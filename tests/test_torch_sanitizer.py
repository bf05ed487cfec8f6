"""The port's sim sanitizer (``repro_torch.analysis.sanitizer``), the cases
of ``tests/test_sanitizer.py``: checked runs, a fleet's included, give the
same bytes as unchecked ones (and as the JAX package's runs), install and
uninstall restore the originals of ``repro_torch.core`` and leave
``repro.core`` alone, every trip condition trips, the fused admits of the
event engine and of the fleet driver call the check, and
``REPRO_SIM_CHECK`` installs it when ``repro_torch.core`` is imported."""
import heapq
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.core.workload as jworkload  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.workload as workload  # noqa: E402
from _torch_core_compare import PKGS  # noqa: E402
from repro_torch.analysis import sanitizer  # noqa: E402
from repro_torch.analysis.sanitizer import SimCheckError  # noqa: E402
from repro_torch.core import EventLoop, LoadSpec, Simulator, drive  # noqa: E402
from repro_torch.core.resources import CorePool  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def sanitized():
    """Install the checked wrappers for one test, always restoring."""
    sanitizer.install()
    try:
        yield
    finally:
        sanitizer.uninstall()


def _runtime(n_cores=8, backend="junctiond", seed=7, core=tcore):
    sim = core.Simulator(seed=seed)
    rt = core.FaasdRuntime(sim, backend=backend, n_cores=n_cores)
    rt.deploy_blocking(core.FunctionSpec(name="aes"))
    return sim, rt


def _drive_fingerprint(engine, backend="junctiond", n_cores=8, rate=4000.0, core=tcore):
    _, rt = _runtime(n_cores=n_cores, backend=backend, core=core)
    res = core.drive(rt, core.LoadSpec.single("aes", rate, duration_s=0.5), engine=engine)
    return json.dumps(res, sort_keys=True, default=str)


# ---------------------------------------------------------------------------
# byte-identical equivalence


@pytest.mark.parametrize("engine", ["events", "process"])
@pytest.mark.parametrize("backend", ["junctiond", "containerd"])
def test_checked_run_is_byte_identical(engine, backend):
    base = _drive_fingerprint(engine, backend=backend)
    sanitizer.install()
    try:
        checked = _drive_fingerprint(engine, backend=backend)
    finally:
        sanitizer.uninstall()
    assert checked == base
    assert base == _drive_fingerprint(engine, backend=backend, core=jcore)


def test_checked_run_is_byte_identical_under_contention():
    # few cores + high rate exercises the waiter queue, materialize,
    # and the per-station fallback alongside the fused path
    base = _drive_fingerprint("events", n_cores=3, rate=20000.0)
    sanitizer.install()
    try:
        checked = _drive_fingerprint("events", n_cores=3, rate=20000.0)
    finally:
        sanitizer.uninstall()
    assert checked == base
    assert base == _drive_fingerprint("events", n_cores=3, rate=20000.0, core=jcore)


def _fleet_fingerprint(pkg=PKGS["torch"]):
    core = pkg.core
    cl = pkg.fleet.Cluster(core.Simulator(seed=3), n_workers=4, backend="junctiond", n_cores=8)
    cl.deploy_blocking(core.FunctionSpec(name="aes"))
    res = core.drive(cl, core.LoadSpec.single("aes", 6000.0, duration_s=0.5))
    return json.dumps(res, sort_keys=True, default=str)


def test_checked_fleet_run_is_byte_identical():
    base = _fleet_fingerprint()
    sanitizer.install()
    try:
        checked = _fleet_fingerprint()
    finally:
        sanitizer.uninstall()
    assert checked == base
    assert base == _fleet_fingerprint(PKGS["jax"])


# ---------------------------------------------------------------------------
# install/uninstall mechanics


def test_install_uninstall_restore_originals():
    orig_loop_run = EventLoop.run
    orig_sim_run = Simulator.run
    orig_busy = CorePool.__dict__["busy"]
    j_loop_run = jcore.EventLoop.run
    assert workload.SIM_CHECK is False
    assert not sanitizer.enabled()
    sanitizer.install()
    try:
        assert sanitizer.enabled()
        assert workload.SIM_CHECK is True
        assert EventLoop.run is not orig_loop_run
        # the JAX package's core stays unchecked
        assert jworkload.SIM_CHECK is False and jcore.EventLoop.run is j_loop_run
    finally:
        sanitizer.uninstall()
    assert not sanitizer.enabled()
    assert workload.SIM_CHECK is False
    assert EventLoop.run is orig_loop_run
    assert Simulator.run is orig_sim_run
    assert CorePool.__dict__["busy"] is orig_busy


def test_install_is_idempotent():
    sanitizer.install()
    try:
        checked = EventLoop.run
        sanitizer.install()
        assert EventLoop.run is checked
    finally:
        sanitizer.uninstall()
    sanitizer.uninstall()       # second uninstall is a no-op


# ---------------------------------------------------------------------------
# trip conditions


def test_corrupted_busy_over_capacity_trips(sanitized):
    _, rt = _runtime(n_cores=4)
    pool = rt.cores
    with pytest.raises(SimCheckError, match="past capacity"):
        pool.busy = pool.n_cores + 5


def test_corrupted_busy_negative_trips(sanitized):
    _, rt = _runtime(n_cores=4)
    with pytest.raises(SimCheckError, match="negative"):
        rt.cores.busy = -1


def test_release_at_with_waiters_trips(sanitized):
    sim, rt = _runtime(n_cores=4)
    pool = rt.cores
    pool._waiters.append(sim.event())
    with pytest.raises(SimCheckError, match="no-waiters"):
        pool.release_at(sim.now + 1.0)


def test_release_at_in_the_past_trips(sanitized):
    sim, rt = _runtime(n_cores=4)
    sim.now = 10.0
    with pytest.raises(SimCheckError, match="past"):
        rt.cores.release_at(5.0)


def test_waiter_append_with_pending_releases_trips(sanitized):
    sim, rt = _runtime(n_cores=4)
    pool = rt.cores
    pool.busy = 1
    pool.release_at(sim.now + 1.0)      # legal: no waiters yet
    with pytest.raises(SimCheckError, match="_materialize"):
        pool._waiters.append(sim.event())


def test_negative_delay_trips(sanitized):
    sim = Simulator(seed=0)
    with pytest.raises(SimCheckError, match="negative delay"):
        sim._schedule(-0.5, lambda: None)


def test_event_in_the_past_trips(sanitized):
    sim = Simulator(seed=0)
    sim.now = 5.0
    heapq.heappush(sim._heap, (1.0, 0, lambda: None, ()))
    with pytest.raises(SimCheckError, match="clock"):
        EventLoop(sim).run(10.0)
    sim2 = Simulator(seed=0)
    sim2.now = 5.0
    heapq.heappush(sim2._heap, (1.0, 0, lambda: None, ()))
    with pytest.raises(SimCheckError, match="clock"):
        sim2.run(10.0)


def test_backwards_arrival_stream_trips(sanitized):
    sim = Simulator(seed=0)
    with pytest.raises(SimCheckError, match="backwards"):
        EventLoop(sim).run(10.0, [5.0, 1.0], lambda i, t: None)


def test_fused_admit_check_trips_on_contention(sanitized):
    sim, rt = _runtime(n_cores=4)
    pool = rt.cores
    pool._waiters.append(sim.event())
    with pytest.raises(SimCheckError, match="waiters"):
        sanitizer.fused_admit_check(pool, 1.0, 2.0)


def test_fused_admit_check_trips_on_past_completion(sanitized):
    _, rt = _runtime(n_cores=4)
    with pytest.raises(SimCheckError, match="precedes"):
        sanitizer.fused_admit_check(rt.cores, 1.0, 0.5)
    with pytest.raises(SimCheckError, match="off-path"):
        sanitizer.fused_admit_check(rt.cores, 1.0, 2.0, off_end_t=0.5)


def test_monotone_run_passes_checks(sanitized):
    _, rt = _runtime(n_cores=8)
    res = drive(rt, LoadSpec.single("aes", 2000.0, duration_s=0.3))
    assert res["n"] > 0


def test_fused_admits_call_the_check(sanitized, monkeypatch):
    """The event engine calls the check on each fused admit, with and
    without an off-path job, and only while the flag is on."""
    calls = []

    def spy(pool, t, end_t, off_end_t=None):
        calls.append((t, end_t, off_end_t))

    monkeypatch.setattr(sanitizer, "fused_admit_check", spy)
    _, rt = _runtime(n_cores=8)
    drive(rt, LoadSpec.single("aes", 2000.0, duration_s=0.3))
    assert calls and all(end >= t for t, end, _ in calls)
    assert any(off is not None for *_, off in calls)
    n = len(calls)
    monkeypatch.setattr(workload, "SIM_CHECK", False)
    _, rt = _runtime(n_cores=8)
    drive(rt, LoadSpec.single("aes", 2000.0, duration_s=0.3))
    assert len(calls) == n


def test_fleet_fused_admits_call_the_check(sanitized, monkeypatch):
    """The fleet driver calls the check on each fused admit too, with and
    without an off-path job, and only while the flag is on."""
    calls = []

    def spy(pool, t, end_t, off_end_t=None):
        calls.append((t, end_t, off_end_t))

    monkeypatch.setattr(sanitizer, "fused_admit_check", spy)
    base = _fleet_fingerprint()
    assert calls and all(end >= t for t, end, _ in calls)
    assert any(off is not None for *_, off in calls)
    n = len(calls)
    monkeypatch.setattr(workload, "SIM_CHECK", False)
    assert _fleet_fingerprint() == base
    assert len(calls) == n


# ---------------------------------------------------------------------------
# REPRO_SIM_CHECK=1 env hook


def test_env_var_installs_sanitizer_on_core_import():
    env = dict(os.environ, REPRO_SIM_CHECK="1", PYTHONPATH=str(REPO_ROOT / "src"))
    code = (
        "import sys\n"
        "import repro_torch.core\n"
        "import repro_torch.core.workload as w\n"
        "from repro_torch.analysis import sanitizer\n"
        "assert sanitizer.enabled()\n"
        "assert w.SIM_CHECK is True\n"
        "from repro_torch.core import Simulator, FaasdRuntime, FunctionSpec, LoadSpec, drive\n"
        "sim = Simulator(seed=1)\n"
        "rt = FaasdRuntime(sim, backend='junctiond', n_cores=8)\n"
        "rt.deploy_blocking(FunctionSpec(name='aes'))\n"
        "res = drive(rt, LoadSpec.single('aes', 1000.0, duration_s=0.2))\n"
        "assert res['n'] > 0\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print('ok')\n")
    rc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO_ROOT,
                        capture_output=True, text=True, timeout=300)
    assert rc.returncode == 0, rc.stderr
    assert rc.stdout.strip() == "ok"


def test_env_var_absent_leaves_sim_unchecked():
    env = {k: v for k, v in os.environ.items() if k != "REPRO_SIM_CHECK"}
    env["PYTHONPATH"] = str(REPO_ROOT / "src")
    code = (
        "import repro_torch.core\n"
        "from repro_torch.analysis import sanitizer\n"
        "assert not sanitizer.enabled()\n"
        "import repro_torch.core.workload as w\n"
        "assert w.SIM_CHECK is False\n"
        "print('ok')\n")
    rc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO_ROOT,
                        capture_output=True, text=True, timeout=300)
    assert rc.returncode == 0, rc.stderr
