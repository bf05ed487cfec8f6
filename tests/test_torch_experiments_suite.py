"""The port's ``smoke`` suite and the runner's worker pool against the JAX
package's: the whole smoke artifact equal float for float, where the
reference's ``model-endpoint`` is given the port's description and bodies
(the decode steps the card measured) by ``dataclasses.replace``; the CI gate
``fig6_throughput_ratio >= 5`` on the port's artifact; and the runner with
two worker processes equal to the runner in one, in a fresh interpreter that
loads neither JAX nor the JAX package.  Artifacts are compared without the
runner's host wall times (``elapsed_s``, ``meta.wall_s``), which no seed
fixes; the pool case also leaves out ``meta.workers``, the one knob it
turns."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from _torch_core_compare import PKGS, same, without_wall  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _smoke_suite(p):
    """The smoke suite of ``p``; the reference's ``model-endpoint`` takes the
    port's description and bodies, every other scenario is as it is."""
    port = PKGS["torch"].experiments.get_scenario("model-endpoint")
    card = {f.name: f.work_us for f in port.functions}
    out = []
    for sc in p.experiments.get_suite("smoke"):
        if sc.name == "model-endpoint" and p is PKGS["jax"]:
            sc = dataclasses.replace(
                sc, description=port.description,
                functions=tuple(dataclasses.replace(f, work_us=card[f.name])
                                for f in sc.functions))
        out.append(sc)
    return out


@pytest.fixture(scope="module")
def smoke_docs():
    docs = {}
    for name, p in PKGS.items():
        ex = p.experiments
        doc = ex.ExperimentRunner(duration_scale=ex.SMOKE_DURATION_SCALE, smoke=True).run_suite(
            _smoke_suite(p), suite="smoke")
        ex.validate_artifact(doc)
        docs[name] = doc
    return docs


def test_smoke_artifact_equals_the_reference(smoke_docs):
    same(without_wall(smoke_docs["torch"]), without_wall(smoke_docs["jax"]), "smoke")
    doc = smoke_docs["torch"]
    assert doc["failures"] == []
    assert [s["name"] for s in doc["scenarios"]] == PKGS["torch"].experiments.SUITES["smoke"]
    endpoint = next(s for s in doc["scenarios"] if s["name"] == "model-endpoint")
    assert set(endpoint["backends"]) == {"containerd", "junctiond"}


def test_fig6_throughput_ratio_gate_on_the_smoke_artifact(smoke_docs):
    metrics = {m["name"]: m["value"] for m in smoke_docs["torch"]["metrics"]}
    assert metrics["fig6_throughput_ratio"] >= 5.0, metrics["fig6_throughput_ratio"]
    # the paper's other claims the suite reduces are there too
    for name in ("fig5_median_reduction", "fig5_p99_reduction", "coldstart_ratio",
                 "fleet_tree_provisioning_speedup", "autoscale_reaction_ratio",
                 "chain_hop_tax_ratio"):
        assert metrics[name] is not None and metrics[name] > 0, name


_POOL = """
import dataclasses, json, sys
from repro_torch.experiments import SMOKE_DURATION_SCALE, ExperimentRunner, get_scenario

sc = dataclasses.replace(get_scenario("paper-fig6"), seeds=(0,))
docs = [ExperimentRunner(duration_scale=SMOKE_DURATION_SCALE, smoke=True, workers=w)
        .run_suite([sc], suite="unit") for w in (2, 0)]
bad = sorted(n for n in sys.modules if n == "jax" or n.startswith("jax.")
             or n == "repro" or n.startswith("repro."))
assert not bad, bad
print(json.dumps(docs))
"""


def test_worker_pool_equals_the_serial_runner():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _POOL], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    pooled, serial = json.loads(r.stdout.strip().splitlines()[-1])
    assert pooled["meta"]["workers"] == 2 and serial["meta"]["workers"] == 0
    for doc in (pooled, serial):
        del doc["meta"]["workers"]
    assert pooled["failures"] == []
    same(without_wall(pooled), without_wall(serial), "pooled")
