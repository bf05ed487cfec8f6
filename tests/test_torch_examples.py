"""The port's examples against the reference's.  The two FaaS examples:
given the paper's host figure for the AES body (``--body-us 95.0``), every
line after the first (which names the body) is the reference example's,
exactly.  The serving example: with both engines' measured decode step set
to the same value, every line after the first is ``examples/serve_e2e.py``'s.  The measured modes run on the CPU's plain versions;
without a card the default (the card) raises."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PAIRS = [("quickstart_torch.py", "quickstart.py"),
         ("faas_comparison_torch.py", "faas_comparison.py")]


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(ROOT / "examples" / script), *args],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


@pytest.mark.parametrize("port,reference", PAIRS)
def test_given_body_reproduces_the_reference_output(port, reference):
    t, r = _run(port, "--body-us", "95.0"), _run(reference)
    assert t.returncode == 0 and r.returncode == 0, t.stderr + r.stderr
    lines = t.stdout.splitlines()
    assert lines[0] == "AES(600 B) body: 95.0 us, given (not measured)"
    assert lines[1:] == r.stdout.splitlines()


@pytest.mark.parametrize("port", [p for p, _ in PAIRS])
def test_cpu_body_is_measured_and_deployed(port):
    t = _run(port, "--device", "cpu")
    assert t.returncode == 0, t.stderr
    first = t.stdout.splitlines()[0]
    assert first.startswith("AES(600 B) body: ") and "on the CPU (plain version)" in first
    body = float(first.split()[3])
    assert body > 0
    assert "junctiond" in t.stdout


@pytest.mark.parametrize("port", [p for p, _ in PAIRS] + ["serve_e2e_torch.py"])
def test_default_needs_a_card(port):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default measures the body on it")
    t = _run(port)
    assert t.returncode != 0 and "no CUDA device" in t.stderr
    assert t.stdout == ""


def test_serve_e2e_given_step_reproduces_the_reference_deployment():
    """The reference and the port run with their engines' measured step set
    to 2500 us (the step is the only number of the FaaS half that the host
    measures): the same requests and tokens counted, the same step, and the
    same containerd and junctiond lines."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    code = ("import runpy, sys\n"
            "from {pkg}.serving import engine\n"
            "engine.ServingEngine.mean_decode_step_us = lambda self: 2500.0\n"
            "sys.argv = {argv!r}\n"
            "runpy.run_path({argv[0]!r}, run_name='__main__')\n")
    r, t = (subprocess.run([sys.executable, "-c", code.format(pkg=pkg, argv=argv)],
                           capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
            for pkg, argv in (("repro", ["examples/serve_e2e.py"]),
                              ("repro_torch", ["examples/serve_e2e_torch.py", "--device", "cpu"])))
    assert r.returncode == 0 and t.returncode == 0, r.stderr + t.stderr
    ref_lines, lines = r.stdout.splitlines(), t.stdout.splitlines()
    assert lines[0].startswith(ref_lines[0]) and lines[0].endswith("the CPU (plain version)")
    assert ref_lines[2] == "measured decode step: 2500 us (CPU, reduced model)"
    assert lines[1:] == ref_lines[1:] and len(lines) == 5


def test_serve_e2e_measures_the_cpu_step_and_deploys_it():
    t = _run("serve_e2e_torch.py", "--device", "cpu")
    assert t.returncode == 0, t.stderr
    lines = t.stdout.splitlines()
    step = float(lines[2].split()[3])
    assert lines[2].endswith("us (CPU, reduced model)") and step > 0
    medians = {ln.split()[0]: float(ln.split("median=")[1].split()[0]) for ln in lines[3:]}
    assert set(medians) == {"containerd", "junctiond"}
    assert medians["junctiond"] < medians["containerd"]
