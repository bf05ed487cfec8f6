"""The port's two FaaS examples against the reference's: given the paper's
host figure for the AES body (``--body-us 95.0``), every line after the
first (which names the body) is the reference example's, exactly.  The
measured modes run on the CPU's plain body; without a card the default
(the card) raises."""
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


@pytest.mark.parametrize("port", [p for p, _ in PAIRS])
def test_default_needs_a_card(port):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default measures the body on it")
    t = _run(port)
    assert t.returncode != 0 and "no CUDA device" in t.stderr
    assert t.stdout == ""
