"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor the JAX package, and no module of it (nor ``chip_smoke.py``)
imports either."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = ("import importlib, sys\n"
            f"for m in {list(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
            "             or n == 'repro' or n.startswith('repro.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_faas_path_loads_no_jax_and_no_repro():
    """``core/backends.py`` imports its backends by module name, which the
    AST check below cannot see: run the FaaS path and look at what got
    loaded."""
    code = ("import sys\n"
            "from repro_torch.core import (FaasdRuntime, FunctionSpec, Simulator,\n"
            "                              available_backends, run_sequential)\n"
            "assert available_backends() == ('containerd', 'junctiond')\n"
            "for b in available_backends():\n"
            "    rt = FaasdRuntime(Simulator(seed=1), backend=b)\n"
            "    rt.deploy_blocking(FunctionSpec('aes'))\n"
            "    assert run_sequential(rt, 'aes', n=20).n == 20\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
            "             or n == 'repro' or n.startswith('repro.'))\n"
            "assert 'repro_torch.core.junctiond' in sys.modules\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_every_cuda_source_has_its_note():
    """Each kernel source names the Pallas kernel it replaces and what
    bounds it on the card."""
    for cu in sorted((PORT / "csrc").glob("*.cu")):
        head = cu.read_text()[:3000]
        assert "Replaces the Pallas kernel" in head, cu
        assert "What bounds it on this card" in head, cu
        assert "What this simple design does about it" in head, cu
