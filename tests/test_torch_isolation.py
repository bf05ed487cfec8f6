"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor the JAX package, and no module of it (nor ``chip_smoke.py``
or the port's examples) imports either."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "examples" / "train_small_torch.py",
                                      ROOT / "examples" / "quickstart_torch.py",
                                      ROOT / "examples" / "faas_comparison_torch.py",
                                      ROOT / "examples" / "serve_e2e_torch.py"]


def _modules():
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_the_walk_covers_the_moe_modules():
    """The import check below walks the package; the MoE slice's modules
    are among those it imports."""
    mods = set(_modules())
    assert {"repro_torch.models.moe", "repro_torch.kernels.moe_gmm",
            "repro_torch.configs.mixtral_8x7b"} <= mods


def test_the_walk_covers_the_scan_modules():
    """The Mamba and RWKV6 slice's modules are among those it imports."""
    mods = set(_modules())
    assert {"repro_torch.models.mamba", "repro_torch.models.rwkv",
            "repro_torch.kernels.mamba_scan", "repro_torch.kernels.rwkv6_scan",
            "repro_torch.configs.jamba_v01", "repro_torch.configs.rwkv6_1p6b"} <= mods


def test_the_walk_covers_the_scan_utils_module():
    """The port's chunked linear scan, the reference form of the scans'
    recurrences, is among the modules it imports."""
    assert "repro_torch.models.scan_utils" in set(_modules())


def test_the_walk_covers_the_encdec_modules():
    """The enc-dec and frontend slice's modules are among those it imports."""
    mods = set(_modules())
    assert {"repro_torch.models.frontends", "repro_torch.configs.seamless_m4t_v2",
            "repro_torch.configs.pixtral_12b"} <= mods


def test_the_walk_covers_the_control_plane_modules():
    """The four other backends, the autoscaler, multi-tenancy and the sim
    sanitizer are among those it imports."""
    mods = set(_modules())
    assert {"repro_torch.core.quark", "repro_torch.core.wasm",
            "repro_torch.core.firecracker", "repro_torch.core.gvisor",
            "repro_torch.core.autoscaler", "repro_torch.core.multitenant",
            "repro_torch.analysis", "repro_torch.analysis.sanitizer"} <= mods


def test_the_walk_covers_the_fleet_and_experiments_modules():
    """The fleet tier and the experiments runner are among those it imports."""
    mods = set(_modules())
    assert {"repro_torch.fleet", "repro_torch.fleet.cluster", "repro_torch.fleet.driver",
            "repro_torch.fleet.gateway", "repro_torch.fleet.placement",
            "repro_torch.fleet.provisioning",
            "repro_torch.experiments", "repro_torch.experiments.artifacts",
            "repro_torch.experiments.runner", "repro_torch.experiments.scenario",
            "repro_torch.experiments.suites"} <= mods


def test_the_walk_covers_the_training_modules():
    """The training path, the FLOP accounting and the input shapes are
    among the modules it imports."""
    mods = set(_modules())
    assert {"repro_torch.train", "repro_torch.train.checkpoint", "repro_torch.train.data",
            "repro_torch.train.losses", "repro_torch.train.optimizer",
            "repro_torch.train.train_loop", "repro_torch.launch.train",
            "repro_torch.models.flops", "repro_torch.config.shapes"} <= mods


def test_the_walk_covers_the_dryrun_modules():
    """The sharding, mesh, dry-run, hillclimb, roofline and collective
    modules, and the scans' trace operators, are among those it imports."""
    mods = set(_modules())
    assert {"repro_torch.distributed", "repro_torch.distributed.sharding",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun", "repro_torch.launch.perf",
            "repro_torch.analysis.roofline", "repro_torch.analysis.collectives",
            "repro_torch.kernels.trace_ops"} <= mods


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
    """``core/backends.py`` imports its backends by module name, and the
    sanitizer patches ``repro_torch.core`` from inside ``install()``, which
    the AST check below cannot see: run the FaaS path on every backend,
    checked, and look at what got loaded."""
    code = ("import sys\n"
            "from repro_torch.analysis import sanitizer\n"
            "from repro_torch.core import (FaasdRuntime, FunctionSpec, LoadSpec, Simulator,\n"
            "                              available_backends, drive, run_sequential)\n"
            "assert available_backends() == ('containerd', 'firecracker', 'gvisor',\n"
            "                                'junctiond', 'quark', 'wasm')\n"
            "sanitizer.install()\n"
            "for b in available_backends():\n"
            "    rt = FaasdRuntime(Simulator(seed=1), backend=b)\n"
            "    rt.deploy_blocking(FunctionSpec('aes'))\n"
            "    assert run_sequential(rt, 'aes', n=20).n == 20\n"
            "    assert drive(rt, LoadSpec.single('aes', 500.0, duration_s=0.1))['n'] > 0\n"
            "sanitizer.uninstall()\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
            "             or n == 'repro' or n.startswith('repro.'))\n"
            "for m in ('junctiond', 'quark', 'wasm', 'firecracker', 'gvisor'):\n"
            "    assert 'repro_torch.core.' + m in sys.modules, m\n"
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
    """Each kernel source names the Pallas kernel it replaces, what bounds
    it on the card and what its design does about that."""
    for cu in sorted((PORT / "csrc").glob("*.cu")):
        head = cu.read_text()[:3000]
        assert "Replaces the Pallas kernel" in head, cu
        assert "What bounds it on this card" in head, cu
        assert ("What this simple design does about it" in head
                or "What this design does about it" in head), cu
