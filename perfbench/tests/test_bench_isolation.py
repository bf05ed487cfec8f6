"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level module names: the port's ``repro_torch`` begins with
``repro``), and the reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

from perfbench import harness

BENCH = Path(harness.__file__).resolve().parent
ROOT = BENCH.parent


def _tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _tops(path) & {"jax", "jaxlib", "flax", "repro"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not _tops(path) & {"repro_torch", "repro", "jax"}, path
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        import perfbench.reference.decoder, perfbench.work.counts, perfbench.weights
        print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'repro_torch', 'repro', 'jax'}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_forbidden_module(checkout):
    root, bd = checkout
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        from pathlib import Path
        from perfbench import harness
        r = harness.run_cell("tiny-dense.serve", 3, 0.2, False, device="cpu",
                             root=Path({str(root)!r}), bench_dir=Path({str(bd)!r}))
        print(r["correct"], harness.loaded_forbidden())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "True []"


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.sub", sys)
    assert "repro" in harness.loaded_forbidden()
