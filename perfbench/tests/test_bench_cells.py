"""The harness finds a cell by its name, and a cell, a mix and a metric
added as new files and entries only run, on the CPU at tiny sizes."""
from __future__ import annotations

import json

import pytest

from perfbench import harness
from perfbench.tests.conftest import CELLS, LIMITS


@pytest.mark.parametrize("workload", [c[0] for c in CELLS])
def test_added_cell_runs_and_is_correct(checkout, workload):
    root, bd = checkout
    r = harness.run_cell(workload, 2**31 + 77, 0.5, False, device="cpu", root=root,
                         bench_dir=bd)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == set(LIMITS[workload])
    assert list(r)[-1] == "checks"
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2


def test_every_cell_of_the_benchmark_has_its_files():
    root = harness.BENCH_DIR.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"], root)
        harness.program_arch(cell.cfg)
        assert cell.limits and cell.per_layer and cell.end_to_end
        for m in cell.per_layer:
            assert callable(harness.metric_reader(cell, m["name"]))


@pytest.mark.parametrize("reader", ["tiny_metric.x.py", "tiny_metric.py"])
def test_added_metric_is_found_by_name(checkout, reader):
    """A metric's own reader, or the one its quantity's cells share."""
    root, bd = checkout
    (bd / "metrics" / reader).write_text(
        "def read(ctx):\n    return None if not ctx['runs'] else float(len(ctx['runs']))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "tiny_metric.x", "unit": "count", "better": "lower",
                               "source": "program_span", "layer": "Engine",
                               "moves": "setup_s", "workloads": ["tiny-dense.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell("tiny-dense.serve", root, bd)
    assert "tiny_metric.x" in [m["name"] for m in cell.per_layer]
    read = harness.metric_reader(cell, "tiny_metric.x")
    assert read({"runs": [1, 2]}) == 2.0 and read({"runs": []}) is None


def test_a_missing_file_is_refused(checkout):
    root, bd = checkout
    (bd / "limits" / "tiny-dense.serve.json").unlink()
    with pytest.raises(harness.Refused):
        harness.find_cell("tiny-dense.serve", root, bd)


def test_a_file_that_disagrees_with_the_program_is_refused(checkout):
    root, bd = checkout
    path = bd / "configs" / "tiny-dense.json"
    cfg = json.loads(path.read_text())
    cfg["intermediate_size"] = 256
    path.write_text(json.dumps(cfg))
    with pytest.raises(harness.Refused):
        harness.program_arch(cfg)


def test_serve_traffic_gives_every_seed_the_same_lengths():
    from perfbench.traffic import Serve
    mix = {"loop": "closed", "callers": 1, "batch": 2, "new_tokens": 1,
           "prompt_lens": [5, 7, 9]}
    a, b = Serve(mix, 1, 50), Serve(mix, 2**40 + 3, 50)
    la, lb = [a.lens(i) for i in range(9)], [b.lens(i) for i in range(9)]
    for k in range(3):
        assert sorted(la[3 * k:3 * k + 3]) == sorted(lb[3 * k:3 * k + 3]) == [5, 7, 9]
    assert a.prompts(4) == Serve(mix, 1, 50).prompts(4)
    assert all(0 <= t < 50 for row in a.prompts(1) for t in row)


def test_check_sample_holds_every_prompt_length():
    # (index, prompt length, ...) of nine invocations in blocks of 512, 1024, 2048
    runs = [(i, (512, 1024, 2048)[(i * 2) % 3]) for i in range(9)]
    for seed in (1, 2**31 + 9, 2**40):
        pick = harness.check_sample(runs, 3, seed)
        assert pick[0] == 1 and sorted(runs[i][1] for i in pick) == [512, 1024, 2048]
        assert len(harness.check_sample(runs, 5, seed)) == len(set(harness.check_sample(runs, 5, seed))) == 5
