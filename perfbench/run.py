"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result, one JSON object; the checks' numbers and limits are also the last
lines of standard error.  Exits 1, printing no result, without a CUDA card
(or with fewer than the cell asks for), where a file is missing, or where
JAX or the JAX package has been loaded into this process.  ``--control``
runs the cell's control instead (``perfbench/control.py``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# the program's kernel caches stay inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, default=0,
                    help="seeds to read the program and the control on (not a benchmark run)")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness
    try:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    except (OSError, StopIteration, KeyError, ValueError) as e:
        print(f"no workload {args.workload!r}: {e!r}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    if args.control:
        from perfbench import control
        return control.main(args.workload, args.seed, args.control, args.seconds, ROOT)
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  root=ROOT, t_start=T_START)
    except harness.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 1
    bad = harness.loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 1
    result["device"]["power_limit"] = harness.power_limit()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
