"""The readings that a cell's limits are set from: on each of ``n`` seeds
from ``seed``, a short run of the cell (its window of ``seconds``, its
checks) with the control read beside the program.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --control <n>

Served cells: the program's widest logit gap and the control's (the fp8
reference's first token at each served position, read in the fp32
reference).  The training cell: the program's three numbers, the fp8
reference's and those of a reference that leaves half of each row's tokens
out of the mean.  Each seed's line is JSON on standard output, and the
lines are written to ``chiprun_out/control-<workload>.jsonl`` too.
"""
from __future__ import annotations

import json
from pathlib import Path

from perfbench import harness


def main(workload: str, seed: int, n: int, seconds: float, root: Path) -> int:
    out_dir = root / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / f"control-{workload}.jsonl", "a") as f:
        for s in range(seed, seed + n):
            r = harness.run_cell(workload, s, seconds, False, root=root, control=True)
            line = json.dumps({"seed": s, "correct": r["correct"], "checks": r["checks"],
                               "readings": r["readings"], "metrics": r["metrics"],
                               "device": r["device"]})
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
    return 0
