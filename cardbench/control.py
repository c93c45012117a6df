"""The control and the planted faults on the card, at a cell's own size.

    python -m cardbench.control --workload <name> --seconds <s> --seeds <n ...> --faults <name ...>

For every fault (`none` for sound runs, or a name of faults.py) and seed, one
run of the cell with the fault applied, in this process for a one-card cell
(the kernels are built and loaded once), with freshly forked ranks for a
cell over several cards.  One JSON line a run: `correct`, the numbers
compared and their limits.  The benchmark's own runs never apply a fault.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import cells, faults, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control and planted faults of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", default=["lazy_reduction"], choices=["none"] + sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    cell = cells.load(args.workload, Path.cwd())
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    for fault in args.faults:
        for seed in args.seeds:
            hooks = [] if fault == "none" else [fault]
            result = run.run_cell(cell, seed, args.seconds, False, {"hooks": hooks})
            print(json.dumps({"workload": cell.name, "fault": fault, "seed": seed, "correct": result["correct"],
                              "attempted": result["attempted"], "failed": result["failed"],
                              "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
