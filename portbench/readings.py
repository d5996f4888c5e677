"""The readings that the limits of ``correct`` are set from.

    python3 portbench/readings.py --workload <cell> --seeds 11 12 13 \\
        [--control-rounds 13]

runs, in one process and at the cell's own size, one whole simulation a
seed (after the warm-up a run has) and prints a JSON line a seed with
every number check.py compares. With ``--control-rounds`` the program's
loss decisions are replaced where they are produced by the reference's
draw at that many rounds (record.py): the control, which has to read
above every limit. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-rounds", type=int)
    args = p.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    for seed in args.seeds:
        result = run.measure(cell, seed, 0,
                             control_rounds=args.control_rounds)
        w = result["window"]
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "control_rounds": args.control_rounds,
            "simulations": len(w.sims),
            "units_decided": sum(len(d[0]) for s in w.sims for d in s.draws),
            "readings": {k: v for k, (v, _) in result["readings"].items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
