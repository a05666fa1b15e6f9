"""Readings from which a cell's limits are set, many seeds in one process.

    python -m gpubench.calibrate --workload <cell> --seeds 11,12,13 --seconds 3 \\
        [--control bf16|fp8] [--fault <name>]

For each seed: one run of the cell as ``gpubench.run`` makes it (set-up, a
short window at the cell's load, the check), its checked numbers, and with
``--control`` the same numbers read off the reference in that lower
precision put in the program's place. ``--fault`` plants one of
``gpubench/faults.py``'s faults in the program first. Prints one JSON line
a seed; never used by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import faults, run as bench_run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", default=None)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    undo = faults.plant(args.fault) if args.fault else (lambda: None)
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            run, line = bench_run.execute(["--workload", args.workload, "--seed", str(seed),
                                           "--seconds", str(args.seconds), "--trace", "0"])
            out = {"seed": seed, "correct": line["correct"], "metrics": run.e2e,
                   "checks": {k: v["value"] for k, v in line["checks"].items()},
                   "info": run.info}
            if args.control:
                out["control"] = run.state.control(args.control)
            print(json.dumps(out), flush=True)
            del run
    finally:
        undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
