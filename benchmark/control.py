"""Readings for the limits of ``correct``: a cell's numbers compared, on
several seeds in one process, from the program as it is (the lower
reading) and from the control (the reference in the program's place, in
bfloat16: the upper reading).

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        [--seconds 2] [--control]

Each seed prints one JSON line ``{"seed", "control", "correct",
"checks"}``.  The benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(BENCH), BENCH]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)

    import torch

    from harness import cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    program = (lambda wl, kept: wl.control()) if args.control else None
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks, errors = cell.run_cell(
            args.workload, seed, args.seconds, False, torch.device("cuda"),
            time.perf_counter(), program=program)
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
