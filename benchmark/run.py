"""Run one cell of the benchmark of ``minnow_torch`` once, on the CUDA card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, each
number compared with its limit, which also end standard error.  Without
a card, with fewer cards than the cell asks for, or when the process has
loaded jax, jaxlib, flax or minnow_tpu, it exits with another code than
0 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [ROOT, BENCH]

FORBIDDEN = ("jax", "jaxlib", "flax", "minnow_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from harness import cell

    chips = cell.cell(cell.spec(), args.workload)["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print("the cell asks for %d cards; %d found"
              % (chips, torch.cuda.device_count()), file=sys.stderr)
        return 2
    result, checks, errors = cell.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda"), T_START)
    found = forbidden_modules()
    if found:
        print("the run loaded %s" % ", ".join(found), file=sys.stderr)
        return 3
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    if errors:
        print("%d requests failed; the first:\n%s" % (len(errors),
                                                       errors[0]),
              file=sys.stderr)
    for k, (v, lim) in checks.items():
        print("check %s: %s (limit %s)" % (k, v, lim), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
