"""Run one cell of the benchmark of ``cmpc_tpu_torch`` on this machine's
cards and print its result as the last line of standard output.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout.  The cell, its configuration and its
metrics are read from ``BENCHMARK.json``.  Exits with 1 and prints no
result where there is no card (or fewer than the cell asks for), where the
program or the benchmark's files are missing, and where a module of JAX or
of the JAX package is loaded in this process.
"""

import time

T_START = time.perf_counter()         # set-up counts the imports below

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # import the benchmark as the package `portbench`, from the root: its
    # own directory first on the path would shadow modules by file name
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    from portbench import core
    try:
        result = core.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), T_START)
    except core.Failure as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 1
    core.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
