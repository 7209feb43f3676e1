"""Runs one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout, on a machine with the CUDA device(s) the
cell asks for.  The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), `device`, with --trace
1 a `breakdown` of the traced slice, and last `check`, each compared
number beside its limit (also the last lines of standard error).  Exit
codes: 0 a result; 1 the run failed; 2 no CUDA device, or fewer than
the cell asks for; 3 JAX or the JAX package was loaded.  See
portbench/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
