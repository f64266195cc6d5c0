"""The benchmark's command, run from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell on the CUDA device(s) it asks for; its result is the
last line of standard output (see benchmark/README.md)."""

import time

T_START = time.perf_counter()  # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    root = Path(__file__).resolve().parents[1]
    sys.path[0] = str(root)  # the checkout's root, not this folder
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], T_START))
