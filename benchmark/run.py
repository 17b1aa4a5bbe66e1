"""The benchmark's command:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with the cards the cell
asks for.  Prints diagnostics and the check's numbers beside their limits
on standard error, and one JSON result line last on standard output.
Exits non-zero, printing no result, without the cards.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import core  # noqa: E402

core.setup_env()

from benchmark import harness  # noqa: E402

if __name__ == '__main__':
    harness.main(t0=T0)
