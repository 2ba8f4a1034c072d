"""Run one cell of the port's benchmark once (see harness/core.py).

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()  # set-up counts from the process's start

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench.harness.core import entry  # noqa: E402

if __name__ == "__main__":
    entry(t_start=T_START)
