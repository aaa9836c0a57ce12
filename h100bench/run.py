"""Entry point of the port's H100 benchmark (see harness.py):

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100bench import harness  # noqa: E402

if __name__ == "__main__":
    harness.set_run_env()
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
