"""Entry point of the port's benchmark; see core/harness.py.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
"""

import os
import time


def _process_start() -> float:
    """perf_counter's reading at the process's start (Linux: its start
    time in /proc; elsewhere this line's)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        since = (time.clock_gettime(time.CLOCK_BOOTTIME)
                 - ticks / os.sysconf("SC_CLK_TCK"))
        return now - max(0.0, since)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


T0 = _process_start()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.core import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
