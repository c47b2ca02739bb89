"""``python -m voxbench``: one run of one cell (``voxbench/harness.py``)."""

import time

T_START = time.perf_counter()  # the process's start, before torch loads

if __name__ == "__main__":
    from voxbench.harness import main

    raise SystemExit(main(t_start=T_START))
