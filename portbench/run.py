#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the port
(``poseidon_tpu_torch``) and one or more CUDA devices.  Prints, as the
last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` a ``breakdown``), then ``checks``: each number the
correctness check compared, with its limit.  Without the devices the
cell asks for it exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
