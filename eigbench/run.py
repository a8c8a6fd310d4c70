"""Run one benchmark cell once and print its result as the last line.

    python3 eigbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the port,
``dominantsparseeigenad_tpu_torch``, on a machine with the cards the cell
asks for; without them it exits with a non-zero code and prints no
result.  See ``lib/harness.py`` for what a run does.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from eigbench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
