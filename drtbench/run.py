"""Run one cell of the drt_tpu_torch benchmark once, from the root of a
checkout:

    python3 drtbench/run.py --workload cbox-train --seed 7 --seconds 20 \
        --trace 0

It prints the cell's metrics as the last line of its standard output, one
JSON object, and the numbers its check compared, each beside its limit,
as the last lines of its standard error. Without a CUDA device it exits
with 1 and prints no result.
"""

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from drtbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
