"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards.  It
prints the numbers compared (and the card's power limit, the trace's and
the reference's seconds) on standard error and the result as the last line
of standard output; without enough CUDA cards it exits 2 and prints no
result.  ``harness.py`` says what a run does, ``README.md`` how to add to it.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BASE = Path(__file__).resolve().parent
ROOT = BASE.parent
# the package, not this folder, is what the benchmark's modules import from
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BASE]
sys.path.insert(0, str(ROOT))
# the program's kernel libraries: built once into the checkout, found again
os.environ["TINYIMGCODEC_TORCH_BUILD_DIR"] = str(ROOT / "build")

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
