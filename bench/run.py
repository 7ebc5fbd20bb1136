"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root, on a machine with the CUDA devices the cell
asks for (``BENCHMARK.json``).  The last line of standard output is the
result (see ``harness/cell.py``).
"""
import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
# The bytecode of every module a run imports, torch's above all, is kept at
# a fixed place in the checkout.  Where the installation holds none and the
# environment forbids writing it (PYTHONDONTWRITEBYTECODE), each run would
# compile torch's sources anew: some 6 s of set-up that no deployed install
# pays.  Only the first run in a checkout writes it.
sys.pycache_prefix = str(HERE.parent / "build" / "pycache")
sys.dont_write_bytecode = False

from harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
