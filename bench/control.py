"""Run the control of a cell on the chip (see ``harness/control.py``)."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from harness.control import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
