"""cost_rows_roofline: the cost_rows kernel's least time on the card (frozen
counts, ``rooflines/cost_rows.py``) over its traced device time, in percent."""
import rooflines
from rooflines import cost_rows as kernel


def read(window):
    return rooflines.traced_share(window, kernel)
