"""alloc_scan_roofline: the alloc_scan kernel's least time on the card (frozen
counts, ``rooflines/alloc_scan.py``) over its traced device time, in percent."""
import rooflines
from rooflines import alloc_scan as kernel


def read(window):
    return rooflines.traced_share(window, kernel)
