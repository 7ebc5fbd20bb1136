"""enum_frames_roofline: the enum_frames kernel's least time on the card (frozen
counts, ``rooflines/enum_frames.py``) over its traced device time, in percent."""
import rooflines
from rooflines import enum_frames as kernel


def read(window):
    return rooflines.traced_share(window, kernel)
