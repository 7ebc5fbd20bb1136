"""compile_p90_ms: the 90th percentile (nearest rank) of the walls of every
compile completed in the window."""
import math


def read(window):
    if not window.walls:
        return None
    walls = sorted(window.walls)
    return 1e3 * walls[math.ceil(0.9 * len(walls)) - 1]
