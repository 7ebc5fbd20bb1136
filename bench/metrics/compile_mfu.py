"""compile_mfu: the least time the card could take for a compile's kernel
work (K2 + K1 + K3 at every chunk, frozen counts) over the compile's mean
wall, in percent.  It bounds the kernels' gain whichever of them a later
change fuses or removes."""
from rooflines import alloc_scan, cost_rows, enum_frames


def read(window):
    if not window.walls or not window.chunks \
            or not window.launches.get("cost_rows"):
        return None
    least = sum(k.bound_s(b, window.shape)[0] for k in
                (enum_frames, alloc_scan, cost_rows) for b in window.chunks)
    return 100.0 * least / (sum(window.walls) / len(window.walls))
