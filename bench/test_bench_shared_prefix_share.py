"""The reader of the program's shared-prefix counter, on the CPU: the share
from the counter, nothing where the program counts none, and the yolov3
cell's figure from its configuration's runs (57 of 79 groups shared by
every chunk of 2^20)."""
import json
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

import reference
from harness import spec
from harness.cell import Window
from rooflines import chunks

BENCH = Path(__file__).resolve().parent
CHUNK = 1 << 20
COUNTER = "alloc.shared_prefix_steps"


def reader():
    return spec.reader("shared_prefix_share")


def window(name: str, compiles: int) -> Window:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    shape = reference.shape(cfg["network"])
    return Window(setup_s=0.0, walls=[], searches=[], compiles_run=compiles,
                  launches={}, trace=None, shape=shape,
                  chunks=chunks(shape["space"], CHUNK))


def counted(n: int) -> None:
    """The counter at ``n``, as the program leaves it under a profiler."""
    from repro_torch.utils import tracing

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count(COUNTER, n)


def shared_steps(name: str) -> int:
    """One compile's shared group steps, from the configuration's runs
    alone: each chunk of 2^20 shares the groups of the runs before the
    first run whose digit differs between its first and last tuples."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    gg = reference.group_nodes(reference.build_graph(cfg["network"]))
    blocks = reference.split_blocks(gg)
    runs = reference.monotone_runs(blocks)
    groups = [sum(len(blocks[b].gids) for b in run) for run in runs]
    strides = [1] * len(runs)
    for q in range(len(runs) - 2, -1, -1):
        strides[q] = strides[q + 1] * (len(runs[q + 1]) + 1)
    size = strides[0] * (len(runs[0]) + 1)
    total = 0
    for lo in range(0, size, CHUNK):
        count = min(CHUNK, size - lo)
        q0 = next((q for q, s in enumerate(strides)
                   if lo // s != (lo + count - 1) // s), len(runs))
        total += sum(groups[:q0]) * count
    return total


def test_share_from_the_counter():
    w = window("yolov2-416", 3)
    steps = 3 * 26 * 7962624
    counted(steps // 4)
    assert reader().read(w) == pytest.approx(25.0, abs=1e-9)
    counted(0)
    assert reader().read(w) == 0.0


def test_no_counter_reads_nothing():
    """The parent's program counts no shared steps: the reader returns
    nothing, and does not raise."""
    from repro_torch.utils import tracing

    tracing.reset()
    assert reader().read(window("yolov3-416", 5)) is None
    counted(10)
    assert reader().read(window("yolov3-416", 0)) is None
    tracing.reset()


@pytest.mark.parametrize("name,share", [("yolov3-416", 72.15),
                                        ("yolov2-416", 6.98)])
def test_the_cells_figures_from_the_runs(name, share):
    compiles = 7
    counted(compiles * shared_steps(name))
    got = reader().read(window(name, compiles))
    from repro_torch.utils import tracing

    tracing.reset()
    assert round(got, 2) == share
