"""The program's side-step counter and its reader, on the CPU: the share
from the counter, nothing where the program counts none, and each
cell's figure from the program's own device loop over the cell's whole
space (``run_chunks`` with its kernels stood in by no-ops: the counter
reads only the chunks' ranges and the allocator's tables), with no count
taken while no profiler records."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

import reference
from harness import spec
from harness.cell import Window
from harness.network import program_accelerator, program_graph

BENCH = Path(__file__).resolve().parent
COUNTER = "alloc.side_steps"


def reader():
    return spec.reader("side_step_share")


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def window(name: str, compiles: int) -> Window:
    shape = reference.shape(config(name)["network"])
    return Window(setup_s=0.0, walls=[], searches=[], compiles_run=compiles,
                  launches={}, trace=None, shape=shape)


def counted(n: int) -> None:
    """The counter at ``n``, as the program leaves it under a profiler."""
    from repro_torch.utils import tracing

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count(COUNTER, n)


def engine(name: str):
    from repro_torch.core.cutpoint import CutpointEngine
    from repro_torch.core.grouping import group_nodes

    cfg = config(name)
    return CutpointEngine(group_nodes(program_graph(cfg["network"])),
                          program_accelerator(cfg["accelerator"]["fields"]),
                          engine="pipeline:torch", device="cpu")


def sub_space(eng, fixed: int = 0):
    """The engine's cut space with its first ``fixed`` runs held mid-run."""
    from repro_torch.kernels import search_pipeline as sp

    return sp.SubSpace.make(tuple(len(r) // 2 for r in eng.runs[:fixed]),
                            [len(r) + 1 for r in eng.runs[fixed:]], "cpu")


def loop_counts(name: str, chunk: int, variant: str, traced: bool,
                fixed: int = 0) -> dict:
    """The counters one pass of the device loop over the configuration's
    space leaves (its first ``fixed`` runs held), its kernels stood in by
    no-ops."""
    from repro_torch.kernels import search_pipeline as sp
    from repro_torch.utils import tracing

    eng = engine(name)
    space = sub_space(eng, fixed)
    stand_ins = {
        "alloc_prefix_cuda": lambda at, tbl, s, c: range(-(-s.size // c)),
        "enum_frames": lambda *a, backend=None: None,
        "alloc_scan": lambda *a, backend=None, state=None:
            SimpleNamespace(io=None, stats=None),
        "cost_rows": lambda *a, backend=None, winner=None: None,
    }
    mp = pytest.MonkeyPatch()
    for k, v in stand_ins.items():
        mp.setattr(sp, k, v)
    try:
        tracing.reset()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                sp.run_chunks(eng, space, "latency", chunk, variant)
        else:
            sp.run_chunks(eng, space, "latency", chunk, variant)
        return tracing.counters()
    finally:
        mp.undo()
        tracing.reset()


def test_share_from_the_counter():
    w = window("mobilenet-v3-224", 3)
    counted(3 * 72 * 15_116_544 // 4)
    assert reader().read(w) == pytest.approx(25.0, abs=1e-9)
    counted(0)
    assert reader().read(w) == 0.0


def test_no_counter_reads_nothing():
    """The parent's program counts no side steps: the reader returns
    nothing, and does not raise."""
    from repro_torch.utils import tracing

    tracing.reset()
    assert reader().read(window("mobilenet-v3-224", 5)) is None
    counted(10)
    assert reader().read(window("mobilenet-v3-224", 0)) is None
    tracing.reset()


@pytest.mark.parametrize("name,chunk,share", [
    ("mobilenet-v3-224", 1 << 20, 25.0),   # 18 of 72 groups, past every g0
    ("yolov2-416", 1024, 0.0),             # the default batch
    ("yolov3-416", 1 << 20, 0.0),
])
def test_the_cells_figures_from_the_device_loop(name, chunk, share):
    from repro_torch.utils import tracing

    counts = loop_counts(name, chunk, "cuda", traced=True)
    w = window(name, 1)
    assert counts[COUNTER] == \
        round(share / 100 * w.shape["groups"] * w.shape["space"])
    counted(counts[COUNTER])
    got = reader().read(w)
    tracing.reset()
    assert round(got, 2) == share


def test_mobilenet_shares_its_prefix_only_before_its_side_groups():
    """Every chunk of 2^20 starts its replay at group 0, 4, 9 or 10, so
    K1 runs all 18 side steps for every candidate, and the shared prefix
    is 7.92 % of the group steps."""
    counts = loop_counts("mobilenet-v3-224", 1 << 20, "cuda", traced=True)
    steps = 72 * 15_116_544
    assert counts[COUNTER] == 18 * 15_116_544
    assert round(100 * counts["alloc.shared_prefix_steps"] / steps, 2) == \
        7.92


@pytest.mark.parametrize("variant", ["torch", "cuda"])
def test_nothing_counted_without_a_profiler(variant):
    counts = loop_counts("mobilenet-v3-224", 1 << 20, variant, traced=False)
    assert counts == {}


def test_a_row_skips_the_side_steps_before_its_chunks_g0():
    """Under the kernels a chunk's replay starts at its ``g0``, so the side
    groups before it are not counted; the plain variant replays, and
    counts, every side group of every candidate.  With mobilenet's first 11
    runs held, every chunk of 40 starts past 8 of its 18 side groups."""
    from repro_torch.kernels import search_pipeline as sp

    eng = engine("mobilenet-v3-224")
    space = sub_space(eng, 11)
    side = eng.alloc_tables().is_side
    want = 0
    for lo in range(0, space.size, 40):
        count = min(40, space.size - lo)
        g0 = sp.shared_prefix(space, eng._run_of, lo, count)
        assert g0 > 42                      # past side groups 11 to 42
        want += int(side[g0:].sum()) * count
    plain = loop_counts("mobilenet-v3-224", 40, "torch", True, fixed=11)
    rows = loop_counts("mobilenet-v3-224", 40, "cuda", True, fixed=11)
    assert plain[COUNTER] == 18 * space.size
    assert rows[COUNTER] == want <= 10 * space.size
