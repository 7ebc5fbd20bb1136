"""The readers of the program's spans and of its upload counter, on the
``small`` cell on the CPU: each returns a number after compiles under a
profiler and nothing from an empty store, and the spans they read lie
inside the compiles' walls."""
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from harness import spec, traffic
from harness.cell import Port, Window, run_cell

SEED = 2 ** 31 + 23
COMPILES = 3
SPAN_METRICS = ("group_ms", "plan_ms", "tables_ms", "winner_ms",
                "enqueue_ms", "readback_wait_ms")
METRICS = SPAN_METRICS + ("uploads_per_compile",)


def compiles(small, n: int, traced: bool) -> Window:
    """``n`` compiles of the cell's first request after a warm one, under a
    CPU profiler when ``traced``; the store holds only theirs."""
    from repro_torch.utils import tracing

    root, name = small
    cell = spec.load_cell(name, root)
    fields = cell.config["accelerator"]["fields"]
    req = traffic.one_round(cell.traffic)[0]
    port = Port(cell.config["network"], "cpu")
    args = port.prepare(traffic.accelerator(cell.config, req),
                        traffic.options(cell.traffic, cell.config, req,
                                        fields))
    port.compile(args)
    tracing.reset()
    walls = []
    prof = profile(activities=[ProfilerActivity.CPU]) if traced else None
    if traced:
        prof.__enter__()
    try:
        for _ in range(n):
            t = time.perf_counter()
            port.compile(args)
            walls.append(time.perf_counter() - t)
    finally:
        if traced:
            prof.__exit__(None, None, None)
    return Window(setup_s=0.0, walls=walls, searches=[], compiles_run=n,
                  launches={}, trace=None, shape={})


def read_all(small, window) -> dict:
    root, _ = small
    return {m: spec.reader(m, root).read(window) for m in METRICS}


def test_readers_read_a_traced_window(small):
    w = compiles(small, COMPILES, traced=True)
    got = read_all(small, w)
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    # the sub-space's digits, the pipeline's 7 tables, the allocator's 4
    assert got["uploads_per_compile"] == 12.0
    wall_ms = 1e3 * sum(w.walls) / len(w.walls)
    assert got["group_ms"] + got["plan_ms"] <= wall_ms
    assert (got["tables_ms"] + got["winner_ms"] + got["enqueue_ms"]
            + got["readback_wait_ms"]) <= wall_ms


@pytest.mark.parametrize("traced", [False, True],
                         ids=["untraced", "reset"])
def test_readers_read_nothing_from_an_empty_store(small, traced):
    from repro_torch.utils import tracing

    w = compiles(small, 1, traced=traced)
    if traced:
        tracing.reset()
    assert read_all(small, w) == dict.fromkeys(METRICS)


def test_traced_run_reports_the_span_metrics(small):
    from repro_torch.utils import tracing

    root, cell = small
    tracing.reset()
    r = run_cell(cell, SEED, 1.0, True, time.perf_counter(), device="cpu",
                 root=root, log=lambda _msg: None)
    tracing.reset()
    assert r["correct"]
    for m in METRICS:
        assert r["metrics"][m]["value"] > 0, m
    assert r["metrics"]["uploads_per_compile"]["value"] == 12.0
