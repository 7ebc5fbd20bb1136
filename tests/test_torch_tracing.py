"""The port's spans and counters (``repro_torch/utils/tracing.py``) and the
marks on the compile path: recorded under a torch profiler, in its trace and
in the store alike, nested as the compiler's layers are; nothing recorded and
nothing changed without one."""
import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.cnn.zoo import build_cnn
from repro_torch.core.compiler import compile_graph
from repro_torch.core.grouping import group_nodes
from repro_torch.core.hw import KCU1500
from repro_torch.core.options import CompileOptions
from repro_torch.kernels.alloc_scan import pack_alloc_tables
from repro_torch.kernels.search_pipeline import PipelineTables
from repro_torch.service import encode_plan
from repro_torch.utils import tracing
from torch_ranks import one_thread

one_thread()

NET = "vgg16-conv"                  # 1,080 cut tuples: two chunks of 1,024
OPTS = CompileOptions(device="cpu")  # the pipeline's plain variant
COMPILES = 2
# span -> (its parent, how many a compile opens)
MARKS = {
    "compile": (None, 1),
    "compile.group": ("compile", 1),
    "search": ("compile", 1),
    "compile.plan": ("compile", 1),
    "search.engine": ("search", 1),
    # the sub-space's digits, the pipeline's tables, the allocator's
    "pipeline.tables": ("search", 3),
    "pipeline.enqueue": ("search", 1),
    "pipeline.readback": ("search", 1),
    "search.reprice": ("search", 1),
    "search.oracle": ("search", 1),
}


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def graph():
    return build_cnn(NET)


@pytest.fixture(scope="module")
def traced(graph):
    """Two compiles under the profiler: ``(plans, records, totals,
    counters, the trace's events as (start_ns, end_ns, name))``."""
    tracing.reset()
    with profiled() as prof:
        plans = [compile_graph(graph, KCU1500, OPTS)
                 for _ in range(COMPILES)]
    events = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                     ev.name())
                    for ev in prof.profiler.kineto_results.events())
    out = (plans, tracing.records(), tracing.totals(), tracing.counters(),
           events)
    tracing.reset()
    return out


# ------------------------------------------------------------ the module
def test_off_span_is_one_shared_object_that_records_nothing():
    tracing.reset()
    a, b = tracing.span("x"), tracing.span("y")
    assert a is b
    with a:
        tracing.count("n", 5)
    assert tracing.records() == [] and tracing.counters() == {}


def test_on_span_records_its_parent_compile_and_interval():
    tracing.reset()
    with profiled():
        with tracing.span("outside"):
            pass
        with tracing.span("compile"):
            with tracing.span("a"):
                with tracing.span("b"):
                    tracing.count("n", 2)
                tracing.count("n")
        with tracing.span("compile"):
            pass
    recs = tracing.records()
    tracing.reset()
    assert [r.name for r in recs] == ["outside", "compile", "a", "b",
                                      "compile"]
    assert [r.parent for r in recs] == [-1, -1, 1, 2, -1]
    first = recs[1].compile_id
    assert recs[0].compile_id is None
    assert [r.compile_id for r in recs[1:]] == [first] * 3 + [first + 1]
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            up = recs[r.parent]
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns


def test_totals_self_seconds_subtract_the_children():
    tracing.reset()
    with profiled():
        with tracing.span("p"):
            for _ in range(3):
                with tracing.span("c"):
                    sum(range(1000))
    recs = tracing.records()
    t = tracing.totals()
    tracing.reset()
    dur = {i: (r.end_ns - r.start_ns) / 1e9 for i, r in enumerate(recs)}
    assert t["c"]["count"] == 3 and t["p"]["count"] == 1
    assert t["c"]["self_seconds"] == pytest.approx(t["c"]["seconds"])
    assert t["p"]["seconds"] == pytest.approx(dur[0])
    assert t["p"]["self_seconds"] == pytest.approx(
        dur[0] - dur[1] - dur[2] - dur[3])
    assert 0 <= t["p"]["self_seconds"] <= t["p"]["seconds"]


def test_reset_clears_spans_and_counters_and_drops_open_parents():
    tracing.reset()
    with profiled():
        with tracing.span("compile"):
            tracing.count("n")
            tracing.reset()
            with tracing.span("after"):
                pass
        assert tracing.counters() == {}
    [after] = tracing.records()
    tracing.reset()
    assert after.name == "after" and after.parent == -1


def run_threads(work, tags):
    threads = [threading.Thread(target=work, args=(t,)) for t in tags]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def test_a_thread_the_profiler_does_not_cover_records_nothing():
    tracing.reset()
    with profiled():
        run_threads(lambda tag: tracing.span(tag).__enter__(), ["t"])
        with tracing.span("main"):
            pass
    assert [r.name for r in tracing.records()] == ["main"]
    tracing.reset()


def test_threads_keep_their_own_stacks(monkeypatch):
    """Two threads recording at once (as where the profiler's state is
    handed to a thread) each nest under their own spans."""
    monkeypatch.setattr(tracing, "recording", lambda: True)
    tracing.reset()
    go = threading.Barrier(2, timeout=30)

    def work(tag):
        with tracing.span(f"outer.{tag}"):
            go.wait()
            with tracing.span(f"inner.{tag}"):
                go.wait()

    run_threads(work, "ab")
    recs = tracing.records()
    tracing.reset()
    assert len(recs) == 4
    for tag in "ab":
        [inner] = [r for r in recs if r.name == f"inner.{tag}"]
        assert recs[inner.parent].name == f"outer.{tag}"


# ------------------------------------------------------- the compile path
def test_one_compile_root_per_compile_each_its_own_id(traced):
    _, recs, _, _, _ = traced
    roots = [r for r in recs if r.name == "compile"]
    assert len(roots) == COMPILES
    assert all(r.parent == -1 for r in roots)
    ids = [r.compile_id for r in roots]
    assert len(set(ids)) == COMPILES and None not in ids
    for r in recs:
        assert r.compile_id in ids


@pytest.mark.parametrize("name", list(MARKS))
def test_span_is_nested_under_its_parent(traced, name):
    _, recs, totals, _, _ = traced
    parent, per_compile = MARKS[name]
    mine = [r for r in recs if r.name == name]
    assert len(mine) == per_compile * COMPILES
    for r in mine:
        assert r.end_ns is not None
        if parent is None:
            continue
        up = recs[r.parent]
        assert up.name == parent and up.compile_id == r.compile_id
        assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
    t = totals[name]
    assert t["count"] == len(mine)
    assert 0 <= t["self_seconds"] <= t["seconds"]


# the trace's clock is read a little apart from the store's
CLOCK_SLACK_NS = 100_000


@pytest.mark.parametrize("name", list(MARKS))
def test_trace_holds_each_span_as_often_as_the_store(traced, name):
    """As often, and each of the trace's ranges inside its record's: the
    two share one clock."""
    _, recs, _, _, events = traced
    ranges = [(s, e) for s, e, n in events if n == name]
    mine = [r for r in recs if r.name == name]
    assert len(ranges) == len(mine)
    for (s, e), r in zip(ranges, mine):
        assert r.start_ns - CLOCK_SLACK_NS <= s <= e \
            <= r.end_ns + CLOCK_SLACK_NS


def test_only_the_marks_are_recorded(traced):
    _, recs, _, _, _ = traced
    assert {r.name for r in recs} == set(MARKS)


def test_uploads_count_the_table_tensors_built(traced, graph):
    _, _, _, counters, _ = traced
    gg = group_nodes(graph)
    pipeline = [f for f in dataclasses.fields(PipelineTables)
                if f.type == "torch.Tensor"]
    alloc = pack_alloc_tables(gg, KCU1500).dev
    digits = 1
    per_compile = len(pipeline) + len(alloc) + digits
    assert per_compile == 12
    # vgg16-conv has no SE side path: its side-step counter reads 0
    assert counters == {"pipeline.uploads": per_compile * COMPILES,
                        "alloc.side_steps": 0}


def test_nothing_recorded_without_a_profiler(graph):
    tracing.reset()
    compile_graph(graph, KCU1500, OPTS)
    assert not torch.autograd._profiler_enabled()
    assert tracing.records() == [] and tracing.counters() == {}


def test_plan_is_the_same_with_the_profiler_on_and_off(traced, graph):
    plans = traced[0]
    off = encode_plan(compile_graph(graph, KCU1500, OPTS))
    assert all(encode_plan(p) == off for p in plans)
    tracing.reset()
