"""The PyTorch port's parallel search pool against the JAX package's, on
the CPU (``device="cpu"``: the plain torch versions of the kernels).

Case for case with tests/test_search_pool.py, on the port:
``search(workers=N)`` returns a ``SearchResult`` bit-identical to the serial path on every zoo
CNN, on the partitioned-exhaustive path and the per-start descent path, and
worker failures surface as errors, never as hangs.  Beyond those:

* the pool (``workers=2``, fork) equals the JAX package's *serial* compile
  on the 8 zoo nets under ``journal``, ``device:torch`` and
  ``pipeline:torch`` (the equalities and the latency rule of
  tests/test_torch_compile.py; efficientnet-b1 against the reference's
  ``batch_size=1`` form, R5);
* ``partition_space`` equals the reference's on every zoo net;
* the start-method rule: a search whose workers touch CUDA ratchets a
  defaulted fork context to spawn, and raises where spawn cannot start;
* a CUDA task never leaves the card: a failing engine raises, and a
  straggler's duplicate is the task itself;
* ROADMAP R10 (``evaluated`` of a ``pallas`` descent, serial and pooled)
  holds in the reference as in the port.
"""
import itertools
import multiprocessing as mp

import pytest

import repro.core.search_pool as ref_pool

import repro_torch.core.compiler as port_compiler
from repro_torch.cnn import build_cnn
from repro_torch.core import search_pool
from repro_torch.core.cutpoint import monotone_runs, search, split_blocks
from repro_torch.core.grouping import group_nodes
from repro_torch.core.hw import KCU1500
from repro_torch.core.options import (CompileOptions, is_cuda_device,
                                      resolve_engine)
from repro_torch.core.search_pool import (TASKS_PER_WORKER,
                                          ParallelSearchDriver, SubspaceTask,
                                          _engine_needs_cuda, partition_space)
from repro_torch.runtime import chaos

from torch_parity import (ALL_CNNS, METRICS, TEST_LIMIT, assert_plans_equal,
                          both, ref_plan)

HAS_FORK = "fork" in mp.get_all_start_methods()
needs_fork = pytest.mark.skipif(not HAS_FORK, reason="fork start method "
                                "required for workers to inherit the "
                                "parent-installed chaos injector")

# the port's engines on the host -> the reference engine each is held to
ENGINES = {"journal": "journal", "device:torch": "device",
           "pipeline:torch": "pipeline:reference"}


def opts(**kw):
    kw.setdefault("engine", "journal")
    return CompileOptions(device="cpu", exhaustive_limit=TEST_LIMIT, **kw)


def assert_results_identical(serial, parallel, ctx=""):
    assert serial.best.cuts == parallel.best.cuts, ctx
    for f in METRICS:
        assert getattr(serial.best, f) == getattr(parallel.best, f), (
            f"{ctx}: {f} serial={getattr(serial.best, f)!r} "
            f"parallel={getattr(parallel.best, f)!r}")
    assert serial.best.policy == parallel.best.policy, ctx
    assert serial.best.alloc.buff == parallel.best.alloc.buff, ctx
    assert serial.best.alloc.spilled == parallel.best.alloc.spilled, ctx
    assert (serial.best.alloc.boundary_writes
            == parallel.best.alloc.boundary_writes), ctx
    assert (serial.best.alloc.boundary_reads
            == parallel.best.alloc.boundary_reads), ctx
    assert serial.evaluated == parallel.evaluated, ctx
    assert serial.runs == parallel.runs, ctx
    assert serial.blocks == parallel.blocks, ctx


@pytest.mark.parametrize("name", ALL_CNNS)
def test_parallel_matches_serial(name):
    gg = group_nodes(build_cnn(name))
    serial = search(gg, KCU1500, opts())
    parallel = search(gg, KCU1500, opts(workers=2))
    assert_results_identical(serial, parallel, ctx=name)
    assert parallel.events == []


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", ALL_CNNS)
def test_pool_equals_reference_serial(name, engine, tmp_path):
    """The whole compile with ``workers=2`` (fork) against the JAX
    package's serial compile of the same net.  ``resume_dir`` forces the
    partitioned path even where the space is below the pool's cutoff, so
    every net's tasks really run in the workers (and journal)."""
    _, port = both(name)
    plan = port_compiler.compile_graph(
        port.graph, port.hw, opts(engine=engine, workers=2,
                                  resume_dir=tmp_path))
    assert plan.search.events == []
    assert len(list(tmp_path.glob("search_*/task_*.rec"))) > 1
    assert_plans_equal(plan, ref_plan(name, ENGINES[engine]),
                       (name, engine))


def test_parallel_matches_serial_forced_coordinate_descent():
    """exhaustive_limit=1 forces the descent fallback even on a small
    space: one worker task per deterministic start, ties broken by start
    order, evaluated = |union of per-start visited tuples|."""
    gg = group_nodes(build_cnn("resnet50", 224))
    base = CompileOptions(engine="journal", device="cpu", exhaustive_limit=1)
    serial = search(gg, KCU1500, base)
    parallel = search(gg, KCU1500, base.replace(workers=2))
    assert_results_identical(serial, parallel, ctx="forced-descent")
    assert parallel.path == "descent"


def test_parallel_exhaustive_below_min_space_cutoff():
    """Forcing the pool onto a tiny space (min_parallel_space=1) must
    still merge to the serial product-order argmin."""
    gg = group_nodes(build_cnn("vgg16-conv", 224))
    serial = search(gg, KCU1500, opts())
    with ParallelSearchDriver(workers=2) as driver:
        parallel = driver.search(gg, KCU1500, opts(), min_parallel_space=1)
    assert_results_identical(serial, parallel, ctx="tiny-exhaustive")


def test_partition_space_is_disjoint_ordered_cover():
    runs = [[0, 1], [2], [3, 4, 5], [6, 7]]
    prefixes, suffix_dims = partition_space(runs, target_tasks=5)
    assert len(prefixes) >= 5
    dims = [range(len(r) + 1) for r in runs]
    full = list(itertools.product(*dims))
    covered = [p + s for p in prefixes
               for s in itertools.product(*[range(d + 1)
                                            for d in suffix_dims])]
    assert covered == full            # disjoint, complete, product order

    # degenerate: target larger than the space -> one task per tuple
    prefixes, suffix_dims = partition_space(runs, target_tasks=10**9)
    assert suffix_dims == []
    assert prefixes == full


@pytest.mark.parametrize("name", ALL_CNNS)
def test_partition_space_equals_reference(name):
    ref, port = both(name)
    assert port.runs == ref.runs
    for workers in (1, 2, 4, 8):
        target = workers * TASKS_PER_WORKER
        assert (partition_space(port.runs, target)
                == ref_pool.partition_space(ref.runs, target)), workers
    assert TASKS_PER_WORKER == ref_pool.TASKS_PER_WORKER
    assert search_pool.MIN_PARALLEL_SPACE == ref_pool.MIN_PARALLEL_SPACE


def test_driver_map_is_ordered_and_reusable():
    with ParallelSearchDriver(workers=2) as driver:
        assert driver.map(abs, [-3, 1, -2]) == [3, 1, 2]
        # the same pool serves a search afterwards
        gg = group_nodes(build_cnn("resnet50", 224))
        result = driver.search(gg, KCU1500, opts())
        assert result.best.feasible
        assert driver.map(abs, [-1]) == [1]


def test_invalid_objective_rejected_before_dispatch():
    """CompileOptions validates eagerly, so an invalid objective raises in
    the caller before any worker is touched."""
    with pytest.raises(ValueError):
        CompileOptions(objective="bogus")


@needs_fork
def test_worker_hard_crash_surfaces_as_runtime_error():
    """A worker that dies without raising (os._exit, on every attempt)
    must surface as a RuntimeError naming the pool -- not hang -- and the
    driver must be usable again once the fault is gone."""
    gg = group_nodes(build_cnn("resnet50", 224))
    driver = ParallelSearchDriver(workers=2, mp_context="fork")
    chaos.install(chaos.ChaosInjector(p_kill=1.0, max_attempt=99))
    try:
        with pytest.raises(RuntimeError, match="worker process died"):
            driver.search(gg, KCU1500, opts())
    finally:
        chaos.uninstall()
    try:
        result = driver.search(gg, KCU1500, opts())   # fresh pool, healthy
        assert_results_identical(search(gg, KCU1500, opts()), result,
                                 ctx="revive")
    finally:
        driver.close()


@needs_fork
def test_worker_raised_exception_propagates():
    """A deterministic exception in a worker (here an objective no
    CompileOptions would let through, put into a task by hand) reaches
    the caller unchanged through the dispatch loop."""
    gg = group_nodes(build_cnn("resnet50", 224))
    runs = monotone_runs(split_blocks(gg))
    with ParallelSearchDriver(workers=2, mp_context="fork") as d:
        [task] = d.subspace_tasks(gg, KCU1500, [(0,)],
                                  [len(r) for r in runs[1:]], opts())
        with pytest.raises(ValueError, match="bogus"):
            d._run_tasks(search_pool._run_subspace,
                         [task._replace(objective="bogus")], keys=[(0,)],
                         events=[])


# ------------------------------------------------------------ start method
def test_cuda_search_ratchets_fork_to_spawn(monkeypatch):
    """A forked child of a CUDA parent cannot use CUDA, so the driver
    ratchets its *defaulted* fork context to spawn exactly for the
    searches whose workers touch CUDA -- and leaves explicit contexts
    alone.  (``CompileOptions`` on a CUDA device validates without one;
    nothing here starts a worker.)"""
    cases = {
        ("pipeline", "cuda", "numpy"): True,
        ("pipeline:torch", "cuda", "numpy"): True,   # plain, on the card
        ("device", "cuda:1", "numpy"): True,
        ("device:torch", "cuda", "numpy"): True,
        ("journal", "cuda", "pallas"): True,         # K5
        ("journal", "cuda", "numpy"): False,         # host code
        ("journal", "cpu", "pallas"): False,
        ("pipeline", "cpu", "numpy"): False,
        ("device:torch", "cpu", "pallas"): False,
    }
    for (engine, device, backend), want in cases.items():
        spec = resolve_engine(engine, device=device)
        assert _engine_needs_cuda(spec, device, backend) is want, (
            engine, device, backend)

    if not HAS_FORK:
        return
    host = CompileOptions(engine="journal")
    card = CompileOptions(engine="pipeline@1048576")
    with ParallelSearchDriver(workers=2) as d:
        assert d.start_method == "fork"
        d._cuda_safe_context(host)
        assert d.start_method == "fork"
        d._cuda_safe_context(card)
        assert d.start_method == "spawn"
        # one-way for the driver's life: later host engines reuse the
        # (universally safe) spawn pool instead of churning workers
        d._cuda_safe_context(host.replace(device="cpu"))
        assert d.start_method == "spawn"

    # an explicit context is the caller's choice
    with ParallelSearchDriver(workers=2, mp_context="fork") as d:
        d._cuda_safe_context(card)
        assert d.start_method == "fork"

    # a parent whose __main__ spawn cannot re-import raises for a search
    # on the card -- it never degrades to the host quietly -- and a host
    # search is untouched
    monkeypatch.setattr(search_pool, "_spawn_main_viable", lambda: False)
    with ParallelSearchDriver(workers=2) as d:
        with pytest.raises(RuntimeError, match="cannot re-import"):
            d._cuda_safe_context(card.replace(backend="pallas"))
        d._cuda_safe_context(host)
        assert d.start_method == "fork"


def test_cuda_search_without_spawn_raises_before_dispatch(monkeypatch):
    """The same refusal through the public entry point: a CUDA search that
    cannot spawn raises before any worker starts or any GPU is asked
    for."""
    monkeypatch.setattr(search_pool, "_spawn_main_viable", lambda: False)
    gg = group_nodes(build_cnn("resnet50", 224))
    with ParallelSearchDriver(workers=2) as d:
        with pytest.raises(RuntimeError, match="spawn"):
            d.search(gg, KCU1500, CompileOptions(
                engine="device", exhaustive_limit=TEST_LIMIT))
        assert d._pool is None


def test_tasks_carry_the_device_and_degrade_to_the_host():
    """Tasks carry the search's device.  A host task's straggler duplicate
    runs the journal engine (keeping the batch); a CUDA task's duplicate is
    the task itself, on the same card."""
    gg = group_nodes(build_cnn("resnet50", 224))
    with ParallelSearchDriver(workers=2) as d:
        [task] = d.subspace_tasks(
            gg, KCU1500, [(1,)], [2] * 7,
            CompileOptions(engine="pipeline:cuda@4096", backend="pallas"))
        [host] = d.descent_tasks(
            gg, KCU1500, [(0,) * 8],
            CompileOptions(engine="device:torch@64", device="cpu"))
    assert isinstance(task, SubspaceTask)
    assert (task.engine, task.device, task.backend) == (
        "pipeline:cuda@4096", "cuda", "pallas")
    assert search_pool._degrade(task) == task
    rescue = search_pool._degrade(host)
    assert (rescue.engine, rescue.device) == ("journal@64", "cpu")
    assert rescue._replace(engine=host.engine) == host


@needs_fork
@pytest.mark.parametrize("limit", [TEST_LIMIT, 1],
                         ids=["exhaustive", "descent"])
def test_cuda_task_failure_raises_and_never_leaves_the_card(
        monkeypatch, tmp_path, limit):
    """On a CUDA device a failing engine (a kernel that does not build or
    launch, an out-of-memory) raises from the search: no task is re-run on
    the host, nothing is journaled, and no plan comes back.  The engine is
    made to fail on CUDA devices (the forked workers inherit the patch), so
    the test means the same with or without a card."""
    real = search_pool._worker_engine

    def failing(token, payload, engine_spec="journal", backend="numpy",
                device="cpu"):
        if is_cuda_device(device):
            raise RuntimeError("kernel launch failed")
        return real(token, payload, engine_spec, backend, device)

    monkeypatch.setattr(search_pool, "_worker_engine", failing)
    gg = group_nodes(build_cnn("resnet50", 224))
    card = CompileOptions(engine="device", device="cuda",
                          exhaustive_limit=limit, resume_dir=tmp_path)
    with ParallelSearchDriver(workers=2, mp_context="fork") as d:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            d.search(gg, KCU1500, card)
    assert not list(tmp_path.glob("search_*/task_*.rec"))


@needs_fork
def test_pallas_descent_evaluated_r10(monkeypatch):
    """ROADMAP R10 in both packages: under ``backend="pallas"`` the serial
    descent counts a tuple each time it is re-scored (float32 scores are
    never memoized), while the pool counts the distinct tuples its starts
    visited.  The reference's interpret-mode kernel is too slow here, so its
    own float32 numpy reference (``score_batch_ref``, to which
    tests/test_score_batch.py holds the kernel) takes its place; the forked
    workers inherit the patch."""
    import repro.kernels.score_batch as ref_sb
    from repro.core import cutpoint as ref_cp
    from repro.core.options import CompileOptions as RefOptions

    monkeypatch.setattr(
        ref_sb, "score_batch_pallas",
        lambda tables, frame, io, bpc, overhead, **_:
        ref_sb.score_batch_ref(tables, frame, io, bpc, overhead))
    ref, port = both("vgg16-conv")
    ropts = RefOptions(engine="journal", backend="pallas",
                       exhaustive_limit=1)
    popts = CompileOptions(engine="journal", backend="pallas", device="cpu",
                           exhaustive_limit=1)
    want_serial = ref_cp.search(ref.gg, ref.hw, ropts)
    with ref_pool.ParallelSearchDriver(workers=2, mp_context="fork") as d:
        want_pool = d.search(ref.gg, ref.hw, ropts)
    got_serial = search(port.gg, port.hw, popts)
    got_pool = search(port.gg, port.hw, popts.replace(workers=2))
    for want, got in ((want_serial, got_serial), (want_pool, got_pool)):
        assert tuple(got.best.cuts) == tuple(want.best.cuts)
        assert got.evaluated == want.evaluated
    assert (got_serial.evaluated, got_pool.evaluated) == (117, 32)
