"""Parallel cut-space search pool with a fault-tolerant runtime.

The cut-point optimizer's exhaustive path walks the cross-product of cut
positions, one per monotone run (see cutpoint.py); yolov2 alone is ~7.9M
tuples.  :class:`ParallelSearchDriver` farms that space out to a
``multiprocessing`` worker pool, and each worker runs the search's engine
itself -- on a CUDA ``device`` that means each worker launches the
kernels (K2 -> K1 -> K3 with K4 in K3's block 0 under ``pipeline``, K1
under ``device``, K5 under ``backend="pallas"``) in its own CUDA context:

* **Partitioning** -- the product space is split into disjoint sub-spaces
  along the *leading* monotone-run axes: the smallest prefix of runs whose
  dimension product reaches ``~8 tasks per worker`` is enumerated in the
  parent, and each resulting prefix tuple becomes one task covering
  ``prefix x product(remaining runs)``.  Every task has the same size and
  walks its suffix in product order.
* **Per-worker engines** -- each worker builds its own ``CutpointEngine``
  for the (graph, hardware) pair once per search and keeps it across all
  tasks of that search.  The graph is *serialized* once per search; the
  ``bytes`` ride along with every task, and workers deserialize it only
  when their cached engine token changes, i.e. once per search.
* **Deterministic merge** -- each task returns its sub-space argmin as a
  :class:`~repro_torch.core.cutpoint.CandidateMetrics`.  The parent
  reduces them with the key ``(objective key, cut tuple)``.  Serial
  ``search`` keeps the *first* optimum in product order, and product
  order over ``range`` axes *is* lexicographic order of the tuples, so
  this merge reproduces the serial winner bit-for-bit -- same cuts, same
  metrics, same ``SearchResult.evaluated`` -- regardless of worker count
  or scheduling.

When the space exceeds ``exhaustive_limit`` the serial fallback is
coordinate descent from three deterministic starts; the pool then runs one
*start* per task.  A start's trajectory depends only on exact candidate
values, so per-start results are identical to serial, ties between starts
break by start order exactly as the serial loop's strict ``<`` does, and
``evaluated`` is recovered as the size of the union of the per-start
visited-tuple sets.

:meth:`ParallelSearchDriver.map` exposes the pool for any
embarrassingly-parallel loop of module-level functions.

Start method
------------

A forked child of a parent that has used CUDA cannot use CUDA.  So a search
whose workers will touch a CUDA tensor -- ``device`` is CUDA and either the
engine is not ``journal`` or ``backend="pallas"`` -- ratchets a defaulted
``fork`` context to ``spawn`` before the pool is (re)created, one way for
the driver's life.  Host engines keep fork's millisecond start.  An explicit
``mp_context`` is honoured.  Where spawn cannot re-import the parent's
``__main__`` (a script fed on stdin) such a search raises: it never leaves
the card quietly.  Every worker runs :func:`_init_worker` first: one torch
thread (pool workers x cores would oversubscribe the host), and the chaos
injector installed in the parent when the pool was created, which is how a
spawn worker receives a fault schedule.

Failure semantics (the fault-tolerant runtime)
----------------------------------------------

Task results are pure functions of ``(token, sub-space)``, which is what
makes every recovery action below *safe*: re-running a task, racing a
duplicate against a straggler, or replaying a journaled result can never
change the deterministic merge.  The dispatch loop distinguishes four
failure classes:

* **Deterministic worker exceptions** propagate to the caller unchanged,
  exactly as the serial path would raise them.
* **Lost tasks** -- a worker process dying outright (OOM kill, signal,
  ``os._exit``) breaks the whole ``ProcessPoolExecutor``.  The driver keeps
  the completed results, rebuilds the pool, and re-dispatches the tasks
  that were in flight, each with bounded attempts (``max_retries``,
  default 2); a task that keeps dying raises ``RuntimeError`` -- never a
  hang, never a silently partial result.  Injected transient failures
  (:class:`repro_torch.runtime.chaos.ChaosError`) are retried under the
  same bound without killing the pool.
* **Stragglers / deadlines** -- with ``task_deadline_s`` set, a task
  running past its deadline (tightened by a task-grain EWMA,
  ``StragglerMonitor.straggler_after``) gets one speculative duplicate;
  first completion wins.  On the host the duplicate runs the journal
  engine (:func:`repro_torch.core.options.degrade_engine`); on a CUDA
  ``device`` it is the same task on the same card.
* **Engine degradation** -- on the host, a worker whose ``device`` /
  ``pipeline`` engine raises re-runs the task under the journal engine and
  reports a ``device_fallback`` event (bit-identical: the replays are).
  On a CUDA ``device`` nothing degrades: a task never moves off the card,
  so a kernel that fails to build or launch, or a CUDA out-of-memory,
  propagates like any deterministic worker exception (an injected
  ``ChaosError`` is retried on the card).

Every recovery is surfaced as a :class:`FaultEvent` on
``SearchResult.events`` (retry / straggler / device_fallback / resume /
preempted) -- the result says not just *what* won but *what it survived*.

Checkpointed resume: with ``resume_dir`` set, every completed task's
result is committed to a :class:`repro_torch.checkpoint.checkpoint.
TaskJournal` (atomic rename + digest, keyed by a content hash of the
graph/hw payload + ``CompileOptions.plan_key()`` + partition -- never
scheduling-only knobs such as the engine or the device), journaled tasks
are skipped on the next run with identical merged results (including
``evaluated``), and a :class:`~repro_torch.runtime.fault_tolerance.
PreemptionGuard` wired into the driver (the ``guard`` knob) drains
in-flight tasks on SIGTERM, journals them, and raises
:class:`SearchPreempted`.  A corrupt journal record raises
``JournalError`` instead of resuming from damaged state.

All failure paths are exercised deterministically by the seeded
fault-injection harness in ``runtime/chaos.py``.
"""
from __future__ import annotations

import hashlib
import itertools
import multiprocessing as mp
import os
import pickle
import sys
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass
from typing import NamedTuple

from repro_torch.core import cutpoint as _cp
from repro_torch.core.options import (degrade_engine, is_cuda_device,
                                      resolve_engine)
from repro_torch.runtime import chaos as _chaos
from repro_torch.runtime.fault_tolerance import (PreemptionGuard,
                                                 StragglerMonitor)

# Sub-space tasks created per worker on the exhaustive path.  More tasks
# than workers smooths the tail; the per-task cost is one small pickle
# round-trip.
TASKS_PER_WORKER = 8

# Below this many tuples the pool's fixed costs (process startup, one
# engine build per worker) exceed the search itself; the driver runs the
# serial path, which is bit-identical anyway.  (With ``resume_dir`` set the
# partitioned path always runs, so even small compiles journal at task
# granularity.)
MIN_PARALLEL_SPACE = 4096

# Dispatch-loop poll period: the granularity of preemption checks and
# deadline/straggler sweeps while waiting on in-flight futures.
_TICK_S = 0.05

class SearchPreempted(RuntimeError):
    """Raised by the dispatch loop after a clean preemption drain: no new
    tasks were started, in-flight tasks were awaited and journaled (when a
    journal is open), and the compile can resume from ``resume_dir``."""


@dataclass(frozen=True)
class FaultEvent:
    """One recovery action taken by the fault-tolerant dispatch loop,
    surfaced on ``SearchResult.events`` rather than silently absorbed."""

    kind: str            # "retry" | "straggler" | "device_fallback" |
    #                      "resume" | "preempted"
    task: object = None  # task identity (sub-space prefix / descent start)
    attempt: int = 0
    detail: str = ""


class SubspaceTask(NamedTuple):
    """One exhaustive task: ``prefix x product(range(d + 1) for d in
    suffix_dims)`` under ``engine`` / ``backend`` on ``device``."""
    token: tuple
    payload: bytes                 # pickled (grouped graph, hw)
    prefix: tuple
    suffix_dims: tuple
    objective: str
    batch_size: int | None
    engine: str
    backend: str
    device: str
    prune: bool = False
    incumbent: object = None       # best objective key seen so far


class DescentTask(NamedTuple):
    """One coordinate-descent start."""
    token: tuple
    payload: bytes
    start: tuple
    objective: str
    batch_size: int | None
    engine: str
    backend: str
    device: str


# ---------------------------------------------------------- worker globals
# Engines per worker process, keyed by (search token, engine spelling,
# scoring backend, device) -- rebuilt when the token changes (a fresh token
# per driver search keeps each engine's memo in the exact state the serial
# implementation's fresh engine has, which is what makes `evaluated` -- a
# cache-miss count -- reproducible).  A host task that degrades mid-search
# needs a *separate* journal-engine instance, hence the other fields.
_ENGINES: dict = {}


def _init_worker(injector) -> None:
    """Runs first in every pool worker: one torch thread, and the chaos
    injector the parent had installed when it created the pool (a spawn
    worker inherits nothing else of the parent's state)."""
    import torch
    torch.set_num_threads(1)
    if injector is not None:
        _chaos.install(injector)


def _worker_engine(token: tuple, payload: bytes,
                   engine_spec: str = "journal",
                   backend: str = "numpy",
                   device: str = "cpu") -> "_cp.CutpointEngine":
    key = (token, engine_spec, backend, device)
    engine = _ENGINES.get(key)
    if engine is None:
        # a new search token invalidates engines of previous searches
        for old in [k for k in _ENGINES if k[0] != token]:
            del _ENGINES[old]
        gg, hw = pickle.loads(payload)
        engine = _ENGINES[key] = _cp.CutpointEngine(
            gg, hw, backend=backend, engine=engine_spec, device=device)
    return engine


def _engine_needs_cuda(spec, device: str, backend: str = "numpy") -> bool:
    """Whether worker processes will touch a CUDA tensor for this search:
    a CUDA ``device`` under the ``device`` / ``pipeline`` engines (either
    variant: ``:torch`` runs the plain versions on the card), or under any
    engine with ``backend="pallas"`` (K5).  The journal engine with the
    exact scorer is host code whatever ``device`` says."""
    return is_cuda_device(device) and (spec.name != "journal"
                                       or backend == "pallas")


def _spawn_main_viable() -> bool:
    """Whether spawn-started workers can initialize.

    ``multiprocessing``'s spawn path re-imports the parent's ``__main__``
    in the child (unless the parent is ``python -c``/embedded, where it
    skips the step).  A parent fed from stdin records ``<stdin>`` as its
    main path, which the child then fails to open -- every worker dies at
    startup."""
    main = sys.modules.get("__main__")
    if main is None or getattr(getattr(main, "__spec__", None),
                               "name", None):
        return True                      # python -m style: import by name
    if sys.argv[0] in ("", "-c"):
        return True                      # spawn skips main re-import
    path = getattr(main, "__file__", None)
    return path is None or os.path.exists(path)


def _on_device(engine_name: str, backend: str, device: str) -> bool:
    """Whether the task's engine runs anything on ``device`` that can fail
    apart from the host replay: the chaos ``"device"`` site."""
    return engine_name != "journal" or (backend == "pallas"
                                        and is_cuda_device(device))


def _may_degrade(engine_name: str, device: str) -> bool:
    """Whether a failing engine is replaced by the journal engine: only on
    the host.  A task on a CUDA ``device`` never leaves the card."""
    return engine_name != "journal" and not is_cuda_device(device)


def _fallback_event(engine_name: str, device: str, e: Exception) -> tuple:
    return (("device_fallback",
             f"{engine_name} engine on {device} failed ({e!r}); journal "
             f"engine on {device} substituted"),)


def _run_subspace(task: SubspaceTask, attempt: int = 0):
    """Evaluate ``prefix x product(suffix_dims)``.

    Returns ``(argmin CandidateMetrics, #evals, #pruned, worker
    events)``.  Ties keep the first optimum in product order, as serial
    search does.  With ``prune`` on and an inherited incumbent key, whole
    sub-trees whose admissible bound exceeds the incumbent are skipped;
    the argmin is ``None`` only when the *entire* task falls to the
    incumbent, which is safe because the global optimum's own task can
    never prune it.  On the host a failing device/pipeline engine degrades
    to the journal engine in-task (bit-identical by contract) and reports
    a ``device_fallback`` event instead of failing the task; on a CUDA
    ``device`` the failure propagates.
    """
    # chaos site at task start, keyed by the task's identity so faults
    # are scheduling-independent
    _chaos.maybe_fire("task", task.prefix, attempt)
    engine_name = resolve_engine(task.engine, device=task.device).name

    def score(engine):
        before = engine.evaluations
        best, pruned = engine.run_subspace(
            task.prefix, list(task.suffix_dims), task.objective,
            batch_size=task.batch_size, incumbent_key=task.incumbent,
            prune=task.prune)
        return best, engine.evaluations - before, pruned

    events: tuple = ()
    try:
        engine = _worker_engine(task.token, task.payload, task.engine,
                                task.backend, task.device)
        if _on_device(engine_name, task.backend, task.device):
            # chaos site for injected backend failures (tests/benchmarks)
            _chaos.maybe_fire("device", task.prefix, attempt)
        best, n, pruned = score(engine)
    except Exception as e:
        if not _may_degrade(engine_name, task.device):
            raise
        # a host engine raised: degrade to the journal engine -- logged,
        # never silent, and bit-identical by the engine contract
        engine = _worker_engine(task.token, task.payload,
                                degrade_engine(task.engine), task.backend,
                                task.device)
        best, n, pruned = score(engine)
        events = _fallback_event(engine_name, task.device, e)
    return best, n, pruned, events


def _run_descent(task: DescentTask, attempt: int = 0):
    """One coordinate-descent start.

    Returns ``(final CandidateMetrics, visited frozenset, worker
    events)``.  Runs ``cutpoint.coordinate_descent`` itself -- the one
    definition of the descent trajectory -- so the returned point is the
    one the serial loop reaches from this start, by construction.  Engine
    degradation mirrors ``_run_subspace``.
    """
    _chaos.maybe_fire("task", task.start, attempt)
    engine_name = resolve_engine(task.engine, device=task.device).name

    def run(engine):
        visited: set[tuple[int, ...]] = set()
        cur = _cp.coordinate_descent(engine, task.start, task.objective,
                                     on_eval=visited.add,
                                     batch_size=task.batch_size)
        return cur, frozenset(visited)

    events: tuple = ()
    try:
        engine = _worker_engine(task.token, task.payload, task.engine,
                                task.backend, task.device)
        if _on_device(engine_name, task.backend, task.device):
            _chaos.maybe_fire("device", task.start, attempt)
        cur, visited = run(engine)
    except Exception as e:
        if not _may_degrade(engine_name, task.device):
            raise
        engine = _worker_engine(task.token, task.payload,
                                degrade_engine(task.engine), task.backend,
                                task.device)
        cur, visited = run(engine)
        events = _fallback_event(engine_name, task.device, e)
    return cur, visited, events


def _degrade(task):
    """The straggler duplicate of ``task``.  On the host it runs the
    journal engine (via :func:`repro_torch.core.options.degrade_engine`,
    which preserves an explicit ``@batch`` suffix): if the device or
    pipeline replay is what's hanging, the rescue must not hang with it.
    On a CUDA ``device`` it is the task itself: work asked of the card
    stays on the card.  The other fields ride along unchanged."""
    if is_cuda_device(task.device):
        return task
    return task._replace(engine=degrade_engine(task.engine))


# ----------------------------------------------------- journal record codec
def _encode_subspace(result) -> dict:
    m, n, pruned, _events = result
    rec = {"evals": int(n), "pruned": int(pruned)}
    if m is not None:                      # task may be pruned away whole
        rec.update({"cuts": [int(c) for c in m.cuts],
                    "lat": float(m.latency_cycles),
                    "dram_total": int(m.dram_total),
                    "dram_fm": int(m.dram_fm), "sram": int(m.sram_total),
                    "bram": int(m.bram18k), "feasible": bool(m.feasible)})
    return rec


def _decode_metrics(rec: dict) -> "_cp.CandidateMetrics":
    return _cp.CandidateMetrics(
        cuts=tuple(rec["cuts"]), latency_cycles=rec["lat"],
        dram_total=rec["dram_total"], dram_fm=rec["dram_fm"],
        sram_total=rec["sram"], bram18k=rec["bram"],
        feasible=rec["feasible"])


def _decode_subspace(rec: dict):
    m = _decode_metrics(rec) if rec.get("cuts") is not None else None
    return m, rec["evals"], rec.get("pruned", 0), ()


def _encode_descent(result) -> dict:
    m, visited, _events = result
    rec = _encode_subspace((m, 0, 0, ()))
    del rec["evals"]
    del rec["pruned"]
    rec["visited"] = sorted([int(c) for c in t] for t in visited)
    return rec


def _decode_descent(rec: dict):
    visited = frozenset(tuple(t) for t in rec["visited"])
    return _decode_metrics(rec), visited, ()


def partition_space(runs: list[list[int]],
                    target_tasks: int) -> tuple[list[tuple[int, ...]],
                                                list[int]]:
    """Split the cut product space along the leading monotone-run axes.

    Takes the smallest ``k`` such that the first ``k`` axes enumerate at
    least ``target_tasks`` prefixes (or all axes, for small spaces) and
    returns ``(prefixes, suffix_dims)``: every ``prefix x
    product(range(d+1) for d in suffix_dims)`` is one equal-sized, disjoint
    sub-space, and concatenating them in prefix order reproduces the full
    product enumeration order.
    """
    k, tasks = 0, 1
    while k < len(runs) and tasks < target_tasks:
        tasks *= len(runs[k]) + 1
        k += 1
    prefixes = list(itertools.product(*[range(len(r) + 1)
                                        for r in runs[:k]]))
    suffix_dims = [len(r) for r in runs[k:]]
    return prefixes, suffix_dims


class ParallelSearchDriver:
    """Persistent worker pool for cut-space search and generic fan-out.

    Parameters
    ----------
    workers:
        Worker process count; ``None`` means ``os.cpu_count()`` (on a CUDA
        ``device``, that many CUDA contexts).
    mp_context:
        ``multiprocessing`` start method.  Default: ``"fork"`` where
        available, ratcheted to ``"spawn"`` for the driver's life by the
        first search whose workers touch CUDA (see the module docstring,
        :meth:`_cuda_safe_context`).  Passing ``mp_context`` explicitly
        disables the ratchet.
    max_retries:
        Re-dispatch budget per task for *transient* failures (a dead
        worker process breaking the pool, an injected ``ChaosError``, a
        straggler duplicate).  A task still failing after
        ``max_retries`` re-dispatches raises ``RuntimeError``.
        Deterministic worker exceptions are never retried.
    task_deadline_s:
        Per-task wall-clock deadline.  A task running past it (or past
        the task-grain EWMA straggler bound once warmed, whichever is
        sooner) gets one speculative duplicate; first completion wins.
        ``None`` (default) disables deadlines and speculation.
    guard:
        A :class:`~repro_torch.runtime.fault_tolerance.PreemptionGuard` to
        poll in the dispatch loop; when it trips (SIGTERM/SIGINT), the
        driver drains in-flight tasks, journals them (under
        ``resume_dir``) and raises :class:`SearchPreempted`.
    straggler_threshold:
        EWMA multiple beyond which an in-flight task counts as a
        straggler (only with ``task_deadline_s`` set).

    The pool is created lazily on first use and reused across calls; use
    the driver as a context manager (or call :meth:`close`) to reap the
    worker processes deterministically.
    """

    def __init__(self, workers: int | None = None,
                 mp_context: str | None = None,
                 max_retries: int = 2,
                 task_deadline_s: float | None = None,
                 guard: "PreemptionGuard | None" = None,
                 straggler_threshold: float = 4.0):
        self.workers = max(1, workers or os.cpu_count() or 1)
        self._explicit_ctx = mp_context is not None
        if mp_context is None and "fork" in mp.get_all_start_methods():
            mp_context = "fork"
        self._ctx = mp.get_context(mp_context) if mp_context else None
        self._pool: ProcessPoolExecutor | None = None
        self._searches = 0
        self.max_retries = max(0, max_retries)
        self.task_deadline_s = task_deadline_s
        self.guard = guard
        self.straggler_threshold = straggler_threshold

    # ------------------------------------------------------------- plumbing
    @property
    def start_method(self) -> str:
        """The start method the next pool's workers get."""
        ctx = self._ctx if self._ctx is not None else mp.get_context()
        return ctx.get_start_method()

    def _executor(self) -> ProcessPoolExecutor:
        if self._pool is None:
            injector = _chaos.active()
            if injector is not None and self.start_method != "fork":
                for (site, key), ev in injector.events.items():
                    if ev.action == "hold":
                        raise ValueError(
                            f"chaos hold at {site}:{key!r}: its gate is "
                            f"fork-inherited, and {self.start_method!r} "
                            f"workers cannot receive it")
            self._pool = ProcessPoolExecutor(
                max_workers=self.workers, mp_context=self._ctx,
                initializer=_init_worker, initargs=(injector,))
        return self._pool

    def _cuda_safe_context(self, opts) -> None:
        """Make a search whose workers touch CUDA start them under spawn.

        CUDA cannot be used in a forked child of a parent that has used
        it (and chip-side callers have, by the time they search).  For
        such searches the defaulted fork context is ratcheted to spawn --
        one-way for the life of the driver, since spawn is safe for every
        engine and flip-flopping would churn worker pools (and their
        per-process engine caches).  Host engines keep fork.  When spawn
        cannot reconstruct the parent's ``__main__`` (a stdin-fed script)
        this raises: the JAX package degrades to the host replay there,
        but a search asked to run on the card must not leave it quietly.
        An explicit ``mp_context`` from the caller is always honoured.
        """
        if self._explicit_ctx or not _engine_needs_cuda(
                opts.engine_spec(), opts.device, opts.backend):
            return
        if self.start_method != "fork":
            return
        if not _spawn_main_viable():
            raise RuntimeError(
                f"engine={opts.engine!r}, backend={opts.backend!r} on "
                f"device={opts.device!r} runs CUDA inside the worker "
                f"processes, which needs the spawn start method (a forked "
                f"child of a CUDA parent cannot use CUDA), and spawn cannot "
                f"re-import this process's __main__ "
                f"({getattr(sys, 'argv', ['?'])[0]!r}); run from an "
                f"importable script or module, search with workers=1, or "
                f"pass mp_context explicitly")
        self._reset()
        self._ctx = mp.get_context("spawn")

    def map(self, fn, items, chunksize: int = 1) -> list:
        """Ordered parallel map (the generic face of the pool).

        ``fn`` must be a module-level callable; results come back in input
        order.  Worker exceptions propagate; a dead worker process raises
        ``RuntimeError`` instead of hanging the caller.  ``map`` does NOT
        retry -- generic callables are not known to be pure; the retrying
        dispatch loop is reserved for the search task functions, whose
        purity makes re-execution safe.
        """
        try:
            return list(self._executor().map(fn, items, chunksize=chunksize))
        except BrokenProcessPool as e:
            self._reset()
            raise RuntimeError(
                f"search-pool worker process died (workers={self.workers}); "
                f"the pool has been discarded") from e

    def _reset(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self) -> "ParallelSearchDriver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------- fault-tolerant loop
    def _open_journal(self, resume_dir, payload: bytes, opts, mode: str,
                      parts):
        """A TaskJournal keyed by the content hash of (graph+hw payload,
        ``CompileOptions.plan_key()``, partition) -- resuming is only
        legal when every one of those matches; scheduling-only knobs
        (batch_size, engine, device, worker count at fixed partition) are
        deliberately excluded, since results are bit-identical across
        them.  Keying on the full ``plan_key()`` keeps e.g. a
        ``prune=True, count_pruned=False`` run from resuming off records
        a ``prune=False`` run committed -- their per-task eval/pruned
        splits differ, so cross-resuming would corrupt ``evaluated``."""
        from repro_torch.checkpoint.checkpoint import TaskJournal
        h = hashlib.sha256()
        h.update(payload)
        h.update(repr((opts.plan_key(), mode, parts)).encode())
        return TaskJournal(resume_dir, h.hexdigest()[:16])

    def _run_tasks(self, fn, tasks: list, keys: list, events: list,
                   journal=None, encode=None, decode=None, degrade=None,
                   prepare=None, observe=None):
        """Dispatch ``tasks`` with retry, healing, deadlines, journaling
        and preemption drain; returns worker results in task order.

        Correctness rests on task purity: ``fn(tasks[i])`` always returns
        the same value, so journal replays, bounded re-dispatch after a
        pool break, and first-completion-wins duplicate racing all merge
        to the same result as a fault-free run.

        ``prepare``/``observe`` are the incumbent-propagation hooks for
        branch-and-bound: ``observe(result)`` runs on every completed or
        journal-resumed result, and ``prepare(task)`` rewrites a task at
        the moment it is (re-)submitted -- so later-dispatched tasks
        (and retried/duplicated ones) inherit the best-so-far incumbent.
        Both hooks may only *tighten* pruning, never change the merged
        argmin: task results stay pure up to their ``pruned`` count,
        which is scheduling-dependent by design (like ``events``) and
        excluded from the bit-identity contract.  Journal keys are
        computed from ``keys``, not the prepared task, so a resumed run
        matches records regardless of incumbent timing.
        """
        n = len(tasks)
        results: dict[int, object] = {}
        task_keys = None
        if journal is not None:
            task_keys = [journal.task_key(k) for k in keys]
            for i in range(n):
                rec = journal.get(task_keys[i])     # may raise JournalError
                if rec is not None:
                    results[i] = decode(rec)
                    if observe is not None:
                        observe(results[i])
                    events.append(FaultEvent(
                        "resume", task=keys[i],
                        detail="journaled task result reused"))
        if len(results) == n:
            return [results[i] for i in range(n)]

        live = {i: tasks[i] for i in range(n)}   # may be degraded on retry
        attempts = [0] * n
        dup_issued = [False] * n
        pending = deque(i for i in range(n) if i not in results)
        inflight: dict = {}                  # future -> (i, t0, attempt)
        monitor = StragglerMonitor(window=64,
                                   threshold=self.straggler_threshold,
                                   min_samples=5)
        # cap in-flight submissions: a pool break then only blames the
        # tasks actually handed to the broken pool, and preemption drains
        # quickly
        window = max(1, 2 * self.workers)

        def submit(i: int) -> None:
            if prepare is not None:          # inject the live incumbent at
                live[i] = prepare(live[i])   # submit time (also on retries)
            try:
                fut = self._executor().submit(fn, live[i], attempts[i])
            except BrokenProcessPool:        # broke between loop ticks
                self._reset()
                fut = self._executor().submit(fn, live[i], attempts[i])
            inflight[fut] = (i, time.monotonic(), attempts[i])

        def fill() -> None:
            while pending and len(inflight) < window:
                i = pending.popleft()
                if i not in results:
                    submit(i)

        def record(i: int, res, wall: float | None) -> None:
            results[i] = res
            if observe is not None:
                observe(res)
            if wall is not None:
                monitor.observe(wall)
            if journal is not None:
                journal.put(task_keys[i], encode(res))

        def retry(i: int, exc, reason: str) -> None:
            if attempts[i] >= self.max_retries:
                raise RuntimeError(
                    f"search-pool task {keys[i]!r} failed after "
                    f"{attempts[i] + 1} attempts ({reason}; workers="
                    f"{self.workers}, max_retries={self.max_retries})"
                ) from exc
            attempts[i] += 1
            pending.append(i)
            events.append(FaultEvent("retry", task=keys[i],
                                     attempt=attempts[i], detail=reason))

        fill()
        while len(results) < n:
            if self.guard is not None and self.guard.preempted:
                self._drain(inflight, results, task_keys, journal, encode,
                            events)
                raise SearchPreempted(
                    f"search preempted: {len(results)}/{n} tasks complete"
                    + (" and journaled" if journal is not None else "")
                    + f"; resume to finish the remaining "
                      f"{n - len(results)}")
            done, _ = wait(list(inflight), timeout=_TICK_S,
                           return_when=FIRST_COMPLETED)
            broken = False
            for fut in done:
                i, t0, _att = inflight.pop(fut)
                exc = fut.exception()
                if exc is None:
                    if i not in results:     # duplicates: first one wins
                        record(i, fut.result(), time.monotonic() - t0)
                    continue
                if isinstance(exc, BrokenProcessPool):
                    broken = True
                    if i not in results:
                        retry(i, exc, "worker process died")
                    continue
                if i in results:
                    continue                 # losing duplicate failed
                if getattr(exc, "transient", False):
                    retry(i, exc, f"transient worker failure: {exc}")
                else:
                    raise exc       # deterministic error: as serial would
            if broken:
                # the pool takes every other in-flight future down with it
                for fut in list(inflight):
                    i, t0, _att = inflight.pop(fut)
                    if i not in results:
                        retry(i, None, "worker process died")
                self._reset()
            self._check_deadlines(inflight, results, attempts, dup_issued,
                                  live, keys, degrade, monitor, events,
                                  submit)
            fill()
        return [results[i] for i in range(n)]

    def _check_deadlines(self, inflight, results, attempts, dup_issued,
                         live, keys, degrade, monitor, events,
                         submit) -> None:
        """Speculative straggler re-dispatch: one duplicate per task once
        it outlives min(task_deadline_s, EWMA straggler bound)."""
        if self.task_deadline_s is None:
            return
        deadline = self.task_deadline_s
        ewma_bound = monitor.straggler_after()
        if ewma_bound is not None:
            deadline = min(deadline, ewma_bound)
        now = time.monotonic()
        for fut, (i, t0, _att) in list(inflight.items()):
            if (i in results or dup_issued[i] or now - t0 <= deadline
                    or attempts[i] >= self.max_retries):
                continue
            attempts[i] += 1
            dup_issued[i] = True
            if degrade is not None:
                live[i] = degrade(live[i])
            submit(i)
            events.append(FaultEvent(
                "straggler", task=keys[i], attempt=attempts[i],
                detail=f"duplicate dispatched after {now - t0:.2f}s > "
                       f"{deadline:.2f}s deadline"))

    def _drain(self, inflight, results, task_keys, journal, encode,
               events) -> None:
        """Clean preemption drain: start nothing new, cancel what hasn't
        started, await what has, journal every completed result."""
        for fut in list(inflight):
            fut.cancel()                       # queued-only futures
        if inflight:
            done, _ = wait(list(inflight))
            for fut in done:
                i, t0, _att = inflight.pop(fut)
                if (i in results or fut.cancelled()
                        or fut.exception() is not None):
                    continue
                results[i] = fut.result()
                if journal is not None:
                    journal.put(task_keys[i], encode(fut.result()))
        events.append(FaultEvent(
            "preempted",
            detail=f"preemption drain: {len(results)} task results kept"))

    # --------------------------------------------------------------- search
    def _token(self, opts) -> tuple:
        self._searches += 1
        return (os.getpid(), id(self), self._searches, opts.engine,
                opts.device)

    def search(self, gg, hw, options=None, *,
               min_parallel_space: int = MIN_PARALLEL_SPACE,
               warm_start=None, **legacy):
        """Parallel ``cutpoint.search``, bit-identical to the serial result.

        Knobs arrive as one :class:`repro_torch.core.options.
        CompileOptions`.  The driver-level scheduling fields --
        ``workers``, ``max_retries``, ``task_deadline_s`` -- are fixed at
        driver construction and *ignored* on the options value here: a
        driver is a process pool, not a per-call policy.  Additionally
        ``min_parallel_space`` sets the space size below which the serial
        path runs directly (the result is identical either way), and
        ``options.resume_dir`` opens the task journal for checkpointed
        resume (which also forces the partitioned path, so every task is
        journaled even on small spaces).  ``warm_start`` threads a cached
        cut tuple through to the underlying search -- see
        :func:`repro_torch.core.cutpoint.search` for its exactness
        contract.

        With ``prune`` on, completed task results feed a shared incumbent
        (the best objective key seen so far); tasks dispatched later
        inherit it, so the parallel search prunes *across* sub-spaces.
        The merged argmin, metrics, and (under ``count_pruned``)
        ``evaluated`` are still bit-identical to the serial search -- only
        ``SearchResult.pruned`` varies with scheduling.
        """
        opts = _cp.resolve_options(options, legacy, site="driver.search")
        blocks = _cp.split_blocks(gg)
        runs = _cp.monotone_runs(blocks)
        space = 1
        for r in runs:
            space *= len(r) + 1
        exhaustive = space <= opts.exhaustive_limit
        serial_ok = (self.workers <= 1 or not runs
                     or (exhaustive and space < min_parallel_space))
        if not runs or (serial_ok and opts.resume_dir is None):
            # workers=1 + resume_dir=None keeps cutpoint.search on its
            # serial path (it would otherwise bounce back to a driver)
            return _cp.search(
                gg, hw, opts.replace(workers=1, resume_dir=None),
                warm_start=warm_start)

        if exhaustive:
            prefixes, suffix_dims = partition_space(
                runs, self.workers * TASKS_PER_WORKER)
            return self.run_subspaces(
                gg, hw, prefixes, suffix_dims, opts,
                blocks=blocks, runs=runs, warm_start=warm_start)

        starts = _cp.descent_starts(blocks, runs)
        ws = _cp.valid_warm_start(warm_start, runs)
        if ws is not None and ws not in starts:
            starts.append(ws)       # extra deterministic start, appended
            #                         so ties still favor the cold starts
        tasks = self.descent_tasks(gg, hw, starts, opts)
        events: list[FaultEvent] = []
        journal = None
        if opts.resume_dir is not None:
            journal = self._open_journal(opts.resume_dir, tasks[0].payload,
                                         opts, "descent", tuple(starts))
        self._cuda_safe_context(opts)
        results = self._run_tasks(
            _run_descent, tasks, keys=starts, events=events,
            journal=journal, encode=_encode_descent,
            decode=_decode_descent, degrade=_degrade)
        visited: set = set()
        best = None
        for start, (m, seen, wev) in zip(starts, results):
            for kind, detail in wev:
                events.append(FaultEvent(kind, task=start, detail=detail))
            visited |= seen                 # start order; strict < as
            if best is None or (_cp._key(m, opts.objective)
                                < _cp._key(best, opts.objective)):
                best = m                    # the serial loop over starts
        cand = _cp.evaluate(gg, blocks, runs, best.cuts, hw)
        return _cp.SearchResult(best=cand, evaluated=len(visited),
                                runs=runs, blocks=blocks, events=events,
                                path="descent")

    def subspace_tasks(self, gg, hw, prefixes, suffix_dims,
                       opts) -> list[SubspaceTask]:
        """The tasks ``run_subspaces`` dispatches for ``prefixes`` (one
        fresh search token), e.g. for :meth:`map` of a function that
        wraps :func:`_run_subspace`."""
        token = self._token(opts)
        payload = pickle.dumps((gg, hw), protocol=pickle.HIGHEST_PROTOCOL)
        batch_size = opts.engine_spec().batch_size
        return [SubspaceTask(token, payload, tuple(p), tuple(suffix_dims),
                             opts.objective, batch_size, opts.engine,
                             opts.backend, opts.device, opts.prune, None)
                for p in prefixes]

    def descent_tasks(self, gg, hw, starts, opts) -> list[DescentTask]:
        """The tasks ``search`` dispatches for the descent ``starts`` (one
        fresh search token), as :meth:`subspace_tasks` for sub-spaces."""
        token = self._token(opts)
        payload = pickle.dumps((gg, hw), protocol=pickle.HIGHEST_PROTOCOL)
        batch_size = opts.engine_spec().batch_size
        return [DescentTask(token, payload, tuple(s), opts.objective,
                            batch_size, opts.engine, opts.backend,
                            opts.device)
                for s in starts]

    def run_subspaces(self, gg, hw, prefixes, suffix_dims, options=None,
                      *, blocks=None, runs=None, warm_start=None,
                      **legacy):
        """Fault-tolerant exhaustive search over an explicit partition.

        ``search`` delegates the full-space exhaustive path here; callers
        may pass a *slice* of the partition to run end-to-end through the
        retry/journal/deadline machinery on a bounded budget.  Returns a
        ``SearchResult`` over exactly the given sub-spaces.

        A valid ``warm_start`` (with ``prune`` on) is priced through the
        direct oracle and seeds the shared incumbent before the first
        task is dispatched.  Exactness is unchanged: the incumbent is a
        real candidate's key inside this space, so the strict ``>`` bound
        test can never eliminate the argmin, and under ``count_pruned``
        the ``evaluated`` accounting is identical to a cold run.
        """
        opts = _cp.resolve_options(options, legacy,
                                   site="driver.run_subspaces")
        self._cuda_safe_context(opts)
        objective = opts.objective
        if blocks is None:
            blocks = _cp.split_blocks(gg)
        if runs is None:
            runs = _cp.monotone_runs(blocks)
        tasks = self.subspace_tasks(gg, hw, prefixes, suffix_dims, opts)
        events: list[FaultEvent] = []
        journal = None
        if opts.resume_dir is not None:
            journal = self._open_journal(
                opts.resume_dir, tasks[0].payload if tasks else b"", opts,
                "exhaustive", (tuple(suffix_dims), tuple(prefixes)))
        # Incumbent propagation: every completed (or journal-resumed) task
        # result tightens a shared best-so-far key; tasks submitted after
        # that inherit it via ``prepare`` and can prune against it from
        # their first batch.  Monotone tightening only -- the argmin's own
        # task can never be pruned by any incumbent, so the merge below is
        # unchanged regardless of completion order.
        inc_box: list = [None]
        ws = _cp.valid_warm_start(warm_start, runs)
        if ws is not None and opts.prune:
            inc_box[0] = _cp._key(
                _cp.evaluate(gg, blocks, runs, ws, hw), objective)

        def _observe(res) -> None:
            m = res[0]
            if m is not None:
                k = _cp._key(m, objective)
                if inc_box[0] is None or k < inc_box[0]:
                    inc_box[0] = k

        def _prepare(task):
            if inc_box[0] is None:
                return task
            return task._replace(incumbent=inc_box[0])

        results = self._run_tasks(
            _run_subspace, tasks, keys=list(prefixes), events=events,
            journal=journal, encode=_encode_subspace,
            decode=_decode_subspace, degrade=_degrade,
            prepare=_prepare if opts.prune else None,
            observe=_observe if opts.prune else None)
        evaluated = 0
        pruned_total = 0
        for prefix, (_m, nev, npr, wev) in zip(prefixes, results):
            evaluated += nev
            pruned_total += npr
            for kind, detail in wev:
                events.append(FaultEvent(kind, task=prefix, detail=detail))
        if opts.count_pruned:
            # scored + pruned per task == the task's tuple count, so the
            # sum is the full enumeration count the unpruned search
            # reports -- deterministic even though the split is not
            evaluated += pruned_total
        # (objective key, cut tuple) == first optimum in product order.
        # Fully-pruned tasks contribute no candidate; at least one task
        # always survives: the global optimum's own subtree bound never
        # strictly exceeds any incumbent (including a warm-start seed,
        # which is itself a candidate inside this space), so its task is
        # never pruned whole.
        survivors = [m for m, _n, _p, _e in results if m is not None]
        assert survivors, "every sub-space pruned: bound/incumbent bug"
        best = min(survivors,
                   key=lambda m: (_cp._key(m, objective), m.cuts))
        cand = _cp.evaluate(gg, blocks, runs, best.cuts, hw)
        return _cp.SearchResult(best=cand, evaluated=evaluated,
                                runs=runs, blocks=blocks, events=events,
                                pruned=pruned_total, path="exhaustive")
