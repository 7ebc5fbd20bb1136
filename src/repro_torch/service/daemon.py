"""Compile-as-a-service daemon.

:class:`CompileService` is a long-lived, in-process daemon answering
``(graph, hw, CompileOptions)`` requests with :class:`ExecutionPlan`\\ s:

* **request flow** -- every request (hit or miss) goes through one
  bounded queue drained by worker threads; a full queue raises
  :class:`ServiceOverloaded` at submit time (backpressure, never
  unbounded buffering).  Hits decode from the cache in ~ms; misses run
  a full ``compile_graph`` -- whose search-level parallelism, retries,
  journal resume and preemption machinery arrive unchanged through the
  request's own ``CompileOptions`` -- then commit the encoded plan back
  to the cache atomically.
* **cache key** -- :func:`repro_torch.service.canonical.request_key`: sha256
  over (schema version, canonical graph, hw signature,
  ``CompileOptions.plan_key()``).  Scheduling-only fields never reach
  the key, so e.g. a ``workers=16`` request hits a record compiled at
  ``workers=1`` -- the repo's bit-identity contract is what makes that
  sound.  ``verify`` is also excluded: it is a pure post-check, so the
  service re-runs the verifier on every hit at the request's own mode
  instead of fragmenting the cache by it.
* **coalescing** -- concurrent submissions of an identical request
  (same cache key *and* same full options value) share one in-flight
  compile and one resulting plan object; plans are treated as
  read-only.
* **warm start** -- a miss first consults :meth:`PlanCache.nearest`
  for the same net family's plan on the closest hw config and seeds
  the search with it (``warm_start=`` through ``compile_graph``).  On
  the exhaustive path (``prune`` + ``count_pruned`` on) this provably
  cannot change the plan bytes, so every such record is byte-identical
  to a cold compile.  Descent-path requests (which never promised
  hit/cold byte-identity) also warm-start since schema v2, but only
  from donors whose recorded search path is ``"exhaustive"`` -- see
  :meth:`CompileService._warm_start`.
* **failure semantics** -- a failed compile fails *that ticket* (the
  exception re-raises from :meth:`Ticket.result`, for every coalesced
  waiter); the daemon and its queue keep serving.  Nothing is cached on
  failure.  Corrupt or stale-schema cache records are misses, not
  errors.  A compile that raises on the GPU is never retried on the
  host: the ticket fails.
* **device** -- the default options are ``CompileOptions()``: the cut
  search runs on the GPU (``engine="pipeline"``, ``device="cuda"``), and
  a host without one fails every miss; pass
  ``CompileOptions(device="cpu")`` for the plain torch versions.  A hit
  runs no kernel: it decodes the record and re-runs the verifier on the
  host.

The daemon is deliberately transport-free: it is the serving core
(queueing, caching, coalescing, warm starts) that an RPC front end
would wrap, and what a traffic benchmark drives directly.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.compiler import (ExecutionPlan, apply_verification,
                                       compile_graph)
from repro_torch.core.cutpoint import monotone_runs, split_blocks
from repro_torch.core.grouping import group_nodes
from repro_torch.core.hw import KCU1500, FPGAConfig
from repro_torch.core.ir import Graph
from repro_torch.core.options import CompileOptions
from repro_torch.service.cache import DEFAULT_CAPACITY, PlanCache
from repro_torch.service.canonical import (graph_fingerprint, hw_signature,
                                           request_key)
from repro_torch.service.codec import (PlanCodecError, decode_plan,
                                       encode_plan)


class ServiceOverloaded(RuntimeError):
    """The bounded request queue is full; the caller should back off and
    resubmit.  Raised at submit time -- overload is backpressure, not a
    silently growing buffer."""


class ServiceClosed(RuntimeError):
    """submit() after close()."""


@dataclass
class Ticket:
    """One submitted request; resolves to an ExecutionPlan.

    ``hit`` / ``warm_started`` / ``queue_wait_s`` / ``service_s`` are
    populated when the ticket completes -- they are what the traffic
    benchmark measures.  Coalesced submissions share one ticket.
    """
    key: str
    submitted_at: float
    hit: bool = False
    warm_started: bool = False
    queue_wait_s: float = 0.0
    service_s: float = 0.0
    _done: threading.Event = field(default_factory=threading.Event,
                                   repr=False)
    _plan: ExecutionPlan | None = field(default=None, repr=False)
    _exc: BaseException | None = field(default=None, repr=False)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> ExecutionPlan:
        if not self._done.wait(timeout):
            raise TimeoutError(f"compile ticket {self.key[:12]} not done "
                               f"within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._plan

    def _resolve(self, plan=None, exc=None) -> None:
        self._plan, self._exc = plan, exc
        self._done.set()


class CompileService:
    """See module docstring.

    Parameters
    ----------
    cache_dir:
        Root of the persistent plan cache (created if absent).  Distinct
        services pointed at the same directory share plans -- records
        are committed atomically and every read is digest-verified.
    options:
        Default :class:`CompileOptions` for requests that don't bring
        their own; ``CompileOptions()`` (the GPU) when ``None``.
    capacity:
        Plan-cache record bound (LRU eviction beyond it).
    max_pending:
        Bounded queue depth; submissions beyond it raise
        :class:`ServiceOverloaded`.
    threads:
        Worker threads draining the queue.  One (the default) serializes
        compiles -- usually right, since a miss already fans out over
        ``options.workers`` processes; more threads let hits overtake a
        long-running miss.
    """

    def __init__(self, cache_dir, options: CompileOptions | None = None,
                 capacity: int = DEFAULT_CAPACITY, max_pending: int = 64,
                 threads: int = 1):
        self.cache = PlanCache(cache_dir, capacity=capacity)
        self.options = options if options is not None else CompileOptions()
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending)
        self._inflight: dict = {}
        self._lock = threading.Lock()
        self._closed = False
        self.stats = {"requests": 0, "hits": 0, "misses": 0,
                      "coalesced": 0, "warm_starts": 0, "overloads": 0,
                      "failures": 0}
        self._threads = [
            threading.Thread(target=self._serve, daemon=True,
                             name=f"compile-serve-{i}")
            for i in range(max(1, threads))]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for _ in self._threads:
            self._queue.put(None)          # one sentinel per worker
        for t in self._threads:
            t.join()

    def __enter__(self) -> "CompileService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- serving
    def submit(self, graph: Graph, hw: FPGAConfig = KCU1500,
               options: CompileOptions | None = None) -> Ticket:
        """Enqueue one request; returns immediately with a Ticket."""
        opts = options if options is not None else self.options
        if not isinstance(opts, CompileOptions):
            raise TypeError(f"options must be a CompileOptions, got "
                            f"{type(opts).__name__}")
        key = request_key(graph, hw, opts)
        with self._lock:
            if self._closed:
                raise ServiceClosed("submit() on a closed CompileService")
            self.stats["requests"] += 1
            # coalesce on (cache key, full options): requests differing
            # only in scheduling knobs share the cache record but not an
            # in-flight ticket (their verify/resume behavior may differ)
            ck = (key, opts)
            ticket = self._inflight.get(ck)
            if ticket is not None:
                self.stats["coalesced"] += 1
                return ticket
            ticket = Ticket(key=key, submitted_at=time.perf_counter())
            try:
                self._queue.put_nowait((ticket, graph, hw, opts, ck))
            except queue.Full:
                self.stats["overloads"] += 1
                raise ServiceOverloaded(
                    f"compile queue full ({self._queue.maxsize} pending); "
                    f"retry with backoff") from None
            self._inflight[ck] = ticket
            return ticket

    def compile(self, graph: Graph, hw: FPGAConfig = KCU1500,
                options: CompileOptions | None = None,
                timeout: float | None = None) -> ExecutionPlan:
        """Synchronous convenience wrapper: submit and wait."""
        return self.submit(graph, hw, options).result(timeout)

    def _serve(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            ticket, graph, hw, opts, ck = item
            t0 = time.perf_counter()
            ticket.queue_wait_s = t0 - ticket.submitted_at
            try:
                plan = self._fulfil(ticket, graph, hw, opts)
            except BaseException as e:
                with self._lock:
                    self.stats["failures"] += 1
                    self._inflight.pop(ck, None)
                ticket.service_s = time.perf_counter() - t0
                ticket._resolve(exc=e)
            else:
                with self._lock:
                    self._inflight.pop(ck, None)
                ticket.service_s = time.perf_counter() - t0
                ticket._resolve(plan=plan)

    def _warm_start(self, graph: Graph, fp: str, hw_sig: list,
                    opts: CompileOptions):
        """Nearest cached cuts, guarded by the request's search path.

        *Exhaustive-path* requests (space within ``exhaustive_limit``,
        ``prune`` + ``count_pruned`` on) may seed from any family donor:
        a seeded incumbent only prunes earlier, ``evaluated`` stays the
        full enumeration count and the argmin is oracle-exact, so the
        stored plan bytes provably cannot change.  Under
        ``count_pruned=False`` a warm start would shift ``evaluated``,
        so those requests compile cold.

        *Descent-path* requests (space beyond the limit) never promised
        hit/cold byte-identity -- a warm start there is an extra
        deterministic start that can only improve the result -- but the
        donor must itself be trustworthy: only records whose stored
        search path is ``"exhaustive"`` (oracle-exact argmins, recorded
        per plan since schema v2) are used, so descent results never
        cascade into other descent searches."""
        if not (opts.prune and opts.count_pruned):
            return None
        space = 1
        for r in monotone_runs(split_blocks(group_nodes(graph))):
            space *= len(r) + 1
        if space > opts.exhaustive_limit:
            return self.cache.nearest(fp, hw_sig,
                                      require_path="exhaustive")
        return self.cache.nearest(fp, hw_sig)

    def _fulfil(self, ticket: Ticket, graph: Graph, hw: FPGAConfig,
                opts: CompileOptions) -> ExecutionPlan:
        blob = self.cache.get(ticket.key)
        if blob is not None:
            try:
                plan = decode_plan(blob, graph, hw)
            except PlanCodecError:
                # stale-schema or undecodable record: a miss, never a
                # ticket failure -- recompile and overwrite it below
                blob = None
            else:
                ticket.hit = True
                with self._lock:
                    self.stats["hits"] += 1
                # verify is scheduling-only: re-run it per request at
                # the requested mode rather than trusting (or keying on)
                # whatever mode the record was compiled under
                return apply_verification(plan, opts.verify,
                                          site="serve")
        with self._lock:
            self.stats["misses"] += 1
        fp = graph_fingerprint(graph)
        hw_sig = hw_signature(hw)
        warm = self._warm_start(graph, fp, hw_sig, opts)
        if warm is not None:
            ticket.warm_started = True
            with self._lock:
                self.stats["warm_starts"] += 1
        plan = compile_graph(graph, hw, opts, warm_start=warm)
        self.cache.put(ticket.key, encode_plan(plan),
                       meta={"graph_fp": fp, "hw_sig": hw_sig,
                             "hw_name": hw.name, "net": graph.name,
                             "cuts": list(plan.candidate.cuts),
                             "path": (plan.search.path
                                      if plan.search is not None
                                      else "policy"),
                             "plan_key": [list(kv) for kv
                                          in opts.plan_key()]})
        return plan
