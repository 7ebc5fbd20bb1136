"""Unified compile-options API: one frozen dataclass for every knob.

Historically ``compile_graph`` and ``cutpoint.search`` each carried their
own copy of ~13 loose keyword knobs, and the signatures drifted.
:class:`CompileOptions` is the single source of truth: every entry point
accepts ``options=CompileOptions(...)``, the legacy keyword spellings keep
working through a deprecation shim (:func:`resolve_options`, emitting
:class:`LegacyKnobWarning`), and the knob documentation lives in exactly
one place -- the field table below.

The class also draws the line a compile *service* keys its persistent
plan cache on: **plan-affecting** fields change what
plan a compile can produce and therefore feed the cache hash
(:meth:`CompileOptions.plan_key`), while **scheduling-only** fields
change wall clock, resilience, or post-checks but never the plan bytes
(:meth:`CompileOptions.schedule`) -- the bit-identity contract proven by
tests/test_torch_compile.py, test_torch_alloc_scan.py and
test_torch_search_pipeline.py is what makes that split sound.  The same
``plan_key()`` keys the ``resume_dir`` task journals, so journals
written under different plan-affecting option sets can never collide.

Every value is implemented: ``workers != 1`` and ``resume_dir`` run the
process pool of ``core/search_pool.py``, whose workers start under
``spawn`` when they will touch a CUDA device (a forked child of a CUDA
parent cannot use CUDA) and under ``fork`` otherwise.

Field reference (the one knob table; README mirrors it)
-------------------------------------------------------

Plan-affecting (feed ``plan_key()`` and the service cache hash):

``objective``
    What the optimizer minimizes; feasibility always dominates.
    ``"latency"`` -> (infeasible, latency_cycles, sram_total),
    ``"sram"`` -> (infeasible, sram_total, latency_cycles),
    ``"dram"`` -> (infeasible, dram_total, latency_cycles).
``exhaustive_limit``
    Cut-product spaces up to this size are enumerated exhaustively
    (guaranteed optimum); beyond it coordinate descent with
    deterministic restarts runs instead.  Changing the limit can move a
    graph across that boundary and change the argmin, so it is
    plan-affecting.
``backend``
    ``CutpointEngine.score_batch`` backend: ``"numpy"`` (default,
    oracle-exact) or ``"pallas"``.  In this package ``"pallas"`` names
    the staged float32 scorer, ``kernels/score_batch.py``: kernel K5 on
    a CUDA ``device``, its plain torch version on the CPU.  It is NOT
    oracle-exact, hence plan-affecting; the spelling is the JAX
    package's, so the two packages' ``plan_key()`` values agree.  It
    changes only ``score_batch`` (the coordinate-descent path, and the
    exhaustive path of the ``journal`` / ``device`` engines); exhaustive
    sub-spaces under ``engine="pipeline"`` still run the exact fused
    pipeline.  With a CUDA ``device`` it raises on a host without one.
``prune``
    ``True`` (default) runs exhaustive enumeration as exact
    branch-and-bound; the argmin and metrics are bit-identical to the
    unpruned search, but ``SearchResult.pruned`` and (under
    ``count_pruned=False``) the scored count depend on it, so compiles
    under different ``prune`` settings must not share journals or cache
    records.
``count_pruned``
    ``True`` (default) counts pruned candidates into
    ``SearchResult.evaluated`` (== the full enumeration count,
    deterministic); ``False`` reports only actually-scored candidates,
    which legitimately varies with scheduling.

Scheduling-only (wall clock / resilience / post-checks; excluded from
``plan_key()`` because results are bit-identical across them):

``workers``
    ``1`` (default) searches serially in-process; ``N > 1`` farms
    disjoint sub-spaces (or descent starts) over a process pool
    (``core/search_pool.py``) whose workers launch the engine's kernels
    themselves; ``None`` uses ``os.cpu_count()`` -- on a CUDA ``device``
    that many CUDA contexts on the card.
``batch_size``
    Cut tuples priced per ``CutpointEngine.score_batch`` call
    (``1`` falls back to the per-tuple loop).  An ``@N`` suffix on
    ``engine`` overrides it.
``engine``
    How candidate metrics are *executed* (never *what* they are --
    every engine value is bit-identical, which is exactly why the knob
    is scheduling-only).  Grammar: ``name[:variant][@batch]``:

    * ``"journal"`` -- checkpointed Python allocator replay per
      candidate (``CutpointEngine._replay``).  Host code: it needs no
      GPU whatever ``device`` says.
    * ``"device"`` -- tensorized allocator scan over the whole batch
      (``kernels/alloc_scan.py``); ``"device:cuda"`` launches the
      hand-written CUDA kernel, ``"device:torch"`` runs the plain torch
      version of the same function.
    * ``"pipeline"`` (default) -- the fully fused on-device search
      pipeline (``kernels/search_pipeline.py``): in-kernel candidate
      enumeration + alloc-scan replay + f64 cost reductions + argmin;
      the host receives only each sub-space's winner.
      ``"pipeline:cuda"`` runs the four CUDA kernels,
      ``"pipeline:torch"`` their plain torch versions.  Only exhaustive
      sub-spaces go through the pipeline: a graph whose cut space
      exceeds ``exhaustive_limit`` is searched by coordinate descent,
      which scores through the journal replay and launches nothing.

    An empty variant resolves by ``device``: ``cuda`` on a CUDA device,
    ``torch`` on the CPU.  ``:torch`` with a CUDA device runs the plain
    versions on the GPU (the yardstick the kernels are checked against);
    ``:cuda`` with ``device="cpu"`` is refused, and a ``device`` or
    ``pipeline`` engine resolved for a CUDA device raises on a host
    without one -- it never carries on on the CPU.

    ``@N`` appended to any spelling overrides ``batch_size`` for that
    engine (``"pipeline@1048576"``; the default batch is sized for the
    host scorer and is small for a GPU).
``device``
    The torch device the ``device`` / ``pipeline`` engines run on:
    ``"cuda"`` (default), ``"cuda:N"`` or ``"cpu"``.  Plans are
    bit-identical across devices, so it never enters ``plan_key()``.
``max_retries``
    Re-dispatch budget per parallel task for *transient* failures (a
    dead worker process, an injected ChaosError, a straggler
    duplicate).  Deterministic errors always propagate.
``task_deadline_s``
    Per-task wall-clock deadline enabling speculative straggler
    re-dispatch (``None`` disables).
``resume_dir``
    Directory for the task-granular completion journal
    (``checkpoint/checkpoint.py::TaskJournal``, standard-library records):
    completed tasks are committed atomically and skipped on re-run, so a
    killed or preempted compile resumes byte-identically; it also routes
    the search through the pool's partitioned path even at ``workers=1``.
    The journal's search key derives from ``plan_key()`` + the
    partition, never from scheduling knobs, so a journal written under
    one engine or device resumes a search under another.
``verify``
    Static plan verifier post-pass (``repro_torch.analysis``): ``"off"``
    (default), ``"warn"`` (diagnostics recorded on
    ``plan.diagnostics`` + UserWarning per error), ``"strict"``
    (raises ``VerificationError``).  A pure check -- the plan bytes
    are unchanged -- so the service re-runs it on cache hits instead
    of keying the cache on it.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

# Cut-product spaces up to this size are enumerated exhaustively; the
# yolov2 detector's full 7.96M-tuple space fits (paper-scale exactness).
EXHAUSTIVE_LIMIT = 8_000_000

# Cut tuples scored per ``CutpointEngine.score_batch`` call in the search
# loops.  Large enough to amortize the numpy dispatch overhead of the 2-D
# reductions across the batch, small enough that the B x G mask/IO
# matrices stay cache-resident.
DEFAULT_BATCH_SIZE = 1024

_OBJECTIVES = ("latency", "sram", "dram")
_BACKENDS = ("numpy", "pallas")
_VERIFY_MODES = ("off", "warn", "strict")

# engine= grammar: name[:variant][@batch].  Variant "" means the engine's
# default implementation; every (name, variant) pair below is bit-identical
# to every other, which is what keeps ``engine`` scheduling-only.
_ENGINE_VARIANTS = {
    "journal": ("",),
    "device": ("", "torch", "cuda"),
    "pipeline": ("", "torch", "cuda"),
}

# The plan-affecting / scheduling-only split (see module docstring).
PLAN_FIELDS = ("objective", "exhaustive_limit", "backend", "prune",
               "count_pruned")
SCHEDULE_FIELDS = ("workers", "batch_size", "engine", "max_retries",
                   "task_deadline_s", "resume_dir", "verify", "device")


class LegacyKnobWarning(DeprecationWarning):
    """A compile entry point was called with loose legacy keyword knobs
    (``workers=``, ``batch_size=``, ``replay=``, ...) instead of
    ``options=CompileOptions(...)``.  The shim maps them onto the
    dataclass so behaviour is unchanged."""


@dataclass(frozen=True)
class EngineSpec:
    """A parsed ``engine=`` value (see the module docstring's grammar).

    ``variant`` is the resolved implementation name, never ``""`` for
    the ``device`` / ``pipeline`` engines: ``resolve_engine`` substitutes
    the default for its ``device``.  ``batch_size`` is the effective
    batch (an ``@N`` suffix wins over the caller's default)."""
    name: str                  # "journal" / "device" / "pipeline"
    variant: str               # resolved implementation: "torch" / "cuda"
    batch_size: int | None     # from "@N", else the caller's default

    def spelling(self) -> str:
        """The canonical string this spec round-trips to."""
        s = f"{self.name}:{self.variant}" if self.name != "journal" \
            else self.name
        if self.batch_size is not None:
            s += f"@{self.batch_size}"
        return s


def is_cuda_device(device: str) -> bool:
    """True for ``"cuda"`` / ``"cuda:N"`` spellings of ``device``."""
    return device == "cuda" or device.startswith("cuda:")


def _default_variant(name: str, device: str) -> str:
    if name == "journal":
        return ""
    # the kernels on a GPU, their plain torch versions on the CPU; both
    # are bit-identical, so the choice cannot change results
    return "cuda" if is_cuda_device(device) else "torch"


def resolve_engine(engine: str,
                   default_batch: int | None = None,
                   device: str = "cuda") -> EngineSpec:
    """Parse and validate an ``engine=`` string into an :class:`EngineSpec`.

    Raises ``ValueError`` on an unknown name, an unknown variant for the
    name, a malformed ``@batch`` suffix, or a ``:cuda`` variant asked of
    a CPU ``device``.  ``default_batch`` fills ``batch_size`` when no
    ``@N`` suffix is present; ``device`` picks the variant an empty one
    stands for.
    """
    if not isinstance(engine, str):
        raise ValueError(f"engine={engine!r}: expected a string "
                         f"'name[:variant][@batch]'")
    spec, batch = engine, default_batch
    if "@" in spec:
        spec, _, bs = spec.partition("@")
        if not bs.isdigit() or int(bs) < 1:
            raise ValueError(f"engine={engine!r}: '@{bs}' batch suffix "
                             f"must be a positive integer")
        batch = int(bs)
    name, _, variant = spec.partition(":")
    variants = _ENGINE_VARIANTS.get(name)
    if variants is None:
        raise ValueError(f"engine={engine!r}: expected one of "
                         f"{tuple(sorted(_ENGINE_VARIANTS))} "
                         f"(grammar: name[:variant][@batch])")
    if variant not in variants:
        raise ValueError(f"engine={engine!r}: unknown variant "
                         f"{variant!r} for {name!r}; expected one of "
                         f"{tuple(v for v in variants if v)}")
    if not variant:
        variant = _default_variant(name, device)
    if variant == "cuda" and not is_cuda_device(device):
        raise ValueError(f"engine={engine!r} with device={device!r}: the "
                         f"CUDA kernels need a CUDA device (use "
                         f"'{name}:torch' or device='cuda')")
    return EngineSpec(name=name, variant=variant, batch_size=batch)


def degrade_engine(engine: str) -> str:
    """The safe fallback spelling for ``engine``: the journal replay,
    preserving any explicit ``@batch`` suffix.

    The single degrade target of the parallel runtime on the host: a
    failing device or pipeline task, and every speculative straggler
    duplicate, re-runs under the returned engine.  A task on a CUDA
    ``device`` never degrades (``search_pool`` keeps it on the card).
    Bit-identical by the replay contract, so degradation only costs wall
    clock; the pool reports each one as a ``FaultEvent``."""
    spec = resolve_engine(engine)
    if spec.batch_size is not None:
        return f"journal@{spec.batch_size}"
    return "journal"


@runtime_checkable
class ReplayEngine(Protocol):
    """What the search runtime requires of a candidate-scoring engine.

    ``CutpointEngine`` is the one production implementation; the serial
    ``search`` loop resolves its ``CompileOptions.engine`` string into a
    concrete implementation through this surface (see
    ``CutpointEngine.run_subspace`` for the dispatch).  Every
    implementation must be bit-identical on ``run_subspace``'s winner --
    the contract that keeps ``engine`` scheduling-only."""

    evaluations: int

    def score_batch(self, cuts_batch, memoize: bool = True,
                    skip=None) -> list: ...

    def run_subspace(self, prefix, suffix_dims, objective: str,
                     batch_size: int, incumbent_key=None,
                     prune: bool = True) -> tuple: ...


@dataclass(frozen=True)
class CompileOptions:
    """Every compile/search knob, in one frozen value object.

    See the module docstring for the per-field reference (the single
    source of truth the README table mirrors).  Instances are immutable
    and hashable; derive variants with :meth:`replace`.
    """

    objective: str = "latency"
    exhaustive_limit: int = EXHAUSTIVE_LIMIT
    workers: int | None = 1
    batch_size: int = DEFAULT_BATCH_SIZE
    engine: str = "pipeline"
    backend: str = "numpy"
    max_retries: int = 2
    task_deadline_s: float | None = None
    resume_dir: str | os.PathLike | None = None
    prune: bool = True
    count_pruned: bool = True
    verify: str = "off"
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.objective not in _OBJECTIVES:
            raise ValueError(f"objective={self.objective!r}: expected one "
                             f"of {_OBJECTIVES}")
        if not (isinstance(self.device, str)
                and (self.device == "cpu" or is_cuda_device(self.device))):
            raise ValueError(f"device={self.device!r}: expected 'cuda', "
                             f"'cuda:N' or 'cpu'")
        # validates the grammar and the variant/device pairing; raises
        resolve_engine(self.engine, device=self.device)
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend={self.backend!r}: expected one of "
                             f"{_BACKENDS}")
        if self.verify not in _VERIFY_MODES:
            raise ValueError(f"verify={self.verify!r}: expected one of "
                             f"{_VERIFY_MODES}")
        if self.exhaustive_limit < 0:
            raise ValueError(f"exhaustive_limit={self.exhaustive_limit}: "
                             f"must be >= 0")
        if self.batch_size < 1:
            raise ValueError(f"batch_size={self.batch_size}: must be >= 1")
        if self.workers is not None and self.workers < 1:
            raise ValueError(f"workers={self.workers}: must be >= 1 or "
                             f"None (= all cores)")
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries}: must be "
                             f">= 0")
        if self.task_deadline_s is not None and self.task_deadline_s <= 0:
            raise ValueError(f"task_deadline_s={self.task_deadline_s}: "
                             f"must be > 0 or None")

    # ---------------------------------------------------------- derivation
    def replace(self, **changes) -> "CompileOptions":
        """A copy with ``changes`` applied (re-validated)."""
        return dataclasses.replace(self, **changes)

    def engine_spec(self) -> EngineSpec:
        """The parsed :class:`EngineSpec` of this option set; its
        ``batch_size`` is the effective one (an ``@N`` engine suffix
        overrides the ``batch_size`` field)."""
        return resolve_engine(self.engine, self.batch_size, self.device)

    def plan_key(self) -> tuple:
        """Canonical tuple of the plan-affecting fields.

        This is what the service's persistent plan cache and the
        ``resume_dir`` task journals hash: two option sets with equal
        ``plan_key()`` are guaranteed (by the repo's bit-identity
        contract) to compile any request to byte-identical plans, and
        two with different ``plan_key()`` must never share cache records
        or journals.
        """
        return tuple((name, getattr(self, name)) for name in PLAN_FIELDS)

    def schedule(self) -> tuple:
        """Canonical tuple of the scheduling-only fields (wall clock /
        resilience / post-checks; never part of any cache or journal
        key).  ``resume_dir`` is normalized to a string so the tuple
        stays comparable and msgpack-able."""
        out = []
        for name in SCHEDULE_FIELDS:
            v = getattr(self, name)
            if name == "resume_dir" and v is not None:
                v = os.fspath(v)
            out.append((name, v))
        return tuple(out)


_FIELD_NAMES = tuple(f.name for f in dataclasses.fields(CompileOptions))

# Retired keyword spellings the legacy shim still understands.  ``replay``
# predates the unified ``engine`` knob; its two values map 1:1 onto engine
# spellings ("journal" -> "journal", "device" -> "device").
_RETIRED_KNOBS = ("replay",)


def resolve_options(options: CompileOptions | None,
                    legacy: dict | None,
                    site: str = "compile",
                    stacklevel: int = 3) -> CompileOptions:
    """Resolve an entry point's ``(options=, **legacy)`` pair.

    * both empty -> default :class:`CompileOptions`;
    * ``options`` given -> returned as-is (legacy knobs must be absent);
    * legacy knobs given -> mapped onto a fresh ``CompileOptions`` with a
      :class:`LegacyKnobWarning`.
      The retired ``replay=`` spelling is translated onto ``engine=``
      (``"journal"``/``"device"``, unchanged meaning).

    Unknown legacy names raise ``TypeError`` exactly as a wrong keyword
    argument would have before the redesign.
    """
    legacy = dict(legacy) if legacy else {}
    unknown = sorted(set(legacy) - set(_FIELD_NAMES) - set(_RETIRED_KNOBS))
    if unknown:
        raise TypeError(f"{site}() got unexpected keyword argument(s) "
                        f"{', '.join(map(repr, unknown))}")
    if "replay" in legacy:
        if "engine" in legacy:
            raise TypeError(f"{site}(): pass engine=..., not both the "
                            f"retired replay= spelling and engine=")
        legacy["engine"] = legacy.pop("replay")
    if options is not None:
        if not isinstance(options, CompileOptions):
            raise TypeError(f"{site}(): options must be a CompileOptions, "
                            f"got {type(options).__name__}")
        if legacy:
            raise TypeError(
                f"{site}(): pass either options=CompileOptions(...) or "
                f"legacy keyword knobs, not both "
                f"(got {sorted(legacy)})")
        return options
    if legacy:
        warnings.warn(
            f"{site}({', '.join(sorted(legacy))}=...): loose keyword "
            f"knobs are deprecated; pass "
            f"options=CompileOptions({', '.join(sorted(legacy))}=...) "
            f"instead (see repro_torch.core.options)",
            LegacyKnobWarning, stacklevel=stacklevel)
        return CompileOptions(**legacy)
    return CompileOptions()
