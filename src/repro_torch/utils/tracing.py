"""Spans and counters of the compile path, recorded while a torch profiler
records and at no other time.

``with span("search.engine"): ...`` marks a layer of the compiler.  While a
``torch.profiler`` records in the calling thread
(``torch.autograd._profiler_enabled()``, false in a thread the profiler's
state was not handed to), the span opens ``record_function(name)``, so the
range lies in the profiler's trace beside the device's work, and appends
one :class:`Record` to the store kept here: its name, its start and end on
the profiler's clock (ns since the epoch, as the trace's events have them),
the index of the span it opened inside, and the id of the ``compile`` span
it belongs to.  Each ``compile`` span takes a new id; a span opened in no
``compile`` span has none.  ``count(name, n)`` adds to a named counter on
the same condition.

With no profiler recording, ``span`` returns one shared object whose
``__enter__`` and ``__exit__`` do nothing, and ``count`` returns at once:
one check a call, torch's own.  No profiler can record before ``torch`` is
imported, so this module imports nothing of it.

:func:`records`, :func:`totals` and :func:`counters` read the store,
:func:`reset` clears it.  The kernels' launch counters
(``repro_torch.kernels.launch_counts``) stay the one count of launches.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import NamedTuple

COMPILE = "compile"          # the root span: one a compile_graph call


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int | None       # None while the span is open
    parent: int              # index of the enclosing span's record, or -1
    compile_id: int | None


_lock = threading.Lock()
_records: list[list] = []    # Record's fields, then the record's index
_counters: dict[str, int] = {}
_compiles = 0                # compile ids taken so far
_local = threading.local()   # .stack: this thread's open spans' records


def recording() -> bool:
    """True while a torch profiler records in this thread.  Until
    ``torch`` is imported none can; from then on this name is bound to
    torch's own check."""
    global recording
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    recording = torch.autograd._profiler_enabled
    return recording()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "record", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _compiles
        from torch.profiler import record_function

        stack = _local.__dict__.setdefault("stack", [])
        with _lock:
            # the enclosing span, unless a reset() has dropped it
            up = stack[-1] if stack else None
            parent = (up[5] if up is not None and up[5] < len(_records)
                      and _records[up[5]] is up else -1)
            if self.name == COMPILE:
                _compiles += 1
                cid = _compiles
            else:
                cid = _records[parent][4] if parent >= 0 else None
            # the record's own index rides along as a sixth field
            self.record = [self.name, time.time_ns(), None, parent, cid,
                           len(_records)]
            _records.append(self.record)
        stack.append(self.record)
        self.range = record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.record[2] = time.time_ns()
        _local.stack.pop()
        return False


def span(name: str):
    """A context manager that marks ``name`` while a profiler records."""
    return _Span(name) if recording() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if recording():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def records() -> list[Record]:
    """Every span recorded since the last :func:`reset`, in the order they
    opened."""
    with _lock:
        return [Record(*r[:5]) for r in _records]


def totals() -> dict[str, dict]:
    """Per span name: ``count`` (closed spans), ``seconds`` (their summed
    durations) and ``self_seconds`` (the same less what their child spans
    cover)."""
    recs = records()
    child = [0] * len(recs)
    for r in recs:
        if r.end_ns is not None and r.parent >= 0:
            child[r.parent] += r.end_ns - r.start_ns
    out: dict[str, dict] = {}
    for i, r in enumerate(recs):
        if r.end_ns is None:
            continue
        t = out.setdefault(r.name, {"count": 0, "seconds": 0.0,
                                    "self_seconds": 0.0})
        t["count"] += 1
        t["seconds"] += (r.end_ns - r.start_ns) / 1e9
        t["self_seconds"] += (r.end_ns - r.start_ns - child[i]) / 1e9
    return out


def counters() -> dict[str, int]:
    """Every counter since the last :func:`reset`."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Clear the spans and the counters (the compile ids go on)."""
    with _lock:
        _records.clear()
        _counters.clear()
