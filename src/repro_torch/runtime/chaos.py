"""Deterministic fault injection for the search runtime.

The search pool's resilience features (task retry, pool healing, journal
resume, deadlines, device-engine fallback -- see core/search_pool.py) are
only trustworthy if every failure path can be exercised *reproducibly*:
a chaos test that kills a worker "sometimes" proves nothing.  This module
is the one injector behind all of them.

Design
------
* **Events are keyed by task identity, not call order.**  Worker/task
  scheduling is nondeterministic, so an injector that fires "on the 3rd
  call" would fire on a different task every run.  Instead every
  injection site passes a stable key (the sub-space prefix tuple, the
  descent start, ...) and the event for ``(site, key)`` is a pure
  function of the seed: ``sha256(seed | site | key)`` drawn against the
  configured probabilities.  The same seed therefore produces the same
  faults on the same search regardless of worker count or scheduling --
  and in this package and the JAX package alike: :func:`_unit` is the
  same formula, so a seed plans the same faults in both.
* **Faults fire on bounded attempts.**  A killed task is re-dispatched
  by the driver with an incremented attempt number; by default an event
  fires only while ``attempt < max_attempt`` (default 1), so the retry
  succeeds and bit-identity of the final result can be asserted.  Tests
  of the exhausted-retries path set ``max_attempt`` high enough that
  every retry dies too.
* **Reaches fork and spawn workers.**  ``install()`` puts an injector in
  a module global.  ``fork``-started pool workers inherit it; a pool
  started under ``spawn`` (every search whose workers touch the GPU)
  inherits nothing, so the driver hands the injector installed when it
  creates the pool to each worker through the executor's initializer,
  which installs it there.  Explicit ``events={(site, key):
  ChaosEvent(...)}`` entries override the seeded draw, so tests can pin
  one surgical fault while fuzz runs stay fully seeded.

Actions
-------
``"raise"``  raises :class:`ChaosError` (marked ``transient=True`` --
the driver retries it with bounded attempts, unlike real worker
exceptions which propagate unchanged); ``"kill"`` hard-exits the worker
process (``os._exit``), which breaks the whole ``ProcessPoolExecutor``
and exercises pool healing; ``"delay"`` sleeps ``delay_s`` before the
task body, which exercises deadlines and straggler re-dispatch;
``"hold"`` blocks on a gate until the test releases it
(:meth:`ChaosInjector.hold`), which exercises the same straggler paths
*deterministically* -- a wall-clock ``delay`` races the deadline timer
under load, a held gate cannot.  A gate is a fork-context
``multiprocessing.Event``, which a spawn worker cannot rebuild: the driver
refuses ``hold`` events under any start method but fork.
"""
from __future__ import annotations

import hashlib
import multiprocessing as _mp
import os
import time
from dataclasses import dataclass, field

ACTIONS = ("raise", "kill", "delay", "hold")


class ChaosError(RuntimeError):
    """Injected worker failure.  ``transient = True`` marks it as
    retryable to the dispatch loop -- the one exception class the driver
    re-dispatches instead of propagating (real worker exceptions are
    deterministic and would fail identically on retry)."""

    transient = True


@dataclass(frozen=True)
class ChaosEvent:
    """One planned fault: what to do, and until which attempt."""

    action: str                 # "raise" | "kill" | "delay" | "hold"
    delay_s: float = 0.05      # sleep length for "delay"
    max_attempt: int = 1       # fire while attempt < max_attempt
    gate: object = None        # mp.Event for "hold"

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown chaos action {self.action!r}")
        if self.action == "hold" and self.gate is None:
            raise ValueError("hold events need a gate "
                             "(use ChaosInjector.hold)")


def _unit(seed: int, site: str, key) -> float:
    """Deterministic draw in [0, 1) from (seed, site, key)."""
    h = hashlib.sha256(f"{seed}|{site}|{key!r}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


@dataclass
class ChaosInjector:
    """Seeded, composable fault schedule.

    ``p_kill`` / ``p_raise`` / ``p_delay`` are per-(site, key) fault
    probabilities drawn deterministically from ``seed``; ``events`` pins
    explicit faults that take precedence over the seeded draw.  The
    injector only decides and acts -- it never tracks state, so it is
    safe to hand to worker processes and to consult concurrently.
    """

    seed: int = 0
    p_kill: float = 0.0
    p_raise: float = 0.0
    p_delay: float = 0.0
    delay_s: float = 0.05
    max_attempt: int = 1
    events: dict = field(default_factory=dict)   # (site, key) -> ChaosEvent
    fired: list = field(default_factory=list)    # log, per process

    def event_for(self, site: str, key) -> ChaosEvent | None:
        """The fault planned for this (site, key), or None.  Pure."""
        ev = self.events.get((site, key))
        if ev is not None:
            return ev
        u = _unit(self.seed, site, key)
        if u < self.p_kill:
            return ChaosEvent("kill", max_attempt=self.max_attempt)
        if u < self.p_kill + self.p_raise:
            return ChaosEvent("raise", max_attempt=self.max_attempt)
        if u < self.p_kill + self.p_raise + self.p_delay:
            return ChaosEvent("delay", delay_s=self.delay_s,
                              max_attempt=self.max_attempt)
        return None

    def hold(self, site: str, key, max_attempt: int = 1):
        """Pin a ``"hold"`` fault at (site, key) and return its release.

        The first ``max_attempt`` attempts of that task block on a
        fork-inherited :class:`multiprocessing.Event` until the returned
        zero-argument callable is invoked, giving tests a *deterministic*
        straggler: the held attempt provably overruns any deadline while
        the duplicate (attempt >= max_attempt) runs unimpeded.  Call the
        release before the pool shuts down, or ``close()`` will join the
        blocked worker forever.
        """
        gate = _mp.get_context("fork" if "fork" in
                               _mp.get_all_start_methods()
                               else None).Event()
        self.events[(site, key)] = ChaosEvent("hold", gate=gate,
                                              max_attempt=max_attempt)
        return gate.set

    def fire(self, site: str, key, attempt: int = 0) -> None:
        """Act on the planned fault for (site, key), if any is due."""
        ev = self.event_for(site, key)
        if ev is None or attempt >= ev.max_attempt:
            return
        self.fired.append((site, key, attempt, ev.action))
        if ev.action == "hold":
            ev.gate.wait()
        elif ev.action == "delay":
            time.sleep(ev.delay_s)
        elif ev.action == "raise":
            raise ChaosError(
                f"chaos: injected failure at {site}:{key!r} "
                f"(attempt {attempt})")
        elif ev.action == "kill":
            os._exit(3)


# ------------------------------------------------------- process-global hook
# The installed injector; fork-started pool workers inherit it from the
# parent, spawn-started ones get it from the pool's initializer.
_INJECTOR: ChaosInjector | None = None


def install(injector: ChaosInjector) -> ChaosInjector:
    global _INJECTOR
    _INJECTOR = injector
    return injector


def uninstall() -> None:
    global _INJECTOR
    _INJECTOR = None


def active() -> ChaosInjector | None:
    return _INJECTOR


def maybe_fire(site: str, key, attempt: int = 0) -> None:
    """Injection-site entry point: a no-op unless an injector is
    installed (the production fast path is one global read)."""
    if _INJECTOR is not None:
        _INJECTOR.fire(site, key, attempt)
