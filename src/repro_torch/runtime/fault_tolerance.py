"""Fault tolerance of the search pool and the training loop: preemption
handling, straggler statistics and restart.

* :class:`PreemptionGuard` -- SIGTERM/SIGINT flips a flag; the search
  pool (core/search_pool.py) polls it and drains cleanly: completed tasks
  are journaled, the pool stops dispatching, and the compile resumes from
  the task journal.
* :class:`StragglerMonitor` -- wall-time statistics at two grains: the
  windowed median (loop steps slower than ``threshold x`` median are
  flagged) and an EWMA (``observe`` / ``straggler_after``), which the
  search pool uses at *task* grain to derive speculative re-dispatch
  deadlines.  Duplicating a straggling task is always sound there, since
  tasks are pure; the training loop flags its slow steps.
* :func:`resume_or_init` -- a training loop's restart from its newest
  committed checkpoint, the data pipeline fast-forwarded to it.
"""
from __future__ import annotations

import signal
import time
from collections import deque
from dataclasses import dataclass, field


class PreemptionGuard:
    """Latches SIGTERM/SIGINT into a ``preempted`` flag.

    ``install()`` saves the previous handlers so ``uninstall()`` can put
    them back -- a guard created for one search must not leak into test
    processes or pool workers for the rest of their lives.  Usable as a
    context manager for exactly that pairing.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = False
        self._installed = False
        self._signals = signals
        self._previous: dict = {}

    def install(self) -> "PreemptionGuard":
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:
                pass                        # non-main thread (tests)
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the signal handlers ``install()`` displaced."""
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass                        # non-main thread (tests)
        self._previous.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def request(self) -> None:              # for tests / manual drain
        self._requested = True


def resume_or_init(ckpt_dir, init_fn, load_fn, pipeline=None):
    """Returns ``(state, start_step)``: ``init_fn()`` and 0 when
    ``ckpt_dir`` holds no committed checkpoint, else ``load_fn(tree)`` of
    the newest one's tree (``checkpoint.py::restore``) and its step, with
    ``pipeline`` fast-forwarded to that step."""
    # lazy: the search pool's users of this module need no checkpoints
    from repro_torch.checkpoint.checkpoint import latest_step, restore

    step = latest_step(ckpt_dir)
    if step is None:
        return init_fn(), 0
    state = load_fn(restore(ckpt_dir, step))
    if pipeline is not None:
        pipeline.fast_forward(step)
    return state, step


@dataclass
class StragglerMonitor:
    """Wall-time statistics with two consumers:

    * step loops call ``step_start``/``step_end`` and get the windowed
      median-based straggler flag (``threshold x`` median);
    * the search pool calls ``observe(dt)`` per completed task and
      ``straggler_after()`` for an EWMA-based speculative-dispatch
      deadline (None until ``min_samples`` tasks have been observed).
    """

    window: int = 50
    threshold: float = 2.0
    alpha: float = 0.2            # EWMA smoothing factor for task grain
    min_samples: int = 5          # EWMA warm-up before deadlines are drawn
    times: deque = field(default_factory=deque)
    flagged_steps: list = field(default_factory=list)
    _t0: float | None = None
    _ewma: float | None = None
    _observed: int = 0

    def __post_init__(self):
        # honor the window field: the deque really is the window
        self.times = deque(self.times, maxlen=self.window)

    def observe(self, dt: float) -> None:
        """Record one duration (a step or a task wall time)."""
        self.times.append(dt)
        self._observed += 1
        self._ewma = dt if self._ewma is None \
            else self.alpha * dt + (1 - self.alpha) * self._ewma

    def step_start(self) -> None:
        self._t0 = time.monotonic()

    def step_end(self, step: int) -> bool:
        """Returns True if this step was a straggler.  A ``step_end``
        without a matching ``step_start`` records nothing and returns
        False."""
        if self._t0 is None:
            return False
        dt = time.monotonic() - self._t0
        self._t0 = None
        self.observe(dt)
        if len(self.times) < 10:
            return False
        med = sorted(self.times)[len(self.times) // 2]
        if dt > self.threshold * med:
            self.flagged_steps.append((step, dt, med))
            return True
        return False

    def straggler_after(self) -> float | None:
        """Duration beyond which a task counts as a straggler (EWMA x
        threshold), or None while the EWMA is still warming up."""
        if self._observed < self.min_samples or self._ewma is None:
            return None
        return self.threshold * self._ewma

    @property
    def median_s(self) -> float:
        if not self.times:
            return 0.0
        return sorted(self.times)[len(self.times) // 2]
