"""Deterministic, restart-safe LM data pipeline.

The JAX package's ``data/pipeline.py``, kept as its own copy (it is numpy
only, and the port imports nothing of that package): ``batch_at`` gives
the same bytes in both.

Two sources behind one interface:
  * SyntheticSource -- hash-based token stream, reproducible per
    (seed, step, host): byte-identical across restarts and host counts,
    so fault-tolerant resume never replays or skips a batch.
  * BinTokenSource  -- memory-mapped uint32 token file (the standard
    packed-tokens format); each host reads only its shard.

The pipeline yields per-host batches; `fast_forward(step)` is O(1) --
the fault-tolerance substrate uses it after checkpoint restore.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from pathlib import Path
from queue import Queue

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    path: str | None = None          # None -> synthetic

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} is not a "
                             f"multiple of {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


class SyntheticSource:
    """splitmix64-based reproducible token stream with LEARNABLE structure.

    Tokens are drawn from a 512-token active subset (so the unigram
    distribution alone is worth ln(V) - ln(512) nats and is learnable in
    tens of steps) and every odd position is a deterministic hash of its
    predecessor (pair structure worth another ~ln(512)/2).  Uniform noise
    over the full vocab would pin the loss at ln(V) forever."""

    ACTIVE = 512

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        c = self.cfg
        active = min(c.vocab, self.ACTIVE)
        n = c.host_batch * (c.seq_len + 1)
        base = (np.uint64(step) << np.uint64(32)) \
            | (np.uint64(c.host_id) << np.uint64(20))
        with np.errstate(over="ignore"):
            idx = np.arange(n, dtype=np.uint64) + np.uint64(
                c.seed) * np.uint64(0x9E3779B97F4A7C15)
            x = base + idx
            # splitmix64 finalizer
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            x = x ^ (x >> np.uint64(31))
            toks = (x % np.uint64(active)).astype(np.int64).reshape(
                c.host_batch, c.seq_len + 1)
            # structure: odd positions are a fixed hash of the previous
            # token (predictable); even positions stay random
            pred = (toks * 2654435761 + 12345) % active
            out = toks.copy()
            out[:, 1::2] = pred[:, 0:-1:2]
        out = out.astype(np.int32)
        return {"tokens": out[:, :-1],
                "labels": out[:, 1:].copy()}


class BinTokenSource:
    """Packed uint32 tokens on disk; hosts stride disjoint slices."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.memmap(Path(cfg.path), dtype=np.uint32, mode="r")
        self.tokens_per_batch = cfg.host_batch * (cfg.seq_len + 1)
        self.n_batches = (len(self.data) // cfg.n_hosts
                          ) // self.tokens_per_batch
        if self.n_batches <= 0:
            raise ValueError(f"{cfg.path}: too small for one batch")

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        c = self.cfg
        b = step % self.n_batches
        start = (self.cfg.host_id * self.n_batches + b) \
            * self.tokens_per_batch
        flat = np.asarray(
            self.data[start:start + self.tokens_per_batch],
            dtype=np.int32).reshape(c.host_batch, c.seq_len + 1)
        flat = flat % c.vocab
        return {"tokens": flat[:, :-1], "labels": flat[:, 1:].copy()}


class Pipeline:
    """Prefetching iterator with O(1) fast-forward."""

    def __init__(self, cfg: DataConfig, prefetch: int = 2):
        self.cfg = cfg
        self.source = BinTokenSource(cfg) if cfg.path else SyntheticSource(cfg)
        self.step = 0
        self._q: Queue = Queue(maxsize=prefetch)
        self._prefetch = prefetch
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ control
    def fast_forward(self, step: int) -> None:
        if self._thread is not None:
            raise RuntimeError("fast_forward after iteration started")
        self.step = step

    def _worker(self) -> None:
        s = self.step
        while not self._stop.is_set():
            self._q.put((s, self.source.batch_at(s)))
            s += 1

    def __iter__(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        s, batch = self._q.get()
        self.step = s + 1
        return batch

    def close(self) -> None:
        self._stop.set()
        while not self._q.empty():
            self._q.get_nowait()
