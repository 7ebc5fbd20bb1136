"""Persistent, content-addressed plan cache.

One record per :func:`repro_torch.service.canonical.request_key`, stored as

    <root>/plan_<key[:32]>.rec

with the same commit discipline as the compiler's task journals
(``checkpoint/checkpoint.py``): the record body is msgpack compressed
through the shared codec (zstd where ``zstandard`` is installed, else
zlib), wrapped with its sha256 digest in a map written by
``packing.packb``, and written via ``atomic_write_bytes`` (tmp + fsync +
``os.replace``) -- a kill mid-write leaves either the old record or the
new one, never a torn file.  The layout is the JAX package's, so either
package reads the other's records (a zstd one only where ``zstandard``
is installed: elsewhere reading it raises, see :meth:`PlanCache.get`).  A record that fails its digest or schema
check on read is treated as a *miss* and deleted (unlike the task
journal, which raises: a journal resumes half-finished state, while a
cache entry is always safely recomputable).

Versioning: every record carries :data:`CACHE_SCHEMA_VERSION`; bumping
the version (a codec or canonicalization change) silently invalidates
the whole store record-by-record, no migration pass needed.

Eviction: bounded record count, LRU by file mtime (a served hit touches
its record's mtime).  Eviction runs at ``put`` time, so a read-only
serving process never deletes records under a writer.

Warm-start lookup: every record's wrapper carries a small metadata map
-- graph fingerprint, hw signature, plan-affecting options, winning
cuts -- readable without decompressing the plan body.  :meth:`nearest`
scans those for records of the same net family (equal graph
fingerprint) and returns the cut tuple of the one whose hw signature is
closest (normalized L1 distance over the numeric FPGAConfig fields), so
a miss for a known net on a *new* hardware config can seed the
branch-and-bound incumbent with the plan of the nearest known config.
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path

from repro_torch.checkpoint.checkpoint import (atomic_write_bytes,
                                               get_codec, get_decompressor)
from repro_torch.service.canonical import CACHE_SCHEMA_VERSION
from repro_torch.service.packing import packb, unpackb

# Default record-count bound; ~10-100 KB per record, so the default store
# stays well under 100 MB.
DEFAULT_CAPACITY = 1024


class PlanCache:
    def __init__(self, root: str | os.PathLike,
                 capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity={capacity}: must be >= 1")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.capacity = capacity

    # -------------------------------------------------------------- records
    def _path(self, key: str) -> Path:
        return self.root / f"plan_{key[:32]}.rec"

    def put(self, key: str, blob: bytes, meta: dict) -> None:
        """Commit ``blob`` (an encoded plan) under ``key``.

        ``meta`` must be msgpack-able; it is stored uncompressed in the
        wrapper so :meth:`nearest` can scan it cheaply.
        """
        codec, compress = get_codec()
        body = compress(blob)
        payload = packb(
            {"v": CACHE_SCHEMA_VERSION, "codec": codec,
             "digest": hashlib.sha256(body).hexdigest(), "meta": meta,
             "body": body})
        atomic_write_bytes(self._path(key), payload)
        self._evict()

    def _read_wrapper(self, path: Path) -> dict | None:
        """The verified wrapper at ``path``, or None (deleting the file)
        if it is damaged or from another schema version."""
        try:
            wrapper = unpackb(path.read_bytes())
            if (wrapper["v"] != CACHE_SCHEMA_VERSION
                    or hashlib.sha256(wrapper["body"]).hexdigest()
                    != wrapper["digest"]):
                raise ValueError("schema or digest mismatch")
            return wrapper
        except FileNotFoundError:
            return None
        except Exception:
            # stale schema or torn/corrupt record: a cache entry is always
            # recomputable, so drop it and report a miss
            path.unlink(missing_ok=True)
            return None

    def get(self, key: str) -> bytes | None:
        """The plan blob for ``key``, or None on miss.  A hit touches the
        record's mtime (the LRU clock).  The body is decompressed outside
        the wrapper's checks, as in the JAX package: a zstd record on a
        host without ``zstandard`` raises (the request fails), it is not
        a miss."""
        path = self._path(key)
        wrapper = self._read_wrapper(path)
        if wrapper is None:
            return None
        try:
            os.utime(path)
        except OSError:
            pass                           # racing eviction loses the touch
        return get_decompressor(wrapper["codec"])(wrapper["body"])

    def __contains__(self, key: str) -> bool:
        return self._read_wrapper(self._path(key)) is not None

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob("plan_*.rec"))

    def _evict(self) -> None:
        recs = sorted(self.root.glob("plan_*.rec"),
                      key=lambda p: (p.stat().st_mtime, p.name))
        for path in recs[:max(0, len(recs) - self.capacity)]:
            path.unlink(missing_ok=True)

    # ----------------------------------------------------------- warm start
    def nearest(self, graph_fp: str, hw_sig: list,
                require_path: str | None = None) -> tuple | None:
        """Cut tuple of the cached plan closest to ``(graph_fp, hw_sig)``.

        Only records of the *same* net family (equal canonical-graph
        fingerprint) are considered -- cut tuples are meaningless across
        different run structures; ``valid_warm_start`` downstream guards
        the residual risk of a fingerprint-equal graph changing shape
        across schema versions.  ``require_path`` additionally restricts
        donors to records whose stored search path matches (the daemon
        passes ``"exhaustive"`` when seeding a descent-path request, so
        only oracle-exact argmins ever seed descent searches).  Distance
        is the normalized L1 gap over the numeric hw fields (ti, to,
        sram_budget, dram_bw, ...), ties broken by record name for
        determinism.  Returns ``None`` when no family record exists --
        including on an exact-key hit's config, which is fine:
        ``nearest`` is only consulted on misses.
        """
        ref = {name: val for name, val in hw_sig
               if isinstance(val, (int, float))}
        best: tuple | None = None
        for path in sorted(self.root.glob("plan_*.rec")):
            wrapper = self._read_wrapper(path)
            if wrapper is None:
                continue
            meta = wrapper.get("meta") or {}
            if meta.get("graph_fp") != graph_fp or "cuts" not in meta:
                continue
            if (require_path is not None
                    and meta.get("path") != require_path):
                continue
            dist = 0.0
            for name, val in meta.get("hw_sig", []):
                if name in ref and val:
                    dist += abs(ref[name] - val) / max(abs(ref[name]),
                                                       abs(val))
            cand = (dist, path.name, tuple(meta["cuts"]))
            if best is None or cand < best:
                best = cand
        return best[2] if best is not None else None
