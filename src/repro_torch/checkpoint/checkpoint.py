"""The task journal of the search pool: crash-atomic, digest-checked
records, one per completed task.

Layout (one directory per search)::

    <root>/search_<search_key>/task_<task_key>.rec

Each record is committed with :func:`atomic_write_bytes` (tmp file, fsync,
``os.replace``), so a kill mid-write never corrupts the journal: a record
is either wholly present or absent.  A record that is present but cannot
be trusted -- truncated, altered, undecodable -- raises
:class:`JournalError` instead of being recomputed behind the caller's back.

The record codec is the standard library's: the record is JSON, compressed
with zlib, and a sha256 digest over the compressed blob is stored in a
one-line JSON header in front of it::

    repro_torch-journal-1\\n{"codec":"zlib","digest":"<hex>","size":N}\\n<blob>

JSON round-trips what the pool journals bit for bit: ints of any size,
bools, strings, lists, and float64 through ``repr`` (the shortest string
that reads back to the same double), so a resumed search reproduces the
same metrics.  It is not msgpack, as the JAX package's journal is, because
the machine with the GPU has no msgpack; the records therefore differ in
bytes between the two packages but decode to the same values.  The
training half of the JAX package's module (``save`` / ``restore`` /
``AsyncCheckpointer``) is not here.

The compile service's plan cache (``service/cache.py``) compresses its
records through :func:`get_codec` / :func:`get_decompressor`, the JAX
package's codec helpers: zstd where the optional ``zstandard`` package is
installed, else the standard library's zlib.  The journal above keeps its
own codec.
"""
from __future__ import annotations

import hashlib
import json
import os
import zlib
from pathlib import Path

try:
    import zstandard
except ImportError:            # optional: fall back to the standard zlib
    zstandard = None

CODEC = "zlib"
MAGIC = b"repro_torch-journal-1\n"


def get_codec():
    """(name, compress) -- zstd when available, stdlib zlib otherwise."""
    if zstandard is not None:
        return "zstd", zstandard.ZstdCompressor(level=3).compress
    return "zlib", (lambda b: zlib.compress(b, 3))


def get_decompressor(codec: str):
    """The decompressor of a record written under ``codec``; a zstd record
    on a host without ``zstandard`` raises ``RuntimeError``."""
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstd but zstandard is not "
                "installed")
        return zstandard.ZstdDecompressor().decompress
    return zlib.decompress


def atomic_write_bytes(path, data: bytes) -> None:
    """Crash-atomic file write: tmp file in the same directory, fsync,
    then ``os.replace`` -- a reader never observes a partial file."""
    path = Path(path)
    tmp = path.parent / f".tmp_{path.name}.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def encode_record(record: dict) -> bytes:
    """``record`` (JSON types only) as the bytes of one journal file."""
    blob = zlib.compress(
        json.dumps(record, separators=(",", ":")).encode(), 3)
    header = json.dumps({"codec": CODEC,
                         "digest": hashlib.sha256(blob).hexdigest(),
                         "size": len(blob)}, separators=(",", ":"))
    return MAGIC + header.encode() + b"\n" + blob


def decode_record(data: bytes) -> dict:
    """The record of :func:`encode_record`'s bytes; ``ValueError`` on
    anything else (a foreign file, a truncated blob, a digest mismatch)."""
    if not data.startswith(MAGIC):
        raise ValueError("not a journal record (bad magic)")
    header, sep, blob = data[len(MAGIC):].partition(b"\n")
    if not sep:
        raise ValueError("truncated header")
    meta = json.loads(header)
    if meta.get("codec") != CODEC:
        raise ValueError(f"unknown codec {meta.get('codec')!r}")
    if len(blob) != meta["size"]:
        raise ValueError(f"truncated blob: {len(blob)} of {meta['size']} "
                         f"bytes")
    if hashlib.sha256(blob).hexdigest() != meta["digest"]:
        raise ValueError("digest mismatch")
    return json.loads(zlib.decompress(blob))


class JournalError(RuntimeError):
    """A journal record exists but cannot be trusted (truncated file,
    digest mismatch, undecodable payload).  Raised instead of silently
    recomputing: a corrupt record means the journal directory is damaged
    and resuming from its siblings may be equally wrong."""


class TaskJournal:
    """Task-granular completion journal for resumable compiles.

    One journal covers one *search* (``search_key``, a content hash of
    graph/hw/plan-affecting options/partition that the caller computes);
    each completed task commits one record file (see the module
    docstring for the layout and the codec).  Records hold JSON types
    only: ints, float64, bools, str, lists and maps with str keys.
    """

    def __init__(self, root, search_key: str):
        self.dir = Path(root) / f"search_{search_key}"
        self.dir.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def task_key(obj) -> str:
        """Stable 16-hex key for a task identity (e.g. a prefix tuple)."""
        return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]

    def _path(self, task_key: str) -> Path:
        return self.dir / f"task_{task_key}.rec"

    def put(self, task_key: str, record: dict) -> None:
        atomic_write_bytes(self._path(task_key), encode_record(record))

    def get(self, task_key: str):
        """The committed record for ``task_key``, or None if absent."""
        path = self._path(task_key)
        if not path.exists():
            return None
        try:
            return decode_record(path.read_bytes())
        except Exception as e:
            # any decode/digest/decompress failure: the record is damaged
            raise JournalError(
                f"corrupt task-journal record {path}: {e}") from e

    def __len__(self) -> int:
        return sum(1 for _ in self.dir.glob("task_*.rec"))
