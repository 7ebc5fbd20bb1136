"""Crash-atomic records on disk: the training checkpoints, the search
pool's task journal and the codec helpers of both and of the plan cache.

**Training checkpoints** (:func:`save`, :func:`latest_step`,
:func:`restore`, :class:`AsyncCheckpointer`) are the JAX package's on-disk
format, so a checkpoint written by either package restores in the other::

    <dir>/step_000123/
        host_<k>.ckpt      -- a msgpack map "<leaf path>::<index>" -> the
                              piece's bytes, compressed
        MANIFEST_<k>.json  -- per leaf: global shape, dtype, the pieces'
                              index, shape and digest; the codec
        COMMITTED          -- written last; restore ignores dirs without it

A tree is nested dicts, tuples and lists of arrays (numpy, or torch
tensors, copied to the host); leaf paths are the JAX package's
(``tree_flatten_with_path``: dict keys sorted, written ``['key']``,
sequence items ``[i]``, joined by ``/``), e.g. ``[0]/['embed']/['tok']``.
An index is the piece's ``(start, stop)`` per dimension.  The port runs
on one host and writes host 0's files; :func:`restore` reads every
host's.  The msgpack is
``service/packing.py``'s (the machine with the GPU has no msgpack
package); the codec is :func:`get_codec`'s.  Where the JAX package writes
one piece a device shard, this module cuts a leaf into row blocks of at
most ``PIECE_BYTES`` and compresses them on a thread each (zlib, the codec
on the card, takes ~20 MB/s a core); the JAX package's ``restore``
assembles pieces by their index either way.  :func:`restore` rebuilds the
tree from the names (no template), checks every piece's digest and parses
indices with ``ast.literal_eval``.

**The task journal** (:class:`TaskJournal`)::

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
same metrics.  It is not msgpack, as the JAX package's journal is; the
records therefore differ in bytes between the two packages but decode to
the same values.

The compile service's plan cache (``service/cache.py``) compresses its
records through :func:`get_codec` / :func:`get_decompressor`, the JAX
package's codec helpers: zstd where the optional ``zstandard`` package is
installed, else the standard library's zlib.  The journal above keeps its
own codec.
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

try:
    import zstandard
except ImportError:            # optional: fall back to the standard zlib
    zstandard = None

CODEC = "zlib"
MAGIC = b"repro_torch-journal-1\n"
PIECE_BYTES = 8 << 20        # a training checkpoint's pieces, at most


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


# ------------------------------------------------------ training checkpoints
def _flatten(tree, path=()) -> list:
    """``[(path name, leaf)]`` in the JAX package's ``tree_flatten_with_path``
    order and spelling."""
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [("/".join(path), tree)]
    return [leaf for key, v in items for leaf in _flatten(v, path + (key,))]


def _unflatten(named: dict):
    """The tree of :func:`_flatten`'s names: ``['key']`` levels become
    dicts, ``[i]`` levels tuples."""
    root: dict = {}
    for name, leaf in named.items():
        keys = [ast.literal_eval(part)[0] for part in name.split("/")]
        node = root
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return tuple(build(node[i]) for i in range(len(node)))
        return {k: build(v) for k, v in node.items()}
    return build(root)


def _numpy(x) -> np.ndarray:
    """A leaf as a numpy array (a torch tensor on the host, no copy)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pieces(a: np.ndarray) -> list:
    """``(index, piece)`` of row blocks of at most ``PIECE_BYTES``."""
    if a.ndim == 0 or a.nbytes <= PIECE_BYTES:
        return [(tuple((0, d) for d in a.shape), a)]
    rows = max(1, PIECE_BYTES // max(1, a.nbytes // a.shape[0]))
    return [(((r, min(r + rows, a.shape[0])),)
             + tuple((0, d) for d in a.shape[1:]), a[r:r + rows])
            for r in range(0, a.shape[0], rows)]


def save(tree, directory, step: int) -> Path:
    """Write ``tree`` as checkpoint ``step`` under ``directory`` (see the
    module docstring) and commit it: one host, host 0."""
    from repro_torch.service import packing

    final = Path(directory) / f"step_{step:09d}"
    final.mkdir(parents=True, exist_ok=True)
    codec = get_codec()[0]
    named = [(name, _numpy(leaf)) for name, leaf in _flatten(tree)]
    jobs = [(name, idx, np.ascontiguousarray(piece))
            for name, a in named for idx, piece in _pieces(a)]
    # a compressor a piece: zstd's are not to be shared between threads
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        blobs = list(pool.map(lambda job: get_codec()[1](job[2].tobytes()),
                              jobs))
    manifest = {"step": step, "leaves": {}, "n_hosts": 1, "codec": codec}
    for name, a in named:
        manifest["leaves"][name] = {"global_shape": list(a.shape),
                                    "dtype": str(a.dtype), "shards": []}
    payload = {}
    for (name, idx, piece), blob in zip(jobs, blobs):
        payload[f"{name}::{idx}"] = blob
        manifest["leaves"][name]["shards"].append({
            "index": idx, "shape": list(piece.shape),
            "digest": hashlib.sha256(blob).hexdigest()[:16]})
    atomic_write_bytes(final / "host_0.ckpt", packing.packb(payload))
    atomic_write_bytes(final / "MANIFEST_0.json",
                       json.dumps(manifest).encode())
    atomic_write_bytes(final / "COMMITTED", b"ok")
    return final


def latest_step(directory) -> int | None:
    """The newest committed step under ``directory``, or None."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in directory.iterdir()
             if d.name.startswith("step_") and (d / "COMMITTED").exists()]
    return max(steps) if steps else None


def restore(directory, step: int):
    """The tree of committed checkpoint ``step`` (host 0's manifest, every
    host's pieces), its leaves numpy arrays of the manifest's shapes and
    types.  A piece whose digest does not match its manifest raises
    ``ValueError``."""
    from repro_torch.service import packing

    directory = Path(directory) / f"step_{step:09d}"
    if not (directory / "COMMITTED").exists():
        raise FileNotFoundError(f"no committed checkpoint at {directory}")
    manifest = json.loads((directory / "MANIFEST_0.json").read_text())
    pieces = []                  # (key, blob, codec)
    for f in sorted(directory.glob("host_*.ckpt")):
        hid = f.stem.split("_", 1)[1]
        man_path = directory / f"MANIFEST_{hid}.json"
        if not man_path.exists():
            raise RuntimeError(
                f"{f.name} present but {man_path.name} is missing -- "
                f"host {hid}'s checkpoint write was incomplete")
        host = json.loads(man_path.read_text())
        codec = host.get("codec", "zstd")
        get_decompressor(codec)       # raises here if it cannot be read
        digests = {f"{name}::{tuple(tuple(i) for i in sh['index'])}":
                   sh["digest"]
                   for name, leaf in host["leaves"].items()
                   for sh in leaf["shards"]}
        payload = packing.unpackb(f.read_bytes())
        if set(payload) != set(digests):
            raise ValueError(f"{f}: its pieces are not its manifest's")
        for key, blob in payload.items():
            if hashlib.sha256(blob).hexdigest()[:16] != digests[key]:
                raise ValueError(f"{f}: piece {key} does not match its "
                                 f"manifest's digest")
            pieces.append((key, blob, codec))
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        raws = list(pool.map(lambda p: get_decompressor(p[2])(p[1]),
                             pieces))
    named = {}
    for name, meta in manifest["leaves"].items():
        named[name] = np.zeros(meta["global_shape"], np.dtype(meta["dtype"]))
    for (key, _blob, _d), raw in zip(pieces, raws):
        name, idx = key.split("::", 1)
        idx = ast.literal_eval(idx)
        full = named[name]
        piece = np.frombuffer(raw, full.dtype).reshape(
            [stop - start for start, stop in idx])
        full[tuple(slice(start, stop) for start, stop in idx)] = piece
    return _unflatten(named)


class AsyncCheckpointer:
    """Double-buffered async save: :meth:`save` copies the tree's torch
    tensors to the host at once (the next in-place optimizer step
    overwrites them) and takes its numpy leaves as they are, as the JAX
    package takes its host arrays (``convert.lm_params_to_numpy``'s are
    fresh copies); a thread compresses and writes it.  :meth:`wait` joins
    that thread and raises what it raised."""

    def __init__(self, directory):
        self.directory = Path(directory)
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, tree, step: int) -> None:
        self.wait()
        snapshot = _unflatten({
            name: leaf.detach().to("cpu", copy=True).numpy()
            if hasattr(leaf, "detach") else np.asarray(leaf)
            for name, leaf in _flatten(tree)})
        self._pending = threading.Thread(target=self._write,
                                         args=(snapshot, step), daemon=True)
        self._pending.start()

    def _write(self, tree, step: int) -> None:
        try:
            save(tree, self.directory, step)
        except BaseException as e:          # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error


# ------------------------------------------------------------- task journal
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
