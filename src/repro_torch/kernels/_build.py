"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` expose a plain C interface (no PyTorch
headers), so ``nvcc`` compiles them in seconds.  Each source is compiled
for ``sm_90a`` into an object file -- all sources at once, one ``nvcc``
process each -- the objects are linked into one shared library, and the
library is loaded with ``ctypes``.  Everything happens at the first kernel
call, never at import: a host without ``nvcc`` or a GPU can import every
module of the package.

The build directory is ``build/repro_torch/`` at the repository root; the
library's name carries a hash of the sources and flags, so an edited kernel
is rebuilt and a stale library is never loaded.

There is no fallback: if the build or the load fails, the call raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMMON_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
# Per-source flags.  search_pipeline.cu holds the float64 cost stage, whose
# results must equal the host's IEEE arithmetic bit for bit, and
# score_batch.cu the float32 scorer, held bit-equal to its plain torch
# version: no fused multiply-add contraction, and no fast-math anywhere.
# The LM kernels (flash attention, the fused MLP block and the SSD scan,
# each as a SIMT and a tensor-core source) are held to their plain versions
# within a tolerance; the RG-LRU scan bit for bit, and rglru_scan.cu spells
# its rounding out with intrinsics.  Headers (*.cuh: tensor_core.cuh, the
# PTX helpers of the tensor-core sources and of the RG-LRU scan's ring) are
# hashed with the sources.
SOURCES = {
    "alloc_scan.cu": (),
    "search_pipeline.cu": ("-fmad=false",),
    "score_batch.cu": ("-fmad=false",),
    "flash_attention.cu": (),
    "flash_attention_tc.cu": (),
    "fused_block.cu": (),
    "fused_block_tc.cu": (),
    "ssd_scan.cu": (),
    "ssd_scan_tc.cu": (),
    "rglru_scan.cu": (),
}

_LIB: ctypes.CDLL | None = None
# seconds the last build took (0.0 when a cached library was loaded);
# callers report it as set-up time
build_seconds = 0.0


def build_dir() -> Path:
    # src/repro_torch/kernels/_build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and under $CUDA_HOME, "
            "/usr/local/cuda): the CUDA kernels cannot be built on this "
            "host")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256()
    for name, flags in sorted(SOURCES.items()):
        h.update(name.encode())
        h.update(" ".join(ARCH_FLAGS + COMMON_FLAGS + flags).encode())
        h.update((CSRC / name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path, lib_path: Path, verbose: bool) -> None:
    nvcc = find_nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for name, flags in SOURCES.items():
        obj = out_dir / (name + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *COMMON_FLAGS, *flags, *extra,
               "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    objs = []
    failed = []
    for name, obj, proc in procs:           # every process is waited for
        out, _ = proc.communicate()
        if verbose and out:
            print(out, flush=True)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}:\n{out}")
        objs.append(str(obj))
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}.so")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link the kernels:\n{link.stdout}")
    os.replace(tmp, lib_path)               # atomic: no half-written library


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"librepro_torch_{_digest()}.so"
    if not lib_path.exists():
        t0 = time.perf_counter()
        _compile(out_dir, lib_path, verbose)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib)
    _LIB = lib
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes for every entry point: pointers and the stream are
    ``c_void_p`` (ctypes would otherwise cut them to 32 bits)."""
    p, i, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_double)
    lib.alloc_scan_launch.argtypes = [
        p, p, p, p, p,              # frame, steps, slots, io, stats
        ll, i, i, i,                # B, n, k, lw
        i, i, i,                    # input_slot, input_meta, W
        i, p]                       # device, stream
    lib.enum_frames_launch.argtypes = [
        p, p, p, p, p,              # digits, run_of, pos_of, dir_neg, frame
        ll, ll, i, i, i,            # lo, B, n, nr, vec
        i, p]                       # device, stream
    lib.cost_rows_launch.argtypes = [
        p, p, p, p, p,              # frame, io, stats, tab, out
        p, p, ll,                   # winner, slots, cap (null: no winner)
        ll, ll, ll, i,              # lo, S, B, n
        d, d, d, d, d,              # bpc, goc, budget, wbytes, row_buff
        i, i,                       # objective, split
        i, p]                       # device, stream
    lib.argmin_rows_launch.argtypes = [p, p, ll, i, p]   # lanes, out, L,
    #                                                      device, stream
    f = ctypes.c_float
    lib.score_batch_launch.argtypes = [
        p, p, i, p, p,              # frame, io, io_is_int, tab, out
        ll, i, f, f, i, p]          # B, G, bpc, overhead, device, stream
    lib.score_batch_split_launch.argtypes = [
        p, ll, ll,                  # frame, its strides (B, G)
        p, ll, ll, i,               # io, its strides, io_is_int
        p, p,                       # tab, out
        ll, i, f, f, i, p]          # B, G, bpc, overhead, device, stream
    lib.flash_attention_launch.argtypes = [
        p, p, p, p,                 # q, k, v, o
        i, i, i, i, i, i,           # B, S, T, NH, NKV, hd
        f, i, i, f,                 # scale, causal, window, softcap
        i, i, p]                    # is_bf16, device, stream
    lib.flash_attention_tc_launch.argtypes = [
        p, p, p, p,                 # q, k, v, o
        i, i, i, i, i, i,           # B, S, T, NH, NKV, hd
        f, i, i, f,                 # scale, causal, window, softcap
        i, p]                       # device, stream
    lib.fused_block_launch.argtypes = [
        p, p, p, p, p, p, p, p,     # x, scale, wg, wu, wd, post, out, part
        i, i, i, i, i,              # M, d, F, bf, splits
        i, i, i, f,                 # gated, gelu, sandwich, eps
        i, i, p]                    # is_bf16, device, stream
    lib.fused_block_tc_launch.argtypes = [
        p, p, p, p, p, p, p,        # x, scale, wg, wu, wd, post, out
        p, p, p,                    # scratch n, h, y
        i, i, i,                    # M, d, F
        i, i, i, f,                 # gated, gelu, sandwich, eps
        i, p]                       # device, stream
    lib.ssd_scan_launch.argtypes = [
        p, p, p, p, p, p, p,        # x, dt, A, Bm, Cm, D, h0
        p, p,                       # y, hout
        i, i, i, i, i, i, i,        # B, S, H, G, P, N, Q
        ll, i, i, p]                # bc_stride, is_bf16, device, stream
    lib.ssd_scan_tc_launch.argtypes = [
        p, p, p, p, p, p, p,        # x, dt, A, Bm, Cm, D, h0
        p, p, p, p,                 # y, hout, scratch states, sync
        i, i, i, i, i, i, i,        # B, S, H, G, P, N, Q
        ll, i, p]                   # bc_stride, device, stream
    lib.rglru_scan_launch.argtypes = [
        p, p, p,                    # a, b, h
        i, i, i, i,                 # B, S, W, vec
        i, p]                       # device, stream
    for fn in (lib.alloc_scan_launch, lib.enum_frames_launch,
               lib.cost_rows_launch, lib.argmin_rows_launch,
               lib.score_batch_launch, lib.score_batch_split_launch,
               lib.flash_attention_launch,
               lib.flash_attention_tc_launch, lib.fused_block_launch,
               lib.fused_block_tc_launch, lib.ssd_scan_launch,
               lib.ssd_scan_tc_launch, lib.rglru_scan_launch):
        fn.restype = ctypes.c_int


def check(err: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"(cudaGetLastError)")
