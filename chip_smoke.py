#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run it from the repository root with no arguments:

    python3 chip_smoke.py

What it does, in order; any failure ends the run with a non-zero exit code:

1. card     -- prints the GPU's name and power limit as ``nvidia-smi`` gives
               them, and builds the CUDA kernels from ``src/repro_torch/
               kernels/csrc`` with ``nvcc`` (reported as set-up seconds).
2. kernels  -- each of the five kernels against its plain torch version on
               the GPU, at the shapes the search gives it.  K1-K4: yolov2
               (26 groups), resnet152 (160) and efficientnet-b1 (139, with
               SE side groups); cut-derived and random frame masks, all
               three objectives, duplicated argmin keys.  K5, the float32
               scorer: the engine's default batch of 1,024 candidates at
               resnet152's 160 groups, a chunk of 1,048,576 at yolov2's 26
               and 8 candidates at efficientnet-b1's 139 (the largest batch
               the descent gives it), fed K2's masks and K1's io as the
               device engine feeds it, and random masks.  Integers must be
               equal and the float64 and float32 rows bit-equal.  Each
               kernel and its plain version are timed with CUDA events.
3. main     -- ``compile_graph`` on the 8 zoo nets in four sweeps: default
               options (``engine="pipeline"`` on ``device="cuda"``, among
               them yolov2@416 with its full space of 7,962,624 cut tuples),
               ``engine="device"``, and both again with
               ``backend="pallas"`` (the float32 scorer).  Each sweep has its
               own launch counts, set to 0 just before it and read just
               after: all of K1-K4 must have run under ``pipeline``, K1
               under ``device``, K5 under both ``pallas`` sweeps and K1 under
               the second.  The default plans are held against the port's
               host ``journal`` engine (against ``pipeline:torch`` on the GPU
               for yolov2, whose space is too large for the host) and pinned
               reference values; the ``pallas`` plans against the same
               compile with ``device="cpu"`` (yolov2's exhaustive plan under
               ``pipeline``, which the scorer never touches, against the
               pinned values).
4. numerics -- the quickstart pipeline (``examples/quickstart.py``) on the
               card at full width, for each zoo net at its published size:
               compile with ``verify="strict"``, the dry simulator audit
               equal to ``dram_report``, the simulator executed with
               ``init_params`` weights on a seeded input and its output equal
               to ``run_graph``'s on the card bit for bit; at 64 pixels,
               ``run_graph`` on the card within 1e-5 of the output's scale
               of the same on the host (TF32 would miss by ~1e-3).
5. report   -- wall and candidates per second of each compile, the execute
               times; the yolov2 compile again, 5 runs for the median wall
               and one run traced with ``torch.profiler`` for the card's busy
               share; one JSON line listing the kernels (times, bounds,
               launches per sweep), the card line, and a last line
               ``{"ok": true, "device": {...}}``.

The chunk of the pipeline engine is ``CHUNK`` candidates (``@1048576``): the
option's default of 1024 is sized for the host scorer.

It imports ``torch`` and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHUNK = 1 << 20

# NVIDIA H100 SXM peaks the bounds are computed against: device memory rate,
# and the vector (non tensor core) rates for the two operation types these
# kernels use.  int32 issues at half the float32 rate of 67 TFLOP/s; float64
# is the data sheet's 34 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 33.5e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_F64_OPS_PER_S = 34e12

# What the JAX package's ``pipeline:reference`` engine returns for
# yolov2@416 (exhaustive over all 7,962,624 tuples), and its winners for the
# two ResNets.
YOLOV2_PINNED = {
    "cuts": (2, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 3, 2, 1, 0),
    "evaluated": 7962624, "path": "exhaustive",
    "latency_cycles": 5728364.05, "dram_total": 55686129,
    "dram_fm": 4744337, "sram_total": 5131776, "bram18k": 3904,
    "feasible": True,
}
RESNET_PINNED = {"cuts": (5, 0, 2, 0, 2, 0, 1, 0), "evaluated": 8748}

KERNEL_INFO = {
    "alloc_scan": {
        "source": "src/repro_torch/kernels/csrc/alloc_scan.cu",
        "replaces": "src/repro/kernels/alloc_scan.py:492"},
    "enum_frames": {
        "source": "src/repro_torch/kernels/csrc/search_pipeline.cu",
        "replaces": "src/repro/kernels/search_pipeline.py:448"},
    "cost_rows": {
        "source": "src/repro_torch/kernels/csrc/search_pipeline.cu",
        "replaces": "src/repro/kernels/search_pipeline.py:490"},
    "argmin_rows": {
        "source": "src/repro_torch/kernels/csrc/search_pipeline.cu",
        "replaces": "src/repro/kernels/search_pipeline.py:592"},
    "score_batch": {
        "source": "src/repro_torch/kernels/csrc/score_batch.cu",
        "replaces": "src/repro/kernels/score_batch.py:149"},
}
# K5's shapes: the engine's default batch at the widest zoo net, one
# pipeline chunk at yolov2's groups, and the largest batch the descent gives
# it on the main path (a sweep's trials, 1 to 8 candidates)
SCORER_SHAPES = (("resnet152", 1024), ("yolov2", CHUNK),
                 ("efficientnet-b1", 8))
# the four sweeps of the main path: (engine, backend, exhaustive limits,
# kernels that must have launched)
PIPELINE_KERNELS = ("alloc_scan", "enum_frames", "cost_rows", "argmin_rows")
SWEEPS = (("pipeline", "numpy", {}, PIPELINE_KERNELS),
          ("device", "numpy", {"yolov2": 100000}, ("alloc_scan",)),
          ("pipeline", "pallas", {}, ("score_batch",)),
          ("device", "pallas", {"yolov2": 100000},
           ("alloc_scan", "score_batch")))


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------- card
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the GPU, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_by_kernel(prof) -> dict:
    """``{kernel: {"count", "device_ms"}}`` from a ``torch.profiler`` trace
    (empty when the trace holds no device time)."""
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0))
        if dev_us and "kernel" in ev.key:
            name = ev.key.split("::")[-1].split("(")[0]
            by_kernel[name] = {"count": ev.count, "device_ms": dev_us / 1e3}
    return by_kernel


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * n_ops / ops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# Operations of one allocator step as core/allocator.py::alloc_step states
# it, counted one per compare, add, maximum or select with buffers addressed
# by index (not this kernel's unrolled three-way forms):
#   a main-path step -- main operand in a buffer? (1), first free buffer (3),
#     fetch needed? (1), input buffer maximum (2), boundary reads into io and
#     bfm (2), final output? with its write into io, bfm, wrf (5), first
#     free buffer that holds no operand (3), take-over of the main operand's
#     buffer (3), claim or spill with its bytes and feasibility (5), owner and
#     buffer maximum (2), location (1): 28; a shortcut adds its buffer's
#     maximum (2);
#   each producer it consumes -- in DRAM? and its read bytes (2), mark its
#     buffer (1), consume (1), row-mode boundary write into io, bfm, wrf (5),
#     dead? owner? release (3): 12;
#   a side step -- side maximum and location (2); each producer: consume,
#     dead? owner? release (4).
ALLOC_OPS_STEP, ALLOC_OPS_SHORTCUT, ALLOC_OPS_PRODUCER = 28, 2, 12
ALLOC_OPS_SIDE_STEP, ALLOC_OPS_SIDE_PRODUCER = 2, 4


def alloc_ops_per_candidate(at) -> int:
    """Integer operations one candidate's replay needs on this graph."""
    side = at.is_side.astype(bool)
    fan_in = (at.gin != at.sink_idx).sum(axis=1)
    shortcuts = int((at.sc[~side] != at.sink_idx).sum())
    return int((~side).sum() * ALLOC_OPS_STEP
               + shortcuts * ALLOC_OPS_SHORTCUT
               + fan_in[~side].sum() * ALLOC_OPS_PRODUCER
               + side.sum() * ALLOC_OPS_SIDE_STEP
               + fan_in[side].sum() * ALLOC_OPS_SIDE_PRODUCER)


def kernel_bounds(B: int, G: int, free_runs: int, L: int,
                  alloc_ops: int) -> dict:
    """The least time the card could take for each kernel's work at these
    shapes: each input read once, each output written once, against the
    operations the function itself needs per candidate (not the
    instructions this implementation spends on them)."""
    return {
        # frame bits in; io (int32) and 7 stats out; the step rule's
        # operations, counted by alloc_ops_per_candidate
        "alloc_scan": bound(B * G + 4 * B * G + 28 * B, B * alloc_ops,
                            PEAK_INT32_OPS_PER_S),
        # one byte out per candidate and group; one divide and one modulo
        # per enumerated run (a fixed prefix run needs none), a compare and
        # a direction select per group
        "enum_frames": bound(B * G, B * (2 * free_runs + 3 * G),
                             PEAK_INT32_OPS_PER_S),
        # mask (1 B) + io (4 B) per candidate and group and 7 stats in, one
        # 32-byte row per block of 256 out; ~8 float64 operations per group
        "cost_rows": bound(5 * B * G + 28 * B + 32 * (-(-B // 256)),
                           B * (8 * G + 16), PEAK_F64_OPS_PER_S),
        # L rows of 32 bytes in, one out; up to 4 compares per row
        "argmin_rows": bound(32 * L + 32, 4 * L, PEAK_F64_OPS_PER_S),
    }


def scorer_bound(B: int, G: int):
    """K5: a mask byte and four io bytes per candidate and group and the
    nine float32 table rows in, six float32 stats per candidate out; about
    14 float32 operations per group (the latency term: add, divide,
    maximum, add, two selects, the sum; the row-mode term: select, add;
    the four masked maxima and their masks)."""
    return bound(5 * B * G + 36 * G + 24 * B, 14 * B * G, PEAK_F32_OPS_PER_S)


# --------------------------------------------------------- kernels vs plain
def make_engine(net: str):
    from repro_torch.cnn import build_cnn
    from repro_torch.core.cutpoint import CutpointEngine
    from repro_torch.core.grouping import group_nodes
    from repro_torch.core.hw import KCU1500
    gg = group_nodes(build_cnn(net))
    return CutpointEngine(gg, KCU1500, engine="pipeline:cuda", device="cuda")


def check_space(engine, target: int):
    """The whole cut space when it has at most ``target`` tuples, else the
    sub-space of the trailing runs that does (leading cuts fixed mid-run)."""
    from repro_torch.kernels.search_pipeline import SubSpace
    dims = [len(r) + 1 for r in engine.runs]
    size, q = 1, len(dims)
    while q > 0 and size * dims[q - 1] <= target:
        q -= 1
        size *= dims[q]
    prefix = tuple(len(r) // 2 for r in engine.runs[:q])
    return SubSpace.make(prefix, dims[q:], "cuda")


def fuzz_lanes(gen, n: int):
    """Key lanes designed to tie (tiny value sets), (4, n) float64."""
    import torch

    def pick(values):
        v = torch.tensor(values, dtype=torch.float64, device="cuda")
        return v[torch.randint(len(values), (n,), generator=gen,
                               device="cuda")]

    idx = torch.randperm(10 * n, generator=gen, device="cuda")[:n]
    return torch.stack([pick([0.0, 1.0]), pick([3.0, 7.0, 7.0, 11.0, 1e9]),
                        pick([2.0, 5.0, 5.0, 123456.0]),
                        idx.to(torch.float64)])


def max_abs_err(got, want) -> float:
    import torch
    return float((got.to(torch.float64) - want.to(torch.float64))
                 .abs().max()) if got.numel() else 0.0


def check_kernels(net: str, target: int, timed: bool, reps: int) -> dict:
    """Every kernel against its plain version on the GPU at ``net``'s
    shapes; returns per-kernel ``{"max_abs_err", "ms", "plain_ms", ...}``."""
    import torch
    from repro_torch.kernels import alloc_scan as scan
    from repro_torch.kernels import search_pipeline as pipe

    engine = make_engine(net)
    tbl = pipe._engine_tables(engine)
    at = engine.alloc_tables()
    space = check_space(engine, target)
    B = min(CHUNK, space.size)
    lo = space.size - B                   # the ragged end of the space
    G, nr = tbl.n, len(engine.runs)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1000 + G)
    errs = {name: 0.0 for name in PIPELINE_KERNELS}

    def same(name, got, want, what, bits=False):
        require(got.shape == want.shape,
                f"{net} {name} {what}: shape {tuple(got.shape)} != "
                f"{tuple(want.shape)}")
        errs[name] = max(errs[name], max_abs_err(got, want))
        if bits:
            ok = torch.equal(got.contiguous().view(torch.int64),
                             want.contiguous().view(torch.int64))
        else:
            ok = torch.equal(got.to(torch.int64), want.to(torch.int64))
        require(ok, f"{net} {name} {what}: kernel != plain version "
                    f"(max abs err {errs[name]})")

    # K2 enumeration
    frame_k = pipe.enum_frames_cuda(tbl, space, lo, B)
    frame_p = pipe.enum_frames_torch(tbl, space, lo, B)
    same("enum_frames", frame_k, frame_p, "masks")

    # K1 allocator replay: cut-derived masks and random masks
    rand = (torch.rand((B, G), generator=gen, device="cuda")
            < torch.rand((B, 1), generator=gen, device="cuda"))
    runs = {}
    for what, frame in (("cut masks", frame_k), ("random masks", rand)):
        res_k = scan.alloc_scan_cuda(at, frame)
        res_p = scan.alloc_scan_torch(at, frame)
        same("alloc_scan", res_k.io, res_p.io, f"{what} io")
        same("alloc_scan", res_k.stats, res_p.stats, f"{what} stats")
        runs[what] = (frame, res_k, res_p)
    for b in (1, 3):                       # B = 1 and a ragged batch
        res_k = scan.alloc_scan_cuda(at, rand[:b])
        res_p = scan.alloc_scan_torch(at, rand[:b])
        same("alloc_scan", res_k.io, res_p.io, f"B={b} io")
        same("alloc_scan", res_k.stats, res_p.stats, f"B={b} stats")

    # K3 cost rows, three objectives, fed by the kernel's and by the plain
    # version's replay (int32 lane-major and int64 row-major inputs)
    rows_main = None
    for what, (frame, res_k, res_p) in runs.items():
        for objective in pipe.OBJECTIVES:
            want = pipe.cost_rows_torch(tbl, frame, res_p.io, res_p.stats,
                                        lo, objective)
            for feed, res in (("kernel-fed", res_k), ("plain-fed", res_p)):
                got = pipe.cost_rows_cuda(tbl, frame, res.io, res.stats, lo,
                                          objective)
                same("cost_rows", got, want, f"{what} {objective} {feed}",
                     bits=True)
            if what == "cut masks" and objective == "latency":
                rows_main = want

    # K4 argmin: the cost stage's rows, and keys stuffed with duplicates
    lanes_list = [rows_main] + [fuzz_lanes(gen, n)
                                for n in (1, 2, 255, 256, 257, 4096, 100003)]
    for lanes in lanes_list:
        same("argmin_rows", pipe.argmin_rows_cuda(lanes),
             pipe.argmin_rows_torch(lanes), f"L={lanes.shape[1]}", bits=True)
    torch.cuda.synchronize()

    out = {"net": net, "B": B, "G": G, "runs": nr, "L": rows_main.shape[1],
           "errs": errs}
    if not timed:
        return out
    frame, res_k, res_p = runs["cut masks"]
    cases = {
        "enum_frames": (lambda: pipe.enum_frames_cuda(tbl, space, lo, B),
                        lambda: pipe.enum_frames_torch(tbl, space, lo, B)),
        "alloc_scan": (lambda: scan.alloc_scan_cuda(at, frame),
                       lambda: scan.alloc_scan_torch(at, frame)),
        "cost_rows": (lambda: pipe.cost_rows_cuda(tbl, frame, res_k.io,
                                                  res_k.stats, lo, "latency"),
                      lambda: pipe.cost_rows_torch(tbl, frame, res_p.io,
                                                   res_p.stats, lo,
                                                   "latency")),
        "argmin_rows": (lambda: pipe.argmin_rows_cuda(rows_main),
                        lambda: pipe.argmin_rows_torch(rows_main)),
    }
    bounds = kernel_bounds(B, G, len(space.dims), rows_main.shape[1],
                           alloc_ops_per_candidate(at))
    out["alloc_ops_per_candidate"] = alloc_ops_per_candidate(at)
    out["times"] = {}
    for name, (kernel, plain) in cases.items():
        # in turns: plain, kernel, kernel, plain
        p1 = time_ms(plain, reps=2)
        k1 = time_ms(kernel, reps=reps, warmup=2)
        k2 = time_ms(kernel, reps=reps, warmup=0)
        p2 = time_ms(plain, reps=2, warmup=0)
        out["times"][name] = {
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
    return out


def check_scorer(shapes, timed: bool, reps: int) -> dict:
    """K5 against its plain version on the GPU, bit for bit, at each
    ``(net, B)`` of ``shapes``: K2's masks of the last B tuples of the
    net's space with K1's io (int32, lane-major: what the device engine
    hands over), random masks with float32 io, B = 1 and B = 3.  Returns
    ``{net: {"B", "G", "max_abs_err"[, "ms", "plain_ms", "bound_ms",
    "bound_by", "device_ms"]}}``: ``ms`` is a launch through the wrapper
    by CUDA events, ``device_ms`` the kernel's own time in a
    ``torch.profiler`` trace of ``reps`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import alloc_scan as scan
    from repro_torch.kernels import score_batch as sb
    from repro_torch.kernels import search_pipeline as pipe

    out = {}
    for net, B in shapes:
        engine = make_engine(net)
        tbl = pipe._engine_tables(engine)
        space = check_space(engine, 8 * CHUNK)
        require(space.size >= B, f"{net}: {space.size} tuples < B = {B}")
        frame = pipe.enum_frames_cuda(tbl, space, space.size - B, B)
        io = scan.alloc_scan_cuda(engine.alloc_tables(), frame).io
        t = engine.score_tables()
        G = t.g
        args = (engine.hw.dram_bytes_per_cycle,
                engine.hw.group_overhead_cycles)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2000 + G)
        rand = (torch.rand((B, G), generator=gen, device="cuda")
                < torch.rand((B, 1), generator=gen, device="cuda"))
        rio = torch.randint(0, 1 << 22, (B, G), generator=gen,
                            device="cuda").to(torch.float32)
        err = 0.0
        for what, f, i in (("cut masks, K1 io", frame, io),
                           ("random masks, float32 io", rand, rio),
                           ("B=1", rand[:1], rio[:1]),
                           ("B=3", rand[:3], rio[:3])):
            got = sb.score_batch_cuda(t, f, i, *args)
            want = sb.score_batch_torch(t, f, i, *args)
            require(got.shape == want.shape == (f.shape[0], sb.N_STATS),
                    f"{net} score_batch {what}: shape {tuple(got.shape)}")
            err = max(err, max_abs_err(got, want))
            require(torch.equal(got.contiguous().view(torch.int32),
                                want.contiguous().view(torch.int32)),
                    f"{net} score_batch {what}: kernel != plain version "
                    f"(max abs err {err})")
        torch.cuda.synchronize()
        row = {"B": B, "G": G, "max_abs_err": err}
        if timed:
            def kernel():
                return sb.score_batch_cuda(t, frame, io, *args)

            def plain():
                return sb.score_batch_torch(t, frame, io, *args)
            # in turns: plain, kernel, kernel, plain
            p1 = time_ms(plain, reps=2)
            k1 = time_ms(kernel, reps=reps, warmup=2)
            k2 = time_ms(kernel, reps=reps, warmup=0)
            p2 = time_ms(plain, reps=2, warmup=0)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    kernel()
                torch.cuda.synchronize()
            traced = device_time_by_kernel(prof).get("score_batch_kernel")
            b = scorer_bound(B, G)
            row.update(ms=min(k1, k2), plain_ms=min(p1, p2), bound_ms=b[0],
                       bound_by=b[1],
                       device_ms=(traced["device_ms"] / traced["count"]
                                  if traced else "not measured"))
        out[net] = row
    return out


# ---------------------------------------------------------------- main path
def plan_signature(plan) -> dict:
    c = plan.candidate
    return {
        "cuts": tuple(c.cuts), "evaluated": plan.search.evaluated,
        "path": plan.search.path, "latency_cycles": plan.latency.cycles,
        "dram_total": plan.dram.total, "dram_fm": plan.dram.fm_bytes,
        "sram_total": plan.sram.sram_total, "bram18k": plan.sram.bram18k,
        "feasible": c.feasible,
        "words": tuple(tuple(int(w) for w in i.encode())
                       for i in plan.instructions),
    }


def require_same_plan(got: dict, want: dict, what: str):
    for key, value in want.items():
        require(got[key] == value,
                f"{what}: {key} differs: {str(got[key])[:200]} != "
                f"{str(value)[:200]}")


def drive_main_path(nets, engine, limits, backend="numpy"):
    """One sweep of kernel-path compiles over ``nets`` under ``engine``
    (``"pipeline"``, the default options, or ``"device"``) and ``backend``,
    with the launch counts set to 0 just before it and read just after.
    Returns ``({(net, engine, backend): (signature, seconds, options)},
    launches)``."""
    import torch
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.options import CompileOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts

    out = {}
    reset_launch_counts()
    for net in nets:
        opts = CompileOptions(engine=f"{engine}@{CHUNK}", backend=backend)
        require(opts.device == "cuda"
                and opts.engine_spec().variant == "cuda",
                "default options do not resolve to the CUDA kernels")
        if net in limits:
            opts = opts.replace(exhaustive_limit=limits[net])
        t0 = time.perf_counter()
        plan = compile_graph(build_cnn(net), options=opts)
        torch.cuda.synchronize()
        out[net, engine, backend] = (plan_signature(plan),
                                     time.perf_counter() - t0, opts)
    return out, launch_counts()


def check_main_path(results):
    """Hold the kernel-path plans against the host journal engine, the plain
    versions on the GPU, and the pinned reference values."""
    import torch
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph

    for (net, engine, backend), (sig, _seconds, opts) in results.items():
        if backend != "numpy":
            continue
        what = f"{net} under {opts.engine}"
        require(all(w == w for w in (sig["latency_cycles"],))
                and sig["latency_cycles"] > 0 and sig["words"],
                f"{what}: empty or non-finite plan")
        if net == "yolov2" and engine == "pipeline":
            # 7,962,624 tuples: too many for the host's journal walk here
            other = opts.replace(engine=f"pipeline:torch@{CHUNK}")
            against = "pipeline:torch on the GPU"
        else:
            other = opts.replace(engine="journal")
            against = "the host journal engine"
        t0 = time.perf_counter()
        want = plan_signature(compile_graph(build_cnn(net), options=other))
        torch.cuda.synchronize()
        log(f"  {what}: equals {against} "
            f"({time.perf_counter() - t0:.2f} s)")
        require_same_plan(sig, want, f"{what} vs {against}")
    sig = results["yolov2", "pipeline", "numpy"][0]
    require_same_plan(sig, YOLOV2_PINNED, "yolov2 vs the pinned reference")
    for net in ("resnet50", "resnet152"):
        require_same_plan(results[net, "pipeline", "numpy"][0],
                          RESNET_PINNED, f"{net} vs the pinned reference")


def check_pallas_path(results):
    """Hold the ``backend="pallas"`` plans against the same compile with
    ``device="cpu"``, the plain versions (K5 equals its plain version bit
    for bit, so the plans must be equal); yolov2's exhaustive plan under
    ``pipeline``, which the scorer never touches, against the pinned
    reference values (its space is too large for the host)."""
    import torch
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph

    for (net, engine, backend), (sig, _seconds, opts) in results.items():
        if backend != "pallas":
            continue
        what = f"{net} under {opts.engine}, backend='pallas'"
        if net == "yolov2" and engine == "pipeline":
            require_same_plan(sig, YOLOV2_PINNED,
                              f"{what} vs the pinned reference")
            continue
        t0 = time.perf_counter()
        want = plan_signature(compile_graph(
            build_cnn(net), options=opts.replace(device="cpu")))
        torch.cuda.synchronize()
        log(f"  {what}: equals device='cpu' "
            f"({time.perf_counter() - t0:.2f} s)")
        require_same_plan(sig, want, f"{what} vs device='cpu'")


# ------------------------------------------------------------- numerics
def quickstart(nets, device="cuda") -> list:
    """The quickstart pipeline on the card at full width, one row per net
    (see the module docstring, phase 4); ``device`` is the card, or the
    CPU for a rehearsal at small sizes."""
    import numpy as np
    import torch
    from repro_torch.analysis import errors_of
    from repro_torch.cnn import build_cnn
    from repro_torch.cnn.torch_ref import init_params, load_params, run_graph
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.dram import dram_report
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.simulator import simulate

    def seeded_input(size):
        return np.random.default_rng(0).standard_normal((1, size, size, 3),
                                                        dtype=np.float32)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    rows = []
    for net in nets:
        graph = build_cnn(net)
        size, last = graph.nodes[0].out_h, len(graph.nodes) - 1
        t0 = time.perf_counter()
        plan = compile_graph(graph, options=CompileOptions(
            engine=f"pipeline@{CHUNK}", verify="strict", device=device))
        compile_s = time.perf_counter() - t0
        require(not errors_of(plan.diagnostics),
                f"{net}: verify='strict' let errors through")
        _, dry = simulate(plan.grouped, plan.alloc, plan.instructions,
                          execute=False)
        rep = dram_report(plan.grouped, plan.alloc)
        require(dry.fm_total == rep.fm_bytes == plan.dram.fm_bytes
                and dry.weight_reads == rep.weight_bytes
                and dry.dangling_reads == 0,
                f"{net}: dry audit {dry} != dram_report {rep}")
        w = load_params(init_params(graph), device)
        x = torch.from_numpy(seeded_input(size)).to(device)
        want = run_graph(graph, w, x, device=device)[last]     # warm-up
        sync()
        t0 = time.perf_counter()
        out, run = simulate(plan.grouped, plan.alloc, plan.instructions, w,
                            x, device=device)
        sync()
        simulate_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        again = run_graph(graph, w, x, device=device)[last]
        sync()
        run_graph_ms = 1e3 * (time.perf_counter() - t0)
        for other, what in ((want, "run_graph"), (again, "run_graph again")):
            require(out.shape == other.shape and torch.equal(
                out.view(torch.int32), other.view(torch.int32)),
                f"{net}: simulator output != {what} on the card")
        require(bool(torch.isfinite(out).all()),
                f"{net}: non-finite output")
        require(dataclasses.astuple(run) == dataclasses.astuple(dry),
                f"{net}: executed counters {run} != dry counters {dry}")
        del w, want, again
        # the card's float32 against the host's on a small input
        small = build_cnn(net, 64)
        sp, sx = init_params(small), seeded_input(64)
        card = run_graph(small, sp, sx, device=device)[len(small.nodes) - 1]
        host = run_graph(small, sp, sx, device="cpu")[len(small.nodes) - 1]
        card, host = card.cpu().double(), host.double()
        rel = float((card - host).abs().max() / host.abs().max())
        require(card.shape == host.shape and rel <= 1e-5,
                f"{net}@64: card vs host {rel:.3g} of the output's scale")
        rows.append({
            "quickstart": net, "size": size,
            "groups": len(plan.grouped.groups),
            "output": list(out.shape), "compile_s": compile_s,
            "simulate_ms": simulate_ms, "run_graph_ms": run_graph_ms,
            "dram_fm_bytes": dry.fm_total, "onchip_hit_bytes": dry.onchip_hits,
            "card_vs_host_at_64px": rel})
        log(json.dumps(rows[-1]))
    return rows


# ------------------------------------------------- where the time goes
def yolov2_wall_and_busy() -> dict:
    """The yolov2@416 compile under default options at ``CHUNK``: the wall of
    5 runs, then one run traced with ``torch.profiler`` for the kernels'
    device time (the card's busy share of the untraced median wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.options import CompileOptions

    graph = build_cnn("yolov2")

    def compile_once():
        t0 = time.perf_counter()
        plan = compile_graph(graph, options=CompileOptions(
            engine=f"pipeline@{CHUNK}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require_same_plan(plan_signature(plan), YOLOV2_PINNED,
                          "yolov2, repeated compile")
        return 1e3 * wall

    compile_once()                                       # warm
    walls = sorted(compile_once() for _ in range(5))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_wall = compile_once()
    by_kernel = device_time_by_kernel(prof)
    busy = sum(k["device_ms"] for k in by_kernel.values())
    return {
        "yolov2_compile": "pipeline:cuda", "chunk": CHUNK,
        "wall_ms_5_runs": walls, "wall_ms_median": walls[2],
        "candidates_per_s_at_median":
            YOLOV2_PINNED["evaluated"] / (walls[2] / 1e3),
        "traced_wall_ms": traced_wall,
        "device_busy_ms": busy if by_kernel else "not measured",
        "device_busy_share_of_median_wall":
            busy / walls[2] if by_kernel else "not measured",
        "device_time_by_kernel": by_kernel}


# --------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels, print what ptxas says, check "
                         "them against their plain versions at small "
                         "sizes, and stop")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures on the GPU only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    from repro_torch.cnn import CNN_BUILDERS
    from repro_torch.kernels import _build
    _build.load(verbose=args.kernels_only)
    log(f"set-up: kernels built in {_build.build_seconds:.1f} s")

    if args.kernels_only:
        for net in ("yolov2", "resnet152", "efficientnet-b1"):
            r = check_kernels(net, target=20000, timed=False, reps=0)
            log(f"kernels equal their plain versions: {json.dumps(r)}")
        r = check_scorer((("resnet152", 1024), ("yolov2", 20000)),
                         timed=False, reps=0)
        log(f"score_batch equals its plain version: {json.dumps(r)}")
        return 0

    # ---- phase 2: kernels against their plain versions, and their times
    checks = {}
    for net, target, timed in (("yolov2", CHUNK * 8, True),
                               ("resnet152", CHUNK, True),
                               ("efficientnet-b1", 200000, False)):
        t0 = time.perf_counter()
        checks[net] = check_kernels(net, target, timed, reps=10)
        c = checks[net]
        log(f"kernels == plain versions at {net} shapes "
            f"(B={c['B']}, G={c['G']}, runs={c['runs']}): max abs err "
            f"{c['errs']} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    scorer = check_scorer(SCORER_SHAPES, timed=True, reps=20)
    log(f"score_batch == plain version at {SCORER_SHAPES}: "
        f"{json.dumps(scorer)} ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 3: the main path, four sweeps, each with its own launch
    # counts (set to 0 just before the sweep, read just after)
    nets = list(CNN_BUILDERS)
    results, launches = {}, {}
    for engine, backend, limits, needed in SWEEPS:
        swept, counts = drive_main_path(nets, engine, limits, backend)
        launches[engine, backend] = counts
        results.update(swept)
        log(f"launches under engine={engine!r}, backend={backend!r}: "
            f"{counts}")
        for name in needed:
            require(counts[name] > 0,
                    f"kernel {name} was never launched under "
                    f"engine={engine!r}, backend={backend!r}")
    check_main_path(results)
    check_pallas_path(results)

    # ---- phase 4: the quickstart pipeline at full width
    t0 = time.perf_counter()
    quick = quickstart(nets)
    log(f"quickstart pipeline on {len(quick)} nets: compile, strict verify, "
        f"audit, simulator == run_graph bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 5: numbers
    for (net, engine, backend), (sig, seconds, opts) in results.items():
        log(json.dumps({
            "compile": net, "engine": opts.engine_spec().spelling(),
            "backend": backend, "path": sig["path"],
            "evaluated": sig["evaluated"], "wall_s": seconds,
            "candidates_per_s": sig["evaluated"] / seconds}))
    for net in ("yolov2", "resnet152"):
        c = checks[net]
        log(json.dumps({"kernel_times_at": net, "B": c["B"], "G": c["G"],
                        "L": c["L"], "alloc_ops_per_candidate":
                            c["alloc_ops_per_candidate"],
                        "times": c["times"]}))
    by_sweep = {name: {f"{e}+{b}": launches[e, b][name]
                       for e, b, _l, _n in SWEEPS}
                for name in KERNEL_INFO}
    main_shape = checks["yolov2"]
    kernels = []
    for name in PIPELINE_KERNELS:
        info, t = KERNEL_INFO[name], main_shape["times"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"],
            "launches": launches["pipeline", "numpy"][name],
            "launches_by_sweep": by_sweep[name],
            "max_abs_err": max(c["errs"][name] for c in checks.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": {"B": main_shape["B"], "G": main_shape["G"],
                      "L": main_shape["L"]}})
    info = KERNEL_INFO["score_batch"]
    t, chunk, descent = (scorer[net] for net, _b in SCORER_SHAPES)
    kernels.append({
        "name": "score_batch", "route": "cuda", "source": info["source"],
        "replaces": info["replaces"],
        "launches": launches["pipeline", "pallas"]["score_batch"],
        "launches_by_sweep": by_sweep["score_batch"],
        "max_abs_err": max(r["max_abs_err"] for r in scorer.values()),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "device_ms": t["device_ms"], "shape": {"B": t["B"], "G": t["G"]},
        "at_chunk": chunk, "at_descent_batch": descent})
    log(json.dumps(yolov2_wall_and_busy()))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr, flush=True)
        code = 1
    sys.exit(code)
