#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run it from the repository root with no arguments:

    python3 chip_smoke.py

What it does, in order; any failure ends the run with a non-zero exit code:

1. card     -- prints the GPU's name and power limit as ``nvidia-smi`` gives
               them, and builds the CUDA kernels from ``src/repro_torch/
               kernels/csrc`` with ``nvcc`` (reported as set-up seconds).
2. kernels  -- each of the four kernels against its plain torch version on
               the GPU, at the shapes the search gives it: yolov2 (26
               groups), resnet152 (160) and efficientnet-b1 (139, with SE
               side groups); cut-derived and random frame masks, all three
               objectives, duplicated argmin keys.  Integers must be equal
               and the float64 rows bit-equal.  Each kernel and its plain
               version are timed with CUDA events.
3. main     -- ``compile_graph`` with default options (``engine="pipeline"``
               on ``device="cuda"``) on the 8 zoo nets, among them
               yolov2@416 with its full space of 7,962,624 cut tuples, and
               again under ``engine="device"``.  Each engine's sweep has its
               own launch counts, set to 0 just before it and read just
               after: all four kernels must have run under ``pipeline`` and
               the allocator kernel under ``device``.  The plans are then held
               against the port's host ``journal`` engine (against
               ``pipeline:torch`` on the GPU for yolov2, whose space is too
               large for the host) and against pinned reference values.
4. report   -- wall and candidates per second of each compile; the yolov2
               compile again, 5 runs for the median wall and one run traced
               with ``torch.profiler`` for the card's busy share; one JSON
               line listing the kernels (times, bounds, launches under the
               default options), the card line, and a last line
               ``{"ok": true, "device": {...}}``.

The chunk of the pipeline engine is ``CHUNK`` candidates (``@1048576``): the
option's default of 1024 is sized for the host scorer.

It imports ``torch`` and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
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
}


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
    errs = {name: 0.0 for name in KERNEL_INFO}

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


def drive_main_path(nets, engine, limits):
    """One sweep of kernel-path compiles over ``nets`` under ``engine``
    (``"pipeline"``, the default options, or ``"device"``), with the launch
    counts set to 0 just before it and read just after.  Returns
    ``({(net, engine): (signature, seconds, options)}, launches)``."""
    import torch
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.options import CompileOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts

    out = {}
    reset_launch_counts()
    for net in nets:
        opts = CompileOptions(engine=f"{engine}@{CHUNK}")
        require(opts.device == "cuda"
                and opts.engine_spec().variant == "cuda",
                "default options do not resolve to the CUDA kernels")
        if net in limits:
            opts = opts.replace(exhaustive_limit=limits[net])
        t0 = time.perf_counter()
        plan = compile_graph(build_cnn(net), options=opts)
        torch.cuda.synchronize()
        out[net, engine] = (plan_signature(plan),
                            time.perf_counter() - t0, opts)
    return out, launch_counts()


def check_main_path(results):
    """Hold the kernel-path plans against the host journal engine, the plain
    versions on the GPU, and the pinned reference values."""
    import torch
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph

    for (net, engine), (sig, _seconds, opts) in results.items():
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
    sig = results["yolov2", "pipeline"][0]
    require_same_plan(sig, YOLOV2_PINNED, "yolov2 vs the pinned reference")
    for net in ("resnet50", "resnet152"):
        require_same_plan(results[net, "pipeline"][0], RESNET_PINNED,
                          f"{net} vs the pinned reference")


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
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0))
        if dev_us and "kernel" in ev.key:
            name = ev.key.split("::")[-1].split("(")[0]
            by_kernel[name] = {"count": ev.count, "device_ms": dev_us / 1e3}
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

    # ---- phase 3: the main path, one sweep per engine, each with its own
    # launch counts (set to 0 just before the sweep, read just after)
    nets = list(CNN_BUILDERS)
    results, launches = {}, {}
    for engine, limits, needed in (
            ("pipeline", {}, tuple(KERNEL_INFO)),
            ("device", {"yolov2": 100000}, ("alloc_scan",))):
        swept, launches[engine] = drive_main_path(nets, engine, limits)
        results.update(swept)
        log(f"launches under engine={engine!r}: {launches[engine]}")
        for name in needed:
            require(launches[engine][name] > 0,
                    f"kernel {name} was never launched under "
                    f"engine={engine!r}")
    check_main_path(results)

    # ---- phase 4: numbers
    for (net, engine), (sig, seconds, opts) in results.items():
        log(json.dumps({
            "compile": net, "engine": opts.engine_spec().spelling(),
            "path": sig["path"], "evaluated": sig["evaluated"],
            "wall_s": seconds,
            "candidates_per_s": sig["evaluated"] / seconds}))
    for net in ("yolov2", "resnet152"):
        c = checks[net]
        log(json.dumps({"kernel_times_at": net, "B": c["B"], "G": c["G"],
                        "L": c["L"], "alloc_ops_per_candidate":
                            c["alloc_ops_per_candidate"],
                        "times": c["times"]}))
    main_shape = checks["yolov2"]
    kernels = []
    for name, info in KERNEL_INFO.items():
        t = main_shape["times"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"],
            "launches": launches["pipeline"][name],
            "launches_under_device_engine": launches["device"][name],
            "max_abs_err": max(c["errs"][name] for c in checks.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": {"B": main_shape["B"], "G": main_shape["G"],
                      "L": main_shape["L"]}})
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
