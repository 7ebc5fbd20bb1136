"""One run of one cell: set-up, the measured window, the check, the result.

``bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
prints, as the last line of its standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and, traced,
``breakdown``) and last ``checks``: each number compared beside its limit,
as they also are the last lines of its standard error.

The window is a closed loop of one client calling the program's
``compile_graph`` back to back; each plan is read into digests right after
its call, outside the timed span.  After the window the device's peak is
read, the program's state is let go, and the reference prices every
distinct request the window sent.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

from harness import check, spec, traffic
from harness.network import program_accelerator, program_graph
from harness.trace import WINDOW, profiler, summarize, top

# top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the compile options the reference models; any other would change what a
# plan is (a float32 scorer, pruned counts, a different search)
MODELLED_OPTIONS = ("engine", "exhaustive_limit", "objective")


@dataclass
class Window:
    """What one run measured: what every metric's reader reads."""
    setup_s: float
    walls: list[float]              # each compile completed in the window
    searches: list[float]           # traced: their search spans, in order
    compiles_run: int               # between the counters' reset and read
    launches: dict                  # kernel -> launches the program counted
    trace: dict | None              # trace.summarize(), in a traced run
    shape: dict                     # the graph's counts (reference.shape)
    chunks: list[int] = field(default_factory=list)  # candidates a launch


def loaded_forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: the loaded
    ones), each compared whole: ``repro_torch`` is not ``repro``."""
    tops = {name.split(".")[0] for name in
            list(sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def host_usage() -> tuple:
    """The process's CPU seconds (all threads), its voluntary and
    involuntary context switches, and its threads."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    threads = 0
    try:
        with open("/proc/self/status") as f:
            threads = int(next(line.split()[1] for line in f
                               if line.startswith("Threads:")))
    except (OSError, StopIteration):
        pass
    return (r.ru_utime + r.ru_stime, r.ru_nvcsw, r.ru_nivcsw, threads)


class Port:
    """The program under test: ``repro_torch``'s compiler."""

    def __init__(self, network: dict, device: str):
        from repro_torch import kernels
        from repro_torch.core import compiler
        from repro_torch.core.options import CompileOptions

        self.compiler, self.kernels = compiler, kernels
        self.options = CompileOptions
        self.graph = program_graph(network)
        self.device = device
        self._search = None

    def prepare(self, hw_fields: dict, opts: dict):
        return (program_accelerator(hw_fields),
                self.options(**opts, device=self.device))

    def compile(self, args):
        hw, opts = args
        return self.compiler.compile_graph(self.graph, hw, opts)

    def build_seconds(self) -> float:
        """Seconds the kernels' library took to build in this process (0.0
        where it was loaded as built)."""
        from repro_torch.kernels import _build

        return _build.build_seconds

    def reset_counts(self) -> None:
        self.kernels.reset_launch_counts()

    def counts(self) -> dict:
        return self.kernels.launch_counts()

    def span_search(self, spans: list | None) -> None:
        """Time every call into the search layer (``spans``), or stop."""
        if spans is None:
            self.compiler.search = self._search
            return
        from torch.profiler import record_function

        inner = self._search = self.compiler.search

        def search(*args, **kwargs):
            with record_function("bench.search"):
                t = time.perf_counter()
                try:
                    return inner(*args, **kwargs)
                finally:
                    spans.append(time.perf_counter() - t)

        self.compiler.search = search


def reference_plan(ref, request_hw: dict, opts: dict):
    from reference import accelerator

    unknown = sorted(set(opts) - set(MODELLED_OPTIONS))
    if unknown:
        raise ValueError(f"the reference does not model the options "
                         f"{unknown}")
    if "exhaustive_limit" not in opts:
        raise ValueError("the mix must state exhaustive_limit")
    return ref.plan(accelerator(request_hw), opts.get("objective", "latency"),
                    opts["exhaustive_limit"])


def chunk_sizes(cell: spec.Cell, opts: dict) -> list[int]:
    from rooflines import chunks

    batch = opts.get("engine", "").partition("@")[2]
    return chunks(cell.config["cut_space"], int(batch)) if batch else []


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             started: float, device: str = "cuda", root: Path = spec.ROOT,
             program=None, log=None, phases=None) -> dict:
    """One run of cell ``name``; returns the result's fields (``checks``
    last).  ``program``: a factory ``(network, device)`` of what the window
    drives, the port by default; ``phases``: set-up seconds already spent
    since ``started``, by name."""
    import torch

    import reference

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    phases = dict(phases or {})
    phases["imports"] = (time.perf_counter() - started
                         - sum(phases.values()))
    cell = spec.load_cell(name, root)
    cfg, mix = cell.config, cell.traffic
    hw_fields = cfg["accelerator"]["fields"]
    on_card = device.startswith("cuda")
    mark = time.perf_counter()
    if on_card:
        torch.empty(0, device=device)
        torch.cuda.synchronize()
        phases["cuda_context"] = time.perf_counter() - mark
        mark = time.perf_counter()
    prog = (program or Port)(cfg["network"], device)
    phases["program"] = time.perf_counter() - mark

    def request_args(req):
        return (traffic.accelerator(cfg, req),
                traffic.options(mix, cfg, req, hw_fields))

    def prepared(req):
        return prog.prepare(*request_args(req))

    # set-up: one warm compile at the cell's shapes
    warm = traffic.one_round(mix)[0]
    mark = time.perf_counter()
    prog.compile(prepared(warm))
    if on_card:
        torch.cuda.synchronize()
    phases["warm_compile"] = time.perf_counter() - mark
    counted = hasattr(prog, "reset_counts")
    if counted:
        prog.reset_counts()
    stream = traffic.requests(mix, seed)
    walls, searches, answers = [], [], []
    kept = {}                       # one plan of each (request, fingerprint)
    spans: list[float] = []
    prof = profiler() if traced else None
    marks = (torch.profiler.record_function if traced
             else lambda _name: nullcontext())
    setup_s = time.perf_counter() - started
    log("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
        + f"; of the warm compile, the kernels' build "
        f"{getattr(prog, 'build_seconds', lambda: 0.0)():.3f}; total "
        f"{setup_s:.3f}")
    host0 = host_usage()
    if traced:
        prof.__enter__()
        if hasattr(prog, "span_search"):
            prog.span_search(spans)
    opened = time.perf_counter()
    deadline = opened + seconds
    with marks(WINDOW):
        while time.perf_counter() < deadline:
            req = next(stream)
            args = prepared(req)
            n_spans = len(spans)
            with marks("bench.compile"):
                t = time.perf_counter()
                try:
                    plan = prog.compile(args)
                except Exception as exc:          # a failed request
                    plan = None
                    log(f"request {req} raised {exc!r}")
                wall = time.perf_counter() - t
            if plan is None:
                answers.append((traffic.key(req), None))
                continue
            if t + wall <= deadline:
                walls.append(wall)
                if len(spans) > n_spans:
                    searches.append(spans[-1])
            fp = check.fingerprint(plan)
            answers.append((traffic.key(req), fp))
            kept.setdefault((traffic.key(req), fp), plan)
            del plan
    closed = time.perf_counter()
    host1 = host_usage()
    if traced:
        if hasattr(prog, "span_search"):
            prog.span_search(None)
        prof.__exit__(None, None, None)
    launches = prog.counts() if counted else {}
    compiles_run = len(answers)
    got = {k: check.plan_parts(plan) for k, plan in kept.items()}
    del kept
    summary = summarize(prof) if traced else None
    del prof
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    del prog
    if on_card:
        torch.cuda.empty_cache()

    # the check: the reference's plan of every distinct request sent
    t = time.perf_counter()
    ref = reference.Reference(cfg["network"], device)
    want = {}
    for k, _ in answers:
        if k not in want:
            want[k] = check.plan_parts(
                reference_plan(ref, *request_args(dict(k))))
    numbers, rejected = check.compare(answers, got, want)
    del ref
    log(f"reference: {len(want)} distinct requests checked against "
        f"{len(answers)} plans in {time.perf_counter() - t:.3f} s")

    window = Window(setup_s=setup_s, walls=walls,
                    searches=searches, compiles_run=compiles_run,
                    launches=launches, trace=summary,
                    shape=reference.shape(cfg["network"]),
                    chunks=chunk_sizes(cell, request_args(warm)[1]))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"], root).read(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"host in the window: cpu {host1[0] - host0[0]:.3f} s of "
        f"{closed - opened:.3f} s wall, context switches "
        f"{host1[1] - host0[1]} voluntary / {host1[2] - host0[2]} "
        f"involuntary, {host1[3]} threads, torch threads "
        f"{torch.get_num_threads()}")
    if walls:
        q = sorted(walls)
        log(f"window: {len(q)} compiles completed in {closed - opened:.3f} s;"
            f" wall ms p10 {1e3 * q[len(q) // 10]:.4f}, p50 "
            f"{1e3 * q[len(q) // 2]:.4f}, max {1e3 * q[-1]:.4f}")
    result = {"correct": bool(answers) and check.verdict(numbers),
              "attempted": len(answers),
              "failed": rejected, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {
            "device_ops": top({k: v["seconds"] for k, v in
                               summary["device_ops"].items()}),
            "idle_gaps": top(summary["idle_by_host"])}
        seen = {k: v["count"] for k, v in summary["device_ops"].items()}
        log(f"kernels the trace saw {json.dumps(seen)}; launches the "
            f"program counted {json.dumps(launches)} over "
            f"{compiles_run} compiles")
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, started: float) -> int:
    import torch

    phases = {"import_torch": time.perf_counter() - started}
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    mark = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"host has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    phases["cuda_probe"] = time.perf_counter() - mark
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), started, phases=phases)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded modules that must not be: {bad}", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
