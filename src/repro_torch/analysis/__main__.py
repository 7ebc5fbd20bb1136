"""CLI: statically verify compiled plans and run the mutation-kill gate.

Usage::

    python -m repro_torch.analysis --all                    # verify every zoo net
    python -m repro_torch.analysis --net resnet50 --strict  # one net, exit 1 on error
    python -m repro_torch.analysis --all --mutation-kill    # coverage gate
    python -m repro_torch.analysis --all --report out.txt   # write rendered report
    python -m repro_torch.analysis --all --engine pipeline --device cuda

Each net is compiled (bounded search, identical to the tier-1 audit
setup), verified with the full check battery, and reported per plan.
``--strict`` exits nonzero when any error-severity diagnostic survives;
``--mutation-kill`` additionally injects every applicable mutation class
x seed and exits nonzero unless the verifier kills 100% of them.

The counterpart of the JAX package's ``python -m repro.analysis``, with the
same flags plus ``--device``: the default ``--engine journal`` is host code
and needs no GPU; the ``device`` and ``pipeline`` engines run on
``--device`` (``cuda`` unless told otherwise).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.diagnostics import Severity, render_report
from repro_torch.analysis.liveness import journal_trace, render_intervals
from repro_torch.analysis.mutate import kill_matrix, render_kill_matrix
from repro_torch.analysis.verifier import verify_execution_plan
from repro_torch.cnn import build_cnn
from repro_torch.core.compiler import compile_graph
from repro_torch.core.options import CompileOptions

ZOO = [("vgg16-conv", 224), ("yolov2", 416), ("yolov3", 416),
       ("resnet50", 224), ("resnet152", 224), ("efficientnet-b1", 256),
       ("retinanet", 512), ("mobilenet-v3", 224)]

# Same bound as tests/test_simulator_audit.py: detector-scale nets take
# the coordinate-descent path so a full-zoo verify stays interactive.
DEFAULT_LIMIT = 50_000


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static verification of compiled ExecutionPlans.")
    ap.add_argument("--net", action="append", default=[],
                    help="zoo net to verify (repeatable); see --all")
    ap.add_argument("--all", action="store_true",
                    help="verify every zoo net")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 if any error-severity diagnostic is found")
    ap.add_argument("--report", metavar="PATH",
                    help="also write the rendered report to PATH")
    ap.add_argument("--mutation-kill", action="store_true",
                    help="run the seeded mutation fuzzer; exit 1 unless "
                         "every applicable mutant is killed")
    ap.add_argument("--seeds", type=int, default=3,
                    help="seeds per mutation class (default 3)")
    ap.add_argument("--engine", default="journal",
                    help="execution engine for the compile search "
                         "(e.g. journal, device, device:torch, pipeline)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device/pipeline engines "
                         "(default cuda; cpu runs their plain versions)")
    ap.add_argument("--exhaustive-limit", type=int, default=DEFAULT_LIMIT,
                    help=f"cut-search exhaustive bound "
                         f"(default {DEFAULT_LIMIT})")
    ap.add_argument("--intervals", action="store_true",
                    help="include the buffer live-interval summary")
    args = ap.parse_args(argv)

    sizes = dict(ZOO)
    nets = [n for n, _ in ZOO] if args.all else args.net
    if not nets:
        ap.error("pick nets with --net NAME (repeatable) or --all")
    unknown = [n for n in nets if n not in sizes]
    if unknown:
        ap.error(f"unknown net(s) {unknown}; zoo: {sorted(sizes)}")

    blocks: list[str] = []
    plans: dict[str, object] = {}
    total_errors = 0
    for name in nets:
        plan = compile_graph(
            build_cnn(name, sizes[name]),
            options=CompileOptions(
                exhaustive_limit=args.exhaustive_limit,
                engine=args.engine, device=args.device))
        plans[name] = plan
        diags = verify_execution_plan(plan)
        total_errors += sum(d.severity is Severity.ERROR for d in diags)
        extra = ""
        if args.intervals:
            extra = "  " + render_intervals(
                journal_trace(plan.grouped, plan.alloc.policy))
        blocks.append(render_report(
            f"{name} ({len(plan.grouped.groups)} groups, "
            f"{'feasible' if plan.candidate.feasible else 'infeasible'})",
            diags, extra=extra))

    out = "\n".join(blocks)
    exit_code = 0
    if args.strict and total_errors:
        exit_code = 1

    if args.mutation_kill:
        rows = kill_matrix(plans, seeds=tuple(range(args.seeds)))
        out += "\n\n" + render_kill_matrix(rows)
        applied = [r for r in rows if r["applied"]]
        missed = [r for r in applied if not r["killed"]]
        if missed or not applied:
            exit_code = 1

    print(out)
    if args.report:
        with open(args.report, "w") as fh:
            fh.write(out + "\n")
        print(f"report written to {args.report}", file=sys.stderr)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
