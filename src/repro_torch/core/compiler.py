"""End-to-end ShortcutFusion compiler: graph -> ExecutionPlan.

Pipeline (paper Fig. 4), one pass per stage:

1. **Parse & analyze** -- ``grouping.group_nodes`` fuses the node graph
   into accelerator instruction groups (conv + its post-processing chain).
2. **Block-wise optimize** -- ``cutpoint.search`` picks a frame-/row-reuse
   mode per residual block by searching cut positions over the monotone
   runs of feature-map size, scoring each candidate with the reuse-aware
   allocator (allocator.py) plus the SRAM/DRAM/latency models (sram.py /
   dram.py / timing.py).  By default the exhaustive search runs on the
   GPU through the fused pipeline (kernels/search_pipeline.py).
3. **Generate instructions** -- ``isa.generate_instructions`` lowers the
   winning allocation to the accelerator's register-level instruction
   stream (one GroupInstruction per group).

Under a ``torch.profiler`` each call is a ``compile`` span with the stages
as ``compile.group``, ``search`` and ``compile.plan`` inside it
(``utils/tracing.py``).

The result is an :class:`ExecutionPlan`: the chosen policy/allocation, the
three analytic reports the paper tabulates (SRAM, DRAM, latency), derived
metrics (GOPS, MAC efficiency, off-chip reduction vs. the all-row
baseline), and the instruction stream.  Everything is static -- no
hardware or input tensors are involved -- which is what lets the static
verifier (``repro_torch.analysis``) and the functional simulator
(core/simulator.py) audit the plan byte for byte.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

from repro_torch.core.allocator import Allocation, allocate, frame_feasible
from repro_torch.core.cutpoint import (DEFAULT_BATCH_SIZE,  # noqa: F401
                                 EXHAUSTIVE_LIMIT, Candidate, SearchResult,
                                 search, sweep_single_cut)
from repro_torch.core.options import CompileOptions, resolve_options
from repro_torch.core.dram import DRAMReport, baseline_total, dram_report
from repro_torch.core.grouping import GroupedGraph, group_nodes
from repro_torch.core.hw import FPGAConfig, KCU1500
from repro_torch.core.ir import Graph
from repro_torch.core.isa import GroupInstruction, generate_instructions
from repro_torch.core.sram import SRAMReport, sram_report
from repro_torch.core.timing import LatencyReport, latency_report
from repro_torch.utils.tracing import COMPILE, span


@dataclass
class ExecutionPlan:
    graph: Graph
    grouped: GroupedGraph
    hw: FPGAConfig
    candidate: Candidate
    alloc: Allocation
    sram: SRAMReport
    dram: DRAMReport
    latency: LatencyReport
    instructions: list[GroupInstruction]
    search: SearchResult | None = None
    # static-verifier findings (empty when verify="off" or the plan is
    # clean); see repro_torch.analysis
    diagnostics: list = field(default_factory=list)

    # ------------------------------------------------------------- metrics
    @property
    def latency_ms(self) -> float:
        return 1e3 * self.latency.cycles / self.hw.freq

    @property
    def gops(self) -> float:
        return 2 * self.graph.total_macs() / (self.latency.cycles / self.hw.freq) / 1e9

    @property
    def mac_efficiency(self) -> float:
        return self.gops * 1e9 / self.hw.peak_gops

    @property
    def baseline_dram(self) -> int:
        return baseline_total(self.grouped)

    @property
    def offchip_reduction(self) -> float:
        base = self.baseline_dram
        return (base - self.dram.total) / base if base else 0.0

    def summary(self) -> str:
        mb = 1 / (1 << 20)
        return (f"{self.graph.name}: {len(self.grouped.groups)} groups, "
                f"latency {self.latency_ms:.2f} ms, {self.gops:.0f} GOPS "
                f"(MAC eff {100 * self.mac_efficiency:.1f}%), "
                f"DRAM {self.dram.total * mb:.1f} MB "
                f"(fm {self.dram.fm_bytes * mb:.2f} MB, "
                f"-{100 * self.offchip_reduction:.1f}% vs baseline "
                f"{self.baseline_dram * mb:.1f} MB), "
                f"SRAM {self.sram.sram_total * mb:.3f} MB")


def apply_verification(plan: ExecutionPlan, mode: str,
                       site: str = "compile_graph") -> ExecutionPlan:
    """Run the static plan verifier (``repro_torch.analysis``) over a
    finished plan, per the ``verify`` mode: ``"off"`` is a no-op,
    ``"warn"`` records the diagnostics on ``plan.diagnostics`` and emits a
    ``UserWarning`` per error-severity finding, ``"strict"`` raises
    ``repro_torch.analysis.VerificationError`` on any error-severity
    diagnostic.  A pure post-check: the plan bytes are never changed."""
    if mode == "off":
        return plan
    # Imported lazily: analysis depends on core, not the reverse.
    from repro_torch.analysis import (VerificationError, errors_of,
                                      verify_execution_plan)
    plan.diagnostics = verify_execution_plan(plan)
    errors = errors_of(plan.diagnostics)
    if errors and mode == "strict":
        raise VerificationError(plan.graph.name, plan.diagnostics)
    for d in errors:
        warnings.warn(f"{site}({plan.graph.name}): {d.render()}",
                      stacklevel=3)
    return plan


def compile_graph(graph: Graph, hw: FPGAConfig = KCU1500,
                  options: CompileOptions | None = None,
                  *, policy: dict[int, str] | None = None,
                  guard=None, warm_start=None,
                  **legacy) -> ExecutionPlan:
    """Compile a CNN graph into an :class:`ExecutionPlan`.

    All search/scheduling knobs arrive as one
    :class:`repro_torch.core.options.CompileOptions` -- that class's docstring
    is the single knob reference (objective, exhaustive_limit, workers,
    batch_size, engine, backend, max_retries, task_deadline_s,
    resume_dir, prune, count_pruned, verify, device).  The legacy
    loose-keyword spelling (``compile_graph(g, hw, batch_size=64)``)
    still works through the deprecation shim and emits
    :class:`~repro_torch.core.options.LegacyKnobWarning`.  With no
    options at all the search runs on the GPU (``engine="pipeline"``,
    ``device="cuda"``) and raises on a host without one; pass
    ``CompileOptions(device="cpu")`` for the plain torch versions.

    ``workers=None`` or ``> 1`` and ``resume_dir`` run the search in the
    process pool (``core/search_pool.py``), whose workers launch the
    engine's kernels; the plan is bit-identical to ``workers=1``.

    Three arguments stay outside the options value because they are not
    reusable configuration: ``policy`` (gid -> "row"/"frame") skips the
    optimizer and compiles the given policy verbatim -- this is how the
    all-row baseline and ablation plans are built (feasibility is still
    computed honestly for the resulting Candidate); ``guard`` is a live
    :class:`~repro_torch.runtime.fault_tolerance.PreemptionGuard` the
    process pool polls to drain and journal on SIGTERM; ``warm_start`` is a cut tuple
    (typically from a plan cache) forwarded to
    :func:`repro_torch.core.cutpoint.search`, which prices it through the
    oracle and seeds the branch-and-bound incumbent -- exhaustive-path
    results stay bit-identical to a cold compile.
    """
    with span(COMPILE):
        opts = resolve_options(options, legacy, site="compile_graph")
        with span("compile.group"):
            graph.validate()
            gg = group_nodes(graph)
        result: SearchResult | None = None
        if policy is None:
            result = search(gg, hw, opts, guard=guard,
                            warm_start=warm_start)
            cand = result.best
            alloc = cand.alloc
        else:
            alloc = allocate(gg, policy)
        with span("compile.plan"):
            sram = sram_report(gg, alloc, hw)
            dram = dram_report(gg, alloc)
            latency = latency_report(gg, alloc, hw)
            if policy is not None:
                feasible = (sram.sram_total <= hw.sram_budget
                            and frame_feasible(gg, policy, alloc))
                cand = Candidate(
                    cuts=(), policy=policy, alloc=alloc,
                    latency_cycles=latency.cycles,
                    dram_total=dram.total, dram_fm=dram.fm_bytes,
                    sram_total=sram.sram_total, bram18k=sram.bram18k,
                    feasible=feasible)
            plan = ExecutionPlan(
                graph=graph, grouped=gg, hw=hw, candidate=cand, alloc=alloc,
                sram=sram, dram=dram, latency=latency,
                instructions=generate_instructions(gg, alloc),
                search=result)
        return apply_verification(plan, opts.verify)


def all_row_policy(gg: GroupedGraph) -> dict[int, str]:
    """Every group streams row-by-row: the paper's off-chip baseline
    (eq. 9) that the optimizer's DRAM reduction is measured against."""
    return {g.gid: "row" for g in gg.groups}


def all_frame_policy(gg: GroupedGraph) -> dict[int, str]:
    """Every group keeps whole feature maps on-chip: the minimum-traffic /
    maximum-SRAM corner, infeasible for large inputs but the anchor of the
    Fig. 16/17 trade-off sweeps."""
    return {g.gid: "frame" for g in gg.groups}
