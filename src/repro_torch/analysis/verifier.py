"""Static plan verifier: prove an ExecutionPlan safe without executing it.

The paper's whole design rests on the *static* buffer allocation
``{alloc_in, alloc_out, alloc_shortcut}`` (Fig. 5b / Algorithm 1) never
clobbering live shortcut data and never exceeding the on-chip budgets.
``verify_plan`` checks that in O(plan) -- no tensors, no simulation -- by
running an *abstract location machine* over the instruction stream: the
functional simulator's dry-mode traversal with every tensor replaced by
its location (buffer id / side space / DRAM) and every transition checked
for legality.  Five check families (codes in ``diagnostics.CODES``):

1. **Dataflow** (SF01x) -- def-before-use and single-producer over the
   decoded ``src_main``/``src_shortcut`` fields; stream shape/order.
2. **Liveness** (SF02x) -- per-buffer live intervals derived from the
   allocator journal (``liveness.journal_trace``); a write to
   ``alloc_out`` must never evict a tensor another consumer will still
   read (the shortcut-clobber class Algorithm 1 exists to prevent), and
   the stream's assignments must land inside the journal's intervals.
3. **Capacity** (SF03x) -- static occupancy of each physical buffer from
   the stream's own claims, the eq. (5) write-buffer bound and the
   eq. (6)/(7) SRAM/BRAM totals vs the ``FPGAConfig`` budgets.
4. **DRAM conservation** (SF04x) -- every off-chip tensor written once
   and read once per consumer, weights fetched exactly once; the
   machine's byte count must equal the analytic model (eqs. (8)/(9)),
   which is the same invariant the dynamic simulator audits -- so any
   traffic divergence the simulator could observe is caught statically.
5. **ISA well-formedness** (SF05x) -- bit-field ranges against the
   11-word encoding (``isa.FIELD_WIDTHS``), opcode/mode/activation
   validity, row-mode and eltwise/shortcut fusion legality, geometry
   agreement with the grouped graph.

The dynamic ``Simulator`` stays the oracle of record for *numerics*; the
verifier is the O(plan) referee every backend-independent consumer (the
compile service, device replays, mutated streams) can run before trusting
a plan.  ``analysis.mutate`` proves the coverage: every class of injected
violation must raise at least one diagnostic, and every mutant the
simulator can detect dynamically must be caught here statically.
"""
from __future__ import annotations

from repro_torch.analysis.diagnostics import Diagnostic, Severity, make
from repro_torch.analysis.liveness import JournalTrace, journal_trace
from repro_torch.core.allocator import Allocation, _is_side
from repro_torch.core.dram import dram_fm
from repro_torch.core.grouping import GroupedGraph
from repro_torch.core.hw import FPGAConfig
from repro_torch.core.isa import (ACTS, FIELD_WIDTHS, MODES, OFFCHIP,
                                  OPCODES, GroupInstruction, field_overflows)
from repro_torch.core.sram import _bram18k_total, sram_report

# instruction word each field is packed into (diagnostic anchors)
_FIELD_WORD = {
    "opcode": 0, "mode": 0, "act": 0, "k": 0, "stride": 0,
    "in_ch": 1, "out_ch": 2, "in_h": 3, "in_w": 4,
    "fused_pool": 5, "fused_eltwise": 5, "fused_upsample": 5,
    "alloc_in": 6, "alloc_out": 6, "alloc_shortcut": 6,
    "src_main": 7, "src_shortcut": 8, "gid": 9,
}
_BUFFER_IDS = (0, 1, 2, OFFCHIP)
_OPCODE_SET = set(OPCODES.values())
_ACT_SET = set(ACTS.values())


def _instr_context(i: GroupInstruction) -> str:
    return (f"op={i.opcode} mode={i.mode} k={i.k} s={i.stride} "
            f"alloc=({i.alloc_in},{i.alloc_out},{i.alloc_shortcut}) "
            f"src=({i.src_main},{i.src_shortcut})")


# ------------------------------------------------------------ SF01x / SF05x
def _check_stream_shape(gg: GroupedGraph,
                        instructions: list[GroupInstruction],
                        diags: list[Diagnostic]) -> dict[int, GroupInstruction]:
    n = len(gg.groups)
    by_gid: dict[int, GroupInstruction] = {}
    prev = -1
    for pos, ins in enumerate(instructions):
        if ins.gid in by_gid:
            diags.append(make("SF012", f"gid {ins.gid} encoded twice "
                              f"(stream positions {pos} and earlier)",
                              gid=ins.gid, word=9))
            continue
        if ins.gid <= prev:
            diags.append(make(
                "SF013", f"stream position {pos} carries gid {ins.gid} "
                f"after gid {prev} (instructions must be dense ascending)",
                gid=ins.gid, word=9))
        prev = max(prev, ins.gid)
        by_gid[ins.gid] = ins
    for g in gg.groups:
        if g.gid not in by_gid:
            diags.append(make("SF014", f"group {g.gid} ({g!r}) has no "
                              f"instruction", gid=g.gid))
    for gid in by_gid:
        if not 0 <= gid < n:
            diags.append(make("SF011", f"instruction gid {gid} does not "
                              f"name a graph group (0..{n - 1})",
                              gid=gid, word=9))
    return by_gid


def _check_wellformed(gg: GroupedGraph, alloc: Allocation,
                      by_gid: dict[int, GroupInstruction],
                      diags: list[Diagnostic]) -> None:
    n = len(gg.groups)
    for gid, ins in sorted(by_gid.items()):
        if not 0 <= gid < n:
            continue
        g = gg.groups[gid]
        ctx = _instr_context(ins)
        # ---- bit-field ranges (SF050): the decoded form must round-trip
        # through the 11-word encoding without truncation.
        for name in FIELD_WIDTHS:
            v = getattr(ins, name)
            if field_overflows(name, v):
                diags.append(make(
                    "SF050", f"{name}={v} does not fit its "
                    f"{FIELD_WIDTHS[name]}-bit slot",
                    gid=gid, word=_FIELD_WORD[name], context=ctx))
        for name in ("src_main", "src_shortcut"):
            if field_overflows(name, getattr(ins, name)):
                diags.append(make(
                    "SF050", f"{name}={getattr(ins, name)} does not fit "
                    f"its signed 32-bit slot",
                    gid=gid, word=_FIELD_WORD[name], context=ctx))
        # ---- enum validity (SF051)
        if ins.opcode not in _OPCODE_SET:
            diags.append(make("SF051", f"opcode {ins.opcode} unknown",
                              gid=gid, word=0, context=ctx))
        if ins.mode not in (0, 1):
            diags.append(make("SF051", f"mode {ins.mode} unknown "
                              f"(0=row, 1=frame)", gid=gid, word=0,
                              context=ctx))
        if ins.act not in _ACT_SET:
            diags.append(make("SF051", f"act {ins.act} unknown",
                              gid=gid, word=0, context=ctx))
        if ins.fused_pool not in (0, 1, 2) or ins.fused_eltwise not in (0, 1):
            diags.append(make(
                "SF054", f"fused_pool={ins.fused_pool} / "
                f"fused_eltwise={ins.fused_eltwise} outside the legal "
                f"fusion codes", gid=gid, word=5, context=ctx))
        # ---- alloc fields (SF052 / SF053)
        for name in ("alloc_in", "alloc_out", "alloc_shortcut"):
            v = getattr(ins, name)
            if v not in _BUFFER_IDS:
                diags.append(make(
                    "SF052", f"{name}={v} is neither a physical buffer "
                    f"{{0,1,2}} nor OFFCHIP({OFFCHIP})",
                    gid=gid, word=6, context=ctx))
        if ins.mode == 0:
            onchip = [name for name in ("alloc_in", "alloc_out",
                                        "alloc_shortcut")
                      if getattr(ins, name) != OFFCHIP]
            if onchip:
                diags.append(make(
                    "SF053", f"row-mode group assigns {', '.join(onchip)} "
                    f"on-chip; the row pipeline streams through DRAM",
                    gid=gid, word=6, context=ctx))
        # ---- dataflow srcs (SF010 / SF011 / SF015 / SF016)
        for name in ("src_main", "src_shortcut"):
            src = getattr(ins, name)
            if src >= gid:
                diags.append(make(
                    "SF010", f"{name}={src} is not produced before "
                    f"group {gid}", gid=gid, word=_FIELD_WORD[name],
                    context=ctx))
            elif src < -1 or src >= n:
                diags.append(make(
                    "SF011", f"{name}={src} names no producer",
                    gid=gid, word=_FIELD_WORD[name], context=ctx))
        gin = gg.group_inputs(g)
        want_main = gin[0] if gin else -1
        if ins.src_main != want_main:
            diags.append(make(
                "SF015", f"src_main={ins.src_main} but the grouped graph "
                f"feeds group {gid} from {want_main}",
                gid=gid, word=7, context=ctx))
        sc = gg.shortcut_source_group(g)
        want_sc = sc if sc is not None else -1
        if ins.src_shortcut != want_sc:
            diags.append(make(
                "SF016", f"src_shortcut={ins.src_shortcut} but the "
                f"grouped graph's shortcut source is {want_sc}",
                gid=gid, word=8, context=ctx))
        # ---- fusion legality (SF054)
        has_add = g.fused_add is not None
        if bool(ins.fused_eltwise) != has_add:
            diags.append(make(
                "SF054", f"fused_eltwise={ins.fused_eltwise} but the "
                f"group {'has' if has_add else 'has no'} eltwise add",
                gid=gid, word=5, context=ctx))
        if not ins.fused_eltwise and ins.src_shortcut != -1:
            diags.append(make(
                "SF054", f"src_shortcut={ins.src_shortcut} forged on a "
                f"group with no eltwise operand", gid=gid, word=8,
                context=ctx))
        if (ins.fused_eltwise and ins.src_shortcut != -1
                and ins.src_shortcut == ins.src_main):
            diags.append(make(
                "SF054", "eltwise operands collapse: src_shortcut == "
                "src_main (row-mode add reads two distinct operands)",
                gid=gid, word=8, context=ctx))
        # ---- geometry / mode agreement with the graph (SF055)
        head, tail = g.head, g.tail
        expect = {
            "opcode": OPCODES[head.kind], "k": head.k,
            "stride": head.stride, "in_ch": head.in_ch,
            "out_ch": tail.out_ch, "in_h": head.in_h, "in_w": head.in_w,
        }
        for name, want in expect.items():
            got = getattr(ins, name)
            if got != want:
                diags.append(make(
                    "SF055", f"{name}={got} disagrees with the graph "
                    f"({name}={want} for {g!r})",
                    gid=gid, word=_FIELD_WORD[name], context=ctx))
        mode = alloc.policy.get(gid)
        if mode is not None and ins.mode in (0, 1) \
                and ins.mode != MODES[mode]:
            diags.append(make(
                "SF055", f"mode={ins.mode} disagrees with the "
                f"allocation's policy ({mode!r})", gid=gid, word=0,
                context=ctx))


# ----------------------------------------------------- SF02x / SF03x / SF04x
def _abstract_machine(gg: GroupedGraph, alloc: Allocation,
                      by_gid: dict[int, GroupInstruction], hw: FPGAConfig,
                      trace: JournalTrace | None,
                      diags: list[Diagnostic],
                      capacity_severity: Severity) -> None:
    """Dry simulator traversal over *locations*: every fetch must find its
    operand somewhere legal, every store must not destroy live data, and
    the resulting byte counts must reproduce the analytic DRAM model."""
    groups = gg.groups
    n = len(groups)
    remaining = [len(gg.group_consumers(g)) for g in groups]
    remaining.append(1)                        # graph input (index -1)
    buffers: dict[int, int] = {}               # buffer id -> owner gid
    dram: set[int] = {-1}                      # gids materialized off-chip
    side: set[int] = set()
    reads_of: dict[int, int] = {}              # DRAM fetch count per gid
    dram_reads = dram_writes = weight_reads = 0
    occ = [0, 0, 0]                            # observed buffer occupancy
    side_occ = 0
    input_size = gg.graph.nodes[0].out_size

    def nbytes(src: int) -> int:
        return input_size if src == -1 else groups[src].out_size

    for g in groups:
        ins = by_gid.get(g.gid)
        if ins is None:
            continue                           # SF014 already reported
        gid = g.gid
        weight_reads += g.weight_size
        gin = gg.group_inputs(g) or [-1]
        frame = ins.mode == 1
        is_side_g = _is_side(gg, g)
        counted = not (is_side_g
                       or (not frame and g.kind in ("concat", "route")))
        main_src = gin[0]
        sc = gg.shortcut_source_group(g)
        for src in gin:
            loc_buf = None
            if src not in side:
                if frame:
                    for b, owner in buffers.items():
                        if owner == src:
                            loc_buf = b
                            break
                if loc_buf is None:
                    # DRAM fetch (row streaming, boundary, spill, input)
                    reads_of[src] = reads_of.get(src, 0) + 1
                    if counted:
                        dram_reads += nbytes(src)
                    if src not in dram and counted:
                        if frame:
                            diags.append(make(
                                "SF021", f"group {gid} reads operand "
                                f"g{src} from no buffer and DRAM never "
                                f"received it (clobbered or never "
                                f"materialized)", gid=gid, word=7,
                                context=repr(g)))
                        else:
                            prod = by_gid.get(src)
                            code = ("SF022" if prod is not None
                                    and prod.mode == 1 else "SF041")
                            diags.append(make(
                                code, f"row-mode group {gid} streams "
                                f"operand g{src} from DRAM but its "
                                f"producer never wrote it out",
                                gid=gid, word=7, context=repr(g)))
            if frame and loc_buf is not None and src == main_src \
                    and ins.alloc_in != OFFCHIP and ins.alloc_in != loc_buf:
                diags.append(make(
                    "SF025", f"alloc_in={ins.alloc_in} but the main "
                    f"operand g{src} lives in buffer {loc_buf}",
                    gid=gid, word=6, context=_instr_context(ins)))
            if frame and loc_buf is not None and sc == src \
                    and ins.alloc_shortcut != OFFCHIP \
                    and ins.alloc_shortcut != loc_buf:
                diags.append(make(
                    "SF025", f"alloc_shortcut={ins.alloc_shortcut} but "
                    f"the shortcut operand g{src} lives in buffer "
                    f"{loc_buf}", gid=gid, word=6,
                    context=_instr_context(ins)))
            remaining[src] -= 1
        # DRAM-fetched main input claims alloc_in transiently (Alg. 1):
        # it occupies the buffer while the group reads it.
        if frame and not is_side_g and ins.alloc_in != OFFCHIP \
                and not any(o == main_src for o in buffers.values()):
            if ins.alloc_in < 3:
                if g.in_size > occ[ins.alloc_in]:
                    occ[ins.alloc_in] = g.in_size
                if ins.alloc_out == ins.alloc_in:
                    diags.append(make(
                        "SF025", f"alloc_out={ins.alloc_out} overwrites "
                        f"the buffer the DRAM-fetched input is being "
                        f"read from", gid=gid, word=6,
                        context=_instr_context(ins)))

        # ---------------------------------------------------------- store
        if is_side_g:
            side.add(gid)
            if g.out_size > side_occ:
                side_occ = g.out_size
            continue
        if not frame:
            if g.kind not in ("concat", "route"):
                if gid in dram:
                    diags.append(make(
                        "SF040", f"group {gid} writes its output to DRAM "
                        f"twice", gid=gid, context=repr(g)))
                dram_writes += g.out_size
            dram.add(gid)
            continue
        spilled = gid in alloc.spilled
        boundary = gid in alloc.boundary_writes
        if ins.alloc_out != OFFCHIP and not spilled and ins.alloc_out < 3:
            prev = buffers.get(ins.alloc_out)
            if prev is not None and prev != gid and remaining[prev] > 0 \
                    and prev not in dram:
                iv = trace.owner_at(ins.alloc_out, gid) if trace else None
                diags.append(make(
                    "SF020", f"group {gid} writes buffer "
                    f"{ins.alloc_out} and destroys g{prev}, which "
                    f"{remaining[prev]} consumer(s) still read and DRAM "
                    f"does not hold", gid=gid, word=6,
                    context=(iv.render() if iv is not None
                             else _instr_context(ins))))
            buffers[ins.alloc_out] = gid
            if g.out_size > occ[ins.alloc_out]:
                occ[ins.alloc_out] = g.out_size
        if spilled or boundary:
            if gid in dram:
                diags.append(make(
                    "SF040", f"group {gid} writes its output to DRAM "
                    f"twice", gid=gid, context=repr(g)))
            dram_writes += g.out_size
            dram.add(gid)
        elif ins.alloc_out == OFFCHIP and remaining[gid] > 0:
            diags.append(make(
                "SF023", f"frame-mode group {gid} produces a tensor with "
                f"{remaining[gid]} consumer(s) but assigns no buffer, is "
                f"not spilled and is not a boundary write -- the data is "
                f"lost", gid=gid, word=6, context=repr(g)))

    # ------------------------------------------------- DRAM conservation
    for gid in sorted(alloc.spilled):
        if reads_of.get(gid, 0) == 0 and 0 <= gid < n:
            diags.append(make(
                "SF043", f"group {gid}'s output is spilled to DRAM but "
                f"no consumer ever reads it back", gid=gid,
                context=repr(groups[gid])))
    model_fm = dram_fm(gg, alloc)
    machine_fm = dram_reads + dram_writes
    if machine_fm != model_fm:
        diags.append(make(
            "SF042", f"stream moves {machine_fm} feature-map bytes "
            f"(r={dram_reads} w={dram_writes}) but the analytic model "
            f"(eq. 8) accounts {model_fm} (drift "
            f"{machine_fm - model_fm:+d})"))
    model_w = sum(g.weight_size for g in groups)
    if weight_reads != model_w:
        diags.append(make(
            "SF042", f"stream fetches {weight_reads} weight bytes but "
            f"constraint (10) requires exactly {model_w} (each layer's "
            f"weights once)"))

    # ------------------------------------------------------- capacity
    declared = list(alloc.buff) + [alloc.side_buff]
    observed = occ + [side_occ]
    names = ["buffer 0", "buffer 1", "buffer 2", "side space"]
    for name, d, o in zip(names, declared, observed):
        if o > d:
            diags.append(make(
                "SF032", f"{name} holds {o} bytes but the allocation "
                f"declares only {d}", severity=capacity_severity))
    sram = sram_report(gg, alloc, hw)
    buff = [max(d, o) for d, o in zip(sram.buff, occ)]
    side_b = max(alloc.side_buff, side_occ)
    total = (sram.row_buff + sram.out_buff + sram.write_buff
             + sum(buff) + side_b)
    if total > hw.sram_budget:
        diags.append(make(
            "SF030", f"SRAM total {total} bytes exceeds the "
            f"{hw.sram_budget}-byte budget (row={sram.row_buff} "
            f"out={sram.out_buff} wr={sram.write_buff} buff={buff} "
            f"side={side_b})", severity=capacity_severity))
    bram = _bram18k_total(sram.row_buff, sram.out_buff, sram.write_buff,
                          buff, side_b, hw)
    if bram > hw.bram18k_total:
        # Advisory only: the optimizer's feasibility contract is byte-level
        # SRAM + frame feasibility; bram18k is reported, not constrained.
        diags.append(make(
            "SF031", f"BRAM18K count {bram} exceeds the "
            f"{hw.bram18k_total} available"))


# ------------------------------------------------------------------ SF024
def _check_journal(gg: GroupedGraph, alloc: Allocation,
                   by_gid: dict[int, GroupInstruction],
                   trace: JournalTrace,
                   diags: list[Diagnostic]) -> None:
    """The plan's allocation record and the stream's buffer assignments
    must both match a fresh journal replay of Algorithm 1 under the
    plan's own policy -- the replay is deterministic, so any divergence
    means the record or the stream was corrupted after allocation."""
    truth = trace.alloc
    for label, got, want in (
            ("alloc_in", alloc.alloc_in, truth.alloc_in),
            ("alloc_out", alloc.alloc_out, truth.alloc_out),
            ("alloc_shortcut", alloc.alloc_shortcut, truth.alloc_shortcut)):
        for gid in sorted(set(got) | set(want)):
            a, b = got.get(gid), want.get(gid)
            if a != b:
                iv = (trace.owner_at(b, gid)
                      if isinstance(b, int) else None)
                diags.append(make(
                    "SF024", f"{label}[{gid}]={a} but the journal replay "
                    f"assigns {b}", gid=gid, word=6,
                    context=(iv.render() if iv is not None else "")))
    for label, got, want in (
            ("spilled", alloc.spilled, truth.spilled),
            ("boundary_writes", alloc.boundary_writes,
             truth.boundary_writes)):
        for gid in sorted(got ^ want):
            diags.append(make(
                "SF024", f"{label} {'records' if gid in got else 'drops'} "
                f"g{gid}, the journal replay "
                f"{'does not' if gid in got else 'does'}", gid=gid))
    if alloc.boundary_reads != truth.boundary_reads:
        delta = {k: (alloc.boundary_reads.get(k), truth.boundary_reads.get(k))
                 for k in set(alloc.boundary_reads) | set(truth.boundary_reads)
                 if alloc.boundary_reads.get(k) != truth.boundary_reads.get(k)}
        diags.append(make(
            "SF024", f"boundary_reads diverge from the journal replay: "
            f"{delta}"))
    for gid, ins in sorted(by_gid.items()):
        if not 0 <= gid < len(gg.groups):
            continue
        for label, attr in (("alloc_in", truth.alloc_in),
                            ("alloc_out", truth.alloc_out),
                            ("alloc_shortcut", truth.alloc_shortcut)):
            want = attr.get(gid, OFFCHIP)
            got = getattr(ins, label)
            if got != want:
                iv = trace.owner_at(want, gid) if want != OFFCHIP else None
                diags.append(make(
                    "SF024", f"instruction {label}={got} but the journal "
                    f"replay assigns {want}", gid=gid, word=6,
                    context=(iv.render() if iv is not None
                             else _instr_context(ins))))


# ------------------------------------------------------------------- entry
def verify_plan(gg: GroupedGraph, alloc: Allocation,
                instructions: list[GroupInstruction], hw: FPGAConfig,
                feasible: bool | None = None,
                with_journal: bool = True) -> list[Diagnostic]:
    """Statically verify one compiled plan; returns all diagnostics.

    ``feasible`` is the plan's own feasibility claim: when the optimizer
    already reports the plan infeasible (no feasible point exists),
    capacity overruns are expected and downgraded to warnings; a plan
    claiming feasibility gets them at error severity.  ``with_journal``
    gates the SF024 journal-replay cross-check (one extra O(groups)
    allocator replay)."""
    diags: list[Diagnostic] = []
    by_gid = _check_stream_shape(gg, instructions, diags)
    _check_wellformed(gg, alloc, by_gid, diags)
    trace: JournalTrace | None = None
    if with_journal and all(g.gid in alloc.policy for g in gg.groups):
        trace = journal_trace(gg, alloc.policy)
        _check_journal(gg, alloc, by_gid, trace, diags)
    capacity_severity = (Severity.WARNING if feasible is False
                         else Severity.ERROR)
    _abstract_machine(gg, alloc, by_gid, hw, trace, diags,
                      capacity_severity)
    return diags


def verify_execution_plan(plan) -> list[Diagnostic]:
    """``verify_plan`` over a ``compiler.ExecutionPlan``."""
    return verify_plan(plan.grouped, plan.alloc, plan.instructions,
                       plan.hw, feasible=plan.candidate.feasible)


def errors_of(diags: list[Diagnostic]) -> list[Diagnostic]:
    return [d for d in diags if d.severity is Severity.ERROR]
