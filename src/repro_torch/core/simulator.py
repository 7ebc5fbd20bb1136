"""Functional accelerator simulator.

The counterpart of the JAX package's ``repro/core/simulator.py``.  Executes
a compiled instruction stream against an explicit memory model: DRAM
(tensor store + byte counters) and the three physical on-chip buffers
{0,1,2} plus the SE side space.  Data movement follows the instruction
fields produced by the compiler; math is delegated to the same per-node ops
as the PyTorch reference (cnn/torch_ref.py), on the same device, so

  * equality -- bit for bit -- with cnn/torch_ref.run_graph validates the
    grouping, the static buffer allocation and the instruction encoding (a
    clobbered buffer corrupts the output), and
  * the DRAM byte counters validate the analytical model of core/dram.py.

``execute=False`` runs the memory model only (dry traffic count, no
tensors, no device) so full YOLO-scale networks can be audited in
milliseconds.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.allocator import Allocation, _is_side
from repro_torch.core.grouping import GroupedGraph
from repro_torch.core.isa import OFFCHIP, GroupInstruction


@dataclass
class MemCounters:
    dram_reads: int = 0
    dram_writes: int = 0
    weight_reads: int = 0
    onchip_hits: int = 0
    # counted DRAM reads of a tensor nothing ever wrote to DRAM -- always 0
    # for a healthy plan; nonzero means the stream reads garbage (the
    # dynamic twin of the static verifier's SF021/SF022/SF041)
    dangling_reads: int = 0

    @property
    def fm_total(self) -> int:
        return self.dram_reads + self.dram_writes

    @property
    def total(self) -> int:
        return self.fm_total + self.weight_reads


@dataclass
class SimState:
    # gid -> tensor (None in dry mode)
    dram: dict[int, object] = field(default_factory=dict)
    buffers: dict[int, tuple[int, object]] = field(default_factory=dict)
    side: dict[int, object] = field(default_factory=dict)
    node_side: dict[int, object] = field(default_factory=dict)
    counters: MemCounters = field(default_factory=MemCounters)


class Simulator:
    def __init__(self, gg: GroupedGraph, alloc: Allocation,
                 instructions: list[GroupInstruction],
                 params: dict | None = None,
                 execute: bool = True, device="cuda"):
        self.gg = gg
        self.alloc = alloc
        self.instructions = {i.gid: i for i in instructions}
        self.device = device
        self.execute = execute
        self.params = params or {}
        if execute:
            from repro_torch.cnn.torch_ref import load_params
            self.params = load_params(self.params, device)
        self.state = SimState()

    # ------------------------------------------------------------ plumbing
    def _tensor_bytes(self, gid: int) -> int:
        if gid == -1:
            return self.gg.graph.nodes[0].out_size
        return self.gg.groups[gid].out_size

    def _fetch(self, src_gid: int, frame_mode: bool, count: bool = True):
        """Fetch an operand tensor, updating counters per its location.

        Row-mode consumers always stream from DRAM, even if a stale copy
        sits in a buffer (the hardware's row pipeline has no random access
        into the frame buffers)."""
        st = self.state
        if src_gid in st.side:
            return st.side[src_gid]
        if frame_mode:
            for _b, (owner, tensor) in st.buffers.items():
                if owner == src_gid:
                    st.counters.onchip_hits += self._tensor_bytes(src_gid)
                    return tensor
        # DRAM read (row streaming, boundary, spill or network input).
        if count:
            st.counters.dram_reads += self._tensor_bytes(src_gid)
            if src_gid not in st.dram:
                st.counters.dangling_reads += 1
        return st.dram.get(src_gid)

    def _store(self, gid: int, tensor, instr: GroupInstruction) -> None:
        st = self.state
        g = self.gg.groups[gid]
        is_frame = instr.mode == 1
        if _is_side(self.gg, g):
            st.side[gid] = tensor
            return
        if not is_frame:
            if g.kind not in ("concat", "route"):   # redirect writes nothing
                st.counters.dram_writes += g.out_size
            st.dram[gid] = tensor
            return
        spilled = gid in self.alloc.spilled
        boundary = gid in self.alloc.boundary_writes
        if instr.alloc_out != OFFCHIP and not spilled:
            # evict previous owner of the physical buffer
            st.buffers[instr.alloc_out] = (gid, tensor)
        if spilled or boundary:
            st.counters.dram_writes += g.out_size
            st.dram[gid] = tensor

    # ------------------------------------------------------------- running
    def run(self, x=None):
        st = self.state
        if self.execute:
            assert x is not None
            from repro_torch.cnn.torch_ref import as_input
            st.dram[-1] = as_input(x, self.device)
        else:
            # Dry mode tracks locations only, but the network input is
            # still DRAM-resident -- seed it so the dangling-read counter
            # never misfires on the first fetch.
            st.dram[-1] = None

        final = None
        for g in self.gg.groups:
            instr = self.instructions[g.gid]
            # ---- weights: streamed from DRAM exactly once (constraint 10)
            st.counters.weight_reads += g.weight_size
            # ---- gather operands
            gin = self.gg.group_inputs(g)
            frame = instr.mode == 1
            # Redirected feature-merging (row concat/route) and the SE side
            # path move no DRAM data (see dram.py).
            count = not (_is_side(self.gg, g)
                         or (not frame and g.kind in ("concat", "route")))
            operands = ([self._fetch(s, frame, count) for s in gin]
                        if gin else [self._fetch(-1, frame, count)])
            # ---- compute
            out = None
            if self.execute:
                out = self._execute_group(g, gin, operands)
            self._store(g.gid, out, instr)
            final = out if self.execute else None
        return final

    def _execute_group(self, g, gin, operands):
        from repro_torch.cnn.torch_ref import apply_node

        # Map producer gid -> tensor for resolving node-level inputs.
        env: dict[int, object] = {}
        src_map = dict(zip(gin, operands)) if gin else {-1: operands[0]}

        def node_operand(i: int):
            if i in env:
                return env[i]
            owner = self.gg.node_group[i]
            if owner == g.gid:
                return env[i]
            og = self.gg.groups[owner] if owner >= 0 else None
            if og is not None and og.tail.idx != i:
                # Side product of a dual-output group (SE pooled copy):
                # delivered through the on-chip side space, never DRAM.
                return self.state.node_side[i]
            return src_map[owner]

        out = None
        for n in g.nodes:
            ops = [node_operand(i) for i in n.inputs] or [src_map[-1]]
            out = apply_node(n, ops, self.params)
            env[n.idx] = out
            if g.side_tail is not None and n.idx == g.side_tail.idx:
                self.state.node_side[n.idx] = out
        # The group's main output is its tail node, not necessarily the
        # last node executed (dual-output groups).
        return env[g.tail.idx]


def simulate(gg: GroupedGraph, alloc: Allocation,
             instructions: list[GroupInstruction],
             params: dict | None = None, x=None,
             execute: bool = True,
             device="cuda") -> tuple[object, MemCounters]:
    """Run the stream; returns ``(output, counters)``.  In execute mode the
    tensors live on ``device`` (``params`` as ``init_params`` or
    ``load_params`` gives them, ``x`` numpy or a tensor); dry mode touches
    no device and returns ``None`` as the output."""
    sim = Simulator(gg, alloc, instructions, params, execute, device)
    out = sim.run(x)
    return out, sim.state.counters
