"""Residual-stream residency planner: ShortcutFusion for LM stacks.

The JAX package's planner carried over unchanged: pure numpy, launching
nothing, planning for the TPU v5e description (``core/hw.py::V5E``) by
default, so that the same call gives the same plan, bit for bit, in both
packages (``tests/test_torch_residency.py``).

A transformer layer is a residual block; the residual stream is the paper's
"shortcut data".  This module re-applies the paper's machinery on the
HBM -> VMEM hierarchy of a TPU:

  frame-reuse  -> RESIDENT mode: the block runs as a fused kernel
                  (kernels/fused_block.py); the shortcut tile is pinned in
                  VMEM across norm->matmul->act->matmul->add; weights are
                  streamed HBM->VMEM exactly once; intermediate activations
                  never touch HBM.
  row-reuse    -> STREAMING mode: op-by-op XLA execution; every operator's
                  inputs/outputs round-trip HBM exactly once (the paper's
                  constraint (10) analogue -- XLA fusion is modelled by
                  counting each *fusion group* boundary, i.e. act_bytes).

Mode boundaries move the residual stream between hierarchies: a resident
segment reads the stream once on entry and writes it once on exit.  Both
transfers are sized by the stream tensor *crossing* the boundary -- the
predecessor block's output (for the stack entry, the stack's input, which
has the first block's stream size since in == out per block).  On
heterogeneous stacks (vision/cross blocks with different ``stream_bytes``)
charging anything else mis-prices every boundary.

Two planners are provided:

  * plan_cutpoint -- paper-faithful: one cut per monotone run of per-block
    working-set size (for homogeneous LM stacks: a single cut L; blocks
    >= L resident).  Exhaustive sweep of the cut as in §IV-B.
  * plan_dp       -- beyond-paper: exact dynamic program over per-block
    modes with segment-boundary costs; a strict generalization that can
    interleave modes (useful for MoE stacks whose expert blocks never fit).

Both respect the hard VMEM budget, mirroring the SRAM constraint (*).

Engine architecture
-------------------

``_evaluate`` is the *oracle*: a from-scratch per-block walk pricing one
mode vector.  The planners instead drive :class:`ResidencyEngine`, which
must agree with the oracle bit-for-bit on every metric and is built from
three pieces (mirroring ``core/cutpoint.py``'s search engine):

* **Cost tables** -- per-block static quantities (both modes' hbm bytes and
  roofline seconds under each of the four prev-mode/mode boundary cases,
  ``resident_vmem``, VMEM-fit mask) are tabulated into numpy arrays once
  per stack (:class:`CostTables`).  Elementwise IEEE float64 ops reproduce
  ``_block_cost`` exactly.
* **Checkpointed sweep** -- ``_evaluate``'s running sums are checkpointed
  at every cut position: prefix sums over the all-streaming costs, suffix
  sums over the fits-determined resident-suffix costs, and a suffix
  running max over resident VMEM.  A candidate cut is then priced by the
  checkpoint pair plus the single boundary delta at the cut, so
  ``plan_cutpoint`` sweeps all N+1 cuts in O(N) total.  Byte sums are
  exact integers; second sums use Shewchuk exact partials so any
  prefix/suffix split reproduces the oracle's ``math.fsum`` bit-for-bit.
* **Vectorized DP** -- ``plan_dp``'s transition step reads the
  pre-tabulated 2x2 boundary-cost tables instead of calling
  ``_block_cost``, and reconstructs the winning path through parent
  pointers instead of copying mode lists per state (the seed's O(N^2)
  path growth).

Oracle contract: ``ResidencyEngine.evaluate_cut(c)`` returns the same
``est_seconds`` / ``hbm_bytes`` / ``vmem_peak`` as ``_evaluate`` on that
cut's mode vector for *every* cut, and ``dp_modes`` picks the same modes
as the transition-by-transition reference DP; both planners materialize
their winner through the oracle, so the returned plan is byte-identical
to a direct O(N^2) search (tests/test_residency_engine.py enforces this
on fuzzed heterogeneous stacks and the LM benchmark archs).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.hw import TPUConfig, V5E


@dataclass(frozen=True)
class LMBlockSpec:
    """Per-layer(-shard) costs, all bytes/flops PER DEVICE per step."""
    idx: int
    kind: str                 # attn | mlp | moe | ssm | rglru | cross | embed
    weight_bytes: int         # parameter bytes this device streams
    stream_bytes: int         # residual-stream tensor bytes (in == out)
    act_bytes: int            # extra HBM traffic in streaming mode
    flops: int                # FLOPs this device executes
    state_bytes: int = 0      # KV-cache / recurrent state traffic (HBM
    #                           resident in either mode)
    vmem_resident: int = 0    # VMEM needed to run resident (3 stream tiles
    #                           + weight slabs + scratch); 0 = derive

    def resident_vmem(self, hw: TPUConfig) -> int:
        if self.vmem_resident:
            return self.vmem_resident
        # 3-slot allocation (Algorithm 1): x-tile, y-tile, norm scratch.
        # Tiles are (tile_m x d); we budget 3 tiles of the stream plus a
        # double-buffered weight slab of 2 * (d x lane) columns + fp32 accum.
        tile = min(self.stream_bytes, 4 << 20)
        slab = 2 * max(1, self.weight_bytes // 64)
        slab = min(slab, 32 << 20)
        return 3 * tile + slab + (4 << 20)


@dataclass
class ResidencyPlan:
    modes: list[str]                       # 'resident' | 'streaming'
    hbm_bytes: int
    vmem_peak: int
    est_seconds: float
    cut: int | None = None                 # for the cut-point planner
    per_block: list[dict] = field(default_factory=list)

    @property
    def n_resident(self) -> int:
        return sum(m == "resident" for m in self.modes)  # det: bool count

    def summary(self) -> str:
        gb = 1 / (1 << 30)
        return (f"{self.n_resident}/{len(self.modes)} blocks resident, "
                f"HBM {self.hbm_bytes * gb:.3f} GB/step/device, "
                f"VMEM peak {self.vmem_peak / (1 << 20):.1f} MB, "
                f"est {1e3 * self.est_seconds:.3f} ms/step")


# ------------------------------------------------------------------- oracle
def _block_cost(b: LMBlockSpec, mode: str, hw: TPUConfig,
                boundary_bytes: int = 0) -> tuple[int, float]:
    """(hbm_bytes, seconds) for one block in one mode.  Segment-boundary
    stream movement folds under the roofline max (it overlaps compute,
    like every other HBM transfer).  The returned time carries an
    infinitesimal traffic tie-break so compute-bound blocks still prefer
    the lower-HBM mode (the paper's DRAM-access constraint under equal
    latency)."""
    if mode == "resident":
        hbm = b.weight_bytes + b.state_bytes
    else:
        hbm = b.weight_bytes + b.state_bytes + b.act_bytes + 2 * b.stream_bytes
    hbm += boundary_bytes
    t = max(b.flops / hw.peak_flops, hbm / hw.hbm_bw)
    return hbm, t


def _entry_stream(blocks: list[LMBlockSpec], i: int) -> int:
    """Bytes of the residual stream crossing the boundary *into* block i:
    the predecessor's output (for block 0, the stack input, which has the
    first block's stream size since in == out per block)."""
    return blocks[i - 1].stream_bytes if i else blocks[0].stream_bytes


def _evaluate(blocks: list[LMBlockSpec], modes: list[str],
              hw: TPUConfig) -> ResidencyPlan:
    """Oracle: price one mode vector block by block.

    ``est_seconds`` is the correctly-rounded (``math.fsum``) sum of the
    per-block times, so it is independent of summation order -- which lets
    :class:`ResidencyEngine` reproduce it bit-for-bit from prefix/suffix
    checkpoints.
    """
    hbm = 0
    ts: list[float] = []
    vmem_peak = 0
    per_block = []
    prev = "streaming"
    for i, (b, m) in enumerate(zip(blocks, modes)):
        # Boundary stream movement is charged to the block where the mode
        # changes and sized by the stream crossing the boundary -- the
        # *predecessor's* output (resident entry reads it; a streaming
        # successor of a resident segment pays that segment's exit write).
        boundary = _entry_stream(blocks, i) if m != prev else 0
        bb, bt = _block_cost(b, m, hw, boundary)
        if m == "resident":
            vmem_peak = max(vmem_peak, b.resident_vmem(hw))
        hbm += bb
        ts.append(bt)
        per_block.append({"idx": b.idx, "kind": b.kind, "mode": m,
                          "hbm": bb, "sec": bt})
        prev = m
    if prev == "resident":      # trailing segment exit: last block's output
        xb = blocks[-1].stream_bytes
        hbm += xb
        ts.append(xb / hw.hbm_bw)
    return ResidencyPlan(modes=list(modes), hbm_bytes=hbm,
                         vmem_peak=vmem_peak, est_seconds=math.fsum(ts),
                         per_block=per_block)


def _fits(b: LMBlockSpec, hw: TPUConfig, vmem_budget: int) -> bool:
    return b.resident_vmem(hw) <= vmem_budget


# -------------------------------------------------------------- cost tables
@dataclass(frozen=True)
class CostTables:
    """Per-block static costs, tabulated once per (stack, hw, budget).

    ``hbm``/``sec`` are keyed by ``(prev_mode, mode)``: the four boundary
    cases of ``_block_cost`` (equal modes -> no boundary; a mode change at
    block i charges ``entry[i]``, the predecessor's stream bytes).  All
    arrays have length N; values are bit-identical to the scalar oracle's.
    """
    n: int
    entry: np.ndarray                       # int64: _entry_stream per block
    rvmem: np.ndarray                       # int64: resident_vmem per block
    fits: np.ndarray                        # bool:  rvmem <= vmem_budget
    hbm: dict[tuple[str, str], np.ndarray]  # int64
    sec: dict[tuple[str, str], np.ndarray]  # float64


def build_cost_tables(blocks: list[LMBlockSpec], hw: TPUConfig,
                      vmem_budget: int) -> CostTables:
    n = len(blocks)
    w = np.array([b.weight_bytes for b in blocks], dtype=np.int64)
    state = np.array([b.state_bytes for b in blocks], dtype=np.int64)
    act = np.array([b.act_bytes for b in blocks], dtype=np.int64)
    stream = np.array([b.stream_bytes for b in blocks], dtype=np.int64)
    entry = np.array([_entry_stream(blocks, i) for i in range(n)],
                     dtype=np.int64)
    rvmem = np.array([b.resident_vmem(hw) for b in blocks], dtype=np.int64)
    flops = np.array([b.flops for b in blocks], dtype=np.float64)

    h_res = w + state
    h_str = h_res + act + 2 * stream
    hbm = {
        ("streaming", "streaming"): h_str,
        ("resident", "resident"): h_res,
        ("streaming", "resident"): h_res + entry,   # segment entry read
        ("resident", "streaming"): h_str + entry,   # segment exit write
    }
    compute_s = flops / hw.peak_flops
    sec = {k: np.maximum(compute_s, v.astype(np.float64) / hw.hbm_bw)
           for k, v in hbm.items()}
    return CostTables(n=n, entry=entry, rvmem=rvmem,
                      fits=rvmem <= vmem_budget, hbm=hbm, sec=sec)


# ---------------------------------------------------- exact float summation
def _grow_partials(partials: list[float], x: float) -> list[float]:
    """Shewchuk error-free accumulation (the ``math.fsum`` inner loop):
    returns non-overlapping partials whose exact sum is sum(partials) + x.
    ``math.fsum`` over any partials snapshot plus further terms therefore
    equals ``math.fsum`` over the original term multiset, bit-for-bit."""
    i = 0
    for y in partials:
        if abs(x) < abs(y):
            x, y = y, x
        hi = x + y
        lo = y - (hi - x)
        if lo:
            partials[i] = lo
            i += 1
        x = hi
    partials[i:] = [x]
    return partials


# ------------------------------------------------------------------- engine
class ResidencyEngine:
    """Incremental, oracle-exact residency planner core (see module
    docstring).  Build once per (stack, hw, vmem_budget); ``sweep`` then
    prices all N+1 cuts in O(N) total and ``dp_modes`` runs the exact DP
    with O(1) work per transition."""

    def __init__(self, blocks: list[LMBlockSpec], hw: TPUConfig = V5E,
                 vmem_budget: int | None = None):
        self.blocks = blocks
        self.hw = hw
        self.vmem_budget = vmem_budget or hw.vmem_bytes
        self.tables = build_cost_tables(blocks, hw, self.vmem_budget)
        self._build_checkpoints()

    # -- cut-point machinery ------------------------------------------------
    def _build_checkpoints(self) -> None:
        """Checkpoint the oracle's running sums at every cut position.

        For cut c the mode vector is: blocks < c streaming; blocks >= c in
        their *fits-mode* (resident iff they fit VMEM -- non-fitting blocks
        are forced streaming).  The fits-mode of every suffix block is
        independent of c, so one prefix pass (all-streaming costs) and one
        suffix pass (fits-mode costs with their fits-determined boundaries)
        price every cut; only block c's own boundary depends on c.
        """
        t = self.tables
        n = t.n
        fm = ["resident" if f else "streaming" for f in t.fits]
        self._fits_modes = fm
        t_ss = t.sec[("streaming", "streaming")]
        h_ss = t.hbm[("streaming", "streaming")]

        # prefix checkpoints: exact sums of all-streaming costs over [0, c)
        self._pre_sec: list[list[float]] = [[]]
        self._pre_hbm: list[int] = [0]
        parts: list[float] = []
        acc = 0
        for i in range(n):
            parts = _grow_partials(parts, float(t_ss[i]))
            acc += int(h_ss[i])
            self._pre_sec.append(list(parts))
            self._pre_hbm.append(acc)

        # suffix checkpoints over [c, n) of fits-mode costs with interior
        # boundaries (block i's boundary case is (fm[i-1], fm[i])); index 0
        # is never queried -- the cut block itself is priced separately.
        self._suf_sec: list[list[float]] = [[] for _ in range(n + 1)]
        self._suf_hbm: list[int] = [0] * (n + 1)
        self._suf_vmax: list[int] = [0] * (n + 1)
        parts = []
        acc = 0
        vmax = 0
        self._exit: tuple[float, int] | None = None
        for i in range(n - 1, 0, -1):
            key = (fm[i - 1], fm[i])
            parts = _grow_partials(parts, float(t.sec[key][i]))
            acc += int(t.hbm[key][i])
            if t.fits[i]:
                vmax = max(vmax, int(t.rvmem[i]))
            self._suf_sec[i] = list(parts)
            self._suf_hbm[i] = acc
            self._suf_vmax[i] = vmax
        if n:
            self._suf_vmax[0] = max(self._suf_vmax[1],
                                    int(t.rvmem[0]) if t.fits[0] else 0)
            if fm[-1] == "resident":
                xb = self.blocks[-1].stream_bytes
                self._exit = (xb / self.hw.hbm_bw, xb)

    def cut_modes(self, cut: int) -> tuple[list[str], list[int]]:
        """(mode vector, forced-streaming block indices) for one cut:
        blocks >= cut are resident where they fit, forced streaming where
        they don't."""
        fm = self._fits_modes
        modes = ["streaming"] * cut + fm[cut:]
        forced = [i for i in range(cut, self.tables.n) if fm[i] != "resident"]
        return modes, forced

    def evaluate_cut(self, cut: int) -> tuple[float, int, int]:
        """(est_seconds, hbm_bytes, vmem_peak) of one cut, bit-identical to
        ``_evaluate(blocks, cut_modes(cut)[0], hw)``, in O(1)."""
        t = self.tables
        n = t.n
        if cut == n:
            return math.fsum(self._pre_sec[n]), self._pre_hbm[n], 0
        # block `cut` sits at the streaming->suffix boundary: it pays the
        # entry read iff it is itself resident
        key = ("streaming", self._fits_modes[cut])
        terms = self._pre_sec[cut] + [float(t.sec[key][cut])] \
            + self._suf_sec[cut + 1]
        hbm = self._pre_hbm[cut] + int(t.hbm[key][cut]) \
            + self._suf_hbm[cut + 1]
        if self._exit is not None:
            terms.append(self._exit[0])
            hbm += self._exit[1]
        return math.fsum(terms), hbm, self._suf_vmax[cut]

    def sweep(self) -> int:
        """Best single cut (lowest (est_seconds, hbm_bytes); ties keep the
        earliest cut, as the direct ascending sweep does)."""
        best_cut = 0
        best_key: tuple[float, int] | None = None
        for cut in range(self.tables.n + 1):
            est, hbm, _ = self.evaluate_cut(cut)
            key = (est, hbm)
            if best_key is None or key < best_key:
                best_cut, best_key = cut, key
        return best_cut

    # -- DP machinery -------------------------------------------------------
    def dp_modes(self) -> list[str]:
        """Exact DP over per-block modes (states: previous block's mode),
        lexicographic (seconds, hbm_bytes) cost.  Transition costs come
        from the pre-tabulated boundary tables; the winning path is
        rebuilt through parent pointers.  Tie-breaks match the reference
        transition-by-transition DP: 'streaming' is preferred (it is
        tried first, and only strictly better costs replace it)."""
        t = self.tables
        n = t.n
        if not n:
            return []
        sec_ss, hbm_ss = (t.sec[("streaming", "streaming")].tolist(),
                          t.hbm[("streaming", "streaming")].tolist())
        sec_sr, hbm_sr = (t.sec[("streaming", "resident")].tolist(),
                          t.hbm[("streaming", "resident")].tolist())
        sec_rs, hbm_rs = (t.sec[("resident", "streaming")].tolist(),
                          t.hbm[("resident", "streaming")].tolist())
        sec_rr, hbm_rr = (t.sec[("resident", "resident")].tolist(),
                          t.hbm[("resident", "resident")].tolist())
        fits = t.fits.tolist()
        INF = (math.inf, math.inf)
        cs, cr = (0.0, 0), INF     # best cost ending streaming / resident
        par_s: list[str] = []      # chosen predecessor mode per (block, state)
        par_r: list[str] = []
        for i in range(n):
            ns, ps = (cs[0] + sec_ss[i], cs[1] + hbm_ss[i]), "streaming"
            if cr != INF:
                c = (cr[0] + sec_rs[i], cr[1] + hbm_rs[i])
                if c < ns:
                    ns, ps = c, "resident"
            nr, pr = INF, ""
            if fits[i]:
                nr, pr = (cs[0] + sec_sr[i], cs[1] + hbm_sr[i]), "streaming"
                if cr != INF:
                    c = (cr[0] + sec_rr[i], cr[1] + hbm_rr[i])
                    if c < nr:
                        nr, pr = c, "resident"
            cs, cr = ns, nr
            par_s.append(ps)
            par_r.append(pr)
        if cr != INF:              # trailing segment exit write
            xb = self.blocks[-1].stream_bytes
            cr = (cr[0] + xb / self.hw.hbm_bw, cr[1] + xb)
        m = "streaming" if cs <= cr else "resident"
        modes = [m]
        for i in range(n - 1, 0, -1):
            m = par_s[i] if m == "streaming" else par_r[i]
            modes.append(m)
        modes.reverse()
        return modes


# ----------------------------------------------------------------- planners
def _engine_for(blocks: list[LMBlockSpec], hw: TPUConfig,
                vmem_budget: int | None,
                engine: ResidencyEngine | None) -> ResidencyEngine:
    if engine is None:
        return ResidencyEngine(blocks, hw, vmem_budget)
    assert engine.blocks is blocks and engine.hw is hw \
        and engine.vmem_budget == (vmem_budget or hw.vmem_bytes), \
        "engine was built for different (blocks, hw, vmem_budget)"
    return engine


def plan_cutpoint(blocks: list[LMBlockSpec], hw: TPUConfig = V5E,
                  vmem_budget: int | None = None,
                  engine: ResidencyEngine | None = None) -> ResidencyPlan:
    """Paper-faithful single-cut policy: blocks >= L resident (provided
    they fit VMEM); exhaustive sweep of L (Fig. 16/17 analogue), priced by
    the O(N) engine.  Pass ``engine`` to reuse one built for the same
    (blocks, hw, vmem_budget); the winner is materialized through the
    oracle.  Blocks inside the resident suffix that were forced streaming
    by the VMEM fit check are flagged ``forced_streaming`` in
    ``per_block``, so ``cut`` plus the flags fully describe ``modes``."""
    engine = _engine_for(blocks, hw, vmem_budget, engine)
    cut = engine.sweep()
    modes, forced = engine.cut_modes(cut)
    plan = _evaluate(blocks, modes, hw)
    plan.cut = cut
    for i in forced:
        plan.per_block[i]["forced_streaming"] = True
    # The per-block fit check already gates every resident block, so the
    # plan-level budget invariant holds by construction -- keep it explicit
    # rather than as an unreachable rejection branch.
    assert plan.vmem_peak <= engine.vmem_budget, \
        (plan.vmem_peak, engine.vmem_budget)
    return plan


def plan_dp(blocks: list[LMBlockSpec], hw: TPUConfig = V5E,
            vmem_budget: int | None = None,
            engine: ResidencyEngine | None = None) -> ResidencyPlan:
    """Beyond-paper exact DP: argmin over per-block modes of total time
    with boundary costs (states: mode of the previous block).  Pass
    ``engine`` to reuse one built for the same (blocks, hw, vmem_budget)."""
    engine = _engine_for(blocks, hw, vmem_budget, engine)
    return _evaluate(blocks, engine.dp_modes(), hw)


def streaming_baseline(blocks: list[LMBlockSpec],
                       hw: TPUConfig = V5E,
                       vmem_budget: int | None = None) -> ResidencyPlan:
    """All-streaming reference plan.  ``vmem_budget`` is accepted for
    signature parity with the planners but is irrelevant: a streaming-only
    plan pins nothing in VMEM."""
    return _evaluate(blocks, ["streaming"] * len(blocks), hw)
