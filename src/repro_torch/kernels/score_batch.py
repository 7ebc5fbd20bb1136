"""Staged float32 scorer (candidates x groups) in PyTorch and CUDA.

The cut-point engine's batched scorer (``CutpointEngine.score_batch``)
expands B cut tuples into a B x G frame-mask matrix plus a B x G
boundary-I/O matrix and reduces them against the static per-group cost
tables (``latency_tables`` / ``dram_tables`` / ``sram_tables``).  Behind
``backend="pallas"`` those reductions are staged in float32 -- the on-device
path of the JAX package's ``repro/kernels/score_batch.py``.  One call
computes, per candidate, the (B, ``N_STATS``) stats matrix

* ``latency`` -- sum over groups of
  ``where(side, comp, where(frame, max(comp, (weight+io)/bpc) + ovh, row))``
* ``row_fm``  -- the row-mode DRAM feature-map term,
  ``sum(where(~frame, row_fm, 0))``
* the four SRAM maxima of eqs. (1)/(4)/(5): ``weight_buff`` (row-mode
  weight max), ``out_frame`` / ``out_row`` (partial-sum buffer
  candidates) and ``wr_row`` (write-buffer max).

Float32 makes this path NOT part of the engine's bit-exact oracle
contract: the numpy backend stays the default and the oracle of record,
and the engine never memoizes what this path returns.  Its own contract is
agreement with the JAX package's float32 reference ``score_batch_ref`` to
``allclose(rtol=1e-5, atol=1e-2)``.

Two implementations of the same function:

* :func:`score_batch_torch` -- the plain version, on any device.  Both sums
  are plain left-to-right float32 accumulations in gid order (a loop of
  ``acc = acc + per[:, g]``, never ``torch.sum``), so it equals the kernel
  bit for bit on the card.
* :func:`score_batch_cuda` -- the hand-written kernel
  (``csrc/score_batch.cu``).

**The kernels.**  They replace the TPU kernel
``repro/kernels/score_batch.py::_score_kernel``, which puts candidates on
the sublane axis and the groups, padded to 128 lanes, on the lane axis, and
reduces each (TB, Gp) tile across lanes.  Per candidate and group the
function reads one mask byte and four io bytes and does about 14 float32
operations, so at the card's 3.35 TB/s and 67 TFLOP/s it is bound by bytes
-- but only at the pipeline's chunk (B 1,048,576, G 26).  At the batches
the main path gives it (the descent's 1 to 8 candidates, the engine's
1,024) the call moves under a megabyte and what sets its time is latency.
:func:`score_batch_plan` picks one of two kernels by a fixed rule on B and
the card's SMs:

* ``"thread"`` (``score_batch_kernel``) -- one thread a candidate walks the
  groups in gid order with its six accumulators in registers; frame and io
  lane-major, ``[G][B]``, so a warp's 32 candidates read 32 neighbouring
  addresses at every group (K1 writes its io matrix so).  It keeps the
  large batches, where it is bound by bytes.  At a few candidates it is a
  chain of G round trips to memory: ~0.05 ms at G 139.
* ``"split"`` (``score_batch_split_kernel``) -- one warp a candidate, taken
  when the first kernel would fill fewer than two blocks an SM.  Each lane
  issues the mask and io loads of all its groups (``l, l + 32, ...``) at
  once while the block stages the nine table rows in shared memory, so a
  candidate waits for one round trip a ``SPLIT_PASS`` groups; lanes 0 and
  1 then add the latency and row-mode terms in gid order (the same plain
  sums), and the four maxima are reduced across the lanes by ``fmaxf``,
  exact in any order on these non-negative tables.  It reads frame and io
  in place through their strides -- row-major from the journal replay's
  host matrices, lane-major from the device replay and K1 -- and writes
  its stats row-major, so nothing is copied before the launch and
  ``score_stats`` reads one contiguous block back.

PERF.md has the times.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

N_STATS = 6                            # stats columns per candidate
SCORE_BLOCK = 256      # candidates a block of the thread-a-candidate kernel
SPLIT_WARPS = 4        # candidates a block of the split kernel, a warp each
SPLIT_PASS = 256       # groups a warp prices with its loads in flight at once
VARIANTS = ("thread", "split")
TABLE_KEYS = ("comp", "row", "weight", "side", "row_fm", "compute",
              "out_frame", "out_row", "wr_row")


@dataclass(frozen=True)
class ScoreTables:
    """The nine per-group cost tables as one (9, G) float32 tensor on
    ``device``, rows in ``TABLE_KEYS`` order."""
    g: int
    rows: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.rows.device


def pack_tables(lt, dt, st, device="cpu") -> ScoreTables:
    """Pack the engine's static cost tables into float32 rows.

    ``lt`` / ``dt`` / ``st`` are the ``LatencyTables`` / ``DRAMTables`` /
    ``SRAMTables`` of one graph.  Each value is taken as float64 and
    rounded once to float32, as the JAX package's ``pack_tables`` does."""
    cols = {"comp": lt.comp, "row": lt.row, "weight": lt.weight,
            "side": lt.side, "row_fm": dt.row_fm, "compute": st.compute,
            "out_frame": st.out_frame, "out_row": st.out_row,
            "wr_row": st.wr_row}
    g = len(lt.comp)
    rows = np.zeros((len(TABLE_KEYS), g), np.float32)
    for i, key in enumerate(TABLE_KEYS):
        rows[i] = np.asarray(cols[key], np.float64)[:g]
    return ScoreTables(g=g, rows=torch.from_numpy(rows).to(device))


@dataclass(frozen=True)
class BatchStats:
    """Per-candidate reductions, shaped (B,), host-side numpy."""
    latency: np.ndarray        # float64 (cast from f32)
    row_fm: np.ndarray         # int64: row-mode DRAM fm term
    maxima: tuple              # (weight_buff, out_frame, out_row, wr_row)


def _check_inputs(t: ScoreTables, frame: torch.Tensor, io: torch.Tensor):
    if frame.ndim != 2 or frame.shape[1] != t.g:
        raise ValueError(f"frame must be (B, {t.g}), got "
                         f"{tuple(frame.shape)}")
    if io.shape != frame.shape:
        raise ValueError(f"io {tuple(io.shape)} and frame "
                         f"{tuple(frame.shape)} differ in shape")
    if frame.device != t.device or io.device != t.device:
        raise ValueError(f"frame on {frame.device} and io on {io.device}, "
                         f"the tables on {t.device}")


# ------------------------------------------------------------ plain version
def score_batch_torch(t: ScoreTables, frame: torch.Tensor, io: torch.Tensor,
                      bpc: float, overhead: float) -> torch.Tensor:
    """The plain version: the (B, ``N_STATS``) float32 stats matrix.

    ``frame`` is the (B, G) mask (bool or uint8), ``io`` the (B, G) boundary
    bytes in any numeric type (rounded once to float32), both on the
    tables' device."""
    _check_inputs(t, frame, io)
    f32 = torch.float32
    fr = frame.to(torch.bool)
    iof = io.to(f32)
    comp, row, weight, side, row_fm, compute, out_frame, out_row, wr_row = (
        t.rows[i] for i in range(len(TABLE_KEYS)))
    bpc32 = torch.tensor(bpc, dtype=f32, device=t.device)
    ovh32 = torch.tensor(overhead, dtype=f32, device=t.device)
    zero = torch.zeros((), dtype=f32, device=t.device)
    mem = (weight + iof) / bpc32
    frame_lat = torch.maximum(comp, mem) + ovh32
    per = torch.where(side > 0, comp, torch.where(fr, frame_lat, row))
    rfm_terms = torch.where(fr, zero, row_fm)
    b = frame.shape[0]
    lat = torch.zeros(b, dtype=f32, device=t.device)
    rfm = torch.zeros(b, dtype=f32, device=t.device)
    for g in range(t.g):                  # det: left-to-right, gid order
        lat = lat + per[:, g]
        rfm = rfm + rfm_terms[:, g]
    cm = compute > 0
    rowm = cm & ~fr
    frm = cm & fr

    def masked_max(mask, vals):
        # the tables are >= 0, so the masked-out zeros act as the initial 0
        if t.g == 0:
            return torch.zeros(b, dtype=f32, device=t.device)
        return torch.where(mask, vals, zero).amax(dim=1)

    return torch.stack([lat, rfm, masked_max(rowm, weight),
                        masked_max(frm, out_frame), masked_max(rowm, out_row),
                        masked_max(rowm, wr_row)], dim=1)


# ------------------------------------------------------------------- kernel
@dataclass(frozen=True)
class ScorePlan:
    """How :func:`score_batch_cuda` launches its kernel."""
    split: bool         # a warp a candidate, else a thread
    threads: int        # a block
    blocks: int
    round_trips: int    # loads a candidate waits for one after another:
    #                     one a group, or one a SPLIT_PASS groups

    @property
    def variant(self) -> str:
        return VARIANTS[self.split]


def score_batch_plan(B: int, G: int, sms: int = 132,
                     split: bool | None = None) -> ScorePlan:
    """The launch of the scorer on ``B`` candidates of ``G`` groups: one
    thread a candidate, or -- when that would fill fewer than two blocks an
    SM of ``sms``, unless ``split`` says -- one warp a candidate."""
    if split is None:
        split = -(-B // SCORE_BLOCK) < 2 * sms
    if split:
        return ScorePlan(split=True, threads=32 * SPLIT_WARPS,
                         blocks=-(-B // SPLIT_WARPS),
                         round_trips=-(-G // SPLIT_PASS))
    return ScorePlan(split=False, threads=SCORE_BLOCK,
                     blocks=-(-B // SCORE_BLOCK), round_trips=G)


def score_batch_cuda(t: ScoreTables, frame: torch.Tensor, io: torch.Tensor,
                     bpc: float, overhead: float,
                     split: bool | None = None) -> torch.Tensor:
    """The CUDA scorer (``csrc/score_batch.cu``): bit-identical to
    :func:`score_batch_torch`.

    ``frame`` is a (B, G) bool or uint8 CUDA tensor, ``io`` a (B, G) float32
    or int32 one.  ``split`` forces one of the two kernels
    (:func:`score_batch_plan` picks when None).  The split kernel reads both
    in place through their strides and returns a contiguous (B,
    ``N_STATS``) tensor; the thread-a-candidate kernel reads lane-major
    storage (K1's io, K2's frames) in place, copies anything else once, and
    returns a (B, ``N_STATS``) view of lane-major storage.  Launches the
    kernel or raises -- there is no other path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.alloc_scan import lane_major
    from repro_torch.kernels.search_pipeline import _sm_count

    if not (frame.is_cuda and io.is_cuda):
        raise ValueError(f"score_batch_cuda wants CUDA tensors, got frame "
                         f"on {frame.device} and io on {io.device}")
    _check_inputs(t, frame, io)
    if frame.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"frame must be bool or uint8, got {frame.dtype}")
    if io.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"io must be float32 or int32, got {io.dtype}")
    b, g = frame.shape
    dev = t.device
    plan = score_batch_plan(b, g, sms=_sm_count(dev.index or 0), split=split)
    if b == 0:
        return torch.empty((0, N_STATS), dtype=torch.float32, device=dev)
    frame8 = frame.view(torch.uint8) if frame.dtype == torch.bool else frame
    io_is_int = int(io.dtype == torch.int32)
    tail = (b, g, float(bpc), float(overhead), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    lib = _build.load()
    if plan.split:
        out = torch.empty((b, N_STATS), dtype=torch.float32, device=dev)
        err = lib.score_batch_split_launch(
            frame8.data_ptr(), *frame8.stride(), io.data_ptr(), *io.stride(),
            io_is_int, t.rows.data_ptr(), out.data_ptr(), *tail)
    else:
        out = torch.empty((N_STATS, b), dtype=torch.float32, device=dev)
        # held until the launch is queued: a copy freed earlier could be
        # handed to the next one
        frame_lm, io_lm = lane_major(frame8), lane_major(io)
        err = lib.score_batch_launch(
            frame_lm.data_ptr(), io_lm.data_ptr(), io_is_int,
            t.rows.data_ptr(), out.data_ptr(), *tail)
        out = out.t()
    _build.check(err, "score_batch")
    score_batch_cuda.launches += 1
    score_batch_cuda.launches_by_variant[plan.variant] += 1
    return out


score_batch_cuda.launches = 0
score_batch_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def score_batch(t: ScoreTables, frame: torch.Tensor, io: torch.Tensor,
                bpc: float, overhead: float,
                backend: str | None = None) -> torch.Tensor:
    """The (B, ``N_STATS``) stats matrix under ``backend``: ``"cuda"`` (the
    kernel; raises for a CPU tensor), ``"torch"`` (the plain version,
    wherever the tensors lie) or ``None`` -- by the tensors' device: the
    kernel for CUDA tensors, the plain version only because they lie on
    the CPU."""
    if backend is None:
        backend = "cuda" if frame.is_cuda else "torch"
    if backend == "cuda":
        return score_batch_cuda(t, frame, io, bpc, overhead)
    if backend == "torch":
        return score_batch_torch(t, frame, io, bpc, overhead)
    raise ValueError(f"unknown score_batch backend: {backend!r}")


def score_stats(t: ScoreTables, frame, io, hw,
                backend: str | None = None) -> BatchStats:
    """Engine adapter: the stats of one batch against ``hw``, as the
    shapes the batched cost models consume (the ``row_terms`` / ``maxima``
    injection points of ``dram_fm_fast_batch`` / ``sram_total_fast_batch``).

    ``frame`` / ``io`` are (B, G) tensors on the tables' device, or host
    numpy arrays (the journal replay's), which are copied to the device
    once as they lie, io rounded to float32 first.  The int quantities are
    rounded from float32 with ``torch.round`` (half to even, as the JAX
    package's ``np.rint``) -- exact only while the true values stay under
    2**24, which is why this path is staged behind ``backend="pallas"``
    rather than replacing the numpy oracle."""
    if isinstance(frame, np.ndarray):
        frame = torch.from_numpy(np.asarray(frame, bool)).to(t.device)
        io = torch.from_numpy(np.asarray(io).astype(np.float32)).to(t.device)
    stats = score_batch(t, frame, io, hw.dram_bytes_per_cycle,
                        hw.group_overhead_cycles, backend=backend).cpu()
    as_int = torch.round(stats[:, 1:]).to(torch.int64).numpy()
    return BatchStats(latency=stats[:, 0].to(torch.float64).numpy(),
                      row_fm=as_int[:, 0],
                      maxima=tuple(as_int[:, i] for i in range(1, 5)))

