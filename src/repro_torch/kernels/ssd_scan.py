"""Mamba-2 SSD chunked scan in PyTorch and CUDA.

The scan of every prefill of an ``ssm`` layer (``models/mamba2.py::
ssm_apply``), in the model's layout::

    x [b, s, h, p]   dt [b, s, h] float32 (after softplus)   A, D [h] float32
    Bm, Cm [b, s, g, n] (head h reads group h // (h_total / g))
    h0 [b, h, p, n] float32, the state the sequence starts from (or None: 0)

    state_t = exp(dt_t A) state_{t-1} + (dt_t x_t) (x) B_t
    y_t     = state_t . C_t + D x_t

returns ``y [b, s, h, p]`` in ``x``'s type and the final state ``[b, h, p,
n]`` float32.  Every input is taken to float32 and ``y`` is rounded once,
after the ``D x`` term.  The within-chunk cumulative sum of ``dt A`` is
taken in float64 and rounded to float32 once a position: at chunk 256 it
reaches |cum| ~ 600, where a float32 running sum's own rounding moves the
differences ``cum_i - cum_j`` (and so ``y``) by a few parts in 1e5, more
than the float32 tolerance.

Two implementations of the same function:

* :func:`ssd_scan_torch` -- the plain version, the JAX package's
  ``models/mamba2.py::ssd_chunked`` in torch: chunks of ``chunk`` tokens in
  order, the quadratic form within a chunk and the state carried across,
  float32 throughout; a ragged last chunk is padded with ``dt = 0`` (no
  state change, no contribution).
* :func:`ssd_scan_cuda` -- the hand-written kernels, which replace the TPU
  kernel ``repro/kernels/ssd_scan.py::_kernel``: the same chunked form,
  reading ``h0`` and writing the final state (the TPU kernel starts from 0
  and keeps its state on chip), the ragged chunk masked in place; on the
  tensor cores for bfloat16 (``csrc/ssd_scan_tc.cu``: the chunks' states,
  chained in chunk order, then the outputs; the float32 operands split
  into bfloat16 hi + lo), SIMT float32 otherwise (``csrc/ssd_scan.cu``).
  :func:`ssd_scan_variant` is the fixed rule that picks one; the designs,
  and what bounds them, are in the sources.

They agree to 1e-4 in float32 and to 2e-2 in bfloat16 (the sums run in
other orders; ``y`` is rounded at the same point); the final state to 1e-4
on both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

MAX_P = 64              # csrc/ssd_scan.cu: PMAX
MAX_N = 128             # csrc/ssd_scan.cu: NMAX
MAX_CHUNK = 4096        # the chunk's four float32 rows fit in shared memory
VARIANTS = ("tensor_core", "simt")


def _check(x, dt, A, Bm, Cm, D, h0):
    if x.ndim != 4 or Bm.ndim != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"x [b,s,h,p], Bm/Cm [b,s,g,n]; got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if (Bm.shape[:2] != (b, s) or dt.shape != (b, s, h)
            or A.shape != (h,) or D.shape != (h,) or g == 0 or h % g):
        raise ValueError(f"shapes do not match x {tuple(x.shape)}: dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)}, Bm {tuple(Bm.shape)} (h a "
                         f"multiple of g)")
    if h0 is not None and h0.shape != (b, h, p, n):
        raise ValueError(f"h0 must be [b,h,p,n] = {(b, h, p, n)}, got "
                         f"{tuple(h0.shape)}")


# ------------------------------------------------------------ plain version
def ssd_scan_torch(x, dt, A, Bm, Cm, D, h0=None, *, chunk: int):
    """The plain version: ``models/mamba2.py::ssd_chunked`` in torch.
    Returns ``(y, final_state)``."""
    _check(x, dt, A, Bm, Cm, D, h0)
    f32 = torch.float32
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    pad = (-s) % chunk
    xf, dtf = x.to(f32), dt.to(f32)
    Bf, Cf = Bm.to(f32), Cm.to(f32)
    if pad:
        # dt = 0 on padding: no state change, no output contribution
        xp = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, 0, 0, pad))
    else:
        xp = xf
    nc = (s + pad) // chunk
    xc = xp.reshape(b, nc, chunk, h, p)
    dtc = dtf.reshape(b, nc, chunk, h)
    Bc = Bf.reshape(b, nc, chunk, g, n)
    Cc = Cf.reshape(b, nc, chunk, g, n)
    # cumulative dt A within each chunk, summed in float64 and rounded
    # once a position (the kernel does the same, so both hold one cum)
    cum = torch.cumsum((dtc * A.to(f32)).to(torch.float64),
                       dim=2).to(f32)                     # [b,nc,l,h]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    ys = []
    for c in range(nc):
        ck = cum[:, c]                                    # [b,l,h]
        # L[i,j] = exp(cum_i - cum_j) for i >= j: the exponent is formed
        # only where it is <= 0 (exp(-cum_j) alone would overflow)
        seg = ck[:, :, None, :] - ck[:, None, :, :]       # [b,l,m,h]
        Lm = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                       float("-inf")))
        xdt = xc[:, c] * dtc[:, c][..., None]             # [b,l,h,p]
        scores = torch.einsum("blgn,bmgn->blmg", Cc[:, c], Bc[:, c])
        scores = scores.repeat_interleave(hg, dim=-1)     # [b,l,m,h]
        y_diag = torch.einsum("blmh,bmhp->blhp", scores * Lm, xdt)
        Ch = Cc[:, c].repeat_interleave(hg, dim=2)        # [b,l,h,n]
        y_off = torch.einsum("blhn,bhpn->blhp", Ch, state) \
            * torch.exp(ck)[..., None]
        decay = torch.exp(ck[:, -1:, :] - ck)             # [b,l,h]
        Bh = Bc[:, c].repeat_interleave(hg, dim=2)        # [b,l,h,n]
        inc = torch.einsum("blhn,blhp->bhpn", Bh, xdt * decay[..., None])
        state = state * torch.exp(ck[:, -1, :])[:, :, None, None] + inc
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1)[:, :s] + xf * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), state


# ------------------------------------------------------------------- kernel
def _token_major(t: torch.Tensor) -> bool:
    """[b, s, g, n] whose [g, n] block is contiguous and whose tokens follow
    each other at one stride (a slice of a wider row, as ``torch.split``
    of the model's B/C projection gives it)."""
    b, s, g, n = t.shape
    st = t.stride()
    return st[3] == 1 and (g == 1 or st[2] == n) and st[0] == s * st[1]


def ssd_scan_variant(dtype: torch.dtype) -> str:
    """The kernel a CUDA call runs, by a fixed rule: ``"tensor_core"``
    (``csrc/ssd_scan_tc.cu``) for bfloat16 x, B and C; ``"simt"``
    (``csrc/ssd_scan.cu``) for float32, which the tensor cores would take in
    TF32."""
    return "tensor_core" if dtype == torch.bfloat16 else "simt"


def ssd_scan_cuda(x, dt, A, Bm, Cm, D, h0=None, *, chunk: int):
    """The CUDA kernel :func:`ssd_scan_variant` names.  x, Bm, Cm are CUDA
    tensors of one type, float32 or bfloat16; dt, A, D, h0 float32; ``p <=
    64``, ``n <= 128``.  Bm and Cm are read in place when their tokens lie
    at one stride (a slice of the model's projection), x and dt are made
    contiguous.  The tensor-core kernel takes a float32 scratch of the
    state after each chunk, ``b * h * ceil(s / chunk) * p * n`` (84 MB at
    mamba2-2.7b's serve), and the chunks' zeroed tickets and flags.
    Returns ``(y, final_state)``.  Launches the kernel or raises."""
    from repro_torch.kernels import _build

    _check(x, dt, A, Bm, Cm, D, h0)
    tensors = (x, dt, A, Bm, Cm, D) + (() if h0 is None else (h0,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError("ssd_scan_cuda wants CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16) or not (
            Bm.dtype == Cm.dtype == x.dtype):
        raise TypeError(f"x, Bm, Cm must share one type, float32 or "
                        f"bfloat16; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if any(t.dtype != torch.float32 for t in tensors[1:3] + tensors[5:]):
        raise TypeError("dt, A, D and h0 must be float32")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if p > MAX_P or n > MAX_N or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan_cuda takes p <= {MAX_P}, n <= {MAX_N} "
                         f"and 0 < chunk <= {MAX_CHUNK}; got p {p}, n {n}, "
                         f"chunk {chunk}")
    if not (_token_major(Bm) and _token_major(Cm)
            and Bm.stride() == Cm.stride()):
        Bm, Cm = Bm.contiguous(), Cm.contiguous()
    x, dt, A, D = (t.contiguous() for t in (x, dt, A, D))
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, (torch.zeros_like(state) if h0 is None else h0.clone())
    dev = x.device
    variant = ssd_scan_variant(x.dtype)
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            state.data_ptr())
    shape = (b, s, h, g, p, n, chunk, Bm.stride(1))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load()
    if variant == "tensor_core":
        # the state after each chunk, and the chunks' tickets and flags
        nc = -(-s // chunk)
        states = torch.empty((b * h * nc * p * n,), dtype=torch.float32,
                             device=dev)
        sync = torch.zeros((1 + b * h * nc,), dtype=torch.int32, device=dev)
        err = lib.ssd_scan_tc_launch(*args, states.data_ptr(),
                                     sync.data_ptr(), *shape,
                                     dev.index or 0, stream)
    else:
        err = lib.ssd_scan_launch(*args, *shape,
                                  int(x.dtype == torch.bfloat16),
                                  dev.index or 0, stream)
    _build.check(err, f"ssd_scan ({variant})")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.launches_by_variant[variant] += 1
    return y, state


ssd_scan_cuda.launches = 0
ssd_scan_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
