"""Fused residual MLP block in PyTorch and CUDA.

The block every MLP of the LM substrate runs (``models/layers.py::
mlp_apply``)::

    y = x + [post_norm]( act(n @ Wg) * (n @ Wu) ) @ Wd,   n = rmsnorm(x)

gated (GeGLU / SwiGLU) or ungated (``act(n @ Wu) @ Wd``, granite), with an
optional sandwich RMS norm (gemma2).  ``x`` is ``[M, d]``; ``w_gate`` /
``w_up`` are ``[d, F]`` and ``w_down`` ``[F, d]``, the JAX package's
``x @ W`` layout; the norm scales are ``[d]``.

Two implementations of the same function:

* :func:`fused_block_torch` -- the plain version, the JAX package's oracle
  ``kernels/ref.py::fused_block_ref`` in torch: the normalised tile and
  ``h`` are rounded to the input type, and each product is rounded to
  float32 where the oracle's float32 accumulator holds it
  (``preferred_element_type=float32`` there).  The products are summed in
  float64 before that rounding: two float32 summation orders over F =
  36,864 (gemma2-27b) differ by up to ~5e-5 after the sandwich norm, more
  than the kernels' float32 tolerance, so a float32 yardstick could not
  tell a right kernel from a wrong one at that width.
* :func:`fused_block_cuda` -- the hand-written kernels, which replace the
  TPU kernel ``repro/kernels/fused_block.py::_kernel``: on bfloat16 two
  tiled tensor-core products (``csrc/fused_block_tc.cu``), on float32 SIMT
  row tiles (``csrc/fused_block.cu``), and for rows wider than those tiles
  hold (d > ``MAX_D``) SIMT product tiles over d in four passes (the same
  source).
  :func:`fused_block_variant` is the fixed rule that picks one.  Both keep
  the rounding points of the TPU kernel; the designs, and what bounds
  them, are in the sources.

With ``partial=True`` both return the float32 accumulator ``y = h @ Wd``
of the F slice they are given, with no post-norm and no residual: under
tensor parallelism each rank holds ``F / n`` columns of ``Wg`` / ``Wu``
and rows of ``Wd``, and the ranks' partial sums are added (in float32)
before the sandwich norm, which is not linear, and the residual
(``models/layers.py::mlp_apply``).  Subtracting ``x`` from the block's
output instead would lose the partial's low bits in bfloat16.

On bfloat16 inputs the two agree to bfloat16 tolerance (2e-2), in float32 to
2e-5; ``mlp_apply`` in the JAX package rounds at other points, so the kernel
matches it only to those tolerances.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-6
MAX_D = 2560            # the SIMT row tiles keep at most 10 columns a thread
BLOCK_M = 8             # rows per block (csrc/fused_block.cu: BM)
WIDE_TILE = 64          # the wide path's product tiles (csrc: WT)
WIDE_K = 16             # and their K step (csrc: WK)
VARIANTS = ("tensor_core", "simt", "simt_split", "simt_wide")


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return x * torch.sigmoid(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def _norm(v: torch.Tensor, s: torch.Tensor, eps: float) -> torch.Tensor:
    v32 = v.to(torch.float32)
    var = torch.mean(v32 * v32, dim=-1, keepdim=True)
    return v32 * torch.rsqrt(var + eps) * (1 + s.to(torch.float32))


def _check(x, scale, w_gate, w_up, w_down, post_scale, gated, sandwich):
    if x.ndim != 2:
        raise ValueError(f"x must be [M, d], got {tuple(x.shape)}")
    m, d = x.shape
    f = w_up.shape[1]
    if w_up.shape != (d, f) or w_down.shape != (f, d) or scale.shape != (d,):
        raise ValueError(f"shapes: x {tuple(x.shape)}, w_up "
                         f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if gated and (w_gate is None or w_gate.shape != (d, f)):
        raise ValueError("gated block needs w_gate of shape [d, F]")
    if sandwich and (post_scale is None or post_scale.shape != (d,)):
        raise ValueError("sandwich block needs post_scale of shape [d]")


# ------------------------------------------------------------ plain version
def fused_block_torch(x, scale, w_gate, w_up, w_down, post_scale=None, *,
                      act: str = "silu", gated: bool = True,
                      sandwich: bool = False, partial: bool = False,
                      eps: float = EPS) -> torch.Tensor:
    """The plain version: ``kernels/ref.py::fused_block_ref`` in torch;
    ``partial``: the float32 product ``h @ Wd`` alone (see the module
    docstring)."""
    sandwich = sandwich and not partial
    _check(x, scale, w_gate, w_up, w_down, post_scale, gated, sandwich)
    f32, f64 = torch.float32, torch.float64

    def product(a, w):
        """``a @ w`` summed in float64, rounded once to float32."""
        return (a.to(f64) @ w.to(f64)).to(f32)

    n = _norm(x, scale, eps).to(x.dtype)
    u = product(n, w_up)
    if gated:
        h = _act(act, product(n, w_gate)) * u
    else:
        h = _act(act, u)
    y = product(h.to(x.dtype), w_down)
    if partial:
        return y
    if sandwich:
        y = _norm(y, post_scale, eps)
    return (x.to(f32) + y).to(x.dtype)


# ------------------------------------------------------------------- kernel
def fused_block_variant(dtype: torch.dtype, m: int, d: int, f: int,
                        sms: int, aligned: bool = True) -> str:
    """The kernel a CUDA call of ``m`` rows runs, by a fixed rule:

    * ``"tensor_core"`` (``csrc/fused_block_tc.cu``) -- bfloat16 with d
      and F multiples of 8 and every tensor 16-byte aligned (its copies are
      16 bytes): prefill and decode alike (at decode, M = 2, it is faster
      than the split SIMT kernel too: ``PERF.md``);
    * ``"simt"`` (``csrc/fused_block.cu``, one block per 8 rows) -- any
      other input with a row tile for every one of the ``sms`` SMs (a
      float32 prefill);
    * ``"simt_split"`` (the same kernel with F split across blocks and a
      second pass) -- the rest up to d = ``MAX_D``: a float32 decode
      (M = batch), short unaligned bfloat16 inputs;
    * ``"simt_wide"`` (``csrc/fused_block.cu``'s four passes, product tiles
      over d) -- any other input wider than ``MAX_D``: gemma2-27b's and
      granite-20b's float32 MLPs, prefill and decode alike.

    float32 never takes the tensor cores: they would compute in TF32.
    """
    if (dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
            and aligned):
        return "tensor_core"
    if d > MAX_D:
        return "simt_wide"
    return "simt" if -(-m // BLOCK_M) >= sms else "simt_split"


def simt_slabs(variant: str, m: int, f: int, sms: int) -> tuple:
    """``(bf, splits)`` of the SIMT kernel: ``"simt"`` walks F in slabs of
    256 in one block per 8 rows; ``"simt_split"`` splits F across blocks in
    slabs of 64 (aiming at two blocks per SM), added in a second pass."""
    if variant == "simt":
        return 256, 1
    return 64, min(-(-f // 64), -(-2 * sms // -(-m // BLOCK_M)))


def simt_wide_splits(m: int, d: int, f: int, sms: int) -> int:
    """How many blocks the ``"simt_wide"`` down product splits F across:
    one where its 64 x 64 tiles of y fill two blocks an SM (a prefill),
    else enough splits to (a decode: gemma2-27b's M 2 has 72 tiles), at
    most one a K step of F."""
    tiles = -(-m // WIDE_TILE) * -(-d // WIDE_TILE)
    if tiles >= 2 * sms:
        return 1
    return min(-(-f // WIDE_K), -(-2 * sms // tiles))


def fused_block_cuda(x, scale, w_gate, w_up, w_down, post_scale=None, *,
                     act: str = "silu", gated: bool = True,
                     sandwich: bool = False, partial: bool = False,
                     eps: float = EPS) -> torch.Tensor:
    """The CUDA block, the kernel :func:`fused_block_variant` names.  ``x``
    and the weights are contiguous CUDA tensors of one type, float32 or
    bfloat16; the scales may be of any float type.  ``partial``: the
    float32 ``[M, d]`` product ``h @ Wd`` alone (``sandwich`` is then
    ignored).  Launches the kernel or raises."""
    from repro_torch.kernels import _build

    sandwich = sandwich and not partial
    _check(x, scale, w_gate, w_up, w_down, post_scale, gated, sandwich)
    mats = [x, w_up, w_down] + ([w_gate] if gated else [])
    if not all(t.is_cuda for t in mats):
        raise ValueError("fused_block_cuda wants CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != x.dtype for t in mats):
        raise TypeError(f"x and the weights must share one type, float32 or "
                        f"bfloat16; got {[t.dtype for t in mats]}")
    if not all(t.is_contiguous() for t in mats):
        raise ValueError("fused_block_cuda wants contiguous tensors")
    if act not in ("silu", "gelu"):
        raise ValueError(act)
    m, d = x.shape
    f = w_up.shape[1]
    dev = x.device
    out = torch.empty((m, d), dtype=torch.float32 if partial else x.dtype,
                      device=dev)
    if m == 0:
        return out
    yout = out.data_ptr() if partial else None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    variant = fused_block_variant(
        x.dtype, m, d, f, sms,
        aligned=all(t.data_ptr() % 16 == 0 for t in mats))
    scale32 = scale.to(device=dev, dtype=torch.float32).contiguous()
    post32 = (post_scale.to(device=dev, dtype=torch.float32).contiguous()
              if sandwich else None)
    wg_ptr = w_gate.data_ptr() if gated else None
    post_ptr = post32.data_ptr() if sandwich else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load()
    if variant == "tensor_core":
        # scratch: the normalised rows, h, and (sandwich) y in float32
        n = torch.empty_like(x)
        h = torch.empty((m, f), dtype=x.dtype, device=dev)
        y = (torch.empty((m, d), dtype=torch.float32, device=dev)
             if sandwich else None)
        err = lib.fused_block_tc_launch(
            x.data_ptr(), scale32.data_ptr(), wg_ptr, w_up.data_ptr(),
            w_down.data_ptr(), post_ptr, None if partial else out.data_ptr(),
            n.data_ptr(), h.data_ptr(),
            yout if partial else (y.data_ptr() if sandwich else None), m, d,
            f, int(gated), int(act == "gelu"), int(sandwich), int(partial),
            float(eps), dev.index or 0, stream)
    elif variant == "simt_wide":
        # scratch: the normalised rows and h in x's type, the down
        # product's partial y in float32, a plane a split of F
        splits = simt_wide_splits(m, d, f, sms)
        n = torch.empty_like(x)
        h = torch.empty((m, f), dtype=x.dtype, device=dev)
        part = torch.empty((splits, m, d), dtype=torch.float32, device=dev)
        err = lib.fused_block_wide_launch(
            x.data_ptr(), scale32.data_ptr(), wg_ptr, w_up.data_ptr(),
            w_down.data_ptr(), post_ptr, None if partial else out.data_ptr(),
            yout, n.data_ptr(), h.data_ptr(), part.data_ptr(), m, d, f,
            splits, int(gated),
            int(act == "gelu"), int(sandwich), float(eps),
            int(x.dtype == torch.bfloat16), dev.index or 0, stream)
    else:
        bf, splits = simt_slabs(variant, m, f, sms)
        part = (torch.empty((splits, m, d), dtype=torch.float32, device=dev)
                if splits > 1 else None)
        err = lib.fused_block_launch(
            x.data_ptr(), scale32.data_ptr(), wg_ptr, w_up.data_ptr(),
            w_down.data_ptr(), post_ptr, None if partial else out.data_ptr(),
            yout, part.data_ptr() if part is not None else None, m, d, f, bf,
            splits, int(gated), int(act == "gelu"), int(sandwich),
            float(eps), int(x.dtype == torch.bfloat16), dev.index or 0,
            stream)
    _build.check(err, f"fused_block ({variant})")
    fused_block_cuda.launches += 1
    fused_block_cuda.launches_by_variant[variant] += 1
    if partial:
        fused_block_cuda.launches_by_form["partial"] += 1
    return out


fused_block_cuda.launches = 0
fused_block_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
fused_block_cuda.launches_by_form = {"partial": 0}
