"""Flash attention (prefill from position 0) in PyTorch and CUDA.

``q [B, S, NH, hd]``, ``k, v [B, T, NKV, hd]`` -> ``[B, S, NH, hd]``, the
JAX package's layout: softmax attention with key positions counted from 0
and query positions from ``q_offset`` (0 but in a context-parallel
prefill, ``models/attention.py::cp_attention``), optional causal mask, sliding window (``window > 0``: only
keys with ``0 <= i - j < window``), gemma-2 logit soft-capping and GQA / MQA
(query head ``h`` reads kv head ``h // (NH // NKV)``).  It is what every
prefill of an attention layer computes (``models/transformer.py::
attn_apply``).

Two implementations of the same function:

* :func:`flash_attention_torch` -- the plain version, the JAX package's
  oracle ``kernels/ref.py::flash_attention_ref`` in torch: it materialises
  the float32 score matrix.
* :func:`flash_attention_cuda` -- the hand-written kernels, which replace
  the TPU kernel ``repro/kernels/flash_attention.py::_kernel``: online
  softmax over key tiles with whole masked tiles skipped, on the tensor
  cores in bfloat16 (``csrc/flash_attention_tc.cu``), SIMT float32
  otherwise (``csrc/flash_attention.cu``).  :func:`flash_attention_variant`
  is the fixed rule that picks one; the designs, and what bounds them, are
  in the sources.

They agree to 2e-5 in float32 and to 2e-2 in bfloat16 (the kernel rounds the
unnormalised probabilities to bfloat16 before ``p @ v``, the plain version
the normalised ones).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
MAX_HD = 256
VARIANTS = ("tensor_core", "simt")


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q [B,S,NH,hd], k/v [B,T,NKV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, nh, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or nh % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (batch, head dim, NH a multiple of NKV)")


# ------------------------------------------------------------ plain version
def flash_attention_torch(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0,
                          q_offset: int = 0) -> torch.Tensor:
    """The plain version: ``kernels/ref.py::flash_attention_ref`` in torch,
    query ``i`` at position ``q_offset + i``."""
    _check(q, k, v)
    f32 = torch.float32
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    qr = q.reshape(b, s, nkv, g, hd)
    sc = torch.einsum("bsngh,btnh->bngst", qr.to(f32), k.to(f32)) * hd ** -0.5
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    delta = (q_offset + torch.arange(s, device=q.device)[:, None]
             - torch.arange(t, device=q.device)[None, :])
    mask = torch.ones_like(delta, dtype=torch.bool)
    if causal:
        mask &= delta >= 0
    if window:
        mask &= delta < window
    sc = torch.where(mask, sc, torch.tensor(NEG_INF, dtype=f32,
                                            device=q.device))
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bngst,btnh->bsngh", p.to(v.dtype).to(f32), v.to(f32))
    return o.reshape(b, s, nh, hd).to(q.dtype)


# ------------------------------------------------------------------- kernel
def flash_attention_variant(dtype: torch.dtype, hd: int,
                            aligned: bool = True) -> str:
    """The kernel a CUDA call runs, by a fixed rule: ``"tensor_core"``
    (``csrc/flash_attention_tc.cu``) for bfloat16 with hd a multiple of 8
    and 16-byte aligned tensors (its copies are 16 bytes); ``"simt"``
    (``csrc/flash_attention.cu``) for everything else.  float32 never takes
    the tensor cores: they would compute in TF32."""
    if dtype == torch.bfloat16 and hd % 8 == 0 and aligned:
        return "tensor_core"
    return "simt"


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         q_offset: int = 0) -> torch.Tensor:
    """The CUDA kernel :func:`flash_attention_variant` names.  q, k, v are
    CUDA tensors of one type, float32 or bfloat16, ``hd <= 256``; they are
    made contiguous (the projections' reshapes already are).  Query ``i``
    is at position ``q_offset + i`` (a context-parallel slice), for the
    masks and the tile skipping alike.  Launches the kernel or raises."""
    from repro_torch.kernels import _build

    _check(q, k, v)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda wants CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k, v must share one type, float32 or bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    if hd > MAX_HD:
        raise ValueError(f"flash_attention_cuda takes hd <= {MAX_HD}, "
                         f"got {hd}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    dev = q.device
    variant = flash_attention_variant(
        q.dtype, hd,
        aligned=all(x.data_ptr() % 16 == 0 for x in (q, k, v, out)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, nh, nkv, hd, float(hd ** -0.5), int(causal),
            int(window), float(softcap), int(q_offset))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load()
    if variant == "tensor_core":
        err = lib.flash_attention_tc_launch(*args, dev.index or 0, stream)
    else:
        err = lib.flash_attention_launch(
            *args, int(q.dtype == torch.bfloat16), dev.index or 0, stream)
    _build.check(err, f"flash_attention ({variant})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_variant[variant] += 1
    if q_offset:
        flash_attention_cuda.launches_by_form["q_offset"] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
flash_attention_cuda.launches_by_form = {"q_offset": 0}
