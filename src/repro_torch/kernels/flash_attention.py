"""Flash attention (prefill from position 0) in PyTorch and CUDA.

``q [B, S, NH, hd]``, ``k, v [B, T, NKV, hd]`` -> ``[B, S, NH, hd]``, the
JAX package's layout: softmax attention with query and key positions both
counted from 0, optional causal mask, sliding window (``window > 0``: only
keys with ``0 <= i - j < window``), gemma-2 logit soft-capping and GQA / MQA
(query head ``h`` reads kv head ``h // (NH // NKV)``).  It is what every
prefill of an attention layer computes (``models/transformer.py::
attn_apply``).

Two implementations of the same function:

* :func:`flash_attention_torch` -- the plain version, the JAX package's
  oracle ``kernels/ref.py::flash_attention_ref`` in torch: it materialises
  the float32 score matrix.
* :func:`flash_attention_cuda` -- the hand-written kernel
  (``csrc/flash_attention.cu``), which replaces the TPU kernel
  ``repro/kernels/flash_attention.py::_kernel``: online softmax over key
  tiles with whole masked tiles skipped; the design, and what bounds it,
  are in the source.

They agree to 2e-5 in float32 and to 2e-2 in bfloat16 (the kernel rounds the
unnormalised probabilities to bfloat16 before ``p @ v``, the plain version
the normalised ones).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
MAX_HD = 256


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
                          softcap: float = 0.0) -> torch.Tensor:
    """The plain version: ``kernels/ref.py::flash_attention_ref`` in torch."""
    _check(q, k, v)
    f32 = torch.float32
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    qr = q.reshape(b, s, nkv, g, hd)
    sc = torch.einsum("bsngh,btnh->bngst", qr.to(f32), k.to(f32)) * hd ** -0.5
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    delta = (torch.arange(s, device=q.device)[:, None]
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
def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """The CUDA kernel (``csrc/flash_attention.cu``).  q, k, v are CUDA
    tensors of one type, float32 or bfloat16, ``hd <= 256``; they are made
    contiguous (the projections' reshapes already are).  Launches the
    kernel or raises."""
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
    lib = _build.load()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, t, nh, nkv, hd, float(hd ** -0.5), int(causal), int(window),
        float(softcap), int(q.dtype == torch.bfloat16), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
