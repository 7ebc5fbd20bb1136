"""Mamba-2 (SSD, state-space duality) block [arXiv:2405.21060] in torch.

The counterpart of the JAX package's ``models/mamba2.py``.  A prefill (with
or without a state to continue from) runs the chunked SSD scan as K8
(``kernels/ops.py::ssd_scan``, whose plain version is the JAX package's
``ssd_chunked`` in torch); decode (S == 1) is the O(1) recurrent update in
torch, as in the JAX package, which has no kernel for it.  The depthwise
causal convolution is shared with the RG-LRU block.

With the heads split over a mesh's ``model`` axis (``tp``, the ``ff``
rule): ``in_z``, ``in_x`` and ``in_dt`` are column-parallel (a rank's
slice of ``d_inner`` is its heads), ``out_proj`` row-parallel, and the
state the rank's heads'.  ``in_bc``'s columns are split too, so B and C
(which every head reads) are gathered after the convolution of the
rank's channels; ``A_log``, ``D`` and ``dt_bias`` are whole and sliced
to the rank's heads; the gate norm's sum of squares over the whole
``d_inner`` is all-reduced.  K8 then scans the rank's heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (D, Params, block_in, block_out,
                                       model_dtype, on_shard, rms_norm)


def ssm_defs(cfg) -> dict:
    """Input projections split per component (z / x / BC / dt), as in the
    JAX package."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    return {
        "pre_norm": D((d,), ("embed",), init="zeros"),
        "in_z": D((d, di), ("embed", "ff")),
        "in_x": D((d, di), ("embed", "ff")),
        "in_bc": D((d, 2 * g * n), ("embed", "ff")),
        "in_dt": D((d, nh), ("embed", "ff")),
        "conv_x_w": D((cfg.conv_width, di), (None, "ff")),
        "conv_x_b": D((di,), ("ff",), init="zeros"),
        "conv_bc_w": D((cfg.conv_width, 2 * g * n), (None, "ff")),
        "conv_bc_b": D((2 * g * n,), ("ff",), init="zeros"),
        "A_log": D((nh,), (None,), init="zeros"),
        "D": D((nh,), (None,), init="ones"),
        "dt_bias": D((nh,), (None,), init="zeros"),
        "gate_norm": D((di,), ("ff",), init="zeros"),
        "out_proj": D((di, d), ("ff", "embed")),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: torch.Tensor | None = None):
    """x [B,S,Cd]; w [K,Cd] depthwise causal conv; state [B,K-1,Cd] carries
    the last K-1 inputs for decode.  Returns (silu(y), new_state); the new
    state is a copy, so a cache does not hold the whole padded input."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # [B,S+K-1,Cd]
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):].clone() if K > 1 else pad
    return F.silu(y), new_state


def ssm_apply(p: Params, x: torch.Tensor, cfg, state: dict | None = None,
              tp=None):
    """Full Mamba-2 block with residual.  state:
      {"convx": [B,K-1,di], "convbc": [B,K-1,2gn], "ssd": [B,h,p,n]}
    (di, 2gn and h the rank's under ``tp``).  Under Megatron-SP
    (``tp.seq``) ``x`` is this rank's sequence shard: normed there,
    gathered for the block and its output reduce-scattered back.
    Returns (y, new_state)."""
    f32 = torch.float32
    dtype = model_dtype(cfg)
    split = tp is not None and tp.ff
    k = tp.n if split else 1
    di, g, n = cfg.d_inner // k, cfg.ssm_ngroups, cfg.ssm_state
    nh, hp = cfg.ssm_nheads // k, cfg.ssm_headdim

    hh = block_in(rms_norm(x, on_shard(p.pre_norm, tp)), tp, split)
    B_, S, _ = hh.shape
    z = hh @ p.in_z.to(hh.dtype)
    xin = hh @ p.in_x.to(hh.dtype)
    bc = hh @ p.in_bc.to(hh.dtype)
    dt = hh @ p.in_dt.to(hh.dtype)
    cx = None if state is None else state["convx"]
    cbc = None if state is None else state["convbc"]
    xin, new_convx = causal_conv(xin, p.conv_x_w.to(dtype),
                                 p.conv_x_b.to(dtype), cx)
    bc, new_convbc = causal_conv(bc, p.conv_bc_w.to(dtype),
                                 p.conv_bc_b.to(dtype), cbc)
    A_log, D_, dt_bias = p.A_log, p.D, p.dt_bias
    if split:
        bc = tp.gather_shards(bc, -1)
        A_log, D_, dt_bias = (tp.slice(tp.copy(t), 0)
                              for t in (A_log, D_, dt_bias))
    Bm, Cm = torch.split(bc, [g * n, g * n], dim=-1)
    xh = xin.reshape(B_, S, nh, hp)
    Bm = Bm.reshape(B_, S, g, n)
    Cm = Cm.reshape(B_, S, g, n)
    if split and g > 1:
        # the groups of the rank's heads
        per = cfg.ssm_nheads // g
        lo, hi = tp.rank * nh // per, ((tp.rank + 1) * nh - 1) // per + 1
        Bm, Cm, g = Bm[:, :, lo:hi], Cm[:, :, lo:hi], hi - lo
    dtv = F.softplus(dt.to(f32) + dt_bias)                    # [B,S,nh]
    A = -torch.exp(A_log.to(f32))                             # [nh]

    if state is None or S > 1:
        # prefill, from the cached state when there is one
        h0 = None if state is None else state["ssd"]
        y, ssd_state = ops.ssd_scan(xh, dtv, A, Bm, Cm, D_.to(f32), h0,
                                    chunk=cfg.ssm_chunk)
    else:
        # recurrent decode: S == 1 (a rank's heads are whole groups)
        hg = max(nh // g, 1)
        dA = torch.exp(dtv[:, 0, :] * A)                      # [B,nh]
        Bh = Bm[:, 0].repeat_interleave(hg, dim=1)            # [B,nh,n]
        xdt = (xh[:, 0] * dtv[:, 0, :, None]).to(f32)
        new_h = (state["ssd"] * dA[:, :, None, None]
                 + torch.einsum("bhn,bhp->bhpn", Bh.to(f32), xdt))
        Ch = Cm[:, 0].repeat_interleave(hg, dim=1)            # [B,nh,n]
        y = torch.einsum("bhpn,bhn->bhp", new_h, Ch.to(f32))
        y = y + xh[:, 0].to(f32) * D_.to(f32)[None, :, None]
        y = y[:, None].to(x.dtype)
        ssd_state = new_h

    y = y.reshape(B_, S, di)
    y = y * F.silu(z.to(f32)).to(y.dtype)
    y = (rms_norm(y, p.gate_norm) if not split
         else _split_rms_norm(y, p.gate_norm, tp, cfg.d_inner))
    out = y @ p.out_proj.to(y.dtype)
    if split:
        out = block_out(out.to(f32), tp, x.dtype)
    new_state = {"convx": new_convx, "convbc": new_convbc, "ssd": ssd_state}
    return x + out, new_state


def _split_rms_norm(x: torch.Tensor, scale: torch.Tensor, tp, width: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """``layers.py::rms_norm`` over a width split over ``tp``'s ranks: the
    sum of squares all-reduced (and copied back into the split work, so
    its gradient is summed too)."""
    dt = x.dtype
    x = x.to(torch.float32)
    ss = tp.copy(tp.reduce(torch.sum(x * x, dim=-1, keepdim=True)))
    y = x * torch.rsqrt(ss / width + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dt)


def init_ssm_state(cfg, batch: int, device="cpu") -> dict:
    di, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    dt = model_dtype(cfg)
    return {
        "convx": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dt,
                             device=device),
        "convbc": torch.zeros((batch, cfg.conv_width - 1, 2 * g * n),
                              dtype=dt, device=device),
        "ssd": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim, n),
                           dtype=torch.float32, device=device),
    }
