"""Mamba-2 (SSD, state-space duality) block [arXiv:2405.21060] in torch.

The counterpart of the JAX package's ``models/mamba2.py``.  A prefill (with
or without a state to continue from) runs the chunked SSD scan as K8
(``kernels/ops.py::ssd_scan``, whose plain version is the JAX package's
``ssd_chunked`` in torch); decode (S == 1) is the O(1) recurrent update in
torch, as in the JAX package, which has no kernel for it.  The depthwise
causal convolution is shared with the RG-LRU block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import D, Params, model_dtype, rms_norm


def ssm_defs(cfg) -> dict:
    """Input projections split per component (z / x / BC / dt), as in the
    JAX package."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    return {
        "pre_norm": D((d,), init="zeros"),
        "in_z": D((d, di)),
        "in_x": D((d, di)),
        "in_bc": D((d, 2 * g * n)),
        "in_dt": D((d, nh)),
        "conv_x_w": D((cfg.conv_width, di)),
        "conv_x_b": D((di,), init="zeros"),
        "conv_bc_w": D((cfg.conv_width, 2 * g * n)),
        "conv_bc_b": D((2 * g * n,), init="zeros"),
        "A_log": D((nh,), init="zeros"),
        "D": D((nh,), init="ones"),
        "dt_bias": D((nh,), init="zeros"),
        "gate_norm": D((di,), init="zeros"),
        "out_proj": D((di, d)),
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


def ssm_apply(p: Params, x: torch.Tensor, cfg, state: dict | None = None):
    """Full Mamba-2 block with residual.  state:
      {"convx": [B,K-1,di], "convbc": [B,K-1,2gn], "ssd": [B,h,p,n]}.
    Returns (y, new_state)."""
    f32 = torch.float32
    dtype = model_dtype(cfg)
    B_, S, _ = x.shape
    di, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    nh, hp = cfg.ssm_nheads, cfg.ssm_headdim

    h = rms_norm(x, p.pre_norm)
    z = h @ p.in_z.to(h.dtype)
    xin = h @ p.in_x.to(h.dtype)
    bc = h @ p.in_bc.to(h.dtype)
    dt = h @ p.in_dt.to(h.dtype)
    cx = None if state is None else state["convx"]
    cbc = None if state is None else state["convbc"]
    xin, new_convx = causal_conv(xin, p.conv_x_w.to(dtype),
                                 p.conv_x_b.to(dtype), cx)
    bc, new_convbc = causal_conv(bc, p.conv_bc_w.to(dtype),
                                 p.conv_bc_b.to(dtype), cbc)
    Bm, Cm = torch.split(bc, [g * n, g * n], dim=-1)
    xh = xin.reshape(B_, S, nh, hp)
    Bm = Bm.reshape(B_, S, g, n)
    Cm = Cm.reshape(B_, S, g, n)
    dtv = F.softplus(dt.to(f32) + p.dt_bias)                  # [B,S,nh]
    A = -torch.exp(p.A_log.to(f32))                           # [nh]

    if state is None or S > 1:
        # prefill, from the cached state when there is one
        h0 = None if state is None else state["ssd"]
        y, ssd_state = ops.ssd_scan(xh, dtv, A, Bm, Cm, p.D.to(f32), h0,
                                    chunk=cfg.ssm_chunk)
    else:
        # recurrent decode: S == 1
        hg = nh // g
        dA = torch.exp(dtv[:, 0, :] * A)                      # [B,nh]
        Bh = Bm[:, 0].repeat_interleave(hg, dim=1)            # [B,nh,n]
        xdt = (xh[:, 0] * dtv[:, 0, :, None]).to(f32)
        new_h = (state["ssd"] * dA[:, :, None, None]
                 + torch.einsum("bhn,bhp->bhpn", Bh.to(f32), xdt))
        Ch = Cm[:, 0].repeat_interleave(hg, dim=1)            # [B,nh,n]
        y = torch.einsum("bhpn,bhn->bhp", new_h, Ch.to(f32))
        y = y + xh[:, 0].to(f32) * p.D.to(f32)[None, :, None]
        y = y[:, None].to(x.dtype)
        ssd_state = new_h

    y = y.reshape(B_, S, di)
    y = rms_norm(y * F.silu(z.to(f32)).to(y.dtype), p.gate_norm)
    out = y @ p.out_proj.to(y.dtype)
    new_state = {"convx": new_convx, "convbc": new_convbc, "ssd": ssd_state}
    return x + out, new_state


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
