"""Attention in torch: blocked (online-softmax) and plain, and the KV cache.

The counterpart of the JAX package's ``models/attention.py``.  A prefill
from position 0 does not come here: it runs K6 (``kernels/ops.py::
flash_attention``).  What stays here is what the JAX package computes in
plain XLA around it: :func:`blocked_attention` (online softmax over key
chunks, with absolute key positions for ring caches) for the decode step
against a ring cache, and :func:`plain_attention` (materialising the
scores) for the decode step against a linear cache and for a forward
without cache.  Both support GQA, causal and sliding-window masks, gemma-2
soft-capping and offset query positions.

Over a mesh's ``model`` axis (``launch/tensor_parallel.py::ModelAxis``,
``tp``): :func:`cp_attention`, the context-parallel prefill (each rank
K6 on its slice of the queries from its offset, the outputs gathered);
and the decode cache split by sequence over the ranks, which is never
gathered: :func:`cache_update` writes each new entry into the rank that
owns its slot, and :func:`sharded_decode_attention` merges the ranks'
partial softmaxes over their own slots by log-sum-exp.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def _chunk_size(t: int) -> int:
    for c in (512, 256, 128, 64, 32, 16, 8):
        if t % c == 0:
            return c
    return t


def _mask(q_pos, k_pos, causal: bool, window: int):
    delta = q_pos[:, None] - k_pos[None, :]
    mask = torch.ones_like(delta, dtype=torch.bool)
    if causal:
        mask &= delta >= 0
    if window:
        mask &= delta < window
    return mask


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: int = 0, causal: bool = True,
                      window: int = 0, softcap_val: float = 0.0,
                      kv_len: int | None = None,
                      k_positions: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """q [B,S,NH,hd]; k,v [B,T,NKV,hd] -> [B,S,NH,hd].

    q_offset: absolute position of q[0].  k_positions: absolute position
    per key slot [T] (ring caches; empty slots carry a huge position so the
    causal mask drops them), default arange(T).  window > 0: only keys with
    0 <= q_pos - k_pos < window attend.  kv_len: number of valid cache
    entries (linear caches)."""
    f32 = torch.float32
    B, S, NH, hd = q.shape
    _, T, NKV, _ = k.shape
    G = NH // NKV
    dev = q.device
    qr = q.reshape(B, S, NKV, G, hd).permute(0, 2, 3, 1, 4)   # B,NKV,G,S,hd
    kr = k.permute(0, 2, 1, 3)                                 # B,NKV,T,hd
    vr = v.permute(0, 2, 1, 3)
    scale = hd ** -0.5
    C = _chunk_size(T)
    q_pos = q_offset + torch.arange(S, device=dev)
    kp_all = torch.arange(T, device=dev) if k_positions is None \
        else k_positions
    m = torch.full((B, NKV, G, S), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, NKV, G, S), dtype=f32, device=dev)
    acc = torch.zeros((B, NKV, G, S, hd), dtype=f32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    for start in range(0, T, C):
        kc = kr[:, :, start:start + C]
        vc = vr[:, :, start:start + C]
        s = torch.einsum("bngsh,bnth->bngst", qr.to(f32), kc.to(f32)) * scale
        if softcap_val:
            s = softcap_val * torch.tanh(s / softcap_val)
        mask = _mask(q_pos, kp_all[start:start + C], causal, window)
        if kv_len is not None:
            mask &= (start + torch.arange(C, device=dev) < kv_len)[None, :]
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bngst,bnth->bngsh", p.to(vc.dtype).to(f32), vc.to(f32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, NH, hd).to(q.dtype)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int = 0, causal: bool = True, window: int = 0,
                    softcap_val: float = 0.0,
                    kv_len: int | None = None) -> torch.Tensor:
    """Reference attention materialising the score matrix; the decode step
    against a linear cache (``kv_len`` valid entries)."""
    f32 = torch.float32
    B, S, NH, hd = q.shape
    _, T, NKV, _ = k.shape
    G = NH // NKV
    dev = q.device
    qr = q.reshape(B, S, NKV, G, hd)
    s = torch.einsum("bsngh,btnh->bngst", qr.to(f32), k.to(f32)) \
        * (hd ** -0.5)
    if softcap_val:
        s = softcap_val * torch.tanh(s / softcap_val)
    k_pos = torch.arange(T, device=dev)
    mask = _mask(q_offset + torch.arange(S, device=dev), k_pos, causal,
                 window)
    if kv_len is not None:
        mask &= (k_pos < kv_len)[None, :]
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=f32, device=dev))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", p.to(v.dtype).to(f32), v.to(f32))
    return out.reshape(B, S, NH, hd).to(q.dtype)


# ----------------------------------------------------------------- KV cache
def init_kv_cache(batch: int, max_len: int, n_kv: int, hd: int,
                  dtype=torch.bfloat16, device="cpu") -> dict:
    return {
        "k": torch.zeros((batch, max_len, n_kv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv, hd), dtype=dtype,
                         device=device),
    }


def cache_update(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int, ring: bool = False, shard=None) -> dict:
    """Insert S_new entries at position ``pos`` (ring buffer when the cache
    holds only a sliding window).  If more new entries arrive than the ring
    holds, only the trailing window is written (earlier ones would be
    overwritten anyway).  Unlike the JAX package, which returns new arrays,
    the cache's tensors are written in place (a cache is as large as the
    model's weights at long contexts); the same dict is returned.

    ``shard=(r, n)``: the cache holds slots ``r * L .. (r + 1) * L - 1`` of
    ``n * L`` (split by sequence); only the entries of those slots are
    written, the ring's wrapped ones included.  Which entries those are
    follows from ``pos`` and the lengths, host numbers, so nothing waits on
    the device."""
    r, n = shard or (0, 1)
    local = cache["k"].shape[1]
    max_len = local * n
    s_new = k_new.shape[1]
    if s_new > max_len:
        k_new = k_new[:, -max_len:]
        v_new = v_new[:, -max_len:]
        pos = pos + (s_new - max_len)
        s_new = max_len
    # host arithmetic in numpy: no tensor of a shape that depends on
    # values, so a step traced on fake tensors runs it too
    idx = pos + np.arange(s_new)
    if ring:
        idx = idx % max_len
    if n > 1:
        own = (idx >= r * local) & (idx < (r + 1) * local)
        src = torch.from_numpy(np.nonzero(own)[0]).to(k_new.device)
        idx = idx[own] - r * local
        k_new, v_new = k_new[:, src], v_new[:, src]
    idx = torch.from_numpy(idx).to(cache["k"].device)
    cache["k"][:, idx] = k_new.to(cache["k"].dtype)
    cache["v"][:, idx] = v_new.to(cache["v"].dtype)
    return cache


def cp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tp, *,
                 causal: bool = True, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """Context-parallel attention of a prefill from position 0 (the JAX
    package's ``cp_attention``): q, k, v are whole on every rank of
    ``tp``; rank ``i`` runs K6 on its ``S / n`` queries from position
    ``i * S / n`` against all the keys, and the outputs are gathered.  The
    causal mask leaves the later ranks more keys: rank ``i`` attends to
    about ``(i + 1/2) S / n`` of them (the reference's schedule)."""
    from repro_torch.kernels import ops

    chunk = q.shape[1] // tp.n
    mine = q[:, tp.rank * chunk:(tp.rank + 1) * chunk].contiguous()
    out = ops.flash_attention(mine, k, v, causal=causal, window=window,
                              softcap=softcap, q_offset=tp.rank * chunk)
    return tp.gather(out, 1)


def sharded_decode_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, tp, *, q_pos: int,
                             k_pos: torch.Tensor, valid: torch.Tensor,
                             causal: bool = True, window: int = 0,
                             softcap_val: float = 0.0) -> torch.Tensor:
    """A decode step against a cache split by sequence over ``tp``'s
    ranks: q [B, S, NH, hd] (every head the cache's kv heads serve);
    k, v [B, L, NKV, hd] this rank's slots, at absolute positions
    ``k_pos`` [L], ``valid`` [L] (slots written so far).  Each rank computes
    the softmax's running max, sum and weighted values over its slots for
    every head; one all-gather brings every rank's, which are merged in
    rank order by log-sum-exp.  The cache is never gathered."""
    f32 = torch.float32
    B, S, NH, hd = q.shape
    NKV = k.shape[2]
    G = NH // NKV
    dev = q.device
    qr = q.reshape(B, S, NKV, G, hd)
    s = torch.einsum("bsngh,btnh->bngst", qr.to(f32), k.to(f32)) \
        * (hd ** -0.5)
    if softcap_val:
        s = softcap_val * torch.tanh(s / softcap_val)
    mask = _mask(q_pos + torch.arange(S, device=dev), k_pos, causal,
                 window) & valid[None, :]
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=f32, device=dev))
    m = s.amax(dim=-1)                                     # B,NKV,G,S
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    acc = torch.einsum("bngst,btnh->bngsh", p.to(v.dtype).to(f32),
                       v.to(f32))
    part = torch.cat([acc, p.sum(dim=-1)[..., None], m[..., None]], dim=-1)
    parts = tp.gather_list(part)
    top = torch.stack([x[..., -1] for x in parts]).amax(dim=0)
    num = torch.zeros_like(acc)
    den = torch.zeros_like(m)
    for x in parts:
        w = torch.exp(x[..., -1] - top)
        num = num + w[..., None] * x[..., :hd]
        den = den + w * x[..., hd]
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, NH, hd).to(q.dtype)


def ring_positions(pos: int, max_len: int, device="cpu") -> torch.Tensor:
    """Absolute position held by each slot of a ring cache of size
    ``max_len`` after ``pos`` tokens (positions 0..pos-1) were written:
    slot s holds p = (pos-1) - ((pos-1-s) mod max_len); p < 0 means the
    slot is empty and is pushed to +inf so the causal mask drops it."""
    slot = torch.arange(max_len, device=device)
    p = (pos - 1) - torch.remainder(pos - 1 - slot, max_len)
    return torch.where(p >= 0, p, torch.full_like(p, 10**9))
