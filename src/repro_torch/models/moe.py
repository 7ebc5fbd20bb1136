"""Mixture-of-Experts layer in torch: top-k router and capacity-based
dispatch on one card.

The counterpart of the JAX package's ``models/moe.py``, its ``_moe_local``
path: each token's ``top_k`` experts are ranked within their expert by one
stable argsort (``_rank_and_slot``); an expert keeps its first ``C`` tokens
(``_capacity``) and drops the rest; the kept tokens are scattered into an
``[E, C, d]`` buffer, every expert runs its gated MLP on its whole slab of
the buffer (``_expert_ffn``: batched products, ``torch.bmm``, as the JAX
package's ``einsum``s outside any Pallas kernel), and each token's outputs
are gathered back and weighted by its renormalised router probabilities.

So the same tokens are kept and dropped as in the JAX package, and a step
reads every expert's weights, even at a decode step of two tokens (C is at
least 8): that is the reference's semantics, kept.  Everything runs on the
device without a host sync (no ``.item()``, no data-dependent shapes):

* the dispatch writes each kept token to its own slot and each dropped one
  to a spare row past the buffer, so no slot is written twice and no
  atomic add is needed;
* the combine adds a token's ``top_k`` contributions in a fixed order, k
  = 0, 1, ..., in the activation type: what the JAX package's sequential
  scatter-add computes, and deterministic on the card, where
  ``index_add_`` would add in the order its atomics land.

The JAX package's expert-parallel path (``_moe_shard_map``: experts
sharded over a mesh axis, the buffers carried by all-to-all) is not
ported: the port runs on one card, and it comes with multi-device
planning.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import D, act_fn, rms_norm


def moe_defs(cfg) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "pre_norm": D((d,), init="zeros"),
        "router": D((d, e)),
        "w_gate": D((e, d, ff)),
        "w_up": D((e, d, ff)),
        "w_down": D((e, ff, d)),
    }


def _capacity(tokens: int, cfg) -> int:
    c = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def _rank_and_slot(flat_e: torch.Tensor, E: int, C: int):
    """flat_e [N] expert ids -> (keep [N], slot [N]) with rank-in-expert
    capacity dropping; one stable argsort, no [N, E] tensors."""
    N = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    # bincount would read the largest id back to the host; integer adds
    # are exact in any order
    counts = torch.zeros((E,), dtype=flat_e.dtype,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    ranks_sorted = (torch.arange(N, device=flat_e.device)
                    - starts[flat_e[order]])
    ranks = torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)
    keep = ranks < C
    slot = flat_e * C + torch.where(keep, ranks, torch.zeros_like(ranks))
    return keep, slot


def _route(p, h2: torch.Tensor, cfg):
    """h2 [T, d] -> (gate_vals [T, K], expert_idx [T, K], me [E], ce [E]):
    the renormalised top-k probabilities, their experts, and the aux
    loss's mean probability and assignment share per expert."""
    logits = h2.to(torch.float32) @ p.router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    me = probs.mean(dim=0)
    flat = expert_idx.reshape(-1)
    # every term is the same 1 / (T * K), so the atomics' order cannot
    # change the sums
    ce = torch.zeros((cfg.n_experts,), dtype=torch.float32,
                     device=h2.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / flat.numel(),
                            dtype=torch.float32, device=h2.device))
    return gate_vals, expert_idx, me, ce


def _expert_ffn(buf: torch.Tensor, p, cfg) -> torch.Tensor:
    """[E, C, d] -> [E, C, d]: every expert's gated MLP on its slab, the
    products in the buffer's type."""
    dt = buf.dtype
    a = act_fn(cfg.act)(torch.bmm(buf, p.w_gate.to(dt)))
    u = torch.bmm(buf, p.w_up.to(dt))
    return torch.bmm(a * u, p.w_down.to(dt))


def _dispatch_combine(p, h2: torch.Tensor, cfg):
    """Dispatch -> expert FFN -> combine on a [T, d] token block.  Returns
    (y [T, d] in h2's type, aux loss)."""
    T, d = h2.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    gate_vals, expert_idx, me, ce = _route(p, h2, cfg)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    flat_e = expert_idx.reshape(-1)                       # [T*K]
    keep, slot = _rank_and_slot(flat_e, E, C)
    tok = torch.arange(T, device=h2.device)[:, None].expand(T, K).reshape(-1)
    # a dropped assignment goes to the spare row E*C, which is cut off
    dest = torch.where(keep, slot, torch.full_like(slot, E * C))
    buf = torch.zeros((E * C + 1, d), dtype=h2.dtype,
                      device=h2.device).index_copy(0, dest, h2[tok])
    out = _expert_ffn(buf[:E * C].reshape(E, C, d), p, cfg).reshape(
        E * C, d)

    # keep the combine in the activation type, as the JAX package does
    w = torch.where(keep, gate_vals.reshape(-1),
                    torch.zeros_like(gate_vals.reshape(-1))).to(h2.dtype)
    gathered = (out[slot] * w[:, None]).reshape(T, K, d)
    y = gathered[:, 0]
    for k in range(1, K):
        y = y + gathered[:, k]
    return y, aux


def moe_apply(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y with residual, aux loss, a float32 scalar)."""
    B, S, d = x.shape
    h = rms_norm(x, p.pre_norm)
    y, aux = _dispatch_combine(p, h.reshape(B * S, d), cfg)
    return x + y.reshape(B, S, d).to(x.dtype), aux
