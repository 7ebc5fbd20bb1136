"""Mixture-of-Experts layer in torch: top-k router and capacity-based
dispatch on a device's rows.

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

The expert-parallel path, the JAX package's ``_moe_shard_map``, runs
with the experts split over a mesh's ``model`` axis (``tp``): each rank
keeps ``E / n`` experts ``[E/n, d, F]``, and the dispatch buffer
``[E, C, d]`` goes to the experts' owners by all-to-all and comes back
the same way.  When ``T % n == 0`` and ``T >= 8 n`` each rank routes its
``T / n`` slice of the rows with the capacity of that slice, and the
outputs are gathered (sequence-parallel dispatch); otherwise every rank
routes all of its rows (decode, or fewer than ``8 n`` rows); each rank
then sends the same tokens to each expert, so in the backward each copy
carries ``1 / n`` of the gradient, and the experts' and the router's
gradients come out as one process's, as the reference's do.  The aux
loss is the mean over the ``model`` ranks of theirs (``launch/steps.py``
averages it over the batch axes, as the reference's ``pmean``).  On a
mesh whose ``model`` axis is 1 each rank routes its own rows with the
capacity of its own tokens: the reference's path with n = 1.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import D, act_fn, on_shard, rms_norm


def moe_defs(cfg) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "pre_norm": D((d,), ("embed",), init="zeros"),
        "router": D((d, e), ("embed", "experts")),
        "w_gate": D((e, d, ff), ("experts", "embed", "ff")),
        "w_up": D((e, d, ff), ("experts", "embed", "ff")),
        "w_down": D((e, ff, d), ("experts", "ff", "embed")),
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


def _route(p, h2: torch.Tensor, cfg, router=None):
    """h2 [T, d] -> (gate_vals [T, K], expert_idx [T, K], me [E], ce [E]):
    the renormalised top-k probabilities, their experts, and the aux
    loss's mean probability and assignment share per expert."""
    router = p.router if router is None else router
    logits = h2.to(torch.float32) @ router.to(torch.float32)
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


def _dispatch_combine(p, h2: torch.Tensor, cfg, tp=None, router=None):
    """Dispatch -> expert FFN -> combine on a [T, d] token block.  Returns
    (y [T, d] in h2's type, aux loss).  With ``tp`` the experts are the
    rank's ``E / n`` and the buffer travels to them by all-to-all;
    ``router`` is then the whole router."""
    T, d = h2.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    gate_vals, expert_idx, me, ce = _route(p, h2, cfg, router)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    flat_e = expert_idx.reshape(-1)                       # [T*K]
    keep, slot = _rank_and_slot(flat_e, E, C)
    tok = torch.arange(T, device=h2.device)[:, None].expand(T, K).reshape(-1)
    # a dropped assignment goes to the spare row E*C, which is cut off
    dest = torch.where(keep, slot, torch.full_like(slot, E * C))
    buf = torch.zeros((E * C + 1, d), dtype=h2.dtype,
                      device=h2.device).index_copy(0, dest, h2[tok])
    buf = buf[:E * C].reshape(E, C, d)
    if tp is None:
        out = _expert_ffn(buf, p, cfg).reshape(E * C, d)
    else:
        # [E, C, d] -> the owners' [E/n, n*C, d] (slot blocks by source
        # rank), and back
        n, el = tp.n, E // tp.n
        got = tp.all_to_all(buf.reshape(n, el, C, d))
        y = _expert_ffn(got.transpose(0, 1).reshape(el, n * C, d), p, cfg)
        out = tp.all_to_all(y.reshape(el, n, C, d).transpose(0, 1)
                            ).reshape(E * C, d)

    # keep the combine in the activation type, as the JAX package does
    w = torch.where(keep, gate_vals.reshape(-1),
                    torch.zeros_like(gate_vals.reshape(-1))).to(h2.dtype)
    gathered = (out[slot] * w[:, None]).reshape(T, K, d)
    y = gathered[:, 0]
    for k in range(1, K):
        y = y + gathered[:, k]
    return y, aux


class _ShareOfGradient(torch.autograd.Function):
    """Forward identity; backward the gradient over ``n``: one of ``n``
    ranks' equal shares of a gradient that each of them computes whole."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def moe_apply(p, x: torch.Tensor, cfg, tp=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y with residual, aux loss, a float32 scalar).
    Under Megatron-SP (``tp.seq``) ``x`` is this rank's sequence shard:
    the normed shards are gathered, so the layer routes the same rows in
    the same order as without SP (capacity drops depend on that order),
    and the output keeps this rank's shard."""
    if tp is not None and tp.ff and not tp.experts:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_experts} experts on {tp.n} model ranks: "
            f"the plan splits the experts' ff instead, which has no path")
    sp = tp is not None and tp.seq
    h = rms_norm(x, on_shard(p.pre_norm, tp))
    if sp:
        h = tp.gather_shards(h, 1)
    B, S, d = h.shape
    h = h.reshape(B * S, d)
    if tp is None or not tp.experts:
        y, aux = _dispatch_combine(p, h, cfg)
        return x + y.reshape(B, S, d).to(x.dtype), aux
    T, n = B * S, tp.n
    router = tp.gather_shards(p.router, 1)
    if T % n == 0 and T >= 8 * n:
        # sequence-parallel dispatch: this rank's slice of the rows
        y, aux = _dispatch_combine(p, tp.slice(h if sp else tp.copy(h), 0),
                                   cfg, tp, router)
        y = tp.gather_shards(y, 0) if sp else tp.gather(y, 0)
        aux = tp.reduce(aux) / n
    elif sp:
        # whole rows on every rank, each rank's gradient only its shard's
        # positions' (the output is sliced below): the ranks' parts add
        # up; the aux loss, the same on every rank, takes 1/n a rank
        y, aux = _dispatch_combine(p, h, cfg, tp, router)
        aux = _ShareOfGradient.apply(aux, n)
    else:
        # whole rows on every rank, the same on each: every expert and the
        # router see each token n times, so each copy takes 1/n of the
        # gradient, and the rows enter through ``tp.copy``, whose sum
        # gives each rank the whole of theirs
        y, aux = _dispatch_combine(p, tp.copy(h), cfg, tp, router)
        y, aux = _ShareOfGradient.apply(y, n), _ShareOfGradient.apply(aux, n)
    y = y.reshape(B, S, d)
    if sp:
        y = tp.slice(y, 1)
    return x + y.to(x.dtype), aux
