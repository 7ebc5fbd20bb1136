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

On a mesh whose ``model`` axis is above 1 (``tp``) the layer chooses as
the JAX package's ``moe_apply`` does, from the run and not from the plan:
the expert-parallel path, its ``_moe_shard_map``, when the rows have a
batch axis (``tp.batch_axis``, the reference's ``hidden_batch_axes``) and
``n`` divides ``E``; otherwise its ``_moe_local``, every rank routing
all of its rows with their capacity, the same on each rank.  Where the
weights sit is the plan's (``launch/sharding.py``), and each path takes
them as they were placed:

* **Expert-parallel.**  Each rank runs ``E / n`` experts ``[E/n, d, F]``
  and the dispatch buffer ``[E, C, d]`` goes to the experts' owners by
  all-to-all and comes back the same way.  Experts the plan split over
  ``model`` are the rank's already; experts it replicated are narrowed to
  the rank's (``tp.scatter``: its backward gathers the whole gradient);
  experts it split on ``ff`` are exchanged once, ``[E, d, F/n]`` into
  ``[E/n, d, F]`` (``tp.all_to_all``, whose backward is the reverse): what
  the reference's ``shard_map`` ``in_specs`` do on every call.  When
  ``T % n == 0`` and ``T >= 8 n`` each rank routes its ``T / n`` slice of
  the rows with the capacity of that slice, and the outputs are gathered
  (sequence-parallel dispatch); otherwise every rank routes all of its
  rows (decode, or fewer than ``8 n`` rows), each rank sends the same
  tokens to each expert, so in the backward each copy carries ``1 / n``
  of the gradient.  The aux loss is the mean over the ``model`` ranks of
  theirs (``launch/steps.py`` averages it over the batch axes, as the
  reference's ``pmean``).
* **Local.**  Every rank routes and dispatches all of its rows, the same
  on each, then runs the experts as they were placed: split on ``ff``,
  ``[E, C, d] x [E, d, F/n]`` on its slice, the partial down products
  summed over ``model`` before the combine (the contraction GSPMD reduces
  in the reference); split by expert, its ``E / n`` slabs of the buffer,
  gathered; replicated, all of them.  The routing is computed whole on
  every rank, so only the dispatched buffer enters the split work through
  ``tp.copy``.

On a mesh whose ``model`` axis is 1 each rank routes its own rows with
the capacity of its own tokens: the reference's path with n = 1.
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


def _weights(p) -> tuple:
    return p.w_gate, p.w_up, p.w_down


def _expert_ffn(buf: torch.Tensor, w: tuple, cfg) -> torch.Tensor:
    """[E', C, d] -> [E', C, d]: every expert's gated MLP on its slab, the
    products in the buffer's type; ``w`` is ``(w_gate [E', d, F'], w_up,
    w_down [E', F', d])``.  With ``F'`` a slice of ``ff`` the result is
    that slice's part of the down product."""
    dt = buf.dtype
    wg, wu, wd = w
    a = act_fn(cfg.act)(torch.bmm(buf, wg.to(dt)))
    u = torch.bmm(buf, wu.to(dt))
    return torch.bmm(a * u, wd.to(dt))


def _dispatch_combine(p, h2: torch.Tensor, cfg, experts=None,
                      router=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch -> experts -> combine on a [T, d] token block.  Returns (y
    [T, d] in h2's type, aux loss).  ``experts`` maps the dispatch buffer
    ``[E, C, d]`` to its outputs (default: every expert of ``p`` on its
    slab); ``router`` is ``p.router`` unless given."""
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
    out = (_expert_ffn(buf, _weights(p), cfg) if experts is None
           else experts(buf)).reshape(E * C, d)

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


def _ff_to_experts(w: torch.Tensor, tp, ff_dim: int) -> torch.Tensor:
    """Experts split on ``ff`` (``[E, d, F/n]``, or ``[E, F/n, d]`` with
    ``ff_dim`` 1) -> this rank's ``E / n`` experts whole, by one
    all-to-all (backward: the reverse)."""
    n = tp.n
    got = tp.all_to_all(w.reshape(n, w.shape[0] // n, *w.shape[1:]))
    # got[j] is rank j's ff slice of this rank's experts: put the slices
    # in rank order along ff
    got = got.movedim(0, ff_dim)
    shape = list(w.shape)
    shape[0] //= n
    shape[ff_dim] *= n
    return got.reshape(shape)


def _expert_parallel(p, h: torch.Tensor, cfg, tp):
    """The reference's ``_moe_shard_map`` on this rank's rows ``h`` [T, d]
    (under SP gathered whole): (y [T, d], aux)."""
    T, n, sp = h.shape[0], tp.n, tp.seq
    if tp.experts:
        w = _weights(p)
        router = tp.gather_shards(p.router, 1)
    else:
        w = ((_ff_to_experts(p.w_gate, tp, 2), _ff_to_experts(p.w_up, tp, 2),
              _ff_to_experts(p.w_down, tp, 1)) if tp.ff
             else tuple(tp.scatter(t, 0) for t in _weights(p)))
        # each rank's share of the router's gradient is a part
        router = tp.copy(p.router)

    def experts(buf):
        # [E, C, d] -> the owners' [E/n, n*C, d] (slot blocks by source
        # rank), and back
        E, C, d = buf.shape
        el = E // n
        got = tp.all_to_all(buf.reshape(n, el, C, d))
        y = _expert_ffn(got.transpose(0, 1).reshape(el, n * C, d), w, cfg)
        return tp.all_to_all(y.reshape(el, n, C, d).transpose(0, 1))

    if T % n == 0 and T >= 8 * n:
        # sequence-parallel dispatch: this rank's slice of the rows
        y, aux = _dispatch_combine(p, tp.slice(h if sp else tp.copy(h), 0),
                                   cfg, experts, router)
        return (tp.gather_shards(y, 0) if sp else tp.gather(y, 0),
                tp.reduce(aux) / n)
    if sp:
        # whole rows on every rank, each rank's gradient only its shard's
        # positions' (the output is sliced): the ranks' parts add up; the
        # aux loss, the same on every rank, takes 1/n a rank
        y, aux = _dispatch_combine(p, h, cfg, experts, router)
        return y, _ShareOfGradient.apply(aux, n)
    # whole rows on every rank, the same on each: every expert and the
    # router see each token n times, so each copy takes 1/n of the
    # gradient, and the rows enter through ``tp.copy``, whose sum gives
    # each rank the whole of theirs
    y, aux = _dispatch_combine(p, tp.copy(h), cfg, experts, router)
    return _ShareOfGradient.apply(y, n), _ShareOfGradient.apply(aux, n)


def _ff_sum(part: torch.Tensor, tp) -> torch.Tensor:
    """The ranks' partial down products of an ``ff`` split summed.  Under
    SP each rank's gradient of the sum is a part (its shard's positions),
    so the backward sums them too."""
    out = tp.reduce(part)
    return tp.copy(out) if tp.seq else out


def _local(p, h: torch.Tensor, cfg, tp):
    """The reference's ``_moe_local`` on this rank's rows ``h`` [T, d]
    (under SP gathered whole), every rank routing all of them alike, the
    experts as the plan placed them: (y [T, d], aux).

    Without SP each rank's gradient is the whole one: the split work's
    parts of the buffer's gradient are summed by ``tp.copy``, a gathered
    router's is this rank's slice.  Under SP each rank's gradient is its
    shard's part, summed where the shards were gathered: the buffer enters
    as it is, the sums' and gathers' backwards sum, and the aux loss takes
    1/n a rank."""
    sp, w = tp.seq, _weights(p)
    if tp.experts:
        router = (tp.gather_shards if sp else tp.gather)(p.router, 1)
    else:
        router = on_shard(p.router, tp)

    def experts(buf):
        if not (tp.experts or tp.ff):
            # replicated (a hybrid plan, so never under SP): all of them
            return _expert_ffn(buf, w, cfg)
        buf = buf if sp else tp.copy(buf)
        if tp.experts:
            out = _expert_ffn(tp.slice(buf, 0), w, cfg)
            return tp.gather_shards(out, 0) if sp else tp.gather(out, 0)
        return _ff_sum(_expert_ffn(buf, w, cfg), tp)

    y, aux = _dispatch_combine(p, h, cfg, experts, router)
    return y, (_ShareOfGradient.apply(aux, tp.n) if sp else aux)


def moe_apply(p, x: torch.Tensor, cfg, tp=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y with residual, aux loss, a float32 scalar).
    Under Megatron-SP (``tp.seq``) ``x`` is this rank's sequence shard:
    the normed shards are gathered, so the layer routes the same rows in
    the same order as without SP (capacity drops depend on that order),
    and the output keeps this rank's shard."""
    sp = tp is not None and tp.seq
    h = rms_norm(x, on_shard(p.pre_norm, tp))
    if sp:
        h = tp.gather_shards(h, 1)
    B, S, d = h.shape
    h = h.reshape(B * S, d)
    if tp is None:
        y, aux = _dispatch_combine(p, h, cfg)
        return x + y.reshape(B, S, d).to(x.dtype), aux
    # the reference's rule: experts over the model axis iff the rows have
    # a batch axis and the axis divides the experts
    ep = tp.batch_axis and cfg.n_experts % tp.n == 0
    y, aux = (_expert_parallel if ep else _local)(p, h, cfg, tp)
    y = y.reshape(B, S, d)
    if sp:
        y = tp.slice(y, 1)
    return x + y.to(x.dtype), aux
