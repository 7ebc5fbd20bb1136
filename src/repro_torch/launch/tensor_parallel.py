"""The collectives of a mesh run, and tensor parallelism over its
``model`` axis.

Two layers, both free of global state (a run passes its groups
explicitly, as ``launch/distributed.py::MeshRun`` does):

* **Transport.**  :func:`all_reduce`, :func:`all_gather`,
  :func:`reduce_scatter`, :func:`all_to_all` and :func:`broadcast` are each
  one ``torch.distributed`` call on a group, on whichever device the
  tensors are (gloo takes all five on CUDA tensors as well, which lets two
  ranks share one card).  A gather or reduce-scatter over a group of one
  rank exchanges nothing and makes no call: it is a copy on the device
  (FSDP reads its weights through a gather over ``data`` even where that
  axis is 1, and gloo would take each such copy through the host).  Every
  call's host seconds, bytes and calls add up in ``TRANSPORT`` (read and
  reset by the caller), so that the wall of a run across ranks can be
  split into the collectives and the rest; ``TRANSPORT["by_kind"]`` keeps
  the calls and bytes of each kind of collective (``KINDS``), the bytes
  counted as the JAX package's ``utils/hlo.py`` counts a compiled
  program's, as the *result's* bytes (an all-gather's whole output, a
  reduce-scatter's shard), beside the input's.  A step traced on fake
  ranks (``launch/dryrun.py::trace_cell``) reads its collectives from
  there.  The arithmetic stays where the tensors are.
* **Conjugate operators** (``torch.autograd.Function``s, Megatron's
  ``f`` / ``g`` pairs), through which a layer enters and leaves the part
  of its work that is split over ``model``:

  - :class:`CopyToModel`: forward identity, backward all-reduce.  Every
    tensor that is the same on all model ranks (an activation, or a
    replicated parameter) and is used by work split over them enters
    through it, so its gradient, a part a rank, is summed;
  - :class:`ReduceFromModel`: forward all-reduce, backward identity: the
    sum of the ranks' partial results (a row-parallel product);
  - :class:`GatherFromModel`: forward all-gather, backward this rank's
    slice: results split over the ranks, then used the same way by all
    (context-parallel outputs, the MoE's token slices, logits);
  - :class:`GatherShards`: forward all-gather, backward reduce-scatter:
    shards gathered for work that is itself split over the ranks (FSDP's
    weights over ``data``, the RG-LRU's gate blocks and the SSM's B / C
    over ``model``, and under Megatron-SP a block's sequence shards at its
    entry), whose gradient is a part a rank;
  - :class:`ReduceScatterToModel`: forward reduce-scatter, backward
    all-gather: the conjugate of ``GatherShards``, through which a block
    leaves its split work under Megatron-SP (the ranks' partial results
    summed, each rank keeping its shard of the sequence);
  - :class:`ScatterToModel`: forward this rank's slice, backward
    all-gather: a tensor that is the same on all ranks (the embedding of a
    vocabulary that is not split, an encoder's input) cut into the
    sequence shards of Megatron-SP;
  - :class:`AllToAll`: forward the exchange of equal slices, backward
    the reverse exchange.

:class:`ModelAxis` is a run's ``model`` group and which logical axes its
plan shards over it; the model code takes it as ``tp`` (None on a mesh
whose ``model`` axis is 1, and without a mesh).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

# the kinds of collective, by the names the JAX package's HLO gives them
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "broadcast")
TRANSPORT: dict = {}


def reset_transport() -> None:
    """Set ``TRANSPORT`` to 0: ``calls``, ``bytes`` (the inputs'),
    ``seconds`` (host), and ``by_kind``: ``{kind: {"calls", "bytes" (the
    results'), "input_bytes"}}`` for every kind of ``KINDS``."""
    TRANSPORT.update(calls=0, bytes=0, seconds=0.0, by_kind={
        k: {"calls": 0, "bytes": 0, "input_bytes": 0} for k in KINDS})


reset_transport()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _timed(kind: str, t: torch.Tensor, out: torch.Tensor, fn):
    """``fn()``, its host seconds, ``t``'s bytes (the input) and
    ``out``'s (the result) added to ``TRANSPORT`` under ``kind``."""
    t0 = time.perf_counter()
    fn()
    TRANSPORT["seconds"] += time.perf_counter() - t0
    TRANSPORT["calls"] += 1
    TRANSPORT["bytes"] += _nbytes(t)
    row = TRANSPORT["by_kind"][kind]
    row["calls"] += 1
    row["bytes"] += _nbytes(out)
    row["input_bytes"] += _nbytes(t)
    return out


def collectives_summary(transport: dict | None = None) -> dict:
    """The collectives of ``transport`` (default ``TRANSPORT``) with the
    keys of the JAX package's ``CollectiveReport.summary()``:
    ``total_bytes``, ``bytes`` and ``dynamic_count`` by kind (the kinds
    that made a call)."""
    rows = (transport or TRANSPORT)["by_kind"]
    used = {k: r for k, r in rows.items() if r["calls"]}
    return {"total_bytes": sum(r["bytes"] for r in used.values()),
            "bytes": {k: r["bytes"] for k, r in used.items()},
            "dynamic_count": {k: r["calls"] for k, r in used.items()}}


# ------------------------------------------------------------ transport
def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``t`` reduced over ``group``, in place; returns ``t``."""
    return _timed("all-reduce", t, t,
                  lambda: dist.all_reduce(t, op=op, group=group))


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    return _timed("broadcast", t, t,
                  lambda: dist.broadcast(t, src, group=group))


def all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in rank order."""
    if n == 1:
        return t.contiguous().clone()
    part = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * part.shape[0], *part.shape[1:]),
                      dtype=part.dtype, device=part.device)
    _timed("all-gather", part, out,
           lambda: dist.all_gather_into_tensor(out, part, group=group))
    return out.movedim(0, dim).contiguous() if dim else out


def reduce_scatter(t: torch.Tensor, dim: int, group, n: int
                   ) -> torch.Tensor:
    """``t`` summed over ``group``; this rank's ``1/n`` of ``dim``."""
    if n == 1:
        return t.contiguous().clone()
    full = t.movedim(dim, 0).contiguous()
    out = torch.empty((full.shape[0] // n, *full.shape[1:]),
                      dtype=full.dtype, device=full.device)
    _timed("reduce-scatter", full, out,
           lambda: dist.reduce_scatter_tensor(out, full, group=group))
    return out.movedim(0, dim).contiguous() if dim else out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Slice ``i`` of ``t``'s first dimension (``n`` equal slices) to rank
    ``i``; the result's slice ``j`` from rank ``j``."""
    t = t.contiguous()
    out = torch.empty_like(t)
    return _timed("all-to-all", t, out,
                  lambda: dist.all_to_all_single(out, t, group=group))


def all_gather_list(t: torch.Tensor, group, n: int) -> list:
    """The ranks' ``t`` (one shape), a list in rank order."""
    return list(all_gather(t[None], 0, group, n).unbind(0))


# ------------------------------------------------ the conjugate operators
class CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.dim, ctx.n, ctx.rank = dim, n, rank
        return all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        k = g.shape[ctx.dim] // ctx.n
        return (g.narrow(ctx.dim, ctx.rank * k, k).contiguous(), None, None,
                None, None)


class GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return all_gather(shard, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None


class ReduceScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return reduce_scatter(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group, ctx.n), None, None, None


class ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        k = x.shape[dim] // n
        return x.narrow(dim, rank * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g, ctx.dim, ctx.group, ctx.n), None, None, None,
                None)


class AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


# ------------------------------------------------------------ the axis
@dataclass(frozen=True, eq=False)
class ModelAxis:
    """A mesh run's ``model`` group (``n`` ranks, this one ``rank``) and
    what its plan splits over it: attention heads, kv heads, the MLP's
    ``ff`` (the recurrent and SSM blocks' widths too), the vocabulary,
    the experts.  ``seq_cache``: kv heads stay whole and ``model`` is not
    a batch axis, so a decode cache whose length ``n`` divides is split
    by sequence (``launch/sharding.py::cache_pspecs``).  ``cp``:
    context-parallel prefill attention where the heads are not split.

    ``seq``: Megatron-SP, the JAX package's ``set_mesh_axes(...,
    seq_shard=True)``: the residual stream between blocks is split by
    sequence over the ranks, ``[B, S / n, d]`` on each.  A run sets it for
    the whole model; the model narrows it to each stream it runs
    (:meth:`on_sequence`: a sequence of one token, or one that ``n`` does
    not divide, stays whole, as XLA leaves such a dimension), so inside a
    block ``tp.seq`` says that the block's input and output are shards.

    ``batch_axis``: the rows of the run's global batch have a batch axis
    (the JAX package's ``hidden_batch_axes`` is not None for it;
    ``MeshRun.rows`` sets it).  With it, and ``n`` dividing the experts,
    the MoE runs expert-parallel, as the reference's rule is; ``experts``
    and ``ff`` only say where the plan placed the weights."""
    group: object
    n: int
    rank: int
    heads: bool
    kv: bool
    ff: bool
    vocab: bool
    experts: bool
    seq_cache: bool
    cp: bool
    seq: bool = False
    batch_axis: bool = True

    def on_sequence(self, length: int) -> "ModelAxis":
        """This axis for a stream of ``length`` positions: ``seq`` kept
        where the ranks split the length into equal shards of it, else
        off."""
        keep = self.seq and length > 1 and length % self.n == 0
        return self if keep == self.seq else replace(self, seq=keep)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return CopyToModel.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return ReduceFromModel.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return GatherFromModel.apply(x, dim % x.ndim, self.group, self.n,
                                     self.rank)

    def gather_shards(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return GatherShards.apply(x, dim % x.ndim, self.group, self.n)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return ReduceScatterToModel.apply(x, dim % x.ndim, self.group,
                                          self.n)

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return ScatterToModel.apply(x, dim % x.ndim, self.group, self.n,
                                    self.rank)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return AllToAll.apply(x, self.group)

    def gather_list(self, x: torch.Tensor) -> list:
        """The ranks' ``x`` (one shape), a list in rank order (no
        gradient)."""
        return all_gather_list(x.detach().contiguous(), self.group, self.n)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the ranks (no gradient)."""
        return all_reduce(x.detach().contiguous().clone(), self.group,
                          dist.ReduceOp.MAX)

    def slice(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's ``1/n`` of ``dim``."""
        k = x.shape[dim] // self.n
        return x.narrow(dim, self.rank * k, k)
