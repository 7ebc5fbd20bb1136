"""Serving and training across ranks: data parallelism and FSDP over a
mesh whose ``model`` axis is 1.

A :class:`MeshRun` is what ``serve(..., mesh=)`` and ``train(...,
mesh=)`` (``launch/serve.py``, ``launch/train.py``) run with, inside a
process group that the caller has initialised (:func:`init_ranks` from
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, as ``torchrun`` sets them; the
tests start each rank as a subprocess over gloo and a ``file://`` store).
It takes the plan (``launch/sharding.py``) on the mesh description
(``launch/mesh.py``) and builds the mesh's ``DeviceMesh``:

* **Rows.** The batch dimension is placed by the plan's ``batch_spec``:
  each rank takes its rows of the global batch (:meth:`MeshRun.rows`), a
  global batch made from the same seed as a one-process run, so together
  the ranks compute what one process computes.  A rank's rows follow its
  coordinate over the batch axes, row-major.
* **Data parallelism.** Each rank's loss is weighted by its share of the
  batch's counted labels, so the gradients summed over the ranks are the
  global batch's.  The replicated parameters' gradients are summed by one
  all-reduce over the ranks.
* **FSDP.** A parameter whose spec maps a dimension to ``data`` (the
  ``embed`` axis under ``plan.fsdp``) is held as the rank's shard of that
  dimension.  The model is built on the ``meta`` device and placed leaf
  by leaf (:meth:`MeshRun.place_init`, :meth:`MeshRun.place_loaded`):
  each full leaf is made (or read from the host), narrowed to the shard
  and dropped before the next, so a rank's device holds, beside its
  shards, the full tensors of one leaf at a time.  Reading a sharded parameter (``p.wq`` in the
  model's code) all-gathers it over the ``data`` ranks
  (``torch.nn.utils.parametrize``; the gather is an ``autograd.Function``
  whose backward reduce-scatters the gradient over the same ranks), so a
  layer gathers its weights when it runs, and again in its recomputation
  under ``remat``; nothing keeps the full weights between layers.  The
  sharded gradients are then summed over ``pod``.  AdamW's ``m`` and
  ``v`` are made from the shards, so they are sharded with them; the
  global gradient norm sums the shards' squares over ``data``, leaf by
  leaf in the same order as one process.  A checkpoint gathers one leaf
  at a time to rank 0's host (:meth:`MeshRun.host_tensors`).
* **Serving** runs the same gathers, each rank its rows and its rows'
  cache (``cache_pspecs`` places the cache by the batch alone when the
  model axis is 1); the generated tokens and logits are gathered.

A mesh whose ``model`` axis is above 1 raises ``NotImplementedError``:
tensor parallelism over ``model`` (the ``tp`` and ``hybrid`` rules for
heads, ``ff`` and vocab), context-parallel attention (``cp_attention``),
the expert-parallel MoE (``_moe_shard_map``) and ``compressed_psum`` over
``pod`` are ROADMAP queue 1 item 3.  So does a config with experts on any
mesh: each rank would route its own rows with capacity from its own
tokens, which nothing holds against the reference yet.  There is no
global mesh state (the JAX package's ``set_mesh_axes``): the run is
passed explicitly, and the reference's ``shard_hidden`` is the identity
on a rank's local rows.
"""
from __future__ import annotations

import math
import os
import re

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.launch.sharding import ShardingPlan, make_plan, shard_shape
from repro_torch.models.layers import Params, init_leaf

_PARAM = re.compile(r"(^|\.)parametrizations\.(\w+)\.original$")


def param_name(name: str) -> str:
    """A ``named_parameters`` name without FSDP's wrapping:
    ``layers.0.attn.parametrizations.wq.original`` -> ``layers.0.attn.wq``
    (unchanged for a parameter that is not sharded)."""
    return _PARAM.sub(r"\1\2", name)


def check_mesh(mesh: Mesh) -> None:
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"mesh {mesh.shape}: a model axis above 1 (tensor parallelism "
            f"over 'model', cp_attention, _moe_shard_map, compressed_psum "
            f"over 'pod') is not ported yet: ROADMAP queue 1 item 3")


class _AllGather(torch.autograd.Function):
    """Forward: the shards of ``group``'s ranks, concatenated along
    ``dim``.  Backward: the gradient reduce-scattered (summed) along
    ``dim`` over the same ranks."""

    @staticmethod
    def forward(ctx, shard, dim: int, group, n: int):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        part = shard.movedim(dim, 0).contiguous()
        out = torch.empty((n * part.shape[0], *part.shape[1:]),
                          dtype=part.dtype, device=part.device)
        dist.all_gather_into_tensor(out, part, group=group)
        return out.movedim(0, dim).contiguous() if dim else out

    @staticmethod
    def backward(ctx, g):
        full = g.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((full.shape[0] // ctx.n, *full.shape[1:]),
                          dtype=full.dtype, device=full.device)
        dist.reduce_scatter_tensor(out, full, group=ctx.group)
        return (out.movedim(0, ctx.dim).contiguous() if ctx.dim else out,
                None, None, None)


class _Gather(nn.Module):
    """The parametrization of a sharded parameter: the full tensor."""

    def __init__(self, dim: int, group, n: int):
        super().__init__()
        self.dim, self.group, self.n = dim, group, n

    def forward(self, shard):
        return _AllGather.apply(shard, self.dim, self.group, self.n)


def _data_dim(spec: tuple) -> int | None:
    """The dimension a spec maps to the ``data`` axis, if any."""
    for i, ax in enumerate(spec):
        if ax == "data" or (isinstance(ax, tuple) and "data" in ax):
            return i
    return None


class MeshRun:
    """A mesh run's plan, device mesh, groups and this rank's place in
    them.  Every method that communicates is collective: all ranks call
    it, in the same order."""

    def __init__(self, cfg, mesh: Mesh, plan: ShardingPlan | None,
                 device):
        check_mesh(mesh)
        if cfg.n_experts:
            raise NotImplementedError(
                f"{cfg.name}: a config with experts on a mesh (each rank "
                f"routing its own rows, _moe_shard_map) is not ported yet: "
                f"ROADMAP queue 1 item 3")
        self.mesh = mesh
        self.plan = plan or make_plan(cfg, mesh)
        self.device = torch.device(device)
        self.device_mesh = device_mesh(mesh, self.device.type)
        self.coord = dict(zip(mesh.axis_names,
                              self.device_mesh.get_coordinate()))
        self.world = mesh.size
        self.rank = dist.get_rank()
        self.groups = {a: self.device_mesh.get_group(a)
                       for a in mesh.axis_names}
        self.specs: dict = {}

    # ------------------------------------------------------------- rows
    def _batch_axes(self, global_batch: int) -> tuple:
        bp = self.plan.batch_spec(self.mesh, global_batch)
        if not bp:
            return ()
        return bp[0] if isinstance(bp[0], tuple) else (bp[0],)

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch."""
        idx, n = 0, 1
        for a in self._batch_axes(global_batch):
            idx = idx * self.mesh.shape[a] + self.coord[a]
            n *= self.mesh.shape[a]
        per = global_batch // n
        return slice(idx * per, (idx + 1) * per)

    def replicas(self, global_batch: int) -> int:
        """How many ranks hold the same rows."""
        return self.world // math.prod(self.mesh.shape[a] for a in
                                       self._batch_axes(global_batch))

    def gather_rows(self, t: torch.Tensor, global_batch: int
                    ) -> torch.Tensor:
        """The global batch's rows of a per-rank result (its first
        dimension), in row order, on every rank."""
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        out, seen = [], set()
        for r in range(self.world):
            coord = dict(zip(self.mesh.axis_names, self._coordinate(r)))
            idx = 0
            for a in self._batch_axes(global_batch):
                idx = idx * self.mesh.shape[a] + coord[a]
            if idx not in seen:
                seen.add(idx)
                out.append((idx, parts[r]))
        return torch.cat([p for _, p in sorted(out, key=lambda x: x[0])])

    def _coordinate(self, rank: int) -> tuple:
        return tuple(int(i) for i in np.unravel_index(rank,
                                                      self.mesh.dims))

    # ------------------------------------------------------------- FSDP
    def place_init(self, model, seed: int) -> None:
        """:meth:`place` with the weights ``Model.init_weights(seed)``
        gives one process: the same ``torch.Generator`` on this rank's
        device draws the full leaves in the same order."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)

        def leaf(_name, d, like):
            return init_leaf(torch.empty(d.shape, dtype=like.dtype,
                                         device=self.device), d, gen)
        self.place(model, leaf)

    def place_loaded(self, model, tensors: dict) -> None:
        """:meth:`place` with the weights of ``tensors`` (a ``state_dict``
        of the unsharded model, best on the host: only this rank's shard
        of each is copied to the device)."""
        self.place(model, lambda name, _d, _like: tensors[name])

    def place(self, model, leaf) -> None:
        """Give a model built on the ``meta`` device its parameters on
        this rank, one leaf at a time in registration order (that of
        ``init_params``): ``leaf(name, param_def, meta_param)`` returns the
        full tensor, on any device.  Each parameter is a copy of it on
        this rank's device; one whose spec maps a dimension to ``data`` a
        copy of this rank's shard of it, read through an all-gather.  The
        full tensor is dropped before the next leaf."""
        specs = model.pspecs(self.plan.rules)
        group, n = self.groups.get("data"), self.mesh.shape.get("data", 1)
        for prefix, mod in list(model.named_modules()):
            if not isinstance(mod, Params):
                continue
            for name, d in mod.defs.items():
                full = f"{prefix}.{name}" if prefix else name
                spec = specs[full]
                self._check_spec(full, spec)
                like = mod._parameters[name]
                t = leaf(full, d, like)
                dim = _data_dim(spec)
                if dim is not None:
                    t = self._narrow(t, dim)
                mod._parameters[name] = nn.Parameter(torch.empty(
                    t.shape, dtype=like.dtype, device=self.device).copy_(t),
                    requires_grad=False)
                del t
                if dim is not None:
                    parametrize.register_parametrization(
                        mod, name, _Gather(dim, group, n), unsafe=True)
                    self.specs[full] = dim

    def _narrow(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's shard of ``t`` along ``dim`` over ``data`` (a view;
        a dimension ``data`` does not divide raises ``ValueError``)."""
        k = shard_shape(t.shape, (None,) * dim + ("data",), self.mesh)[dim]
        return t.narrow(dim, self.coord["data"] * k, k)

    def _check_spec(self, name: str, spec: tuple) -> None:
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None and a != "data" and self.mesh.shape[a] > 1:
                    raise NotImplementedError(
                        f"{name}: spec {spec} shards over {a!r}; only "
                        f"'data' is ported (ROADMAP queue 1 item 3)")

    def host_tensors(self, tensors: dict) -> dict | None:
        """``{name: tensor}`` of parameter shards (or of tensors sharded
        as they are, AdamW's ``m`` and ``v``) -> the full tensors on rank
        0's host, None on the other ranks.  One leaf at a time: a sharded
        leaf is all-gathered, copied to the host on rank 0 and dropped
        before the next, so a rank's device holds, beside its shards, the
        gather of one leaf at a time."""
        out = {} if self.rank == 0 else None
        for name, t in tensors.items():
            dim = self.specs.get(name)
            full = t.detach() if dim is None else _AllGather.apply(
                t.detach(), dim, self.groups["data"],
                self.mesh.shape["data"])
            if out is not None:
                out[name] = full.to("cpu", copy=True)
            del full
        return out

    def shard_tensors(self, tensors: dict) -> dict:
        """The inverse of :meth:`host_tensors`: this rank's shards, on its
        device (each copied there from wherever ``tensors`` are)."""
        out = {}
        for name, t in tensors.items():
            dim = self.specs.get(name)
            if dim is not None:
                t = self._narrow(t, dim)
            out[name] = torch.empty(t.shape, dtype=t.dtype,
                                    device=self.device).copy_(t)
        return out

    # ------------------------------------------------------- gradients
    def reduce_grads(self, names: list, grads: list) -> list:
        """Sum the per-rank gradients in place: the replicated parameters'
        over all ranks (one all-reduce of them flattened); the sharded
        ones, which the gather's backward summed over ``data``, over
        ``pod``."""
        rep = [i for i, n in enumerate(names) if n not in self.specs]
        shd = [i for i, n in enumerate(names) if n in self.specs]
        for idx, group in ((rep, None), (shd, self.groups.get("pod"))):
            if not idx or (idx is shd and group is None):
                continue
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=group)
            start = 0
            for i in idx:
                n = grads[i].numel()
                grads[i].copy_(flat[start:start + n].view_as(grads[i]))
                start += n
        return grads

    def grad_norm(self, names: list, grads: list) -> torch.Tensor:
        """The global gradient norm: each leaf's sum of squares (the
        shards' summed over ``data``), added in the leaves' order."""
        sq = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
        shd = [i for i, n in enumerate(names) if n in self.specs]
        if shd:
            part = torch.stack([sq[i] for i in shd])
            dist.all_reduce(part, group=self.groups["data"])
            for j, i in enumerate(shd):
                sq[i] = part[j]
        total = None
        for s in sq:
            total = s if total is None else total + s
        return torch.sqrt(total)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t)
        return t

    def any(self, flag: bool) -> bool:
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index or 0])
        else:
            dist.barrier()


def parameters_by_name(model) -> dict:
    """``{name: parameter}`` of a model, sharded or not, by the names of
    an unsharded one (:func:`param_name`)."""
    return {param_name(n): p for n, p in model.named_parameters()}


def init_ranks(store: str | None = None, device: str | None = None):
    """Join the process group of the ranks ``torchrun`` (or a test) starts:
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` from the environment;
    ``store`` an ``init_method`` (``file:///path`` or ``tcp://host:port``;
    default ``env://``, ``MASTER_ADDR`` / ``MASTER_PORT``).  NCCL on
    ``cuda:LOCAL_RANK`` unless ``device="cpu"`` (gloo).  Returns the
    rank's device; :func:`close_ranks` leaves the group."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device == "cpu":
        dev = torch.device("cpu")
        dist.init_process_group("gloo", init_method=store or "env://",
                                rank=rank, world_size=world)
    else:
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=store or "env://",
                                rank=rank, world_size=world, device_id=dev)
    return dev


def close_ranks() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def ranks_from_env() -> bool:
    """Whether this process was started as one rank of several."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ
