"""Serving and training across ranks: data parallelism, FSDP and tensor
parallelism over a mesh's ``pod``, ``data`` and ``model`` axes.

A :class:`MeshRun` is what ``serve(..., mesh=)`` and ``train(...,
mesh=)`` (``launch/serve.py``, ``launch/train.py``) run with, inside a
process group that the caller has initialised (:func:`init_ranks` from
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, as ``torchrun`` sets them; the
tests start each rank as a subprocess over gloo and a ``file://`` store,
``chip_smoke.py``'s phase 10 two and three ranks on one card, over
gloo).  It takes the plan (``launch/sharding.py``) on the mesh description
(``launch/mesh.py``), and makes one process group an axis and a
coordinate of the other axes (rank ``r`` at the mesh's row-major
coordinate ``r``).  Every collective goes through
``launch/tensor_parallel.py``: one ``torch.distributed`` call each, on
the tensors' own device.

* **Rows.** The batch dimension is placed by the plan's ``batch_spec``
  (over ``pod`` and ``data``, never ``model``): each rank takes its rows
  of the global batch (:meth:`MeshRun.rows`), a global batch made from the
  same seed as a one-process run, so together the ranks compute what one
  process computes.  The ranks of one ``model`` group hold the same rows.
* **Placement.** The model is built on the ``meta`` device and placed
  leaf by leaf (:meth:`MeshRun.place_init`, :meth:`MeshRun.place_loaded`):
  each full leaf is made (or read from the host), narrowed to this rank's
  shard on every dimension its spec maps to an axis, and dropped before
  the next, so a rank holds exactly the bytes ``dryrun.shard_bytes``
  gives (a decode cache too, :meth:`MeshRun.init_cache`).
* **FSDP.** A dimension mapped to ``data`` (the ``embed`` axis under
  ``plan.fsdp``) is read through an all-gather over ``data``
  (``torch.nn.utils.parametrize``; ``tensor_parallel.GatherShards``,
  whose backward reduce-scatters the gradient), so a layer gathers its
  weights when it runs, and again in its recomputation under ``remat``.
  A leaf that is also split over ``model`` gathers over ``data`` inside
  its model shard.
* **Tensor parallelism.** A dimension mapped to ``model`` stays split:
  the model code takes the run's ``tensor_parallel.ModelAxis`` (``tp``)
  and runs its share (Megatron's column- and row-parallel products, with
  explicit collectives on the ``model`` group): the vocabulary-parallel
  embedding, logits and cross entropy; attention on the local heads (kv
  heads that the axis does not divide are computed whole and the ones
  the local heads read are taken); K7's partial sum over the local
  ``ff`` slice, summed in float32 before the sandwich norm and the
  residual; the RG-LRU's and the SSM block's width by heads; the MoE by
  the reference's rule (``models/moe.py``: expert-parallel, the dispatch
  buffers carried by all-to-all, where the rows have a batch axis and
  the axis divides the experts; else every rank routing all its rows,
  the experts split as the plan placed them, on ``ff`` or by expert).  A
  decode cache whose kv heads stay whole is split by sequence: each rank
  writes the entries of its slots and attends over them, and the step's
  partial softmaxes are merged by log-sum-exp (``models/attention.py``).
  ``cp=True`` runs a prefill's attention context-parallel where the heads
  are not split.  ``seq_shard=True`` (under a ``tp`` plan; ignored
  under a hybrid one, as the JAX package's ``dryrun.run_cell`` ignores
  it) is Megatron-SP, the JAX package's ``set_mesh_axes(...,
  seq_shard=True)``: the residual stream between blocks is split by
  sequence over ``model``, so each block enters its split work through
  an all-gather of the sequence and leaves it through a reduce-scatter
  where it would all-reduce (``models/layers.py::block_in`` /
  ``block_out``); a decode step, and a sequence that the axis does not
  divide, keep the replicated stream.  The results are the same: only
  where the sums are made moves.
* **Gradients.** Each rank's loss is weighted by its share of the
  batch's counted labels (and the MoE's aux loss by its share of the row
  shards), so the gradients summed over the ranks of other rows are the
  global batch's: the leaves that are whole over ``data`` are summed over
  ``data`` and ``pod``, the ``data`` shards (summed over ``data`` by the
  gather's backward) over ``pod``.  Over ``model`` nothing is summed: the
  conjugate operators already made every gradient whole or this rank's
  shard of it.  AdamW's ``m`` and ``v`` are made from the shards, so they
  are sharded with them; the global gradient norm sums the shards'
  squares over the axes that split them, leaf by leaf in the same order
  as one process.  A checkpoint gathers one leaf at a time to rank 0's
  host (:meth:`MeshRun.host_tensors`).
* **Serving** returns the generated tokens and logits of the whole batch
  on every rank.

There is no global mesh state (the JAX package's ``set_mesh_axes``): the
run is passed explicitly, the model holds its ``tp``, and the
reference's ``shard_hidden`` is the identity on a rank's local rows
(with ``seq_shard``, the split of the stream by sequence that the
model's ``tp.seq`` carries out).
"""
from __future__ import annotations

import itertools
import math
import os
import re
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from repro_torch.launch import tensor_parallel as tpc
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import (ShardingPlan, cache_pspecs,
                                         hidden_batch_axes, make_plan,
                                         shard_shape)
from repro_torch.models.layers import Params, init_leaf, model_dtype

_PARAM = re.compile(r"(^|\.)parametrizations\.(\w+)\.original$")


def param_name(name: str) -> str:
    """A ``named_parameters`` name without FSDP's wrapping:
    ``layers.0.attn.parametrizations.wq.original`` -> ``layers.0.attn.wq``
    (unchanged for a parameter that is not sharded)."""
    return _PARAM.sub(r"\1\2", name)


class _Gather(nn.Module):
    """The parametrization of a parameter sharded over ``data``: its
    ``data`` shards gathered."""

    def __init__(self, dim: int, group, n: int):
        super().__init__()
        self.dim, self.group, self.n = dim, group, n

    def forward(self, shard):
        return tpc.GatherShards.apply(shard, self.dim, self.group, self.n)


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (
        () if entry is None else (entry,))


def _data_dim(spec: tuple) -> int | None:
    """The dimension a spec maps to the ``data`` axis, if any."""
    for i, ax in enumerate(spec):
        if "data" in _axes(ax):
            return i
    return None


class MeshRun:
    """A mesh run's plan, groups and this rank's place in them.  Every
    method that communicates is collective: all ranks call it, in the
    same order."""

    def __init__(self, cfg, mesh: Mesh, plan: ShardingPlan | None,
                 device, cp: bool = False, seq_shard: bool = False):
        if dist.get_world_size() != mesh.size:
            raise ValueError(f"mesh {mesh.dims} needs {mesh.size} ranks, the "
                             f"process group has {dist.get_world_size()}")
        self.cfg = cfg
        self.mesh = mesh
        self.plan = plan or make_plan(cfg, mesh)
        self.device = torch.device(device)
        self.world = mesh.size
        self.rank = dist.get_rank()
        self.coord = dict(zip(mesh.axis_names, self._coordinate(self.rank)))
        self.groups = self._axis_groups()
        self.specs: dict = {}         # name -> spec of a sharded parameter
        self.model = None             # the model placed on this run
        n = mesh.shape.get("model", 1)
        rules = self.plan.rules
        self.tp = None if n == 1 else tpc.ModelAxis(
            group=self.groups["model"], n=n, rank=self.coord["model"],
            heads=rules.get("heads") == "model",
            kv=rules.get("kv") == "model", ff=rules.get("ff") == "model",
            vocab=rules.get("vocab") == "model",
            experts=rules.get("experts") == "model",
            seq_cache=rules.get("kv") != "model", cp=cp,
            seq=seq_shard and self.plan.kind == "tp")

    def _axis_groups(self) -> dict:
        """``{axis: the group of this rank's line along it}``: every rank
        makes every line's group, in the same order."""
        names, dims = self.mesh.axis_names, self.mesh.dims
        out = {}
        for i, a in enumerate(names):
            others = [range(d) if j != i else [None]
                      for j, d in enumerate(dims)]
            for rest in itertools.product(*others):
                ranks = [int(np.ravel_multi_index(
                    tuple(k if j == i else rest[j]
                          for j in range(len(dims))), dims))
                    for k in range(dims[i])]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    out[a] = group
        return out

    def _coordinate(self, rank: int) -> tuple:
        return tuple(int(i) for i in np.unravel_index(rank,
                                                      self.mesh.dims))

    # ------------------------------------------------------------- rows
    def _batch_axes(self, global_batch: int) -> tuple:
        bp = self.plan.batch_spec(self.mesh, global_batch)
        return _axes(bp[0]) if bp else ()

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch.  The run's model axis, and
        that of the model it placed, then say whether these rows have a
        batch axis (``ModelAxis.batch_axis``: the JAX package sets its
        ``hidden_batch_axes`` from a run's global batch), which the MoE's
        choice of path reads."""
        if self.tp is not None:
            self.tp = replace(self.tp, batch_axis=hidden_batch_axes(
                self.plan, self.mesh, global_batch) is not None)
            if self.model is not None:
                self.model.tp = self.tp
        idx, n = 0, 1
        for a in self._batch_axes(global_batch):
            idx = idx * self.mesh.shape[a] + self.coord[a]
            n *= self.mesh.shape[a]
        per = global_batch // n
        return slice(idx * per, (idx + 1) * per)

    def row_shards(self, global_batch: int) -> int:
        """How many shards the rows are split into."""
        return math.prod(self.mesh.shape[a]
                         for a in self._batch_axes(global_batch))

    def replicas(self, global_batch: int) -> int:
        """How many ranks of one ``model`` coordinate hold the same
        rows."""
        dp = math.prod(self.mesh.shape.get(a, 1) for a in ("pod", "data"))
        return dp // self.row_shards(global_batch)

    def gather_rows(self, t: torch.Tensor, global_batch: int
                    ) -> torch.Tensor:
        """The global batch's rows of a per-rank result (its first
        dimension), in row order, on every rank."""
        parts = tpc.all_gather_list(t.contiguous(), None, self.world)
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

    # -------------------------------------------------------- placement
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
        full tensor, on any device.  Each parameter is a copy of this
        rank's shard of it (the whole tensor where its spec maps no
        dimension to an axis); one whose spec maps a dimension to ``data``
        is read through an all-gather.  The full tensor is dropped before
        the next leaf.  The model then takes the run's ``tp``."""
        specs = model.pspecs(self.plan.rules)
        group, n = self.groups.get("data"), self.mesh.shape.get("data", 1)
        for prefix, mod in list(model.named_modules()):
            if not isinstance(mod, Params):
                continue
            for name, d in mod.defs.items():
                full = f"{prefix}.{name}" if prefix else name
                spec = specs[full]
                like = mod._parameters[name]
                t = self._narrow(leaf(full, d, like), spec)
                mod._parameters[name] = nn.Parameter(torch.empty(
                    t.shape, dtype=like.dtype, device=self.device).copy_(t),
                    requires_grad=False)
                del t
                dim = _data_dim(spec)
                if dim is not None:
                    parametrize.register_parametrization(
                        mod, name, _Gather(dim, group, n), unsafe=True)
                if self._split_dims(spec):
                    self.specs[full] = spec
        model.tp = self.tp
        self.model = model

    def _split_dims(self, spec: tuple) -> list:
        """``[(dim, axis)]`` of a parameter spec: every ``data`` dimension
        (FSDP gathers it even on one rank), and ``model`` where the axis
        is above 1."""
        out = []
        for i, ax in enumerate(spec):
            for a in _axes(ax):
                if a == "data" or self.mesh.shape.get(a, 1) > 1:
                    out.append((i, a))
        return out

    def _narrow(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's shard of ``t`` under ``spec`` (a view; a dimension
        its axes do not divide raises ``ValueError``)."""
        shape = shard_shape(t.shape, spec, self.mesh)
        for i, ax in enumerate(spec):
            idx = 0
            for a in _axes(ax):
                idx = idx * self.mesh.shape[a] + self.coord[a]
            if shape[i] != t.shape[i]:
                t = t.narrow(i, idx * shape[i], shape[i])
        return t

    def init_cache(self, model, global_batch: int, max_len: int) -> dict:
        """This rank's shard of the decode cache of ``global_batch`` rows
        (``cache_pspecs``): its rows, and where the plan splits them its
        kv heads, sequence slots, widths or heads; zeros, as
        ``Model.init_cache``."""
        from repro_torch.models.transformer import stack_cache

        cfg = model.cfg
        full = {"layers": stack_cache(cfg, global_batch, max_len,
                                      model_dtype(cfg), "meta"), "pos": 0}
        specs = cache_pspecs(full, self.mesh, global_batch, self.plan)

        def walk(node, spec):
            if isinstance(node, dict):
                return {k: walk(v, spec[k]) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v, s) for v, s in zip(node, spec)]
            if not isinstance(node, torch.Tensor):
                return node
            return torch.zeros(shard_shape(node.shape, spec, self.mesh),
                               dtype=node.dtype, device=self.device)
        return walk(full, specs)

    # ------------------------------------------------------ whole leaves
    def full_tensor(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole of a leaf held as this rank's shard under the spec of
        parameter ``name`` (a parameter, or AdamW's ``m`` / ``v`` of it),
        on every rank."""
        out = t.detach()
        for dim, a in self._split_dims(self.specs.get(name, ())):
            out = tpc.all_gather(out, dim, self.groups[a],
                                 self.mesh.shape[a])
        return out

    def host_tensors(self, tensors: dict) -> dict | None:
        """``{name: tensor}`` of parameter shards (or of tensors sharded
        as they are, AdamW's ``m`` and ``v``) -> the full tensors on rank
        0's host, None on the other ranks.  One leaf at a time: a sharded
        leaf is all-gathered, copied to the host on rank 0 and dropped
        before the next, so a rank's device holds, beside its shards, the
        gather of one leaf at a time."""
        out = {} if self.rank == 0 else None
        for name, t in tensors.items():
            full = self.full_tensor(name, t)
            if out is not None:
                out[name] = full.to("cpu", copy=True)
            del full
        return out

    def shard_tensors(self, tensors: dict) -> dict:
        """The inverse of :meth:`host_tensors`: this rank's shards, on its
        device (each copied there from wherever ``tensors`` are)."""
        out = {}
        for name, t in tensors.items():
            t = self._narrow(t, self.specs.get(name, ()))
            out[name] = torch.empty(t.shape, dtype=t.dtype,
                                    device=self.device).copy_(t)
        return out

    # ------------------------------------------------------- gradients
    def _dp_groups(self, with_data: bool) -> list:
        axes = (("data", "pod") if with_data else ("pod",))
        return [self.groups[a] for a in axes
                if self.mesh.shape.get(a, 1) > 1]

    def reduce_grads(self, names: list, grads: list) -> list:
        """Sum the per-rank gradients over the ranks of other rows, in
        place: the leaves whole over ``data`` over ``data`` and ``pod``
        (one all-reduce of them flattened an axis), the ``data`` shards,
        which the gather's backward summed over ``data``, over ``pod``."""
        shd = [i for i, n in enumerate(names)
               if _data_dim(self.specs.get(n, ())) is not None]
        rep = [i for i in range(len(names)) if i not in set(shd)]
        for idx, groups in ((rep, self._dp_groups(True)),
                            (shd, self._dp_groups(False))):
            if not idx or not groups:
                continue
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            for group in groups:
                tpc.all_reduce(flat, group)
            start = 0
            for i in idx:
                n = grads[i].numel()
                grads[i].copy_(flat[start:start + n].view_as(grads[i]))
                start += n
        return grads

    def grad_norm(self, names: list, grads: list) -> torch.Tensor:
        """The global gradient norm: each leaf's sum of squares (a sharded
        leaf's summed over the axes that split it), added in the leaves'
        order."""
        sq = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
        for a in ("data", "model"):
            idx = [i for i, n in enumerate(names)
                   if any(ax == a for _, ax in
                          self._split_dims(self.specs.get(n, ())))]
            if idx:
                part = torch.stack([sq[i] for i in idx])
                tpc.all_reduce(part, self.groups[a])
                for j, i in enumerate(idx):
                    sq[i] = part[j]
        total = None
        for s in sq:
            total = s if total is None else total + s
        return torch.sqrt(total)

    def dp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks of other rows (``data``, ``pod``);
        the ranks of one ``model`` group hold the same value."""
        t = t.clone()
        for group in self._dp_groups(True):
            tpc.all_reduce(t, group)
        return t

    def any(self, flag: bool) -> bool:
        t = torch.tensor([int(flag)], device=self.device)
        tpc.all_reduce(t, None, dist.ReduceOp.MAX)
        return bool(t.item())

    def barrier(self) -> None:
        if self.device.type == "cuda" and dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index or 0])
        else:
            dist.barrier()


def parameters_by_name(model) -> dict:
    """``{name: parameter}`` of a model, sharded or not, by the names of
    an unsharded one (:func:`param_name`)."""
    return {param_name(n): p for n, p in model.named_parameters()}


def init_ranks(store: str | None = None, device: str | None = None,
               backend: str | None = None):
    """Join the process group of the ranks ``torchrun`` (or a test) starts:
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` from the environment;
    ``store`` an ``init_method`` (``file:///path`` or ``tcp://host:port``;
    default ``env://``, ``MASTER_ADDR`` / ``MASTER_PORT``).  The rank's
    device is the host with ``device="cpu"``, else ``cuda:LOCAL_RANK``;
    ``backend`` is NCCL on the card and gloo on the host unless given
    (gloo on the card runs ranks that share one, which NCCL refuses).
    Returns the device; :func:`close_ranks` leaves the group."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device == "cpu":
        dev = torch.device("cpu")
        dist.init_process_group(backend or "gloo",
                                init_method=store or "env://",
                                rank=rank, world_size=world)
        return dev
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    backend = backend or "nccl"
    dist.init_process_group(
        backend, init_method=store or "env://", rank=rank, world_size=world,
        **({"device_id": dev} if backend == "nccl" else {}))
    return dev


def close_ranks() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def ranks_from_env() -> bool:
    """Whether this process was started as one rank of several."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ
