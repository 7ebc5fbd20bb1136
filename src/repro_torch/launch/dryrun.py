"""Dry-run: what every (architecture x input shape) cell holds on each
device of a production mesh, whether it fits, and what its step costs
-- without devices.

    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes --trace

The counterpart of the JAX package's ``launch/dryrun.py``, in two halves.

**Analytic** (:func:`run_cell`).  For each cell of
``configs.valid_cells()`` it takes the cell's plan on the mesh
(``launch/sharding.py``) and counts the per-device bytes of what a step
takes as arguments: the parameters (float32 for a train step, bfloat16
to serve), AdamW's ``m`` and ``v`` (train), the decode cache (prefill,
decode) and the batch, each shard's shape by ``sharding.shard_shape``.
The shapes come from a model and a cache on the ``meta`` device, so
nothing is allocated.  Beside them: ``model_flops`` (6 N D to train, 2 N
D to serve) and the per-device FLOPs and bytes of
``utils/costmodel.py::cell_cost``, attributed as the JAX package
attributes them, and the reference's ``roofline`` with this card's
constants.  The fit is judged against the card's memory:
``torch.cuda.get_device_properties(device).total_memory`` when a device
is given, else :data:`H100_HBM_BYTES`.

**Traced** (:func:`trace_cell`, ``run_cell(..., trace=True)``, ``--trace``):
the counterpart of what the JAX package reads from XLA after lowering and
compiling the real step on the production mesh.  The port runs its own
real step (``launch/steps.py``: a train step, a prefill or a decode step)
once, on one rank of a process group of the mesh's size whose ranks are
fake (``torch.distributed``'s ``"fake"`` backend: every collective
returns at once) and on fake tensors (``FakeTensorMode``: shapes and
types, no data and no memory), and reads:

* ``memory`` (``memory_analysis()``): the arguments' bytes, which equal
  the analytic ones; the bytes of what the step returns; the peak of the
  temporaries it allocates beyond its arguments, each tensor's storage
  rounded up to 512 B as the CUDA caching allocator rounds a block
  (the kernels' own scratch, made inside a launch, is not seen);
* ``cost`` (``cost_analysis()``): FLOPs by
  ``torch.utils.flop_counter.FlopCounterMode`` -- every product of the
  step, its backward and the recomputation of ``remat`` included, and the
  kernels K6-K9 by their own formulas (``kernels/ops.py``); and the bytes
  accessed, by the rule: every op that is not a view or an allocation
  reads each tensor it is given and writes each tensor it returns, once;
* ``collectives`` (the HLO's, ``utils/hlo.py``): the calls and the
  result bytes of each kind that the step made, from
  ``launch/tensor_parallel.py``'s ``TRANSPORT``, through which every
  collective of the port passes, with the keys of
  ``CollectiveReport.summary()``.

Ops run on nothing, so the fake tensors sit on the host device: only
their shapes matter (and Python indexing of a fake CUDA tensor needs a
CUDA build of torch).  Importing this module sets no environment
variable, builds nothing and starts no process group; a trace starts its
group of fake ranks and destroys it, and refuses to run inside another.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, get_config, valid_cells
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.sharding import (ShardingPlan, batch_pspecs,
                                         cache_pspecs, make_plan,
                                         param_pspecs, shard_shape)
from repro_torch.models.layers import model_dtype
from repro_torch.models.model import Model, TensorSpec
from repro_torch.models.transformer import stack_cache
from repro_torch.utils.costmodel import attention_fraction, cell_cost

# The card the roofline is drawn for: an NVIDIA H100 80GB HBM3 at a power
# limit of 700 W (``nvidia-smi --query-gpu=name,power.limit``).
# torch.cuda.get_device_properties(0).total_memory, as chip_smoke.py's
# phase 9 reads it on that card (PERF.md, section 6)
H100_HBM_BYTES = 85_017_493_504
# dense bfloat16 tensor-core peak, FLOPs a second: chip_smoke.py's
# PEAK_BF16_OPS_PER_S, the datasheet's H100 SXM figure without sparsity
H100_PEAK_BF16_FLOPS = 989e12
# HBM3 bandwidth, bytes a second: chip_smoke.py's PEAK_BYTES_PER_S, the
# datasheet's H100 SXM figure
H100_HBM_BYTES_PER_S = 3.35e12
# NVLink 4, bytes a second, both directions together: the datasheet's
# H100 SXM figure (900 GB/s).  Not measured: the chip has one card.
H100_NVLINK_BYTES_PER_S = 900e9
# the CUDA caching allocator's rounding of a block (c10's kMinBlockSize)
ALLOCATOR_ROUND = 512


def _leaves(tree, specs):
    """(leaf, spec) pairs of a tree (dicts, lists) and its specs."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs, strict=True):
            yield from _leaves(v, s)
    else:
        yield tree, specs


def shard_bytes(tree, specs, mesh: Mesh) -> int:
    """Per-device bytes of a tree of tensors or ``TensorSpec``s placed by
    ``specs`` (the same structure) on ``mesh``."""
    total = 0
    for leaf, spec in _leaves(tree, specs):
        total += math.prod(shard_shape(leaf.shape, spec, mesh)) \
            * leaf.dtype.itemsize
    return total


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS: 6*N*D train, 2*N*D per generated/processed token."""
    n = cfg.active_param_count()
    if cell.mode == "train":
        tokens = cell.seq_len * cell.global_batch
        return 6.0 * n * tokens
    if cell.mode == "prefill":
        tokens = cell.seq_len * cell.global_batch
        return 2.0 * n * tokens
    return 2.0 * n * cell.global_batch          # decode: one token/seq


def abstract_params(model: Model, dtype: torch.dtype) -> dict:
    return {n: TensorSpec(tuple(p.shape), dtype)
            for n, p in model.named_parameters()}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode cache's shapes and types, on the ``meta`` device.  Its
    position, a host int in the port, counts as the int32 scalar the JAX
    package keeps on the device."""
    return {"layers": stack_cache(cfg, batch, max_len, model_dtype(cfg),
                                  "meta"),
            "pos": TensorSpec((), torch.int32)}


def cell_bytes(cfg: ModelConfig, cell: ShapeCell, mesh: Mesh,
               plan: ShardingPlan) -> dict:
    """Per-device bytes of a cell's step arguments: ``params``, ``opt``
    (train) or ``cache`` (prefill, decode), and ``batch``.  ``cfg`` is
    the cell's (``max_seq`` its length)."""
    model = Model(cfg, device="meta")
    pspecs = param_pspecs(model, mesh, plan)
    bspec = model.batch_spec(cell.seq_len, cell.global_batch, cell.mode)
    bshard = batch_pspecs(model, mesh, bspec, cell.global_batch, plan)
    if cell.mode == "train":
        params = abstract_params(model, torch.float32)
        out = {"params": shard_bytes(params, pspecs, mesh),
               "opt": shard_bytes(params, pspecs, mesh) * 2}
    else:
        cache = abstract_cache(cfg, cell.global_batch, cell.seq_len)
        cshard = cache_pspecs(cache, mesh, cell.global_batch, plan)
        out = {"params": shard_bytes(abstract_params(model, torch.bfloat16),
                                     pspecs, mesh),
               "cache": shard_bytes(cache, cshard, mesh)}
    out["batch"] = shard_bytes(bspec, bshard, mesh)
    return out


def hbm_bytes(device=None) -> int:
    """The memory a cell must fit in: the given CUDA device's, else an
    H100 80GB HBM3's."""
    if device is None:
        return H100_HBM_BYTES
    return torch.cuda.get_device_properties(torch.device(device)
                                            ).total_memory


def cell_config(arch: str, shape, cfg_override=None
                ) -> tuple[ModelConfig, ShapeCell]:
    """A cell's config (``max_seq`` its length, then ``cfg_override``'s
    fields) and its shape (a name of ``SHAPES``, or a ``ShapeCell``)."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch).replace(max_seq=cell.seq_len)
    if cfg_override:
        cfg = cfg.replace(**cfg_override)
    return cfg, cell


def run_cell(arch: str, shape, multi_pod: bool = False,
             plan_override: ShardingPlan | None = None, remat: str = "full",
             cfg_override: dict | None = None, seq_shard: bool = False,
             cp: bool = False, device=None, trace: bool = False,
             mesh: Mesh | None = None) -> dict:
    """One cell (the JAX package's ``run_cell``): its per-device argument
    bytes and fit, its model and analytic FLOPs and bytes, and its
    ``roofline`` on an H100; with ``trace=True`` also :func:`trace_cell`'s
    ``memory``, ``cost`` and ``collectives``, whose collective bytes give
    the roofline's ``collective_s`` (None without a trace).  ``mesh``:
    another mesh than the production one (for a check at a small
    size)."""
    cfg, cell = cell_config(arch, shape, cfg_override)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    plan = plan_override or make_plan(cfg, mesh)
    arg_bytes = cell_bytes(cfg, cell, mesh, plan)
    total = sum(arg_bytes.values())
    limit = hbm_bytes(device)

    mflops = model_flops(cfg, cell)
    # traffic attribution (the JAX package's): params divide by the
    # number of distinct param shards (model x data-FSDP), activations
    # and KV by the batch shards; FLOPs over the chips that compute
    ac = cell_cost(cfg, cell, chips, remat=remat)
    model_n = mesh.shape.get("model", 1)
    data_n = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    param_shards = model_n * (data_n if (plan.fsdp and plan.kind == "tp")
                              else 1)
    bspec_used = plan.batch_spec(mesh, cell.global_batch)
    batch_shards = 1
    if len(bspec_used):
        ax0 = bspec_used[0]
        for a in (ax0 if isinstance(ax0, tuple) else (ax0,)):
            batch_shards *= mesh.shape[a]
    bytes_dev = ac.weight_bytes / param_shards + ac.act_bytes / batch_shards
    # TP plan: the model axis takes part everywhere.  Hybrid plan: the
    # ff-TP MLP spreads over all chips, the head-replicated attention
    # only over the batch shards (or all chips with cp prefill attention)
    if plan.kind == "tp":
        flops_dev = ac.flops / chips
    else:
        S_eff = 1 if cell.mode == "decode" else cell.seq_len
        af = attention_fraction(cfg, S_eff,
                                cell.seq_len if cell.mode == "decode"
                                else (cell.seq_len + 1) / 2, cell.mode)
        attn_shards = chips if (cp and cell.mode == "prefill") \
            else batch_shards
        flops_dev = ac.flops * (af / attn_shards + (1 - af) / chips)
    res = {
        "arch": arch, "shape": cell.name,
        "mesh": list(mesh.dims), "axes": list(mesh.axis_names),
        "chips": chips, "mode": cell.mode,
        "plan": plan.kind, "fsdp": plan.fsdp, "seq_shard": seq_shard,
        "cp": cp, "remat": remat,
        "arg_bytes_per_device": arg_bytes,
        "total_arg_bytes_per_device": total,
        "hbm_bytes": limit,
        "fits_hbm": total < limit,
        "model_flops_global": mflops,
        "model_flops_per_device": mflops / chips,
        "analytic_flops_per_device": flops_dev,
        "analytic_bytes_per_device": bytes_dev,
    }
    coll_bytes = None
    if trace:
        traced = trace_cell(arch, cell, multi_pod=multi_pod, remat=remat,
                            seq_shard=seq_shard, cp=cp,
                            plan_override=plan, cfg_override=cfg_override,
                            mesh=mesh)
        res.update({k: traced[k] for k in (
            "trace_s", "groups_s", "memory", "cost", "collectives")})
        res["traced_flops_per_device"] = traced["cost"]["flops"]
        res["traced_bytes_per_device"] = traced["cost"]["bytes_accessed"]
        coll_bytes = traced["collectives"]["total_bytes"]
    res["roofline"] = roofline(flops_dev, bytes_dev, coll_bytes, mflops,
                               ac.flops, chips)
    res["ok"] = True
    return res


def roofline(flops_dev: float, bytes_dev: float, coll_bytes, mflops: float,
             analytic_flops: float, chips: int) -> dict:
    """The JAX package's ``roofline`` on an H100: compute, memory and
    collective seconds (``H100_*``; the collective term None without a
    trace's bytes), the step's the largest of them and which it is, the
    share of the analytic FLOPs that the model's are, and the MFU the
    step's seconds allow."""
    compute_s = flops_dev / H100_PEAK_BF16_FLOPS
    memory_s = bytes_dev / H100_HBM_BYTES_PER_S
    collective_s = (None if coll_bytes is None
                    else coll_bytes / H100_NVLINK_BYTES_PER_S)
    terms = [("compute", compute_s), ("memory", memory_s)]
    if collective_s is not None:
        terms.append(("collective", collective_s))
    dominant, step_s = max(terms, key=lambda kv: kv[1])
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "step_s": step_s,
            "dominant": dominant,
            "useful_flops_frac": (mflops / analytic_flops
                                  if analytic_flops else None),
            "mfu_bound": ((mflops / chips / step_s) / H100_PEAK_BF16_FLOPS
                          if step_s else None)}


# ------------------------------------------------------------ the trace
def _tensors(node):
    """The tensors of a tree of dicts, lists and tuples."""
    return [t for t in tree_leaves(node) if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cell_step(model, run, cell: ShapeCell, remat: str = "full"):
    """A cell's step on this rank of ``run`` (``launch/steps.py``) and
    its arguments: ``(call, arguments)``, ``call()`` running the step
    once and ``arguments`` ``{part: [tensors]}`` with the parts of
    :func:`cell_bytes`.  A train step takes the global batch (its rows
    are the rank's part), a prefill or decode step this rank's rows; a
    decode step is the cache's last position (``pos = seq_len - 1``).
    Tokens are random, other inputs zeros, on ``run.device``; the model
    is placed on ``run``."""
    from repro_torch.launch.distributed import parameters_by_name
    from repro_torch.launch.steps import (make_decode_step,
                                          make_mesh_train_step,
                                          make_prefill_step)
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    cfg, dev = model.cfg, run.device
    B, S = cell.global_batch, cell.seq_len
    rows = run.rows(B)

    def inputs(batch, seq, mode):
        return {name: (torch.randint(0, cfg.vocab, spec.shape,
                                     dtype=spec.dtype, device=dev)
                       if spec.dtype == torch.int32 else
                       torch.zeros(spec.shape, dtype=spec.dtype, device=dev))
                for name, spec in model.batch_spec(seq, batch,
                                                   mode).items()}

    params = list(model.parameters())
    if cell.mode == "train":
        step = make_mesh_train_step(model, run, AdamWConfig(), remat=remat)
        opt = init_opt_state(parameters_by_name(model))
        batch = inputs(B, S, "train")
        return (lambda: step(opt, batch)), {
            "params": params, "opt": [*opt["m"].values(),
                                      *opt["v"].values()],
            "batch": [t[rows] for t in batch.values()]}
    cache = run.init_cache(model, B, S)
    if cell.mode == "prefill":
        batch = inputs(rows.stop - rows.start, S, "prefill")
        step = make_prefill_step(model)

        def call():
            return step(batch, cache)
    else:
        cache["pos"] = S - 1
        batch = inputs(rows.stop - rows.start, 1, "decode")
        step = make_decode_step(model)

        def call():
            return step(cache, batch["tokens"])
    return call, {"params": params, "cache": _tensors(cache),
                  "batch": list(batch.values())}


class _StepTrace(TorchDispatchMode):
    """Every op of a traced step: the bytes it accesses (its tensor inputs
    and outputs, views and allocations aside) and the storages it makes,
    each live until the last tensor on it is gone (a finalizer on the
    storage), their bytes rounded to ``ALLOCATOR_ROUND``; the peak of the
    live total.  The arguments' storages are known from the start and
    never counted as temporaries."""

    def __init__(self, arguments):
        super().__init__()
        self.known = {id(t.untyped_storage()) for t in arguments}
        self.live = self.peak = self.bytes_accessed = 0

    def _free(self, key, size):
        self.known.discard(key)
        self.live -= size

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if not (getattr(func, "is_view", False)
                or getattr(func, "__name__", "").startswith("empty")):
            self.bytes_accessed += (_nbytes(_tensors((args, kwargs)))
                                    + _nbytes(outs))
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self.known:
                continue
            size = -(-st.nbytes() // ALLOCATOR_ROUND) * ALLOCATOR_ROUND
            self.known.add(key)
            self.live += size
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, size)
        return out


class _GlobalOnly:
    """A stand-in for ``FlopCounterMode``'s module tracker that keeps the
    global count alone.  The tracker hooks the gradient of every module's
    inputs, FSDP's gather parametrization (``launch/distributed.py``)
    among them, whose input is a parameter; inside
    ``torch.autograd.grad`` such a hook on a leaf raises."""
    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def _flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _GlobalOnly()
    return counter


def _empty_leaf(device):
    def leaf(_name, d, like):
        return torch.empty(d.shape, dtype=like.dtype, device=device)
    return leaf


def trace_cell(arch: str, shape, multi_pod: bool = False,
               remat: str = "full", seq_shard: bool = False,
               cp: bool = False, plan_override: ShardingPlan | None = None,
               cfg_override: dict | None = None, rank: int = 0,
               mesh: Mesh | None = None) -> dict:
    """Trace one cell's real step on rank ``rank`` of the mesh (see the
    module docstring): ``memory`` (``argument_bytes`` by part and in
    all, ``output_bytes``, ``temp_bytes``, ``peak_bytes`` = arguments +
    temporaries), ``cost`` (``flops``, ``flops_by_op``,
    ``bytes_accessed``), ``collectives`` (``total_bytes``, ``bytes`` and
    ``dynamic_count`` by kind), ``trace_s`` and ``groups_s`` (the fake
    ranks' process groups).  Starts a process group of fake ranks and
    destroys it; raises inside another."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import tensor_parallel as tpc
    from repro_torch.launch.distributed import MeshRun

    if dist.is_initialized():
        raise RuntimeError("trace_cell starts a process group of fake "
                           "ranks; this process already has a group")
    cfg, cell = cell_config(arch, shape, cfg_override)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    plan = plan_override or make_plan(cfg, mesh)
    t0 = time.perf_counter()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=mesh.size)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            run = MeshRun(cfg, mesh, plan, "cpu", cp=cp,
                          seq_shard=seq_shard)
            groups_s = time.perf_counter() - t0
            model = Model(cfg, device="meta", param_dtype=(
                torch.float32 if cell.mode == "train" else None))
            run.place(model, _empty_leaf(run.device))
            call, arguments = cell_step(model, run, cell, remat)
            parts = {k: _nbytes(v) for k, v in arguments.items()}
            if "cache" in parts:
                parts["cache"] += 4       # pos, as ``abstract_cache``
            tpc.reset_transport()
            everything = [t for v in arguments.values() for t in v]
            with _StepTrace(everything) as tr, _flop_counter() as fc:
                out = call()
            coll = tpc.collectives_summary()
            args_st = {id(t.untyped_storage()) for t in everything}
            output = _nbytes([t for t in _tensors(out)
                              if id(t.untyped_storage()) not in args_st])
            flops = {str(k): int(v) for k, v in
                     fc.get_flop_counts()["Global"].items()}
    finally:
        dist.destroy_process_group()
        tpc.reset_transport()
    arg = sum(parts.values())
    return {"arch": arch, "shape": cell.name, "mode": cell.mode,
            "mesh": list(mesh.dims), "rank": rank, "plan": plan.kind,
            "seq_shard": seq_shard and plan.kind == "tp", "cp": cp,
            "remat": remat,
            "memory": {"argument_bytes": arg, "arguments": parts,
                       "output_bytes": output, "temp_bytes": tr.peak,
                       "peak_bytes": arg + tr.peak},
            "cost": {"flops": sum(flops.values()), "flops_by_op": flops,
                     "bytes_accessed": tr.bytes_accessed},
            "collectives": coll,
            "trace_s": time.perf_counter() - t0, "groups_s": groups_s}


def cell_line(res: dict) -> str:
    """One line of a ``run_cell`` result, as the CLI prints it (with the
    traced peak, FLOPs and collectives when it was traced)."""
    tag = (f"{res['arch']}_{res['shape']}_"
           f"{'pod2' if len(res['mesh']) == 3 else 'pod1'}")
    parts = " ".join(f"{k}={v / 2**30:.3f}"
                     for k, v in res["arg_bytes_per_device"].items())
    line = (f"[OK] {tag}: plan={res['plan']} fsdp={res['fsdp']} {parts} "
            f"total={res['total_arg_bytes_per_device'] / 2**30:.3f}GiB/dev "
            f"fits={res['fits_hbm']}")
    if "memory" in res:
        r, coll = res["roofline"], res["collectives"]
        kinds = ",".join(f"{k}:{n}" for k, n in
                         coll["dynamic_count"].items())
        line += (f" traced: peak={res['memory']['peak_bytes'] / 2**30:.3f}"
                 f"GiB flops={res['cost']['flops']:.4g} "
                 f"collectives={coll['total_bytes'] / 2**30:.3f}GiB "
                 f"[{kinds}] dominant={r['dominant']} "
                 f"step={r['step_s']:.4g}s ({res['trace_s']:.1f}s)")
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--trace", action="store_true",
                    help="also trace each cell's step on fake ranks")
    ap.add_argument("--seq-shard", action="store_true",
                    help="Megatron-SP under tp plans")
    ap.add_argument("--cp", action="store_true",
                    help="context-parallel prefill attention under hybrid "
                         "plans")
    ap.add_argument("--device", default=None,
                    help="judge the fit against this CUDA device's memory")
    ap.add_argument("--out", default=None,
                    help="also write one JSON file a cell into this folder")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --all, or --arch and --shape")

    out_dir = Path(args.out) if args.out else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    cells = valid_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.perf_counter()
    for arch, shape in cells:
        for mp in meshes:
            res = run_cell(arch, shape, multi_pod=mp, remat=args.remat,
                           seq_shard=args.seq_shard, cp=args.cp,
                           device=args.device, trace=args.trace)
            print(cell_line(res), flush=True)
            if out_dir is not None:
                tag = f"{arch}_{shape}_{'pod2' if mp else 'pod1'}"
                (out_dir / f"{tag}.json").write_text(json.dumps(res,
                                                                indent=1))
    print(f"all {len(cells) * len(meshes)} requested cells "
          f"{'traced' if args.trace else 'planned'}.")
    print(f"wall {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
