"""Analytic dry-run: what every (architecture x input shape) cell holds on
each device of a production mesh, and whether it fits -- without devices.

    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k

The counterpart of the analytic half of the JAX package's
``launch/dryrun.py``.  For each cell of ``configs.valid_cells()`` it takes
the cell's plan on the mesh (``launch/sharding.py``) and counts the
per-device bytes of what a step takes as arguments: the parameters
(float32 for a train step, bfloat16 to serve), AdamW's ``m`` and ``v``
(train), the decode cache (prefill, decode) and the batch, each shard's
shape by ``sharding.shard_shape``.  The shapes come from a model and a
cache on the ``meta`` device, so nothing is allocated.  Beside them:
``model_flops`` (6 N D to train, 2 N D to serve) and the per-device FLOPs
and bytes of ``utils/costmodel.py::cell_cost``, attributed as the JAX
package attributes them.  The fit is judged against the card's memory:
``torch.cuda.get_device_properties(device).total_memory`` when a device
is given, else :data:`H100_HBM_BYTES`.

What the JAX package's dry-run reads from XLA has no torch counterpart
and is not here: it lowers and compiles every step, then reads
``memory_analysis()`` (argument, output and temporary bytes),
``cost_analysis()`` (the compiled program's FLOPs and bytes) and the
collectives of the compiled HLO text (``utils/hlo.py``).  Importing this
module sets no environment variable, builds nothing and starts no process
group.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

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

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3, as chip_smoke.py's phase 9 reads it (PERF.md, section 6)
H100_HBM_BYTES = 85_017_493_504


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


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             remat: str = "full", device=None) -> dict:
    cfg = get_config(arch)
    cell = SHAPES[shape]
    cfg = cfg.replace(max_seq=cell.seq_len)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    plan = make_plan(cfg, mesh)
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
    if plan.kind == "tp":
        flops_dev = ac.flops / chips
    else:
        S_eff = 1 if cell.mode == "decode" else cell.seq_len
        af = attention_fraction(cfg, S_eff,
                                cell.seq_len if cell.mode == "decode"
                                else (cell.seq_len + 1) / 2, cell.mode)
        flops_dev = ac.flops * (af / batch_shards + (1 - af) / chips)
    return {
        "arch": arch, "shape": shape,
        "mesh": list(mesh.dims), "axes": list(mesh.axis_names),
        "chips": chips, "mode": cell.mode,
        "plan": plan.kind, "fsdp": plan.fsdp, "remat": remat,
        "arg_bytes_per_device": arg_bytes,
        "total_arg_bytes_per_device": total,
        "hbm_bytes": limit,
        "fits_hbm": total < limit,
        "model_flops_global": mflops,
        "model_flops_per_device": mflops / chips,
        "analytic_flops_per_device": flops_dev,
        "analytic_bytes_per_device": bytes_dev,
        "ok": True,
    }


def cell_line(res: dict) -> str:
    """One line of a ``run_cell`` result, as the CLI prints it."""
    tag = (f"{res['arch']}_{res['shape']}_"
           f"{'pod2' if len(res['mesh']) == 3 else 'pod1'}")
    parts = " ".join(f"{k}={v / 2**30:.3f}"
                     for k, v in res["arg_bytes_per_device"].items())
    return (f"[OK] {tag}: plan={res['plan']} fsdp={res['fsdp']} {parts} "
            f"total={res['total_arg_bytes_per_device'] / 2**30:.3f}GiB/dev "
            f"fits={res['fits_hbm']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="full")
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
    for arch, shape in cells:
        for mp in meshes:
            res = run_cell(arch, shape, multi_pod=mp, remat=args.remat,
                           device=args.device)
            print(cell_line(res))
            if out_dir is not None:
                tag = f"{arch}_{shape}_{'pod2' if mp else 'pod1'}"
                (out_dir / f"{tag}.json").write_text(json.dumps(res,
                                                                indent=1))
    print(f"all {len(cells) * len(meshes)} requested cells planned.")


if __name__ == "__main__":
    main()
