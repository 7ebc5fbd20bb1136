"""Training loop: data pipeline -> train step -> checkpoint loop, with
preemption handling, restart from the newest checkpoint and straggler
monitoring, on one device or on every rank of a mesh.

    python -m repro_torch.launch.train --arch smollm-360m --steps 12
    python -m repro_torch.launch.train --arch smollm-360m --smoke \
        --device cpu --seq 32 --batch 2 --steps 4
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch smollm-360m --mesh 4,1

The counterpart of the JAX package's ``launch/train.py``.  Without a mesh
it runs on one device with no process group.  With ``mesh=`` (a
``launch/mesh.py`` description) every rank runs this function inside a
process group that the caller has started (``main`` does so from
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``): data parallelism over the
batch axes, FSDP where the plan says so and tensor parallelism over the
``model`` axis (``launch/distributed.py``); rank 0 writes the gathered state, in the
same format, so a one-process run restores a mesh run's checkpoint and
the reverse.  The rest is as on one device: float32 master weights
(``Model(..., param_dtype=torch.float32)``, from ``torch.Generator(seed)``),
the forward in the config's type, ``launch/steps.py``'s step, checkpoints
in the JAX package's format (``checkpoint/checkpoint.py``), so either
package resumes the other's.  On the card every attention layer runs K6
and every MLP K7 (again in a rematerialised layer's recomputation), every
recurrent layer K9 (also in its backward), every ssm layer K8.  Each
step's time is host clock around work that ends in
``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint.checkpoint import AsyncCheckpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 opt_state_from_numpy, opt_state_to_numpy)
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch.distributed import (MeshRun, close_ranks, init_ranks,
                                            parameters_by_name,
                                            ranks_from_env)
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.sharding import ShardingPlan
from repro_torch.launch.steps import make_mesh_train_step, make_train_step
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.fault_tolerance import (PreemptionGuard,
                                                 StragglerMonitor,
                                                 resume_or_init)


@dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    seed: int = 0
    remat: str = "full"
    opt: AdamWConfig = field(default_factory=AdamWConfig)


def train(cfg: ModelConfig, tc: TrainConfig,
          data_cfg: DataConfig | None = None, device="cuda",
          mesh: Mesh | None = None, plan: ShardingPlan | None = None,
          seq_shard: bool = False) -> dict:
    """Train from the newest checkpoint in ``tc.ckpt_dir`` (or from
    scratch) up to step ``tc.steps``.  Returns the logged ``losses``
    ``[(step, loss)]``, each step's seconds (``step_s``), the
    ``final_step``, ``stragglers``, ``wall_s``, the ``model`` and its
    ``opt_state``.  With ``mesh`` (and ``plan``, default ``make_plan`` of
    the config on it) the model and state are this rank's shards, and
    ``run`` is the ``MeshRun`` they belong to (:func:`checkpoint_tree`
    gathers them); ``seq_shard``: Megatron-SP (``MeshRun``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device (torch.cuda.is_available() "
                           "is False); pass device='cpu' to train on the "
                           "host")
    run = None if mesh is None else MeshRun(cfg, mesh, plan, device,
                                            seq_shard=seq_shard)
    model = Model(cfg, device=device if run is None else "meta",
                  param_dtype=torch.float32)
    if run is None:
        step_fn = make_train_step(model, tc.opt, remat=tc.remat)
    data_cfg = data_cfg or DataConfig(
        seq_len=cfg.max_seq, global_batch=8, vocab=cfg.vocab, seed=tc.seed)
    pipeline = Pipeline(data_cfg)
    monitor = StragglerMonitor()
    lead = run is None or run.rank == 0
    ckpt = AsyncCheckpointer(tc.ckpt_dir) if lead else None

    def init():
        if run is None:
            model.init_weights(tc.seed)
        else:
            run.place_init(model, tc.seed)
        return init_opt_state(parameters_by_name(model))

    def load(tree):
        if run is None:
            model.load_state_dict(lm_params_from_numpy(cfg, tree[0], device))
            return opt_state_from_numpy(cfg, tree[1], device)
        # the host's full tensors; only this rank's shards reach the device
        run.place_loaded(model, lm_params_from_numpy(cfg, tree[0], "cpu"))
        opt = opt_state_from_numpy(cfg, tree[1], "cpu")
        return {**opt, "m": run.shard_tensors(opt["m"]),
                "v": run.shard_tensors(opt["v"])}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    opt_state, start = resume_or_init(tc.ckpt_dir, init, load, pipeline)
    if run is not None:
        step_fn = make_mesh_train_step(model, run, tc.opt, remat=tc.remat)
    guard = PreemptionGuard().install()
    losses, step_s = [], []
    step = start
    t_start = time.time()
    try:
        it = iter(pipeline)
        for step in range(start, tc.steps):
            monitor.step_start()
            metrics = step_fn(opt_state, next(it))
            sync()
            monitor.step_end(step)
            step_s.append(monitor.times[-1])
            if step % tc.log_every == 0 or step == tc.steps - 1:
                loss = float(metrics["loss"])
                losses.append((step, loss))
                if lead:
                    print(f"step {step}: loss {loss:.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"({monitor.median_s * 1e3:.0f} ms/step)")
            preempted = guard.preempted if run is None else run.any(
                guard.preempted)
            if (step + 1) % tc.ckpt_every == 0 or preempted:
                tree = checkpoint_tree(cfg, model, opt_state, run)
                if lead:
                    ckpt.save(tree, step + 1)
            if preempted:
                if lead:
                    print(f"preempted at step {step}; checkpoint committed")
                break
        if lead:
            ckpt.wait()
        if run is not None:
            run.barrier()                 # the checkpoint is on disk
    finally:
        guard.uninstall()
        pipeline.close()
    out = {"losses": losses, "step_s": step_s, "final_step": step,
           "stragglers": monitor.flagged_steps,
           "wall_s": time.time() - t_start, "model": model,
           "opt_state": opt_state}
    if run is not None:
        out["run"] = run
    return out


def checkpoint_tree(cfg, model, opt_state: dict, run: MeshRun | None):
    """The checkpoint's tree of a model and its AdamW state: the JAX
    package's parameter and optimizer trees.  Under a mesh every rank
    calls it; the full tensors are gathered one leaf at a time to rank
    0's host (``MeshRun.host_tensors``), which alone gets the tree, the
    others None."""
    if run is None:
        return (lm_params_to_numpy(cfg, model.state_dict()),
                opt_state_to_numpy(cfg, opt_state))
    params = run.host_tensors(parameters_by_name(model))
    m = run.host_tensors(opt_state["m"])
    v = run.host_tensors(opt_state["v"])
    if params is None:
        return None
    return (lm_params_to_numpy(cfg, params),
            opt_state_to_numpy(cfg, {**opt_state, "m": m, "v": v}))


def main(argv=None) -> None:
    import argparse
    from repro_torch.configs import get_config, smoke_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="with RANK / WORLD_SIZE set: the mesh's dims, "
                         "e.g. 4,1 (data, model) or 2,2,1 (pod, data, "
                         "model); default WORLD_SIZE,1")
    ap.add_argument("--store", default=None,
                    help="the process group's init_method (file:///path "
                         "or tcp://host:port; default env://)")
    args = ap.parse_args(argv)
    cfg = (smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(max_seq=args.seq)
    dc = DataConfig(seq_len=args.seq, global_batch=args.batch,
                    vocab=cfg.vocab)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir)
    if not ranks_from_env():
        out = train(cfg, tc, data_cfg=dc, device=args.device)
    else:
        device = init_ranks(args.store, args.device)
        try:
            dims = (tuple(int(n) for n in args.mesh.split(",")) if args.mesh
                    else (torch.distributed.get_world_size(), 1))
            out = train(cfg, tc, data_cfg=dc, device=device,
                        mesh=make_mesh(dims))
        finally:
            close_ranks()
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"loss {first:.3f} -> {last:.3f} over {out['final_step']} steps")


if __name__ == "__main__":
    main()
