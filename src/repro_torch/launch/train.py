"""Training loop: data pipeline -> train step -> checkpoint loop, with
preemption handling, restart from the newest checkpoint and straggler
monitoring, on one device.

    python -m repro_torch.launch.train --arch smollm-360m --steps 12
    python -m repro_torch.launch.train --arch smollm-360m --smoke \
        --device cpu --seq 32 --batch 2 --steps 4

The counterpart of the JAX package's ``launch/train.py`` without its mesh
(sharding is ROADMAP queue 1's multi-device item): float32 master weights
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
from repro_torch.launch.steps import make_train_step
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
          data_cfg: DataConfig | None = None, device="cuda") -> dict:
    """Train from the newest checkpoint in ``tc.ckpt_dir`` (or from
    scratch) up to step ``tc.steps``.  Returns the logged ``losses``
    ``[(step, loss)]``, each step's seconds (``step_s``), the
    ``final_step``, ``stragglers``, ``wall_s``, the ``model`` and its
    ``opt_state``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device (torch.cuda.is_available() "
                           "is False); pass device='cpu' to train on the "
                           "host")
    model = Model(cfg, device=device, param_dtype=torch.float32)
    step_fn = make_train_step(model, tc.opt, remat=tc.remat)
    data_cfg = data_cfg or DataConfig(
        seq_len=cfg.max_seq, global_batch=8, vocab=cfg.vocab, seed=tc.seed)
    pipeline = Pipeline(data_cfg)
    monitor = StragglerMonitor()
    ckpt = AsyncCheckpointer(tc.ckpt_dir)

    def init():
        model.init_weights(tc.seed)
        return init_opt_state(dict(model.named_parameters()))

    def load(tree):
        model.load_state_dict(lm_params_from_numpy(cfg, tree[0], device))
        return opt_state_from_numpy(cfg, tree[1], device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    opt_state, start = resume_or_init(tc.ckpt_dir, init, load, pipeline)
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
                print(f"step {step}: loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"({monitor.median_s * 1e3:.0f} ms/step)")
            if (step + 1) % tc.ckpt_every == 0 or guard.preempted:
                ckpt.save((lm_params_to_numpy(cfg, model.state_dict()),
                           opt_state_to_numpy(cfg, opt_state)), step + 1)
            if guard.preempted:
                print(f"preempted at step {step}; checkpoint committed")
                break
        ckpt.wait()
    finally:
        guard.uninstall()
        pipeline.close()
    return {"losses": losses, "step_s": step_s, "final_step": step,
            "stragglers": monitor.flagged_steps,
            "wall_s": time.time() - t_start, "model": model,
            "opt_state": opt_state}


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
    args = ap.parse_args(argv)
    cfg = (smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(max_seq=args.seq)
    dc = DataConfig(seq_len=args.seq, global_batch=args.batch,
                    vocab=cfg.vocab)
    out = train(cfg, TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir),
                data_cfg=dc, device=args.device)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"loss {first:.3f} -> {last:.3f} over {out['final_step']} steps")


if __name__ == "__main__":
    main()
