"""AdamW with decoupled weight decay, linear-warmup cosine schedule and
global-norm clipping, over a model's named parameters.

The counterpart of the JAX package's ``optim/adamw.py``, whose state
mirrors the parameter tree: here ``params`` and ``grads`` are
``{name: tensor}`` dicts in one order, and the state is ``{"m": {name:
float32}, "v": {name: float32}, "step": int}``.  The update is the JAX
package's expression for expression, in float32, and writes the
parameters, ``m`` and ``v`` in place under ``torch.no_grad()`` (the
``torch._foreach_*`` forms: one launch an expression for all tensors).
The global norm sums the leaves' squares in the dict's order, one after
the other; ``launch/steps.py`` orders the parameters as the JAX tree's
leaves come (``convert.py::lm_leaf_key``), so the two round alike.  The
schedule is computed on the host in float32.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate of ``step`` (counted from 1), in float32."""
    f = np.float32
    step = f(step)
    warm = min(step / f(max(cfg.warmup_steps, 1)), f(1.0))
    t = np.clip((step - f(cfg.warmup_steps))
                / f(max(cfg.total_steps - cfg.warmup_steps, 1)), f(0), f(1))
    cos = f(0.5) * (f(1) + np.cos(f(np.pi) * t))
    frac = f(cfg.min_lr_frac) + f(1 - cfg.min_lr_frac) * cos
    return float(f(cfg.lr) * warm * frac)


def init_opt_state(params: dict) -> dict:
    zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
    return {"m": zeros(), "v": zeros(), "step": 0}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every tensor's sum of squares (float32), summed
    in the order given."""
    total = None
    for x in tensors:
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict,
                 state: dict, grad_norm: torch.Tensor | None = None) -> dict:
    """One step: ``params``, ``state["m"]`` and ``state["v"]`` updated in
    place, ``state["step"]`` advanced.  ``grad_norm`` is the global norm
    of the gradients where they are shards of a mesh run's (default:
    ``global_norm`` of ``grads``).  Returns the metrics ``grad_norm`` (a
    device scalar) and ``lr``."""
    names = list(params)
    p = [params[n] for n in names]
    g = [grads[n].to(torch.float32) for n in names]
    m = [state["m"][n] for n in names]
    v = [state["v"][n] for n in names]
    step = state["step"] + 1
    gn = global_norm(g) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    f = np.float32
    bc1 = float(f(1) - f(cfg.b1) ** f(step))
    bc2 = float(f(1) - f(cfg.b2) ** f(step))

    g = torch._foreach_mul(g, scale)
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - cfg.b2))
    denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
    torch._foreach_add_(denom, cfg.eps)
    delta = torch._foreach_div(torch._foreach_div(m, bc1), denom)
    torch._foreach_add_(delta, torch._foreach_mul(p, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(p, delta)
    state["step"] = step
    return {"grad_norm": gn, "lr": torch.tensor(lr, dtype=torch.float32)}
