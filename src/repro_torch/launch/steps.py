"""The train step of the training loop (``train.py``).

The counterpart of the JAX package's ``launch/steps.py::make_train_step``
without ``jit``: the loss, its gradient with respect to every parameter
(``torch.autograd.grad``; the LM kernels' backwards are
``kernels/autograd.py``'s) and one AdamW step, which updates the model's
parameters and the optimizer's state in place.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.convert import lm_leaf_key
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def train_params(model) -> dict:
    """The model's parameters, ``{name: parameter}`` in the order of the
    JAX tree's leaves (so the global norm sums as it does there), with
    their gradients turned on."""
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    return {n: named[n]
            for n in sorted(named, key=lambda n: lm_leaf_key(model.cfg, n))}


# the points of a step that ``make_train_step``'s ``mark`` is called at: the
# start, and the end of the forward, the backward and the optimizer
STEP_MARKS = ("start", "forward", "backward", "optimizer")


def make_train_step(model, opt_cfg: AdamWConfig, remat: str = "full",
                    mark: Callable[[str], None] | None = None):
    """``train_step(opt_state, batch) -> metrics``: ``loss``, ``nll``,
    ``aux``, ``grad_norm`` (device scalars) and ``lr``, the JAX step's.
    ``mark``, if given, is called with each of ``STEP_MARKS`` in turn (to
    record a CUDA event there, for example)."""
    params = train_params(model)
    mark = mark or (lambda _point: None)

    def train_step(opt_state: dict, batch: dict) -> dict:
        mark("start")
        loss, metrics = model.loss(batch, remat=remat)
        mark("forward")
        grads = torch.autograd.grad(loss, list(params.values()))
        mark("backward")
        opt_metrics = adamw_update(opt_cfg, params,
                                   dict(zip(params, grads)), opt_state)
        mark("optimizer")
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in metrics.items()},
                **opt_metrics}
    return train_step
