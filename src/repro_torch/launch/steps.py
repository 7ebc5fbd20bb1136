"""The step builders shared by the drivers (``train.py``, ``serve.py``).

The counterpart of the JAX package's ``launch/steps.py`` without ``jit``:

* ``make_train_step`` -- the loss, its gradient with respect to every
  parameter (``torch.autograd.grad``; the LM kernels' backwards are
  ``kernels/autograd.py``'s) and one AdamW step, which updates the model's
  parameters and the optimizer's state in place;
* ``make_prefill_step`` -- a prefill of a batch into a cache;
* ``make_decode_step`` -- one greedy token per sequence against the
  standing cache.

The model holds its parameters, so no step takes them.
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


def make_prefill_step(model):
    """``prefill_step(batch, cache) -> (logits, cache)``."""
    def prefill_step(batch: dict, cache: dict):
        return model.prefill(batch, cache)
    return prefill_step


def make_decode_step(model):
    """``serve_step(cache, tokens) -> (next_tok [B, 1] int32, logits,
    cache)``: the greedy token is the first index of the largest logit."""
    def serve_step(cache: dict, tokens):
        logits, new_cache = model.decode_step(cache, tokens)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, new_cache
    return serve_step
