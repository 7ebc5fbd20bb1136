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
from repro_torch.launch.distributed import parameters_by_name
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def train_params(model) -> dict:
    """The model's parameters, ``{name: parameter}`` in the order of the
    JAX tree's leaves (so the global norm sums as it does there), with
    their gradients turned on; a mesh run's sharded parameters by their
    unsharded names."""
    model.requires_grad_(True)
    named = parameters_by_name(model)
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


def mesh_grads(model, run, params: dict, batch: dict, remat: str = "full"):
    """This rank's rows of the global ``batch`` through the loss, weighted
    by their share of the counted labels (and the aux loss by their share
    of the row shards: the reference's ``pmean`` over the batch axes);
    returns the gradients of ``params`` summed over the ranks of other
    rows (``MeshRun.reduce_grads``: each a shard where the parameter is
    one) and this rank's weighted ``(nll, aux)``."""
    labels = torch.as_tensor(batch["labels"])
    rows = run.rows(labels.shape[0])
    copies = run.replicas(labels.shape[0])
    # the share is a tensor where the labels are (no read back to the
    # host, so a step traced on fake tensors runs it too), in float64
    # and rounded once, as the host's division was
    counted = torch.clamp((labels != -1).sum(), min=1).to(torch.float64)
    w_nll = (labels[rows] != -1).sum().to(torch.float64) / counted / copies
    w_aux = 1.0 / (run.row_shards(labels.shape[0]) * copies)
    _, metrics = model.loss({k: v[rows] for k, v in batch.items()},
                            remat=remat)
    nll = metrics["nll"] * w_nll.to(device=metrics["nll"].device,
                                    dtype=metrics["nll"].dtype)
    aux = metrics["aux"] * w_aux
    grads = run.reduce_grads(list(params), list(torch.autograd.grad(
        nll + aux, list(params.values()))))
    return grads, nll.detach(), aux.detach()


def make_mesh_train_step(model, run, opt_cfg: AdamWConfig,
                         remat: str = "full"):
    """``make_train_step`` on one rank of a mesh run
    (``launch/distributed.py::MeshRun``): ``train_step(opt_state,
    global_batch)`` takes this rank's rows of the global batch
    (:func:`mesh_grads`) and steps AdamW on this rank's shards with the
    global gradient norm.  The metrics are the global batch's, equal on
    every rank."""
    params = train_params(model)
    names = list(params)

    def train_step(opt_state: dict, batch: dict) -> dict:
        grads, nll, aux = mesh_grads(model, run, params, batch, remat)
        grad_norm = run.grad_norm(names, grads)
        opt_metrics = adamw_update(opt_cfg, params, dict(zip(names, grads)),
                                   opt_state, grad_norm=grad_norm)
        nll, aux = run.dp_sum(torch.stack([nll, aux])).unbind()
        return {"loss": nll + aux, "nll": nll, "aux": aux, **opt_metrics}
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
