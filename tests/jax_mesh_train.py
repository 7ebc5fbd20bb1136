"""The JAX package on host devices, for ``test_torch_mesh_reference.py``:
a process of its own, started with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` in its environment
alone, so the test's process keeps one device.

    python tests/jax_mesh_train.py job.json

The job lists cases, each with its mesh's ``dims`` (as ``data``,
``model``; a ``pod`` axis first when three) and a ``kind``:

* ``train`` -- resume the checkpoint in ``ckpt_dir`` and train a smoke
  config to ``steps``, checkpointing at the end; ``fsdp`` forces the
  plan's FSDP on (the ``embed`` axis over ``data``, the rule the
  reference's ``make_plan`` applies above its threshold);
* ``serve`` -- ``serve`` of a batch with the weights pickled in
  ``params`` (the JAX package's tree, numpy leaves), the smoke config's
  fields ``replace`` changed;
* ``cp`` -- ``models/attention.py::cp_attention`` on numpy inputs;
* ``psum`` -- ``optim/compression.py::compressed_psum`` over ``pod`` in a
  ``shard_map``, each participant's gradients its row of the inputs;
* ``grads`` -- the loss and its gradient (``jax.value_and_grad`` of
  ``Model.loss``, jitted on the mesh with the reference's plan, as its
  ``train`` sets it up) at the weights pickled in ``params`` and the batch
  in ``inputs``.

The mesh's axes are ``Auto``: under jax 0.9 ``jax.make_mesh`` makes
explicit axes by default, on which the reference's embedding gather
raises ``ShardingTypeError`` (ROADMAP R4, R7).  The results go to
``results.pkl`` beside the job.
"""
from __future__ import annotations

import dataclasses
import json
import pickle
import sys
from pathlib import Path

import numpy as np


def _mesh(dims):
    import jax

    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return jax.make_mesh(tuple(dims), names,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(dims))


def _train(case, mesh):
    import repro.launch.train as reference
    from repro.configs import smoke_config
    from repro.data.pipeline import DataConfig

    make_plan = reference.make_plan

    def plan(cfg, mesh, fsdp=case["fsdp"]):
        p = make_plan(cfg, mesh)
        if not fsdp:
            return p
        return dataclasses.replace(p, fsdp=True,
                                   rules={**p.rules, "embed": "data"})

    reference.make_plan = plan
    try:
        cfg = smoke_config(case["arch"]).replace(max_seq=case["seq"])
        res = reference.train(
            cfg, reference.TrainConfig(
                steps=case["steps"], log_every=1,
                ckpt_every=case["steps"], ckpt_dir=case["ckpt_dir"]),
            mesh=mesh,
            data_cfg=DataConfig(seq_len=case["seq"],
                                global_batch=case["batch"],
                                vocab=cfg.vocab, seed=case["data_seed"]))
    finally:
        reference.make_plan = make_plan
    return res["losses"]


def _serve(case, mesh):
    import jax

    from repro.configs import smoke_config
    from repro.launch.serve import ServeConfig, serve

    cfg = smoke_config(case["arch"]).replace(max_seq=case["seq"],
                                             **case.get("replace", {}))
    with open(case["params"], "rb") as f:
        params = jax.tree.map(jax.numpy.asarray, pickle.load(f))
    out = serve(cfg, ServeConfig(batch=case["batch"],
                                 prompt_len=case["seq"] - case["gen"],
                                 gen_len=case["gen"], seed=case["seed"]),
                mesh=mesh, params=params)
    return out["tokens"]


def _cp(case, mesh):
    import jax.numpy as jnp

    from repro.models.attention import cp_attention

    q, k, v = (jnp.asarray(case["inputs"][n]) for n in ("q", "k", "v"))
    with mesh:
        out = cp_attention(q, k, v, mesh=mesh, batch_axes=("data",),
                           model_axis="model", causal=True,
                           window=case["window"])
    return np.asarray(out)


def _psum(case, mesh):
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.optim.compression import compressed_psum

    g = np.asarray(case["grads"], np.float32)        # [participants, n]

    def local(x):
        mean, err = compressed_psum({"w": x[0]}, {"w": 0 * x[0]}, "pod")
        return mean["w"][None], err["w"][None]

    fn = jax.shard_map(local, mesh=mesh, in_specs=P("pod"),
                       out_specs=(P("pod"), P("pod")), check_vma=False)
    mean, err = fn(g)
    return np.asarray(mean), np.asarray(err)


def _grads(case, mesh):
    import jax

    from repro.configs import smoke_config
    from repro.launch.sharding import (batch_pspecs, hidden_batch_axes,
                                       make_plan, param_pspecs, to_named)
    from repro.models.model import build_model
    from repro.models.transformer import set_mesh_axes

    cfg = smoke_config(case["arch"]).replace(max_seq=case["seq"],
                                             **case.get("replace", {}))
    model = build_model(cfg)
    with open(case["params"], "rb") as f:
        params = jax.tree.map(jax.numpy.asarray, pickle.load(f))
    batch = {k: jax.numpy.asarray(v) for k, v in case["inputs"].items()}
    rows = batch["tokens"].shape[0]
    plan = make_plan(cfg, mesh)
    set_mesh_axes(hidden_batch_axes(plan, mesh, rows), "model", mesh=mesh)
    try:
        with mesh:
            pshard = to_named(mesh, param_pspecs(model, mesh, plan))
            bshard = to_named(mesh, batch_pspecs(
                model, mesh, model.batch_spec(case["seq"], rows, "train"),
                rows, plan))
            fn = jax.jit(jax.value_and_grad(
                lambda p, b: model.loss(p, b)[0]),
                in_shardings=(pshard, bshard))
            loss, grads = fn(jax.device_put(params, pshard),
                             jax.device_put(batch, bshard))
    finally:
        set_mesh_axes(None)
    return float(loss), jax.tree.map(np.asarray, grads)


KINDS = {"train": _train, "serve": _serve, "cp": _cp, "psum": _psum,
         "grads": _grads}


def main(job_path: str) -> None:
    job = json.loads(Path(job_path).read_text())
    out = {}
    for case in job["cases"]:
        if "inputs" in case:
            with open(case["inputs"], "rb") as f:
                case = {**case, "inputs": pickle.load(f)}
        out[case["id"]] = KINDS[case["kind"]](case, _mesh(case["dims"]))
    with open(Path(job_path).parent / "results.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
