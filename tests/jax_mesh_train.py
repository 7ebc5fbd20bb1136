"""The JAX package's ``train(..., mesh=)`` on host devices, for
``test_torch_mesh_reference.py``: a process of its own, started with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` in its environment
alone, so the test's process keeps one device.

    python tests/jax_mesh_train.py job.json

The job names the mesh's dims (as ``data``, ``model``) and the cases:
each resumes the checkpoint in its ``ckpt_dir`` and trains a smoke config
to ``steps``, checkpointing at the end; ``fsdp`` forces the plan's FSDP
on (the ``embed`` axis over ``data``, the rule the reference's
``make_plan`` applies above its threshold).  The mesh's axes are
``Auto``: under jax 0.9 ``jax.make_mesh`` makes explicit axes by default,
on which the reference's embedding gather raises ``ShardingTypeError``
(ROADMAP R4).  The losses go to ``losses.json`` beside the job.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path


def main(job_path: str) -> None:
    import jax

    import repro.launch.train as reference
    from repro.configs import smoke_config
    from repro.data.pipeline import DataConfig

    job = json.loads(Path(job_path).read_text())
    make_plan = reference.make_plan
    out = {}
    for case in job["cases"]:
        def plan(cfg, mesh, fsdp=case["fsdp"]):
            p = make_plan(cfg, mesh)
            if not fsdp:
                return p
            return dataclasses.replace(
                p, fsdp=True, rules={**p.rules, "embed": "data"})

        reference.make_plan = plan
        cfg = smoke_config(case["arch"]).replace(max_seq=case["seq"])
        mesh = jax.make_mesh(tuple(job["dims"]), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        res = reference.train(
            cfg, reference.TrainConfig(
                steps=case["steps"], log_every=1,
                ckpt_every=case["steps"], ckpt_dir=case["ckpt_dir"]),
            mesh=mesh,
            data_cfg=DataConfig(seq_len=case["seq"],
                                global_batch=case["batch"],
                                vocab=cfg.vocab, seed=case["data_seed"]))
        out[case["id"]] = res["losses"]
    reference.make_plan = make_plan
    (Path(job_path).parent / "losses.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
