"""The port's ``train(..., mesh=)`` across ranks against the JAX
package's ``train(..., mesh=)`` on the same mesh, on the CPU.

Both resume one checkpoint: a one-process run of the port to step 1
(smollm-360m's smoke config, a global batch of 4 x 16), written in the
format both packages read.  From it, on a (2, 1) mesh as (data, model),
with FSDP as the plan says (off at this size) and forced on, each trains
to step 4 and checkpoints there:

* the reference in one process on two host devices
  (``jax_mesh_train.py``, ``XLA_FLAGS`` set in that process alone);
* the port in two rank processes (``torch_ranks.py``: gloo over a
  ``file://`` store under ``tmp_path``, one thread, ``device="cpu"``).

The two run at once, under one timeout.  Every loss of steps 1-3 agrees
within 1e-5 (relative), and every leaf of the step-4 checkpoints
(parameters, AdamW's ``m`` and ``v``) within 1e-5 of its largest
magnitude: the ranks' loss weighting, gradient sums and sharded gradient
norm against what the reference computes under a mesh.
"""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_parity
import torch_ranks
from repro_torch.checkpoint.checkpoint import latest_step, restore
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.train import TrainConfig, train

torch_parity.one_thread()

DIMS = (2, 1)
SEQ, BATCH, START, STEPS, DATA_SEED = 16, 4, 1, 4, 7
ARCH = "smollm-360m"
TIMEOUT_S = 240


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, path + (i,))
    else:
        yield "/".join(map(str, path)), np.asarray(tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_reference")
    cfg = smoke_config(ARCH).replace(max_seq=SEQ)
    train(cfg, TrainConfig(steps=START, log_every=1, ckpt_every=START,
                           ckpt_dir=str(root / "start"), seed=5),
          data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH,
                              vocab=cfg.vocab, seed=DATA_SEED),
          device="cpu")
    assert latest_step(root / "start") == START
    cases = {"ref": [], "port": []}
    for side in cases:
        for fsdp in (False, True):
            ckpt = root / side / ("fsdp" if fsdp else "dp")
            shutil.copytree(root / "start", ckpt)
            cases[side].append(dict(
                id=ckpt.name, kind="train", arch=ARCH, fsdp=fsdp, seq=SEQ,
                batch=BATCH, steps=STEPS, ckpt_every=STEPS,
                ckpt_dir=str(ckpt), data_seed=DATA_SEED))
    job = root / "ref" / "job.json"
    job.write_text(json.dumps({"dims": list(DIMS), "cases": cases["ref"]}))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": str(torch_ranks.ROOT / "src")}
    with open(root / "ref" / "log", "w") as log:
        ref = subprocess.Popen(
            [sys.executable, str(torch_ranks.ROOT / "tests" /
                                 "jax_mesh_train.py"), str(job)],
            env=env, cwd=root / "ref", stdout=log, stderr=subprocess.STDOUT)
    procs = torch_ranks.start_world(DIMS, cases["port"], root / "port")
    t0 = time.monotonic()
    try:
        ref.wait(timeout=TIMEOUT_S)
        assert ref.returncode == 0, (root / "ref" / "log").read_text()[-4000:]
        ranks = torch_ranks.wait_world(
            procs, root / "port", max(TIMEOUT_S - (time.monotonic() - t0),
                                      1.0))
    finally:
        for p in [ref, *procs]:
            if p.poll() is None:
                p.kill()
                p.wait()
    ref_losses = json.loads((root / "ref" / "losses.json").read_text())
    return root, ref_losses, ranks


@pytest.mark.parametrize("case", ["dp", "fsdp"])
def test_mesh_losses_equal_the_reference_mesh_train(runs, case):
    _, ref_losses, ranks = runs
    want = ref_losses[case]
    assert [s for s, _ in want] == list(range(START, STEPS))
    for rank, res in enumerate(ranks):
        got = res[case]["losses"]
        assert [s for s, _ in got] == [s for s, _ in want]
        for (s, g), (_, w) in zip(got, want):
            assert abs(g - w) <= 1e-5 * abs(w), (case, rank, s, g, w)


@pytest.mark.parametrize("case", ["dp", "fsdp"])
def test_mesh_checkpoint_equals_the_reference_mesh_train(runs, case):
    root = runs[0]
    trees = {}
    for side in ("ref", "port"):
        ckpt = root / side / case
        assert latest_step(ckpt) == STEPS
        trees[side] = dict(_leaves(restore(ckpt, STEPS)))
    assert sorted(trees["port"]) == sorted(trees["ref"])
    assert any("/m/" in name for name in trees["ref"])
    for name, want in trees["ref"].items():
        got = trees["port"][name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        err = float(np.abs(got.astype(np.float64) - want).max(initial=0))
        scale = float(np.abs(want.astype(np.float64)).max(initial=0))
        assert err <= 1e-5 * scale, (case, name, err, scale)
