"""The port's mesh runs across ranks against the JAX package's on the same
meshes, on the CPU.

One process of the reference on two host devices (``jax_mesh_train.py``,
``XLA_FLAGS`` set in that process alone, ``Auto`` axes) runs every
reference case of the module in one job, while the port's ranks
(``torch_ranks.py``: gloo over a ``file://`` store under ``tmp_path``,
one thread, ``device="cpu"``) run theirs, each world in one launch, all
under one timeout.

* **Training.**  Each case resumes one checkpoint on both sides: a
  one-process run of the port to step 1 (the smoke config, a global batch
  of 4 x 16), written in the format both packages read.  From it each
  trains to step 4 and checkpoints there.  On (2, 1) as (data, model),
  smollm-360m with FSDP as the plan says (off at this size) and forced on:
  every loss of steps 1-3 within 1e-5 (relative), and every leaf of the
  step-4 checkpoints (parameters, AdamW's ``m`` and ``v``) within 1e-5 of
  its largest magnitude.  On the model axis, (1, 2): smollm-360m,
  recurrentgemma-2b, gemma2-2b and moonshot-v1-16b-a3b (through the
  reference's ``_moe_shard_map``); and moonshot on (2, 1): every loss
  within 1e-4 (relative), every leaf of the step-4 checkpoints (rank 0
  gathers the leaves split over ``model`` too) within 1e-4 of its largest
  magnitude.  mamba2-2.7b's reference ``train`` fails on (1, 2) (ROADMAP
  R12), the audio and vlm ones (R13).
* **Serving** on (1, 2), the seven configs the reference serves there:
  the same weights on both sides (the port's ``init_weights(3)``, the
  layers' weights tripled and the norm scales and vlm gates moved off
  their initial values, so that every layer moves the logits), the same
  prompts: the generated tokens equal.
* ``cp_attention`` on (1, 2) against the reference's own, within 1e-5 of
  the output's scale (causal, window 6).
* ``compressed_psum`` over a ``pod`` axis of two: the reference's values,
  among them R11's (each participant quantised with its own scale, the
  sum taken at the largest).
"""
import json
import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_parity
import torch_ranks
from repro_torch.checkpoint.checkpoint import latest_step, restore
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_to_numpy
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models.model import Model

torch_parity.one_thread()

SEQ, BATCH, START, STEPS, DATA_SEED = 16, 4, 1, 4, 7
GEN, SERVE_SEED = 4, 3
ARCH = "smollm-360m"
TIMEOUT_S = 300
# (case id, arch, mesh dims, FSDP forced, loss tolerance)
TRAINS = [("dp", ARCH, (2, 1), False, 1e-5),
          ("fsdp", ARCH, (2, 1), True, 1e-5),
          ("tp-smollm-360m", ARCH, (1, 2), False, 1e-4),
          ("tp-recurrentgemma-2b", "recurrentgemma-2b", (1, 2), False, 1e-4),
          ("tp-gemma2-2b", "gemma2-2b", (1, 2), False, 1e-4),
          ("ep-moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b", (1, 2), False,
           1e-4),
          ("dp-moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b", (2, 1), False,
           1e-4)]
SERVES = ["smollm-360m", "recurrentgemma-2b", "mamba2-2.7b",
          "moonshot-v1-16b-a3b", "llama-3.2-vision-11b", "whisper-base",
          "gemma2-2b"]
CP_WINDOW = 6
PSUM_GRADS = [[1.0, -0.5, 0.25], [10.0, 3.0, -7.0]]
R11_MEAN = [10.0, -1.0236, -2.2441]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, path + (i,))
    else:
        yield "/".join(map(str, path)), np.asarray(tree)


def _serve_weights(arch, path):
    """The port's ``init_weights(SERVE_SEED)`` of the smoke config, in the
    JAX package's tree, stirred: matrices outside the embedding tripled,
    vectors and scalars moved by N(0, 0.3); pickled to ``path``."""
    cfg = smoke_config(arch).replace(max_seq=SEQ + GEN)
    model = Model(cfg, device="cpu").init_weights(SERVE_SEED)
    rng = np.random.default_rng(SERVE_SEED)

    def stir(tree, path=()):
        if isinstance(tree, dict):
            return {k: stir(v, path + (k,)) for k, v in sorted(tree.items())}
        if "embed" in path:
            return tree
        if tree.ndim >= 2:
            return tree * np.float32(3.0)
        return tree + rng.normal(0.0, 0.3, tree.shape).astype(tree.dtype)

    with open(path, "wb") as f:
        pickle.dump(stir(lm_params_to_numpy(cfg, model.state_dict())), f)


def _start(root, arch):
    ckpt = root / "start" / arch
    if latest_step(ckpt) is None:
        cfg = smoke_config(arch).replace(max_seq=SEQ)
        train(cfg, TrainConfig(steps=START, log_every=1, ckpt_every=START,
                               ckpt_dir=str(ckpt), seed=5),
              data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH,
                                  vocab=cfg.vocab, seed=DATA_SEED),
              device="cpu")
    assert latest_step(ckpt) == START
    return ckpt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_reference")
    ref_cases, port = [], {}
    for case, arch, dims, fsdp, _tol in TRAINS:
        start = _start(root, arch)
        for side in ("ref", "port"):
            ckpt = root / side / case
            shutil.copytree(start, ckpt)
            c = dict(id=case, kind="train", arch=arch, fsdp=fsdp, seq=SEQ,
                     batch=BATCH, steps=STEPS, ckpt_every=STEPS,
                     ckpt_dir=str(ckpt), data_seed=DATA_SEED,
                     dims=list(dims))
            if side == "ref":
                ref_cases.append(c)
            else:
                port.setdefault(dims, []).append(c)
    for arch in SERVES:
        weights = root / f"weights-{arch}.pkl"
        _serve_weights(arch, weights)
        c = dict(id=f"serve-{arch}", kind="serve", arch=arch, fsdp=False,
                 seq=SEQ + GEN, gen=GEN, batch=BATCH, seed=SERVE_SEED,
                 params=str(weights), dims=[1, 2])
        ref_cases.append(c)
        port[(1, 2)].append(c)
    rng = np.random.default_rng(0)
    inputs = root / "cp_inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({n: rng.standard_normal(
            (2, SEQ, 4 if n == "q" else 2, 16)).astype(np.float32)
            for n in ("q", "k", "v")}, f)
    cp = dict(id="cp", kind="cp", window=CP_WINDOW, inputs=str(inputs),
              dims=[1, 2])
    psum = dict(id="psum", kind="psum", grads=PSUM_GRADS, dims=[2, 1, 1])
    ref_cases += [cp, psum]
    port[(1, 2)].append(cp)
    port[(2, 1, 1)] = [psum]

    (root / "ref").mkdir(exist_ok=True)
    job = root / "ref" / "job.json"
    job.write_text(json.dumps({"cases": ref_cases}))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": str(torch_ranks.ROOT / "src")}
    with open(root / "ref" / "log", "w") as log:
        ref = subprocess.Popen(
            [sys.executable, str(torch_ranks.ROOT / "tests" /
                                 "jax_mesh_train.py"), str(job)],
            env=env, cwd=root / "ref", stdout=log, stderr=subprocess.STDOUT)
    procs = {dims: torch_ranks.start_world(
        dims, cases, root / "port" / "x".join(map(str, dims)))
        for dims, cases in port.items()}
    t0 = time.monotonic()
    try:
        ref.wait(timeout=TIMEOUT_S)
        assert ref.returncode == 0, (root / "ref" / "log").read_text()[-4000:]
        ranks = {dims: torch_ranks.wait_world(
            p, root / "port" / "x".join(map(str, dims)),
            max(TIMEOUT_S - (time.monotonic() - t0), 1.0))
            for dims, p in procs.items()}
    finally:
        for p in [ref, *(q for ps in procs.values() for q in ps)]:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(root / "ref" / "results.pkl", "rb") as f:
        ref_out = pickle.load(f)
    return root, ref_out, ranks


def _train_case(case):
    return next(t for t in TRAINS if t[0] == case)


@pytest.mark.parametrize("case", ["dp", "fsdp"])
def test_mesh_losses_equal_the_reference_mesh_train(runs, case):
    _check_losses(runs, case)


@pytest.mark.parametrize("case", [t[0] for t in TRAINS[2:]])
def test_model_axis_losses_equal_the_reference(runs, case):
    _check_losses(runs, case)


def _check_losses(runs, case):
    _, ref_out, ranks = runs
    _c, _arch, dims, _f, tol = _train_case(case)
    want = ref_out[case]
    assert [s for s, _ in want] == list(range(START, STEPS))
    for rank, res in enumerate(ranks[dims]):
        got = res[case]["losses"]
        assert [s for s, _ in got] == [s for s, _ in want]
        for (s, g), (_, w) in zip(got, want):
            assert abs(g - w) <= tol * abs(w), (case, rank, s, g, w)


@pytest.mark.parametrize("case", ["dp", "fsdp"])
def test_mesh_checkpoint_equals_the_reference_mesh_train(runs, case):
    _check_checkpoint(runs, case, 1e-5)


@pytest.mark.parametrize("case", [t[0] for t in TRAINS[2:]])
def test_model_axis_checkpoint_equals_the_reference(runs, case):
    """The step-4 checkpoints, which the port's rank 0 gathers leaf by
    leaf (leaves split over ``model`` included): every leaf within 1e-4
    of its largest magnitude of the reference's."""
    _check_checkpoint(runs, case, 1e-4)


def _check_checkpoint(runs, case, tol):
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
        assert err <= tol * scale, (case, name, err, scale)


@pytest.mark.parametrize("arch", SERVES)
def test_model_axis_serve_tokens_equal_the_reference(runs, arch):
    _, ref_out, ranks = runs
    want = ref_out[f"serve-{arch}"]
    assert want.shape == (BATCH, GEN)
    for res in ranks[(1, 2)]:
        got = res[f"serve-{arch}"]
        assert np.array_equal(got["tokens"], want), (arch, got["tokens"],
                                                     want)
        assert got["param_bytes"] == got["shard_param_bytes"]
        assert got["cache_bytes"] == got["shard_cache_bytes"]


def test_cp_attention_equals_the_reference(runs):
    _, ref_out, ranks = runs
    want = ref_out["cp"]
    for res in ranks[(1, 2)]:
        got = res["cp"]["out"].numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_compressed_psum_equals_the_reference(runs):
    _, ref_out, ranks = runs
    mean, err = ref_out["psum"]
    np.testing.assert_allclose(mean[0], R11_MEAN, atol=1e-4)
    for rank, res in enumerate(ranks[(2, 1, 1)]):
        np.testing.assert_array_equal(res["psum"]["mean"].numpy(),
                                      mean[rank])
        np.testing.assert_array_equal(res["psum"]["error"].numpy(),
                                      err[rank])
    assert np.abs(mean[0] - np.mean(PSUM_GRADS, axis=0)).max() > 1.0
