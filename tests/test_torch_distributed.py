"""``train(..., mesh=)`` and ``serve(..., mesh=)`` across ranks
(``repro_torch/launch/distributed.py``) against the one-process run, on
the CPU.

Three worlds, one a mesh: (2, 1) and (4, 1) as (data, model), (2, 2, 1)
as (pod, data, model).  Each rank is a subprocess (``torch_ranks.py``:
gloo over a ``file://`` store under ``tmp_path``, one thread,
``device="cpu"``) that runs every case of its world in one launch; the
three worlds run at once, under one timeout, while this process computes
the one-process results.  The cases use the smoke configs:

* train, 3 steps at a global batch of 4 x 16: smollm-360m on every mesh
  with FSDP as the plan says (off: the smoke configs are small) and
  forced on; recurrentgemma-2b and mamba2-2.7b on (2, 1) with FSDP forced
  on.  Every loss within 1e-5 (relative) of the one-process run on the
  same global batch, every parameter after step 3 within 1e-5 of its
  largest magnitude, and each rank's parameter bytes (and AdamW's, twice
  them) equal to ``dryrun.shard_bytes`` under the mesh and plan.
* a checkpoint's peak, on every mesh: smollm-360m cut to 12 layers (its
  largest leaf, the embedding, a fourteenth of the model), FSDP forced
  on, one step; while a checkpoint of the result is gathered, no rank but
  0 (whose host, the device here, keeps the tree) has more bytes
  allocated than the full model's parameters.
* serve on (2, 1), all three configs, FSDP off and forced on: the
  generated tokens equal to the one-process serve's, the last logits
  within 1e-5 of their scale.
* checkpoints (smollm-360m, FSDP on, on (2, 1) and (2, 2, 1)): a mesh run
  to step 2 writes a checkpoint; the restart to step 4 under the mesh and
  in one process match a straight one-process run within 1e-4, and a mesh
  run restarts from a one-process checkpoint as well.

* a model axis above 1 (smollm-360m on (1, 2), (2, 2) and (1, 2, 4) as
  (pod, data, model)): train and serve equal to one process (the
  model axis itself is ``test_torch_tensor_parallel.py``'s), and a config
  with experts on (2, 1), each rank routing its own rows.

This process never has a process group.
"""
import shutil
from pathlib import Path

import pytest
import torch

import torch_parity
import torch_ranks
from repro_torch.checkpoint.checkpoint import latest_step
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.serve import ServeConfig, serve
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models.model import Model

torch_parity.one_thread()

WORLDS = {"2x1": (2, 1), "4x1": (4, 1), "2x2x1": (2, 2, 1)}
SEQ, BATCH, STEPS, GEN = 16, 4, 3, 4
TRAIN = [("smollm-360m", False), ("smollm-360m", True)]
TRAIN_2X1 = [("recurrentgemma-2b", True), ("mamba2-2.7b", True)]
SERVE = ["smollm-360m", "recurrentgemma-2b", "mamba2-2.7b"]
CKPT_WORLDS = ("2x1", "2x2x1")
PEAK_REPLACE = {"n_layers": 12}
TIMEOUT_S = 240


def _train_cases(world):
    runs = TRAIN + (TRAIN_2X1 if world == "2x1" else [])
    return [dict(id=f"train-{a}-{'fsdp' if f else 'dp'}", kind="train",
                 arch=a, fsdp=f, seq=SEQ, batch=BATCH, steps=STEPS)
            for a, f in runs]


def _serve_cases(world):
    if world != "2x1":
        return []
    return [dict(id=f"serve-{a}-{'fsdp' if f else 'dp'}", kind="serve",
                 arch=a, fsdp=f, seq=SEQ + GEN, gen=GEN, batch=BATCH)
            for a in SERVE for f in (False, True)]


def _ckpt_cases(world, root: Path):
    if world not in CKPT_WORLDS:
        return []
    base = dict(kind="train", arch="smollm-360m", fsdp=True, seq=SEQ,
                batch=BATCH)
    return [dict(base, id="ckpt-write", steps=2, ckpt_every=2,
                 ckpt_dir=str(root / world / "mesh_ckpt")),
            dict(base, id="ckpt-resume-mesh", steps=4,
                 ckpt_dir=str(root / world / "mesh_ckpt")),
            dict(base, id="ckpt-resume-one", steps=4,
                 ckpt_dir=str(root / world / "one_ckpt"))]


def _peak_cases(world):
    return [dict(id="ckpt-peak", kind="train", arch="smollm-360m",
                 fsdp=True, seq=SEQ, batch=BATCH, steps=1, peak=True,
                 replace=PEAK_REPLACE)]


def _one_process_train(arch, steps, ckpt_dir, ckpt_every=1000):
    cfg = smoke_config(arch).replace(max_seq=SEQ)
    tc = TrainConfig(steps=steps, log_every=1, ckpt_every=ckpt_every,
                     ckpt_dir=str(ckpt_dir), seed=5)
    dc = DataConfig(seq_len=SEQ, global_batch=BATCH, vocab=cfg.vocab, seed=7)
    return train(cfg, tc, data_cfg=dc, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks")
    # a one-process checkpoint at step 2 for the mesh runs to restart from
    one = root / "one_ckpt_src"
    _one_process_train("smollm-360m", 2, one, ckpt_every=2)
    started = {}
    for world, dims in WORLDS.items():
        if world in CKPT_WORLDS:
            shutil.copytree(one, root / world / "one_ckpt")
        cases = (_train_cases(world) + _serve_cases(world)
                 + _ckpt_cases(world, root) + _peak_cases(world)
                 + _experts_cases(world))
        started[world] = torch_ranks.start_world(dims, cases, root / world)
    for world, dims in MODEL_WORLDS.items():
        started[world] = torch_ranks.start_world(dims, _model_cases(),
                                                 root / world)

    try:
        # the one-process results, while the ranks run
        base = {"train": {}, "serve": {}}
        for arch in {a for a, _ in TRAIN + TRAIN_2X1}:
            out = _one_process_train(arch, STEPS, root / f"straight-{arch}")
            base["train"][arch] = (out["losses"], {
                n: p.detach().clone()
                for n, p in out["model"].named_parameters()})
        for arch in SERVE:
            cfg = smoke_config(arch).replace(max_seq=SEQ + GEN)
            base["serve"][arch] = serve(cfg, ServeConfig(
                batch=BATCH, prompt_len=SEQ, gen_len=GEN, seed=3),
                device="cpu")
        base["straight4"] = _one_process_train("smollm-360m", 4,
                                               root / "straight4")["losses"]
        cfg = smoke_config(EXPERTS).replace(max_seq=SEQ + GEN)
        base["serve"][EXPERTS] = serve(cfg, ServeConfig(
            batch=BATCH, prompt_len=SEQ, gen_len=GEN, seed=3), device="cpu")
        base["experts-loss"] = _experts_first_loss()
        results = {world: torch_ranks.wait_world(procs, root / world,
                                                 TIMEOUT_S)
                   for world, procs in started.items()}
    finally:
        for procs in started.values():       # none left behind
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return root, base, results


def _experts_first_loss() -> float:
    """The first loss of a (2, 1) mesh's training of the experts' config:
    the global batch's nll plus the mean of the two row shards' aux."""
    cfg = smoke_config(EXPERTS).replace(max_seq=SEQ)
    model = Model(cfg, device="cpu",
                  param_dtype=torch.float32).init_weights(5)
    batch = torch_ranks.case_batch(cfg, dict(seq=SEQ, batch=BATCH))
    with torch.no_grad():
        nll = model.loss(batch)[1]["nll"]
        half = BATCH // 2
        aux = [model.loss({k: v[i * half:(i + 1) * half]
                           for k, v in batch.items()})[1]["aux"]
               for i in range(2)]
    return float(nll + (aux[0] + aux[1]) / 2)


def _close(got, want, tol, what):
    assert abs(got - want) <= tol * abs(want), (what, got, want)


TRAIN_IDS = [(w, c["id"]) for w in WORLDS for c in _train_cases(w)]


@pytest.mark.parametrize("world,case", TRAIN_IDS,
                         ids=[f"{w}-{c}" for w, c in TRAIN_IDS])
def test_train_equals_one_process(runs, world, case):
    _, base, results = runs
    arch = next(a for a, _ in TRAIN + TRAIN_2X1 if f"-{a}-" in case)
    want_losses, want_params = base["train"][arch]
    for rank, res in enumerate(results[world]):
        got = res[case]
        assert [s for s, _ in got["losses"]] == list(range(STEPS))
        for (s, g), (_, w) in zip(got["losses"], want_losses):
            _close(g, w, 1e-5, (world, case, rank, s))
        assert got["local_param_bytes"] == got["shard_param_bytes"]
        assert got["opt_bytes"] == 2 * got["shard_param_bytes"]
        assert sorted(got["params"]) == sorted(want_params)
        for name, w in want_params.items():
            err = float((got["params"][name] - w).abs().max())
            assert err <= 1e-5 * float(w.abs().max()), (world, case, name,
                                                       err)
    full = sum(p.numel() * 4 for p in want_params.values())
    if case.endswith("fsdp"):
        assert results[world][0][case]["local_param_bytes"] < full


@pytest.mark.parametrize("world", WORLDS)
def test_a_checkpoint_gathers_one_leaf_at_a_time(runs, world):
    cfg = smoke_config("smollm-360m").replace(**PEAK_REPLACE)
    sizes = [p.numel() * 4 for p in Model(cfg, device="meta").parameters()]
    full = sum(sizes)
    assert 10 * max(sizes) < full
    _, _, results = runs
    for rank, res in enumerate(results[world][1:], 1):
        got = res["ckpt-peak"]
        assert got["local_param_bytes"] < full
        assert 0 < got["checkpoint_peak_bytes"] < full, (
            world, rank, got["checkpoint_peak_bytes"], full)


SERVE_IDS = [c["id"] for c in _serve_cases("2x1")]


@pytest.mark.parametrize("case", SERVE_IDS)
def test_serve_equals_one_process(runs, case):
    _, base, results = runs
    arch = next(a for a in SERVE if f"-{a}-" in case)
    want = base["serve"][arch]
    scale = float(want["logits"].abs().max())
    for res in results["2x1"]:
        got = res[case]
        assert (got["tokens"] == want["tokens"]).all(), case
        assert got["logits"].shape == want["logits"].shape
        err = float((got["logits"] - want["logits"]).abs().max())
        assert err <= 1e-5 * scale, (case, err, scale)


@pytest.mark.parametrize("world", CKPT_WORLDS)
def test_restart_from_a_mesh_checkpoint_matches_a_straight_run(runs,
                                                               world):
    root, base, results = runs
    straight = dict(base["straight4"])
    mesh_ckpt = root / world / "mesh_ckpt"
    assert latest_step(mesh_ckpt) == 2
    for res in results[world]:
        wrote = dict(res["ckpt-write"]["losses"])
        resumed = dict(res["ckpt-resume-mesh"]["losses"])
        assert sorted(wrote) == [0, 1] and sorted(resumed) == [2, 3]
        for s, g in {**wrote, **resumed}.items():
            _close(g, straight[s], 1e-4, (world, "mesh", s))
    # the same checkpoint restarted in one process
    one = root / world / "mesh_ckpt_one_process"
    shutil.copytree(mesh_ckpt, one)
    out = _one_process_train("smollm-360m", 4, one)
    assert [s for s, _ in out["losses"]] == [2, 3]
    for s, g in out["losses"]:
        _close(g, straight[s], 1e-4, (world, "one process", s))


@pytest.mark.parametrize("world", CKPT_WORLDS)
def test_a_mesh_run_restarts_from_a_one_process_checkpoint(runs, world):
    _, base, results = runs
    straight = dict(base["straight4"])
    for res in results[world]:
        got = res["ckpt-resume-one"]["losses"]
        assert [s for s, _ in got] == [2, 3]
        for s, g in got:
            _close(g, straight[s], 1e-4, (world, s))


MODEL_WORLDS = {"1x2": (1, 2), "2x2": (2, 2), "1x2x4": (1, 2, 4)}
EXPERTS = "qwen3-moe-235b-a22b"


def _model_cases():
    base = dict(arch="smollm-360m", fsdp=False, batch=BATCH)
    return [dict(base, id="model-train", kind="train", seq=SEQ,
                 steps=STEPS),
            dict(base, id="model-serve", kind="serve", seq=SEQ + GEN,
                 gen=GEN)]


def _experts_cases(world):
    if world != "2x1":
        return []
    base = dict(arch=EXPERTS, fsdp=False, batch=BATCH)
    return [dict(base, id="experts-train", kind="train", seq=SEQ, steps=1),
            dict(base, id="experts-serve", kind="serve", seq=SEQ + GEN,
                 gen=GEN)]


@pytest.mark.parametrize("entry", ["train", "serve"])
@pytest.mark.parametrize("dims", list(MODEL_WORLDS.values()))
def test_a_model_axis_above_one_runs(runs, entry, dims):
    """``train`` and ``serve`` on meshes whose model axis is 2 or 4 (2 x 2:
    data and model; 1 x 2 x 4: pod, data, model), equal to one
    process."""
    _, base, results = runs
    world = next(w for w, d in MODEL_WORLDS.items() if d == dims)
    for rank, res in enumerate(results[world]):
        if entry == "train":
            got = res["model-train"]
            want, _ = base["train"]["smollm-360m"]
            for (s, g), (_, w) in zip(got["losses"], want):
                _close(g, w, 1e-5, (world, rank, s))
            assert len(got["losses"]) == STEPS
            assert got["local_param_bytes"] == got["shard_param_bytes"]
        else:
            got, want = res["model-serve"], base["serve"]["smollm-360m"]
            assert (got["tokens"] == want["tokens"]).all(), (world, rank)
            err = float((got["logits"] - want["logits"]).abs().max())
            assert err <= 1e-5 * float(want["logits"].abs().max())
            assert got["param_bytes"] == got["shard_param_bytes"]
            assert got["cache_bytes"] == got["shard_cache_bytes"]


@pytest.mark.parametrize("entry", ["train", "serve"])
def test_a_config_with_experts_runs_on_a_mesh(runs, entry):
    """qwen3's smoke config (8 experts, no token dropped) on (2, 1): each
    rank routes its own rows with the capacity of its own tokens, the
    reference's path on a model axis of 1.  Served, it equals one process;
    trained, its first loss is the global batch's nll plus the mean of
    the two row shards' aux losses (the reference's ``pmean``)."""
    _, base, results = runs
    for res in results["2x1"]:
        if entry == "serve":
            got, want = res["experts-serve"], base["serve"][EXPERTS]
            assert (got["tokens"] == want["tokens"]).all()
            err = float((got["logits"] - want["logits"]).abs().max())
            assert err <= 1e-5 * float(want["logits"].abs().max())
        else:
            (_, got), = res["experts-train"]["losses"]
            _close(got, base["experts-loss"], 1e-5, "experts")


def test_the_entry_points_run_as_torchrun_starts_them(tmp_path):
    """``python -m repro_torch.launch.train`` and ``...serve`` with
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` set, ``--mesh 2,1`` and a
    ``file://`` store: two ranks each, all four at once."""
    import os
    import subprocess
    import sys

    args = {"train": ["--steps", "2", "--seq", "16", "--batch", "4",
                      "--ckpt-dir", str(tmp_path / "ckpt")],
            "serve": ["--batch", "2", "--prompt", "6", "--gen", "3"]}
    procs = []
    for entry, extra in args.items():
        for rank in range(2):
            env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2",
                   "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1",
                   "PYTHONPATH": str(torch_ranks.ROOT / "src")}
            procs.append((entry, rank, subprocess.Popen(
                [sys.executable, "-m", f"repro_torch.launch.{entry}",
                 "--arch", "smollm-360m", "--smoke", "--device", "cpu",
                 "--mesh", "2,1", "--store",
                 f"file://{tmp_path / (entry + '_store')}", *extra],
                env=env, cwd=tmp_path, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    outs = {}
    try:
        for entry, rank, proc in procs:
            outs[entry, rank] = proc.communicate(timeout=120)[0]
            assert proc.returncode == 0, (entry, rank, outs[entry, rank])
    finally:
        for _e, _r, proc in procs:
            if proc.poll() is None:
                proc.kill()
    assert "over 1 steps" in outs["train", 0]
    assert outs["serve", 0].count("sample:") == 1
    assert not torch.distributed.is_initialized()


def test_this_process_never_has_a_process_group(runs):
    """Last in the file: after every multi-rank case has run."""
    assert not torch.distributed.is_initialized()
