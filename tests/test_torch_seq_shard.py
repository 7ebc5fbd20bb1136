"""Megatron-SP on the model axis (``MeshRun(..., seq_shard=True)``, the
JAX package's ``set_mesh_axes(..., seq_shard=True)``) against the same
run without it, on the CPU.

Three worlds, the ones ``test_torch_tensor_parallel.py`` starts: (1, 2)
and (2, 2) as (data, model), and (1, 2, 4) as (pod, data, model), whose
four model ranks leave the smoke configs' two kv heads whole.  Each rank
is a subprocess (``torch_ranks.py``: gloo over a ``file://`` store under
``tmp_path``, one thread, ``device="cpu"``) that runs every case of its
world twice, with ``seq_shard`` off and on; this process starts no
group.  The smoke configs cover every layer kind under a ``tp`` plan:
recurrentgemma-2b (``recurrent`` and ``local``, one kv head),
mamba2-2.7b (``ssm``), moonshot-v1-16b-a3b (the MoE, with a capacity
that drops tokens), whisper-base (``enc`` and ``encdec``; also with a
vocabulary of 513 that no axis divides, so the embedding is cut and the
unembedding gathered whole), llama-3.2-vision-11b (``cross``) and
smollm-360m (``global``).

* **Values** (a).  Float32: the last logits of a serve (prefill and 3
  decode steps) within 1e-5 of their scale, and the tokens equal; one
  step's gradients, gathered whole, each within 1e-5 of its largest
  magnitude; 3 train steps' losses within 1e-5 (relative).  On two
  ranks a reduce-scatter adds the same two numbers the all-reduce adds;
  on four the order may differ, which 1e-5 of the scale covers.  A
  bfloat16 serve's tokens equal.  Under a hybrid plan (smollm-360m with
  3 heads on (1, 2)) ``seq_shard`` is ignored: the logits, gradients and
  collectives are equal with ``==``.
* **Collectives by kind** (b).  A prefill step: each all-reduce at a TP
  boundary -- the embedding's sum, and the exit of every block's split
  work -- becomes one reduce-scatter, and each block's entry one
  all-gather of the sequence (the embedding has no entry, and the
  prefill's last positions take one all-gather to reach the
  unembedding), so the all-reduces fall by the number of boundaries and
  the reduce-scatters and all-gathers rise by it.  Boundaries a layer
  kind: ``global``, ``local``, ``cross``, ``enc``, ``recurrent`` 2 (the
  attention or recurrence, and the MLP), ``ssm`` 1, ``encdec`` 3, plus 1
  for the embedding; an MoE layer's boundary is its attention's, and its
  experts add one all-gather (the rows are gathered whole before the
  dispatch, so it routes the rows it routes without SP), as does an
  encoder's output (gathered whole for the cross-attention).  A decode
  step (one position) makes the same collectives either way.
"""
import json
import shutil

import numpy as np
import pytest
import torch

import torch_parity
import torch_ranks
from repro_torch.configs import smoke_config
from repro_torch.models.transformer import stack_kinds

torch_parity.one_thread()

SEQ, BATCH, STEPS, GEN = 16, 4, 3, 4
TIMEOUT_S = 300
TOL = 1e-5
HYBRID = {"n_heads": 3, "n_kv_heads": 1}
DROPS = {"capacity_factor": 0.5}
# (batch, seq) of the MoE's whole-rows gradient: 8 rows, under 8 a rank
MOE_ROWS = (1, 8)
WORLDS = {"1x2": (1, 2), "2x2": (2, 2), "1x2x4": (1, 2, 4)}
# (case id, arch, config fields replaced): served, and one step's
# gradients, with seq_shard off and on
CASES = {
    "1x2": [("recurrent", "recurrentgemma-2b", {}),
            ("ssm", "mamba2-2.7b", {}),
            ("moe-drops", "moonshot-v1-16b-a3b", DROPS),
            ("audio", "whisper-base", {}),
            ("audio-vocab-whole", "whisper-base", {"vocab": 513}),
            ("vlm", "llama-3.2-vision-11b", {}),
            ("hybrid", "smollm-360m", HYBRID)],
    "2x2": [("global", "smollm-360m", {}),
            ("recurrent", "recurrentgemma-2b", {}),
            ("moe-drops", "moonshot-v1-16b-a3b", DROPS)],
    "1x2x4": [("global-kv-whole", "smollm-360m", {}),
              ("recurrent", "recurrentgemma-2b", {})],
}
BF16 = {"1x2": [("recurrent-bf16", "recurrentgemma-2b",
                 {"dtype": "bfloat16"})],
        "2x2": [("global-bf16", "smollm-360m", {"dtype": "bfloat16"})]}
TRAINS = {"1x2": [("recurrent", "recurrentgemma-2b", {})],
          "2x2": [("moe-drops", "moonshot-v1-16b-a3b", DROPS)]}
# (case id, arch, config fields replaced): one prefill and one decode
# step, off and on, for their collectives
STEPS_OF = {"1x2": [("recurrent", "recurrentgemma-2b", {}),
                    ("ssm", "mamba2-2.7b", {}),
                    ("moe", "moonshot-v1-16b-a3b", {}),
                    ("audio", "whisper-base", {}),
                    ("vlm", "llama-3.2-vision-11b", {}),
                    ("hybrid", "smollm-360m", HYBRID)],
            "2x2": [("global", "smollm-360m", {})],
            "1x2x4": [("global-kv-whole", "smollm-360m", {})]}


def _cases(world):
    out = []
    for sp in (False, True):
        tag = "sp" if sp else "nosp"
        for c, a, r in CASES.get(world, []) + BF16.get(world, []):
            out.append(dict(id=f"serve-{c}-{tag}", kind="serve", arch=a,
                            fsdp=False, seq=SEQ + GEN, gen=GEN, batch=BATCH,
                            replace=r, seq_shard=sp))
        for c, a, r in CASES.get(world, []):
            out.append(dict(id=f"grads-{c}-{tag}", kind="grads", arch=a,
                            fsdp=False, seq=SEQ, batch=BATCH, replace=r,
                            seq_shard=sp))
        for c, a, r in TRAINS.get(world, []):
            out.append(dict(id=f"train-{c}-{tag}", kind="train", arch=a,
                            fsdp=False, seq=SEQ, batch=BATCH, replace=r,
                            steps=STEPS, seq_shard=sp))
        for c, a, r in STEPS_OF.get(world, []):
            for mode in ("prefill", "decode"):
                out.append(dict(id=f"{mode}-{c}-{tag}", kind="step",
                                mode=mode, arch=a, fsdp=False, seq=SEQ,
                                batch=BATCH, replace=r, seq_shard=sp))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_shard")
    started = {w: torch_ranks.start_world(d, _cases(w), root / w)
               for w, d in WORLDS.items()}
    try:
        results = {w: torch_ranks.wait_world(procs, root / w, TIMEOUT_S)
                   for w, procs in started.items()}
    finally:
        for procs in started.values():
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    shutil.rmtree(root, ignore_errors=True)
    return results


def _pairs(results, world, cid):
    """Each rank's (without SP, with SP) results of a case."""
    return [(r[f"{cid}-nosp"], r[f"{cid}-sp"]) for r in results[world]]


SERVE_IDS = [(w, c) for w in WORLDS
             for c, _a, _r in CASES.get(w, []) + BF16.get(w, [])]


@pytest.mark.parametrize("world,case", SERVE_IDS,
                         ids=[f"{w}-{c}" for w, c in SERVE_IDS])
def test_serve_with_seq_shard_equals_without(runs, world, case):
    for rank, (off, on) in enumerate(_pairs(runs, world, f"serve-{case}")):
        assert np.array_equal(on["tokens"], off["tokens"]), (world, case,
                                                             rank)
        if case.endswith("bf16"):
            continue
        scale = float(off["logits"].abs().max())
        err = float((on["logits"] - off["logits"]).abs().max())
        assert err <= TOL * scale, (world, case, rank, err, scale)
        if case == "hybrid":              # seq_shard is ignored there
            assert torch.equal(on["logits"], off["logits"])
            assert on["collectives"] == off["collectives"]


GRAD_IDS = [(w, c) for w in WORLDS for c, _a, _r in CASES.get(w, [])]


@pytest.mark.parametrize("world,case", GRAD_IDS,
                         ids=[f"{w}-{c}" for w, c in GRAD_IDS])
def test_gradients_with_seq_shard_equal_without(runs, world, case):
    for rank, (off, on) in enumerate(_pairs(runs, world, f"grads-{case}")):
        assert abs(on["nll"] - off["nll"]) <= TOL * abs(off["nll"])
        assert abs(on["aux"] - off["aux"]) <= TOL * max(abs(off["aux"]),
                                                        1e-30)
        assert sorted(on["grads"]) == sorted(off["grads"])
        for name, want in off["grads"].items():
            err = float((on["grads"][name] - want).abs().max())
            scale = float(want.abs().max())
            assert err <= TOL * scale, (world, case, rank, name, err, scale)
            if case == "hybrid":
                assert torch.equal(on["grads"][name], want), name
        if case == "hybrid":
            assert on["collectives"] == off["collectives"]


@pytest.mark.parametrize("world", ["1x2", "2x2"])
def test_the_moe_drops_tokens_and_routes_them_alike(runs, world):
    """Capacity factor 0.5 drops assignments (the gradients' step and the
    serve each drop some on the world's ranks), with and without SP the
    same number on each rank (the same rows routed in the same
    order)."""
    for cid in ("grads-moe-drops", "serve-moe-drops"):
        pairs = _pairs(runs, world, cid)
        assert sum(off["dropped"] for off, _on in pairs) > 0, (world, cid)
        for rank, (off, on) in enumerate(pairs):
            assert on["dropped"] == off["dropped"], (world, cid, rank)


TRAIN_IDS = [(w, c) for w in WORLDS for c, _a, _r in TRAINS.get(w, [])]


@pytest.mark.parametrize("world,case", TRAIN_IDS,
                         ids=[f"{w}-{c}" for w, c in TRAIN_IDS])
def test_train_with_seq_shard_equals_without(runs, world, case):
    for rank, (off, on) in enumerate(_pairs(runs, world, f"train-{case}")):
        assert [s for s, _ in on["losses"]] == list(range(STEPS))
        for (s, got), (_, want) in zip(on["losses"], off["losses"]):
            assert abs(got - want) <= TOL * abs(want), (world, case, rank,
                                                        s, got, want)
        for name, want in off["params"].items():
            err = float((on["params"][name] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (world, name, err)


def _boundaries(arch, replace) -> tuple[int, int]:
    """(TP boundaries, extra all-gathers) of a smoke config's prefill
    under SP: the embedding, then per layer its attention or recurrence
    (``encdec`` two: self- and cross-attention) and its dense MLP; the
    extra gathers are the MoE layers' (their rows) and an encoder's
    output, gathered whole for the cross-attention."""
    cfg = smoke_config(arch).replace(**replace)
    mlp = 0 if cfg.n_experts else 1
    blocks = {"ssm": 1, "encdec": 2 + mlp}
    kinds = stack_kinds(cfg)
    enc = stack_kinds(cfg, decoder=False) if cfg.family == "audio" else []
    b = 1 + sum(blocks.get(k, 1 + mlp) for k in kinds + enc)
    extra = (sum(1 for k in kinds if k != "ssm") if cfg.n_experts
             else 0) + (1 if enc else 0)
    return b, extra


def _count(coll, kind):
    return coll["dynamic_count"].get(kind, 0)


STEP_IDS = [(w, c, a, r) for w in WORLDS for c, a, r in STEPS_OF.get(w, [])]


@pytest.mark.parametrize("world,case,arch,rep", STEP_IDS,
                         ids=[f"{w}-{c}" for w, c, _a, _r in STEP_IDS])
def test_each_boundary_all_reduce_becomes_a_reduce_scatter_and_a_gather(
        runs, world, case, arch, rep):
    b, extra = _boundaries(arch, rep)
    hybrid = case == "hybrid"
    for off, on in _pairs(runs, world, f"prefill-{case}"):
        off, on = off["collectives"], on["collectives"]
        if hybrid:
            assert on == off
            continue
        assert _count(off, "all-reduce") - _count(on, "all-reduce") == b
        assert _count(on, "reduce-scatter") - _count(off,
                                                     "reduce-scatter") == b
        assert _count(on, "all-gather") - _count(off,
                                                 "all-gather") == b + extra
        assert _count(on, "all-to-all") == _count(off, "all-to-all")
    for off, on in _pairs(runs, world, f"decode-{case}"):
        assert on["collectives"] == off["collectives"]


@pytest.fixture(scope="module")
def moe_rows(tmp_path_factory):
    """moonshot-v1-16b-a3b's gradients at 1 x 8 tokens on mesh (1, 2),
    fewer than 8 rows a model rank, so every rank routes the whole rows:
    the port's ranks (``seq_shard`` off and on), the port in one process,
    and the JAX package on two host devices (``jax_mesh_train.py``, the
    same weights and batch)."""
    import os
    import pickle
    import subprocess
    import sys

    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.launch.steps import train_params
    from repro_torch.models.model import Model

    root = tmp_path_factory.mktemp("moe_rows")
    case = dict(arch="moonshot-v1-16b-a3b", fsdp=False, seq=MOE_ROWS[1],
                batch=MOE_ROWS[0], kind="grads")
    procs = torch_ranks.start_world(
        (1, 2), [dict(case, id=f"rows-{sp}", seq_shard=sp)
                 for sp in (False, True)], root / "ranks")
    cfg = torch_ranks.case_config(case)
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    model.init_weights(5)
    batch = torch_ranks.case_batch(cfg, case)
    with open(root / "params.pkl", "wb") as f:
        pickle.dump(lm_params_to_numpy(cfg, model.state_dict()), f)
    with open(root / "batch.pkl", "wb") as f:
        pickle.dump({k: np.asarray(v) for k, v in batch.items()}, f)
    job = root / "job.json"
    job.write_text(json.dumps({"cases": [dict(
        case, id="ref", dims=[1, 2], params=str(root / "params.pkl"),
        inputs=str(root / "batch.pkl"))]}))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": os.pathsep.join([str(torch_ranks.ROOT / "src"),
                                          str(torch_ranks.ROOT / "tests")])}
    ref = subprocess.Popen(
        [sys.executable, str(torch_ranks.ROOT / "tests" / "jax_mesh_train.py"),
         str(job)], env=env, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        params = train_params(model)
        loss, _ = model.loss(batch)
        one = dict(zip(params, torch.autograd.grad(loss,
                                                   list(params.values()))))
        ranks = torch_ranks.wait_world(procs, root / "ranks", TIMEOUT_S)
        log, _ = ref.communicate(timeout=TIMEOUT_S)
    finally:
        for p in [ref, *procs]:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert ref.returncode == 0, log.decode()[-3000:]
    with open(root / "results.pkl", "rb") as f:
        ref_loss, ref_grads = pickle.load(f)["ref"]
    shutil.rmtree(root, ignore_errors=True)
    return {"one": (float(loss.detach()), one), "ranks": ranks,
            "ref": (ref_loss, lm_params_from_numpy(cfg, ref_grads, "cpu"))}


def _within(got: dict, want: dict, tol: float, what):
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= tol * float(w.abs().max()), (what, name, err)


@pytest.mark.parametrize("sp", [False, True], ids=["nosp", "sp"])
def test_the_moe_routing_whole_rows_takes_the_right_gradients(moe_rows, sp):
    """The port's mesh gradients equal its one process's within 1e-5 of
    each leaf's scale (before, the whole-rows branch raised under a
    gradient: each expert took every rank's copy of the tokens), and the
    JAX package's mesh gradients within 1e-4 (across frameworks, as
    ``test_torch_train.py`` holds them)."""
    one_loss, one = moe_rows["one"]
    ref_loss, ref = moe_rows["ref"]
    assert abs(ref_loss - one_loss) <= 1e-5 * abs(one_loss)
    _within(ref, one, 1e-4, "reference")
    for rank, res in enumerate(moe_rows["ranks"]):
        got = res[f"rows-{sp}"]
        assert abs(got["nll"] + got["aux"] - one_loss) <= 1e-5 * one_loss
        _within(got["grads"], one, 1e-5, ("port", rank))
        _within(got["grads"], ref, 1e-4, ("reference", rank))


def test_this_process_never_has_a_process_group(runs):
    assert not torch.distributed.is_initialized()
