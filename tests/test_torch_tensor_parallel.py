"""The model axis of the port's mesh runs (``launch/tensor_parallel.py``,
``launch/distributed.py``) against its own one-process run, on the CPU.

Three worlds, one a mesh: (1, 2) and (2, 2) as (data, model), and (2, 1)
for the MoE.  Each rank is a subprocess (``torch_ranks.py``: gloo over a
``file://`` store under ``tmp_path``, one thread, ``device="cpu"``) that
runs every case of its world in one launch; the worlds run at once,
under one timeout, while this process computes the one-process results.
The smoke configs cover every plan kind:

* ``tp`` with kv heads split (llama-3.2-vision-11b, gemma2-2b's sandwich
  norm, the MoE's experts) and kept whole, the decode cache then split by
  sequence (recurrentgemma-2b: one kv head, its local layers' ring);
* ``hybrid`` (smollm-360m with 3 heads, which 2 does not divide), with
  and without ``cp``: attention whole on every rank, the MLP and the
  vocabulary split, the cache split by sequence;
* the SSM's heads (mamba2-2.7b), whisper-base with a vocabulary that 2
  does not divide (replicated), and FSDP forced on over (2, 2).

Serving: the tokens equal the one-process serve's and the last logits
are within 1e-5 of their scale; every rank's placed parameters and cache
are ``dryrun.shard_bytes``'s; no all-gather of a sequence-split serve
carries as many elements as one whole cache leaf.  Training: 3 steps,
every loss within 1e-5 (relative) of the one-process run's, the
parameters after them within 1e-4 of their largest magnitude, and one
step's gradients, gathered whole, within 1e-4 of their largest
magnitude.  The conjugate operators pass ``gradcheck`` in float64; a
gather or reduce-scatter over one rank makes no call.
"""
import shutil

import pytest
import torch

import torch_parity
import torch_ranks
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.serve import ServeConfig, serve
from repro_torch.launch.steps import train_params
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models.model import Model

torch_parity.one_thread()

SEQ, BATCH, STEPS, GEN = 16, 4, 3, 4
TIMEOUT_S = 240
HYBRID = {"n_heads": 3, "n_kv_heads": 1}
# (case id, arch, config fields replaced, cp)
SERVES = {
    "1x2": [("vlm-kv-split", "llama-3.2-vision-11b", {}, False),
            ("ring-seq-cache", "recurrentgemma-2b", {"window": 24}, False),
            ("hybrid", "smollm-360m", HYBRID, False),
            ("hybrid-cp", "smollm-360m", HYBRID, True),
            ("ssm", "mamba2-2.7b", {}, False),
            ("sandwich", "gemma2-2b", {}, False),
            ("audio-vocab-whole", "whisper-base", {"vocab": 513}, False),
            ("moe", "moonshot-v1-16b-a3b", {}, False)],
    "2x2": [("tp", "smollm-360m", {}, False),
            ("ring-seq-cache", "recurrentgemma-2b", {"window": 24}, False)],
    "2x1": [("moe", "moonshot-v1-16b-a3b", {}, False)],
}
# (case id, arch, config fields replaced, FSDP forced)
TRAINS = {
    "1x2": [("tp", "smollm-360m", {}, False),
            ("hybrid", "smollm-360m", HYBRID, False),
            ("recurrent", "recurrentgemma-2b", {}, False),
            ("ssm", "mamba2-2.7b", {}, False),
            ("sandwich", "gemma2-2b", {}, False)],
    "2x2": [("fsdp", "smollm-360m", {}, True)],
}
WORLDS = {"1x2": (1, 2), "2x2": (2, 2), "2x1": (2, 1)}


def _cases(world):
    out = [dict(id=f"serve-{c}", kind="serve", arch=a, fsdp=False,
                seq=SEQ + GEN, gen=GEN, batch=BATCH, replace=r, cp=cp)
           for c, a, r, cp in SERVES.get(world, [])]
    for c, a, r, f in TRAINS.get(world, []):
        base = dict(arch=a, fsdp=f, seq=SEQ, batch=BATCH, replace=r)
        out += [dict(base, id=f"train-{c}", kind="train", steps=STEPS),
                dict(base, id=f"grads-{c}", kind="grads")]
    if world == "1x2":
        out.append(dict(id="gradcheck", kind="gradcheck"))
    return out


def _key(arch, replace):
    return arch, tuple(sorted(replace.items()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tensor_parallel")
    started = {w: torch_ranks.start_world(d, _cases(w), root / w)
               for w, d in WORLDS.items()}
    try:
        base = {"serve": {}, "train": {}, "grads": {}}
        for cases in SERVES.values():
            for _c, arch, rep, _cp in cases:
                cfg = smoke_config(arch).replace(max_seq=SEQ + GEN, **rep)
                base["serve"].setdefault(_key(arch, rep), serve(
                    cfg, ServeConfig(batch=BATCH, prompt_len=SEQ,
                                     gen_len=GEN, seed=3), device="cpu"))
        for cases in TRAINS.values():
            for _c, arch, rep, _f in cases:
                if _key(arch, rep) in base["train"]:
                    continue
                cfg = smoke_config(arch).replace(max_seq=SEQ, **rep)
                out = train(cfg, TrainConfig(
                    steps=STEPS, log_every=1, ckpt_every=1000, seed=5,
                    ckpt_dir=str(root / f"one-{arch}-{len(rep)}")),
                    data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH,
                                        vocab=cfg.vocab, seed=7),
                    device="cpu")
                base["train"][_key(arch, rep)] = (out["losses"], {
                    n: p.detach().clone()
                    for n, p in out["model"].named_parameters()})
                model = Model(cfg, device="cpu",
                              param_dtype=torch.float32).init_weights(5)
                params = train_params(model)
                loss, _ = model.loss(torch_ranks.case_batch(
                    cfg, dict(seq=SEQ, batch=BATCH)))
                base["grads"][_key(arch, rep)] = dict(zip(
                    params, torch.autograd.grad(loss,
                                                list(params.values()))))
        results = {w: torch_ranks.wait_world(procs, root / w, TIMEOUT_S)
                   for w, procs in started.items()}
    finally:
        for procs in started.values():
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    shutil.rmtree(root, ignore_errors=True)
    return base, results


SERVE_IDS = [(w, c, a, r) for w, cases in SERVES.items()
             for c, a, r, _cp in cases]


@pytest.mark.parametrize("world,case,arch,rep", SERVE_IDS,
                         ids=[f"{w}-{c}" for w, c, _a, _r in SERVE_IDS])
def test_serve_equals_one_process(runs, world, case, arch, rep):
    base, results = runs
    want = base["serve"][_key(arch, rep)]
    scale = float(want["logits"].abs().max())
    for rank, res in enumerate(results[world]):
        got = res[f"serve-{case}"]
        assert (got["tokens"] == want["tokens"]).all(), (world, case, rank)
        err = float((got["logits"] - want["logits"]).abs().max())
        assert err <= 1e-5 * scale, (world, case, rank, err, scale)


@pytest.mark.parametrize("world,case,arch,rep", SERVE_IDS,
                         ids=[f"{w}-{c}" for w, c, _a, _r in SERVE_IDS])
def test_serve_places_the_dry_runs_bytes(runs, world, case, arch, rep):
    _, results = runs
    full = Model(smoke_config(arch).replace(**rep), device="meta")
    whole = sum(p.numel() * p.element_size() for p in full.parameters())
    for rank, res in enumerate(results[world]):
        got = res[f"serve-{case}"]
        assert got["param_bytes"] == got["shard_param_bytes"], (world, case)
        assert got["cache_bytes"] == got["shard_cache_bytes"], (world, case)
        if WORLDS[world][-1] > 1:
            assert got["param_bytes"] < whole, (world, case, rank)


@pytest.mark.parametrize("world", ["1x2", "2x2"])
def test_a_sequence_split_cache_is_never_gathered(runs, world):
    """recurrentgemma-2b's local layers keep a ring of 24 slots, 12 a
    rank: no all-gather of the serve (prefill and decode) carries as
    many elements as one whole ring leaf ``[B, 24, 1, 16]``."""
    _, results = runs
    cfg = smoke_config("recurrentgemma-2b")
    rows = BATCH // WORLDS[world][0]
    leaf = rows * 24 * cfg.n_kv_heads * cfg.hd
    for res in results[world]:
        got = res["serve-ring-seq-cache"]
        assert 0 < got["largest_gather"] < leaf, (world, got["largest_gather"])


TRAIN_IDS = [(w, c, a, r) for w, cases in TRAINS.items()
             for c, a, r, _f in cases]


@pytest.mark.parametrize("world,case,arch,rep", TRAIN_IDS,
                         ids=[f"{w}-{c}" for w, c, _a, _r in TRAIN_IDS])
def test_train_equals_one_process(runs, world, case, arch, rep):
    base, results = runs
    want_losses, want_params = base["train"][_key(arch, rep)]
    for rank, res in enumerate(results[world]):
        got = res[f"train-{case}"]
        assert [s for s, _ in got["losses"]] == list(range(STEPS))
        for (s, g), (_, w) in zip(got["losses"], want_losses):
            assert abs(g - w) <= 1e-5 * abs(w), (world, case, rank, s, g, w)
        assert got["local_param_bytes"] == got["shard_param_bytes"]
        assert got["opt_bytes"] == 2 * got["shard_param_bytes"]
        assert sorted(got["params"]) == sorted(want_params)
        for name, w in want_params.items():
            err = float((got["params"][name] - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()), (world, case, name,
                                                        err)


@pytest.mark.parametrize("world,case,arch,rep", TRAIN_IDS,
                         ids=[f"{w}-{c}" for w, c, _a, _r in TRAIN_IDS])
def test_gradients_equal_one_process(runs, world, case, arch, rep):
    base, results = runs
    want = base["grads"][_key(arch, rep)]
    for rank, res in enumerate(results[world]):
        got = res[f"grads-{case}"]
        assert got["aux"] == 0.0
        assert sorted(got["grads"]) == sorted(want)
        for name, w in want.items():
            err = float((got["grads"][name] - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()), (world, case, rank,
                                                        name, err)


@pytest.mark.parametrize("op", ["copy_reduce", "split_gather",
                                "gather_shards", "exchange"])
def test_conjugate_operators_pass_gradcheck(runs, op):
    _, results = runs
    assert all(res["gradcheck"][op] for res in results["1x2"])


def test_this_process_never_has_a_process_group(runs):
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter"])
def test_a_group_of_one_rank_makes_no_call(monkeypatch, op):
    """Over one rank a gather or reduce-scatter is a copy on the device:
    no ``torch.distributed`` call (gloo would take a CUDA tensor through
    the host for it) and nothing added to ``TRANSPORT``."""
    from repro_torch.launch import tensor_parallel as tpc

    def refuse(*args, **kwargs):
        raise AssertionError("a collective was called over one rank")

    for name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        monkeypatch.setattr(tpc.dist, name, refuse)
    tpc.reset_transport()
    t = torch.arange(12.0).view(3, 4)
    out = getattr(tpc, op)(t.t(), 1, None, 1)
    assert torch.equal(out, t.t()) and out.is_contiguous()
    assert out.data_ptr() != t.data_ptr()
    assert tpc.TRANSPORT["calls"] == 0
