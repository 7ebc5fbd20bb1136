"""The MoE on every mesh the JAX package runs it on, against the reference,
on the CPU.

The reference chooses its path from the run, not from the plan
(``src/repro/models/moe.py::moe_apply``): ``_moe_shard_map``
(expert-parallel) when the rows have a batch axis and the ``model`` axis
divides the experts, else ``_moe_local``, the experts' weights sharded as
the plan placed them.  The port's ``models/moe.py`` takes the same rule.
Five cases on the smoke moonshot (8 experts top 2, capacity factor 8),
each the reference's loss and gradient (``jax_mesh_train.py``'s
``grads``: ``jax.value_and_grad`` of ``Model.loss`` jitted on host
devices, ``Auto`` axes, one process of four devices) against the port's
ranks (``torch_ranks.py``: gloo, one thread, ``device="cpu"``) at the
same weights and batch (``convert.py`` carries them across):

* **A** -- (1, 3), 6 experts: the hybrid plan replicates the experts
  (``ff`` 128 does not divide by 3), the reference runs them
  expert-parallel, each rank routing its third of the 48 rows (the
  aux loss a mean of the slices', not one process's; its weight 0.1,
  ten times the configs', so that the two stand apart by ten times the
  tolerance);
* **B** -- (1, 2), 3 heads and one kv head: the hybrid plan splits the
  experts' ``ff``, the reference runs them expert-parallel (the weights
  exchanged into whole experts);
* **C** -- (1, 2) with 3 experts and (1, 4) with 6: the tp plan splits
  ``ff``, the experts do not divide, the reference runs ``_moe_local``
  with the ``ff`` contraction reduced; also under Megatron-SP, and on the
  qwen3-moe smoke config (qk-norm) with 6 experts on (1, 4);
* **D** -- (2, 2) at a global batch of 1: ``data`` does not divide it,
  so there is no batch axis, and the reference runs ``_moe_local`` on the
  whole rows with the experts split by expert;
* **E** -- (1, 3) with the 8 experts: the hybrid plan replicates them and
  3 does not divide them, so ``_moe_local`` with nothing split.

Each: the loss within 1e-4 (relative) and every gradient within 1e-4 of
its largest magnitude of the reference's; the collectives show the path
(all-to-all iff expert-parallel); placed bytes ``==`` the dry-run's.
A-C also serve (2 x 12 + 4, weights stirred off their initial values;
C on (1, 2) also under SP) and the greedy tokens equal the reference's.

The trace: ``dryrun.trace_cell`` of qwen3-moe-235b-a22b at full width
(depth 2) on (1, 3) runs, and the smoke qwen3-moe with 3 heads, one kv
head and ``d_ff`` 96 on (1, 3) -- case C -- has traced collectives by
kind ``==`` a real three-rank run of the same step (train, prefill,
decode).
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
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models.model import Model

torch_parity.one_thread()

TIMEOUT_S = 420
TOL = 1e-4
MOON, QWEN = "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"
SERVE = {"seq": 16, "gen": 4, "batch": 2, "seed": 3}
# id: (arch, mesh, replace, global batch x seq, seq_shard, expert-parallel)
CASES = {
    "A": (MOON, (1, 3), {"n_experts": 6, "router_aux_weight": 0.1},
          (4, 12), False, True),
    "B": (MOON, (1, 2), {"n_heads": 3, "n_kv_heads": 1}, (4, 16), False,
          True),
    "C-1x2": (MOON, (1, 2), {"n_experts": 3}, (4, 16), False, False),
    "C-1x4": (MOON, (1, 4), {"n_experts": 6}, (4, 16), False, False),
    "C-1x2-sp": (MOON, (1, 2), {"n_experts": 3}, (4, 16), True, False),
    "C-1x4-sp": (MOON, (1, 4), {"n_experts": 6}, (4, 16), True, False),
    "C-qwen3": (QWEN, (1, 4), {"n_experts": 6}, (4, 16), False, False),
    "D": (MOON, (2, 2), {}, (1, 16), False, False),
    "E": (MOON, (1, 3), {}, (4, 12), False, False),
}
SERVED = ("A", "B", "C-1x2", "C-1x4", "C-qwen3", "C-1x2-sp")
# case C of the trace: 3 heads split, 8 experts that 3 does not divide
TRACE_SMALL = {"arch": QWEN, "replace": {"n_heads": 3, "n_kv_heads": 1,
                                         "d_ff": 96},
               "dims": (1, 3), "seq": 16, "batch": 4}
TRACE_MODES = ("train", "prefill", "decode")
TRACE_FULL = dict(arch=QWEN, shape=["probe", 1024, 2, "train"],
                  cfg_override={"n_layers": 2}, dims=[1, 3])


def _grads_case(cid):
    arch, dims, replace, (batch, seq), sp, _ep = CASES[cid]
    return dict(id=f"grads-{cid}", kind="grads", arch=arch, fsdp=False,
                seq=seq, batch=batch, replace=replace, seq_shard=sp)


def _serve_case(cid, weights):
    arch, dims, replace, _bs, sp, _ep = CASES[cid]
    return dict(id=f"serve-{cid}", kind="serve", arch=arch, fsdp=False,
                seq=SERVE["seq"], gen=SERVE["gen"], batch=SERVE["batch"],
                seed=SERVE["seed"], replace=replace, params=str(weights),
                seq_shard=sp)


def _stirred_weights(case, path):
    """The port's ``init_weights(3)`` of a case's config in the JAX
    package's tree, the matrices outside the embedding tripled and the
    vectors moved by N(0, 0.3), so every layer moves the logits;
    pickled to ``path``."""
    cfg = torch_ranks.case_config(case)
    model = Model(cfg, device="cpu").init_weights(SERVE["seed"])
    rng = np.random.default_rng(SERVE["seed"])

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


def _trace_step(mode):
    t = TRACE_SMALL
    case = dict(kind="step", arch=t["arch"], mode=mode, fsdp=False,
                seq=t["seq"], batch=t["batch"], replace=t["replace"],
                id=f"step-{mode}")
    call = dict(arch=t["arch"], shape=["small", t["seq"], t["batch"], mode],
                cfg_override=torch_ranks.config_override(case),
                dims=list(t["dims"]))
    return case, call


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_mesh")
    ref_cases, port, one = [], {}, {}
    for cid, (_a, dims, _r, _bs, sp, _ep) in CASES.items():
        case = _grads_case(cid)
        cfg = torch_ranks.case_config(case)
        model = Model(cfg, device="cpu", param_dtype=torch.float32)
        model.init_weights(5)
        batch = torch_ranks.case_batch(cfg, case)
        params, inputs = root / f"params-{cid}.pkl", root / f"batch-{cid}.pkl"
        with open(params, "wb") as f:
            pickle.dump(lm_params_to_numpy(cfg, model.state_dict()), f)
        with open(inputs, "wb") as f:
            pickle.dump({k: np.asarray(v) for k, v in batch.items()}, f)
        loss, _ = model.loss(batch)
        one[cid] = float(loss.detach())
        port.setdefault(dims, []).append(case)
        if not sp:
            ref_cases.append(dict(case, dims=list(dims), params=str(params),
                                  inputs=str(inputs)))
    for cid in SERVED:
        weights = root / f"weights-{cid}.pkl"
        case = _serve_case(cid, weights)
        _stirred_weights(case, weights)
        dims, sp = CASES[cid][1], CASES[cid][4]
        if not sp:
            ref_cases.append(dict(case, dims=list(dims)))
        port[dims].append(case)
    steps = [_trace_step(m) for m in TRACE_MODES]
    port[TRACE_SMALL["dims"]] += [case for case, _call in steps]

    (root / "ref").mkdir()
    job = root / "ref" / "job.json"
    job.write_text(json.dumps({"cases": ref_cases}))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(torch_ranks.ROOT / "src")}
    with open(root / "ref" / "log", "w") as log:
        ref = subprocess.Popen(
            [sys.executable, str(torch_ranks.ROOT / "tests" /
                                 "jax_mesh_train.py"), str(job)],
            env=env, cwd=root / "ref", stdout=log, stderr=subprocess.STDOUT)
    worlds = {dims: torch_ranks.start_world(
        dims, cases, root / "port" / "x".join(map(str, dims)))
        for dims, cases in port.items()}
    tracer = torch_ranks.start_traces(
        [call for _case, call in steps] + [TRACE_FULL], root / "traces")
    t0 = time.monotonic()

    def left():
        return max(TIMEOUT_S - (time.monotonic() - t0), 1.0)
    try:
        ranks = {dims: torch_ranks.wait_world(
            p, root / "port" / "x".join(map(str, dims)), left())
            for dims, p in worlds.items()}
        traced = torch_ranks.wait_traces(tracer, root / "traces", left())
        ref.wait(timeout=left())
        assert ref.returncode == 0, (root / "ref" / "log").read_text()[-4000:]
    finally:
        for p in [ref, tracer, *(q for ps in worlds.values() for q in ps)]:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(root / "ref" / "results.pkl", "rb") as f:
        ref_out = pickle.load(f)
    shutil.rmtree(root, ignore_errors=True)
    return {"ref": ref_out, "ranks": ranks, "one": one,
            "traced": dict(zip(TRACE_MODES, traced)), "full": traced[-1]}


def _reference_of(cid):
    """A case's reference: the same case without SP."""
    return cid.removesuffix("-sp")


@pytest.mark.parametrize("cid", list(CASES))
def test_loss_equals_the_reference(runs, cid):
    """Every rank's loss (nll + aux, summed over the ranks of other rows)
    within 1e-4 of the reference's."""
    want, _ = runs["ref"][f"grads-{_reference_of(cid)}"]
    dims = CASES[cid][1]
    for rank, res in enumerate(runs["ranks"][dims]):
        got = res[f"grads-{cid}"]
        loss = got["nll"] + got["aux"]
        assert abs(loss - want) <= TOL * abs(want), (cid, rank, loss, want)


@pytest.mark.parametrize("cid", list(CASES))
def test_gradients_equal_the_reference(runs, cid):
    """Every leaf's gradient, gathered whole on each rank, within 1e-4 of
    its largest magnitude of the reference's."""
    arch, dims, replace, _bs, _sp, _ep = CASES[cid]
    cfg = torch_ranks.case_config(_grads_case(cid))
    _, ref_tree = runs["ref"][f"grads-{_reference_of(cid)}"]
    want = lm_params_from_numpy(cfg, ref_tree, "cpu")
    for rank, res in enumerate(runs["ranks"][dims]):
        got = res[f"grads-{cid}"]["grads"]
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            err = float((got[name] - w).abs().max())
            scale = float(w.abs().max())
            assert err <= TOL * scale, (cid, rank, name, err, scale)


@pytest.mark.parametrize("cid", list(CASES))
def test_the_path_is_the_references(runs, cid):
    """All-to-all iff the reference's rule takes the experts
    expert-parallel; every rank makes the same collectives; the
    parameters placed on each rank are the dry-run's bytes."""
    ep = CASES[cid][5]
    dims = CASES[cid][1]
    res = [r[f"grads-{cid}"] for r in runs["ranks"][dims]]
    kinds = res[0]["collectives"]["dynamic_count"]
    assert ("all-to-all" in kinds) == ep, (cid, kinds)
    for r in res:
        assert r["collectives"] == res[0]["collectives"]
        assert r["local_param_bytes"] == r["shard_param_bytes"]


def test_case_a_on_the_mesh_is_not_one_process(runs):
    """Case A's reference on the mesh routes each third of the rows on its
    own (a mean of three aux losses), so its loss is not one process's:
    the path matters beyond the tolerance.  Case D's, with no batch axis,
    is."""
    ref_a, _ = runs["ref"]["grads-A"]
    assert abs(ref_a - runs["one"]["A"]) > TOL * abs(ref_a)
    ref_d, _ = runs["ref"]["grads-D"]
    assert abs(ref_d - runs["one"]["D"]) <= 1e-5 * abs(ref_d)


@pytest.mark.parametrize("cid", SERVED)
def test_serve_tokens_equal_the_reference(runs, cid):
    want = runs["ref"][f"serve-{_reference_of(cid)}"]
    assert want.shape == (SERVE["batch"], SERVE["gen"])
    for res in runs["ranks"][CASES[cid][1]]:
        got = res[f"serve-{cid}"]
        assert np.array_equal(got["tokens"], want), (cid, got["tokens"],
                                                     want)
        assert got["param_bytes"] == got["shard_param_bytes"]
        assert got["cache_bytes"] == got["shard_cache_bytes"]


@pytest.mark.parametrize("mode", TRACE_MODES)
def test_the_trace_of_case_c_counts_what_three_ranks_send(runs, mode):
    """The smoke qwen3-moe with its ``ff`` split over 3 ranks and its 8
    experts local: the traced step's collectives by kind ``==`` a real
    rank's, every rank's the same."""
    traced = runs["traced"][mode]
    assert traced["plan"] == "tp" and traced["mesh"] == [1, 3]
    real = [r[f"step-{mode}"] for r in runs["ranks"][TRACE_SMALL["dims"]]]
    assert all(r["collectives"] == real[0]["collectives"] for r in real)
    assert traced["collectives"] == real[0]["collectives"]
    assert "all-to-all" not in traced["collectives"]["dynamic_count"]
    args = dict(traced["memory"]["arguments"])
    if "cache" in args:
        args["cache"] -= 4                 # the position, counted as int32
    assert args == real[0]["arguments"]


def test_qwen3_moe_at_full_width_traces_on_three_ranks(runs):
    """qwen3-moe-235b-a22b at full width (depth 2) on (1, 3): 64 heads
    and 128 experts do not divide, ``d_ff`` 1,536 does, so the hybrid
    plan and the local path with the experts' ``ff`` split; a train step
    traces, its argument bytes the analytic ones."""
    res = runs["full"]
    assert res["plan"] == "hybrid" and res["mesh"] == [1, 3]
    mem = res["memory"]
    assert mem["arguments"] == res["arg_bytes_per_device"]
    assert res["cost"]["flops"] > 0
    kinds = res["collectives"]["dynamic_count"]
    assert kinds.get("all-reduce", 0) > 0 and "all-to-all" not in kinds
