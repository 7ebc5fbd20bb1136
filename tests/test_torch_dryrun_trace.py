"""The traced half of the port's dry-run (``launch/dryrun.py::trace_cell``,
``run_cell(..., trace=True)``) and the options and roofline of its
``run_cell``, on the CPU.

A trace starts a process group of fake ranks, so every trace runs in a
subprocess (``torch_ranks.start_traces``: one process, one thread, its
results as JSON), beside the rank worlds of the real runs it is held
against; this process starts no group.

* **The trace counts what a real run sends** (c).  The same step -- a
  train step (``remat="full"``), a prefill and a decode step of
  ``dryrun.cell_step`` -- at the same small size, smollm-360m (kv heads
  split), recurrentgemma-2b (one kv head, a ring cache) and
  moonshot-v1-16b-a3b (the experts over ``model``), with and without
  ``seq_shard``, in bfloat16, on meshes (1, 2) and (2, 2): traced on
  fake ranks, and
  run by gloo rank processes on real tensors.  The traced collectives
  (calls and result bytes by kind) equal the real ranks' with ``==``, and
  so do the arguments' bytes.
* **Traced arguments match the analytic ones** (d): for every one of
  those traces, for a train step with FSDP forced, and for one
  production cell of each mode, the traced argument bytes equal
  ``run_cell``'s analytic ``arg_bytes_per_device``, part by part, with
  ``==``.
* **Traced FLOPs against the cost model** (e).  A prefill of 2 x 4,096
  at full width and depth 2 (recurrentgemma-2b 3 and llama-3.2-vision-11b
  5, so that each layer kind of the pattern is there; whisper-base's
  encoder 2) on mesh (1, 1): the traced FLOPs within 3 % of
  ``cell_cost(...).flops``.  The two count the same products (K6-K9 by
  formulas written as the cost model counts them), and differ where the
  cost model counts work that ``FlopCounterMode`` does not see or counts
  another way: the depthwise convolutions and the RG-LRU's gates
  (elementwise; and the cost model's gate blocks are ``w // 8`` wide,
  the port's ``w / n_heads``), and whisper's encoder, whose attention is
  not causal but which the cost model counts as causal (2.7 % more
  here).  A train step is not compared term by term: the cost model
  counts four forwards and an embedding product that the port's lookup
  does not make, while the port's backward recomputes K6 and K7 in plain
  torch (attention over every pair of positions).
* **The reference's formulas** (f).  ``run_cell``'s
  ``analytic_flops_per_device`` (with ``cp``'s attention shards) and
  every term of its ``roofline`` equal the JAX package's
  (``src/repro/launch/dryrun.py``) recomputed here from the same inputs
  with the reference's cost model and the H100's constants, on all 32
  cells, with ``cp`` off and on; a traced roofline's collective term is
  the traced bytes over the NVLink rate.
* **The CLI** (g): ``python -m repro_torch.launch.dryrun --trace`` on
  three whole production cells in a subprocess, within 240 s.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jax.sharding import AbstractMesh

import torch_parity
import torch_ranks
from repro.launch import sharding as ref_sharding
from repro.utils import costmodel as ref_costmodel
from repro_torch.configs import SHAPES, get_config, valid_cells
from repro_torch.launch import dryrun

torch_parity.one_thread()

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH = 16, 4
TIMEOUT_S = 300
WORLDS = {"1x2": (1, 2), "2x2": (2, 2)}
# bfloat16, the type the analytic half counts a serve's parameters in
BF16 = {"dtype": "bfloat16"}
ARCHS = {"smollm-360m": BF16, "recurrentgemma-2b": {"window": 8, **BF16},
         "moonshot-v1-16b-a3b": BF16}
MODES = ("train", "prefill", "decode")
FLOPS_TOL = 0.03
FLOPS_DEPTH = {"recurrentgemma-2b": 3, "llama-3.2-vision-11b": 5}
FLOPS_ARCHS = ("smollm-360m", "gemma2-2b", "moonshot-v1-16b-a3b",
               "recurrentgemma-2b", "mamba2-2.7b", "whisper-base",
               "llama-3.2-vision-11b")
# one production cell of each mode, on 16 x 16
PRODUCTION = [("whisper-base", "train_4k"), ("smollm-360m", "prefill_32k"),
              ("mamba2-2.7b", "long_500k")]


def _small(arch, mode, sp):
    """A small step case (for the rank worlds) and its trace call."""
    case = dict(kind="step", arch=arch, mode=mode, fsdp=False, seq=SEQ,
                batch=BATCH, replace=ARCHS[arch], seq_shard=sp)
    call = dict(arch=arch, shape=["small", SEQ, BATCH, mode],
                cfg_override=torch_ranks.config_override(case),
                seq_shard=sp)
    return case, call


def _small_ids():
    return [(a, m, sp) for a in ARCHS for m in MODES
            for sp in ((False, True) if m != "decode" else (False,))]


def _flops_call(arch):
    over = {"n_layers": FLOPS_DEPTH.get(arch, 2)}
    if arch == "whisper-base":
        over["enc_layers"] = 2
    return dict(arch=arch, shape=["probe", 4096, 2, "prefill"],
                cfg_override=over, dims=[1, 1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun_trace")
    small = [_small(*k) for k in _small_ids()]
    calls = [dict(c, dims=list(d)) for d in WORLDS.values()
             for _case, c in small]
    fsdp = dict(_small("smollm-360m", "train", False)[1], dims=[2, 2],
                fsdp=True)
    other = ([fsdp] + [_flops_call(a) for a in FLOPS_ARCHS]
             + [dict(arch=a, shape=s) for a, s in PRODUCTION])
    procs = {"small": torch_ranks.start_traces(calls, root / "small"),
             "other": torch_ranks.start_traces(other, root / "other")}
    worlds = {w: torch_ranks.start_world(
        d, [dict(case, id=f"{case['arch']}-{case['mode']}-"
                 f"{case['seq_shard']}") for case, _c in small], root / w)
        for w, d in WORLDS.items()}
    try:
        real = {w: torch_ranks.wait_world(p, root / w, TIMEOUT_S)
                for w, p in worlds.items()}
        traced = torch_ranks.wait_traces(procs["small"], root / "small",
                                         TIMEOUT_S)
        rest = torch_ranks.wait_traces(procs["other"], root / "other",
                                       TIMEOUT_S)
    finally:
        for p in [procs["small"], procs["other"],
                  *[q for ps in worlds.values() for q in ps]]:
            if p.poll() is None:
                p.kill()
                p.wait()
    shutil.rmtree(root, ignore_errors=True)
    n = len(small)
    by_world = {w: dict(zip(_small_ids(), traced[i * n:(i + 1) * n]))
                for i, w in enumerate(WORLDS)}
    k = len(FLOPS_ARCHS)
    return {"real": real, "traced": by_world, "fsdp": rest[0],
            "flops": dict(zip(FLOPS_ARCHS, rest[1:1 + k])),
            "production": rest[1 + k:]}


SMALL_IDS = [(w, *k) for w in WORLDS for k in _small_ids()]


@pytest.mark.parametrize("world,arch,mode,sp", SMALL_IDS,
                         ids=[f"{w}-{a}-{m}-{'sp' if sp else 'nosp'}"
                              for w, a, m, sp in SMALL_IDS])
def test_the_trace_counts_what_a_real_run_sends(runs, world, arch, mode, sp):
    traced = runs["traced"][world][(arch, mode, sp)]
    assert traced["seq_shard"] == sp and traced["mode"] == mode
    real = [r[f"{arch}-{mode}-{sp}"] for r in runs["real"][world]]
    assert all(r["collectives"] == real[0]["collectives"] for r in real)
    assert traced["collectives"] == real[0]["collectives"]
    assert traced["collectives"]["total_bytes"] > 0
    args = dict(traced["memory"]["arguments"])
    if "cache" in args:
        args["cache"] -= 4                 # the position, counted as int32
    assert args == real[0]["arguments"]


@pytest.mark.parametrize("world,arch,mode,sp", SMALL_IDS,
                         ids=[f"{w}-{a}-{m}-{'sp' if sp else 'nosp'}"
                              for w, a, m, sp in SMALL_IDS])
def test_traced_arguments_equal_the_analytic_ones(runs, world, arch, mode,
                                                  sp):
    res = runs["traced"][world][(arch, mode, sp)]
    _check_arguments(res)


def _check_arguments(res):
    mem = res["memory"]
    assert mem["arguments"] == res["arg_bytes_per_device"]
    assert mem["argument_bytes"] == res["total_arg_bytes_per_device"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] > 0 and res["cost"]["flops"] > 0


def test_traced_arguments_under_fsdp_equal_the_analytic_ones(runs):
    res = runs["fsdp"]
    assert res["fsdp"] and res["plan"] == "tp"
    _check_arguments(res)
    assert res["collectives"]["dynamic_count"]["reduce-scatter"] > 0


@pytest.mark.parametrize("i", range(len(PRODUCTION)),
                         ids=[f"{a}-{s}" for a, s in PRODUCTION])
def test_a_production_cell_traces_its_analytic_arguments(runs, i):
    res = runs["production"][i]
    assert (res["arch"], res["shape"]) == PRODUCTION[i]
    assert res["chips"] == 256
    _check_arguments(res)


@pytest.mark.parametrize("arch", FLOPS_ARCHS)
def test_traced_flops_are_the_cost_models(runs, arch):
    from repro_torch.configs.base import ShapeCell
    from repro_torch.utils.costmodel import cell_cost

    res = runs["flops"][arch]
    call = _flops_call(arch)
    cfg, cell = dryrun.cell_config(arch, ShapeCell(*call["shape"]),
                                   call["cfg_override"])
    want = cell_cost(cfg, cell, 1).flops
    got = res["cost"]["flops"]
    assert abs(got - want) <= FLOPS_TOL * want, (arch, got / want)
    kernels = {k for k in res["cost"]["flops_by_op"]
               if k.startswith("repro_torch.")}
    assert kernels, res["cost"]["flops_by_op"]


def _reference_terms(res, cfg, cell, cp, coll_bytes):
    """``src/repro/launch/dryrun.py``'s flops_dev and roofline, from the
    same inputs, with the reference's cost model and the H100's
    constants."""
    chips = res["chips"]
    ac = ref_costmodel.cell_cost(cfg, cell, chips, remat=res["remat"])
    if res["plan"] == "tp":
        flops_dev = ac.flops / chips
    else:
        s_eff = 1 if cell.mode == "decode" else cell.seq_len
        af = ref_costmodel.attention_fraction(
            cfg, s_eff, cell.seq_len if cell.mode == "decode"
            else (cell.seq_len + 1) / 2, cell.mode)
        mesh = AbstractMesh(tuple(res["mesh"]), tuple(res["axes"]))
        bspec = tuple(ref_sharding.make_plan(cfg, mesh).batch_spec(
            mesh, cell.global_batch))
        batch_shards = 1
        if bspec:
            for a in (bspec[0] if isinstance(bspec[0], tuple)
                      else (bspec[0],)):
                batch_shards *= mesh.shape[a]
        attn_shards = chips if (cp and cell.mode == "prefill") \
            else batch_shards
        flops_dev = ac.flops * (af / attn_shards + (1 - af) / chips)
    compute_s = flops_dev / dryrun.H100_PEAK_BF16_FLOPS
    memory_s = res["analytic_bytes_per_device"] / dryrun.H100_HBM_BYTES_PER_S
    terms = [("compute", compute_s), ("memory", memory_s)]
    collective_s = None
    if coll_bytes is not None:
        collective_s = coll_bytes / dryrun.H100_NVLINK_BYTES_PER_S
        terms.append(("collective", collective_s))
    step_s = max(v for _k, v in terms)
    mflops = res["model_flops_global"]
    return flops_dev, {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "step_s": step_s,
        "dominant": max(terms, key=lambda kv: kv[1])[0],
        "useful_flops_frac": mflops / ac.flops if ac.flops else None,
        "mfu_bound": (mflops / chips / step_s) / dryrun.H100_PEAK_BF16_FLOPS}


def _ref_config(arch, shape):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_get_config

    cell = REF_SHAPES[shape]
    return ref_get_config(arch).replace(max_seq=cell.seq_len), cell


@pytest.mark.parametrize("cp", [False, True], ids=["nocp", "cp"])
@pytest.mark.parametrize("arch,shape", valid_cells(),
                         ids=[f"{a}-{s}" for a, s in valid_cells()])
def test_run_cell_terms_are_the_reference_formulas(arch, shape, cp):
    res = dryrun.run_cell(arch, shape, cp=cp)
    cfg, cell = _ref_config(arch, shape)
    flops_dev, roof = _reference_terms(res, cfg, cell, cp, None)
    assert res["analytic_flops_per_device"] == flops_dev
    assert res["roofline"] == roof
    assert res["cp"] == cp and "memory" not in res
    if cp and res["plan"] == "hybrid" and cell.mode == "prefill":
        assert flops_dev < dryrun.run_cell(
            arch, shape)["analytic_flops_per_device"]


@pytest.mark.parametrize("i", range(len(PRODUCTION)),
                         ids=[f"{a}-{s}" for a, s in PRODUCTION])
def test_a_traced_roofline_is_the_reference_formula(runs, i):
    res = runs["production"][i]
    cfg, cell = _ref_config(res["arch"], res["shape"])
    coll = res["collectives"]["total_bytes"]
    _flops, roof = _reference_terms(res, cfg, cell, False, coll)
    assert res["roofline"] == roof


def test_run_cell_takes_the_references_options():
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import force_fsdp, make_plan

    cfg = get_config("smollm-360m").replace(
        max_seq=SHAPES["train_4k"].seq_len)
    plan = force_fsdp(make_plan(cfg, make_production_mesh()))
    res = dryrun.run_cell("smollm-360m", "train_4k", plan_override=plan,
                          cfg_override={"n_layers": 4}, seq_shard=True)
    assert res["fsdp"] and res["seq_shard"]
    base = dryrun.run_cell("smollm-360m", "train_4k")
    assert res["model_flops_global"] < base["model_flops_global"]
    assert res["arg_bytes_per_device"]["params"] < \
        base["arg_bytes_per_device"]["params"]
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "HBM_BYTES"):
        assert not hasattr(dryrun, name)      # no v5e constant left


def test_the_cli_traces_whole_cells(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    lines = []
    for argv in (["--arch", "whisper-base", "--shape", "decode_32k",
                  "--both-meshes"],
                 ["--arch", "mamba2-2.7b", "--shape", "long_500k",
                  "--seq-shard"]):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--trace",
             "--out", str(tmp_path), *argv], capture_output=True, text=True,
            timeout=240, env=env, cwd=tmp_path)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "requested cells traced." in out.stdout
        lines += [ln for ln in out.stdout.splitlines()
                  if ln.startswith("[OK]")]
    assert len(lines) == 3 and all(" traced: " in ln for ln in lines)
    assert len(list(tmp_path.glob("*.json"))) == 3


def test_this_process_never_has_a_process_group(runs):
    assert not torch.distributed.is_initialized()
