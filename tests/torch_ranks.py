"""Rank processes for the port's multi-rank tests, and the thread setting
of every port test.

Nothing here imports JAX or the JAX package: a rank is a process of the
port alone.  ``start_world`` starts one subprocess a rank of a mesh --
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in its environment, as
``torchrun`` sets them, ``OMP_NUM_THREADS=1`` -- running this file on a
job file; each rank joins a gloo process group through a ``file://``
store under the test's ``tmp_path`` (no port to collide on), runs every
case of the job in order with ``device="cpu"``, writes its results with
``torch.save`` and leaves the group.  ``wait_world`` waits for all of
them with one timeout and kills what is left.  No process group is ever
started in the test's own process.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def one_thread() -> None:
    """Run torch on one intra-op and one inter-op thread in this process.
    The suite runs in several worker processes at once, and a worker's
    default of one thread a core oversubscribes the machine; every
    ``test_torch_*.py`` calls this at its top (``torch_parity`` exports
    it), and every rank process does.  The inter-op pool can be sized
    once a process, before its first use."""
    torch.set_num_threads(1)
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:            # already set, or already in use
        pass


def start_world(dims, cases: list, workdir: Path) -> list:
    """Start the ranks of a mesh of ``dims`` (as ``make_mesh`` names them)
    on ``cases`` (dicts for :func:`run_case`); returns the processes."""
    workdir.mkdir(parents=True, exist_ok=True)
    job = workdir / "job.json"
    job.write_text(json.dumps({"dims": list(dims), "cases": cases,
                               "store": f"file://{workdir / 'store'}"}))
    world = 1
    for n in dims:
        world *= n
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")])}
        log = open(workdir / f"rank{rank}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(job)], env=env, cwd=workdir,
            stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def wait_world(procs: list, workdir: Path, timeout: float) -> list:
    """Each rank's results, after all ranks ended (killed at ``timeout``
    seconds); a rank that failed raises with the end of its log."""
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    out = []
    for rank, p in enumerate(procs):
        log = (workdir / f"rank{rank}.log").read_text()
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {workdir.name} exited "
                               f"{p.returncode}:\n{log[-4000:]}")
        out.append(torch.load(workdir / f"rank{rank}.pt",
                              weights_only=False))
    return out


# ------------------------------------------------------------- a rank
def run_case(case: dict, mesh) -> dict:
    """One case on this rank: ``train`` or ``serve`` of a smoke config
    (``replace``: fields of the config to change) on ``mesh`` with
    ``device="cpu"``, FSDP as the plan says or forced, ``cp`` for a serve;
    a serve of ``params`` (a pickled tree of the JAX package's layout)
    holds those weights.  Each records its placed bytes beside
    ``dryrun.shard_bytes``'s."""
    import pickle

    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.dryrun import (abstract_cache, abstract_params,
                                           shard_bytes)
    from repro_torch.launch.serve import ServeConfig, serve
    from repro_torch.launch.sharding import (cache_pspecs, force_fsdp,
                                             make_plan, param_pspecs)
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.models.layers import model_dtype
    from repro_torch.models.model import Model

    from repro_torch.launch import tensor_parallel as tpc

    if case["kind"] in OPERATOR_CASES:
        return OPERATOR_CASES[case["kind"]](case, mesh)
    cfg = case_config(case)
    plan = make_plan(cfg, mesh)
    if case["fsdp"]:
        plan = force_fsdp(plan)
    if case["kind"] == "step":
        return step_case(cfg, case, mesh, plan)
    meta = Model(cfg, device="meta")
    sp = case.get("seq_shard", False)
    if case["kind"] == "serve":
        params = None
        if case.get("params"):
            with open(case["params"], "rb") as f:
                params = lm_params_from_numpy(cfg, pickle.load(f), "cpu")
        tpc.reset_transport()
        with gathered_sizes() as gathered, dropped_assignments() as dropped:
            out = serve(cfg, ServeConfig(batch=case["batch"],
                                         prompt_len=case["seq"] - case["gen"],
                                         gen_len=case["gen"], seed=3),
                        device="cpu", params=params, mesh=mesh, plan=plan,
                        cp=case.get("cp", False), seq_shard=sp)
        cache = abstract_cache(cfg, case["batch"], case["seq"])
        return {"tokens": out["tokens"], "logits": out["logits"],
                "collectives": tpc.collectives_summary(),
                "dropped": sum(dropped),
                "largest_gather": max(gathered, default=0),
                "param_bytes": out["param_bytes"],
                "cache_bytes": out["cache_bytes"],
                "shard_param_bytes": shard_bytes(
                    abstract_params(meta, model_dtype(cfg)),
                    param_pspecs(meta, mesh, plan), mesh),
                "shard_cache_bytes": shard_bytes(
                    cache, cache_pspecs(cache, mesh, case["batch"], plan),
                    mesh) - 4}
    if case["kind"] == "grads":
        return mesh_case_grads(cfg, case, mesh, plan)
    tc = TrainConfig(steps=case["steps"], log_every=1,
                     ckpt_every=case.get("ckpt_every", 1000),
                     ckpt_dir=case.get("ckpt_dir", "unused_ckpt"), seed=5)
    dc = DataConfig(seq_len=case["seq"], global_batch=case["batch"],
                    vocab=cfg.vocab, seed=case.get("data_seed", 7))
    out = train(cfg, tc, data_cfg=dc, device="cpu", mesh=mesh, plan=plan,
                seq_shard=sp)
    want = shard_bytes(abstract_params(meta, torch.float32),
                       param_pspecs(meta, mesh, plan), mesh)
    local = sum(p.numel() * p.element_size()
                for p in out["model"].parameters())
    opt = sum(t.numel() * t.element_size()
              for part in ("m", "v") for t in out["opt_state"][part].values())
    res = {"losses": out["losses"],
           "params": full_params(out["model"], out["run"]),
           "local_param_bytes": local, "shard_param_bytes": want,
           "opt_bytes": opt}
    if case.get("peak"):
        res["checkpoint_peak_bytes"] = checkpoint_peak(cfg, out)
    return res


def case_config(case: dict):
    """A case's smoke config: ``max_seq`` its ``seq``, then its
    ``replace`` fields."""
    from repro_torch.configs import smoke_config

    return smoke_config(case["arch"]).replace(max_seq=case["seq"],
                                              **case.get("replace", {}))


def config_override(case: dict) -> dict:
    """Every field of a case's config, as ``dryrun``'s ``cfg_override``
    (which starts from the full config of the arch)."""
    import dataclasses

    cfg = case_config(case)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def step_case(cfg, case, mesh, plan) -> dict:
    """One step of a cell (``dryrun.cell_step``: a train step, a prefill
    or a decode step, ``case["mode"]``) at the case's small size on this
    rank, with real tensors: the collectives it made
    (``tensor_parallel.collectives_summary``) and its arguments' bytes by
    part, to hold against a trace of the same step."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch import tensor_parallel as tpc
    from repro_torch.launch.distributed import MeshRun
    from repro_torch.models.model import Model

    run = MeshRun(cfg, mesh, plan, "cpu",
                  seq_shard=case.get("seq_shard", False))
    train = case["mode"] == "train"
    model = Model(cfg, device="meta",
                  param_dtype=torch.float32 if train else None)
    run.place_init(model, 5)
    torch.manual_seed(0)
    call, arguments = dryrun.cell_step(
        model, run, ShapeCell("small", case["seq"], case["batch"],
                              case["mode"]), case.get("remat", "full"))
    tpc.reset_transport()
    call()
    return {"collectives": tpc.collectives_summary(),
            "arguments": {k: sum(t.numel() * t.element_size() for t in v)
                          for k, v in arguments.items()}}


@contextlib.contextmanager
def gathered_sizes():
    """The element counts of every all-gather's input over a group of the
    mesh's axes on this rank inside the block
    (``launch/tensor_parallel.py::all_gather``, which every gather of the
    port goes through; the gather of the results' rows over the world is
    not counted), a list."""
    from repro_torch.launch import tensor_parallel as tpc

    sizes, real = [], tpc.all_gather

    def spy(t, dim, group, n):
        if group is not None:
            sizes.append(t.numel())
        return real(t, dim, group, n)
    tpc.all_gather = spy
    try:
        yield sizes
    finally:
        tpc.all_gather = real


@contextlib.contextmanager
def dropped_assignments():
    """The MoE's dropped (token, expert) assignments on this rank inside
    the block, one count a dispatch (``models/moe.py::_rank_and_slot``),
    a list."""
    from repro_torch.models import moe

    counts, real = [], moe._rank_and_slot

    def spy(flat_e, E, C):
        keep, slot = real(flat_e, E, C)
        counts.append(int((~keep).sum()))
        return keep, slot
    moe._rank_and_slot = spy
    try:
        yield counts
    finally:
        moe._rank_and_slot = real


def _axis(mesh):
    """The world as one ``model`` group, every rule split over it."""
    import torch.distributed as dist

    from repro_torch.launch.tensor_parallel import ModelAxis

    return ModelAxis(group=dist.group.WORLD, n=mesh.size,
                     rank=dist.get_rank(), heads=True, kv=True, ff=True,
                     vocab=True, experts=True, seq_cache=False, cp=True)


def cp_case(case, mesh) -> dict:
    """``models/attention.py::cp_attention`` on a pickled q, k, v."""
    import pickle

    from repro_torch.models.attention import cp_attention

    with open(case["inputs"], "rb") as f:
        q, k, v = (torch.from_numpy(t) for t in pickle.load(f).values())
    return {"out": cp_attention(q, k, v, _axis(mesh), causal=True,
                                window=case["window"])}


def psum_case(case, mesh) -> dict:
    """``optim/compression.py::compressed_psum`` over the world (a mesh
    of ``pod`` alone), this rank's gradients its row of the case's."""
    import torch.distributed as dist

    from repro_torch.optim.compression import compressed_psum

    g = {"w": torch.tensor(case["grads"][dist.get_rank()],
                           dtype=torch.float32)}
    mean, err = compressed_psum(g, {"w": torch.zeros(3)}, dist.group.WORLD)
    return {"mean": mean["w"], "error": err["w"]}


def gradcheck_case(case, mesh) -> dict:
    """``torch.autograd.gradcheck`` in float64 of the conjugate operators
    of ``launch/tensor_parallel.py``, each in a function whose input and
    output are the same on every rank (so all ranks perturb and read the
    same global function in step): rank-dependent work between them."""
    import torch.distributed as dist

    tp = _axis(mesh)
    r = dist.get_rank()
    gen = torch.Generator().manual_seed(11)
    w = torch.randn(tp.n, 6, 6, dtype=torch.float64, generator=gen)

    def copy_reduce(x):                     # column then row parallel
        return tp.reduce(torch.tanh(tp.copy(x) @ w[r]) @ w[r].t())

    def split_gather(x):                    # a slice each, gathered
        return tp.gather(torch.sin(tp.slice(tp.copy(x), 0) @ w[r]), 0)

    def gather_shards(x):                   # shards gathered, used split
        full = tp.gather_shards(tp.slice(tp.copy(x), 1), 1)
        return tp.reduce(torch.cos(full @ w[r]))

    def exchange(x):                        # all-to-all there and back
        y = tp.all_to_all(torch.sinh(tp.copy(x) * (r + 1)))
        return tp.reduce(tp.all_to_all(y @ w[r]))

    x = torch.randn(2 * tp.n, 6, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    return {name: torch.autograd.gradcheck(fn, (x,), eps=1e-6, atol=1e-8)
            for name, fn in (("copy_reduce", copy_reduce),
                             ("split_gather", split_gather),
                             ("gather_shards", gather_shards),
                             ("exchange", exchange))}


OPERATOR_CASES = {"cp": cp_case, "psum": psum_case,
                  "gradcheck": gradcheck_case}


def case_batch(cfg, case) -> dict:
    """The first global batch of a case's data pipeline; for the audio
    and vlm families (whose frames and patches no pipeline makes) also
    ``frames`` / ``patches`` drawn from ``numpy.random.default_rng(11)``."""
    import numpy as np

    from repro_torch.data.pipeline import DataConfig, Pipeline

    pipe = Pipeline(DataConfig(seq_len=case["seq"],
                               global_batch=case["batch"], vocab=cfg.vocab,
                               seed=case.get("data_seed", 7)))
    try:
        batch = next(iter(pipe))
    finally:
        pipe.close()
    ctx = {"audio": ("frames", cfg.enc_seq),
           "vlm": ("patches", cfg.vision_seq)}.get(cfg.family)
    if ctx is not None:
        draw = np.random.default_rng(11).standard_normal(
            (case["batch"], ctx[1], cfg.d_model))
        batch[ctx[0]] = torch.from_numpy(draw.astype(np.float32))
    return batch


def mesh_case_grads(cfg, case, mesh, plan) -> dict:
    """The gradients of one step's loss on ``mesh`` (the weights of
    ``Model.init_weights(5)``, the case's first batch), each gathered
    whole, with the step's global nll and aux, its collectives, and the
    parameters' bytes placed on this rank beside ``dryrun.shard_bytes``'s."""
    from repro_torch.launch.distributed import MeshRun
    from repro_torch.launch.dryrun import abstract_params, shard_bytes
    from repro_torch.launch.sharding import param_pspecs
    from repro_torch.launch.steps import mesh_grads, train_params
    from repro_torch.models.model import Model

    from repro_torch.launch import tensor_parallel as tpc

    run = MeshRun(cfg, mesh, plan, "cpu",
                  seq_shard=case.get("seq_shard", False))
    model = Model(cfg, device="meta", param_dtype=torch.float32)
    run.place_init(model, 5)
    params = train_params(model)
    tpc.reset_transport()
    with dropped_assignments() as dropped:
        grads, nll, aux = mesh_grads(model, run, params,
                                     case_batch(cfg, case))
    collectives = tpc.collectives_summary()
    nll, aux = run.dp_sum(torch.stack([nll, aux])).tolist()
    meta = Model(cfg, device="meta")
    return {"nll": nll, "aux": aux, "collectives": collectives,
            "dropped": sum(dropped),
            "local_param_bytes": sum(p.numel() * p.element_size()
                                     for p in model.parameters()),
            "shard_param_bytes": shard_bytes(
                abstract_params(meta, torch.float32),
                param_pspecs(meta, mesh, plan), mesh),
            "grads": {n: run.full_tensor(n, g).to("cpu", copy=True)
                      for n, g in zip(params, grads)}}


@torch.no_grad()
def full_params(model, run) -> dict:
    """A mesh run's parameters, full, on the host, by their unsharded
    names: one leaf at a time, each gathered over the axes that split it
    (every rank calls this, in the same order)."""
    from repro_torch.launch.distributed import parameters_by_name

    return {name: run.full_tensor(name, p).to("cpu", copy=True)
            for name, p in parameters_by_name(model).items()}


def checkpoint_peak(cfg, out: dict) -> int:
    """The most bytes that torch's allocator held, above what it held
    before, while this rank gathered a checkpoint of a train's result
    (``train.py::checkpoint_tree``): the allocations and frees that the
    profiler records on every thread (gloo's included), added in time
    order.  On the CPU the host is the device, so rank 0's peak also
    holds the tree it keeps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import checkpoint_tree

    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        tree = checkpoint_tree(cfg, out["model"], out["opt_state"],
                               out["run"])
    del tree
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "[memory]"]
    live = peak = 0
    for ev in sorted(events, key=lambda e: e.start_ns()):
        live += ev.nbytes()
        peak = max(peak, live)
    return peak


# ---------------------------------------------------------- traces
def start_traces(calls: list, workdir: Path):
    """Start one process that runs ``dryrun.run_cell(..., trace=True)``
    (which traces on a process group of fake ranks) for each of
    ``calls`` (dicts of its keyword arguments, with ``dims`` for a mesh
    that is not a production one) in order, and writes their results as
    JSON; :func:`wait_traces` reads them."""
    workdir.mkdir(parents=True, exist_ok=True)
    job = workdir / "traces.json"
    job.write_text(json.dumps(calls))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")])}
    log = open(workdir / "traces.log", "w")
    proc = subprocess.Popen([sys.executable, __file__, "--trace", str(job)],
                            env=env, cwd=workdir, stdout=log,
                            stderr=subprocess.STDOUT)
    log.close()
    return proc


def wait_traces(proc, workdir: Path, timeout: float) -> list:
    """The results of :func:`start_traces`'s calls, in order (killed at
    ``timeout`` seconds; a failure raises with the end of its log)."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log = (workdir / "traces.log").read_text()
    if proc.returncode != 0:
        raise RuntimeError(f"the traces exited {proc.returncode}:\n"
                           f"{log[-4000:]}")
    return json.loads((workdir / "traces.out.json").read_text())


def run_traces(job_path: str) -> None:
    one_thread()
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    from repro_torch.launch.sharding import force_fsdp, make_plan

    calls = json.loads(Path(job_path).read_text())
    out = []
    for kw in calls:
        kw = dict(kw)
        if "dims" in kw:
            kw["mesh"] = make_mesh(kw.pop("dims"))
        if isinstance(kw["shape"], list):
            kw["shape"] = ShapeCell(*kw["shape"])
        if kw.get("cfg_override"):          # JSON made the tuples lists
            kw["cfg_override"] = {k: tuple(v) if isinstance(v, list) else v
                                  for k, v in kw["cfg_override"].items()}
        if kw.pop("fsdp", False):
            cfg, _cell = dryrun.cell_config(kw["arch"], kw["shape"],
                                            kw.get("cfg_override"))
            kw["plan_override"] = force_fsdp(make_plan(cfg, kw["mesh"]))
        out.append(dryrun.run_cell(**kw, trace=True))
    (Path(job_path).parent / "traces.out.json").write_text(json.dumps(out))


def main(job_path: str) -> None:
    one_thread()
    import torch.distributed as dist

    from repro_torch.launch.distributed import close_ranks, init_ranks
    from repro_torch.launch.mesh import make_mesh

    job = json.loads(Path(job_path).read_text())
    init_ranks(job["store"], "cpu")
    try:
        mesh = make_mesh(job["dims"])
        results = {c["id"]: run_case(c, mesh) for c in job["cases"]}
        rank = dist.get_rank()
    finally:
        close_ranks()
    torch.save(results, Path(job_path).parent / f"rank{rank}.pt")


if __name__ == "__main__":
    if sys.argv[1] == "--trace":
        run_traces(sys.argv[2])
    else:
        main(sys.argv[1])
