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
    """One case on this rank: ``train`` or ``serve`` of a smoke config on
    ``mesh`` with ``device="cpu"``, FSDP as the plan says or forced."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.dryrun import abstract_params, shard_bytes
    from repro_torch.launch.serve import ServeConfig, serve
    from repro_torch.launch.sharding import (force_fsdp, make_plan,
                                             param_pspecs)
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.models.model import Model

    cfg = smoke_config(case["arch"]).replace(
        max_seq=case["seq"], **case.get("replace", {}))
    plan = make_plan(cfg, mesh)
    if case["fsdp"]:
        plan = force_fsdp(plan)
    if case["kind"] == "serve":
        out = serve(cfg, ServeConfig(batch=case["batch"],
                                     prompt_len=case["seq"] - case["gen"],
                                     gen_len=case["gen"], seed=3),
                    device="cpu", mesh=mesh, plan=plan)
        return {"tokens": out["tokens"], "logits": out["logits"]}
    tc = TrainConfig(steps=case["steps"], log_every=1,
                     ckpt_every=case.get("ckpt_every", 1000),
                     ckpt_dir=case.get("ckpt_dir", "unused_ckpt"), seed=5)
    dc = DataConfig(seq_len=case["seq"], global_batch=case["batch"],
                    vocab=cfg.vocab, seed=7)
    out = train(cfg, tc, data_cfg=dc, device="cpu", mesh=mesh, plan=plan)
    meta = Model(cfg, device="meta")
    want = shard_bytes(abstract_params(meta, torch.float32),
                       param_pspecs(meta, mesh, plan), mesh)
    local = sum(p.numel() * p.element_size()
                for p in out["model"].parameters())
    opt = sum(t.numel() * t.element_size()
              for part in ("m", "v") for t in out["opt_state"][part].values())
    res = {"losses": out["losses"], "params": full_params(out["model"]),
           "local_param_bytes": local, "shard_param_bytes": want,
           "opt_bytes": opt}
    if case.get("peak"):
        res["checkpoint_peak_bytes"] = checkpoint_peak(cfg, out)
    return res


@torch.no_grad()
def full_params(model) -> dict:
    """A mesh run's parameters, full, on the host, by their unsharded
    names: one leaf at a time, each read through its all-gather (every
    rank calls this, in the same order)."""
    from repro_torch.models.layers import Params

    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, Params):
            for name in mod.defs:
                full = f"{prefix}.{name}" if prefix else name
                out[full] = getattr(mod, name).detach().to("cpu", copy=True)
    return out


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
    main(sys.argv[1])
