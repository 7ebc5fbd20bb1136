"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package ``repro`` (nor ``msgpack``), it can be imported on a host with no
GPU and no CUDA compiler, and it refuses to run a GPU engine on the CPU
behind the caller's back."""
import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch_parity

torch_parity.one_thread()

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
# msgpack too: the machine with the GPU has none (the task journal's codec
# is the standard library's)
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py")))


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _imported_roots(path: Path):
    """Top-level package of every import statement anywhere in the file
    (function bodies included)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    # no dynamic imports that the AST walk would miss
    src = path.read_text()
    assert "importlib" not in src and "__import__" not in src


def test_port_has_the_modules_of_the_slice():
    mods = set(_port_modules())
    for want in ("repro_torch.core.ir", "repro_torch.core.hw",
                 "repro_torch.cnn.zoo", "repro_torch.core.grouping",
                 "repro_torch.core.allocator", "repro_torch.core.dram",
                 "repro_torch.core.sram", "repro_torch.core.timing",
                 "repro_torch.core.options", "repro_torch.core.isa",
                 "repro_torch.core.cutpoint", "repro_torch.core.compiler",
                 "repro_torch.kernels.alloc_scan",
                 "repro_torch.kernels.search_pipeline",
                 "repro_torch.kernels.score_batch",
                 "repro_torch.kernels._build", "repro_torch.convert",
                 "repro_torch.cnn.torch_ref", "repro_torch.core.simulator",
                 "repro_torch.analysis", "repro_torch.analysis.__main__",
                 "repro_torch.analysis.diagnostics",
                 "repro_torch.analysis.liveness",
                 "repro_torch.analysis.verifier",
                 "repro_torch.analysis.mutate",
                 "repro_torch.configs", "repro_torch.configs.base",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.fused_block",
                 "repro_torch.kernels.rglru_scan",
                 "repro_torch.kernels.ssd_scan",
                 "repro_torch.kernels.ops", "repro_torch.models.layers",
                 "repro_torch.models.attention",
                 "repro_torch.models.mamba2", "repro_torch.models.rglru",
                 "repro_torch.models.transformer",
                 "repro_torch.models.model", "repro_torch.launch.serve",
                 "repro_torch.core.search_pool", "repro_torch.runtime",
                 "repro_torch.runtime.chaos",
                 "repro_torch.runtime.fault_tolerance",
                 "repro_torch.checkpoint",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.service", "repro_torch.service.packing",
                 "repro_torch.service.canonical",
                 "repro_torch.service.codec", "repro_torch.service.cache",
                 "repro_torch.service.daemon",
                 "repro_torch.kernels.autograd", "repro_torch.data.pipeline",
                 "repro_torch.optim.adamw", "repro_torch.optim.compression",
                 "repro_torch.launch.steps", "repro_torch.launch.train",
                 "repro_torch.core.residency", "repro_torch.models.moe",
                 "repro_torch.utils", "repro_torch.utils.costmodel",
                 "repro_torch.launch.mesh", "repro_torch.launch.sharding",
                 "repro_torch.launch.dryrun",
                 "repro_torch.launch.distributed"):
        assert want in mods, want
    twins = {p.name for p in (ROOT / "examples").glob("*_torch.py")}
    assert twins == {"quickstart_torch.py", "serve_compile_torch.py",
                     "serve_lm_torch.py", "train_lm_torch.py"}
    csrc = {p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")}
    assert csrc == {"alloc_scan.cu", "search_pipeline.cu", "score_batch.cu",
                    "flash_attention.cu", "flash_attention_tc.cu",
                    "fused_block.cu", "fused_block_tc.cu", "rglru_scan.cu",
                    "ssd_scan.cu", "ssd_scan_tc.cu"}
    from repro_torch.kernels import _build
    assert set(_build.SOURCES) == csrc


def test_every_port_module_imports_without_jax_gpu_or_compiler():
    """A fresh interpreter imports every module of the port; afterwards
    neither ``jax`` nor ``repro`` is loaded, nothing was built and no CUDA
    library was looked for."""
    code = (
        "import importlib, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build, launch_counts\n"
        "assert _build._LIB is None\n"
        "assert set(launch_counts().values()) == {0}\n"
        "print('ok', len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[0] == "ok"


def test_multi_rank_runs_leave_this_process_without_a_process_group(
        tmp_path):
    """A world of two ranks (``torch_ranks.py``: each a subprocess, gloo
    over a ``file://`` store) serves a smoke model; afterwards this
    process has no process group, and importing the mesh, sharding,
    dry-run and distributed modules started none."""
    import torch
    import torch_ranks

    import repro_torch.launch.distributed  # noqa: F401
    import repro_torch.launch.dryrun  # noqa: F401

    case = dict(id="serve", kind="serve", arch="smollm-360m", fsdp=True,
                seq=8, gen=2, batch=2)
    procs = torch_ranks.start_world((2, 1), [case], tmp_path / "world")
    results = torch_ranks.wait_world(procs, tmp_path / "world", 120)
    assert (results[0]["serve"]["tokens"] ==
            results[1]["serve"]["tokens"]).all()
    assert results[0]["serve"]["tokens"].shape == (2, 2)
    assert not torch.distributed.is_initialized()


def test_default_options_never_run_on_the_cpu_silently():
    """``CompileOptions()`` means the pipeline on the GPU.  On a host
    without one the compile raises; the same compile with ``device="cpu"``
    runs the plain torch versions."""
    import torch
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.options import CompileOptions

    opts = CompileOptions()
    assert (opts.engine, opts.device) == ("pipeline", "cuda")
    assert opts.engine_spec().spelling() == "pipeline:cuda@1024"
    g = build_cnn("vgg16-conv")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compile_graph(g, options=opts)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compile_graph(g, options=CompileOptions(engine="device"))
    cpu = CompileOptions(device="cpu")
    assert cpu.engine_spec().spelling() == "pipeline:torch@1024"
    plan = compile_graph(g, options=cpu)
    assert plan.search.path == "exhaustive" and plan.search.evaluated == 1080
    # journal is host code: it needs no GPU whatever ``device`` says
    host = compile_graph(g, options=CompileOptions(engine="journal"))
    assert tuple(host.candidate.cuts) == tuple(plan.candidate.cuts)


def test_engine_grammar_and_device_field():
    from repro_torch.core.options import (SCHEDULE_FIELDS, CompileOptions,
                                          resolve_engine)

    assert "device" in SCHEDULE_FIELDS
    a, b = CompileOptions(), CompileOptions(device="cpu")
    assert a.plan_key() == b.plan_key()          # plans are device-blind
    assert a.schedule() != b.schedule()
    assert resolve_engine("device", device="cpu").variant == "torch"
    assert resolve_engine("device", device="cuda:1").variant == "cuda"
    assert resolve_engine("pipeline:torch@64").batch_size == 64
    assert resolve_engine("journal").variant == ""
    for bad in ("pipeline:lax", "device:pallas", "device:reference",
                "fused", "pipeline@0"):
        with pytest.raises(ValueError):
            resolve_engine(bad)
    with pytest.raises(ValueError, match="CUDA device"):
        CompileOptions(engine="pipeline:cuda", device="cpu")
    with pytest.raises(ValueError):
        CompileOptions(device="tpu")


@pytest.mark.parametrize("kwargs,match", [
    ({"workers": 2, "resume_dir": "journal-dir"}, "pool"),
    ({"workers": None, "resume_dir": "journal-dir"}, "pool"),
    ({"resume_dir": "journal-dir"}, "pool"),
    ({"workers": 2, "backend": "pallas", "resume_dir": "journal-dir"},
     "pool"),
    ({"workers": 2, "verify": "strict", "resume_dir": "journal-dir"},
     "pool"),
    ({"resume_dir": "journal-dir", "verify": "warn"}, "pool"),
])
def test_what_the_slice_leaves_out_raises(kwargs, match, tmp_path,
                                          monkeypatch):
    """What earlier slices refused now runs: ``workers`` and ``resume_dir``
    go through the process pool (``match`` names the module that serves
    them), and the plan equals ``workers=1``.  vgg16-conv's 1,080 tuples
    are below the pool's cutoff, so every case sets ``resume_dir``, which
    forces the partitioned path: the driver runs it once with the asked
    worker count, and every task of that partition is journaled."""
    import os

    from repro_torch.cnn import build_cnn
    from repro_torch.core import search_pool
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.options import CompileOptions

    calls = []
    run_subspaces = search_pool.ParallelSearchDriver.run_subspaces

    def spy(self, *args, **kw):
        calls.append((type(self).__module__, self.workers))
        return run_subspaces(self, *args, **kw)

    monkeypatch.setattr(search_pool.ParallelSearchDriver, "run_subspaces",
                        spy)
    journal = tmp_path / kwargs["resume_dir"]
    g = build_cnn("vgg16-conv")
    opts = CompileOptions(engine="journal", device="cpu",
                          **dict(kwargs, resume_dir=journal))
    plan = compile_graph(g, options=opts)
    [(module, workers)] = calls
    assert match in module
    assert workers == (opts.workers or os.cpu_count())
    prefixes, _ = search_pool.partition_space(
        plan.search.runs, workers * search_pool.TASKS_PER_WORKER)
    assert len(list(journal.glob("search_*/task_*.rec"))) == len(prefixes)
    serial = compile_graph(g, options=opts.replace(workers=1,
                                                   resume_dir=None))
    assert tuple(plan.candidate.cuts) == tuple(serial.candidate.cuts)
    assert plan.search.evaluated == serial.search.evaluated == 1080
    assert plan.latency.cycles == serial.latency.cycles
    assert plan.instructions == serial.instructions
    assert plan.search.events == []


@pytest.mark.parametrize("kwargs", [
    {"backend": "pallas"}, {"verify": "strict"}, {"verify": "warn"},
    {"backend": "pallas", "verify": "strict"}])
def test_scorer_and_verifier_options_run(kwargs):
    """``backend="pallas"`` (the float32 scorer) and ``verify`` are part of
    the port now: the compile runs and returns the exhaustive plan."""
    from repro_torch.analysis import errors_of
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.options import CompileOptions

    plan = compile_graph(build_cnn("vgg16-conv"), options=CompileOptions(
        engine="journal", device="cpu", **kwargs))
    assert plan.search.path == "exhaustive" and plan.search.evaluated == 1080
    assert errors_of(plan.diagnostics) == []


def test_guard_raises_and_legacy_shim_still_works():
    """A ``PreemptionGuard`` is taken (the pool polls it; the serial path
    has nothing to drain) and the plan is unchanged; the legacy shim still
    maps loose knobs."""
    from repro_torch.cnn import build_cnn
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.options import CompileOptions, LegacyKnobWarning
    from repro_torch.runtime.fault_tolerance import PreemptionGuard

    g = build_cnn("vgg16-conv")
    opts = CompileOptions(engine="journal")
    guarded = compile_graph(g, options=opts, guard=PreemptionGuard())
    assert guarded.search.evaluated == 1080
    assert (tuple(guarded.candidate.cuts)
            == tuple(compile_graph(g, options=opts).candidate.cuts))
    with pytest.warns(LegacyKnobWarning):
        plan = compile_graph(g, replay="journal", device="cpu")
    assert plan.search.evaluated == 1080
    with pytest.raises(TypeError):
        compile_graph(g, options=CompileOptions(device="cpu"), workers=1)
    assert importlib.import_module("repro_torch").__doc__
