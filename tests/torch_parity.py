"""Shared helpers of the tests/test_torch_*.py parity suite.

Every test there pushes the same inputs -- zoo graphs built in code, cut
tuples and masks made from a seed -- through the JAX package (``repro``,
the reference) and its PyTorch counterpart (``repro_torch``) and compares
the results.  Data crosses between the two as plain Python / numpy values.
"""
import dataclasses
import itertools
import random

import numpy as np
import pytest
import torch

import repro.cnn as ref_cnn
import repro.core.compiler as ref_compiler
import repro.core.cutpoint as ref_cut
import repro.core.grouping as ref_grouping
import repro.core.options as ref_options
import repro.core.timing as ref_timing
import repro.kernels.alloc_scan as ref_scan
from repro.core.hw import KCU1500 as REF_HW

import repro_torch.cnn as port_cnn
import repro_torch.core.cutpoint as port_cut
import repro_torch.core.grouping as port_grouping
import repro_torch.kernels.alloc_scan as port_scan
from repro_torch.convert import graph_from_nodes
from repro_torch.core.hw import KCU1500 as PORT_HW
from torch_ranks import one_thread  # noqa: F401  (every port test calls it)

ALL_CNNS = ["vgg16-conv", "yolov2", "yolov3", "resnet50", "resnet152",
            "efficientnet-b1", "retinanet", "mobilenet-v3"]

METRICS = ["latency_cycles", "dram_total", "dram_fm", "sram_total",
           "bram18k", "feasible"]
INT_METRICS = [m for m in METRICS if m != "latency_cycles"]

# R1: on Python >= 3.12 the reference's *scalar* latency total (builtin
# ``sum``, compensated) and its *batched* one (``np.cumsum``, plain left to
# right) differ in the last bits.  The port uses the plain order everywhere,
# so it is held bit-equal to the reference's batched total and within this
# relative tolerance of the reference's scalar report.
R1_RTOL = 1e-13

_CACHE: dict = {}


def reference_dryrun():
    """The JAX package's ``launch/dryrun.py``, imported without the
    ``XLA_FLAGS`` it writes at import (512 host devices) reaching this
    process's environment: the flag is put back as it was at once, so a
    later test in the same process starts jax as before."""
    import os
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref_dryrun


def node_dicts(graph) -> list[dict]:
    return [dataclasses.asdict(n) for n in graph.nodes]


def both(name):
    """``(ref, port)`` for one zoo net; each side is a namespace with the
    grouped graph, blocks, runs and a fresh-engine factory."""
    got = _CACHE.get(name)
    if got is None:
        got = _CACHE[name] = (_Side(ref_cnn, ref_grouping, ref_cut, REF_HW,
                                    name),
                              _Side(port_cnn, port_grouping, port_cut,
                                    PORT_HW, name))
    return got


class _Side:
    def __init__(self, cnn, grouping, cut, hw, name):
        self.cut = cut
        self.hw = hw
        self.graph = cnn.build_cnn(name)
        self.gg = grouping.group_nodes(self.graph)
        self.blocks = cut.split_blocks(self.gg)
        self.runs = cut.monotone_runs(self.blocks)

    def engine(self, **kw):
        return self.cut.CutpointEngine(self.gg, self.hw, self.blocks,
                                       self.runs, **kw)


def port_engine_of(name: str, **kw):
    """A port ``CutpointEngine`` on the CPU (``engine="pipeline:torch"``
    unless ``kw`` says) for a zoo net, or for a benchmark configuration
    named ``bench:<config>`` (``bench/configs/<config>.json``: its layer
    table and its accelerator's fields)."""
    import json
    from pathlib import Path

    from repro_torch.core.hw import FPGAConfig
    from repro_torch.core.ir import Graph, LayerNode

    kw = {"engine": "pipeline:torch", "device": "cpu", **kw}
    if not name.startswith("bench:"):
        return both(name)[1].engine(**kw)
    path = (Path(__file__).resolve().parents[1] / "bench" / "configs"
            / (name.split(":", 1)[1] + ".json"))
    cfg = json.loads(path.read_text())
    net = cfg["network"]
    graph = Graph(net["name"],
                  [LayerNode(idx=i, **dict(zip(net["columns"], row)))
                   for i, row in enumerate(net["layers"])])
    return port_cut.CutpointEngine(port_grouping.group_nodes(graph),
                                   FPGAConfig(**cfg["accelerator"]["fields"]),
                                   **kw)


def mixed_tuples(runs, n_prefix=25, n_random=25, seed=17):
    """Cut tuples: the first few in product order, seeded random ones, and
    the two corners (the fuzz of tests/test_alloc_scan.py)."""
    dims = [range(len(r) + 1) for r in runs]
    tuples = list(itertools.islice(itertools.product(*dims), n_prefix))
    rng = random.Random(seed)
    tuples += [tuple(rng.randint(0, len(r)) for r in runs)
               for _ in range(n_random)]
    tuples.append(tuple(0 for _ in runs))
    tuples.append(tuple(len(r) for r in runs))
    return tuples


def random_masks(n_groups, b, seed):
    """Arbitrary (b, G) frame masks -- not reachable from any cut tuple, so
    they exercise allocator states the search never visits."""
    rng = np.random.default_rng(seed)
    return rng.random((b, n_groups)) < rng.random((b, 1))


def ref_tables_dict(t) -> dict:
    """The reference's AllocScanTables as a dict of numpy arrays."""
    return {f: np.asarray(getattr(t, f)) for f in port_scan.TABLE_FIELDS}


def scan_tables(name):
    """``(reference tables, port tables on the CPU)`` for one net; the
    port's are made from the reference's numpy fields."""
    key = ("tables", name)
    got = _CACHE.get(key)
    if got is None:
        ref, _ = both(name)
        rt = ref_scan.pack_alloc_tables(ref.gg, ref.hw)
        got = _CACHE[key] = (rt, port_scan.AllocScanTables.from_numpy(
            ref_tables_dict(rt)))
    return got


def assert_scan_equal(res, want, ctx):
    """Port AllocScanResult (tensors) == reference AllocScanResult (numpy),
    every integer."""
    for f in ["io", "buff", "side_buff", "wrf", "bfm", "feasible"]:
        got = getattr(res, f).cpu().numpy()
        exp = np.asarray(getattr(want, f))
        assert got.shape == exp.shape, (ctx, f, got.shape, exp.shape)
        assert np.array_equal(got, exp), (
            f"{ctx}: {f} mismatch at {np.argwhere(got != exp)[:4]}")


def as_tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def port_graph_of(ref_graph):
    """The reference's graph carried into the port as plain data."""
    return graph_from_nodes(ref_graph.name, node_dicts(ref_graph))


# ------------------------------------------------------- whole compiles
TEST_LIMIT = 200_000

# R5 (ROADMAP queue 3): the reference's *batched* coordinate descent mixes
# its two latency totals -- each descent start is priced by the scalar
# ``evaluate`` (compensated builtin ``sum``) and memoized, the sweep trials
# by ``score_batch`` (plain ``np.cumsum``) -- so on efficientnet-b1 two
# candidates of equal latency compare unequal in the last bit and the
# descent settles on a worse tie (test_reference_batched_descent_r5 below
# pins that).  With ``batch_size=1`` the reference prices every tuple the
# same way; that consistent form is what the port is held against there.
REF_BATCH = {"efficientnet-b1": 1}

_CACHE_PLANS: dict = {}


def ref_plan(name, engine):
    key = (name, engine)
    if key not in _CACHE_PLANS:
        ref, _ = both(name)
        _CACHE_PLANS[key] = ref_compiler.compile_graph(
            ref.graph, ref.hw, ref_options.CompileOptions(
                engine=engine, exhaustive_limit=TEST_LIMIT,
                batch_size=REF_BATCH.get(name, 1024)))
    return _CACHE_PLANS[key]


def assert_plans_equal(pp, rp, ctx):
    assert tuple(pp.candidate.cuts) == tuple(rp.candidate.cuts), ctx
    assert pp.search.evaluated == rp.search.evaluated, ctx
    assert pp.search.path == rp.search.path, ctx
    for f in INT_METRICS:
        assert getattr(pp.candidate, f) == getattr(rp.candidate, f), (ctx, f)
    assert dataclasses.asdict(pp.sram) == dataclasses.asdict(rp.sram), ctx
    assert dataclasses.asdict(pp.dram) == dataclasses.asdict(rp.dram), ctx
    assert dataclasses.asdict(pp.alloc) == dataclasses.asdict(rp.alloc), ctx
    pw = [i.encode().tolist() for i in pp.instructions]
    rw = [i.encode().tolist() for i in rp.instructions]
    assert pw == rw, ctx
    # latency: per group bit-equal; the total bit-equal to the reference's
    # batched form and within R1_RTOL of its scalar report
    assert pp.latency.per_group == rp.latency.per_group, ctx
    gg, hw = rp.grouped, rp.hw
    frame = np.array([[rp.candidate.policy[g.gid] == "frame"
                       for g in gg.groups]])
    io = np.zeros((1, len(gg.groups)))
    for gid, v in rp.alloc.boundary_reads.items():
        io[0, gid] += v
    for g in gg.groups:
        if g.gid in rp.alloc.boundary_writes or g.gid in rp.alloc.spilled:
            io[0, g.gid] += g.out_size
    batched = ref_timing.latency_cycles_fast_batch(
        ref_timing.latency_tables(gg, hw), frame, io, hw)
    assert pp.latency.cycles == float(batched[0]), ctx
    assert pp.candidate.latency_cycles == pp.latency.cycles, ctx
    assert pp.latency.cycles == pytest.approx(rp.latency.cycles,
                                              rel=R1_RTOL, abs=0), ctx


# ------------------------------------------------ chip_smoke.py's pins
def chip_smoke():
    """``chip_smoke.py`` loaded as a module (its constants: the launch
    counts it pins); nothing in it runs at import."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# each LM kernel's plain version in ``kernels/ops.py``
LM_PLAIN = {"flash_attention": "flash_attention_torch",
            "fused_block": "fused_block_torch", "ssd_scan": "ssd_scan_torch",
            "rglru_scan": "rglru_scan_torch"}


def count_lm_calls(monkeypatch) -> dict:
    """Count the forwards ``kernels/ops.py`` hands to the LM kernels'
    Functions (on the CPU their plain versions): on the card each is one
    launch.  Returns the live ``{kernel: calls}``."""
    from repro_torch.kernels import ops
    calls = dict.fromkeys(LM_PLAIN, 0)
    for name, attr in LM_PLAIN.items():
        def wrapped(*a, _fn=getattr(ops, attr), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, attr, wrapped)
    return calls
