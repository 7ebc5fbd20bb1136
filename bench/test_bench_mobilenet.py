"""The MobileNetV3-Large configuration on the CPU: its layer table is the
zoo's at the published SE widths and chains from node to node; the
reference's host oracle equals the JAX package's on it; the port's plan
equals the reference's on its first 34 nodes (six SE side steps); a small
cell made of those nodes runs ``correct``, and the float32 control and a
fault planted in the side step of K1's plain version are rejected there."""
import dataclasses
import json
import shutil
import time
from pathlib import Path

import pytest

import reference
from bench import test_bench_jax_oracle as oracle
from bench import test_bench_reference as zoo
from harness.cell import run_cell
from harness.control import Control
from harness.network import program_accelerator, program_graph

BENCH = Path(__file__).resolve().parent
NAME = "mobilenet-v3-224"
NODES = 34                      # through the third SE block's projection
SEED = 2 ** 31 + 35
# The published network's SE squeeze width is _make_divisible(exp / 4, 8):
# 24 for exp 72 and 32 for exp 120, where the zoo gives exp // 4 (18, 30).
# Node -> the fields the configuration holds at the published widths.
SE_WIDTHS = {15: {"out_ch": 24}, 16: {"in_ch": 24},
             22: {"out_ch": 32}, 23: {"in_ch": 32},
             30: {"out_ch": 32}, 31: {"in_ch": 32}}


def config() -> dict:
    return json.loads((BENCH / "configs" / f"{NAME}.json").read_text())


def first_nodes(n: int = NODES) -> dict:
    net = dict(config()["network"])
    net["layers"] = net["layers"][:n]
    return net


def test_configuration_is_the_zoo_network_at_the_published_se_widths():
    from repro_torch.cnn.zoo import build_cnn
    from repro_torch.core.hw import KCU1500

    cfg = config()
    got = program_graph(cfg["network"])
    want = build_cnn("mobilenet-v3", cfg["network"]["input_size"])
    assert cfg["network"]["input_size"] == 224
    for idx, fields in SE_WIDTHS.items():
        node = want.nodes[idx]
        assert node.kind == "fc"
        assert all(getattr(node, k) != v for k, v in fields.items())
        want.nodes[idx] = dataclasses.replace(node, **fields)
    assert [dataclasses.asdict(n) for n in got.nodes] == \
        [dataclasses.asdict(n) for n in want.nodes]
    assert program_accelerator(cfg["accelerator"]["fields"]) == KCU1500
    assert cfg["reduced"] == []


def test_configuration_widths_chain_and_shape():
    zoo.test_configuration_widths_chain(NAME)
    nodes = reference.build_graph(config()["network"]).nodes
    for n in nodes:
        if n.kind in ("add", "scale"):
            # the shortcut's width, the SE gate's width: the main input's
            assert all(nodes[i].out_ch == n.in_ch for i in n.inputs), n
        if n.kind == "fc":
            assert (n.in_h, n.in_w, n.out_h, n.out_w) == (1, 1, 1, 1), n
    s = reference.shape(config()["network"])
    assert (len(nodes), s["groups"], s["runs"], s["space"]) == \
        (92, 72, 18, 15_116_544) == (92, 72, 18, config()["cut_space"])
    assert sum(side for side, _, _ in s["steps"]) == 18
    kinds = [n.kind for n in nodes]
    assert (kinds.count("dwconv"), kinds.count("scale"),
            kinds.count("add")) == (15, 8, 10)


def test_reference_oracle_equals_jax_package():
    assert oracle.mismatches(NAME) == []


@pytest.mark.parametrize("objective", ["latency", "dram", "sram"])
def test_reference_plan_equals_port_on_the_first_nodes(objective):
    net = first_nodes()
    s = reference.shape(net)
    assert (s["groups"], s["space"]) == (27, 11_664)
    assert sum(side for side, _, _ in s["steps"]) == 6
    assert zoo.mismatches(net, objective) == []


@pytest.fixture(scope="module")
def small_se(tmp_path_factory):
    """``(root, cell)``: a copy of the benchmark with one cell more, made of
    data files only: the configuration's first 34 nodes (27 groups, 6 of
    them SE side steps, 11,664 cut tuples) searched in chunks of 1,024."""
    cell = "mobilenet-v3-34.dse_small"
    root = tmp_path_factory.mktemp("bench_root_se")
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cfg = config()
    cfg["network"] = first_nodes()
    cfg.update(name="mobilenet-v3-34", cut_space=11_664, reduced=["network"])
    (root / "bench" / "configs" / "mobilenet-v3-34.json").write_text(
        json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "dse_exhaustive.json").read_text())
    mix["options"]["engine"] = "pipeline@1024"
    (root / "bench" / "traffic" / "dse_small.json").write_text(
        json.dumps(mix))
    spec["configs"].append({"name": "mobilenet-v3-34", "source": cfg["source"],
                            "file": "bench/configs/mobilenet-v3-34.json",
                            "reduced": ["network"], "why": "tests"})
    spec["workloads"].append({"name": cell, "config": "mobilenet-v3-34",
                              "traffic": "dse_small", "chips": 1,
                              "why": "tests"})
    for m in spec["per_layer"]:
        m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, cell


def run(small_se, traced=False, **kw):
    root, cell = small_se
    return run_cell(cell, SEED, 1.0, traced, time.perf_counter(),
                    device="cpu", root=root, log=lambda _msg: None, **kw)


def test_sound_run_is_correct(small_se):
    r = run(small_se)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] == 0 for c in r["checks"].values())


def test_control_is_rejected(small_se):
    r = run(small_se, program=Control)
    assert not r["correct"]
    assert r["checks"]["reports_mismatch"]["value"] > 0


def _side_step_keeps_its_producers(monkeypatch):
    """K1's side step consumes nothing: its producers (the depthwise group
    before an SE block, the squeeze fc) are never released."""
    from repro_torch.kernels import search_pipeline
    from repro_torch.kernels.alloc_scan import alloc_scan_torch

    def alloc_scan(at, frame, backend=None, state=None):
        gin = at.gin.copy()
        gin[at.is_side] = at.sink_idx
        return alloc_scan_torch(dataclasses.replace(at, gin=gin), frame)

    monkeypatch.setattr(search_pipeline, "alloc_scan", alloc_scan)


def test_side_step_fault_is_rejected(small_se, monkeypatch):
    """(A side step that leaves ``side_buff`` alone is no such fault: the
    side space is one maximum over the network's side outputs, the same
    for every candidate, so it moves every candidate's SRAM alike.)"""
    _side_step_keeps_its_producers(monkeypatch)
    r = run(small_se)
    assert not r["correct"] and r["failed"] > 0


def test_traced_run_reads_the_side_step_share(small_se):
    """The plain variant replays every group of every candidate, so the
    share is the side groups' share of the groups: 6 of 27."""
    from repro_torch.utils import tracing

    tracing.reset()
    r = run(small_se, traced=True)
    tracing.reset()
    assert r["correct"]
    assert r["metrics"]["side_step_share"]["value"] == \
        pytest.approx(100.0 * 6 / 27, abs=1e-9)
