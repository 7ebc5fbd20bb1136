"""The frozen reference against the port, on the CPU: equal plans on
vgg16-conv, resnet50 and yolov2 cut to its first 16 nodes; its enumeration
equal to its own oracle on every cut tuple; a planted fault in a copied
cost model caught; the configurations' layer tables equal to the zoo's
at the published widths, and consistent from node to node."""
import dataclasses
import json
from pathlib import Path

import pytest

import reference
from harness import check
from harness.network import program_accelerator, program_graph

BENCH = Path(__file__).resolve().parent
MIB = 1 << 20
BUDGETS = (2, 5, 9, 12)


def network(net: str, nodes=None) -> dict:
    from repro_torch.cnn.zoo import build_cnn

    cfg = json.loads((BENCH / "configs" / "yolov2-416.json").read_text())
    cols = cfg["network"]["columns"]
    g = build_cnn(net)
    rows = [[getattr(n, c) for c in cols] for n in g.nodes[:nodes]]
    return {"name": g.name, "columns": cols, "layers": rows}


def hw_fields(budget_mib: int) -> dict:
    from repro_torch.core.hw import KCU1500

    fields = {f.name: getattr(KCU1500, f.name)
              for f in dataclasses.fields(KCU1500)}
    return {**fields, "sram_budget": budget_mib * MIB}


def port_plan(net: dict, fields: dict, objective: str, space: int):
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.options import CompileOptions

    return compile_graph(program_graph(net), program_accelerator(fields),
                         CompileOptions(objective=objective,
                                        engine="pipeline@4096", device="cpu",
                                        exhaustive_limit=space))


def mismatches(net: dict, objective: str) -> list:
    ref = reference.Reference(net, "cpu")
    space = reference.shape(net)["space"]
    out = []
    for b in BUDGETS:
        want = check.plan_parts(ref.plan(
            reference.accelerator(hw_fields(b)), objective, space))
        got = check.plan_parts(port_plan(net, hw_fields(b), objective,
                                         space))
        out += [(b, part) for part in check.PARTS if got[part] != want[part]]
    return out


@pytest.mark.parametrize("objective", ["latency", "dram", "sram"])
@pytest.mark.parametrize("net,nodes", [("vgg16-conv", None),
                                       ("resnet50", None), ("yolov2", 16)])
def test_reference_plan_equals_port(net, nodes, objective):
    assert mismatches(network(net, nodes), objective) == []


@pytest.mark.parametrize("net,nodes", [("vgg16-conv", None), ("yolov2", 16)])
def test_enumeration_prices_every_tuple_as_the_oracle(net, nodes):
    from reference.cuts import evaluate

    ref = reference.Reference(network(net, nodes), "cpu")
    hw = reference.accelerator(hw_fields(9))
    # a block smaller than the space, so that the walk takes several
    costs = ref.space(hw).costs("cpu", block=64)
    for i in range(costs.latency.numel()):
        ev = evaluate(ref.gg, ref.blocks, ref.runs, costs.cuts(i), hw)
        spills_ok = all(
            reference.allocator.spill_is_long_path(ref.gg, g)
            for g in ev.alloc.spilled)
        assert (float(costs.latency[i]), int(costs.sram[i]),
                int(costs.dram[i]), bool(costs.spills_ok[i])) == \
            (ev.latency.cycles, ev.sram.sram_total, ev.dram.total,
             spills_ok), costs.cuts(i)


def test_planted_cost_model_fault_is_caught(monkeypatch):
    from reference import dram

    inner = dram.row_fm_bytes
    monkeypatch.setattr(dram, "row_fm_bytes",
                        lambda gg, g: inner(gg, g) + 1)
    assert any(part == "reports" for _, part in
               mismatches(network("vgg16-conv"), "dram"))


# Where a configuration departs from the port's zoo, and why: Darknet's
# yolov3.cfg gives the 1x1 conv after each `route -4` 256, then 128 filters
# (its layers 84 and 96), so the concats with layers 61 and 36 are 768 and
# 384 wide; the zoo gives those convs half the width.  Node -> the fields the
# configuration holds at the cfg's widths.
CFG_WIDTHS = {
    "yolov2": {},
    "yolov3": {84: {"out_ch": 256}, 85: {"in_ch": 256, "out_ch": 256},
               86: {"in_ch": 256, "out_ch": 768}, 87: {"in_ch": 768},
               95: {"out_ch": 128}, 96: {"in_ch": 128, "out_ch": 128},
               97: {"in_ch": 128, "out_ch": 384}, 98: {"in_ch": 384}},
}


@pytest.mark.parametrize("name,net", [("yolov2-416", "yolov2"),
                                      ("yolov3-416", "yolov3")])
def test_configuration_is_the_zoo_network(name, net):
    """The zoo's network, at the published widths where the zoo is off."""
    from repro_torch.cnn.zoo import build_cnn
    from repro_torch.core.hw import KCU1500

    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    got = program_graph(cfg["network"])
    want = build_cnn(net, cfg["network"]["input_size"])
    for idx, fields in CFG_WIDTHS[net].items():
        want.nodes[idx] = dataclasses.replace(want.nodes[idx], **fields)
    assert [dataclasses.asdict(n) for n in got.nodes] == \
        [dataclasses.asdict(n) for n in want.nodes]
    assert reference.shape(cfg["network"])["space"] == cfg["cut_space"]
    assert program_accelerator(cfg["accelerator"]["fields"]) == KCU1500


@pytest.mark.parametrize("name", ["yolov2-416", "yolov3-416"])
def test_configuration_widths_chain(name):
    """Every node reads what its first producer writes, and a concat's
    width is the sum of its inputs': no width is changed on one side only."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    nodes = reference.build_graph(cfg["network"]).nodes
    for n in nodes[1:]:
        first = nodes[n.inputs[0]]
        assert (n.in_ch, n.in_h, n.in_w) == \
            (first.out_ch, first.out_h, first.out_w), n
        if n.kind == "concat":
            assert n.out_ch == sum(nodes[i].out_ch for i in n.inputs), n
        if n.kind in ("add", "upsample"):
            assert n.out_ch == n.in_ch, n
