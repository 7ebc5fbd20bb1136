"""The slice as a whole: ``compile_graph`` of the PyTorch port vs the JAX
package on the 8 zoo nets, under the three engines, on the CPU.

Held equal: cuts, ``evaluated``, ``path``, every integer metric
(DRAM / SRAM / BRAM18K), feasibility and the encoded instruction stream.
Latency: the port totals in plain left-to-right order everywhere, so its
plan latency is bit-equal to the reference's ``latency_cycles_fast_batch``
for the winning policy and within ``R1_RTOL`` of the reference's
``latency_report`` (which totals with a compensated builtin ``sum``).

yolov2's full space (7.96M tuples) is far too large for a CPU test: like
tests/test_search_pool.py the suite lowers ``exhaustive_limit`` so that net
takes the descent path, and searches a yolov2 sub-space exhaustively
through ``pipeline_subspace`` instead."""
import pytest

import repro.core.compiler as ref_compiler
import repro.core.options as ref_options
import repro.kernels.search_pipeline as ref_pipe

import repro_torch.core.compiler as port_compiler
import repro_torch.core.options as port_options
import repro_torch.kernels.search_pipeline as port_pipe
from repro_torch.convert import graph_from_nodes

from conftest import random_cnn
from hypothesis_compat import given, settings
from torch_parity import (ALL_CNNS, METRICS, TEST_LIMIT, assert_plans_equal,
                          both, node_dicts, port_graph_of, ref_plan)
import torch_parity

torch_parity.one_thread()

# port engine spelling -> the reference engine it is held against; the
# "device" engine has a file of its own (tests/test_torch_compile_device.py)
ENGINES = {"journal": "journal", "pipeline": "pipeline:reference"}

@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", ALL_CNNS)
def test_compile_graph_equals_reference(name, engine):
    _, port = both(name)
    pp = port_compiler.compile_graph(
        port.graph, port.hw, port_options.CompileOptions(
            engine=engine, device="cpu", exhaustive_limit=TEST_LIMIT))
    assert_plans_equal(pp, ref_plan(name, ENGINES[engine]),
                        (name, engine))


def test_reference_batched_descent_r5():
    """The known disagreement (R5).  The port equals the reference's
    per-tuple descent on efficientnet-b1 -- always.  Where the interpreter
    totals floats with a compensated builtin ``sum`` (Python >= 3.12), the
    reference's default *batched* descent differs from its own per-tuple
    one, and what it returns is the worse key: cut 0 for run 16 after 196
    evaluations against cut 1 after 170, the same latency with more SRAM.
    That is pinned here so that the record in ROADMAP queue 3 stays true."""
    ref, port = both("efficientnet-b1")
    scalar = ref.cut.search(ref.gg, ref.hw,
                            ref_options.CompileOptions(batch_size=1))
    for batch in (1, 64, 1024):
        ours = port.cut.search(port.gg, port.hw, port_options.CompileOptions(
            engine="journal", device="cpu", batch_size=batch))
        assert tuple(ours.best.cuts) == tuple(scalar.best.cuts)
        assert ours.evaluated == scalar.evaluated == 170
        assert ours.best.sram_total == scalar.best.sram_total == 7040896
    batched = ref.cut.search(ref.gg, ref.hw, ref_options.CompileOptions())
    if tuple(batched.best.cuts) != tuple(scalar.best.cuts):
        assert scalar.best.cuts[16] == 1
        assert batched.best.cuts[16] == 0 and batched.evaluated == 196
        assert batched.best.latency_cycles == scalar.best.latency_cycles
        assert batched.best.sram_total == 7040960


@pytest.mark.parametrize("objective", ["sram", "dram"])
@pytest.mark.parametrize("name", ["resnet50", "mobilenet-v3"])
def test_compile_graph_other_objectives(name, objective):
    ref, port = both(name)
    rp = ref_compiler.compile_graph(
        ref.graph, ref.hw, ref_options.CompileOptions(
            objective=objective, exhaustive_limit=TEST_LIMIT))
    pp = port_compiler.compile_graph(
        port.graph, port.hw, port_options.CompileOptions(
            objective=objective, engine="pipeline@300", device="cpu",
            exhaustive_limit=TEST_LIMIT))
    assert_plans_equal(pp, rp, (name, objective))


def test_yolov2_subspace_exhaustive():
    """A slice of yolov2's exhaustive space (the leading runs fixed at the
    full search's winner): the port's pipeline == the reference's."""
    ref, port = both("yolov2")
    prefix = (2, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1)
    suffix_dims = [len(r) for r in ref.runs[len(prefix):]]
    want, _ = ref_pipe.pipeline_subspace(ref.engine(), prefix, suffix_dims,
                                         "latency", batch_size=512,
                                         variant="reference")
    pe = port.engine(engine="pipeline", device="cpu")
    got, pruned = port_pipe.pipeline_subspace(pe, prefix, suffix_dims,
                                              "latency", batch_size=500,
                                              variant="torch")
    assert pruned == 0 and got.cuts == want.cuts
    for f in METRICS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.cuts == (2, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 3, 2,
                        1, 0)
    assert got.latency_cycles == 5728364.05


def test_compile_given_policy_equals_reference():
    ref, port = both("resnet50")
    rp = ref_compiler.compile_graph(
        ref.graph, ref.hw, policy=ref_compiler.all_row_policy(ref.gg))
    pp = port_compiler.compile_graph(
        port.graph, port.hw, policy=port_compiler.all_row_policy(port.gg))
    assert pp.search is None and rp.search is None
    assert pp.dram.total == rp.dram.total
    assert pp.baseline_dram == rp.baseline_dram
    assert pp.offchip_reduction == rp.offchip_reduction
    assert pp.sram.sram_total == rp.sram.sram_total
    assert pp.candidate.feasible == rp.candidate.feasible
    assert pp.summary().split("latency")[0] == rp.summary().split(
        "latency")[0]


# ------------------------------------------------------- state carried over
@pytest.mark.parametrize("name", ["yolov3", "efficientnet-b1"])
def test_graph_from_nodes_round_trip(name):
    ref, port = both(name)
    carried = port_graph_of(ref.graph)
    assert node_dicts(carried) == node_dicts(port.graph)
    opts = dict(engine="journal", exhaustive_limit=TEST_LIMIT)
    pp = port_compiler.compile_graph(
        carried, port.hw, port_options.CompileOptions(device="cpu", **opts))
    assert_plans_equal(pp, ref_plan(name, "journal"), name)


def test_graph_from_nodes_refuses_bad_input():
    ref, _ = both("vgg16-conv")
    nodes = node_dicts(ref.graph)
    with pytest.raises(ValueError, match="index order"):
        graph_from_nodes("x", nodes[1:])
    with pytest.raises(ValueError, match="unknown LayerNode fields"):
        graph_from_nodes("x", [dict(nodes[0], colour="red")])


@settings(max_examples=12, deadline=None)
@given(g=random_cnn())
def test_random_cnn_graph_through_both_compilers(g):
    """A graph built by the reference (random residual CNN: shortcut
    fan-out, pools, upsamples) carried into the port as plain data."""
    rp = ref_compiler.compile_graph(g, options=ref_options.CompileOptions())
    for engine in ("journal", "pipeline@64"):
        pp = port_compiler.compile_graph(
            port_graph_of(g),
            options=port_options.CompileOptions(engine=engine, device="cpu"))
        assert_plans_equal(pp, rp, engine)
