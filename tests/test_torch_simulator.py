"""The functional simulator and the CNN numerics of the PyTorch port
(``core/simulator.py``, ``cnn/torch_ref.py``) against the JAX package, on
the CPU.

* Dry mode: the memory counters equal the reference simulator's, field by
  field, and the port's own analytic DRAM model, on all 8 zoo nets at their
  published sizes -- for the compiled plan and the all-row / all-frame
  policies.  On random graphs (R3 in ROADMAP queue 3) the model and the
  simulator may disagree; there port and reference are held equal on both
  numbers.
* Execute mode: within the port, the simulator's output equals
  ``run_graph``'s bit for bit (same ops, same device: a clobbered buffer
  would show).  Against the reference, from the same ``init_params``
  weights, two tolerances:

  - on graphs of a few layers at up to 32 pixels (tiny_resnet@32 of
    tests/test_compiler_cnn.py, one graph per node kind at 15 pixels):
    ``allclose(rtol=1e-5, atol=1e-5)`` element by element, the tolerance of
    the reference's own test;
  - on tiny_resnet@64 and the zoo nets at 64 pixels: ``max |port - ref| <=
    1e-5 * max |ref|``, and the port within ``5e-6 * max |ref|`` of the
    float64 evaluation of the same graph.  Element by element 1e-5 does not
    hold there, and not through the port: against the float64 evaluation
    the reference's own float32 error reaches 3.2e-6 of the output's scale
    (retinanet; the port's largest is 2.6e-6), so elements near zero differ
    by more than 1e-5 relative (measured on this host: 4% of
    tiny_resnet@64's elements, up to 16% of a zoo net's).  The convolutions
    sum thousands of float32 products in another order (oneDNN here, XLA
    there).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.cnn as ref_cnn
import repro.core.compiler as ref_compiler
import repro.core.options as ref_options
import repro.core.simulator as ref_sim
from repro.cnn.jax_ref import init_params as ref_init_params
from repro.cnn.jax_ref import run_graph as ref_run_graph
from repro.core.grouping import group_nodes as ref_group_nodes
from repro.core.ir import Graph, make_input

import repro_torch.core.compiler as port_compiler
import repro_torch.core.options as port_options
from repro_torch.cnn.torch_ref import (apply_node, init_params, load_params,
                                       run_graph, same_pads)
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.core.dram import dram_report
from repro_torch.core.simulator import MemCounters, simulate

from conftest import random_cnn
from hypothesis_compat import given, settings, st
from test_compiler_cnn import tiny_resnet
from torch_parity import ALL_CNNS, REF_BATCH, port_graph_of

AUDIT_LIMIT = 50_000
RTOL = ATOL = 1e-5
SCALE_TOL = 1e-5
F64_TOL = 5e-6


def _ref_opts(name):
    # R5: efficientnet-b1 against the reference's per-tuple descent
    return ref_options.CompileOptions(exhaustive_limit=AUDIT_LIMIT,
                                      batch_size=REF_BATCH.get(name, 1024))


def _port_opts():
    return port_options.CompileOptions(engine="journal", device="cpu",
                                       exhaustive_limit=AUDIT_LIMIT)


def _counters(c) -> dict:
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


# ------------------------------------------------------------- dry mode
@pytest.mark.parametrize("name", ALL_CNNS)
def test_dry_counters_equal_reference_and_model(name):
    g = ref_cnn.build_cnn(name)
    pg = port_graph_of(g)
    rp = ref_compiler.compile_graph(g, options=_ref_opts(name))
    pp = port_compiler.compile_graph(pg, options=_port_opts())
    assert tuple(pp.candidate.cuts) == tuple(rp.candidate.cuts)
    plans = [(pp, rp)]
    for fn in ("all_row_policy", "all_frame_policy"):
        plans.append((
            port_compiler.compile_graph(
                pg, policy=getattr(port_compiler, fn)(pp.grouped)),
            ref_compiler.compile_graph(
                g, policy=getattr(ref_compiler, fn)(rp.grouped))))
    for p, r in plans:
        _, got = simulate(p.grouped, p.alloc, p.instructions, execute=False)
        _, want = ref_sim.simulate(r.grouped, r.alloc, r.instructions,
                                   execute=False)
        assert isinstance(got, MemCounters)
        assert _counters(got) == _counters(want), name
        assert got.fm_total == p.dram.fm_bytes == dram_report(
            p.grouped, p.alloc).fm_bytes
        assert got.weight_reads == p.dram.weight_bytes
        assert got.dangling_reads == 0


@settings(max_examples=15, deadline=None)
@given(g=random_cnn(), seed=st.integers(0, 999))
def test_random_graphs_port_equals_reference_r3(g, seed):
    """R3: on random graphs the analytic model and the simulator need not
    agree (the reference's own property test finds graphs where they
    differ); the port reproduces both numbers of the reference exactly."""
    from repro.core.allocator import allocate as ref_allocate
    from repro.core.dram import dram_report as ref_dram_report
    from repro.core.isa import generate_instructions as ref_gen
    from repro_torch.core.allocator import allocate
    from repro_torch.core.grouping import group_nodes
    from repro_torch.core.isa import generate_instructions

    rgg = ref_group_nodes(g)
    rng = np.random.default_rng(seed)
    policy = {gr.gid: ("row" if rng.random() < 0.5 else "frame")
              for gr in rgg.groups}
    ralloc = ref_allocate(rgg, policy)
    _, want = ref_sim.simulate(rgg, ralloc, ref_gen(rgg, ralloc),
                               execute=False)
    gg = group_nodes(port_graph_of(g))
    alloc = allocate(gg, policy)
    _, got = simulate(gg, alloc, generate_instructions(gg, alloc),
                      execute=False)
    assert _counters(got) == _counters(want)
    rep, ref_rep = dram_report(gg, alloc), ref_dram_report(rgg, ralloc)
    assert (rep.fm_bytes, rep.weight_bytes) == (ref_rep.fm_bytes,
                                               ref_rep.weight_bytes)


# ----------------------------------------------------------- execute mode
def _input(size, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (1, size, size, 3), dtype=np.float32)


def _ref_out(g, params, x):
    return np.asarray(ref_run_graph(g, params, x)[len(g.nodes) - 1])


def _f64_out(pg, params, x):
    """The graph's output evaluated in float64 by the same ops (the
    yardstick both float32 results are measured against)."""
    w = {k: v.to(torch.float64) for k, v in load_params(params,
                                                         "cpu").items()}
    outs = {}
    for n in pg:
        outs[n.idx] = (torch.from_numpy(x.astype(np.float64))
                       if n.kind == "input"
                       else apply_node(n, [outs[i] for i in n.inputs], w))
    return outs[len(pg.nodes) - 1].numpy()


def _assert_near_reference(got, want, truth, ctx):
    """The scale tolerance of the module docstring."""
    assert got.shape == want.shape and np.isfinite(got).all(), ctx
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= SCALE_TOL * scale, (
        ctx, np.abs(got - want).max() / scale)
    assert np.abs(got - truth).max() <= F64_TOL * scale, (
        ctx, np.abs(got - truth).max() / scale)


@pytest.mark.parametrize("policy", ["all_row_policy", "all_frame_policy",
                                    None])
@pytest.mark.parametrize("size", [32, 64])
def test_tiny_resnet_simulator_equals_run_graph_and_reference(size, policy):
    g = tiny_resnet(size)
    pg = port_graph_of(g)
    if policy is None:
        plan = port_compiler.compile_graph(pg, options=_port_opts())
    else:
        gg = port_compiler.group_nodes(pg)
        plan = port_compiler.compile_graph(
            pg, policy=getattr(port_compiler, policy)(gg))
    params = ref_init_params(g)
    x = _input(size, seed=1)
    out, counters = simulate(plan.grouped, plan.alloc, plan.instructions,
                             params, x, device="cpu")
    mine = run_graph(pg, params, x, device="cpu")[len(pg.nodes) - 1]
    assert torch.equal(out, mine)
    want = _ref_out(g, params, x)
    if size == 32:
        np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)
    else:
        _assert_near_reference(out.numpy(), want, _f64_out(pg, params, x),
                               ("tiny", size, policy))
    assert counters.weight_reads == g.total_weight_bytes()


def _node_kinds_graph() -> Graph:
    """Every node kind the executor knows, with odd spatial sizes so that
    SAME padding is asymmetric (the extra row and column at the bottom and
    right), a grouped conv, both pools, YOLOv2's space-to-depth route, an
    identity route and an SE channel gate."""
    g = Graph("kinds")
    make_input(g, 15, 15)
    g.add("conv", out_ch=8, k=3, stride=2, act="leaky")       # 15 -> 8
    a = g.add("conv", out_ch=8, k=3, act="relu")
    g.add("route", inputs=[a.idx],
          out_h=a.out_h // 2, out_w=a.out_w // 2, out_ch=4 * a.out_ch)
    s2d = g.nodes[-1]                                          # 4x4x32
    g.add("conv", inputs=[a.idx], out_ch=16, k=3, stride=2, groups=2,
          act="swish")                                         # 8 -> 4
    g.add("concat", inputs=[len(g.nodes) - 1, s2d.idx])        # 4x4x48
    g.add("conv", out_ch=8, k=1, act="linear")
    up = g.add("upsample", stride=2)                           # 8x8x8
    g.add("add", inputs=[up.idx, a.idx])
    g.add("maxpool", k=3, stride=2)                            # 8 -> 4
    odd = g.add("conv", inputs=[a.idx], out_ch=8, k=1, act="relu",
                stride=1)
    g.add("avgpool", inputs=[odd.idx], k=3, stride=3)          # 8 -> 3
    g.add("dwconv", k=3, stride=2, act="swish")                # 3 -> 2
    dw = g.nodes[-1]
    g.add("globalpool", inputs=[dw.idx])
    g.add("fc", out_ch=4, in_ch=8, in_h=1, in_w=1, out_h=1, out_w=1,
          act="swish")
    se = g.add("fc", out_ch=8, in_ch=4, in_h=1, in_w=1, out_h=1, out_w=1,
               act="sigmoid")
    g.add("scale", inputs=[dw.idx, se.idx])
    g.add("route")                                             # identity
    g.validate()
    return g


def test_every_node_kind_equals_reference():
    g = _node_kinds_graph()
    pg = port_graph_of(g)
    params = ref_init_params(g, seed=4)
    x = np.random.default_rng(3).standard_normal((1, 15, 15, 3),
                                                 dtype=np.float32)
    want = ref_run_graph(g, params, x)
    got = run_graph(pg, params, x, device="cpu")
    assert {n.kind for n in g} >= {
        "conv", "dwconv", "fc", "maxpool", "avgpool", "globalpool",
        "upsample", "add", "concat", "route", "scale"}
    for n in g:
        w, p = np.asarray(want[n.idx]), got[n.idx].numpy()
        assert p.shape == w.shape, (n.idx, n.kind)
        np.testing.assert_allclose(p, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"node {n.idx} ({n.kind})")


def test_same_padding_is_xla_s():
    # out = ceil(in / s); the odd extra goes after (bottom / right)
    assert same_pads(15, 3, 2) == (1, 1)
    assert same_pads(16, 3, 2) == (0, 1)
    assert same_pads(8, 2, 2) == (0, 0)
    assert same_pads(8, 3, 3) == (0, 1)
    assert same_pads(5, 1, 1) == (0, 0)


def test_space_to_depth_element_order():
    """YOLOv2's reorg: channel block (dy, dx) of output pixel (i, j) holds
    input pixel (2i + dy, 2j + dx) -- a permutation no shape check sees."""
    g = Graph("s2d")
    make_input(g, 4, 4, ch=2)
    g.add("route", out_h=2, out_w=2, out_ch=8)
    pg = port_graph_of(g)
    x = np.arange(32, dtype=np.float32).reshape(1, 4, 4, 2)
    got = run_graph(pg, {}, x, device="cpu")[1].numpy()
    want = np.asarray(ref_run_graph(g, {}, x)[1])
    assert np.array_equal(got, want)
    for i, j, dy, dx, c in np.ndindex(2, 2, 2, 2, 2):
        assert got[0, i, j, (2 * dy + dx) * 2 + c] == x[0, 2 * i + dy,
                                                         2 * j + dx, c]


def test_params_carried_across():
    g = _node_kinds_graph()
    pg = port_graph_of(g)
    ref = ref_init_params(g, seed=9)
    mine = init_params(pg, seed=9)
    assert ref.keys() == mine.keys()
    for k in ref:
        assert np.array_equal(ref[k], mine[k])
    # init_params scales float32 draws by a float64 factor, so its arrays
    # are float64; both packages compute with them rounded once to float32
    w = cnn_params_from_numpy(ref, device="cpu")
    for n in g:
        want = ref.get(n.idx, np.zeros(0)).astype(np.float32)
        if n.kind == "conv":
            assert tuple(w[n.idx].shape) == (n.out_ch, n.in_ch // n.groups,
                                             n.k, n.k)
            assert np.array_equal(w[n.idx].numpy(),
                                  want.transpose(3, 2, 0, 1))
        if n.kind == "fc":
            assert w[n.idx].dtype == torch.float32
            assert np.array_equal(w[n.idx].numpy(), want)
    # converted weights and numpy weights compute the same thing
    x = np.random.default_rng(0).standard_normal((1, 15, 15, 3),
                                                 dtype=np.float32)
    a = run_graph(pg, w, x, device="cpu")[len(g.nodes) - 1]
    b = run_graph(pg, ref, x, device="cpu")[len(g.nodes) - 1]
    assert torch.equal(a, b)
    assert load_params(w, "cpu")[1] is w[1]


def test_apply_node_refuses_unknown_kind():
    g = _node_kinds_graph()
    node = dataclasses.replace(port_graph_of(g).nodes[1], kind="lstm")
    with pytest.raises(ValueError, match="cannot execute"):
        apply_node(node, [torch.zeros((1, 15, 15, 3))], {})


@pytest.mark.parametrize("name", ALL_CNNS)
def test_zoo_at_64_simulator_bit_equal_and_close_to_reference(name):
    """The quickstart's numerical check on every zoo net at size 64."""
    g = ref_cnn.build_cnn(name, 64)
    pg = port_graph_of(g)
    plan = port_compiler.compile_graph(pg, options=_port_opts())
    params = ref_init_params(g)
    x = _input(64)
    out, _ = simulate(plan.grouped, plan.alloc, plan.instructions, params,
                      x, device="cpu")
    mine = run_graph(pg, params, x, device="cpu")[len(pg.nodes) - 1]
    assert torch.equal(out, mine), name
    _assert_near_reference(out.numpy(), _ref_out(g, params, x),
                           _f64_out(pg, params, x), name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clobbered_buffer_shows_as_corruption(seed):
    """Reroute one frame group's output onto a buffer whose tensor is
    still live.  The simulator looks a consumer's operand up by its owner,
    so the evicted tensor is never silently reused: the dry run counts a
    dangling DRAM read, and the executed run finds no operand and raises --
    as the reference simulator does on the same mutant."""
    from repro.analysis import mutate_plan as ref_mutate_plan
    from repro_torch.analysis import mutate_plan
    g = tiny_resnet(32)
    pg = port_graph_of(g)
    plan = port_compiler.compile_graph(
        pg, policy=port_compiler.all_frame_policy(
            port_compiler.group_nodes(pg)))
    rplan = ref_compiler.compile_graph(
        g, policy=ref_compiler.all_frame_policy(ref_group_nodes(g)))
    m = mutate_plan(plan, "clobber_alloc", seed=seed)
    rm = ref_mutate_plan(rplan, "clobber_alloc", seed=seed)
    assert m is not None and m.description == rm.description
    _, got = simulate(m.gg, m.alloc, m.instructions, execute=False)
    _, want = ref_sim.simulate(rm.gg, rm.alloc, rm.instructions,
                               execute=False)
    assert _counters(got) == _counters(want)
    assert got.dangling_reads > 0
    params = ref_init_params(g)
    x = _input(32, seed=1)
    with pytest.raises(TypeError):
        simulate(m.gg, m.alloc, m.instructions, params, x, device="cpu")
    with pytest.raises(TypeError):
        ref_sim.simulate(rm.gg, rm.alloc, rm.instructions, params, x)
    ok, _ = simulate(plan.grouped, plan.alloc, plan.instructions, params, x,
                     device="cpu")
    assert torch.equal(ok, run_graph(pg, params, x,
                                     device="cpu")[len(pg.nodes) - 1])
