"""Host side of the PyTorch port vs the JAX package: IR and zoo, grouping,
allocator, the three cost models (scalar, tabulated, batched) and the ISA.

Everything here is integer-exact except the latency total; see
``torch_parity.R1_RTOL`` for how that one is held."""
import dataclasses

import numpy as np
import pytest

import repro.core.allocator as ref_alloc
import repro.core.compiler as ref_compiler
import repro.core.dram as ref_dram
import repro.core.isa as ref_isa
import repro.core.sram as ref_sram
import repro.core.timing as ref_timing

import repro_torch.core.allocator as port_alloc
import repro_torch.core.compiler as port_compiler
import repro_torch.core.dram as port_dram
import repro_torch.core.isa as port_isa
import repro_torch.core.sram as port_sram
import repro_torch.core.timing as port_timing

from torch_parity import (ALL_CNNS, INT_METRICS, R1_RTOL, both,
                          mixed_tuples, node_dicts)


@pytest.mark.parametrize("name", ALL_CNNS)
def test_zoo_nodes_and_groups_equal(name):
    ref, port = both(name)
    assert node_dicts(port.graph) == node_dicts(ref.graph)
    assert len(port.gg.groups) == len(ref.gg.groups)
    for pg, rg in zip(port.gg.groups, ref.gg.groups):
        assert pg.gid == rg.gid and pg.kind == rg.kind
        assert [n.idx for n in pg.nodes] == [n.idx for n in rg.nodes]
        for f in ("in_size", "out_size", "weight_size", "macs"):
            assert getattr(pg, f) == getattr(rg, f), (name, pg.gid, f)
    assert [b.gids for b in port.blocks] == [b.gids for b in ref.blocks]
    assert port.runs == ref.runs


def _policies(side, compiler, cuts):
    return {
        "all_row": compiler.all_row_policy(side.gg),
        "all_frame": compiler.all_frame_policy(side.gg),
        "cuts": side.cut.policy_from_cuts(side.gg, side.blocks, side.runs,
                                          cuts),
    }


@pytest.mark.parametrize("name", ALL_CNNS)
def test_allocation_reports_and_isa_equal(name):
    """``allocate`` under the all-row, all-frame and a mid-cut policy, then
    the three scalar reports and the encoded instruction words."""
    ref, port = both(name)
    cuts = tuple(len(r) // 2 for r in ref.runs)
    rp = _policies(ref, ref_compiler, cuts)
    pp = _policies(port, port_compiler, cuts)
    for which in rp:
        assert pp[which] == rp[which]
        ra = ref_alloc.allocate(ref.gg, rp[which])
        pa = port_alloc.allocate(port.gg, pp[which])
        assert dataclasses.asdict(pa) == dataclasses.asdict(ra), (name, which)
        assert (dataclasses.asdict(port_sram.sram_report(port.gg, pa,
                                                         port.hw))
                == dataclasses.asdict(ref_sram.sram_report(ref.gg, ra,
                                                           ref.hw)))
        assert (dataclasses.asdict(port_dram.dram_report(port.gg, pa))
                == dataclasses.asdict(ref_dram.dram_report(ref.gg, ra)))
        rl = ref_timing.latency_report(ref.gg, ra, ref.hw)
        pl = port_timing.latency_report(port.gg, pa, port.hw)
        assert pl.per_group == rl.per_group          # per group: bit-equal
        # R1: the reference totals with a compensated sum
        assert pl.cycles == pytest.approx(rl.cycles, rel=R1_RTOL, abs=0)
        assert (port_alloc.frame_feasible(port.gg, pp[which], pa)
                == ref_alloc.frame_feasible(ref.gg, rp[which], ra))
        rw = [i.encode().tolist()
              for i in ref_isa.generate_instructions(ref.gg, ra)]
        pw = [i.encode().tolist()
              for i in port_isa.generate_instructions(port.gg, pa)]
        assert pw == rw, (name, which)


@pytest.mark.parametrize("name", ALL_CNNS)
def test_cost_tables_equal(name):
    ref, port = both(name)
    pairs = [
        (port_timing.latency_tables(port.gg, port.hw),
         ref_timing.latency_tables(ref.gg, ref.hw)),
        (port_dram.dram_tables(port.gg), ref_dram.dram_tables(ref.gg)),
        (port_sram.sram_tables(port.gg, port.hw),
         ref_sram.sram_tables(ref.gg, ref.hw)),
    ]
    for pt, rt in pairs:
        for f in dataclasses.fields(rt):
            got, want = getattr(pt, f.name), getattr(rt, f.name)
            assert np.array_equal(np.asarray(got), np.asarray(want)), (
                name, type(rt).__name__, f.name)


@pytest.mark.parametrize("name", ALL_CNNS)
def test_scalar_and_batched_metrics_on_fuzzed_cuts(name):
    """Fuzzed cut tuples through both engines: the batched scorer
    (``score_batch``: integers equal, latency bit-equal -- both sides add
    left to right) and the scalar one (``evaluate``: integers equal,
    latency bit-equal to the *batched* reference and within R1_RTOL of the
    scalar reference)."""
    ref, port = both(name)
    tuples = mixed_tuples(ref.runs, n_prefix=12, n_random=12, seed=3)
    rb = ref.engine().score_batch(tuples)
    pb = port.engine().score_batch(tuples)
    re_, pe = ref.engine(), port.engine()
    for cuts, r, p in zip(tuples, rb, pb):
        assert p.cuts == r.cuts == cuts
        for f in INT_METRICS:
            assert getattr(p, f) == getattr(r, f), (name, cuts, f)
        assert p.latency_cycles == r.latency_cycles, (name, cuts)
        rs, ps = re_.evaluate(cuts), pe.evaluate(cuts)
        for f in INT_METRICS:
            assert getattr(ps, f) == getattr(rs, f), (name, cuts, f)
        assert ps.latency_cycles == r.latency_cycles, (name, cuts)
        assert ps.latency_cycles == pytest.approx(rs.latency_cycles,
                                                  rel=R1_RTOL, abs=0)


@pytest.mark.parametrize("name", ["resnet50", "yolov2", "efficientnet-b1"])
def test_prefix_bound_equal(name):
    """The branch-and-bound floors: integer objectives equal, the latency
    floor within R1_RTOL (the reference totals it with builtin ``sum``)."""
    ref, port = both(name)
    re_, pe = ref.engine(), port.engine()
    nr = len(ref.runs)
    for cuts in mixed_tuples(ref.runs, n_prefix=4, n_random=6, seed=9):
        for depth in sorted({1, (nr + 1) // 2, nr}):
            for objective in ("sram", "dram"):
                assert (pe.prefix_bound(cuts, depth, objective)
                        == re_.prefix_bound(cuts, depth, objective))
            assert pe.prefix_bound(cuts, depth, "latency") == pytest.approx(
                re_.prefix_bound(cuts, depth, "latency"), rel=R1_RTOL, abs=0)


def test_seq_sum_is_plain_left_to_right():
    """The port's one latency total equals ``np.cumsum``'s order (the
    reference's batched form) bit for bit, and is *not* the compensated
    builtin ``sum`` -- the input below separates the two."""
    vals = [1e16, 1.0, 1.0, 1.0, 1.0, -1e16, 0.1]
    assert port_timing.seq_sum(vals) == float(np.cumsum(vals)[-1])
    rng = np.random.default_rng(0)
    for _ in range(20):
        v = (rng.random(160) * 1e6).tolist()
        assert port_timing.seq_sum(v) == float(np.cumsum(v)[-1])
