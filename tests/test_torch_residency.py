"""The port's residency planner against the JAX package's, bit for bit.

``core/residency.py`` is pure numpy in both packages and plans for the same
TPU v5e description (``core/hw.py::V5E``, carried over unchanged), so the
same stack must give the same plan: ``est_seconds`` (a ``math.fsum`` of
float64 terms), ``hbm_bytes``, ``vmem_peak``, the modes, the cut and every
per-block row, with no tolerance.  Stacks: the fuzzed heterogeneous ones of
``tests/test_residency_engine.py`` (under several VMEM budgets), the LM
arch stacks of ``benchmarks/residency_lm.py::make_blocks`` converted field
for field, the synthetic stacks of ``benchmarks/residency_throughput.py``,
and the empty and single-block stacks.  The port's ``residency.py`` also
passes ``tools/lint_determinism.py``.
"""
import dataclasses
import random
from pathlib import Path

import pytest
from hypothesis_compat import given, settings, st

import repro.core.residency as ref
from repro.core.hw import V5E as REF_V5E

import repro_torch.core.residency as port
from repro_torch.core.hw import V5E as PORT_V5E

MB = 1 << 20
ROOT = Path(__file__).resolve().parent.parent
BUDGETS = [None, 16 * MB, 64 * MB, 256 * MB]


def rand_stack(n, seed):
    """``tests/test_residency_engine.py``'s heterogeneous stack, as field
    dicts."""
    rng = random.Random(seed)
    return [dict(
        idx=i,
        kind=rng.choice(["attn", "mlp", "moe", "cross", "vision"]),
        weight_bytes=rng.choice([8, 64, 512, 4096]) * MB,
        stream_bytes=rng.choice([1, 8, 64, 256]) * MB,
        act_bytes=rng.choice([4, 32, 256]) * MB,
        flops=rng.choice([10 ** 11, 10 ** 12, 10 ** 13]),
        state_bytes=rng.choice([0, 0, 16, 128]) * MB,
        vmem_resident=rng.choice([0, 0, 0, 32, 500]) * MB)
        for i in range(n)]


def both(fields):
    """The same stack as the JAX package's and as the port's blocks."""
    return ([ref.LMBlockSpec(**f) for f in fields],
            [port.LMBlockSpec(**f) for f in fields])


def plan_tuple(plan):
    return (plan.modes, plan.cut, plan.hbm_bytes, plan.vmem_peak,
            plan.est_seconds, plan.per_block, plan.summary())


def assert_same_plans(fields, budget=None):
    """Every cut's price, the sweep, the DP's modes and the three plans
    equal between the packages, floats compared with ``==``."""
    rb, pb = both(fields)
    assert PORT_V5E == port.TPUConfig(**dataclasses.asdict(REF_V5E))
    reng = ref.ResidencyEngine(rb, REF_V5E, budget)
    peng = port.ResidencyEngine(pb, PORT_V5E, budget)
    for cut in range(len(fields) + 1):
        assert peng.evaluate_cut(cut) == reng.evaluate_cut(cut), cut
        assert peng.cut_modes(cut) == reng.cut_modes(cut)
    assert peng.sweep() == reng.sweep()
    assert peng.dp_modes() == reng.dp_modes()
    for name in ("plan_cutpoint", "plan_dp"):
        got = getattr(port, name)(pb, PORT_V5E, budget, engine=peng)
        want = getattr(ref, name)(rb, REF_V5E, budget, engine=reng)
        assert plan_tuple(got) == plan_tuple(want), name
    assert (plan_tuple(port.streaming_baseline(pb, PORT_V5E, budget))
            == plan_tuple(ref.streaming_baseline(rb, REF_V5E, budget)))
    # the defaults plan for V5E in both packages
    assert (plan_tuple(port.plan_cutpoint(pb))
            == plan_tuple(ref.plan_cutpoint(rb)))


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 40), seed=st.integers(0, 10 ** 6))
def test_fuzzed_stacks_plan_bit_for_bit(n, seed):
    budget = random.Random(seed ^ 0xbeef).choice(BUDGETS)
    assert_same_plans(rand_stack(n, seed), budget)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("budget", BUDGETS, ids=["v5e", "16MB", "64MB",
                                                 "256MB"])
def test_seeded_stacks_plan_bit_for_bit(seed, budget):
    assert_same_plans(rand_stack(8 + 7 * seed, seed), budget)


def _lm_cells():
    from repro.configs import valid_cells
    return valid_cells()


@pytest.mark.parametrize("arch,shape", _lm_cells())
def test_lm_arch_stacks_plan_bit_for_bit(arch, shape):
    """Every (arch, shape) cell the LM residency benchmark plans."""
    from benchmarks.residency_lm import make_blocks
    from repro.configs import SHAPES, get_config
    blocks = make_blocks(get_config(arch), SHAPES[shape])
    assert_same_plans([dataclasses.asdict(b) for b in blocks])


@pytest.mark.parametrize("kind", ["uniform-lm", "moe-interleave",
                                  "hetero-vision-cross"])
def test_synthetic_throughput_stacks_plan_bit_for_bit(kind):
    from benchmarks.residency_throughput import make_stack
    assert_same_plans([dataclasses.asdict(b) for b in make_stack(kind, 64)])


def test_empty_and_single_block_stacks():
    assert port.plan_cutpoint([]).modes == ref.plan_cutpoint([]).modes == []
    assert port.plan_dp([]).modes == []
    assert plan_tuple(port.streaming_baseline([])) == plan_tuple(
        ref.streaming_baseline([]))
    for seed in range(4):
        assert_same_plans(rand_stack(1, seed))


def test_resident_vmem_is_derived_alike():
    for fields in rand_stack(30, 3):
        rb, pb = both([fields])
        assert pb[0].resident_vmem(PORT_V5E) == rb[0].resident_vmem(REF_V5E)


def test_engine_refuses_another_stack():
    _, pb = both(rand_stack(5, 1))
    eng = port.ResidencyEngine(pb)
    with pytest.raises(AssertionError):
        port.plan_cutpoint(list(pb), engine=eng)


def test_lint_determinism_passes_on_the_port():
    """Every accumulation in the port's planner carries its ``# det:``
    pragma or is exempt, as the reference's must."""
    import sys
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import lint_determinism
    finally:
        sys.path.remove(str(ROOT / "tools"))
    path = ROOT / "src" / "repro_torch" / "core" / "residency.py"
    assert lint_determinism.main([str(path)]) == 0
    assert lint_determinism.lint_file(path) == []
