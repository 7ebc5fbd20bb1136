"""``compile_graph(engine="device")`` of the PyTorch port vs the JAX
package's ``engine="device"`` on the 8 zoo nets, on the CPU: the search
scores every batch through the tensorized allocator replay (the plain torch
version here, the CUDA kernel on a GPU) instead of the journal replay.

Equalities and the latency rule are those of tests/test_torch_compile.py."""
import pytest

import repro_torch.core.compiler as port_compiler
import repro_torch.core.options as port_options

from torch_parity import (ALL_CNNS, INT_METRICS, TEST_LIMIT,
                          assert_plans_equal, both, mixed_tuples, ref_plan)


@pytest.mark.parametrize("name", ALL_CNNS)
def test_compile_graph_device_equals_reference(name):
    _, port = both(name)
    pp = port_compiler.compile_graph(
        port.graph, port.hw, port_options.CompileOptions(
            engine="device", device="cpu", exhaustive_limit=TEST_LIMIT))
    assert_plans_equal(pp, ref_plan(name, "device"), (name, "device"))


@pytest.mark.parametrize("name", ["resnet50", "mobilenet-v3"])
def test_score_batch_device_equals_journal_and_reference(name):
    """One engine, both replays: metrics, memo and ``evaluations`` agree
    with the journal replay and with the reference's device replay."""
    ref, port = both(name)
    tuples = mixed_tuples(ref.runs, n_prefix=10, n_random=10, seed=21)
    want = ref.engine(replay="device").score_batch(tuples)
    dev = port.engine(engine="device", device="cpu")
    jou = port.engine(engine="journal")
    got_d = dev.score_batch(tuples)
    got_j = jou.score_batch(tuples)
    assert dev.evaluations == jou.evaluations == len(set(tuples))
    for w, d, j in zip(want, got_d, got_j):
        assert d.cuts == j.cuts == w.cuts
        assert d.latency_cycles == j.latency_cycles == w.latency_cycles
        for f in INT_METRICS:
            assert getattr(d, f) == getattr(j, f) == getattr(w, f), f
    # skip mask: pruned lanes are never replayed nor counted
    skip = [i % 3 == 0 for i in range(len(tuples))]
    before = dev.evaluations
    out = dev.score_batch(tuples, memoize=False, skip=skip)
    assert dev.evaluations - before == skip.count(False)
    for s, m, w in zip(skip, out, got_j):
        assert (m is None) if s else (m.sram_total == w.sram_total
                                      and m.dram_fm == w.dram_fm)
