"""``repro_torch.kernels.search_pipeline`` vs the JAX package's fused search.

Stage by stage and as a whole, with the plain torch versions (what runs on
a host without a GPU, and what the CUDA kernels are held against on the
card):

* enumeration vs ``CutpointEngine._frame_matrix`` and vs the reference's
  Pallas enumeration kernel in interpret mode;
* cost keys vs the reference's host scorer, chunk winners vs its numpy
  pipeline (``_run_reference``), all three objectives.  The reference's
  Pallas cost and argmin kernels cannot run on this jax (they need
  ``jax.experimental.enable_x64``), so its numpy forms are the yardstick;
* argmin vs a stable ``np.lexsort`` on keys stuffed with duplicates;
* ``pipeline_subspace`` vs the reference's ``pipeline:reference`` and its
  branch-and-bound walk on partitioned sub-spaces.

Tolerance: none.  Integers equal, float64 keys bit-equal."""
import itertools

import numpy as np
import pytest
import torch

import repro.kernels.search_pipeline as ref_pipe
from repro.kernels.alloc_scan import pack_alloc_tables
from repro.core.search_pool import partition_space

import repro_torch.kernels.search_pipeline as port_pipe
from repro_torch.convert import pipeline_tables_from_numpy
from repro_torch.kernels.alloc_scan import alloc_scan

from torch_parity import ALL_CNNS, METRICS, both

OBJECTIVES = ("latency", "sram", "dram")


def _port_engine(name, engine="pipeline:torch"):
    _, port = both(name)
    return port.engine(engine=engine, device="cpu")


def _ref_engine(name):
    ref, _ = both(name)
    eng = ref.engine()
    eng._at = pack_alloc_tables(ref.gg, ref.hw)
    return eng


def _bits(x):
    return np.asarray(x, dtype=np.float64).view(np.int64)


# ------------------------------------------------------------ enumeration
@pytest.mark.parametrize("name", ALL_CNNS)
def test_enum_frames_matches_frame_matrix(name):
    """Linear indices of a sub-space (fixed prefix + mixed-radix suffix)
    decode to the masks the host paints from the cut tuples."""
    ref, _ = both(name)
    pe = _port_engine(name)
    tbl = port_pipe._engine_tables(pe)
    nr = len(ref.runs)
    npfx = max(0, nr - 4)
    prefix = tuple(len(r) // 2 for r in ref.runs[:npfx])
    dims = tuple(len(r) + 1 for r in ref.runs[npfx:])
    space = port_pipe.SubSpace.make(prefix, dims, "cpu")
    lo, count = space.size // 3, min(50, space.size - space.size // 3)
    tuples = [prefix + port_pipe._decode_index(j, space.strides, dims)
              for j in range(lo, lo + count)]
    want = ref.engine()._frame_matrix(tuples)
    got = port_pipe.enum_frames(tbl, space, lo, count)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want), name
    # product order == linear index order
    if npfx == 0:
        first = list(itertools.islice(
            itertools.product(*[range(d) for d in dims]), 5))
        assert first == [port_pipe._decode_index(j, space.strides, dims)
                         for j in range(5)]


@pytest.mark.parametrize("name", ["resnet50", "vgg16-conv"])
def test_enum_frames_matches_pallas_enum_kernel(name):
    """K2 itself, in interpret mode (it needs no x64)."""
    ref, _ = both(name)
    re_ = _ref_engine(name)
    rtbl = ref_pipe._engine_tables(re_)
    pe = _port_engine(name)
    tbl = port_pipe._engine_tables(pe)
    nr = len(ref.runs)
    prefix = (1,)
    dims = tuple(len(r) + 1 for r in ref.runs[1:])
    space = port_pipe.SubSpace.make(prefix, dims, "cpu")
    block_b, nb, lo = 8, 4, 40
    call = ref_pipe._build_enum_call(nb, block_b, rtbl["lanes"], nr, 1,
                                     space.strides, dims, True)
    want = np.asarray(call(np.asarray([lo], dtype=np.int32),
                           np.asarray(prefix, dtype=np.int32),
                           rtbl["runof_row"], rtbl["pos_row"],
                           rtbl["dirneg_row"]))[:, :rtbl["n"]]
    got = port_pipe.enum_frames_torch(tbl, space, lo, nb * block_b)
    assert np.array_equal(got.numpy(), want.astype(bool))


# ------------------------------------------------------- cost + chunk winner
@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("name", ["resnet50", "vgg16-conv"])
def test_cost_keys_match_reference_scorer(name, objective):
    """Key lanes of a chunk == the reference's host scorer on the same
    tuples: ``(infeasible, primary, secondary)`` bit for bit."""
    ref, _ = both(name)
    pe = _port_engine(name)
    tbl = port_pipe._engine_tables(pe)
    dims = tuple(len(r) + 1 for r in ref.runs)
    space = port_pipe.SubSpace.make((), dims, "cpu")
    lo, count = 100, 300
    frame = port_pipe.enum_frames(tbl, space, lo, count)
    res = alloc_scan(pe.alloc_tables(), frame)
    keys = port_pipe.cost_keys_torch(tbl, frame, res.io, res.stats, lo,
                                     objective).numpy()
    tuples = [port_pipe._decode_index(j, space.strides, dims)
              for j in range(lo, lo + count)]
    ms = ref.engine().score_batch(tuples, memoize=False)
    infeas, primary, secondary = ref_pipe._keys_np(
        objective, [m.latency_cycles for m in ms],
        [m.dram_total for m in ms], [m.sram_total for m in ms],
        [m.feasible for m in ms])
    assert np.array_equal(keys[0], infeas)
    assert np.array_equal(_bits(keys[1]), _bits(primary))
    assert np.array_equal(_bits(keys[2]), _bits(secondary))
    assert np.array_equal(keys[3], np.arange(lo, lo + count))
    # block rows: the per-block winners fold to the chunk's winner
    rows = port_pipe.cost_rows(tbl, frame, res.io, res.stats, lo, objective)
    assert rows.shape == (4, -(-count // port_pipe.COST_BLOCK))
    want = ref_pipe.argmin_lanes(infeas, primary, secondary,
                                 np.arange(lo, lo + count))
    got = port_pipe.argmin_rows(rows).tolist()
    assert (got[0], got[1], got[2], int(got[3])) == want


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_chunk_winners_match_run_reference(objective):
    """The device loop's winner == the reference's numpy pipeline, for
    chunkings that split the space differently (one chunk, ragged)."""
    name = "resnet50"
    ref, _ = both(name)
    re_ = _ref_engine(name)
    rtbl = ref_pipe._engine_tables(re_)
    pe = _port_engine(name)
    prefix = (5, 0)
    dims = tuple(len(r) + 1 for r in ref.runs[2:])
    space = port_pipe.SubSpace.make(prefix, dims, "cpu")
    want = ref_pipe._run_reference(re_, rtbl, prefix, dims, space.strides,
                                   space.size, 4096, objective)
    for chunk in (space.size, 100):
        rows = port_pipe.run_chunks(pe, space, objective, chunk, "torch")
        assert rows.shape == (-(-space.size // chunk), 4)
        best = None
        for row in rows.tolist():
            best = port_pipe._fold(best, row)
        assert best == tuple(float(x) for x in want), (objective, chunk)


# ------------------------------------------------------------------ argmin
def _fuzz_lanes(rng, n):
    """Keys designed to tie: every component comes from a tiny value set,
    so duplicated full keys are common and only the index separates
    winners (the fuzz of tests/test_search_pipeline.py)."""
    infeas = rng.choice([0.0, 1.0], size=n)
    primary = rng.choice([3.0, 7.0, 7.0, 11.0, 1e9], size=n)
    secondary = rng.choice([2.0, 5.0, 5.0, 123456.0], size=n)
    idx = rng.permutation(10 * n)[:n].astype(np.float64)
    return infeas, primary, secondary, idx


def _host_winner(infeas, primary, secondary, idx):
    j = int(np.lexsort((idx, secondary, primary, infeas))[0])
    return (float(infeas[j]), float(primary[j]), float(secondary[j]),
            int(idx[j]))


@pytest.mark.parametrize("n", [1, 2, 7, 64, 257, 1000])
def test_argmin_lanes_fuzzed_duplicate_keys(n):
    rng = np.random.default_rng(1234 + n)
    for _ in range(10):
        lanes = _fuzz_lanes(rng, n)
        want = _host_winner(*lanes)
        assert port_pipe.argmin_lanes(*lanes) == want
        assert want == ref_pipe.argmin_lanes(*lanes, backend="reference")


def test_argmin_lanes_edge_cases():
    n = 37
    rng = np.random.default_rng(7)
    _, primary, secondary, idx = _fuzz_lanes(rng, n)
    all_infeasible = np.ones(n)
    assert (port_pipe.argmin_lanes(all_infeasible, primary, secondary, idx)
            == _host_winner(all_infeasible, primary, secondary, idx))
    same = np.full(n, 5.0)
    assert port_pipe.argmin_lanes(np.zeros(n), same, same, idx)[3] == int(
        idx.min())
    with pytest.raises(ValueError):
        port_pipe.argmin_lanes([0.0], [1.0, 2.0], [1.0], [0.0])
    with pytest.raises(ValueError):
        port_pipe.argmin_lanes([], [], [], [])
    # a batched reduction along the last axis equals lane-by-lane calls
    lanes = torch.from_numpy(np.stack(
        [np.stack(_fuzz_lanes(rng, 16)) for _ in range(5)], axis=1))
    rows = port_pipe.argmin_rows_torch(lanes)
    for b in range(5):
        assert torch.equal(rows[:, b], port_pipe.argmin_rows(lanes[:, b]))


# -------------------------------------------------------- pipeline_subspace
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_pipeline_subspace_matches_reference(objective):
    """Partitioned resnet50 sub-spaces: the port's pipeline == the
    reference's ``pipeline:reference`` == its unpruned host walk."""
    ref, port = both("resnet50")
    prefixes, suffix_dims = partition_space(ref.runs, target_tasks=8)
    re_ = ref.engine()
    host = ref.engine()
    pe = _port_engine("resnet50")
    for prefix in prefixes[:3]:
        want, _ = ref.cut.branch_bound_subspace(host, prefix, suffix_dims,
                                                objective, prune=False)
        mid, _ = ref_pipe.pipeline_subspace(re_, prefix, suffix_dims,
                                            objective, batch_size=256,
                                            variant="reference")
        before = pe.evaluations
        got, pruned = port_pipe.pipeline_subspace(pe, prefix, suffix_dims,
                                                  objective, batch_size=200,
                                                  variant="torch")
        assert pruned == 0
        assert got.cuts == want.cuts == mid.cuts, (objective, prefix)
        for f in METRICS:
            assert getattr(got, f) == getattr(want, f), (objective, f)
        size = int(np.prod([d + 1 for d in suffix_dims]))
        assert pe.evaluations - before == size


def test_pipeline_subspace_singleton_and_validation():
    ref, _ = both("resnet50")
    pe = _port_engine("resnet50")
    full = tuple(len(r) // 2 for r in ref.runs)
    got, pruned = port_pipe.pipeline_subspace(pe, full, [], "latency")
    [want] = ref.engine().score_batch([full])
    assert pruned == 0 and got.cuts == full
    for f in METRICS:
        assert getattr(got, f) == getattr(want, f)
    with pytest.raises(ValueError):
        port_pipe.pipeline_subspace(pe, (), [1], "latency")
    with pytest.raises(ValueError):
        port_pipe.pipeline_subspace(pe, full, [], "speed")
    with pytest.raises(ValueError):
        port_pipe.pipeline_subspace(pe, full, [], "latency", variant="lax")


# ------------------------------------------------------------ state carried
def test_pipeline_tables_from_numpy_round_trip():
    """convert.pipeline_tables_from_numpy(the reference's table dict) ==
    the tables the port builds from its own engine."""
    name = "efficientnet-b1"
    rtbl = ref_pipe._engine_tables(_ref_engine(name))
    a = pipeline_tables_from_numpy(rtbl, device="cpu")
    b = port_pipe._engine_tables(_port_engine(name))
    assert (a.n, a.bpc, a.goc, a.budget, a.weight_bytes, a.row_buff) == (
        b.n, b.bpc, b.goc, b.budget, b.weight_bytes, b.row_buff)
    for f in ("run_of", "pos_of", "dir_neg", "run_of32", "pos_of32",
              "dir_neg8", "tab"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_kernel_wrappers_refuse_cpu_tensors():
    pe = _port_engine("vgg16-conv")
    tbl = port_pipe._engine_tables(pe)
    space = port_pipe.SubSpace.make(
        (), tuple(len(r) + 1 for r in pe.runs), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        port_pipe.enum_frames(tbl, space, 0, 8, backend="cuda")
    frame = port_pipe.enum_frames(tbl, space, 0, 8)
    res = alloc_scan(pe.alloc_tables(), frame)
    with pytest.raises(ValueError, match="CUDA"):
        port_pipe.cost_rows(tbl, frame, res.io, res.stats, 0, "latency",
                            backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        port_pipe.argmin_rows(torch.zeros((4, 3), dtype=torch.float64),
                              backend="cuda")
    from repro_torch.kernels import launch_counts
    assert set(launch_counts().values()) == {0}
