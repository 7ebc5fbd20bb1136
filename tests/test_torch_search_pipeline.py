"""``repro_torch.kernels.search_pipeline`` vs the JAX package's fused search.

Stage by stage and as a whole, with the plain torch versions (what runs on
a host without a GPU, and what the CUDA kernels are held against on the
card):

* enumeration vs ``CutpointEngine._frame_matrix`` and vs the reference's
  Pallas enumeration kernel in interpret mode; the CUDA kernel's schedule
  (``enum_schedule``: V candidates a thread, digits stepped without
  division, V-byte stores) vs both and vs ``(j // stride) % dim``;
* cost keys vs the reference's host scorer, chunk winners vs its numpy
  pipeline (``_run_reference``), all three objectives.  The reference's
  Pallas cost and argmin kernels cannot run on this jax (they need
  ``jax.experimental.enable_x64``), so its numpy forms are the yardstick;
* argmin vs a stable ``np.lexsort`` on keys stuffed with duplicates; the
  kernels' row reduction (``rows_argmin_schedule``) vs the plain version
  under permutations of the rows; chunk winners taken by the cost stage vs
  the reference's ``_run_reference`` chunk by chunk;
* ``pipeline_subspace`` vs the reference's ``pipeline:reference`` and its
  branch-and-bound walk on partitioned sub-spaces.

Tolerance: none.  Integers equal, float64 keys bit-equal."""
import functools
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

from hypothesis_compat import given, settings, st
from torch_parity import ALL_CNNS, METRICS, both
import torch_parity

torch_parity.one_thread()

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
    with pytest.raises(ValueError, match="CUDA"):
        port_pipe.cost_rows(tbl, frame, res.io, res.stats, 0, "latency",
                            backend="cuda",
                            winner=torch.empty(4, dtype=torch.float64))
    from repro_torch.kernels import fused_launch_counts, launch_counts
    assert set(launch_counts().values()) == {0}
    assert fused_launch_counts() == {"argmin_rows": 0}


# ------------------------------------------- K3's schedule, on the CPU
_TAB = dict(comp=0, row=1, weight=2, side=3, rowfm=4, scomp=5, sweight=6,
            outf=7, outr=8, wrr=9)


def _key_less(o, a):
    """``csrc/search_pipeline.cu::key_less`` over arrays of keys (..., 4)."""
    less = np.zeros(o.shape[:-1], dtype=bool)
    undecided = np.ones(o.shape[:-1], dtype=bool)
    for c in range(4):
        ne = o[..., c] != a[..., c]
        less |= undecided & ne & (o[..., c] < a[..., c])
        undecided &= ~ne
    return less


def _price(t, fr, io_g, tbl, q):
    """``price_group``: the latency terms of one group (table column ``t``)
    for candidates with frame bits ``fr`` and io words ``io_g``; the
    order-free terms go into ``q``."""
    per = np.full(fr.shape, t[_TAB["row"]])
    if t[_TAB["side"]] > 0.0:
        per[:] = t[_TAB["comp"]]
    else:
        mem = (t[_TAB["weight"]] + io_g.astype(np.float64)) / tbl.bpc
        per = np.where(fr, np.maximum(t[_TAB["comp"]], mem) + tbl.goc, per)
    q["rterm"] = np.where(fr, q["rterm"], q["rterm"] + t[_TAB["rowfm"]])
    if t[_TAB["scomp"]] > 0.0:
        q["outf"] = np.where(fr, np.maximum(q["outf"], t[_TAB["outf"]]),
                             q["outf"])
        for name in ("sweight", "outr", "wrr"):
            key = "wbuff" if name == "sweight" else name
            q[key] = np.where(fr, q[key], np.maximum(q[key], t[_TAB[name]]))
    return per


def cost_schedule(tbl, frame, io, stats, lo, objective, plan):
    """``csrc/search_pipeline.cu``'s cost kernels as they run, in numpy.

    Block ``blk`` prices candidates ``blk * COST_BLOCK + c``.  With one
    thread a candidate, thread ``c`` loads the frame bytes and io words of
    ``COST_WINDOW`` groups at a time from the flat lane-major rows (nothing
    past B or n) and adds each group's term in gid order.  Split, thread
    ``(p, c)`` of ``COST_SPLIT`` prices groups ``g0 + p + COST_SPLIT * j``
    of each step of ``COST_STEP`` groups, from load slots refilled
    ``COST_AHEAD`` steps ahead, into a term buffer (asserted to be written
    once a step), and thread ``(0, c)`` adds the step's terms in gid order;
    the order-free terms are combined across ``p`` at the end.
    The table is read from its staged tile of ``COST_TILE`` groups, padded
    past n with side groups of 0 cycles, and both kernels run whole windows
    or steps over the padding (adding +0.0).  Then each block's tree of
    ``block_argmin_in``.  Returns the rows (4, blocks) and how often each
    (group, candidate) element was loaded."""
    B, n = frame.shape
    nb, blk = plan.blocks, port_pipe.COST_BLOCK
    assert nb * blk >= B > (nb - 1) * blk
    fr_flat = frame.numpy().astype(np.uint8).T.reshape(-1)
    io_flat = io.numpy().astype(np.int64).T.reshape(-1)
    st_flat = stats.numpy().astype(np.int64).T.reshape(-1)
    tab = tbl.tab.numpy()
    b = np.arange(nb * blk)                  # candidate c of block blk
    ok = b < B
    loads = np.zeros((n, B), dtype=np.int64)

    def load(g):
        """Frame bits and io words of group g for every candidate."""
        fr = np.zeros(len(b), dtype=bool)
        io_g = np.zeros(len(b), dtype=np.int64)
        if g < n:
            fr[ok] = fr_flat[g * B + b[ok]] != 0
            io_g[ok] = io_flat[g * B + b[ok]]
            loads[g] += 1
        return fr, io_g

    def fresh():
        return {k: np.zeros(len(b)) for k in ("rterm", "wbuff", "outf",
                                               "outr", "wrr")}

    T = port_pipe.COST_TILE
    tile = np.zeros((len(_TAB), T))

    def stage(g0):
        """The table's columns g0 .. g0 + T - 1 at a tile boundary; a column
        past n is a side group of 0 cycles and no SRAM term."""
        if g0 % T == 0:
            tile[:] = 0.0
            tile[_TAB["side"]] = 1.0
            part = tab[:, g0:g0 + T]
            tile[:, :part.shape[1]] = part

    lat = np.zeros(len(b))
    if not plan.split:
        assert plan.threads == blk
        q = fresh()
        W = port_pipe.COST_WINDOW
        cur = [load(g) for g in range(W)]
        for g0 in range(0, n, W):
            stage(g0)
            nxt = [load(g) for g in range(g0 + W, g0 + 2 * W)]
            for u in range(W):          # whole windows: past n, +0.0
                lat = lat + _price(tile[:, (g0 + u) % T], *cur[u], tbl, q)
            cur = nxt
    else:
        P, step = port_pipe.COST_SPLIT, port_pipe.COST_STEP
        assert plan.threads == blk * P and step % P == 0
        qs = [fresh() for _ in range(P)]
        mine = [[p + P * j for j in range(step // P)] for p in range(P)]
        ahead = port_pipe.COST_AHEAD
        # slot d of thread p: its groups of step k0 + d
        slots = [[[load(d * step + i) for i in mine[p]] for p in range(P)]
                 for d in range(ahead)]
        for k, g0 in enumerate(range(0, n, step)):
            stage(g0)
            d = k % ahead
            terms = np.full((step, len(b)), np.nan)
            written = np.zeros(step, dtype=np.int64)
            for p in range(P):
                for j, i in enumerate(mine[p]):
                    terms[i] = _price(tile[:, (g0 + i) % T], *slots[d][p][j],
                                      tbl, qs[p])
                    written[i] += 1
                    slots[d][p][j] = load(g0 + ahead * step + i)
            assert (written == 1).all()
            for i in range(step):                  # thread (0, c), in order
                lat = lat + terms[i]
        q = qs[0]
        for other in qs[1:]:                       # exact in any order
            q["rterm"] = q["rterm"] + other["rterm"]
            for k in ("wbuff", "outf", "outr", "wrr"):
                q[k] = np.maximum(q[k], other[k])

    st = np.zeros((7, len(b)))
    for r in range(7):
        st[r, ok] = st_flat[r * B + b[ok]]
    dram = q["rterm"] + st[5] + float(tbl.weight_bytes)
    sram = (float(tbl.row_buff) + np.maximum(q["outf"], q["outr"])
            + np.maximum(q["wrr"], st[4]) + st[0]
            + np.maximum(st[1], q["wbuff"]) + st[2] + st[3])
    feasible = (sram <= float(tbl.budget)) & (st[6] > 0)
    infeas = np.where(feasible, 0.0, 1.0)
    primary, secondary = {"latency": (lat, sram), "sram": (sram, lat),
                          "dram": (dram, lat)}[objective]
    keys = np.stack([infeas, primary, secondary,
                     (lo + b).astype(np.float64)], axis=-1)
    keys[~ok] = np.inf                             # pad_key: never wins
    tree = keys.reshape(nb, blk, 4)                # block_argmin_in
    step = blk // 2
    while step:
        a, o = tree[:, :step], tree[:, step:2 * step]
        tree[:, :step] = np.where(_key_less(o, a)[..., None], o, a)
        step //= 2
    return tree[:, 0].T.copy(), loads


def _ref_block_rows(ref_eng, frame, lo, objective):
    """The JAX package's pipeline on masks: its allocator replay and the
    host's batched reductions (the body of ``_run_reference``), then the
    first minimum of every block of ``COST_BLOCK`` candidates."""
    from repro.core.dram import dram_fm_fast_batch
    from repro.core.sram import sram_total_fast_batch
    from repro.core.timing import latency_cycles_fast_batch
    from repro.kernels.alloc_scan import alloc_scan_ref
    res = alloc_scan_ref(ref_eng._at, frame)
    lat = latency_cycles_fast_batch(ref_eng._lt, frame,
                                    res.io.astype(np.float64), ref_eng.hw)
    fm = dram_fm_fast_batch(ref_eng._dt, frame, res.bfm.tolist())
    terms = [(b[0], b[1], b[2], s, w) for b, s, w in zip(
        res.buff.tolist(), res.side_buff.tolist(), res.wrf.tolist())]
    sram, _ = sram_total_fast_batch(ref_eng._st, frame, terms, ref_eng.hw,
                                    bram_memo=ref_eng._bram_memo)
    sram = np.asarray(sram, dtype=np.int64)
    feasible = (sram <= ref_eng.hw.sram_budget) & res.feasible
    dram = np.asarray(fm, dtype=np.float64) + float(ref_eng._dt.weight_bytes)
    keys = ref_pipe._keys_np(objective, lat, dram, sram, feasible)
    idx = np.arange(lo, lo + len(frame), dtype=np.float64)
    blk = port_pipe.COST_BLOCK
    rows = [ref_pipe.argmin_lanes(*(np.asarray(c)[i:i + blk]
                                    for c in (*keys, idx)))
            for i in range(0, len(frame), blk)]
    return np.asarray(rows, dtype=np.float64).T


def _plans(B):
    """Both kernels the plan can pick at B."""
    return [port_pipe.cost_rows_plan(B, split=False),
            port_pipe.cost_rows_plan(B, split=True)]


def _hold_schedule(tbl, frame, res, lo, objective, want, what):
    for plan in _plans(frame.shape[0]):
        rows, loads = cost_schedule(tbl, frame, res.io, res.stats, lo,
                                    objective, plan)
        assert (loads == 1).all(), (what, plan)
        assert np.array_equal(_bits(rows), _bits(want)), (what, plan)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("name", ALL_CNNS)
def test_cost_schedule_on_the_zoo(name, objective):
    """K3's schedule on a small chunk of each zoo net's cut space from an
    odd ``lo`` (two blocks, the second short) == the plain version's rows
    == the JAX package's pipeline, bit for bit, under every plan."""
    ref, _ = both(name)
    pe = _port_engine(name)
    tbl = port_pipe._engine_tables(pe)
    space = port_pipe.SubSpace.make(
        (), tuple(len(r) + 1 for r in ref.runs), "cpu")
    lo = 101
    count = min(300, space.size - lo)
    frame = port_pipe.enum_frames(tbl, space, lo, count)
    res = alloc_scan(pe.alloc_tables(), frame)
    want = port_pipe.cost_rows_torch(tbl, frame, res.io, res.stats, lo,
                                     objective).numpy()
    _hold_schedule(tbl, frame, res, lo, objective, want, name)
    ref_rows = _ref_block_rows(_ref_engine(name), frame.numpy(), lo,
                               objective)
    assert np.array_equal(_bits(ref_rows), _bits(want)), name


@pytest.mark.parametrize("B", [1, 3, 255, 257, 8748])
def test_cost_schedule_ragged_batches(B):
    """resnet152's 160 groups (three tiles of the table), random masks
    from an odd ``lo``: one candidate, a batch below a window of 4, one
    short of a block, one past it, and resnet152's whole space."""
    name = "resnet152"
    pe = _port_engine(name)
    tbl = port_pipe._engine_tables(pe)
    rng = np.random.default_rng(B)
    masks = rng.random((B, tbl.n)) < rng.random((B, 1))
    frame = torch.from_numpy(masks)
    res = alloc_scan(pe.alloc_tables(), frame)
    lo = 12345
    ref_eng = _ref_engine(name)
    for objective in OBJECTIVES:
        want = port_pipe.cost_rows_torch(tbl, frame, res.io, res.stats, lo,
                                         objective).numpy()
        _hold_schedule(tbl, frame, res, lo, objective, want, objective)
        ref_rows = _ref_block_rows(ref_eng, masks, lo, objective)
        assert np.array_equal(_bits(ref_rows), _bits(want)), objective


@pytest.mark.parametrize("B", [1, 3, 255, 256, 257, 8748, 263 * 256,
                               263 * 256 + 1, 4095 * 256, 1 << 20])
@pytest.mark.parametrize("split", [None, False, True])
def test_cost_rows_plan(B, split):
    """One row a block of COST_BLOCK candidates, every candidate in exactly
    one block's slots, the shared memory within a block's 227 KB, and the
    split kernel exactly when the one-thread kernel would leave SMs
    without two blocks."""
    plan = port_pipe.cost_rows_plan(B, sms=132, split=split)
    assert plan.blocks == -(-B // port_pipe.COST_BLOCK)
    slots = (np.arange(plan.blocks)[:, None] * port_pipe.COST_BLOCK
             + np.arange(port_pipe.COST_BLOCK)[None, :]).reshape(-1)
    assert np.array_equal(slots[slots < B], np.arange(B))
    assert plan.smem_bytes <= 227 * 1024
    want = plan.blocks < 2 * 132 if split is None else split
    assert plan.split == want
    assert plan.threads == port_pipe.COST_BLOCK * (
        port_pipe.COST_SPLIT if want else 1)
    assert plan.threads <= 1024


# ------------------------------------------- K2's schedule, on the CPU
def run_digits_schedule(fixed, stride, dim, j0, V):
    """``csrc/search_pipeline.cu::run_digits``: the digits of candidates
    ``j0 + v``, v < V, of one run, for threads starting at ``j0`` (an int64
    array) -> (threads, V).  The first by division; then, for a stride of at
    least V, one step at ``v = stride - j0 % stride``, and for a smaller one
    an odometer."""
    j0 = np.asarray(j0, dtype=np.int64)
    if stride == 0:
        return np.full((len(j0), V), fixed, dtype=np.int64)
    q, rem = np.divmod(j0, stride)
    d = q % dim
    dig = np.empty((len(j0), V), dtype=np.int64)
    if stride >= V:
        first = np.minimum(stride - rem, V)
        d1 = np.where(d + 1 == dim, 0, d + 1)
        v = np.arange(V)[None, :]
        dig[:] = np.where(v < first[:, None], d[:, None], d1[:, None])
    else:
        r, d = rem.copy(), d.copy()
        for v in range(V):
            dig[:, v] = d
            r += 1
            carry = r == stride
            r[carry] = 0
            d[carry] += 1
            d[d == dim] = 0
    return dig


def enum_schedule(digits, run_of, pos_of, dir_neg, lo, B, V=None):
    """``enum_frames_kernel<V>`` as it runs, in numpy: thread t decodes
    candidates ``b0 = t V .. b0 + V - 1`` from ``j0 = lo + b0``, walks the
    groups in order and decodes a run's V digits when the run changes,
    then packs each group's V mask bytes into little-endian 32-bit words
    and stores them at ``g * B + b0``.  Returns the flat lane-major bytes
    [n * B] and how often each byte was stored."""
    V = port_pipe.enum_frames_plan(B) if V is None else V
    assert B % V == 0
    digits = np.asarray(digits, dtype=np.int64)
    n = len(run_of)
    threads = B // V
    b0 = np.arange(threads, dtype=np.int64) * V
    j0 = lo + b0
    out = np.zeros(n * B, dtype=np.uint8)
    stores = np.zeros(n * B, dtype=np.int64)
    last_run, dig = -1, None
    for g in range(n):
        r = int(run_of[g])
        if r != last_run:
            dig = run_digits_schedule(*(int(x) for x in digits[:, r]), j0, V)
            last_run = r
        m = (int(pos_of[g]) >= dig) == bool(dir_neg[g])   # (threads, V)
        words = np.zeros((threads, -(-V // 4)), dtype=np.uint32)
        for v in range(V):
            words[:, v // 4] |= m[:, v].astype(np.uint32) << (8 * (v % 4))
        vec = words.astype("<u4").view(np.uint8)[:, :V]
        at = g * B + b0
        assert (at % V == 0).all()                        # aligned stores
        for v in range(V):
            out[at + v] = vec[:, v]
            stores[at + v] += 1
    return out, stores


def _zoo_subspace(name, target=1 << 20):
    """The zoo net's trailing runs whose product is at most ``target``,
    the leading cuts fixed mid-run (int32 indices for the Pallas kernel)."""
    ref, _ = both(name)
    dims = [len(r) + 1 for r in ref.runs]
    size, q = 1, len(dims)
    while q > 1 and size * dims[q - 1] <= target:
        q -= 1
        size *= dims[q]
    prefix = tuple(len(r) // 2 for r in ref.runs[:q])
    return port_pipe.SubSpace.make(prefix, dims[q:], "cpu")


@functools.lru_cache(maxsize=None)
def _pallas_enum(name, lo, count):
    """The JAX package's ``_enum_kernel`` in interpret mode on
    ``_zoo_subspace(name)``: (count, G) masks from ``lo``."""
    space = _zoo_subspace(name)
    rtbl = ref_pipe._engine_tables(_ref_engine(name))
    block_b = 8
    nb = -(-count // block_b)
    nr = len(space.prefix) + len(space.dims)
    call = ref_pipe._build_enum_call(nb, block_b, rtbl["lanes"], nr,
                                     len(space.prefix), space.strides,
                                     space.dims, True)
    out = call(np.asarray([lo], dtype=np.int32),
               np.asarray(space.prefix, dtype=np.int32),
               rtbl["runof_row"], rtbl["pos_row"], rtbl["dirneg_row"])
    return np.asarray(out)[:count, :rtbl["n"]].astype(bool)


# a batch that takes each V of the rule
ENUM_B = {16: 48, 4: 36, 1: 35}


@pytest.mark.parametrize("V", [16, 4, 1])
@pytest.mark.parametrize("name", ALL_CNNS)
def test_enum_schedule_on_the_zoo(name, V):
    """K2's schedule at each V == the plain version == the JAX package's
    enumeration kernel in interpret mode, on each zoo net's sub-space from
    an odd ``lo``; every byte stored once."""
    space = _zoo_subspace(name)
    tbl = port_pipe._engine_tables(_port_engine(name))
    B = ENUM_B[V]
    assert port_pipe.enum_frames_plan(B) == V
    lo = space.size // 3 | 1
    assert lo + max(ENUM_B.values()) <= space.size
    flat, stores = enum_schedule(space.digits.numpy(), tbl.run_of32.numpy(),
                                 tbl.pos_of32.numpy(), tbl.dir_neg8.numpy(),
                                 lo, B)
    assert (stores == 1).all()
    got = flat.reshape(tbl.n, B).T.astype(bool)
    want = port_pipe.enum_frames_torch(tbl, space, lo, B).numpy()
    assert np.array_equal(got, want), name
    assert np.array_equal(got, _pallas_enum(name, lo, max(ENUM_B.values()))
                          [:B]), name
    # the space's strides reach both branches of run_digits
    assert V == 1 or min(space.strides) < V <= max(space.strides)


@settings(max_examples=150, deadline=None)
@given(dims=st.lists(st.integers(1, 300), min_size=1, max_size=6),
       npfx=st.integers(0, 2),
       lo=st.one_of(st.integers(0, 1 << 40),
                    st.integers((1 << 32) - 40, (1 << 32) + 40)),
       threads=st.integers(1, 5), V=st.sampled_from([1, 4, 16]))
def test_run_digits_schedule_is_the_mixed_radix_digit(dims, npfx, lo,
                                                      threads, V):
    """The stepped digits equal ``(j // stride) % dim`` for every run and
    candidate, strides below V and ``lo`` across 2^32 included."""
    space = port_pipe.SubSpace.make((0,) * npfx, dims, "cpu")
    j0 = lo + np.arange(threads, dtype=np.int64) * V
    j = (j0[:, None] + np.arange(V)[None, :]).astype(object)
    for r, (fixed, stride, dim) in enumerate(space.digits.numpy().T):
        got = run_digits_schedule(int(fixed), int(stride), int(dim), j0, V)
        if stride == 0:
            assert (got == fixed).all()
            continue
        want = (j // int(stride)) % int(dim)       # Python integers
        assert np.array_equal(got.astype(object), want), (r, stride, dim)


@pytest.mark.parametrize("B", [1, 2, 3, 4, 12, 16, 35, 36, 48, 8748,
                               622592, 1 << 20, (1 << 20) - 1])
def test_enum_frames_plan(B):
    """V is 16 when it divides B, else 4, else 1: yolov2's chunk and its
    last chunk take 16, resnet152's 8,748 takes 4; B / V threads cover
    every candidate once with V-aligned stores."""
    V = port_pipe.enum_frames_plan(B)
    assert V == (16 if B % 16 == 0 else 4 if B % 4 == 0 else 1)
    assert V in port_pipe.ENUM_VECTORS and B % V == 0
    b0 = np.arange(B // V) * V
    covered = (b0[:, None] + np.arange(V)[None, :]).reshape(-1)
    assert np.array_equal(covered, np.arange(B))
    if B in (622592, 1 << 20):
        assert V == 16
    if B == 8748:
        assert V == 4


# ----------------------------------- K4's reduction, alone and in K3
def _warp_argmin(keys):
    """``warp_argmin`` over (..., 32, 4): shuffles down by 16, 8, 4, 2, 1;
    a lane past 31 reads its own key."""
    keys = keys.copy()
    for off in (16, 8, 4, 2, 1):
        other = keys.copy()
        other[..., :32 - off, :] = keys[..., off:, :]
        less = _key_less(other, keys)
        keys = np.where(less[..., None], other, keys)
    return keys


def rows_argmin_schedule(rows, nt, r):
    """The kernels' reductions of rows in numpy: with ``R`` 16,
    ``rows_argmin<NT>`` (the standalone kernel); with ``R`` 1,
    ``chunk_winner<NT>`` (the cost kernels' block 0, once every row is
    posted).  Thread t loads keys
    ``i0 + t + k NT`` (k < R; pads past L) of each pass of ``NT R`` keys,
    then compares them in order; the block reduces by warp shuffles and one
    warp over the warps' winners.  Returns thread 0's key and how often
    each key was loaded."""
    L = rows.shape[1]
    keys = np.asarray(rows, dtype=np.float64).T
    best = np.full((nt, 4), np.inf)
    loads = np.zeros(L, dtype=np.int64)
    t = np.arange(nt)
    for i0 in range(0, L, nt * r):
        batch = []
        for k in range(r):
            i = i0 + t + k * nt
            ok = i < L
            key = np.full((nt, 4), np.inf)
            key[ok] = keys[i[ok]]
            loads[i[ok]] += 1
            batch.append(key)
        for key in batch:
            best = np.where(_key_less(key, best)[:, None], key, best)
    warps = _warp_argmin(best.reshape(nt // 32, 32, 4))[:, 0]
    lead = np.full((32, 4), np.inf)
    lead[:len(warps)] = warps
    return _warp_argmin(lead)[0], loads


def _awkward_rows(rng, L):
    """Block rows as the cost stage leaves them, with the keys that test a
    reduction's order: pad rows (a last block with no candidate in range),
    infeasible rows, ties on primary and secondary, and +0.0 / -0.0
    primaries; the idx of real rows unique."""
    infeas = rng.choice([0.0, 1.0], size=L)
    primary = rng.choice([0.0, -0.0, 3.0, 3.0, 1e9], size=L)
    secondary = rng.choice([2.0, 5.0, 5.0], size=L)
    idx = rng.permutation(50 * L)[:L].astype(np.float64)
    rows = np.stack([infeas, primary, secondary, idx])
    rows[:, rng.random(L) < 0.2] = np.inf
    return rows


@pytest.mark.parametrize("L", [1, 2, 35, 257, 4096, 9000])
def test_rows_argmin_is_order_free(L):
    """The fused reduction (``NT`` 256 and 1,024 threads, one key at a
    time) and the standalone kernel's (256, ``R`` 16) ==
    ``argmin_rows_torch`` == the host's lexsort, bit for bit, for any
    permutation of the rows: pad rows, all-infeasible rows and +-0.0
    primaries included."""
    rng = np.random.default_rng(L)
    for case in range(4):
        rows = _awkward_rows(rng, L)
        if case == 1:
            rows[0] = np.where(np.isinf(rows[0]), np.inf, 1.0)  # all infeas.
        if case == 2:
            rows[:, :] = np.inf                          # all pads
        want = port_pipe.argmin_rows_torch(torch.from_numpy(rows)).numpy()
        real = ~np.isinf(rows[3])
        if real.any():
            host = _host_winner(*(c[real] for c in rows))
            assert tuple(want[:3]) == host[:3] and int(want[3]) == host[3]
            j = int(np.flatnonzero(rows[3] == want[3])[0])
            assert np.array_equal(_bits(want), _bits(rows[:, j]))
        for perm in range(3):
            order = rng.permutation(L) if perm else np.arange(L)
            shuffled = rows[:, order]
            plain = port_pipe.argmin_rows_torch(torch.from_numpy(shuffled))
            assert np.array_equal(_bits(plain.numpy()), _bits(want))
            for nt, r in ((256, 1), (1024, 1), (256, 16)):
                got, loads = rows_argmin_schedule(shuffled, nt, r)
                assert (loads == 1).all()
                assert np.array_equal(_bits(got), _bits(want)), (nt, r)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_chunk_winners_match_run_reference_chunk_by_chunk(objective):
    """Each chunk's winner, as the cost stage hands it over (``winner=``),
    == the reference's ``_run_reference`` on the same chunk: chunks of the
    first free run's stride are the sub-spaces with that run's cut fixed."""
    name = "resnet50"
    ref, _ = both(name)
    re_ = _ref_engine(name)
    rtbl = ref_pipe._engine_tables(re_)
    pe = _port_engine(name)
    prefix = (5,)
    dims = tuple(len(r) + 1 for r in ref.runs[1:])
    space = port_pipe.SubSpace.make(prefix, dims, "cpu")
    chunk = space.strides[0]
    rows = port_pipe.run_chunks(pe, space, objective, chunk, "torch")
    assert rows.shape == (dims[0], 4)
    sub = port_pipe.SubSpace.make(prefix + (0,), dims[1:], "cpu")
    for k in range(dims[0]):
        want = ref_pipe._run_reference(re_, rtbl, prefix + (k,), dims[1:],
                                       sub.strides, sub.size, 4096,
                                       objective)
        want = (*want[:3], want[3] + k * chunk)
        assert np.array_equal(_bits(rows[k].numpy()), _bits(want)), k
    # and the same winner straight from cost_rows, the block rows beside it
    tbl = port_pipe._engine_tables(pe)
    frame = port_pipe.enum_frames(tbl, space, chunk, chunk)
    res = alloc_scan(pe.alloc_tables(), frame)
    winner = torch.empty(4, dtype=torch.float64)
    blocks = port_pipe.cost_rows(tbl, frame, res.io, res.stats, chunk,
                                 objective, winner=winner)
    assert torch.equal(winner, port_pipe.argmin_rows_torch(blocks))
    assert torch.equal(winner, rows[1])


def test_run_chunks_takes_no_argmin_launch(monkeypatch):
    """The device loop's winners come from the cost stage: it never calls
    the standalone argmin."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("run_chunks called argmin_rows")

    monkeypatch.setattr(port_pipe, "argmin_rows", refuse)
    monkeypatch.setattr(port_pipe, "argmin_rows_cuda", refuse)
    pe = _port_engine("vgg16-conv")
    space = port_pipe.SubSpace.make(
        (), tuple(len(r) + 1 for r in pe.runs), "cpu")
    rows = port_pipe.run_chunks(pe, space, "latency", 300, "torch")
    assert rows.shape == (-(-space.size // 300), 4)
    assert (rows[:, 0] <= 1.0).all()


# ------------------------------------------------------- K1's shared prefix
# zoo nets and the benchmark's two configurations (``bench/configs/``)
PREFIX_NETS = ("bench:yolov2-416", "bench:yolov3-416", "resnet50", "yolov2")


@functools.lru_cache(maxsize=None)
def _prefix_engine(net):
    return torch_parity.port_engine_of(net)


def prefix_space(net, fixed):
    """The net's whole cut space, or with its first two runs fixed
    mid-run."""
    pe = _prefix_engine(net)
    dims = [len(r) + 1 for r in pe.runs]
    npfx = 2 if fixed else 0
    return port_pipe.SubSpace.make(
        tuple(len(r) // 2 for r in pe.runs[:npfx]), dims[npfx:], "cpu")


def prefix_chunks(space, chunk, picks=4):
    """``(lo, count)`` of the first chunk, the last (ragged where the space
    is not a multiple of ``chunk``) and ``picks - 2`` between."""
    n = -(-space.size // chunk)
    ks = sorted({round(i * (n - 1) / (picks - 1)) for i in range(picks)})
    return [(k * chunk, min(chunk, space.size - k * chunk)) for k in ks]


def varying_rows(tbl, space, lo, count, block=1 << 16):
    """(G,) bool: the frame rows that differ somewhere in ``[lo, lo +
    count)`` from the first candidate's, from the plain enumeration's masks
    a block at a time."""
    first = port_pipe.enum_frames_torch(tbl, space, lo, 1)[0]
    vary = torch.zeros(tbl.n, dtype=torch.bool)
    for a in range(lo, lo + count, block):
        masks = port_pipe.enum_frames_torch(tbl, space, a,
                                            min(block, lo + count - a))
        vary |= (masks != first).any(dim=0)
    return vary


@pytest.mark.parametrize("chunk", [1024, 1 << 20])
@pytest.mark.parametrize("fixed", [False, True], ids=["whole", "fixed"])
@pytest.mark.parametrize("net", PREFIX_NETS)
def test_shared_prefix_against_brute_force(net, fixed, chunk):
    """``shared_prefix``'s ``g0`` against every candidate's masks: the
    frame rows before it are constant over the chunk, and unless ``g0`` is
    G a row of ``g0``'s run is not, so no later start of a run would do.
    (Row ``g0`` itself may be constant: yolov2-416's sixth chunk of 2^20
    sees only cuts 1 and 2 of its first run, which frame its first group
    either way.)  On the first, the last and two chunks between, whole
    spaces and sub-spaces with fixed leading cuts."""
    pe = _prefix_engine(net)
    tbl = port_pipe._engine_tables(pe)
    space = prefix_space(net, fixed)
    for lo, count in prefix_chunks(space, chunk):
        g0 = port_pipe.shared_prefix(space, pe._run_of, lo, count)
        vary = varying_rows(tbl, space, lo, count)
        assert 0 <= g0 <= tbl.n
        assert not vary[:g0].any(), (net, lo, count, g0)
        if g0 < tbl.n:
            run = pe._run_of == pe._run_of[g0]
            assert g0 == 0 or pe._run_of[g0 - 1] != pe._run_of[g0]
            assert vary[torch.from_numpy(run)].any(), (net, lo, count, g0)


@pytest.mark.parametrize("chunk, want", [(1 << 20, [57] * 128),
                                         (1024, [68] * 131072)])
def test_shared_prefix_of_the_yolov3_cell(chunk, want):
    """yolov3-416's 23 runs: at a chunk of 2^20 every chunk shares groups
    0-56 (runs 0-4, strides >= 2^20) of 79 -- 72.15 % of the group steps --
    and at the default batch of 1,024 groups 0-67; yolov2-416's 8 chunks
    of 2^20 share 3, 2, 0, 2, 3, 0, 2 and 3 of 26."""
    pe = _prefix_engine("bench:yolov3-416")
    space = prefix_space("bench:yolov3-416", False)
    got = [port_pipe.shared_prefix(space, pe._run_of, lo, min(chunk,
                                                              space.size - lo))
           for lo in range(0, space.size, chunk)]
    assert got == want
    pe = _prefix_engine("bench:yolov2-416")
    space = prefix_space("bench:yolov2-416", False)
    assert [port_pipe.shared_prefix(space, pe._run_of, lo,
                                    min(1 << 20, space.size - lo))
            for lo in range(0, space.size, 1 << 20)] == [3, 2, 0, 2, 3, 0,
                                                         2, 3]


def test_shared_prefix_edges():
    """One candidate shares every group; a range that crosses the first
    free run's stride shares only the fixed runs' groups."""
    pe = _prefix_engine("resnet50")
    space = prefix_space("resnet50", True)
    n = len(pe._run_of)
    assert port_pipe.shared_prefix(space, pe._run_of, 5, 1) == n
    first_free = int(np.argmax(pe._run_of >= len(space.prefix)))
    assert first_free > 0
    assert port_pipe.shared_prefix(space, pe._run_of, 0,
                                   space.size) == first_free


def test_run_chunks_hands_each_chunk_its_state_row(monkeypatch):
    """Under the kernels the device loop makes every chunk's state row in
    one prefix launch and hands row k to chunk k's replay; while a profiler
    records it counts each chunk's ``g0`` times its candidates in
    ``alloc.shared_prefix_steps`` (and its side steps past ``g0``, none
    on yolov2, in ``alloc.side_steps``), and nothing otherwise.  The plain
    variant makes no rows.  (The kernels are stood in for by the plain
    versions: this host has no card.)"""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.utils import tracing

    pe = _prefix_engine("bench:yolov2-416")
    fixed = len(pe.runs) - 5
    space = port_pipe.SubSpace.make(
        tuple(len(r) // 2 for r in pe.runs[:fixed]),
        [len(r) + 1 for r in pe.runs[fixed:]], "cpu")
    chunk = 40
    los = range(0, space.size, chunk)
    prefix_calls, states = [], []

    def prefix(at, tbl, sp, c):
        prefix_calls.append(c)
        rows = torch.arange(len(los), dtype=torch.int32)[:, None]
        return rows.expand(len(los), 3).contiguous()

    def scan(at, frame, backend=None, skip=None, state=None):
        states.append(None if state is None else int(state[0]))
        return alloc_scan(at, frame, backend="torch")

    monkeypatch.setattr(port_pipe, "alloc_prefix_cuda", prefix)
    monkeypatch.setattr(port_pipe, "alloc_scan", scan)
    monkeypatch.setattr(port_pipe, "enum_frames",
                        lambda *a, backend=None: port_pipe.enum_frames_torch(
                            *a))
    monkeypatch.setattr(port_pipe, "cost_rows",
                        lambda *a, backend=None, winner=None:
                        port_pipe.cost_rows_torch(*a, winner=winner))
    want = sum(port_pipe.shared_prefix(space, pe._run_of, lo,
                                       min(chunk, space.size - lo))
               * min(chunk, space.size - lo) for lo in los)
    assert want > 0
    tracing.reset()
    plain = port_pipe.run_chunks(pe, space, "latency", chunk, "torch")
    assert prefix_calls == [] and set(states) == {None}
    states.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        rows = port_pipe.run_chunks(pe, space, "latency", chunk, "cuda")
    assert prefix_calls == [chunk] and states == list(range(len(los)))
    # yolov2 has no SE side path: its side-step counter reads 0
    assert tracing.counters() == {"alloc.shared_prefix_steps": want,
                                  "alloc.side_steps": 0}
    assert torch.equal(rows, plain)
    tracing.reset()
    port_pipe.run_chunks(pe, space, "latency", chunk, "cuda")
    assert tracing.counters() == {}
