"""The staged float32 scorer (kernel K5's plain version) and
``backend="pallas"`` of the PyTorch port against the JAX package, on the CPU.

Tolerances:

* ``score_batch_torch`` against the reference's float32 numpy reference
  ``score_batch_ref`` and its Pallas kernel in interpret mode:
  ``allclose(rtol=1e-5, atol=1e-2)``, the tolerance of the reference's own
  ``tests/test_score_batch.py``.  The sums are taken in another order (the
  port: left to right in gid order; numpy: pairwise; interpret mode: XLA's
  reduction), so they may differ by a few float32 ulps.
* ``score_schedule`` (the split kernel's algorithm in numpy) against
  ``score_batch_torch``: bit for bit; against the reference, as above.
* the engine's ``backend="pallas"`` against its numpy backend: within 1e-4
  relative, as the reference's test holds its own pallas backend.
* whole compiles: cuts, ``evaluated``, ``path``, every integer metric and
  the instruction words equal the reference's ``backend="pallas"`` compile
  (the winner is re-priced through the exact oracle on both sides).  One
  net, efficientnet-b1, differs through the summation order alone (R6 in
  ROADMAP queue 3): there the port is held against the reference with its
  scorer's sums taken in the port's order, and the disagreement is pinned.
"""
import numpy as np
import pytest
import torch

import repro.core.compiler as ref_compiler
import repro.core.options as ref_options
import repro.kernels.score_batch as ref_sb

import repro_torch.core.compiler as port_compiler
import repro_torch.core.options as port_options
import repro_torch.kernels.score_batch as port_sb
from repro_torch.kernels.alloc_scan import lane_major

from torch_parity import (ALL_CNNS, INT_METRICS, assert_plans_equal, both,
                          mixed_tuples, random_masks)
import torch_parity

torch_parity.one_thread()

RTOL, ATOL = 1e-5, 1e-2
# nets whose cut space exceeds this limit take the descent path
LIMITS = {"yolov2": 100_000}
# R6: the reference's interpret-mode float32 sum and the port's sequential
# one round efficientnet-b1's latency differently, and its descent drifts
R6_NET = "efficientnet-b1"


def _hw():
    _, port = both("resnet50")
    return port.hw


def _batch_inputs(name, n_tuples=32):
    """Frame masks and io rows of reachable candidates, from the
    reference's journal replay (the inputs of its own kernel test)."""
    ref, _ = both(name)
    engine = ref.engine()
    tuples = mixed_tuples(ref.runs, n_prefix=n_tuples // 2,
                          n_random=n_tuples // 2, seed=3)
    n = len(ref.gg.groups)
    frame = np.zeros((len(tuples), n), dtype=bool)
    io = np.zeros((len(tuples), n))
    for j, cuts in enumerate(tuples):
        engine._replay(cuts)
        frame[j] = engine._frame
        io[j] = np.asarray(engine._x_io, dtype=np.float64)
    return engine, frame, io


def _port_tables(name):
    _, port = both(name)
    return port.engine(device="cpu").score_tables()


@pytest.mark.parametrize("name", ["resnet50", "yolov2", "efficientnet-b1"])
def test_tables_equal_reference(name):
    ref_engine, _, _ = _batch_inputs(name, n_tuples=2)
    want = ref_sb.pack_tables(ref_engine._lt, ref_engine._dt, ref_engine._st)
    got = _port_tables(name)
    assert got.g == want["g"] and got.rows.dtype == torch.float32
    for i, key in enumerate(port_sb.TABLE_KEYS):
        assert np.array_equal(got.rows[i].numpy(), want[key][0, :want["g"]])


@pytest.mark.parametrize("name", ["resnet50", "yolov2", "efficientnet-b1"])
def test_score_batch_torch_matches_reference(name):
    ref_engine, frame, io = _batch_inputs(name)
    tables = ref_sb.pack_tables(ref_engine._lt, ref_engine._dt,
                                ref_engine._st)
    hw = _hw()
    bpc, ovh = hw.dram_bytes_per_cycle, hw.group_overhead_cycles
    want = ref_sb.score_batch_ref(tables, frame, io, bpc, ovh)
    ker = ref_sb.score_batch_pallas(tables, frame, io, bpc, ovh,
                                    interpret=True)
    got = port_sb.score_batch_torch(_port_tables(name),
                                    torch.from_numpy(frame),
                                    torch.from_numpy(io), bpc, ovh).numpy()
    assert got.shape == want.shape == (len(frame), port_sb.N_STATS)
    assert got.dtype == np.float32
    for other in (want, ker):
        assert np.allclose(got, other, rtol=RTOL, atol=ATOL), (
            name, np.max(np.abs(got - other)))
    # the four maxima and the integer-valued DRAM term are exact
    assert np.array_equal(got[:, 2:], want[:, 2:])


@pytest.mark.parametrize("io_dtype", [torch.int32, torch.int64,
                                      torch.float32, torch.float64])
def test_score_batch_random_masks_and_io_types(io_dtype):
    """Masks no cut tuple reaches, and io in every type the engine hands
    over (K1's int32, the plain replay's int64, the journal's float64):
    each is rounded once to float32 and scored like the reference."""
    name = "efficientnet-b1"
    ref_engine, _, _ = _batch_inputs(name, n_tuples=2)
    tables = ref_sb.pack_tables(ref_engine._lt, ref_engine._dt,
                                ref_engine._st)
    g = tables["g"]
    rng = np.random.default_rng(11)
    frame = random_masks(g, 40, seed=5)
    io = rng.integers(0, 1 << 22, size=(40, g)).astype(np.int64)
    hw = _hw()
    bpc, ovh = hw.dram_bytes_per_cycle, hw.group_overhead_cycles
    want = ref_sb.score_batch_ref(tables, frame, io.astype(np.float64),
                                  bpc, ovh)
    got = port_sb.score_batch(_port_tables(name), torch.from_numpy(frame),
                              torch.from_numpy(io).to(io_dtype), bpc, ovh)
    assert np.allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got.numpy()[:, 2:], want[:, 2:])


def test_score_batch_plain_sum_is_sequential():
    """The plain version's sums are left to right in gid order: a column
    of 1.0 after 2**24 is absorbed every time (a pairwise or tree sum would
    keep some of them)."""
    t = port_sb.ScoreTables(g=5, rows=torch.zeros((9, 5)))
    t.rows[port_sb.TABLE_KEYS.index("row")] = torch.tensor(
        [2.0 ** 24, 1.0, 1.0, 1.0, 1.0])
    frame = torch.zeros((1, 5), dtype=torch.bool)
    out = port_sb.score_batch_torch(t, frame, torch.zeros((1, 5)), 1.0, 0.0)
    assert out[0, 0].item() == 2.0 ** 24


def test_score_stats_rounds_half_to_even():
    """The int stats are rounded like the reference's ``np.rint``."""
    t = port_sb.ScoreTables(g=2, rows=torch.zeros((9, 2)))
    k = port_sb.TABLE_KEYS.index
    t.rows[k("row_fm")] = torch.tensor([0.5, 2.0])
    t.rows[k("compute")] = 1.0
    t.rows[k("weight")] = torch.tensor([2.5, 1.5])
    t.rows[k("out_row")] = torch.tensor([3.5, 0.0])
    t.rows[k("wr_row")] = torch.tensor([0.0, 4.5])
    frame = np.array([[False, False], [False, True]])
    st = port_sb.score_stats(t, frame, np.zeros((2, 2)), _hw())
    want_rfm = np.rint(np.array([2.5, 0.5], np.float32)).astype(np.int64)
    assert st.row_fm.tolist() == want_rfm.tolist() == [2, 0]
    assert [m.tolist() for m in st.maxima] == [[2, 2], [0, 0], [4, 4],
                                               [4, 0]]
    assert st.latency.dtype == np.float64


def test_score_batch_refuses_what_it_does_not_take():
    t = _port_tables("resnet50")
    frame = torch.zeros((3, t.g), dtype=torch.bool)
    with pytest.raises(ValueError, match="frame must be"):
        port_sb.score_batch_torch(t, frame[:, :-1], torch.zeros((3, t.g - 1)),
                                  1.0, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        port_sb.score_batch_cuda(t, frame, torch.zeros((3, t.g)), 1.0, 0.0)
    with pytest.raises(ValueError, match="backend"):
        port_sb.score_batch(t, frame, torch.zeros((3, t.g)), 1.0, 0.0,
                            backend="pallas")


# --------------------------------------------- the kernels' launch and plan
# (B, sms, split, blocks): the rule takes the split kernel while the
# thread-a-candidate kernel would fill fewer than two blocks an SM, so at 132
# SMs up to B 263 * 256 = 67,328 and at 4 SMs up to B 7 * 256 = 1,792
@pytest.mark.parametrize("B,sms,split,blocks", [
    (1, 132, True, 1), (8, 132, True, 2), (1024, 132, True, 256),
    (67_328, 132, True, 16_832), (67_329, 132, False, 264),
    (1_048_576, 132, False, 4096),
    (1, 4, True, 1), (8, 4, True, 2), (1024, 4, True, 256),
    (1792, 4, True, 448), (1793, 4, False, 8), (1_048_576, 4, False, 4096)])
def test_score_batch_plan(B, sms, split, blocks):
    plan = port_sb.score_batch_plan(B, 160, sms)
    assert (plan.split, plan.blocks) == (split, blocks)
    assert plan.variant == ("split" if split else "thread")
    assert plan.variant in port_sb.VARIANTS
    if split:
        # a warp a candidate; all 160 groups' loads in flight at once
        assert plan.threads == 32 * port_sb.SPLIT_WARPS
        assert plan.round_trips == 1
    else:
        assert plan.threads == port_sb.SCORE_BLOCK
        assert plan.round_trips == 160
    forced = port_sb.score_batch_plan(B, 160, sms, split=not split)
    assert forced.split is (not split)


@pytest.mark.parametrize("G,trips", [(0, 0), (1, 1), (160, 1), (256, 1),
                                     (257, 2), (600, 3)])
def test_score_batch_plan_round_trips(G, trips):
    """The split kernel waits for one round trip a ``SPLIT_PASS`` groups."""
    assert port_sb.score_batch_plan(8, G).round_trips == trips


@pytest.mark.parametrize("split", [None, False, True])
def test_score_batch_cuda_refuses_cpu_tensors(split):
    t = _port_tables("resnet50")
    frame = torch.zeros((3, t.g), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        port_sb.score_batch_cuda(t, frame, torch.zeros((3, t.g)), 1.0, 0.0,
                                 split=split)


def _flat(x: torch.Tensor):
    """A dense tensor's storage in memory order and its element strides,
    as the kernel's pointer arithmetic sees them."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    return torch.as_strided(x, (x.numel(),), (1,)).numpy(), x.stride()


def score_schedule(t, frame, io, bpc, overhead):
    """``csrc/score_batch.cu``'s split kernel as it runs, in numpy.

    Warp ``w`` of block ``blk`` owns candidate ``blk * SPLIT_WARPS + w``.
    For each pass of ``SPLIT_PASS`` groups from ``g0``, lane ``l`` loads the
    mask byte and io word of groups ``g0 + l + 32 j`` (``j`` < SPLIT_PASS /
    32) from the flat storage through the tensors' strides (nothing past B
    or G), the block's ``32 * SPLIT_WARPS`` threads stage the pass's table
    columns (a column left unstaged is NaN and would show), each lane prices
    its groups into a term buffer (unwritten entries NaN) and keeps its own
    four maxima, and lanes 0 and 1 add the latency and row-mode terms to
    their sums, left to right in gid order.  Then the maxima go through the
    xor-shuffle tree across the 32 lanes.  Returns the (B, 6) float32 stats
    and how often each (group, candidate) element was loaded."""
    f32 = np.float32
    W, PASS = port_sb.SPLIT_WARPS, port_sb.SPLIT_PASS
    PER, threads = PASS // 32, 32 * W
    B, G = frame.shape
    fr_flat, (fsb, fsg) = _flat(frame)
    io_flat, (isb, isg) = _flat(io)
    rows = t.rows.numpy()
    k = {key: i for i, key in enumerate(port_sb.TABLE_KEYS)}
    b = np.arange(-(-B // W) * W)
    ok = b < B
    loads = np.zeros((G, B), dtype=np.int64)
    sums = np.zeros((2, len(b)), f32)          # lanes 0 and 1
    mx = np.zeros((4, 32, len(b)), f32)        # wbuff, outf, outr, wrr
    bpc32, ovh32 = f32(bpc), f32(overhead)
    for g0 in range(0, G, PASS):
        n = min(PASS, G - g0)
        fr = np.zeros((32, PER, len(b)), bool)
        iw = np.zeros((32, PER, len(b)), f32)
        for lane in range(32):
            for j in range(PER):
                g = g0 + lane + 32 * j
                if g < G:
                    fr[lane, j, ok] = fr_flat[b[ok] * fsb + g * fsg] != 0
                    iw[lane, j, ok] = io_flat[b[ok] * isb + g * isg]
                    loads[g] += 1
        tabs = np.full((len(k), PASS), np.nan, f32)
        for h in range(PASS // threads):
            g = np.arange(threads) + h * threads
            g = g[g < n]
            tabs[:, g] = rows[:, g0 + g]
        terms = np.full((2, PASS, len(b)), np.nan, f32)
        for lane in range(32):
            for j in range(PER):
                i = lane + 32 * j
                if i >= n:
                    continue
                f = fr[lane, j]
                col = tabs[:, i]
                mem = (col[k["weight"]] + iw[lane, j]) / bpc32
                frame_lat = np.maximum(col[k["comp"]], mem) + ovh32
                terms[0, i] = (np.full(len(b), col[k["comp"]])
                               if col[k["side"]] > 0
                               else np.where(f, frame_lat, col[k["row"]]))
                terms[1, i] = np.where(f, f32(0), col[k["row_fm"]])
                if col[k["compute"]] > 0:
                    for r, key, on in ((0, "weight", ~f), (1, "out_frame", f),
                                       (2, "out_row", ~f),
                                       (3, "wr_row", ~f)):
                        mx[r, lane] = np.where(
                            on, np.maximum(mx[r, lane], col[k[key]]),
                            mx[r, lane])
        for i in range(n):                     # det: gid order
            sums = sums + terms[:, i]
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        mx = np.maximum(mx, mx[:, lanes ^ off])
    out = np.concatenate([sums, mx[:, 0]]).T[:B]
    assert out.dtype == f32
    return out, loads


_SCHEDULE_INPUTS: dict = {}


def _schedule_inputs(name, B):
    """Reachable candidates of ``name``: the port's masks and K1's io (the
    plain replay's, as int32), with the reference's float32 numpy scorer
    and its Pallas kernel in interpret mode on the same inputs."""
    key = (name, B)
    if key not in _SCHEDULE_INPUTS:
        ref, port = both(name)
        engine = port.engine(engine="device", device="cpu")
        tuples = mixed_tuples(port.runs, n_prefix=B // 2 + 1,
                              n_random=B // 2 + 1, seed=5)[:B]
        frame = engine._frame_matrix(tuples)
        _, res = engine._device_replay(frame)
        io = res.io.to(torch.int32).numpy()
        ref_engine = ref.engine()
        tables = ref_sb.pack_tables(ref_engine._lt, ref_engine._dt,
                                    ref_engine._st)
        hw = _hw()
        args = (hw.dram_bytes_per_cycle, hw.group_overhead_cycles)
        io64 = io.astype(np.float64)
        _SCHEDULE_INPUTS[key] = (
            engine.score_tables(), frame, io, args,
            ref_sb.score_batch_ref(tables, frame, io64, *args),
            ref_sb.score_batch_pallas(tables, frame, io64, *args,
                                      interpret=True))
    return _SCHEDULE_INPUTS[key]


# how the scorer is handed its (B, G) inputs: "row-major", the journal
# replay's host matrices uploaded as they lie (float32 io); "lane-major",
# the device replay's masks (the engine's mask matrix is column-major) and
# K1's int32 io, as the pipeline's; "mixed", row-major masks beside K1's io
LAYOUTS = ("row-major", "lane-major", "mixed")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B", [1, 3, 8, 1024])
@pytest.mark.parametrize("name", ALL_CNNS)
def test_score_schedule_equals_plain_and_reference(name, B, layout):
    """The split kernel's algorithm is the plain version bit for bit, on
    every zoo net at the batches the main path gives it, from inputs in
    each layout; and it agrees with the reference's float32 scorer and its
    TPU kernel (interpret mode) as the plain version does."""
    t, frame, io, args, want, ker = _schedule_inputs(name, B)
    fr_t = torch.from_numpy(np.ascontiguousarray(frame))
    io_t = torch.from_numpy(np.ascontiguousarray(io))
    if layout == "row-major":
        io_t = io_t.to(torch.float32)
    else:
        io_t = lane_major(io_t)
    if layout == "lane-major":
        fr_t = lane_major(fr_t)
    if B > 1:                  # (a single row is both layouts at once)
        row, lane = (t.g, 1), (1, B)
        assert (fr_t.stride(), io_t.stride()) == {
            "row-major": (row, row), "lane-major": (lane, lane),
            "mixed": (row, lane)}[layout]
    got, loads = score_schedule(t, fr_t, io_t, *args)
    plain = port_sb.score_batch_torch(t, fr_t, io_t, *args).numpy()
    assert got.shape == (B, port_sb.N_STATS)
    assert np.array_equal(got.view(np.int32), plain.view(np.int32)), (
        name, B, layout, np.max(np.abs(got - plain)))
    assert (loads == 1).all()
    for other in (want, ker):
        assert np.allclose(got, other, rtol=RTOL, atol=ATOL), (
            name, np.max(np.abs(got - other)))
    assert np.array_equal(got[:, 2:], want[:, 2:])


@pytest.mark.parametrize("G", [1, 31, 255, 256, 257, 600])
def test_score_schedule_across_passes(G):
    """Tables wider than one pass (the zoo's G is at most 160): the sums
    carry from pass to pass in gid order, and the staged columns, lanes
    and maxima of a ragged last pass stay right; equal to the plain
    version bit for bit."""
    rng = np.random.default_rng(G)
    B = 5
    rows = rng.integers(0, 1 << 20, size=(9, G)).astype(np.float32)
    rows[port_sb.TABLE_KEYS.index("side")] = rng.random(G) < 0.2
    rows[port_sb.TABLE_KEYS.index("compute")] = rng.random(G) < 0.7
    t = port_sb.ScoreTables(g=G, rows=torch.from_numpy(rows))
    frame = torch.from_numpy(random_masks(G, B, seed=G))
    io = torch.from_numpy(rng.integers(0, 1 << 22, size=(B, G),
                                       dtype=np.int32))
    for fr_t, io_t in ((frame, io), (lane_major(frame), lane_major(io))):
        got, loads = score_schedule(t, fr_t, io_t, 8.0, 3.0)
        plain = port_sb.score_batch_torch(t, fr_t, io_t, 8.0, 3.0).numpy()
        assert np.array_equal(got.view(np.int32), plain.view(np.int32))
        assert (loads == 1).all()


# ------------------------------------------------------- the engine backend
@pytest.mark.parametrize("engine", ["journal", "device"])
def test_pallas_backend_tracks_numpy_backend(engine):
    """backend='pallas' is float32-staged, not oracle-exact: its metrics
    agree with the numpy backend to float32 relative precision and its
    bookkeeping (evaluations, memo) is unchanged."""
    _, port = both("resnet50")
    tuples = mixed_tuples(port.runs, n_prefix=16, n_random=16)
    a = port.engine(engine=engine, device="cpu").score_batch(
        tuples, memoize=False)
    pe = port.engine(engine=engine, device="cpu", backend="pallas")
    b = pe.score_batch(tuples, memoize=False)
    assert pe.evaluations == len(tuples)
    for x, y in zip(a, b):
        assert x.cuts == y.cuts
        assert abs(x.latency_cycles - y.latency_cycles) \
            <= 1e-4 * max(1.0, x.latency_cycles)
        assert abs(x.dram_fm - y.dram_fm) <= 1e-4 * max(1, x.dram_fm)
        assert (x.sram_total, x.bram18k) == (y.sram_total, y.bram18k)


def test_pallas_results_never_poison_the_memo():
    """A memoized pallas batch must not plant float32 results in the
    shared memo: a later evaluate() on the same engine still returns the
    bit-exact oracle metrics."""
    _, port = both("resnet50")
    cuts = tuple(0 for _ in port.runs)
    engine = port.engine(device="cpu", backend="pallas")
    engine.score_batch([cuts])            # memoize=True, pallas backend
    assert cuts not in engine._cache
    want = port.cut.evaluate(port.gg, port.blocks, port.runs, cuts, port.hw)
    got = engine.evaluate(cuts)
    for f in ["latency_cycles"] + INT_METRICS:
        assert getattr(got, f) == getattr(want, f), f


def test_device_and_journal_replays_feed_the_scorer_alike():
    """Under the device replay the scorer reads the allocator scan's own
    io matrix; the stats equal the journal replay's, lane by lane, skip
    mask included."""
    _, port = both("efficientnet-b1")
    tuples = mixed_tuples(port.runs, n_prefix=20, n_random=20)
    skip = [i % 3 == 1 for i in range(len(tuples))]
    j = port.engine(device="cpu", backend="pallas").score_batch(
        tuples, memoize=False, skip=skip)
    d = port.engine(engine="device", device="cpu",
                    backend="pallas").score_batch(tuples, memoize=False,
                                                  skip=skip)
    assert [m is None for m in j] == skip == [m is None for m in d]
    assert j == d


def test_pallas_backend_on_a_cuda_device_needs_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, port = both("vgg16-conv")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.engine(engine="journal", device="cuda", backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        port.engine(device="cpu", backend="triton")


# ------------------------------------------------------- whole compiles
_REF_PLANS: dict = {}


def _ref_pallas_plan(name, sequential=False):
    key = (name, sequential)
    if key not in _REF_PLANS:
        ref, _ = both(name)
        opts = ref_options.CompileOptions(
            backend="pallas",
            exhaustive_limit=LIMITS.get(name, ref_options.EXHAUSTIVE_LIMIT))
        if sequential:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(ref_sb, "score_batch_pallas", _sequential_scorer)
                _REF_PLANS[key] = ref_compiler.compile_graph(ref.graph,
                                                             ref.hw, opts)
        else:
            _REF_PLANS[key] = ref_compiler.compile_graph(ref.graph, ref.hw,
                                                         opts)
    return _REF_PLANS[key]


def _sequential_scorer(tables, frame, io, bpc, overhead, interpret=None,
                       block_b=256):
    """The reference's scorer with its sums taken in the port's order --
    the port's plain version run on the reference's own packed tables."""
    g = tables["g"]
    rows = np.stack([tables[k][0, :g] for k in port_sb.TABLE_KEYS])
    t = port_sb.ScoreTables(g=g, rows=torch.from_numpy(rows))
    return port_sb.score_batch_torch(
        t, torch.from_numpy(np.asarray(frame, bool)[:, :g]),
        torch.from_numpy(np.asarray(io, np.float32)[:, :g]), bpc,
        overhead).numpy()


def _port_pallas_plan(name, engine="journal"):
    _, port = both(name)
    return port_compiler.compile_graph(
        port.graph, port.hw, port_options.CompileOptions(
            backend="pallas", engine=engine, device="cpu",
            exhaustive_limit=LIMITS.get(name,
                                        port_options.EXHAUSTIVE_LIMIT)))


@pytest.mark.parametrize("name", ALL_CNNS)
def test_compile_pallas_equals_reference(name):
    """The port's backend="pallas" compile equals the reference's
    backend="pallas" compile (the journal engine on both sides; yolov2
    with its descent limit).  On R6's net the reference is run with the
    port's summation order."""
    pp = _port_pallas_plan(name)
    rp = _ref_pallas_plan(name, sequential=(name == R6_NET))
    assert_plans_equal(pp, rp, (name, "pallas"))


def test_reference_float32_summation_r6():
    """The known disagreement (R6).  On one efficientnet-b1 candidate the
    reference's interpret-mode sum and its numpy reference give a float32
    latency of 818110.0, the port's left-to-right sum 818109.875 (2 ulps
    below); the exact float64 latency is 818110.0.  The descent compares a
    trial's float32 latency with its start's exact one, so the port sees a
    spurious improvement the reference does not: 409 evaluated and cut 0
    in runs 16 and 24 against 329 and cut 1 -- the same exact latency, 64
    more bytes of SRAM.  With the port's order the reference itself takes
    the port's path (test_compile_pallas_equals_reference)."""
    ref, port = both(R6_NET)
    cuts = (0, 2, 1, 1, 0, 2, 1, 1, 0, 2, 1, 1, 0, 2, 1, 2, 1, 2, 1, 1, 0, 2,
            1, 2, 1, 2, 0)
    engine = ref.engine()
    engine._replay(cuts)
    frame = engine._frame.copy()[None]
    io = np.asarray(engine._x_io, np.float64)[None]
    tables = ref_sb.pack_tables(engine._lt, engine._dt, engine._st)
    hw = _hw()
    args = (hw.dram_bytes_per_cycle, hw.group_overhead_cycles)
    ker = ref_sb.score_batch_pallas(tables, frame, io, *args, interpret=True)
    npy = ref_sb.score_batch_ref(tables, frame, io, *args)
    got = port_sb.score_batch_torch(_port_tables(R6_NET),
                                    torch.from_numpy(frame),
                                    torch.from_numpy(io), *args)
    assert float(ker[0, 0]) == float(npy[0, 0]) == 818110.0
    assert float(got[0, 0]) == 818109.875
    assert engine.evaluate(cuts).latency_cycles == 818110.0
    rp, pp = _ref_pallas_plan(R6_NET), _port_pallas_plan(R6_NET)
    assert (rp.search.evaluated, pp.search.evaluated) == (329, 409)
    assert tuple(rp.candidate.cuts) == cuts
    assert [pp.candidate.cuts[i] for i in (16, 24)] == [0, 0]
    assert rp.latency.cycles == pytest.approx(pp.latency.cycles, rel=1e-13)
    assert (rp.candidate.sram_total, pp.candidate.sram_total) == (7040896,
                                                                  7040960)


@pytest.mark.parametrize("name", ["resnet50", "mobilenet-v3",
                                  "efficientnet-b1"])
def test_compile_pallas_same_under_every_engine(name):
    """``engine`` stays scheduling-only under backend="pallas": the device
    replay feeds the scorer the same matrices, and the pipeline's exact
    exhaustive search picks the same winners on these nets."""
    want = _port_pallas_plan(name)
    for engine in ("device", "pipeline"):
        assert_plans_equal(_port_pallas_plan(name, engine), want,
                           (name, engine))
