"""``repro_torch.kernels.alloc_scan`` vs the JAX package's allocator scan.

The plain torch version (the one that runs on a host without a GPU, and the
yardstick the CUDA kernel is held against on the card) must reproduce the
reference's numpy form -- and its Pallas kernel, run in interpret mode as
the reference's own tests run it -- on every integer: the boundary-I/O
matrix, the three buffer maxima, side space, write-buffer max, DRAM
boundary total and spill feasibility.  Tolerance: none, integers equal."""
import numpy as np
import pytest
import torch

import repro.kernels.alloc_scan as ref_scan

import repro_torch.kernels.alloc_scan as port_scan
from repro_torch.convert import alloc_tables_from_numpy

from torch_parity import (ALL_CNNS, as_tensor, assert_scan_equal, both,
                          mixed_tuples, random_masks, ref_tables_dict,
                          scan_tables)


@pytest.mark.parametrize("name", ALL_CNNS)
def test_pack_alloc_tables_equal(name):
    """The port's own packing == the reference's, field by field, and the
    packed int32 step table the kernel reads holds the same numbers."""
    ref, port = both(name)
    rt, _ = scan_tables(name)
    pt = port_scan.pack_alloc_tables(port.gg, port.hw)
    assert (pt.n, pt.k, pt.input_idx, pt.sink_idx) == (
        rt.n, rt.k, rt.input_idx, rt.sink_idx)
    for f in port_scan.TABLE_FIELDS:
        assert np.array_equal(getattr(pt, f), getattr(rt, f)), (name, f)
    assert pt.fits_int32
    steps = pt.dev["steps32"].numpy()
    k = pt.k
    assert steps.shape == (pt.n, 8 + 2 * k)
    assert np.array_equal(steps[:, 8:8 + k], rt.gin)
    assert np.array_equal(steps[:, 8 + k:], rt.src_size)
    assert np.array_equal(steps[:, 5], rt.out_size)
    assert np.array_equal(steps[:, 6], rt.wr_cand[:rt.n])


@pytest.mark.parametrize("name", ALL_CNNS)
def test_alloc_scan_torch_matches_reference_on_cut_masks(name):
    ref, _ = both(name)
    rt, pt = scan_tables(name)
    frame = ref.engine()._frame_matrix(mixed_tuples(ref.runs))
    want = ref_scan.alloc_scan(rt, frame, "reference")
    got = port_scan.alloc_scan(pt, as_tensor(frame))
    assert got.io.dtype == torch.int64
    assert_scan_equal(got, want, name)


@pytest.mark.parametrize("name", ALL_CNNS)
def test_alloc_scan_torch_matches_reference_on_random_masks(name):
    """Arbitrary masks (no cut tuple produces them): spills, side groups
    and the reuse-main rule in states the search never reaches."""
    rt, pt = scan_tables(name)
    frame = random_masks(rt.n, 40, seed=len(name))
    want = ref_scan.alloc_scan(rt, frame, "reference")
    assert_scan_equal(port_scan.alloc_scan_torch(pt, as_tensor(frame)),
                      want, name)


@pytest.mark.parametrize("b", [1, 3, 17])
def test_alloc_scan_torch_b1_and_ragged(b):
    rt, pt = scan_tables("retinanet")
    frame = random_masks(rt.n, b, seed=b)
    assert_scan_equal(port_scan.alloc_scan(pt, as_tensor(frame)),
                      ref_scan.alloc_scan(rt, frame, "reference"), b)


@pytest.mark.parametrize("name", ["resnet50", "mobilenet-v3"])
def test_alloc_scan_skip_mask(name):
    """``skip=``: pruned lanes come back zero-filled (feasible), the
    others equal an unskipped call -- on both sides."""
    rt, pt = scan_tables(name)
    frame = random_masks(rt.n, 24, seed=5)
    skip = np.random.default_rng(1).random(24) < 0.4
    want = ref_scan.alloc_scan(rt, frame, "reference", skip=skip)
    got = port_scan.alloc_scan(pt, as_tensor(frame), skip=as_tensor(skip))
    assert_scan_equal(got, want, name)
    all_skip = np.ones(24, dtype=bool)
    assert_scan_equal(
        port_scan.alloc_scan(pt, as_tensor(frame), skip=as_tensor(all_skip)),
        ref_scan.alloc_scan(rt, frame, "reference", skip=all_skip), name)
    with pytest.raises(ValueError):
        port_scan.alloc_scan(pt, as_tensor(frame), skip=as_tensor(skip[:3]))


@pytest.mark.parametrize("name", ["vgg16-conv", "resnet50", "mobilenet-v3"])
def test_alloc_scan_torch_matches_pallas_interpret(name):
    """K1 itself, run the way the reference's tests run it off the TPU."""
    ref, _ = both(name)
    rt, pt = scan_tables(name)
    frame = np.concatenate([
        ref.engine()._frame_matrix(mixed_tuples(ref.runs, 4, 4, seed=2)),
        random_masks(rt.n, 6, seed=4)])
    want = ref_scan.alloc_scan_pallas(rt, frame, interpret=True, block_b=8)
    assert_scan_equal(port_scan.alloc_scan_torch(pt, as_tensor(frame)),
                      want, name)


def test_alloc_tables_from_numpy_round_trip():
    """convert.alloc_tables_from_numpy(reference fields) == the port's own
    packing, host fields and device tensors alike."""
    _, port = both("efficientnet-b1")
    rt, _ = scan_tables("efficientnet-b1")
    a = alloc_tables_from_numpy(ref_tables_dict(rt), device="cpu")
    b = port_scan.pack_alloc_tables(port.gg, port.hw)
    for f in port_scan.TABLE_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.dev.keys() == b.dev.keys()
    for key in a.dev:
        assert torch.equal(a.dev[key], b.dev[key]), key


def test_alloc_scan_wrappers_refuse_what_they_cannot_run():
    rt, pt = scan_tables("vgg16-conv")
    frame = as_tensor(random_masks(rt.n, 4, seed=0))
    # the kernel's wrapper never runs on a CPU tensor, it raises
    with pytest.raises(ValueError, match="CUDA"):
        port_scan.alloc_scan_cuda(pt, frame)
    with pytest.raises(ValueError, match="CUDA"):
        port_scan.alloc_scan(pt, frame, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        port_scan.alloc_scan(pt, frame, backend="pallas")
    assert port_scan.alloc_scan_cuda.launches == 0
    # a graph whose totals could overflow int32 is refused by the packer's
    # flag, which the kernel wrapper checks before launching
    big = ref_tables_dict(rt)
    big["out_size"] = big["out_size"].astype(np.int64) * 4096
    assert not port_scan.AllocScanTables.from_numpy(big).fits_int32


def test_lane_major_layout():
    x = torch.arange(12).reshape(3, 4)
    lm = port_scan.lane_major(x)
    assert torch.equal(lm, x) and lm.stride() == (1, 3)
    assert port_scan.lane_major(lm) is lm
    one = torch.arange(5).reshape(1, 5)
    assert port_scan.lane_major(one) is one


# ------------------------------------------------ the kernel's slot map
# the most lanes live at once on each zoo net (a lane lives from its
# producer's step, the graph input from the start, to its last reader)
ZOO_SLOTS = {"vgg16-conv": 2, "yolov2": 3, "yolov3": 5, "resnet50": 3,
             "resnet152": 3, "efficientnet-b1": 4, "retinanet": 7,
             "mobilenet-v3": 4}


def _live_ranges(t):
    """Each lane's (first, last) step, straight from the step rows."""
    n, sink = t.n, t.sink_idx
    first = {lane: lane for lane in range(n)}
    first[t.input_idx] = 0
    last = dict(first)
    for g in range(n):
        for lane in (*t.gin[g], t.main[g], t.sc[g]):
            if lane != sink:
                last[int(lane)] = max(last[int(lane)], g)
    return first, last


@pytest.mark.parametrize("name", ALL_CNNS)
def test_lane_slots_never_share_a_slot_between_live_lanes(name):
    _, pt = scan_tables(name)
    sl = pt.slots
    first, last = _live_ranges(pt)
    assert sl.width == ZOO_SLOTS[name]
    assert sl.slot[pt.sink_idx] == -1
    lanes = sorted(first)
    assert all(0 <= sl.slot[x] < sl.width for x in lanes)
    for i, a in enumerate(lanes):
        assert (sl.start[a], sl.end[a]) == (first[a], last[a]), (name, a)
        for b in lanes[i + 1:]:
            if first[a] <= last[b] and first[b] <= last[a]:
                assert sl.slot[a] != sl.slot[b], (name, a, b)
    # W is the most ranges live at one step: no colouring uses fewer
    assert sl.width == max(sum(first[x] <= g <= last[x] for x in lanes)
                           for g in range(pt.n))
    # every group's io leaves at the step its range ends, once
    assert sorted(x for ended in sl.ends for x in ended) == list(range(pt.n))
    assert all(last[x] == g for g, ended in enumerate(sl.ends)
               for x in ended)


def slot_replay(t, frame):
    """csrc/alloc_scan.cu's algorithm on the CPU, B candidates at once: the
    state lives only in the W slots of the packed slot table the kernel
    reads (``dev["slots32"]``), each lane's io leaves when its range ends.
    Returns ``(io (B, n), stats (B, 7))`` int64."""
    frame = np.asarray(frame, dtype=bool)
    B, (n, k) = frame.shape[0], t.gin.shape
    ni, sink, NB = t.input_idx, t.sink_idx, 3
    table = t.dev["slots32"].cpu().numpy().astype(np.int64)
    E = (table.shape[1] - 5 - 2 * k) // 2
    W = t.slots.width
    rem = np.zeros((W, B), np.int64)
    loc = np.zeros((W, B), np.int64)
    bw = np.zeros((W, B), bool)
    io_s = np.zeros((W, B), np.int64)
    io = np.full((n, B), -1, np.int64)         # -1: never written out
    s_in = t.slots.slot[ni]
    rem[s_in], loc[s_in] = t.rem0[ni], t.loc0[ni]
    live = np.full((NB, B), -1, np.int64)
    buff = np.zeros((NB, B), np.int64)
    side = np.zeros(B, np.int64)
    wrf = np.zeros(B, np.int64)
    bfm = np.zeros(B, np.int64)
    feas = np.ones(B, bool)

    def first_free(masks):
        out = np.full(B, -1, np.int64)
        for i in reversed(range(NB)):
            out[masks[i]] = i
        return out

    def release(slots_of):
        for src, sj in slots_of:
            if src == ni:
                continue
            dead = rem[sj] <= 0
            for i in range(NB):
                live[i][dead & (loc[sj] == i) & (live[i] == src)] = -1

    for g in range(n):
        row = table[g]
        own, smain, ssc = row[0], row[1], row[2]
        ops = [(int(t.gin[g, j]), int(row[4 + j]), int(t.src_size[g, j]))
               for j in range(k) if t.gin[g, j] != sink]
        wrc = {int(t.gin[g, j]): row[4 + k + j] for j in range(k)}
        assert all(sj >= 0 for _, sj, _ in ops)
        outsz = int(t.out_size[g])
        # the packed initial state: rem << 8 | bw << 4 | loc
        rem[own], loc[own] = row[3] >> 8, row[3] & 15
        bw[own], io_s[own] = (row[3] >> 4) & 1, 0
        if t.is_side[g]:
            side = np.maximum(side, outsz)
            loc[own] = 3
            for _, sj, _ in ops:
                rem[sj] -= 1
            release([(src, sj) for src, sj, _ in ops])
        else:
            fr = frame[:, g]
            mloc = loc[smain].copy()
            main_in = mloc < NB
            read = np.zeros(B, np.int64)
            in_buf = [np.zeros(B, bool) for _ in range(NB)]
            for _, sj, sz in ops:
                read += (loc[sj] == 4) * sz
                for i in range(NB):
                    in_buf[i] |= loc[sj] == i
            fetch = first_free([live[i] == -1 for i in range(NB)])
            need = ~main_in & (fetch >= 0)
            for i in range(NB):
                fetched = need & (fetch == i)
                hit = fr & ((main_in & (mloc == i)) | fetched)
                buff[i] = np.where(hit, np.maximum(buff[i], t.in_size[g]),
                                   buff[i])
                in_buf[i] |= fetched
            if t.sc[g] != sink:
                for i in range(NB):
                    hit = fr & (loc[ssc] == i)
                    buff[i] = np.where(hit,
                                       np.maximum(buff[i], t.sc_size[g]),
                                       buff[i])
            for src, sj, sz in ops:
                if src == ni:
                    continue
                add = ~fr & (loc[sj] < NB) & ~bw[sj]
                bw[sj] |= add
                io_s[sj] += add * sz
                bfm += add * sz
                wrf = np.where(add, np.maximum(wrf, wrc[src]), wrf)
            for _, sj, _ in ops:
                rem[sj] -= 1
            io_g = fr * read
            bfm += fr * read
            final = rem[own] == 0
            addf = fr & final
            bw[own] |= addf
            io_g += addf * outsz
            bfm += addf * outsz
            wrf = np.where(addf, np.maximum(wrf, t.wr_cand[g]), wrf)
            b_out = first_free([(live[i] == -1) & ~in_buf[i]
                                for i in range(NB)])
            main_live = np.zeros(B, bool)
            for i in range(NB):
                main_live |= (mloc == i) & (live[i] == t.main[g])
            take = (b_out < 0) & main_in & (rem[smain] == 0) & main_live
            b_out = np.where(take, mloc, b_out)
            alloc = fr & ~final & (b_out >= 0)
            spill = fr & ~final & (b_out < 0)
            io_g += (spill & ~addf) * outsz
            bfm += (spill & ~addf) * outsz
            if not t.spill_ok[g]:
                feas &= ~spill
            for i in range(NB):
                sel = alloc & (b_out == i)
                live[i] = np.where(sel, g, live[i])
                buff[i] = np.where(sel, np.maximum(buff[i], outsz), buff[i])
            loc[own] = np.where(alloc, b_out, 4)
            io_s[own] = io_g
            release([(src, sj) for src, sj, _ in ops])
        for e in range(row[4 + 2 * k]):
            io[row[5 + 2 * k + e]] = io_s[row[5 + 2 * k + E + e]]
    stats = np.stack([*buff, side, wrf, bfm, feas.astype(np.int64)], axis=1)
    return io.T, stats


@pytest.mark.parametrize("name", ALL_CNNS)
@pytest.mark.parametrize("masks", ["cut", "random"])
def test_slot_replay_equals_plain_version_and_reference(name, masks):
    """The kernel's algorithm, state in W slots only, equals the plain
    version bit for bit and the JAX package's reference replay."""
    ref, _ = both(name)
    rt, pt = scan_tables(name)
    if masks == "cut":
        frame = ref.engine()._frame_matrix(mixed_tuples(ref.runs))
    else:
        frame = random_masks(rt.n, 40, seed=7 + len(name))
    io, stats = slot_replay(pt, frame)
    assert (io >= 0).all(), "a lane's io was never written out"
    plain = port_scan.alloc_scan_torch(pt, as_tensor(frame))
    assert np.array_equal(io, plain.io.numpy())
    assert np.array_equal(stats, plain.stats.numpy())
    want = ref_scan.alloc_scan(rt, frame, "reference")
    assert np.array_equal(io, np.asarray(want.io))
    assert np.array_equal(stats[:, :3], np.asarray(want.buff))
    assert np.array_equal(stats[:, 5], np.asarray(want.bfm))
    assert np.array_equal(stats[:, 6] > 0, np.asarray(want.feasible))


@pytest.mark.parametrize("name", ["vgg16-conv", "resnet50", "mobilenet-v3"])
def test_slot_replay_equals_pallas_interpret(name):
    ref, _ = both(name)
    rt, pt = scan_tables(name)
    frame = np.concatenate([
        ref.engine()._frame_matrix(mixed_tuples(ref.runs, 4, 4, seed=3)),
        random_masks(rt.n, 6, seed=8)])
    want = ref_scan.alloc_scan_pallas(rt, frame, interpret=True, block_b=8)
    io, stats = slot_replay(pt, frame)
    assert np.array_equal(io, np.asarray(want.io))
    assert np.array_equal(stats[:, :3], np.asarray(want.buff))
    assert np.array_equal(stats[:, 3], np.asarray(want.side_buff))
    assert np.array_equal(stats[:, 4], np.asarray(want.wrf))


def test_slot_table_packs_the_slot_map():
    _, pt = scan_tables("retinanet")
    table = pt.dev["slots32"].numpy()
    k, sl = pt.k, pt.slots
    assert table.dtype == np.int32 and table.shape[0] == pt.n
    assert np.array_equal(table[:, 0], sl.slot[:pt.n])
    assert np.array_equal(table[:, 3] >> 8, pt.rem0[:pt.n])
    assert np.array_equal(table[:, 3] & 15, pt.loc0[:pt.n])
    assert np.array_equal(table[:, 4:4 + k], sl.slot[pt.gin])
    assert np.array_equal(table[:, 4 + k:4 + 2 * k], pt.wr_cand[pt.gin])
    assert np.array_equal(table[:, 4 + 2 * k], [len(e) for e in sl.ends])


def test_a_graph_too_wide_for_the_slots_is_refused():
    """A graph whose every group reads the graph input and feeds the last
    one keeps all its lanes live at once: wider than the kernel's slots,
    the CUDA wrapper refuses it with the reason (before it looks at the
    device); the plain version still runs it."""
    n = port_scan.MAX_SLOTS + 2
    ni, sink = n, n + 1
    gin = np.full((n, n - 1), sink, np.int32)
    gin[:-1, 0] = ni
    gin[-1] = np.arange(n - 1)
    fields = dict(
        is_side=np.zeros(n, bool), gin=gin,
        src_size=np.where(gin != sink, 64, 0), main=gin[:, 0].copy(),
        sc=np.full(n, sink, np.int32), sc_size=np.zeros(n, np.int64),
        in_size=np.full(n, 64), out_size=np.full(n, 64),
        wr_cand=np.zeros(n + 2, np.int64), spill_ok=np.ones(n, bool),
        rem0=np.append(np.append(np.full(n - 1, 1), 0), [n - 1, 1 << 40]),
        loc0=np.full(n + 2, 4, np.int8))
    t = port_scan.AllocScanTables.from_numpy(fields)
    assert t.slots.width == n
    frame = as_tensor(random_masks(n, 3, seed=1))
    with pytest.raises(ValueError, match="slots"):
        port_scan.alloc_scan_cuda(t, frame)
    assert port_scan.alloc_scan_cuda.launches == 0
    io, stats = slot_replay(t, frame.numpy())
    plain = port_scan.alloc_scan_torch(t, frame)
    assert np.array_equal(io, plain.io.numpy())
    assert np.array_equal(stats, plain.stats.numpy())
