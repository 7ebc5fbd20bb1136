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
