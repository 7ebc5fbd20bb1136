"""The frozen roofline counts: at yolov2's chunk they give the bounds the
port's records hold (K1 0.0495 ms, K2 0.00814, K3 0.0495, all set by
bytes), from the configuration's data alone."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

import reference
import rooflines
from rooflines import alloc_scan, cost_rows, enum_frames

BENCH = Path(__file__).resolve().parent
CHUNK = 1 << 20


def shape(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return reference.shape(cfg["network"])


@pytest.mark.parametrize("kernel,ms", [(alloc_scan, 0.0495),
                                       (enum_frames, 0.00814),
                                       (cost_rows, 0.0495)])
def test_bounds_at_yolov2_chunk(kernel, ms):
    seconds, by = kernel.bound_s(CHUNK, shape("yolov2-416"))
    assert by == "bytes"
    assert f"{seconds * 1e3:.3g}" == f"{ms:.3g}"


@pytest.mark.parametrize("name", ["yolov2-416", "yolov3-416"])
def test_alloc_ops_match_the_port_tables(name):
    """The operation count from the configuration's data equals the one the
    port's allocator tables give."""
    from repro_torch.core.grouping import group_nodes
    from repro_torch.core.hw import KCU1500
    from repro_torch.kernels.alloc_scan import pack_alloc_tables

    from harness.network import program_graph

    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    at = pack_alloc_tables(group_nodes(program_graph(cfg["network"])),
                           KCU1500)
    side = at.is_side
    fan_in = (at.gin != at.sink_idx).sum(axis=1)
    ops = int((~side).sum() * alloc_scan.OPS_STEP
              + (at.sc[~side] != at.sink_idx).sum() * alloc_scan.OPS_SHORTCUT
              + fan_in[~side].sum() * alloc_scan.OPS_PRODUCER
              + side.sum() * alloc_scan.OPS_SIDE_STEP
              + fan_in[side].sum() * alloc_scan.OPS_SIDE_PRODUCER)
    assert alloc_scan.ops_per_candidate(shape(name)) == ops


def test_chunks_cover_the_space():
    assert rooflines.chunks(7962624, CHUNK) == [CHUNK] * 7 + [622592]
    assert sum(rooflines.chunks(134217728, CHUNK)) == 134217728


def test_traced_share_reads_the_trace_or_nothing():
    sh = shape("yolov2-416")
    least = alloc_scan.bound_s(CHUNK, sh)[0]
    trace = {"device_ops": {"alloc_scan_kernel": {"count": 4,
                                                  "seconds": 8 * least}}}
    w = SimpleNamespace(trace=trace, chunks=[CHUNK], shape=sh)
    assert rooflines.traced_share(w, alloc_scan) == pytest.approx(50.0)
    assert rooflines.traced_share(w, cost_rows) is None
    assert rooflines.traced_share(SimpleNamespace(trace=None, chunks=[CHUNK],
                                                  shape=sh), alloc_scan) is None
