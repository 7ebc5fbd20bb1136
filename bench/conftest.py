"""The benchmark's tests: they run on the CPU through the port's plain
versions (``device="cpu"``), except those marked ``chip``, which need a
CUDA device and skip without one."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
for _p in (BENCH, BENCH.parent / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one); run "
        "`python -m pytest bench -m chip` on the chip")


@pytest.fixture
def chip():
    """The CUDA device's name, or a skip where the host has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.get_device_name(0)


@pytest.fixture(scope="session")
def small(tmp_path_factory):
    """``(root, cell)``: a copy of the benchmark with one cell more, made
    of new data files only: yolov2's first 16 nodes (864 cut tuples), a mix searching them in
    chunks of 64, and a metric of its own.  Runs in seconds on the CPU."""
    import json
    import shutil

    cell = "yolov2-16.dse_small"
    root = tmp_path_factory.mktemp("bench_root")
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "yolov2-416.json").read_text())
    cfg["network"]["layers"] = cfg["network"]["layers"][:16]
    cfg.update(name="yolov2-16", cut_space=864, reduced=["network"])
    (root / "bench" / "configs" / "yolov2-16.json").write_text(
        json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "dse_exhaustive.json").read_text())
    mix["options"]["engine"] = "pipeline@64"
    (root / "bench" / "traffic" / "dse_small.json").write_text(
        json.dumps(mix))
    (root / "bench" / "metrics" / "compiles_done.py").write_text(
        "def read(window):\n    return float(len(window.walls))\n")
    spec["configs"].append({"name": "yolov2-16", "source": cfg["source"],
                            "file": "bench/configs/yolov2-16.json",
                            "reduced": ["network"], "why": "tests"})
    spec["workloads"].append({"name": cell, "config": "yolov2-16",
                              "traffic": "dse_small", "chips": 1,
                              "why": "tests"})
    spec["end_to_end"].append({"name": "compiles_done", "unit": "compiles",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": [cell]})
    for m in spec["per_layer"]:
        m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, cell
