"""The harness is data: a copy of ``bench/`` with a configuration file, a
mix file and a metric file added runs the new cell, found by name, with no
code edited."""
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def test_added_files_make_a_cell(small):
    root, cell = small
    added = {"configs/yolov2-16.json", "traffic/dse_small.json",
             "metrics/compiles_done.py"}
    copy = {p.relative_to(root / "bench").as_posix()
            for p in (root / "bench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}
    mine = {p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}
    assert copy == mine | added
    for rel in mine:                    # nothing of the harness edited
        assert (root / "bench" / rel).read_bytes() == \
            (BENCH / rel).read_bytes()
    # the copy's own harness, on the copy's own BENCHMARK.json
    code = f"""
import sys, json, time
sys.path[:0] = [{str(root / "bench")!r}, {str(BENCH.parent / "src")!r}]
from harness.cell import run_cell
print(json.dumps(run_cell({cell!r}, 5, 1.0, False, time.perf_counter(),
                          device="cpu", root=__import__("pathlib").Path(
                              {str(root)!r}))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"]
    assert set(r["metrics"]) == {"compile_ms", "setup_s", "compiles_done"}
    assert r["metrics"]["compiles_done"]["value"] >= 1
