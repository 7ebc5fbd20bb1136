"""What a run imports: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (the JAX package), each name compared
whole, since ``repro_torch`` begins with ``repro``; and the reference
imports nothing of the program."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from harness.cell import loaded_forbidden

BENCH = Path(__file__).resolve().parent
SRC = BENCH.parent / "src"


def python(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_names_compare_whole_top_level_names():
    assert loaded_forbidden(["repro_torch", "repro_torch.core",
                             "jax_like", "reference", "flaxen"]) == []
    assert loaded_forbidden(["repro.core.ir", "jax.numpy", "jaxlib",
                             "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                "repro"]


@pytest.mark.parametrize("cell", ["yolov2-416.dse_exhaustive",
                                  "yolov3-416.dse_exhaustive"])
def test_run_module_graph_loads_no_jax(cell):
    got = python(f"""
import sys, json
sys.path[:0] = [{str(BENCH)!r}, {str(SRC)!r}]
import harness.cell as c, reference
from harness import spec
from harness.control import Control
cell = spec.load_cell({cell!r})
for m in cell.end_to_end + cell.per_layer:
    spec.reader(m["name"])
c.Port(cell.config["network"], "cpu")
reference.Reference(cell.config["network"], "cpu")
print(json.dumps(c.loaded_forbidden()))
""")
    assert got == []


def test_reference_imports_nothing_of_the_program():
    got = python(f"""
import sys, json
sys.path[:0] = [{str(BENCH)!r}]
import reference
cfg = json.load(open({str(BENCH / "configs" / "yolov2-416.json")!r}))
net = dict(cfg["network"], layers=cfg["network"]["layers"][:16])
ref = reference.Reference(net, "cpu")
hw = reference.accelerator(cfg["accelerator"]["fields"])
ref.plan(hw, "latency", 864)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}}
                        & {{"repro_torch", "repro", "jax", "harness"}})))
""")
    assert got == []
