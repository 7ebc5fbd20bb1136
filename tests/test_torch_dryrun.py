"""The port's analytic dry-run (``repro_torch/launch/dryrun.py``) against
the analytic half of the JAX package's, on all 32 ``valid_cells()`` and
both production meshes (16 x 16 and 2 x 16 x 16), in this process.

The reference's per-device argument bytes are built here as its
``run_cell`` builds them, up to the lowering it does next: its abstract
parameters, optimizer state, cache and batch, placed by its plans through
``to_named`` on a ``jax.sharding.AbstractMesh``, summed by its own
``shard_bytes``.  The port's ``params``, ``opt``, ``cache`` and ``batch``
bytes must equal them with ``==``, and ``model_flops`` the reference's.
The lowering, ``memory_analysis`` and ``cost_analysis`` are the
reference's alone and are not checked (its own subprocess test of them
fails here, ROADMAP R4)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

import torch_parity
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import sharding as ref
from repro.models.model import build_model as ref_build_model
from repro.optim.adamw import init_opt_state as ref_init_opt_state

from repro_torch.configs import SHAPES, get_config, valid_cells
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

torch_parity.one_thread()
REF_DRYRUN = torch_parity.reference_dryrun()
ROOT = Path(__file__).resolve().parents[1]
CELLS = valid_cells()


def _reference_arg_bytes(arch, shape, multi_pod):
    """The reference ``run_cell``'s ``arg_bytes``, without lowering."""
    cell = REF_SHAPES[shape]
    cfg = ref_get_config(arch).replace(max_seq=cell.seq_len)
    port_mesh = make_production_mesh(multi_pod=multi_pod)
    mesh = AbstractMesh(port_mesh.dims, port_mesh.axis_names)
    model = ref_build_model(cfg)
    plan = ref.make_plan(cfg, mesh)
    pshard = ref.to_named(mesh, ref.param_pspecs(model, mesh, plan))
    bspec = model.batch_spec(cell.seq_len, cell.global_batch, cell.mode)
    bshard = ref.to_named(mesh, ref.batch_pspecs(model, mesh, bspec,
                                                 cell.global_batch, plan))
    sb = REF_DRYRUN.shard_bytes
    if cell.mode == "train":
        params = model.abstract_params("float32")
        opt = jax.eval_shape(ref_init_opt_state, params)
        return plan, {"params": sb(params, pshard),
                      "opt": sb(opt["m"], pshard) * 2,
                      "batch": sb(bspec, bshard)}
    params = model.abstract_params("bfloat16")
    cache = model.abstract_cache(cell.global_batch, cell.seq_len)
    cshard = ref.to_named(mesh, ref.cache_pspecs(cache, mesh,
                                                 cell.global_batch, plan))
    return plan, {"params": sb(params, pshard), "cache": sb(cache, cshard),
                  "batch": sb(bspec, bshard)}


def test_the_cells_are_the_references():
    from repro.configs import valid_cells as ref_valid_cells
    assert CELLS == ref_valid_cells() and len(CELLS) == 32
    assert sorted(SHAPES) == sorted(REF_SHAPES)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_per_device_bytes_and_flops_equal_the_reference(arch, shape,
                                                        multi_pod):
    plan, want = _reference_arg_bytes(arch, shape, multi_pod)
    res = dryrun.run_cell(arch, shape, multi_pod=multi_pod)
    assert res["arg_bytes_per_device"] == want
    assert (res["plan"], res["fsdp"]) == (plan.kind, plan.fsdp)
    assert res["total_arg_bytes_per_device"] == sum(want.values())
    cfg = get_config(arch).replace(max_seq=SHAPES[shape].seq_len)
    rcfg = ref_get_config(arch).replace(max_seq=SHAPES[shape].seq_len)
    assert res["model_flops_global"] == REF_DRYRUN.model_flops(
        rcfg, REF_SHAPES[shape])
    assert dryrun.model_flops(cfg, SHAPES[shape]) == \
        res["model_flops_global"]
    assert res["hbm_bytes"] == dryrun.H100_HBM_BYTES
    assert res["fits_hbm"] == (sum(want.values()) < dryrun.H100_HBM_BYTES)


def test_shard_bytes_equals_the_reference_on_a_small_tree():
    """Both ``shard_bytes`` over the same leaves, one spec each, among
    them a replicated, a 2-axis and a 1-entry-short spec."""
    import jax.numpy as jnp
    import torch

    from repro_torch.models.model import TensorSpec

    pm = make_production_mesh(multi_pod=True)
    mesh = AbstractMesh(pm.dims, pm.axis_names)
    shapes = {"a": ((32, 64), ("data", None)), "b": ((2, 256), ("pod",
                                                             "model")),
              "c": ((64,), ()), "d": ((64, 3, 5), (("pod", "data"),))}
    ref_tree = {k: jax.ShapeDtypeStruct(s, jnp.bfloat16)
                for k, (s, _) in shapes.items()}
    port_tree = {k: TensorSpec(s, torch.bfloat16)
                 for k, (s, _) in shapes.items()}
    specs = {k: sp for k, (_, sp) in shapes.items()}
    want = REF_DRYRUN.shard_bytes(
        ref_tree, ref.to_named(mesh, {k: P(*sp) for k, sp in
                                      specs.items()}))
    assert dryrun.shard_bytes(port_tree, specs, pm) == want


def test_the_cli_runs_every_cell_on_this_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--both-meshes", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[OK]")]
    assert len(lines) == 64
    assert "all 64 requested cells planned." in out.stdout
    rec = json.loads((tmp_path / "gemma2-2b_train_4k_pod1.json").read_text())
    assert rec["arg_bytes_per_device"] == dryrun.run_cell(
        "gemma2-2b", "train_4k")["arg_bytes_per_device"]
    assert "XLA_FLAGS" not in out.stdout
