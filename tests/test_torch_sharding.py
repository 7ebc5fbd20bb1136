"""The port's mesh and sharding plans (``repro_torch/launch/{mesh,
sharding}.py``, ``models/layers.py::partition_specs``, ``Model.pspecs``)
against the JAX package's, in this process: no process group, no
subprocess, no device.  The reference's side is a
``jax.sharding.AbstractMesh`` of the same shape and
``NamedSharding(...).shard_shape``; the port's is its own ``Mesh``
description.  All 10 configs on the meshes (1, 1), (4, 1), (2, 2),
(16, 16) and (2, 16, 16): the plan (kind, ``fsdp``, rules, batch
preference), every parameter's spec by name and its shard's shape, and for
every valid cell of the config its ``batch_pspecs``, ``cache_pspecs`` and
``hidden_batch_axes``.  The JAX tree stacks each pattern slot's layers on
a leading ``layers`` axis, which every plan replicates; the port holds a
tensor a layer, so its spec is the reference's without that first entry.
"""
import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

import torch_parity
from repro.configs import get_config as ref_get_config
from repro.launch import mesh as ref_mesh
from repro.launch import sharding as ref
from repro.models.model import build_model as ref_build_model

from repro_torch.configs import ARCHS, SHAPES, get_config, valid_cells
from repro_torch.convert import _leaf_path
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import sharding as port
from repro_torch.launch.dryrun import abstract_cache
from repro_torch.models.model import Model
from repro_torch.models.transformer import stack_structure

torch_parity.one_thread()

ARCH_NAMES = sorted(ARCHS)
MESHES = {"1x1": (1, 1), "4x1": (4, 1), "2x2": (2, 2), "16x16": (16, 16),
          "2x16x16": (2, 16, 16)}


def _meshes(key):
    dims = MESHES[key]
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return AbstractMesh(dims, names), port_mesh.make_mesh(dims, names)


def _flat(tree) -> dict:
    """``{path of keys: leaf}`` of a JAX tree (specs as leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            leaf for path, leaf in flat}


def _flat_specs(tree, prefix=()) -> dict:
    """``{path of keys: spec}`` of the port's specs (dicts of tuples)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _cells(arch):
    return [SHAPES[s] for a, s in valid_cells() if a == arch]


def _plans(arch, key):
    rmesh, pmesh = _meshes(key)
    return (ref.make_plan(ref_get_config(arch), rmesh),
            port.make_plan(get_config(arch), pmesh), rmesh, pmesh)


def test_meshes_are_the_references():
    for multi in (False, True):
        m = port_mesh.make_production_mesh(multi_pod=multi)
        assert m.dims == ((2, 16, 16) if multi else (16, 16))
        rm = AbstractMesh(m.dims, m.axis_names)
        assert port_mesh.batch_axes(m) == ref_mesh.batch_axes(rm)
        assert port_mesh.data_shards(m) == ref_mesh.data_shards(rm)
        assert m.size == rm.size and m.shape == dict(rm.shape)
    host = port_mesh.make_host_mesh()
    assert (host.dims, host.axis_names) == ((1, 1), ("data", "model"))


@pytest.mark.parametrize("key", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_plan_equals_the_reference(arch, key):
    rp, pp, rmesh, pmesh = _plans(arch, key)
    assert (pp.kind, pp.fsdp) == (rp.kind, rp.fsdp)
    assert pp.rules == rp.rules
    assert pp.batch_axis_pref == rp.batch_axis_pref
    assert port.needs_fsdp(get_config(arch), pmesh) == ref.needs_fsdp(
        ref_get_config(arch), rmesh)


@pytest.mark.parametrize("key", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_parameter_spec_and_shard_equal_the_reference(arch, key):
    rp, pp, rmesh, pmesh = _plans(arch, key)
    cfg = get_config(arch)
    rmodel = ref_build_model(ref_get_config(arch))
    want = _flat(ref.param_pspecs(rmodel, rmesh, rp))
    shapes = _flat(rmodel.abstract_params("float32"))
    model = Model(cfg, device="meta")
    got = port.param_pspecs(model, pmesh, pp)
    named = dict(model.named_parameters())
    assert sorted(got) == sorted(named)
    seen = set()
    for name, spec in got.items():
        path, g = _leaf_path(cfg, name)
        seen.add(path)
        rspec, rshape = tuple(want[path]), shapes[path].shape
        if g >= 0:                         # a stacked leaf: drop 'layers'
            assert rspec[0] is None and rshape[1:] == named[name].shape
            rspec, rshape = rspec[1:], rshape[1:]
        assert spec == rspec, name
        rshard = NamedSharding(rmesh, want[path]).shard_shape(
            shapes[path].shape)
        assert port.shard_shape(named[name].shape, spec, pmesh) == (
            rshard[1:] if g >= 0 else rshard), name
    assert seen == set(want)


def _port_cache_paths(cfg, cache):
    """``{reference cache path: port spec}`` of a port cache's specs:
    layer ``i`` of the port is the reference's group slot or tail."""
    pattern, n_groups, _ = stack_structure(cfg)
    out = {("pos",): cache["pos"]}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out[prefix + (k,)] = v

    for i, layer in enumerate(cache["layers"]):
        if i < n_groups * len(pattern):
            walk(layer, ("groups", f"p{i % len(pattern)}"))
        else:
            walk(layer, ("tail", f"t{i - n_groups * len(pattern)}"))
    return out


@pytest.mark.parametrize("key", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_cache_and_hidden_specs_equal_the_reference(arch, key):
    rp, pp, rmesh, pmesh = _plans(arch, key)
    for cell in _cells(arch):
        cfg = get_config(arch).replace(max_seq=cell.seq_len)
        rmodel = ref_build_model(ref_get_config(arch).replace(
            max_seq=cell.seq_len))
        model = Model(cfg, device="meta")
        B, S = cell.global_batch, cell.seq_len
        ctx = (arch, cell.name)

        rb = ref.batch_pspecs(rmodel, rmesh,
                              rmodel.batch_spec(S, B, cell.mode), B, rp)
        pb = port.batch_pspecs(model, pmesh, model.batch_spec(S, B,
                                                              cell.mode),
                               B, pp)
        assert pb == {k: tuple(v) for k, v in rb.items()}, ctx

        rcache = rmodel.abstract_cache(B, S)
        want = _flat(ref.cache_pspecs(rcache, rmesh, B, rp))
        got = port.cache_pspecs(abstract_cache(cfg, B, S), pmesh, B, pp)
        got = _port_cache_paths(cfg, got)
        for path, spec in got.items():
            rspec = tuple(want[path])
            if path[0] == "groups":
                assert rspec[0] is None, (ctx, path)
                rspec = rspec[1:]
            assert spec == rspec, (ctx, path)
        assert set(got) == set(want), ctx
        # the reference's own stacked cache through the port's function
        stacked = port.cache_pspecs(rcache, pmesh, B, pp)
        assert _flat_specs(stacked) == {k: tuple(v)
                                        for k, v in want.items()}, ctx

        assert port.hidden_batch_axes(pp, pmesh, B) == \
            ref.hidden_batch_axes(rp, rmesh, B), ctx


def test_partition_specs_never_map_a_mesh_axis_twice():
    from repro.models.layers import D as RD
    from repro.models.layers import partition_specs as ref_partition_specs

    from repro_torch.models.layers import D, partition_specs

    rules = {"embed": "data", "ff": "data", "heads": ("pod", "data"),
             "kv": ("data",), None: None}
    axes = [("embed", "ff"), ("ff", "embed"), ("heads", "embed"),
            ("embed", "heads"), ("kv", "ff", "embed"), (None, "ff"),
            ("vocab", "embed"), ()]
    defs = {f"w{i}": D((2,) * len(a), a) for i, a in enumerate(axes)}
    rdefs = {f"w{i}": RD((2,) * len(a), a) for i, a in enumerate(axes)}
    want = ref_partition_specs(rdefs, rules)
    assert partition_specs(defs, rules) == {k: tuple(v)
                                           for k, v in want.items()}


def test_shard_shape_refuses_what_does_not_divide():
    m = port_mesh.make_mesh((16, 16))
    assert port.shard_shape((32, 5), ("data",), m) == (2, 5)
    assert port.shard_shape((512, 8), (("data", "model"), None), m) == (
        2, 8)
    with pytest.raises(ValueError):
        port.shard_shape((30, 5), ("data", None), m)
