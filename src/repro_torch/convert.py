"""State carried across from the JAX package, as plain data.

On the compiler's path what has to be identical on both sides is the graph
and the packed tables; on the numerics path (``cnn/torch_ref.py``, the
simulator) it is the CNN weights too; on the LM path the model's weights.  The functions here take the other
package's objects as plain Python / numpy data (``dataclasses.asdict`` of
its nodes, dicts of its numpy tables and weights) -- this package never
imports the other one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.cnn.torch_ref import load_params
from repro_torch.core.ir import Graph, LayerNode
from repro_torch.kernels.alloc_scan import AllocScanTables
from repro_torch.kernels.search_pipeline import PipelineTables


def graph_from_nodes(name: str, nodes: list[dict]) -> Graph:
    """A :class:`Graph` from one dict per ``LayerNode`` (every dataclass
    field, as ``dataclasses.asdict`` gives them), in index order.  The
    nodes are taken as they are -- shapes already inferred -- and the
    graph is validated."""
    fields = {f.name for f in dataclasses.fields(LayerNode)}
    g = Graph(name)
    for i, d in enumerate(nodes):
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"node {i}: unknown LayerNode fields "
                             f"{sorted(unknown)}")
        node = LayerNode(**{k: (list(v) if isinstance(v, (list, tuple))
                                else v) for k, v in d.items()})
        if node.idx != i:
            raise ValueError(f"node {i} carries idx {node.idx}: nodes must "
                             f"come in index order")
        g.nodes.append(node)
    g.validate()
    return g


def alloc_tables_from_numpy(fields: dict, device="cpu") -> AllocScanTables:
    """The allocator-scan tables on ``device`` from a dict of the numpy
    fields of the other package's ``AllocScanTables``."""
    return AllocScanTables.from_numpy(fields, device=device)


def pipeline_tables_from_numpy(tables: dict, device="cpu") -> PipelineTables:
    """The pipeline's tables on ``device`` from the dict the other
    package's ``_engine_tables`` builds."""
    return PipelineTables.from_numpy(tables, device=device)


def cnn_params_from_numpy(params: dict, device="cpu") -> dict:
    """The port's CNN weights on ``device`` from the other package's
    ``init_params`` dict (numpy arrays keyed by node index: conv / dwconv
    kernels HWIO, fc matrices ``[cin, cout]``), in the layout
    ``cnn/torch_ref.py`` computes with."""
    return load_params(params, device)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # numpy has no bfloat16 of its own
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_numpy(cfg, tree: dict, device="cpu") -> dict:
    """The ``state_dict`` of ``models/model.py::Model(cfg)`` from the other
    package's ``Model.init`` tree, its leaves as numpy arrays.

    That tree stacks the layers of each pattern slot along a leading axis
    (``stack/groups/p{i}/<block>/<name>[g]``) and keeps the remainder as
    ``stack/tail/t{i}``; the port holds one module per layer in depth
    order, so group ``g``, slot ``i`` is layer ``g * len(pattern) + i`` and
    tail ``t{i}`` follows the groups.  The layouts are the same on both
    sides (both compute ``x @ W`` with ``W [in, out]``), so no weight is
    transposed; every array keeps its type."""
    from repro_torch.models.transformer import stack_structure

    pattern, n_groups, n_tail = stack_structure(cfg)
    out = {"final_norm": _tensor(tree["final_norm"], device)}
    for name, a in tree["embed"].items():
        out[f"embed.{name}"] = _tensor(a, device)
    stack = tree["stack"]
    for i in range(len(pattern)):
        for block, leaves in stack["groups"][f"p{i}"].items():
            for name, a in leaves.items():
                a = np.asarray(a)
                if a.shape[0] != n_groups:
                    raise ValueError(f"p{i}/{block}/{name}: leading axis "
                                     f"{a.shape[0]} != {n_groups} groups")
                for g in range(n_groups):
                    out[f"layers.{g * len(pattern) + i}.{block}.{name}"] = \
                        _tensor(a[g], device)
    for i in range(n_tail):
        for block, leaves in stack["tail"][f"t{i}"].items():
            for name, a in leaves.items():
                out[f"layers.{n_groups * len(pattern) + i}.{block}.{name}"] = \
                    _tensor(a, device)
    return out
