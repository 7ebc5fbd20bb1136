"""State carried across from the JAX package, as plain data.

On the compiler's path what has to be identical on both sides is the graph
and the packed tables; on the numerics path (``cnn/torch_ref.py``, the
simulator) it is the CNN weights too.  The functions here take the other
package's objects as plain Python / numpy data (``dataclasses.asdict`` of
its nodes, dicts of its numpy tables and weights) -- this package never
imports the other one.
"""
from __future__ import annotations

import dataclasses

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
