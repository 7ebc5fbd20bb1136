"""The program's inputs, built from a configuration's data."""
from __future__ import annotations


def program_graph(network: dict):
    """The port's ``Graph`` of a configuration's layer table."""
    from repro_torch.core.ir import Graph, LayerNode

    cols = network["columns"]
    return Graph(network["name"],
                 [LayerNode(idx=i, **dict(zip(cols, row)))
                  for i, row in enumerate(network["layers"])])


def program_accelerator(fields: dict):
    from repro_torch.core.hw import FPGAConfig

    return FPGAConfig(**fields)
