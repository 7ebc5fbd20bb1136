"""State carried across from the JAX package, as plain data.

On the compiler's path what has to be identical on both sides is the graph
and the packed tables; on the numerics path (``cnn/torch_ref.py``, the
simulator) it is the CNN weights too; on the LM path the model's weights
and, for training, the optimizer's state.  The functions here take the
other package's objects as plain Python / numpy data (``dataclasses.asdict``
of its nodes, dicts of its numpy tables and weights) and give the port's
state back in the same form -- this package never imports the other one.
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


# the port's layer stacks and the JAX tree's: (module list, tree key,
# decoder stack?)
_STACKS = (("layers", "stack", True), ("enc_layers", "enc_stack", False))


def lm_params_from_numpy(cfg, tree: dict, device="cpu") -> dict:
    """The ``state_dict`` of ``models/model.py::Model(cfg)`` from the other
    package's ``Model.init`` tree, its leaves as numpy arrays.

    That tree stacks the layers of each pattern slot along a leading axis
    (``stack/groups/p{i}/<block>/<name>[g]``) and keeps the remainder as
    ``stack/tail/t{i}``; the port holds one module per layer in depth
    order, so group ``g``, slot ``i`` is layer ``g * len(pattern) + i`` and
    tail ``t{i}`` follows the groups.  Audio's encoder (``enc_stack``, the
    pattern ``enc``) goes the same way into ``enc_layers``.  The layouts are
    the same on both sides (both compute ``x @ W`` with ``W [in, out]``;
    the experts' ``[E, d, ff]``), so no weight is transposed; every array
    keeps its type, a vlm gate as a 0-dim tensor."""
    from repro_torch.models.transformer import stack_structure

    known = {"embed", "final_norm", "enc_norm"} | {k for _, k, _ in _STACKS}
    unknown = set(tree) - known
    if unknown:
        raise ValueError(f"leaves the port has no place for: "
                         f"{sorted(unknown)}")
    out = {name: _tensor(tree[name], device)
           for name in ("final_norm", "enc_norm") if name in tree}
    for name, a in tree["embed"].items():
        out[f"embed.{name}"] = _tensor(a, device)
    for prefix, key, decoder in _STACKS:
        if key not in tree:
            continue
        stack = tree[key]
        pattern, n_groups, n_tail = stack_structure(cfg, decoder)
        for i in range(len(pattern)):
            for block, leaves in stack["groups"][f"p{i}"].items():
                for name, a in leaves.items():
                    a = np.asarray(a)
                    if a.shape[0] != n_groups:
                        raise ValueError(
                            f"{key} p{i}/{block}/{name}: leading axis "
                            f"{a.shape[0]} != {n_groups} groups")
                    for g in range(n_groups):
                        out[f"{prefix}.{g * len(pattern) + i}.{block}."
                            f"{name}"] = _tensor(a[g], device)
        for i in range(n_tail):
            for block, leaves in stack["tail"][f"t{i}"].items():
                for name, a in leaves.items():
                    out[f"{prefix}.{n_groups * len(pattern) + i}.{block}."
                        f"{name}"] = _tensor(a, device)
    return out


def _leaf_path(cfg, name: str) -> tuple[tuple[str, ...], int]:
    """The JAX tree's path to a port parameter's leaf, and the layer's
    index along that leaf's group axis (-1: not stacked)."""
    from repro_torch.models.transformer import stack_structure

    parts = name.split(".")
    stacks = {prefix: (key, decoder) for prefix, key, decoder in _STACKS}
    if parts[0] not in stacks:
        return tuple(parts), -1
    key, decoder = stacks[parts[0]]
    pattern, n_groups, _ = stack_structure(cfg, decoder)
    i, block, leaf = int(parts[1]), parts[2], parts[3]
    if i < n_groups * len(pattern):
        return (key, "groups", f"p{i % len(pattern)}", block,
                leaf), i // len(pattern)
    return (key, "tail", f"t{i - n_groups * len(pattern)}", block,
            leaf), -1


def lm_leaf_key(cfg, name: str) -> tuple:
    """A sort key that puts the port's parameter names in the order of the
    JAX tree's leaves (its dict keys sorted; a stacked leaf's layers by
    group)."""
    path, g = _leaf_path(cfg, name)
    return path + (g,)


def lm_params_to_numpy(cfg, state_dict: dict) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: the JAX package's
    ``Model.init`` tree, its leaves numpy copies of ``state_dict``'s
    tensors (each pattern slot's layers stacked along a leading group
    axis, on the tensors' device), each copied to the host once and sharing
    no memory with them.  numpy has no bfloat16, so a bfloat16 tensor
    raises ``TypeError``."""
    tree: dict = {}
    stacked: dict = {}
    for name, t in state_dict.items():
        if t.dtype == torch.bfloat16:
            raise TypeError(f"{name}: bfloat16 has no numpy type here")
        path, g = _leaf_path(cfg, name)
        if g >= 0:
            stacked.setdefault(path, {})[g] = t.detach()
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.detach().to("cpu", copy=True).numpy()
    for path, by_group in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.stack(     # a new tensor: .cpu() copies once
            [by_group[g] for g in sorted(by_group)]).cpu().numpy()
    return tree


def opt_state_to_numpy(cfg, state: dict) -> dict:
    """The JAX package's ``init_opt_state`` tree of an
    ``optim/adamw.py`` state: ``m`` and ``v`` as parameter trees, ``step``
    a 0-d int32 array."""
    return {"m": lm_params_to_numpy(cfg, state["m"]),
            "v": lm_params_to_numpy(cfg, state["v"]),
            "step": np.asarray(state["step"], dtype=np.int32)}


def opt_state_from_numpy(cfg, tree: dict, device="cpu") -> dict:
    """An ``optim/adamw.py`` state from the JAX package's optimizer
    tree."""
    return {"m": lm_params_from_numpy(cfg, tree["m"], device),
            "v": lm_params_from_numpy(cfg, tree["v"], device),
            "step": int(np.asarray(tree["step"]))}
