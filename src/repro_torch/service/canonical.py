"""Deterministic request canonicalization for the compile service.

The plan cache is content-addressed: a request is ``(graph, hw,
CompileOptions)``, and two requests that can only ever compile to the
same plan must hash equal.  That requires a graph signature that is

* **insertion-order independent** -- the same network built by two code
  paths that append nodes in different (topologically valid) orders must
  canonicalize identically, so node indices cannot appear in the hash
  directly;
* **process independent** -- the hash must survive a fresh interpreter
  with a different ``PYTHONHASHSEED``, so nothing here uses Python's
  ``hash()``; everything goes through sha256 over a msgpack encoding
  (``packing.packb``, the standard library's writer of msgpack's format,
  byte-equal to ``msgpack.packb(..., use_bin_type=True)``);
* **cosmetics-blind** -- ``LayerNode.name`` and ``Graph.name`` are
  display strings with no bearing on the plan, so they are excluded
  (the weights *shape* signature is fully implied by the structural
  fields: in_ch/out_ch/k/groups/qw).

Canonicalization runs two signature passes over the DAG (a two-direction
Weisfeiler-Leman-style refinement):

1. **forward**: ``fwd[i] = H(fields(i), [fwd[j] for j in inputs(i)])``
   -- input order is preserved, because it is semantic (``add``'s
   ``inputs[1:]`` are the shortcut operands);
2. **backward**: ``bwd[i] = H(fields(i), sorted((bwd[c], position of i
   in c.inputs) for consumers c))`` -- the consumer *set* is unordered,
   so it is sorted by value.

Nodes are then ordered by ``(fwd, bwd, original index)`` and input edges
remapped to canonical positions.  The original index appears only as the
final tie-break: two nodes tie on both signatures only when they are
automorphic twins (structurally interchangeable), in which case either
order encodes an isomorphic -- but not always byte-equal -- structure.
That is the documented best-effort boundary (exact canonical forms for
arbitrary DAGs are graph-isomorphism-hard); none of the zoo networks
contains such twins.
"""
from __future__ import annotations

import dataclasses
import hashlib

from repro_torch.core.hw import FPGAConfig
from repro_torch.core.ir import Graph
from repro_torch.core.options import CompileOptions
from repro_torch.service.packing import packb

# Bumped whenever the canonical encoding, the plan codec, or the cache
# record layout changes shape: records written under a different schema
# version are never served (the cache treats them as evictable misses).
# v2: search records carry the search path ("exhaustive"/"descent") so
# the warm-start donor filter can tell oracle-exact argmins from descent
# results; record metadata carries "path" for the same reason.
CACHE_SCHEMA_VERSION = 2

# Structural LayerNode fields, in hash order.  `idx`, `name` and `inputs`
# are deliberately absent: indices and edges enter through the signature
# recursion, names are cosmetic.
_NODE_FIELDS = ("kind", "in_ch", "out_ch", "in_h", "in_w", "out_h",
                "out_w", "k", "stride", "groups", "act", "fused_pool",
                "qa", "qw", "qs")


def _digest(obj) -> bytes:
    return hashlib.sha256(packb(obj)).digest()


def _fields(node) -> list:
    return [getattr(node, f) for f in _NODE_FIELDS]


def canonical_graph(graph: Graph) -> list:
    """Insertion-order-independent structural encoding of ``graph``.

    Returns a msgpack-able nested list: one ``[fields..., inputs]`` entry
    per node, in canonical order, with ``inputs`` remapped to canonical
    positions.  Isomorphic graphs built in different node-insertion
    orders encode byte-identically (up to the automorphic-twin boundary
    in the module docstring).
    """
    nodes = graph.nodes
    fwd: list[bytes | None] = [None] * len(nodes)
    for n in nodes:                       # nodes are topologically ordered
        fwd[n.idx] = _digest([_fields(n), [fwd[j] for j in n.inputs]])
    bwd: list[bytes | None] = [None] * len(nodes)
    consumers: list[list] = [[] for _ in nodes]
    for n in nodes:
        for pos, j in enumerate(n.inputs):
            consumers[j].append((n.idx, pos))
    for n in reversed(nodes):
        uses = sorted((bwd[c], pos) for c, pos in consumers[n.idx])
        bwd[n.idx] = _digest([_fields(n), uses])
    order = sorted(range(len(nodes)),
                   key=lambda i: (fwd[i], bwd[i], i))
    position = {old: new for new, old in enumerate(order)}
    return [[*_fields(nodes[i]),
             [position[j] for j in nodes[i].inputs]] for i in order]


def graph_fingerprint(graph: Graph) -> str:
    """sha256 hex of the canonical graph alone (no hw, no options) --
    the "net family" identity the warm-start nearest-plan lookup matches
    on."""
    return hashlib.sha256(
        packb([CACHE_SCHEMA_VERSION, canonical_graph(graph)])).hexdigest()


def hw_signature(hw: FPGAConfig) -> list:
    """All FPGAConfig fields, name included (a renamed config with equal
    numbers still keys equal: the name is dropped from the hash but kept
    in the record metadata for reports)."""
    return [[f.name, getattr(hw, f.name)]
            for f in dataclasses.fields(hw) if f.name != "name"]


def plan_key_signature(options: CompileOptions) -> list:
    """``CompileOptions.plan_key()`` as a msgpack-able list.  Scheduling
    fields never appear here -- that is the point of the split."""
    return [[name, value] for name, value in options.plan_key()]


def request_key(graph: Graph, hw: FPGAConfig,
                options: CompileOptions) -> str:
    """The cache key: sha256 hex over (schema version, canonical graph,
    hw signature, plan-affecting options)."""
    payload = packb(
        [CACHE_SCHEMA_VERSION, canonical_graph(graph),
         hw_signature(hw), plan_key_signature(options)])
    return hashlib.sha256(payload).hexdigest()
