"""CNN parser & analyzer: re-organize nodes into fused instruction groups.

Mirrors Fig. 5: Convolution, Activation (implicit in the conv node),
Normalization (folded), Pooling, Element-wise (shortcut), Scale and
Up-sampling nodes are fused into a single group when they form a simple
producer chain -- exactly the fusions the back-end accelerator supports
(output of the MAC array forwarded through the post-processing chain without
a memory round-trip).  Concat/route stay standalone (feature-merging is a
redirect, Fig. 5 discussion).

A :class:`Group` is the unit everything downstream operates on: the
allocator assigns each group's output a buffer (or a DRAM round-trip), the
cut-point optimizer assigns each group a reuse mode via its residual
*block* (cutpoint.split_blocks aggregates groups back into blocks), the
cost models charge traffic/latency per group, and the ISA emits exactly
one instruction per group.  Group ids are dense and topological --
``groups[i].gid == i`` -- and every derived quantity (sizes, MACs, fused
add, dual output) is a property over the member nodes, so a Group never
caches state that could go stale under graph edits.

:class:`GroupedGraph` additionally carries three topology caches filled
once by :func:`group_nodes` -- per-group inputs, consumers, and the
shortcut-source map -- because the allocator and the cost models query
group topology inside the O(N^k) cut-point search where a dict lookup
matters.  The caches are private to this module; callers use the
``group_inputs`` / ``group_consumers`` / ``shortcut_source_group``
accessors.  The input image maps to pseudo-group ``-1`` (it owns no
buffer and no instruction).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .ir import Graph, LayerNode

# Node kinds a compute group may absorb after the conv.
FUSABLE = ("maxpool", "avgpool", "globalpool", "add", "upsample", "scale")


@dataclass
class Group:
    gid: int
    nodes: list[LayerNode] = field(default_factory=list)
    # Fig. 13(d): a dwconv group may emit BOTH its feature map (main output)
    # and an on-the-fly global-pooled copy for the SE side path.
    dual_output: bool = False

    # -------------------------------------------------------------- derived
    @property
    def head(self) -> LayerNode:
        return self.nodes[0]

    @property
    def tail(self) -> LayerNode:
        """Main-output node (excludes the side pooled copy)."""
        if self.dual_output:
            return self.nodes[-2]
        return self.nodes[-1]

    @property
    def kind(self) -> str:
        return self.head.kind

    @property
    def is_compute(self) -> bool:
        return self.head.is_compute

    @property
    def macs(self) -> int:
        return sum(n.macs for n in self.nodes)

    @property
    def weight_size(self) -> int:
        return sum(n.weight_size for n in self.nodes)

    @property
    def in_size(self) -> int:
        return self.head.in_size

    @property
    def out_size(self) -> int:
        return self.tail.out_size

    @property
    def fused_add(self) -> LayerNode | None:
        for n in self.nodes:
            if n.kind == "add":
                return n
        return None

    def __repr__(self) -> str:
        ks = "+".join(n.kind for n in self.nodes)
        return f"G{self.gid}[{ks} n{self.head.idx}-{self.tail.idx}]"


@dataclass
class GroupedGraph:
    graph: Graph
    groups: list[Group]
    # node idx -> group id
    node_group: dict[int, int]
    # Topology caches, filled once by group_nodes (allocation/timing/DRAM
    # models query these inside the O(N^k) cut-point search).
    _inputs: dict[int, list[int]] = field(default_factory=dict)
    _consumers: dict[int, list[int]] = field(default_factory=dict)
    _shortcut_src: dict[int, int | None] = field(default_factory=dict)

    def group_inputs(self, g: Group) -> list[int]:
        """Group ids feeding this group (main path first, then shortcut)."""
        return self._inputs[g.gid]

    def group_consumers(self, g: Group) -> list[int]:
        return self._consumers[g.gid]

    def shortcut_source_group(self, g: Group) -> int | None:
        """Group id producing the shortcut operand of g's fused add."""
        return self._shortcut_src[g.gid]

    def _build_caches(self) -> None:
        for g in self.groups:
            member = {n.idx for n in g.nodes}
            seen: list[int] = []
            for n in g.nodes:
                for i in n.inputs:
                    if i not in member:
                        gid = self.node_group[i]
                        if gid not in seen:
                            seen.append(gid)
            self._inputs[g.gid] = seen
            self._consumers[g.gid] = []
            src: int | None = None
            add = g.fused_add
            if add is not None:
                for i in add.inputs[1:]:
                    if i not in member:
                        src = self.node_group[i]
                        break
            self._shortcut_src[g.gid] = src
        for g in self.groups:
            for src in self._inputs[g.gid]:
                if src >= 0 and g.gid not in self._consumers[src]:
                    self._consumers[src].append(g.gid)


def group_nodes(graph: Graph) -> GroupedGraph:
    """Greedy chain fusion (the paper's analyzer, Fig. 5a).

    Each compute node (conv/dwconv/fc) opens a group and absorbs the
    linear chain of FUSABLE post-processing nodes that immediately follows
    it -- a successor fuses only if it is the next node in topological
    order and consumes the current tail as its main input, i.e. the chain
    the accelerator can stream through without a memory round-trip.  A
    node with multiple consumers ends the chain, with one exception
    (Fig. 13d): a depthwise conv that feeds both the main path and an SE
    global-pool keeps the pooled copy in-group (``dual_output``), because
    the hardware produces it on the fly.  Non-compute nodes that nothing
    absorbed (concat, route, standalone adds/pools) become single-node
    groups.
    """
    groups: list[Group] = []
    node_group: dict[int, int] = {}
    consumed: set[int] = set()

    consumer_map: dict[int, list[LayerNode]] = {n.idx: [] for n in graph}
    for n in graph:
        for i in n.inputs:
            consumer_map[i].append(n)

    for n in graph:
        if n.idx in consumed:
            continue
        if n.kind == "input":
            continue                      # the input image is not a group
        grp = Group(gid=len(groups), nodes=[n])
        consumed.add(n.idx)
        node_group[n.idx] = grp.gid
        if n.is_compute:
            # Absorb a linear chain of post-processing nodes.
            tail = n
            while True:
                nxt = None
                for c in consumer_map[tail.idx]:
                    if (c.kind in FUSABLE and c.idx == tail.idx + 1
                            and c.inputs[0] == tail.idx):
                        nxt = c
                        break
                # Special case (Fig. 13d): a dwconv may also feed the SE
                # global-pool concurrently; the pooled copy is produced on
                # the fly, so globalpool fuses even though the dwconv output
                # has another consumer.
                if nxt is None:
                    break
                multi = len(consumer_map[tail.idx]) > 1
                if multi and nxt.kind != "globalpool":
                    break
                grp.nodes.append(nxt)
                consumed.add(nxt.idx)
                node_group[nxt.idx] = grp.gid
                tail = nxt
                if nxt.kind == "globalpool" and multi:
                    grp.dual_output = True
                    break
        groups.append(grp)

    # Map the input node to a pseudo-group id of -1 handled by callers; to
    # keep lookups total, alias it to the first group.
    for n in graph:
        if n.kind == "input":
            node_group[n.idx] = -1
    gg = GroupedGraph(graph=graph, groups=groups, node_group=node_group)
    gg._build_caches()
    return gg
