"""Graph IR for the ShortcutFusion compiler.

A :class:`Graph` is a topologically-ordered list of :class:`LayerNode`.
Nodes are deliberately close to the paper's abstraction level (Fig. 5):
convolutions carry their fused BatchNorm/activation; pooling, element-wise
(shortcut) addition, concatenation, up-sampling and SE-scale ops are explicit
nodes that the grouping pass (grouping.py) fuses into instruction groups.

Sizes follow the paper's conventions: 8-bit activations (Q_A = 1 byte),
8-bit weights, 32-bit partial sums (Q_S = 4 bytes) unless overridden.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Iterator

# Node kinds understood by the compiler.
CONV_KINDS = ("conv", "dwconv", "fc")
MEMORY_KINDS = ("add", "concat", "route", "upsample", "maxpool", "avgpool",
                "globalpool", "scale", "input", "output")
ALL_KINDS = CONV_KINDS + MEMORY_KINDS


@dataclass
class LayerNode:
    idx: int
    kind: str
    name: str = ""
    # Spatial geometry.  For fc layers h = w = 1.
    in_ch: int = 0
    out_ch: int = 0
    in_h: int = 0
    in_w: int = 0
    out_h: int = 0
    out_w: int = 0
    k: int = 1                      # kernel size (k x k)
    stride: int = 1
    groups: int = 1                 # ==in_ch for depthwise
    act: str = "linear"             # relu / leaky / swish / sigmoid / linear
    # Graph edges: indices of producer nodes.  inputs[0] is the main path;
    # for `add` nodes inputs[1] is the shortcut operand.
    inputs: list[int] = field(default_factory=list)
    # Fusion hints (set by the zoo, consumed by grouping).
    fused_pool: int = 1             # 2 => fused 2x2 maxpool after conv
    # Quantization widths, bytes.
    qa: int = 1                     # activation width
    qw: int = 1                     # weight width
    qs: int = 4                     # partial-sum width

    # ------------------------------------------------------------------ sizes
    @property
    def in_size(self) -> int:
        """Input feature-map bytes (main path)."""
        return self.in_h * self.in_w * self.in_ch * self.qa

    @property
    def out_size(self) -> int:
        return self.out_h * self.out_w * self.out_ch * self.qa

    @property
    def weight_size(self) -> int:
        if self.kind == "conv":
            return self.k * self.k * self.in_ch * self.out_ch * self.qw // self.groups
        if self.kind == "dwconv":
            return self.k * self.k * self.in_ch * self.qw
        if self.kind == "fc":
            return self.in_ch * self.out_ch * self.qw
        if self.kind == "scale":        # SE scale: per-channel weights come
            return 0                    # from the FC side path, counted there
        return 0

    @property
    def macs(self) -> int:
        """Multiply-accumulate count."""
        if self.kind == "conv":
            return (self.k * self.k * self.in_ch * self.out_ch
                    * self.out_h * self.out_w) // self.groups
        if self.kind == "dwconv":
            return self.k * self.k * self.in_ch * self.out_h * self.out_w
        if self.kind == "fc":
            return self.in_ch * self.out_ch
        if self.kind == "scale":
            return self.out_h * self.out_w * self.out_ch
        return 0

    @property
    def is_compute(self) -> bool:
        return self.kind in CONV_KINDS

    def clone(self, **kw) -> "LayerNode":
        return dataclasses.replace(self, **kw)


@dataclass
class Graph:
    name: str
    nodes: list[LayerNode] = field(default_factory=list)

    # ------------------------------------------------------------- building
    def add(self, kind: str, **kw) -> LayerNode:
        if kind not in ALL_KINDS:
            raise ValueError(f"unknown node kind {kind!r}")
        idx = len(self.nodes)
        if "inputs" not in kw and idx > 0:
            kw["inputs"] = [idx - 1]
        node = LayerNode(idx=idx, kind=kind, **kw)
        # Geometry inference from the main producer when not given.
        if node.inputs and node.in_h == 0:
            p = self.nodes[node.inputs[0]]
            node.in_h, node.in_w, node.in_ch = p.out_h, p.out_w, p.out_ch
        if node.out_h == 0:
            node.out_h = max(1, node.in_h // node.stride)
            node.out_w = max(1, node.in_w // node.stride)
        if node.out_ch == 0:
            node.out_ch = node.in_ch
        if node.kind == "dwconv":
            node.groups = node.in_ch
            node.out_ch = node.in_ch
        if node.kind == "globalpool":
            node.out_h = node.out_w = 1
        if node.kind == "concat":
            node.out_ch = sum(self.nodes[i].out_ch for i in node.inputs)
        if node.kind == "add":
            a = self.nodes[node.inputs[0]]
            node.out_h, node.out_w, node.out_ch = a.out_h, a.out_w, a.out_ch
        if node.kind == "upsample":
            node.out_h, node.out_w = node.in_h * node.stride, node.in_w * node.stride
        self.nodes.append(node)
        return node

    # -------------------------------------------------------------- queries
    def __iter__(self) -> Iterator[LayerNode]:
        return iter(self.nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    def consumers(self, idx: int) -> list[LayerNode]:
        return [n for n in self.nodes if idx in n.inputs]

    def to_residual(self, idx: int) -> bool:
        """True iff node idx's output is the *shortcut* operand of a later add
        (i.e. it is consumed by an `add` node that is not its direct
        successor) -- Algorithm 1's ``to_residual``."""
        for n in self.nodes:
            if n.kind == "add" and len(n.inputs) > 1 and idx in n.inputs[1:]:
                return True
        return False

    def shortcut_span(self, idx: int) -> int:
        """Distance (in nodes) the shortcut produced at idx must stay alive."""
        spans = [n.idx - idx for n in self.nodes
                 if n.kind == "add" and len(n.inputs) > 1 and idx in n.inputs[1:]]
        return max(spans, default=0)

    def total_weight_bytes(self) -> int:
        return sum(n.weight_size for n in self.nodes)

    def total_macs(self) -> int:
        return sum(n.macs for n in self.nodes)

    def conv_layers(self) -> list[LayerNode]:
        return [n for n in self.nodes if n.is_compute]

    def validate(self) -> None:
        for n in self.nodes:
            for i in n.inputs:
                if not (0 <= i < n.idx):
                    raise ValueError(
                        f"node {n.idx} ({n.name}) has non-topological input {i}")
            if n.kind == "add" and len(n.inputs) < 2:
                raise ValueError(f"add node {n.idx} needs >=2 inputs")
        if self.nodes and self.nodes[0].kind != "input":
            raise ValueError("graph must start with an input node")


def make_input(g: Graph, h: int, w: int, ch: int = 3, qa: int = 1) -> LayerNode:
    return g.add("input", inputs=[], in_h=h, in_w=w, in_ch=ch,
                 out_h=h, out_w=w, out_ch=ch, qa=qa)
