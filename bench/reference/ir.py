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

from dataclasses import dataclass, field
from typing import Iterator

# Node kinds understood by the compiler.
CONV_KINDS = ("conv", "dwconv", "fc")


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

@dataclass
class Graph:
    name: str
    nodes: list[LayerNode] = field(default_factory=list)

    # ------------------------------------------------------------- building
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


