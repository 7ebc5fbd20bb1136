"""Group-wise instruction generation (paper Fig. 5b).

Each node group is described by an 11-word instruction (32-bit words): the
convolution geometry, activation type, pooling/upsampling option, fused
element-wise (shortcut) operand, data-reuse mode, and the static buffer
allocation {alloc_in, alloc_out, alloc_shortcut} from Algorithm 1.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .allocator import Allocation
from .grouping import GroupedGraph

WORDS = 11

OPCODES = {"conv": 0, "dwconv": 1, "fc": 2, "add": 3, "concat": 4,
           "route": 5, "upsample": 6, "maxpool": 7, "avgpool": 8,
           "globalpool": 9, "scale": 10}
ACTS = {"linear": 0, "relu": 1, "leaky": 2, "swish": 3, "sigmoid": 4}
MODES = {"row": 0, "frame": 1}
OFFCHIP = 3                                    # buffer id meaning DRAM

# Bit width of every unsigned field in the 11-word encoding, in the order
# encode() packs them.  This is the single source of truth for range
# validation: encode() refuses to emit a word a field does not fit in, and
# a static verifier can check decoded/mutated instructions against the
# same table without encoding them.
FIELD_WIDTHS = {
    "opcode": 8, "mode": 4, "act": 4, "k": 8, "stride": 8,       # word 0
    "in_ch": 32, "out_ch": 32, "in_h": 32, "in_w": 32,           # words 1-4
    "fused_pool": 8, "fused_eltwise": 8, "fused_upsample": 8,    # word 5
    "alloc_in": 4, "alloc_out": 4, "alloc_shortcut": 4,          # word 6
    "gid": 32,                                                   # word 9
}
# src_main / src_shortcut (words 7/8) are signed 32-bit: -1 is the
# network-input / no-shortcut sentinel.
SIGNED_FIELDS = ("src_main", "src_shortcut")


def field_overflows(name: str, value: int) -> bool:
    """True if ``value`` does not fit the encoding slot of ``name``."""
    if name in SIGNED_FIELDS:
        return not (-(1 << 31) <= value < (1 << 31))
    return not (0 <= value < (1 << FIELD_WIDTHS[name]))


@dataclass
class GroupInstruction:
    gid: int
    opcode: int
    mode: int
    k: int
    stride: int
    in_ch: int
    out_ch: int
    in_h: int
    in_w: int
    act: int
    fused_pool: int          # 0 none, 1 max2x2, 2 global-avg
    fused_eltwise: int       # 0 none, 1 add
    fused_upsample: int
    alloc_in: int            # {0,1,2} or OFFCHIP
    alloc_out: int
    alloc_shortcut: int
    src_main: int            # producer gid (-1 = network input)
    src_shortcut: int        # producer gid of shortcut operand (-1 = none)

    def encode(self) -> np.ndarray:
        # Refuse to emit a truncated word: a field past its slot width used
        # to be silently masked (``& 0xFF`` etc.), corrupting the stream.
        for name in FIELD_WIDTHS:
            if field_overflows(name, getattr(self, name)):
                raise ValueError(
                    f"GroupInstruction.encode: field {name}="
                    f"{getattr(self, name)} overflows its "
                    f"{FIELD_WIDTHS[name]}-bit slot (gid {self.gid})")
        for name in SIGNED_FIELDS:
            if field_overflows(name, getattr(self, name)):
                raise ValueError(
                    f"GroupInstruction.encode: field {name}="
                    f"{getattr(self, name)} overflows its signed 32-bit "
                    f"slot (gid {self.gid})")
        w = np.zeros(WORDS, dtype=np.uint32)
        w[0] = (self.opcode) | ((self.mode) << 8) \
            | ((self.act) << 12) | ((self.k) << 16) \
            | ((self.stride) << 24)
        w[1] = self.in_ch
        w[2] = self.out_ch
        w[3] = self.in_h
        w[4] = self.in_w
        w[5] = (self.fused_pool) | ((self.fused_eltwise) << 8) \
            | ((self.fused_upsample) << 16)
        w[6] = (self.alloc_in) | ((self.alloc_out) << 4) \
            | ((self.alloc_shortcut) << 8)
        w[7] = np.uint32(self.src_main & 0xFFFFFFFF)
        w[8] = np.uint32(self.src_shortcut & 0xFFFFFFFF)
        w[9] = self.gid
        w[10] = 0xC0FFEE                        # group terminator marker
        return w

def generate_instructions(gg: GroupedGraph,
                          alloc: Allocation) -> list[GroupInstruction]:
    ins: list[GroupInstruction] = []
    for g in gg.groups:
        head, tail = g.head, g.tail
        fused_pool = 0
        fused_elt = 0
        fused_up = 0
        for n in g.nodes[1:] if head.is_compute else g.nodes:
            if n.kind == "maxpool":
                fused_pool = 1
            elif n.kind in ("avgpool", "globalpool"):
                fused_pool = 2
            elif n.kind == "add":
                fused_elt = 1
            elif n.kind == "upsample":
                fused_up = n.stride
        gin = gg.group_inputs(g)
        sc = gg.shortcut_source_group(g)
        ins.append(GroupInstruction(
            gid=g.gid,
            opcode=OPCODES[head.kind],
            mode=MODES[alloc.policy[g.gid]],
            k=head.k, stride=head.stride,
            in_ch=head.in_ch, out_ch=tail.out_ch,
            in_h=head.in_h, in_w=head.in_w,
            act=ACTS.get(head.act, 0),
            fused_pool=fused_pool, fused_eltwise=fused_elt,
            fused_upsample=fused_up,
            alloc_in=alloc.alloc_in.get(g.gid, OFFCHIP),
            alloc_out=alloc.alloc_out.get(g.gid, OFFCHIP),
            alloc_shortcut=alloc.alloc_shortcut.get(g.gid, OFFCHIP),
            src_main=gin[0] if gin else -1,
            src_shortcut=sc if sc is not None else -1))
    return ins


