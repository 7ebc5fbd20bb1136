"""The paper's CNN workloads as compiler IR graphs.

Layer tables follow the canonical public definitions (Darknet cfg files for
YOLO, torchvision for ResNet/VGG, the EfficientNet paper for B1, the
RetinaNet paper for the FPN + heads).  Node counts land within a few nodes of
the paper's Table III ("number of layers including shortcut, concatenation,
etc.") -- exact parity is impossible without the authors' private parser, and
the compiler results depend only on the shapes, which are exact.
"""
from __future__ import annotations

from repro_torch.core.ir import Graph, make_input


# --------------------------------------------------------------------- VGG16
def vgg16_conv(input_size: int = 224) -> Graph:
    g = Graph("vgg16-conv")
    make_input(g, input_size, input_size)
    cfg = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
    for ch, reps in cfg:
        for _ in range(reps):
            g.add("conv", out_ch=ch, k=3, act="relu")
        g.add("maxpool", k=2, stride=2)
    return g


# -------------------------------------------------------------------- YOLOv2
def yolov2(input_size: int = 416) -> Graph:
    g = Graph("yolov2")
    make_input(g, input_size, input_size)

    def cbl(ch, k=3):
        return g.add("conv", out_ch=ch, k=k, act="leaky")

    cbl(32); g.add("maxpool", k=2, stride=2)
    cbl(64); g.add("maxpool", k=2, stride=2)
    cbl(128); cbl(64, 1); cbl(128); g.add("maxpool", k=2, stride=2)
    cbl(256); cbl(128, 1); cbl(256); g.add("maxpool", k=2, stride=2)
    cbl(512); cbl(256, 1); cbl(512); cbl(256, 1)
    route16 = cbl(512)                                    # 26x26x512 passthrough
    g.add("maxpool", k=2, stride=2)
    cbl(1024); cbl(512, 1); cbl(1024); cbl(512, 1); cbl(1024)
    cbl(1024); cbl(1024)
    trunk = g.nodes[-1]
    # passthrough: 1x1 conv on route16, space-to-depth, concat with trunk.
    side = g.add("conv", inputs=[route16.idx], out_ch=64, k=1, act="leaky")
    reorg = g.add("route", inputs=[side.idx],
                  out_h=side.out_h // 2, out_w=side.out_w // 2,
                  out_ch=side.out_ch * 4)                 # space-to-depth
    g.add("concat", inputs=[trunk.idx, reorg.idx])
    cbl(1024)
    g.add("conv", out_ch=425, k=1, act="linear")
    return g


# -------------------------------------------------------------------- YOLOv3
def yolov3(input_size: int = 416) -> Graph:
    g = Graph("yolov3")
    make_input(g, input_size, input_size)

    def cbl(ch, k=3, stride=1, inputs=None):
        kw = dict(out_ch=ch, k=k, stride=stride, act="leaky")
        if inputs is not None:
            kw["inputs"] = inputs
        return g.add("conv", **kw)

    def res_block(mid, out):
        entry = g.nodes[-1]
        cbl(mid, 1)
        cbl(out, 3)
        g.add("add", inputs=[len(g.nodes) - 1, entry.idx])

    cbl(32)
    cbl(64, stride=2)
    res_block(32, 64)
    cbl(128, stride=2)
    for _ in range(2):
        res_block(64, 128)
    cbl(256, stride=2)
    for _ in range(8):
        res_block(128, 256)
    route_a = g.nodes[-1]                                  # 52x52x256
    cbl(512, stride=2)
    for _ in range(8):
        res_block(256, 512)
    route_b = g.nodes[-1]                                  # 26x26x512
    cbl(1024, stride=2)
    for _ in range(4):
        res_block(512, 1024)

    def head(base_ch, concat_with=None, route_from=None):
        if route_from is not None:
            g.add("route", inputs=[route_from])
            cbl(base_ch // 2, 1)
            g.add("upsample", stride=2)
            g.add("concat", inputs=[len(g.nodes) - 1, concat_with])
        cbl(base_ch, 1); cbl(base_ch * 2, 3)
        cbl(base_ch, 1); cbl(base_ch * 2, 3)
        branch = cbl(base_ch, 1)
        cbl(base_ch * 2, 3)
        g.add("conv", out_ch=255, k=1, act="linear")
        return branch

    b1 = head(512)
    b2 = head(256, concat_with=route_b.idx, route_from=b1.idx)
    head(128, concat_with=route_a.idx, route_from=b2.idx)
    return g


# -------------------------------------------------------------------- ResNet
def resnet(depth: int = 50, input_size: int = 224) -> Graph:
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}[depth]
    g = Graph(f"resnet{depth}")
    make_input(g, input_size, input_size)
    g.add("conv", out_ch=64, k=7, stride=2, act="relu")
    g.add("maxpool", k=3, stride=2)

    in_planes = 64
    for stage, reps in enumerate(blocks):
        width = 64 * (2 ** stage)
        for b in range(reps):
            stride = 2 if (stage > 0 and b == 0) else 1
            entry = g.nodes[-1]
            g.add("conv", out_ch=width, k=1, act="relu")
            g.add("conv", out_ch=width, k=3, stride=stride, act="relu")
            main = g.add("conv", out_ch=width * 4, k=1, act="linear")
            if b == 0:      # projection shortcut
                proj = g.add("conv", inputs=[entry.idx], out_ch=width * 4,
                             k=1, stride=stride, act="linear")
                g.add("add", inputs=[main.idx, proj.idx])
            else:
                g.add("add", inputs=[main.idx, entry.idx])
            in_planes = width * 4
    g.add("globalpool")
    g.add("fc", out_ch=1000, in_ch=in_planes, in_h=1, in_w=1,
          out_h=1, out_w=1)
    return g


# ----------------------------------------------------------- EfficientNet-B1
def efficientnet_b1(input_size: int = 256) -> Graph:
    """EfficientNet-B1: B0 stage table scaled depth x1.1, width x1.0."""
    g = Graph("efficientnet-b1")
    make_input(g, input_size, input_size)
    g.add("conv", out_ch=32, k=3, stride=2, act="swish")           # stem

    # (expand, channels, reps, stride, kernel) -- B1 depths.
    stages = [(1, 16, 2, 1, 3), (6, 24, 3, 2, 3), (6, 40, 3, 2, 5),
              (6, 80, 4, 2, 3), (6, 112, 4, 1, 5), (6, 192, 5, 2, 5),
              (6, 320, 2, 1, 3)]
    for expand, ch, reps, stride, k in stages:
        for b in range(reps):
            s = stride if b == 0 else 1
            entry = g.nodes[-1]
            in_ch = entry.out_ch
            mid = in_ch * expand
            if expand != 1:
                g.add("conv", out_ch=mid, k=1, act="swish")        # expand
            g.add("dwconv", k=k, stride=s, act="swish")            # depthwise
            dw = g.nodes[-1]
            # Squeeze-and-Excitation side path (Fig. 13c/d).
            g.add("globalpool", inputs=[dw.idx])
            g.add("fc", out_ch=max(1, in_ch // 4), in_ch=mid,
                  in_h=1, in_w=1, out_h=1, out_w=1, act="swish")
            se = g.add("fc", out_ch=mid, in_ch=max(1, in_ch // 4),
                       in_h=1, in_w=1, out_h=1, out_w=1, act="sigmoid")
            g.add("scale", inputs=[dw.idx, se.idx])                # channel scale
            main = g.add("conv", out_ch=ch, k=1, act="linear")     # project
            if s == 1 and in_ch == ch:
                g.add("add", inputs=[main.idx, entry.idx])
    g.add("conv", out_ch=1280, k=1, act="swish")                   # head
    g.add("globalpool")
    g.add("fc", out_ch=1000, in_ch=1280, in_h=1, in_w=1, out_h=1, out_w=1)
    return g


# ----------------------------------------------------------------- RetinaNet
def retinanet(input_size: int = 512) -> Graph:
    """ResNet50-FPN RetinaNet; heads instantiated per pyramid level."""
    g = resnet(50, input_size)
    g.name = "retinanet"
    # Drop classifier head (globalpool + fc) from the backbone.
    g.nodes = g.nodes[:-2]
    # Locate stage outputs C3, C4, C5 (last add of stages 2, 3, 4).
    adds = [n.idx for n in g.nodes if n.kind == "add"]
    c3, c4, c5 = adds[3 + 4 - 1], adds[3 + 4 + 6 - 1], adds[-1]

    lat5 = g.add("conv", inputs=[c5], out_ch=256, k=1, act="linear")
    lat4 = g.add("conv", inputs=[c4], out_ch=256, k=1, act="linear")
    lat3 = g.add("conv", inputs=[c3], out_ch=256, k=1, act="linear")
    up5 = g.add("upsample", inputs=[lat5.idx], stride=2)
    m4 = g.add("add", inputs=[lat4.idx, up5.idx])
    up4 = g.add("upsample", inputs=[m4.idx], stride=2)
    m3 = g.add("add", inputs=[lat3.idx, up4.idx])
    p3 = g.add("conv", inputs=[m3.idx], out_ch=256, k=3, act="linear")
    p4 = g.add("conv", inputs=[m4.idx], out_ch=256, k=3, act="linear")
    p5 = g.add("conv", inputs=[lat5.idx], out_ch=256, k=3, act="linear")
    p6 = g.add("conv", inputs=[c5], out_ch=256, k=3, stride=2, act="linear")
    p7 = g.add("conv", inputs=[p6.idx], out_ch=256, k=3, stride=2, act="relu")

    for level in (p3, p4, p5, p6, p7):
        for _head in range(2):                       # cls head + box head
            prev = level.idx
            for _ in range(4):
                c = g.add("conv", inputs=[prev], out_ch=256, k=3, act="relu")
                prev = c.idx
            out_ch = 9 * 80 if _head == 0 else 9 * 4
            g.add("conv", inputs=[prev], out_ch=out_ch, k=3, act="linear")
    return g


# -------------------------------------------------------------- MobileNetV3
def mobilenet_v3(input_size: int = 224) -> Graph:
    """MobileNetV3-Large -- the paper's Fig. 1 block (MBConv + SE).
    h-swish is modelled as swish (same dataflow/cost in the compiler)."""
    g = Graph("mobilenet-v3")
    make_input(g, input_size, input_size)
    g.add("conv", out_ch=16, k=3, stride=2, act="swish")           # stem

    # (kernel, expand_ch, out_ch, SE, act, stride)
    table = [
        (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
        (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
        (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
        (3, 240, 80, False, "swish", 2), (3, 200, 80, False, "swish", 1),
        (3, 184, 80, False, "swish", 1), (3, 184, 80, False, "swish", 1),
        (3, 480, 112, True, "swish", 1), (3, 672, 112, True, "swish", 1),
        (5, 672, 160, True, "swish", 2), (5, 960, 160, True, "swish", 1),
        (5, 960, 160, True, "swish", 1),
    ]
    for k, exp, out, se, act, s in table:
        entry = g.nodes[-1]
        in_ch = entry.out_ch
        if exp != in_ch:
            g.add("conv", out_ch=exp, k=1, act=act)                # expand
        g.add("dwconv", k=k, stride=s, act=act)                    # depthwise
        dw = g.nodes[-1]
        if se:
            g.add("globalpool", inputs=[dw.idx])
            g.add("fc", out_ch=max(1, exp // 4), in_ch=exp,
                  in_h=1, in_w=1, out_h=1, out_w=1, act="relu")
            gate = g.add("fc", out_ch=exp, in_ch=max(1, exp // 4),
                         in_h=1, in_w=1, out_h=1, out_w=1, act="sigmoid")
            g.add("scale", inputs=[dw.idx, gate.idx])
        main = g.add("conv", out_ch=out, k=1, act="linear")        # project
        if s == 1 and in_ch == out:
            g.add("add", inputs=[main.idx, entry.idx])
    g.add("conv", out_ch=960, k=1, act="swish")
    g.add("globalpool")
    g.add("fc", out_ch=1280, in_ch=960, in_h=1, in_w=1, out_h=1, out_w=1,
          act="swish")
    g.add("fc", out_ch=1000, in_ch=1280, in_h=1, in_w=1, out_h=1, out_w=1)
    return g


CNN_BUILDERS = {
    "vgg16-conv": vgg16_conv,
    "yolov2": yolov2,
    "yolov3": yolov3,
    "resnet50": lambda input_size=224: resnet(50, input_size),
    "resnet152": lambda input_size=224: resnet(152, input_size),
    "efficientnet-b1": efficientnet_b1,
    "retinanet": retinanet,
    "mobilenet-v3": mobilenet_v3,
}


def build_cnn(name: str, input_size: int | None = None) -> Graph:
    make = CNN_BUILDERS[name]
    g = make(input_size) if input_size else make()
    g.validate()
    return g
