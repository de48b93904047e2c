"""RegNetX family as explicit graphs (PyTorch port of
``shiftedscalequantization_tpu/models/regnet.py``).

ResBottleneckBlock maps onto the generic BlockSpec: f.a (1x1, relu) ->
f.b (3x3 grouped, relu) -> f.c (1x1, disable_act_quant), a ``proj``
downsample when the shape changes, post-add relu, then the block act
quantizer. Only the X configs (no SE) are generated.
"""
from __future__ import annotations

import numpy as np

from ..graph import BlockSpec, OpSpec, UnitSpec, iter_units

CONFIGS = {
    "regnetx_200m": dict(WA=36.44, W0=24, WM=2.49, DEPTH=13, GROUP_W=8),
    "regnetx_400m": dict(WA=24.48, W0=24, WM=2.54, DEPTH=22, GROUP_W=16),
    "regnetx_600m": dict(WA=36.97, W0=48, WM=2.24, DEPTH=16, GROUP_W=24),
    "regnetx_800m": dict(WA=35.73, W0=56, WM=2.28, DEPTH=16, GROUP_W=16),
    "regnetx_1600m": dict(WA=34.01, W0=80, WM=2.25, DEPTH=18, GROUP_W=24),
    "regnetx_3200m": dict(WA=26.31, W0=88, WM=2.25, DEPTH=25, GROUP_W=48),
    "regnetx_4000m": dict(WA=38.65, W0=96, WM=2.43, DEPTH=23, GROUP_W=40),
    "regnetx_6400m": dict(WA=60.83, W0=184, WM=2.07, DEPTH=17, GROUP_W=56),
}


def _conv(name, cin, cout, k, s, p, groups=1, act=None, disable_aq=False):
    return UnitSpec(name=name, kind="conv", in_ch=cin, out_ch=cout,
                    kernel=(k, k), stride=(s, s), padding=(p, p),
                    groups=groups, activation=act,
                    disable_act_quant=disable_aq, has_bn=True)


def generate_regnet(w_a, w_0, w_m, d, q=8):
    """Per-block widths quantized to multiples of ``q``, and the number of
    stages."""
    ws_cont = np.arange(d) * w_a + w_0
    ks = np.round(np.log(ws_cont / w_0) / np.log(w_m))
    ws = w_0 * np.power(w_m, ks)
    ws = np.round(np.divide(ws, q)) * q
    num_stages = len(np.unique(ws))
    return ws.astype(int).tolist(), num_stages


def get_stages_from_blocks(ws):
    """Stage widths and depths from per-block widths."""
    ts = [w != wp for w, wp in zip(ws + [0], [0] + ws)]
    s_ws = [w for w, t in zip(ws, ts[:-1]) if t]
    s_ds = np.diff([d for d, t in zip(range(len(ts)), ts) if t]).tolist()
    return s_ws, s_ds


def adjust_ws_gs_comp(ws, bms, gs):
    """Widths made compatible with the bottleneck ratios and group widths."""
    ws_bot = [int(w * b) for w, b in zip(ws, bms)]
    gs = [min(g, w_bot) for g, w_bot in zip(gs, ws_bot)]
    ws_bot = [int(round(w_bot / g) * g) for w_bot, g in zip(ws_bot, gs)]
    ws = [int(w_bot / b) for w_bot, b in zip(ws_bot, bms)]
    return ws, gs


def _res_bottleneck(name, w_in, w_out, stride, bm, gw):
    w_b = int(round(w_out * bm))
    num_gs = w_b // gw
    units = (
        _conv(f"{name}.f.a", w_in, w_b, 1, 1, 0, act="relu"),
        _conv(f"{name}.f.b", w_b, w_b, 3, stride, 1, groups=num_gs,
              act="relu"),
        _conv(f"{name}.f.c", w_b, w_out, 1, 1, 0, disable_aq=True),
    )
    down = None
    if (w_in != w_out) or (stride != 1):
        down = _conv(f"{name}.proj", w_in, w_out, 1, stride, 0,
                     disable_aq=True)
    return BlockSpec(name=name, units=units, downsample=down,
                     residual=True, post_activation="relu")


def build_regnetx(arch: str = "regnetx_600m", num_classes: int = 1000,
                  variant: str = "imagenet"):
    """Build the graph. variant='cifar' runs the stem and the first
    stage's downsample at stride 1, so 32x32 inputs keep a useful head
    map."""
    small = variant == "cifar"
    cfg = CONFIGS[arch]
    b_ws, num_s = generate_regnet(cfg["WA"], cfg["W0"], cfg["WM"],
                                  cfg["DEPTH"])
    ws, ds = get_stages_from_blocks(b_ws)
    bms = [1.0] * num_s
    gws = [cfg["GROUP_W"]] * num_s
    ws, gws = adjust_ws_gs_comp(ws, bms, gws)
    stem_w = 32
    nodes = [_conv("model.stem.conv", 3, stem_w, 3, 1 if small else 2, 1,
                   act="relu")]
    prev_w = stem_w
    for i, (d, w, bm, gw) in enumerate(zip(ds, ws, bms, gws)):
        for b in range(d):
            stride = 2 if b == 0 and not (small and i == 0) else 1
            w_in = prev_w if b == 0 else w
            nodes.append(_res_bottleneck(
                f"model.s{i + 1}.b{b + 1}", w_in, w, stride, bm, gw))
        prev_w = w
    nodes.append(OpSpec("model.avgpool", "gap"))
    nodes.append(UnitSpec("model.head.fc", "linear", in_ch=prev_w,
                          out_ch=num_classes))
    return tuple(nodes)


def torch_key_map(graph):
    """unit name -> (conv_prefix, bn_prefix | None): stem.conv <-> stem.bn;
    f.a / f.b / f.c <-> f.a_bn / f.b_bn / f.c_bn; proj <-> its sibling bn;
    head.fc has none."""
    m = {}
    for u in iter_units(graph):
        tname = u.name.removeprefix("model.")
        if not u.has_bn:
            m[u.name] = (tname, None)
        elif tname == "stem.conv":
            m[u.name] = (tname, "stem.bn")
        elif tname.endswith(".proj"):
            m[u.name] = (tname, tname[: -len("proj")] + "bn")
        else:
            m[u.name] = (tname, tname + "_bn")
    return m
