"""MNASNet as an explicit graph (PyTorch port of
``shiftedscalequantization_tpu/models/mnasnet.py``).

The reference quantizes MNASNet without a special block: every conv is an
individual unit and the residual adds stay in the module forward. That
maps onto BlockSpec(block_act_quant=False): the residual structure is
kept, there is no block-level act quantizer, and the reconstruction
targets are the individual units.
"""
from __future__ import annotations

from ..graph import BlockSpec, OpSpec, UnitSpec, iter_units
from .resnet import init_params  # noqa: F401  (the shared initializer)


def _conv(name, cin, cout, k, s, p, groups=1, act=None):
    return UnitSpec(name=name, kind="conv", in_ch=cin, out_ch=cout,
                    kernel=(k, k), stride=(s, s), padding=(p, p),
                    groups=groups, activation=act, has_bn=True)


def _round_to_multiple_of(val, divisor, round_up_bias=0.9):
    new_val = max(divisor, int(val + divisor / 2) // divisor * divisor)
    return new_val if new_val >= round_up_bias * val else new_val + divisor


def _get_depths(scale):
    return [_round_to_multiple_of(d * scale, 8)
            for d in [32, 16, 24, 40, 80, 96, 192, 320]]


def _inverted_residual(name, cin, cout, k, stride, exp):
    mid = cin * exp
    units = (
        _conv(f"{name}.layers.0", cin, mid, 1, 1, 0, act="relu"),
        _conv(f"{name}.layers.3", mid, mid, k, stride, k // 2,
              groups=mid, act="relu"),
        _conv(f"{name}.layers.6", mid, cout, 1, 1, 0),
    )
    return BlockSpec(name=name, units=units, downsample=None,
                     residual=(cin == cout and stride == 1),
                     post_activation=None, block_act_quant=False)


# stacks: (kernel, stride, expansion, repeats), reference mnasnet.py:94-99
_STACKS = [(3, 2, 3, 3), (5, 2, 3, 3), (5, 2, 6, 3), (3, 1, 6, 2),
           (5, 2, 6, 4), (3, 1, 6, 1)]


def build_mnasnet(scale: float = 2.0, num_classes: int = 1000,
                  variant: str = "imagenet"):
    """variant='cifar' keeps the topology but moves the stem and the first
    two stack downsamples to stride 1, so 32x32 inputs keep a 4x4 head
    map (as mobilenetv2.build_mobilenetv2 does)."""
    small = variant == "cifar"
    d = _get_depths(scale)
    nodes = [
        _conv("model.layers.0", 3, d[0], 3, 1 if small else 2, 1,
              act="relu"),
        _conv("model.layers.3", d[0], d[0], 3, 1, 1, groups=d[0], act="relu"),
        _conv("model.layers.6", d[0], d[1], 1, 1, 0),
    ]
    stacks = _STACKS
    if small:
        stacks = [(3, 1, 3, 3), (5, 1, 3, 3)] + _STACKS[2:]
    cin = d[1]
    for si, (k, s, e, n) in enumerate(stacks):
        cout = d[2 + si]
        for i in range(n):
            nodes.append(_inverted_residual(
                f"model.layers.{8 + si}.{i}", cin, cout, k,
                s if i == 0 else 1, e))
            cin = cout
    nodes.append(_conv("model.layers.14", cin, 1280, 1, 1, 0, act="relu"))
    nodes.append(OpSpec("model.avgpool", "gap"))
    nodes.append(UnitSpec("model.classifier.1", "linear",
                          in_ch=1280, out_ch=num_classes))
    return tuple(nodes)


def torch_key_map(graph):
    """unit name -> (conv_prefix, bn_prefix | None) in a torchvision
    MNASNet state dict: sequential indices, the BN of ``<head>.<j>`` is
    ``<head>.<j+1>``; the classifier has none."""
    m = {}
    for u in iter_units(graph):
        tname = u.name.removeprefix("model.")
        if not u.has_bn:
            m[u.name] = (tname, None)
        else:
            head, j = tname.rsplit(".", 1)
            m[u.name] = (tname, f"{head}.{int(j) + 1}")
    return m
