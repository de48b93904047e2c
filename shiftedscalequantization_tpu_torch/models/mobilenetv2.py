"""MobileNetV2 as an explicit graph (PyTorch port of
``shiftedscalequantization_tpu/models/mobilenetv2.py``).

Inverted-residual blocks map onto the generic BlockSpec: expand_ratio == 1
-> (dw 3x3 relu6, project 1x1 without act quant); otherwise (expand 1x1
relu6, dw 3x3 relu6, project 1x1 without act quant). The residual add is
taken iff stride == 1 and in == out; there is no post-add activation.
"""
from __future__ import annotations

from ..graph import BlockSpec, OpSpec, UnitSpec, iter_units
from .resnet import init_params  # noqa: F401  (the shared initializer)


def _conv(name, cin, cout, k, s, p, groups=1, act=None, disable_aq=False):
    return UnitSpec(name=name, kind="conv", in_ch=cin, out_ch=cout,
                    kernel=(k, k), stride=(s, s), padding=(p, p),
                    groups=groups, activation=act,
                    disable_act_quant=disable_aq, has_bn=True)


# (t, c, n, s) rows of torchvision's mobilenet_v2
_SETTINGS = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


def _inverted_residual(name, cin, cout, stride, t):
    hidden = round(cin * t)
    use_res = stride == 1 and cin == cout
    if t == 1:
        units = (
            _conv(f"{name}.conv.0", hidden, hidden, 3, stride, 1,
                  groups=hidden, act="relu6"),
            _conv(f"{name}.conv.3", hidden, cout, 1, 1, 0, disable_aq=True),
        )
    else:
        units = (
            _conv(f"{name}.conv.0", cin, hidden, 1, 1, 0, act="relu6"),
            _conv(f"{name}.conv.3", hidden, hidden, 3, stride, 1,
                  groups=hidden, act="relu6"),
            _conv(f"{name}.conv.6", hidden, cout, 1, 1, 0, disable_aq=True),
        )
    return BlockSpec(name=name, units=units, downsample=None,
                     residual=use_res, post_activation=None)


def build_mobilenetv2(num_classes: int = 1000, width_mult: float = 1.0,
                      variant: str = "imagenet"):
    """variant='cifar' keeps the block topology but moves the stem and the
    first two downsamples to stride 1, for 32x32 inputs."""
    small = variant == "cifar"
    input_channel = int(32 * width_mult)
    last_channel = int(1280 * width_mult) if width_mult > 1.0 else 1280
    nodes = [_conv("model.features.0.0", 3, input_channel, 3,
                   1 if small else 2, 1, act="relu6")]
    idx = 1
    cin = input_channel
    settings = _SETTINGS
    if small:
        settings = [(t, c, n, 1) for (t, c, n, s) in _SETTINGS[:2]] \
            + list(_SETTINGS[2:])
    for t, c, n, s in settings:
        cout = int(c * width_mult)
        for i in range(n):
            nodes.append(_inverted_residual(
                f"model.features.{idx}", cin, cout, s if i == 0 else 1, t))
            cin = cout
            idx += 1
    nodes.append(_conv(f"model.features.{idx}.0", cin, last_channel, 1, 1, 0,
                       act="relu6"))
    nodes.append(OpSpec("model.avgpool", "gap"))
    nodes.append(UnitSpec("model.classifier.1", "linear",
                          in_ch=last_channel, out_ch=num_classes))
    return tuple(nodes)


def torch_key_map(graph):
    """unit name -> (conv_prefix, bn_prefix | None) in a torchvision
    MobileNetV2 state dict: the BN of ``<head>.<j>`` is ``<head>.<j+1>``;
    the classifier has none."""
    m = {}
    for u in iter_units(graph):
        tname = u.name.removeprefix("model.")
        if not u.has_bn:
            m[u.name] = (tname, None)
        else:
            head, j = tname.rsplit(".", 1)
            m[u.name] = (tname, f"{head}.{int(j) + 1}")
    return m
