"""ResNet family (ImageNet and CIFAR variants) as explicit graphs (PyTorch
port of ``shiftedscalequantization_tpu/models/resnet.py:63,100,120``).

conv2 and downsample of each block have ``disable_act_quant=True``; the
post-add ReLU and the block-level act quantizer belong to the BlockSpec.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .._device import resolve_device
from ..graph import BlockSpec, OpSpec, UnitSpec, iter_units


def _conv(name, cin, cout, k, s, p, act=None, disable_aq=False, groups=1):
    return UnitSpec(name=name, kind="conv", in_ch=cin, out_ch=cout,
                    kernel=(k, k), stride=(s, s), padding=(p, p),
                    groups=groups, activation=act,
                    disable_act_quant=disable_aq, has_bn=True)


def _basic_block(name, cin, cout, stride):
    units = (
        _conv(f"{name}.conv1", cin, cout, 3, stride, 1, act="relu"),
        _conv(f"{name}.conv2", cout, cout, 3, 1, 1, disable_aq=True),
    )
    down = None
    if stride != 1 or cin != cout:
        down = _conv(f"{name}.downsample.0", cin, cout, 1, stride, 0,
                     disable_aq=True)
    return BlockSpec(name=name, units=units, downsample=down,
                     residual=True, post_activation="relu")


def _bottleneck(name, cin, width, cout, stride):
    units = (
        _conv(f"{name}.conv1", cin, width, 1, 1, 0, act="relu"),
        _conv(f"{name}.conv2", width, width, 3, stride, 1, act="relu"),
        _conv(f"{name}.conv3", width, cout, 1, 1, 0, disable_aq=True),
    )
    down = None
    if stride != 1 or cin != cout:
        down = _conv(f"{name}.downsample.0", cin, cout, 1, stride, 0,
                     disable_aq=True)
    return BlockSpec(name=name, units=units, downsample=down,
                     residual=True, post_activation="relu")


def build_resnet(depth: int = 18, num_classes: int = 1000,
                 variant: str = "imagenet"):
    """Build the graph. variant: 'imagenet' | 'cifar'."""
    cfgs = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
            50: ("bottleneck", (3, 4, 6, 3)),
            101: ("bottleneck", (3, 4, 23, 3)),
            152: ("bottleneck", (3, 8, 36, 3))}
    kind, layers = cfgs[depth]
    expansion = 1 if kind == "basic" else 4
    nodes = []
    if variant == "imagenet":
        nodes.append(_conv("model.conv1", 3, 64, 7, 2, 3, act="relu"))
        nodes.append(OpSpec("model.maxpool", "maxpool",
                            window=(3, 3), stride=(2, 2), padding=(1, 1)))
    else:  # CIFAR stem: 3x3 stride 1, no maxpool
        nodes.append(_conv("model.conv1", 3, 64, 3, 1, 1, act="relu"))
    cin = 64
    for stage, n_blocks in enumerate(layers):
        planes = 64 * (2 ** stage)
        cout = planes * expansion
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            name = f"model.layer{stage + 1}.{b}"
            if kind == "basic":
                nodes.append(_basic_block(name, cin, cout, stride))
            else:
                nodes.append(_bottleneck(name, cin, planes, cout, stride))
            cin = cout
    nodes.append(OpSpec("model.avgpool", "gap"))
    nodes.append(UnitSpec(name="model.fc", kind="linear", in_ch=cin,
                          out_ch=num_classes))
    return tuple(nodes)


def init_unit_params(spec: UnitSpec, generator: torch.Generator,
                     device, dtype=torch.float32):
    """He-normal conv/linear init + identity BN stats (random baseline)."""
    if spec.kind == "conv":
        shape = (spec.out_ch, spec.in_ch // spec.groups, *spec.kernel)
        fan_in = shape[1] * shape[2] * shape[3]
    else:
        shape = (spec.out_ch, spec.in_ch)
        fan_in = spec.in_ch
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=dtype) * math.sqrt(2.0 / fan_in)
    p = {"w": w}
    c = spec.out_ch
    if spec.has_bn:
        p["bn"] = {"gamma": torch.ones(c, dtype=dtype, device=device),
                   "beta": torch.zeros(c, dtype=dtype, device=device),
                   "mean": torch.zeros(c, dtype=dtype, device=device),
                   "var": torch.ones(c, dtype=dtype, device=device)}
    else:
        p["b"] = torch.zeros(c, dtype=dtype, device=device)
    return p


def init_params(graph, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                device="cuda", dtype=torch.float32):
    """Seeded random raw params. The draws differ from the JAX package's:
    parity tests carry one set of weights to both (utils/jax_import)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return {u.name: init_unit_params(u, generator, dev, dtype)
            for u in iter_units(graph)}


def torch_key_map(graph):
    """unit name -> (conv_prefix, bn_prefix | None) in a torchvision-style
    state dict (convN <-> bnN; stem conv1 <-> bn1; downsample.0 <->
    downsample.1)."""
    m = {}
    for u in iter_units(graph):
        tname = u.name.removeprefix("model.")
        if not u.has_bn:
            m[u.name] = (tname, None)
        elif tname == "conv1":
            m[u.name] = (tname, "bn1")
        elif tname.endswith("downsample.0"):
            m[u.name] = (tname, tname[:-1] + "1")
        else:
            head, leaf = tname.rsplit(".", 1)
            m[u.name] = (tname, f"{head}.bn{leaf[-1]}")
    return m
