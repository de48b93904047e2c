"""Model registry (PyTorch port of
``shiftedscalequantization_tpu/models/zoo.py``): ResNet, MobileNetV2,
RegNetX and MNASNet (scale 2.0)."""
from __future__ import annotations

from . import mnasnet, mobilenetv2, regnet, resnet
from .resnet import init_params  # noqa: F401


def build(arch: str, num_classes: int | None = None,
          dataset: str = "imagenet"):
    """Returns (graph, torch_key_map_fn); 32x32 datasets take the CIFAR
    variant."""
    small = dataset in ("cifar10", "digits", "synth10")
    nc = num_classes if num_classes is not None else (10 if small else 1000)
    variant = "cifar" if small else "imagenet"
    if arch.startswith("resnet"):
        depth = int(arch.removeprefix("resnet"))
        g = resnet.build_resnet(depth, num_classes=nc, variant=variant)
        return g, resnet.torch_key_map
    if arch == "mobilenetv2":
        g = mobilenetv2.build_mobilenetv2(num_classes=nc, variant=variant)
        return g, mobilenetv2.torch_key_map
    if arch.startswith("regnetx"):
        g = regnet.build_regnetx(arch, num_classes=nc, variant=variant)
        return g, regnet.torch_key_map
    if arch == "mnasnet":
        g = mnasnet.build_mnasnet(scale=2.0, num_classes=nc, variant=variant)
        return g, mnasnet.torch_key_map
    raise ValueError(f"unknown arch {arch}")


ARCHS = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
         "mobilenetv2", "regnetx_200m", "regnetx_400m", "regnetx_600m",
         "regnetx_800m", "regnetx_1600m", "regnetx_3200m", "regnetx_4000m",
         "regnetx_6400m", "mnasnet"]
