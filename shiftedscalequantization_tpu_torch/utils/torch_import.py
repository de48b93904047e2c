"""Import pretrained torch checkpoints into raw graph params (PyTorch port
of ``shiftedscalequantization_tpu/utils/torch_import.py``).

Replaces the reference's hubconf downloads (trash/hubconf.py:16-68) with an
offline converter: given a torch state dict (or a .pth / .pth.tar path) and
a model's torch_key_map, produce the raw params (conv weights OIHW, linear
(O, I): torch's own layout, so nothing is transposed) with the BN stats
attached for fold_bn. ``random_state_dict`` draws such a state dict with
numpy, for checkpoints made without a download.
"""
from __future__ import annotations

import pickle
from typing import Mapping

import numpy as np
import torch

from .._device import resolve_device
from ..graph import Graph, iter_units


def _to_tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu()
    return torch.as_tensor(np.asarray(t))


def load_state_dict(path: str) -> dict:
    """Load a torch checkpoint file to a {key: CPU tensor} dict: a flat
    state dict, ``{'state_dict': sd}``, or the BRECQ release's
    ``{'model': sd}`` (reference trash/hubconf.py:38); a DataParallel
    ``module.`` prefix is stripped. Only tensors, containers and numbers
    are unpickled (``weights_only=True``): a checkpoint that holds other
    objects is refused rather than run."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"--pretrained {path}: the checkpoint holds objects other than "
            "tensors, containers and numbers, which torch.load(..., "
            f"weights_only=True) refuses to unpickle ({e})") from e
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model" in sd \
            and not any(hasattr(v, "shape") for v in sd.values()):
        sd = sd["model"]
    return {k.removeprefix("module."): _to_tensor(v) for k, v in sd.items()}


def params_from_state_dict(graph: Graph, key_map: Mapping[str, tuple],
                           sd: Mapping[str, object], device="cuda",
                           dtype=torch.float32) -> dict:
    """Raw params {unit: {'w', 'b'?, 'bn'?}} from a torch state dict, as
    ``dtype`` tensors on ``device``."""
    dev = resolve_device(device)

    def get(key):
        return _to_tensor(sd[key]).to(device=dev, dtype=dtype)

    params = {}
    for u in iter_units(graph):
        conv_key, bn_key = key_map[u.name]
        p = {"w": get(f"{conv_key}.weight")}
        if f"{conv_key}.bias" in sd:
            p["b"] = get(f"{conv_key}.bias")
        if bn_key is not None:
            bn = {"mean": get(f"{bn_key}.running_mean"),
                  "var": get(f"{bn_key}.running_var")}
            if f"{bn_key}.weight" in sd:
                bn["gamma"] = get(f"{bn_key}.weight")
                bn["beta"] = get(f"{bn_key}.bias")
            p["bn"] = bn
        params[u.name] = p
    return params


def random_state_dict(graph: Graph, key_map: Mapping[str, tuple], seed=0,
                      bn_gamma=(0.8, 1.2), bn_beta_std=0.05,
                      bn_mean_std=0.05, bn_var=(0.8, 1.2)) -> dict:
    """A torchvision-layout state dict for ``graph`` drawn with numpy
    (``default_rng(seed)``): He-normal conv and linear weights, zero linear
    bias; BN weight U(bn_gamma), bias N(0, bn_beta_std), running mean
    N(0, bn_mean_std), running var U(bn_var), drawn in that order for each
    unit; and the num_batches_tracked counters the importers ignore."""
    rng = np.random.default_rng(seed)
    sd = {}
    for u in iter_units(graph):
        conv, bn = key_map[u.name]
        shape = (u.out_ch, u.in_ch // u.groups, *u.kernel) \
            if u.kind == "conv" else (u.out_ch, u.in_ch)
        fan_in = int(np.prod(shape[1:]))
        sd[f"{conv}.weight"] = torch.as_tensor(
            rng.standard_normal(shape, dtype=np.float32)
            * np.float32(np.sqrt(2.0 / fan_in)))
        c = u.out_ch
        if bn is None:
            sd[f"{conv}.bias"] = torch.zeros(c)
            continue
        for name, v in (("weight", rng.uniform(*bn_gamma, c)),
                        ("bias", rng.normal(0.0, bn_beta_std, c)),
                        ("running_mean", rng.normal(0.0, bn_mean_std, c)),
                        ("running_var", rng.uniform(*bn_var, c))):
            sd[f"{bn}.{name}"] = torch.as_tensor(v.astype(np.float32))
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
    return sd
