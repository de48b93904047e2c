"""Raw-parameter (pre-fold) checkpoint IO (PyTorch port of
``shiftedscalequantization_tpu/train.py:230-253``).

The npz layout is the JAX trainer's: ``"<unit>/w"``, ``"<unit>/b"`` and
``"<unit>/bn/<stat>"``, so weights trained by either package load in the
other. The trainer itself is not ported yet (ROADMAP.md, 'Open items',
queue 1: tooling).
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device


def save_raw_params(path: str, raw: dict):
    """Write a raw-params dict of tensors or arrays to ``path`` (npz)."""
    def host(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)

    flat = {}
    for name, p in raw.items():
        flat[f"{name}/w"] = host(p["w"])
        if "b" in p:
            flat[f"{name}/b"] = host(p["b"])
        if "bn" in p:
            for k, v in p["bn"].items():
                flat[f"{name}/bn/{k}"] = host(v)
    np.savez(path, **flat)


def load_raw_params(path: str, device="cuda") -> dict:
    """Read an npz of raw params into a dict of tensors on ``device``."""
    dev = resolve_device(device)
    raw: dict = {}
    with np.load(path) as f:
        for key in f.files:
            parts = key.split("/")
            name = parts[0]
            raw.setdefault(name, {})
            t = torch.as_tensor(f[key], device=dev)
            if parts[1] == "bn":
                raw[name].setdefault("bn", {})[parts[2]] = t
            else:
                raw[name][parts[1]] = t
    return raw
