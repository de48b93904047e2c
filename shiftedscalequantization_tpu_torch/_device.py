"""Device selection shared by the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``). A CUDA request on a
machine without a card raises instead of quietly running on the CPU; the CPU
path is taken only when the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev
