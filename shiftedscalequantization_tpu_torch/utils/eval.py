"""Evaluation harness (PyTorch port of
``shiftedscalequantization_tpu/utils/eval.py``): top-1/top-5 accuracy and
the golden-logit regression.

Functional equivalent of the reference's validate_model /
validate_with_loss (common.py:152-293). The hit counts stay on the device
until the end of the pass; the golden-logit file is the JAX package's
``.npz`` (one array, ``logits``), so a file written by either package
reads in the other.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..graph import Flags, Graph, forward


def _params_device(params) -> torch.device:
    for p in params.values():
        return p["w"].device
    raise ValueError("validate_model: empty params")


def validate_model(graph: Graph, params, qstate, data: Iterable,
                   flags: Flags = Flags(), topk=(1, 5),
                   return_logits: bool = False, max_batches: Optional[int] = None):
    """data yields (images NHWC, labels) as numpy or tensors; the forward
    runs on the device the params lie on. Returns a dict of top-k accuracy
    % (and the concatenated logits as numpy if requested, for golden-file
    regression)."""
    dev = _params_device(params)
    maxk = max(topk)
    totals = torch.zeros(len(topk), dtype=torch.int64, device=dev)
    n = 0
    logits_all = []
    with torch.no_grad():
        for i, (xb, yb) in enumerate(data):
            if max_batches is not None and i >= max_batches:
                break
            logits = forward(graph, params, qstate,
                             torch.as_tensor(xb, device=dev), flags,
                             device=dev)
            yb = torch.as_tensor(yb, device=dev).long()
            hit = torch.topk(logits, maxk, dim=-1).indices == yb[:, None]
            totals += torch.stack([hit[:, :k].any(dim=1).sum()
                                   for k in topk])
            n += xb.shape[0]
            if return_logits:
                logits_all.append(logits)
    counts = totals.tolist()
    acc = {f"top{k}": 100.0 * c / max(n, 1) for k, c in zip(topk, counts)}
    if return_logits:
        return acc, torch.cat(logits_all).cpu().numpy()
    return acc


def golden_logit_mse(logits: np.ndarray, path: str,
                     save_if_missing: bool = False) -> Optional[float]:
    """Golden-file logits regression (reference validate_with_loss,
    common.py:277-286). Returns MSE vs the stored file, or None after
    creating it."""
    if not os.path.exists(path):
        if save_if_missing:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            np.savez(path, logits=logits)
            return None
        raise FileNotFoundError(path)
    ref = np.load(path)["logits"]
    return float(np.mean((logits - ref) ** 2))


def get_train_samples(data: Iterable, num_samples: int = 1024,
                      device="cuda"):
    """First-N training images as the calibration set (reference
    common.py:144-150): one tensor on ``device``."""
    batches = []
    total = 0
    for xb, _ in data:
        batches.append(np.asarray(xb))
        total += xb.shape[0]
        if total >= num_samples:
            break
    return torch.as_tensor(np.concatenate(batches, axis=0)[:num_samples],
                           device=resolve_device(device))
