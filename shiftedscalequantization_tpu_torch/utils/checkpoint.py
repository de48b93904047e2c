"""Checkpoint and resume for quantization state (PyTorch port of
``shiftedscalequantization_tpu/utils/checkpoint.py``).

The whole quantization state is one tree of the port's dataclasses
(UnitQuant, the weight quantizers, QParams) whose structure says which
quantizer class, hardened or not, which shift targets; the file pickles
that tree with every tensor as a CPU numpy array, so a checkpoint is
self-describing and needs no template on restore. The payload is the JAX
package's: ``<path>.pkl`` holding ``{"qstate", "done"}``, where ``done``
lists the reconstructed targets (per-layer resume). A JAX package pickle
names its own classes and does not load here.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

from .._device import resolve_device
from ..quantize import to_device, to_numpy


def save_qstate(path: str, qstate, done: Optional[list] = None):
    """Save qstate (+ per-layer done-list) to ``path``.pkl."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"qstate": to_numpy(qstate), "done": list(done or [])}
    with open(path + ".pkl", "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_qstate(path: str, device="cuda"):
    """Restore (qstate with tensors on ``device``, done_list)."""
    path = os.path.abspath(path)
    with open(path + ".pkl", "rb") as f:
        payload = pickle.load(f)
    return (to_device(payload["qstate"], resolve_device(device)),
            payload.get("done", []))


def exists(path: str) -> bool:
    return os.path.exists(os.path.abspath(path) + ".pkl")
