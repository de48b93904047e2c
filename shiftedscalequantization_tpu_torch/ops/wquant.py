"""Weight quantizers (PyTorch port of
``shiftedscalequantization_tpu/ops/wquant.py:43,468``).

Only ``UniformWQ`` is ported: the serving slice converts uniform
per-channel weight quantizers. AdaRound, shifted-scale and input-scale
quantizers come with the reconstruction slice.
"""
from __future__ import annotations

import dataclasses

import torch

from . import quant as Q
from .quant import QParams


@dataclasses.dataclass
class UniformWQ:
    """Plain STE uniform affine fake-quant (per-out-channel delta)."""
    qp: QParams

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        delta = _bshape(self.qp.delta, w)
        zp = _bshape(self.qp.zero_point, w)
        lo, hi = self.qp.qrange()
        x_int = Q.round_ste(w / delta) + zp
        return (torch.clamp(x_int, lo, hi) - zp) * delta


def _bshape(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Broadcast per-out-channel (OC, 1) params against an (OC, ...) weight;
    0-d and full-rank params pass through."""
    if a.ndim == 0 or a.ndim == w.ndim:
        return a
    return a.reshape((a.shape[0],) + (1,) * (w.ndim - 1))


def apply_weight_quant(wq, w: torch.Tensor) -> torch.Tensor:
    if wq is None:
        return w
    return wq(w)
