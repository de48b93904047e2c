"""Activation-side shifted-scale quantizer (PyTorch port of
``shiftedscalequantization_tpu/ops/act_quant.py``).

Per-channel selection among shifted activation scales (default {1, 1/2})
with the rectified-softmax relaxation of the weight side: each candidate is
the per-tensor fake-quant of the activation at step ``delta * st``, and the
candidates are mixed per channel (channels last) by the soft selection, or
by its one-hot argmax once hardened. A hardened selection is a per-channel
step (``effective_delta``), which deploy serves on f32 edges.

Each candidate runs through the fake-quant kernel
(``ops/cuda/fake_quant.fake_quant_act``): the CUDA kernel on the card, its
plain version on the CPU, one launch per candidate. The mix is a sum over
candidates of elementwise products (no einsum, which can reach a TF32 bmm
on the card). ``torch.argmax``/``argmin`` take the first extremum, as
``jnp.argmax``/``argmin`` do.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from . import quant as Q
from .cuda.fake_quant import fake_quant_act
from .quant import QParams


@dataclasses.dataclass
class ActShiftQuant:
    """Per-channel shifted-scale activation fake-quant (channels last)."""
    qp: QParams                       # base per-tensor delta / zero point
    alpha: torch.Tensor               # (C, S) selection logits
    shift_targets: Tuple[float, ...]
    hard_targets: bool = False

    def soft_targets(self):
        return Q.rectified_softmax(self.alpha, axis=-1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        p = self.soft_targets()
        if self.hard_targets:
            p = F.one_hot(torch.argmax(p, dim=-1),
                          len(self.shift_targets)).to(x.dtype)
        out = None
        for s, st in enumerate(self.shift_targets):
            xq = fake_quant_act(x, self.qp.delta * st, self.qp.zero_point,
                                self.qp.n_bits, self.qp.sym)
            term = xq * p[:, s]
            out = term if out is None else out + term
        return out

    def effective_delta(self) -> torch.Tensor:
        """Per-channel hardened step: delta * shift_targets[argmax p]."""
        idx = torch.argmax(self.soft_targets(), dim=-1)
        sts = torch.tensor(self.shift_targets, dtype=self.qp.delta.dtype,
                           device=self.qp.delta.device)
        return self.qp.delta * sts[idx]


def init_act_shift(qp: QParams, sample_nhwc: torch.Tensor,
                   shift_targets: Tuple[float, ...] = (1.0, 0.5),
                   clip: float = 0.8) -> ActShiftQuant:
    """Alpha from the per-channel MSE argmin of the candidates on a
    calibration sample (round, no STE): the argmin candidate gets
    ``clip``, the rest share 1 - clip, through the inverse rectified
    softmax."""
    lo, hi = qp.qrange()
    c = sample_nhwc.shape[-1]
    with torch.no_grad():
        mses = []
        for st in shift_targets:
            d = qp.delta * st
            q = torch.clamp(torch.round(sample_nhwc / d) + qp.zero_point,
                            lo, hi)
            e = ((q - qp.zero_point) * d - sample_nhwc) ** 2
            mses.append(e.reshape(-1, c).sum(dim=0))          # per channel
        min_index = torch.argmin(torch.stack(mses), dim=0)   # (C,)
    n = len(shift_targets)
    if n == 1:
        p = torch.ones((c, 1), dtype=sample_nhwc.dtype,
                       device=sample_nhwc.device)
    else:
        onehot = F.one_hot(min_index, n).to(sample_nhwc.dtype)
        p = onehot * clip + (1.0 - onehot) * ((1.0 - clip) / (n - 1))
    return ActShiftQuant(qp=qp, alpha=Q.inverse_rectified_softmax(p),
                         shift_targets=tuple(shift_targets))
