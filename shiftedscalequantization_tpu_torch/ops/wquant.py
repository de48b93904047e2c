"""Weight quantizers (PyTorch port of
``shiftedscalequantization_tpu/ops/wquant.py``).

Each quantizer is a plain dataclass whose tensors are its state and whose
mode switches (``soft``, ``hard_targets``, ``dequant``, ...) are Python
values; ``apply_weight_quant`` calls it on a weight:

  * UniformWQ      -- plain STE uniform affine fake-quant (the fake-quant
                      kernel, ``ops/cuda/fake_quant.py``)
  * AdaRoundWQ     -- AdaRound learned rounding, optionally on baked shifts
                      (``st_index`` into ``shift_targets``)
  * ShiftedScaleWQ -- the paper's shifted-scale selection with AdaRound
                      rounding (fused 'adaShift' codes, or the two-phase
                      full fake-quant candidates)
  * InpScaleWQ     -- closed-form per-input-channel scale

The candidate precompute is a stacked (S, *w.shape) tensor and the soft or
hard selection is an einsum over S, as in the JAX package. For convs the
selection is per input channel (alpha (IC, S)); for linear layers per
(OC, IC) pair (alpha (OC, IC, S)). ``torch.argmax``/``argmin`` take the
first extremum, as ``jnp.argmax``/``argmin`` do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import quant as Q
from .cuda.fake_quant import fake_quant_weight
from .quant import QParams


def _bshape(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Broadcast per-out-channel (OC, 1) params against an (OC, ...) weight;
    0-d and full-rank params pass through."""
    if a.ndim == 0 or a.ndim == w.ndim:
        return a
    return a.reshape((a.shape[0],) + (1,) * (w.ndim - 1))


def _targets(shift_targets, w: torch.Tensor) -> torch.Tensor:
    return torch.tensor(shift_targets, dtype=w.dtype, device=w.device)


# ---------------------------------------------------------------------------
# Uniform
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UniformWQ:
    """Plain STE uniform affine fake-quant (per-out-channel delta)."""
    qp: QParams

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        return fake_quant_weight(w, self.qp.delta, self.qp.zero_point,
                                 self.qp.n_bits, self.qp.sym)


# ---------------------------------------------------------------------------
# AdaRound
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdaRoundWQ:
    """AdaRound learned rounding: floor(w/delta) + h(alpha) (soft) or
    [alpha >= 0] (hard), clamp, dequant.

    ``signed_clamp`` clamps sym-aware (the shifted-scale family's rule);
    otherwise the clamp is unsigned. With ``st_index`` set, the effective
    delta is the per-OC ``qp.delta`` times ``shift_targets[st_index]``,
    st_index per input channel (conv) or per (oc, ic) pair (linear): the
    baked form that deploys as grouped integer convs with a
    per-(group, OC) scale table."""
    qp: QParams
    alpha: torch.Tensor               # weight-shaped rounding logits
    soft: bool = True
    signed_clamp: bool = False
    st_index: Optional[torch.Tensor] = None
    shift_targets: Tuple[float, ...] = ()

    def _delta(self, w):
        delta = _bshape(self.qp.delta, w)
        if self.st_index is not None:
            st = _targets(self.shift_targets, w)[self.st_index]
            if self.st_index.ndim == 1 and w.ndim == 4:
                st = st.reshape(1, -1, 1, 1)
            delta = delta * st
        return delta

    def _clip_range(self):
        if self.signed_clamp and self.qp.sym:
            return -(self.qp.n_levels // 2), self.qp.n_levels // 2 - 1
        return 0, self.qp.n_levels - 1

    def __call__(self, w):
        delta = self._delta(w)
        zp = _bshape(self.qp.zero_point, w)
        x_floor = torch.floor(w / delta)
        if self.soft:
            x_int = x_floor + Q.rectified_sigmoid(self.alpha)
        else:
            x_int = x_floor + (self.alpha >= 0).to(w.dtype)
        lo, hi = self._clip_range()
        x_q = Q.clip(x_int + zp, lo, hi)
        return (x_q - zp) * delta


def init_adaround(qp: QParams, w: torch.Tensor) -> AdaRoundWQ:
    """alpha with rectified_sigmoid(alpha) = frac(w / delta)."""
    delta = _bshape(qp.delta, w)
    rest = w / delta - torch.floor(w / delta)
    return AdaRoundWQ(qp=qp, alpha=Q.inverse_rectified_sigmoid(rest),
                      soft=True)


# ---------------------------------------------------------------------------
# Shifted scale (the paper's method)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShiftedScaleWQ:
    """Shifted-scale selection over |S| candidates with AdaRound rounding.

    ``codes=True`` (fused 'adaShift'): ``x_q[s] = floor(w / (delta *
    shift_targets[s]))`` are floor codes; forward mixes them by the
    selection (soft, or one-hot at the argmax when ``hard_targets``), adds
    the rounding offset h(beta) (or [beta >= 0] when ``hard_round``),
    clamps and dequantizes. ``dequant='unit'`` dequantizes the mixed codes
    at the base delta (the reference's fused semantics, sane for near-1
    targets); ``'effective'`` mixes per-candidate values each dequantized
    at delta * st (the paper's step-size semantics, needed for coarse sets
    such as {1/2, 1}). ``codes=False`` (two-phase): ``x_q`` are full
    fake-quant values and forward is the bare mixture."""
    qp: QParams
    alpha: torch.Tensor
    beta: Optional[torch.Tensor]
    x_q: torch.Tensor                 # (S, *w.shape)
    shift_targets: Tuple[float, ...]
    hard_targets: bool = False
    hard_round: bool = False
    codes: bool = True
    dequant: str = "unit"

    def soft_targets(self):
        return Q.rectified_softmax(self.alpha, axis=-1)

    def _selection(self, dtype):
        p = self.soft_targets()
        if self.hard_targets:
            p = F.one_hot(torch.argmax(p, dim=-1),
                          len(self.shift_targets)).to(dtype)
        return p

    def mix_codes(self, dtype=torch.float32):
        """Soft or hard mixture of the candidate codes."""
        return _mix(self.x_q, self._selection(dtype))

    def __call__(self, w):
        if not self.codes:
            return self.mix_codes(w.dtype)
        delta = _bshape(self.qp.delta, w)
        zp = _bshape(self.qp.zero_point, w)
        lo, hi = self.qp.qrange()
        if self.hard_round:
            off = (self.beta >= 0).to(w.dtype)
        else:
            off = Q.rectified_sigmoid(self.beta)
        if self.dequant == "effective":
            # mix the per-candidate dequantized values; the hard form is
            # AdaRoundWQ with st_index = argmax (shifted_to_baked)
            sts = _targets(self.shift_targets, w).reshape(
                (-1,) + (1,) * w.ndim)
            vals = (Q.clip(self.x_q + off[None] + zp[None], lo, hi)
                    - zp[None]) * (delta[None] * sts)
            return _mix(vals, self._selection(w.dtype))
        x_int = self.mix_codes(w.dtype) + off
        x_q = Q.clip(x_int + zp, lo, hi)
        return (x_q - zp) * delta

    def effective_delta(self, w):
        """Per-(oc, ic) delta * shift_targets[argmax p]."""
        delta = _bshape(self.qp.delta, w)
        idx = torch.argmax(self.soft_targets(), dim=-1)
        st = _targets(self.shift_targets, w)[idx]
        if self.alpha.ndim == 2 and w.ndim == 4:   # conv: (IC,) -> (1,IC,1,1)
            st = st.reshape(1, -1, 1, 1)
        return delta * st


def _mix(x_q, p):
    """Mix stacked candidates x_q (S, OC, IC[, KH, KW]) with selection
    probabilities p (IC, S) or (OC, IC, S)."""
    if x_q.ndim == 5:
        if p.ndim == 2:                       # conv, per input channel
            return torch.einsum("soihw,is->oihw", x_q, p)
        return torch.einsum("soihw,ois->oihw", x_q, p)
    if p.ndim == 2 and p.shape[0] == x_q.shape[2]:
        return torch.einsum("soi,is->oi", x_q, p)
    return torch.einsum("soi,ois->oi", x_q, p)


def _selection_mse(w, x_q, per_pair: bool):
    """Per-selection-group candidate squared error: (S, IC) for a conv
    (summed over OC, KH, KW), (S, OC, IC) elementwise otherwise."""
    d2 = (w[None] - x_q) ** 2
    if w.ndim == 4 and not per_pair:
        return d2.sum(dim=(1, 3, 4))
    return d2


def init_alpha_from_mse(w, x_q, n_targets: int, clip: float = 0.33):
    """Selection logits from the per-group MSE argmin: the argmin candidate
    gets probability ``clip``, the others share 1 - clip."""
    per_pair = w.ndim != 4
    min_index = torch.argmin(_selection_mse(w, x_q, per_pair), dim=0)
    if n_targets == 1:
        p = torch.ones(min_index.shape + (1,), dtype=w.dtype,
                       device=w.device)
    else:
        remain = (1.0 - clip) / (n_targets - 1)
        onehot = F.one_hot(min_index, n_targets).to(w.dtype)
        p = onehot * clip + (1.0 - onehot) * remain
    return Q.inverse_rectified_softmax(p, axis=-1)


def init_shifted_scale(qp: QParams, w: torch.Tensor,
                       shift_targets: Tuple[float, ...],
                       clip: Optional[float] = None,
                       dequant: str = "unit") -> ShiftedScaleWQ:
    """Fused shift+round init: floor codes per candidate, selection from
    the MSE argmin rule, then beta with rectified_sigmoid(beta) =
    frac(w / effective_delta). For dequant='effective' the MSE compares
    the dequantized candidate values with w."""
    delta = _bshape(qp.delta, w)
    zp = _bshape(qp.zero_point, w)
    lo, hi = qp.qrange()
    sts = _targets(shift_targets, w)
    x_q = torch.stack([torch.floor(w / (delta * st)) for st in sts])
    if dequant == "effective":
        mse_cands = torch.stack([
            (torch.clamp(torch.round(w / (delta * st)) + zp, lo, hi) - zp)
            * (delta * st) for st in sts])
        # the argmin must be the argmax of p: 0.33 would invert the order
        # for |S| = 3
        default_clip = max(0.90 - 0.05 * len(shift_targets), 0.5)
    else:
        mse_cands = x_q
        default_clip = 0.33
    alpha = init_alpha_from_mse(w, mse_cands, len(shift_targets),
                                clip=default_clip if clip is None else clip)
    wq = ShiftedScaleWQ(qp=qp, alpha=alpha, beta=torch.zeros_like(w),
                        x_q=x_q, shift_targets=tuple(shift_targets),
                        dequant=dequant)
    return warmstart_alpha(wq, alpha, w)


def init_shifted_scale_twophase(qp: QParams, w: torch.Tensor,
                                shift_targets: Tuple[float, ...],
                                clip: Optional[float] = None
                                ) -> ShiftedScaleWQ:
    """Two-phase shift-phase init: candidates are full fake-quant values at
    each shifted step; forward is the bare mixture."""
    delta = _bshape(qp.delta, w)
    zp = _bshape(qp.zero_point, w)
    lo, hi = qp.qrange()
    cands = []
    for st in _targets(shift_targets, w):
        x_qc = torch.clamp(torch.round(w / (delta * st)) + zp, lo, hi)
        cands.append((x_qc - zp) * (delta * st))
    x_q = torch.stack(cands)
    alpha = init_alpha_from_mse(w, x_q, len(shift_targets),
                                clip=0.33 if clip is None else clip)
    return ShiftedScaleWQ(qp=qp, alpha=alpha, beta=None, x_q=x_q,
                          shift_targets=tuple(shift_targets), codes=False)


def warmstart_alpha(wq: ShiftedScaleWQ, alpha: torch.Tensor,
                    w: torch.Tensor) -> ShiftedScaleWQ:
    """Re-seed a fused quantizer's selection with ``alpha`` and re-derive
    the rounding logits on the new argmax grid."""
    wq = dataclasses.replace(wq, alpha=alpha)
    delta_eff = wq.effective_delta(w)
    rest = w / delta_eff - torch.floor(w / delta_eff)
    return dataclasses.replace(wq, beta=Q.inverse_rectified_sigmoid(rest))


def bake_shift_to_adaround(wq: ShiftedScaleWQ, w: torch.Tensor
                           ) -> AdaRoundWQ:
    """Two-phase transition: bake the chosen shifts (factorized as
    st_index) into AdaRound, rounding logits from frac(w / delta_eff)."""
    out = AdaRoundWQ(qp=wq.qp, alpha=torch.zeros_like(w), soft=True,
                     signed_clamp=True,
                     st_index=torch.argmax(wq.soft_targets(), dim=-1),
                     shift_targets=tuple(wq.shift_targets))
    delta_eff = out._delta(w)
    rest = w / delta_eff - torch.floor(w / delta_eff)
    return dataclasses.replace(out, alpha=Q.inverse_rectified_sigmoid(rest))


def shifted_to_baked(wq: ShiftedScaleWQ) -> AdaRoundWQ:
    """Harden a fused effective-dequant ShiftedScaleWQ into the baked form:
    hard AdaRoundWQ with st_index = argmax(selection) and the rounding
    logits carried over; value-identical to the hard effective forward."""
    return AdaRoundWQ(qp=wq.qp, alpha=wq.beta, soft=False,
                      signed_clamp=True,
                      st_index=torch.argmax(wq.soft_targets(), dim=-1),
                      shift_targets=tuple(wq.shift_targets))


def rank_shift_candidates(qp: QParams, w: torch.Tensor,
                          num_of_candi: int = 3) -> Tuple[float, ...]:
    """Data-driven candidate set over {1/8 .. 15/8} without 1 by rank
    voting per selection group; 1.0 is always appended."""
    delta = _bshape(qp.delta, w)
    zp = _bshape(qp.zero_point, w)
    lo, hi = qp.qrange()
    candidates = [i / 8 for i in range(1, 16) if i != 8]
    mses = []
    for st in candidates:
        x_q = torch.clamp(torch.round(w / (delta * st)) + zp, lo, hi)
        e = torch.abs((x_q - zp) * (delta * st) - w) ** 2.4
        mses.append(e.sum(dim=(0, 2, 3)) if w.ndim == 4 else e.sum(dim=0))
    order = torch.argsort(torch.stack(mses), dim=0,
                          stable=True)[:num_of_candi]
    weights = torch.arange(num_of_candi, 0, -1, device=w.device)[:, None]
    scores = torch.zeros(len(candidates), dtype=torch.float32,
                         device=w.device)
    scores.index_add_(0, order.reshape(-1),
                      weights.expand(order.shape).reshape(-1).float())
    top = torch.argsort(-scores, stable=True)[: num_of_candi - 1]
    return tuple([candidates[int(i)] for i in top.tolist()] + [1.0])


# ---------------------------------------------------------------------------
# Closed-form input-channel scale
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InpScaleWQ:
    """Per-input-channel scale quantizer: zp = round(raw_zp / delta);
    round(w / inp_scale / delta) + zp, unsigned clamp, dequant at
    delta * inp_scale."""
    qp: QParams
    raw_zero_point: torch.Tensor
    inp_scale: torch.Tensor          # (1, IC, KH, KW) conv / (1, IC) linear

    def __call__(self, w):
        delta = _bshape(self.qp.delta, w)
        zp = torch.round(_bshape(self.raw_zero_point, w) / delta)
        x_int = Q.round_ste(w / self.inp_scale / delta) + zp
        x_q = Q.clip(x_int, 0, self.qp.n_levels - 1)
        return (x_q - zp) * delta * self.inp_scale


def init_inp_scale(qp: QParams, raw_zp: torch.Tensor, w: torch.Tensor,
                   level: int = 1, threshold: float = 1.0) -> InpScaleWQ:
    """Range-fit rule: for c = level/level .. 1/level, keep per element the
    last c whose normalized codes, reduced over the out-channel axis, stay
    within half a step (times ``threshold``) of [0, 1]."""
    delta = _bshape(qp.delta, w)
    zp = torch.round(_bshape(raw_zp, w) / delta)
    x_range = qp.n_levels - 1
    min_lim = 0.0 - 0.5 / x_range * threshold
    max_lim = 1.0 + 0.5 / x_range * threshold
    inp_scale = torch.ones((1,) + tuple(w.shape[1:]), dtype=w.dtype,
                           device=w.device)
    for i in range(level, 0, -1):
        c = i / level
        x_norm = (w / c / delta + zp) / x_range
        ok = ((x_norm.amin(dim=0, keepdim=True) > min_lim)
              & (x_norm.amax(dim=0, keepdim=True) < max_lim))
        inp_scale = torch.where(ok, torch.full_like(inp_scale, c), inp_scale)
    return InpScaleWQ(qp=qp, raw_zero_point=raw_zp, inp_scale=inp_scale)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def apply_weight_quant(wq, w: torch.Tensor) -> torch.Tensor:
    if wq is None:
        return w
    return wq(w)
