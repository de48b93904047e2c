"""Reconstruction engine, quantizer plumbing (PyTorch port of
``shiftedscalequantization_tpu/recon/engine.py:48-311, 690-709``).

Ported so far: the settings, the swap of each unit's weight quantizer for
the trainable form of a mode (``_init_quantizers``), the theta dict of
trainable tensors and its re-insertion, hardening, and the shift-selection
ratios. The optimizer loop, the losses and the activation phases are not
ported yet. ``ReconSettings`` keeps the JAX field names; ``chunk`` (the
TPU scan length) has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..graph import UnitQuant
from ..ops import wquant as W


@dataclasses.dataclass(frozen=True)
class ReconSettings:
    """Reconstruction hyperparameters (see the JAX ReconSettings for the
    meaning of each field)."""
    mode: str = "fused"
    iters: int = 20000
    batch_size: int = 32
    lr: float = 1e-3
    act_lr: float = 4e-4
    b_range: tuple = (20, 2)
    warmup: float = 0.2
    lmda_r: float = 0.01
    lmda_s: float = 0.1
    weight: float = 0.01
    p: Optional[float] = None
    shift_targets: tuple = (1.0 - 1.0 / 32, 1.0 + 1.0 / 32, 1.0)
    # fused candidate dequant: 'unit', 'effective', or 'auto' (effective
    # when max|st - 1| > 1/8)
    fused_dequant: str = "auto"
    opt_beta: bool = True
    opt_output_affine: bool = False
    grad_psum_axis: Optional[str] = None
    grad_wire: str = "f32"
    rec_loss: str = "mse"
    auto_candidates: bool = False
    act_p: float = 2.4
    post_round_frac: float = 0.5
    warmstart_frac: float = 0.0
    warmstart_freeze: bool = True
    warmstart_lr: Optional[float] = None
    act_shift_targets: tuple = (1.0, 0.5)


def resolve_dequant(dequant: str, shift_targets) -> str:
    """'auto' -> 'effective' for coarse candidate sets (max|st-1| > 1/8),
    'unit' for near-1 sets; 'unit'/'effective' pass through."""
    if dequant != "auto":
        return dequant
    return ("effective"
            if max(abs(float(t) - 1.0) for t in shift_targets) > 1.0 / 8
            else "unit")


def _skip_shift(qp, targets) -> bool:
    """8-bit units take plain AdaRound, no shift selection, when the
    candidate set is coarse; near-1 sets keep their selection."""
    return qp.n_bits >= 8 and \
        max(abs(float(t) - 1.0) for t in targets) > 1.0 / 8


def _init_quantizers(params, qstate, unit_names, s: ReconSettings,
                     warm_alphas=None):
    """Swap each unit's weight quantizer for the trainable form of
    ``s.mode`` and build the theta dict {unit: {name: tensor}} of what the
    loop optimizes. ``warm_alphas`` (fused warm start): unit name -> solved
    selection logits that re-seed that unit's alpha and beta."""
    qstate = dict(qstate)
    theta = {}
    for name in unit_names:
        uq: UnitQuant = qstate[name]
        w = params[name]["w"]
        qp = uq.wq.qp
        t = {}
        warm = bool(warm_alphas) and name in warm_alphas
        if s.mode == "fused":
            targets = W.rank_shift_candidates(qp, w) if s.auto_candidates \
                else s.shift_targets
            if _skip_shift(qp, targets):
                wq = W.init_adaround(qp, w)
                t["alpha"] = wq.alpha
            else:
                wq = W.init_shifted_scale(
                    qp, w, targets,
                    dequant=resolve_dequant(s.fused_dequant, targets))
                if warm:
                    wq = W.warmstart_alpha(wq, warm_alphas[name], w)
                    if s.warmstart_freeze:
                        # selection locked at the solved argmax
                        wq = dataclasses.replace(wq, hard_targets=True)
                if not (warm and s.warmstart_freeze):
                    t["alpha"] = wq.alpha
                if s.opt_beta:
                    t["beta"] = wq.beta
        elif s.mode == "brecq":
            wq = W.init_adaround(qp, w)
            t["alpha"] = wq.alpha
        elif s.mode == "shift":
            if _skip_shift(qp, s.shift_targets):
                wq = W.init_adaround(qp, w)
            else:
                wq = W.init_shifted_scale_twophase(qp, w, s.shift_targets)
            t["alpha"] = wq.alpha
        elif s.mode == "round":
            # phase 2 of two-phase: bake a hardened 'shift' quantizer, or
            # re-open an AdaRound one (8-bit units skipped the shift phase)
            prev = qstate[name].wq
            if isinstance(prev, W.AdaRoundWQ):
                wq = dataclasses.replace(prev, soft=True)
            else:
                wq = W.bake_shift_to_adaround(prev, w)
            t["alpha"] = wq.alpha
        elif s.mode == "round_refine":
            # post-harden refinement of a baked AdaRoundWQ: the selection
            # stays frozen, the rounding logits re-open
            wq = dataclasses.replace(qstate[name].wq, soft=True)
            t["alpha"] = wq.alpha
        else:
            raise ValueError(s.mode)
        if s.opt_output_affine:
            t["alpha_out"] = uq.alpha_out
            t["beta_out"] = uq.beta_out
        qstate[name] = dataclasses.replace(uq, wq=wq)
        theta[name] = t
    return qstate, theta


def _insert_theta(qstate, theta):
    """Write the theta tensors back into the units' quantizers."""
    qstate = dict(qstate)
    for name, t in theta.items():
        uq = qstate[name]
        wq = uq.wq
        if "alpha" in t:
            wq = dataclasses.replace(wq, alpha=t["alpha"])
        if "beta" in t:
            wq = dataclasses.replace(wq, beta=t["beta"])
        uq = dataclasses.replace(uq, wq=wq)
        if "alpha_out" in t:
            uq = dataclasses.replace(uq, alpha_out=t["alpha_out"],
                                     beta_out=t["beta_out"])
        qstate[name] = uq
    return qstate


def _harden(qstate, unit_names, mode):
    """Flip quantizers to hard rounding and selection. Fused
    effective-dequant quantizers become the baked AdaRoundWQ form."""
    qstate = dict(qstate)
    for name in unit_names:
        uq = qstate[name]
        wq = uq.wq
        if isinstance(wq, W.ShiftedScaleWQ):
            if wq.codes and wq.dequant == "effective":
                wq = W.shifted_to_baked(wq)
            else:
                wq = dataclasses.replace(wq, hard_targets=True,
                                         hard_round=wq.codes)
        elif isinstance(wq, W.AdaRoundWQ):
            wq = dataclasses.replace(wq, soft=False)
        qstate[name] = dataclasses.replace(uq, wq=wq)
    return qstate


def selection_ratios(qstate, unit_names):
    """Fraction of selection groups choosing each shift candidate:
    {unit: (S,) tensor}, for units with a shift selection."""
    out = {}
    for name in unit_names:
        wq = qstate[name].wq
        if isinstance(wq, W.ShiftedScaleWQ):
            idx = torch.argmax(wq.soft_targets(), dim=-1)
            n_s = len(wq.shift_targets)
        elif isinstance(wq, W.AdaRoundWQ) and wq.st_index is not None:
            idx, n_s = wq.st_index, len(wq.shift_targets)
        else:
            continue
        counts = torch.bincount(idx.reshape(-1), minlength=n_s)
        out[name] = counts.to(torch.float32) / idx.numel()
    return out
