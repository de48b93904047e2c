"""BatchNorm folding as a pure parameter transform (PyTorch port of
``shiftedscalequantization_tpu/fold_bn.py:15-37``).

Raw params carry an optional 'bn' entry per unit ({'gamma', 'beta', 'mean',
'var'}); folding returns plain {'w', 'b'} unit params.
"""
from __future__ import annotations

import torch

BN_EPS = 1e-5


def fold_unit(p: dict, eps: float = BN_EPS) -> dict:
    """Fold one unit's BN into its weights."""
    if "bn" not in p:
        return dict(p)
    w, b, bn = p["w"], p.get("b"), p["bn"]
    std = torch.sqrt(bn["var"] + eps)
    gamma = bn.get("gamma")
    beta = bn.get("beta")
    view = (-1,) + (1,) * (w.ndim - 1)
    if gamma is not None:  # affine BN
        w_f = w * (gamma / std).reshape(view)
        beta_t = beta - gamma * bn["mean"] / std
        b_f = gamma * b / std + beta_t if b is not None else beta_t
    else:
        w_f = w / std.reshape(view)
        beta_t = -bn["mean"] / std
        b_f = b / std + beta_t if b is not None else beta_t
    return {"w": w_f, "b": b_f}


def fold_bn(params: dict, eps: float = BN_EPS) -> dict:
    """Fold every unit's BN. params: {unit_name: {'w', 'b'?, 'bn'?}}."""
    return {name: fold_unit(p, eps) for name, p in params.items()}
