"""Carry parameters and quantizer state from the JAX package into the port.

The two packages draw different random numbers from the same seed, so the
parity tests make one set of weights and state and hand it to both. This
module reads what the JAX package produces only through numpy
(``np.asarray``) and attribute or key access; it never imports jax.

- ``params_from_numpy``: a nested dict of arrays (the ``init_params`` or
  ``prepare_model`` trees) becomes the same dict of tensors.
- ``qstate_from_numpy``: a qstate of unit entries (``wq``; ``aq``;
  ``alpha_out``/``beta_out``/``raw_zp``) and block-level act quantizers
  becomes the port's qstate. Weight quantizers are carried with their
  arrays and their static fields: ``UniformWQ``, ``AdaRoundWQ``
  (``soft``, ``signed_clamp``, ``st_index``, ``shift_targets``),
  ``ShiftedScaleWQ`` (``hard_targets``, ``hard_round``, ``codes``,
  ``dequant``) and ``InpScaleWQ``. Act quantizers (a unit's ``aq`` and
  block sites) are QParams or ``ActShiftQuant`` (``qp``, ``alpha``,
  ``shift_targets``, ``hard_targets``). Entries may be objects or dicts;
  a dict quantizer is told apart by its keys.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..graph import UnitQuant
from ..ops.act_quant import ActShiftQuant
from ..ops.quant import QParams
from ..ops import wquant as W


def _get(obj, key):
    return obj[key] if isinstance(obj, dict) else getattr(obj, key)


def _tensor(a, dev):
    return torch.as_tensor(np.array(a), device=dev)


def params_from_numpy(tree, device="cuda"):
    """Nested dict of arrays -> the same nesting of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor(tree, dev)


def qparams_from_numpy(qp, device="cuda") -> QParams:
    dev = resolve_device(device)
    return QParams(delta=_tensor(_get(qp, "delta"), dev),
                   zero_point=_tensor(_get(qp, "zero_point"), dev),
                   n_bits=int(_get(qp, "n_bits")), sym=bool(_get(qp, "sym")))


def act_quantizer_from_numpy(aq, device="cuda"):
    """One act quantizer of the JAX package (QParams or ActShiftQuant)
    -> the port's."""
    dev = resolve_device(device)
    is_shift = ("shift_targets" in aq) if isinstance(aq, dict) \
        else hasattr(aq, "shift_targets")
    if not is_shift:
        return qparams_from_numpy(aq, dev)
    return ActShiftQuant(
        qp=qparams_from_numpy(_get(aq, "qp"), dev),
        alpha=_tensor(_get(aq, "alpha"), dev),
        shift_targets=tuple(float(t) for t in _get(aq, "shift_targets")),
        hard_targets=bool(_get(aq, "hard_targets")))


def _kind(wq) -> str:
    if not isinstance(wq, dict):
        return type(wq).__name__
    for key, kind in (("x_q", "ShiftedScaleWQ"), ("inp_scale", "InpScaleWQ"),
                      ("alpha", "AdaRoundWQ")):
        if key in wq:
            return kind
    return "UniformWQ"


def weight_quantizer_from_numpy(wq, device="cuda"):
    """One weight quantizer of the JAX package -> the port's."""
    dev = resolve_device(device)
    kind = _kind(wq)
    if kind not in ("UniformWQ", "AdaRoundWQ", "ShiftedScaleWQ",
                    "InpScaleWQ"):
        raise NotImplementedError(f"weight quantizer {kind} is not ported")
    qp = qparams_from_numpy(_get(wq, "qp"), dev)
    if kind == "UniformWQ":
        return W.UniformWQ(qp=qp)
    if kind == "AdaRoundWQ":
        idx = _get(wq, "st_index")
        return W.AdaRoundWQ(
            qp=qp, alpha=_tensor(_get(wq, "alpha"), dev),
            soft=bool(_get(wq, "soft")),
            signed_clamp=bool(_get(wq, "signed_clamp")),
            st_index=None if idx is None else _tensor(idx, dev).long(),
            shift_targets=tuple(float(t) for t in _get(wq, "shift_targets")))
    if kind == "ShiftedScaleWQ":
        beta = _get(wq, "beta")
        return W.ShiftedScaleWQ(
            qp=qp, alpha=_tensor(_get(wq, "alpha"), dev),
            beta=None if beta is None else _tensor(beta, dev),
            x_q=_tensor(_get(wq, "x_q"), dev),
            shift_targets=tuple(float(t) for t in _get(wq, "shift_targets")),
            hard_targets=bool(_get(wq, "hard_targets")),
            hard_round=bool(_get(wq, "hard_round")),
            codes=bool(_get(wq, "codes")), dequant=str(_get(wq, "dequant")))
    return W.InpScaleWQ(
        qp=qp, raw_zero_point=_tensor(_get(wq, "raw_zero_point"), dev),
        inp_scale=_tensor(_get(wq, "inp_scale"), dev))


def qstate_from_numpy(qstate: dict, device="cuda") -> dict:
    """Unit entries (those with a ``wq``) become UnitQuant; other entries
    are block-level act quantizers."""
    dev = resolve_device(device)
    out = {}
    for name, v in qstate.items():
        if v is None:
            out[name] = None
            continue
        has_wq = ("wq" in v) if isinstance(v, dict) else hasattr(v, "wq")
        if not has_wq:
            out[name] = act_quantizer_from_numpy(v, dev)
            continue
        try:
            wq = weight_quantizer_from_numpy(_get(v, "wq"), dev)
        except NotImplementedError as e:
            raise NotImplementedError(f"{name}: {e}") from None
        aq = _get(v, "aq")
        opt = {k: (None if _get(v, k) is None else _tensor(_get(v, k), dev))
               for k in ("alpha_out", "beta_out", "raw_zp")}
        out[name] = UnitQuant(
            wq=wq,
            aq=None if aq is None else act_quantizer_from_numpy(aq, dev),
            **opt)
    return out
