"""Carry parameters and quantizer state from the JAX package into the port.

The two packages draw different random numbers from the same seed, so the
parity tests make one set of weights and state and hand it to both. This
module reads what the JAX package produces only through numpy
(``np.asarray``) and attribute or key access; it never imports jax.

- ``params_from_numpy``: a nested dict of arrays (the ``init_params`` or
  ``prepare_model`` trees) becomes the same dict of tensors.
- ``qstate_from_numpy``: a qstate of unit entries (``wq.qp`` with delta,
  zero_point, n_bits, sym; ``aq``; ``alpha_out``/``beta_out``/``raw_zp``)
  and block-level act quantizers becomes the port's qstate with
  ``UniformWQ`` weight quantizers. Entries may be objects or dicts.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..graph import UnitQuant
from ..ops.quant import QParams
from ..ops.wquant import UniformWQ


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


def qstate_from_numpy(qstate: dict, device="cuda") -> dict:
    """Unit entries (those with a ``wq``) become UnitQuant with a UniformWQ;
    other entries are block-level act QParams."""
    dev = resolve_device(device)
    out = {}
    for name, v in qstate.items():
        if v is None:
            out[name] = None
            continue
        has_wq = ("wq" in v) if isinstance(v, dict) else hasattr(v, "wq")
        if not has_wq:
            out[name] = qparams_from_numpy(v, dev)
            continue
        wq = _get(v, "wq")
        if not isinstance(wq, dict) and type(wq).__name__ != "UniformWQ":
            raise NotImplementedError(
                f"{name}: weight quantizer {type(wq).__name__} is not "
                "ported (UniformWQ only)")
        aq = _get(v, "aq")
        opt = {k: (None if _get(v, k) is None else _tensor(_get(v, k), dev))
               for k in ("alpha_out", "beta_out", "raw_zp")}
        out[name] = UnitQuant(
            wq=UniformWQ(qp=qparams_from_numpy(_get(wq, "qp"), dev)),
            aq=None if aq is None else qparams_from_numpy(aq, dev), **opt)
    return out
