"""Greedy and random shift-selection searches, the non-gradient baselines
(PyTorch port of ``shiftedscalequantization_tpu/recon/search.py``).

The reference's per-(out-channel, in-channel) search harnesses
(QuantModule.run_layerGreedy / run_layerDist / run_GreedyLoss,
quant_layer.py:325-528, and the randomize test,
myScaledMethods.py:418-501):

  * weight-space greedy: the weight L_p loss decomposes per (oc, ic) pair,
    so the hill-climb is one batched argmin over the candidate axis;
  * output-space greedy: coordinate descent over input channels with an
    incremental output, every out-channel and candidate of one input
    channel evaluated at once;
  * distance greedy: the weight-space argmin at steps ``delta / qParam``;
  * random selection from a ``torch.Generator`` (it cannot draw JAX's
    numbers, so only its distribution and determinism match).

A selection is a per-(oc, ic) candidate index. Selections pick candidates
by index (``torch.gather``), which is exact where the JAX package's
one-hot einsum is; convs and matmuls run with TF32 off
(``graph._fp32``). ``torch.argmin`` takes the first minimum, as
``jnp.argmin`` does. Plain PyTorch throughout: the JAX package runs all of
it outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..graph import _fp32, conv2d, linear
from ..ops.quant import QParams
from ..ops.wquant import _bshape


def candidate_weights(qp: QParams, w: torch.Tensor,
                      shift_targets: Tuple[float, ...]) -> torch.Tensor:
    """(S, *w.shape) fully fake-quantized weights at each shifted step
    (the two-phase candidate form, channelQuant.py:201-213)."""
    delta = _bshape(qp.delta, w)
    zp = _bshape(qp.zero_point, w)
    lo, hi = qp.qrange()
    cands = []
    for st in shift_targets:
        x_int = torch.round(w / (delta * st))
        x_q = torch.clamp(x_int + zp, lo, hi)
        cands.append((x_q - zp) * (delta * st))
    return torch.stack(cands)


def weight_greedy_selection(w, cands, p: float = 2.4):
    """argmin_k of the per-(oc, ic) weight loss: the exact optimum of the
    reference's weight-space greedy (run_layerGreedy,
    quant_layer.py:325-359, whose objective decomposes per pair). Returns
    (selection (OC, IC) int32, total loss)."""
    err = torch.abs(cands - w[None]) ** p              # (S, OC, IC, ...)
    per_pair = err.reshape(err.shape[:3] + (-1,)).sum(dim=-1)
    return torch.argmin(per_pair, dim=0).to(torch.int32), \
        per_pair.amin(dim=0).sum()


def _pick(stacked, idx):
    """stacked[idx[...], ...] along the leading (candidate) axis, with
    ``idx`` broadcast against ``stacked.shape[1:]``."""
    idx = torch.broadcast_to(idx.long(), stacked.shape[1:])
    return torch.gather(stacked, 0, idx[None])[0]


def apply_selection(cands, sel):
    """The selected weight tensor from (S, ...) candidates and a
    per-(oc, ic) selection."""
    if cands.ndim == 5:
        return _pick(cands, sel[:, :, None, None])
    return _pick(cands, sel)


def _unit_out(spec, w, x):
    with _fp32():
        if spec.kind == "conv":
            return conv2d(x, w, None, spec.stride, spec.padding, spec.groups)
        return linear(x, w, None)


def output_greedy_selection(spec, cands, cached_inp, cached_out,
                            sweeps: int = 1, p: float = 2.0):
    """Output-space coordinate-descent greedy (run_GreedyLoss,
    quant_layer.py:407-457): for each input channel, try every candidate
    for all out-channels at once, keep the best per out-channel, and
    update the running output incrementally. ``cands``: (S, OC, IC, KH,
    KW) or (S, OC, IC).

    Returns (selection (OC, IC) int32, final loss). Loss: the sum over
    the channel axis of |err|^p, mean over the rest (the reference's
    lp_loss on the cached batch)."""
    n_s, oc, ic = cands.shape[:3]
    x, tgt = cached_inp, cached_out
    spec_i = dataclasses.replace(spec, in_ch=1, groups=1)

    def channel_contrib(k, i):
        """Output contribution of input channel i under candidate k."""
        if cands.ndim == 5:
            return _unit_out(spec_i, cands[k, :, i][:, None],
                             x[..., i:i + 1])
        return x[:, i][:, None] * cands[k, :, i][None, :]

    with torch.no_grad():
        sel = torch.zeros((oc, ic), dtype=torch.int32, device=cands.device)
        out = _unit_out(spec, apply_selection(cands, sel), x)
        for _ in range(sweeps):
            for i in range(ic):
                contribs = torch.stack([channel_contrib(k, i)
                                        for k in range(n_s)])  # (S, ..., OC)
                base = out - _pick(contribs, sel[:, i])
                # per-out-channel loss of each candidate: out-channels are
                # independent given the input
                errs = torch.stack([
                    (torch.abs(base + contribs[k] - tgt) ** p)
                    .reshape(-1, oc).mean(dim=0) for k in range(n_s)])
                new_k = torch.argmin(errs, dim=0).to(torch.int32)
                out = base + _pick(contribs, new_k)
                sel[:, i] = new_k
        return sel, (torch.abs(out - tgt) ** p).sum(dim=-1).mean()


def dist_selection(qp: QParams, w: torch.Tensor,
                   qparams: Tuple[float, ...] = (1.0, 0.5), p: float = 2.0):
    """Distance-metric greedy (run_layerDist, quant_layer.py:361-405): per
    (oc, ic) pair, the candidate divisor qParam[k] whose step ``delta /
    qParam[k]`` (divided: the opposite direction from the shifted scale's
    ``delta * target``) minimizes the plain L_p weight distance. Returns
    (selection (OC, IC) int32, total weight loss)."""
    cands = candidate_weights(qp, w, tuple(1.0 / q for q in qparams))
    return weight_greedy_selection(w, cands, p=p)


def random_selection(gen: torch.Generator, oc: int, ic: int,
                     n_targets: int, prob_nonbase: float = 0.5):
    """Random per-(oc, ic) selection baseline (channelRandomizeTest,
    myScaledMethods.py:418-501): candidate 0 ('base') with probability
    1 - prob_nonbase, otherwise uniform among the rest; drawn from
    ``gen``, on its device."""
    nonbase = torch.rand((oc, ic), generator=gen,
                         device=gen.device) < prob_nonbase
    alt = torch.randint(1, max(n_targets, 2), (oc, ic), generator=gen,
                        device=gen.device)
    return torch.where(nonbase, alt, 0).to(torch.int32)
