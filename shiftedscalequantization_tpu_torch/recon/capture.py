"""Calibration activation capture (PyTorch port of
``shiftedscalequantization_tpu/recon/capture.py:24-175``).

Two capture routes feed reconstruction:

  * ``capture_io``: per target, one pass per flag set over the calibration
    set: inputs under ``inp_flags`` (the already-reconstructed prefix
    weight-quantized: asymmetric reconstruction) and target outputs under
    ``out_flags`` (typically all FP). Each pass stops at the captured node.
  * ``CaptureSession``: one full forward per batch with the quantized
    prefix expressed as data: each done unit's weight is replaced by its
    materialized fake-quant tensor, and the FP target outputs of every
    target are cached once. Same numbers as ``capture_io`` with
    weight-only prefix flags. The JAX package takes this route on an
    accelerator to compile one graph; here it saves the FP pass per
    target.

``capture_grads`` gives the Fisher losses their weights: the gradient
of the KL divergence between the quantized-till-target and the FP
network outputs at the target's output.

Batches cover every row: the last partial batch is kept. (The JAX package
zero-pads it to keep one compiled shape; PyTorch runs it at its own size.)
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..graph import Flags, Graph, _fp32, forward, forward_inject, \
    forward_multi_capture, iter_units, prefix_flags_till
from ..ops.wquant import apply_weight_quant


def _batches(data, bs: int):
    """Batches of ``bs`` rows covering all of ``data``; the last one may
    be shorter."""
    return (data[i:i + bs] for i in range(0, data.shape[0], bs))


def _cast(t, cache_dtype):
    return t if cache_dtype is None else t.to(cache_dtype)


def capture_io(graph: Graph, params, qstate, target: str, cali_data,
               inp_flags: Flags, out_flags: Flags, batch_size: int = 64,
               cache_dtype=None, device="cuda"):
    """(cached_inp, cached_out) of ``target`` over ``cali_data`` (NHWC, on
    any device; moved to ``device`` batch by batch)."""
    dev = resolve_device(device)

    def run(flags, want_input):
        outs = []
        for xb in _batches(cali_data, batch_size):
            cin, cout = forward(graph, params, qstate, xb.to(dev), flags,
                                capture=target, device=dev)
            outs.append(_cast(cin if want_input else cout, cache_dtype))
        return torch.cat(outs)

    return run(inp_flags, True), run(out_flags, False)


class CaptureSession:
    """Capture for the sequential pipeline: the quantized prefix as
    materialized weights, the FP target outputs cached once."""

    def __init__(self, graph: Graph, params, cali_data, targets,
                 batch_size: int = 64, output_affine: bool = False,
                 fp_cache_limit_bytes: int = 4 << 30, device="cuda"):
        self.graph = graph
        self.params = params
        self.device = resolve_device(device)
        self.cali = cali_data
        self.batch_size = batch_size
        self.output_affine = output_affine
        self.targets = tuple(targets)
        self._qstate = {u.name: None for u in iter_units(graph)}
        # FP target outputs do not depend on the prefix: one pass caches
        # them for every target, unless they would exceed the limit
        self._fp_outs = None
        self._fp_cache_limit = fp_cache_limit_bytes

    def _run(self, params, xb):
        return forward_multi_capture(self.graph, params, self._qstate,
                                     xb.to(self.device), {}, self.targets,
                                     Flags(), device=self.device)

    def _sub_params(self, qstate, prefix_units):
        """params with each prefix unit's weight replaced by its fake-quant
        tensor; with output_affine its gamma^z/phi^z fold into weight and
        bias: conv(x, w)*a + b*a + beta == conv(x, w*a) + (b*a + beta)."""
        out = dict(self.params)
        with torch.no_grad():
            for u in prefix_units:
                if u not in out or qstate.get(u) is None:
                    continue
                uq = qstate[u]
                p = dict(out[u])
                w_hat = apply_weight_quant(uq.wq, p["w"])
                if self.output_affine and uq.alpha_out is not None:
                    w_hat = w_hat * uq.alpha_out.reshape(
                        (-1,) + (1,) * (w_hat.ndim - 1))
                    b = p.get("b")
                    p["b"] = (0.0 if b is None else b) * uq.alpha_out \
                        + uq.beta_out
                p["w"] = w_hat
                out[u] = p
        return out

    def _ensure_fp_cache(self):
        if self._fp_outs is not None:
            return self._fp_outs is not False
        probe = self._run(self.params, self.cali[:1])
        per_row = sum(v[1].numel() for v in probe.values())
        if per_row * self.cali.shape[0] * 4 > self._fp_cache_limit:
            self._fp_outs = False
            return False
        outs = {t: [] for t in self.targets}
        for xb in _batches(self.cali, self.batch_size):
            res = self._run(self.params, xb)
            for t in self.targets:
                outs[t].append(res[t][1])      # f32, as capture_io
        self._fp_outs = {t: torch.cat(v) for t, v in outs.items()}
        return True

    def capture(self, qstate, target: str, prefix_units, cache_dtype=None):
        """(cached_inp under the quantized prefix, cached_out all FP)."""
        p_prefix = self._sub_params(qstate, frozenset(prefix_units))
        have_fp = self._ensure_fp_cache()
        inps, outs = [], []
        for xb in _batches(self.cali, self.batch_size):
            inps.append(_cast(self._run(p_prefix, xb)[target][0],
                              cache_dtype))
            if not have_fp:
                outs.append(_cast(self._run(self.params, xb)[target][1],
                                  cache_dtype))
        cached_out = self._fp_outs[target] if have_fp else torch.cat(outs)
        return torch.cat(inps), _cast(cached_out, cache_dtype)


def capture_grads(graph: Graph, params, qstate, target: str, cali_data,
                  batch_size: int = 32, act_quant: bool = False,
                  damping: float = 1.0, device="cuda"):
    """Fisher-information proxy: |d KL(fp || quant) / d t| + ``damping``
    per row of ``cali_data``, where t is ``target``'s output with the
    network quantized up to and including ``target``
    (``prefix_flags_till``). The KL is F.kl_div(log_softmax(quant),
    softmax(fp), 'batchmean') over batches of ``batch_size`` rows; its
    mean divides by ``batch_size`` also for a short last batch, as the
    JAX package's zero-padded batch does (rows are independent, so the
    padding adds nothing else). The gradient is taken through
    ``forward_inject`` (targets nested inside blocks included), with TF32
    off in the forward and the backward."""
    dev = resolve_device(device)
    qflags = prefix_flags_till(graph, target, act_quant=act_quant)
    outs = []
    for xb in _batches(cali_data, batch_size):
        xb = xb.to(dev)
        with torch.no_grad():
            p_fp = torch.softmax(forward(graph, params, qstate, xb, Flags(),
                                         device=dev), dim=1)
            logp = torch.log(torch.clamp(p_fp, min=1e-12))
            _, t = forward(graph, params, qstate, xb, qflags,
                           capture=target, device=dev)
        t = t.detach().requires_grad_(True)
        with _fp32():
            out_q = forward_inject(graph, params, qstate, xb, target, t,
                                   qflags)
            kl = (p_fp * (logp - torch.log_softmax(out_q, dim=1))).sum() \
                / batch_size
            g, = torch.autograd.grad(kl, t)
        outs.append(torch.abs(g) + damping)
        del out_q, kl, t
    return torch.cat(outs)
