"""Fused uniform fake-quant: scale, round, clip, dequant in one pass.

Port of ``shiftedscalequantization_tpu/ops/pallas/fake_quant.py`` (kernel
``_fake_quant_kernel`` via ``fake_quant_2d``; wrappers ``fake_quant_weight``
and ``fake_quant_act``). The CUDA kernel is ``csrc/fake_quant.cu``; its
source note gives the bound on an H100 and what the design does about it.

The kernel is rank-2, as the TPU kernel: per-out-channel weights are
viewed as (OC, IC*KH*KW) with a delta per row, activations as
(N*H*W, C) with one delta. It divides by delta (IEEE quotient) and rounds
half to even, where the TPU kernel multiplies by 1/delta: the sim path it
serves, ``ops/quant.fake_quant`` of the JAX package, divides, and a code
that flipped at a tie would change the calibration and every loss after
it. Its output equals ``fake_quant_plain`` bit for bit.

``fake_quant_weight`` and ``fake_quant_act`` run under an autograd Function
whose backward is ``jax.grad`` of ``ops/quant.fake_quant`` (the TPU kernel
has no backward kernel; PyTorch elementwise code computes it):

    grad x  = g * delta * m / delta
    grad dl = sum g * ((q - zp) - m * x / delta)
    grad zp = sum g * delta * (m - 1)

with q the clipped code, m ``jnp.clip``'s derivative at the unclipped code
(1 inside, 1/2 at a bound, 0 outside: ``ops/quant.clip_grad``) and the sums
over the axes delta and zp are broadcast along. CPU tensors take the plain
version; CUDA tensors launch the kernel. Each wrapper counts its launches.
"""
from __future__ import annotations

import torch

from . import _build
from ..quant import clip, clip_grad, round_ste


def _qrange(n_bits: int, sym: bool):
    n = 2 ** n_bits
    return (-(n // 2), n // 2 - 1) if sym else (0, n - 1)


def fake_quant_plain(x, delta, zp, lo, hi):
    """Plain PyTorch version, ``ops/quant.fake_quant``'s op sequence:
    (clip(round_ste(x / delta) + zp, lo, hi) - zp) * delta, with delta and
    zp broadcast against x. Differentiable, with the JAX package's
    gradient."""
    return (clip(round_ste(x / delta) + zp, lo, hi) - zp) * delta


def _launch(x2d, d, z, lo, hi, counter):
    """The kernel on contiguous f32 (R, C) with delta/zp (R, 1) or (1, 1)
    on the same card; ``counter.launches`` grows by one."""
    r, c = x2d.shape
    per_row = d.shape[0] == r and r > 1
    for name, t in (("x", x2d), ("delta", d), ("zp", z)):
        if not t.is_cuda or t.device != x2d.device \
                or t.dtype != torch.float32:
            raise ValueError(f"fake_quant: {name} must be float32 on "
                             f"{x2d.device}, got {t.dtype} on {t.device}")
    if tuple(d.shape) not in ((r, 1), (1, 1)) or z.shape != d.shape:
        raise ValueError(f"fake_quant: delta/zp must be ({r}, 1) or (1, 1), "
                         f"got {tuple(d.shape)} / {tuple(z.shape)}")
    if r * c >= 2 ** 62:
        raise ValueError(f"fake_quant: {r} x {c} elements is too many")
    x2d, d, z = x2d.contiguous(), d.contiguous(), z.contiguous()
    out = torch.empty_like(x2d)
    lib = _build.load()
    err = lib.ssq_fake_quant(x2d.data_ptr(), d.data_ptr(), z.data_ptr(),
                             out.data_ptr(), r, c, int(per_row), int(lo),
                             int(hi), _build.stream_ptr(x2d))
    _build.check(lib, "ssq_fake_quant", err)
    counter.launches += 1
    return out


def fake_quant_2d(x, delta, zp, lo: int, hi: int):
    """Fake-quant of an (R, C) tensor with delta/zp (R, 1) per row or
    (1, 1): the kernel on the card, the plain version on the CPU. No
    gradient (the wrappers below carry one)."""
    if not x.is_cuda:
        return fake_quant_plain(x, delta, zp, lo, hi).detach()
    return _launch(x, delta, zp, lo, hi, fake_quant_2d)


class FakeQuantFn(torch.autograd.Function):
    """fake_quant_2d with the JAX package's gradient w.r.t. x, delta, zp."""

    @staticmethod
    def forward(ctx, x2d, d, z, lo, hi, counter):
        ctx.save_for_backward(x2d, d, z)
        ctx.bounds = (lo, hi)
        if not x2d.is_cuda:
            return fake_quant_plain(x2d, d, z, lo, hi)
        return _launch(x2d, d, z, lo, hi, counter)

    @staticmethod
    def backward(ctx, g):
        x, d, z = ctx.saved_tensors
        lo, hi = ctx.bounds
        t = x / d
        code = torch.round(t) + z
        m = clip_grad(code, lo, hi)
        # (g * delta * m) / delta, in the order autodiff of the op sequence
        # takes it: not g * m, which differs in the last bit
        gx = g * d * m / d if ctx.needs_input_grad[0] else None
        gd = gz = None
        row = d.shape[0] == x.shape[0] and x.shape[0] > 1
        dims = 1 if row else (0, 1)
        if ctx.needs_input_grad[1]:
            q = torch.clamp(code, lo, hi)
            gd = (g * ((q - z) - m * t)).sum(dim=dims, keepdim=True)
        if ctx.needs_input_grad[2]:
            gz = (g * d * (m - 1.0)).sum(dim=dims, keepdim=True)
        return gx, gd, gz, None, None, None


def _as_rows(a, rows, what):
    a = torch.as_tensor(a)
    if a.numel() not in (1, rows):
        raise ValueError(f"fake_quant_weight: {what} has {a.numel()} "
                         f"values for {rows} rows")
    return torch.broadcast_to(a.reshape(-1, 1), (rows, 1))


def fake_quant_weight(w, delta, zp, n_bits: int, sym: bool):
    """Per-out-channel weight fake-quant. w: (OC, ...) any rank;
    delta/zp: OC values (any shape that holds them, e.g. (OC, 1)) or one."""
    lo, hi = _qrange(n_bits, sym)
    oc = w.shape[0]
    out = FakeQuantFn.apply(w.reshape(oc, -1), _as_rows(delta, oc, "delta"),
                            _as_rows(zp, oc, "zp"), lo, hi,
                            fake_quant_weight)
    return out.reshape(w.shape)


def fake_quant_act(x, delta, zp, n_bits: int, sym: bool = False):
    """Per-tensor activation fake-quant of an NHWC or (N, C) tensor (one
    delta and zp, any shape holding one value)."""
    lo, hi = _qrange(n_bits, sym)
    if delta.numel() != 1 or zp.numel() != 1:
        raise ValueError("fake_quant_act: delta and zp must hold one value")
    shape = x.shape
    flat = x.reshape(-1, shape[-1]) if x.ndim else x.reshape(1, 1)
    out = FakeQuantFn.apply(flat, delta.reshape(1, 1), zp.reshape(1, 1),
                            lo, hi, fake_quant_act)
    return out.reshape(shape)


fake_quant_2d.launches = 0
fake_quant_weight.launches = 0
fake_quant_act.launches = 0
