"""Uniform-affine quantizer math and the soft-target relaxations shared by
AdaRound and shifted-scale selection (PyTorch port of
``shiftedscalequantization_tpu/ops/quant.py``).

Rounding is half-to-even (``torch.round``), as ``jnp.round`` is. The MSE
scale search keeps the reference's 80-point shrink grid, but walks the grid
in a loop so that a calibration tensor of any size needs one extra copy of
itself at a time instead of 80.

Every clamp on a differentiated path is ``clip``, which has ``jnp.clip``'s
gradient: 1 strictly inside the bounds, 1/2 where the value equals a bound
(``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, and JAX splits a tie of
``maximum``/``minimum`` evenly), 0 outside. ``torch.clamp`` passes the full
gradient at the bounds, which would double the gradient of every code that
lands exactly on ``lo`` or ``hi`` (every post-ReLU zero at zero point 0).

``fake_quant`` runs the fake-quant kernel's autograd Function
(``ops/cuda/fake_quant.py``): the CUDA kernel on the card, its plain
version on the CPU, and a backward with the same tie rule.
"""
from __future__ import annotations

import dataclasses

import torch

# Soft-target relaxation constants (AdaRound):
# clamp(sigmoid(a) * (ZETA - GAMMA) + GAMMA, 0, 1)
GAMMA = -0.1
ZETA = 1.1


def clip_grad(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``'s derivative at ``x``: 1 inside (lo, hi), 1/2 at
    either bound, 0 outside (and at NaN)."""
    inside = (x > lo) & (x < hi)
    tie = (x == lo) | (x == hi)
    return inside.to(x.dtype) + 0.5 * tie.to(x.dtype)


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * clip_grad(x, *ctx.bounds), None, None


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``torch.clamp``'s values with ``jnp.clip``'s gradient (clip_grad)."""
    return _Clip.apply(x, lo, hi)


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def floor_ste(x: torch.Tensor) -> torch.Tensor:
    """Floor with a straight-through gradient."""
    return x + (torch.floor(x) - x).detach()


def lp_loss(pred, tgt, p: float = 2.0, reduction: str = "none",
            channel_axis: int = -1):
    """L_p reconstruction loss. reduction='none': sum over the channel axis
    (last, for NHWC), then mean; 'all': plain mean."""
    d = torch.abs(pred - tgt) ** p
    if reduction == "none":
        return d.sum(dim=channel_axis).mean()
    return d.mean()


@dataclasses.dataclass
class QParams:
    """Affine quantizer parameters: x_q = clamp(round(x/delta)+zp, lo, hi).

    ``delta``/``zero_point`` broadcast against the quantized tensor (0-d for
    per-tensor, (OC, 1) for per-channel weights)."""
    delta: torch.Tensor
    zero_point: torch.Tensor
    n_bits: int
    sym: bool

    @property
    def n_levels(self) -> int:
        return 2 ** self.n_bits

    def qrange(self) -> tuple[int, int]:
        n = self.n_levels
        return (-(n // 2), n // 2 - 1) if self.sym else (0, n - 1)


def fake_quant(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """STE fake quantization: clip(round(x/delta)+zp) dequantized, through
    the fake-quant kernel. ``qp`` is per tensor (one delta) or per leading
    row (a delta per ``x.shape[0]``, as per-out-channel weights)."""
    from .cuda import fake_quant as FQ   # the kernel module imports this one
    if qp.delta.numel() == 1:
        return FQ.fake_quant_act(x, qp.delta, qp.zero_point, qp.n_bits,
                                 qp.sym)
    return FQ.fake_quant_weight(x, qp.delta, qp.zero_point, qp.n_bits,
                                qp.sym)


def quantize_int(x: torch.Tensor, qp: QParams, dtype=torch.int8):
    """True integer quantization: returns int codes."""
    lo, hi = qp.qrange()
    x_int = torch.round(x / qp.delta) + qp.zero_point
    return torch.clamp(x_int, lo, hi).to(dtype)


def dequantize(codes: torch.Tensor, qp: QParams) -> torch.Tensor:
    return (codes.to(qp.delta.dtype) - qp.zero_point) * qp.delta


# ---------------------------------------------------------------------------
# Scale initialization
# ---------------------------------------------------------------------------

def _quant_with_range(x, new_max, new_min, n_bits):
    """Quantize x with range [new_min, new_max] (broadcasting)."""
    n_levels = 2 ** n_bits
    delta = (new_max - new_min) / (n_levels - 1)
    delta = torch.where(torch.abs(delta) < 1e-12,
                        torch.full_like(delta, 1e-12), delta)
    zero_point = torch.round(-new_min / delta)
    x_int = torch.round(x / delta)
    x_q = torch.clamp(x_int + zero_point, 0, n_levels - 1)
    return (x_q - zero_point) * delta


def init_scale_minmax(x: torch.Tensor, n_bits: int, sym: bool,
                      reduce_dims=None, scale_bits_adjust: bool = False):
    """'max' scale init. Returns (delta, zero_point, raw_zero_point) reduced
    over ``reduce_dims`` (None = whole tensor, 0-d results)."""
    n_levels = 2 ** n_bits
    if reduce_dims is None:
        x_min, x_max = x.min(), x.max()
    else:
        x_min = x.amin(dim=reduce_dims, keepdim=True)
        x_max = x.amax(dim=reduce_dims, keepdim=True)
    x_min = torch.clamp(x_min, max=0.0)
    x_max = torch.clamp(x_max, min=0.0)
    if scale_bits_adjust:
        x_min = x_min * (n_bits + 2) / 8
        x_max = x_max * (n_bits + 2) / 8
    if sym:
        x_absmax = torch.maximum(torch.abs(x_min), x_max)
        x_min = torch.where(x_min < 0, -x_absmax, torch.zeros_like(x_min))
        x_max = x_absmax
    delta = (x_max - x_min) / (n_levels - 1)
    delta = torch.clamp(delta, min=1e-8)
    zero_point = torch.round(-x_min / delta)
    return delta, zero_point, -x_min


def _mse_rows(x2d: torch.Tensor, n_bits: int, sym: bool, n_grid: int,
              p: float):
    """LAPQ MSE grid search, one independent search per row of ``x2d``.

    Shrinks [x_min, x_max] by i% for i in 0..n_grid-1, quantizes, and keeps
    the range minimizing the mean L_p error. Returns (delta, zp, raw_zp),
    each of shape (rows,)."""
    n_levels = 2 ** n_bits
    x_max = x2d.amax(dim=1)
    x_min = x2d.amin(dim=1)
    if sym:
        x_absmax = torch.maximum(torch.abs(x_min), x_max)
        x_min = torch.where(x_min < 0, -x_absmax, torch.zeros_like(x_min))
        x_max = x_absmax
    shrink = 1.0 - torch.arange(n_grid, dtype=x2d.dtype,
                                device=x2d.device) * 0.01
    scores = torch.empty((n_grid, x2d.shape[0]), dtype=x2d.dtype,
                         device=x2d.device)
    for g in range(n_grid):
        new_max = (x_max * shrink[g])[:, None]
        new_min = (x_min * shrink[g])[:, None]
        xq = _quant_with_range(x2d, new_max, new_min, n_bits)
        scores[g] = (torch.abs(xq - x2d) ** p).mean(dim=1)
    best = torch.argmin(scores, dim=0)
    bmax = x_max * shrink[best]
    bmin = x_min * shrink[best]
    delta = (bmax - bmin) / (n_levels - 1)
    delta = torch.where(torch.abs(delta) < 1e-12,
                        torch.full_like(delta, 1e-12), delta)
    if sym:
        return delta, torch.zeros_like(delta), torch.zeros_like(delta)
    return delta, torch.round(-bmin / delta), -bmin


def init_scale_mse(x: torch.Tensor, n_bits: int, sym: bool,
                   n_grid: int = 80, p: float = 2.4):
    """MSE grid scale init for a whole tensor. Returns 0-d
    (delta, zp, raw_zp)."""
    d, z, r = _mse_rows(x.reshape(1, -1), n_bits, sym, n_grid, p)
    return d[0], z[0], r[0]


def init_weight_qparams(w_oc_flat: torch.Tensor, n_bits: int, sym: bool,
                        channel_wise: bool, scale_method: str = "mse"):
    """Weight quantizer init from (OC, -1) weights. Returns (QParams,
    raw_zero_point) with (OC, 1) params when channel-wise, else 0-d."""
    adjust = "scale" in scale_method
    if channel_wise:
        if scale_method == "mse":
            delta, zp, raw_zp = _mse_rows(w_oc_flat, n_bits, sym, 80, 2.4)
        else:
            delta, zp, raw_zp = init_scale_minmax(
                w_oc_flat, n_bits, sym, reduce_dims=1,
                scale_bits_adjust=adjust)
        delta, zp, raw_zp = (a.reshape(-1, 1) for a in (delta, zp, raw_zp))
    elif scale_method == "mse":
        delta, zp, raw_zp = init_scale_mse(w_oc_flat, n_bits, sym)
    else:
        delta, zp, raw_zp = init_scale_minmax(
            w_oc_flat, n_bits, sym, scale_bits_adjust=adjust)
    return QParams(delta=delta, zero_point=zp, n_bits=n_bits, sym=sym), raw_zp


def init_act_qparams(x: torch.Tensor, n_bits: int, sym: bool = False,
                     scale_method: str = "mse") -> QParams:
    """Per-tensor activation scale init."""
    if scale_method == "mse":
        delta, zp, _ = init_scale_mse(x, n_bits, sym)
    else:
        delta, zp, _ = init_scale_minmax(
            x, n_bits, sym, scale_bits_adjust="scale" in scale_method)
    return QParams(delta=delta, zero_point=zp, n_bits=n_bits, sym=sym)


# ---------------------------------------------------------------------------
# Soft-target relaxations (shared by AdaRound and shifted-scale selection)
# ---------------------------------------------------------------------------

def rectified_sigmoid(alpha: torch.Tensor) -> torch.Tensor:
    """clamp(sigmoid(a) * (zeta - gamma) + gamma, 0, 1)."""
    return clip(torch.sigmoid(alpha) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def rectified_softmax(alpha: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """clamp(softmax(a) * (zeta - gamma) + gamma, 0, 1)."""
    return clip(torch.softmax(alpha, dim=axis) * (ZETA - GAMMA) + GAMMA,
                0.0, 1.0)


def inverse_rectified_sigmoid(rest: torch.Tensor) -> torch.Tensor:
    """alpha with rectified_sigmoid(alpha) == rest."""
    return -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1.0)


def inverse_rectified_softmax(p: torch.Tensor, axis: int = -1):
    """Logits with rectified_softmax(logits) == p (mean-centred)."""
    logits = torch.log((p - GAMMA) / (ZETA - GAMMA))
    return logits - logits.mean(dim=axis, keepdim=True)


def round_regularizer(soft_vals: torch.Tensor, b) -> torch.Tensor:
    """AdaRound rounding regularizer sum(1 - |2h - 1|^b)."""
    return (1.0 - (torch.abs(soft_vals - 0.5) * 2.0) ** b).sum()


def linear_temp_decay(t, t_max: float, rel_start_decay: float = 0.2,
                      start_b: float = 20.0, end_b: float = 2.0):
    """Linear temperature decay b(t): start_b until rel_start_decay * t_max,
    then linear down to end_b at t_max. ``t`` may be a number or a 0-d
    tensor; returns a 0-d float32 tensor."""
    t = torch.as_tensor(t, dtype=torch.float32)
    start_decay = rel_start_decay * t_max
    if t_max != start_decay:
        rel_t = (t - start_decay) / (t_max - start_decay)
    else:
        rel_t = torch.ones_like(t)
    decayed = end_b + (start_b - end_b) * torch.clamp(1.0 - rel_t, min=0.0)
    return torch.where(t < start_decay, torch.full_like(t, start_b), decayed)
