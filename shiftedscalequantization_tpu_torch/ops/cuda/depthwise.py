"""Fused int8 depthwise 3x3 conv -> act requant, on centered int8 codes.

Port of ``shiftedscalequantization_tpu/ops/pallas/depthwise.py`` (kernel
``_dw_kernel`` via ``dw_conv3x3_int8``). The CUDA kernel is
``csrc/dw_conv3x3.cu``; its source note gives the bound on an H100 and what
the design does about it. The TPU kernel computes every stride-1 output
and subsamples for stride 2; the CUDA kernel computes only the strided
outputs, which are the same values.

Rounding is the TPU kernel's own and differs from the deploy requant: the
epilogue ``acc * scalef + biasf`` is rounded after the multiply and after
the add (no fused multiply-add), the requant multiplies by ``1/delta_out``
taken once in f32, and it rounds half to even.
"""
from __future__ import annotations

import torch

from . import _build
from .packed import _scalar

ACTS = ("none", "relu", "relu6")


def _qp(out_delta, out_zp, out_qmax, device) -> torch.Tensor:
    """[1/delta_out, zp_out, qmax] as f32 on ``device``."""
    return torch.stack([1.0 / _scalar(out_delta, device),
                        _scalar(out_zp, device), _scalar(out_qmax, device)])


def _out_hw(h, w, stride):
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def dw_conv3x3_int8_plain(x_codes, w_codes_c33, scalef_c, biasf_c,
                          out_delta, out_zp, out_qmax, stride: int = 1,
                          act: str = "relu6"):
    """Plain PyTorch version: nine shifted int32 multiply-adds of the
    zero-padded codes (exact), then the f32 epilogue and requant."""
    b, h, w, c = x_codes.shape
    ho, wo = _out_hw(h, w, stride)
    inv_d, zp, qmax = _qp(out_delta, out_zp, out_qmax, x_codes.device)
    xp = torch.zeros((b, h + 2, w + 2, c), dtype=torch.int32,
                     device=x_codes.device)
    xp[:, 1:h + 1, 1:w + 1, :] = x_codes.to(torch.int32)
    wt = w_codes_c33.to(torch.int32).reshape(c, 9)
    acc = torch.zeros((b, ho, wo, c), dtype=torch.int32,
                      device=x_codes.device)
    for k in range(9):
        di, dj = divmod(k, 3)
        acc += xp[:, di:di + stride * (ho - 1) + 1:stride,
                  dj:dj + stride * (wo - 1) + 1:stride, :] * wt[:, k]
    y = acc.to(torch.float32) * scalef_c.to(torch.float32) \
        + biasf_c.to(torch.float32)
    if act == "relu":
        y = torch.relu(y)
    elif act == "relu6":
        y = torch.clamp(y, 0.0, 6.0)
    q = torch.minimum(torch.clamp(torch.round(y * inv_d) + zp, min=0.0),
                      qmax)
    return (q - zp).to(torch.int8)


def dw_conv3x3_int8(x_codes, w_codes_c33, scalef_c, biasf_c, out_delta,
                    out_zp, out_qmax, stride: int = 1, act: str = "relu6"):
    """Fused depthwise 3x3 (pad 1) on centered int8 activation codes.

    x_codes: (B, H, W, C) int8 centered codes (the kernel takes C a
    multiple of 4). w_codes_c33: (C, 3, 3) centered integer weight codes in
    int8 range. scalef_c: (C,) f32 dequant of the integer accumulator;
    biasf_c: (C,) f32 folded bias. out_delta,
    out_zp, out_qmax: the unit's own act grid (0-d tensors stay on the
    device). Returns (B, Ho, Wo, C) centered int8 codes on that grid.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if not x_codes.is_cuda:
        return dw_conv3x3_int8_plain(x_codes, w_codes_c33, scalef_c,
                                     biasf_c, out_delta, out_zp, out_qmax,
                                     stride, act)
    b, h, w, c = x_codes.shape
    if c % 4:
        raise ValueError(f"dw kernel takes C a multiple of 4, got {c}")
    if tuple(w_codes_c33.shape) != (c, 3, 3):
        raise ValueError(f"w_codes: want ({c}, 3, 3), got "
                         f"{tuple(w_codes_c33.shape)}")
    for name, t, dtype, shape in (
            ("x_codes", x_codes, torch.int8, (b, h, w, c)),
            ("scalef", scalef_c, torch.float32, (c,)),
            ("biasf", biasf_c, torch.float32, (c,))):
        if t.device != x_codes.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on "
                f"{x_codes.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if w_codes_c33.device != x_codes.device:
        raise ValueError(f"w_codes on {w_codes_c33.device}, x on "
                         f"{x_codes.device}")
    # 4-byte code words and 16-byte scale / bias vectors per thread
    for name, t, align in (("x_codes", x_codes, 4), ("scalef", scalef_c, 16),
                           ("biasf", biasf_c, 16)):
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    # tap-major (9, C) int8, so one 4-byte load holds 4 channels of a tap
    wt = w_codes_c33.reshape(c, 9).t().to(torch.int8).contiguous()
    qp = _qp(out_delta, out_zp, out_qmax, x_codes.device)
    ho, wo = _out_hw(h, w, stride)
    out = torch.empty((b, ho, wo, c), dtype=torch.int8,
                      device=x_codes.device)
    lib = _build.load()
    err = lib.ssq_dw_conv3x3(
        x_codes.data_ptr(), wt.data_ptr(), scalef_c.data_ptr(),
        biasf_c.data_ptr(), qp.data_ptr(), out.data_ptr(), b, h, w, c,
        stride, ACTS.index(act), _build.stream_ptr(x_codes))
    _build.check(lib, "ssq_dw_conv3x3", err)
    dw_conv3x3_int8.launches += 1
    return out


dw_conv3x3_int8.launches = 0
