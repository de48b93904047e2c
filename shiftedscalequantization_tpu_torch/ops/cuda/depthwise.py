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

What a launch reads besides the codes depends only on the deploy params
and the plan, so ``prepare_dw`` builds it once (``DwConsts``): deploy keeps
one per ``dw_int8`` unit in its plan, and a forward launches the kernel
and nothing else for the unit.
"""
from __future__ import annotations

import dataclasses

import torch

from . import _build
from .packed import _scalar

ACTS = ("none", "relu", "relu6")
_TAP_SHIFTS = (0, 8, 16)


@dataclasses.dataclass(frozen=True)
class DwConsts:
    """A depthwise unit's launch constants, on one device.

    w_taps: (C, 3) int32, one word per (channel, kernel row): the codes of
    taps kw = 0, 1, 2 as signed bytes 0-2, byte 3 zero. scalef, biasf: (C,)
    f32. qp: (3,) f32 [1/delta_out, zp_out, qmax]."""
    w_taps: torch.Tensor
    scalef: torch.Tensor
    biasf: torch.Tensor
    qp: torch.Tensor

    @property
    def device(self):
        return self.w_taps.device


def pack_taps(w_codes_c33) -> torch.Tensor:
    """(C, 3, 3) integer codes in int8 range -> (C, 3) int32 tap words."""
    b = w_codes_c33.to(torch.int32) & 0xFF
    return b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16)


def unpack_taps(w_taps) -> torch.Tensor:
    """(C, 3) int32 tap words -> (C, 3, 3) int32 codes."""
    shifts = torch.tensor(_TAP_SHIFTS, dtype=torch.int32,
                          device=w_taps.device)
    b = (w_taps.to(torch.int32)[:, :, None] >> shifts) & 0xFF
    return b - ((b & 0x80) << 1)


def prepare_dw(w_codes_c33, scalef_c, biasf_c, out_delta, out_zp,
               out_qmax) -> DwConsts:
    """A unit's launch constants on ``w_codes_c33``'s device. The values
    are those the per-call route took: ``1/delta_out`` is one f32 division
    there, and scalef / biasf are taken as f32."""
    dev = w_codes_c33.device
    c = w_codes_c33.shape[0]
    if tuple(w_codes_c33.shape) != (c, 3, 3):
        raise ValueError(f"w_codes: want (C, 3, 3), got "
                         f"{tuple(w_codes_c33.shape)}")
    qp = torch.stack([1.0 / _scalar(out_delta, dev),
                      _scalar(out_zp, dev), _scalar(out_qmax, dev)])
    return DwConsts(
        w_taps=pack_taps(w_codes_c33).contiguous(),
        scalef=scalef_c.to(device=dev, dtype=torch.float32).reshape(c)
        .contiguous(),
        biasf=biasf_c.to(device=dev, dtype=torch.float32).reshape(c)
        .contiguous(),
        qp=qp)


def _out_hw(h, w, stride):
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def _check_options(stride, act):
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")


def dw_plain_prepared(x_codes, k: DwConsts, stride: int = 1,
                      act: str = "relu6"):
    """Plain PyTorch version on prepared constants: nine shifted int32
    multiply-adds of the zero-padded codes (exact), then the f32 epilogue
    and requant."""
    b, h, w, c = x_codes.shape
    ho, wo = _out_hw(h, w, stride)
    inv_d, zp, qmax = k.qp
    xp = torch.zeros((b, h + 2, w + 2, c), dtype=torch.int32,
                     device=x_codes.device)
    xp[:, 1:h + 1, 1:w + 1, :] = x_codes.to(torch.int32)
    wt = unpack_taps(k.w_taps).reshape(c, 9)
    acc = torch.zeros((b, ho, wo, c), dtype=torch.int32,
                      device=x_codes.device)
    for t in range(9):
        di, dj = divmod(t, 3)
        acc += xp[:, di:di + stride * (ho - 1) + 1:stride,
                  dj:dj + stride * (wo - 1) + 1:stride, :] * wt[:, t]
    y = acc.to(torch.float32) * k.scalef + k.biasf
    if act == "relu":
        y = torch.relu(y)
    elif act == "relu6":
        y = torch.clamp(y, 0.0, 6.0)
    q = torch.minimum(torch.clamp(torch.round(y * inv_d) + zp, min=0.0),
                      qmax)
    return (q - zp).to(torch.int8)


def dw_conv3x3_int8_plain(x_codes, w_codes_c33, scalef_c, biasf_c,
                          out_delta, out_zp, out_qmax, stride: int = 1,
                          act: str = "relu6"):
    """Plain PyTorch version of ``dw_conv3x3_int8``."""
    return dw_plain_prepared(
        x_codes, prepare_dw(w_codes_c33, scalef_c, biasf_c, out_delta,
                            out_zp, out_qmax), stride, act)


def dw_conv3x3_int8_prepared(x_codes, k: DwConsts, stride: int = 1,
                             act: str = "relu6"):
    """``dw_conv3x3_int8`` on constants from ``prepare_dw``: CPU tensors
    take the plain version; CUDA tensors launch the kernel (C a multiple
    of 4) and nothing else."""
    _check_options(stride, act)
    if not x_codes.is_cuda:
        return dw_plain_prepared(x_codes, k, stride, act)
    b, h, w, c = x_codes.shape
    if c % 4:
        raise ValueError(f"dw kernel takes C a multiple of 4, got {c}")
    if x_codes.dtype != torch.int8 or not x_codes.is_contiguous():
        raise ValueError(f"x_codes: want contiguous int8, got "
                         f"{x_codes.dtype}")
    for name, t, dtype, shape in (("w_taps", k.w_taps, torch.int32, (c, 3)),
                                  ("scalef", k.scalef, torch.float32, (c,)),
                                  ("biasf", k.biasf, torch.float32, (c,)),
                                  ("qp", k.qp, torch.float32, (3,))):
        if t.device != x_codes.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on "
                f"{x_codes.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    # 16-byte copy words where C % 16 == 0 (4-byte otherwise); 16-byte
    # weight, scale and bias vectors per thread
    for name, t, align in (("x_codes", x_codes, 16 if c % 16 == 0 else 4),
                           ("w_taps", k.w_taps, 16), ("scalef", k.scalef, 16),
                           ("biasf", k.biasf, 16)):
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    ho, wo = _out_hw(h, w, stride)
    out = torch.empty((b, ho, wo, c), dtype=torch.int8,
                      device=x_codes.device)
    lib = _build.load()
    err = lib.ssq_dw_conv3x3(
        x_codes.data_ptr(), k.w_taps.data_ptr(), k.scalef.data_ptr(),
        k.biasf.data_ptr(), k.qp.data_ptr(), out.data_ptr(), b, h, w, c,
        stride, ACTS.index(act), _build.stream_ptr(x_codes))
    _build.check(lib, "ssq_dw_conv3x3", err)
    dw_conv3x3_int8.launches += 1
    return out


def dw_conv3x3_int8(x_codes, w_codes_c33, scalef_c, biasf_c, out_delta,
                    out_zp, out_qmax, stride: int = 1, act: str = "relu6"):
    """Fused depthwise 3x3 (pad 1) on centered int8 activation codes.

    x_codes: (B, H, W, C) int8 centered codes (the kernel takes C a
    multiple of 4). w_codes_c33: (C, 3, 3) centered integer weight codes in
    int8 range. scalef_c: (C,) f32 dequant of the integer accumulator;
    biasf_c: (C,) f32 folded bias. out_delta (> 0), out_zp (an integer),
    out_qmax: the unit's own act grid (0-d tensors stay on the device).
    Returns (B, Ho, Wo, C) centered int8 codes on that grid. CPU tensors
    take the plain version; CUDA tensors launch the kernel. A caller that
    runs the same unit again builds its constants once with ``prepare_dw``
    and calls ``dw_conv3x3_int8_prepared``.
    """
    return dw_conv3x3_int8_prepared(
        x_codes, prepare_dw(w_codes_c33, scalef_c, biasf_c, out_delta,
                            out_zp, out_qmax), stride, act)


dw_conv3x3_int8.launches = 0
