"""Fused ResNet stem: 7x7/s2/p3 conv + ReLU + act quant + 3x3/s2/p1 maxpool
on the codes, in one pass.

Port of ``shiftedscalequantization_tpu/ops/pallas/stem.py`` (kernel
``_stem_kernel`` via ``stem_fused``). The CUDA kernel is
``csrc/stem_fused.cu``; its source note gives the bound on an H100 and what
the design does about it. The TPU kernel's banded weight matrix
(``build_stem_weights``) is a Mosaic workaround and has no counterpart.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...graph import _fp32
from . import _build
from .packed import _scalar


def _qp(out_delta, out_zp, out_qmax, center_off, device) -> torch.Tensor:
    """[1/delta, zp, qmax, center_off] as f32 on ``device``: the reciprocal
    is taken once, in f32, as the TPU kernel's host side does."""
    return torch.stack([1.0 / _scalar(out_delta, device),
                        *(_scalar(v, device)
                          for v in (out_zp, out_qmax, center_off))])


def stem_fused_plain(x_nhwc, w_codes, scale_oc, bias_oc, out_delta, out_zp,
                     out_qmax, center_off):
    """Plain PyTorch version: f32 conv (TF32 off), relu(y * scale + bias),
    clip(round(y * (1/delta)) + zp, 0, qmax) - center_off, then the max
    pool on the codes with -128 padding."""
    inv_d, zp, qmax, coff = _qp(out_delta, out_zp, out_qmax, center_off,
                                x_nhwc.device)
    with _fp32():
        y = F.conv2d(x_nhwc.permute(0, 3, 1, 2), w_codes, None, 2, 3)
    y = torch.relu(y.permute(0, 2, 3, 1) * scale_oc + bias_oc)
    q = torch.clamp(torch.round(y * inv_d) + zp, min=0.0)
    q = torch.minimum(q, qmax) - coff
    q = F.pad(q.permute(0, 3, 1, 2), (1, 1, 1, 1), value=-128.0)
    return F.max_pool2d(q, 3, 2).permute(0, 2, 3, 1).to(torch.int8)


def stem_fused(x_nhwc, w_codes, scale_oc, bias_oc, out_delta, out_zp,
               out_qmax, center_off):
    """Fused 7x7/s2/p3 conv + ReLU + act quant + 3x3/s2/p1 maxpool.

    x_nhwc: (B, H, W, 3) f32 with H, W multiples of 4. w_codes: (OC, 3, 7,
    7) f32 integer codes, OC a multiple of 16. scale_oc, bias_oc: (OC,)
    f32. Output grid: q = clip(round(y/delta)+zp, 0, qmax), stored codes
    q - center_off (128: biased int8 transport; zp: centered). Returns
    (B, H/4, W/4, OC) int8. CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    if not x_nhwc.is_cuda:
        return stem_fused_plain(x_nhwc, w_codes, scale_oc, bias_oc,
                                out_delta, out_zp, out_qmax, center_off)
    b, h, w, c = x_nhwc.shape
    oc = w_codes.shape[0]
    if c != 3 or h % 4 or w % 4:
        raise ValueError(f"stem kernel takes (B, H, W, 3) with H, W "
                         f"multiples of 4, got {tuple(x_nhwc.shape)}")
    if oc % 16 or tuple(w_codes.shape) != (oc, 3, 7, 7):
        raise ValueError(f"stem kernel takes (OC, 3, 7, 7) weights with OC "
                         f"a multiple of 16, got {tuple(w_codes.shape)}")
    for name, t, shape in (("x", x_nhwc, (b, h, w, 3)),
                           ("w_codes", w_codes, (oc, 3, 7, 7)),
                           ("scale", scale_oc, (oc,)),
                           ("bias", bias_oc, (oc,))):
        if t.device != x_nhwc.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous float32 {shape} on "
                f"{x_nhwc.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    qp = _qp(out_delta, out_zp, out_qmax, center_off, x_nhwc.device)
    out = torch.empty((b, h // 4, w // 4, oc), dtype=torch.int8,
                      device=x_nhwc.device)
    lib = _build.load()
    err = lib.ssq_stem_fused(
        x_nhwc.data_ptr(), w_codes.data_ptr(), scale_oc.data_ptr(),
        bias_oc.data_ptr(), qp.data_ptr(), out.data_ptr(), b, h, w, oc,
        _build.stream_ptr(x_nhwc))
    _build.check(lib, "ssq_stem_fused", err)
    stem_fused.launches += 1
    return out


stem_fused.launches = 0
