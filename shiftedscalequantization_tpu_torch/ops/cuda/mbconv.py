"""Fused stride-1 MobileNetV2 inverted-residual block on int8 codes.

Port of ``shiftedscalequantization_tpu/ops/pallas/mbconv.py`` (kernel
``_mbconv_kernel`` via ``mbconv_fused``). The CUDA kernel is
``csrc/mbconv_fused.cu``; its source note gives the bound on an H100 and
what the design does about it. The deploy plan does not call this kernel,
as the JAX package's does not; it is checked at MobileNetV2's block shapes.

The block, with every operand a small integer code:

    q1 = clip(floor(x @ we * A_e + B_e), 0, hi_e)      (expand 1x1)
    q2 = clip(floor(dw3x3(q1) * A_d + B_d), 0, hi_d)   (zero-padded dw)
    y  = q2 @ wp * A_p + B_p  [+ x * res_scale]        (project 1x1)
    out = clip(floor(y), lo_o, hi_o)

Sums are exact (integers; the TPU kernel's f32 sums are exact below 2^24
and the port's int32 sums wherever those are). Each epilogue is rounded
after the multiply and after the add, with no fused multiply-add.
"""
from __future__ import annotations

import torch

from . import _build


def _rows(t, n):
    """(2, n) epilogue rows -> (A, B), f32."""
    t = t.to(torch.float32).reshape(2, n)
    return t[0], t[1]


def mbconv_fused_plain(x_codes, we, ae, wd, ad, wp, ap, qp,
                       has_expand: bool = True, has_residual: bool = True):
    """Plain PyTorch version: the products and sums in float64 (exact for
    these integer codes), each epilogue in f32 as the kernel rounds it."""
    b, h, w, ci = x_codes.shape
    ce, co = wd.shape[1], wp.shape[1]
    hi_e, hi_d, r_s, lo_o, hi_o = qp.to(torch.float32).reshape(-1)[:5]
    x64 = x_codes.to(torch.float64).reshape(-1, ci)
    if has_expand:
        a_e, b_e = _rows(ae, ce)
        acc = (x64 @ we.to(torch.float64)).to(torch.float32)
        q1 = torch.minimum(torch.clamp(torch.floor(acc * a_e + b_e),
                                       min=0.0), hi_e)
    else:
        q1 = x64.to(torch.float32)
    q1p = torch.zeros((b, h + 2, w + 2, ce), dtype=torch.float64,
                      device=x_codes.device)
    q1p[:, 1:h + 1, 1:w + 1, :] = q1.reshape(b, h, w, ce)
    wd64 = wd.to(torch.float64).reshape(9, ce)
    acc = torch.zeros((b, h, w, ce), dtype=torch.float64,
                      device=x_codes.device)
    for k in range(9):
        di, dj = divmod(k, 3)
        acc += q1p[:, di:di + h, dj:dj + w, :] * wd64[k]
    a_d, b_d = _rows(ad, ce)
    q2 = torch.minimum(torch.clamp(
        torch.floor(acc.to(torch.float32) * a_d + b_d), min=0.0), hi_d)
    a_p, b_p = _rows(ap, co)
    accp = (q2.reshape(-1, ce).to(torch.float64)
            @ wp.to(torch.float64)).to(torch.float32)
    y = accp * a_p + b_p
    if has_residual:
        y = y + x64.to(torch.float32) * r_s
    q = torch.minimum(torch.clamp(torch.floor(y), min=lo_o), hi_o)
    return q.reshape(b, h, w, co).to(torch.int8)


def mbconv_fused(x_codes, we, ae, wd, ad, wp, ap, qp,
                 has_expand: bool = True, has_residual: bool = True):
    """Fused stride-1 inverted-residual block on centered int8 codes.

    x_codes: (B, H, W, CI) int8. we: (CI, CE) expand codes (with
    has_expand=False, CE == CI and ``we`` is not read). wd: (9, CE) dw
    codes, tap-major. wp: (CE, CO) project codes. ae, ad, ap: (2, C) f32
    epilogue rows [A; B] (B carries the +0.5 that makes floor a round).
    qp: 6 f32 scalars [hi_e, hi_d, res_scale, lo_o, hi_o, unused], with
    hi_e, hi_d <= 255. Returns (B, H, W, CO) int8 codes on the block's
    grid. CPU tensors take the plain version; CUDA tensors launch the
    kernel, which takes we, wd, wp as int8.
    """
    b, h, w, ci = x_codes.shape
    ce, co = wd.shape[1], wp.shape[1]
    if not has_expand and ce != ci:
        raise ValueError(f"without expand CE must equal CI, got {ce}, {ci}")
    if has_residual and co != ci:
        raise ValueError(f"a residual needs CO == CI, got {co}, {ci}")
    if not x_codes.is_cuda:
        return mbconv_fused_plain(x_codes, we, ae, wd, ad, wp, ap, qp,
                                  has_expand, has_residual)
    we_shape = (ci, ce) if has_expand else tuple(we.shape)
    for name, t, dtype, shape in (
            ("x_codes", x_codes, torch.int8, (b, h, w, ci)),
            ("we", we, torch.int8, we_shape),
            ("ae", ae, torch.float32, (2, ce)),
            ("wd", wd, torch.int8, (9, ce)),
            ("ad", ad, torch.float32, (2, ce)),
            ("wp", wp, torch.int8, (ce, co)),
            ("ap", ap, torch.float32, (2, co)),
            ("qp", qp, torch.float32, tuple(qp.shape))):
        if t.device != x_codes.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on "
                f"{x_codes.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if qp.numel() < 5:
        raise ValueError(f"qp holds {qp.numel()} scalars, want 6")
    out = torch.empty((b, h, w, co), dtype=torch.int8,
                      device=x_codes.device)
    lib = _build.load()
    err = lib.ssq_mbconv_fused(
        x_codes.data_ptr(), we.data_ptr(), ae.data_ptr(), wd.data_ptr(),
        ad.data_ptr(), wp.data_ptr(), ap.data_ptr(), qp.data_ptr(),
        out.data_ptr(), b, h, w, ci, ce, co, int(has_expand),
        int(has_residual), _build.stream_ptr(x_codes))
    _build.check(lib, "ssq_mbconv_fused", err)
    mbconv_fused.launches += 1
    return out


mbconv_fused.launches = 0
