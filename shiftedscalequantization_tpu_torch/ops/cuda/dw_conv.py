"""Integer depthwise KxK convolution (``csrc/dw_conv_int8.cu``).

The deploy path's ``bf16_codes`` and ``int8`` depthwise units (MNASNet's
3x3 and 5x5 units, MobileNetV2's biased-fed ``features.1.conv.0``), which
the JAX package hands to XLA (its grouped ``conv_general_dilated`` with
``feature_group_count = C``). The ``dw_int8`` kind keeps its own kernel
(``depthwise.dw_conv3x3_int8``) and its rint rounding; the units here
requant with the deploy path's ``floor(x + 0.5)`` through the
``requant.Requant`` epilogue.

``dw_conv_int8`` takes ``int_matmul.int8_conv``'s arguments, with the
depthwise weight operand ``w_mat`` (S, C, KH*KW) in (kh, kw) order, and
returns what it returns: int32 sums, the f32 scale-table sum, or with a
``requant.Requant`` the next site's int8 codes. CPU tensors take the
plain version, which is exact (shifted int32 multiply-adds, then
``int_matmul.plain_epilogue``). CUDA tensors launch the kernel, which
takes K 3 or 5 with pad K // 2 and stride 1 or 2, or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .int_matmul import _out_hw, conv_launch_outputs, plain_epilogue

KERNELS = (3, 5)
STRIDES = (1, 2)


def dw_sums(codes, w_taps, kernel, stride, padding, pad_value: int = 0):
    """Exact int32 depthwise sums of int8 codes (B, H, W, C) padded with
    ``pad_value``: one shifted int32 multiply-add per tap of ``w_taps``
    (C, KH*KW)."""
    b, h, w, c = codes.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    ho, wo = _out_hw(h, w, kernel, stride, padding)
    xp = codes.new_full((b, h + 2 * ph, w + 2 * pw, c), int(pad_value),
                        dtype=torch.int32)
    xp[:, ph:ph + h, pw:pw + w, :] = codes
    wt = w_taps.to(torch.int32).reshape(c, kh * kw)
    acc = None
    for i in range(kh):
        for j in range(kw):
            t = xp[:, i:i + sh * (ho - 1) + 1:sh,
                   j:j + sw * (wo - 1) + 1:sw, :] * wt[:, i * kw + j]
            acc = t if acc is None else acc + t
    return acc


def dw_conv_int8_plain(codes, w_mat, kernel, stride, padding, pad_value=0,
                       group_scales=None, act_delta=None, acc_offset=None,
                       requant=None):
    """Plain PyTorch version: ``dw_sums`` per weight group, then
    ``int8_conv``'s epilogue (``int_matmul.plain_epilogue``)."""
    b, h, w, c = codes.shape
    ho, wo = _out_hw(h, w, kernel, stride, padding)
    return plain_epilogue(
        lambda s: dw_sums(codes, w_mat[s], kernel, stride, padding,
                          pad_value),
        w_mat.shape[0], (b, ho, wo, c), codes.device, group_scales,
        act_delta, acc_offset, requant)


def dw_conv_int8(codes, w_mat, kernel, stride, padding, pad_value=0,
                 group_scales=None, act_delta=None, acc_offset=None,
                 requant=None):
    """Depthwise integer convolution of int8 NHWC codes.

    codes: (B, H, W, C) int8. w_mat: (S, C, KH*KW) int8 in (kh, kw) order.
    ``pad_value`` is the code outside the image. ``acc_offset`` (S, C)
    int32, if given, is added to each weight group's sums. Without
    ``group_scales`` (S must be 1) returns the int32 sums (B, Ho, Wo, C);
    with group_scales (S, C) f32 and the scalar ``act_delta`` returns ``0 +
    sum_s float(acc_s) * (group_scales[s] * act_delta)`` in f32; with
    ``requant`` int8 codes. CPU tensors take the plain version, at any
    shape; CUDA tensors launch the kernel: square K in ``KERNELS``, pad K
    // 2, equal strides in ``STRIDES``, 1 <= S <= 4."""
    if not codes.is_cuda:
        return dw_conv_int8_plain(codes, w_mat, kernel, stride, padding,
                                  pad_value, group_scales, act_delta,
                                  acc_offset, requant)
    if codes.ndim != 4 or w_mat.ndim != 3:
        raise ValueError(f"codes {tuple(codes.shape)} / w_mat "
                         f"{tuple(w_mat.shape)}: want (B, H, W, C) and "
                         "(S, C, KH*KW)")
    b, h, w, c = codes.shape
    s_n, n, k = w_mat.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    if kh != kw or kh not in KERNELS or (ph, pw) != (kh // 2, kh // 2) \
            or sh != sw or sh not in STRIDES:
        raise ValueError(f"dw kernel takes K in {KERNELS} with pad K // 2 "
                         f"and a stride in {STRIDES}; got kernel {kernel}, "
                         f"stride {stride}, padding {padding}")
    if n != c or k != kh * kw:
        raise ValueError(f"w_mat {tuple(w_mat.shape)} is not (S, {c}, "
                         f"{kh * kw})")
    ho, wo = _out_hw(h, w, kernel, stride, padding)
    out, table, delta, rq, keep = conv_launch_outputs(  # noqa: F841
        codes, w_mat, ho, wo, pad_value, group_scales, act_delta,
        acc_offset, requant)
    if s_n == 3:
        # the kernel takes 1, 2 or 4 groups: a zero fourth group adds
        # float(0) * (0 * delta), so v + 0.0, to every sum
        w_mat = torch.cat([w_mat, w_mat.new_zeros((1, n, k))])
        table = torch.cat([table, table.new_zeros((1, n))])
        if acc_offset is not None:
            acc_offset = torch.cat([acc_offset, acc_offset.new_zeros((1, n))])
        s_n = 4
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load()
    err = lib.ssq_dw_conv_int8(
        codes.data_ptr(), w_mat.data_ptr(), ptr(table), ptr(acc_offset),
        ptr(delta), out.data_ptr(), s_n, b, h, w, c, kh, sh, int(pad_value),
        None if rq is None else ctypes.addressof(rq),
        _build.stream_ptr(codes))
    _build.check(lib, "ssq_dw_conv_int8", err)
    dw_conv_int8.launches += 1
    return out


dw_conv_int8.launches = 0
