"""Grouped int8 implicit-GEMM convolution (``csrc/int8_group_conv.cu``).

The deploy path's grouped integer convs (RegNetX's f.b units, served as
``int8`` or ``bf16_codes``), which the JAX package hands to XLA
(``deploy._int_conv`` with ``feature_group_count``). Two kinds of groups
are kept apart here:

- conv groups (``conv_groups``, G): the conv's feature groups. Output
  channel ``oc`` belongs to conv group ``oc // (OC / G)`` and reads input
  channels ``[g*Cg, (g+1)*Cg)``, Cg = C / G;
- weight groups (S): the shift candidates of a baked unit, each its own
  masked weight with a row of the scale table, as in ``int8_conv``.

``int8_group_conv`` takes ``int_matmul.int8_conv``'s arguments plus
``conv_groups`` and returns what it returns: int32 sums, the f32
scale-table sum, or with a ``requant.Requant`` the next site's int8
codes. CPU tensors take the plain version, which is exact (integer
products summed in float64; every sum here is below 2^53).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .int_matmul import _out_hw, conv_launch_outputs, im2col, plain_epilogue


def _group_patches(codes, kernel, stride, padding, pad_value, conv_groups):
    """(G, B*Ho*Wo, KH*KW*Cg) patches of each conv group, (kh, kw, ic)
    order, padded with ``pad_value``."""
    a, shape = im2col(codes, kernel, stride, padding, pad_value)
    m, c = a.shape[0], codes.shape[3]
    cg = c // conv_groups
    a = a.reshape(m, -1, conv_groups, cg).permute(2, 0, 1, 3)
    return a.reshape(conv_groups, m, -1), shape


def int8_group_conv_plain(codes, w_mat, kernel, stride, padding,
                          conv_groups, pad_value=0, group_scales=None,
                          act_delta=None, acc_offset=None, requant=None):
    """Plain PyTorch version: each conv group's patches times its rows of
    each weight group, exact in float64, then ``int8_conv``'s epilogue
    (``int_matmul.plain_epilogue``)."""
    a, (b, ho, wo) = _group_patches(codes, kernel, stride, padding,
                                    pad_value, conv_groups)
    a = a.to(torch.float64)
    s_n, n, k = w_mat.shape
    m = a.shape[1]

    def acc_of(s):
        wg = w_mat[s].reshape(conv_groups, n // conv_groups, k) \
            .to(torch.float64)
        return torch.bmm(a, wg.transpose(1, 2)).permute(1, 0, 2) \
            .reshape(m, n).to(torch.int32)

    return plain_epilogue(acc_of, s_n, (b, ho, wo, n), codes.device,
                          group_scales, act_delta, acc_offset, requant)


def int8_group_conv(codes, w_mat, kernel, stride, padding, conv_groups,
                    pad_value=0, group_scales=None, act_delta=None,
                    acc_offset=None, requant=None):
    """Grouped integer convolution of int8 NHWC codes.

    codes: (B, H, W, C) int8. w_mat: (S, OC, KH*KW*Cg) int8 in (kh, kw,
    ic) order, Cg = C / conv_groups. ``pad_value`` is the code outside
    the image. ``acc_offset`` (S, OC) int32, if given, is added to each
    weight group's sums. Without ``group_scales`` (S must be 1) returns
    the int32 sums (B, Ho, Wo, OC); with group_scales (S, OC) f32 and the
    scalar ``act_delta`` returns ``0 + sum_s float(acc_s) *
    (group_scales[s] * act_delta)`` in f32; with ``requant`` int8 codes.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes 1 <= S <= 4."""
    if not codes.is_cuda:
        return int8_group_conv_plain(codes, w_mat, kernel, stride, padding,
                                     conv_groups, pad_value, group_scales,
                                     act_delta, acc_offset, requant)
    if codes.ndim != 4 or w_mat.ndim != 3:
        raise ValueError(f"codes {tuple(codes.shape)} / w_mat "
                         f"{tuple(w_mat.shape)}: want (B, H, W, C) and "
                         "(S, OC, K)")
    b, h, w, c = codes.shape
    s_n, n, k = w_mat.shape
    g = int(conv_groups)
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    ho, wo = _out_hw(h, w, kernel, stride, padding)
    if g < 1 or c % g or n % g:
        raise ValueError(f"{g} conv groups do not divide C={c} and OC={n}")
    cg = c // g
    if k != kh * kw * cg:
        raise ValueError(f"w_mat K={k} is not KH*KW*Cg={kh * kw * cg}")
    out, table, delta, rq, keep = conv_launch_outputs(  # noqa: F841
        codes, w_mat, ho, wo, pad_value, group_scales, act_delta,
        acc_offset, requant)
    # the widest load that divides a group's channels, at aligned addresses
    vec = next(v for v in (16, 8, 4, 1)
               if cg % v == 0 and codes.data_ptr() % v == 0
               and w_mat.data_ptr() % v == 0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load()
    err = lib.ssq_int8_group_conv(
        codes.data_ptr(), w_mat.data_ptr(), ptr(table), ptr(acc_offset),
        ptr(delta), out.data_ptr(), s_n, b, h, w, c, kh, kw, sh, sw, ph, pw,
        n, g, int(pad_value), vec,
        None if rq is None else ctypes.addressof(rq),
        _build.stream_ptr(codes))
    _build.check(lib, "ssq_int8_group_conv", err)
    int8_group_conv.launches += 1
    return out


int8_group_conv.launches = 0
