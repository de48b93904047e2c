"""Int8 GEMM kernels: fused quantize -> int8 GEMM -> dequant, and the int8
implicit-GEMM convolution grown from it.

Port of ``shiftedscalequantization_tpu/ops/pallas/int_matmul.py`` (kernel
``_qmm_kernel`` via ``quant_matmul`` and ``quant_conv1x1``). The same CUDA
kernel core, ``csrc/int_matmul.cu``, also computes ``int8_conv``: the
integer convolution of the deploy path's ``int8``/``bf16_codes`` units,
which the JAX package leaves to XLA (``deploy._int_conv``). Its source
note gives the bound on an H100 and what the design does about it.

``int8_conv`` writes int32 sums, the f32 scale-table sum, or, given a
``requant.Requant``, the next site's int8 codes straight from its epilogue.

Each wrapper takes its plain PyTorch version for CPU tensors and launches
the kernel for CUDA tensors, or raises on what the kernel does not take.
The plain versions are exact: integer products summed in float64 (every
sum here is below 2^53) and f32 epilogues rounded step by step.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .packed import _scalar
from .requant import device_args, requant_plain

MAX_GROUPS = 4          # weight groups (shift candidates) the kernel takes


def _check(name, t, device, dtype, shape):
    if t.device != device or t.dtype != dtype \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


# ---------------------------------------------------------------------------
# quant_matmul: the TPU kernel's own function
# ---------------------------------------------------------------------------

def quant_matmul_plain(x, w_kn, scale_n, bias_n, act_delta, act_zp,
                       act_n_bits: int = 4, relu: bool = False):
    """Plain PyTorch version: quantize x by division with half-to-even
    rounding, exact integer product, f32 epilogue acc * (scale * delta) +
    bias, optional ReLU."""
    delta = _scalar(act_delta, x.device)
    zp = _scalar(act_zp, x.device)
    q = torch.clamp(torch.round(x / delta) + zp, 0, 2 ** act_n_bits - 1) - zp
    acc = q.to(torch.float64) @ w_kn.to(torch.float64)
    out = acc.to(torch.float32) * (scale_n * delta) + bias_n
    return torch.relu(out) if relu else out


def quant_matmul(x, w_kn, scale_n, bias_n, act_delta, act_zp,
                 act_n_bits: int = 4, relu: bool = False):
    """y = relu?(int8mm(quant(x), w) * (scale * delta) + bias).

    x: (M, K) f32 (the kernel quantizes it onto the act grid). w_kn: (K, N)
    centered int8 codes. scale_n, bias_n: (N,) f32. act_delta, act_zp:
    scalars (0-d tensors stay on the device). The centered act codes must
    fit int8, as on the TPU. CPU tensors take the plain version."""
    if not x.is_cuda:
        return quant_matmul_plain(x, w_kn, scale_n, bias_n, act_delta,
                                  act_zp, act_n_bits, relu)
    if not 1 <= act_n_bits <= 8:
        raise ValueError(f"act_n_bits must be in 1..8, got {act_n_bits}")
    if x.ndim != 2 or w_kn.ndim != 2 or w_kn.shape[0] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w_kn.shape)} "
                         "are not (M, K) and (K, N)")
    m, k = x.shape
    n = w_kn.shape[1]
    for name, t, dtype, shape in (("x", x, torch.float32, (m, k)),
                                  ("w", w_kn, torch.int8, (k, n)),
                                  ("scale", scale_n, torch.float32, (n,)),
                                  ("bias", bias_n, torch.float32, (n,))):
        _check(name, t, x.device, dtype, shape)
    qp = torch.stack([_scalar(act_delta, x.device),
                      _scalar(act_zp, x.device), _scalar(0.0, x.device),
                      _scalar(2 ** act_n_bits - 1, x.device)])
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = _build.load()
    err = lib.ssq_quant_matmul(
        x.data_ptr(), w_kn.data_ptr(), scale_n.data_ptr(), bias_n.data_ptr(),
        qp.data_ptr(), out.data_ptr(), m, k, n, int(relu),
        _build.stream_ptr(x))
    _build.check(lib, "ssq_quant_matmul", err)
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def quant_conv1x1(x_nhwc, w_oi, scale, bias, act_delta, act_zp,
                  act_n_bits: int = 4, stride=(1, 1), relu: bool = False):
    """1x1 conv as quant_matmul: subsample for stride, then reshape.
    w_oi: (O, I) int8."""
    if tuple(stride) != (1, 1):
        x_nhwc = x_nhwc[:, ::stride[0], ::stride[1], :]
    n, h, w, c = x_nhwc.shape
    y = quant_matmul(x_nhwc.reshape(-1, c).contiguous(),
                     w_oi.T.contiguous(), scale, bias, act_delta, act_zp,
                     act_n_bits, relu)
    return y.reshape(n, h, w, -1)


# ---------------------------------------------------------------------------
# int8_conv: implicit-GEMM convolution of int8 NHWC codes
# ---------------------------------------------------------------------------

def _out_hw(h, w, kernel, stride, padding):
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


def im2col(x, kernel, stride, padding, pad_value: int):
    """(B, H, W, C) -> (B*Ho*Wo, KH*KW*C) patches in (kh, kw, c) order,
    padded with ``pad_value``."""
    b, h, w, c = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    ho, wo = _out_hw(h, w, kernel, stride, padding)
    if (kh, kw, ph, pw) == (1, 1, 0, 0):
        return x[:, ::sh, ::sw, :].reshape(b * ho * wo, c), (b, ho, wo)
    xp = x.new_full((b, h + 2 * ph, w + 2 * pw, c), pad_value)
    xp[:, ph:ph + h, pw:pw + w, :] = x
    cols = [xp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    return torch.stack(cols, dim=3).reshape(b * ho * wo, kh * kw * c), \
        (b, ho, wo)


def plain_epilogue(acc_of, s_n, out_shape, device, group_scales=None,
                   act_delta=None, acc_offset=None, requant=None):
    """The conv plain versions' epilogue on weight group s's exact int32
    sums ``acc_of(s)`` (M, N): ``acc_offset`` added; the int32 sums (S =
    1, no table), else the f32 scale-table sum ``0 + sum_s float(acc_s) *
    (table[s] * delta)``; with ``requant``, that value (the sums as f32
    without a table) through ``requant.requant_plain``: int8 codes."""
    delta = None if group_scales is None else _scalar(act_delta, device)
    out = 0.0
    for s in range(s_n):
        acc = acc_of(s)
        if acc_offset is not None:
            acc = acc + acc_offset[s]
        if group_scales is None:
            out = acc
            break
        out = out + acc.to(torch.float32) * (group_scales[s] * delta)
    out = out.reshape(out_shape)
    if requant is not None:
        return requant_plain(out.to(torch.float32), requant)
    return out


def int8_conv_plain(codes, w_mat, kernel, stride, padding, pad_value=0,
                    group_scales=None, act_delta=None, acc_offset=None,
                    requant=None):
    """Plain PyTorch version: im2col, one exact integer product per weight
    group (float64), then ``plain_epilogue``."""
    a, (b, ho, wo) = im2col(codes, kernel, stride, padding, pad_value)
    a = a.to(torch.float64)
    return plain_epilogue(
        lambda s: (a @ w_mat[s].to(torch.float64).T).to(torch.int32),
        w_mat.shape[0], (b, ho, wo, -1), codes.device, group_scales,
        act_delta, acc_offset, requant)


def conv_launch_outputs(codes, w_mat, ho, wo, pad_value, group_scales,
                        act_delta, acc_offset, requant):
    """The checks the conv kernels' wrappers make before a launch, and
    what the launch writes to: (out, table, delta, requant args, tensors
    to keep alive until the launch is queued)."""
    dev = codes.device
    b, h, w, c = codes.shape
    s_n, n, k = w_mat.shape
    if not 1 <= s_n <= MAX_GROUPS or (group_scales is None and s_n != 1):
        raise ValueError(f"kernel takes 1..{MAX_GROUPS} weight groups, and "
                         f"one without a scale table; got S={s_n}")
    if not -128 <= int(pad_value) <= 127:
        raise ValueError(f"pad_value {pad_value} is not an int8 code")
    if ho <= 0 or wo <= 0 or b * ho * wo >= 2 ** 31 \
            or codes.numel() >= 2 ** 31 or w_mat.numel() >= 2 ** 31:
        raise ValueError(f"output {b}x{ho}x{wo} is empty or too large")
    _check("codes", codes, dev, torch.int8, (b, h, w, c))
    _check("w_mat", w_mat, dev, torch.int8, (s_n, n, k))
    if acc_offset is not None:
        _check("acc_offset", acc_offset, dev, torch.int32, (s_n, n))
    if group_scales is None:
        table = delta = None
        dtype = torch.int32
    else:
        _check("group_scales", group_scales, dev, torch.float32, (s_n, n))
        table, delta = group_scales, _scalar(act_delta, dev)
        dtype = torch.float32
    out = torch.empty((b, ho, wo, n), device=dev,
                      dtype=dtype if requant is None else torch.int8)
    rq, keep = (None, None) if requant is None \
        else device_args(requant, n, out.shape, dev)
    return out, table, delta, rq, keep


def int8_conv(codes, w_mat, kernel, stride, padding, pad_value=0,
              group_scales=None, act_delta=None, acc_offset=None,
              requant=None):
    """Integer convolution of int8 NHWC codes (groups = 1).

    codes: (B, H, W, C) int8. w_mat: (S, N, KH*KW*C) int8 in (kh, kw, c)
    order. ``pad_value`` is the code outside the image. ``acc_offset``
    (S, N) int32, if given, is added to each group's sums. Without
    ``group_scales`` (S must be 1) returns the int32 sums (B, Ho, Wo, N);
    with group_scales (S, N) f32 and the scalar ``act_delta`` returns
    ``0 + sum_s float(acc_s) * (group_scales[s] * act_delta)`` in f32.
    With ``requant`` (a ``requant.Requant``) returns int8 codes (B, Ho,
    Wo, N): that value (the int32 sums as f32 without a table) through
    the requant epilogue. CPU tensors take the plain version, at any
    shape; CUDA tensors launch the kernel, which takes 1 <= S <= 4."""
    if not codes.is_cuda:
        return int8_conv_plain(codes, w_mat, kernel, stride, padding,
                               pad_value, group_scales, act_delta,
                               acc_offset, requant)
    if codes.ndim != 4 or w_mat.ndim != 3:
        raise ValueError(f"codes {tuple(codes.shape)} / w_mat "
                         f"{tuple(w_mat.shape)}: want (B, H, W, C) and "
                         "(S, N, K)")
    b, h, w, c = codes.shape
    s_n, n, k = w_mat.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    ho, wo = _out_hw(h, w, kernel, stride, padding)
    if k != kh * kw * c:
        raise ValueError(f"w_mat K={k} is not KH*KW*C={kh * kw * c}")
    out, table, delta, rq, keep = conv_launch_outputs(  # noqa: F841
        codes, w_mat, ho, wo, pad_value, group_scales, act_delta,
        acc_offset, requant)
    if s_n == 3:
        # the kernel's wgmma widths take 1, 2 or 4 groups: a zero fourth
        # group adds float(0) * (0 * delta), so v + 0.0, to every sum
        w_mat = torch.cat([w_mat, w_mat.new_zeros((1, n, k))])
        table = torch.cat([table, table.new_zeros((1, n))])
        if acc_offset is not None:
            acc_offset = torch.cat([acc_offset, acc_offset.new_zeros((1, n))])
        s_n = 4
    # 16-byte gathers need whole 16-channel chunks at aligned addresses
    vec = int(c % 16 == 0 and codes.data_ptr() % 16 == 0
              and w_mat.data_ptr() % 16 == 0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load()
    err = lib.ssq_int8_conv(
        codes.data_ptr(), w_mat.data_ptr(), ptr(table), ptr(acc_offset),
        ptr(delta), out.data_ptr(), s_n, b, h, w, c, kh, kw, sh, sw, ph, pw,
        n, int(pad_value), vec,
        None if rq is None else ctypes.addressof(rq),
        _build.stream_ptr(codes))
    _build.check(lib, "ssq_int8_conv", err)
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
