"""Packed W2/W4 weight matmul with fused activation quantization.

Port of ``shiftedscalequantization_tpu/ops/pallas/packed.py`` (kernel
``_pqmm_kernel`` via ``packed_quant_matmul``; host ``pack_codes`` and
``unpack_codes``). The CUDA kernel is ``csrc/packed_qmm.cu``; its source
note gives the bound on an H100 and what the design does about it.

The kernel takes int8 codes or f32 rows, reads a strided 1x1 conv's rows
in place, and writes f32 or, given a ``requant.Requant``, the next site's
int8 codes from its epilogue.

Packing differs from the TPU's strided layout, which served
``pltpu.repeat``: here ``pack_codes`` returns (N, ceil(K/f)) int32 with
word (n, j) holding the raw codes k = j*f + s of column n in bit slot s
(f = 32 // bits), so one word unpacks to f consecutive K positions.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .requant import device_args, requant_plain


def pack_codes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack raw codes (K, N) in [0, 2^bits) into (N, ceil(K/f)) int32."""
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    f = 32 // bits
    k, n = q.shape
    kw = -(-k // f)
    qt = torch.zeros((n, kw * f), dtype=torch.int64, device=q.device)
    qt[:, :k] = q.T.to(torch.int64)
    shifts = torch.arange(f, device=q.device, dtype=torch.int64) * bits
    words = (qt.reshape(n, kw, f) << shifts).sum(dim=-1)    # < 2^32
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_codes(words: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Inverse of pack_codes: (K, N) int32 raw codes."""
    f = 32 // bits
    n, kw = words.shape
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(f, device=words.device, dtype=torch.int64) * bits
    parts = (w[..., None] >> shifts) & ((1 << bits) - 1)     # (N, KW, f)
    return parts.reshape(n, kw * f)[:, :k].T.to(torch.int32)


def _scalar(v, device) -> torch.Tensor:
    """0-d f32 on ``device``; a Python number becomes a fill, not a copy
    from the host, so a launch never waits for the card."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _rows(x, stride: int):
    """(rows, leading shape) of a 4-D NHWC feed at a 1x1 conv's stride, or
    of (M, K) rows."""
    if x.ndim == 4:
        if stride != 1:
            x = x[:, ::stride, ::stride, :]
        return x.reshape(-1, x.shape[-1]), x.shape[:-1]
    return x, x.shape[:-1]


def packed_quant_matmul_plain(x, w_packed, w_zp_n, scale_n, bias_n,
                              act_delta, act_zp, bits: int,
                              act_n_bits: int = 4, relu: bool = False,
                              stride: int = 1, requant=None):
    """Plain PyTorch version of the kernel: int8 codes as they are, or f32
    quantized by division with half-to-even rounding; unpack, integer
    product (exact in float64), f32 epilogue acc * (scale * delta) + bias,
    then ``requant.requant_plain`` when ``requant`` is given."""
    rows, lead = _rows(x, stride)
    delta = _scalar(act_delta, x.device)
    if x.dtype == torch.int8:
        q = rows
    else:
        zp = _scalar(act_zp, x.device)
        q = torch.clamp(torch.round(rows / delta) + zp, 0,
                        2 ** act_n_bits - 1) - zp
    wc = (unpack_codes(w_packed, bits, rows.shape[1]).to(torch.float64)
          - torch.round(w_zp_n).to(torch.float64))
    acc = q.to(torch.float64) @ wc
    out = acc.to(torch.float32) * (scale_n * delta) + bias_n
    if relu:
        out = torch.relu(out)
    out = out.reshape(*lead, -1)
    return out if requant is None else requant_plain(out, requant)


def packed_quant_matmul(x, w_packed, w_zp_n, scale_n, bias_n, act_delta,
                        act_zp, bits: int, act_n_bits: int = 4,
                        relu: bool = False, stride: int = 1, requant=None):
    """y = relu?(dequant(int8mm(q, unpack(w_packed) - zp_w))).

    x: rows (M, K) or an NHWC feed (B, H, W, K), f32 (quantized on the
    way in: q = clip(rint(x / delta) + zp) - zp) or int8 codes on the
    grid of step ``act_delta`` (taken as they are). A 4-D feed is a 1x1
    conv: ``stride`` subsamples its rows, which the kernel reads in place.
    w_packed: (N, ceil(K/f)) int32 from pack_codes. w_zp_n, scale_n,
    bias_n: (N,) f32. act_delta, act_zp: scalars (0-d tensors stay on the
    device, so the call never waits for the card). Returns f32 (..., N),
    or with ``requant`` (a ``requant.Requant``) int8 codes (..., N). CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    if not x.is_cuda:
        return packed_quant_matmul_plain(x, w_packed, w_zp_n, scale_n,
                                         bias_n, act_delta, act_zp, bits,
                                         act_n_bits, relu, stride, requant)
    if bits not in (2, 4):
        raise ValueError(f"packed kernel takes 2- or 4-bit codes, got {bits}")
    if not 1 <= act_n_bits <= 8:
        raise ValueError(f"act_n_bits must be in 1..8, got {act_n_bits}")
    if x.dtype not in (torch.float32, torch.int8) or x.ndim not in (2, 4) \
            or not x.is_contiguous():
        raise ValueError(f"x: want contiguous f32 or int8 (M, K) or (B, H, "
                         f"W, K), got {x.dtype} {tuple(x.shape)}")
    if stride < 1 or (stride != 1 and x.ndim != 4):
        raise ValueError(f"stride {stride} needs a 4-D feed")
    if x.ndim == 4:
        b, h, w, k = x.shape
    else:
        (b, k), h, w = x.shape, 1, 1
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    m = b * ho * wo
    n, kw = w_packed.shape
    if kw != -(-k // (32 // bits)):
        raise ValueError(f"w_packed {tuple(w_packed.shape)} does not hold "
                         f"K={k} {bits}-bit codes")
    if x.numel() >= 2 ** 31 or m * n >= 2 ** 31 or -(-m // 128) > 65535:
        raise ValueError(f"{m} x {n} outputs of K={k} are too many")
    for name, t, dtype, shape in (
            ("w_packed", w_packed, torch.int32, (n, kw)),
            ("w_zp", w_zp_n, torch.float32, (n,)),
            ("scale", scale_n, torch.float32, (n,)),
            ("bias", bias_n, torch.float32, (n,))):
        if t.device != x.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    qp = torch.stack([_scalar(act_delta, x.device),
                      _scalar(act_zp, x.device),
                      _scalar(0.0, x.device),
                      _scalar(2 ** act_n_bits - 1, x.device)])
    lead = (b, ho, wo) if x.ndim == 4 else (m,)
    codes = x.dtype == torch.int8
    if codes:
        vec = next(v for v in (16, 8, 1)
                   if k % v == 0 and x.data_ptr() % v == 0)
    else:
        vec = 4 if k % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    out = torch.empty((*lead, n), device=x.device,
                      dtype=torch.float32 if requant is None else torch.int8)
    rq = None
    if requant is not None:
        rq, keep = device_args(requant, n, out.shape, x.device)  # noqa: F841
    lib = _build.load()
    err = lib.ssq_packed_qmm(
        x.data_ptr(), int(codes), w_packed.data_ptr(), w_zp_n.data_ptr(),
        scale_n.data_ptr(), bias_n.data_ptr(), qp.data_ptr(),
        out.data_ptr(), b, h, w, k, stride, n, bits, int(relu), vec,
        None if rq is None else ctypes.addressof(rq), _build.stream_ptr(x))
    _build.check(lib, "ssq_packed_qmm", err)
    packed_quant_matmul.launches += 1
    return out


packed_quant_matmul.launches = 0
