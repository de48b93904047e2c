"""Fused ResNet stem: 7x7/s2/p3 conv + ReLU + act quant + 3x3/s2/p1 maxpool
on the codes, in one pass.

Port of ``shiftedscalequantization_tpu/ops/pallas/stem.py`` (kernel
``_stem_kernel`` via ``stem_fused``). The CUDA kernel is
``csrc/stem_fused.cu``; its source note gives the bound on an H100 and what
the design does about it. Like the TPU kernel it runs the conv as two bf16
products with f32 accumulation (``split_hi_lo``; the weight codes cast to
bf16, laid out K-major by ``stem_weight_layout``); the TPU kernel's banded
weight matrix (``build_stem_weights``) is a Mosaic workaround and has no
counterpart. The plain version is the f32 conv; ``stem_2pass_plain``
emulates the kernel's product in PyTorch.

What a launch reads besides the image depends only on the deploy params
and the plan, so ``prepare_stem`` builds it once (``StemConsts``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ...graph import _fp32
from . import _build
from .packed import _scalar

KROW = 22        # contraction per kernel row: 7 kw x 3 channels + 1 zero
K = 160          # 7 kernel rows of KROW, padded to 10 wgmma k-steps of 16
MAX_OC = 64


@dataclasses.dataclass(frozen=True)
class StemConsts:
    """The stem's launch constants, on one device.

    w: (OC, 3, 7, 7) f32 codes (the plain version's); w_k: the kernel's
    K-major bf16 layout (``stem_weight_layout``); scale, bias:
    (OC,) f32; qp: (4,) f32 [1/delta, zp, qmax, center_off]."""
    w: torch.Tensor
    w_k: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    qp: torch.Tensor

    @property
    def device(self):
        return self.w.device


def _k_index():
    """Contraction index of each (ch, kh, kw) tap: 22 kh + 3 kw + ch."""
    ch, kh, kw = torch.meshgrid(torch.arange(3), torch.arange(7),
                                torch.arange(7), indexing="ij")
    return (KROW * kh + 3 * kw + ch).reshape(-1)


def stem_weight_matrix(w_codes) -> torch.Tensor:
    """(OC, 3, 7, 7) codes -> (OC, K) bf16 K-major, k = 22 kh + 3 kw + ch,
    zero elsewhere. Exact for integer codes of at most 8 significant
    bits."""
    oc = w_codes.shape[0]
    out = torch.zeros((oc, K), dtype=torch.bfloat16, device=w_codes.device)
    out[:, _k_index().to(w_codes.device)] = \
        w_codes.reshape(oc, -1).to(torch.bfloat16)
    return out


def stem_weight_layout(w_codes) -> torch.Tensor:
    """The kernel's B operand: ``stem_weight_matrix`` cut into wgmma's
    K-major core matrices, (K / 16, OC / 8, 2, 8, 8): k-step, 8-channel
    block, k half, channel, k; each core matrix 128 contiguous bytes."""
    oc = w_codes.shape[0]
    return stem_weight_matrix(w_codes).reshape(oc // 8, 8, K // 16, 2, 8) \
        .permute(2, 0, 3, 1, 4).contiguous()


def unpack_stem_weights(w_k) -> torch.Tensor:
    """Inverse of ``stem_weight_layout``: (OC, 3, 7, 7) f32."""
    oc = w_k.shape[1] * 8
    m = w_k.permute(1, 3, 0, 2, 4).reshape(oc, K)
    return m[:, _k_index().to(w_k.device)].to(torch.float32) \
        .reshape(oc, 3, 7, 7)


def split_hi_lo(x):
    """The 2-pass split of f32 values: hi = bf16(x), lo = bf16(x - hi),
    both rounded to nearest even (JAX ``stem.py:131-132``)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


def prepare_stem(w_codes, scale_oc, bias_oc, out_delta, out_zp, out_qmax,
                 center_off) -> StemConsts:
    """The stem's launch constants on ``w_codes``'s device; the reciprocal
    is one f32 division there, as the TPU kernel's host side takes it."""
    dev = w_codes.device
    oc = w_codes.shape[0]
    w = w_codes.to(torch.float32).contiguous()
    qp = torch.stack([1.0 / _scalar(out_delta, dev),
                      *(_scalar(v, dev)
                        for v in (out_zp, out_qmax, center_off))])
    return StemConsts(
        w=w, w_k=stem_weight_layout(w).contiguous(),
        scale=scale_oc.to(device=dev, dtype=torch.float32).reshape(oc)
        .contiguous(),
        bias=bias_oc.to(device=dev, dtype=torch.float32).reshape(oc)
        .contiguous(),
        qp=qp)


def _requant_pool(y, k: StemConsts):
    """relu(y * scale + bias) onto the grid, then the max pool on the codes
    with -128 padding; y: (B, Hc, Wc, OC) f32 conv sums."""
    inv_d, zp, qmax, coff = k.qp
    y = torch.relu(y * k.scale + k.bias)
    q = torch.clamp(torch.round(y * inv_d) + zp, min=0.0)
    q = torch.minimum(q, qmax) - coff
    q = F.pad(q.permute(0, 3, 1, 2), (1, 1, 1, 1), value=-128.0)
    return F.max_pool2d(q, 3, 2).permute(0, 2, 3, 1).to(torch.int8)


def _conv(x_nhwc, w):
    with _fp32():
        return F.conv2d(x_nhwc.permute(0, 3, 1, 2), w, None, 2, 3) \
            .permute(0, 2, 3, 1)


def stem_plain_prepared(x_nhwc, k: StemConsts):
    """Plain PyTorch version: f32 conv (TF32 off), relu(y * scale + bias),
    clip(round(y * (1/delta)) + zp, 0, qmax) - center_off, then the max
    pool on the codes with -128 padding."""
    return _requant_pool(_conv(x_nhwc, k.w), k)


def stem_2pass_plain(x_nhwc, k: StemConsts):
    """The kernel's product emulated in PyTorch: the f32 conv of hi and of
    lo with the bf16 weight codes (read back from the kernel's layout),
    added, then the same epilogue as the plain version."""
    hi, lo = split_hi_lo(x_nhwc)
    w = unpack_stem_weights(k.w_k)
    return _requant_pool(_conv(hi.to(torch.float32), w)
                         + _conv(lo.to(torch.float32), w), k)


def stem_fused_plain(x_nhwc, w_codes, scale_oc, bias_oc, out_delta, out_zp,
                     out_qmax, center_off):
    """Plain PyTorch version of ``stem_fused``."""
    return stem_plain_prepared(x_nhwc, prepare_stem(
        w_codes, scale_oc, bias_oc, out_delta, out_zp, out_qmax, center_off))


def stem_fused_prepared(x_nhwc, k: StemConsts):
    """``stem_fused`` on constants from ``prepare_stem``: CPU tensors take
    the plain version; CUDA tensors launch the kernel and nothing else."""
    if not x_nhwc.is_cuda:
        return stem_plain_prepared(x_nhwc, k)
    b, h, w, c = x_nhwc.shape
    oc = k.w.shape[0]
    if c != 3 or h % 4 or w % 4:
        raise ValueError(f"stem kernel takes (B, H, W, 3) with H, W "
                         f"multiples of 4, got {tuple(x_nhwc.shape)}")
    if oc % 16 or not 16 <= oc <= MAX_OC:
        raise ValueError(f"stem kernel takes OC a multiple of 16 up to "
                         f"{MAX_OC}, got {oc}")
    for name, t, dtype, shape in (
            ("x", x_nhwc, torch.float32, (b, h, w, 3)),
            ("w_k", k.w_k, torch.bfloat16, (K // 16, oc // 8, 2, 8, 8)),
            ("scale", k.scale, torch.float32, (oc,)),
            ("bias", k.bias, torch.float32, (oc,)),
            ("qp", k.qp, torch.float32, (4,))):
        if t.device != x_nhwc.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on "
                f"{x_nhwc.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    for name, t in (("x", x_nhwc), ("w_k", k.w_k)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((b, h // 4, w // 4, oc), dtype=torch.int8,
                      device=x_nhwc.device)
    lib = _build.load()
    err = lib.ssq_stem_fused(
        x_nhwc.data_ptr(), k.w_k.data_ptr(), k.scale.data_ptr(),
        k.bias.data_ptr(), k.qp.data_ptr(), out.data_ptr(), b, h, w, oc,
        _build.stream_ptr(x_nhwc))
    _build.check(lib, "ssq_stem_fused", err)
    stem_fused.launches += 1
    return out


def stem_fused(x_nhwc, w_codes, scale_oc, bias_oc, out_delta, out_zp,
               out_qmax, center_off):
    """Fused 7x7/s2/p3 conv + ReLU + act quant + 3x3/s2/p1 maxpool.

    x_nhwc: (B, H, W, 3) f32 with H, W multiples of 4. w_codes: (OC, 3, 7,
    7) f32 integer codes (bf16-exact), OC a multiple of 16 up to 64.
    scale_oc, bias_oc: (OC,) f32. Output grid: q = clip(round(y/delta)+zp,
    0, qmax) with delta > 0 and an integer zp, stored codes q - center_off
    (128: biased int8 transport; zp: centered). Returns (B, H/4, W/4, OC)
    int8. CPU tensors take the plain version; CUDA tensors launch the
    kernel. A caller that runs the stem again builds its constants once
    with ``prepare_stem`` and calls ``stem_fused_prepared``.
    """
    return stem_fused_prepared(x_nhwc, prepare_stem(
        w_codes, scale_oc, bias_oc, out_delta, out_zp, out_qmax, center_off))


stem_fused.launches = 0
