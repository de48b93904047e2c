"""The requant epilogue of the integer GEMM kernels (``int8_conv``,
``packed_quant_matmul``): the deploy path's ``quantize_out`` applied to
the kernel's f32 value before it leaves the card's registers, so the unit
writes the next site's int8 codes instead of f32 sums.

The JAX package defines the requant as one multiply-add in code space,
``q = clip(floor(acc*M + C), lo, hi)`` (JAX ``deploy.quantize_out``), with
relu and relu6 folded into the clip and a residual entering the same
chain as ``floor(acc*M + r*Mr + C)``; XLA fuses it into the producer. A
``Requant`` holds those terms per output column, built on the device by
``deploy.quantize_out`` with the torch expressions of its elementwise
route, so the kernel's codes are that route's codes bit for bit.
``requant_plain`` is the plain version, in the kernel's order
(``csrc/requant.cuh``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class Requant:
    """Per output column n, from the kernel's f32 value v::

        u = v [* m1[n]] [+ c1[n]]
        q1:  u = clip(floor(u), lo1, hi1) - sub1
        q2:  u = clip(floor(u * m2[n] [+ r * mr] + c2[n]), lo2, hi2) - sub2
        out = int8(u)

    Stage 1 is the unit's own epilogue: its requant onto its own site
    (``q1`` set), or the f32 affine the sums would be materialized with
    (``q1`` None). Stage 2 (``q2`` set) requantizes onto the block's site
    with the residual ``r`` (int8 codes or f32, shaped like the output).
    Per-column terms broadcast to (N,); ``q1``/``q2`` are (lo, hi, sub)
    and ``mr`` is a scalar, 0-d tensors or numbers."""
    m1: Optional[Tensor] = None
    c1: Optional[Tensor] = None
    q1: Optional[tuple] = None
    m2: Optional[Tensor] = None
    c2: Optional[Tensor] = None
    q2: Optional[tuple] = None
    r: Optional[Tensor] = None
    mr: Optional[object] = None

    def __post_init__(self):
        if self.q2 is None:
            if self.q1 is None or self.m2 is not None or self.r is not None:
                raise ValueError("a Requant ends in a quantizing stage: q1 "
                                 "alone, or stage 2 with q2")
        elif self.m2 is None or self.c2 is None:
            raise ValueError("stage 2 needs m2 and c2")
        if (self.r is None) != (self.mr is None):
            raise ValueError("a residual needs r and mr together")


def clip(x, lo, hi):
    """clip with float or 0-d tensor bounds (deploy's clip)."""
    x = torch.maximum(x, lo) if torch.is_tensor(lo) else x.clamp(min=lo)
    return torch.minimum(x, hi) if torch.is_tensor(hi) else x.clamp(max=hi)


def requant_plain(v: Tensor, rq: Requant) -> Tensor:
    """Plain version of the epilogue on f32 values ``v`` (..., N): the
    kernel's steps as separate torch ops, each rounded once."""
    u = v
    if rq.m1 is not None:
        u = u * rq.m1
    if rq.c1 is not None:
        u = u + rq.c1
    if rq.q1 is not None:
        lo, hi, sub = rq.q1
        u = clip(torch.floor(u), lo, hi) - sub
    if rq.q2 is not None:
        w = u * rq.m2
        if rq.r is not None:
            w = w + rq.r.reshape(v.shape).to(torch.float32) * rq.mr
        lo, hi, sub = rq.q2
        u = clip(torch.floor(w + rq.c2), lo, hi) - sub
    return u.to(torch.int8)


class RequantArgs(ctypes.Structure):
    """``struct Requant`` of ``csrc/requant.cuh``."""
    _fields_ = [("m1", ctypes.c_void_p), ("c1", ctypes.c_void_p),
                ("m2", ctypes.c_void_p), ("c2", ctypes.c_void_p),
                ("r", ctypes.c_void_p), ("scal", ctypes.c_void_p),
                ("q1", ctypes.c_int), ("res", ctypes.c_int)]


def _scalar(v, device) -> Tensor:
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def device_args(rq: Requant, n: int, out_shape, device):
    """(RequantArgs, tensors to keep alive until the launch is queued) for
    a kernel writing ``out_shape`` (..., N) codes on ``device``: per-column
    terms as contiguous (N,) f32, the scalars stacked on the device (no
    wait for the card), the residual checked against the output."""
    keep = []

    def col(t):
        if t is None:
            return None
        t = torch.broadcast_to(t.to(device=device, dtype=torch.float32),
                               (n,)).contiguous()
        if t.data_ptr() % 16:                  # the kernels load float4s
            t = t.clone()
        keep.append(t)
        return t.data_ptr()

    zero = torch.zeros((), dtype=torch.float32, device=device)
    lo1, hi1, sub1 = rq.q1 if rq.q1 is not None else (zero,) * 3
    lo2, hi2, sub2 = rq.q2 if rq.q2 is not None else (zero,) * 3
    mr = rq.mr if rq.mr is not None else zero
    scal = torch.stack([_scalar(s, device) for s in
                        (lo1, hi1, sub1, lo2, hi2, sub2, mr)])
    keep.append(scal)
    res, r_ptr = 0, None
    if rq.q2 is not None:
        res = 1
        if rq.r is not None:
            r = rq.r.contiguous()
            if r.device != torch.device(device) \
                    or r.dtype not in (torch.int8, torch.float32) \
                    or r.numel() != int(torch.Size(out_shape).numel()):
                raise ValueError(
                    f"residual: want int8 or f32 of "
                    f"{tuple(out_shape)} on {device}, got {r.dtype} "
                    f"{tuple(r.shape)} on {r.device}")
            if r.data_ptr() % 16:
                r = r.clone()
            res = 2 if r.dtype == torch.int8 else 3
            r_ptr = r.data_ptr()
            keep.append(r)
    args = RequantArgs(col(rq.m1), col(rq.c1), col(rq.m2), col(rq.c2), r_ptr,
                       scal.data_ptr(), int(rq.q1 is not None), res)
    return args, keep
