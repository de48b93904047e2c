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

The kernel walks the expanded channels in chunks of ``NC``; what it reads
besides the codes depends only on the weights, so ``prepare_mbconv`` lays
it out once (``MbconvConsts``): one record per chunk holding the expand
weights and the project weights in mma fragment order, the depthwise tap
words and the two epilogue rows. ``mbconv_plain_prepared`` unpacks the
records and computes chunk by chunk in the kernel's order and arithmetic
(the clamp before the floor, integer sums converted exactly);
``mbconv_fused_plain`` is the straightforward version the kernel is held
to.
"""
from __future__ import annotations

import dataclasses

import torch

from . import _build
from .depthwise import pack_taps, unpack_taps

NC = 32                  # expanded channels per chunk
WARPS = 8                # warps per block (256 threads)
P_MAX = 896              # output pixels of a band, at most
MAX_SMEM = 232448        # shared memory a block can use
RING = 4                 # chunk records in shared memory
# project unit classes, (units per warp, n-tiles per unit): the kernel's
# register accumulators are UPW x NTG fragments of 16 x 8 (at most 96 of
# the 128 registers that let two blocks share an SM)
CLASSES = ((4, 3), (4, 4), (1, 12), (2, 12), (1, 20), (8, 2))


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


# ---- the chunk records ------------------------------------------------


def expand_column_channel():
    """(NC,) the chunk channel of each expand mma column p: thread t of an
    m16n8 fragment holds columns nt*8 + 2t + e of n-tile nt, which are
    channels 8t + 2nt + e, 8 consecutive channels of one pixel."""
    p = torch.arange(NC)
    return 8 * ((p >> 1) & 3) + 2 * (p >> 3) + (p & 1)


def _frag_k(lanes, byte):
    """The k of byte ``byte`` of lane ``lanes``' m16n8k32 B fragment:
    register byte // 4 holds k = 16 (byte // 4) + 4 (lane % 4) + byte % 4."""
    return (byte // 4) * 16 + 4 * (lanes & 3) + byte % 4


def _we_index(ks_n):
    """(k, column) index tensors (KS, 4, 32, 8) of the expand B fragments:
    k-step, n-tile, lane, byte."""
    ks, nt, lane, byte = torch.meshgrid(
        torch.arange(ks_n), torch.arange(4), torch.arange(32),
        torch.arange(8), indexing="ij")
    k = 32 * ks + _frag_k(lane, byte)
    col = expand_column_channel()[8 * nt + (lane >> 2)]
    return k, col


def _wp_index(nt_n):
    """(k, output channel) index tensors (NT, 32, 8) of the project B
    fragments: n-tile, lane, byte."""
    nt, lane, byte = torch.meshgrid(torch.arange(nt_n), torch.arange(32),
                                    torch.arange(8), indexing="ij")
    return _frag_k(lane, byte), 8 * nt + (lane >> 2)


def record_layout(ci, co, has_expand):
    """{part: (offset, bytes)} of a chunk record and its size: expand
    weights (KS, 4, 32, 8) and rows (2, NC) f32 (with an expand), tap words
    (NC, 3) int32, dw rows (2, NC) f32, project weights (NT, 32, 8)."""
    ks = -(-ci // 32) if has_expand else 0
    nt = -(-co // 8)
    sizes = (("we", ks * 1024), ("ae", 8 * NC if has_expand else 0),
             ("wd", 12 * NC), ("ad", 8 * NC), ("wp", nt * 256))
    out, off = {}, 0
    for name, n in sizes:
        out[name] = (off, n)
        off += n
    return out, off


@dataclasses.dataclass(frozen=True)
class MbconvConsts:
    """A block's launch constants, on one device.

    chunks: (NCH, CB) uint8, one record per chunk of NC expanded channels
    (``record_layout``); the channels past CE are zero weights and zero
    rows, whose codes are 0 at every stage. ap: (2, CO) f32 [A_p; B_p].
    qp: (6,) f32 [hi_e, hi_d, res_scale, lo_o, hi_o, -]."""
    chunks: torch.Tensor
    ap: torch.Tensor
    qp: torch.Tensor
    ci: int
    ce: int
    co: int
    has_expand: bool
    has_residual: bool

    @property
    def device(self):
        return self.chunks.device


def _bytes(t, nch):
    """(NCH, ...) tensor -> (NCH, bytes) uint8, little-endian."""
    return t.contiguous().view(torch.uint8).reshape(nch, -1)


def prepare_mbconv(we, ae, wd, ad, wp, ap, qp, has_expand: bool = True,
                   has_residual: bool = True) -> MbconvConsts:
    """A block's launch constants on ``wd``'s device. ``we`` (CI, CE),
    ``wd`` (9, CE) tap-major and ``wp`` (CE, CO) hold integer codes in
    int8 range, in any dtype; ``we`` is not read without an expand (CI ==
    CE). ae, ad: (2, CE), ap: (2, CO) epilogue rows; qp: 6 scalars, its
    clip bounds integers (the kernel clamps before it floors, which equals
    floor-then-clip only then) and hi_e, hi_d <= 255."""
    hi_e, hi_d, _, lo_o, hi_o = qp.reshape(-1)[:5].tolist()
    if any(v != int(v) for v in (hi_e, hi_d, lo_o, hi_o)):
        raise ValueError(f"qp's clip bounds must be integers, got hi_e "
                         f"{hi_e}, hi_d {hi_d}, lo_o {lo_o}, hi_o {hi_o}")
    if max(hi_e, hi_d) > 255:
        raise ValueError(f"hi_e and hi_d must be <= 255, got {hi_e}, {hi_d}")
    dev = wd.device
    ce, co = wd.shape[1], wp.shape[1]
    ci = we.shape[0] if has_expand else ce
    if has_residual and co != ci:
        raise ValueError(f"a residual needs CO == CI, got {co}, {ci}")
    nch = -(-ce // NC)
    cep = nch * NC
    nt = -(-co // 8)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    parts = []

    def rows(t):
        r = torch.zeros((2, cep), **f32)
        r[:, :ce] = t.to(**f32).reshape(2, ce)
        return _bytes(r.reshape(2, nch, NC).permute(1, 0, 2), nch)

    if has_expand:
        ks = -(-ci // 32)
        w = torch.zeros((ks * 32, nch, NC), **i32)
        w.reshape(ks * 32, cep)[:ci, :ce] = we.to(**i32).reshape(ci, ce)
        k, col = _we_index(ks)
        frag = w[k.to(dev), :, col.to(dev)]           # (KS, 4, 32, 8, NCH)
        parts += [_bytes(frag.permute(4, 0, 1, 2, 3).to(torch.int8), nch),
                  rows(ae)]
    taps = torch.zeros((cep, 3), **i32)
    taps[:ce] = pack_taps(wd.to(**i32).reshape(9, ce).T.reshape(ce, 3, 3))
    parts += [_bytes(taps.reshape(nch, NC * 3), nch), rows(ad)]
    w = torch.zeros((nch, NC, nt * 8), **i32)
    w.reshape(cep, nt * 8)[:ce, :co] = wp.to(**i32).reshape(ce, co)
    k, o = _wp_index(nt)
    parts.append(_bytes(w[:, k.to(dev), o.to(dev)].to(torch.int8), nch))
    chunks = torch.cat(parts, 1).contiguous()
    assert chunks.shape[1] == record_layout(ci, co, has_expand)[1]
    return MbconvConsts(
        chunks=chunks, ap=ap.to(**f32).reshape(2, co).contiguous(),
        qp=qp.to(**f32).reshape(-1).contiguous(), ci=ci, ce=ce, co=co,
        has_expand=has_expand, has_residual=has_residual)


def _part(k: MbconvConsts, name, dtype):
    off, n = record_layout(k.ci, k.co, k.has_expand)[0][name]
    return k.chunks[:, off:off + n].contiguous().view(dtype)


def unpack_mbconv(k: MbconvConsts):
    """Inverse of ``prepare_mbconv``'s records: (we (CI, CE) or None, wd
    (9, CE), wp (CE, CO)) int32 codes and (ae, ad) (2, CE) f32 rows."""
    nch = k.chunks.shape[0]
    cep = nch * NC
    dev = k.device

    def rows(name):
        r = _part(k, name, torch.float32).reshape(nch, 2, NC)
        return r.permute(1, 0, 2).reshape(2, cep)[:, :k.ce]

    we = ae = None
    if k.has_expand:
        ks = -(-k.ci // 32)
        frag = _part(k, "we", torch.int8).reshape(nch, ks, 4, 32, 8)
        w = torch.zeros((ks * 32, nch, NC), dtype=torch.int32, device=dev)
        kk, col = _we_index(ks)
        w[kk.to(dev), :, col.to(dev)] = \
            frag.permute(1, 2, 3, 4, 0).to(torch.int32)
        we = w.reshape(ks * 32, cep)[:k.ci, :k.ce]
        ae = rows("ae")
    taps = _part(k, "wd", torch.int32).reshape(cep, 3)[:k.ce]
    wd = unpack_taps(taps).reshape(k.ce, 9).T
    nt = -(-k.co // 8)
    frag = _part(k, "wp", torch.int8).reshape(nch, nt, 32, 8)
    w = torch.zeros((nch, NC, nt * 8), dtype=torch.int32, device=dev)
    kk, o = _wp_index(nt)
    w[:, kk.to(dev), o.to(dev)] = frag.to(torch.int32)
    wp = w.reshape(cep, nt * 8)[:k.ce, :k.co]
    return we, wd.contiguous(), wp, ae, rows("ad")


def floor_code(v, lo, hi):
    """The kernel's epilogue rounding: clamp to [lo, hi] first, then floor
    (an add of 1.5 * 2^23 rounded down, whose low byte is the code). Equal
    to clip(floor(v), lo, hi) for integer bounds."""
    return torch.floor(torch.clamp(v, lo, hi))


def mbconv_plain_prepared(x_codes, k: MbconvConsts):
    """The kernel's order on prepared constants, in PyTorch: chunk by
    chunk of NC expanded channels, the expand and dw codes of the chunk,
    then its share of the project sum (integer sums, exact in float64);
    the epilogues in f32, rounded after the multiply and after the add,
    the clamp before the floor."""
    b, h, w, ci = x_codes.shape
    dev = x_codes.device
    we, wd, wp, ae, ad = unpack_mbconv(k)
    hi_e, hi_d, r_s, lo_o, hi_o = k.qp[:5]
    x64 = x_codes.to(torch.float64).reshape(-1, ci)
    accp = torch.zeros((b * h * w, k.co), dtype=torch.float64, device=dev)
    for c0 in range(0, k.ce, NC):
        sl = slice(c0, min(c0 + NC, k.ce))
        if k.has_expand:
            acc = (x64 @ we[:, sl].to(torch.float64)).to(torch.float32)
            q1 = floor_code(acc * ae[0, sl] + ae[1, sl], 0.0, hi_e)
        else:
            q1 = x64[:, sl]
        q1p = torch.zeros((b, h + 2, w + 2, q1.shape[1]),
                          dtype=torch.float64, device=dev)
        q1p[:, 1:h + 1, 1:w + 1] = q1.reshape(b, h, w, -1)
        acc = torch.zeros((b, h, w, q1.shape[1]), dtype=torch.float64,
                          device=dev)
        for tap in range(9):
            di, dj = divmod(tap, 3)
            acc += q1p[:, di:di + h, dj:dj + w] * wd[tap, sl]
        q2 = floor_code(acc.to(torch.float32) * ad[0, sl] + ad[1, sl],
                        0.0, hi_d)
        accp += q2.reshape(-1, q2.shape[-1]).to(torch.float64) \
            @ wp[sl].to(torch.float64)
    y = accp.to(torch.float32) * k.ap[0] + k.ap[1]
    if k.has_residual:
        y = y + x64.to(torch.float32) * r_s
    return floor_code(y, lo_o, hi_o).reshape(b, h, w, k.co).to(torch.int8)


# ---- the launch plan --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """R output rows per band, the project unit class (``CLASSES``), G
    groups of n-tiles, and the block's shared memory in bytes."""
    rows: int
    cls: int
    groups: int
    smem: int


def _align16(n):
    return (n + 15) // 16 * 16


def smem_bytes(r, h, w, ci, ce, co, has_expand):
    """The kernel's shared memory for bands of ``r`` rows (its ``Layout``):
    the staged input rows (or, without an expand, every chunk of the input
    with its zero border), two q1 chunks, two q2 chunks, ``RING`` chunk
    records; the output tile reuses all but the first."""
    cb = record_layout(ci, co, has_expand)[1]
    q1_chunk = (r + 2) * (w + 2) * NC
    cis = -(-ci // 32) * 32 + 16
    region_a = _align16(min(r + 2, h) * w * cis) if has_expand \
        else -(-ce // NC) * q1_chunk
    q2 = -(-(r * w) // 16) * 16 * NC
    end_w = region_a + (2 * q1_chunk if has_expand else 0) + 2 * q2 \
        + RING * cb
    return max(end_w, region_a + _align16(r * w * co))


def _unit_class(mt, nt):
    """(more than 16 accumulator fragments, MMAs and A-fragment loads per
    warp per chunk, fragments, class, G) of the cheapest project split of
    mt m-tiles x nt n-tiles over the warps, or None: a class of at most 16
    fragments (64 registers, no spill) where one fits."""
    best = None
    for cls, (upw, ntg) in enumerate(CLASSES):
        for g in range(1, nt + 1):
            per = -(-nt // g)
            if per > ntg:
                continue
            units = -(-(mt * g) // WARPS)
            if units > upw:
                break
            cand = (upw * ntg > 16, units * (per + 1), upw * ntg, cls, g)
            best = cand if best is None else min(best, cand)
    return best


def launch_plan(h, w, ci, ce, co, has_expand) -> LaunchPlan:
    """The kernel's bands and project split for a block shape, or
    ValueError if the kernel cannot take it: the fewest bands of at most
    ``P_MAX`` pixels that the register accumulators and shared memory
    allow (each band streams every weight record once)."""
    if ci % 4 or co % 4:
        raise ValueError(f"mbconv kernel takes CI and CO multiples of 4, "
                         f"got {ci}, {co}")
    if has_expand and ci > 256:
        raise ValueError(f"mbconv kernel takes CI up to 256, got {ci}")
    if not has_expand and ce != ci:
        raise ValueError(f"without expand CE must equal CI, got {ce}, {ci}")
    nt = -(-co // 8)
    for n_bands in range(max(1, -(-(h * w) // P_MAX)), h + 1):
        r = -(-h // n_bands)
        if -(-h // r) != n_bands or (r + 2) * w * w >= 1 << 21:
            continue
        split = _unit_class(-(-(r * w) // 16), nt)
        smem = smem_bytes(r, h, w, ci, ce, co, has_expand)
        if split is not None and smem <= MAX_SMEM:
            return LaunchPlan(rows=r, cls=split[3], groups=split[4],
                              smem=smem)
    raise ValueError(f"mbconv kernel cannot take H={h} W={w} CI={ci} "
                     f"CE={ce} CO={co}: no band fits its registers and "
                     "shared memory")


# ---- the wrappers -----------------------------------------------------


def mbconv_fused_prepared(x_codes, k: MbconvConsts):
    """``mbconv_fused`` on constants from ``prepare_mbconv``: CPU tensors
    take ``mbconv_plain_prepared``; CUDA tensors launch the kernel, or
    raise ValueError before any launch on a shape it cannot take."""
    b, h, w, ci = x_codes.shape
    if ci != k.ci:
        raise ValueError(f"x_codes has {ci} channels, the block {k.ci}")
    if not x_codes.is_cuda:
        return mbconv_plain_prepared(x_codes, k)
    plan = launch_plan(h, w, k.ci, k.ce, k.co, k.has_expand)
    if x_codes.dtype != torch.int8 or not x_codes.is_contiguous():
        raise ValueError(f"x_codes: want contiguous int8, got "
                         f"{x_codes.dtype}")
    nch, cb = -(-k.ce // NC), record_layout(k.ci, k.co, k.has_expand)[1]
    for name, t, dtype, shape in (
            ("chunks", k.chunks, torch.uint8, (nch, cb)),
            ("ap", k.ap, torch.float32, (2, k.co)),
            ("qp", k.qp, torch.float32, tuple(k.qp.shape))):
        if t.device != x_codes.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on "
                f"{x_codes.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if k.qp.numel() < 5:
        raise ValueError(f"qp holds {k.qp.numel()} scalars, want 6")
    for name, t, align in (("x_codes", x_codes, 16), ("chunks", k.chunks, 16),
                           ("ap", k.ap, 8)):
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    out = torch.empty((b, h, w, k.co), dtype=torch.int8,
                      device=x_codes.device)
    lib = _build.load()
    err = lib.ssq_mbconv_fused(
        x_codes.data_ptr(), k.chunks.data_ptr(), k.ap.data_ptr(),
        k.qp.data_ptr(), out.data_ptr(), b, h, w, k.ci, k.ce, k.co,
        int(k.has_expand), int(k.has_residual), plan.rows, plan.cls,
        plan.groups, _build.stream_ptr(x_codes))
    _build.check(lib, "ssq_mbconv_fused", err)
    mbconv_fused.launches += 1
    return out


def mbconv_fused(x_codes, we, ae, wd, ad, wp, ap, qp,
                 has_expand: bool = True, has_residual: bool = True):
    """Fused stride-1 inverted-residual block on centered int8 codes.

    x_codes: (B, H, W, CI) int8. we: (CI, CE) expand codes (with
    has_expand=False, CE == CI and ``we`` is not read). wd: (9, CE) dw
    codes, tap-major. wp: (CE, CO) project codes. ae, ad, ap: (2, C) f32
    epilogue rows [A; B] (B carries the +0.5 that makes floor a round).
    qp: 6 f32 scalars [hi_e, hi_d, res_scale, lo_o, hi_o, unused], with
    hi_e, hi_d <= 255 and integer clip bounds. Returns (B, H, W, CO) int8
    codes on the block's grid. CPU tensors take the plain version; CUDA
    tensors launch the kernel (CI and CO multiples of 4). A caller that
    runs the same block again builds its constants once with
    ``prepare_mbconv`` and calls ``mbconv_fused_prepared``.
    """
    ci, ce = x_codes.shape[3], wd.shape[1]
    if not has_expand and ce != ci:
        raise ValueError(f"without expand CE must equal CI, got {ce}, {ci}")
    if has_expand and tuple(we.shape) != (ci, ce):
        raise ValueError(f"we: want ({ci}, {ce}), got {tuple(we.shape)}")
    return mbconv_fused_prepared(
        x_codes, prepare_mbconv(we, ae, wd, ad, wp, ap, qp, has_expand,
                                has_residual))


mbconv_fused.launches = 0
