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
products summed in float64; every sum here is below 2^53). CUDA tensors
launch the kernel with ``group_conv_launch_plan``'s tiling, or raise
ValueError before any launch on a shape the plan cannot fit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import _build
from .int_matmul import _out_hw, conv_launch_outputs, im2col, plain_epilogue

WARPS = 8                  # warps of a block, 16 output pixels each a pass
MAX_SMEM = 232448          # dynamic shared memory one block may use (H100)
SM_SMEM = 233472           # shared memory of one SM
MAX_TILE_PIXELS = 256      # output pixels of a tile: two passes of 8 warps
MAX_NTW = 4                # 8-column MMA tiles of a warp's chunk (S <= 4:
                           # at most 64 accumulator registers)
ACC_TILES = 16             # a warp takes two 16-row fragments at once where
                           # their 2 * S * ntw MMA tiles stay within this
H100_SMS = 132


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


# ---- the launch plan ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """The kernel's tiling of one grouped conv.

    A block owns ``gb`` consecutive conv groups (a set) and, when the
    group's weights are too wide for shared memory, one of ``ctiles``
    column tiles of ``ncols`` output channels of its group. It stages
    those weights once, then walks the pixel tiles ``blockIdx.x,
    blockIdx.x + grid_x, ...``: ``ni`` whole images, or ``th`` output rows
    of one image, at the full output width. A tile's input halo, ``ni *
    hr`` rows of ``hwc`` cells, each ``cpix`` bytes holding the set's
    ``gb * Cg`` channels (a group's ``cgp`` channels, Cg rounded up to 4),
    comes into shared memory by ``cw``-byte copies while the block runs
    the previous tile's MMAs.

    The fields up to ``sw`` are the plan's decisions (``DECISIONS``), the
    only ones the kernel takes (``struct Plan`` of
    ``csrc/int8_group_conv.cu``, in the same order); the rest follow from
    them and the shape, and the kernel derives them itself (``tiling``,
    ``layout``)."""
    gb: int          # conv groups per block
    ctiles: int      # column tiles per group (gb == 1 where > 1)
    ncols: int       # output channels of a group per block
    ntw: int         # 8-column MMA tiles per warp chunk
    nch: int         # chunks per group: ncols <= nch * ntw * 8
    cw: int          # bytes per halo copy: 16, 8, 4 (cp.async) or 1
    cww: int         # bytes per weight copy: 16, 8, 4 (cp.async) or 1
    cgp: int         # a group's channels in a halo cell
    cpix: int        # halo cell stride, bytes
    ni: int          # images per tile
    th: int          # output rows per tile
    grid_x: int      # blocks per (set, column tile)
    ovec: int        # output elements per store: 16, 8, 4 or 1
    sw: int          # staging row stride of a warp's chunk, floats
    mt: int          # 16-row fragments a warp takes at once (2 where
                     # 2 * S * ntw <= ACC_TILES)
    hr: int          # halo rows per image: (th - 1) * SH + KH
    hwc: int         # halo cells per row: (Wo - 1) * SW + KW
    kp: int          # K in shared memory, KH*KW*cgp rounded up to 32
    tiles: int       # pixel tiles
    grid_y: int      # sets * column tiles
    smem: int        # dynamic shared memory, bytes (smem_bytes)

    @functools.cached_property
    def c_args(self):
        """The plan's decisions as the C entry takes them: an int array,
        built once."""
        vals = [getattr(self, f) for f in DECISIONS]
        return (ctypes.c_int * len(vals))(*vals)


DECISIONS = ("gb", "ctiles", "ncols", "ntw", "nch", "cw", "cww", "cgp",
             "cpix", "ni", "th", "grid_x", "ovec", "sw")


def _pow2_align(v: int) -> int:
    """The largest of 16, 8, 4, 2, 1 that divides ``v``."""
    return next(a for a in (16, 8, 4, 2, 1) if v % a == 0)


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def weight_stride(kp: int) -> int:
    """A staged weight row's bytes: K' padded to 32 mod 64, so the 8-byte
    B fragment reads of 4 rows fall in distinct banks."""
    return kp if kp % 64 == 32 else kp + 32


def smem_bytes(s_n, gb, ncols, ntw, nch, mt, kp, halo, sw, mf):
    """Dynamic shared memory of a launch, the total of the kernel's
    ``layout``, which carves it: two halo buffers, the weights, the warps'
    staged values, the requant and scale-table columns, the tap offsets
    and the pixel offsets (of ``mf`` fragments rounded up to even). The
    plan fits its tiles by it; the kernel launches with its own total and
    refuses one above MAX_SMEM."""
    wbp = -(-gb * ncols // 4) * 4
    return (2 * _r16(halo)
            + _r16(s_n * gb * nch * ntw * 8 * weight_stride(kp))
            + _r16(WARPS * 16 * mt * sw * 4) + _r16(16 * wbp)
            + 2 * _r16(4 * s_n * wbp) + _r16(kp) + _r16(64 * (mf + mf % 2)))


def bank_conflicts(cpix: int, stride: int) -> int:
    """Most 4-byte words one shared-memory bank serves in one phase of a
    fragment read: 4 pixels ``stride`` cells apart, 32 bytes each (a
    half-warp's 8-byte reads)."""
    banks = [0] * 32
    for p in range(4):
        for j in range(8):
            banks[(p * stride * cpix // 4 + j) % 32] += 1
    return max(banks)


def _cpix(run: int, cw: int, stride: int) -> int:
    """Halo cell stride: at least ``run`` bytes, a multiple of the copy and
    of a word, with the fewest bank conflicts (then the smallest)."""
    step = max(4, cw)
    start = -(-run // step) * step
    return min(range(start, start + 64 + 1, step),
               key=lambda v: (bank_conflicts(v, stride), v))


def _rows_loaded(h, ho, th, sh, kh, ph):
    """Input rows of one image the halos of its row bands read."""
    hr = (th - 1) * sh + kh
    total = 0
    for h0 in range(0, ho, th):
        lo = h0 * sh - ph
        total += max(0, min(h, lo + hr) - max(0, lo))
    return total


def _tile_shapes(b, ho, wo):
    """(ni, th) of each tile shape: whole images, or row bands of one
    image, of at most MAX_TILE_PIXELS pixels (one output row where a row
    is wider)."""
    shapes = [(ni, ho) for ni in range(1, b + 1)
              if ni * ho * wo <= MAX_TILE_PIXELS]
    shapes += [(1, th) for th in range(1, ho)
               if th * wo <= MAX_TILE_PIXELS]
    return shapes or [(1, 1)]


def _grid(tiles, units, smem, sms):
    """(blocks per (set, column tile), blocks one SM holds): enough blocks
    to fill every SM, each walking the same number of tiles."""
    per_sm = max(1, min(2, SM_SMEM // (smem + 1024)))
    gx = min(tiles, max(1, -(-sms * per_sm // units)))
    return -(-tiles // -(-tiles // gx)), per_sm


def _estimate(tiles, gx, units, per_sm, mf, amp, sms):
    """Relative time of a tiling: the 16-row fragments (plus 4 for a
    tile's barrier and halo) of the busiest SM's blocks, at 60% of the
    SM's rate when it holds one block (its warps wait at the tile's
    barrier), times half the extra halo rows read."""
    busiest = -(-gx * units // sms)
    rate = 1.0 if min(per_sm, busiest) > 1 else 0.6
    return busiest * -(-tiles // gx) * (mf + 4) / rate \
        * (1 + 0.5 * max(0.0, amp - 1.0))


def _groups_per_block(g: int, cg: int) -> int:
    """A divisor of G, at most 4, whose channel run is best aligned for
    16-byte copies, the smallest such."""
    if cg % 4:
        return 1
    return min((d for d in range(1, min(4, g) + 1) if g % d == 0),
               key=lambda d: (-min(16, _pow2_align(d * cg)), d))


@functools.lru_cache(maxsize=4096)
def group_conv_launch_plan(b, h, w, c, n, g, kernel, stride, padding, s_n,
                           sms=H100_SMS, x_align=16,
                           w_align=16) -> LaunchPlan:
    """The kernel's tiling of a grouped conv of (B, H, W, C) int8 codes to
    N channels in G conv groups with S weight groups, or ValueError where
    no tiling fits shared memory. ``x_align`` / ``w_align``: the largest
    power of two (<= 16) dividing the codes' and the weights' addresses;
    ``sms``: the card's multiprocessors."""
    (kh, kw), (sh, sw_), (ph, pw) = kernel, stride, padding
    ho, wo = _out_hw(h, w, kernel, stride, padding)
    if ho <= 0 or wo <= 0 or g < 1 or c % g or n % g or not 1 <= s_n <= 4:
        raise ValueError(f"grouped conv {b}x{h}x{w}x{c}->{n} G{g} S{s_n}: "
                         "no kernel launch for this shape")
    cg, ocg, taps = c // g, n // g, kh * kw
    cgp = -(-cg // 4) * 4
    kp = -(-taps * cgp // 32) * 32
    hwc = (wo - 1) * sw_ + kw
    if cgp == cg and w_align >= 4:
        cww = min(16, _pow2_align(taps * cg), w_align)
    else:
        cww = 1
    ntg = -(-ocg // 8)
    gb_first = _groups_per_block(g, cg)
    # the set's groups whole, then one group at a time, then its columns
    # in ever more tiles
    for gb, ctiles in [(gb_first, 1)] + [(1, ct) for ct in range(
            1, ntg + 1)]:
        ncols = ocg if ctiles == 1 else 8 * -(-ntg // ctiles)
        if -(-ocg // ncols) != ctiles:
            continue
        run = gb * cg
        cw = min(16, _pow2_align(run), x_align) if cg % 4 == 0 else 1
        if cw < 4:
            cw = 1
        cpix = _cpix(gb * cgp, cw, sw_)
        ntc = -(-ncols // 8)
        nch = -(-ntc // MAX_NTW)
        ntw = -(-ntc // nch)
        mt = 2 if 2 * s_n * ntw <= ACC_TILES else 1
        # a chunk's 8*ntw staged columns, rows padded to 8 or 24 mod 32
        # words: a half-warp's 8-byte writes fall in distinct banks
        sw = next(v for v in range(8 * ntw, 8 * ntw + 32, 8)
                  if v % 32 in (8, 24))
        grid_y = g // gb * ctiles
        best = None
        for ni, th in _tile_shapes(b, ho, wo):
            hr = (th - 1) * sh + kh
            mf = -(-ni * th * wo // 16)
            smem = smem_bytes(s_n, gb, ncols, ntw, nch, mt, kp,
                              ni * hr * hwc * cpix, sw, mf)
            if smem > MAX_SMEM:
                continue
            tiles = -(-b // ni) * -(-ho // th)
            gx, per_sm = _grid(tiles, grid_y, smem, sms)
            amp = _rows_loaded(h, ho, th, sh, kh, ph) / h
            est = _estimate(tiles, gx, grid_y, per_sm, mf, amp, sms)
            if best is None or est < best[0]:
                best = (est, ni, th, hr, tiles, gx, smem)
        if best is None:
            continue
        if grid_y > 65535:
            raise ValueError(f"{grid_y} block rows exceed the grid")
        _, ni, th, hr, tiles, gx, smem = best
        # pieces of a chunk's columns: they start at multiples of OCg,
        # ncols and 8*ntw
        span = math.gcd(n, ocg, ncols, 8 * ntw if nch > 1 else ocg)
        ovec = next(v for v in (16, 8, 4, 1) if span % v == 0)
        return LaunchPlan(gb, ctiles, ncols, ntw, nch, cw, cww, cgp, cpix,
                          ni, th, gx, ovec, sw, mt, hr, hwc, kp, tiles,
                          grid_y, smem)
    raise ValueError(f"grouped conv {b}x{h}x{w}x{c}->{n} G{g} k{kh}x{kw}: "
                     "no tile fits the kernel's shared memory")


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---- the wrapper -------------------------------------------------------


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
    plan = group_conv_launch_plan(
        b, h, w, c, n, g, (kh, kw), (sh, sw), (ph, pw), s_n,
        _sms(codes.device), _pow2_align(codes.data_ptr()),
        _pow2_align(w_mat.data_ptr())).c_args
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load()
    err = lib.ssq_int8_group_conv(
        codes.data_ptr(), w_mat.data_ptr(), ptr(table), ptr(acc_offset),
        ptr(delta), out.data_ptr(), s_n, b, h, w, c, kh, kw, sh, sw, ph, pw,
        n, g, int(pad_value), ctypes.addressof(plan),
        None if rq is None else ctypes.addressof(rq),
        _build.stream_ptr(codes))
    _build.check(lib, "ssq_int8_group_conv", err)
    int8_group_conv.launches += 1
    return out


int8_group_conv.launches = 0
