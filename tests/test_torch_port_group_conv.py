"""The grouped int8 implicit-GEMM convolution of the PyTorch port
(``ops/cuda/group_conv.py``), run on the CPU through its plain version.

- ``int8_group_conv`` (plain) against XLA's grouped integer convolution
  (``feature_group_count``, the JAX deploy path's ``_int_conv``) with
  int32 operands, so biased feeds fit: int32 sums bit for bit
  (``torch.equal``), and the scale-table sum bit for bit against the JAX
  deploy expression ``0 + sum_s f32(acc_s) * (table[s] * delta)``, op by
  op;
- against ``int8_conv`` (plain) on the dense block-diagonal operand
  deploy builds for ``int8_bd``: the same integers, so every mode equal;
- its requant modes against its sums mode followed by deploy's
  ``quantize_out``, bit for bit, in every requant epilogue.

Shapes cover what the kernel finds hardest: group widths Cg of 24
(RegNetX-600M), 8 (regnetx_200m) and odd; output groups OC/G not a
multiple of 8; stride 2 with padding 1; a 1x1 grouped conv; S = 1, 2, 3
weight groups; pad values of a biased (offset) feed. The card-only tests
(``tests/test_torch_port_cuda.py``) hold the kernel to the plain version
at these shapes.
"""
import dataclasses
from types import SimpleNamespace as NS

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch.ops.cuda import group_conv as TG
from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul as TI
from shiftedscalequantization_tpu_torch.ops.cuda import requant as TR

# (b, h, w, c, n, conv groups, kernel, stride, padding, S, offset)
SHAPES = [
    (2, 8, 8, 48, 48, 2, 3, 2, 1, 1, 0),       # Cg = 24, stride 2
    (2, 7, 7, 24, 24, 3, 3, 1, 1, 2, 128),     # Cg = 8, biased feed
    (1, 9, 7, 15, 15, 3, 3, 2, 1, 3, 0),       # odd Cg = OC/G = 5
    (2, 6, 6, 16, 24, 2, 3, 1, 1, 1, 9),       # OC/G = 12, offset 9
    (2, 5, 5, 12, 8, 4, 1, 1, 0, 2, 0),        # 1x1 grouped, OC/G = 2
    (1, 6, 6, 96, 96, 4, 3, 2, 1, 3, 128),     # Cg = 24, S = 3, biased
]
SHAPE_IDS = ["cg24-s2", "cg8-biased", "cg5-odd", "ocg12", "1x1",
             "cg24-S3-biased"]
SITES = {"u4": (0.37, 0.0, 4), "a4": (0.29, 7.0, 4), "b8": (0.021, 0.0, 8),
         "blk": (0.41, 0.0, 4), "blka": (0.33, 8.0, 4)}
# (id, unit site, unit act, block site, block act, residual kind)
VARIANTS = [
    ("site-relu", "u4", "relu", None, None, None),
    ("site-relu6", "u4", "relu6", None, None, None),
    ("site-none", "a4", None, None, None, None),
    ("biased-relu", "b8", "relu", None, None, None),
    ("block-codes-res", None, None, "blk", "relu", "codes"),
    ("block-f32-res", None, None, "blk", "relu", "f32"),
    ("block-biased-res", None, None, "blka", None, "biased"),
    ("block-no-res", None, None, "blka", None, None),
    ("unit-site-then-block", "a4", None, "blk", "relu6", "codes"),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _case(shape, seed=0):
    """Codes, grouped OIHW weights per weight group, the port's operand,
    and the offset's acc_offset, for one SHAPES entry."""
    b, h, w, c, n, g, k, st, p, s_n, offset = shape
    rng = np.random.default_rng(seed + c * 7 + n)
    span = 128 if offset else 8
    xi = rng.integers(-span, span, size=(b, h, w, c)).astype(np.int8)
    # symmetric weights: a biased feed's centered codes stay >= 0
    ws = rng.integers(-2, 3, size=(s_n, n, c // g, k, k)).astype(np.int8)
    wm = torch.as_tensor(np.ascontiguousarray(
        np.transpose(ws, (0, 1, 3, 4, 2)).reshape(s_n, n, -1)))
    acc_off = offset * wm.sum(dim=2, dtype=torch.int32) if offset else None
    geom = ((k, k), (st, st), (p, p))
    return rng, xi, ws, wm, acc_off, geom


def _jax_group_conv(xc, w_oihw, stride, padding, groups):
    """XLA's grouped integer conv of centered codes, zero padding (JAX
    deploy._int_conv with int32 operands)."""
    pad = ((padding[0], padding[0]), (padding[1], padding[1]))
    return jax.lax.conv_general_dilated(
        jnp.asarray(xc, jnp.int32),
        jnp.transpose(jnp.asarray(w_oihw, jnp.int32), (2, 3, 1, 0)),
        window_strides=stride, padding=pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_group_conv_matches_jax_grouped_conv(shape):
    """int32 sums of each weight group bit for bit against XLA's grouped
    conv of the centered codes ``xi + offset`` (padding -offset, offset *
    sum(w) added back); the scale-table sum bit for bit against the JAX
    deploy expression."""
    _, _, _, _, n, g, _, _, _, s_n, offset = shape
    rng, xi, ws, wm, acc_off, geom = _case(shape)
    xc = xi.astype(np.int32) + offset
    accs = [np.array(_jax_group_conv(xc, ws[s], geom[1], geom[2], g))
            for s in range(s_n)]
    before = TG.int8_group_conv.launches
    for s in range(s_n):
        got = TG.int8_group_conv(
            torch.as_tensor(xi), wm[s:s + 1].contiguous(), *geom, g,
            pad_value=-offset,
            acc_offset=None if acc_off is None else acc_off[s:s + 1])
        assert got.dtype == torch.int32
        assert torch.equal(got, torch.as_tensor(accs[s]))
    table = (rng.random((s_n, n)) * 0.02 + 1e-3).astype(np.float32)
    delta = np.float32(0.37)
    want = jnp.float32(0.0)
    for s in range(s_n):
        want = want + jnp.asarray(accs[s]).astype(jnp.float32) \
            * (jnp.asarray(table[s]) * delta)
    got = TG.int8_group_conv(torch.as_tensor(xi), wm, *geom, g,
                             pad_value=-offset,
                             group_scales=torch.as_tensor(table),
                             act_delta=torch.tensor(delta),
                             acc_offset=acc_off)
    assert TG.int8_group_conv.launches == before     # the CPU runs plain
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.as_tensor(np.array(want)))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_group_conv_equals_dense_block_diagonal(shape):
    """The grouped conv equals int8_conv on the dense block-diagonal
    operand deploy builds for int8_bd (zeros add nothing): sums, the
    scale-table sum and a requant, all torch.equal."""
    _, _, _, _, n, g, _, _, _, s_n, offset = shape
    rng, xi, ws, wm, acc_off, geom = _case(shape, seed=1)
    dense = TD._gemm_operand(torch.stack([
        TD._block_diagonal(torch.as_tensor(ws[s]), g) for s in range(s_n)]))
    assert torch.equal(dense.sum(dim=2, dtype=torch.int32),
                       wm.sum(dim=2, dtype=torch.int32))
    x = torch.as_tensor(xi)
    table = torch.as_tensor(rng.random((s_n, n)) * 0.02 + 1e-3,
                            dtype=torch.float32)
    rq = TR.Requant(m1=torch.full((n,), 0.37), c1=torch.tensor(0.5),
                    q1=(0.0, 15.0, 0.0))
    for kw in (dict(group_scales=table, act_delta=torch.tensor(0.37)),
               dict(group_scales=table, act_delta=torch.tensor(0.37),
                    requant=rq)):
        kw.update(pad_value=-offset, acc_offset=acc_off)
        assert torch.equal(TG.int8_group_conv(x, wm, *geom, g, **kw),
                           TI.int8_conv(x, dense, *geom, **kw))
    if s_n == 1:
        assert torch.equal(
            TG.int8_group_conv(x, wm, *geom, g, pad_value=-offset,
                               acc_offset=acc_off),
            TI.int8_conv(x, dense, *geom, pad_value=-offset,
                         acc_offset=acc_off))


def _ctx():
    steps = {k: (torch.tensor(d), torch.tensor(z), b)
             for k, (d, z, b) in SITES.items()}
    return TD._Ctx(steps, frozenset({"u4", "a4", "blk", "blka"}),
                   frozenset({"b8"}))


def _residuals(rng, shape):
    return {"codes": ("codes", torch.as_tensor(
                rng.integers(-7, 9, shape), dtype=torch.int8), "a4"),
            "biased": ("biased", torch.as_tensor(
                rng.integers(-128, 128, shape), dtype=torch.int8), "b8"),
            "f32": ("f32", torch.as_tensor(
                rng.normal(size=shape) * 1.5, dtype=torch.float32), None)}


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1], SHAPES[5]],
                         ids=["S1", "S2-biased", "S3-biased"])
def test_group_conv_requant_equals_sums_then_quantize_out(shape, variant):
    """The requant mode equals the sums mode followed by deploy's
    quantize_out elementwise route, and requant_plain on the sums, bit
    for bit, in every requant epilogue deploy builds."""
    _, _, _, c, n, g, k, _, _, s_n, offset = shape
    rng, xi, _, wm, acc_off, geom = _case(shape, seed=2)
    x = torch.as_tensor(xi)
    kk = k * k * c // g
    spread = (209.0 if offset else 6.6) * np.sqrt(kk)
    scale = torch.as_tensor(rng.uniform(0.75, 1.25, n) * 3 * 0.37 / spread,
                            dtype=torch.float32)
    bias = torch.as_tensor(rng.normal(size=n) * 0.6, dtype=torch.float32)
    delta = torch.tensor(0.37)
    table = None if s_n == 1 else torch.stack(
        [scale * (0.5 + 0.25 * s) for s in range(s_n)]) / delta
    kw = dict(pad_value=-offset, group_scales=table, act_delta=delta,
              acc_offset=acc_off)
    sums = TG.int8_group_conv(x, wm, *geom, g, **kw)
    pending = TD._Pending(sums.float(), scale, bias) if s_n == 1 \
        else TD._Pending(sums, None, bias)
    res = _residuals(rng, tuple(sums.shape))
    _, usite, uact, bsite, bact, rkind = variant
    ctx, seen = _ctx(), []

    def run(rq):
        seen.append(rq)
        return TG.int8_group_conv(x, wm, *geom, g, requant=rq, **kw)

    deferred = TD._Deferred(run, pending.scale, pending.bias)
    if bsite is None:
        fused = TD.quantize_out(ctx, deferred, usite, uact)
        unfused = TD.quantize_out(ctx, pending, usite, uact)
    else:
        unit = NS(name=usite or "no site", activation=uact)
        node = NS(name=bsite, post_activation=bact)
        r = res[rkind] if rkind else None
        fused = TD._block_requant(ctx, deferred, unit, node, r)
        t = TD.quantize_out(ctx, pending, unit.name, uact)
        unfused = TD.quantize_out(ctx, t, bsite, bact, residual=r)
    assert len(seen) == 1
    assert fused[0] == unfused[0] and fused[2] == unfused[2]
    assert fused[1].dtype == torch.int8
    assert torch.equal(fused[1], unfused[1])
    assert torch.equal(fused[1], TR.requant_plain(sums.float(), seen[0]))
    # a check that cannot fail would pass on saturated codes alone
    assert torch.unique(fused[1]).numel() >= 3


def test_block_diagonal_layout():
    """Each conv group's weights land on its diagonal block, zeros off
    it."""
    w = torch.arange(1, 6 * 2 * 1 * 1 + 1, dtype=torch.int8) \
        .reshape(6, 2, 1, 1)
    dense = TD._block_diagonal(w, 3)
    assert tuple(dense.shape) == (6, 6, 1, 1)
    for oc in range(6):
        g = oc // 2
        row = dense[oc, :, 0, 0]
        assert torch.equal(row[2 * g:2 * g + 2], w[oc, :, 0, 0])
        assert int(row.abs().sum()) == int(w[oc].abs().sum())



# ---- the kernel's launch plan (group_conv_launch_plan) -----------------

def _zoo_grouped_shapes():
    """(H, W, C, N, G, kernel, stride, padding) of every grouped unit of
    the eight RegNetX X configs at 224x224, from the zoo."""
    from shiftedscalequantization_tpu_torch.graph import iter_units
    from shiftedscalequantization_tpu_torch.models import regnet, zoo
    shapes = set()
    for arch in regnet.CONFIGS:
        graph = zoo.build(arch)[0]
        hw = TD._unit_in_hw(graph, (224, 224))
        shapes |= {(*hw[u.name], u.in_ch, u.out_ch, u.groups, u.kernel[0],
                    u.stride[0], u.padding[0])
                   for u in iter_units(graph) if u.groups > 1}
    return sorted(shapes)


ZOO_GROUPED = _zoo_grouped_shapes()
# shapes outside the zoo the kernel takes: odd Cg = OC/G = 5; Cg = 12 with
# OC/G = 18; Cg = 16 with OC/G = 24; OC/G = 12; a 1x1 grouped conv with
# OC/G = 40; 15x15 at stride 2; OC/G = 5 at stride 1; a dense conv wide
# enough to need column tiles
ODD_GROUPED = [(15, 15, 15, 15, 3, 3, 2, 1), (28, 28, 48, 72, 4, 3, 1, 1),
               (7, 7, 32, 48, 2, 3, 1, 1), (6, 6, 16, 24, 2, 3, 1, 1),
               (6, 6, 96, 80, 2, 1, 1, 0), (15, 15, 96, 96, 4, 3, 2, 1),
               (9, 9, 15, 15, 3, 3, 1, 1), (7, 7, 256, 512, 1, 3, 1, 1)]


def _plan(shape, b, s_n, x_align=16, w_align=16):
    h, w, c, n, g, k, st, p = shape
    return TG.group_conv_launch_plan(b, h, w, c, n, g, (k, k), (st, st),
                                     (p, p), s_n, 132, x_align, w_align)


def _tile_run(plan, t, b, ho, wo):
    """(first output row m0, pixels) of pixel tile t, as the kernel
    computes them."""
    nb = -(-ho // plan.th)
    bi, hb = divmod(t, nb)
    b0, ho0 = bi * plan.ni, hb * plan.th
    return ((b0 * ho + ho0) * wo,
            min(plan.ni, b - b0) * min(plan.th, ho - ho0) * wo)


def _block_columns(plan, by, ocg):
    """(first output column n0, columns) of the blocks in grid row by."""
    st, ct = divmod(by, plan.ctiles)
    c0 = ct * plan.ncols
    ncl = min(plan.ncols, ocg - c0)
    return st * plan.gb * ocg + c0, plan.gb * ncl


def _offset_tables(plan, kernel, stride, wo):
    """The kernel's tap offsets (per 4-byte word of K') and pixel offsets
    (per tile pixel) into a halo buffer."""
    (kh, kw), (sh, sw) = kernel, stride
    k = np.arange(plan.kp // 4) * 4
    tap, ic = k // plan.cgp, k % plan.cgp
    koff = np.where(tap < kh * kw,
                    ((tap // kw) * plan.hwc + tap % kw) * plan.cpix + ic, 0)
    tm = plan.ni * plan.th * wo
    lp = np.arange(-(-tm // 32) * 32)
    ni, r = lp // (plan.th * wo), lp % (plan.th * wo)
    pix = np.where(lp < tm, ((ni * plan.hr + (r // wo) * sh) * plan.hwc
                             + (r % wo) * sw) * plan.cpix, 0)
    return koff, pix


@pytest.mark.parametrize("b", [1, 256])
@pytest.mark.parametrize("shape", ZOO_GROUPED + ODD_GROUPED,
                         ids=["x".join(map(str, s))
                              for s in ZOO_GROUPED + ODD_GROUPED])
def test_launch_plan_covers_and_fits(shape, b):
    """For every grouped shape of the zoo's RegNetX configs (and the odd
    ones) at batch 1 and 256, S = 1..4: the blocks cover every output
    pixel of every conv group exactly once; every tap of every pixel of a
    tile (image borders, strides 1 and 2) reads the halo cell of its input
    pixel, inside the buffer; shared memory and the grid stay within the
    card's limits; the copy widths divide the channel runs, their starts
    and the addresses."""
    h, w, c, n, g, k, st, p = shape
    ho, wo = (h + 2 * p - k) // st + 1, (w + 2 * p - k) // st + 1
    cg, ocg = c // g, n // g
    for s_n in range(1, 5):
        plan = _plan(shape, b, s_n)
        mf = -(-plan.ni * plan.th * wo // 16)
        halo = plan.ni * plan.hr * plan.hwc * plan.cpix
        assert plan.smem == TG.smem_bytes(s_n, plan.gb, plan.ncols,
                                          plan.ntw, plan.nch, plan.mt,
                                          plan.kp, halo, plan.sw,
                                          mf) <= TG.MAX_SMEM
        assert plan.mt == (2 if 2 * s_n * plan.ntw <= TG.ACC_TILES else 1)
        assert 1 <= plan.grid_x <= plan.tiles and plan.grid_y <= 65535
        assert plan.grid_y == g // plan.gb * plan.ctiles
        # copies: whole chunks of the set's channel run, at aligned starts
        run = plan.gb * cg
        assert plan.cw in (16, 8, 4, 1) and run % plan.cw == 0
        assert c % plan.cw == 0 and plan.cpix % max(4, plan.cw) == 0
        assert plan.cpix >= plan.gb * plan.cgp and plan.cgp % 4 == 0
        assert (plan.cw == 1) == (cg % 4 != 0)
        assert plan.cww in (16, 8, 4, 1) and (k * k * cg) % plan.cww == 0
        assert plan.kp % 32 == 0 and plan.kp >= k * k * plan.cgp
        assert plan.nch * plan.ntw * 8 >= plan.ncols and plan.ntw <= 4
        assert plan.sw >= 8 * plan.ntw and plan.sw % 32 in (8, 24)
        # fragment reads of neighbouring pixels: at most 2-way conflicts
        assert TG.bank_conflicts(plan.cpix, st) <= 2
        # pixels: each tile once, the tiles' runs partition the M rows
        seen = sorted(t for bx in range(plan.grid_x)
                      for t in range(bx, plan.tiles, plan.grid_x))
        assert seen == list(range(plan.tiles))
        runs = sorted(_tile_run(plan, t, b, ho, wo)
                      for t in range(plan.tiles))
        assert runs[0][0] == 0 and all(
            m0 + cnt == nxt for (m0, cnt), (nxt, _) in zip(runs, runs[1:]))
        assert sum(cnt for _, cnt in runs) == b * ho * wo
        # columns: the grid rows' runs partition the N channels
        cols = sorted(_block_columns(plan, by, ocg)
                      for by in range(plan.grid_y))
        assert cols[0][0] == 0 and all(
            n0 + wb == nxt for (n0, wb), (nxt, _) in zip(cols, cols[1:]))
        assert sum(wb for _, wb in cols) == n
        assert all(n0 % plan.ovec == 0 and wb % plan.ovec == 0
                   for n0, wb in cols) and n % plan.ovec == 0
        assert ocg % plan.ovec == 0 and (
            plan.nch == 1 or 8 * plan.ntw % plan.ovec == 0)
        # every tap of the first and last tiles' pixels: its halo row holds
        # input row ho*s - p + kh of its image, its cell input column
        # wo*s - p + kw, and the read stays inside the buffer
        koff, pix = _offset_tables(plan, (k, k), (st, st), wo)
        assert pix.max() + koff.max() + (plan.gb - 1) * cg + 4 <= halo
        nb = -(-ho // plan.th)
        for t in {0, plan.tiles - 1}:
            m0, cnt = _tile_run(plan, t, b, ho, wo)
            m = m0 + np.arange(cnt)
            img, rem = m // (ho * wo), m % (ho * wo)
            oh, ow = rem // wo, rem % wo
            b0 = t // nb * plan.ni
            hi0 = t % nb * plan.th * st - p
            lp = np.arange(cnt)
            for kh in range(k):
                for kw in range(k):
                    cell = (pix[lp] + (kh * plan.hwc + kw) * plan.cpix) \
                        // plan.cpix
                    row, col = cell // plan.hwc, cell % plan.hwc
                    assert (row < plan.ni * plan.hr).all()
                    assert np.array_equal(b0 + row // plan.hr, img)
                    assert np.array_equal(hi0 + row % plan.hr,
                                          oh * st - p + kh)
                    assert np.array_equal(col - p, ow * st - p + kw)


def _emulate(x, wm, geom, g, plan, pad, rng):
    """The kernel's algorithm in numpy, by its plan: per block the staged
    weights (k' = tap*cgp + ic, zeros past Cg, the taps and the group's
    columns), per tile a halo buffer of stale bytes filled as the kernel
    fills it (the set's channel run per cell, the pad code outside the
    image), every tap read through the offset tables. Returns the (S, M,
    N) int64 sums; raises if an output is written twice or never."""
    b, h, w, c = x.shape
    s_n, n, _ = wm.shape
    (kh, kw), (sh, sw), (ph, pw) = geom
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    cg, ocg, taps = c // g, n // g, kh * kw
    ntp8 = plan.nch * plan.ntw * 8
    koff, pix = _offset_tables(plan, (kh, kw), (sh, sw), wo)
    nbytes = plan.ni * plan.hr * plan.hwc * plan.cpix
    nb = -(-ho // plan.th)
    out = np.zeros((s_n, b * ho * wo, n), np.int64)
    written = np.zeros((b * ho * wo, n), np.int64)
    for by in range(plan.grid_y):
        st, ct = divmod(by, plan.ctiles)
        g0, c0 = st * plan.gb, ct * plan.ncols
        ncl = min(plan.ncols, ocg - c0)
        n0 = g0 * ocg + c0
        wts = np.zeros((s_n, plan.gb, ntp8, plan.kp), np.int64)
        for gi in range(plan.gb):
            rows = wm[:, (g0 + gi) * ocg + c0:(g0 + gi) * ocg + c0 + ncl]
            for tp in range(taps):
                wts[:, gi, :ncl, tp * plan.cgp:tp * plan.cgp + cg] = \
                    rows[:, :, tp * cg:(tp + 1) * cg]
        for bx in range(plan.grid_x):
            for t in range(bx, plan.tiles, plan.grid_x):
                buf = rng.integers(-128, 128, nbytes)
                bi, hb = divmod(t, nb)
                b0, hi0 = bi * plan.ni, hb * plan.th * sh - ph
                for r in range(plan.ni * plan.hr):
                    img, hi = b0 + r // plan.hr, hi0 + r % plan.hr
                    for col in range(plan.hwc):
                        wi, at = col - pw, (r * plan.hwc + col) * plan.cpix
                        buf[at:at + plan.gb * cg] = (
                            x[img, hi, wi, g0 * cg:(g0 + plan.gb) * cg]
                            if img < b and 0 <= hi < h and 0 <= wi < w
                            else pad)
                m0, cnt = _tile_run(plan, t, b, ho, wo)
                for gi in range(plan.gb):
                    at = (pix[:cnt, None] + koff[None, :] + gi * cg)[
                        :, :, None] + np.arange(4)
                    a = buf[at.reshape(cnt, plan.kp)]
                    cols = n0 + gi * ncl + np.arange(ncl)
                    for s in range(s_n):
                        out[s, m0:m0 + cnt, cols] = (a @ wts[s, gi, :ncl].T).T
                    written[m0:m0 + cnt, cols] += 1
    assert (written == 1).all()
    return out


# (b, h, w, c, n, G, kernel, stride, padding, S, pad value)
EMULATED = [
    (3, 7, 7, 48, 48, 2, 3, 1, 1, 2, 0),       # 600M's Cg 24, two a block
    (2, 9, 9, 48, 48, 2, 3, 2, 1, 1, -128),    # stride 2, odd size
    (2, 15, 15, 96, 96, 4, 3, 2, 1, 4, 0),     # 15x15/s2, S = 4
    (1, 14, 14, 72, 72, 3, 3, 1, 1, 1, -3),    # odd G: one group a block
    (2, 8, 8, 80, 80, 2, 3, 1, 1, 3, 0),       # Cg = 40 (4000M)
    (2, 7, 7, 112, 112, 2, 3, 1, 1, 2, 5),     # Cg = 56 (6400M)
    (1, 9, 9, 15, 15, 3, 3, 2, 1, 4, 9),       # odd Cg = OC/G = 5, bytes
    (2, 6, 6, 48, 72, 4, 3, 1, 1, 2, 0),       # Cg 12, OC/G 18: 4 a block
    (2, 6, 6, 96, 80, 2, 1, 1, 0, 1, 0),       # 1x1, OC/G = 40
    (1, 5, 5, 256, 512, 1, 3, 1, 1, 1, 0),     # column tiles
    (40, 7, 7, 16, 16, 2, 3, 1, 1, 1, 0),      # many images, tiles cross
]


@pytest.mark.parametrize("case", EMULATED,
                         ids=["x".join(map(str, e[:9])) for e in EMULATED])
def test_launch_plan_emulated_matches_plain(case):
    """The kernel's tiling, emulated in numpy from its plan (offset tables,
    halo buffers of stale bytes, padded weights), gives the plain version's
    int32 sums bit for bit for every weight group."""
    b, h, w, c, n, g, k, st, p, s_n, pad = case
    rng = np.random.default_rng(b * 131 + c + n)
    x = rng.integers(-128, 128, (b, h, w, c)).astype(np.int8)
    wm = rng.integers(-128, 128, (s_n, n, k * k * c // g)).astype(np.int8)
    geom = ((k, k), (st, st), (p, p))
    plan = TG.group_conv_launch_plan(b, h, w, c, n, g, *geom, s_n)
    if c == 256:
        assert plan.ctiles > 1
    plans = [plan]
    if b > 1:
        # whole images, the last tile short, each block walking tiles
        ho = (h + 2 * p - k) // st + 1
        ni = min(3, b)
        tiles = -(-b // ni)
        plans.append(dataclasses.replace(
            plan, ni=ni, th=ho, hr=(ho - 1) * st + k, tiles=tiles,
            grid_x=max(1, tiles // 2)))
    for pl in plans:
        got = _emulate(x, wm.astype(np.int64), geom, g, pl, pad, rng)
        for s in range(s_n):
            want = TG.int8_group_conv_plain(
                torch.as_tensor(x), torch.as_tensor(wm[s:s + 1]), *geom, g,
                pad_value=pad)
            assert np.array_equal(got[s], want.reshape(-1, n).numpy())


def test_launch_plan_struct_matches_the_kernel():
    """The plan's decisions, LaunchPlan's leading fields, are the kernel's
    struct Plan, in order, and all that c_args passes."""
    import re
    from pathlib import Path
    src = (Path(TG.__file__).resolve().parents[2] / "csrc"
           / "int8_group_conv.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\w+", body.replace("int", " ", 1))
    names = [f.name for f in dataclasses.fields(TG.LaunchPlan)]
    assert fields == list(TG.DECISIONS) == names[:len(fields)]
    plan = _plan(ZOO_GROUPED[0], 4, 2)
    assert list(plan.c_args) == [getattr(plan, f) for f in fields]


def test_launch_plan_refuses_what_does_not_fit():
    """A halo row wider than shared memory, even one output row a tile,
    raises before any launch; so does a shape with no output."""
    with pytest.raises(ValueError, match="shared memory"):
        TG.group_conv_launch_plan(1, 64, 64, 8192, 8192, 2, (3, 3), (1, 1),
                                  (1, 1), 1)
    with pytest.raises(ValueError, match="no kernel launch"):
        TG.group_conv_launch_plan(1, 2, 2, 8, 8, 2, (5, 5), (1, 1), (0, 0),
                                  1)


def test_launch_plan_copy_widths_follow_alignment():
    """The halo copy shrinks to what the codes' address allows (bytes below
    4), the weight copy to the weights' address."""
    shape = (14, 14, 240, 240, 10, 3, 1, 1)
    assert _plan(shape, 4, 2).cw == 16
    assert _plan(shape, 4, 2, x_align=8).cw == 8
    assert _plan(shape, 4, 2, x_align=2).cw == 1
    assert _plan(shape, 4, 2, w_align=4).cww == 4
