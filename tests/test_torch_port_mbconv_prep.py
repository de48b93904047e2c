"""PyTorch port vs the JAX package: what the inverted-residual (mbconv)
kernel reads, laid out once by ``prepare_mbconv``, the kernel's order of
work emulated by ``mbconv_plain_prepared``, and the arithmetic its CUDA
epilogues fold.

- The chunk records unpack back to the weights and rows they were made
  from, and their fragment bytes follow the m16n8k32 register layout.
- ``mbconv_plain_prepared`` (chunk by chunk of 32 expanded channels) equals
  ``mbconv_fused_plain`` bit for bit, with chunk remainders, with and
  without the expand and the residual, at ragged band and image sizes,
  with 8-bit stage clips over the whole int8 range, and with a B_e that
  makes expand(0) nonzero (zero padding is zero in q1, not expand(0)).
  Both are held to the Pallas kernel in interpret mode by
  ``tests/test_torch_port_mbconv_kernels.py``.
- The folded epilogue (clamp before floor, the floor as an add of 1.5 *
  2^23 rounded down whose low byte is the code, the accumulators started
  at the bits of 1.5 * 2^23) against the step-by-step chain over every
  clamp and rounding tie.
- ``prepare_mbconv`` refuses clip bounds the folded epilogue cannot
  take: fractional ones, and stage clips above 255.
- The launch plan takes all 8 stride-1 MobileNetV2 block shapes and
  refuses, before any launch, the shapes the kernel cannot take.
"""
import numpy as np
import pytest
import torch

from shiftedscalequantization_tpu_torch.ops.cuda import mbconv as TMB

MAGIC = np.float32(12582912.0)      # 1.5 * 2^23, as in the CUDA source
MAGIC_I = 0x4B400000                # its bits


def _inputs(rng, b, h, w, ci, ce, co, full=False):
    """Block codes and rows: 4-bit codes, W2 weights and 4-bit clips; or
    (full) codes over the whole int8 range with 8-bit clips and rows that
    spread every stage over its range."""
    if full:
        x = rng.integers(-128, 128, (b, h, w, ci))
        we, wd, wp = (rng.integers(-128, 128, s)
                      for s in ((ci, ce), (9, ce), (ce, co)))
        ae = [rng.uniform(0.5, 1.5, ce) * 128 / (np.sqrt(ci) * 5470),
              rng.normal(size=ce) * 30 + 100]
        ad = [rng.uniform(0.5, 1.5, ce) * 128 / 22000,
              rng.normal(size=ce) * 30 + 100]
        ap = [rng.uniform(0.5, 1.5, co) * 128 / (np.sqrt(ce) * 9000),
              rng.normal(size=co) * 10]
        qp = [255, 255, 0.7, -128, 127, 0]
    else:
        x = rng.integers(-8, 8, (b, h, w, ci))
        we, wd, wp = (rng.integers(-2, 2, s)
                      for s in ((ci, ce), (9, ce), (ce, co)))
        ae = [rng.uniform(0.05, 0.3, ce), rng.normal(size=ce) + 0.5]
        ad = [rng.uniform(0.05, 0.3, ce), rng.normal(size=ce) + 0.5]
        ap = [rng.uniform(0.01, 0.1, co), rng.normal(size=co) + 0.5]
        qp = [15, 15, 0.7, -8, 7, 0]
    t8 = lambda a: torch.as_tensor(np.asarray(a, np.int8))     # noqa: E731
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa
    return (t8(x), t8(we), f32(ae), t8(wd), f32(ad), t8(wp), f32(ap),
            f32(qp))


@pytest.mark.parametrize("ci,ce,co,expand", [
    (8, 48, 12, True), (20, 40, 20, True), (24, 144, 24, True),
    (160, 960, 160, True), (24, 24, 16, False)])
def test_prepared_records_unpack_to_the_weights(ci, ce, co, expand):
    """Each record holds its chunk's weights and rows, zero past CE."""
    rng = np.random.default_rng(ci + ce)
    _, we, ae, wd, ad, wp, ap, qp = _inputs(rng, 1, 1, 1, ci, ce, co,
                                            full=True)
    k = TMB.prepare_mbconv(we, ae, wd, ad, wp, ap, qp, expand, False)
    nch = -(-ce // 32)
    assert k.chunks.dtype == torch.uint8
    assert tuple(k.chunks.shape) == (
        nch, TMB.record_layout(ci, co, expand)[1])
    got_we, got_wd, got_wp, got_ae, got_ad = TMB.unpack_mbconv(k)
    if expand:
        assert torch.equal(got_we, we.to(torch.int32))
        assert torch.equal(got_ae, ae)
    else:
        assert got_we is None and got_ae is None
    assert torch.equal(got_wd, wd.to(torch.int32))
    assert torch.equal(got_wp, wp.to(torch.int32))
    assert torch.equal(got_ad, ad)
    # the channels past CE: zero weights, zero rows
    for name, dtype in (("wd", torch.int32), ("ad", torch.float32)):
        part = TMB._part(k, name, dtype)[-1]
        if ce % 32 and name == "wd":
            assert not part.reshape(32, 3)[ce % 32:].any()
        if ce % 32 and name == "ad":
            assert not part.reshape(2, 32)[:, ce % 32:].any()


def test_expand_columns_give_a_thread_consecutive_channels():
    """Column p of the expand product is channel 8t + 2nt + e for the
    accumulator (n-tile nt, column 2t + e) that thread t holds: a thread's
    eight accumulators of a pixel row are channels 8t .. 8t + 7."""
    col = TMB.expand_column_channel()
    assert sorted(col.tolist()) == list(range(32))
    for t in range(4):
        got = [int(col[8 * nt + 2 * t + e]) for nt in range(4)
               for e in range(2)]
        assert got == list(range(8 * t, 8 * t + 8))


def test_fragment_bytes_follow_the_mma_layout():
    """Byte j of lane l's B fragment of k-step ks, n-tile nt: register
    j // 4 holds k = 32 ks + 16 (j // 4) + 4 (l % 4) + j % 4, column
    (n) l // 4; checked element by element for the expand and the
    project records of a two-chunk block."""
    rng = np.random.default_rng(5)
    ci, ce, co = 40, 64, 24
    _, we, ae, wd, ad, wp, ap, qp = _inputs(rng, 1, 1, 1, ci, ce, co,
                                            full=True)
    k = TMB.prepare_mbconv(we, ae, wd, ad, wp, ap, qp, True, False)
    fe = TMB._part(k, "we", torch.int8).reshape(2, 2, 4, 32, 8)
    fp = TMB._part(k, "wp", torch.int8).reshape(2, 3, 32, 8)
    col = TMB.expand_column_channel()
    for c in range(2):
        for lane in (0, 5, 18, 31):
            for j in range(8):
                kk = 16 * (j // 4) + 4 * (lane % 4) + j % 4
                for ks in range(2):
                    for nt in range(4):
                        ch = 32 * c + int(col[8 * nt + lane // 4])
                        want = int(we[32 * ks + kk, ch]) \
                            if 32 * ks + kk < ci else 0
                        assert int(fe[c, ks, nt, lane, j]) == want
                for nt in range(3):
                    assert int(fp[c, nt, lane, j]) == \
                        int(wp[32 * c + kk, 8 * nt + lane // 4])


CASES = [
    # (b, h, w, ci, ce, co, expand, residual)
    (2, 8, 8, 16, 96, 16, True, True),      # 3 whole chunks
    (2, 13, 13, 20, 40, 20, True, True),    # H = 13, a chunk of 8
    (1, 13, 11, 8, 48, 12, True, False),    # a chunk of 16, W != H
    (2, 7, 7, 32, 144, 32, True, True),     # 7x7, a chunk of 16
    (2, 6, 5, 24, 144, 32, True, False),
    (2, 8, 8, 32, 32, 16, False, False),    # dw only
    (2, 7, 7, 16, 16, 16, False, True),     # dw + residual, half a chunk
    (1, 9, 9, 40, 40, 40, False, True),     # dw only, two chunks
]


@pytest.mark.parametrize("full", [False, True], ids=["4bit", "full"])
@pytest.mark.parametrize("b,h,w,ci,ce,co,expand,residual", CASES)
def test_plain_prepared_matches_plain(b, h, w, ci, ce, co, expand, residual,
                                      full):
    """Chunk by chunk in the kernel's order == the straightforward version,
    bit for bit, on 4-bit codes and over the whole int8 range with 8-bit
    clips; no launch on CPU tensors."""
    rng = np.random.default_rng(h * 100 + ce + full)
    args = _inputs(rng, b, h, w, ci, ce, co, full)
    kw = dict(has_expand=expand, has_residual=residual)
    k = TMB.prepare_mbconv(*args[1:], **kw)
    before = TMB.mbconv_fused.launches
    got = TMB.mbconv_fused_prepared(args[0], k)
    assert TMB.mbconv_fused.launches == before
    want = TMB.mbconv_fused_plain(*args, **kw)
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got, want)
    if full:       # the outputs span the 8-bit grid
        assert int(want.min()) < -64 and int(want.max()) > 64


def test_zero_padding_is_zero_not_expand_of_zero():
    """A B_e of 5.5 makes expand(0) = 5, not 0; the border that the dw
    reads must stay 0. The plain versions agree, and differ from a block
    that pads with expand(0) (the input padded before the expand)."""
    rng = np.random.default_rng(1)
    x, we, ae, wd, ad, wp, ap, qp = _inputs(rng, 1, 5, 5, 8, 40, 8)
    ae[1] = 5.5
    wd[:] = 1
    k = TMB.prepare_mbconv(we, ae, wd, ad, wp, ap, qp, True, True)
    got = TMB.mbconv_plain_prepared(x, k)
    assert torch.equal(got, TMB.mbconv_fused_plain(x, we, ae, wd, ad, wp,
                                                   ap, qp))
    xp = torch.zeros((1, 7, 7, 8), dtype=torch.int8)
    xp[:, 1:6, 1:6] = x
    padded = TMB.mbconv_fused_plain(xp, we, ae, wd, ad, wp, ap, qp,
                                    has_residual=False)
    k_nores = TMB.prepare_mbconv(we, ae, wd, ad, wp, ap, qp, True, False)
    plain = TMB.mbconv_plain_prepared(x, k_nores)
    assert not torch.equal(plain, padded[:, 1:6, 1:6])


def _fadd_rd_magic(v):
    """__fadd_rd(v, MAGIC) for f32 v with |v| < 2^22: the exact sum lies
    in [2^23, 2^24), where the f32 grid is the integers, so rounding it
    down gives MAGIC + floor(v) (an f64 sum would lose a denormal v)."""
    return (np.float64(MAGIC) + np.floor(v.astype(np.float64))).astype(
        np.float32)


@pytest.mark.parametrize("lo,hi", [(0, 15), (0, 255), (-8, 7),
                                   (-128, 127), (0, 0)])
def test_folded_epilogue_matches_step_by_step(lo, hi):
    """clip(floor(v), lo, hi) == the low byte of __fadd_rd(clamp(v, lo,
    hi), MAGIC) as an int8 / uint8 code, at every integer k around the
    bounds and in between, at k, k + 1 ulp, k + 0.5 (a tie), k + 1 - 1
    ulp, k - 1 ulp and far outside."""
    ks = np.arange(lo - 3, hi + 4, dtype=np.float32)
    one = np.float32(1)
    v = np.concatenate([
        ks, np.nextafter(ks, ks + one), ks + np.float32(0.5),
        np.nextafter(ks + one, ks), np.nextafter(ks, ks - one),
        np.float32([-3e6, -1e30, 4e6, 1e30])]).astype(np.float32)
    step = np.clip(np.floor(v), lo, hi)
    clamped = np.minimum(np.maximum(v, np.float32(lo)), np.float32(hi))
    bits = _fadd_rd_magic(clamped).view(np.uint32)
    low = (bits & 0xFF).astype(np.uint8)
    code = low.view(np.int8) if lo < 0 else low
    np.testing.assert_array_equal(code.astype(np.float32), step)
    np.testing.assert_array_equal(
        TMB.floor_code(torch.as_tensor(v), lo, hi).numpy(), step)


@pytest.mark.parametrize("at,value,match", [
    (0, 15.5, "integers"), (1, 7.25, "integers"), (3, -8.5, "integers"),
    (4, 6.999, "integers"), (0, 256.0, "<= 255"), (1, 511.0, "<= 255")])
def test_prepare_refuses_bounds_the_folded_epilogue_cannot_take(at, value,
                                                                match):
    """The kernel clamps before it floors, which equals floor-then-clip
    only for integer bounds; its stage codes are bytes."""
    args = list(_inputs(np.random.default_rng(7), 1, 4, 4, 8, 16, 8))
    args[7][at] = value
    with pytest.raises(ValueError, match=match):
        TMB.prepare_mbconv(*args[1:], has_expand=True, has_residual=True)


def test_accumulator_magic_start_converts_exactly():
    """A sum s accumulated from the bits of MAGIC reads, as a float, MAGIC
    + s, and one subtraction gives (float) s exactly for |s| < 2^22: the
    expand (|s| <= 256 * 128 * 128 = 2^22, reached only at CI = 256 with
    every code -128) and the dw (9 * 255 * 128) stay inside."""
    s = np.concatenate([np.arange(-5000, 5000),
                        np.array([-(1 << 22), (1 << 22) - 1, 293760,
                                  -293760, 160 * 128 * 128,
                                  -160 * 128 * 127])]).astype(np.int64)
    bits = (MAGIC_I + s).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(bits - MAGIC, s.astype(np.float32))


MNV2_BLOCKS = [(112, 32, 32, 16, False), (56, 24, 144, 24, True),
               (28, 32, 192, 32, True), (14, 64, 384, 64, True),
               (14, 64, 384, 96, True), (14, 96, 576, 96, True),
               (7, 160, 960, 160, True), (7, 160, 960, 320, True)]


@pytest.mark.parametrize("h,ci,ce,co,expand", MNV2_BLOCKS)
def test_launch_plan_takes_every_mobilenetv2_block(h, ci, ce, co, expand):
    """Every stride-1 block shape gets bands of at most P_MAX pixels (a
    whole image at 14x14 and 7x7), a unit class that covers its output
    tiles, and shared memory within the card's limit."""
    plan = TMB.launch_plan(h, h, ci, ce, co, expand)
    assert 1 <= plan.rows <= h and plan.rows * h <= TMB.P_MAX
    assert plan.rows == h or h >= 28
    upw, ntg = TMB.CLASSES[plan.cls]
    mt, nt = -(-(plan.rows * h) // 16), -(-co // 8)
    assert -(-nt // plan.groups) <= ntg
    assert -(-(mt * plan.groups) // TMB.WARPS) <= upw
    assert plan.smem == TMB.smem_bytes(plan.rows, h, h, ci, ce, co, expand)
    assert plan.smem <= TMB.MAX_SMEM


@pytest.mark.parametrize("h,w,ci,ce,co,expand,match", [
    (8, 8, 22, 44, 24, True, "multiples of 4"),
    (8, 8, 24, 48, 18, True, "multiples of 4"),
    (8, 8, 288, 576, 32, True, "up to 256"),
    (8, 8, 32, 64, 32, False, "CE must equal CI"),
    (4, 900, 32, 64, 32, True, "cannot take")])
def test_launch_plan_refuses_what_the_kernel_cannot_take(h, w, ci, ce, co,
                                                         expand, match):
    with pytest.raises(ValueError, match=match):
        TMB.launch_plan(h, w, ci, ce, co, expand)
