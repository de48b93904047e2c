"""PyTorch port vs the JAX package: what the depthwise and stem kernels
read, built once per plan, and the arithmetic their CUDA epilogues fold.

- The dw unit's setup-time constants (tap words, scalef, [1/delta, zp,
  qmax]) through the plain route against the Pallas kernel in interpret
  mode, bit for bit.
- The stem's operands: the hi/lo split against JAX's astype(bf16) split and
  the K-major bf16 weight layout against the codes and against JAX's
  banded matrix, bit for bit; the 2-pass product emulated in PyTorch
  against the Pallas kernel in interpret mode, held to the JAX package's
  own flip rate (tests/test_pallas_fused.py:51).
- The folded requant of both kernels (one clamp, a magic-number rint, the
  low float byte as the code) emulated in f32 against the step-by-step
  epilogue over accumulators that reach every clamp and rounding tie.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from shiftedscalequantization_tpu.ops.pallas.depthwise import \
    dw_conv3x3_int8 as j_dw
from shiftedscalequantization_tpu.ops.pallas.stem import \
    build_stem_weights as j_stem_weights
from shiftedscalequantization_tpu.ops.pallas.stem import stem_fused as j_stem
from shiftedscalequantization_tpu_torch.ops.cuda import depthwise as TDW
from shiftedscalequantization_tpu_torch.ops.cuda import stem as TS

MAGIC = np.float32(12582912.0)      # 1.5 * 2^23, as in the CUDA sources


def _dw_inputs(rng, h, w, c):
    x = rng.integers(-8, 8, (2, h, w, c)).astype(np.int8)
    wc = rng.integers(-2, 2, (c, 3, 3)).astype(np.int8)
    scalef = rng.uniform(0.001, 0.05, c).astype(np.float32)
    biasf = (rng.normal(size=c) * 0.5).astype(np.float32)
    return x, wc, scalef, biasf


@pytest.mark.parametrize("h,w,c,stride,act", [
    (8, 8, 32, 1, "relu6"), (9, 7, 30, 2, "relu"), (16, 16, 24, 2, "none"),
    (7, 7, 96, 1, "relu6"), (12, 10, 13, 1, "relu"), (5, 6, 7, 2, "relu6")])
def test_dw_prepared_constants_match_pallas(h, w, c, stride, act):
    """The shapes of test_dw_plain_matches_pallas, through prepare_dw and
    the prepared route: bit-exact against the Pallas kernel, no launch on
    CPU tensors, and each constant the value the per-call route took."""
    rng = np.random.default_rng(h * 100 + c)
    x, wc, scalef, biasf = _dw_inputs(rng, h, w, c)
    delta, zp, qmax = np.float32(0.07), 7.0, 15.0
    want = np.asarray(j_dw(jnp.asarray(x), jnp.asarray(wc),
                           jnp.asarray(scalef), jnp.asarray(biasf), delta,
                           zp, qmax, stride=stride, act=act, interpret=True))
    k = TDW.prepare_dw(torch.as_tensor(wc), torch.as_tensor(scalef),
                       torch.as_tensor(biasf), torch.tensor(delta), zp, qmax)
    assert k.w_taps.dtype == torch.int32 and tuple(k.w_taps.shape) == (c, 3)
    assert int(k.w_taps.max()) < 1 << 24          # byte 3 stays zero
    np.testing.assert_array_equal(TDW.unpack_taps(k.w_taps).numpy(), wc)
    np.testing.assert_array_equal(k.scalef.numpy(), scalef)
    np.testing.assert_array_equal(
        k.qp.numpy(), np.array([np.float32(1) / delta, zp, qmax], np.float32))
    before = TDW.dw_conv3x3_int8.launches
    got = TDW.dw_conv3x3_int8_prepared(torch.as_tensor(x), k, stride, act)
    assert TDW.dw_conv3x3_int8.launches == before
    np.testing.assert_array_equal(got.numpy(), want)


def test_dw_tap_words_round_trip_the_int8_range():
    codes = torch.arange(-128, 127, dtype=torch.int32)
    w = torch.stack([codes, codes.flip(0), codes.roll(7)], 1)
    w = torch.stack([w, w.roll(3, 0), -w.clamp(-127)], 1)    # (255, 3, 3)
    words = TDW.pack_taps(w)
    assert words.dtype == torch.int32 and int(words.min()) >= 0
    assert torch.equal(TDW.unpack_taps(words), w)
    # the kernel's dp4a reads byte kw of word (c, kh) as tap (kh, kw)
    b = words.numpy().astype(np.uint32).view(np.uint8).reshape(255, 3, 4)
    np.testing.assert_array_equal(b[..., :3].view(np.int8), w.numpy())
    assert not b[..., 3].any()


def _clamp_bounds(inv, zp, qmax, act_lo, act_hi):
    """The kernels' folded clamp: the activation range in rint(y * inv)
    units intersected with [-zp, qmax - zp]; disjoint ranges collapse to
    the bound the step-by-step chain reaches."""
    lo, hi = -zp, qmax - zp
    alo = np.rint(np.float32(act_lo) * inv) if act_lo is not None else -np.inf
    ahi = np.rint(np.float32(act_hi) * inv) if act_hi is not None else np.inf
    l2, h2 = max(alo, lo), min(ahi, hi)
    if l2 > h2:
        l2 = h2 = lo if ahi < lo else hi
    return np.float32(l2), np.float32(h2)


def _folded_codes(t, lo, hi, offset=0):
    """rint(clamp(t, lo, hi)) by the magic-number add, read as the low
    byte of the float, plus a byte offset (mod 256), as int8."""
    r = (np.clip(t, lo, hi).astype(np.float32) + MAGIC).astype(np.float32)
    return ((r.view(np.uint32) + np.uint32(offset & 0xFF)) & 0xFF) \
        .astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("act", ["none", "relu", "relu6"])
@pytest.mark.parametrize("delta,zp,qmax", [
    (0.07, 7.0, 15.0), (0.013, 128.0, 255.0), (0.5, 0.0, 15.0),
    (0.25, 8.0, 15.0), (2.0, 3.0, 7.0)])
def test_dw_folded_epilogue_equals_step_by_step(act, delta, zp, qmax):
    """Every int32 sum the epilogue can meet around the clamps and the
    rounding ties: the CUDA kernel's folded form equals the plain
    version's chain (act, rint(y * inv) + zp, clip, - zp)."""
    rng = np.random.default_rng(int(delta * 1000) + int(zp))
    acc = np.concatenate([np.arange(-3000, 3000),
                          rng.integers(-300000, 300000, 20000)])
    # a power-of-two step without bias puts sums on exact rounding ties
    dyadic = delta in (0.5, 0.25, 2.0)
    scalef = np.float32(0.5 * delta)
    biasf = np.float32(0.0 if dyadic else rng.normal() * 0.1)
    inv = np.float32(1) / np.float32(delta)
    y = (acc.astype(np.float32) * scalef).astype(np.float32) + biasf
    y = y.astype(np.float32)
    if act == "relu":
        ya = np.maximum(y, 0)
    elif act == "relu6":
        ya = np.clip(y, 0, 6)
    else:
        ya = y
    q = np.clip(np.rint((ya * inv).astype(np.float32)) + zp, 0, qmax) - zp
    want = q.astype(np.int8)
    act_lo = None if act == "none" else 0.0
    act_hi = 6.0 if act == "relu6" else None
    lo, hi = _clamp_bounds(inv, zp, qmax, act_lo, act_hi)
    got = _folded_codes((y * inv).astype(np.float32), lo, hi)
    if dyadic:
        assert np.isin((ya * inv).astype(np.float32) % 1, 0.5).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("delta,zp,qmax,coff", [
    (0.02, 0.0, 255.0, 128.0), (0.1, 0.0, 15.0, 0.0),
    (0.1, 7.0, 15.0, 7.0), (0.05, 3.0, 15.0, 128.0)])
def test_stem_folded_epilogue_equals_step_by_step(delta, zp, qmax, coff):
    """The stem's form: relu folded into the clamp's low bound, the
    (zp - center_off) offset a byte add; against relu, rint(y * inv) + zp,
    clip, - center_off."""
    rng = np.random.default_rng(int(coff) + 1)
    t0 = np.arange(-40000, 40000, dtype=np.float32) * np.float32(0.01)
    y = np.concatenate([t0, (np.arange(-600, 600) * 0.5 * delta)
                        .astype(np.float32),
                        rng.normal(size=20000).astype(np.float32) * 9])
    inv = np.float32(1) / np.float32(delta)
    q = np.clip(np.rint((np.maximum(y, 0) * inv).astype(np.float32)) + zp,
                0, qmax) - coff
    want = q.astype(np.int8)
    lo, hi = _clamp_bounds(inv, zp, qmax, 0.0, None)
    got = _folded_codes((y * inv).astype(np.float32), lo, hi,
                        int(zp - coff))
    np.testing.assert_array_equal(got, want)


def test_stem_hi_lo_split_matches_jax():
    """hi = bf16(x), lo = bf16(x - hi), both round to nearest even: the
    bit patterns of JAX's astype split (stem.py:131-132)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=50000) * 3,
                        rng.uniform(-1e-3, 1e-3, 5000),
                        np.round(rng.normal(size=5000) * 8) / 8,
                        [0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8]])
    x = x.astype(np.float32)
    hi, lo = TS.split_hi_lo(torch.as_tensor(x))
    jx = jnp.asarray(x)
    jhi = jx.astype(jnp.bfloat16)
    jlo = (jx - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(hi.view(torch.int16).numpy(),
                                  np.asarray(jhi).view(np.int16))
    np.testing.assert_array_equal(lo.view(torch.int16).numpy(),
                                  np.asarray(jlo).view(np.int16))
    grid = np.round(rng.normal(size=1000) * 8).astype(np.float32) / 8
    assert not TS.split_hi_lo(torch.as_tensor(grid))[1].float().any()


@pytest.mark.parametrize("oc", [16, 64])
def test_stem_weight_layout_unpacks_to_the_codes(oc):
    """K-major bf16, k = 22 kh + 3 kw + ch: the codes bit for bit, zeros at
    j = 21 and k >= 154, each kernel row the same 21 values as the JAX
    package's banded matrix (row 39 kh + 3 kw + ch at t = 0); the kernel's
    tiling is wgmma's core matrices: element (channel n, k) at k-step
    k // 16, block n // 8, half (k // 8) % 2, row n % 8, column k % 8."""
    rng = np.random.default_rng(oc)
    w = rng.integers(-128, 128, (oc, 3, 7, 7)).astype(np.float32)
    lay = TS.stem_weight_layout(torch.as_tensor(w))
    assert lay.dtype == torch.bfloat16
    assert tuple(lay.shape) == (TS.K // 16, oc // 8, 2, 8, 8)
    np.testing.assert_array_equal(TS.unpack_stem_weights(lay).numpy(), w)
    dense = TS.stem_weight_matrix(torch.as_tensor(w)).float().numpy()
    assert dense.shape == (oc, TS.K)
    assert not dense[:, 21:154:22].any() and not dense[:, 154:].any()
    jw = np.asarray(j_stem_weights(jnp.asarray(w)).astype(jnp.float32))
    for kh in range(7):
        np.testing.assert_array_equal(dense[:, 22 * kh:22 * kh + 21],
                                      jw[39 * kh:39 * kh + 21, :oc].T)
    tiles = lay.float().numpy()
    for n, k in ((0, 0), (oc - 1, 153), (9, 22), (oc // 2 + 3, 100)):
        assert tiles[k // 16, n // 8, (k // 8) % 2, n % 8, k % 8] \
            == dense[n, k]


def _stem_inputs(rng, h, oc):
    x = rng.normal(size=(2, h, h, 3)).astype(np.float32)
    w = rng.integers(-120, 121, (oc, 3, 7, 7)).astype(np.float32)
    scale = rng.uniform(0.001, 0.004, oc).astype(np.float32)
    bias = (rng.normal(size=oc) * 0.1).astype(np.float32)
    return x, w, scale, bias


@pytest.mark.parametrize("h,oc,biased,seed", [(32, 16, True, 0),
                                              (64, 64, True, 1),
                                              (64, 16, False, 3)])
def test_stem_2pass_emulation_matches_pallas(h, oc, biased, seed):
    """The kernel's 2-pass bf16 product, emulated in PyTorch (f32 convs of
    hi and lo against the bf16 layout's codes), vs stem_fused(interpret=
    True): summation order differs, so a code may differ by one step at a
    rounding boundary, on at most 2e-3 of outputs."""
    rng = np.random.default_rng(seed)
    x, w, scale, bias = _stem_inputs(rng, h, oc)
    q = (0.02, 0.0, 255.0, 128.0) if biased else (0.1, 0.0, 15.0, 0.0)
    want = np.asarray(j_stem(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(scale), jnp.asarray(bias), *q,
                             interpret=True))
    k = TS.prepare_stem(torch.as_tensor(w), torch.as_tensor(scale),
                        torch.as_tensor(bias), *q)
    got = TS.stem_2pass_plain(torch.as_tensor(x), k)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 2e-3, (diff != 0).mean()


@pytest.mark.parametrize("biased", [True, False])
def test_stem_2pass_equals_plain_on_grid_images(biased):
    """On 1/8-grid images lo is zero and every sum is exact in f32, so the
    2-pass product and the plain f32 conv give the same codes (what the
    card's equality check relies on); the prepared constants hold the
    per-call values."""
    rng = np.random.default_rng(4)
    x, w, scale, bias = _stem_inputs(rng, 64, 64)
    x = (np.round(x * 8) / 8).astype(np.float32)
    q = (0.02, 0.0, 255.0, 128.0) if biased else (0.1, 0.0, 15.0, 0.0)
    k = TS.prepare_stem(torch.as_tensor(w), torch.as_tensor(scale),
                        torch.as_tensor(bias), *q)
    np.testing.assert_array_equal(
        k.qp.numpy(), np.array([np.float32(1) / np.float32(q[0]), *q[1:]],
                               np.float32))
    xt = torch.as_tensor(x)
    before = TS.stem_fused.launches
    plain = TS.stem_fused_prepared(xt, k)
    assert TS.stem_fused.launches == before
    assert torch.equal(TS.stem_2pass_plain(xt, k), plain)
    assert torch.equal(plain, TS.stem_fused(xt, torch.as_tensor(w),
                                            torch.as_tensor(scale),
                                            torch.as_tensor(bias), *q))
