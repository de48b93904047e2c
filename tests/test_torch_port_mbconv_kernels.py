"""PyTorch port vs the JAX package: the depthwise and inverted-residual
kernel modules, through their plain PyTorch versions (what the wrappers
run on CPU tensors) against the Pallas kernels in interpret mode.

Both are bit-exact: the sums are exact integer arithmetic on both sides,
and each f32 epilogue is one multiply and one add. XLA on the CPU may
contract that pair into a fused multiply-add where the port rounds twice
(as the TPU's vector unit does); the two differ only where a result lies
within one f32 ulp of a rounding boundary, which none of these inputs
reaches.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from shiftedscalequantization_tpu.ops.pallas.depthwise import \
    dw_conv3x3_int8 as j_dw
from shiftedscalequantization_tpu.ops.pallas.mbconv import \
    mbconv_fused as j_mbconv
from shiftedscalequantization_tpu_torch.ops.cuda import depthwise as TDW
from shiftedscalequantization_tpu_torch.ops.cuda import mbconv as TMB


@pytest.mark.parametrize("h,w,c,stride,act", [
    (8, 8, 32, 1, "relu6"), (9, 7, 30, 2, "relu"), (16, 16, 24, 2, "none"),
    (7, 7, 96, 1, "relu6"), (12, 10, 13, 1, "relu"), (5, 6, 7, 2, "relu6")])
def test_dw_plain_matches_pallas(h, w, c, stride, act):
    """Codes on a 4-bit grid (zp 7, qmax 15) from 4-bit inputs and W2
    codes; odd sizes, stride 2 over odd H and W, and C not a multiple of
    4. Bit-exact, and no launch on CPU tensors."""
    rng = np.random.default_rng(h * 100 + c)
    x = rng.integers(-8, 8, (2, h, w, c)).astype(np.int8)
    wc = rng.integers(-2, 2, (c, 3, 3)).astype(np.int8)
    scalef = rng.uniform(0.001, 0.05, c).astype(np.float32)
    biasf = (rng.normal(size=c) * 0.5).astype(np.float32)
    delta, zp, qmax = np.float32(0.07), 7.0, 15.0
    want = np.asarray(j_dw(jnp.asarray(x), jnp.asarray(wc),
                           jnp.asarray(scalef), jnp.asarray(biasf), delta,
                           zp, qmax, stride=stride, act=act, interpret=True))
    before = TDW.dw_conv3x3_int8.launches
    got = TDW.dw_conv3x3_int8(torch.as_tensor(x), torch.as_tensor(wc),
                              torch.as_tensor(scalef), torch.as_tensor(biasf),
                              float(delta), zp, qmax, stride=stride, act=act)
    assert TDW.dw_conv3x3_int8.launches == before
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_dw_plain_rounds_half_to_even():
    """The kernel's requant rounds half to even (jnp.round), unlike the
    deploy requant's floor(x + 0.5): 0.5 -> 0, 1.5 -> 2, 2.5 -> 2."""
    x = torch.tensor([1, 3, 5], dtype=torch.int8).reshape(1, 1, 3, 1)
    w = torch.zeros((1, 3, 3), dtype=torch.int8)
    w[0, 1, 1] = 1
    got = TDW.dw_conv3x3_int8(x, w, torch.tensor([0.5]), torch.tensor([0.0]),
                              1.0, 0.0, 15.0, act="none")
    assert got.reshape(-1).tolist() == [0, 2, 2]


def test_dw_wrapper_rejects_bad_options():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((8, 3, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="act"):
        TDW.dw_conv3x3_int8(x, w, torch.ones(8), torch.zeros(8), 1.0, 0.0,
                            15.0, act="gelu")
    with pytest.raises(ValueError, match="stride"):
        TDW.dw_conv3x3_int8(x, w, torch.ones(8), torch.zeros(8), 1.0, 0.0,
                            15.0, stride=3)


def _mbconv_inputs(rng, ci, ce, co):
    we = rng.integers(-2, 2, (ci, ce)).astype(np.float32)
    wd = rng.integers(-2, 2, (9, ce)).astype(np.float32)
    wp = rng.integers(-2, 2, (ce, co)).astype(np.float32)
    ae = np.stack([rng.uniform(0.05, 0.3, ce),
                   rng.normal(size=ce) + 0.5]).astype(np.float32)
    ad = np.stack([rng.uniform(0.05, 0.3, ce),
                   rng.normal(size=ce) + 0.5]).astype(np.float32)
    ap = np.stack([rng.uniform(0.01, 0.1, co),
                   rng.normal(size=co) + 0.5]).astype(np.float32)
    return we, ae, wd, ad, wp, ap


@pytest.mark.parametrize("h,w,ci,ce,co,expand,residual", [
    (8, 8, 16, 96, 16, True, True), (6, 5, 24, 144, 32, True, False),
    (8, 8, 32, 32, 16, False, False), (7, 7, 16, 16, 16, False, True),
    (4, 4, 20, 120, 20, True, True)],
    ids=["expand+res", "expand", "dw-only", "dw+res", "small-7x7-like"])
def test_mbconv_plain_matches_pallas(h, w, ci, ce, co, expand, residual):
    """Bit-exact against mbconv_fused(interpret=True) with and without the
    expand and the residual; 4-bit block grid [-8, 7], 4-bit stage clips,
    W2 codes. Both the wrapper (on CPU tensors, the kernel's order on
    prepared constants) and the plain version every card check is held
    to."""
    rng = np.random.default_rng(h * 1000 + ce)
    x = rng.integers(-8, 8, (2, h, w, ci)).astype(np.int8)
    we, ae, wd, ad, wp, ap = _mbconv_inputs(rng, ci, ce, co)
    qp = np.array([[15, 15, 0.7, -8, 7, 0]], np.float32)
    want = np.asarray(j_mbconv(
        jnp.asarray(x), jnp.asarray(we, jnp.bfloat16), jnp.asarray(ae),
        jnp.asarray(wd), jnp.asarray(ad), jnp.asarray(wp, jnp.bfloat16),
        jnp.asarray(ap), jnp.asarray(qp), has_expand=expand,
        has_residual=residual, interpret=True))
    before = TMB.mbconv_fused.launches
    got = TMB.mbconv_fused(
        *(torch.as_tensor(a) for a in (x, we, ae, wd, ad, wp, ap, qp)),
        has_expand=expand, has_residual=residual)
    assert TMB.mbconv_fused.launches == before
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    plain = TMB.mbconv_fused_plain(
        *(torch.as_tensor(a) for a in (x, we, ae, wd, ad, wp, ap, qp)),
        has_expand=expand, has_residual=residual)
    np.testing.assert_array_equal(plain.numpy(), want)


def test_mbconv_wrapper_checks_channels():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    we, ae, wd, ad, wp, ap = (torch.as_tensor(a) for a in _mbconv_inputs(
        np.random.default_rng(0), 8, 16, 8))
    qp = torch.zeros(6)
    with pytest.raises(ValueError, match="CE must equal CI"):
        TMB.mbconv_fused(x, we, ae, wd, ad, wp, ap, qp, has_expand=False)
    wp12 = torch.zeros((16, 12))
    ap12 = torch.zeros((2, 12))
    with pytest.raises(ValueError, match="residual"):
        TMB.mbconv_fused(x, we, ae, wd, ad, wp12, ap12, qp)
