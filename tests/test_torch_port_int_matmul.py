"""PyTorch port vs the JAX package: the int8 GEMM kernel module
(``ops/cuda/int_matmul.py``), run on the CPU through its plain versions.

``quant_matmul`` / ``quant_conv1x1`` are held to the Pallas kernel
(``ops/pallas/int_matmul.py``) in interpret mode: the codes and the int32
sums are exact on both sides; inside jit XLA on the CPU contracts the
epilogue's multiply-add into an FMA, which the port rounds in two steps,
so the f32 outputs may differ by an ulp (rtol 1e-6, atol 1e-6).
``int8_conv`` is held to ``jax.lax.conv_general_dilated`` with int32
accumulation, bit for bit, and its scale-table sum to the JAX deploy
path's expression evaluated op by op (no contraction), bit for bit.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from shiftedscalequantization_tpu.ops.pallas import int_matmul as JIM
from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul as TIM


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("m,k,n,relu,bits,zp", [
    (64, 32, 48, False, 4, 7.0), (37, 16, 24, True, 4, 0.0),
    (130, 72, 10, False, 4, 3.0), (9, 130, 20, True, 8, 128.0)])
def test_quant_matmul_matches_pallas(m, k, n, relu, bits, zp):
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.integers(-2, 2, size=(k, n)).astype(np.int8)
    scale = (rng.random(n) * 0.1 + 0.01).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    want = np.asarray(JIM.quant_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias), 0.05, zp, bits, relu=relu, interpret=True))
    before = TIM.quant_matmul.launches
    got = TIM.quant_matmul(_t(x), _t(w), _t(scale), _t(bias),
                           torch.tensor(0.05), torch.tensor(zp), bits, relu)
    assert TIM.quant_matmul.launches == before    # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if relu:
        assert float(got.min()) >= 0.0


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
def test_quant_conv1x1_matches_pallas(stride):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 9, 16)).astype(np.float32)
    w = rng.integers(-2, 2, size=(24, 16)).astype(np.int8)
    scale = (rng.random(24) * 0.1).astype(np.float32)
    bias = rng.normal(size=24).astype(np.float32)
    want = np.asarray(JIM.quant_conv1x1(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias), 0.1, 8.0, 4, stride=stride, relu=True,
        interpret=True))
    got = TIM.quant_conv1x1(_t(x), _t(w), _t(scale), _t(bias), 0.1, 8.0, 4,
                            stride=stride, relu=True)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _jax_conv(xc, w_oihw, stride, padding):
    """int32 conv of centered codes, zero padding (JAX deploy._int_conv
    with int32 operands so biased feeds fit)."""
    pad = ((padding[0], padding[0]), (padding[1], padding[1]))
    return jax.lax.conv_general_dilated(
        jnp.asarray(xc, jnp.int32),
        jnp.transpose(jnp.asarray(w_oihw, jnp.int32), (2, 3, 1, 0)),
        window_strides=stride, padding=pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)


def _w_mat(w_soihw):
    """(S, O, I, KH, KW) -> (S, O, KH*KW*I), the port's operand order."""
    s, o = w_soihw.shape[:2]
    return np.ascontiguousarray(
        np.transpose(w_soihw, (0, 1, 3, 4, 2)).reshape(s, o, -1))


@pytest.mark.parametrize("b,h,w,c,n,kern,stride,pad,s,offset", [
    (2, 8, 8, 16, 24, 3, 1, 1, 1, 0),
    (1, 4, 4, 64, 32, 3, 1, 1, 1, 0),          # M = 16 (batch 1, layer4)
    (3, 9, 7, 5, 10, 3, 2, 1, 2, 128),         # ragged, biased feed
    (2, 6, 6, 12, 8, 1, 2, 0, 2, 0),           # strided 1x1 downsample
    (1, 11, 11, 3, 16, 7, 2, 3, 3, 9)])        # 7x7 stem geometry
def test_int8_conv_matches_jax_conv(b, h, w, c, n, kern, stride, pad, s,
                                    offset):
    """int32 sums bit for bit against XLA's integer conv of the centered
    codes ``xi + offset`` (padding -offset, offset * sum(w) added back);
    the f32 scale-table sum bit for bit against the JAX deploy
    expression ``0 + sum_s f32(acc_s) * (table[s] * delta)``."""
    rng = np.random.default_rng(b * 100 + c)
    # 4-bit centered codes, or biased codes over the whole int8 range
    span = 128 if offset else 8
    xi = rng.integers(-span, span, size=(b, h, w, c)).astype(np.int8)
    ws = rng.integers(-2, 2, size=(s, n, c, kern, kern)).astype(np.int8)
    wm = torch.as_tensor(_w_mat(ws))
    acc_off = (offset * wm.sum(dim=2, dtype=torch.int32)) if offset else None
    geom = ((kern, kern), (stride, stride), (pad, pad))
    xc = xi.astype(np.int32) + offset
    accs = [np.asarray(_jax_conv(xc, ws[g], geom[1], geom[2]))
            for g in range(s)]
    if s == 1:
        got = TIM.int8_conv(torch.as_tensor(xi), wm, *geom,
                            pad_value=-offset, acc_offset=acc_off)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), accs[0])
    table = (rng.random((s, n)) * 0.02 + 1e-3).astype(np.float32)
    delta = np.float32(0.37)
    want = jnp.float32(0.0)
    for g in range(s):
        want = want + jnp.asarray(accs[g]).astype(jnp.float32) \
            * (jnp.asarray(table[g]) * delta)
    before = TIM.int8_conv.launches
    got = TIM.int8_conv(torch.as_tensor(xi), wm, *geom, pad_value=-offset,
                        group_scales=torch.as_tensor(table),
                        act_delta=torch.tensor(delta), acc_offset=acc_off)
    assert TIM.int8_conv.launches == before
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_im2col_order_and_padding():
    """Patches in (kh, kw, c) order, padded with the given code."""
    x = torch.arange(2 * 3 * 3 * 2, dtype=torch.int8).reshape(2, 3, 3, 2)
    cols, (b, ho, wo) = TIM.im2col(x, (3, 3), (1, 1), (1, 1), -5)
    assert (b, ho, wo) == (2, 3, 3) and tuple(cols.shape) == (18, 18)
    # centre pixel of image 0: its 3x3 neighbourhood, channels innermost
    np.testing.assert_array_equal(cols[4].numpy(),
                                  x[0].reshape(-1).numpy())
    # corner pixel: the first row and column of taps are padding
    assert (cols[0].reshape(3, 3, 2)[0] == -5).all()
    assert (cols[0].reshape(3, 3, 2)[:, 0] == -5).all()
