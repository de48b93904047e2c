"""PyTorch port vs the JAX package: quantizer math and BN folding.

Both packages get the same numpy inputs; the port runs on the CPU.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from shiftedscalequantization_tpu import fold_bn as jfb
from shiftedscalequantization_tpu.ops import quant as JQ
from shiftedscalequantization_tpu_torch import fold_bn as tfb
from shiftedscalequantization_tpu_torch.ops import quant as TQ
from shiftedscalequantization_tpu_torch.ops import wquant as TW


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("method", ["mse", "max"])
@pytest.mark.parametrize("n_bits", [2, 4, 8])
def test_weight_scale_init_matches_jax(method, n_bits):
    """Per-channel weight scale init. Both sides compute the same f32
    expressions; only reduction order differs, so delta and zero point
    agree to rtol 1e-6 (the MSE argmin lands on the same grid point)."""
    rng = np.random.default_rng(n_bits)
    w = (rng.normal(size=(16, 72)) * 0.2).astype(np.float32)
    qj, rzj = JQ.init_weight_qparams(jnp.asarray(w), n_bits=n_bits,
                                     sym=False, channel_wise=True,
                                     scale_method=method)
    qt, rzt = TQ.init_weight_qparams(_t(w), n_bits=n_bits, sym=False,
                                     channel_wise=True, scale_method=method)
    assert tuple(qt.delta.shape) == (16, 1)
    np.testing.assert_allclose(qt.delta.numpy(), np.asarray(qj.delta),
                               rtol=1e-6)
    np.testing.assert_allclose(qt.zero_point.numpy(),
                               np.asarray(qj.zero_point), rtol=1e-6)
    np.testing.assert_allclose(rzt.numpy(), np.asarray(rzj), rtol=1e-6)


@pytest.mark.parametrize("method", ["mse", "max"])
@pytest.mark.parametrize("n_bits,sym", [(4, False), (8, False), (4, True)])
def test_act_scale_init_matches_jax(method, n_bits, sym):
    """Per-tensor act scale init on a post-ReLU-like tensor: rtol 1e-6 (same
    f32 arithmetic, different reduction order)."""
    rng = np.random.default_rng(7)
    x = np.maximum(rng.normal(size=(4, 9, 9, 32)), 0).astype(np.float32) * 3
    qj = JQ.init_act_qparams(jnp.asarray(x), n_bits, sym=sym,
                             scale_method=method)
    qt = TQ.init_act_qparams(_t(x), n_bits, sym=sym, scale_method=method)
    assert qt.delta.ndim == 0 and qt.n_bits == n_bits and qt.sym == sym
    np.testing.assert_allclose(float(qt.delta), float(qj.delta), rtol=1e-6)
    np.testing.assert_allclose(float(qt.zero_point), float(qj.zero_point),
                               rtol=1e-6)


def test_fake_quant_and_int_codes_match_jax():
    """fake_quant, quantize_int and dequantize with per-channel params:
    division and half-to-even rounding as in JAX, atol 1e-6."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 50)).astype(np.float32)
    # include exact .5 ties: half-to-even must match jnp.round
    x[0, :10] = (np.arange(10) - 4.5) * 0.1
    delta = np.full((8, 1), 0.1, np.float32)
    delta[1:] = rng.uniform(0.05, 0.2, (7, 1))
    zp = rng.integers(0, 8, (8, 1)).astype(np.float32)
    qj = JQ.QParams(delta=jnp.asarray(delta), zero_point=jnp.asarray(zp),
                    n_bits=4, sym=False)
    qt = TQ.QParams(delta=_t(delta), zero_point=_t(zp), n_bits=4, sym=False)
    np.testing.assert_allclose(TQ.fake_quant(_t(x), qt).numpy(),
                               np.asarray(JQ.fake_quant(jnp.asarray(x), qj)),
                               atol=1e-6)
    ci = TQ.quantize_int(_t(x), qt)
    np.testing.assert_array_equal(
        ci.numpy(), np.asarray(JQ.quantize_int(jnp.asarray(x), qj)))
    np.testing.assert_allclose(
        TQ.dequantize(ci, qt).numpy(),
        np.asarray(JQ.dequantize(jnp.asarray(ci.numpy()), qj)), atol=1e-6)


def test_round_ste_passes_gradient_straight_through():
    x = torch.tensor([0.2, 1.5, 2.5, -0.7], requires_grad=True)
    y = TQ.round_ste(x)
    np.testing.assert_array_equal(y.detach().numpy(), [0.0, 2.0, 2.0, -1.0])
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(4))


def test_uniform_weight_quant_matches_jax():
    """UniformWQ on OIHW conv weights with (OC, 1) params, atol 1e-6."""
    from shiftedscalequantization_tpu.ops import wquant as JW
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(8, 4, 3, 3)) * 0.3).astype(np.float32)
    qj, _ = JQ.init_weight_qparams(jnp.asarray(w.reshape(8, -1)), n_bits=2,
                                   sym=False, channel_wise=True)
    qt = TQ.QParams(delta=_t(qj.delta), zero_point=_t(qj.zero_point),
                    n_bits=2, sym=False)
    got = TW.apply_weight_quant(TW.UniformWQ(qp=qt), _t(w)).numpy()
    want = np.asarray(JW.apply_weight_quant(JW.UniformWQ(qp=qj),
                                            jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert TW.apply_weight_quant(None, _t(w)) is not None


@pytest.mark.parametrize("affine", [True, False])
def test_fold_bn_matches_jax(affine):
    """BN folding, rtol 1e-6: the same f32 expressions."""
    rng = np.random.default_rng(11)
    c = 6
    bn = {"mean": rng.normal(size=c), "var": rng.uniform(0.5, 2.0, c)}
    if affine:
        bn["gamma"] = rng.normal(size=c)
        bn["beta"] = rng.normal(size=c)
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    p = {"conv": {"w": rng.normal(size=(c, 3, 3, 3)).astype(np.float32),
                  "bn": bn},
         "fc": {"w": rng.normal(size=(c, 4)).astype(np.float32),
                "b": rng.normal(size=c).astype(np.float32)}}
    want = jfb.fold_bn({n: {k: (jnp.asarray(v) if not isinstance(v, dict)
                                else {kk: jnp.asarray(vv)
                                      for kk, vv in v.items()})
                            for k, v in u.items()} for n, u in p.items()})
    got = tfb.fold_bn({n: {k: (_t(v) if not isinstance(v, dict)
                               else {kk: _t(vv) for kk, vv in v.items()})
                           for k, v in u.items()} for n, u in p.items()})
    for n in p:
        for k in ("w", "b"):
            np.testing.assert_allclose(got[n][k].numpy(),
                                       np.asarray(want[n][k]), rtol=1e-6,
                                       atol=1e-7)
