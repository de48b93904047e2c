"""PyTorch port vs the JAX package: the fake-quant kernel's plain version
and autograd Function (``ops/cuda/fake_quant.py``), and the clip tie rule
(``ops/quant.clip``), on the CPU.

The plain version divides and rounds half to even, as
``ops/quant.fake_quant`` of the JAX package does: it is held to that
function bit for bit, and to the Pallas kernel ``fake_quant_2d`` in
interpret mode at the tolerances ``tests/test_pallas.py`` uses (the Pallas
kernel multiplies by 1/delta, so a code may differ by one step at a tie;
none does on these inputs). Gradients are held to ``jax.grad`` of
``ops/quant.fake_quant``: w.r.t. x bit for bit, w.r.t. delta and zp at
rtol/atol 1e-5 (sums in another order and another formula), with elements
placed exactly on the clip bounds.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from shiftedscalequantization_tpu import graph as JG
from shiftedscalequantization_tpu.ops import quant as JQ
from shiftedscalequantization_tpu.ops import wquant as JW
from shiftedscalequantization_tpu.ops.pallas import fake_quant as PFQ
from shiftedscalequantization_tpu_torch import graph as TG
from shiftedscalequantization_tpu_torch.ops import quant as TQ
from shiftedscalequantization_tpu_torch.ops import wquant as TW
from shiftedscalequantization_tpu_torch.ops.cuda import fake_quant as FQ

# the vector of the tie check: delta 0.5, zp 0, 4 bits; 7.5, 7.4, 7.6 land
# on code 15 (hi), 8.0 beyond it, 0.0, -0.1, 0.1 on code 0 (lo)
TIES = np.array([7.5, 7.4, 7.6, 8.0, 0.0, -0.1, 0.1, 3.3], np.float32)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _np(t):
    return t.detach().numpy()


def _weight_case(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(16, 8, 3, 3)).astype(np.float32)
    qp, _ = JQ.init_weight_qparams(jnp.asarray(w.reshape(16, -1)), 4, False,
                                   True)
    return w, np.asarray(qp.delta), np.asarray(qp.zero_point)


def test_plain_weight_matches_pallas_and_ops_quant():
    """Per-row (OC, IC*KH*KW): bit-exact against ops/quant.fake_quant,
    atol 1e-6 against the Pallas kernel (interpret mode)."""
    w, d, z = _weight_case()
    want = JQ.fake_quant(jnp.asarray(w), JQ.QParams(
        delta=jnp.asarray(d.reshape(16, 1, 1, 1)),
        zero_point=jnp.asarray(z.reshape(16, 1, 1, 1)), n_bits=4, sym=False))
    pallas = PFQ.fake_quant_weight(jnp.asarray(w), jnp.asarray(d),
                                   jnp.asarray(z), 4, False, interpret=True)
    got = _np(FQ.fake_quant_weight(_t(w), _t(d), _t(z), 4, False))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-6)
    # the port's UniformWQ is the same call
    uq = TW.UniformWQ(qp=TQ.QParams(_t(d), _t(z), 4, False))
    np.testing.assert_array_equal(_np(uq(_t(w))), got)


def test_plain_act_matches_pallas_and_ops_quant():
    """Per-tensor 8-bit act on NHWC: bit-exact against ops/quant.fake_quant,
    atol 1e-5 against the Pallas kernel, and the share of elements whose
    code differs from the Pallas kernel's (by exactly one step) is 0."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 8, 8, 16)).astype(np.float32)
    qp = JQ.init_act_qparams(jnp.asarray(x), 8, scale_method="max")
    want = np.asarray(JQ.fake_quant(jnp.asarray(x), qp))
    pallas = np.asarray(PFQ.fake_quant_act(jnp.asarray(x), qp.delta,
                                           qp.zero_point, 8, interpret=True))
    tq = TQ.QParams(_t(qp.delta), _t(qp.zero_point), 8, False)
    got = _np(TQ.fake_quant(_t(x), tq))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    steps = np.abs(got - pallas) / float(qp.delta)
    assert float((steps > 0.5).mean()) == 0.0


def test_plain_unaligned_per_row_and_half_even_ties():
    """A ragged (10, 130) with per-row delta/zp through fake_quant_2d, as
    the Pallas test; then exact .5 quotients round half to even."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(10, 130)).astype(np.float32)
    d = np.full((10, 1), 0.07, np.float32)
    z = np.full((10, 1), 8.0, np.float32)
    want = (np.clip(np.round(x / d) + z, 0, 15) - z) * d
    pallas = PFQ.fake_quant_2d(jnp.asarray(x), jnp.asarray(d), jnp.asarray(z),
                               0, 15, interpret=True)
    got = _np(FQ.fake_quant_2d(_t(x), _t(d), _t(z), 0, 15))
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-6)
    ties = (np.arange(12, dtype=np.float32) - 5.5) * 0.25      # x/d = k+.5
    got = _np(FQ.fake_quant_2d(_t(ties[None]), _t([[0.25]]), _t([[8.0]]),
                               0, 15))
    np.testing.assert_array_equal(got[0] / 0.25, np.round(ties / 0.25))


def test_cpu_takes_the_plain_version_without_counting():
    w, d, z = _weight_case()
    before = (FQ.fake_quant_2d.launches, FQ.fake_quant_weight.launches,
              FQ.fake_quant_act.launches)
    FQ.fake_quant_weight(_t(w), _t(d), _t(z), 2, False)
    FQ.fake_quant_act(_t(w), _t(d[0, 0]), _t(z[0, 0]), 4)
    FQ.fake_quant_2d(_t(w.reshape(16, -1)), _t(d), _t(z), 0, 3)
    assert (FQ.fake_quant_2d.launches, FQ.fake_quant_weight.launches,
            FQ.fake_quant_act.launches) == before


def test_wrappers_refuse_other_layouts():
    x = torch.zeros((6, 5))
    with pytest.raises(ValueError, match="4 values for 6 rows"):
        FQ.fake_quant_weight(x, torch.ones(4), torch.zeros(4), 4, False)
    with pytest.raises(ValueError, match="one value"):
        FQ.fake_quant_act(x, torch.ones(5), torch.zeros(5), 4)
    with pytest.raises(ValueError, match="4 values for 6 rows"):
        TQ.fake_quant(x, TQ.QParams(torch.ones(4, 1), torch.zeros(4, 1),
                                    4, False))


def _jax_grads(x, d, z, n_bits, sym, g):
    def f(x, d, z):
        out = JQ.fake_quant(x, JQ.QParams(delta=d, zero_point=z,
                                          n_bits=n_bits, sym=sym))
        return (out * g).sum()
    return [np.asarray(a) for a in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(d), jnp.asarray(z))]


def test_tie_vector_gradient_matches_jax():
    """The fault this port repairs: JAX passes 1/2 at the clip bounds."""
    d, z = np.float32(0.5), np.float32(0.0)
    want = _jax_grads(TIES, d, z, 4, False, np.ones_like(TIES))
    np.testing.assert_array_equal(want[0], [.5, .5, .5, 0, .5, .5, .5, 1])
    x, dt, zt = _t(TIES, True), _t(d, True), _t(z, True)
    TQ.fake_quant(x, TQ.QParams(dt, zt, 4, False)).sum().backward()
    np.testing.assert_array_equal(_np(x.grad), want[0])
    np.testing.assert_allclose(float(dt.grad), float(want[1]), **GRAD_TOL)
    np.testing.assert_allclose(float(zt.grad), float(want[2]), **GRAD_TOL)
    # the plain version's autograd gives the same (the reference for the
    # Function's backward on the card)
    x2, d2, z2 = _t(TIES, True), _t(d, True), _t(z, True)
    FQ.fake_quant_plain(x2, d2, z2, 0, 15).sum().backward()
    for a, b in ((x.grad, x2.grad), (dt.grad, d2.grad), (zt.grad, z2.grad)):
        np.testing.assert_allclose(_np(a), _np(b), **GRAD_TOL)


@pytest.mark.parametrize("kind", ["act", "weight", "weight_sym"])
def test_function_gradients_match_jax(kind):
    """grad x, delta, zp of the Function against jax.grad of
    ops/quant.fake_quant under a random cotangent, a quarter of the
    elements placed exactly on a clip bound or beyond."""
    rng = np.random.default_rng(7)
    sym = kind == "weight_sym"
    n_bits = 4 if kind == "act" else 2
    lo, hi = (-(2 ** n_bits) // 2, 2 ** n_bits // 2 - 1) if sym \
        else (0, 2 ** n_bits - 1)
    if kind == "act":
        x = rng.normal(size=(3, 5, 5, 8)).astype(np.float32)
        d = np.float32(0.2)
        z = np.float32(3.0)
        codes = rng.integers(lo - 2, hi + 3, size=x.shape)
        pin = rng.random(x.shape) < 0.25
        x = np.where(pin, (codes - z) * d, x).astype(np.float32)
        dz_shape = ()
    else:
        x = rng.normal(size=(6, 4, 3, 3)).astype(np.float32)
        d = rng.uniform(0.2, 0.6, size=(6, 1, 1, 1)).astype(np.float32)
        z = (np.zeros if sym else np.ones)((6, 1, 1, 1), np.float32)
        codes = rng.integers(lo - 2, hi + 3, size=x.shape)
        pin = rng.random(x.shape) < 0.25
        x = np.where(pin, (codes - z) * d, x).astype(np.float32)
        dz_shape = (6, 1)
    g = rng.normal(size=x.shape).astype(np.float32)
    want = _jax_grads(x, d, z, n_bits, sym, g)
    xt = _t(x, True)
    dt = _t(np.reshape(d, dz_shape) if kind != "act" else d, True)
    zt = _t(np.reshape(z, dz_shape) if kind != "act" else z, True)
    if kind == "act":
        out = FQ.fake_quant_act(xt, dt, zt, n_bits)
    else:
        out = FQ.fake_quant_weight(xt, dt, zt, n_bits, sym)
    (out * _t(g)).sum().backward()
    np.testing.assert_array_equal(_np(out), np.asarray(JQ.fake_quant(
        jnp.asarray(x), JQ.QParams(jnp.asarray(d), jnp.asarray(z), n_bits,
                                   sym))))
    np.testing.assert_array_equal(_np(xt.grad), want[0])
    np.testing.assert_allclose(_np(dt.grad).reshape(want[1].shape), want[1],
                               **GRAD_TOL)
    np.testing.assert_allclose(_np(zt.grad).reshape(want[2].shape), want[2],
                               **GRAD_TOL)
    m = _np(xt.grad) / g                                 # 1, 1/2 or 0
    assert bool((np.abs(m - 0.5) < 1e-6).any())          # ties were hit


def test_uniform_wq_gradient_matches_jax():
    """UniformWQ through the Function: d/dw and d/d delta as jax.grad of
    the JAX UniformWQ."""
    w, d, z = _weight_case(3)
    g = np.random.default_rng(4).normal(size=w.shape).astype(np.float32)

    def f(w, d):
        qp = JQ.QParams(delta=d, zero_point=jnp.asarray(z), n_bits=2,
                        sym=False)
        return (JW.UniformWQ(qp=qp)(w) * g).sum()
    jw, jd = jax.grad(f, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(d))
    wt, dt = _t(w, True), _t(d, True)
    out = TW.UniformWQ(qp=TQ.QParams(dt, _t(z), 2, False))(wt)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(wt.grad), np.asarray(jw), **GRAD_TOL)
    np.testing.assert_allclose(_np(dt.grad), np.asarray(jd), **GRAD_TOL)


def test_clip_tie_rule_matches_jax():
    """ops/quant.clip and the clamps that use it (relu6, the rectified
    sigmoid and softmax, the quantizer clips) differentiate as jnp.clip:
    1 inside, 1/2 at a bound, 0 outside; forward values are torch.clamp's."""
    x = np.array([-1.0, 0.0, 0.5, 1.0, 1.5, 6.0, 7.0, 3.0], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.clip(v, 0.0, 6.0).sum())(
        jnp.asarray(x)))
    np.testing.assert_array_equal(want, [0, .5, 1, 1, 1, .5, 0, 1])
    for fn in (lambda v: TQ.clip(v, 0.0, 6.0),
               lambda v: TG._activation("relu6", v)):
        xt = _t(x, True)
        y = fn(xt)
        y.sum().backward()
        np.testing.assert_array_equal(_np(xt.grad), want)
        np.testing.assert_array_equal(_np(y), np.clip(x, 0, 6))
    np.testing.assert_array_equal(
        np.asarray(jax.grad(lambda v: JG._activation("relu6", v).sum())(
            jnp.asarray(x))), want)
    # rectified sigmoid at logits whose relaxation hits 0 and 1 exactly
    a = np.array([np.log(1 / 11), -np.log(1 / 11), 0.3, -8.0, 8.0],
                 np.float32)
    jg = np.asarray(jax.grad(lambda v: JQ.rectified_sigmoid(v).sum())(
        jnp.asarray(a)))
    at = _t(a, True)
    TQ.rectified_sigmoid(at).sum().backward()
    np.testing.assert_allclose(_np(at.grad), jg, rtol=1e-6, atol=1e-7)
    p = np.array([[2.0, -1.0, 0.1], [9.0, -9.0, 0.0]], np.float32)
    jg = np.asarray(jax.grad(lambda v: (JQ.rectified_softmax(v) *
                                        jnp.arange(3.0)).sum())(
        jnp.asarray(p)))
    pt = _t(p, True)
    (TQ.rectified_softmax(pt) * torch.arange(3.0)).sum().backward()
    np.testing.assert_allclose(_np(pt.grad), jg, rtol=1e-5, atol=1e-6)


def test_adaround_clip_ties_match_jax():
    """AdaRound's soft forward with codes on and beyond the clip bounds:
    the gradient w.r.t. the rounding logits equals jax.grad's. (A code
    lands on a bound only where the rectified sigmoid saturates, whose own
    clip then gives 0 on both sides.)"""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    d = np.full((4, 1), 0.5, np.float32)
    z = np.full((4, 1), 1.0, np.float32)
    alpha = rng.normal(size=w.shape).astype(np.float32)
    # floor(w/d) + h + zp: 1 + 1 + 1 = 3 (hi), -1 + 0 + 1 = 0 (lo)
    w[:, :2] = np.array([0.75, -0.25], np.float32)[None]
    alpha[:, :2] = np.array([8.0, -8.0], np.float32)[None]

    def f(a):
        wq = JW.AdaRoundWQ(qp=JQ.QParams(jnp.asarray(d), jnp.asarray(z), 2,
                                         False), alpha=a)
        return wq(jnp.asarray(w)).sum()
    want = np.asarray(jax.grad(f)(jnp.asarray(alpha)))
    at = _t(alpha, True)
    TW.AdaRoundWQ(qp=TQ.QParams(_t(d), _t(z), 2, False), alpha=at)(
        _t(w)).sum().backward()
    np.testing.assert_allclose(_np(at.grad), want, rtol=1e-5, atol=1e-7)
