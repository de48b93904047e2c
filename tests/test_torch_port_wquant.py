"""PyTorch port vs the JAX package: the method's quantizer math
(``ops/quant.py`` relaxations, ``ops/wquant.py``) and the reconstruction
engine's quantizer plumbing (``recon/engine.py``), run on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Integer codes and hard forwards must match bit for bit; the soft
relaxations go through exp/log, whose last bits differ between XLA and
PyTorch, and are held to rtol/atol 1e-5. Where a selection or rounding
decision sits on such a near-tie, the state is made by the JAX package and
carried across (``utils/jax_import``), and the port's own init is compared
at a stated flip rate.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu.graph import BlockSpec as JBlock, \
    OpSpec as JOp, UnitSpec as JUnit
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.ops import quant as JQ
from shiftedscalequantization_tpu.ops import wquant as JW
from shiftedscalequantization_tpu.recon import engine as JE
from shiftedscalequantization_tpu_torch.ops import quant as TQ
from shiftedscalequantization_tpu_torch.ops import wquant as TW
from shiftedscalequantization_tpu_torch.recon import engine as TE
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

STS = (0.25, 0.5, 1.0)
NEAR1 = (1 - 1 / 32, 1 + 1 / 32, 1.0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _weight(kind, seed=0):
    """Conv (8, 12, 3, 3) or linear (10, 24) weight whose input-channel
    thirds span a 4x scale range, the regime shifted scales exist for."""
    rng = np.random.RandomState(seed)
    shape = (8, 12, 3, 3) if kind == "conv" else (10, 24)
    w = rng.randn(*shape).astype(np.float32)
    s = np.ones(shape[1], np.float32)
    s[: shape[1] // 3] = 0.25
    s[shape[1] // 3: 2 * (shape[1] // 3)] = 0.5
    return w * s.reshape((1, -1) + (1,) * (len(shape) - 2))


def _qps(w, n_bits=2, sym=False):
    """The same per-channel max-scale QParams in both packages."""
    jqp, _ = JQ.init_weight_qparams(jnp.asarray(w.reshape(w.shape[0], -1)),
                                    n_bits, sym=sym, channel_wise=True,
                                    scale_method="max")
    return jqp, JI.qparams_from_numpy(jax.tree.map(np.asarray, jqp), "cpu")


def _carry(jwq):
    return JI.weight_quantizer_from_numpy(jax.tree.map(np.asarray, jwq),
                                          "cpu")


def test_relaxations_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 5)).astype(np.float32) * 3
    rest = rng.uniform(0.01, 0.99, size=(6, 5)).astype(np.float32)
    p = rng.dirichlet(np.ones(3), size=7).astype(np.float32)
    pairs = [
        (JQ.rectified_sigmoid(a), TQ.rectified_sigmoid(_t(a))),
        (JQ.inverse_rectified_sigmoid(rest),
         TQ.inverse_rectified_sigmoid(_t(rest))),
        (JQ.rectified_softmax(a, axis=-1), TQ.rectified_softmax(_t(a))),
        (JQ.inverse_rectified_softmax(p), TQ.inverse_rectified_softmax(_t(p))),
        (JQ.round_regularizer(rest, 4.0),
         TQ.round_regularizer(_t(rest), 4.0)),
        (JQ.floor_ste(a), TQ.floor_ste(_t(a))),
        (JQ.lp_loss(a, rest), TQ.lp_loss(_t(a), _t(rest))),
        (JQ.lp_loss(a, rest, p=2.4, reduction="all"),
         TQ.lp_loss(_t(a), _t(rest), p=2.4, reduction="all")),
        (JQ.lp_loss(a, rest, channel_axis=0),
         TQ.lp_loss(_t(a), _t(rest), channel_axis=0)),
    ]
    for t in (0, 100, 200, 600, 999, 1000):
        pairs.append((JQ.linear_temp_decay(t, 1000),
                      TQ.linear_temp_decay(t, 1000)))
    pairs.append((JQ.linear_temp_decay(7, 10, 0.5, 10.0, 1.0),
                  TQ.linear_temp_decay(7, 10, 0.5, 10.0, 1.0)))
    for want, got in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert float(TQ.linear_temp_decay(0, 1000)) == 20.0
    assert float(TQ.linear_temp_decay(1000, 1000)) == 2.0


def test_straight_through_gradients():
    x = torch.tensor([0.2, 1.7, -2.5], requires_grad=True)
    TQ.floor_ste(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(3))
    np.testing.assert_array_equal(TQ.floor_ste(x).detach().numpy(),
                                  [0.0, 1.0, -3.0])


@pytest.mark.parametrize("kind", ["conv", "linear"])
@pytest.mark.parametrize("sym,signed", [(False, False), (True, True),
                                        (True, False)])
def test_adaround_matches_jax(kind, sym, signed):
    """init_adaround's logits within 1e-5; soft forward within 1e-5; the
    hard forward of the same (JAX-made) logits bit for bit."""
    w = _weight(kind)
    jqp, tqp = _qps(w, 4, sym)
    jwq = dataclasses.replace(JW.init_adaround(jqp, jnp.asarray(w)),
                              signed_clamp=signed)
    twq = dataclasses.replace(TW.init_adaround(tqp, _t(w)),
                              signed_clamp=signed)
    np.testing.assert_allclose(twq.alpha.numpy(), np.asarray(jwq.alpha),
                               **TOL)
    np.testing.assert_allclose(_np(twq(_t(w))), np.asarray(jwq(w)), **TOL)
    jhard = dataclasses.replace(jwq, soft=False)
    thard = _carry(jhard)
    assert not thard.soft and thard.signed_clamp == signed
    np.testing.assert_array_equal(_np(thard(_t(w))), np.asarray(jhard(w)))


@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_baked_adaround_matches_jax(kind):
    """AdaRoundWQ on baked shifts (st_index per input channel for a conv,
    per pair for a linear layer): the same effective grid, bit for bit."""
    w = _weight(kind, seed=1)
    jqp, _ = _qps(w, 2, True)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 3, size=w.shape[1:2] if kind == "conv"
                       else w.shape)
    alpha = rng.normal(size=w.shape).astype(np.float32)
    jwq = JW.AdaRoundWQ(qp=jqp, alpha=jnp.asarray(alpha), soft=False,
                        signed_clamp=True, st_index=jnp.asarray(idx),
                        shift_targets=STS)
    twq = _carry(jwq)
    assert twq.shift_targets == STS and twq.st_index.dtype == torch.int64
    np.testing.assert_array_equal(_np(twq._delta(_t(w))),
                                  np.asarray(jwq._delta(jnp.asarray(w))))
    np.testing.assert_array_equal(_np(twq(_t(w))), np.asarray(jwq(w)))


@pytest.mark.parametrize("kind", ["conv", "linear"])
@pytest.mark.parametrize("dequant,sts", [("effective", STS),
                                         ("effective", (0.5, 1.0)),
                                         ("unit", NEAR1)])
def test_shifted_scale_init_matches_jax(kind, dequant, sts):
    """Floor codes bit for bit; the MSE-argmin selection agrees on every
    group here (a float32 near-tie could flip one: the rate allowed is
    2%); selection and rounding logits within 1e-5 where it agrees."""
    w = _weight(kind, seed=3)
    jqp, tqp = _qps(w)
    jwq = JW.init_shifted_scale(jqp, jnp.asarray(w), sts, dequant=dequant)
    twq = TW.init_shifted_scale(tqp, _t(w), sts, dequant=dequant)
    assert (twq.shift_targets, twq.dequant, twq.codes) == \
        (tuple(sts), dequant, True)
    np.testing.assert_array_equal(twq.x_q.numpy(), np.asarray(jwq.x_q))
    jsel = np.asarray(jnp.argmax(jwq.alpha, -1))
    tsel = twq.alpha.argmax(-1).numpy()
    assert (jsel == tsel).mean() >= 0.98
    agree = jsel == tsel
    np.testing.assert_allclose(twq.alpha.numpy()[agree],
                               np.asarray(jwq.alpha)[agree], **TOL)
    if agree.all():
        np.testing.assert_allclose(twq.beta.numpy(), np.asarray(jwq.beta),
                                   **TOL)


@pytest.mark.parametrize("kind", ["conv", "linear"])
@pytest.mark.parametrize("dequant,sts", [("effective", STS),
                                         ("unit", NEAR1)])
def test_shifted_scale_forwards_match_jax(kind, dequant, sts):
    """On JAX-made state with perturbed logits: soft forward and soft
    mixture within 1e-5; hard forward, effective delta and the hard
    mixture bit for bit; the baked form of an effective quantizer equals
    its hard forward in both packages."""
    w = _weight(kind, seed=4)
    jqp, _ = _qps(w)
    jwq = JW.init_shifted_scale(jqp, jnp.asarray(w), sts, dequant=dequant)
    rng = np.random.default_rng(5)
    jwq = dataclasses.replace(
        jwq, alpha=jwq.alpha + rng.normal(size=jwq.alpha.shape),
        beta=jwq.beta + rng.normal(size=jwq.beta.shape))
    twq = _carry(jwq)
    tw = _t(w)
    np.testing.assert_allclose(_np(twq(tw)), np.asarray(jwq(w)), **TOL)
    np.testing.assert_allclose(_np(twq.mix_codes()),
                               np.asarray(jwq.mix_codes()), **TOL)
    np.testing.assert_allclose(_np(twq.soft_targets()),
                               np.asarray(jwq.soft_targets()), **TOL)
    np.testing.assert_array_equal(_np(twq.effective_delta(tw)),
                                  np.asarray(jwq.effective_delta(w)))
    jhard = dataclasses.replace(jwq, hard_targets=True, hard_round=True)
    thard = _carry(jhard)
    np.testing.assert_array_equal(_np(thard(tw)), np.asarray(jhard(w)))
    np.testing.assert_array_equal(_np(thard.mix_codes()),
                                  np.asarray(jhard.mix_codes()))
    if dequant == "effective":
        tb = TW.shifted_to_baked(twq)
        assert tb.st_index is not None and not tb.soft and tb.signed_clamp
        np.testing.assert_array_equal(_np(tb(tw)), _np(thard(tw)))
        np.testing.assert_array_equal(
            _np(tb(tw)), np.asarray(JW.shifted_to_baked(jwq)(w)))


@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_twophase_warmstart_and_bake_match_jax(kind):
    """Two-phase candidates and their soft/hard mixtures; warmstart_alpha
    and bake_shift_to_adaround on the same solved logits."""
    w = _weight(kind, seed=6)
    jqp, tqp = _qps(w, 4)
    jwq = JW.init_shifted_scale_twophase(jqp, jnp.asarray(w), STS)
    twq = TW.init_shifted_scale_twophase(tqp, _t(w), STS)
    assert not twq.codes and twq.beta is None
    np.testing.assert_array_equal(twq.x_q.numpy(), np.asarray(jwq.x_q))
    np.testing.assert_allclose(twq.alpha.numpy(), np.asarray(jwq.alpha),
                               **TOL)
    np.testing.assert_allclose(_np(twq(_t(w))), np.asarray(jwq(w)), **TOL)
    solved = np.random.default_rng(7).normal(
        size=jwq.alpha.shape).astype(np.float32)
    jb = JW.bake_shift_to_adaround(
        dataclasses.replace(jwq, alpha=jnp.asarray(solved)), jnp.asarray(w))
    tb = TW.bake_shift_to_adaround(
        dataclasses.replace(twq, alpha=_t(solved)), _t(w))
    np.testing.assert_array_equal(tb.st_index.numpy(),
                                  np.asarray(jb.st_index))
    np.testing.assert_allclose(tb.alpha.numpy(), np.asarray(jb.alpha),
                               **TOL)
    jf = JW.init_shifted_scale(jqp, jnp.asarray(w), STS,
                               dequant="effective")
    tf = _carry(jf)
    jws = JW.warmstart_alpha(jf, jnp.asarray(solved), jnp.asarray(w))
    tws = TW.warmstart_alpha(tf, _t(solved), _t(w))
    np.testing.assert_allclose(tws.beta.numpy(), np.asarray(jws.beta),
                               **TOL)


@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_rank_candidates_and_inp_scale_match_jax(kind):
    w = _weight(kind, seed=8)
    jqp, tqp = _qps(w, 4)
    assert TW.rank_shift_candidates(tqp, _t(w)) == \
        JW.rank_shift_candidates(jqp, jnp.asarray(w))
    raw = np.abs(np.random.default_rng(9).normal(
        size=(w.shape[0], 1))).astype(np.float32) * 0.3
    jis = JW.init_inp_scale(jqp, jnp.asarray(raw), jnp.asarray(w), level=4)
    tis = TW.init_inp_scale(tqp, _t(raw), _t(w), level=4)
    np.testing.assert_array_equal(tis.inp_scale.numpy(),
                                  np.asarray(jis.inp_scale))
    if kind == "conv":         # the rule shrinks some conv positions
        assert len(np.unique(tis.inp_scale.numpy())) > 1
    np.testing.assert_allclose(_np(tis(_t(w))), np.asarray(jis(w)), **TOL)
    np.testing.assert_allclose(_np(_carry(jis)(_t(w))), np.asarray(jis(w)),
                               **TOL)


def test_soft_gradients_reach_alpha_and_beta():
    w = _t(_weight("conv", seed=10))
    _, tqp = _qps(w.numpy())
    wq = TW.init_shifted_scale(tqp, w, STS, dequant="effective")
    alpha = wq.alpha.clone().requires_grad_()
    beta = wq.beta.clone().requires_grad_()
    q = dataclasses.replace(wq, alpha=alpha, beta=beta)
    ((q(w) - w) ** 2).sum().backward()
    assert float(alpha.grad.abs().max()) > 0
    assert float(beta.grad.abs().max()) > 0


def _tiny_graph(spec):
    """stem conv -> residual block with a strided downsample -> gap -> fc,
    in either package's node classes."""
    unit, block, op = spec

    def conv(name, cin, cout, k=3, s=1, act="relu"):
        return unit(name=name, kind="conv", in_ch=cin, out_ch=cout,
                    kernel=(k, k), stride=(s, s), padding=(k // 2, k // 2),
                    activation=act, has_bn=True)

    return (conv("stem", 3, 8),
            block(name="blk", units=(conv("blk.a", 8, 16, s=2),
                                     conv("blk.b", 16, 16, act=None)),
                  downsample=conv("blk.ds", 8, 16, k=1, s=2, act=None),
                  post_activation="relu"),
            op("gap", "gap"),
            unit(name="fc", kind="linear", in_ch=16, out_ch=10))


@pytest.fixture(scope="module")
def tiny():
    from shiftedscalequantization_tpu_torch.graph import BlockSpec, OpSpec, \
        UnitSpec
    g = _tiny_graph((JUnit, JBlock, JOp))
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          a_scale_method="max")
    params, qs = ssq.prepare_model(g, raw, cfg)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(g=g, gt=_tiny_graph((UnitSpec, BlockSpec, OpSpec)),
                params=params, qs=qs,
                tparams=JI.params_from_numpy(to_np(params), "cpu"),
                tqs=JI.qstate_from_numpy(to_np(qs), "cpu"),
                names=["stem", "blk.a", "blk.b", "blk.ds", "fc"])


def _assert_wq_equal(twq, jwq, exact=False):
    assert type(twq).__name__ == type(jwq).__name__
    for f in dataclasses.fields(jwq):
        jv, tv = getattr(jwq, f.name), getattr(twq, f.name)
        if f.name == "qp":
            np.testing.assert_array_equal(tv.delta.numpy(),
                                          np.asarray(jv.delta))
        elif jv is None or isinstance(jv, (bool, str, tuple)):
            assert tv == jv or (tv is None and jv is None), f.name
        elif exact:
            np.testing.assert_array_equal(_np(tv), np.asarray(jv))
        else:
            np.testing.assert_allclose(_np(tv), np.asarray(jv), **TOL,
                                       err_msg=f.name)


@pytest.mark.parametrize("settings", [
    dict(mode="fused", shift_targets=(0.5, 1.0)),
    dict(mode="fused"),
    dict(mode="fused", shift_targets=(0.5, 1.0), opt_beta=False,
         opt_output_affine=True),
    dict(mode="brecq"),
    dict(mode="shift", shift_targets=STS)],
    ids=["fused-effective", "fused-unit", "fused-noBeta-affine", "brecq",
         "shift"])
def test_init_quantizers_and_harden_match_jax(tiny, settings):
    """Per unit: the same quantizer type and static fields, the same theta
    keys, tensors within 1e-5 (the 8-bit stem and fc take plain AdaRound
    on coarse candidate sets); then _harden gives the same forms, and on
    the carried hardened state the same selection ratios."""
    js = JE.ReconSettings(**settings)
    ts = TE.ReconSettings(**settings)
    jq, jth = JE._init_quantizers(tiny["params"], tiny["qs"], tiny["names"],
                                  js)
    tq, tth = TE._init_quantizers(tiny["tparams"], tiny["tqs"],
                                  tiny["names"], ts)
    for name in tiny["names"]:
        _assert_wq_equal(tq[name].wq, jq[name].wq)
        assert sorted(tth[name]) == sorted(jth[name]), name
    if settings.get("shift_targets") == (0.5, 1.0):
        assert type(tq["stem"].wq).__name__ == "AdaRoundWQ"
        assert tq["blk.a"].wq.dequant == "effective"
    jh = JE._harden(jq, tiny["names"], settings["mode"])
    th = TE._harden(tq, tiny["names"], settings["mode"])
    carried = JI.qstate_from_numpy(jax.tree.map(np.asarray, jh), "cpu")
    for name in tiny["names"]:
        _assert_wq_equal(th[name].wq, jh[name].wq)
        _assert_wq_equal(carried[name].wq, jh[name].wq, exact=True)
    jr = JE.selection_ratios(jh, tiny["names"])
    tr = TE.selection_ratios(carried, tiny["names"])
    assert sorted(tr) == sorted(jr)
    for name in jr:
        np.testing.assert_allclose(tr[name].numpy(), np.asarray(jr[name]),
                                   rtol=1e-6)


def test_round_phases_and_theta_plumbing_match_jax(tiny):
    """'round' after a hardened 'shift' phase, then 'round_refine' on the
    baked result; theta re-inserted with new logits lands in the
    quantizers and output affine of both packages alike."""
    names = tiny["names"]
    s = dict(mode="shift", shift_targets=STS)
    jq, _ = JE._init_quantizers(tiny["params"], tiny["qs"], names,
                                JE.ReconSettings(**s))
    jq = JE._harden(jq, names, "shift")
    tq = JI.qstate_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    for mode in ("round", "round_refine"):
        jq, jth = JE._init_quantizers(tiny["params"], jq, names,
                                      JE.ReconSettings(mode=mode))
        tq, tth = TE._init_quantizers(tiny["tparams"], tq, names,
                                      TE.ReconSettings(mode=mode))
        for name in names:
            _assert_wq_equal(tq[name].wq, jq[name].wq)
            assert sorted(tth[name]) == sorted(jth[name]) == ["alpha"]
    rng = np.random.default_rng(11)
    new = {n: rng.normal(size=np.shape(jth[n]["alpha"])).astype(np.float32)
           for n in names}
    jq2 = JE._insert_theta(jq, {n: {"alpha": jnp.asarray(a)}
                                for n, a in new.items()})
    tq2 = TE._insert_theta(tq, {n: {"alpha": _t(a)} for n, a in new.items()})
    for name in names:
        _assert_wq_equal(tq2[name].wq, jq2[name].wq, exact=True)
    with pytest.raises(ValueError):
        TE._init_quantizers(tiny["tparams"], tq, names,
                            TE.ReconSettings(mode="nope"))


def test_resolve_dequant_and_skip_shift():
    for sts in (STS, (0.5, 1.0), NEAR1, (1.0,)):
        for mode in ("auto", "unit", "effective"):
            assert TE.resolve_dequant(mode, sts) == \
                JE.resolve_dequant(mode, sts)
    for n_bits in (2, 4, 8):
        qp = TQ.QParams(torch.ones(()), torch.zeros(()), n_bits, False)
        for sts in (STS, NEAR1):
            assert TE._skip_shift(qp, sts) == JE._skip_shift(qp, sts)
    assert {f.name for f in dataclasses.fields(TE.ReconSettings)} == \
        {f.name for f in dataclasses.fields(JE.ReconSettings)} - {"chunk"}
