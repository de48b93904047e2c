"""PyTorch port vs the JAX package: the reconstruction modes of the CLI's
brecq and two-phase pipelines (``recon/engine.py`` modes 'brecq' and
'round', ``recon/pipeline.py`` mode 'two_phase') and the act-delta phase
(``engine.reconstruct_act_delta``, ``act_phase="delta"``), on the CPU.

The tiny model and its state come from ``test_torch_port_recon.py``
(made by the JAX package and carried across). Caches hold N =
batch_size rows, so every step sees all rows and only summation orders
differ (the packages draw rows from different generators). Tolerances:
traces, losses and learned act deltas within rtol 1e-4 (f32 sums in two
orders over 20-40 Adam steps); hardened codes within a flip rate of 0.5%
(rounding ties); the act-delta gradient of one step within rtol 1e-4 of
``jax.grad``: the block site's gradient sums 8192 terms that mostly
cancel, and the JAX package's f32 sum lands 5e-5 of it from the float64
value, the port's 4e-7.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu import graph as JG
from shiftedscalequantization_tpu.recon import engine as JE
from shiftedscalequantization_tpu.recon import pipeline as JP
from shiftedscalequantization_tpu_torch import graph as TG
from shiftedscalequantization_tpu_torch.recon import engine as TE
from shiftedscalequantization_tpu_torch.recon import pipeline as TP
from shiftedscalequantization_tpu_torch.utils import jax_import as JI
from test_torch_port_recon import BLOCK, UNITS, _a, _caches, _flip_rate, \
    _np, _state

RTOL = 1e-4
FLIP_RATE = 0.005
GRAD_RTOL = 1e-4
N = 16


@pytest.fixture(scope="module")
def tiny():
    return _state()


@pytest.fixture(scope="module")
def calibrated(tiny):
    """The tiny state with every act site calibrated (weights on), in
    both packages, and the block's FP caches of N rows."""
    st = dict(tiny)
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          use_8bit_head_stem=False)
    st["qs"] = ssq.calibrate_acts(st["g"], st["params"], st["qs"],
                                  jnp.asarray(st["cali"][:32]), cfg,
                                  flags=JG.Flags().all_weights(st["g"]))
    st["tqs"] = JI.qstate_from_numpy(_np(st["qs"]), "cpu")
    st["ci"], st["co"] = _caches(st, BLOCK, N)
    return st


def _run_both(st, settings, qs=None, tqs=None):
    ci, co = _caches(st, BLOCK, N)
    jq, jm = JE.reconstruct_node(
        st["g"], st["params"], st["qs"] if qs is None else qs, BLOCK,
        jnp.asarray(ci), jnp.asarray(co), JE.ReconSettings(**settings),
        jax.random.PRNGKey(3))
    tq, tm = TE.reconstruct_node(
        st["gt"], st["tparams"], st["tqs"] if tqs is None else tqs, BLOCK,
        torch.tensor(ci), torch.tensor(co), TE.ReconSettings(**settings),
        seed=3)
    return jq, jm, tq, tm


def _check_adaround(jq, jm, tq, tm):
    np.testing.assert_allclose(_a(tm["rec_trace"]), np.asarray(jm["rec_trace"]),
                               rtol=RTOL)
    for k in ("soft_loss", "hard_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL)
    for u in UNITS:
        jw, tw = jq[u].wq, tq[u].wq
        assert type(tw).__name__ == type(jw).__name__ == "AdaRoundWQ"
        assert not tw.soft and not jw.soft
        assert _flip_rate(_a(tw.alpha) >= 0, np.asarray(jw.alpha) >= 0) \
            <= FLIP_RATE
        if jw.st_index is None:
            assert tw.st_index is None
        else:
            np.testing.assert_array_equal(_a(tw.st_index),
                                          np.asarray(jw.st_index))


def test_brecq_trajectory_matches_jax(tiny):
    """AdaRound on the block: trace, soft and hard loss, hardened
    rounding."""
    _check_adaround(*_run_both(tiny, dict(mode="brecq", iters=40,
                                          batch_size=N, weight=0.01)))


def test_round_after_shift_matches_jax(tiny):
    """Two-phase's round phase, from the same hardened shift-phase state
    (made by the JAX package): the selection baked into st_index, then
    AdaRound on the per-(oc, ic) steps."""
    ci, co = _caches(tiny, BLOCK, N)
    s1 = JE.ReconSettings(mode="shift", iters=20, batch_size=N,
                          shift_targets=(0.5, 1.0))
    qs1, _ = JE.reconstruct_node(tiny["g"], tiny["params"], tiny["qs"], BLOCK,
                                 jnp.asarray(ci), jnp.asarray(co), s1,
                                 jax.random.PRNGKey(1))
    assert all(type(qs1[u].wq).__name__ == "ShiftedScaleWQ"
               and not qs1[u].wq.codes for u in UNITS)
    _check_adaround(*_run_both(
        tiny, dict(mode="round", iters=40, batch_size=N,
                   shift_targets=(0.5, 1.0)),
        qs=qs1, tqs=JI.qstate_from_numpy(_np(qs1), "cpu")))


def test_two_phase_pipeline_matches_jax(tiny):
    """mode='two_phase' through both pipelines (cache N = batch_size):
    each target runs shift then round at twice the steps; the shift
    phase's metrics ride along; hardened selection and rounding within
    FLIP_RATE, hard losses within RTOL."""
    kw = dict(mode="two_phase", iters=20, batch_size=N,
              shift_targets=(0.5, 1.0))
    targets = [BLOCK, "model.fc"]
    x = tiny["cali"][:N]
    jq, jh, jprefix = JP.reconstruct_model(
        tiny["g"], tiny["params"], tiny["qs"], targets, jnp.asarray(x),
        JE.ReconSettings(**kw), jax.random.PRNGKey(0), batch_size=N)
    tq, th, tprefix = TP.reconstruct_model(
        tiny["gt"], tiny["tparams"], tiny["tqs"], targets, torch.tensor(x),
        TE.ReconSettings(**kw), seed=0, batch_size=N, device="cpu")
    assert tprefix.weight_on == jprefix.weight_on
    for t in targets:
        assert _a(th[t]["rec_trace"]).shape == (40,)
        assert _a(th[t]["shift_phase"]["rec_trace"]).shape == (20,)
        np.testing.assert_allclose(float(th[t]["hard_loss"]),
                                   float(jh[t]["hard_loss"]), rtol=RTOL)
        np.testing.assert_allclose(float(th[t]["shift_phase"]["hard_loss"]),
                                   float(jh[t]["shift_phase"]["hard_loss"]),
                                   rtol=RTOL)
    for u in list(UNITS) + ["model.fc"]:
        jw, tw = jq[u].wq, tq[u].wq
        assert type(tw).__name__ == type(jw).__name__ == "AdaRoundWQ"
        assert _flip_rate(_a(tw.st_index), np.asarray(jw.st_index)) \
            <= FLIP_RATE
        assert _flip_rate(_a(tw.alpha) >= 0, np.asarray(jw.alpha) >= 0) \
            <= FLIP_RATE


def test_cosine_schedule_matches_optax():
    """The LambdaLR factor against optax's schedule, which evaluates in
    f32: within rtol 1e-6 plus 1e-10 absolute (f32 rounding of the cosine
    near its end, 2^-22 of the peak)."""
    import optax
    for iters in (1, 7, 200):
        want = optax.cosine_decay_schedule(4e-4, max(iters, 1), 0.0)
        f = TE.cosine_lr(iters)
        for k in range(iters + 3):
            np.testing.assert_allclose(4e-4 * f(k), float(want(k)),
                                       rtol=1e-6, atol=1e-10)


def test_act_delta_gradient_matches_jax(calibrated):
    """One step's gradient w.r.t. the block's two act deltas (the unit
    site and the block-level site), through FakeQuantFn's grad w.r.t.
    delta, against jax.grad of the JAX package's node loss."""
    st = calibrated
    node_j, node_t = JG.find_node(st["g"], BLOCK), TG.find_node(st["gt"],
                                                                BLOCK)
    sites = [UNITS[0], BLOCK]
    flags = dict(weight_on=frozenset(UNITS), act_on=frozenset(sites))

    def jloss(d):
        qs = dict(st["qs"])
        qs[UNITS[0]] = dataclasses.replace(qs[UNITS[0]], aq=dataclasses.replace(
            qs[UNITS[0]].aq, delta=d[0]))
        qs[BLOCK] = dataclasses.replace(qs[BLOCK], delta=d[1])
        pred = JG.apply_node(node_j, st["params"], qs, jnp.asarray(st["ci"]),
                             JG.Flags(**flags))
        return JE.lp_loss_cl(pred, jnp.asarray(st["co"]), 2.4)

    d0 = [st["qs"][UNITS[0]].aq.delta, st["qs"][BLOCK].delta]
    want = jax.grad(jloss)(d0)
    dt = [torch.tensor(np.asarray(d), requires_grad=True) for d in d0]
    qs = dict(st["tqs"])
    qs[UNITS[0]] = dataclasses.replace(qs[UNITS[0]], aq=dataclasses.replace(
        qs[UNITS[0]].aq, delta=dt[0]))
    qs[BLOCK] = dataclasses.replace(qs[BLOCK], delta=dt[1])
    with TG._fp32():
        pred = TG.apply_node(node_t, st["tparams"], qs,
                             torch.tensor(st["ci"]), TG.Flags(**flags))
        TE.lp_loss_cl(pred, torch.tensor(st["co"]), 2.4).backward()
    for w, t in zip(want, dt):
        assert float(np.abs(np.asarray(w))) > 0
        np.testing.assert_allclose(_a(t.grad), np.asarray(w), rtol=GRAD_RTOL)


def test_act_delta_matches_jax(calibrated):
    """reconstruct_act_delta on the block: the unit site and the block
    site learn their deltas by Adam with the cosine schedule; trace and
    learned deltas within RTOL; weights and zero points untouched."""
    st = calibrated
    s = dict(mode="fused", iters=30, batch_size=N, act_lr=4e-4, act_p=2.4)
    jq, jm = JE.reconstruct_act_delta(
        st["g"], st["params"], st["qs"], BLOCK, jnp.asarray(st["ci"]),
        jnp.asarray(st["co"]), JE.ReconSettings(**s), jax.random.PRNGKey(4))
    tq, tm = TE.reconstruct_act_delta(
        st["gt"], st["tparams"], st["tqs"], BLOCK, torch.tensor(st["ci"]),
        torch.tensor(st["co"]), TE.ReconSettings(**s), seed=4)
    tr = _a(tm["rec_trace"])
    np.testing.assert_allclose(tr, np.asarray(jm["rec_trace"]), rtol=RTOL)
    assert tr[-5:].mean() < tr[:5].mean()
    for got, want, start in (
            (tq[UNITS[0]].aq.delta, jq[UNITS[0]].aq.delta,
             st["qs"][UNITS[0]].aq.delta),
            (tq[BLOCK].delta, jq[BLOCK].delta, st["qs"][BLOCK].delta)):
        assert not np.allclose(np.asarray(want), np.asarray(start))
        np.testing.assert_allclose(_a(got), np.asarray(want), rtol=RTOL)
    np.testing.assert_array_equal(_a(tq[UNITS[0]].aq.zero_point),
                                  _a(st["tqs"][UNITS[0]].aq.zero_point))
    assert tq[UNITS[1]].wq is st["tqs"][UNITS[1]].wq
    # a node without act sites learns nothing and keeps its state
    fq, fm = TE.reconstruct_act_delta(
        st["gt"], st["tparams"], st["tqs"], "model.fc",
        torch.zeros((N, 8)), torch.zeros((N, 4)), TE.ReconSettings(**s))
    assert fm == {} and fq["model.fc"] is st["tqs"]["model.fc"]


def test_act_phase_pipeline(calibrated):
    """act_phase='delta' through the pipeline learns the deltas of every
    target that has act sites, from the prefix of hardened weights."""
    st = calibrated
    s = TE.ReconSettings(mode="fused", iters=10, batch_size=N, act_lr=4e-3)
    prefix = TG.Flags(weight_on=frozenset(UNITS) | {"model.fc"})
    tq, th, _ = TP.reconstruct_model(
        st["gt"], st["tparams"], st["tqs"], [BLOCK, "model.fc"],
        torch.tensor(st["cali"][:N]), s, seed=1, batch_size=N,
        base_flags=prefix, act_phase="delta", device="cpu")
    assert _a(th[BLOCK]["rec_trace"]).shape == (10,)
    assert "rec_trace" not in th["model.fc"]
    assert float(tq[BLOCK].delta) != float(st["tqs"][BLOCK].delta)
    assert float(tq[UNITS[0]].aq.delta) \
        != float(st["tqs"][UNITS[0]].aq.delta)
