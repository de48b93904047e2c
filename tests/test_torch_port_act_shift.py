"""PyTorch port vs the JAX package: the activation shifted-scale quantizer
(``ops/act_quant.py``), its reconstruction phase
(``engine.reconstruct_act_shift``, the pipeline's ``act_phase="shift"``),
the serving of an act-shift state (``deploy.py``) and its checkpoint, on
the CPU.

State is made by the JAX package and carried across
(``utils/jax_import``). The tiny model and its caches come from
``test_torch_port_recon.py``; caches hold N = batch_size rows, so every
step sees all rows and only summation orders differ. Tolerances: the
hardened quantizer and the steps bit for bit; the soft mix within rtol
1e-6 (the JAX package mixes by einsum, the port by a sum of products, an
ulp apart); the alpha gradient within rtol 1e-5; traces and learned
alphas within rtol 1e-4 over 40 Adam steps; hardened selections equal.
The deploy case is ``tests/test_deploy_extra.py``'s TestActShiftDeploy
with every act step a power of two and images on a 1/8 grid: the f32
edges of the per-channel sites then hold values whose products with the
integer weight codes sum exactly in either package, so the port's deploy
equals the JAX package's (rel-MSE <= 1e-8).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu import deploy as JD
from shiftedscalequantization_tpu import graph as JG
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.ops import act_quant as JA
from shiftedscalequantization_tpu.ops import quant as JQ
from shiftedscalequantization_tpu.quantize import act_flags as jact_flags
from shiftedscalequantization_tpu.recon import engine as JE
from shiftedscalequantization_tpu.recon import pipeline as JP
import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch import graph as TG
from shiftedscalequantization_tpu_torch.ops import act_quant as TA
from shiftedscalequantization_tpu_torch.ops.quant import QParams
from shiftedscalequantization_tpu_torch.recon import engine as TE
from shiftedscalequantization_tpu_torch.recon import pipeline as TP
from shiftedscalequantization_tpu_torch.utils import checkpoint as TCK
from shiftedscalequantization_tpu_torch.utils import jax_import as JI
from test_torch_port_recon import BLOCK, UNITS, _a, _caches, _np, \
    _port_graph, _state

MIX_RTOL = 1e-6
GRAD_RTOL = 1e-5
RTOL = 1e-4
N = 16
TARGETS = (1.0, 0.5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores, and small ops on threads that wait for busy cores
    run hundreds of times slower)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _qp(delta=0.3, zp=2.0, n_bits=4):
    return (JQ.QParams(delta=jnp.float32(delta), zero_point=jnp.float32(zp),
                       n_bits=n_bits, sym=False),
            QParams(delta=torch.tensor(delta), zero_point=torch.tensor(zp),
                    n_bits=n_bits, sym=False))


def _pair(alpha, targets=TARGETS, hard=False):
    jqp, tqp = _qp()
    return (JA.ActShiftQuant(qp=jqp, alpha=jnp.asarray(alpha),
                             shift_targets=targets, hard_targets=hard),
            TA.ActShiftQuant(qp=tqp, alpha=torch.tensor(alpha),
                             shift_targets=targets, hard_targets=hard))


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("targets", [TARGETS, (1.0, 0.5, 0.25)],
                         ids=["two", "three"])
def test_act_shift_quant_matches_jax(hard, targets):
    """__call__ (the hardened mix bit for bit, the soft one within
    MIX_RTOL), its gradient w.r.t. alpha and x, and effective_delta
    (argmax, first index on a tie: channel 0's logits are tied)."""
    rng = np.random.default_rng(0)
    c = 6
    x = (rng.normal(size=(4, 5, 5, c)) * 2).astype(np.float32)
    alpha = rng.normal(size=(c, len(targets))).astype(np.float32)
    alpha[0] = 0.0
    r = rng.normal(size=x.shape).astype(np.float32)
    jq, tq = _pair(alpha, targets, hard)

    def jloss(a, x):
        return (dataclasses.replace(jq, alpha=a)(x) * r).sum()

    want = np.asarray(jq(jnp.asarray(x)))
    ja, jx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(alpha),
                                             jnp.asarray(x))
    ta = torch.tensor(alpha, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    got = dataclasses.replace(tq, alpha=ta)(tx)
    (got * torch.tensor(r)).sum().backward()
    if hard:
        np.testing.assert_array_equal(_a(got), want)
    else:
        np.testing.assert_allclose(_a(got), want, rtol=MIX_RTOL, atol=1e-7)
        np.testing.assert_allclose(_a(ta.grad), np.asarray(ja),
                                   rtol=GRAD_RTOL, atol=1e-5)
    np.testing.assert_allclose(_a(tx.grad), np.asarray(jx), rtol=GRAD_RTOL,
                               atol=1e-6)
    np.testing.assert_array_equal(_a(tq.effective_delta()),
                                  np.asarray(jq.effective_delta()))
    assert float(tq.effective_delta()[0]) == float(tq.qp.delta) * targets[0]


@pytest.mark.parametrize("targets", [TARGETS, (1.0, 0.5, 0.25), (1.0,)],
                         ids=["two", "three", "one"])
def test_init_act_shift_matches_jax(targets):
    """The per-channel MSE argmin init: the same selection and logits."""
    rng = np.random.default_rng(1)
    x = np.maximum(rng.normal(size=(16, 6, 6, 8)) * 1.5, 0) \
        .astype(np.float32)
    x[..., :3] *= 0.4          # channels that prefer the finer step
    jqp, tqp = _qp()
    want = JA.init_act_shift(jqp, jnp.asarray(x), targets)
    got = TA.init_act_shift(tqp, torch.tensor(x), targets)
    assert got.shift_targets == want.shift_targets and not got.hard_targets
    np.testing.assert_allclose(_a(got.alpha), np.asarray(want.alpha),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_a(got.alpha).argmax(-1),
                                  np.asarray(want.alpha).argmax(-1))
    if len(targets) > 1:
        assert len(set(_a(got.alpha).argmax(-1).tolist())) > 1


@pytest.fixture(scope="module")
def calibrated():
    """The tiny state with every act site calibrated (weights on), in
    both packages, and the block's FP caches of N rows."""
    st = _state()
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          use_8bit_head_stem=False)
    st["qs"] = ssq.calibrate_acts(st["g"], st["params"], st["qs"],
                                  jnp.asarray(st["cali"][:32]), cfg,
                                  flags=JG.Flags().all_weights(st["g"]))
    st["tqs"] = JI.qstate_from_numpy(_np(st["qs"]), "cpu")
    st["ci"], st["co"] = _caches(st, BLOCK, N)
    return st


def _sites(qs):
    """site -> ActShiftQuant of a qstate (unit aq and block sites)."""
    out = {}
    for k, v in qs.items():
        aq = getattr(v, "aq", v)
        if type(aq).__name__ == "ActShiftQuant":
            out[k] = aq
    return out


def test_reconstruct_act_shift_matches_jax(calibrated):
    st = calibrated
    s = dict(iters=40, batch_size=N, act_shift_targets=TARGETS)
    jq, jm = JE.reconstruct_act_shift(
        st["g"], st["params"], st["qs"], BLOCK, jnp.asarray(st["ci"]),
        jnp.asarray(st["co"]), JE.ReconSettings(**s), jax.random.PRNGKey(4))
    tq, tm = TE.reconstruct_act_shift(
        st["gt"], st["tparams"], st["tqs"], BLOCK, torch.tensor(st["ci"]),
        torch.tensor(st["co"]), TE.ReconSettings(**s), seed=4)
    np.testing.assert_allclose(_a(tm["rec_trace"]),
                               np.asarray(jm["rec_trace"]), rtol=RTOL)
    jsites, tsites = _sites(jq), _sites(tq)
    assert set(tsites) == set(jsites) == {UNITS[0], BLOCK}
    for k, ja in jsites.items():
        ta = tsites[k]
        assert ta.hard_targets and ja.hard_targets
        np.testing.assert_allclose(_a(ta.alpha), np.asarray(ja.alpha),
                                   rtol=RTOL, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(_a(ta.effective_delta()),
                                      np.asarray(ja.effective_delta()))
    # the hardened state's loss on the caches is the same in both
    flags = dict(weight_on=frozenset(UNITS), act_on=frozenset(jsites))
    want = JG.apply_node(JG.find_node(st["g"], BLOCK), st["params"], jq,
                         jnp.asarray(st["ci"]), JG.Flags(**flags))
    got = TG.apply_node(TG.find_node(st["gt"], BLOCK), st["tparams"], tq,
                        torch.tensor(st["ci"]), TG.Flags(**flags))
    np.testing.assert_allclose(_a(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_pipeline_act_shift_phase_matches_jax(calibrated):
    """act_phase='shift' over the tiny model's targets (the fc has no
    act site) with the weights on, from N calibration rows."""
    st = calibrated
    s = dict(iters=20, batch_size=N, act_shift_targets=TARGETS)
    targets = [BLOCK, "model.fc"]
    wflags = JG.Flags().all_weights(st["g"])
    jq, _, jprefix = JP.reconstruct_model(
        st["g"], st["params"], st["qs"], targets,
        jnp.asarray(st["cali"][:N]), JE.ReconSettings(**s),
        jax.random.PRNGKey(1), batch_size=N, base_flags=wflags,
        act_phase="shift")
    tq, hist, tprefix = TP.reconstruct_model(
        st["gt"], st["tparams"], st["tqs"], targets,
        torch.tensor(st["cali"][:N]), TE.ReconSettings(**s), seed=1,
        batch_size=N, base_flags=TG.Flags().all_weights(st["gt"]),
        act_phase="shift", device="cpu")
    assert tprefix.weight_on == jprefix.weight_on
    # no Fisher gradients in an act phase
    assert hist[BLOCK]["grads_s"] < 0.1 and "rec_trace" in hist[BLOCK]
    jsites, tsites = _sites(jq), _sites(tq)
    assert set(tsites) == set(jsites) == {UNITS[0], BLOCK}
    for k, ja in jsites.items():
        np.testing.assert_allclose(_a(tsites[k].alpha), np.asarray(ja.alpha),
                                   rtol=RTOL, atol=1e-5, err_msg=k)
        assert tsites[k].hard_targets


def test_checkpoint_round_trip(calibrated, tmp_path):
    """A qstate holding act-shift sites (a unit's aq and a block site)
    saves and loads with every field."""
    st = calibrated
    tq, _ = TE.reconstruct_act_shift(
        st["gt"], st["tparams"], st["tqs"], BLOCK, torch.tensor(st["ci"]),
        torch.tensor(st["co"]), TE.ReconSettings(iters=2, batch_size=N),
        seed=0)
    path = str(tmp_path / "ck" / "state")
    TCK.save_qstate(path, tq, done=[BLOCK])
    back, done = TCK.load_qstate(path, device="cpu")
    assert done == [BLOCK]
    for k, a in _sites(tq).items():
        b = _sites(back)[k]
        assert type(b) is TA.ActShiftQuant
        assert (b.shift_targets, b.hard_targets, b.qp.n_bits, b.qp.sym) \
            == (a.shift_targets, a.hard_targets, a.qp.n_bits, a.qp.sym)
        for f in ("alpha",):
            assert torch.equal(getattr(b, f), getattr(a, f))
        assert torch.equal(b.qp.delta, a.qp.delta)
        assert torch.equal(b.qp.zero_point, a.qp.zero_point)
        assert torch.equal(b.effective_delta(), a.effective_delta())


# ---------------------------------------------------------------------------
# serving (tests/test_deploy_extra.py TestActShiftDeploy)
# ---------------------------------------------------------------------------

def _pow2(qp):
    return dataclasses.replace(qp, delta=jnp.exp2(jnp.round(jnp.log2(
        qp.delta))))


@pytest.fixture(scope="module")
def served():
    """ResNet-18 (CIFAR variant) W2A4, max scales, calibrated on 8 images
    on a 1/8 grid, every act step rounded to a power of two."""
    graph = JR.build_resnet(18, num_classes=10, variant="cifar")
    raw = JR.init_params(jax.random.PRNGKey(0), graph)
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          a_scale_method="max")
    params, qs = ssq.prepare_model(graph, raw, cfg)
    x = (np.round(np.random.default_rng(1).normal(size=(8, 32, 32, 3)) * 8)
         / 8).astype(np.float32)
    qs = ssq.calibrate_acts(graph, params, qs, jnp.asarray(x), cfg)
    qs = {k: (dataclasses.replace(v, aq=_pow2(v.aq))
              if isinstance(v, JG.UnitQuant) and v.aq is not None
              else _pow2(v) if isinstance(v, JQ.QParams) else v)
          for k, v in qs.items()}
    return dict(g=graph, params=params, qs=qs, x=x,
                flags=jact_flags(graph, cfg,
                                 base=ssq.Flags().all_weights(graph)),
                gt=_port_graph(graph),
                tparams=JI.params_from_numpy(_np(params), "cpu"))


def _act_shift_state(sv, every_site):
    """The first block site (or every act site but the stem's) an
    ActShiftQuant with targets alternating 1 / 1/2 over channels,
    hardened."""
    qs = dict(sv["qs"])
    for name, v in sv["qs"].items():
        unit = isinstance(v, JG.UnitQuant)
        if v is None or (unit and (not every_site or v.aq is None
                                   or name == "model.conv1")):
            continue
        node = JG.find_node(sv["g"], name)
        c = node.out_ch if unit else node.units[-1].out_ch
        p = jax.nn.one_hot(jnp.arange(c) % 2, 2, dtype=jnp.float32)
        asq = JA.ActShiftQuant(
            qp=v.aq if unit else v,
            alpha=JQ.inverse_rectified_softmax(p * 0.8 + (1 - p) * 0.2),
            shift_targets=TARGETS, hard_targets=True)
        qs[name] = dataclasses.replace(v, aq=asq) if unit else asq
        if not every_site:
            break
    return qs


@pytest.mark.parametrize("every_site", [False, True],
                         ids=["block_site", "every_site"])
def test_act_shift_deploy_matches_jax(served, every_site):
    """Per-channel sites travel as f32 edges: the plan equals the JAX
    package's unit by unit, no act-shift site is an int8 or biased
    code site, and deploy equals the JAX package's deploy (rel-MSE <=
    1e-8) and keeps the reference's own bound against the sim."""
    sv = served
    jqs = _act_shift_state(sv, every_site)
    tqs = JI.qstate_from_numpy(_np(jqs), "cpu")
    sites = _sites(tqs)
    assert len(sites) == (16 if every_site else 1)
    jsteps = JD.act_steps_from_qstate(sv["g"], jqs)
    tsteps = TD.act_steps_from_qstate(sv["gt"], tqs)
    for k in sites:
        assert tsteps[k][0].numel() == np.asarray(jsteps[k][0]).size > 1
        np.testing.assert_array_equal(_a(tsteps[k][0]),
                                      np.asarray(jsteps[k][0]))
    jdp = JD.build_deploy_params(sv["g"], sv["params"], jqs)
    jplan = JD.make_deploy_plan(sv["g"], jdp, jsteps)
    tdp = TD.build_deploy_params(sv["gt"], sv["tparams"], tqs, device="cpu")
    tplan = TD.make_deploy_plan(sv["gt"], tdp, tsteps, input_hw=(32, 32))
    units = [k for k in jplan if not k.startswith("__")]
    assert {k: tplan[k] for k in units} == {k: jplan[k] for k in units}
    for k in sites:
        assert k not in tplan["__int8_sites__"]
        assert k not in tplan["__biased_sites__"]
    kinds = {tplan[k][0] for k in units}
    assert "float" in kinds and ("int8" in kinds) != every_site
    x = jnp.asarray(sv["x"])
    want = np.asarray(jax.jit(lambda x: JD.deploy_forward(
        sv["g"], jdp, jsteps, x, jplan))(x), np.float64)
    got = TD.deploy_forward(sv["gt"], tdp, tsteps, torch.tensor(sv["x"]),
                            plan=tplan, device="cpu").double().numpy()
    rel = ((got - want) ** 2).mean() / (want ** 2).mean()
    assert rel <= 1e-8, rel
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    sim = tp.forward(sv["gt"], sv["tparams"], tqs, torch.tensor(sv["x"]),
                     sv["flags"], device="cpu").double().numpy()
    assert np.abs(sim - got).mean() / (np.abs(sim).mean() + 1e-9) < 0.15
    assert (sim.argmax(-1) == got.argmax(-1)).mean() >= 0.99


def test_per_channel_step_refused_by_integer_feeds(served):
    """The int8 / bf16_codes, packed and dw_int8 integer feeds read one
    step: a plan that hands them a per-channel site raises ValueError."""
    sv = served
    jqs = _act_shift_state(sv, False)
    tqs = JI.qstate_from_numpy(_np(jqs), "cpu")
    site = next(iter(_sites(tqs)))
    tsteps = TD.act_steps_from_qstate(sv["gt"], tqs)
    tdp = TD.build_deploy_params(sv["gt"], sv["tparams"], tqs, device="cpu")
    plan = TD.make_deploy_plan(sv["gt"], tdp, tsteps, input_hw=(32, 32))
    fed = [k for k, v in plan.items()
           if not k.startswith("__") and v[1] == site]
    assert fed and all(plan[k][0] == "float" for k in fed)
    for kind in ("int8", "bf16_codes", "int8_pair", "packed", "dw_int8"):
        bad = dict(plan, **{k: (kind, site) for k in fed})
        with pytest.raises(ValueError, match="scalar act step"):
            TD.deploy_forward(sv["gt"], tdp, tsteps,
                              torch.tensor(sv["x"][:2]), plan=bad,
                              device="cpu")
