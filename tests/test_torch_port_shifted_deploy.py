"""PyTorch port vs the JAX package: serving a net quantized by the
shifted-scale method (fused quantizers hardened by the engine, deploy
conversion with the per-(candidate, OC) scale table, plan and integer
deploy forward), run on the CPU.

State is made by the JAX package on the CIFAR ResNet-18 at 32x32 (and
MobileNetV2 for the depthwise rules): W2A4, max scales snapped to powers
of two, 1/8-grid calibration images, ``_init_quantizers`` in fused mode,
seeded noise on the selection and rounding logits (as a trained state
would have, so every shift candidate owns channels), then ``_harden``. It
is carried to the port (``utils/jax_import``). On 1/8-grid images every
code is exact integer arithmetic in both deploy paths, and the logits
agree to the rounding of the float head: rel-MSE <= 1e-8 and the same
top-1. With power-of-two steps and targets the sim forwards of both
packages are exact too, so each package's deploy-vs-sim gap is the same.

States: 'effective' (targets {1/2, 1}: W2 units baked, the 8-bit stem and
fc plain AdaRound), 'unit' (the reference's near-1 targets: hardened
ShiftedScaleWQ, plain codes) and 'effective-w2' (no 8-bit head or stem:
the stem and fc are baked units on float edges, whose scale table folds
back into the weight). 'effective-near1' (near-1 targets forced to
effective dequant: the 8-bit stem and fc are baked with codes beyond int8,
whose shifts fold into f32 codes) is held to the JAX conversion and plan
only: the JAX float path rounds those non-integral codes to bf16, the
port's f32 path keeps them.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu import deploy as JD
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.models import zoo as JZ
from shiftedscalequantization_tpu.quantize import unit_order
from shiftedscalequantization_tpu.recon import engine as JE
import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.quantize import \
    act_flags as t_act_flags
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

HW = 32
NEAR1 = (1 - 1 / 32, 1 + 1 / 32, 1.0)
SWITCHES = ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
            "SSQ_DW_KERNEL")
SERVING = {"SSQ_STEM_KERNEL": "1", "SSQ_PACKED": "1", "SSQ_STEM_1PASS": "0"}
STATES = {
    "effective": (True, dict(shift_targets=(0.5, 1.0))),
    "unit": (True, dict()),
    "effective-w2": (False, dict(shift_targets=(0.5, 1.0))),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_mse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(((got - want) ** 2).mean() / (want ** 2).mean())


def _images(n, seed=1):
    x = np.random.default_rng(seed).normal(size=(n, HW, HW, 3))
    return (np.round(x * 8) / 8).astype(np.float32)


def _set_env(monkeypatch, env):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _kinds(plan):
    return {k: v for k, v in plan.items() if not k.startswith("__")}


def _pow2(a):
    return jnp.asarray(2.0 ** np.round(np.log2(np.asarray(a))), jnp.float32)


def _dyadic(qs):
    """Every weight and act step snapped to the nearest power of two."""
    out = {}
    for name, v in qs.items():
        if isinstance(v, ssq.UnitQuant):
            qp = dataclasses.replace(v.wq.qp, delta=_pow2(v.wq.qp.delta))
            aq = None if v.aq is None else \
                dataclasses.replace(v.aq, delta=_pow2(v.aq.delta))
            out[name] = dataclasses.replace(
                v, wq=dataclasses.replace(v.wq, qp=qp), aq=aq)
        else:
            out[name] = dataclasses.replace(v, delta=_pow2(v.delta))
    return out


_BASE = {}


def _base(arch, head_stem):
    """Prepared and calibrated JAX state, shared by the states of one
    (arch, head/stem rule)."""
    key = (arch, head_stem)
    if key not in _BASE:
        g, _ = JZ.build(arch, num_classes=10, dataset="cifar10")
        raw = JR.init_params(jax.random.PRNGKey(0), g)
        cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                              a_scale_method="max",
                              use_8bit_head_stem=head_stem)
        params, qs = ssq.prepare_model(g, raw, cfg)
        x = _images(8)
        qs = _dyadic(ssq.calibrate_acts(g, params, qs, jnp.asarray(x), cfg))
        _BASE[key] = (g, params, qs, x)
    return _BASE[key]


def _fused_state(arch, head_stem, settings):
    """JAX-made hardened fused state and its port copy."""
    g, params, qs, x = _base(arch, head_stem)
    names = unit_order(g)
    qs, theta = JE._init_quantizers(params, qs, names,
                                    JE.ReconSettings(mode="fused", **settings))
    rng = np.random.default_rng(10)
    theta = {n: {k: v + rng.normal(size=v.shape).astype(np.float32)
                 for k, v in t.items()} for n, t in theta.items()}
    qs = JE._harden(JE._insert_theta(qs, theta), names, "fused")
    gt, _ = TZ.build(arch, num_classes=10, dataset="cifar10")
    tparams = JI.params_from_numpy(_np(params), "cpu")
    tqs = JI.qstate_from_numpy(_np(qs), "cpu")
    tcfg = tp.QuantConfig(n_bits_w=2, n_bits_a=4,
                          use_8bit_head_stem=head_stem)
    return dict(g=g, params=params, qs=qs, x=x, gt=gt, tparams=tparams,
                tqs=tqs, tcfg=tcfg, names=names,
                jd=JD.build_deploy_params(g, params, qs),
                jsteps=JD.act_steps_from_qstate(g, qs),
                td=TD.build_deploy_params(gt, tparams, tqs, device="cpu"),
                tsteps=TD.act_steps_from_qstate(gt, tqs))


@pytest.fixture(scope="module", params=list(STATES))
def state(request):
    head_stem, settings = STATES[request.param]
    s = _fused_state("resnet18", head_stem, settings)
    s["kind"] = request.param
    return s


@pytest.fixture(scope="module")
def near1():
    return _fused_state("resnet18", True, dict(shift_targets=NEAR1,
                                               fused_dequant="effective"))


def _plans(s, hw=HW):
    pj = JD.make_deploy_plan(s["g"], s["jd"], s["jsteps"],
                             input_hw=(hw, hw))
    pt = TD.make_deploy_plan(s["gt"], s["td"], s["tsteps"],
                             input_hw=(hw, hw))
    return pj, pt


def _deploy_both(s, x, pj, pt):
    want = np.asarray(JD.deploy_forward(s["g"], s["jd"], s["jsteps"],
                                        jnp.asarray(x), plan=pj))
    got = TD.deploy_forward(s["gt"], s["td"], s["tsteps"],
                            torch.as_tensor(x), plan=pt, device="cpu")
    return got.numpy(), want


def _assert_units_match(s):
    """Integer codes, masked groups (w_groups) and f32 codes exact; the
    scale table, scale and bias the same f32 expressions (rtol 1e-6); no
    packed form for baked units. Returns the number of baked units."""
    baked = 0
    for name, dj in s["jd"].items():
        dt = s["td"][name]
        for f in ("w_int", "w_fp", "w_groups"):
            a, b = getattr(dt, f), getattr(dj, f)
            assert (a is None) == (b is None), (name, f)
            if b is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for f in ("scale", "bias", "group_scales"):
            a, b = getattr(dt, f), getattr(dj, f)
            assert (a is None) == (b is None), (name, f)
            if b is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-7)
        assert dt.w_pack_bits == dj.w_pack_bits, name
        if dt.w_groups is not None:
            baked += 1
            assert dt.w_packed is None
            assert tuple(dt.w_mat.shape) == (
                dt.w_groups.shape[0], dt.w_groups.shape[1],
                dt.w_groups[0, 0].numel())
            assert torch.equal(dt.w_sum, dt.w_mat.sum(dim=2,
                                                      dtype=torch.int32))
    return baked


def test_deploy_units_match_jax(state):
    baked = _assert_units_match(state)
    assert baked == {"effective": 19, "unit": 0,
                     "effective-w2": 21}[state["kind"]]
    if state["kind"] == "effective":
        # both candidates own channels somewhere in the net
        owners = sum((state["td"][n].w_groups[s] != 0).any().item()
                     for n in state["td"] for s in range(2)
                     if state["td"][n].w_groups is not None)
        assert owners > 19


def test_baked_8bit_units_fold_shifts_like_jax(near1, monkeypatch):
    """Near-1 targets with effective dequant: the 8-bit stem and fc are
    baked with centered codes beyond int8, kept as f32 codes with their
    shifts folded in, as the JAX conversion does; the plan is the same."""
    assert _assert_units_match(near1) == 19
    for name in (near1["names"][0], near1["names"][-1]):
        d = near1["td"][name]
        assert d.w_fp is not None and d.w_groups is None
        assert not torch.equal(d.w_fp, torch.round(d.w_fp))
    _set_env(monkeypatch, SERVING)
    pj, pt = _plans(near1)
    assert _kinds(pt) == _kinds(pj)


@pytest.mark.parametrize("env", [{}, {"SSQ_PACKED": "1"}, SERVING],
                         ids=["default", "packed", "serving"])
def test_plan_matches_jax(state, monkeypatch, env):
    _set_env(monkeypatch, env)
    pj, pt = _plans(state)
    assert _kinds(pt) == _kinds(pj)
    for key in ("__fused_stem__", "__int8_sites__", "__biased_sites__"):
        assert pt[key] == pj[key], key


@pytest.mark.parametrize("batch", [8, 1], ids=["batch8", "batch1"])
def test_deploy_forward_matches_jax(state, monkeypatch, batch):
    """Port deploy vs JAX deploy under the serving switches: rel-MSE <=
    1e-8, same top-1. Batch 1 was refused by the port's old integer route
    (M = 16 at layer4); it now serves as JAX does."""
    _set_env(monkeypatch, SERVING)
    pj, pt = _plans(state)
    got, want = _deploy_both(state, state["x"][:batch], pj, pt)
    assert got.shape == (batch, 10)
    assert _rel_mse(got, want) <= 1e-8
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_deploy_vs_sim_gap_matches_jax(state, monkeypatch):
    """The port's deploy vs its own sim forward on the hardened state: the
    gap is the JAX package's own deploy-vs-sim gap on the same state,
    within 10% of it (half-up requant in deploy vs half-even in sim
    spreads through depth on random weights), and top-1 agrees on at
    least 6 of 8 images."""
    _set_env(monkeypatch, SERVING)
    x = torch.as_tensor(state["x"])
    flags = t_act_flags(state["gt"], state["tcfg"],
                        base=tp.Flags().all_weights(state["gt"]))
    sim = tp.forward(state["gt"], state["tparams"], state["tqs"], x, flags,
                     device="cpu").numpy()
    dep = TD.deploy_forward(state["gt"], state["td"], state["tsteps"], x,
                            device="cpu").numpy()
    rel = np.abs(sim - dep).mean() / (np.abs(sim).mean() + 1e-9)
    jflags = dataclasses.replace(ssq.Flags(), weight_on=flags.weight_on,
                                 act_on=flags.act_on)
    jx = jnp.asarray(state["x"])
    jsim = np.asarray(ssq.forward(state["g"], state["params"], state["qs"],
                                  jx, jflags))
    jdep = np.asarray(JD.deploy_forward(state["g"], state["jd"],
                                        state["jsteps"], jx))
    jrel = np.abs(jsim - jdep).mean() / (np.abs(jsim).mean() + 1e-9)
    assert abs(rel - jrel) <= 0.1 * jrel, (rel, jrel)
    assert (sim.argmax(-1) == dep.argmax(-1)).sum() >= 6


@pytest.fixture(scope="module")
def mnv2():
    return _fused_state("mobilenetv2", True, dict(shift_targets=(0.5, 1.0)))


@pytest.mark.parametrize("env", [{"SSQ_DW_KERNEL": "1"},
                                 {"SSQ_DW_KERNEL": "1", "SSQ_PACKED": "1"}],
                         ids=["dw", "dw+packed"])
def test_mobilenetv2_baked_plan_matches_jax(mnv2, monkeypatch, env):
    """Baked depthwise units stay off the dw kernel (the JAX rule's
    w_groups condition) and take bf16_codes, one integer pass per group;
    baked 1x1 convs have no packed form."""
    _set_env(monkeypatch, env)
    pj, pt = _plans(mnv2)
    assert _kinds(pt) == _kinds(pj)
    kinds = [k for k, _ in _kinds(pt).values()]
    assert "dw_int8" not in kinds and "packed" not in kinds
    dw = [n for n, d in mnv2["td"].items()
          if d.w_int is not None and d.w_int.shape[1] == 1]
    assert len(dw) == 17 and all(mnv2["td"][n].w_groups is not None
                                 for n in dw)


def test_mobilenetv2_baked_deploy_matches_jax(mnv2, monkeypatch):
    """MobileNetV2 on baked state at batch 1 (M = 16, K = 576 at the last
    1x1 convs, which the port's old integer route refused): the depthwise
    scale-table route and the dense one against the JAX deploy, rel-MSE
    <= 1e-8, same top-1."""
    _set_env(monkeypatch, {"SSQ_DW_KERNEL": "1", "SSQ_PACKED": "1"})
    pj, pt = _plans(mnv2)
    got, want = _deploy_both(mnv2, mnv2["x"][:1], pj, pt)
    assert _rel_mse(got, want) <= 1e-8
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
