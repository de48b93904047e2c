"""PyTorch port vs the JAX package: MobileNetV2 (graph, sim forward,
calibration, deploy plan and integer deploy forward), run on the CPU.

The CIFAR variant at 32x32 keeps the ImageNet variant's 17 depthwise
units, 34 1x1 convs and the 8-bit stem and head, with a JAX deploy that
runs in seconds. State is made by the JAX package and carried to the port
(``utils/jax_import``); images are multiples of 1/8, so the stem conv is
exact in both packages and every code after it is integer arithmetic.
Each JAX deploy result is computed once per module.
"""
import collections
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu import deploy as JD
from shiftedscalequantization_tpu.models import mobilenetv2 as JM
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.models import zoo as JZ
from shiftedscalequantization_tpu.quantize import act_flags as j_act_flags
import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.ops.cuda import depthwise as TDW
from shiftedscalequantization_tpu_torch.ops.cuda import dw_conv as TDC
from shiftedscalequantization_tpu_torch.quantize import \
    act_flags as t_act_flags
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

HW = 32
SWITCHES = ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
            "SSQ_DW_KERNEL")
DW = {"SSQ_DW_KERNEL": "1"}
DW_PACKED = {"SSQ_DW_KERNEL": "1", "SSQ_PACKED": "1"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the same cores, and torch's thread pool then waits on
    descheduled threads at every small op of the scale searches."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_mse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(((got - want) ** 2).mean() / (want ** 2).mean())


def _images(n, hw, seed=1):
    x = np.random.default_rng(seed).normal(size=(n, hw, hw, 3))
    return (np.round(x * 8) / 8).astype(np.float32)


def _set_env(monkeypatch, env):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _kinds(plan):
    return {k: v for k, v in plan.items() if not k.startswith("__")}


@pytest.fixture(scope="module")
def state():
    """W2A4, MSE weight and act scales (the serving configuration), JAX
    state carried to the port; ``jax_deploy`` caches the JAX logits per
    switch set."""
    g, _ = JZ.build("mobilenetv2", num_classes=10, dataset="cifar10")
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4)
    params, qs = ssq.prepare_model(g, raw, cfg)
    x = _images(4, HW)
    qs = ssq.calibrate_acts(g, params, qs, jnp.asarray(x), cfg)
    gt, _ = TZ.build("mobilenetv2", num_classes=10, dataset="cifar10")
    tparams = JI.params_from_numpy(_np(params), "cpu")
    tqs = JI.qstate_from_numpy(_np(qs), "cpu")
    return dict(g=g, raw=raw, params=params, qs=qs, x=x, gt=gt,
                tparams=tparams, tqs=tqs,
                jd=JD.build_deploy_params(g, params, qs),
                jsteps=JD.act_steps_from_qstate(g, qs),
                td=TD.build_deploy_params(gt, tparams, tqs, device="cpu"),
                tsteps=TD.act_steps_from_qstate(gt, tqs), jax_deploy={})


def _plans(state):
    pj = JD.make_deploy_plan(state["g"], state["jd"], state["jsteps"],
                             input_hw=(HW, HW))
    pt = TD.make_deploy_plan(state["gt"], state["td"], state["tsteps"],
                             input_hw=(HW, HW))
    return pj, pt


@pytest.mark.parametrize("dataset", ["imagenet", "cifar10"])
def test_graph_and_key_map_match_jax(dataset):
    gj, _ = JZ.build("mobilenetv2", num_classes=10, dataset=dataset)
    gt, key_map = TZ.build("mobilenetv2", num_classes=10, dataset=dataset)
    assert [dataclasses.asdict(n) for n in gt] == \
        [dataclasses.asdict(n) for n in gj]
    assert key_map(gt) == JM.torch_key_map(gj)
    assert "mobilenetv2" in TZ.ARCHS
    units = list(tp.graph.iter_units(gt))
    assert len(units) == 53
    assert sum(u.groups > 1 for u in units) == 17


@pytest.mark.parametrize("width", [0.5, 1.0, 1.4])
def test_width_mult_matches_jax(width):
    from shiftedscalequantization_tpu_torch.models import mobilenetv2 as TM
    gj = JM.build_mobilenetv2(num_classes=1000, width_mult=width)
    gt = TM.build_mobilenetv2(num_classes=1000, width_mult=width)
    assert [dataclasses.asdict(n) for n in gt] == \
        [dataclasses.asdict(n) for n in gj]
    # torchvision's mobilenet_v2 at width 1.0 has 3.5 M parameters
    pt = TZ.init_params(gt, device="cpu")
    n = sum(t.numel() for p in pt.values() for k, t in p.items()
            if k == "w")
    if width == 1.0:
        assert 3.4e6 < n < 3.6e6, n


@pytest.mark.parametrize("dataset,hw", [("imagenet", 64), ("cifar10", 32)])
def test_fp_forward_matches_jax(dataset, hw):
    """Float forward (no quantizers) of BN-folded params: only f32
    summation order differs, rel-MSE <= 1e-8."""
    g, _ = JZ.build("mobilenetv2", num_classes=10, dataset=dataset)
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=4, n_bits_a=8, w_scale_method="max")
    params, qs = ssq.prepare_model(g, raw, cfg)
    x = _images(2, hw, seed=2)
    want = ssq.forward(g, params, qs, jnp.asarray(x), ssq.Flags())
    gt, _ = TZ.build("mobilenetv2", num_classes=10, dataset=dataset)
    got = tp.forward(gt, JI.params_from_numpy(_np(params), "cpu"),
                     JI.qstate_from_numpy(_np(qs), "cpu"), torch.as_tensor(x),
                     tp.Flags(), device="cpu")
    assert tuple(got.shape) == (2, 10)
    assert _rel_mse(got.numpy(), want) <= 1e-8


def _pow2(a):
    return jnp.asarray(2.0 ** np.round(np.log2(np.asarray(a))), jnp.float32)


def _dyadic(qs):
    """Every weight and act step snapped to the nearest power of two, as
    in test_torch_port_model.py: every fake-quant value and partial sum is
    then exact in f32 and the sim forward does not depend on summation
    order."""
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


def test_quantized_sim_forward_matches_jax():
    """W4A8 fake-quant forward with every weight and act quantizer on
    (relu6 clips, depthwise groups, the 8-bit stem and head), on carried
    state snapped to power-of-two steps and 1/8-grid images: both packages
    compute exactly the same values, rel-MSE <= 1e-8. Max scales keep the
    JAX setup short; the snap replaces the steps anyway."""
    g, _ = JZ.build("mobilenetv2", num_classes=10, dataset="cifar10")
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=4, n_bits_a=8, w_scale_method="max",
                          a_scale_method="max")
    params, qs = ssq.prepare_model(g, raw, cfg)
    x = _images(2, HW)
    qs = _dyadic(ssq.calibrate_acts(g, params, qs, jnp.asarray(x), cfg))
    flags = j_act_flags(g, cfg, base=ssq.Flags().all_weights(g))
    want = ssq.forward(g, params, qs, jnp.asarray(x), flags)
    gt, _ = TZ.build("mobilenetv2", num_classes=10, dataset="cifar10")
    tcfg = tp.QuantConfig(n_bits_w=4, n_bits_a=8, w_scale_method="max",
                          a_scale_method="max")
    tflags = t_act_flags(gt, tcfg, base=tp.Flags().all_weights(gt))
    assert (tflags.weight_on, tflags.act_on) == (flags.weight_on,
                                                 flags.act_on)
    got = tp.forward(gt, JI.params_from_numpy(_np(params), "cpu"),
                     JI.qstate_from_numpy(_np(qs), "cpu"), torch.as_tensor(x),
                     tflags, device="cpu")
    assert _rel_mse(got.numpy(), want) <= 1e-8


def test_prepare_and_calibrate_match_jax(state):
    """The port's own prepare_model + calibrate_acts (W2A4, MSE) from the
    same raw weights and images: weight QParams and every act site's delta
    and zero point rtol 1e-5, the same sites, 8-bit stem and head."""
    tcfg = tp.QuantConfig(n_bits_w=2, n_bits_a=4)
    tparams, tqs = tp.prepare_model(
        state["gt"], JI.params_from_numpy(_np(state["raw"]), "cpu"), tcfg,
        device="cpu")
    tqs = tp.calibrate_acts(state["gt"], tparams, tqs,
                            torch.as_tensor(state["x"]), tcfg, device="cpu")
    sites = 0
    for name, v in state["qs"].items():
        t = tqs[name]
        if isinstance(v, ssq.UnitQuant):
            assert t.wq.qp.n_bits == v.wq.qp.n_bits, name
            np.testing.assert_allclose(t.wq.qp.delta.numpy(),
                                       np.asarray(v.wq.qp.delta), rtol=1e-5)
            aj, at = v.aq, t.aq
        else:
            aj, at = v, t
        assert (aj is None) == (at is None), name
        if aj is None:
            continue
        sites += 1
        assert at.n_bits == aj.n_bits
        np.testing.assert_allclose(float(at.delta), float(aj.delta),
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(float(at.zero_point),
                                   float(aj.zero_point), rtol=1e-5,
                                   err_msg=name)
    # unit sites: stem + 16 expand + 17 dw + the head conv; and the 17
    # block sites
    assert sites == 35 + 17
    assert tqs["model.features.0.0"].aq.n_bits == 8
    assert tqs["model.features.18.0"].aq.n_bits == 8
    assert tqs["model.classifier.1"].wq.qp.n_bits == 8


def test_deploy_params_match_jax(state):
    for name, dj in state["jd"].items():
        dt = state["td"][name]
        assert (dt.w_int is None) == (dj.w_int is None), name
        if dj.w_int is not None:
            np.testing.assert_array_equal(dt.w_int.numpy(),
                                          np.asarray(dj.w_int))
        np.testing.assert_allclose(dt.scale.numpy(), np.asarray(dj.scale),
                                   rtol=1e-6)
        assert dt.w_pack_bits == dj.w_pack_bits, name


@pytest.mark.parametrize("env", [{}, DW, DW_PACKED],
                         ids=["default", "dw", "dw+packed"])
def test_plan_matches_jax(state, monkeypatch, env):
    """Same kind and feeding site per unit and the same transport sets as
    the JAX plan under the same SSQ_* switches."""
    _set_env(monkeypatch, env)
    pj, pt = _plans(state)
    assert _kinds(pt) == _kinds(pj)
    for key in ("__fused_stem__", "__int8_sites__", "__biased_sites__"):
        assert pt[key] == pj[key], key
    assert set(pt["__sum_steps__"]) == set(pj["__sum_steps__"])


def test_serving_plan_counts(state, monkeypatch):
    """The serving switches give the JAX package's counts: every depthwise
    unit but the first (fed by the biased 8-bit stem site) on the dw
    kernel, every W2 1x1 conv on the packed kernel."""
    _set_env(monkeypatch, DW_PACKED)
    _, pt = _plans(state)
    counts = collections.Counter(k for k, _ in _kinds(pt).values())
    assert counts == {"dw_int8": 16, "packed": 34, "bf16_codes": 1,
                      "float_1p": 1, "float": 1}
    assert pt["model.features.1.conv.0"][0] == "bf16_codes"
    assert "model.features.0.0" in pt["__biased_sites__"]


@pytest.mark.parametrize("env", [DW, DW_PACKED], ids=["dw", "dw+packed"])
def test_deploy_forward_matches_jax(state, monkeypatch, env):
    """Deploy logits vs the JAX deploy_forward (Pallas kernels in
    interpret mode) under the same switches: rel-MSE <= 1e-8 and the same
    top-1. The dw kernel counts no launch on CPU tensors."""
    _set_env(monkeypatch, env)
    pj, pt = _plans(state)
    key = tuple(sorted(env.items()))
    if key not in state["jax_deploy"]:
        state["jax_deploy"][key] = np.asarray(JD.deploy_forward(
            state["g"], state["jd"], state["jsteps"],
            jnp.asarray(state["x"]), plan=pj))
    want = state["jax_deploy"][key]
    before = TDW.dw_conv3x3_int8.launches
    got = TD.deploy_forward(state["gt"], state["td"], state["tsteps"],
                            torch.as_tensor(state["x"]), plan=pt,
                            device="cpu")
    assert TDW.dw_conv3x3_int8.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 10)
    assert _rel_mse(got.numpy(), want) <= 1e-8
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("env", [DW, DW_PACKED], ids=["dw", "dw+packed"])
def test_deploy_vs_sim_gap_matches_jax(state, monkeypatch, env):
    """The port's deploy-vs-sim logit gap (rel-MSE of deploy against its
    own sim forward with every act site on) equals the JAX package's own
    gap on the same state (MSE scales, the serving configuration) within
    1e-4 of it, with the same top-1 agreement. The two sims part by
    summation order only (rel-MSE about 1e-13), so the gaps agree to
    about 2e-6 of their value."""
    _set_env(monkeypatch, env)
    pj, pt = _plans(state)
    key = tuple(sorted(env.items()))
    if key not in state["jax_deploy"]:
        state["jax_deploy"][key] = np.asarray(JD.deploy_forward(
            state["g"], state["jd"], state["jsteps"],
            jnp.asarray(state["x"]), plan=pj))
    jdep = state["jax_deploy"][key]
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4)
    jflags = j_act_flags(state["g"], cfg,
                         base=ssq.Flags().all_weights(state["g"]))
    if "jax_sim" not in state:
        state["jax_sim"] = np.asarray(jax.jit(lambda x: ssq.forward(
            state["g"], state["params"], state["qs"], x, jflags))(
                jnp.asarray(state["x"])))
    jsim = state["jax_sim"]
    tflags = t_act_flags(state["gt"], tp.QuantConfig(n_bits_w=2, n_bits_a=4),
                         base=tp.Flags().all_weights(state["gt"]))
    x = torch.as_tensor(state["x"])
    tsim = tp.forward(state["gt"], state["tparams"], state["tqs"], x, tflags,
                      device="cpu").numpy()
    tdep = TD.deploy_forward(state["gt"], state["td"], state["tsteps"], x,
                             plan=pt, device="cpu").numpy()
    jgap, tgap = _rel_mse(jdep, jsim), _rel_mse(tdep, tsim)
    assert np.isfinite(tgap) and abs(tgap - jgap) <= 1e-4 * jgap, \
        (tgap, jgap)
    assert (tdep.argmax(-1) == tsim.argmax(-1)).sum() == \
        (jdep.argmax(-1) == jsim.argmax(-1)).sum()


def test_dw_units_launch_from_plan_constants(state, monkeypatch):
    """The serving plan holds each dw_int8 unit's launch constants, built
    once: the tap words unpack to the unit's codes, scalef is scale *
    delta_in, qp is [1/delta_out, zp_out, qmax] (one f32 division). A
    forward builds none of them again and gives the JAX deploy logits."""
    _set_env(monkeypatch, DW_PACKED)
    pj, pt = _plans(state)
    consts = pt["__kernel_consts__"]
    dw_units = sorted(n for n, (k, _) in _kinds(pt).items()
                      if k == "dw_int8")
    assert len(dw_units) == 16 and sorted(consts) == dw_units
    for name in dw_units:
        d, k = state["td"][name], consts[name]
        delta_in = state["tsteps"][pt[name][1]][0]
        delta_o, zp_o, n_bits = state["tsteps"][name]
        assert torch.equal(TDW.unpack_taps(k.w_taps),
                           d.w_int.reshape(-1, 3, 3).to(torch.int32))
        assert torch.equal(k.scalef, (d.scale * delta_in).float())
        np.testing.assert_array_equal(k.qp.numpy(), np.array(
            [np.float32(1) / np.float32(float(delta_o)), float(zp_o),
             2.0 ** n_bits - 1], np.float32))

    def rebuilt(*args, **kwargs):
        raise AssertionError("dw constants built during a forward")

    monkeypatch.setattr(TD, "prepare_dw", rebuilt)
    key = tuple(sorted(DW_PACKED.items()))
    if key not in state["jax_deploy"]:
        state["jax_deploy"][key] = np.asarray(JD.deploy_forward(
            state["g"], state["jd"], state["jsteps"],
            jnp.asarray(state["x"]), plan=pj))
    got = TD.deploy_forward(state["gt"], state["td"], state["tsteps"],
                            torch.as_tensor(state["x"]), plan=pt,
                            device="cpu")
    assert _rel_mse(got.numpy(), state["jax_deploy"][key]) <= 1e-8


def test_depthwise_integer_route_is_exact():
    """The plain depthwise accumulate that serves bf16_codes and int8
    units (the dw_conv_int8 kernel's plain version: pad -offset, offset *
    sum(w) added back) equals a grouped float64 conv of the centered codes
    (exact), for a biased feed (offset 128) and a centered one, strides 1
    and 2."""
    rng = np.random.default_rng(5)
    for stride, offset in ((1, 128), (2, 0), (2, 128), (1, 3)):
        spec = tp.UnitSpec(name="dw", kind="conv", in_ch=12, out_ch=12,
                           kernel=(3, 3), stride=(stride, stride),
                           padding=(1, 1), groups=12)
        xi = torch.as_tensor(rng.integers(-128, 128, (2, 9, 7, 12)),
                             dtype=torch.int8)
        w = torch.as_tensor(rng.integers(-2, 2, (12, 1, 3, 3)),
                            dtype=torch.int8)
        w_mat = TD._gemm_operand(w[None])
        got = TDC.dw_conv_int8(
            xi, w_mat, spec.kernel, spec.stride, spec.padding,
            pad_value=-offset,
            acc_offset=offset * w_mat.sum(dim=2, dtype=torch.int32))
        want = torch.nn.functional.conv2d(
            (xi.double() + offset).permute(0, 3, 1, 2), w.double(), None,
            stride, 1, 1, 12).permute(0, 2, 3, 1)
        assert got.dtype == torch.int32
        assert torch.equal(got.double(), want)
