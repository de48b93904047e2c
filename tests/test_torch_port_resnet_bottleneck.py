"""PyTorch port vs the JAX package: the deeper ResNets (34, 50, 101, 152)
and ResNet-50's Bottleneck blocks through the serving slice, on the CPU.

Graphs, torchvision key maps and reconstruction targets of every depth
and variant must be equal node by node. ResNet-50 (ImageNet variant at
32x32: the 7x7 stem and maxpool, every Bottleneck, layer4 at 1x1) is
made W2A4 by the JAX package with max scales snapped to powers of two
and calibrated on 1/8-grid images, in two states: uniform, and baked (the
method's fused quantizers, targets {1/2, 1}, seeded logit noise so both
candidates own channels, hardened), and carried to the port
(``utils/jax_import``). On 1/8-grid images the stem's convs (f32 in the
port, 2-pass bf16 in the JAX package) are exact and every code after it
is integer arithmetic, so the deploy traces hold equal integer codes at
every unit and node and the logits agree to the rounding of the float
head: rel-MSE <= 1e-8 and the same top-1, under the default switches and
under SSQ_STEM_KERNEL=1 SSQ_PACKED=1. Plans are equal unit by unit; their
kind counts at 224x224 are pinned (``chip_smoke.py`` holds the card's
plans to the same counts). The sim forward with power-of-two steps is
exact in both packages (every partial sum a short dyadic number):
rel-MSE <= 1e-10.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu import deploy as JD
from shiftedscalequantization_tpu import quantize as JQ
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.models import zoo as JZ
from shiftedscalequantization_tpu.recon import engine as JE
import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch import quantize as TQ
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

HW = 32
SWITCHES = ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
            "SSQ_DW_KERNEL")
ENVS = {"default": {},
        "stem+packed": {"SSQ_STEM_KERNEL": "1", "SSQ_PACKED": "1"}}
# the JAX package's plan kinds for ImageNet ResNet-50 W2A4 at 224x224 (8-bit
# stem and fc): chip_smoke.py's R50_KINDS
KINDS_224 = {
    ("uniform", "default"): {"bf16_codes": 10, "float": 1, "float_1p": 1,
                             "int8": 42},
    ("uniform", "stem+packed"): {"bf16_codes": 5, "float": 1, "int8": 13,
                                 "packed": 34, "stem_fused": 1},
    ("baked", "default"): {"bf16_codes": 10, "float": 1, "float_1p": 1,
                           "int8": 42},
    ("baked", "stem+packed"): {"bf16_codes": 10, "float": 1, "int8": 42,
                               "stem_fused": 1},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_mse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(((got - want) ** 2).mean() / (want ** 2).mean())


def _set_env(monkeypatch, env):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _kinds(plan):
    return {k: v for k, v in plan.items() if not k.startswith("__")}


def _counts(plan):
    kinds = [v[0] for v in _kinds(plan).values()]
    return {k: kinds.count(k) for k in sorted(set(kinds))}


@pytest.mark.parametrize("variant", ["imagenet", "cifar"])
@pytest.mark.parametrize("depth", [34, 50, 101, 152])
def test_graph_key_map_and_targets_match_jax(depth, variant):
    """Names, kernels, strides, paddings, channels, disable_aq, the
    downsamples and block wiring of every node; the torchvision key map;
    the reconstruction targets and the unit order."""
    gj = JR.build_resnet(depth, num_classes=1000, variant=variant)
    gt = tp.models.resnet.build_resnet(depth, num_classes=1000,
                                       variant=variant)
    assert [dataclasses.asdict(n) for n in gt] == \
        [dataclasses.asdict(n) for n in gj]
    assert tp.models.resnet.torch_key_map(gt) == JR.torch_key_map(gj)
    assert TQ.reconstruction_targets(gt) == JQ.reconstruction_targets(gj)
    assert TQ.unit_order(gt) == JQ.unit_order(gj)
    blocks = {34: 16, 50: 16, 101: 33, 152: 50}[depth]
    assert len(TQ.reconstruction_targets(gt)) == blocks + 1
    dataset = "imagenet" if variant == "imagenet" else "cifar10"
    zg, km = TZ.build(f"resnet{depth}", dataset=dataset)
    jzg, jkm = JZ.build(f"resnet{depth}", dataset=dataset)
    assert [dataclasses.asdict(n) for n in zg] == \
        [dataclasses.asdict(n) for n in jzg]
    assert km(zg) == jkm(jzg)


def _pow2(a):
    return jnp.asarray(2.0 ** np.round(np.log2(np.asarray(a))), jnp.float32)


def _dyadic(qs):
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


def _images(n, seed):
    x = np.round(np.random.default_rng(seed).normal(size=(n, HW, HW, 3)) * 8)
    return (x / 8).astype(np.float32)


def _raw(g, seed=0):
    """He-normal weights drawn with numpy in unit order, identity BN and
    zero linear bias, as the JAX package's init makes them (which draws op
    by op: 15 s for ResNet-50 on the CPU)."""
    rng = np.random.default_rng(seed)
    raw = {}
    for u in JQ.iter_units(g):
        shape = (u.out_ch, u.in_ch // u.groups, *u.kernel) \
            if u.kind == "conv" else (u.out_ch, u.in_ch)
        fan_in = int(np.prod(shape[1:]))
        w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        p = {"w": jnp.asarray(w, jnp.float32)}
        c = u.out_ch
        if u.has_bn:
            p["bn"] = {"gamma": jnp.ones(c), "beta": jnp.zeros(c),
                       "mean": jnp.zeros(c), "var": jnp.ones(c)}
        else:
            p["b"] = jnp.zeros(c)
        raw[u.name] = p
    return raw


@pytest.fixture(scope="module")
def base():
    g, _ = JZ.build("resnet50", num_classes=10)
    raw = _raw(g)
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          a_scale_method="max")
    params, qs = ssq.prepare_model(g, raw, cfg)
    qs = _dyadic(ssq.calibrate_acts(g, params, qs, jnp.asarray(_images(4, 1)),
                                    cfg))
    return g, cfg, params, qs


def _carry(g, params, qs):
    gt, _ = TZ.build("resnet50", num_classes=10)
    tparams = JI.params_from_numpy(_np(params), "cpu")
    tqs = JI.qstate_from_numpy(_np(qs), "cpu")
    return dict(g=g, params=params, qs=qs, gt=gt, tparams=tparams, tqs=tqs,
                jd=JD.build_deploy_params(g, params, qs),
                jsteps=JD.act_steps_from_qstate(g, qs),
                td=TD.build_deploy_params(gt, tparams, tqs, device="cpu"),
                tsteps=TD.act_steps_from_qstate(gt, tqs))


@pytest.fixture(scope="module", params=["uniform", "baked"])
def state(request, base):
    g, cfg, params, qs = base
    if request.param == "baked":
        names = JQ.unit_order(g)
        qs, theta = JE._init_quantizers(
            params, qs, names,
            JE.ReconSettings(mode="fused", shift_targets=(0.5, 1.0)))
        rng = np.random.default_rng(10)
        theta = {n: {k: v + rng.normal(size=v.shape).astype(np.float32)
                     for k, v in t.items()} for n, t in theta.items()}
        qs = JE._harden(JE._insert_theta(qs, theta), names, "fused")
    s = _carry(g, params, qs)
    s.update(kind=request.param, cfg=cfg)
    return s


def test_deploy_units_match_jax(state):
    """Integer codes (and the baked units' masked groups) exact; the f32
    epilogue terms the same expressions (rtol 1e-6); the act steps
    equal."""
    baked = 0
    for name, dj in state["jd"].items():
        dt = state["td"][name]
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
        baked += dt.w_groups is not None
    assert baked == {"uniform": 0, "baked": 52}[state["kind"]]
    assert set(state["tsteps"]) == set(state["jsteps"])
    for name, (d, z, n) in state["jsteps"].items():
        dt, zt, nt = state["tsteps"][name]
        assert nt == n and float(dt) == float(d) and float(zt) == float(z)


@pytest.mark.parametrize("env", list(ENVS))
def test_plan_matches_jax(state, monkeypatch, env):
    """Same kind and feeding site per unit and the same transport sets,
    at 32x32 and at 224x224; the 224 counts pinned."""
    _set_env(monkeypatch, ENVS[env])
    for hw in (HW, 224):
        pj = JD.make_deploy_plan(state["g"], state["jd"], state["jsteps"],
                                 input_hw=(hw, hw))
        pt = TD.make_deploy_plan(state["gt"], state["td"], state["tsteps"],
                                 input_hw=(hw, hw))
        assert _kinds(pt) == _kinds(pj)
        for key in ("__fused_stem__", "__int8_sites__", "__biased_sites__"):
            assert pt[key] == pj[key], key
        assert set(pt["__sum_steps__"]) == set(pj["__sum_steps__"])
    assert _counts(pj) == KINDS_224[(state["kind"], env)]


@pytest.mark.parametrize("env", list(ENVS))
def test_deploy_forward_matches_jax(state, monkeypatch, env):
    """The port's deploy against the JAX package's (Pallas kernels in
    interpret mode): equal values at every unit and node of the trace
    (integer codes), logits rel-MSE <= 1e-8, the same top-1. Requants
    left to elementwise ops: the float stem's under the default switches
    (as MobileNetV2's), none with the stem kernel."""
    _set_env(monkeypatch, dict(ENVS[env], SSQ_STEM_1PASS="0"))
    monkeypatch.setattr(TD.quantize_out, "unfused", 0)
    x = _images(4, 2)
    pj = JD.make_deploy_plan(state["g"], state["jd"], state["jsteps"],
                             input_hw=(HW, HW))
    jtrace, ttrace = [], []
    want = np.asarray(JD.deploy_forward(state["g"], state["jd"],
                                        state["jsteps"], jnp.asarray(x),
                                        plan=pj, trace=jtrace))
    pt = TD.make_deploy_plan(state["gt"], state["td"], state["tsteps"],
                             input_hw=(HW, HW))
    got = TD.deploy_forward(state["gt"], state["td"], state["tsteps"],
                            torch.as_tensor(x), plan=pt, device="cpu",
                            trace=ttrace).numpy()
    assert TD.quantize_out.unfused == (0 if env == "stem+packed" else 1)
    assert [n for n, _ in ttrace] == [n for n, _ in jtrace]
    assert len(ttrace) > 60
    for (name, tv), (_, jv) in zip(ttrace[:-1], jtrace[:-1]):
        np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv),
                                      err_msg=name)
    assert got.shape == (4, 10)
    assert _rel_mse(got, want) <= 1e-8
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_sim_forward_matches_jax(state):
    """The fake-quant sim forward with every weight and act site on."""
    x = _images(4, 3)
    jflags = JQ.act_flags(state["g"], state["cfg"],
                          base=ssq.Flags().all_weights(state["g"]))
    want = np.asarray(ssq.forward(state["g"], state["params"], state["qs"],
                                  jnp.asarray(x), jflags))
    tcfg = tp.QuantConfig(n_bits_w=2, n_bits_a=4)
    tflags = TQ.act_flags(state["gt"], tcfg,
                          base=tp.Flags().all_weights(state["gt"]))
    got = tp.forward(state["gt"], state["tparams"], state["tqs"],
                     torch.as_tensor(x), tflags, device="cpu").numpy()
    assert got.shape == (4, 10) and np.isfinite(got).all()
    assert _rel_mse(got, want) <= 1e-10
