"""PyTorch port vs the JAX package: MNASNet (graph, sim forward, deploy
plan, integer deploy forward with pair transport across its siteless
residual chains, the harmonized state with its ``__sum__`` sites), run on
the CPU. The port's CLI on MNASNet is in
``test_torch_port_cli_mnasnet.py``.

Weights are drawn once (the port's seeded init, as numpy) and handed to
both packages; quantizer state is made by the JAX package (max scales,
calibrated on 2 small 1/8-grid images) and carried to the port with
``utils/jax_import``. With every step snapped to a power of two both
packages compute identical values on such images; the plans are taken
on the unsnapped state, whose chains have unequal steps as a calibrated
net's do. The JAX side's deploy
params are the port's converted unit for unit (weight codes, scales, the
packed words repacked by the JAX package's own ``pack_codes``): the
conversion is the same code for every model and is held to the JAX
package in ``tests/test_torch_port_deploy.py``, ``_regnet.py`` and
``_mobilenetv2.py``, while the JAX package's eager conversion of
MNASNet's 53 units would take this file's time budget (one compile per
op and shape); ``test_deploy_conversion_matches_jax`` holds it on one
unit of each MNASNet kind. The JAX forwards run under jit, as the JAX
package serves them; its ``pair_stats`` are counted while it traces.
"""
import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu import deploy as JD
from shiftedscalequantization_tpu import quantize as JQ
from shiftedscalequantization_tpu.graph import iter_units as j_iter_units
from shiftedscalequantization_tpu.models import mnasnet as JM
from shiftedscalequantization_tpu.models import zoo as JZ
from shiftedscalequantization_tpu.ops.pallas.packed import \
    pack_codes as j_pack_codes
from shiftedscalequantization_tpu.quantize import act_flags as j_act_flags
import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch import quantize as TQ
from shiftedscalequantization_tpu_torch.graph import BlockSpec, iter_units
from shiftedscalequantization_tpu_torch.models import mnasnet as TM
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.ops.cuda import packed as TP
from shiftedscalequantization_tpu_torch.quantize import \
    act_flags as t_act_flags
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

# the JAX deploy module's switches (the port reads the first four and
# SSQ_PAIR_TERMS), cleared before each run of either package
SWITCHES = ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
            "SSQ_DW_KERNEL", "SSQ_PAIR_TRANSPORT", "SSQ_PAIR_TERMS",
            "SSQ_THIN_CHANNELS", "SSQ_THIN_MINHW", "SSQ_FLOAT_1PASS")
SERVING = {"SSQ_DW_KERNEL": "1", "SSQ_PACKED": "1"}
# ImageNet MNASNet W2A4 at 224x224 (chip_smoke.py phase 31 gates the
# same counts on the card): the plain state under the JAX package's
# defaults and under the serving switches, and the harmonized state
# (its chains' sums on int8 __sum__ sites) under the serving switches
KINDS_224 = {
    ("plain", "default"): {"float_1p": 1, "float": 11, "bf16_codes": 27,
                           "int8": 14},
    ("plain", "serving"): {"float_1p": 1, "float": 11, "dw_int8": 6,
                           "bf16_codes": 11, "packed": 24},
    ("harmonized", "default"): {"float_1p": 1, "float": 1,
                                "bf16_codes": 31, "int8": 20},
    ("harmonized", "serving"): {"float_1p": 1, "float": 1, "dw_int8": 6,
                                "bf16_codes": 11, "packed": 34},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _set_env(monkeypatch, **env):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_mse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(((got - want) ** 2).mean() / (want ** 2).mean())


def _kinds(plan):
    return {k: v for k, v in plan.items() if not k.startswith("__")}


def _counts(plan):
    kinds = [k for k, _ in _kinds(plan).values()]
    return {k: kinds.count(k) for k in set(kinds)}


def _images(n, hw, seed=1):
    x = np.random.default_rng(seed).normal(size=(n, hw, hw, 3))
    return (np.round(x * 8) / 8).astype(np.float32)


def _pow2(a):
    return jnp.asarray(2.0 ** np.round(np.log2(np.asarray(a))), jnp.float32)


def _dyadic(qs):
    """Every weight and act step snapped to the nearest power of two."""
    out = {}
    for name, v in qs.items():
        qp = dataclasses.replace(v.wq.qp, delta=_pow2(v.wq.qp.delta))
        aq = None if v.aq is None else \
            dataclasses.replace(v.aq, delta=_pow2(v.aq.delta))
        out[name] = dataclasses.replace(
            v, wq=dataclasses.replace(v.wq, qp=qp), aq=aq)
    return out


def _jax_units(graph, td):
    """The port's deploy params as the JAX package's DeployUnits."""
    pack = jax.jit(j_pack_codes, static_argnums=1)

    def arr(t):
        return None if t is None else jnp.asarray(t.numpy())

    out = {}
    for u in iter_units(graph):
        d = td[u.name]
        packed = None
        if d.w_packed is not None:
            k = d.w_mat.shape[2]
            packed = pack(jnp.asarray(TP.unpack_codes(
                d.w_packed, d.w_pack_bits, k).numpy()), d.w_pack_bits)
        out[u.name] = JD.DeployUnit(
            w_int=arr(d.w_int), w_fp=arr(d.w_fp), scale=arr(d.scale),
            bias=arr(d.bias), w_groups=arr(d.w_groups),
            group_scales=arr(d.group_scales), w_packed=packed,
            w_pack_zp=arr(d.w_pack_zp), w_pack_bits=d.w_pack_bits)
    return out


_BASE = {}


def _state(variant, snap=True):
    """JAX-made W2A4 state of MNASNet (``variant``: cifar at 32x32 or
    imagenet, 10 classes), plain and harmonized, in both packages; with
    ``snap`` every step a power of two."""
    if (variant, snap) not in _BASE:
        g = JM.build_mnasnet(2.0, 10, variant)
        gt = TM.build_mnasnet(2.0, 10, variant)
        raw = jax.tree.map(lambda t: t.numpy(),
                           TZ.init_params(gt, seed=0, device="cpu"))
        cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                              a_scale_method="max")
        params, qs = ssq.prepare_model(
            g, jax.tree.map(jnp.asarray, raw), cfg)
        x = _images(8, 32)
        qs = ssq.calibrate_acts(g, params, qs, jnp.asarray(x[:2]), cfg)
        if snap:
            qs = _dyadic(qs)
        qs_h, ratios = JQ.harmonize_residual_chains(g, qs)
        tparams = JI.params_from_numpy(_np(params), "cpu")
        td = TD.build_deploy_params(gt, tparams, JI.qstate_from_numpy(
            _np(qs), "cpu"), device="cpu")
        jd = _jax_units(gt, td)
        s = dict(g=g, gt=gt, cfg=cfg, params=params, tparams=tparams, x=x,
                 td=td, jd=jd, ratios=ratios,
                 tcfg=tp.QuantConfig(n_bits_w=2, n_bits_a=4))
        for name, q in (("plain", qs), ("harmonized", qs_h)):
            tqs = JI.qstate_from_numpy(_np(q), "cpu")
            s[name] = dict(qs=q, tqs=tqs,
                           jsteps=JD.act_steps_from_qstate(g, q),
                           tsteps=TD.act_steps_from_qstate(gt, tqs))
        _BASE[(variant, snap)] = s
    return _BASE[(variant, snap)]


# ---------------------------------------------------------------------------
# graph and registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset", ["imagenet", "synth10"])
def test_graph_and_key_map_match_jax(dataset):
    """Both variants through the zoo: the same nodes and unit specs, the
    same torch key map and depths; 17 depthwise units, 10 of them 5x5;
    siteless residual blocks (block_act_quant=False)."""
    gj, kj = JZ.build("mnasnet", dataset=dataset)
    gt, kt = TZ.build("mnasnet", dataset=dataset)
    assert [dataclasses.asdict(n) for n in gt] == \
        [dataclasses.asdict(n) for n in gj]
    assert kt(gt) == kj(gj) == TM.torch_key_map(gt)
    for scale in (0.5, 1.0, 2.0):
        assert TM._get_depths(scale) == JM._get_depths(scale)
    assert gt == (TM.build_mnasnet(2.0, 10, "cifar") if dataset == "synth10"
                  else TM.build_mnasnet(2.0, 1000, "imagenet"))
    dw = [u for u in iter_units(gt) if u.groups == u.in_ch > 1]
    assert len(dw) == 17 and sum(u.kernel == (5, 5) for u in dw) == 10
    blocks = [n for n in gt if isinstance(n, BlockSpec)]
    assert len(blocks) == 16
    assert not any(b.block_act_quant for b in blocks)
    assert sum(b.residual for b in blocks) == 10


def test_zoo_builds_mnasnet_at_scale_2():
    assert TZ.ARCHS == JZ.ARCHS
    gt, _ = TZ.build("mnasnet")
    assert gt == TM.build_mnasnet(2.0, 1000, "imagenet")
    assert gt[-1].out_ch == 1000
    raw = TZ.init_params(gt, seed=0, device="cpu")
    for u in iter_units(gt):
        assert tuple(raw[u.name]["w"].shape) == (
            (u.out_ch, u.in_ch // u.groups, *u.kernel) if u.kind == "conv"
            else (u.out_ch, u.in_ch))


# ---------------------------------------------------------------------------
# sim forward
# ---------------------------------------------------------------------------

def test_sim_forward_matches_jax():
    """CIFAR variant at 32x32: the W2A4 fake-quant forward (every weight
    and act quantizer on) of the plain state against the JAX package,
    rel-MSE <= 1e-8 (grid images, power-of-two steps)."""
    s = _state("cifar")
    st = s["plain"]
    flags = j_act_flags(s["g"], s["cfg"], base=ssq.Flags().all_weights(
        s["g"]))
    tflags = t_act_flags(s["gt"], s["tcfg"],
                         base=tp.Flags().all_weights(s["gt"]))
    assert (tflags.weight_on, tflags.act_on) == (flags.weight_on,
                                                 flags.act_on)
    want = _jax_sim(s, "plain")
    got = tp.forward(s["gt"], s["tparams"], st["tqs"],
                     torch.as_tensor(s["x"]), tflags, device="cpu")
    assert tuple(got.shape) == want.shape == (8, 10)
    assert _rel_mse(got.numpy(), want) <= 1e-8


# ---------------------------------------------------------------------------
# deploy conversion and plan
# ---------------------------------------------------------------------------

def test_deploy_conversion_matches_jax():
    """The JAX package's own conversion on one unit of each MNASNet kind
    (the 8-bit stem, a 5x5 depthwise, a W2 1x1 with packed words, the
    8-bit classifier) equals the port's: codes exact, scales rtol 1e-6."""
    s = _state("cifar")
    names = ("model.layers.0", "model.layers.9.1.layers.3",
             "model.layers.9.1.layers.6", "model.classifier.1")
    sub = tuple(u for u in j_iter_units(s["g"]) if u.name in names)
    jd = JD.build_deploy_params(sub, s["params"], s["plain"]["qs"])
    assert set(jd) == set(names)
    for n in names:
        dj, dt = jd[n], s["td"][n]
        for f in ("w_int", "w_fp", "w_groups"):
            a, b = getattr(dt, f), getattr(dj, f)
            assert (a is None) == (b is None), (n, f)
            if b is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(dt.scale.numpy(), np.asarray(dj.scale),
                                   rtol=1e-6)
        assert (dt.w_packed is None) == (dj.w_packed is None), n
        if dj.w_packed is not None:
            np.testing.assert_array_equal(np.asarray(s["jd"][n].w_packed),
                                          np.asarray(dj.w_packed))


@pytest.mark.parametrize("state,env", [
    ("plain", "default"), ("plain", "serving"), ("harmonized", "default"),
    ("harmonized", "serving"), ("plain", "stem")])
def test_plan_matches_jax_224(state, env, monkeypatch):
    """ImageNet variant, plan at 224x224: the same kind and feeding site
    per unit, the same int8, biased and sum sites as the JAX package,
    under its defaults, the serving switches (SSQ_DW_KERNEL=1
    SSQ_PACKED=1) and the stem switches (SSQ_STEM_KERNEL=1,
    SSQ_STEM_1PASS=0); the counts pinned where chip_smoke.py gates
    them."""
    _set_env(monkeypatch, **{
        "default": {}, "serving": SERVING,
        "stem": {"SSQ_STEM_KERNEL": "1", "SSQ_STEM_1PASS": "0"}}[env])
    s = _state("imagenet", snap=False)
    st = s[state]
    pj = JD.make_deploy_plan(s["g"], s["jd"], st["jsteps"],
                             input_hw=(224, 224))
    pt = TD.make_deploy_plan(s["gt"], s["td"], st["tsteps"],
                             input_hw=(224, 224))
    assert _kinds(pt) == _kinds(pj)
    for key in ("__int8_sites__", "__biased_sites__"):
        assert pt[key] == pj[key], key
    assert set(pt["__sum_steps__"]) == set(pj["__sum_steps__"])
    assert len(pt["__sum_steps__"]) == (10 if state == "harmonized" else 0)
    if (state, env) in KINDS_224:
        assert _counts(pt) == KINDS_224[(state, env)]
    if env == "stem":
        # the 3x3 stem fits no stem_fused kernel and keeps the 2-pass route
        assert _counts(pt)["float"] == 12 and "float_1p" not in _counts(pt)


# ---------------------------------------------------------------------------
# integer deploy forward, pair transport
# ---------------------------------------------------------------------------

_JAX_RUNS = {}


def _jax_sim(s, state):
    """The JAX package's jitted sim forward (all quantizers on) of a
    state on the 8 grid images."""
    key = (id(s), state, "sim")
    if key not in _JAX_RUNS:
        flags = j_act_flags(s["g"], s["cfg"],
                            base=ssq.Flags().all_weights(s["g"]))
        _JAX_RUNS[key] = np.asarray(jax.jit(lambda x: ssq.forward(
            s["g"], s["params"], s[state]["qs"], x, flags))(
                jnp.asarray(s["x"])))
    return _JAX_RUNS[key]


def _jax_deploy(s, st, plan):
    """The JAX package's jitted deploy forward on the 8 grid images: its
    logits, its per-unit trace and the pair_stats of its trace (one run
    per state, plan and switches)."""
    key = (id(st), tuple(sorted(_kinds(plan).items())),
           tuple(os.environ.get(k) for k in SWITCHES))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_deploy_run(s, st, plan)
    return _JAX_RUNS[key]


def _jax_deploy_run(s, st, plan):
    names = []

    def f(x):
        tr = []
        y = JD.deploy_forward(s["g"], s["jd"], st["jsteps"], x, plan=plan,
                              trace=tr)
        names.extend(n for n, _ in tr)
        return y, [a for _, a in tr]

    y, arrs = jax.jit(f)(jnp.asarray(s["x"]))
    return np.asarray(y), list(zip(names, map(np.asarray, arrs))), \
        dict(JD.pair_stats)


# (state, SSQ_PAIR_TERMS, pairs formed): cap 2 forms one pair in each of
# the five stacks with a residual, cap 3 lets the three-deep and
# four-deep chains defer once more, cap 0 forms none (the exact f32
# fallback everywhere)
PAIR_CASES = [("plain", "2", 5), ("plain", "3", 8), ("plain", "0", 0),
              ("harmonized", "2", 0)]


@pytest.mark.parametrize("state,terms,formed", PAIR_CASES)
def test_deploy_forward_matches_jax(state, terms, formed, monkeypatch):
    """CIFAR variant, 8 grid images, plan at 32x32 under the JAX
    package's defaults: the port's deploy logits against the JAX
    package's, rel-MSE <= 1e-8 and the same top-1; pair_stats equal to
    the JAX package's; every traced node and unit equal up to the float
    head (the trace names the first unit where the two part)."""
    # the cap's default is 2
    _set_env(monkeypatch, **({} if terms == "2" else
                             {"SSQ_PAIR_TERMS": terms}))
    s = _state("cifar")
    st = s[state]
    pj = JD.make_deploy_plan(s["g"], s["jd"], st["jsteps"],
                             input_hw=(32, 32))
    pt = TD.make_deploy_plan(s["gt"], s["td"], st["tsteps"],
                             input_hw=(32, 32))
    assert _kinds(pt) == _kinds(pj)
    want, jtrace, jstats = _jax_deploy(s, st, pj)
    trace = []
    got = TD.deploy_forward(s["gt"], s["td"], st["tsteps"],
                            torch.as_tensor(s["x"]), plan=pt, device="cpu",
                            trace=trace)
    assert dict(TD.pair_stats) == jstats
    assert jstats == {"formed": formed,
                      "consumed_fast": formed if terms == "2" else
                      jstats["consumed_fast"]}
    assert [n for n, _ in trace] == [n for n, _ in jtrace]
    for (name, a), (_, b) in zip(trace, jtrace):
        if name == "model.classifier.1":
            break
        assert np.array_equal(a.numpy(), b), f"first parts at {name}"
    assert tuple(got.shape) == want.shape == (8, 10)
    assert _rel_mse(got.numpy(), want) <= 1e-8
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    # the traced forward runs the same codes as the untraced one
    assert torch.equal(got, TD.deploy_forward(
        s["gt"], s["td"], st["tsteps"], torch.as_tensor(s["x"]), plan=pt,
        device="cpu"))


def test_pair_transport_switch_and_consumers(monkeypatch):
    """SSQ_PAIR_TERMS 0 or 1 forms no pair and gives the f32 fallback's
    logits (equal, exact sums on grid images); every pair-fed consumer
    runs one int8_conv per term (consumed_fast == formed at cap 2), and
    its requant stays elementwise."""
    s = _state("cifar")
    st = s["plain"]
    x = torch.as_tensor(s["x"])
    out = {}
    for env in ({"SSQ_PAIR_TERMS": "2"}, {"SSQ_PAIR_TERMS": "0"},
                {"SSQ_PAIR_TERMS": "1"}):
        _set_env(monkeypatch, **env)
        plan = TD.make_deploy_plan(s["gt"], s["td"], st["tsteps"],
                                   input_hw=(32, 32))
        TD.quantize_out.unfused = 0
        y = TD.deploy_forward(s["gt"], s["td"], st["tsteps"], x, plan=plan,
                              device="cpu")
        out[tuple(env.items())] = (y, dict(TD.pair_stats),
                                   TD.quantize_out.unfused)
    (y2, s2, u2), (y0, s0, u0), (y1, s1, u1) = out.values()
    assert s2 == {"formed": 5, "consumed_fast": 5}
    assert s0 == s1 == {"formed": 0, "consumed_fast": 0}
    assert torch.equal(y0, y1)
    assert _rel_mse(y2.numpy(), y0.numpy()) <= 1e-12
    # each pair's consumer requants elementwise, as the f32 edge's did
    assert u2 == u0


@pytest.mark.parametrize("state", ["plain", "harmonized"])
def test_deploy_vs_sim_gap_matches_jax(state, monkeypatch):
    """The port's deploy-vs-sim logit gap equals the JAX package's own
    gap on the same state (rel 1e-9), with the same top-1 agreement. On
    grid images with power-of-two steps many requant inputs fall on .5
    ties, where deploy rounds half up and sim half to even, so this gap
    is large in both packages; each package's deploy and sim are those
    of the other bit for bit (test_deploy_forward_matches_jax,
    test_sim_forward_matches_jax), and the realistic gap is chip_smoke's
    (MSE scales, random images), held beside mnasnet_parity_gap.py's."""
    _set_env(monkeypatch)
    s = _state("cifar")
    st = s[state]
    tflags = t_act_flags(s["gt"], s["tcfg"],
                         base=tp.Flags().all_weights(s["gt"]))
    jsim = _jax_sim(s, state)
    pj = JD.make_deploy_plan(s["g"], s["jd"], st["jsteps"],
                             input_hw=(32, 32))
    jdep = _jax_deploy(s, st, pj)[0]
    x = torch.as_tensor(s["x"])
    tsim = tp.forward(s["gt"], s["tparams"], st["tqs"], x, tflags,
                      device="cpu").numpy()
    plan = TD.make_deploy_plan(s["gt"], s["td"], st["tsteps"],
                               input_hw=(32, 32))
    tdep = TD.deploy_forward(s["gt"], s["td"], st["tsteps"], x, plan=plan,
                             device="cpu").numpy()
    jgap, tgap = _rel_mse(jdep, jsim), _rel_mse(tdep, tsim)
    assert np.isfinite(tgap) and abs(tgap - jgap) <= 1e-9 * jgap, \
        (tgap, jgap)
    assert (tdep.argmax(-1) == tsim.argmax(-1)).sum() == \
        (jdep.argmax(-1) == jsim.argmax(-1)).sum()


def test_packed_units_take_sum_codes_as_they_are(monkeypatch):
    """Harmonized state under SSQ_PACKED=1: the port's packed units read
    a __sum__ site's codes as they are, so its logits equal those of its
    integer units under the defaults bit for bit (exact sums on grid
    images). The JAX package's packed kernel re-quantizes its input with
    the sum site's zero point 0 and the base grid's bits, clipping the
    sum codes: its logits part from its defaults at the first packed unit
    fed by a __sum__ site (a fault of the reference, ROADMAP queue 3), and
    the port holds to sim there, to the JAX package at its defaults."""
    s = _state("cifar")
    st = s["harmonized"]
    x = torch.as_tensor(s["x"])
    out = {}
    for env in ({}, {"SSQ_PACKED": "1"}):
        _set_env(monkeypatch, **env)
        pt = TD.make_deploy_plan(s["gt"], s["td"], st["tsteps"],
                                 input_hw=(32, 32))
        pj = JD.make_deploy_plan(s["g"], s["jd"], st["jsteps"],
                                 input_hw=(32, 32))
        assert _kinds(pt) == _kinds(pj)
        trace = []
        y = TD.deploy_forward(s["gt"], s["td"], st["tsteps"], x, plan=pt,
                              device="cpu", trace=trace)
        out[bool(env)] = (pt, y, trace, _jax_deploy(s, st, pj))
    (_, y0, tr0, (j0, jt0, _)), (pt, y1, tr1, (j1, jt1, _)) = \
        out[False], out[True]
    fed = [n for n, (k, site) in _kinds(pt).items()
           if k == "packed" and site.endswith("__sum__")]
    assert fed
    assert torch.equal(y1, y0)
    assert _rel_mse(y0.numpy(), j0) <= 1e-8
    parted = next(n for (n, a), (_, b) in zip(jt1, jt0)
                  if not np.array_equal(a, b))
    assert parted in fed
    assert _rel_mse(j1, j0) > 1e-2


def test_harmonized_state_matches_port_harmonize():
    """The port's harmonize_residual_chains on the carried plain state
    gives the JAX package's harmonized steps and ratios (10 chain sites
    re-stepped), and the port's plan makes one int8 __sum__ site per
    residual block."""
    s = _state("cifar")
    qs, ratios = TQ.harmonize_residual_chains(s["gt"], s["plain"]["tqs"])
    assert ratios.keys() == s["ratios"].keys()
    for k, v in s["ratios"].items():
        assert ratios[k] == pytest.approx(float(v), rel=1e-12)
    want = s["harmonized"]["tsteps"]
    got = TD.act_steps_from_qstate(s["gt"], qs)
    for k, (d, z, n) in want.items():
        assert torch.equal(got[k][0], d) and torch.equal(got[k][1], z) \
            and got[k][2] == n, k
    plan = TD.make_deploy_plan(s["gt"], s["td"], got, input_hw=(32, 32))
    sums = plan["__sum_steps__"]
    assert len(sums) == 10 and sums.keys() <= plan["__int8_sites__"]
