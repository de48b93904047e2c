"""PyTorch port vs the JAX package: RegNetX (graph, trained weights, sim
forward, deploy conversion, plan, integer deploy forward, and one fused
reconstruction of a block with a grouped conv), run on the CPU; and the
``int8_pair`` plan kind on ResNet-18 W4A8.

Weights are drawn once (the port's seeded init, as numpy) and handed to
both packages; quantizer state is made by the JAX package and carried to
the port with ``utils/jax_import``. Scales are set by the max rule, which
gives every site the zero point the MSE rule gives it (post-relu sites
are unsigned either way), so the plans are the ones the MSE rule would
give; calibration runs on 2 small images, since a plan depends only on
each site's bits and zero point and the units' shapes (it is made at
224x224). On 1/8-grid images with steps snapped to powers of two both
packages compute identical values (see test_torch_port_model.py), and
the integer deploy paths agree to the rounding of the float head.
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
from shiftedscalequantization_tpu.models import regnet as JRG
from shiftedscalequantization_tpu.models import zoo as JZ
from shiftedscalequantization_tpu.quantize import act_flags as j_act_flags
from shiftedscalequantization_tpu.quantize import unit_order
from shiftedscalequantization_tpu.recon import capture as JC
from shiftedscalequantization_tpu.recon import engine as JE
from shiftedscalequantization_tpu.train import load_raw_params as j_load_raw
import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch.graph import BlockSpec, iter_units
from shiftedscalequantization_tpu_torch.models import regnet as TRG
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.recon import capture as TC
from shiftedscalequantization_tpu_torch.quantize import \
    act_flags as t_act_flags
from shiftedscalequantization_tpu_torch.recon import engine as TE
from shiftedscalequantization_tpu_torch.train import load_raw_params
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "trained_regnetx_600m_synth10.npz")
SWITCHES = ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
            "SSQ_DW_KERNEL")
REGNETS = sorted(JRG.CONFIGS)
# RegNetX-600M at 224x224 under the JAX package's defaults (its plan on
# the CPU, and chip_smoke.py's gate on the card)
KINDS_600M = {
    "uniform": {"float_1p": 1, "float": 1, "int8_bd": 4, "int8": 30,
                "bf16_codes": 18},
    "baked": {"float_1p": 1, "float": 1, "int8": 34, "bf16_codes": 18},
    "w4a8": {"float_1p": 1, "float": 1, "int8_pair": 24, "bf16_codes": 28}}


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


def _set_env(monkeypatch, **env):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


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
        if isinstance(v, ssq.UnitQuant):
            qp = dataclasses.replace(v.wq.qp, delta=_pow2(v.wq.qp.delta))
            aq = None if v.aq is None else \
                dataclasses.replace(v.aq, delta=_pow2(v.aq.delta))
            out[name] = dataclasses.replace(
                v, wq=dataclasses.replace(v.wq, qp=qp), aq=aq)
        else:
            out[name] = dataclasses.replace(v, delta=_pow2(v.delta))
    return out


def _raw(arch, dataset, num_classes=None):
    """The port's seeded init as a numpy tree, handed to both packages."""
    gt, _ = TZ.build(arch, num_classes=num_classes, dataset=dataset)
    raw = TZ.init_params(gt, seed=0, device="cpu")
    return jax.tree.map(lambda t: t.numpy(), raw)


def _baked(g, params, qs, seed=10):
    """The method's fused quantizers (targets {1/2, 1}) with seeded noise
    on their logits, as a trained state would have them (every candidate
    owns channels), hardened to the baked form."""
    names = unit_order(g)
    qs, theta = JE._init_quantizers(
        params, qs, names, JE.ReconSettings(mode="fused",
                                            shift_targets=(0.5, 1.0)))
    rng = np.random.default_rng(seed)
    theta = {n: {k: v + rng.normal(size=v.shape).astype(np.float32)
                 for k, v in t.items()} for n, t in theta.items()}
    return JE._harden(JE._insert_theta(qs, theta), names, "fused")


_BASE = {}


def _state(arch, dataset, nbw, nba, hw, baked=False, n=2, snap=False,
           num_classes=None):
    """JAX-made state (max scales, calibrated on n grid images; the
    uniform and baked states of one setting share it) and its deploy
    conversion in both packages."""
    key = (arch, dataset, nbw, nba, hw, n, snap, num_classes)
    if key not in _BASE:
        g, _ = JZ.build(arch, num_classes=num_classes, dataset=dataset)
        raw = jax.tree.map(jnp.asarray, _raw(arch, dataset, num_classes))
        cfg = ssq.QuantConfig(n_bits_w=nbw, n_bits_a=nba,
                              w_scale_method="max", a_scale_method="max")
        params, qs = ssq.prepare_model(g, raw, cfg)
        x = _images(n, hw)
        qs = ssq.calibrate_acts(g, params, qs, jnp.asarray(x), cfg)
        _BASE[key] = (g, cfg, params, _dyadic(qs) if snap else qs, x)
    g, cfg, params, qs, x = _BASE[key]
    if baked:
        qs = _baked(g, params, qs)
    gt, _ = TZ.build(arch, num_classes=num_classes, dataset=dataset)
    tparams = JI.params_from_numpy(_np(params), "cpu")
    tqs = JI.qstate_from_numpy(_np(qs), "cpu")
    return dict(g=g, params=params, qs=qs, x=x, gt=gt, tparams=tparams,
                tqs=tqs, cfg=cfg,
                tcfg=tp.QuantConfig(n_bits_w=nbw, n_bits_a=nba),
                jd=JD.build_deploy_params(g, params, qs),
                jsteps=JD.act_steps_from_qstate(g, qs),
                td=TD.build_deploy_params(gt, tparams, tqs, device="cpu"),
                tsteps=TD.act_steps_from_qstate(gt, tqs))


# ---------------------------------------------------------------------------
# graph, registry, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", REGNETS)
def test_graph_and_key_map_match_jax(arch):
    """Every X config, both variants: the same nodes and unit specs, the
    same torch key map, and the same parameter shapes."""
    for dataset in ("imagenet", "synth10"):
        gj, kj = JZ.build(arch, dataset=dataset)
        gt, kt = TZ.build(arch, dataset=dataset)
        assert [dataclasses.asdict(n) for n in gt] == \
            [dataclasses.asdict(n) for n in gj]
        assert kt(gt) == kj(gj) == TRG.torch_key_map(gt)
        blocks = [n for n in gt if isinstance(n, BlockSpec)]
        want = {"regnetx_600m": 16, "regnetx_3200m": 25}.get(arch)
        if want is not None:
            assert len(blocks) == want
        # every block has a grouped 3x3 f.b whose group width is the
        # config's (or the whole width where that is narrower)
        gw = JRG.CONFIGS[arch]["GROUP_W"]
        for blk in blocks:
            fb = blk.units[1]
            assert fb.kernel == (3, 3) and fb.in_ch // fb.groups == \
                min(gw, fb.in_ch)
        raw = TZ.init_params(gt, seed=0, device="cpu")
        for u in iter_units(gt):
            cg = u.in_ch // u.groups
            assert tuple(raw[u.name]["w"].shape) == (
                (u.out_ch, cg, *u.kernel) if u.kind == "conv"
                else (u.out_ch, u.in_ch))
    assert TRG.generate_regnet(36.97, 48, 2.24, 16) == \
        JRG.generate_regnet(36.97, 48, 2.24, 16)


def test_zoo_registry():
    assert [a for a in TZ.ARCHS if a.startswith("regnetx")] == \
        [a for a in JZ.ARCHS if a.startswith("regnetx")]
    assert TZ.ARCHS == JZ.ARCHS
    gt, kt = TZ.build("mnasnet")
    gj, kj = JZ.build("mnasnet")
    assert [dataclasses.asdict(n) for n in gt] == \
        [dataclasses.asdict(n) for n in gj]
    assert kt(gt) == kj(gj)
    with pytest.raises(ValueError):
        TZ.build("regnety_600m")


def test_trained_npz_carries_every_array():
    """The trained RegNetX-600M (CIFAR variant, synth10) npz: its 267
    arrays load into the port as the JAX package loads them, cover every
    unit of the graph at its shape, and carry across jax_import
    unchanged."""
    with np.load(TRAINED) as f:
        assert len(f.files) == 267
    raw = load_raw_params(TRAINED, device="cpu")
    jraw = j_load_raw(TRAINED)
    gt, _ = TZ.build("regnetx_600m", dataset="synth10")
    assert set(raw) == {u.name for u in iter_units(gt)} == set(jraw)
    carried = JI.params_from_numpy(_np(jraw), "cpu")
    n = 0
    for u in iter_units(gt):
        assert set(raw[u.name]) == set(jraw[u.name])
        assert tuple(raw[u.name]["w"].shape) == (
            (u.out_ch, u.in_ch // u.groups, *u.kernel)
            if u.kind == "conv" else (u.out_ch, u.in_ch))
        for k, v in jraw[u.name].items():
            leaves = v.items() if isinstance(v, dict) else [(None, v)]
            for kk, arr in leaves:
                got = raw[u.name][k] if kk is None else raw[u.name][k][kk]
                via = carried[u.name][k] if kk is None \
                    else carried[u.name][k][kk]
                np.testing.assert_array_equal(got.numpy(), np.asarray(arr))
                assert torch.equal(got, via)
                n += 1
    assert n == 267


# ---------------------------------------------------------------------------
# sim forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [None, (2, 4)], ids=["fp", "w2a4"])
def test_sim_forward_matches_jax(bits):
    """regnetx_200m, CIFAR variant at 16x16: the FP forward of the folded
    params and the W2A4 fake-quant forward (all weight and act quantizers
    on) against the JAX package, rel-MSE <= 1e-8 (1/8-grid images, steps
    snapped to powers of two: identical values on both sides)."""
    nbw, nba = bits or (4, 8)
    g, _ = JZ.build("regnetx_200m", dataset="cifar10")
    raw = jax.tree.map(jnp.asarray, _raw("regnetx_200m", "cifar10"))
    cfg = ssq.QuantConfig(n_bits_w=nbw, n_bits_a=nba, w_scale_method="max",
                          a_scale_method="max")
    params, qs = ssq.prepare_model(g, raw, cfg)
    x = _images(4, 16)
    flags, tflags = ssq.Flags(), tp.Flags()
    gt, _ = TZ.build("regnetx_200m", dataset="cifar10")
    if bits is not None:
        qs = _dyadic(ssq.calibrate_acts(g, params, qs, jnp.asarray(x), cfg))
        flags = j_act_flags(g, cfg, base=ssq.Flags().all_weights(g))
        tflags = t_act_flags(gt, tp.QuantConfig(n_bits_w=nbw, n_bits_a=nba),
                             base=tp.Flags().all_weights(gt))
        assert (tflags.weight_on, tflags.act_on) == (flags.weight_on,
                                                     flags.act_on)
    want = np.asarray(jax.jit(
        lambda x: ssq.forward(g, params, qs, x, flags))(jnp.asarray(x)))
    got = tp.forward(gt, JI.params_from_numpy(_np(params), "cpu"),
                     JI.qstate_from_numpy(_np(qs), "cpu"), torch.as_tensor(x),
                     tflags, device="cpu")
    assert tuple(got.shape) == (4, 10)
    assert _rel_mse(got.numpy(), want) <= 1e-8


# ---------------------------------------------------------------------------
# RegNetX-600M at full width: deploy conversion and plan
# ---------------------------------------------------------------------------

_600M = {}


def _state_600m(kind):
    if kind not in _600M:
        _600M[kind] = _state("regnetx_600m", "imagenet",
                             *((4, 8) if kind == "w4a8" else (2, 4)), hw=32,
                             baked=kind == "baked")
    return _600M[kind]


@pytest.mark.parametrize("env", [{}, {"SSQ_PACKED": "1"}],
                         ids=["default", "packed"])
@pytest.mark.parametrize("kind", list(KINDS_600M))
def test_plan_matches_jax_600m(kind, env, monkeypatch):
    """RegNetX-600M at full width, plan at 224x224: the same kind and
    feeding site per unit as the JAX package, under its defaults and with
    SSQ_PACKED=1; the kind counts pinned under the defaults (uniform: 4
    int8_bd, 12 grouped units on the grouped kernel; baked: none
    densified, all 16 f.b grouped)."""
    _set_env(monkeypatch, **env)
    s = _state_600m(kind)
    pj = JD.make_deploy_plan(s["g"], s["jd"], s["jsteps"],
                             input_hw=(224, 224))
    pt = TD.make_deploy_plan(s["gt"], s["td"], s["tsteps"],
                             input_hw=(224, 224))
    assert _kinds(pt) == _kinds(pj)
    for key in ("__int8_sites__", "__biased_sites__"):
        assert pt[key] == pj[key], key
    fb = [pt[u.name][0] for u in iter_units(s["gt"]) if u.groups > 1]
    assert len(fb) == 16
    if not env:
        assert _counts(pt) == KINDS_600M[kind]
        if kind == "uniform":
            assert fb.count("int8_bd") == 4
            assert fb.count("int8") + fb.count("bf16_codes") == 12
        else:
            assert fb.count("int8") + fb.count("bf16_codes") == 16
    else:
        assert "packed" in _counts(pt) or kind != "uniform"


@pytest.mark.parametrize("kind", list(KINDS_600M))
def test_deploy_params_match_jax_600m(kind):
    """Integer codes, the masked weight groups of baked units (their shift
    index one entry per input channel of a conv group) and the dense
    block-diagonal int8_bd operand (JAX w_int_bd) exact; scales rtol
    1e-6."""
    s = _state_600m(kind)
    n_bd = 0
    for u in iter_units(s["gt"]):
        dj, dt = s["jd"][u.name], s["td"][u.name]
        for f in ("w_int", "w_fp", "w_groups"):
            a, b = getattr(dt, f), getattr(dj, f)
            assert (a is None) == (b is None), (u.name, f)
            if b is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(dt.scale.numpy(), np.asarray(dj.scale),
                                   rtol=1e-6)
        assert (dt.w_bd is None) == (dj.w_int_bd is None), u.name
        if dj.w_int_bd is not None:
            n_bd += 1
            want = TD._gemm_operand(torch.as_tensor(
                np.array(dj.w_int_bd))[None])
            assert torch.equal(dt.w_bd, want)
            assert torch.equal(dt.w_bd.sum(dim=2, dtype=torch.int32),
                               dt.w_sum)
        wq = s["tqs"][u.name].wq
        if kind == "baked" and u.groups > 1 and dt.w_groups is not None:
            assert tuple(wq.st_index.shape) == (u.in_ch // u.groups,)
            assert tuple(dt.w_groups.shape[:3]) == (
                2, u.out_ch, u.in_ch // u.groups)
    assert n_bd == (4 if kind in ("uniform", "w4a8") else 0)


# ---------------------------------------------------------------------------
# integer deploy forward
# ---------------------------------------------------------------------------

DEPLOY_CASES = {
    # regnetx_200m at the 224 plan: int8_bd (s1, s2), grouped int8 (s3,
    # s4.b1) and grouped bf16_codes (s4's 7px units)
    "regnetx_200m-uniform": ("regnetx_200m", "imagenet", (2, 4), False, 32),
    "regnetx_200m-baked": ("regnetx_200m", "imagenet", (2, 4), True, 32),
    # int8_pair: the 8-bit unsigned feeds of ResNet-18's wide units
    "resnet18-w4a8": ("resnet18", "cifar10", (4, 8), False, 32),
    # A8 RegNet: grouped bf16_codes fed biased codes (offset 128)
    "regnetx_200m-w4a8": ("regnetx_200m", "imagenet", (4, 8), False, 32),
}


@pytest.mark.parametrize("case", list(DEPLOY_CASES))
def test_deploy_forward_matches_jax(case):
    """Deploy logits against the JAX deploy_forward on the same plan (made
    at 224x224 for regnetx_200m), rel-MSE <= 1e-8 and the same top-1: the
    integer kinds compute exact codes on both sides, only the float head
    rounds differently."""
    arch, dataset, (nbw, nba), baked, hw = DEPLOY_CASES[case]
    s = _state(arch, dataset, nbw, nba, hw, baked=baked, n=8, snap=True,
               num_classes=10)
    plan_hw = 224 if arch.startswith("regnet") else hw
    pj = JD.make_deploy_plan(s["g"], s["jd"], s["jsteps"],
                             input_hw=(plan_hw, plan_hw))
    pt = TD.make_deploy_plan(s["gt"], s["td"], s["tsteps"],
                             input_hw=(plan_hw, plan_hw))
    assert _kinds(pt) == _kinds(pj)
    counts = _counts(pt)
    if case == "regnetx_200m-uniform":
        assert counts["int8_bd"] > 0
    if arch.startswith("regnet"):
        fb = {pt[u.name][0] for u in iter_units(s["gt"])
              if u.groups > 1 and pt[u.name][0] != "int8_bd"}
        assert fb == ({"bf16_codes"} if nba == 8 else {"int8", "bf16_codes"})
    if case == "resnet18-w4a8":
        assert counts["int8_pair"] > 0
    # under jit, as the JAX package serves it (one compile instead of one
    # per eager op)
    want = np.asarray(jax.jit(lambda x: JD.deploy_forward(
        s["g"], s["jd"], s["jsteps"], x, plan=pj))(jnp.asarray(s["x"])))
    got = TD.deploy_forward(s["gt"], s["td"], s["tsteps"],
                            torch.as_tensor(s["x"]), plan=pt, device="cpu")
    assert tuple(got.shape) == want.shape == (8, 10)
    assert _rel_mse(got.numpy(), want) <= 1e-8
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("case", ["regnetx_200m-uniform",
                                  "regnetx_200m-baked"])
def test_deploy_vs_sim_gap_matches_jax(case):
    """The port's deploy-vs-sim logit gap (rel-MSE of deploy against its
    own sim forward with every act site on) equals the JAX package's own
    gap on the same state within 1e-9 of it, with the same top-1
    agreement: on 1/8-grid images with power-of-two steps both sims and
    both deploys compute the same values. Many requant inputs then sit
    on .5 ties, where deploy rounds half up and sim half to even, so the
    gap itself is large in both packages; the realistic gap is the
    card's (chip_smoke.py phases 24-25, beside regnet_parity_gap.py's)."""
    arch, dataset, (nbw, nba), baked, hw = DEPLOY_CASES[case]
    s = _state(arch, dataset, nbw, nba, hw, baked=baked, n=8, snap=True,
               num_classes=10)
    pj = JD.make_deploy_plan(s["g"], s["jd"], s["jsteps"],
                             input_hw=(224, 224))
    pt = TD.make_deploy_plan(s["gt"], s["td"], s["tsteps"],
                             input_hw=(224, 224))
    jflags = j_act_flags(s["g"], s["cfg"],
                         base=ssq.Flags().all_weights(s["g"]))
    tflags = t_act_flags(s["gt"], s["tcfg"],
                         base=tp.Flags().all_weights(s["gt"]))
    x = jnp.asarray(s["x"])
    jsim = np.asarray(jax.jit(
        lambda x: ssq.forward(s["g"], s["params"], s["qs"], x, jflags))(x))
    jdep = np.asarray(jax.jit(lambda x: JD.deploy_forward(
        s["g"], s["jd"], s["jsteps"], x, plan=pj))(x))
    tx = torch.as_tensor(s["x"])
    tsim = tp.forward(s["gt"], s["tparams"], s["tqs"], tx, tflags,
                      device="cpu").numpy()
    tdep = TD.deploy_forward(s["gt"], s["td"], s["tsteps"], tx, plan=pt,
                             device="cpu").numpy()
    jgap, tgap = _rel_mse(jdep, jsim), _rel_mse(tdep, tsim)
    assert np.isfinite(tgap) and abs(tgap - jgap) <= 1e-9 * jgap, \
        (tgap, jgap)
    assert (tdep.argmax(-1) == tsim.argmax(-1)).sum() == \
        (jdep.argmax(-1) == jsim.argmax(-1)).sum()


# ---------------------------------------------------------------------------
# reconstruction of a block with a grouped conv
# ---------------------------------------------------------------------------

RECON_MODES = {
    # the paper's fused loop, coarse targets: warm start, joint, refine
    "fused": dict(mode="fused", shift_targets=(0.5, 1.0),
                  warmstart_frac=0.25),
    # BRECQ's AdaRound reconstruction (rounding only)
    "brecq": dict(mode="brecq"),
}


@pytest.mark.parametrize("mode", list(RECON_MODES))
def test_recon_of_grouped_block_matches_jax(mode):
    """regnetx_200m's first block (its f.b grouped, 8 input channels a
    group) reconstructed in both packages from the JAX package's capture
    (the shape of tests/test_recon.py's grouped-conv test; a cache of
    batch_size rows, so every step sees all rows): the port's own capture
    of it rtol 1e-5 (f32 summation order); rec_trace (and the refine
    trace) and the losses rtol 1e-4; the hardened rounding, and the
    selection (one index per input channel of a conv group), flip rate
    <= 0.5%."""
    g, _ = JZ.build("regnetx_200m", num_classes=10)
    raw = jax.tree.map(jnp.asarray, _raw("regnetx_200m", "imagenet", 10))
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          use_8bit_head_stem=False)
    params, qs = ssq.prepare_model(g, raw, cfg)
    name = g[1].name
    assert g[1].units[1].groups > 1
    cali = jnp.asarray(np.random.default_rng(1).normal(
        size=(16, 16, 16, 3)).astype(np.float32))
    ci, co = JC.capture_io(g, params, qs, name, cali, ssq.Flags(),
                           ssq.Flags(), 16)
    base = dict(iters=30, batch_size=16, **RECON_MODES[mode])
    jq, jm = JE.reconstruct_node(g, params, qs, name, ci, co,
                                 JE.ReconSettings(**base),
                                 jax.random.PRNGKey(2))
    gt, _ = TZ.build("regnetx_200m", num_classes=10)
    tparams = JI.params_from_numpy(_np(params), "cpu")
    tqs = JI.qstate_from_numpy(_np(qs), "cpu")
    tci, tco = TC.capture_io(gt, tparams, tqs, name,
                             torch.tensor(np.asarray(cali)), tp.Flags(),
                             tp.Flags(), 16, device="cpu")
    for got, want in ((tci, ci), (tco, co)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    tq, tm = TE.reconstruct_node(
        gt, tparams, tqs, name,
        torch.tensor(np.asarray(ci)), torch.tensor(np.asarray(co)),
        TE.ReconSettings(**base), seed=2)
    assert ("refine_trace" in tm) == ("refine_trace" in jm) \
        == (mode == "fused")
    for k in ("rec_trace", "refine_trace"):
        if k in jm:
            np.testing.assert_allclose(tm[k].detach().numpy(),
                                       np.asarray(jm[k]), rtol=1e-4,
                                       err_msg=k)
    for k in ("soft_loss", "hard_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    fb = g[1].units[1]
    for u in g[1].units:
        jw, tw = jq[u.name].wq, tq[u.name].wq
        assert type(tw).__name__ == type(jw).__name__ == "AdaRoundWQ"
        assert not tw.soft
        assert float(((tw.alpha >= 0).numpy()
                      != (np.asarray(jw.alpha) >= 0)).mean()) <= 0.005
        assert (tw.st_index is None) == (jw.st_index is None) \
            == (mode == "brecq")
        if jw.st_index is not None:
            assert tuple(tw.st_index.shape) == np.asarray(jw.st_index).shape
            assert float((tw.st_index.numpy() != np.asarray(jw.st_index))
                         .mean()) <= 0.005
    if mode == "fused":
        assert tuple(tq[fb.name].wq.st_index.shape) == \
            (fb.in_ch // fb.groups,)


def test_trained_fp_forward_matches_jax_on_its_synth10():
    """The trained RegNetX-600M's FP forward (BN folded, no quantizer) on
    the JAX CLI's own synth10 test images (drawn by jax.random, which the
    port's torch.Generator draws cannot repeat): the port's logits against
    the JAX package's, rel-MSE <= 1e-8 (f32 summation order only), and
    the same top-1 on every image."""
    from shiftedscalequantization_tpu.data.realdata import \
        synth10_test_arrays
    x, y = synth10_test_arrays(2048, seed=7)
    x, y = x[:64], y[:64]
    g, _ = JZ.build("regnetx_600m", dataset="synth10")
    # the quantizers are off: the max rule only keeps the set-up short
    cfg = ssq.QuantConfig(w_scale_method="max")
    params, qs = ssq.prepare_model(
        g, jax.tree.map(jnp.asarray, j_load_raw(TRAINED)), cfg)
    want = np.asarray(jax.jit(
        lambda x: ssq.forward(g, params, qs, x, ssq.Flags()))(
            jnp.asarray(x)))
    gt, _ = TZ.build("regnetx_600m", dataset="synth10")
    tparams, tqs = tp.prepare_model(
        gt, load_raw_params(TRAINED, device="cpu"),
        tp.QuantConfig(w_scale_method="max"), device="cpu")
    got = tp.forward(gt, tparams, tqs, torch.as_tensor(np.array(x)),
                     tp.Flags(), device="cpu").numpy()
    assert _rel_mse(got, want) <= 1e-8
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert (got.argmax(-1) == y).mean() > 0.9
