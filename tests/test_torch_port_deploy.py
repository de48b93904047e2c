"""PyTorch port vs the JAX package: the integer serving slice (deploy
conversion, plan, deploy_forward), run on the CPU.

State comes from the JAX package (W2A4 / W4A4, MSE scales, ResNet-18
ImageNet variant at 64x64) and is carried to the port. Images are
multiples of 1/8: bf16-exact, so the JAX package's 2-pass and 1-pass bf16
stem convs and the port's f32 conv are all exact, and every code after
the stem is integer arithmetic in both packages. The logits then agree to
rounding of the float head (measured rel-MSE ~1e-11).
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
import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch.graph import BlockSpec, OpSpec, \
    UnitSpec
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.ops.cuda import packed as TP
from shiftedscalequantization_tpu_torch.ops.cuda import stem as TS
from shiftedscalequantization_tpu_torch.quantize import act_flags
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

HW = 64
SWITCHES = ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
            "SSQ_DW_KERNEL")


def _rel_mse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(((got - want) ** 2).mean() / (want ** 2).mean())


def _set_env(monkeypatch, **env):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module", params=[(2, 4), (4, 4)],
                ids=["w2a4", "w4a4"])
def state(request):
    nbw, nba = request.param
    g, _ = JZ.build("resnet18", num_classes=10)
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=nbw, n_bits_a=nba)
    params, qs = ssq.prepare_model(g, raw, cfg)
    x = np.round(np.random.default_rng(1).normal(size=(8, HW, HW, 3)) * 8)
    x = (x / 8).astype(np.float32)
    qs = ssq.calibrate_acts(g, params, qs, jnp.asarray(x), cfg)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    gt, _ = TZ.build("resnet18", num_classes=10)
    tparams = JI.params_from_numpy(to_np(params), "cpu")
    tqs = JI.qstate_from_numpy(to_np(qs), "cpu")
    return dict(g=g, params=params, qs=qs, x=x, gt=gt, tparams=tparams,
                tqs=tqs, tcfg=tp.QuantConfig(n_bits_w=nbw, n_bits_a=nba),
                jd=JD.build_deploy_params(g, params, qs),
                jsteps=JD.act_steps_from_qstate(g, qs),
                td=TD.build_deploy_params(gt, tparams, tqs, device="cpu"),
                tsteps=TD.act_steps_from_qstate(gt, tqs))


def _kinds(plan):
    return {k: v for k, v in plan.items() if not k.startswith("__")}


def test_deploy_params_match_jax(state):
    """Integer weight codes and packed codes are exact; the f32 epilogue
    scale and bias are the same expressions (rtol 1e-6)."""
    for name, dj in state["jd"].items():
        dt = state["td"][name]
        assert (dt.w_int is None) == (dj.w_int is None), name
        if dj.w_int is not None:
            np.testing.assert_array_equal(dt.w_int.numpy(),
                                          np.asarray(dj.w_int))
        else:
            np.testing.assert_array_equal(dt.w_fp.numpy(),
                                          np.asarray(dj.w_fp))
        np.testing.assert_allclose(dt.scale.numpy(), np.asarray(dj.scale),
                                   rtol=1e-6)
        np.testing.assert_allclose(dt.bias.numpy(), np.asarray(dj.bias),
                                   rtol=1e-6, atol=1e-7)
        assert dt.w_pack_bits == dj.w_pack_bits, name
        if dj.w_packed is not None:
            from shiftedscalequantization_tpu.ops.pallas.packed import \
                unpack_codes
            k = dt.w_int[0].numel()
            np.testing.assert_array_equal(
                TP.unpack_codes(dt.w_packed, dt.w_pack_bits, k).numpy(),
                np.asarray(unpack_codes(dj.w_packed, dj.w_pack_bits, k)))
            np.testing.assert_array_equal(dt.w_pack_zp.numpy(),
                                          np.asarray(dj.w_pack_zp))
    assert set(state["tsteps"]) == set(state["jsteps"])
    for name, (d, z, n) in state["jsteps"].items():
        dt, zt, nt = state["tsteps"][name]
        assert nt == n and float(dt) == float(d) and float(zt) == float(z)


@pytest.mark.parametrize("env", [
    {}, {"SSQ_STEM_KERNEL": "1"}, {"SSQ_PACKED": "1"},
    {"SSQ_STEM_KERNEL": "1", "SSQ_PACKED": "1"},
    {"SSQ_STEM_1PASS": "0"}, {"SSQ_STEM_1PASS": "1"}],
    ids=["default", "stem", "packed", "stem+packed", "exact", "1pass"])
def test_plan_matches_jax(state, monkeypatch, env):
    """Same kind and feeding site per unit, and the same transport sets,
    under the same SSQ_* switches."""
    _set_env(monkeypatch, **env)
    pj = JD.make_deploy_plan(state["g"], state["jd"], state["jsteps"],
                             input_hw=(HW, HW))
    pt = TD.make_deploy_plan(state["gt"], state["td"], state["tsteps"],
                             input_hw=(HW, HW))
    assert _kinds(pt) == _kinds(pj)
    for key in ("__fused_stem__", "__int8_sites__", "__biased_sites__"):
        assert pt[key] == pj[key], key
    assert set(pt["__sum_steps__"]) == set(pj["__sum_steps__"])


def test_serving_plan_uses_both_kernels(state, monkeypatch):
    _set_env(monkeypatch, SSQ_STEM_KERNEL="1", SSQ_PACKED="1")
    plan = TD.make_deploy_plan(state["gt"], state["td"], state["tsteps"],
                               input_hw=(HW, HW))
    kinds = [k for k, _ in _kinds(plan).values()]
    assert kinds.count("stem_fused") == 1
    assert sorted(n for n, (k, _) in _kinds(plan).items()
                  if k == "packed") == [
        "model.layer2.0.downsample.0", "model.layer3.0.downsample.0",
        "model.layer4.0.downsample.0"]


@pytest.mark.parametrize("env", [
    {"SSQ_STEM_KERNEL": "1", "SSQ_PACKED": "1", "SSQ_STEM_1PASS": "0"},
    {"SSQ_STEM_1PASS": "0"}, {"SSQ_STEM_1PASS": "1"}],
    ids=["stem+packed", "exact-float-stem", "1pass-stem"])
def test_deploy_forward_matches_jax(state, monkeypatch, env):
    """Deploy logits vs the JAX deploy_forward (Pallas kernels in interpret
    mode) under the same plan switches: rel-MSE <= 1e-8 and the same top-1
    (see the module note for why the fixture makes both exact)."""
    _set_env(monkeypatch, **env)
    pj = JD.make_deploy_plan(state["g"], state["jd"], state["jsteps"],
                             input_hw=(HW, HW))
    want = np.asarray(JD.deploy_forward(state["g"], state["jd"],
                                        state["jsteps"],
                                        jnp.asarray(state["x"]), plan=pj))
    pt = TD.make_deploy_plan(state["gt"], state["td"], state["tsteps"],
                             input_hw=(HW, HW))
    got = TD.deploy_forward(state["gt"], state["td"], state["tsteps"],
                            torch.as_tensor(state["x"]), plan=pt,
                            device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 10)
    assert _rel_mse(got.numpy(), want) <= 1e-8
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_deploy_matches_sim(state, monkeypatch):
    """The port's deploy == sim on its own (serving plan, exact stem). On
    this random-weight fixture half-even (sim) vs half-up (deploy) rounding
    ties spread through depth, so the criterion is the one the JAX package
    holds its ImageNet-variant stem deploy to (tests/test_pallas_fused.py:
    129-131): top-1 agreement >= 0.75 and mean |diff| / mean |sim| < 0.2.
    The gap must also be the JAX package's own deploy-vs-sim gap on the
    same state, within 10% of it (the port measured 0.022 at W2A4)."""
    _set_env(monkeypatch, SSQ_STEM_KERNEL="1", SSQ_PACKED="1",
             SSQ_STEM_1PASS="0")
    x = torch.as_tensor(state["x"])
    flags = act_flags(state["gt"], state["tcfg"],
                      base=tp.Flags().all_weights(state["gt"]))
    sim = tp.forward(state["gt"], state["tparams"], state["tqs"], x, flags,
                     device="cpu").numpy()
    dep = TD.deploy_forward(state["gt"], state["td"], state["tsteps"], x,
                            device="cpu").numpy()
    rel = np.abs(sim - dep).mean() / (np.abs(sim).mean() + 1e-9)
    assert (sim.argmax(-1) == dep.argmax(-1)).mean() >= 0.75
    assert rel < 0.2, rel
    jflags = dataclasses.replace(
        ssq.Flags(), weight_on=flags.weight_on, act_on=flags.act_on)
    jx = jnp.asarray(state["x"])
    jsim = np.asarray(ssq.forward(state["g"], state["params"], state["qs"],
                                  jx, jflags))
    jdep = np.asarray(JD.deploy_forward(state["g"], state["jd"],
                                        state["jsteps"], jx))
    jrel = np.abs(jsim - jdep).mean() / (np.abs(jsim).mean() + 1e-9)
    assert abs(rel - jrel) <= 0.1 * jrel, (rel, jrel)


def test_stem_launches_from_plan_constants(state, monkeypatch):
    """The serving plan holds the fused stem's launch constants, built
    once (f32 codes, their K-major bf16 layout, scale, bias, [1/delta, zp,
    qmax, center_off] with 128 for the biased 8-bit site); a forward
    builds none again and equals one on a plan without them."""
    _set_env(monkeypatch, SSQ_STEM_KERNEL="1", SSQ_PACKED="1",
             SSQ_STEM_1PASS="0")
    plan = TD.make_deploy_plan(state["gt"], state["td"], state["tsteps"],
                               input_hw=(HW, HW))
    stem = plan["__fused_stem__"]
    assert set(plan["__kernel_consts__"]) == {stem}
    k, d = plan["__kernel_consts__"][stem], state["td"][stem]
    codes = d.w_int if d.w_int is not None else d.w_fp  # 8-bit: f32 codes
    assert torch.equal(k.w, codes.float())
    assert torch.equal(TS.unpack_stem_weights(k.w_k), k.w)
    delta, zp, n_bits = state["tsteps"][stem]
    np.testing.assert_array_equal(k.qp.numpy(), np.array(
        [np.float32(1) / np.float32(float(delta)), float(zp),
         2.0 ** n_bits - 1, 128.0 if stem in plan["__biased_sites__"]
         else float(zp)], np.float32))
    x = torch.as_tensor(state["x"])
    bare = {key: v for key, v in plan.items() if key != "__kernel_consts__"}
    want = TD.deploy_forward(state["gt"], state["td"], state["tsteps"], x,
                             plan=bare, device="cpu")

    def rebuilt(*args, **kwargs):
        raise AssertionError("stem constants built during a forward")

    monkeypatch.setattr(TD, "prepare_stem", rebuilt)
    got = TD.deploy_forward(state["gt"], state["td"], state["tsteps"], x,
                            plan=plan, device="cpu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", TD.UNPORTED_KINDS)
def test_unported_plan_kind_raises(state, monkeypatch, kind):
    _set_env(monkeypatch)
    plan = dict(TD.make_deploy_plan(state["gt"], state["td"],
                                    state["tsteps"], input_hw=(HW, HW)))
    name = "model.layer2.0.conv2"
    plan[name] = (kind, plan[name][1])
    with pytest.raises(NotImplementedError, match=kind):
        TD.deploy_forward(state["gt"], state["td"], state["tsteps"],
                          torch.as_tensor(state["x"]), plan=plan,
                          device="cpu")


def test_pair_transport_raises():
    """A siteless residual block (no post-activation, no block act site)
    whose two code grids have different steps hands its sum on as a pair
    (the name is from when pair transport raised): its 1x1 consumer runs
    one integer conv per term, and deploy matches the JAX package's
    deploy (pair_stats too) and the sim forward; with the cap below 2 the
    exact f32 sum serves instead. With the steps made equal, the exact
    int8 code add of a harmonized chain runs."""
    from shiftedscalequantization_tpu import graph as JG
    from shiftedscalequantization_tpu.quantize import \
        act_flags as j_act_flags

    def graph_of(G):
        def conv(name, cin, cout, act=None, k=3):
            return G.UnitSpec(name=name, kind="conv", in_ch=cin,
                              out_ch=cout, kernel=(k, k),
                              padding=(k // 2, k // 2), activation=act)

        return (conv("stem", 3, 16, "relu"),
                G.BlockSpec(name="blk",
                            units=(conv("blk.a", 16, 16, "relu"),
                                   conv("blk.b", 16, 16)),
                            residual=True, post_activation=None,
                            block_act_quant=False),
                conv("post", 16, 16, "relu", k=1),
                G.OpSpec("gap", "gap"),
                G.UnitSpec(name="fc", kind="linear", in_ch=16, out_ch=8))

    gj = graph_of(JG)
    graph = graph_of(tp.graph)
    cfg = ssq.QuantConfig(n_bits_w=4, n_bits_a=4, w_scale_method="max",
                          a_scale_method="max", use_8bit_head_stem=False)
    tcfg = tp.QuantConfig(n_bits_w=4, n_bits_a=4, w_scale_method="max",
                          a_scale_method="max", use_8bit_head_stem=False)
    raw = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                       TZ.init_params(graph, device="cpu"))
    params, jqs = ssq.prepare_model(gj, raw, cfg)
    xn = np.random.default_rng(0).normal(size=(32, 8, 8, 3))
    xn = (np.round(xn * 8) / 8).astype(np.float32)
    x = torch.as_tensor(xn)
    jqs = ssq.calibrate_acts(gj, params, jqs, jnp.asarray(xn), cfg)
    tparams = JI.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    qs = JI.qstate_from_numpy(jax.tree.map(np.asarray, jqs), "cpu")
    dp = TD.build_deploy_params(graph, tparams, qs, device="cpu")
    jdp = JD.build_deploy_params(gj, params, jqs)
    steps = TD.act_steps_from_qstate(graph, qs)
    jsteps = JD.act_steps_from_qstate(gj, jqs)
    assert float(steps["stem"][0]) != float(steps["blk.b"][0])
    plan = TD.make_deploy_plan(graph, dp, steps, input_hw=(8, 8))
    jplan = JD.make_deploy_plan(gj, jdp, jsteps, input_hw=(8, 8))
    assert {k: v for k, v in plan.items() if not k.startswith("__")} == \
        {k: v for k, v in jplan.items() if not k.startswith("__")}
    assert plan["post"] == ("float", None)
    sim = tp.forward(graph, tparams, qs, x,
                     act_flags(graph, tcfg, base=tp.Flags().all_weights(
                         graph)), device="cpu")
    deps = {}
    for terms in ("2", "0"):
        with pytest.MonkeyPatch.context() as m:
            m.setenv("SSQ_PAIR_TERMS", terms)
            dep = TD.deploy_forward(graph, dp, steps, x, plan=plan,
                                    device="cpu")
            stats = dict(TD.pair_stats)
            want = np.asarray(JD.deploy_forward(gj, jdp, jsteps,
                                                jnp.asarray(xn), plan=jplan))
        assert stats == JD.pair_stats == (
            {"formed": 1, "consumed_fast": 1} if terms == "2"
            else {"formed": 0, "consumed_fast": 0})
        assert _rel_mse(dep.numpy(), want) <= 1e-8
        rel = float((sim - dep).abs().mean() / (sim.abs().mean() + 1e-9))
        assert rel < 0.02, rel
        deps[terms] = dep
    assert _rel_mse(deps["2"].numpy(), deps["0"].numpy()) <= 1e-8
    # harmonize: the block's last unit takes the entry grid's step
    qs = dict(qs)
    qs["blk.b"] = dataclasses.replace(
        qs["blk.b"], aq=dataclasses.replace(qs["blk.b"].aq,
                                            delta=qs["stem"].aq.delta))
    steps = TD.act_steps_from_qstate(graph, qs)
    plan = TD.make_deploy_plan(graph, dp, steps, input_hw=(8, 8))
    assert "blk__sum__" in plan["__sum_steps__"]
    dep = TD.deploy_forward(graph, dp, steps, x, plan=plan, device="cpu")
    assert TD.pair_stats["formed"] == 0
    sim = tp.forward(graph, tparams, qs, x,
                     act_flags(graph, tcfg, base=tp.Flags().all_weights(
                         graph)), device="cpu")
    rel = float((sim - dep).abs().mean() / (sim.abs().mean() + 1e-9))
    assert rel < 0.02, rel
