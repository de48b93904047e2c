"""The port's own deploy == sim suite, on the CPU: the properties the JAX
package's ``tests/test_deploy.py`` and ``tests/test_deploy_extra.py`` hold
its deploy path to, asserted with the same bounds on the port's deploy.

The states are the JAX tests' own: made by the JAX package as its tests
make them (CIFAR ResNet-18 from ``resnet.init_params(PRNGKey(0))``, max
scales, calibrated on ``normal(PRNGKey(1), (8, 32, 32, 3))``; the chain
and MobileNetV2 likewise) and carried into the port as numpy
(``utils/jax_import``); from there the port converts, plans and runs both
forwards itself. On a state the port calibrates itself (act steps up to
1.6% apart from the JAX package's on these random W2 weights) the W2A4
act-shift case agreed on 6 of 8 top-1s: those logits are nearly
degenerate, and the JAX state is what the bound was set on. The MNASNet
cases calibrate in the port (the JAX package's eager calibration at
224x224 takes minutes).

The 18 JAX cases and their port counterparts:

test_deploy.py
- TestDeployMatchesSim.test_w4a4_logits_match (:25): here,
  ``test_w4a4_logits_match`` (rel < 0.15, top-1 agreement >= 0.99).
- .test_w2a4_int8_units_dominate (:44): here (integer codes at all but
  3 units, a layer1 unit's codes within +-3).
- .test_int_conv_exactness_single_unit (:55): here, ``test_w4a8_matches_
  sim`` (rel < 0.02), as one case with test_deploy_extra.py:45 below.
- TestS2dStem.test_s2d_equals_direct_conv (:68), .test_s2d_off_by_default
  (:83): none. The port never ports the space-to-depth stem (no caller:
  the JAX package's deploy passes use_s2d_stem=False); its plan kind
  ``float_s2d`` is refused (test_torch_port_deploy.py::
  test_unported_plan_kind_raises).
- TestTwoPhaseDeploy.test_baked_shift_grouped_int_deploy_matches_sim
  (:100): here, ``test_two_phase_baked_state_matches_sim`` (grouped
  scale-table form with 2 groups, rel < 0.15, top-1 agreement >= 0.95);
  the fused-quantizer baked state beside it in
  test_torch_port_shifted_deploy.py.
- TestStem1Pass.test_1pass_engages_and_matches_on_coarse_grids (:132):
  here (only model.conv1 changes, to float_1p; argmax agreement >= 0.75,
  rel < 0.15 between the two modes).

test_deploy_extra.py
- TestClampFolding.test_fold_is_exact_vs_separate_activation (:30): here,
  on the port's ``deploy._fold_act`` too.
- .test_full_net_deploy_still_matches_sim (:45): here,
  ``test_w4a8_matches_sim``.
- TestPackedDeploy.test_packed_plan_kind_actually_executes (:58): here
  (packed units in the plan, the downsamples among them, SSQ_PACKED=1
  logits within rel 1e-4 of the default plan's).
- TestActShiftDeploy.test_per_channel_site_transports_f32_and_matches_sim
  (:85): here (per-channel step, not an int8 or biased site, rel < 0.15,
  top-1 agreement >= 0.99).
- TestSitelessBlockTransport (slow in the JAX package):
  .test_mnasnet_w2a4_code_transport (:145): here (stage .1 expand convs
  off the float path, rel < 0.2); .test_mnasnet_w4a8_matches_sim_tightly
  (:167): here (rel < 0.03, same argmax); .test_pair_term_cap (:177):
  test_torch_port_mnasnet.py (test_deploy_forward_matches_jax over
  SSQ_PAIR_TERMS 2 / 3 / 0 with the pairs formed and consumed pinned, and
  test_pair_transport_switch_and_consumers). The two MNASNet cases here
  run ImageNet MNASNet at 224x224 on one image, as the JAX package's do;
  in the port they take seconds, so they are not marked slow.
- TestResidualChainHarmonization.test_chain_exactness_and_plan (:263):
  here (>= 3 sites, one delta, 3 sum sites, chain consumers off the float
  path, max rel < 1e-3). "Every transport is exact" is held against the
  port's sim run in float64: the f32 sim puts three depthwise outputs of
  model.s.1.layers.3 at y / delta = 1.49999986 (float64) on the other
  side of the tie, within one f32 ulp, and parts by 2.9e-3 from the
  deploy, which equals the float64 sim to 1.1e-7 (and the JAX package's
  deploy to 3.7e-6); the JAX package's own f32 sim is 7.6e-4 off the
  float64 one.
- .test_harmonization_noop_without_equal_deltas (:302): here.
- TestMobileNetV2Deploy.test_w4a8_matches_sim (:323): here (bf16_codes in
  the plan, rel < 0.15, argmax equal on every image).
- TestHarmonizeSurvivesRecalibration.test_reharmonize_after_recalibrate
  (:354): here.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from shiftedscalequantization_tpu.models import resnet as JR
import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import deploy
from shiftedscalequantization_tpu_torch.graph import OpSpec, UnitQuant, \
    UnitSpec, find_node
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.quantize import act_flags, \
    harmonize_residual_chains
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

SWITCHES = ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
            "SSQ_DW_KERNEL", "SSQ_PAIR_TERMS")


@pytest.fixture(autouse=True)
def _exact_stem(monkeypatch):
    """The JAX suite's settings: every switch at its default but the exact
    2-pass stem (its conftest pins SSQ_STEM_1PASS=0); two torch threads."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SSQ_STEM_1PASS", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _raw(graph_jax, seed=0):
    """The JAX package's init_params(PRNGKey(seed)) as the port's raw
    params."""
    raw = JR.init_params(jax.random.PRNGKey(seed), graph_jax)
    return JI.params_from_numpy(jax.tree.map(np.asarray, raw), "cpu")


def _normal(seed, shape):
    return torch.as_tensor(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), shape)))


def _rel(sim, dep):
    sim, dep = np.asarray(sim), np.asarray(dep)
    return float(np.abs(sim - dep).mean() / (np.abs(sim).mean() + 1e-9))


def _agree(a, b):
    return float((np.asarray(a).argmax(-1) == np.asarray(b).argmax(-1))
                 .mean())


def _carry(graph, jparams, jqs, x, cfg):
    """The JAX package's (params, qstate) in the port, with the port's act
    flags: (graph, params, qstate, flags, cfg)."""
    params = JI.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    qs = JI.qstate_from_numpy(jax.tree.map(np.asarray, jqs), "cpu")
    return graph, params, qs, act_flags(
        graph, cfg, base=tp.Flags().all_weights(graph)), cfg


def _jax_setup(arch, dataset, nbw, nba, x, **cfg_kw):
    """The JAX tests' build(): max scales, calibration on ``x``, made by
    the JAX package from init_params(PRNGKey(0)) and carried over."""
    import shiftedscalequantization_tpu as ssq
    from shiftedscalequantization_tpu.models import zoo as JZ
    jgraph, _ = JZ.build(arch, dataset=dataset)
    kw = dict(n_bits_w=nbw, n_bits_a=nba, w_scale_method="max",
              a_scale_method="max", **cfg_kw)
    jcfg = ssq.QuantConfig(**kw)
    jparams, jqs = ssq.prepare_model(
        jgraph, JR.init_params(jax.random.PRNGKey(0), jgraph), jcfg)
    jqs = ssq.calibrate_acts(jgraph, jparams, jqs, jnp.asarray(x.numpy()),
                             jcfg)
    return _carry(TZ.build(arch, dataset=dataset)[0], jparams, jqs, x,
                  tp.QuantConfig(**kw))


def _setup(arch, dataset, nbw, nba, x, **cfg_kw):
    """(graph, params, qstate, flags, cfg): the port's own max-scale
    state, calibrated on ``x``, from the JAX package's raw weights."""
    from shiftedscalequantization_tpu.models import zoo as JZ
    graph, _ = TZ.build(arch, dataset=dataset)
    jgraph, _ = JZ.build(arch, dataset=dataset)
    cfg = tp.QuantConfig(n_bits_w=nbw, n_bits_a=nba, w_scale_method="max",
                         a_scale_method="max", **cfg_kw)
    params, qs = tp.prepare_model(graph, _raw(jgraph), cfg, device="cpu")
    qs = tp.calibrate_acts(graph, params, qs, x, cfg, device="cpu")
    flags = act_flags(graph, cfg, base=tp.Flags().all_weights(graph))
    return graph, params, qs, flags, cfg


def _sim_dep(graph, params, qs, x, flags, plan=None):
    sim = tp.forward(graph, params, qs, x, flags, device="cpu")
    dp = deploy.build_deploy_params(graph, params, qs, device="cpu")
    steps = deploy.act_steps_from_qstate(graph, qs)
    dep = deploy.deploy_forward(graph, dp, steps, x, plan, device="cpu")
    return sim.numpy(), dep.numpy()


@pytest.fixture(scope="module")
def r18():
    """CIFAR ResNet-18 at W4A4, W2A4 and W4A8 on the JAX tests' images."""
    x = _normal(1, (8, 32, 32, 3))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {bits: _jax_setup("resnet18", "cifar10", *bits, x)
           for bits in ((4, 4), (2, 4), (4, 8))}
    torch.set_num_threads(n)
    return x, out


# ---------------------------------------------------------------------------
# test_deploy.py
# ---------------------------------------------------------------------------

def test_w4a4_logits_match(r18):
    x, states = r18
    graph, params, qs, flags, _ = states[(4, 4)]
    sim, dep = _sim_dep(graph, params, qs, x, flags)
    assert _rel(sim, dep) < 0.15, _rel(sim, dep)
    assert _agree(sim, dep) >= 0.99


def test_w2a4_int8_units_dominate(r18):
    graph, params, qs, _, _ = r18[1][(2, 4)]
    dp = deploy.build_deploy_params(graph, params, qs, device="cpu")
    n_int = sum(1 for d in dp.values() if d.w_int is not None)
    assert n_int >= len(dp) - 3          # only the 8-bit head/stem fall back
    some = [d for n, d in dp.items()
            if d.w_int is not None and "layer1" in n][0]
    assert int(some.w_int.abs().max()) <= 3


@pytest.mark.parametrize("packed", [False, True], ids=["default", "packed"])
def test_w4a8_matches_sim(r18, packed, monkeypatch):
    """test_deploy.py:55 and test_deploy_extra.py:45 (relu folded into the
    requant): W4A8 keeps the drift small, rel < 0.02; with SSQ_PACKED=1
    too (the packed units take the same codes)."""
    if packed:
        monkeypatch.setenv("SSQ_PACKED", "1")
    x, states = r18
    graph, params, qs, flags, _ = states[(4, 8)]
    sim, dep = _sim_dep(graph, params, qs, x, flags)
    assert _rel(sim, dep) < 0.02, _rel(sim, dep)


def test_two_phase_baked_state_matches_sim():
    """Shift selection then AdaRound on layer1.0 and the fc (the two-phase
    stack, 10 steps each): the baked units deploy through the grouped
    scale-table form and match sim."""
    from shiftedscalequantization_tpu_torch.recon import ReconSettings, \
        capture_io, reconstruct_node
    x = _normal(1, (8, 32, 32, 3))
    graph, params, qs, flags, _ = _jax_setup("resnet18", "cifar10", 4, 4, x)
    cali = _normal(5, (64, 32, 32, 3))
    for i, name in enumerate(["model.layer1.0", "model.fc"]):
        cin, cout = capture_io(graph, params, qs, name, cali, tp.Flags(),
                               tp.Flags(), 32, device="cpu")
        qs, _ = reconstruct_node(
            graph, params, qs, name, cin, cout,
            ReconSettings(mode="shift", iters=10, batch_size=16,
                          shift_targets=(0.5, 1.0), lmda_s=0.01), 6 + 2 * i)
        qs, _ = reconstruct_node(
            graph, params, qs, name, cin, cout,
            ReconSettings(mode="round", iters=10, batch_size=16), 7 + 2 * i)
    dp = deploy.build_deploy_params(graph, params, qs, device="cpu")
    assert dp["model.layer1.0.conv1"].w_groups is not None
    assert dp["model.layer1.0.conv1"].w_groups.shape[0] == 2
    sim, dep = _sim_dep(graph, params, qs, x, flags)
    assert _rel(sim, dep) < 0.15, _rel(sim, dep)
    assert _agree(sim, dep) >= 0.95


def test_1pass_engages_and_matches_on_coarse_grids(r18, monkeypatch):
    x, states = r18
    graph, params, qs, _, _ = states[(2, 4)]
    dp = deploy.build_deploy_params(graph, params, qs, device="cpu")
    steps = deploy.act_steps_from_qstate(graph, qs)
    plans = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("SSQ_STEM_1PASS", mode)
        plans[mode] = deploy.make_deploy_plan(graph, dp, steps,
                                              input_hw=(32, 32))
    p1, p0 = plans["1"], plans["0"]
    assert {k for k in p0 if p0[k] != p1[k]} == {"model.conv1"}
    assert p1["model.conv1"][0] == "float_1p"
    d0, d1 = (deploy.deploy_forward(graph, dp, steps, x, p, device="cpu")
              .numpy() for p in (p0, p1))
    assert _agree(d0, d1) >= 0.75
    assert _rel(d0, d1) < 0.15, _rel(d0, d1)


# ---------------------------------------------------------------------------
# test_deploy_extra.py
# ---------------------------------------------------------------------------

FOLD_CASES = [(6.0, 0, 0.43, 15), (6.0, 3, 0.391, 15), (6.0, 0, 0.05, 15),
              (None, 5, 0.21, 15)]


@pytest.mark.parametrize("act_hi,zp,d,hi", FOLD_CASES)
def test_fold_is_exact_vs_separate_activation(act_hi, zp, d, hi):
    """code(clip(x, 0, 6)) == clip(code(x), code(0), code(6)): the algebra
    the requant relies on, and the port's _fold_act bounds give it."""
    x = np.random.default_rng(0).normal(size=(4096,)).astype(np.float32) * 8
    xa = np.clip(x, 0.0, act_hi if act_hi else None)
    old = np.clip(np.floor(xa / d + 0.5) + zp, 0, hi)
    lo_f = max(0.0, zp)
    hi_f = min(hi, np.floor(act_hi / d + 0.5) + zp) if act_hi else hi
    new = np.clip(np.floor(x / d + 0.5) + zp, lo_f, hi_f)
    np.testing.assert_array_equal(old, new)
    lo_p, hi_p, left = deploy._fold_act(
        "relu6" if act_hi else "relu", torch.tensor(float(zp)), 0.0,
        float(hi), torch.tensor(1.0 / d))
    assert left is None
    got = np.clip(np.floor(x / d + 0.5) + zp, float(lo_p), float(hi_p))
    np.testing.assert_array_equal(got, new)


def test_packed_plan_kind_actually_executes(r18, monkeypatch):
    x, states = r18
    graph, params, qs, _, _ = states[(2, 4)]
    dp = deploy.build_deploy_params(graph, params, qs, device="cpu")
    steps = deploy.act_steps_from_qstate(graph, qs)
    monkeypatch.setenv("SSQ_PACKED", "1")
    plan_p = deploy.make_deploy_plan(graph, dp, steps, input_hw=(32, 32))
    packed = [k for k, v in plan_p.items()
              if not k.startswith("__") and v[0] == "packed"]
    assert packed and any("downsample" in n for n in packed), packed
    dep_p = deploy.deploy_forward(graph, dp, steps, x, plan_p, device="cpu")
    monkeypatch.setenv("SSQ_PACKED", "0")
    plan_0 = deploy.make_deploy_plan(graph, dp, steps, input_hw=(32, 32))
    dep_0 = deploy.deploy_forward(graph, dp, steps, x, plan_0, device="cpu")
    assert _rel(dep_0, dep_p) < 1e-4


def test_per_channel_site_transports_f32_and_matches_sim(r18):
    from shiftedscalequantization_tpu_torch.ops import quant as Q
    from shiftedscalequantization_tpu_torch.ops.act_quant import \
        ActShiftQuant
    x, states = r18
    graph, params, qs, flags, _ = states[(2, 4)]
    name = next(n for n, v in qs.items()
                if v is not None and not isinstance(v, UnitQuant))
    c = find_node(graph, name).units[-1].out_ch
    p = torch.nn.functional.one_hot(torch.arange(c) % 2, 2).float()
    qs = dict(qs)
    qs[name] = ActShiftQuant(
        qp=qs[name], alpha=Q.inverse_rectified_softmax(p * 0.8
                                                      + (1 - p) * 0.2),
        shift_targets=(1.0, 0.5), hard_targets=True)
    steps = deploy.act_steps_from_qstate(graph, qs)
    assert np.asarray(steps[name][0]).size == c
    dp = deploy.build_deploy_params(graph, params, qs, device="cpu")
    plan = deploy.make_deploy_plan(graph, dp, steps, input_hw=(32, 32))
    assert name not in plan["__int8_sites__"]
    assert name not in plan.get("__biased_sites__", frozenset())
    sim, dep = _sim_dep(graph, params, qs, x, flags, plan)
    assert _rel(sim, dep) < 0.15, _rel(sim, dep)
    assert _agree(sim, dep) >= 0.99


def _mnasnet_224(nbw, nba):
    x = _normal(1, (1, 224, 224, 3))
    return x, _setup("mnasnet", "imagenet", nbw, nba, x)


def test_mnasnet_w2a4_code_transport():
    x, (graph, params, qs, flags, _) = _mnasnet_224(2, 4)
    dp = deploy.build_deploy_params(graph, params, qs, device="cpu")
    steps = deploy.act_steps_from_qstate(graph, qs)
    plan = deploy.make_deploy_plan(graph, dp, steps)
    fixed = [k for k, v in plan.items()
             if not k.startswith("__") and ".1.layers.0" in k]
    assert fixed
    for k in fixed:
        assert not plan[k][0].startswith("float"), (k, plan[k])
    sim, dep = _sim_dep(graph, params, qs, x, flags, plan)
    assert _rel(sim, dep) < 0.2, _rel(sim, dep)


def test_mnasnet_w4a8_matches_sim_tightly():
    x, (graph, params, qs, flags, _) = _mnasnet_224(4, 8)
    sim, dep = _sim_dep(graph, params, qs, x, flags)
    assert _rel(sim, dep) < 0.03, _rel(sim, dep)
    assert int(sim.argmax()) == int(dep.argmax())


def _chain_graph():
    """An isolated 3-deep siteless inverted-residual chain (the MNASNet
    stage shape) with a linear head, as the JAX test builds it."""
    from shiftedscalequantization_tpu_torch.models.mnasnet import _conv, \
        _inverted_residual
    return (_conv("model.pre", 3, 16, 3, 1, 1, act="relu"),
            _inverted_residual("model.s.0", 16, 16, 3, 1, 3),
            _inverted_residual("model.s.1", 16, 16, 3, 1, 3),
            _inverted_residual("model.s.2", 16, 16, 3, 1, 3),
            OpSpec("model.gap", "gap"),
            UnitSpec("model.fc", "linear", in_ch=16, out_ch=10))


@pytest.fixture(scope="module")
def chain():
    """The chain at W4A4 without 8-bit head or stem, made as the JAX test
    makes it (init_params(PRNGKey(3)), calibrated on normal(PRNGKey(4),
    (4, 16, 16, 3))) and carried over."""
    import shiftedscalequantization_tpu as ssq
    from shiftedscalequantization_tpu.graph import OpSpec as JOp
    from shiftedscalequantization_tpu.graph import UnitSpec as JUnit
    from shiftedscalequantization_tpu.models.mnasnet import \
        _conv as j_conv, _inverted_residual as j_ir
    jgraph = (j_conv("model.pre", 3, 16, 3, 1, 1, act="relu"),
              j_ir("model.s.0", 16, 16, 3, 1, 3),
              j_ir("model.s.1", 16, 16, 3, 1, 3),
              j_ir("model.s.2", 16, 16, 3, 1, 3), JOp("model.gap", "gap"),
              JUnit("model.fc", "linear", in_ch=16, out_ch=10))
    kw = dict(n_bits_w=4, n_bits_a=4, w_scale_method="max",
              a_scale_method="max", use_8bit_head_stem=False)
    jcfg = ssq.QuantConfig(**kw)
    jparams, jqs = ssq.prepare_model(
        jgraph, JR.init_params(jax.random.PRNGKey(3), jgraph), jcfg)
    x = _normal(4, (4, 16, 16, 3))
    jqs = ssq.calibrate_acts(jgraph, jparams, jqs, jnp.asarray(x.numpy()),
                             jcfg)
    graph, params, qs, _, cfg = _carry(_chain_graph(), jparams, jqs, x,
                                       tp.QuantConfig(**kw))
    return graph, params, qs, x, cfg


def _float64(tree):
    from shiftedscalequantization_tpu_torch.quantize import _map_arrays
    return _map_arrays(tree, lambda t: t.double() if t.is_floating_point()
                       else t)


def test_chain_exactness_and_plan(chain):
    graph, params, qs, x, cfg = chain
    qs, ratios = harmonize_residual_chains(graph, qs)
    assert len(ratios) >= 3 and max(ratios.values()) >= 1.0, ratios
    assert len({float(qs[n].aq.delta) for n in ratios}) == 1
    dp = deploy.build_deploy_params(graph, params, qs, device="cpu")
    steps = deploy.act_steps_from_qstate(graph, qs)
    assert len(deploy._chain_sum_sites(graph, steps)) == 3
    plan = deploy.make_deploy_plan(graph, dp, steps, input_hw=(16, 16))
    for blk in ("model.s.1", "model.s.2"):
        assert not plan[f"{blk}.layers.0"][0].startswith("float"), blk
    flags = act_flags(graph, cfg, base=tp.Flags().all_weights(graph))
    _, dep = _sim_dep(graph, params, qs, x, flags, plan)
    sim = tp.forward(graph, _float64(params), _float64(qs), x.double(),
                     flags, device="cpu").numpy()
    rel = np.abs(sim - dep).max() / (np.abs(sim).max() + 1e-9)
    assert rel < 1e-3, rel


def test_harmonization_noop_without_equal_deltas(chain):
    graph, _, qs, _, _ = chain
    steps = deploy.act_steps_from_qstate(graph, qs)
    assert deploy._chain_sum_sites(graph, steps) == {}


def test_reharmonize_after_recalibrate(chain):
    graph, params, qs, x, cfg = chain
    qs, ratios = harmonize_residual_chains(graph, qs)
    assert len(ratios) >= 3

    def member_deltas(q):
        return [float(q[n].aq.delta) for n in ratios]

    def sum_steps(q):
        dp = deploy.build_deploy_params(graph, params, q, device="cpu")
        steps = deploy.act_steps_from_qstate(graph, q)
        return deploy.make_deploy_plan(graph, dp, steps,
                                       input_hw=(16, 16))["__sum_steps__"]

    qs2 = tp.calibrate_acts(graph, params, qs, x, cfg, device="cpu")
    assert len(set(member_deltas(qs2))) > 1
    assert len(sum_steps(qs2)) == 0
    qs3, _ = harmonize_residual_chains(graph, qs2)
    assert len(set(member_deltas(qs3))) == 1
    assert len(sum_steps(qs3)) >= 1


def test_mobilenetv2_w4a8_matches_sim():
    x = _normal(1, (4, 32, 32, 3))
    graph, params, qs, flags, _ = _jax_setup("mobilenetv2", "synth10", 4, 8,
                                             x)
    dp = deploy.build_deploy_params(graph, params, qs, device="cpu")
    steps = deploy.act_steps_from_qstate(graph, qs)
    plan = deploy.make_deploy_plan(graph, dp, steps, input_hw=(32, 32))
    kinds = {v[0] for k, v in plan.items()
             if isinstance(v, tuple) and len(v) == 2}
    assert "bf16_codes" in kinds, kinds
    sim, dep = _sim_dep(graph, params, qs, x, flags, plan)
    assert _rel(sim, dep) < 0.15, _rel(sim, dep)
    assert (sim.argmax(-1) == dep.argmax(-1)).all()
