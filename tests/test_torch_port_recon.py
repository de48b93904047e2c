"""PyTorch port vs the JAX package: the reconstruction engine
(``recon/engine.py``: losses, regularizers, the fused loop with its warm
start and refine) and the pipeline (``recon/pipeline.py``), on the CPU,
and the whole slice on a tiny model.

State is made by the JAX package and carried across (``utils/jax_import``).
The two packages draw minibatch rows from different generators, so the
trajectory tests use a cache of N = batch_size rows: every step sees all
rows and only the summation order differs. The tests hold ``rec_trace``
and the losses to rtol 1e-4 over 40 steps, the hardened rounding and
selection codes to a flip rate of 0.5%, and the selection ratios to 0.01.
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
from shiftedscalequantization_tpu import quantize as JQZ
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.ops import wquant as JW
from shiftedscalequantization_tpu.recon import capture as JC
from shiftedscalequantization_tpu.recon import engine as JE
from shiftedscalequantization_tpu.recon import pipeline as JP
import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch import graph as TG
from shiftedscalequantization_tpu_torch import quantize as TQZ
from shiftedscalequantization_tpu_torch.ops import wquant as TW
from shiftedscalequantization_tpu_torch.recon import capture as TC
from shiftedscalequantization_tpu_torch.recon import engine as TE
from shiftedscalequantization_tpu_torch.recon import pipeline as TP
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

BLOCK = "model.layer1.0"
UNITS = ("model.layer1.0.conv1", "model.layer1.0.conv2")
NEAR1 = (1 - 1 / 32, 1 + 1 / 32, 1.0)
RTOL = 1e-4
FLIP_RATE = 0.005
RATIO_ATOL = 0.01


def _jax_tiny_graph():
    """tests/test_recon.py's tiny model: stem, one basic block, gap, fc."""
    U, B = JG.UnitSpec, JG.BlockSpec
    conv1 = U("model.conv1", "conv", 3, 8, kernel=(3, 3), stride=(1, 1),
              padding=(1, 1), activation="relu", has_bn=True)
    block = B(BLOCK, units=(
        U(UNITS[0], "conv", 8, 8, kernel=(3, 3), padding=(1, 1),
          activation="relu", has_bn=True),
        U(UNITS[1], "conv", 8, 8, kernel=(3, 3), padding=(1, 1),
          disable_act_quant=True, has_bn=True)),
        residual=True, post_activation="relu")
    return (conv1, block, JG.OpSpec("model.avgpool", "gap"),
            U("model.fc", "linear", 8, 4))


def _port_graph(g):
    def unit(u):
        return TG.UnitSpec(**dataclasses.asdict(u))
    out = []
    for n in g:
        if isinstance(n, JG.UnitSpec):
            out.append(unit(n))
        elif isinstance(n, JG.BlockSpec):
            out.append(TG.BlockSpec(
                n.name, tuple(unit(u) for u in n.units),
                unit(n.downsample) if n.downsample else None, n.residual,
                n.post_activation, n.block_act_quant))
        else:
            out.append(TG.OpSpec(**dataclasses.asdict(n)))
    return tuple(out)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _a(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _planted_raw():
    """The tiny model's raw params with TestFusedWarmstart's planted 16x
    per-input-channel imbalance on the block's conv2 (thirds scaled by 1,
    4, 16 and compensated in conv1's BN, so the FP function is unchanged).
    Returns (raw, scales)."""
    g = _jax_tiny_graph()
    raw = {k: dict(v) for k, v in
           JR.init_params(jax.random.PRNGKey(0), g).items()}
    s = np.ones(8, np.float32)
    s[2:5] = 4.0
    s[5:] = 16.0
    raw[UNITS[1]]["w"] = raw[UNITS[1]]["w"] * s[None, :, None, None]
    bn = dict(raw[UNITS[0]]["bn"])
    bn["gamma"] = bn["gamma"] / s
    bn["beta"] = bn["beta"] / s
    raw[UNITS[0]]["bn"] = bn
    return raw, s


def _state(raw=None, n=64):
    g = _jax_tiny_graph()
    if raw is None:
        raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          use_8bit_head_stem=False)
    params, qs = ssq.prepare_model(g, raw, cfg)
    cali = np.random.default_rng(1).normal(size=(n, 8, 8, 3)) \
        .astype(np.float32)
    return dict(g=g, params=params, qs=qs, cali=cali, gt=_port_graph(g),
                tparams=JI.params_from_numpy(_np(params), "cpu"),
                tqs=JI.qstate_from_numpy(_np(qs), "cpu"),
                tcali=torch.as_tensor(cali))


@pytest.fixture(scope="module")
def tiny():
    return _state()


def _caches(st, name, n=None):
    """The JAX package's capture of ``name`` (FP prefix), as numpy."""
    ci, co = JC.capture_io(st["g"], st["params"], st["qs"], name,
                           jnp.asarray(st["cali"][:n]), JG.Flags(),
                           JG.Flags(), batch_size=32)
    return np.asarray(ci), np.asarray(co)


def _flip_rate(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float((a != b).mean())


# ---------------------------------------------------------------------------
# losses and regularizers
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 5, 5, 6)).astype(np.float32)
    b = rng.normal(size=(4, 5, 5, 6)).astype(np.float32)
    for p in (1.0, 2.0, 2.4):
        np.testing.assert_allclose(
            float(TE.lp_loss_cl(torch.tensor(a), torch.tensor(b), p)),
            float(JE.lp_loss_cl(a, b, p)), rtol=1e-6)
        np.testing.assert_allclose(
            float(TE.rec_loss_fn(torch.tensor(a), torch.tensor(b), None,
                                 "mse", p)),
            float(JE.rec_loss_fn(a, b, None, "mse", p)), rtol=1e-6)
    g = np.abs(a) + 1.0
    for kind in ("fisher_diag", "fisher_full"):
        np.testing.assert_allclose(
            float(TE.rec_loss_fn(torch.tensor(a), torch.tensor(b),
                                 torch.tensor(g), kind, 2.0)),
            float(JE.rec_loss_fn(a, b, g, kind, 2.0)), rtol=1e-6)


def _reg_state(mode, seed=0):
    """A node's quantizers in the form ``mode`` optimizes, made by the JAX
    package with seeded noise on the logits (as a trained state has)."""
    st = _state()
    units = list(UNITS)
    first = {"round_refine": "fused", "round": "shift"}.get(mode, mode)
    s = JE.ReconSettings(mode=first, iters=100, shift_targets=(0.5, 1.0),
                         fused_dequant="effective", weight=0.03)
    qs, _ = JE._init_quantizers(st["params"], st["qs"], units, s)
    if mode != first:
        # the refine re-opens a hardened fused state, two-phase's round
        # phase bakes a hardened shift-phase state
        qs = JE._harden(qs, units, first)
        s = dataclasses.replace(s, mode=mode)
        qs, _ = JE._init_quantizers(st["params"], qs, units, s)
    rng = np.random.default_rng(seed)
    for u in units:
        wq = qs[u].wq
        kw = {}
        for f in ("alpha", "beta"):
            v = getattr(wq, f, None)
            if v is not None:
                kw[f] = v + rng.normal(size=v.shape).astype(np.float32)
        qs[u] = dataclasses.replace(qs[u], wq=dataclasses.replace(wq, **kw))
    return st, qs, s, JI.qstate_from_numpy(_np(qs), "cpu")


@pytest.mark.parametrize("mode", ["fused", "shift", "round_refine",
                                  "brecq", "round"])
def test_reg_terms_match_jax(mode):
    """The regularizers at steps before, at and after the warmup gate and
    at the end of both temperature horizons (AdaRound's weighted by
    ``weight`` in 'brecq', by ``lmda_r`` in 'round'): rtol 1e-6."""
    _, jqs, s, tqs = _reg_state(mode)
    for step in (0, 19, 20, 21, 50, 74, 75, 99):
        want = float(JE._reg_terms(jqs, list(UNITS), jnp.float32(step), s,
                                   True))
        got = float(TE._reg_terms(tqs, list(UNITS), float(step), s))
        if step < 20:
            assert want == got == 0.0
        else:
            assert want > 0
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unported_modes_raise(tiny):
    """An unknown mode is a ValueError (the act phases have entry points
    of their own); an unknown loss form too."""
    ci, co = (torch.zeros((4, 8, 8, 8)),) * 2
    with pytest.raises(ValueError, match="act_delta"):
        TE.reconstruct_node(tiny["gt"], tiny["tparams"], tiny["tqs"], BLOCK,
                            ci, co, TE.ReconSettings(mode="act_delta"))
    with pytest.raises(ValueError, match="fisher_half"):
        TE.reconstruct_node(tiny["gt"], tiny["tparams"], tiny["tqs"], BLOCK,
                            ci, co, TE.ReconSettings(rec_loss="fisher_half",
                                                     iters=1, batch_size=4),
                            cached_grads=torch.ones((4, 8, 8, 8)))


# ---------------------------------------------------------------------------
# reconstruct_node trajectories
# ---------------------------------------------------------------------------

CASES = {
    # the reference's near-1 targets: unit dequant, no warm start, no refine
    "unit": dict(shift_targets=NEAR1),
    # the paper's coarse targets: effective dequant, warm start, refine
    "effective": dict(shift_targets=(0.5, 1.0), warmstart_frac=0.25),
    # gamma^z / phi^z trained beside the logits
    "output_affine": dict(shift_targets=(0.5, 1.0), opt_output_affine=True),
    # caches kept in bf16 (cache_dtype), widened per step
    "bf16_cache": dict(shift_targets=(0.5, 1.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_trajectory_matches_jax(tiny, case):
    n = 16
    ci, co = _caches(tiny, BLOCK, n)
    jci, jco, tci, tco = (jnp.asarray(ci), jnp.asarray(co),
                          torch.tensor(ci), torch.tensor(co))
    if case == "bf16_cache":
        jci, jco = jci.astype(jnp.bfloat16), jco.astype(jnp.bfloat16)
        tci, tco = (torch.tensor(np.asarray(a.astype(jnp.float32)))
                    .to(torch.bfloat16) for a in (jci, jco))
    base = dict(mode="fused", iters=40, batch_size=n, **CASES[case])
    jq, jm = JE.reconstruct_node(tiny["g"], tiny["params"], tiny["qs"],
                                 BLOCK, jci, jco, JE.ReconSettings(**base),
                                 jax.random.PRNGKey(2))
    tq, tm = TE.reconstruct_node(tiny["gt"], tiny["tparams"], tiny["tqs"],
                                 BLOCK, tci, tco, TE.ReconSettings(**base),
                                 seed=2)
    traces = [("rec_trace", jm["rec_trace"], tm["rec_trace"])]
    if case == "effective":
        assert tm["warmstart"]["iters"] == jm["warmstart"]["iters"] == 10
        np.testing.assert_allclose(
            float(tm["warmstart"]["presolve_hard_loss"]),
            float(jm["warmstart"]["presolve_hard_loss"]), rtol=RTOL)
        traces.append(("refine_trace", jm["refine_trace"],
                       tm["refine_trace"]))
        np.testing.assert_allclose(float(tm["hard_loss_prerefine"]),
                                   float(jm["hard_loss_prerefine"]),
                                   rtol=RTOL)
    assert ("refine_trace" in tm) == ("refine_trace" in jm)
    for name, want, got in traces:
        assert _a(got).shape == np.asarray(want).shape, name
        np.testing.assert_allclose(_a(got), np.asarray(want), rtol=RTOL,
                                   err_msg=name)
    for k in ("soft_loss", "hard_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL)
    for u in UNITS:
        jw, tw = jq[u].wq, tq[u].wq
        assert type(tw).__name__ == type(jw).__name__
        if isinstance(jw, JW.ShiftedScaleWQ):
            assert tw.hard_targets and tw.hard_round
            assert _flip_rate(_a(tw.beta) >= 0, np.asarray(jw.beta) >= 0) \
                <= FLIP_RATE
            assert _flip_rate(_a(tw.alpha).argmax(-1),
                              np.asarray(jw.alpha).argmax(-1)) <= FLIP_RATE
        else:
            assert tw.st_index is not None and not tw.soft
            assert _flip_rate(_a(tw.st_index), jw.st_index) <= FLIP_RATE
            assert _flip_rate(_a(tw.alpha) >= 0, np.asarray(jw.alpha) >= 0) \
                <= FLIP_RATE
        np.testing.assert_allclose(_a(tm["selection_ratio"][u]),
                                   np.asarray(jm["selection_ratio"][u]),
                                   atol=RATIO_ATOL)
        if case == "output_affine":
            np.testing.assert_allclose(_a(tq[u].alpha_out),
                                       np.asarray(jq[u].alpha_out),
                                       rtol=RTOL, atol=1e-6)
            assert float((tq[u].beta_out).abs().max()) > 0


def test_block_recon_improves(tiny):
    """tests/test_recon.py TestFusedRecon: the hardened loss beats the
    plain W2 quantizers', ratios are normalised, the result is a hard
    ShiftedScaleWQ; metrics report the incoming loss."""
    ci, co = TC.capture_io(tiny["gt"], tiny["tparams"], tiny["tqs"], BLOCK,
                           tiny["tcali"], TG.Flags(), TG.Flags(),
                           batch_size=32, device="cpu")
    s = TE.ReconSettings(mode="fused", iters=150, batch_size=16,
                         shift_targets=NEAR1)
    pre = TG.apply_node(TG.find_node(tiny["gt"], BLOCK), tiny["tparams"],
                        tiny["tqs"], ci[:16],
                        TG.Flags(weight_on=frozenset(UNITS)))
    pre_loss = float(TE.lp_loss_cl(pre, co[:16], 2.0))
    qs2, m = TE.reconstruct_node(tiny["gt"], tiny["tparams"], tiny["tqs"],
                                 BLOCK, ci, co, s, seed=2)
    np.testing.assert_allclose(float(m["init_loss"]), pre_loss, rtol=1e-6)
    assert float(m["hard_loss"]) < pre_loss
    assert m["rec_trace"].shape == (150,)
    for r in m["selection_ratio"].values():
        np.testing.assert_allclose(float(r.sum()), 1.0, atol=1e-6)
    wq = qs2[UNITS[0]].wq
    assert isinstance(wq, TW.ShiftedScaleWQ) and wq.hard_targets \
        and wq.hard_round


def test_rec_trace_decreases(tiny):
    ci, co = TC.capture_io(tiny["gt"], tiny["tparams"], tiny["tqs"],
                           "model.fc", tiny["tcali"], TG.Flags(), TG.Flags(),
                           batch_size=32, device="cpu")
    s = TE.ReconSettings(mode="fused", iters=200, batch_size=16,
                         shift_targets=NEAR1)
    _, m = TE.reconstruct_node(tiny["gt"], tiny["tparams"], tiny["tqs"],
                               "model.fc", ci, co, s, seed=3)
    tr = _a(m["rec_trace"])
    assert tr[-20:].mean() <= tr[:20].mean()


def test_warmstart_repairs_planted_imbalance():
    """tests/test_recon.py TestFusedWarmstart: with the shift pre-solve,
    the hardened st_index is exactly the pre-solve's argmax (rerun from the
    same derived seed), and tracks the planted pattern."""
    raw, scales = _planted_raw()
    st = _state(raw)
    ci, co = TC.capture_io(st["gt"], st["tparams"], st["tqs"], BLOCK,
                           st["tcali"], TG.Flags(), TG.Flags(),
                           batch_size=32, device="cpu")
    sts = (0.0625, 0.25, 1.0)
    base = dict(mode="fused", iters=80, batch_size=16, shift_targets=sts,
                fused_dequant="effective", opt_beta=True)
    qs_on, m_on = TE.reconstruct_node(
        st["gt"], st["tparams"], st["tqs"], BLOCK, ci, co,
        TE.ReconSettings(**base, warmstart_frac=0.25), seed=2)
    assert m_on["warmstart"]["iters"] == 20
    assert np.isfinite(float(m_on["hard_loss"]))
    s_ws = dataclasses.replace(TE.ReconSettings(**base, warmstart_frac=0.25),
                               mode="shift", iters=20)
    qs_ws, _ = TE.reconstruct_node(st["gt"], st["tparams"], st["tqs"], BLOCK,
                                   ci, co, s_ws, seed=TE._fold_in(2, 877))
    for u in UNITS:
        wq = qs_on[u].wq
        assert isinstance(wq, TW.AdaRoundWQ) and wq.st_index is not None
        np.testing.assert_array_equal(
            _a(wq.st_index), _a(qs_ws[u].wq.soft_targets().argmax(-1)))
    idx = _a(qs_on[UNITS[1]].wq.st_index).reshape(-1)
    expect = np.argmin(np.abs(np.asarray(sts)[None, :]
                              - (scales / scales.max())[:, None]), 1)
    assert float((idx == expect).mean()) >= 0.5, (idx, expect)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def test_pipeline_prefix_and_capture_session(tiny):
    """tests/test_recon.py TestPipeline and TestCaptureSession: the prefix
    accumulates node by node, the hook sees it, and the pipeline's
    CaptureSession route gives the same result as capture_io and
    reconstruct_node run by hand with the pipeline's node seeds."""
    s = TE.ReconSettings(mode="fused", iters=20, batch_size=16,
                         shift_targets=NEAR1)
    targets = [BLOCK, "model.fc"]
    seen = []
    qa, ha, pa = TP.reconstruct_model(
        tiny["gt"], tiny["tparams"], tiny["tqs"], targets, tiny["tcali"], s,
        seed=7, batch_size=32, device="cpu",
        on_node_done=lambda n, q, m, f: seen.append((n, set(f.weight_on))))
    assert [n for n, _ in seen] == targets
    assert seen[0][1] == set(UNITS)
    assert seen[1][1] == set(UNITS) | {"model.fc"} == set(pa.weight_on)
    assert set(ha) == set(targets)
    for m in ha.values():
        assert m["capture_s"] >= 0 and m["recon_s"] > 0
        assert m["wall_s"] >= m["capture_s"] + m["recon_s"] - 1e-6
    qb, prefix, hb = tiny["tqs"], TG.Flags(), {}
    for name, seed in zip(targets, TP.node_seeds(7, len(targets))):
        ci, co = TC.capture_io(tiny["gt"], tiny["tparams"], qb, name,
                               tiny["tcali"], prefix, TG.Flags(),
                               batch_size=32, device="cpu")
        qb, hb[name] = TE.reconstruct_node(tiny["gt"], tiny["tparams"], qb,
                                           name, ci, co, s, seed=seed)
        prefix = TG.Flags(weight_on=frozenset(seen[len(hb) - 1][1]))
    np.testing.assert_allclose(_a(qa["model.fc"].wq.alpha),
                               _a(qb["model.fc"].wq.alpha), rtol=1e-4,
                               atol=1e-5)
    for name in targets:
        np.testing.assert_allclose(_a(ha[name]["rec_trace"]),
                                   _a(hb[name]["rec_trace"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_slice_end_to_end_matches_jax():
    """prepare -> calibrate -> reconstruct both targets (fused, targets
    {1/2, 1}, warm start 0.25, refine 0.5) -> re-calibrate with the prefix
    -> sim forward with every act site on -> deploy, in both packages from
    the same raw weights and images (cache N = batch_size). The port's
    final sim and deploy logits against JAX's: rel-MSE <= 1e-6, the same
    top-1; each package's deploy within the bench gate of its sim
    (1e-2)."""
    g = _jax_tiny_graph()
    gt = _port_graph(g)
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    x = np.random.default_rng(5).normal(size=(16, 8, 8, 3)) \
        .astype(np.float32)
    jcfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4)
    tcfg = TQZ.QuantConfig(n_bits_w=2, n_bits_a=4)
    kw = dict(mode="fused", iters=40, batch_size=16, shift_targets=(0.5, 1.0),
              warmstart_frac=0.25, post_round_frac=0.5)

    params, qs = ssq.prepare_model(g, raw, jcfg)
    wflags = JG.Flags().all_weights(g)
    qs = ssq.calibrate_acts(g, params, qs, jnp.asarray(x), jcfg, flags=wflags)
    targets = JQZ.reconstruction_targets(g)
    assert targets == TQZ.reconstruction_targets(gt) == [BLOCK, "model.fc"]
    qs, _, prefix = JP.reconstruct_model(
        g, params, qs, targets, jnp.asarray(x), JE.ReconSettings(**kw),
        jax.random.PRNGKey(0), batch_size=16)
    qs = ssq.calibrate_acts(g, params, qs, jnp.asarray(x), jcfg, flags=prefix)
    aflags = JQZ.act_flags(g, jcfg, base=wflags)
    jsim = np.asarray(ssq.forward(g, params, qs, jnp.asarray(x), aflags))
    jdp = JD.build_deploy_params(g, params, qs)
    jsteps = JD.act_steps_from_qstate(g, qs)
    jdep = np.asarray(JD.deploy_forward(g, jdp, jsteps, jnp.asarray(x)))

    tparams, tqs = tp.prepare_model(gt, _np(raw), tcfg, device="cpu")
    twflags = TG.Flags().all_weights(gt)
    tx = torch.tensor(x)
    tqs = tp.calibrate_acts(gt, tparams, tqs, tx, tcfg, flags=twflags,
                            device="cpu")
    tqs, hist, tprefix = TP.reconstruct_model(
        gt, tparams, tqs, targets, tx, TE.ReconSettings(**kw), seed=0,
        batch_size=16, device="cpu")
    assert tprefix.weight_on == prefix.weight_on
    tqs = tp.calibrate_acts(gt, tparams, tqs, tx, tcfg, flags=tprefix,
                            device="cpu")
    tsim = _a(tp.forward(gt, tparams, tqs, tx,
                         TQZ.act_flags(gt, tcfg, base=twflags),
                         device="cpu"))
    tdp = TD.build_deploy_params(gt, tparams, tqs, device="cpu")
    tdep = _a(TD.deploy_forward(gt, tdp, TD.act_steps_from_qstate(gt, tqs),
                                tx, device="cpu"))

    def rel(a, b):
        return float(((a - b) ** 2).mean() / (b ** 2).mean())
    assert rel(tsim, jsim) <= 1e-6 and rel(tdep, jdep) <= 1e-6
    np.testing.assert_array_equal(tsim.argmax(-1), jsim.argmax(-1))
    np.testing.assert_array_equal(tdep.argmax(-1), jdep.argmax(-1))
    assert rel(tdep, tsim) <= 1e-2 and rel(jdep, jsim) <= 1e-2
    assert all(np.isfinite(float(m["hard_loss"])) for m in hist.values())
