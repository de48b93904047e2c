"""PyTorch port vs the JAX package: the Fisher-weighted reconstruction
(``recon/capture.capture_grads``, the 'fisher_diag' and 'fisher_full'
loss forms of ``recon/engine.py`` and their trajectories), on the CPU;
each case of ``tests/test_fisher.py``.

State is made by the JAX package and carried across
(``utils/jax_import``): ResNet-18 (CIFAR variant) W2A4 with max scales, as
the JAX test's setup, on 40 numpy-drawn 16x16 images (a batch of 32 and a
short one of 8). Tolerances: the gradients within 1e-4 of their largest
value, compared without the damping: ``capture_grads(damping=0)`` is
g - 1 computed exactly (``max|g0 - g0_jax| <= 1e-4 * max(g0_jax)``; g
itself is 1 + a signal of about 1e-3 here, so comparing g would pass on
any small signal, and f32 holds g - 1 only to one ulp of 1, 1.2e-7),
row by row: a relu input that lands within rounding of zero passes the
gradient in one package and not in the other (row 14 of layer3.0's
output: 2.4e-6 where the tensor reaches 69; the JAX package's value
agrees with a float64 run there, the port's not, and elsewhere the
other way), so at most one row in 40 (ROW_FLIPS) may exceed the bound;
the loss forms within rtol 1e-6; trajectories at N =
batch_size rows (every step sees all rows, only summation orders
differ), traces and losses within rtol 1e-4 over 40 steps, hardened codes
within a flip rate of 0.5%.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu import graph as JG
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.recon import capture as JC
from shiftedscalequantization_tpu.recon import engine as JE
from shiftedscalequantization_tpu_torch import graph as TG
from shiftedscalequantization_tpu_torch.recon import capture as TC
from shiftedscalequantization_tpu_torch.recon import engine as TE
from shiftedscalequantization_tpu_torch.utils import jax_import as JI
from test_torch_port_recon import NEAR1, _a, _flip_rate, _np, _port_graph

GRAD_TOL = 1e-4
ROW_FLIPS = 1 / 40
LOSS_RTOL = 1e-6
RTOL = 1e-4
FLIP_RATE = 0.005
N = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores, and small ops on threads that wait for busy cores
    run hundreds of times slower)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def net():
    """tests/test_fisher.py's setup, in both packages."""
    g = JR.build_resnet(18, num_classes=10, variant="cifar")
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          use_8bit_head_stem=False)
    params, qs = ssq.prepare_model(g, raw, cfg)
    cali = np.random.default_rng(1).normal(size=(40, 16, 16, 3)) \
        .astype(np.float32)
    return dict(g=g, params=params, qs=qs, cali=cali, gt=_port_graph(g),
                tparams=JI.params_from_numpy(_np(params), "cpu"),
                tqs=JI.qstate_from_numpy(_np(qs), "cpu"),
                tcali=torch.tensor(cali))


def _grads(net, target, n=None, **kw):
    """(JAX grads, port grads) of ``target`` on the first ``n`` rows,
    without the damping."""
    kw.setdefault("damping", 0.0)
    want = JC.capture_grads(net["g"], net["params"], net["qs"], target,
                            jnp.asarray(net["cali"][:n]), batch_size=32,
                            **kw)
    got = TC.capture_grads(net["gt"], net["tparams"], net["tqs"], target,
                           net["tcali"][:n], batch_size=32, device="cpu",
                           **kw)
    return np.asarray(want), _a(got)


def _check_rows(got, want):
    """max|got - want| <= GRAD_TOL * max(want) on every row but a share
    ROW_FLIPS of them."""
    signal = float(want.max())
    assert signal > 0
    rows = np.abs(got - want).reshape(got.shape[0], -1).max(axis=1)
    bad = rows > GRAD_TOL * signal
    assert bad.mean() <= ROW_FLIPS, (rows.max() / signal, np.flatnonzero(bad))


# ---------------------------------------------------------------------------
# TestForwardFrom / TestNestedTargetGrads: the forwards capture_grads uses
# ---------------------------------------------------------------------------

def test_resume_equals_full(net):
    name = "model.layer2.0"
    flags = TG.Flags().all_weights(net["gt"])
    x = net["tcali"][:8]
    full = TG.forward(net["gt"], net["tparams"], net["tqs"], x, flags,
                      device="cpu")
    _, t = TG.forward(net["gt"], net["tparams"], net["tqs"], x, flags,
                      capture=name, device="cpu")
    resumed = TG.forward_from(net["gt"], net["tparams"], net["tqs"], name, t,
                              flags)
    np.testing.assert_allclose(_a(resumed), _a(full), rtol=1e-5, atol=1e-5)
    want = JG.forward(net["g"], net["params"], net["qs"],
                      jnp.asarray(net["cali"][:8]),
                      JG.Flags().all_weights(net["g"]))
    np.testing.assert_allclose(_a(full), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("target", ["model.layer1.1", "model.layer1.0.conv1",
                                    "model.layer2.0.downsample.0",
                                    "model.fc"])
def test_prefix_flags_till_matches_jax(net, target):
    for act_quant in (False, True):
        want = JG.prefix_flags_till(net["g"], target, act_quant=act_quant)
        got = TG.prefix_flags_till(net["gt"], target, act_quant=act_quant)
        assert got.weight_on == want.weight_on
        assert got.act_on == want.act_on
    f = TG.prefix_flags_till(net["gt"], "model.layer1.0.conv1")
    assert "model.layer1.0.conv1" in f.weight_on
    assert "model.layer1.0.conv2" not in f.weight_on
    f = TG.prefix_flags_till(net["gt"], "model.layer1.1")
    assert {"model.conv1", "model.layer1.1.conv2"} <= f.weight_on
    assert "model.layer2.0.conv1" not in f.weight_on


def test_inject_matches_forward(net):
    flags = TG.Flags().all_weights(net["gt"])
    name = "model.layer2.0.conv1"
    x = net["tcali"][:4]
    _, t = TG.forward(net["gt"], net["tparams"], net["tqs"], x, flags,
                      capture=name, device="cpu")
    full = TG.forward(net["gt"], net["tparams"], net["tqs"], x, flags,
                      device="cpu")
    injected = TG.forward_inject(net["gt"], net["tparams"], net["tqs"], x,
                                 name, t, flags)
    np.testing.assert_allclose(_a(injected), _a(full), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# TestGradCapture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["model.layer1.0", "model.layer2.0",
                                    "model.layer1.0.conv1",
                                    "model.layer3.0.conv1"])
def test_capture_grads_match_jax(net, target):
    """A block and nested units, 40 rows in batches of 32 and 8: the
    short batch's KL mean divides by 32, as the JAX package's padded
    batch does. With the default damping every value is 1 + |grad|."""
    want, got = _grads(net, target)
    assert got.shape == want.shape and got.shape[0] == 40
    _check_rows(got, want)
    g = _a(TC.capture_grads(net["gt"], net["tparams"], net["tqs"], target,
                            net["tcali"], batch_size=32, device="cpu"))
    assert float(g.min()) >= 1.0 and float(g.max()) > 1.0
    np.testing.assert_array_equal(g, got + np.float32(1.0))


def test_fp_prefix_gives_signal_from_quant(net):
    """The deepest block: the quantized prefix moves the output, so the
    gradients are not all zero."""
    want, got = _grads(net, "model.layer4.1", n=32)
    assert float(got.max()) > 0.0
    _check_rows(got, want)


# ---------------------------------------------------------------------------
# the loss forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fisher_diag", "fisher_full"])
@pytest.mark.parametrize("shape", [(4, 5, 5, 6), (8, 10)], ids=["nhwc", "nc"])
def test_loss_forms_match_jax(kind, shape):
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    g = (np.abs(rng.normal(size=shape)) + 1.0).astype(np.float32)
    want = float(JE.rec_loss_fn(a, b, g, kind, 2.0))
    got = float(TE.rec_loss_fn(torch.tensor(a), torch.tensor(b),
                               torch.tensor(g), kind, 2.0))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # without gradients every form is the L_p loss
    np.testing.assert_allclose(
        float(TE.rec_loss_fn(torch.tensor(a), torch.tensor(b), None, kind,
                             2.0)),
        float(JE.lp_loss_cl(a, b, 2.0)), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# TestFisherRecon: trajectories
# ---------------------------------------------------------------------------

CASES = {
    # tests/test_fisher.py's fisher_diag case: the near-1 targets
    "diag_unit": dict(node="model.layer1.0", rec_loss="fisher_diag",
                      mode="fused", shift_targets=NEAR1),
    # the coarse targets: the warm start and the refine take the grads too
    "diag_effective": dict(node="model.layer1.0", rec_loss="fisher_diag",
                           mode="fused", shift_targets=(0.5, 1.0),
                           warmstart_frac=0.25),
    # tests/test_fisher.py's fisher_full case: brecq on the fc, drawn grads
    "full_fc": dict(node="model.fc", rec_loss="fisher_full", mode="brecq"),
}


def _case(net, case, drawn=False):
    """(node, caches, grads, settings) of a case; ``drawn``: 1 + |normal|
    grads, whose weights vary far more than the quantized net's."""
    kw = dict(CASES[case])
    node = kw.pop("node")
    ci, co = JC.capture_io(net["g"], net["params"], net["qs"], node,
                           jnp.asarray(net["cali"][:N]), JG.Flags(),
                           JG.Flags(), batch_size=N)
    if case == "full_fc" or drawn:
        grads = np.abs(np.random.default_rng(9).normal(
            size=co.shape)).astype(np.float32) + 1.0
    else:
        grads = np.asarray(JC.capture_grads(
            net["g"], net["params"], net["qs"], node,
            jnp.asarray(net["cali"][:N]), batch_size=N))
    return node, np.asarray(ci), np.asarray(co), grads, \
        dict(iters=40, batch_size=N, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_fisher_trajectory_matches_jax(net, case):
    node, ci, co, grads, kw = _case(net, case)
    jq, jm = JE.reconstruct_node(
        net["g"], net["params"], net["qs"], node, jnp.asarray(ci),
        jnp.asarray(co), JE.ReconSettings(**kw), jax.random.PRNGKey(3),
        cached_grads=jnp.asarray(grads))
    tq, tm = TE.reconstruct_node(
        net["gt"], net["tparams"], net["tqs"], node, torch.tensor(ci),
        torch.tensor(co), TE.ReconSettings(**kw), seed=3,
        cached_grads=torch.tensor(grads))
    traces = [("rec_trace", jm["rec_trace"], tm["rec_trace"])]
    if case == "diag_effective":
        np.testing.assert_allclose(
            float(tm["warmstart"]["presolve_hard_loss"]),
            float(jm["warmstart"]["presolve_hard_loss"]), rtol=RTOL)
        traces.append(("refine_trace", jm["refine_trace"],
                       tm["refine_trace"]))
    for name, want, got in traces:
        np.testing.assert_allclose(_a(got), np.asarray(want), rtol=RTOL,
                                   err_msg=name)
    assert np.isfinite(_a(tm["rec_trace"])).all()
    for k in ("init_loss", "soft_loss", "hard_loss"):
        if k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=RTOL, err_msg=k)
    for u in jq:
        jw = getattr(jq[u], "wq", None)
        if jw is None or jw is net["qs"][u].wq:
            continue
        tw = tq[u].wq
        assert type(tw).__name__ == type(jw).__name__, u
        if hasattr(jw, "st_index") and jw.st_index is not None:
            assert _flip_rate(_a(tw.st_index), jw.st_index) <= FLIP_RATE
        logits = jw.beta if hasattr(jw, "beta") else jw.alpha
        tl = tw.beta if hasattr(tw, "beta") else tw.alpha
        assert _flip_rate(_a(tl) >= 0, np.asarray(logits) >= 0) <= FLIP_RATE
    if case == "diag_unit":
        tr = _a(tm["rec_trace"])
        assert tr[-10:].mean() <= tr[:5].mean() * 1.5


@pytest.mark.parametrize("case", ["diag_unit", "full_fc"])
def test_fisher_trace_differs_from_mse(net, case):
    """The Fisher forms are taken: on the same caches and rows, their
    trace is not the 'mse' one (rec_loss_fn falls back to the L_p loss
    when a path drops the grads). The grads are drawn: the quantized
    net's (1 + about 1e-3) weight the block's L2 loss nearly evenly."""
    node, ci, co, grads, kw = _case(net, case, drawn=True)
    args = (net["gt"], net["tparams"], net["tqs"], node, torch.tensor(ci),
            torch.tensor(co))
    _, fm = TE.reconstruct_node(*args, TE.ReconSettings(**kw), seed=3,
                                cached_grads=torch.tensor(grads))
    _, mm = TE.reconstruct_node(
        *args, TE.ReconSettings(**dict(kw, rec_loss="mse")), seed=3)
    _, nm = TE.reconstruct_node(*args, TE.ReconSettings(**kw), seed=3)
    f, m, n = (_a(x["rec_trace"]) for x in (fm, mm, nm))
    assert not np.allclose(f, m, rtol=1e-3)
    np.testing.assert_array_equal(n, m)       # no grads: the L_p loss
    # fisher_diag with unit grads is the L_2 loss
    if case == "diag_unit":
        _, um = TE.reconstruct_node(*args, TE.ReconSettings(**kw), seed=3,
                                    cached_grads=torch.ones_like(
                                        torch.tensor(grads)))
        p2 = TE.ReconSettings(**dict(kw, rec_loss="mse", p=2.0))
        _, m2 = TE.reconstruct_node(*args, p2, seed=3)
        np.testing.assert_allclose(_a(um["rec_trace"]), _a(m2["rec_trace"]),
                                   rtol=1e-6)


def test_pipeline_caches_grads_per_target(net):
    """reconstruct_model with a Fisher rec_loss hands each target the
    gradients of capture_grads with the capture's batching and reports
    their seconds; with 'mse' it takes none."""
    from shiftedscalequantization_tpu_torch.recon import pipeline as TP
    seen = {}
    real = TP.capture_grads

    def record(*a, **kw):
        out = real(*a, **kw)
        seen[a[3]] = (out.shape, kw["batch_size"])
        return out

    targets = ["model.layer1.0", "model.layer1.1"]
    s = TE.ReconSettings(mode="brecq", iters=4, batch_size=16,
                         rec_loss="fisher_diag")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "capture_grads", record)
        _, hist, _ = TP.reconstruct_model(
            net["gt"], net["tparams"], net["tqs"], targets, net["tcali"], s,
            seed=0, batch_size=32, device="cpu")
        assert seen == {t: ((40, 16, 16, 64), 32) for t in targets}
        assert all(hist[t]["grads_s"] > 0 for t in targets)
        seen.clear()
        TP.reconstruct_model(
            net["gt"], net["tparams"], net["tqs"], targets[:1],
            net["tcali"], dataclasses.replace(s, rec_loss="mse"), seed=0,
            batch_size=32, device="cpu")
        assert not seen
