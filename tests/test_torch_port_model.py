"""PyTorch port vs the JAX package: graph, ResNet builder, sim forward,
prepare_model and calibrate_acts.

The two packages draw different random numbers, so weights and quantizer
state are made by the JAX package and carried to the port with
``utils/jax_import``. The port runs on the CPU.

Random-weight W2A4/W4A4 nets are chaotic: one act code that lands within
1e-7 of a rounding tie flips under a different summation order, and the
flip spreads. Where a test compares through quantizers it says how it
keeps the two sides on identical values.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu.graph import find_node
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.models import zoo as JZ
from shiftedscalequantization_tpu.quantize import act_flags as j_act_flags
import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import graph as TG
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.quantize import \
    act_flags as t_act_flags
from shiftedscalequantization_tpu_torch.utils import jax_import as JI


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


def _images(n, hw, seed=1, grid=False):
    x = np.random.default_rng(seed).normal(size=(n, hw, hw, 3))
    if grid:
        x = np.round(x * 8) / 8
    return x.astype(np.float32)


@pytest.mark.parametrize("dataset", ["imagenet", "cifar10"])
def test_zoo_graph_and_param_shapes_match_jax(dataset):
    gj, _ = JZ.build("resnet18", num_classes=10, dataset=dataset)
    gt, key_map = TZ.build("resnet18", num_classes=10, dataset=dataset)
    assert [dataclasses.asdict(n) for n in gt] == \
        [dataclasses.asdict(n) for n in gj]
    assert key_map(gt) == JR.torch_key_map(gj)
    assert [n.name for n in TG.iter_nodes(gt)] == [n.name for n in gj]
    for name in ("model.conv1", "model.layer2.0",
                 "model.layer3.0.downsample.0", "model.layer4.1.conv2"):
        assert dataclasses.asdict(TG.find_node(gt, name)) == \
            dataclasses.asdict(find_node(gj, name))
    with pytest.raises(KeyError):
        TG.find_node(gt, "model.layer9")
    pj = JR.init_params(jax.random.PRNGKey(0), gj)
    pt = TZ.init_params(gt, seed=0, device="cpu")
    assert set(pt) == set(pj)
    for name in pj:
        assert tuple(pt[name]["w"].shape) == pj[name]["w"].shape
        assert set(pt[name]) == set(pj[name])
    # He-normal: the port's draws have the JAX package's spread
    w = pt["model.layer3.0.conv2"]["w"]
    assert abs(float(w.std()) / np.sqrt(2.0 / (256 * 9)) - 1) < 0.05


@pytest.mark.parametrize("dataset,hw", [("imagenet", 64), ("cifar10", 32)])
def test_fp_forward_matches_jax(dataset, hw):
    """Float forward (no quantizers) of BN-folded params: only f32
    summation order differs, rel-MSE <= 1e-8."""
    g, _ = JZ.build("resnet18", num_classes=10, dataset=dataset)
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=4, n_bits_a=8)
    params, qs = ssq.prepare_model(g, raw, cfg)
    x = _images(4, hw)
    want = ssq.forward(g, params, qs, jnp.asarray(x), ssq.Flags())
    gt, _ = TZ.build("resnet18", num_classes=10, dataset=dataset)
    got = tp.forward(gt, JI.params_from_numpy(_np(params), "cpu"),
                     JI.qstate_from_numpy(_np(qs), "cpu"), torch.as_tensor(x),
                     tp.Flags(), device="cpu")
    assert tuple(got.shape) == (4, 10)
    assert _rel_mse(got.numpy(), want) <= 1e-8


def _pow2(a):
    return jnp.asarray(2.0 ** np.round(np.log2(np.asarray(a))), jnp.float32)


def _dyadic(qs):
    """Snap every weight and act step to the nearest power of two. Then
    every fake-quant value is a short dyadic number, each product in a conv
    is exact, and every partial sum is exact in f32 (at most 255 * 8 * 4608
    units < 2^24), so the sim forward no longer depends on summation
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


@pytest.mark.parametrize("nbw,nba", [(4, 8), (2, 4)])
def test_quantized_sim_forward_matches_jax(nbw, nba):
    """Fake-quant forward on carried state, all weight and act quantizers
    on. A random-weight net is chaotic under a change of summation order,
    so the state's steps are snapped to powers of two (_dyadic) and the
    images to multiples of 1/8: both packages then compute exactly the
    same values, rel-MSE <= 1e-8 (without the snap: 6e-5 at W4A8)."""
    g, _ = JZ.build("resnet18", num_classes=10)
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=nbw, n_bits_a=nba)
    params, qs = ssq.prepare_model(g, raw, cfg)
    x = _images(4, 64, grid=True)
    qs = _dyadic(ssq.calibrate_acts(g, params, qs, jnp.asarray(x), cfg))
    flags = j_act_flags(g, cfg, base=ssq.Flags().all_weights(g))
    want = ssq.forward(g, params, qs, jnp.asarray(x), flags)
    gt, _ = TZ.build("resnet18", num_classes=10)
    tcfg = tp.QuantConfig(n_bits_w=nbw, n_bits_a=nba)
    tflags = t_act_flags(gt, tcfg, base=tp.Flags().all_weights(gt))
    assert (tflags.weight_on, tflags.act_on) == (flags.weight_on,
                                                 flags.act_on)
    got = tp.forward(gt, JI.params_from_numpy(_np(params), "cpu"),
                     JI.qstate_from_numpy(_np(qs), "cpu"), torch.as_tensor(x),
                     tflags, device="cpu")
    assert _rel_mse(got.numpy(), want) <= 1e-8


def test_prepare_model_matches_jax():
    """BN fold rtol 1e-6; per-unit weight QParams (MSE grid, 8-bit head and
    stem) rtol 1e-5 — the weights are identical inputs."""
    g, _ = JZ.build("resnet18", num_classes=10)
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4)
    params, qs = ssq.prepare_model(g, raw, cfg)
    gt, _ = TZ.build("resnet18", num_classes=10)
    tparams, tqs = tp.prepare_model(
        gt, JI.params_from_numpy(_np(raw), "cpu"),
        tp.QuantConfig(n_bits_w=2, n_bits_a=4), device="cpu")
    for name, uq in qs.items():
        for k in ("w", "b"):
            np.testing.assert_allclose(tparams[name][k].numpy(),
                                       np.asarray(params[name][k]),
                                       rtol=1e-6, atol=1e-7)
        tq = tqs[name]
        assert tq.wq.qp.n_bits == uq.wq.qp.n_bits
        np.testing.assert_allclose(tq.wq.qp.delta.numpy(),
                                   np.asarray(uq.wq.qp.delta), rtol=1e-5)
        np.testing.assert_allclose(tq.wq.qp.zero_point.numpy(),
                                   np.asarray(uq.wq.qp.zero_point),
                                   rtol=1e-5)
    assert tqs["model.conv1"].wq.qp.n_bits == 8
    assert tqs["model.fc"].wq.qp.n_bits == 8


def test_calibrate_acts_matches_jax():
    """Per-site act deltas and zero points after the port's own
    prepare_model + calibrate_acts, rtol 1e-5. W4A4 with MSE scales on
    grid-valued images: the stem's conv inputs are exact, and at this
    fixture no site's MSE search sits on a near-tie, so both packages see
    the same tensors at every site (measured max rel diff 8e-7). Other
    fixtures let one flipped code move a later site's MSE minimum by a
    grid step; the search itself is held to rtol 1e-6 on identical
    tensors in test_torch_port_quant.py."""
    g, _ = JZ.build("resnet18", num_classes=10)
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=4, n_bits_a=4)
    params, qs = ssq.prepare_model(g, raw, cfg)
    x = _images(8, 64, grid=True)
    qs = ssq.calibrate_acts(g, params, qs, jnp.asarray(x), cfg)
    gt, _ = TZ.build("resnet18", num_classes=10)
    tcfg = tp.QuantConfig(n_bits_w=4, n_bits_a=4)
    tparams, tqs = tp.prepare_model(
        gt, JI.params_from_numpy(_np(raw), "cpu"), tcfg, device="cpu")
    tqs = tp.calibrate_acts(gt, tparams, tqs, torch.as_tensor(x), tcfg,
                            device="cpu")
    sites = 0
    for name, v in qs.items():
        aj = v.aq if isinstance(v, ssq.UnitQuant) else v
        at = tqs[name].aq if isinstance(tqs[name], tp.UnitQuant) \
            else tqs[name]
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
    assert sites == 17      # 8 block sites + 8 conv1 sites + the stem


def test_sim_forward_runs_without_tf32(monkeypatch):
    """The sim forward's convs and matmuls run with TF32 off (the JAX
    package asks for Precision.HIGHEST), and the flags come back after."""
    seen = []
    real_conv = TG.F.conv2d

    def spy(*a, **k):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return real_conv(*a, **k)

    monkeypatch.setattr(TG.F, "conv2d", spy)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gt, _ = TZ.build("resnet18", num_classes=10, dataset="cifar10")
        params, qs = tp.prepare_model(
            gt, TZ.init_params(gt, seed=0, device="cpu"),
            tp.QuantConfig(w_scale_method="max"), device="cpu")
        tp.forward(gt, params, qs, torch.zeros((1, 32, 32, 3)),
                   tp.Flags().all_weights(gt), device="cpu")
        assert seen and all(s == (False, False) for s in seen)
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False


def test_uncalibrated_act_site_raises():
    gt, _ = TZ.build("resnet18", num_classes=10, dataset="cifar10")
    cfg = tp.QuantConfig(w_scale_method="max")
    params, qs = tp.prepare_model(gt, TZ.init_params(gt, device="cpu"), cfg,
                                  device="cpu")
    with pytest.raises(ValueError, match="not calibrated"):
        tp.forward(gt, params, qs, torch.zeros((1, 32, 32, 3)),
                   t_act_flags(gt, cfg), device="cpu")
    with pytest.raises(KeyError):
        tp.calibrate_acts(gt, params, qs, torch.zeros((1, 32, 32, 3)), cfg,
                          bit_overrides={"model.nope": 8}, device="cpu")
