"""PyTorch port vs the JAX package: the capture API of ``graph.py``,
``quantize.reconstruction_targets`` / ``harmonize_residual_chains`` and
``recon/capture.py`` (``capture_io``, ``CaptureSession``), on the CPU.

Weights and quantizer state are made by the JAX package and carried across
(``utils/jax_import``). Captured tensors pass through W2 weight quantizers
and convs summed in another order; against the JAX package they are held
to an absolute error of 1e-5 times the tensor's largest magnitude
(``_close``), the tiny model's captures to atol 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu import graph as JG
from shiftedscalequantization_tpu import quantize as JQZ
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.models import zoo as JZ
from shiftedscalequantization_tpu.ops import wquant as JW
from shiftedscalequantization_tpu.recon import capture as JC
from shiftedscalequantization_tpu_torch import graph as TG
from shiftedscalequantization_tpu_torch import quantize as TQZ
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.ops import wquant as TW
from shiftedscalequantization_tpu_torch.recon import capture as TC
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

BLOCK = "model.layer1.0"
INNER = "model.layer1.0.conv2"


def _jax_tiny_graph():
    """tests/test_recon.py's tiny model: stem, one basic block, gap, fc."""
    U, B = JG.UnitSpec, JG.BlockSpec
    conv1 = U("model.conv1", "conv", 3, 8, kernel=(3, 3), stride=(1, 1),
              padding=(1, 1), activation="relu", has_bn=True)
    block = B(BLOCK, units=(
        U("model.layer1.0.conv1", "conv", 8, 8, kernel=(3, 3),
          padding=(1, 1), activation="relu", has_bn=True),
        U(INNER, "conv", 8, 8, kernel=(3, 3), padding=(1, 1),
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


def _close(got, want, rel=1e-5):
    got, want = _a(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


@pytest.fixture(scope="module")
def tiny():
    g = _jax_tiny_graph()
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          use_8bit_head_stem=False)
    params, qstate = ssq.prepare_model(g, raw, cfg)
    cali = np.random.default_rng(1).normal(size=(64, 8, 8, 3)) \
        .astype(np.float32)
    return dict(g=g, params=params, qs=qstate, cali=cali, gt=_port_graph(g),
                tparams=JI.params_from_numpy(_np(params), "cpu"),
                tqs=JI.qstate_from_numpy(_np(qstate), "cpu"),
                tcali=torch.as_tensor(cali))


@pytest.fixture(scope="module")
def cifar():
    """CIFAR ResNet-18 W2A4, calibrated by the JAX package."""
    g, _ = JZ.build("resnet18", num_classes=10, dataset="cifar10")
    raw = JR.init_params(jax.random.PRNGKey(3), g)
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          a_scale_method="max")
    params, qs = ssq.prepare_model(g, raw, cfg)
    x = np.random.default_rng(4).normal(size=(8, 32, 32, 3)) \
        .astype(np.float32)
    qs = ssq.calibrate_acts(g, params, qs, jnp.asarray(x), cfg)
    gt, _ = TZ.build("resnet18", num_classes=10, dataset="cifar10")
    return dict(g=g, params=params, qs=qs, x=x, cfg=cfg, gt=gt,
                tparams=JI.params_from_numpy(_np(params), "cpu"),
                tqs=JI.qstate_from_numpy(_np(qs), "cpu"))


# ---------------------------------------------------------------------------
# graph.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", [
    "model.layer2.0", "model.layer2.0.downsample.0", "model.layer3.1.conv1"])
def test_forward_capture_matches_jax(cifar, target):
    """A block, a downsample and an inner unit, captured with the weight
    prefix quantized. (With act quantizers on, random W2A4 nets are
    chaotic: a code on a rounding tie flips under another summation order,
    tests/test_torch_port_model.py.)"""
    c = cifar
    flags = JG.prefix_flags_till(c["g"], "model.layer1.1")
    tflags = TG.prefix_flags_till(c["gt"], "model.layer1.1")
    assert tflags == TG.Flags(weight_on=flags.weight_on, act_on=flags.act_on)
    ji, jo = ssq.forward(c["g"], c["params"], c["qs"], jnp.asarray(c["x"]),
                         flags, capture=target)
    ti, to = TG.forward(c["gt"], c["tparams"], c["tqs"],
                        torch.as_tensor(c["x"]), tflags, capture=target,
                        device="cpu")
    _close(ti, ji)
    _close(to, jo)
    with pytest.raises(KeyError):
        TG.forward(c["gt"], c["tparams"], c["tqs"], torch.as_tensor(c["x"]),
                   tflags, capture="model.layer9", device="cpu")


def test_multi_capture_apply_node_and_inject_match_jax(cifar):
    """forward_multi_capture with dynamic weight gates; apply_node and
    apply_node_multi_capture on the captured input; forward_from and
    forward_inject, and the gradient at an injected inner unit."""
    c = cifar
    g, gt, x = c["g"], c["gt"], c["x"]
    targets = ["model.layer1.0", "model.layer2.0.conv1", "model.fc"]
    gates = {"model.conv1": True, "model.layer1.0.conv1": False}
    jm = JG.forward_multi_capture(
        g, c["params"], c["qs"], jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in gates.items()}, targets)
    tm = TG.forward_multi_capture(
        gt, c["tparams"], c["tqs"], torch.as_tensor(x),
        {k: torch.tensor(v) for k, v in gates.items()}, targets,
        device="cpu")
    assert set(tm) == set(targets)
    for k in targets:
        for a, b in zip(tm[k], jm[k]):
            _close(a, b)

    node = TG.find_node(gt, "model.layer2.0")
    flags = TG.Flags(weight_on=frozenset(TG.node_unit_names(node)))
    jflags = JG.Flags(weight_on=flags.weight_on)
    xin = tm["model.layer2.0.conv1"][0].clone().requires_grad_(True)
    out = TG.apply_node(node, c["tparams"], c["tqs"], xin, flags)
    jout = JG.apply_node(JG.find_node(g, "model.layer2.0"), c["params"],
                         c["qs"], jnp.asarray(_a(xin)), jflags)
    _close(out, jout)
    out.sum().backward()                 # apply_node lets gradients through
    assert xin.grad is not None and float(xin.grad.abs().sum()) > 0
    out2, caps = TG.apply_node_multi_capture(
        node, c["tparams"], c["tqs"], xin.detach(), flags,
        ["model.layer2.0.conv2", "model.layer2.0"])
    _, jcaps = JG.apply_node_multi_capture(
        JG.find_node(g, "model.layer2.0"), c["params"], c["qs"],
        jnp.asarray(_a(xin)), jflags, ["model.layer2.0.conv2",
                                       "model.layer2.0"])
    np.testing.assert_array_equal(_a(out2), _a(out))
    for k in jcaps:
        for a, b in zip(caps[k], jcaps[k]):
            _close(a, b)

    t = torch.tensor(np.asarray(jm["model.layer1.0"][1]))
    _close(TG.forward_from(gt, c["tparams"], c["tqs"], "model.layer1.0", t),
           JG.forward_from(g, c["params"], c["qs"], "model.layer1.0",
                           jm["model.layer1.0"][1]))
    with pytest.raises(KeyError):
        TG.forward_from(gt, c["tparams"], c["tqs"], "model.nope", t)

    inner = "model.layer2.0.conv1"
    ti = tm[inner][1].clone().requires_grad_(True)
    loss = TG.forward_inject(gt, c["tparams"], c["tqs"], torch.as_tensor(x),
                             inner, ti).pow(2).sum()
    loss.backward()
    jg = jax.grad(lambda t: (JG.forward_inject(
        g, c["params"], c["qs"], jnp.asarray(x), inner, t) ** 2).sum())(
            jm[inner][1])
    _close(ti.grad, jg)


@pytest.mark.parametrize("arch", ["resnet18", "mobilenetv2"])
def test_graph_helpers_and_targets_match_jax(arch):
    g, _ = JZ.build(arch, num_classes=10, dataset="cifar10")
    gt, _ = TZ.build(arch, num_classes=10, dataset="cifar10")
    assert TQZ.reconstruction_targets(gt) == JQZ.reconstruction_targets(g)
    assert TQZ.reconstruction_targets(gt, block_level=False) == \
        JQZ.reconstruction_targets(g, block_level=False)
    for node in list(g)[:6] + list(g)[-4:]:
        if isinstance(node, JG.OpSpec):
            continue
        assert TG.node_unit_names(TG.find_node(gt, node.name)) == \
            JG.node_unit_names(node)
    names = [u.name for u in JG.iter_units(g)]
    for target in names[:3] + names[-3:] + [n.name for n in g][2:5]:
        for aq in (False, True):
            jf = JG.prefix_flags_till(g, target, act_quant=aq)
            tf = TG.prefix_flags_till(gt, target, act_quant=aq)
            assert (tf.weight_on, tf.act_on) == (jf.weight_on, jf.act_on)


def test_harmonize_residual_chains_matches_jax():
    """Two siteless residual blocks (no block act site, as MNASNet's) after
    the stem form one chain; calibrated by the JAX package, both packages
    give the same sites, ratios and new steps."""
    U, B = JG.UnitSpec, JG.BlockSpec

    def block(name):
        return B(name, units=(
            U(f"{name}.conv1", "conv", 8, 8, kernel=(3, 3), padding=(1, 1),
              activation="relu", has_bn=True),
            U(f"{name}.conv2", "conv", 8, 8, kernel=(1, 1), has_bn=True)),
            residual=True, block_act_quant=False)
    g = (U("model.conv1", "conv", 3, 8, kernel=(3, 3), padding=(1, 1),
           activation="relu", has_bn=True), block("model.b1"),
         block("model.b2"), JG.OpSpec("model.avgpool", "gap"),
         U("model.fc", "linear", 8, 4))
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=4, n_bits_a=4, w_scale_method="max",
                          a_scale_method="max", use_8bit_head_stem=False)
    params, qs = ssq.prepare_model(g, raw, cfg)
    x = np.random.default_rng(2).normal(size=(4, 8, 8, 3)).astype(np.float32)
    qs = ssq.calibrate_acts(g, params, qs, jnp.asarray(x), cfg)
    jqs, jr = JQZ.harmonize_residual_chains(g, qs)
    tqs, tr = TQZ.harmonize_residual_chains(
        _port_graph(g), JI.qstate_from_numpy(_np(qs), "cpu"))
    assert set(jr) == {"model.conv1", "model.b1.conv2", "model.b2.conv2"}
    assert tr.keys() == jr.keys()
    for k in jr:
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-6)
        np.testing.assert_array_equal(_a(tqs[k].aq.delta),
                                      np.asarray(jqs[k].aq.delta))
        np.testing.assert_array_equal(_a(tqs[k].aq.zero_point),
                                      np.asarray(jqs[k].aq.zero_point))


# ---------------------------------------------------------------------------
# recon/capture.py (tests/test_recon.py TestCapture, TestCaptureSession)
# ---------------------------------------------------------------------------

def _tcap(s, name, prefix=TG.Flags(), n=64, **kw):
    return TC.capture_io(s["gt"], s["tparams"], s["tqs"], name,
                         s["tcali"][:n], inp_flags=prefix,
                         out_flags=TG.Flags(), batch_size=32, device="cpu",
                         **kw)


@pytest.mark.parametrize("target", [BLOCK, INNER])
def test_capture_io_matches_jax(tiny, target):
    prefix = frozenset({"model.conv1"})
    ji, jo = JC.capture_io(tiny["g"], tiny["params"], tiny["qs"], target,
                           jnp.asarray(tiny["cali"]),
                           JG.Flags(weight_on=prefix), JG.Flags(),
                           batch_size=32)
    ti, to = _tcap(tiny, target, TG.Flags(weight_on=prefix))
    assert ti.shape == (64, 8, 8, 8) and to.shape == (64, 8, 8, 8)
    np.testing.assert_allclose(_a(ti), np.asarray(ji), atol=1e-5)
    np.testing.assert_allclose(_a(to), np.asarray(jo), atol=1e-5)
    # the asymmetric prefix is visible in the inputs, not in the targets
    fi, fo = _tcap(tiny, target)
    assert float((fi - ti).abs().max()) > 0
    np.testing.assert_array_equal(_a(fo), _a(to))
    bi, bo = _tcap(tiny, target, TG.Flags(weight_on=prefix),
                   cache_dtype=torch.bfloat16)
    assert bi.dtype == bo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_a(bi.float()), _a(ti.to(torch.bfloat16)
                                                     .float()))


@pytest.mark.parametrize("n", [50, 20])
def test_remainder_batch_not_dropped(tiny, n):
    """N % batch_size != 0 captures every row (50 = one full batch and a
    remainder; 20 < batch_size)."""
    full, _ = _tcap(tiny, BLOCK)
    cin, cout = _tcap(tiny, BLOCK, n=n)
    assert cin.shape[0] == n and cout.shape[0] == n
    np.testing.assert_allclose(_a(cin), _a(full[:n]), rtol=1e-6, atol=1e-7)
    sess = TC.CaptureSession(tiny["gt"], tiny["tparams"], tiny["tcali"][:n],
                             (BLOCK,), batch_size=32, device="cpu")
    si, so = sess.capture(tiny["tqs"], BLOCK, [])
    assert si.shape[0] == n
    np.testing.assert_allclose(_a(si), _a(cin), atol=1e-6)
    np.testing.assert_allclose(_a(so), _a(cout), atol=1e-6)


@pytest.mark.parametrize("limit", [4 << 30, 0])
def test_session_matches_capture_io_across_prefixes(tiny, limit):
    """Empty prefix, and a prefix holding a hardened shifted-scale
    quantizer; with the FP cache and (limit 0) without it."""
    targets = [BLOCK, "model.fc"]
    sess = TC.CaptureSession(tiny["gt"], tiny["tparams"], tiny["tcali"],
                             targets, batch_size=32,
                             fp_cache_limit_bytes=limit, device="cpu")
    ci, co = sess.capture(tiny["tqs"], BLOCK, frozenset())
    ri, ro = _tcap(tiny, BLOCK)
    np.testing.assert_allclose(_a(ci), _a(ri), atol=1e-6)
    np.testing.assert_allclose(_a(co), _a(ro), atol=1e-6)
    assert (sess._fp_outs is False) == (limit == 0)

    name = "model.conv1"
    qs2 = dict(tiny["tqs"])
    wq = TW.init_shifted_scale(qs2[name].wq.qp, tiny["tparams"][name]["w"],
                               (1 - 1 / 32, 1 + 1 / 32, 1.0))
    wq = dataclasses.replace(wq, hard_targets=True, hard_round=True)
    qs2[name] = dataclasses.replace(qs2[name], wq=wq)
    prefix = frozenset({name})
    ci2, co2 = sess.capture(qs2, "model.fc", prefix)
    ri2, ro2 = TC.capture_io(tiny["gt"], tiny["tparams"], qs2, "model.fc",
                             tiny["tcali"], TG.Flags(weight_on=prefix),
                             TG.Flags(), 32, device="cpu")
    np.testing.assert_allclose(_a(ci2), _a(ri2), atol=1e-5)
    np.testing.assert_allclose(_a(co2), _a(ro2), atol=1e-6)
    # against the JAX session with the same (JAX-made) hardened quantizer
    jqs = dict(tiny["qs"])
    jwq = JW.init_shifted_scale(jqs[name].wq.qp, tiny["params"][name]["w"],
                                (1 - 1 / 32, 1 + 1 / 32, 1.0))
    jwq = dataclasses.replace(jwq, hard_targets=True, hard_round=True)
    jqs[name] = dataclasses.replace(jqs[name], wq=jwq)
    jsess = JC.CaptureSession(tiny["g"], tiny["params"],
                              jnp.asarray(tiny["cali"]), targets,
                              batch_size=32)
    ji, jo = jsess.capture(jqs, "model.fc", prefix)
    tqs3 = dict(tiny["tqs"])
    tqs3[name] = JI.qstate_from_numpy({name: _np(jqs[name])}, "cpu")[name]
    ti, to = sess.capture(tqs3, "model.fc", prefix)
    np.testing.assert_allclose(_a(ti), np.asarray(ji), atol=1e-5)
    np.testing.assert_allclose(_a(to), np.asarray(jo), atol=1e-5)


def test_session_output_affine_folds_into_weights(tiny):
    """With output_affine, a prefix unit's gamma^z / phi^z fold into its
    materialized weight and bias: the same inputs as capture_io under
    Flags(output_affine=True)."""
    name = "model.conv1"
    qs = dict(tiny["tqs"])
    gen = torch.Generator().manual_seed(0)
    qs[name] = dataclasses.replace(
        qs[name], alpha_out=1 + 0.1 * torch.randn(8, generator=gen),
        beta_out=0.1 * torch.randn(8, generator=gen))
    sess = TC.CaptureSession(tiny["gt"], tiny["tparams"], tiny["tcali"],
                             [BLOCK], batch_size=32, output_affine=True,
                             device="cpu")
    si, _ = sess.capture(qs, BLOCK, {name})
    ri, _ = TC.capture_io(tiny["gt"], tiny["tparams"], qs, BLOCK,
                          tiny["tcali"],
                          TG.Flags(weight_on=frozenset({name}),
                                   output_affine=True), TG.Flags(), 32,
                          device="cpu")
    np.testing.assert_allclose(_a(si), _a(ri), atol=1e-5)
