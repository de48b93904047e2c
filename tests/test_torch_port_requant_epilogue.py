"""The requant epilogue of the PyTorch port's integer GEMM kernels
(``int8_conv``, ``packed_quant_matmul``), run on the CPU.

A unit whose output goes to an int8 or biased site under none, relu or
relu6 hands deploy's ``quantize_out`` a deferred launch, and the kernel
writes that site's int8 codes from its epilogue; the last unit of a block
also takes the block's requant with the residual. On the CPU the wrappers
run their plain versions, so these tests hold the arithmetic the card
kernels are held to (``chip_smoke.py`` compares them there):

- each plain version's requant modes equal its sums mode followed by the
  port's ``quantize_out`` elementwise route, bit for bit (``torch.equal``):
  int8_conv at S = 1 and 2, offset 0 and 128; packed with codes and f32
  in, W2 and W4, stride 1 and 2; every requant variant (relu, relu6,
  none; int8 and biased sites; the block requant with a residual as
  codes, biased codes, f32 or none; a unit site before the block's);
- the whole deploy forward through the new route equals the old
  elementwise route bit for bit, and the JAX package's deploy forward
  within rel-MSE 1e-8 with the same top-1 (exact integer codes on 1/8-grid
  images; only the float head rounds differently);
- ``deploy.quantize_out.unfused``, the requants left to PyTorch
  elementwise ops, is the count each path should leave.
"""
from types import SimpleNamespace as NS

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu import deploy as JD
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.models import zoo as JZ
from shiftedscalequantization_tpu.quantize import unit_order
from shiftedscalequantization_tpu.recon import engine as JE
from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch import quantize as TQ
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul as TI
from shiftedscalequantization_tpu_torch.ops.cuda import packed as TP
from shiftedscalequantization_tpu_torch.ops.cuda import requant as TR
from shiftedscalequantization_tpu_torch.recon import engine as TE
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

SWITCHES = ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
            "SSQ_DW_KERNEL")
R18_SERVING = {"SSQ_STEM_KERNEL": "1", "SSQ_PACKED": "1",
               "SSQ_STEM_1PASS": "0"}
MNV2_SERVING = {"SSQ_DW_KERNEL": "1", "SSQ_PACKED": "1",
                "SSQ_STEM_1PASS": "1"}
# sites (delta, zp, bits): 4-bit post-relu, 4-bit asymmetric, 8-bit
# unsigned (biased transport), two block sites
SITES = {"u4": (0.37, -0.0, 4), "a4": (0.29, 7.0, 4), "b8": (0.021, 0.0, 8),
         "blk": (0.41, 0.0, 4), "blka": (0.33, 8.0, 4)}
# (id, unit site, unit act, block site, block act, residual kind)
VARIANTS = [
    ("site-relu", "u4", "relu", None, None, None),
    ("site-relu6", "u4", "relu6", None, None, None),
    ("site-none", "a4", None, None, None, None),
    ("biased-relu", "b8", "relu", None, None, None),
    ("block-codes-res", None, None, "blk", "relu", "codes"),
    ("block-f32-res", None, None, "blk", "relu", "f32"),
    ("block-biased-res", None, None, "blka", None, "biased"),
    ("block-no-res", None, None, "blka", None, None),
    ("unit-site-then-block", "a4", None, "blk", "relu6", "codes"),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _ctx():
    steps = {k: (torch.tensor(d), torch.tensor(z), b)
             for k, (d, z, b) in SITES.items()}
    return TD._Ctx(steps, frozenset({"u4", "a4", "blk", "blka"}),
                   frozenset({"b8"}))


def _residuals(rng, shape):
    return {"codes": ("codes", torch.as_tensor(
                rng.integers(-7, 9, shape), dtype=torch.int8), "a4"),
            "biased": ("biased", torch.as_tensor(
                rng.integers(-128, 128, shape), dtype=torch.int8), "b8"),
            "f32": ("f32", torch.as_tensor(
                rng.normal(size=shape) * 1.5, dtype=torch.float32), None)}


def _fused_and_unfused(variant, launch, pending, res):
    """(fused, unfused, the Requant deploy built): the deferred launch
    through deploy's route, and the sums-mode value ``pending`` through
    quantize_out's elementwise route."""
    _, usite, uact, bsite, bact, rkind = variant
    ctx = _ctx()
    seen = []

    def run(rq):
        seen.append(rq)
        return launch(rq)

    deferred = TD._Deferred(run, pending.scale, pending.bias) \
        if isinstance(pending, TD._Pending) \
        else TD._Deferred(run, pending=False)
    before = TD.quantize_out.unfused
    if bsite is None:
        fused = TD.quantize_out(ctx, deferred, usite, uact)
        assert TD.quantize_out.unfused == before
        unfused = TD.quantize_out(ctx, pending, usite, uact)
    else:
        unit = NS(name=usite or "no site", activation=uact)
        node = NS(name=bsite, post_activation=bact)
        r = res[rkind] if rkind else None
        fused = TD._block_requant(ctx, deferred, unit, node, r)
        assert TD.quantize_out.unfused == before
        t = TD.quantize_out(ctx, pending, unit.name, uact)
        unfused = TD.quantize_out(ctx, t, bsite, bact, residual=r)
    assert len(seen) == 1
    return fused, unfused, seen[0]


def _assert_same_codes(fused, unfused):
    assert fused[0] == unfused[0] and fused[2] == unfused[2]
    assert fused[1].dtype == torch.int8
    assert torch.equal(fused[1], unfused[1])
    # a check that cannot fail would pass on saturated codes alone
    assert torch.unique(fused[1]).numel() >= 3


def _scales(rng, n, spread):
    """Per-column scales that spread the value over a few codes of the
    sites' grids, and biases of a step or two."""
    sc = rng.uniform(0.75, 1.25, n) * 3 * 0.37 / spread
    return (torch.as_tensor(sc, dtype=torch.float32),
            torch.as_tensor(rng.normal(size=n) * 0.6, dtype=torch.float32))


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
@pytest.mark.parametrize("s_n,offset", [(1, 0), (1, 128), (2, 0), (2, 128)],
                         ids=["S1", "S1-offset", "S2", "S2-offset"])
def test_int8_conv_requant_equals_sums_then_quantize_out(s_n, offset,
                                                         variant):
    """int8_conv's requant mode (plain version) equals its sums mode
    followed by quantize_out, and equals requant_plain on its sums."""
    rng = np.random.default_rng(s_n * 1000 + offset)
    b, h, c, n, k = 2, 7, 16, 24, 3
    kk = k * k * c
    lo, hi = (-128, 128) if offset else (-8, 8)
    x = torch.as_tensor(rng.integers(lo, hi, (b, h, h, c)), dtype=torch.int8)
    # symmetric weights: the biased feed's centered codes are all >= 0
    w = torch.as_tensor(rng.integers(-2, 3, (s_n, n, kk)), dtype=torch.int8)
    geom = ((k, k), (2, 2), (1, 1))
    scale, bias = _scales(rng, n, (209.0 if offset else 6.6) * np.sqrt(kk))
    delta = torch.tensor(0.37)
    table = None if s_n == 1 else torch.stack([scale * 0.5, scale]) / delta
    kw = dict(pad_value=-offset, group_scales=table, act_delta=delta,
              acc_offset=(offset * w.sum(dim=2, dtype=torch.int32)
                          if offset else None))
    sums = TI.int8_conv(x, w, *geom, **kw)
    assert sums.dtype == (torch.int32 if s_n == 1 else torch.float32)
    pending = TD._Pending(sums.float(), scale, bias) if s_n == 1 \
        else TD._Pending(sums, None, bias)
    res = _residuals(rng, tuple(sums.shape))
    before = TI.int8_conv.launches
    fused, unfused, rq = _fused_and_unfused(
        variant, lambda rq: TI.int8_conv(x, w, *geom, requant=rq, **kw),
        pending, res)
    assert TI.int8_conv.launches == before       # the CPU runs plain
    _assert_same_codes(fused, unfused)
    assert torch.equal(fused[1], TR.requant_plain(sums.float(), rq))


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
@pytest.mark.parametrize("feed,bits,stride", [
    ("codes", 2, 1), ("codes", 2, 2), ("codes", 4, 1), ("f32", 2, 2),
    ("f32", 4, 1)])
def test_packed_requant_equals_sums_then_quantize_out(feed, bits, stride,
                                                      variant):
    """packed_quant_matmul's requant mode (plain version) equals its sums
    mode followed by quantize_out, with int8 codes or f32 fed in and a
    strided NHWC feed read as a 1x1 conv."""
    rng = np.random.default_rng(bits * 10 + stride)
    b, h, k, n = 2, 9, 40, 24
    if feed == "codes":
        x = torch.as_tensor(rng.integers(-7, 9, (b, h, h, k)),
                            dtype=torch.int8)
    else:
        x = torch.as_tensor(rng.normal(size=(b, h, h, k)) * 0.4,
                            dtype=torch.float32)
    raw = torch.as_tensor(rng.integers(0, 2 ** bits, (k, n)),
                          dtype=torch.int32)
    w_zp = torch.as_tensor(rng.integers(0, 2 ** bits, n), dtype=torch.float32)
    scale, bias = _scales(rng, n, 0.05 * 4.0 * bits * np.sqrt(k))
    args = (x, TP.pack_codes(raw, bits), w_zp, scale, bias,
            torch.tensor(0.05), torch.tensor(7.0), bits, 4)
    sums = TP.packed_quant_matmul(*args, stride=stride)
    ho = (h - 1) // stride + 1
    assert sums.dtype == torch.float32 and sums.shape == (b, ho, ho, n)
    # the strided feed is the strided rows of the (M, K) form
    rows = x[:, ::stride, ::stride, :].reshape(-1, k).contiguous()
    assert torch.equal(sums.reshape(-1, n),
                       TP.packed_quant_matmul(rows, *args[1:]))
    res = _residuals(rng, tuple(sums.shape))
    fused, unfused, rq = _fused_and_unfused(
        variant, lambda rq: TP.packed_quant_matmul(*args, stride=stride,
                                                   requant=rq),
        sums, res)
    _assert_same_codes(fused, unfused)
    assert torch.equal(fused[1], TR.requant_plain(sums, rq))


def test_requant_refuses_what_it_cannot_write():
    """A Requant ends in a quantizing stage; a residual needs its step."""
    one = torch.ones(3)
    with pytest.raises(ValueError, match="quantizing stage"):
        TR.Requant(m1=one, c1=one)
    with pytest.raises(ValueError, match="m2 and c2"):
        TR.Requant(q2=(0.0, 15.0, 0.0), m2=one)
    with pytest.raises(ValueError, match="r and mr"):
        TR.Requant(m2=one, c2=one, q2=(0.0, 15.0, 0.0),
                   r=torch.zeros(3, dtype=torch.int8))


# ---------------------------------------------------------------------------
# whole deploy forwards
# ---------------------------------------------------------------------------

def _set_env(monkeypatch, env):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _images(n, hw, seed=1):
    x = np.random.default_rng(seed).normal(size=(n, hw, hw, 3))
    return (np.round(x * 8) / 8).astype(np.float32)


def _rel_mse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(((got - want) ** 2).mean() / (want ** 2).mean())


def _port_state(arch, dataset, hw, shifted):
    """Port-made state (no JAX): seeded weights, W2A4, MSE scales,
    calibration on 4 grid images, and with ``shifted`` the method's fused
    quantizers hardened to the baked form."""
    g, _ = TZ.build(arch, num_classes=10, dataset=dataset)
    raw = TZ.init_params(g, seed=0, device="cpu")
    cfg = TQ.QuantConfig(n_bits_w=2, n_bits_a=4)
    params, qs = TQ.prepare_model(g, raw, cfg, device="cpu")
    x = torch.as_tensor(_images(4, hw))
    qs = TQ.calibrate_acts(g, params, qs, x, cfg, device="cpu")
    if shifted:
        names = TQ.unit_order(g)
        qs, _ = TE._init_quantizers(params, qs, names, TE.ReconSettings(
            mode="fused", shift_targets=(0.5, 1.0)))
        qs = TE._harden(qs, names, "fused")
    return (g, TD.build_deploy_params(g, params, qs, device="cpu"),
            TD.act_steps_from_qstate(g, qs), x)


# (path, arch, dataset, input size, method state, switches, requants left
# to PyTorch elementwise). ImageNet ResNet-18 at 64x64 keeps the fused
# stem; the CIFAR variant's 3x3 float stem requantizes elementwise, as
# MobileNetV2's float_1p stem (the bf16_codes depthwise unit after it
# requantizes in dw_conv_int8's epilogue) and MNASNet's, whose ten float
# units fed by a pair or an f32 sum requantize elementwise too
PATHS = [
    ("resnet18-uniform", "resnet18", "imagenet", 64, False, R18_SERVING, 0),
    ("resnet18-method", "resnet18", "imagenet", 64, True, R18_SERVING, 0),
    ("resnet18-cifar", "resnet18", "cifar10", 32, True, R18_SERVING, 1),
    ("mobilenetv2", "mobilenetv2", "imagenet", 64, False, MNV2_SERVING, 1),
    ("mnasnet", "mnasnet", "imagenet", 64, False, MNV2_SERVING, 11),
]


@pytest.mark.parametrize("path", PATHS, ids=[p[0] for p in PATHS])
def test_unfused_count_and_old_route(path, monkeypatch):
    """The serving route leaves the expected requants to PyTorch
    elementwise and gives the old all-elementwise route's logits bit for
    bit (the old route: no site fuses, every requant elementwise)."""
    _, arch, dataset, hw, shifted, env, want = path
    _set_env(monkeypatch, env)
    g, dp, st, x = _port_state(arch, dataset, hw, shifted)
    plan = TD.make_deploy_plan(g, dp, st, input_hw=(hw, hw))
    TD.quantize_out.unfused = 0
    new = TD.deploy_forward(g, dp, st, x, plan=plan, device="cpu")
    assert TD.quantize_out.unfused == want
    monkeypatch.setattr(TD._Ctx, "clip", lambda self, site, act, inv: None)
    TD.quantize_out.unfused = 0
    old = TD.deploy_forward(g, dp, st, x, plan=plan, device="cpu")
    assert TD.quantize_out.unfused > want
    assert torch.equal(new, old)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(arch, hw, shifted, width=1.0):
    """JAX-made state carried to the port: W2A4, max scales, 1/8-grid
    calibration images; with ``shifted`` the fused quantizers with seeded
    noise on their logits (so both candidates own channels), hardened."""
    g, _ = JZ.build(arch, num_classes=10, dataset="cifar10")
    if width != 1.0:
        from shiftedscalequantization_tpu.models import mobilenetv2 as JM
        g = JM.build_mobilenetv2(num_classes=10, width_mult=width,
                                 variant="cifar")
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          a_scale_method="max")
    params, qs = ssq.prepare_model(g, raw, cfg)
    x = _images(4, hw)
    qs = ssq.calibrate_acts(g, params, qs, jnp.asarray(x), cfg)
    if shifted:
        names = unit_order(g)
        qs, theta = JE._init_quantizers(params, qs, names, JE.ReconSettings(
            mode="fused", shift_targets=(0.5, 1.0)))
        rng = np.random.default_rng(10)
        theta = {u: {k: v + rng.normal(size=v.shape).astype(np.float32)
                     for k, v in t.items()} for u, t in theta.items()}
        qs = JE._harden(JE._insert_theta(qs, theta), names, "fused")
    from shiftedscalequantization_tpu_torch.models import mobilenetv2 as TM
    gt = TZ.build(arch, num_classes=10, dataset="cifar10")[0] \
        if width == 1.0 else TM.build_mobilenetv2(
            num_classes=10, width_mult=width, variant="cifar")
    tparams = JI.params_from_numpy(_np(params), "cpu")
    tqs = JI.qstate_from_numpy(_np(qs), "cpu")
    return (g, JD.build_deploy_params(g, params, qs),
            JD.act_steps_from_qstate(g, qs), gt,
            TD.build_deploy_params(gt, tparams, tqs, device="cpu"),
            TD.act_steps_from_qstate(gt, tqs), x)


@pytest.mark.parametrize("case", [
    ("resnet18-method", "resnet18", True, 1.0, R18_SERVING, 1),
    ("mobilenetv2-narrow", "mobilenetv2", False, 0.5, MNV2_SERVING, 1)],
    ids=lambda c: c[0])
def test_deploy_forward_matches_jax(case, monkeypatch):
    """The port's deploy forward through the requant epilogues against the
    JAX package's deploy forward on the same state: rel-MSE <= 1e-8 (the
    codes are exact integer arithmetic on 1/8-grid images; only the float
    head's sums round in another order) and the same top-1."""
    _, arch, shifted, width, env, unfused = case
    _set_env(monkeypatch, env)
    g, jd, jsteps, gt, td, tsteps, x = _jax_state(arch, 32, shifted, width)
    pj = JD.make_deploy_plan(g, jd, jsteps, input_hw=(32, 32))
    pt = TD.make_deploy_plan(gt, td, tsteps, input_hw=(32, 32))
    want = np.asarray(JD.deploy_forward(g, jd, jsteps, jnp.asarray(x),
                                        plan=pj))
    TD.quantize_out.unfused = 0
    got = TD.deploy_forward(gt, td, tsteps, torch.as_tensor(x), plan=pt,
                            device="cpu").numpy()
    assert TD.quantize_out.unfused == unfused
    assert _rel_mse(got, want) <= 1e-8
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_switches_are_unchanged():
    """The route adds no switch: deploy reads only the JAX package's four
    plan switches and its pair-term cap, SSQ_PAIR_TERMS (each one a switch
    of the JAX deploy module)."""
    import inspect
    import re

    def read(module):
        return set(re.findall(r'os\.environ\.get\(\s*"(SSQ_\w+)"',
                              inspect.getsource(module)))

    assert read(TD) == set(SWITCHES) | {"SSQ_PAIR_TERMS"}
    assert read(TD) < read(JD)
