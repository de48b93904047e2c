"""The integer depthwise kernel of the PyTorch port
(``ops/cuda/dw_conv.dw_conv_int8``, ``csrc/dw_conv_int8.cu``), its plain
version run on the CPU.

Before the kernel, the port served its ``bf16_codes`` and ``int8``
depthwise units with shifted int32 multiply-adds of the centered codes
(zero-padded) and a requant in PyTorch elementwise ops. These tests hold
the kernel's plain version, which the card's kernel is held to bit for bit
(``chip_smoke.py``, ``tests/test_torch_port_cuda.py``), to that route:

- unit by unit (``torch.equal``): K 3 and 5, strides 1 and 2, feeds with
  offset 0 and 128 (pad ``-offset``, ``offset * sum(w)`` added back),
  uniform (int32 sums) and baked (the f32 scale-table sum of two shift
  candidates), and every requant deploy fuses into it (none, relu, relu6
  onto an int8 site, relu onto a biased one);
- whole forwards: MobileNetV2's and MNASNet's CIFAR deploy logits through
  the deferred kernel route equal those of the old route, monkeypatched
  back in as in ``tests/test_torch_port_requant_epilogue.py``.
"""
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch.graph import UnitSpec, iter_units
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.ops.cuda import dw_conv as TDC

# sites (delta, zp, bits): 4-bit post-relu, 4-bit asymmetric, 8-bit
# unsigned (biased transport)
SITES = {"u4": (0.37, 0.0, 4), "a4": (0.29, 7.0, 4), "b8": (0.021, 0.0, 8)}
REQUANTS = [("u4", "relu"), ("u4", "relu6"), ("a4", None), ("b8", "relu")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _old_dw_acc(spec, w_int, xi, offset):
    """The route the depthwise units took before the kernel: shifted int32
    multiply-adds over the centered codes ``xi + offset``, zero-padded."""
    b, h, w, c = xi.shape
    (kh, kw), (sh, sw), (ph, pw) = spec.kernel, spec.stride, spec.padding
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    xp = xi.new_zeros((b, h + 2 * ph, w + 2 * pw, c), dtype=torch.int32)
    xp[:, ph:ph + h, pw:pw + w, :] = xi.to(torch.int32) + offset
    wt = w_int.to(torch.int32).reshape(c, kh * kw)
    acc = None
    for i in range(kh):
        for j in range(kw):
            t = xp[:, i:i + sh * (ho - 1) + 1:sh,
                   j:j + sw * (wo - 1) + 1:sw, :] * wt[:, i * kw + j]
            acc = t if acc is None else acc + t
    return acc


def _old_unit(spec, d, xi, offset, delta):
    """The old route's pending value of a depthwise unit."""
    if d.w_groups is None:
        acc = _old_dw_acc(spec, d.w_int, xi, offset)
        return TD._Pending(acc.to(torch.float32), d.scale * delta, d.bias)
    out = 0.0
    for s in range(d.w_groups.shape[0]):
        acc = _old_dw_acc(spec, d.w_groups[s], xi, offset)
        out = out + acc.to(torch.float32) * (d.group_scales[s] * delta)
    return TD._Pending(out, None, d.bias)


def _ctx():
    steps = {k: (torch.tensor(d), torch.tensor(z), b)
             for k, (d, z, b) in SITES.items()}
    return TD._Ctx(steps, frozenset({"u4", "a4"}), frozenset({"b8"}))


def _unit(rng, c, k, stride, s_n):
    """A depthwise unit's deploy params: W2 codes (S masked groups and
    their scale table when baked), per-channel scale and bias."""
    w_int = torch.as_tensor(rng.integers(-2, 2, (c, 1, k, k)),
                            dtype=torch.int8)
    scale = torch.as_tensor(rng.uniform(0.01, 0.05, c), dtype=torch.float32)
    bias = torch.as_tensor(rng.normal(size=c) * 0.3, dtype=torch.float32)
    w_groups = group_scales = None
    wm = w_int[None]
    if s_n > 1:
        sel = torch.as_tensor(rng.integers(0, s_n, (c, 1, 1, 1)))
        w_groups = torch.stack([torch.where(sel == s, w_int, 0)
                                for s in range(s_n)]).to(torch.int8)
        group_scales = torch.stack([scale * 0.5, scale])
        wm = w_groups
    w_mat = TD._gemm_operand(wm)
    spec = UnitSpec(name="dw", kind="conv", in_ch=c, out_ch=c,
                    kernel=(k, k), stride=(stride, stride),
                    padding=(k // 2, k // 2), groups=c, activation="relu")
    return spec, TD.DeployUnit(
        w_int=w_int, w_fp=None, scale=scale, bias=bias, w_groups=w_groups,
        group_scales=group_scales, w_mat=w_mat,
        w_sum=w_mat.sum(dim=2, dtype=torch.int32))


@pytest.mark.parametrize("s_n", [1, 2], ids=["uniform", "baked"])
@pytest.mark.parametrize("offset", [0, 128])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_plain_version_equals_old_route(k, stride, offset, s_n):
    """Sums (int32 uniform, the f32 scale-table sum baked) and each
    requant deploy fuses into the kernel (none, relu, relu6 onto an int8
    site, relu onto a biased site) equal the old route, torch.equal."""
    rng = np.random.default_rng(100 * k + 10 * stride + s_n + offset)
    c = 24
    spec, d = _unit(rng, c, k, stride, s_n)
    span = 128 if offset else 8
    xi = torch.as_tensor(rng.integers(-span, span, (2, 11, 9, c)),
                         dtype=torch.int8)
    delta = torch.tensor(0.053 if offset else 0.29)
    old = _old_unit(spec, d, xi, offset, delta)
    new = TD._int_unit(spec, d, xi, offset, delta)
    assert isinstance(new, TD._Deferred)
    sums = new.sums()
    assert sums.acc.dtype == old.acc.dtype == torch.float32
    assert torch.equal(sums.acc, old.acc)
    raw = new.launch(None)
    assert raw.dtype == torch.float32
    if s_n == 1:
        # int32 before the route's f32 cast
        got = TDC.dw_conv_int8(xi, d.w_mat, spec.kernel, spec.stride,
                               spec.padding, pad_value=-offset,
                               acc_offset=offset * d.w_sum if offset else None)
        assert got.dtype == torch.int32
        assert torch.equal(got, _old_dw_acc(spec, d.w_int, xi, offset))
    ctx = _ctx()
    for site, act in REQUANTS:
        before = TD.quantize_out.unfused
        fused = TD.quantize_out(ctx, TD._int_unit(spec, d, xi, offset, delta),
                                site, act)
        assert TD.quantize_out.unfused == before
        want = TD.quantize_out(ctx, old, site, act)
        assert TD.quantize_out.unfused == before + 1
        assert fused[0] == want[0] and fused[2] == want[2] == site
        assert fused[1].dtype == torch.int8
        assert torch.equal(fused[1], want[1]), (site, act)


def test_plain_version_three_groups_and_offsets():
    """Three weight groups (the kernel pads them to four) and a feed whose
    offset is neither 0 nor 128 (an asymmetric 8-bit site): the
    scale-table sum equals the old route's."""
    rng = np.random.default_rng(3)
    spec, d = _unit(rng, 16, 5, 1, 1)
    sel = torch.as_tensor(rng.integers(0, 3, (16, 1, 1, 1)))
    groups = torch.stack([torch.where(sel == s, d.w_int, 0)
                          for s in range(3)]).to(torch.int8)
    w_mat = TD._gemm_operand(groups)
    d3 = TD.DeployUnit(w_int=d.w_int, w_fp=None, scale=d.scale, bias=d.bias,
                       w_groups=groups,
                       group_scales=torch.stack([d.scale * f
                                                 for f in (0.5, 1.0, 2.0)]),
                       w_mat=w_mat, w_sum=w_mat.sum(dim=2, dtype=torch.int32))
    xi = torch.as_tensor(rng.integers(-128, 128, (2, 7, 7, 16)),
                         dtype=torch.int8)
    delta = torch.tensor(0.021)
    for offset in (0, 3, 128):
        want = _old_unit(spec, d3, xi, offset, delta).acc
        got = TD._int_unit(spec, d3, xi, offset, delta).sums().acc
        assert torch.equal(got, want), offset


def _old_route(monkeypatch):
    """Deploy with the old depthwise route: depthwise integer units return
    the pending shifted-sum value, and every requant runs elementwise."""
    new_int_unit = TD._int_unit

    def old_int_unit(spec, d, xi, offset, delta, block_diagonal=False):
        if spec.kind == "conv" and spec.groups == spec.in_ch == spec.out_ch \
                and spec.groups > 1:
            return _old_unit(spec, d, xi, offset, delta)
        return new_int_unit(spec, d, xi, offset, delta, block_diagonal)

    monkeypatch.setattr(TD, "_int_unit", old_int_unit)
    monkeypatch.setattr(TD._Ctx, "clip", lambda self, *a: None)


@pytest.mark.parametrize("env", [{}, {"SSQ_DW_KERNEL": "1",
                                      "SSQ_PACKED": "1"}],
                         ids=["default", "serving"])
@pytest.mark.parametrize("arch", ["mobilenetv2", "mnasnet"])
def test_deploy_logits_equal_old_route(arch, env, monkeypatch):
    """MobileNetV2 and MNASNet W2A4, CIFAR variant at 16x16: the deploy
    logits through the kernel route (the depthwise units' requant in the
    kernel's epilogue) equal the old route's, torch.equal; under the
    serving switches MobileNetV2's biased-fed features.1.conv.0 is the one
    depthwise unit on the new kernel and its requant fuses (one requant
    left, the float stem's)."""
    for k in ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
              "SSQ_DW_KERNEL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    graph, _ = TZ.build(arch, dataset="cifar10")
    cfg = tp.QuantConfig(n_bits_w=2, n_bits_a=4)
    params, qs = tp.prepare_model(graph, TZ.init_params(graph, device="cpu"),
                                  cfg, device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 3))
    x = torch.as_tensor((np.round(x * 8) / 8).astype(np.float32))
    qs = tp.calibrate_acts(graph, params, qs, x, cfg, device="cpu")
    dp = TD.build_deploy_params(graph, params, qs, device="cpu")
    steps = TD.act_steps_from_qstate(graph, qs)
    plan = TD.make_deploy_plan(graph, dp, steps, input_hw=(16, 16))
    dw_units = [u.name for u in iter_units(graph)
                if u.groups == u.in_ch > 1
                and plan[u.name][0] in ("bf16_codes", "int8")]
    assert dw_units
    TD.quantize_out.unfused = 0
    new = TD.deploy_forward(graph, dp, steps, x, plan=plan, device="cpu")
    unfused = TD.quantize_out.unfused
    if arch == "mobilenetv2" and env:
        assert dw_units == ["model.features.1.conv.0"]
        assert unfused == 1
    with monkeypatch.context() as m:
        _old_route(m)
        old = TD.deploy_forward(graph, dp, steps, x, plan=plan, device="cpu")
    assert torch.equal(new, old)


def test_plain_version_takes_any_geometry():
    """On the CPU the wrapper's plain version takes any geometry (here
    7x7, pad 3), as the old route did; the kernel's refusals need a card
    (tests/test_torch_port_cuda.py)."""
    rng = np.random.default_rng(9)
    spec = NS(kernel=(7, 7), stride=(1, 1), padding=(3, 3))
    xi = torch.as_tensor(rng.integers(-8, 8, (1, 9, 9, 8)), dtype=torch.int8)
    w = torch.as_tensor(rng.integers(-2, 2, (8, 1, 7, 7)), dtype=torch.int8)
    got = TDC.dw_conv_int8(xi, TD._gemm_operand(w[None]), spec.kernel,
                           spec.stride, spec.padding)
    assert torch.equal(got, _old_dw_acc(spec, w, xi, 0))
