"""Card-only tests of the PyTorch port: each CUDA kernel against its plain
version on the card, and one integer deploy forward through both kernels.

Marked ``cuda``; they skip where no card is present. On a machine with one:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("bits,m,k,n,relu", [
    (2, 200704 // 64, 64, 128, False), (2, 1000, 130, 72, True),
    (4, 517, 256, 512, False)])
def test_packed_kernel_matches_plain(card, bits, m, k, n, relu):
    """int32 accumulation is exact and the epilogue is rounded step by step
    on both sides: atol 1e-4, rtol 1e-5."""
    from shiftedscalequantization_tpu_torch.ops.cuda import packed as TP
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((m, k), generator=g, device=card)
    raw = torch.randint(0, 2 ** bits, (k, n), generator=g, device=card,
                        dtype=torch.int32)
    wp = TP.pack_codes(raw, bits)
    w_zp = torch.randint(0, 2 ** bits, (n,), generator=g,
                         device=card).float()
    scale = torch.rand((n,), generator=g, device=card) * 0.1
    bias = torch.randn((n,), generator=g, device=card)
    args = (x, wp, w_zp, scale, bias, torch.tensor(0.05, device=card),
            torch.tensor(7.0, device=card), bits, 4, relu)
    before = TP.packed_quant_matmul.launches
    got = TP.packed_quant_matmul(*args)
    torch.cuda.synchronize()
    assert TP.packed_quant_matmul.launches == before + 1
    torch.testing.assert_close(got, TP.packed_quant_matmul_plain(*args),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,h,oc,biased", [(4, 224, 64, True),
                                           (3, 64, 16, False),
                                           (2, 40, 32, True)])
def test_stem_kernel_matches_plain(card, b, h, oc, biased):
    """f32 FMA order differs from cuDNN's: codes may differ by one step at
    rounding boundaries, on at most 2e-3 of outputs."""
    from shiftedscalequantization_tpu_torch.ops.cuda import stem as TS
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((b, h, h, 3), generator=g, device=card)
    w = torch.randint(-120, 121, (oc, 3, 7, 7), generator=g,
                      device=card).float()
    scale = torch.rand((oc,), generator=g, device=card) * 0.003 + 0.001
    bias = torch.randn((oc,), generator=g, device=card) * 0.1
    q = (0.02, 0.0, 255.0, 128.0) if biased else (0.1, 0.0, 15.0, 0.0)
    before = TS.stem_fused.launches
    got = TS.stem_fused(x, w, scale, bias, *q)
    torch.cuda.synchronize()
    assert TS.stem_fused.launches == before + 1
    want = TS.stem_fused_plain(x, w, scale, bias, *q)
    diff = (got.int() - want.int()).abs()
    assert got.shape == want.shape == (b, h // 4, h // 4, oc)
    assert int(diff.max()) <= 1
    assert float((diff != 0).float().mean()) < 2e-3


def test_deploy_forward_on_card_runs_both_kernels(card, monkeypatch):
    """ResNet-18 ImageNet W2A4 at 64x64: one stem and three packed launches
    per forward, deploy == sim as bench.py gates it (rel-MSE <= 1e-2), and
    the card agrees with the CPU plain path on the same state."""
    import shiftedscalequantization_tpu_torch as tp
    from shiftedscalequantization_tpu_torch import deploy as TD
    from shiftedscalequantization_tpu_torch.models import zoo as TZ
    from shiftedscalequantization_tpu_torch.ops.cuda import packed as TP
    from shiftedscalequantization_tpu_torch.ops.cuda import stem as TS
    monkeypatch.setenv("SSQ_STEM_KERNEL", "1")
    monkeypatch.setenv("SSQ_PACKED", "1")
    monkeypatch.setenv("SSQ_STEM_1PASS", "0")
    graph, _ = TZ.build("resnet18", num_classes=10)
    cfg = tp.QuantConfig(n_bits_w=2, n_bits_a=4)
    params, qs = tp.prepare_model(graph, TZ.init_params(graph, device=card),
                                  cfg, device=card)
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(32, 64, 64, 3)).astype(np.float32), device=card)
    qs = tp.calibrate_acts(graph, params, qs, x, cfg, device=card)
    dp = TD.build_deploy_params(graph, params, qs, device=card)
    steps = TD.act_steps_from_qstate(graph, qs)
    plan = TD.make_deploy_plan(graph, dp, steps, input_hw=(64, 64))
    TS.stem_fused.launches = 0
    TP.packed_quant_matmul.launches = 0
    dep = TD.deploy_forward(graph, dp, steps, x, plan=plan, device=card)
    torch.cuda.synchronize()
    assert (TS.stem_fused.launches, TP.packed_quant_matmul.launches) == (1, 3)
    sim = tp.forward(graph, params, qs, x,
                     tp.quantize.act_flags(
                         graph, cfg, base=tp.Flags().all_weights(graph)),
                     device=card)
    rel = float(((sim - dep) ** 2).mean() / (sim ** 2).mean())
    assert torch.isfinite(dep).all() and rel <= 1e-2, rel
    cpu = lambda d: {k: (v.cpu() if torch.is_tensor(v) else v)  # noqa
                     for k, v in d.__dict__.items()}
    dp_cpu = {k: TD.DeployUnit(**cpu(v)) for k, v in dp.items()}
    steps_cpu = {k: (d.cpu(), z.cpu(), n) for k, (d, z, n) in steps.items()}
    dep_cpu = TD.deploy_forward(graph, dp_cpu, steps_cpu, x.cpu(), plan=plan,
                                device="cpu")
    rel_cpu = float(((dep.cpu() - dep_cpu) ** 2).mean()
                    / (dep_cpu ** 2).mean())
    assert rel_cpu <= 1e-2, rel_cpu


@pytest.mark.parametrize("b,h,c,stride,act", [
    (8, 112, 96, 2, "relu6"), (16, 28, 192, 1, "relu6"),
    (4, 15, 28, 2, "relu"), (3, 9, 12, 1, "none")])
def test_dw_kernel_matches_plain(card, b, h, c, stride, act):
    """int32 accumulation and a step-by-step rounded epilogue on both
    sides: bit-exact, odd H and W included. The kernel refuses C not a
    multiple of 4 rather than take the plain version."""
    from shiftedscalequantization_tpu_torch.ops.cuda import depthwise as TDW
    g = torch.Generator(device=card).manual_seed(2)
    x = torch.randint(-8, 8, (b, h, h, c), generator=g, device=card,
                      dtype=torch.int8)
    w = torch.randint(-2, 2, (c, 3, 3), generator=g, device=card,
                      dtype=torch.int8)
    scalef = torch.rand((c,), generator=g, device=card) * 0.05 + 0.001
    biasf = torch.randn((c,), generator=g, device=card) * 0.5
    args = (x, w, scalef, biasf, torch.tensor(0.07, device=card),
            torch.tensor(7.0, device=card), 15.0)
    before = TDW.dw_conv3x3_int8.launches
    got = TDW.dw_conv3x3_int8(*args, stride=stride, act=act)
    torch.cuda.synchronize()
    assert TDW.dw_conv3x3_int8.launches == before + 1
    want = TDW.dw_conv3x3_int8_plain(*args, stride=stride, act=act)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="multiple of 4"):
        TDW.dw_conv3x3_int8(x[..., :c - 1].contiguous(), w[:c - 1],
                            scalef[:c - 1].contiguous(),
                            biasf[:c - 1].contiguous(), *args[4:])
    assert TDW.dw_conv3x3_int8.launches == before + 1


@pytest.mark.parametrize("b,h,ci,ce,co,expand,residual", [
    (4, 56, 24, 144, 24, True, True), (8, 7, 160, 960, 160, True, True),
    (2, 112, 32, 32, 16, False, False), (3, 13, 8, 48, 12, True, False)])
def test_mbconv_kernel_matches_plain(card, b, h, ci, ce, co, expand,
                                     residual):
    """Integer sums exact on both sides, epilogues rounded step by step:
    bit-exact at MobileNetV2 block shapes and a ragged one."""
    from shiftedscalequantization_tpu_torch.ops.cuda import mbconv as TMB
    g = torch.Generator(device=card).manual_seed(3)

    def codes(*shape):
        return torch.randint(-2, 2, shape, generator=g, device=card,
                             dtype=torch.int8)

    def rows(n, lo, hi):
        return torch.stack([torch.rand((n,), generator=g, device=card)
                            * (hi - lo) + lo,
                            torch.randn((n,), generator=g, device=card)
                            + 0.5]).contiguous()

    x = torch.randint(-8, 8, (b, h, h, ci), generator=g, device=card,
                      dtype=torch.int8)
    args = (x, codes(ci, ce), rows(ce, 0.05, 0.3), codes(9, ce),
            rows(ce, 0.05, 0.3), codes(ce, co), rows(co, 0.01, 0.1),
            torch.tensor([15.0, 15.0, 0.7, -8.0, 7.0, 0.0], device=card))
    before = TMB.mbconv_fused.launches
    got = TMB.mbconv_fused(*args, has_expand=expand, has_residual=residual)
    torch.cuda.synchronize()
    assert TMB.mbconv_fused.launches == before + 1
    want = TMB.mbconv_fused_plain(*args, has_expand=expand,
                                  has_residual=residual)
    assert torch.equal(got, want)


def test_mobilenetv2_deploy_on_card_runs_dw_kernel(card, monkeypatch):
    """MobileNetV2 W2A4 (CIFAR variant, 32x32, batch 32) under
    SSQ_DW_KERNEL=1 SSQ_PACKED=1: 16 dw and 34 packed launches per
    forward, deploy == sim as bench.py gates it (rel-MSE <= 1e-2), and on
    1/8-grid images the card equals the CPU plain path on the same state
    (rel-MSE <= 1e-8, same top-1)."""
    import shiftedscalequantization_tpu_torch as tp
    from shiftedscalequantization_tpu_torch import deploy as TD
    from shiftedscalequantization_tpu_torch.models import zoo as TZ
    from shiftedscalequantization_tpu_torch.ops.cuda import depthwise as TDW
    from shiftedscalequantization_tpu_torch.ops.cuda import packed as TP
    monkeypatch.setenv("SSQ_DW_KERNEL", "1")
    monkeypatch.setenv("SSQ_PACKED", "1")
    graph, _ = TZ.build("mobilenetv2", dataset="cifar10")
    cfg = tp.QuantConfig(n_bits_w=2, n_bits_a=4)
    params, qs = tp.prepare_model(graph, TZ.init_params(graph, device=card),
                                  cfg, device=card)
    x = np.random.default_rng(0).normal(size=(32, 32, 32, 3))
    x = torch.as_tensor((np.round(x * 8) / 8).astype(np.float32),
                        device=card)
    qs = tp.calibrate_acts(graph, params, qs, x, cfg, device=card)
    dp = TD.build_deploy_params(graph, params, qs, device=card)
    steps = TD.act_steps_from_qstate(graph, qs)
    plan = TD.make_deploy_plan(graph, dp, steps, input_hw=(32, 32))
    TDW.dw_conv3x3_int8.launches = 0
    TP.packed_quant_matmul.launches = 0
    dep = TD.deploy_forward(graph, dp, steps, x, plan=plan, device=card)
    torch.cuda.synchronize()
    assert (TDW.dw_conv3x3_int8.launches,
            TP.packed_quant_matmul.launches) == (16, 34)
    sim = tp.forward(graph, params, qs, x,
                     tp.quantize.act_flags(
                         graph, cfg, base=tp.Flags().all_weights(graph)),
                     device=card)
    rel = float(((sim - dep) ** 2).mean() / (sim ** 2).mean())
    assert torch.isfinite(dep).all() and rel <= 1e-2, rel
    cpu = lambda d: {k: (v.cpu() if torch.is_tensor(v) else v)  # noqa
                     for k, v in d.__dict__.items()}
    dp_cpu = {k: TD.DeployUnit(**cpu(v)) for k, v in dp.items()}
    steps_cpu = {k: (d.cpu(), z.cpu(), n) for k, (d, z, n) in steps.items()}
    dep_cpu = TD.deploy_forward(graph, dp_cpu, steps_cpu, x.cpu(), plan=plan,
                                device="cpu")
    rel_cpu = float(((dep.cpu() - dep_cpu) ** 2).mean()
                    / (dep_cpu ** 2).mean())
    assert rel_cpu <= 1e-8, rel_cpu
    assert torch.equal(dep.cpu().argmax(-1), dep_cpu.argmax(-1))
