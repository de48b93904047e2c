"""Card-only tests of the PyTorch port: each CUDA kernel against its plain
version on the card (the fake-quant kernel's backward too), integer
deploy forwards through the kernels, and one reconstruction on the card
against the CPU.

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
    on both sides (__fmul_rn / __fadd_rn): bit-exact."""
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
    assert torch.equal(got, TP.packed_quant_matmul_plain(*args))


def _requants(g, card, n, out_shape):
    """A requant onto a 4-bit site after relu, and the block requant after
    the f32 affine with an int8 and an f32 residual (ops/cuda/requant)."""
    from shiftedscalequantization_tpu_torch.ops.cuda.requant import Requant

    def t(v):
        return torch.tensor(v, device=card)

    def cols(lo, hi):
        return torch.rand((n,), generator=g, device=card) * (hi - lo) + lo

    r8 = torch.randint(-7, 9, out_shape, generator=g, device=card,
                       dtype=torch.int8)
    rf = torch.randn(out_shape, generator=g, device=card)
    return {
        "site": Requant(m1=cols(0.5, 2.0), c1=cols(0.5, 8.5),
                        q1=(t(0.0), t(15.0), t(0.0))),
        "block codes": Requant(m1=cols(0.8, 1.2), c1=cols(-1, 1),
                               m2=cols(0.5, 2.0), c2=cols(0.5, 8.5),
                               q2=(t(0.0), t(15.0), t(8.0)), r=r8,
                               mr=t(0.7)),
        "block f32": Requant(m2=cols(0.5, 2.0), c2=cols(100.5, 140.5),
                             q2=(t(0.0), t(255.0), t(128.0)), r=rf,
                             mr=t(2.4)),
    }


@pytest.mark.parametrize("bits,b,h,k,n,stride,feed", [
    (2, 4, 56, 64, 128, 2, "codes"), (2, 2, 28, 24, 144, 1, "codes"),
    (4, 3, 14, 40, 72, 1, "codes"), (2, 2, 9, 130, 40, 2, "codes"),
    (2, 2, 14, 64, 96, 2, "f32"), (4, 2, 7, 30, 24, 1, "f32")])
def test_packed_codes_and_requant_match_plain(card, bits, b, h, k, n,
                                              stride, feed):
    """Codes fed as int8 (16-, 8- and 1-byte loads) or f32, a strided 1x1
    conv read in place, sums and every requant mode: bit-exact."""
    from shiftedscalequantization_tpu_torch.ops.cuda import packed as TP
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randint(-7, 9, (b, h, h, k), generator=g, device=card,
                      dtype=torch.int8) if feed == "codes" \
        else torch.randn((b, h, h, k), generator=g, device=card)
    raw = torch.randint(0, 2 ** bits, (k, n), generator=g, device=card,
                        dtype=torch.int32)
    w_zp = torch.randint(0, 2 ** bits, (n,), generator=g,
                         device=card).float()
    scale = torch.rand((n,), generator=g, device=card) * 0.2 + 0.05
    bias = torch.randn((n,), generator=g, device=card)
    args = (x, TP.pack_codes(raw, bits), w_zp, scale, bias,
            torch.tensor(0.25, device=card), torch.tensor(7.0, device=card),
            bits, 4)
    got = TP.packed_quant_matmul(*args, stride=stride)
    assert torch.equal(got, TP.packed_quant_matmul_plain(*args,
                                                         stride=stride))
    for name, rq in _requants(g, card, n, got.shape).items():
        got = TP.packed_quant_matmul(*args, stride=stride, requant=rq)
        want = TP.packed_quant_matmul_plain(*args, stride=stride, requant=rq)
        torch.cuda.synchronize()
        assert got.dtype == torch.int8 and torch.equal(got, want), name
        assert torch.unique(want).numel() >= 3, name


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
    """ResNet-18 ImageNet W2A4 at 64x64: one stem, three packed and 16
    int8_conv launches per forward, deploy == sim as bench.py gates it
    (rel-MSE <= 1e-2), and the card agrees with the CPU plain path on the
    same state."""
    import shiftedscalequantization_tpu_torch as tp
    from shiftedscalequantization_tpu_torch import deploy as TD
    from shiftedscalequantization_tpu_torch.models import zoo as TZ
    from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul as TI
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
    TI.int8_conv.launches = 0
    dep = TD.deploy_forward(graph, dp, steps, x, plan=plan, device=card)
    torch.cuda.synchronize()
    assert (TS.stem_fused.launches, TP.packed_quant_matmul.launches,
            TI.int8_conv.launches) == (1, 3, 16)
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


@pytest.mark.parametrize("b,h,w,c,stride", [
    (5, 15, 15, 28, 2), (3, 9, 7, 12, 1), (2, 13, 11, 20, 2),
    (5, 28, 28, 192, 2), (4, 7, 7, 960, 1), (3, 56, 56, 36, 1),
    (2, 1, 1, 16, 1)])
def test_dw_kernel_full_int8_range_matches_plain(card, b, h, w, c, stride):
    """Codes and weights over the whole int8 range (the dp4a products'
    signs), every act, a centered 4-bit grid and a centered 8-bit one, on
    constants prepared once: bit-exact at ragged batches, odd and
    non-square H x W, stride 2 and C % 16 != 0 (the 4-byte copy instance),
    one launch each."""
    from shiftedscalequantization_tpu_torch.ops.cuda import depthwise as TDW
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randint(-128, 128, (b, h, w, c), generator=g, device=card,
                      dtype=torch.int8)
    wc = torch.randint(-128, 128, (c, 3, 3), generator=g, device=card,
                       dtype=torch.int8)
    scalef = torch.rand((c,), generator=g, device=card) * 0.002 + 1e-4
    biasf = torch.randn((c,), generator=g, device=card)
    for delta, zp, qmax in ((0.07, 7.0, 15.0), (0.013, 128.0, 255.0)):
        k = TDW.prepare_dw(wc, scalef, biasf, torch.tensor(delta, device=card),
                           torch.tensor(zp, device=card), qmax)
        for act in TDW.ACTS:
            before = TDW.dw_conv3x3_int8.launches
            got = TDW.dw_conv3x3_int8_prepared(x, k, stride, act)
            torch.cuda.synchronize()
            assert TDW.dw_conv3x3_int8.launches == before + 1
            want = TDW.dw_plain_prepared(x, k, stride, act)
            assert torch.equal(got, want), (delta, act)


@pytest.mark.parametrize("b,h,oc,biased", [(5, 224, 64, True),
                                           (3, 64, 16, False),
                                           (2, 40, 32, True),
                                           (1, 48, 48, False)])
def test_stem_kernel_equals_plain_on_grid_images(card, b, h, oc, biased):
    """On 1/8-grid images every value is bf16-exact (lo = 0) and every sum
    exact in f32: the 2-pass bf16 kernel equals the plain f32 conv bit for
    bit, at ragged batches and every OC instance; the kernel refuses OC
    above 64 and H not a multiple of 4 rather than take the plain
    version."""
    from shiftedscalequantization_tpu_torch.ops.cuda import stem as TS
    g = torch.Generator(device=card).manual_seed(4)
    x = torch.round(torch.randn((b, h, h, 3), generator=g, device=card)
                    * 8) / 8
    w = torch.randint(-128, 128, (oc, 3, 7, 7), generator=g,
                      device=card).float()
    scale = torch.rand((oc,), generator=g, device=card) * 0.003 + 0.001
    bias = torch.randn((oc,), generator=g, device=card) * 0.1
    q = (0.02, 0.0, 255.0, 128.0) if biased else (0.1, 0.0, 15.0, 0.0)
    k = TS.prepare_stem(w, scale, bias, *q)
    before = TS.stem_fused.launches
    got = TS.stem_fused_prepared(x, k)
    torch.cuda.synchronize()
    assert TS.stem_fused.launches == before + 1
    assert torch.equal(got, TS.stem_plain_prepared(x, k))
    with pytest.raises(ValueError, match="up to 64"):
        TS.stem_fused(x, torch.zeros((80, 3, 7, 7), device=card),
                      torch.ones(80, device=card),
                      torch.zeros(80, device=card), *q)
    with pytest.raises(ValueError, match="multiples of 4"):
        TS.stem_fused_prepared(x[:, :h - 2, :h - 2].contiguous(), k)
    assert TS.stem_fused.launches == before + 1


@pytest.mark.parametrize("b,h,ci,ce,co,expand,residual,full", [
    # MobileNetV2's 8 stride-1 block shapes at small batch
    (2, 112, 32, 32, 16, False, False, False),
    (4, 56, 24, 144, 24, True, True, False),
    (4, 28, 32, 192, 32, True, True, False),
    (8, 14, 64, 384, 64, True, True, False),
    (8, 14, 64, 384, 96, True, False, False),
    (8, 14, 96, 576, 96, True, True, False),
    (8, 7, 160, 960, 160, True, True, False),
    (8, 7, 160, 960, 320, True, False, False),
    # ragged: H = 13, CI = 20, CE not a multiple of the 32-channel chunk
    (3, 13, 20, 40, 20, True, True, False),
    (3, 13, 8, 48, 12, True, False, False),
    (3, 7, 16, 16, 16, False, True, False),
    # the whole int8 range with 8-bit stage clips (hi_e = hi_d = 255)
    (4, 56, 24, 144, 24, True, True, True),
    (8, 7, 160, 960, 320, True, False, True),
    (2, 112, 32, 32, 16, False, False, True),
    (3, 13, 20, 40, 20, True, True, True)])
def test_mbconv_kernel_matches_plain(card, b, h, ci, ce, co, expand,
                                     residual, full):
    """Integer sums exact on both sides, epilogues rounded step by step:
    bit-exact at MobileNetV2 block shapes, ragged ones and over the whole
    int8 range; one launch each, on constants prepared once."""
    from shiftedscalequantization_tpu_torch.ops.cuda import mbconv as TMB
    g = torch.Generator(device=card).manual_seed(3)
    lim = (-128, 128) if full else (-2, 2)

    def codes(*shape):
        return torch.randint(*lim, shape, generator=g, device=card,
                             dtype=torch.int8)

    def rows(n, lo, hi, mean=0.5, spread=1.0):
        return torch.stack([torch.rand((n,), generator=g, device=card)
                            * (hi - lo) + lo,
                            torch.randn((n,), generator=g, device=card)
                            * spread + mean]).contiguous()

    if full:
        x = torch.randint(-128, 128, (b, h, h, ci), generator=g,
                          device=card, dtype=torch.int8)
        se, sd, sp = (128 / (ci ** 0.5 * 5470), 128 / 22000,
                      128 / (ce ** 0.5 * 9000))
        args = (x, codes(ci, ce), rows(ce, se / 2, 1.5 * se, 100, 30),
                codes(9, ce), rows(ce, sd / 2, 1.5 * sd, 100, 30),
                codes(ce, co), rows(co, sp / 2, 1.5 * sp, 0, 10),
                torch.tensor([255.0, 255.0, 0.7, -128.0, 127.0, 0.0],
                             device=card))
    else:
        x = torch.randint(-8, 8, (b, h, h, ci), generator=g, device=card,
                          dtype=torch.int8)
        args = (x, codes(ci, ce), rows(ce, 0.05, 0.3), codes(9, ce),
                rows(ce, 0.05, 0.3), codes(ce, co), rows(co, 0.01, 0.1),
                torch.tensor([15.0, 15.0, 0.7, -8.0, 7.0, 0.0],
                             device=card))
    kw = dict(has_expand=expand, has_residual=residual)
    k = TMB.prepare_mbconv(*args[1:], **kw)
    before = TMB.mbconv_fused.launches
    got = TMB.mbconv_fused_prepared(x, k)
    torch.cuda.synchronize()
    assert TMB.mbconv_fused.launches == before + 1
    want = TMB.mbconv_fused_plain(*args, **kw)
    assert torch.equal(got, want)
    assert torch.equal(TMB.mbconv_fused(*args, **kw), want)
    assert TMB.mbconv_fused.launches == before + 2


def test_mbconv_kernel_refuses_before_launch(card):
    """A shape the kernel cannot take (CI not a multiple of 4) raises
    ValueError in the wrapper, and nothing is launched."""
    from shiftedscalequantization_tpu_torch.ops.cuda import mbconv as TMB
    x = torch.zeros((1, 8, 8, 22), dtype=torch.int8, device=card)
    we = torch.zeros((22, 44), dtype=torch.int8, device=card)
    wd = torch.zeros((9, 44), dtype=torch.int8, device=card)
    wp = torch.zeros((44, 22), dtype=torch.int8, device=card)
    r44 = torch.zeros((2, 44), device=card)
    before = TMB.mbconv_fused.launches
    with pytest.raises(ValueError, match="multiples of 4"):
        TMB.mbconv_fused(x, we, r44, wd, r44, wp, torch.zeros((2, 22),
                                                              device=card),
                         torch.zeros(6, device=card))
    assert TMB.mbconv_fused.launches == before


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


@pytest.mark.parametrize("m,k,n,relu,bits", [
    (12544, 256, 512, False, 4), (1000, 130, 72, True, 4),
    (37, 16, 24, False, 4), (300, 64, 128, True, 8)])
def test_quant_matmul_kernel_matches_plain(card, m, k, n, relu, bits):
    """Division, half-to-even rounding, exact int32 sums and an epilogue
    rounded step by step on both sides: bit-exact, ragged M, K and N
    included (8-bit codes centred by zp 128 to fit int8)."""
    from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul as TI
    g = torch.Generator(device=card).manual_seed(4)
    x = torch.randn((m, k), generator=g, device=card)
    w = torch.randint(-2, 2, (k, n), generator=g, device=card,
                      dtype=torch.int8)
    scale = torch.rand((n,), generator=g, device=card) * 0.1
    bias = torch.randn((n,), generator=g, device=card)
    zp = 7.0 if bits == 4 else 128.0
    args = (x, w, scale, bias, torch.tensor(0.05, device=card),
            torch.tensor(zp, device=card), bits, relu)
    before = TI.quant_matmul.launches
    got = TI.quant_matmul(*args)
    torch.cuda.synchronize()
    assert TI.quant_matmul.launches == before + 1
    assert torch.equal(got, TI.quant_matmul_plain(*args))
    x4 = x[:36].reshape(1, 6, 6, k)
    got = TI.quant_conv1x1(x4, w.T.contiguous(), scale, bias, *args[4:7],
                           stride=(2, 2), relu=relu)
    want = TI.quant_matmul_plain(x4[:, ::2, ::2].reshape(9, k), *args[1:])
    assert torch.equal(got.reshape(9, n), want)


@pytest.mark.parametrize("b,h,c,n,kern,stride,pad,s,pad_value,offset", [
    (4, 14, 64, 64, 3, 1, 1, 1, 0, False),
    (2, 15, 128, 72, 3, 2, 1, 2, 0, False),
    (3, 9, 32, 40, 1, 2, 0, 2, 0, True),
    (2, 8, 16, 16, 3, 1, 1, 1, -128, True),
    (2, 11, 3, 24, 5, 2, 2, 3, 3, False),
    (1, 7, 48, 8, 3, 1, 1, 4, -8, True)])
def test_int8_conv_kernel_matches_plain(card, b, h, c, n, kern, stride, pad,
                                        s, pad_value, offset):
    """Exact int32 sums and a scale-table epilogue rounded step by step in
    the JAX package's order: bit-exact for int32 (S = 1) and f32 (S >= 1)
    outputs, with offset padding, per-group offsets, ragged M, N and K,
    and C not a multiple of 16 (byte gathers)."""
    from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul as TI
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randint(-8, 8, (b, h, h, c), generator=g, device=card,
                      dtype=torch.int8)
    w = torch.randint(-2, 2, (s, n, kern * kern * c), generator=g,
                      device=card, dtype=torch.int8)
    acc_off = torch.randint(-300, 300, (s, n), generator=g, device=card,
                            dtype=torch.int32) if offset else None
    geom = ((kern, kern), (stride, stride), (pad, pad))
    before = TI.int8_conv.launches
    if s == 1:
        got = TI.int8_conv(x, w, *geom, pad_value=pad_value,
                           acc_offset=acc_off)
        want = TI.int8_conv_plain(x, w, *geom, pad_value=pad_value,
                                  acc_offset=acc_off)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    table = torch.rand((s, n), generator=g, device=card) * 0.02 + 1e-3
    delta = torch.tensor(0.37, device=card)
    got = TI.int8_conv(x, w, *geom, pad_value=pad_value, group_scales=table,
                       act_delta=delta, acc_offset=acc_off)
    torch.cuda.synchronize()
    assert TI.int8_conv.launches == before + 1 + (s == 1)
    want = TI.int8_conv_plain(x, w, *geom, pad_value=pad_value,
                              group_scales=table, act_delta=delta,
                              acc_offset=acc_off)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("b,h,c,n,kern,stride,pad,s", [
    (4, 14, 64, 64, 3, 1, 1, 1), (2, 15, 128, 72, 3, 2, 1, 2),
    (2, 11, 3, 24, 5, 2, 2, 3), (1, 7, 48, 40, 3, 1, 1, 4)])
def test_int8_conv_requant_matches_plain(card, b, h, c, n, kern, stride,
                                         pad, s):
    """The requant modes (a unit site; the block requant with int8 and
    f32 residuals) on int32 sums (S = 1) and scale-table sums, with
    16-byte and byte gathers: bit-exact."""
    from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul as TI
    g = torch.Generator(device=card).manual_seed(6)
    x = torch.randint(-8, 8, (b, h, h, c), generator=g, device=card,
                      dtype=torch.int8)
    w = torch.randint(-2, 3, (s, n, kern * kern * c), generator=g,
                      device=card, dtype=torch.int8)
    geom = ((kern, kern), (stride, stride), (pad, pad))
    table = None if s == 1 else \
        torch.rand((s, n), generator=g, device=card) * 0.2 + 0.05
    kw = dict(group_scales=table, act_delta=torch.tensor(0.37, device=card))
    sums = TI.int8_conv(x, w, *geom, **kw)
    for name, rq in _requants(g, card, n, sums.shape).items():
        if s == 1 and name == "site":
            rq.m1 = rq.m1 * 0.05        # int32 sums: scale them to codes
        got = TI.int8_conv(x, w, *geom, requant=rq, **kw)
        want = TI.int8_conv_plain(x, w, *geom, requant=rq, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.int8 and torch.equal(got, want), name


def test_int8_conv_refuses_what_it_cannot_take(card):
    """On a CUDA tensor the wrapper launches or raises: too many groups,
    a weight of the wrong K, a non-contiguous input, no table for S > 1."""
    from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul as TI
    x = torch.zeros((2, 8, 8, 16), dtype=torch.int8, device=card)
    geom = ((3, 3), (1, 1), (1, 1))
    table = torch.ones((5, 8), device=card)
    before = TI.int8_conv.launches
    with pytest.raises(ValueError, match="weight groups"):
        TI.int8_conv(x, torch.zeros((5, 8, 144), dtype=torch.int8,
                                    device=card), *geom,
                     group_scales=table, act_delta=1.0)
    with pytest.raises(ValueError, match="weight groups"):
        TI.int8_conv(x, torch.zeros((2, 8, 144), dtype=torch.int8,
                                    device=card), *geom)
    with pytest.raises(ValueError, match="KH\\*KW\\*C"):
        TI.int8_conv(x, torch.zeros((1, 8, 140), dtype=torch.int8,
                                    device=card), *geom)
    with pytest.raises(ValueError, match="contiguous"):
        TI.int8_conv(x.permute(0, 2, 1, 3), torch.zeros(
            (1, 8, 144), dtype=torch.int8, device=card), *geom)
    assert TI.int8_conv.launches == before


@pytest.mark.parametrize("b,h,c,n,groups,kern,stride,pad,s,offset", [
    (4, 14, 240, 240, 10, 3, 1, 1, 1, 0),      # RegNetX-600M s3, Cg = 24
    (2, 15, 96, 96, 4, 3, 2, 1, 2, 128),       # stride 2, biased feed
    (2, 9, 24, 24, 3, 3, 1, 1, 3, 0),          # Cg = 8, S = 3
    (1, 9, 15, 15, 3, 3, 2, 1, 4, 9),          # odd Cg = OC/G = 5
    (2, 7, 32, 48, 2, 3, 1, 1, 1, 0),          # OC/G = 24 > Cg = 16
    (2, 6, 16, 24, 2, 3, 1, 1, 2, 0),          # OC/G = 12
    (2, 6, 96, 80, 2, 1, 1, 0, 1, 0),          # 1x1, OC/G = 40: 2 chunks
    (32, 7, 368, 368, 46, 3, 1, 1, 2, 0),      # 3 images a tile, last short
    (1, 7, 528, 528, 22, 3, 1, 1, 2, 0),       # batch 1: 4-row bands, 7 % 4
    (1, 56, 96, 96, 4, 3, 2, 1, 2, 0),         # batch 1, stride 2
    (32, 28, 240, 240, 10, 3, 2, 1, 2, 0),     # bands of 5 rows of 14
    (32, 15, 96, 96, 4, 3, 2, 1, 2, 0),        # 15x15 at stride 2
    (32, 14, 560, 560, 14, 3, 1, 1, 2, 0),     # Cg = 40 (RegNetX-4000M)
    (32, 14, 432, 432, 9, 3, 1, 1, 2, 0),      # Cg = 48 (-3200M), G odd
    (32, 14, 784, 784, 14, 3, 1, 1, 2, 0),     # Cg = 56 (-6400M), 5 rows
    (32, 28, 168, 168, 7, 3, 1, 1, 2, 0),      # Cg = 24, odd g: 8-byte runs
    (32, 14, 240, 240, 10, 3, 1, 1, 4, 0),     # S = 4
    (1, 7, 256, 512, 1, 3, 1, 1, 1, 0)])       # weights in column tiles
def test_int8_group_conv_kernel_matches_plain(card, b, h, c, n, groups,
                                              kern, stride, pad, s, offset):
    """The grouped kernel against its plain version: int32 sums (S = 1),
    the scale-table sum and a unit-site and a block requant with an int8
    and an f32 residual, bit-exact, one launch each, with codes of a 4-bit
    feed (offset 0) and of a biased 8-bit one (offset 128, and the case's
    own); group widths 256, 56, 48, 40, 24, 16, 8 and odd, OC/G of 5, 12,
    24, 40, 512 (in column tiles); tiles of several images, bands that do
    not divide the image, batch 1 and S up to 4."""
    from shiftedscalequantization_tpu_torch.ops.cuda import group_conv as TG
    g = torch.Generator(device=card).manual_seed(7)
    w = torch.randint(-2, 3, (s, n, kern * kern * (c // groups)),
                      generator=g, device=card, dtype=torch.int8)
    geom = ((kern, kern), (stride, stride), (pad, pad))
    table = torch.rand((s, n), generator=g, device=card) * 0.02 + 1e-3
    delta = torch.tensor(0.37, device=card)
    ho = (h + 2 * pad - kern) // stride + 1
    for off_n in sorted({0, 128, offset}):
        span = 128 if off_n else 8
        x = torch.randint(-span, span, (b, h, h, c), generator=g,
                          device=card, dtype=torch.int8)
        off = off_n * w.sum(dim=2, dtype=torch.int32) if off_n else None
        modes = [dict(group_scales=table, act_delta=delta)]
        if s == 1:
            modes.append({})
        for rq in _requants(g, card, n, (b, ho, ho, n)).values():
            modes.append(dict(group_scales=table, act_delta=delta,
                              requant=rq))
        for kw in modes:
            before = TG.int8_group_conv.launches
            got = TG.int8_group_conv(x, w, *geom, groups, pad_value=-off_n,
                                     acc_offset=off, **kw)
            torch.cuda.synchronize()
            assert TG.int8_group_conv.launches == before + 1
            want = TG.int8_group_conv_plain(x, w, *geom, groups,
                                            pad_value=-off_n,
                                            acc_offset=off, **kw)
            assert got.dtype == want.dtype and torch.equal(got, want)


def test_int8_group_conv_refuses_what_it_cannot_take(card):
    """On a CUDA tensor the wrapper launches or raises: groups that do not
    divide the channels, a weight of the wrong K, too many weight
    groups."""
    from shiftedscalequantization_tpu_torch.ops.cuda import group_conv as TG
    x = torch.zeros((2, 8, 8, 24), dtype=torch.int8, device=card)
    geom = ((3, 3), (1, 1), (1, 1))
    before = TG.int8_group_conv.launches
    with pytest.raises(ValueError, match="conv groups"):
        TG.int8_group_conv(x, torch.zeros((1, 24, 45), dtype=torch.int8,
                                          device=card), *geom, 5)
    with pytest.raises(ValueError, match="KH\\*KW\\*Cg"):
        TG.int8_group_conv(x, torch.zeros((1, 24, 70), dtype=torch.int8,
                                          device=card), *geom, 3)
    with pytest.raises(ValueError, match="weight groups"):
        TG.int8_group_conv(x, torch.zeros((5, 24, 72), dtype=torch.int8,
                                          device=card), *geom, 3,
                           group_scales=torch.ones((5, 24), device=card),
                           act_delta=1.0)
    assert TG.int8_group_conv.launches == before


def test_shifted_scale_deploy_on_card(card, monkeypatch):
    """The method path at small size: CIFAR ResNet-18 W2A4, fused
    shifted-scale quantizers with targets {1/2, 1} (logits perturbed)
    hardened to the baked form, served: 19 int8_conv launches per
    forward (16 3x3 convs and 3 downsamples), deploy == sim within the
    1e-2 gate, and on 1/8-grid images the card equals the CPU plain path
    (rel-MSE <= 1e-8, same top-1)."""
    import shiftedscalequantization_tpu_torch as tp
    from shiftedscalequantization_tpu_torch import deploy as TD
    from shiftedscalequantization_tpu_torch.models import zoo as TZ
    from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul as TI
    from shiftedscalequantization_tpu_torch.recon import engine as TE
    from shiftedscalequantization_tpu_torch.quantize import unit_order
    monkeypatch.setenv("SSQ_PACKED", "1")
    graph, _ = TZ.build("resnet18", num_classes=10, dataset="cifar10")
    cfg = tp.QuantConfig(n_bits_w=2, n_bits_a=4)
    params, qs = tp.prepare_model(graph, TZ.init_params(graph, device=card),
                                  cfg, device=card)
    x = np.random.default_rng(0).normal(size=(16, 32, 32, 3))
    x = torch.as_tensor((np.round(x * 8) / 8).astype(np.float32),
                        device=card)
    qs = tp.calibrate_acts(graph, params, qs, x, cfg, device=card)
    names = unit_order(graph)
    qs, theta = TE._init_quantizers(params, qs, names, TE.ReconSettings(
        mode="fused", shift_targets=(0.5, 1.0)))
    # seeded noise on the logits, as a trained state would have, so that
    # both candidates own input channels
    g = torch.Generator(device=card).manual_seed(6)
    theta = {n: {k: v + torch.randn(v.shape, generator=g, device=card)
                 for k, v in t.items()} for n, t in theta.items()}
    qs = TE._harden(TE._insert_theta(qs, theta), names, "fused")
    dp = TD.build_deploy_params(graph, params, qs, device=card)
    assert sum(d.w_groups is not None for d in dp.values()) == 19
    assert all(bool((d.w_groups[s] != 0).any()) for d in dp.values()
               if d.w_groups is not None for s in range(2))
    steps = TD.act_steps_from_qstate(graph, qs)
    plan = TD.make_deploy_plan(graph, dp, steps, input_hw=(32, 32))
    TI.int8_conv.launches = 0
    dep = TD.deploy_forward(graph, dp, steps, x, plan=plan, device=card)
    torch.cuda.synchronize()
    assert TI.int8_conv.launches == 19
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


@pytest.mark.parametrize("r,c,per_row,hi", [
    (802816, 64, False, 15), (512, 4608, True, 3), (64, 147, True, 255),
    (10, 130, True, 15), (1001, 3, False, 15)])
def test_fake_quant_kernel_matches_plain(card, r, c, per_row, hi):
    """IEEE division and half-to-even rounding on both sides: bit-exact,
    the vector path (C % 4 == 0) and the scalar one, per row and per
    tensor, with a fifth of the elements on exact codes and bounds."""
    from shiftedscalequantization_tpu_torch.ops.cuda import fake_quant as FQ
    g = torch.Generator(device=card).manual_seed(7)
    if per_row:
        d = torch.rand((r, 1), generator=g, device=card) * 0.3 + 0.05
        z = torch.randint(0, hi + 1, (r, 1), generator=g, device=card).float()
    else:
        d = torch.full((1, 1), 0.37, device=card)
        z = torch.full((1, 1), 3.0, device=card)
    x = torch.randn((r, c), generator=g, device=card) * 2
    codes = torch.randint(-2, hi + 3, (r, c), generator=g, device=card)
    pin = torch.rand((r, c), generator=g, device=card) < 0.2
    x = torch.where(pin, (codes.float() - z) * d, x)
    before = FQ.fake_quant_2d.launches
    got = FQ.fake_quant_2d(x, d, z, 0, hi)
    torch.cuda.synchronize()
    assert FQ.fake_quant_2d.launches == before + 1
    assert torch.equal(got, FQ.fake_quant_plain(x, d, z, 0, hi))
    # a view 4 bytes off 16-byte alignment takes the scalar path
    xu = x.reshape(-1)[1:1 + (r - 1) * c].reshape(r - 1, c)
    du, zu = (d[: r - 1], z[: r - 1]) if per_row else (d, z)
    assert torch.equal(FQ.fake_quant_2d(xu, du, zu, 0, hi),
                       FQ.fake_quant_plain(xu, du, zu, 0, hi))
    with pytest.raises(ValueError, match="float32"):
        FQ.fake_quant_2d(x.double(), d, z, 0, hi)


@pytest.mark.parametrize("kind", ["act", "weight"])
def test_fake_quant_backward_on_card(card, kind):
    """The Function's backward on the card against autograd through the
    plain version: grad x equal (g * delta * m / delta in both; the
    clip-bound ties give m = 1/2), grad delta
    and zp within 1e-4 of their largest magnitude (sums in two orders)."""
    from shiftedscalequantization_tpu_torch.ops.cuda import fake_quant as FQ
    g = torch.Generator(device=card).manual_seed(8)
    bits = 4 if kind == "act" else 2
    hi = 2 ** bits - 1
    shape = (16, 14, 14, 64) if kind == "act" else (128, 64, 3, 3)
    if kind == "act":
        d, z = torch.tensor(0.37, device=card), torch.tensor(2.0, device=card)
        db, zb = d, z
    else:
        d = torch.rand((shape[0], 1), generator=g, device=card) * 0.3 + 0.05
        z = torch.randint(0, hi + 1, (shape[0], 1), generator=g,
                          device=card).float()
        db, zb = d.reshape(-1, 1, 1, 1), z.reshape(-1, 1, 1, 1)
    x = torch.randn(shape, generator=g, device=card) * 2
    codes = torch.randint(-2, hi + 3, shape, generator=g, device=card)
    x = torch.where(torch.rand(shape, generator=g, device=card) < 0.2,
                    (codes.float() - zb) * db, x)
    cot = torch.randn(shape, generator=g, device=card)
    grads = []
    for route in ("kernel", "plain"):
        xt, dt, zt = (t.clone().requires_grad_(True) for t in (x, d, z))
        if route == "plain":
            y = FQ.fake_quant_plain(xt, dt.reshape(db.shape),
                                    zt.reshape(zb.shape), 0, hi)
        elif kind == "act":
            y = FQ.fake_quant_act(xt, dt, zt, bits)
        else:
            y = FQ.fake_quant_weight(xt, dt, zt, bits, False)
        (y * cot).sum().backward()
        grads.append((y.detach(), xt.grad, dt.grad, zt.grad))
    (y1, gx, gd, gz), (y2, rx, rd, rz) = grads
    assert torch.equal(y1, y2) and torch.equal(gx, rx)
    assert bool(((rx / cot - 0.5).abs() < 1e-6).any())
    for a, b in ((gd, rd), (gz, rz)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_reconstruct_node_step_on_card(card):
    """One fused reconstruction (warm start, joint step, refine) of a
    CIFAR ResNet-18 block on the card and on the CPU from the same caches
    and the same CPU-generator rows: traces within rtol 1e-3, hardened
    codes within a 0.5% flip rate."""
    import shiftedscalequantization_tpu_torch as tp
    from shiftedscalequantization_tpu_torch import quantize as TQZ
    from shiftedscalequantization_tpu_torch.models import zoo as TZ
    from shiftedscalequantization_tpu_torch.recon import capture as TC
    from shiftedscalequantization_tpu_torch.recon import engine as TE
    graph, _ = TZ.build("resnet18", num_classes=10, dataset="cifar10")
    cfg = tp.QuantConfig(n_bits_w=2, n_bits_a=4)
    params, qs = tp.prepare_model(graph, TZ.init_params(graph, device=card),
                                  cfg, device=card)
    x = torch.randn((32, 32, 32, 3),
                    generator=torch.Generator(device=card).manual_seed(9),
                    device=card)
    name = "model.layer2.0"
    ci, co = TC.capture_io(graph, params, qs, name, x, tp.Flags(),
                           tp.Flags(), batch_size=32, device=card)
    s = TE.ReconSettings(mode="fused", iters=12, batch_size=16,
                         shift_targets=(0.5, 1.0), warmstart_frac=0.25)
    q_card, m_card = TE.reconstruct_node(graph, params, qs, name, ci, co, s,
                                         seed=3)
    q_cpu, m_cpu = TE.reconstruct_node(
        graph, TQZ.to_device(params, "cpu"), TQZ.to_device(qs, "cpu"), name,
        ci.cpu(), co.cpu(), s, seed=3)
    for a, b in ((m_card["rec_trace"], m_cpu["rec_trace"]),
                 (m_card["refine_trace"], m_cpu["refine_trace"]),
                 (m_card["warmstart"]["rec_trace"],
                  m_cpu["warmstart"]["rec_trace"])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=0)
    for u in ("model.layer2.0.conv1", "model.layer2.0.conv2",
              "model.layer2.0.downsample.0"):
        wc, wh = q_card[u].wq, q_cpu[u].wq
        assert float((wc.st_index.cpu() != wh.st_index).float().mean()) \
            <= 0.005
        assert float(((wc.alpha.cpu() >= 0) != (wh.alpha >= 0)).float()
                     .mean()) <= 0.005


@pytest.mark.parametrize("b,h,w,c,k,stride,s,skew", [
    (4, 56, 56, 144, 5, 1, 1, False), (4, 56, 56, 144, 5, 2, 2, False),
    (2, 28, 28, 240, 5, 1, 2, False), (8, 7, 7, 1152, 5, 1, 1, False),
    (2, 112, 112, 32, 3, 1, 1, False), (2, 15, 13, 96, 3, 2, 3, False),
    (3, 9, 11, 20, 5, 2, 4, False), (2, 10, 10, 30, 3, 1, 1, False),
    (3, 13, 11, 36, 5, 1, 4, False), (2, 9, 10, 100, 3, 2, 3, False),
    (4, 1, 1, 100, 3, 1, 2, False), (4, 2, 2, 36, 5, 2, 1, False),
    (2, 2, 2, 100, 5, 1, 3, False), (2, 12, 17, 48, 3, 1, 2, True),
    (2, 13, 11, 48, 5, 2, 1, True)])
def test_dw_conv_int8_kernel_matches_plain(card, b, h, w, c, k, stride, s,
                                           skew):
    """The integer depthwise kernel against its plain version: int32 sums
    (S = 1), the scale-table sum, a unit-site and two block requants and
    one with grid bounds that are not integers, bit-exact, one launch
    each, with codes of a 4-bit feed (offset 0) and of a biased 8-bit one
    (offset 128); K 3 and 5, strides 1 and 2, odd
    and short maps (planes no tile divides, 1x1 and 2x2), S up to 4 (3
    padded to 4), C % 4 != 0 (byte copies), C % 16 != 0 (4-byte copies:
    36, 100), C % 32 != 0 (a partial channel slab) and a codes view one
    byte off (byte copies)."""
    from shiftedscalequantization_tpu_torch.ops.cuda import dw_conv as TDC
    from shiftedscalequantization_tpu_torch.ops.cuda.requant import Requant
    g = torch.Generator(device=card).manual_seed(11)
    wm = torch.randint(-2, 3, (s, c, k * k), generator=g, device=card,
                       dtype=torch.int8)
    geom = ((k, k), (stride, stride), (k // 2, k // 2))
    table = torch.rand((s, c), generator=g, device=card) * 0.02 + 1e-3
    delta = torch.tensor(0.37, device=card)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    for off_n in (0, 128):
        span = 128 if off_n else 8
        buf = torch.randint(-span, span, (b * h * w * c + int(skew),),
                            generator=g, device=card, dtype=torch.int8)
        x = buf[int(skew):].view(b, h, w, c)
        off = off_n * wm.sum(dim=2, dtype=torch.int32) if off_n else None
        modes = [dict(group_scales=table, act_delta=delta)]
        if s == 1:
            modes.append({})
        for rq in _requants(g, card, c, (b, ho, wo, c)).values():
            modes.append(dict(group_scales=table, act_delta=delta,
                              requant=rq))
        # grid bounds that are not integers take the general requant path
        modes.append(dict(group_scales=table, act_delta=delta,
                          requant=Requant(
                              m1=torch.full((c,), 1.3, device=card),
                              c1=torch.full((c,), 7.25, device=card),
                              q1=tuple(torch.tensor(v, device=card)
                                       for v in (0.5, 14.5, 0.25)))))
        for kw in modes:
            before = TDC.dw_conv_int8.launches
            got = TDC.dw_conv_int8(x, wm, *geom, pad_value=-off_n,
                                   acc_offset=off, **kw)
            torch.cuda.synchronize()
            assert TDC.dw_conv_int8.launches == before + 1
            want = TDC.dw_conv_int8_plain(x, wm, *geom, pad_value=-off_n,
                                          acc_offset=off, **kw)
            assert got.dtype == want.dtype and torch.equal(got, want)


def test_dw_conv_int8_refuses_what_it_cannot_take(card):
    """On a CUDA tensor the wrapper launches or raises: a 7x7 kernel, a
    pad other than K // 2, unequal strides, a weight of the wrong shape."""
    from shiftedscalequantization_tpu_torch.ops.cuda import dw_conv as TDC
    x = torch.zeros((2, 8, 8, 16), dtype=torch.int8, device=card)
    w = torch.zeros((1, 16, 9), dtype=torch.int8, device=card)
    before = TDC.dw_conv_int8.launches
    with pytest.raises(ValueError, match="K in"):
        TDC.dw_conv_int8(x, torch.zeros((1, 16, 49), dtype=torch.int8,
                                        device=card), (7, 7), (1, 1), (3, 3))
    with pytest.raises(ValueError, match="K in"):
        TDC.dw_conv_int8(x, w, (3, 3), (1, 1), (0, 0))
    with pytest.raises(ValueError, match="K in"):
        TDC.dw_conv_int8(x, w, (3, 3), (1, 2), (1, 1))
    with pytest.raises(ValueError, match="w_mat"):
        TDC.dw_conv_int8(x, torch.zeros((1, 8, 9), dtype=torch.int8,
                                        device=card), (3, 3), (1, 1), (1, 1))
    assert TDC.dw_conv_int8.launches == before


def test_mnasnet_deploy_on_card_runs_dw_and_pairs(card, monkeypatch):
    """MNASNet W2A4 (CIFAR variant, 32x32, batch 16) under SSQ_DW_KERNEL=1
    SSQ_PACKED=1, plain and harmonized: the 5x5 and biased-fed depthwise
    units on dw_conv_int8, pairs formed and consumed on int8_conv in the
    plain state and none in the harmonized one, deploy == sim as bench.py
    gates it (rel-MSE <= 1e-2), and on 1/8-grid images the card equals
    the CPU plain path on the same state (rel-MSE <= 1e-8, same top-1)."""
    import shiftedscalequantization_tpu_torch as tp
    from shiftedscalequantization_tpu_torch import deploy as TD
    from shiftedscalequantization_tpu_torch.models import zoo as TZ
    from shiftedscalequantization_tpu_torch.ops.cuda import dw_conv as TDC
    from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul as TI
    monkeypatch.setenv("SSQ_DW_KERNEL", "1")
    monkeypatch.setenv("SSQ_PACKED", "1")
    graph, _ = TZ.build("mnasnet", dataset="cifar10")
    cfg = tp.QuantConfig(n_bits_w=2, n_bits_a=4)
    params, qs = tp.prepare_model(graph, TZ.init_params(graph, device=card),
                                  cfg, device=card)
    x = np.random.default_rng(0).normal(size=(16, 32, 32, 3))
    x = torch.as_tensor((np.round(x * 8) / 8).astype(np.float32),
                        device=card)
    qs = tp.calibrate_acts(graph, params, qs, x, cfg, device=card)
    dp = TD.build_deploy_params(graph, params, qs, device=card)
    cpu = lambda d: {k: (v.cpu() if torch.is_tensor(v) else v)  # noqa
                     for k, v in d.__dict__.items()}
    dp_cpu = {k: TD.DeployUnit(**cpu(v)) for k, v in dp.items()}
    for state in ("plain", "harmonized"):
        if state == "harmonized":
            qs, _ = tp.quantize.harmonize_residual_chains(graph, qs)
        steps = TD.act_steps_from_qstate(graph, qs)
        plan = TD.make_deploy_plan(graph, dp, steps, input_hw=(32, 32))
        TDC.dw_conv_int8.launches = TI.int8_conv.launches = 0
        dep = TD.deploy_forward(graph, dp, steps, x, plan=plan, device=card)
        torch.cuda.synchronize()
        dw_units = sum(v[0] in ("bf16_codes", "int8")
                       and n.endswith("layers.3")
                       for n, v in plan.items() if not n.startswith("__"))
        assert TDC.dw_conv_int8.launches == dw_units >= 10
        if state == "plain":
            assert TD.pair_stats["formed"] > 0
            # two terms a pair at the default cap
            assert TI.int8_conv.launches == \
                2 * TD.pair_stats["consumed_fast"] > 0
        else:
            assert TD.pair_stats["formed"] == 0
        sim = tp.forward(graph, params, qs, x,
                         tp.quantize.act_flags(
                             graph, cfg, base=tp.Flags().all_weights(graph)),
                         device=card)
        rel = float(((sim - dep) ** 2).mean() / (sim ** 2).mean())
        assert torch.isfinite(dep).all() and rel <= 1e-2, (state, rel)
        steps_cpu = {k: (d.cpu(), z.cpu(), n)
                     for k, (d, z, n) in steps.items()}
        dep_cpu = TD.deploy_forward(graph, dp_cpu, steps_cpu, x.cpu(),
                                    plan=plan, device="cpu")
        rel_cpu = float(((dep.cpu() - dep_cpu) ** 2).mean()
                        / (dep_cpu ** 2).mean())
        assert rel_cpu <= 1e-8, (state, rel_cpu)
        assert torch.equal(dep.cpu().argmax(-1), dep_cpu.argmax(-1))
