#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port
(``shiftedscalequantization_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed with its seconds; any failure ends the run with a
non-zero exit and no result line:

1. device: the card's name and power limit (nvidia-smi);
2. build: one nvcc call compiles the port's CUDA sources;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the serving path's shapes (batch 256, 224x224), with CUDA
   event timings beside the card's bound for the same work;
4. serving: ResNet-18 ImageNet W2A4 at full width with seeded weights,
   MSE scale init, calibration on 16 images, deploy conversion, and one
   integer deploy forward at batch 256 with the fused stem and packed-W2
   kernels on; the launch counters, reset just before that forward, must
   show both kernels ran;
5. parity: the fake-quant sim forward on the same batch (TF32 off) against
   the deploy logits: no NaN, rel-MSE <= 1e-2.

It imports nothing of JAX. Standard output ends with a JSON line of the
kernels, the nvidia-smi line, the total seconds, and then
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS = 67e12                # H100 SXM f32, outside the tensor cores
INT8_OPS = 1979e12               # H100 SXM int8 tensor cores, dense
RELMSE_GATE = 1e-2
BATCH = 256
HW = 224
_T0 = time.perf_counter()


def phase(name, t0):
    print(f"[{name}] {time.perf_counter() - t0:.2f} s", flush=True)


def time_cuda(fn, iters=20, warmup=3):
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_packed(torch, gen, packed):
    """The three stride-2 downsample 1x1 convs of ResNet-18 at batch 256."""
    rows = []
    shapes = [("layer2.0.downsample", 200704, 64, 128),
              ("layer3.0.downsample", 50176, 128, 256),
              ("layer4.0.downsample", 12544, 256, 512)]
    dev = "cuda"
    for name, m, k, n in shapes:
        x = torch.randn((m, k), generator=gen, device=dev)
        raw = torch.randint(0, 4, (k, n), generator=gen, device=dev,
                            dtype=torch.int32)
        w_zp = torch.randint(0, 4, (n,), generator=gen, device=dev).float()
        scale = torch.rand((n,), generator=gen, device=dev) * 0.09 + 0.01
        bias = torch.randn((n,), generator=gen, device=dev)
        wp = packed.pack_codes(raw, 2)
        delta = torch.tensor(0.05, device=dev)
        zp = torch.tensor(7.0, device=dev)
        args = (x, wp, w_zp, scale, bias, delta, zp, 2, 4)
        got = packed.packed_quant_matmul(*args)
        want = packed.packed_quant_matmul_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
            raise AssertionError(f"packed {name}: max abs err {err}")
        ms = time_cuda(lambda: packed.packed_quant_matmul(*args))
        plain_ms = time_cuda(lambda: packed.packed_quant_matmul_plain(*args))
        xq = (torch.clamp(torch.round(x / delta) + zp, 0, 15) - zp) \
            .to(torch.int8)
        w8 = (raw - w_zp.round().to(torch.int32)).to(torch.int8) \
            .T.contiguous().T
        lib_ms = time_cuda(lambda: torch._int_mm(xq, w8))
        n_bytes = m * k * 4 + wp.numel() * 4 + 3 * n * 4 + m * n * 4
        b_ms, b_by = bound_ms(n_bytes, 2 * m * n * k, INT8_OPS)
        print(f"  packed {name} M={m} K={k} N={n}: {ms:.4f} ms "
              f"(bound {b_ms:.4f} ms by {b_by}, plain {plain_ms:.4f}, "
              f"_int_mm {lib_ms:.4f}), max abs err {err:.3g}", flush=True)
        rows.append(dict(shape=(m, k, n), ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         err=err))
    return rows


def check_stem(torch, gen, stem):
    """The ResNet-18 stem at batch 256, 224x224: biased 8-bit (the serving
    site) and centered 4-bit transport."""
    dev = "cuda"
    x = torch.randn((BATCH, HW, HW, 3), generator=gen, device=dev)
    w = torch.randint(-120, 121, (64, 3, 7, 7), generator=gen,
                      device=dev).float()
    scale = torch.rand((64,), generator=gen, device=dev) * 0.003 + 0.001
    bias = torch.randn((64,), generator=gen, device=dev) * 0.1
    rows = []
    for label, delta, zp, qmax, coff in (("biased", 0.02, 0.0, 255.0, 128.0),
                                         ("centered", 0.1, 0.0, 15.0, 0.0)):
        args = (x, w, scale, bias, delta, zp, qmax, coff)
        got = stem.stem_fused(*args)
        want = stem.stem_fused_plain(*args)
        torch.cuda.synchronize()
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        off = float((diff != 0).float().mean())
        worst = int(diff.max())
        if worst > 1 or off > 2e-3:
            raise AssertionError(f"stem {label}: {off:.3g} of codes off, "
                                 f"max |diff| {worst}")
        ms = time_cuda(lambda: stem.stem_fused(*args))
        plain_ms = time_cuda(lambda: stem.stem_fused_plain(*args))
        hp = HW // 4
        n_bytes = (x.numel() * 4 + w.numel() * 4 + 2 * 64 * 4
                   + BATCH * hp * hp * 64)
        n_ops = 2 * BATCH * (HW // 2) ** 2 * 64 * 147
        b_ms, b_by = bound_ms(n_bytes, n_ops, F32_FLOPS)
        print(f"  stem {label}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
              f"plain {plain_ms:.4f}), {off:.3g} of codes off by "
              f"<= {worst}", flush=True)
        rows.append(dict(label=label, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, err=float(worst),
                         off=off))
    return rows


def serving_setup(torch, gen):
    """ResNet-18 ImageNet W2A4 at full width, seeded weights, all on the
    card: BN fold + MSE weight scales, act calibration on 16 images, deploy
    conversion. Returns (graph, cfg, params, qstate, dparams, steps)."""
    from shiftedscalequantization_tpu_torch import deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.models import zoo
    graph, _ = zoo.build("resnet18", dataset="imagenet")
    raw = zoo.init_params(graph, seed=0, device="cuda")
    cfg = Q.QuantConfig(n_bits_w=2, n_bits_a=4)
    params, qstate = Q.prepare_model(graph, raw, cfg, device="cuda")
    calib = torch.randn((16, HW, HW, 3), generator=gen, device="cuda")
    qstate = Q.calibrate_acts(graph, params, qstate, calib, cfg,
                              device="cuda")
    dparams = deploy.build_deploy_params(graph, params, qstate,
                                         device="cuda")
    steps = deploy.act_steps_from_qstate(graph, qstate)
    return graph, cfg, params, qstate, dparams, steps


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from shiftedscalequantization_tpu_torch import deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, forward
    from shiftedscalequantization_tpu_torch.ops.cuda import _build, packed, \
        stem

    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} (count {count}); nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    phase("device", t0)

    t0 = time.perf_counter()
    _build.load()
    built = _build.build_seconds
    print("  nvcc build " + (f"{built:.2f} s" if built is not None
                             else "reused (same sources)"), flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    packed_rows = check_packed(torch, gen, packed)
    stem_rows = check_stem(torch, gen, stem)
    phase("kernels", t0)

    t0 = time.perf_counter()
    os.environ.update(SSQ_STEM_KERNEL="1", SSQ_PACKED="1",
                      SSQ_STEM_1PASS="0")
    graph, cfg, params, qstate, dparams, steps = serving_setup(torch, gen)
    plan = deploy.make_deploy_plan(graph, dparams, steps,
                                   input_hw=(HW, HW))
    kinds = [v[0] for k, v in plan.items() if not k.startswith("__")]
    if kinds.count("stem_fused") != 1 or kinds.count("packed") != 3:
        raise AssertionError(f"plan kinds {kinds}")
    torch.cuda.synchronize()
    print(f"  setup (init, BN fold, MSE scales, calibration, deploy "
          f"conversion) {time.perf_counter() - t0:.2f} s; plan kinds "
          f"{sorted(set(kinds))}", flush=True)
    x = torch.randn((BATCH, HW, HW, 3), generator=gen, device="cuda")
    stem.stem_fused.launches = 0
    packed.packed_quant_matmul.launches = 0
    logits = deploy.deploy_forward(graph, dparams, steps, x, plan=plan,
                                   device="cuda")
    torch.cuda.synchronize()
    launches = {"stem_fused": stem.stem_fused.launches,
                "packed_quant_matmul": packed.packed_quant_matmul.launches}
    print(f"  launches in one deploy forward: {launches}", flush=True)
    if launches != {"stem_fused": 1, "packed_quant_matmul": 3}:
        raise AssertionError(f"kernel launches {launches}")
    if tuple(logits.shape) != (BATCH, 1000) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("deploy logits not finite or misshapen")
    fwd = lambda: deploy.deploy_forward(graph, dparams, steps, x,  # noqa
                                        plan=plan, device="cuda")
    deploy_ms = time_cuda(fwd, iters=5, warmup=1)
    print(f"  deploy forward batch {BATCH}: {deploy_ms:.3f} ms/batch",
          flush=True)
    phase("serving", t0)

    t0 = time.perf_counter()
    flags = Q.act_flags(graph, cfg, base=Flags().all_weights(graph))
    sim = forward(graph, params, qstate, x, flags, device="cuda")
    torch.cuda.synchronize()
    sim64, dep64 = sim.double(), logits.double()
    if not bool(torch.isfinite(sim64).all()):
        raise AssertionError("sim logits not finite")
    rel_mse = float(((sim64 - dep64) ** 2).mean()
                    / (sim64 ** 2).mean().clamp_min(1e-30))
    agree = float((sim64.argmax(-1) == dep64.argmax(-1)).double().mean())
    print(f"  deploy vs sim: logit rel-MSE {rel_mse:.4e} (gate "
          f"{RELMSE_GATE:g}), top-1 agreement {agree:.4f}", flush=True)
    if not rel_mse <= RELMSE_GATE:
        raise AssertionError(f"parity gate failed: rel-MSE {rel_mse}")
    phase("parity", t0)

    src = "shiftedscalequantization_tpu_torch/csrc/"
    # packed: the three downsample shapes summed, the work of one forward
    per_fwd = {k: sum(r[k] for r in packed_rows)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    kernels = [
        {"name": "packed_quant_matmul", "route": "cuda",
         "source": src + "packed_qmm.cu",
         "replaces": "shiftedscalequantization_tpu/ops/pallas/packed.py:55",
         "launches": launches["packed_quant_matmul"],
         "max_abs_err": max(r["err"] for r in packed_rows),
         "ms": per_fwd["ms"], "plain_ms": per_fwd["plain_ms"],
         "bound_ms": per_fwd["bound_ms"],
         "bound_by": max(packed_rows, key=lambda r: r["bound_ms"])[
             "bound_by"],
         "library_ms": per_fwd["library_ms"]},
        {"name": "stem_fused", "route": "cuda",
         "source": src + "stem_fused.cu",
         "replaces": "shiftedscalequantization_tpu/ops/pallas/stem.py:66",
         "launches": launches["stem_fused"],
         "max_abs_err": max(r["err"] for r in stem_rows),
         "ms": stem_rows[0]["ms"], "plain_ms": stem_rows[0]["plain_ms"],
         "bound_ms": stem_rows[0]["bound_ms"],
         "bound_by": stem_rows[0]["bound_by"], "library_ms": None},
    ]
    print(json.dumps({"packed_shapes": packed_rows, "stem": stem_rows,
                      "deploy_ms_per_batch": deploy_ms,
                      "deploy_sim_rel_mse": rel_mse,
                      "deploy_sim_top1_agreement": agree}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(f"total {time.perf_counter() - _T0:.2f} s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
