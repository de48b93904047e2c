#!/usr/bin/env python3
"""Where the PyTorch port's integer deploy forward spends its time on the
card: an ImageNet model at W2A4, batch 256, 224x224, the state
chip_smoke.py builds.

    python3 profile_torch_deploy.py
        [--arch resnet18|mobilenetv2|regnetx_600m|mnasnet] [--shifted]
        [--harmonized]

``--shifted`` (ResNet-18, RegNetX-600M) serves the model quantized by
the method's fused shifted-scale quantizers, hardened to the baked
scale-table form, as chip_smoke.py's method path does. RegNetX-600M and
MNASNet take chip_smoke.py's numpy-drawn weights and calibration images
(MNASNet in its plain state, as chip_smoke.py's phase 31 builds it, or
with ``--harmonized`` in its harmonized state: the residual chains'
act sites re-stepped by ``quantize.harmonize_residual_chains``).

Prints, for the card named by nvidia-smi (name, power limit):
- ms/batch (CUDA events) of the deploy forward under three plans, timed in
  turns A B C C B A. ResNet-18: 'serving' (SSQ_STEM_KERNEL=1
  SSQ_PACKED=1), 'no kernels' (the JAX package's default plan: 1-pass
  float stem, int8 1x1 downsample) and 'exact stem' (SSQ_STEM_1PASS=0, no
  kernels). MobileNetV2: 'serving' (SSQ_DW_KERNEL=1 SSQ_PACKED=1), 'dw
  only' (SSQ_DW_KERNEL=1) and 'no kernels' (the default plan: depthwise
  units on the plain integer route, 1x1 convs on the integer GEMM or the
  integer route). RegNetX-600M: 'serving' (the JAX package's defaults:
  float_1p stem, int8_bd, grouped units on the grouped kernel) and
  'packed' (SSQ_PACKED=1). MNASNet: 'serving' (SSQ_DW_KERNEL=1
  SSQ_PACKED=1: its 5x5 and stem-fed depthwise units on dw_conv_int8).
  And the port's float forward in bf16 (no
  quantizers),
  the JAX bench's baseline;
- the host's time to issue one serving forward (wall clock of the
  deploy_forward call, the card synchronised before and after each, so
  it includes any wait the call makes on the card): where it is close to
  the serving ms/batch, the host, not the card, sets the pace;
- device time of one serving forward by kernel (torch.profiler), grouped
  into the port's kernels, integer GEMMs, copies (im2col and layout),
  and elementwise work (epilogues, requant), and the top 15
  kernels by name. Writes the full table to chiprun_out/.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import chip_smoke

PLANS = {
    "resnet18": {
        "serving": {"SSQ_STEM_KERNEL": "1", "SSQ_PACKED": "1",
                    "SSQ_STEM_1PASS": "0"},
        "no kernels": {"SSQ_STEM_KERNEL": "0", "SSQ_PACKED": "0",
                       "SSQ_STEM_1PASS": "1"},
        "exact stem": {"SSQ_STEM_KERNEL": "0", "SSQ_PACKED": "0",
                       "SSQ_STEM_1PASS": "0"}},
    "mobilenetv2": {
        "serving": {"SSQ_DW_KERNEL": "1", "SSQ_PACKED": "1",
                    "SSQ_STEM_1PASS": "1"},
        "dw only": {"SSQ_DW_KERNEL": "1", "SSQ_PACKED": "0",
                    "SSQ_STEM_1PASS": "1"},
        "no kernels": {"SSQ_DW_KERNEL": "0", "SSQ_PACKED": "0",
                       "SSQ_STEM_1PASS": "1"}},
    "regnetx_600m": {
        "serving": {"SSQ_STEM_KERNEL": "0", "SSQ_PACKED": "0",
                    "SSQ_DW_KERNEL": "0", "SSQ_STEM_1PASS": "1"},
        "packed": {"SSQ_STEM_KERNEL": "0", "SSQ_PACKED": "1",
                   "SSQ_DW_KERNEL": "0", "SSQ_STEM_1PASS": "1"}},
    "mnasnet": {
        "serving": {"SSQ_STEM_KERNEL": "0", "SSQ_DW_KERNEL": "1",
                    "SSQ_PACKED": "1", "SSQ_STEM_1PASS": "1"}}}
GROUPS = (("int8_conv kernel", ("igemm_kernel",)),
          ("stem kernel", ("stem_fused_kernel",)),
          ("packed kernel", ("packed_qmm_kernel",)),
          ("dw kernel", ("dw_conv3x3_kernel",)),
          ("dw_conv_int8 kernel", ("dw_conv_int8_kernel",)),
          ("group conv kernel", ("group_conv_kernel",)),
          ("integer GEMM", ("gemm", "igemm", "cutlass", "xmma", "imma")),
          ("copies", ("copy", "cat", "Cat", "stack")),
          ("elementwise", ("elementwise", "vectorized", "reduce",
                           "Reduce", "pool")))


def group_of(name):
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(PLANS), default="resnet18")
    ap.add_argument("--shifted", action="store_true",
                    help="ResNet-18 or RegNetX-600M quantized by the "
                    "method (baked state)")
    ap.add_argument("--harmonized", action="store_true",
                    help="MNASNet in its harmonized state")
    args = ap.parse_args()
    if args.shifted and args.arch in ("mobilenetv2", "mnasnet"):
        ap.error("--shifted serves ResNet-18 and RegNetX-600M only")
    if args.harmonized and args.arch != "mnasnet":
        ap.error("--harmonized serves MNASNet only")
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_deploy: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from shiftedscalequantization_tpu_torch import deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, forward

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    graph, _, params, qstate, dparams, steps = \
        chip_smoke.serving_setup(torch, gen, args.arch,
                                 shifted=args.shifted,
                                 host=args.arch in ("regnetx_600m",
                                                    "mnasnet"))
    if args.harmonized:
        qstate, _ = Q.harmonize_residual_chains(graph, qstate)
        steps = deploy.act_steps_from_qstate(graph, qstate)
    plan_envs = PLANS[args.arch]
    x = torch.randn((chip_smoke.BATCH, chip_smoke.HW, chip_smoke.HW, 3),
                    generator=gen, device="cuda")
    plans = {}
    for name, env in plan_envs.items():
        os.environ.update(env)
        plans[name] = deploy.make_deploy_plan(
            graph, dparams, steps, input_hw=(chip_smoke.HW,) * 2)

    def fwd(name):
        return lambda: deploy.deploy_forward(graph, dparams, steps, x,
                                             plan=plans[name], device="cuda")

    times = {name: [] for name in plan_envs}
    for name in list(plan_envs) + list(plan_envs)[::-1]:
        times[name].append(chip_smoke.time_cuda(fwd(name), iters=10,
                                                warmup=2))
    params_bf16 = {u: {k: v.to(torch.bfloat16) for k, v in p.items()}
                   for u, p in params.items()}
    xb = x.to(torch.bfloat16)
    bf16_ms = chip_smoke.time_cuda(
        lambda: forward(graph, params_bf16, qstate, xb, Flags(),
                        device="cuda"), iters=10, warmup=2)

    host_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd("serving")()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    host_ms = sum(host_ms[2:]) / len(host_ms[2:])

    from torch.profiler import ProfilerActivity, profile
    fwd("serving")()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd("serving")()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.device_time_total for e in events)
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    groups = {}
    for e in events:
        g = group_of(e.key)
        groups[g] = groups.get(g, 0.0) + e.device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:15]

    print(smi)
    label = args.arch + (" (shifted)" if args.shifted else "") \
        + (" (harmonized)" if args.harmonized else "")
    print(f"{label}: plan kinds {{name: kind counts}}:")
    for name, plan in plans.items():
        kinds = [v[0] for k, v in plan.items() if not k.startswith("__")]
        print(f"  {name:11s} "
              f"{ {k: kinds.count(k) for k in sorted(set(kinds))} }")
    print(f"deploy forward, batch {chip_smoke.BATCH}, ms/batch in turns "
          f"A B C C B A:")
    for name, ts in times.items():
        print(f"  {name:11s} {' '.join(f'{t:.3f}' for t in ts)}")
    print(f"  bf16 float forward {bf16_ms:.3f}")
    print(f"host time to issue one serving forward: {host_ms:.3f} ms")
    print(f"device time of one serving forward: {total_us / 1e3:.3f} ms")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:14s} {ms:8.3f} ms  {100 * ms * 1e3 / total_us:5.1f}%")
    for e in top:
        print(f"  {e.device_time_total / 1e3:8.3f} ms  {e.count:4d}x  "
              f"{e.key[:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    out = "chiprun_out/profile_torch_deploy_" + label.replace(
        " (shifted)", "_shifted").replace(" (harmonized)", "_harmonized") \
        + ".txt"
    with open(out, "w") as f:
        f.write(f"{smi}; {label}\n")
        f.write(prof.key_averages().table(sort_by="device_time_total",
                                          row_limit=60))
    print(json.dumps({"device": smi, "arch": label, "deploy_ms": times,
                      "bf16_forward_ms": bf16_ms,
                      "serving_host_issue_ms": host_ms,
                      "serving_device_ms": total_us / 1e3,
                      "groups_ms": groups}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
