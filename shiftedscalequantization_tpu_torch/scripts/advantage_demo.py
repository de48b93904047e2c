"""Shifted-scale advantage demo on the port: the regime the method exists
for (the repository's ``advantage_demo.py``, on PyTorch).

The method beats plain BRECQ by letting each (out-channel, input-channel)
pair pick a shifted weight-quant step (the reference's channelQuant.py
shiftTarget, e.g. {1/2, 1}). This script plants the failure mode it
targets, a per-INPUT-channel scale mismatch, without changing the FP
function, then runs the methods at an equal budget:

  for every BasicBlock's conv1 -> relu -> conv2 pair, split conv2's input
  channels into thirds and scale them by ``--scales`` (conv2.w[:, c] *= s),
  compensating exactly in conv1's BN affine (gamma[c] /= s, beta[c] /= s).
  ReLU is positive-homogeneous, so the FP function is unchanged up to
  rounding (checked), but conv2's per-OC step now faces input channels
  whose scales span 4x: at W2 the unscaled channels are crushed, and the
  candidates {1/4, 1/2, 1} repair exactly that.

The source is ``trained_resnet18_<dataset>.npz`` in the working directory;
the planted copy goes to ``torch_logs/``. Writes the JSON record to
``--out`` after each arm (``aggregate_advantage.py`` reads it).

    python -m shiftedscalequantization_tpu_torch.scripts.advantage_demo \\
        [--platform cuda|cpu] [--dataset digits|synth10] [--iters 2000] \\
        [--arms brecq,fused+beta,two_phase] [--quick]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shlex

import numpy as np
import torch

from .._device import resolve_device
from . import _common as C


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--iters_a", type=int, default=300)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--dataset", default="digits")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--scales", default="1,2,4",
                    help="per-third input-channel scale factors applied to "
                         "every block conv2 (compensated in conv1's BN)")
    ap.add_argument("--shift_targets", default="0.25,0.5,1.0",
                    help="candidate set for the fused run (1/scale of each "
                         "factor repairs that third exactly)")
    ap.add_argument("--out", default="torch_logs/advantage_demo.json")
    ap.add_argument("--arms", default="brecq,fused+beta,two_phase",
                    help="comma list of arms to run; available: brecq, "
                         "fused+beta, fused-nowarm, two_phase")
    ap.add_argument("--act_mode_fused", default="delta",
                    help="act phase for the fused arms (delta|shift|none)")
    ap.add_argument("--extra", default="",
                    help="extra cli flags appended to every arm "
                         "(shlex-split), e.g. '--act_mode shift "
                         "--act_shift_targets 1.0,0.25,0.0625'")
    ap.add_argument("--suffix", default="",
                    help="suffix for checkpoint/log paths so concurrent demo "
                         "invocations on the same config don't clobber each "
                         "other's per-layer checkpoints")
    C.add_platform(ap)
    ap.add_argument("--act_quant", default="true",
                    help="'false' runs every arm act-FP. Needed for harsh "
                         "imbalance: the transform compensates in conv1's "
                         "BN, so conv1's output activations span the full "
                         "planted ratio, which a per-tensor A4 grid cannot "
                         "hold")
    args = ap.parse_args(argv)
    if args.quick:
        args.iters, args.iters_a = 4, 4
    return args


def names(args) -> dict:
    """The scales, the tag and suffix of every path, the source npz and the
    planted copy."""
    scales = [float(s) for s in args.scales.split(",")]
    if len(scales) != 3:
        raise ValueError(f"--scales needs three factors: {args.scales}")
    tag = "x".join(f"{s:g}" for s in scales)
    # seed 7 keeps the suffix-free names
    sfx = ("" if args.seed == 7 else f"_s{args.seed}") + args.suffix
    return {"scales": scales, "tag": tag, "sfx": sfx,
            "src": f"trained_resnet18_{args.dataset}.npz",
            "dst": os.path.join(
                "torch_logs",
                f"trained_resnet18_{args.dataset}_imbalanced_{tag}{sfx}.npz")}


def make_imbalanced(src: str, dst: str, seed: int, scales) -> dict:
    """Per-IC rescale of every block conv2, compensated in conv1's BN."""
    d = dict(np.load(src))
    rng = np.random.RandomState(seed)
    report = {}
    for k in sorted(d):
        m = re.match(r"(model\.layer\d\.\d)\.conv2/w$", k)
        if not m:
            continue
        blk = m.group(1)
        w2 = d[k]                      # (OC, IC, KH, KW)
        ic = w2.shape[1]
        perm = rng.permutation(ic)
        s = np.full(ic, scales[0], np.float32)
        s[perm[: ic // 3]] = scales[1]
        s[perm[ic // 3: 2 * (ic // 3)]] = scales[2]
        d[k] = (w2 * s[None, :, None, None]).astype(w2.dtype)
        # conv1's BN affine is the last op before the relu feeding conv2
        for leaf in ("gamma", "beta"):
            kk = f"{blk}.conv1/bn/{leaf}"
            d[kk] = (d[kk] / s).astype(d[kk].dtype)
        report[blk] = {"ic": ic,
                       f"x{scales[1]:g}": int((s == scales[1]).sum()),
                       f"x{scales[2]:g}": int((s == scales[2]).sum()),
                       "scales": s.tolist()}
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    np.savez(dst, **d)
    return report


def fp_check(src: str, dst: str, dataset: str, device) -> float:
    """Max |FP logits of src - of dst| / max |FP logits of src| on 8
    seeded normal images: the transform must keep the FP function. The
    quantizers stay off, so their init is the cheapest (max)."""
    from ..graph import Flags, forward
    from ..models import zoo
    from ..quantize import QuantConfig, prepare_model
    from ..train import load_raw_params
    graph, _ = zoo.build("resnet18", dataset=dataset)
    cfg = QuantConfig(n_bits_w=8, n_bits_a=8, w_scale_method="max",
                      a_scale_method="max")
    x = torch.randn((8, 32, 32, 3), generator=torch.Generator()
                    .manual_seed(0)).to(device)
    outs = []
    for path in (src, dst):
        params, qstate = prepare_model(
            graph, load_raw_params(path, device=device), cfg, device=device)
        outs.append(forward(graph, params, qstate, x, Flags(),
                            device=device))
    return float((outs[0] - outs[1]).abs().max()
                 / (outs[0].abs().max() + 1e-9))


def arm_dir(args, nm, tag) -> str:
    return f"./checkPoint/adv_{args.dataset}_{nm['tag']}_{tag}{nm['sfx']}"


def run_cli(args, nm, tag, mode, extra) -> dict:
    argv = ["--dataset", args.dataset, "--arch", "resnet18",
            "--pretrained", nm["dst"], "--mode", mode,
            # max-init per-OC deltas for every arm: the shifted-scale
            # regime assumes a no-clipping base step that per-(oc, ic)
            # candidates then shrink; an MSE init on a bimodal channel
            # distribution lands mid-spread and clips the large channels
            "--w_scale_method", "max",
            "--n_bits_w", "2", "--n_bits_a", "4",
            "--iters_w", str(args.iters), "--iters_a", str(args.iters_a),
            "--num_samples", "256", "--batch_size", "64",
            "--act_quant", args.act_quant,
            "--seed", str(args.seed),
            "--checkpoint_dir", arm_dir(args, nm, tag),
            "--log_path", C.tmp_path(f"adv_{args.dataset}_{nm['tag']}_{tag}"
                                     f"{nm['sfx']}.log")
            ] + extra + C.platform_flags(args)
    final, out, wall = C.run_cli(argv)
    fp = re.findall(r"accuracy of FP model: \{'top1': ([\d.]+)", out)
    init = re.findall(r"accuracy of qnn \(with cal\.\): \{'top1': ([\d.]+)",
                      out)
    traj = re.findall(r"accuracy of qnn_hard (\S+): \{'top1': ([\d.]+)", out)
    ratios = re.findall(r"selection ratio (\S+): (\[.*\])", out)
    return {
        "tag": tag, "iters": args.iters,
        "fp_top1": float(fp[0]) if fp else None,
        "init_top1": float(init[0]) if init else None,
        "trajectory": [(n, float(a)) for n, a in traj],
        "final": final, "wall_s": round(wall, 1),
        "selection_ratios": {n: json.loads(r) for n, r in ratios},
    }


def selection_vs_planted(ckpt_dir, report, shift_targets) -> dict:
    """Does the hardened per-IC selection track the planted imbalance? The
    base per-OC delta is set by the largest channels (max init), so a
    channel scaled by s needs the candidate closest to s / max(s). Returns
    the match fraction per block."""
    from ..utils import checkpoint as ckpt
    sts = np.asarray([float(t) for t in shift_targets.split(",")])
    qs, _ = ckpt.load_qstate(f"{ckpt_dir}/QNN_W2_A4", device="cpu")
    out = {}
    for blk, info in report.items():
        uq = qs.get(f"{blk}.conv2")
        idx = getattr(getattr(uq, "wq", None), "st_index", None)
        if idx is None:
            continue
        idx = np.asarray(idx).reshape(-1)          # per-IC
        s = np.asarray(info["scales"])
        expect = np.argmin(np.abs(sts[None, :] - (s / s.max())[:, None]), 1)
        out[blk] = float((idx == expect).mean())
    return out


def arms(args) -> list:
    runs = [
        ("brecq", "brecq", []),
        # fused+beta with the coarse candidate set {1/4, 1/2, 1}; the CLI's
        # default --fused_warmstart 0.25 seeds the joint selection from a
        # short two-phase shift pre-solve
        ("fused+beta", "fused", ["--opt_beta", "true",
                                 "--act_mode", args.act_mode_fused,
                                 "--shift_targets", args.shift_targets]),
        # ablation: the joint path without the warm start
        ("fused-nowarm", "fused", ["--opt_beta", "true",
                                   "--act_mode", args.act_mode_fused,
                                   "--fused_warmstart", "0",
                                   "--shift_targets", args.shift_targets]),
        # the reference's two-phase stack (shift selection on full dequant
        # values -> bake -> AdaRound)
        ("two_phase", "two_phase", ["--shift_targets", args.shift_targets]),
    ]
    wanted = [a.strip() for a in args.arms.split(",") if a.strip()]
    runs = [r for r in runs if r[0] in wanted]
    extra = shlex.split(args.extra) if args.extra else []
    return [(tag, mode, ex + extra) for tag, mode, ex in runs]


def main(argv=None) -> dict:
    """Returns the record written to --out: {"imbalance", "fp_rel",
    "runs"}."""
    args = parse_args(argv)
    dev = resolve_device(args.platform)
    nm = names(args)
    report = make_imbalanced(nm["src"], nm["dst"], args.seed, nm["scales"])
    print("imbalance report:",
          json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "scales"}
                      for k, v in report.items()}))
    rel = fp_check(nm["src"], nm["dst"], args.dataset, dev)
    print(f"FP parity after transform: max rel diff {rel:.2e}")
    if not rel < 1e-4:
        raise AssertionError(f"FP function changed by the transform: {rel}")
    results = {"imbalance": report, "fp_rel": rel, "runs": []}
    for tag, mode, extra in arms(args):
        print(f"\n===== advantage demo: {tag} (iters={args.iters}) =====")
        res = run_cli(args, nm, tag, mode, extra)
        if mode in ("fused", "two_phase"):
            try:
                res["selection_vs_planted"] = selection_vs_planted(
                    arm_dir(args, nm, tag), report, args.shift_targets)
                print("selection matches planted imbalance:",
                      json.dumps(res["selection_vs_planted"]))
            except Exception as e:
                res["selection_vs_planted"] = f"error: {e}"
        print(json.dumps(
            {k: v for k, v in res.items() if k != "selection_ratios"},
            default=str))
        results["runs"].append(res)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
