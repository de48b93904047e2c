"""End-to-end accuracy harness on the port: trained weights through the
port's CLI in each mode and bit width of RUNS, then the true-integer deploy
of the recovered brecq W2A4 state in both stem modes (the repository's
``run_accuracy.py``, on PyTorch).

Each run prints the FP -> quant-init -> per-target -> final top-1
trajectory (the reference's ShiftedScaleQuant.py:274-276). The weights are
``trained_<arch>_<dataset>.npz`` in the working directory, trained with the
port's trainer when missing. The deploy rows: the exact 2-pass stem
(``SSQ_STEM_1PASS=0``) and the 1-pass stem (``=1``, the serving default),
beside the sim top-1 of the same state. Writes the markdown table to
``--out``; ``--quick`` runs the first of RUNS at 4 steps and writes
nothing.

    python -m shiftedscalequantization_tpu_torch.scripts.run_accuracy \\
        [--platform cuda|cpu] [--iters N] [--iters_a N] [--quick] \\
        [--only synth10:brecq:W2A4,...] [--arch resnet18] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import re

from .._device import resolve_device
from . import _common as C

RUNS = [
    # (tag, dataset, mode, n_bits_w, n_bits_a, extra_flags)
    ("fused", "synth10", "fused", 2, 4, []),
    # learned rounding inside the fused reconstruction, with the act-delta
    # phase
    ("fused+beta", "synth10", "fused", 2, 4,
     ["--opt_beta", "true", "--act_mode", "delta"]),
    ("fused", "synth10", "fused", 4, 4, []),
    ("brecq", "synth10", "brecq", 2, 4, []),
    ("brecq", "digits", "brecq", 2, 4, []),
    # the bit-width sweep on the real-image dataset at a fixed budget
    ("brecq", "digits", "brecq", 3, 4, []),
    ("brecq", "digits", "brecq", 4, 4, []),
    ("fused+beta", "digits", "fused", 2, 4,
     ["--opt_beta", "true", "--act_mode", "delta"]),
]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    C.add_platform(ap)
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--iters_a", type=int, default=300)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma list of dataset:mode:WxAy filters, e.g. "
                         "'synth10:fused:W2A4,digits:fused:W2A4'")
    ap.add_argument("--out", default="torch_logs/ACCURACY.md")
    ap.add_argument("--arch", default="resnet18",
                    help="any zoo arch with a cifar/small variant "
                         "(resnet18/34/50/...)")
    args = ap.parse_args(argv)
    if args.quick:
        args.iters, args.iters_a = 4, 4
    return args


def trained_npz(args, dataset: str) -> str:
    return f"trained_{args.arch}_{dataset}.npz"


def checkpoint_dir(args, dataset: str, tag: str) -> str:
    if args.arch != "resnet18":
        return f"./checkPoint/acc_{dataset}_{args.arch}_{tag}"
    return f"./checkPoint/acc_{dataset}_{tag}"


def ensure_trained(args, dataset: str) -> str:
    path = trained_npz(args, dataset)
    if not os.path.exists(path):
        from ..train import main as train_main
        steps = "200" if args.quick else "4000"
        print(f"[train] {dataset}: {steps} steps on-device")
        train_main(["--arch", args.arch, "--dataset", dataset,
                    "--steps", steps, "--batch_size", "128",
                    "--out", path] + C.platform_flags(args))
    return path


def select_runs(args) -> list:
    runs = RUNS[:1] if args.quick else list(RUNS)
    if args.only:
        keys = set(args.only.split(","))
        runs = [r for r in runs if f"{r[1]}:{r[0]}:W{r[3]}A{r[4]}" in keys]
    return runs


def run_one(args, tag, dataset, mode, nbw, nba, extra) -> dict:
    ck = ensure_trained(args, dataset)
    argv = ["--dataset", dataset, "--arch", args.arch,
            "--pretrained", ck, "--mode", mode,
            "--n_bits_w", str(nbw), "--n_bits_a", str(nba),
            "--iters_w", str(args.iters), "--iters_a", str(args.iters_a),
            "--num_samples", "256", "--batch_size", "64",
            "--checkpoint_dir", checkpoint_dir(args, dataset, tag),
            "--log_path", C.tmp_path(f"acc_{dataset}_{tag}_W{nbw}A{nba}.log"),
            ] + extra + C.platform_flags(args)
    final, out, wall = C.run_cli(argv)
    fp = re.findall(r"accuracy of FP model: \{'top1': ([\d.]+)", out)
    init = re.findall(r"accuracy of qnn \(with cal\.\): \{'top1': ([\d.]+)",
                      out)
    traj = re.findall(r"accuracy of qnn_hard (\S+): \{'top1': ([\d.]+)", out)
    return {
        "dataset": dataset, "mode": tag, "bits": f"W{nbw}A{nba}",
        "fp_top1": float(fp[0]) if fp else None,
        "init_top1": float(init[0]) if init else None,
        "trajectory": [(n, float(a)) for n, a in traj],
        "final": final, "wall_s": round(wall, 1),
    }


def deploy_eval(args, dataset, nbw, nba, tag) -> dict:
    """Top-1 of the true-int deploy path on the hardened state, for both
    stem modes (the exact 2-pass split and the 1-pass serving default),
    beside the sim top-1. The environment is restored afterwards."""
    from .. import deploy
    from ..data import realdata
    dev = resolve_device(args.platform)
    graph, sim, dparams, steps = C.served_state(
        args.arch, dataset, trained_npz(args, dataset),
        f"{checkpoint_dir(args, dataset, tag)}/QNN_W{nbw}_A{nba}", nbw, nba,
        dev)
    if dataset == "digits":
        _, _, x_te, y_te = realdata.digits_arrays()
    else:
        x_te, y_te = realdata.synth10_test_arrays()
    accs = {"sim": C.top1(sim, x_te, y_te, dev)}
    saved = os.environ.get("SSQ_STEM_1PASS")
    try:
        for mode_env in ("0", "1"):
            os.environ["SSQ_STEM_1PASS"] = mode_env
            plan = deploy.make_deploy_plan(graph, dparams, steps,
                                           input_hw=(32, 32))
            accs["deploy_2pass" if mode_env == "0" else "deploy_1pass"] = \
                C.top1(lambda x, p=plan: deploy.deploy_forward(
                    graph, dparams, steps, x, plan=p, device=dev),
                    x_te, y_te, dev)
    finally:
        if saved is None:
            os.environ.pop("SSQ_STEM_1PASS", None)
        else:
            os.environ["SSQ_STEM_1PASS"] = saved
    return accs


def write_table(args, results, dep):
    lines = [
        "# Accuracy: trained weights through the full PTQ pipeline",
        "",
        f"{args.arch} (CIFAR variant) trained on-device (train.py), then the",
        f"full shifted-scale pipeline (cli.py). iters_w={args.iters},",
        f"iters_a={args.iters_a}, 256 calibration samples, "
        f"platform={args.platform}.",
        "Reference story being mirrored: FP -> quant-init -> per-layer recon",
        "trajectory -> final (ShiftedScaleQuant.py:263-278, README.md:20-27).",
        "",
        "| dataset | mode | bits | FP top-1 | quant-init | final | recovery |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in results:
        fin = r["final"]["top1"] if isinstance(r["final"], dict) \
            else r["final"]
        rec = (None if r["init_top1"] is None
               else round(fin - r["init_top1"], 2))
        lines.append(
            f"| {r['dataset']} | {r['mode']} | {r['bits']} | {r['fp_top1']} | "
            f"{r['init_top1']} | {fin} | +{rec} |")
    lines += ["", "Per-layer trajectory (headline run, top-1 after hardening "
              "each node):", ""]
    for r in results:
        if r["trajectory"]:
            lines.append(f"- **{r['dataset']} {r['mode']} {r['bits']}**: " +
                         " -> ".join(f"{n.split('.')[-2]}.{n.split('.')[-1]} "
                                     f"{a}" for n, a in r["trajectory"]))
    if dep:
        lines += ["", "## True-int deploy parity on the hardened W2A4 state",
                  "",
                  f"sim {dep['sim']}% | deploy exact 2-pass stem "
                  f"{dep['deploy_2pass']}% | deploy 1-pass stem (serving "
                  f"default) {dep['deploy_1pass']}%", ""]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None) -> dict:
    """Returns {"runs": [one record per run], "deploy": deploy_eval's
    top-1s or None}."""
    args = parse_args(argv)
    resolve_device(args.platform)
    results = []
    for r in select_runs(args):
        print(f"\n===== {r} =====")
        res = run_one(args, *r)
        print(json.dumps(res, default=str))
        results.append(res)
    if args.quick:
        print("QUICK OK")
        return {"runs": results, "deploy": None}
    # the true-int deploy on the RECOVERED brecq W2A4 state
    dep = deploy_eval(args, "synth10", 2, 4, "brecq")
    print("deploy eval (brecq W2A4):", dep)
    write_table(args, results, dep)
    print(f"wrote {args.out}")
    return {"runs": results, "deploy": dep}


if __name__ == "__main__":
    main()
