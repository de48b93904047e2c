"""Harmonization accuracy on a trained MNASNet (CIFAR variant), on the
port (the repository's ``harm_accuracy.py``, on PyTorch).

Residual-chain act-step harmonization (``--harmonize_residual``) gives
every siteless residual chain one act step, so its sums run as int8 code
adds, at the price of coarser member grids. This measures the top-1 cost
on trained weights: the full pipeline (quant-init -> calibrate ->
[harmonize] -> per-unit brecq reconstruction -> act phase) without and
with harmonization, then sim against the true-integer deploy on each final
state, with the number of chain sum sites its deploy plan forms.

The weights are ``trained_mnasnet_synth10.npz`` in the working directory,
trained with the port's trainer when missing.

    python -m shiftedscalequantization_tpu_torch.scripts.harm_accuracy \\
        [--platform cuda|cpu] [--iters 600] [--iters_a 300]

Writes ``--out`` (default torch_logs/harm_accuracy.json).
"""
from __future__ import annotations

import argparse
import json
import os
import re

from .._device import resolve_device
from . import _common as C

CKPT = "trained_mnasnet_synth10.npz"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--iters_a", type=int, default=300)
    C.add_platform(ap)
    ap.add_argument("--out", default="torch_logs/harm_accuracy.json")
    return ap.parse_args(argv)


def ensure_trained(args):
    if not os.path.exists(CKPT):
        from ..train import main as train_main
        print("[train] mnasnet synth10: 3000 steps on-device", flush=True)
        train_main(["--arch", "mnasnet", "--dataset", "synth10",
                    "--steps", "3000", "--batch_size", "128", "--out", CKPT]
                   + C.platform_flags(args))


def run_cli(args, tag, harmonize) -> dict:
    argv = ["--dataset", "synth10", "--arch", "mnasnet",
            "--pretrained", CKPT, "--mode", "brecq",
            "--n_bits_w", "2", "--n_bits_a", "4",
            "--iters_w", str(args.iters), "--iters_a", str(args.iters_a),
            "--num_samples", "256", "--batch_size", "64",
            "--harmonize_residual", "true" if harmonize else "false",
            # the per-unit trajectory evals would be most of the wall
            # time on MNASNet's 52 targets
            "--skip_test", "true",
            "--checkpoint_dir", f"./checkPoint/harm_{tag}",
            "--log_path", C.tmp_path(f"harm_{tag}_torch.log"),
            ] + C.platform_flags(args)
    final, out, wall = C.run_cli(argv)
    coars = re.findall(r"worst step coarsening ([\d.]+)x", out)
    return {"tag": tag, "final": final,
            "worst_coarsening": float(coars[0]) if coars else None,
            "wall_s": round(wall, 1)}


def deploy_check(args, tag, harmonize) -> dict:
    """sim vs true-int deploy top-1 on the recovered state, and the chain
    sum sites of its deploy plan."""
    from .. import deploy
    from ..data import realdata
    dev = resolve_device(args.platform)
    graph, sim, dparams, steps = C.served_state(
        "mnasnet", "synth10", CKPT, f"./checkPoint/harm_{tag}/QNN_W2_A4", 2,
        4, dev)
    plan = deploy.make_deploy_plan(graph, dparams, steps, input_hw=(32, 32))
    x_te, y_te = realdata.synth10_test_arrays()
    return {"sim": C.top1(sim, x_te, y_te, dev),
            "deploy": C.top1(lambda x: deploy.deploy_forward(
                graph, dparams, steps, x, plan, device=dev), x_te, y_te, dev),
            "sum_sites": len(plan.get("__sum_steps__", {}))}


def main(argv=None) -> dict:
    """Returns the record written to --out: {"plain": ..., "harmonized":
    ...}, each with its deploy_check."""
    args = parse_args(argv)
    resolve_device(args.platform)
    ensure_trained(args)
    results = {}
    for tag, harm in (("plain", False), ("harmonized", True)):
        print(f"\n===== harm_accuracy: {tag} =====", flush=True)
        results[tag] = run_cli(args, tag, harm)
        results[tag]["deploy_check"] = deploy_check(args, tag, harm)
        print(json.dumps(results[tag], default=str), flush=True)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
