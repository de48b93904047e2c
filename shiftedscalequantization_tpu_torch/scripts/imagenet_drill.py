"""ImageNet-readiness drill on the port (the repository's
``imagenet_drill.py``, on PyTorch).

Shows that real ImageNet weights and images are a flag away, end to end,
with nothing downloaded: it writes (1) a BRECQ-release-format
``.pth.tar``, the flat state dict of ImageNet ResNet-18 (1000 classes)
with weights drawn with numpy (``utils/torch_import.random_state_dict``:
torch's BN affine init, running mean N(0, 0.2) and var U(0.5, 1.5)), and
(2) an ImageFolder of real JPEG files at ImageNet-like sizes, then runs the
port's CLI with ``--dataset imagenet --pretrained <pth.tar> --data_path
<folder>``, so the real-data code path runs: the state-dict import, the
JPEG loaders (the native C++ loader where libjpeg builds, else
``ImageFolderLoader``: PIL decode, resize 256, crop 224), calibration,
reconstruction, the act phase and the golden-logit file
(``utils/eval.golden_logit_mse``). A second ``--eval_only`` pass replays
the checkpoint against the golden logits (MSE must be ~0).

    python -m shiftedscalequantization_tpu_torch.scripts.imagenet_drill \\
        [--platform cuda|cpu] [--iters 600] [--quick] [--root DIR]

Writes ``--out`` (default torch_logs/imagenet_drill.json).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np

from .._device import resolve_device
from . import _common as C

N_CLASSES = 10
N_TRAIN_PER = 40
N_VAL_PER = 8


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    C.add_platform(ap)
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--iters_a", type=int, default=300)
    ap.add_argument("--num_samples", type=int, default=256)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--root", default=C.tmp_path("ssq_imagenet_drill_torch"))
    ap.add_argument("--out", default="torch_logs/imagenet_drill.json")
    args = ap.parse_args(argv)
    if args.quick:
        args.iters, args.iters_a, args.num_samples = 4, 4, 64
    return args


def make_pth_tar(path: str, seed=0) -> str:
    """BRECQ release format: the flat state_dict of ImageNet ResNet-18."""
    import torch
    from ..models import zoo
    from ..utils.torch_import import random_state_dict
    graph, km = zoo.build("resnet18", dataset="imagenet")
    sd = random_state_dict(graph, km(graph), seed, bn_gamma=(1.0, 1.0),
                           bn_beta_std=0.0, bn_mean_std=0.2,
                           bn_var=(0.5, 1.5))
    torch.save(sd, path)
    return path


def make_image_folder(root: str, seed=0) -> dict:
    """ImageNet-shaped ImageFolder: {root}/{train,val}/{class}/*.JPEG,
    real JPEG files (PIL-encoded) at ImageNet-like sizes so the val
    pipeline does true decode + resize-256 + center-crop-224 work."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    counts = {}
    for split, n_per in (("train", N_TRAIN_PER), ("val", N_VAL_PER)):
        for c in range(N_CLASSES):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d, exist_ok=True)
            for i in range(n_per):
                h = int(rng.integers(256, 460))
                w = int(rng.integers(256, 460))
                # class-correlated mean so labels aren't pure noise
                base = np.full((h, w, 3), 20 * c + 30, np.float32)
                img = np.clip(base + rng.normal(0, 40, (h, w, 3)), 0,
                              255).astype(np.uint8)
                Image.fromarray(img).save(
                    os.path.join(d, f"img_{i:04d}.JPEG"), quality=90)
            counts[f"{split}/{c}"] = n_per
    return counts


def main(argv=None) -> dict:
    """Returns the record written to --out."""
    args = parse_args(argv)
    resolve_device(args.platform)
    t0 = time.time()
    os.makedirs(args.root, exist_ok=True)
    pth = os.path.join(args.root, "resnet18_imagenet.pth.tar")
    if not os.path.exists(pth):
        make_pth_tar(pth)
    if not os.path.isdir(os.path.join(args.root, "val")):
        make_image_folder(args.root)
    golden_dir = os.path.join("torch_logs", "golden_imagenet")
    os.makedirs(golden_dir, exist_ok=True)
    golden = os.path.join(golden_dir, "result_2bit.npz")
    if os.path.exists(golden):
        # a previous run's file would make this run's golden comparison
        # (and the replay) measure run-to-run drift instead of replay
        # determinism
        os.remove(golden)

    argv = ["--dataset", "imagenet", "--arch", "resnet18",
            "--pretrained", pth, "--data_path", args.root,
            "--mode", "brecq", "--n_bits_w", "2", "--n_bits_a", "4",
            "--iters_w", str(args.iters), "--iters_a", str(args.iters_a),
            "--num_samples", str(args.num_samples), "--batch_size", "32",
            "--golden_dir", golden_dir,
            "--checkpoint_dir", "./checkPoint/imagenet_drill",
            "--log_path", C.tmp_path("imagenet_drill_torch.log"),
            ] + C.platform_flags(args)
    final, out, _ = C.run_cli(argv)
    wall = time.time() - t0
    loaders = re.search(r"data loaders: (.*)", out)

    # regression replay: eval_only against the golden file
    t1 = time.time()
    final2, replay_out, _ = C.run_cli(argv + ["--eval_only", "true"])
    m = re.search(r"golden-logit MSE: ([\deE.+-]+)", replay_out)
    golden_mse = float(m.group(1)) if m else None

    result = {
        "cmd": "python -m shiftedscalequantization_tpu_torch.scripts."
               "imagenet_drill --iters %d --iters_a %d --num_samples %d "
               "--platform %s" % (args.iters, args.iters_a, args.num_samples,
                                  args.platform),
        "checkpoint_format": "BRECQ .pth.tar (flat state_dict of ImageNet "
                             "ResNet-18, weights drawn with numpy)",
        "data_path": "ImageFolder JPEGs via data/imagenet_io.py "
                     "(real decode+resize+crop+normalize)",
        "data_loaders": loaders.group(1) if loaders else None,
        "final_top1": final["top1"] if isinstance(final, dict) else final,
        "eval_only_top1": final2["top1"] if isinstance(final2, dict)
        else final2,
        "golden_logit_mse_on_replay": golden_mse,
        "golden_artifact": golden,
        "wall_s": round(wall, 1), "replay_wall_s": round(time.time() - t1, 1),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
