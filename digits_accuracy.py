#!/usr/bin/env python3
"""Digits ResNet-18 W2A4 accuracy of one package's CLI, on the CPU.

Runs ``cli.main`` of the JAX package (``--package jax``) or of the
PyTorch port (``--package torch``) on sklearn's digits from the tracked
trained weights, with the JAX package's native loader off so both
packages take the same calibration rows. Flags after ``--`` are appended
to the defaults below (a later flag wins):

    python3 digits_accuracy.py --package torch -- --mode fused --bias_cal true
    python3 digits_accuracy.py --package jax -- --mode brecq

The CLI's own lines are printed as they come; the last line is one JSON
object with the package, the flags, the final accuracy and the wall
seconds of the run.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULTS = ["--dataset", "digits", "--arch", "resnet18",
            "--pretrained", os.path.join(ROOT, "trained_resnet18_digits.npz"),
            "--n_bits_w", "2", "--n_bits_a", "4", "--iters_w", "2000",
            "--iters_a", "300", "--num_samples", "256", "--batch_size", "64",
            "--platform", "cpu"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=["jax", "torch"], required=True)
    ap.add_argument("flags", nargs=argparse.REMAINDER)
    a = ap.parse_args()
    extra = a.flags[1:] if a.flags[:1] == ["--"] else a.flags
    sys.path.insert(0, ROOT)
    if a.package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        from shiftedscalequantization_tpu import cli
        from shiftedscalequantization_tpu.data import native_loader
        native_loader.native_available = lambda: False
    else:
        from shiftedscalequantization_tpu_torch import cli
    with tempfile.TemporaryDirectory() as tmp:
        argv = DEFAULTS + extra + ["--checkpoint_dir", tmp,
                                   "--log_path", os.path.join(tmp, "run.log")]
        t0 = time.perf_counter()
        final = cli.main(argv)
        wall = time.perf_counter() - t0
    print(json.dumps({"package": a.package, "flags": DEFAULTS[:-2] + extra,
                      "final": final, "wall_s": wall}), flush=True)


if __name__ == "__main__":
    main()
