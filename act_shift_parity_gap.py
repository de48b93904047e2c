"""The JAX package's own deploy-vs-sim logit gap on an act-shift state of
``chip_smoke.py``'s phase 29 recipe.

Phase 29 serves the state the port's CLI leaves after ``--mode fused
--act_quant true --act_mode shift`` on ImageNet ResNet-18 W2A4 (224x224,
synthetic data, random init) and gates deploy against sim. Every
act-shift site has a per-channel step, so deploy carries it as an f32
edge and requantizes with half-up rounding where the sim rounds half to
even: part of the gap belongs to the reference. This script measures the
JAX package's gap on the same recipe at a small size, on the CPU: the JAX
CLI with the phase's flags (fewer calibration rows and steps), then its
final checkpoint's sim forward (every act site on) against
``deploy_forward`` (the plan under the JAX package's defaults) on the
first ``--images`` of the CLI's test images, both under jit.

Usage: python act_shift_parity_gap.py [--images 32] [--num_samples 64]
       [--iters 20]
Prints one JSON line: {"rel_mse": ..., "top1_agreement": ..., ...}.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CLI_COMMON = ["--arch", "resnet18", "--dataset", "imagenet",
              "--synthetic_data", "true", "--n_bits_w", "2", "--n_bits_a",
              "4", "--mode", "fused", "--act_quant", "true", "--act_mode",
              "shift", "--act_shift_targets", "1.0,0.5", "--skip_test",
              "true", "--test_before_calibration", "false"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=32,
                    help="test images compared")
    ap.add_argument("--num_samples", type=int, default=64,
                    help="calibration rows of the CLI run")
    ap.add_argument("--iters", type=int, default=20,
                    help="steps a target, weight and act phases")
    a = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    for k in ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
              "SSQ_DW_KERNEL"):
        os.environ.pop(k, None)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import shiftedscalequantization_tpu as ssq
    from shiftedscalequantization_tpu import cli
    from shiftedscalequantization_tpu import deploy as JD
    from shiftedscalequantization_tpu.ops.act_quant import ActShiftQuant
    from shiftedscalequantization_tpu.quantize import act_flags
    from shiftedscalequantization_tpu.utils import checkpoint as ck
    from shiftedscalequantization_tpu.utils.config import load_args

    t = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        argv = CLI_COMMON + [
            "--num_samples", str(a.num_samples), "--iters_w", str(a.iters),
            "--iters_a", str(a.iters), "--checkpoint_dir", tmp,
            "--log_path", os.path.join(tmp, "run.log")]
        stdout = sys.stdout
        sys.stdout = sys.stderr          # the CLI's lines
        try:
            cli.main(argv)
        finally:
            sys.stdout = stdout
        qs, done = ck.load_qstate(os.path.join(tmp, "QNN_W2_A4"))
    cli_s = time.time() - t
    args = load_args(argv)
    graph, raw, cfg = cli.build_everything(args)
    params, _ = ssq.prepare_model(graph, raw, cfg)
    _, test = cli.build_data(args)
    x = jnp.asarray(np.concatenate([b for b, _ in test])[:a.images])
    flags = act_flags(graph, cfg, base=ssq.Flags().all_weights(graph))
    sites = [k for k, v in qs.items() if isinstance(
        getattr(v, "aq", v), ActShiftQuant)]
    sim = np.asarray(jax.jit(
        lambda x: ssq.forward(graph, params, qs, x, flags))(x), np.float64)
    dp = JD.build_deploy_params(graph, params, qs)
    steps = JD.act_steps_from_qstate(graph, qs)
    plan = JD.make_deploy_plan(graph, dp, steps, input_hw=(224, 224))
    dep = np.asarray(jax.jit(lambda x: JD.deploy_forward(
        graph, dp, steps, x, plan=plan))(x), np.float64)
    kinds = [v[0] for k, v in plan.items() if not k.startswith("__")]
    out = dict(
        rel_mse=float(((dep - sim) ** 2).mean() / (sim ** 2).mean()),
        top1_agreement=float((dep.argmax(-1) == sim.argmax(-1)).mean()),
        finite=bool(np.isfinite(dep).all() and np.isfinite(sim).all()),
        images=int(x.shape[0]), act_shift_sites=len(sites),
        targets_done=len(done), num_samples=a.num_samples, iters=a.iters,
        plan_kinds={k: kinds.count(k) for k in sorted(set(kinds))},
        cli_s=cli_s, total_s=time.time() - t)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
