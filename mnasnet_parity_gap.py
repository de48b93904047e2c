"""The JAX package's own deploy-vs-sim logit gap, plan and pair counts on
the states of ``chip_smoke.py``'s MNASNet serving phase (phase 31).

The port's phase gates deploy against sim at rel-MSE <= 1e-2. Part of
that gap belongs to the reference itself (half-up requant against the
sim's half-even rounding, chaotic on random weights), so this script
measures the JAX package's gap on the same recipe, on the CPU: ImageNet
MNASNet (scale 2.0) with He-normal weights from ``default_rng(0)`` in
unit order and identity BN (``chip_smoke.host_params``), 16 calibration
images from ``default_rng(1)``, the first ``--images`` of the 256 parity
images from ``default_rng(2)``; W2A4 with MSE scales (8-bit stem and
head), in two states: plain, and harmonized
(``quantize.harmonize_residual_chains``). For each it gives the plan's
kinds at 224x224 under the JAX package's defaults and under
``SSQ_DW_KERNEL=1 SSQ_PACKED=1`` (the card's serving switches), the
pairs formed and consumed in one deploy forward (``pair_stats``), and
the sim forward (all quantizers on) against ``deploy_forward`` under the
defaults, both under jit. The chip computes its state on the card from
the same draws; MSE searches in another float order may land a step
apart, so this is the reference's gap on the recipe, not on the card's
bits. The JAX package's packed kernel re-quantizes its input with the
feeding site's zero point and bits, which clips a harmonized chain's
``__sum__`` codes, so the gap is taken at its defaults.

Usage: python mnasnet_parity_gap.py [--images 32]
Prints one JSON line: {state: {"rel_mse": ..., "plan_kinds": ..., ...}}.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from regnet_parity_gap import host_images, host_params  # noqa: E402

HW = 224
# the JAX deploy module's switches, cleared so that it runs at its
# defaults but for the recipe's own
SWITCHES = ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
            "SSQ_DW_KERNEL", "SSQ_PAIR_TRANSPORT", "SSQ_PAIR_TERMS",
            "SSQ_THIN_CHANNELS", "SSQ_THIN_MINHW", "SSQ_FLOAT_1PASS")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=32,
                    help="parity images (the first of the card's 256)")
    a = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    for k in SWITCHES:
        os.environ.pop(k, None)
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    import shiftedscalequantization_tpu as ssq
    from shiftedscalequantization_tpu import deploy as JD
    from shiftedscalequantization_tpu.graph import iter_units
    from shiftedscalequantization_tpu.models import zoo
    from shiftedscalequantization_tpu.quantize import act_flags, \
        harmonize_residual_chains

    def kinds_of(plan):
        kinds = [v[0] for k, v in plan.items() if not k.startswith("__")]
        return {k: kinds.count(k) for k in sorted(set(kinds))}

    t = time.time()
    cal = jnp.asarray(host_images(16, 1))
    x = jnp.asarray(host_images(256, 2)[:a.images])
    g, _ = zoo.build("mnasnet")
    raw = jax.tree.map(jnp.asarray, host_params(list(iter_units(g))))
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4)
    params, qs = ssq.prepare_model(g, raw, cfg)
    qs = ssq.calibrate_acts(g, params, qs, cal, cfg)
    qs_h, ratios = harmonize_residual_chains(g, qs)
    dp = JD.build_deploy_params(g, params, qs)
    flags = act_flags(g, cfg, base=ssq.Flags().all_weights(g))
    out = {}
    for name, q in (("plain", qs), ("harmonized", qs_h)):
        steps = JD.act_steps_from_qstate(g, q)
        os.environ.update(SSQ_DW_KERNEL="1", SSQ_PACKED="1")
        serving = kinds_of(JD.make_deploy_plan(g, dp, steps,
                                               input_hw=(HW, HW)))
        for k in SWITCHES:
            os.environ.pop(k, None)
        plan = JD.make_deploy_plan(g, dp, steps, input_hw=(HW, HW))
        sim = np.asarray(jax.jit(
            lambda x: ssq.forward(g, params, q, x, flags))(x), np.float64)
        dep = np.asarray(jax.jit(lambda x: JD.deploy_forward(
            g, dp, steps, x, plan=plan))(x), np.float64)
        out[name] = dict(
            rel_mse=float(((dep - sim) ** 2).mean() / (sim ** 2).mean()),
            top1_agreement=float((dep.argmax(-1) == sim.argmax(-1)).mean()),
            finite=bool(np.isfinite(dep).all() and np.isfinite(sim).all()),
            images=int(x.shape[0]), plan_kinds=kinds_of(plan),
            serving_plan_kinds=serving, pair_stats=dict(JD.pair_stats),
            sum_sites=len(plan["__sum_steps__"]),
            harmonized_sites=len(ratios) if name == "harmonized" else 0)
        print(f"mnasnet {name}: {out[name]} ({time.time() - t:.1f} s)",
              file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
