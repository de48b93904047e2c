"""The JAX package's own deploy-vs-sim logit gap on the states of
``chip_smoke.py``'s RegNetX-600M and ResNet-18 W4A8 serving phases.

The port's phases gate deploy against sim at rel-MSE <= 1e-2. Part of
that gap belongs to the reference itself (half-up requant against the
sim's half-even rounding, chaotic on random weights), so this script
measures the JAX package's gap on the same recipe, on the CPU: the
weights, calibration images and parity images are drawn with numpy by
the recipe ``chip_smoke.py`` uses (``host_params`` / ``host_images``:
He-normal weights from ``default_rng(0)`` in unit order, identity BN;
16 calibration images from ``default_rng(1)``; the first ``--images`` of
the 256 parity images from ``default_rng(2)``), then W2A4 (W4A8 for
ResNet-18) with MSE scales, the baked state by the fused quantizers
(targets {1/2, 1}) hardened without reconstruction, the plan under the
JAX package's defaults at 224x224, and the sim forward (all quantizers
on) against ``deploy_forward``, both under jit. The chip computes its
state on the card from the same draws; MSE searches in another float
order may land a step apart, so this is the reference's gap on the
recipe, not on the card's bits.

Usage: python regnet_parity_gap.py [--images 32]
Prints one JSON line: {state: {"rel_mse": ..., "top1_agreement": ...}}.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HW = 224


def host_params(units, seed=0):
    """He-normal weights drawn in unit order from default_rng(seed),
    identity BN, zero linear bias (chip_smoke.host_params)."""
    rng = np.random.default_rng(seed)
    out = {}
    for u in units:
        shape = (u.out_ch, u.in_ch // u.groups, *u.kernel) \
            if u.kind == "conv" else (u.out_ch, u.in_ch)
        fan_in = int(np.prod(shape[1:]))
        w = rng.standard_normal(shape, dtype=np.float32) \
            * np.float32(np.sqrt(2.0 / fan_in))
        p = {"w": w}
        if u.has_bn:
            c = u.out_ch
            p["bn"] = {"gamma": np.ones(c, np.float32),
                       "beta": np.zeros(c, np.float32),
                       "mean": np.zeros(c, np.float32),
                       "var": np.ones(c, np.float32)}
        else:
            p["b"] = np.zeros(u.out_ch, np.float32)
        out[u.name] = p
    return out


def host_images(n, seed):
    """n standard-normal 224x224 NHWC images from default_rng(seed)
    (chip_smoke.host_images)."""
    return np.random.default_rng(seed).standard_normal(
        (n, HW, HW, 3), dtype=np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=32,
                    help="parity images (the first of the card's 256)")
    a = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    for k in ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
              "SSQ_DW_KERNEL"):
        os.environ.pop(k, None)
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    import shiftedscalequantization_tpu as ssq
    from shiftedscalequantization_tpu import deploy as JD
    from shiftedscalequantization_tpu.graph import iter_units
    from shiftedscalequantization_tpu.models import zoo
    from shiftedscalequantization_tpu.quantize import act_flags, unit_order
    from shiftedscalequantization_tpu.recon import engine as JE

    cal = jnp.asarray(host_images(16, 1))
    x = jnp.asarray(host_images(256, 2)[:a.images])
    out = {}
    for arch, bits in (("regnetx_600m", (2, 4)), ("resnet18", (4, 8))):
        t = time.time()
        g, _ = zoo.build(arch)
        raw = jax.tree.map(jnp.asarray, host_params(list(iter_units(g))))
        cfg = ssq.QuantConfig(n_bits_w=bits[0], n_bits_a=bits[1])
        params, qs = ssq.prepare_model(g, raw, cfg)
        qs = ssq.calibrate_acts(g, params, qs, cal, cfg)
        states = {"uniform": qs}
        if arch == "regnetx_600m":
            names = unit_order(g)
            q2, theta = JE._init_quantizers(
                params, qs, names,
                JE.ReconSettings(mode="fused", shift_targets=(0.5, 1.0)))
            states["baked"] = JE._harden(JE._insert_theta(q2, theta), names,
                                         "fused")
        flags = act_flags(g, cfg, base=ssq.Flags().all_weights(g))
        for name, q in states.items():
            sim = np.asarray(jax.jit(
                lambda x: ssq.forward(g, params, q, x, flags))(x), np.float64)
            dp = JD.build_deploy_params(g, params, q)
            steps = JD.act_steps_from_qstate(g, q)
            plan = JD.make_deploy_plan(g, dp, steps, input_hw=(HW, HW))
            dep = np.asarray(jax.jit(lambda x: JD.deploy_forward(
                g, dp, steps, x, plan=plan))(x), np.float64)
            kinds = [v[0] for k, v in plan.items() if not k.startswith("__")]
            out[f"{arch}_{name}"] = dict(
                rel_mse=float(((dep - sim) ** 2).mean() / (sim ** 2).mean()),
                top1_agreement=float((dep.argmax(-1) == sim.argmax(-1))
                                     .mean()),
                finite=bool(np.isfinite(dep).all() and np.isfinite(sim).all()),
                images=int(x.shape[0]),
                plan_kinds={k: kinds.count(k) for k in sorted(set(kinds))})
            print(f"{arch} {name}: {out[f'{arch}_{name}']} "
                  f"({time.time() - t:.1f} s)", file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
