"""Experiment CLI (PyTorch port of
``shiftedscalequantization_tpu/cli.py``).

The shifted-scale pipelines of the reference (ShiftedScaleQuant.py
channelShift_wLoss:185-286 / channelShift_wMSE:119-183), the BRECQ
pipeline (Brecq/main_imagenet.py: weight reconstruction, then the act
phase) and the two-phase variant, with the JAX package's flags and printed
lines: the Fisher losses (``--opt_mode fisher_diag|fisher_full``) and the
act phases (``--act_mode delta|shift``, ``--act_shift_targets``,
``--act_bits_overrides``) included. ``--platform auto`` runs on the CUDA
card and raises without one; ``--platform cpu`` runs on the CPU.

Run:  python -m shiftedscalequantization_tpu_torch.cli --arch resnet18
      --dataset cifar10 --mode fused --n_bits_w 2 --n_bits_a 4 ...

Not ported yet, raising NotImplementedError that names its ROADMAP item:
``--pretrained *.pth`` (the torchvision importer).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import quantize as QZ
from ._device import resolve_device
from .data.datasets import DATA_ITEM, build_cifar10_data, \
    build_imagenet_data
from .graph import Flags
from .models import zoo
from .quantize import QuantConfig, act_flags, calibrate_acts, prepare_model, \
    reconstruction_targets
from .recon import ReconSettings, reconstruct_model
from .utils import checkpoint as ckpt
from .utils.config import load_args, parse_shift_targets
from .utils.eval import get_train_samples, validate_model
from .utils.logging import RunLog, Timer, notify


def seed_all(seed: int):
    """(reference common.py:77-85) The numpy global generator; every other
    draw of the pipeline comes from a generator seeded explicitly."""
    np.random.seed(seed)


def build_everything(args, device="cuda"):
    graph, _ = zoo.build(args.arch, dataset=args.dataset)
    if getattr(args, "pretrained", None) \
            and args.pretrained.endswith((".pth", ".pth.tar")):
        raise NotImplementedError(
            f"--pretrained with a torch checkpoint (utils/torch_import) "
            f"{DATA_ITEM}")
    if getattr(args, "pretrained", None):
        # trained raw params in the trainer's npz layout (the reference's
        # hubconf pretrained-checkpoint role, trash/hubconf.py:16-68)
        from .train import load_raw_params
        raw = load_raw_params(args.pretrained, device=device)
    else:
        raw = zoo.init_params(graph, seed=args.seed, device=device)
    cfg = QuantConfig(
        n_bits_w=args.n_bits_w, n_bits_a=args.n_bits_a,
        channel_wise=args.channel_wise, sym=args.sym,
        w_scale_method=args.w_scale_method,
        a_scale_method=args.a_scale_method,
        use_8bit_head_stem=not args.disable_8bit_head_stem)
    return graph, raw, cfg


def build_data(args):
    if args.dataset == "cifar10":
        return build_cifar10_data(batch_size=args.batch_size,
                                  data_path=args.data_path, seed=args.seed,
                                  synthetic=args.synthetic_data)
    if args.dataset == "digits":
        from .data.datasets import build_digits_data
        return build_digits_data(batch_size=args.batch_size, seed=args.seed)
    if args.dataset == "synth10":
        from .data.datasets import build_synth10_data
        return build_synth10_data(batch_size=args.batch_size, seed=args.seed)
    return build_imagenet_data(batch_size=args.batch_size,
                               data_path=args.data_path, seed=args.seed,
                               synthetic=args.synthetic_data)


def main(argv=None):
    args = load_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    seed_all(args.seed)
    log = RunLog(args.log_path or f"{args.run_device.replace(':', '_')}.log")
    timer = Timer()

    graph, raw, cfg = build_everything(args, device=device)
    train_loader, test_loader = build_data(args)
    cali_data = get_train_samples(train_loader, args.num_samples,
                                  device=device)
    params, qstate = prepare_model(graph, raw, cfg, device=device)

    wflags = Flags(output_affine=args.bias_cal).all_weights(graph)
    if args.test_before_calibration and not args.skip_test:
        acc = validate_model(graph, params, qstate, test_loader)
        print(f"accuracy of FP model: {acc}")

    ckpt_path = (f"{args.checkpoint_dir}/{args.dataset}_QNN_CW_"
                 f"W{args.n_bits_w}_A{args.n_bits_a}")
    recon_ckpt = f"{args.checkpoint_dir}/QNN_W{args.n_bits_w}_A{args.n_bits_a}"

    if args.eval_only:
        # checkpoint replay (reference myProject.py:71-89), routed through
        # the golden-logit regression when --golden_dir is set (the
        # reference's validate_with_loss replay, common.py:224-293)
        qstate, done = ckpt.load_qstate(recon_ckpt, device=device)
        prefix = Flags(output_affine=args.bias_cal).all_weights(graph)
        aflags = act_flags(graph, cfg, base=prefix) if args.act_quant \
            else prefix
        acc = _final_validate(graph, params, qstate, test_loader, aflags,
                              args)
        print(f"eval-only W{args.n_bits_w}A{args.n_bits_a} "
              f"(done={len(done)} layers): {acc}")
        return acc

    # weight-quantizer scale init happened in prepare_model; act init on
    # the first 64 calibration samples (reference lazy-init pass,
    # ShiftedScaleQuant.py:228-229)
    def maybe_harmonize(qs, when):
        if not args.harmonize_residual:
            return qs
        qs, hr = QZ.harmonize_residual_chains(graph, qs)
        if hr:
            worst = max(hr.values())
            print(f"harmonized {len(hr)} chain act sites {when} "
                  f"(worst step coarsening {worst:.2f}x)")
        return qs

    overrides = {}
    for kv in filter(None, args.act_bits_overrides.split(",")):
        site, bits = kv.split("=")
        overrides[site.strip()] = int(bits)

    if args.act_quant:
        qstate = calibrate_acts(graph, params, qstate, cali_data[:64], cfg,
                                flags=wflags, bit_overrides=overrides,
                                device=device)
        qstate = maybe_harmonize(qstate, "pre-recon")
    if args.make_checkpoint:
        # save the initialized (pre-recon) quantizer state and exit
        # (reference init_delta_zero, myScaledMethods.py:207-261 +
        # --make_checkpoint early exit, ShiftedScaleQuant.py:376-379)
        ckpt.save_qstate(ckpt_path, qstate)
        print(f"Making checkpoint data done -> {ckpt_path}.pkl")
        return None
    if not args.skip_test:
        acc = validate_model(graph, params, qstate, test_loader, wflags)
        print(f"accuracy of qnn (with cal.): {acc}")

    shift_targets = parse_shift_targets(args.shift_targets)

    if args.mode == "mse":
        qstate = run_mse_pipeline(graph, params, qstate, args)
        acc = _final_validate(graph, params, qstate, test_loader, wflags,
                              args)
        print(f"accuracy of qnn_mse: {acc}")
        log.append(f"mse,{args.arch},W{args.n_bits_w}A{args.n_bits_a}", acc)
        return acc

    settings = ReconSettings(
        mode=args.mode, iters=args.iters_w,
        batch_size=32, b_range=(args.b_start, args.b_end),
        warmup=args.warmup, weight=args.weight,
        lmda_r=0.01, lmda_s=args.lmda,
        shift_targets=shift_targets if args.bias_ch_quant else (1.0,),
        act_shift_targets=parse_shift_targets(args.act_shift_targets),
        fused_dequant=args.fused_dequant,
        post_round_frac=args.post_round_frac,
        warmstart_frac=args.fused_warmstart,
        warmstart_lr=args.fused_warmstart_lr or None,
        opt_beta=args.opt_beta, opt_output_affine=args.bias_cal,
        rec_loss=args.opt_mode, auto_candidates=args.auto_candidates,
        act_p=args.p)

    targets = reconstruction_targets(graph)
    done: list = []
    if args.resume and ckpt.exists(recon_ckpt):
        qstate, done = ckpt.load_qstate(recon_ckpt, device=device)
        print(f"Resumed from {recon_ckpt}.pkl ({len(done)} layers done)")
    pending = [t for t in targets if t not in done]
    accs = []

    def on_done(name, qs, metrics, prefix):
        sl = float(metrics.get("soft_loss", math.nan))
        hl = float(metrics.get("hard_loss", math.nan))
        print(f"Reconstructed {name}: soft {sl:.6f} -> hard {hl:.6f} "
              f"({metrics['wall_s']:.1f}s)")
        sr = metrics.get("selection_ratio")
        if sr:
            # reference print_ratio (layer_recon_fused_shiftedScale.py:13-21)
            for unit, ratios in sr.items():
                vals = ratios if isinstance(ratios, str) \
                    else np.asarray(ratios.cpu()).round(4).tolist()
                print(f"selection ratio {unit}: {vals}")
        done.append(name)
        ckpt.save_qstate(recon_ckpt, qs, done=done)  # per-layer resume point
        if not args.skip_test:
            # accuracy with every weight quantizer on (the reference's
            # set_quant_state(True, False) around the test,
            # ShiftedScaleQuant.py:263-278); capture keeps using the
            # accumulating prefix
            a = validate_model(graph, params, qs, test_loader, wflags)
            accs.append(a["top1"])
            print(f"accuracy of qnn_hard {name}: {a}")
            notify(f"{name}: {a}")

    # prefix flags start with the already-done layers quantized (resume)
    base = Flags(output_affine=args.bias_cal)
    if done:
        from .graph import find_node, node_unit_names
        units = set()
        for t in done:
            units.update(node_unit_names(find_node(graph, t)))
        base = dataclasses.replace(base, weight_on=frozenset(units))

    cache_dtype = {"bfloat16": torch.bfloat16, "float32": None,
                   None: None}[args.cache_dtype]
    qstate, history, prefix = reconstruct_model(
        graph, params, qstate, pending, cali_data, settings, seed=args.seed,
        batch_size=args.batch_size, base_flags=base, on_node_done=on_done,
        cache_dtype=cache_dtype, device=device)

    # activation phase: 'delta' = BRECQ act-scale learning
    # (main_imagenet.py:233-244), 'shift' = activation shifted-scale
    # selection (channelShift_wLoss_feature, ShiftedScaleQuant.py:288-353)
    act_mode = args.act_mode
    if act_mode == "auto":
        act_mode = "delta" if args.mode == "brecq" else "none"
    if args.act_quant:
        # re-initialize the act scales on 64 samples now that the weights
        # are reconstructed (reference Brecq/main_imagenet.py:231-234: the
        # act quantizers lazily init on the first forward after
        # recon_model); harmonized chain steps are re-derived
        qstate = calibrate_acts(graph, params, qstate, cali_data[:64], cfg,
                                flags=prefix, bit_overrides=overrides,
                                device=device)
        qstate = maybe_harmonize(qstate, "post-recon")
    if args.act_quant and act_mode != "none" and args.iters_a > 0:
        act_settings = dataclasses.replace(settings, iters=args.iters_a,
                                           act_lr=args.lr)
        pre_deltas = _act_deltas(qstate)
        qstate, _, _ = reconstruct_model(
            graph, params, qstate, targets, cali_data, act_settings,
            seed=args.seed + 1, batch_size=args.batch_size,
            base_flags=prefix, act_phase=act_mode, device=device)
        _report_act_drift(pre_deltas, _act_deltas(qstate))
        # the act phase learns each site's delta independently, splitting
        # any harmonized chain again: re-coarsen to the chain max
        qstate = maybe_harmonize(qstate, "post-act-phase")

    aflags = act_flags(graph, cfg, base=wflags) if args.act_quant else wflags
    final = _final_validate(graph, params, qstate, test_loader, aflags, args)
    print(f"Final W{args.n_bits_w}A{args.n_bits_a} accuracy: {final} "
          f"({timer.lap():.1f}s total)")
    log.append(
        f"{args.mode},{args.arch},W{args.n_bits_w}A{args.n_bits_a},"
        f"lmda={args.lmda},st={shift_targets}",
        {"accs": accs, "final": final})
    ckpt.save_qstate(recon_ckpt, qstate, done=done)
    return final


def _act_deltas(qstate):
    """site -> scalar act delta (diagnostic for the act-delta phase)."""
    from .graph import UnitQuant
    out = {}
    for name, v in qstate.items():
        aq = v.aq if isinstance(v, UnitQuant) else v
        if aq is not None and hasattr(aq, "delta") and aq.delta.numel() == 1:
            out[name] = float(aq.delta)
    return out


def _report_act_drift(pre: dict, post: dict):
    """Surface act-scale learning anomalies (negative or wildly drifted
    deltas)."""
    rows = []
    for name, d0 in pre.items():
        d1 = post.get(name)
        if d1 is None or d0 == 0:
            continue
        rows.append((abs(d1 / d0 - 1.0), name, d0, d1))
    if not rows:
        return
    rows.sort(reverse=True)
    bad = [r for r in rows if r[3] <= 0]
    worst = rows[0]
    print(f"act-phase delta drift: worst {worst[1]} "
          f"{worst[2]:.5g} -> {worst[3]:.5g} "
          f"({(worst[3] / worst[2] - 1.0) * 100:+.1f}%)"
          + (f"; {len(bad)} sites NON-POSITIVE: "
             + ", ".join(r[1] for r in bad[:5]) if bad else ""))


def _final_validate(graph, params, qstate, test_loader, flags, args):
    """Final accuracy, with the optional golden-logit regression (the
    reference's validate_with_loss against ./output_loss/result_{b}bit.pt,
    common.py:224-293)."""
    if args.golden_dir:
        acc, logits = validate_model(graph, params, qstate, test_loader,
                                     flags, return_logits=True)
        from .utils.eval import golden_logit_mse
        mse = golden_logit_mse(
            logits, f"{args.golden_dir}/result_{args.n_bits_w}bit.npz",
            save_if_missing=True)
        print(f"golden-logit MSE: {mse}" if mse is not None
              else "golden logits saved")
        return acc
    return validate_model(graph, params, qstate, test_loader, flags)


def run_mse_pipeline(graph, params, qstate, args):
    """Closed-form input-channel-scale pipeline (channelShift_wMSE,
    reference ShiftedScaleQuant.py:119-183): swap every reconstructable
    unit's weight quantizer for InpScaleWQ and run init_scale."""
    from .graph import UnitQuant, iter_units
    from .ops import wquant as W
    order = QZ.unit_order(graph)
    skip = {order[0], order[-1]}  # 8-bit head/stem + '.model.fc' skip list
    qstate = dict(qstate)
    for u in iter_units(graph):
        if u.name in skip:
            continue
        uq: UnitQuant = qstate[u.name]
        w = params[u.name]["w"]
        wq = W.init_inp_scale(uq.wq.qp, uq.raw_zp, w,
                              level=args.mse_level,
                              threshold=args.mse_threshold)
        qstate[u.name] = dataclasses.replace(uq, wq=wq)
    return qstate


if __name__ == "__main__":
    main()
