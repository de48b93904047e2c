"""CLI flag set (PyTorch port of
``shiftedscalequantization_tpu/utils/config.py``): the same flag names,
defaults, choices and help, so one command line drives either package.

Two flags name the card where the JAX package names its TPU:
``--platform auto`` runs on the CUDA card (and raises without one),
``--platform cpu`` on the CPU; ``--run_device`` (default ``cuda:0``)
names the run's log file.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Shifted-scale PTQ (PyTorch/CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    # general (common.py:24-30)
    p.add_argument("--seed", default=1005, type=int)
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto runs on the CUDA card and raises without "
                        "one; cpu runs on the CPU")
    p.add_argument("--arch", default="resnet18", type=str,
                   choices=["resnet18", "resnet34", "resnet50", "resnet101",
                            "resnet152", "mobilenetv2", "regnetx_600m",
                            "regnetx_3200m", "mnasnet"])
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--workers", default=4, type=int)
    p.add_argument("--data_path", default="~/dataset/cifar10", type=str)
    p.add_argument("--dataset", default="cifar10", type=str,
                   choices=["cifar10", "imagenet", "digits", "synth10"],
                   help="digits/synth10: the on-device datasets of "
                        "ACCURACY.md (train with -m ...train first)")
    p.add_argument("--pretrained", default=None, type=str,
                   help="path to trained raw params (.npz in the "
                        "'unit/w', 'unit/bn/<stat>' layout of "
                        "train.save_raw_params; the hubconf "
                        "pretrained-checkpoint role). Default: random init")

    # quantization (common.py:33-38)
    p.add_argument("--n_bits_w", default=2, type=int)
    p.add_argument("--channel_wise", default=True, type=_boolish)
    p.add_argument("--n_bits_a", default=4, type=int)
    p.add_argument("--act_quant", default=True, type=_boolish)
    p.add_argument("--disable_8bit_head_stem", default=False, type=_boolish)
    p.add_argument("--test_before_calibration", default=True, type=_boolish)

    # weight calibration (common.py:41-48)
    p.add_argument("--num_samples", default=1024, type=int)
    p.add_argument("--iters_w", default=20000, type=int)
    p.add_argument("--weight", default=0.01, type=float,
                   help="rounding-reg weight (BRECQ --weight)")
    # NOTE: the reference declares --sym default True (common.py:44) but its
    # shifted-scale entry script never forwards it to the quantizer ctor
    # (myScaledMethods.py build_qnn), so quantizers run asymmetric; we keep
    # the effective behavior as the default and make the flag real.
    p.add_argument("--sym", default=False, type=_boolish)
    p.add_argument("--b_start", default=20, type=int)
    p.add_argument("--b_end", default=2, type=int)
    p.add_argument("--warmup", default=0.2, type=float)
    p.add_argument("--step", default=20, type=int)

    # act calibration (common.py:51-53)
    p.add_argument("--iters_a", default=5000, type=int)
    p.add_argument("--lr", default=4e-4, type=float)
    p.add_argument("--p", default=2.4, type=float)

    # ops flags (common.py:56-64)
    p.add_argument("--make_checkpoint", default=False, type=_boolish)
    p.add_argument("--skip_test", default=False, type=_boolish)
    p.add_argument("--run_device", default="cuda:0", type=str)
    p.add_argument("--msg_bot_enable", default=False, type=_boolish)
    p.add_argument("--make_init_data", default=False, type=_boolish)
    p.add_argument("--bypassChannelShift", default=False, type=_boolish)

    # shifted-scale (common.py:67-71)
    p.add_argument("--mse_level", default=1, type=int)
    p.add_argument("--mse_threshold", default=1.0, type=float)
    p.add_argument("--shift_quant_mode", default="max", type=str)
    p.add_argument("--w_scale_method", default="mse", type=str)
    p.add_argument("--a_scale_method", default="mse", type=str)
    p.add_argument("--test", default=False, type=_boolish)

    # knobs latent in the reference, real here (README.md:30-34;
    # layer_recon_fused_shiftedScale.py:65-70)
    p.add_argument("--bias_cal", default=False, type=_boolish,
                   help="optimize gamma^z/phi^z output affine")
    p.add_argument("--bias_ch_quant", default=True, type=_boolish,
                   help="enable input-channel-group shifted scales")
    p.add_argument("--opt_beta", default=True, type=_boolish,
                   help="also optimize rounding logits in fused recon "
                        "(default ON: the reference's latent-but-intended "
                        "joint optimization, layer_recon_fused_shifted"
                        "Scale.py:65-70; selection-only fused recon "
                        "measurably stalls at chance — ACCURACY.md "
                        "ablation. 'false' restores the snapshot-faithful "
                        "behavior)")
    p.add_argument("--lmda", default=0.1, type=float,
                   help="shift-reg weight lambda_S")
    p.add_argument("--shift_targets", default="0.96875,1.03125,1.0", type=str,
                   help="comma-separated shift candidates")
    p.add_argument("--act_bits_overrides", default="", type=str,
                   help="per-site act-precision overrides, "
                        "'site=bits,site=bits' (e.g. "
                        "'model.layer3.5=8'): the reference's 8-bit "
                        "head/stem rule generalized to any act site — "
                        "lift the one or two dominant sites a deep net's "
                        "A4 accuracy is bottlenecked on (see "
                        "ACCURACY_r50_r5.md)")
    p.add_argument("--act_shift_targets", default="1.0,0.5", type=str,
                   help="comma-separated per-channel candidates for the "
                        "activation shift phase (--act_mode shift; the "
                        "reference ChannelQuantAct's intended {1,1/2} set "
                        "— widen to e.g. 1.0,0.25,0.0625 for harsh "
                        "per-channel activation spreads)")
    p.add_argument("--fused_dequant", default="auto",
                   choices=("auto", "unit", "effective"),
                   help="fused candidate dequant semantics: 'unit' = "
                        "reference-faithful (codes dequant at the base "
                        "delta; sane only for candidates ~1), 'effective' "
                        "= per-candidate delta*st grids (required for "
                        "coarse sets like 0.25,0.5,1); 'auto' picks "
                        "'effective' whenever max|st-1| > 1/8 (the "
                        "round-3 advantage demos collapsed to chance "
                        "because coarse candidates ran under 'unit')")
    p.add_argument("--fused_warmstart_lr", default=0.0, type=float,
                   help="LR override for the warm-start shift pre-solve "
                        "(0 = use the main recon LR)")
    p.add_argument("--post_round_frac", default=0.5, type=float,
                   help="fused effective-dequant runs: fraction of the "
                        "budget spent on the post-harden rounding-only "
                        "refinement (engine.ReconSettings.post_round_frac)")
    p.add_argument("--fused_warmstart", default=0.25, type=float,
                   help="fused mode, coarse candidates only: fraction of "
                        "the iteration budget spent on a two-phase shift "
                        "pre-solve whose solved selection re-seeds the "
                        "joint phase (engine.ReconSettings.warmstart_"
                        "frac). Repairs the joint path's selection "
                        "mis-assignment on harsh per-IC imbalance "
                        "(round-4 x16: fused 7.8%, fused+warmstart 99+). "
                        "0 disables")

    # infra
    p.add_argument("--synthetic_data", default=None, type=_boolish,
                   help="force synthetic data (default: auto if no dataset)")
    p.add_argument("--checkpoint_dir", default="./checkPoint", type=str)
    p.add_argument("--resume", default=False, type=_boolish)
    p.add_argument("--log_path", default=None, type=str)
    p.add_argument("--mode", default="fused", type=str,
                   choices=["fused", "brecq", "two_phase", "mse"],
                   help="reconstruction pipeline")
    p.add_argument("--eval_only", default=False, type=_boolish,
                   help="load checkpoint and evaluate (myProject.py replay)")
    p.add_argument("--opt_mode", default="mse", type=str,
                   choices=["mse", "fisher_diag", "fisher_full"],
                   help="reconstruction loss form (BRECQ opt_mode)")
    p.add_argument("--act_mode", default="auto", type=str,
                   choices=["auto", "none", "delta", "shift"],
                   help="activation phase after weight recon: 'delta' = "
                        "BRECQ act-scale learning, 'shift' = activation "
                        "shifted-scale selection (channelShift_wLoss_feature"
                        "); 'auto' = delta for brecq mode, none otherwise")
    p.add_argument("--harmonize_residual", default=False, type=_boolish,
                   help="share one act step per siteless residual chain "
                        "(quantize.harmonize_residual_chains) before "
                        "reconstruction: residual adds become exact int8 "
                        "code adds in deploy (MNASNet 1.02x row)")
    p.add_argument("--auto_candidates", default=False, type=_boolish,
                   help="per-unit data-driven shift candidate search "
                        "(rank voting over {1/8..15/8})")
    p.add_argument("--cache_dtype", default=None, type=str,
                   choices=[None, "float32", "bfloat16"],
                   help="dtype for cached calibration activations "
                        "(bfloat16 halves cache HBM; reference keeps fp32)")
    p.add_argument("--golden_dir", default=None, type=str,
                   help="golden-logit regression dir (validate_with_loss "
                        "role): saves result_{W}bit.npz on first run, "
                        "reports logits MSE after")
    return p


def _boolish(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "y")


def parse_shift_targets(s: str):
    return tuple(float(t) for t in s.split(","))


def load_args(argv=None):
    return build_parser().parse_args(argv)
