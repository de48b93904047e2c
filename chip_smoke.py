#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port
(``shiftedscalequantization_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed with its seconds; any failure ends the run with a
non-zero exit and no result line:

1. device: the card's name and power limit (nvidia-smi);
2. build: one nvcc process per CUDA source, all started together, and a
   link into one library (int_matmul.cu includes CuTe); its seconds and
   ptxas's registers and shared memory per kernel;
3. kernels: the stem and quant_matmul kernels against their plain
   PyTorch versions on the card, at the ResNet-18 serving shapes (batch
   256, 224x224; quant_matmul also at a ragged shape), with CUDA event
   timings beside the card's bound; the stem within one code of its plain
   f32 version on < 2e-3 of outputs and torch.equal on 1/8-grid images,
   in both transports, timed by CUDA-graph replay (eager beside) with
   cuDNN's f32 and bf16 convs alone as yardsticks;
4. serving: ResNet-18 ImageNet W2A4 at full width with seeded weights,
   MSE scale init, calibration on 16 images, deploy conversion, and one
   integer deploy forward at batch 256 with the fused stem and packed-W2
   kernels on; the counters, reset just before that forward, must show
   the stem kernel once, the packed kernel 3 times, the int8_conv kernel
   16 times and UNFUSED requants left to PyTorch elementwise ops;
   then the packed kernel at the path's three downsample shapes (codes
   in, stride 2 read in place): torch.equal against its plain version in
   sums mode (f32 out) and in every requant epilogue of REQUANT_VARIANTS,
   each also against the same launch in sums mode followed by deploy's
   quantize_out; f32 rows in, sums mode; timed per mode beside the bound
   and torch._int_mm;
5. parity: the fake-quant sim forward on the same batch (TF32 off) against
   the deploy logits: no NaN, rel-MSE <= 1e-2;
6. mnv2 setup: MobileNetV2 ImageNet (width 1.0) W2A4, set up as in 4, and
   its plan under SSQ_DW_KERNEL=1 SSQ_PACKED=1, which must hold the JAX
   package's kinds: 16 dw_int8, 34 packed, 1 bf16_codes, 1 float_1p,
   1 float;
7. dw kernel: the depthwise kernel against its plain version, bit-exact,
   at each distinct shape of the plan's 16 dw units and at one odd,
   stride-2, C % 16 != 0 shape, timed by CUDA-graph replay (eager beside)
   beside cuDNN's bf16 depthwise conv; the packed kernel as in 4 at each
   distinct shape of the plan's 34 packed units;
8. mbconv kernel: the fused inverted-residual kernel (it has no caller on
   the serving path) against its plain version, torch.equal, at each of
   MobileNetV2's 8 stride-1 block shapes at batch 256 (13 blocks), with
   4-bit codes and over the whole int8 range with 8-bit stage clips;
   timed by CUDA-graph replay on constants prepared once (eager beside),
   beside its bound, its CUDA-core floor (the design's instructions per
   expanded element over SMs x 128 lanes x the SM clock), cuDNN's bf16
   convs of the block alone, and the same run's packed and dw times of
   the units the served block runs;
9. mnv2 serving: one deploy forward at batch 256 with the counters reset
   just before it (16 dw and 34 packed launches, no int8_conv, UNFUSED
   requants left), its time, and the time of the port's bf16 float
   forward of the same model;
10. mnv2 parity: sim (TF32 off) against deploy, no NaN, rel-MSE <= 1e-2;
   and on 8 images snapped to a 1/8 grid the card's deploy logits against
   the port's CPU deploy of the same state (the plain versions), rel-MSE
   <= 1e-8 and the same top-1;
11. method setup: ResNet-18 as in 4, its weight quantizers swapped for the
   method's fused shifted-scale quantizers (targets {1/2, 1}; the 8-bit
   stem and fc take plain AdaRound) and hardened to the baked form, then
   converted; the plan under SSQ_STEM_KERNEL=1 SSQ_PACKED=1 must be 1
   stem_fused, 19 int8/bf16_codes and 1 float;
12. int8_conv kernel: the wgmma implicit-GEMM kernel against its plain
   version at every distinct conv shape of that plan and of the uniform
   plan, with one weight group (int32 sums) and two (the scale-table
   sum), offsets 0 and 128: torch.equal in sums mode and in every requant
   epilogue, each also against the sums launch followed by quantize_out;
   timed per mode beside the bound (all groups' operations), S cuDNN bf16
   convs on the same codes and the im2col + torch._int_mm route;
13. method serving: one deploy forward at batch 256 with the counters
   reset just before it (19 int8_conv, 1 stem, 0 packed launches, UNFUSED
   requants left), its time, and the shift-candidate selection ratios;
14. method parity: sim against deploy, no NaN, rel-MSE <= 1e-2, with the
   top-1 agreement and how close the sim's top two logits sit beside the
   deploy-vs-sim difference; card against CPU deploy on 8 grid images,
   rel-MSE <= 1e-8, same top-1;
15. fake_quant kernel: the fake-quant kernel against its plain version,
   bit-exact, at every act site's (N*H*W, C) shape of the ResNet-18 sim
   forward at batch 256, the stem's and a W2 per-row weight shape and a
   ragged (10, 130), timed beside its bound (8 bytes per element) and
   torch.fake_quantize_per_tensor_affine / _per_channel_affine (a
   yardstick: they multiply by the reciprocal); then the autograd
   Function's backward on the card against the plain version's autograd
   gradient, with elements on the clip bounds;
16. recon setup: the paper's reconstruction flow (the CLI's --mode fused)
   on ImageNet ResNet-18 W2A4 at full width: 256 seeded 224x224 images,
   prepare_model, act calibration on 64 of them with the weights on;
17. reconstruction: first the first target reconstructed twice as the
   pipeline will, untimed, under torch.profiler (host activity), with
   host CPU seconds and allocator retries: what the first run pays once;
   then reconstruct_model over the 9
   targets (reconstruction_targets; one CaptureSession), shift targets
   {1/2, 1} (effective dequant), warm start 0.25, refine 0.5, RECON_ITERS
   steps per target at batch 32; per target the capture seconds, steps/s,
   the loss before, the soft and hard loss, each trace's first-10 and
   last-10 means and the selection ratios; every loss finite and every
   trace's last-10 mean <= its first-10 mean;
18. recon parity: layer4.1 reconstructed on the card and on the CPU (the
   plain versions) from the same 64-row caches and the same CPU-generator
   rows; rec_trace within PARITY_RTOL, hardened codes within PARITY_FLIPS;
19. recon serving: calibration again with the reconstructed prefix, the
   sim forward with every act site on (counters reset just before it:
   fake_quant once per act site, 17, and once for the stem's 8-bit
   UniformWQ weight), deploy conversion and one deploy forward (19
   int8_conv, 1 stem, UNFUSED requants left); deploy vs sim rel-MSE
   <= 1e-2, no NaN, its top-1
   agreement and margins as in 14; card vs CPU deploy on 8 grid images
   rel-MSE <= 1e-8, same top-1;
20. cli runs: the port's CLI (``cli.main``, in this process) three times
   on ImageNet ResNet-18 W2A4 at full width (224x224, 1000 classes,
   seeded synthetic data: 512 train and 256 test images, random init),
   with the checkpoints, logs and golden logits in a temporary directory
   (CLI_RUNS): --mode fused (200 steps a target, 256 calibration rows,
   the per-target validation on), --mode brecq (128 rows, 200 steps, then
   the act-delta phase at 200 steps on every target) and --mode two_phase
   (128 rows, 100 + 200 steps, targets {1/2, 1}); per run its wall
   seconds, the
   CLI's own lines, the fake_quant act and weight launches counted during
   the run (counters reset just before it), the hard losses and the final
   accuracy; each run must reconstruct all 9 targets with finite hard
   losses and finite final logits, launch fake_quant (act and weight),
   leave every act delta positive and its checkpoint loadable; brecq must
   print the act-phase drift line. Then the act-delta phase of
   ACT_PARITY_TARGET is run again from the state and caches the brecq
   run gave it, ACT_PARITY_ITERS steps on the card and on the CPU (the
   plain versions) with the same CPU-generator rows: rec_trace and the
   learned deltas within PARITY_RTOL;
21. cli serving: the fused run's final checkpoint loaded onto the card
   and served through build_deploy_params / deploy_forward at batch 256
   (the CLI's test images): deploy vs sim logit rel-MSE <= 1e-2, no NaN.
22. regnet setup: RegNetX-600M ImageNet W2A4 at full width, weights
   and calibration images drawn with numpy (host_params, host_images:
   a recipe regnet_parity_gap.py repeats for the JAX package on the
   CPU), MSE scales, calibration on 16 images, in two states: uniform,
   and baked (the fused quantizers, targets SHIFT_TARGETS, hardened);
   each plan under the JAX package's defaults must hold the JAX plan's
   kinds (REGNET_KINDS: uniform 4 int8_bd and 12 grouped units, baked
   16 grouped); the kinds under SSQ_PACKED=1 are printed;
23. group conv kernel: int8_group_conv against its plain version with
   torch.equal at each grouped shape of both plans at batch 256, S = 1
   (int32 sums) and S = 2 (scale-table sum), offsets 0 and 128, in sums
   mode and in every requant epilogue of REQUANT_VARIANTS (each also
   against the sums launch followed by quantize_out), timed by
   CUDA-graph replay (eager beside) next to its bound and S cuDNN bf16
   grouped convs on the same codes; then at GROUP_ODD_SHAPES (Cg 8, 5,
   12, 24 in 8-byte runs, 40, 48, 56; OC/G not a multiple of 8; S = 3,
   4; tiles of several images with the last short, row bands that do not
   divide the image, batch 1 and 32, 15x15 at stride 2); and int8_conv
   against its plain version at every dense integer shape of both
   plans (int8_bd units on their block-diagonal operand);
24-25. regnet serving + parity: one deploy forward per state at batch
   256 with the counters reset just before it (REGNET_LAUNCHES: 12
   grouped + 40 int8_conv launches uniform, 16 + 36 baked; one requant
   left, the float stem's), its time, the forward under SSQ_PACKED=1
   and the port's bf16 float forward; sim (TF32 off) against deploy, no
   NaN, rel-MSE <= 1e-2, beside the JAX package's own gap on the recipe
   (JAX_GAP); card vs CPU deploy on 8 grid images, rel-MSE <= 1e-8,
   same top-1;
26. int8_pair: ResNet-18 ImageNet W4A8 under phase 4's switches
   (R18_W4A8_KINDS: 13 int8_pair units), int8_conv at its dense shapes
   (offset 128 for the int8_pair units), then served and gated as in
   24-25 (19 int8_conv launches, no requant left);
27. regnet cli: the port's CLI on the trained RegNetX-600M (CIFAR
   variant, synth10), REGNET_CLI_COMMON with --mode brecq and then
   --mode fused (at 100 weight steps: REGNET_CLI_MODES), each in its own
   process under REGNET_CLI_TIMEOUT_S;
   FP top-1, top-1 after each target, final top-1 and the deploy top-1
   of the final state on the 2048 test images, beside
   ACCURACY_regnet_r4.md; gates: FP top-1 equals the port CLI's on the
   CPU (PORT_CLI_FP_TOP1), brecq's final top-1 >= FP - 3 points, deploy
   within 0.5 points of the final (sim) top-1;
28. fisher: on ImageNet ResNet-18 W2A4 at full width (seeded, 64 rows),
   capture_grads for a block (model.layer2.0) and a nested unit
   (model.layer3.0.conv1) on the card and on the CPU (the plain
   versions), the head scaled to unit logit std on the rows (random
   weights saturate the softmax and leave the KL no gradient), without
   the damping (g - 1 exactly): the damped values >= 1 and some > 1;
   max|card - CPU| <= FISHER_GATE * max(g_cpu - 1) on every row where no
   relu input downstream of the target changed sign between the two
   runs, and each sign change a tie (|x| <= FISHER_TIE of its row's
   max): a relu input at a tie passes the gradient in one run and not in
   the other;
   the seconds per target; then model.layer4.1 reconstructed with
   fisher_diag and with fisher_full on the card and on the CPU from the
   same caches and grads, as 18 (rec_trace within PARITY_RTOL, codes
   within PARITY_FLIPS);
29. cli fisher and act-shift: cli.main twice as in 20 (METHOD_CLI_RUNS:
   --mode brecq --opt_mode fisher_diag, and --mode fused --act_mode
   shift with 100 act steps, 128 rows, 100 steps a target): 9 finite
   hard losses each, and a hardened ActShiftQuant at each of the 16 act
   sites of the targets; the act-shift checkpoint served at batch 256:
   its sim forward launches fake_quant once per candidate of each
   act-shift site (and once at the stem's site and its UniformWQ
   weight); the plan's kinds equal its CPU plan's, every per-channel
   site an f32 edge; the deploy launches (counters reset just before)
   equal those the CPU plan gives (plan_launches) and the requants left
   to PyTorch the CPU deploy's; no NaN; deploy vs sim rel-MSE <=
   RELMSE_GATE beside the JAX package's own gap (JAX_ACT_SHIFT_GAP,
   act_shift_parity_gap.py); card vs CPU deploy on 8 grid images
   rel-MSE <= 1e-8, same top-1; its ms/batch beside phase 13's;
30. search: on SEARCH_UNIT with SEARCH_ROWS FP-cached rows of phase 28's
   state, on the card and on the CPU: weight_greedy_selection and
   dist_selection equal but at pairs whose two losses tie within
   SEARCH_TIE; output_greedy_selection (one sweep) no worse than the
   all-base selection and within SEARCH_RTOL of the CPU's loss; its
   seconds;
31. mnasnet serving: ImageNet MNASNet (scale 2.0) W2A4 at full width,
   numpy-drawn (host_params), MSE scales, calibration on 16 images, in
   two states: plain, and harmonized (quantize.harmonize_residual_chains,
   its chains' sums on int8 __sum__ sites); each plan under
   SSQ_DW_KERNEL=1 SSQ_PACKED=1 must hold the JAX package's kinds for the
   recipe (MNASNET_KINDS, mnasnet_parity_gap.py on the CPU); one deploy
   forward at batch 256 with the counters reset just before it
   (MNASNET_LAUNCHES: dw_conv3x3_int8, dw_conv_int8, packed, and in the
   plain state int8_conv once per pair term), its pair_stats
   (MNASNET_PAIRS: pairs formed and consumed by int8_conv), the requants
   left (UNFUSED), its ms/batch and host issue time beside the port's
   bf16 float forward; sim (TF32 off) against deploy, no NaN, rel-MSE
   <= 1e-2, beside the JAX package's own gap (JAX_GAP); card vs CPU
   deploy on 8 grid images, rel-MSE <= 1e-8, same top-1; then the plain
   state with SSQ_PAIR_TERMS=0: no pair formed, no int8_conv launch,
   deploy vs sim within the gate;
32. dw_conv_int8 kernel: the integer depthwise kernel against its plain
   version at every depthwise shape it serves in phase 31 and at
   MobileNetV2's features.1.conv.0, with a centered 4-bit feed and a
   biased 8-bit one, one weight group (int32 sums) and two (the
   scale-table sum): torch.equal in sums mode and in every requant
   variant of REQUANT_VARIANTS (each also against the sums launch
   followed by quantize_out); timed by CUDA-graph replay in the path's
   mode (eager beside) next to its bound, the plain version (the shifted
   int32 multiply-adds it replaces, requant elementwise) and cuDNN's bf16
   depthwise conv on the same codes; then at DW_ODD_SHAPES (C = 36 and
   100: 4-byte copies; C = 30: bytes; a codes view one byte off; planes
   no tile divides, 1x1 and 2x2; S = 2, 3, 4), torch.equal in sums mode
   and in every requant variant, offsets 0 and 128;
33. mnasnet cli: the port's CLI on the trained MNASNet (CIFAR variant,
   synth10), MNASNET_CLI_COMMON (brecq W2A4) without and with
   --harmonize_residual, each in its own process under
   MNASNET_CLI_TIMEOUT_S, each final state served under SSQ_DW_KERNEL=1
   SSQ_PACKED=1 on the 2048 test images; gates: FP top-1 equals the port
   CLI's on the CPU (MNASNET_CPU_FP_TOP1), all 52 targets done, final
   (sim) top-1 at least FP - REGNET_FINAL_DROP, deploy within 0.5 points
   of it; the sum sites beside the JAX record's;
34. resnet50 setup + serving: ImageNet ResNet-50 W2A4 at full width from
   a torchvision-layout checkpoint drawn with numpy
   (torchvision_checkpoint, saved as {'state_dict': {'module.<key>':
   ...}}) and read back through utils/torch_import, MSE scales,
   calibration on 16 images, uniform and baked (SHIFT_TARGETS); each
   plan under the JAX package's defaults and under SSQ_STEM_KERNEL=1
   SSQ_PACKED=1 must hold the JAX plan's kinds (R50_KINDS); each served
   at batch 256 with the counters reset just before the forward
   (plan_launches; requants left UNFUSED: the float_1p stem's under the
   defaults), its ms/batch beside the port's bf16 float forward, deploy
   vs sim rel-MSE <= 1e-2, no NaN, card vs CPU deploy on 8 grid images
   rel-MSE <= 1e-8, same top-1; the sim forward (counters reset
   just before it) launches fake_quant once at each of the 49 act
   sites and once for each UniformWQ weight;
35. resnet50 kernels: fake_quant at the 49 act sites' shapes (12
   shapes, up to 3 211 264 x 64 and 802 816 x 256), as in 15; int8_conv
   at every dense shape of both default plans (22 shapes; S = 2 baked,
   S = 1 uniform; 1x1 at M = 802 816 and up to C = N = 2048, the
   stride-2 downsamples) and the packed kernel at every shape of the
   uniform stem+packed plan (34 units, K 64-2048), as in 12 and 4
   (torch.equal in sums mode and every requant variant,
   timed beside the bound, cuDNN and torch._int_mm); the stem's shape is
   phase 3's;
36. native loader: whether Pillow and libjpeg are installed; the native
   loader built from native/dataloader.cc into build/native/, its
   sequential batches equal ArrayLoader's bit for bit, and the loader
   the data builders take; left out, on a line of its own, only where
   libjpeg is missing;
37. resnet50 cli: an ImageNet npz root synthesized in a temporary
   directory (uint8 train.npz that takes the resize and crop, float32
   val shards) and the CLI in its own process under R50_CLI_TIMEOUT_S
   (R50_CLI_ARGS, --pretrained the phase-34 checkpoint); gates: exit 0,
   the loader kinds printed, 17 targets, the imported FP logits on 4 val
   images card vs CPU within R50_FP_RTOL, the fused checkpoint served
   with deploy vs sim rel-MSE <= 1e-2, no NaN;
38. parallel setup: two rank processes on the one card
   (``chip_smoke.py --parallel-rank DIR`` with SSQ_* set, as
   tests/test_multiprocess.py starts its ranks), each joining through
   ``parallel.dist.init_multihost``: the backend rule gives gloo (the
   ranks share cuda:0, and NCCL refuses two ranks on one device), and
   the ranks load the kernel library this process built (none rebuilds
   it); ImageNet ResNet-18 W2A4 at full width, numpy-drawn (host_params,
   PAR_SEED), MSE scales, 8-bit stem and head, in every process; each
   rank's seconds by phase;
39. parallel calibrate: synced_calibrate_acts on 2 x 32 images
   (fake_quant at every act site): the synced deltas equal on both ranks
   and within PAR_CAL_RTOL of the mean of the two local calibrations run
   here, every zero point integral;
40. parallel recon: sharded_capture of PAR_TARGET (32 rows, the prefix's
   act sites on), gathered; an untimed two-step warm-up (what the first
   reconstruction in a process pays once); ddp_reconstruct with the f32
   and with the int8 wire (PAR_ITERS fused steps, 16 rows a rank, near-1
   targets): steps/s (gloo through one card, not NCCL), the wire bytes a
   rank a step from theta's shapes, ranks bit-identical, each trace's
   last-10 mean <= its first-10; the f32 trace within PARITY_RTOL of
   reconstruct_node here on the same 32 rows; the int8 hard loss within
   INT8_WIRE_GAP of the f32's; the gathered caches against one capture
   here (FP outputs within PAR_CAPTURE_RTOL of their max, inputs but
   PARITY_FLIPS of them);
41. parallel validate: sharded_validate of the sim model over 4 x 32
   images (labels: the one-process sim top-1) equal to validate_model
   here; each rank's counters, reset before each of its phases, equal to
   this process's on that rank's share of the calibration, capture and
   validation, fake_quant_act above 0. Phases 38-41 run under
   PAR_LIMIT_S;
42. train: first, no child process of this one is alive and no process
   group is left; then train.train_model on CIFAR ResNet-18 (published
   widths 64-512, 32x32) from init_params(seed 0), synth10 drawn and
   rendered on the card, batch 256, TRAIN_STEPS steps, chunk 100, lr 0.1,
   f32 with TF32 off: steps/s, images/s, each chunk's mean loss and train
   accuracy, the held-out top-1 on synth10_test_arrays() (2048 images);
   gates: every loss finite, the last chunk's mean loss below the
   first's, top-1 >= TRAIN_TOP1_GATE;
43. train parity: the first PAR_STEPS steps of phase 42's schedule
   (train.train_step, make_optimizer) from the same initial params on
   fixed CPU-drawn batches of 16, on the card and on the CPU: each step's
   loss within TRAIN_LOSS_RTOL, the final params and the BN running stats
   each within TRAIN_PARAM_RTOL relative L2 (the updates and the worst
   tensor beside); the first batch's f32 gradient on the card within
   GRAD_F64_RTOL of float64 on the card (the CPU's beside); then
   phase 42's params through save_raw_params / load_raw_params (a
   temporary file), eval_accuracy equal to phase 42's top-1;
44. sweep: utils.sweep.main over SWEEP_GRID on the port's CLI (brecq,
   SWEEP_BASE) from phase 43's npz; gates: two records, no error, each a
   finite top-1, fake_quant_act launched; the same call again runs
   nothing;
45. profiling: profiling.layer_timing on ImageNet ResNet-18 W2A4 (the sim
   forward with weights and act sites on, batch 256, PROFILE_INNER
   launches a node) with format_timing's table, the sum of its rows
   beside this state's whole sim forward and phase 19's; one f32 3x3 conv
   at layer3.1's shape, its rate and its error against float64; gates:
   every row's ms positive and finite, no roofline share (direct
   multiply-adds against the f32 CUDA-core peak) above PROFILE_ROOF_MAX,
   each row's flops graph_flops', fake_quant_act launched, the conv
   within F32_CONV_RTOL of float64 (TF32 off); one sim forward under
   profiling.trace: one trace file whose CUDA kernel events include
   fake_quant. Phases 42-45 run under TOOLS_LIMIT_S.

It imports nothing of JAX. Standard output ends with a JSON line of
details, a JSON line of the kernels, the nvidia-smi line, the total
seconds, and then ``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS = 67e12                # H100 SXM f32, outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM bf16 tensor cores, dense
INT8_OPS = 1979e12               # H100 SXM int8 tensor cores, dense
RELMSE_GATE = 1e-2
CARD_CPU_GATE = 1e-8             # card deploy vs CPU deploy, grid images
MNV2_KINDS = {"dw_int8": 16, "packed": 34, "bf16_codes": 1, "float_1p": 1,
              "float": 1}
# requants each path's deploy forward leaves to PyTorch elementwise ops
# (deploy.quantize_out.unfused): ResNet-18's go in the int8_conv and
# packed epilogues; MobileNetV2's float_1p stem has no requant epilogue
# (the bf16_codes depthwise unit it feeds runs dw_conv_int8's); MNASNet's
# float_1p stem and, in the plain state, its 10 float units fed by a pair
# or an f32 sum (the consumer's requant after its int8_conv terms)
UNFUSED = {"resnet18": 0, "resnet18_shifted": 0, "resnet18_reconstructed": 0,
           "mobilenetv2": 1, "regnetx_600m_uniform": 1,
           "regnetx_600m_baked": 1, "resnet18_w4a8": 0, "mnasnet_plain": 11,
           "mnasnet_harmonized": 1,
           # ResNet-50: the float_1p stem's requant under the defaults, as
           # MobileNetV2's; none with the stem kernel
           "resnet50_uniform_default": 1, "resnet50_baked_default": 1,
           "resnet50_uniform_stem_packed": 0,
           "resnet50_baked_stem_packed": 0}
SHIFT_TARGETS = (0.5, 1.0)       # the method path's candidate set
RECON_IMAGES = 256               # calibration set of the reconstruction
RECON_ITERS = 200                # optimizer steps per target (CLI: 20000)
RECON_BATCH = 32                 # minibatch of a reconstruction step
RECON_CAL_ROWS = 64              # act calibration rows, before and after
PARITY_ROWS = 64                 # card vs CPU reconstruction of layer4.1
PARITY_ITERS = 16
PARITY_RTOL = 1e-3               # rec_trace, card vs CPU
PARITY_FLIPS = 0.005             # hardened codes, card vs CPU
ACT_PARITY_TARGET = "model.layer1.0"   # card vs CPU act-delta phase
ACT_PARITY_ITERS = 16
GRAD_RTOL = 1e-4                 # delta / zp gradients: sums in two orders
BATCH = 256
HW = 224
DEVICE = "cuda"                  # the card; the checks allocate here
# RegNetX-600M (phases 22-25): the plan kinds the JAX package gives both
# states under its defaults at 224x224 (tests/test_torch_port_regnet.py
# pins them against its plan on the CPU), and the launches of one deploy
# forward: the grouped f.b units on int8_group_conv, every other integer
# unit (int8_bd densified) on int8_conv
REGNET_KINDS = {
    "uniform": {"float_1p": 1, "float": 1, "int8_bd": 4, "int8": 30,
                "bf16_codes": 18},
    "baked": {"float_1p": 1, "float": 1, "int8": 34, "bf16_codes": 18}}
REGNET_LAUNCHES = {"uniform": dict(int8_group_conv=12, int8_conv=40),
                   "baked": dict(int8_group_conv=16, int8_conv=36)}
# the JAX package's own deploy-vs-sim logit rel-MSE on the same recipe
# (regnet_parity_gap.py --images 32, on the CPU): the share of the gap
# that belongs to the reference
JAX_GAP = {"regnetx_600m_uniform": 5.657550433364477e-04,
           "regnetx_600m_baked": 5.703625017323605e-04,
           # its plan under its defaults (a float_1p stem where the card
           # runs the stem kernel): the 13 int8_pair units are the same
           "resnet18_w4a8": 6.907369906493377e-06,
           # mnasnet_parity_gap.py --images 32, under the JAX package's
           # defaults (its packed kernel clips a __sum__ site's codes)
           "mnasnet_plain": 2.390080396739268e-03,
           "mnasnet_harmonized": 3.05720950312419e-03}
# ResNet-18 ImageNet W4A8 under phase 4's switches (phase 26): the 8-bit
# unsigned feeds of the 13 wide units are int8_pair
R18_W4A8_KINDS = {"stem_fused": 1, "int8_pair": 13, "bf16_codes": 6,
                  "float": 1}
# grouped shapes outside RegNetX-600M's plans at batch 256, and the edges
# of the kernel's tiling: (batch, H, W, C, N, conv groups, kernel, stride,
# padding, weight groups S): regnetx_200m's Cg = 8 at stride 2, an odd Cg
# = OC/G = 5, OC/G = 18 with Cg = 12, S = 3 and S = 4 at Cg = 24; tiles of
# three 7x7 images with the last one short (regnetx_200m); batch 1 (bands
# that do not divide a 7x7 image; stride 2); 15x15 at stride 2; bands of 5
# rows of 14; the group widths 40, 48 and 56 (regnetx_4000m, 3200m,
# 6400m); Cg = 24 in an odd number of groups, whose channel runs are only
# 8-byte aligned (regnetx_1600m)
GROUP_ODD_SHAPES = [(32, 56, 56, 24, 24, 3, 3, 2, 1, 2),
                    (32, 15, 15, 15, 15, 3, 3, 2, 1, 3),
                    (32, 28, 28, 48, 72, 4, 3, 1, 1, 2),
                    (32, 14, 14, 240, 240, 10, 3, 1, 1, 3),
                    (32, 14, 14, 240, 240, 10, 3, 1, 1, 4),
                    (32, 7, 7, 368, 368, 46, 3, 1, 1, 2),
                    (1, 7, 7, 528, 528, 22, 3, 1, 1, 2),
                    (1, 56, 56, 96, 96, 4, 3, 2, 1, 2),
                    (32, 15, 15, 96, 96, 4, 3, 2, 1, 2),
                    (32, 28, 28, 240, 240, 10, 3, 2, 1, 2),
                    (32, 14, 14, 560, 560, 14, 3, 1, 1, 2),
                    (32, 14, 14, 432, 432, 9, 3, 1, 1, 2),
                    (32, 14, 14, 784, 784, 14, 3, 1, 1, 2),
                    (32, 28, 28, 168, 168, 7, 3, 1, 1, 2)]
# phase 27: the port's CLI on the trained RegNetX-600M (CIFAR variant) on
# synth10, the flags of ACCURACY_regnet_r4.md (FP 99.80, brecq final
# 98.83, integer deploy 98.78 for the JAX package on a TPU); each run in a
# process of its own under REGNET_CLI_TIMEOUT_S
REGNET_CLI_COMMON = ["--arch", "regnetx_600m", "--dataset", "synth10",
                     "--pretrained", "trained_regnetx_600m_synth10.npz",
                     "--n_bits_w", "2", "--n_bits_a", "4", "--iters_w", "300",
                     "--iters_a", "150", "--num_samples", "256"]
# each mode's flags after REGNET_CLI_COMMON (a later flag wins): the fused
# run, gated on FP top-1 and deploy against sim only (it ends near 14
# top-1 at 300 steps), takes 100 weight steps: at 300 the whole script
# took 991.53-1097.88 s on the H100's machine, whose host runs the CLI
# phases 20-45% slower from one call to the next
REGNET_CLI_MODES = {"brecq": [], "fused": ["--iters_w", "100"]}
REGNET_CLI_TIMEOUT_S = 420
# FP top-1 on the CPU, same flags (--platform cpu): the port's CLI, 2048
# of its 2048 synth10 test images, is the gate; the JAX CLI's, 2044 of
# 2048, is printed beside: the port draws synth10 from a torch.Generator
# (data/realdata.py), so its test images are not the JAX CLI's (the CPU
# test test_torch_port_regnet.py holds the port's FP logits on the JAX
# CLI's own test images to the JAX package's)
PORT_CLI_FP_TOP1 = 100.0
JAX_CLI_FP_TOP1 = 99.8046875
REGNET_FINAL_DROP = 3.0          # brecq final top-1 >= FP - 3 points
REGNET_DEPLOY_GAP = 0.5          # |deploy - sim| top-1, points
_T0 = time.perf_counter()


def phase(name, t0):
    now = time.perf_counter()
    print(f"[{name}] {now - t0:.2f} s (at {now - _T0:.2f} s)", flush=True)


@contextlib.contextmanager
def time_limit(name, seconds):
    """Fail the phases run inside if they take longer than ``seconds``
    (SIGALRM, seen between Python bytecodes)."""
    import signal

    def expire(signum, frame):
        raise TimeoutError(f"{name}: over its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def time_cuda(fn, iters=20, warmup=3):
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph(fn, iters=20, warmup=3):
    """Mean ms per call of ``fn`` captured once in a CUDA graph and
    replayed ``iters`` times between CUDA events, after warm-up: the
    card's time for the call (its small setup kernels included) without
    the host's Python between launches, which a small kernel's eager
    timing measures instead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# The requant epilogues the deploy path builds, each held two ways at a
# kernel's full shape: the kernel launched with the epilogue (through
# deploy's own quantize_out / _block_requant on a deferred launch) against
# the same kernel's sums-mode launch followed by quantize_out's elementwise
# arithmetic, and against the plain version's sums through requant_plain.
# Sites (delta, zp, bits): 4-bit post-relu, 4-bit asymmetric, 8-bit
# unsigned (biased transport), and two block sites.
REQUANT_SITES = {"u4": (0.37, 0.0, 4), "a4": (0.29, 7.0, 4),
                 "b8": (0.021, 0.0, 8), "blk": (0.41, 0.0, 4),
                 "blka": (0.33, 8.0, 4)}
# (label, unit site or None, unit act, block site or None, block act,
#  residual kind): a unit requant onto its own site (no block), or the
# block's requant after the last unit (its site or none) with a residual
REQUANT_VARIANTS = [
    ("site u4 relu", "u4", "relu", None, None, None),
    ("site u4 relu6", "u4", "relu6", None, None, None),
    ("site a4 none", "a4", None, None, None, None),
    ("biased b8 relu", "b8", "relu", None, None, None),
    ("block relu, codes residual", None, None, "blk", "relu", "codes"),
    ("block relu, f32 residual", None, None, "blk", "relu", "f32"),
    ("block none, biased residual", None, None, "blka", None, "biased"),
    ("block none, no residual", None, None, "blka", None, None),
    ("unit site a4 + block relu6, codes residual", "a4", None, "blk",
     "relu6", "codes"),
]
# the variant each role of a unit on the serving paths runs
ROLE_VARIANT = {"site": "site u4 relu", "block codes":
                "block relu, codes residual",
                "block f32": "block relu, f32 residual",
                "block none": "block none, no residual"}


def requant_context(torch, deploy, dev):
    steps = {k: (torch.tensor(d, device=dev), torch.tensor(z, device=dev), b)
             for k, (d, z, b) in REQUANT_SITES.items()}
    return deploy._Ctx(steps, frozenset({"u4", "a4", "blk", "blka"}),
                       frozenset({"b8"}))


def requant_variant(torch, deploy, ctx, variant, deferred, pending, res):
    """(fused, unfused) outputs ('codes'/'biased', int8, site) of one
    variant: ``deferred`` launches the kernel with the epilogue,
    ``pending`` is its sums-mode value."""
    from types import SimpleNamespace as NS
    _, usite, uact, bsite, bact, rkind = variant
    if bsite is None:
        return (deploy.quantize_out(ctx, deferred, usite, uact),
                deploy.quantize_out(ctx, pending, usite, uact))
    unit = NS(name=usite or "no site", activation=uact)
    node = NS(name=bsite, post_activation=bact)
    r = res[rkind] if rkind else None
    fused = deploy._block_requant(ctx, deferred, unit, node, r)
    t = deploy.quantize_out(ctx, pending, unit.name, uact)
    return fused, deploy.quantize_out(ctx, t, bsite, bact, residual=r)


def residuals(torch, gen, shape, dev):
    """A residual of each kind shaped like a unit's output."""
    return {"codes": ("codes", torch.randint(-7, 9, shape, generator=gen,
                                             device=dev, dtype=torch.int8),
                      "a4"),
            "biased": ("biased", torch.randint(-128, 128, shape,
                                               generator=gen, device=dev,
                                               dtype=torch.int8), "b8"),
            "f32": ("f32", torch.randn(shape, generator=gen, device=dev)
                    * 1.5, None)}


def check_requant_modes(torch, deploy, requant, label, launch, plain_value,
                        pending, res, ctx):
    """Every variant: kernel codes == sums launch + quantize_out == plain
    sums + requant_plain, with torch.equal. Returns {variant: the Requant
    deploy built for it}."""
    rqs = {}
    for variant in REQUANT_VARIANTS:
        seen = []

        def run(rq):
            seen.append(rq)
            return launch(rq)

        fused, unfused = requant_variant(
            torch, deploy, ctx, variant,
            deploy._Deferred(run, pending.scale, pending.bias,
                             pending=True) if isinstance(
                                 pending, deploy._Pending)
            else deploy._Deferred(run, pending=False), pending, res)
        plain = requant.requant_plain(plain_value, seen[0])
        torch.cuda.synchronize()
        if fused[0] != unfused[0] or fused[2] != unfused[2] \
                or fused[1].dtype != torch.int8 \
                or not torch.equal(fused[1], unfused[1]) \
                or not torch.equal(fused[1], plain) \
                or torch.unique(plain).numel() < 3:
            d = (fused[1].int() - plain.int()).abs()
            raise AssertionError(
                f"{label} {variant[0]}: kernel codes differ from the sums + "
                f"quantize_out route or the plain version ({int(d.max())} "
                f"max, {int((d != 0).sum())} codes), or the codes take "
                f"{torch.unique(plain).numel()} values (a check needs 3)")
        rqs[variant[0]] = seen[0]
    return rqs


def gemm_roles(graph, plan, kinds):
    """{unit name: role} of the units a plan runs as ``kinds``: 'sums' (a
    downsample, materialized in f32), 'block codes' / 'block f32' / 'block
    none' (a block's last unit, which takes the block's requant with an
    identity residual, a downsample's, or none) or 'site' (a requant onto
    the unit's own site)."""
    from shiftedscalequantization_tpu_torch.graph import BlockSpec, UnitSpec
    roles = {}
    for node in graph:
        if isinstance(node, UnitSpec):
            if plan[node.name][0] in kinds:
                roles[node.name] = "site"
        elif isinstance(node, BlockSpec):
            if node.downsample is not None \
                    and plan[node.downsample.name][0] in kinds:
                roles[node.downsample.name] = "sums"
            for u in node.units:
                if plan[u.name][0] not in kinds:
                    continue
                if u is node.units[-1]:
                    roles[u.name] = "block " + (
                        "none" if not node.residual else
                        "f32" if node.downsample is not None else "codes")
                else:
                    roles[u.name] = "site"
    return roles


def role_counts(graph, plan, kinds, key_of):
    """{shape key: {role: count}} of the units a plan runs as ``kinds``."""
    from shiftedscalequantization_tpu_torch.graph import iter_units
    from shiftedscalequantization_tpu_torch import deploy
    hw = deploy._unit_in_hw(graph, (HW, HW))
    roles = gemm_roles(graph, plan, kinds)
    out = {}
    for u in iter_units(graph):
        if u.name in roles:
            key = key_of(u, hw[u.name])
            out.setdefault(key, {})
            out[key][roles[u.name]] = out[key].get(roles[u.name], 0) + 1
    return out


def _scaled(torch, gen, n, dev, spread):
    """Per-column scales that put a value of std ``spread`` near 3 steps of
    the 0.37 grid, and biases of a step or two."""
    sc = (torch.rand((n,), generator=gen, device=dev) * 0.5 + 0.75) \
        * (3 * 0.37 / max(spread, 1e-6))
    return sc, torch.randn((n,), generator=gen, device=dev) * 0.6


def path_time(rows, key="ms", roles="roles"):
    """Sum over shapes of count x the time (or bound) of each role's
    mode: one forward's worth."""
    return sum(c * r[key][role] for r in rows for role, c in
               r[roles].items())


def check_packed(torch, gen, packed, requant, deploy, shapes, iters=20):
    """Packed kernel vs its plain version at each (B, H, W, K, stride, N)
    NHWC 1x1 shape of a path at batch 256, W2 codes, int8 codes in:
    torch.equal in sums mode (f32 out, as the downsample uses it) and in
    every requant variant, each also against the same launch in sums mode
    followed by quantize_out; f32 rows in (quantized on the way in), sums
    mode, once per shape. Timed in each role's mode and in sums mode,
    beside the bound (the bytes the mode reads and writes once, or the
    int8 operations) and torch._int_mm on the same codes."""
    dev = DEVICE
    ctx = requant_context(torch, deploy, dev)
    rows = []
    for (b, h, w, k, st, n), roles in sorted(shapes.items(), reverse=True):
        ho, wo = (h - 1) // st + 1, (w - 1) // st + 1
        m = b * ho * wo
        x = torch.randint(-7, 9, (b, h, w, k), generator=gen, device=dev,
                          dtype=torch.int8)
        raw = torch.randint(0, 4, (k, n), generator=gen, device=dev,
                            dtype=torch.int32)
        w_zp = torch.randint(0, 4, (n,), generator=gen, device=dev).float()
        wp = packed.pack_codes(raw, 2)
        delta = torch.tensor(0.05, device=dev)
        zp = torch.tensor(7.0, device=dev)
        spread = 0.05 * 4.0 * math.sqrt(k)
        scale, bias = _scaled(torch, gen, n, dev, spread)
        args = (x, wp, w_zp, scale, bias, delta, zp, 2, 4)
        label = f"packed {b}x{h}x{w}x{k}/s{st}->{n}"
        got = packed.packed_quant_matmul(*args, stride=st)
        want = packed.packed_quant_matmul_plain(*args, stride=st)
        xf = torch.randn((b, h, w, k), generator=gen, device=dev)
        got_f = packed.packed_quant_matmul(xf, *args[1:], stride=st)
        want_f = packed.packed_quant_matmul_plain(xf, *args[1:], stride=st)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got_f, want_f)):
            raise AssertionError(f"{label}: sums differ from the plain "
                                 "version")
        res = residuals(torch, gen, got.shape, dev)
        rqs = check_requant_modes(
            torch, deploy, requant, label,
            lambda rq: packed.packed_quant_matmul(*args, stride=st,
                                                  requant=rq),
            want, got, res, ctx)
        ms = {"sums": time_graph(lambda: packed.packed_quant_matmul(
            *args, stride=st), iters)}
        bytes_ = {"sums": m * k + wp.numel() * 4 + 3 * n * 4 + 4 * m * n}
        for role in roles:
            if role == "sums":
                continue
            rq = rqs[ROLE_VARIANT[role]]
            ms[role] = time_graph(lambda: packed.packed_quant_matmul(
                *args, stride=st, requant=rq), iters)
            rbytes = {"block codes": m * n, "block f32": 4 * m * n}.get(
                role, 0)
            bytes_[role] = m * k + wp.numel() * 4 + 5 * n * 4 + m * n \
                + rbytes
        plain_ms = time_cuda(lambda: packed.packed_quant_matmul_plain(
            *args, stride=st), max(2, iters // 4), warmup=1)
        xq = x[:, ::st, ::st, :].reshape(m, k)
        w8 = (raw - w_zp.round().to(torch.int32)).to(torch.int8) \
            .T.contiguous().T
        lib_ms = time_graph(lambda: torch._int_mm(xq, w8), iters)
        bound = {role: bound_ms(nb, 2 * m * n * k, INT8_OPS)
                 for role, nb in bytes_.items()}
        print(f"  {label} {roles}: " + ", ".join(
            f"{role} {t:.4f} ms (bound {bound[role][0]:.4f} by "
            f"{bound[role][1]})" for role, t in ms.items())
            + f"; plain {plain_ms:.4f}, _int_mm {lib_ms:.4f}; sums and "
            f"{len(rqs)} requant variants bit-exact", flush=True)
        rows.append(dict(shape=(b, h, w, k, st, n), roles=roles, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms={r: v[0] for r, v in bound.items()},
                         bound_by={r: v[1] for r, v in bound.items()},
                         err=0.0))
    return rows


def check_stem(torch, gen, stem):
    """The ResNet-18 stem at batch 256, 224x224: biased 8-bit (the serving
    site) and centered 4-bit transport, launched on constants prepared
    once as the deploy plan holds them. Within one code of the plain f32
    version on < 2e-3 of outputs; on 1/8-grid images (every value
    bf16-exact, every sum exact in f32) torch.equal. Timed by CUDA-graph
    replay with the eager time beside; yardsticks: cuDNN's f32 conv alone
    (TF32 off) and its bf16 conv alone on the same image and codes,
    channels-last (the conv without the epilogue and pool)."""
    import torch.nn.functional as F
    dev = DEVICE
    x = torch.randn((BATCH, HW, HW, 3), generator=gen, device=dev)
    xg = torch.round(x * 8) / 8
    w = torch.randint(-120, 121, (64, 3, 7, 7), generator=gen,
                      device=dev).float()
    scale = torch.rand((64,), generator=gen, device=dev) * 0.003 + 0.001
    bias = torch.randn((64,), generator=gen, device=dev) * 0.1
    xc = x.permute(0, 3, 1, 2)                    # channels-last NCHW view
    wc = w.contiguous(memory_format=torch.channels_last)
    xb, wb = xc.to(torch.bfloat16), wc.to(torch.bfloat16)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        f32_ms = time_graph(lambda: F.conv2d(xc, wc, None, 2, 3))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    bf16_ms = time_graph(lambda: F.conv2d(xb, wb, None, 2, 3))
    hp = HW // 4
    n_bytes = (x.numel() * 4 + 64 * stem.K * 2 + 2 * 64 * 4 + 16
               + BATCH * hp * hp * 64)
    conv_ops = 2 * BATCH * (HW // 2) ** 2 * 64 * 147
    b_ms, b_by = bound_ms(n_bytes, 2 * conv_ops, BF16_FLOPS)
    f32_bound, _ = bound_ms(n_bytes, conv_ops, F32_FLOPS)
    rows = []
    for label, delta, zp, qmax, coff in (("biased", 0.02, 0.0, 255.0, 128.0),
                                         ("centered", 0.1, 0.0, 15.0, 0.0)):
        args = (w, scale, bias, delta, zp, qmax, coff)
        k = stem.prepare_stem(*args)
        got = stem.stem_fused_prepared(x, k)
        want = stem.stem_fused_plain(x, *args)
        grid_equal = torch.equal(stem.stem_fused_prepared(xg, k),
                                 stem.stem_fused_plain(xg, *args))
        torch.cuda.synchronize()
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        off = float((diff != 0).float().mean())
        worst = int(diff.max())
        if worst > 1 or off > 2e-3 or not grid_equal:
            raise AssertionError(f"stem {label}: {off:.3g} of codes off, "
                                 f"max |diff| {worst}, 1/8-grid images "
                                 f"equal {grid_equal}")
        ms = time_graph(lambda: stem.stem_fused_prepared(x, k))
        eager_ms = time_cuda(lambda: stem.stem_fused_prepared(x, k))
        plain_ms = time_cuda(lambda: stem.stem_fused_plain(x, *args))
        print(f"  stem {label}: {ms:.4f} ms graph, {eager_ms:.4f} eager "
              f"(bound {b_ms:.4f} ms by {b_by}: 2-pass bf16 on the tensor "
              f"cores; f32-pipe bound {f32_bound:.4f}; plain {plain_ms:.4f};"
              f" cuDNN conv alone f32 {f32_ms:.4f}, bf16 {bf16_ms:.4f}), "
              f"{off:.3g} of codes off by <= {worst}, 1/8-grid images "
              f"equal", flush=True)
        rows.append(dict(label=label, ms=ms, eager_ms=eager_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         bound_f32_pipe_ms=f32_bound,
                         cudnn_f32_conv_ms=f32_ms,
                         cudnn_bf16_conv_ms=bf16_ms, err=float(worst),
                         off=off, grid_equal=grid_equal))
    return rows


# (name, M, K, N) of quant_matmul's checks: the three stride-2
# downsample 1x1 convs of ResNet-18 at batch 256, and a ragged shape
QMM_SHAPES = [("layer2.0.downsample", 200704, 64, 128),
              ("layer3.0.downsample", 50176, 128, 256),
              ("layer4.0.downsample", 12544, 256, 512),
              ("ragged", 50177, 16, 40)]


def check_quant_matmul(torch, gen, int_matmul):
    """quant_matmul vs its plain version (bit-exact: the same division,
    rounding and step-by-step epilogue), 4-bit acts, W2 codes, ReLU on;
    beside it torch._int_mm on the pre-quantized int8 operands (the GEMM
    alone, without the quantization or the epilogue)."""
    dev = DEVICE
    rows = []
    for name, m, k, n in QMM_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randint(-2, 2, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((n,), generator=gen, device=dev) * 0.09 + 0.01
        bias = torch.randn((n,), generator=gen, device=dev)
        delta = torch.tensor(0.05, device=dev)
        zp = torch.tensor(7.0, device=dev)
        args = (x, w, scale, bias, delta, zp, 4, True)
        got = int_matmul.quant_matmul(*args)
        want = int_matmul.quant_matmul_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err != 0:
            raise AssertionError(f"quant_matmul {name}: max abs err {err}")
        ms = time_graph(lambda: int_matmul.quant_matmul(*args))
        plain_ms = time_cuda(lambda: int_matmul.quant_matmul_plain(*args),
                             iters=5)
        xq = (torch.clamp(torch.round(x / delta) + zp, 0, 15) - zp) \
            .to(torch.int8)
        # cuBLASLt's int8 GEMM behind torch._int_mm refuses M not a
        # multiple of 8: no library time for the ragged shape
        lib_ms = time_graph(lambda: torch._int_mm(xq, w)) \
            if m % 8 == 0 else None
        n_bytes = m * k * 4 + k * n + 2 * n * 4 + m * n * 4
        b_ms, b_by = bound_ms(n_bytes, 2 * m * n * k, INT8_OPS)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"  quant_matmul {name} M={m} K={k} N={n}: {ms:.4f} ms "
              f"(bound {b_ms:.4f} ms by {b_by}, plain {plain_ms:.4f}, "
              f"_int_mm {lib}), max abs err {err:.3g}", flush=True)
        rows.append(dict(name=name, shape=(m, k, n), ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by, err=err))
    return rows


def host_params(torch, graph, seed=0):
    """He-normal weights drawn with numpy in unit order from
    default_rng(seed), identity BN, zero linear bias, on the card: a
    recipe the CPU can repeat without the card (regnet_parity_gap.py
    draws the same for the JAX package)."""
    import numpy as np
    from shiftedscalequantization_tpu_torch.graph import iter_units
    rng = np.random.default_rng(seed)
    out = {}
    for u in iter_units(graph):
        shape = (u.out_ch, u.in_ch // u.groups, *u.kernel) \
            if u.kind == "conv" else (u.out_ch, u.in_ch)
        fan_in = int(np.prod(shape[1:]))
        w = rng.standard_normal(shape, dtype=np.float32) \
            * np.float32(np.sqrt(2.0 / fan_in))
        p = {"w": torch.as_tensor(w, device=DEVICE)}
        c = u.out_ch
        if u.has_bn:
            p["bn"] = {k: torch.full((c,), v, device=DEVICE) for k, v in
                       (("gamma", 1.0), ("beta", 0.0), ("mean", 0.0),
                        ("var", 1.0))}
        else:
            p["b"] = torch.zeros((c,), device=DEVICE)
        out[u.name] = p
    return out


def host_images(torch, n, seed):
    """n standard-normal 224x224 NHWC images from numpy's
    default_rng(seed), on the card."""
    import numpy as np
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (n, HW, HW, 3), dtype=np.float32), device=DEVICE)


def serving_setup(torch, gen, arch="resnet18", shifted=False, bits=(2, 4),
                  host=False, raw=None):
    """An ImageNet model (ResNet-18 or -50, MobileNetV2, RegNetX-600M or
    MNASNet) at full width, W2A4 or ``bits``, seeded weights (or ``raw``
    params), all on the card: BN fold + MSE weight scales, act calibration
    on 16 images, and with ``shifted`` the method's fused shifted-scale
    quantizers (targets SHIFT_TARGETS) hardened as the reconstruction
    engine hardens them; then deploy conversion. ``host`` draws the
    weights and the calibration images with numpy (host_params,
    host_images seed 1), else with the card's generators. Returns (graph,
    cfg, params, qstate, dparams, steps)."""
    from shiftedscalequantization_tpu_torch import deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.models import zoo
    from shiftedscalequantization_tpu_torch.recon import engine
    graph, _ = zoo.build(arch, dataset="imagenet")
    if raw is None:
        raw = host_params(torch, graph) if host \
            else zoo.init_params(graph, seed=0, device=DEVICE)
    cfg = Q.QuantConfig(n_bits_w=bits[0], n_bits_a=bits[1])
    params, qstate = Q.prepare_model(graph, raw, cfg, device=DEVICE)
    calib = host_images(torch, 16, 1) if host \
        else torch.randn((16, HW, HW, 3), generator=gen, device=DEVICE)
    qstate = Q.calibrate_acts(graph, params, qstate, calib, cfg,
                              device=DEVICE)
    if shifted:
        qstate = bake(engine, Q, graph, params, qstate)
    dparams = deploy.build_deploy_params(graph, params, qstate,
                                         device=DEVICE)
    steps = deploy.act_steps_from_qstate(graph, qstate)
    return graph, cfg, params, qstate, dparams, steps


def bake(engine, Q, graph, params, qstate):
    """The method's fused shifted-scale quantizers (targets SHIFT_TARGETS)
    on every unit, hardened as the reconstruction engine hardens them."""
    names = Q.unit_order(graph)
    qstate, _ = engine._init_quantizers(
        params, qstate, names,
        engine.ReconSettings(mode="fused", shift_targets=SHIFT_TARGETS))
    return engine._harden(qstate, names, "fused")


def packed_shapes(graph, dparams, plan):
    """{(B, H, W, K, stride, N): {role: count}} of the units a plan runs
    packed, at batch 256 (a linear unit is B x 1 x 1 rows)."""
    for name, d in dparams.items():
        if plan[name][0] == "packed" and d.w_pack_bits != 2:
            raise AssertionError(f"{name}: not W2 packed")
    return role_counts(
        graph, plan, ("packed",),
        lambda u, hw: (BATCH, *((1, 1) if u.kind == "linear" else hw),
                       u.in_ch, u.stride[0], u.out_ch))


def dw_shapes(graph, plan):
    """{(H, W, C, stride): count} of the dw_int8 units of a plan."""
    from shiftedscalequantization_tpu_torch import deploy
    from shiftedscalequantization_tpu_torch.graph import iter_units
    hw = deploy._unit_in_hw(graph, (HW, HW))
    dw = {}
    for u in iter_units(graph):
        if plan[u.name][0] == "dw_int8":
            key = (*hw[u.name], u.in_ch, u.stride[0])
            dw[key] = dw.get(key, 0) + 1
    return dw


# a depthwise shape outside MobileNetV2's, checked beside the path's:
# odd H and W, stride 2, C % 16 != 0 (the kernel's 4-byte copy instance)
DW_EXTRA_SHAPE = (15, 15, 28, 2)


def check_dw(torch, gen, dw, shapes):
    """dw kernel vs its plain version, bit-exact, at each (H, W, C, stride)
    of the path at batch 256 and at DW_EXTRA_SHAPE (count 0, outside the
    per-forward sums), 4-bit codes in and out, W2 codes, relu6, launched
    on constants prepared once as the deploy plan holds them; timed by
    CUDA-graph replay with the eager time beside, and beside it cuDNN's
    bf16 channels-last depthwise conv of the same shape (the conv alone,
    without the epilogue and requant)."""
    import torch.nn.functional as F
    dev = DEVICE
    rows = []
    todo = sorted(shapes.items(), reverse=True) + [(DW_EXTRA_SHAPE, 0)]
    for (h, w, c, stride), count in todo:
        x = torch.randint(-8, 8, (BATCH, h, w, c), generator=gen,
                          device=dev, dtype=torch.int8)
        wc = torch.randint(-2, 2, (c, 3, 3), generator=gen, device=dev,
                           dtype=torch.int8)
        scalef = torch.rand((c,), generator=gen, device=dev) * 0.05 + 0.001
        biasf = torch.randn((c,), generator=gen, device=dev) * 0.5
        args = (x, wc, scalef, biasf, torch.tensor(0.07, device=dev),
                torch.tensor(7.0, device=dev), 15.0)
        k = dw.prepare_dw(*args[1:])
        got = dw.dw_conv3x3_int8_prepared(x, k, stride, "relu6")
        want = dw.dw_conv3x3_int8_plain(*args, stride=stride, act="relu6")
        torch.cuda.synchronize()
        err = float((got.int() - want.int()).abs().max())
        if err != 0:
            raise AssertionError(f"dw {h}x{w}x{c}/s{stride}: max abs err "
                                 f"{err} codes")
        ms = time_graph(lambda: dw.dw_conv3x3_int8_prepared(x, k, stride,
                                                            "relu6"))
        eager_ms = time_cuda(lambda: dw.dw_conv3x3_int8_prepared(
            x, k, stride, "relu6"))
        plain_ms = time_cuda(lambda: dw.dw_conv3x3_int8_plain(
            *args, stride=stride, act="relu6"))
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)       # channels_last
        wb = wc.reshape(c, 1, 3, 3).to(torch.bfloat16) \
            .contiguous(memory_format=torch.channels_last)
        conv_ms = time_graph(lambda: F.conv2d(xb, wb, None, stride, 1, 1,
                                              c))
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        n_bytes = BATCH * (h * w + ho * wo) * c + 12 * c + 8 * c + 12
        b_ms, b_by = bound_ms(n_bytes, 2 * 9 * BATCH * ho * wo * c,
                              INT8_OPS)
        print(f"  dw {h}x{w}x{c}/s{stride} (x{count}): {ms:.4f} ms graph, "
              f"{eager_ms:.4f} eager (bound {b_ms:.4f} ms by {b_by}, plain "
              f"{plain_ms:.4f}, cuDNN bf16 conv alone {conv_ms:.4f}), "
              f"bit-exact", flush=True)
        rows.append(dict(shape=(h, w, c, stride), count=count, ms=ms,
                         eager_ms=eager_ms, plain_ms=plain_ms,
                         conv_alone_ms=conv_ms, bound_ms=b_ms,
                         bound_by=b_by, err=err))
    return rows


# MobileNetV2's stride-1 inverted-residual blocks at 224x224, batch 256:
# (name, H, CI, CE, CO, expand, residual, blocks of that shape), 13 blocks
MBCONV_SHAPES = [
    ("features.1", 112, 32, 32, 16, False, False, 1),
    ("features.3", 56, 24, 144, 24, True, True, 1),
    ("features.5-6", 28, 32, 192, 32, True, True, 2),
    ("features.8-10", 14, 64, 384, 64, True, True, 3),
    ("features.11", 14, 64, 384, 96, True, False, 1),
    ("features.12-13", 14, 96, 576, 96, True, True, 2),
    ("features.15-16", 7, 160, 960, 160, True, True, 2),
    ("features.17", 7, 160, 960, 320, True, False, 1)]
# the three shapes of the kernel's first timings, one launch each
MBCONV_3SHAPES = ("features.1", "features.3", "features.15-16")
# a design estimate, counted from the source and not measured on the card:
# the kernel's instructions per expanded element (B*H*W*CE) on the CUDA
# cores, the dw 12.25 (a 4-channel word: 3 shared loads, 6 byte
# permutes and 12 dp4a per q1 row, which feeds 3 output rows; then the
# epilogue, 6 float operations a code and 3 permutes a word, and one
# store), the expand's epilogue 6.875 and, per 32 input channels, an
# ldmatrix, 4 fragment loads and 4 mma a 16 x 32 tile (0.5625)
MBCONV_DW_INSTR = 12.25
MBCONV_EXPAND_INSTR = 6.875
MBCONV_KSTEP_INSTR = 0.5625


def cuda_core_rate(torch):
    """Issued thread-instructions a second: SMs x 128 lanes x the card's
    maximum SM clock (nvidia-smi)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * mhz * 1e6, sms, mhz


def _mbconv_args(torch, gen, h, ci, ce, co, full):
    """Seeded block inputs at batch 256: 4-bit block codes, W2 codes and
    4-bit stage clips; or (full) codes over the whole int8 range, 8-bit
    stage clips (hi_e = hi_d = 255) and an 8-bit block grid, with rows
    scaled so that every stage spans its range."""
    dev = DEVICE

    def codes(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def rows(n, lo, hi, mean, spread):
        return torch.stack([torch.rand((n,), generator=gen, device=dev)
                            * (hi - lo) + lo,
                            torch.randn((n,), generator=gen, device=dev)
                            * spread + mean]).contiguous()

    if full:
        k = (-128, 128)
        return (codes(*k, BATCH, h, h, ci), codes(*k, ci, ce),
                rows(ce, *(128 / (ci ** 0.5 * 5470) * f for f in (.5, 1.5)),
                     100.0, 30.0),
                codes(*k, 9, ce),
                rows(ce, *(128 / 22000 * f for f in (.5, 1.5)), 100.0, 30.0),
                codes(*k, ce, co),
                rows(co, *(128 / (ce ** 0.5 * 9000) * f for f in (.5, 1.5)),
                     0.0, 10.0),
                torch.tensor([255.0, 255.0, 0.7, -128.0, 127.0, 0.0],
                             device=dev))
    return (codes(-8, 8, BATCH, h, h, ci), codes(-2, 2, ci, ce),
            rows(ce, 0.05, 0.3, 0.5, 1.0), codes(-2, 2, 9, ce),
            rows(ce, 0.05, 0.3, 0.5, 1.0), codes(-2, 2, ce, co),
            rows(co, 0.01, 0.1, 0.5, 1.0),
            torch.tensor([15.0, 15.0, 0.7, -8.0, 7.0, 0.0], device=dev))


def block_units_ms(h, ci, ce, co, expand, residual, pk_rows, dw_rows):
    """The same run's times of the units a served MobileNetV2 block runs
    instead (the expand and project through packed, each in its role's
    mode, the dw through dw): their sum and the units not among the rows
    (features.1's dw unit is bf16_codes)."""
    pk = {r["shape"]: r for r in pk_rows}
    dw = {r["shape"]: r for r in dw_rows}
    units = [("packed", (BATCH, h, h, ci, 1, ce), "site"),
             ("dw", (h, h, ce, 1), None),
             ("packed", (BATCH, h, h, ce, 1, co),
              "block codes" if residual else "block none")]
    if not expand:
        units = units[1:]
    total, missing = 0.0, []
    for kind, shape, role in units:
        row = (pk if kind == "packed" else dw).get(tuple(shape))
        t = None if row is None else (row["ms"] if role is None
                                      else row["ms"].get(role))
        if t is None:
            missing.append(f"{kind} {shape}")
        else:
            total += t
    return total, missing


def check_mbconv(torch, gen, mbconv, pk_rows, dw_rows):
    """mbconv kernel vs its plain version, torch.equal, at MobileNetV2's 8
    stride-1 block shapes at batch 256 (13 blocks), 4-bit and full-range
    8-bit (hi_e = hi_d = 255); launched on constants prepared once, timed
    by CUDA-graph replay with the eager time beside, beside the bound, the
    CUDA-core floor, cuDNN's bf16 convs of the block alone (expand 1x1,
    depthwise 3x3, project 1x1: three calls, two without an expand) and
    the same run's packed and dw rows of the block's units."""
    import torch.nn.functional as F
    rate, sms, mhz = cuda_core_rate(torch)
    print(f"  CUDA-core floor (a design estimate): {sms} SMs x 128 "
          f"lanes x {mhz:.0f} MHz = "
          f"{rate / 1e12:.2f} T instructions/s", flush=True)
    rows = []
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, h, ci, ce, co, expand, residual, count in MBCONV_SHAPES:
            kw = dict(has_expand=expand, has_residual=residual)
            for full in (True, False):
                args = _mbconv_args(torch, gen, h, ci, ce, co, full)
                k = mbconv.prepare_mbconv(*args[1:], **kw)
                got = mbconv.mbconv_fused_prepared(args[0], k)
                want = mbconv.mbconv_fused_plain(*args, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    n = int((got != want).sum())
                    raise AssertionError(f"mbconv {name} (full range "
                                         f"{full}): {n} codes differ")
            # timed on the 4-bit case
            x = args[0]
            ms = time_graph(lambda: mbconv.mbconv_fused_prepared(x, k))
            eager_ms = time_cuda(lambda: mbconv.mbconv_fused_prepared(x, k))
            plain_ms = time_cuda(lambda: mbconv.mbconv_fused_plain(
                *args, **kw), iters=2, warmup=1)
            xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)    # channels_last
            we = args[1].T.reshape(ce, ci, 1, 1).to(torch.bfloat16) \
                .contiguous(memory_format=torch.channels_last)
            wd = args[3].T.reshape(ce, 1, 3, 3).to(torch.bfloat16) \
                .contiguous(memory_format=torch.channels_last)
            wp = args[5].T.reshape(co, ce, 1, 1).to(torch.bfloat16) \
                .contiguous(memory_format=torch.channels_last)

            def convs():
                y = F.conv2d(xb, we) if expand else xb
                return F.conv2d(F.conv2d(y, wd, None, 1, 1, 1, ce), wp)

            conv_ms = time_graph(convs)
            pix = BATCH * h * h
            n_ops = 2 * pix * ((ci * ce if expand else 0) + 9 * ce + ce * co)
            b_ms, b_by = bound_ms(pix * (ci + co), n_ops, INT8_OPS)
            instr = MBCONV_DW_INSTR + (
                MBCONV_EXPAND_INSTR + MBCONV_KSTEP_INSTR * -(-ci // 32)
                if expand else 0.0)
            floor_ms = instr * pix * ce / rate * 1e3
            units_ms, missing = block_units_ms(h, ci, ce, co, expand,
                                               residual, pk_rows, dw_rows)
            print(f"  mbconv {name} (x{count}) {h}x{h} {ci}/{ce}/{co}: "
                  f"{ms:.4f} ms graph, {eager_ms:.4f} eager (bound "
                  f"{b_ms:.4f} ms by {b_by}; CUDA-core floor, a design estimate "
                  f"from counted source lines, {floor_ms:.4f} at {instr:g} "
                  f"instructions per expanded element; plain "
                  f"{plain_ms:.4f}, cuDNN bf16 convs alone "
                  f"({3 if expand else 2} calls) {conv_ms:.4f}; the served "
                  f"units packed + dw {units_ms:.4f}"
                  + (f", without {missing}" if missing else "")
                  + "), bit-exact 4-bit and full range", flush=True)
            rows.append(dict(name=name, shape=(h, ci, ce, co, expand,
                                               residual),
                             count=count, ms=ms, eager_ms=eager_ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             floor_ms=floor_ms, instr_per_element=instr,
                             convs_ms=conv_ms, units_ms=units_ms,
                             units_missing=missing, err=0.0))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return rows


def int8_conv_shapes(graph, plan):
    """{(H, W, C, N, kernel, stride, padding): {role: count}} of the dense
    units a plan sends through int8_conv."""
    return role_counts(
        graph, plan, ("int8", "bf16_codes"),
        lambda u, hw: (*hw, u.in_ch, u.out_ch, u.kernel[0], u.stride[0],
                       u.padding[0]))


def check_int8_conv(torch, gen, int_matmul, requant, deploy, shapes,
                    uniform_shapes):
    """int8_conv vs its plain version at each conv shape of the method
    path (``shapes``) and the uniform path at batch 256, 4-bit codes
    (8-bit biased ones with offset 128), W2 codes: one weight group (int32
    sums) and two masked per input channel with a scale table (f32), each
    with offset 0 and 128, torch.equal in sums mode and in every requant
    variant, each also against the same launch in sums mode followed by
    quantize_out. Timed in each role's mode and in sums mode at S = 2 (the
    method path) and S = 1 (uniform), beside the bound (the bytes the mode
    reads and writes once, or all S groups' int8 operations), S cuDNN bf16
    channels-last convs on the same codes (the library yardstick) and the
    im2col + torch._int_mm route (a yardstick)."""
    import torch.nn.functional as F
    dev = DEVICE
    ctx = requant_context(torch, deploy, dev)
    rows = []
    for key in sorted(set(shapes) | set(uniform_shapes), reverse=True):
        h, w, c, n, k, st, p = key
        geom = ((k, k), (st, st), (p, p))
        kk = k * k * c
        ho, wo = (h + 2 * p - k) // st + 1, (w + 2 * p - k) // st + 1
        m = BATCH * ho * wo
        x4 = torch.randint(-8, 8, (BATCH, h, w, c), generator=gen,
                           device=dev, dtype=torch.int8)
        x8 = torch.randint(-128, 128, (BATCH, h, w, c), generator=gen,
                           device=dev, dtype=torch.int8)
        # symmetric weights: the biased feed's centered codes are >= 0
        w1 = torch.randint(-2, 3, (1, n, kk), generator=gen, device=dev,
                           dtype=torch.int8)
        sel = torch.randint(0, 2, (c,), generator=gen, device=dev) \
            .repeat(k * k)                    # group of each K position
        w2 = torch.stack([torch.where(sel == s, w1[0], 0) for s in (0, 1)]) \
            .to(torch.int8).contiguous()
        delta = torch.tensor(0.37, device=dev)
        label = f"int8_conv {h}x{w}x{c}->{n} k{k}/s{st}"
        ms, bytes_, rqs_by = {}, {}, {}
        res = None
        for s_n, wm in ((1, w1), (2, w2)):
            for offset in (0, 128):
                x = x8 if offset else x4
                spread = (209.0 if offset else 6.6) * math.sqrt(kk)
                scale, bias = _scaled(torch, gen, n, dev, spread)
                table = None if s_n == 1 else torch.stack(
                    [scale * 0.5, scale]) / delta
                off = offset * wm.sum(dim=2, dtype=torch.int32) \
                    if offset else None
                kw = dict(pad_value=-offset, group_scales=table,
                          act_delta=delta, acc_offset=off)
                got = int_matmul.int8_conv(x, wm, *geom, **kw)
                want = int_matmul.int8_conv_plain(x, wm, *geom, **kw)
                torch.cuda.synchronize()
                if got.dtype != want.dtype or not torch.equal(got, want):
                    raise AssertionError(f"{label} S={s_n} offset {offset}: "
                                         "sums differ from the plain version")
                if res is None:
                    res = residuals(torch, gen, got.shape, dev)
                pend = deploy._Pending(got.float(), scale, bias) \
                    if s_n == 1 else deploy._Pending(got, None, bias)
                rqs = check_requant_modes(
                    torch, deploy, requant, f"{label} S={s_n} offset "
                    f"{offset}",
                    lambda rq: int_matmul.int8_conv(x, wm, *geom,
                                                    requant=rq, **kw),
                    want.float(), pend, res, ctx)
                if offset:
                    continue
                rqs_by[s_n] = rqs
                tag = "S=2" if s_n == 2 else "S=1"
                base = BATCH * h * w * c + s_n * n * kk
                ms[(tag, "sums")] = time_graph(
                    lambda: int_matmul.int8_conv(x, wm, *geom, **kw))
                bytes_[(tag, "sums")] = base + 4 * m * n + 4 * s_n * n
                roles = (shapes if s_n == 2 else uniform_shapes).get(key, {})
                for role in roles:
                    if role == "sums":
                        continue
                    rq = rqs[ROLE_VARIANT[role]]
                    ms[(tag, role)] = time_graph(
                        lambda: int_matmul.int8_conv(x, wm, *geom,
                                                     requant=rq, **kw))
                    bytes_[(tag, role)] = base + m * n + 4 * s_n * n \
                        + {"block codes": m * n,
                           "block f32": 4 * m * n}.get(role, 0)
        plain_ms = time_cuda(lambda: int_matmul.int8_conv_plain(
            x4, w2, *geom, group_scales=table, act_delta=delta), iters=3,
            warmup=1)
        xb = x4.permute(0, 3, 1, 2).to(torch.bfloat16)     # channels_last
        wbs = [w2[s].reshape(n, k, k, c).permute(0, 3, 1, 2)
               .to(torch.bfloat16) for s in range(2)]
        lib = {"S=1": time_graph(lambda: F.conv2d(xb, wbs[0], None, st, p)),
               "S=2": time_graph(lambda: [F.conv2d(xb, wb, None, st, p)
                                          for wb in wbs])}
        mm_ms = time_cuda(lambda: torch._int_mm(
            int_matmul.im2col(x4, *geom, 0)[0], w1[0].t()), iters=5)
        bound = {kr: bound_ms(nb, 2 * m * n * kk * (2 if kr[0] == "S=2"
                                                    else 1), INT8_OPS)
                 for kr, nb in bytes_.items()}
        print(f"  {label} (method {shapes.get(key, {})}, uniform "
              f"{uniform_shapes.get(key, {})}): " + ", ".join(
                  f"{t} {r} {v:.4f} ms (bound {bound[(t, r)][0]:.4f} by "
                  f"{bound[(t, r)][1]})" for (t, r), v in ms.items())
              + f"; plain (S=2) {plain_ms:.4f}, cuDNN bf16 S=1 "
              f"{lib['S=1']:.4f} / S=2 {lib['S=2']:.4f}, im2col + _int_mm "
              f"{mm_ms:.4f}; sums and {len(rqs_by[1])} requant variants "
              "bit-exact at S = 1, 2 and offsets 0, 128", flush=True)
        rows.append(dict(
            shape=key, roles=shapes.get(key, {}),
            uniform_roles=uniform_shapes.get(key, {}),
            ms={r: v for (t, r), v in ms.items() if t == "S=2"},
            ms_s1={r: v for (t, r), v in ms.items() if t == "S=1"},
            bound_ms={r: v[0] for (t, r), v in bound.items() if t == "S=2"},
            bound_s1_ms={r: v[0] for (t, r), v in bound.items()
                         if t == "S=1"},
            bound_by={r: v[1] for (t, r), v in bound.items() if t == "S=2"},
            plain_ms=plain_ms, library_ms=lib["S=2"],
            library_s1_ms=lib["S=1"], im2col_int_mm_ms=mm_ms, err=0.0))
    return rows


def act_site_shapes(graph, params, qstate, cfg, x1, batch):
    """{(rows, C): count} of the act sites of the sim forward at ``batch``
    images, read from a forward of one image."""
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, \
        forward_multi_capture
    sites = list(Q.act_quant_sites(graph, cfg))
    caps = forward_multi_capture(graph, params, qstate, x1, {}, sites,
                                 Flags(), device=x1.device)
    shapes = {}
    for _, out in caps.values():
        c = out.shape[-1]
        key = (batch * out[0].numel() // c, c)
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def _pin_codes(torch, gen, x, d, z, hi, share=0.2):
    """x with ``share`` of its elements moved onto exact codes, the clip
    bounds and two steps beyond them included."""
    codes = torch.randint(-2, hi + 3, x.shape, generator=gen,
                          device=x.device).float()
    pin = torch.rand(x.shape, generator=gen, device=x.device) < share
    return torch.where(pin, (codes - z) * d, x)


def check_fake_quant(torch, gen, fq, act_shapes):
    """fake_quant_2d vs its plain version, bit-exact: 4-bit per-tensor at
    each act site shape, the stem's 8-bit and a W2 per-row weight shape,
    and a ragged (10, 130). Timed beside the bound (8 bytes per element)
    and torch.fake_quantize_per_tensor_affine / _per_channel_affine (a
    yardstick: they multiply by the reciprocal)."""
    dev = DEVICE
    cases = [(f"act {r}x{c}", r, c, n, False, 4)
             for (r, c), n in sorted(act_shapes.items(), reverse=True)]
    cases += [("weight stem 64x147, 8-bit", 64, 147, 1, True, 8),
              ("weight layer4 conv2 512x4608, W2", 512, 4608, 0, True, 2),
              ("ragged 10x130", 10, 130, 0, True, 4)]
    rows = []
    for name, r, c, count, per_row, bits in cases:
        hi = 2 ** bits - 1
        if per_row:
            d = torch.rand((r, 1), generator=gen, device=dev) * 0.3 + 0.05
            z = torch.randint(0, hi + 1, (r, 1), generator=gen,
                              device=dev).float()
        else:
            d = torch.full((1, 1), 0.37, device=dev)
            z = torch.zeros((1, 1), device=dev)
        x = _pin_codes(torch, gen, torch.randn((r, c), generator=gen,
                                               device=dev) * 2, d, z, hi)
        got = fq.fake_quant_2d(x, d, z, 0, hi)
        want = fq.fake_quant_plain(x, d, z, 0, hi)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = float((got - want).abs().max())
            raise AssertionError(f"fake_quant {name}: max abs err {err}")
        ms = time_cuda(lambda: fq.fake_quant_2d(x, d, z, 0, hi))
        plain_ms = time_cuda(lambda: fq.fake_quant_plain(x, d, z, 0, hi),
                             iters=5)
        zi = z.to(torch.int32)
        if per_row:
            lib_ms = time_cuda(lambda: torch.fake_quantize_per_channel_affine(
                x, d.reshape(-1), zi.reshape(-1), 0, 0, hi))
        else:
            lib_ms = time_cuda(lambda: torch.fake_quantize_per_tensor_affine(
                x, d.reshape(()), zi.reshape(()), 0, hi))
        b_ms, b_by = bound_ms(8 * r * c + 8 * d.numel(), 6 * r * c,
                              F32_FLOPS)
        print(f"  fake_quant {name} (x{count}): {ms:.4f} ms (bound "
              f"{b_ms:.4f} ms by {b_by}, plain {plain_ms:.4f}, torch "
              f"fake_quantize {lib_ms:.4f}), bit-exact", flush=True)
        rows.append(dict(name=name, shape=(r, c), count=count, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by, err=0.0))
    return rows


def check_fake_quant_grad(torch, gen, fq):
    """The autograd Function's backward on the card (fake_quant_act and
    fake_quant_weight) against autograd through the plain version, a fifth
    of the elements on exact codes: grad x equal, grad delta and zp within
    GRAD_RTOL of the largest."""
    dev = DEVICE
    rows = []
    for kind, shape, bits in (("act", (64, 28, 28, 128), 4),
                              ("weight", (512, 256, 3, 3), 2)):
        hi = 2 ** bits - 1
        if kind == "act":
            d = torch.tensor(0.37, device=dev)
            z = torch.tensor(2.0, device=dev)
            db, zb = d, z
        else:
            d = torch.rand((shape[0], 1), generator=gen, device=dev) * 0.3 \
                + 0.05
            z = torch.randint(0, hi + 1, (shape[0], 1), generator=gen,
                              device=dev).float()
            db, zb = d.reshape(-1, 1, 1, 1), z.reshape(-1, 1, 1, 1)
        x = _pin_codes(torch, gen, torch.randn(shape, generator=gen,
                                               device=dev) * 2, db, zb, hi)
        g = torch.randn(shape, generator=gen, device=dev)
        grads = []
        for route in ("kernel", "plain"):
            xt, dt, zt = (t.clone().requires_grad_(True) for t in (x, d, z))
            if route == "plain":
                y = fq.fake_quant_plain(xt, dt.reshape(db.shape),
                                        zt.reshape(zb.shape), 0, hi)
            elif kind == "act":
                y = fq.fake_quant_act(xt, dt, zt, bits)
            else:
                y = fq.fake_quant_weight(xt, dt, zt, bits, False)
            (y * g).sum().backward()
            grads.append((xt.grad, dt.grad, zt.grad))
        torch.cuda.synchronize()
        (gx, gd, gz), (rx, rd, rz) = grads
        ties = int(((rx / g - 0.5).abs() < 1e-6).sum())
        if not torch.equal(gx, rx) or ties == 0:
            raise AssertionError(f"fake_quant backward {kind}: grad x "
                                 f"differs or no tie ({ties})")
        errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in ((gd, rd), (gz, rz))]
        print(f"  fake_quant backward {kind} {tuple(shape)}: grad x equal "
              f"({ties} elements at a clip bound), grad delta / zp rel err "
              f"{errs[0]:.3g} / {errs[1]:.3g} (gate {GRAD_RTOL:g})",
              flush=True)
        if max(errs) > GRAD_RTOL:
            raise AssertionError(f"fake_quant backward {kind}: {errs}")
        rows.append(dict(kind=kind, shape=shape, ties=ties,
                         delta_rel_err=errs[0], zp_rel_err=errs[1]))
    return rows


def trace_means(metrics):
    """{phase: (first-10 mean, last-10 mean)} of a target's traces."""
    out = {}
    for phase_name, tr in (("warm start", metrics.get("warmstart", {})
                            .get("rec_trace")),
                           ("joint", metrics.get("rec_trace")),
                           ("refine", metrics.get("refine_trace"))):
        if tr is not None:
            out[phase_name] = (float(tr[:10].mean()), float(tr[-10:].mean()))
    return out


def logit_rel_mse(torch, got, want):
    g, w = got.double(), want.double()
    return float(((g - w) ** 2).mean() / (w ** 2).mean().clamp_min(1e-30))


def to_cpu(torch, deploy, dparams, steps):
    """The deploy state moved to the CPU, for the plain-version deploy."""
    def unit(d):
        return deploy.DeployUnit(**{k: (v.cpu() if torch.is_tensor(v)
                                        else v)
                                    for k, v in d.__dict__.items()})
    return ({k: unit(d) for k, d in dparams.items()},
            {k: (d.cpu(), z.cpu(), n) for k, (d, z, n) in steps.items()})


def first_target_probe(torch, engine, capture, graph, params, qstate, cali,
                       target, settings):
    """The first target reconstructed twice as the pipeline will (same
    settings, all calibration rows), before the timed pipeline, each run
    under torch.profiler (host activity; a first, empty session pays the
    profiler's own start-up). The first run pays what a process pays once,
    which the pipeline's timing then leaves out. Returns, per run, its
    seconds, the process's host CPU seconds, the caching allocator's
    retries and device allocations, the sum of op self times and the ops
    with the most self time."""
    from torch.profiler import ProfilerActivity, profile
    from shiftedscalequantization_tpu_torch.graph import Flags
    ci, co = capture.capture_io(graph, params, qstate, target, cali, Flags(),
                                Flags(), batch_size=64, device="cuda")
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_stats()
        t, c = time.perf_counter(), time.process_time()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            engine.reconstruct_node(graph, params, qstate, target, ci, co,
                                    settings, seed=0)
            torch.cuda.synchronize()
        sec, cpu = time.perf_counter() - t, time.process_time() - c
        mem1 = torch.cuda.memory_stats()
        ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                     reverse=True)
        runs.append(dict(
            s=sec, cpu_s=cpu,
            alloc_retries=mem1["num_alloc_retries"]
            - mem0["num_alloc_retries"],
            device_allocs=mem1["num_device_alloc"] - mem0["num_device_alloc"],
            ops_self_s=sum(e.self_cpu_time_total for e in ops) / 1e6,
            top=[(e.key, e.self_cpu_time_total / 1e6, e.count)
                 for e in ops[:6]]))
    return runs


def margin_reading(torch, sim, dep):
    """How close the sim logits' top two sit, against the deploy-vs-sim
    difference, both over the logits' standard deviation: the medians,
    the images whose margin is below twice their largest difference (only
    these can change top-1) and those that did."""
    s, d = sim.double(), dep.double()
    sd = float(s.std())
    top2 = s.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]) / sd
    diff = (d - s).abs().amax(-1) / sd
    return dict(median_margin=float(margin.median()),
                median_max_diff=float(diff.median()),
                can_flip=int((margin < 2 * diff).sum()),
                flipped=int((s.argmax(-1) != d.argmax(-1)).sum()),
                images=int(s.shape[0]))


def kernel_counters():
    """Every kernel wrapper of the port that counts its launches."""
    from shiftedscalequantization_tpu_torch.ops.cuda import depthwise, \
        dw_conv, fake_quant, group_conv, int_matmul, mbconv, packed, stem
    return (stem.stem_fused, packed.packed_quant_matmul, int_matmul.int8_conv,
            int_matmul.quant_matmul, depthwise.dw_conv3x3_int8,
            mbconv.mbconv_fused, fake_quant.fake_quant_2d,
            fake_quant.fake_quant_act, fake_quant.fake_quant_weight,
            group_conv.int8_group_conv, dw_conv.dw_conv_int8)


def reset_counts():
    from shiftedscalequantization_tpu_torch import deploy
    for fn in kernel_counters():
        fn.launches = 0
    deploy.quantize_out.unfused = 0


def counts():
    """Each kernel's launches, and ``unfused``: the requants deploy left
    to PyTorch elementwise ops."""
    from shiftedscalequantization_tpu_torch import deploy
    return {**{fn.__name__: fn.launches for fn in kernel_counters()},
            "unfused": deploy.quantize_out.unfused}


def check_unfused(got, path):
    """Fail unless a path's deploy forward left UNFUSED[path] requants to
    PyTorch elementwise ops."""
    if got != UNFUSED[path]:
        raise AssertionError(f"{path}: {got} requants left to PyTorch "
                             f"elementwise, want {UNFUSED[path]}")


def check_counts(got, **want):
    """Fail unless each named kernel was launched the wanted times."""
    seen = {k: got[k] for k in want}
    if seen != want:
        raise AssertionError(f"kernel launches {seen}, want {want}")


def recon_phases(torch, gen):
    """Phases 16-19: the paper's reconstruction flow (the CLI's --mode
    fused) on ImageNet ResNet-18 W2A4 at full width, then the sim forward
    and deploy of its result. Returns what the result lines report."""
    from shiftedscalequantization_tpu_torch import deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, find_node, \
        forward, iter_units, node_unit_names
    from shiftedscalequantization_tpu_torch.models import zoo
    from shiftedscalequantization_tpu_torch.recon import capture, engine, \
        pipeline

    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    rg, _ = zoo.build("resnet18", dataset="imagenet")
    rcfg = Q.QuantConfig(n_bits_w=2, n_bits_a=4)
    rparams, rqs = Q.prepare_model(
        rg, zoo.init_params(rg, seed=1, device="cuda"), rcfg, device="cuda")
    cali = torch.randn((RECON_IMAGES, HW, HW, 3), generator=gen, device="cuda")
    wflags = Flags().all_weights(rg)
    reset_counts()
    rqs = Q.calibrate_acts(rg, rparams, rqs, cali[:RECON_CAL_ROWS], rcfg,
                           flags=wflags, device="cuda")
    sync()
    cal_counts = counts()
    print(f"  setup ({RECON_IMAGES} images, prepare_model, calibration on "
          f"{RECON_CAL_ROWS}) {time.perf_counter() - t0:.2f} s; fake_quant "
          f"launches in "
          f"the calibration: act {cal_counts['fake_quant_act']}, weight "
          f"{cal_counts['fake_quant_weight']}", flush=True)
    phase("recon setup", t0)

    t0 = time.perf_counter()
    targets = Q.reconstruction_targets(rg)
    settings = engine.ReconSettings(
        mode="fused", iters=RECON_ITERS, batch_size=RECON_BATCH,
        shift_targets=SHIFT_TARGETS, warmstart_frac=0.25,
        post_round_frac=0.5)
    pre_qs = rqs
    recon_rows = []

    def on_done(name, qs, m, prefix):
        means = trace_means(m)
        losses = {k: float(m[k]) for k in ("init_loss", "soft_loss",
                                            "hard_loss_prerefine",
                                            "hard_loss") if k in m}
        ratios = {u: (r if isinstance(r, str) else
                      [round(float(v), 4) for v in r])
                  for u, r in m["selection_ratio"].items()}
        row = dict(target=name, capture_s=m["capture_s"],
                   recon_s=m["recon_s"],
                   steps_per_s=RECON_ITERS / m["recon_s"], **losses,
                   traces=means, selection_ratio=ratios)
        recon_rows.append(row)
        print(f"  {name}: capture {m['capture_s']:.3f} s, {RECON_ITERS} "
              f"steps in {m['recon_s']:.3f} s ({row['steps_per_s']:.1f} "
              f"steps/s); loss before {losses['init_loss']:.6g}, soft "
              f"{losses['soft_loss']:.6g}, hard {losses['hard_loss']:.6g}"
              + (f" (before refine {losses['hard_loss_prerefine']:.6g})"
                 if "hard_loss_prerefine" in losses else "") + "; traces "
              + ", ".join(f"{k} {a:.6g} -> {b:.6g}"
                          for k, (a, b) in means.items())
              + f"; selection {ratios}", flush=True)

    probe = first_target_probe(torch, engine, capture, rg, rparams, rqs,
                               cali, targets[0], settings)
    for i, r in enumerate(probe):
        print(f"  untimed probe {i + 1} of {targets[0]} ({RECON_ITERS} "
              f"steps, host profiler): {r['s']:.3f} s, host CPU "
              f"{r['cpu_s']:.3f} s, allocator retries {r['alloc_retries']}, "
              f"device allocations {r['device_allocs']}, op self time "
              f"{r['ops_self_s']:.3f} s; top ops " + ", ".join(
                  f"{k} {t:.4f} s x{n}" for k, t, n in r["top"]),
              flush=True)
    t0 = time.perf_counter()
    reset_counts()
    rqs, hist, prefix = pipeline.reconstruct_model(
        rg, rparams, rqs, targets, cali, settings, seed=0, batch_size=64,
        device="cuda", on_node_done=on_done)
    sync()
    recon_counts = counts()
    recon_s = time.perf_counter() - t0
    print(f"  {len(targets)} targets in {recon_s:.2f} s; kernel launches "
          f"during reconstruction {recon_counts}", flush=True)
    if [r["target"] for r in recon_rows] != targets or len(targets) != 9:
        raise AssertionError(f"targets {targets}")
    for r in recon_rows:
        vals = [v for k, v in r.items() if k.endswith("loss")] \
            + [v for ab in r["traces"].values() for v in ab]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{r['target']}: a loss is not finite")
        for k, (first, last) in r["traces"].items():
            if not last <= first:
                raise AssertionError(f"{r['target']} {k} trace rose: "
                                     f"{first} -> {last}")
    phase("reconstruction", t0)

    t0 = time.perf_counter()
    pt = "model.layer4.1"
    pflags = Flags(weight_on=frozenset(
        u for t in targets[:targets.index(pt)]
        for u in node_unit_names(find_node(rg, t))))
    ci, co = capture.capture_io(rg, rparams, rqs, pt, cali[:PARITY_ROWS],
                                pflags, Flags(), batch_size=64,
                                device="cuda")
    s_par = dataclasses.replace(settings, iters=PARITY_ITERS)
    qs_card, m_card = engine.reconstruct_node(rg, rparams, pre_qs, pt, ci,
                                              co, s_par, seed=5)
    sync()
    t1 = time.perf_counter()
    qs_cpu, m_cpu = engine.reconstruct_node(
        rg, Q.to_device(rparams, "cpu"), Q.to_device(pre_qs, "cpu"), pt,
        ci.cpu(), co.cpu(), s_par, seed=5)
    cpu_s = time.perf_counter() - t1
    par = {}
    for key, a, b in (("warm start", m_card["warmstart"]["rec_trace"],
                       m_cpu["warmstart"]["rec_trace"]),
                      ("joint", m_card["rec_trace"], m_cpu["rec_trace"]),
                      ("refine", m_card["refine_trace"],
                       m_cpu["refine_trace"])):
        a = a.cpu().double()
        b = b.double()
        par[key] = float(((a - b).abs() / b.abs()).max())
    flips = {}
    for u in node_unit_names(find_node(rg, pt)):
        wc, wh = qs_card[u].wq, qs_cpu[u].wq
        flips[u] = max(
            float((wc.st_index.cpu() != wh.st_index).float().mean()),
            float(((wc.alpha.cpu() >= 0) != (wh.alpha >= 0)).float()
                  .mean()))
    print(f"  {pt}, {PARITY_ROWS} rows, {PARITY_ITERS} steps, card vs CPU "
          f"({cpu_s:.2f} s on the CPU): trace max rel diff "
          + ", ".join(f"{k} {v:.3g}" for k, v in par.items())
          + f" (gate {PARITY_RTOL:g}); hardened code flips "
          + ", ".join(f"{u.split('.')[-1]} {v:.4g}" for u, v in flips.items())
          + f" (gate {PARITY_FLIPS:g})", flush=True)
    if max(par.values()) > PARITY_RTOL or max(flips.values()) > PARITY_FLIPS:
        raise AssertionError(f"card vs CPU reconstruction: {par} {flips}")
    phase("recon parity", t0)

    t0 = time.perf_counter()
    rqs = Q.calibrate_acts(rg, rparams, rqs, cali[:RECON_CAL_ROWS], rcfg,
                           flags=prefix, device="cuda")
    aflags = Q.act_flags(rg, rcfg, base=wflags)
    rx = torch.randn((BATCH, HW, HW, 3), generator=gen, device="cuda")
    n_sites = len(Q.act_quant_sites(rg, rcfg))
    n_uniform = sum(type(rqs[u.name].wq).__name__ == "UniformWQ"
                    for u in iter_units(rg))
    reset_counts()
    rsim = forward(rg, rparams, rqs, rx, aflags, device="cuda")
    sync()
    sim_counts = counts()
    print(f"  launches in one sim forward: {sim_counts} ({n_sites} act "
          f"sites, {n_uniform} UniformWQ unit)", flush=True)
    want = dict.fromkeys(sim_counts, 0)
    want.update(fake_quant_act=17, fake_quant_weight=1)
    if sim_counts != want or n_sites != 17 or n_uniform != 1:
        raise AssertionError(f"sim forward launches {sim_counts}")
    sim_ms = time_cuda(
        lambda: forward(rg, rparams, rqs, rx, aflags, device="cuda"),
        iters=3, warmup=1)
    os.environ.update(SSQ_STEM_KERNEL="1", SSQ_PACKED="1", SSQ_DW_KERNEL="0",
                      SSQ_STEM_1PASS="0")
    rdp = deploy.build_deploy_params(rg, rparams, rqs, device="cuda")
    rsteps = deploy.act_steps_from_qstate(rg, rqs)
    rplan = deploy.make_deploy_plan(rg, rdp, rsteps, input_hw=(HW, HW))
    rkinds = [v[0] for k, v in rplan.items() if not k.startswith("__")]
    rcounts = {k: rkinds.count(k) for k in sorted(set(rkinds))}
    if (rcounts.get("stem_fused"), rcounts.get("float"),
            rcounts.get("int8", 0) + rcounts.get("bf16_codes", 0)) \
            != (1, 1, 19):
        raise AssertionError(f"recon plan kinds {rcounts}")
    reset_counts()
    rdep = deploy.deploy_forward(rg, rdp, rsteps, rx, plan=rplan,
                                 device="cuda")
    sync()
    dep_counts = counts()
    check_counts(dep_counts, int8_conv=19, stem_fused=1)
    check_unfused(dep_counts["unfused"], "resnet18_reconstructed")
    if not (bool(torch.isfinite(rsim).all())
            and bool(torch.isfinite(rdep).all())):
        raise AssertionError("recon sim or deploy logits not finite")
    r_rel = logit_rel_mse(torch, rdep, rsim)
    r_agree = float((rsim.argmax(-1) == rdep.argmax(-1)).double().mean())
    r_margin = margin_reading(torch, rsim, rdep)
    rdeploy_ms = time_cuda(lambda: deploy.deploy_forward(
        rg, rdp, rsteps, rx, plan=rplan, device="cuda"), iters=5, warmup=1)
    rxg = torch.round(rx[:8] * 8) / 8
    rcard = deploy.deploy_forward(rg, rdp, rsteps, rxg, plan=rplan,
                                  device="cuda")
    rdp_cpu, rsteps_cpu = to_cpu(torch, deploy, rdp, rsteps)
    rhost = deploy.deploy_forward(rg, rdp_cpu, rsteps_cpu, rxg.cpu(),
                                  plan=rplan, device="cpu")
    rc_rel = logit_rel_mse(torch, rcard.cpu(), rhost)
    rc_same = bool(torch.equal(rcard.cpu().argmax(-1), rhost.argmax(-1)))
    rratios = engine.selection_ratios(rqs, Q.unit_order(rg))
    rgroups = sum(rqs[n].wq.st_index.numel() for n in rratios)
    roverall = [sum(float(r[i]) * rqs[n].wq.st_index.numel()
                    for n, r in rratios.items()) / rgroups
                for i in range(len(SHIFT_TARGETS))]
    print(f"  plan kinds {rcounts}; deploy launches int8_conv "
          f"{dep_counts['int8_conv']}, stem {dep_counts['stem_fused']}, "
          f"requants left to PyTorch elementwise {dep_counts['unfused']}; "
          f"sim forward {sim_ms:.3f} ms/batch, deploy forward "
          f"{rdeploy_ms:.3f} ms/batch; deploy vs sim: logit rel-MSE "
          f"{r_rel:.4e} (gate {RELMSE_GATE:g}), top-1 agreement "
          f"{r_agree:.4f} (margins {r_margin}); card vs CPU deploy on 8 "
          f"grid images: rel-MSE "
          f"{rc_rel:.4e} (gate {CARD_CPU_GATE:g}), same top-1 {rc_same}; "
          f"selection ratios over {rgroups} groups: " + ", ".join(
              f"{t:g}: {r:.4f}" for t, r in zip(SHIFT_TARGETS, roverall)),
          flush=True)
    if not r_rel <= RELMSE_GATE:
        raise AssertionError(f"recon parity gate failed: rel-MSE {r_rel}")
    if not (rc_rel <= CARD_CPU_GATE and rc_same):
        raise AssertionError(f"recon card vs CPU deploy: rel-MSE {rc_rel}, "
                             f"same top-1 {rc_same}")
    phase("recon serving", t0)
    return dict(cal_counts=cal_counts, recon_rows=recon_rows,
                recon_s=recon_s, par=par, flips=flips, cpu_s=cpu_s,
                rcounts=rcounts, sim_counts=sim_counts, sim_ms=sim_ms,
                unfused=dep_counts["unfused"],
                rdeploy_ms=rdeploy_ms, r_rel=r_rel, r_agree=r_agree,
                r_margin=r_margin, probe=probe,
                rc_rel=rc_rel, roverall=roverall)


CLI_COMMON = ["--arch", "resnet18", "--dataset", "imagenet",
              "--synthetic_data", "true", "--n_bits_w", "2", "--n_bits_a", "4"]
# the three CLI runs of phase 20 (ImageNet ResNet-18 W2A4 at full width,
# synthetic data: 512 train and 256 test images)
CLI_RUNS = [
    ("fused", ["--mode", "fused", "--iters_w", "200", "--num_samples", "256",
               "--batch_size", "64", "--skip_test", "false"]),
    ("brecq", ["--mode", "brecq", "--iters_w", "200", "--iters_a", "200",
               "--num_samples", "128", "--batch_size", "64",
               "--skip_test", "true"]),
    ("two_phase", ["--mode", "two_phase", "--iters_w", "100",
                   "--num_samples", "128", "--shift_targets", "0.5,1.0",
                   "--skip_test", "true"]),
]


class _Tee:
    """stdout that also keeps what was written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def act_delta_parity(torch, Q, engine, rec):
    """The act-delta phase of ACT_PARITY_TARGET from what the brecq run's
    pipeline gave it (``rec``), ACT_PARITY_ITERS steps on the card and on
    the CPU with the same rows. Returns (max rel diff of rec_trace, of
    the learned deltas, CPU seconds)."""
    from shiftedscalequantization_tpu_torch.graph import find_node, \
        node_unit_names
    s = dataclasses.replace(rec["settings"], iters=ACT_PARITY_ITERS)
    args = (rec["graph"], rec["params"], rec["qstate"], ACT_PARITY_TARGET)
    qs_card, m_card = engine.reconstruct_act_delta(
        *args, rec["ci"], rec["co"], s, seed=rec["seed"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    qs_cpu, m_cpu = engine.reconstruct_act_delta(
        rec["graph"], Q.to_device(rec["params"], "cpu"),
        Q.to_device(rec["qstate"], "cpu"), ACT_PARITY_TARGET,
        rec["ci"].cpu(), rec["co"].cpu(), s, seed=rec["seed"])
    cpu_s = time.perf_counter() - t

    def rel(a, b):
        a, b = a.detach().cpu().double(), b.detach().double()
        return float(((a - b).abs() / b.abs()).max())

    units = node_unit_names(find_node(rec["graph"], ACT_PARITY_TARGET))

    def deltas(qs):
        out = [qs[u].aq.delta for u in units if qs[u].aq is not None]
        if qs.get(ACT_PARITY_TARGET) is not None:
            out.append(qs[ACT_PARITY_TARGET].delta)
        return out

    trace = rel(m_card["rec_trace"], m_cpu["rec_trace"])
    learned = max(rel(a, b) for a, b in zip(deltas(qs_card),
                                             deltas(qs_cpu)))
    return trace, learned, cpu_s


def cli_phases(torch):
    """Phases 20-21: the port's CLI driven in-process (cli.main) for the
    three runs of CLI_RUNS, then run 1's final checkpoint served. Returns
    what the result lines report."""
    import tempfile
    import numpy as np
    from shiftedscalequantization_tpu_torch import cli, deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, forward
    from shiftedscalequantization_tpu_torch.recon import engine
    from shiftedscalequantization_tpu_torch.recon import pipeline
    from shiftedscalequantization_tpu_torch.utils import checkpoint as ck
    from shiftedscalequantization_tpu_torch.utils.config import load_args
    sync = _sync

    # what the brecq run's pipeline gives ACT_PARITY_TARGET's act phase
    act_rec = {}
    act_phase = pipeline.reconstruct_act_delta

    def record_act_phase(graph, params, qstate, name, ci, co, s, **kw):
        if name == ACT_PARITY_TARGET:
            act_rec.update(graph=graph, params=params, qstate=qstate, ci=ci,
                           co=co, settings=s, seed=kw["seed"])
        return act_phase(graph, params, qstate, name, ci, co, s, **kw)

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    runs = {}
    for name, flags in CLI_RUNS:
        argv = CLI_COMMON + flags + [
            "--checkpoint_dir", os.path.join(tmp.name, name),
            "--log_path", os.path.join(tmp.name, f"{name}.log"),
            "--golden_dir", os.path.join(tmp.name, f"{name}_golden")]
        pipeline.reconstruct_act_delta = record_act_phase
        try:
            wall, final, hard, out, launches = _run_cli(torch, name, argv)
        finally:
            pipeline.reconstruct_act_delta = act_phase
        logits = np.load(os.path.join(tmp.name, f"{name}_golden",
                                      "result_2bit.npz"))["logits"]
        drift = [ln for ln in out.splitlines()
                 if ln.startswith("act-phase delta drift")]
        qs, done = ck.load_qstate(
            os.path.join(tmp.name, name, "QNN_W2_A4"), device=DEVICE)
        deltas = cli._act_deltas(qs)
        runs[name] = dict(
            wall_s=wall, final=final, hard_loss=hard,
            fake_quant_act=launches["fake_quant_act"],
            fake_quant_weight=launches["fake_quant_weight"],
            logits_shape=list(logits.shape),
            logits_finite=bool(np.isfinite(logits).all()),
            drift=drift[0] if drift else None, done=len(done),
            min_act_delta=min(deltas.values()))
        print(f"  cli run {name}: {wall:.2f} s; final {final}; fake_quant "
              f"launches act {launches['fake_quant_act']}, weight "
              f"{launches['fake_quant_weight']}; hard losses "
              + ", ".join(f"{k.removeprefix('model.')} {v:.6g}"
                          for k, v in hard.items())
              + f"; final logits {tuple(logits.shape)} finite "
              f"{runs[name]['logits_finite']}; act drift "
              f"{runs[name]['drift']}; smallest act delta "
              f"{runs[name]['min_act_delta']:.6g}", flush=True)
        if len(hard) != 9 or len(done) != 9:
            raise AssertionError(f"cli {name}: targets {list(hard)}, done "
                                 f"{len(done)}")
        if not all(math.isfinite(v) for v in hard.values()) \
                or not runs[name]["logits_finite"] \
                or logits.shape[0] != BATCH:
            raise AssertionError(f"cli {name}: a hard loss or final logit "
                                 f"is not finite ({hard}, {logits.shape})")
        if not (launches["fake_quant_act"] > 0
                and launches["fake_quant_weight"] > 0):
            raise AssertionError(f"cli {name}: fake_quant not launched "
                                 f"{launches}")
        if min(deltas.values()) <= 0 or (drift and "NON-POSITIVE"
                                         in drift[0]):
            raise AssertionError(f"cli {name}: a non-positive act delta")
        if name == "brecq" and not drift:
            raise AssertionError("cli brecq: no act-delta phase ran")
    if not act_rec:
        raise AssertionError(f"no act-delta phase of {ACT_PARITY_TARGET}")
    act_trace, act_deltas, act_cpu_s = act_delta_parity(torch, Q, engine,
                                                        act_rec)
    act_rows = act_rec["ci"].shape[0]
    act_rec.clear()
    print(f"  {ACT_PARITY_TARGET} act-delta phase from the brecq run's "
          f"state and {act_rows}-row caches, {ACT_PARITY_ITERS} steps, card "
          f"vs CPU ({act_cpu_s:.2f} s on the CPU): rec_trace max rel diff "
          f"{act_trace:.3g}, learned deltas {act_deltas:.3g} (gate "
          f"{PARITY_RTOL:g})", flush=True)
    if max(act_trace, act_deltas) > PARITY_RTOL:
        raise AssertionError(f"card vs CPU act-delta phase: trace "
                             f"{act_trace}, deltas {act_deltas}")
    phase("cli runs", t0)

    # run 1's final checkpoint served at batch 256
    t0 = time.perf_counter()
    args = load_args(CLI_COMMON + CLI_RUNS[0][1])
    graph, raw, cfg = cli.build_everything(args, device=DEVICE)
    params, _ = Q.prepare_model(graph, raw, cfg, device=DEVICE)
    qs, done = ck.load_qstate(os.path.join(tmp.name, "fused", "QNN_W2_A4"),
                              device=DEVICE)
    _, test = cli.build_data(args)
    x = torch.as_tensor(np.concatenate([b for b, _ in test]), device=DEVICE)
    tmp.cleanup()
    aflags = Q.act_flags(graph, cfg, base=Flags().all_weights(graph))
    sim = forward(graph, params, qs, x, aflags, device=DEVICE)
    os.environ.update(SSQ_STEM_KERNEL="1", SSQ_PACKED="1", SSQ_DW_KERNEL="0",
                      SSQ_STEM_1PASS="0")
    dp = deploy.build_deploy_params(graph, params, qs, device=DEVICE)
    steps = deploy.act_steps_from_qstate(graph, qs)
    plan = deploy.make_deploy_plan(graph, dp, steps, input_hw=(HW, HW))
    kinds = [v[0] for k, v in plan.items() if not k.startswith("__")]
    kind_counts = {k: kinds.count(k) for k in sorted(set(kinds))}
    reset_counts()
    dep = deploy.deploy_forward(graph, dp, steps, x, plan=plan, device=DEVICE)
    sync()
    dep_counts = counts()
    finite = bool(torch.isfinite(sim).all()) and bool(
        torch.isfinite(dep).all())
    rel = logit_rel_mse(torch, dep, sim)
    agree = float((sim.argmax(-1) == dep.argmax(-1)).double().mean())
    print(f"  served the fused run's checkpoint ({len(done)} targets done): "
          f"batch {x.shape[0]}, plan kinds {kind_counts}, deploy launches "
          f"{ {k: v for k, v in dep_counts.items() if v} }; deploy vs sim "
          f"logit rel-MSE {rel:.4e} (gate {RELMSE_GATE:g}), top-1 agreement "
          f"{agree:.4f}, finite {finite}", flush=True)
    if not (finite and rel <= RELMSE_GATE) or x.shape[0] != BATCH:
        raise AssertionError(f"cli checkpoint serving: rel-MSE {rel}, "
                             f"finite {finite}")
    phase("cli serving", t0)
    return dict(runs=runs, act_parity=dict(
                    target=ACT_PARITY_TARGET, rows=act_rows,
                    steps=ACT_PARITY_ITERS, trace_rel=act_trace,
                    deltas_rel=act_deltas, cpu_s=act_cpu_s),
                serve_rel_mse=rel, serve_top1_agreement=agree,
                serve_plan_kinds=kind_counts,
                serve_launches={k: v for k, v in dep_counts.items() if v})


# ---------------------------------------------------------------------------
# RegNetX-600M, the grouped int8 conv kernel, int8_pair (phases 22-27)
# ---------------------------------------------------------------------------

def plan_counts(plan):
    kinds = [v[0] for k, v in plan.items() if not k.startswith("__")]
    return {k: kinds.count(k) for k in sorted(set(kinds))}


def serving_env(**env):
    """The SSQ_* switches at the JAX package's defaults, then ``env``."""
    os.environ.update(SSQ_STEM_KERNEL="0", SSQ_PACKED="0", SSQ_DW_KERNEL="0",
                      SSQ_STEM_1PASS="1")
    os.environ.update(env)


def group_conv_shapes(graph, plan):
    """{(H, W, C, N, G, kernel, stride, padding): {role: count}} of the
    grouped units a plan sends through int8_group_conv."""
    shapes = role_counts(
        graph, plan, ("int8", "bf16_codes", "int8_pair"),
        lambda u, hw: (*hw, u.in_ch, u.out_ch, u.groups, u.kernel[0],
                       u.stride[0], u.padding[0]) if u.groups > 1 else None)
    shapes.pop(None, None)
    return shapes


def dense_int_shapes(graph, plan):
    """{(H, W, C, N, kernel, stride, padding, offset): count} of the units
    a plan sends through int8_conv (int8_bd densified, int8_pair with
    offset 128; a linear unit as 1x1 rows)."""
    from shiftedscalequantization_tpu_torch.graph import iter_units
    from shiftedscalequantization_tpu_torch import deploy
    hw = deploy._unit_in_hw(graph, (HW, HW))
    out = {}
    for u in iter_units(graph):
        kind = plan[u.name][0]
        if kind not in ("int8", "bf16_codes", "int8_bd", "int8_pair") \
                or (u.groups > 1 and kind != "int8_bd"):
            continue
        geo = (1, 1, 0) if u.kind == "linear" else \
            (u.kernel[0], u.stride[0], u.padding[0])
        key = ((1, 1) if u.kind == "linear" else hw[u.name]) + (
            u.in_ch, u.out_ch, *geo, 128 if kind == "int8_pair" else 0)
        out[key] = out.get(key, 0) + 1
    return out


def _group_case(torch, gen, b, h, w, c, n, g, k, s_n):
    """Codes (4-bit centered, and the int8 range for offset 128) and W2
    codes for S weight groups masked per input channel of a conv group."""
    cg = c // g
    kk = k * k * cg
    x4 = torch.randint(-8, 8, (b, h, w, c), generator=gen, device=DEVICE,
                       dtype=torch.int8)
    x8 = torch.randint(-128, 128, (b, h, w, c), generator=gen,
                       device=DEVICE, dtype=torch.int8)
    # symmetric weights: the biased feed's centered codes are >= 0
    w1 = torch.randint(-2, 3, (1, n, kk), generator=gen, device=DEVICE,
                       dtype=torch.int8)
    sel = torch.randint(0, s_n, (cg,), generator=gen, device=DEVICE) \
        .repeat(k * k)                        # group of each K position
    ws = torch.stack([torch.where(sel == s, w1[0], 0)
                      for s in range(s_n)]).to(torch.int8).contiguous()
    return x4, x8, w1, ws, kk


def check_group_conv(torch, gen, gc, requant, deploy, shapes, uniform_shapes):
    """int8_group_conv vs its plain version at each grouped shape of the
    baked (``shapes``, S = 2) and uniform (S = 1) RegNetX-600M plans at
    batch 256, 4-bit codes (offset 0) and the int8 range (offset 128):
    torch.equal in sums mode (int32 at S = 1, the f32 scale-table sum at
    S = 2) and in every requant variant, each also against the same
    launch in sums mode followed by quantize_out. Timed by CUDA-graph
    replay in each role's mode and in sums mode (eager beside), next to
    the bound (the bytes the mode reads and writes once, or all S groups'
    int8 operations) and S cuDNN bf16 grouped convs on the same codes (the
    library yardstick)."""
    import torch.nn.functional as F
    ctx = requant_context(torch, deploy, DEVICE)
    rows = []
    for key in sorted(set(shapes) | set(uniform_shapes), reverse=True):
        h, w, c, n, g, k, st, p = key
        geom = ((k, k), (st, st), (p, p))
        ho, wo = (h + 2 * p - k) // st + 1, (w + 2 * p - k) // st + 1
        m = BATCH * ho * wo
        x4, x8, w1, w2, kk = _group_case(torch, gen, BATCH, h, w, c, n, g, k,
                                         2)
        delta = torch.tensor(0.37, device=DEVICE)
        label = f"int8_group_conv {h}x{w}x{c}->{n} G{g} k{k}/s{st}"
        ms, eager, bytes_, res = {}, {}, {}, None
        for s_n, wm in ((1, w1), (2, w2)):
            for offset in (0, 128):
                x = x8 if offset else x4
                spread = (209.0 if offset else 6.6) * math.sqrt(kk)
                scale, bias = _scaled(torch, gen, n, DEVICE, spread)
                table = None if s_n == 1 else torch.stack(
                    [scale * 0.5, scale]) / delta
                off = offset * wm.sum(dim=2, dtype=torch.int32) \
                    if offset else None
                kw = dict(pad_value=-offset, group_scales=table,
                          act_delta=delta, acc_offset=off)
                got = gc.int8_group_conv(x, wm, *geom, g, **kw)
                want = gc.int8_group_conv_plain(x, wm, *geom, g, **kw)
                torch.cuda.synchronize()
                if got.dtype != want.dtype or not torch.equal(got, want):
                    raise AssertionError(f"{label} S={s_n} offset {offset}: "
                                         "sums differ from the plain version")
                if res is None:
                    res = residuals(torch, gen, got.shape, DEVICE)
                pend = deploy._Pending(got.float(), scale, bias) \
                    if s_n == 1 else deploy._Pending(got, None, bias)
                rqs = check_requant_modes(
                    torch, deploy, requant,
                    f"{label} S={s_n} offset {offset}",
                    lambda rq: gc.int8_group_conv(x, wm, *geom, g,
                                                  requant=rq, **kw),
                    want.float(), pend, res, ctx)
                if offset:
                    continue
                tag = f"S={s_n}"
                base = BATCH * h * w * c + s_n * n * kk
                fn = lambda: gc.int8_group_conv(x, wm, *geom, g,  # noqa
                                                **kw)
                ms[(tag, "sums")] = time_graph(fn)
                eager[(tag, "sums")] = time_cuda(fn)
                bytes_[(tag, "sums")] = base + 4 * m * n + 4 * s_n * n
                roles = (shapes if s_n == 2 else uniform_shapes).get(key, {})
                for role in roles:
                    rq = rqs[ROLE_VARIANT[role]]
                    fn = lambda: gc.int8_group_conv(  # noqa: E731
                        x, wm, *geom, g, requant=rq, **kw)
                    ms[(tag, role)] = time_graph(fn)
                    eager[(tag, role)] = time_cuda(fn)
                    bytes_[(tag, role)] = base + m * n + 4 * s_n * n
        plain_ms = time_cuda(lambda: gc.int8_group_conv_plain(
            x4, w2, *geom, g, group_scales=table, act_delta=delta),
            iters=3, warmup=1)
        xb = x4.permute(0, 3, 1, 2).to(torch.bfloat16)     # channels_last
        wbs = [w2[s].reshape(n, k, k, c // g).permute(0, 3, 1, 2)
               .to(torch.bfloat16) for s in range(2)]
        lib = {"S=1": time_graph(lambda: F.conv2d(xb, wbs[0], None, st, p,
                                                  1, g)),
               "S=2": time_graph(lambda: [F.conv2d(xb, wb, None, st, p, 1, g)
                                          for wb in wbs])}
        bound = {kr: bound_ms(nb, 2 * m * n * kk * int(kr[0][-1]), INT8_OPS)
                 for kr, nb in bytes_.items()}
        print(f"  {label} (baked {shapes.get(key, {})}, uniform "
              f"{uniform_shapes.get(key, {})}): " + ", ".join(
                  f"{t} {r} {v:.4f} ms (eager {eager[(t, r)]:.4f}; bound "
                  f"{bound[(t, r)][0]:.4f} by {bound[(t, r)][1]})"
                  for (t, r), v in ms.items())
              + f"; plain (S=2) {plain_ms:.4f}, cuDNN bf16 grouped S=1 "
              f"{lib['S=1']:.4f} / S=2 {lib['S=2']:.4f}; sums and "
              f"{len(REQUANT_VARIANTS)} requant variants bit-exact at S = 1, "
              "2 and offsets 0, 128", flush=True)
        rows.append(dict(
            shape=key, roles=shapes.get(key, {}),
            uniform_roles=uniform_shapes.get(key, {}),
            ms={r: v for (t, r), v in ms.items() if t == "S=2"},
            ms_s1={r: v for (t, r), v in ms.items() if t == "S=1"},
            eager_ms={r: v for (t, r), v in eager.items() if t == "S=2"},
            eager_s1_ms={r: v for (t, r), v in eager.items() if t == "S=1"},
            bound_ms={r: v[0] for (t, r), v in bound.items() if t == "S=2"},
            bound_s1_ms={r: v[0] for (t, r), v in bound.items()
                         if t == "S=1"},
            bound_by={r: v[1] for (t, r), v in bound.items() if t == "S=2"},
            bound_s1_by={r: v[1] for (t, r), v in bound.items()
                         if t == "S=1"},
            plain_ms=plain_ms, library_ms=lib["S=2"],
            library_s1_ms=lib["S=1"], err=0.0))
    return rows


def check_group_conv_odd(torch, gen, gc, requant, deploy):
    """The grouped kernel at GROUP_ODD_SHAPES: torch.equal with the plain
    version in sums mode (int32 at S = 1, the scale-table sum at the
    shape's S) and every requant variant, offsets 0 and 128."""
    ctx = requant_context(torch, deploy, DEVICE)
    for b, h, w, c, n, g, k, st, p, s_top in GROUP_ODD_SHAPES:
        geom = ((k, k), (st, st), (p, p))
        x4, x8, w1, ws, kk = _group_case(torch, gen, b, h, w, c, n, g, k,
                                         s_top)
        label = f"int8_group_conv {h}x{w}x{c}->{n} G{g} k{k}/s{st}"
        delta = torch.tensor(0.37, device=DEVICE)
        res = None
        for s_n, wm in ((1, w1), (s_top, ws)):
            for offset in (0, 128):
                x = x8 if offset else x4
                scale, bias = _scaled(torch, gen, n, DEVICE, (
                    209.0 if offset else 6.6) * math.sqrt(kk))
                table = None if s_n == 1 else torch.stack(
                    [scale * (0.5 + 0.25 * s) for s in range(s_n)]) / delta
                kw = dict(pad_value=-offset, group_scales=table,
                          act_delta=delta,
                          acc_offset=offset * wm.sum(dim=2, dtype=torch.int32)
                          if offset else None)
                got = gc.int8_group_conv(x, wm, *geom, g, **kw)
                want = gc.int8_group_conv_plain(x, wm, *geom, g, **kw)
                torch.cuda.synchronize()
                if got.dtype != want.dtype or not torch.equal(got, want):
                    raise AssertionError(f"{label} S={s_n} offset {offset}: "
                                         "sums differ from the plain version")
                if res is None:
                    res = residuals(torch, gen, got.shape, DEVICE)
                pend = deploy._Pending(got.float(), scale, bias) \
                    if s_n == 1 else deploy._Pending(got, None, bias)
                check_requant_modes(
                    torch, deploy, requant,
                    f"{label} S={s_n} offset {offset}",
                    lambda rq: gc.int8_group_conv(x, wm, *geom, g,
                                                  requant=rq, **kw),
                    want.float(), pend, res, ctx)
        plan = gc.group_conv_launch_plan(b, h, w, c, n, g, (k, k), (st, st),
                                         (p, p), s_top)
        print(f"  {label} batch {b} (Cg {c // g}, OC/G {n // g}; tiles of "
              f"{plan.ni} images x {plan.th} rows, {plan.gb} groups a "
              f"block, {plan.cw}-byte copies): sums and "
              f"{len(REQUANT_VARIANTS)} requant variants bit-exact at S = 1, "
              f"{s_top} and offsets 0, 128", flush=True)


def check_dense_int(torch, gen, int_matmul, shapes, label):
    """int8_conv vs its plain version at each dense integer shape of a
    path at batch 256 (int8_bd units on their block-diagonal operand, a
    linear unit as 1x1 rows), in the path's mode: 4-bit codes, or the int8
    range with offset 128 for int8_pair, int32 sums and the scale-table
    sum of two weight groups, torch.equal."""
    for (h, w, c, n, k, st, p, offset), count in sorted(shapes.items()):
        geom = ((k, k), (st, st), (p, p))
        lo = -128 if offset else -8
        x = torch.randint(lo, -lo, (BATCH, h, w, c), generator=gen,
                          device=DEVICE, dtype=torch.int8)
        wm = torch.randint(-2, 3, (2, n, k * k * c), generator=gen,
                           device=DEVICE, dtype=torch.int8)
        off = offset * wm.sum(dim=2, dtype=torch.int32) if offset else None
        table = torch.rand((2, n), generator=gen, device=DEVICE) * 0.02
        for kw in (dict(acc_offset=None if off is None else off[:1]),
                   dict(acc_offset=off, group_scales=table,
                        act_delta=torch.tensor(0.37, device=DEVICE))):
            wk = wm if "group_scales" in kw else wm[:1].contiguous()
            got = int_matmul.int8_conv(x, wk, *geom, pad_value=-offset, **kw)
            want = int_matmul.int8_conv_plain(x, wk, *geom,
                                              pad_value=-offset, **kw)
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(
                    f"int8_conv {h}x{w}x{c}->{n} k{k}/s{st} offset {offset} "
                    f"({label}): differs from the plain version")
    print(f"  int8_conv at the {len(shapes)} dense integer shapes of "
          f"{label} ({sum(shapes.values())} units): int32 and scale-table "
          "sums bit-exact", flush=True)


def serve_state(torch, deploy, Q, forward, Flags, name, setup, x, launches,
                unfused_key):
    """One deploy forward at batch 256 with the counters reset just before
    it, gated on its launches and requants left; its time; the sim
    forward (TF32 off) against it; card vs CPU deploy on 8 grid images.
    Returns what the result lines report."""
    graph, cfg, params, qstate, dparams, steps = setup
    plan = deploy.make_deploy_plan(graph, dparams, steps, input_hw=(HW, HW))
    reset_counts()
    logits = deploy.deploy_forward(graph, dparams, steps, x, plan=plan,
                                   device=DEVICE)
    torch.cuda.synchronize()
    got = counts()
    pairs = dict(deploy.pair_stats)
    unfused = got.pop("unfused")
    print(f"  {name}: launches in one deploy forward "
          f"{ {k: v for k, v in got.items() if v} }; requants left to "
          f"PyTorch elementwise: {unfused}", flush=True)
    check_counts(got, **launches)
    check_unfused(unfused, unfused_key)
    if tuple(logits.shape) != (BATCH, 1000) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: deploy logits not finite or "
                             "misshapen")
    dep_ms = time_cuda(lambda: deploy.deploy_forward(
        graph, dparams, steps, x, plan=plan, device=DEVICE), iters=5,
        warmup=1)
    flags = Q.act_flags(graph, cfg, base=Flags().all_weights(graph))
    reset_counts()
    sim = forward(graph, params, qstate, x, flags, device=DEVICE)
    torch.cuda.synchronize()
    sim_launches = {k: v for k, v in counts().items() if v}
    finite = bool(torch.isfinite(sim).all())
    rel = logit_rel_mse(torch, logits, sim)
    agree = float((sim.argmax(-1) == logits.argmax(-1)).double().mean())
    xg = torch.round(x[:8] * 8) / 8
    card = deploy.deploy_forward(graph, dparams, steps, xg, plan=plan,
                                 device=DEVICE)
    cdp, csteps = to_cpu(torch, deploy, dparams, steps)
    host = deploy.deploy_forward(graph, cdp, csteps, xg.cpu(), plan=plan,
                                 device="cpu")
    c_rel = logit_rel_mse(torch, card.cpu(), host)
    same = bool(torch.equal(card.cpu().argmax(-1), host.argmax(-1)))
    jgap = JAX_GAP.get(unfused_key)
    print(f"  {name}: deploy forward batch {BATCH} {dep_ms:.3f} ms/batch; "
          f"deploy vs sim logit rel-MSE {rel:.4e} (gate {RELMSE_GATE:g}, "
          f"margin {RELMSE_GATE / max(rel, 1e-30):.1f}x; the JAX package's "
          f"own gap on this recipe "
          + ("not measured" if jgap is None else f"{jgap:.4e}")
          + f"), top-1 agreement {agree:.4f}, sim finite {finite}; card vs "
          f"CPU deploy on 8 grid images rel-MSE {c_rel:.4e} (gate "
          f"{CARD_CPU_GATE:g}), same top-1 {same}", flush=True)
    if not (finite and rel <= RELMSE_GATE):
        raise AssertionError(f"{name}: deploy vs sim rel-MSE {rel}, sim "
                             f"finite {finite}")
    if not (c_rel <= CARD_CPU_GATE and same):
        raise AssertionError(f"{name}: card vs CPU deploy rel-MSE {c_rel}, "
                             f"same top-1 {same}")
    return dict(plan=plan, launches={k: v for k, v in got.items() if v},
                sim_launches=sim_launches,
                pair_stats=pairs, unfused=unfused, deploy_ms=dep_ms,
                rel_mse=rel,
                top1_agreement=agree, card_cpu_rel_mse=c_rel,
                jax_gap=jgap)


def regnet_phases(torch, gen):
    """Phases 22-25: RegNetX-600M ImageNet W2A4 at full width in both
    states, the grouped kernel at its shapes, serving and parity."""
    from shiftedscalequantization_tpu_torch import deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, forward
    from shiftedscalequantization_tpu_torch.ops.cuda import group_conv as gc
    from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul, \
        requant
    t0 = time.perf_counter()
    serving_env()
    setups, plans, packed_counts, setup_s = {}, {}, {}, {}
    for state in ("uniform", "baked"):
        t = time.perf_counter()
        setups[state] = serving_setup(torch, gen, "regnetx_600m",
                                      shifted=state == "baked", host=True)
        graph, _, _, _, dparams, steps = setups[state]
        plans[state] = deploy.make_deploy_plan(graph, dparams, steps,
                                               input_hw=(HW, HW))
        serving_env(SSQ_PACKED="1")
        packed_counts[state] = plan_counts(deploy.make_deploy_plan(
            graph, dparams, steps, input_hw=(HW, HW)))
        serving_env()
        torch.cuda.synchronize()
        setup_s[state] = time.perf_counter() - t
        got = plan_counts(plans[state])
        print(f"  regnetx_600m {state}: setup (host-drawn weights, BN fold, "
              f"MSE scales, calibration on 16 images"
              + (", fused quantizers hardened" if state == "baked" else "")
              + f", deploy conversion) {setup_s[state]:.2f} s; plan kinds "
              f"{got} (JAX {REGNET_KINDS[state]}); with SSQ_PACKED=1 "
              f"{packed_counts[state]}", flush=True)
        if got != REGNET_KINDS[state]:
            raise AssertionError(f"regnetx_600m {state} plan kinds {got}, "
                                 f"want {REGNET_KINDS[state]}")
    gshapes = {s: group_conv_shapes(setups[s][0], plans[s])
               for s in plans}
    if sum(sum(r.values()) for r in gshapes["uniform"].values()) != 12 \
            or sum(sum(r.values()) for r in gshapes["baked"].values()) != 16:
        raise AssertionError(f"grouped shapes {gshapes}")
    phase("regnet setup", t0)

    t0 = time.perf_counter()
    g_rows = check_group_conv(torch, gen, gc, requant, deploy,
                              gshapes["baked"], gshapes["uniform"])
    check_group_conv_odd(torch, gen, gc, requant, deploy)
    dense = {s: dense_int_shapes(setups[s][0], plans[s]) for s in plans}
    for s in plans:
        check_dense_int(torch, gen, int_matmul, dense[s],
                        f"the {s} RegNetX-600M plan")
    phase("group conv kernel", t0)

    t0 = time.perf_counter()
    x = host_images(torch, BATCH, 2)
    served = {}
    for state in ("uniform", "baked"):
        served[state] = serve_state(
            torch, deploy, Q, forward, Flags, f"regnetx_600m {state}",
            setups[state], x, dict(REGNET_LAUNCHES[state],
                                   packed_quant_matmul=0, stem_fused=0,
                                   dw_conv3x3_int8=0),
            f"regnetx_600m_{state}")
        graph, _, params, qstate, dparams, steps = setups[state]
        serving_env(SSQ_PACKED="1")
        pplan = deploy.make_deploy_plan(graph, dparams, steps,
                                        input_hw=(HW, HW))
        reset_counts()
        deploy.deploy_forward(graph, dparams, steps, x, plan=pplan,
                              device=DEVICE)
        torch.cuda.synchronize()
        pk_launch = {k: v for k, v in counts().items()
                     if v and k != "unfused"}
        served[state]["packed_ms"] = time_cuda(
            lambda: deploy.deploy_forward(graph, dparams, steps, x,
                                          plan=pplan, device=DEVICE),
            iters=5, warmup=1)
        served[state]["packed_launches"] = pk_launch
        serving_env()
        params_bf16 = {u: {k: v.to(torch.bfloat16) for k, v in p.items()}
                       for u, p in params.items()}
        xb = x.to(torch.bfloat16)
        served[state]["bf16_ms"] = time_cuda(
            lambda: forward(graph, params_bf16, qstate, xb, Flags(),
                            device=DEVICE), iters=5, warmup=1)
        served[state]["plan"] = plan_counts(served[state]["plan"])
        print(f"  regnetx_600m {state}: under SSQ_PACKED=1 "
              f"{served[state]['packed_ms']:.3f} ms/batch (launches "
              f"{pk_launch}); the port's bf16 float forward "
              f"{served[state]['bf16_ms']:.3f} ms/batch", flush=True)
    phase("regnet serving + parity", t0)
    return dict(setup_s=setup_s, plan_kinds={s: plan_counts(p)
                                             for s, p in plans.items()},
                packed_plan_kinds=packed_counts, group_rows=g_rows,
                dense_shapes={s: len(d) for s, d in dense.items()},
                served=served)


def pair_phase(torch, gen):
    """Phase 26: ResNet-18 ImageNet W4A8 at full width under phase 4's
    switches: 13 int8_pair units (8-bit unsigned feeds as biased codes,
    offset 128) on int8_conv; served, gated and timed as RegNet is."""
    from shiftedscalequantization_tpu_torch import deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, forward
    from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul
    t0 = time.perf_counter()
    serving_env(SSQ_STEM_KERNEL="1", SSQ_PACKED="1", SSQ_STEM_1PASS="0")
    setup = serving_setup(torch, gen, "resnet18", bits=(4, 8), host=True)
    graph, _, _, _, dparams, steps = setup
    plan = deploy.make_deploy_plan(graph, dparams, steps, input_hw=(HW, HW))
    got = plan_counts(plan)
    print(f"  resnet18 W4A8: plan kinds {got}", flush=True)
    if got != R18_W4A8_KINDS:
        raise AssertionError(f"resnet18 W4A8 plan kinds {got}, want "
                             f"{R18_W4A8_KINDS}")
    check_dense_int(torch, gen, int_matmul, dense_int_shapes(graph, plan),
                    "ResNet-18 W4A8")
    x = host_images(torch, BATCH, 2)
    res = serve_state(torch, deploy, Q, forward, Flags, "resnet18 W4A8",
                      setup, x, dict(int8_conv=19, stem_fused=1,
                                     packed_quant_matmul=0,
                                     int8_group_conv=0), "resnet18_w4a8")
    res["plan"] = got
    serving_env()
    phase("int8_pair", t0)
    return res


def _cli_dict(line):
    import ast
    return ast.literal_eval(line[line.index("{"):line.index("}") + 1])


def regnet_cli_phases(torch):
    """Phase 27: the port's CLI on the trained RegNetX-600M, brecq then
    fused, each in its own process under REGNET_CLI_TIMEOUT_S; then each
    run's final state served on synth10's 2048 test images. Gates: FP
    top-1 equals the port CLI's on the CPU (PORT_CLI_FP_TOP1), brecq's
    final top-1 >= FP - 3 points, and deploy within 0.5 points of the sim
    top-1 of the same state."""
    import tempfile
    import numpy as np
    from shiftedscalequantization_tpu_torch import cli, deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.utils import checkpoint as ck
    from shiftedscalequantization_tpu_torch.utils.config import load_args
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory()
    env = dict(os.environ, PYTHONPATH=root)
    for k in ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
              "SSQ_DW_KERNEL"):
        env.pop(k, None)
    runs = {}
    common = [os.path.join(root, a) if a.endswith(".npz") else a
              for a in REGNET_CLI_COMMON]
    for mode, extra in REGNET_CLI_MODES.items():
        argv = common + extra + [
            "--mode", mode, "--checkpoint_dir", os.path.join(tmp.name, mode),
            "--log_path", os.path.join(tmp.name, f"{mode}.log")]
        print(f"  regnet cli {mode}: python -m "
              f"shiftedscalequantization_tpu_torch.cli {' '.join(argv)}",
              flush=True)
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "shiftedscalequantization_tpu_torch.cli",
             *argv], cwd=root, env=env, capture_output=True, text=True,
            timeout=REGNET_CLI_TIMEOUT_S)
        wall = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"regnet cli {mode}: exit "
                                 f"{proc.returncode}\n{proc.stdout[-4000:]}"
                                 f"\n{proc.stderr[-4000:]}")
        fp, per, final = None, {}, None
        for line in proc.stdout.splitlines():
            if line.startswith("accuracy of FP model:"):
                fp = _cli_dict(line)["top1"]
            elif line.startswith("accuracy of qnn_hard "):
                per[line.split()[3].rstrip(":")] = _cli_dict(line)["top1"]
            elif line.startswith("Final W"):
                final = _cli_dict(line)["top1"]
        # the final state served: the CLI's own graph, weights and data
        args = load_args(argv)
        graph, raw, cfg = cli.build_everything(args, device=DEVICE)
        params, _ = Q.prepare_model(graph, raw, cfg, device=DEVICE)
        qs, done = ck.load_qstate(os.path.join(tmp.name, mode, "QNN_W2_A4"),
                                  device=DEVICE)
        _, test = cli.build_data(args)
        batches = list(test)
        xs = np.concatenate([b for b, _ in batches])
        ys = np.concatenate([y for _, y in batches])
        x = torch.as_tensor(xs, device=DEVICE)
        serving_env()
        dp = deploy.build_deploy_params(graph, params, qs, device=DEVICE)
        steps = deploy.act_steps_from_qstate(graph, qs)
        plan = deploy.make_deploy_plan(graph, dp, steps,
                                       input_hw=tuple(xs.shape[1:3]))
        reset_counts()
        logits = torch.cat([deploy.deploy_forward(
            graph, dp, steps, x[i:i + BATCH], plan=plan, device=DEVICE)
            for i in range(0, x.shape[0], BATCH)])
        torch.cuda.synchronize()
        launches = {k: v for k, v in counts().items() if v}
        launches["unfused"] = launches.pop("unfused", 0)
        y = torch.as_tensor(ys, device=DEVICE)
        dep_top1 = float((logits.argmax(-1) == y).double().mean()) * 100
        runs[mode] = dict(wall_s=wall, fp_top1=fp, per_target=per,
                          final_top1=final, deploy_top1=dep_top1,
                          targets=len(done), images=int(x.shape[0]),
                          plan_kinds=plan_counts(plan),
                          deploy_launches=launches)
        print(f"  regnet cli {mode}: {wall:.2f} s; FP top-1 {fp} (the "
              f"port's CLI on the CPU {PORT_CLI_FP_TOP1}, the JAX CLI on its "
              f"own synth10 draws {JAX_CLI_FP_TOP1}); top-1 after each "
              "target "
              + ", ".join(f"{k.removeprefix('model.')} {v:.2f}"
                          for k, v in per.items())
              + f"; final {final}; deploy {dep_top1:.4f} on {x.shape[0]} "
              f"images (plan {plan_counts(plan)}, launches {launches}); "
              "ACCURACY_regnet_r4.md (JAX, brecq): FP 99.80, final 98.83, "
              "deploy 98.78", flush=True)
        if fp != PORT_CLI_FP_TOP1:
            raise AssertionError(f"regnet cli {mode}: FP top-1 {fp}, on the "
                                 f"CPU {PORT_CLI_FP_TOP1}")
        if final is None or len(per) != len(done) or not done:
            raise AssertionError(f"regnet cli {mode}: final {final}, "
                                 f"{len(per)} validations, {len(done)} "
                                 "targets done")
        if mode == "brecq" and final < fp - REGNET_FINAL_DROP:
            raise AssertionError(f"regnet cli brecq: final top-1 {final} < "
                                 f"FP {fp} - {REGNET_FINAL_DROP}")
        if abs(dep_top1 - final) > REGNET_DEPLOY_GAP:
            raise AssertionError(f"regnet cli {mode}: deploy top-1 "
                                 f"{dep_top1} vs sim {final}")
    tmp.cleanup()
    phase("regnet cli", t0)
    return runs


# ---------------------------------------------------------------------------
# the Fisher losses, the act-shift phase and the searches (phases 28-30)
# ---------------------------------------------------------------------------

FISHER_ROWS = 64                 # capture_grads and layer4.1's caches
FISHER_TARGETS = ("model.layer2.0", "model.layer3.0.conv1")
FISHER_GATE = 1e-3               # max|g_card - g_cpu| / max(g_cpu - 1)
FISHER_TIE = 1e-5                # a relu input this close to 0 (over its
                                 # row's max) is a tie
# phase 29: the port's CLI twice on ImageNet ResNet-18 W2A4 at full width
# (CLI_COMMON), 128 calibration rows and 100 steps a target
METHOD_CLI_RUNS = [
    ("fisher", ["--mode", "brecq", "--opt_mode", "fisher_diag",
                "--iters_w", "100", "--iters_a", "0", "--num_samples", "128",
                "--skip_test", "true"]),
    ("act_shift", ["--mode", "fused", "--act_quant", "true", "--act_mode",
                   "shift", "--iters_w", "100", "--iters_a", "100",
                   "--act_shift_targets", "1.0,0.5", "--num_samples", "128",
                   "--skip_test", "true"]),
]
# the JAX package's own deploy-vs-sim logit rel-MSE on an act-shift state
# of the phase 29 recipe (act_shift_parity_gap.py: 64 rows, 20 steps a
# target, 32 test images, on the CPU); below RELMSE_GATE, which stays
JAX_ACT_SHIFT_GAP = 8.688941575775322e-05
SEARCH_UNIT = "model.layer3.0.conv2"   # IC 256, 14x14
SEARCH_ROWS = 64
SEARCH_TIE = 1e-6                # relative gap of a pair's two losses
SEARCH_RTOL = 1e-3               # output greedy loss, card vs CPU


def _sync():
    """Wait for the card (no-op on the CPU, where DEVICE may point for a
    rehearsal of the phases)."""
    import torch
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def plan_launches(graph, plan):
    """The kernel launches one deploy forward takes for ``plan``'s kinds
    (deploy.run_unit's routes): stem_fused, dw_int8 and packed units one
    launch of their kernel each; the integer kinds one int8_conv launch
    (int8_group_conv for a grouped conv that is not densified), a
    depthwise one none."""
    from shiftedscalequantization_tpu_torch.graph import iter_units
    want = dict(stem_fused=0, dw_conv3x3_int8=0, packed_quant_matmul=0,
                int8_conv=0, int8_group_conv=0)
    route = {"stem_fused": "stem_fused", "dw_int8": "dw_conv3x3_int8",
             "packed": "packed_quant_matmul"}
    for u in iter_units(graph):
        kind = plan[u.name][0]
        if kind in route:
            want[route[kind]] += 1
        elif kind in ("int8", "bf16_codes", "int8_bd", "int8_pair"):
            if u.kind == "conv" and u.groups == u.in_ch == u.out_ch > 1:
                continue
            grouped = u.kind == "conv" and u.groups > 1 and kind != "int8_bd"
            want["int8_group_conv" if grouped else "int8_conv"] += 1
    return want


@contextlib.contextmanager
def relu_inputs(store):
    """Append to ``store`` every relu input on the gradient path
    (graph._activation while a tensor that requires grad passes)."""
    from shiftedscalequantization_tpu_torch import graph as G
    real = G._activation

    def act(name, x):
        if name == "relu" and x.requires_grad:
            store.append(x.detach().cpu())
        return real(name, x)

    G._activation = act
    try:
        yield store
    finally:
        G._activation = real


def sign_flips(torch, card, host, rows):
    """(relu sign changes per row, the largest |x| of a changed input
    over its row's max |x|) between two runs' relu_inputs."""
    flips = torch.zeros(rows, dtype=torch.long)
    tie = 0.0
    for a, b in zip(card, host):
        f = (a > 0) != (b > 0)
        flips += f.reshape(rows, -1).sum(1)
        if bool(f.any()):
            row_max = a.abs().reshape(rows, -1).amax(1).clamp_min(1e-30)
            rel = a.abs() / row_max.reshape((rows,) + (1,) * (a.ndim - 1))
            tie = max(tie, float(rel[f].max()))
    return flips, tie


def fisher_phase(torch, gen):
    """Phase 28: capture_grads and the Fisher reconstruction on the card
    against the CPU (the plain versions), ImageNet ResNet-18 W2A4 at full
    width. Returns what the result lines report and the state phase 30
    reuses."""
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, find_node, \
        forward, node_unit_names
    from shiftedscalequantization_tpu_torch.models import zoo
    from shiftedscalequantization_tpu_torch.recon import capture, engine
    sync = _sync
    t0 = time.perf_counter()
    g, _ = zoo.build("resnet18", dataset="imagenet")
    cfg = Q.QuantConfig(n_bits_w=2, n_bits_a=4)
    raw = zoo.init_params(g, seed=3, device=DEVICE)
    cali = torch.randn((FISHER_ROWS, HW, HW, 3), generator=gen,
                       device=DEVICE)
    # random weights saturate the softmax (logit std about 37: the KL's
    # gradient 1e-10, below f32's step at 1): the head is scaled to unit
    # logit std on these rows, as a trained net's softmax is soft
    fp = forward(g, *Q.prepare_model(g, raw, cfg, device=DEVICE), cali,
                 Flags(), device=DEVICE)
    head_scale = 1.0 / float(fp.std())
    raw["model.fc"]["w"] = raw["model.fc"]["w"] * head_scale
    del fp
    params, qs = Q.prepare_model(g, raw, cfg, device=DEVICE)
    cparams, cqs, ccali = (Q.to_device(params, "cpu"),
                           Q.to_device(qs, "cpu"), cali.cpu())
    grads = {}
    for target in FISHER_TARGETS:
        # damping 0: g - 1 exactly (f32 holds 1 + g to one ulp of 1);
        # relu inputs downstream of the target recorded in both runs; the
        # card's time taken by a run without the recording
        rc, rh = [], []
        sync()
        t = time.perf_counter()
        capture.capture_grads(g, params, qs, target, cali, batch_size=64,
                              device=DEVICE)
        sync()
        card_s = time.perf_counter() - t
        with relu_inputs(rc):
            card = capture.capture_grads(g, params, qs, target, cali,
                                         batch_size=64, damping=0.0,
                                         device=DEVICE)
        t = time.perf_counter()
        with relu_inputs(rh):
            host = capture.capture_grads(g, cparams, cqs, target, ccali,
                                         batch_size=64, damping=0.0,
                                         device="cpu")
        cpu_s = time.perf_counter() - t
        flips, tie = sign_flips(torch, rc, rh, FISHER_ROWS)
        del rc, rh
        damped = card + 1.0          # capture_grads' default damping
        signal = max(float(host.max()), 1e-30)
        rows = (card.cpu() - host).abs().reshape(FISHER_ROWS, -1) \
            .amax(1) / signal
        clean = rows[flips == 0]
        grads[target] = dict(
            shape=list(card.shape), card_s=card_s, cpu_s=cpu_s,
            signal=signal, max_err_rel=float(rows.max()),
            max_err_rel_rows_without_flip=float(clean.max())
            if clean.numel() else 0.0,
            rows_with_flips=int((flips > 0).sum()),
            relu_flips=int(flips.sum()), largest_flipped_input=tie,
            min_damped=float(damped.min()), max_damped=float(damped.max()))
        r = grads[target]
        print(f"  capture_grads {target} {tuple(card.shape)}: card "
              f"{card_s:.3f} s, CPU {cpu_s:.2f} s; max(g - 1) {signal:.4g}; "
              f"max|card - CPU| / max(g - 1) {r['max_err_rel']:.3g} over "
              f"all rows, {r['max_err_rel_rows_without_flip']:.3g} over the "
              f"{FISHER_ROWS - r['rows_with_flips']} rows where no relu "
              f"input changed sign (gate {FISHER_GATE:g}); "
              f"{r['relu_flips']} sign changes in {r['rows_with_flips']} "
              f"rows, the largest input |x| {tie:.3g} of its row's max "
              f"(gate {FISHER_TIE:g}); damped g in [{r['min_damped']:.9g}, "
              f"{r['max_damped']:.9g}]", flush=True)
        if not (r["min_damped"] >= 1.0 and r["max_damped"] > 1.0
                and r["max_err_rel_rows_without_flip"] <= FISHER_GATE
                and tie <= FISHER_TIE):
            raise AssertionError(f"capture_grads {target}: {r}")
    del card, host, damped
    phase("fisher grads", t0)

    t0 = time.perf_counter()
    pt = "model.layer4.1"
    ci, co = capture.capture_io(g, params, qs, pt, cali, Flags(), Flags(),
                                batch_size=64, device=DEVICE)
    gr = capture.capture_grads(g, params, qs, pt, cali, batch_size=64,
                               device=DEVICE)
    base = engine.ReconSettings(
        mode="fused", iters=PARITY_ITERS, batch_size=RECON_BATCH,
        shift_targets=SHIFT_TARGETS, warmstart_frac=0.25,
        post_round_frac=0.5)
    recon = {}
    for kind in ("fisher_diag", "fisher_full"):
        s = dataclasses.replace(base, rec_loss=kind)
        qs_card, m_card = engine.reconstruct_node(g, params, qs, pt, ci, co,
                                                  s, seed=7, cached_grads=gr)
        sync()
        t = time.perf_counter()
        qs_cpu, m_cpu = engine.reconstruct_node(
            g, cparams, cqs, pt, ci.cpu(), co.cpu(), s, seed=7,
            cached_grads=gr.cpu())
        cpu_s = time.perf_counter() - t
        par = {}
        for key, a, b in (("warm start", m_card["warmstart"]["rec_trace"],
                           m_cpu["warmstart"]["rec_trace"]),
                          ("joint", m_card["rec_trace"], m_cpu["rec_trace"]),
                          ("refine", m_card["refine_trace"],
                           m_cpu["refine_trace"])):
            a, b = a.cpu().double(), b.double()
            par[key] = float(((a - b).abs() / b.abs()).max())
        flips = {}
        for u in node_unit_names(find_node(g, pt)):
            wc, wh = qs_card[u].wq, qs_cpu[u].wq
            flips[u] = max(
                float((wc.st_index.cpu() != wh.st_index).float().mean()),
                float(((wc.alpha.cpu() >= 0) != (wh.alpha >= 0)).float()
                      .mean()))
        recon[kind] = dict(trace_rel=par, flips=flips, cpu_s=cpu_s,
                           hard_loss=float(m_card["hard_loss"]))
        print(f"  {pt} {kind}, {FISHER_ROWS} rows, {PARITY_ITERS} steps, "
              f"card vs CPU ({cpu_s:.2f} s on the CPU): trace max rel diff "
              + ", ".join(f"{k} {v:.3g}" for k, v in par.items())
              + f" (gate {PARITY_RTOL:g}); hardened code flips "
              + ", ".join(f"{u.split('.')[-1]} {v:.4g}"
                          for u, v in flips.items())
              + f" (gate {PARITY_FLIPS:g}); hard loss "
              f"{recon[kind]['hard_loss']:.6g}", flush=True)
        if max(par.values()) > PARITY_RTOL \
                or max(flips.values()) > PARITY_FLIPS:
            raise AssertionError(f"card vs CPU {kind}: {par} {flips}")
    phase("fisher recon parity", t0)
    return dict(head_scale=head_scale, grads=grads, recon=recon), \
        (g, params, qs, cali)


def _run_cli(torch, name, argv):
    """cli.main(argv) in this process, its lines printed: (wall seconds,
    final accuracy, {target: hard loss}, its standard output, kernel
    launches during the run)."""
    from shiftedscalequantization_tpu_torch import cli
    print(f"  cli run {name}: python -m "
          f"shiftedscalequantization_tpu_torch.cli {' '.join(argv)}",
          flush=True)
    tee = _Tee(sys.stdout)
    _sync()
    reset_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        final = cli.main(argv)
    _sync()
    wall = time.perf_counter() - t
    out = "".join(tee.parts)
    hard = {}
    for line in out.splitlines():
        if line.startswith("Reconstructed "):
            target, rest = line[len("Reconstructed "):].split(": ", 1)
            hard[target] = float(rest.split(" -> hard ")[1].split()[0])
    return wall, final, hard, out, counts()


def act_shift_sites(graph, qs, targets):
    """{site: ActShiftQuant or what stands there} of every act site of
    every target node (unit sites and block sites)."""
    from shiftedscalequantization_tpu_torch.graph import BlockSpec, \
        UnitQuant, find_node, node_unit_names
    out = {}
    for t in targets:
        node = find_node(graph, t)
        for u in node_unit_names(node):
            if isinstance(qs[u], UnitQuant) and qs[u].aq is not None:
                out[u] = qs[u].aq
        if isinstance(node, BlockSpec) and qs.get(t) is not None:
            out[t] = qs[t]
    return out


def cli_method_phases(torch, method_deploy_ms):
    """Phase 29: the port's CLI with the Fisher loss and with the
    act-shift phase (METHOD_CLI_RUNS), then the act-shift run's final
    checkpoint served at batch 256. Returns what the result lines
    report."""
    import tempfile
    import numpy as np
    from shiftedscalequantization_tpu_torch import cli, deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, forward, \
        iter_units
    from shiftedscalequantization_tpu_torch.ops.act_quant import \
        ActShiftQuant
    from shiftedscalequantization_tpu_torch.utils import checkpoint as ck
    from shiftedscalequantization_tpu_torch.utils.config import load_args
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    runs = {}
    for name, flags in METHOD_CLI_RUNS:
        argv = CLI_COMMON + flags + [
            "--checkpoint_dir", os.path.join(tmp.name, name),
            "--log_path", os.path.join(tmp.name, f"{name}.log")]
        wall, final, hard, _, launches = _run_cli(torch, name, argv)
        qs, done = ck.load_qstate(os.path.join(tmp.name, name, "QNN_W2_A4"),
                                  device=DEVICE)
        runs[name] = dict(wall_s=wall, final=final, hard_loss=hard,
                          done=len(done),
                          fake_quant_act=launches["fake_quant_act"],
                          fake_quant_weight=launches["fake_quant_weight"])
        print(f"  cli run {name}: {wall:.2f} s; final {final}; fake_quant "
              f"launches act {launches['fake_quant_act']}, weight "
              f"{launches['fake_quant_weight']}; hard losses "
              + ", ".join(f"{k.removeprefix('model.')} {v:.6g}"
                          for k, v in hard.items()), flush=True)
        if len(hard) != 9 or len(done) != 9 or not all(
                math.isfinite(v) for v in hard.values()):
            raise AssertionError(f"cli {name}: hard losses {hard}, done "
                                 f"{len(done)}")
    # qs: the act-shift run's final state (the last run)
    args = load_args(CLI_COMMON + METHOD_CLI_RUNS[1][1])
    graph, raw, cfg = cli.build_everything(args, device=DEVICE)
    targets = Q.reconstruction_targets(graph)
    sites = act_shift_sites(graph, qs, targets)
    hard_sites = [k for k, v in sites.items()
                  if isinstance(v, ActShiftQuant) and v.hard_targets]
    print(f"  act-shift run: {len(hard_sites)} of {len(sites)} act sites of "
          f"its {len(targets)} targets hold a hardened ActShiftQuant",
          flush=True)
    if len(hard_sites) != len(sites) or len(sites) != 16:
        raise AssertionError(f"act-shift sites {sorted(sites)}, hardened "
                             f"{sorted(hard_sites)}")
    phase("cli fisher and act-shift", t0)

    # the act-shift run's final checkpoint served at batch 256
    t0 = time.perf_counter()
    params, _ = Q.prepare_model(graph, raw, cfg, device=DEVICE)
    _, test = cli.build_data(args)
    x = torch.as_tensor(np.concatenate([b for b, _ in test]), device=DEVICE)
    tmp.cleanup()
    aflags = Q.act_flags(graph, cfg, base=Flags().all_weights(graph))
    n_cands = sum(len(v.shift_targets) if isinstance(v, ActShiftQuant)
                  else 1 for k, v in
                  ((k, getattr(qs.get(k), "aq", qs.get(k)))
                   for k in aflags.act_on) if v is not None)
    n_uniform = sum(type(qs[u.name].wq).__name__ == "UniformWQ"
                    for u in iter_units(graph))
    reset_counts()
    sim = forward(graph, params, qs, x, aflags, device=DEVICE)
    _sync()
    sim_counts = counts()
    print(f"  launches in one sim forward: {sim_counts} ({len(aflags.act_on)}"
          f" act sites, {n_cands} candidates, {n_uniform} UniformWQ unit)",
          flush=True)
    if n_cands != 2 * 16 + 1:
        raise AssertionError(f"act-shift sim forward: {n_cands} candidates")
    want = dict.fromkeys(sim_counts, 0)
    want.update(fake_quant_act=n_cands, fake_quant_weight=n_uniform)
    check_counts(sim_counts, **want)
    os.environ.update(SSQ_STEM_KERNEL="1", SSQ_PACKED="1", SSQ_DW_KERNEL="0",
                      SSQ_STEM_1PASS="0")
    dp = deploy.build_deploy_params(graph, params, qs, device=DEVICE)
    steps = deploy.act_steps_from_qstate(graph, qs)
    plan = deploy.make_deploy_plan(graph, dp, steps, input_hw=(HW, HW))
    dp_cpu, steps_cpu = to_cpu(torch, deploy, dp, steps)
    plan_cpu = deploy.make_deploy_plan(graph, dp_cpu, steps_cpu,
                                       input_hw=(HW, HW))
    units = [u.name for u in iter_units(graph)]
    kinds = [plan[u][0] for u in units]
    kind_counts = {k: kinds.count(k) for k in sorted(set(kinds))}
    if [plan[u] for u in units] != [plan_cpu[u] for u in units] \
            or plan["__int8_sites__"] != plan_cpu["__int8_sites__"]:
        raise AssertionError("act-shift plan differs from its CPU plan")
    per_channel = [k for k, v in steps.items() if v[0].numel() > 1]
    if set(per_channel) != set(sites) or set(per_channel) & (
            plan["__int8_sites__"] | plan["__biased_sites__"]):
        raise AssertionError(f"per-channel sites {sorted(per_channel)}")
    want_launches = plan_launches(graph, plan_cpu)
    xg = torch.round(x[:8] * 8) / 8
    reset_counts()
    host = deploy.deploy_forward(graph, dp_cpu, steps_cpu, xg.cpu(),
                                 plan=plan_cpu, device="cpu")
    want_unfused = counts()["unfused"]
    reset_counts()
    dep = deploy.deploy_forward(graph, dp, steps, x, plan=plan,
                                device=DEVICE)
    _sync()
    dep_counts = counts()
    print(f"  plan kinds {kind_counts} (equal to the CPU plan; "
          f"{len(per_channel)} per-channel sites); deploy launches "
          f"{ {k: v for k, v in dep_counts.items() if v} }, from the plan "
          f"{want_launches}, requants left to PyTorch elementwise "
          f"{dep_counts['unfused']} (CPU deploy {want_unfused})", flush=True)
    check_counts(dep_counts, **want_launches)
    if dep_counts["unfused"] != want_unfused:
        raise AssertionError(f"unfused {dep_counts['unfused']}, want "
                             f"{want_unfused}")
    finite = bool(torch.isfinite(sim).all()) and bool(
        torch.isfinite(dep).all())
    rel = logit_rel_mse(torch, dep, sim)
    agree = float((sim.argmax(-1) == dep.argmax(-1)).double().mean())
    deploy_ms = time_cuda(lambda: deploy.deploy_forward(
        graph, dp, steps, x, plan=plan, device=DEVICE), iters=3, warmup=1)
    card = deploy.deploy_forward(graph, dp, steps, xg, plan=plan,
                                 device=DEVICE)
    c_rel = logit_rel_mse(torch, card.cpu(), host)
    c_same = bool(torch.equal(card.cpu().argmax(-1), host.argmax(-1)))
    print(f"  served the act-shift run's checkpoint: batch {x.shape[0]}, "
          f"deploy forward {deploy_ms:.3f} ms/batch (the method path's, "
          f"phase 13: {method_deploy_ms:.3f}); deploy vs sim logit rel-MSE "
          f"{rel:.4e} (gate {RELMSE_GATE:g}; the JAX package's own on the "
          f"recipe {JAX_ACT_SHIFT_GAP:.4e}), top-1 agreement {agree:.4f}, "
          f"finite {finite}; card vs CPU deploy on 8 grid images: rel-MSE "
          f"{c_rel:.4e} (gate {CARD_CPU_GATE:g}), same top-1 {c_same}",
          flush=True)
    if not (finite and rel <= RELMSE_GATE) or x.shape[0] != BATCH:
        raise AssertionError(f"act-shift serving: rel-MSE {rel}, finite "
                             f"{finite}")
    if not (c_rel <= CARD_CPU_GATE and c_same):
        raise AssertionError(f"act-shift card vs CPU deploy: rel-MSE "
                             f"{c_rel}, same top-1 {c_same}")
    phase("act-shift serving", t0)
    return dict(runs=runs, sim_counts=sim_counts,
                act_shift_sites=len(sites), plan_kinds=kind_counts,
                launches={k: v for k, v in dep_counts.items() if v},
                deploy_ms=deploy_ms, deploy_sim_rel_mse=rel,
                deploy_sim_top1_agreement=agree, card_cpu_rel_mse=c_rel,
                jax_gap=JAX_ACT_SHIFT_GAP)


def search_phase(torch, state):
    """Phase 30: the selection searches on SEARCH_UNIT with SEARCH_ROWS
    cached rows, on the card and on the CPU."""
    from shiftedscalequantization_tpu_torch.graph import Flags, find_node
    from shiftedscalequantization_tpu_torch.recon import capture
    from shiftedscalequantization_tpu_torch.recon import search as S
    t0 = time.perf_counter()
    g, params, qs, cali = state
    spec = find_node(g, SEARCH_UNIT)
    ci, co = capture.capture_io(g, params, qs, SEARCH_UNIT,
                                cali[:SEARCH_ROWS], Flags(), Flags(),
                                batch_size=64, device=DEVICE)
    qp, w = qs[SEARCH_UNIT].wq.qp, params[SEARCH_UNIT]["w"]
    host = [dataclasses.replace(qp, delta=qp.delta.cpu(),
                                zero_point=qp.zero_point.cpu()), w.cpu()]
    out = {}

    def per_pair(cands, w, p):
        err = (cands.double() - w.double()[None]).abs() ** p
        return err.reshape(err.shape[:3] + (-1,)).sum(-1)

    # dist_selection's candidates: steps delta / qParam, qParam (1, 1/2)
    for name, targets, p in (("weight_greedy", SHIFT_TARGETS, 2.4),
                             ("dist", (1.0, 2.0), 2.0)):
        _sync()
        t = time.perf_counter()
        if name == "dist":
            sel, loss = S.dist_selection(qp, w)
            hsel, hloss = S.dist_selection(*host)
        else:
            sel, loss = S.weight_greedy_selection(
                w, S.candidate_weights(qp, w, targets), p=p)
            hsel, hloss = S.weight_greedy_selection(
                host[1], S.candidate_weights(*host, targets), p=p)
        _sync()
        sec = time.perf_counter() - t
        pp = per_pair(S.candidate_weights(*host, targets), host[1], p)
        tie = (pp[0] - pp[1]).abs() <= SEARCH_TIE * pp.abs().amax(0)
        diff = sel.cpu() != hsel
        out[name] = dict(s=sec, differ=int(diff.sum()),
                         differ_at_ties=int((diff & tie).sum()),
                         ties=int(tie.sum()), pairs=int(diff.numel()),
                         loss=float(loss), cpu_loss=float(hloss))
        print(f"  {name} {tuple(sel.shape)}: {sec:.3f} s (card and CPU); "
              f"{out[name]['differ']} of {diff.numel()} selections differ, "
              f"{out[name]['differ_at_ties']} of them at pairs whose losses "
              f"tie within {SEARCH_TIE:g} ({out[name]['ties']} such pairs)",
              flush=True)
        if bool((diff & ~tie).any()):
            raise AssertionError(f"{name} selections differ off ties")
    cands = S.candidate_weights(qp, w, SHIFT_TARGETS)
    hcands = cands.cpu()
    _sync()
    t = time.perf_counter()
    sel, loss = S.output_greedy_selection(spec, cands, ci, co, sweeps=1)
    _sync()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    hsel, hloss = S.output_greedy_selection(spec, hcands, ci.cpu(), co.cpu(),
                                            sweeps=1)
    cpu_s = time.perf_counter() - t
    base = S._unit_out(spec, S.apply_selection(
        cands, torch.zeros_like(sel)), ci)
    base_loss = float((torch.abs(base - co) ** 2).sum(-1).mean())
    rel = abs(float(loss) - float(hloss)) / abs(float(hloss))
    out["output_greedy"] = dict(
        card_s=card_s, cpu_s=cpu_s, loss=float(loss), cpu_loss=float(hloss),
        base_loss=base_loss, rel=rel,
        differ=int((sel.cpu() != hsel).sum()), pairs=int(sel.numel()))
    print(f"  output_greedy (one sweep over {spec.in_ch} input channels, "
          f"{SEARCH_ROWS} rows): card {card_s:.3f} s, CPU {cpu_s:.2f} s; "
          f"loss {float(loss):.6g} (all-base {base_loss:.6g}; CPU "
          f"{float(hloss):.6g}, rel diff {rel:.3g}, gate {SEARCH_RTOL:g}); "
          f"{out['output_greedy']['differ']} selections differ", flush=True)
    if not (float(loss) <= base_loss and rel <= SEARCH_RTOL):
        raise AssertionError(f"output greedy: {out['output_greedy']}")
    phase("search", t0)
    return out


# ---------------------------------------------------------------------------
# MNASNet, pair transport, the integer depthwise kernel (phases 31-33)
# ---------------------------------------------------------------------------

# phase 31: ImageNet MNASNet (scale 2.0) W2A4 under SSQ_DW_KERNEL=1
# SSQ_PACKED=1, numpy-drawn (host_params), MSE scales, in two states:
# plain (pair transport across the siteless residual chains) and
# harmonized (quantize.harmonize_residual_chains: int8 __sum__ sites). The
# JAX package's plan kinds and pair counts on the CPU for the same recipe
# (mnasnet_parity_gap.py), and the launches of one deploy forward: the
# 3x3 int8-fed units on dw_conv3x3_int8, the other depthwise units on
# dw_conv_int8, the 1x1 units with int8 feeds packed, and each pair-fed
# consumer one int8_conv per term
MNASNET_STATES = ("plain", "harmonized")
MNASNET_KINDS = {
    "plain": {"bf16_codes": 11, "dw_int8": 6, "float": 11, "float_1p": 1,
              "packed": 24},
    "harmonized": {"bf16_codes": 11, "dw_int8": 6, "float": 1,
                   "float_1p": 1, "packed": 34}}
MNASNET_PAIRS = {"plain": {"formed": 5, "consumed_fast": 5},
                 "harmonized": {"formed": 0, "consumed_fast": 0}}
MNASNET_LAUNCHES = {
    "plain": dict(dw_conv3x3_int8=6, dw_conv_int8=11, packed_quant_matmul=24,
                  int8_conv=10, stem_fused=0, int8_group_conv=0),
    "harmonized": dict(dw_conv3x3_int8=6, dw_conv_int8=11,
                       packed_quant_matmul=34, int8_conv=0, stem_fused=0,
                       int8_group_conv=0)}
# phase 32: MobileNetV2's features.1.conv.0 (fed by the biased 8-bit stem
# site) is the one depthwise unit of its serving path on dw_conv_int8:
# (H, W, C, K, stride, offset)
MNV2_DW_INT8_SHAPE = (112, 112, 32, 3, 1, 128)
# phase 32: dw_conv_int8 away from the path's shapes, each case at
# offsets 0 and 128 and weight groups 1 and s_top: (batch, H, W, C, K,
# stride, s_top, codes view misaligned by a byte). C = 36 and 100 (a
# multiple of 4, not of 16: 4-byte copies), 30 (bytes); planes that no
# tile divides (13x11, 9x10, 15x13, 12x17), 1x1 and 2x2; a codes view one
# byte off (byte copies at C = 48)
DW_ODD_SHAPES = [(3, 13, 11, 36, 5, 1, 4, False),
                 (2, 9, 10, 100, 3, 2, 3, False),
                 (4, 1, 1, 100, 3, 1, 2, False),
                 (4, 2, 2, 36, 5, 2, 4, False),
                 (2, 2, 2, 100, 5, 1, 3, False),
                 (2, 1, 1, 36, 5, 2, 2, False),
                 (2, 15, 13, 30, 5, 2, 3, False),
                 (2, 12, 17, 48, 3, 1, 2, True),
                 (2, 13, 11, 48, 5, 2, 4, True)]
# phase 33: the port's CLI on the trained MNASNet (CIFAR variant) on
# synth10, brecq W2A4, with and without --harmonize_residual, each in a
# process of its own under MNASNET_CLI_TIMEOUT_S (each 112-163 s on the
# card: host-bound, and the card machine's host varies that much between
# calls);
# 52 per-unit targets at
# 400 weight steps, no act-delta phase and no per-target validation (on
# the card at 100 / 50 steps the plain run ended at 13.1 top-1; at
# 200 / 100 at 72.0, 300 / 0 at 95.1, 600 / 0 at 99.8).
# The JAX package's record on the same weights
# (round4_logs/harm_accuracy.json, brecq W2A4 at 600 / 300 steps, its own
# synth10 draws): plain final 99.71, sim 99.66, deploy 99.61, 0 sum
# sites; harmonized 99.61 / 99.66 / 99.71 with 10 sum sites
MNASNET_CLI_COMMON = ["--arch", "mnasnet", "--dataset", "synth10",
                      "--pretrained", "trained_mnasnet_synth10.npz",
                      "--mode", "brecq", "--n_bits_w", "2", "--n_bits_a",
                      "4", "--num_samples", "256", "--batch_size", "64",
                      "--iters_w", "400", "--iters_a", "0",
                      "--skip_test", "true"]
MNASNET_CLI_TIMEOUT_S = 240
# FP top-1 of the port's CLI on the CPU (--platform cpu, the same data
# flags; its "accuracy of FP model" line): 2048 synth10 test images
MNASNET_CPU_FP_TOP1 = 100.0
JAX_MNASNET_SUM_SITES = 10


def mnasnet_dw_shapes(graph, plan):
    """{(H, W, C, K, stride, offset): count} of the depthwise units a plan
    sends through dw_conv_int8 (offset 128 where the feed is a biased
    site)."""
    from shiftedscalequantization_tpu_torch import deploy
    from shiftedscalequantization_tpu_torch.graph import iter_units
    hw = deploy._unit_in_hw(graph, (HW, HW))
    out = {}
    for u in iter_units(graph):
        kind, site = plan[u.name]
        if u.groups == u.in_ch > 1 and kind in ("bf16_codes", "int8"):
            key = (*hw[u.name], u.in_ch, u.kernel[0], u.stride[0],
                   128 if site in plan["__biased_sites__"] else 0)
            out[key] = out.get(key, 0) + 1
    return out


def check_dw_conv(torch, gen, dwc, requant, deploy, shapes):
    """dw_conv_int8 vs its plain version at each (H, W, C, K, stride,
    offset) of the paths at batch 256 ({shape: {path: count}}), with a
    4-bit centered feed (offset 0) and a biased 8-bit one (offset 128):
    torch.equal in sums mode (int32 uniform, the f32 scale-table sum of
    two weight groups) and in every requant variant of REQUANT_VARIANTS
    (each also against the sums launch followed by quantize_out). Timed
    by CUDA-graph replay in the path's mode (S = 1, the shape's offset, a
    relu requant onto a 4-bit site; eager beside), next to its bound (the
    bytes it reads and writes once), the plain version (the shifted int32
    multiply-adds it replaces, the requant elementwise) and cuDNN's bf16
    depthwise conv on the same codes (the conv alone)."""
    import torch.nn.functional as F
    ctx = requant_context(torch, deploy, DEVICE)
    delta = torch.tensor(0.37, device=DEVICE)
    rows = []
    for key, paths in sorted(shapes.items(), reverse=True):
        h, w, c, k, st, path_off = key
        geom = ((k, k), (st, st), (k // 2, k // 2))
        ho, wo = (h - 1) // st + 1, (w - 1) // st + 1
        w1 = torch.randint(-2, 3, (1, c, k * k), generator=gen,
                           device=DEVICE, dtype=torch.int8)
        sel = torch.randint(0, 2, (c, 1), generator=gen, device=DEVICE)
        w2 = torch.stack([torch.where(sel == s, w1[0], 0)
                          for s in range(2)]).to(torch.int8).contiguous()
        res = residuals(torch, gen, (BATCH, ho, wo, c), DEVICE)
        label = f"dw_conv_int8 {h}x{w}x{c} k{k}/s{st}"
        timed = {}
        for offset in (0, 128):
            lo = -128 if offset else -8
            x = torch.randint(lo, -lo, (BATCH, h, w, c), generator=gen,
                              device=DEVICE, dtype=torch.int8)
            spread = (209.0 if offset else 6.6) * k
            scale, bias = _scaled(torch, gen, c, DEVICE, spread)
            for s_n, wm in ((1, w1), (2, w2)):
                table = None if s_n == 1 else torch.stack(
                    [scale * 0.5, scale]) / delta
                off = offset * wm.sum(dim=2, dtype=torch.int32) \
                    if offset else None
                kw = dict(pad_value=-offset, group_scales=table,
                          act_delta=delta, acc_offset=off)
                got = dwc.dw_conv_int8(x, wm, *geom, **kw)
                want = dwc.dw_conv_int8_plain(x, wm, *geom, **kw)
                torch.cuda.synchronize()
                if got.dtype != want.dtype or not torch.equal(got, want):
                    raise AssertionError(f"{label} S={s_n} offset {offset}: "
                                         "sums differ from the plain version")
                pend = deploy._Pending(got.float(), scale, bias) \
                    if s_n == 1 else deploy._Pending(got, None, bias)
                rqs = check_requant_modes(
                    torch, deploy, requant,
                    f"{label} S={s_n} offset {offset}",
                    lambda rq: dwc.dw_conv_int8(x, wm, *geom, requant=rq,
                                                **kw),
                    want.float(), pend, res, ctx)
                if s_n == 1 and offset == path_off:
                    rq = rqs[ROLE_VARIANT["site"]]
                    timed = dict(x=x, kw=kw, rq=rq)
        x, kw, rq = timed["x"], timed["kw"], timed["rq"]
        fn = lambda: dwc.dw_conv_int8(x, w1, *geom, requant=rq,  # noqa
                                      **kw)
        ms = time_graph(fn)
        eager_ms = time_cuda(fn)
        sums_ms = time_graph(lambda: dwc.dw_conv_int8(x, w1, *geom, **kw))
        plain_ms = time_cuda(lambda: dwc.dw_conv_int8_plain(
            x, w1, *geom, requant=rq, **kw), iters=3, warmup=1)
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)       # channels_last
        wb = w1[0].reshape(c, 1, k, k).to(torch.bfloat16) \
            .contiguous(memory_format=torch.channels_last)
        conv_ms = time_graph(lambda: F.conv2d(xb, wb, None, st, k // 2, 1,
                                              c))
        n_bytes = BATCH * (h * w + ho * wo) * c + k * k * c + 4 * 4 * c
        b_ms, b_by = bound_ms(n_bytes, 2 * k * k * BATCH * ho * wo * c,
                              INT8_OPS)
        print(f"  {label} offset {path_off} ({paths}): {ms:.4f} ms graph, "
              f"{eager_ms:.4f} eager, sums {sums_ms:.4f} (bound {b_ms:.4f} "
              f"ms by {b_by}; plain {plain_ms:.4f}; cuDNN bf16 conv alone "
              f"{conv_ms:.4f}); sums and {len(REQUANT_VARIANTS)} requant "
              "variants bit-exact at S = 1, 2 and offsets 0, 128",
              flush=True)
        rows.append(dict(shape=key, paths=paths, ms=ms, eager_ms=eager_ms,
                         sums_ms=sums_ms, plain_ms=plain_ms,
                         library_ms=conv_ms, bound_ms=b_ms, bound_by=b_by,
                         err=0.0))
    return rows


def check_dw_conv_odd(torch, gen, dwc, requant, deploy):
    """dw_conv_int8 at DW_ODD_SHAPES: torch.equal with the plain version
    in sums mode (int32 and the scale-table sum at S = 1, the scale-table
    sum at the case's S) and in every requant variant of REQUANT_VARIANTS
    at both S, offsets 0 and 128."""
    ctx = requant_context(torch, deploy, DEVICE)
    delta = torch.tensor(0.37, device=DEVICE)
    for b, h, w, c, k, st, s_top, skew in DW_ODD_SHAPES:
        geom = ((k, k), (st, st), (k // 2, k // 2))
        ho, wo = (h - 1) // st + 1, (w - 1) // st + 1
        ws = torch.randint(-2, 3, (s_top, c, k * k), generator=gen,
                           device=DEVICE, dtype=torch.int8)
        res = residuals(torch, gen, (b, ho, wo, c), DEVICE)
        label = (f"dw_conv_int8 {h}x{w}x{c} k{k}/s{st} batch {b}"
                 + (", codes one byte off" if skew else ""))
        for offset in (0, 128):
            lo = -128 if offset else -8
            buf = torch.randint(lo, -lo, (b * h * w * c + int(skew),),
                                generator=gen, device=DEVICE,
                                dtype=torch.int8)
            x = buf[int(skew):].view(b, h, w, c)
            if skew and x.data_ptr() % 4 == 0:
                raise AssertionError(f"{label}: the view is aligned")
            # the taps inside the image set the spread of the sums
            taps = min(h, k) * min(w, k)
            scale, bias = _scaled(torch, gen, c, DEVICE, (
                209.0 if offset else 6.6) * math.sqrt(taps))
            for s_n in (1, s_top):
                wm = ws[:s_n].contiguous()
                table = torch.stack([scale * (0.5 + 0.25 * s)
                                     for s in range(s_n)]) / delta
                base = dict(pad_value=-offset, acc_offset=offset * wm.sum(
                    dim=2, dtype=torch.int32) if offset else None)
                tab = dict(base, group_scales=table, act_delta=delta)
                for mode, kw in (("int32", base), ("table", tab)):
                    if mode == "int32" and s_n > 1:
                        continue
                    got = dwc.dw_conv_int8(x, wm, *geom, **kw)
                    want = dwc.dw_conv_int8_plain(x, wm, *geom, **kw)
                    torch.cuda.synchronize()
                    if got.dtype != want.dtype or not torch.equal(got, want):
                        raise AssertionError(
                            f"{label} S={s_n} offset {offset} {mode}: "
                            "sums differ from the plain version")
                # the requant's input: the int32 sums at S = 1 (deploy's
                # pending scale and bias), else the scale-table sum
                kw = base if s_n == 1 else tab
                value = dwc.dw_conv_int8_plain(x, wm, *geom, **kw).float()
                pend = deploy._Pending(value, scale, bias) if s_n == 1 \
                    else deploy._Pending(value, None, bias)
                check_requant_modes(
                    torch, deploy, requant,
                    f"{label} S={s_n} offset {offset}",
                    lambda rq: dwc.dw_conv_int8(x, wm, *geom, requant=rq,
                                                **kw),
                    value, pend, res, ctx)
        print(f"  {label}: int32 and scale-table sums and "
              f"{len(REQUANT_VARIANTS)} requant variants bit-exact at S = "
              f"1, {s_top} and offsets 0, 128", flush=True)


def mnasnet_phases(torch, gen, mnv2_dw_count):
    """Phases 31-32: ImageNet MNASNet W2A4 at full width, plain and
    harmonized, served under SSQ_DW_KERNEL=1 SSQ_PACKED=1 (plan kinds,
    launches, pairs, requants left, deploy vs sim, card vs CPU, ms/batch
    and host issue time beside the bf16 forward, and the plain state
    once more with SSQ_PAIR_TERMS=0); then dw_conv_int8 at every
    depthwise shape it serves there and at MobileNetV2's
    features.1.conv.0 (``mnv2_dw_count`` units)."""
    from shiftedscalequantization_tpu_torch import deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, forward
    from shiftedscalequantization_tpu_torch.ops.cuda import dw_conv, requant
    t0 = time.perf_counter()
    serving_env(SSQ_DW_KERNEL="1", SSQ_PACKED="1")
    setup = serving_setup(torch, gen, "mnasnet", host=True)
    graph, cfg, params, qstate, dparams, steps = setup
    qs_h, ratios = Q.harmonize_residual_chains(graph, qstate)
    setups = {"plain": setup,
              "harmonized": (graph, cfg, params, qs_h, dparams,
                             deploy.act_steps_from_qstate(graph, qs_h))}
    plans = {}
    for state in MNASNET_STATES:
        plans[state] = deploy.make_deploy_plan(
            graph, dparams, setups[state][5], input_hw=(HW, HW))
        got = plan_counts(plans[state])
        print(f"  mnasnet {state}: plan kinds {got} (JAX "
              f"{MNASNET_KINDS[state]}); sum sites "
              f"{len(plans[state]['__sum_steps__'])}"
              + (f", {len(ratios)} act sites harmonized" if state ==
                 "harmonized" else ""), flush=True)
        if got != MNASNET_KINDS[state]:
            raise AssertionError(f"mnasnet {state} plan kinds {got}, want "
                                 f"{MNASNET_KINDS[state]}")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    phase("mnasnet setup", t0)

    t0 = time.perf_counter()
    x = host_images(torch, BATCH, 2)
    served = {}
    for state in MNASNET_STATES:
        res = serve_state(torch, deploy, Q, forward, Flags,
                          f"mnasnet {state}", setups[state], x,
                          MNASNET_LAUNCHES[state], f"mnasnet_{state}")
        pairs = res["pair_stats"]
        print(f"  mnasnet {state}: pair_stats of one forward {pairs} (JAX "
              f"{MNASNET_PAIRS[state]})", flush=True)
        if pairs != MNASNET_PAIRS[state]:
            raise AssertionError(f"mnasnet {state}: pair_stats {pairs}, "
                                 f"want {MNASNET_PAIRS[state]}")
        _, _, params_s, qs_s, dp_s, steps_s = setups[state]
        plan = res["plan"]
        fwd = lambda: deploy.deploy_forward(  # noqa: E731
            graph, dp_s, steps_s, x, plan=plan, device=DEVICE)
        issue = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fwd()
            issue.append(time.perf_counter() - t)
            torch.cuda.synchronize()
        res["host_issue_ms"] = min(issue[1:]) * 1e3
        params_bf16 = {u: {k: v.to(torch.bfloat16) for k, v in p.items()}
                       for u, p in params_s.items()}
        xb = x.to(torch.bfloat16)
        res["bf16_ms"] = time_cuda(lambda: forward(
            graph, params_bf16, qs_s, xb, Flags(), device=DEVICE),
            iters=5, warmup=1)
        res["plan"] = plan_counts(plan)
        print(f"  mnasnet {state}: {res['deploy_ms']:.3f} ms/batch, host "
              f"issue {res['host_issue_ms']:.3f} ms; the port's bf16 float "
              f"forward {res['bf16_ms']:.3f} ms/batch", flush=True)
        served[state] = res
    # the plain state with pair transport off: the exact f32 sums
    os.environ["SSQ_PAIR_TERMS"] = "0"
    graph, cfg, params, qstate, dparams, steps = setups["plain"]
    reset_counts()
    logits0 = deploy.deploy_forward(graph, dparams, steps, x,
                                    plan=plans["plain"], device=DEVICE)
    torch.cuda.synchronize()
    off = dict(pairs=dict(deploy.pair_stats),
               launches={k: v for k, v in counts().items() if v})
    del os.environ["SSQ_PAIR_TERMS"]
    sim = forward(graph, params, qstate, x, Q.act_flags(
        graph, cfg, base=Flags().all_weights(graph)), device=DEVICE)
    off["rel_mse"] = logit_rel_mse(torch, logits0, sim)
    off["finite"] = bool(torch.isfinite(logits0).all())
    print(f"  mnasnet plain, SSQ_PAIR_TERMS=0: pair_stats {off['pairs']}, "
          f"launches {off['launches']}; deploy vs sim logit rel-MSE "
          f"{off['rel_mse']:.4e} (gate {RELMSE_GATE:g})", flush=True)
    if off["pairs"]["formed"] != 0 or off["launches"].get("int8_conv", 0) \
            or not (off["finite"] and off["rel_mse"] <= RELMSE_GATE):
        raise AssertionError(f"mnasnet SSQ_PAIR_TERMS=0: {off}")
    serving_env()
    phase("mnasnet serving + parity", t0)

    t0 = time.perf_counter()
    shapes = {}
    for key, n in mnasnet_dw_shapes(graph, plans["plain"]).items():
        shapes.setdefault(key, {})["mnasnet"] = n
    shapes.setdefault(MNV2_DW_INT8_SHAPE, {})["mobilenetv2"] = mnv2_dw_count
    if sum(r.get("mnasnet", 0) for r in shapes.values()) != 11:
        raise AssertionError(f"mnasnet dw_conv_int8 shapes {shapes}")
    dw_rows = check_dw_conv(torch, gen, dw_conv, requant, deploy, shapes)
    check_dw_conv_odd(torch, gen, dw_conv, requant, deploy)
    phase("dw_conv_int8 kernel", t0)
    return dict(setup_s=setup_s, served=served, pair_terms_0=off,
                harmonized_sites=len(ratios), dw_rows=dw_rows)


def mnasnet_cli_phases(torch):
    """Phase 33: the port's CLI on the trained MNASNet, brecq W2A4, with
    and without --harmonize_residual, each in its own process under
    MNASNET_CLI_TIMEOUT_S; then each run's final state served on
    synth10's 2048 test images. Gates: the FP model's top-1 on them
    equals the port CLI's on the CPU, the final (sim) top-1 at least FP -
    REGNET_FINAL_DROP (a reconstruction that collapses fails), deploy
    within 0.5 points of the sim top-1 of the same state."""
    import tempfile
    import numpy as np
    from shiftedscalequantization_tpu_torch import cli, deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, forward
    from shiftedscalequantization_tpu_torch.utils import checkpoint as ck
    from shiftedscalequantization_tpu_torch.utils.config import load_args
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory()
    env = dict(os.environ, PYTHONPATH=root)
    for k in ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
              "SSQ_DW_KERNEL", "SSQ_PAIR_TERMS"):
        env.pop(k, None)
    common = [os.path.join(root, a) if a.endswith(".npz") else a
              for a in MNASNET_CLI_COMMON]
    runs = {}
    for harm in ("false", "true"):
        name = "harmonized" if harm == "true" else "plain"
        argv = common + [
            "--harmonize_residual", harm,
            "--checkpoint_dir", os.path.join(tmp.name, name),
            "--log_path", os.path.join(tmp.name, f"{name}.log")]
        print(f"  mnasnet cli {name}: python -m "
              f"shiftedscalequantization_tpu_torch.cli {' '.join(argv)}",
              flush=True)
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "shiftedscalequantization_tpu_torch.cli",
             *argv], cwd=root, env=env, capture_output=True, text=True,
            timeout=MNASNET_CLI_TIMEOUT_S)
        wall = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"mnasnet cli {name}: exit "
                                 f"{proc.returncode}\n{proc.stdout[-4000:]}"
                                 f"\n{proc.stderr[-4000:]}")
        final, harmonized = None, None
        for line in proc.stdout.splitlines():
            if line.startswith("Final W"):
                final = _cli_dict(line)["top1"]
            elif line.startswith("harmonized "):
                harmonized = line
        args = load_args(argv)
        graph, raw, cfg = cli.build_everything(args, device=DEVICE)
        params, _ = Q.prepare_model(graph, raw, cfg, device=DEVICE)
        qs, done = ck.load_qstate(os.path.join(tmp.name, name, "QNN_W2_A4"),
                                  device=DEVICE)
        _, test = cli.build_data(args)
        batches = list(test)
        xs = np.concatenate([b for b, _ in batches])
        ys = np.concatenate([y for _, y in batches])
        x = torch.as_tensor(xs, device=DEVICE)
        serving_env(SSQ_DW_KERNEL="1", SSQ_PACKED="1")
        dp = deploy.build_deploy_params(graph, params, qs, device=DEVICE)
        steps = deploy.act_steps_from_qstate(graph, qs)
        plan = deploy.make_deploy_plan(graph, dp, steps,
                                       input_hw=tuple(xs.shape[1:3]))
        reset_counts()
        logits = torch.cat([deploy.deploy_forward(
            graph, dp, steps, x[i:i + BATCH], plan=plan, device=DEVICE)
            for i in range(0, x.shape[0], BATCH)])
        torch.cuda.synchronize()
        serving_env()
        launches = {k: v for k, v in counts().items() if v}
        launches["unfused"] = launches.pop("unfused", 0)
        y = torch.as_tensor(ys, device=DEVICE)
        dep_top1 = float((logits.argmax(-1) == y).double().mean()) * 100
        # the FP model's top-1 on the same images (--skip_test leaves it
        # out of the CLI's lines)
        fp_logits = torch.cat([forward(graph, params, qs, x[i:i + BATCH],
                                       Flags(), device=DEVICE)
                               for i in range(0, x.shape[0], BATCH)])
        fp = float((fp_logits.argmax(-1) == y).double().mean()) * 100
        sums = len(plan["__sum_steps__"])
        runs[name] = dict(wall_s=wall, fp_top1=fp, final_top1=final,
                          deploy_top1=dep_top1, targets=len(done),
                          images=int(x.shape[0]), sum_sites=sums,
                          harmonized=harmonized,
                          plan_kinds=plan_counts(plan),
                          deploy_launches=launches)
        print(f"  mnasnet cli {name}: {wall:.2f} s; {len(done)} targets; FP "
              f"top-1 {fp} (the port's CLI on the CPU "
              f"{MNASNET_CPU_FP_TOP1}); final {final}; deploy "
              f"{dep_top1:.4f} on {x.shape[0]} images under SSQ_DW_KERNEL=1 "
              f"SSQ_PACKED=1 (plan {plan_counts(plan)}, launches "
              f"{launches}); sum sites {sums} (the JAX record's harmonized "
              f"run: {JAX_MNASNET_SUM_SITES}); {harmonized or ''}; "
              "round4_logs/harm_accuracy.json (JAX, brecq, 600 / 300 "
              "steps): plain final 99.71, deploy 99.61; harmonized 99.61 / "
              "99.71", flush=True)
        if fp != MNASNET_CPU_FP_TOP1:
            raise AssertionError(f"mnasnet cli {name}: FP top-1 {fp}, on "
                                 f"the CPU {MNASNET_CPU_FP_TOP1}")
        if final is None or len(done) != len(
                Q.reconstruction_targets(graph)):
            raise AssertionError(f"mnasnet cli {name}: final {final}, "
                                 f"{len(done)} targets done")
        if final < fp - REGNET_FINAL_DROP:
            raise AssertionError(f"mnasnet cli {name}: final top-1 {final}"
                                 f" < FP {fp} - {REGNET_FINAL_DROP}")
        if abs(dep_top1 - final) > REGNET_DEPLOY_GAP:
            raise AssertionError(f"mnasnet cli {name}: deploy top-1 "
                                 f"{dep_top1} vs sim {final}")
    tmp.cleanup()
    phase("mnasnet cli", t0)
    return runs


# ---------------------------------------------------------------------------
# ResNet-50 from a torchvision checkpoint, the native loader, the import
# and data path through the CLI (phases 34-37)
# ---------------------------------------------------------------------------

R50_STATES = ("uniform", "baked")
R50_ENVS = {"default": {},
            "stem+packed": dict(SSQ_STEM_KERNEL="1", SSQ_PACKED="1")}
# the JAX package's plan kinds for ImageNet ResNet-50 W2A4 at 224x224
# (tests/test_torch_port_resnet_bottleneck.py pins them against its plan)
R50_KINDS = {
    ("uniform", "default"): {"bf16_codes": 10, "float": 1, "float_1p": 1,
                             "int8": 42},
    ("uniform", "stem+packed"): {"bf16_codes": 5, "float": 1, "int8": 13,
                                 "packed": 34, "stem_fused": 1},
    ("baked", "default"): {"bf16_codes": 10, "float": 1, "float_1p": 1,
                           "int8": 42},
    ("baked", "stem+packed"): {"bf16_codes": 10, "float": 1, "int8": 42,
                               "stem_fused": 1},
}
R50_CLI_ARGS = ["--arch", "resnet50", "--dataset", "imagenet", "--mode",
                "fused", "--iters_w", "20", "--iters_a", "0",
                "--num_samples", "64"]
R50_CLI_TIMEOUT_S = 150         # the CLI's process
R50_LIMIT_S = 300               # phases 34-35
R50_ACT_SITES = 49              # act sites of the sim forward (W2A4)
NATIVE_LIMIT_S = 60             # phase 36
R50_CLI_LIMIT_S = 300           # phase 37: the CLI's process, then serving
R50_CLI_TRAIN = (64, 288, 360)   # uint8 train images: the val transform
#                                  shrinks them to 256x320 and crops 224
R50_CLI_VAL = (2, 16)            # float32 224x224 val shards x images
R50_FP_RTOL = 1e-5               # imported FP logits, card vs CPU:
#                                  max |diff| / max |CPU logit|


def r50_key(state, env):
    return f"resnet50_{state}_{env.replace('+', '_')}"


def torchvision_state_dict(torch, graph, key_map, seed=0):
    """A torchvision-layout state dict for ``graph`` drawn with numpy:
    He-normal conv and linear weights, zero linear bias, BN affine and
    running statistics near identity, the num_batches_tracked counters
    the importers ignore."""
    import numpy as np
    from shiftedscalequantization_tpu_torch.graph import iter_units
    rng = np.random.default_rng(seed)
    sd = {}
    for u in iter_units(graph):
        conv, bn = key_map[u.name]
        shape = (u.out_ch, u.in_ch // u.groups, *u.kernel) \
            if u.kind == "conv" else (u.out_ch, u.in_ch)
        fan_in = int(np.prod(shape[1:]))
        sd[f"{conv}.weight"] = torch.as_tensor(
            rng.standard_normal(shape, dtype=np.float32)
            * np.float32(np.sqrt(2.0 / fan_in)))
        c = u.out_ch
        if bn is None:
            sd[f"{conv}.bias"] = torch.zeros(c)
            continue
        for name, v in (("weight", rng.uniform(0.8, 1.2, c)),
                        ("bias", rng.normal(0.0, 0.05, c)),
                        ("running_mean", rng.normal(0.0, 0.05, c)),
                        ("running_var", rng.uniform(0.8, 1.2, c))):
            sd[f"{bn}.{name}"] = torch.as_tensor(v.astype(np.float32))
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
    return sd


def torchvision_checkpoint(torch, graph, key_map, path, seed=0):
    """torchvision_state_dict saved as a DataParallel training checkpoint,
    {'state_dict': {'module.<key>': tensor}}, at ``path``."""
    sd = torchvision_state_dict(torch, graph, key_map, seed)
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)


def resnet50_phases(torch, gen, ckpt):
    """Phases 34-35: ImageNet ResNet-50 W2A4 at full width from the
    torchvision checkpoint ``ckpt`` read through utils/torch_import, MSE
    scales, calibration on 16 images, uniform and baked (the method's
    fused quantizers, SHIFT_TARGETS, hardened); each plan under the JAX
    package's defaults and under SSQ_STEM_KERNEL=1 SSQ_PACKED=1 must hold
    the JAX plan's kinds (R50_KINDS); each served at batch 256 with the
    counters reset just before the forward (plan_launches, requants left
    UNFUSED), deploy vs sim, card vs CPU on 8 grid images, ms/batch
    beside the port's bf16 float forward, the sim forward's fake_quant
    launches gated (one a site, one a UniformWQ weight); then fake_quant
    at the act sites' shapes, int8_conv at every dense shape of both
    default plans and the packed kernel at every shape of the uniform
    stem+packed plan against their plain versions."""
    from shiftedscalequantization_tpu_torch import deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, forward
    from shiftedscalequantization_tpu_torch.models import zoo
    from shiftedscalequantization_tpu_torch.graph import iter_units
    from shiftedscalequantization_tpu_torch.ops.cuda import fake_quant, \
        int_matmul, packed, requant
    from shiftedscalequantization_tpu_torch.recon import engine
    from shiftedscalequantization_tpu_torch.utils import torch_import
    t0 = time.perf_counter()
    serving_env()
    graph, km = zoo.build("resnet50", dataset="imagenet")
    sd = torch_import.load_state_dict(ckpt)
    raw = torch_import.params_from_state_dict(graph, km(graph), sd,
                                              device=DEVICE)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    uniform = serving_setup(torch, gen, "resnet50", host=True, raw=raw)
    g, cfg, params, qstate, _, _ = uniform
    qs_b = bake(engine, Q, g, params, qstate)
    setups = {"uniform": uniform,
              "baked": (g, cfg, params, qs_b,
                        deploy.build_deploy_params(g, params, qs_b,
                                                   device=DEVICE),
                        deploy.act_steps_from_qstate(g, qs_b))}
    plans = {}
    for state in R50_STATES:
        for env, switches in R50_ENVS.items():
            serving_env(**switches)
            plan = deploy.make_deploy_plan(graph, setups[state][4],
                                           setups[state][5],
                                           input_hw=(HW, HW))
            got = plan_counts(plan)
            print(f"  resnet50 {state} {env}: plan kinds {got} (JAX "
                  f"{R50_KINDS[(state, env)]})", flush=True)
            if got != R50_KINDS[(state, env)]:
                raise AssertionError(f"resnet50 {state} {env} plan kinds "
                                     f"{got}")
            plans[(state, env)] = plan
    baked = sum(d.w_groups is not None for d in setups["baked"][4].values())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"  resnet50: {len(sd)} checkpoint tensors imported in "
          f"{import_s:.2f} s; setup (import, BN fold, MSE scales, "
          f"calibration, baking, two deploy conversions) {setup_s:.2f} s; "
          f"{baked} baked units", flush=True)
    phase("resnet50 setup", t0)

    t0 = time.perf_counter()
    x = host_images(torch, BATCH, 3)
    served = {}
    for state in R50_STATES:
        _, _, params_s, qs_s, _, _ = setups[state]
        for env, switches in R50_ENVS.items():
            serving_env(**switches)
            key = r50_key(state, env)
            res = serve_state(torch, deploy, Q, forward, Flags,
                              f"resnet50 {state} {env}", setups[state], x,
                              plan_launches(graph, plans[(state, env)]),
                              key)
            res["plan"] = plan_counts(res["plan"])
            want = dict(fake_quant_act=R50_ACT_SITES,
                        fake_quant_weight=sum(
                            type(qs_s[u.name].wq).__name__ == "UniformWQ"
                            for u in iter_units(graph)))
            got = {k: res["sim_launches"].get(k, 0) for k in want}
            print(f"  resnet50 {state} {env}: fake_quant launches in one "
                  f"sim forward {got} (want {want})", flush=True)
            if got != want:
                raise AssertionError(f"resnet50 {state} {env} sim "
                                     f"fake_quant launches {got}")
            served[key] = res
        params_bf16 = {u: {k: v.to(torch.bfloat16) for k, v in p.items()}
                       for u, p in params_s.items()}
        xb = x.to(torch.bfloat16)
        bf16_ms = time_cuda(lambda: forward(
            graph, params_bf16, qs_s, xb, Flags(), device=DEVICE),
            iters=5, warmup=1)
        for env in R50_ENVS:
            served[r50_key(state, env)]["bf16_ms"] = bf16_ms
        print(f"  resnet50 {state}: deploy " + ", ".join(
            f"{env} {served[r50_key(state, env)]['deploy_ms']:.3f}"
            for env in R50_ENVS) + f" ms/batch; the port's bf16 float "
            f"forward {bf16_ms:.3f} ms/batch", flush=True)
    serving_env()
    phase("resnet50 serving + parity", t0)

    t0 = time.perf_counter()
    fq_shapes = act_site_shapes(g, params, qstate, cfg, x[:1], BATCH)
    if sum(fq_shapes.values()) != R50_ACT_SITES:
        raise AssertionError(f"resnet50 act site shapes {fq_shapes}")
    fq_rows = check_fake_quant(torch, gen, fake_quant, fq_shapes)
    conv_rows = check_int8_conv(
        torch, gen, int_matmul, requant, deploy,
        int8_conv_shapes(graph, plans[("baked", "default")]),
        int8_conv_shapes(graph, plans[("uniform", "default")]))
    if sum(sum(r["roles"].values()) for r in conv_rows) != 52 \
            or sum(sum(r["uniform_roles"].values()) for r in conv_rows) != 52:
        raise AssertionError(f"resnet50 int8_conv shapes {conv_rows}")
    pk_rows = check_packed(
        torch, gen, packed, requant, deploy,
        packed_shapes(graph, setups["uniform"][4],
                      plans[("uniform", "stem+packed")]), iters=5)
    if sum(sum(r["roles"].values()) for r in pk_rows) != 34:
        raise AssertionError(f"resnet50 packed shapes {pk_rows}")
    print("  resnet50 stem: the shape of phase 3's check (batch 256, "
          "224x224, 64 channels), bit-exact there", flush=True)
    phase("resnet50 kernels", t0)
    return dict(import_s=import_s, setup_s=setup_s, baked_units=baked,
                served=served, fq_rows=fq_rows, conv_rows=conv_rows,
                packed_rows=pk_rows)


def native_loader_phase():
    """Phase 36: whether the card's machine has Pillow and libjpeg, the
    native loader built there into build/native/ from
    native/dataloader.cc; sequential NativeLoader batches against
    ArrayLoader's, bit for bit; the loader _make_loader takes. Left out,
    on a line of its own, only where libjpeg is missing."""
    import glob
    import shutil
    import numpy as np
    from shiftedscalequantization_tpu_torch.data import datasets, \
        native_loader
    t0 = time.perf_counter()
    try:
        import PIL
        pillow = PIL.__version__
    except ImportError:
        pillow = None
    headers = [p for pat in ("/usr/include/jpeglib.h",
                             "/usr/include/*/jpeglib.h",
                             "/usr/local/include/jpeglib.h")
               for p in glob.glob(pat)]
    ldc = subprocess.run(["ldconfig", "-p"], capture_output=True,
                         text=True).stdout if shutil.which("ldconfig") else ""
    libs = sorted({ln.split()[0] for ln in ldc.splitlines()
                   if "libjpeg" in ln})
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    probe = dict(pillow=pillow, jpeglib_h=headers, libjpeg=libs, cxx=cxx)
    print(f"  probe: Pillow {pillow or 'absent'}; jpeglib.h "
          f"{headers or 'absent'}; libjpeg {libs or 'absent'}; compiler "
          f"{cxx or 'absent'}", flush=True)
    t = time.perf_counter()
    built = native_loader.native_available()
    build_s = time.perf_counter() - t
    if not built:
        err = native_loader.build_error()
        if not headers:
            print(f"native loader phase left out: libjpeg's header is "
                  f"missing on this machine, so native/dataloader.cc does "
                  f"not build ({err.splitlines()[-1][:200]})", flush=True)
            phase("native loader", t0)
            return dict(probe=probe, built=False, error=err)
        raise AssertionError(f"native loader does not build: {err}")
    lib = os.path.abspath(native_loader._lib._name)
    if os.path.dirname(lib) != str(native_loader.BUILD_DIR):
        raise AssertionError(f"native library loaded from {lib}")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1000, 32, 32, 3), dtype=np.float32)
    y = rng.integers(0, 1000, 1000).astype(np.int32)
    nat = list(native_loader.NativeLoader(x, y, 64))
    arr = list(datasets.ArrayLoader(x, y, 64))
    same = len(nat) == len(arr) and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        for a, b in zip(nat, arr))
    chosen = type(datasets._make_loader(x, y, 64, True, 0, (0, 1))).__name__
    print(f"  native loader built in {build_s:.2f} s at {lib}; {len(nat)} "
          f"sequential batches equal ArrayLoader's bit for bit: {same}; "
          f"_make_loader takes {chosen}", flush=True)
    if not same or chosen != "NativeLoader":
        raise AssertionError(f"native loader: batches equal {same}, "
                             f"_make_loader took {chosen}")
    phase("native loader", t0)
    return dict(probe=probe, built=True, build_s=build_s, batches=len(nat),
                loader=chosen)


def resnet50_cli_phase(torch, ckpt, tmp):
    """Phase 37: the import and data path end to end. An ImageNet npz root
    synthesized in ``tmp`` (uint8 train.npz that takes the val transform's
    resize and crop, float32 val shards), and the port's CLI on it in its
    own process under R50_CLI_TIMEOUT_S: R50_CLI_ARGS (--arch resnet50
    --mode fused, 20 steps a target, 64 rows), --pretrained ``ckpt``. Gates:
    exit 0, the loader kinds printed, 17 targets reconstructed, the
    imported FP logits on 4 val images on the card equal the CPU's within
    R50_FP_RTOL, and the final checkpoint served with deploy vs sim
    rel-MSE <= RELMSE_GATE, no NaN."""
    import numpy as np
    from shiftedscalequantization_tpu_torch import cli, deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.data import imagenet_io
    from shiftedscalequantization_tpu_torch.graph import Flags, forward
    from shiftedscalequantization_tpu_torch.utils import checkpoint as ck
    from shiftedscalequantization_tpu_torch.utils.config import load_args
    t0 = time.perf_counter()
    root = os.path.join(tmp, "imagenet")
    os.makedirs(os.path.join(root, "val"))
    rng = np.random.default_rng(5)
    n, h, w = R50_CLI_TRAIN
    np.savez(os.path.join(root, "train.npz"),
             images=rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8),
             labels=rng.integers(0, 1000, n))
    shards, per = R50_CLI_VAL
    for i in range(shards):
        np.savez(os.path.join(root, "val", f"shard{i}.npz"),
                 images=rng.standard_normal((per, HW, HW, 3),
                                            dtype=np.float32),
                 labels=rng.integers(0, 1000, per))
    repo = os.path.dirname(os.path.abspath(__file__))
    argv = R50_CLI_ARGS + [
        "--data_path", root, "--pretrained", ckpt, "--checkpoint_dir",
        os.path.join(tmp, "r50_ck"), "--log_path",
        os.path.join(tmp, "r50.log")]
    env = dict(os.environ, PYTHONPATH=repo)
    for k in ("SSQ_STEM_KERNEL", "SSQ_PACKED", "SSQ_STEM_1PASS",
              "SSQ_DW_KERNEL"):
        env.pop(k, None)
    print(f"  resnet50 cli: python -m shiftedscalequantization_tpu_torch.cli "
          f"{' '.join(argv)}", flush=True)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "shiftedscalequantization_tpu_torch.cli",
         *argv], cwd=repo, env=env, capture_output=True, text=True,
        timeout=R50_CLI_TIMEOUT_S)
    wall = time.perf_counter() - t
    out = proc.stdout
    for line in out.splitlines():
        if line.startswith(("data loaders:", "accuracy of FP", "Final W")):
            print("  | " + line, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"resnet50 cli: exit {proc.returncode}\n"
                             f"{out[-4000:]}\n{proc.stderr[-4000:]}")
    loaders = [ln for ln in out.splitlines()
               if ln.startswith("data loaders: train ")]
    recon = out.count("Reconstructed ")
    final = next((_cli_dict(ln)["top1"] for ln in out.splitlines()
                  if ln.startswith("Final W")), None)
    if len(loaders) != 1 or recon != 17 or final is None:
        raise AssertionError(f"resnet50 cli: loader lines {loaders}, "
                             f"{recon} targets reconstructed, final {final}")
    args = load_args(argv)
    xv, _ = imagenet_io.load_array_split(root, "val")
    fp = {}
    for dev in (DEVICE, "cpu"):
        graph, raw, _ = cli.build_everything(args, device=dev)
        params, qs0 = Q.prepare_model(
            graph, raw, Q.QuantConfig(w_scale_method="max"), device=dev)
        fp[dev] = forward(graph, params, qs0,
                          torch.as_tensor(xv[:4], device=dev), Flags(),
                          device=dev).cpu().double()
    fp_err = float((fp[DEVICE] - fp["cpu"]).abs().max()
                   / fp["cpu"].abs().max())
    graph, raw, cfg = cli.build_everything(args, device=DEVICE)
    params, _ = Q.prepare_model(graph, raw, cfg, device=DEVICE)
    qs, done = ck.load_qstate(os.path.join(tmp, "r50_ck", "QNN_W2_A4"),
                              device=DEVICE)
    dp = deploy.build_deploy_params(graph, params, qs, device=DEVICE)
    steps = deploy.act_steps_from_qstate(graph, qs)
    serving_env()
    plan = deploy.make_deploy_plan(graph, dp, steps, input_hw=(HW, HW))
    x = torch.as_tensor(xv, device=DEVICE)
    reset_counts()
    logits = deploy.deploy_forward(graph, dp, steps, x, plan=plan,
                                   device=DEVICE)
    torch.cuda.synchronize()
    launches = {k: v for k, v in counts().items() if v}
    sim = forward(graph, params, qs, x, Q.act_flags(
        graph, cfg, base=Flags().all_weights(graph)), device=DEVICE)
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(sim).all())
    rel = logit_rel_mse(torch, logits, sim)
    print(f"  resnet50 cli: {wall:.2f} s (limit {R50_CLI_TIMEOUT_S}); "
          f"{recon} targets; {loaders[0]}; imported FP logits on 4 val "
          f"images, card vs CPU max |diff| / max |logit| {fp_err:.3e} (gate "
          f"{R50_FP_RTOL:g}); the fused checkpoint ({len(done)} targets "
          f"done) served on {x.shape[0]} val images: plan "
          f"{plan_counts(plan)}, launches {launches}, deploy vs sim logit "
          f"rel-MSE {rel:.4e} (gate {RELMSE_GATE:g}), finite {finite}",
          flush=True)
    if not fp_err <= R50_FP_RTOL:
        raise AssertionError(f"resnet50 cli: imported FP logits card vs "
                             f"CPU {fp_err}")
    if len(done) != 17 or not (finite and rel <= RELMSE_GATE):
        raise AssertionError(f"resnet50 cli: {len(done)} targets done, "
                             f"deploy vs sim {rel}, finite {finite}")
    phase("resnet50 cli", t0)
    return dict(wall_s=wall, loaders=loaders[0], targets=recon,
                final_top1=final, fp_card_cpu=fp_err, deploy_sim_rel_mse=rel,
                deploy_launches=launches, plan_kinds=plan_counts(plan))


# ---------------------------------------------------------------------------
# phases 38-41: data-parallel calibration and reconstruction, two ranks
# ---------------------------------------------------------------------------

PAR_RANKS = 2
PAR_LIMIT_S = 150                # phases 38-41 together
PAR_RANK_TIMEOUT_S = 140         # each rank process
PAR_SEED = 3                     # host_params: the model's weights
PAR_CAL_IMAGES = 64              # 2 x 32, synced_calibrate_acts
PAR_ROWS = 32                    # cache rows = the global batch
PAR_TARGET = "model.layer2.0"    # the block with a downsample
PAR_ITERS = 100
PAR_TARGETS = (1.0 - 1.0 / 32, 1.0 + 1.0 / 32, 1.0)
PAR_VAL = (4, 32)                # validation batches x images
PAR_CAL_RTOL = 1e-6              # synced delta vs the mean of local ones
PAR_CAPTURE_RTOL = 1e-4          # ranks' caches vs one capture, of max|x|:
#                                  FP outputs all, quantized-prefix inputs
#                                  but PARITY_FLIPS of them (a 4-bit code
#                                  flipped at a tie of two summation orders)
INT8_WIRE_GAP = 0.25             # |hard int8 - hard f32| / hard f32


def par_settings(engine):
    return engine.ReconSettings(mode="fused", iters=PAR_ITERS,
                                batch_size=PAR_ROWS,
                                shift_targets=PAR_TARGETS)


def par_model(torch):
    """ImageNet ResNet-18 W2A4 at full width, numpy-drawn (host_params,
    PAR_SEED), MSE scales, 8-bit stem and head, on the card; its
    calibration, capture and validation images (numpy seeds) and the sim
    forward's flags. Identical in every process."""
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags
    from shiftedscalequantization_tpu_torch.models import zoo
    graph, _ = zoo.build("resnet18", dataset="imagenet")
    cfg = Q.QuantConfig(n_bits_w=2, n_bits_a=4)
    params, qs = Q.prepare_model(graph, host_params(torch, graph, PAR_SEED),
                                 cfg, device=DEVICE)
    return dict(graph=graph, cfg=cfg, params=params, qs=qs,
                aflags=Q.act_flags(graph, cfg,
                                   base=Flags().all_weights(graph)),
                cal=host_images(torch, PAR_CAL_IMAGES, 11),
                rows=host_images(torch, PAR_ROWS, 12),
                val_x=host_images(torch, PAR_VAL[0] * PAR_VAL[1], 13))


def par_data(torch, m, qs):
    """The validation batches, labelled with the calibrated sim model's
    top-1 on whole batches (one process): a sharded run that reproduces
    every prediction scores 100.0, where random or FP labels would leave
    a W2A4 model on random weights near 0 whatever the sharding did."""
    from shiftedscalequantization_tpu_torch.graph import forward
    b = PAR_VAL[1]
    out = []
    with torch.no_grad():
        for i in range(0, m["val_x"].shape[0], b):
            x = m["val_x"][i:i + b]
            out.append((x, forward(m["graph"], m["params"], qs, x,
                                   m["aflags"], device=DEVICE).argmax(-1)))
    return out


def theta_of(qs, units):
    return {u: {f: getattr(qs[u].wq, f).detach().cpu()
                for f in ("alpha", "beta")
                if getattr(qs[u].wq, f, None) is not None} for u in units}


def parallel_rank(tmp):
    """One rank of phases 38-41 (``chip_smoke.py --parallel-rank DIR``,
    started by parallel_phases with SSQ_* set): the kernel library the
    main process built, synced act calibration, sharded capture,
    ddp_reconstruct with each wire and sharded_validate, each with the
    kernel counters reset just before it; results to DIR/rank{r}.pt."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, \
        node_unit_names, find_node
    from shiftedscalequantization_tpu_torch.ops.cuda import _build
    from shiftedscalequantization_tpu_torch.parallel import dist as PD
    from shiftedscalequantization_tpu_torch.parallel import make_mesh
    from shiftedscalequantization_tpu_torch.parallel.collectives import \
        all_gather_rows
    from shiftedscalequantization_tpu_torch.recon import engine
    t0 = time.perf_counter()
    if not PD.init_multihost():
        raise RuntimeError("parallel rank: SSQ_NUM_PROCESSES is not set")
    rank, world = dist.get_rank(), dist.get_world_size()
    _build.load()
    out = dict(rank=rank, backend=dist.get_backend(),
               rule=PD.backend_for("cuda", world),
               device=str(PD.rank_device()), rebuilt=_build.build_seconds)
    mesh = make_mesh()
    m = par_model(torch)
    graph, cfg, params = m["graph"], m["cfg"], m["params"]
    torch.cuda.synchronize()
    secs = {"setup": time.perf_counter() - t0}
    counts_by = {}

    def run(name, fn):
        dist.barrier()
        reset_counts()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        counts_by[name] = counts()
        print(f"  rank {rank}: {name} {secs[name]:.3f} s", flush=True)
        return res

    qs = run("calibrate", lambda: PD.synced_calibrate_acts(
        graph, params, m["qs"], m["cal"], cfg, mesh))
    aflags = m["aflags"]
    ci, co = run("capture", lambda: PD.sharded_capture(
        graph, params, qs, PAR_TARGET, m["rows"], mesh, aflags, Flags(),
        batch_size=PAR_ROWS))
    group = mesh.group("data")
    gci, gco = all_gather_rows(ci, group), all_gather_rows(co, group)
    units = node_unit_names(find_node(graph, PAR_TARGET))
    # what the first reconstruction in a process pays once (cuDNN and
    # lazily loaded kernels; phase 17's probe), outside the timed runs
    run("recon warm-up", lambda: PD.ddp_reconstruct(
        graph, params, qs, PAR_TARGET, gci, gco, dataclasses.replace(
            par_settings(engine), iters=2), 0, mesh))
    for wire in ("f32", "int8"):
        rq, rm = run(f"recon {wire}", lambda: PD.ddp_reconstruct(
            graph, params, qs, PAR_TARGET, gci, gco,
            par_settings(engine), 0, mesh, wire=wire))
        out[f"recon {wire}"] = dict(
            theta=theta_of(rq, units), trace=rm["rec_trace"].cpu(),
            **{k: float(rm[k]) for k in ("init_loss", "soft_loss",
                                          "hard_loss")})
    data = par_data(torch, m, qs)
    out["acc"] = run("validate", lambda: PD.sharded_validate(
        graph, params, qs, data, mesh, aflags))
    out["sites"] = {k: (a.delta.cpu(), a.zero_point.cpu())
                    for k, a in ((k, getattr(v, "aq", v))
                                 for k, v in qs.items())
                    if a is not None and hasattr(a, "zero_point")}
    out.update(secs=secs, counts=counts_by,
               theta_numel=[v.numel() for t in out["recon f32"]["theta"]
                            .values() for v in t.values()])
    if rank == 0:
        out["caches"] = (gci.cpu(), gco.cpu())
        out["qstate"] = Q.to_device(qs, "cpu")
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def wire_bytes(numels, n, wire):
    """Bytes one rank sends per reduction of tensors of ``numels``
    elements plus the f32 loss, over ``n`` ranks: a ring all-reduce of
    f32 sends 2 (n - 1) / n x 4 bytes an element; the int8 wire's
    all_to_all (n - 1) / n x 1 and its int16 all-gather (n - 1) / n x 2
    bytes of each padded tensor, and the amaxes (f32, one a tensor) and
    tensors under 4n elements go as f32."""
    ring = 2 * (n - 1) / n * 4
    if wire == "f32":
        return ring * (sum(numels) + 1)
    big = [k for k in numels if k >= 4 * n]
    small = sum(k for k in numels if k < 4 * n) + 1
    padded = sum(k + (-k) % n for k in big)
    return (n - 1) / n * 3 * padded + ring * (small + len(big))


def parallel_phases(torch):
    """Phases 38-41 (see the module doc). Returns what the result lines
    report."""
    import socket
    import tempfile
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags
    from shiftedscalequantization_tpu_torch.recon import capture, engine
    from shiftedscalequantization_tpu_torch.utils.eval import validate_model

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "SSQ_NUM_PROCESSES": str(PAR_RANKS),
           "SSQ_COORDINATOR": f"localhost:{port}"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         tmp.name], env={**env, "SSQ_PROCESS_ID": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(PAR_RANKS)]
    try:
        m = par_model(torch)        # the single process's copy, meanwhile
        outs = [p.communicate(timeout=PAR_RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"parallel rank {r} exited {p.returncode}:"
                                 f"\n{o[-6000:]}")
        print("\n".join(line for line in o.splitlines()
                        if line.startswith("  rank")), flush=True)
    res = [torch.load(os.path.join(tmp.name, f"rank{r}.pt"),
                      weights_only=False) for r in range(PAR_RANKS)]
    tmp.cleanup()
    graph, cfg, params = m["graph"], m["cfg"], m["params"]
    print(f"  {PAR_RANKS} ranks on {res[0]['device']} / {res[1]['device']}, "
          f"backend {res[0]['backend']} (rule: {res[0]['rule']}: ranks "
          f"share one card, and NCCL refuses two ranks on one device); "
          f"kernel library rebuilt by a rank: "
          f"{[r['rebuilt'] for r in res]}; rank seconds "
          + "; ".join(f"rank {r['rank']} " + ", ".join(
              f"{k} {v:.3f}" for k, v in r["secs"].items()) for r in res),
          flush=True)
    if any(r["rebuilt"] is not None for r in res) \
            or {r["backend"] for r in res} != {"gloo"} \
            or res[0]["rule"] != "gloo":
        raise AssertionError("parallel ranks: a rank rebuilt the kernels or "
                             "the backend is not the rule's gloo")
    phase("parallel setup", t0)

    # ---- synced calibration against the mean of local ones ------------
    t0 = time.perf_counter()
    share = PAR_CAL_IMAGES // PAR_RANKS
    local, ref_counts = [], [{} for _ in res]
    for r in range(PAR_RANKS):
        reset_counts()
        local.append(Q.calibrate_acts(graph, params, m["qs"],
                                      m["cal"][r * share:(r + 1) * share],
                                      cfg, device=DEVICE))
        torch.cuda.synchronize()
        ref_counts[r]["calibrate"] = counts()
    sites = res[0]["sites"]
    worst = 0.0
    for k, (delta, zp) in sites.items():
        for other in res[1:]:
            if not (torch.equal(other["sites"][k][0], delta)
                    and torch.equal(other["sites"][k][1], zp)):
                raise AssertionError(f"synced {k} differs between ranks")
        locs = [getattr(q[k], "aq", q[k]) for q in local]
        mean = sum(a.delta.double().cpu() for a in locs) / len(locs)
        worst = max(worst, float(((delta.double() - mean).abs()
                                  / mean.abs()).max()))
        if not torch.equal(zp, torch.round(zp)):
            raise AssertionError(f"synced {k}: zero point not integral")
    print(f"  synced calibration ({len(sites)} act sites, {share} images "
          f"a rank): deltas equal on both ranks; max rel diff to the mean "
          f"of the two local calibrations {worst:.3g} (gate "
          f"{PAR_CAL_RTOL:g}); zero points integral", flush=True)
    if not worst <= PAR_CAL_RTOL:
        raise AssertionError(f"synced calibration: rel diff {worst}")
    qs = Q.to_device(res[0]["qstate"], DEVICE)
    phase("parallel calibrate", t0)

    # ---- ddp reconstruction against the single process ----------------
    t0 = time.perf_counter()
    aflags = m["aflags"]
    rows = PAR_ROWS // PAR_RANKS
    for r in range(PAR_RANKS):
        reset_counts()
        capture.capture_io(graph, params, qs, PAR_TARGET,
                           m["rows"][r * rows:(r + 1) * rows], aflags,
                           Flags(), batch_size=PAR_ROWS, device=DEVICE)
        torch.cuda.synchronize()
        ref_counts[r]["capture"] = counts()
    gci, gco = (t.to(DEVICE) for t in res[0]["caches"])
    ci, co = capture.capture_io(graph, params, qs, PAR_TARGET, m["rows"],
                                aflags, Flags(), batch_size=PAR_ROWS,
                                device=DEVICE)
    cap_err = float((gco - co).abs().max() / co.abs().max())
    cap_flips = float(((gci - ci).abs() > PAR_CAPTURE_RTOL
                       * ci.abs().max()).double().mean())
    reset_counts()
    t1 = time.perf_counter()
    _, sm = engine.reconstruct_node(graph, params, qs, PAR_TARGET, gci, gco,
                                    par_settings(engine), seed=0)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t1
    single_counts = counts()
    want = sm["rec_trace"].double().cpu()
    rec = {}
    for wire in ("f32", "int8"):
        a, b = (r[f"recon {wire}"] for r in res)
        same = torch.equal(a["trace"], b["trace"]) and all(
            torch.equal(a["theta"][u][f], b["theta"][u][f])
            for u in a["theta"] for f in a["theta"][u]) and all(
            a[k] == b[k] for k in ("init_loss", "soft_loss", "hard_loss"))
        tr = a["trace"].double()
        means = (float(tr[:10].mean()), float(tr[-10:].mean()))
        rec[wire] = dict(
            steps_per_s=[PAR_ITERS / r["secs"][f"recon {wire}"]
                         for r in res],
            wire_bytes_per_step=wire_bytes(res[0]["theta_numel"], PAR_RANKS,
                                           wire),
            trace_first10_last10=means, ranks_identical=same,
            trace_rel_to_single=float(((tr - want).abs() / want.abs())
                                      .max()),
            **{k: a[k] for k in ("init_loss", "soft_loss", "hard_loss")})
    rec["int8_hard_gap"] = abs(rec["int8"]["hard_loss"]
                               - rec["f32"]["hard_loss"]) \
        / abs(rec["f32"]["hard_loss"])
    for wire in ("f32", "int8"):
        w = rec[wire]
        print(f"  ddp_reconstruct {PAR_TARGET}, wire {wire}, {PAR_ITERS} "
              f"steps of {rows} rows a rank (gloo through one card, 2 ranks "
              f"on cuda:0, not NCCL): steps/s "
              + " / ".join(f"{v:.2f}" for v in w["steps_per_s"])
              + f"; wire {w['wire_bytes_per_step']:.0f} bytes a rank a step "
              f"({sum(res[0]['theta_numel'])} theta elements); loss before "
              f"{w['init_loss']:.6g}, soft {w['soft_loss']:.6g}, hard "
              f"{w['hard_loss']:.6g}; trace {w['trace_first10_last10'][0]:.6g}"
              f" -> {w['trace_first10_last10'][1]:.6g}; ranks bit-identical "
              f"{w['ranks_identical']}; trace vs the single process max rel "
              f"{w['trace_rel_to_single']:.3g}", flush=True)
    print(f"  single process on the card: {PAR_ITERS} steps of {PAR_ROWS} "
          f"rows in {single_s:.3f} s ({PAR_ITERS / single_s:.2f} steps/s), "
          f"hard {float(sm['hard_loss']):.6g}; int8 vs f32 hard-loss gap "
          f"{rec['int8_hard_gap']:.4g} (gate {INT8_WIRE_GAP:g}); ranks' "
          f"caches vs one capture: FP outputs max rel {cap_err:.3g} (gate "
          f"{PAR_CAPTURE_RTOL:g}), inputs off by more than that "
          f"{cap_flips:.3g} (gate {PARITY_FLIPS:g})", flush=True)
    for wire in ("f32", "int8"):
        w = rec[wire]
        if not (w["ranks_identical"] and w["trace_first10_last10"][1]
                <= w["trace_first10_last10"][0]):
            raise AssertionError(f"ddp {wire}: ranks differ or the trace "
                                 f"rose: {w}")
    if not (rec["f32"]["trace_rel_to_single"] <= PARITY_RTOL
            and rec["int8_hard_gap"] <= INT8_WIRE_GAP
            and cap_err <= PAR_CAPTURE_RTOL and cap_flips <= PARITY_FLIPS):
        raise AssertionError(f"ddp reconstruction gates: {rec}, captures "
                             f"{cap_err} {cap_flips}")
    phase("parallel recon", t0)

    # ---- sharded validation against one process; the launches ---------
    t0 = time.perf_counter()
    data = par_data(torch, m, qs)
    acc = validate_model(graph, params, qs, data, aflags)
    b = PAR_VAL[1] // PAR_RANKS
    for r in range(PAR_RANKS):
        reset_counts()
        validate_model(graph, params, qs, [(x[r * b:(r + 1) * b],
                                            y[r * b:(r + 1) * b])
                                           for x, y in data], aflags)
        torch.cuda.synchronize()
        ref_counts[r]["validate"] = counts()
    launches = [{k: r["counts"][k]["fake_quant_act"] for k in
                 ("calibrate", "capture", "validate")} for r in res]
    print(f"  sharded_validate over {PAR_VAL[0]} x {PAR_VAL[1]} images "
          f"(labels: the one-process sim top-1): {[r['acc'] for r in res]}; "
          f"one "
          f"process {acc}; fake_quant_act launches by rank "
          f"{launches}, by the single process on each rank's share "
          f"{[{k: c[k]['fake_quant_act'] for k in c} for c in ref_counts]}"
          f"; recon launches a rank f32 {res[0]['counts']['recon f32']}, "
          f"single process {single_counts}", flush=True)
    if any(r["acc"] != acc for r in res):
        raise AssertionError(f"sharded_validate {[r['acc'] for r in res]} "
                             f"!= {acc}")
    for r, c in zip(res, ref_counts):
        if any(r["counts"][k] != c[k] for k in c) \
                or not sum(launches[r["rank"]].values()) > 0:
            raise AssertionError(f"rank {r['rank']} launches "
                                 f"{r['counts']} != {c}")
    phase("parallel validate", t0)
    return dict(recon=rec, acc=acc, launches=launches,
                secs=[r["secs"] for r in res], single_steps_per_s=PAR_ITERS
                / single_s, cal_rel=worst, capture_rel=cap_err,
                capture_in_off=cap_flips, backend=res[0]["backend"])


# ---------------------------------------------------------------------------
# FP training, sweep and profiling (phases 42-45)
# ---------------------------------------------------------------------------

TOOLS_LIMIT_S = 150              # phases 42-45 together
TRAIN_ARCH = "resnet18"          # CIFAR variant: published widths 64-512
TRAIN_STEPS = 300
TRAIN_BATCH = 256
TRAIN_CHUNK = 100
TRAIN_LR = 0.1
TRAIN_TOP1_GATE = 30.0           # held-out top-1 %, 3x chance
PAR_STEPS = 3                    # phase 43: card vs CPU, three steps
PAR_BATCH = 16
TRAIN_LOSS_RTOL = 1e-4           # each step's loss, card vs CPU
TRAIN_PARAM_RTOL = 1e-3          # final params, and BN running stats:
#                                  relative L2 over each set
GRAD_F64_RTOL = 1e-2             # the card's f32 gradient vs float64: the
#   f32 backward of a train-mode BN net loses ~1e-3 to the convs'
#   algorithms (phase 43 prints the card's and the CPU's); TF32 rounds a
#   conv's output hundreds of times coarser than f32 (phase 45)
# phase 44: the port's CLI (brecq, phase 27's flags cut) from phase 42's
# trained checkpoint, over a two-combo grid
SWEEP_BASE = ["--arch", "resnet18", "--dataset", "synth10", "--mode",
              "brecq", "--n_bits_a", "4", "--iters_w", "40", "--iters_a",
              "20", "--num_samples", "64"]
SWEEP_GRID = "n_bits_w=2,4"
PROFILE_INNER = 20               # phase 45: launches timed per node
# phase 45's roofline shares count a conv's direct multiply-adds against
# the f32 FMA peak, but cuDNN's f32 3x3 convs (TF32 off, f32 accuracy)
# run algorithms with fewer multiplies and beat that peak (phase 45
# prints one: layer3.1's conv); Winograd F(4x4, 3x3) does 4x fewer
# multiplies, so a share above 4 is a timing that missed the work.
PROFILE_ROOF_MAX = 4.0
F32_CONV_RTOL = 1e-5             # that conv vs float64: TF32 is off


def live_children():
    """PIDs of this process's children that are still running or unreaped
    (/proc/<pid>/task/*/children)."""
    import glob
    pids = []
    for path in glob.glob(f"/proc/{os.getpid()}/task/*/children"):
        with open(path) as f:
            pids += f.read().split()
    return pids


def _to(raw, dev):
    return {n: {k: ({s: t.to(dev) for s, t in v.items()} if k == "bn"
                    else v.to(dev)) for k, v in p.items()}
            for n, p in raw.items()}


def _flat(torch, raw, stats):
    """raw params as one float64 CPU vector: the trainable tensors, or
    with ``stats`` the BN running stats."""
    parts = []
    for p in raw.values():
        ts = [p["bn"][k] for k in ("mean", "var")] if stats and "bn" in p \
            else [] if stats else [p["w"], *([p["b"]] if "b" in p else []),
                                   *([p["bn"]["gamma"], p["bn"]["beta"]]
                                     if "bn" in p else [])]
        parts += [t.detach().double().cpu().reshape(-1) for t in ts]
    return torch.cat(parts)


def _rel_l2(torch, a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _tensor_worst(torch, got, want):
    """(worst per-tensor relative L2, 'unit/key/stat') of two raw dicts."""
    return max((_rel_l2(torch, got[n]["bn"][s] if k == "bn" else got[n][k],
                        want[n]["bn"][s] if k == "bn" else want[n][k]),
                f"{n}/{k}/{s}")
               for n in want for k in want[n]
               for s in (want[n]["bn"] if k == "bn" else [""]))


def train_phase(torch, train, graph, raw_cpu):
    """Phase 42: train_model on the card, full width. Returns the trained
    raw params, its held-out top-1 and what the result line reports."""
    from shiftedscalequantization_tpu_torch.data.realdata import \
        synth10_test_arrays
    t0 = time.perf_counter()
    seen = []

    def log(line):
        seen.append((time.perf_counter(), line))

    data_fn = train.make_data_fn("synth10", TRAIN_BATCH)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    torch.cuda.synchronize()
    start = time.perf_counter()
    trained = train.train_model(graph, raw_cpu, data_fn, TRAIN_STEPS,
                                TRAIN_LR, gen, chunk=TRAIN_CHUNK, log=log,
                                device=DEVICE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    chunks = []
    prev = start
    for t, line in seen:
        f = line.split()
        chunks.append(dict(step=int(f[1].split("/")[0]), loss=float(f[3]),
                           train_acc=float(f[5].rstrip("%")),
                           steps_per_s=TRAIN_CHUNK / (t - prev)))
        prev = t
    x_te, y_te = synth10_test_arrays()
    top1 = train.eval_accuracy(graph, *train.split_params(trained), x_te,
                               y_te, device=DEVICE)
    steps_per_s = len(chunks) * TRAIN_CHUNK / secs
    print(f"  train {TRAIN_ARCH} (CIFAR variant, widths 64-512) on synth10 "
          f"drawn on the card, batch {TRAIN_BATCH}, {TRAIN_STEPS} steps, lr "
          f"{TRAIN_LR}, f32 with TF32 off: {secs:.2f} s, {steps_per_s:.2f} "
          f"steps/s, {steps_per_s * TRAIN_BATCH:.1f} images/s (chunks: "
          + "; ".join(f"to step {c['step']} loss {c['loss']} train-acc "
                      f"{c['train_acc']}% {c['steps_per_s']:.2f} steps/s"
                      for c in chunks)
          + f"); held-out top-1 {top1:.4f}% on {len(y_te)} images (gate >= "
          f"{TRAIN_TOP1_GATE})", flush=True)
    if len(chunks) != math.ceil(TRAIN_STEPS / TRAIN_CHUNK) \
            or not all(math.isfinite(c["loss"]) for c in chunks):
        raise AssertionError(f"train: chunks {chunks}")
    if not chunks[-1]["loss"] < chunks[0]["loss"]:
        raise AssertionError(f"train: last chunk's loss {chunks[-1]['loss']}"
                             f" not below the first's {chunks[0]['loss']}")
    if not top1 >= TRAIN_TOP1_GATE:
        raise AssertionError(f"train: held-out top-1 {top1}")
    phase("train", t0)
    return trained, top1, dict(seconds=secs, steps_per_s=steps_per_s,
                               images_per_s=steps_per_s * TRAIN_BATCH,
                               chunks=chunks, top1=top1, images=len(y_te))


def _grads(torch, train, graph, raw_cpu, x, y, dev, dtype):
    """The trainer's loss gradient at ``raw_cpu`` on (x, y), computed on
    ``dev`` in ``dtype``, as one float64 CPU vector."""
    from shiftedscalequantization_tpu_torch.graph import _fp32
    trainable, bn = train.split_params(raw_cpu)
    trainable = {n: {k: v.to(dev, dtype, copy=True).requires_grad_()
                     for k, v in p.items()} for n, p in trainable.items()}
    bn = {n: {k: v.to(dev, dtype) for k, v in p.items()}
          for n, p in bn.items()}
    with _fp32():
        logits, _ = train.forward_train(graph, trainable, bn,
                                        x.to(dev, dtype), True)
        train.smoothed_cross_entropy(logits, y.to(dev)).backward()
    return torch.cat([v.grad.double().cpu().reshape(-1)
                      for p in trainable.values() for v in p.values()])


def train_parity_phase(torch, train, graph, raw_cpu, trained, top1, tmp):
    """Phase 43: the first PAR_STEPS steps of phase 42's schedule from the
    same initial params on fixed CPU-drawn batches, on the card and on
    the CPU; the first batch's gradient in f32 on each against float64 on
    the card; then phase 42's params through save_raw_params /
    load_raw_params and eval_accuracy again. Returns the npz path and
    what the result line reports."""
    from shiftedscalequantization_tpu_torch.data.realdata import \
        synth10_draws, synth10_render, synth10_test_arrays
    t0 = time.perf_counter()
    batches = [synth10_render(synth10_draws(PAR_BATCH, seed=100 + i))
               for i in range(PAR_STEPS)]
    runs, secs = {}, {}
    for dev in (DEVICE, "cpu"):
        t = time.perf_counter()
        trainable, bn = train.split_params(_to(raw_cpu, dev))
        trainable = {n: {k: v.clone().requires_grad_() for k, v in p.items()}
                     for n, p in trainable.items()}
        opt, sched = train.make_optimizer(trainable, TRAIN_LR, TRAIN_STEPS)
        losses = []
        for x, y in batches:
            bn, loss, _ = train.train_step(graph, trainable, bn, opt, sched,
                                           x.to(dev), y.to(dev))
            losses.append(float(loss))
        runs[dev] = (losses, train.merge_params(trainable, bn))
        secs[dev] = time.perf_counter() - t
    (lc, pc), (lh, ph) = runs[DEVICE], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    flat0 = _flat(torch, raw_cpu, False)
    param_rel = _rel_l2(torch, _flat(torch, pc, False),
                        _flat(torch, ph, False))
    update_rel = _rel_l2(torch, _flat(torch, pc, False) - flat0,
                         _flat(torch, ph, False) - flat0)
    stats_rel = _rel_l2(torch, _flat(torch, pc, True), _flat(torch, ph, True))
    worst = _tensor_worst(torch, pc, ph)
    x, y = batches[0]
    g64 = _grads(torch, train, graph, raw_cpu, x, y, DEVICE, torch.float64)
    grad_rel = {dev: _rel_l2(torch, _grads(torch, train, graph, raw_cpu, x,
                                           y, dev, torch.float32), g64)
                for dev in (DEVICE, "cpu")}
    path = os.path.join(tmp, "trained_resnet18_synth10.npz")
    train.save_raw_params(path, trained)
    back = train.load_raw_params(path, device=DEVICE)
    x_te, y_te = synth10_test_arrays()
    top1_back = train.eval_accuracy(graph, *train.split_params(back), x_te,
                                    y_te, device=DEVICE)
    print(f"  card vs CPU ({torch.get_num_threads()} threads), the first "
          f"{PAR_STEPS} steps of phase 42's schedule at batch {PAR_BATCH}: "
          f"losses card {lc} CPU {lh}, worst rel {loss_rel:.3e} (gate "
          f"{TRAIN_LOSS_RTOL:g}); final params rel L2 {param_rel:.3e}, BN "
          f"running stats {stats_rel:.3e} (gate {TRAIN_PARAM_RTOL:g} each); "
          f"the updates {update_rel:.3e}; worst tensor {worst[0]:.3e} at "
          f"{worst[1]}; the first gradient in f32 against float64 on the "
          f"card: card {grad_rel[DEVICE]:.3e} (gate {GRAD_F64_RTOL:g}), CPU "
          f"{grad_rel['cpu']:.3e}; seconds: card {secs[DEVICE]:.2f}, CPU "
          f"{secs['cpu']:.2f}; saved and reloaded ({os.path.getsize(path)} "
          f"bytes): top-1 {top1_back:.4f} (phase 42 {top1:.4f})", flush=True)
    if not (loss_rel <= TRAIN_LOSS_RTOL and param_rel <= TRAIN_PARAM_RTOL
            and stats_rel <= TRAIN_PARAM_RTOL
            and grad_rel[DEVICE] <= GRAD_F64_RTOL):
        raise AssertionError(f"train card vs CPU: loss {loss_rel}, params "
                             f"{param_rel}, BN stats {stats_rel}, gradient "
                             f"vs f64 {grad_rel}")
    if top1_back != top1:
        raise AssertionError(f"reloaded top-1 {top1_back} != {top1}")
    phase("train parity", t0)
    return path, dict(losses_card=lc, losses_cpu=lh, loss_rel=loss_rel,
                      param_rel_l2=param_rel, update_rel_l2=update_rel,
                      bn_stats_rel_l2=stats_rel, worst_tensor=worst,
                      grad_f32_vs_f64={"card": grad_rel[DEVICE],
                                       "cpu": grad_rel["cpu"]},
                      cpu_threads=torch.get_num_threads(),
                      card_s=secs[DEVICE], cpu_s=secs["cpu"],
                      reloaded_top1=top1_back)


def sweep_phase(npz, tmp):
    """Phase 44: utils.sweep.main over SWEEP_GRID on the port's CLI from
    phase 43's checkpoint; then the same call again, which runs nothing.
    The sweep logs a failed run as an error record and goes on, so the
    records are the gate."""
    from shiftedscalequantization_tpu_torch.utils import sweep
    t0 = time.perf_counter()
    out = os.path.join(tmp, "sweep.jsonl")
    base = " ".join(SWEEP_BASE + [
        "--pretrained", npz, "--checkpoint_dir", os.path.join(tmp, "ckpt"),
        "--log_path", os.path.join(tmp, "cli.log")])
    argv = ["--base", base, "--grid", SWEEP_GRID, "--out", out]
    print(f"  sweep: python -m shiftedscalequantization_tpu_torch.utils.sweep"
          f" {' '.join(repr(a) if ' ' in a else a for a in argv)}",
          flush=True)
    import io
    cli_out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(cli_out):
        recs = sweep.main(argv)
    launches = counts()
    with open(out) as f:
        logged = [json.loads(line) for line in f]
    again = sweep.main(argv)
    print(f"  sweep records {recs}; fake_quant launches "
          f"{ {k: v for k, v in launches.items() if v} }; the same call "
          f"again ran {len(again)}", flush=True)
    top1s = [r.get("result", {}).get("top1") for r in recs]
    if len(recs) != 2 or logged != recs or any("error" in r for r in recs) \
            or not all(isinstance(t, float) and math.isfinite(t)
                       for t in top1s):
        raise AssertionError(f"sweep records {recs}\n"
                             f"{cli_out.getvalue()[-4000:]}")
    if not launches["fake_quant_act"] > 0 or again:
        raise AssertionError(f"sweep: launches {launches}, rerun {again}")
    phase("sweep", t0)
    return dict(records=recs, launches={k: v for k, v in launches.items()
                                        if v}, rerun=len(again))


def profiling_phase(torch, recon_sim_ms, tmp):
    """Phase 45: profiling.layer_timing on ImageNet ResNet-18 W2A4, the
    sim forward with weights and act sites on, batch 256, graph_flops
    beside; one sim forward under profiling.trace."""
    import glob
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, _fp32, \
        conv2d, forward
    from shiftedscalequantization_tpu_torch.models import zoo
    from shiftedscalequantization_tpu_torch.utils import profiling
    t0 = time.perf_counter()
    graph, _ = zoo.build("resnet18", dataset="imagenet")
    cfg = Q.QuantConfig(n_bits_w=2, n_bits_a=4)
    gen = torch.Generator(device=DEVICE).manual_seed(45)
    params, qs = Q.prepare_model(
        graph, zoo.init_params(graph, seed=45, device=DEVICE), cfg,
        device=DEVICE)
    qs = Q.calibrate_acts(graph, params, qs, torch.randn(
        (16, HW, HW, 3), generator=gen, device=DEVICE), cfg, device=DEVICE)
    flags = Q.act_flags(graph, cfg, base=Flags().all_weights(graph))
    x = torch.randn((BATCH, HW, HW, 3), generator=gen, device=DEVICE)
    reset_counts()
    rows = profiling.layer_timing(graph, params, qs, x, flags,
                                  peak_flops=F32_FLOPS, inner=PROFILE_INNER,
                                  device=DEVICE)
    torch.cuda.synchronize()
    launches = {k: v for k, v in counts().items() if v}
    total, per = profiling.graph_flops(graph, (HW, HW), BATCH)
    whole_ms = time_cuda(lambda: forward(graph, params, qs, x, flags,
                                         device=DEVICE), iters=3, warmup=1)
    rows_ms = sum(r["ms"] for r in rows)
    print(profiling.format_timing(rows), flush=True)
    print(f"  layer_timing: {len(rows)} nodes, inner {PROFILE_INNER}, "
          f"roofline against {F32_FLOPS:g} FLOP/s (H100 SXM f32 outside "
          f"the tensor cores, NVIDIA's data sheet; apply_node runs f32 with "
          f"TF32 off); sum of rows {rows_ms:.3f} ms, this state's whole sim "
          f"forward {whole_ms:.3f} ms, phase 19's {recon_sim_ms:.3f} ms; "
          f"graph_flops {total / 1e9:.2f} GFLOP, rows "
          f"{sum(r['gflop'] for r in rows):.2f}; launches {launches}",
          flush=True)
    # one f32 3x3 conv at layer3.1's shape through the graph's conv2d,
    # TF32 off: its rate against the f32 peak and its error against f64
    cx = torch.randn((BATCH, 14, 14, 256), generator=gen, device=DEVICE)
    cw = torch.randn((256, 256, 3, 3), generator=gen, device=DEVICE) \
        * math.sqrt(2 / 2304)
    with _fp32():
        conv_ms = time_cuda(lambda: conv2d(cx, cw, None, (1, 1), (1, 1), 1))
        conv_out = conv2d(cx, cw, None, (1, 1), (1, 1), 1)
    conv_ref = conv2d(cx.double(), cw.double(), None, (1, 1), (1, 1), 1)
    conv_err = _rel_l2(torch, conv_out, conv_ref)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True       # a reading beside it
    try:
        tf32_ms = time_cuda(lambda: conv2d(cx, cw, None, (1, 1), (1, 1), 1))
        tf32_err = _rel_l2(torch, conv2d(cx, cw, None, (1, 1), (1, 1), 1),
                           conv_ref)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    conv_flop = 2 * BATCH * 14 * 14 * 256 * 256 * 9
    conv_tflops = conv_flop / conv_ms / 1e9
    print(f"  f32 3x3 conv at layer3.1's shape (cuDNN, TF32 off): "
          f"{conv_ms:.4f} ms, {conv_tflops:.1f} TFLOP/s of direct "
          f"multiply-adds ({conv_tflops * 1e12 / F32_FLOPS:.3f} of the f32 "
          f"peak), rel. error vs float64 {conv_err:.3e} (gate "
          f"{F32_CONV_RTOL:g}); with TF32 on {tf32_ms:.4f} ms, "
          f"{conv_flop / tf32_ms / 1e9:.1f} TFLOP/s, error {tf32_err:.3e}",
          flush=True)
    if not all(r["ms"] > 0 and math.isfinite(r["ms"])
               and r["roofline_frac"] <= PROFILE_ROOF_MAX for r in rows):
        raise AssertionError(f"layer_timing rows {rows}")
    if not conv_err <= F32_CONV_RTOL:
        raise AssertionError(f"f32 conv error {conv_err}: TF32 on?")
    if {r["name"]: r["gflop"] * 1e9 for r in rows} != \
            {k: float(v) for k, v in per.items()} \
            or not launches.get("fake_quant_act", 0) > 0:
        raise AssertionError(f"layer_timing flops or launches: {launches}")
    logdir = os.path.join(tmp, "trace")
    with profiling.trace(logdir):
        forward(graph, params, qs, x, flags, device=DEVICE)
        torch.cuda.synchronize()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    kernels = []
    for path in files:
        with open(path) as f:
            kernels += [e["name"] for e in json.load(f)["traceEvents"]
                        if e.get("cat") == "kernel"]
    fq = sorted({k for k in kernels if "fake_quant" in k})
    print(f"  trace: {len(files)} file(s), {sum(map(os.path.getsize, files))}"
          f" bytes, {len(kernels)} CUDA kernel events, fake_quant kernels "
          f"{fq} ({sum('fake_quant' in k for k in kernels)} launches)",
          flush=True)
    if len(files) != 1 or not fq:
        raise AssertionError(f"trace: files {files}, kernels "
                             f"{sorted(set(kernels))[:20]}")
    phase("profiling", t0)
    return dict(rows=rows, rows_ms=rows_ms, whole_sim_ms=whole_ms,
                recon_sim_ms=recon_sim_ms, gflop=total / 1e9,
                f32_conv={"ms": conv_ms, "tflops": conv_tflops,
                          "rel_err_vs_f64": conv_err, "tf32_ms": tf32_ms,
                          "tf32_rel_err_vs_f64": tf32_err},
                launches=launches, trace_kernel_events=len(kernels),
                trace_fake_quant=fq)


def tools_phases(torch, recon_sim_ms):
    """Phases 42-45 (see the module doc). Every file goes to a temporary
    directory. Returns what the result lines report."""
    import tempfile
    from shiftedscalequantization_tpu_torch import train
    from shiftedscalequantization_tpu_torch.models import zoo
    alive = live_children()
    print(f"  before phase 42: child processes alive {alive}, process "
          f"group initialized {torch.distributed.is_initialized()}",
          flush=True)
    if alive or torch.distributed.is_initialized():
        raise AssertionError(f"processes {alive} or a process group left")
    tmp = tempfile.TemporaryDirectory()
    graph, _ = zoo.build(TRAIN_ARCH, num_classes=10, dataset="cifar10")
    raw_cpu = zoo.init_params(graph, seed=0, device="cpu")
    trained, top1, tr = train_phase(torch, train, graph, raw_cpu)
    npz, par = train_parity_phase(torch, train, graph, raw_cpu, trained,
                                  top1, tmp.name)
    sw = sweep_phase(npz, tmp.name)
    prof = profiling_phase(torch, recon_sim_ms, tmp.name)
    tmp.cleanup()
    return dict(train=tr, train_parity=par, sweep=sw, profiling=prof)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--parallel-rank"]:
        return parallel_rank(sys.argv[2])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from shiftedscalequantization_tpu_torch import deploy
    from shiftedscalequantization_tpu_torch import quantize as Q
    from shiftedscalequantization_tpu_torch.graph import Flags, forward
    from shiftedscalequantization_tpu_torch.ops.cuda import _build, \
        depthwise, int_matmul, mbconv, packed, requant, stem
    from shiftedscalequantization_tpu_torch.ops.cuda import fake_quant as fq
    from shiftedscalequantization_tpu_torch.recon import engine

    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} (count {count}); nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    phase("device", t0)

    t0 = time.perf_counter()
    _build.load()
    built = _build.build_seconds
    print("  nvcc build " + (f"{built:.2f} s" if built is not None
                             else "reused (same sources)"), flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            print("  ptxas " + line.strip().removeprefix("ptxas info    : "),
                  flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stem_rows = check_stem(torch, gen, stem)
    qmm_rows = check_quant_matmul(torch, gen, int_matmul)
    phase("kernels", t0)

    t0 = time.perf_counter()
    os.environ.update(SSQ_STEM_KERNEL="1", SSQ_PACKED="1",
                      SSQ_STEM_1PASS="0")
    graph, cfg, params, qstate, dparams, steps = serving_setup(torch, gen)
    plan = deploy.make_deploy_plan(graph, dparams, steps,
                                   input_hw=(HW, HW))
    kinds = [v[0] for k, v in plan.items() if not k.startswith("__")]
    if kinds.count("stem_fused") != 1 or kinds.count("packed") != 3:
        raise AssertionError(f"plan kinds {kinds}")
    torch.cuda.synchronize()
    print(f"  setup (init, BN fold, MSE scales, calibration, deploy "
          f"conversion) {time.perf_counter() - t0:.2f} s; plan kinds "
          f"{sorted(set(kinds))}", flush=True)
    x = torch.randn((BATCH, HW, HW, 3), generator=gen, device="cuda")
    reset_counts()
    logits = deploy.deploy_forward(graph, dparams, steps, x, plan=plan,
                                   device="cuda")
    torch.cuda.synchronize()
    launches = counts()
    unfused = {"resnet18": launches.pop("unfused")}
    print(f"  launches in one deploy forward: {launches}; requants left "
          f"to PyTorch elementwise: {unfused['resnet18']}", flush=True)
    check_counts(launches, stem_fused=1, packed_quant_matmul=3, int8_conv=16)
    check_unfused(unfused["resnet18"], "resnet18")
    if tuple(logits.shape) != (BATCH, 1000) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("deploy logits not finite or misshapen")
    fwd = lambda: deploy.deploy_forward(graph, dparams, steps, x,  # noqa
                                        plan=plan, device="cuda")
    deploy_ms = time_cuda(fwd, iters=5, warmup=1)
    print(f"  deploy forward batch {BATCH}: {deploy_ms:.3f} ms/batch",
          flush=True)
    uniform_conv_shapes = int8_conv_shapes(graph, plan)
    phase("serving", t0)

    t0 = time.perf_counter()
    packed_rows = check_packed(torch, gen, packed, requant, deploy,
                               packed_shapes(graph, dparams, plan))
    if [r["roles"] for r in packed_rows] != [{"sums": 1}] * 3:
        raise AssertionError(f"packed roles {packed_rows}")
    phase("packed kernel", t0)

    t0 = time.perf_counter()
    flags = Q.act_flags(graph, cfg, base=Flags().all_weights(graph))
    sim = forward(graph, params, qstate, x, flags, device="cuda")
    torch.cuda.synchronize()
    sim64, dep64 = sim.double(), logits.double()
    if not bool(torch.isfinite(sim64).all()):
        raise AssertionError("sim logits not finite")
    rel_mse = float(((sim64 - dep64) ** 2).mean()
                    / (sim64 ** 2).mean().clamp_min(1e-30))
    agree = float((sim64.argmax(-1) == dep64.argmax(-1)).double().mean())
    print(f"  deploy vs sim: logit rel-MSE {rel_mse:.4e} (gate "
          f"{RELMSE_GATE:g}), top-1 agreement {agree:.4f}", flush=True)
    if not rel_mse <= RELMSE_GATE:
        raise AssertionError(f"parity gate failed: rel-MSE {rel_mse}")
    phase("parity", t0)

    # ---- MobileNetV2 ------------------------------------------------
    t0 = time.perf_counter()
    os.environ.update(SSQ_STEM_KERNEL="0", SSQ_PACKED="1", SSQ_DW_KERNEL="1",
                      SSQ_STEM_1PASS="1")
    mg, mcfg, mparams, mqstate, mdparams, msteps = serving_setup(
        torch, gen, "mobilenetv2")
    mplan = deploy.make_deploy_plan(mg, mdparams, msteps, input_hw=(HW, HW))
    mkinds = [v[0] for k, v in mplan.items() if not k.startswith("__")]
    mkind_counts = {k: mkinds.count(k) for k in sorted(set(mkinds))}
    torch.cuda.synchronize()
    print(f"  setup {time.perf_counter() - t0:.2f} s; plan kinds "
          f"{mkind_counts}", flush=True)
    if mkind_counts != MNV2_KINDS:
        raise AssertionError(f"MobileNetV2 plan kinds {mkind_counts}, want "
                             f"{MNV2_KINDS}")
    mdw_shapes = dw_shapes(mg, mplan)
    mpk_shapes = packed_shapes(mg, mdparams, mplan)
    phase("mnv2 setup", t0)

    t0 = time.perf_counter()
    dw_rows = check_dw(torch, gen, depthwise, mdw_shapes)
    if sum(r["count"] for r in dw_rows) != 16 or len(dw_rows) != 10:
        raise AssertionError(f"dw shapes {mdw_shapes}")
    phase("dw kernel", t0)

    t0 = time.perf_counter()
    mpk_rows = check_packed(torch, gen, packed, requant, deploy, mpk_shapes,
                            iters=5)
    if sum(sum(r["roles"].values()) for r in mpk_rows) != 34:
        raise AssertionError(f"packed shapes {mpk_shapes}")
    phase("packed kernel", t0)

    t0 = time.perf_counter()
    mb_rows = check_mbconv(torch, gen, mbconv, mpk_rows, dw_rows)
    if sum(r["count"] for r in mb_rows) != 13:
        raise AssertionError(f"mbconv shapes {mb_rows}")
    mb3 = sum(r["ms"] for r in mb_rows if r["name"] in MBCONV_3SHAPES)
    print(f"  mbconv 13 blocks {sum(r['ms'] * r['count'] for r in mb_rows):.4f}"
          f" ms (features.1 + .3 + .15 {mb3:.4f}); the served units packed"
          f" + dw {sum(r['units_ms'] * r['count'] for r in mb_rows):.4f}",
          flush=True)
    phase("mbconv kernel", t0)

    t0 = time.perf_counter()
    mx = torch.randn((BATCH, HW, HW, 3), generator=gen, device="cuda")
    reset_counts()
    mlogits = deploy.deploy_forward(mg, mdparams, msteps, mx, plan=mplan,
                                    device="cuda")
    torch.cuda.synchronize()
    mlaunches = counts()
    unfused["mobilenetv2"] = mlaunches.pop("unfused")
    print(f"  launches in one deploy forward: {mlaunches}; requants left "
          f"to PyTorch elementwise: {unfused['mobilenetv2']}", flush=True)
    check_counts(mlaunches, dw_conv3x3_int8=16, packed_quant_matmul=34,
                 stem_fused=0, mbconv_fused=0, int8_conv=0, dw_conv_int8=1)
    check_unfused(unfused["mobilenetv2"], "mobilenetv2")
    if tuple(mlogits.shape) != (BATCH, 1000) \
            or not bool(torch.isfinite(mlogits).all()):
        raise AssertionError("deploy logits not finite or misshapen")
    mdeploy_ms = time_cuda(
        lambda: deploy.deploy_forward(mg, mdparams, msteps, mx, plan=mplan,
                                      device="cuda"), iters=5, warmup=1)
    params_bf16 = {u: {k: v.to(torch.bfloat16) for k, v in p.items()}
                   for u, p in mparams.items()}
    mxb = mx.to(torch.bfloat16)
    mbf16_ms = time_cuda(
        lambda: forward(mg, params_bf16, mqstate, mxb, Flags(),
                        device="cuda"), iters=5, warmup=1)
    print(f"  deploy forward batch {BATCH}: {mdeploy_ms:.3f} ms/batch; "
          f"bf16 float forward {mbf16_ms:.3f} ms/batch", flush=True)
    phase("mnv2 serving", t0)

    t0 = time.perf_counter()
    mflags = Q.act_flags(mg, mcfg, base=Flags().all_weights(mg))
    msim = forward(mg, mparams, mqstate, mx, mflags, device="cuda")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(msim).all()):
        raise AssertionError("sim logits not finite")
    m_rel = logit_rel_mse(torch, mlogits, msim)
    m_agree = float((msim.argmax(-1) == mlogits.argmax(-1)).double().mean())
    print(f"  deploy vs sim: logit rel-MSE {m_rel:.4e} (gate "
          f"{RELMSE_GATE:g}), top-1 agreement {m_agree:.4f}", flush=True)
    if not m_rel <= RELMSE_GATE:
        raise AssertionError(f"parity gate failed: rel-MSE {m_rel}")
    xg = torch.round(mx[:8] * 8) / 8
    card = deploy.deploy_forward(mg, mdparams, msteps, xg, plan=mplan,
                                 device="cuda")
    cdp, csteps = to_cpu(torch, deploy, mdparams, msteps)
    host = deploy.deploy_forward(mg, cdp, csteps, xg.cpu(), plan=mplan,
                                 device="cpu")
    c_rel = logit_rel_mse(torch, card.cpu(), host)
    same_top1 = bool(torch.equal(card.cpu().argmax(-1), host.argmax(-1)))
    print(f"  card vs CPU deploy on 8 grid images: rel-MSE {c_rel:.4e} "
          f"(gate {CARD_CPU_GATE:g}), same top-1 {same_top1}", flush=True)
    if not (c_rel <= CARD_CPU_GATE and same_top1):
        raise AssertionError(f"card vs CPU deploy: rel-MSE {c_rel}, same "
                             f"top-1 {same_top1}")
    phase("mnv2 parity", t0)

    # ---- ResNet-18 quantized by the method's fused quantizers ---------
    t0 = time.perf_counter()
    os.environ.update(SSQ_STEM_KERNEL="1", SSQ_PACKED="1", SSQ_DW_KERNEL="0",
                      SSQ_STEM_1PASS="0")
    sg, scfg, sparams, sqstate, sdparams, ssteps = serving_setup(
        torch, gen, "resnet18", shifted=True)
    splan = deploy.make_deploy_plan(sg, sdparams, ssteps, input_hw=(HW, HW))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    skinds = [v[0] for k, v in splan.items() if not k.startswith("__")]
    scounts = {k: skinds.count(k) for k in sorted(set(skinds))}
    baked = sum(d.w_groups is not None for d in sdparams.values())
    print(f"  setup (init, BN fold, MSE scales, calibration, fused "
          f"shifted-scale init and hardening, deploy conversion) "
          f"{setup_s:.2f} s; plan kinds {scounts}; {baked} baked units",
          flush=True)
    if (scounts.get("stem_fused"), scounts.get("float"),
            scounts.get("int8", 0) + scounts.get("bf16_codes", 0),
            len(skinds), baked) != (1, 1, 19, 21, 19):
        raise AssertionError(f"method plan kinds {scounts}, {baked} baked")
    conv_shapes = int8_conv_shapes(sg, splan)
    phase("method setup", t0)

    t0 = time.perf_counter()
    conv_rows = check_int8_conv(torch, gen, int_matmul, requant, deploy,
                                conv_shapes, uniform_conv_shapes)
    if sum(sum(r["roles"].values()) for r in conv_rows) != 19 \
            or sum(sum(r["uniform_roles"].values()) for r in conv_rows) != 16:
        raise AssertionError(f"int8_conv shapes {conv_shapes} / uniform "
                             f"{uniform_conv_shapes}")
    phase("int8_conv kernel", t0)

    t0 = time.perf_counter()
    sx = torch.randn((BATCH, HW, HW, 3), generator=gen, device="cuda")
    reset_counts()
    slogits = deploy.deploy_forward(sg, sdparams, ssteps, sx, plan=splan,
                                    device="cuda")
    torch.cuda.synchronize()
    slaunches = counts()
    unfused["resnet18_shifted"] = slaunches.pop("unfused")
    print(f"  launches in one deploy forward: {slaunches}; requants left "
          f"to PyTorch elementwise: {unfused['resnet18_shifted']}",
          flush=True)
    check_counts(slaunches, int8_conv=19, stem_fused=1, packed_quant_matmul=0,
                 quant_matmul=0)
    check_unfused(unfused["resnet18_shifted"], "resnet18_shifted")
    if tuple(slogits.shape) != (BATCH, 1000) \
            or not bool(torch.isfinite(slogits).all()):
        raise AssertionError("deploy logits not finite or misshapen")
    sdeploy_ms = time_cuda(
        lambda: deploy.deploy_forward(sg, sdparams, ssteps, sx, plan=splan,
                                      device="cuda"), iters=5, warmup=1)
    ratios = engine.selection_ratios(sqstate, Q.unit_order(sg))
    groups = sum(sqstate[n].wq.st_index.numel() for n in ratios)
    overall = [sum(float(r[i]) * sqstate[n].wq.st_index.numel()
                   for n, r in ratios.items()) / groups
               for i in range(len(SHIFT_TARGETS))]
    print(f"  deploy forward batch {BATCH}: {sdeploy_ms:.3f} ms/batch; "
          f"selection ratios over {groups} input-channel groups of "
          f"{len(ratios)} units: " + ", ".join(
              f"{t:g}: {r:.4f}" for t, r in zip(SHIFT_TARGETS, overall)),
          flush=True)
    phase("method serving", t0)

    t0 = time.perf_counter()
    sflags = Q.act_flags(sg, scfg, base=Flags().all_weights(sg))
    ssim = forward(sg, sparams, sqstate, sx, sflags, device="cuda")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(ssim).all()):
        raise AssertionError("sim logits not finite")
    s_rel = logit_rel_mse(torch, slogits, ssim)
    s_agree = float((ssim.argmax(-1) == slogits.argmax(-1)).double().mean())
    s_margin = margin_reading(torch, ssim, slogits)
    print(f"  deploy vs sim: logit rel-MSE {s_rel:.4e} (gate "
          f"{RELMSE_GATE:g}), top-1 agreement {s_agree:.4f} (margins "
          f"{s_margin})", flush=True)
    if not s_rel <= RELMSE_GATE:
        raise AssertionError(f"parity gate failed: rel-MSE {s_rel}")
    sxg = torch.round(sx[:8] * 8) / 8
    scard = deploy.deploy_forward(sg, sdparams, ssteps, sxg, plan=splan,
                                  device="cuda")
    sdp_cpu, ssteps_cpu = to_cpu(torch, deploy, sdparams, ssteps)
    shost = deploy.deploy_forward(sg, sdp_cpu, ssteps_cpu, sxg.cpu(),
                                  plan=splan, device="cpu")
    sc_rel = logit_rel_mse(torch, scard.cpu(), shost)
    s_same = bool(torch.equal(scard.cpu().argmax(-1), shost.argmax(-1)))
    print(f"  card vs CPU deploy on 8 grid images: rel-MSE {sc_rel:.4e} "
          f"(gate {CARD_CPU_GATE:g}), same top-1 {s_same}", flush=True)
    if not (sc_rel <= CARD_CPU_GATE and s_same):
        raise AssertionError(f"card vs CPU deploy: rel-MSE {sc_rel}, same "
                             f"top-1 {s_same}")
    phase("method parity", t0)

    # ---- the fake-quant kernel ---------------------------------------
    t0 = time.perf_counter()
    fq_shapes = act_site_shapes(sg, sparams, sqstate, scfg, sx[:1], BATCH)
    if sum(fq_shapes.values()) != 17:
        raise AssertionError(f"act site shapes {fq_shapes}")
    fq_rows = check_fake_quant(torch, gen, fq, fq_shapes)
    fq_grad_rows = check_fake_quant_grad(torch, gen, fq)
    phase("fake_quant kernel", t0)

    # ---- the paper's reconstruction (the CLI's --mode fused) ----------
    res = recon_phases(torch, gen)
    cal_counts, sim_counts = res["cal_counts"], res["sim_counts"]

    # ---- the CLI: fused, brecq + act delta, two-phase ----------------
    cli_res = cli_phases(torch)

    # ---- RegNetX-600M: grouped int8 conv; int8_pair; trained CLI -------
    rg = regnet_phases(torch, gen)
    pair = pair_phase(torch, gen)
    rg_cli = regnet_cli_phases(torch)

    # ---- Fisher losses, the act-shift phase, the searches --------------
    fisher, fisher_state = fisher_phase(torch, gen)
    method_cli = cli_method_phases(torch, sdeploy_ms)
    search = search_phase(torch, fisher_state)
    del fisher_state

    # ---- MNASNet: pair transport, dw_conv_int8, the trained CLI --------
    mn = mnasnet_phases(torch, gen, mlaunches["dw_conv_int8"])
    mn_cli = mnasnet_cli_phases(torch)
    unfused.update({f"mnasnet_{s}": r["unfused"]
                    for s, r in mn["served"].items()})
    unfused.update({f"regnetx_600m_{s}": r["unfused"]
                    for s, r in rg["served"].items()})
    unfused["resnet18_w4a8"] = pair["unfused"]

    # ---- ResNet-50 from a torchvision checkpoint; the native loader; the
    # import and data path through the CLI --------------------------------
    import tempfile
    from shiftedscalequantization_tpu_torch.models import zoo
    r50_tmp = tempfile.TemporaryDirectory()
    r50_ckpt = os.path.join(r50_tmp.name, "resnet50.pth.tar")
    g50, km50 = zoo.build("resnet50", dataset="imagenet")
    torchvision_checkpoint(torch, g50, km50(g50), r50_ckpt)
    with time_limit("resnet50 phases", R50_LIMIT_S):
        r50 = resnet50_phases(torch, gen, r50_ckpt)
    with time_limit("native loader", NATIVE_LIMIT_S):
        native = native_loader_phase()
    with time_limit("resnet50 cli", R50_CLI_LIMIT_S):
        r50_cli = resnet50_cli_phase(torch, r50_ckpt, r50_tmp.name)
    r50_tmp.cleanup()

    # ---- data-parallel calibration and reconstruction, two ranks -------
    with time_limit("parallel", PAR_LIMIT_S):
        par = parallel_phases(torch)

    # ---- FP training, the sweep and profiling -------------------------
    with time_limit("training and tools", TOOLS_LIMIT_S):
        tools = tools_phases(torch, res["sim_ms"])
    r50_served = r50["served"]
    unfused.update({k: r["unfused"] for k, r in r50_served.items()})

    def r50_count(kernel):
        return {k: r["launches"].get(kernel, 0)
                for k, r in r50_served.items()}

    r50_sim_fq = {k: r["sim_launches"].get("fake_quant_act", 0)
                  + r["sim_launches"].get("fake_quant_weight", 0)
                  for k, r in r50_served.items()}
    r50_fq_act = [r for r in r50["fq_rows"] if r["name"].startswith("act ")]

    src = "shiftedscalequantization_tpu_torch/csrc/"

    def per_forward(rows, key):
        return sum(r[key] * r.get("count", 1) for r in rows)

    unfused["resnet18_reconstructed"] = res["unfused"]
    # one row per kernel; times and bounds are the work of one forward of
    # each path the kernel runs on, each unit in the mode its path runs it
    # (packed: ResNet-18 uniform and MobileNetV2; int8_conv: the method
    # path, with the uniform path's beside it)
    pk_all = packed_rows + mpk_rows

    def sums_mode(rows, key="ms", roles="roles"):
        return sum(c * r[key]["sums"] for r in rows
                   for c in r[roles].values())

    def per_path(rows, key, roles="roles"):
        return sum(r[key] * c for r in rows for c in r[roles].values())

    def per_dw(rows, key, path=None):
        return sum(r[key] * c for r in rows for p, c in r["paths"].items()
                   if path in (None, p))

    rg_served, g_rows = rg["served"], rg["group_rows"]
    kernels = [
        {"name": "packed_quant_matmul", "route": "cuda",
         "source": src + "packed_qmm.cu",
         "replaces": "shiftedscalequantization_tpu/ops/pallas/packed.py:55",
         "launches": launches["packed_quant_matmul"]
         + mlaunches["packed_quant_matmul"]
         + sum(r50_count("packed_quant_matmul").values()),
         "launches_by_path": {
             "resnet18": launches["packed_quant_matmul"],
             "mobilenetv2": mlaunches["packed_quant_matmul"],
             **r50_count("packed_quant_matmul")},
         "max_abs_err": max(r["err"] for r in pk_all),
         "ms": path_time(pk_all),
         "ms_by_path": {"resnet18": path_time(packed_rows),
                        "mobilenetv2": path_time(mpk_rows)},
         "ms_sums_mode": sums_mode(pk_all),
         "plain_ms": per_path(pk_all, "plain_ms"),
         "bound_ms": path_time(pk_all, "bound_ms"),
         "bound_by": max(((r["bound_ms"][k], r["bound_by"][k])
                          for r in pk_all for k in r["roles"]))[1],
         "library_ms": per_path(pk_all, "library_ms"),
         # ResNet-50's uniform stem+packed forward (34 units)
         "resnet50": {
             "ms": path_time(r50["packed_rows"]),
             "bound_ms": path_time(r50["packed_rows"], "bound_ms"),
             "plain_ms": per_path(r50["packed_rows"], "plain_ms"),
             "library_ms": per_path(r50["packed_rows"], "library_ms")}},
        {"name": "stem_fused", "route": "cuda",
         "source": src + "stem_fused.cu",
         "replaces": "shiftedscalequantization_tpu/ops/pallas/stem.py:66",
         "launches": launches["stem_fused"]
         + sum(r50_count("stem_fused").values()),
         "launches_by_path": {"resnet18": launches["stem_fused"],
                              **r50_count("stem_fused")},
         "max_abs_err": max(r["err"] for r in stem_rows),
         "ms": stem_rows[0]["ms"], "ms_eager": stem_rows[0]["eager_ms"],
         "plain_ms": stem_rows[0]["plain_ms"],
         "bound_ms": stem_rows[0]["bound_ms"],
         "bound_by": stem_rows[0]["bound_by"],
         "bound_f32_pipe_ms": stem_rows[0]["bound_f32_pipe_ms"],
         # yardsticks, not the same function: cuDNN's conv alone
         "cudnn_f32_conv_ms": stem_rows[0]["cudnn_f32_conv_ms"],
         "cudnn_bf16_conv_ms": stem_rows[0]["cudnn_bf16_conv_ms"],
         "library_ms": None},
        # dw's library yardstick: cuDNN's bf16 depthwise conv on the same
        # codes, the conv alone
        {"name": "dw_conv3x3_int8", "route": "cuda",
         "source": src + "dw_conv3x3.cu",
         "replaces":
             "shiftedscalequantization_tpu/ops/pallas/depthwise.py:35",
         "launches": mlaunches["dw_conv3x3_int8"],
         "max_abs_err": max(r["err"] for r in dw_rows),
         "ms": per_forward(dw_rows, "ms"),
         "ms_eager": per_forward(dw_rows, "eager_ms"),
         "plain_ms": per_forward(dw_rows, "plain_ms"),
         "bound_ms": per_forward(dw_rows, "bound_ms"),
         "bound_by": max(dw_rows, key=lambda r: r["bound_ms"])["bound_by"],
         "library_ms": per_forward(dw_rows, "conv_alone_ms")},
        # mbconv has no caller in either package: its times are those of
        # MobileNetV2's 13 stride-1 blocks, and ms_3shapes that of
        # MBCONV_3SHAPES, one launch each; its library yardstick is
        # cuDNN's bf16 convs of each block (three calls, two for
        # features.1), and units_ms the packed and dw units served today
        {"name": "mbconv_fused", "route": "cuda",
         "source": src + "mbconv_fused.cu",
         "replaces": "shiftedscalequantization_tpu/ops/pallas/mbconv.py:38",
         "launches": mlaunches["mbconv_fused"],
         "max_abs_err": max(r["err"] for r in mb_rows),
         "ms": per_forward(mb_rows, "ms"),
         "ms_3shapes": sum(r["ms"] for r in mb_rows
                           if r["name"] in MBCONV_3SHAPES),
         "ms_eager": per_forward(mb_rows, "eager_ms"),
         "plain_ms": per_forward(mb_rows, "plain_ms"),
         "bound_ms": per_forward(mb_rows, "bound_ms"),
         "bound_by": max(mb_rows, key=lambda r: r["bound_ms"])["bound_by"],
         "units_ms": per_forward(mb_rows, "units_ms"),
         "library_ms": per_forward(mb_rows, "convs_ms")},
        # quant_matmul has no deploy caller in either package: its times
        # are those of the three ResNet-18 downsample GEMM shapes
        {"name": "quant_matmul", "route": "cuda",
         "source": src + "int_matmul.cu",
         "replaces":
             "shiftedscalequantization_tpu/ops/pallas/int_matmul.py:24",
         "launches": slaunches["quant_matmul"],
         "max_abs_err": max(r["err"] for r in qmm_rows),
         "ms": per_forward(qmm_rows[:3], "ms"),
         "plain_ms": per_forward(qmm_rows[:3], "plain_ms"),
         "bound_ms": per_forward(qmm_rows[:3], "bound_ms"),
         "bound_by": max(qmm_rows[:3],
                         key=lambda r: r["bound_ms"])["bound_by"],
         "library_ms": per_forward(qmm_rows[:3], "library_ms")},
        # fake_quant: one recon-path sim forward (17 act sites and the
        # stem's 8-bit weight), ResNet-50's sim forward beside it
        {"name": "fake_quant", "route": "cuda",
         "source": src + "fake_quant.cu",
         "replaces":
             "shiftedscalequantization_tpu/ops/pallas/fake_quant.py:23",
         "launches": sim_counts["fake_quant_act"]
         + sim_counts["fake_quant_weight"] + sum(r50_sim_fq.values()),
         "launches_by_route": {"act": sim_counts["fake_quant_act"],
                               "weight": sim_counts["fake_quant_weight"]},
         "launches_cli": {n: {"act": r["fake_quant_act"],
                              "weight": r["fake_quant_weight"]}
                          for n, r in (*cli_res["runs"].items(),
                                       *method_cli["runs"].items())},
         # one sim forward of the act-shift state: each act-shift site
         # once per candidate
         "launches_act_shift": {
             "act": method_cli["sim_counts"]["fake_quant_act"],
             "weight": method_cli["sim_counts"]["fake_quant_weight"]},
         # each rank of phases 38-41 (synced calibration, sharded
         # capture, sharded validation), act sites
         "launches_parallel": par["launches"],
         # the sweep's two CLI runs (phase 44) and layer_timing's sim
         # nodes (phase 45, PROFILE_INNER + 1 calls a node)
         "launches_tools": {"sweep": tools["sweep"]["launches"],
                            "layer_timing": tools["profiling"]["launches"]},
         "max_abs_err": max(r["err"] for r in fq_rows),
         "ms": per_forward(fq_rows, "ms"),
         "plain_ms": per_forward(fq_rows, "plain_ms"),
         "bound_ms": per_forward(fq_rows, "bound_ms"),
         "bound_by": max(fq_rows, key=lambda r: r["bound_ms"])["bound_by"],
         "library_ms": per_forward(fq_rows, "library_ms"),
          # the 49 act sites of ResNet-50's sim forward; the launches of
         # each served cell's sim forward (uniform: 54 UniformWQ weights
         # too, baked none)
         "resnet50": {
             "launches": r50_sim_fq,
             "max_abs_err": max(r["err"] for r in r50["fq_rows"]),
             "ms": per_forward(r50_fq_act, "ms"),
             "plain_ms": per_forward(r50_fq_act, "plain_ms"),
             "bound_ms": per_forward(r50_fq_act, "bound_ms"),
             "library_ms": per_forward(r50_fq_act, "library_ms")}},
        # int8_conv: one method-path forward (19 units, two weight groups);
        # its library yardstick is two cuDNN bf16 convs per unit
        {"name": "int8_conv", "route": "cuda",
         "source": src + "int_matmul.cu",
         "replaces":
             "shiftedscalequantization_tpu/ops/pallas/int_matmul.py:24",
         "launches": slaunches["int8_conv"] + launches["int8_conv"]
         + mlaunches["int8_conv"] + sum(
             r["launches"].get("int8_conv", 0) for r in rg_served.values())
         + pair["launches"]["int8_conv"]
         + method_cli["launches"].get("int8_conv", 0)
         + sum(r["launches"].get("int8_conv", 0)
               for r in mn["served"].values())
         + sum(r50_count("int8_conv").values()),
         "launches_by_path": {
             **r50_count("int8_conv"),
             "resnet18_shifted": slaunches["int8_conv"],
             "resnet18": launches["int8_conv"],
             "mobilenetv2": mlaunches["int8_conv"],
             **{f"regnetx_600m_{s}": r["launches"].get("int8_conv", 0)
                for s, r in rg_served.items()},
             "resnet18_w4a8": pair["launches"]["int8_conv"],
             "resnet18_act_shift": method_cli["launches"].get("int8_conv",
                                                              0),
             **{f"mnasnet_{s}": r["launches"].get("int8_conv", 0)
                for s, r in mn["served"].items()}},
         "max_abs_err": max(r["err"] for r in conv_rows),
         "ms": path_time(conv_rows),
         "ms_sums_mode": sums_mode(conv_rows),
         "ms_uniform_s1": path_time(conv_rows, "ms_s1", "uniform_roles"),
         "ms_uniform_s1_sums_mode": sums_mode(conv_rows, "ms_s1",
                                              "uniform_roles"),
         "plain_ms": per_path(conv_rows, "plain_ms"),
         "bound_ms": path_time(conv_rows, "bound_ms"),
         "bound_uniform_s1_ms": path_time(conv_rows, "bound_s1_ms",
                                          "uniform_roles"),
         "bound_by": max(((r["bound_ms"][k], r["bound_by"][k])
                          for r in conv_rows for k in r["roles"]))[1],
         "library_ms": per_path(conv_rows, "library_ms"),
         "library_uniform_s1_ms": per_path(conv_rows, "library_s1_ms",
                                           "uniform_roles"),
         # ResNet-50's default-plan forward, baked (52 units, S = 2) and
         # uniform (52, S = 1)
         "resnet50": {
             "ms": path_time(r50["conv_rows"]),
             "bound_ms": path_time(r50["conv_rows"], "bound_ms"),
             "plain_ms": per_path(r50["conv_rows"], "plain_ms"),
             "library_ms": per_path(r50["conv_rows"], "library_ms"),
             "ms_uniform_s1": path_time(r50["conv_rows"], "ms_s1",
                                        "uniform_roles"),
             "bound_uniform_s1_ms": path_time(r50["conv_rows"],
                                              "bound_s1_ms",
                                              "uniform_roles"),
             "library_uniform_s1_ms": per_path(
                 r50["conv_rows"], "library_s1_ms", "uniform_roles")}},
        # int8_group_conv: one RegNetX-600M baked-path forward (16 grouped
        # units, two weight groups), the uniform path's (12, S = 1)
        # beside; its library yardstick is S cuDNN bf16 grouped convs
        {"name": "int8_group_conv", "route": "cuda",
         "source": src + "int8_group_conv.cu",
         "replaces": "shiftedscalequantization_tpu/deploy.py:660 (_int_conv "
                     "with feature_group_count > 1, left to XLA)",
         "launches": sum(r["launches"].get("int8_group_conv", 0)
                         for r in rg_served.values()),
         "launches_by_path": {
             f"regnetx_600m_{s}": r["launches"].get("int8_group_conv", 0)
             for s, r in rg_served.items()},
         "max_abs_err": max(r["err"] for r in g_rows),
         "ms": path_time(g_rows),
         "ms_eager": path_time(g_rows, "eager_ms"),
         "ms_sums_mode": sums_mode(g_rows),
         "ms_uniform_s1": path_time(g_rows, "ms_s1", "uniform_roles"),
         "plain_ms": per_path(g_rows, "plain_ms"),
         "bound_ms": path_time(g_rows, "bound_ms"),
         "bound_uniform_s1_ms": path_time(g_rows, "bound_s1_ms",
                                          "uniform_roles"),
         "bound_by": max(((r["bound_ms"][k], r["bound_by"][k])
                          for r in g_rows for k in r["roles"]))[1],
         "library_ms": per_path(g_rows, "library_ms"),
         "library_uniform_s1_ms": per_path(g_rows, "library_s1_ms",
                                           "uniform_roles")},
        # dw_conv_int8: one plain-state MNASNet forward (11 depthwise
        # units, the relu requant onto their sites in the epilogue) and
        # MobileNetV2's features.1.conv.0 (offset 128); its library
        # yardstick is cuDNN's bf16 depthwise conv on the same codes, the
        # conv alone
        {"name": "dw_conv_int8", "route": "cuda",
         "source": src + "dw_conv_int8.cu",
         "replaces": "shiftedscalequantization_tpu/deploy.py:942 (the "
                     "bf16_codes depthwise conv, feature_group_count = C, "
                     "left to XLA)",
         "launches": mn["served"]["plain"]["launches"].get("dw_conv_int8", 0)
         + mlaunches["dw_conv_int8"],
         "launches_by_path": {
             **{f"mnasnet_{s}": r["launches"].get("dw_conv_int8", 0)
                for s, r in mn["served"].items()},
             "mobilenetv2": mlaunches["dw_conv_int8"]},
         "max_abs_err": max(r["err"] for r in mn["dw_rows"]),
         **{k: per_dw(mn["dw_rows"], k) for k in (
             "ms", "eager_ms", "sums_ms", "plain_ms", "bound_ms",
             "library_ms")},
         "ms_by_path": {p: per_dw(mn["dw_rows"], "ms", p)
                        for p in ("mnasnet", "mobilenetv2")},
         "ms_by_shape": {
             "{}x{}x{} k{}/s{} offset {}".format(*r["shape"]): {
                 k: r[k] for k in ("ms", "bound_ms", "library_ms")}
             for r in mn["dw_rows"]},
         "status": "redesigned: tiles fitted to the shape, 4 channels a "
                   "thread with dp4a, cp.async staging, word-wide requant "
                   "stores",
         "bound_by": max(mn["dw_rows"],
                         key=lambda r: r["bound_ms"])["bound_by"]},
    ]
    print(json.dumps({"packed_shapes": packed_rows, "stem": stem_rows,
                      "requants_left_to_pytorch": unfused,
                      "deploy_ms_per_batch": deploy_ms,
                      "deploy_sim_rel_mse": rel_mse,
                      "deploy_sim_top1_agreement": agree,
                      "mnv2_plan_kinds": mkind_counts,
                      "mnv2_dw_shapes": dw_rows,
                      "mnv2_packed_shapes": mpk_rows,
                      "mnv2_mbconv_shapes": mb_rows,
                      "mnv2_deploy_ms_per_batch": mdeploy_ms,
                      "mnv2_bf16_forward_ms_per_batch": mbf16_ms,
                      "mnv2_deploy_sim_rel_mse": m_rel,
                      "mnv2_deploy_sim_top1_agreement": m_agree,
                      "mnv2_card_cpu_rel_mse": c_rel,
                      "quant_matmul_shapes": qmm_rows,
                      "method_setup_s": setup_s,
                      "method_plan_kinds": scounts,
                      "method_int8_conv_shapes": conv_rows,
                      "method_deploy_ms_per_batch": sdeploy_ms,
                      "method_deploy_sim_rel_mse": s_rel,
                      "method_deploy_sim_top1_agreement": s_agree,
                      "method_deploy_sim_margins": s_margin,
                      "method_card_cpu_rel_mse": sc_rel,
                      "method_selection_ratios": dict(zip(
                          map(str, SHIFT_TARGETS), overall)),
                      "fake_quant_shapes": fq_rows,
                      "fake_quant_backward": fq_grad_rows,
                      "recon_calibration_launches": cal_counts,
                      "recon_targets": res["recon_rows"],
                      "recon_s": res["recon_s"],
                      "recon_parity_trace_rel": res["par"],
                      "recon_parity_flips": res["flips"],
                      "recon_parity_cpu_s": res["cpu_s"],
                      "recon_plan_kinds": res["rcounts"],
                      "recon_sim_ms_per_batch": res["sim_ms"],
                      "recon_deploy_ms_per_batch": res["rdeploy_ms"],
                      "recon_deploy_sim_rel_mse": res["r_rel"],
                      "recon_deploy_sim_top1_agreement": res["r_agree"],
                      "recon_deploy_sim_margins": res["r_margin"],
                      "recon_first_target_probe": res["probe"],
                      "recon_card_cpu_rel_mse": res["rc_rel"],
                      "recon_selection_ratios": dict(zip(
                          map(str, SHIFT_TARGETS), res["roverall"])),
                      "cli": cli_res,
                      "regnet": {k: v for k, v in rg.items()
                                 if k != "group_rows"},
                      "regnet_group_conv_shapes": g_rows,
                      "resnet18_w4a8": pair,
                      "regnet_cli": rg_cli,
                      "fisher": fisher,
                      "cli_fisher_act_shift": method_cli,
                      "search": search,
                      "mnasnet": {k: v for k, v in mn.items()
                                  if k != "dw_rows"},
                      "mnasnet_dw_conv_shapes": mn["dw_rows"],
                      "mnasnet_cli": mn_cli,
                      "resnet50": {k: v for k, v in r50.items()
                                   if k not in ("conv_rows",
                                                "packed_rows")},
                      "resnet50_fake_quant_shapes": r50["fq_rows"],
                      "resnet50_int8_conv_shapes": r50["conv_rows"],
                      "resnet50_packed_shapes": r50["packed_rows"],
                      "native_loader": native,
                      "resnet50_cli": r50_cli,
                      "parallel": par,
                      "tools": tools}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(f"total {time.perf_counter() - _T0:.2f} s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
