#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Besides serving, it drives two training steps: BiSeNet-R18 and DFN-R101
(with the multi-class sigmoid focal loss run on the DFN step's logits), the
training command line for BiSeNet-R18, PSPNet-R50 and DFN-R101 on PNG
files it writes (with PSANet's and FCN's steps), the evaluation command
line on those files and the CLI's snapshots (sliding window, msf and
flip, the speed protocol), and
the training half across processes (``dryrun_multichip``, the four-rank
leg, whole-image evaluation) with its dp x sp leg (the image height
sharded over two ranks: the step, the dryrun, whole-image evaluation).
The main path is the int8-through BiSeNet-R18.speed serving graph at
1024x2048 (``torchseg_tpu_torch.entry``): seeded random weights, four
distinct seeded uint8 images served, (1, 128, 256) int32 labels out.  The
full-resolution path is BiSeNet-R18 (head scales (16, 8, 8)) at 1024x2048
serving (1, 1024, 2048) labels through two graphs: the bf16 fused-stem
deploy graph with ``argmax="fused"`` (its stem on K11) and the
int8-through graph with ``argmax="tiled"``, both ending in the
upsample-argmax kernel K7.  The X39 path is BiSeNet-X39.speed's bf16
fused-stem graph at 768x1536 (``deploy_entry``), its stem on K11.  The
script

  1. needs a CUDA card (exits non-zero without one, with no CPU fallback);
  2. prints the card's name and power limit as nvidia-smi reports them;
  3. builds the CUDA kernels from the checkout's sources (one nvcc per
     source, in parallel) and prints the build time and ptxas's register /
     shared-memory report;
  4. main path: builds the serving graph and serves the images; counts each
     kernel wrapper's launches over exactly one served forward (stem_pool_i8
     1, conv3x3s2_i8 2, l1_stage_i8 1, down_stage_i8 2 (stages 2 and 3),
     down_block_i8 1, res_block_i8 1, cbr_i8 7 (sp3 and the decoder's six
     convs), K7 0) and checks that the forward runs no float64 conv (no
     plain version); lists the device kernels of the forwards
     (torch.profiler) with their device time, and checks that the int8
     convs are exactly MAIN_PATH_CONVS (no CUDA-core conv_i8_kernel; K5's
     conv2 the cluster-split projection launch; the decoder's on the
     tensor cores);
  5. compares every kernel with its plain PyTorch version on the tensors
     the main path fed it (K2-K6 and each of the seven cbr_i8 calls
     bit-exact, K1 within one code on at most a 1e-3 share of its codes),
     the main path's /8 logits with the plain decoder's on the same body
     codes (bit-identical), and the served graph with the plain graph run
     on the CPU on one small input;
  6. times the served forward over the distinct inputs (median, p90,
     enqueue, and the card's idle share against the profiler's device
     time), each kernel against its plain version (K2's two launches, sp1
     and sp2, as rows of their own; the seven cbr_i8 calls each, and as one
     row), the decoder on the kernels and on the plain route, and the
     parts of the graph, with CUDA events after a warm-up, and logs
     same-MACs vendor yardsticks (not on the path): cuDNN's bf16 conv of
     K1's s2d 4x4 conv and ``torch._int_mm`` of K2's sp1, of one K3 link,
     of stage 3's conv2 (K4), of K5's two links, of one K6 link and of
     each cbr_i8 call, each as an im2col GEMM;
  7. full-resolution path: each graph launches K7 exactly once per forward
     (the int8 graph also K1-K6, the bf16 graph K11 once); K11 meets its
     bars against its plain version on the bf16 graph's stem inputs (bf16
     out equal on >= 99.9 % of the elements and within one bf16 ulp, or
     1e-5 of max |y| near zero, everywhere; float32 out within 1e-5 of max
     |y|) on its bf16 tensor-core route (wgmma, the graph's packed
     weights) and is timed against cuDNN's bf16 conv + affine + ReLU; K7
     meets its bar against its plain version on each graph's own /8
     logits (equal labels on >= 99.9 % of
     pixels and wherever the top-two gap exceeds 1e-4); each graph's card
     labels agree with the same graph run on the CPU at 256x512 (>= 99 %;
     the fused-stem graph in float32 for that bar, and in bf16 against
     bf16 to a bar of 97 %, see BF16_AGREE); both forwards are timed
     (median, p90, enqueue, and the device time per forward and the
     card's idle share by the profiler), and K7 against its plain version
     and against the materialized upsample + argmax, its bound from the
     separable form's operations;
  8. X39 path: ``deploy_entry()`` (``cityscapes.bisenet.X39.speed``, bf16,
     s2d input) serves four seeded images, (1, 96, 192) labels in [0, 19);
     one forward launches K11 once and nothing else; K11 meets its bars on
     the forwards' own stem inputs (72 channels: 64 SpatialPath + 8
     Xception stem) and is timed against its bound and cuDNN's route; the
     card's labels agree with the same graph on the CPU at 256x512 (>= 99
     % in float32, >= BF16_AGREE in bf16); the forward is timed (median,
     p90, enqueue) and a profiler pass gives the card's idle share;
  9. PSPNet path: int8-through PSPNet-R50 (``ade.pspnet.R50_v1c``) at
     480x480 through ``serve_entry``, the graph's calibration and package
     as the JAX package builds them: four seeded images served, (1, 480,
     480) labels in [0, 150); one forward launches K10 once (on its
     16-byte route), cbr_i8 twice
     (stem2, stem3) and bottleneck_i8's 48 conv launches (16 blocks x 3)
     and nothing else, all 50 convs on the tensor cores (the profiler: no
     conv_i8_kernel); K10, both cbr_i8 calls and each of the 16
     bottleneck_i8 calls are held bit-exact to their plain versions on the
     tensors the forwards fed them; the card's labels agree with the same package run on the CPU
     at 160x160, the head in float32 on both (>= 99 %, PSP_AGREE); the
     forward is timed (median, p90), with K10 (its device time by the
     profiler over eight inputs that outgrow the L2, and through its
     wrapper by CUDA events) against its plain version, its bound and
     ``F.max_pool2d`` on a float16 copy (device time), the body's blocks
     (against ``torch._int_mm`` of their GEMMs) and the parts of the
     forward, and a profiler pass gives the card's idle share;
  10. training path: the BiSeNet-R18 training step (``train_entry``,
     1024x1024 crops, batch 2, float32, three OHEM heads, group-lr SGD)
     launches K8 and K9 35 times each in one step (22 of the K9 launches
     with the ReLU fused), and no BN runs torch's own batch norm; K9 is held
     bit-exact to its plain version on the float32 tensors that step fed it
     and on the same tensors in bfloat16, K8 within 1e-5 of sum |x| (sum x)
     and 1e-5 relative (sum x^2) and to the same bits on a second call, and
     K8's fold (the SyncBN epilogue: mean, inv, a, b, d, the running stats
     and num_batches_tracked) bit-exact against ``bn_fold_plain`` on K8's
     own sums with the step's own BN operands, its a and b those the step
     fed K9; one SyncBN forward launches at most 3 device kernels (the
     profiler; it is K8 and K9); one step on the card agrees with the same
     step on the CPU, run in float64, at 64x64, batch 8 (CHECK_CROP: where
     the float32 step is well-conditioned, see there), with cuDNN off: the
     loss within 1e-4 relative, each parameter's change within 1e-3 of its
     largest entry, the running stats within 1e-4 of their scale (the same
     step with cuDNN, and the CPU's float32 step, are measured beside it);
     20 steps on
     the learnable synthetic batch lower the loss, and a second run of the
     same 20 steps in the same process gives the same loss curve bit for
     bit (the resizes' backward is deterministic); the step is timed
     (median, p90, host enqueue, peak memory), K8 and K9 against their
     plain versions and the one-call library yardsticks, with their
     wrappers' host microseconds a call, K8 + K9 against
     ``F.batch_norm``, and, as a comparison only, the same step with
     ``nn.BatchNorm2d`` as the model's norm;
  11. DFN path: the DFN-R101 training step (``train_entry(
     "cityscapes.dfn.R101_v1c")``, 800x800 crops, batch 2, float32, four
     smooth CE heads and four border focal heads against the synthetic
     border label) launches K8 and K9 once per BN of the model (130 each)
     and nothing else, and no BN runs torch's own batch norm; K8 and K9
     meet the training phase's bars on that step's tensors; the
     multi-class sigmoid focal loss (``SigmoidFocalLossMulti``) on the
     step's last smooth head, (1280000, 19) NHWC rows with targets label +
     1, launches K12 once forward and K13 once backward, and both meet
     their bars against their plain versions on those tensors and on a
     copy of the targets with background and ignored entries mixed in;
     one step on the card agrees with the same step on the CPU in float64
     (DFN_CHECK_*); 20 steps lower the loss (DFN_DRYRUN_SEED); the step
     is timed (median, p90, enqueue, peak memory), K8 and K9 per step at
     DFN's shapes, K12 and K13 against their plain versions and bounds
     (with the achieved TB/s), and a profiler pass gives the card's idle
     share;
  12. the training half across processes: ``dryrun_multichip(1)`` with
     this process as rank 0 of an NCCL group of one (DDP, SyncBN on the
     process-group route: K8 for the sums only, a float64 all-reduce,
     ``bn_fold_plain``, K9) trains BiSeNet-R18 at 32x32 for 20 steps (the
     loss falls) and evaluates whole-image, sharded, with the histograms
     summed over the group (every pixel counted once); K8 and K9 launch
     35 times each a step and nothing else runs a kernel; on the first
     step's tensors K8's sums meet the training phase's bars, the fold
     folds exactly K8's sums and hands K9 its a, b, and K9 is bit-exact to
     its plain version; the step is timed and profiled, and the group
     route's SyncBN forward counted (profiler) and its all-reduce and fold
     timed on the host; the four-rank gloo leg
     (``parallel._multihost_worker``) runs every rank on this card: its dp4
     and dp2 x sp2 losses equal on every rank and falling, equal merged
     pixel counts; whole-image evaluation of BiSeNet-R18 at 1024x2048 on
     two ``SyntheticDataset`` images counts every pixel once, and is timed
     per image;
  13. the dp x sp leg (``parallel/spatial.py``, ``ops/spatial.py``):
     ``dryrun_multichip(2, backend="gloo")`` on this card runs its dp2 leg
     and its dp1 x sp2 leg (both losses fall; the sp2 whole-image eval
     counts 4 x 32x32 pixels once); then two gloo ranks on this card run
     the BiSeNet-R18 step dp1 x sp2 (``SpatialTrainer``, the batches made
     here and handed to the ranks) against ``train_entry``'s one-process
     step on the same weights and batch, deterministic cuDNN on both
     sides: at CHECK_BATCH x CHECK_CROP, where the float32 step is
     well-conditioned, within JAX's bars (loss 3e-3 relative, each
     gradient leaf's max |diff| under 3e-2 of its max |value|); at
     TRAIN_BATCH x TRAIN_CROP, where every map down to /32 stays sharded,
     the loss within 3e-3 and the whole gradient within SP_L2_BAR, each
     leaf's difference recorded (see SP_L2_BAR); there K8 and K9 launch
     35 times each a step on each rank and nothing else, K8 for the sums
     only, 32 SyncBNs summing over the 2-D group and SP_GATE_BNS over the
     data group, K9 bit-exact and K8 within its bars on the step's
     tensors; the step is timed on both ranks (median, p90, peak memory,
     the host time of the halo exchanges and of all the context's
     collectives) beside the one-process step, and profiled on rank 0
     (the card's idle share); the sp2 whole-image evaluation of
     BiSeNet-R18 at 1024x2048 agrees with the one-rank evaluation on >=
     SP_AGREE of the labels and is timed per image beside it;
  14. the families phase (``FAMILIES``): int8-through PSANet-R50
     (``ade.psanet.R50_v1c``, 480x480: its 60x60 features are the 3600
     attention channels), FCN-32s-R101 (``voc.fcn32s.R101_v1c``, 512x512),
     DFN-R101 (``cityscapes.dfn.R101_v1c``, 800x800) and BiSeNet-R101
     (``cityscapes.bisenet.R101``, 1024x1024), each built through
     ``serve_entry`` at its published crop, batch 1, serving four seeded
     uint8 images: labels (1, H, W) int32 in range; one forward launches
     K10 once, cbr_i8 twice (the deep stem; BiSeNet-R101 five, with its
     spatial path's sp1-sp3), bottleneck_i8 three times a block (48 for
     R50, 99 for R101) and nothing else, and runs no float64 conv; every
     K10, cbr_i8 and bottleneck_i8 call of the four forwards is bit-exact
     against its plain version on the tensors they fed it (the standard-
     stride bodies' stride-2 blocks at stages 3 and 4 among them); the
     card's labels agree with the same package run on the CPU at 160x160
     with float32 heads (>= FAM_AGREE); each graph logs its forward median
     and p90, enqueue ms, the profiler's device time and idle share, peak
     memory, build s, and its body and head as parts; the kernels line
     gets rows ``maxpool2d_3x3s2_i8:<family>``, ``bottleneck_i8:<family>``
     and ``cbr_i8:<family>`` from the first forward's calls.
  15. the training CLI (``torchseg_tpu_torch.train``, ``cli_phase``): seeded
     PNG trees written here with a small zlib writer (four Cityscapes-
     shaped 1024x2048 RGB images with {0, 1} train-id labels that are a
     function of the image, four ADE-shaped 512x683 images with labels
     0-150), then ``train.main`` on the card: BiSeNet-R18 at its 1024x1024
     crop and scale array, batch 2, 2 epochs x 3 iterations, then resumed
     from ``epoch-last.ckpt`` for a third epoch (K8 and K9 35 launches a
     step, every loss finite, the three snapshots and the link, the
     resumed run at epoch 2 with PolyLR's lr at step 6, the snapshot's
     model and optimizer state equal to the run's bit for bit); PSPNet-R50
     at 480x480, batch 2, 3 iterations (K8/K9 once per BN a step), then
     one step repeated from that snapshot under deterministic cuDNN gives
     bit-equal losses for equal dropout-generator seeds and different
     ones for different seeds; PSPNet-R50, PSANet-R50 (480x480) and
     FCN-32s-R101 (512x512) ``train_entry`` steps with dropout on: K8/K9
     once per BN, held against their plain versions with the training
     phase's bars, timed and profiled (rows ``<kernel>:<family>``; the
     profiler's K8/K9 device time and idle share a step); PSANet's and FCN's
     card step against the CPU's float64 step at 2 x 64x64 (dropout off,
     ``step_vs_cpu``'s float32-distance bars); DFN-R101 at 800x800, batch
     2, 2 iterations through ``DFNTrainPre`` (every batch's ``aux_label``
     in {0, 1, 255}, finite losses); and ``cv2`` never imported.  Each
     CLI run logs its median step (CUDA events), the host time a step
     waited for the loader, the card's idle share over its last steps
     (profiler) and its peak memory.
  16. the evaluation command line (``torchseg_tpu_torch.eval``,
     ``eval_city_phase`` and ``eval_ade_phase``, run inside the CLI phase
     on its PNG trees and snapshots before they are removed): (a) the
     main path's protocol, ``cityscapes.bisenet.R18.speed`` whole-image at
     ``resize_to`` 768x1536 with the labels cut by 8 (a snapshot of one
     CLI step), over the four Cityscapes-shaped images; (b) BiSeNet-R18's
     sliding protocol at 1024x2048 (crop 1024, stride 854: 3 crops) and
     then ``--msf`` (6 scales with flip: 28 crops, 56 forwards an image),
     each over the CLI run's snapshot sweep (``--epochs 0-``) with ``-p``
     and ``--submit``: every dumped PNG read back by the port's decoder
     has the label map's shape and values in the train ids (predictions)
     or in Cityscapes' label ids (submissions), the ``val_*.log`` holds
     one table an epoch and ``val_last.log`` links to it, and each
     epoch's logged mIoU equals ``Evaluator.run_dataset`` on a model
     restored from that epoch alone (at least two epochs' histograms
     differ, else one image's scores must); (c) PSPNet-R50's ADE protocol
     (``ade.pspnet.R50_v1c``: crop 480, ``label_offset`` -1) single-scale
     and ``--msf`` (5 scales with flip) on the ADE-shaped images with the
     CLI's snapshot; (d) each protocol on one small seeded image (crop 96)
     on the card against the same protocol on the CPU with the same
     weights, labels equal on >= 99 % of pixels, and ``tools/
     eval_speed`` for each at the full size (ms an image, the profiler's
     device time an image and the top kernels, the idle share, peak
     memory); ``cv2`` never imported.
  17. the deployment and measurement tools (``tools_phase``): ``tools/
     speed.py`` on R18.speed at 1x1024x2048x3 ``--int8-through`` (each
     kernel's launches per forward equal to the main path's; its ms/iter
     beside the main path's median), ``--deploy`` (K11 once a forward and
     nothing else) and plain bf16 X39.speed at 1x768x1536x3 (no kernel);
     ``--int8`` (``deploy/quantize.py``): each conv's route fixed when the
     model was quantized and one forward's convs by route equal to it,
     ``conv_i8_affine`` (the no-ReLU float32 mode of the tensor-core conv)
     bit-exact against its plain version on every call of a forward, timed
     (CUDA events, and its device time by the profiler) against its bound
     and ``torch._int_mm`` of the same GEMMs, and the card against the CPU
     plain run at 128x256: in float64 every conv's codes and every label
     equal; in float32 the first conv whose codes differ differs only at
     rounding midpoints (the float glue rounds otherwise on the two) and
     the labels agree on PTQ_F32_FLOOR;
     ``deploy/export.py``: the int8-through artifact exported with
     ``--platforms cuda`` and loaded in a fresh process that imports only
     the kernel module, its codes and labels equal to the live main-path
     graph's bit for bit on two images, and the bf16 float artifact equal
     to its live forward (``--check``); a seeded reference-layout
     BiSeNet-R18 ``.pth`` through ``eval.py --torch-checkpoint`` (card vs
     CPU mIoU within 1e-3) and ``export --torch-checkpoint`` (card vs CPU
     log-probs within REF_BAR); ``tools/roofline.py`` of the main path
     (its bound, the profiler's device time, the median); ``tools/
     train_speed.py`` on BiSeNet-R18 at 2 x 512x1024 (K8/K9 35 launches a
     step); ``--summary``; a DCP save and restore
     (``engine/checkpoint_orbax.py``) whose resumed step is bit-identical.

Every failed phase raises, so the exit code is non-zero.  The line before
last is a JSON object with the kernels' numbers (each with its bound: the
larger of its bytes over 3.35 TB/s and its operations over the peak rate
for their type, from the H100 SXM data sheet); the last line is
``{"ok": true, "device": {...}}``.  Only the port is imported (no JAX).
TF32 is off for cuDNN and matmuls, set here and by the entry: calibration
runs the float graph in float32 on the card.  The script uses one card:
it makes only the first visible one visible to itself.
"""

import contextlib
import copy
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import types

os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

SCRIPT_T0 = time.perf_counter()
H, W = 1024, 2048
SMALL = (256, 512)  # the card-vs-CPU comparison's input
N_IMAGES = 4
FWD_ROUNDS = 25  # 100 timed forwards: p90 has ten samples beyond it
FULLRES_ROUNDS = 10  # 40 timed forwards per full-resolution graph
BF16_AGREE = 0.97  # bf16 card vs bf16 CPU labels (see the full-res phase)
X39_HW, X39_SMALL = (768, 1536), (256, 512)
X39_ROUNDS = 10  # 40 timed forwards
PSP_HW, PSP_SMALL = (480, 480), (160, 160)
PSP_ROUNDS = 10  # 40 timed forwards
PSP_AGREE = 0.99  # card vs CPU labels, the head in float32 on both
PSP_LAUNCHES = {"maxpool2d_3x3s2_i8": 1, "cbr_i8": 2, "bottleneck_i8": 48}
# the families phase: (experiment, row tag, launches of one forward); each
# served at its published crop (entry.SERVE_CROPS), batch 1.  K10 once,
# the deep stem's two cbr_i8 (BiSeNet-R101: and its spatial path's three),
# bottleneck_i8 three a block (R50 16 blocks, R101 33)
FAMILIES = (
    ("ade.psanet.R50_v1c", "psanet_r50",
     {"maxpool2d_3x3s2_i8": 1, "cbr_i8": 2, "bottleneck_i8": 48}),
    ("voc.fcn32s.R101_v1c", "fcn32s_r101",
     {"maxpool2d_3x3s2_i8": 1, "cbr_i8": 2, "bottleneck_i8": 99}),
    ("cityscapes.dfn.R101_v1c", "dfn_r101",
     {"maxpool2d_3x3s2_i8": 1, "cbr_i8": 2, "bottleneck_i8": 99}),
    ("cityscapes.bisenet.R101", "bisenet_r101",
     {"maxpool2d_3x3s2_i8": 1, "cbr_i8": 5, "bottleneck_i8": 99}),
)
FAM_SMALL = (160, 160)  # card vs CPU labels, float32 heads (PSPNet's size)
FAM_AGREE = 0.99
FAM_ROUNDS = 5  # 20 timed forwards a graph
TRAIN_CROP, TRAIN_BATCH = (1024, 1024), 2
# card-vs-CPU step, at a size and seed where the float32 step is
# well-conditioned: at batch 2 BiSeNet's (B, C, 1, 1) BNs see two values a
# channel, and ReLU and max-pool comparisons that rounding flips reroute
# gradients.  scripts/torch_step_conditioning.py measures the CPU float32
# step's largest per-tensor gradient error against float64: 2.3e-2 to
# 1.9e-1 at 2 x 128x128 and 3.6e-3 to 5.5e-2 at 8 x 128x128 (seeds 0-2),
# 1.3e-5 here
CHECK_CROP, CHECK_BATCH, CHECK_SEED = (64, 64), 8, 2
TRAIN_STEPS = 12  # timed steps (after two warm-up steps)
DRYRUN_STEPS = 20
PROFILED_STEPS = 3
BN_LAUNCHES, BN_RELU = 35, 22  # per training step (BiSeNet-R18's 35 BNs)
# the dp1 x sp2 phase: its step at TRAIN_BATCH x TRAIN_CROP, where every map
# down to /32 stays sharded and only the three (B, C, 1, 1) gate BNs (the
# global context's, the two ARMs') sum over the data group
SP_STEPS = 6  # timed steps (after two warm-up steps)
SP_GATE_BNS = 3
SP_LOSS_RTOL, SP_GRAD_BAR = 3e-3, 3e-2  # JAX tests/test_spatial.py
# JAX's per-leaf bar holds the step where the float32 step is well-
# conditioned (CHECK_*: 1.4e-5 on the CPU).  At TRAIN_BATCH x TRAIN_CROP
# the float32 step's own gradients move more than that bar when only its
# conv algorithms change (one-process, cuDNN off vs deterministic cuDNN:
# 5.8e-2 at the worst leaf, 2.6e-2 at the median, PERF.md), so there the
# per-leaf numbers are recorded and the whole gradient's relative L2
# difference is held to this guard against gross errors
SP_L2_BAR = 3e-2
SP_AGREE = 0.999  # sp2 vs one-rank eval labels (JAX tests/test_spatial.py)
SP_EVAL_ROUNDS = 5  # 10 timed evaluations
DFN_CROP, DFN_BATCH = (800, 800), 2
# card-vs-CPU DFN step.  No size makes DFN-R101's float32 step close to
# float64: scripts/torch_step_conditioning.py measures the CPU float32
# step's whole-gradient L2 error against float64 at 3.5e-2 to 5.3e-2 (8 x
# 64x64 and 4 x 128x128, seeds 0-2; the ResNet-101 backward from random
# weights, with the border loss alone too), so the card is held to the
# CPU float32 step's own distance (step_vs_cpu, as_float32)
DFN_CHECK_CROP, DFN_CHECK_BATCH, DFN_CHECK_SEED = (64, 64), 8, 0
# From seeded random weights the DFN-R101 step at lr 7e-4 (7e-3 on the
# decoder) first overshoots (the loss jumps ~25x at the third step, in
# float64 on the CPU as on the card) and then, for some seeds, settles and
# falls while others stay chaotic (PERF.md, Findings): the dryrun uses a seed
# whose 20 steps settle
DFN_DRYRUN_SEED = 1
DFN_STEPS, DFN_PROFILED_STEPS = 6, 2
SRC = "torchseg_tpu_torch/csrc/int8_serve_kernels.cu"
SRC_K7 = "torchseg_tpu_torch/csrc/upsample_argmax.cu"
SRC_BN = "torchseg_tpu_torch/csrc/bn_kernels.cu"
SRC_K11 = "torchseg_tpu_torch/csrc/stem_conv.cu"
SRC_FOCAL = "torchseg_tpu_torch/csrc/focal_loss.cu"
# the Bottleneck body and the deep stem's CBRs replace XLA convs in JAX
XLA_BOTTLENECK = "torchseg_tpu/deploy/int8_serve.py:716 (XLA, no TPU kernel)"
XLA_STEM_CBR = "torchseg_tpu/deploy/int8_serve.py:756 (XLA, no TPU kernel)"
# sp3 and the R18 decoder's convs: _apply_cbr, XLA convs in JAX
XLA_CBR = "torchseg_tpu/deploy/int8_serve.py:940 (XLA, no TPU kernel)"
TPU = "torchseg_tpu/ops/pallas/int8_serve_kernels.py"
TPU_K7 = "torchseg_tpu/ops/pallas/upsample_argmax.py:49"
TPU_BN = "torchseg_tpu/ops/pallas/bn_kernel.py"
TPU_K11 = "torchseg_tpu/ops/pallas/stem_conv.py:75"
TPU_FOCAL = "torchseg_tpu/ops/pallas/focal_loss.py"
# the card's memory rate, its dense peaks by type, and a kernel call's
# bound: tools/roofline.py, the yardstick the tools and this script share
from torchseg_tpu_torch.tools.roofline import HBM, PEAK, bound  # noqa: E402


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, inputs, reps=1):
    """Mean ms per call of fn(*args) over every args tuple in ``inputs``
    (each ``reps`` times), CUDA events, after one warm-up pass."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for args in inputs:
            fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(inputs))


def forward_ms(fn, inputs, rounds):
    """CUDA-event ms of each call, ``rounds`` passes over ``inputs`` back to
    back (after one warm-up pass); returns (median, p90, mean)."""
    for args in inputs:
        fn(*args)
    marks = []
    for _ in range(rounds):
        for args in inputs:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            fn(*args)
            ev[1].record()
            marks.append(ev)
    torch.cuda.synchronize()
    samples = np.array([a.elapsed_time(b) for a, b in marks])
    return (float(np.median(samples)), float(np.percentile(samples, 90)),
            float(samples.mean()))


def enqueue_ms(fn, inputs):
    """Host ms to enqueue one call (no sync), mean over ``inputs``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in inputs:
        fn(*args)
    ms = (time.perf_counter() - t0) * 1000.0 / len(inputs)
    torch.cuda.synchronize()
    return ms


def tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tensors(v)


def nbytes(*trees):
    return sum(t.numel() * t.element_size() for tr in trees
               for t in tensors(tr))


def conv_weights(tree):
    """Every int8 conv weight (key "w") in package entry trees."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "w" and torch.is_tensor(v):
                yield v
            else:
                yield from conv_weights(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from conv_weights(v)


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


def check_labels(name, y, hw, num_classes):
    if tuple(y.shape) != (1, *hw) or y.dtype != torch.int32:
        fail(f"{name}: labels {tuple(y.shape)} {y.dtype}, expected "
             f"(1, {hw[0]}, {hw[1]}) int32")
    if int(y.min()) < 0 or int(y.max()) >= num_classes:
        fail(f"{name}: labels outside [0, {num_classes})")


def launch_counts(kernels):
    return {fn.__name__: fn.launches for fn in kernels}


def kernel_counters():
    """(every kernel wrapper of the port, a function that sets their
    launch counts to 0)."""
    from torchseg_tpu_torch.ops.kernels import bn_kernels as B
    from torchseg_tpu_torch.ops.kernels import focal_loss as FL
    from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K
    from torchseg_tpu_torch.ops.kernels import stem_conv as S
    from torchseg_tpu_torch.ops.kernels import upsample_argmax as U

    mods = (K, U, B, S, FL)

    def reset_all():
        for m in mods:
            m.reset_launches()

    return [fn for m in mods for fn in m.KERNELS], reset_all


def compare_codes(name, kern, plain, inputs):
    """Kernel against plain on every input; returns the largest code
    difference.  The stem may flip a round-half tie (one code), but
    rarely: a systematic rounding error moves a large share of codes."""
    worst, n_diff, n_all = 0, 0, 0
    for args in inputs:
        got, ref = kern(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref):
            if g.shape != r.shape or g.dtype != r.dtype:
                fail(f"{name}: {tuple(g.shape)} {g.dtype} vs plain "
                     f"{tuple(r.shape)} {r.dtype}")
            d = (g.int() - r.int()).abs()
            worst = max(worst, int(d.max()))
            n_diff += int((d > 0).sum())
            n_all += d.numel()
    tol, max_share = (1, 1e-3) if name == "stem_pool_i8" else (0, 0.0)
    log(f"{name}: max |kernel - plain| = {worst} code(s) (tolerance "
        f"{tol}); differing codes {n_diff}/{n_all} = "
        f"{n_diff / n_all:.3e} (tolerance {max_share:.0e})")
    if worst > tol:
        fail(f"{name} disagrees with its plain version: {worst} > {tol}")
    if n_diff > max_share * n_all:
        fail(f"{name}: {n_diff}/{n_all} codes differ from its plain "
             f"version, more than a share of {max_share:.0e}")
    return worst


def int_mm_ms(dev, m, k, n):
    """CUDA-event ms of ``torch._int_mm`` of seeded (m, k) x (k, n) int8
    operands (the second column-major where the build takes it)."""
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                      dtype=torch.int8).t()  # column-major (k, n)
    try:
        return cuda_ms(lambda: torch._int_mm(a, b), [()], reps=20)
    except RuntimeError as err:  # a build that wants it row-major
        log(f"torch._int_mm refused a column-major operand ({err}); "
            f"timing it row-major")
        b = b.contiguous()
        return cuda_ms(lambda: torch._int_mm(a, b), [()], reps=20)


def same_macs_yardsticks(dev, xs, wf, kernel_ms, main_ops):
    """Vendor tensor-core calls with the same multiply-accumulates as K1 and
    single K2-K6 links, timed beside them (none is on the path, and none is
    a PyTorch call for the kernels' whole functions, so they are logged
    here and not as ``library_ms``): cuDNN's bf16 conv of K1's s2d 4x4 conv
    (no requant, no pool; NCHW and channels-last), and ``torch._int_mm``
    (int8 -> int32) of im2col GEMMs: K2's sp1 and a K3 link (131,072 x 576
    x 64), stage 3's conv2 (8,192 x 2,304 x 256), K5's conv1 (2,048 x 2,304
    x 512) and conv2 (2,048 x 4,608 x 512, without its projection) and a K6
    link (2,048 x 4,608 x 512)."""
    import torch.nn.functional as F

    x = xs.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
    w = wf.permute(3, 2, 0, 1).contiguous()
    conv = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        conv["nchw"] = cuda_ms(lambda: F.conv2d(x, w), [()], reps=20)
        xl = x.contiguous(memory_format=torch.channels_last)
        wl = w.contiguous(memory_format=torch.channels_last)
        conv["channels_last"] = cuda_ms(lambda: F.conv2d(xl, wl), [()],
                                        reps=20)
    k1 = kernel_ms["stem_pool_i8"]
    log(f"same-MACs yardstick, K1: cuDNN bf16 F.conv2d {tuple(x.shape)} * "
        f"{tuple(w.shape)} (no requant, no pool) NCHW {conv['nchw']:.4f} ms, "
        f"channels-last {conv['channels_last']:.4f} ms; K1 {k1:.4f} ms = "
        f"{k1 / min(conv.values()):.2f}x the faster")
    for tag, name, gemms, links in (
            ("K2", "conv3x3s2_i8:sp1", [(131072, 576, 64)], "one launch"),
            ("K3", "l1_stage_i8", [(131072, 576, 64)], "four links"),
            ("K4", "down_stage_i8:stage3", [(8192, 2304, 256)],
             "four links"),
            ("K5", "down_block_i8", [(2048, 2304, 512), (2048, 4608, 512)],
             "two links"),
            ("K6", "res_block_i8", [(2048, 4608, 512)], "two links")):
        ops, ms = main_ops[name], kernel_ms[name]
        for m, k, n in gemms:
            mm_ms = int_mm_ms(dev, m, k, n)
            log(f"same-MACs yardstick, {tag}: torch._int_mm ({m}, {k}) x "
                f"({k}, {n}) {mm_ms:.4f} ms = "
                f"{2 * m * k * n / mm_ms / 1e9:.1f} TOP/s; {tag} {name} "
                f"({links}, {ops / 1e9:.2f} G int8 ops) {ms:.4f} ms = "
                f"{ops / ms / 1e9:.1f} TOP/s")


# one served forward's tensor-core conv launches, as torch.profiler names
# their instantiations: <mode, window, float32 out> of the resident-weight
# kernel, <mode, split, window, float32 out> of the streaming one (window
# 0: 3x3 pad 1, 2: 1x1).  K2 (stride 2) and K3 on the resident kernel, sp3
# its 1x1; K4 and refine1 unsplit; K5 and K6, and arm0, refine0 and arm1
# (32 and 128 tiles) split over two-block clusters, the three with float32
# out; the head (256 tiles) unsplit with float32 out; the FFM 1x1 (1,024
# tiles) unsplit with float32 out
MAIN_PATH_CONVS = {"conv_i8_mma_res_kernel<0, 0, false>": 4,
                   "conv_i8_mma_res_kernel<1, 0, false>": 2,
                   "conv_i8_mma_res_kernel<0, 2, false>": 1,
                   "conv_i8_mma_kernel<0, 1, 0, false>": 5,
                   "conv_i8_mma_kernel<1, 1, 0, false>": 2,
                   "conv_i8_mma_kernel<2, 1, 0, false>": 2,
                   "conv_i8_mma_kernel<0, 2, 0, false>": 2,
                   "conv_i8_mma_kernel<1, 2, 0, false>": 1,
                   "conv_i8_mma_kernel<2, 2, 0, false>": 1,
                   "conv_i8_mma_kernel<0, 2, 0, true>": 3,
                   "conv_i8_mma_kernel<0, 1, 0, true>": 1,
                   "conv_i8_mma_kernel<0, 1, 2, true>": 1}
# the seven cbr_i8 calls of a served forward, in order
MAIN_CBRS = ("sp3", "arm0", "refine0", "arm1", "refine1", "ffm", "head")


# annotations that the profiler records on the device beside the kernels:
# a scheduled profile's steps, DDP's forward, the optimizer's step
ANNOTATIONS = ("ProfilerStep", "DistributedDataParallel", "Optimizer.")


def device_kernels(prof):
    """The device events of a profile, without the annotations
    (``ANNOTATIONS``) that it records on the device as well."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(ANNOTATIONS)]


def int8_convs(prof, n_calls):
    """{instantiation: launches per call} of the int8 conv kernels in a
    profile of ``n_calls`` calls, and the device kernels by key."""
    import re

    kernels = device_kernels(prof)
    convs = {}
    for e in kernels:
        m = re.search(r"(conv_i8\w*kernel(<[\w, ]+>)?)", e.key)
        if m:
            convs[m.group(1)] = convs.get(m.group(1), 0) + e.count // n_calls
    return convs, kernels


_PROFILER_WARM = []  # set once the process has run a throwaway session


def profile_calls(calls):
    """torch.profiler over ``calls`` (closures), each followed by a
    synchronize, after one more call of the first in the profiler's
    warm-up step, whose events are dropped.  A profile started cold has
    been seen to miss one of four PSPNet forwards' kernels; the counts of
    launches per call read from this one hold every counted call.  A
    session that records no device activity at all (seen once, on the
    full-resolution bf16 graph, after the main path's session had seen
    its kernels) is run once more; the callers fail if that one is empty
    too."""
    from torch.profiler import ProfilerActivity, profile, schedule

    if not _PROFILER_WARM:
        # the first session of a process has been seen to drop events in
        # its active steps too (44 of a main-path forward's 79 kernels,
        # every wrapper's launch counted): a throwaway one first
        _PROFILER_WARM.append(True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            calls[0]()
            torch.cuda.synchronize()
    for attempt in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=len(calls),
                                       repeat=1)) as prof:
            for fn in [calls[0], *calls]:
                fn()
                torch.cuda.synchronize()
                prof.step()
        if device_kernels(prof) or attempt:
            return prof
        log("torch.profiler recorded no device activity; profiling again")


def profile_int8_convs(calls, n_convs, tag):
    """``profile_calls`` over ``calls`` and the int8 convs it saw a call
    (``int8_convs``): profiled again, up to three sessions, while it saw
    fewer than the ``n_convs`` tensor-core launches a call that the
    wrappers counted (the profiler dropping events; a wrong launch shows
    as the same count under other instantiations, which the callers
    check).  Returns (prof, convs, kernels)."""
    for attempt in range(3):
        prof = profile_calls(calls)
        convs, kernels = int8_convs(prof, len(calls))
        if sum(convs.values()) >= n_convs or attempt == 2:
            return prof, convs, kernels
        log(f"{tag}: the profiler saw {sum(convs.values())} of the "
            f"{n_convs} int8 conv launches a call that the wrappers made "
            f"(dropped events); profiling again")


def main_path_kernels(infer, pkg, xss):
    """The device kernels of the served forwards over ``xss`` by
    torch.profiler: the int8 convs of each are MAIN_PATH_CONVS (no
    CUDA-core conv; K5's conv2 the projection split over a cluster; the
    decoder's on the tensor cores).  Returns the kernels' device ms per
    forward."""
    _, convs, kernels = profile_int8_convs(
        [lambda xs=xs: infer(pkg, xs) for xs in xss],
        sum(MAIN_PATH_CONVS.values()), "main path")
    busy = sum(e.self_device_time_total for e in kernels) / 1000.0 / len(xss)
    log(f"one served forward: {sum(e.count for e in kernels) // len(xss)} "
        f"device kernels, {len(kernels)} distinct, {busy:.4f} ms of device "
        f"time (profiler, {len(xss)} forwards); int8 convs {convs}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  device {e.self_device_time_total / 1000.0 / len(xss):9.4f}"
            f" ms per forward, {e.count // len(xss):4d} calls: "
            f"{e.key[:100]}")
    if not kernels:
        fail("the profiler saw no device kernel in a served forward")
    if convs != MAIN_PATH_CONVS:
        fail(f"a served forward's int8 conv launches are {convs}, expected "
             f"{MAIN_PATH_CONVS}")
    return busy


def device_time(fn, inputs, top=6):
    """torch.profiler over one call of ``fn`` per args tuple, through
    ``profile_calls`` (a warm-up call first, each call synchronized; a cold
    session missed one of 48 K10 launches): (device ms of all kernels per
    call, kernels per call, the ``top`` kernels as (ms per call, calls per
    call, name))."""
    prof = profile_calls([lambda a=a: fn(*a) for a in inputs])
    n = len(inputs)
    kern = device_kernels(prof)
    if not kern:
        fail("the profiler saw no device kernel")
    busy = sum(e.self_device_time_total for e in kern) / 1000.0 / n
    ranked = sorted(kern, key=lambda e: -e.self_device_time_total)[:top]
    return (busy, sum(e.count for e in kern) // n,
            [(e.self_device_time_total / 1000.0 / n, e.count // n,
              e.key[:100]) for e in ranked])


@contextlib.contextmanager
def record_cbr_calls(i8):
    """Collect the arguments of every cbr_i8 call the serving graphs make
    (x, e, stride, pad, emit_int8, dilation) while the context is open."""
    fed, cbr = [], i8.cbr_i8

    def spy(x, e, stride, pad, emit_int8=True, dilation=1):
        fed.append((x, e, stride, pad, emit_int8, dilation))
        return cbr(x, e, stride, pad, emit_int8, dilation)

    i8.cbr_i8 = spy
    try:
        yield fed
    finally:
        i8.cbr_i8 = cbr


def cbr_work(args, out):
    """(bytes, int8 operations, GEMM (m, k, n)) of one cbr_i8 call: its
    input, weights, epilogue constants and output once, 2 operations a
    multiply-accumulate."""
    x, e = args[:2]
    k, cin, cout = e["w"].shape[0], e["w"].shape[2], e["w"].shape[3]
    m = out.shape[1] * out.shape[2]
    return nbytes(x, e, out), 2 * m * k * k * cin * cout, (m, k * k * cin,
                                                           cout)


def main_path_cbr(dev, infer, pkg, xss, launches, i8, K):
    """sp3 and the decoder's six convs, the seven cbr_i8 calls of a served
    forward: each bit-exact against apply_cbr on the tensors the forwards
    fed it; each timed (CUDA events, wrapper included) against its plain
    version, its bound and ``torch._int_mm`` of its im2col GEMM (a
    same-MACs yardstick); the main path's /8 logits bit-identical to the
    plain decoder's on the same body codes; the decoder timed as a part on
    the kernels and on the plain float64 route.  Returns (the kernels
    line's row, sp3 ms, decoder ms, plain decoder ms)."""
    with record_cbr_calls(i8) as fed, torch.inference_mode():
        for x in xss:
            infer(pkg, x)
    if len(fed) != len(MAIN_CBRS) * len(xss):
        fail(f"{len(fed)} cbr_i8 calls in {len(xss)} served forwards, "
             f"expected {len(MAIN_CBRS)} each")
    per = {n: fed[i::len(MAIN_CBRS)] for i, n in enumerate(MAIN_CBRS)}
    for name, calls in per.items():
        for args in calls:
            g, r = K.cbr_i8(*args), K.apply_cbr(*args)
            if g.dtype != r.dtype or not torch.equal(g, r):
                fail(f"cbr_i8:{name} differs from apply_cbr on "
                     f"{int((g != r).sum())} of {r.numel()} elements")
    log(f"cbr_i8: bit-exact to apply_cbr on all {len(fed)} calls of the "
        f"{len(xss)} served forwards (sp3 and refine1 codes, the other five "
        f"float32)")
    tot = {"ms": 0.0, "plain": 0.0, "bytes": 0, "ops": 0}
    sp3_ms = 0.0
    for name, calls in per.items():
        ms = cuda_ms(K.cbr_i8, calls, reps=5)
        plain_ms = cuda_ms(K.apply_cbr, calls)
        n_bytes, ops, (m, kk, n) = cbr_work(calls[0], K.cbr_i8(*calls[0]))
        b_ms, b_by = bound(n_bytes, ops, "int8")
        mm_ms = int_mm_ms(dev, m, kk, n)
        x, e = calls[0][:2]
        log(f"cbr_i8:{name} {tuple(x.shape)} -> {tuple(e['w'].shape)} "
            f"{'codes' if calls[0][4] else 'float32'}: kernel {ms:.4f} ms "
            f"(wrapper included) = {ops / ms / 1e9:.1f} TOP/s, plain "
            f"{plain_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}: "
            f"{n_bytes / 1e6:.2f} MB, {ops / 1e9:.3f} G int8 operations) = "
            f"{100 * b_ms / ms:.2f} %; same-MACs yardstick torch._int_mm "
            f"({m}, {kk}) x ({kk}, {n}) {mm_ms:.4f} ms = "
            f"{ops / mm_ms / 1e9:.1f} TOP/s")
        tot["ms"] += ms
        tot["plain"] += plain_ms
        tot["bytes"] += n_bytes
        tot["ops"] += ops
        if name == "sp3":
            sp3_ms = ms
    b_ms, b_by = bound(tot["bytes"], tot["ops"], "int8")
    log(f"cbr_i8, the seven convs of a forward: {tot['ms']:.4f} ms (plain "
        f"{tot['plain']:.4f} ms); {tot['ops'] / 1e9:.2f} G int8 operations, "
        f"bound {b_ms:.5f} ms ({b_by}) = {100 * b_ms / tot['ms']:.2f} %")

    def plain_cbr(*args, **kwargs):  # NHWC-contiguous, as the kernels write
        return K.apply_cbr(*args, **kwargs).contiguous()

    def decoder(body):
        s, f = body
        return i8._apply_int8_decoder(pkg["dec"], s, f[-2], f[-1])

    with torch.inference_mode():
        bodies = [i8.int8_body(pkg, x) for x in xss]
        logits = [decoder(b) for b in bodies]
        cbr, i8.cbr_i8 = i8.cbr_i8, plain_cbr
        try:
            ref = [decoder(b) for b in bodies]
            dec_plain_ms = cuda_ms(decoder, [(b,) for b in bodies])
        finally:
            i8.cbr_i8 = cbr
        dec_ms = cuda_ms(decoder, [(b,) for b in bodies], reps=5)
    for got, want in zip(logits, ref):
        if not torch.equal(got, want) or not torch.equal(
                got.argmax(-1), want.argmax(-1)):
            fail("the main path's /8 logits differ from the plain "
                 "decoder's on the same body codes")
    log(f"main path /8 logits bit-identical to the plain decoder's on the "
        f"same body codes ({len(xss)} images); int8 decoder {dec_ms:.4f} ms "
        f"on the kernels, {dec_plain_ms:.4f} ms on the plain float64 route")
    row = {"name": "cbr_i8:r18_main", "route": "cuda", "source": SRC,
           "replaces": XLA_CBR, "launches": launches["cbr_i8"],
           "max_abs_err": 0, "ms": tot["ms"], "plain_ms": tot["plain"],
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return row, sp3_ms, dec_ms


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    from torchseg_tpu_torch.deploy import fused_stem as fs
    from torchseg_tpu_torch.deploy import int8_serve as i8
    from torchseg_tpu_torch.entry import entry
    from torchseg_tpu_torch.experiments.registry import (
        build_model,
        get_experiment,
    )
    from torchseg_tpu_torch.models import init_weights
    from torchseg_tpu_torch.ops.kernels import _build
    from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K
    from torchseg_tpu_torch.ops.kernels import upsample_argmax as U
    from torchseg_tpu_torch.ops.resize import resize_bilinear_align_corners

    all_kernels, reset_all = kernel_counters()

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; TF32 off (cudnn, matmul)")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    for name in _build.LIBRARIES:
        _build.ready(dev.index, name)
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (parallel nvcc "
        f"{_build.BuildInfo.seconds:.2f} s) -> "
        f"{sorted(_build.BuildInfo.paths.values())}")
    log(f"shared memory per block (opt-in): {_build.smem_optin(dev.index)} "
        f"bytes")
    for name, text in _build.BuildInfo.logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  ptxas [{name}]: " + line.strip())

    # -- main path --------------------------------------------------------
    t0 = time.perf_counter()
    infer, (pkg, xs0) = entry(device=dev, image_hw=(H, W))
    torch.cuda.synchronize()
    log(f"graph built (seeded weights, calibration, int8 package): "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = get_experiment("cityscapes.bisenet.R18.speed")
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8)
              for _ in range(N_IMAGES)]
    xss = [i8.prepare_s2d_input_u8(u, image_mean=cfg.image_mean, device=dev)
           for u in images]
    infer(pkg, xss[0])  # warm-up: library load, cuDNN plans
    torch.cuda.synchronize()

    reset_all()
    labels = infer(pkg, xss[0])
    torch.cuda.synchronize()
    launches = launch_counts(all_kernels)
    log(f"launches in one served forward: {launches}")
    expected = {"stem_pool_i8": 1, "conv3x3s2_i8": 2, "l1_stage_i8": 1,
                "down_stage_i8": 2, "down_block_i8": 1, "res_block_i8": 1,
                "maxpool2d_3x3s2_i8": 0, "cbr_i8": 7, "bottleneck_i8": 0,
                "fused_upsample_argmax": 0, "channel_sum_sumsq": 0,
                "fused_scale_bias_act": 0, "stem_conv7x7_s2": 0,
                "conv_i8_affine": 0, "sigmoid_focal_loss_fwd": 0,
                "sigmoid_focal_loss_bwd": 0}
    if launches != expected:
        fail(f"main path launches {launches}, expected {expected}")

    busy = main_path_kernels(infer, pkg, xss)

    # no float64 conv (a plain version's qconv) in a whole served forward
    with count_float64_convs(K) as n_qconv:
        infer(pkg, xss[0])
        with torch.inference_mode():
            spatial_out, feats = i8.int8_body(pkg, xss[0])
    log(f"float64 convs in a served forward: {n_qconv}")
    if n_qconv:
        fail("a served forward ran float64 convs (plain versions)")

    outs = [labels] + [infer(pkg, x) for x in xss[1:]]
    for y in outs:
        check_labels("main path", y, (H // 8, W // 8), cfg.num_classes)
    log(f"labels {tuple(labels.shape)} {labels.dtype}; distinct labels per "
        f"image: {[int(y.unique().numel()) for y in outs]}")
    with torch.inference_mode():
        logits = i8._apply_int8_decoder(pkg["dec"], spatial_out, feats[-2],
                                        feats[-1])
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite logits")

    # -- kernels against their plain versions, on the main path's tensors -
    st = pkg["stem"]
    per_image = []
    for x in xss:
        sp, pooled = K.stem_pool_i8(x, st["wf"], st["mf"], st["cf"],
                                    st["n_sp"])
        s1 = K.conv3x3s2_i8(sp, pkg["sp1"]["w"], pkg["sp1"]["m"],
                            pkg["sp1"]["c"])
        c4 = K.l1_stage_i8(pooled, pkg["l1_0"], pkg["l1_1"])
        c8 = K.down_stage_i8(c4, pkg["l2_0"], pkg["l2_1"])
        c16 = K.down_stage_i8(c8, pkg["l3_0"], pkg["l3_1"])
        y4 = K.down_block_i8(c16, pkg["l4_0"])
        per_image.append({"xs": x, "sp": sp, "s1": s1, "pooled": pooled,
                          "c4": c4, "c8": c8, "c16": c16, "y4": y4})
    # (bytes, operations, their type) of one call: K1's conv is 7x7x3 ->
    # 128 at stride 2 with bf16 weights on int8 codes; K2-K6 are int8
    # convs (2 operations per multiply-accumulate)
    def stem_work(a, o):
        return (nbytes(a, o), 2 * o[0].shape[1] * o[0].shape[2] * 128 * 147,
                "bf16")

    def conv_work(a, o):
        return (nbytes(a, o), 2 * o.shape[1] * o.shape[2] * sum(
            w.numel() for w in conv_weights({"w": a[1]} if torch.is_tensor(
                a[1]) else a[1:])), "int8")

    cases = [
        ("stem_pool_i8", K.stem_pool_i8, K.stem_pool_i8_plain, 384,
         [(d["xs"], st["wf"], st["mf"], st["cf"], st["n_sp"])
          for d in per_image], stem_work),
        ("conv3x3s2_i8:sp1", K.conv3x3s2_i8, K.conv3x3s2_i8_plain, 515,
         [(d["sp"], *(pkg["sp1"][f] for f in ("w", "m", "c")))
          for d in per_image], conv_work),
        ("conv3x3s2_i8:sp2", K.conv3x3s2_i8, K.conv3x3s2_i8_plain, 515,
         [(d["s1"], *(pkg["sp2"][f] for f in ("w", "m", "c")))
          for d in per_image], conv_work),
        ("l1_stage_i8", K.l1_stage_i8, K.l1_stage_i8_plain, 763,
         [(d["pooled"], pkg["l1_0"], pkg["l1_1"]) for d in per_image],
         conv_work),
        ("down_stage_i8:stage2", K.down_stage_i8, K.down_stage_i8_plain, 986,
         [(d["c4"], pkg["l2_0"], pkg["l2_1"]) for d in per_image],
         conv_work),
        ("down_stage_i8:stage3", K.down_stage_i8, K.down_stage_i8_plain, 986,
         [(d["c8"], pkg["l3_0"], pkg["l3_1"]) for d in per_image],
         conv_work),
        ("down_block_i8", K.down_block_i8, K.down_block_i8_plain, 1136,
         [(d["c16"], pkg["l4_0"]) for d in per_image], conv_work),
        ("res_block_i8", K.res_block_i8, K.res_block_i8_plain, 1226,
         [(d["y4"], pkg["l4_1"]) for d in per_image], conv_work),
    ]
    rows = []
    kernel_ms = {}
    main_ops = {}
    for name, kern, plain, line, inputs, work in cases:
        worst = compare_codes(name.split(":")[0], kern, plain, inputs)
        ms = cuda_ms(kern, inputs, reps=5)
        plain_ms = cuda_ms(plain, inputs, reps=1)
        kernel_ms[name] = ms
        n_bytes, ops, kind = work(inputs[0], kern(*inputs[0]))
        bound_ms, bound_by = bound(n_bytes, ops, kind)
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call "
            f"({len(inputs)} distinct inputs); bound {bound_ms:.5f} ms "
            f"({bound_by}: {n_bytes / 1e6:.2f} MB, {ops / 1e9:.2f} G {kind} "
            f"operations) = {100 * bound_ms / ms:.2f} % of the kernel's time")
        rows.append({"name": name, "route": "cuda", "source": SRC,
                     "replaces": f"{TPU}:{line}",
                     "launches": launches[name.split(":")[0]],
                     "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
        main_ops[name] = ops

    same_macs_yardsticks(dev, per_image[0]["xs"], st["wf"], kernel_ms,
                         main_ops)
    cbr_row, sp3_ms, dec_ms = main_path_cbr(
        dev, infer, pkg, xss, launches, i8, K)
    rows.append(cbr_row)

    # -- the served graph against the plain graph on the CPU, small input -
    cpu_infer, (cpu_pkg, cpu_xs) = entry(device="cpu", image_hw=SMALL,
                                         seed=3)
    card_labels = cpu_infer(to_device(cpu_pkg, dev), cpu_xs.to(dev)).cpu()
    agree = float((card_labels == cpu_infer(cpu_pkg, cpu_xs)).float().mean())
    log(f"small input {SMALL[0]}x{SMALL[1]}: card labels agree with the CPU "
        f"plain graph on {agree:.6f} of pixels")
    if agree < 0.99:
        fail(f"card vs CPU plain graph label agreement {agree} < 0.99")

    # -- timings: served forward and the plain-PyTorch parts --------------
    med, p90, fwd_ms = forward_ms(infer, [(pkg, x) for x in xss], FWD_ROUNDS)
    main_med = med
    log(f"served forward (device input, {N_IMAGES} distinct images, "
        f"{FWD_ROUNDS * N_IMAGES} forwards back to back): median {med:.4f} "
        f"ms, p90 {p90:.4f} ms, mean {fwd_ms:.4f} ms = "
        f"{1000.0 / fwd_ms:.2f} FPS")
    enq = enqueue_ms(infer, [(pkg, x) for x in xss])
    log(f"host time to enqueue one forward (no sync): {enq:.4f} ms "
        f"({'below' if enq < fwd_ms else 'ABOVE'} the forward's "
        f"{fwd_ms:.4f} ms on the card)")
    log(f"device time of a forward (profiler) {busy:.4f} ms: against the "
        f"mean forward of {fwd_ms:.4f} ms the card is idle "
        f"{max(0.0, 1 - busy / fwd_ms):.3f} of the time")
    t0 = time.perf_counter()
    for u in images:
        infer(pkg, i8.prepare_s2d_input_u8(u, image_mean=cfg.image_mean,
                                           device=dev))
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t0) * 1000.0 / len(images)
    log(f"served forward incl. host s2d prep + copy: {e2e_ms:.4f} ms")
    parts = [("stem + pool (K1)", kernel_ms["stem_pool_i8"]),
             ("spatial path 3x3/2 x2 (K2)", kernel_ms["conv3x3s2_i8:sp1"]
              + kernel_ms["conv3x3s2_i8:sp2"]),
             ("sp3 1x1 (cbr_i8)", sp3_ms),
             ("stage 1 (K3)", kernel_ms["l1_stage_i8"]),
             ("stage 2 (K4)", kernel_ms["down_stage_i8:stage2"]),
             ("stage 3 (K4)", kernel_ms["down_stage_i8:stage3"]),
             ("stage 4 block 0 (K5)", kernel_ms["down_block_i8"]),
             ("stage 4 block 1 (K6)", kernel_ms["res_block_i8"]),
             ("int8 decoder (six cbr_i8 + float glue)", dec_ms)]
    total = sum(ms for _, ms in parts)
    for part, ms in sorted(parts, key=lambda p: -p[1]):
        log(f"  part {part}: {ms:.4f} ms = {100 * ms / fwd_ms:.1f} % of the "
            f"mean forward")
    log(f"  sum of parts {total:.4f} ms vs mean forward {fwd_ms:.4f} ms")

    # -- full-resolution path: BiSeNet-R18, two graphs ending in K7 -------
    fcfg = get_experiment("cityscapes.bisenet.R18")
    t0 = time.perf_counter()
    fmodel = init_weights(build_model(fcfg),
                          torch.Generator().manual_seed(0)).to(dev)
    _, i8_pkg, i8_prepare = i8.build_int8_serving_for_experiment(fcfg,
                                                                 fmodel)
    i8_infer, _ = i8.make_int8_through_infer(fmodel, i8_pkg, argmax="tiled")
    bf_model = copy.deepcopy(fmodel).to(torch.bfloat16)
    bf_infer = fs.make_bisenet_fused_infer(bf_model, fcfg.bn_eps,
                                           argmax="fused",
                                           input_format="s2d")
    torch.cuda.synchronize()
    log(f"full-resolution graphs built (R18 seeded weights; int8 package; "
        f"bf16 copy): {time.perf_counter() - t0:.2f} s")
    mean = np.asarray(fcfg.image_mean, np.float32)
    std = np.asarray(fcfg.image_std, np.float32)

    def bf_input(u8, device):
        img = (u8.astype(np.float32) / 255.0 - mean) / std
        return fs.prepare_s2d_input(img, torch.bfloat16, device=device)

    graphs = {
        "bf16 fused-stem, argmax='fused'": (
            bf_infer, [(bf_input(u, dev),) for u in images]),
        "int8-through, argmax='tiled'": (
            lambda xs: i8_infer(i8_pkg, xs),
            [(i8_prepare(u),) for u in images]),
    }
    k7_launches, k11_launches = 0, 0
    for gname, (fn, inputs) in graphs.items():
        fn(*inputs[0])  # warm-up
        torch.cuda.synchronize()
        reset_all()
        y = fn(*inputs[0])
        torch.cuda.synchronize()
        got = launch_counts(all_kernels)
        log(f"{gname}: launches in one forward: {got}")
        want = dict(expected) if gname.startswith("int8") else (
            dict.fromkeys(got, 0) | {"stem_conv7x7_s2": 1})
        want["fused_upsample_argmax"] = 1
        if got != want:
            fail(f"{gname}: launches {got}, expected {want}")
        k7_launches += got["fused_upsample_argmax"]
        k11_launches += got["stem_conv7x7_s2"]
        outs = [y] + [fn(*a) for a in inputs[1:]]
        for y in outs:
            check_labels(gname, y, (H, W), fcfg.num_classes)
        log(f"{gname}: labels {tuple(y.shape)} {y.dtype}; distinct labels "
            f"per image: {[int(y.unique().numel()) for y in outs]}")
        med, p90, mean_ms = forward_ms(fn, inputs, FULLRES_ROUNDS)
        busy, n_kern, top = device_time(fn, inputs)
        log(f"{gname} forward ({N_IMAGES} distinct images, "
            f"{FULLRES_ROUNDS * N_IMAGES} forwards): median {med:.4f} ms, "
            f"p90 {p90:.4f} ms, mean {mean_ms:.4f} ms = "
            f"{1000.0 / mean_ms:.2f} FPS; host time to enqueue one forward "
            f"(no sync) {enqueue_ms(fn, inputs):.4f} ms; device "
            f"{busy:.4f} ms a forward ({n_kern} kernels, profiler), idle "
            f"{max(0.0, 1 - busy / mean_ms):.3f} of the mean forward")
        for ms, calls, key in top:
            log(f"  device {ms:9.4f} ms per forward, {calls:4d} calls: "
                f"{key}")

    # K11 on the bf16 graph's own stem inputs (R18's 128 channels)
    with record_stem_calls(fs) as fed_r18:
        for args in graphs["bf16 fused-stem, argmax='fused'"][1]:
            bf_infer(*args)
    rows.append(k11_row("stem_conv7x7_s2:r18_fullres", fed_r18,
                        k11_launches))

    # K7 against its plain version on each graph's own /8 logits
    def bf_logits(xs):
        with torch.inference_mode():
            stems = fs._fused_stem_s2d(bf_model, xs, fcfg.bn_eps)
            raw = bf_model(None, stem_outs=stems, raw_logits=True)
        return raw.float().permute(0, 2, 3, 1).contiguous()

    def i8_logits(xs):
        with torch.inference_mode():
            s, f = i8.int8_body(i8_pkg, xs)
            return i8._apply_int8_decoder(i8_pkg["dec"], s, f[-2],
                                          f[-1]).contiguous()

    k7_inputs = ([(bf_logits(*a), (H, W)) for a in graphs[
        "bf16 fused-stem, argmax='fused'"][1]]
        + [(i8_logits(*a), (H, W)) for a in graphs[
            "int8-through, argmax='tiled'"][1]])
    worst_share, worst_err = 1.0, 0.0
    for x, hw in k7_inputs:
        got = U.fused_upsample_argmax(x, hw)
        ref = U.fused_upsample_argmax_plain(x, hw)
        scores = resize_bilinear_align_corners(
            x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)
        share, n_clear = U.label_agreement(got, ref, scores)
        # how much lower the kernel's pick scores than the plain pick
        err = float((scores.gather(-1, ref[..., None].long())
                     - scores.gather(-1, got[..., None].long())).abs().max())
        worst_share, worst_err = min(worst_share, share), max(worst_err, err)
        if share < U.MIN_SHARE or n_clear:
            fail(f"fused_upsample_argmax: labels equal on {share:.6f} of "
                 f"pixels, {n_clear} differ beyond a top-two gap of "
                 f"{U.MARGIN}")
    log(f"fused_upsample_argmax vs plain on {len(k7_inputs)} graph logits "
        f"(1, {H // 8}, {W // 8}, 19): labels equal on >= {worst_share:.6f} "
        f"of pixels (bar {U.MIN_SHARE}), none beyond a top-two gap of "
        f"{U.MARGIN}; max score shortfall of the kernel's pick {worst_err}")
    k7_ms = cuda_ms(U.fused_upsample_argmax, k7_inputs, reps=5)
    k7_plain_ms = cuda_ms(U.fused_upsample_argmax_plain, k7_inputs)
    mat_ms = cuda_ms(lambda x, hw: resize_bilinear_align_corners(
        x.permute(0, 3, 1, 2), hw).argmax(dim=1).to(torch.int32), k7_inputs)
    # bytes: the logits in, the labels out; operations: the separable
    # form's float32 flops, 3 a class and output pixel (the column lerp's
    # two products and sum) plus the row pass, 3 a class, output row and
    # source column (a one-thread-a-pixel kernel would count 9 a
    # class and pixel: two row lerps and a column lerp)
    k7_x = k7_inputs[0][0]
    k7_b, _, k7_w, k7_c = k7_x.shape
    k7_ops = 3 * k7_b * k7_c * H * (W + k7_w)
    k7_bound = bound(nbytes(k7_x) + 4 * k7_b * H * W, k7_ops, "f32")
    log(f"fused_upsample_argmax: bound by {k7_ops / 1e6:.1f} M separable "
        f"float32 operations ({k7_ops / PEAK['f32'] * 1e3:.5f} ms) and "
        f"{(nbytes(k7_x) + 4 * k7_b * H * W) / 1e6:.2f} MB; the per-pixel "
        f"count, 9 a class and pixel, would be "
        f"{9 * k7_b * H * W * k7_c / PEAK['f32'] * 1e3:.5f} ms")
    log(f"fused_upsample_argmax: kernel {k7_ms:.4f} ms, plain (row-tiled "
        f"einsum) {k7_plain_ms:.4f} ms, materialized upsample + argmax "
        f"{mat_ms:.4f} ms per call; bound {k7_bound[0]:.5f} ms "
        f"({k7_bound[1]}) = {100 * k7_bound[0] / k7_ms:.2f} %")
    rows.append({"name": "fused_upsample_argmax", "route": "cuda",
                 "source": SRC_K7, "replaces": TPU_K7,
                 "launches": k7_launches, "max_abs_err": worst_err,
                 "ms": k7_ms, "plain_ms": k7_plain_ms,
                 "bound_ms": k7_bound[0], "bound_by": k7_bound[1],
                 "library_ms": None})

    # each graph's card labels against the same graph on the CPU, small.
    # The fused-stem graph is held to the bar in float32: in bf16 these
    # random weights are so ill-conditioned that the order of a conv's
    # float32 sum alone moves ~1.4 % of labels (CPU emulation: the CPU's
    # bf16 conv against one rounding of a float32 sum), so bf16 against
    # bf16 gets a bar of its own, BF16_AGREE, and its share is printed.
    su8 = np.random.default_rng(4).integers(0, 256, (1, *SMALL, 3),
                                            dtype=np.uint8)
    sfloat = (su8.astype(np.float32) / 255.0 - mean) / std

    def fused_graph(model, device, dtype):
        infer = fs.make_bisenet_fused_infer(model, fcfg.bn_eps,
                                            argmax="fused",
                                            input_format="s2d")
        return infer(fs.prepare_s2d_input(sfloat, dtype, device=device)).cpu()

    cpu_pkg = to_device(i8_pkg, "cpu")
    xs_cpu = i8.prepare_s2d_input_u8(su8, image_mean=fcfg.image_mean)
    pairs = [
        ("bf16 fused-stem, argmax='fused', run in float32", 0.99,
         fused_graph(fmodel, dev, torch.float32),
         fused_graph(copy.deepcopy(fmodel).cpu(), None, torch.float32)),
        ("bf16 fused-stem, argmax='fused', in bf16", BF16_AGREE,
         fused_graph(bf_model, dev, torch.bfloat16),
         fused_graph(copy.deepcopy(bf_model).cpu(), None, torch.bfloat16)),
        ("int8-through, argmax='tiled'", 0.99,
         i8_infer(i8_pkg, xs_cpu.to(dev)).cpu(), i8_infer(cpu_pkg, xs_cpu)),
    ]
    for gname, bar, card_y, cpu_y in pairs:
        agree = float((card_y == cpu_y).float().mean())
        log(f"{gname} at {SMALL[0]}x{SMALL[1]}: card labels agree with the "
            f"same graph on the CPU on {agree:.6f} of pixels (bar {bar})")
        if agree < bar:
            fail(f"{gname}: card vs CPU label agreement {agree} < {bar}")
    log(f"peak device memory (serving phases): "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    rows += x39_phase(dev, all_kernels, reset_all)
    rows += psp_phase(dev, all_kernels, reset_all)
    rows += families_phase(dev, all_kernels, reset_all)
    rows += train_phase(dev, all_kernels, reset_all)
    rows += multichip_phase(dev, all_kernels, reset_all)
    rows += sp_phase(dev)
    rows += dfn_phase(dev, all_kernels, reset_all)
    rows += cli_phase(dev, all_kernels, reset_all)
    rows += tools_phase(dev, all_kernels, reset_all, main_med, infer, pkg,
                        expected)
    log(f"chip_smoke: {time.perf_counter() - SCRIPT_T0:.1f} s in all")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


@contextlib.contextmanager
def record_stem_calls(fs):
    """Within the block, every K11 call of ``deploy/fused_stem.py`` is
    recorded as (args, kwargs) in the yielded list (and still runs)."""
    calls, k11 = [], fs.stem_conv7x7_s2

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return k11(*args, **kwargs)

    fs.stem_conv7x7_s2 = spy
    try:
        yield calls
    finally:
        fs.stem_conv7x7_s2 = k11


def k11_row(name, fed, launches):
    """K11 against its plain version on the recorded stem calls ``fed``
    (bf16 as the graph ran them, and with float32 out), timed against the
    plain version and cuDNN's route (a bf16 ``F.conv2d`` on the image,
    then the affine and ReLU in bf16, as the graph ran before K11);
    returns the kernels line's row."""
    import torch.nn.functional as F

    from torchseg_tpu_torch.ops.kernels import stem_conv as S

    calls = [(*args, kwargs.get("out_dtype", torch.bfloat16),
              kwargs.get("pack")) for args, kwargs in fed]
    worst, share_min = 0.0, 1.0
    for x, w, a, b, n_sp, fmt, out_dtype, pack in calls:
        for od in (out_dtype, torch.float32):
            err, share, n_beyond = S.agreement(
                S.stem_conv7x7_s2(x, w, a, b, n_sp, fmt, od, pack),
                S.stem_conv7x7_s2_plain(x, w, a, b, n_sp, fmt, od))
            if n_beyond:
                fail(f"{name}: {n_beyond} {od} elements beyond K11's bar "
                     f"against its plain version")
            if od == torch.bfloat16:
                share_min = min(share_min, share)
                if share < S.MIN_SHARE:
                    fail(f"{name}: bf16 out equal on {share:.6f} of the "
                         f"elements, below {S.MIN_SHARE}")
            worst = max(worst, err)
    x, w, a, b, n_sp, fmt, out_dtype, pack = calls[0]
    if pack is None:
        fail(f"{name}: the served graph passed K11 no packed weights")
    y = S.stem_conv7x7_s2(x, w, a, b, n_sp, fmt, out_dtype, pack)
    log(f"{name}: K11 vs plain on {len(calls)} stem inputs "
        f"{tuple(x.shape)} {x.dtype} {fmt} on {S.route(x)} -> "
        f"{y[0].shape[1]} + "
        f"{y[1].shape[1]} channels: bf16 equal on >= {share_min:.6f} (bar "
        f"{S.MIN_SHARE}), none beyond one bf16 ulp or {S.F32_TOL} of max "
        f"|y| (float32 out too); max |kernel - plain| {worst}")
    ms = cuda_ms(S.stem_conv7x7_s2, calls, reps=20)
    plain_ms = cuda_ms(S.stem_conv7x7_s2_plain, [c[:7] for c in calls],
                       reps=2)
    images = [(S.s2d_to_image(c[0]) if c[5] == "s2d" else c[0][..., :3])
              .permute(0, 3, 1, 2).contiguous() for c in calls]
    wk = w.permute(3, 2, 0, 1).to(x.dtype).contiguous()
    ab = (a.to(x.dtype)[:, None, None], b.to(x.dtype)[:, None, None])
    conv_ms = cuda_ms(lambda im: F.conv2d(im, wk, stride=2, padding=3),
                      [(im,) for im in images], reps=20)
    lib_ms = cuda_ms(lambda im: torch.relu(
        F.conv2d(im, wk, stride=2, padding=3) * ab[0] + ab[1]),
        [(im,) for im in images], reps=20)
    # bytes: the input, the weights and affine, both halves out; operations:
    # the function's 7x7x3 window with its zeros, 2 a multiply-add, at the
    # peak rate for the inputs' type (bf16); the tensor-core route's own
    # work (K = 192, three weight terms) is logged beside it
    ops = 2 * y[0].shape[2] * y[0].shape[3] * w.shape[3] * 147
    tc_ops = 2 * y[0].shape[2] * y[0].shape[3] * pack.shape[2] * 8 * 192 * 3
    bnd, by = bound(nbytes(x, w, a, b, y), ops,
                    "bf16" if x.dtype == torch.bfloat16 else "f32")
    log(f"{name}: the tensor-core route's own work {tc_ops / 1e9:.2f} G bf16 "
        f"operations = {tc_ops / PEAK['bf16'] * 1e6:.2f} us at the dense "
        f"peak; the kernel ran at {tc_ops / (ms * 1e9):.1f} TFLOP/s")
    log(f"{name}: kernel {ms * 1000:.2f} us, plain (float32 cuDNN) "
        f"{plain_ms * 1000:.2f} us, cuDNN bf16 conv {conv_ms * 1000:.2f} us "
        f"and with the affine + ReLU {lib_ms * 1000:.2f} us; bound "
        f"{bnd * 1000:.2f} us ({by}: {nbytes(x, w, a, b, y) / 1e6:.2f} MB, "
        f"{ops / 1e9:.2f} G operations) = {100 * bnd / ms:.1f} % of the "
        f"kernel's time; at the float32 CUDA-core peak "
        f"{ops / PEAK['f32'] * 1e6:.1f} us = "
        f"{ops / PEAK['f32'] * 1e5 / ms:.1f} %")
    return {"name": name, "route": "cuda", "source": SRC_K11,
            "replaces": TPU_K11, "launches": launches, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms, "instruction": S.route(x)}


def x39_phase(dev, all_kernels, reset_all):
    """The X39 path (see the module docstring, item 8); returns the kernels
    line's
    row for K11 at X39's shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torchseg_tpu_torch.deploy import fused_stem as fs
    from torchseg_tpu_torch.entry import DEPLOY_EXPERIMENT, deploy_entry
    from torchseg_tpu_torch.experiments.registry import (
        build_model,
        get_experiment,
    )
    from torchseg_tpu_torch.models import init_weights

    cfg = get_experiment(DEPLOY_EXPERIMENT)
    t0 = time.perf_counter()
    infer, _ = deploy_entry(device=dev)
    torch.cuda.synchronize()
    log(f"X39 bf16 fused-stem graph built ({DEPLOY_EXPERIMENT}, seeded "
        f"weights): {time.perf_counter() - t0:.2f} s")
    mean = np.asarray(cfg.image_mean, np.float32)
    std = np.asarray(cfg.image_std, np.float32)

    def s2d(u8, dtype, device):
        img = (u8.astype(np.float32) / 255.0 - mean) / std
        return fs.prepare_s2d_input(img, dtype, device=device)

    rng = np.random.default_rng(8)
    images = [rng.integers(0, 256, (1, *X39_HW, 3), dtype=np.uint8)
              for _ in range(N_IMAGES)]
    xss = [s2d(u, torch.bfloat16, dev) for u in images]
    infer(xss[0])  # warm-up: library load, cuDNN plans
    torch.cuda.synchronize()

    reset_all()
    labels = infer(xss[0])
    torch.cuda.synchronize()
    got = launch_counts(all_kernels)
    want = dict.fromkeys(got, 0) | {"stem_conv7x7_s2": 1}
    log(f"X39: launches in one served forward: {got}")
    if got != want:
        fail(f"X39 forward launches {got}, expected {want}")
    with record_stem_calls(fs) as fed:
        outs = [infer(x) for x in xss]
    hw8 = (X39_HW[0] // 8, X39_HW[1] // 8)
    for y in outs:
        check_labels("X39", y, hw8, cfg.num_classes)
    log(f"X39: labels {tuple(labels.shape)} {labels.dtype}; distinct labels "
        f"per image: {[int(y.unique().numel()) for y in outs]}")
    row = k11_row("stem_conv7x7_s2", fed, got["stem_conv7x7_s2"])

    # -- the card against the CPU, same graph, smaller input -------------
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    su8 = np.random.default_rng(9).integers(0, 256, (1, *X39_SMALL, 3),
                                            dtype=np.uint8)
    for dtype, bar in ((torch.float32, 0.99), (torch.bfloat16, BF16_AGREE)):
        ys = []
        for device in (dev, "cpu"):
            m = copy.deepcopy(model).to(device=device, dtype=dtype)
            ys.append(fs.make_bisenet_fused_infer(
                m, cfg.bn_eps, argmax=True, input_format="s2d")(
                    s2d(su8, dtype, device)).cpu())
        agree = float((ys[0] == ys[1]).float().mean())
        log(f"X39 at {X39_SMALL[0]}x{X39_SMALL[1]} in {dtype}: card labels "
            f"agree with the CPU on {agree:.6f} of pixels (bar {bar})")
        if agree < bar:
            fail(f"X39 {dtype} card vs CPU label agreement {agree} < {bar}")

    # -- timings -------------------------------------------------------------
    inputs = [(x,) for x in xss]
    med, p90, mean_ms = forward_ms(infer, inputs, X39_ROUNDS)
    enq = enqueue_ms(infer, inputs)
    log(f"X39 forward ({N_IMAGES} distinct images, {X39_ROUNDS * N_IMAGES} "
        f"forwards back to back): median {med:.4f} ms, p90 {p90:.4f} ms, "
        f"mean {mean_ms:.4f} ms = {1000.0 / mean_ms:.2f} FPS; host time to "
        f"enqueue one forward (no sync) {enq:.4f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for args in inputs:
            infer(*args)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1000.0 / len(inputs)
    n_launch = sum(e.count for e in kern) // len(inputs)
    log(f"X39 profiled {len(inputs)} forwards: {n_launch} kernels, "
        f"{busy:.4f} ms of kernel time per forward; against the mean "
        f"forward of {mean_ms:.4f} ms the card is idle "
        f"{max(0.0, 1 - busy / mean_ms):.3f} of the time")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  device {e.self_device_time_total / 1000.0 / len(inputs):9.4f}"
            f" ms per forward, {e.count // len(inputs):4d} calls: "
            f"{e.key[:100]}")
    return [row]


def block_work(x, e, stride, dilation, emit_int8, out):
    """(bytes, int8 operations) of one Bottleneck: its input, weights,
    epilogue constants and output once; 2 operations a multiply-accumulate
    (conv1 at the input's resolution, the rest at the output's)."""
    hw_in = x.shape[1] * x.shape[2]
    hw_out = out.shape[1] * out.shape[2]
    ops = 2 * hw_in * e["conv1"]["w"].numel() + 2 * hw_out * sum(
        e[k]["w"].numel() for k in ("conv2", "conv3", "down") if k in e)
    return nbytes(x, out, {k: e[k] for k in ("conv1", "conv2", "conv3",
                                             "down") if k in e}), ops


def psp_phase(dev, all_kernels, reset_all):
    """The PSPNet path (see the module docstring, item 9); returns the
    kernels line's rows for K10, bottleneck_i8 and cbr_i8."""
    import torch.nn.functional as F

    from torchseg_tpu_torch.deploy import int8_serve as i8
    from torchseg_tpu_torch.entry import PSP_EXPERIMENT, serve_entry
    from torchseg_tpu_torch.experiments.registry import (
        build_model,
        get_experiment,
    )
    from torchseg_tpu_torch.models import init_weights
    from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K

    cfg = get_experiment(PSP_EXPERIMENT)
    t0 = time.perf_counter()
    infer, (pkg, _) = serve_entry(PSP_EXPERIMENT, image_hw=PSP_HW,
                                  device=dev)
    torch.cuda.synchronize()
    log(f"PSPNet-R50 serving graph built (seeded weights, calibration on "
        f"two 256x512 images, int8 package, bf16 head): "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (1, *PSP_HW, 3), dtype=np.uint8)
              for _ in range(N_IMAGES)]
    xss = [i8.prepare_u8_input(u, image_mean=cfg.image_mean, device=dev)
           for u in images]
    infer(pkg, xss[0])  # warm-up: cuDNN plans for stem1 and the head
    torch.cuda.synchronize()

    reset_all()
    labels = infer(pkg, xss[0])
    torch.cuda.synchronize()
    got = launch_counts(all_kernels)
    want = dict.fromkeys(got, 0)
    want.update(PSP_LAUNCHES)
    log(f"PSPNet: launches in one served forward: {got}; K10 by route "
        f"(bytes a load): {K.maxpool2d_3x3s2_i8.routes}")
    if got != want:
        fail(f"PSPNet forward launches {got}, expected {want}")
    if K.maxpool2d_3x3s2_i8.routes != {16: 1, 4: 0}:
        fail(f"PSPNet's K10 launch (C = 128, a fresh output) took route "
             f"{K.maxpool2d_3x3s2_i8.routes}, expected the 16-byte one")
    outs = [labels] + [infer(pkg, x) for x in xss[1:]]
    for y in outs:
        check_labels("PSPNet", y, PSP_HW, cfg.num_classes)
    log(f"PSPNet: labels {tuple(labels.shape)} {labels.dtype}; distinct "
        f"labels per image: {[int(y.unique().numel()) for y in outs]}")

    # -- K10 and every Bottleneck against their plain versions, on what
    # the forwards fed them ------------------------------------------------
    with record_body_calls(i8) as (fed_pool, fed_blocks, fed_cbr), \
            torch.inference_mode():
        for x in xss:
            i8.int8_backbone(pkg, x)
    k10_err = compare_codes("maxpool2d_3x3s2_i8", K.maxpool2d_3x3s2_i8,
                            K.maxpool_i8, fed_pool)
    for args in fed_blocks:
        g, r = K.bottleneck_i8(*args), K.apply_bottleneck(*args)
        if g.dtype != r.dtype or not torch.equal(g, r):
            fail(f"bottleneck_i8 (stride {args[2]}, dilation {args[3]}, "
                 f"{tuple(args[0].shape)}) differs from apply_bottleneck on "
                 f"{int((g != r).sum())} of {r.numel()} elements")
    for args in fed_cbr:
        if not torch.equal(K.cbr_i8(*args), K.apply_cbr(*args)):
            fail("cbr_i8 differs from apply_cbr")
    log(f"bottleneck_i8: bit-exact to apply_bottleneck on all "
        f"{len(fed_blocks)} blocks the {N_IMAGES} forwards ran (16 each, the "
        f"last emitting float32); cbr_i8 bit-exact to apply_cbr on "
        f"{len(fed_cbr)} calls")

    # -- the card against the CPU at a small size, float32 heads ----------
    model = init_weights(build_model(cfg),
                         torch.Generator().manual_seed(0))
    cpu_pkg = to_device(pkg, "cpu")
    cpu_infer, _ = i8.make_int8_pspnet_infer(model, cpu_pkg,
                                             dtype=torch.float32)
    card_infer, _ = i8.make_int8_pspnet_infer(copy.deepcopy(model).to(dev),
                                              pkg, dtype=torch.float32)
    su8 = np.random.default_rng(6).integers(0, 256, (1, *PSP_SMALL, 3),
                                            dtype=np.uint8)
    sxs = i8.prepare_u8_input(su8, image_mean=cfg.image_mean)
    t0 = time.perf_counter()
    cpu_y = cpu_infer(cpu_pkg, sxs)
    cpu_s = time.perf_counter() - t0
    card_y = card_infer(pkg, sxs.to(dev)).cpu()
    stem_eq = float((i8.stem1_i8(sxs, cpu_pkg["stem1"])
                     == i8.stem1_i8(sxs.to(dev), pkg["stem1"]).cpu())
                    .float().mean())
    agree = float((card_y == cpu_y).float().mean())
    log(f"PSPNet at {PSP_SMALL[0]}x{PSP_SMALL[1]}, float32 heads: card labels "
        f"agree with the CPU on {agree:.6f} of pixels (bar {PSP_AGREE}); "
        f"stem1 codes equal on {stem_eq:.6f} (float32 sums in another "
        f"order); CPU forward {cpu_s:.2f} s")
    if agree < PSP_AGREE:
        fail(f"PSPNet card vs CPU label agreement {agree} < {PSP_AGREE}")

    # -- timings -------------------------------------------------------------
    inputs = [(pkg, x) for x in xss]
    med, p90, mean_ms = forward_ms(infer, inputs, PSP_ROUNDS)
    enq = enqueue_ms(infer, inputs)
    log(f"PSPNet forward ({N_IMAGES} distinct images, "
        f"{PSP_ROUNDS * N_IMAGES} forwards back to back): median {med:.4f} "
        f"ms, p90 {p90:.4f} ms, mean {mean_ms:.4f} ms = "
        f"{1000.0 / mean_ms:.2f} FPS; host time to enqueue one forward (no "
        f"sync) {enq:.4f} ms")
    k10_ms = cuda_ms(K.maxpool2d_3x3s2_i8, fed_pool, reps=50)
    k10_plain = cuda_ms(K.maxpool_i8, fed_pool, reps=5)
    # device time on inputs that outgrow the 50 MB L2 (the fed four and
    # four seeded codes of the same shape, 59 MB), read by the profiler
    # for the kernel and for the library yardstick alike
    g = torch.Generator(device=dev).manual_seed(10)
    cold = fed_pool + [(torch.randint(
        -128, 128, fed_pool[0][0].shape, generator=g, device=dev,
        dtype=torch.int8),) for _ in range(8 - len(fed_pool))]
    halves = [(x.half(),) for (x,) in cold]
    # profiled again, up to three sessions, while the profiler saw fewer
    # kernels than calls (a warm session has also been seen to keep only
    # part of the 48 launches); the check below reads the last session
    for attempt in range(3):
        before = dict(K.maxpool2d_3x3s2_i8.routes)
        k10_dev, k10_kernels, _ = device_time(K.maxpool2d_3x3s2_i8,
                                              cold * 6)
        k10_routes = {r: n - before[r] - (r == 16)  # less the warm-up call
                      for r, n in K.maxpool2d_3x3s2_i8.routes.items()}
        if k10_kernels >= 1 or attempt == 2:
            break
        log(f"K10: the profiler saw fewer kernels than the {len(cold) * 6} "
            f"calls (dropped events); profiling again")
    k10_lib, _, lib_top = device_time(
        lambda x: F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1), halves * 6)
    cast_ms, _, _ = device_time(lambda x: x.half(), cold * 6)
    x0 = fed_pool[0][0]
    k10_out = K.maxpool2d_3x3s2_i8(x0)
    # bytes: the codes in, the pooled codes out; 8 maxes an output element
    k10_bound = bound(nbytes(x0, k10_out), 8 * k10_out.numel(), "int8")
    log(f"maxpool2d_3x3s2_i8 {tuple(x0.shape)} -> {tuple(k10_out.shape)}, "
        f"{len(cold)} inputs in turn: kernel {k10_dev * 1000:.2f} us of "
        f"device time (profiler; {k10_kernels} kernel a call, launches by "
        f"route {k10_routes}), {k10_ms * 1000:.2f} us a call with the "
        f"wrapper (CUDA events, host-bound), plain {k10_plain * 1000:.2f} "
        f"us; F.max_pool2d on a float16 copy {k10_lib * 1000:.2f} us of "
        f"device time ({lib_top[0][2][:60]}; + the cast "
        f"{cast_ms * 1000:.2f} us); bound {k10_bound[0] * 1000:.2f} us "
        f"({k10_bound[1]}: {nbytes(x0, k10_out) / 1e6:.2f} MB) = "
        f"{100 * k10_bound[0] / k10_dev:.1f} % of the kernel's device time")
    if k10_routes != {16: len(cold) * 6, 4: 0} or k10_kernels != 1:
        fail(f"K10 on PSPNet's shape took routes {k10_routes} with "
             f"{k10_kernels} device kernels a call: expected one kernel a "
             f"call, on the 16-byte route for all {len(cold) * 6} calls")

    one = fed_blocks[:16]  # the first forward's blocks
    blk_ms = [cuda_ms(K.bottleneck_i8, [a], reps=5) for a in one]
    blk_plain = sum(cuda_ms(K.apply_bottleneck, [a]) for a in one)
    blk_bytes, blk_ops = 0, 0
    for a in one:
        b, o = block_work(*a, K.bottleneck_i8(*a))
        blk_bytes, blk_ops = blk_bytes + b, blk_ops + o
    body_bound = bound(blk_bytes, blk_ops, "int8")
    log(f"bottleneck_i8, the 16 blocks of one forward: {sum(blk_ms):.4f} ms "
        f"(plain float64 {blk_plain:.4f} ms); {blk_ops / 2e9:.2f} G int8 "
        f"multiply-accumulates, bound {body_bound[0]:.5f} ms "
        f"({body_bound[1]}) = {100 * body_bound[0] / sum(blk_ms):.2f} %; "
        f"{blk_ops / sum(blk_ms) / 1e9:.1f} TOP/s")
    # same-MACs yardstick: torch._int_mm of each conv's im2col GEMM (the
    # projection's too), summed over the 16 blocks
    gemms = {}
    for x, e, s, d, _ in one:
        hw_in = x.shape[1] * x.shape[2]
        hw_out = ((x.shape[1] - 1) // s + 1) * ((x.shape[2] - 1) // s + 1)
        for key, m in (("conv1", hw_in), ("conv2", hw_out),
                       ("conv3", hw_out), ("down", hw_out)):
            if key in e:
                w = e[key]["w"]
                shape = (m, w.shape[0] * w.shape[1] * w.shape[2], w.shape[3])
                gemms[shape] = gemms.get(shape, 0) + 1
    mm_ms = sum(n * int_mm_ms(dev, *shape) for shape, n in gemms.items())
    log(f"same-MACs yardstick, bottleneck_i8: torch._int_mm of the 16 "
        f"blocks' {sum(gemms.values())} im2col GEMMs ({len(gemms)} "
        f"distinct) {mm_ms:.4f} ms = {blk_ops / mm_ms / 1e9:.1f} TOP/s; "
        f"the blocks {sum(blk_ms):.4f} ms")
    for (x, e, s, d, emit), ms in zip(one, blk_ms):
        log(f"  block {tuple(x.shape)} stride {s} dilation {d} "
            f"{'int8' if emit else 'float32'} out: {ms:.4f} ms")
    cbr_ms = cuda_ms(K.cbr_i8, fed_cbr[:2], reps=5) * 2
    cbr_plain = cuda_ms(K.apply_cbr, fed_cbr[:2]) * 2
    cbr_out = [K.cbr_i8(*a) for a in fed_cbr[:2]]
    cbr_bound = bound(nbytes([a[:2] for a in fed_cbr[:2]], cbr_out), sum(
        2 * o.shape[1] * o.shape[2] * a[1]["w"].numel()
        for a, o in zip(fed_cbr[:2], cbr_out)), "int8")
    log(f"cbr_i8, stem2 + stem3: {cbr_ms:.4f} ms (plain {cbr_plain:.4f} "
        f"ms); bound {cbr_bound[0]:.5f} ms ({cbr_bound[1]})")

    # the parts of the forward, each alone on the first forward's tensors
    with torch.inference_mode():
        feats = [i8.int8_backbone(pkg, x) for x in xss]
    head = copy.deepcopy(model).to(dev).to(torch.bfloat16).eval()

    def head_logits(f):
        with torch.inference_mode():
            return head.psp_layer(f[-1].permute(0, 3, 1, 2))

    def head_tail(z):
        with torch.inference_mode():
            up = i8.upsample_by_scale(z.float(), 8)
            return torch.log_softmax(up, dim=1).argmax(dim=1)

    logits = [head_logits(f) for f in feats]
    parts = [("stem1 (cuDNN float32 conv + requant)", cuda_ms(
                 lambda x: i8.stem1_i8(x, pkg["stem1"]), [(x,) for x in xss])),
             ("stem2 + stem3 (cbr_i8)", cbr_ms),
             ("max pool (K10)", k10_ms),
             ("16 Bottlenecks (bottleneck_i8)", sum(blk_ms)),
             ("PPM head, bf16 (cuDNN)", cuda_ms(head_logits,
                                                [(f,) for f in feats])),
             ("x8 upsample + log_softmax + argmax", cuda_ms(
                 head_tail, [(z,) for z in logits]))]
    for part, ms in sorted(parts, key=lambda p: -p[1]):
        log(f"  part {part}: {ms:.4f} ms = {100 * ms / mean_ms:.1f} % of the "
            f"mean forward")
    log(f"  sum of parts {sum(ms for _, ms in parts):.4f} ms vs mean forward "
        f"{mean_ms:.4f} ms")

    n_convs = PSP_LAUNCHES["cbr_i8"] + PSP_LAUNCHES["bottleneck_i8"]
    t0 = time.perf_counter()
    prof, convs, kern = profile_int8_convs(
        [lambda a=a: infer(*a) for a in inputs], n_convs, "PSPNet")
    wall = (time.perf_counter() - t0) * 1000.0 / len(inputs)
    busy = sum(e.self_device_time_total for e in kern) / 1000.0 / len(inputs)
    # the profiler's own start-up and the warm-up call fill its wall time,
    # so the idle share is taken against the forward's CUDA-event time
    # instead
    log(f"PSPNet profiled {len(inputs)} forwards: kernels {busy:.4f} ms per "
        f"forward ({wall:.1f} ms wall under the profiler); against the "
        f"mean forward of {mean_ms:.4f} ms the card is idle "
        f"{max(0.0, 1 - busy / mean_ms):.3f} of the time")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  device {e.self_device_time_total / 1000.0 / len(inputs):9.4f}"
            f" ms per forward, {e.count // len(inputs):4d} calls: "
            f"{e.key[:100]}")
    log(f"PSPNet: int8 conv launches per forward (profiler): {convs}")
    if any(k.startswith("conv_i8_kernel") for k in convs) or sum(
            convs.values()) != n_convs:
        fail(f"PSPNet: a forward's int8 conv launches are {convs}: expected "
             f"{PSP_LAUNCHES['cbr_i8']} + {PSP_LAUNCHES['bottleneck_i8']} "
             f"tensor-core launches and no CUDA-core conv_i8_kernel")

    return [
        {"name": "maxpool2d_3x3s2_i8", "route": "cuda", "source": SRC,
         "replaces": f"{TPU}:1308",
         "launches": got["maxpool2d_3x3s2_i8"], "max_abs_err": k10_err,
         "ms": k10_dev, "plain_ms": k10_plain, "bound_ms": k10_bound[0],
         "bound_by": k10_bound[1], "library_ms": k10_lib,
         "wrapper_ms": k10_ms, "k10_route": 16},
        {"name": "bottleneck_i8", "route": "cuda", "source": SRC,
         "replaces": XLA_BOTTLENECK, "launches": got["bottleneck_i8"],
         "max_abs_err": 0, "ms": sum(blk_ms), "plain_ms": blk_plain,
         "bound_ms": body_bound[0], "bound_by": body_bound[1],
         "library_ms": None},
        {"name": "cbr_i8:psp_stem", "route": "cuda", "source": SRC,
         "replaces": XLA_STEM_CBR, "launches": got["cbr_i8"],
         "max_abs_err": 0, "ms": cbr_ms, "plain_ms": cbr_plain,
         "bound_ms": cbr_bound[0], "bound_by": cbr_bound[1],
         "library_ms": None},
    ]


@contextlib.contextmanager
def record_body_calls(i8):
    """Collect the arguments of every K10, bottleneck_i8 and cbr_i8 call
    the serving graphs make while the context is open: (pool calls, block
    calls, cbr calls)."""
    fed_pool, fed_blocks = [], []
    pool, block = i8.maxpool2d_3x3s2_i8, i8.bottleneck_i8

    def spy_pool(x):
        fed_pool.append((x,))
        return pool(x)

    def spy_block(x, e, stride, dilation, emit_int8=True):
        fed_blocks.append((x, e, stride, dilation, emit_int8))
        return block(x, e, stride, dilation, emit_int8)

    i8.maxpool2d_3x3s2_i8, i8.bottleneck_i8 = spy_pool, spy_block
    try:
        with record_cbr_calls(i8) as fed_cbr:
            yield fed_pool, fed_blocks, fed_cbr
    finally:
        i8.maxpool2d_3x3s2_i8, i8.bottleneck_i8 = pool, block


@contextlib.contextmanager
def count_float64_convs(K):
    """The shapes of the float64 convolutions run while the context is open
    (a plain version's ``qconv``, or any ``F.conv2d`` on float64)."""
    import torch.nn.functional as F

    seen, qconv, conv2d = [], K.qconv, F.conv2d

    def counting_qconv(*args, **kwargs):
        seen.append(("qconv", tuple(args[1].shape)))
        return qconv(*args, **kwargs)

    def counting_conv2d(x, w, *args, **kwargs):
        if x.dtype == torch.float64:
            seen.append(("conv2d", tuple(w.shape)))
        return conv2d(x, w, *args, **kwargs)

    K.qconv, F.conv2d = counting_qconv, counting_conv2d
    try:
        yield seen
    finally:
        K.qconv, F.conv2d = qconv, conv2d


def family_phase(dev, all_kernels, reset_all, experiment, tag, launches):
    """One family of the families phase (see the module docstring, item
    14): ``experiment`` through ``serve_entry`` at its published crop;
    returns the kernels line's rows for its K10, cbr_i8 and bottleneck_i8
    launches and a summary for the log."""
    import torch.nn.functional as F

    from torchseg_tpu_torch.deploy import int8_serve as i8
    from torchseg_tpu_torch.entry import SERVE_CROPS, serve_entry
    from torchseg_tpu_torch.experiments.registry import (
        build_model,
        get_experiment,
    )
    from torchseg_tpu_torch.models import init_weights
    from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K

    cfg = get_experiment(experiment)
    hw = SERVE_CROPS[experiment]
    bisenet = cfg.model == "bisenet_r101"
    pad = 3 if bisenet else 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    infer, (pkg, _) = serve_entry(experiment, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    images = [rng.integers(0, 256, (1, *hw, 3), dtype=np.uint8)
              for _ in range(N_IMAGES)]
    xss = [i8.prepare_u8_input(u, pad=pad, image_mean=cfg.image_mean,
                               device=dev) for u in images]
    infer(pkg, xss[0])  # warm-up: cuDNN plans for the stems and the head
    torch.cuda.synchronize()

    reset_all()
    labels = infer(pkg, xss[0])
    torch.cuda.synchronize()
    got = launch_counts(all_kernels)
    want = dict.fromkeys(got, 0)
    want.update(launches)
    log(f"{tag} at {hw[0]}x{hw[1]}: graph built in {build_s:.2f} s "
        f"(seeded weights, calibration on two 256x512 images, int8 "
        f"package, bf16 head); launches in one served forward: {got}")
    if got != want:
        fail(f"{tag} forward launches {got}, expected {want}")
    outs = [labels] + [infer(pkg, x) for x in xss[1:]]
    for y in outs:
        check_labels(tag, y, hw, cfg.num_classes)
    with count_float64_convs(K) as f64:
        infer(pkg, xss[1])
        torch.cuda.synchronize()
    if f64:
        fail(f"{tag}: a served forward ran float64 convs {f64}")
    log(f"{tag}: labels {tuple(labels.shape)} {labels.dtype}; distinct "
        f"labels per image {[int(y.unique().numel()) for y in outs]}; no "
        f"float64 conv in a served forward")

    # -- every K10, cbr_i8 and bottleneck_i8 call of the four forwards
    # against its plain version ---------------------------------------------
    with record_body_calls(i8) as (fed_pool, fed_blocks, fed_cbr):
        for x in xss:
            infer(pkg, x)
    k10_err = compare_codes("maxpool2d_3x3s2_i8", K.maxpool2d_3x3s2_i8,
                            K.maxpool_i8, fed_pool)
    for args in fed_blocks:
        g, r = K.bottleneck_i8(*args), K.apply_bottleneck(*args)
        if g.dtype != r.dtype or not torch.equal(g, r):
            fail(f"{tag}: bottleneck_i8 (stride {args[2]}, dilation "
                 f"{args[3]}, {tuple(args[0].shape)}) differs from "
                 f"apply_bottleneck on {int((g != r).sum())} of "
                 f"{r.numel()} elements")
    for args in fed_cbr:
        if not torch.equal(K.cbr_i8(*args), K.apply_cbr(*args)):
            fail(f"{tag}: cbr_i8 {tuple(args[0].shape)} stride {args[2]} "
                 f"differs from apply_cbr")
    n_blk = launches["bottleneck_i8"] // 3
    n_cbr = launches["cbr_i8"]
    strided = sorted({(a[0].shape[3], a[2]) for a in fed_blocks
                      if a[2] > 1})
    log(f"{tag}: K10 bit-exact on {len(fed_pool)} calls; bottleneck_i8 "
        f"bit-exact to apply_bottleneck on all {len(fed_blocks)} blocks "
        f"({n_blk} a forward; stride-2 blocks (cin, stride) {strided}; "
        f"stage-4 map {tuple(fed_blocks[n_blk - 1][0].shape[1:3])}); "
        f"cbr_i8 bit-exact to apply_cbr on {len(fed_cbr)} calls")

    # -- the card against the CPU at a small size, float32 heads ----------
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    cpu_pkg = to_device(pkg, "cpu")
    make = (i8.make_int8_bisenet_r101_infer if bisenet else functools.partial(
        i8.make_int8_pspnet_infer,
        dequant_all=cfg.model.startswith(("dfn", "fcn"))))
    cpu_infer, _ = make(model, cpu_pkg, dtype=torch.float32)
    card_infer, _ = make(copy.deepcopy(model).to(dev), pkg,
                         dtype=torch.float32)
    su8 = np.random.default_rng(12).integers(0, 256, (1, *FAM_SMALL, 3),
                                             dtype=np.uint8)
    sxs = i8.prepare_u8_input(su8, pad=pad, image_mean=cfg.image_mean)
    t0 = time.perf_counter()
    cpu_y = cpu_infer(cpu_pkg, sxs)
    cpu_s = time.perf_counter() - t0
    card_y = card_infer(pkg, sxs.to(dev)).cpu()
    agree = float((card_y == cpu_y).float().mean())
    log(f"{tag} at {FAM_SMALL[0]}x{FAM_SMALL[1]}, float32 heads: card labels "
        f"agree with the CPU on {agree:.6f} of pixels (bar {FAM_AGREE}); "
        f"CPU forward {cpu_s:.2f} s")
    if agree < FAM_AGREE:
        fail(f"{tag} card vs CPU label agreement {agree} < {FAM_AGREE}")
    del model, cpu_pkg, cpu_infer, card_infer

    # -- timings ---------------------------------------------------------
    inputs = [(pkg, x) for x in xss]
    med, p90, mean_ms = forward_ms(infer, inputs, FAM_ROUNDS)
    enq = enqueue_ms(infer, inputs)
    prof = profile_calls([lambda a=a: infer(*a) for a in inputs])
    kern = device_kernels(prof)
    if not kern:
        fail(f"{tag}: the profiler saw no device kernel in a forward")
    busy = sum(e.self_device_time_total for e in kern) / 1000.0 / len(inputs)
    idle = max(0.0, 1 - busy / mean_ms)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag} forward ({N_IMAGES} distinct images, "
        f"{FAM_ROUNDS * N_IMAGES} forwards back to back): median {med:.4f} "
        f"ms, p90 {p90:.4f} ms, mean {mean_ms:.4f} ms = "
        f"{1000.0 / mean_ms:.2f} FPS; enqueue {enq:.4f} ms; kernels "
        f"{busy:.4f} ms a forward (profiler, "
        f"{sum(e.count for e in kern) // len(inputs)} kernels), idle "
        f"{idle:.3f}; peak memory {peak:.2f} GiB; build {build_s:.2f} s")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  device {e.self_device_time_total / 1000.0 / len(inputs):9.4f}"
            f" ms per forward, {e.count // len(inputs):4d} calls: "
            f"{e.key[:100]}")

    # the parts of the forward: the int8 body (with BiSeNet-R101's spatial
    # path) and the float head on its features
    def body(x):
        with torch.inference_mode():
            if bisenet:
                q = i8.stem1_i8(x, pkg["sp_stem"])
                q = i8.cbr_i8(i8.cbr_i8(q, pkg["sp1"], 2, 1), pkg["sp2"], 2, 1)
                return (i8.cbr_i8(q, pkg["sp3"], 1, 0, emit_int8=False),
                        i8.int8_backbone(pkg["bb"], x[:, 2:-2, 2:-2, :]))
            return None, i8.int8_backbone(
                pkg, x, dequant_all=cfg.model.startswith(("dfn", "fcn")))

    head_model = init_weights(build_model(cfg),
                              torch.Generator().manual_seed(0)).to(
                                  dev, torch.bfloat16).eval()

    def head(sp, feats):
        with torch.inference_mode():
            blocks = tuple(f.to(torch.bfloat16).permute(0, 3, 1, 2)
                           for f in feats)
            if bisenet:
                out = head_model(None, spatial_out=sp.to(
                    torch.bfloat16).permute(0, 3, 1, 2),
                    context_blocks=blocks)
            else:
                out = head_model(None, context_blocks=blocks)
            return out.argmax(dim=1)

    body_ms = cuda_ms(body, [(x,) for x in xss], reps=2)
    outs = [body(x) for x in xss]
    head_ms = cuda_ms(head, outs, reps=2)
    log(f"{tag} parts (CUDA events, each alone): int8 body "
        f"{'+ spatial path ' if bisenet else ''}{body_ms:.4f} ms = "
        f"{100 * body_ms / mean_ms:.1f} % of the mean forward, bf16 head + "
        f"upsample + argmax {head_ms:.4f} ms = "
        f"{100 * head_ms / mean_ms:.1f} %")
    del head_model, outs

    # -- the kernels line's rows, from the first forward's calls ---------
    pool_args = fed_pool[:1]
    k10_ms = cuda_ms(K.maxpool2d_3x3s2_i8, pool_args, reps=20)
    k10_plain = cuda_ms(K.maxpool_i8, pool_args, reps=5)
    half = [(a[0].half().permute(0, 3, 1, 2),) for a in pool_args]
    k10_lib = cuda_ms(lambda x: F.max_pool2d(x, 3, 2, 1), half, reps=20)
    k10_out = K.maxpool2d_3x3s2_i8(pool_args[0][0])
    k10_bound = bound(nbytes(pool_args[0][0], k10_out), 8 * k10_out.numel(),
                      "int8")
    blocks1 = fed_blocks[:n_blk]
    blk_ms = sum(cuda_ms(K.bottleneck_i8, [a], reps=3) for a in blocks1)
    blk_plain = sum(cuda_ms(K.apply_bottleneck, [a]) for a in blocks1)
    blk_bytes = blk_ops = 0
    for a in blocks1:
        b, o = block_work(*a, K.bottleneck_i8(*a))
        blk_bytes, blk_ops = blk_bytes + b, blk_ops + o
    blk_bound = bound(blk_bytes, blk_ops, "int8")
    cbr1 = fed_cbr[:n_cbr]
    cbr_ms = sum(cuda_ms(K.cbr_i8, [a], reps=5) for a in cbr1)
    cbr_plain = sum(cuda_ms(K.apply_cbr, [a]) for a in cbr1)
    cbr_b = cbr_o = 0
    for a in cbr1:
        b, o, _ = cbr_work(a, K.cbr_i8(*a))
        cbr_b, cbr_o = cbr_b + b, cbr_o + o
    cbr_bound = bound(cbr_b, cbr_o, "int8")
    log(f"{tag} kernels, one forward's calls (CUDA events, wrapper "
        f"included): K10 {tuple(pool_args[0][0].shape)} {k10_ms:.4f} ms "
        f"(plain {k10_plain:.4f}, F.max_pool2d on a float16 copy "
        f"{k10_lib:.4f}, bound {k10_bound[0]:.5f} by {k10_bound[1]}); "
        f"{n_blk} bottleneck_i8 {blk_ms:.4f} ms (plain float64 "
        f"{blk_plain:.4f}; {blk_ops / 2e9:.2f} G multiply-accumulates, bound "
        f"{blk_bound[0]:.5f} by {blk_bound[1]} = "
        f"{100 * blk_bound[0] / blk_ms:.2f} %); {n_cbr} cbr_i8 "
        f"{cbr_ms:.4f} ms (plain {cbr_plain:.4f}, bound {cbr_bound[0]:.5f} "
        f"by {cbr_bound[1]})")
    row = {"route": "cuda", "source": SRC, "max_abs_err": 0}
    rows = [
        {**row, "name": f"maxpool2d_3x3s2_i8:{tag}", "replaces": f"{TPU}:1308",
         "launches": got["maxpool2d_3x3s2_i8"], "max_abs_err": k10_err,
         "ms": k10_ms, "plain_ms": k10_plain, "bound_ms": k10_bound[0],
         "bound_by": k10_bound[1], "library_ms": k10_lib},
        {**row, "name": f"bottleneck_i8:{tag}", "replaces": XLA_BOTTLENECK,
         "launches": got["bottleneck_i8"], "ms": blk_ms,
         "plain_ms": blk_plain, "bound_ms": blk_bound[0],
         "bound_by": blk_bound[1], "library_ms": None},
        {**row, "name": f"cbr_i8:{tag}",
         "replaces": XLA_CBR if bisenet else XLA_STEM_CBR,
         "launches": got["cbr_i8"], "ms": cbr_ms, "plain_ms": cbr_plain,
         "bound_ms": cbr_bound[0], "bound_by": cbr_bound[1],
         "library_ms": None},
    ]
    del fed_pool, fed_blocks, fed_cbr, pkg, infer, xss
    return rows, {"tag": tag, "hw": hw, "median": med, "p90": p90,
                  "enqueue": enq, "busy": busy, "idle": idle,
                  "peak_gib": peak, "build_s": build_s, "agree": agree}


def families_phase(dev, all_kernels, reset_all):
    """Every family on the Bottleneck body at its published crop (see the
    module docstring, item 14); returns the kernels line's rows."""
    t0 = time.perf_counter()
    rows, summary = [], []
    for experiment, tag, launches in FAMILIES:
        r, s = family_phase(dev, all_kernels, reset_all, experiment, tag,
                            launches)
        rows += r
        summary.append(s)
        torch.cuda.empty_cache()
    for s in summary:
        log(f"families: {s['tag']} {s['hw'][0]}x{s['hw'][1]} median "
            f"{s['median']:.4f} ms, p90 {s['p90']:.4f}, enqueue "
            f"{s['enqueue']:.4f}, kernels {s['busy']:.4f} (idle "
            f"{s['idle']:.3f}), peak {s['peak_gib']:.2f} GiB, build "
            f"{s['build_s']:.2f} s, card vs CPU {s['agree']:.6f}")
    log(f"families phase: {time.perf_counter() - t0:.1f} s")
    return rows


def step_ms(trainer, data, n):
    """CUDA-event ms of each of ``n`` back-to-back training steps (after
    two warm-up steps): (median, p90, mean), and the mean host ms to
    enqueue one step without a sync."""
    for _ in range(2):
        trainer.train_step(data)
    torch.cuda.synchronize()
    marks, enq = [], []
    for _ in range(n):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        trainer.train_step(data)
        ev[1].record()
        enq.append(time.perf_counter() - t0)
        marks.append(ev)
    torch.cuda.synchronize()
    samples = np.array([a.elapsed_time(b) for a, b in marks])
    return (float(np.median(samples)), float(np.percentile(samples, 90)),
            float(samples.mean()), 1000.0 * float(np.mean(enq)))


def clone_bn(bn):
    """K8's BN operands with the tensors cloned."""
    return tuple(t.detach().clone() if torch.is_tensor(t) else t for t in bn)


def spied_step(trainer, data, all_kernels, reset_all, hooks=()):
    """One training step with the launch counts set to 0 just before it and
    read just after; every K8 call recorded as it was fed ((x, BN operands
    as they were before the call: weight, bias, running stats,
    num_batches_tracked, eps, momentum)), every K9 call ((x, a, b), act)
    and every call of torch's own batch norm counted.  ``hooks``: (module,
    forward hook) pairs registered for the step.  Returns (loss, launches,
    fed, acts, torch_bn, folds): fed/acts K9's, folds K8's."""
    import torch.nn.functional as F

    from torchseg_tpu_torch.ops import norm as N
    from torchseg_tpu_torch.ops.kernels import bn_kernels as B

    fed, acts, torch_bn, folds = [], [], [], []
    f_bn, t_bn = F.batch_norm, torch.batch_norm

    def spy_k8(x, bn=None):
        folds.append((x, None if bn is None else clone_bn(bn)))
        return B.channel_sum_sumsq(x, bn)

    def spy_k9(x, a, b, act="none"):
        fed.append((x, a.detach().clone(), b.detach().clone()))
        acts.append(act)
        return B.fused_scale_bias_act(x, a, b, act)

    def spy_bn(fn):
        def run(*args, **kwargs):
            torch_bn.append(fn.__name__)
            return fn(*args, **kwargs)
        return run

    # the BNs reach K8 and K9 through ops/norm.py's module reference ``K``:
    # a stand-in records what each call is fed and calls the wrapper
    spy = types.SimpleNamespace(**vars(B))
    spy.channel_sum_sumsq, spy.fused_scale_bias_act = spy_k8, spy_k9
    handles = [m.register_forward_hook(h) for m, h in hooks]
    reset_all()
    N.K = spy
    F.batch_norm, torch.batch_norm = spy_bn(f_bn), spy_bn(t_bn)
    try:
        loss, _ = trainer.train_step(data)
        torch.cuda.synchronize()
    finally:
        N.K = B
        F.batch_norm, torch.batch_norm = f_bn, t_bn
        for h in handles:
            h.remove()
    got = launch_counts(all_kernels)
    return (loss, got, [(x.detach(), a, b) for x, a, b in fed], acts,
            torch_bn, [(x.detach(), bn) for x, bn in folds])


def check_step_launches(tag, loss, got, acts, torch_bn, n_bn, n_relu):
    """K8 and K9 ``n_bn`` times each in the step and no other kernel,
    ``n_relu`` of the K9 launches with the ReLU fused (unless None), no
    torch BN."""
    want = dict.fromkeys(got, 0)
    want.update(channel_sum_sumsq=n_bn, fused_scale_bias_act=n_bn)
    log(f"launches in one {tag} step: {got}; K9 with the ReLU fused: "
        f"{acts.count('relu')}; torch batch-norm calls: {len(torch_bn)}")
    if got != want:
        fail(f"{tag} step launches {got}, expected {want}")
    if n_relu is not None and acts.count("relu") != n_relu:
        fail(f"{tag}: {acts.count('relu')} K9 launches fused a ReLU, "
             f"expected {n_relu}")
    if torch_bn:
        fail(f"the {tag} step ran torch's own batch norm: {torch_bn}")
    if not bool(torch.isfinite(loss)):
        fail(f"non-finite {tag} training loss {float(loss)}")


def check_k9(fed, acts):
    """K9 bit-exact to its plain version on each (x, a, b) it was fed, in
    float32 and the same in bfloat16; returns the largest difference."""
    from torchseg_tpu_torch.ops.kernels import bn_kernels as B

    k9_diff = 0.0
    for (x, a, b), act in zip(fed, acts):
        for xx in (x, x.to(torch.bfloat16)):
            got9 = B.fused_scale_bias_act(xx, a, b, act)
            ref9 = B.fused_scale_bias_act_plain(xx, a, b, act)
            if got9.dtype != ref9.dtype or not torch.equal(got9, ref9):
                fail(f"fused_scale_bias_act ({xx.dtype}, {act}, "
                     f"{tuple(xx.shape)}) differs from its plain version "
                     f"on {int((got9 != ref9).sum())} elements")
            k9_diff = max(k9_diff, float((got9.float() - ref9.float()
                                          ).abs().max()))
    return k9_diff


def check_k8_sums(x):
    """K8's sums of ``x`` (no fold) within 1e-5 of sum |x| (sum x) and 1e-5
    relative (sum x^2) of its plain version, the same bits on a second
    call; returns (the sums, the largest absolute error, the largest error
    relative to its bar's scale)."""
    from torchseg_tpu_torch.ops.kernels import bn_kernels as B

    got8 = B.channel_sum_sumsq(x)
    if not torch.equal(got8, B.channel_sum_sumsq(x)):
        fail(f"channel_sum_sumsq {tuple(x.shape)}: two calls on the "
             f"same input differ")
    ref8 = B.channel_sum_sumsq_plain(x)
    abs_sum = x.double().abs().sum(dim=(0, 2, 3))
    d = (got8 - ref8).abs().double()
    sq = ref8[1].double().abs().clamp_min(1e-30)
    rel = max(float((d[0] / abs_sum.clamp_min(1e-30)).max()),
              float((d[1] / sq).max()))
    if bool((d[0] > 1e-5 * abs_sum).any()) or bool(
            (d[1] > 1e-5 * sq).any()):
        fail(f"channel_sum_sumsq {tuple(x.shape)}: sum x off by more "
             f"than 1e-5 of sum |x|, or sum x^2 by more than 1e-5 "
             f"relative, against its plain version")
    return got8, float(d.max()), rel


def check_bn_kernels(tag, fed, acts, folds):
    """K9 bit-exact to its plain version on the step's tensors (float32 and
    the same in bfloat16), K8's sums within 1e-5 of sum |x| (sum x) and
    1e-5 relative (sum x^2) and the same bits on a second call; K8's fold
    (the step's own BN operands, as they were before the step) bit-exact
    against ``bn_fold_plain`` on K8's own sums, running stats and
    num_batches_tracked included, and its a and b the ones the step fed
    K9; returns (K8's and K9's largest absolute error)."""
    from torchseg_tpu_torch.ops.kernels import bn_kernels as B

    k9_diff = check_k9(fed, acts)
    k8_err, k8_rel = 0.0, 0.0
    for (x, bn), (_, a, b) in zip(folds, fed):
        got8, err, rel = check_k8_sums(x)
        k8_err, k8_rel = max(k8_err, err), max(k8_rel, rel)
        k_bn, p_bn = clone_bn(bn), clone_bn(bn)
        stats = B.channel_sum_sumsq(x, k_bn)
        ref = B.bn_fold_plain(got8, x.numel() // x.shape[1], *p_bn)
        bad = [name for name, g, r in zip(
            ("(mean, inv, a, b, d)", "weight", "bias", "running_mean",
             "running_var", "num_batches_tracked"),
            (stats,) + k_bn[:5], (ref,) + p_bn[:5]) if not torch.equal(g, r)]
        if bad:
            fail(f"channel_sum_sumsq's fold {tuple(x.shape)} differs from "
                 f"bn_fold_plain on its own sums: {bad}")
        if not torch.equal(stats, B.channel_sum_sumsq(x, clone_bn(bn))):
            fail(f"channel_sum_sumsq's fold {tuple(x.shape)}: two calls "
                 f"differ")
        if not (torch.equal(stats[2], a) and torch.equal(stats[3], b)):
            fail(f"the step fed K9 {tuple(x.shape)} other a, b than K8's "
                 f"fold gives")
    log(f"{tag}: fused_scale_bias_act bit-exact to its plain version on all "
        f"{len(fed)} BN inputs of the step, float32 and bfloat16; "
        f"channel_sum_sumsq: worst error {k8_rel:.3e} of its bar's scale "
        f"(1e-5), {k8_err:.3e} absolute, the same bits on every call; its "
        f"fold (mean, inv, a, b, d, running stats, counter) bit-exact "
        f"against bn_fold_plain on its own sums on all {len(folds)}, and "
        f"the a, b the step fed K9")
    return k8_err, k9_diff


def step_vs_cpu(dev, experiment, crop, batch, seed, as_float32=False):
    """One step on the card against the same step on the CPU in float64:
    the loss within 1e-4 relative, the running stats within 1e-4 of their
    scale, and each parameter's change within 1e-3 of its largest entry;
    or, with ``as_float32``, for a step whose float32 rounding alone moves
    it further from float64 than that (DFN-R101's), the loss, the running
    stats and the whole update's relative L2 error each within twice the
    CPU float32 step's own distance (or the bars above, if larger).  The
    card's step is gated with cuDNN off (torch's own CUDA convs): cuDNN's
    float32 algorithms round ~1e-5 away from the CPU's, which flips ReLU
    masks and max-pool routes and moves single gradient entries; with
    cuDNN the same step is measured, not gated, as is the CPU's float32
    step."""
    from torchseg_tpu_torch.entry import train_entry

    def run(device, dtype=torch.float32, cudnn=True):
        tr, (_, d) = train_entry(experiment, device=device, crop=crop,
                                 batch=batch, seed=seed)
        tr.model.to(dtype)
        d = dict(d, image=d["image"].to(dtype))
        start = {n: p.detach().double().cpu().clone()
                 for n, p in tr.model.named_parameters()}
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            loss = float(tr.train_step(d)[0])
        return (loss, {n: p.detach().double().cpu() - start[n]
                       for n, p in tr.model.named_parameters()},
                {n: b.detach().double().cpu()
                 for n, b in tr.model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))})

    t0 = time.perf_counter()
    l64, d64, s64 = run("cpu", torch.float64)

    def distance(loss, delta, stats):
        """(loss error, per-tensor change errors relative to the largest
        float64 change, per-buffer stat errors relative to max(1, scale),
        whole-update relative L2 error) against the float64 step."""
        errs = {n: float((delta[n] - r).abs().max() / r.abs().max())
                for n, r in d64.items()}
        serrs = {n: float((stats[n] - r).abs().max()
                          / max(1.0, float(r.abs().max())))
                 for n, r in s64.items()}
        l2 = float(sum(((delta[n] - r) ** 2).sum() for n, r in d64.items())
                   .sqrt() / sum((r ** 2).sum() for r in d64.values()).sqrt())
        return abs(loss - l64) / abs(l64), errs, serrs, l2

    seen = {}
    for tag, device, cudnn in (("CPU float32", "cpu", True),
                               ("card, cuDNN", dev, True),
                               ("card, cuDNN off", dev, False)):
        lerr, errs, serrs, l2 = distance(*run(device, cudnn=cudnn))
        seen[tag] = (lerr, l2, max(serrs.values()))
        worst = max(errs, key=errs.get)
        log(f"{experiment} {batch}x{crop[0]}x{crop[1]} step (seed {seed}), "
            f"{tag} vs CPU float64: loss {lerr:.2e} relative; largest change"
            f" error {errs[worst]:.2e} ({worst}); "
            f"{sum(e > 1e-3 for e in errs.values())} of {len(errs)} tensors "
            f"above 1e-3; update L2 {l2:.2e}; running stats "
            f"{seen[tag][2]:.2e}")
    # the gate: the last one, the card with cuDNN off
    if as_float32:
        bars = [max(b, 2 * c) for b, c in zip((1e-4, 0.0, 1e-4),
                                               seen["CPU float32"])]
        bad = [f"{what} {got:.2e} > {bar:.2e}" for what, got, bar in zip(
            ("loss", "update L2", "running stats"), seen["card, cuDNN off"],
            bars) if got > bar]
    else:
        bad = [n for n, e in errs.items() if e > 1e-3] + [
            n for n, e in serrs.items() if e > 1e-4]
        if lerr > 1e-4:
            bad.append(f"loss {lerr:.2e} > 1e-4")
    if bad:
        fail(f"{experiment}: card step vs CPU float64 step beyond its bars: "
             f"{bad}")
    log(f"card vs CPU step comparison: {time.perf_counter() - t0:.1f} s")


def host_us(fn, inputs, reps=5):
    """Host microseconds per call without a sync (after one warm-up
    pass), mean over ``reps`` passes over ``inputs``."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for args in inputs:
            fn(*args)
    us = (time.perf_counter() - t0) * 1e6 / (reps * len(inputs))
    torch.cuda.synchronize()
    return us


def bn_forward_launches(folds, acts):
    """Device events (kernels, copies, memsets) per train-mode SyncBN
    forward (no process group), by torch.profiler, over one forward on
    each of the step's BN inputs with its own operands (cloned)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torchseg_tpu_torch.ops.norm import SyncBatchNormFn

    calls = [(x, clone_bn(bn), act == "relu")
             for (x, bn), act in zip(folds, acts)]
    for x, bn, relu in calls:  # warm-up
        SyncBatchNormFn.apply(x, *bn, relu, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x, bn, relu in calls:
            SyncBatchNormFn.apply(x, *bn, relu, None)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA)
    return n / len(calls)


def bn_kernel_rows(tag, dev, fed, acts, folds, launches):
    """K8 (with its fold, as the SyncBN forward calls it) and K9 timed per
    step over the step's BN inputs, against their plain versions, the
    one-call library yardsticks and their bounds; their host microseconds
    per call; the SyncBN forward's launches per BN (at most 3); K8 + K9
    against ``F.batch_norm``; returns the kernels line's two rows (without
    max_abs_err)."""
    import torch.nn.functional as F

    from torchseg_tpu_torch.ops.kernels import bn_kernels as B

    inputs8 = [(x, clone_bn(bn)) for x, bn in folds]
    sums8 = [(x,) for x, _ in folds]
    inputs9 = [(x, a, b, act) for (x, a, b), act in zip(fed, acts)]
    k8_ms = cuda_ms(B.channel_sum_sumsq, inputs8, reps=5) * len(fed)
    k8_sums_ms = cuda_ms(B.channel_sum_sumsq, sums8, reps=5) * len(fed)
    k8_plain = cuda_ms(B.channel_sum_sumsq_plain, inputs8) * len(fed)
    k8_lib = cuda_ms(lambda x: torch.batch_norm_stats(x, 1e-5),
                     sums8, reps=5) * len(fed)
    k9_ms = cuda_ms(B.fused_scale_bias_act, inputs9, reps=5) * len(fed)
    k9_plain = cuda_ms(B.fused_scale_bias_act_plain, inputs9) * len(fed)
    stats = [torch.batch_norm_stats(x, 1e-5) for x, _, _ in fed]
    k9_lib = cuda_ms(lambda x, m, s: torch.batch_norm_elemt(
        x, None, None, m, s, 1e-5), [(x, *st) for (x, _, _), st in zip(
            fed, stats)], reps=5) * len(fed)
    k8_host = host_us(B.channel_sum_sumsq, inputs8)
    k9_host = host_us(B.fused_scale_bias_act, inputs9)
    fwd_launches = bn_forward_launches(folds, acts)
    ones = [(x, torch.zeros(x.shape[1], device=dev),
             torch.ones(x.shape[1], device=dev)) for x, _, _ in fed]
    fbn_ms = cuda_ms(lambda x, rm, rv: F.batch_norm(
        x, rm, rv, training=True, momentum=0.1, eps=1e-5), ones,
        reps=5) * len(fed)
    n_el = sum(x.numel() for x, _, _ in fed)
    x_bytes = sum(nbytes(x) for x, _, _ in fed)
    c_all = sum(x.shape[1] for x, _, _ in fed)
    # K8 reads x and four (C,) float32 vectors, writes (5, C) and the two
    # running stats; 3 flops an element (add; multiply-add).  K9 reads x
    # (and a, b), writes y; 2 flops an element (one FMA)
    k8_bound = bound(x_bytes + 4 * 11 * c_all, 3 * n_el, "f32")
    k9_bound = bound(2 * x_bytes + 8 * c_all, 2 * n_el, "f32")
    biggest = max(fed, key=lambda t: t[0].numel())[0]
    big8 = cuda_ms(B.channel_sum_sumsq, [(biggest,)], reps=20)
    big9 = cuda_ms(B.fused_scale_bias_act, [(biggest, torch.ones(
        biggest.shape[1], device=dev), torch.zeros(biggest.shape[1],
                                                   device=dev))], reps=20)
    log(f"{tag} per step, summed over the {len(fed)} BN inputs "
        f"({x_bytes / 1e6:.1f} MB): channel_sum_sumsq with its fold "
        f"{k8_ms:.4f} ms (sums only {k8_sums_ms:.4f}; plain {k8_plain:.4f}, "
        f"torch.batch_norm_stats {k8_lib:.4f}; bound {k8_bound[0]:.4f} ms, "
        f"{k8_bound[1]}); fused_scale_bias_act {k9_ms:.4f} ms (plain "
        f"{k9_plain:.4f}, torch.batch_norm_elemt {k9_lib:.4f}; bound "
        f"{k9_bound[0]:.4f} ms, {k9_bound[1]}); K8 + K9 "
        f"{k8_ms + k9_ms:.4f} ms vs F.batch_norm(training=True) "
        f"{fbn_ms:.4f} ms")
    log(f"{tag} wrapper host time per call (no sync, {len(fed)} inputs x "
        f"5): channel_sum_sumsq with its fold {k8_host:.2f} us, "
        f"fused_scale_bias_act {k9_host:.2f} us; one SyncBN forward: "
        f"{fwd_launches:.2f} device launches (profiler)")
    log(f"{tag} largest BN input {tuple(biggest.shape)} "
        f"({nbytes(biggest) / 1e6:.1f} MB): channel_sum_sumsq {big8:.4f} ms"
        f" ({nbytes(biggest) / big8 / 1e6:.0f} GB/s), fused_scale_bias_act "
        f"{big9:.4f} ms ({2 * nbytes(biggest) / big9 / 1e6:.0f} GB/s)")
    if fwd_launches > 3:
        fail(f"{tag}: one SyncBN forward launches {fwd_launches:.2f} device "
             f"kernels, more than 3")
    return [
        {"name": "channel_sum_sumsq", "route": "cuda", "source": SRC_BN,
         "replaces": f"{TPU_BN}:41", "launches": launches["channel_sum_sumsq"],
         "ms": k8_ms, "plain_ms": k8_plain, "bound_ms": k8_bound[0],
         "bound_by": k8_bound[1], "library_ms": k8_lib, "host_us": k8_host,
         "bn_forward_launches": fwd_launches},
        {"name": "fused_scale_bias_act", "route": "cuda", "source": SRC_BN,
         "replaces": f"{TPU_BN}:68",
         "launches": launches["fused_scale_bias_act"], "ms": k9_ms,
         "plain_ms": k9_plain, "bound_ms": k9_bound[0],
         "bound_by": k9_bound[1], "library_ms": k9_lib, "host_us": k9_host,
         "bn_forward_launches": fwd_launches},
    ]


def profile_steps(tag, trainer, data, n_steps, kernel_names):
    """Device time of ``n_steps`` steps under torch.profiler: the card's
    busy time against the wall time, the named kernels' device time, the
    largest device kernels and host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            trainer.train_step(data)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1000.0 / n_steps
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1000.0 / n_steps
    log(f"{tag}: profiled {n_steps} steps: device busy {busy:.4f} ms of "
        f"{wall:.4f} ms wall per step under the profiler = idle share "
        f"{1 - busy / wall:.3f}")
    for kname, label in kernel_names:
        dev_ms = sum(e.self_device_time_total for e in kernels
                     if kname in e.key) / 1000.0 / n_steps
        log(f"  {label}: {dev_ms:.4f} ms of kernel time per step (its CUDA-"
            f"event time above also holds the gaps while the host runs the "
            f"wrapper)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  device {e.self_device_time_total / 1000.0 / n_steps:9.4f}"
            f" ms per step, {e.count // n_steps:4d} calls: {e.key[:110]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    n_ops = sum(e.count for e in prof.key_averages()
                if e.key.startswith("aten::")) // n_steps
    log(f"host: {n_ops} aten calls per step; largest self host times:")
    for e in host[:8]:
        log(f"  host {e.self_cpu_time_total / 1000.0 / n_steps:9.4f} ms"
            f" per step, {e.count // n_steps:4d} calls: {e.key[:80]}")


BN_KERNEL_NAMES = (("channel_sums", "channel_sum_sumsq"),
                   ("scale_bias_act", "fused_scale_bias_act"))


def train_phase(dev, all_kernels, reset_all):
    """The training path (see the module docstring, item 10); returns the
    kernels line's rows for K8 and K9."""
    import functools

    from torch import nn

    from torchseg_tpu_torch import models
    from torchseg_tpu_torch.engine.trainer import Trainer
    from torchseg_tpu_torch.entry import TRAIN_EXPERIMENT, dryrun, train_entry
    from torchseg_tpu_torch.experiments.registry import (
        build_loss_fn,
        get_experiment,
    )

    # -- the step on the card; launches over exactly one step -------------
    t0 = time.perf_counter()
    trainer, (_, data) = train_entry(device=dev, crop=TRAIN_CROP,
                                     batch=TRAIN_BATCH)
    torch.cuda.synchronize()
    log(f"training step built (BiSeNet-R18, seeded weights, {TRAIN_BATCH}x"
        f"{TRAIN_CROP[0]}x{TRAIN_CROP[1]} synthetic batch): "
        f"{time.perf_counter() - t0:.2f} s")
    trainer.train_step(data)  # warm-up: library load, cuDNN plans
    torch.cuda.synchronize()
    loss0, got, fed, acts, torch_bn, folds = spied_step(
        trainer, data, all_kernels, reset_all)
    check_step_launches("training", loss0, got, acts, torch_bn, BN_LAUNCHES,
                        BN_RELU)

    # -- K8 and K9 against their plain versions, on the step's tensors ----
    k8_err, k9_diff = check_bn_kernels("training step", fed, acts, folds)

    # -- one step on the card against the CPU, small crop -----------------
    step_vs_cpu(dev, TRAIN_EXPERIMENT, CHECK_CROP, CHECK_BATCH, CHECK_SEED)

    # -- 20 steps on the learnable batch, twice: the same curve (C1) ------
    curves = []
    for run in range(2):
        t0 = time.perf_counter()
        losses = dryrun(DRYRUN_STEPS, device=dev, crop=TRAIN_CROP,
                        batch=TRAIN_BATCH)
        curves.append(losses)
        log(f"dryrun {run}, {DRYRUN_STEPS} steps at {TRAIN_BATCH}x"
            f"{TRAIN_CROP[0]}x{TRAIN_CROP[1]} ({time.perf_counter() - t0:.1f}"
            f" s): loss {np.mean(losses[:3]):.4f} (first 3) -> "
            f"{np.mean(losses[-3:]):.4f} (last 3); {losses}")
    if curves[0] != curves[1]:
        step = next(i for i, (a, b) in enumerate(zip(*curves)) if a != b)
        fail(f"two dryruns in one process give different loss curves, "
             f"from step {step}: {curves[0][step:]} vs {curves[1][step:]}")
    log("dryrun: the two runs' loss curves are bit-identical")

    # -- timings ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    med, p90, mean_ms, enq = step_ms(trainer, data, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"training step ({TRAIN_STEPS} steps back to back): median "
        f"{med:.4f} ms, p90 {p90:.4f} ms, mean {mean_ms:.4f} ms = "
        f"{1000.0 * TRAIN_BATCH / mean_ms:.2f} images/s; host enqueue "
        f"{enq:.4f} ms per step; peak device memory {peak:.1f} MiB")
    rows = bn_kernel_rows("BiSeNet-R18 step", dev, fed, acts, folds, got)
    rows[0]["max_abs_err"], rows[1]["max_abs_err"] = k8_err, k9_diff

    # -- device time of a step: torch.profiler over PROFILED_STEPS ---------
    profile_steps("BiSeNet-R18 step", trainer, data, PROFILED_STEPS,
                  BN_KERNEL_NAMES)

    # -- comparison only: the same step with nn.BatchNorm2d ---------------
    cfg = get_experiment("cityscapes.bisenet.R18")
    tnorm = functools.partial(nn.BatchNorm2d, eps=cfg.bn_eps,
                              momentum=cfg.bn_momentum)
    tmodel = models.init_weights(
        models.bisenet_r18(num_classes=cfg.num_classes, norm=tnorm),
        torch.Generator().manual_seed(0)).to(dev)
    ttrainer = Trainer(tmodel, build_loss_fn(dataclasses.replace(
        cfg, image_height=TRAIN_CROP[0], image_width=TRAIN_CROP[1],
        batch_size=TRAIN_BATCH)), trainer.lr_schedule,
        sgd_momentum=cfg.momentum, lr_mult=trainer.lr_mult, wd=trainer.wd)
    ttrainer.init_state()
    tmed, tp90, tmean, tenq = step_ms(ttrainer, data, TRAIN_STEPS)
    log(f"comparison only, nn.BatchNorm2d as the norm: median {tmed:.4f} ms,"
        f" p90 {tp90:.4f} ms, mean {tmean:.4f} ms; enqueue {tenq:.4f} ms")
    return rows


@contextlib.contextmanager
def spy_bn_calls():
    """Within the block, every K8 call (x, BN operands or None), every
    ``bn_fold_plain`` call (sums, n, BN operands as they were, its output)
    and every K9 call ((x, a, b), act) that ``ops/norm.py`` makes is
    recorded (and still runs): yields (k8, folds, fed, acts)."""
    from torchseg_tpu_torch.ops import norm as N
    from torchseg_tpu_torch.ops.kernels import bn_kernels as B

    k8, folds, fed, acts = [], [], [], []

    def spy_k8(x, bn=None):
        k8.append((x.detach(), None if bn is None else clone_bn(bn)))
        return B.channel_sum_sumsq(x, bn)

    def spy_fold(sums, n, *bn):
        before = (sums.clone(), n.clone(), clone_bn(bn))
        out = B.bn_fold_plain(sums, n, *bn)
        folds.append(before + (out.clone(),))
        return out

    def spy_k9(x, a, b, act="none"):
        fed.append((x.detach(), a.detach().clone(), b.detach().clone()))
        acts.append(act)
        return B.fused_scale_bias_act(x, a, b, act)

    spy = types.SimpleNamespace(**vars(B))
    spy.channel_sum_sumsq, spy.fused_scale_bias_act = spy_k8, spy_k9
    spy.bn_fold_plain = spy_fold
    N.K = spy
    try:
        yield k8, folds, fed, acts
    finally:
        N.K = B


def group_route_rows(dev, group, k8, folds, fed, acts, launches):
    """K8 (sums only, as the process-group route calls it) and K9 at the
    32x32 step's BN inputs, per step, against their plain versions, the
    one-call library yardsticks and their bounds; the group route's SyncBN
    forward launches (profiler) and the host time of its all-reduce and
    fold; returns the kernels line's two rows (without max_abs_err)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torchseg_tpu_torch.ops import norm as N
    from torchseg_tpu_torch.ops.kernels import bn_kernels as B

    sums8 = [(x,) for x, _ in k8]
    inputs9 = [(x, a, b, act) for (x, a, b), act in zip(fed, acts)]
    n_bn = len(sums8)
    k8_ms = cuda_ms(B.channel_sum_sumsq, sums8, reps=5) * n_bn
    k8_plain = cuda_ms(B.channel_sum_sumsq_plain, sums8) * n_bn
    k8_lib = cuda_ms(lambda x: torch.batch_norm_stats(x, 1e-5), sums8,
                     reps=5) * n_bn
    k9_ms = cuda_ms(B.fused_scale_bias_act, inputs9, reps=5) * n_bn
    k9_plain = cuda_ms(B.fused_scale_bias_act_plain, inputs9) * n_bn
    stats = [torch.batch_norm_stats(x, 1e-5) for x, _, _ in fed]
    k9_lib = cuda_ms(lambda x, m, sd: torch.batch_norm_elemt(
        x, None, None, m, sd, 1e-5), [(x, *st) for (x, _, _), st in zip(
            fed, stats)], reps=5) * n_bn
    k8_host = host_us(B.channel_sum_sumsq, sums8)
    fold_in = [(sums, n, bn) for sums, n, bn, _ in folds]
    fold_host = host_us(lambda sums, n, bn: B.bn_fold_plain(
        *N._group_sums(sums, n, group), *clone_bn(bn)), fold_in)
    allreduce_host = host_us(lambda sums, n, bn: N._group_sums(
        sums, n, group), fold_in)
    calls = [(x, clone_bn(bn), act == "relu")
             for (x, _, _), (_, _, bn, _), act in zip(fed, folds, acts)]
    for x, bn, relu in calls:  # warm-up
        N.SyncBatchNormFn.apply(x, *bn, relu, group)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x, bn, relu in calls:
            N.SyncBatchNormFn.apply(x, *bn, relu, group)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    fwd_launches = sum(e.count for e in events) / len(calls)
    n_el = sum(x.numel() for x, _ in k8)
    x_bytes = sum(nbytes(x) for x, _ in k8)
    c_all = sum(x.shape[1] for x, _ in k8)
    # K8 on the group route reads x, writes the (2, C) sums: 3 flops an
    # element; K9 reads x (and a, b), writes y: one FMA an element
    k8_bound = bound(x_bytes + 8 * c_all, 3 * n_el, "f32")
    k9_bound = bound(2 * x_bytes + 8 * c_all, 2 * n_el, "f32")
    log(f"group route, per 32x32 step over its {n_bn} BN inputs "
        f"({x_bytes / 1e6:.3f} MB): channel_sum_sumsq (sums only) "
        f"{k8_ms:.4f} ms (plain {k8_plain:.4f}, torch.batch_norm_stats "
        f"{k8_lib:.4f}; bound {k8_bound[0]:.6f} ms, {k8_bound[1]}); "
        f"fused_scale_bias_act {k9_ms:.4f} ms (plain {k9_plain:.4f}, "
        f"torch.batch_norm_elemt {k9_lib:.4f}; bound {k9_bound[0]:.6f} ms, "
        f"{k9_bound[1]})")
    log(f"group route host time per BN (no sync): K8 wrapper "
        f"{k8_host:.2f} us; the float64 all-reduce of the sums "
        f"{allreduce_host:.2f} us; all-reduce + bn_fold_plain "
        f"{fold_host:.2f} us; one SyncBN forward under the group: "
        f"{fwd_launches:.2f} device launches (profiler: "
        f"{sorted({e.key[:60] for e in events})})")
    return [
        {"name": "channel_sum_sumsq:group_route", "route": "cuda",
         "source": SRC_BN, "replaces": f"{TPU_BN}:41",
         "launches": launches["channel_sum_sumsq"], "ms": k8_ms,
         "plain_ms": k8_plain, "bound_ms": k8_bound[0],
         "bound_by": k8_bound[1], "library_ms": k8_lib, "host_us": k8_host,
         "allreduce_fold_host_us": fold_host,
         "bn_forward_launches": fwd_launches},
        {"name": "fused_scale_bias_act:group_route", "route": "cuda",
         "source": SRC_BN, "replaces": f"{TPU_BN}:68",
         "launches": launches["fused_scale_bias_act"], "ms": k9_ms,
         "plain_ms": k9_plain, "bound_ms": k9_bound[0],
         "bound_by": k9_bound[1], "library_ms": k9_lib,
         "bn_forward_launches": fwd_launches},
    ]


def multichip_phase(dev, all_kernels, reset_all):
    """The training half across processes (module docstring, item 12);
    returns the kernels line's rows for K8 and K9 on the group route."""
    import socket

    import torch.distributed as dist

    from torchseg_tpu_torch.data.base import SyntheticDataset
    from torchseg_tpu_torch.engine.evaluator import Evaluator
    from torchseg_tpu_torch.entry import (
        MULTICHIP_CROP,
        MULTICHIP_STEPS,
        TRAIN_EXPERIMENT,
        dryrun_multichip,
        multichip_trainer,
    )
    from torchseg_tpu_torch.experiments.registry import (
        build_model,
        get_experiment,
    )
    from torchseg_tpu_torch.models import init_weights
    from torchseg_tpu_torch.parallel._multihost_worker import (
        run_four_rank_leg,
    )

    # -- dryrun_multichip(1): NCCL at world size 1, this process rank 0 ----
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        t0 = time.perf_counter()
        with spy_bn_calls() as (k8, folds, fed, acts):
            reset_all()
            losses, acc, _, _ = dryrun_multichip(1, device=dev)
            torch.cuda.synchronize()
            got = launch_counts(all_kernels)
        log(f"dryrun_multichip(1) over {dist.get_backend()} "
            f"({time.perf_counter() - t0:.1f} s): loss "
            f"{np.mean(losses[:3]):.4f} (first 3) -> "
            f"{np.mean(losses[-3:]):.4f} (last 3); {losses}; merged "
            f"histogram {int(acc.hist.sum())} pixels (2 x {MULTICHIP_CROP}"
            f"x{MULTICHIP_CROP}), mIoU {acc.scores()[1]:.4f}")
        want = dict.fromkeys(got, 0)
        want.update(channel_sum_sumsq=BN_LAUNCHES * MULTICHIP_STEPS,
                    fused_scale_bias_act=BN_LAUNCHES * MULTICHIP_STEPS)
        log(f"launches in dryrun_multichip(1) ({MULTICHIP_STEPS} steps and "
            f"the whole-image eval): {got}; K9 with the ReLU fused: "
            f"{acts.count('relu')}; K8 calls with a fold: "
            f"{sum(bn is not None for _, bn in k8)}")
        if got != want:
            fail(f"dryrun_multichip(1) launches {got}, expected {want}")
        if acts.count("relu") != BN_RELU * MULTICHIP_STEPS:
            fail(f"{acts.count('relu')} K9 launches fused a ReLU, expected "
                 f"{BN_RELU * MULTICHIP_STEPS}")
        if any(bn is not None for _, bn in k8) or \
                len(folds) != len(k8):
            fail("the group route must call K8 for the sums only and fold "
                 "them with bn_fold_plain")
        if int(acc.hist.sum()) != 2 * MULTICHIP_CROP ** 2:
            fail(f"merged histogram {int(acc.hist.sum())} pixels")

        # K8's sums-only launches and K9 against their plain versions on
        # the first step's tensors; the fold's a, b are what K9 was fed
        k8s, foldss, feds, actss = (k8[:BN_LAUNCHES], folds[:BN_LAUNCHES],
                                    fed[:BN_LAUNCHES], acts[:BN_LAUNCHES])
        k9_diff = check_k9(feds, actss)
        k8_err = 0.0
        for (x, _), (sums, n, _, out), (_, a, b) in zip(k8s, foldss, feds):
            got8, err, _ = check_k8_sums(x)
            k8_err = max(k8_err, err)
            if not torch.equal(sums, got8) or float(n) != x.numel() // \
                    x.shape[1]:
                fail(f"group route {tuple(x.shape)}: the folded sums or "
                     f"count are not K8's (world size 1)")
            if not (torch.equal(out[2], a) and torch.equal(out[3], b)):
                fail(f"group route {tuple(x.shape)}: K9 was fed other a, b "
                     f"than bn_fold_plain gave")
        log(f"group route: fused_scale_bias_act bit-exact to its plain "
            f"version on the step's {len(feds)} BN inputs (float32 and "
            f"bfloat16); channel_sum_sumsq's sums within its bars "
            f"({k8_err:.3e} absolute), the same bits twice, and the sums "
            f"bn_fold_plain folded; K9 fed the fold's a, b")

        # the 32x32 step at world size 1, timed and profiled
        trainer, data = multichip_trainer(0, 1, dev)
        med, p90, mean_ms, enq = step_ms(trainer, data, TRAIN_STEPS)
        log(f"dryrun_multichip step (world size 1, NCCL, 1 x 32x32, "
            f"{TRAIN_STEPS} steps back to back): median {med:.4f} ms, p90 "
            f"{p90:.4f} ms, mean {mean_ms:.4f} ms; host enqueue {enq:.4f} "
            f"ms")
        profile_steps("dryrun_multichip step", trainer, data,
                      PROFILED_STEPS, BN_KERNEL_NAMES)
        rows = group_route_rows(dev, group, k8s, foldss, feds, actss, got)
        rows[0]["max_abs_err"], rows[1]["max_abs_err"] = k8_err, k9_diff
        del trainer, data
    finally:
        dist.destroy_process_group()

    # -- the four-rank gloo leg, every rank on this card ------------------
    t0 = time.perf_counter()
    outs = run_four_rank_leg("cuda")
    log(f"four-rank gloo leg, every rank on cuda:0 "
        f"({time.perf_counter() - t0:.1f} s): dp4 losses {outs[0]['losses']}"
        f", dp2 x sp2 losses {outs[0]['sp_losses']}, the same on all four "
        f"ranks; local pixels {[o['local_pixels'] for o in outs]}, merged "
        f"{outs[0]['merged_pixels']} on each")

    # -- whole-image evaluation at the Cityscapes frame size ---------------
    cfg = get_experiment(TRAIN_EXPERIMENT)
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0)
                         ).to(dev).eval()
    ev = Evaluator(lambda m, x: m(x), model, cfg.num_classes, cfg.image_mean,
                   cfg.image_std, device=dev)
    ds = SyntheticDataset(num_items=2, image_hw=(H, W),
                          num_classes=cfg.num_classes)
    reset_all()
    acc = ev.run_dataset(ds, mode="whole", process_index=0, process_count=1)
    torch.cuda.synchronize()
    if int(acc.hist.sum()) != 2 * H * W:
        fail(f"whole-image eval at {H}x{W}: histogram {int(acc.hist.sum())}"
             f" pixels, expected {2 * H * W}")
    images = [(ds[i]["image"],) for i in range(2)]
    med, p90, _ = forward_ms(ev.whole_eval, images, 5)
    log(f"whole-image eval of {TRAIN_EXPERIMENT} at {H}x{W} (uint8 in, "
        f"int32 labels on the card): 2 SyntheticDataset images, histogram "
        f"{int(acc.hist.sum())} = 2 x {H} x {W} pixels, mIoU "
        f"{acc.scores()[1]:.4f}; {med:.4f} ms an image (median of 10, p90 "
        f"{p90:.4f}); kernel launches {launch_counts(all_kernels)}")
    return rows


def dp_sp_rows(k8, fed, acts, launches, groups):
    """K8 (sums only) and K9 at the dp1 x sp2 step's BN inputs (this
    rank's shards of the sharded maps, the whole gate maps), per step,
    against their plain versions, the one-call library yardsticks and their
    bounds; the kernels line's two rows (without max_abs_err)."""
    from torchseg_tpu_torch.ops.kernels import bn_kernels as B

    sums8 = [(x,) for x, _ in k8]
    inputs9 = [(x, a, b, act) for (x, a, b), act in zip(fed, acts)]
    n_bn = len(sums8)
    k8_ms = cuda_ms(B.channel_sum_sumsq, sums8, reps=5) * n_bn
    k8_plain = cuda_ms(B.channel_sum_sumsq_plain, sums8) * n_bn
    k8_lib = cuda_ms(lambda x: torch.batch_norm_stats(x, 1e-5), sums8,
                     reps=5) * n_bn
    k9_ms = cuda_ms(B.fused_scale_bias_act, inputs9, reps=5) * n_bn
    k9_plain = cuda_ms(B.fused_scale_bias_act_plain, inputs9) * n_bn
    stats = [torch.batch_norm_stats(x, 1e-5) for x, _, _ in fed]
    k9_lib = cuda_ms(lambda x, m, sd: torch.batch_norm_elemt(
        x, None, None, m, sd, 1e-5), [(x, *st) for (x, _, _), st in zip(
            fed, stats)], reps=5) * n_bn
    n_el = sum(x.numel() for x, _ in k8)
    x_bytes = sum(nbytes(x) for x, _ in k8)
    c_all = sum(x.shape[1] for x, _ in k8)
    k8_bound = bound(x_bytes + 8 * c_all, 3 * n_el, "f32")
    k9_bound = bound(2 * x_bytes + 8 * c_all, 2 * n_el, "f32")
    log(f"dp1 x sp2 step (rank 0), per step over its {n_bn} BN inputs "
        f"({x_bytes / 1e6:.3f} MB; {groups['2-D']} on the 2-D group, "
        f"{groups['data']} on the data group): channel_sum_sumsq (sums "
        f"only) {k8_ms:.4f} ms (plain {k8_plain:.4f}, "
        f"torch.batch_norm_stats {k8_lib:.4f}; bound {k8_bound[0]:.6f} ms, "
        f"{k8_bound[1]}); fused_scale_bias_act {k9_ms:.4f} ms (plain "
        f"{k9_plain:.4f}, torch.batch_norm_elemt {k9_lib:.4f}; bound "
        f"{k9_bound[0]:.6f} ms, {k9_bound[1]})")
    extra = {"launches_2d_group": groups["2-D"],
             "launches_data_group": groups["data"]}
    return [
        {"name": "channel_sum_sumsq:dp_sp", "route": "cuda",
         "source": SRC_BN, "replaces": f"{TPU_BN}:41",
         "launches": launches["channel_sum_sumsq"], "ms": k8_ms,
         "plain_ms": k8_plain, "bound_ms": k8_bound[0],
         "bound_by": k8_bound[1], "library_ms": k8_lib, **extra},
        {"name": "fused_scale_bias_act:dp_sp", "route": "cuda",
         "source": SRC_BN, "replaces": f"{TPU_BN}:68",
         "launches": launches["fused_scale_bias_act"], "ms": k9_ms,
         "plain_ms": k9_plain, "bound_ms": k9_bound[0],
         "bound_by": k9_bound[1], "library_ms": k9_lib, **extra},
    ]


def sp_images(num_classes):
    """The whole-image evaluation's two SyntheticDataset frames of H x W."""
    from torchseg_tpu_torch.data.base import SyntheticDataset

    ds = SyntheticDataset(num_items=2, image_hw=(H, W),
                          num_classes=num_classes)
    return [(ds[i]["image"],) for i in range(2)]


def eval_model(dev):
    """BiSeNet-R18 (the training configuration's model) from seed 0, in
    eval mode on ``dev``, and its configuration."""
    from torchseg_tpu_torch.entry import TRAIN_EXPERIMENT
    from torchseg_tpu_torch.experiments.registry import (
        build_model,
        get_experiment,
    )
    from torchseg_tpu_torch.models import init_weights

    cfg = get_experiment(TRAIN_EXPERIMENT)
    return init_weights(build_model(cfg), torch.Generator().manual_seed(
        0)).to(dev).eval(), cfg


def sp_trainer(cfg, dev, seed):
    """``train_entry``'s step of ``cfg`` as a dp1 x sp2 ``SpatialTrainer``
    over the initialized group (OHEM of ``num_shards=1``, the parameter
    groups, cuDNN's deterministic algorithms), weights from ``seed``."""
    from torchseg_tpu_torch.engine.lr_policy import PolyLR
    from torchseg_tpu_torch.engine.optim import (
        make_lr_mult_tree,
        make_wd_tree,
    )
    from torchseg_tpu_torch.experiments.registry import (
        build_loss_fn,
        build_model,
    )
    from torchseg_tpu_torch.parallel.spatial import (
        SpatialTrainer,
        make_dp_sp_mesh,
    )

    model = build_model(cfg).to(dev)
    trainer = SpatialTrainer(
        model, build_loss_fn(cfg, num_shards=1),
        PolyLR(cfg.lr, cfg.lr_power, cfg.nepochs * cfg.niters_per_epoch),
        sgd_momentum=cfg.momentum,
        lr_mult=make_lr_mult_tree(model, cfg.business_lr_mult),
        wd=make_wd_tree(model, cfg.weight_decay),
        mesh=make_dp_sp_mesh(1, 2), deterministic=True)
    trainer.init_state(torch.Generator().manual_seed(seed))
    return trainer


def sp_config(crop, batch):
    from torchseg_tpu_torch.entry import TRAIN_EXPERIMENT
    from torchseg_tpu_torch.experiments.registry import get_experiment

    return dataclasses.replace(get_experiment(TRAIN_EXPERIMENT),
                               image_height=crop[0], image_width=crop[1],
                               batch_size=batch)


def grads_of(model):
    return {n: p.grad.detach().cpu().numpy()
            for n, p in model.named_parameters()}


def sp_rank(rank, world, port, dev, batches, out):
    """One of the two gloo ranks of the dp1 x sp2 phase, both on cuda:0
    (module docstring, item 13): the step at CHECK_BATCH x CHECK_CROP (seed
    CHECK_SEED) once; the step at TRAIN_BATCH x TRAIN_CROP (seed 0) once
    spied (launches, the group of every SyncBN), then SP_STEPS timed
    steps and a profiled pass (rank 0); then the sp2 whole-image
    evaluation of the two H x W frames.  ``batches``: the two global
    batches on the CPU, as the one-process steps had them.  Puts its
    results (rank 0: the gradients, the K8/K9 checks and rows, the labels)
    on ``out``."""
    from collections import Counter

    import torch.distributed as dist

    from torchseg_tpu_torch.engine.evaluator import Evaluator
    from torchseg_tpu_torch.ops import norm as N

    dev = torch.device(dev)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        all_kernels, reset_all = kernel_counters()
        res = {"rank": rank}
        trainer = sp_trainer(sp_config(CHECK_CROP, CHECK_BATCH), dev,
                             CHECK_SEED)
        res["check_loss"] = float(trainer.train_step(batches["check"])[0])
        if rank == 0:
            res["check_grads"] = grads_of(trainer.model)
        del trainer

        trainer = sp_trainer(sp_config(TRAIN_CROP, TRAIN_BATCH), dev, 0)
        mesh, model, data = trainer.mesh, trainer.model, batches["full"]
        torch.cuda.reset_peak_memory_stats()
        groups = Counter()
        group_sums = N._group_sums

        def spy_groups(sums, n, group):
            groups["2-D" if group is mesh.full_group else
                   "data" if group is mesh.data_group else "other"] += 1
            return group_sums(sums, n, group)

        N._group_sums = spy_groups
        try:
            with spy_bn_calls() as (k8, folds, fed, acts):
                reset_all()
                loss, _ = trainer.train_step(data)
                torch.cuda.synchronize()
                launches = launch_counts(all_kernels)
        finally:
            N._group_sums = group_sums
        res.update(loss=float(loss), launches=launches, groups=dict(groups),
                   relu=acts.count("relu"),
                   k8_folded=sum(bn is not None for _, bn in k8),
                   space=(dict(trainer.space.counts),
                          dict(trainer.space.seconds)))
        if rank == 0:
            res["grads"] = grads_of(model)
            res["k9_diff"] = check_k9(fed, acts)
            res["k8_err"] = max(check_k8_sums(x)[1] for x, _ in k8)
            res["rows"] = dp_sp_rows(k8, fed, acts, launches, groups)
        del k8, folds, fed, acts
        res["step"] = step_ms(trainer, data, SP_STEPS)
        res["halo"] = (trainer.space.seconds["halo"] * 1e3,
                       trainer.space.counts["halo"])
        res["collectives_ms"] = sum(trainer.space.seconds.values()) * 1e3
        res["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
        if rank == 0:
            profile_steps("dp1 x sp2 step (rank 0)", trainer, data,
                          PROFILED_STEPS, BN_KERNEL_NAMES)
        else:
            for _ in range(PROFILED_STEPS):
                trainer.train_step(data)
            torch.cuda.synchronize()
        del trainer, model, data
        torch.cuda.empty_cache()

        emodel, ecfg = eval_model(dev)
        ev = Evaluator(lambda m, x: m(x), emodel, ecfg.num_classes,
                       ecfg.image_mean, ecfg.image_std, device=dev,
                       spatial_shards=world)
        images = sp_images(ecfg.num_classes)
        labels = [ev.whole_eval(*img).cpu().numpy() for img in images]
        res["eval"] = forward_ms(ev.whole_eval, images, SP_EVAL_ROUNDS)
        if rank == 0:
            res["labels"] = labels
        out.put(res)
    finally:
        dist.destroy_process_group()


def reference_step(dev, crop, batch, seed):
    """``train_entry``'s one-process step (deterministic cuDNN): its
    trainer, its batch on the CPU, the loss and the gradients."""
    from torchseg_tpu_torch.entry import train_entry

    trainer, (_, data) = train_entry(device=dev, crop=crop, batch=batch,
                                     seed=seed, deterministic=True)
    loss = float(trainer.train_step(data)[0])
    return trainer, data, loss, grads_of(trainer.model)


def grad_errors(got, ref):
    """Each leaf's max |got - ref| over its max |ref|, largest first, and
    the whole gradient's relative L2 difference."""
    errs = sorted(((float(np.abs(got[n] - g).max())
                    / max(float(np.abs(g).max()), 1e-30), n)
                   for n, g in ref.items()), reverse=True)
    l2 = float(np.sqrt(sum(float(((got[n] - g).astype(np.float64) ** 2)
                                 .sum()) for n, g in ref.items())
                       / sum(float((g.astype(np.float64) ** 2).sum())
                             for g in ref.values())))
    return errs, l2


def sp_phase(dev):
    """The dp x sp leg (module docstring, item 13); returns the kernels
    line's rows for K8 and K9 on the dp1 x sp2 step."""
    import socket

    import torch.multiprocessing as mp

    from torchseg_tpu_torch.engine.evaluator import Evaluator
    from torchseg_tpu_torch.entry import MULTICHIP_CROP, dryrun_multichip

    # -- dryrun_multichip(2) over gloo, both ranks on this card -------------
    t0 = time.perf_counter()
    losses, acc, sp_losses, sp_acc = dryrun_multichip(2, device=dev,
                                                      backend="gloo")
    n_pix = 4 * MULTICHIP_CROP ** 2
    log(f"dryrun_multichip(2) over gloo on cuda:0 "
        f"({time.perf_counter() - t0:.1f} s): dp2 loss "
        f"{np.mean(losses[:3]):.4f} -> {np.mean(losses[-3:]):.4f}; dp1 x "
        f"sp2 loss {np.mean(sp_losses[:3]):.4f} -> "
        f"{np.mean(sp_losses[-3:]):.4f} ({sp_losses}); sp2 whole eval "
        f"histogram {int(sp_acc.hist.sum())} pixels (4 x {MULTICHIP_CROP}x"
        f"{MULTICHIP_CROP}), mIoU {sp_acc.scores()[1]:.4f}")
    if int(sp_acc.hist.sum()) != n_pix or int(acc.hist.sum()) != n_pix:
        fail(f"dryrun_multichip(2) histograms {int(acc.hist.sum())} and "
             f"{int(sp_acc.hist.sum())} pixels, expected {n_pix}")

    # -- the one-process steps and the one-rank eval, the references --------
    trainer, check_data, check_loss, check_grads = reference_step(
        dev, CHECK_CROP, CHECK_BATCH, CHECK_SEED)
    del trainer
    trainer, data, ref_loss, ref_grads = reference_step(
        dev, TRAIN_CROP, TRAIN_BATCH, 0)
    one_step = step_ms(trainer, data, SP_STEPS)
    del trainer
    emodel, ecfg = eval_model(dev)
    ev = Evaluator(lambda m, x: m(x), emodel, ecfg.num_classes,
                   ecfg.image_mean, ecfg.image_std, device=dev)
    images = sp_images(ecfg.num_classes)
    one_labels = [ev.whole_eval(*img).cpu().numpy() for img in images]
    one_eval = forward_ms(ev.whole_eval, images, SP_EVAL_ROUNDS)
    del emodel, ev
    torch.cuda.empty_cache()
    batches = {k: {n: t.cpu() for n, t in v.items()}
               for k, v in (("check", check_data), ("full", data))}
    del check_data, data

    # -- the two ranks -------------------------------------------------------
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    q = mp.get_context("spawn").SimpleQueue()
    t0 = time.perf_counter()
    ctx = mp.spawn(sp_rank, args=(2, port, str(dev), batches, q), nprocs=2,
                   join=False)
    got = []
    while True:  # drain before the join: rank 0's gradients outgrow a pipe
        while not q.empty():
            got.append(q.get())
        if ctx.join(timeout=1):
            break
    while not q.empty():
        got.append(q.get())
    if len(got) != 2:
        fail(f"the dp1 x sp2 ranks returned {len(got)} results")
    r0, r1 = sorted(got, key=lambda r: r["rank"])
    log(f"dp1 x sp2 phase: two gloo ranks on cuda:0 "
        f"({time.perf_counter() - t0:.1f} s)")

    # the well-conditioned step against the one-process step: JAX's bars
    loss_rel = abs(r0["check_loss"] - check_loss) / abs(check_loss)
    errs, l2 = grad_errors(r0["check_grads"], check_grads)
    log(f"dp1 x sp2 step vs the one-process step at {CHECK_BATCH} x "
        f"{CHECK_CROP[0]}x{CHECK_CROP[1]}, seed {CHECK_SEED} (same weights "
        f"and batch, deterministic cuDNN, float32): loss "
        f"{r0['check_loss']:.6f} vs {check_loss:.6f} (relative "
        f"{loss_rel:.3e}, bar {SP_LOSS_RTOL}); largest gradient-leaf max "
        f"|diff| / max |value| {[(n, f'{e:.3e}') for e, n in errs[:4]]} "
        f"(bar {SP_GRAD_BAR}); whole-gradient L2 {l2:.3e}")
    if not loss_rel <= SP_LOSS_RTOL or not errs[0][0] < SP_GRAD_BAR:
        fail(f"dp1 x sp2 step at {CHECK_CROP}: loss off by {loss_rel:.3e}, "
             f"gradient leaf {errs[0][1]} by {errs[0][0]:.3e}")

    # launches: K8 and K9 once per BN, nothing else; K8 sums only
    want = dict.fromkeys(r0["launches"], 0)
    want.update(channel_sum_sumsq=BN_LAUNCHES,
                fused_scale_bias_act=BN_LAUNCHES)
    want_groups = {"2-D": BN_LAUNCHES - SP_GATE_BNS, "data": SP_GATE_BNS}
    for r in (r0, r1):
        log(f"dp1 x sp2 step at {TRAIN_BATCH} x {TRAIN_CROP[0]}x"
            f"{TRAIN_CROP[1]}, rank {r['rank']}: launches {r['launches']}; "
            f"SyncBN groups {r['groups']}; K9 with the ReLU fused "
            f"{r['relu']}; space-context exchanges {r['space'][0]}, host "
            f"ms {({k: round(v * 1e3, 3) for k, v in r['space'][1].items()})}")
        if r["launches"] != want:
            fail(f"dp1 x sp2 rank {r['rank']} launches {r['launches']}, "
                 f"expected {want}")
        if r["groups"] != want_groups or r["relu"] != BN_RELU or \
                r["k8_folded"]:
            fail(f"dp1 x sp2 rank {r['rank']}: SyncBN groups {r['groups']} "
                 f"(expected {want_groups}), {r['relu']} K9 ReLUs "
                 f"(expected {BN_RELU}), {r['k8_folded']} K8 calls with a "
                 f"fold (expected 0: the group route sums only)")
    log(f"dp1 x sp2 step: fused_scale_bias_act bit-exact to its plain "
        f"version on the step's {BN_LAUNCHES} BN inputs (float32 and "
        f"bfloat16); channel_sum_sumsq's sums within its bars "
        f"({r0['k8_err']:.3e} absolute), the same bits twice")

    # the full-size step against the one-process step
    loss_rel = abs(r0["loss"] - ref_loss) / abs(ref_loss)
    errs, l2 = grad_errors(r0["grads"], ref_grads)
    log(f"dp1 x sp2 step vs the one-process step at {TRAIN_BATCH} x "
        f"{TRAIN_CROP[0]}x{TRAIN_CROP[1]} (same weights and batch, "
        f"deterministic cuDNN, float32): loss {r0['loss']:.6f} vs "
        f"{ref_loss:.6f} (relative {loss_rel:.3e}, bar {SP_LOSS_RTOL}); "
        f"whole-gradient L2 {l2:.3e} (bar {SP_L2_BAR}); largest "
        f"gradient-leaf max |diff| / max |value| "
        f"{[(n, f'{e:.3e}') for e, n in errs[:6]]}, median leaf "
        f"{errs[len(errs) // 2][0]:.3e} (recorded: the float32 step's own "
        f"noise at this size, see SP_L2_BAR)")
    if not loss_rel <= SP_LOSS_RTOL or not l2 < SP_L2_BAR:
        fail(f"dp1 x sp2 step at {TRAIN_CROP}: loss off by {loss_rel:.3e}, "
             f"whole gradient by {l2:.3e}")

    # timing, memory, exchanges
    for r in (r0, r1):
        med, p90, mean_ms, enq = r["step"]
        log(f"dp1 x sp2 step, rank {r['rank']} ({SP_STEPS} steps back to "
            f"back, both ranks on the one card): median {med:.4f} ms, p90 "
            f"{p90:.4f} ms, mean {mean_ms:.4f} ms, host enqueue {enq:.4f} "
            f"ms; halo exchanges {r['halo'][1]} a step, {r['halo'][0]:.3f} "
            f"ms of host time; all the context's collectives "
            f"{r['collectives_ms']:.3f} ms; peak device memory "
            f"{r['peak_mib']:.1f} MiB")
    log(f"one-process step, deterministic cuDNN (same call, {SP_STEPS} "
        f"steps): median {one_step[0]:.4f} ms, p90 {one_step[1]:.4f} ms")

    # the sp2 whole-image eval against the one-rank eval
    shares = [float((a == b).mean()) for a, b in zip(r0["labels"],
                                                     one_labels)]
    log(f"sp2 whole-image eval at {H}x{W}: labels agree with the one-rank "
        f"Evaluator on {shares} of pixels (bar {SP_AGREE}); "
        f"{r0['eval'][0]:.4f} ms an image on rank 0 (p90 "
        f"{r0['eval'][1]:.4f}), {r1['eval'][0]:.4f} on rank 1; one rank "
        f"{one_eval[0]:.4f} ms (p90 {one_eval[1]:.4f}) in this call")
    if min(shares) < SP_AGREE:
        fail(f"sp2 eval labels agree on {min(shares)} < {SP_AGREE}")

    rows = r0["rows"]
    rows[0]["max_abs_err"], rows[1]["max_abs_err"] = (r0["k8_err"],
                                                      r0["k9_diff"])
    return rows


def focal_operands(head, label):
    """A (B, C, H, W) head as NHWC rows (B*H*W, C) and int32 targets label
    + 1, -1 where the label is 255 (ignored)."""
    x = head.permute(0, 2, 3, 1).reshape(-1, head.shape[1]).contiguous()
    lab = label.reshape(-1)
    return x, torch.where(lab == 255, -1, lab + 1).to(torch.int32)


def focal_rows(dev, x, t, launches):
    """K12 and K13 on the DFN step's last smooth head as ``focal_operands``
    gives it (rows ``x``, targets ``t``): held to their plain versions on
    the card, element by element within 1e-5 of max |value| + 1e-6 and the
    module's loss within 1e-5 relative, on those targets and on a copy
    with background (0) and
    ignored (-1) targets mixed in; timed against their plain versions
    (the eager formula: no one PyTorch call computes this function) and
    their bounds.  Returns the kernels line's two rows."""
    from torchseg_tpu_torch.ops.kernels import focal_loss as FL

    g = torch.Generator(device=dev).manual_seed(7)
    u = torch.rand(t.shape, generator=g, device=dev)
    mixed = torch.where(u < 0.1, 0, torch.where(u < 0.2, -1, t)).to(
        torch.int32)
    dense = torch.randn(x.shape, generator=g, device=dev)

    def close(name, got, ref):
        bar = 1e-5 * float(ref.float().abs().max()) + 1e-6
        err = float((got.float() - ref.float()).abs().max())
        if got.shape != ref.shape or got.dtype != ref.dtype or err > bar:
            fail(f"{name}: {tuple(got.shape)} {got.dtype} vs plain "
                 f"{tuple(ref.shape)} {ref.dtype}, max error {err:.3e} > "
                 f"{bar:.3e}")
        return err

    errs = {"fwd": 0.0, "bwd": 0.0}
    for tag, tt in (("path targets", t), ("with background and ignored",
                                           mixed)):
        pos = float((tt > 0).sum().clamp_min(1))
        xg = x.clone().requires_grad_(True)
        loss = FL.SigmoidFocalLossMulti(xg, tt)
        loss.backward()
        ref_loss = float(FL.sigmoid_focal_loss_multiclass_plain(x, tt)
                         .double().sum()) / pos
        if abs(float(loss.detach()) - ref_loss) > 1e-5 * abs(ref_loss):
            fail(f"SigmoidFocalLossMulti ({tag}): {float(loss.detach())} vs "
                 f"plain {ref_loss}")
        scalar = torch.full((), 1.0 / pos, device=dev).expand_as(x)
        errs["fwd"] = max(errs["fwd"], close(
            f"sigmoid_focal_loss_fwd ({tag})", FL.sigmoid_focal_loss_fwd(
                x, tt), FL.sigmoid_focal_loss_multiclass_plain(x, tt)))
        for gname, gg in (("the sum's stride-0 dloss", scalar),
                          ("a dense dloss", dense)):
            errs["bwd"] = max(errs["bwd"], close(
                f"sigmoid_focal_loss_bwd ({tag}, {gname})",
                FL.sigmoid_focal_loss_bwd(x, tt, gg),
                FL.sigmoid_focal_loss_multiclass_bwd_plain(x, tt, gg)))
        errs["bwd"] = max(errs["bwd"], close(
            f"autograd gradient ({tag})", xg.grad,
            FL.sigmoid_focal_loss_multiclass_bwd_plain(x, tt, scalar)))
        log(f"SigmoidFocalLossMulti on the step's last smooth head "
            f"{tuple(x.shape)} ({tag}, {int(pos)} positive targets): loss "
            f"{float(loss.detach()):.6f}, plain {ref_loss:.6f}")
    log(f"K12 and K13 vs plain on the card: max |kernel - plain| "
        f"{errs['fwd']:.3e} (forward), {errs['bwd']:.3e} (backward), "
        f"bars 1e-5 of max |value| + 1e-6")

    scalar = torch.full((), 1.0 / float((t > 0).sum().clamp_min(1)),
                        device=dev).expand_as(x)
    fwd_in, bwd_in = [(x, t)], [(x, t, scalar)]
    k12 = cuda_ms(FL.sigmoid_focal_loss_fwd, fwd_in, reps=20)
    k12_plain = cuda_ms(FL.sigmoid_focal_loss_multiclass_plain, fwd_in,
                        reps=5)
    k13 = cuda_ms(FL.sigmoid_focal_loss_bwd, bwd_in, reps=20)
    k13_plain = cuda_ms(FL.sigmoid_focal_loss_multiclass_bwd_plain, bwd_in,
                        reps=5)
    k13_dense = cuda_ms(FL.sigmoid_focal_loss_bwd, [(x, t, dense)], reps=20)
    # bytes: each input read once, each output written once (the path's
    # K13 reads the one value of the sum's gradient, a dense dloss would
    # add 4 bytes an element); operations: ~20 (forward) and ~30
    # (backward) float32 operations an element, exp, log and log1p each
    # counted once
    k12_bytes = nbytes(x, t) + 4 * x.numel()
    k13_bytes = nbytes(x, t) + 4 + nbytes(x)
    dense_bytes = nbytes(x, t, dense, x)
    k12_bound = bound(k12_bytes, 20 * x.numel(), "f32")
    k13_bound = bound(k13_bytes, 30 * x.numel(), "f32")
    dense_bound = bound(dense_bytes, 30 * x.numel(), "f32")
    # achieved TB/s: those bytes over the measured time
    log(f"sigmoid_focal_loss_fwd (K12) on {tuple(x.shape)}: kernel "
        f"{k12 * 1000:.2f} us = {k12_bytes / k12 / 1e9:.3f} TB/s, plain "
        f"(eager formula) {k12_plain * 1000:.2f} us; bound "
        f"{k12_bound[0] * 1000:.2f} us ({k12_bound[1]}) = "
        f"{100 * k12_bound[0] / k12:.1f} % of the kernel's time")
    log(f"sigmoid_focal_loss_bwd (K13), the sum's stride-0 dloss as on the "
        f"path: kernel {k13 * 1000:.2f} us = {k13_bytes / k13 / 1e9:.3f} "
        f"TB/s, plain (eager formula) {k13_plain * 1000:.2f} us; bound "
        f"{k13_bound[0] * 1000:.2f} us ({k13_bound[1]}) = "
        f"{100 * k13_bound[0] / k13:.1f} %; dense dloss "
        f"{k13_dense * 1000:.2f} us = {dense_bytes / k13_dense / 1e9:.3f} "
        f"TB/s against a bound of {dense_bound[0] * 1000:.2f} us")
    return [
        {"name": "sigmoid_focal_loss_fwd", "route": "cuda",
         "source": SRC_FOCAL, "replaces": f"{TPU_FOCAL}:38",
         "launches": launches["sigmoid_focal_loss_fwd"],
         "max_abs_err": errs["fwd"], "ms": k12, "plain_ms": k12_plain,
         "bound_ms": k12_bound[0], "bound_by": k12_bound[1],
         "library_ms": None},
        {"name": "sigmoid_focal_loss_bwd", "route": "cuda",
         "source": SRC_FOCAL, "replaces": f"{TPU_FOCAL}:54",
         "launches": launches["sigmoid_focal_loss_bwd"],
         "max_abs_err": errs["bwd"], "ms": k13, "plain_ms": k13_plain,
         "bound_ms": k13_bound[0], "bound_by": k13_bound[1],
         "library_ms": None},
    ]


def dfn_phase(dev, all_kernels, reset_all):
    """The DFN path (see the module docstring, item 11); returns the
    kernels line's rows: K8 and K9 at DFN's step, K12 and K13."""
    from torchseg_tpu_torch.entry import DFN_EXPERIMENT, dryrun, train_entry
    from torchseg_tpu_torch.ops.kernels import focal_loss as FL
    from torchseg_tpu_torch.ops.norm import BatchNorm2d

    phase_t0 = time.perf_counter()
    # -- the step on the card; launches over exactly one step -------------
    t0 = time.perf_counter()
    trainer, (_, data) = train_entry(DFN_EXPERIMENT, device=dev,
                                     crop=DFN_CROP, batch=DFN_BATCH)
    torch.cuda.synchronize()
    model = trainer.model
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    log(f"DFN-R101 training step built (seeded weights, {DFN_BATCH}x"
        f"{DFN_CROP[0]}x{DFN_CROP[1]} synthetic batch with border labels; "
        f"{len(bns)} BNs, {sum(p.numel() for p in model.parameters())} "
        f"parameters): {time.perf_counter() - t0:.2f} s")
    trainer.train_step(data)  # warm-up: cuDNN plans
    torch.cuda.synchronize()
    heads = {}
    hook = (model.smooth_head3,
            lambda mod, args, out: heads.__setitem__("last", out.detach()))
    loss0, got, fed, acts, torch_bn, folds = spied_step(
        trainer, data, all_kernels, reset_all, hooks=[hook])
    check_step_launches("DFN-R101", loss0, got, acts, torch_bn, len(bns),
                        None)
    k8_err, k9_diff = check_bn_kernels("DFN-R101 step", fed, acts, folds)

    # -- K12 / K13 on the step's last smooth head -------------------------
    head = heads["last"]
    if tuple(head.shape) != (DFN_BATCH, 19, *DFN_CROP) or not bool(
            torch.isfinite(head).all()):
        fail(f"DFN last smooth head {tuple(head.shape)}, expected finite "
             f"({DFN_BATCH}, 19, {DFN_CROP[0]}, {DFN_CROP[1]})")
    x, t = focal_operands(head, data["label"])
    reset_all()
    xg = x.clone().requires_grad_(True)
    FL.SigmoidFocalLossMulti(xg, t).backward()
    torch.cuda.synchronize()
    focal = launch_counts(all_kernels)
    want = dict.fromkeys(focal, 0) | {"sigmoid_focal_loss_fwd": 1,
                                      "sigmoid_focal_loss_bwd": 1}
    log(f"launches in one SigmoidFocalLossMulti forward and backward: "
        f"{focal}")
    if focal != want:
        fail(f"focal loss launches {focal}, expected {want}")
    del xg
    rows = focal_rows(dev, x, t, focal)

    # -- one step on the card against the CPU, small crop -----------------
    step_vs_cpu(dev, DFN_EXPERIMENT, DFN_CHECK_CROP, DFN_CHECK_BATCH,
                DFN_CHECK_SEED, as_float32=True)

    # -- 20 steps on the learnable batch ----------------------------------
    t0 = time.perf_counter()
    losses = dryrun(DRYRUN_STEPS, experiment=DFN_EXPERIMENT, device=dev,
                    crop=DFN_CROP, batch=DFN_BATCH, seed=DFN_DRYRUN_SEED)
    log(f"DFN dryrun, {DRYRUN_STEPS} steps at {DFN_BATCH}x{DFN_CROP[0]}x"
        f"{DFN_CROP[1]}, seed {DFN_DRYRUN_SEED} "
        f"({time.perf_counter() - t0:.1f} s): loss "
        f"{np.mean(losses[:3]):.4f} (first 3) -> {np.mean(losses[-3:]):.4f}"
        f" (last 3); {[round(v, 4) for v in losses]}")

    # -- timings ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    med, p90, mean_ms, enq = step_ms(trainer, data, DFN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"DFN-R101 training step ({DFN_STEPS} steps back to back): median "
        f"{med:.4f} ms, p90 {p90:.4f} ms, mean {mean_ms:.4f} ms = "
        f"{1000.0 * DFN_BATCH / mean_ms:.2f} images/s; host enqueue "
        f"{enq:.4f} ms per step; peak device memory {peak:.1f} MiB")
    bn_rows = bn_kernel_rows("DFN-R101 step", dev, fed, acts, folds, got)
    bn_rows[0]["max_abs_err"], bn_rows[1]["max_abs_err"] = k8_err, k9_diff
    for r in bn_rows:
        r["name"] += ":dfn_r101"
    profile_steps("DFN-R101 step", trainer, data, DFN_PROFILED_STEPS,
                  BN_KERNEL_NAMES)
    log(f"DFN phase: {time.perf_counter() - phase_t0:.1f} s")
    return bn_rows + rows


# -- the training CLI (train.py) on PNG trees written here --------------------

CLI_CITY_HW, CLI_ADE_HW, CLI_IMAGES = (1024, 2048), (512, 683), 4
CLI_WORKERS = 4
CLI_R18_EPOCHS, CLI_R18_ITERS = 2, 3   # then one more epoch, resumed
CLI_PSP_ITERS, CLI_DFN_ITERS = 3, 2
CLI_CROPS = {"ade.psanet.R50_v1c": (480, 480),
             "voc.fcn32s.R101_v1c": (512, 512)}
# the card-vs-CPU step of PSANet and FCN (dropout off): R50/R101 float32
# steps from random weights are far from float64 at any small size (DFN's
# note above), so the card is held to the CPU float32 step's own distance
CLI_CHECK_CROP, CLI_CHECK_BATCH, CLI_CHECK_SEED = (64, 64), 2, 0
CLI_TIMED_STEPS = 4  # after two warm-up steps
CLI_PROFILED_STEPS = 2


def write_png(path, img):
    """An 8-bit grey (H, W) or RGB (H, W, 3) PNG, every row of filter type
    0, zlib level 1 (no image library needed)."""
    import struct
    import zlib

    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * channels)], axis=1)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             0 if channels == 1 else 2,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + chunk(b"IEND", b""))


def write_trees(root):
    """Seeded PNG trees: CLI_IMAGES Cityscapes-shaped RGB images with train-
    id labels {0, 1} = (the image's smooth field, channel 0, > 0), as
    ``entry.synthetic_batch`` labels its batch, and CLI_IMAGES ADE-shaped
    images with labels 0-150 (0 unlabeled), a function of the image too;
    returns the two datasets' settings."""
    from torchseg_tpu_torch.entry import smooth_field

    rng = np.random.default_rng(0)
    out = {}
    for name, hw in (("city", CLI_CITY_HW), ("ade", CLI_ADE_HW)):
        img_dir = os.path.join(root, name, "images")
        gt_dir = os.path.join(root, name, "labels")
        os.makedirs(img_dir)
        os.makedirs(gt_dir)
        lines = []
        for i in range(CLI_IMAGES):
            grid = rng.normal(size=(1, 3, hw[0] // 32, hw[1] // 32))
            field = smooth_field(grid, hw)[0]
            img = np.clip(128 + 60 * field, 0, 255).astype(np.uint8)
            if name == "city":
                gt = (field[0] > 0).astype(np.uint8)
            else:
                gt = np.clip(75 + 40 * field[0], 1, 150).astype(np.uint8)
                gt[field[1] > 1.5] = 0
            fname = f"{name}_{i:02d}.png"
            write_png(os.path.join(img_dir, fname), img.transpose(1, 2, 0))
            write_png(os.path.join(gt_dir, fname), gt)
            lines.append(fname if name == "ade" else f"{fname}\t{fname}")
        manifest = os.path.join(root, name, "train.txt")
        with open(manifest, "w") as f:
            f.write("\n".join(lines) + "\n")
        out[name] = ["--img-root", img_dir, "--gt-root", gt_dir,
                     "--train-source", manifest]
    return out


def cli_run(tag, argv, n_steps, window, all_kernels, reset_all, n_bn,
            check=None):
    """``train.main(argv)`` on the card: each step's K8 and K9 launches (the
    counts set to 0 before the run and after each step) must be ``n_bn``
    each and every loss finite; ``check(info)`` on every step.  Logs the
    median step (CUDA events between consecutive steps, the first step
    left out), the host time a step waited for its batch, the card's idle
    share over steps ``window`` (1-based, inclusive; torch.profiler) and
    the peak memory.  Returns (the final state, the steps' losses, their
    lrs, their (epoch, it))."""
    from torch.profiler import ProfilerActivity, profile

    from torchseg_tpu_torch import train

    rec = {"loss": [], "lr": [], "at": [], "wait": [], "events": [],
           "launches": []}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock = {}

    def on_step(info):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        rec["events"].append(ev)
        rec["launches"].append(launch_counts(all_kernels))
        reset_all()
        rec["loss"].append(info["loss"].detach())
        rec["lr"].append(info["lr"])
        rec["at"].append((info["epoch"], info["it"]))
        rec["wait"].append(info["wait_s"])
        if check is not None:
            check(info)
        k = len(rec["loss"])
        if k == window[0] - 1:
            torch.cuda.synchronize()
            prof.__enter__()
            clock["t0"] = time.perf_counter()
        elif k == window[1]:
            torch.cuda.synchronize()
            clock["wall"] = time.perf_counter() - clock["t0"]
            prof.__exit__(None, None, None)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all()
    t0 = time.perf_counter()
    state = train.main(argv + ["--device", "cuda"], on_step=on_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = [float(v) for v in rec["loss"]]
    if len(losses) != n_steps:
        fail(f"{tag}: {len(losses)} steps, expected {n_steps}")
    if not all(np.isfinite(losses)):
        fail(f"{tag}: non-finite losses {losses}")
    want = {"channel_sum_sumsq": n_bn, "fused_scale_bias_act": n_bn}
    for i, got in enumerate(rec["launches"]):
        ran = {k: v for k, v in got.items() if v}
        if ran != want:
            fail(f"{tag}: step {i} launched {ran}, expected {want}")
    steps = [a.elapsed_time(b) for a, b in zip(rec["events"],
                                                rec["events"][1:])]
    kernels = device_kernels(prof)
    n_window = window[1] - window[0] + 1
    busy = sum(e.self_device_time_total for e in kernels) / 1000.0
    wall = clock["wall"] * 1000.0
    log(f"{tag}: {n_steps} steps in {seconds:.1f} s (build, loader, steps, "
        f"snapshots); K8 and K9 {n_bn} launches each a step; losses "
        f"{[round(v, 4) for v in losses]}; lrs {rec['lr']}")
    log(f"{tag}: step median {np.median(steps):.2f} ms (CUDA events between "
        f"steps {[round(v, 2) for v in steps]}), host wait for the loader "
        f"{1000.0 * np.mean(rec['wait'][1:]):.2f} ms a step after the "
        f"first ({[round(1000.0 * v, 2) for v in rec['wait']]} ms; an "
        f"epoch's first batch is made after the epoch starts); profiled steps "
        f"{window[0]}-{window[1]}: device busy {busy / n_window:.2f} ms of "
        f"{wall / n_window:.2f} ms wall a step = idle share "
        f"{1 - busy / wall:.3f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return state, losses, rec["lr"], rec["at"]


def bn_count(model):
    from torchseg_tpu_torch.ops.norm import BatchNorm2d

    return sum(isinstance(m, BatchNorm2d) for m in model.modules())


def same_state(tag, a, b):
    """Fails unless two (model, optimizer) states are equal bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    bad = [k for k in sa if not torch.equal(sa[k].cpu(), sb[k].cpu())]
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    if oa["param_groups"] != ob["param_groups"]:
        bad.append("optimizer param_groups")
    bad += [f"momentum {i}" for i in oa["state"] if not torch.equal(
        oa["state"][i]["momentum_buffer"].cpu(),
        ob["state"][i]["momentum_buffer"].cpu())]
    if set(sa) != set(sb) or set(oa["state"]) != set(ob["state"]) or bad:
        fail(f"{tag}: restored state differs from the saved one: {bad[:5]}")


def entry_step_rows(tag, suffix, dev, trainer, data, generator, all_kernels,
                    reset_all):
    """One step of ``trainer`` on ``data``, its dropout drawn from
    ``generator``, with K8 and K9 spied: once per BN of the model each and
    nothing else; K8 and K9 against their plain versions on the step's
    tensors (the train phase's bars); the step timed; returns the kernels
    line's K8 and K9 rows, named ``<kernel>:<suffix>``."""
    stepper = types.SimpleNamespace(
        train_step=lambda d: trainer.train_step(d, generator))
    stepper.train_step(data)  # warm-up: cuDNN plans
    torch.cuda.synchronize()
    loss, got, fed, acts, torch_bn, folds = spied_step(
        stepper, data, all_kernels, reset_all)
    check_step_launches(tag, loss, got, acts, torch_bn,
                        bn_count(trainer.model), None)
    k8_err, k9_diff = check_bn_kernels(tag, fed, acts, folds)
    torch.cuda.reset_peak_memory_stats()
    med, p90, mean_ms, enq = step_ms(stepper, data, CLI_TIMED_STEPS)
    log(f"{tag} ({CLI_TIMED_STEPS} steps back to back, dropout on): median "
        f"{med:.4f} ms, p90 {p90:.4f} ms, mean {mean_ms:.4f} ms; host "
        f"enqueue {enq:.4f} ms a step; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    rows = bn_kernel_rows(tag, dev, fed, acts, folds, got)
    rows[0]["max_abs_err"], rows[1]["max_abs_err"] = k8_err, k9_diff
    for r in rows:
        r["name"] += f":{suffix}"
    profile_steps(tag, stepper, data, CLI_PROFILED_STEPS, BN_KERNEL_NAMES)
    return rows


# -- the evaluation command line (eval.py) on the CLI's trees and snapshots ---

EVAL_SPEED_EXPERIMENT = "cityscapes.bisenet.R18.speed"
# card vs CPU: one small seeded image a protocol, (image hw, crop)
EVAL_SMALL = {"city": ((96, 192), 96), "speed": ((128, 256), 96),
              "ade": ((96, 128), 96)}
EVAL_SMALL_RESIZE_TO = (96, 192)  # the speed protocol's target there
EVAL_AGREE = 0.99
EVAL_SPEED_N, EVAL_SPEED_PASSES = 2, 2  # tools/eval_speed, images a pass


def eval_flags(root, trees, name):
    """The eval CLI's data flags for a tree written by ``write_trees``.
    Cityscapes: a val list whose labels are links named
    ``<name>_gtFine.png``, so that ``--submit``'s rename
    (``Cityscapes.transform_label``: the last ``_`` part dropped) keeps the
    images apart."""
    img_dir, gt_dir, manifest = trees[name][1], trees[name][3], trees[name][5]
    if name == "ade":
        return ["--img-root", img_dir, "--gt-root", gt_dir, "--eval-source",
                manifest]
    named = os.path.join(root, name, "val_labels")
    os.makedirs(named, exist_ok=True)
    lines = []
    for fname in sorted(os.listdir(gt_dir)):
        stem = fname[:-len(".png")]
        link = os.path.join(named, f"{stem}_gtFine.png")
        if not os.path.lexists(link):
            os.symlink(os.path.join(gt_dir, fname), link)
        lines.append(f"{fname}\t{stem}_gtFine.png")
    val = os.path.join(root, name, "val.txt")
    with open(val, "w") as f:
        f.write("\n".join(lines) + "\n")
    return ["--img-root", img_dir, "--gt-root", named, "--eval-source", val]


def eval_cli(tag, argv):
    """``eval.main(argv)`` on the card; returns [(epoch, mIoU)], each
    finite, and logs the seconds it took."""
    from torchseg_tpu_torch import eval as teval

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = teval.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not got or not all(np.isfinite(m) for _, m in got):
        fail(f"{tag}: eval.main gave {got}")
    log(f"{tag}: eval.main {seconds:.2f} s; (epoch, mIoU) "
        f"{[(e, round(float(m), 6)) for e, m in got]}")
    return got


def eval_logs(tag, log_dir, n_epochs):
    """The newest ``val_*.log`` holds ``n_epochs`` tables (a multiple: two
    runs in one second share a log) and ``val_last.log`` links to it."""
    link = os.path.join(log_dir, "val_last.log")
    logs = sorted(f for f in os.listdir(log_dir)
                  if f.startswith("val_2") and f.endswith(".log"))
    if not os.path.islink(link) or os.readlink(link) != logs[-1]:
        fail(f"{tag}: val_last.log does not link to the newest of {logs}")
    with open(os.path.join(log_dir, logs[-1])) as f:
        text = f.read()
    n = text.count("== epoch ")
    if not n or n % n_epochs or "mean_IU" not in text:
        fail(f"{tag}: {logs[-1]} holds {n} tables, expected {n_epochs}")


def check_dumps(tag, pred_dir, submit_dir, n, hw, num_classes):
    """The ``-p`` and ``--submit`` PNGs, read back by the port's decoder:
    ``n`` of each, of the label map's shape, the predictions in the train
    ids and the submissions in Cityscapes' label ids."""
    from torchseg_tpu_torch.data import image_io
    from torchseg_tpu_torch.data.cityscapes import Cityscapes

    for d, allowed in ((pred_dir, set(range(num_classes))),
                       (submit_dir, set(Cityscapes.trans_labels))):
        files = sorted(os.listdir(d))
        if len(files) != n:
            fail(f"{tag}: {len(files)} PNGs in {d}, expected {n}")
        for f in files:
            a = image_io.imread(os.path.join(d, f), image_io.GRAYSCALE)
            seen = set(np.unique(a).tolist())
            if a.shape != tuple(hw) or not seen <= allowed:
                fail(f"{tag}: {f} is {a.shape} with values {sorted(seen)}")


def eval_small_image(name, seed):
    """A seeded smooth uint8 image of ``EVAL_SMALL[name]`` (as
    ``write_trees`` draws them)."""
    from torchseg_tpu_torch.entry import smooth_field

    hw = EVAL_SMALL[name][0]
    grid = np.random.default_rng(seed).normal(size=(1, 3, hw[0] // 16,
                                                    hw[1] // 16))
    field = smooth_field(grid, hw)[0]
    return np.clip(128 + 60 * field, 0, 255).astype(np.uint8).transpose(
        1, 2, 0).copy()


def eval_card_vs_cpu(tag, dev, cfg, model, name, msf, seed):
    """The protocol of ``cfg`` (crop ``EVAL_SMALL``) on one small seeded
    image with the same weights on the card and on the CPU: labels agree
    on >= EVAL_AGREE of the pixels."""
    from torchseg_tpu_torch import native
    from torchseg_tpu_torch.eval import make_evaluator

    crop = EVAL_SMALL[name][1]
    over = dict(eval_crop_size=crop, eval_base_size=crop)
    if cfg.eval_resize_to is not None:
        over["eval_resize_to"] = EVAL_SMALL_RESIZE_TO
    cfg = dataclasses.replace(cfg, **over)
    img = eval_small_image(name, seed)
    preds = []
    for device, m in ((dev, model), (torch.device("cpu"),
                                     copy.deepcopy(model).cpu())):
        ev = make_evaluator(cfg, m, msf=msf, device=device)
        if cfg.eval_mode == "whole":
            h, w = cfg.eval_resize_to
            k = cfg.eval_gt_down_sampling
            pred = ev.whole_eval(native.resize_linear_cv(img, (w, h)),
                                 output_size=(h // k, w // k))
        else:
            pred = ev.sliding_eval(img)
        preds.append(pred.cpu())
    agree = float((preds[0] == preds[1]).float().mean())
    log(f"{tag} at {img.shape[0]}x{img.shape[1]}, crop {crop}: card labels "
        f"{tuple(preds[0].shape)} agree with the CPU's on {agree:.6f} of "
        f"pixels (bar {EVAL_AGREE})")
    if agree < EVAL_AGREE:
        fail(f"{tag}: card vs CPU label agreement {agree} < {EVAL_AGREE}")


def eval_speed_run(tag, argv):
    """``tools/eval_speed.main`` on the card: ms an image, the device time
    an image (profiler), the idle share, the top kernels and peak memory
    (printed by the tool)."""
    from torchseg_tpu_torch.tools import eval_speed

    log(f"{tag}: tools/eval_speed {' '.join(argv)}")
    out = eval_speed.main(argv + ["--n", str(EVAL_SPEED_N), "--passes",
                                  str(EVAL_SPEED_PASSES), "--device-time"])
    if not (out["ms_per_img"] > 0 and out.get("device_ms_per_img", 0) > 0):
        fail(f"{tag}: eval_speed gave {out}")
    torch.cuda.empty_cache()
    return out


def eval_city_phase(dev, root, trees, log_dir, snap):
    """The evaluation phase's Cityscapes half (module docstring, item 16,
    (a), (b) and their part of (d)) on the BiSeNet-R18 CLI's snapshots."""
    from torchseg_tpu_torch import train
    from torchseg_tpu_torch.engine.checkpoint import restore_checkpoint
    from torchseg_tpu_torch.engine.trainer import TrainState
    from torchseg_tpu_torch.entry import TRAIN_EXPERIMENT
    from torchseg_tpu_torch.eval import make_evaluator
    from torchseg_tpu_torch.experiments.registry import (
        DATASETS,
        build_model,
        get_experiment,
    )

    t0 = time.perf_counter()
    flags = eval_flags(root, trees, "city")
    epochs = sorted(int(f[len("epoch-"):-len(".ckpt")])
                    for f in os.listdir(snap) if f[len("epoch-"):-len(
                        ".ckpt")].isdigit())

    # (a) the main path's protocol: R18.speed whole at resize_to, labels /8
    speed_cfg = get_experiment(EVAL_SPEED_EXPERIMENT)
    train.main(["-e", EVAL_SPEED_EXPERIMENT, "--synthetic", "--epochs", "1",
                "--iters", "1", "--batch-size", "2", "--num-workers", "1",
                "--log-dir", log_dir, "--device", "cuda"])
    speed_snap = os.path.join(log_dir, EVAL_SPEED_EXPERIMENT, "snapshot")
    eval_cli("R18.speed whole (resize_to 768x1536, labels /8)",
             ["-e", EVAL_SPEED_EXPERIMENT, *flags, "--snapshot-dir",
              speed_snap, "--log-dir", log_dir])
    eval_logs("R18.speed", os.path.join(log_dir, EVAL_SPEED_EXPERIMENT), 1)
    state = TrainState(model=build_model(speed_cfg).to(dev), optimizer=None)
    restore_checkpoint(os.path.join(speed_snap, "epoch-last.ckpt"), state)
    eval_card_vs_cpu("R18.speed whole", dev, speed_cfg, state.model,
                     "speed", False, 11)

    # (b) BiSeNet-R18's sliding protocol over the snapshot sweep
    cfg = get_experiment(TRAIN_EXPERIMENT)
    exp_log = os.path.join(log_dir, TRAIN_EXPERIMENT)
    pred_dir, submit_dir = (os.path.join(root, "eval_pred"),
                            os.path.join(root, "eval_submit"))
    sweep = ["-e", TRAIN_EXPERIMENT, *flags, "--snapshot-dir", snap,
             "--log-dir", log_dir, "--epochs", "0-", "-p", pred_dir,
             "--submit", submit_dir]
    got = eval_cli(f"R18 sliding (crop 1024, 3 crops) over epochs {epochs}",
                   sweep)
    if [e for e, _ in got] != epochs:
        fail(f"R18 sweep scored epochs {[e for e, _ in got]}, not {epochs}")
    eval_logs("R18 sliding", exp_log, len(epochs))
    check_dumps("R18 sliding", pred_dir, submit_dir, CLI_IMAGES,
                CLI_CITY_HW, cfg.num_classes)
    # each epoch's mIoU is that epoch's own checkpoint evaluated alone
    ds = DATASETS[cfg.dataset](
        {"img_root": flags[1], "gt_root": flags[3],
         "train_source": flags[5], "eval_source": flags[5]}, "val")
    hists = []
    for (epoch, miou) in got:
        alone = TrainState(model=build_model(cfg).to(dev), optimizer=None)
        restore_checkpoint(os.path.join(snap, f"epoch-{epoch}.ckpt"), alone)
        acc = make_evaluator(cfg, alone.model, device=dev).run_dataset(
            ds, mode=cfg.eval_mode)
        hists.append(acc.hist.cpu())
        if acc.scores()[1] != miou:
            fail(f"R18 sweep: epoch {epoch} logged mIoU {miou}, its "
                 f"checkpoint alone {acc.scores()[1]} (stale weights?)")
    differ = [i for i in range(1, len(hists))
              if not torch.equal(hists[i], hists[0])]
    log(f"R18 sweep: every epoch's mIoU equals its checkpoint evaluated "
        f"alone; epochs {[epochs[i] for i in differ]} give a histogram other "
        f"than epoch {epochs[0]}'s")
    if not differ:
        img = ds[0]["image"]
        scores = []
        for epoch in epochs:
            alone = TrainState(model=build_model(cfg).to(dev), optimizer=None)
            restore_checkpoint(os.path.join(snap, f"epoch-{epoch}.ckpt"),
                               alone)
            scores.append(make_evaluator(cfg, alone.model, device=dev)
                          .scale_process(img, img.shape[:2],
                                         cfg.eval_crop_size,
                                         cfg.eval_stride_rate))
        if all(np.array_equal(scores[0], s) for s in scores[1:]):
            fail("R18 sweep: every epoch gives the same scores; the "
                 "stale-weights check shows nothing")
    got_msf = eval_cli("R18 sliding msf (6 scales + flip, 28 crops, 56 "
                       "forwards an image)", sweep + ["--msf"])
    if [e for e, _ in got_msf] != epochs:
        fail(f"R18 msf sweep scored epochs {[e for e, _ in got_msf]}")
    eval_logs("R18 msf", exp_log, len(epochs))
    check_dumps("R18 msf", pred_dir, submit_dir, CLI_IMAGES, CLI_CITY_HW,
                cfg.num_classes)
    model = TrainState(model=build_model(cfg).to(dev), optimizer=None)
    restore_checkpoint(os.path.join(snap, "epoch-last.ckpt"), model)
    for msf in (False, True):
        eval_card_vs_cpu(f"R18 sliding{' msf' if msf else ''}", dev, cfg,
                         model.model, "city", msf, 12)
    del state, model
    torch.cuda.empty_cache()

    # (d) the timings, at the full sizes
    eval_speed_run("R18.speed whole", ["-e", EVAL_SPEED_EXPERIMENT])
    eval_speed_run("R18 sliding", ["-e", TRAIN_EXPERIMENT])
    eval_speed_run("R18 sliding msf", ["-e", TRAIN_EXPERIMENT, "--msf"])
    if "cv2" in sys.modules:
        fail("the evaluation phase imported cv2")
    log(f"evaluation phase, Cityscapes half: "
        f"{time.perf_counter() - t0:.1f} s")


def eval_ade_phase(dev, root, trees, log_dir, snap):
    """The evaluation phase's ADE half (module docstring, item 16, (c) and
    its part of (d)) on the PSPNet-R50 CLI's snapshot."""
    from torchseg_tpu_torch.engine.checkpoint import restore_checkpoint
    from torchseg_tpu_torch.engine.trainer import TrainState
    from torchseg_tpu_torch.entry import PSP_EXPERIMENT
    from torchseg_tpu_torch.experiments.registry import (
        build_model,
        get_experiment,
    )

    t0 = time.perf_counter()
    cfg = get_experiment(PSP_EXPERIMENT)
    argv = ["-e", PSP_EXPERIMENT, *eval_flags(root, trees, "ade"),
            "--snapshot-dir", snap, "--log-dir", log_dir]
    eval_cli("PSPNet-R50 ADE sliding (crop 480, label_offset -1)", argv)
    eval_cli("PSPNet-R50 ADE sliding msf (5 scales + flip)",
             argv + ["--msf"])
    eval_logs("PSPNet-R50", os.path.join(log_dir, PSP_EXPERIMENT), 1)
    state = TrainState(model=build_model(cfg).to(dev), optimizer=None)
    restore_checkpoint(os.path.join(snap, "epoch-last.ckpt"), state)
    for msf in (False, True):
        eval_card_vs_cpu(f"PSPNet-R50 sliding{' msf' if msf else ''}", dev,
                         cfg, state.model, "ade", msf, 13)
    del state
    torch.cuda.empty_cache()
    size = f"{CLI_ADE_HW[0]}x{CLI_ADE_HW[1]}"
    eval_speed_run("PSPNet-R50 sliding", ["-e", PSP_EXPERIMENT, "--size",
                                          size])
    eval_speed_run("PSPNet-R50 sliding msf", ["-e", PSP_EXPERIMENT, "--msf",
                                              "--size", size])
    if "cv2" in sys.modules:
        fail("the evaluation phase imported cv2")
    log(f"evaluation phase, ADE half: {time.perf_counter() - t0:.1f} s")


def cli_phase(dev, all_kernels, reset_all):
    """The training CLI (see the module docstring, item 15); returns the
    kernels line's K8 and K9 rows at the PSPNet, PSANet and FCN steps."""
    import shutil
    import tempfile

    from torchseg_tpu_torch.engine.checkpoint import (
        LAST_LINK,
        restore_checkpoint,
    )
    from torchseg_tpu_torch.engine.lr_policy import PolyLR
    from torchseg_tpu_torch.entry import (
        DFN_EXPERIMENT,
        FCN_EXPERIMENT,
        PSANET_EXPERIMENT,
        PSP_EXPERIMENT,
        TRAIN_EXPERIMENT,
        train_entry,
    )
    from torchseg_tpu_torch.experiments.registry import (
        build_model,
        get_experiment,
    )
    from torchseg_tpu_torch.ops.dropout import make_generator

    phase_t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    log(f"training CLI phase on {smi.stdout.strip()}")
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    rows = []
    try:
        t0 = time.perf_counter()
        trees = write_trees(root)
        log(f"PNG trees written ({CLI_IMAGES} Cityscapes-shaped "
            f"{CLI_CITY_HW[0]}x{CLI_CITY_HW[1]}, {CLI_IMAGES} ADE-shaped "
            f"{CLI_ADE_HW[0]}x{CLI_ADE_HW[1]}): "
            f"{time.perf_counter() - t0:.2f} s")
        log_dir = os.path.join(root, "log")
        common = ["--batch-size", "2", "--num-workers", str(CLI_WORKERS),
                  "--log-dir", log_dir]

        # -- BiSeNet-R18: two epochs, the snapshot restored, a third -------
        cfg = get_experiment(TRAIN_EXPERIMENT)
        base = ["-e", TRAIN_EXPERIMENT, *trees["city"], *common, "--iters",
                str(CLI_R18_ITERS)]
        n_steps = CLI_R18_EPOCHS * CLI_R18_ITERS
        state, _, _, _ = cli_run(
            "BiSeNet-R18 CLI", base + ["--epochs", str(CLI_R18_EPOCHS)],
            n_steps, (CLI_R18_ITERS + 2, n_steps), all_kernels, reset_all,
            BN_LAUNCHES)
        snap = os.path.join(log_dir, TRAIN_EXPERIMENT, "snapshot")
        other, _ = train_entry(TRAIN_EXPERIMENT, device=dev, crop=(
            cfg.image_height, cfg.image_width), batch=2, seed=1)
        restored, epoch, _ = restore_checkpoint(
            os.path.join(snap, LAST_LINK), other.state)
        if epoch != CLI_R18_EPOCHS - 1 or restored.step != n_steps:
            fail(f"epoch-last.ckpt holds epoch {epoch}, step "
                 f"{restored.step}; expected {CLI_R18_EPOCHS - 1}, {n_steps}")
        same_state("BiSeNet-R18 CLI snapshot", state, restored)
        log("BiSeNet-R18 CLI: the restored model and optimizer state equal "
            "the saved ones bit for bit")
        del state, other, restored
        n_total = (CLI_R18_EPOCHS + 1) * CLI_R18_ITERS
        _, _, lrs, at = cli_run(
            "BiSeNet-R18 CLI resumed", base + [
                "--epochs", str(CLI_R18_EPOCHS + 1), "-c",
                os.path.join(snap, LAST_LINK)],
            CLI_R18_ITERS, (2, CLI_R18_ITERS), all_kernels, reset_all,
            BN_LAUNCHES)
        want_lr = PolyLR(cfg.lr, cfg.lr_power, n_total)(n_steps)
        if at[0] != (CLI_R18_EPOCHS, 0) or lrs[0] != want_lr:
            fail(f"the resumed run started at (epoch, it) {at[0]} with lr "
                 f"{lrs[0]}; expected ({CLI_R18_EPOCHS}, 0), PolyLR at step "
                 f"{n_steps}: {want_lr}")
        files = sorted(os.listdir(snap))
        want = sorted([f"epoch-{e}.ckpt" for e in range(
            CLI_R18_EPOCHS + 1)] + [LAST_LINK])
        if files != want or os.readlink(os.path.join(snap, LAST_LINK)) != (
                f"epoch-{CLI_R18_EPOCHS}.ckpt"):
            fail(f"snapshots {files}, expected {want} with the link on the "
                 f"last")
        log(f"BiSeNet-R18 CLI resumed at epoch {CLI_R18_EPOCHS} with lr "
            f"{lrs[0]} (PolyLR at step {n_steps}); snapshots {files}")
        eval_city_phase(dev, root, trees, log_dir, snap)
        shutil.rmtree(os.path.join(log_dir, TRAIN_EXPERIMENT))

        # -- PSPNet-R50 at 480x480; its dropout generator on the card ------
        psp_cfg = get_experiment(PSP_EXPERIMENT)
        psp_bns = bn_count(build_model(psp_cfg))
        state, _, _, _ = cli_run(
            "PSPNet-R50 CLI", ["-e", PSP_EXPERIMENT, *trees["ade"], *common,
                               "--epochs", "1", "--iters",
                               str(CLI_PSP_ITERS)],
            CLI_PSP_ITERS, (2, CLI_PSP_ITERS), all_kernels, reset_all,
            psp_bns)
        del state
        psp_snap = os.path.join(log_dir, PSP_EXPERIMENT, "snapshot",
                                LAST_LINK)
        trainer, (_, data) = train_entry(
            PSP_EXPERIMENT, device=dev, crop=(psp_cfg.image_height,
                                              psp_cfg.image_width),
            batch=2, deterministic=True)

        def step_from_snapshot(seed):
            restore_checkpoint(psp_snap, trainer.state)
            loss, _ = trainer.train_step(data, make_generator(seed, dev))
            return loss.detach().clone()

        same_a, same_b, other_c = (step_from_snapshot(1),
                                   step_from_snapshot(1),
                                   step_from_snapshot(2))
        log(f"PSPNet-R50 step from the CLI's snapshot, deterministic cuDNN: "
            f"loss {float(same_a)!r} and {float(same_b)!r} with generator "
            f"seed 1 twice, {float(other_c)!r} with seed 2")
        if not torch.equal(same_a, same_b):
            fail("PSPNet-R50: one step from one state with equal generator "
                 "seeds gave different losses")
        if torch.equal(same_a, other_c):
            fail("PSPNet-R50: generator seeds 1 and 2 gave the same loss: "
                 "the generator does not drive the dropout masks")
        trainer.deterministic = False
        rows += entry_step_rows("PSPNet-R50 step", "pspnet_r50", dev,
                                trainer, data, make_generator(3, dev),
                                all_kernels, reset_all)
        del trainer, data
        torch.cuda.empty_cache()
        eval_ade_phase(dev, root, trees, log_dir,
                       os.path.dirname(psp_snap))
        shutil.rmtree(os.path.join(log_dir, PSP_EXPERIMENT))
        torch.cuda.empty_cache()

        # -- PSANet-R50 and FCN-32s-R101 through train_entry ---------------
        for exp, suffix, tag in ((PSANET_EXPERIMENT, "psanet_r50",
                                  "PSANet-R50"),
                                 (FCN_EXPERIMENT, "fcn32s_r101",
                                  "FCN-32s-R101")):
            trainer, (_, data) = train_entry(exp, device=dev,
                                             crop=CLI_CROPS[exp], batch=2)
            rows += entry_step_rows(f"{tag} step", suffix, dev, trainer,
                                    data, make_generator(4, dev),
                                    all_kernels, reset_all)
            del trainer, data
            torch.cuda.empty_cache()
            step_vs_cpu(dev, exp, CLI_CHECK_CROP, CLI_CHECK_BATCH,
                        CLI_CHECK_SEED, as_float32=True)

        # -- DFN-R101 at 800x800 through DFNTrainPre -----------------------
        def border_values(info):
            seen = set(torch.unique(info["batch"]["aux_label"]).tolist())
            if not seen <= {0, 1, 255}:
                fail(f"DFN batch aux_label values {sorted(seen)}")

        cli_run("DFN-R101 CLI", ["-e", DFN_EXPERIMENT, *trees["city"],
                                 *common, "--epochs", "1", "--iters",
                                 str(CLI_DFN_ITERS)],
                CLI_DFN_ITERS, (2, CLI_DFN_ITERS), all_kernels, reset_all,
                bn_count(build_model(get_experiment(DFN_EXPERIMENT))),
                check=border_values)
        log("DFN-R101 CLI: every batch's aux_label lies in {0, 1, 255}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if "cv2" in sys.modules:
        fail("the training CLI phase imported cv2")
    log(f"training CLI phase: {time.perf_counter() - phase_t0:.1f} s; cv2 "
        f"was not imported")
    return rows


# ----------------------------------------------------------------------
# the deployment and measurement tools (item 17)
# ----------------------------------------------------------------------

SPEED_EXPERIMENT = "cityscapes.bisenet.R18.speed"
SPEED_SIZE = "1x1024x2048x3"
X39_SIZE = "1x768x1536x3"
TOOLS_CHAIN = ["--chain", "50", "--reps", "2"]  # 103 forwards a route
PTQ_SMALL = (1, 3, 128, 256)  # the generic int8 graph's card-vs-CPU input
REF_SIZE = "1x256x512x3"  # the reference checkpoint's export
REF_BAR = 1e-4  # log-probs, card vs CPU, float32 (the float graphs' bar)
TRAIN_SPEED_ARGS = ["-e", "cityscapes.bisenet.R18", "--crop", "512",
                    "1024", "--batch-size", "2", "--steps", "3", "--reps",
                    "2", "--memory", "--top-ops", "8"]
DCP_CROP = (256, 256)
# the generic int8 graph, card vs CPU at PTQ_SMALL in float32, free runs
# (scripts/torch_ptq_probe.py, seeds 7-11; PERF.md, Findings): the
# farthest a flipped code's value may sit from a rounding midpoint, in code
# units (read: 1.9e-6 to 2.3e-5; a conv missing a tap or scales rounded to
# bf16: 0.2-0.5), and the labels' floor (read: 0.9805-0.9941).  The floor
# only guards gross faults: with those two faults the labels still agree on
# 0.9746-0.9961; the check of each conv on the CPU's inputs finds them
PTQ_TIE = 1e-4
PTQ_F32_FLOOR = 0.97


def speed_run(dev, tag, argv, all_kernels, reset_all, per_forward):
    """``tools.speed.main(argv)`` on the card with every launch counted;
    each kernel's launches must be ``per_forward`` (a dict, or a function
    of the tool's info giving one) times the forwards the tool ran, the
    rest 0.  Returns (its dict, its info)."""
    from torchseg_tpu_torch.tools import speed

    info = {}
    reset_all()
    res = speed.main(argv + ["--device", dev.type], info=info)
    torch.cuda.synchronize()
    got = launch_counts(all_kernels)
    n = info["forwards"]
    if callable(per_forward):
        per_forward = per_forward(info)
    want = dict.fromkeys(got, 0) | {k: v * n for k, v in per_forward.items()}
    if got != want:
        fail(f"speed {tag}: launches {got} over {n} forwards, expected "
             f"{want}")
    log(f"speed {tag}: {res['ms_per_iter']:.4f} ms/iter, {res['fps']:.2f} "
        f"FPS; launches {per_forward} a forward over {n} forwards")
    return res, info


@contextlib.contextmanager
def record_ptq_calls(q):
    """The arguments of every conv_i8_affine call the quantized model
    makes while the context is open."""
    fed, fn = [], q.conv_i8_affine

    def spy(*args):
        fed.append(args)
        return fn(*args)

    q.conv_i8_affine = spy
    try:
        yield fed
    finally:
        q.conv_i8_affine = fn


def ptq_device_ms(dev, fed, gemms, fn, args, K):
    """torch.profiler device ms of: the ``fed`` conv_i8_affine calls (its
    kernel alone), ``torch._int_mm`` of the same im2col GEMMs (``gemms``:
    (m, k, n) each, seeded operands), and one whole ``--int8`` forward
    ``fn(*args)``; returns (conv, int_mm, forward, the forward's
    conv_i8_affine kernels)."""
    from torchseg_tpu_torch.tools.profile import collect_op_times

    def mode3(ops):
        return sum(v for k, v in ops.items() if "conv_i8_mma_kernel<3," in k)

    _, ops = collect_op_times(
        lambda: [K.conv_i8_affine(*c) for c in fed], runs=3)
    conv = mode3(ops)
    if conv <= 0:
        fail(f"the profiler saw no conv_i8_affine kernel: {ops}")
    if sum(ops.values()) > conv:
        log(f"conv_i8_affine's calls also ran {ops}")
    g = torch.Generator(device=dev).manual_seed(0)
    mats = [(torch.randint(-127, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8),
             torch.randint(-127, 128, (n, k), generator=g, device=dev,
                           dtype=torch.int8).t()) for m, k, n in gemms]
    mm, _ = collect_op_times(
        lambda: [torch._int_mm(a, b) for a, b in mats], runs=3)
    fwd, ops = collect_op_times(fn, *args, runs=3)
    return conv, mm, fwd, mode3(ops)


def ptq_phase(dev, all_kernels, reset_all, K):
    """``--int8`` on R18.speed: the routes fixed at quantization and
    counted, every tensor-core conv of a forward bit-exact against its
    plain version on its own tensors and timed, the card against the CPU
    plain run on a small input (``ptq_card_vs_cpu``); returns the kernels
    line's row."""
    import torchseg_tpu_torch.deploy.quantize as Q
    from torchseg_tpu_torch.experiments.registry import (
        build_model,
        get_experiment,
    )
    from torchseg_tpu_torch.models import init_weights

    import collections

    res, info = speed_run(dev, "--int8", [
        "-e", SPEED_EXPERIMENT, "--input-size", SPEED_SIZE, "--int8",
        *TOOLS_CHAIN], all_kernels, reset_all, lambda info: {
            "conv_i8_affine": Q.route_counts(info["routes"])["mma"]})
    counts = Q.route_counts(info["routes"])
    n_mma = counts["mma"]
    fn, args = info["fn"], info["args"]
    calls, forward = collections.Counter(), Q.QuantConv2d.forward

    def counted(self, x):
        calls[self.route] += 1
        return forward(self, x)

    reset_all()
    Q.QuantConv2d.forward = counted
    try:
        with record_ptq_calls(Q) as fed:
            fn(*args)
    finally:
        Q.QuantConv2d.forward = forward
    torch.cuda.synchronize()
    launches = launch_counts(all_kernels)["conv_i8_affine"]
    log(f"generic int8 R18.speed: the {len(info['routes'])} quantized convs "
        f"by route when the model was quantized {counts}; one forward's "
        f"calls by route {dict(calls)}; conv_i8_affine launches {launches}")
    if {r: calls.get(r, 0) for r in counts} != counts or \
            launches != n_mma or len(fed) != n_mma:
        fail("one --int8 forward's convs by route differ from the routes "
             "fixed when the model was quantized")
    for call in fed:
        got, ref = K.conv_i8_affine(*call), K.conv_i8_affine_plain(*call)
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            fail(f"conv_i8_affine {tuple(call[1].shape)} differs from its "
                 f"plain version on {int((got != ref).sum())} elements")
    log(f"conv_i8_affine: bit-exact to its plain version on all {len(fed)} "
        f"calls of one --int8 forward")
    ms = cuda_ms(lambda: [K.conv_i8_affine(*c) for c in fed], [()], reps=5)
    plain_ms = cuda_ms(lambda: [K.conv_i8_affine_plain(*c) for c in fed],
                       [()])
    n_bytes = ops = 0
    lib_ms = 0.0
    gemms = []
    for call in fed:
        x, w = call[:2]
        out = K.conv_i8_affine(*call)
        k, cin, cout = w.shape[0], w.shape[2], w.shape[3]
        m = out.shape[1] * out.shape[2]
        n_bytes += nbytes(list(call[:4]), out)
        ops += 2 * m * k * k * cin * cout
        gemms.append((max(m, 17), k * k * cin, cout))
        lib_ms += int_mm_ms(dev, *gemms[-1])
    b_ms, b_by = bound(n_bytes, ops, "int8")
    log(f"conv_i8_affine, the {len(fed)} convs of a forward: kernel "
        f"{ms:.4f} ms (wrapper included) = {ops / ms / 1e9:.1f} TOP/s, "
        f"plain {plain_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}: "
        f"{n_bytes / 1e6:.2f} MB, {ops / 1e9:.2f} G int8 operations) = "
        f"{100 * b_ms / ms:.2f} %; torch._int_mm of the same GEMMs "
        f"{lib_ms:.4f} ms; the forward {res['ms_per_iter']:.4f} ms")
    dev_ms, mm_dev, fwd_dev, fwd_conv = ptq_device_ms(dev, fed, gemms, fn,
                                                      args, K)
    log(f"conv_i8_affine device time (profiler): the {len(fed)} launches "
        f"{dev_ms:.4f} ms = {ops / dev_ms / 1e9:.1f} TOP/s, "
        f"{100 * b_ms / dev_ms:.2f} % of its bound; torch._int_mm of the "
        f"same GEMMs {mm_dev:.4f} ms; one --int8 forward's kernels "
        f"{fwd_dev:.4f} ms, of which conv_i8_affine {fwd_conv:.4f} ms")
    row = {"name": "conv_i8_affine:r18_speed_ptq", "route": "cuda",
           "source": SRC, "replaces": "torchseg_tpu/deploy/quantize.py:100 "
           "(XLA, no TPU kernel)", "launches": launches,
           "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}

    # the card against the CPU plain run on a small input.  The int8 convs
    # give the same values on both (exact sums, one fused multiply-add):
    # each conv run on the card on the CPU run's input of that conv must
    # give the CPU's output bit for bit.  The float glue between them
    # rounds otherwise on the two (the float32 spatial-path stem, a cuDNN
    # conv, is the first module whose output differs on equal inputs), so
    # in free runs a value on a rounding midpoint of a conv's input can
    # take the other code, and the difference grows from that conv on.  In
    # float64 every code and label must be equal; in float32 the first conv
    # whose codes differ must differ only at midpoints (within PTQ_TIE),
    # and the labels must agree on PTQ_F32_FLOOR.
    cfg = get_experiment(SPEED_EXPERIMENT)
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    for dtype in (torch.float64, torch.float32):
        r = ptq_card_vs_cpu(dev, model, 7, dtype)
        log(f"generic int8 R18.speed at {PTQ_SMALL[2]}x{PTQ_SMALL[3]} in "
            f"{dtype}: each of the {r['convs']} convs fed the CPU's input "
            f"gives the CPU's output bit for bit except {r['forced']}; "
            f"free runs: labels equal on {r['share']:.6f} of pixels, the "
            f"first conv whose codes differ {r['flip']}")
        if r["forced"]:
            fail(f"generic int8 in {dtype}: on the CPU's inputs the card's "
                 f"convs {r['forced']} differ from the CPU's")
        flip = r["flip"]
        if dtype == torch.float64 and (r["share"] != 1.0 or flip):
            fail("generic int8 in float64: the card's codes or labels "
                 "differ from the CPU's")
        if flip is not None and flip["tie"] > PTQ_TIE:
            fail(f"generic int8 in {dtype}: a code differs at "
                 f"{flip['tie']} code units from a rounding midpoint (bar "
                 f"{PTQ_TIE})")
        if r["share"] < PTQ_F32_FLOOR:
            fail(f"generic int8 in {dtype}: card vs CPU labels agree on "
                 f"{r['share']} < {PTQ_F32_FLOOR}")
    return row


def ptq_card_vs_cpu(dev, model, seed, dtype, tamper=None):
    """The generic int8 graph of ``model`` (in ``dtype``) calibrated on two
    seeded batches at PTQ_SMALL, run on the card and on the CPU (plain)
    on a third; ``tamper(qmodel)`` edits the card's copy (a control).
    Returns {"share": the label share, "convs": the number of convs,
    "forced": the convs whose card output, fed the CPU run's input of
    that conv, is not the CPU's bit for bit, "flip": None, or the first
    conv in call order whose int8 codes differ in the free runs: {"conv",
    "n", "of", "tie": the largest distance, in code units, of a flipped
    value from a rounding midpoint on either side, "max_rel": the largest
    |card - CPU| of that conv's input over its max |x|}}."""
    import torchseg_tpu_torch.deploy.quantize as Q

    rng = np.random.default_rng(seed)
    calib = [torch.from_numpy(rng.normal(size=PTQ_SMALL)).to(dtype)
             for _ in range(2)]
    x = torch.from_numpy(rng.normal(size=PTQ_SMALL)).to(dtype)
    infer_cpu, _, qcpu, _ = Q.make_int8_infer(
        copy.deepcopy(model).to(dtype).eval(), calib)
    qcard = copy.deepcopy(qcpu).to(dev)
    if tamper is not None:
        tamper(qcard)
    recs = []
    for q, xin in ((qcpu, x), (qcard, x.to(dev))):
        rec, hooks = [], []
        for name, mod in q.named_modules():
            if isinstance(mod, Q.QuantConv2d):
                hooks.append(mod.register_forward_hook(
                    lambda m, a, y, name=name, rec=rec: rec.append(
                        (name, a[0].detach().cpu(), y.detach().cpu()))))
        try:
            with torch.inference_mode():
                y = q(xin).argmax(dim=1).to(torch.int32).cpu()
        finally:
            for h in hooks:
                h.remove()
        recs.append((rec, y))
    (cpu_rec, cpu_y), (card_rec, card_y) = recs
    if not torch.equal(infer_cpu(x), cpu_y):
        fail("the generic int8 graph's serving function differs from its "
             "model on the CPU")
    if [r[0] for r in cpu_rec] != [r[0] for r in card_rec]:
        fail("the card ran other convs than the CPU, or in another order")
    cpu_convs, card_convs = dict(qcpu.named_modules()), \
        dict(qcard.named_modules())
    out = {"share": float((card_y == cpu_y).float().mean()),
           "convs": len(cpu_rec), "forced": [], "flip": None}
    with torch.inference_mode():
        for name, a, y in cpu_rec:
            got = card_convs[name](a.to(dev)).cpu()
            if got.dtype != y.dtype or not torch.equal(got, y):
                out["forced"].append(Q.conv_path(name))
    for (name, a, _), (_, b, _) in zip(cpu_rec, card_rec):
        q = cpu_convs[name]
        diff = q.quantize_input(a) != q.quantize_input(b)
        if diff.any():
            def tie(v):
                v = v.permute(0, 2, 3, 1).float() / q.s_in
                return ((v - v.floor()) - 0.5).abs()[diff]
            out["flip"] = {
                "conv": Q.conv_path(name), "n": int(diff.sum()),
                "of": diff.numel(),
                "tie": float(torch.maximum(tie(a), tie(b)).max()),
                "max_rel": float((a - b).abs().max() / a.abs().max())}
            break
    return out


def export_phase(dev, root, main_infer, main_pkg, all_kernels, reset_all):
    """The int8-through artifact (cuda) loaded in a fresh process that
    imports only the kernel module, against the live main-path graph; the
    bf16 float artifact against its live forward (``--check``)."""
    from torchseg_tpu_torch.deploy import export as E
    from torchseg_tpu_torch.deploy.int8_serve import prepare_s2d_input_u8
    from torchseg_tpu_torch.experiments.registry import get_experiment

    cfg = get_experiment(SPEED_EXPERIMENT)
    art = os.path.join(root, "r18_int8")
    t0 = time.perf_counter()
    E.main(["-e", SPEED_EXPERIMENT, "-o", art, "--int8-through",
            "--platforms", dev.type, "--input-size", SPEED_SIZE, "--check"])
    log(f"export --int8-through --platforms cuda: "
        f"{time.perf_counter() - t0:.1f} s (with --check, exact)")
    with open(os.path.join(art, E.META_FILE)) as f:
        meta = json.load(f)
    ops = sorted({str(n.target) for n in torch.export.load(os.path.join(
        art, E.GRAPH_FILE)).graph.nodes if "torchseg_cuda" in str(n.target)})
    log(f"int8-through artifact: {meta['graph_bytes'] / 1e6:.1f} MB, "
        f"platforms {meta['platforms']}, in {meta['in_avals']}, out "
        f"{meta['out_avals']}; kernel ops {ops}")
    rng = np.random.default_rng(11)
    shape = tuple(int(s) for s in SPEED_SIZE.split("x"))
    imgs = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(2)]
    for i, img in enumerate(imgs):
        np.save(os.path.join(root, f"img{i}.npy"), img)
    code = (
        "import sys, numpy as np, torch\n"
        "from torchseg_tpu_torch.ops.kernels import custom_ops\n"
        "art, root = sys.argv[1], sys.argv[2]\n"
        "main = torch.export.load(art + '/graph.pt2').module()\n"
        "prep = torch.export.load(art + '/prepare.pt2').module()\n"
        "for i in range(2):\n"
        "    img = torch.from_numpy(np.load(f'{root}/img{i}.npy')).to("
        "sys.argv[3])\n"
        "    codes = prep(img)\n"
        "    torch.save({'codes': codes.cpu(), 'labels': main(codes).cpu()},"
        " f'{root}/out{i}.pt')\n"
        "mods = sorted(m for m in sys.modules if m.startswith("
        "'torchseg_tpu_torch'))\n"
        "print('imported', mods)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, art, root,
                           dev.type],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode:
        fail(f"the artifact's fresh process failed: {proc.stderr[-2000:]}")
    log(f"fresh process ({time.perf_counter() - t0:.1f} s): "
        f"{proc.stdout.strip()}")
    if "torchseg_tpu_torch.deploy" in proc.stdout:
        fail("the artifact's process imported the deploy package")
    for i, img in enumerate(imgs):
        out = torch.load(os.path.join(root, f"out{i}.pt"))
        xs = prepare_s2d_input_u8(img, image_mean=cfg.image_mean, device=dev)
        want = main_infer(main_pkg, xs).cpu()
        if not torch.equal(out["codes"], xs.cpu()):
            fail("the artifact's prepare graph's codes differ from the "
                 "host prep's")
        if out["labels"].dtype != want.dtype or not torch.equal(
                out["labels"], want):
            fail(f"the int8-through artifact's labels differ from the live "
                 f"graph's on {int((out['labels'] != want).sum())} pixels")
    log("int8-through artifact, loaded in a fresh process: codes and labels "
        "equal the live main-path graph's bit for bit on 2 images")
    t0 = time.perf_counter()
    E.main(["-e", SPEED_EXPERIMENT, "-o", os.path.join(root, "r18_bf16"),
            "--platforms", dev.type, "--input-size", SPEED_SIZE, "--check"])
    log(f"export bf16 float artifact: {time.perf_counter() - t0:.1f} s; its "
        f"labels equal the live forward's (--check)")


def ref_checkpoint_phase(dev, root):
    """A seeded reference-layout BiSeNet-R18 .pth through eval.py
    --torch-checkpoint and export --torch-checkpoint; the card's log-probs
    against the CPU's from the same file."""
    from torchseg_tpu_torch import eval as teval
    from torchseg_tpu_torch.deploy import export as E
    from torchseg_tpu_torch.experiments.registry import (
        build_model,
        get_experiment,
    )
    from torchseg_tpu_torch.models import init_weights
    from torchseg_tpu_torch.utils.torch_convert import (
        graft_full_checkpoint,
        reference_state_dict,
    )

    exp = "cityscapes.bisenet.R18"
    cfg = get_experiment(exp)
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(5))
    sd = reference_state_dict(model, "bisenet")
    rng = np.random.default_rng(5)
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 2.0, sd[k].shape)
                                     .astype(np.float32))
        elif k.endswith("running_mean"):
            sd[k] = torch.from_numpy(rng.normal(0, 0.1, sd[k].shape)
                                     .astype(np.float32))
    path = os.path.join(root, "bisenet_r18.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    common = ["-e", exp, "--torch-checkpoint", path, "--synthetic", "1",
              "--eval-crop", "256", "--eval-base", "256", "--log-dir",
              os.path.join(root, "log")]
    card = teval.main(common + ["--device", dev.type])
    cpu = teval.main(common + ["--device", "cpu"])
    log(f"eval.py --torch-checkpoint: mIoU on the card {card}, on the CPU "
        f"{cpu}")
    if card[0][0] != "torch" or abs(card[0][1] - cpu[0][1]) > 1e-3:
        fail(f"eval --torch-checkpoint: card {card} vs CPU {cpu}")
    art = os.path.join(root, "r18_ref")
    E.main(["-e", exp, "-o", art, "--torch-checkpoint", path, "--platforms",
            dev.type, "--f32", "--scores", "--input-size", REF_SIZE,
            "--check"])
    infer, _ = E.load_artifact(art, dev.type)
    img = rng.integers(0, 256, tuple(int(s) for s in REF_SIZE.split("x")),
                       dtype=np.uint8)
    got = infer(torch.from_numpy(img).to(dev)).float().cpu()
    cpu_model = graft_full_checkpoint(path, build_model(cfg), "bisenet")
    serve = E.build_serving_fn(cpu_model, image_mean=cfg.image_mean,
                               image_std=cfg.image_std, output="scores",
                               dtype=torch.float32)
    with torch.inference_mode():
        want = serve(torch.from_numpy(img))
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"export --torch-checkpoint (f32 scores {tuple(got.shape)}): card vs "
        f"CPU max |diff| {err:.3e} (log-probs up to {scale:.3e}; bar "
        f"{REF_BAR} absolute and relative)")
    if err > REF_BAR * max(1.0, scale):
        fail(f"the reference checkpoint's card log-probs differ from the "
             f"CPU's by {err}")


def dcp_phase(dev, root):
    """A DCP save at step 2, one more step; the same state restored into a
    fresh trainer and stepped once: bit-identical (deterministic cuDNN)."""
    from torchseg_tpu_torch.engine.checkpoint_orbax import OrbaxCheckpointer
    from torchseg_tpu_torch.entry import train_entry

    trainer, (state, data) = train_entry("cityscapes.bisenet.R18",
                                         device=dev, crop=DCP_CROP, batch=2,
                                         deterministic=True)
    for _ in range(2):
        trainer.train_step(data)
    ck = OrbaxCheckpointer(os.path.join(root, "dcp"), keep=2)
    t0 = time.perf_counter()
    ck.save(2, state)
    t_async = time.perf_counter() - t0
    loss_a = trainer.train_step(data)[0]
    ck.wait()
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    other, (fresh, _) = train_entry("cityscapes.bisenet.R18", device=dev,
                                    crop=DCP_CROP, batch=2, seed=9,
                                    deterministic=True)
    ck.restore(fresh)
    if fresh.step != 2:
        fail(f"DCP restored step {fresh.step}, expected 2")
    loss_b = other.train_step(data)[0]
    got = fresh.model.state_dict()
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    log(f"DCP checkpoint: save returned in {t_async * 1e3:.1f} ms (async), "
        f"committed steps {ck.steps()}; the resumed step's loss "
        f"{float(loss_b)!r} vs {float(loss_a)!r}, {len(bad)} of {len(want)} "
        f"state tensors differ")
    if bad or not torch.equal(loss_a, loss_b):
        fail(f"the resumed step differs: {bad[:5]}")
    ck.close()


def tools_phase(dev, all_kernels, reset_all, main_med, main_infer, main_pkg,
                main_launches):
    """The deployment and measurement tools (the module docstring, item
    17); returns the kernels line's row of the post-training int8 conv."""
    import shutil
    import tempfile

    from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K
    from torchseg_tpu_torch.tools import roofline, train_speed

    phase_t0 = time.perf_counter()
    log(f"tools phase on {roofline.card()}")
    per_forward = {k: v for k, v in main_launches.items() if v}
    res, _ = speed_run(dev, "--int8-through", [
        "-e", SPEED_EXPERIMENT, "--input-size", SPEED_SIZE,
        "--int8-through"], all_kernels, reset_all, per_forward)
    log(f"speed --int8-through {res['ms_per_iter']:.4f} ms/iter beside the "
        f"main path's median forward {main_med:.4f} ms (chip_smoke's CUDA "
        f"events, 4 images)")
    speed_run(dev, "--deploy", ["-e", SPEED_EXPERIMENT, "--input-size",
                           SPEED_SIZE, "--deploy", *TOOLS_CHAIN],
              all_kernels, reset_all, {"stem_conv7x7_s2": 1})
    speed_run(dev, "X39.speed bf16", ["-e", "cityscapes.bisenet.X39.speed",
                                 "--input-size", X39_SIZE, *TOOLS_CHAIN],
              all_kernels, reset_all, {})
    row = ptq_phase(dev, all_kernels, reset_all, K)
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        export_phase(dev, root, main_infer, main_pkg, all_kernels, reset_all)
        torch.cuda.empty_cache()
        ref_checkpoint_phase(dev, root)
        dcp_phase(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    rl = roofline.main(["-e", SPEED_EXPERIMENT, "--int8-through",
                        "--input-size", SPEED_SIZE, "--measured-ms",
                        str(main_med), "--device", dev.type, "--trace"])
    log(f"roofline of the main path: bound {rl['sol_ms']:.4f} ms "
        f"({rl['bound']}), device {rl.get('trace_device_ms', 0.0):.4f} ms a "
        f"forward, the median forward {main_med:.4f} ms")
    reset_all()
    ts = train_speed.main(TRAIN_SPEED_ARGS + ["--device", dev.type])
    got = launch_counts(all_kernels)
    # the warm-up step, 3 x 2 timed, the profiler's warm-up and profiled
    n_steps = 1 + 3 * 2 + 2
    for name in ("channel_sum_sumsq", "fused_scale_bias_act"):
        if got[name] != BN_LAUNCHES * n_steps:
            fail(f"train_speed: {name} launched {got[name]} times in "
                 f"{n_steps} steps, expected {BN_LAUNCHES} a step")
    log(f"train_speed BiSeNet-R18 2 x 512x1024: {ts['ms_per_step']:.2f} ms a "
        f"step, {ts['img_per_s']:.1f} img/s, peak {ts['peak_hbm_gib']} GiB; "
        f"K8/K9 {BN_LAUNCHES} launches a step")
    speed_run(dev, "--summary (bf16)", ["-e", SPEED_EXPERIMENT,
                                        "--input-size", SPEED_SIZE,
                                        "--summary", "--chain", "10",
                                        "--reps", "1"], all_kernels,
              reset_all, {})
    log(f"tools phase: {time.perf_counter() - phase_t0:.1f} s")
    return [row]


if __name__ == "__main__":
    main()
    sys.exit(0)
