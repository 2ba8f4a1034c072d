"""Smoke run of the PyTorch / CUDA port (ao_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card and nvcc; exits non-zero without them. Reads nothing
under data/ or exp/: the scenes are synthetic and the weights are random.
PT-v2m2 runs at the full width of configs/s3dis/semseg-pt-v2m2-0-base.py,
then of configs/scannet/semseg-pt-v2m2-0-base.py and
configs/semantic_kitti/semseg-pt-v2m2-0-base.py, PT-v2m1 at that of
configs/s3dis/semseg-pt-v2m1-0-base.py, the sparse-convolution U-Nets
at those of their ScanNet SpUNet, S3DIS MinkUNet34C and SemanticKITTI
SPVCNN configs, the SpUNet task heads (CAC, PointGroup, MSC) at those
of their ScanNet and S3DIS configs, PT-v1 (Seg50, Cls26, PartSeg50) at
those of its S3DIS and ModelNet40 configs, Swin3D-v1m1 at those of its
ScanNet small and large configs, and the Stratified Transformer (ST-v1m1,
ST-v1m2) and OctFormer-v1m1 at those of their ScanNet configs.

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the kernels (one nvcc process per csrc/*.cu
   source, all started together, then one link).
2. Kernel phase (test slice): runs the slice phase's own largest batch
   (8 distinct fragments of a synthetic room, padded as the tester pads
   them) and a small batch of two room pieces padded to 16384, whose deep
   stages fall below the 2048-point slab gate. The inputs of every kernel
   call with a new shape are captured; each kernel is then held against
   its plain PyTorch version on them and timed (the wrapper by CUDA
   events, after warm-up; the kernel's own device time by torch.profiler)
   beside the plain version, a library call where one computes the same
   function, and its bound.
3. Slice phase: whole-scene testing of the room through the port's entry
   point (ao_tpu_torch.tools.test) with the config's 10 TTA views; every
   point must receive finite votes from every view. Then the largest
   batch's forward is timed and traced with torch.profiler.
4. Train kernel phase: one train step of the train phase's batch (three
   synthetic rooms of about 80k voxels each, B=3 x 81920, every stage on
   the slab path) and one of the small batch (deep stages gathered), with
   all seven kernel wrappers of the train path captured (K1 and K2 at the
   train batch's own graphs, K3 with batch-statistic folds, K4 position
   moments, K5 weight-BN statistics, K6 backward, and PointBatchNorm's
   five kernels at the first call of each width and kind); each held
   against its plain version and timed as in 2 (PointBatchNorm through a
   forward and backward: y, dx, the parameter gradients and the running
   statistics against the PyTorch composite under autograd). Each step's
   PointBatchNorm calls must launch five kernels each, and so must the
   train phase's steps. Then PointBatchNorm's cases (BN_CASES: the
   benchmark cells' widths at B=12, the scalar path, no mask, an
   all-masked batch; train and eval) held the same way; ``--point-bn``
   runs them alone.
5. Train phase: a few steps of the base config's hook-driven Trainer
   through the port's entry point (ao_tpu_torch.tools.train) on the three
   rooms, with the config's hooks (CheckpointLoader, IterationTimer,
   InformationWriter, SemSegEvaluator, CheckpointSaver); the run stops on
   max_steps inside its first epoch, whose end evaluates the slice's room
   (its full-resolution points, through the origin-coord re-projection)
   and saves model_last.pt and model_best.pt. Every loss and gradient norm
   must be finite, the parameters must move, the validation metrics must
   be finite and both checkpoints must exist. Prints the step seconds, the
   data wait, the peak device memory and the validation line, then times
   and traces one more step with torch.profiler.
6. AO phase: PP2S over the three train rooms through the port's CLI
   (ao_tpu_torch.tools.pp2s) in oracle mode, render_frames at 512^2 with
   6 + 2 views, then all (oracle id maps, bridges with the proxy's 0.02 m
   depth test, weak labels, basket, SAM labels); every stage must write
   its files for every room. Then a REAL run of 3 steps at B=3 x 81920
   through ao_tpu_torch.tools.train_real with the options of
   configs/s3dis/semseg-pt-v2m2-1-proxy-real.py; its cut epoch ends with
   the evaluation and one refinement round over oracle masks. The basket
   must hold finite logits at exactly the sampled rows, prompts must be
   mined, masks decoded, label files rewritten, the sam_label metrics
   finite and the basket reset; a REAL step must launch each kernel as
   often as a train step. Then the neural SAM at ViT-H width, built on
   the card from its seed: set_image of two rendered frames (timed after
   a warm-up) and one refinement of a room with it (predict_batch at the
   loop's bucketed shapes); embeddings, IoU predictions and mask logits
   must be finite. Prints the stages' seconds, the labels' mIoU before and
   after, the step seconds with and without the basket fill, the
   refinement's seconds, SAM's ms and the peak memory.

7. ScanNet phase: configs/scannet/semseg-pt-v2m2-0-base.py at full width
   (its patch embed takes S=8 neighbours, its deepest stage C=512, G=64)
   with the S3DIS config's bf16 compute (as written the config computes in
   f32, which takes the unfused attention in both packages) on synthetic
   rooms in ScanNet's .pth layout (make_room's geometry at
   0.03 m, ScanNet's 20 classes, normals from a neighbourhood fit), made
   here from the seed. Whole-scene testing of one room through the port's
   entry point with the config's test_cfg (no crop, 10 TTA views), votes
   checked as in 3; one train step with every kernel captured, the new
   instances (K1 at k=8, K3-K6 at S=8 / C=48 and at C=512) held against
   their plain versions and timed as in 2; then train steps at B=4 x
   102400 through ao_tpu_torch.tools.train (Mix3D at the config's 0.8,
   OneCycle): losses finite, each step's lr OneCycle's, at least one step
   merged by Mix3D, each kernel's and instance's launches per step, the
   step seconds and the peak memory. ``--scannet-batch B`` runs only these
   train steps at batch B (the config's own 12), ``--scannet-options``
   with other overrides (none: the config as written).
8. Outdoor phase: configs/semantic_kitti/semseg-pt-v2m2-0-base.py as
   written (f32, its attention unfused in both packages: only K1 and K2
   run) at full width on synthetic LiDAR scans made here from the seed.
   The scan model (:func:`make_scan`): a sensor 1.73 m above a ground
   plane casts a 64-beam ring (elevations -24.8 to +2 degrees, 2048
   azimuth steps) into a street of boxes (cars, trucks, buildings, fences,
   bushes, tree crowns, signs) and vertical cylinders (people, trunks,
   poles); each ray keeps its first hit within 80 m, labelled with the
   surface's SemanticKITTI raw id and an instance id in the upper 16 bits,
   intensity uniform in [0, 1): about 129k points a scan, as a real
   HDL-64E sweep. Four scans are written in SemanticKITTI's layout
   (sequence 00), a fifth as the test split's sequence 11 (no labels),
   and a 32-beam sweep (-30.67 to +10.67 degrees, 1084 steps, about 34k
   points) in nuScenes' layout with its info pickle. Through
   ao_tpu_torch.tools.train: 2 steps at the config's own B=12 with
   model.backbone.enable_checkpoint=True (without it B=12 does not fit the
   card), then 3 steps at B=3 (the per-card batch of the reference's
   4-card run) with checkpointing off and 3 with it on (the peak must
   fall), each printing the step seconds, the peak memory and the stage
   overflow counts, checking finite losses, moved parameters and
   OneCycle's lr on every step; one step with bf16 compute
   (SCANNET_BF16) whose K1-K6 calls are held against their plain versions
   and timed as in 2, and 3 more counted; then whole-scan testing through
   ao_tpu_torch.tools.test with submit=True of
   configs/semantic_kitti/semseg-pt-v2m2-1-benchmark-submit.py on
   sequence 11 (one .label of one uint32 per input point, every value a
   raw id of learning_map_inv) and of
   configs/nuscenes/semseg-pt-v2m2-1-benchmark-submit.py on the nuScenes
   sweep (one _lidarseg.bin of one uint8 per point, in 1..16).
   ``--outdoor-batch B`` runs only the first train steps at batch B,
   ``--outdoor-options`` with other overrides (none: the config as
   written).
9. PT-v2m1 phase: configs/s3dis/semseg-pt-v2m1-0-base.py (the pe
   multiplier, the GroupedLinear weight encoding, interp unpooling, bf16
   compute; its attention unfused in both packages) at full width on the
   train phase's rooms: one step at B=3 x 81920 with checkpointing on and
   its K1 calls (each probe of the 3-probe self graph) and K2 calls (the
   (3, 16) merges, the unpool's (2, 3)) held against their plain versions,
   3 steps at B=3 with checkpointing on (without it B=3 does not fit the
   card), and 3 steps at B=2 with it off and 3 with it on (the peak must
   fall): losses finite, parameters moved, MultiStepLR's lr, launches per
   step, step seconds and peak memory.

10. Sparse phase: the sparse-convolution configs as written (f32) at full
   width on the rooms and scans of phases 7, 8 and 5. First
   ops/sparse_conv.py's sparse_conv_apply (the recomputing Function; not a
   TPU kernel: the JAX package runs it in XLA) against its plain
   gather-then-einsum version at the ScanNet batch's full-resolution
   decoder conv (B=2, C_in=128, C_out=96, k=3): values, gradients, ms of
   both, bound. Then configs/scannet/semseg-spunet-v1m1-0-base.py: 3 steps
   at its B=12 (SGD nesterov, OneCycle, Mix3D at 0.8: a step must merge),
   and whole-scene testing of the ScanNet room with its 10 views (votes
   checked as in 3); configs/s3dis/semseg-minkunet34c-0-base.py: 3 steps
   at B=12 (PolyLR); configs/semantic_kitti/semseg-spvcnn-v1m1-0-base.py:
   one step with its K1 and K2 calls (the point branch's two
   devoxelisations, k=3 from 2 probes) held against their plain versions,
   then 3 steps at B=8 (AdamW, OneCycle). Each run prints the step
   seconds, the peak memory and the clusters beyond each stride-2 level's
   capacity per step. ``--sparse`` runs this phase alone, on data made
   for it, and times and traces one more ScanNet SpUNet step at B=12.

11. Heads phase: the SpUNet task heads' configs as written (f32) at full
   width on the rooms of phases 7 and 5. CAC:
   configs/scannet/semseg-cac-v1m1-0-spunet-base.py, 3 steps at its B=12
   (Mix3D, SGD nesterov, OneCycle; its four loss terms finite), then
   whole-scene testing of the ScanNet room with its 10 views (votes checked
   as in 3); semseg-cac-v1m1-2-ptv2-lovasz.py at B=12 with
   enable_checkpoint (as written PT-v2m2 in f32 does not fit B=12) and
   in_channels=6, the features its data gives (:data:`CAC_PTV2_IN`): one
   step whose K1 and K2 calls are held against their plain versions, then
   3 counted. PointGroup: configs/scannet/insseg-pointgroup-v1m1-0-
   spunet-base.py through ao_tpu_torch.tools.train_insseg, 3 steps at
   B=12 (PolyLR) whose cut epoch ends with the InsSegEvaluator on the val
   room (mAP, AP50, AP25 finite; the same hook on the room's own labels
   must make proposals and score AP50 1; the host seconds of clustering
   and of the AP table printed); the S3DIS config 3 steps at B=12. MSC:
   configs/scannet/pretrain-msc-v1m1-0-spunet-base.py through
   ao_tpu_torch.tools.train_pretrain: 2 steps at B=4 in the full run (3
   under ``--heads`` at the first of B = 8, 7, 6, 4, 2 that fits: the
   config's 32, 16 and 12 do not on an 80 GB card; the peak reached
   printed), the NCE, colour and normal losses finite and matched
   pairs on every step, and the matching kNN timed on one of its batches;
   then one step of pretrain-msc-v1m2-0-spunet-csc.py at that batch. Each run prints its step seconds, data wait and peak
   memory. ``--heads`` runs this phase alone, on data made for it.

12. PT-v1 phase: FPS (csrc/fps.cu; no TPU kernel: ao_tpu runs it as an XLA
   loop) held against its plain version, indices equal, on a padded
   batch and on a lattice with exact ties, then at Seg50's four stages
   of the S3DIS train batch (81920 -> 20480 -> 5120 -> 1280 -> 320).
   configs/s3dis/semseg-pt-v1-0-base.py as written (Seg50, f32, AdamW,
   MultiStepLR) on phase 5's rooms: one train step at the first of B =
   12, 8, 6, 4, 3 that fits (the peak reached printed for each that does
   not) with its K1 and K2 calls (the unpooling's 2-probe k=3 search at
   Nq = 81920, 20480, 5120) and its FPS calls captured and held, 3
   counted steps at that batch (losses finite, parameters moved,
   MultiStepLR's lr, launches per step, step seconds, data wait, peak
   memory), one more timed for the share of its exact kNN (chunked above
   2^28 scores), and whole-scene testing of the slice phase's room with
   the config's first view (all 10 under ``--ptv1``).
   configs/modelnet40/cls-ptv1-0-base.py as written
   (Cls26, B=32 x 1024, SGD nesterov) on synthetic shapes in ModelNet40's
   layout (40 classes, 10000 points with normals a file, one train and one
   test shape a class): 3 steps whose cut epoch ends with the
   ClsEvaluator, then its ClsTester; cls-spunet-v1m1-0-base.py 3 steps at
   its B=16 with the level-0 sites a shape printed (its transforms have
   no GridSample). PartSeg50 with the PartSegTester on two shapes in
   ShapeNetPart's layout (a config built here: two scaled views).
   ``--ptv1`` runs this phase alone, on data made for it.
13. Swin3D phase: configs/scannet/semseg-swin3d-v1m1-0-small.py as written
   (f32, AdamW with the cRSE tables in their param_dicts group, OneCycle,
   Mix3D) on phase 7's rooms: one unmixed train step (Mix3D's worst case)
   at B=6 in the full run (under ``--swin3d`` at the first of B = 12, 8,
   6, 4, 3, 2 that fits, the peak reached printed for each that does not)
   with its K1 and K2 calls (the decoder's 2-probe k=3 interpolation
   search at four levels) captured and held, 3 counted steps at that
   batch (losses finite, parameters moved, both groups' lr OneCycle's,
   each stage's occupied window rows against num_windows and the points
   dropped beyond num_windows and beyond the capacity, step seconds, data
   wait, peak memory), one more timed for the downsampling's exact kNN's
   share (under ``--swin3d`` traced with torch.profiler: device time by
   kernel); one step of
   semseg-swin3d-v1m1-1-large.py at the first of B
   = 4, 2, 1 that fits unmixed; whole-scene testing of the ScanNet room with the
   config's first view (all 10 under ``--swin3d``; the first fragments'
   K1 / K2 calls held). ``--swin3d`` runs this phase alone, on data made
   for it.
14. Stratified phase: configs/scannet/semseg-st-v1m1-0-origin.py as
   written (f32, 5 stages, C up to 384, the KPConv embedding's exact
   16-NN, AdamW, MultiStepLR, Mix3D) on phase 7's rooms: one unmixed
   train step at B=ST_BATCH (under ``--stratified`` at the first of B =
   12, 10, 8, 7, 6, 5, 4, 3, 2 that fits) with its K1 and K2 calls (the decoder's
   2-probe k=3 search at four levels) captured and held, 3 counted steps
   (each block's occupied window rows and drops of the fine and the
   coarse packs, step seconds, data wait, peak memory), one more timed for
   the exact kNN's share; one step of semseg-st-v1m2-0-refined.py with
   in_channels=6 (the 6 features its data gives); whole-scene testing of
   the ScanNet room with the config's first 2 views (the first fragments'
   K1 / K2 calls held). ``--stratified`` runs this phase alone, with one
   more step traced for device time by kernel.
15. OctFormer phase: configs/scannet/semseg-octformer-v1m1-0-base.py as
   written (f32, C 96 / 192 / 384 / 384, depths 2 / 2 / 18 / 2, groups of
   26, dilation 4, AdamW with its empty "blocks" parameter group,
   MultiStepWithWarmupLR, Mix3D) on phase 7's rooms, as phase 14: one
   unmixed step at B=OCTFORMER_BATCH (under ``--octformer`` the first of
   the same batches that fits) with its K1 / K2 calls held, 3 counted
   steps with both groups' lr each step, one timed for the CPE's exact
   kNN's share, and a 2-view scene test. ``--octformer`` runs it alone,
   with a traced step.
16. PointContrast phase: ScanNet-layout scenes written here as .sens
   streams (version 4, 640 x 480 zlib depth and JPEG colour, ScanNet's
   depth intrinsics), each frame rendered from a make_room room (0.02 m)
   by a camera turning 20 degrees a frame, so that neighbouring frames
   overlap; the port's preprocessor
   (ao_tpu_torch.datasets.preprocessing.preprocess_scannet_pair) over them;
   then 2 steps of configs/scannet/pretrain-msc-v1m1-1-spunet-pointcontrast.py
   at its full width (SpUNet, in_channels 3) through
   ao_tpu_torch.tools.train_pretrain at the config's B=32 pairs (under
   ``--pointcontrast`` the first of B = 32, 24, 16 that fits, the peak
   reached printed for each that does not): losses finite, pairs matched,
   parameters moved; the pairs kept, the points a view, the step seconds
   and the peak memory printed. ``--pointcontrast`` runs it alone.
17. Data-parallel phase (one card): the main path's config at full width
   (bf16) on four rooms at a global B=4 x 81920, SGD, no stochastic depth,
   each scene's augmentation seeded by its index: one process twice (its
   run-to-run spread), then two processes over gloo on the card through
   ao_tpu_torch.engines.launch (B=2 each; process 0 holds K1-K6 of its
   first step against their plain versions at these shapes), 3 steps; at
   every step the loss, the parameters (all tensors together) and the
   running statistics within max(3 x the spread, a floor) of the single
   process, K1-K6 launched per step by each process as by the single one;
   then the same of configs/scannet/semseg-pt-v2m2-3-lovasz.py (its
   Lovasz term over the global batch; in the config's f32 with PyTorch's
   deterministic algorithms, its first grid pool at 0.4 of the points so
   that the synthetic rooms overflow none) on two ScanNet rooms, 2 steps:
   one process at B=2 twice, two gloo processes at B=1 each, held in the
   same kind of band (K1 and K2 launched alike: f32's attention is the
   unfused one); a spread that would widen step 1's band past 0.5 of
   a step in the parameters fails either case; then an NCCL group of one
   for 2 steps. The collectives a step and their
   seconds in a timed step printed. ``--ddp`` runs it alone;
   ``--ddp-faults`` adds, to both cases, two-process runs with a fault
   planted in the gradient reduction (doubled, or left unreduced), each of
   which must fall outside the band; ``--ddp-nccl 2 4`` runs the single
   process and 2 and 4 processes over NCCL, one card each (on a machine
   with 4 cards), held in the same band, and the Lovasz case at a global
   B=4; ``--lovasz-spread`` prints the Lovasz case's single-process
   spread under the settings of LOVASZ_SPREADS (bf16 or f32, the Lovasz
   term or CE alone, the config's capacities or no overflow, PyTorch's
   deterministic algorithms or not) and two gloo processes against one
   under each.
18. Leftovers phase: phase 17's four rooms written as raw S3DIS rooms of
   two areas (Area_<a>/<room>/Annotations/<class>_<k>.txt), the port's
   preprocessor (ao_tpu_torch.datasets.preprocessing.preprocess_s3dis,
   spawned workers) over them; the main path's config (B=3 x 81920, bf16)
   trained 3 steps through ao_tpu_torch.tools.train on a ConcatDataset of
   the two preprocessed areas with RuntimeProfilerV2 in its hooks (its
   trace file must hold the traced step's CUDA kernels); DataCacheOperator
   over a plain S3DIS dataset of the rooms under an AO_SHM_CACHE in the
   phase's directory (every cached array equal to the scene, clear_cache
   at the end); then train steps under each of ao_tpu's kernel-path
   switches: AO_GVA_SLAB=0 (3 steps: K1's 3 probes merged by K2, K3-K6
   on gathered rows at every stage), AO_SLAB_W=512 (2: the wider slab
   windows), AO_EXACT_KNN=1 (2: the exact kNN's graphs, gathered K3-K6)
   and AO_GVA_FUSED=0 (2, the unfused attention with K1 / K2 only, at the
   first of B = 3, 2, 1 that fits), every kernel call captured and held
   against its plain version; each switch's step seconds, peak memory and
   the batch that fit printed. ``--leftovers`` runs it alone.

The full run keeps to about 810 s of its 1200-second limit (a slower host
adds a seventh): phases 10-15 take FULL_RUN_STEPS (2) counted steps, Seg50
a fixed B=PTV1_FULL_BATCH (6), MSC a fixed B=4 for one step, the PT-v1
and Swin3D scene tests FULL_RUN_TEST_VIEWS (1) view, ST's and
OctFormer's 2, and Swin3D no traced step; each phase's flag runs it at
the depth above.

Each main path (the slice phase, the train phase, the REAL run, the
ScanNet test and train runs, every train and test run of phases 8-16 and
18)
runs with every kernel's launch count set to 0 just before it and read
just after, and fails if one of its kernels never launched (PointBatchNorm's
on every path but the Stratified Transformer's and OctFormer's). The last
three lines are the card, the kernels' JSON record (one entry per kernel,
then one per new instance of the ScanNet config, then one per kernel of
the outdoor, PT-v2m1, sparse, CAC, PT-v1, Swin3D, Stratified, OctFormer,
data-parallel and switch paths (knn_window[gathered], gva_bwd[slab512],
...) at its heaviest shape there, then FPS) and {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import faulthandler
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BASE_CONFIG = os.path.join(ROOT, "configs", "s3dis", "semseg-pt-v2m2-0-base.py")
REAL_CONFIG = os.path.join(ROOT, "configs", "s3dis",
                           "semseg-pt-v2m2-1-proxy-real.py")
SCANNET_CONFIG = os.path.join(ROOT, "configs", "scannet",
                              "semseg-pt-v2m2-0-base.py")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

KERNEL_INFO = {
    "knn_window": dict(
        route="cuda", source="ao_tpu_torch/csrc/knn_window.cu",
        replaces="ao_tpu/ops/pallas/knn_window.py:108"),
    "merge_topk": dict(
        route="cuda", source="ao_tpu_torch/csrc/merge_topk.cu",
        replaces="ao_tpu/ops/pallas/merge_topk.py:91"),
    "gva_eval": dict(
        route="cuda", source="ao_tpu_torch/csrc/gva_eval.cu",
        replaces="ao_tpu/ops/pallas/gva_slab.py:263 + "
                 "ao_tpu/ops/pallas/gva_fused.py:276"),
    "gva_pos": dict(
        route="cuda", source="ao_tpu_torch/csrc/gva_pos.cu",
        replaces="ao_tpu/ops/pallas/gva_slab.py:203 + "
                 "ao_tpu/ops/pallas/gva_fused.py:242"),
    "gva_stats": dict(
        route="cuda", source="ao_tpu_torch/csrc/gva_stats.cu",
        replaces="ao_tpu/ops/pallas/gva_slab.py:236 + "
                 "ao_tpu/ops/pallas/gva_fused.py:218"),
    "gva_bwd": dict(
        route="cuda", source="ao_tpu_torch/csrc/gva_bwd.cu",
        replaces="ao_tpu/ops/pallas/gva_slab.py:294 + "
                 "ao_tpu/ops/pallas/gva_fused.py:292 + "
                 "ao_tpu/ops/pallas/gva_fused.py:346"),
    # no TPU kernel: ao_tpu's FPS is an XLA lax.fori_loop
    "fps": dict(
        route="cuda", source="ao_tpu_torch/csrc/fps.cu",
        replaces="ao_tpu/ops/sampling.py:22 (XLA fori_loop, no TPU kernel)"),
    # no TPU kernel: ao_tpu's PointBatchNorm is XLA ops; five kernels (two
    # statistics passes, the normalisation, the backward's sums and dx)
    # behind one wrapper, ops/point_bn.py
    "point_bn": dict(
        route="cuda", source="ao_tpu_torch/csrc/point_bn.cu",
        replaces="none: ao_tpu/models/utils.py PointBatchNorm (XLA ops)"),
}
# the kernels of each main path (all six of PT-v2 run in a train step, and
# PointBatchNorm's in every model but the Stratified Transformer and
# OctFormer)
SLICE_KERNELS = ("knn_window", "merge_topk", "gva_eval", "point_bn")
TRAIN_KERNELS = ("knn_window", "merge_topk", "gva_eval", "gva_pos",
                 "gva_stats", "gva_bwd", "point_bn")
# PointBatchNorm's kernels alone, and with the unfused attention's K1 / K2
BN_KERNELS = ("point_bn",)
GRAPH_BN_KERNELS = ("knn_window", "merge_topk", "point_bn")
# (make_room seed, room size in m) of the train phase's three rooms: over
# 100k voxels of 0.04 m each, so that after the train transforms
# (RandomScale down to 0.9) SphereCrop keeps 80000 points and the batch
# pads to the config's 81920
TRAIN_ROOMS = ((1, (6.0, 5.0, 3.0)), (2, (6.4, 4.8, 3.0)),
               (3, (5.6, 5.4, 3.2)))

# class id -> base colour of the synthetic room (S3DIS' 13 classes)
_COLORS = np.array([
    [200, 200, 200], [140, 120, 100], [220, 210, 190], [120, 100, 80],
    [180, 180, 170], [150, 190, 230], [130, 90, 60], [160, 110, 70],
    [60, 60, 140], [120, 40, 40], [90, 70, 50], [30, 80, 40], [110, 110, 110],
], np.float32)


def log(t0, msg):
    print(f"[{time.perf_counter() - t0:8.1f} s] {msg}", flush=True)


def card_line():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else (
            f"nvidia-smi failed: {res.stderr.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
# synthetic S3DIS room
# ---------------------------------------------------------------------------


def _plane(rng, origin, u, v, spacing):
    """Jittered grid of points on the rectangle origin + [0,1]u + [0,1]v."""
    origin, u, v = (np.asarray(x, np.float64) for x in (origin, u, v))
    nu = max(int(np.linalg.norm(u) / spacing), 1)
    nv = max(int(np.linalg.norm(v) / spacing), 1)
    a, b = np.meshgrid((np.arange(nu) + 0.5) / nu, (np.arange(nv) + 0.5) / nv)
    pts = origin + a.reshape(-1, 1) * u + b.reshape(-1, 1) * v
    return pts + rng.uniform(-0.1, 0.1, pts.shape) * spacing


def _box(rng, lo, hi, spacing):
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    d = hi - lo
    ex, ey, ez = np.diag(d)
    faces = [
        (lo, ex, ey), (lo + ez, ex, ey), (lo, ex, ez), (lo + ey, ex, ez),
        (lo, ey, ez), (lo + ex, ey, ez),
    ]
    return np.concatenate([_plane(rng, o, u, v, spacing) for o, u, v in faces])


def make_room(seed, size=(4.8, 4.0, 2.6), spacing=0.034):
    """One room in the S3DIS scene format: a shell (floor, ceiling, walls
    with a door, a window and a board), a beam, a column and box
    furniture, all placed relative to the room's size; coord (n, 3) f32,
    color (n, 3) in 0..255, semantic_gt (n, 1) in 0..12, instance_gt (n, 1):
    one id per part (each plane of the shell, each box, the clutter) and
    one per wall fixture (door, window, board), drawing nothing from the
    random generator. At the default size the 0.04 m test voxelisation
    keeps about 80k points per fragment."""
    rng = np.random.default_rng(seed)
    X, Y, Z = size
    parts = []

    def add(points, label):
        parts.append((points, np.full(len(points), label, np.int64)))

    def box(lo, hi, label):  # lo / hi as fractions of the room
        add(_box(rng, np.multiply(lo, size), np.multiply(hi, size), spacing),
            label)

    add(_plane(rng, (0, 0, 0), (X, 0, 0), (0, Y, 0), spacing), 1)  # floor
    add(_plane(rng, (0, 0, Z), (X, 0, 0), (0, Y, 0), spacing), 0)  # ceiling
    wall_planes = [
        _plane(rng, (0, 0, 0), (X, 0, 0), (0, 0, Z), spacing),
        _plane(rng, (0, Y, 0), (X, 0, 0), (0, 0, Z), spacing),
        _plane(rng, (0, 0, 0), (0, Y, 0), (0, 0, Z), spacing),
        _plane(rng, (X, 0, 0), (0, Y, 0), (0, 0, Z), spacing),
    ]
    walls = np.concatenate(wall_planes)
    wl = np.full(len(walls), 2, np.int64)
    x, y, z = (walls / np.asarray(size)).T
    eps = 1e-4
    wl[(y < eps) & (x > 0.15) & (x < 0.33) & (z < 0.77)] = 6  # door
    wl[(y > 1 - eps) & (x > 0.4) & (x < 0.7) & (z > 0.35) & (z < 0.77)] = 5
    wl[(x < eps) & (y > 0.3) & (y < 0.7) & (z > 0.38) & (z < 0.77)] = 11
    parts.append((walls, wl))
    box((0, 0.5, 0.89), (1, 0.56, 1), 3)  # beam
    box((0.92, 0.9, 0), (1, 1, 1), 4)  # column
    box((0.3, 0.3, 0.27), (0.63, 0.52, 0.29), 7)  # table
    box((0.17, 0.3, 0), (0.27, 0.41, 0.35), 8)  # chairs
    box((0.68, 0.35, 0), (0.77, 0.46, 0.35), 8)
    box((0.01, 0.01, 0), (0.39, 0.22, 0.31), 9)  # sofa
    box((0.75, 0.01, 0), (0.99, 0.11, 0.77), 10)  # bookcase
    n_clutter = int(0.01 * X * Y * Z / spacing**2)
    add(rng.uniform((0.1 * X, 0.1 * Y, 0), (0.9 * X, 0.9 * Y, 0.6 * Z),
                    (n_clutter, 3)), 12)

    coord = np.concatenate([p for p, _ in parts]).astype(np.float32)
    label = np.concatenate([lab for _, lab in parts])
    color = np.clip(_COLORS[label] + rng.normal(0, 12, (len(label), 3)), 0, 255)
    # instance ids: parts in order, the walls' part split by plane, then
    # the door, window and board (their own ids past the parts')
    sizes = [len(p) for p, _ in parts]
    wall_part = 2  # floor, ceiling, walls, ...
    sizes[wall_part:wall_part + 1] = [len(w) for w in wall_planes]
    instance = np.repeat(np.arange(len(sizes)), sizes)
    for i, fixture in enumerate((6, 5, 11)):
        instance[label == fixture] = len(sizes) + i
    return dict(coord=coord, color=color.astype(np.float32),
                semantic_gt=label.reshape(-1, 1),
                instance_gt=instance.reshape(-1, 1))


def write_raw_s3dis(root, rooms):
    """Write ``rooms`` ({(area, room name): a scene of :func:`make_room`})
    as the raw S3DIS release lays them out:
    ``<root>/Area_<area>/<room>/Annotations/<class>_<k>.txt``, one file an
    instance, each line x y z r g b (millimetres, integer colours)."""
    from ao_tpu_torch.datasets.preprocessing.preprocess_s3dis import CLASS_NAMES

    for (area, name), room in rooms.items():
        ann = os.path.join(root, f"Area_{area}", name, "Annotations")
        os.makedirs(ann, exist_ok=True)
        sem = room["semantic_gt"].reshape(-1)
        inst = room["instance_gt"].reshape(-1)
        counts = {}
        for i in np.unique(inst):
            rows = inst == i
            cls = CLASS_NAMES[int(sem[rows][0])]
            k = counts[cls] = counts.get(cls, 0) + 1
            np.savetxt(os.path.join(ann, f"{cls}_{k}.txt"),
                       np.concatenate([room["coord"][rows],
                                       room["color"][rows]], 1),
                       fmt="%.3f %.3f %.3f %d %d %d")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def _shape_key(a):
    if torch.is_tensor(a):
        return tuple(a.shape)
    if isinstance(a, (tuple, list)):
        return tuple(_shape_key(x) for x in a)
    return a


def _clone(a):
    if torch.is_tensor(a):  # no graph: a wrapper outside autograd's Functions
        return a.detach().clone()
    if isinstance(a, torch.nn.Module):  # a BatchNorm1d as at the call
        with torch.inference_mode(False):
            return copy.deepcopy(a)
    if isinstance(a, dict):
        return {k: v.detach().clone() for k, v in a.items()}
    if isinstance(a, (tuple, list)):
        return type(a)(_clone(x) for x in a)
    return a


def _bn_key(x, mask, bn, training, relu=False):
    """PointBatchNorm's capture key: its width, type and kind, so that a
    run keeps the first (largest) call of each width."""
    return (x.shape[-1], x.dtype, x.dim(), mask is None, training, relu)


# kernels whose calls are told apart by more or less than their shapes
CAPTURE_KEYS = {"point_bn": _bn_key}


class Capture:
    """Wraps the kernel wrappers so that the inputs of the first call of
    each (kernel, shape) are kept for the comparison with the plain
    versions: of every shape, or of the first ``limit[name]`` shapes of a
    kernel named there (a key of :data:`CAPTURE_KEYS` in place of the
    shapes); ``counts`` holds every call's. Launches count as they would
    unwrapped, so a counted run may be captured too."""

    def __init__(self, limit=None):
        self.calls = {}
        self.counts = {}
        self.limit = dict(limit or {})
        self._undo = []

    def wrap(self, module, attr, name):
        fn = getattr(module, attr)

        def rec(*args):
            self.counts[name] = self.counts.get(name, 0) + 1
            key = (name,) + (CAPTURE_KEYS[name](*args) if name in CAPTURE_KEYS
                             else tuple(_shape_key(a) for a in args
                                        if not isinstance(a, dict)))
            seen = sum(c[0] == name for c in self.calls.values())
            if key not in self.calls and seen < self.limit.get(name, seen + 1):
                self.calls[key] = (name, fn, [_clone(a) for a in args])
            out = fn(*args)
            # a wrapper counts its launches on its module's attribute, which
            # is this function while wrapped: they move to the wrapper's own
            # count (which _wrappers reads through __wrapped__)
            fn.launches += rec.launches
            rec.launches = 0
            return out

        rec.launches = 0
        rec.__wrapped__ = fn
        setattr(module, attr, rec)
        self._undo.append((module, attr, fn))

    def wrap_path(self, names):
        """Wrap the wrappers of ``names`` (kernel names of
        :data:`KERNEL_INFO`) where the paths call them."""
        from ao_tpu_torch.models import utils as model_utils
        from ao_tpu_torch.models.point_transformer import ptv1
        from ao_tpu_torch.ops import gva as gva_mod
        from ao_tpu_torch.ops import knn_spatial as ks

        for name in names:
            if name == "merge_topk":
                self.wrap(ks, "merge_topk_probes", name)
            elif name == "knn_window":
                self.wrap(ks, name, name)
            elif name == "fps":  # PT-v1's TransitionDown calls it by this name
                self.wrap(ptv1, "farthest_point_sampling", name)
            elif name == "point_bn":  # PointBatchNorm.forward calls it there
                self.wrap(model_utils, "point_batch_norm", name)
            else:
                self.wrap(gva_mod, name, name)
        return self

    def restore(self):
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()


def cuda_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def _bound(nbytes, bf16_ops=0.0, f32_ops=0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = bf16_ops / BF16_FLOP_PER_S + f32_ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_knn_window(args, out_k, out_p):
    keys, k2, order, q, ws, k, tile_q, window = args
    (dk, ik), (dp, ip) = out_k, out_p
    B, Nq = q.shape[:2]
    T = Nq // tile_q
    # the (B, T, tile_q, window) score tile and window ids of the same inputs
    start = ws.long().clamp(0, keys.shape[1] - window)
    cols = (start[..., None] + torch.arange(window, device=ws.device)).reshape(B, -1)
    wk = torch.gather(keys, 1, cols[..., None].expand(-1, -1, 3))
    wo = torch.gather(order, 1, cols).reshape(B, T, window)
    scores = torch.gather(k2, 1, cols).reshape(B, T, 1, window) - 2.0 * torch.matmul(
        q.reshape(B, T, tile_q, 3), wk.reshape(B, T, window, 3).transpose(-1, -2))

    err = (dk - dp).abs()
    # a score |k|^2 - 2 q.k is a difference of terms of the order of |q|^2,
    # which f32 rounds to 1.2e-7 of that: where a query's neighbours lie as
    # far from it as it lies from the origin (a sparse LiDAR window at
    # range) the score cancels to far less than its terms
    q2 = (q * q).sum(-1, keepdim=True)
    tol = 1e-5 * torch.clamp_min(torch.maximum(dp.abs(), q2), 1.0)
    ok = bool((err <= tol).all())
    # ids may differ only between equidistant candidates: every differing
    # id must be one of its tile's window ids whose score is the score the
    # kernel emitted for it
    b, n, j = (ik != ip).nonzero(as_tuple=True)
    t, qi = n // tile_q, n % tile_q
    hit = wo[b, t] == ik[b, n, j][:, None]
    col = hit.float().argmax(dim=1)
    s_hit = scores[b, t, qi, col]
    ok = ok and bool(hit.any(dim=1).all()) and bool(
        ((s_hit - dk[b, n, j]).abs() <= tol[b, n, j]).all())
    nbytes = _nbytes(keys, k2, order, q, ws) + B * Nq * k * 8
    # per (query, key) pair: 3 mul + 2 add for q.k, x2, -, and a compare
    bound_ms, by = _bound(nbytes, f32_ops=8.0 * B * Nq * window)
    # yardstick: torch.topk over the materialised score tile
    lib_ms = cuda_ms(lambda: torch.topk(scores, k, dim=-1, largest=False))
    return ok, float(err.max()), bound_ms, by, lib_ms, (
        f"ids differing at ties {len(b)}")


def check_merge_topk(args, out_k, out_p):
    """The fused K2 (every probe's tail in its loads) against its plain
    version, bit for bit; beside it, the row kernel on the concatenated
    tails against merge_topk_plain, bit for bit, with its device ms."""
    from ao_tpu_torch.ops import knn_spatial as ks

    s, idx, q2, inv, k = args
    (dk, ik), (dp, ip) = out_k, out_p
    ok = torch.equal(ik, ip) and torch.equal(dk.view(torch.int32),
                                             dp.view(torch.int32))
    tails = [ks._probe_tail(*p) for p in zip(s, idx, q2, inv)]
    d2 = torch.cat([t[0] for t in tails], -1)
    ids = torch.cat([t[1] for t in tails], -1)
    rk, rp = ks.merge_topk(d2, ids, k), ks.merge_topk_plain(d2, ids, k)
    rows_ok = torch.equal(rk[1], rp[1]) and torch.equal(
        rk[0].view(torch.int32), rp[0].view(torch.int32))
    rows_ms = _device_ms(lambda: ks.merge_topk(d2, ids, k), "merge_topk_kernel",
                        reps=5, warmup=1)
    B, Nq = inv[0].shape
    width = len(s) * k
    # per query and probe: its inverse row, k scores, k ids and |q|^2 read
    # once; k scores and ids written
    nbytes = B * Nq * (len(s) * (4 + 8 * k + 4) + 8 * k)
    bound_ms, by = _bound(nbytes, f32_ops=3.0 * B * Nq * k * width)
    return ok and rows_ok, float((dk - dp).abs().max()), bound_ms, by, None, (
        f"bitwise; row kernel on the concatenated tails bitwise={rows_ok} "
        f"device_ms={rows_ms}")


def check_gva_eval(args, out_k, out_p):
    src, qrow, idx, valid, fp = args
    err = float((out_k - out_p).abs().max())
    scale = max(float(out_p.abs().max()), 1.0)
    ok = err < 5e-3 * scale
    B, Nq, S = idx.shape
    C, G = qrow.shape[-1] - 7, fp["W2"].shape[0]
    nbytes = _nbytes(src, qrow, idx, valid, *fp.values()) + B * Nq * C * 4
    slots = B * Nq * S
    mm = slots * (2 * 3 * C + 2 * C * C + 2 * C * G)  # bf16-operand products
    other = slots * (2 * G * G + 8 * C + 6 * G)  # f32 products, softmax, sums
    bound_ms, by = _bound(nbytes, bf16_ops=mm, f32_ops=other)
    return ok, err, bound_ms, by, None, f"scale {scale:.3g}"


def _gva_dims(args):
    """(B, Nq, S, Nsrc, C) of a GVA kernel's row arguments."""
    src, qrow, idx = args[:3]
    return (*idx.shape, src.shape[1], qrow.shape[-1] - 7)


def _rel(out_k, out_p, scale=None):
    """(max abs error, the reference's scale) of two tensors."""
    err = float((out_k.float() - out_p.float()).abs().max())
    ref = float(out_p.abs().max()) if scale is None else scale
    return err, max(ref, 1e-12)


def check_gva_pos(args, out_k, out_p):
    src, qrow, idx, valid = args
    B, Nq, S, Nsrc, C = _gva_dims(args)
    ok, errs, notes = torch.equal(out_k[2], out_p[2]), [], []
    for name, a, b in zip(("psum", "ppsum"), out_k[:2], out_p[:2]):
        err, scale = _rel(a, b)
        ok = ok and err <= 1e-4 * scale  # f32 sums of ~4M terms
        errs.append(err)
        notes.append(f"{name} {err / scale:.2g}")
    edges = float(out_p[2])
    # coordinate lanes of every source and query row, ids, validity
    nbytes = (B * (Nsrc + Nq) * 6 * 2 + _nbytes(idx, valid) + 13 * 4)
    bound_ms, by = _bound(nbytes, f32_ops=30.0 * edges)
    return ok, max(errs), bound_ms, by, None, (
        f"count {edges:.0f} exact={torch.equal(out_k[2], out_p[2])}; rel "
        + " ".join(notes))


def check_gva_stats(args, out_k, out_p):
    src, qrow, idx, valid, A, cA, Wp2, bp2, W1, b1 = args
    B, Nq, S, Nsrc, C = _gva_dims(args)
    G = W1.shape[1]
    ok, errs, notes = torch.equal(out_k[2], out_p[2]), [], []
    for name, a, b in zip(("sum_t", "sum_t2", "count", "psum", "ppsum"),
                          out_k, out_p):
        err, scale = _rel(a, b)
        ok = ok and err <= 1e-4 * scale
        errs.append(err)
        notes.append(f"{name} {err / scale:.2g}")
    edges = float(out_p[2])
    nbytes = (B * Nsrc * (C + 6) * 2 + B * Nq * (C + 7) * 2
              + _nbytes(idx, valid, A, cA, Wp2, bp2, W1, b1) + (2 * G + 13) * 4)
    # the products pe0 (K = 3, bf16 operands), peb and t at the bf16 rate;
    # the elementwise steps and sums at the f32 rate
    mm = edges * (2 * 3 * C + 2 * C * C + 2 * C * G)
    bound_ms, by = _bound(nbytes, bf16_ops=mm, f32_ops=edges * (6 * C + 6 * G))
    return ok, max(errs), bound_ms, by, None, "rel " + " ".join(notes)


# K6's parameter sums and the weight sums whose scale their bias sums are
# measured against (db2 is zero up to rounding: the softmax is
# shift-invariant)
_PARTNER = {"db1f": "dW1f", "db2": "dW2", "dbp2": "dWp2", "dcA": "dA"}


def check_gva_bwd(args, out_k, out_p):
    from ao_tpu_torch.ops.gva import _split_par, bwd_par_layout

    src, qrow, idx, valid, fp, dout = args
    B, Nq, S, Nsrc, C = _gva_dims(args)
    G = fp["W2"].shape[0]
    # dkv / dq / the parameter sums: f32 atomics in changing order, and the
    # bf16 rounding of dt and dpeb can flip by one unit where the kernel's
    # sums differ in the last bit: 1e-2 of scale (measured up to 5.8e-3);
    # the [valid | t] moments: 1e-3
    ok, errs, notes = True, [], []
    for name, a, b, tol in (("dkv", out_k[0], out_p[0], 1e-2),
                            ("dq", out_k[1], out_p[1], 1e-2),
                            ("mom", out_k[3], out_p[3], 1e-3),
                            ("qmom", out_k[4], out_p[4], 1e-3)):
        err, scale = _rel(a, b)
        ok = ok and err <= tol * scale
        errs.append(err)
        notes.append(f"{name} {err / scale:.2g}")
    pk, pp = _split_par(out_k[2], C, G), _split_par(out_p[2], C, G)
    for name in pk:
        scale = float(pp[name].abs().max())
        if name in _PARTNER:
            scale = max(scale, float(pp[_PARTNER[name]].abs().max()))
        err, scale = _rel(pk[name], pp[name], scale)
        ok = ok and err <= 1e-2 * scale
        errs.append(err)
        notes.append(f"{name} {err / scale:.2g}")
    edges = float(valid.sum())
    P = sum(math.prod(shape) for _, shape in bwd_par_layout(C, G))
    nbytes = (_nbytes(src, qrow, idx, valid, dout, *fp.values())
              + B * Nsrc * (2 * C + 1 + G) * 4 + B * Nq * (C + 1 + G) * 4
              + P * 4)
    # at the bf16 rate the products with bf16 operands (as the TPU kernel):
    # pe0 (K = 3), peb and dpe0 and the sum pe1^T dpeb (C x C each), t, dr
    # and the sum r^T dt (C x G each), the (1 + G) x 6C moment; at the f32
    # rate the three G x G products (f32 operands), the softmax and the
    # elementwise steps
    mm = edges * (2 * 3 * C + 6 * C * C + 6 * C * G + 12 * C * (1 + G))
    f32 = edges * (6 * G * G + 36 * C)
    bound_ms, by = _bound(nbytes, bf16_ops=mm, f32_ops=f32)
    return ok, max(errs), bound_ms, by, None, "rel " + " ".join(notes)


# H100 SXM's highest boost clock (data sheet) and the latency of a
# dependent f32 operation on an SM (4 cycles; a microbenchmark figure, not
# a data-sheet one): the floor under a chain of dependent operations
SM_CLOCK_HZ = 1.98e9
DEPENDENT_OP_CYCLES = 4


def check_fps(args, out_k, out_p):
    """FPS against its plain version: indices and validity equal. Bound:
    the larger of the bytes (coordinates and mask read once, indices and
    validity written once) at the memory rate, the operations (about 10 a
    valid point and step: 3 subtractions, 3 products, 2 sums, a minimum, a
    comparison) at the f32 rate, and the chain of the steps: a step depends
    on the last one's argmax, a reduction over N values that takes at least
    log2(N) dependent operations. No PyTorch call computes FPS."""
    coord, mask, m = args[:3]
    (ik, vk), (ip, vp) = out_k, out_p
    ok = torch.equal(ik, ip) and torch.equal(vk, vp)
    err = float((ik != ip).sum())
    B, N = mask.shape
    n_valid = mask.sum(1)
    steps = torch.clamp(torch.clamp_max(n_valid, m) - 1, min=0)
    ops = 10.0 * float((steps * n_valid).sum())
    chain_ms = (float(steps.max()) * math.ceil(math.log2(max(N, 2)))
                * DEPENDENT_OP_CYCLES / SM_CLOCK_HZ * 1e3)
    nbytes = _nbytes(coord, mask) + B * m * 5
    bound_ms, by = _bound(nbytes, f32_ops=ops)
    if chain_ms > bound_ms:
        bound_ms, by = chain_ms, "operations"
    return ok, err, bound_ms, by, None, (
        f"indices differing {int(err)}; chain {chain_ms:.4f} ms")


@contextlib.contextmanager
def _local_comm():
    """No process group while a hold runs: process 0 of a data-parallel run
    holds its calls alone while the others wait, so PointBatchNorm's
    statistics and gradients stay its own on both sides (the steps
    themselves ran with the global ones)."""
    from ao_tpu_torch.utils import comm

    distributed, comm.is_distributed = comm.is_distributed, lambda: False
    try:
        yield
    finally:
        comm.is_distributed = distributed


def point_bn_plain(x, mask, bn, training, relu=False):
    """PointBatchNorm's plain version (the PyTorch composite the kernels
    replace) with the wrapper's signature."""
    from ao_tpu_torch.ops.point_bn import point_batch_norm_plain

    return point_batch_norm_plain(x, mask, bn.weight, bn.bias, bn, training,
                                  relu)[0]


# the band around 0 of a fused ReLU's input, as a share of its terms' size,
# inside which f32 cannot tell its sign: the two sides' statistics differ
# in their last bits (sums in another order), and that moves t by a few
# units of 2^-24 of the terms, times log2 of the rows
BN_UNDECIDED = 2.0 ** -14


def point_bn_grad(x, mask, bn, training, relu=False):
    """The output gradient a hold of PointBatchNorm feeds both sides: drawn
    from a fixed seed, and with the ReLU 0 at the valid rows' elements
    whose input t = (x - mean) rstd w + b (f64 statistics) lies within
    :data:`BN_UNDECIDED` of its terms' size of 0. There either side may
    gate, and one gated element moves dbias by its gradient, far past the
    band of a sum."""
    with torch.inference_mode(False), torch.no_grad():
        gen = torch.Generator(device=x.device).manual_seed(0)
        g = torch.randn(x.shape, generator=gen, device=x.device)
        if relu:
            dims = tuple(range(x.dim() - 1))
            xd = x.double()
            m = (torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
                 if mask is None else mask)[..., None].double()
            n = torch.clamp_min(m.sum(), 1.0)
            if training:
                mean = (xd * m).sum(dims) / n
                var = (((xd - mean) ** 2) * m).sum(dims) / n
            else:
                mean, var = bn.running_mean.double(), bn.running_var.double()
            rstd = torch.rsqrt(var + bn.eps)
            w, b = bn.weight.double(), bn.bias.double()
            t = (xd - mean) * rstd * w + b
            size = ((xd.abs() + (xd.abs() * m).sum(dims) / n + mean.abs())
                    * rstd * w.abs() + b.abs())
            undecided = (t.abs() <= BN_UNDECIDED * size) & (m > 0)
            g = torch.where(undecided, 0.0, g)
            del xd, m, t, size, undecided
        return g.to(x.dtype)


def point_bn_run(fwd, x, mask, bn, training, relu=False, g=None):
    """(y, dx, dweight, dbias, running mean, running var,
    num_batches_tracked, the output gradient) of one forward and backward
    through ``fwd`` (the kernels' wrapper, or :func:`point_bn_plain` under
    autograd) on copies of x, the mask and ``bn``, the output gradient
    ``g`` (:func:`point_bn_grad` where None); the statistics local
    (:func:`_local_comm`)."""
    if g is None:
        g = point_bn_grad(x, mask, bn, training, relu)
    with torch.inference_mode(False), torch.enable_grad(), _local_comm():
        bn = copy.deepcopy(bn)
        xr = x.clone().requires_grad_()
        mask = None if mask is None else mask.clone()
        y = fwd(xr, mask, bn, training, relu)
        y.backward(g)
    return (y.detach(), xr.grad, bn.weight.grad, bn.bias.grad,
            bn.running_mean, bn.running_var, bn.num_batches_tracked, g)


def point_bn_runs(kernel, plain, args):
    """The kernels' and the plain version's forward and backward
    (:func:`point_bn_run`) on ``args``, with one output gradient."""
    g = point_bn_grad(*args)
    return (functools.partial(point_bn_run, kernel, g=g),
            functools.partial(point_bn_run, plain, g=g))


BN_OUTPUTS = ("y", "dx", "dweight", "dbias", "running_mean", "running_var")


def check_point_bn(args, out_k, out_p):
    """PointBatchNorm's kernels against the composite (both through
    :func:`point_bn_run`): an element is off beyond 1e-2 of its tensor's
    scale in bf16 (1e-5 in f32) in y and dx, beyond 1e-4 in the parameter
    gradients and running statistics; a call passes with at most 1e-4 of
    each tensor's elements off (bf16 outputs may differ by a rounding where
    the statistics differ in their last bits, and a fused ReLU's gate with
    them) and num_batches_tracked equal; the note counts the elements whose
    output gradient :func:`point_bn_grad` set to 0. Bound: x read and y
    written forward, x and g read and dx written backward, each once, and
    the mask read twice; about 24 f32 operations an element."""
    x, mask = args[:2]
    tol = 1e-2 if x.dtype == torch.bfloat16 else 1e-5
    ok = int(out_k[6]) == int(out_p[6])
    errs, notes = [], []
    for name, a, b in zip(BN_OUTPUTS, out_k, out_p):
        a, b = a.float(), b.float()
        scale = max(float(b.abs().max()), 1e-6)
        diff = (a - b).abs()
        band = (tol if name in ("y", "dx") else 1e-4) * scale
        ok = ok and float((diff > band).float().mean()) <= 1e-4
        errs.append(float(diff.max()))
        notes.append(f"{name} {errs[-1] / scale:.2g}")
    nbytes = 5 * _nbytes(x) + (0 if mask is None else 2 * _nbytes(mask))
    bound_ms, by = _bound(nbytes, f32_ops=24.0 * x.numel())
    undecided = int((out_p[7] == 0).sum()) if len(args) > 4 and args[4] else 0
    return ok, max(errs), bound_ms, by, None, (
        f"batches {int(out_k[6])}/{int(out_p[6])}; undecided gates "
        f"{undecided}; rel " + " ".join(notes))


def describe(name, args, gathered=False):
    if name == "point_bn":
        x, mask, _, training = args[:4]
        relu = args[4] if len(args) > 4 else False
        valid = "none" if mask is None else f"{float(mask.float().mean()):.3f}"
        return (f"x={tuple(x.shape)} {str(x.dtype)[6:]} valid={valid} "
                f"{'train' if training else 'eval'} relu={relu} "
                f"{'vector' if x.shape[-1] % 8 == 0 else 'scalar'}")
    if name == "fps":
        coord, mask, m = args[:3]
        return (f"B={coord.shape[0]} N={coord.shape[1]} m={m} "
                f"valid={[int(v) for v in mask.sum(1)]}")
    if name == "knn_window":
        keys, _, _, q, _, k, tile_q, window = args
        return (f"B={q.shape[0]} Nq={q.shape[1]} Nk={keys.shape[1]} k={k} "
                f"tile_q={tile_q} window={window}")
    if name == "merge_topk":
        s, _, _, inv, k = args
        return (f"B={inv[0].shape[0]} N={inv[0].shape[1]} probes={len(s)} "
                f"k={k} width={len(s) * k}")
    B, Nq, S, Nsrc, C = _gva_dims(args)
    # the default dispatch's gate (N >= 2048); a run with the slab path off
    # passes ``gathered``
    mode = "slab" if Nsrc >= 2048 and not gathered else "gathered"
    G = (args[4]["W2"].shape[0] if name in ("gva_eval", "gva_bwd")
         else args[8].shape[1] if name == "gva_stats" else None)
    g = f" G={G}" if G else ""
    return f"B={B} N={Nq} S={S} C={C}{g} mode={mode}"


PLAIN = {}  # kernel name -> its plain version, filled by plain_versions()
CHECKS = {"knn_window": check_knn_window, "merge_topk": check_merge_topk,
          "gva_eval": check_gva_eval, "gva_pos": check_gva_pos,
          "gva_stats": check_gva_stats, "gva_bwd": check_gva_bwd,
          "fps": check_fps, "point_bn": check_point_bn}
# kernels held through runs of their wrapper and plain version (forward and
# backward, made from the captured arguments) rather than a call, and the
# names of their device kernels
RUNS = {"point_bn": point_bn_runs}
DEVICE_NAMES = {"point_bn": ("::sum_kernel<", "::sqdev_kernel<",
                             "::norm_kernel<", "::bwd_sums_kernel<",
                             "::bwd_dx_kernel<")}


def plain_versions():
    from ao_tpu_torch.ops import gva as g
    from ao_tpu_torch.ops import knn_spatial as ks
    from ao_tpu_torch.ops import sampling

    PLAIN.update(knn_window=ks.knn_window_plain,
                 merge_topk=ks.merge_topk_probes_plain,
                 gva_eval=g.gva_eval_plain, gva_pos=g.gva_pos_plain,
                 gva_stats=g.gva_stats_plain, gva_bwd=g.gva_bwd_plain,
                 fps=sampling.farthest_point_sampling_plain,
                 point_bn=point_bn_plain)
    return PLAIN


def _device_ms(fn, name, **kw):
    """The kernel's device ms per launch (torch.profiler), or None where the
    profiler recorded no CUDA kernel in any of its traces: on the card's
    machine a trace now and then comes back with no device events at all,
    and a missing device time must not stop the run (``ms``, by CUDA
    events, is measured regardless)."""
    from ao_tpu_torch.utils.devtime import device_ms

    try:
        return device_ms(fn, name, **kw)
    except RuntimeError as e:
        print(f"  device_ms of {name} not measured: {e}", flush=True)
        return None


# timed calls of the kernel and of its plain version (default (10, 3)):
# FPS's plain version runs its m steps as separate launches (seconds at
# 81920 points), and the kernel's steps run in sequence (a tenth of a
# second)
TIMING_REPS = {"fps": (3, 1), "point_bn": (5, 2)}


def hold_captured(cap, phase, gathered=False):
    """Hold each kernel against its plain version on every captured
    (kernel, shape) and time both; raise if one disagrees. ``ms`` is the
    wrapper's time per call (CUDA events around back-to-back calls, host
    work included), ``device_ms`` the kernel's own device time per launch
    (torch.profiler; None where no trace recorded it); a kernel of
    :data:`RUNS` is held and timed through a forward and backward of its
    wrapper and of its plain version. ``gathered``: the run took the
    gathered path at every N (:func:`describe`)."""
    plain = plain_versions()
    rows, failures = [], []
    for key, (name, fn, args) in cap.calls.items():
        reps, plain_reps = TIMING_REPS.get(name, (10, 3))
        kern, ref = fn, plain[name]
        if name in RUNS:
            kern, ref = RUNS[name](kern, ref, args)
        with torch.inference_mode():
            out_k = kern(*args)
            out = []
            # with one timed call, the compared call is the timed one
            first_ms = cuda_ms(lambda: out.append(ref(*args)), reps=1,
                               warmup=0)
            out_p = out[0]
            ok, err, bound_ms, by, lib_ms, note = CHECKS[name](args, out_k, out_p)
            del out_k, out_p, out
            ms = cuda_ms(lambda: kern(*args), reps=reps, warmup=min(reps, 2))
            dev_ms = _device_ms(lambda: kern(*args), DEVICE_NAMES.get(name, name),
                                reps=min(reps, 5), warmup=0)
            plain_ms = first_ms if plain_reps == 1 else cuda_ms(
                lambda: ref(*args), reps=plain_reps, warmup=1)
        row = dict(name=name, phase=phase, shape=describe(name, args, gathered),
                   ok=ok,
                   max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=by, library_ms=lib_ms, note=note)
        rows.append(row)
        print(f"  {name:10s} {row['shape']:46s} ok={ok} err={err:.3g} "
              f"ms={ms:.4f} device_ms={dev_ms} plain_ms={plain_ms:.3f} "
              f"bound_ms={bound_ms:.4f} "
              f"({by}) library_ms={lib_ms} {note}", flush=True)
        if not ok:
            failures.append(f"{name} {row['shape']}")
        torch.cuda.empty_cache()
    cap.calls.clear()
    print(json.dumps({"kernel_shapes": rows}), flush=True)
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return rows


def _require(rows, names, what):
    missing = set(names) - {r["name"] for r in rows}
    if missing:
        raise RuntimeError(f"kernels never called on the {what}: {sorted(missing)}")
    for name in names:
        if name.startswith("gva") and not any(
                r["name"] == name and "mode=gathered" in r["shape"] for r in rows):
            raise RuntimeError(f"{name} was not exercised in its gathered mode")


def kernel_phase(model, batches, t0, device):
    """Run the model once on each (label, coord, feat, mask) batch with the
    kernel wrappers captured, then hold each kernel against its plain
    version on every captured (kernel, shape) and time both."""
    from ao_tpu_torch.ops import knn_spatial as ks
    from ao_tpu_torch.models.point_transformer_v2 import ptv2m2

    cap = Capture()
    cap.wrap(ks, "knn_window", "knn_window")
    cap.wrap(ks, "merge_topk_probes", "merge_topk")
    cap.wrap(ptv2m2, "gva_eval", "gva_eval")
    cap.wrap_path(BN_KERNELS)
    try:
        for label, coord, feat, mask in batches:
            with torch.inference_mode():
                logits = model(coord.to(device), feat.to(device), mask.to(device))
            torch.cuda.synchronize()
            if not torch.isfinite(logits[mask.to(device)]).all():
                raise RuntimeError(f"non-finite logits on the {label}")
            log(t0, f"captured kernel inputs of the {label}, (B, N) "
                    f"{tuple(mask.shape)}, stage capacities "
                    f"{model.backbone.stage_capacities(mask.shape[1])}")
    finally:
        cap.restore()
    rows = hold_captured(cap, "test")
    _require(rows, SLICE_KERNELS, "slice's path")
    return rows


def train_kernel_phase(trainer, batches, t0):
    """One train step on each (label, batch) with every kernel wrapper of the
    train path captured (K1 and K2 at the train batch's own graphs, K3 with
    batch-statistic folds, K4, K5, K6, PointBatchNorm's at each width),
    then each held against its plain version and timed. Every
    PointBatchNorm call of a step must launch its five kernels. Returns
    (rows, PointBatchNorm calls in the first step)."""
    from ao_tpu_torch.ops import gva as gva_mod
    from ao_tpu_torch.ops import knn_spatial as ks
    from ao_tpu_torch.ops.point_bn import point_batch_norm

    cap = Capture().wrap_path(BN_KERNELS)
    cap.wrap(ks, "knn_window", "knn_window")
    cap.wrap(ks, "merge_topk_probes", "merge_topk")
    for name in ("gva_pos", "gva_stats", "gva_eval", "gva_bwd"):
        cap.wrap(gva_mod, name, name)
    bn_calls = []
    try:
        for label, batch in batches:
            calls, launches = cap.counts.get("point_bn", 0), point_batch_norm.launches
            m = trainer.train_step(batch)
            torch.cuda.synchronize()
            if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
                raise RuntimeError(f"non-finite loss or gradient on the {label}")
            calls = cap.counts["point_bn"] - calls
            launches = point_batch_norm.launches - launches
            if launches != 5 * calls:
                raise RuntimeError(f"{calls} PointBatchNorm calls launched "
                                   f"{launches} kernels in a step, not 5 each")
            bn_calls.append(calls)
            log(t0, f"captured train kernel inputs of the {label}, (B, N) "
                    f"{tuple(batch['mask'].shape)}, loss {float(m['loss']):.4f}, "
                    f"PointBatchNorm calls {calls} ({launches} launches)")
    finally:
        cap.restore()
    rows = hold_captured(cap, "train")
    _require(rows, TRAIN_KERNELS, "train path")
    return rows, bn_calls[0]


# PointBatchNorm's cases beside the paths' own calls, each held in train
# and in eval mode: (label, B, rows a scene, C, dtype, mask, relu). The
# benchmark cells' widths at their B=12 (S3DIS bf16 with the ReLU, ScanNet
# f32 masked, as written), the scalar path (edge-level widths 12 and 6 on a
# stage's edges, PT-v2m1's 3), no mask, an all-masked batch.
BN_CASES = (
    [("s3dis", 12, n, c, torch.bfloat16, True, True)
     for n, c in ((81920, 48), (28672, 96), (10035, 192), (3512, 384))]
    + [("scannet", 12, n, c, torch.float32, True, False)
       for n, c in ((102400, 48), (35840, 96), (12544, 192), (4416, 384),
                    (1536, 512))]
    + [("edges", 3, 28672 * 16, 12, torch.bfloat16, True, True),
       ("edges", 3, 10035 * 16, 6, torch.float32, True, True),
       ("width3", 4, 4096, 3, torch.float32, True, True),
       ("nomask", 12, 3512, 384, torch.bfloat16, None, False),
       ("allmasked", 2, 1000, 96, torch.float32, False, True)])


def point_bn_case(seed, B, N, C, dtype, masked, device):
    """(x, mask, bn) of a case: x ~ N(0.3, 1.5^2), 9 rows in 10 valid (no
    mask for None, every row masked for False), a BatchNorm1d with drawn
    weight, bias and running statistics."""
    rng = np.random.default_rng(seed)

    def f(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    x = f(rng.normal(size=(B, N, C)) * 1.5 + 0.3).to(dtype)
    mask = None if masked is None else (
        f(rng.random((B, N)) < 0.9).bool() if masked
        else torch.zeros((B, N), dtype=torch.bool, device=device))
    bn = torch.nn.BatchNorm1d(C).to(device)
    with torch.no_grad():
        bn.weight.copy_(f(rng.normal(1, 0.3, C)))
        bn.bias.copy_(f(rng.normal(0, 0.3, C)))
        bn.running_mean.copy_(f(rng.normal(0, 1, C)))
        bn.running_var.copy_(f(rng.uniform(0.5, 2, C)))
    return x, mask, bn


def point_bn_cases(device, seed, t0):
    """Hold PointBatchNorm's kernels on :data:`BN_CASES` as the paths'
    calls are held (:func:`hold_captured`)."""
    from ao_tpu_torch.ops.point_bn import point_batch_norm

    rows = []
    for i, (label, B, N, C, dtype, masked, relu) in enumerate(BN_CASES):
        x, mask, bn = point_bn_case(seed + i, B, N, C, dtype, masked, device)
        calls = {(i, training): ("point_bn", point_batch_norm,
                                 [x, mask, bn, training, relu])
                 for training in (True, False)}
        rows += hold_captured(type("Cases", (), dict(calls=calls))(),
                              f"point_bn cases: {label}")
        del x, mask, bn, calls
        torch.cuda.empty_cache()
    log(t0, f"PointBatchNorm cases held: {len(rows)}")
    return rows


def main_path_batch(options, fb=8):
    """The forward of the slice phase with the most points: the tester's
    own (B, N) batch of the room's fragments under ``options``, as
    (label, coord, feat, mask) CPU tensors."""
    from ao_tpu_torch.datasets import build_dataset
    from ao_tpu_torch.engines.test import TesterBase
    from ao_tpu_torch.utils import Config, DictAction

    cfg = Config.fromfile(BASE_CONFIG)
    cfg.merge_from_dict({k: DictAction._parse_value(v) for k, v in
                         (o.partition("=")[::2] for o in options)})
    frags = build_dataset(dict(cfg.data.test))[0]["fragment_list"]
    fb = int(cfg.get("test_fragments_per_batch", fb))
    _, batch = max(TesterBase.batches(frags, cfg.get("pad_multiple", 4096), fb),
                   key=lambda gb: gb[1]["mask"].numel())
    return ("slice phase's largest batch", batch["coord"], batch["feat"],
            batch["mask"])


def small_batch(room, n_pad=16384, n_keep=15000):
    """Two pieces of the room's first 0.04 m test fragment (its n_keep
    lowest and n_keep - 1000 highest points in x), padded to n_pad: small
    enough that the deep stages fall below the 2048-point slab gate (the
    gathered GVA and the 3-probe graph), in a batch of two distinct rows."""
    from ao_tpu_torch.datasets.transform import Compose, GridSample

    data = Compose([dict(type="CenterShift", apply_z=True),
                    dict(type="NormalizeColor")])(
        dict(coord=room["coord"].copy(), color=room["color"].copy()))
    frag = GridSample(grid_size=0.04, hash_type="fnv", mode="test",
                      keys=("coord", "color"))(data)[0]
    frag = Compose([dict(type="CenterShift", apply_z=False)])(frag)
    order = np.argsort(frag["coord"][:, 0], kind="stable")
    coord = torch.zeros((2, n_pad, 3))
    feat = torch.zeros((2, n_pad, 6))
    mask = torch.zeros((2, n_pad), dtype=torch.bool)
    for b, rows in enumerate((order[:n_keep], order[-(n_keep - 1000):])):
        c = torch.from_numpy(frag["coord"][rows].astype(np.float32))
        col = torch.from_numpy(frag["color"][rows].astype(np.float32))
        coord[b, : len(rows)] = c
        feat[b, : len(rows)] = torch.cat([c, col], dim=-1)
        mask[b, : len(rows)] = True
    return "small batch", coord, feat, mask


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def slice_setup(room, views=None, pad_multiple=None, workdir=None):
    """Write the room (from :func:`make_room`) under ``workdir`` (a new
    temporary directory by default). Returns (workdir, the entry point's
    KEY=VALUE config overrides for testing it, the number of TTA views)."""
    from ao_tpu_torch.utils import Config

    workdir = workdir or tempfile.mkdtemp(prefix="ao_chip_smoke_")
    room_dir = os.path.join(workdir, "s3dis", "Area_5")
    os.makedirs(room_dir, exist_ok=True)
    np.savez(os.path.join(room_dir, "office_1.npz"), **room)
    cfg = Config.fromfile(BASE_CONFIG)
    options = [f"weight={os.path.join(workdir, 'model.pt')}",
               f"save_path={os.path.join(workdir, 'exp')}",
               f"data.test.data_root={os.path.join(workdir, 's3dis')}"]
    n_views = len(cfg.data.test.test_cfg.aug_transform)
    if views is not None:
        n_views = views
        aug = cfg.data.test.test_cfg.aug_transform[:views]
        options.append(f"data.test.test_cfg.aug_transform={aug!r}")
    if pad_multiple is not None:
        options.append(f"pad_multiple={pad_multiple}")
    return workdir, options, n_views


def run_slice(device, seed=0, room_size=(4.8, 4.0, 2.6), spacing=0.034,
              views=None, pad_multiple=None, workdir=None, model=None,
              setup=None):
    """Whole-scene testing of one synthetic room through the port's entry
    point, on the room of ``setup`` (from :func:`slice_setup`) or a new
    one. Returns (result dict, votes (n, 13), n_views)."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.utils import Config

    workdir, options, n_views = setup or slice_setup(
        make_room(seed, room_size, spacing), views, pad_multiple, workdir)
    if model is None:
        torch.manual_seed(seed)
        model = build_model(dict(Config.fromfile(BASE_CONFIG).model))
    torch.save(model.state_dict(), os.path.join(workdir, "model.pt"))
    result = test_main(["--config-file", BASE_CONFIG, "--device", str(device),
                        "--options", *options])
    votes = np.load(os.path.join(workdir, "exp", "result", "office_1_pred.npy"))
    return result, votes, n_views


def check_votes(votes, n_views, num_classes=13):
    if votes.ndim != 2 or votes.shape[1] != num_classes:
        raise RuntimeError(f"votes of shape {votes.shape}, expected "
                           f"(n, {num_classes})")
    if not np.isfinite(votes).all():
        raise RuntimeError("non-finite votes")
    # every vote is a whole softmax row, and every view's fragments cover
    # every point at least once (points of sparse voxels recur in several
    # complementary fragments)
    total = votes.sum(-1)
    if not (np.abs(total - np.round(total)) < 1e-3).all():
        raise RuntimeError("votes are not sums of whole probability rows")
    if not (total > n_views - 1e-3).all():
        raise RuntimeError("a point missed the vote of some view")


def _by_kernel(events):
    """Device ms and launches of each port kernel in a profile (K6's sums
    pass counts with K6)."""
    out = {}
    for name in KERNEL_INFO:
        hits = [e for e in events if name in e.key]
        out[name] = dict(ms=sum(e.self_device_time_total for e in hits) / 1e3,
                         launches=sum(e.count for e in hits))
    return out


def profile_forward(model, batch, device):
    """Time one eval forward of a (label, coord, feat, mask) batch (CUDA
    events), then trace one with torch.profiler: device time by kernel
    name and the device's busy share of the forward."""
    _, coord, feat, mask = batch
    c, f, m = coord.to(device), feat.to(device), mask.to(device)
    from ao_tpu_torch.utils.devtime import trace

    with torch.inference_mode():
        wall_ms = cuda_ms(lambda: model(c, f, m), reps=3, warmup=1)
        _, device_ms, _, events = trace(lambda: model(c, f, m), warmup=0)
    top = [dict(name=e.key[:60], ms=e.self_device_time_total / 1e3,
                calls=e.count) for e in events[:12]]
    return dict(shape=list(mask.shape), points=int(mask.sum()),
                wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms, top=top,
                port_kernels=_by_kernel(events))


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------


def train_setup(rooms, workdir=None, batch_size=3, max_steps=5, workers=3,
                seed=0, val_room=None):
    """Write the rooms (from :func:`make_room`) as scenes of the S3DIS train
    split under ``workdir`` (a new temporary directory by default), one
    area each, and ``val_room`` as the validation split's one scene.
    Returns (workdir, the train entry point's KEY=VALUE config overrides).
    The validation pipeline is the config's with ``origin_coord`` /
    ``origin_segment`` collected, so that the evaluator scores the
    full-resolution points through the nearest-neighbour re-projection;
    without ``val_room``, evaluation is off. TensorBoard is off."""
    from ao_tpu_torch.utils import Config

    workdir = workdir or tempfile.mkdtemp(prefix="ao_chip_train_")
    for i, room in enumerate(rooms):
        room_dir = os.path.join(workdir, "s3dis", f"Area_{i + 1}")
        os.makedirs(room_dir, exist_ok=True)
        np.savez(os.path.join(room_dir, f"office_{i}.npz"), **room)
    options = [f"save_path={os.path.join(workdir, 'exp')}",
               f"data.train.data_root={os.path.join(workdir, 's3dis')}",
               f"batch_size={batch_size}", f"max_steps={max_steps}",
               f"num_worker={workers}", f"seed={seed}",
               "enable_tensorboard=False"]
    if val_room is None:
        return workdir, options + ["evaluate=False"]
    val_dir = os.path.join(workdir, "s3dis_val", "Area_5")
    os.makedirs(val_dir, exist_ok=True)
    np.savez(os.path.join(val_dir, "office_v.npz"), **val_room)
    transform = [dict(t) for t in Config.fromfile(BASE_CONFIG).data.val.transform]
    collect = next(t for t in transform if t["type"] == "Collect")
    collect["keys"] = tuple(collect["keys"]) + ("origin_coord", "origin_segment")
    return workdir, options + [
        f"data.val.data_root={os.path.join(workdir, 's3dis_val')}",
        f"data.val.transform={transform!r}"]


def build_trainer(options, device, config=BASE_CONFIG):
    from ao_tpu_torch.engines import Trainer, default_config_parser
    from ao_tpu_torch.utils import DictAction

    opts = {k: DictAction._parse_value(v) for k, v in
            (o.partition("=")[::2] for o in options)}
    return Trainer(default_config_parser(config, opts), device=device)


def run_train(device, options, config=BASE_CONFIG, entry="train"):
    """Training on ``config`` through the port's entry point
    ``ao_tpu_torch.tools.<entry>`` (train, train_insseg, train_pretrain);
    returns the trainer."""
    import importlib

    main = importlib.import_module(f"ao_tpu_torch.tools.{entry}").main
    return main(["--config-file", config, "--device", str(device),
                 "--options", *options])


def check_train(trainer, steps):
    """Every step's loss and gradient norm finite, and the parameters moved
    away from the initial weights (rebuilt from the trainer's seed)."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.utils.env import set_seed

    hist = trainer.history
    if len(hist) != steps:
        raise RuntimeError(f"{len(hist)} train steps, expected {steps}")
    for i, r in enumerate(hist):
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise RuntimeError(f"step {i}: non-finite loss or gradient {r}")
    set_seed(trainer.seed)
    init = build_model(dict(trainer.cfg.model)).state_dict()
    params = dict(trainer.model.named_parameters())
    changed = sum(not torch.equal(p.detach().cpu(), init[n])
                  for n, p in params.items())
    if changed < 0.9 * len(params):
        raise RuntimeError(f"only {changed} of {len(params)} parameter tensors "
                           f"changed in training")
    return changed, len(params)


def check_val(trainer):
    """The evaluator ran once, on the validation room's full-resolution
    points, with finite metrics, and the checkpoint saver wrote
    model_last.pt and model_best.pt; returns the evaluator's result."""
    val = trainer.comm_info.get("val_result")
    if val is None or val["batches"] != 1:
        raise RuntimeError(f"the evaluator did not score the validation room: {val}")
    if not all(np.isfinite(val[k]) for k in ("mIoU", "mAcc", "allAcc", "loss")):
        raise RuntimeError(f"non-finite validation metrics {val}")
    for name in ("model_last.pt", "model_best.pt"):
        if not os.path.isfile(os.path.join(trainer.save_path, "model", name)):
            raise RuntimeError(f"the checkpoint saver wrote no {name}")
    return val


class KnnTimer:
    """CUDA events around every exact-kNN call of a model's module (PT-v1's
    layers' knn_query and TransitionDown's knn, Swin3D's downsampling knn),
    each noted as chunked or not (above ``CHUNK_ELEMENTS`` scores
    ops/knn.py takes its chunks of torch.topk); ``ms()`` reads (all,
    chunked) ms after a synchronize."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        import importlib

        self.calls = []
        scores = {"knn": lambda q, k, *a: q.shape[0] * q.shape[1] * k.shape[1],
                  "knn_query": lambda k, c, *a: c.shape[0] * c.shape[1] ** 2}
        self._orig = {n: getattr(self.module, n) for n in scores
                      if hasattr(self.module, n)}
        chunk = importlib.import_module("ao_tpu_torch.ops.knn").CHUNK_ELEMENTS

        def timed(fn, count):
            def call(*args):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = fn(*args)
                e.record()
                self.calls.append((s, e, count(*args) > chunk))
                return out
            return call

        for n, fn in self._orig.items():
            setattr(self.module, n, timed(fn, scores[n]))
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self.module, n, fn)

    def ms(self):
        torch.cuda.synchronize()
        t = [(s.elapsed_time(e), c) for s, e, c in self.calls]
        return sum(x for x, _ in t), sum(x for x, c in t if c)


def profile_train_step(trainer, batch, knn=None, warm=True, traced=True):
    """Time one train step (host clock around a synchronised step, after a
    warm one unless ``warm`` is off: a trainer that has just stepped at
    these shapes), then trace one with torch.profiler unless ``traced`` is
    off: device time by kernel name and the device's busy share of the
    step. With ``knn``, a model's module, the timed step runs under
    :class:`KnnTimer` on it: the exact kNN's calls, ms and share of the
    step."""
    from ao_tpu_torch.utils.devtime import trace

    if warm:
        trainer.train_step(batch)
    torch.cuda.synchronize()
    with KnnTimer(knn) as timer:
        t = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rec = dict(shape=list(batch["mask"].shape),
               points=int(batch["mask"].sum()), wall_ms=wall_ms)
    if traced:
        _, device_ms, _, events = trace(lambda: trainer.train_step(batch),
                                        warmup=0)
        rec.update(device_ms=device_ms, busy_share=device_ms / wall_ms,
                   top=[dict(name=e.key[:60], ms=e.self_device_time_total / 1e3,
                             calls=e.count) for e in events[:15]],
                   port_kernels=_by_kernel(events))
    if knn is not None:
        knn_ms, chunked_ms = timer.ms()
        rec.update(knn_calls=len(timer.calls),
                   chunked_calls=sum(c for *_, c in timer.calls),
                   knn_ms=knn_ms, chunked_ms=chunked_ms,
                   share=knn_ms / wall_ms, chunked_share=chunked_ms / wall_ms)
    return rec


# ---------------------------------------------------------------------------
# AO phase: PP2S, REAL, the neural SAM
# ---------------------------------------------------------------------------


def check_pp2s(workdir, rooms, n_frames):
    """Every PP2S stage wrote its files for every ``(area, room)``: the
    rendered rgb / depth / pose and the frame list, the oracle id maps, at
    least one bridge, the weak labels, the SAM labels and the room's row
    of the basket."""
    from ao_tpu_torch.pp2s import load_basket

    basket = load_basket(os.path.join(workdir, "basket_s3dis.pickle"))
    for area, room in rooms:
        data = os.path.join(workdir, "S2D3D", area, "data")
        frames = [f"camera_render{v:02d}_{room}_rgb" for v in range(n_frames)]
        want = [os.path.join(data, "rgb", f + ".png") for f in frames]
        want += [os.path.join(data, "depth", f.replace("rgb", "depth") + ".png")
                 for f in frames]
        want += [os.path.join(data, "pose", f.replace("rgb", "pose") + ".json")
                 for f in frames]
        want += [os.path.join(workdir, "embeddings", area, room, f + ".npz")
                 for f in frames]
        want += [os.path.join(workdir, "used_imgs", area, room + ".txt")]
        want += [os.path.join(workdir, d, area, room + ".npy")
                 for d in ("weak_labels", "sam_labels")]
        missing = [w for w in want if not os.path.isfile(w)]
        bridges = os.path.join(workdir, "bridge", area, room)
        if not os.path.isdir(bridges) or not os.listdir(bridges):
            missing.append(bridges + "/*.npy")
        if f"{area}/{room}" not in basket:
            missing.append(f"basket row {area}/{room}")
        if missing:
            raise RuntimeError(f"PP2S wrote no {missing}")


def real_setup(rooms, val_room, workdir=None, size=512, views=6,
               batch_size=3, max_steps=3, workers=3, seed=0, device="cuda"):
    """Write the rooms (from :func:`make_room`) as S3DIS train scenes, one
    area each, and ``val_room`` as the validation scene (as
    :func:`train_setup`), then run the port's PP2S CLI on the train rooms
    in oracle mode: render_frames (``views`` ring views and 2 vertical ones
    of ``size``^2 pixels), then all, with the proxy's 0.02 m depth test.
    Returns (workdir, the REAL entry point's KEY=VALUE overrides, the
    stages' seconds, the PP2S labels' metrics)."""
    from ao_tpu_torch.engines.label_eval import get_miou
    from ao_tpu_torch.tools.pp2s import main as pp2s_main

    workdir, options = train_setup(rooms, workdir, batch_size, max_steps,
                                   workers, seed, val_room)
    areas = [f"Area_{i + 1}" for i in range(len(rooms))]
    common = ["--data-root", workdir, "--sam-oracle", "--frame-size",
              str(size), "--bridge-depth-thresh", "0.02", "--areas", *areas,
              "--device", str(device)]
    seconds = dict(pp2s_main(common + ["--stage", "render_frames",
                                       "--render-views", str(views)]).stage_seconds)
    seconds.update(pp2s_main(common + ["--stage", "all"]).stage_seconds)
    check_pp2s(workdir, [(a, f"office_{i}") for i, a in enumerate(areas)],
               views + 2)
    labels = get_miou(os.path.join(workdir, "sam_labels"),
                      os.path.join(workdir, "s3dis"), 13, areas=areas)
    # random weights: their top1 - top2 confidence rarely passes the
    # config's 0.7, so a low bar lets prompts be mined and masks decoded
    # (as the JAX package's REAL test does with 0.05)
    real = dict(initial_labels=os.path.join(workdir, "sam_labels"),
                basket=os.path.join(workdir, "basket_s3dis.pickle"),
                data_root=os.path.join(workdir, "s3dis"),
                bridge_root=os.path.join(workdir, "bridge"),
                embedding_root=os.path.join(workdir, "embeddings"),
                frame_size=(size, size), conf_thresh=0.05,
                eval_areas=tuple(areas))
    options = options + ["weight=None"] + [
        f"real.{k}={v!r}" for k, v in real.items()]
    return workdir, options, seconds, labels


def run_real(device, options):
    """REAL training through the port's entry point. Each refinement
    round's basket is recorded before refinement (and the reset), and the
    rows each step sampled, by scene. Returns (trainer, record)."""
    from ao_tpu_torch.engines import train_real
    from ao_tpu_torch.tools.train_real import main as real_main

    cls = train_real.RealTrainer
    record = dict(sampled={}, baskets=[], shapes=[])
    fill, refine = cls.fill_basket, cls.refine_labels

    def fill_rec(self, batch, logits):
        fill(self, batch, logits)
        record["shapes"].append(tuple(batch["mask"].shape))
        for b, name in enumerate(batch["extras"]["scene_id"]):
            rows = batch["instance"][b][batch["mask"][b]].numpy()
            record["sampled"].setdefault(self._scene_key(name), []).append(rows)

    def refine_rec(self, basket):
        record["baskets"].append({k: v.copy() for k, v in basket.items()})
        refine(self, basket)

    cls.fill_basket, cls.refine_labels = fill_rec, refine_rec
    try:
        trainer = real_main(["--config-file", REAL_CONFIG,
                             "--device", str(device), "--options", *options])
    finally:
        cls.fill_basket, cls.refine_labels = fill, refine
    return trainer, record


def check_real(trainer, record, initial_labels):
    """One refinement round ran: the basket held finite logits at exactly
    the rows the steps sampled, prompts were mined, masks decoded and label
    files rewritten, the sam_label metrics are finite, and the basket was
    reset. Returns the round's record."""
    if len(trainer.refine_history) != 1 or len(record["baskets"]) != 1:
        raise RuntimeError(f"{len(trainer.refine_history)} refinement rounds, "
                           f"expected 1")
    basket = record["baskets"][0]
    if not record["sampled"]:
        raise RuntimeError("no step filled the basket")
    for key, logits in basket.items():
        filled = np.where(logits[:, 0] != -100)[0]
        rows = np.unique(np.concatenate(record["sampled"].get(key, [[]])))
        if not np.array_equal(filled, rows.astype(filled.dtype)):
            raise RuntimeError(f"basket {key}: {len(filled)} rows filled, "
                               f"{len(rows)} sampled")
        if not np.isfinite(logits[filled]).all():
            raise RuntimeError(f"basket {key}: non-finite logits")
    r = trainer.refine_history[0]
    if r["prompts"] <= 0 or r["masks"] <= 0 or r["num_updated"] <= 0:
        raise RuntimeError(f"refinement mined, decoded or updated nothing: {r}")
    rewritten = 0
    for d, _, names in os.walk(initial_labels):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), initial_labels)
            rewritten += not np.array_equal(
                np.load(os.path.join(d, n)),
                np.load(os.path.join(trainer.labels_dir, rel)))
    if rewritten == 0:
        raise RuntimeError("no label file was rewritten")
    if not all(np.isfinite(r[k]) for k in ("mIoU", "mPre", "mRec",
                                           "prompt_accuracy")):
        raise RuntimeError(f"non-finite sam_label metrics {r}")
    if not all((v == -100).all() for v in trainer.basket.values()):
        raise RuntimeError("the basket was not reset after refinement")
    return dict(r, labels_rewritten=rewritten)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device, out):
    """``fn`` wrapped to append its milliseconds (CUDA events on the card,
    the host clock elsewhere) to ``out``."""
    def run(*args, **kw):
        if torch.device(device).type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            res = fn(*args, **kw)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            res = fn(*args, **kw)
            out.append((time.perf_counter() - t) * 1e3)
        return res
    return run


def run_sam(workdir, basket, device, model_type="vit_h", size=512):
    """The neural SAM of ``model_type``, built on the device from its seed:
    ``set_image`` of two rendered frames of the room with the most
    logits in ``basket`` (timed after a warm-up), then one refinement of
    that room (``_refine_one_scene``) with the neural predictor on those
    embeddings and the room's logits, which drives ``predict_batch`` at the
    loop's bucketed shapes. Fails on non-finite embeddings, IoU
    predictions or mask logits. Returns a summary."""
    import shutil

    from PIL import Image

    from ao_tpu_torch.engines.train_real import _refine_one_scene
    from ao_tpu_torch.models.sam import SamConfig, SamPredictor

    key = max(basket, key=lambda k: int((basket[k][:, 0] != -100).sum()))
    area, room = key.split("/")
    predictor = SamPredictor(getattr(SamConfig, model_type)(), device=device)
    t = time.perf_counter()
    model = predictor._ensure_model()
    _sync(device)
    build_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    rgb_dir = os.path.join(workdir, "S2D3D", area, "data", "rgb")
    names = sorted(f for f in os.listdir(rgb_dir) if f"_{room}_" in f)[:2]
    images = [np.asarray(Image.open(os.path.join(rgb_dir, n)))[..., :3]
              for n in names]
    predictor.set_image(images[0])  # warm-up
    _sync(device)
    embed_ms = []
    set_image = _timed(predictor.set_image, device, embed_ms)
    emb_root = os.path.join(workdir, "embeddings_sam")
    os.makedirs(os.path.join(emb_root, area, room), exist_ok=True)
    for name, image in zip(names, images):
        feats = set_image(image)
        if not torch.isfinite(feats).all():
            raise RuntimeError(f"non-finite SAM embeddings of {name}")
        np.savez(os.path.join(emb_root, area, room,
                              os.path.splitext(name)[0] + ".npz"),
                 features=feats[0].cpu().numpy())

    decode_ms, call_ms, shapes = [], [], []
    decode = predictor._decode

    def checked_decode(features, pts, lbl):
        low_res, iou = decode(features, pts, lbl)
        shapes.append(tuple(pts.shape[:2]))
        if not (torch.isfinite(low_res).all() and torch.isfinite(iou).all()):
            raise RuntimeError("non-finite SAM mask logits or IoU predictions")
        return low_res, iou

    predictor._decode = _timed(checked_decode, device, decode_ms)
    predictor.predict_batch = _timed(predictor.predict_batch, device, call_ms)
    labels_dir = os.path.join(workdir, "sam_labels_sam")
    shutil.rmtree(labels_dir, ignore_errors=True)
    shutil.copytree(os.path.join(workdir, "sam_labels"), labels_dir)
    cfg = dict(labels_dir=labels_dir, data_root=os.path.join(workdir, "s3dis"),
               bridge_root=os.path.join(workdir, "bridge"),
               embedding_root=emb_root, frame_size=(size, size),
               grid_scale=0.5, prompt_search="grid", conf_thresh=0.05,
               radius_scale=0.33, sam_frame_batch=4,
               num_classes=13, vote_min_fill=1, vote_min_overwrite=1)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    updated, accuracy, prompts, masks = _refine_one_scene(
        (cfg, predictor, key, basket[key]))
    refine_s = time.perf_counter() - t
    if not decode_ms:
        raise RuntimeError("the refinement decoded no SAM masks")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if torch.device(device).type == "cuda" else None)
    return dict(model=model_type, scene=key, params=n_params, build_s=build_s,
                frames=len(names), set_image_ms=embed_ms,
                decode_ms=decode_ms, predict_batch_ms=call_ms,
                shapes_FP=shapes, prompts=prompts, masks=masks,
                updated=updated, prompt_accuracy=accuracy,
                refine_s=refine_s, peak_gib=peak)


# ---------------------------------------------------------------------------
# ScanNet phase: the ScanNet PT-v2m2 config (S=8 patch embed, C=512 stage)
# ---------------------------------------------------------------------------

# (make_room seed, room size in m) of the ScanNet phase's train rooms: at
# 0.03 m spacing 170k-200k points each, so that after the train transforms
# (RandomDropout, RandomScale down to 0.9, GridSample at 0.02 m) SphereCrop
# keeps 100000 points and a batch pads to the config's max_points = 102400
SCANNET_ROOMS = ((11, (6.0, 5.0, 3.0)), (12, (6.4, 4.8, 3.0)),
                 (13, (5.6, 5.4, 3.2)), (14, (5.2, 5.0, 3.0)))
SCANNET_TEST_ROOM = (15, (4.8, 4.0, 2.6))
SCANNET_SPACING = 0.03
# The ScanNet config as written computes in f32, so in both packages its
# attention takes the unfused path (ao_tpu's _fused_gva_ok and the port's
# fused_ok want bf16) and only K1 and K2 run; with the S3DIS config's
# bf16 compute every stage goes to the fused kernels K3-K6, the path this
# phase holds
SCANNET_BF16 = ("model.backbone.compute_dtype=bfloat16",)
# ScanNet's 20 classes for the synthetic room's 13 (S3DIS order): ceiling
# and beam are unlabelled in ScanNet (-1), a column is wall, a board a
# picture, clutter otherfurniture
_SCANNET20 = np.array([-1, 1, 0, -1, 0, 8, 7, 6, 4, 5, 9, 10, 19], np.int64)


def scannet_normals(coord, k=10):
    """Unit normals of a neighbourhood fit: the direction of least variance
    of each point's k nearest points, turned to face the room's centre
    (deterministic, no random draw)."""
    from scipy.spatial import cKDTree

    _, nn = cKDTree(coord).query(coord, k=k)
    nb = coord[nn] - coord[nn].mean(1, keepdims=True)
    _, vec = np.linalg.eigh(np.einsum("nki,nkj->nij", nb, nb))
    normal = vec[:, :, 0]
    flip = np.einsum("ni,ni->n", normal, coord.mean(0) - coord) < 0
    normal[flip] = -normal[flip]
    return normal.astype(np.float32)


def make_scannet_room(seed, size, spacing=SCANNET_SPACING):
    """A synthetic room in ScanNet's preprocessed layout, from
    :func:`make_room`'s geometry and draws: coord, color, normal,
    semantic_gt20 (ScanNet's 20 classes, -1 unlabelled), instance_gt."""
    room = make_room(seed, size, spacing)
    return dict(coord=room["coord"], color=room["color"],
                normal=scannet_normals(room["coord"]),
                semantic_gt20=_SCANNET20[room["semantic_gt"].reshape(-1)],
                instance_gt=room["instance_gt"].reshape(-1))


def scannet_setup(rooms, test_room=None, workdir=None, batch_size=4,
                  max_steps=3, workers=3, seed=0):
    """Write the rooms (from :func:`make_scannet_room`) as ScanNet train
    scenes (``.pth``) and ``test_room`` as the val split's one scene, under
    ``workdir`` (a new temporary directory by default). Returns (workdir,
    the train entry point's KEY=VALUE overrides of the ScanNet config:
    enough loops of the train scenes for ``max_steps`` in one epoch,
    evaluation and TensorBoard off)."""
    workdir = workdir or tempfile.mkdtemp(prefix="ao_chip_scannet_")
    root = os.path.join(workdir, "scannet")
    # the train scenes loop so that the run's steps fit in one epoch
    loop = -(-batch_size * max_steps // len(rooms))
    for split, scenes in (("train", rooms), ("val", [test_room] if test_room else [])):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i, room in enumerate(scenes):
            torch.save(room, os.path.join(root, split, f"scene{i:04d}_00.pth"))
    options = [f"save_path={os.path.join(workdir, 'exp')}",
               f"data.train.data_root={root}", f"batch_size={batch_size}",
               f"max_steps={max_steps}", f"num_worker={workers}",
               f"seed={seed}", f"data.train.loop={loop}", "evaluate=False",
               "enable_tensorboard=False"]
    return workdir, options


def run_scannet_test(device, model, workdir, options=()):
    """Whole-scene testing of the val room written by :func:`scannet_setup`
    through the port's entry point with the ScanNet config's test_cfg (no
    crop, 10 TTA views: anisotropic RandomScale, then with RandomFlip(p=1);
    GridSample at 0.02 m in test mode), with ``model``'s weights and the
    KEY=VALUE ``options``. Returns (result dict, votes, views)."""
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.utils import Config

    torch.save(model.state_dict(), os.path.join(workdir, "model.pt"))
    result = test_main([
        "--config-file", SCANNET_CONFIG, "--device", str(device), "--options",
        f"weight={os.path.join(workdir, 'model.pt')}",
        f"save_path={os.path.join(workdir, 'exp_test')}",
        f"data.test.data_root={os.path.join(workdir, 'scannet')}", *options])
    votes = np.load(os.path.join(workdir, "exp_test", "result",
                                 "scene0000_00_pred.npy"))
    views = len(Config.fromfile(SCANNET_CONFIG).data.test.test_cfg.aug_transform)
    return result, votes, views


def run_scannet_train(device, options):
    """Training on the ScanNet config through the port's entry point."""
    from ao_tpu_torch.tools.train import main as train_main

    return train_main(["--config-file", SCANNET_CONFIG, "--device", str(device),
                       "--options", *options])


def check_scannet_train(trainer, steps):
    """Every step's loss and gradient norm finite; each step's lr is
    OneCycle's (the config's max_lr, pct_start, div factors over the run's
    total steps) to 1e-12 relative; returns the steps whose batch Mix3D
    merged (fewer scenes than the batch size)."""
    from ao_tpu_torch.utils.scheduler import onecycle_lr

    hist, sched = trainer.history, trainer.cfg.scheduler
    if len(hist) != steps:
        raise RuntimeError(f"{len(hist)} ScanNet train steps, expected {steps}")
    for i, r in enumerate(hist):
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise RuntimeError(f"ScanNet step {i}: non-finite loss or gradient {r}")
        lr = onecycle_lr(i, trainer.total_steps, sched.max_lr, sched.pct_start,
                         sched.div_factor, sched.final_div_factor)
        if abs(r["lr"] - lr) > 1e-12 * lr:
            raise RuntimeError(f"ScanNet step {i}: lr {r['lr']} is not "
                               f"OneCycle's {lr}")
    return [i for i, r in enumerate(hist) if r["scenes"] < trainer.cfg.batch_size]


def instance_of(name, args):
    """The new instance of the ScanNet config a kernel call runs, or None:
    K1 at k=8, a GVA kernel at S=8 (the patch embed) or at C=512."""
    if name == "knn_window":
        return "k=8" if args[5] == 8 else None
    qrow, idx = args[1], args[2]
    if idx.shape[-1] == 8:
        return "S=8"
    return "C=512" if qrow.shape[-1] - 7 == 512 else None


class InstanceLaunches:
    """While active, counts the calls on CUDA tensors of each new instance
    (:func:`instance_of`), each of which launches its kernel once. A
    wrapper counts its launches on its module's attribute, which is a shim
    while this is active; after every call the shims' counts move to the
    wrappers' own, so these count as they would without the shims
    (:func:`_wrappers` reads them through the shims)."""

    def __init__(self):
        self.counts = {}
        self._undo = []

    def _flush(self):
        for module, attr, fn in self._undo:
            shim = getattr(module, attr)
            fn.launches += shim.launches
            shim.launches = 0

    def __enter__(self):
        from ao_tpu_torch.models.point_transformer_v2 import ptv2m2
        from ao_tpu_torch.ops import gva
        from ao_tpu_torch.ops import knn_spatial as ks

        for module, attr in ((ks, "knn_window"), (ptv2m2, "gva_eval"),
                             (gva, "gva_eval"), (gva, "gva_pos"),
                             (gva, "gva_stats"), (gva, "gva_bwd")):
            fn = getattr(module, attr)

            def rec(*args, _fn=fn, _name=attr):
                inst = instance_of(_name, args)
                if inst is not None and args[0].is_cuda:
                    key = f"{_name}[{inst}]"
                    self.counts[key] = self.counts.get(key, 0) + 1
                try:
                    return _fn(*args)
                finally:
                    self._flush()

            rec.__wrapped__ = fn
            rec.launches = 0
            setattr(module, attr, rec)
            self._undo.append((module, attr, fn))
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()


def scannet_kernel_phase(trainer, batch, t0):
    """One ScanNet train step with every kernel wrapper captured, then the
    calls of the config's new instances (:func:`instance_of`) held against
    their plain versions and timed, on the path's own arguments."""
    from ao_tpu_torch.ops import gva as gva_mod
    from ao_tpu_torch.ops import knn_spatial as ks

    cap = Capture()
    cap.wrap(ks, "knn_window", "knn_window")
    for name in ("gva_pos", "gva_stats", "gva_eval", "gva_bwd"):
        cap.wrap(gva_mod, name, name)
    try:
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
    finally:
        cap.restore()
    if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
        raise RuntimeError("non-finite loss or gradient on the ScanNet batch")
    log(t0, f"captured ScanNet train kernel inputs, (B, N) "
            f"{tuple(batch['mask'].shape)}, loss {float(m['loss']):.4f}")
    cap.calls = {key: call for key, call in cap.calls.items()
                 if instance_of(call[0], call[2]) is not None}
    names = [f"{name}[{instance_of(name, args)}]"
             for name, _, args in cap.calls.values()]
    rows = hold_captured(cap, "scannet")
    for r, name in zip(rows, names):
        r["instance"] = name
    want = {"knn_window[k=8]", "gva_eval[S=8]", "gva_pos[S=8]",
            "gva_stats[S=8]", "gva_bwd[S=8]", "gva_eval[C=512]",
            "gva_stats[C=512]", "gva_bwd[C=512]"}
    missing = want - {r["instance"] for r in rows}
    if missing:
        raise RuntimeError(f"new instances never called: {sorted(missing)}")
    return rows


def scannet_phase(device, seed, t0, card="", batch_size=4, steps=3,
                  test=True, extra=SCANNET_BF16, workdir=None):
    """The ScanNet PT-v2m2 config at full width with the KEY=VALUE
    overrides ``extra`` (by default bf16 compute): whole-scene testing of a
    synthetic room (10 TTA views), the new kernel instances held against
    their plain versions, then ``steps`` train steps at ``batch_size``
    through the port's entry point (Mix3D at the config's mix_prob,
    OneCycle); the test and the train run each driven with the launch
    counts set to 0 just before and read just after (with f32 compute the
    train run needs only K1 and K2). Returns (kernel rows, launches by
    path, instance launches by path, launches per train step, instance
    launches per train step)."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.utils import Config, DictAction

    t_phase = time.perf_counter()
    rooms = [make_scannet_room(s, size) for s, size in SCANNET_ROOMS]
    test_room = make_scannet_room(*SCANNET_TEST_ROOM)
    workdir, options = scannet_setup(rooms, test_room, workdir,
                                     batch_size=batch_size, max_steps=steps,
                                     seed=seed)
    options += list(extra)
    log(t0, f"ScanNet rooms: {[len(r['coord']) for r in rooms]} train, "
            f"{len(test_room['coord'])} test points")
    launches, inst, rows = {}, {}, []
    if test:
        cfg = Config.fromfile(SCANNET_CONFIG)
        cfg.merge_from_dict({k: DictAction._parse_value(v) for k, v in
                             (o.partition("=")[::2] for o in extra)})
        torch.manual_seed(seed)
        model = build_model(dict(cfg.model)).to(device).eval()
        with InstanceLaunches() as il:
            (result, votes, views), launches["scannet_test"] = _drive(
                SLICE_KERNELS, lambda: run_scannet_test(device, model, workdir,
                                                        extra))
        inst["scannet_test"] = dict(il.counts)
        check_votes(votes, views, num_classes=20)
        scene = result["scenes"][0]
        print(f"scannet test: {scene['fragments']} fragments in batches (B, N) "
              f"{scene['batches']}; scene {scene['seconds']:.2f} s; launches "
              f"{launches['scannet_test']}, new instances "
              f"{inst['scannet_test']}; mIoU {result['mIoU']:.4f} (random "
              f"weights)", flush=True)
        del model
        torch.cuda.empty_cache()
        log(t0, "ScanNet test done")

        trainer = build_trainer(options + [
            f"save_path={os.path.join(workdir, 'exp_kernels')}"], device,
            SCANNET_CONFIG)
        it = iter(trainer.train_loader)
        batch = next(it)
        del it
        rows = scannet_kernel_phase(trainer, batch, t0)
        del trainer
        torch.cuda.empty_cache()
        log(t0, "ScanNet kernel phase done")

    torch.cuda.reset_peak_memory_stats()
    fused = "compute_dtype=bfloat16" in " ".join(extra)
    with StepLaunches() as step_count, InstanceLaunches() as il:
        trainer, launches["scannet_train"] = _drive(
            TRAIN_KERNELS if fused else GRAPH_BN_KERNELS,
            lambda: run_scannet_train(device, options))
    inst["scannet_train"] = dict(il.counts)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    mixed = check_scannet_train(trainer, steps)
    hist = trainer.history
    print(f"scannet train ({' '.join(extra) or 'the config as written'}): "
          f"batch {batch_size}, scenes/step {[r['scenes'] for r in hist]} "
          f"points/step {[r['points'] for r in hist]}; Mix3D merged steps "
          f"{mixed} ({len(mixed)} of {steps}); lr {[r['lr'] for r in hist]} "
          f"(OneCycle over {trainer.total_steps} steps)", flush=True)
    print(f"scannet train: losses {[round(r['loss'], 5) for r in hist]} "
          f"grad_norms {[round(r['grad_norm'], 4) for r in hist]} "
          f"pool_overflow {[r['pool_overflow'] for r in hist]}", flush=True)
    step_s = [r["step_seconds"] for r in hist]
    print(f"scannet train: step seconds {[round(x, 4) for x in step_s]} "
          f"(median of steps 2-{steps}: {np.median(step_s[1:]):.4f} s), data "
          f"wait {[round(r['data_seconds'], 4) for r in hist]}; peak memory "
          f"{peak_gb:.2f} GiB; launches per step {step_count.per_step()}, "
          f"new instances {inst['scannet_train']} ({steps} steps); card "
          f"{card}", flush=True)
    if not mixed and batch_size % 2 == 0 and trainer.cfg.get("mix_prob", 0) > 0:
        raise RuntimeError("no ScanNet train step was mixed by Mix3D")
    per_step_inst = {k: v / steps for k, v in inst["scannet_train"].items()}
    del trainer
    torch.cuda.empty_cache()
    log(t0, f"ScanNet phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, inst, step_count.per_step(), per_step_inst


# ---------------------------------------------------------------------------
# phase 8: synthetic LiDAR scans (SemanticKITTI, nuScenes)
# ---------------------------------------------------------------------------

KITTI_CONFIG = os.path.join(ROOT, "configs", "semantic_kitti",
                            "semseg-pt-v2m2-0-base.py")
KITTI_SUBMIT_CONFIG = os.path.join(ROOT, "configs", "semantic_kitti",
                                   "semseg-pt-v2m2-1-benchmark-submit.py")
NUSCENES_SUBMIT_CONFIG = os.path.join(ROOT, "configs", "nuscenes",
                                      "semseg-pt-v2m2-1-benchmark-submit.py")
PTV2M1_CONFIG = os.path.join(ROOT, "configs", "s3dis", "semseg-pt-v2m1-0-base.py")
# the sensor rings: HDL-64E (SemanticKITTI) and HDL-32E (nuScenes); sensor
# height above the ground plane in m
KITTI_RING = dict(beams=64, steps=2048, elevation=(-24.8, 2.0))
NUSCENES_RING = dict(beams=32, steps=1084, elevation=(-30.67, 10.67))
SENSOR_HEIGHT = 1.73
# SemanticKITTI raw ids of the scan model's surfaces: road, sidewalk,
# terrain, car, truck, person, building, fence, vegetation, trunk, pole,
# traffic-sign; and the nuScenes lidarseg raw class of each
_KITTI_IDS = dict(road=40, sidewalk=48, terrain=72, car=10, truck=18,
                  person=30, building=50, fence=51, vegetation=70, trunk=71,
                  pole=80, sign=81)
_NUSCENES_OF_KITTI = {40: 24, 48: 26, 72: 27, 10: 17, 18: 23, 30: 2, 50: 28,
                      51: 9, 70: 30, 71: 30, 80: 28, 81: 28}


def _street(rng):
    """The scan model's objects, placed from ``rng`` along a street on the
    x axis: axis-aligned boxes (lo, hi, raw id, instance) for cars, trucks,
    buildings, fences, bushes, tree crowns and signs, and vertical
    cylinders (cx, cy, radius, z0, z1, raw id, instance) for people, trunks
    and poles; z is relative to the sensor (ground at -SENSOR_HEIGHT)."""
    g = -SENSOR_HEIGHT
    ids = _KITTI_IDS
    boxes, cyls = [], []
    inst = iter(range(1, 1 << 16))
    for _ in range(int(rng.integers(14, 20))):  # cars, trucks: road, parking
        truck = rng.random() < 0.15
        L, W, H = (7.5, 2.5, 3.2) if truck else (4.3, 1.8, 1.5)
        x = rng.uniform(-45, 45)
        y = rng.choice([-5.2, -1.8, 1.8, 5.2]) + rng.uniform(-0.3, 0.3)
        if abs(x) < 5 and abs(y) < 3:
            continue  # not on the sensor
        boxes.append(((x - L / 2, y - W / 2, g), (x + L / 2, y + W / 2, g + H),
                      ids["truck" if truck else "car"], next(inst)))
    for side in (-1, 1):  # buildings behind a fence, bushes in front
        x = -60.0
        while x < 60:
            L = rng.uniform(8, 20)
            y0 = side * rng.uniform(12, 16)
            D = rng.uniform(8, 14)
            lo_y, hi_y = sorted((y0, y0 + side * D))
            boxes.append(((x, lo_y, g), (x + L, hi_y, g + rng.uniform(6, 16)),
                          ids["building"], 0))
            x += L + rng.uniform(2, 6)
        fy = side * 10.5
        boxes.append(((-50, min(fy, fy + side * 0.1), g),
                      (50, max(fy, fy + side * 0.1), g + 1.2), ids["fence"], 0))
        for x in rng.uniform(-50, 50, 10):  # bushes
            y = side * rng.uniform(8, 10)
            boxes.append(((x - 1, y - 0.8, g), (x + 1, y + 0.8, g + 1.0),
                          ids["vegetation"], 0))
        for x in np.arange(-48.0, 50.0, 9.0) + rng.uniform(-1, 1):  # trees
            y = side * 7.5
            cyls.append((x, y, 0.18, g, g + 3.0, ids["trunk"], 0))
            boxes.append(((x - 1.8, y - 1.8, g + 3.0), (x + 1.8, y + 1.8, g + 6.5),
                          ids["vegetation"], 0))
        for x in np.arange(-44.0, 50.0, 18.0) + rng.uniform(-1, 1):  # poles
            y = side * 6.6
            cyls.append((x, y, 0.1, g, g + 5.0, ids["pole"], 0))
            boxes.append(((x - 0.3, y - 0.05, g + 3.0), (x + 0.3, y + 0.05, g + 3.8),
                          ids["sign"], 0))
    for _ in range(int(rng.integers(4, 9))):  # people on the sidewalks
        x, y = rng.uniform(-30, 30), rng.choice([-1, 1]) * rng.uniform(5.8, 6.8)
        cyls.append((x, y, 0.3, g, g + 1.75, ids["person"], next(inst)))
    return boxes, cyls


def _ground_id(x, y):
    ids = _KITTI_IDS
    a = np.abs(y)
    return np.where(a < 4.0, ids["road"], np.where(a < 7.0, ids["sidewalk"],
                                                   ids["terrain"]))


def make_scan(seed, beams=64, steps=2048, elevation=(-24.8, 2.0),
              max_range=80.0):
    """One synthetic LiDAR sweep of a street (:func:`_street`), cast from a
    sensor ``SENSOR_HEIGHT`` m above a ground plane: ``beams`` rings at
    elevations evenly spread over ``elevation`` (degrees) and ``steps``
    azimuth steps a turn. Each ray takes its first hit (the ground, a box
    or a cylinder) within ``max_range``; rays that hit nothing are dropped.
    Returns coord (n, 3) f32 with 1 cm range noise, intensity (n,) f32 in
    [0, 1), label (n,) uint32 (the SemanticKITTI raw id of the surface hit
    in the low 16 bits, its instance in the high 16) and ring (n,). A
    64 x 2048 sweep keeps about 120k points, as a real HDL-64E scan."""
    rng = np.random.default_rng(seed)
    boxes, cyls = _street(rng)
    az = (np.arange(steps) + rng.uniform()) * (2 * np.pi / steps)
    el = np.deg2rad(np.linspace(elevation[0], elevation[1], beams))
    ring = np.repeat(np.arange(beams), steps)
    az = np.tile(az, beams) + rng.normal(0, 2e-4, beams * steps)
    el = el[ring]
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).astype(np.float32)
    t = np.full(len(d), np.inf, np.float32)
    label = np.zeros(len(d), np.uint32)
    with np.errstate(divide="ignore", invalid="ignore"):
        tg = np.where(d[:, 2] < 0, -SENSOR_HEIGHT / d[:, 2], np.inf)
    hit = tg < t
    t[hit] = tg[hit]
    label[hit] = _ground_id(*(tg[hit, None] * d[hit, :2]).T)
    inv = 1.0 / np.where(d == 0, 1e-12, d)
    for lo, hi, raw, inst in boxes:  # slab test
        lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
        t0, t1 = lo * inv, hi * inv
        tn = np.minimum(t0, t1).max(1)
        tf = np.maximum(t0, t1).min(1)
        hit = (tn <= tf) & (tn > 0) & (tn < t)
        t[hit] = tn[hit]
        label[hit] = (inst << 16) | raw
    a = (d[:, :2] ** 2).sum(1)
    for cx, cy, r, z0, z1, raw, inst in cyls:
        b = d[:, 0] * cx + d[:, 1] * cy
        disc = b * b - a * (cx * cx + cy * cy - r * r)
        with np.errstate(invalid="ignore"):
            tc = (b - np.sqrt(disc)) / a
        z = tc * d[:, 2]
        hit = (disc > 0) & (tc > 0) & (tc < t) & (z >= z0) & (z <= z1)
        t[hit] = tc[hit]
        label[hit] = (inst << 16) | raw
    keep = t < max_range
    t = t[keep] + rng.normal(0, 0.01, int(keep.sum())).astype(np.float32)
    coord = (t[:, None] * d[keep]).astype(np.float32)
    return dict(coord=coord, intensity=rng.random(len(t), dtype=np.float32),
                label=label[keep], ring=ring[keep])

def write_kitti(root, sequences):
    """Write scans (from :func:`make_scan`) in SemanticKITTI's layout under
    ``root``: ``dataset/sequences/<seq>/velodyne/<frame>.bin`` (x, y, z,
    intensity as float32) and, for every sequence outside the test split
    (11-21), ``labels/<frame>.label`` (uint32). ``sequences`` maps a
    sequence number to its scans."""
    for seq, scans in sequences.items():
        base = os.path.join(root, "dataset", "sequences", f"{seq:02d}")
        os.makedirs(os.path.join(base, "velodyne"), exist_ok=True)
        if seq < 11:
            os.makedirs(os.path.join(base, "labels"), exist_ok=True)
        for i, s in enumerate(scans):
            np.concatenate([s["coord"], s["intensity"][:, None]], 1).astype(
                np.float32).tofile(os.path.join(base, "velodyne", f"{i:06d}.bin"))
            if seq < 11:
                s["label"].astype(np.uint32).tofile(
                    os.path.join(base, "labels", f"{i:06d}.label"))


def write_nuscenes(root, splits, sweeps=10):
    """Write sweeps (from :func:`make_scan` with :data:`NUSCENES_RING`) in
    nuScenes' layout under ``root``: ``raw/samples/LIDAR_TOP/<token>.bin``
    ((n, 5) float32: x, y, z, intensity 0..255, ring), outside the test
    split ``raw/lidarseg/<token>_lidarseg.bin`` (uint8 raw lidarseg
    classes), and ``info/nuscenes_infos_{sweeps}sweeps_<split>.pkl``.
    ``splits`` maps a split to its sweeps; tokens are ``<split><i>``."""
    import pickle

    lut = np.zeros(max(_KITTI_IDS.values()) + 1, np.uint8)
    for k, v in _NUSCENES_OF_KITTI.items():
        lut[k] = v
    os.makedirs(os.path.join(root, "raw", "samples", "LIDAR_TOP"), exist_ok=True)
    os.makedirs(os.path.join(root, "raw", "lidarseg"), exist_ok=True)
    os.makedirs(os.path.join(root, "info"), exist_ok=True)
    for split, scans in splits.items():
        infos = []
        for i, s in enumerate(scans):
            token = f"{split}{i:04d}"
            info = dict(lidar_path=f"samples/LIDAR_TOP/{token}.bin",
                        lidar_token=token)
            np.concatenate([s["coord"], 255 * s["intensity"][:, None],
                            s["ring"][:, None]], 1).astype(np.float32).tofile(
                os.path.join(root, "raw", info["lidar_path"]))
            if split != "test":
                info["gt_segment_path"] = f"lidarseg/{token}_lidarseg.bin"
                lut[s["label"] & 0xFFFF].tofile(
                    os.path.join(root, "raw", info["gt_segment_path"]))
            infos.append(info)
        with open(os.path.join(root, "info", f"nuscenes_infos_{sweeps}sweeps_"
                               f"{split}.pkl"), "wb") as f:
            pickle.dump(infos, f)


def outdoor_setup(train_scans, test_scan=None, sweep=None, workdir=None):
    """Write ``train_scans`` as SemanticKITTI sequence 00 (train split),
    ``test_scan`` as sequence 11 (test split, no labels) and ``sweep`` as
    the nuScenes test split's one sweep, under ``workdir`` (a new temporary
    directory by default); returns it."""
    workdir = workdir or tempfile.mkdtemp(prefix="ao_chip_outdoor_")
    write_kitti(os.path.join(workdir, "semantic_kitti"),
                {0: train_scans, **({11: [test_scan]} if test_scan else {})})
    if sweep is not None:
        write_nuscenes(os.path.join(workdir, "nuscenes"), {"test": [sweep]})
    return workdir


def kitti_options(workdir, n_scans, batch_size=3, max_steps=3, workers=6,
                  seed=0):
    """The train entry point's KEY=VALUE overrides of the SemanticKITTI
    config for the scans of :func:`outdoor_setup`: enough loops of the
    ``n_scans`` scans for ``max_steps`` in one epoch (OneCycle spans that
    epoch), evaluation and TensorBoard off."""
    # the trainer loops the train set epoch // eval_epoch times an epoch
    loop = -(-batch_size * max_steps // n_scans)
    return [f"save_path={os.path.join(workdir, 'exp')}",
            f"data.train.data_root={os.path.join(workdir, 'semantic_kitti')}",
            f"batch_size={batch_size}", f"max_steps={max_steps}",
            f"num_worker={workers}", f"seed={seed}", f"epoch={loop}",
            "eval_epoch=1", "evaluate=False", "enable_tensorboard=False"]


def check_lr(trainer, lr_of_step, what):
    """Every step's lr equals ``lr_of_step(step)`` to 1e-12 relative."""
    for i, r in enumerate(trainer.history):
        lr = lr_of_step(i)
        if abs(r["lr"] - lr) > 1e-12 * lr:
            raise RuntimeError(f"{what} step {i}: lr {r['lr']}, expected {lr}")


def onecycle_of(trainer):
    from ao_tpu_torch.utils.scheduler import onecycle_lr

    s = trainer.cfg.scheduler
    return lambda i: onecycle_lr(i, trainer.total_steps, s.max_lr, s.pct_start,
                                 s.div_factor, s.final_div_factor)


def multistep_of(trainer):
    """MultiStepLR per step: gamma for every milestone int(r * total) passed."""
    s, base = trainer.cfg.scheduler, trainer.cfg.optimizer.lr
    bounds = [int(r * trainer.total_steps) for r in s.milestones]
    return lambda i: base * s.gamma ** sum(i >= b for b in bounds)


def train_run(label, config, device, options, steps, path_kernels, lr_of,
              card, entry="train", keep=False):
    """One train run through the entry point ``entry`` (:func:`run_train`),
    driven with the launch counts set to 0 just before and read just after:
    losses and gradient norms finite, the parameters moved, each step's lr
    the schedule's. Prints the step seconds, the peak memory, the overflow
    counts and the launches per step. Returns (launches, record), and the
    trainer as well with ``keep``."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with StepLaunches() as step_count:
        trainer, launches = _drive(path_kernels, lambda: run_train(
            device, options, config, entry))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    changed, n_params = check_train(trainer, steps)
    check_lr(trainer, lr_of(trainer), label)
    hist = trainer.history
    step_s = [r["step_seconds"] for r in hist]
    med = float(np.median(step_s[1:])) if len(step_s) > 1 else step_s[0]
    record = dict(batch=trainer.cfg.batch_size, points=[r["points"] for r in hist],
                  scenes=[r["scenes"] for r in hist], step_seconds=step_s,
                  median_step_seconds=med,
                  peak_gib=peak_gb, pool_overflow=[r["pool_overflow"] for r in hist],
                  launches_per_step=step_count.per_step())
    print(f"{label}: points/step {record['points']}; losses "
          f"{[round(r['loss'], 5) for r in hist]}; grad_norms "
          f"{[round(r['grad_norm'], 4) for r in hist]}; lr "
          f"{[r['lr'] for r in hist]}; pool_overflow "
          f"{record['pool_overflow']}; {changed}/{n_params} parameter tensors "
          f"changed", flush=True)
    print(f"{label}: step seconds {[round(x, 4) for x in step_s]} (median of "
          f"steps 2-{steps}: {med:.4f} s), data wait "
          f"{[round(r['data_seconds'], 4) for r in hist]}; peak memory "
          f"{peak_gb:.2f} GiB; launches per step {record['launches_per_step']};"
          f" card {card}", flush=True)
    record["history"] = hist
    if keep:
        return launches, record, trainer
    del trainer
    torch.cuda.empty_cache()
    return launches, record


def capture_step(config, options, device, names, t0, label):
    """One train step of ``config``'s trainer on its first batch with the
    wrappers of ``names`` (kernel names of :data:`KERNEL_INFO`) captured,
    then every captured (kernel, shape) held against its plain version and
    timed (:func:`hold_captured`)."""
    trainer = build_trainer(options, device, config)
    it = iter(trainer.train_loader)
    batch = next(it)
    del it
    cap = Capture().wrap_path(names)
    try:
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
    finally:
        cap.restore()
    if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
        raise RuntimeError(f"non-finite loss or gradient on the {label}")
    caps = getattr(trainer.model.backbone, "stage_capacities", None)
    caps = f", stage capacities {caps(batch['mask'].shape[1])}" if caps else ""
    log(t0, f"captured the {label}'s kernel inputs, (B, N) "
            f"{tuple(batch['mask'].shape)}{caps}, loss {float(m['loss']):.4f}")
    del trainer, batch
    torch.cuda.empty_cache()
    rows = hold_captured(cap, label)
    missing = set(names) - {r["name"] for r in rows}
    if missing:
        raise RuntimeError(f"kernels never called on the {label}: {sorted(missing)}")
    return rows


def held(names, label, fn, limit=None, gathered=False):
    """Run ``fn`` with the wrappers of ``names`` captured (:class:`Capture`,
    launches counted as without it; ``limit`` caps the shapes kept a
    kernel), then hold every captured (kernel, shape) against its plain
    version (:func:`hold_captured`). Returns (fn's result, rows)."""
    cap = Capture(limit).wrap_path(names)
    try:
        out = fn()
    finally:
        cap.restore()
    rows = hold_captured(cap, label, gathered)
    missing = set(names) - {r["name"] for r in rows}
    if missing:
        raise RuntimeError(f"kernels never called on the {label}: {sorted(missing)}")
    return out, rows


def fit_batch(batches, label, card, fn):
    """``(batch, fn(batch))`` of the first of ``batches`` whose ``fn`` does
    not run out of memory; prints the peak reached by each that does."""
    import gc

    for batch in batches:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            return batch, fn(batch)
        except torch.cuda.OutOfMemoryError as e:
            print(f"{label} B={batch}: out of memory, peak reached "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ("
                  f"{str(e).splitlines()[0][:160]}); card {card}", flush=True)
            del e
            gc.collect()
    raise RuntimeError(f"{label} fits none of the batches {batches}")


def run_submit_test(config, device, seed, workdir, options):
    """Whole-scan testing of ``config``'s test split through the port's
    entry point with ``submit=True`` and the KEY=VALUE ``options``, on the
    weights of the model they configure drawn from ``seed``; returns the
    result dict."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.utils import Config, DictAction

    cfg = Config.fromfile(config)
    cfg.merge_from_dict({k: DictAction._parse_value(v) for k, v in
                         (o.partition("=")[::2] for o in options)})
    torch.manual_seed(seed)
    model = build_model(dict(cfg.model))
    weight = os.path.join(workdir, "model.pt")
    torch.save(model.state_dict(), weight)
    return test_main(["--config-file", config, "--device", str(device),
                      "--options", f"weight={weight}", "submit=True", *options])


def check_submission(path, n, dtype, allowed):
    """The submission file at ``path`` holds ``n`` values of ``dtype``, each
    in ``allowed``; returns the values."""
    if not os.path.isfile(path):
        raise RuntimeError(f"no submission file {path}")
    pred = np.fromfile(path, dtype=dtype)
    if len(pred) != n:
        raise RuntimeError(f"{path}: {len(pred)} values for {n} points")
    bad = ~np.isin(pred, np.asarray(sorted(allowed)))
    if bad.any():
        raise RuntimeError(f"{path}: values {np.unique(pred[bad])[:8]} outside "
                           f"the benchmark's classes")
    return pred


def outdoor_phase(device, seed, t0, card="", batch_size=12, steps=2,
                  small_batch_size=3, small_steps=3, full=True,
                  extra=("model.backbone.enable_checkpoint=True",),
                  workdir=None):
    """Phase 8: the SemanticKITTI config as written (f32) at full width on
    synthetic 64-beam scans: ``steps`` train steps at ``batch_size`` with
    the KEY=VALUE overrides ``extra`` (by default checkpointing on), then
    (``full``) ``small_steps`` at ``small_batch_size`` with checkpointing
    off and on; one step with bf16 compute whose K1-K6 calls are held
    against their plain versions, and ``small_steps`` more of it counted;
    whole-scan testing of the benchmark-submit configs with submit=True on
    a SemanticKITTI test scan and a nuScenes test sweep. The scans are
    written under ``workdir`` (a new temporary directory by default).
    Returns (kernel rows, launches by path, train records)."""
    from ao_tpu_torch.utils import Config

    t_phase = time.perf_counter()
    scans = [make_scan(seed * 100 + s, **KITTI_RING) for s in range(4)]
    test_scan = make_scan(seed * 100 + 4, **KITTI_RING)
    sweep = make_scan(seed * 100 + 5, **NUSCENES_RING)
    workdir = outdoor_setup(scans, test_scan, sweep, workdir)
    options = kitti_options(workdir, len(scans), batch_size, steps, seed=seed)
    log(t0, f"LiDAR scans: {[len(s['coord']) for s in scans]} train, "
            f"{len(test_scan['coord'])} test points; nuScenes sweep "
            f"{len(sweep['coord'])} points")
    f32_kernels = GRAPH_BN_KERNELS
    launches, records = {}, {}
    launches["kitti_train_b"], records["kitti_train_b"] = train_run(
        f"kitti train B={batch_size} ({' '.join(extra) or 'as written'})",
        KITTI_CONFIG, device, options + list(extra), steps, f32_kernels,
        onecycle_of, card)
    log(t0, "SemanticKITTI train steps done")
    if not full:
        return [], launches, records

    small = kitti_options(workdir, len(scans), small_batch_size, small_steps,
                          seed=seed)
    for key, ckpt in (("kitti_train", False), ("kitti_train_ckpt", True)):
        launches[key], records[key] = train_run(
            f"kitti train B={small_batch_size} enable_checkpoint={ckpt}",
            KITTI_CONFIG, device, small + [
                f"model.backbone.enable_checkpoint={ckpt}",
                f"save_path={os.path.join(workdir, key)}"], small_steps,
            f32_kernels, onecycle_of, card)
    if not records["kitti_train_ckpt"]["peak_gib"] < records["kitti_train"]["peak_gib"]:
        raise RuntimeError("enable_checkpoint did not lower the peak memory")
    log(t0, "SemanticKITTI checkpointing off / on done")

    bf16 = small + list(SCANNET_BF16)
    rows = capture_step(KITTI_CONFIG, bf16 + [
        f"save_path={os.path.join(workdir, 'exp_kernels')}"], device,
        TRAIN_KERNELS, t0, "kitti bf16 train step")
    launches["kitti_train_bf16"], records["kitti_train_bf16"] = train_run(
        f"kitti train B={small_batch_size} bf16", KITTI_CONFIG, device,
        bf16 + [f"save_path={os.path.join(workdir, 'exp_bf16')}"], small_steps,
        TRAIN_KERNELS, onecycle_of, card)
    log(t0, "SemanticKITTI bf16 step done")

    cfg = Config.fromfile(KITTI_SUBMIT_CONFIG)
    kitti_root = os.path.join(workdir, "semantic_kitti")
    t = time.perf_counter()
    result, launches["kitti_test"] = _drive(f32_kernels, lambda: run_submit_test(
        KITTI_SUBMIT_CONFIG, device, seed, workdir, [
            f"save_path={os.path.join(workdir, 'kitti_test')}",
            f"data.test.data_root={kitti_root}"]))
    seconds = time.perf_counter() - t
    label = check_submission(
        os.path.join(workdir, "kitti_test", "result", "submit", "sequences",
                     "11", "predictions", "000000.label"),
        len(test_scan["coord"]), np.uint32, set(cfg.learning_map_inv.values()))
    scene = result["scenes"][0]
    print(f"kitti test (submit): {scene['fragments']} fragments in batches "
          f"(B, N) {scene['batches']}; scan {scene['seconds']:.2f} s ({seconds:.2f}"
          f" s with loading); .label of {len(label)} uint32, raw ids "
          f"{np.unique(label).tolist()}; launches {launches['kitti_test']}",
          flush=True)
    t = time.perf_counter()
    result, launches["nuscenes_test"] = _drive(
        ("knn_window", "point_bn"), lambda: run_submit_test(
            NUSCENES_SUBMIT_CONFIG, device, seed, workdir, [
                f"save_path={os.path.join(workdir, 'nuscenes_test')}",
                f"data.test.data_root={os.path.join(workdir, 'nuscenes')}"]))
    seconds = time.perf_counter() - t
    pred = check_submission(
        os.path.join(workdir, "nuscenes_test", "result", "submit", "lidarseg",
                     "test", "test0000_lidarseg.bin"),
        len(sweep["coord"]), np.uint8, set(range(1, 17)))
    scene = result["scenes"][0]
    print(f"nuscenes test (submit): {scene['fragments']} fragments in batches "
          f"(B, N) {scene['batches']}; sweep {scene['seconds']:.2f} s "
          f"({seconds:.2f} s with loading); _lidarseg.bin of {len(pred)} uint8 "
          f"in {pred.min()}..{pred.max()}; launches {launches['nuscenes_test']}",
          flush=True)
    torch.cuda.empty_cache()
    log(t0, f"outdoor phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, records


def ptv2m1_phase(device, seed, t0, rooms, card="", steps=3, batch_size=3,
                 off_batch_size=2):
    """Phase 9: configs/s3dis/semseg-pt-v2m1-0-base.py (PT-v2m1: the pe
    multiplier, GroupedLinear weight encoding, interp unpooling; bf16
    compute by its base config; its attention unfused in both packages)
    at full width on the train phase's rooms, with checkpointing on at
    ``batch_size`` (B=3 x 81920, the base config's per-card batch): one
    step with its K1 (each probe of the multi-probe graph) and K2 ((3, 16)
    merges, the unpool's (2, 3)) calls held against their plain versions,
    then ``steps`` steps; and ``steps`` steps at ``off_batch_size`` with
    checkpointing off and on (without it B=3 does not fit the card).
    Returns (kernel rows, launches by path, train records)."""
    t_phase = time.perf_counter()
    graph = GRAPH_BN_KERNELS
    ckpt = ["model.backbone.enable_checkpoint=True"]
    workdir, options = train_setup(rooms, batch_size=batch_size,
                                   max_steps=steps, seed=seed)
    rows = capture_step(PTV2M1_CONFIG, options + ckpt + [
        f"save_path={os.path.join(workdir, 'exp_kernels')}"], device, graph,
        t0, "PT-v2m1 train step")
    launches, records = {}, {}
    launches["ptv2m1_train_ckpt"], records["ptv2m1_train_ckpt"] = train_run(
        f"PT-v2m1 train B={batch_size} enable_checkpoint=True", PTV2M1_CONFIG,
        device, options + ckpt, steps, graph, multistep_of, card)
    _, small = train_setup(rooms, workdir=workdir, batch_size=off_batch_size,
                           max_steps=steps, seed=seed)
    for on in (False, True):
        key = f"ptv2m1_train_b{off_batch_size}" + ("_ckpt" if on else "")
        launches[key], records[key] = train_run(
            f"PT-v2m1 train B={off_batch_size} enable_checkpoint={on}",
            PTV2M1_CONFIG, device, small + [
                f"model.backbone.enable_checkpoint={on}",
                f"save_path={os.path.join(workdir, key)}"], steps, graph,
            multistep_of, card)
    off, on = (records[f"ptv2m1_train_b{off_batch_size}{x}"] for x in ("", "_ckpt"))
    if not on["peak_gib"] < off["peak_gib"]:
        raise RuntimeError("enable_checkpoint did not lower PT-v2m1's peak memory")
    log(t0, f"PT-v2m1 phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, records


# ---------------------------------------------------------------------------
# phase 10: the sparse-convolution configs (SpUNet, MinkUNet34C, SPVCNN)
# ---------------------------------------------------------------------------

SPUNET_CONFIG = os.path.join(ROOT, "configs", "scannet",
                             "semseg-spunet-v1m1-0-base.py")
MINKUNET_CONFIG = os.path.join(ROOT, "configs", "s3dis",
                               "semseg-minkunet34c-0-base.py")
SPVCNN_CONFIG = os.path.join(ROOT, "configs", "semantic_kitti",
                             "semseg-spvcnn-v1m1-0-base.py")
# the ScanNet SpUNet's full-resolution decoder conv: the first block's
# conv1 takes the inverse conv's 96 channels and the 32 of the skip
SPARSE_CONV_SHAPE = dict(c_in=96 + 32, c_out=96, kernel_size=3)


class StageOverflow:
    """While active, keeps the backbone's clusters beyond each stride-2
    level's capacity (``stage_overflow``) after every train step."""

    def __enter__(self):
        from ao_tpu_torch.engines.train import Trainer

        self.steps = []
        self._orig = Trainer._step

        def step(trainer, batch):
            out = self._orig(trainer, batch)
            self.steps.append(trainer.model.backbone.stage_overflow.tolist())
            return out

        Trainer._step = step
        return self

    def __exit__(self, *exc):
        from ao_tpu_torch.engines.train import Trainer

        Trainer._step = self._orig


def sparse_options(data_root, n_scenes, batch_size, steps, save_path, seed,
                   workers=6):
    """The train entry point's KEY=VALUE overrides for ``steps`` steps at
    ``batch_size`` on the ``n_scenes`` scenes under ``data_root``, looped so
    that the steps fit in one epoch; evaluation and TensorBoard off."""
    loop = -(-batch_size * steps // n_scenes)
    return [f"save_path={save_path}", f"data.train.data_root={data_root}",
            f"batch_size={batch_size}", f"max_steps={steps}",
            f"num_worker={workers}", f"seed={seed}", f"data.train.loop={loop}",
            "evaluate=False", "enable_tensorboard=False"]


def poly_of(trainer):
    """PolyLR per step: lr * (1 - step / (total + 1)) ** power."""
    s, base = trainer.cfg.scheduler, trainer.cfg.optimizer.lr
    return lambda i: base * (1 - i / (trainer.total_steps + 1)) ** s.power


def check_sparse_conv(batch, device, card):
    """sparse_conv_apply (the recomputing Function) against its plain
    version (gather all K rows, one einsum, autograd) on the card, on the
    k=3 neighbour rows of the first two scenes of a ScanNet batch at the
    full-resolution decoder conv's widths (:data:`SPARSE_CONV_SHAPE`), with
    random features and kernel: the output within 1e-5 of scale, the
    feature and kernel gradients of sum(out * r) within 1e-4 of scale. Both
    timed by CUDA events, forward alone and forward + backward. Bound: each
    input read once and the output written once at the memory rate,
    against 2 C_in C_out operations a valid (site, offset) pair at the f32
    rate (the port runs f32 products without TF32)."""
    from ao_tpu_torch.models.sparse_unet.spunet import neighbours
    from ao_tpu_torch.ops.sparse_conv import (sparse_conv_apply,
                                              sparse_conv_apply_plain)

    mask = batch["mask"][:2].to(device)
    dc = torch.where(mask[..., None], batch["discrete_coord"][:2].to(device), 0)
    shape = SPARSE_CONV_SHAPE
    idx, valid = neighbours(dc, mask, shape["kernel_size"])
    g = torch.Generator(device=device)
    g.manual_seed(0)
    B, N = mask.shape
    K = idx.shape[-1]
    feat = torch.randn(B, N, shape["c_in"], device=device, generator=g)
    feat = feat * mask[..., None]
    w = torch.randn(K, shape["c_in"], shape["c_out"], device=device,
                    generator=g) / math.sqrt(K * shape["c_in"])
    r = torch.randn(B, N, shape["c_out"], device=device, generator=g)

    def step(fn):
        f, k = feat.clone().requires_grad_(), w.clone().requires_grad_()
        out = fn(f, idx, valid, k)
        (out * r).sum().backward()
        return out.detach(), f.grad, k.grad

    got, ref = step(sparse_conv_apply), step(sparse_conv_apply_plain)
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, ref)]
    ok = errs[0] <= 1e-5 and max(errs[1:]) <= 1e-4
    del got, ref
    torch.cuda.empty_cache()
    with torch.no_grad():
        ms = cuda_ms(lambda: sparse_conv_apply(feat, idx, valid, w))
        plain_ms = cuda_ms(lambda: sparse_conv_apply_plain(feat, idx, valid, w),
                           reps=3, warmup=1)
    train_ms = cuda_ms(lambda: step(sparse_conv_apply), reps=3, warmup=1)
    plain_train_ms = cuda_ms(lambda: step(sparse_conv_apply_plain), reps=3,
                             warmup=1)
    pairs = int(valid.sum())
    nbytes = _nbytes(feat, idx, valid, w) + B * N * shape["c_out"] * 4
    bound_ms, by = _bound(nbytes, f32_ops=2.0 * pairs * shape["c_in"] * shape["c_out"])
    rec = dict(shape=f"B={B} N={N} K={K} C_in={shape['c_in']} "
                     f"C_out={shape['c_out']} valid pairs={pairs}",
               ok=ok, rel_err=dict(out=errs[0], dfeat=errs[1], dkernel=errs[2]),
               ms=ms, plain_ms=plain_ms, train_ms=train_ms,
               plain_train_ms=plain_train_ms, bound_ms=bound_ms, bound_by=by,
               library_ms=None, card=card)
    print(json.dumps({"sparse_conv_apply": rec}), flush=True)
    torch.cuda.empty_cache()
    if not ok:
        raise RuntimeError(f"sparse_conv_apply disagrees with its plain version: "
                           f"{rec['rel_err']}")
    return rec


def sparse_train(label, config, device, options, steps, path_kernels, lr_of,
                 card, **kw):
    """A :func:`train_run` of a sparse config that also prints the clusters
    beyond each stride-2 level's capacity, per step."""
    with StageOverflow() as over:
        out = train_run(label, config, device, options, steps, path_kernels,
                        lr_of, card, **kw)
    out[1]["stage_overflow"] = over.steps
    print(f"{label}: overflow per stage and step {over.steps}", flush=True)
    return out


def sparse_phase(device, seed, t0, card="", scannet_dir=None, kitti_dir=None,
                 s3dis_dir=None, steps=3, profile=False):
    """Phase 10: the sparse-convolution configs as written (f32) at full
    width on the rooms and scans of phases 7, 8 and 5 (written under
    ``scannet_dir``, ``kitti_dir`` and ``s3dis_dir``; made here from the
    seed where None): sparse_conv_apply held against its plain version at
    the ScanNet batch's full-resolution decoder conv (B=2); the ScanNet
    SpUNet config at its B=12 (SGD, OneCycle, Mix3D), then whole-scene
    testing of the ScanNet room with its 10 views; MinkUNet34C S3DIS at
    B=12 (PolyLR); SPVCNN SemanticKITTI at B=8 (AdamW, OneCycle), whose K1
    and K2 calls (the two devoxelisations) are held against their plain
    versions on one captured step. Each run: losses finite, parameters
    moved, the schedule's lr, step seconds, peak memory, the overflow per
    stage. With ``profile``, one more ScanNet SpUNet step at B=12 is timed
    and traced (:func:`profile_train_step`). Returns (kernel rows, launches
    by path, train records)."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.utils import Config

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="ao_chip_sparse_")
    if scannet_dir is None:
        scannet_dir, _ = scannet_setup(
            [make_scannet_room(s_, size) for s_, size in SCANNET_ROOMS],
            make_scannet_room(*SCANNET_TEST_ROOM))
    if kitti_dir is None:
        kitti_dir = outdoor_setup([make_scan(seed * 100 + i, **KITTI_RING)
                                   for i in range(4)])
    if s3dis_dir is None:
        s3dis_dir, _ = train_setup([make_room(s_, size) for s_, size in TRAIN_ROOMS])
    sc_root = os.path.join(scannet_dir, "scannet")
    n_sc = len(os.listdir(os.path.join(sc_root, "train")))
    s3_root = os.path.join(s3dis_dir, "s3dis")
    n_s3 = len(os.listdir(s3_root))
    n_kitti = len(os.listdir(os.path.join(kitti_dir, "semantic_kitti", "dataset",
                                          "sequences", "00", "velodyne")))
    log(t0, f"sparse phase data: {n_sc} ScanNet, {n_s3} S3DIS rooms, "
            f"{n_kitti} SemanticKITTI scans")
    launches, records = {}, {}

    trainer = build_trainer(sparse_options(
        sc_root, n_sc, 2, 1, os.path.join(work, "conv"), seed, workers=2) + [
        "mix_prob=0"], device, SPUNET_CONFIG)
    batch = next(iter(trainer.train_loader))
    del trainer
    conv = check_sparse_conv(batch, device, card)
    print(f"sparse_conv_apply {conv['shape']}: rel err {conv['rel_err']}; ms "
          f"{conv['ms']:.3f} (plain {conv['plain_ms']:.3f}), forward + backward "
          f"{conv['train_ms']:.3f} (plain {conv['plain_train_ms']:.3f}); bound "
          f"{conv['bound_ms']:.4f} ({conv['bound_by']}); card {card}", flush=True)
    del batch
    log(t0, "sparse_conv_apply checked")

    launches["spunet_train"], records["spunet_train"] = sparse_train(
        "scannet spunet train B=12 (as written)", SPUNET_CONFIG, device,
        sparse_options(sc_root, n_sc, 12, steps, os.path.join(work, "spunet"),
                       seed), steps, BN_KERNELS, onecycle_of, card)
    rec = records["spunet_train"]
    if not any(n < rec["batch"] for n in rec["scenes"]):
        raise RuntimeError("no ScanNet SpUNet step was mixed by Mix3D")
    log(t0, "ScanNet SpUNet train steps done")
    if profile:
        trainer = build_trainer(sparse_options(
            sc_root, n_sc, 12, 3, os.path.join(work, "profile"), seed) + [
            "mix_prob=0"], device, SPUNET_CONFIG)
        batch = next(iter(trainer.train_loader))
        print(json.dumps({"spunet_train_step_profile": dict(
            profile_train_step(trainer, batch), card=card)}), flush=True)
        del trainer, batch
        torch.cuda.empty_cache()
        log(t0, "ScanNet SpUNet step profiled")

    cfg = Config.fromfile(SPUNET_CONFIG)
    torch.manual_seed(seed)
    weight = os.path.join(work, "spunet.pt")
    torch.save(build_model(dict(cfg.model)).state_dict(), weight)
    result, launches["spunet_test"] = _drive(BN_KERNELS, lambda: test_main([
        "--config-file", SPUNET_CONFIG, "--device", str(device), "--options",
        f"weight={weight}", f"save_path={os.path.join(work, 'spunet_test')}",
        f"data.test.data_root={sc_root}"]))
    names = sorted(os.listdir(os.path.join(sc_root, "val")))
    votes = np.load(os.path.join(work, "spunet_test", "result",
                                 names[0].replace(".pth", "_pred.npy")))
    check_votes(votes, len(cfg.data.test.test_cfg.aug_transform), num_classes=20)
    scene = result["scenes"][0]
    print(f"scannet spunet test: {scene['fragments']} fragments in batches "
          f"(B, N) {scene['batches']}; scene {scene['seconds']:.2f} s; votes "
          f"{votes.shape}; mIoU {result['mIoU']:.4f} (random weights); card "
          f"{card}", flush=True)
    torch.cuda.empty_cache()
    log(t0, "ScanNet SpUNet test done")

    launches["minkunet_train"], records["minkunet_train"] = sparse_train(
        "s3dis minkunet34c train B=12 (as written)", MINKUNET_CONFIG, device,
        sparse_options(s3_root, n_s3, 12, steps, os.path.join(work, "mink"),
                       seed), steps, BN_KERNELS, poly_of, card)
    log(t0, "MinkUNet34C train steps done")

    kitti = kitti_options(kitti_dir, n_kitti, 8, steps, seed=seed)
    graph = GRAPH_BN_KERNELS
    rows = capture_step(SPVCNN_CONFIG, kitti + [
        f"save_path={os.path.join(work, 'spvcnn_kernels')}"], device, graph, t0,
        "SPVCNN train step")
    launches["spvcnn_train"], records["spvcnn_train"] = sparse_train(
        "kitti spvcnn train B=8 (as written)", SPVCNN_CONFIG, device, kitti + [
            f"save_path={os.path.join(work, 'spvcnn')}"], steps, graph,
        onecycle_of, card)
    log(t0, f"sparse phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, records


CAC_CONFIG = os.path.join(ROOT, "configs", "scannet",
                          "semseg-cac-v1m1-0-spunet-base.py")
CAC_PTV2_CONFIG = os.path.join(ROOT, "configs", "scannet",
                               "semseg-cac-v1m1-2-ptv2-lovasz.py")
PG_CONFIG = os.path.join(ROOT, "configs", "scannet",
                         "insseg-pointgroup-v1m1-0-spunet-base.py")
PG_S3DIS_CONFIG = os.path.join(ROOT, "configs", "s3dis",
                               "insseg-pointgroup-v1m1-0-spunet-base.py")
MSC_CONFIG = os.path.join(ROOT, "configs", "scannet",
                          "pretrain-msc-v1m1-0-spunet-base.py")
CSC_CONFIG = os.path.join(ROOT, "configs", "scannet",
                          "pretrain-msc-v1m2-0-spunet-csc.py")
CAC_TERMS = ("seg_loss", "pre_loss", "pre_self_loss", "kl_loss")
# The CAC PT-v2m2 config names in_channels=9 but inherits the SpUNet base's
# data, whose Collect gives 6 features (colour, normal): the JAX package's
# flax Dense takes the 6 it is given, the port's Linear is built for
# in_channels, so the run sets the 6 the data gives (ROADMAP.md section 3)
CAC_PTV2_IN = ("model.backbone.in_channels=6",)
# MSC's batches, tried in turn until one fits: the config's own 32, 16 and
# 12 ran out of memory on an 80 GB card in every full run (B=7 fits), so
# the ladder starts at 8 to keep the script inside its time limit
MSC_BATCHES = (8, 7, 6, 4, 2)
# the full run's MSC batch and steps (the ladder runs under --heads)
MSC_FULL_BATCH = 4
MSC_FULL_STEPS = 1


def check_terms(record, terms, label):
    """Every step's ``terms`` finite."""
    for i, r in enumerate(record["history"]):
        bad = [t for t in terms if not np.isfinite(r[t])]
        if bad:
            raise RuntimeError(f"{label} step {i}: non-finite {bad} in {r}")


def oracle_scene(batch, b, num_classes):
    """The evaluator's inputs for scene ``b`` of a validation batch from its
    own labels: logits one-hot (x 10) on the segment (ignored points on
    class 0), offsets to the instance centres (0 off instances)."""
    seg = batch["segment"][b].numpy()
    logits = np.zeros(seg.shape + (num_classes,), np.float32)
    logits[np.arange(len(seg)), np.maximum(seg, 0)] = 10.0
    inst = batch["instance"][b].numpy() >= 0
    bias = np.where(inst[:, None], batch["instance_center"][b].numpy()
                    - batch["coord"][b].numpy(), 0.0).astype(np.float32)
    return logits, bias


def check_insseg(trainer, label, card):
    """The InsSegEvaluator ran on the validation room with finite mAP, AP50
    and AP25; then the same hook on the room's own labels (one-hot logits,
    exact offsets; :func:`oracle_scene`) must make proposals and score
    AP50 1. Prints both, with the host seconds of clustering and of the AP
    table."""
    from ao_tpu_torch.engines.train_insseg import InsSegEvaluator

    res = trainer.comm_info.get("insseg_result")
    if res is None or res["scenes"] < 1:
        raise RuntimeError(f"{label}: the InsSegEvaluator scored no scene: {res}")
    if not all(np.isfinite(res[k]) for k in ("all_ap", "all_ap_50", "all_ap_25")):
        raise RuntimeError(f"{label}: non-finite AP {res}")
    hook = next(h for h in trainer.hooks if isinstance(h, InsSegEvaluator))
    K = trainer.cfg.data.num_classes
    trainer.eval_scene = lambda batch: tuple(np.stack(x) for x in zip(*(
        oracle_scene(batch, b, K) for b in range(batch["mask"].shape[0]))))
    hook.eval()
    oracle = trainer.comm_info["insseg_result"]
    for name, r in (("model", res), ("labels", oracle)):
        print(f"{label} insseg on the val room ({name}): mAP {r['all_ap']:.4f} "
              f"AP50 {r['all_ap_50']:.4f} AP25 {r['all_ap_25']:.4f}; "
              f"{r['proposals']} proposals; host seconds: clustering "
              f"{r['cluster_seconds']:.4f}, AP table {r['ap_seconds']:.4f}; card "
              f"{card}", flush=True)
    if oracle["proposals"] < 1 or oracle["all_ap_50"] < 0.99:
        raise RuntimeError(f"{label}: the room's own labels gave {oracle}")
    return res, oracle


def time_msc_knn(trainer, card):
    """CUDA-event ms of the MSC step's matching kNN (ops/knn.py, chunked
    above its score budget) on a batch of the trainer's loader: view 1's
    origin coords against view 2's, k = matching_max_k; prints it beside
    the scores it ranks."""
    from ao_tpu_torch.ops.knn import CHUNK_ELEMENTS, knn

    batch = next(iter(trainer.train_loader))
    o1, o2, m1, m2 = (batch[k].to(trainer.device) for k in (
        "view1_origin_coord", "view2_origin_coord", "view1_mask", "view2_mask"))
    k = trainer.model.matching_max_k
    ms = cuda_ms(lambda: knn(o1, o2, k, m1, m2), reps=3, warmup=1)
    B, N1, N2 = m1.shape + m2.shape[1:]
    rec = dict(B=B, N1=N1, N2=N2, k=k, scores=B * N1 * N2,
               chunked=B * N1 * N2 > CHUNK_ELEMENTS, ms=ms)
    print(f"msc matching kNN: B={B} N1={N1} N2={N2} k={k}, {rec['scores']:.3e} "
          f"scores (chunked {rec['chunked']}): {ms:.2f} ms; card {card}", flush=True)
    del batch, o1, o2, m1, m2
    return rec


def heads_phase(device, seed, t0, card="", scannet_dir=None, s3dis_rooms=None,
                steps=3, msc_batches=MSC_BATCHES, msc_steps=3):
    """Phase 11: the SpUNet task heads' configs as written (f32, full width)
    on the rooms of phases 7 and 5 (the ScanNet rooms written under
    ``scannet_dir``, the S3DIS rooms given as ``s3dis_rooms``, written here
    with normals from :func:`scannet_normals`, which the PointGroup S3DIS
    config collects; made here where None). CAC on SpUNet at
    its B=12 and whole-scene testing of the ScanNet room with its 10 views;
    CAC on PT-v2m2 (the lovasz config) at B=12 with enable_checkpoint, one
    step with its K1 and K2 calls held against their plain versions, then
    ``steps`` counted; PointGroup ScanNet at B=12 through
    ao_tpu_torch.tools.train_insseg, whose cut epoch ends with the
    InsSegEvaluator on the val room (:func:`check_insseg`), and PointGroup
    S3DIS at B=12; MSC-v1m1 through ao_tpu_torch.tools.train_pretrain,
    ``msc_steps`` steps at the first of ``msc_batches`` that fits (each
    that does not prints the peak reached), then one MSC-v1m2 (CSC) step at
    that batch. Every run: losses (CAC's four terms, PointGroup's three,
    MSC's NCE, colour and normal) finite, matched pairs > 0 each MSC step,
    parameters moved, the schedule's lr, step seconds, data wait, peak
    memory. Returns (kernel rows, launches by path, train records)."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.utils import Config

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="ao_chip_heads_")
    if scannet_dir is None:
        scannet_dir, _ = scannet_setup(
            [make_scannet_room(s_, size) for s_, size in SCANNET_ROOMS],
            make_scannet_room(*SCANNET_TEST_ROOM))
    if s3dis_rooms is None:
        s3dis_rooms = [make_room(s_, size) for s_, size in TRAIN_ROOMS]
    s3dis_dir, _ = train_setup([dict(r, normal=scannet_normals(r["coord"]))
                                for r in s3dis_rooms], os.path.join(work, "s3dis_data"))
    sc_root = os.path.join(scannet_dir, "scannet")
    n_sc = len(os.listdir(os.path.join(sc_root, "train")))
    s3_root = os.path.join(s3dis_dir, "s3dis")
    n_s3 = len(os.listdir(s3_root))
    log(t0, f"heads phase data: {n_sc} ScanNet, {n_s3} S3DIS rooms")
    launches, records = {}, {}

    def opts(root, n, batch, n_steps, name):
        return sparse_options(root, n, batch, n_steps, os.path.join(work, name), seed)

    # CAC on SpUNet, then its scene test
    launches["cac_train"], records["cac_train"] = sparse_train(
        "scannet cac spunet train B=12 (as written)", CAC_CONFIG, device,
        opts(sc_root, n_sc, 12, steps, "cac"), steps, BN_KERNELS, onecycle_of, card)
    check_terms(records["cac_train"], CAC_TERMS, "CAC")
    rec = records["cac_train"]
    if not any(n < rec["batch"] for n in rec["scenes"]):
        raise RuntimeError("no CAC step was mixed by Mix3D")
    print(f"scannet cac spunet train: terms "
          f"{[{t: round(r[t], 5) for t in CAC_TERMS} for r in rec['history']]}",
          flush=True)
    cfg = Config.fromfile(CAC_CONFIG)
    torch.manual_seed(seed)
    weight = os.path.join(work, "cac.pt")
    torch.save(build_model(dict(cfg.model)).state_dict(), weight)
    result, launches["cac_test"] = _drive(BN_KERNELS, lambda: test_main([
        "--config-file", CAC_CONFIG, "--device", str(device), "--options",
        f"weight={weight}", f"save_path={os.path.join(work, 'cac_test')}",
        f"data.test.data_root={sc_root}"]))
    names = sorted(os.listdir(os.path.join(sc_root, "val")))
    votes = np.load(os.path.join(work, "cac_test", "result",
                                 names[0].replace(".pth", "_pred.npy")))
    check_votes(votes, len(cfg.data.test.test_cfg.aug_transform), num_classes=20)
    scene = result["scenes"][0]
    print(f"scannet cac spunet test: {scene['fragments']} fragments in batches "
          f"(B, N) {scene['batches']}; scene {scene['seconds']:.2f} s; votes "
          f"{votes.shape}; mIoU {result['mIoU']:.4f} (random weights); card "
          f"{card}", flush=True)
    torch.cuda.empty_cache()
    log(t0, "CAC SpUNet train and test done")

    # CAC on PT-v2m2: its K1 / K2 calls held, then counted steps
    graph = GRAPH_BN_KERNELS
    ckpt = ["model.backbone.enable_checkpoint=True", *CAC_PTV2_IN]
    torch.cuda.reset_peak_memory_stats()
    rows = capture_step(CAC_PTV2_CONFIG, opts(sc_root, n_sc, 12, 1, "cac_ptv2_kernels")
                        + ckpt, device, graph, t0, "CAC PT-v2m2 train step")
    print(f"cac ptv2 captured step: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card}",
          flush=True)
    launches["cac_ptv2_train"], records["cac_ptv2_train"] = train_run(
        "scannet cac ptv2 train B=12 (enable_checkpoint)", CAC_PTV2_CONFIG,
        device, opts(sc_root, n_sc, 12, steps, "cac_ptv2") + ckpt, steps, graph,
        onecycle_of, card)
    check_terms(records["cac_ptv2_train"], CAC_TERMS, "CAC PT-v2m2")
    log(t0, "CAC PT-v2m2 done")

    # PointGroup: ScanNet with the evaluator, S3DIS
    launches["pg_train"], records["pg_train"], trainer = sparse_train(
        "scannet pointgroup train B=12 (as written)", PG_CONFIG, device,
        opts(sc_root, n_sc, 12, steps, "pg") + [
            "evaluate=True", f"data.val.data_root={sc_root}"], steps, BN_KERNELS, poly_of,
        card, entry="train_insseg", keep=True)
    check_terms(records["pg_train"], ("seg_loss", "bias_l1_loss",
                                      "bias_cosine_loss"), "PointGroup")
    records["pg_eval"] = check_insseg(trainer, "scannet pointgroup", card)
    del trainer
    torch.cuda.empty_cache()
    launches["pg_s3dis_train"], records["pg_s3dis_train"] = sparse_train(
        "s3dis pointgroup train B=12 (as written)", PG_S3DIS_CONFIG, device,
        opts(s3_root, n_s3, 12, steps, "pg_s3dis"), steps, BN_KERNELS, poly_of, card,
        entry="train_insseg")
    log(t0, "PointGroup done")

    # MSC at the largest batch that fits, then a CSC step. The MSC configs
    # loop their scenes epoch // eval_epoch times an epoch, which the
    # entry point sets over data.train.loop: the epoch sets it here
    msc_terms = ("nce_loss", "color_loss", "normal_loss", "pairs")
    n_msc = n_sc + len(os.listdir(os.path.join(sc_root, "val")))
    eval_epoch = Config.fromfile(MSC_CONFIG).eval_epoch

    def msc_opts(batch, n_steps, name):
        return opts(sc_root, n_msc, batch, n_steps, name) + [
            f"epoch={eval_epoch * -(-batch * n_steps // n_msc)}"]

    _, (launches["msc_train"], records["msc_train"], trainer) = fit_batch(
        msc_batches, "scannet msc train", card, lambda b: sparse_train(
            f"scannet msc train B={b}", MSC_CONFIG, device,
            msc_opts(b, msc_steps, f"msc{b}"), msc_steps, BN_KERNELS, onecycle_of, card,
            entry="train_pretrain", keep=True))
    records["msc_knn"] = time_msc_knn(trainer, card)
    del trainer
    torch.cuda.empty_cache()
    rec = records["msc_train"]
    check_terms(rec, msc_terms, "MSC")
    if min(r["pairs"] for r in rec["history"]) <= 0:
        raise RuntimeError("an MSC step matched no pair")
    print(f"scannet msc train B={rec['batch']}: "
          f"{[{t: round(r[t], 5) for t in msc_terms + ('pos_sim',)} for r in rec['history']]}",
          flush=True)
    launches["csc_train"], records["csc_train"] = sparse_train(
        f"scannet msc-v1m2 (csc) train B={rec['batch']}", CSC_CONFIG, device,
        msc_opts(rec["batch"], 1, "csc"), 1, BN_KERNELS, onecycle_of, card,
        entry="train_pretrain")
    check_terms(records["csc_train"], msc_terms, "CSC")
    if records["csc_train"]["history"][0]["pairs"] <= 0:
        raise RuntimeError("the CSC step matched no pair")
    log(t0, f"heads phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, records


# ---------------------------------------------------------------------------
# phase 12: PT-v1, classification and part segmentation
# ---------------------------------------------------------------------------

PTV1_CONFIG = os.path.join(ROOT, "configs", "s3dis", "semseg-pt-v1-0-base.py")
CLS_CONFIG = os.path.join(ROOT, "configs", "modelnet40", "cls-ptv1-0-base.py")
CLS_SPUNET_CONFIG = os.path.join(ROOT, "configs", "modelnet40",
                                 "cls-spunet-v1m1-0-base.py")
# Seg50's batches, tried in turn from the config's own 12 until one fits
PTV1_BATCHES = (12, 8, 6, 4, 3)
# the full run's Seg50 batch (B=12 fits: 7.6 s a step; the ladder runs under
# --ptv1) and the counted steps of the full run's phases 10-15
PTV1_FULL_BATCH = 6
FULL_RUN_STEPS = 2
# the kernels of the PT-v1 segmentation paths (the unpooling's K1 and K2
# above 2M query x key pairs, FPS at every TransitionDown)
PTV1_KERNELS = ("knn_window", "merge_topk", "fps", "point_bn")
# ShapeNetPart's first two categories of synsetoffset2category.txt as the
# smoke writes it (name, synset token), with all 16 named
SHAPENET_CATEGORIES = (
    ("Airplane", "02691156"), ("Bag", "02773838"), ("Cap", "02954340"),
    ("Car", "02958343"), ("Chair", "03001627"), ("Earphone", "03261776"),
    ("Guitar", "03467517"), ("Knife", "03624134"), ("Lamp", "03636649"),
    ("Laptop", "03642806"), ("Motorbike", "03790512"), ("Mug", "03797390"),
    ("Pistol", "03948459"), ("Rocket", "04099429"), ("Skateboard", "04225987"),
    ("Table", "04379243"))


def make_shape(seed, category, n=10000):
    """A synthetic ModelNet-style shape of class ``category``: ``n`` points
    on the surface of an ellipsoid, a box or a closed cylinder (by
    ``category % 3``) with half-axes of the class (drawn from the class),
    turned about z by an angle of the shape, with unit outward normals;
    (n, 6) float32 rows x, y, z, nx, ny, nz."""
    axes = np.random.default_rng(1000 + category).uniform(0.3, 1.0, 3)
    rng = np.random.default_rng(seed)
    kind = category % 3
    if kind == 0:  # ellipsoid: a sphere's points scaled, normals by 1 / axes
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        p, nrm = u * axes, u / axes
    elif kind == 1:  # box: a face by its area, a point uniform on it
        area = np.array([axes[1] * axes[2], axes[0] * axes[2], axes[0] * axes[1]])
        face = rng.choice(6, n, p=np.tile(area, 2) / (2 * area.sum()))
        axis, sign = face % 3, np.where(face < 3, 1.0, -1.0)
        p = rng.uniform(-1, 1, (n, 3)) * axes
        p[np.arange(n), axis] = sign * axes[axis]
        nrm = np.zeros((n, 3))
        nrm[np.arange(n), axis] = sign
    else:  # cylinder about z: side or caps by their areas
        r, h = axes[0], axes[2]
        side = rng.random(n) < h / (h + r)
        t = rng.uniform(0, 2 * np.pi, n)
        rad = np.where(side, r, r * np.sqrt(rng.random(n)))
        z = np.where(side, rng.uniform(-h, h, n),
                     np.where(rng.random(n) < 0.5, h, -h))
        p = np.stack([rad * np.cos(t), rad * np.sin(t), z], axis=1)
        nrm = np.where(side[:, None], np.stack([np.cos(t), np.sin(t),
                                                np.zeros(n)], axis=1),
                       np.stack([np.zeros(n), np.zeros(n), np.sign(z)], axis=1))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    a = rng.uniform(0, 2 * np.pi)
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]])
    return np.concatenate([p @ rot.T, nrm @ rot.T], axis=1).astype(np.float32)


def modelnet_setup(workdir, names, per_class=(1, 1), n_points=10000, seed=0):
    """Write synthetic shapes in ModelNet40's layout under
    ``<workdir>/modelnet40``: ``<shape>/<shape>_<nnnn>.txt`` (comma-separated
    x, y, z and normal, :func:`make_shape`) and the ``modelnet40_train.txt``
    / ``modelnet40_test.txt`` split lists, ``per_class`` (train, test)
    shapes of every class of ``names``. Returns the root."""
    root = os.path.join(workdir, "modelnet40")
    for split, per, first in (("train", per_class[0], 1),
                              ("test", per_class[1], per_class[0] + 1)):
        listed = []
        for c, shape in enumerate(names):
            os.makedirs(os.path.join(root, shape), exist_ok=True)
            for j in range(first, first + per):
                name = f"{shape}_{j:04d}"
                np.savetxt(os.path.join(root, shape, name + ".txt"),
                           make_shape(seed * 100003 + c * 1009 + j, c, n_points),
                           delimiter=",", fmt="%.6f")
                listed.append(name)
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("\n".join(listed) + "\n")
    return root


def cls_options(root, n_shapes, batch_size, steps, save_path, seed, workers=8):
    """The train entry point's overrides for ``steps`` steps of a ModelNet
    config at ``batch_size`` on the ``n_shapes`` train shapes under
    ``root``, in one epoch: the entry point loops the train split epoch //
    eval_epoch times an epoch, so ``epoch`` sets the loop (both ModelNet
    configs evaluate every 200 epochs). The cut epoch ends with the
    config's ClsEvaluator on the test split."""
    loop = -(-batch_size * steps // n_shapes)
    return [f"save_path={save_path}", f"batch_size={batch_size}",
            f"max_steps={steps}", f"num_worker={workers}", f"seed={seed}",
            f"epoch={200 * loop}", f"data.train.data_root={root}",
            f"data.val.data_root={root}", f"data.test.data_root={root}",
            "enable_tensorboard=False"]


def shapenetpart_setup(workdir, shapes=((0, 2500), (4, 2500)), seed=0):
    """Write synthetic shapes in ShapeNetPart's layout under
    ``<workdir>/shapenetpart``: synsetoffset2category.txt (the 16
    categories), ``<token>/<name>.txt`` (whitespace-separated x, y, z,
    normal, part) for each (category index, points) of ``shapes`` and the
    test split's ``train_test_split/shuffled_test_file_list.json``. A
    shape is :func:`make_shape`'s surface whose parts, the category's
    parts of ShapeNetPartDataset, split it in equal slabs along z."""
    from ao_tpu_torch.datasets.misc_datasets import ShapeNetPartDataset

    root = os.path.join(workdir, "shapenetpart")
    os.makedirs(os.path.join(root, "train_test_split"), exist_ok=True)
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        f.write("".join(f"{n}\t{t}\n" for n, t in SHAPENET_CATEGORIES))
    listed = []
    for i, (cat, n) in enumerate(shapes):
        name, token = SHAPENET_CATEGORIES[cat]
        pts = make_shape(seed + i, cat, n)
        parts = ShapeNetPartDataset.category2part[name]
        z = pts[:, 2]
        slab = ((z - z.min()) / max(np.ptp(z), 1e-6) * len(parts)).astype(int)
        label = np.asarray(parts)[np.clip(slab, 0, len(parts) - 1)]
        os.makedirs(os.path.join(root, token), exist_ok=True)
        np.savetxt(os.path.join(root, token, f"shape_{i}.txt"),
                   np.concatenate([pts, label[:, None]], axis=1), fmt="%.6f")
        listed.append(f"shape_data/{token}/shape_{i}")
    with open(os.path.join(root, "train_test_split",
                           "shuffled_test_file_list.json"), "w") as f:
        json.dump(listed, f)
    return root


def partseg_config(root, save_path, weight, backbone="PointTransformer-PartSeg50",
                   pad_multiple=1024):
    """A part-segmentation test config (the repo has none): ShapeNetPart's
    test split, coordinates normalised into the unit sphere, two views
    scaled by 0.9 and 1.1, features coord and normal; PT-v1 PartSeg with
    the 16 shape classes and 50 parts."""
    from ao_tpu_torch.utils import Config

    return Config(dict(
        save_path=save_path, weight=weight, pad_multiple=pad_multiple,
        data=dict(num_classes=50, ignore_index=-1, test=dict(
            type="ShapeNetPartDataset", split="test", data_root=root,
            transform=[dict(type="NormalizeCoord")], test_mode=True,
            test_cfg=dict(
                voxelize=None, crop=None,
                post_transform=[dict(type="ToTensor"), dict(
                    type="Collect", keys=("coord", "index"),
                    feat_keys=("coord", "normal"))],
                aug_transform=[[dict(type="RandomScale", scale=[0.9, 0.9])],
                               [dict(type="RandomScale", scale=[1.1, 1.1])]]))),
        model=dict(type="DefaultSegmentor", backbone=dict(
            type=backbone, in_channels=6, num_classes=50,
            num_shape_classes=16))))


def run_partseg(device, root, workdir, seed, backbone="PointTransformer-PartSeg50",
                pad_multiple=1024):
    """PartSegTester with random weights from ``seed`` on the shapes under
    ``root``; returns its result (ins.mIoU, cat.mIoU)."""
    from ao_tpu_torch.engines import TEST
    from ao_tpu_torch.models import build_model

    weight = os.path.join(workdir, "partseg.pt")
    cfg = partseg_config(root, os.path.join(workdir, "partseg_test"), weight,
                         backbone, pad_multiple)
    os.makedirs(cfg.save_path, exist_ok=True)
    torch.manual_seed(seed)
    torch.save(build_model(dict(cfg.model)).state_dict(), weight)
    return TEST.build(dict(type="PartSegTester", cfg=cfg, verbose=True,
                           device=str(device)))()


def voxel_sites(batch):
    """Sites a scene of SpUNet's level 0 when no discrete_coord is given:
    distinct floor(coord - the scene's minimum) of its valid points."""
    from ao_tpu_torch.models.sparse_unet.spunet import voxel_coords

    dc = voxel_coords(batch["coord"], batch["mask"])
    return [len(torch.unique(dc[b][batch["mask"][b]], dim=0))
            for b in range(dc.shape[0])]


def fps_cases(device, seed=0):
    """FPS inputs beside the path's own: a padded batch (a full scene and
    scenes of 12000 and 3 valid points in 16384 rows) and integer-grid
    points with exact ties (a 16^3 lattice, shuffled, two scenes)."""
    g = torch.Generator().manual_seed(seed)
    coord = torch.rand((3, 16384, 3), generator=g) * torch.tensor([6.0, 5.0, 3.0])
    mask = torch.zeros((3, 16384), dtype=torch.bool)
    for b, n in enumerate((16384, 12000, 3)):
        mask[b, :n] = True
    grid = torch.stack(torch.meshgrid(*[torch.arange(16.0)] * 3, indexing="ij"),
                       -1).reshape(-1, 3)
    lattice = torch.stack([grid[torch.randperm(len(grid), generator=g)]
                           for _ in range(2)])
    return [(coord.to(device), mask.to(device), 4096),
            (lattice.to(device), torch.ones(lattice.shape[:2], dtype=torch.bool,
                                            device=device), 1024)]


def ptv1_phase(device, seed, t0, card="", rooms=None, test_room=None, steps=3,
               test_views=None, batches=PTV1_BATCHES):
    """Phase 12: PT-v1 and the classification and part-segmentation tasks
    at full width (f32). FPS held against its plain version on
    :func:`fps_cases`. configs/s3dis/semseg-pt-v1-0-base.py (Seg50,
    AdamW, MultiStepLR) on the train phase's rooms (made here where None)
    written with their loop: one train step at the first of
    ``batches`` that fits (each that does not prints the peak
    reached) with its K1, K2 and FPS calls captured and held, then
    ``steps`` counted steps at that batch, one more timed for the exact
    kNN's share (:func:`profile_train_step`), and whole-scene testing of ``test_room``
    (the slice phase's) with the config's first ``test_views`` views (all 10
    where None), the kernel calls of its first fragment batch held. Then ModelNet40 shapes
    made here (:func:`modelnet_setup`: 40 classes, one train and one test
    shape each, 10000 points): configs/modelnet40/cls-ptv1-0-base.py as
    written (Cls26, B=32 x 1024, SGD nesterov, MultiStepLR) for ``steps``
    steps, its cut epoch ending with the ClsEvaluator, then its ClsTester
    through the test entry point, each with its FPS calls held;
    cls-spunet-v1m1-0-base.py ``steps`` steps at its B=16 with the sites a
    scene of its voxelisation printed. Then PartSeg50 with the
    PartSegTester on two ShapeNetPart shapes, its kernel calls held.
    Returns (kernel rows, launches by path, records)."""
    import gc

    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.models.point_transformer import ptv1
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.utils import Config

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="ao_chip_ptv1_")
    launches, records = {}, {}

    # FPS on the padded and tied inputs
    from ao_tpu_torch.ops import sampling

    cases = {("fps", i): ("fps", sampling.farthest_point_sampling, list(a))
             for i, a in enumerate(fps_cases(device, seed))}
    rows = hold_captured(type("Cases", (), dict(calls=cases))(), "fps cases")
    log(t0, "FPS cases held")

    # Seg50 on S3DIS: the batch that fits, its kernels held, counted steps
    if rooms is None:
        rooms = [make_room(s_, size) for s_, size in TRAIN_ROOMS]
    s3_dir, _ = train_setup(rooms, os.path.join(work, "s3dis_data"))
    s3_root = os.path.join(s3_dir, "s3dis")
    n_s3 = len(os.listdir(s3_root))

    def opts(batch, n_steps, name):
        return sparse_options(s3_root, n_s3, batch, n_steps,
                              os.path.join(work, name), seed)

    batch, rows_b = fit_batch(batches, "ptv1 seg50 train", card, lambda b: (
        capture_step(PTV1_CONFIG, opts(b, 1, f"seg50_k{b}"), device,
                     PTV1_KERNELS, t0, f"PT-v1 Seg50 train step B={b}")))
    rows += rows_b
    print(f"ptv1 seg50: B={batch} fits; captured step peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card}",
          flush=True)
    launches["seg50_train"], records["seg50_train"], trainer = train_run(
        f"s3dis ptv1 seg50 train B={batch}", PTV1_CONFIG, device,
        opts(batch, steps, "seg50"), steps, PTV1_KERNELS, multistep_of, card,
        keep=True)
    records["seg50_knn"] = profile_train_step(
        trainer, next(iter(trainer.train_loader)), ptv1, warm=False,
        traced=False)
    print(json.dumps({"ptv1_seg50_step_profile": dict(
        records["seg50_knn"], card=card)}), flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    log(t0, "PT-v1 Seg50 train done")

    setup = slice_setup(test_room if test_room is not None
                        else make_room(seed), views=test_views,
                        workdir=os.path.join(work, "scene"))
    workdir, options, n_views = setup
    torch.manual_seed(seed)
    torch.save(build_model(dict(Config.fromfile(PTV1_CONFIG).model)).state_dict(),
               os.path.join(workdir, "model.pt"))
    t = time.perf_counter()
    # the first fragment batch's kernel calls held (a plain FPS at 65536
    # points takes seconds)
    (result, launches["seg50_test"]), held_rows = held(
        PTV1_KERNELS, "PT-v1 Seg50 scene test", lambda: _drive(
            PTV1_KERNELS, lambda: test_main(
                ["--config-file", PTV1_CONFIG, "--device", str(device),
                 "--options", *options])),
        limit={"fps": 4, "knn_window": 3, "merge_topk": 3})
    rows += held_rows
    votes = np.load(os.path.join(workdir, "exp", "result", "office_1_pred.npy"))
    check_votes(votes, n_views)
    scene = result["scenes"][0]
    records["seg50_test"] = dict(scene, seconds_total=time.perf_counter() - t)
    print(f"s3dis ptv1 seg50 test: {scene['fragments']} fragments in batches "
          f"(B, N) {scene['batches']}; scene {scene['seconds']:.2f} s; votes "
          f"{votes.shape}; mIoU {result['mIoU']:.4f} (random weights); launches "
          f"{launches['seg50_test']}; card {card}", flush=True)
    torch.cuda.empty_cache()
    log(t0, "PT-v1 Seg50 scene test done")

    # ModelNet40: Cls26 with its evaluator and tester, SpUNet cls_mode
    names = list(Config.fromfile(CLS_CONFIG).data.names)
    mn_root = modelnet_setup(work, names, seed=seed)
    (launches["cls_train"], records["cls_train"], trainer), held_rows = held(
        ("fps", "point_bn"), "Cls26 train B=32", lambda: train_run(
            "modelnet40 ptv1 cls26 train B=32 (as written)", CLS_CONFIG, device,
            cls_options(mn_root, len(names), 32, steps, os.path.join(work, "cls"),
                        seed), steps, ("fps", "point_bn"), multistep_of, card, keep=True))
    rows += held_rows
    val = trainer.comm_info.get("val_result")
    if val is None or not (np.isfinite(val["mAcc"]) and np.isfinite(val["allAcc"])):
        raise RuntimeError(f"the ClsEvaluator gave no finite result: {val}")
    records["cls_val"] = val
    del trainer
    torch.cuda.empty_cache()
    (res, launches["cls_test"]), held_rows = held(
        ("fps", "point_bn"), "Cls26 test", lambda: _drive(
            ("fps", "point_bn"), lambda: test_main(
                ["--config-file", CLS_CONFIG, "--device", str(device),
                 "--options",
                 f"weight={os.path.join(work, 'cls', 'model', 'model_last.pt')}",
                 f"save_path={os.path.join(work, 'cls_test')}",
                 f"data.test.data_root={mn_root}"])))
    rows += held_rows
    if not (np.isfinite(res["mAcc"]) and np.isfinite(res["allAcc"])):
        raise RuntimeError(f"the ClsTester gave no finite result: {res}")
    records["cls_test"] = res
    print(f"modelnet40 ptv1 cls26: ClsEvaluator mAcc {val['mAcc']:.4f} allAcc "
          f"{val['allAcc']:.4f} ({val['batches']} batches, {val['seconds']:.2f} "
          f"s); ClsTester mAcc {res['mAcc']:.4f} allAcc {res['allAcc']:.4f} "
          f"(random weights, {steps} steps); card {card}", flush=True)
    launches["cls_spunet_train"], records["cls_spunet_train"], trainer = train_run(
        "modelnet40 spunet cls train B=16 (as written)", CLS_SPUNET_CONFIG,
        device, cls_options(mn_root, len(names), 16, steps,
                            os.path.join(work, "cls_spunet"), seed) + [
            "evaluate=False"], steps, BN_KERNELS, multistep_of, card, keep=True)
    sites = voxel_sites(next(iter(trainer.train_loader)))
    records["cls_spunet_sites"] = sites
    print(f"modelnet40 spunet cls: level-0 sites a scene {sites} (no GridSample "
          f"in the config: floor(coord - min) of the unit-sphere shapes); card "
          f"{card}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    log(t0, "ModelNet40 done")

    # PartSeg50 with the PartSegTester
    ps_root = shapenetpart_setup(work, seed=seed)
    (res, launches["partseg_test"]), held_rows = held(
        PTV1_KERNELS, "PartSeg50 test", lambda: _drive(
            PTV1_KERNELS, lambda: run_partseg(device, ps_root, work, seed)))
    rows += held_rows
    if not (np.isfinite(res["ins_mIoU"]) and np.isfinite(res["cat_mIoU"])):
        raise RuntimeError(f"the PartSegTester gave no finite result: {res}")
    records["partseg_test"] = res
    print(f"shapenetpart ptv1 partseg50: ins.mIoU {res['ins_mIoU']:.4f} cat.mIoU "
          f"{res['cat_mIoU']:.4f} (random weights, 2 shapes, 2 views); launches "
          f"{launches['partseg_test']}; card {card}", flush=True)
    log(t0, f"PT-v1 phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, records


# ---------------------------------------------------------------------------
# phase 13: Swin3D-v1m1 (cRSE window attention over occupied windows)
# ---------------------------------------------------------------------------

SWIN3D_CONFIG = os.path.join(ROOT, "configs", "scannet",
                             "semseg-swin3d-v1m1-0-small.py")
SWIN3D_LARGE_CONFIG = os.path.join(ROOT, "configs", "scannet",
                                   "semseg-swin3d-v1m1-1-large.py")
# the batches tried in turn until one fits: the small config's from its own
# 12, the large config's (one step)
SWIN3D_BATCHES = (12, 8, 6, 4, 3, 2)
SWIN3D_LARGE_BATCHES = (4, 2, 1)
# the full run's: the small config's batch the ladder found (B=12 and 8 ran
# out of memory unmixed on an 80 GB card) and the scene test's views
SWIN3D_BATCH = 6
FULL_RUN_TEST_VIEWS = 1
# the kernels of the Swin3D, Stratified and OctFormer paths: the decoder's
# 3-NN interpolation above 2M query x key pairs (2-probe curve search: K1,
# then K2's fused merge)
UNPOOL_KERNELS = ("knn_window", "merge_topk")
# and Swin3D's PointBatchNorm (its stem and its head)
SWIN3D_KERNELS = UNPOOL_KERNELS + ("point_bn",)


class SwinSteps:
    """While active, keeps after every train step each block's window
    statistics (stage, block, then the block's own: Swin3D's occupied rows,
    rows, points dropped beyond num_windows and beyond the capacity, the
    Stratified Transformer's with its coarse pack's after them), where the
    backbone has them, and, from before the step, each parameter group's
    lr."""

    def __enter__(self):
        from ao_tpu_torch.engines.train import Trainer

        self.stats, self.lrs = [], []
        self._orig = Trainer._step

        def step(trainer, batch):
            self.lrs.append([g["lr"] for g in trainer.optimizer.param_groups])
            out = self._orig(trainer, batch)
            stats = getattr(trainer.model.backbone, "window_stats", None)
            if stats is not None:
                self.stats.append([tuple(int(x) for x in st) for st in stats])
            return out

        Trainer._step = step
        return self

    def __exit__(self, *exc):
        from ao_tpu_torch.engines.train import Trainer

        Trainer._step = self._orig


def window_summary(stats):
    """Per stage: each block's own statistics (:class:`SwinSteps`: occupied
    rows, rows, dropped beyond num_windows, dropped beyond the capacity,
    and the coarse pack's after them) of one step."""
    out = {}
    for s, _, *rest in stats:
        out.setdefault(s, []).append(tuple(rest))
    return out


def scannet_scene_test(config, device, sc_root, work, seed, label, card,
                       views=None, kernels=UNPOOL_KERNELS):
    """Whole-scene testing of the ScanNet val room through the test entry
    point with the config's first ``views`` views (all where None) and
    random weights from ``seed``, driven with the launch counts set to 0
    just before and read just after, the calls of ``kernels`` in its first
    fragments held; votes checked. Returns (launches, kernel rows, the
    scene's record)."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.utils import Config

    cfg = Config.fromfile(config)
    torch.manual_seed(seed)
    weight = os.path.join(work, f"{label}.pt")
    torch.save(build_model(dict(cfg.model)).state_dict(), weight)
    aug = cfg.data.test.test_cfg.aug_transform[:views]
    save = os.path.join(work, f"{label}_test")
    (result, launches), rows = held(
        kernels, f"{label} scene test", lambda: _drive(
            kernels, lambda: test_main([
                "--config-file", config, "--device", str(device), "--options",
                f"weight={weight}", f"save_path={save}",
                f"data.test.data_root={sc_root}",
                f"data.test.test_cfg.aug_transform={aug!r}"])),
        limit={"knn_window": 4, "merge_topk": 4})
    names = sorted(os.listdir(os.path.join(sc_root, "val")))
    votes = np.load(os.path.join(save, "result", names[0].replace(".pth", "_pred.npy")))
    check_votes(votes, len(aug), num_classes=20)
    scene = result["scenes"][0]
    print(f"scannet {label} test ({len(aug)} views): {scene['fragments']} fragments "
          f"in batches (B, N) {scene['batches']}; scene {scene['seconds']:.2f} s; "
          f"votes {votes.shape}; mIoU {result['mIoU']:.4f} (random weights); "
          f"launches {launches}; card {card}", flush=True)
    return launches, rows, scene


def swin3d_phase(device, seed, t0, card="", scannet_dir=None, steps=3,
                 batches=(SWIN3D_BATCH,), views=None, traced=True):
    """Phase 13: configs/scannet/semseg-swin3d-v1m1-0-small.py as written
    (f32, AdamW with the tables' param_dicts group, OneCycle, Mix3D) on the
    ScanNet phase's rooms (written under ``scannet_dir``; made here where
    None): one train step at the first of ``batches`` that fits
    unmixed (mix_prob 0: every scene at max_points, Mix3D's worst case; each
    batch that does not fit prints the peak reached) with its K1 and K2
    calls captured and held against their plain versions, ``steps``
    counted steps at that batch as written (losses finite, parameters moved, OneCycle's lr in both
    groups, the windows each stage occupies and drops, step seconds, data
    wait, peak memory), one more timed for the share of the downsampling's
    exact kNN and, with ``traced``, one traced for device time by kernel
    (:func:`profile_train_step`); the
    large config's one step at the first of
    :data:`SWIN3D_LARGE_BATCHES` that fits unmixed; whole-scene testing of the
    ScanNet room with the config's first ``views`` views (all 10 where
    None), the kernel calls of its first fragments held. Returns (kernel
    rows, launches by path, records)."""
    import gc

    from ao_tpu_torch.models.swin3d import swin3d

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="ao_chip_swin3d_")
    if scannet_dir is None:
        scannet_dir, _ = scannet_setup(
            [make_scannet_room(s_, size) for s_, size in SCANNET_ROOMS],
            make_scannet_room(*SCANNET_TEST_ROOM), workdir=work)
    sc_root = os.path.join(scannet_dir, "scannet")
    n_sc = len(os.listdir(os.path.join(sc_root, "train")))
    launches, records = {}, {}

    def opts(batch, n_steps, name):
        return sparse_options(sc_root, n_sc, batch, n_steps,
                              os.path.join(work, name), seed)

    # a batch fits when its step fits unmixed: Mix3D merges pairs of
    # scenes into one of at most max_points, so a mixed step holds fewer
    batch, rows = fit_batch(batches, "scannet swin3d train unmixed", card, lambda b: (
        capture_step(SWIN3D_CONFIG, opts(b, 1, f"kernels_b{b}") + ["mix_prob=0"],
                     device, SWIN3D_KERNELS, t0, f"Swin3D train step B={b}")))
    print(f"scannet swin3d: B={batch} fits unmixed; captured step peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card}",
          flush=True)
    torch.cuda.empty_cache()
    with SwinSteps() as seen:
        launches["train"], records["train"], trainer = train_run(
            f"scannet swin3d train B={batch} (as written)", SWIN3D_CONFIG, device,
            opts(batch, steps, "train"), steps, SWIN3D_KERNELS, onecycle_of, card,
            keep=True)
    groups = trainer.optimizer.param_groups
    n_tables = sum("table" in n for n, _ in trainer.model.named_parameters())
    if len(groups) != 2 or len(groups[1]["params"]) != n_tables:
        raise RuntimeError("the config's param_dicts did not group the tables")
    for i, (default, table) in enumerate(seen.lrs):
        if abs(table - default) > 1e-12 * default:
            raise RuntimeError(f"step {i}: the table group's lr {table} is not "
                               f"the default group's {default}")
    print(f"scannet swin3d param_dicts: {n_tables} tables in their group (lr "
          f"{trainer.cfg.param_dicts[0].lr} as configured); lr per step (default"
          f", tables) {seen.lrs} (OneCycle's max_lr peaks both); card {card}",
          flush=True)
    records["train"]["windows"] = [window_summary(st) for st in seen.stats]
    for s, blocks in window_summary(seen.stats[-1]).items():
        print(f"scannet swin3d stage {s} (last step, per block): occupied rows "
              f"{[b[0] for b in blocks]} of {blocks[0][1]}; points dropped beyond "
              f"num_windows {[b[2] for b in blocks]}, beyond the capacity "
              f"{[b[3] for b in blocks]}", flush=True)
    records["trace"] = profile_train_step(
        trainer, next(iter(trainer.train_loader)), swin3d, warm=False,
        traced=traced)
    print(json.dumps({"scannet_swin3d_step_profile": dict(
        records["trace"], card=card)}), flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    log(t0, "Swin3D train done")

    large, (launches["large_train"], records["large_train"]) = fit_batch(
        SWIN3D_LARGE_BATCHES, "scannet swin3d large train unmixed", card,
        lambda b: train_run(
            f"scannet swin3d large train B={b} (unmixed)", SWIN3D_LARGE_CONFIG,
            device, opts(b, 1, f"large_b{b}") + ["mix_prob=0"], 1,
            SWIN3D_KERNELS, onecycle_of, card))
    print(f"scannet swin3d large: B={large} fits unmixed; peak memory "
          f"{records['large_train']['peak_gib']:.2f} GiB, step "
          f"{records['large_train']['step_seconds'][0]:.4f} s; card {card}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(t0, "Swin3D large step done")

    launches["test"], held_rows, records["test"] = scannet_scene_test(
        SWIN3D_CONFIG, device, sc_root, work, seed, "swin3d", card, views,
        SWIN3D_KERNELS)
    rows += held_rows
    torch.cuda.empty_cache()
    log(t0, f"Swin3D phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, records


# ---------------------------------------------------------------------------
# phases 14 and 15: the Stratified Transformer and OctFormer
# ---------------------------------------------------------------------------

ST_CONFIG = os.path.join(ROOT, "configs", "scannet", "semseg-st-v1m1-0-origin.py")
ST_REFINED_CONFIG = os.path.join(ROOT, "configs", "scannet",
                                 "semseg-st-v1m2-0-refined.py")
OCTFORMER_CONFIG = os.path.join(ROOT, "configs", "scannet",
                                "semseg-octformer-v1m1-0-base.py")
# the ST-v1m2 configs set in_channels=9 over the 6 features their Collect
# gives (colour, normal): the port sizes the KPConv kernel from
# in_channels and refuses the mismatch, so the run sets the 6 the data
# gives (ROADMAP.md section 3)
ST_REFINED_IN = ("model.backbone.in_channels=6",)
# the batches the flags (--stratified, --octformer) try in turn until an
# unmixed step and the counted steps fit, from the configs' own 12; the
# full run takes the one they found on an 80 GB card
ST_BATCHES = (12, 10, 8, 7, 6, 5, 4, 3, 2)
OCTFORMER_BATCHES = (12, 10, 8, 7, 6, 5, 4, 3, 2)
ST_BATCH = 8
OCTFORMER_BATCH = 7
# the views of their scene tests (the configs' first ones, of 10)
ST_OCTFORMER_TEST_VIEWS = 2


def warmup_multistep_of(trainer):
    """MultiStepWithWarmupLR per step: MultiStepLR's factor times the linear
    warmup from warmup_scale over warmup_rate of the steps."""
    s, base = trainer.cfg.scheduler, trainer.cfg.optimizer.lr
    total = trainer.total_steps
    bounds = [int(r * total) for r in s.milestones]
    warmup = s.warmup_rate * total

    def lr(i):
        f = s.gamma ** sum(i >= b for b in bounds)
        if i <= warmup:
            f *= 1.0 - (1.0 - i / warmup) * (1.0 - s.warmup_scale)
        return base * f

    return lr


def stratified_phase(device, seed, t0, card="", scannet_dir=None, steps=3,
                     batches=(ST_BATCH,), traced=False):
    """Phase 14: configs/scannet/semseg-st-v1m1-0-origin.py as written (f32,
    AdamW, MultiStepLR, Mix3D; 5 stages, C up to 384, the KPConv embedding's
    exact 16-NN) on the ScanNet phase's rooms (written under
    ``scannet_dir``; made here where None): at the first of ``batches``
    that fits (the peak reached printed for each that does not), one
    unmixed train step (Mix3D's worst case) with its K1 and K2 calls
    captured and held against their plain versions, then ``steps`` counted
    steps at that batch as written (losses finite, parameters moved,
    MultiStepLR's lr, each block's occupied window rows and drops of the
    fine and coarse packs, step seconds, data wait, peak memory), one more
    timed for the exact kNN's share (:func:`profile_train_step`) and, with
    ``traced``, one traced for device time by kernel; one
    step of semseg-st-v1m2-0-refined.py at that batch with
    ``in_channels=6``; whole-scene testing of the ScanNet room with the
    origin config's first views (:func:`scannet_scene_test`). Returns
    (kernel rows, launches by path, records)."""
    import gc

    from ao_tpu_torch.models.stratified_transformer import stratified

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="ao_chip_st_")
    if scannet_dir is None:
        scannet_dir, _ = scannet_setup(
            [make_scannet_room(s_, size) for s_, size in SCANNET_ROOMS],
            make_scannet_room(*SCANNET_TEST_ROOM), workdir=work)
    sc_root = os.path.join(scannet_dir, "scannet")
    n_sc = len(os.listdir(os.path.join(sc_root, "train")))
    launches, records = {}, {}

    def opts(batch, n_steps, name):
        return sparse_options(sc_root, n_sc, batch, n_steps,
                              os.path.join(work, name), seed)

    def attempt(b):
        rows = capture_step(ST_CONFIG, opts(b, 1, f"kernels_b{b}") + ["mix_prob=0"],
                            device, UNPOOL_KERNELS, t0, f"ST-v1m1 train step B={b}")
        print(f"scannet st-v1m1: B={b} fits unmixed; captured step peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card}",
              flush=True)
        torch.cuda.empty_cache()
        with SwinSteps() as seen:
            out = train_run(
                f"scannet st-v1m1 train B={b} (as written)", ST_CONFIG, device,
                opts(b, steps, "train"), steps, UNPOOL_KERNELS, multistep_of, card,
                keep=True)
        return (rows, seen) + out

    batch, (rows, seen, launches["train"], records["train"], trainer) = fit_batch(
        batches, "scannet st-v1m1 train", card, attempt)
    records["train"]["windows"] = [window_summary(st) for st in seen.stats]
    for s, blocks in window_summary(seen.stats[-1]).items():
        print(f"scannet st-v1m1 stage {s} (last step, per block): occupied rows "
              f"{[b[0] for b in blocks]} of {blocks[0][1]}, dropped beyond "
              f"num_windows {[b[2] for b in blocks]}, beyond the capacity "
              f"{[b[3] for b in blocks]}; coarse rows {[b[4] for b in blocks]}, "
              f"dropped beyond num_windows {[b[5] for b in blocks]}, beyond the "
              f"capacity {[b[6] for b in blocks]}", flush=True)
    records["trace"] = profile_train_step(
        trainer, next(iter(trainer.train_loader)), stratified, warm=False,
        traced=traced)
    print(json.dumps({"scannet_st_v1m1_step_profile": dict(
        records["trace"], card=card)}), flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    log(t0, "ST-v1m1 train done")

    launches["refined_train"], records["refined_train"] = train_run(
        f"scannet st-v1m2 refined train B={batch} (in_channels=6)",
        ST_REFINED_CONFIG, device, opts(batch, 1, "refined") + list(ST_REFINED_IN),
        1, UNPOOL_KERNELS, multistep_of, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(t0, "ST-v1m2 step done")

    launches["test"], held_rows, records["test"] = scannet_scene_test(
        ST_CONFIG, device, sc_root, work, seed, "st-v1m1", card,
        ST_OCTFORMER_TEST_VIEWS)
    rows += held_rows
    torch.cuda.empty_cache()
    log(t0, f"Stratified phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, records


def octformer_phase(device, seed, t0, card="", scannet_dir=None, steps=3,
                    batches=(OCTFORMER_BATCH,), traced=False):
    """Phase 15: configs/scannet/semseg-octformer-v1m1-0-base.py as written
    (f32, C 96 / 192 / 384 / 384, depths 2 / 2 / 18 / 2, groups of 26,
    dilation 4, AdamW with the config's "blocks" parameter group,
    MultiStepWithWarmupLR, Mix3D) on the ScanNet phase's rooms: at the
    first of ``batches`` that fits, one unmixed train step with its K1 and
    K2 calls held, then ``steps`` counted steps as written (each parameter
    group's lr each step: the default group's the schedule's at lr 0.0015,
    the empty "blocks" group's at its own 0.00015), one more timed for the
    exact kNN's share (the CPE's stage graphs) and, with ``traced``, one
    traced for device time by kernel; whole-scene testing of the
    ScanNet room with the config's first views. Returns (kernel rows,
    launches by path, records)."""
    import gc

    from ao_tpu_torch.models.octformer import octformer

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="ao_chip_octformer_")
    if scannet_dir is None:
        scannet_dir, _ = scannet_setup(
            [make_scannet_room(s_, size) for s_, size in SCANNET_ROOMS],
            make_scannet_room(*SCANNET_TEST_ROOM), workdir=work)
    sc_root = os.path.join(scannet_dir, "scannet")
    n_sc = len(os.listdir(os.path.join(sc_root, "train")))
    launches, records = {}, {}

    def opts(batch, n_steps, name):
        return sparse_options(sc_root, n_sc, batch, n_steps,
                              os.path.join(work, name), seed)

    def attempt(b):
        rows = capture_step(OCTFORMER_CONFIG, opts(b, 1, f"kernels_b{b}")
                            + ["mix_prob=0"], device, UNPOOL_KERNELS, t0,
                            f"OctFormer train step B={b}")
        print(f"scannet octformer: B={b} fits unmixed; captured step peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card "
              f"{card}", flush=True)
        torch.cuda.empty_cache()
        with SwinSteps() as seen:
            out = train_run(
                f"scannet octformer train B={b} (as written)", OCTFORMER_CONFIG,
                device, opts(b, steps, "train"), steps, UNPOOL_KERNELS,
                warmup_multistep_of, card, keep=True)
        return (rows, seen) + out

    batch, (rows, seen, launches["train"], records["train"], trainer) = fit_batch(
        batches, "scannet octformer train", card, attempt)
    groups = trainer.optimizer.param_groups
    n_params = len(list(trainer.model.parameters()))
    if [len(g["params"]) for g in groups] != [n_params, 0]:
        raise RuntimeError("the config's \"blocks\" group is not the empty second one")
    blocks_lr = trainer.cfg.param_dicts[0].lr
    for i, (default, blocks) in enumerate(seen.lrs):
        if abs(blocks / default - blocks_lr / trainer.cfg.optimizer.lr) > 1e-9:
            raise RuntimeError(f"step {i}: the blocks group's lr {blocks} does not "
                               f"follow the schedule at its own lr {blocks_lr}")
    print(f"scannet octformer param_dicts: {n_params} parameters in the default "
          f"group, 0 in the \"blocks\" group; lr per step (default, blocks) "
          f"{seen.lrs} (MultiStepWithWarmupLR over {trainer.total_steps} steps); "
          f"card {card}", flush=True)
    records["train"]["lrs"] = seen.lrs
    records["trace"] = profile_train_step(
        trainer, next(iter(trainer.train_loader)), octformer, warm=False,
        traced=traced)
    print(json.dumps({"scannet_octformer_step_profile": dict(
        records["trace"], card=card)}), flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    log(t0, "OctFormer train done")

    launches["test"], held_rows, records["test"] = scannet_scene_test(
        OCTFORMER_CONFIG, device, sc_root, work, seed, "octformer", card,
        ST_OCTFORMER_TEST_VIEWS)
    rows += held_rows
    torch.cuda.empty_cache()
    log(t0, f"OctFormer phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, records


def _wrappers():
    """The kernels' wrappers (the wrapper itself where a counting shim of
    :class:`InstanceLaunches` stands in its place)."""
    from ao_tpu_torch.ops import gva, knn_spatial, point_bn, sampling

    ws = {"knn_window": knn_spatial.knn_window,
          "merge_topk": knn_spatial.merge_topk_probes,
          "gva_eval": gva.gva_eval,
          "gva_pos": gva.gva_pos, "gva_stats": gva.gva_stats,
          "gva_bwd": gva.gva_bwd, "fps": sampling.farthest_point_sampling,
          "point_bn": point_bn.point_batch_norm}
    return {n: getattr(w, "__wrapped__", w) for n, w in ws.items()}


class StepLaunches:
    """Counts each kernel's launches inside train steps only (the trainer's
    ``_step``: forward, loss, backward, optimizer), not in evaluations."""

    def __enter__(self):
        from ao_tpu_torch.engines.train import Trainer

        self.total = {n: 0 for n in KERNEL_INFO}
        self.steps = 0
        self._orig = Trainer._step
        wrappers = _wrappers()

        def step(trainer, batch):
            before = {n: w.launches for n, w in wrappers.items()}
            out = self._orig(trainer, batch)
            for n, w in wrappers.items():
                self.total[n] += w.launches - before[n]
            self.steps += 1
            return out

        Trainer._step = step
        return self

    def __exit__(self, *exc):
        from ao_tpu_torch.engines.train import Trainer

        Trainer._step = self._orig

    def per_step(self):
        return {n: v / max(self.steps, 1) for n, v in self.total.items()}


def _drive(path_kernels, fn):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after; fail if a kernel of the path never launched."""
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    launches = {n: w.launches for n, w in wrappers.items()}
    missing = [n for n in path_kernels if launches[n] <= 0]
    if missing:
        raise RuntimeError(f"kernels of the path never launched: {missing} "
                           f"({launches})")
    return out, launches


# ---------------------------------------------------------------------------
# phase 16: PointContrast on ScanNet frame pairs

POINTCONTRAST_CONFIG = os.path.join(
    ROOT, "configs", "scannet", "pretrain-msc-v1m1-1-spunet-pointcontrast.py")
# ScanNet's depth camera (640 x 480; the intrinsics of its scene0000_00)
SENS_HW = (480, 640)
SENS_INTRINSIC = np.array([[577.590698, 0.0, 318.905426, 0.0],
                           [0.0, 578.729797, 242.683609, 0.0],
                           [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
# (make_room seed, room size in m) of each scene and its frames (34 pairs
# over the config's overlap 0.3); the batches (pairs a step) that
# --pointcontrast tries in turn from the config's own 32 until one fits,
# and the full run's
PAIR_SCENES = ((21, (4.8, 4.0, 2.6)), (22, (5.2, 4.4, 2.8)),
               (23, (5.0, 4.2, 2.7)))
PAIR_FRAMES = 8
PAIR_SPACING = 0.02
POINTCONTRAST_BATCHES = (32, 24, 16)
POINTCONTRAST_BATCH = 32


def write_sens(path, poses, depths, colors, intrinsic):
    """A ScanNet ``.sens`` stream, version 4: the depth intrinsics as
    colour and depth intrinsics, JPEG colour, zlib 16-bit depth (mm) at
    the colour's size, each frame's camera-to-world pose."""
    import io
    import struct
    import zlib

    from PIL import Image

    with open(path, "wb") as f:
        f.write(struct.pack("I", 4))
        name = b"synthetic"
        f.write(struct.pack("Q", len(name)) + name)
        for m in (intrinsic, np.eye(4), intrinsic, np.eye(4)):
            f.write(np.asarray(m, np.float32).tobytes())
        f.write(struct.pack("ii", 2, 1))  # jpeg colour, zlib depth
        h, w = depths[0].shape
        f.write(struct.pack("IIII", w, h, w, h))
        f.write(struct.pack("f", 1000.0))
        f.write(struct.pack("Q", len(poses)))
        for pose, depth, color in zip(poses, depths, colors):
            f.write(np.asarray(pose, np.float32).tobytes())
            f.write(struct.pack("QQ", 0, 0))
            buf = io.BytesIO()
            Image.fromarray(color).save(buf, format="JPEG")
            cb, db = buf.getvalue(), zlib.compress(depth.astype(np.uint16).tobytes())
            f.write(struct.pack("QQ", len(cb), len(db)) + cb + db)


def render_frame(room, pose, intrinsic=SENS_INTRINSIC, hw=SENS_HW):
    """(depth uint16 in mm, colour uint8 (h, w, 3)) of a room's points seen
    by a camera (x right, y down, z forward) at ``pose`` (camera to world),
    the nearest point winning each pixel; pixels no point reaches stay 0."""
    h, w = hw
    R, t = pose[:3, :3], pose[:3, 3]
    cam = (room["coord"] - t) @ R
    keep = cam[:, 2] > 0.1
    cam, col = cam[keep], room["color"][keep]
    u = np.round(intrinsic[0, 0] * cam[:, 0] / cam[:, 2] + intrinsic[0, 2])
    v = np.round(intrinsic[1, 1] * cam[:, 1] / cam[:, 2] + intrinsic[1, 2])
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (cam[:, 2] < 60.0)
    pix = (v[ok] * w + u[ok]).astype(np.int64)
    z, col = cam[ok, 2], col[ok]
    order = np.argsort(-z, kind="stable")  # the nearest written last
    depth = np.zeros(h * w, np.uint16)
    color = np.zeros((h * w, 3), np.uint8)
    depth[pix[order]] = np.round(z[order] * 1000.0).astype(np.uint16)
    color[pix[order]] = col[order].astype(np.uint8)
    return depth.reshape(h, w), color.reshape(h, w, 3)


def sens_frames(seed, size, frames, spacing=PAIR_SPACING):
    """(poses, depths, colours) of ``frames`` views of :func:`make_room`
    (seed, size, spacing) from 1.4 m above its floor, off its centre,
    turning 20 degrees a frame, so that each view overlaps the next."""
    room = make_room(seed, size, spacing)
    rng = np.random.default_rng(seed)
    eye = np.array([size[0] * 0.45, size[1] * 0.5, 1.4])
    yaw0 = rng.uniform(0, 2 * np.pi)
    poses, depths, colors = [], [], []
    for f in range(frames):
        yaw = yaw0 + np.deg2rad(20.0) * f
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        pose = np.eye(4)
        pose[:3, :3] = np.stack([right, [0.0, 0.0, -1.0], fwd], axis=1)
        pose[:3, 3] = eye
        depth, color = render_frame(room, pose)
        poses.append(pose)
        depths.append(depth)
        colors.append(color)
    return poses, depths, colors


def write_pair_scenes(raw, scenes=PAIR_SCENES, frames=PAIR_FRAMES,
                      spacing=PAIR_SPACING):
    """ScanNet-layout scenes ``<raw>/scene<i>_00/scene<i>_00.sens`` of
    :func:`sens_frames`, one per (seed, size) of ``scenes``."""
    for i, (seed, size) in enumerate(scenes):
        scene = os.path.join(raw, f"scene{i:04d}_00")
        os.makedirs(scene, exist_ok=True)
        write_sens(os.path.join(scene, f"scene{i:04d}_00.sens"),
                   *sens_frames(seed, size, frames, spacing), SENS_INTRINSIC)


def pair_setup(workdir, scenes=PAIR_SCENES, frames=PAIR_FRAMES,
               spacing=PAIR_SPACING):
    """:func:`write_pair_scenes` under ``<workdir>/raw``, then the port's
    preprocessor over them (every frame kept) into
    ``<workdir>/scannet_pair``. Returns (the output root, the
    preprocessor's seconds)."""
    from ao_tpu_torch.datasets.preprocessing import preprocess_scannet_pair

    write_pair_scenes(os.path.join(workdir, "raw"), scenes, frames, spacing)
    out = os.path.join(workdir, "scannet_pair")
    t = time.perf_counter()
    preprocess_scannet_pair.main(["--dataset-root", os.path.join(workdir, "raw"),
                                  "--output-root", out, "--frame-skip", "1"])
    return out, time.perf_counter() - t


# ---------------------------------------------------------------------------
# data parallelism (phase 17; tests/test_torch_ddp.py runs the same
# recorder on the CPU over gloo)


class SeededItems:
    """A dataset's ``prepare_train_data`` with the transforms' draws (torch's
    default CPU generator, and numpy's) seeded by the scene's index, so
    that a scene takes the same augmentation whichever process loads it,
    and in whatever order."""

    def __init__(self, fn, seed):
        self.fn, self.seed = fn, seed

    def __call__(self, idx):
        s = (self.seed * 7919 + idx) % 2**32
        torch.default_generator.manual_seed(s)
        np.random.seed(s)
        return self.fn(idx)


def record_worker(cfg, device):
    """One process of a recorded run (the launcher's ``main_func``): the
    Trainer on this process's device, its train items seeded by
    :class:`SeededItems`, trained as ``tools.train`` trains it; every step
    records its (global) loss, seconds, kernel launches, collectives, and
    the parameters and running statistics after it (on the CPU). Options
    of ``cfg``: ``record_path`` (a directory: ``rank<r>.pt`` is written
    there), ``record_batches`` (keep each step's batch), ``record_timed``
    (the step whose collectives are timed, their seconds beside it),
    ``record_hold`` (process 0 holds K1-K6 of its first step against
    their plain versions at its own shapes, as phase 4 does),
    ``record_fault`` (a fault of :func:`plant_fault` in the step's gradient
    reduction, to show that the comparison catches it),
    ``record_deterministic`` (PyTorch's deterministic algorithms where it
    has them, a warning where not)."""
    from contextlib import nullcontext

    from ao_tpu_torch.engines import Trainer, local_device
    from ao_tpu_torch.utils import comm

    device = local_device(device)
    cuda = device.type == "cuda"
    trainer = Trainer(cfg, device=device)
    ds = trainer.train_loader.dataset
    ds.prepare_train_data = SeededItems(ds.prepare_train_data, cfg.seed)
    wrappers = _wrappers()
    steps, holds, init = [], [], {}
    inner = trainer._step

    def snapshot():
        return dict(
            params={n: p.detach().float().cpu().clone()
                    for n, p in trainer.model.named_parameters()},
            stats={n: b.detach().float().cpu().clone()
                   for n, b in trainer.model.named_buffers() if "running" in n})

    def step(batch):
        if not steps:
            init.update(snapshot())
        before = {n: w.launches for n, w in wrappers.items()}
        comm.reset_counts()
        cap = None
        if cfg.get("record_hold") and comm.is_main_process() and not steps:
            cap = Capture().wrap_path(TRAIN_KERNELS)
        timed = len(steps) == cfg.get("record_timed", -1)
        if cuda:
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        try:
            with comm.timed() if timed else nullcontext():
                out = inner(batch)
                loss = float(out[0]["loss"])
            if cuda:
                torch.cuda.synchronize(device)
        finally:
            if cap is not None:
                cap.restore()
        rec = dict(
            loss=loss, seconds=time.perf_counter() - t, timed=timed,
            grad_norm=float(out[0]["grad_norm"]),
            overflow=float(out[0].get("pool_overflow", 0.0)),
            shape=tuple(trainer._masks(batch)[0].shape),
            collectives=comm.COUNTS["collectives"],
            collective_seconds=comm.COUNTS["seconds"],
            launches={n: w.launches - before[n] for n, w in wrappers.items()},
            **snapshot())
        if cfg.get("record_batches"):
            rec["batch"] = {k: v.clone() for k, v in batch.items()
                            if torch.is_tensor(v)}
        steps.append(rec)
        if cap is not None:
            holds.extend(hold_captured(cap, f"train, rank 0 of "
                                            f"{comm.get_world_size()}"))
        return out

    trainer._step = step
    if cfg.get("record_fault"):
        plant_fault(trainer, cfg.record_fault)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if cfg.get("record_deterministic"):
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        trainer.train()
    finally:
        torch.use_deterministic_algorithms(False)
    torch.save(dict(
        rank=comm.get_rank(), world=comm.get_world_size(), steps=steps,
        init=init, holds=holds, val=trainer.comm_info.get("val_result"),
        history=trainer.history,
        peak_gib=torch.cuda.max_memory_allocated(device) / 2**30 if cuda else 0.0),
        os.path.join(cfg.record_path, f"rank{comm.get_rank()}.pt"))


def plant_fault(trainer, fault):
    """Break ``trainer``'s gradient reduction (its ``_reduce``) on purpose:
    ``"double"`` doubles the summed gradients, ``"unreduced"`` leaves each
    process with its own (its share of the global loss's gradient). The
    metrics are still summed, so every process logs the global loss."""
    if fault not in DDP_FAULTS:
        raise ValueError(f"record_fault {fault!r}: one of {DDP_FAULTS}")
    reduce = trainer._reduce

    def faulty(metrics):
        params = [p for p in trainer.model.parameters() if p.requires_grad]
        own = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
               for p in params]
        out = reduce(metrics)
        with torch.no_grad():
            for p, g in zip(params, own):
                if fault == "double":
                    p.grad.mul_(2.0)
                else:
                    p.grad.copy_(g)
        return out

    trainer._reduce = faulty


def run_recorded(options, world, out, device="cuda", backend=None,
                 config=BASE_CONFIG):
    """A recorded run (:func:`record_worker`) of ``config`` with the
    KEY=VALUE ``options`` over ``world`` processes started by the port's
    launcher (in this process for one); returns every rank's record."""
    from ao_tpu_torch.engines import default_config_parser, launch
    from ao_tpu_torch.utils import DictAction

    os.makedirs(out, exist_ok=True)
    opts = {k: DictAction._parse_value(v) for k, v in
            (o.partition("=")[::2] for o in options)}
    cfg = default_config_parser(config, dict(opts, record_path=out))
    launch(record_worker, num_devices_per_machine=world, cfg=(cfg, device),
           device=device, backend=backend)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def compare_records(a, b):
    """Per step of two recorded runs (records of :func:`record_worker`) of
    one global batch: the loss's relative gap; for the parameters and for
    the running statistics the largest over tensors of
    |a - b| / max(|b - b_before|, 1e-2 * the step's largest change of any
    tensor) in Frobenius norm, b_before being the tensor before the step:
    the gap over the step's own change, floored for tensors that barely
    move (the Linear biases ahead of a BatchNorm, whose gradient is zero up
    to rounding); and ``params_all``, the parameters' gap over the step's
    change with every tensor together, sum |a - b| / sum |b - b_before|."""
    rows, prev = [], b["init"]
    for i, (sa, sb) in enumerate(zip(a["steps"], b["steps"])):
        def gaps(key):
            change = {n: float(torch.linalg.vector_norm(vb - prev[key][n]))
                      for n, vb in sb[key].items()}
            gap = {n: float(torch.linalg.vector_norm(sa[key][n] - vb))
                   for n, vb in sb[key].items()}
            floor = 1e-2 * max(change.values())
            worst = max(gap[n] / max(change[n], floor, 1e-30) for n in gap)
            return worst, sum(gap.values()) / max(sum(change.values()), 1e-30)

        params, params_all = gaps("params")
        rows.append(dict(step=i + 1, loss_a=sa["loss"], loss_b=sb["loss"],
                         loss_rel=abs(sa["loss"] - sb["loss"]) / abs(sb["loss"]),
                         params=params, params_all=params_all,
                         stats=gaps("stats")[0]))
        prev = sb
    return rows


def pointcontrast_phase(device, seed, t0, card="",
                        batches=(POINTCONTRAST_BATCH,)):
    """Phase 16: PointContrast. ScanNet-layout .sens scenes written here
    (:data:`PAIR_SCENES`, :data:`PAIR_FRAMES` frames each, 640 x 480 zlib
    depth and JPEG colour), the port's preprocessor over them, then 2
    steps of the PointContrast config at its full width (SpUNet,
    in_channels 3) through ao_tpu_torch.tools.train_pretrain at the first
    of ``batches`` (pairs a step) that fits: losses finite, pairs matched
    every step, parameters moved. Prints the pairs kept, the points a view,
    the step seconds and the peak memory."""
    from ao_tpu_torch.datasets import build_dataset
    from ao_tpu_torch.utils import Config

    work = tempfile.mkdtemp(prefix="ao_chip_pairs_")
    t = time.perf_counter()
    root, pre_s = pair_setup(work)
    cfg = Config.fromfile(POINTCONTRAST_CONFIG)
    kept = len(build_dataset(dict(cfg.data.train, data_root=root)).data_list)
    with open(os.path.join(root, "overlap30.txt")) as f:
        listed = sum(1 for _ in f)
    log(t0, f"pointcontrast: {len(PAIR_SCENES)} scenes x {PAIR_FRAMES} frames "
            f"written and preprocessed in {time.perf_counter() - t:.1f} s "
            f"(preprocessor {pre_s:.1f} s); {kept} pairs over the config's "
            f"overlap 0.3 ({listed} in overlap30.txt)")
    if kept < max(batches):
        raise RuntimeError(f"{kept} pairs, fewer than a batch of {max(batches)}")

    def train(batch):
        options = [f"save_path={os.path.join(work, f'exp{batch}')}",
                   f"data.train.data_root={root}", f"batch_size={batch}",
                   "max_steps=2", "num_worker=8", f"seed={seed}",
                   "enable_tensorboard=False"]
        trainer, launches = _drive(BN_KERNELS, lambda: run_train(
            device, options, POINTCONTRAST_CONFIG, "train_pretrain"))
        return trainer, torch.cuda.max_memory_allocated() / 2**30, launches

    batch, (trainer, peak_gb, launches) = fit_batch(
        batches, "pointcontrast train", card, train)
    hist = trainer.history
    for r in hist:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["nce_loss"])
                and r["pairs"] > 0):
            raise RuntimeError(f"pointcontrast step {r}")
    changed, n_params = check_train(trainer, 2)
    views = 2 * batch
    print(f"pointcontrast: B={batch} pairs a step, points a view "
          f"{[round(r['points'] / views) for r in hist]} (mean), matched pairs "
          f"{[int(r['pairs']) for r in hist]}; losses "
          f"{[round(r['loss'], 5) for r in hist]}; step seconds "
          f"{[round(r['step_seconds'], 4) for r in hist]}, data wait "
          f"{[round(r['data_seconds'], 4) for r in hist]}; peak memory "
          f"{peak_gb:.2f} GiB; {changed}/{n_params} parameter tensors changed;"
          f" launches {launches}; card {card}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    log(t0, "pointcontrast phase done")


# phase 17: four train rooms (the train phase's three and one more), two a
# process; the floors of the band within which a data-parallel run must
# agree with the single process at every step: the loss's relative gap,
# the parameters' gap over the step's change with every tensor together
# (compare_records' params_all) and the running statistics' worst tensor's.
# On an H100 in bf16 one process's spread between two runs is 0.10-0.16
# of a step in the parameters and 3e-5-5e-5 in the loss, while a doubled
# or an unreduced gradient puts them at 0.79-1.05 and above 1e-3
DDP_ROOMS = TRAIN_ROOMS + ((4, (6.2, 5.2, 3.0)),)
DDP_STEPS = 3
DDP_FLOOR = dict(loss_rel=2e-4, params_all=0.25, stats=2e-2)
# the widest parameter band a case may take at its first step, whose
# update is the (reduced) gradient itself: there a doubled gradient shows
# as 1.0 of a step and an unreduced one as 0.79-1.0, so a wider band could
# not tell a fault from the runs' own spread
DDP_CEILING = 0.5
# the faults --ddp-faults plants in a two-process run's gradient reduction
DDP_FAULTS = ("double", "unreduced")


def ddp_hold(label, ranks, one, band):
    """Every rank's record of a data-parallel run against the single
    process's, step by step, printed beside the band; returns the (rank,
    step, key) of every gap outside it."""
    out = []
    for rec in ranks:
        for row, lim in zip(compare_records(rec, one), band):
            print(f"ddp {label}: rank {rec['rank']} step {row['step']} loss "
                  f"{row['loss_a']:.6f} vs {row['loss_b']:.6f} (rel "
                  f"{row['loss_rel']:.3g}), params {row['params_all']:.3g} "
                  f"(worst tensor {row['params']:.3g}), stats "
                  f"{row['stats']:.3g}; band loss_rel {lim['loss_rel']:.3g}, "
                  f"params {lim['params_all']:.3g}, stats {lim['stats']:.3g}",
                  flush=True)
            out += [(rec["rank"], row["step"], k) for k in DDP_FLOOR
                    if row[k] > lim[k]]
    return out


def ddp_summary(label, ranks, one):
    """Prints a data-parallel run's step seconds against the single
    process's, its collectives a step and their seconds in its timed step
    (each synchronised), its peak memory and losses."""
    timed = [s for s in ranks[0]["steps"] if s["timed"]][0]
    print(f"ddp {label}: {len(ranks)} processes, (B, N) "
          f"{ranks[0]['steps'][0]['shape']} each: step seconds "
          f"{[[round(s['seconds'], 4) for s in r['steps']] for r in ranks]} "
          f"against one process at {one['steps'][0]['shape']} "
          f"{[round(s['seconds'], 4) for s in one['steps']]}; collectives a "
          f"step {[s['collectives'] for s in ranks[0]['steps']]}, "
          f"{timed['collective_seconds']:.4f} s of the timed step's "
          f"{timed['seconds']:.4f} s (share "
          f"{timed['collective_seconds'] / timed['seconds']:.3f}); peak memory "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB a process, "
          f"{one['peak_gib']:.2f} GiB one; losses "
          f"{[round(s['loss'], 6) for s in ranks[0]['steps']]} against "
          f"{[round(s['loss'], 6) for s in one['steps']]}", flush=True)


def launch_failures(label, ranks, one, kernels=TRAIN_KERNELS):
    """The steps of a data-parallel run whose launches of ``kernels``
    differ from the single process's, or lack a kernel."""
    bad = []
    for rec in ranks:
        for i, (s, s1) in enumerate(zip(rec["steps"], one["steps"])):
            got = {n: s["launches"][n] for n in kernels}
            want = {n: s1["launches"][n] for n in kernels}
            if got != want or not all(got.values()):
                bad.append(f"{label} rank {rec['rank']} step {i + 1} "
                           f"launches {got} vs {want}")
    return bad


def single_spread(label, recorded, card):
    """One process twice through ``recorded(name, world, backend)``: its
    record and the per-step spread (:func:`compare_records`) between the
    two, printed with the step-1 gradient norms and the grid pools'
    overflow."""
    one = recorded("one", 1, None)[0]
    again = recorded("one_again", 1, None)[0]
    spread = compare_records(again, one)
    print(f"ddp {label}: (B, N) {one['steps'][0]['shape']}; single-process "
          f"spread {spread}; gradient norms "
          f"{[round(s['grad_norm'], 4) for s in one['steps']]} and "
          f"{[round(s['grad_norm'], 4) for s in again['steps']]}; pool overflow "
          f"{[s['overflow'] for s in one['steps']]}; step seconds "
          f"{[round(s['seconds'], 4) for s in one['steps']]} and "
          f"{[round(s['seconds'], 4) for s in again['steps']]}; card {card}",
          flush=True)
    return one, spread


def ddp_case(label, config, base, work, runs, faults, t0, card,
             kernels=TRAIN_KERNELS, repeat=True):
    """One case of phase 17: ``config`` with the KEY=VALUE ``base``
    options. One process twice (:func:`single_spread`) sets the band
    max(3 x spread, :data:`DDP_FLOOR`) per step, whose parameter gap at
    step 1 may not pass :data:`DDP_CEILING`; without ``repeat`` (a case
    whose single process repeats itself bit for bit) one process once and
    the band :data:`DDP_FLOOR`. Then each of ``runs``
    ((name, world, backend, *options)) held in that band at every step
    (loss, parameters, running statistics) with ``kernels`` launched per
    step by every process as by the single one; and for each fault of
    ``faults`` (:data:`DDP_FAULTS`), two gloo processes with the fault
    planted in their gradient reduction, which must fall outside the band
    in the loss or the parameters. Returns (failures, process 0's held
    kernel rows, launches by path, the single process's record)."""

    def recorded(name, world, backend, *extra):
        torch.cuda.empty_cache()
        out = os.path.join(work, f"{label}_{name}")
        ranks = run_recorded(base + [f"save_path={out}", *extra], world, out,
                             device="cuda", backend=backend, config=config)
        log(t0, f"ddp {label} {name}: {world} process(es) done")
        return ranks

    if repeat:
        one, spread = single_spread(label, recorded, card)
        band = [{k: max(3 * row[k], DDP_FLOOR[k]) for k in DDP_FLOOR}
                for row in spread]
    else:
        one = recorded("one", 1, None)[0]
        band = [dict(DDP_FLOOR) for _ in one["steps"]]
        print(f"ddp {label}: (B, N) {one['steps'][0]['shape']}; band "
              f"{DDP_FLOOR} (no repeat); gradient norms "
              f"{[round(s['grad_norm'], 4) for s in one['steps']]}; pool "
              f"overflow {[s['overflow'] for s in one['steps']]}; step seconds "
              f"{[round(s['seconds'], 4) for s in one['steps']]}; card {card}",
              flush=True)
    failures = [f"{label}: the spread sets a parameter band of "
                f"{band[0]['params_all']:.3g} at step 1, above {DDP_CEILING}"
                ] if band[0]["params_all"] > DDP_CEILING else []
    holds, launches = [], {}
    for name, world, backend, *extra in runs:
        ranks = recorded(name, world, backend, *extra)
        failures += [f"{label} {name} rank {r} step {i} {k}" for r, i, k in
                     ddp_hold(f"{label} {name}", ranks, one, band)]
        failures += launch_failures(f"{label} {name}", ranks, one, kernels)
        ddp_summary(f"{label} {name}, card {card}", ranks, one)
        holds += ranks[0]["holds"]
        launches.update({f"ddp_{label}_{name}_rank{r['rank']}": {
            n: sum(s["launches"][n] for s in r["steps"]) for n in KERNEL_INFO}
            for r in ranks})
    for fault in faults:
        ranks = recorded(f"fault_{fault}", 2, "gloo", f"record_fault={fault}")
        caught = ddp_hold(f"{label} fault {fault}", ranks, one, band)
        print(f"ddp {label}: fault {fault!r} planted in the gradient "
              f"reduction: outside the band at (rank, step, key) {caught}",
              flush=True)
        if not {"loss_rel", "params_all"} & {k for _, _, k in caught}:
            failures.append(f"{label}: the band misses the fault {fault!r}")
    return failures, holds, launches, one


# phase 17's Lovasz case: configs/scannet/semseg-pt-v2m2-3-lovasz.py (its
# Lovasz term over the global batch), 2 steps, at a global batch of 2
# ScanNet rooms (of 4 where 4 processes run), in the config's f32 with
# PyTorch's deterministic algorithms (LOVASZ_HELD) and its first grid
# pool at 0.4 of the points. In bf16 this path turns any difference in
# the order of a sum (atomics, or the batch split over processes) into
# 0.45-0.55 of a step at step 1, as wide as a planted fault; in f32 with
# deterministic algorithms one process repeats itself bit for bit and two
# processes stay within 0.004 (--lovasz-spread), so phase 17 runs its
# single process once and holds it in DDP_FLOOR. In f32 the attention is
# unfused (K3-K6 are bf16 kernels), so the case launches K1 and K2
# (UNPOOL_KERNELS); the S3DIS case holds K3-K6. A pool's capacity follows
# each process's padded N, and the synthetic rooms (sparser than
# ScanNet's 0.02 m grid) overflow the config's 0.35 by 2812 clusters,
# which would merge otherwise in one process than in two
LOVASZ_CONFIG = os.path.join(ROOT, "configs", "scannet",
                             "semseg-pt-v2m2-3-lovasz.py")
LOVASZ_STEPS = 2
LOVASZ_CAPACITY = "model.backbone.stage_cap_ratios=(0.4, 0.35, 0.35, 0.35)"
LOVASZ_CE_ONLY = ("model.criteria=[{'type': 'CrossEntropyLoss', "
                  "'loss_weight': 1.0, 'ignore_index': -1}]")
LOVASZ_F32 = "model.backbone.compute_dtype=float32"
LOVASZ_DETERMINISTIC = "record_deterministic=True"
LOVASZ_HELD = (LOVASZ_CAPACITY, LOVASZ_F32, LOVASZ_DETERMINISTIC)


def lovasz_setup(work, batch, seed, t0):
    """The Lovasz case's ``batch`` ScanNet rooms written under ``work`` and
    its options (bf16, SGD, no stochastic depth, no Mix3D, one loop), at
    the config's own capacities."""
    rooms = [make_scannet_room(s_, size) for s_, size in SCANNET_ROOMS[:batch]]
    _, base = scannet_setup(rooms, workdir=os.path.join(work, "lovasz"),
                            batch_size=batch, max_steps=LOVASZ_STEPS, workers=0,
                            seed=seed)
    log(t0, f"ddp lovasz rooms: {[len(r['coord']) for r in rooms]} points")
    return base + list(SCANNET_BF16) + [
        "model.backbone.drop_path_rate=0.0", "mix_prob=0.0", "data.train.loop=1",
        f"epoch={LOVASZ_STEPS}", f"eval_epoch={LOVASZ_STEPS}", "record_timed=1",
        "optimizer={'type': 'SGD', 'lr': 0.006, 'momentum': 0.9, "
        "'weight_decay': 0.0001}"]


# the settings --lovasz-spread compares (options over lovasz_setup's):
# the config as written (CE + Lovasz, bf16, first pool at 0.35), CE
# alone, the first pool at 0.4 (no overflow), both, f32, PyTorch's
# deterministic algorithms, f32 with them
LOVASZ_SPREADS = {
    "config": (), "ce_only": (LOVASZ_CE_ONLY,), "capacity": (LOVASZ_CAPACITY,),
    "ce_only_capacity": (LOVASZ_CE_ONLY, LOVASZ_CAPACITY),
    "f32_capacity": (LOVASZ_CAPACITY, LOVASZ_F32),
    "deterministic_capacity": (LOVASZ_CAPACITY, LOVASZ_DETERMINISTIC),
    "f32_deterministic_capacity": LOVASZ_HELD}


def lovasz_spread(seed, t0, card, names=tuple(LOVASZ_SPREADS)):
    """The Lovasz case's single-process spread (:func:`single_spread`) at
    B=2 under each setting of ``names`` (:data:`LOVASZ_SPREADS`), to tell
    the loss's, the overflowing pool's, bf16's and PyTorch's atomics'
    shares of it, and two gloo processes at B=1 each against the single
    process under the same setting, printed beside the band max(3 x
    spread, :data:`DDP_FLOOR`)."""
    work = tempfile.mkdtemp(prefix="ao_chip_spread_")
    base = lovasz_setup(work, 2, seed, t0)
    for name in names:
        def recorded(run, world, backend):
            torch.cuda.empty_cache()
            out = os.path.join(work, f"{name}_{run}")
            ranks = run_recorded(base + list(LOVASZ_SPREADS[name]) + [
                f"save_path={out}"], world, out, device="cuda",
                backend=backend, config=LOVASZ_CONFIG)
            log(t0, f"lovasz spread {name} {run} done")
            return ranks

        one, spread = single_spread(f"lovasz spread, {name}", recorded, card)
        band = [{k: max(3 * row[k], DDP_FLOOR[k]) for k in DDP_FLOOR}
                for row in spread]
        ddp_hold(f"lovasz spread, {name}, gloo", recorded("gloo", 2, "gloo"),
                 one, band)


def ddp_phase(device, seed, t0, card="", gloo=True, faults=(), nccl=(),
              group_of_one=True, lovasz=True):
    """Phase 17: data parallelism. The main path's config (full width,
    bf16) on :data:`DDP_ROOMS` at a global B=4 x 81920, one step an epoch,
    for :data:`DDP_STEPS` steps, with SGD in place of AdamW (whose first
    updates are the gradients' signs, so that a gradient zero up to
    rounding flips sign between any two runs), no stochastic depth, and
    each scene's augmentation seeded by its index (:class:`SeededItems`),
    held by :func:`ddp_case` (one process twice for the band; K6 sums with
    atomics): with ``gloo``, two processes over gloo on one card at B=2
    each through the port's launcher, process 0 holding K1-K6 of its first
    step against their plain versions at its own shapes; for each world of
    ``nccl``, that many processes over NCCL, one card each; each fault of
    ``faults``. With ``lovasz``, the same runs and faults of the ScanNet
    Lovasz config (:func:`lovasz_setup`, under :data:`LOVASZ_HELD`). With
    ``group_of_one``, one process in an NCCL group of one through the
    launcher's worker, 2 steps. Prints the collectives a step and their
    share of a timed step. Returns (the kernel rows held, the launches by
    path)."""
    from ao_tpu_torch.engines import default_config_parser
    from ao_tpu_torch.engines.launch import distributed_worker, free_port
    from ao_tpu_torch.utils import DictAction

    work = tempfile.mkdtemp(prefix="ao_chip_ddp_")
    rooms = [make_room(s, size) for s, size in DDP_ROOMS]
    # no loader workers: one step an epoch would start them anew each step
    _, base = train_setup(rooms, work, batch_size=4, max_steps=DDP_STEPS,
                          workers=0, seed=seed)
    base += ["model.backbone.drop_path_rate=0.0", f"epoch={DDP_STEPS}",
             f"eval_epoch={DDP_STEPS}", "record_timed=2",
             "optimizer={'type': 'SGD', 'lr': 0.006, 'momentum': 0.9, "
             "'weight_decay': 0.0001}"]
    log(t0, f"ddp rooms: {[len(r['coord']) for r in rooms]} points")
    runs = ([("gloo", 2, "gloo", "record_hold=True")] if gloo else []) + [
        (f"nccl{w}", w, "nccl") for w in nccl]
    failures, holds, launches, one = ddp_case("s3dis", BASE_CONFIG, base, work,
                                              runs, faults, t0, card)
    if lovasz:
        batch = 4 if any(w > 2 for _, w, *_ in runs) else 2
        # one process in f32 at B=4 x 102400 would need about 86 GiB
        lv_base = lovasz_setup(work, batch, seed, t0) + list(LOVASZ_HELD) + (
            ["model.backbone.enable_checkpoint=True"] if batch > 2 else [])
        lv_failures, _, lv_launches, _ = ddp_case(
            "lovasz", LOVASZ_CONFIG, lv_base, work,
            [(name, world, backend) for name, world, backend, *_ in runs],
            faults, t0, card, kernels=GRAPH_BN_KERNELS, repeat=False)
        failures += lv_failures
        launches.update(lv_launches)
    if failures:
        raise RuntimeError(f"data-parallel runs disagree with one process: "
                           f"{failures}")
    log(t0, "ddp runs held")
    if not group_of_one:
        return holds, launches

    # the NCCL path on one card: one process, a group of one
    opts = {k: DictAction._parse_value(v) for k, v in
            (o.partition("=")[::2] for o in base + [
                f"save_path={os.path.join(work, 'nccl')}", "max_steps=2",
                "record_timed=1"])}
    out = os.path.join(work, "nccl")
    os.makedirs(out, exist_ok=True)
    cfg = default_config_parser(BASE_CONFIG, dict(opts, record_path=out))
    env = {k: os.environ.get(k) for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE")}
    torch.cuda.empty_cache()
    try:
        distributed_worker(0, record_worker, 1, 1, 0,
                           f"tcp://127.0.0.1:{free_port()}", (cfg, "cuda"),
                           "cuda", "nccl")
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    nccl1 = torch.load(os.path.join(out, "rank0.pt"), weights_only=False)
    steps = nccl1["steps"]
    if len(steps) != 2 or not all(np.isfinite(s["loss"]) and s["collectives"] > 0
                                  for s in steps):
        raise RuntimeError(f"the NCCL process's steps: {steps}")
    print(f"ddp: nccl, a group of one: losses {[round(s['loss'], 5) for s in steps]}"
          f" (one process: {[round(s['loss'], 5) for s in one['steps'][:2]]}); "
          f"step seconds {[round(s['seconds'], 4) for s in steps]}; collectives "
          f"a step {[s['collectives'] for s in steps]}, "
          f"{steps[1]['collective_seconds']:.4f} s of the timed step 2's "
          f"{steps[1]['seconds']:.4f} s; card {card}", flush=True)
    log(t0, "ddp phase done")
    launches["ddp_nccl"] = {n: sum(s["launches"][n] for s in steps)
                            for n in KERNEL_INFO}
    return holds, launches


# ---------------------------------------------------------------------------
# phase 18: the raw-data preprocessor, ConcatDataset, the cache and
# profiler hooks, and the AO_* kernel-path switches on the main path

# the four rooms of phase 17, as raw S3DIS rooms of two areas
LEFTOVER_AREAS = (1, 1, 2, 2)
# (switch, value, counted steps, the path's kernels, kernels-line tag):
# the gathered path (K1's 3 probes at (256, 1152) merged by K2 (3, 16),
# K3-K6 on gathered rows), the wider slab graph, the exact kNN (gathered
# K3-K6), the unfused attention (K1 / K2 only); at least 2 steps, as the
# first sets up the allocator and the loader
SWITCHES = (
    ("AO_GVA_SLAB", "0", 3, TRAIN_KERNELS, "gathered"),
    ("AO_SLAB_W", "512", 2, TRAIN_KERNELS, "slab512"),
    ("AO_EXACT_KNN", "1", 2, TRAIN_KERNELS, "exact"),
    ("AO_GVA_FUSED", "0", 2, GRAPH_BN_KERNELS, "unfused"),
)
# the switches under which no stage takes the slab path: their GVA calls
# read gathered rows at every N
SLAB_OFF = (("AO_GVA_SLAB", "0"), ("AO_EXACT_KNN", "1"))
# the unfused attention's batches, tried in turn (PT-v2m1, unfused, fits
# B=3 only with checkpointing)
UNFUSED_BATCHES = (3, 2, 1)


@contextlib.contextmanager
def env_set(name, value):
    """The environment variable ``name`` set to ``value`` inside, restored
    (or removed) after."""
    before = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = before


class _Shim:
    """The parts of a trainer a hook's ``before_train`` reads."""

    def __init__(self, dataset):
        from ao_tpu_torch.utils.logger import get_root_logger

        self.train_loader = type("Loader", (), {"dataset": dataset})()
        self.logger = get_root_logger()


def check_data_cache(root, work, card):
    """DataCacheOperator over a plain S3DISDataset of the preprocessed
    rooms, its cache under an AO_SHM_CACHE in ``work``: every scene cached,
    every cached array equal to the scene as loaded; clear_cache at the
    end empties it."""
    from ao_tpu_torch.datasets import build_dataset, load_scene
    from ao_tpu_torch.engines.hooks.misc import DataCacheOperator
    from ao_tpu_torch.utils import cache

    with env_set("AO_SHM_CACHE", os.path.join(work, "shm_cache")):
        t = time.perf_counter()
        ds = build_dataset(dict(type="S3DISDataset", split=("Area_1", "Area_2"),
                                data_root=root, transform=[], cache=True))
        hook = DataCacheOperator(data_root=root)
        hook.trainer = _Shim(ds)
        hook.before_train()
        fill_s = time.perf_counter() - t
        if hook.cached != ds.data_list or not ds.data_list:
            raise RuntimeError(f"cached {hook.cached} of {ds.data_list}")
        nbytes = 0
        for path in ds.data_list:
            entry, scene = cache.shared_dict("ao-" + path), load_scene(path)
            if sorted(entry) != sorted(scene) or not all(
                    np.array_equal(entry[k], scene[k]) for k in scene):
                raise RuntimeError(f"the cache of {path} differs from the scene")
            nbytes += sum(v.nbytes for v in entry.values())
        cache.clear_cache()
        if os.path.exists(cache.cache_root()):
            raise RuntimeError("clear_cache left the cache in place")
    print(f"leftovers: DataCacheOperator cached {len(ds.data_list)} scenes "
          f"({nbytes / 2**20:.1f} MiB) in {fill_s:.2f} s, each array equal to "
          f"the scene loaded; clear_cache emptied it; card {card}", flush=True)


def switch_run(name, value, steps, kernels, batch, options, device, t0, card):
    """``steps`` train steps of the main path's config with the kernel-path
    switch ``name`` set to ``value`` (and restored after), every kernel
    call captured and held against its plain version, each of ``kernels``
    launched. Returns (rows, launches, launches a step, step seconds, peak
    GiB)."""
    label = f"{name}={value} B={batch}"

    def train():  # the run's peak, before the holds
        trainer = run_train(device, options + [f"batch_size={batch}",
                                               f"max_steps={steps}"])
        return trainer, torch.cuda.max_memory_allocated() / 2**30

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with env_set(name, value), StepLaunches() as counted:
        ((trainer, peak), launches), rows = held(
            kernels, label, lambda: _drive(kernels, train),
            gathered=(name, value) in SLAB_OFF)
    hist = trainer.history
    if len(hist) != steps or not all(np.isfinite(r["loss"]) for r in hist):
        raise RuntimeError(f"{label}: steps {hist}")
    if any(launches[n] != counted.total[n] for n in KERNEL_INFO):
        raise RuntimeError(f"{label}: launches {launches} besides the train "
                           f"steps' {counted.total}")
    seconds = [round(r["step_seconds"], 4) for r in hist]
    per_step = {n: round(v, 2) for n, v in counted.per_step().items() if v}
    print(f"leftovers {label}: (B, N) points a step "
          f"{[r['points'] for r in hist]}, losses "
          f"{[round(r['loss'], 5) for r in hist]}, step seconds {seconds}, "
          f"peak memory {peak:.2f} GiB; launches a step {per_step}; card "
          f"{card}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    log(t0, f"leftovers {label} done")
    return rows, launches, per_step, seconds, peak


def leftovers_phase(device, seed, t0, card=""):
    """Phase 18. The four rooms of phase 17, written as raw S3DIS rooms of
    two areas (:func:`write_raw_s3dis`), through the port's
    ``preprocess_s3dis`` (spawned workers); the main path's config (B=3 x
    81920, bf16) trained 3 steps on the preprocessed rooms through a
    ConcatDataset of the two areas, with RuntimeProfilerV2 in its hooks
    (wait 1, warmup 1, active 1: the third step traced), whose trace file
    must exist and hold the step's CUDA kernels; DataCacheOperator on a
    plain S3DIS dataset (:func:`check_data_cache`); then the steps of each
    of :data:`SWITCHES` (the unfused attention at the first of
    :data:`UNFUSED_BATCHES` that fits), every kernel call captured and held
    against its plain version. Prints each switch's step seconds, peak
    memory and the batch that fit. Returns (rows by kernels-line tag,
    launches by tag)."""
    from ao_tpu_torch.datasets.preprocessing import preprocess_s3dis
    from ao_tpu_torch.utils import Config

    work = tempfile.mkdtemp(prefix="ao_chip_leftovers_")
    t = time.perf_counter()
    rooms = {(area, f"office_{i}"): make_room(s_, size) for i, (area, (s_, size))
             in enumerate(zip(LEFTOVER_AREAS, DDP_ROOMS))}
    raw, root = os.path.join(work, "raw"), os.path.join(work, "s3dis")
    write_raw_s3dis(raw, rooms)
    written = time.perf_counter() - t
    preprocess_s3dis.main(["--dataset-root", raw, "--output-root", root,
                           "--num-workers", str(len(rooms))])
    pre_s = time.perf_counter() - t - written
    for (area, name), room in rooms.items():
        with np.load(os.path.join(root, f"Area_{area}", f"{name}.npz")) as z:
            if not (len(z["coord"]) == len(room["coord"]) and np.array_equal(
                    np.unique(z["semantic_gt"]), np.unique(room["semantic_gt"]))):
                raise RuntimeError(f"the preprocessed {area}/{name} differs")
    log(t0, f"leftovers: {len(rooms)} raw rooms "
            f"({[len(r['coord']) for r in rooms.values()]} points) written in "
            f"{written:.1f} s, preprocessed in {pre_s:.1f} s")

    cfg = Config.fromfile(BASE_CONFIG)
    transform = [dict(t_) for t_ in cfg.data.train.transform]
    concat = dict(_delete_=True, type="ConcatDataset", datasets=[
        dict(type="S3DISDataset", split=f"Area_{a}", data_root=root,
             transform=transform) for a in (1, 2)])
    hooks = [dict(h) for h in cfg.hooks] + [dict(
        type="RuntimeProfilerV2", wait=1, warmup=1, active=1, repeat=1)]
    save = os.path.join(work, "concat")
    options = [f"save_path={save}", "batch_size=3", "max_steps=3",
               "num_worker=4", f"seed={seed}", "evaluate=False",
               "enable_tensorboard=False", f"data.train={concat!r}",
               f"hooks={hooks!r}"]
    torch.cuda.reset_peak_memory_stats()
    trainer, launches = _drive(TRAIN_KERNELS, lambda: run_train(device, options))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_train(trainer, 3)
    ds = trainer.train_loader.dataset
    trace = os.path.join(save, "profile_v2", "trace_1.json")
    if type(ds).__name__ != "ConcatDataset" or len(ds.datasets) != 2:
        raise RuntimeError(f"the train set is {type(ds).__name__}")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    if not kernels:
        raise RuntimeError(f"{trace} holds no CUDA kernel")
    hist = trainer.history
    print(f"leftovers: ConcatDataset of Area_1 / Area_2 "
          f"({[len(d.data_list) for d in ds.datasets]} rooms), "
          f"losses {[round(r['loss'], 5) for r in hist]}, step seconds "
          f"{[round(r['step_seconds'], 4) for r in hist]}, peak memory "
          f"{peak:.2f} GiB; RuntimeProfilerV2 trace {os.path.getsize(trace)} "
          f"bytes, {kernels} CUDA kernels; launches {launches}; card {card}",
          flush=True)
    del trainer
    torch.cuda.empty_cache()
    log(t0, "leftovers: concat train done")
    check_data_cache(root, work, card)

    plain = [f"save_path={os.path.join(work, 'switch')}", "num_worker=4",
             f"seed={seed}", "evaluate=False", "enable_tensorboard=False",
             f"data.train.data_root={root}",
             "data.train.split=('Area_1', 'Area_2')"]
    rows, launches_by_tag = {}, {}
    for name, value, steps, kernels, tag in SWITCHES:
        batches = UNFUSED_BATCHES if tag == "unfused" else (3,)
        batch, (rows[tag], got, per_step, seconds, peak) = fit_batch(
            batches, f"leftovers {name}={value}", card,
            lambda b: switch_run(name, value, steps, kernels, b, plain, device,
                                 t0, card))
        print(f"leftovers {name}={value}: B={batch} x 81920 fits (of "
              f"{batches}); step seconds {seconds}, peak memory {peak:.2f} "
              f"GiB; card {card}", flush=True)
        launches_by_tag[tag] = {f"{tag}_train": got}
    log(t0, "leftovers phase done")
    return rows, launches_by_tag


def ao_phase(device, seed, t0, rooms, val_room, train_per_step, card=""):
    """PP2S over the train rooms (oracle mode, 512^2 frames, 6 + 2 views),
    a REAL run of 3 steps at B=3 x 81920 through the port's
    entry point (its cut epoch ends with the evaluation and one refinement
    round), driven with the launch counts set to 0 just before it and read
    just after, then the neural SAM at ViT-H width. Returns (the REAL run's
    launches, its launches per train step)."""
    workdir, options, seconds, labels = real_setup(
        rooms, val_room, max_steps=3, seed=seed, device=device)
    print(f"pp2s: {len(rooms)} rooms, stage seconds "
          f"{ {k: round(v, 3) for k, v in seconds.items()} }; labels mIoU "
          f"{labels['mIoU']:.4f} mPre {labels['mPrecision']:.4f} mRec "
          f"{labels['mRecall']:.4f}", flush=True)
    log(t0, "PP2S done")

    torch.cuda.reset_peak_memory_stats()
    with StepLaunches() as steps:
        (trainer, record), launches = _drive(
            TRAIN_KERNELS, lambda: run_real(device, options))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    r = check_real(trainer, record, os.path.join(workdir, "sam_labels"))
    hist = trainer.history
    step_s = [r_["step_seconds"] for r_ in hist]
    basket_s = [r_["basket_seconds"] for r_ in hist]
    print(f"real: (B, N) {sorted(set(record['shapes']))} "
          f"points/step {[r_['points'] for r_ in hist]}; losses "
          f"{[round(r_['loss'], 5) for r_ in hist]}", flush=True)
    print(f"real: step seconds {[round(x, 4) for x in step_s]}, of which "
          f"basket fill {[round(x, 4) for x in basket_s]} (median of steps "
          f"2-{len(hist)}: {np.median(step_s[1:]):.4f} s with, "
          f"{np.median(np.subtract(step_s, basket_s)[1:]):.4f} s without); "
          f"peak memory {peak_gb:.2f} GiB", flush=True)
    print(f"real: refinement {r['seconds']:.2f} s: prompts {r['prompts']}, "
          f"masks {r['masks']}, updated {r['num_updated']} points in "
          f"{r['labels_rewritten']} label files, prompt accuracy "
          f"{r['prompt_accuracy']:.4f}; label mIoU {labels['mIoU']:.4f} -> "
          f"{r['mIoU']:.4f} mPre {labels['mPrecision']:.4f} -> "
          f"{r['mPre']:.4f} (random weights)", flush=True)
    per_step = steps.per_step()
    print(f"real: launches {launches} ({len(hist)} steps); per train step "
          f"{per_step} (train phase {train_per_step}); card {card}",
          flush=True)
    if per_step != train_per_step:
        raise RuntimeError("a REAL step launched the kernels otherwise than "
                           "a train step")
    basket = record["baskets"][0]
    del trainer, record
    torch.cuda.empty_cache()
    log(t0, "REAL phase done")

    sam = run_sam(workdir, basket, device)
    print(f"sam: {sam['model']} ({sam['params']} parameters, built on the "
          f"card in {sam['build_s']:.2f} s): set_image ms per frame "
          f"{[round(x, 2) for x in sam['set_image_ms']]}; refinement of "
          f"{sam['scene']} in {sam['refine_s']:.2f} s: (F, P) "
          f"{sam['shapes_FP']}, decoder ms {[round(x, 2) for x in sam['decode_ms']]}"
          f", predict_batch ms {[round(x, 2) for x in sam['predict_batch_ms']]};"
          f" prompts {sam['prompts']}, masks {sam['masks']}, updated "
          f"{sam['updated']}; peak memory {sam['peak_gib']:.2f} GiB; card "
          f"{card}", flush=True)
    torch.cuda.empty_cache()
    log(t0, "SAM phase done")
    return launches, per_step


def run(device, seed, t0, room_size=(4.8, 4.0, 2.6), train_steps=5, card="",
        **setup_kw):
    """The test slice (kernel phase, slice phase, forward profile), then the
    train slice (train kernel phase, train phase, train-step profile); each
    main path is driven with the launch counts set to 0 just before it and
    read just after. Returns the kernels' record."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.utils import Config

    cfg = Config.fromfile(BASE_CONFIG)
    torch.manual_seed(seed)
    model = build_model(dict(cfg.model)).to(device).eval()
    room = make_room(seed, room_size)
    setup = slice_setup(room, **setup_kw)
    log(t0, f"synthetic room: {len(room['coord'])} points")
    main_batch = main_path_batch(setup[1])
    small = small_batch(room)
    rows = kernel_phase(model, [main_batch, small], t0, device)
    log(t0, "kernel phase done")

    (result, votes, n_views), slice_launches = _drive(
        SLICE_KERNELS, lambda: run_slice(device, seed, model=model, setup=setup))
    check_votes(votes, n_views)
    scene = result["scenes"][0]
    caps = sorted({tuple(model.backbone.stage_capacities(n))
                   for _, n in scene["batches"]})
    print(f"slice: {scene['fragments']} fragments in batches (B, N) "
          f"{scene['batches']}; stage capacities {caps}", flush=True)
    print(f"slice: launches {slice_launches}; scene {scene['seconds']:.2f} s; "
          f"mIoU {result['mIoU']:.4f} allAcc {result['allAcc']:.4f} "
          f"(random weights)", flush=True)
    log(t0, "slice phase done")
    print(json.dumps({"forward_profile": dict(
        profile_forward(model, main_batch, device), card=card)}), flush=True)
    del model
    torch.cuda.empty_cache()
    log(t0, "forward profile done")

    rooms = [make_room(s, size) for s, size in TRAIN_ROOMS]
    workdir, options = train_setup(rooms, max_steps=train_steps, seed=seed,
                                   val_room=room)
    log(t0, f"train rooms: {[len(r['coord']) for r in rooms]} points")
    trainer = build_trainer(
        options + [f"save_path={os.path.join(workdir, 'exp_kernels')}"], device)
    it = iter(trainer.train_loader)
    train_batch = next(it)
    del it
    _, coord, feat, mask = small
    small_train = dict(coord=coord, feat=feat, mask=mask,
                       segment=torch.where(mask, 0, -1).to(torch.int32))
    train_rows, bn_calls = train_kernel_phase(
        trainer, [("train phase's batch", train_batch),
                  ("small batch", small_train)], t0)
    rows += train_rows
    del trainer
    torch.cuda.empty_cache()
    point_bn_cases(device, seed, t0)
    log(t0, "train kernel phase done")

    torch.cuda.reset_peak_memory_stats()
    with StepLaunches() as train_steps_count:
        trainer, train_launches = _drive(TRAIN_KERNELS,
                                         lambda: run_train(device, options))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    bn_step = train_steps_count.per_step()["point_bn"]
    if bn_step != 5 * bn_calls:
        raise RuntimeError(f"point_bn: {bn_step} launches a train step, not 5 x "
                           f"{bn_calls} PointBatchNorm calls")
    print(f"train: point_bn {bn_step:.0f} launches a train step (5 x "
          f"{bn_calls} PointBatchNorm calls)", flush=True)
    changed, n_params = check_train(trainer, train_steps)
    val = check_val(trainer)
    print(f"train: val (random weights, {train_steps} steps) mIoU "
          f"{val['mIoU']:.4f} mAcc {val['mAcc']:.4f} allAcc {val['allAcc']:.4f}"
          f" loss {val['loss']:.4f}; evaluation {val['seconds']:.2f} s; "
          f"model_last.pt and model_best.pt written", flush=True)
    hist = trainer.history
    step_s = float(np.median([r["step_seconds"] for r in hist[1:]]))
    print(f"train: (B, N) {tuple(train_batch['mask'].shape)} points/step "
          f"{[r['points'] for r in hist]}", flush=True)
    print(f"train: losses {[round(r['loss'], 5) for r in hist]} grad_norms "
          f"{[round(r['grad_norm'], 4) for r in hist]} pool_overflow "
          f"{[r['pool_overflow'] for r in hist]}", flush=True)
    print(f"train: step seconds {[round(r['step_seconds'], 4) for r in hist]}"
          f" (median of steps 2-{train_steps}: {step_s:.4f} s), data wait "
          f"{[round(r['data_seconds'], 4) for r in hist]}; peak memory "
          f"{peak_gb:.2f} GiB; {changed}/{n_params} parameter tensors changed;"
          f" launches {train_launches} ({train_steps} steps); card {card}",
          flush=True)
    log(t0, "train phase done")
    print(json.dumps({"train_step_profile": dict(
        profile_train_step(trainer, train_batch), card=card)}), flush=True)
    del trainer
    torch.cuda.empty_cache()
    log(t0, "train-step profile done")

    real_launches, real_per_step = ao_phase(device, seed, t0, rooms, room,
                                            train_steps_count.per_step(), card)

    sc_dir = tempfile.mkdtemp(prefix="ao_chip_scannet_")
    (sc_rows, sc_launches, sc_inst, sc_per_step,
     sc_inst_per_step) = scannet_phase(device, seed, t0, card, workdir=sc_dir)
    kitti_dir = tempfile.mkdtemp(prefix="ao_chip_outdoor_")
    out_rows, out_launches, _ = outdoor_phase(device, seed, t0, card,
                                              workdir=kitti_dir)
    m1_rows, m1_launches, _ = ptv2m1_phase(device, seed, t0, rooms, card)
    steps = FULL_RUN_STEPS
    sp_rows, sp_launches, _ = sparse_phase(device, seed, t0, card, sc_dir,
                                           kitti_dir, workdir, steps=steps)
    hd_rows, hd_launches, _ = heads_phase(device, seed, t0, card, sc_dir, rooms,
                                          steps=steps,
                                          msc_batches=(MSC_FULL_BATCH,),
                                          msc_steps=MSC_FULL_STEPS)
    v1_rows, v1_launches, _ = ptv1_phase(device, seed, t0, card, rooms, room,
                                         steps=steps,
                                         test_views=FULL_RUN_TEST_VIEWS,
                                         batches=(PTV1_FULL_BATCH,))
    sw_rows, sw_launches, _ = swin3d_phase(device, seed, t0, card, sc_dir,
                                           steps=steps,
                                           views=FULL_RUN_TEST_VIEWS,
                                           traced=False)
    st_rows, st_launches, _ = stratified_phase(device, seed, t0, card, sc_dir,
                                               steps=steps)
    oc_rows, oc_launches, _ = octformer_phase(device, seed, t0, card, sc_dir,
                                              steps=steps)
    pointcontrast_phase(device, seed, t0, card)
    dd_rows, dd_launches = ddp_phase(device, seed, t0, card)
    lo_rows, lo_launches = leftovers_phase(device, seed, t0, card)

    # one entry per kernel: its heaviest captured shape of the S3DIS paths
    kernels = []
    for name in TRAIN_KERNELS:
        info = KERNEL_INFO[name]
        row = max((r for r in rows if r["name"] == name),
                  key=lambda r: r["bound_ms"])
        by_path = {"test": slice_launches[name], "train": train_launches[name],
                   "real": real_launches[name],
                   "scannet_test": sc_launches["scannet_test"][name],
                   "scannet_train": sc_launches["scannet_train"][name],
                   **{p: n[name] for p, n in out_launches.items()},
                   **{p: n[name] for p, n in m1_launches.items()}}
        kernels.append(dict(
            name=name, **info, launches=sum(by_path.values()),
            launches_by_path=by_path,
            launches_per_train_step=train_launches[name] / train_steps,
            launches_per_real_step=real_per_step[name],
            launches_per_scannet_step=sc_per_step[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            device_ms=row["device_ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=f"{row['phase']}: {row['shape']}"))
    # and one per new instance of the ScanNet config, at its heaviest shape
    for inst in sorted({r["instance"] for r in sc_rows}):
        row = max((r for r in sc_rows if r["instance"] == inst),
                  key=lambda r: r["bound_ms"])
        by_path = {p: sc_inst[p].get(inst, 0) for p in sc_inst}
        if sum(by_path.values()) <= 0:
            raise RuntimeError(f"{inst} never launched on the ScanNet paths")
        kernels.append(dict(
            name=inst, **KERNEL_INFO[row["name"]],
            launches=sum(by_path.values()), launches_by_path=by_path,
            launches_per_scannet_step=sc_inst_per_step.get(inst, 0),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            device_ms=row["device_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"],
            shape=f"{row['phase']}: {row['shape']}"))
    # and one per kernel of the outdoor, PT-v2m1, sparse, CAC, PT-v1 and
    # Swin3D paths, at its heaviest shape there, with the launches of those
    # paths (of the heads' paths, CAC on PT-v2m2's: the others launch none)
    for tag, phase_rows, paths in (
            ("outdoor", out_rows, out_launches), ("ptv2m1", m1_rows, m1_launches),
            ("sparse", sp_rows, sp_launches),
            ("cac", hd_rows, {"cac_ptv2_train": hd_launches["cac_ptv2_train"]}),
            ("ptv1", [r for r in v1_rows if r["name"] != "fps"], v1_launches),
            ("swin3d", sw_rows, sw_launches),
            ("stratified", st_rows, st_launches),
            ("octformer", oc_rows, oc_launches),
            ("ddp", dd_rows, dd_launches),
            *((tag, lo_rows[tag], lo_launches[tag]) for tag in lo_rows)):
        for name in sorted({r["name"] for r in phase_rows}):
            row = max((r for r in phase_rows if r["name"] == name),
                      key=lambda r: r["bound_ms"])
            by_path = {p: n[name] for p, n in paths.items()}
            if sum(by_path.values()) <= 0:
                raise RuntimeError(f"{name} never launched on the {tag} paths")
            kernels.append(dict(
                name=f"{name}[{tag}]", **KERNEL_INFO[name],
                launches=sum(by_path.values()), launches_by_path=by_path,
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                device_ms=row["device_ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"],
                shape=f"{row['phase']}: {row['shape']}"))
    # and FPS (phase 12's paths only): one entry for the S3DIS Seg50 paths
    # (with the padded and tied cases), one for the ModelNet Cls26 paths'
    # small scenes and one for PartSeg50's, each at its heaviest shape there
    # and with the launches of its own paths
    for name, phases, paths in (
            ("fps", ("PT-v1 Seg50", "fps cases"), ("seg50_train", "seg50_test")),
            ("fps[cls26]", ("Cls26",), ("cls_train", "cls_test")),
            ("fps[partseg50]", ("PartSeg50",), ("partseg_test",))):
        row = max((r for r in v1_rows if r["name"] == "fps"
                   and r["phase"].startswith(phases)), key=lambda r: r["bound_ms"])
        by_path = {p: v1_launches[p]["fps"] for p in paths}
        if sum(by_path.values()) <= 0:
            raise RuntimeError(f"{name} never launched on its paths")
        kernels.append(dict(
            name=name, **KERNEL_INFO["fps"], launches=sum(by_path.values()),
            launches_by_path=by_path, max_abs_err=row["max_abs_err"],
            ms=row["ms"], device_ms=row["device_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=f"{row['phase']}: {row['shape']}"))
    return kernels


def main():
    parser = argparse.ArgumentParser(description="port smoke run on one card")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--scannet-batch", type=int, default=None, metavar="B",
        help="run only the ScanNet config's train steps at batch B (the "
             "config's own batch_size is 12), printing step seconds and peak "
             "memory, and no kernel record")
    parser.add_argument(
        "--scannet-options", nargs="*", default=list(SCANNET_BF16),
        metavar="KEY=VALUE",
        help="config overrides of the ScanNet run (default: bf16 compute; "
             "none: the config as written, f32)")
    parser.add_argument(
        "--outdoor-batch", type=int, default=None, metavar="B",
        help="run only the SemanticKITTI config's train steps at batch B (the "
             "config's own batch_size is 12), printing step seconds, peak "
             "memory and overflow counts, and no kernel record")
    parser.add_argument(
        "--outdoor-options", nargs="*",
        default=["model.backbone.enable_checkpoint=True"], metavar="KEY=VALUE",
        help="config overrides of the SemanticKITTI run (default: "
             "checkpointing on; none: the config as written)")
    parser.add_argument(
        "--sparse", action="store_true",
        help="run only phase 10 (the sparse-convolution configs, on rooms and "
             "scans made for it) with a traced ScanNet SpUNet step, and no "
             "kernel record")
    parser.add_argument(
        "--heads", action="store_true",
        help="run only phase 11 (the CAC, PointGroup and MSC configs, on rooms "
             "made for it), and no kernel record")
    parser.add_argument(
        "--ptv1", action="store_true",
        help="run only phase 12 (PT-v1 Seg50, the ModelNet40 configs and "
             "PartSeg50, on data made for it), and no kernel record")
    parser.add_argument(
        "--swin3d", action="store_true",
        help="run only phase 13 (the ScanNet Swin3D configs, on rooms made for "
             "it), and no kernel record")
    parser.add_argument(
        "--stratified", action="store_true",
        help="run only phase 14 (the ScanNet Stratified Transformer configs, "
             "on rooms made for it) at the largest of ST_BATCHES whose unmixed "
             "step fits, with a traced step, and no kernel record")
    parser.add_argument(
        "--octformer", action="store_true",
        help="run only phase 15 (the ScanNet OctFormer config, on rooms made "
             "for it) at the largest of OCTFORMER_BATCHES whose unmixed step "
             "fits, with a traced step, and no kernel record")
    parser.add_argument(
        "--pointcontrast", action="store_true",
        help="run only phase 16 (PointContrast: .sens scenes, the pair "
             "preprocessor, 2 steps of its config), and no kernel record")
    parser.add_argument(
        "--ddp", action="store_true",
        help="run only phase 17 (data parallelism on the one card: gloo "
             "processes against one, an NCCL group of one), and no kernel "
             "record")
    parser.add_argument(
        "--ddp-faults", action="store_true",
        help="with --ddp: also run two gloo processes with each fault of "
             "DDP_FAULTS planted in their gradient reduction, which must fall "
             "outside phase 17's band")
    parser.add_argument(
        "--lovasz-spread", nargs="*", default=None, metavar="SETTING",
        choices=sorted(LOVASZ_SPREADS),
        help="run only the single-process spread of phase 17's Lovasz case "
             "and two gloo processes against the single one, under each "
             "SETTING of LOVASZ_SPREADS (default: all), and no kernel record")
    parser.add_argument(
        "--leftovers", action="store_true",
        help="run only phase 18 (raw S3DIS rooms through the preprocessor, "
             "a ConcatDataset train with RuntimeProfilerV2, DataCacheOperator, "
             "the AO_* switches' steps), and no kernel record")
    parser.add_argument(
        "--ddp-nccl", type=int, nargs="+", default=None, metavar="N",
        help="run only phase 17's single process and, for each N, N processes "
             "over NCCL on N cards held against it (needs N cards), and no "
             "kernel record")
    parser.add_argument(
        "--point-bn", action="store_true",
        help="run only PointBatchNorm's kernels on BN_CASES (train and eval, "
             "held and timed as in phase 4), and no kernel record")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    # a healthy run takes 11-15 minutes: a hang becomes a traceback
    # and a non-zero exit inside the caller's 1200 s
    faulthandler.dump_traceback_later(1020, exit=True)
    t0 = time.perf_counter()
    from ao_tpu_torch.ops import _native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    _native.lib()
    built = _native.build_seconds
    log(t0, f"kernels built: parallel nvcc, {built:.1f} s" if built is not None
        else f"kernels reused from {_native.BUILD_DIR}")

    if args.scannet_batch is not None:
        scannet_phase(torch.device("cuda"), args.seed, t0, card,
                      batch_size=args.scannet_batch, test=False,
                      extra=args.scannet_options)
    if args.outdoor_batch is not None:
        outdoor_phase(torch.device("cuda"), args.seed, t0, card,
                      batch_size=args.outdoor_batch, full=False,
                      extra=args.outdoor_options)
    if args.sparse:
        sparse_phase(torch.device("cuda"), args.seed, t0, card, profile=True)
    if args.heads:
        heads_phase(torch.device("cuda"), args.seed, t0, card)
    if args.ptv1:
        ptv1_phase(torch.device("cuda"), args.seed, t0, card)
    if args.swin3d:
        swin3d_phase(torch.device("cuda"), args.seed, t0, card,
                     batches=SWIN3D_BATCHES)
    if args.stratified:
        stratified_phase(torch.device("cuda"), args.seed, t0, card,
                         batches=ST_BATCHES, traced=True)
    if args.octformer:
        octformer_phase(torch.device("cuda"), args.seed, t0, card,
                        batches=OCTFORMER_BATCHES, traced=True)
    if args.pointcontrast:
        pointcontrast_phase(torch.device("cuda"), args.seed, t0, card,
                            batches=POINTCONTRAST_BATCHES)
    if args.lovasz_spread is not None:
        lovasz_spread(args.seed, t0, card,
                      args.lovasz_spread or tuple(LOVASZ_SPREADS))
    if args.ddp or args.ddp_faults:
        ddp_phase(torch.device("cuda"), args.seed, t0, card,
                  faults=DDP_FAULTS if args.ddp_faults else ())
    if args.ddp_nccl:
        ddp_phase(torch.device("cuda"), args.seed, t0, card, gloo=False,
                  nccl=args.ddp_nccl, group_of_one=False)
    if args.leftovers:
        leftovers_phase(torch.device("cuda"), args.seed, t0, card)
    if args.point_bn:
        point_bn_cases(torch.device("cuda"), args.seed, t0)
    if (args.scannet_batch is not None or args.outdoor_batch is not None
            or args.sparse or args.heads or args.ptv1 or args.swin3d
            or args.stratified or args.octformer or args.pointcontrast
            or args.ddp or args.ddp_faults or args.ddp_nccl
            or args.lovasz_spread is not None or args.leftovers
            or args.point_bn):
        faulthandler.cancel_dump_traceback_later()
        print(f"card: {card}", flush=True)
        return 0
    kernels = run(torch.device("cuda"), args.seed, t0, card=card)
    faulthandler.cancel_dump_traceback_later()
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
