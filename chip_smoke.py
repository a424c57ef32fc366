#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving paths, its PTQ calibration, its
``ptq`` and ``infer`` missions and its PTQ extensions on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile] [--ab] [--serving-extras]
                          [--swinunetr]

``--ab`` runs phases 0, 2, 4 and 7 alone (the serving paths' volumes/s
and the flagship calibration's seconds) and prints no result line: copied
into two trees and run from each in one call, it compares their serving
and calibration speed with the same harness.  ``--serving-extras`` runs
phases 0, 2, 4, 8 and 11 alone and prints no result line.
``--swinunetr`` runs phases 0 and 14 alone and prints no result line.

Phases, each printed on its own lines:

0. setup: the card (as nvidia-smi names it), torch / CUDA / nvcc versions,
   and the builds of K1 (efficientq_tpu_torch/csrc/qconv3d_int8.cu), K2
   (csrc/stem_s2d.cu), K3 (csrc/qmatmul_int8.cu) and K4
   (csrc/qmatmul_f32.cu), one nvcc for sm_90a per source, started
   together, with the build seconds, and ptxas's registers, barriers and
   spills of each K1 and K2 kernel;
1. K1 against its plain PyTorch version on the card, at every conv shape
   and epilogue of the flagship BraTS net (N = 2, 128^3 patches) and at
   dilation 1 and 2, and at wide and remainder geometries (C and O of 40,
   72, 256, extents below one brick and odd, N = 1 and 3, every brick of
   the tile plan, dilation up to 9, float32 and bfloat16 output): outputs
   must be identical (torch.equal); then the kernel's and the plain
   version's times (medians of 20 launches after 3 warm-up launches, and
   of 5 after 1 for the plain version);
   then K1 at the LiTS preset's 18 interior convs (two per stage of
   64^3 x 32 ... 4^3 x 512 ... 64^3 x 32, N = 8 patches, float32 output)
   on the sub-4-bit recipe's 16-level grid: 16-level act-quant prologue
   and next-act-quant epilogue, 16-level codes with residual, relu and
   pool, and at C = O = 512 a 16-level conv feeding a 4-level one and the
   other way round, each equal to the plain K1 (torch.equal), with K1's,
   the plain version's and cuDNN's times (per call and as device time)
   and the bound; then K1 taking a float32 input (its quantize pass and
   the convolution on the codes) at the nine block1 convs of the LiTS
   serving net (N = 8, 4 levels, the served quant epilogue), equal to
   ``act_codes`` + K1 on the codes (torch.equal), with both device times,
   ``act_codes``'s and the bound, and ``prologue_quant_launches``;
2. the serving slice at full width: the BraTS W4A4 preset with weights
   from ``--seed``, BN folded, post-PTQ weights emulated (projected onto
   the alpha grid, alpha_act = 1), exported and reloaded as an int8
   checkpoint, deployed to the fused int8 graph, and 3 synthetic BraTS
   volumes (155 x 240 x 240, 4 modalities) served with 128^3 patches at
   overlap 16, patch batch 2, final head, multilabel hard prediction.
   K1 must have launched 14 times per patch-batch forward; the first
   volume's prediction must match a run with the plain K1 on the card;
   Dice per class against the synthetic labels must be finite.
3. K2 and K1 at bfloat16 against their plain versions on the card: K2 at
   the flagship geometry (B = 8 s2d patches of the BraTS grid, both
   z parities, C8 = O = 32) with float32 and bfloat16 outputs, and at an
   odd small geometry (C = 4, O = 8, depth 23): float32 output within
   1e-4 max|y|, bfloat16 output within one bf16 ulp (or, for values that
   small, within 1e-4 max|y|), int8 codes equal
   except at .5 ties of the plain clip(y/alpha, 0, 1)(n-1) (within 1e-4;
   at bfloat16 also where the rounded outputs differ), counted; K1 with
   bfloat16 output and residual at every flagship conv shape and epilogue
   (torch.equal).  Times: median of 20 launches after 3 warm-ups, with
   the plain version's, one PyTorch library call's (cuDNN) and the bound
   (bytes over 3.35 TB/s, operations over the tensor-core peak); for K1
   per stage also its int8 TOP/s, its share of the bound and its tiles;
   K1, K2 and cuDNN also as device time alone (CUDA graph replay of 10
   calls); K2 at the flagship called as the serving path calls it (alpha
   on the card, weights packed at deploy time), per call in three rounds
   (min / median / max), with its plan (``kernels/stem.py::_k2_plan``).
4. the s2d bf16 serving slice (``--serve_stem s2d``), run eagerly (the
   patch forward not captured; phase 11 (a) holds the captured path
   against it): the same net and
   volumes through ``ptq.deploy.make_s2d_volume_inferencer`` (host
   volume, channels-first tail, K2 stem, K1 at bfloat16, final head,
   multilabel hard prediction, patch batch "auto" = the whole grid of 8).
   K2 must launch once and K1 14 times per patch-batch forward; volume 1
   must agree on >= 0.999 of voxel-classes with the direct bf16 inferencer
   (cuDNN stem), equal the s2d path on the plain K1, and agree on >= 0.99
   with the s2d path on the plain K2 and K1: the float64 stem rounds a
   few bf16 outputs and codes apart and the random-weight net amplifies
   them; with the plain stem's codes swapped in, the K2 path must equal
   the plain path (a run with its activation swapped in is printed);
   Dice must be finite.  Also the s2d transform's two placements (on the
   host before the upload, on the card after it), timed and checked
   bit-equal.
5. K3 and K4 against their plain versions on the card at the six
   flagship 1x1 shapes (the transition convs), at B = 2 patches with
   float32 input and B = 8 with bfloat16 input: K3 equal (torch.equal),
   with per-tensor and per-channel scale; K4 within 1e-5 max|y|.  Times
   (median of 20 launches after 3 warm-ups) of the kernels, their plain
   versions and one library call each (``torch._int_mm`` on the codes for
   K3, float32 ``torch.addmm`` with TF32 off on the fake-quantized x for
   K4), and the bounds (bytes over 3.35 TB/s against operations over the
   int8 tensor-core or the float32 non-tensor peak).  K3 (with weights
   packed as the deployment packs them), K4 and their library calls also
   as device time alone (CUDA graph replay of 10 calls), the difference
   printed as the host's time per call; each kernel per call in three
   rounds (min / median / max, its same-card spread); each kernel's plan
   per shape.
6. the ``include_1x1`` serving paths on the same net and volumes:
   (a) the int8 deployment with the 1x1 convs flagged, on the int8
   float32 path: 14 K1 and 6 K3 launches per forward, predictions equal
   to phase 2's; (b) the same graph on the s2d bf16 path: 1 K2, 14 K1, 6
   K3 per forward, predictions equal to phase 4's; (c) the headline mode,
   the mixed deployment (``only_kernel_sizes={(3, 3, 3)}``, ``--deploy
   mixed``) with ``--serve_stem s2d`` and ``include_1x1``: 1 K2, 14 K1, 6
   K4 per forward, >= 0.99 agreement with the same path on the plain K4
   (the 1x1 outputs that differ and the downstream codes that flip are
   counted), and the agreement with the mixed path on cuDNN's bf16 1x1
   convs printed; (d) fq mode: the quantized graph with BN folded and its
   weights unprojected, flagged, on one 128^3 patch through
   ``nnir.apply(mode="fq")``: 6 K4 launches, finite logits, >= 0.99
   argmax agreement with the plain-K4 forward, the max |logit difference|
   printed.
7. the calibration slice: the same preset at full width and depth, weights
   from ``--seed`` with BN state randomised as tests/test_ptq_e2e.py does,
   calibrated by ``ptq.run_ptq`` (200 ADMM iterations a layer) on one
   synthetic BraTS volume center-cropped to 128 x 192 x 192 by the
   calibration crop rule.  Printed beside the card's name and power
   limit: the FP forward's and the calibration's seconds, each layer's
   Gram build, ADMM and the rest (CUDA events) and reported loss, and the
   peak device memory.  Checked: 22 finite layer losses, every
   weight-quantized kernel on its grid, the quantized forward equal to the
   sweep's output within 1e-3, the calibrated net's MSE to the FP output
   below the naive net's (fq at alpha_w = 1 with the calibrated alpha_act,
   as the JAX test; the net with each kernel projected at its own alpha is
   printed).  The calibrated net is deployed to int8 and serves phase 2's
   first volume on the int8 float32 path (14 K1 launches per forward,
   equal to the plain-K1 run, finite Dice, agreement with the FP net's
   prediction printed) and on the s2d bf16 path (1 K2 and 14 K1 launches,
   >= 0.99 agreement with the s2d path on the plain K2 and K1).  Then the
   tiny fixture of tests/test_ptq_e2e.py is calibrated on the card, and
   on the CPU unperturbed and under 12 rounding-level (1e-7) perturbations
   of its Grams, which reach several equally valid outcomes: the card's
   gaps to the unperturbed run are printed, and its outcome must lie,
   within the CPU tests' tolerances (codes equal on >= 0.99, layer losses
   within 1e-2, alpha_act within 1e-5, class voxel counts equal, argmax
   agreement >= 0.99), at one of the CPU's.

8. the missions through the port's CLI (``efficientq_tpu_torch.cli``) at
   full width, in a temporary directory removed at the end: (a) a
   synthetic BraTS dataset (4 subjects of 155 x 240 x 240 x 4, npz; train,
   val, test and true-test splits) and phase 7's flagship (weights from
   ``--seed``, BN state randomised) pickled as ``{'state_dict': ...}``;
   (b) the README's command, ``ptq --qlvl_w 4 --qlvl_a 4 --round 1
   --config config/brats_ptq.yaml --pretrain <ckpt> --data_dir <data>
   --split_dir <splits> --true_test --save_nii``: every artifact file, 22
   finite layer losses, finite val and test metrics, an export of NumPy
   arrays with its 22 grids, no K1 launch (its final test is fake-quant);
   its seconds split into data, FP forward, calibration, final test and
   exports, beside the card's name and power limit; (c) ``infer --deploy
   int8`` on (b)'s ``state_in_int8.pkl`` with ``--save_nii``: 14 K1
   launches per patch-batch forward, the saved val prediction equal to
   ``validate_seg`` of the same deployed graph on the plain K1
   (``np.array_equal``); (d) ``infer --deploy mixed --serve_stem s2d
   --serve_dtype bf16``: 1 K2 and 14 K1 launches per forward, >= 0.99
   agreement with the same path on the plain K2 and K1; (e) a sustained
   stream: ``validate_seg`` over 4 volumes (phase 2's three, repeated)
   through the port's ``Loader`` on the int8 float32 path and the s2d bf16
   path (each patch forward replayed from CUDA graphs), volumes/s over
   volumes 2-4 beside phases 2 and 4's rates, and the host's time in
   ``SegMetricMC``.  Phases 8 to 10 pass ``--tune_serving off``: their
   patch batches stay ``min(grid, 8)``.
9. the PTQ extensions through the CLI at full width, beside the
   toolchain's fingerprint (``utils/toolchain.py``): (a) a synthetic LiTS
   set (8 subjects of 256 x 256 x 128, npy, 1 modality; train 4, val 2,
   test 2) and the LiTS preset (widths 32-512-32, init stride 2,2,1)
   with weights from ``--seed`` and BN state randomised; (b) the
   sub-4-bit recipe as a user types it, ``ptq --qlvl_w 4 --qlvl_a 4
   --round 1 --config config/lits_ptq_sub4.yaml`` (``--mixed_frac 0.25
   --mixed_qlvl 16 --lwq_select 4``): ``calib_select.txt`` with 4 scores
   and one pick, ``mixed_upgraded.txt`` with the tail convs first, the
   export's 16-level grids on the lifted layers, finite layer losses and
   metrics, no K1 launch; its seconds by part (data, the ranking pass,
   each candidate's calibration and scoring, FP forward, the kept
   calibration, final test, exports) and its peak device memory;
   (c) ``infer --deploy int8`` on (b)'s export: K1 launches equal to the
   deployed graph's flagged convs (printed) times the forwards, the
   saved val predictions equal to ``validate_seg`` of the same graph on
   the plain K1; (d) ``ptq --config config/brats_ptq.yaml --mixed_frac
   0.25 --lwq_granularity block --act_offset 2 --tail_alpha_sweep
   --tune_act 50 --no_test`` on phase 8's BraTS set and checkpoint: the
   sweep's and the tuning's files, ``act_k`` on the tail convs, 22
   finite layer losses; then ``infer --deploy mixed --serve_stem s2d
   --serve_dtype bf16`` on its export: one K2 launch per forward, K1
   launches of 14 less the offset-grid 3^3 convs per forward, >= 0.99
   agreement with the same path on the plain K2 and K1.
10. FP training and the quantization-aware fine-tune at full width: (a)
   the train step of the flagship preset of ``config/brats_fp.yaml``
   (weights from ``--seed``, a batch of 4 synthetic 128^3 x 4 patches,
   loss bhybrid, dropout 0.5) at float32 with TF32 off, float32 with TF32
   on (the FP step's default), ``--amp`` and ``--remat 4``: the median ms
   per optimizer step over steps 2-6 (CUDA events), samples/s, peak device
   memory, and one step's forward, backward and Adam parts; finite losses,
   BN running stats that moved, the amp loss within 2e-2 of the float32
   loss; with dropout 0, one step on the card (TF32 off) against the
   CPU's float64 step on the same weights and batch (batch 2 of 64^3 at
   full width; the CPU's float32 step printed beside it): the loss within
   rtol 1e-6, the whole gradient within 1e-3 (relative L2) and each leaf
   within 1e-2 of its largest entry; at dropout 0.5 with deterministic cuDNN the remat step
   against the plain one: the loss and BN state equal, gradients within
   1e-5 of each leaf's largest entry; (b) ``train_fp --round 2 --config
   <brats_fp.yaml with max_epoch 4> --data_dir <phase 8's set> --split_dir
   <its 4 subjects as train, 1 as val, 1 as test> --max_epoch 4
   --test_interval 2`` (the YAML wins over the command line, so the copy
   carries the 4): ``description.txt``, ``loss.txt``, ``seg_metric.txt``,
   ``state_0004.pkl``, ``state_FP.npz`` and finite
   ``seg_0004/{val,test}_seg.txt``, its seconds by part and the host's
   share of the train loop; (c) ``ptq --qlvl_w 4 --qlvl_a 4 --round 1
   --config config/brats_ptq.yaml --pretrain <(b)'s state_0004.pkl>
   --qat_epochs 1 --loss bhybrid --no_test`` (the FP preset's loss: the
   default CE cannot take BraTS's multi-label targets):
   ``qat/qat_loss.txt`` with its epoch-0 and epoch-1 lines and one kept
   mark, 22 finite layer losses, every weight-quantized kernel of the
   export on its grid; its seconds with the fine-tune apart; (d) ``infer
   --deploy int8`` on (c)'s export: 14 K1 launches per patch-batch
   forward, the saved val prediction equal to ``validate_seg`` of the same
   deployed graph on the plain K1.
11. the serving extras on the flagship (``eval/sliding.py``,
   ``eval/autotune.py``, ``export.py``, ``kernels/library.py``): (a) the
   captured int8 float32 path (``make_volume_inferencer``'s default on a
   card, each chunk's patch forward replayed from a CUDA graph) over phase
   2's three volumes and the captured s2d bf16 path over phase 4's:
   predictions equal (``torch.equal``) to phases 2 and 4's eager ones, the
   eager paths' K1 and K2 launches per forward, volumes/s of each path beside
   its eager one, in turns in this call, and one volume of each int8 path
   under the profiler (device busy, idle share); (b) the column grid
   (``serve_grid="column"``: 4 columns of 160 x 128 x 128 in one forward)
   on phase 2's volumes: K1 equal to the plain K1 at every conv of the
   column forward, the path equal to the same path on the plain K1, 14 K1
   launches a volume, its agreement with the patch grid printed, and
   volumes/s against the captured patch grid in turns; (c) the autotuner
   (``choose_patch_batch(tune="auto")`` with its cache in the temporary
   directory): each candidate's time, the choice and the sweep's seconds,
   then a second call that reads the cache with no launch; (d) ``infer
   --deploy int8 --export_artifact`` and ``infer --deploy mixed
   --serve_stem s2d --serve_dtype bf16 --export_artifact`` on phase 8's
   export, then ``infer --artifact`` on each zip: the int8 artifact's
   predictions equal to phase 8 (c)'s, the s2d artifact's (a float32 head,
   as the JAX package's) >= 0.999 with phase 8 (d)'s, the export seconds,
   the artifact runs' K1 and K2 launches; (e) one batch of 2 patches
   through the exported ``include_1x1`` int8 graph (K1 and K3 as the
   registered ``effq::`` operators) equal to its eager forward, 14 K1 and
   6 K3 launches.  Phases 8 to 11 write their data to one temporary
   directory, removed at the end.
12. K5 (efficientq_tpu_torch/csrc/upsample3d.cu, built here) against its
   plain version (``F.interpolate``, then the add): at the LiTS chunk's
   five upsamples (N = 8: TransUp5-8 with the skip in the epilogue, and
   the head, NDHWC and NCDHW) outputs identical (torch.equal) on normal
   inputs, and per call K5's time (events around one call; device time
   alone from CUDA graph replay), the byte bound (x, skip and y over
   3.35 TB/s), the plain version's time and ``F.interpolate`` plus the add
   on an NCDHW tensor; then a 256 x 256 x 128 LiTS volume through the
   main path (``validate._build_infer``, captured) on the LiTS preset's
   int8 deployment: 5 K5 and 18 K1 launches a chunk (9 of them
   quantizing a float input, ``prologue_quant_launches``; 12 of a chunk of
   8 and 8 of the last chunk of 3 on K1's overlapped pipeline,
   ``overlapped_launches``), the prediction
   and one chunk's logits identical to the same network on K5's plain
   version.  The
   plain networks of phases 2, 4, 7, 8, 9, 10 and 11 run K5's plain
   version too.
13. K6 (efficientq_tpu_torch/csrc/groupnorm.cu, built here) against its
   plain version (float64 statistics in PyTorch): at SegResNet's
   GroupNorms in a chunk of 8 patches of 128 x 192 x 160 (32 channels at
   full resolution, emitting K1's codes, to 256 at an eighth; the head's
   ReLU'd float32) outputs identical (torch.equal) on normal inputs, and
   per call K6's device time (CUDA graph replay), the byte bound (x read
   once, the codes or float32 written once, over 3.35 TB/s), the plain
   version's time and ``F.group_norm`` on an NCDHW tensor with the ReLU
   and the act-quant as torch ops; then a BraTS study of 155 x 240 x 240
   through the main path (``validate._build_infer``, captured) on the
   full-width SegResNet's int8 deployment: 25 K6, 24 K1 and 3 K5 launches
   a chunk, no K1 launch quantizing a float input (K6 hands K1 codes), all
   24 on K1's overlapped pipeline (``overlapped_launches``).
14. SwinUNETR's kernels (K7, efficientq_tpu_torch/csrc/window_attention.cu,
   built here; K1 and K3 on the offset grid; K6 at one channel a group)
   at the published widths (feature size 48, heads 3, 6, 12, 24, window
   7) on weights from ``--seed`` on 4-level grids: (a) one chunk of 8
   patches of 128^3 through the served graph (``serving_graph``), eagerly,
   every K1, K3, K6 and K7 call held to its plain version on the same
   inputs as it runs: K1 (the offset-grid quantize pass of a float input
   at k = 1 included), K3 (K 1536 and 3072 walked in chunks) and K6 (48
   to 768 channels) ``torch.equal``; K7 at the four stages, shift 0 and
   3, within its tolerance (at most one element in 10^5 differs, by at
   most one float32 ulp); 19, 46, 26 and 8 calls; per shape the calls'
   device time (events around each eager call, launched while the card
   spins, so the host's launch time is not counted) beside the bound
   computed from their arguments (bytes over 3.35 TB/s against int8
   operations at 1,979 TOP/s, K7's QK^T and AV at the float32 peak of 67
   TFLOP/s);
   (b) a BraTS study of 155 x 240 x 240 through the main path
   (``validate._build_infer``, captured): 19 K1, 46 K3, 26 K6 and 8 K7
   launches a chunk, 8 x 8532 window-heads, K7's tile scores as
   ``tile_scores`` counts them; the InstanceNorms' and
   LayerNorms' elements printed.

``--profile`` adds a torch.profiler probe of one volume of each serving
path (phases 2 and 4, and paths (b) and (c) of phase 6), of one
``run_ptq`` of phase 7 at 20 ADMM iterations a layer (wall time, device
time and the kernels by device time), and, last, (phase 8 (f)) of phase
8's stream on both paths: device busy time (the union of kernels, copies and
memsets over every stream), idle share, the host-to-device copies' time
and how much of it ran while a kernel ran on the compute stream, from the
profiler's Chrome trace.

Then one JSON line describing each kernel of the paths, the card's
nvidia-smi line, and the result line.  With no CUDA device, or when any
phase fails, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K1_SOURCE = "efficientq_tpu_torch/csrc/qconv3d_int8.cu"
K1_REPLACES = "efficientq_tpu/pallas/qconv3d.py:439"
K2_SOURCE = "efficientq_tpu_torch/csrc/stem_s2d.cu"
K2_REPLACES = "efficientq_tpu/pallas/stem.py:328"
K3_SOURCE = "efficientq_tpu_torch/csrc/qmatmul_int8.cu"
K3_REPLACES = "efficientq_tpu/pallas/qmatmul.py:116"
K4_SOURCE = "efficientq_tpu_torch/csrc/qmatmul_f32.cu"
K4_REPLACES = "efficientq_tpu/pallas/qmatmul.py:54"
K5_SOURCE = "efficientq_tpu_torch/csrc/upsample3d.cu"
K5_REPLACES = "none: efficientq_tpu/ops.py:198 resizes with jax.image.resize"
K6_SOURCE = "efficientq_tpu_torch/csrc/groupnorm.cu"
K6_REPLACES = "none: the JAX package has no GroupNorm"
# NVIDIA H100 SXM published peaks (dense): device memory bytes/s, bf16 and
# int8 tensor-core operations/s, float32 operations/s off the tensor cores
HBM_BPS, BF16_OPS, INT8_OPS = 3.35e12, 989e12, 1979e12
FP32_OPS = 67e12
# flagship BraTS stages at a 128^3 patch (init stride 2): (extent, width)
STAGES = [(64, 32), (32, 64), (16, 128), (8, 256), (16, 128), (32, 64),
          (64, 32)]
N_BATCH = 2
VOL_SHAPE = (155, 240, 240)
PATCH, OVERLAP = (128, 128, 128), (16, 16, 16)
AGREE_MIN = 0.9999
AGREE_S2D = 0.999  # bf16 reduction order (the JAX test's own level)
# the plain K2 (float64 sums) against K2 (float32 tensor-core sums): the
# random-weight net amplifies the stem's rounding-level differences
# (phase 4 prints which of them moves the predictions)
AGREE_PLAIN_S2D = 0.99
# K4 against its plain version (float32 sums in another order) on the
# paths of phase 6 (c) and (d): the same amplification of code flips
AGREE_PLAIN_K4 = 0.99
# phases 3 and 5 time K2, K3 and K4 this many times (the same-card spread)
ROUNDS = 3
# phase 1 times the plain K1 (float64 sums, tens of ms a call) over fewer
# launches than the kernels' 20: cut when phase 11 joined the smoke
PLAIN_REPS = dict(warmup=1, reps=5)
# the flagship's six transition 1x1 convs: (name, voxels per 128^3 patch,
# K, N)
ONE_BY_ONE = [("TransDown1", 32768, 32, 64), ("TransDown2", 4096, 64, 128),
              ("TransDown3", 512, 128, 256), ("TransUp4", 512, 256, 128),
              ("TransUp5", 4096, 128, 64), ("TransUp6", 32768, 64, 32)]
S2D_BATCH = 8  # the s2d path's patch batch: the whole grid of a volume
# the LiTS preset's interior 3^3 convs (C = O) at its 128 x 128 x 64 patch
# (init stride 2,2,1), two per stage: (extent, width); the LiTS path serves
# the min(grid, 8) = 8 patches of a 256 x 256 x 128 volume a forward, and
# the sub-4-bit recipe lifts layers to a 16-level grid
LITS_STAGES = [(64, 32), (32, 64), (16, 128), (8, 256), (4, 512), (8, 256),
               (16, 128), (32, 64), (64, 32)]
LITS_BATCH = 8
LITS_QLVL = 16
# K1 launches on the overlapped pipeline in a LiTS chunk of 8 patches and
# in the ragged chunk of 3 that ends a 256 x 256 x 128 volume's 27, and in
# a SegResNet chunk of 8 (tests/test_torch_port_qconv3d.py pins them)
LITS_OVERLAPPED = {8: 12, 3: 8}
SEG_OVERLAPPED = 24
# K1 at the kernel's tile edges (phase 1): (N, extents, C, O, dilation)
WIDE_CASES = [(3, (32, 32, 32), 40, 72, 2), (1, (6, 16, 16), 64, 264, 1),
              (1, (8, 16, 16), 256, 256, 1), (1, (5, 6, 7), 72, 40, 1),
              (3, (8, 8, 8), 256, 256, 2), (1, (3, 2, 5), 48, 40, 1),
              (3, (9, 10, 11), 96, 72, 3), (2, (12, 12, 12), 16, 72, 9)]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def setup():
    from efficientq_tpu_torch.kernels import build, qconv3d, qmatmul, stem

    smi = gpu_line()
    print(smi)
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"[setup] python {sys.version.split()[0]}  torch {torch.__version__}"
          f"  cuda {torch.version.cuda}  nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.load_all(["qconv3d_int8.cu", "stem_s2d.cu", "qmatmul_int8.cu",
                    "qmatmul_f32.cu"])
    qconv3d._lib()
    stem._lib()
    qmatmul._int8_lib()
    qmatmul._f32_lib()
    print(f"[setup] built K1 ({K1_SOURCE}), K2 ({K2_SOURCE}), K3 "
          f"({K3_SOURCE}) and K4 ({K4_SOURCE}) for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in _ptxas_lines(build.build_log.get("qconv3d_int8.cu")):
        print(f"[setup] K1 ptxas: {line}", flush=True)
    for line in _ptxas_lines(build.build_log.get("stem_s2d.cu")):
        print(f"[setup] K2 ptxas: {line}", flush=True)
    return smi


def _ptxas_lines(log):
    """One line per kernel of an nvcc -Xptxas=-v log: the template
    arguments (K1: brick z, brick y, 16-byte loads, or its float input's
    pass and the input type; K2: k-steps per tap, output type), registers,
    barriers, stack and spills."""
    import re

    if log is None:
        return ["no ptxas output (the library was built before this run)"]
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"ILi(\d+)ELi(\d+)ELb(\d)E", m.group(1))
            k2 = re.search(r"stem_s2d_kernelILi(\d+)ELb(\d)E", m.group(1))
            q = re.search(r"qconv3d_int8_kernel_quantizeILb(\d)E",
                          m.group(1))
            name = (f"quantize pass, {('f32', 'bf16')[int(q.group(1))]} x"
                    if q else
                    f"brick {t.group(1)}x{t.group(2)}x8 "
                    f"{'cp.async' if t.group(3) == '1' else 'byte loads'}"
                    if t else
                    f"k-steps {k2.group(1)} (0: run time), "
                    f"{'bf16' if k2.group(2) == '1' else 'f32'} out"
                    if k2 else m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out or ["ptxas printed no resource lines"]


def _median_ms(fn, warmup=3, reps=20):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_ms(fn, calls=10, reps=4, rounds=5):
    """Device time of one call of fn: ``calls`` calls of fn captured in
    one CUDA graph, the graph replayed ``reps`` times between two events
    (no Python between the launches, and the host's time to launch a
    graph spread over ``calls`` kernels), median over ``rounds``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (reps * calls))
    del graph
    return statistics.median(times)


def _max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


def phase1(seed: int):
    """K1 against its plain version: bit-exact at every flagship conv
    shape and epilogue, dilation 1 and 2; times at the 14 convs of one
    forward.  Returns (max |difference|, kernel ms, plain ms) over the
    forward's 14 convs."""
    from efficientq_tpu_torch.kernels import qconv3d as K
    from efficientq_tpu_torch.quant import act_codes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    one = torch.tensor(1.0, device=dev)

    def conv_inputs(s, c, o=None, nb=N_BATCH, per_channel=False):
        o = o or c
        shape = (nb, *(s if isinstance(s, tuple) else (s, s, s)))
        x = torch.randn(*shape, c, device=dev, generator=gen)
        w = (2 * torch.randint(0, 4, (3, 3, 3, c, o), device=dev,
                               generator=gen) - 3).to(torch.int8)
        scale = (torch.rand(o, device=dev, generator=gen) * 0.05
                 if per_channel else torch.tensor(0.05, device=dev))
        return dict(x=x, w=w, b=torch.randn(o, device=dev, generator=gen),
                    scale=scale,
                    res=torch.randn(*shape, o, device=dev, generator=gen))

    def variants(inp, encoder):
        """The epilogue combinations of the fused graph, plus none."""
        qa = act_codes(inp["x"], one, 4)
        return {
            "none": (inp["x"], {}),
            "block1 (quant)": (inp["x"], dict(quant_alpha=one, quant_qlvl=4)),
            "block2 (codes+residual+relu" + ("+pool)" if encoder else ")"): (
                qa, dict(x_quantized=True, residual=inp["res"],
                         residual_relu=True, pool=encoder)),
        }

    max_err = 0.0

    def compare(label, x, inp, kw, dil):
        nonlocal max_err
        args = (x, inp["w"], inp["b"], one, inp["scale"], 4)
        got = K.qconv3x3_int8_ndhwc(*args, dilation=dil, **kw)
        ref = K.qconv3x3_int8_ndhwc_reference(*args, dilation=dil, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref):
            err = float((g.float() - r.float()).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(g, r):
                ulp = _max_ulp(g, r) if g.dtype == torch.float32 else "n/a"
                raise SmokeFailure(f"K1 != plain at {label} dil={dil}: max "
                                   f"|diff| {err}, max ulp {ulp}")

    total_k = total_p = 0.0
    checked = 0
    seen = set()
    for i, (s, c) in enumerate(STAGES):
        encoder = i < len(STAGES) // 2
        inp = conv_inputs(s, c)
        geo = (s, c, encoder)
        for name, (x, kw) in variants(inp, encoder).items():
            for dil in ((1, 2) if geo not in seen else (1,)):
                compare(f"stage{i + 1} {s}^3x{c} {name}", x, inp, kw, dil)
                checked += 1
        seen.add(geo)
        for name, (x, kw) in list(variants(inp, encoder).items())[1:]:
            args = (x, inp["w"], inp["b"], one, inp["scale"], 4)
            qa = x if kw.get("x_quantized") else act_codes(x, one, 4)
            kw_q = dict(kw, x_quantized=True)  # time the conv, not the prologue
            tk = _median_ms(lambda: K.qconv3x3_int8_ndhwc(
                qa, *args[1:], **kw_q))
            tp = _median_ms(lambda: K.qconv3x3_int8_ndhwc_reference(
                qa, *args[1:], **kw_q), **PLAIN_REPS)
            total_k += tk
            total_p += tp
            print(f"[phase1] stage{i + 1} N={N_BATCH} {s}^3 C=O={c} {name}: "
                  f"K1 {tk:.4f} ms  plain {tp:.4f} ms  ({tp / tk:.2f}x)",
                  flush=True)
        del inp
    # per-channel scale, odd extents (VALID pool, masked cells) and a
    # channel count that is not a multiple of 16 (the byte-load halo)
    for s, c, dil in ((64, 32, 1), (9, 8, 2), (7, 3, 1)):
        inp = conv_inputs(s, c, per_channel=True)
        for name, (x, kw) in variants(inp, True).items():
            compare(f"per-channel {s}^3x{c} {name}", x, inp, kw, dil)
            checked += 1
    # wide and remainder geometries: C and O of 40, 72 and 256 (partial
    # 32-channel chunks and column tiles), extents below a brick and odd,
    # N = 1 and 3, every brick of the tile plan, both output dtypes
    for nb, shape, c, o, dil in WIDE_CASES:
        inp = conv_inputs(shape, c, o, nb, per_channel=True)
        for name, (x, kw) in variants(inp, True).items():
            for dt in (torch.float32, torch.bfloat16):
                compare(f"N={nb} {shape} C={c} O={o} {name} {dt}", x, inp,
                        dict(kw, out_dtype=dt), dil)
                checked += 1
        del inp
    print(f"[phase1] {checked} comparisons: K1 == plain (torch.equal) "
          f"everywhere; one forward's 14 convs: K1 {total_k:.4f} ms, plain "
          f"{total_p:.4f} ms", flush=True)
    return max_err, total_k, total_p


def k1_lits(seed: int):
    """Phase 1, LiTS: K1 against its plain version at the LiTS preset's 18
    interior convs (two per stage, C = O up to 512 at the 4^3 bottleneck),
    N = 8 patches, float32 output (the LiTS ``infer --deploy int8`` path),
    on the recipe's 16-level grid: block1 with the 16-level act-quant
    prologue and next-act-quant epilogue, block2 on 16-level codes with
    residual, relu and (encoder) pool; at the bottleneck also a 16-level
    conv feeding a 4-level one and the other way round.  torch.equal
    everywhere.  Times per conv (median of 20 launches, x as codes as in
    phase 1), device time (CUDA graph replay), cuDNN's bf16 conv of the
    codes, and the bound (bytes over 3.35 TB/s against int8 operations
    over 1979 TOP/s).  Returns the sums over one forward's 18 convs."""
    import torch.nn.functional as F

    from efficientq_tpu_torch.kernels import qconv3d as K
    from efficientq_tpu_torch.quant import act_codes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    one = torch.tensor(1.0, device=dev)
    n, q = LITS_BATCH, LITS_QLVL
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               graph_ms=0.0, graph_library_ms=0.0, t_bytes=0.0, t_ops=0.0)
    max_err, checked = 0.0, 0

    def compare(label, args, kw):
        nonlocal max_err, checked
        got = K.qconv3x3_int8_ndhwc(*args, **kw)
        ref = K.qconv3x3_int8_ndhwc_reference(*args, **kw)
        torch.cuda.synchronize()
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            max_err = max(max_err, float((g.float() - r.float()).abs().max()))
            check(g.dtype == r.dtype and torch.equal(g, r),
                  f"K1 != plain at LiTS {label}")
        checked += 1

    for i, (s, c) in enumerate(LITS_STAGES):
        encoder = i < len(LITS_STAGES) // 2
        x = torch.randn(n, s, s, s, c, device=dev, generator=gen)
        w = (2 * torch.randint(0, q, (3, 3, 3, c, c), device=dev,
                               generator=gen) - (q - 1)).to(torch.int8)
        b = torch.randn(c, device=dev, generator=gen)
        scale = torch.tensor(0.002, device=dev)
        res = torch.randn(n, s, s, s, c, device=dev, generator=gen)
        qa = act_codes(x, one, q)
        variants = {
            f"block1 (a{q} + quant{q})": (
                x, dict(quant_alpha=one, quant_qlvl=q)),
            f"block2 (codes{q}+residual+relu" + (
                "+pool)" if encoder else ")"): (
                qa, dict(x_quantized=True, residual=res, residual_relu=True,
                         pool=encoder)),
        }
        if c == 512:
            variants[f"a{q} + quant4"] = (x, dict(quant_alpha=one,
                                                  quant_qlvl=4))
            variants[f"a4 + quant{q}"] = (x, dict(quant_alpha=one,
                                                  quant_qlvl=q, qlvl=4))
        for name, (xin, kw) in variants.items():
            kw = dict(kw)
            compare(f"stage{i + 1} N={n} {s}^3 C=O={c} {name}",
                    (xin, w, b, one, scale, kw.pop("qlvl", q)), kw)
        for name, (xin, kw) in list(variants.items())[:2]:
            kwq = dict(kw, x_quantized=True)  # time the conv, not the prologue
            a = (qa, w, b, one, scale, q)
            tk = _median_ms(lambda: K.qconv3x3_int8_ndhwc(*a, **kwq))
            tp = _median_ms(lambda: K.qconv3x3_int8_ndhwc_reference(*a,
                                                                    **kwq),
                            **PLAIN_REPS)
            xl = qa.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
            wl = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2)
            tl = _median_ms(lambda: F.conv3d(xl, wl, padding=1))
            gk = _graph_ms(lambda: K.qconv3x3_int8_ndhwc(*a, **kwq))
            gl = _graph_ms(lambda: F.conv3d(xl, wl, padding=1))
            cost = _k1_cost(n, s, c, kw, 4, 4)
            bound, by = _bound(*cost, INT8_OPS)
            for key, v in (("ms", tk), ("plain_ms", tp), ("library_ms", tl),
                           ("bound_ms", bound), ("graph_ms", gk),
                           ("graph_library_ms", gl),
                           ("t_bytes", cost[0] / HBM_BPS),
                           ("t_ops", cost[1] / INT8_OPS)):
                tot[key] += v
            plan = K._tile_plan(n, s, s, s, c, c, 1)
            print(f"[phase1] LiTS stage{i + 1} N={n} {s}^3 C=O={c} {name}: "
                  f"K1 {tk:.4f} ms (device {gk:.4f} ms, "
                  f"{cost[1] / gk / 1e9:.1f} TOP/s, {bound / gk:.1%} of the "
                  f"bound)  plain {tp:.4f} ms  cuDNN bf16 conv of the codes "
                  f"{tl:.4f} ms (device {gl:.4f} ms; K1 / cuDNN device "
                  f"{gk / gl:.2f})  bound {bound:.4f} ms ({by})  tiles: "
                  f"brick {plan.brick}, grid {plan.grid}, sums {plan.sums}",
                  flush=True)
            del xl, wl
        del x, w, res, qa, variants
        torch.cuda.empty_cache()
    print(f"[phase1] LiTS: {checked} comparisons at N={n}, {q} levels: K1 "
          f"== plain (torch.equal) everywhere; one forward's 18 convs: K1 "
          f"{tot['ms']:.4f} ms (device {tot['graph_ms']:.4f} ms), plain "
          f"{tot['plain_ms']:.4f} ms, cuDNN {tot['library_ms']:.4f} ms "
          f"(device {tot['graph_library_ms']:.4f} ms), bound "
          f"{tot['bound_ms']:.4f} ms ({tot['bound_ms'] / tot['graph_ms']:.1%}"
          f" of it reached in device time)", flush=True)
    by = "bytes" if tot.pop("t_bytes") >= tot.pop("t_ops") else "operations"
    return dict({f"lits_{k}": v for k, v in tot.items()},
                lits_bound_by=by, lits_max_abs_err=max_err)


def k1_float_input(seed: int, smi: str):
    """Phase 1, K1 with a float input at the LiTS block1 convs (one a
    stage of ``LITS_STAGES``; N = 8 patches, float32 x, 4 levels of alpha
    4/3, the served quant epilogue, as the benchmark serves them): device
    time (CUDA graph replay) of K1 taking x (its
    quantize pass, then the convolution on the codes) beside ``act_codes``
    + K1 on the codes (and each alone), the call's bound (float32 x read
    and codes written once, against its int8 operations), outputs equal
    (torch.equal), and ``prologue_quant_launches`` (one a call).  Returns
    the sums over one forward's nine block1 convs."""
    from efficientq_tpu_torch.kernels import qconv3d as K
    from efficientq_tpu_torch.quant import act_codes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    n, q = LITS_BATCH, 4
    alpha = torch.tensor(4.0 / 3.0, device=dev)
    keys = ("float_input_ms", "separate_ms", "act_codes_ms", "codes_ms",
            "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    rows = {}
    before = K.qconv3x3_int8_ndhwc.prologue_quant_launches
    for s, c in dict.fromkeys(LITS_STAGES):
        count = LITS_STAGES.count((s, c))
        x = torch.randn(n, s, s, s, c, device=dev, generator=gen).abs()
        w = (2 * torch.randint(0, q, (3, 3, 3, c, c), device=dev,
                               generator=gen) - (q - 1)).to(torch.int8)
        b = torch.randn(c, device=dev, generator=gen)
        scale = torch.tensor(0.002, device=dev)
        kw = dict(quant_alpha=alpha, quant_qlvl=q, w_packed=K.pack_weights(w))
        qa = act_codes(x, alpha, q)

        def float_input():
            return K.qconv3x3_int8_ndhwc(x, w, b, alpha, scale, q, **kw)

        def separate():
            return K.qconv3x3_int8_ndhwc(act_codes(x, alpha, q), w, b,
                                         alpha, scale, q, x_quantized=True,
                                         **kw)

        check(torch.equal(float_input(), separate()),
              f"K1 on float x != act_codes + K1 at {s}^3 x {c}")
        nbytes = x.numel() * 5 + 27 * c * c + 8 * c
        bound, by = _bound(nbytes, 2 * x.numel() * 27 * c, INT8_OPS)
        row = dict(
            float_input_ms=_graph_ms(float_input),
            separate_ms=_graph_ms(separate),
            act_codes_ms=_graph_ms(lambda: act_codes(x, alpha, q)),
            codes_ms=_graph_ms(lambda: K.qconv3x3_int8_ndhwc(
                qa, w, b, alpha, scale, q, x_quantized=True, **kw)),
            bound_ms=bound)
        rows[f"{s}^3 x {c}"] = row
        for k in keys:
            tot[k] += count * row[k]
        print(f"[phase1] K1 on float x, LiTS block1 N={n} {s}^3 C=O={c} "
              f"(x{count} a forward): device {row['float_input_ms']:.4f} ms "
              f"({100 * bound / row['float_input_ms']:.1f} % of the bound "
              f"{bound:.4f}, {by}); act_codes + K1 on codes "
              f"{row['separate_ms']:.4f} (act_codes {row['act_codes_ms']:.4f}"
              f", K1 on codes {row['codes_ms']:.4f}); equal (torch.equal)",
              flush=True)
        del x, w, qa, kw
        torch.cuda.empty_cache()
    calls = K.qconv3x3_int8_ndhwc.prologue_quant_launches - before
    print(f"[phase1] on {smi}: one LiTS forward's nine block1 convs (N={n}): "
          f"K1 on float x {tot['float_input_ms']:.4f} ms, act_codes + K1 "
          f"{tot['separate_ms']:.4f} ms (act_codes {tot['act_codes_ms']:.4f},"
          f" K1 on codes {tot['codes_ms']:.4f}), bound {tot['bound_ms']:.4f};"
          f" {tot['float_input_ms'] / n:.4f} against "
          f"{tot['separate_ms'] / n:.4f} ms a patch; prologue_quant_launches "
          f"+{calls} over these calls", flush=True)
    return dict(tot, shapes=rows)


def post_ptq_weights(graph, seed: int):
    """``graph``'s weights from ``seed``, BN folded, post-PTQ weights
    emulated: each weight-quantized kernel on its grid (alpha = max |w|),
    every activation range 1.  Returns the folded (graph, variables) on
    the CPU."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.ptq import fold_bn
    from efficientq_tpu_torch.quant import fake_quant_weight

    fgraph, fvars = fold_bn(graph, nnir.init(graph, seed, device="cpu"))
    for node in fgraph.qconv_nodes():
        qcfg = node.attrs["qcfg"]
        p = fvars["params"][node.name]
        if qcfg.q_weight:
            alpha = torch.clamp_min(p["kernel"].abs().max(), 1e-8)
            p["kernel"] = fake_quant_weight(p["kernel"], alpha, qcfg.qlvl_w)
            p["alpha_w"] = alpha
        if qcfg.q_act:
            p["alpha_act"] = torch.tensor(1.0)
    return fgraph, fvars


def deploy_served(graph, variables, **kw):
    """``to_int8_inference`` with the upsamples on K5
    (``ptq.deploy.upsample_serving``), as every serving path of the port
    runs them, so the inferencers built here serve the missions' graph."""
    from efficientq_tpu_torch.ptq.deploy import (to_int8_inference,
                                                 upsample_serving)

    g, v = to_int8_inference(graph, variables, **kw)
    return upsample_serving(g), v


def build_net(seed: int):
    """BraTS W4A4 preset, BN folded, post-PTQ weights emulated, exported
    as an int8 checkpoint, reloaded and deployed.  Returns the deployed
    graph, its ``GraphModule`` and the reloaded (folded, undeployed) graph
    and variables on the CPU."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.kernels.build import BUILD_DIR
    from efficientq_tpu_torch.models import build_uresq, preset_config
    from efficientq_tpu_torch.models import torch_io
    from efficientq_tpu_torch.ptq import fold_bn
    from efficientq_tpu_torch.quant import pack_int_weight

    cfg = preset_config("brats", quantize=True)
    graph = build_uresq(cfg)
    fgraph, fvars = post_ptq_weights(graph, seed)
    # the PTQ export format: packed integer weight codes in an npz
    sd = torch_io.to_torch_state_dict(fgraph, fvars)
    for node in fgraph.qconv_nodes():
        if node.attrs["qcfg"].q_weight:
            sd[f"{node.name}.weight"] = pack_int_weight(
                sd[f"{node.name}.weight"], sd[f"{node.name}.alpha_w"],
                node.attrs["qcfg"].qlvl_w)
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "smoke_state_in_int8_compress.npz")
    np.savez_compressed(path, state_dict=sd)
    # overwritten by the export
    fresh = nnir.init(graph, seed + 1, device="cpu")
    _, fresh = fold_bn(graph, fresh)
    lvars = torch_io.load_int8_checkpoint(fgraph, fresh, path)
    os.remove(path)
    dgraph, dvars = deploy_served(fgraph, lvars)
    n_k1 = sum(1 for n in dgraph.nodes if n.attrs.get("pallas"))
    n_int8 = sum(1 for n in dgraph.nodes if n.attrs.get("int8"))
    print(f"[phase2] BraTS W4A4 preset: {n_int8} convs on the int8 path, "
          f"{n_k1} on K1", flush=True)
    check(n_k1 == 14, f"expected 14 K1 convs, got {n_k1}")
    return (dgraph, nnir.GraphModule(dgraph, dvars, mode="quantized"),
            (fgraph, lvars))


def phase2(seed: int):
    from efficientq_tpu_torch.data.labels import split_label_brats
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.data.synthetic import make_subject
    from efficientq_tpu_torch.eval.metrics import dice
    from efficientq_tpu_torch.eval.sliding import (make_volume_inferencer,
                                                   patch_grid)
    from efficientq_tpu_torch.kernels import qconv3d as K
    from efficientq_tpu_torch.kernels import upsample as K5

    dev = torch.device("cuda")
    dgraph, net, folded = build_net(seed)
    net = net.to(dev)
    variables = net.variables

    t0 = time.perf_counter()
    subjects = [make_subject(np.random.default_rng(seed + 100 + i), "brats",
                             VOL_SHAPE) for i in range(3)]
    vols = [torch.from_numpy(np.stack(list(img.values()), axis=-1)[None])
            for img, _ in subjects]
    print(f"[phase2] 3 synthetic BraTS volumes {VOL_SHAPE} x 4 modalities "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)

    n_patches = len(patch_grid(VOL_SHAPE, PATCH, OVERLAP))
    forwards = -(-n_patches // 2)
    kw = dict(patch_batch=2, mode="quantized", heads=slice(-1, None),
              hard_pred=True, multilabel=True)
    infer = make_volume_inferencer(dgraph, capture=False, **kw)
    preds, secs = [], []
    torch.cuda.synchronize()
    K.qconv3x3_int8_ndhwc.launches = 0
    K5.upsample_trilinear3d.launches = 0
    for vol in vols:
        t0 = time.perf_counter()
        pred = infer(variables, vol.to(dev), PATCH, OVERLAP)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        preds.append(pred)
    launches = K.qconv3x3_int8_ndhwc.launches
    k5 = K5.upsample_trilinear3d.launches
    # the final head's upsamples, each on K5 (ptq.deploy.upsample_serving)
    n_up = sum(1 for name in nnir.live_nodes(dgraph, dgraph.outputs[-1:])
               if dgraph.node(name).op == "upsample_k5")
    print(f"[phase2] K1 launches {launches}, K5 launches {k5} over "
          f"{3 * forwards} patch-batch forwards ({n_patches} patches per "
          f"volume, batch 2)", flush=True)
    check(launches == 14 * 3 * forwards,
          f"K1 launched {launches} times, expected {14 * 3 * forwards}")
    check(n_up > 0 and k5 == n_up * 3 * forwards,
          f"K5 launched {k5} times, expected {n_up * 3 * forwards}")
    vps = 2 / (secs[1] + secs[2])
    print(f"[phase2] seconds per volume {[round(s, 4) for s in secs]}; "
          f"volumes/s over volumes 2-3: {vps:.4f}", flush=True)

    for i, (pred, (_, label)) in enumerate(zip(preds, subjects)):
        check(tuple(pred.shape) == (1, 1, *VOL_SHAPE, 3)
              and pred.dtype == torch.uint8 and int(pred.max()) <= 1,
              f"volume {i + 1}: prediction {tuple(pred.shape)} {pred.dtype}")
        p = pred[0, 0].cpu().numpy()
        target = split_label_brats(label)
        d = [dice(p[..., c], target[c]) for c in range(3)]
        check(all(np.isfinite(d)), f"volume {i + 1}: Dice {d}")
        print(f"[phase2] volume {i + 1} Dice WT/TC/ET vs synthetic labels: "
              f"{[round(x, 6) for x in d]}", flush=True)

    # the same serving run with the plain K1 on the card (launches no K1)
    plain = make_volume_inferencer(
        dgraph, kernels=plain_direct(), capture=False, **kw)
    ref = plain(variables, vols[0].to(dev), PATCH, OVERLAP)
    same = int((ref == preds[0]).sum())
    frac = same / ref.numel()
    print(f"[phase2] volume 1, K1 and K5 vs their plain versions: {same} of "
          f"{ref.numel()} "
          f"voxel-classes agree ({frac:.8f})", flush=True)
    check(frac >= AGREE_MIN, f"agreement {frac} < {AGREE_MIN}")

    # logits of one patch batch are finite and of the expected shape
    with torch.inference_mode():
        x = vols[0][:, :PATCH[0], :PATCH[1], :PATCH[2]].to(dev)
        logits = net(x.expand(2, -1, -1, -1, -1).contiguous(),
                     heads=slice(-1, None))
    check(tuple(logits.shape) == (1, 2, *PATCH, 3)
          and bool(torch.isfinite(logits).all()),
          f"logits {tuple(logits.shape)} not finite")
    return launches, dict(dgraph=dgraph, net=net, vols=vols,
                          subjects=subjects, infer=infer, preds=preds,
                          folded=folded, vps={"phase 2": vps}, k5=k5)


def _bound(nbytes: float, ops: float, peak: float):
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _k1_cost(n, s, c, kw, out_bytes, res_bytes):
    """Bytes that one K1 call must move (codes in, weights, residual,
    outputs, each once) and its int8 operations, C = O = c."""
    vox = n * s ** 3
    nbytes = vox * c + 27 * c * c + 8 * c
    nbytes += vox * c * (1 if kw.get("quant_qlvl") else out_bytes)
    if kw.get("residual") is not None:
        nbytes += vox * c * res_bytes
    if kw.get("pool"):
        nbytes += n * (s // 2) ** 3 * c * out_bytes
    return nbytes, 2 * vox * 27 * c * c


def _check_stem(label, y, q, yr, qr, alpha, qlvl):
    """K2 against its plain version at the module's tolerances; returns
    (max |difference| of y, int8 codes that differ at excused places)."""
    yf, rf = y.float(), yr.float()
    diff = (yf - rf).abs()
    err = float(diff.max())
    tol = 1e-4 * float(rf.abs().max())
    if y.dtype == torch.float32:
        check(err <= tol, f"K2 {label}: max |diff| {err} > {tol}")
        apart = torch.zeros_like(q, dtype=torch.bool)
    else:  # bfloat16: adjacent bit patterns (the values are >= 0), or
        # both within the float32 tolerance of a value that small (the
        # relu boundary, where one ulp is tiny)
        ulps = (y.view(torch.int16).int() - yr.view(torch.int16).int()).abs()
        far = (ulps > 1) & (diff > tol)
        check(not bool(far.any()), f"K2 {label}: {int(far.sum())} outputs "
              f"more than one bf16 ulp and {tol} apart")
        apart = ulps > 0
    pre = torch.clamp(rf / alpha, 0.0, 1.0) * (qlvl - 1)
    tie = ((pre - pre.floor()) - 0.5).abs() <= 1e-4
    qdiff = q != qr
    bad = int((qdiff & ~tie & ~apart).sum())
    check(bad == 0, f"K2 {label}: {bad} int8 codes differ away from ties")
    return err, int(qdiff.sum())


def stem_inputs(gen, seed, vol_shape, c, o, patch, overlap):
    """K2's inputs on the card: the s2d patches of a random (vol_shape, c)
    volume on the standard grid (both z parities where the depth allows),
    their parities, the s2d weights of a random 3^3 kernel and a bias."""
    from efficientq_tpu_torch.eval.sliding import patch_grid
    from efficientq_tpu_torch.kernels import stem

    dev = torch.device("cuda")
    rng = np.random.RandomState(seed + o)
    vol = torch.randn(1, *vol_shape, c, device=dev, generator=gen)
    starts = patch_grid(vol_shape, patch, overlap)
    x, par = stem.extract_s2d_patches(vol, starts, patch)
    w3 = rng.randn(3, 3, 3, c, o).astype(np.float32) * 0.2
    we, wo = (torch.from_numpy(w).to(dev, torch.bfloat16)
              for w in stem.s2d_stem_weights(w3))
    bias = torch.from_numpy(rng.randn(o).astype(np.float32) * 0.1)
    return x, par, we, wo, bias.to(dev)


def k2_cost(x, o):
    """(bytes, multiply-adds) of one K2 call with bfloat16 output: the
    patches and both parities' weights read once, the bias, the bf16 and
    int8 outputs written once; 8 C8 multiply-adds per output."""
    b, d1, h, w, c8 = x.shape
    vox = b * (d1 - 1) * h * w
    return (x.numel() * 2 + 2 * 2 * 4 * c8 * o * 2 + o * 4 + vox * o * 3,
            vox * o * 8 * c8)


def k2_plan_line(x, o, out_bytes=2):
    from efficientq_tpu_torch.kernels import stem

    b, d1, h, w, c8 = x.shape
    p = stem._k2_plan(b, d1 - 1, h, w, c8, o, out_bytes=out_bytes)
    return (f"rows={p.rows} zc={p.zc} grid={p.grid} smem={p.smem} "
            f"threads={p.threads}")


def phase3(seed: int):
    """K2 and K1-bf16 against their plain versions; times and bounds."""
    import torch.nn.functional as F

    from efficientq_tpu_torch.eval.sliding import patch_grid
    from efficientq_tpu_torch.kernels import qconv3d as K
    from efficientq_tpu_torch.kernels import stem
    from efficientq_tpu_torch.quant import act_codes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    bf16 = torch.bfloat16
    out = {}

    # K2 at the flagship geometry and an odd small one
    k2_err, geos = 0.0, [
        ("flagship", VOL_SHAPE, 4, 32, PATCH, OVERLAP, 1.0),
        ("odd small", (23, 32, 32), 4, 8, (16, 16, 16), (4, 4, 4), 0.7)]
    for label, vol_shape, c, o, patch, overlap, alpha in geos:
        x, par, we, wo, bias = stem_inputs(gen, seed, vol_shape, c, o, patch,
                                           overlap)
        check(0 < int(par.sum()) < par.numel(),
              f"K2 {label}: parities {par.tolist()} are not mixed")
        for dt in (torch.float32, bf16):
            args = (x, par, we, wo, bias, alpha, 4)
            y, q = stem.stem_s2d_conv(*args, out_dtype=dt)
            yr, qr = stem.stem_s2d_conv_reference(*args, out_dtype=dt)
            torch.cuda.synchronize()
            err, excused = _check_stem(f"{label} {dt}", y, q, yr, qr, alpha,
                                       4)
            k2_err = max(k2_err, err)
            print(f"[phase3] K2 {label} B={x.shape[0]} {tuple(x.shape[1:])}"
                  f" -> {o}, parities {par.tolist()}, out {dt}: max |diff| "
                  f"{err:.3e} (max |y| {float(yr.float().abs().max()):.4f}),"
                  f" int8 codes differing at ties or rounding: {excused} "
                  f"of {q.numel()}", flush=True)
            del y, q, yr, qr
        if label == "flagship":
            # as the serving path calls it: alpha on the card, the weights
            # packed at deploy time
            at = torch.tensor(alpha, device=dev)
            wp = stem.pack_stem_weights(we, wo)
            args = (x, par, we, wo, bias, at, 4)

            def k2():
                return stem.stem_s2d_conv(*args, out_dtype=bf16, w_packed=wp)

            rounds = [_median_ms(k2) for _ in range(ROUNDS)]
            tk = statistics.median(rounds)
            gk = _graph_ms(k2)
            tp = _median_ms(lambda: stem.stem_s2d_conv_reference(
                *args, out_dtype=bf16))
            # the nearest library call: cuDNN's bf16 stride-2 conv with
            # bias on the 8 raw (not s2d) 128^3 x 4 patches
            xl = torch.randn(x.shape[0], *PATCH, c, device=dev,
                             generator=gen).to(bf16).permute(0, 4, 1, 2, 3)
            wl = torch.randn(o, c, 3, 3, 3, device=dev, generator=gen,
                             dtype=bf16)
            bl = torch.randn(o, device=dev, generator=gen, dtype=bf16)
            def cudnn():
                return F.conv3d(xl, wl, bl, stride=2, padding=1)

            tl = _median_ms(cudnn)
            gl = _graph_ms(cudnn)
            nbytes, macs = k2_cost(x, o)
            bound, by = _bound(nbytes, 2 * macs, BF16_OPS)
            print(f"[phase3] K2 flagship, bf16 out: K2 {tk:.4f} ms per call "
                  f"(over {ROUNDS} rounds min / median / max "
                  f"{min(rounds):.4f} / {tk:.4f} / {max(rounds):.4f}), "
                  f"device {gk:.4f} ms ({bound / gk:.1%} of the bound)  "
                  f"plain {tp:.4f} ms  cuDNN bf16 stride-2 conv + bias on "
                  f"{tuple(xl.shape)} {tl:.4f} ms, device {gl:.4f} ms  bound "
                  f"{bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
                  f"{macs / 1e9:.2f} G multiply-adds); plan "
                  f"{k2_plan_line(x, o)}", flush=True)
            out["k2"] = dict(max_abs_err=k2_err, ms=tk, plain_ms=tp,
                             bound_ms=bound, bound_by=by, library_ms=tl,
                             graph_ms=gk, graph_library_ms=gl,
                             rounds_min_ms=min(rounds),
                             rounds_max_ms=max(rounds))
            del wp, xl, wl, bl
        del x, par, we, wo, bias
    out["k2"]["max_abs_err"] = k2_err
    torch.cuda.empty_cache()

    # K1 with bf16 output and residual at the s2d path's batch (the whole
    # grid): equal to the plain version at every flagship shape and
    # epilogue; times, library calls and bounds of one forward's 14 convs
    # at bfloat16 (the s2d path) and float32 (the same convs, f32 out)
    n = len(patch_grid(VOL_SHAPE, PATCH, OVERLAP))
    one = torch.tensor(1.0, device=dev)
    k1_err, checked = 0.0, 0
    tot = dict(bf16=0.0, f32=0.0, plain=0.0, library=0.0, bound=0.0,
               bound_f32=0.0, t_bytes=0.0, t_ops=0.0, graph_bf16=0.0,
               graph_library=0.0)
    for i, (s, c) in enumerate(STAGES):
        encoder = i < len(STAGES) // 2
        x = torch.randn(n, s, s, s, c, device=dev, generator=gen)
        w = (2 * torch.randint(0, 4, (3, 3, 3, c, c), device=dev,
                               generator=gen) - 3).to(torch.int8)
        b = torch.randn(c, device=dev, generator=gen)
        scale = torch.tensor(0.05, device=dev)
        res = torch.randn(n, s, s, s, c, device=dev, generator=gen).to(bf16)
        qa = act_codes(x, one, 4)
        variants = {
            "none": (x.to(bf16), {}),
            "block1 (quant)": (x.to(bf16), dict(quant_alpha=one,
                                                quant_qlvl=4)),
            "block2 (codes+residual+relu" + ("+pool)" if encoder else ")"):
                (qa, dict(x_quantized=True, residual=res, residual_relu=True,
                          pool=encoder)),
        }
        for name, (xin, kw) in variants.items():
            for dil in ((1, 2) if i < 4 else (1,)):
                a = (xin, w, b, one, scale, 4)
                got = K.qconv3x3_int8_ndhwc(*a, dilation=dil, out_dtype=bf16,
                                            **kw)
                ref = K.qconv3x3_int8_ndhwc_reference(
                    *a, dilation=dil, out_dtype=bf16, **kw)
                torch.cuda.synchronize()
                for g, r in zip(got if isinstance(got, tuple) else (got,),
                                ref if isinstance(ref, tuple) else (ref,)):
                    k1_err = max(k1_err, float((g.float() - r.float()).abs()
                                               .max()))
                    check(g.dtype == r.dtype and torch.equal(g, r),
                          f"K1 bf16 != plain at stage{i + 1} {s}^3x{c} "
                          f"{name} dil={dil}")
                checked += 1
                del got, ref
        for name, (xin, kw) in list(variants.items())[1:]:
            kwq = dict(kw, x_quantized=True)  # time the conv, not the prologue
            kw32 = dict(kwq, residual=kwq["residual"].float()
                        if "residual" in kwq else None)
            a = (qa, w, b, one, scale, 4)
            tk = _median_ms(lambda: K.qconv3x3_int8_ndhwc(
                *a, out_dtype=bf16, **kwq))
            t32 = _median_ms(lambda: K.qconv3x3_int8_ndhwc(*a, **kw32))
            tp = _median_ms(lambda: K.qconv3x3_int8_ndhwc_reference(
                *a, out_dtype=bf16, **kwq))
            xl = qa.to(bf16).permute(0, 4, 1, 2, 3)
            wl = w.to(bf16).permute(4, 3, 0, 1, 2)
            tl = _median_ms(lambda: F.conv3d(xl, wl, padding=1))
            # device time alone, free of the host's time per call
            gk = _graph_ms(lambda: K.qconv3x3_int8_ndhwc(
                *a, out_dtype=bf16, **kwq))
            gl = _graph_ms(lambda: F.conv3d(xl, wl, padding=1))
            tot["graph_bf16"] += gk
            tot["graph_library"] += gl
            cost16 = _k1_cost(n, s, c, kw, 2, 2)
            bound, by16 = _bound(*cost16, INT8_OPS)
            tot["bf16"] += tk
            tot["f32"] += t32
            tot["plain"] += tp
            tot["library"] += tl
            tot["bound"] += bound
            tot["bound_f32"] += _bound(*_k1_cost(n, s, c, kw, 4, 4),
                                       INT8_OPS)[0]
            tot["t_bytes"] += cost16[0] / HBM_BPS
            tot["t_ops"] += cost16[1] / INT8_OPS
            plan = K._tile_plan(n, s, s, s, c, c, 1)
            print(f"[phase3] stage{i + 1} N={n} {s}^3 C=O={c} {name}: K1 "
                  f"bf16 out {tk:.4f} ms ({cost16[1] / tk / 1e9:.1f} TOP/s, "
                  f"{bound / tk:.1%} of the bound)  f32 out {t32:.4f} ms  "
                  f"plain (bf16) {tp:.4f} ms  cuDNN bf16 conv of the codes "
                  f"{tl:.4f} ms (K1 / cuDNN {tk / tl:.2f})  bound (bf16) "
                  f"{bound:.4f} ms ({by16}: {cost16[0] / 1e6:.1f} MB, "
                  f"{cost16[1] / 1e9:.1f} G int8 operations)  tiles: brick "
                  f"{plan.brick}, grid {plan.grid}, "
                  f"{plan.smem} B shared, {plan.sums} sums buffers",
                  flush=True)
            print(f"[phase3]   device time (CUDA graph replay): K1 bf16 out "
                  f"{gk:.4f} ms ({cost16[1] / gk / 1e9:.1f} TOP/s, "
                  f"{bound / gk:.1%} of the bound)  cuDNN {gl:.4f} ms (K1 / "
                  f"cuDNN {gk / gl:.2f})", flush=True)
            del xl, wl
        del x, w, res, qa, variants
        torch.cuda.empty_cache()
    print(f"[phase3] {checked} comparisons at N={n}: K1 bf16 out/residual == "
          f"plain (torch.equal) everywhere; one forward's 14 convs: K1 bf16 "
          f"{tot['bf16']:.4f} ms, K1 f32 {tot['f32']:.4f} ms, plain "
          f"{tot['plain']:.4f} ms, cuDNN bf16 conv of the codes (no "
          f"epilogue) {tot['library']:.4f} ms (K1 / cuDNN "
          f"{tot['bf16'] / tot['library']:.2f}), bound {tot['bound']:.4f} ms "
          f"({tot['bound'] / tot['bf16']:.1%} reached; f32 out: "
          f"{tot['bound_f32']:.4f} ms); device time alone (CUDA graph "
          f"replay): K1 {tot['graph_bf16']:.4f} ms, cuDNN "
          f"{tot['graph_library']:.4f} ms (K1 / cuDNN "
          f"{tot['graph_bf16'] / tot['graph_library']:.2f}, "
          f"{tot['bound'] / tot['graph_bf16']:.1%} of the bound)", flush=True)
    out["k1"] = dict(max_abs_err=k1_err, ms=tot["bf16"],
                     plain_ms=tot["plain"], library_ms=tot["library"],
                     bound_ms=tot["bound"],
                     bound_by=("bytes" if tot["t_bytes"] >= tot["t_ops"]
                               else "operations"),
                     f32_ms=tot["f32"], f32_bound_ms=tot["bound_f32"],
                     graph_ms=tot["graph_bf16"],
                     graph_library_ms=tot["graph_library"])
    torch.cuda.empty_cache()
    return out


def phase4(seed: int, served):
    """The s2d bf16 serving slice, run eagerly (``capture=False``: the
    baseline of phase 11 (a)'s captured path, and the plain K2 and the
    printing hooks read the card from the host), checked against the
    direct bf16 path and the plain kernels; returns (K1 launches, K2
    launches, inferencer, predictions)."""
    from efficientq_tpu_torch.data.labels import split_label_brats
    from efficientq_tpu_torch.eval.metrics import dice
    from efficientq_tpu_torch.eval.sliding import (make_volume_inferencer,
                                                   patch_grid)
    from efficientq_tpu_torch.kernels import qconv3d as K
    from efficientq_tpu_torch.kernels import stem
    from efficientq_tpu_torch.ptq.deploy import make_s2d_volume_inferencer

    dev = torch.device("cuda")
    dgraph, variables = served["dgraph"], served["net"].variables
    vols = [v.numpy() for v in served["vols"]]
    starts = patch_grid(VOL_SHAPE, PATCH, OVERLAP)
    forwards = 1  # patch batch "auto": the whole grid in one forward
    kw = dict(multilabel=True, heads=slice(-1, None), device=dev,
              capture=False)
    infer = make_s2d_volume_inferencer(dgraph, variables, **kw)
    check(infer is not None, "no eligible s2d stem in the deployed graph")

    # the s2d transform: on the host before the upload, or on the card
    # after it (the inferencer's choice); bits must be equal
    need = stem.s2d_need_planes(starts, PATCH)
    img = served["vols"][0]

    def on_host():
        return stem.s2d_volume(img, need).to(dev)

    def on_card():
        return stem.s2d_volume(img.to(dev), need)

    check(torch.equal(on_host().view(torch.int16),
                      on_card().view(torch.int16)),
          "s2d on the host and on the card differ")
    times = {"host": [], "card": []}
    for fn, key in [(on_host, "host"), (on_card, "card")] * 3 + [
            (on_card, "card"), (on_host, "host")] * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[key].append((time.perf_counter() - t0) * 1e3)
    print(f"[phase4] s2d transform of one volume incl. its upload (median "
          f"of 5, ms): on the host then upload bf16 "
          f"{statistics.median(times['host']):.4f}, upload f32 then on the "
          f"card {statistics.median(times['card']):.4f} (the inferencer's)",
          flush=True)

    preds, secs = [], []
    torch.cuda.synchronize()
    K.qconv3x3_int8_ndhwc.launches = 0
    stem.stem_s2d_conv.launches = 0
    for vol in vols:
        t0 = time.perf_counter()
        pred = infer(None, vol, PATCH, OVERLAP)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        preds.append(pred)
    k1, k2 = K.qconv3x3_int8_ndhwc.launches, stem.stem_s2d_conv.launches
    print(f"[phase4] K2 launches {k2}, K1 launches {k1} over {3 * forwards} "
          f"patch-batch forwards ({len(starts)} patches per volume, batch "
          f"{len(starts)})", flush=True)
    check(k2 == 3 * forwards, f"K2 launched {k2} times, expected "
          f"{3 * forwards}")
    check(k1 == 14 * 3 * forwards, f"K1 launched {k1} times, expected "
          f"{14 * 3 * forwards}")
    vps = 2 / (secs[1] + secs[2])
    served["vps"]["phase 4"] = vps
    print(f"[phase4] seconds per volume {[round(x, 4) for x in secs]}; "
          f"volumes/s over volumes 2-3: {vps:.4f}", flush=True)

    for i, (pred, (_, label)) in enumerate(zip(preds, served["subjects"])):
        check(tuple(pred.shape) == (1, 1, *VOL_SHAPE, 3)
              and pred.dtype == torch.uint8 and int(pred.max()) <= 1,
              f"volume {i + 1}: prediction {tuple(pred.shape)} {pred.dtype}")
        p = pred[0, 0].cpu().numpy()
        target = split_label_brats(label)
        d = [dice(p[..., c], target[c]) for c in range(3)]
        check(all(np.isfinite(d)), f"volume {i + 1}: Dice {d}")
        print(f"[phase4] volume {i + 1} Dice WT/TC/ET vs synthetic labels: "
              f"{[round(x, 6) for x in d]}", flush=True)

    direct = make_volume_inferencer(
        dgraph, patch_batch=len(starts), mode="quantized",
        heads=slice(-1, None), hard_pred=True, multilabel=True,
        compute_dtype=torch.bfloat16, capture=False)(
        variables, served["vols"][0].to(dev), PATCH, OVERLAP)
    plain_k1 = make_s2d_volume_inferencer(
        dgraph, variables, kernels=kernels_with(
            conv3x3_int8=K.qconv3x3_int8_ndhwc_reference),
        **kw)(None, vols[0], PATCH, OVERLAP)
    plain = make_s2d_volume_inferencer(
        dgraph, variables, kernels=plain_s2d(), **kw)(
        None, vols[0], PATCH, OVERLAP)
    f32 = served["infer"](variables, served["vols"][0].to(dev), PATCH,
                          OVERLAP)
    agree = {}
    for what, ref in (("the direct bf16 path (cuDNN stem)", direct),
                      ("the s2d path on the plain K1", plain_k1),
                      ("the s2d path on the plain K2 and K1", plain),
                      ("phase 2's int8 float32 path", f32)):
        agree[what] = float((ref == preds[0]).float().mean())
        print(f"[phase4] volume 1 agrees with {what} on "
              f"{agree[what]:.8f} of {ref.numel()} voxel-classes",
              flush=True)
    check(agree["the direct bf16 path (cuDNN stem)"] >= AGREE_S2D,
          "s2d path vs the direct bf16 path")
    check(torch.equal(plain_k1, preds[0]), "s2d path: K1 vs plain K1")

    # The plain K2 sums in float64, K2 on the tensor cores in float32: a
    # few bf16 stem outputs round apart, and a code can sit on a .5 tie.
    # Which of the two moves the hard predictions: the K2 path with the
    # plain stem's codes, and with the plain stem's activation.
    def mixed(plain_codes):
        def stem_conv(*a, **k):
            y, q = stem.stem_s2d_conv(*a, **k)
            yp, qp = stem.stem_s2d_conv_reference(*a, **k)
            n_apart = (int((y != yp).sum()), int((q != qp).sum()))
            print(f"[phase4]   K2 and its plain version round apart on "
                  f"{n_apart[0]} bf16 stem outputs and {n_apart[1]} int8 "
                  f"codes of this batch", flush=True)
            return (y, qp) if plain_codes else (yp, q)
        return stem_conv

    for plain_codes in (True, False):
        got = make_s2d_volume_inferencer(
            dgraph, variables,
            kernels=kernels_with(stem_conv=mixed(plain_codes)), **kw)(
            None, vols[0], PATCH, OVERLAP)
        print(f"[phase4] K2 path with the plain stem's "
              f"{'int8 codes' if plain_codes else 'bf16 activation'}: "
              f"agrees with the K2 path on "
              f"{float((got == preds[0]).float().mean()):.8f}, with the "
              f"plain path on {float((got == plain).float().mean()):.8f}",
              flush=True)
        if plain_codes:  # the rest of the path is exact
            check(torch.equal(got, plain), "K2 path with the plain stem's "
                  "codes != the plain path")
    check(agree["the s2d path on the plain K2 and K1"] >= AGREE_PLAIN_S2D,
          "s2d path vs the plain K2 and K1")
    return k1, k2, infer, preds


def _int_mm_call(qa, codes):
    """A call of ``torch._int_mm`` (cuBLASLt int8 GEMM, int32 out) on the
    codes, or None where this build refuses the shape or layout."""
    for b in (codes, codes.t().contiguous().t()):
        try:
            torch._int_mm(qa, b)
        except RuntimeError as e:
            err = str(e).splitlines()[0]
            continue
        return lambda: torch._int_mm(qa, b)
    print(f"[phase5]   torch._int_mm refused {tuple(qa.shape)} x "
          f"{tuple(codes.shape)}: {err}", flush=True)
    return None


def _plan_line(key, m, k, n, bf16):
    """The plan of K3 or K4 at one shape, as printed."""
    from efficientq_tpu_torch.kernels import qmatmul as KM

    if key == "k3":
        p = KM._k3_plan(m, k, n, bf16)
        return (f"bm={p.bm} nc={p.nc} mt={p.mt} nt={p.nt} wn={p.wn} "
                f"stages={p.stages} grid={p.grid} smem={p.smem}")
    p = KM._k4_plan(m, k, n, bf16)
    return f"nc={p.nc} rn={p.rn} bm={p.bm} grid={p.grid} smem={p.smem}"


def phase5(seed: int):
    """K3 and K4 against their plain versions at the six flagship 1x1
    shapes; times, library calls and bounds.  Returns, per kernel, the
    numbers of one B = 8 bfloat16 forward's six convs (the s2d path's)
    with the B = 2 float32 forward's beside them."""
    from efficientq_tpu_torch.kernels import qmatmul as KM
    from efficientq_tpu_torch.quant import act_codes, fake_quant_act

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    alpha = torch.tensor(1.0, device=dev)
    out = {}
    for batch, dt in ((N_BATCH, torch.float32), (S2D_BATCH, torch.bfloat16)):
        tot = {key: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                         t_bytes=0.0, t_ops=0.0, max_abs_err=0.0,
                         graph_ms=0.0, graph_library_ms=0.0,
                         rounds=[0.0] * ROUNDS)
               for key in ("k3", "k4")}
        for name, per_patch, k, n in ONE_BY_ONE:
            m = per_patch * batch
            x = (torch.randn(m, k, device=dev, generator=gen) * 0.7).to(dt)
            codes = (2 * torch.randint(0, 4, (k, n), device=dev,
                                       generator=gen) - 3).to(torch.int8)
            wp = KM.pack_weights_1x1(codes)  # as the deployment packs it
            w = torch.randn(k, n, device=dev, generator=gen) * 0.1
            b = torch.randn(n, device=dev, generator=gen)
            scales = {"per-tensor": torch.tensor(0.05, device=dev),
                      "per-channel": torch.rand(n, device=dev,
                                                generator=gen) * 0.05}
            for kind, sc in scales.items():
                args = (x, codes, b, alpha, sc, 4, wp)
                got = KM.fused_int8_matmul(*args)
                ref = KM.fused_int8_matmul_reference(*args)
                torch.cuda.synchronize()
                check(torch.equal(got, ref), f"K3 != plain at {name} B={batch}"
                      f" {dt} {kind}: max |diff| "
                      f"{float((got - ref).abs().max())}")
            args4 = (x, w, b, alpha, 4)
            got = KM.fused_qact_matmul(*args4)
            ref = KM.fused_qact_matmul_reference(*args4)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = 1e-5 * float(ref.abs().max())
            check(err <= tol, f"K4 at {name} B={batch} {dt}: max |diff| {err}"
                  f" > {tol}")
            tot["k4"]["max_abs_err"] = max(tot["k4"]["max_abs_err"], err)
            del got, ref
            args = (x, codes, b, alpha, scales["per-tensor"], 4, wp)
            qa = act_codes(x, alpha, 4)
            xq = fake_quant_act(x, alpha, 4)
            xbytes = x.element_size() * m * k
            # per kernel: (kernel, plain version, library call or None,
            # bound); per call in ROUNDS rounds (the same-card spread),
            # and kernel and library call as device time alone (CUDA
            # graph replay)
            calls = {
                "k3": (lambda: KM.fused_int8_matmul(*args),
                       lambda: KM.fused_int8_matmul_reference(*args),
                       _int_mm_call(qa, codes),
                       _bound(xbytes + k * n + 8 * n + 4 * m * n,
                              2 * m * k * n, INT8_OPS)),
                "k4": (lambda: KM.fused_qact_matmul(*args4),
                       lambda: KM.fused_qact_matmul_reference(*args4),
                       lambda: torch.addmm(b, xq, w),
                       _bound(xbytes + 4 * k * n + 4 * n + 4 * m * n,
                              2 * m * k * n, FP32_OPS))}
            for key, (fn, plain, lib, (bound, by)) in calls.items():
                t = tot[key]
                rounds = [_median_ms(fn) for _ in range(ROUNDS)]
                tk = statistics.median(rounds)
                tp = _median_ms(plain)
                tl = None if lib is None else _median_ms(lib)
                gk = _graph_ms(fn)
                gl = None if lib is None else _graph_ms(lib)
                t["ms"] += tk
                t["plain_ms"] += tp
                for r, ms in enumerate(rounds):
                    t["rounds"][r] += ms
                for field, v in (("library_ms", tl), ("graph_library_ms", gl)):
                    t[field] = (None if v is None or t[field] is None
                                else t[field] + v)
                t["graph_ms"] += gk
                t["bound_ms"] += bound
                peak = INT8_OPS if key == "k3" else FP32_OPS
                t["t_bytes"] += (bound if by == "bytes" else 0.0)
                t["t_ops"] += (bound if by == "operations" else 0.0)
                lib_name = "_int_mm" if key == "k3" else "addmm"
                lib_s = ("n/a" if tl is None else
                         f"{tl:.4f} ms, device {gl:.4f} ms (host per call "
                         f"{tl - gl:.4f} ms)")
                print(f"[phase5] {key.upper()} {name} B={batch} {dt} M={m} "
                      f"K={k} N={n}: kernel {tk:.4f} ms  plain {tp:.4f} ms  "
                      f"library {lib_s}  bound {bound:.4f} ms ({by}; peak "
                      f"{peak / 1e12:.0f} T/s)", flush=True)
                print(f"[phase5]   {key.upper()} per call over {ROUNDS} "
                      f"rounds min / median / max {min(rounds):.4f} / "
                      f"{tk:.4f} / {max(rounds):.4f} ms; device time (CUDA "
                      f"graph replay) {gk:.4f} ms ({bound / gk:.1%} of the "
                      f"bound; {lib_name} "
                      f"{'n/a' if gl is None else f'{gl:.4f} ms'}); host per "
                      f"call (per call - device) {tk - gk:.4f} ms; plan "
                      f"{_plan_line(key, m, k, n, dt == torch.bfloat16)}",
                      flush=True)
            del x, qa, xq, wp
        for key in ("k3", "k4"):
            t = tot[key]
            t["bound_by"] = ("bytes" if t.pop("t_bytes") >= t.pop("t_ops")
                             else "operations")
            rounds = t.pop("rounds")
            t.update(rounds_min_ms=min(rounds), rounds_max_ms=max(rounds))
            lib_name = "_int_mm" if key == "k3" else "addmm"
            lib = ("n/a" if t["library_ms"] is None else
                   f"{t['library_ms']:.4f} ms, device "
                   f"{t['graph_library_ms']:.4f} ms, host per call "
                   f"{t['library_ms'] - t['graph_library_ms']:.4f} ms")
            print(f"[phase5] {key.upper()} one forward's six 1x1 convs at "
                  f"B={batch} {dt}: kernel {t['ms']:.4f} ms per call (over "
                  f"{ROUNDS} rounds min / median / max {min(rounds):.4f} / "
                  f"{statistics.median(rounds):.4f} / {max(rounds):.4f}), "
                  f"device {t['graph_ms']:.4f} ms "
                  f"({t['bound_ms'] / t['graph_ms']:.1%} of the bound), host "
                  f"per call "
                  f"{t['ms'] - t['graph_ms']:.4f} ms; plain "
                  f"{t['plain_ms']:.4f} ms; {lib_name} {lib}; bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}) (six calls)",
                  flush=True)
        out[batch] = tot
        torch.cuda.empty_cache()
    print(f"[phase5] K3 == plain (torch.equal) at every shape, both scales; "
          f"K4 max |diff| {out[S2D_BATCH]['k4']['max_abs_err']:.3e} (B=8), "
          f"{out[N_BATCH]['k4']['max_abs_err']:.3e} (B=2), within 1e-5 "
          f"max|y|", flush=True)
    result = {}
    for key in ("k3", "k4"):
        b8, b2 = out[S2D_BATCH][key], out[N_BATCH][key]
        result[key] = dict(b8, max_abs_err=max(b8["max_abs_err"],
                                               b2["max_abs_err"]),
                           n2_f32_ms=b2["ms"], n2_f32_plain_ms=b2["plain_ms"],
                           n2_f32_bound_ms=b2["bound_ms"],
                           n2_f32_graph_ms=b2["graph_ms"],
                           n2_f32_library_ms=b2["library_ms"],
                           n2_f32_graph_library_ms=b2["graph_library_ms"])
    return result


class _Launches:
    """Sets the kernels' launch counts to 0 on entry and reads them on
    exit, as {name: launches}."""

    def __init__(self):
        from efficientq_tpu_torch.kernels import qconv3d, qmatmul, stem

        self.fns = {"K1": qconv3d.qconv3x3_int8_ndhwc,
                    "K2": stem.stem_s2d_conv,
                    "K3": qmatmul.fused_int8_matmul,
                    "K4": qmatmul.fused_qact_matmul}
        self.counts = {}

    def __enter__(self):
        torch.cuda.synchronize()
        for fn in self.fns.values():
            fn.launches = 0
        return self

    def __exit__(self, *exc):
        self.counts = {k: fn.launches for k, fn in self.fns.items()}


def _serve(label, infer, vols, want):
    """Serves the volumes, checks the launches per forward against
    ``want`` ({kernel: launches per volume}), prints volumes/s; returns
    (predictions, launches)."""
    preds, secs = [], []
    with _Launches() as counted:
        for vol in vols:
            t0 = time.perf_counter()
            preds.append(infer(vol))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    got = counted.counts
    print(f"[phase6] {label}: launches {got} over {len(vols)} volumes; "
          f"seconds per volume {[round(x, 4) for x in secs]}; volumes/s over "
          f"volumes 2-3: {2 / (secs[1] + secs[2]):.4f}", flush=True)
    for name in got:
        n = want.get(name, 0) * len(vols)
        check(got[name] == n, f"{label}: {name} launched {got[name]} times, "
              f"expected {n}")
    return preds, got


def phase6(seed: int, served, s2d_preds):
    """The include_1x1 serving paths (a)-(d); returns the launches of each
    path and the inferencers of paths (b) and (c)."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.eval.sliding import (make_volume_inferencer,
                                                   patch_grid)
    from efficientq_tpu_torch.kernels import qmatmul as KM
    from efficientq_tpu_torch.models import build_uresq, preset_config
    from efficientq_tpu_torch.ptq import fold_bn
    from efficientq_tpu_torch.ptq.deploy import make_s2d_volume_inferencer
    from efficientq_tpu_torch.quant import act_codes

    dev = torch.device("cuda")
    variables = served["net"].variables
    host = [v.numpy() for v in served["vols"]]
    fw = -(-len(patch_grid(VOL_SHAPE, PATCH, OVERLAP)) // N_BATCH)
    launches = {}

    def flagged_1x1(g, int8):
        return sum(1 for n in g.nodes if n.attrs.get("pallas")
                   and n.attrs["kernel_size"] == (1, 1, 1)
                   and bool(n.attrs.get("int8")) == int8)

    # (a) int8 deployment + include_1x1, int8 float32 path
    pg = KM.to_pallas_inference(served["dgraph"], include_1x1=True)
    check(flagged_1x1(pg, True) == 6, "expected 6 int8 1x1 convs on K3")
    infer_a = make_volume_inferencer(
        pg, patch_batch=N_BATCH, mode="quantized", heads=slice(-1, None),
        hard_pred=True, multilabel=True, capture=False)
    preds, launches["a"] = _serve(
        "(a) int8 + include_1x1, int8 float32 path",
        lambda v: infer_a(variables, v.to(dev), PATCH, OVERLAP),
        served["vols"], {"K1": 14 * fw, "K3": 6 * fw})
    check(all(torch.equal(p, q) for p, q in zip(preds, served["preds"])),
          "(a): predictions differ from phase 2's")
    print("[phase6] (a) predictions equal phase 2's on all 3 volumes",
          flush=True)

    # (b) the same graph on the s2d bf16 path
    kw = dict(multilabel=True, heads=slice(-1, None), device=dev)
    infer_b = make_s2d_volume_inferencer(pg, variables, **kw)
    preds, launches["b"] = _serve(
        "(b) int8 + include_1x1, s2d bf16 path",
        lambda v: infer_b(None, v, PATCH, OVERLAP), host,
        {"K1": 14, "K2": 1, "K3": 6})
    check(all(torch.equal(p, q) for p, q in zip(preds, s2d_preds)),
          "(b): predictions differ from phase 4's")
    print("[phase6] (b) predictions equal phase 4's on all 3 volumes",
          flush=True)
    del infer_a
    torch.cuda.empty_cache()

    # (c) --deploy mixed + --serve_stem s2d + include_1x1
    fgraph, lvars = served["folded"]
    mg, mv = deploy_served(fgraph, lvars, only_kernel_sizes={(3, 3, 3)})
    mpg = KM.to_pallas_inference(mg, include_1x1=True)
    n_k1 = sum(1 for n in mpg.nodes if n.attrs.get("pallas")
               and n.attrs["kernel_size"] == (3, 3, 3))
    check(n_k1 == 14 and flagged_1x1(mpg, False) == 6
          and flagged_1x1(mpg, True) == 0,
          "mixed graph: expected 14 K1 and 6 float 1x1 convs on K4")
    infer_c = make_s2d_volume_inferencer(mpg, mv, **kw)
    preds, launches["c"] = _serve(
        "(c) mixed + s2d + include_1x1", lambda v: infer_c(None, v, PATCH,
                                                           OVERLAP),
        host, {"K1": 14, "K2": 1, "K4": 6})
    plain = make_s2d_volume_inferencer(
        mpg, mv,
        kernels=kernels_with(qact_matmul=KM.fused_qact_matmul_reference),
        capture=False, **kw)(None, host[0], PATCH, OVERLAP)
    agree = float((plain == preds[0]).float().mean())
    print(f"[phase6] (c) volume 1 agrees with the same path on the plain K4 "
          f"on {agree:.8f} of {plain.numel()} voxel-classes", flush=True)

    def compare(x, w, b, alpha, qlvl):
        y = KM.fused_qact_matmul(x, w, b, alpha, qlvl)
        yp = KM.fused_qact_matmul_reference(x, w, b, alpha, qlvl)
        # every act-quantized conv of this net has alpha_act = 1, 4 levels
        flips = int((act_codes(y, 1.0, 4) != act_codes(yp, 1.0, 4)).sum())
        print(f"[phase6]   K4 {tuple(x.shape)} x {tuple(w.shape)}: "
              f"{int((y != yp).sum())} of {y.numel()} outputs differ from "
              f"the plain K4 (max |diff| {float((y - yp).abs().max()):.3e}), "
              f"{flips} downstream codes flip", flush=True)
        return y

    # eager: compare reads the card from the host
    swapped = make_s2d_volume_inferencer(
        mpg, mv, kernels=kernels_with(qact_matmul=compare), capture=False,
        **kw)(None, host[0], PATCH, OVERLAP)
    check(torch.equal(swapped, preds[0]), "(c): the comparing run differs")
    no_1x1 = make_s2d_volume_inferencer(mg, mv, **kw)(None, host[0], PATCH,
                                                      OVERLAP)
    print(f"[phase6] (c) volume 1 agrees with the mixed s2d path without "
          f"include_1x1 (cuDNN bf16 1x1 convs) on "
          f"{float((no_1x1 == preds[0]).float().mean()):.8f} (printed, not "
          f"held: other numerics)", flush=True)
    check(agree >= AGREE_PLAIN_K4, f"(c): agreement {agree} with the plain K4"
          f" < {AGREE_PLAIN_K4}")
    del plain, swapped, no_1x1
    torch.cuda.empty_cache()

    # (d) fq mode: weights unprojected, quantized on the fly
    graph = build_uresq(preset_config("brats", quantize=True))
    qg, qv = fold_bn(graph, nnir.init(graph, seed, device="cpu"))
    for node in qg.qconv_nodes():
        p = qv["params"][node.name]
        if node.attrs["qcfg"].q_weight:
            p["alpha_w"] = torch.clamp_min(p["kernel"].abs().max(), 1e-8)
        if node.attrs["qcfg"].q_act:
            p["alpha_act"] = torch.tensor(1.0)
    fq_graph = KM.to_pallas_inference(qg, include_1x1=True)
    check(flagged_1x1(fq_graph, False) == 6, "fq graph: expected 6 K4 convs")
    fq_net = nnir.GraphModule(fq_graph, qv, mode="fq").to(dev)
    x = served["vols"][0][:, :PATCH[0], :PATCH[1], :PATCH[2]].to(dev)
    with torch.inference_mode():
        with _Launches() as counted:
            logits = fq_net(x, heads=slice(-1, None))
        ref = fq_net(x, heads=slice(-1, None), kernels=kernels_with(
            qact_matmul=KM.fused_qact_matmul_reference))
    launches["d"] = counted.counts
    check(counted.counts == {"K1": 0, "K2": 0, "K3": 0, "K4": 6},
          f"(d): launches {counted.counts}, expected 6 K4 only")
    check(tuple(logits.shape) == (1, 1, *PATCH, 3)
          and bool(torch.isfinite(logits).all()),
          f"(d): logits {tuple(logits.shape)} not finite")
    agree_d = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"[phase6] (d) fq mode, one 128^3 patch: launches "
          f"{counted.counts}; logits finite, max |logit - plain-K4 logit| "
          f"{float((logits - ref).abs().max()):.3e}, argmax agreement "
          f"{agree_d:.8f}", flush=True)
    check(agree_d >= AGREE_PLAIN_K4, f"(d): argmax agreement {agree_d} < "
          f"{AGREE_PLAIN_K4}")
    del fq_net, logits, ref
    torch.cuda.empty_cache()
    return launches, infer_b, infer_c


def _random_bn_state(variables, seed):
    """BN statistics drawn as tests/test_ptq_e2e.py draws them, so that
    folding is not the identity."""
    rng = np.random.RandomState(seed)
    for s in variables["state"].values():
        s["mean"] = torch.from_numpy(
            rng.randn(*s["mean"].shape).astype(np.float32) * 0.1)
        s["var"] = torch.from_numpy(
            (np.abs(rng.randn(*s["var"].shape)) * 0.2 + 0.9)
            .astype(np.float32))
    return variables


def calibration_crop(seed):
    """One synthetic BraTS volume (4 modalities), center-cropped by the
    calibration crop rule (each spatial extent capped at 192 and rounded
    down to a multiple of 64): (1, 128, 192, 192, 4) float32."""
    from efficientq_tpu_torch.data.synthetic import make_subject

    img, _ = make_subject(np.random.default_rng(seed + 300), "brats",
                          VOL_SHAPE)
    vol = np.stack(list(img.values()), axis=-1)
    crop = [min(e, 192) // 64 * 64 for e in VOL_SHAPE]
    lo = [(e - c) // 2 for e, c in zip(VOL_SHAPE, crop)]
    return np.ascontiguousarray(vol[lo[0]:lo[0] + crop[0],
                                    lo[1]:lo[1] + crop[1],
                                    lo[2]:lo[2] + crop[2]][None])


def flagship_for_ptq(seed):
    """The BraTS W4A4 preset at full width and depth, weights from
    ``seed``, BN state randomised: (graph, variables) on the CPU."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.models import build_uresq, preset_config

    graph = build_uresq(preset_config("brats", quantize=True))
    return graph, _random_bn_state(nnir.init(graph, seed, device="cpu"),
                                   seed)


def tiny_calibration(device):
    """run_ptq on the fixture of tests/test_ptq_e2e.py (the tiny W4A4 net,
    BN state randomised, 40 ADMM iterations) on ``device``."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.models import UResQConfig, build_uresq
    from efficientq_tpu_torch.ptq import PTQHyperParams, run_ptq

    cfg = UResQConfig(num_mod=2, num_classes=3, depth_config=[1, 1, 1],
                      width_config=[4, 8, 4], dilation_config=[1, 1, 1],
                      init_stride=(2, 2, 2), drop_rate=0.0, blk_type="mid",
                      ds="simple", ds_depth_limit=3, quantize=True, qlvl_w=4,
                      qlvl_act=4, q_first=(256, -1), q_last=(256, -1))
    graph = build_uresq(cfg)
    variables = _random_bn_state(nnir.init(graph, 0, device="cpu"), 0)
    x = np.random.RandomState(7).randn(1, 16, 16, 16, 2).astype(np.float32)
    return run_ptq(graph, variables, x, task="lits", init_stride=(2, 2, 2),
                   hp=PTQHyperParams(admm_iter=40), device=device)


def tiny_outcome(result):
    """What a tiny-fixture calibration decided: per layer its weight codes,
    reported loss, alpha_w and alpha_act, and the class voxel counts and
    argmax of the calibrated output, on the CPU."""
    fg, qv, rep = result
    out = {"nums": rep.class_voxel_nums,
           "argmax": rep.output_q[-1].argmax(-1).cpu(), "layers": {}}
    for name, loss in rep.layer_losses:
        q = fg.node(name).attrs["qcfg"]
        p = qv["params"][name]
        out["layers"][name] = dict(
            codes=_grid_codes(p["kernel"].cpu(), float(p["alpha_w"]),
                              q.qlvl_w)[0],
            loss=loss, alpha_w=float(p["alpha_w"]),
            alpha_act=float(p["alpha_act"]) if q.q_act else None)
    return out


def outcome_gaps(a, b):
    """(share of equal weight codes, largest relative gaps {loss, alpha_w,
    alpha_act}, argmax agreement, class counts equal) of two outcomes."""
    same = total = 0
    gaps = {"loss": 0.0, "alpha_w": 0.0, "alpha_act": 0.0}
    for name, la in a["layers"].items():
        lb = b["layers"][name]
        same += int((la["codes"] == lb["codes"]).sum())
        total += la["codes"].numel()
        for k in gaps:
            if la[k] is not None:
                gaps[k] = max(gaps[k], abs(la[k] / lb[k] - 1))
    argmax = float((a["argmax"] == b["argmax"]).float().mean())
    return same / total, gaps, argmax, a["nums"] == b["nums"]


def within_cpu_tolerances(share, gaps, argmax, nums_equal):
    """The tolerances tests/test_torch_port_ptq.py holds the CPU to against
    JAX."""
    return (nums_equal and share >= 0.99 and gaps["loss"] <= 1e-2
            and gaps["alpha_act"] <= 1e-5 and argmax >= 0.99)


def perturbed_grams(seed):
    """A ``compute_gram_stats`` whose A_att and B_att are scaled element
    by element by 1 + 1e-7 N(0, 1) (A_att kept symmetric): noise at the
    level of the float32 sums' own rounding."""
    from efficientq_tpu_torch.ptq import solver

    gen = torch.Generator().manual_seed(seed)

    def grams(*args, **kw):
        st = solver.compute_gram_stats(*args, **kw)

        def noisy(t):
            return t * (1 + 1e-7 * torch.randn(t.shape, generator=gen,
                                               dtype=t.dtype))
        A = noisy(st.A_att)
        return st._replace(A_att=(A + A.T) / 2, B_att=noisy(st.B_att))
    return grams


def cpu_rounding_outcomes(draws=12):
    """The tiny fixture's calibration on the CPU, unperturbed and under
    ``draws`` rounding-level perturbations of its Grams: ADMM projects
    onto the grid at every step, so a perturbation that flips one
    near-tie code sends a layer to another, equally valid, best iterate."""
    from efficientq_tpu_torch.ptq import admm

    outcomes = [tiny_outcome(tiny_calibration("cpu"))]
    real = admm.compute_gram_stats
    try:
        for seed in range(draws):
            admm.compute_gram_stats = perturbed_grams(seed)
            outcomes.append(tiny_outcome(tiny_calibration("cpu")))
    finally:
        admm.compute_gram_stats = real
    return outcomes


def tiny_card_against_cpu(dev):
    """The tiny fixture calibrated on the card and on the CPU: how far
    cuBLAS/cuSOLVER drift from the CPU's BLAS/LAPACK.  The card's outcome
    must lie within the CPU tests' tolerances of one of the outcomes the
    CPU itself reaches under rounding-level perturbations."""
    card = tiny_outcome(tiny_calibration(dev))
    cpu = cpu_rounding_outcomes()
    distinct = []
    for o in cpu:
        if not any(outcome_gaps(o, d)[0] == 1.0 for d in distinct):
            distinct.append(o)
    share, gaps, argmax, nums = outcome_gaps(card, cpu[0])
    print(f"[phase7] tiny fixture, card against CPU: weight codes equal on "
          f"{share:.8f}; largest relative gap: layer loss "
          f"{gaps['loss']:.3e}, alpha_w {gaps['alpha_w']:.3e}, alpha_act "
          f"{gaps['alpha_act']:.3e}; class voxel counts equal: {nums}; "
          f"argmax agreement {argmax:.8f}", flush=True)
    spread = [outcome_gaps(o, cpu[0]) for o in cpu[1:]]
    print(f"[phase7] the CPU under {len(cpu) - 1} rounding-level "
          f"perturbations of its Grams (x (1 + 1e-7 N(0, 1))) reaches "
          f"{len(distinct)} distinct outcomes: codes equal to the "
          f"unperturbed run's on {min(s for s, _, _, _ in spread):.8f} at "
          f"the least, layer loss gaps up to "
          f"{max(g['loss'] for _, g, _, _ in spread):.3e}, alpha_act gaps "
          f"up to {max(g['alpha_act'] for _, g, _, _ in spread):.3e}",
          flush=True)
    near = max(range(len(cpu)), key=lambda i: outcome_gaps(card, cpu[i])[0])
    share, gaps, argmax, nums = outcome_gaps(card, cpu[near])
    print(f"[phase7] nearest CPU outcome (draw {near}; 0 = "
          f"unperturbed): codes equal on {share:.8f}; largest relative gap:"
          f" layer loss {gaps['loss']:.3e}, alpha_w {gaps['alpha_w']:.3e}, "
          f"alpha_act {gaps['alpha_act']:.3e}; argmax agreement "
          f"{argmax:.8f}", flush=True)
    check(within_cpu_tolerances(share, gaps, argmax, nums),
          "tiny fixture: the card's calibration is none of the CPU's "
          "rounding-level outcomes")


def _grid_codes(kernel, alpha, qlvl):
    """(integer codes, largest distance from the alpha grid) of a
    weight-quantized kernel."""
    t = (kernel.double() / alpha + 1.0) * (qlvl - 1) / 2
    codes = torch.round(t)
    return codes, float(((t - codes).abs() * alpha * 2 / (qlvl - 1)).max())


def phase7(seed: int, smi: str, vol, label, dev):
    """The calibration slice: run_ptq of the flagship on one calibration
    crop, checked; the calibrated net served on the int8 float32 path and
    the s2d bf16 path; the tiny fixture calibrated on the card and on the
    CPU.  Returns {path: {kernel: launches}}."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.data.labels import split_label_brats
    from efficientq_tpu_torch.eval.metrics import dice
    from efficientq_tpu_torch.eval.sliding import (make_volume_inferencer,
                                                   patch_grid)
    from efficientq_tpu_torch.ptq import PTQHyperParams, fold_bn, run_ptq
    from efficientq_tpu_torch.ptq.deploy import make_s2d_volume_inferencer
    from efficientq_tpu_torch.quant import project_by_iter

    graph, variables = flagship_for_ptq(seed)
    x = calibration_crop(seed)
    hp = PTQHyperParams()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fg, qv, rep = run_ptq(graph, variables, x, task="brats",
                          init_stride=(2, 2, 2), hp=hp, device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[phase7] on {smi}: run_ptq of the BraTS W4A4 preset (full width "
          f"and depth) on one {tuple(x.shape[1:4])} x 4 calibration crop, "
          f"{hp.admm_iter} ADMM iterations a layer: FP forward "
          f"{rep.fp_forward_seconds:.4f} s, calibration "
          f"{rep.calibration_seconds:.4f} s, run_ptq {wall:.4f} s (copies "
          f"and BN folding included); peak device memory "
          f"{peak / 2**30:.4f} GiB above the {base / 2**30:.4f} GiB held "
          f"before", flush=True)
    nodes = fg.qconv_nodes()
    check(len(rep.layer_losses) == len(nodes) == 22,
          f"{len(rep.layer_losses)} layer losses for {len(nodes)} qconvs")
    sums = {"gram": 0.0, "admm": 0.0, "rest": 0.0}
    worst = 0.0
    for (name, loss), (_, rel) in zip(rep.layer_losses,
                                      rep.layer_rel_losses):
        node = fg.node(name)
        q, a = node.attrs["qcfg"], node.attrs
        p = qv["params"][name]
        secs = rep.layer_seconds[name]
        for k in sums:
            sums[k] += secs[k]
        _, dist = _grid_codes(p["kernel"], float(p["alpha_w"]), q.qlvl_w)
        worst = max(worst, dist)
        print(f"[phase7]   {name:45s} {a['kernel_size'][0]}^3 "
              f"{a['in_ch']:3d}->{a['out_ch']:3d} W{q.qlvl_w}"
              f"A{q.qlvl_act if q.q_act else '-'}: gram "
              f"{secs['gram'] * 1e3:9.3f} ms, admm {secs['admm'] * 1e3:9.3f}"
              f" ms ({secs['admm'] * 1e3 / hp.admm_iter:.3f} a step), rest "
              f"{secs['rest'] * 1e3:8.3f} ms; loss {loss:.6e} (relative "
              f"{rel:.6e})", flush=True)
        check(np.isfinite(loss) and np.isfinite(rel), f"{name}: loss {loss}")
        check(dist < 1e-4, f"{name}: kernel {dist} off its grid")
    print(f"[phase7] on {smi}: per-layer sums (CUDA events): gram "
          f"{sums['gram']:.4f} s, admm {sums['admm']:.4f} s, rest "
          f"{sums['rest']:.4f} s; every kernel on its grid (largest "
          f"distance {worst:.3e})", flush=True)

    xd = torch.from_numpy(x).to(dev)
    with torch.inference_mode():
        out_q = nnir.apply(fg, qv, xd, mode="quantized")
    gap = float((out_q - rep.output_q).abs().max())
    check(torch.allclose(out_q, rep.output_q, atol=1e-3, rtol=1e-3),
          f"quantized forward vs the sweep's output: max |diff| {gap}")
    # naive: the folded FP weights quantized on the fly at alpha_w = 1
    # (mode 'fq') with the calibrated alpha_act, as tests/test_ptq_e2e.py;
    # and, printed, each folded kernel projected at its own optimal alpha
    nfg, nfv = fold_bn(graph, variables)
    for name, p in nfv["params"].items():
        if "alpha_act" in p:
            p["alpha_act"] = qv["params"][name]["alpha_act"].cpu()
    pfv = {"params": {k: dict(v) for k, v in nfv["params"].items()},
           "state": nfv["state"]}
    for node in nfg.qconv_nodes():
        q, p = node.attrs["qcfg"], pfv["params"][node.name]
        if q.q_weight:
            a_w, b_w = project_by_iter(p["kernel"].to(dev), q.qlvl_w)
            p["kernel"], p["alpha_w"] = (a_w * b_w).cpu(), a_w.cpu()
    with torch.inference_mode():
        out_naive = nnir.apply(nfg, nnir.to_device(nfv, dev), xd,
                               mode="fq")
        out_proj = nnir.apply(nfg, nnir.to_device(pfv, dev), xd,
                              mode="quantized")
    fp = rep.output_fp[-1]
    err = {k: float(torch.mean((o[-1] - fp) ** 2)) for k, o in
           (("calibrated", out_q), ("naive", out_naive),
            ("projected", out_proj))}
    print(f"[phase7] final-head MSE to the FP output: calibrated "
          f"{err['calibrated']:.6e}, naive (fq at alpha_w = 1) "
          f"{err['naive']:.6e}, each kernel projected at its optimal alpha "
          f"{err['projected']:.6e}; quantized forward vs the sweep's output "
          f"max |diff| {gap:.3e}", flush=True)
    check(np.isfinite(err["calibrated"])
          and err["calibrated"] < err["naive"],
          f"calibrated MSE {err['calibrated']} not below naive "
          f"{err['naive']}")
    del out_q, out_naive, out_proj, xd
    torch.cuda.empty_cache()

    # serving the calibrated net: int8 float32 path, then s2d bf16
    dg, dv = deploy_served(fg, nnir.to_device(qv, "cpu"))
    n_k1 = sum(1 for n in dg.nodes if n.attrs.get("pallas"))
    check(n_k1 == 14, f"calibrated deployment: {n_k1} K1 convs, expected 14")
    dv = nnir.to_device(dv, dev)
    forwards = -(-len(patch_grid(VOL_SHAPE, PATCH, OVERLAP)) // N_BATCH)
    kw = dict(patch_batch=N_BATCH, heads=slice(-1, None), hard_pred=True,
              multilabel=True)
    infer = make_volume_inferencer(dg, mode="quantized", capture=False, **kw)
    launches = {}
    with _Launches() as counted:
        t0 = time.perf_counter()
        pred = infer(dv, vol.to(dev), PATCH, OVERLAP)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches["calibrated_int8_f32"] = counted.counts
    check(counted.counts["K1"] == 14 * forwards,
          f"calibrated int8 path: {counted.counts} over {forwards} forwards")
    plain = make_volume_inferencer(
        dg, mode="quantized", kernels=plain_direct(), capture=False, **kw)(
        dv, vol.to(dev), PATCH, OVERLAP)
    check(torch.equal(plain, pred), "calibrated int8 path: K1 != plain K1")
    target = split_label_brats(label)
    d = [dice(pred[0, 0, ..., c].cpu().numpy(), target[c]) for c in range(3)]
    check(all(np.isfinite(d)), f"calibrated int8 path: Dice {d}")
    fg_fp, fv_fp = fold_bn(graph, variables)
    fp_pred = make_volume_inferencer(fg_fp, mode="fp", capture=False, **kw)(
        nnir.to_device(fv_fp, dev), vol.to(dev), PATCH, OVERLAP)
    agree_fp = float((fp_pred == pred).float().mean())
    print(f"[phase7] on {smi}: calibrated net served on the int8 float32 "
          f"path: {secs:.4f} s for one volume, launches {counted.counts} "
          f"over {forwards} patch-batch forwards; equal to the plain-K1 run;"
          f" Dice WT/TC/ET vs synthetic labels {[round(v, 6) for v in d]}; "
          f"agrees with the FP network's prediction on {agree_fp:.8f} of "
          f"{pred.numel()} voxel-classes", flush=True)
    del plain, fp_pred
    torch.cuda.empty_cache()

    s2d_kw = dict(multilabel=True, heads=slice(-1, None), device=dev)
    s2d = make_s2d_volume_inferencer(dg, dv, **s2d_kw)
    check(s2d is not None, "calibrated deployment: no eligible s2d stem")
    host = vol.numpy()
    with _Launches() as counted:
        s2d_pred = s2d(None, host, PATCH, OVERLAP)
    launches["calibrated_s2d_bf16"] = counted.counts
    check(counted.counts["K1"] == 14 and counted.counts["K2"] == 1,
          f"calibrated s2d path: launches {counted.counts}")
    s2d_plain = make_s2d_volume_inferencer(
        dg, dv, kernels=plain_s2d(), capture=False, **s2d_kw)(
        None, host, PATCH, OVERLAP)
    agree_s2d = float((s2d_plain == s2d_pred).float().mean())
    print(f"[phase7] calibrated net on the s2d bf16 path: launches "
          f"{counted.counts}; agrees with the s2d path on the plain K2 and "
          f"K1 on {agree_s2d:.8f} of {s2d_pred.numel()} voxel-classes "
          f"(random weights, phase 4: 0.99214107), with the int8 float32 "
          f"path on {float((s2d_pred == pred).float().mean()):.8f}",
          flush=True)
    check(agree_s2d >= AGREE_PLAIN_S2D, f"calibrated s2d path vs the plain "
          f"K2 and K1: {agree_s2d} < {AGREE_PLAIN_S2D}")
    del s2d, s2d_pred, s2d_plain, pred, dv, qv
    torch.cuda.empty_cache()

    # the tiny fixture on the card and on the CPU
    tiny_card_against_cpu(dev)
    return launches


def profile_calibration(seed):
    """torch.profiler over run_ptq of the flagship on the calibration crop,
    at 20 ADMM iterations a layer (the steps repeat, so their mix is
    that of 200)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from efficientq_tpu_torch.ptq import PTQHyperParams, run_ptq

    graph, variables = flagship_for_ptq(seed)
    x = calibration_crop(seed)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_ptq(graph, variables, x, task="brats", init_stride=(2, 2, 2),
                hp=PTQHyperParams(admm_iter=20), device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.key != "Activity Buffer Request"]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in events) / 1e3
    print(f"[profile] run_ptq, 20 ADMM iterations a layer: wall {wall:.3f} "
          f"ms under the profiler, device busy {busy:.3f} ms (idle share "
          f"{max(0.0, 1 - busy / wall):.4f}), {sum(e.count for e in events)}"
          f" device events", flush=True)
    for e in sorted(events, key=dev_us, reverse=True)[:20]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}", flush=True)


def profile_paths(served, s2d_infer, k3_infer, mixed_infer):
    """torch.profiler over one volume of each serving path."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    vol = served["vols"][1]
    runs = [("int8 f32 path (phase 2)", lambda: served["infer"](
                served["net"].variables, vol.to(dev), PATCH, OVERLAP)),
            ("s2d bf16 path (phase 4)", lambda: s2d_infer(
                None, vol.numpy(), PATCH, OVERLAP)),
            ("int8 + include_1x1 s2d path (phase 6 b)", lambda: k3_infer(
                None, vol.numpy(), PATCH, OVERLAP)),
            ("mixed + s2d + include_1x1 path (phase 6 c)", lambda:
                mixed_infer(None, vol.numpy(), PATCH, OVERLAP))]
    for name, run in runs:
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        from torch.autograd import DeviceType

        # device-side events only (kernels and copies): the host-side aten
        # ops carry the same device time again
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.key != "Activity Buffer Request"]

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))

        busy = sum(dev_us(e) for e in events) / 1e3
        print(f"[profile] {name}: wall {wall:.3f} ms under the profiler, "
              f"device busy {busy:.3f} ms (idle share "
              f"{max(0.0, 1 - busy / wall):.4f})", flush=True)
        for e in sorted(events, key=dev_us, reverse=True)[:15]:
            print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  "
                  f"{e.key[:90]}", flush=True)


HERE = os.path.dirname(os.path.abspath(__file__))
# the artifact files of the ptq mission, name for name as the JAX mission
# writes them (efficientq_tpu/cli/missions.py)
PTQ_FILES = ("cmd.txt", "time_cost.txt", "layer_loss.txt",
             "layer_loss_curve.npz", "class_voxel_nums.txt", "Qseg0.nii.gz",
             "FPseg0.nii.gz", "state_in_fp.pkl", "state_in_int8.pkl",
             "state_in_int8_compress.npz", "ptq/val_seg.txt",
             "ptq/test_seg.txt")
# the stream's length: 4 volumes since phase 11 joined the smoke (6 since
# phase 9 did, 12 before), to keep the whole run well inside its limit
STREAM_VOLUMES = 4


def _metric_numbers(path):
    """Every number of a ``*_seg.txt`` metric file."""
    import re

    with open(path) as f:
        text = f.read()
    return [float(v) for v in re.findall(r"(?<![\w/])-?\d+\.\d+|nan|inf",
                                         text)]


def _seg(path):
    from efficientq_tpu_torch.utils.nifti import load_nifti

    return np.asarray(load_nifti(path).dataobj)


def _mission_args(argv):
    from efficientq_tpu_torch.cli import entrance

    args = entrance.build_parser().parse_args(argv)
    return entrance.merge_config(args.config, args)


def _deployed_export(args):
    """The infer mission's serving graph, built as ``cli/missions.py::infer``
    builds it: (graph, variables on the CPU, data hub, heads, classes)."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.cli import definer
    from efficientq_tpu_torch.models import build_uresq, torch_io
    from efficientq_tpu_torch.ptq import apply_qlvl_overrides, fold_bn

    hub, _, _, n_class, _ = definer.get_data_cube(args)
    cfg, _, n_mo = definer.get_model_config(args)
    graph = build_uresq(cfg)
    fg, fv = fold_bn(graph, nnir.init(graph, 0, device="cpu"))
    overrides = torch_io.read_export_qlvl_overrides(args.pretrain)
    if overrides:  # a mixed-precision export's per-layer grids
        fg = apply_qlvl_overrides(fg, overrides)
    fv = torch_io.load_int8_checkpoint(fg, fv, args.pretrain)
    only = {(3, 3, 3)} if args.deploy == "mixed" else None
    dg, dv = deploy_served(fg, fv, only_kernel_sizes=only)
    return dg, dv, hub, n_mo, n_class


def _plain_val(args, infer_maker, out_dir):
    """validate_seg of the mission's deployed graph over its val split with
    the inferencer ``infer_maker(graph, variables)``, the final head's
    predictions saved as the mission saves them: {subject: labels}."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.eval.validate import validate_seg

    dg, dv, hub, n_mo, n_class = _deployed_export(args)
    dv = nnir.to_device(dv, "cuda")
    validate_seg(dg, dv, hub.valloader, hub.val_sn, n_mo, n_class,
                 patch_size=hub.slide_patch_size, overlap=hub.slide_overlap,
                 mode="quantized", save_dir=out_dir,
                 sn_fn_dict=hub.sn_to_fn_map,
                 merge_label_func=hub.merge_label_func,
                 multilabel_fusetype=hub.multilabel_fusetype,
                 infer=infer_maker(dg, dv), device="cuda")
    return {sn: _seg(os.path.join(out_dir, f"{sn}.nii.gz"))
            for sn in hub.val_sn}


class _ListDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _stream(served, serve_stem, refs):
    """validate_seg over STREAM_VOLUMES volumes (phase 2's three, repeated)
    through the port's Loader: (volumes/s over volumes 2-N, launches,
    wall ms, ms in the host's metrics, each volume's agreement with its
    reference).  The int8 float32 path serves at phase 2's patch batch, the
    s2d path at its whole-grid rule, as phase 4.  The time a volume is done
    is when its last head's metrics are.  Volume i's final-head prediction,
    as the host reads it back, is held against ``refs[i % 3]`` (phase 2's
    or phase 4's predictions): a readback or a staging buffer that raced
    the next volume would hand the host another volume's prediction."""
    from efficientq_tpu_torch.data.datasets import Loader
    from efficientq_tpu_torch.data.labels import split_label_brats
    from efficientq_tpu_torch.eval import validate as V

    imgs = [np.ascontiguousarray(np.moveaxis(v[0].numpy(), -1, 0))
            for v in served["vols"]]
    labs = [split_label_brats(lab) for _, lab in served["subjects"]]
    data = _ListDataset([(imgs[i % 3], labs[i % 3])
                         for i in range(STREAM_VOLUMES)])
    refs = [np.moveaxis(p[0, 0].cpu().numpy(), -1, 0) for p in refs]
    dgraph = served["dgraph"]
    n_mo = len(dgraph.outputs)
    done, spent, agree = [], [], []

    class Timed(V.SegMetricMC):
        def evaluate_append_pred(self, pred, *a, **k):
            t = time.perf_counter()
            out = super().evaluate_append_pred(pred, *a, **k)
            done.append(time.perf_counter())
            spent.append(done[-1] - t)
            if len(done) % n_mo == 0:  # the final head comes last
                ref = refs[(len(done) // n_mo - 1) % 3]
                agree.append(float(np.mean(pred == ref))
                             if pred.shape == ref.shape else -1.0)
            return out

    saved = V.SegMetricMC
    V.SegMetricMC = Timed
    try:
        torch.cuda.synchronize()
        with _Launches() as counted:
            t0 = time.perf_counter()
            sm = V.validate_seg(
                dgraph, served["net"].variables, Loader(data), None, n_mo, 3,
                patch_size=PATCH, overlap=OVERLAP, mode="quantized",
                patch_batch=N_BATCH if serve_stem == "direct" else "auto",
                compute_dtype=torch.bfloat16 if serve_stem == "s2d" else None,
                serve_stem=serve_stem, device="cuda")
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        V.SegMetricMC = saved
    finished = done[n_mo - 1::n_mo]
    check(len(finished) == STREAM_VOLUMES and len(sm[-1]) == STREAM_VOLUMES,
          f"stream: {len(finished)} volumes done")
    check(all(np.isfinite(list(sm[-1].get_metric().values()))),
          "stream: metrics not finite")
    vps = (STREAM_VOLUMES - 1) / (finished[-1] - finished[0])
    return vps, counted.counts, wall, sum(spent) * 1e3, agree


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(intervals, merged):
    """Total length of ``intervals`` that lies inside the union
    ``merged``."""
    import bisect

    starts = [a for a, _ in merged]
    total = 0.0
    for a, b in intervals:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(merged) and merged[i][0] < b:
            total += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
            i += 1
    return total


def trace_stats(path, wall_ms):
    """Device busy time (the union of kernel, copy and memset intervals on
    every stream), idle share against ``wall_ms``, the host-to-device
    copies' time, and how much of it ran while a kernel ran on the compute
    stream (the stream with the most kernel time), from a
    ``torch.profiler`` Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, kernels, h2d = [], {}, []
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy",
                                             "gpu_memset"):
            continue
        iv = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        dev.append(iv)
        if cat == "kernel":
            kernels.setdefault(e.get("args", {}).get("stream"), []).append(iv)
        elif "HtoD" in e.get("name", ""):
            h2d.append(iv)
    check(bool(kernels), "profile: no kernel ran on the device")
    compute = max(kernels, key=lambda s: sum(b - a for a, b in kernels[s]))
    busy = sum(b - a for a, b in _union(dev)) / 1e3
    copy = sum(b - a for a, b in h2d) / 1e3
    under = _overlap(h2d, _union(kernels[compute])) / 1e3
    return dict(busy_ms=busy, idle_share=max(0.0, 1 - busy / wall_ms),
                h2d_ms=copy, h2d_under_kernels_ms=under,
                h2d_overlap_share=under / copy if copy else 0.0,
                compute_stream=compute, h2d_copies=len(h2d))


def phase8(seed: int, smi: str, served, s2d_preds, work: str):
    """The ptq and infer missions through the port's CLI at full width, on
    a synthetic BraTS dataset written under ``work`` (phase 9 reuses it;
    ``main`` removes it), then a sustained stream through validate_seg.
    Returns ({path: {kernel: launches}}, {"data_dir", "split_dir",
    "ckpt"})."""
    from efficientq_tpu_torch.cli import entrance
    from efficientq_tpu_torch.data.synthetic import make_synthetic_dataset
    from efficientq_tpu_torch.eval.sliding import (make_volume_inferencer,
                                                   patch_grid)
    from efficientq_tpu_torch.models import torch_io
    from efficientq_tpu_torch.ptq.deploy import make_s2d_volume_inferencer

    check(os.environ.get("EFFQ_PLATFORM", "").lower() != "cpu",
          "EFFQ_PLATFORM=cpu would keep the missions off the card")
    launches = {}
    tmp = os.path.join(work, "brats")
    os.makedirs(tmp)
    cwd = os.getcwd()
    try:
        # (a) the data and the "pretrain" checkpoint
        t0 = time.perf_counter()
        data_dir, split_dir = make_synthetic_dataset(
            tmp, task="brats", n_subjects=4, vol_shape=VOL_SHAPE, seed=seed,
            access_type="npz")
        graph, variables = flagship_for_ptq(seed)
        ckpt = os.path.join(tmp, "pretrain.pkl")
        with open(ckpt, "wb") as f:
            pickle.dump({"state_dict": torch_io.to_torch_state_dict(
                graph, variables)}, f)
        del graph, variables
        print(f"[phase8] (a) synthetic BraTS dataset (4 subjects, "
              f"{VOL_SHAPE} x 4 modalities, npz) and the random-weight "
              f"flagship checkpoint written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        os.chdir(tmp)
        config = os.path.join(HERE, "config", "brats_ptq.yaml")
        common = ["--qlvl_w", "4", "--qlvl_a", "4", "--round", "1",
                  "--config", config, "--data_dir", data_dir,
                  "--split_dir", split_dir, "--tune_serving", "off"]

        # (b) the README's ptq command
        t0 = time.perf_counter()
        with _Launches() as counted:
            snap, sec = entrance.main(["ptq", *common, "--pretrain", ckpt,
                                       "--true_test", "--save_nii"])
        wall = time.perf_counter() - t0
        launches["mission_ptq"] = counted.counts
        for name in PTQ_FILES:
            check(os.path.isfile(os.path.join(snap, name)),
                  f"ptq mission: {name} missing")
        for sub in ("ptq/val", "ptq/test", "ptq/true_test"):
            check(bool(os.listdir(os.path.join(snap, sub))),
                  f"ptq mission: no NIfTI under {sub}")
        with open(os.path.join(snap, "layer_loss.txt")) as f:
            losses = [float(line.rsplit(":", 1)[1])
                      for line in f.read().splitlines()]
        check(len(losses) == 22 and all(np.isfinite(losses)),
              f"ptq mission: {len(losses)} layer losses {losses}")
        for split in ("val", "test"):
            nums = _metric_numbers(os.path.join(snap, "ptq",
                                                f"{split}_seg.txt"))
            check(bool(nums) and all(np.isfinite(nums)),
                  f"ptq mission: {split}_seg.txt not finite")
        with open(os.path.join(snap, "state_in_int8.pkl"), "rb") as f:
            sd = pickle.load(f)["state_dict"]
        check(len(sd["__qlvl_overrides__"]) == 22
              and all(type(v) is np.ndarray for k, v in sd.items()
                      if k != "__qlvl_overrides__"),
              "ptq mission: export is not NumPy arrays with the 22 grids")
        check(counted.counts["K1"] == 0, "ptq mission: the fake-quant final "
              f"test launched K1 {counted.counts}")
        print(f"[phase8] (b) on {smi}: ptq mission (config/brats_ptq.yaml, "
              f"W4A4, full width) {wall:.4f} s: data "
              f"{sec['data']:.4f} s, FP forward {sec['fp_forward']:.4f} s, "
              f"calibration {sec['calibration']:.4f} s, final test "
              f"{sec['final_test']:.4f} s, exports {sec['exports']:.4f} s; "
              f"every artifact file written, 22 finite layer losses, finite "
              f"val and test metrics", flush=True)

        # (c) infer --deploy int8 on (b)'s export
        export = os.path.join(snap, "state_in_int8.pkl")
        n_patches = len(patch_grid(VOL_SHAPE, PATCH, OVERLAP))
        forwards = 2 * -(-n_patches // min(n_patches, 8))  # val + test
        argv = ["infer", *common, "--pretrain", export, "--save_nii"]
        t0 = time.perf_counter()
        with _Launches() as counted:
            snap_c, _ = entrance.main(argv + ["--deploy", "int8",
                                              "--suffix", "int8"])
        wall = time.perf_counter() - t0
        launches["mission_infer_int8"] = counted.counts
        check(counted.counts["K1"] == 14 * forwards,
              f"infer int8: launches {counted.counts}, expected "
              f"{14 * forwards} K1 over {forwards} forwards")
        args = _mission_args(argv + ["--deploy", "int8"])
        plain = _plain_val(args, lambda g, v: make_volume_inferencer(
            g, patch_batch=min(n_patches, 8), mode="quantized",
            hard_pred=True, multilabel=True,
            kernels=plain_direct(), capture=False),
            os.path.join(tmp, "plain_int8"))
        int8_val = {}
        for sn, want in plain.items():
            got = _seg(os.path.join(snap_c, "infer", "val", f"{sn}.nii.gz"))
            check(np.array_equal(got, want), f"infer int8: {sn} differs "
                  f"from validate_seg on the plain K1")
            int8_val[sn] = got
        for split in ("val", "test"):
            nums = _metric_numbers(os.path.join(snap_c, "infer",
                                                f"{split}_seg.txt"))
            check(bool(nums) and all(np.isfinite(nums)),
                  f"infer int8: {split}_seg.txt not finite")
        print(f"[phase8] (c) infer --deploy int8: {wall:.4f} s, launches "
              f"{counted.counts} over {forwards} patch-batch forwards (14 K1 "
              f"each); the saved val prediction equals validate_seg of the "
              f"same graph on the plain K1", flush=True)

        # (d) infer --deploy mixed --serve_stem s2d --serve_dtype bf16
        forwards = 2  # the whole grid of a volume in one forward
        t0 = time.perf_counter()
        with _Launches() as counted:
            snap_d, _ = entrance.main(argv + [
                "--deploy", "mixed", "--serve_stem", "s2d", "--serve_dtype",
                "bf16", "--suffix", "s2d"])
        wall = time.perf_counter() - t0
        launches["mission_infer_mixed_s2d"] = counted.counts
        check(counted.counts["K2"] == forwards
              and counted.counts["K1"] == 14 * forwards,
              f"infer mixed s2d: launches {counted.counts}, expected 1 K2 "
              f"and 14 K1 per forward over {forwards}")
        args = _mission_args(argv + ["--deploy", "mixed"])
        plain = _plain_val(args, lambda g, v: make_s2d_volume_inferencer(
            g, v, multilabel=True, compute_dtype=torch.bfloat16,
            device="cuda", kernels=plain_s2d(), capture=False),
            os.path.join(tmp, "plain_s2d"))
        for sn, want in plain.items():
            got = _seg(os.path.join(snap_d, "infer", "val", f"{sn}.nii.gz"))
            agree = float(np.mean(got == want))
            print(f"[phase8] (d) infer --deploy mixed --serve_stem s2d "
                  f"--serve_dtype bf16: {wall:.4f} s, launches "
                  f"{counted.counts} over {forwards} forwards; val {sn} "
                  f"agrees with the same path on the plain K2 and K1 on "
                  f"{agree:.8f} of {got.size} voxels, with (c)'s int8 "
                  f"float32 prediction on "
                  f"{float(np.mean(got == int8_val[sn])):.8f}", flush=True)
            check(agree >= AGREE_PLAIN_S2D, f"infer mixed s2d vs the plain "
                  f"K2 and K1: {agree} < {AGREE_PLAIN_S2D}")
        del plain
        torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)

    # (e) a sustained stream through validate_seg and the Loader, each
    # volume held against its reference: phase 2's int8 float32 predictions
    # (equal) and phase 4's s2d bf16 ones (AGREE_S2D)
    rates = {}
    fw = -(-len(patch_grid(VOL_SHAPE, PATCH, OVERLAP)) // N_BATCH)
    for path, stem_kind, refs, level in (
            ("int8_f32", "direct", served["preds"], 1.0),
            ("s2d_bf16", "s2d", s2d_preds, AGREE_S2D)):
        host = [p[0, 0].cpu().numpy() for p in refs]
        cross = max(float(np.mean(host[i] == host[j]))
                    for i, j in ((0, 1), (0, 2), (1, 2)))
        check(cross < level, f"stream {path}: the three references agree on "
              f"{cross}, so a volume served out of order would pass")
        vps, counts, wall, metrics_ms, agree = _stream(served, stem_kind,
                                                       refs)
        rates[path] = vps
        launches[f"stream_{path}"] = counts
        check(counts["K1"] == 14 * STREAM_VOLUMES * (
                  fw if stem_kind == "direct" else 1)
              and counts["K2"] == (STREAM_VOLUMES if stem_kind == "s2d"
                                   else 0),
              f"stream {path}: launches {counts}")
        check(len(agree) == STREAM_VOLUMES and min(agree) >= level,
              f"stream {path}: volumes agree with their references on "
              f"{agree} (< {level})")
        print(f"[phase8] (e) stream {path}: {wall:.3f} ms for "
              f"{STREAM_VOLUMES} volumes, of which {metrics_ms:.3f} ms in "
              f"the host's SegMetricMC; launches {counts}; each volume's "
              f"final-head prediction agrees with "
              f"{'phase 2' if stem_kind == 'direct' else 'phase 4'}'s for "
              f"the same volume on at least {min(agree):.8f} (held: "
              f"{level}; the references of different volumes agree on at "
              f"most {cross:.8f})", flush=True)
    print(f"[phase8] (e) on {smi}: validate_seg over {STREAM_VOLUMES} "
          f"volumes through the Loader (every head), volumes/s over volumes "
          f"2-{STREAM_VOLUMES}: int8 float32 path at patch batch {N_BATCH} "
          f"{rates['int8_f32']:.4f} (phase 2, final head, batch {N_BATCH}: "
          f"{served['vps']['phase 2']:.4f}), s2d bf16 path, whole grid "
          f"{rates['s2d_bf16']:.4f} (phase 4: "
          f"{served['vps']['phase 4']:.4f})", flush=True)
    return launches, dict(data_dir=data_dir, split_dir=split_dir, ckpt=ckpt,
                          export=export, common=common, snap_int8=snap_c,
                          snap_s2d=snap_d)


LITS_VOL = (256, 256, 128)  # the in-plane size of train_crop_npy_256, z last
LITS_SUBJECTS = 8  # train 4 (the recipe's --lwq_select 4), val 2, test 2


def _phase9_lits_data(seed, root):
    """Phase 9 (a): the synthetic LiTS set (npy, 1 modality) and the LiTS
    preset with weights from ``seed`` and BN state randomised, pickled as
    {'state_dict': ...}.  Returns (data_dir, split_dir, ckpt, graph)."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.data.synthetic import make_synthetic_dataset
    from efficientq_tpu_torch.models import (build_uresq, preset_config,
                                             torch_io)

    data_dir, split_dir = make_synthetic_dataset(
        root, task="lits", n_subjects=LITS_SUBJECTS, vol_shape=LITS_VOL,
        seed=seed + 9, access_type="npy")
    graph = build_uresq(preset_config("lits", quantize=True))
    variables = _random_bn_state(nnir.init(graph, seed, device="cpu"), seed)
    ckpt = os.path.join(root, "pretrain.pkl")
    with open(ckpt, "wb") as f:
        pickle.dump({"state_dict": torch_io.to_torch_state_dict(
            graph, variables)}, f)
    return data_dir, split_dir, ckpt, graph


def _flagged(graph):
    """The convs K1 runs in a forward of every head of a deployed graph."""
    from efficientq_tpu_torch import nnir

    live = nnir.live_nodes(graph, graph.outputs)
    return [n.name for n in graph.nodes if n.name in live
            and n.attrs.get("pallas") and n.attrs["kernel_size"] == (3, 3, 3)]


def phase9(seed: int, smi: str, work: str, brats):
    """The PTQ extensions through the port's CLI at full width: the LiTS
    sub-4-bit recipe (config/lits_ptq_sub4.yaml) and ``infer --deploy
    int8`` on its export, then the other knobs on phase 8's BraTS set and
    checkpoint.  Returns {path: {kernel: launches}}."""
    from efficientq_tpu_torch.utils.toolchain import toolchain_fingerprint

    for key, value in toolchain_fingerprint().items():
        print(f"[phase9] toolchain {key}: {value}", flush=True)
    return {**phase9_lits(seed, smi, work),
            **phase9_knobs(seed, smi, work, brats)}


def phase9_lits(seed: int, smi: str, work: str):
    """Phase 9 (a)-(c): the LiTS recipe and infer --deploy int8 on its
    export.  Returns {path: {kernel: launches}}."""
    import re

    from efficientq_tpu_torch.cli import entrance
    from efficientq_tpu_torch.eval.sliding import (make_volume_inferencer,
                                                   patch_grid)
    from efficientq_tpu_torch.ptq import tail_sensitive_convs

    launches = {}
    root = os.path.join(work, "lits")
    os.makedirs(root)
    cwd = os.getcwd()
    try:
        # (a) the data and the checkpoint
        t0 = time.perf_counter()
        data_dir, split_dir, ckpt, graph = _phase9_lits_data(seed, root)
        tail = tail_sensitive_convs(graph)
        n_weight_q = sum(1 for n in graph.qconv_nodes()
                         if n.attrs["qcfg"].q_weight)
        del graph
        print(f"[phase9] (a) synthetic LiTS set ({LITS_SUBJECTS} subjects of "
              f"{LITS_VOL}, npy, 1 modality: train 4, val 2, test 2) and the "
              f"random-weight LiTS preset (widths 32-512-32, init stride "
              f"2,2,1) written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        os.chdir(root)
        config = os.path.join(HERE, "config", "lits_ptq_sub4.yaml")
        common = ["--qlvl_w", "4", "--qlvl_a", "4", "--round", "1",
                  "--config", config, "--data_dir", data_dir,
                  "--split_dir", split_dir, "--tune_serving", "off"]

        # (b) the recipe as a user types it
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _Launches() as counted:
            snap, sec = entrance.main(["ptq", *common, "--pretrain", ckpt])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches["lits_recipe_ptq"] = counted.counts
        lines = open(os.path.join(snap, "calib_select.txt")).read() \
            .splitlines()
        pat = re.compile(r"^candidate \d+: train-volume dice \d+\.\d{6}"
                         r"(  <- picked)?$")
        check(len(lines) == 4 and all(pat.match(ln) for ln in lines)
              and sum(ln.endswith("<- picked") for ln in lines) == 1,
              f"recipe: calib_select.txt {lines}")
        lifted = open(os.path.join(snap, "mixed_upgraded.txt")).read() \
            .split()
        check(lifted[:len(tail)] == tail, f"recipe: mixed_upgraded.txt "
              f"{lifted} does not list the tail {tail} first")
        with open(os.path.join(snap, "state_in_int8.pkl"), "rb") as f:
            grids = pickle.load(f)["state_dict"]["__qlvl_overrides__"]
        # a lifted 4-level layer is on the 16-level grid; the 256-level
        # first and last convs keep theirs
        check(all(tuple(grids[name]) == (16, 16) for name in tail)
              and all(min(grids[name]) >= 16 for name in lifted),
              f"recipe: lifted layers not on 16-level grids: "
              f"{ {n: grids[n] for n in lifted} }")
        with open(os.path.join(snap, "layer_loss.txt")) as f:
            losses = [float(line.rsplit(":", 1)[1])
                      for line in f.read().splitlines()]
        check(len(losses) == n_weight_q and all(np.isfinite(losses)),
              f"recipe: {len(losses)} layer losses {losses}")
        for split in ("val", "test"):
            nums = _metric_numbers(os.path.join(snap, "ptq",
                                                f"{split}_seg.txt"))
            check(bool(nums) and all(np.isfinite(nums)),
                  f"recipe: {split}_seg.txt not finite")
        check(counted.counts["K1"] == 0, "recipe: the fake-quant scoring and "
              f"final test launched K1 {counted.counts}")
        parts = ", ".join(f"{k} {v:.4f} s" for k, v in sec.items())
        print(f"[phase9] (b) on {smi}: ptq --config "
              f"config/lits_ptq_sub4.yaml (W4A4, --mixed_frac 0.25 "
              f"--mixed_qlvl 16 --lwq_select 4, full width) {wall:.4f} s: "
              f"{parts}; peak device memory {peak:.4f} GiB", flush=True)
        print(f"[phase9] (b) calib_select.txt: {' | '.join(lines)}",
              flush=True)
        print(f"[phase9] (b) {len(lifted)} of {n_weight_q} layers lifted, "
              f"the tail first: {lifted}; export grids of the lifted layers "
              f"{ {n: tuple(grids[n]) for n in lifted} }; {len(losses)} "
              f"finite layer losses", flush=True)

        # (c) infer --deploy int8 on (b)'s export
        export = os.path.join(snap, "state_in_int8.pkl")
        argv = ["infer", *common, "--pretrain", export, "--save_nii",
                "--deploy", "int8"]
        args = _mission_args(argv)
        dg, _, hub, _, _ = _deployed_export(args)
        flagged = _flagged(dg)
        grid = patch_grid(LITS_VOL, tuple(hub.slide_patch_size),
                          tuple(hub.slide_overlap))
        batch = min(len(grid), 8)
        forwards = 4 * -(-len(grid) // batch)  # val 2 + test 2
        del dg
        t0 = time.perf_counter()
        with _Launches() as counted:
            snap_c, _ = entrance.main(argv + ["--suffix", "int8"])
        wall = time.perf_counter() - t0
        launches["lits_recipe_infer_int8"] = counted.counts
        check(counted.counts["K1"] == len(flagged) * forwards,
              f"LiTS infer int8: launches {counted.counts}, expected "
              f"{len(flagged)} K1 x {forwards} forwards")
        plain = _plain_val(args, lambda g, v: make_volume_inferencer(
            g, patch_batch=batch, mode="quantized", hard_pred=True,
            multilabel=False, kernels=plain_direct(), capture=False),
            os.path.join(root, "plain_int8"))
        for sn, want in plain.items():
            got = _seg(os.path.join(snap_c, "infer", "val", f"{sn}.nii.gz"))
            check(np.array_equal(got, want), f"LiTS infer int8: {sn} differs "
                  f"from validate_seg on the plain K1")
        for split in ("val", "test"):
            nums = _metric_numbers(os.path.join(snap_c, "infer",
                                                f"{split}_seg.txt"))
            check(bool(nums) and all(np.isfinite(nums)),
                  f"LiTS infer int8: {split}_seg.txt not finite")
        print(f"[phase9] (c) infer --deploy int8 on the recipe's export: "
              f"{wall:.4f} s, {len(flagged)} convs flagged for K1 in the "
              f"deployed graph, launches {counted.counts} over {forwards} "
              f"forwards of {batch} patches ({len(grid)} a volume); the "
              f"saved val predictions of {len(plain)} volumes equal "
              f"validate_seg of the same graph on the plain K1", flush=True)
        del plain
        torch.cuda.empty_cache()

    finally:
        os.chdir(cwd)
    return launches


def phase9_knobs(seed: int, smi: str, work: str, brats):
    """Phase 9 (d): the other PTQ extensions on phase 8's BraTS set and
    checkpoint, then their export served on the s2d bf16 mixed path.
    Returns {path: {kernel: launches}}."""
    from efficientq_tpu_torch.cli import entrance
    from efficientq_tpu_torch.kernels import stem
    from efficientq_tpu_torch.models import build_uresq, preset_config
    from efficientq_tpu_torch.ptq import tail_sensitive_convs
    from efficientq_tpu_torch.ptq.deploy import make_s2d_volume_inferencer

    launches = {}
    cwd = os.getcwd()
    try:
        # (d) the other knobs on phase 8's BraTS set and checkpoint
        os.chdir(os.path.join(work, "brats"))
        bcommon = ["--qlvl_w", "4", "--qlvl_a", "4", "--round", "1",
                   "--config", os.path.join(HERE, "config", "brats_ptq.yaml"),
                   "--data_dir", brats["data_dir"],
                   "--split_dir", brats["split_dir"], "--tune_serving",
                   "off"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _Launches() as counted:
            snap_d, sec = entrance.main([
                "ptq", *bcommon, "--pretrain", brats["ckpt"], "--mixed_frac",
                "0.25", "--lwq_granularity", "block", "--act_offset", "2",
                "--tail_alpha_sweep", "--tune_act", "50", "--no_test",
                "--suffix", "knobs"])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches["brats_knobs_ptq"] = counted.counts
        sweep = open(os.path.join(snap_d, "tail_alpha_sweep.txt")).read() \
            .splitlines()
        check(len(sweep) == 5 and sum(ln.endswith("<- kept")
                                      for ln in sweep) == 1,
              f"knobs: tail_alpha_sweep.txt {sweep}")
        tune_loss = [float(v) for v in open(os.path.join(
            snap_d, "tune_act_loss.txt")).read().split()]
        check(len(tune_loss) == 50 and all(np.isfinite(tune_loss)),
              f"knobs: tune_act_loss.txt {tune_loss}")
        scores = open(os.path.join(snap_d, "tune_act_score.txt")).read() \
            .splitlines()
        check([ln.split(":")[0] for ln in scores] == ["iter 0", "iter 50"]
              and sum(ln.endswith("<- kept") for ln in scores) == 1,
              f"knobs: tune_act_score.txt {scores}")
        with open(os.path.join(snap_d, "state_in_fp.pkl"), "rb") as f:
            sd = pickle.load(f)["state_dict"]
        act_k = {k.rsplit(".", 1)[0]: int(v) for k, v in sd.items()
                 if k.endswith(".act_k")}
        btail = tail_sensitive_convs(build_uresq(preset_config(
            "brats", quantize=True)))
        check(sorted(act_k) == sorted(btail), f"knobs: act_k on {act_k}, "
              f"the searched tail is {btail}")
        with open(os.path.join(snap_d, "layer_loss.txt")) as f:
            losses = [float(line.rsplit(":", 1)[1])
                      for line in f.read().splitlines()]
        check(len(losses) == 22 and all(np.isfinite(losses)),
              f"knobs: {len(losses)} layer losses {losses}")
        parts = ", ".join(f"{k} {v:.4f} s" for k, v in sec.items())
        print(f"[phase9] (d) on {smi}: ptq --config config/brats_ptq.yaml "
              f"--mixed_frac 0.25 --lwq_granularity block --act_offset 2 "
              f"--tail_alpha_sweep --tune_act 50 --no_test {wall:.4f} s: "
              f"{parts}; peak device memory {peak:.4f} GiB; act_k chosen "
              f"{act_k}; tail_alpha_sweep.txt: {' | '.join(sweep)}; "
              f"tune_act_score.txt: {' | '.join(scores)}; recon MSE "
              f"{tune_loss[0]:.6g} -> {tune_loss[-1]:.6g}", flush=True)

        argv = ["infer", *bcommon, "--pretrain",
                os.path.join(snap_d, "state_in_int8.pkl"), "--save_nii",
                "--deploy", "mixed", "--serve_stem", "s2d", "--serve_dtype",
                "bf16"]
        args = _mission_args(argv)
        dg, _, _, _, _ = _deployed_export(args)
        offset_3x3 = [n.name for n in dg.nodes if n.attrs.get("act_k")
                      and n.attrs["kernel_size"] == (3, 3, 3)]
        flagged = _flagged(dg)
        del dg
        check(len(flagged) == 14 - len(offset_3x3),
              f"knobs: {len(flagged)} K1 convs with offset-grid 3^3 convs "
              f"{offset_3x3}")
        forwards = 2  # val and test, the whole grid of a volume a forward
        t0 = time.perf_counter()
        with _Launches() as counted:
            snap_e, _ = entrance.main(argv + ["--suffix", "knobs_s2d"])
        wall = time.perf_counter() - t0
        launches["brats_knobs_infer_mixed_s2d"] = counted.counts
        check(counted.counts["K2"] == forwards
              and counted.counts["K1"] == len(flagged) * forwards,
              f"knobs infer mixed s2d: launches {counted.counts}, expected 1 "
              f"K2 and {len(flagged)} K1 per forward over {forwards}")
        plain = _plain_val(args, lambda g, v: make_s2d_volume_inferencer(
            g, v, multilabel=True, compute_dtype=torch.bfloat16,
            device="cuda", kernels=plain_s2d(), capture=False),
            os.path.join(work, "brats", "plain_knobs"))
        # K2 sums in float32 on the tensor cores, its plain version in
        # float64: a few bf16 stem outputs round one ulp apart, a code with
        # them, and this tuned random-weight net carries both to the
        # predictions through the stem's 16-level consumer and the residual
        # stream (PERF.md: 1924 outputs and one code apart moved 2.16 % of
        # the voxels; the plain codes alone left 0.71 %, the plain
        # activation alone 1.51 %).  So the path is held where it is exact:
        # K2 within its tolerances of the plain K2 at every stem call of
        # this path, and the path with the plain stem's outputs (K1 and the
        # rest as served) equal to the all-plain path.
        apart = {"y": 0, "q": 0}

        def stem_checked(*a, **k):
            y, q = stem.stem_s2d_conv(*a, **k)
            yp, qp = stem.stem_s2d_conv_reference(*a, **k)
            _check_stem(f"phase 9 (d), {a[6]}-level consumer", y, q, yp, qp,
                        a[5], a[6])
            apart["y"] += int((y != yp).sum())
            apart["q"] += int((q != qp).sum())
            apart["qlvl"] = a[6]
            return yp, qp

        # eager: stem_checked reads the card from the host
        swapped = _plain_val(
            args, lambda g, v: make_s2d_volume_inferencer(
                g, v, multilabel=True, compute_dtype=torch.bfloat16,
                device="cuda", kernels=kernels_with(stem_conv=stem_checked),
                capture=False),
            os.path.join(work, "brats", "plain_stem"))
        for sn, want in plain.items():
            got = _seg(os.path.join(snap_e, "infer", "val", f"{sn}.nii.gz"))
            agree = float(np.mean(got == want))
            print(f"[phase9] (d) infer --deploy mixed --serve_stem s2d "
                  f"--serve_dtype bf16 on that export: {wall:.4f} s, "
                  f"{len(flagged)} K1 convs (14 less the offset-grid 3^3 "
                  f"convs {offset_3x3}), launches {counted.counts} over "
                  f"{forwards} forwards; val {sn} agrees with the same path "
                  f"on the plain K2 and K1 on {agree:.8f} of {got.size} "
                  f"voxels; K2 within its tolerances of the plain K2 at "
                  f"this path's stem ({apart['y']} bf16 outputs one ulp "
                  f"apart, {apart['q']} {apart['qlvl']}-level codes apart); "
                  f"with the plain stem's outputs the path equals the "
                  f"all-plain path: {np.array_equal(swapped[sn], want)}",
                  flush=True)
            check(np.array_equal(swapped[sn], want), "knobs infer mixed "
                  "s2d: the path with the plain stem's outputs != the "
                  "plain path")
        del plain, swapped
        torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
    return launches


FP_CONFIG = os.path.join(HERE, "config", "brats_fp.yaml")
TRAIN_BATCH, TRAIN_PATCH = 4, 128  # the preset's batch and patch
CHECK_BATCH, CHECK_PATCH = 2, 64  # the card-against-CPU step's
TRAIN_STEPS = 6  # timed steps per variant; the median is of steps 2-6


def _train_batch(seed, n, size):
    """``n`` synthetic BraTS patches of size^3 x 4 modalities and their
    multi-label targets, as (N, C, D, H, W) float32 arrays."""
    from efficientq_tpu_torch.data import synthetic
    from efficientq_tpu_torch.data.labels import split_label_brats

    gen = np.random.default_rng(seed)
    subjects = [synthetic.make_subject(gen, "brats", (size,) * 3)
                for _ in range(n)]
    x = np.stack([np.stack(list(img.values())) for img, _ in subjects])
    y = np.stack([split_label_brats(lab) for _, lab in subjects])
    return x, y


def _flagship_trainer(graph, variables, args, n_mo, root, device="cuda",
                      **kw):
    """A Trainer of the FP preset as ``train_fp`` builds it (one step an
    epoch: the schedule's warmup over that step)."""
    from types import SimpleNamespace

    from efficientq_tpu_torch.train import Trainer

    return Trainer(graph, variables, SimpleNamespace(trainloader=[None]),
                   loss_name=args.loss, num_mo=n_mo, n_class=3,
                   base_lr=args.lr, max_epoch=TRAIN_STEPS,
                   snapshot_root=root, multilabel_fusetype=args.merge_type,
                   device=device, **kw)


def _grads(trainer):
    return {k: t.grad.detach().float().cpu() for k, t in
            trainer._leaves.items()}


def _grad_report(got, want):
    """(max over leaves of max|got - want| / max|want|, the three farthest
    leaves as text, the whole gradient's relative L2 distance)."""
    rows = sorted(((float((got[k] - w).abs().max())
                    / max(float(w.abs().max()), 1e-30), k,
                    float(w.abs().max()), float((got[k] - w).abs().max()))
                   for k, w in want.items()), reverse=True)
    num = sum(float((got[k] - w).double().square().sum())
              for k, w in want.items())
    den = sum(float(w.double().square().sum()) for w in want.values())
    return (rows[0][0], ", ".join(f"{k} (max {m:.3e}, gap {d:.3e})"
                                  for _, k, m, d in rows[:3]),
            (num / den) ** 0.5)


def phase10(seed: int, smi: str, work: str, brats):
    """FP training and the quantization-aware fine-tune at full width: the
    train step in four variants, then ``train_fp``, ``ptq --qat_epochs
    1`` and ``infer --deploy int8`` through the CLI on phase 8's BraTS
    set.  Returns {path: {kernel: launches}}."""
    phase10_step(seed, smi, work)
    return phase10_missions(seed, smi, work, brats)


def phase10_step(seed: int, smi: str, work: str):
    """Phase 10 (a): the flagship's train step."""
    import dataclasses

    from efficientq_tpu_torch import nnir, ops
    from efficientq_tpu_torch.cli import definer
    from efficientq_tpu_torch.models import build_uresq

    args = _mission_args(["train_fp", "--round", "1", "--config",
                          FP_CONFIG])
    cfg, _, n_mo = definer.get_model_config(args)
    graph = build_uresq(cfg)
    variables = nnir.init(graph, seed, device="cpu")
    root = os.path.join(work, "train_step")
    x, y = _train_batch(seed, TRAIN_BATCH, TRAIN_PATCH)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    first = {}
    for name, kw in (("float32, TF32 off", dict(tf32=False)),
                     ("float32, TF32 on", dict(tf32=True)),
                     ("--amp", dict(amp=True)),
                     ("--remat 4", dict(remat=4))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = _flagship_trainer(graph, variables, args, n_mo, root, **kw)
        ms, losses = [], []
        for _ in range(TRAIN_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            loss, _ = tr.train_step(xd, yd)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(all(np.isfinite(losses)), f"train step {name}: losses {losses}")
        moved = sum(not torch.equal(tr.variables["state"][n]["mean"].cpu(),
                                    variables["state"][n]["mean"])
                    for n in variables["state"])
        check(moved == len(variables["state"]), f"train step {name}: "
              f"{moved} of {len(variables['state'])} BN running means moved")
        med = statistics.median(ms[1:])
        # one more step in parts: forward and loss, backward, Adam
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with ops.conv_precision(tr.tf32):
            ev[0].record()
            total, _, new_state = tr.forward(xd, yd)
            ev[1].record()
            total.backward()
            ev[2].record()
        tr.update(new_state)
        ev[3].record()
        torch.cuda.synchronize()
        parts = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        first[name] = losses[0]
        print(f"[phase10] (a) on {smi}: train step {name} (batch "
              f"{TRAIN_BATCH} of {TRAIN_PATCH}^3 x 4, full width): "
              f"{med:.4f} ms per optimizer step (median of steps 2-"
              f"{TRAIN_STEPS}; all {[round(v, 4) for v in ms]}), "
              f"{TRAIN_BATCH * 1000 / med:.4f} samples/s, peak device "
              f"memory {peak:.4f} GiB; one step's parts: forward and loss "
              f"{parts[0]:.4f} ms, backward {parts[1]:.4f} ms, clip and "
              f"Adam {parts[2]:.4f} ms; losses {losses}", flush=True)
        del tr, total, new_state
    gap = abs(first["--amp"] - first["float32, TF32 off"]) / abs(
        first["float32, TF32 off"])
    check(gap <= 2e-2, f"train step: the amp loss {first['--amp']} is "
          f"{gap} from the float32 loss {first['float32, TF32 off']}")
    print(f"[phase10] (a) the first step's loss: float32 "
          f"{first['float32, TF32 off']:.7f}, TF32 "
          f"{first['float32, TF32 on']:.7f}, amp {first['--amp']:.7f} "
          f"({gap:.3e} relative, held: 2e-2), remat "
          f"{first['--remat 4']:.7f}", flush=True)

    # the card against the CPU, dropout 0, exact float32: both against the
    # CPU's float64 step, since float32 itself is 1e-4-1e-3 off it here
    # (batch norm's backward over a few hundred voxels at the bottleneck)
    g0 = build_uresq(dataclasses.replace(cfg, drop_rate=0.0))
    v0 = nnir.init(g0, seed, device="cpu")
    x, y = _train_batch(seed + 1, CHECK_BATCH, CHECK_PATCH)
    runs = {}
    for where, device, dtype in (("card", "cuda", torch.float32),
                                 ("host", "cpu", torch.float32),
                                 ("host64", "cpu", torch.float64)):
        v = {grp: {n: {k: t.to(dtype) for k, t in e.items()}
                   for n, e in v0[grp].items()} for grp in ("params", "state")}
        tr = _flagship_trainer(g0, v, args, n_mo, root, device=device,
                               tf32=False)
        loss, _ = tr.train_step(torch.from_numpy(x).to(device, dtype),
                                torch.from_numpy(y).to(device, dtype))
        runs[where] = (float(loss), _grads(tr))
        del tr
    ref = runs["host64"]
    lgap = abs(runs["card"][0] - ref[0]) / abs(ref[0])
    ggap, worst, l2 = _grad_report(runs["card"][1], ref[1])
    l2_host = _grad_report(runs["host"][1], ref[1])[2]
    l2_pair = _grad_report(runs["card"][1], runs["host"][1])[2]
    print(f"[phase10] (a) one step at dropout 0, batch {CHECK_BATCH} of "
          f"{CHECK_PATCH}^3, TF32 off, against the CPU's float64 step: "
          f"loss {runs['card'][0]:.9f} against {ref[0]:.9f} ({lgap:.3e} "
          f"relative, held: 1e-6); the whole gradient {l2:.3e} apart "
          f"(relative L2, held: 1e-3), each leaf within {ggap:.3e} of its "
          f"largest entry (held: 1e-2), farthest: {worst}; the CPU's "
          f"float32 step: loss {runs['host'][0]:.9f}, gradient {l2_host:.3e} "
          f"from float64 and {l2_pair:.3e} from the card's", flush=True)
    check(lgap <= 1e-6 and l2 <= 1e-3 and ggap <= 1e-2, "train step: the "
          "card's step disagrees with the CPU's float64 step")

    # remat against the plain step, dropout 0.5, deterministic cuDNN
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for remat in (0, 4):
            tr = _flagship_trainer(graph, variables, args, n_mo, root,
                                   tf32=False, remat=remat)
            loss, _ = tr.train_step(torch.from_numpy(x).cuda(),
                                    torch.from_numpy(y).cuda())
            runs[remat] = (float(loss), _grads(tr),
                           {n: s["var"].cpu() for n, s in
                            tr.variables["state"].items()})
            del tr
    finally:
        torch.backends.cudnn.deterministic = saved
    ggap, worst, l2 = _grad_report(runs[4][1], runs[0][1])
    print(f"[phase10] (a) remat against plain: the whole gradient {l2:.3e} "
          f"apart (relative L2); farthest leaves: {worst}", flush=True)
    same_state = all(torch.equal(runs[4][2][n], v)
                     for n, v in runs[0][2].items())
    print(f"[phase10] (a) --remat 4 against the plain step (dropout 0.5, "
          f"deterministic cuDNN, batch {CHECK_BATCH} of {CHECK_PATCH}^3): "
          f"losses {runs[4][0]:.7f} and {runs[0][0]:.7f}, BN state "
          f"{'equal' if same_state else 'DIFFERENT'}, gradients at most "
          f"{ggap:.3e} of their leaf's largest entry apart (held: 1e-5)",
          flush=True)
    check(runs[4][0] == runs[0][0] and same_state and ggap <= 1e-5,
          "train step: remat differs from the plain step")
    torch.cuda.empty_cache()


def _train_split(data_dir, root):
    """Round 2 of a split over phase 8's 4 subjects: all 4 train, 1 val, 1
    test."""
    sns = sorted(f[:-4] for f in os.listdir(os.path.join(data_dir, "seg")))
    rdir = os.path.join(root, "split", "round2")
    os.makedirs(rdir)
    for name, lst in (("train.txt", sns), ("val.txt", sns[2:3]),
                      ("test.txt", sns[3:4])):
        with open(os.path.join(rdir, name), "w") as f:
            f.write("\n".join(lst) + "\n")
    return os.path.dirname(rdir)


def phase10_missions(seed: int, smi: str, work: str, brats):
    """Phase 10 (b)-(d): train_fp, ptq --qat_epochs 1 on its checkpoint,
    and infer --deploy int8 on the fine-tuned export."""
    import re

    from efficientq_tpu_torch.cli import entrance
    from efficientq_tpu_torch.eval.sliding import (make_volume_inferencer,
                                                   patch_grid)
    from efficientq_tpu_torch.quant import fake_quant_weight

    launches = {}
    root = os.path.join(work, "training")
    os.makedirs(root)
    data_dir = brats["data_dir"]
    cwd = os.getcwd()
    try:
        # (b) train_fp as a user types it
        split_dir = _train_split(data_dir, root)
        config = os.path.join(root, "brats_fp.yaml")
        with open(FP_CONFIG) as f:
            text = f.read()
        check("max_epoch: 500" in text, "config/brats_fp.yaml: no "
              "max_epoch: 500 line to shorten")
        with open(config, "w") as f:
            f.write(text.replace("max_epoch: 500", "max_epoch: 4"))
        os.chdir(root)
        t0 = time.perf_counter()
        with _Launches() as counted:
            snap, sec = entrance.main([
                "train_fp", "--round", "2", "--config", config, "--data_dir",
                data_dir, "--split_dir", split_dir, "--max_epoch", "4",
                "--test_interval", "2", "--tune_serving", "off"])
        wall = time.perf_counter() - t0
        launches["train_fp"] = counted.counts
        for name in ("description.txt", "loss.txt", "seg_metric.txt",
                     "state_0004.pkl", "state_FP.npz"):
            check(os.path.isfile(os.path.join(snap, name)),
                  f"train_fp: {name} missing")
        losses = [float(ln.split(",")[1]) for ln in
                  open(os.path.join(snap, "loss.txt")).read().splitlines()]
        check(bool(losses) and all(np.isfinite(losses)),
              f"train_fp: loss.txt {losses}")
        csv = open(os.path.join(snap, "seg_metric.txt")).read().splitlines()
        check(len(csv) == 3, f"train_fp: seg_metric.txt has {len(csv)} "
              f"lines, expected the validations of epochs 1, 2 and 4")
        for split in ("val", "test"):
            nums = _metric_numbers(os.path.join(snap, "seg_0004",
                                                f"{split}_seg.txt"))
            check(bool(nums) and all(np.isfinite(nums)),
                  f"train_fp: seg_0004/{split}_seg.txt not finite")
        host = sec["train_data"] / (sec["train_data"] + sec["steps"])
        parts = ", ".join(f"{k} {v:.4f} s" for k, v in sec.items())
        print(f"[phase10] (b) on {smi}: train_fp --config brats_fp.yaml "
              f"(max_epoch 4) --round 2 (4 train subjects of {VOL_SHAPE}, "
              f"batch 4, balance crops of 128^3) --test_interval 2: "
              f"{wall:.4f} s: {parts}; the train loop waited for batches "
              f"{host:.4f} of its time (train_data / (train_data + steps)); "
              f"loss.txt {losses}; the files and finite seg_0004 metrics "
              f"written", flush=True)

        # (c) ptq --qat_epochs 1 on (b)'s checkpoint
        ckpt = os.path.join(snap, "state_0004.pkl")
        common = ["--qlvl_w", "4", "--qlvl_a", "4", "--round", "1",
                  "--config", os.path.join(HERE, "config", "brats_ptq.yaml"),
                  "--data_dir", data_dir, "--split_dir", brats["split_dir"],
                  "--tune_serving", "off"]
        t0 = time.perf_counter()
        with _Launches() as counted:
            snap_c, sec = entrance.main([
                "ptq", *common, "--pretrain", ckpt, "--qat_epochs", "1",
                "--loss", "bhybrid", "--no_test"])
        wall = time.perf_counter() - t0
        launches["ptq_qat"] = counted.counts
        lines = open(os.path.join(snap_c, "qat", "qat_loss.txt")) \
            .read().splitlines()
        pat = re.compile(r"^epoch (0 \(pure PTQ\):|1: loss \S+) val_dice "
                         r"\d+\.\d{6}(  <- kept)?$")
        check(len(lines) == 2 and all(pat.match(ln) for ln in lines)
              and sum(ln.endswith("<- kept") for ln in lines) == 1,
              f"ptq --qat_epochs 1: qat_loss.txt {lines}")
        with open(os.path.join(snap_c, "layer_loss.txt")) as f:
            layer = [float(ln.rsplit(":", 1)[1])
                     for ln in f.read().splitlines()]
        check(len(layer) == 22 and all(np.isfinite(layer)),
              f"ptq --qat_epochs 1: layer losses {layer}")
        with open(os.path.join(snap_c, "state_in_fp.pkl"), "rb") as f:
            sd = pickle.load(f)["state_dict"]
        off = 0
        for name, (qlvl_w, _) in sd["__qlvl_overrides__"].items():
            if qlvl_w > 0:
                w = torch.from_numpy(sd[f"{name}.weight"])
                a = torch.as_tensor(sd[f"{name}.alpha_w"])
                off += int((fake_quant_weight(w, a, qlvl_w) != w).sum())
        check(off == 0, f"ptq --qat_epochs 1: {off} exported weights off "
              f"their grids")
        parts = ", ".join(f"{k} {v:.4f} s" for k, v in sec.items())
        print(f"[phase10] (c) ptq --config brats_ptq.yaml --qat_epochs 1 "
              f"--loss bhybrid --no_test on (b)'s state_0004.pkl: "
              f"{wall:.4f} s: {parts}; qat_loss.txt: {' | '.join(lines)}; "
              f"22 finite layer losses; every exported kernel on its grid",
              flush=True)

        # (d) infer --deploy int8 on the fine-tuned export
        export = os.path.join(snap_c, "state_in_int8.pkl")
        n_patches = len(patch_grid(VOL_SHAPE, PATCH, OVERLAP))
        forwards = 2 * -(-n_patches // min(n_patches, 8))  # val + test
        argv = ["infer", *common, "--pretrain", export, "--save_nii",
                "--deploy", "int8"]
        t0 = time.perf_counter()
        with _Launches() as counted:
            snap_d, _ = entrance.main(argv + ["--suffix", "qat"])
        wall = time.perf_counter() - t0
        launches["qat_infer_int8"] = counted.counts
        check(counted.counts["K1"] == 14 * forwards,
              f"infer on the QAT export: launches {counted.counts}, "
              f"expected {14 * forwards} K1 over {forwards} forwards")
        plain = _plain_val(_mission_args(argv), lambda g, v:
                           make_volume_inferencer(
                               g, patch_batch=min(n_patches, 8),
                               mode="quantized", hard_pred=True,
                               multilabel=True,
                               kernels=plain_direct(), capture=False),
                           os.path.join(root, "plain_int8"))
        for sn, want in plain.items():
            got = _seg(os.path.join(snap_d, "infer", "val", f"{sn}.nii.gz"))
            check(np.array_equal(got, want), f"infer on the QAT export: {sn} "
                  f"differs from validate_seg on the plain K1")
        print(f"[phase10] (d) infer --deploy int8 on (c)'s fine-tuned "
              f"export: {wall:.4f} s, launches {counted.counts} over "
              f"{forwards} patch-batch forwards (14 K1 each); the saved val "
              f"prediction equals validate_seg of the same graph on the "
              f"plain K1", flush=True)
        del plain
        torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
    return launches


def profile_stream(served, s2d_preds):
    """Phase 8 (f): phase 8's stream under the profiler on both paths:
    device busy time, idle share, and how much of the host-to-device
    copies ran while a kernel ran on the compute stream."""
    from torch.profiler import ProfilerActivity

    for path, stem_kind, refs in (("int8 float32", "direct", served["preds"]),
                                  ("s2d bf16", "s2d", s2d_preds)):
        with tempfile.TemporaryDirectory() as d:
            trace = os.path.join(d, "trace.json")
            with torch.profiler.profile(
                    activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
                _, _, wall, _, _ = _stream(served, stem_kind, refs)
            prof.export_chrome_trace(trace)
            st = trace_stats(trace, wall)
        print(f"[profile] stream of {STREAM_VOLUMES} volumes, {path} path: "
              f"wall {wall:.3f} ms under the profiler, device busy "
              f"{st['busy_ms']:.3f} ms (idle share {st['idle_share']:.4f}); "
              f"host-to-device copies {st['h2d_ms']:.3f} ms "
              f"({st['h2d_copies']} copies), of which "
              f"{st['h2d_under_kernels_ms']:.3f} ms "
              f"({st['h2d_overlap_share']:.4f}) ran while a kernel ran on "
              f"the compute stream (stream {st['compute_stream']})",
              flush=True)


def _device_busy(fn):
    """(wall ms, device busy ms, idle share, kernels seen) of one call of
    ``fn`` under torch.profiler: busy is the union of the CUDA events'
    intervals (kernels, copies, memsets, inside CUDA graphs too)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    iv = [(e.time_range.start, e.time_range.end) for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(b - a for a, b in _union(iv)) / 1e3
    return wall, busy, max(0.0, 1 - busy / wall), len(iv)


def _rates(paths, vols, rounds=2):
    """Volumes/s of each path over ``vols``, timed in turns in one call
    (a, b, b, a per round), the median of the rounds: {name: vps}."""
    names = list(paths)
    got = {k: [] for k in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for v in vols:
                paths[name](v)
            torch.cuda.synchronize()
            got[name].append(len(vols) / (time.perf_counter() - t0))
    return {k: statistics.median(v) for k, v in got.items()}


LITS_PATCH, LITS_OVERLAP = (128, 128, 64), (16, 16, 16)  # the LiTS task's
LITS_STREAM = 6  # phase 11 (g)'s volumes
LITS_DEPTHS = (64, 256)  # the range of their depths, drawn from --seed


def phase11(seed: int, smi: str, served, s2d_infer, s2d_preds, work: str,
            brats):
    """The serving extras on the flagship: (a) the captured int8 float32
    and s2d bf16 paths, (b) the column grid, (c) the autotuner, (d)
    serving artifacts through the CLI, (e) an exported include_1x1 graph;
    the captured path under (f) per-set scoring and (g) a LiTS stream of
    varied depths.  Returns {path: {kernel: launches}}."""
    from efficientq_tpu_torch import export as X
    from efficientq_tpu_torch import nnir, ops
    from efficientq_tpu_torch.cli import entrance
    from efficientq_tpu_torch.eval import autotune
    from efficientq_tpu_torch.eval.sliding import (
        column_grid_plan, make_volume_inferencer, patch_grid)
    from efficientq_tpu_torch.kernels import qconv3d as K
    from efficientq_tpu_torch.kernels import qmatmul as KM
    from efficientq_tpu_torch.models import (build_uresq, min_input_divisor,
                                             preset_config)
    from efficientq_tpu_torch.ptq.deploy import make_s2d_volume_inferencer
    from efficientq_tpu_torch.ptq.tune import sweep_tail_alpha

    dev = torch.device("cuda")
    dgraph, variables = served["dgraph"], served["net"].variables
    vols = [v.to(dev) for v in served["vols"]]
    host = [v.numpy() for v in served["vols"]]
    final = slice(-1, None)
    kw = dict(patch_batch=N_BATCH, mode="quantized", heads=final,
              hard_pred=True, multilabel=True)
    n_patches = len(patch_grid(VOL_SHAPE, PATCH, OVERLAP))
    forwards = -(-n_patches // N_BATCH)
    launches = {}

    # (a) the captured paths against phases 2 and 4's eager ones
    cap = make_volume_inferencer(dgraph, **kw)
    with _Launches() as counted:
        preds = [cap(variables, v, PATCH, OVERLAP) for v in vols]
        torch.cuda.synchronize()
    launches["captured_int8_f32"] = counted.counts
    check(counted.counts["K1"] == 14 * 3 * forwards,
          f"(a) captured int8: launches {counted.counts}, expected "
          f"{14 * 3 * forwards} K1")
    for i, (got, want) in enumerate(zip(preds, served["preds"])):
        check(torch.equal(got, want), f"(a) captured int8: volume {i + 1} "
              f"differs from phase 2's eager prediction")
    s2d_cap = make_s2d_volume_inferencer(dgraph, variables, multilabel=True,
                                         heads=final, device=dev)
    with _Launches() as counted:
        preds = [s2d_cap(None, v, PATCH, OVERLAP) for v in host]
        torch.cuda.synchronize()
    launches["captured_s2d_bf16"] = counted.counts
    check(counted.counts["K2"] == 3 and counted.counts["K1"] == 42,
          f"(a) captured s2d: launches {counted.counts}, expected 3 K2 and "
          f"42 K1 (one forward a volume)")
    for i, (got, want) in enumerate(zip(preds, s2d_preds)):
        check(torch.equal(got, want), f"(a) captured s2d: volume {i + 1} "
              f"differs from phase 4's eager prediction")
    rates = _rates({
        "int8 eager": lambda v: served["infer"](variables, v, PATCH,
                                                OVERLAP),
        "int8 captured": lambda v: cap(variables, v, PATCH, OVERLAP)},
        vols[1:])
    rates.update(_rates({
        "s2d eager": lambda v: s2d_infer(None, v, PATCH, OVERLAP),
        "s2d captured": lambda v: s2d_cap(None, v, PATCH, OVERLAP)},
        host[1:]))
    idle = {name: _device_busy(lambda: fn(vols[1]))
            for name, fn in (("int8 eager", lambda v: served["infer"](
                                  variables, v, PATCH, OVERLAP)),
                             ("int8 captured", lambda v: cap(
                                 variables, v, PATCH, OVERLAP)))}
    print(f"[phase11] (a) on {smi}: the captured int8 float32 path equals "
          f"phase 2's eager one on 3 volumes (launches "
          f"{launches['captured_int8_f32']}), the captured s2d bf16 path "
          f"phase 4's (launches {launches['captured_s2d_bf16']}); "
          f"volumes/s over volumes 2-3 in turns, median of 2 rounds: "
          + ", ".join(f"{k} {v:.4f}" for k, v in rates.items())
          + "; one volume under the profiler, device busy of wall (idle "
          "share, CUDA events seen): "
          + ", ".join(f"{k} {b:.3f} of {w:.3f} ms ({i:.4f}, {n})"
                      for k, (w, b, i, n) in idle.items()), flush=True)
    del preds
    torch.cuda.empty_cache()

    # (b) the column grid on phase 2's volumes
    div = min_input_divisor(preset_config("brats", quantize=True))[0]
    depth, cpatch, cover = column_grid_plan(VOL_SHAPE, PATCH, OVERLAP, div)
    n_cols = len(patch_grid((depth, *VOL_SHAPE[1:]), cpatch, cover))
    ckw = dict(kw, patch_batch=n_cols, serve_grid="column", stride_div=div)
    shapes = set()

    def k1_checked(*a, **k):
        y = K.qconv3x3_int8_ndhwc(*a, **k)
        r = K.qconv3x3_int8_ndhwc_reference(*a, **k)
        for g, w in zip(y if k.get("pool") else (y,),
                        r if k.get("pool") else (r,)):
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"(b) K1 != plain K1 at {tuple(a[0].shape)} -> "
                  f"{a[1].shape[-1]}")
        shapes.add((tuple(a[0].shape[1:4]), a[0].shape[-1], a[1].shape[-1]))
        return y

    checked = make_volume_inferencer(
        dgraph, kernels=kernels_with(conv3x3_int8=k1_checked), capture=False,
        **ckw)(
        variables, vols[0], PATCH, OVERLAP)
    plain = make_volume_inferencer(
        dgraph, kernels=plain_direct(), capture=False, **ckw)(
        variables, vols[0], PATCH, OVERLAP)
    col = make_volume_inferencer(dgraph, **ckw)
    with _Launches() as counted:
        cpreds = [col(variables, v, PATCH, OVERLAP) for v in vols]
        torch.cuda.synchronize()
    launches["column_int8_f32"] = counted.counts
    check(counted.counts["K1"] == 14 * 3,
          f"(b) column: launches {counted.counts}, expected 14 K1 a volume "
          f"(its {n_cols} columns in one forward)")
    check(torch.equal(checked, plain) and torch.equal(cpreds[0], plain),
          "(b) the column path differs from the same path on the plain K1")
    agree = float((cpreds[0] == served["preds"][0]).float().mean())
    crates = _rates({
        "patch grid": lambda v: cap(variables, v, PATCH, OVERLAP),
        "column grid": lambda v: col(variables, v, PATCH, OVERLAP)},
        vols[1:])
    print(f"[phase11] (b) on {smi}: column plan D {VOL_SHAPE[0]} -> "
          f"{depth}, {n_cols} columns of {cpatch} (overlap {cover}) in one "
          f"forward, {n_cols * depth * cpatch[1] * cpatch[2]} voxels of "
          f"forward work against the patch grid's "
          f"{n_patches * PATCH[0] * PATCH[1] * PATCH[2]}; K1 == plain K1 "
          f"(torch.equal) at every conv of the column forward: "
          f"{sorted(shapes)}; the column path equals the same path on the "
          f"plain K1; launches {counted.counts}; volume 1 agrees with the "
          f"patch grid on {agree:.8f} of {plain.numel()} voxel-classes "
          f"(printed, not held: other context at the D edges, random "
          f"weights); captured volumes/s over volumes 2-3 in turns: "
          + ", ".join(f"{k} {v:.4f}" for k, v in crates.items()),
          flush=True)
    del checked, plain, cpreds, col
    torch.cuda.empty_cache()

    # (c) the autotuner: a sweep, then a hit on its disk cache
    saved = os.environ.get("EFFQ_TUNE_CACHE")
    os.environ["EFFQ_TUNE_CACHE"] = os.path.join(work, "tune_phase11.json")
    try:
        autotune._MEM_CACHE.clear()
        t0 = time.perf_counter()
        pb = autotune.choose_patch_batch(dgraph, variables, vols[0], PATCH,
                                         OVERLAP, mode="quantized",
                                         heads=final, tune="auto")
        sweep = time.perf_counter() - t0
        autotune._MEM_CACHE.clear()
        with _Launches() as counted:
            t0 = time.perf_counter()
            again = autotune.choose_patch_batch(
                dgraph, variables, vols[0], PATCH, OVERLAP, mode="quantized",
                heads=final, tune="auto")
            hit = time.perf_counter() - t0
        with open(os.environ["EFFQ_TUNE_CACHE"]) as f:
            entries = len(json.load(f))
    finally:
        if saved is None:
            os.environ.pop("EFFQ_TUNE_CACHE", None)
        else:
            os.environ["EFFQ_TUNE_CACHE"] = saved
    check(pb in autotune._candidates(n_patches) and again == pb
          and not any(counted.counts.values()) and entries == 1,
          f"(c) autotuner: chose {pb}, then {again} with launches "
          f"{counted.counts}; {entries} cache entries")
    print(f"[phase11] (c) on {smi}: choose_patch_batch(tune='auto') swept "
          f"{autotune._candidates(n_patches)} in {sweep:.4f} s and chose "
          f"{pb}; the second call read the disk cache in {hit:.6f} s with no "
          f"launch", flush=True)
    torch.cuda.empty_cache()

    # (d) artifacts through the CLI on phase 8's export
    cwd = os.getcwd()
    tmp = os.path.join(work, "brats")
    os.chdir(tmp)
    try:
        base = ["infer", *brats["common"], "--save_nii", "--patch_batch",
                "8"]
        seconds = {}
        for name, flags, zipname in (
                ("int8", ["--deploy", "int8"], "serving_artifact.zip"),
                ("s2d", ["--deploy", "mixed", "--serve_stem", "s2d",
                         "--serve_dtype", "bf16"],
                 "serving_artifact_s2d.zip")):
            t0 = time.perf_counter()
            snap, sec = entrance.main(base + flags + [
                "--pretrain", brats["export"], "--export_artifact",
                "--suffix", f"export_{name}"])
            seconds[name] = (sec["export_artifact"],
                             time.perf_counter() - t0)
            path = os.path.join(snap, zipname)
            check(os.path.isfile(path), f"(d) {zipname} not written")
            with _Launches() as counted:
                served_snap, _ = entrance.main(base + [
                    "--artifact", path, "--suffix", f"artifact_{name}"])
            launches[f"artifact_{name}"] = counted.counts
            want = {"K1": 28, "K2": 2 if name == "s2d" else 0}
            check(all(counted.counts[k] == n for k, n in want.items()),
                  f"(d) artifact {name}: launches {counted.counts}, "
                  f"expected {want} (one forward a volume, val and test)")
            ref = brats["snap_int8" if name == "int8" else "snap_s2d"]
            for split in ("val", "test"):
                for f in sorted(os.listdir(os.path.join(ref, "infer",
                                                        split))):
                    a = _seg(os.path.join(served_snap, "infer", split, f))
                    b = _seg(os.path.join(ref, "infer", split, f))
                    same = float(np.mean(a == b))
                    print(f"[phase11] (d) infer --artifact {zipname}: "
                          f"{split} {f} agrees with phase 8's "
                          f"{'(c)' if name == 'int8' else '(d)'} on "
                          f"{same:.8f} of {a.size} voxels", flush=True)
                    if name == "int8":
                        check(np.array_equal(a, b), f"(d) artifact int8: "
                              f"{split} {f} != phase 8 (c)")
                    else:
                        check(same >= AGREE_S2D, f"(d) artifact s2d: "
                              f"{split} {f} {same} < {AGREE_S2D}")
    finally:
        os.chdir(cwd)
    print(f"[phase11] (d) on {smi}: export seconds (and the whole infer "
          f"--export_artifact run): "
          + ", ".join(f"{k} {e:.4f} ({w:.4f})"
                      for k, (e, w) in seconds.items())
          + f"; artifact runs' launches int8 {launches['artifact_int8']}, "
          f"s2d {launches['artifact_s2d']}; the int8 artifact's predictions "
          f"equal phase 8 (c)'s, the s2d artifact's (float32 head, as the "
          f"JAX package's) agree with phase 8 (d)'s (bfloat16 head) on >= "
          f"{AGREE_S2D}", flush=True)
    torch.cuda.empty_cache()

    # (e) one patch batch of the exported include_1x1 graph (phase 6 (a))
    pg = KM.to_pallas_inference(dgraph, include_1x1=True)
    t0 = time.perf_counter()
    ep, batch = X.export_patch_model(pg, variables, PATCH, 4, patch_batch=2,
                                     device=dev)
    secs = time.perf_counter() - t0
    x = vols[0][:, :PATCH[0], :PATCH[1], :PATCH[2]].expand(
        2, -1, -1, -1, -1).contiguous()
    module = ep.module()
    # as nnir.apply runs it: float32 convs exact (TF32 off)
    with torch.inference_mode(), ops.exact_f32():
        with _Launches() as counted:
            got = module(x)
            torch.cuda.synchronize()
        want = nnir.apply(pg, variables, x, mode="quantized", heads=final)
    launches["export_include_1x1"] = counted.counts
    check(counted.counts["K1"] == 14 and counted.counts["K3"] == 6
          and torch.equal(got, want),
          f"(e) exported include_1x1: launches {counted.counts}, equal "
          f"{torch.equal(got, want)}")
    print(f"[phase11] (e) on {smi}: the include_1x1 int8 graph exported "
          f"(batch {batch}) in {secs:.4f} s; one batch of 2 patches equals "
          f"its eager forward (torch.equal), launches {counted.counts}",
          flush=True)
    del module, ep, got, want, cap, s2d_cap
    torch.cuda.empty_cache()

    # (f) per-set scoring: the tail clip sweep's five variable sets, each
    # scored on one calibration-sized crop through one inferencer, as the
    # ptq mission's tuning scorer does, eager against captured in turns
    crop = vols[0][:, 13:141, 24:216, 24:216].contiguous()
    skw = dict(kw, patch_batch=2)
    n_chunks = -(-len(patch_grid(tuple(crop.shape[1:4]), PATCH,
                                 OVERLAP)) // 2)
    per_set = {"eager": [], "captured": []}
    scores, captures = {}, 0
    for name in ("eager", "captured", "captured", "eager"):
        score_infer = make_volume_inferencer(
            dgraph, capture=name == "captured", **skw)

        def score(v):  # a number read back, as a dice score is
            return float(score_infer(v, crop, PATCH, OVERLAP).float().mean())

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, info = sweep_tail_alpha(dgraph, variables, score)
        check(len(info["scores"]) == 5, f"(f) sweep scored {info['scores']}")
        per_set[name].append((time.perf_counter() - t0) / 5)
        scores.setdefault(name, info["scores"])
        if name == "captured":
            captures = score_infer.captured.captures
    check(scores["eager"] == scores["captured"] and captures == 5,
          f"(f) per-set scoring: eager {scores['eager']}, captured "
          f"{scores['captured']}, {captures} captures (expected 5)")
    print(f"[phase11] (f) on {smi}: the tail clip sweep's 5 variable sets "
          f"each scored on a {tuple(crop.shape[1:4])} crop ({n_chunks} "
          f"chunks of 2 patches) through one inferencer, equal scores; "
          f"seconds per set, eager {per_set['eager']}, captured "
          f"{per_set['captured']} (a pass each, in turns; {captures} "
          f"captures a captured pass)", flush=True)
    del crop, score_infer
    torch.cuda.empty_cache()

    # (g) a LiTS stream of varied depths on the LiTS preset (random
    # weights): captured against eager
    lg, lv = deploy_served(*post_ptq_weights(
        build_uresq(preset_config("lits", quantize=True)), seed + 11))
    lv = nnir.to_device(lv, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    depths = [int(z) for z in np.random.default_rng(seed + 11).integers(
        LITS_DEPTHS[0], LITS_DEPTHS[1] + 1, LITS_STREAM)]
    lvols = [torch.randn((1, *LITS_VOL[:2], z, 1), generator=gen,
                         device=dev) for z in depths]
    lkw = dict(patch_batch=8, mode="quantized", heads=final, hard_pred=True,
               multilabel=False)
    grids = [len(patch_grid(tuple(v.shape[1:4]), LITS_PATCH, LITS_OVERLAP))
             for v in lvols]
    eager_l = make_volume_inferencer(lg, capture=False, **lkw)
    cap_l = make_volume_inferencer(lg, **lkw)
    passes = {}
    for name, fn in (("eager", eager_l), ("captured", cap_l)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _Launches() as counted:
            preds = [fn(lv, v, LITS_PATCH, LITS_OVERLAP) for v in lvols]
            torch.cuda.synchronize()
        # reserved: a graph's private pool is reserved, not allocated
        passes[name] = (preds, counted.counts,
                        torch.cuda.max_memory_allocated() / 2 ** 30,
                        torch.cuda.max_memory_reserved() / 2 ** 30)
    launches["captured_lits_varied_depth"] = passes["captured"][1]
    check(passes["captured"][1] == passes["eager"][1]
          and all(torch.equal(a, b) for a, b in zip(passes["eager"][0],
                                                    passes["captured"][0]))
          and cap_l.captured.captures == 1,
          f"(g) LiTS stream: launches eager {passes['eager'][1]}, captured "
          f"{passes['captured'][1]}; {cap_l.captured.captures} captures")
    lrates = _rates({
        "eager": lambda v: eager_l(lv, v, LITS_PATCH, LITS_OVERLAP),
        "captured": lambda v: cap_l(lv, v, LITS_PATCH, LITS_OVERLAP)},
        lvols)
    print(f"[phase11] (g) on {smi}: a LiTS stream of {LITS_STREAM} volumes "
          f"{LITS_VOL[:2]} x depths {depths} (seed {seed + 11}; patches "
          f"{grids}, chunks of 8, ragged last chunks "
          f"{[g % 8 for g in grids]}) on the LiTS preset's int8 deployment: "
          f"captured equals eager on every volume, launches "
          f"{passes['captured'][1]} (the eager pass's), "
          f"{cap_l.captured.captures} capture in all (the ragged chunks ran "
          f"eagerly); peak device memory allocated (reserved) eager "
          f"{passes['eager'][2]:.4f} ({passes['eager'][3]:.4f}) GiB, "
          f"captured {passes['captured'][2]:.4f} "
          f"({passes['captured'][3]:.4f}) GiB; volumes/s over the stream in "
          f"turns, median of 2 rounds: "
          + ", ".join(f"{k} {v:.4f}" for k, v in lrates.items()),
          flush=True)
    del lvols, passes, eager_l, cap_l, lv
    torch.cuda.empty_cache()
    return launches


# the LiTS serving graph's five upsamples at a chunk of LITS_BATCH
# patches of 128 x 128 x 64 (phase 12): (input shape, factors, channels
# first, with the skip); the head as the direct path serves it (NDHWC) and
# as the s2d path does (NCDHW)
K5_SHAPES = {
    "TransUp5": ((LITS_BATCH, 4, 4, 4, 256), (2, 2, 2), False, True),
    "TransUp6": ((LITS_BATCH, 8, 8, 8, 128), (2, 2, 2), False, True),
    "TransUp7": ((LITS_BATCH, 16, 16, 16, 64), (2, 2, 2), False, True),
    "TransUp8": ((LITS_BATCH, 32, 32, 32, 32), (2, 2, 2), False, True),
    "head": ((LITS_BATCH, 64, 64, 64, 3), (2, 2, 1), False, False),
    "head_ncdhw": ((LITS_BATCH, 3, 64, 64, 64), (2, 2, 1), True, False),
}


def plain_k5(*args, **kw):
    """K5's plain version (``F.interpolate``, then the add), the
    ``upsample`` entry of the plain networks' kernel record."""
    from efficientq_tpu_torch.kernels import upsample

    return upsample.upsample_trilinear3d_reference(*args, **kw)


def kernels_with(**entries):
    """The port's kernel record (``efficientq_tpu_torch/kernels``): the
    wrappers, with ``entries`` in their place."""
    from efficientq_tpu_torch.kernels import WRAPPERS

    return WRAPPERS._replace(**entries)


def plain_direct():
    """The record of the plain direct networks: K1 and K5 plain."""
    from efficientq_tpu_torch.kernels import qconv3d

    return kernels_with(conv3x3_int8=qconv3d.qconv3x3_int8_ndhwc_reference,
                        upsample=plain_k5)


def plain_s2d():
    """The record of the plain s2d networks: K1, K2 and K5 plain."""
    from efficientq_tpu_torch.kernels import stem

    return plain_direct()._replace(stem_conv=stem.stem_s2d_conv_reference)


def phase12(seed: int, smi: str):
    """K5 against its plain version: (a) at the LiTS chunk's five
    upsamples, outputs identical (torch.equal) on normal inputs, and K5's
    time beside the byte bound, the plain version's and ``F.interpolate``
    plus the add on PyTorch's own NCDHW layout; (b) a 256 x 256 x 128 LiTS
    volume through the main path (``validate._build_infer``, captured) on
    the LiTS preset's int8 deployment: 5 K5 launches a chunk, and the
    prediction and one chunk's logits identical to the plain network's
    (the same path with K5's plain version).  Returns (numbers,
    {path: launches})."""
    import torch.nn.functional as F

    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.eval.sliding import (make_volume_inferencer,
                                                   patch_grid)
    from efficientq_tpu_torch.eval.validate import _build_infer
    from efficientq_tpu_torch.kernels import build
    from efficientq_tpu_torch.kernels import qconv3d as K1
    from efficientq_tpu_torch.kernels import upsample as K5
    from efficientq_tpu_torch.models import build_uresq, preset_config
    from efficientq_tpu_torch.ptq import to_int8_inference
    from efficientq_tpu_torch.ptq.deploy import upsample_serving

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    K5._lib()
    print(f"[phase12] built K5 ({K5_SOURCE}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in _ptxas_lines(build.build_log.get("upsample3d.cu")):
        print(f"[phase12] K5 ptxas: {line}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    keys = ("ms", "graph_ms", "plain_ms", "graph_plain_ms", "library_ms",
            "graph_library_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    shapes, max_err = {}, 0.0
    for name, (shape, f, cf, with_skip) in K5_SHAPES.items():
        x = torch.randn(shape, generator=gen, device=dev)
        want = K5.upsample_trilinear3d_reference(x, f, None, cf)
        skip = (torch.randn(want.shape, generator=gen, device=dev)
                if with_skip else None)
        if skip is not None:
            want = want + skip
        got = K5.upsample_trilinear3d(x, f, skip, cf)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want),
              f"K5 {name} {shape} x {f}: max |K5 - plain| {err}")
        # PyTorch's own layout for F.interpolate: NCDHW, contiguous
        xc = (x if cf else x.permute(0, 4, 1, 2, 3)).contiguous()
        sc = (None if skip is None else
              skip.permute(0, 4, 1, 2, 3).contiguous())
        size = tuple(e * k for e, k in zip(xc.shape[2:], f))

        def k5():
            return K5.upsample_trilinear3d(x, f, skip, cf)

        def plain():
            return K5.upsample_trilinear3d_reference(x, f, skip, cf)

        def library():
            y = F.interpolate(xc, size=size, mode="trilinear",
                              align_corners=False)
            return y if sc is None else y + sc

        nbytes = 4 * (x.numel() + got.numel() * (2 if with_skip else 1))
        row = dict(ms=_median_ms(k5), graph_ms=_graph_ms(k5),
                   plain_ms=_median_ms(plain), graph_plain_ms=_graph_ms(plain),
                   library_ms=_median_ms(library),
                   graph_library_ms=_graph_ms(library),
                   bound_ms=nbytes / HBM_BPS * 1e3)
        shapes[name] = row
        if name != "head_ncdhw":  # the chunk's five: the direct path's head
            for k in keys:
                tot[k] += row[k]
        share = 100 * row["bound_ms"] / row["graph_ms"]
        print(f"[phase12] K5 {name} {shape} x {f}"
              f"{' + skip' if with_skip else ''}: equals its plain version; "
              f"device {row['graph_ms']:.4f} ms ({share:.1f} % of the "
              f"bound {row['bound_ms']:.4f}, {nbytes / 1e6:.1f} MB), with the "
              f"host {row['ms']:.4f}; plain {row['graph_plain_ms']:.4f}; "
              f"F.interpolate NCDHW + add {row['graph_library_ms']:.4f}",
              flush=True)
        del x, skip, got, want, xc, sc
    print(f"[phase12] on {smi}: the LiTS chunk's five upsamples ({LITS_BATCH} "
          f"patches): K5 device {tot['graph_ms']:.4f} ms "
          f"({tot['graph_ms'] / LITS_BATCH:.4f} a patch, "
          f"{100 * tot['bound_ms'] / tot['graph_ms']:.1f} % of the bound "
          f"{tot['bound_ms']:.4f}); plain {tot['graph_plain_ms']:.4f} "
          f"({tot['graph_plain_ms'] / LITS_BATCH:.4f} a patch); "
          f"F.interpolate + add {tot['graph_library_ms']:.4f}", flush=True)
    torch.cuda.empty_cache()

    # (b) the main path on a LiTS volume, K5 against the plain network
    dg, dv = to_int8_inference(*post_ptq_weights(
        build_uresq(preset_config("lits", quantize=True)), seed + 12))
    dv = nnir.to_device(dv, dev)
    vol = torch.randn((1, *LITS_VOL, 1), generator=gen, device=dev)
    chunks = -(-len(patch_grid(LITS_VOL, LITS_PATCH, LITS_OVERLAP))
               // LITS_BATCH)
    infer = _build_infer(
        dg, dv, vol, LITS_PATCH, LITS_OVERLAP, mode="quantized",
        patch_batch="auto", multilabel=False, compute_dtype=None,
        serve_stem="direct", heads=slice(-1, None), device=dev,
        tune_serving="off")
    infer(dv, vol, LITS_PATCH, LITS_OVERLAP)  # captures the full chunks
    torch.cuda.synchronize()
    K5.upsample_trilinear3d.launches = 0
    k1_counts = ("launches", "prologue_quant_launches", "overlapped_launches")
    k1 = [getattr(K1.qconv3x3_int8_ndhwc, k) for k in k1_counts]
    pred = infer(dv, vol, LITS_PATCH, LITS_OVERLAP)
    torch.cuda.synchronize()
    launches = K5.upsample_trilinear3d.launches
    check(launches == 5 * chunks,
          f"LiTS main path: K5 launched {launches} times, expected "
          f"{5 * chunks} ({chunks} chunks)")
    k1 = tuple(getattr(K1.qconv3x3_int8_ndhwc, k) - b
               for k, b in zip(k1_counts, k1))
    n_patches = len(patch_grid(LITS_VOL, LITS_PATCH, LITS_OVERLAP))
    overlapped = sum(LITS_OVERLAPPED[min(LITS_BATCH, n_patches - i)]
                     for i in range(0, n_patches, LITS_BATCH))
    check(k1 == (18 * chunks, 9 * chunks, overlapped),
          f"LiTS main path: K1 launched {k1[0]} times, {k1[1]} of them "
          f"quantizing a float input, {k1[2]} on the overlapped pipeline; "
          f"expected {18 * chunks}, {9 * chunks} and {overlapped}")
    served = upsample_serving(dg)
    plain = make_volume_inferencer(
        served, patch_batch=LITS_BATCH, mode="quantized",
        heads=slice(-1, None), hard_pred=True,
        kernels=kernels_with(upsample=plain_k5), capture=False)(
        dv, vol, LITS_PATCH, LITS_OVERLAP)
    check(torch.equal(plain, pred),
          "LiTS main path: the prediction differs from the plain network's")
    xb = torch.randn((LITS_BATCH, *LITS_PATCH, 1), generator=gen, device=dev)
    with torch.inference_mode():
        logits = nnir.apply(served, dv, xb, mode="quantized",
                            heads=slice(-1, None))
        plain_logits = nnir.apply(served, dv, xb, mode="quantized",
                                  heads=slice(-1, None),
                                  kernels=kernels_with(upsample=plain_k5))
    check(torch.equal(logits, plain_logits),
          f"LiTS chunk: logits differ from the plain network's by up to "
          f"{float((logits - plain_logits).abs().max())}")
    print(f"[phase12] on {smi}: a {LITS_VOL} LiTS volume through "
          f"_build_infer (captured, {chunks} chunks of {LITS_BATCH}): K5 "
          f"launches {launches}, K1 {k1[0]} ({k1[1]} quantizing their float "
          f"input, the block1 convs; {k1[2]} overlapped_launches); the "
          f"prediction and one chunk's logits equal the plain network's "
          f"(torch.equal)", flush=True)
    del dv, vol, pred, plain, xb, logits, plain_logits, infer
    torch.cuda.empty_cache()
    numbers = dict(max_abs_err=max_err, per_patch_graph_ms=tot["graph_ms"]
                   / LITS_BATCH, **tot, shapes=shapes)
    return numbers, {"lits_int8_f32": launches}


# SegResNet's GroupNorms in a chunk of 8 patches of 128 x 192 x 160
# (phase 13): (shape, how many a forward runs, codes for K1 or the head's
# ReLU'd float32)
SEG_PATCH, SEG_BATCH, SEG_VOL = (128, 192, 160), 8, (155, 240, 240)
K6_SHAPES = {
    "level0": ((SEG_BATCH, 128, 192, 160, 32), 4, True),
    "level1": ((SEG_BATCH, 64, 96, 80, 64), 6, True),
    "level2": ((SEG_BATCH, 32, 48, 40, 128), 6, True),
    "level3": ((SEG_BATCH, 16, 24, 20, 256), 8, True),
    "head": ((SEG_BATCH, 128, 192, 160, 32), 1, False),
}


def phase13(seed: int, smi: str):
    """K6 against its plain version: (a) at SegResNet's GroupNorms in a
    chunk of 8 patches, outputs identical (torch.equal) on normal inputs,
    and K6's device time beside the byte bound, the plain version's and
    ``F.group_norm`` (NCDHW) with the ReLU and the act-quant as torch ops;
    (b) a BraTS study through the main path (``validate._build_infer``,
    captured) on the full-width SegResNet's int8 deployment: 25 K6, 24 K1
    and 3 K5 launches a chunk.  Returns (numbers, {path: launches})."""
    import torch.nn.functional as F

    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.eval.validate import _build_infer
    from efficientq_tpu_torch.kernels import build
    from efficientq_tpu_torch.kernels import groupnorm as K6
    from efficientq_tpu_torch.kernels import qconv3d as K1
    from efficientq_tpu_torch.kernels import upsample as K5
    from efficientq_tpu_torch.models import SegResNetConfig, build_segresnet
    from efficientq_tpu_torch.ptq import to_int8_inference
    from efficientq_tpu_torch.quant import act_codes

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    K6._lib()
    print(f"[phase13] built K6 ({K6_SOURCE}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in _ptxas_lines(build.build_log.get("groupnorm.cu")):
        print(f"[phase13] K6 ptxas: {line}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    alpha = torch.tensor(4.0 / 3.0, device=dev)
    keys = ("graph_ms", "plain_ms", "library_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    shapes = {}
    for name, (shape, count, codes) in K6_SHAPES.items():
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev)
             + torch.randn(c, generator=gen, device=dev))
        gamma = 1 + 0.2 * torch.randn(c, generator=gen, device=dev)
        beta = 0.2 * torch.randn(c, generator=gen, device=dev)
        kw = (dict(quant_alpha=alpha, quant_qlvl=4) if codes
              else dict(relu=True))
        got = K6.group_norm(x, gamma, beta, 8, **kw)
        want = K6.group_norm_reference(x, gamma, beta, 8, **kw)
        check(torch.equal(got, want), f"K6 {name} {shape}: differs from its "
              f"plain version at {int((got != want).sum())} elements")
        del want
        xc = x.permute(0, 4, 1, 2, 3).contiguous()

        def k6():
            return K6.group_norm(x, gamma, beta, 8, **kw)

        def plain():
            return K6.group_norm_reference(x, gamma, beta, 8, **kw)

        def library():
            y = F.relu(F.group_norm(xc, 8, gamma, beta, 1e-5))
            return act_codes(y, alpha, 4) if codes else y

        nbytes = x.numel() * (4 + (1 if codes else 4))
        row = dict(graph_ms=_graph_ms(k6), plain_ms=_median_ms(plain, 1, 3),
                   library_ms=_median_ms(library),
                   bound_ms=nbytes / HBM_BPS * 1e3)
        shapes[name] = row
        for k in keys:
            tot[k] += count * row[k]
        print(f"[phase13] K6 {name} {shape} -> "
              f"{'codes' if codes else 'relu float32'}: equals its plain "
              f"version; device {row['graph_ms']:.4f} ms "
              f"({100 * row['bound_ms'] / row['graph_ms']:.1f} % of the "
              f"bound {row['bound_ms']:.4f}, {nbytes / 1e6:.1f} MB); plain "
              f"{row['plain_ms']:.4f}; F.group_norm NCDHW + relu"
              f"{' + act-quant' if codes else ''} {row['library_ms']:.4f}",
              flush=True)
        del x, xc, got
        torch.cuda.empty_cache()
    print(f"[phase13] on {smi}: the 25 GroupNorms of a SegResNet chunk "
          f"({SEG_BATCH} patches): K6 device {tot['graph_ms']:.4f} ms "
          f"({100 * tot['bound_ms'] / tot['graph_ms']:.1f} % of the bound "
          f"{tot['bound_ms']:.4f}); plain {tot['plain_ms']:.4f}; "
          f"F.group_norm + relu + act-quant {tot['library_ms']:.4f}",
          flush=True)

    # (b) the main path on a BraTS study
    cfg = SegResNetConfig(num_mod=4, num_classes=3, quantize=True, qlvl_w=4,
                          qlvl_act=4, q_first=(256, -1), q_last=(256, -1))
    dg, dv = to_int8_inference(*post_ptq_weights(build_segresnet(cfg),
                                                 seed + 13))
    dv = nnir.to_device(dv, dev)
    vol = torch.randn((1, *SEG_VOL, 4), generator=gen, device=dev)
    infer = _build_infer(
        dg, dv, vol, SEG_PATCH, OVERLAP, mode="quantized",
        patch_batch="auto", multilabel=True, compute_dtype=None,
        serve_stem="direct", heads=slice(-1, None), device=dev,
        tune_serving="off")
    for _ in range(2):  # eager, then captured
        infer(dv, vol, SEG_PATCH, OVERLAP)
    torch.cuda.synchronize()
    counters = (K6.group_norm, K1.qconv3x3_int8_ndhwc,
                K5.upsample_trilinear3d)
    before = [fn.launches for fn in counters]
    prologue = K1.qconv3x3_int8_ndhwc.prologue_quant_launches
    overlapped = K1.qconv3x3_int8_ndhwc.overlapped_launches
    infer(dv, vol, SEG_PATCH, OVERLAP)
    torch.cuda.synchronize()
    launches = [fn.launches - b for fn, b in zip(counters, before)]
    prologue = K1.qconv3x3_int8_ndhwc.prologue_quant_launches - prologue
    overlapped = K1.qconv3x3_int8_ndhwc.overlapped_launches - overlapped
    check(launches == [25, 24, 3] and prologue == 0
          and overlapped == SEG_OVERLAPPED,
          f"SegResNet main path: K6, K1 and K5 launched {launches} times a "
          f"chunk, K1 quantized {prologue} float inputs and took the "
          f"overlapped pipeline {overlapped} times; expected [25, 24, 3], 0 "
          f"(K6 hands K1 its codes) and {SEG_OVERLAPPED}")
    print(f"[phase13] on {smi}: a {SEG_VOL} BraTS study through "
          f"_build_infer (captured, one chunk of {SEG_BATCH}): K6, K1, K5 "
          f"launches {launches}, K1 prologue quantizations {prologue}, K1 "
          f"overlapped_launches {overlapped}", flush=True)
    del dv, vol, infer
    torch.cuda.empty_cache()
    numbers = dict(per_patch_graph_ms=tot["graph_ms"] / SEG_BATCH, **tot,
                   shapes=shapes)
    return numbers, {"segresnet_int8_f32": launches[0]}


K7_SOURCE = "efficientq_tpu_torch/csrc/window_attention.cu"
K7_REPLACES = "none: the JAX package has no attention"
SWIN_PATCH, SWIN_BATCH, SWIN_VOL = (128, 128, 128), 8, (155, 240, 240)
# a 128^3 chunk of SwinUNETR's served graph: K1's 3^3 convs, K3's int8
# 1x1 convs (one launch each), K6's InstanceNorms, K7's blocks
SWIN_LAUNCHES = {"K1": 19, "K3": 46, "K6": 26, "K7": 8}
# K7's windows x heads a patch: stage extents 64, 32, 16, 8 padded to 70,
# 35, 21, 14, so 1000, 125, 27, 8 windows of 3, 6, 12, 24 heads, two
# blocks a stage
SWIN_WINDOW_HEADS = 2 * (1000 * 3 + 125 * 6 + 27 * 12 + 8 * 24)
# K7's stages a patch: (grid extent, heads), each unshifted and shifted by
# 3 (window 7); their tile scores are K7's ``tile_scores``
SWIN_STAGES = ((64, 3), (32, 6), (16, 12), (8, 24))
# cycles the card spins ahead of a timed eager call (about 50 ms): longer
# than the host takes to launch it, its first call's plan included
SPIN_CYCLES = 10 ** 8


def _swin_offset(name):
    """The layers of SwinUNETR that read a LayerNorm's, an attention's or
    a concat's output: on the offset grid."""
    return (name.endswith(("attn.qkv", "attn.proj", "mlp.linear1",
                           "downsample.reduction"))
            or (name.endswith("conv1.conv")
                and not name.startswith("encoder1."))
            or (name.endswith("conv3.conv") and name.startswith("decoder")))


def swin_net(seed: int):
    """The published widths on weights from ``seed``, every quantized
    kernel on its 4-level grid (alpha = max |w|), every activation range
    4/3, the offset-grid layers at k = 1, biases 0.1 N(0, 1): (deployed
    graph, variables) on the CPU."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.models import SwinUNETRConfig, build_model
    from efficientq_tpu_torch.ptq import to_int8_inference
    from efficientq_tpu_torch.quant import fake_quant_weight

    cfg = SwinUNETRConfig(quantize=True, qlvl_w=4, qlvl_act=4,
                          q_first=(256, -1), q_last=(256, -1))
    g = build_model(cfg)
    v = nnir.init(g, seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for node in g.qconv_nodes():
        p = v["params"][node.name]
        q = node.attrs["qcfg"]
        if q.q_weight:
            alpha = torch.clamp_min(p["kernel"].abs().max(), 1e-8)
            p["kernel"] = fake_quant_weight(p["kernel"], alpha, q.qlvl_w)
            p["alpha_w"] = alpha
        p["alpha_act"] = torch.tensor(4.0 / 3.0)
        if _swin_offset(node.name):
            p["act_k"] = torch.tensor(1, dtype=torch.int32)
        if "bias" in p:
            p["bias"] = 0.1 * torch.randn(p["bias"].shape, generator=gen)
    return to_int8_inference(g, v)


def _k7_close(got, want):
    """(share of elements that differ, K7's tolerance held): K7 and its
    plain version both sum in float64 and round once, so an element
    differs only where a sum straddles a float32 rounding boundary: at
    most one in 10^5, by at most one ulp of the plain value."""
    differ = got != want
    share = float(differ.float().mean())
    ulp = torch.finfo(torch.float32).eps * want[differ].abs()
    return share, share <= 1e-5 and bool(
        ((got - want)[differ].abs() <= ulp).all())


def _swin_costs():
    """Each kernel's (key, bytes, operations, peak) of one call from its
    arguments, as the calls of the served graph pass them."""
    def k1(x, w, *a, residual=None, quant_qlvl=0, pool=False, **kw):
        n, d, h, wd, c = x.shape
        o, vox = w.shape[-1], n * d * h * wd
        nbytes = (x.numel() * x.element_size() + w.numel()
                  + vox * o * (1 if quant_qlvl else 4))
        if residual is not None:
            nbytes += residual.numel() * residual.element_size()
        key = (f"{d}^3 x {c} -> {o}"
               f"{' float in' if x.is_floating_point() else ''}"
               f"{' quant' if quant_qlvl else ''}"
               f"{' residual' if residual is not None else ''}"
               f", k {kw.get('act_k', 0)}")
        return key, nbytes, 2 * vox * 27 * c * o, INT8_OPS

    def k3(x, w, bias, *a, **kw):
        (m, k), n = x.shape, w.shape[1]
        key = f"{m} x {k} -> {n}, k {kw.get('act_k', 0)}"
        return (key, x.numel() * x.element_size() + w.numel() + m * n * 4,
                2 * m * k * n, INT8_OPS)

    def k6(x, gamma, beta, groups, eps=1e-5, relu=False, quant_alpha=None,
           quant_qlvl=0):
        key = (f"{x.shape[1]}^3 x {x.shape[-1]}"
               f"{' -> codes' if quant_qlvl else ''}")
        return (key, x.numel() * (x.element_size() + (1 if quant_qlvl
                                                      else 4)), 0, INT8_OPS)

    def k7(qkv, table, bias, heads, window, shift):
        n, d, h, w, c3 = qkv.shape
        tokens, c = n * d * h * w, c3 // 3
        # QK^T and AV of every query of the unpadded grid against the 343
        # keys of its window
        flops = 4 * tokens * c * 343
        return (f"{d}^3 x {c}, {heads} heads, shift {shift[0]}",
                tokens * (c3 + c) * 4 + table.numel() * 4, flops, FP32_OPS)

    return {"K1": k1, "K3": k3, "K6": k6, "K7": k7}


def phase14(seed: int, smi: str):
    """SwinUNETR's kernels on the cell's chunk: (a) one 128^3 chunk of 8
    through the served graph (``serving_graph``), eagerly, each K1, K3, K6
    and K7 call checked against its plain version on the same inputs (K1,
    K3 and K6 ``torch.equal``; K7 within its tolerance, ``_k7_close``) and
    timed (events around the call), beside its bound; (b) a BraTS study
    through the main path (``validate._build_infer``, captured): 19 K1, 46
    K3, 26 K6 and 8 K7 launches a chunk, 8 x 8532 window-heads, K7's
    ``tile_scores`` of the chunk's eight attentions.  Returns
    (numbers, {kernel: launches a chunk})."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.eval.validate import _build_infer
    from efficientq_tpu_torch.kernels import REFERENCES, WRAPPERS, build
    from efficientq_tpu_torch.kernels import groupnorm as K6
    from efficientq_tpu_torch.kernels import qconv3d as K1
    from efficientq_tpu_torch.kernels import qmatmul as K3
    from efficientq_tpu_torch.kernels import window_attention as K7
    from efficientq_tpu_torch.ops import layer_norm
    from efficientq_tpu_torch.ptq.deploy import serving_graph

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    K6._lib()
    K7._lib()
    print(f"[phase14] built K6 ({K6_SOURCE}) and K7 ({K7_SOURCE}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in _ptxas_lines(build.build_log.get("window_attention.cu")):
        print(f"[phase14] K7 ptxas: {line}", flush=True)
    dg, dv = swin_net(seed + 14)
    dv = nnir.to_device(dv, dev)

    # (a) every kernel call of one chunk against its plain version
    fields = {"K1": "conv3x3_int8", "K3": "int8_matmul", "K6": "group_norm",
              "K7": "window_attention"}
    costs = _swin_costs()
    rows, failures = {}, []

    def checked(kernel):
        fast = getattr(WRAPPERS, fields[kernel])
        plain = getattr(REFERENCES, fields[kernel])

        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            # the card spins while the host launches, so the events time
            # the kernel alone
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            got = fast(*args, **kw)
            end.record()
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            if kernel == "K7":
                share, ok = _k7_close(got, want)
            else:
                share = float((got != want).float().mean())
                ok = torch.equal(got, want)
            key, nbytes, ops, peak = costs[kernel](*args, **kw)
            row = rows.setdefault((kernel, key), dict(
                calls=0, ms=0.0, bound_ms=0.0, differ=0.0, equal=True))
            row["calls"] += 1
            row["ms"] += start.elapsed_time(end)
            row["bound_ms"] += _bound(nbytes, ops, peak)[0]
            row["differ"] = max(row["differ"], share)
            row["equal"] = row["equal"] and ok
            if not ok:
                failures.append(f"{kernel} {key}: {share:.3g} of its "
                                f"outputs differ from its plain version")
            del want
            return got

        return call

    record = WRAPPERS._replace(**{fields[k]: checked(k) for k in fields})
    sg = serving_graph(dg)
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    x = torch.randn((SWIN_BATCH, *SWIN_PATCH, 4), generator=gen, device=dev)
    with torch.inference_mode():
        logits = nnir.apply(sg, dv, x, mode="quantized", kernels=record)
    check(bool(torch.isfinite(logits).all()),
          "SwinUNETR chunk: non-finite logits")
    del x, logits
    torch.cuda.empty_cache()
    calls = {k: sum(r["calls"] for (kk, _), r in rows.items() if kk == k)
             for k in fields}
    tot = {k: dict(ms=sum(r["ms"] for (kk, _), r in rows.items() if kk == k),
                   bound_ms=sum(r["bound_ms"] for (kk, _), r in rows.items()
                                if kk == k)) for k in fields}
    for (kernel, key), r in sorted(rows.items()):
        print(f"[phase14] {kernel} {key}: {r['calls']} call(s), "
              f"{'equal to' if kernel != 'K7' else 'within tolerance of'} "
              f"its plain version: {r['equal']} (differ {r['differ']:.3g});"
              f" {r['ms']:.4f} ms (device), bound_ms "
              f"{r['bound_ms']:.4f} ({100 * r['bound_ms'] / r['ms']:.1f} %)",
              flush=True)
    for k in fields:
        print(f"[phase14] on {smi}: {k} over one chunk of {SWIN_BATCH} "
              f"patches of {SWIN_PATCH}: {calls[k]} calls, "
              f"{tot[k]['ms']:.4f} ms, bound_ms {tot[k]['bound_ms']:.4f} "
              f"({100 * tot[k]['bound_ms'] / tot[k]['ms']:.1f} %)",
              flush=True)
    check(not failures, "; ".join(failures[:8]))
    check(calls == SWIN_LAUNCHES, f"SwinUNETR chunk: kernel calls {calls}, "
          f"expected {SWIN_LAUNCHES}")

    # (b) the main path on a BraTS study
    vol = torch.randn((1, *SWIN_VOL, 4), generator=gen, device=dev)
    infer = _build_infer(
        dg, dv, vol, SWIN_PATCH, OVERLAP, mode="quantized",
        patch_batch="auto", multilabel=True, compute_dtype=None,
        serve_stem="direct", heads=slice(-1, None), device=dev,
        tune_serving="off")
    for _ in range(2):  # eager, then captured
        infer(dv, vol, SWIN_PATCH, OVERLAP)
    torch.cuda.synchronize()
    counters = {"K1": (K1.qconv3x3_int8_ndhwc, "launches"),
                "K3": (K3.fused_int8_matmul, "launches"),
                "K6": (K6.group_norm, "launches"),
                "K7": (K7.window_attention, "launches"),
                "window_heads": (K7.window_attention, "window_heads"),
                "tile_scores": (K7.window_attention, "tile_scores"),
                "group_norm.elements": (K6.group_norm, "elements"),
                "layer_norm.elements": (layer_norm, "elements")}
    for fn, attr in counters.values():  # counted from 0 around one study
        setattr(fn, attr, 0)
    infer(dv, vol, SWIN_PATCH, OVERLAP)
    torch.cuda.synchronize()
    counts = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    launches = {k: counts[k] for k in SWIN_LAUNCHES}
    print(f"[phase14] on {smi}: a {SWIN_VOL} BraTS study through "
          f"_build_infer (captured, one chunk of {SWIN_BATCH}): {counts}",
          flush=True)
    scores = sum(K7.tile_scores((e,) * 3, (7,) * 3, (sh,) * 3, SWIN_BATCH, h)
                 for e, h in SWIN_STAGES for sh in (0, 3))
    check(launches == SWIN_LAUNCHES
          and counts["window_heads"] == SWIN_BATCH * SWIN_WINDOW_HEADS
          and counts["tile_scores"] == scores,
          f"SwinUNETR main path: {counts}, expected {SWIN_LAUNCHES}, "
          f"{SWIN_BATCH * SWIN_WINDOW_HEADS} window-heads and {scores} "
          f"tile scores")
    del dv, vol, infer
    torch.cuda.empty_cache()
    numbers = {f"{k}_{m}": tot[k][m] for k in fields for m in tot[k]}
    numbers["shapes"] = {f"{k} {key}": r for (k, key), r in rows.items()}
    return numbers, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="profile one volume of each serving path, the "
                    "calibration and phase 8's stream")
    ap.add_argument("--ab", action="store_true",
                    help="run phases 0, 2, 4 and 7 alone, with no result "
                    "line (to compare two trees in one call)")
    ap.add_argument("--serving-extras", action="store_true",
                    help="run phases 0, 2, 4, 8 and 11 alone, with no "
                    "result line")
    ap.add_argument("--swinunetr", action="store_true",
                    help="run phases 0 and 14 alone, with no result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; nothing was run")
    smi = setup()
    if args.swinunetr:
        phase14(args.seed, smi)
        return
    if args.ab:
        _, served = phase2(args.seed)
        phase4(args.seed, served)
        phase7(args.seed, smi, served["vols"][0], served["subjects"][0][1],
               torch.device("cuda"))
        return
    if args.serving_extras:
        _, served = phase2(args.seed)
        _, _, s2d_infer, s2d_preds = phase4(args.seed, served)
        work = tempfile.mkdtemp(prefix="effq_smoke_")
        os.environ["EFFQ_TUNE_CACHE"] = os.path.join(work, "tune.json")
        try:
            _, brats = phase8(args.seed, smi, served, s2d_preds, work)
            phase11(args.seed, smi, served, s2d_infer, s2d_preds, work,
                    brats)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return
    max_err, ms, plain_ms = phase1(args.seed)
    lits = k1_lits(args.seed)
    float_input = k1_float_input(args.seed, smi)
    k1_f32, served = phase2(args.seed)
    p3 = phase3(args.seed)
    # phase 4 runs the s2d path eagerly: phase 11 (a) holds the captured
    # path against it
    k1_s2d, k2, s2d_infer, s2d_preds = phase4(args.seed, served)
    p5 = phase5(args.seed)
    paths, k3_infer, mixed_infer = phase6(args.seed, served, s2d_preds)
    calibrated = phase7(args.seed, smi, served["vols"][0],
                        served["subjects"][0][1], torch.device("cuda"))
    # phases 8 to 11 write their datasets (and the autotuner its cache)
    # here; removed at the end
    work = tempfile.mkdtemp(prefix="effq_smoke_")
    os.environ["EFFQ_TUNE_CACHE"] = os.path.join(work, "tune.json")
    try:
        missions, brats = phase8(args.seed, smi, served, s2d_preds, work)
        extensions = phase9(args.seed, smi, work, brats)
        training = phase10(args.seed, smi, work, brats)
        extras = phase11(args.seed, smi, served, s2d_infer, s2d_preds, work,
                         brats)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    k5, k5_paths = phase12(args.seed, smi)
    k6, k6_paths = phase13(args.seed, smi)
    k7, swin = phase14(args.seed, smi)
    if args.profile:
        profile_paths(served, s2d_infer, k3_infer, mixed_infer)
        profile_calibration(args.seed)
        # last: a profiler session after one that exported a Chrome trace
        # recorded no host-to-device copies (PERF.md §7)
        profile_stream(served, s2d_preds)
    # launches of each kernel on each serving path, counted from 0 around
    # the path's run
    by_path = {"K1": {"int8_f32": k1_f32, "s2d_bf16": k1_s2d},
               "K2": {"s2d_bf16": k2}, "K3": {}, "K4": {},
               "K5": {"int8_f32": served["k5"], **k5_paths},
               "K6": k6_paths, "K7": {}}
    for kernel, n in swin.items():
        by_path[kernel]["swinunetr_int8_f32"] = n
    names = {"a": "int8_f32_include_1x1", "b": "s2d_bf16_include_1x1",
             "c": "mixed_s2d_include_1x1", "d": "fq_patch"}
    for path, counts in paths.items():
        for kernel, n in counts.items():
            if n:
                by_path[kernel][names[path]] = n
    for path, counts in [*calibrated.items(), *missions.items(),
                         *extensions.items(), *training.items(),
                         *extras.items()]:
        for kernel, n in counts.items():
            if n:
                by_path[kernel][path] = n

    def entry(kernel, name, source, replaces, numbers):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(by_path[kernel].values()),
                "launches_by_path": by_path[kernel], **numbers}

    # K1's numbers: one forward's 14 convs at the s2d path's batch and
    # bfloat16 (phase 3); phase 1's float32 N = 2 forward beside them.
    # K3's and K4's: one forward's six 1x1 convs at B = 8 and bfloat16
    # input (phase 5), the B = 2 float32 forward beside them.
    # K1's LiTS numbers (phase 1): one LiTS forward's 18 convs at N = 8,
    # 16 levels, float32 output, as lits_* keys.  K5's (phase 12): the sums
    # over one LiTS chunk's five upsamples at N = 8, and each shape's.  K6's
    # (phase 13): the sums over one SegResNet chunk's 25 GroupNorms.  K7's
    # (phase 14): the sums over one SwinUNETR chunk's 8 blocks, with every
    # SwinUNETR kernel's per shape.
    k1 = dict(p3["k1"], max_abs_err=max(max_err, p3["k1"]["max_abs_err"],
                                        lits["lits_max_abs_err"]),
              n2_f32_ms=ms, n2_f32_plain_ms=plain_ms, **lits,
              lits_block1_float_input=float_input)
    print(json.dumps({"kernels": [
        entry("K1", "qconv3x3_int8_ndhwc", K1_SOURCE, K1_REPLACES, k1),
        entry("K2", "stem_s2d_conv", K2_SOURCE, K2_REPLACES, p3["k2"]),
        entry("K3", "fused_int8_matmul", K3_SOURCE, K3_REPLACES, p5["k3"]),
        entry("K4", "fused_qact_matmul", K4_SOURCE, K4_REPLACES,
              p5["k4"]),
        entry("K5", "upsample_trilinear3d", K5_SOURCE, K5_REPLACES, k5),
        entry("K6", "group_norm", K6_SOURCE, K6_REPLACES, k6),
        entry("K7", "window_attention", K7_SOURCE, K7_REPLACES, k7)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
