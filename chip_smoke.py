#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds and runs on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --train-config-steps 200

The second form runs only the committed v2 synthetic training config as
committed (``time_train_config``) and prints its timing; the first runs
every phase below.  ``--only v4 dispnetc data_parallel`` runs those phases
alone.

Runs on one NVIDIA Hopper card (it exits non-zero at once without CUDA) and
imports nothing of JAX.  Phases, each timed after ``torch.cuda.synchronize()``:

1. build: compile ``realtime_stereo_matcher_tpu_torch/csrc/*.cu`` with nvcc.
2. kernels: every hand-written kernel against its plain PyTorch version at
   every distinct shape of the 720p v1 path, in float32 and bfloat16, then
   timed at its largest shape beside the plain version, one cuDNN call
   (``library_ms``) and the card's bound.
   The bf16 32 -> 32 stride-1 K1 and the bf16 32 -> 32 K3 run on the
   tensor cores (``csrc/conv_tc.cuh``): they are also held to their plain
   versions at the 32 -> 32 shapes of the training steps (forward, and dx
   with the flipped, transposed weights) and at ragged shapes, and timed at
   every dilation of the 720p frame and at the training volumes; their rows
   also give ``device_ms``, the same calls queued behind a device sleep
   (``time_ms(..., queued=True)``), so that the events read device time
   alone.  So do the bf16 32 -> 32 stride-2 convs, K2 (3x3) and K2-4x4
   (``csrc/conv_s2_tc.cuh``), checked also on ragged batches and timed at
   their other 720p levels, and K4 (``csrc/dw_tc.cuh``), timed at every
   dilation and at the v2 / v3 shapes.
3. train kernels: K4 (``dw_reduce``, 2D and 3D) and the channel pairs the
   backward adds to K1 and K3, against their plain versions at every shape
   of the 4 x 480 x 640 training step, float32 and bfloat16; the
   tensor-core K4 (bf16 32 -> 32) also at the v2 / v3 shapes and ragged
   ones, each launched twice for the same bits; K4 timed beside its plain
   version and one cuDNN weight-gradient call.
4. autograd: ``flat_conv3x3`` and ``flat_conv3d`` backward (dx, dW) against
   the plain backward of the same functions, float32 and bfloat16.
4a. narrow kernels: the narrow channel pairs, bf16 on the tensor cores
   (K1 stride 1 at 1 / 3 / 4 / 7 -> 32 and 32 -> 1 / 4 / 7,
   ``csrc/conv_narrow_tc.cuh``; K4 at 4 / 7 -> 32 and 32 -> 1, 2D and 3D,
   ``csrc/dw_tc.cuh``; K2 stride 2 at 3 -> 32, ``csrc/conv_s2_tc.cuh``; K3
   at 32 -> 1 and 1 -> 32, ``csrc/conv3d_narrow_tc.cuh``), against their
   plain versions at every frame and training shape of v1 / v2 / v3 and at
   ragged ones, float32 and bf16, each K4 launched twice for the same bits;
   then every narrow pair timed at its largest launch beside its plain
   version, one cuDNN call and the bound, with ``device_ms``.  After the
   last timed phase (10b): ``narrow routes``, one v1 and v3 frame and one v1
   and v2 training step under the profiler, which must show every narrow
   pair of those paths on the tensor cores and none on the CUDA cores;
   ``K7 profile``, K7's device time by the profiler; and ``augment
   profile``, the device ms and launches of a step's resident fetch and
   augmentation (phase 10b) by the profiler.  They come last because a
   profiler session can slow the host's launches for the rest of the
   process.
5. model: v1 from ``configure/stereo_net_config.json`` with seeded weights
   and BatchNorm stats; the float32 kernel path against the plain float32
   model at 1280x720, the bf16 kernel path (the inference main path) with
   launch counts, then 8 stereo pairs through
   ``realtime_stereo_matcher_tpu_torch.bench``.
6. v3: the kernels of the v3 path (K2-4x4 and K1 3 -> 32, and K1's other
   v3 epilogues) against their plain versions at every distinct shape of
   the 720p v3 frame, float32 and bfloat16; K2-4x4 and the 3 -> 32 stem
   timed beside their plain versions, one cuDNN call and the bound; v3 from
   ``configure/stereo_net_config_v3.json`` with seeded weights: its float32
   kernel path against the plain float32 model with the same banded warp at
   1280x720, each refine level's largest flow against its warp band, the
   bf16 kernel path (the v3 inference main path) with launch counts, then 8
   pairs through ``bench.run_bench(model="v3")``.
7. train: the reference training config (batch 4, 480 x 640 crops of seeded
   synthetic scenes) from ``create_train_state``; the first step's float32
   kernel-path loss, gradients and BatchNorm updates against the float32
   plain step, its bf16 gradients too, then ``train()`` on the kernel path
   in bf16 (the training main path) for 2 warm-up and 8 timed steps, with
   launch counts per step and step times by CUDA events.
8. v2 kernels: the channel pairs v2 adds (K1 7 -> 32 at the 720p refine
   levels; K1 32 -> 7 and K4 7 -> 32 at the 8 x 240 x 320 training levels)
   and K7 ``conv3x3_s2`` (forward, dx and dW at (4, 240, 320, 32)) against
   their plain versions, float32 and bfloat16, then timed by CUDA events
   beside the plain version, one cuDNN call and the bound (its device time
   by the profiler waits for the ``K7 profile`` phase).
9. v2 model and v2 bench: v2 from ``configure/stereo_net_config_v2.json``
   as v3 in phase 6: the float32 kernel path against the plain float32 v2
   with the same banded warp at 1280x720, the bf16 kernel path (the v2
   inference main path) with launch counts, 8 pairs through
   ``bench.run_bench(model="v2")``.
10. train v2, train v3: phase 7 on each repo config's own train section
    (batch 8, 240 x 320).  The plain step warps with the kernel path's
    band (``banded_warp=True``): at the train-start init the flows run far
    past the band, where the unbanded warp still samples the image.
10a. eval: the trained v2 and v3 (``realtime_stereo_matcher_tpu_torch/
    weights/``, loaded by ``models/checkpoint.py``, each built from the
    config ``weights/held_out.json`` names).  For each, the evaluation
    entry point ``evaluate.main`` on its config's test set (the 40
    held-out synthetic scenes at 320 x 448) with the bf16 kernel path, the
    main path, its launches counted from 0 (every forward, the latency's
    included); then ``validate_synthetic`` with the bf16 kernel path, the
    float32 kernel path and the plain float32 model (unbanded, as the JAX
    package's Flax).  Held: the plain EPE within 1e-3 px and D1 within
    0.05 points of the JAX package's (``held_out.json``); the float32
    kernel path within rtol 1e-3 / atol 5e-2 of the banded plain model on
    the first three scenes, and its EPE within 0.01 px of the plain EPE;
    the bf16 EPE at most 0.05 px and its D1 at most 2 points above the
    plain ones; v2 also at the padded KITTI shape 384 x 1280 (a synthetic
    scene), float32 kernel path against the banded plain model.
10b. train config: ``configure/stereo_net_v2_synthetic_config.json``
    through the train entry point ``train_stereo.main`` at its full width
    and train section (batch 8, 240 x 320 crops of 320 x 448 scenes, bf16,
    the kernel train path, ``device_augment``), its one cut 512 scenes
    (``synthetic_512``, 0.59 GB resident) for its 4000, for 99 steps: the
    resident path taken, every step's launches those of the v2 kernel step
    (``LAUNCHES_PER_STEP``: the augmentation adds no hand-written kernel),
    the losses finite, the metric log's rows those of the JAX package's
    logger; ``apply_augment`` on the card against the same call on the CPU
    (images within 1e-2 levels, flow within 1e-4 px, valid equal); resume
    at an epoch boundary (64 scenes, an epoch of 8 batches): step 8 resumed
    from the checkpoint of step 8 gives the uninterrupted run's augmented
    batch bit for bit and its loss within 1e-3 relative; the pack's seconds
    and GB, and the step median with the resident fetch and augmentation
    and without them (pre-made batches), printed beside the ``nvidia-smi``
    name and power limit.
10c. v4, dispnetc: the two families without a kernel path (none in the
    JAX package either), each from its repo config
    (``configure/stereo_net_config_v4.json``, ``disp_net_c_config.json``)
    and its trained weights (``held_out.json``): ``evaluate.main`` on the
    40 held-out scenes (the plain forward, bf16 autocast: the main path)
    and the plain float32 model, held to the JAX package's EPE within 1e-4
    px and D1 within 0.01 points, bf16 to float32 within 0.05 px and 0.2
    points, with FPS; a seeded float32 forward (the train-start init) at
    128 x 192 on the card against the CPU, median |d| under 1e-3 px; 1280
    x 720 frames of the trained model, float32 and bf16, min and median
    over 8 after 2 by CUDA events, bf16 within 1 px median of float32; the
    first training step at the config's train section (V4 at batch 2: its
    CPU steps at 6 take minutes) on the card against the CPU's float64
    step, float64 within 1e-4 (loss), 1e-3 (gradients, relative L2) and
    1e-4 (running stats), float32 within those or 16 x the float32 floor
    (the CPU's float32 step, the card's on the batch reversed: a float32
    step of these models amplifies rounding); ``train()`` in bf16 at the
    train section, step median and min over 8 after 2; the committed
    synthetic config through ``train_stereo.main`` (64 scenes resident),
    20 steps, its metric log and a falling or flat loss.  No hand-written
    kernel may launch in either phase (``python3 chip_smoke.py --only v4
    dispnetc`` runs these phases alone).
10d. data parallel (``--only data_parallel`` runs it alone): two ranks,
    each a process of this script (``--dp-rank``) started with its
    ``RSM_*`` env vars by ``parallel.distributed.spawn_ranks``, over NCCL
    with a card a rank or over gloo where they share one card (the
    backend and each rank's device are printed); the kernels are built
    once, here, before the ranks start.  (a) v2's repo config (global
    batch 8, 240 x 320, 4 a rank, train-start init, one seeded batch): the
    first float32 and bf16 kernel-path steps on the ranks against the same
    step in this process on the global batch: loss within 1e-5 and EPE
    within 1e-4 relative, the parameters after the update within rtol 1e-3
    / atol 2e-4 and the running stats within rtol 1e-4 / atol 1e-5 (the
    JAX package's tolerances for its sharded step; bf16 may stray 6 x as
    far as this process's bf16 step does on the batch reordered three ways,
    which moves only the order of its float32 sums, as the ranks do: this
    process's bf16 step with every conv run on the two halves of its batch,
    the ranks' conv batch, must give its loss, EPE and running stats bit
    for bit), the gradients by the train phases' rule (in bf16 but for
    v2's two biases whose gradient is zero by symmetry), the ranks'
    parameters equal; every rank
    launches K1 108 / K3 10 / K4 59 a bf16 step; the bf16 step median on
    the ranks and here; the collective audit of a bf16 step (the gradient
    all-reduce 4 bytes a parameter).  (b) a 1-rank NCCL group through one
    float32 step, equal to this process's step bit for bit (loss, EPE,
    gradients, parameters, running stats, launches; both under
    ``torch.use_deterministic_algorithms``, under which one process
    repeats its step bit for bit; without them two runs of one process
    differ in their gradients, and the count is printed), and its bf16
    step median (one process's work with the DP step's collectives).  (c) the v2 synthetic config
    through ``train_stereo`` on 2 ranks, 512 scenes (256 resident a rank),
    20 steps: every step's launches those of a v2 step, the same losses on
    both ranks, falling, equal final parameter hashes, the step median.
    (d) ``parallel.scaling_bench`` at 720p bf16, 2 frames a rank, at every
    rank count up to the cards of the machine.
11. report: one ``{"kernels": [...]}`` line (each kernel's
    ``launches_by_path`` with ``eval_v2`` / ``eval_v3``, its launches a
    frame of the eval phase, ``train_config_v2``, its launches in the 99
    steps of phase 10b, ``v4`` / ``dispnetc``, 0 in phase 10c, and
    ``data_parallel``, rank 0's in the 20 steps of phase 10d (c)), one
    latency line (the eval metrics under
    ``eval``, phase 10b's under ``train_config_v2``), the ``nvidia-smi``
    name and power limit, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no "ok".
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
import json
import logging
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from realtime_stereo_matcher_tpu_torch import (
    bench,
    evaluate,
    frame_profile,
    train_stereo,
)
from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.data.device_augment import (
    N_UNIFORMS,
    AugmentSpec,
    apply_augment,
    draw_params,
    make_device_augment,
    step_generator,
)
from realtime_stereo_matcher_tpu_torch.data.device_cache import (
    DeviceResidentScenes,
    cache_path,
    pack_synthetic,
)
from realtime_stereo_matcher_tpu_torch.data.synthetic import (
    SyntheticBatches,
    SyntheticStereo,
    make_scene,
)
from realtime_stereo_matcher_tpu_torch.eval import validators
from realtime_stereo_matcher_tpu_torch.kernels import _build
from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    fused_conv3x3,
    fused_conv3x3_plain,
    fused_conv4x4_s2,
    fused_conv4x4_s2_plain,
    output_hw,
)
from realtime_stereo_matcher_tpu_torch.kernels.cost_filter3d import (
    fused_conv3d,
    fused_conv3d_plain,
)
from realtime_stereo_matcher_tpu_torch.kernels.train_conv import (
    conv3x3_s2,
    dw_reduce,
    dw_reduce3d,
    dw_reduce3d_plain,
    dw_reduce_plain,
    flat_conv3x3,
)
from realtime_stereo_matcher_tpu_torch.kernels.train_conv3d import flat_conv3d
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.checkpoint import load_weights
from realtime_stereo_matcher_tpu_torch.models import fast_train
from realtime_stereo_matcher_tpu_torch.models.fast_infer import make_fast_forward
from realtime_stereo_matcher_tpu_torch.models.fast_train import (
    fast_train_forward,
    load_running_stats,
    make_fast_train_step,
    running_stats,
)
from realtime_stereo_matcher_tpu_torch.models.stereo_net import (
    refine_max_shifts,
)
from realtime_stereo_matcher_tpu_torch.parallel.comm_audit import audit
from realtime_stereo_matcher_tpu_torch.parallel.distributed import (
    ENV_PROCESS_ID,
    default_group,
    free_port,
    init_group,
    initialize,
    shutdown,
    spawn_ranks,
)
from realtime_stereo_matcher_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_batch,
)
from realtime_stereo_matcher_tpu_torch.parallel.scaling_bench import (
    scaling_efficiency,
)
from realtime_stereo_matcher_tpu_torch.train import trainer
from realtime_stereo_matcher_tpu_torch.train.loss import build_loss_function
from realtime_stereo_matcher_tpu_torch.train.optim import onecycle_schedule
from realtime_stereo_matcher_tpu_torch.train.trainer import (
    broadcast_state,
    create_train_state,
    restore_checkpoint,
    train,
)
from realtime_stereo_matcher_tpu_torch.utils.logger import setup_basic_logging

SEED = 0
HW = (720, 1280)
# float32: the kernel and the plain version (cuDNN in full float32, TF32
# off) sum the same products in another order
TOL_F32 = (1e-3, 1e-3)  # (atol, rtol)
# bfloat16: the kernel rounds its output to bf16 after the activation, and
# again after the residual (<= 2^-9 relative each); the reference is the
# plain version in float32 on the same bf16-rounded inputs, unrounded
TOL_BF16 = (2e-2, 1e-2)
# K4 sums ~10^6 products per output: its tolerances are relative to the
# output's scale (its largest magnitude), atol * scale + rtol * |ref|
TOL_DW_F32 = (1e-3, 1e-3)
TOL_DW_BF16 = (2e-2, 1e-2)
# launches of one 720p frame on the inference main path
LAUNCHES_PER_FRAME = {"fused_conv3x3": 56, "fused_conv3x3_s2": 6,
                      "fused_conv3d": 5}
# launches of one 720p v3 frame: K1 12 per view in the U-Net and 15 per
# RefineNet, K2-4x4 3 per view, K3 5
LAUNCHES_PER_FRAME_V3 = {"fused_conv3x3": 69, "fused_conv4x4_s2": 6,
                         "fused_conv3d": 5}
# the training main path: reference config, batch 4 at 480 x 640
TRAIN_B, TRAIN_HW = 4, (480, 640)
# v2 and v3 train at their configs' batch 8, 240 x 320
TRAIN_B_V23, TRAIN_HW_V23 = 8, (240, 320)
WARMUP_STEPS, TIMED_STEPS = 2, 8
# launches of one bf16 training step: v1 and v2 K1 54 forward + 54 dx, K3
# 5 + 5, K4 54 2D + 5 3D; v3 K1 39 + 39 (the refines after their plain
# 65-channel entries), K3 5 + 5, K4 39 2D + 5 3D (the U-Net is plain)
LAUNCHES_PER_STEP = {"fused_conv3x3": 108, "fused_conv3d": 10,
                     "dw_reduce": 59}
LAUNCHES_PER_STEP_V3 = {"fused_conv3x3": 78, "fused_conv3d": 10,
                        "dw_reduce": 44}
# K7 conv3x3_s2 at the v1 / v2 encoder's second stride-2 conv of a batch-4
# 480 x 640 step: (4, 240, 320, 32) -> (4, 120, 160, 32)
K7_SHAPE = (4, 240, 320)
# first-step gradients against the float32 plain step: per-parameter
# relative L2 within max(1e-2, 6 x the plain step's own noise floor), the
# rule of tests/test_fast_train.py, the floor measured by running the plain
# step on the batch in reverse order (the same gradient, summed in another
# order); parameters whose gradient norm is < 1e-3 (zero by symmetry, e.g.
# the encoder head bias, which cancels in the difference volume) are
# skipped.  In bf16 the bound is max(5e-2, 3 x the plain step's own bf16
# distance from float32): bf16 itself moves the encoder's gradients by
# 25-75% in the plain (autocast) step, where the features' difference
# volume cancels
GRAD_RTOL_F32, GRAD_F32_FLOOR_SLACK = 1e-2, 6.0
GRAD_RTOL_BF16, GRAD_BF16_FLOOR_SLACK = 5e-2, 3.0
REPLACES = {
    "fused_conv3x3": "realtime_stereo_matcher_tpu/kernels/conv3x3.py:369",
    "fused_conv3x3_s2": "realtime_stereo_matcher_tpu/kernels/conv3x3.py:613",
    "fused_conv4x4_s2": "realtime_stereo_matcher_tpu/kernels/conv3x3.py:700",
    "fused_conv3d": "realtime_stereo_matcher_tpu/kernels/cost_filter3d.py:213",
    "dw_reduce": "realtime_stereo_matcher_tpu/kernels/train_conv.py:141",
    "conv3x3_s2": "realtime_stereo_matcher_tpu/kernels/train_conv.py:401",
}
SOURCES = {
    # the timed bf16 32 -> 32 rows run the tensor-core kernels (entry points
    # in csrc/conv3x3.cu, csrc/conv3d.cu and csrc/dw_reduce.cu)
    "fused_conv3x3": "realtime_stereo_matcher_tpu_torch/csrc/conv_tc.cuh",
    "fused_conv3x3_s2": "realtime_stereo_matcher_tpu_torch/csrc/conv_s2_tc.cuh",
    "fused_conv4x4_s2": "realtime_stereo_matcher_tpu_torch/csrc/conv_s2_tc.cuh",
    "fused_conv3d": "realtime_stereo_matcher_tpu_torch/csrc/conv_tc.cuh",
    "dw_reduce": "realtime_stereo_matcher_tpu_torch/csrc/dw_tc.cuh",
    "conv3x3_s2": "realtime_stereo_matcher_tpu_torch/kernels/train_conv.py",
}
# the design of the kernels that carry the bf16 32 -> 32 calls (the timed
# rows), and of those that carry the bf16 narrow pairs (the "pairs" of K1,
# K2, K3 and K4: their rows name one of the "narrow ..." designs); float32
# stays on the CUDA-core template
TC_DESIGN = {
    "fused_conv3x3": "tensor cores (mma.sync), cp.async",
    "fused_conv3x3_s2": "tensor cores (mma.sync), cp.async, input rows "
                        "staged as column-parity planes",
    "fused_conv4x4_s2": "tensor cores (mma.sync), cp.async, input rows "
                        "staged as column-parity planes",
    "fused_conv3d": "tensor cores (mma.sync), cp.async",
    "dw_reduce": "tensor cores (mma.sync, both operands by ldmatrix.trans), "
                 "cp.async; one partial a block, summed in a fixed order",
    "narrow in": "tensor cores (mma.sync), csrc/conv_narrow_tc.cuh: input "
                 "pixels staged through registers as 16-byte chunks "
                 "(channels padded to 8), taps packed two to a k16 step "
                 "(K = 80), 16-byte staged stores",
    "narrow out": "tensor cores (mma.sync), csrc/conv_narrow_tc.cuh: "
                  "32-channel rows by cp.async, one n8 tile (C_out padded "
                  "to 8), output rows staged compactly",
    "dw narrow x": "tensor cores (mma.sync), csrc/dw_tc.cuh: x staged "
                   "through registers padded to 8 channels, a tap row's 3 "
                   "taps in two m16 tiles, two blocks an SM; one partial a "
                   "block, summed in a fixed order",
    "dw narrow g": "tensor cores (mma.sync), csrc/dw_tc.cuh: g staged "
                   "through registers padded to 8 channels, one n8 tile, two "
                   "blocks an SM; one partial a block, summed in a fixed "
                   "order",
    "narrow s2 in": "tensor cores (mma.sync), csrc/conv_s2_tc.cuh: input "
                    "pixels staged through registers as 8-byte chunks "
                    "(channels padded to 4) in column order, so one 16-byte "
                    "ldmatrix row holds two stride-2 taps and a k16 step a "
                    "kernel row (K = 48), two blocks an SM, 16-byte staged "
                    "stores",
    "narrow 3D out": "tensor cores (mma.sync), csrc/conv3d_narrow_tc.cuh: "
                     "32-channel depth slabs by cp.async, N = (kx, co) "
                     "padded to 8 so one A fragment serves three taps, the "
                     "shifted partial columns summed in the epilogue",
    "narrow 3D in": "tensor cores (mma.sync), csrc/conv3d_narrow_tc.cuh: "
                    "2-byte depth slabs staged through registers, K = the "
                    "27 taps padded to 32, A gathered per lane by 2-byte "
                    "loads, two blocks an SM, 16-byte staged stores"}
# the epilogue each narrow K1 pair has on the model paths
NARROW_ACT = {(4, 32): "relu", (7, 32): "relu", (3, 32): 0.2, (1, 32): "none",
              (32, 1): "none", (32, 4): "none", (32, 7): "none"}
# device clock cycles queued ahead of a device-time run (~50 ms at 1.98 GHz)
SLEEP_CYCLES = 100_000_000
ROOT = pathlib.Path(__file__).resolve().parent
# the trained weights and the JAX package's held-out metrics of each
HELD_OUT = ROOT / "realtime_stereo_matcher_tpu_torch" / "weights" / "held_out.json"
# eval bounds: plain float32 on the card against the JAX package's EPE (px)
# and D1 (points); the float32 kernel path's EPE against the plain one's;
# the bf16 kernel path's EPE and D1 above the plain ones (the TPU's bf16
# gap was ~0.03 px and 0.7-1.4 points; the H100's was -0.008 / 0.00005 px
# and 0.03 / -0.04 points, so D1 is held to five times that); the bf16
# kernel path's median |d| against the banded plain model per scene, as
# ``check_kernel_path`` holds the 720p frames
EVAL_PLAIN_EPE_TOL, EVAL_PLAIN_D1_TOL = 1e-3, 0.05
EVAL_F32_EPE_TOL = 0.01
EVAL_BF16_EPE_GAP, EVAL_BF16_D1_GAP = 0.05, 0.2
EVAL_BF16_MEDIAN_PX = 1.0
# held-out scenes of validate_synthetic (its default, the configs' test
# set); scenes held per pixel against the banded plain model; KITTI 2015's
# 375 x 1242 frames padded to /64
EVAL_SCENES, EVAL_PIXEL_SCENES, KITTI_PADDED_HW = 40, 3, (384, 1280)
EVAL_HW = ((320, 448), KITTI_PADDED_HW)
# the training main path from a committed config: the v2 synthetic config
# through the train entry point, at its full width and train section; its
# one cut, 512 scenes resident (0.59 GB) in place of its 4000 (4.59 GB, ~1
# min of scene generation on the card's host)
TRAIN_CONFIG = ROOT / "configure" / "stereo_net_v2_synthetic_config.json"
TRAIN_CONFIG_DATASETS = ["synthetic_512"]
# 99 steps: the metric logger's first mean row (the trainer's MetricLogger,
# sum_freq 100) falls on step 98
TRAIN_CONFIG_STEPS, METRIC_SUM_FREQ = 99, 100
# resume: 64 scenes, an epoch of 8 batches; the checkpoint of step 8
RESUME_DATASETS, RESUME_STEP = ["synthetic_64"], 8
RESUME_LOSS_RTOL = 1e-3
# the augmentation on the card against the same call on the CPU: images in
# 255 levels, flow in px (float32 means summed in another order)
AUG_TOL_IMG, AUG_TOL_FLOW = 1e-2, 1e-4
# peak memory rate (bytes/s) and dense bf16 tensor-core rate (FLOP/s) from
# NVIDIA's data sheets, by card name; other cards use the H100 SXM row
PEAKS = {"H200": (4.8e12, 989e12), "H100": (3.35e12, 989e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Times a phase to the end of its device work."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            torch.cuda.synchronize()
        log(f"phase {self.name}: {time.perf_counter() - self.t0:.3f} s"
            + (" (failed)" if exc_type else ""))
        return False


# ---------------------------------------------------------------------------
# kernel cases: every distinct (kernel, shape, epilogue) of the 720p v1 path
# ---------------------------------------------------------------------------


def conv3x3_cases(h: int = HW[0], w: int = HW[1]) -> list[dict]:
    """Stride-1 and stride-2 3x3 cases of the v1 path at an h x w input."""
    cases = []
    enc = [(h >> k, w >> k) for k in (1, 2, 3)]         # encoder levels
    for hw in enc:
        for res in (False, True):                       # ResBlock convs
            cases.append(dict(hw=hw, cin=32, cout=32, stride=1, dil=1,
                              act="relu", res=res))
    cases.append(dict(hw=enc[-1], cin=32, cout=32, stride=1, dil=1,
                      act="none", res=False))           # encoder head
    for hw in reversed(enc[:2] + [(h, w)]):             # refine levels
        cases.append(dict(hw=hw, cin=4, cout=32, stride=1, dil=1, act="relu",
                          res=False))                   # entry
        for dil in (1, 2, 4, 8):
            for res in (False, True):
                cases.append(dict(hw=hw, cin=32, cout=32, stride=1, dil=dil,
                                  act="relu", res=res))
        cases.append(dict(hw=hw, cin=32, cout=1, stride=1, dil=1, act="none",
                          res=False))                   # head
    # leaky ReLU: not on the v1 path, but part of the function K1 computes
    cases.append(dict(hw=enc[1], cin=32, cout=32, stride=1, dil=2, act=0.2,
                      res=True))
    cases.append(dict(hw=(h, w), cin=3, cout=32, stride=2, dil=1, act="relu",
                      res=False))
    for hw in enc[:2]:
        cases.append(dict(hw=hw, cin=32, cout=32, stride=2, dil=1, act="relu",
                          res=False))
    unique = []
    for c in cases:
        if c not in unique:
            unique.append(c)
    return unique


def conv3d_cases(h: int = HW[0], w: int = HW[1]) -> list[dict]:
    """The 3x3x3 cases of the v1 cost filter (D = 24 at 1/8 resolution)."""
    vol = (1, 24, h >> 3, w >> 3)
    return [dict(vol=vol, cin=32, cout=32, relu=True),
            dict(vol=vol, cin=32, cout=1, relu=False)]


def _operands(shape_x, shape_w, cout, dtype, device, gen):
    x = (torch.rand(shape_x, generator=gen, device=device) * 2 - 1).to(dtype)
    fan_in = 1
    for s in shape_w[:-1]:
        fan_in *= s
    w = ((torch.rand(shape_w, generator=gen, device=device) * 2 - 1)
         / fan_in ** 0.5).to(dtype)
    scale = torch.rand(cout, generator=gen, device=device) + 0.5
    bias = (torch.rand(cout, generator=gen, device=device) - 0.5) * 0.6
    return x, w, scale, bias


def conv3x3_operands(case, dtype, device, gen):
    h, w = case["hw"]
    x, wt, scale, bias = _operands((1, h, w, case["cin"]),
                                   (3, 3, case["cin"], case["cout"]),
                                   case["cout"], dtype, device, gen)
    s = case["stride"]
    res = None
    if case["res"]:
        res = (torch.rand((1, *output_hw(h, w, s), case["cout"]),
                          generator=gen, device=device) * 2 - 1).to(dtype)
    kw = dict(stride=s, dilation=case["dil"], act=case["act"])
    return (x, wt, scale, bias), kw, res


def conv3d_operands(case, dtype, device, gen):
    args = _operands((*case["vol"], case["cin"]),
                     (3, 3, 3, case["cin"], case["cout"]), case["cout"],
                     dtype, device, gen)
    return args, dict(relu=case["relu"])


def _compare(got, ref, tol, what):
    atol, rtol = tol
    err = (got.float() - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if got.shape != ref.shape or bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {ref.numel()} values out of "
            f"tolerance (atol {atol}, rtol {rtol}), max abs err "
            f"{float(err.max()):.3e}, shapes {tuple(got.shape)} "
            f"{tuple(ref.shape)}")
    return float(err.max())


def check_kernels(device, cases2d, cases3d) -> dict:
    """Each kernel against its plain version, float32 and bf16; returns the
    largest abs error per kernel name and dtype."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst: dict = {}

    def note(name, dtype, err):
        key = (name, "f32" if dtype == torch.float32 else "bf16")
        worst[key] = max(worst.get(key, 0.0), err)

    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for case in cases2d:
            args, kw, res = conv3x3_operands(case, dtype, device, gen)
            got = fused_conv3x3(*args, **kw, residual=res)
            ref = fused_conv3x3_plain(
                *(a.float() for a in args), **kw,
                residual=None if res is None else res.float())
            name = "fused_conv3x3" if case["stride"] == 1 else "fused_conv3x3_s2"
            note(name, dtype, _compare(got, ref, tol, f"{name} {case} {dtype}"))
        for case in cases3d:
            args, kw = conv3d_operands(case, dtype, device, gen)
            got = fused_conv3d(*args, **kw)
            ref = fused_conv3d_plain(*(a.float() for a in args), **kw)
            note("fused_conv3d", dtype,
                 _compare(got, ref, tol, f"fused_conv3d {case} {dtype}"))
        log(f"  {len(cases2d) + len(cases3d)} cases within tolerance in {dtype}")
    return worst


# ---------------------------------------------------------------------------
# timing at the largest main-path shape of each kernel
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 20, warm: int = 3, queued: bool = False
            ) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls.

    Where the host issues a call more slowly than the card runs it, the
    events time the host as well.  ``queued=True`` queues the calls behind a
    ~50 ms device sleep, so that the events read device time alone (a
    tensor-core kernel of tens of microseconds takes about as long on the
    card as its Python wrapper takes on the host)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _tc_times(kernel, library) -> dict:
    """``ms`` and ``library_ms`` as every row reads them, and ``device_ms``:
    the same two with the calls queued (device time alone)."""
    return dict(ms=time_ms(kernel), library_ms=time_ms(library),
                device_ms=dict(ms=time_ms(kernel, queued=True),
                               library_ms=time_ms(library, queued=True)))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(nbytes: int, flops: int, peaks) -> dict:
    """The larger of ``nbytes`` over the memory rate and ``flops`` over the
    bf16 tensor-core rate (ms), and which of the two it is."""
    bw, flops_peak = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, flops / flops_peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def add_bounds(rows: dict, peaks) -> dict:
    """Each row's bound (:func:`bound` of its bytes and operations)."""
    for row in rows.values():
        row.update(bound(row["bytes"], row["flops"], peaks))
    return rows


def time_kernels(device, peaks) -> dict:
    """bf16 timings at each kernel's largest main-path shape."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    rows = {}
    timed = [
        ("fused_conv3x3", dict(hw=HW, cin=32, cout=32, stride=1, dil=1,
                               act="relu", res=True)),
        ("fused_conv3x3_s2", dict(hw=(HW[0] // 2, HW[1] // 2), cin=32,
                                  cout=32, stride=2, dil=1, act="relu",
                                  res=False)),
    ]
    for name, case in timed:
        args, kw, res = conv3x3_operands(case, torch.bfloat16, device, gen)
        x, w = args[0], args[1]
        out = fused_conv3x3(*args, **kw, residual=res)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy
        s, d = case["stride"], case["dil"]
        flops = 2 * out.numel() * 9 * case["cin"]

        def kernel():
            fused_conv3x3(*args, **kw, residual=res)

        def library():
            F.conv2d(x_nchw, w_oihw, stride=s, padding=d, dilation=d)

        times = (_tc_times(kernel, library) if name in TC_DESIGN else
                 dict(ms=time_ms(kernel), library_ms=time_ms(library)))
        rows[name] = dict(
            shape=f"{case['hw'][0]}x{case['hw'][1]} {case['cin']}->"
                  f"{case['cout']} stride {s}" + (" +residual" if res is not None else ""),
            plain_ms=time_ms(lambda: fused_conv3x3_plain(*args, **kw,
                                                         residual=res)),
            **times, bytes=_nbytes(*args, res, out), flops=flops)
    case = conv3d_cases()[0]
    args, kw = conv3d_operands(case, torch.bfloat16, device, gen)
    x, w = args[0], args[1]
    out = fused_conv3d(*args, **kw)
    w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous()
    x_ncdhw = x.permute(0, 4, 1, 2, 3)
    rows["fused_conv3d"] = dict(
        shape=f"{'x'.join(map(str, case['vol']))} {case['cin']}->{case['cout']}",
        plain_ms=time_ms(lambda: fused_conv3d_plain(*args, **kw)),
        **_tc_times(lambda: fused_conv3d(*args, **kw),
                    lambda: F.conv3d(x_ncdhw, w_oidhw, padding=1)),
        bytes=_nbytes(*args, out), flops=2 * out.numel() * 27 * case["cin"])
    return add_bounds(rows, peaks)


# ---------------------------------------------------------------------------
# training kernels: K4 and the channel pairs the backward adds to K1 and K3
# ---------------------------------------------------------------------------


def train_levels(h: int = TRAIN_HW[0], w: int = TRAIN_HW[1]):
    """(refine levels full, 1/2, 1/4; encoder ResBlock levels 1/2 to 1/8)."""
    return [(h >> k, w >> k) for k in (0, 1, 2)], \
        [(h >> k, w >> k) for k in (1, 2, 3)]


def dw_cases() -> list[dict]:
    """Every K4 launch shape of a training step: (hw, cin, cout, dil) in 2D,
    (vol, cin, cout) in 3D."""
    refine, enc = train_levels()
    cases = []
    for hw in refine:
        cases += [dict(hw=hw, cin=32, cout=32, dil=d) for d in (1, 2, 4, 8)]
        cases += [dict(hw=hw, cin=4, cout=32, dil=1),
                  dict(hw=hw, cin=32, cout=1, dil=1)]
    cases += [dict(hw=hw, cin=32, cout=32, dil=1) for hw in enc
              if hw not in refine]
    vol = (24, TRAIN_HW[0] >> 3, TRAIN_HW[1] >> 3)
    cases += [dict(vol=vol, cin=32, cout=32), dict(vol=vol, cin=32, cout=1)]
    return cases


def _compare_scaled(got, ref, tol, what):
    """|got - ref| <= atol * max|ref| + rtol * |ref|; returns the largest
    abs error and that error over max|ref|."""
    atol, rtol = tol
    scale = float(ref.abs().max())
    err = (got.float() - ref).abs()
    bad = err > atol * scale + rtol * ref.abs()
    if got.shape != ref.shape or bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {ref.numel()} values out of "
            f"tolerance (atol {atol} x scale {scale:.3e}, rtol {rtol}), max "
            f"abs err {float(err.max()):.3e}")
    return float(err.max()), float(err.max()) / max(scale, 1e-30)


def _dw_operands(case, dtype, device, gen, batch=TRAIN_B):
    shape = (batch, *case["vol"]) if "vol" in case else (batch, *case["hw"])
    x = (torch.rand((*shape, case["cin"]), generator=gen, device=device)
         * 2 - 1).to(dtype)
    g = (torch.rand((*shape, case["cout"]), generator=gen, device=device)
         * 2 - 1).to(dtype)
    return x, g


def check_train_kernels(device) -> dict:
    """K4 against its plain version at every training shape, and the new K1
    / K3 channel pairs against theirs; returns the largest errors."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    worst: dict = {}

    def note(key, err):
        worst[key] = max(worst.get(key, 0.0), err)

    refine, _ = train_levels()
    for dtype, tol, ktol, tag in ((torch.float32, TOL_DW_F32, TOL_F32, "f32"),
                                  (torch.bfloat16, TOL_DW_BF16, TOL_BF16,
                                   "bf16")):
        for case in dw_cases():
            x, g = _dw_operands(case, dtype, device, gen)
            if "vol" in case:
                got = dw_reduce3d(x, g)
                ref = dw_reduce3d_plain(x.float(), g.float())
            else:
                got = dw_reduce(x, g, case["dil"])
                ref = dw_reduce_plain(x.float(), g.float(), case["dil"])
            err, rel = _compare_scaled(got, ref, tol,
                                       f"dw_reduce {case} {dtype}")
            note(("dw_reduce", tag), err)
            note(("dw_reduce", tag, "over scale"), rel)
        # K1 32 -> 4 and 1 -> 32 (dx of the refine entry and head), K3 1 -> 32
        for hw in refine:
            for cin, cout in ((32, 4), (1, 32)):
                args = _operands((TRAIN_B, *hw, cin), (3, 3, cin, cout), cout,
                                 dtype, device, gen)
                got = fused_conv3x3(*args, act="none")
                ref = fused_conv3x3_plain(*(a.float() for a in args),
                                          act="none")
                note(("fused_conv3x3", tag), _compare(
                    got, ref, ktol, f"fused_conv3x3 {hw} {cin}->{cout} "
                    f"{dtype}"))
        case = dict(vol=(TRAIN_B, 24, TRAIN_HW[0] >> 3, TRAIN_HW[1] >> 3),
                    cin=1, cout=32, relu=False)
        args, kw = conv3d_operands(case, dtype, device, gen)
        got = fused_conv3d(*args, **kw)
        ref = fused_conv3d_plain(*(a.float() for a in args), **kw)
        note(("fused_conv3d", tag),
             _compare(got, ref, ktol, f"fused_conv3d {case} {dtype}"))
        log(f"  {len(dw_cases())} K4 cases and 7 new K1/K3 pair cases "
            f"within tolerance in {dtype}")
    return worst


def tc_cases() -> tuple[list, list]:
    """The 32 -> 32 shapes of the tensor-core K1 and K3 beyond the 720p
    frame's: K1 at the refine levels of the v1 step (batch 4 at 480 x 640,
    dilations 1-8) and of the v2 / v3 step (batch 8 at 240 x 320), the
    encoder levels below them (dilation 1), and two ragged shapes; K3 at the
    720p cost volume, the two training volumes and a ragged one."""
    k1 = []
    for b, (h, w) in ((TRAIN_B, TRAIN_HW), (TRAIN_B_V23, TRAIN_HW_V23)):
        refine = [(b, h >> k, w >> k) for k in (0, 1, 2)]
        k1 += [(shape, d) for shape in refine for d in (1, 2, 4, 8)]
        k1.append(((b, h >> 3, w >> 3), 1))
    k1 += [((3, 37, 53), 1), ((3, 37, 53), 8)]
    k3 = [(1, 24, HW[0] >> 3, HW[1] >> 3),
          (TRAIN_B, 24, TRAIN_HW[0] >> 3, TRAIN_HW[1] >> 3),
          (TRAIN_B_V23, 24, TRAIN_HW_V23[0] >> 3, TRAIN_HW_V23[1] >> 3),
          (2, 5, 37, 53)]
    return k1, k3


def check_tc_kernels(device) -> dict:
    """The tensor-core K1 and K3 (bf16 32 -> 32) against their plain
    versions at ``tc_cases()``: K1 forward (ReLU with a residual, and leaky
    at the ragged shapes) and dx (no epilogue, the weights flipped in y and
    x with C_in and C_out swapped, as ``flat_conv3x3`` calls it); K3 with
    ReLU and dx (flipped in z, y and x, no epilogue)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    worst = {}

    def note(name, err):
        worst[(name, "bf16")] = max(worst.get((name, "bf16"), 0.0), err)

    k1, k3 = tc_cases()
    for (n, h, w), d in k1:
        args = _operands((n, h, w, 32), (3, 3, 32, 32), 32, torch.bfloat16,
                         device, gen)
        res = (torch.rand((n, h, w, 32), generator=gen, device=device) * 2
               - 1).bfloat16()
        act = 0.2 if h == 37 else "relu"
        got = fused_conv3x3(*args, dilation=d, act=act, residual=res)
        ref = fused_conv3x3_plain(*(a.float() for a in args), dilation=d,
                                  act=act, residual=res.float())
        note("fused_conv3x3", _compare(got, ref, TOL_BF16,
                                       f"tc fused_conv3x3 {n}x{h}x{w} d{d}"))
        x, wt = args[0], args[1].flip((0, 1)).transpose(2, 3).contiguous()
        one = torch.ones(32, device=device)
        zero = torch.zeros(32, device=device)
        got = fused_conv3x3(x, wt, one, zero, dilation=d, act="none")
        ref = fused_conv3x3_plain(x.float(), wt.float(), one, zero,
                                  dilation=d, act="none")
        note("fused_conv3x3", _compare(
            got, ref, TOL_BF16, f"tc fused_conv3x3 dx {n}x{h}x{w} d{d}"))
    for vol in k3:
        args = _operands((*vol, 32), (3, 3, 3, 32, 32), 32, torch.bfloat16,
                         device, gen)
        got = fused_conv3d(*args, relu=True)
        ref = fused_conv3d_plain(*(a.float() for a in args), relu=True)
        note("fused_conv3d", _compare(got, ref, TOL_BF16,
                                      f"tc fused_conv3d {vol}"))
        x, wt = args[0], args[1].flip((0, 1, 2)).transpose(3, 4).contiguous()
        one = torch.ones(32, device=device)
        zero = torch.zeros(32, device=device)
        got = fused_conv3d(x, wt, one, zero, relu=False)
        ref = fused_conv3d_plain(x.float(), wt.float(), one, zero, relu=False)
        note("fused_conv3d", _compare(got, ref, TOL_BF16,
                                      f"tc fused_conv3d dx {vol}"))
    s2 = s2_cases()
    for (n, h, w), taps in s2:
        args = _operands((n, h, w, 32), (taps, taps, 32, 32), 32,
                         torch.bfloat16, device, gen)
        if taps == 4:
            name, got = "fused_conv4x4_s2", fused_conv4x4_s2(*args, act=0.2)
            ref = fused_conv4x4_s2_plain(*(a.float() for a in args), act=0.2)
        else:
            name = "fused_conv3x3_s2"
            got = fused_conv3x3(*args, stride=2, act="relu")
            ref = fused_conv3x3_plain(*(a.float() for a in args), stride=2,
                                      act="relu")
        note(name, _compare(got, ref, TOL_BF16, f"tc {name} {n}x{h}x{w}"))
    log(f"  tensor-core kernels: {2 * len(k1)} K1, {2 * len(k3)} K3 and "
        f"{len(s2)} K2 / K2-4x4 cases within tolerance in torch.bfloat16")
    return worst


def s2_cases() -> list:
    """((n, h, w), taps) of the tensor-core K2 (3x3) and K2-4x4 beyond the
    720p frames' (which ``check_kernels`` and ``check_v3_kernels`` hold):
    ragged batches, odd and even sizes, widths no 32-column strip divides."""
    return [((n, h, w), taps) for taps in (3, 4)
            for n, h, w in ((3, 37, 53), (2, 38, 70), (1, 9, 66),
                            (2, 181, 321))]


def dw_tc_cases() -> list[dict]:
    """The tensor-core K4's launches: every bf16 32 -> 32 shape of the v1
    step (``dw_cases``) and of the v2 / v3 step (batch 8: refine levels
    240 x 320 to 60 x 80 at dilations 1-8, the encoder's 30 x 40, the
    (8, 24, 30, 40) volume), then ragged ones (odd sizes, widths no strip
    divides, depths 5 and 7)."""
    cases = [dict(c, batch=TRAIN_B) for c in dw_cases()
             if (c["cin"], c["cout"]) == (32, 32)]
    h, w = TRAIN_HW_V23
    for k in (0, 1, 2):
        cases += [dict(hw=(h >> k, w >> k), dil=d, batch=TRAIN_B_V23)
                  for d in (1, 2, 4, 8)]
    cases += [dict(hw=(h >> 3, w >> 3), dil=1, batch=TRAIN_B_V23),
              dict(vol=(24, h >> 3, w >> 3), batch=TRAIN_B_V23)]
    cases += [dict(hw=(37, 53), dil=1, batch=3), dict(hw=(37, 53), dil=8,
                                                      batch=3),
              dict(hw=(5, 130), dil=2, batch=1), dict(hw=(61, 83), dil=4,
                                                      batch=2),
              dict(vol=(5, 17, 33), batch=2), dict(vol=(7, 9, 21), batch=1)]
    for c in cases:
        c.update(cin=32, cout=32)
    return cases


def check_dw_tc(device) -> dict:
    """The tensor-core K4 (bf16 32 -> 32) against its plain version at
    ``dw_tc_cases()`` within ``TOL_DW_BF16`` of the output's scale, each
    launched twice on the same inputs: the two must be the same bits."""
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    worst = {("dw_reduce", "bf16"): 0.0, ("dw_reduce", "bf16", "over scale"):
             0.0}
    for case in dw_tc_cases():
        x, g = _dw_operands(case, torch.bfloat16, device, gen, case["batch"])
        if "vol" in case:
            got, again = dw_reduce3d(x, g), dw_reduce3d(x, g)
            ref = dw_reduce3d_plain(x.float(), g.float())
        else:
            got, again = dw_reduce(x, g, case["dil"]), dw_reduce(x, g,
                                                                 case["dil"])
            ref = dw_reduce_plain(x.float(), g.float(), case["dil"])
        err, rel = _compare_scaled(got, ref, TOL_DW_BF16,
                                   f"tc dw_reduce {case}")
        if not torch.equal(got, again):
            raise AssertionError(f"tc dw_reduce {case}: two launches on the "
                                 f"same inputs differ")
        worst[("dw_reduce", "bf16")] = max(worst[("dw_reduce", "bf16")], err)
        key = ("dw_reduce", "bf16", "over scale")
        worst[key] = max(worst[key], rel)
    log(f"  tensor-core K4: {len(dw_tc_cases())} cases within tolerance, "
        f"each the same bits on a second launch")
    return worst


def time_tc_kernels(device, peaks) -> dict:
    """The tensor-core kernels at their other main-path shapes: K1 at
    720 x 1280 +residual for each dilation (the timed row is dilation 1),
    K3 at the 720p and training volumes, K2 and K2-4x4 at their smaller
    720p levels, K4 at dilations 2, 4 and 8 of the v1 step's largest launch
    and at the v2 / v3 step's largest 2D and 3D launches; each beside
    cuDNN's bf16 call (K2, K2-4x4 and K4 also with their bound)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    out = {"fused_conv3x3": {}, "fused_conv3d": {}, "fused_conv3x3_s2": {},
           "fused_conv4x4_s2": {}, "dw_reduce": {}}
    for d in (2, 4, 8):
        case = dict(hw=HW, cin=32, cout=32, stride=1, dil=d, act="relu",
                    res=True)
        args, kw, res = conv3x3_operands(case, torch.bfloat16, device, gen)
        w_oihw = args[1].permute(3, 2, 0, 1).contiguous()
        x_nchw = args[0].permute(0, 3, 1, 2)
        out["fused_conv3x3"][f"720x1280 d{d} +residual"] = _tc_times(
            lambda: fused_conv3x3(*args, **kw, residual=res),
            lambda: F.conv2d(x_nchw, w_oihw, padding=d, dilation=d))
    for vol in tc_cases()[1][:3]:
        args, kw = conv3d_operands(dict(vol=vol, cin=32, cout=32, relu=True),
                                   torch.bfloat16, device, gen)
        w_oidhw = args[1].permute(4, 3, 0, 1, 2).contiguous()
        x_ncdhw = args[0].permute(0, 4, 1, 2, 3)
        out["fused_conv3d"]["x".join(map(str, vol))] = _tc_times(
            lambda: fused_conv3d(*args, **kw),
            lambda: F.conv3d(x_ncdhw, w_oidhw, padding=1))
    for name, taps, hw in (("fused_conv3x3_s2", 3, (HW[0] // 4, HW[1] // 4)),
                           ("fused_conv4x4_s2", 4, (HW[0] // 2, HW[1] // 2)),
                           ("fused_conv4x4_s2", 4, (HW[0] // 4, HW[1] // 4))):
        args = _operands((1, *hw, 32), (taps, taps, 32, 32), 32,
                         torch.bfloat16, device, gen)
        fn = ((lambda: fused_conv4x4_s2(*args, act=0.2)) if taps == 4 else
              (lambda: fused_conv3x3(*args, stride=2)))
        y = fn()
        w_oihw = args[1].permute(3, 2, 0, 1).contiguous()
        x_nchw = args[0].permute(0, 3, 1, 2)
        out[name][f"{hw[0]}x{hw[1]} -> {y.shape[1]}x{y.shape[2]}"] = dict(
            _tc_times(fn, lambda: F.conv2d(x_nchw, w_oihw, stride=2,
                                           padding=1)),
            **bound(_nbytes(*args, y), 2 * y.numel() * taps * taps * 32,
                    peaks))
    dw = [(f"{TRAIN_B}x{TRAIN_HW[0]}x{TRAIN_HW[1]} d{d}",
           dict(hw=TRAIN_HW, dil=d), TRAIN_B) for d in (2, 4, 8)]
    dw += [(f"{TRAIN_B_V23}x{TRAIN_HW_V23[0]}x{TRAIN_HW_V23[1]} d1",
            dict(hw=TRAIN_HW_V23, dil=1), TRAIN_B_V23),
           (f"{TRAIN_B_V23}x24x{TRAIN_HW_V23[0] >> 3}x{TRAIN_HW_V23[1] >> 3}",
            dict(vol=(24, TRAIN_HW_V23[0] >> 3, TRAIN_HW_V23[1] >> 3)),
            TRAIN_B_V23)]
    for key, case, batch in dw:
        x, g = _dw_operands(dict(case, cin=32, cout=32), torch.bfloat16,
                            device, gen, batch)
        x_nc, g_nc = x.movedim(-1, 1), g.movedim(-1, 1)
        if "vol" in case:
            fn = lambda: dw_reduce3d(x, g)
            lib = lambda: torch.nn.grad.conv3d_weight(
                x_nc, (32, 32, 3, 3, 3), g_nc, padding=1)
            taps = 27
        else:
            d = case["dil"]
            fn = lambda: dw_reduce(x, g, d)
            lib = lambda: torch.nn.grad.conv2d_weight(
                x_nc, (32, 32, 3, 3), g_nc, padding=d, dilation=d)
            taps = 9
        y = fn()
        out["dw_reduce"][key] = dict(
            _tc_times(fn, lib),
            **bound(_nbytes(x, g, y), 2 * (x.numel() // 32) * taps * 32 * 32,
                    peaks))
    return out


def time_train_kernels(device, peaks) -> dict:
    """bf16 timings of K4 at its largest launch (2D, and the 3D form) and
    of K5 / K6 (``time_autograd``); the narrow pairs are timed by
    ``time_narrow``."""
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    rows = {}
    for key, case in (("dw_reduce", dict(hw=TRAIN_HW, cin=32, cout=32, dil=1)),
                      ("dw_reduce 3D", dict(vol=(24, TRAIN_HW[0] >> 3,
                                                 TRAIN_HW[1] >> 3),
                                            cin=32, cout=32))):
        x, g = _dw_operands(case, torch.bfloat16, device, gen)
        x_nc = x.movedim(-1, 1)  # channels-last NCHW / NCDHW views
        g_nc = g.movedim(-1, 1)
        if "vol" in case:
            fn, plain = (lambda: dw_reduce3d(x, g)), (
                lambda: dw_reduce3d_plain(x, g))
            lib = (lambda: torch.nn.grad.conv3d_weight(
                x_nc, (32, 32, 3, 3, 3), g_nc, padding=1))
            shape = f"{TRAIN_B}x{'x'.join(map(str, case['vol']))} 32->32"
            taps = 27
        else:
            fn, plain = (lambda: dw_reduce(x, g)), (
                lambda: dw_reduce_plain(x, g))
            lib = (lambda: torch.nn.grad.conv2d_weight(
                x_nc, (32, 32, 3, 3), g_nc, padding=1))
            shape = f"{TRAIN_B}x{case['hw'][0]}x{case['hw'][1]} 32->32 d1"
            taps = 9
        out = fn()
        pixels = x.numel() // 32
        rows[key] = dict(shape=shape, plain_ms=time_ms(plain),
                         **_tc_times(fn, lib), bytes=_nbytes(x, g, out),
                         flops=2 * pixels * taps * 32 * 32)
    rows.update(time_autograd(device, gen))
    return add_bounds(rows, peaks)


def time_autograd(device, gen) -> dict:
    """bf16 forward + backward (dx and dW) of K5 ``flat_conv3x3`` and K6
    ``flat_conv3d`` at their largest training shapes, beside the plain
    versions' autograd and cuDNN's bf16 forward + backward.  Bytes: the
    forward reads x and writes y, dx reads g and writes dx, dW reads x and g;
    operations: three convolutions' worth."""
    rows = {}
    for name, shape, taps in (("flat_conv3x3", (TRAIN_B, *TRAIN_HW), 9),
                              ("flat_conv3d", (TRAIN_B, 24, TRAIN_HW[0] >> 3,
                                               TRAIN_HW[1] >> 3), 27)):
        nd = len(shape) - 1
        x = ((torch.rand((*shape, 32), generator=gen, device=device) * 2 - 1)
             .bfloat16().requires_grad_())
        w = ((torch.rand((*([3] * nd), 32, 32), generator=gen, device=device)
              - 0.5) * 0.2).requires_grad_()
        cot = torch.rand((*shape, 32), generator=gen, device=device).bfloat16()
        one = torch.ones(32, device=device)
        zero = torch.zeros(32, device=device)
        if nd == 2:
            fn = flat_conv3x3
            plain = lambda a, b: fused_conv3x3_plain(a, b, one, zero,
                                                     act="none")
            lib = lambda a, b: F.conv2d(a.movedim(-1, 1),
                                        b.permute(3, 2, 0, 1).bfloat16(),
                                        padding=1)
        else:
            fn = flat_conv3d
            plain = lambda a, b: fused_conv3d_plain(a, b, one, zero,
                                                    relu=False)
            lib = lambda a, b: F.conv3d(a.movedim(-1, 1),
                                        b.permute(4, 3, 0, 1, 2).bfloat16(),
                                        padding=1)

        def step(f, cot_view=lambda c: c):
            y = f(x, w)
            y.backward(cot_view(cot).to(y.dtype))

        act = x.numel() * 2  # bytes of one bf16 activation
        rows[name] = dict(
            shape=f"{'x'.join(map(str, shape))} 32->32 forward + backward",
            ms=time_ms(lambda: step(fn)),
            plain_ms=time_ms(lambda: step(plain)),
            library_ms=time_ms(lambda: step(lib, lambda c: c.movedim(-1, 1))),
            bytes=6 * act + w.numel() * 4 * 2,
            flops=3 * 2 * x.numel() * taps * 32)
    return rows


def check_autograd(device) -> dict:
    """``flat_conv3x3`` / ``flat_conv3d`` backward on the kernels against
    the plain backward of the same functions (autograd through the plain
    float32 convs) on the same bf16-representable values."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    worst: dict = {}

    def rand(*shape):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1
                ).bfloat16().float()

    cases = [((2, 64, 96), 32, 32, d) for d in (1, 2, 4, 8)]
    cases += [((2, 64, 96), 4, 32, 1), ((2, 64, 96), 32, 1, 1),
              ((2, 8, 16, 24), 32, 32, None), ((2, 8, 16, 24), 32, 1, None)]
    for dtype, tol, tag in ((torch.float32, TOL_DW_F32, "f32"),
                            (torch.bfloat16, TOL_DW_BF16, "bf16")):
        for shape, cin, cout, dil in cases:
            x0, cot0 = rand(*shape, cin), rand(*shape, cout)
            w0 = (rand(*([3] * (len(shape) - 1)), cin, cout) * 0.2
                  ).bfloat16().float()
            one = torch.ones(cout, device=device)
            zero = torch.zeros(cout, device=device)
            if dil is None:
                name = "flat_conv3d"
                fn = flat_conv3d
                plain = lambda a, b: fused_conv3d_plain(a, b, one, zero,
                                                        relu=False)
            else:
                name = "flat_conv3x3"
                fn = lambda a, b, d=dil: flat_conv3x3(a, b, d)
                plain = lambda a, b, d=dil: fused_conv3x3_plain(
                    a, b, one, zero, dilation=d, act="none")
            x = x0.to(dtype).requires_grad_()
            w = w0.clone().requires_grad_()
            gx, gw = torch.autograd.grad(
                (fn(x, w).float() * cot0).sum(), (x, w))
            xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            rx, rw = torch.autograd.grad((plain(xr, wr) * cot0).sum(),
                                         (xr, wr))
            what = f"{name} {shape} {cin}->{cout} d{dil} {dtype}"
            for part, got, ref in (("dx", gx, rx), ("dW", gw, rw)):
                key = (name, part, tag)
                rel = _compare_scaled(got, ref, tol, f"{what} {part}")[1]
                worst[key] = max(worst.get(key, 0.0), rel)
    log(f"  {2 * len(cases)} backward cases within tolerance; largest error "
        f"/ scale " + json.dumps({" ".join(k): v for k, v in worst.items()}))
    return worst


# ---------------------------------------------------------------------------
# the narrow channel pairs of K1 (stride 1), K2 (stride 2), K3 and K4, on the
# tensor cores in bf16
# ---------------------------------------------------------------------------


def narrow_cases() -> tuple[list, list, list]:
    """Every narrow K1 (stride 1), K4, K2 and K3 launch shape of the v1 / v2
    / v3 frames and training steps, then ragged ones: K1 as (pair, (n, h,
    w), dilation, residual), K4 as (kd, pair, shape, dilation), K2 and K3 as
    (pair, shape): K2's 3 -> 32 stem (n, h, w) at stride 2, K3's 32 -> 1
    head and 1 -> 32 dx (b, d, h, w)."""
    frame = [(1, HW[0] >> k, HW[1] >> k) for k in (0, 1, 2)]
    v1 = [(TRAIN_B, TRAIN_HW[0] >> k, TRAIN_HW[1] >> k) for k in (0, 1, 2)]
    v23 = [(TRAIN_B_V23, TRAIN_HW_V23[0] >> k, TRAIN_HW_V23[1] >> k)
           for k in (0, 1, 2)]
    k1_shapes = {(4, 32): frame + v1, (7, 32): frame + v23,
                 (3, 32): frame[:1], (1, 32): v1 + v23,
                 (32, 1): frame + v1 + v23, (32, 4): v1, (32, 7): v23}
    ragged = [((3, 37, 53), 1, False), ((3, 37, 53), 8, True),
              ((2, 9, 130), 4, False)]
    k1 = [(pair, shape, 1, False) for pair, shapes in k1_shapes.items()
          for shape in shapes]
    k1 += [(pair, shape, d, res) for pair in k1_shapes
           for shape, d, res in ragged]
    vols = [(TRAIN_B, 24, TRAIN_HW[0] >> 3, TRAIN_HW[1] >> 3),
            (TRAIN_B_V23, 24, TRAIN_HW_V23[0] >> 3, TRAIN_HW_V23[1] >> 3)]
    k4 = [(1, (4, 32), shape, 1) for shape in v1]
    k4 += [(1, (7, 32), shape, 1) for shape in v23]
    k4 += [(1, (32, 1), shape, 1) for shape in v1 + v23]
    k4 += [(3, (32, 1), vol, 1) for vol in vols]
    k4 += [(1, pair, (3, 37, 53), d) for pair in ((4, 32), (7, 32), (32, 1))
           for d in (1, 8)]
    k4 += [(1, (7, 32), (1, 5, 130), 2), (3, (32, 1), (2, 5, 17, 33), 1)]
    ragged3d = [(2, 5, 37, 53), (1, 7, 17, 33)]
    k23 = [((3, 32), shape) for shape in ((1, *HW), (3, 37, 53), (2, 38, 70),
                                          (1, 9, 66), (2, 181, 321))]
    k23 += [((32, 1), vol) for vol in [(1, 24, HW[0] >> 3, HW[1] >> 3)]
            + vols + ragged3d]
    k23 += [((1, 32), vol) for vol in vols + ragged3d]
    return k1, k4, k23


def check_narrow(device) -> dict:
    """The narrow pairs against their plain versions at ``narrow_cases()``,
    float32 and bf16: K1 within ``TOL_F32`` / ``TOL_BF16`` with its model
    epilogue (and ReLU with a residual at a ragged shape), K4 within
    ``TOL_DW_F32`` / ``TOL_DW_BF16`` of its output's scale, each K4 launched
    twice on the same inputs: the two must be the same bits; K2's stem
    (ReLU) and K3's head and dx (no ReLU) within ``TOL_F32`` /
    ``TOL_BF16``."""
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    worst: dict = {}

    def note(key, err):
        worst[key] = max(worst.get(key, 0.0), err)

    k1, k4, k23 = narrow_cases()
    for dtype, tol, dtol, tag in ((torch.float32, TOL_F32, TOL_DW_F32, "f32"),
                                  (torch.bfloat16, TOL_BF16, TOL_DW_BF16,
                                   "bf16")):
        for (cin, cout), (n, h, w), d, with_res in k1:
            args = _operands((n, h, w, cin), (3, 3, cin, cout), cout, dtype,
                             device, gen)
            res, act = None, NARROW_ACT[(cin, cout)]
            if with_res:
                res, act = (torch.rand((n, h, w, cout), generator=gen,
                                       device=device) * 2 - 1).to(dtype), "relu"
            got = fused_conv3x3(*args, dilation=d, act=act, residual=res)
            ref = fused_conv3x3_plain(
                *(a.float() for a in args), dilation=d, act=act,
                residual=None if res is None else res.float())
            note(("fused_conv3x3", tag), _compare(
                got, ref, tol, f"narrow fused_conv3x3 {cin}->{cout} "
                f"{n}x{h}x{w} d{d} {dtype}"))
        for kd, (cin, cout), shape, d in k4:
            x = (torch.rand((*shape, cin), generator=gen, device=device) * 2
                 - 1).to(dtype)
            g = (torch.rand((*shape, cout), generator=gen, device=device) * 2
                 - 1).to(dtype)
            if kd == 3:
                got, again = dw_reduce3d(x, g), dw_reduce3d(x, g)
                ref = dw_reduce3d_plain(x.float(), g.float())
            else:
                got, again = dw_reduce(x, g, d), dw_reduce(x, g, d)
                ref = dw_reduce_plain(x.float(), g.float(), d)
            what = f"narrow dw_reduce {kd}D {cin}->{cout} {shape} d{d} {dtype}"
            err, rel = _compare_scaled(got, ref, dtol, what)
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: two launches on the same "
                                     f"inputs differ")
            note(("dw_reduce", tag), err)
            note(("dw_reduce", tag, "over scale"), rel)
        for (cin, cout), shape in k23:
            if len(shape) == 3:
                name, kw = "fused_conv3x3_s2", dict(stride=2, act="relu")
                args = _operands((*shape, cin), (3, 3, cin, cout), cout,
                                 dtype, device, gen)
                got = fused_conv3x3(*args, **kw)
                ref = fused_conv3x3_plain(*(a.float() for a in args), **kw)
            else:
                name = "fused_conv3d"
                args, kw = conv3d_operands(dict(vol=shape, cin=cin, cout=cout,
                                                relu=False), dtype, device,
                                           gen)
                got = fused_conv3d(*args, **kw)
                ref = fused_conv3d_plain(*(a.float() for a in args), **kw)
            note((name, tag), _compare(
                got, ref, tol, f"narrow {name} {cin}->{cout} {shape} {dtype}"))
        log(f"  narrow pairs: {len(k1)} K1, {len(k4)} K4 and {len(k23)} K2 / "
            f"K3 cases within tolerance in {dtype}, each K4 the same bits on "
            f"a second launch")
    log("  narrow pairs, largest error (K4 also over its output's scale): "
        + json.dumps({" ".join(k): v for k, v in worst.items()}))
    return worst


# the narrow pairs' groups (frame_profile.kernel_group) each main path runs,
# all on the tensor cores in bf16
NARROW_TC_GROUPS = {
    "frame v1": ("fused_conv3x3 4->32", "fused_conv3x3 32->1",
                 "fused_conv3x3_s2 3->32", "fused_conv3d 32->1"),
    "train v1": ("fused_conv3x3 4->32", "fused_conv3x3 32->1",
                 "fused_conv3x3 32->4", "fused_conv3x3 1->32",
                 "dw_reduce 4->32", "dw_reduce 32->1", "dw_reduce 3D 32->1",
                 "fused_conv3d 32->1", "fused_conv3d 1->32"),
    "train v2": ("fused_conv3x3 7->32", "fused_conv3x3 32->7",
                 "dw_reduce 7->32", "fused_conv3d 32->1",
                 "fused_conv3d 1->32"),
    "frame v3": ("fused_conv3x3 3->32", "fused_conv3x3 32->1",
                 "fused_conv3d 32->1")}


def check_narrow_routes(device) -> dict:
    """One bf16 v1 and v3 720p frame and one v1 and v2 training step under
    the profiler (``frame_profile``): each of ``NARROW_TC_GROUPS`` launched
    on the tensor cores, and no narrow pair on the CUDA cores.  Returns the
    narrow groups' launches per step or frame with their routes."""
    got = {}
    for label, (fn, model) in (
            ("frame v1", (frame_profile.frame_fn, "v1")),
            ("train v1", (frame_profile.train_step_fn, "v1")),
            ("train v2", (frame_profile.train_step_fn, "v2")),
            ("frame v3", (frame_profile.frame_fn, "v3"))):
        prof = frame_profile.profile_device(fn(device, SEED, model), 1)
        narrow = {g: v for g, v in prof["groups"].items()
                  if v["route"] in ("tensor cores", "cuda cores")
                  and not g.endswith(" 32->32")}
        for g in NARROW_TC_GROUPS[label]:
            if narrow.get(g, {}).get("route") != "tensor cores" or \
                    not narrow[g]["launches_per_frame"]:
                raise AssertionError(f"{label}: {g} did not run on the "
                                     f"tensor cores: {narrow.get(g)}")
        for g, v in narrow.items():
            if v["route"] != "tensor cores":
                raise AssertionError(f"{label}: {g} ran on {v['route']}")
        got[label] = {g: {"launches": v["launches_per_frame"],
                          "route": v["route"]} for g, v in narrow.items()}
    log(f"  narrow pairs on the main paths by route: {json.dumps(got)}")
    return got


def time_narrow(device, peaks) -> dict:
    """bf16 timings of every narrow pair at its largest launch beside its
    plain version, one cuDNN call (``library_ms``) and the bound, ``ms`` and
    ``device_ms`` (the same calls queued: device time alone), all on the
    tensor cores: K1 1 / 3 / 4 / 7 -> 32 and 32 -> 1 / 4 / 7, K4 4 / 7 -> 32
    and 32 -> 1 (2D and 3D), K2's 3 -> 32 encoder stem and K3's 32 -> 1 head
    and 1 -> 32 (its dx)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    rows = {}
    v1 = (TRAIN_B, *TRAIN_HW)
    v23 = (TRAIN_B_V23, *TRAIN_HW_V23)
    for (cin, cout), shape in (((4, 32), (1, *HW)), ((7, 32), (1, *HW)),
                               ((3, 32), (1, *HW)), ((1, 32), v1),
                               ((32, 1), (1, *HW)), ((32, 4), v1),
                               ((32, 7), v23)):
        act = NARROW_ACT[(cin, cout)]
        args = _operands((*shape, cin), (3, 3, cin, cout), cout,
                         torch.bfloat16, device, gen)
        out = fused_conv3x3(*args, act=act)
        w_oihw = args[1].permute(3, 2, 0, 1).contiguous()
        x_nchw = args[0].permute(0, 3, 1, 2)
        rows[f"fused_conv3x3 {cin}->{cout}"] = dict(
            shape=f"{'x'.join(map(str, shape))} {cin}->{cout} {act}",
            design=TC_DESIGN["narrow in" if cout == 32 else "narrow out"],
            source="realtime_stereo_matcher_tpu_torch/csrc/conv_narrow_tc.cuh",
            plain_ms=time_ms(lambda: fused_conv3x3_plain(*args, act=act)),
            **_tc_times(lambda: fused_conv3x3(*args, act=act),
                        lambda: F.conv2d(x_nchw, w_oihw, padding=1)),
            bytes=_nbytes(*args, out), flops=2 * out.numel() * 9 * cin)
    for kd, (cin, cout), shape in (
            (1, (4, 32), v1), (1, (7, 32), v23), (1, (32, 1), v1),
            (3, (32, 1), (TRAIN_B, 24, TRAIN_HW[0] >> 3, TRAIN_HW[1] >> 3))):
        x = (torch.rand((*shape, cin), generator=gen, device=device) * 2
             - 1).bfloat16()
        g = (torch.rand((*shape, cout), generator=gen, device=device) * 2
             - 1).bfloat16()
        x_nc, g_nc = x.movedim(-1, 1), g.movedim(-1, 1)
        if kd == 3:
            fn, plain = (lambda: dw_reduce3d(x, g)), (
                lambda: dw_reduce3d_plain(x, g))
            lib = (lambda: torch.nn.grad.conv3d_weight(
                x_nc, (cout, cin, 3, 3, 3), g_nc, padding=1))
        else:
            fn, plain = (lambda: dw_reduce(x, g)), (
                lambda: dw_reduce_plain(x, g))
            lib = (lambda: torch.nn.grad.conv2d_weight(
                x_nc, (cout, cin, 3, 3), g_nc, padding=1))
        out = fn()
        rows[f"dw_reduce{' 3D' if kd == 3 else ''} {cin}->{cout}"] = dict(
            shape=f"{'x'.join(map(str, shape))} {cin}->{cout}",
            design=TC_DESIGN["dw narrow x" if cout == 32 else
                             "dw narrow g"],
            source="realtime_stereo_matcher_tpu_torch/csrc/dw_tc.cuh",
            plain_ms=time_ms(plain), **_tc_times(fn, lib),
            bytes=_nbytes(x, g, out),
            flops=2 * (x.numel() // cin) * 9 * kd * cin * cout)
    args = _operands((1, *HW, 3), (3, 3, 3, 32), 32, torch.bfloat16, device,
                     gen)
    out = fused_conv3x3(*args, stride=2)
    w_oihw = args[1].permute(3, 2, 0, 1).contiguous()
    x_nchw = args[0].permute(0, 3, 1, 2)
    rows["fused_conv3x3_s2 3->32"] = dict(
        shape=f"{HW[0]}x{HW[1]} -> {out.shape[1]}x{out.shape[2]} 3->32 relu",
        design=TC_DESIGN["narrow s2 in"],
        source="realtime_stereo_matcher_tpu_torch/csrc/conv_s2_tc.cuh",
        plain_ms=time_ms(lambda: fused_conv3x3_plain(*args, stride=2)),
        **_tc_times(lambda: fused_conv3x3(*args, stride=2),
                    lambda: F.conv2d(x_nchw, w_oihw, stride=2, padding=1)),
        bytes=_nbytes(*args, out), flops=2 * out.numel() * 9 * 3)
    for (cin, cout), vol, relu in (
            ((32, 1), (1, 24, HW[0] >> 3, HW[1] >> 3), False),
            ((1, 32), (TRAIN_B, 24, TRAIN_HW[0] >> 3, TRAIN_HW[1] >> 3),
             False)):
        args, kw = conv3d_operands(dict(vol=vol, cin=cin, cout=cout,
                                        relu=relu), torch.bfloat16, device,
                                   gen)
        out = fused_conv3d(*args, **kw)
        w_oidhw = args[1].permute(4, 3, 0, 1, 2).contiguous()
        x_ncdhw = args[0].permute(0, 4, 1, 2, 3)
        rows[f"fused_conv3d {cin}->{cout}"] = dict(
            shape=f"{'x'.join(map(str, vol))} {cin}->{cout}",
            design=TC_DESIGN["narrow 3D out" if cin == 32 else
                             "narrow 3D in"],
            source="realtime_stereo_matcher_tpu_torch/csrc/"
                   "conv3d_narrow_tc.cuh",
            plain_ms=time_ms(lambda: fused_conv3d_plain(*args, **kw)),
            **_tc_times(lambda: fused_conv3d(*args, **kw),
                        lambda: F.conv3d(x_ncdhw, w_oidhw, padding=1)),
            bytes=_nbytes(*args, out), flops=2 * out.numel() * 27 * cin)
    add_bounds(rows, peaks)
    for row in rows.values():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["device_ms"]["bound_share"] = (row["bound_ms"]
                                           / row["device_ms"]["ms"])
    return rows


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def seeded_model(device, model: str = "v1"):
    """``model`` (v1 or v3) from its repo config, weights and BatchNorm
    stats from ``SEED``."""
    config = bench.model_config(model)
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(config, device=device, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
                n = m.running_mean.numel()
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.3)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return model


def check_model(device, hw=HW) -> dict:
    """Kernel path against the plain model; the bf16 frame is the main path
    whose launches are counted."""
    model = seeded_model(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    left, right = (torch.rand((1, *hw, 3), generator=gen, device=device) * 255
                   for _ in range(2))
    with torch.no_grad():
        plain = model(left, right)
    return check_kernel_path(model, left, right, plain, LAUNCHES_PER_FRAME)


def check_kernel_path(model, left, right, plain, expected, what="") -> dict:
    """The float32 kernel path against the plain float32 outputs ``plain``
    (rtol 1e-3, atol 5e-2), then the bf16 kernel path (the main path),
    its launches counted from 0 and held to ``expected``, its output
    finite negative flow within 1 px median of the plain one."""
    fast32 = make_fast_forward(model, dtype=torch.float32)(left, right)
    f32_err = [_compare(g, w, (5e-2, 1e-3), f"{what}f32 kernel path head {i}")
               for i, (g, w) in enumerate(zip(fast32, plain))]
    log(f"  {what}f32 kernel path vs plain f32: max abs err per head {f32_err}")

    fast_bf16 = make_fast_forward(model)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    out = fast_bf16(left, right)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    final = out[-1]
    if final.shape != left.shape[:3] + (1,) or not bool(
            torch.isfinite(final).all()):
        raise AssertionError(f"{what}bf16 output: shape {tuple(final.shape)}")
    if float(final.max()) > 0:
        raise AssertionError(f"{what}bf16 output is not negative flow")
    median = float((final - plain[-1]).abs().median())
    log(f"  {what}bf16 kernel path vs plain f32: median |d| {median:.4f} px")
    if not median < 1.0:
        raise AssertionError(f"{what}bf16 median error {median} px >= 1 px")
    if launches != expected:
        raise AssertionError(f"launches of one {what}frame {launches}, "
                             f"expected {expected}")
    return dict(launches=launches, f32_max_abs_err=f32_err,
                bf16_median_err_px=median)


def run_checked_bench(model: str, per_frame: dict) -> dict:
    """8 pairs through ``bench.run_bench``, its launches held to
    ``per_frame`` x the frames it ran (warm-up included)."""
    _build.LAUNCHES.clear()
    record = bench.run_bench(pairs=8, seed=SEED, model=model)
    frames = record["pairs"] + record["warmup"]
    expected = {k: v * frames for k, v in per_frame.items()}
    if dict(_build.LAUNCHES) != expected:
        raise AssertionError(f"{model} bench launches "
                             f"{dict(_build.LAUNCHES)}, expected {expected}")
    log(json.dumps(record))
    return record


# ---------------------------------------------------------------------------
# v3: K2-4x4, K1's v3 cases and the v3 model
# ---------------------------------------------------------------------------


def v3_conv3x3_cases(h: int = HW[0], w: int = HW[1]) -> list[dict]:
    """K1 cases the v3 frame adds to v1's: the 3 -> 32 stem, the U-Net's
    leaky convs (1/8 to full) and the refine entry's two linear halves (the
    second with the first as its residual) at the refine levels."""
    levels = [(h >> k, w >> k) for k in (0, 1, 2, 3)]
    cases = [dict(hw=levels[0], cin=3, cout=32, stride=1, dil=1, act=0.2,
                  res=False)]
    cases += [dict(hw=hw, cin=32, cout=32, stride=1, dil=1, act=0.2,
                   res=False) for hw in levels]
    for hw in levels[:3]:
        for res in (False, True):
            cases.append(dict(hw=hw, cin=32, cout=32, stride=1, dil=1,
                              act="none", res=res))
    return cases


def conv4x4_cases(h: int = HW[0], w: int = HW[1]) -> list[tuple]:
    """Input sizes of the U-Net's 4x4 stride-2 convs: full, 1/2, 1/4."""
    return [(h >> k, w >> k) for k in (0, 1, 2)]


def conv4x4_operands(hw, dtype, device, gen):
    return _operands((1, *hw, 32), (4, 4, 32, 32), 32, dtype, device, gen)


def check_v3_kernels(device, size=HW) -> dict:
    """K1's v3 cases and K2-4x4 against their plain versions at an input of
    ``size``."""
    worst = check_kernels(device, v3_conv3x3_cases(*size), [])
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    for dtype, tol, tag in ((torch.float32, TOL_F32, "f32"),
                            (torch.bfloat16, TOL_BF16, "bf16")):
        for hw in conv4x4_cases(*size):
            args = conv4x4_operands(hw, dtype, device, gen)
            got = fused_conv4x4_s2(*args, act=0.2)
            ref = fused_conv4x4_s2_plain(*(a.float() for a in args), act=0.2)
            key = ("fused_conv4x4_s2", tag)
            worst[key] = max(worst.get(key, 0.0), _compare(
                got, ref, tol, f"fused_conv4x4_s2 {hw} {dtype}"))
        log(f"  {len(conv4x4_cases())} K2-4x4 cases within tolerance in "
            f"{dtype}")
    return worst


def eval_conv3x3_cases(h: int, w: int) -> list[dict]:
    """K1 and K2 cases of the v2 and v3 frames at an h x w input: v1's with
    v2's 7 -> 32 refine entry in place of the 4 -> 32 one (v3's refine
    levels run the same dilated ResBlocks and 32 -> 1 heads); v3's own are
    ``check_v3_kernels``'s."""
    return [dict(c, cin=7) if c["cin"] == 4 else c
            for c in conv3x3_cases(h, w)]


def check_eval_kernels(device) -> dict:
    """Every kernel launch shape of the v2 / v3 eval frames against its
    plain version, at each level of the held-out scenes' 320 x 448 and of
    KITTI's padded 384 x 1280 (K3 at (1, 24, 40, 56) and (1, 24, 48, 160)),
    float32 and bf16 within ``TOL_F32`` / ``TOL_BF16``; returns the largest
    abs error per kernel name and dtype."""
    worst: dict = {}
    for hw in EVAL_HW:
        for part in (check_kernels(device, eval_conv3x3_cases(*hw),
                                   conv3d_cases(*hw)),
                     check_v3_kernels(device, hw)):
            for key, err in part.items():
                worst[key] = max(worst.get(key, 0.0), err)
        log(f"  eval kernels at {hw[0]}x{hw[1]} within tolerance")
    log("  eval kernels, largest abs error: "
        + json.dumps({" ".join(k): v for k, v in sorted(worst.items())}))
    return worst


def time_v3_kernels(device, peaks) -> dict:
    """bf16 timings of K2-4x4 at its largest launch (720x1280 -> 360x640);
    the v3 stem (K1 3 -> 32) is timed by ``time_narrow``.  cuDNN's
    yardstick for the 4x4 conv is the same conv with torch padding 1, which
    is TF-SAME on even sizes."""
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows = {}
    args = conv4x4_operands(HW, torch.bfloat16, device, gen)
    x, w = args[0], args[1]
    out = fused_conv4x4_s2(*args, act=0.2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    x_nchw = x.permute(0, 3, 1, 2)
    rows["fused_conv4x4_s2"] = dict(
        shape=f"{HW[0]}x{HW[1]} -> {out.shape[1]}x{out.shape[2]} 32->32",
        plain_ms=time_ms(lambda: fused_conv4x4_s2_plain(*args, act=0.2)),
        **_tc_times(lambda: fused_conv4x4_s2(*args, act=0.2),
                    lambda: F.conv2d(x_nchw, w_oihw, stride=2, padding=1)),
        bytes=_nbytes(*args, out), flops=2 * out.numel() * 16 * 32)
    return add_bounds(rows, peaks)


def check_model_warped(device, name: str, expected: dict,
                       hw=HW) -> dict:
    """The v2 or v3 kernel path against the plain model with the same
    banded warp; the bf16 frame is the model's main path whose launches
    are counted."""
    model = seeded_model(device, name)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    left, right = (torch.rand((1, *hw, 3), generator=gen, device=device) * 255
                   for _ in range(2))
    shifts = refine_max_shifts(model.max_disp, model.down_factor)
    flows = []  # the largest flow each refine level warps by: 2 x its input

    def note_flow(_, args):
        flows.append(2.0 * float(args[0].abs().max()))

    refines = model.refine_layers if name == "v3" else model.refine_layer
    hooks = [r.register_forward_pre_hook(note_flow) for r in refines]
    with torch.no_grad():
        plain = model(left, right, banded_warp=True)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        unbanded = model(left, right)
    band_effect = [float((a - b).abs().max()) for a, b in zip(plain, unbanded)]
    levels = [dict(level=i, max_abs_flow=f, max_shift=m, in_band=f <= m)
              for i, (f, m) in enumerate(zip(flows, shifts))]
    log(f"  {name} refine levels, largest |flow| against the warp band: "
        f"{json.dumps(levels)}; plain banded vs unbanded warp, max abs "
        f"difference per head {band_effect}")

    result = check_kernel_path(model, left, right, plain, expected,
                               f"{name} ")
    return dict(result, refine_levels=levels, band_effect=band_effect)


# ---------------------------------------------------------------------------
# v2: the channel pairs v2 adds to K1 and K4, and K7
# ---------------------------------------------------------------------------


def v2_levels():
    """(720p refine levels; the 240 x 320 training refine levels)."""
    return ([(HW[0] >> k, HW[1] >> k) for k in (0, 1, 2)],
            [(TRAIN_HW_V23[0] >> k, TRAIN_HW_V23[1] >> k) for k in (0, 1, 2)])


def _k7_operands(dtype, device, gen):
    """K7's x (in ``dtype``), float32 w and float32 cotangent, all
    bf16-representable."""
    def rand(*shape):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1
                ).bfloat16().float()

    x = rand(*K7_SHAPE, 32)
    w = (rand(3, 3, 32, 32) * 0.1).bfloat16().float()
    cot = rand(K7_SHAPE[0], K7_SHAPE[1] // 2, K7_SHAPE[2] // 2, 32)
    return x.to(dtype), w, cot


def _k7_plain(x, w):
    """K7's plain version: ``F.conv2d`` at stride 2 in float32, whose
    autograd is the plain backward."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


def check_v2_kernels(device) -> dict:
    """K1 7 -> 32 (the v2 refine entry) at the 720p refine levels, K1
    32 -> 7 and K4 7 -> 32 (its dx and dW) at the training levels, and K7
    forward, dx and dW, each against its plain version; returns the largest
    errors (K4 and K7 also over the output's scale)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    worst: dict = {}

    def note(key, err):
        worst[key] = max(worst.get(key, 0.0), err)

    infer, train_lv = v2_levels()
    for dtype, tol, dtol, tag in ((torch.float32, TOL_F32, TOL_DW_F32, "f32"),
                                  (torch.bfloat16, TOL_BF16, TOL_DW_BF16,
                                   "bf16")):
        for hw in infer:
            case = dict(hw=hw, cin=7, cout=32, stride=1, dil=1, act="relu",
                        res=False)
            args, kw, _ = conv3x3_operands(case, dtype, device, gen)
            got = fused_conv3x3(*args, **kw)
            ref = fused_conv3x3_plain(*(a.float() for a in args), **kw)
            note(("fused_conv3x3", tag), _compare(
                got, ref, tol, f"fused_conv3x3 {case} {dtype}"))
        for hw in train_lv:
            args = _operands((TRAIN_B_V23, *hw, 32), (3, 3, 32, 7), 7, dtype,
                             device, gen)
            got = fused_conv3x3(*args, act="none")
            ref = fused_conv3x3_plain(*(a.float() for a in args), act="none")
            note(("fused_conv3x3", tag), _compare(
                got, ref, tol, f"fused_conv3x3 {hw} 32->7 {dtype}"))
            x, g = _dw_operands(dict(hw=hw, cin=7, cout=32), dtype, device,
                                gen, TRAIN_B_V23)
            err, rel = _compare_scaled(dw_reduce(x, g),
                                       dw_reduce_plain(x.float(), g.float()),
                                       dtol, f"dw_reduce {hw} 7->32 {dtype}")
            note(("dw_reduce", tag), err)
            note(("dw_reduce", tag, "over scale"), rel)
        x0, w0, cot = _k7_operands(dtype, device, gen)
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = conv3x3_s2(x, w)
        gx, gw = torch.autograd.grad((y.float() * cot).sum(), (x, w))
        xr, wr = x0.float().requires_grad_(), w0.clone().requires_grad_()
        yr = _k7_plain(xr, wr)
        rx, rw = torch.autograd.grad((yr * cot).sum(), (xr, wr))
        for part, got, ref in (("y", y.detach(), yr.detach()), ("dx", gx, rx),
                               ("dW", gw, rw)):
            err, rel = _compare_scaled(got, ref, dtol,
                                       f"conv3x3_s2 {part} {dtype}")
            note(("conv3x3_s2", tag), err)
            note(("conv3x3_s2", tag, part, "over scale"), rel)
        log(f"  K1 7->32 and 32->7, K4 7->32 and K7 within tolerance in "
            f"{dtype}")
    return worst


def _k7_runs(device) -> tuple[dict, dict]:
    """K7's three bf16 forward + backward runs at (4, 240, 320, 32), each a
    callable (``ms``: K7, ``plain_ms``: its plain float32 autograd,
    ``library_ms``: cuDNN's bf16 forward + backward), and its row without
    times.  K7's bytes: x, w, the cotangent, y, dx and dW once each; its
    operations: three stride-2 convolutions' worth (its zero-upsampled
    backward does 4x that)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    x0, w0, cot = _k7_operands(torch.bfloat16, device, gen)
    x, w = x0.requires_grad_(), w0.requires_grad_()
    cot = cot.bfloat16()

    def step(fn, cot_view=lambda c: c):
        y = fn(x, w)
        y.backward(cot_view(cot).to(y.dtype))

    def cudnn(a, b):
        return F.conv2d(a.movedim(-1, 1), b.permute(3, 2, 0, 1).bfloat16(),
                        stride=2, padding=1)

    y = conv3x3_s2(x, w)
    runs = dict(ms=lambda: step(conv3x3_s2), plain_ms=lambda: step(_k7_plain),
                library_ms=lambda: step(cudnn, lambda c: c.movedim(-1, 1)))
    row = dict(
        shape=f"{'x'.join(map(str, K7_SHAPE))} -> {y.shape[1]}x{y.shape[2]} "
              f"32->32 forward + backward",
        bytes=2 * _nbytes(x, w) + _nbytes(cot, y),
        flops=3 * 2 * y.numel() * 9 * 32)
    return runs, row


def time_v2_kernels(device, peaks) -> dict:
    """bf16 timings of K7 forward + backward (``_k7_runs``) by CUDA events
    (the v2 pairs of K1 and K4 are timed by ``time_narrow``; K7's device
    time by ``profile_k7``, after the timed phases)."""
    runs, row = _k7_runs(device)
    return add_bounds({"conv3x3_s2": dict(
        row, **{k: time_ms(run) for k, run in runs.items()})}, peaks)


def profile_k7(device) -> dict:
    """K7's device time per call of each of ``_k7_runs`` by the profiler: an
    autograd call this small leaves the device idle while the host issues
    it, so CUDA events measure the host as well."""
    runs, _ = _k7_runs(device)
    return {k: frame_profile.profile_device(run, 5)["device_ms_per_frame"]
            for k, run in runs.items()}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _grad_errors(grads, want, rtol, what, floor, slack) -> tuple[float, list]:
    """Per-parameter relative L2 of ``grads`` against ``want``; raises,
    naming every parameter above it, where one is above max(``rtol``,
    ``slack`` x the relative L2 of ``floor``, another estimate of the same
    gradient).  Returns the largest error over its limit and the parameters
    skipped for a gradient norm < 1e-3."""
    worst, skipped, bad = 0.0, [], []
    for k, w in want.items():
        norm = float(w.norm())
        if norm < 1e-3:
            skipped.append(k)
            continue
        rel = float((grads[k] - w).norm()) / norm
        limit = max(rtol, slack * float((floor[k] - w).norm()) / norm)
        if not rel <= limit:
            bad.append(f"{k} off by {rel:.3e} (limit {limit:.3e})")
        worst = max(worst, rel / limit)
    if bad:
        raise AssertionError(f"{what}: gradients beyond their relative L2 "
                             f"limits: {'; '.join(bad)}")
    return worst, skipped


def _step_grads(model, img1, img2, flow, valid, loss_fn, dtype=None, *,
                plain_dtype=torch.float32):
    """Loss, gradients and new running stats of one training forward on
    ``model``'s weights: the kernel path in ``dtype``, or the plain model
    (``dtype=None``) autocast to ``plain_dtype``, with the kernel path's
    banded warp where the model warps (v2, v3).  The model's running stats
    are left as they were.  Returns the loss, the gradients, the new running
    stats and each head's largest |flow|."""
    model.zero_grad(set_to_none=True)
    before = {k: v.clone() for k, v in running_stats(model).items()}
    if dtype is None:
        banded = ({} if type(model).__name__ == "MobileStereoNet"
                  else {"banded_warp": True})
        with torch.autocast(img1.device.type, dtype=plain_dtype,
                            enabled=plain_dtype != torch.float32):
            preds = model(img1, img2, **banded)
        stats = {k: v.clone() for k, v in running_stats(model).items()}
        load_running_stats(model, before)
    else:
        preds, stats = fast_train_forward(model, img1, img2, dtype=dtype)
    loss = loss_fn(preds, flow, valid)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    flows = [float(p.detach().abs().max()) for p in preds]
    return float(loss.detach()), grads, stats, flows


def check_train(device, name: str = "v1") -> dict:
    """The first step's kernel-path gradients against the plain path, then
    ``train()`` on the kernel path in bf16 with launches and step times, on
    the repo config of ``name`` (v1, v2 or v3) and its train section."""
    cfg = load_config(bench.MODELS[name][0])
    cfg.path = str(ROOT / "_runs" / f"chip_smoke_train_{name}")  # gitignored
    cfg.train.fast_kernels = "on"
    b, hw = cfg.train.batch_size, tuple(cfg.data.image_size)
    assert (b, hw) == ((TRAIN_B, TRAIN_HW) if name == "v1"
                       else (TRAIN_B_V23, TRAIN_HW_V23))
    assert cfg.model.mixed_precision
    expected = LAUNCHES_PER_STEP_V3 if name == "v3" else LAUNCHES_PER_STEP
    t0 = time.perf_counter()
    # scenes up to 96 px of disparity at 640 px wide, as wide at 320
    data = SyntheticBatches(b, hw, n_batches=WARMUP_STEPS + TIMED_STEPS,
                            seed0=SEED, max_disp=96.0 * hw[1] / TRAIN_HW[1],
                            device=device)
    log(f"  {name}: {b * len(data)} synthetic scenes at {hw} in "
        f"{time.perf_counter() - t0:.3f} s")

    # (a), (b): the first step of train() (same seed, same first batch)
    model, *_ = create_train_state(cfg, device=device)  # train()'s seed
    batch = next(iter(data))[1:]
    loss_fn = build_loss_function({"type": cfg.train.loss.type,
                                   "parameters": cfg.train.loss.parameters})
    plain_loss, plain_g, plain_s, flows = _step_grads(model, *batch, loss_fn)
    _, rev_g, _, _ = _step_grads(model, *(t.flip(0) for t in batch), loss_fn)
    k32_loss, k32_g, k32_s, _ = _step_grads(model, *batch, loss_fn,
                                            torch.float32)
    if not abs(k32_loss - plain_loss) <= 1e-4 * abs(plain_loss):
        raise AssertionError(f"f32 kernel-path loss {k32_loss} vs plain "
                             f"{plain_loss}")
    g32_err, skipped = _grad_errors(k32_g, plain_g, GRAD_RTOL_F32,
                                    "f32 kernel path", rev_g,
                                    GRAD_F32_FLOOR_SLACK)
    stat_err = 0.0
    for k, v in plain_s.items():
        err = (k32_s[k] - v).abs()
        if bool((err > 1e-4 + 1e-4 * v.abs()).any()):
            raise AssertionError(f"BN stat {k}: max err {float(err.max())}")
        stat_err = max(stat_err, float(err.max()))
    k16_loss, k16_g, _, _ = _step_grads(model, *batch, loss_fn,
                                        torch.bfloat16)
    _, p16_g, _, _ = _step_grads(model, *batch, loss_fn,
                              plain_dtype=torch.bfloat16)
    g16_err, _ = _grad_errors(k16_g, plain_g, GRAD_RTOL_BF16,
                              "bf16 kernel path", p16_g, GRAD_BF16_FLOOR_SLACK)
    rel16 = {k: (float((k16_g[k] - w).norm()) / float(w.norm()),
                 float((p16_g[k] - w).norm()) / float(w.norm()))
             for k, w in plain_g.items() if k not in skipped}
    log(f"  {name} first step: loss plain f32 {plain_loss:.6f}, kernel f32 "
        f"{k32_loss:.6f}, kernel bf16 {k16_loss:.6f}; worst gradient rel L2 "
        f"f32 {g32_err:.3e}, bf16 {g16_err:.3e} of its limit; BN stats max "
        f"err {stat_err:.3e}; skipped (norm < 1e-3): {skipped}; largest "
        f"|flow| per head of the plain f32 step (full-resolution px) "
        f"{flows}")
    log("  bf16 gradient rel L2 (kernel, plain autocast) vs f32 plain, "
        "worst 8: " + json.dumps(sorted(rel16.items(),
                                        key=lambda kv: -kv[1][0])[:8]))
    log("  f32 gradient rel L2 (kernel, plain on the reversed batch) vs f32 "
        "plain, worst 4: " + json.dumps(sorted(
            ((k, (float((k32_g[k] - w).norm()) / float(w.norm()),
                  float((rev_g[k] - w).norm()) / float(w.norm())))
             for k, w in plain_g.items() if k not in skipped),
            key=lambda kv: -kv[1][0])[:4]))
    del model, plain_g, rev_g, k32_g, k16_g, p16_g

    # the training main path: train() on the kernels, counts from 0
    events, launches, losses = [], [], []

    def on_step(step, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        launches.append(dict(_build.LAUNCHES))
        losses.append(metrics["live_loss"])

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    ckpt = train(cfg, max_steps=WARMUP_STEPS + TIMED_STEPS - 1,
                 data_loader=data, device=device, on_step=on_step)
    torch.cuda.synchronize()
    run_launches = dict(_build.LAUNCHES)
    per_step = [{k: v - prev.get(k, 0) for k, v in cur.items()}
                for prev, cur in zip([{}] + launches, launches)]
    for i, counts in enumerate(per_step):
        if counts != expected:
            raise AssertionError(f"{name} step {i} launches {counts}, "
                                 f"expected {expected}")
    loss_values = [float(v) for v in losses]
    if len(loss_values) != WARMUP_STEPS + TIMED_STEPS or not all(
            math.isfinite(v) for v in loss_values):
        raise AssertionError(f"train() losses {loss_values}")
    ms = [events[i - 1].elapsed_time(events[i])
          for i in range(WARMUP_STEPS, len(events))]
    model, *_, state = create_train_state(cfg, seed=SEED, device=device)
    restore_checkpoint(ckpt, state)
    if state.step != len(loss_values):
        raise AssertionError(f"checkpoint step {state.step}")
    shutil.rmtree(cfg.path)
    result = dict(step_ms_median=statistics.median(ms), step_ms_min=min(ms),
                  step_ms=ms, losses=loss_values, launches=run_launches,
                  launches_per_step=per_step[-1],
                  first_step=dict(loss_plain_f32=plain_loss,
                                  loss_kernel_f32=k32_loss,
                                  loss_kernel_bf16=k16_loss,
                                  grad_f32_over_limit=g32_err,
                                  grad_bf16_over_limit=g16_err,
                                  bn_stat_max_err=stat_err,
                                  skipped=skipped, max_abs_flow=flows))
    log(f"  {name} train(): {len(loss_values)} bf16 steps, launches per step "
        f"{per_step[-1]}, step median {result['step_ms_median']:.3f} ms, "
        f"min {result['step_ms_min']:.3f} ms; losses {loss_values}")
    return result


# ---------------------------------------------------------------------------
# eval: the trained v2 and v3 through the evaluation entry point
# ---------------------------------------------------------------------------


def _eval_pixels(runners, model, left, right, what) -> tuple[list, float]:
    """Against the plain model with the same banded warp: the float32
    kernel path per head (rtol 1e-3, atol 5e-2), and the bf16 kernel path's
    final head by its median |d| (at most ``EVAL_BF16_MEDIAN_PX``).
    Returns the float32 max abs errors and the bf16 median."""
    with torch.no_grad():
        plain = model(left, right, banded_warp=True)
    fast = runners["f32 kernel path"](left, right)
    f32 = [_compare(g, w, (5e-2, 1e-3), f"{what} head {i}")
           for i, (g, w) in enumerate(zip(fast, plain))]
    final = runners["bf16 kernel path"](left, right)[-1]
    if final.shape != plain[-1].shape or not bool(
            torch.isfinite(final).all()):
        raise AssertionError(f"{what} bf16 output {tuple(final.shape)}")
    median = float((final.float() - plain[-1]).abs().median())
    if not median <= EVAL_BF16_MEDIAN_PX:
        raise AssertionError(f"{what} bf16 kernel path median |d| {median} "
                             f"px against the banded plain model")
    return f32, median


def check_eval(device, name: str, per_frame: dict) -> dict:
    """The trained ``name`` (v2 or v3) through ``evaluate.main`` (the main
    path, launches counted) and ``validate_synthetic`` with three runners,
    held to the JAX package's held-out metrics (phase 10a)."""
    spec = json.loads(HELD_OUT.read_text())[name]
    want = spec["validate_synthetic"]
    config_path, weights = ROOT / spec["config"], ROOT / spec["weights"]
    config = load_config(config_path)
    if not config.model.mixed_precision:
        raise AssertionError(f"{name}: the eval main path is bf16")

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    main_path = evaluate.main([f"--exp_config_json={config_path}",
                               f"--model_chkpt_file={weights}",
                               f"--device={device}"])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    # one padded shape: the scenes, then the latency's warm-up and timed runs
    forwards = (EVAL_SCENES + validators.LATENCY_WARMUP
                + validators.LATENCY_ITERS)
    if launches != {k: v * forwards for k, v in per_frame.items()}:
        raise AssertionError(f"{name} eval launches {launches} over "
                             f"{forwards} forwards, expected {per_frame} "
                             f"a forward")
    log(f"  {name} evaluate.main (bf16 kernel path): {json.dumps(main_path)}"
        f"; launches {launches} = {per_frame} x {forwards} forwards")

    model = build_model(config.model.as_dict(), device=device)
    load_weights(weights, model)
    runners = {
        "bf16 kernel path": validators.ModelRunner(
            model, fast=True, dtype=torch.bfloat16, device=device),
        "f32 kernel path": validators.ModelRunner(
            model, fast=True, dtype=torch.float32, device=device),
        "plain f32": validators.ModelRunner(model, fast=False, device=device)}
    metrics = {k: validators.validate_synthetic(r, n_images=EVAL_SCENES)
               for k, r in runners.items()}
    plain, f32, bf16 = (metrics[k] for k in ("plain f32", "f32 kernel path",
                                             "bf16 kernel path"))
    gaps = dict(
        plain_epe_vs_jax=plain["synthetic-epe"] - want["synthetic-epe"],
        plain_d1_vs_jax=plain["synthetic-d1"] - want["synthetic-d1"],
        f32_epe_vs_plain=f32["synthetic-epe"] - plain["synthetic-epe"],
        bf16_epe_vs_plain=bf16["synthetic-epe"] - plain["synthetic-epe"],
        bf16_d1_vs_plain=bf16["synthetic-d1"] - plain["synthetic-d1"],
        main_path_epe_vs_bf16=(main_path["synthetic-epe"]
                               - bf16["synthetic-epe"]))
    log(f"  {name} validate_synthetic: {json.dumps(metrics)}; JAX "
        f"(held_out.json) {json.dumps(want)}; gaps {json.dumps(gaps)}")

    # per scene: the f32 kernel path's max abs err per head and the bf16
    # kernel path's median |d|, against the banded plain model
    pixels, medians = [], []
    scenes = SyntheticStereo(length=EVAL_PIXEL_SCENES, seed0=10 ** 6)
    for i in range(EVAL_PIXEL_SCENES):
        _, image1, image2, _, _ = scenes[i]
        left, right, _ = validators._prep(image1, image2, device)
        f32_err, median = _eval_pixels(runners, model, left, right,
                                       f"{name} scene {i}")
        pixels.append(f32_err)
        medians.append(median)
    left, right, _, _ = make_scene(10 ** 6, *KITTI_PADDED_HW)
    left, right = (torch.from_numpy(a[None].astype("float32")).to(device)
                   for a in (left, right))
    kitti, kitti_median = _eval_pixels(runners, model, left, right,
                                       f"{name} {KITTI_PADDED_HW}")
    log(f"  {name} against the banded plain model: f32 kernel path max abs "
        f"err per head, scenes {pixels}, KITTI shape {kitti}; bf16 kernel "
        f"path median |d| px, scenes {medians}, KITTI shape {kitti_median}")

    if not abs(gaps["plain_epe_vs_jax"]) <= EVAL_PLAIN_EPE_TOL:
        raise AssertionError(f"{name} plain f32 EPE {plain['synthetic-epe']}"
                             f" against the JAX package's "
                             f"{want['synthetic-epe']}")
    if not abs(gaps["plain_d1_vs_jax"]) <= EVAL_PLAIN_D1_TOL:
        raise AssertionError(f"{name} plain f32 D1 {plain['synthetic-d1']} "
                             f"against the JAX package's "
                             f"{want['synthetic-d1']}")
    if not abs(gaps["f32_epe_vs_plain"]) <= EVAL_F32_EPE_TOL:
        raise AssertionError(f"{name} f32 kernel path EPE "
                             f"{f32['synthetic-epe']} against plain "
                             f"{plain['synthetic-epe']}")
    if not (gaps["bf16_epe_vs_plain"] <= EVAL_BF16_EPE_GAP
            and gaps["bf16_d1_vs_plain"] <= EVAL_BF16_D1_GAP):
        raise AssertionError(f"{name} bf16 kernel path EPE / D1 "
                             f"{bf16['synthetic-epe']} / "
                             f"{bf16['synthetic-d1']} against plain "
                             f"{plain['synthetic-epe']} / "
                             f"{plain['synthetic-d1']}")
    return dict(launches={k: v // forwards for k, v in launches.items()},
                launches_run=launches, forwards=forwards,
                evaluate_main=main_path, validate_synthetic=metrics,
                jax_held_out=want, gaps=gaps, f32_pixel_err=pixels,
                f32_pixel_err_kitti=kitti, bf16_median_px=medians,
                bf16_median_px_kitti=kitti_median)


# ---------------------------------------------------------------------------
# train config: a committed training config through the train entry point
# ---------------------------------------------------------------------------


class _Records(logging.Handler):
    """Keeps the log records of a run (the trainer says which data path it
    took, and the pack's size and seconds)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def train_config_file(name: str, config: pathlib.Path = TRAIN_CONFIG,
                      **train_changes) -> pathlib.Path:
    """``config`` with its ``path`` under ``_runs/<name>`` and
    ``train_changes`` in its train section, written to ``_runs/<name>.json``
    (``_runs/`` is gitignored); an earlier run's directory there is
    removed."""
    raw = json.loads(config.read_text())
    raw["path"] = str(ROOT / "_runs" / name)
    shutil.rmtree(raw["path"], ignore_errors=True)  # a fresh metric log
    raw["train"].update(train_changes)
    out = ROOT / "_runs" / f"{name}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(raw, indent=2))
    return out


def run_train_config(device, config_path, max_steps: int,
                     on_batch=None, first_step: int = 0,
                     expected: dict = LAUNCHES_PER_STEP) -> dict:
    """``train_stereo.main`` on ``config_path`` (the bf16 kernel train path)
    with every step's launches held to ``expected`` (``LAUNCHES_PER_STEP``;
    none on the plain step of V4 and DispNetC) and its loss finite; the
    resident path must be taken.  Returns the losses, the
    launches, the step times by CUDA events after ``WARMUP_STEPS`` (where
    the run has more), and the pack's scenes, GB and seconds as the trainer
    logged them.  ``first_step``: the step a restored checkpoint starts
    from."""
    events, launches, losses = [], [], []

    def on_step(step, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        launches.append(dict(_build.LAUNCHES))
        losses.append(metrics["live_loss"])

    handler = _Records()
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        final = train_stereo.main([f"--exp_config_json={config_path}",
                                   f"--max_steps={max_steps}",
                                   f"--device={device}"],
                                  on_step=on_step, on_batch=on_batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    messages = [r.getMessage() for r in handler.records]
    resident = [r for r in handler.records
                if r.msg.startswith("Device-resident dataset:")]
    if not resident:
        raise AssertionError(f"{config_path}: the resident path was not "
                             f"taken: {messages}")
    scenes, gb, _, pack_s = resident[0].args
    per_step = [{k: v - prev.get(k, 0) for k, v in cur.items()}
                for prev, cur in zip([{}] + launches, launches)]
    for i, counts in enumerate(per_step):
        if counts != expected:
            raise AssertionError(f"{config_path} step {i} launches {counts}, "
                                 f"expected {expected}")
    loss_values = [float(v) for v in losses]
    if len(loss_values) != max_steps + 1 - first_step or not all(
            math.isfinite(v) for v in loss_values):
        raise AssertionError(f"{config_path} losses {loss_values}")
    ms = [events[i - 1].elapsed_time(events[i])
          for i in range(WARMUP_STEPS + 1, len(events))]
    return dict(final=final, steps=len(loss_values), losses=loss_values,
                launches=dict(_build.LAUNCHES),
                launches_per_step=per_step[-1], scenes=scenes,
                resident_gb=gb, pack_s=pack_s,
                generated=any(m.startswith("Packed ") for m in messages),
                step_ms=ms, step_ms_median=statistics.median(ms) if ms else None,
                seconds=seconds)


def check_metric_log(run: dict, cfg) -> dict:
    """The run's ``scalars.jsonl`` holds the rows the JAX package's logger
    writes: one a step (its live loss as the step returned it, the
    schedule's learning rate), and at every push k with k % sum_freq ==
    sum_freq - 1 the running means, summed over those pushes and divided by
    sum_freq."""
    rows = [json.loads(line) for line in (pathlib.Path(cfg.path) / "runs" /
                                          "scalars.jsonl").read_text().splitlines()]
    per_step = [r for r in rows if "learning_rate" in r]
    means = [r for r in rows if "learning_rate" not in r]
    n, losses = run["steps"], run["losses"]
    schedule = onecycle_schedule(cfg.train.learn_rate, cfg.train.num_of_steps)
    if [r["step"] for r in per_step] != list(range(n)):
        raise AssertionError(f"metric log steps {[r['step'] for r in per_step]}")
    for r in per_step:
        if (r["live_loss"] != losses[r["step"]]
                or r["learning_rate"] != schedule(r["step"])):
            raise AssertionError(f"metric log row {r}")
    freq = METRIC_SUM_FREQ
    want_steps = [k - 1 for k in range(1, n + 1) if k % freq == freq - 1]
    if [r["step"] for r in means] != want_steps:
        raise AssertionError(f"mean rows at {[r['step'] for r in means]}, "
                             f"expected {want_steps}")
    lo = 0
    for r in means:
        want = sum(losses[lo:r["step"] + 1]) / freq
        if not math.isclose(r["live_loss"], want, rel_tol=1e-12):
            raise AssertionError(f"mean row {r}, live loss {want}")
        lo = r["step"] + 1
    return dict(rows=len(rows), mean_rows=[r["step"] for r in means])


def check_augment_on_card(device, cfg) -> dict:
    """``apply_augment`` on the card against the same call on the CPU, at
    the config's shapes (8 raw 320 x 448 scenes from the resident fetch,
    240 x 320 crops), with the same params, both colour branches and the
    eraser on and off."""
    packed = pack_synthetic(SyntheticStereo(length=cfg.train.batch_size),
                            cache_dir=None)
    resident = DeviceResidentScenes(packed, device=device)
    b = resident.length
    raw = resident.fetch(torch.arange(b, device=device))
    spec = AugmentSpec.from_aug_params(cfg.aug_params(), resident.image_hw)
    u = torch.rand((b, N_UNIFORMS), generator=step_generator(0, device),
                   device=device)
    params = draw_params(spec, u)
    k = torch.arange(b, device=device)
    params["asym"], params["eraser_on"] = k % 2 == 1, k // 2 % 2 == 1
    got = apply_augment(spec, params, *raw)
    want = apply_augment(spec, {n: t.cpu() for n, t in params.items()},
                         *(t.cpu() for t in raw))
    err = [float((g.cpu() - w).abs().max()) for g, w in zip(got, want)]
    if not (err[0] <= AUG_TOL_IMG and err[1] <= AUG_TOL_IMG
            and err[2] <= AUG_TOL_FLOW and err[3] == 0.0):
        raise AssertionError(f"augmentation on the card against the CPU: "
                             f"max abs err img1, img2, flow, valid {err}")
    if got[0].shape != (b, *cfg.data.image_size, 3):
        raise AssertionError(f"augmented shape {tuple(got[0].shape)}")
    return dict(max_abs_err=dict(zip(("img1", "img2", "flow", "valid"), err)))


def check_resume(device) -> dict:
    """An epoch of 8 batches (64 scenes): the uninterrupted run's step 8
    against step 8 resumed from the checkpoint of step 8 (an epoch
    boundary): the same augmented batch, bit for bit, and the loss within
    ``RESUME_LOSS_RTOL``."""
    first, again = {}, {}

    def keep(into):
        def on_batch(step, batch):
            if step == RESUME_STEP:
                into[step] = [t.clone() for t in batch]
        return on_batch

    path_a = train_config_file("chip_smoke_resume_a", datasets=RESUME_DATASETS,
                               save_checkpoint_frequency=RESUME_STEP)
    run_a = run_train_config(device, path_a, RESUME_STEP, keep(first))
    ckpt = (pathlib.Path(load_config(path_a).path) / "checkpoints" /
            f"{load_config(path_a).name}-epoch-{RESUME_STEP}.ckpt")
    path_b = train_config_file("chip_smoke_resume_b", datasets=RESUME_DATASETS,
                               save_checkpoint_frequency=RESUME_STEP,
                               restore_checkpoint=str(ckpt))
    run_b = run_train_config(device, path_b, RESUME_STEP, keep(again),
                             first_step=RESUME_STEP)
    scenes = int(RESUME_DATASETS[0].split("_")[1])
    if (run_a["scenes"] != scenes or scenes // TRAIN_B_V23 != RESUME_STEP
            or sorted(again) != [RESUME_STEP]):
        raise AssertionError(f"resume runs: {run_a['scenes']} scenes, "
                             f"steps {sorted(again)}")
    same = [torch.equal(a, b) for a, b in zip(first[RESUME_STEP],
                                               again[RESUME_STEP])]
    loss_a, loss_b = run_a["losses"][RESUME_STEP], run_b["losses"][0]
    rel = abs(loss_b - loss_a) / abs(loss_a)
    if not all(same) or not rel <= RESUME_LOSS_RTOL:
        raise AssertionError(f"resumed step {RESUME_STEP}: batch equal "
                             f"{same}, loss {loss_b} against {loss_a}")
    for p in (path_a, path_b):
        shutil.rmtree(load_config(p).path)
        p.unlink()
    return dict(batch_bit_equal=True, loss=loss_a, loss_resumed=loss_b,
                loss_rel_err=rel)


def time_without_augment(device, cfg) -> dict:
    """The same config's kernel step on pre-made batches (no resident
    fetch, no augmentation): the step median by CUDA events."""
    cfg = dataclasses.replace(cfg, path=str(ROOT / "_runs" /
                                            "chip_smoke_no_augment"))
    cfg.train = dataclasses.replace(cfg.train, device_augment=False)
    data = SyntheticBatches(cfg.train.batch_size, tuple(cfg.data.image_size),
                            n_batches=WARMUP_STEPS + TIMED_STEPS, seed0=SEED,
                            device=device)
    events = []

    def on_step(step, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    train(cfg, max_steps=WARMUP_STEPS + TIMED_STEPS - 1, data_loader=data,
          device=device, on_step=on_step)
    torch.cuda.synchronize()
    shutil.rmtree(cfg.path)
    ms = [events[i - 1].elapsed_time(events[i])
          for i in range(WARMUP_STEPS + 1, len(events))]
    return dict(step_ms_median=statistics.median(ms), step_ms=ms)


def check_train_config(device, smi: str) -> dict:
    """Phase "train config": ``TRAIN_CONFIG`` through the train entry point
    at its full width, its one cut ``TRAIN_CONFIG_DATASETS``; its metric
    log, the augmentation on the card against the CPU, resume at an epoch
    boundary, and the step without augmentation."""
    path = train_config_file("chip_smoke_train_config",
                             datasets=TRAIN_CONFIG_DATASETS)
    cfg = load_config(path)
    if not (cfg.train.device_augment and cfg.model.mixed_precision
            and cfg.train.fast_kernels == "auto"
            and (cfg.train.batch_size, tuple(cfg.data.image_size))
            == (TRAIN_B_V23, TRAIN_HW_V23)):
        raise AssertionError(f"{TRAIN_CONFIG.name}: not the v2 synthetic "
                             f"config's train section")
    caches = [cache_path(SyntheticStereo(length=n))
              for n in (int(d.split("_")[1])
                        for d in TRAIN_CONFIG_DATASETS + RESUME_DATASETS)]
    new_caches = [c for c in caches if not c.exists()]
    run = run_train_config(device, path, TRAIN_CONFIG_STEPS - 1)
    log(f"  train config: {TRAIN_CONFIG.name}, datasets "
        f"{TRAIN_CONFIG_DATASETS}: pack {run['pack_s']:.3f} s "
        f"({'generated' if run['generated'] else 'from the disk cache'}), "
        f"{run['scenes']} scenes, {run['resident_gb']:.4f} GB resident; "
        f"{run['steps']} bf16 steps, launches per step "
        f"{run['launches_per_step']}, step median "
        f"{run['step_ms_median']:.3f} ms | {smi}")
    metric_log = check_metric_log(run, cfg)
    shutil.rmtree(cfg.path)
    path.unlink()
    augment = check_augment_on_card(device, cfg)
    resume = check_resume(device)
    plain = time_without_augment(device, cfg)
    for c in new_caches:
        c.unlink(missing_ok=True)
    log(f"  train config: step median with the resident fetch and "
        f"augmentation {run['step_ms_median']:.3f} ms, without (pre-made "
        f"batches) {plain['step_ms_median']:.3f} ms | {smi}")
    log(f"  train config: metric log {json.dumps(metric_log)}; augmentation "
        f"on the card against the CPU {json.dumps(augment)}; resume "
        f"{json.dumps(resume)}")
    return dict(run, final=None, metric_log=metric_log, augment=augment,
                resume=resume, step_ms_median_without_augment=plain[
                    "step_ms_median"], step_ms_without_augment=plain["step_ms"])


def profile_augment(device) -> dict:
    """What the resident path adds to a step, under the profiler: the fetch
    of 8 scenes by index and their augmentation to the config's crops --
    device ms and launches per step."""
    cfg = load_config(TRAIN_CONFIG)
    packed = pack_synthetic(SyntheticStereo(length=cfg.train.batch_size),
                            cache_dir=None)
    resident = DeviceResidentScenes(packed, device=device)
    spec = AugmentSpec.from_aug_params(cfg.aug_params(), resident.image_hw)
    augment = make_device_augment(spec)
    idx = torch.arange(resident.length, device=device)
    prof = frame_profile.profile_device(
        lambda: augment(0, *resident.fetch(idx)), 5)
    return dict(device_ms=prof["device_ms_per_frame"],
                span_ms=prof["span_ms_per_frame"],
                launches=sum(g["launches_per_frame"]
                             for g in prof["groups"].values()))


def time_train_config(device, smi: str, max_steps: int) -> None:
    """``--train-config-steps n``: ``TRAIN_CONFIG`` as committed (its
    ``synthetic_4000`` resident, 4.59 GB; its train section; only its
    ``path`` moved under ``_runs/``) through the train entry point for
    n + 1 steps, held as phase "train config" holds its run (resident path,
    ``LAUNCHES_PER_STEP`` every step, finite losses).  Prints one JSON line:
    the pack's seconds (scene generation and the disk cache's write, or its
    read) and GB, the step median and min by CUDA events after the warm-up
    steps, the run's seconds, and the ``nvidia-smi`` name and power limit."""
    path = train_config_file("chip_smoke_train_config_full")
    run = run_train_config(device, path, max_steps)
    shutil.rmtree(load_config(path).path)
    path.unlink()
    log(json.dumps({
        "config": str(TRAIN_CONFIG.relative_to(ROOT)),
        "scenes": run["scenes"], "resident_gb": run["resident_gb"],
        "pack_s": run["pack_s"], "pack_generated": run["generated"],
        "steps": run["steps"], "step_ms_median": run["step_ms_median"],
        "step_ms_min": min(run["step_ms"]), "run_s": run["seconds"],
        "launches_per_step": run["launches_per_step"],
        "loss_first_last": [run["losses"][0], run["losses"][-1]],
        "nvidia_smi": smi}))
    log(smi)


# ---------------------------------------------------------------------------
# v4, dispnetc: the two model families without a kernel path
# ---------------------------------------------------------------------------

# each family's repo config (its seeded full-width model and train section)
# and its committed synthetic training config
NEW_MODELS = {
    "v4": dict(config=ROOT / "configure" / "stereo_net_config_v4.json",
               train_config=(ROOT / "configure"
                             / "stereo_net_v4_synthetic_config.json")),
    "dispnetc": dict(config=ROOT / "configure" / "disp_net_c_config.json",
                     train_config=(ROOT / "configure"
                                   / "disp_net_c_synthetic_config.json")),
}
# the plain float32 model (TF32 off) against the JAX package's float32
# held-out EPE (px) and D1 (points); bf16 autocast against float32
NEW_EVAL_EPE_TOL, NEW_EVAL_D1_TOL = 1e-4, 0.01
# one seeded float32 forward on the card against the CPU: median |d| (px)
CARD_CPU_HW, CARD_CPU_MEDIAN_PX = (128, 192), 1e-3
# the first float32 training step on the card against the CPU
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_STAT_TOL = 1e-4, 1e-3, 1e-4
# the step on the card against the CPU, held to the CPU's float64 step: V4
# at batch 2 (its CPU steps at batch 6 take ~2.5 min on the 8 cores of the
# card's host, at 2 ~30 s), DispNetC at its config's batch
STEP_BATCH = {"v4": 2}
# the float32 step against the float32 floor (see ``_step_on_card_and_cpu``;
# the bound of tests/test_torch_port_v4_train.py)
F32_FLOOR_SLACK = 16.0
# the committed synthetic config through train_stereo: its one cut the
# dataset, 64 scenes, for 20 steps
NEW_CONFIG_DATASETS, NEW_CONFIG_STEPS = ["synthetic_64"], 20


def _plain_step(model, batch, loss_fn, dtype=torch.float32) -> tuple:
    """The loss, gradients and new running stats of one plain train-mode
    step on a copy of ``model`` in ``dtype`` (the model is left as it
    was)."""
    model = copy.deepcopy(model).to(dtype).train()
    img1, img2, flow, valid = batch
    preds = model(img1.to(dtype), img2.to(dtype))
    loss = loss_fn(preds, flow, valid)
    loss.backward()
    grads = {k: p.grad.detach().double().cpu()
             for k, p in model.named_parameters()}
    stats = {k: v.double().cpu() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return float(loss.detach()), grads, stats


def _step_on_card_and_cpu(device, name, cfg) -> dict:
    """The first training step from the train-start init on the card
    against the same step on the CPU (module docstring, phase 10c): float64
    held outright to the CPU's float64 step; float32 held to it against
    the float32 floor, the larger error of the CPU's float32 step and of
    the card's on the batch reversed (the same sums in another order)."""
    hw = tuple(cfg.data.image_size)
    b = STEP_BATCH.get(name, cfg.train.batch_size)
    cpu_model, *_ = create_train_state(cfg, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(device)
    loss_fn = build_loss_function({"type": cfg.train.loss.type,
                                   "parameters": cfg.train.loss.parameters})
    batch = next(iter(SyntheticBatches(b, hw, seed0=SEED,
                                       max_disp=96.0 * hw[1] / 640)))[1:]
    card_batch = tuple(t.to(device) for t in batch)
    steps, cpu_s = {}, {}
    for dtype in (torch.float64, torch.float32):
        key = str(dtype)[6:]
        t0 = time.perf_counter()
        steps["cpu", key] = _plain_step(cpu_model, batch, loss_fn, dtype)
        cpu_s[key] = time.perf_counter() - t0
        steps["card", key] = _plain_step(card_model, card_batch, loss_fn,
                                         dtype)
    steps["card", "reversed"] = _plain_step(
        card_model, tuple(t.flip(0) for t in card_batch), loss_fn,
        torch.float32)
    want_loss, want, want_stats = steps["cpu", "float64"]

    def err(g):  # per tensor: relative L2 from the float64 step
        return {k: float((g[k] - w).norm()) / float(w.norm())
                for k, w in want.items()}

    floors = [err(steps[side, key][1]) for side, key in
              (("cpu", "float32"), ("card", "reversed"))]
    floor = {k: max(f[k] for f in floors) for k in want}
    stat_floor = {k: max(float((steps[side, key][2][k] - w).abs().max())
                         for side, key in (("cpu", "float32"),
                                           ("card", "reversed")))
                  for k, w in want_stats.items()}
    result = dict(batch=b, crop=hw, cpu_s=cpu_s, loss_cpu_float64=want_loss)
    for key in ("float64", "float32"):
        loss, grads, stats = steps["card", key]
        if not abs(loss - want_loss) <= STEP_LOSS_RTOL * abs(want_loss):
            raise AssertionError(f"{name} {key} step loss on the card {loss}"
                                 f" against the CPU's float64 {want_loss}")
        # parameters whose gradient is ~0 (< 1e-3: zero by construction,
        # such as a bias before a train-mode BatchNorm) are skipped, as
        # ``_grad_errors`` skips them
        rel, bad, over = err(grads), [], 0.0
        for k, w in want.items():
            if float(w.norm()) < 1e-3:
                continue
            limit = STEP_GRAD_RTOL if key == "float64" else max(
                STEP_GRAD_RTOL, F32_FLOOR_SLACK * floor[k])
            over = max(over, rel[k] / limit)
            if not rel[k] <= limit:
                bad.append(f"{k} off by {rel[k]:.3e} (limit {limit:.3e})")
        s_err = 0.0
        for k, w in want_stats.items():
            e = float((stats[k] - w).abs().max())
            limit = STEP_STAT_TOL if key == "float64" else max(
                STEP_STAT_TOL, F32_FLOOR_SLACK * stat_floor[k])
            s_err = max(s_err, e)
            if not e <= limit:
                bad.append(f"running stat {k} off by {e:.3e} (limit "
                           f"{limit:.3e})")
        if bad:
            raise AssertionError(f"{name} {key} step on the card against the"
                                 f" CPU's float64: {'; '.join(bad)}")
        checked = [k for k, w in want.items() if float(w.norm()) >= 1e-3]
        result[key] = dict(loss_card=loss, grad_worst_over_limit=over,
                           grad_rel_l2_worst=max(rel[k] for k in checked),
                           stat_max_err=s_err,
                           skipped=len(want) - len(checked))
    result["float32_floor_grad_rel_l2_worst"] = max(
        floor[k] for k in want if float(want[k].norm()) >= 1e-3)
    return result


def _frames_720p(device, model) -> dict:
    """1280 x 720 batch-1 frames of the trained model, float32 and bf16
    autocast: min and median ms over ``TIMED_STEPS`` frames after
    ``WARMUP_STEPS``, by CUDA events; the bf16 final map's median |d|
    against the float32 one."""
    left, right, _, _ = make_scene(SEED, *HW)
    left, right = (torch.from_numpy(a[None].astype("float32")).to(device)
                   for a in (left, right))
    out, finals = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        runner = validators.ModelRunner(
            model, fast=False if dtype == torch.float32 else "auto",
            dtype=dtype, device=device)
        if runner.dtype != dtype:
            raise AssertionError(f"runner dtype {runner.dtype}")
        ms = []
        for i in range(WARMUP_STEPS + TIMED_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            final = runner(left, right)[-1]
            end.record()
            end.synchronize()
            if i >= WARMUP_STEPS:
                ms.append(start.elapsed_time(end))
        finals[dtype] = final.float()
        out[str(dtype)[6:]] = dict(ms_min=min(ms),
                                   ms_median=statistics.median(ms), ms=ms)
    f32, bf16 = finals[torch.float32], finals[torch.bfloat16]
    if bf16.shape != (1, *HW, 1) or not bool(torch.isfinite(bf16).all()):
        raise AssertionError(f"720p bf16 output {tuple(bf16.shape)}")
    median = float((bf16 - f32).abs().median())
    if not median <= EVAL_BF16_MEDIAN_PX:
        raise AssertionError(f"720p bf16 median |d| {median} px")
    out["bf16_median_px"] = median
    return out


def _train_step_times(device, name, cfg) -> dict:
    """``train()`` in bf16 on the config's train section (pre-made batches
    on the card), 2 + 8 steps: median and min ms by CUDA events."""
    cfg = copy.deepcopy(cfg)
    cfg.path = str(ROOT / "_runs" / f"chip_smoke_train_{name}")
    b, hw = cfg.train.batch_size, tuple(cfg.data.image_size)
    data = SyntheticBatches(b, hw, n_batches=WARMUP_STEPS + TIMED_STEPS,
                            seed0=SEED, max_disp=96.0 * hw[1] / 640,
                            device=device)
    events, losses = [], []

    def on_step(step, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(metrics["live_loss"])

    train(cfg, max_steps=WARMUP_STEPS + TIMED_STEPS - 1, data_loader=data,
          device=device, on_step=on_step)
    torch.cuda.synchronize()
    shutil.rmtree(cfg.path)
    ms = [events[i - 1].elapsed_time(events[i])
          for i in range(WARMUP_STEPS, len(events))]
    values = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{name} train() losses {values}")
    return dict(batch=b, crop=hw, step_ms_median=statistics.median(ms),
                step_ms_min=min(ms), step_ms=ms, losses=values)


def check_new_model(device, name: str, smi: str) -> dict:
    """Phase "v4" / "dispnetc" (module docstring, phase 10c)."""
    spec = json.loads(HELD_OUT.read_text())[name]
    want = spec["validate_synthetic"]
    config_path, weights = ROOT / spec["config"], ROOT / spec["weights"]
    config = load_config(config_path)
    if not config.model.mixed_precision:
        raise AssertionError(f"{name}: the eval main path is bf16")
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()

    # the trained model: evaluate.main (plain forward, bf16 autocast), then
    # the plain float32 model
    bf16 = evaluate.main([f"--exp_config_json={config_path}",
                          f"--model_chkpt_file={weights}",
                          f"--device={device}"])
    model = build_model(config.model.as_dict(), device=device)
    load_weights(weights, model)
    f32 = validators.validate_synthetic(
        validators.ModelRunner(model, fast=False, device=device),
        n_images=EVAL_SCENES)
    gaps = dict(
        f32_epe_vs_jax=f32["synthetic-epe"] - want["synthetic-epe"],
        f32_d1_vs_jax=f32["synthetic-d1"] - want["synthetic-d1"],
        bf16_epe_vs_f32=bf16["synthetic-epe"] - f32["synthetic-epe"],
        bf16_d1_vs_f32=bf16["synthetic-d1"] - f32["synthetic-d1"])
    log(f"  {name} held-out: float32 {json.dumps(f32)}, bf16 (evaluate.main)"
        f" {json.dumps(bf16)}; JAX (held_out.json) {json.dumps(want)}; gaps "
        f"{json.dumps(gaps)} | {smi}")
    if not (abs(gaps["f32_epe_vs_jax"]) <= NEW_EVAL_EPE_TOL
            and abs(gaps["f32_d1_vs_jax"]) <= NEW_EVAL_D1_TOL):
        raise AssertionError(f"{name} float32 held-out {f32} against the JAX "
                             f"package's {want}")
    if not (abs(gaps["bf16_epe_vs_f32"]) <= EVAL_BF16_EPE_GAP
            and abs(gaps["bf16_d1_vs_f32"]) <= EVAL_BF16_D1_GAP):
        raise AssertionError(f"{name} bf16 held-out {bf16} against float32 "
                             f"{f32}")
    frames = _frames_720p(device, model)
    log(f"  {name} 720p frames (trained): float32 min "
        f"{frames['float32']['ms_min']:.3f} / median "
        f"{frames['float32']['ms_median']:.3f} ms, bf16 min "
        f"{frames['bfloat16']['ms_min']:.3f} / median "
        f"{frames['bfloat16']['ms_median']:.3f} ms, bf16 median |d| "
        f"{frames['bf16_median_px']:.4f} px | {smi}")
    del model

    # a seeded full-width model of the repo config (its train-start init:
    # torch's default init leaves V4's output constant) in eval mode: one
    # float32 forward on the card against the CPU
    cfg = load_config(NEW_MODELS[name]["config"])
    seeded, *_ = create_train_state(cfg, seed=SEED, device="cpu")
    seeded.eval()
    left, right = (torch.rand(1, *CARD_CPU_HW, 3, generator=torch.Generator()
                              .manual_seed(i)) * 255 for i in range(2))
    with torch.no_grad():
        cpu = seeded(left, right)
        card = seeded.to(device)(left.to(device), right.to(device))
    diffs = [(c.cpu() - w).abs() for c, w in zip(card, cpu)]
    card_cpu = dict(median_px=[float(d.median()) for d in diffs],
                    max_px=[float(d.max()) for d in diffs],
                    output_std_px=[float(w.std()) for w in cpu])
    log(f"  {name} seeded float32 forward at {CARD_CPU_HW}, card against CPU"
        f" per head: {json.dumps(card_cpu)}")
    if not max(card_cpu["median_px"]) < CARD_CPU_MEDIAN_PX:
        raise AssertionError(f"{name} card against CPU {card_cpu}")
    del seeded

    step = _step_on_card_and_cpu(device, name, cfg)
    log(f"  {name} first training step, card against CPU: "
        f"{json.dumps(step)}")
    times = _train_step_times(device, name, cfg)
    log(f"  {name} train() bf16 at batch {times['batch']}, {times['crop']}: "
        f"step median {times['step_ms_median']:.3f} ms, min "
        f"{times['step_ms_min']:.3f} ms | {smi}")

    # the committed synthetic config through the train entry point
    path = train_config_file(f"chip_smoke_{name}_config",
                             NEW_MODELS[name]["train_config"],
                             datasets=NEW_CONFIG_DATASETS)
    run_cfg = load_config(path)
    run = run_train_config(device, path, NEW_CONFIG_STEPS - 1, expected={})
    metric_log = check_metric_log(run, run_cfg)
    third = NEW_CONFIG_STEPS // 3
    first, last = (statistics.mean(run["losses"][:third]),
                   statistics.mean(run["losses"][-third:]))
    if not last <= first * 1.05:
        raise AssertionError(f"{name} config run: loss rose, {run['losses']}")
    shutil.rmtree(run_cfg.path)
    path.unlink()
    log(f"  {name} train_stereo on {NEW_MODELS[name]['train_config'].name} "
        f"({NEW_CONFIG_DATASETS}): {run['steps']} steps, loss mean of the "
        f"first / last {third} {first:.4f} / {last:.4f}, step median "
        f"{run['step_ms_median']:.3f} ms, metric log {json.dumps(metric_log)}"
        f" | {smi}")

    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if launches:
        raise AssertionError(f"{name}: hand-written kernels launched on a "
                             f"path without any: {launches}")
    return dict(launches=launches, eval_float32=f32, eval_bf16=bf16,
                jax_held_out=want, gaps=gaps, frames_720p=frames,
                card_vs_cpu=card_cpu, first_step=step, train_steps=times,
                config_run=dict(steps=run["steps"], losses=run["losses"],
                                step_ms_median=run["step_ms_median"],
                                metric_log=metric_log,
                                resident_gb=run["resident_gb"]))


def new_model_phases(device, smi: str, names) -> dict:
    """Phases "v4" and "dispnetc"; the scenes their config runs pack are
    removed from the disk cache afterwards where they made them."""
    cache = cache_path(SyntheticStereo(
        length=int(NEW_CONFIG_DATASETS[0].split("_")[1])))
    made = not cache.exists()
    results = {}
    for name in names:
        with Phase(name):
            results[name] = check_new_model(device, name, smi)
    if made:
        cache.unlink(missing_ok=True)
    return results


# ---------------------------------------------------------------------------
# data parallel: the v2 kernel train step and train_stereo across processes
# ---------------------------------------------------------------------------

# two ranks: over NCCL with a card each, over gloo on one shared card
DP_WORLD = 2
# the JAX package's tolerances for its sharded float32 step against one
# device (tests/test_fast_train.py:318-340): loss, EPE (relative), the
# parameters after the update and the running stats, (rtol, atol)
DP_LOSS_RTOL, DP_EPE_RTOL = 1e-5, 1e-4
DP_PARAM_TOL, DP_STAT_TOL = (1e-3, 2e-4), (1e-4, 1e-5)
# bf16: a number may also stray 6 x as far as the one-process step on the
# batch in another order does, the farthest of these orders (_dp_compare)
DP_BF16_FLOOR_SLACK = 6.0
DP_BF16_ORDERS = {"reversed": [7, 6, 5, 4, 3, 2, 1, 0],
                  "halves swapped": [4, 5, 6, 7, 0, 1, 2, 3],
                  "interleaved": [0, 4, 1, 5, 2, 6, 3, 7]}
# v2's parameters whose gradient is zero by symmetry: the encoder head's bias
# cancels in the difference volume, the cost filter head's in the
# soft-argmin (shift invariance); bf16 noise gives them a norm, not held
DP_ZERO_GRADS = ("feature_extractor.6.bias", "cost_filter.12.bias")
# the v2 synthetic config through train_stereo on the ranks: 512 scenes,
# 256 resident on each rank, 20 steps
DP_TRAIN_DATASETS, DP_TRAIN_STEPS = ["synthetic_512"], 20
DP_DIR = ROOT / "_runs" / "chip_smoke_dp"
DP_RANKS_TIMEOUT_S = 600.0


def _dp_config_and_batch(device):
    """v2's repo config (its train section: batch 8, 240 x 320) and one
    seeded batch of it on ``device``."""
    cfg = load_config(bench.MODELS["v2"][0])
    b, hw = cfg.train.batch_size, tuple(cfg.data.image_size)
    assert (b, hw) == (TRAIN_B_V23, TRAIN_HW_V23)
    data = SyntheticBatches(b, hw, seed0=SEED,
                            max_disp=96.0 * hw[1] / TRAIN_HW[1], device=device)
    return cfg, list(next(iter(data))[1:])


def _dp_step(cfg, device, dtype, batch, group=None, timed: bool = False):
    """One v2 kernel-path step from the train-start init (rank 0's, where
    ``group``) on ``batch``: its loss and EPE, the gradients the optimizer
    was given (before the clip), the parameters and running stats after it
    (on the CPU) and the step's launches, counted from 0; with ``timed``
    then 2 + 8 more steps, ms by CUDA events."""
    model, tx, _, state = create_train_state(cfg, device=device)
    broadcast_state(state, group)
    step_fn = make_fast_train_step(model, tx, cfg.train.loss.parameters,
                                   cfg.train.loss.type, dtype=dtype,
                                   group=group)
    grads = {}
    optimizer_step = tx.step

    def step():
        grads.update({k: p.grad.detach().float().cpu()
                      for k, p in model.named_parameters()
                      if p.grad is not None})
        return optimizer_step()

    tx.step = step
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    _, metrics = step_fn(state, *batch)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    del tx.step
    out = dict(loss=float(metrics["live_loss"]), epe=float(metrics["epe"]),
               grads=grads, launches=launches,
               params={k: p.detach().cpu() for k, p in
                       model.named_parameters()},
               stats={k: v.cpu() for k, v in running_stats(model).items()})
    if timed:
        events = []
        for _ in range(WARMUP_STEPS + TIMED_STEPS + 1):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            step_fn(state, *batch)
        torch.cuda.synchronize()
        ms = [events[i - 1].elapsed_time(events[i])
              for i in range(WARMUP_STEPS + 1, len(events))]
        out.update(step_ms=ms, step_ms_median=statistics.median(ms))
    return out


@contextlib.contextmanager
def _convs_in_halves():
    """Every conv of the kernel step (the K1 / K3 autograd wrappers and the
    cuDNN convs beside them) runs on the two halves of its batch, one after
    the other: the one-process step at the ranks' conv batch, with no
    collective."""
    names = ("_conv2d_nhwc", "flat_conv3x3", "flat_conv3d")
    saved = {n: getattr(fast_train, n) for n in names}

    def in_halves(fn):
        def run(x, *args, **kwargs):
            h = x.shape[0] // 2
            return torch.cat([fn(x[:h], *args, **kwargs),
                              fn(x[h:], *args, **kwargs)])
        return run

    for n, fn in saved.items():
        setattr(fast_train, n, in_halves(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(fast_train, n, fn)


def _dp_compare(got, want, floor, what, orders=None) -> dict:
    """``got`` (a rank's step) against ``want`` (one process on the global
    batch): loss and EPE, gradients (``_grad_errors``: max(1e-2, 6 x the
    reversed-batch ``floor``)), parameters and running stats by the JAX
    package's float32 tolerances, and the launches equal.  A bf16 step
    (``orders``: the one-process bf16 steps on ``DP_BF16_ORDERS``) may also
    stray ``DP_BF16_FLOOR_SLACK`` x as far as the farthest of ``orders``
    does in its loss, EPE, parameters and running stats, and is held on
    every gradient but ``DP_ZERO_GRADS``.  Raises naming every number over
    its limit; returns the largest errors."""
    out, bad = {}, []

    def allowance(key, k=None):
        if orders is None:
            return 0.0
        if k is None:
            return DP_BF16_FLOOR_SLACK * max(abs(o[key] - want[key])
                                             for o in orders)
        return DP_BF16_FLOOR_SLACK * max(
            float((o[key][k] - want[key][k]).abs().max()) for o in orders)

    for key, rtol in (("loss", DP_LOSS_RTOL), ("epe", DP_EPE_RTOL)):
        err = abs(got[key] - want[key]) / abs(want[key])
        limit = max(rtol, allowance(key) / abs(want[key]))
        if not err <= limit:
            bad.append(f"{key} {got[key]} vs {want[key]} (rel {err:.3e}, "
                       f"limit {limit:.3e})")
        out[f"{key}_rel_err"], out[f"{key}_limit"] = err, limit
    held = want["grads"]
    if orders is not None:
        held = {k: v for k, v in held.items() if k not in DP_ZERO_GRADS}
    try:
        out["grad_over_limit"], skipped = _grad_errors(
            got["grads"], held, GRAD_RTOL_F32, what, floor["grads"],
            GRAD_F32_FLOOR_SLACK)
        out["grads_skipped"] = len(want["grads"]) - len(held) + len(skipped)
    except AssertionError as exc:
        bad.append(str(exc))
    for key, (rtol, atol) in (("params", DP_PARAM_TOL),
                              ("stats", DP_STAT_TOL)):
        worst = 0.0
        for k, w in want[key].items():
            excess = float(((got[key][k] - w).abs() - rtol * w.abs()).max())
            limit = max(atol, allowance(key, k))
            if not excess <= limit:
                bad.append(f"{key} {k}: {excess:.3e} over rtol {rtol} "
                           f"(limit {limit:.3e})")
            worst = max(worst, excess / limit)
        out[f"{key}_over_limit"] = worst
    if got["launches"] != want["launches"]:
        bad.append(f"launches {got['launches']}, one process "
                   f"{want['launches']}")
    if bad:
        raise AssertionError(f"{what}: " + "; ".join(bad))
    return out


def _dp_equal(got, want, what, keys=("grads", "params", "stats")) -> None:
    """``got`` equal to ``want`` bit for bit: loss, EPE, and every tensor of
    ``keys`` (gradients, parameters, running stats) and the launches where
    ``keys`` holds them all."""
    bad = [key for key in ("loss", "epe") if got[key] != want[key]]
    if len(keys) == 3 and got["launches"] != want["launches"]:
        bad.append("launches")
    for key in keys:
        if got[key].keys() != want[key].keys():
            bad.append(f"{key} names")
            continue
        bad += [f"{key} {k} (max diff {float((got[key][k] - w).abs().max())})"
                for k, w in want[key].items()
                if not torch.equal(got[key][k], w)]
    if bad:
        raise AssertionError(f"{what} differs from one process: "
                             + "; ".join(bad[:8]))


def _rank_device(rank: int) -> torch.device:
    """The card of rank ``rank``: ``cuda:{rank % device_count}``, made the
    current device."""
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def _dp_rank_step(out_dir: pathlib.Path) -> None:
    """A rank of the phase's step check (``--dp-rank step``): its rows of
    the saved batch through the float32 and bf16 DP steps, the bf16 one
    timed, then one bf16 step under the collective audit; results to
    ``step_rank<r>.pt``."""
    initialize(device="cuda")
    try:
        mesh = make_mesh(data=DP_WORLD)
        device = _rank_device(mesh.rank)
        cfg = load_config(bench.MODELS["v2"][0])
        batch = [t.to(device) for t in shard_batch(
            mesh, torch.load(out_dir / "batch.pt", weights_only=True))]
        out = dict(rank=mesh.rank, device=str(device),
                   backend=torch.distributed.get_backend(mesh.group))
        for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            out[key] = _dp_step(cfg, device, dtype, batch, mesh.group,
                                timed=dtype == torch.bfloat16)
        model, tx, _, state = create_train_state(cfg, device=device)
        broadcast_state(state, mesh.group)
        step_fn = make_fast_train_step(model, tx, cfg.train.loss.parameters,
                                       cfg.train.loss.type,
                                       dtype=torch.bfloat16, group=mesh.group)
        report = audit(step_fn, state, *batch)
        out["audit"] = {k: report[k] for k in ("per_op", "per_what",
                                               "total_bytes")}
        out["params"] = sum(p.numel() for p in model.parameters())
        torch.save(out, out_dir / f"step_rank{mesh.rank}.pt")
    finally:
        shutdown()


def _dp_rank_train(out_dir: pathlib.Path, config_path: str) -> None:
    """A rank of the phase's train_stereo run (``--dp-rank train``): the
    entry point as a user launches it (``RSM_*`` env vars), every step's
    launches and CUDA-event time kept; the final parameters' hash and the
    rest to ``train_rank<r>.json``."""
    states, events, launches, losses = [], [], [], []
    create = trainer.create_train_state

    def capture(*args, **kwargs):
        out = create(*args, **kwargs)
        states.append(out[-1])
        return out

    def on_step(step, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        launches.append(dict(_build.LAUNCHES))
        losses.append(metrics["live_loss"])

    trainer.create_train_state = capture
    setup_basic_logging()  # before the handler, or it would set up none
    handler = _Records()
    logging.getLogger().addHandler(handler)
    _build.LAUNCHES.clear()
    final = train_stereo.main([f"--exp_config_json={config_path}",
                               f"--max_steps={DP_TRAIN_STEPS - 1}"],
                              on_step=on_step)
    torch.cuda.synchronize()
    resident = [r.args[0] for r in handler.records
                if r.msg.startswith("Device-resident dataset:")]
    per_step = [{k: v - prev.get(k, 0) for k, v in cur.items()}
                for prev, cur in zip([{}] + launches, launches)]
    ms = [events[i - 1].elapsed_time(events[i])
          for i in range(WARMUP_STEPS + 1, len(events))]
    model = states[0].model
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().cpu().contiguous().numpy().tobytes())
    rank = int(os.environ[ENV_PROCESS_ID])
    (out_dir / f"train_rank{rank}.json").write_text(json.dumps(dict(
        rank=rank, device=str(next(model.parameters()).device),
        hash=digest.hexdigest(), final=final, steps=states[0].step,
        resident_scenes=resident,
        losses=[float(v) for v in losses], launches_per_step=per_step,
        launches=dict(_build.LAUNCHES), step_ms=ms,
        step_ms_median=statistics.median(ms))))


def check_data_parallel(device, smi: str) -> dict:
    """Phase "data parallel" (module docstring, phase 10d)."""
    _build.build()  # here, once: each rank would build it again
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    cards = torch.cuda.device_count()
    cfg, batch = _dp_config_and_batch(device)
    torch.save([t.cpu() for t in batch], DP_DIR / "batch.pt")

    # (a) the first step on 2 ranks against one process on the global batch
    t0 = time.perf_counter()
    spawn_ranks([ROOT / "chip_smoke.py", "--dp-rank", "step", DP_DIR],
                DP_WORLD, timeout=DP_RANKS_TIMEOUT_S, cwd=ROOT)
    step_s = time.perf_counter() - t0
    ranks = [torch.load(DP_DIR / f"step_rank{r}.pt", weights_only=True)
             for r in range(DP_WORLD)]
    one, errors = {}, {}
    for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        one[key] = _dp_step(cfg, device, dtype, batch,
                            timed=dtype == torch.bfloat16)
    # the ranks run every conv at their local batch: that moves no bf16
    # number of the forward, so the ranks differ from this process in the
    # order of their float32 sums only, which reordering the batch samples
    with _convs_in_halves():
        halves = _dp_step(cfg, device, torch.bfloat16, batch)
    _dp_equal(halves, one["bf16"], "bf16 step with its convs in halves",
              keys=("stats",))
    orders = {name: _dp_step(cfg, device, torch.bfloat16,
                             [t[order] for t in batch])
              for name, order in DP_BF16_ORDERS.items()}
    floors = {"f32": _dp_step(cfg, device, torch.float32,
                              [t.flip(0) for t in batch]),
              "bf16": orders["reversed"]}
    failures = []
    for key in ("f32", "bf16"):
        for r in ranks:
            try:
                errors[f"{key} rank {r['rank']}"] = _dp_compare(
                    r[key], one[key], floors[key], f"DP {key} rank "
                    f"{r['rank']}",
                    list(orders.values()) if key == "bf16" else None)
            except AssertionError as exc:
                failures.append(str(exc))
    order_rel = {n: abs(o["loss"] - one["bf16"]["loss"]) / one["bf16"]["loss"]
                 for n, o in orders.items()}
    log(f"  data parallel: one process, loss / EPE f32 {one['f32']['loss']}"
        f" / {one['f32']['epe']}, reversed {floors['f32']['loss']} / "
        f"{floors['f32']['epe']}; bf16 {one['bf16']['loss']} / "
        f"{one['bf16']['epe']}, reversed {floors['bf16']['loss']} / "
        f"{floors['bf16']['epe']}; bf16 loss rel in other orders "
        f"{json.dumps(order_rel)}; ranks f32 {ranks[0]['f32']['loss']} / "
        f"{ranks[0]['f32']['epe']}, bf16 {ranks[0]['bf16']['loss']} / "
        f"{ranks[0]['bf16']['epe']}")
    if failures:
        raise AssertionError("; ".join(failures))
    for r in ranks:
        if r["bf16"]["launches"] != LAUNCHES_PER_STEP:
            raise AssertionError(f"DP bf16 rank {r['rank']} launches "
                                 f"{r['bf16']['launches']}")
    if ranks[0]["f32"]["params"].keys() != ranks[1]["f32"]["params"].keys() \
            or any(not torch.equal(ranks[0][k]["params"][n],
                                   ranks[1][k]["params"][n])
                   for k in ("f32", "bf16") for n in ranks[0][k]["params"]):
        raise AssertionError("DP step: the ranks' parameters differ")
    audit_report = ranks[0]["audit"]
    grad_bytes = audit_report["per_what"]["gradients"]["bytes"]
    if grad_bytes != 4 * ranks[0]["params"]:
        raise AssertionError(f"gradient all-reduce {grad_bytes} B for "
                             f"{ranks[0]['params']} parameters")
    log(f"  data parallel: {DP_WORLD} ranks over "
        f"{ranks[0]['backend']} on {[r['device'] for r in ranks]} "
        f"({cards} card(s)), step check {step_s:.1f} s; first v2 step "
        f"against one process on the global batch of "
        f"{cfg.train.batch_size}: {json.dumps(errors)}")
    log(f"  data parallel: launches a rank a step f32 "
        f"{ranks[0]['f32']['launches']}, bf16 {ranks[0]['bf16']['launches']};"
        f" bf16 step median {ranks[0]['bf16']['step_ms_median']:.3f} / "
        f"{ranks[1]['bf16']['step_ms_median']:.3f} ms (ranks), one process "
        f"{one['bf16']['step_ms_median']:.3f} ms | {smi}")
    log(f"  data parallel: collectives a bf16 step (rank 0, payload bytes) "
        f"{json.dumps(audit_report['per_what'])}; total "
        f"{audit_report['total_bytes']} B")

    # (b) a 1-rank NCCL group through one float32 step, in this process,
    # against one process, both with deterministic algorithms (without them
    # the index ops' backward makes the gradients differ between two runs
    # of one process); then its bf16 step timed: the same work as one
    # process on the global batch, plus every collective of the DP step
    # (trivial at one rank)
    again = _dp_step(cfg, device, torch.float32, batch)
    nondeterministic = sum(not torch.equal(again["grads"][k], g)
                           for k, g in one["f32"]["grads"].items())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want = _dp_step(cfg, device, torch.float32, batch)
        _dp_equal(_dp_step(cfg, device, torch.float32, batch), want,
                  "one process's float32 step under deterministic algorithms")
        init_group(f"localhost:{free_port()}", 1, 0, backend="nccl")
        try:
            nccl = _dp_step(cfg, device, torch.float32, batch,
                            default_group())
        finally:
            shutdown()
    finally:
        torch.use_deterministic_algorithms(False)
    _dp_equal(nccl, want, "NCCL 1-rank float32 step")
    init_group(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        nccl_ms = _dp_step(cfg, device, torch.bfloat16, batch,
                           default_group(), timed=True)["step_ms_median"]
    finally:
        shutdown()
    log(f"  data parallel: 1-rank NCCL float32 step equal to one process's "
        f"bit for bit under deterministic algorithms (without them two runs "
        f"of one process differ in {nondeterministic} of "
        f"{len(again['grads'])} gradients); its bf16 step median "
        f"{nccl_ms:.3f} ms, one process {one['bf16']['step_ms_median']:.3f} "
        f"ms | {smi}")

    # (c) the v2 synthetic config through train_stereo on 2 ranks
    path = train_config_file("chip_smoke_dp_config",
                             datasets=DP_TRAIN_DATASETS)
    t0 = time.perf_counter()
    spawn_ranks([ROOT / "chip_smoke.py", "--dp-rank", "train", DP_DIR, path],
                DP_WORLD, timeout=DP_RANKS_TIMEOUT_S, cwd=ROOT)
    train_s = time.perf_counter() - t0
    runs = [json.loads((DP_DIR / f"train_rank{r}.json").read_text())
            for r in range(DP_WORLD)]
    if len({r["hash"] for r in runs}) != 1:
        raise AssertionError("train_stereo on 2 ranks: final parameters "
                             "differ")
    scenes = int(DP_TRAIN_DATASETS[0].split("_")[1]) // DP_WORLD
    for r in runs:
        if any(c != LAUNCHES_PER_STEP for c in r["launches_per_step"]):
            raise AssertionError(f"train_stereo rank {r['rank']} launches "
                                 f"{r['launches_per_step']}")
        if r["resident_scenes"] != [scenes]:
            raise AssertionError(f"train_stereo rank {r['rank']}: resident "
                                 f"scenes {r['resident_scenes']}, not "
                                 f"{scenes}")
    losses = runs[0]["losses"]
    third = DP_TRAIN_STEPS // 3
    first, last = statistics.mean(losses[:third]), statistics.mean(
        losses[-third:])
    if (len(losses) != DP_TRAIN_STEPS or runs[1]["losses"] != losses
            or not all(math.isfinite(v) for v in losses) or not last < first):
        raise AssertionError(f"train_stereo on 2 ranks: losses {losses} / "
                             f"{runs[1]['losses']}")
    shutil.rmtree(load_config(path).path)
    path.unlink()
    log(f"  data parallel: train_stereo on {TRAIN_CONFIG.name} "
        f"({DP_TRAIN_DATASETS}, {scenes} resident a rank), {DP_TRAIN_STEPS} steps"
        f" on {DP_WORLD} ranks in {train_s:.1f} s: loss mean of the first / "
        f"last {third} {first:.4f} / {last:.4f}, equal final hashes, step "
        f"median {runs[0]['step_ms_median']:.3f} / "
        f"{runs[1]['step_ms_median']:.3f} ms (ranks) | {smi}")

    # (d) the scaling bench (720p, bf16, 2 frames a rank) over the cards
    scaling = scaling_efficiency(image_hw=HW, frames_per_device=2)
    log(f"  data parallel: scaling_bench at 720p bf16, 2 frames a rank: "
        f"{json.dumps(scaling)} | {smi}")
    shutil.rmtree(DP_DIR)
    return dict(
        launches=runs[0]["launches"], backend=ranks[0]["backend"],
        devices=[r["device"] for r in ranks], cards=cards,
        first_step=errors, nccl_1_rank="bit for bit",
        nondeterministic_grads=nondeterministic,
        launches_per_step={"f32": ranks[0]["f32"]["launches"],
                           "bf16": ranks[0]["bf16"]["launches"]},
        step_ms_median={"ranks": [r["bf16"]["step_ms_median"]
                                  for r in ranks],
                        "one_process": one["bf16"]["step_ms_median"],
                        "nccl_1_rank": nccl_ms},
        audit_bytes=audit_report["per_what"],
        audit_total_bytes=audit_report["total_bytes"],
        train_stereo=dict(steps=DP_TRAIN_STEPS, losses=losses,
                          seconds=train_s,
                          step_ms_median=[r["step_ms_median"] for r in runs]),
        scaling=scaling, step_check_s=step_s)


def dp_rank_main(mode: str, args) -> int:
    """``--dp-rank``: one rank of the data-parallel phase."""
    if mode == "step":
        _dp_rank_step(pathlib.Path(args[0]))
    else:
        _dp_rank_train(pathlib.Path(args[0]), args[1])
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--train-config-steps", type=int, default=None,
                        metavar="N",
                        help="run only the committed v2 synthetic config, "
                             "unmodified, for N + 1 steps, and time it")
    parser.add_argument("--only", nargs="+",
                        choices=sorted(NEW_MODELS) + ["data_parallel"],
                        help="run only these phases (v4, dispnetc, "
                             "data_parallel)")
    parser.add_argument("--dp-rank", nargs="+", metavar="ARG",
                        help=argparse.SUPPRESS)  # a rank of data_parallel
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.dp_rank:
        return dp_rank_main(args.dp_rank[0], args.dp_rank[1:])
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in PEAKS.items() if k in kind), PEAKS["H100"])
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log("set torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False")
    if args.train_config_steps is not None:
        time_train_config(device, smi, args.train_config_steps)
        return 0
    if args.only:
        results = new_model_phases(
            device, smi, [n for n in args.only if n in NEW_MODELS])
        if "data_parallel" in args.only:
            with Phase("data parallel"):
                results["data_parallel"] = check_data_parallel(device, smi)
        log(json.dumps({name: {k: v for k, v in r.items()}
                        for name, r in results.items()}))
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    log(f"bounds from peaks {peaks[0]:.3g} B/s, {peaks[1]:.3g} bf16 FLOP/s")

    with Phase("build"):
        t0 = time.perf_counter()
        so = _build.build()
        _build.library()
        log(f"  built {pathlib.Path(so).name} in "
            f"{time.perf_counter() - t0:.3f} s")
    with Phase("kernels"):
        worst = check_kernels(device, conv3x3_cases(), conv3d_cases())
        tc_worst = check_tc_kernels(device)
        rows = time_kernels(device, peaks)
        tc_rows = time_tc_kernels(device, peaks)
        log(json.dumps({"tc_kernel_times": tc_rows}))
    with Phase("train kernels"):
        train_worst = check_train_kernels(device)
        dw_tc_worst = check_dw_tc(device)
        train_rows = time_train_kernels(device, peaks)
        log(json.dumps({"train_kernel_times": train_rows}))
    with Phase("autograd"):
        grad_worst = check_autograd(device)
    with Phase("narrow kernels"):
        narrow_worst = check_narrow(device)
        narrow_rows = time_narrow(device, peaks)
        log(json.dumps({"narrow_kernel_times": narrow_rows}))
    with Phase("model"):
        model_result = check_model(device)
    with Phase("bench"):
        record = run_checked_bench("v1", LAUNCHES_PER_FRAME)
    with Phase("v3 kernels"):
        v3_worst = check_v3_kernels(device)
        v3_rows = time_v3_kernels(device, peaks)
        log(json.dumps({"v3_kernel_times": v3_rows}))
    with Phase("v3 model"):
        v3_result = check_model_warped(device, "v3", LAUNCHES_PER_FRAME_V3)
    with Phase("v3 bench"):
        v3_record = run_checked_bench("v3", LAUNCHES_PER_FRAME_V3)
    with Phase("train"):
        train_result = check_train(device)
    with Phase("v2 kernels"):
        v2_worst = check_v2_kernels(device)
        v2_rows = time_v2_kernels(device, peaks)
        log(json.dumps({"v2_kernel_times": v2_rows}))
    with Phase("v2 model"):
        v2_result = check_model_warped(device, "v2", LAUNCHES_PER_FRAME)
    with Phase("v2 bench"):
        v2_record = run_checked_bench("v2", LAUNCHES_PER_FRAME)
    with Phase("train v2"):
        train_v2 = check_train(device, "v2")
    with Phase("train v3"):
        train_v3 = check_train(device, "v3")
    with Phase("eval"):
        eval_worst = check_eval_kernels(device)
        eval_v2 = check_eval(device, "v2", LAUNCHES_PER_FRAME)
        eval_v3 = check_eval(device, "v3", LAUNCHES_PER_FRAME_V3)
    with Phase("train config"):
        train_config = check_train_config(device, smi)
    new_models = new_model_phases(device, smi, sorted(NEW_MODELS))
    with Phase("data parallel"):
        data_parallel = check_data_parallel(device, smi)
    # last: a profiler session can leave per-launch tracing costs on the
    # host, which would slow the frames and steps timed above
    with Phase("narrow routes"):
        narrow_paths = check_narrow_routes(device)
    with Phase("K7 profile"):
        v2_rows["conv3x3_s2"]["device_ms"] = profile_k7(device)
        log(json.dumps({"k7_device_ms": v2_rows["conv3x3_s2"]["device_ms"]}))
    with Phase("augment profile"):
        train_config["augment_profile"] = profile_augment(device)
        log(f"  train config: resident fetch + augmentation per step "
            f"{json.dumps(train_config['augment_profile'])} | {smi}")

    rows["dw_reduce"] = train_rows["dw_reduce"]
    rows["fused_conv4x4_s2"] = v3_rows["fused_conv4x4_s2"]
    rows["conv3x3_s2"] = v2_rows["conv3x3_s2"]
    for key in ("f32", "bf16"):  # the largest error of each kernel
        for name in ("fused_conv3x3", "fused_conv3d"):
            worst[(name, key)] = max(worst[(name, key)],
                                     train_worst[(name, key)],
                                     tc_worst.get((name, key), 0.0),
                                     narrow_worst.get((name, key), 0.0))
        worst[("fused_conv3x3", key)] = max(
            worst[("fused_conv3x3", key)], v3_worst[("fused_conv3x3", key)],
            v2_worst[("fused_conv3x3", key)],
            narrow_worst[("fused_conv3x3", key)])
        worst[("fused_conv4x4_s2", key)] = max(
            v3_worst[("fused_conv4x4_s2", key)],
            tc_worst.get(("fused_conv4x4_s2", key), 0.0))
        worst[("fused_conv3x3_s2", key)] = max(
            worst[("fused_conv3x3_s2", key)],
            tc_worst.get(("fused_conv3x3_s2", key), 0.0),
            narrow_worst[("fused_conv3x3_s2", key)])
        worst[("dw_reduce", key)] = max(train_worst[("dw_reduce", key)],
                                        v2_worst[("dw_reduce", key)],
                                        dw_tc_worst.get(("dw_reduce", key),
                                                        0.0),
                                        narrow_worst[("dw_reduce", key)])
        worst[("conv3x3_s2", key)] = v2_worst[("conv3x3_s2", key)]
        for name in ("fused_conv3x3", "fused_conv3x3_s2", "fused_conv3d",
                     "fused_conv4x4_s2"):
            worst[(name, key)] = max(worst.get((name, key), 0.0),
                                     eval_worst[(name, key)])
    over_scale = {
        "dw_reduce": {key: max(train_worst[("dw_reduce", key, "over scale")],
                               v2_worst[("dw_reduce", key, "over scale")],
                               dw_tc_worst.get(("dw_reduce", key,
                                                "over scale"), 0.0),
                               narrow_worst[("dw_reduce", key, "over scale")])
                      for key in ("f32", "bf16")},
        "conv3x3_s2": {f"{part} {key}": v2_worst[("conv3x3_s2", key, part,
                                                  "over scale")]
                       for key in ("f32", "bf16") for part in ("y", "dx",
                                                                "dW")}}
    # the narrow channel pairs of K1, K2, K3 and K4 (and K4's 3D 32 -> 32),
    # timed at their largest launches, each with its design
    pairs = {}
    for key, row in narrow_rows.items():
        name, pair = key.split(" ", 1)
        pairs.setdefault(name, {})[pair] = row
    pairs["dw_reduce"]["3d"] = train_rows["dw_reduce 3D"]
    for name in pairs:  # the narrow launches of the main paths, by route
        pairs[name]["main path launches"] = {
            label: {g: v for g, v in groups.items() if g.split(" ")[0] == name}
            for label, groups in narrow_paths.items()}
    paths = {"train_run": train_result, "infer_frame": model_result,
             "infer_frame_v2": v2_result, "infer_frame_v3": v3_result,
             "train_run_v2": train_v2, "train_run_v3": train_v3,
             "eval_v2": eval_v2, "eval_v3": eval_v3,
             "train_config_v2": train_config, **new_models,
             "data_parallel": data_parallel}
    kernels = []
    for name, row in rows.items():
        by_path = {p: r["launches"].get(name, 0) for p, r in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            # the count of the main path the kernel carries: the v1
            # training run (train() over all its steps) where it runs
            # there, else the first inference frame or training run that
            # launches it; K7 is on no model path
            "launches": next((n for n in by_path.values() if n), 0),
            "launches_by_path": by_path,
            "launches_per_train_step": {
                m: r["launches_per_step"].get(name, 0)
                for m, r in (("v1", train_result), ("v2", train_v2),
                             ("v3", train_v3))},
            "max_abs_err": worst[(name, "bf16")],
            "max_abs_err_f32": worst[(name, "f32")],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
        })
        if name in TC_DESIGN:
            kernels[-1]["design"] = TC_DESIGN[name]
            kernels[-1]["bound_share"] = row["bound_ms"] / row["ms"]
            kernels[-1]["device_ms"] = dict(
                row["device_ms"],
                bound_share=row["bound_ms"] / row["device_ms"]["ms"])
            kernels[-1]["other_shapes"] = tc_rows[name]
        if name in over_scale:
            kernels[-1]["max_err_over_scale"] = over_scale[name]
        if name in pairs:
            kernels[-1]["pairs"] = pairs[name]
        if name == "conv3x3_s2":
            kernels[-1]["note"] = ("on no model path: a backward over K1 "
                                   "and K4, whose launches count as theirs")
            kernels[-1]["device_ms"] = row["device_ms"]
    log(json.dumps({"kernels": kernels}))

    def frame(record, result):
        return {"frame_latency_ms": record["latency_ms"],
                "fps": record["value"], **result}

    def step(result):
        return {"median": result["step_ms_median"],
                "min": result["step_ms_min"]}

    log(json.dumps({"frame_latency_ms": record["latency_ms"],
                    "fps": record["value"],
                    "bf16_median_err_px": model_result["bf16_median_err_px"],
                    "v2": frame(v2_record, v2_result),
                    "v3": dict(frame(v3_record, v3_result),
                               kernel_times=v3_rows),
                    "train_step_ms": step(train_result),
                    "train_step_ms_v2": step(train_v2),
                    "train_step_ms_v3": step(train_v3),
                    "train": train_result, "train_v2": train_v2,
                    "train_v3": train_v3,
                    "eval": {"v2": eval_v2, "v3": eval_v3},
                    "train_config_v2": {k: v for k, v in train_config.items()
                                        if k not in ("losses", "final")},
                    **{name: {k: v for k, v in r.items()
                              if k not in ("launches",)}
                       for name, r in new_models.items()},
                    "data_parallel": {k: v for k, v in data_parallel.items()
                                      if k != "launches"},
                    "autograd_err": {" ".join(k): v
                                     for k, v in grad_worst.items()},
                    "nvidia_smi": smi}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
