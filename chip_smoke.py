#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (H100):

    python3 chip_smoke.py

1. prints the toolchain and the card (``nvidia-smi`` name and power limit);
2. builds the CUDA kernels from ``mrn_tpu_torch/ops/csrc`` (one ``nvcc``
   per source, all started together);
3. holds the fused SVTR Block kernel against its plain PyTorch version at
   the four Block shapes of SVTR at batch 256, in float32 and bfloat16 (two
   launches must be bitwise equal), prints each shape's launch plan, and
   times kernel, plain version and a library yardstick (a composed Block on
   cuBLAS and ``F.scaled_dot_product_attention``, which the port never
   calls) beside the card's bound for the same work;
4. serves ``configs/svtr_mrn.py`` at full width as a 6-expert SVTR-MRN
   ensemble (4500 classes, random weights from a seed in the JAX init
   distributions, bridged with ``bridge.from_flax``): a few requests of 256
   crops in bfloat16 and float32 through ``serve.Server``, counting kernel
   launches and the host-side weight folds (none in a warm request), then
   the same batch forced through the plain versions on the card for
   comparison, and a device profile of one warm bf16 request;
5. holds the two training attention kernels (full and banded) against their
   plain versions at the four attention shapes of the SVTR training forward
   (f32 and bf16, forward, and f32 gradients through the autograd
   Functions; two launches must be bitwise equal), timed beside the plain
   version, one ``F.scaled_dot_product_attention`` call (timed only) and the
   bound, with each kernel's share of the bound and its ratio to SDPA; and
   the full kernel at int8 calibration's two masked Local shapes (N 512, the
   three-pass path, and N 256), f32 and bf16, checked the same way;
6. trains task 5 of the 6-task SVTR-MRN sequence at full width through
   ``MRN.incremental_train`` (5 frozen random experts plus the new one,
   batch 256 of synthetic crops from a uint8 bank on the card, validated
   on one batch of the task's own crops): step 0 (the new expert) and step
   1 (the router over 6 experts), bf16 then f32, printing each step's loss,
   its ``StepMeter`` window's mean step time and images/s and counting
   kernel launches (the validations' fused Blocks included); then, in bf16
   and f32, one step-0 step on the kernel path against the same step on the
   plain versions (loss, grad norm, fc grad);
7. holds the three fused training Block kernels (forward, backward tail,
   backward head) against their plain versions at the four Block shapes at
   batch 256, f32 and bf16, with a non-trivial LN affine and droppath masks
   with zeros: forward output and residuals (two forward launches bitwise
   equal, the forward's launch plan printed), dy/dattn and 8 grads, dx and 4
   grads, the whole autograd Function's grads, and bitwise-repeatable weight
   grads; prints the backward's launch plan per shape and the registers and
   spills of its kernels; timed beside the plain versions, the bound and a
   library yardstick (the composed library Block's forward with grad
   enabled; for the tail autograd's backward of the library Block's proj,
   LayerNorm and MLP sub-graph, for the head that of its LayerNorm and qkv
   product, with the whole library Block's backward printed beside them);
8. trains task 5 again with ``MRN_FUSED_TRAIN=1`` (set, then restored): every
   train-mode Block runs the fused training Block, counting 12 + 12 + 12
   launches per step-0 step; then one step-0 step on the fused kernels
   against the fused plain versions (bf16 and f32), and one f32 step-0 step
   fused against composed with the same masks;
9. profiles one step of each kind: the composed step 1 and step 0, and the
   fused step 0;
9b. checkpoints, validation and test: task 5 again, bf16 policy, validated
   on one synthetic set of 300 crops per seen task (two eval batches each,
   the second padded), best checkpoints and expert blobs written under
   ``build/`` (removed at the end), then ``MRN.test``; counts the fused
   Block's launches of the validations and the test, and checks (a) that
   the best files reload leaf for leaf what was saved and the blob names
   are the restored trees' hashes, (b) that ``Server.from_checkpoint`` on
   the step-1 file serves the learner's TF logits bitwise in float32 (and
   bfloat16 against its plain path), (c) FF and TF validation on the
   kernels against the plain versions (picks may differ only at near-ties)
   and (d) that ``test`` scores every seen task; prints checkpoint bytes,
   save/load seconds and validation crops/s;
9c. runs the 6-task SVTR-MRN campaign (``mrn_tpu_torch.campaign``'s
   ``run_incremental``, the slice's entry point) at full width, bf16, batch
   256, prefetch on, composed Blocks, cut as ``CAMPAIGN_*`` below says:
   synthetic suite, ``DatasetManager`` with rehearsal memory, task-0
   reference init, best checkpoints, ``test`` and the accuracy matrix,
   counting the kernels' launches; checks (a) that the batches the loop
   took equal those of the same stream built again without the learner or
   the prefetcher, bitwise, and that step 1's router targets are binary,
   (b) the memory sizes after each task, (c) that a crash injected after
   routed step ``CAMPAIGN_CRASH`` of task 5 resumes (``resume_full``,
   ``start_task=5.5``) into the uninterrupted replay's batches bitwise and
   its losses and router within ``TRAIN_STEP_TOL``; prints (d) the matrix,
   the AIA and seconds per stage and (e) the step-0 window mean with and
   without the prefetcher and a traced window's idle share;
9d. runs the other strategies (base, LwF, WA, EWC, DER, joint_mix and
   joint_loader) through ``campaign.run_incremental`` / ``run_joint`` at
   full width, bf16, batch 256, prefetch on, over 3 tasks of the campaign
   suite, cut as ``STRATEGY_*`` below says, counting the launches of rows
   1, 2 and 4 against the expected counts; checks (a) that the batches
   each run took (EWC's Fisher batches too) equal those of its stream
   built again without the prefetcher, bitwise, half-batch loaders
   included, and (b) the strategies' invariants: LwF's and WA's KD term
   finite and above 0 from task 1, every WA align leaving the new columns'
   mean norm at the old columns' within 1e-5, EWC's Fisher at most 1e-4
   and its penalty finite, DER's frozen extractors bitwise unchanged over
   a task, and task 0 of base, LwF, WA and EWC the same draws and the same
   model; (c) one training step with the kernels against the plain
   versions within ``TRAIN_STEP_TOL``: LwF at task 1 (row 4 in the old
   network, rows 1-2 in the live one), DER at task 2 composed and with
   ``MRN_FUSED_TRAIN=1`` (rows 5-7); prints (d) each strategy's step time
   over a window after 3 warm-up steps, its stage seconds and launches;
10. holds the w8a8 Block kernel against its plain version at the four Block
   shapes at batch 256, float32 and bfloat16, float and int8 attention, each
   Block calibrated on its input and quantized first (Local Blocks banded,
   the plain version over the full mask); two launches must be bitwise
   equal, and the plain version with float products (the control) must
   fail the check the kernel passes; prints the kernel's registers and
   spills, each shape's band and launch plan and the device time of each
   of its five launches (``torch.profiler``); timed beside the plain
   version, the bound and a library yardstick (the w8a8 Block from
   ``torch._int_mm``, ``F.layer_norm`` and ``F.scaled_dot_product_attention``,
   which the port never calls), whose kernels are then profiled;
11. serves one full-width SVTR recognizer of ``configs/svtr_mrn.py`` (task 0,
   2000 classes, random weights) int8 as ``evaluate_cli --int8 --taski 0``
   does: prints the float server's score envelope, calibrates on 4 synthetic
   batches and quantizes (``serve.quantize_int8``), serves 5 requests of
   256 crops in float32 and bfloat16 counting 12 int8 Block launches per
   request, holds each served Block against the plain version on its own
   served input and the logits and greedy picks against the plain versions
   (each beside the control), and prints word agreement and mean NED
   against the float server;
12. serves ``configs/trba_mrn.py`` at full width as a 6-expert TRBA-MRN
   ensemble (TPS with 20 fiducials, ResNet (1, 2, 5, 3) at 512 channels,
   two BiLSTMs of 256, a 26-step greedy Attn decoder; the SVTR phase's
   class counts; random weights from the seed in the JAX init
   distributions, ``localization_fc2`` perturbed and the BatchNorm
   statistics and router biases set on the batch, see
   ``calibrate_random_trba``) and as one recognizer: requests of 256 crops
   in bfloat16 and float32 through ``serve.Server``, counting 6 TPS warp
   launches per ensemble request and 1 per single-recognizer request, then
   the same batch with the warp forced through its plain version on the
   card (route scores, picks, logits and words, near-ties reported) and a
   profile of one request per dtype;
13. holds the TPS warp kernel against its plain version at batch 256,
   32x256x4 -> 32x256, on random grids in [-1.3, 1.3], the identity grid
   and the served batch's TPS grids, float32 and bfloat16 images (float32
   grids), timed beside the plain version, ``F.grid_sample`` on NCHW
   (timed only) and the bound.

Any failed check raises (exit code != 0).  The line before the last is the
per-kernel JSON record, the last line ``{"ok": true, "device": {...}}``.
Exits non-zero without printing a result when no CUDA card is present.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from mrn_tpu_torch import campaign  # noqa: E402
from mrn_tpu_torch.bridge import quant_tree, state_to_flax, to_flax  # noqa: E402
from mrn_tpu_torch.config import load_config  # noqa: E402
from mrn_tpu_torch.data.manager import DatasetManager, ValDataset  # noqa: E402
from mrn_tpu_torch.data.prefetch import Prefetcher  # noqa: E402
from mrn_tpu_torch.data.synthetic import (SyntheticTaskLoader, alphabet_of_size,  # noqa: E402
                                          synthetic_val_set)
from mrn_tpu_torch.models.init import (random_block, random_mrn,  # noqa: E402
                                       random_recognizer, random_router)
from mrn_tpu_torch.models import tps  # noqa: E402
from mrn_tpu_torch.models.common import BatchNorm  # noqa: E402
from mrn_tpu_torch.models.svtr import (Block, configure_blocks,  # noqa: E402
                                       local_attention_mask_col_major)
from mrn_tpu_torch.ops import _build, int8, metrics, svtr_attention, svtr_block  # noqa: E402
from mrn_tpu_torch.ops import grid_sample, svtr_train_block  # noqa: E402
from mrn_tpu_torch.ops.ctc import ctc_loss_per_sample  # noqa: E402
from mrn_tpu_torch.serve import Server, quantize_int8  # noqa: E402
from mrn_tpu_torch.train import checkpoint  # noqa: E402
from mrn_tpu_torch.train.learners import mrn as mrn_learner  # noqa: E402
from mrn_tpu_torch.train.learners.base import BaseLearner  # noqa: E402
from mrn_tpu_torch.train.learners.mrn import MRN, tree_hash  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet) at the full 700 W limit.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12

BATCH = 256
# (name, grid (h, w), dim, heads, mixer, Blocks of this shape per expert)
BLOCK_SHAPES = (("stage1-local", (8, 64), 64, 2, "Local", 3),
                ("stage2-local", (4, 64), 128, 4, "Local", 3),
                ("stage2-global", (4, 64), 128, 4, "Global", 3),
                ("stage3-global", (2, 64), 256, 8, "Global", 3))
# kernel vs plain: float32 differs only in summation order and the CUDA
# exp/rsqrt ulps; bfloat16 can flip a rounding of an intermediate (one bf16
# ulp = 2^-8 relative) and the bf16 output rounding (|out| <= ~8 -> ulp
# <= 2^-5), so allow a few output ulps.  Checked as |k - p| <= atol + rtol*|p|.
BLOCK_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 2e-2)}
# served logits and route scores after 12 Blocks per expert
LOGIT_TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (1e-1, 5e-2)}
N_EXPERTS = 6
CLASS_COUNTS = (2000, 2500, 3000, 3500, 4000, 4500)
REQUESTS = {"bfloat16": 3, "float32": 2}
SEED = 0

# Attention of the SVTR training path at batch 256: (name, grid (h, w),
# heads, kernel, Blocks of this shape per expert forward); head_dim 32.
ATTN_SHAPES = (("stage1-local", (8, 64), 2, "banded", 3),
               ("stage2-local", (4, 64), 4, "banded", 3),
               ("stage2-global", (4, 64), 4, "full", 3),
               ("stage3-global", (2, 64), 8, "full", 3))
# int8 calibration's composed eval Blocks run the full kernel over a Local
# Block's whole column-major mask (models/svtr.py Block._composed): (name,
# grid (h, w), heads) at batch 256, head_dim 32; N 512 is wider than the 256
# keys a warp holds in registers and takes the three-pass kernel
CALIB_ATTN_SHAPES = (("stage1-local", (8, 64), 2), ("stage2-local", (4, 64), 4))
# kernel vs plain forward: float32 summation order and exp ulps; bfloat16 a P
# rounding flipped by a float32 ulp plus one output ulp at |o| < 4
ATTN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 1e-2)}
# dq/dk/dv of the Function (kernel forward, plain backward) against autograd
# through the kernel's plain arithmetic, float32: the same math, another
# summation order in the backward's products
ATTN_GRAD_TOL = (1e-4, 1e-3)
# SVTR-MRN training: task 5 of 6 (5 frozen experts + the new one)
TRAIN_TASK = 5
TRAIN_ITERS = 4          # step-0 updates; step 1 runs TRAIN_ITERS // 2
CROPS_PER_TASK = 256
TRAIN_DTYPES = ("bf16", "f32")
# validation: the training phases validate on one batch of the task's own
# synthetic crops; the checkpoint phase on one set of VAL_CROPS per seen
# task (two eval batches per set, the second padded).  Kernel-4 launches
# per eval batch: 12 Blocks for FF (the standalone expert), 6 experts x 12
# for TF (the routed ensemble).
VAL_CROPS = 300
FF_LAUNCHES, TF_LAUNCHES = 12, N_EXPERTS * 12
# FF/TF validation on the kernels against the plain versions, float32: the
# served logits agree to float32 noise (max |diff| 2.4e-6 at this width on
# an H100 80GB HBM3); a per-sample CTC sums 64 log-softmax steps, each
# moved by at most 2 max|diff|, so it moves by <= 3e-4 against per-sample
# losses of ~100 with random weights over 4500 classes: 1e-4 relative
# leaves 30x (measured on that card: 5.8e-7 at most per sample)
VAL_LOSS_RTOL = 1e-4
# kernel path vs the same step-0 step forced through the plain versions:
# (loss rtol, grad-norm rtol, fc-grad atol as a share of the leaf's largest
# |grad|).  float32: the forwards differ in summation order and exp ulps
# (ATTN_TOL), which 12 Blocks and the backward carry to ~1e-6 relative.
# bfloat16: a kernel output may round one bf16 ulp (2^-8) away from the
# plain one, and each such flip feeds the next Block, so the loss and the
# grads agree to a few ulps of the bf16 activations, not to float32 noise.
# The first Adam update moves every weight by about lr * sign(g) whatever
# |g| is, so the updated weights are not compared: the fc grads are.
TRAIN_STEP_TOL = {"f32": (1e-4, 1e-4, 1e-4), "bf16": (1e-2, 3e-2, 3e-2)}
# Fused training Block kernels (rows 5-7) against their plain versions on the
# same inputs, per tensor as |k - p| <= the bound below of its largest |p|.
# float32: summation order (the weight grads sum 32768..131072 rows) and CUDA
# exp/rsqrt ulps, 2e-5 of the largest value.  bfloat16: the order can flip the
# rounding of an intermediate or of the result by one bf16 ulp; two ulps of
# the largest value (2^-7 of it rounded down to a power of two), the CPU
# tests' bound against the Pallas bodies, so a missed rounding point (one
# ulp everywhere, and more where it feeds a product) does not pass.
TRAIN_BLOCK_F32_SHARE = 2e-5
TRAIN_BLOCK_BF16_ULPS = 2


def train_block_bound(dt, top):
    """The largest |kernel - plain| allowed for a tensor whose largest |plain|
    is ``top`` (see TRAIN_BLOCK_F32_SHARE / TRAIN_BLOCK_BF16_ULPS)."""
    top = max(top, 1e-12)
    if dt == torch.float32:
        return TRAIN_BLOCK_F32_SHARE * top
    return TRAIN_BLOCK_BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


# The fused step-0 step on the kernels against the same step on the fused
# plain versions: the reasons of TRAIN_STEP_TOL hold unchanged (float32
# summation order carried through 12 Blocks; bf16 flips of one ulp feeding
# the next Block), so its values do too.
FUSED_STEP_TOL = TRAIN_STEP_TOL
# One f32 step-0 step, fused against composed, same weights, batch and
# masks: the GELU differs (degree-15 erf polynomial, |erf error| < 1.9e-7,
# |gelu' error| < 1.6e-5, against the exact erf) and so does the softmax's
# rounding (normalise after PV against before): the loss to 1e-4 relative,
# the grad norm and the fc grad to 1e-3.
FUSED_VS_COMPOSED_TOL = (1e-4, 1e-3, 1e-3)

# w8a8 Block kernel (row 3) against its plain version on the same inputs.
# The integer products are exact, so the two agree bit for bit wherever
# their int8 inputs agree.  But the LayerNorm statistics and the softmax sums
# are float32 sums taken in another order, and an activation within a
# float32 ulp of a .5 boundary can round to the neighbouring int8 value on
# one side only.  Such a flip moves one projection input by a quantization
# step, and through the attention it moves its image's later activations,
# some across further boundaries (never beyond its image).  So at batch 256
# at most INT8_FLIP_SHARE of the elements may differ by more than the float
# noise INT8_NOISE (|k - p| <= atol + rtol |p|: float32 as BLOCK_TOL; in
# bfloat16 none, since both round the same float32 value to bf16 unless it
# sits within a float32 ulp of a rounding boundary), and no element by more
# than INT8_FLIP_MAX of the largest |output| (three bf16 ulps of it).  The
# control -- the plain version with float products in place of the int8
# ones (activations scaled, not rounded) -- must fail the check.  Measured
# on an H100 at batch 256: at most 0.22% of the elements on random inputs
# and 0.70% on a served recognizer's (its last Block), 0.65% of the largest
# |output|; the control moved 78-96% (float32) and 22-57% (bfloat16).  The
# bound: 2.8x the largest reading.
INT8_NOISE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (0.0, 0.0)}
INT8_FLIP_SHARE = 0.02
INT8_FLIP_MAX = 0.02
# Served int8 logits, kernel against plain, after 12 Blocks: a flip carries
# into every later Block of its image and moves its later activations
# across further boundaries, so the logits of two correct implementations
# differ by a share of the int8 noise itself.  Each served Block is held to
# the INT8_FLIP_SHARE check on its own served input (no cascade).  The
# logits: their mean |k - p| at most INT8_LOGIT_MEAN_SHARE of the
# float-products control's mean |c - p|, and the greedy picks agree at every
# step whose plain top-2 margin exceeds INT8_TIE.  Measured on an H100: the
# mean 0.41 (float32) and 0.55 (bfloat16) of the control's, 65% and 48% of
# the logits beyond float noise (control 91% and 72%), max |k - p| 5.0e-3
# and 1.6e-2, so a top-2 margin moved by at most 1.0e-2 and 3.1e-2: INT8_TIE
# is 2x and 1.6x that.  A kernel that skipped the activation rounding would
# be the control, at 1.0.
INT8_LOGIT_MEAN_SHARE = 0.75
INT8_TIE = {"float32": 2e-2, "bfloat16": 5e-2}
INT8_REQUESTS = {"float32": 5, "bfloat16": 5}
INT8_CALIB_BATCHES = 4

# TRBA-MRN serving (configs/trba_mrn.py), 6 experts, the SVTR phase's
# class counts; 6 TPS warp launches per request (one per expert)
TRBA_REQUESTS = {"bfloat16": 3, "float32": 2}
# localization_fc2's kernel starts at zero (tps.py:91-93), which gives every
# crop the same grid; a small seeded kernel gives each crop its own, with
# fractional taps and clamped borders
TRBA_FC2_SCALE = 0.05
# TPS warp kernel vs plain: the same IEEE float32 operations in the same
# order (the kernel's are rounded, never contracted), so equal up to float32
# ulps; a bfloat16 image rounds the same float32 value once, one bf16 ulp
GRID_SAMPLE_TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (0.0, 2.0 ** -7)}
# served TRBA logits and route scores, kernel warp vs plain warp: the
# warps agree to GRID_SAMPLE_TOL, which the ResNet, the BiLSTMs and 26
# decode steps carry to the logits (bfloat16: a flipped rounding feeds the
# next layer)
TRBA_LOGIT_TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (1e-1, 5e-2)}

# The 6-task campaign phase: mrn_tpu_torch.campaign's run_incremental at
# full width, bf16, batch 256, prefetch on, seed 111, cut against the
# protocol of ACCURACY_RUNS/t6/svtr_mrn.json: the train instance counts / 8
# (336..5926 for 2687..47411), CAMPAIGN_TEST test crops a task (for
# 529..11073), memory_num CAMPAIGN_MEMORY (for 2000; under the smallest cut
# task, 404) and num_iter CAMPAIGN_ITERS with val_interval CAMPAIGN_VAL (for
# 1000 and 500): 20 step-0 steps a task validated at 1, 10 and 20, and 10
# step-1 steps validated at 1, 2, 4, 6, 8 and 10.
CAMPAIGN_CUT = 8
CAMPAIGN_TEST = 256
CAMPAIGN_MEMORY = 256
CAMPAIGN_ITERS = 20
CAMPAIGN_VAL = 10
CAMPAIGN_SEED = 111
# (c): the crash comes after routed step 5 of task 5; its last snapshot is
# step 4's (one at every validation point before the last)
CAMPAIGN_CRASH = 5
# (e): a step-0 window of TIME_STEPS steps after TIME_WARMUP, no validation
# in it; TRACE_STEPS of them traced
TIME_WARMUP, TIME_STEPS, TRACE_STEPS = 3, 10, 5

# The strategies phase: campaign.run_incremental / run_joint for each of
# STRATEGY_ILS at full width, bf16, batch 256, prefetch on, seed 111, on
# the campaign phase's suite (train instance counts / CAMPAIGN_CUT,
# CAMPAIGN_TEST test crops a task), cut against the protocol of
# ACCURACY_RUNS/t6/svtr_{base,wa}.json: STRATEGY_TASKS tasks (for 6),
# memory_num CAMPAIGN_MEMORY (for 2000), num_iter STRATEGY_ITERS with
# val_interval STRATEGY_VAL (for 1000 and 500; validations at 1, 5 and
# 10) and fisher_num_iter STRATEGY_FISHER (for num_iter // 4 = 250).
STRATEGY_ILS = ("base", "lwf", "wa", "ewc", "der", "joint_mix", "joint_loader")
STRATEGY_TASKS = 3
STRATEGY_ITERS = 10
STRATEGY_VAL = 5
STRATEGY_FISHER = 3


# ------------------------------------------------------------------- timing
def cuda_ms(fn, reps):
    """Mean device time of one call, from CUDA events over ``reps`` calls
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def block_bound_ms(b, n, c, heads, hidden, dt, mask, width):
    """The two halves of the least time (ms) for one Block call on an H100:
    the bytes it must move (x in, out, weights, biases, mask) over HBM
    bandwidth, and its operations over the peak rate of its type; the bound
    is the larger.  Attention counts only the (query, key) pairs the mask
    leaves visible."""
    isz = torch.tensor([], dtype=dt).element_size()
    m = b * n
    pairs = n * n if mask is None else int((mask == 0).sum())
    ops = (2 * m * c * (3 * c + c + 2 * hidden)
           + 2 * 2 * b * heads * pairs * (c // heads))
    nbytes = (2 * m * c * isz + c * (4 * c + 2 * hidden) * isz
              + 4 * (5 * c + hidden) + (0 if mask is None else 4 * n * width))
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_FLOPS[dt]


def library_block(x, p, mask, heads, scale):
    """Yardstick: the same Block composed from library calls (LayerNorm,
    cuBLAS matmuls, SDPA, exact GELU) in x's dtype.  Timed only."""
    b, n, c = x.shape
    d = c // heads
    h = F.layer_norm(x, (c,), p["norm1_scale"], p["norm1_bias"], 1e-6)
    qkv = (h @ p["qkv_kernel"] + p["qkv_bias"]).view(b, n, 3, heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    x = x + o.transpose(1, 2).reshape(b, n, c) @ p["proj_kernel"] + p["proj_bias"]
    h = F.layer_norm(x, (c,), p["norm2_scale"], p["norm2_bias"], 1e-6)
    h = F.gelu(h @ p["fc1_kernel"] + p["fc1_bias"])
    return x + h @ p["fc2_kernel"] + p["fc2_bias"]


def library_tail(x, attn_cat, p):
    """Yardstick of row 6 (the backward tail): the library Block's sub-graph
    from x and attn_cat on -- the proj product and residual, F.layer_norm,
    the MLP with exact GELU -- whose backward gives the cotangents of x and
    attn_cat and the 8 tail grads.  Timed only."""
    c = x.shape[-1]
    y = x + attn_cat @ p["proj_kernel"] + p["proj_bias"]
    h = F.layer_norm(y, (c,), p["norm2_scale"], p["norm2_bias"], 1e-6)
    h = F.gelu(h @ p["fc1_kernel"] + p["fc1_bias"])
    return y + h @ p["fc2_kernel"] + p["fc2_bias"]


def library_head(x, p):
    """Yardstick of row 7 (the backward head): F.layer_norm and the qkv
    product, whose backward gives dx's LayerNorm part and the 4 head
    grads.  Timed only."""
    h = F.layer_norm(x, (x.shape[-1],), p["norm1_scale"], p["norm1_bias"], 1e-6)
    return h @ p["qkv_kernel"] + p["qkv_bias"]


def check_close(what, got, ref, atol, rtol):
    err = (got.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool((err <= limit).all())
    mx = float(err.max()) if err.numel() else 0.0
    print(f"  {what}: max_abs_err {mx:.3e} (tol atol {atol:g} + rtol {rtol:g}*|ref|) "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError(f"{what}: kernel disagrees with its plain version")
    return mx


# ------------------------------------------------------------------- phases
def phase_environment():
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(f"nvcc: {shutil.which('nvcc') or ('/usr/local/cuda/bin/nvcc' if os.path.exists('/usr/local/cuda/bin/nvcc') else 'not found')}")
    return smi


def demangle(names):
    """{mangled: readable} through ``c++filt`` where the toolkit's host has
    it, else the names as they are."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, (o.replace("(anonymous namespace)::", "") for o in out)))


def print_ptxas(lib, select=lambda name: True, indent="  "):
    """Registers and spills of each kernel of a built library (ptxas -v)."""
    report = {n: r for n, r in _build.ptxas_report(lib).items() if select(n)}
    names = demangle(sorted(report))
    for name in sorted(report, key=names.get):
        r = report[name]
        print(f"{indent}ptxas {lib}: {names[name]}: {r.get('registers', '?')} registers, "
              f"{r.get('spill_stores', '?')} bytes spill stores, "
              f"{r.get('spill_loads', '?')} bytes spill loads")


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        print_ptxas(name)


def phase_blocks(device, rng):
    """Kernel vs plain at the four Block shapes; returns per-dtype sums over
    one expert's 12 Blocks."""
    totals = {}
    for dt in (torch.float32, torch.bfloat16):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   max_abs_err=0.0, bytes_ms=0.0, ops_ms=0.0)
        for name, hw, c, heads, mixer, count in BLOCK_SHAPES:
            n = hw[0] * hw[1]
            blk = Block(c, heads, mixer, hw, col_major=(mixer == "Local"))
            with torch.no_grad():
                for key, val in random_block(rng, c).items():
                    getattr(blk, key).copy_(torch.from_numpy(val))
            # non-trivial LN affine so the host-side fold is exercised
            with torch.no_grad():
                for key in ("norm1_scale", "norm1_bias", "norm2_scale", "norm2_bias"):
                    getattr(blk, key).add_(0.1 * torch.from_numpy(
                        rng.standard_normal(c).astype(np.float32)))
            blk = blk.to(device=device, dtype=dt).eval()
            x = torch.from_numpy(rng.standard_normal((BATCH, n, c)).astype(np.float32)
                                 ).to(device=device, dtype=dt)
            with torch.inference_mode():
                blk.plain = False
                out_k = _launch_twice(f"{name} {str(dt)[6:]} Block", lambda: blk(x))
                ms = cuda_ms(lambda: blk(x), 5)
                blk.plain = True
                out_p = blk(x)
                plain_ms = cuda_ms(lambda: blk(x), 3)
                blk.plain = False
                params = {k: v for k, v in blk.named_parameters()}
                full_mask = (None if blk.mask is None
                             else blk.mask.to(device=device, dtype=dt))
                lib_ms = cuda_ms(lambda: library_block(x, params, full_mask, heads,
                                                       blk.scale), 5)
            plan = svtr_block._Plan(n, blk.mask, blk.band, x.device)
            bytes_ms, ops_ms = block_bound_ms(BATCH, n, c, heads, 4 * c, dt,
                                              plan.mask, plan.width)
            bound = max(bytes_ms, ops_ms)
            atol, rtol = BLOCK_TOL[dt]
            err = check_close(f"{name} {str(dt)[6:]} [{BATCH},{n},{c}] qb {plan.qb} "
                              f"width {plan.width}", out_k, out_p, atol, rtol)
            print(f"    ms {ms:.3f}  plain_ms {plain_ms:.3f}  library_ms {lib_ms:.3f}  "
                  f"bound_ms {bound:.4f} ({'operations' if ops_ms >= bytes_ms else 'bytes'})  "
                  f"({bound / ms:.1%} of bound); two launches bitwise equal; "
                  + _block_plan_text(svtr_block._kernel_plan(dt, n, c, heads, 4 * c, plan.qb,
                                                             plan.width)))
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["library_ms"] += count * lib_ms
            tot["bound_ms"] += count * bound
            tot["bytes_ms"] += count * bytes_ms
            tot["ops_ms"] += count * ops_ms
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
        print(f"  one expert's 12 Blocks, {str(dt)[6:]}, batch {BATCH}: "
              + ", ".join(f"{k} {v:.4g}" for k, v in tot.items()))
        totals[dt] = tot
    return totals


def _block_plan_text(plan):
    span, key_tiles, segments, passes, smem, *tiles = plan
    return (f"plan: attention {span} query rows per block, {key_tiles} key tiles in "
            f"registers, {segments} key segment(s), {passes} pass(es) "
            f"({'one-pass' if segments == 1 and passes == 1 else 'segments'} kernel), "
            f"{smem} B shared; "
            f"projection tiles 128 x {'/'.join(map(str, tiles))} (qkv/proj/fc1/fc2)")


def _routed_outputs(model, x, plain):
    """An MRNNet's eval forward on ``x`` with its Blocks on the kernels or on
    the plain versions; the route scores are read with a hook on the
    router's last layer."""
    scores = []
    hook = model.route.register_forward_hook(
        lambda mod, inp, out: scores.append(out[..., 0].float()))
    configure_blocks(model, plain=plain)
    try:
        with torch.no_grad():
            out = model(x, is_train=False)
    finally:
        configure_blocks(model, plain=False)
        hook.remove()
    return out, scores[0]


def routed_vs_plain(model, x, tol, what):
    """An MRNNet's eval forward on ``x`` on the kernels against the same on
    the plain versions: route scores within ``tol`` ((atol, rtol)), expert
    picks equal except on a near-tie of the plain path's top-2 scores, and
    the logits of samples with the same pick within ``tol``.  Returns (kernel
    output, plain output, same-pick mask)."""
    atol, rtol = tol
    out_k, scores_k = _routed_outputs(model, x, False)
    out_p, scores_p = _routed_outputs(model, x, True)
    err = check_close(f"{what} route scores", scores_k, scores_p, atol, rtol)
    # with every score within err of its plain value, the order of two
    # experts can flip only where their plain margin is <= 2 * err
    top2 = scores_p.topk(2, dim=1).values
    near_tie = (top2[:, 0] - top2[:, 1]) <= 2 * err
    agree = out_k["index"] == out_p["index"]
    print(f"  {what}: expert picks agree on {int(agree.sum())}/{len(agree)} samples, "
          f"{int(near_tie.sum())} near-ties (picks per expert "
          f"{torch.bincount(out_k['index'], minlength=model.n_experts).tolist()})")
    if bool((~agree & ~near_tie).any()):
        raise RuntimeError(f"{what}: expert picks disagree between kernel and plain paths "
                           "beyond score near-ties")
    check_close(f"{what} served logits (samples with the same pick)",
                out_k["logits"][agree], out_p["logits"][agree], atol, rtol)
    return out_k, out_p, agree


def phase_serve(rng):
    """The slice's main path: 6-expert SVTR-MRN serving at full width."""
    chars = [chr(0x4E00 + i) for i in range(max(CLASS_COUNTS) - 4)]
    base = load_config(os.path.join(ROOT, "configs", "svtr_mrn.py"))
    params, stats = random_mrn(rng, base, CLASS_COUNTS)
    images = rng.integers(0, 256, (BATCH, base.imgH, base.imgW, base.input_channel),
                          dtype=np.uint8)
    servers = {}
    for dtype in REQUESTS:
        opt = base.replace(compute_dtype=dtype)
        servers[dtype] = Server(opt, params, stats, chars, class_counts=CLASS_COUNTS)

    # ---- counted run: the main path, through the entry points
    svtr_block.launches = 0
    timings, folds = {}, {}
    for dtype, n_req in REQUESTS.items():
        timings[dtype], folds[dtype] = [], []
        for _ in range(n_req):
            torch.cuda.synchronize()
            before = svtr_block.folds
            t0 = time.perf_counter()
            results = servers[dtype].recognize(images)
            timings[dtype].append(time.perf_counter() - t0)
            folds[dtype].append(svtr_block.folds - before)
            if len(results) != BATCH or not all(np.isfinite(c) for _, c in results):
                raise RuntimeError("recognize returned a malformed batch")
    launches = svtr_block.launches
    expected = sum(REQUESTS.values()) * N_EXPERTS * 12
    print(f"  fused Block launches in the served requests: {launches} "
          f"(expected {expected} = {sum(REQUESTS.values())} requests x "
          f"{N_EXPERTS} experts x 12 Blocks)")
    if launches != expected or launches == 0:
        raise RuntimeError("the served path did not run through the kernel as expected")
    if any(svtr_attention.launches.values()):
        raise RuntimeError("serving launched a training attention kernel")
    print(f"  host-side weight folds per request: {folds} (the first request of each "
          f"server folds each of its {N_EXPERTS * 12} Blocks once, a warm request none)")
    if any(f[0] != N_EXPERTS * 12 or any(f[1:]) for f in folds.values()):
        raise RuntimeError("a warm request folded weights again")
    for dtype, ts in timings.items():
        print(f"  {dtype}: request seconds {[round(t, 4) for t in ts]}, crops/s "
              f"{[round(BATCH / t, 1) for t in ts]} (first request includes warm-up)")
    print(f"  sample words of the last request: {[w for w, _ in results[:3]]}")

    # ---- the same batch through the plain versions on the card
    for dtype, srv in servers.items():
        out_k, _, _ = routed_vs_plain(srv.model, srv.images(images), LOGIT_TOL[srv.dtype], dtype)
        shape = (BATCH, base.imgW // 4, max(CLASS_COUNTS))
        if tuple(out_k["logits"].shape) != shape:
            raise RuntimeError(f"logits shape {tuple(out_k['logits'].shape)} != {shape}")

    # ---- where a warm bf16 request's device time goes
    from torch.profiler import ProfilerActivity, profile

    servers["bfloat16"].recognize(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        servers["bfloat16"].recognize(images)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_device_profile(f"bf16 {N_EXPERTS}-expert SVTR request of {BATCH} crops, warm",
                         prof, wall)
    return launches, timings


def attention_bound_ms(b, heads, n, d, dt, pairs, mask_bytes):
    """The two halves of the least time (ms) of one attention forward on an
    H100: q, k, v and out once plus the mask the kernel reads, over HBM
    bandwidth; QK^T and PV over the (query, key) pairs the mask leaves
    visible, at the peak rate of the type."""
    isz = torch.tensor([], dtype=dt).element_size()
    nbytes = 4 * b * heads * n * d * isz + mask_bytes
    ops = 2 * 2 * b * heads * pairs * d
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_FLOPS[dt]


def _attention_inputs(rng, heads, n, d, device, dt):
    qkv = [torch.from_numpy(rng.standard_normal((BATCH, heads, n, d))
                            .astype(np.float32)).to(device, dt) for _ in range(3)]
    qkv[0] = qkv[0] * d ** -0.5
    return qkv


def _launch_twice(what, kernel):
    """The kernel's output, after checking that a second launch on the same
    inputs gives the same bits (the forwards have no atomics)."""
    out = kernel()
    torch.cuda.synchronize()
    if not torch.equal(out, kernel()):
        raise RuntimeError(f"{what}: two launches on the same inputs differ")
    return out


def _plan_text(dt, n, d, qb, width):
    span, key_tiles, segments, passes, smem = svtr_attention._kernel_plan(dt, n, d, qb, width)
    return (f"plan: {span} query rows per block, {key_tiles} key tiles in registers, "
            f"{segments} key segment(s), {passes} pass(es), {smem} B shared")


def phase_attention(device, rng):
    """Each attention kernel vs its plain version at the four attention
    shapes of the SVTR training forward, f32 and bf16, two launches bitwise
    equal; timed beside the plain version,
    ``F.scaled_dot_product_attention`` (timed only) and the bound.  Then the
    full kernel at int8 calibration's masked shapes, checked the same way.
    Returns per-kernel, per-dtype sums over one expert forward."""
    d = 32
    totals = {}
    for dt in (torch.float32, torch.bfloat16):
        for name, hw, heads, kind, count in ATTN_SHAPES:
            n = hw[0] * hw[1]
            q, k, v = _attention_inputs(rng, heads, n, d, device, dt)
            band = (hw[0], hw[1], 7, 11) if kind == "banded" else None
            full_mask = (torch.from_numpy(local_attention_mask_col_major(*band)).to(device)
                         if band else None)
            with torch.no_grad():
                if band:
                    kernel = lambda: svtr_attention.banded_attention_forward(q, k, v, band)  # noqa: E731
                    plain = lambda: svtr_attention.banded_attention_reference(q, k, v, band)  # noqa: E731
                    plan = svtr_block._band_spec(*band)
                    mask_bytes = 4 * n * plan[1]
                    what = f"qb {plan[0]} width {plan[1]}"
                    qb, width = plan[0], plan[1]
                else:
                    kernel = lambda: svtr_attention.attention_forward(q, k, v)  # noqa: E731
                    plain = lambda: svtr_attention.attention_reference(q, k, v)  # noqa: E731
                    mask_bytes, what = 0, "unmasked"
                    qb = width = n
                out_k = _launch_twice(f"{kind} {name}", kernel)
                out_p = plain()
                ms = cuda_ms(kernel, 5)
                plain_ms = cuda_ms(plain, 3)
                lib_mask = None if full_mask is None else full_mask.to(dt)
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=lib_mask, scale=1.0), 5)
            pairs = n * n if full_mask is None else int((full_mask == 0).sum())
            bytes_ms, ops_ms = attention_bound_ms(BATCH, heads, n, d, dt, pairs, mask_bytes)
            bound = max(bytes_ms, ops_ms)
            atol, rtol = ATTN_TOL[dt]
            err = check_close(f"{kind} {name} {str(dt)[6:]} [{BATCH},{heads},{n},{d}] {what}",
                              out_k, out_p, atol, rtol)
            print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {lib_ms:.4f}  "
                  f"bound_ms {bound:.4f} ({'operations' if ops_ms >= bytes_ms else 'bytes'})"
                  f"  ({bound / ms:.1%} of bound, {ms / lib_ms:.2f}x SDPA); two launches "
                  f"bitwise equal; {_plan_text(dt, n, d, qb, width)}")
            if dt == torch.float32:   # gradients through the autograd Function
                g = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(device)
                grads = []
                for fn in (lambda a, b, c: svtr_attention.mha_small_n(a, b, c, band=band),
                           (lambda a, b, c: svtr_attention.banded_attention_reference(a, b, c, band))
                           if band else svtr_attention.attention_reference):
                    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                    grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
                for label, a, b in zip("qkv", *grads):
                    check_close(f"  d{label} through the Function", a, b, *ATTN_GRAD_TOL)
            tot = totals.setdefault((kind, dt), dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                                     bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                                                     max_abs_err=0.0))
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                             ("bound_ms", bound), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                tot[key] += count * val
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
    # its own generator: the later phases draw from rng as before
    calib_rng = np.random.default_rng(SEED + 5)
    for dt in (torch.float32, torch.bfloat16):
        for name, hw, heads in CALIB_ATTN_SHAPES:
            n = hw[0] * hw[1]
            q, k, v = _attention_inputs(calib_rng, heads, n, d, device, dt)
            mask = torch.from_numpy(local_attention_mask_col_major(*hw)).to(device)
            with torch.no_grad():
                kernel = lambda: svtr_attention.attention_forward(q, k, v, mask)  # noqa: E731
                out_k = _launch_twice(f"full {name} calibration", kernel)
                out_p = svtr_attention.attention_reference(q, k, v, mask)
                ms = cuda_ms(kernel, 5)
            check_close(f"full {name} calibration {str(dt)[6:]} [{BATCH},{heads},{n},{d}] "
                        f"local mask [{n},{n}]", out_k, out_p, *ATTN_TOL[dt])
            print(f"    ms {ms:.4f}; two launches bitwise equal; {_plan_text(dt, n, d, n, n)}")
    for (kind, dt), tot in totals.items():
        print(f"  {kind} attention, one expert forward (6 Blocks), {str(dt)[6:]}: "
              + ", ".join(f"{k} {v:.4g}" for k, v in tot.items()))
    return totals


def train_block_bounds_ms(b, n, c, heads, hidden, dt, pairs, mask_bytes):
    """(bytes_ms, ops_ms) of the least time of each fused training kernel on
    an H100 -- forward, tail, head -- from its inputs read once and its
    outputs written once over HBM bandwidth, and its products over the peak
    rate of the type (attention over the visible (query, key) pairs)."""
    isz = torch.tensor([], dtype=dt).element_size()
    m = b * n
    d = c // heads
    ms = lambda nbytes, ops: (1e3 * nbytes / HBM_BYTES_PER_S,  # noqa: E731
                              1e3 * ops / PEAK_FLOPS[dt])
    fwd = ms(isz * (m * c * 4 + m * 3 * c + m * hidden + c * (4 * c + 2 * hidden))
             + 4 * (9 * c + hidden + 2 * b) + mask_bytes,
             2 * m * c * (4 * c + 2 * hidden) + 4 * b * heads * pairs * d)
    tail = ms(isz * (m * c * 5 + m * hidden + c * (c + 2 * hidden))
              + 4 * (2 * c + 2 * b) + 4 * (2 * c * hidden + c * c + hidden + 4 * c),
              2 * m * (4 * c * hidden + 2 * c * c))
    head = ms(isz * (m * c * 6 + 3 * c * c) + 4 * 2 * c + 4 * (3 * c * c + 5 * c),
              12 * m * c * c)
    return fwd, tail, head


def _train_block_check(what, got, ref, dt):
    """|got - ref| <= train_block_bound(dt, max|ref|), finite; returns
    (max |difference|, that difference over the bound)."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    top = float(ref.abs().max())
    bound = train_block_bound(dt, top)
    if not (bool(torch.isfinite(got).all()) and err <= bound):
        print(f"  {what}: max_abs_err {err:.3e} of max |ref| {top:.3e} (bound {bound:.3e}) FAILED")
        raise RuntimeError(f"{what}: kernel disagrees with its plain version")
    return err, err / bound


def _bwd_plan_text(dt, m, c, hidden):
    grads, projs = svtr_train_block._bwd_plan(dt, m, c, hidden)
    return ("backward plan: " + ", ".join(
        f"{k} tile {tm}x{tn} over {count} chunks of {chunk} rows"
        for k, (tm, tn, count, chunk) in grads.items()) + "; "
        + ", ".join(f"{k} 128x{w}" for k, w in projs.items()))


def phase_train_blocks(device, rng):
    """The fused training Block's three kernels against their plain
    versions at the four Block shapes, f32 and bf16; returns per-kernel,
    per-dtype sums over one expert's 12 Blocks."""
    tb = svtr_train_block
    totals = {}
    print_ptxas("svtr_train_block", lambda name: "wgrad_kernel" in name or (
        "proj_kernel" in name and ("Dh1Epi" in name or "StoreEpi" in name)), "  backward ")
    for dt in (torch.float32, torch.bfloat16):
        for name, hw, c, heads, mixer, count in BLOCK_SHAPES:
            n = hw[0] * hw[1]
            hidden = 4 * c
            params = {k: torch.from_numpy(v) for k, v in random_block(rng, c).items()}
            for key in ("norm1_scale", "norm1_bias", "norm2_scale", "norm2_bias"):
                params[key] = params[key] + 0.1 * torch.from_numpy(
                    rng.standard_normal(c).astype(np.float32))
            params = {k: v.to(device, dt) for k, v in params.items()}
            keep = 0.9
            dm = (rng.random((2, BATCH, 1)) < keep).astype(np.float32) / keep
            dm[:, :2] = [[[0.0], [1 / keep]], [[1 / keep], [0.0]]]   # zeros on both
            dm_a, dm_b = (torch.from_numpy(v).to(device) for v in dm)
            x = torch.from_numpy(rng.standard_normal((BATCH, n, c)).astype(np.float32)
                                 ).to(device, dt)
            band = (hw[0], hw[1], 7, 11) if mixer == "Local" else None
            scale = (c // heads) ** -0.5
            g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(device, dt)
            errs = {"fwd": 0.0, "tail": 0.0, "head": 0.0, "Function": 0.0}
            worst = 0.0    # largest difference as a share of its bound

            def check(kind, what, a, b):
                nonlocal worst
                err, share = _train_block_check(f"{label} {kind} {what}", a, b, dt)
                errs[kind] = max(errs[kind], err)
                worst = max(worst, share)

            label = f"{name} {str(dt)[6:]} [{BATCH},{n},{c}]"
            with torch.no_grad():
                out, res = tb.forward(x, params, dm_a, dm_b, heads, scale, band)
                torch.cuda.synchronize()
                out2, res2 = tb.forward(x, params, dm_a, dm_b, heads, scale, band)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip((out,) + res, (out2,) + res2)):
                    raise RuntimeError(f"{label}: two forward launches on the same inputs differ")
                del out2, res2
                ref_out, ref_res = tb.forward_reference(x, params, dm_a, dm_b, heads, scale, band)
                for what, a, b in zip(("out", "qkv", "attn_cat", "y", "h1"),
                                      (out,) + res, (ref_out,) + ref_res):
                    check("fwd", what, a, b)
                qkv, attn, y, h1 = res
                dy, dattn, tail = tb.bwd_tail(g, y, h1, attn, params, dm_a, dm_b)
                torch.cuda.synchronize()
                rdy, rdattn, rtail = tb.bwd_tail_reference(g, y, h1, attn, params, dm_a, dm_b)
                for what, a, b in [("dy", dy, rdy), ("dattn", dattn, rdattn)] + [
                        (k, tail[k], rtail[k]) for k in rtail]:
                    check("tail", what, a, b)
                dqkv = tb._attn_bwd(qkv, dattn, heads, scale, band, dt).to(dt)
                dx, head = tb.bwd_head(x, dy, dqkv, params)
                torch.cuda.synchronize()
                rdx, rhead = tb.bwd_head_reference(x, dy, dqkv, params)
                for what, a, b in [("dx", dx, rdx)] + [(k, head[k], rhead[k]) for k in rhead]:
                    check("head", what, a, b)
                # the same inputs twice: bitwise-equal weight grads
                _, _, tail2 = tb.bwd_tail(g, y, h1, attn, params, dm_a, dm_b)
                _, head2 = tb.bwd_head(x, dy, dqkv, params)
                if not all(torch.equal(tail[k], tail2[k]) for k in tail) or \
                        not all(torch.equal(head[k], head2[k]) for k in head):
                    raise RuntimeError(f"{label}: weight grads differ between two kernel calls")
                ms = {"fwd": cuda_ms(lambda: tb.forward(x, params, dm_a, dm_b, heads, scale,
                                                        band), 5),
                      "tail": cuda_ms(lambda: tb.bwd_tail(g, y, h1, attn, params, dm_a, dm_b), 5),
                      "head": cuda_ms(lambda: tb.bwd_head(x, dy, dqkv, params), 5)}
                plain_ms = {
                    "fwd": cuda_ms(lambda: tb.forward_reference(x, params, dm_a, dm_b, heads,
                                                                scale, band), 3),
                    "tail": cuda_ms(lambda: tb.bwd_tail_reference(g, y, h1, attn, params,
                                                                  dm_a, dm_b), 3),
                    "head": cuda_ms(lambda: tb.bwd_head_reference(x, dy, dqkv, params), 3)}
            # the whole autograd Function, kernels against plain versions
            grads = []
            for plain in (False, True):
                leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
                xl = x.clone().requires_grad_()
                o = tb.fused_block_train(xl, leaves, dm_a, dm_b, num_heads=heads, scale=scale,
                                         band=band, plain=plain)
                grads.append(torch.autograd.grad(o, [xl] + [leaves[k] for k in tb.PARAM_KEYS], g))
            for k, a, b in zip(("x",) + tb.PARAM_KEYS, *grads):
                check("Function", f"d{k}", a, b)
            # library yardsticks (timed only): the composed library Block
            # forward and its whole backward; the tail's and the head's
            # sub-graphs and their backwards
            leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
            xl = x.clone().requires_grad_()
            mask = (None if band is None else torch.from_numpy(
                local_attention_mask_col_major(*band)).to(device, dt))
            lib_fwd = cuda_ms(lambda: library_block(xl, leaves, mask, heads, scale), 5)
            lib_out = library_block(xl, leaves, mask, heads, scale)
            lib_in = [xl] + list(leaves.values())
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_in, g, retain_graph=True), 5)
            del lib_out
            attn_l = attn.clone().requires_grad_()
            lib_out = library_tail(xl, attn_l, leaves)
            lib_in = [xl, attn_l] + [leaves[k] for k in (
                "proj_kernel", "proj_bias", "norm2_scale", "norm2_bias", "fc1_kernel",
                "fc1_bias", "fc2_kernel", "fc2_bias")]
            lib_tail = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_in, g, retain_graph=True),
                               5)
            lib_out = library_head(xl, leaves)
            lib_in = [xl] + [leaves[k] for k in ("norm1_scale", "norm1_bias", "qkv_kernel",
                                                  "qkv_bias")]
            lib_head = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_in, dqkv,
                                                           retain_graph=True), 5)
            del lib_out, lib_in
            plan = svtr_block._band_spec(*band) if band else None
            pairs = n * n if band is None else int((mask == 0).sum())
            mask_bytes = 0 if band is None else 4 * n * plan[1]
            bounds = dict(zip(("fwd", "tail", "head"),
                              train_block_bounds_ms(BATCH, n, c, heads, hidden, dt, pairs,
                                                    mask_bytes)))
            library = {"fwd": lib_fwd, "tail": lib_tail, "head": lib_head}
            print(f"  {label} {'banded qb %d width %d' % plan[:2] if plan else 'full'}: "
                  f"max |err| fwd {errs['fwd']:.3e} tail {errs['tail']:.3e} head "
                  f"{errs['head']:.3e} Function {errs['Function']:.3e}, at most {worst:.3f} of "
                  f"each tensor's bound; forward outputs and weight grads bitwise repeatable; "
                  + _block_plan_text(tb._kernel_plan(dt, n, c, heads, hidden,
                                                     *(plan[:2] if plan else (n, n))))
                  + "; " + _bwd_plan_text(dt, BATCH * n, c, hidden))
            for kind in ("fwd", "tail", "head"):
                b_ms, o_ms = bounds[kind]
                bound = max(b_ms, o_ms)
                lib = library[kind]
                print(f"    {kind}: ms {ms[kind]:.4f}  plain_ms {plain_ms[kind]:.4f}  "
                      f"bound_ms {bound:.4f} ({'operations' if o_ms >= b_ms else 'bytes'}, "
                      f"{bound / ms[kind]:.1%} of bound)  library_ms {lib:.4f}"
                      + (f"  (whole library Block backward {lib_bwd:.4f})" if kind == "tail"
                         else ""))
                tot = totals.setdefault((kind, dt), dict(
                    ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                    ops_ms=0.0, max_abs_err=0.0))
                tot["ms"] += count * ms[kind]
                tot["plain_ms"] += count * plain_ms[kind]
                tot["library_ms"] += count * lib
                if kind == "tail":
                    tot["block_bwd_library_ms"] = tot.get("block_bwd_library_ms", 0.0) + \
                        count * lib_bwd
                tot["bound_ms"] += count * bound
                tot["bytes_ms"] += count * b_ms
                tot["ops_ms"] += count * o_ms
                tot["max_abs_err"] = max(tot["max_abs_err"], errs[kind])
    for (kind, dt), tot in totals.items():
        print(f"  train {kind}, one expert's 12 Blocks, {str(dt)[6:]}: "
              + ", ".join(f"{k} {v:.4g}" for k, v in tot.items()))
    return totals


def _task_alphabets():
    """Per-task alphabets whose cumulative sizes give CLASS_COUNTS (4
    special tokens in front)."""
    sizes = [CLASS_COUNTS[0] - 4] + [b - a for a, b in zip(CLASS_COUNTS, CLASS_COUNTS[1:])]
    starts = np.cumsum([0] + sizes[:-1])
    return [alphabet_of_size(n, 0x4E00 + int(s)) for n, s in zip(sizes, starts)]


def _train_learner(base, rng, loader, dtype):
    opt = base.replace(num_iter=TRAIN_ITERS, train_dtype=dtype, image_bank=loader.bank,
                       manual_seed=SEED)
    learner = MRN(opt)
    for count in CLASS_COUNTS[:TRAIN_TASK]:
        params, stats = random_recognizer(rng, opt, count)
        learner.add_expert(params, stats, count)
    return learner


@contextlib.contextmanager
def fused_train_env(flag):
    """``MRN_FUSED_TRAIN`` set to ``flag`` inside the block and restored
    after it, as ``bench.py`` does around its fused training rows."""
    saved = os.environ.get("MRN_FUSED_TRAIN")
    os.environ["MRN_FUSED_TRAIN"] = "1" if flag else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("MRN_FUSED_TRAIN", None)
        else:
            os.environ["MRN_FUSED_TRAIN"] = saved


def _step_pair(base, loader, character, dtype, variants, tol, what):
    """One step-0 step of a fresh expert from the same weights, batch and
    DropPath masks under each of two ``variants`` ((label, plain, fused)):
    loss, global grad norm and the fc grad must agree within ``tol``
    ((loss rtol, grad-norm rtol, fc-grad atol as a share of its largest
    |grad|))."""
    learner = MRN(base.replace(num_iter=TRAIN_ITERS, train_dtype=dtype,
                               image_bank=loader.bank, manual_seed=SEED))
    learner.character = list(character)
    learner.converter = learner.build_converter()
    learner.change_model()
    start = copy.deepcopy(learner.model.state_dict())
    batch = loader.get_batch()
    gen_state = learner.generator.get_state()
    captured = {}

    def keep_fc_grad(grads):
        captured["fc"] = grads["fc.kernel"].detach().clone()
        return grads

    learner.grad_transform = lambda: keep_fc_grad
    results = []
    for _, plain, fused in variants:
        learner.model.load_state_dict(start)
        learner.generator.set_state(gen_state)
        configure_blocks(learner.model, plain=plain)
        learner.build_optimizer()
        with fused_train_env(fused):
            metrics = learner.train_step(batch)
        results.append((float(metrics["loss"]), float(metrics["grad_norm"]), captured["fc"]))
    configure_blocks(learner.model, plain=False)
    (lk, gk, fk), (lp, gp, fp) = results
    loss_rtol, norm_rtol, fc_share = tol
    largest = float(fp.abs().max())
    dfc = float((fk - fp).abs().max())
    print(f"  {dtype} step-0 step, {what}: loss {lk:.7f} vs {lp:.7f} "
          f"(rel {abs(lk - lp) / abs(lp):.2e}, tol {loss_rtol:g}), grad_norm {gk:.6f} vs "
          f"{gp:.6f} (rel {abs(gk - gp) / gp:.2e}, tol {norm_rtol:g}), fc grad max |diff| "
          f"{dfc:.3e} of max |grad| {largest:.3e} (tol {fc_share:g} of it)")
    if abs(lk - lp) > loss_rtol * abs(lp) or abs(gk - gp) > norm_rtol * gp \
            or dfc > fc_share * largest:
        raise RuntimeError(f"{dtype}: the {what} training steps disagree")


def reset_launches():
    svtr_attention.launches.update(full=0, banded=0)
    svtr_block.launches = 0
    svtr_train_block.launches.update(train_fwd=0, train_bwd_tail=0, train_bwd_head=0)


def read_launches():
    return dict(svtr_attention.launches, fused=svtr_block.launches, **svtr_train_block.launches)


def val_points(num_iter, val_interval):
    """The iterations ``_run_loop`` validates at: 1, every ``val_interval``
    and the last."""
    return len({i for i in range(1, num_iter + 1)
                if i % val_interval == 0 or i in (1, num_iter)})


def val_launches(opt, ff_batches, tf_batches):
    """Kernel-4 launches of the validations of one task-5 training run:
    step 0 FF, step 1 TF every val_interval // 5."""
    n0, n1 = TRAIN_ITERS, TRAIN_ITERS // 2
    return (val_points(n0, opt.val_interval) * ff_batches * FF_LAUNCHES
            + val_points(n1, max(1, opt.val_interval // 5)) * tf_batches * TF_LAUNCHES)


def _train_runs(base, rng, loader, character, valid, tag):
    """``MRN.incremental_train`` of task 5 for each dtype of TRAIN_DTYPES,
    from fresh learners, validated on ``valid``; prints each step (its time
    the mean step of its ``StepMeter`` window, synced at the window's end,
    validation left out) and checks that it moved."""
    learners = {dtype: _train_learner(base, rng, loader, dtype) for dtype in TRAIN_DTYPES}
    n0, n1 = TRAIN_ITERS, TRAIN_ITERS // 2
    reset_launches()
    for dtype, learner in learners.items():
        init_rng = copy.deepcopy(learner.weight_rng)
        learner.incremental_train(TRAIN_TASK, character, loader, valid)
        init_fc = random_recognizer(init_rng, learner.opt, CLASS_COUNTS[-1])[0]["fc"]["kernel"]
        init_route = random_router(init_rng, learner.opt, N_EXPERTS)["route"]["kernel"]
        moved = (float((learner.expert_states[-1]["fc.kernel"].cpu()
                        - torch.from_numpy(init_fc)).abs().max()),
                 float((learner.router_state["route.kernel"].cpu()
                        - torch.from_numpy(init_route)).abs().max()))
        for rec in learner.history:
            print(f"  {tag} {dtype} task {rec['task']} step {rec['step']} iter "
                  f"{rec['iteration']}: loss {rec['loss']:.5f}"
                  + (f" (clf {rec['clf']:.5f}, router {rec['router']:.5f})" if "clf" in rec else "")
                  + f", grad_norm {rec['grad_norm']:.4g}, lr {rec['lr']:.4g}, "
                  f"{1e3 * rec['seconds']:.1f} ms/step over its window, "
                  f"{BATCH / rec['seconds']:.1f} images/s")
        print(f"  {tag} {dtype}: max |change| of the new expert's fc {moved[0]:.3e}, "
              f"of the router's route kernel {moved[1]:.3e}")
        if not all(np.isfinite(rec["loss"]) for rec in learner.history):
            raise RuntimeError(f"{tag} {dtype}: non-finite training loss")
        if len(learner.history) != n0 + n1 or min(moved) <= 0.0:
            raise RuntimeError(f"{tag} {dtype}: the trained parameters did not move")
    return read_launches(), learners


def _train_setup(base):
    """The task-5 training stream (a uint8 bank of every task's crops) and
    the training phases' validation: one batch of task 5's own crops,
    rendered from a seed of its own."""
    alphabets = _task_alphabets()
    t0 = time.perf_counter()
    loader = SyntheticTaskLoader(alphabets, TRAIN_TASK, BATCH, CROPS_PER_TASK,
                                 img_h=base.imgH, img_w=base.imgW, seed=SEED)
    val_set = synthetic_val_set(alphabets, TRAIN_TASK, BATCH, base.imgH, base.imgW,
                                seed=SEED + 1)
    print(f"  rendered {len(loader.labels)} crops {loader.bank.shape[1:]} into the bank "
          f"and {len(val_set)} validation crops in {time.perf_counter() - t0:.1f} s")
    valid = ValDataset(["val"], base, {"val": val_set}.__getitem__)
    return alphabets, loader, valid


def phase_train(rng, base, character, loader, valid):
    """Slice 2's path: SVTR-MRN training of task 5 at full width on the
    composed route (step 0, the new expert alone; step 1, the router over 6
    frozen experts) through ``MRN.incremental_train``, bf16 then f32,
    validated on one batch; then, in each dtype, one step-0 step on the
    kernel path against the same step on the plain versions."""
    n0, n1 = TRAIN_ITERS, TRAIN_ITERS // 2
    steps = len(TRAIN_DTYPES)
    with fused_train_env(False):
        # ---- counted run: the main path, through the entry point
        launches, learners = _train_runs(base, rng, loader, character, valid, "composed")
    n_val = val_launches(base, 1, 1) * steps
    expected = dict(full=6 * n0 * steps, banded=6 * n0 * steps,
                    fused=72 * n1 * steps + n_val,
                    train_fwd=0, train_bwd_tail=0, train_bwd_head=0)
    print(f"  launches in the composed training runs: {launches} (expected {expected}: "
          f"per step-0 step 6 full + 6 banded attention, per step-1 step 72 fused "
          f"Blocks = {N_EXPERTS} experts x 12, and {n_val} fused Blocks of the "
          f"validations = {steps} runs x ({val_points(n0, base.val_interval)} FF x "
          f"{FF_LAUNCHES} + {val_points(n1, max(1, base.val_interval // 5))} TF x "
          f"{TF_LAUNCHES}) of one batch)")
    if launches != expected:
        raise RuntimeError("the training path did not run through the kernels as expected")
    for dtype in TRAIN_DTYPES:
        _step_pair(base, loader, character, dtype,
                   (("kernel", False, False), ("plain", True, False)),
                   TRAIN_STEP_TOL[dtype], "kernel vs plain")
    return launches, learners


def phase_train_fused(rng, base, character, loader, valid):
    """Slice 3's path: the same task-5 training with ``MRN_FUSED_TRAIN=1``
    (every train-mode Block is the fused training Block: 12 forward, 12 tail
    and 12 head launches per step-0 step, no attention-kernel launch), bf16
    then f32; then one step-0 step on the fused kernels against the fused
    plain versions in each dtype, and one f32 step-0 step fused against
    composed with the same masks."""
    n0, n1 = TRAIN_ITERS, TRAIN_ITERS // 2
    steps = len(TRAIN_DTYPES)
    with fused_train_env(True):
        # ---- counted run: the main path, through the entry point
        launches, learners = _train_runs(base, rng, loader, character, valid, "fused")
    n_val = val_launches(base, 1, 1) * steps
    expected = dict(full=0, banded=0, fused=72 * n1 * steps + n_val,
                    train_fwd=12 * n0 * steps,
                    train_bwd_tail=12 * n0 * steps, train_bwd_head=12 * n0 * steps)
    print(f"  launches in the fused training runs: {launches} (expected {expected}: "
          f"per step-0 step 12 forward + 12 tail + 12 head fused training Blocks and no "
          f"attention kernel, per step-1 step 72 fused inference Blocks, and {n_val} of "
          f"the validations, as in the composed runs)")
    if launches != expected:
        raise RuntimeError("the fused training path did not run through the kernels as expected")
    for dtype in TRAIN_DTYPES:
        _step_pair(base, loader, character, dtype,
                   (("kernel", False, True), ("plain", True, True)),
                   FUSED_STEP_TOL[dtype], "fused kernels vs fused plain")
    _step_pair(base, loader, character, "f32",
               (("fused", False, True), ("composed", False, False)),
               FUSED_VS_COMPOSED_TOL, "fused vs composed")
    return launches, learners


def phase_profile(runs, loader):
    """Where one step's device time goes: ``torch.profiler`` over one step
    of each (label, learner, fused) of ``runs`` -- step 1 as the router
    phase ended, or the learner's standalone expert again for step 0.
    Prints the kernels with the most device time, the device-busy time and
    the host-clock step time (the profiler's own overhead is inside the
    latter)."""
    from torch.profiler import ProfilerActivity, profile

    for label, learner, fused in runs:
        if label.endswith("step 0"):
            learner._phase = "standalone"
            learner.build_optimizer()
            get_batch = loader.get_batch
        else:
            get_batch = loader.get_batch2
        batch = get_batch()
        with fused_train_env(fused):
            learner.train_step(batch)     # warm-up outside the trace
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                t0 = time.perf_counter()
                learner.train_step(batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        print_device_profile(f"bf16 {label}, one step", prof, wall)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def check_same_tree(what, got, ref):
    """Leaf for leaf: the same keys, dtypes, shapes and bytes."""
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    if got.keys() != ref.keys():
        raise RuntimeError(f"{what}: keys differ ({sorted(got.keys() ^ ref.keys())[:4]})")
    for k, r in ref.items():
        g = got[k]
        if g.dtype != r.dtype or g.shape != r.shape or g.tobytes() != r.tobytes():
            raise RuntimeError(f"{what}: leaf {k} differs")
    return len(ref)


def _ff_logits(learner, model, x, plain):
    """The standalone expert's float32 eval logits of one batch on the
    kernels or on the plain versions."""
    configure_blocks(model, plain=plain)
    try:
        with torch.no_grad():
            return learner._eval_logits(x, "FF").float()
    finally:
        configure_blocks(model, plain=False)


def check_validation_paths(learner, loader, choose, model):
    """Check (c): ``run_validation`` on the kernels (timed: crops/s) and on
    the plain versions (``configure_blocks(plain=True)``), and, batch by
    batch, the two paths' outputs: expert picks (TF) equal except on a
    near-tie of the plain route scores and the logits of samples with the
    same pick within LOGIT_TOL (``routed_vs_plain``; FF: every sample's); a
    greedy pick different only where the plain top-2 margin is within twice
    the row's largest logit difference; each such sample's CTC within
    VAL_LOSS_RTOL.  Words may differ only on those
    samples, and the score and NED by no more than they account for; with
    no flipped expert pick the validation losses agree within
    VAL_LOSS_RTOL."""
    res, secs = {}, {}
    for plain in (False, True):
        configure_blocks(model, plain=plain)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[plain] = learner.run_validation(loader, choose)
            secs[plain] = time.perf_counter() - t0
        finally:
            configure_blocks(model, plain=False)
    atol, rtol = LOGIT_TOL[torch.float32]
    flipped, expert_flips, worst_loss, offset = set(), 0, 0.0, 0
    for images, labels, n_valid in loader:
        x = learner._device_images(images)[:n_valid]
        if choose == "TF":
            out_k, out_p, same = routed_vs_plain(model, x, (atol, rtol), "TF validation")
            lk, lp = out_k["logits"].float(), out_p["logits"].float()
            expert_flips += int((~same).sum())
        else:
            lk, lp = (_ff_logits(learner, model, x, plain) for plain in (False, True))
            same = torch.ones(n_valid, dtype=torch.bool, device=x.device)
            check_close("FF validation logits", lk, lp, atol, rtol)
        delta = (lk - lp).abs().amax(dim=2, keepdim=True)
        top2 = lp.topk(2, dim=2).values
        pick_flip = (lk.argmax(2) != lp.argmax(2)) & same[:, None]
        if bool((pick_flip & ((top2[..., 0] - top2[..., 1]) > 2 * delta[..., 0])).any()):
            raise RuntimeError(f"{choose} validation: greedy picks differ beyond near-ties")
        labels_index, lengths = learner.converter.encode(
            labels[:n_valid], batch_max_length=learner.opt.batch_max_length)
        lengths = torch.as_tensor(lengths, device=x.device)
        target = torch.as_tensor(labels_index, device=x.device)
        per_k = ctc_loss_per_sample(lk, target, lengths)[same]
        per_p = ctc_loss_per_sample(lp, target, lengths)[same]
        rel = ((per_k - per_p).abs() / per_p.abs()).max() if len(per_p) else torch.zeros(())
        worst_loss = max(worst_loss, float(rel))
        flipped |= {offset + i for i in range(n_valid)
                    if not bool(same[i]) or bool(pick_flip[i].any())}
        offset += n_valid
    k, p = res[False], res[True]
    words = {i for i, (a, b) in enumerate(zip(k.preds, p.preds)) if a != b}
    share = 100.0 * len(flipped) / max(1, k.length_of_data)
    loss_rel = abs(k.loss - p.loss) / abs(p.loss)
    print(f"  {choose} validation of {k.length_of_data} crops: kernels {secs[False]:.3f} s "
          f"({k.length_of_data / secs[False]:.1f} crops/s), plain {secs[True]:.3f} s; "
          f"score {k.score:.2f} vs {p.score:.2f}, NED {k.ned:.4f} vs {p.ned:.4f}, loss "
          f"{k.loss:.6f} vs {p.loss:.6f} (rel {loss_rel:.2e}, tol {VAL_LOSS_RTOL:g}); "
          f"per-sample CTC max rel {worst_loss:.2e}; {len(words)} words differ, "
          f"{len(flipped)} samples with a near-tie flip ({expert_flips} expert picks)")
    if not words <= flipped or worst_loss > VAL_LOSS_RTOL:
        raise RuntimeError(f"{choose} validation: kernel and plain paths disagree")
    if abs(k.score - p.score) > share or abs(k.ned - p.ned) > share:
        raise RuntimeError(f"{choose} validation: scores differ beyond the near-tie flips")
    if expert_flips == 0 and loss_rel > VAL_LOSS_RTOL:
        raise RuntimeError(f"{choose} validation: losses disagree")
    return k.length_of_data / secs[False]


def phase_checkpoints(base, alphabets, loader):
    """This slice's path: task 5 of SVTR-MRN at full width (5 frozen random
    experts plus the new one, 4500 classes, batch 256), bf16 policy,
    ``num_iter`` 4, through ``MRN.incremental_train`` with validation on one
    synthetic set of VAL_CROPS per seen task (FF at step 0 on task 5's set,
    TF at step 1 on all six), best checkpoints and expert blobs written to
    ``opt.output_dir``, then ``MRN.test`` (reloads the step-1 best, scores
    every seen task).  Checks: (a) the best files reload leaf for leaf
    what was saved, the blob names are the hashes of the restored trees;
    (b) ``Server.from_checkpoint`` on the step-1 file serves the learner's
    TF logits bitwise in float32, and bfloat16 against its plain path; (c)
    FF and TF validation on the kernels against the plain versions; (d)
    ``test`` scores every seen task."""
    rng = np.random.default_rng(SEED + 10)   # leaves the later phases' draws as they were
    character = "".join(alphabets)
    sets = {f"val/{t}": synthetic_val_set(alphabets, t, VAL_CROPS, base.imgH, base.imgW,
                                          seed=SEED + 100 + t)
            for t in range(TRAIN_TASK + 1)}
    names = list(sets)
    # a directory of its own: every blob this run needs is written (and seen) here
    learner = _train_learner(base.replace(output_dir=os.path.join(base.output_dir, "ckpt")),
                             rng, loader, "bf16")
    valid = ValDataset(names, learner.opt, sets.__getitem__)

    def builder(name):
        return ValDataset([name], learner.opt, sets.__getitem__).create_dataset()

    saved = {}   # path -> the trees handed to save_model (the last write of each file)
    write = mrn_learner.save_model

    def capture(path, params, stats, extra=None):
        saved[path] = copy.deepcopy(dict(params=params, batch_stats=stats, **(extra or {})))
        return write(path, params, stats, extra)

    ff_batches = -(-VAL_CROPS // BATCH)
    tf_batches = -(-len(names) * VAL_CROPS // BATCH)
    n0, n1 = TRAIN_ITERS, TRAIN_ITERS // 2
    # ---- counted run: the main path, through the entry points
    with fused_train_env(False), mock.patch.object(mrn_learner, "save_model", capture):
        reset_launches()
        t0 = time.perf_counter()
        learner.incremental_train(TRAIN_TASK, character, loader, valid)
        t1 = time.perf_counter()
        best, _ = learner.test(names, [], [], TRAIN_TASK, val_dataset_builder=builder)
        t2 = time.perf_counter()
        launches = read_launches()
    n_val = val_launches(learner.opt, ff_batches, tf_batches)
    n_test = len(names) * ff_batches * TF_LAUNCHES
    expected = dict(full=6 * n0, banded=6 * n0, fused=72 * n1 + n_val + n_test,
                    train_fwd=0, train_bwd_tail=0, train_bwd_head=0)
    print(f"  incremental_train {t1 - t0:.1f} s, test {t2 - t1:.1f} s; launches {launches} "
          f"(expected {expected}: 6 full + 6 banded attention per step-0 step, 72 fused "
          f"Blocks per step-1 step, {n_val} in the validations = "
          f"{val_points(n0, learner.opt.val_interval)} FF x {ff_batches} batches x "
          f"{FF_LAUNCHES} + {val_points(n1, max(1, learner.opt.val_interval // 5))} TF x "
          f"{tf_batches} batches x {TF_LAUNCHES}, {n_test} in test = {len(names)} sets x "
          f"{ff_batches} batches x {TF_LAUNCHES})")
    if launches != expected:
        raise RuntimeError("validation and test did not run through the kernels as expected")
    for rec in learner.history:
        print(f"  bf16 task {rec['task']} step {rec['step']} iter {rec['iteration']}: loss "
              f"{rec['loss']:.5f}, {1e3 * rec['seconds']:.1f} ms/step over its window")
    log = open(learner.log.train_log_path, encoding="utf-8").read()
    for line in log.splitlines():
        if line.startswith(("Current_score", "Best_score", "Task 5 load", "Task 5 Test AIA",
                            "Task 5 accs", "ned:")):
            print(f"    log: {line}")

    # ---- (d) test() scored every seen task
    accs = ast.literal_eval(log.split("Task 5 accs: ")[-1].splitlines()[0])
    print(f"  (d) test(): task accuracies {accs}, AIA {best[-1]}")
    if len(accs) != len(names) or not all(np.isfinite(accs)) or len(best) != 1:
        raise RuntimeError("test() did not score every seen task")

    # ---- (a) the best files reload what was saved, leaf for leaf
    path1 = learner._best_path(TRAIN_TASK, 1)
    path0 = learner._best_path(TRAIN_TASK, 0)
    blob_dir = learner._expert_dir()
    refs = saved[path1]["expert_refs"]
    if learner._expert_hashes != refs:
        raise RuntimeError("(a) the restored blob refs differ from the saved ones")
    n_leaves = 0
    for i, state in enumerate(learner.expert_states):
        params, stats = state_to_flax(state)
        blob = saved[os.path.join(blob_dir, f"{refs[i]}.msgpack")]
        n_leaves += check_same_tree(f"(a) expert {i}", params, blob["params"])
        n_leaves += check_same_tree(f"(a) expert {i} stats", stats, saved[path1]["expert_stats"][i])
        if tree_hash(params, stats) != refs[i]:
            raise RuntimeError(f"(a) blob {refs[i]} is not the hash of expert {i}'s trees")
    n_leaves += check_same_tree("(a) router", learner._router_tree(), saved[path1]["router"])
    check_same_tree("(a) step-1 params", learner._router_tree(), saved[path1]["params"])
    learner._load_best(TRAIN_TASK, 0)
    params, stats = to_flax(learner.model)
    n_leaves += check_same_tree("(a) step-0 expert", params, saved[path0]["params"])
    n_leaves += check_same_tree("(a) step-0 stats", stats, saved[path0]["batch_stats"])
    learner._load_best(TRAIN_TASK, 1)
    print(f"  (a) {n_leaves} leaves of the step-0 and step-1 best files and the "
          f"{len(refs)} blobs reload bitwise; blob names are the restored trees' hashes")

    # checkpoint sizes and times
    t0 = time.perf_counter()
    blob_params, blob_stats = state_to_flax(learner.expert_states[-1])
    t1 = time.perf_counter()
    probe = os.path.join(learner.opt.output_dir, "probe.msgpack")
    n_bytes = checkpoint.save_model(probe, blob_params, blob_stats, extra={"class_count": 1})
    t2 = time.perf_counter()
    checkpoint.load_model(probe)
    t3 = time.perf_counter()
    checkpoint.load_model(path1)
    t4 = time.perf_counter()
    print(f"  checkpoint bytes per best save: step 1 (router only, {len(refs)} refs, every "
          f"expert's stats) {os.path.getsize(path1)}, step 0 (one expert inline) "
          f"{os.path.getsize(path0)}; one expert blob {n_bytes}; device-to-host trees "
          f"{t1 - t0:.3f} s, save_model {t2 - t1:.3f} s, load_model {t3 - t2:.3f} s (blob), "
          f"{t4 - t3:.3f} s (step-1 file)")

    # ---- (b) serving the step-1 file
    images = next(iter(valid.create_list_dataset()))[0]
    srv = Server.from_checkpoint(base.replace(compute_dtype="float32"), path1, character,
                                 TRAIN_TASK)
    with torch.no_grad():
        ref = learner._eval_logits(learner._device_images(images), "TF")
    got = srv.forward(images)["logits"]
    if not torch.equal(got, ref):
        raise RuntimeError("(b) Server.from_checkpoint's logits differ from the learner's")
    print(f"  (b) float32 Server.from_checkpoint: logits {tuple(got.shape)} bitwise equal "
          f"to the learner's TF eval logits on the first validation batch")
    srv16 = Server.from_checkpoint(base.replace(compute_dtype="bfloat16"), path1, character,
                                   TRAIN_TASK)
    out16, _, _ = routed_vs_plain(srv16.model, srv16.images(images),
                                  LOGIT_TOL[torch.bfloat16], "(b) bfloat16 from_checkpoint")
    print(f"  (b) bfloat16 against float32 served: max |logit diff| "
          f"{float((out16['logits'].float() - got).abs().max()):.3e} (not checked)")
    del srv, srv16

    # ---- (c) FF and TF validation, kernels against plain versions
    learner._phase = "standalone"
    ff_rate = check_validation_paths(learner, valid.create_dataset(), "FF", learner.model)
    learner._phase = "routed"
    tf_rate = check_validation_paths(learner, valid.create_list_dataset(), "TF",
                                     learner._eval_ensemble())
    print(f"  validation crops/s (float32 experts, host clock around run_validation): "
          f"FF {ff_rate:.1f}, TF {tf_rate:.1f}")
    return launches


class _Crash(Exception):
    """The crash check (c) injects."""


class _MemoryDraw:
    """What MRN's memory draw reads of its learner: ``opt``, ``np_rng``
    (seeded as the learner's) and ``memory_index``."""
    build_random_current_memory = BaseLearner.build_random_current_memory
    reduce_samplers = BaseLearner.reduce_samplers
    build_rehearsal_memory = MRN.build_rehearsal_memory

    def __init__(self, opt):
        self.opt, self.np_rng, self.memory_index = opt, np.random.default_rng(opt.manual_seed), []


def _campaign_opt(out, source, device, **kw):
    opt = campaign.campaign_options(
        tasks=len(campaign.LANS), num_iter=CAMPAIGN_ITERS, batch_size=BATCH,
        seed=CAMPAIGN_SEED, bf16=True, out=out,
        **dict(dict(memory_num=CAMPAIGN_MEMORY, val_interval=CAMPAIGN_VAL), **kw))
    opt.image_bank = source.device_bank(device)
    return opt


def _campaign_run(opt, source, crash_after=None):
    """``run_incremental`` recording each step's (task, phase, batch
    indices, router targets) and the memory sizes after each draw; with
    ``crash_after`` it raises after that many routed steps and the crash is
    swallowed."""
    learner = MRN(opt)
    steps, sizes, routed = [], [], [0]
    step, draw = learner.train_step, learner.build_rehearsal_memory

    def recorded_step(fetched):
        if crash_after is not None and learner._phase == "routed":
            routed[0] += 1
            if routed[0] > crash_after:
                raise _Crash()
        steps.append((learner._cur_task, learner._phase, np.asarray(fetched[0]).copy(),
                      np.asarray(fetched[2]).copy() if len(fetched) > 2 else None))
        return step(fetched)

    def recorded_draw(manager, taski):
        draw(manager, taski)
        sizes.append([len(ix) for ix in learner.memory_index])

    learner.train_step, learner.build_rehearsal_memory = recorded_step, recorded_draw
    result = None
    try:
        result = campaign.run_incremental(opt, source, learner=learner)[1:]
    except _Crash:
        pass
    return learner, steps, sizes, result


def _stream_again(opt, source):
    """The campaign's stream built again without the learner or the
    prefetcher: per task the step-0 build and ``num_iter`` batches, then
    (task > 0) the memory draw and ``num_iter // 2`` indexed batches."""
    manager = DatasetManager(opt, dataset_factory=source.train_factory)
    manager.init_start(opt, opt.select_data, None, 0)
    draw, steps = _MemoryDraw(opt), []
    for taski in range(len(opt.lan_list)):
        if taski:
            manager.get_dataset(taski, memory=None)
        steps += [(taski, "standalone", manager.get_batch()[0], None)
                  for _ in range(opt.num_iter)]
        if taski:
            draw.build_rehearsal_memory(manager, taski)
            steps += [(taski, "routed") + tuple(manager.get_batch2()[::2])
                      for _ in range(opt.num_iter // 2)]
    return steps, draw.memory_index


def _same_steps(what, got, ref):
    if len(got) != len(ref) or any(
            g[:2] != r[:2] or g[2].tobytes() != r[2].tobytes()
            or (g[3] is None) != (r[3] is None)
            or (g[3] is not None and g[3].tobytes() != r[3].tobytes())
            for g, r in zip(got, ref)):
        raise RuntimeError(f"{what}: the batches differ")


def campaign_launches(tasks, ff_batches):
    """Kernel launches of the campaign run: 6 full + 6 banded attention per
    step-0 step; kernel 4 in the FF validations (12 a batch), the step-1
    steps and TF validations ((t + 1) experts x 12 a step or batch, t + 1
    test sets of one batch at task t), and ``test`` plus the matrix row (FF
    at task 0, TF later), each over every seen set."""
    n0, n1 = CAMPAIGN_ITERS, CAMPAIGN_ITERS // 2
    fused = 0
    for t in range(tasks):
        experts = (t + 1) * 12
        fused += val_points(n0, CAMPAIGN_VAL) * ff_batches * 12
        if t == 0:
            fused += 2 * ff_batches * 12
            continue
        fused += n1 * experts
        fused += val_points(n1, max(1, CAMPAIGN_VAL // 5)) * (t + 1) * ff_batches * experts
        fused += 2 * (t + 1) * ff_batches * experts
    return dict(full=6 * n0 * tasks, banded=6 * n0 * tasks, fused=fused,
                train_fwd=0, train_bwd_tail=0, train_bwd_head=0)


def _step0_window(learner, manager, prefetch):
    """The mean step-0 step (host clock, synced at both ends) of TIME_STEPS
    steps after TIME_WARMUP, batches from ``manager`` through a prefetcher
    or not."""
    n = TIME_WARMUP + TIME_STEPS
    fetch = Prefetcher(manager.get_batch, n) if prefetch else manager.get_batch
    try:
        for _ in range(TIME_WARMUP):
            learner.train_step(fetch())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIME_STEPS):
            learner.train_step(fetch())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / TIME_STEPS
    finally:
        if prefetch:
            fetch.close()


def campaign_source():
    """The campaign suite, cut: train instance counts / CAMPAIGN_CUT,
    CAMPAIGN_TEST test crops a task."""
    t0 = time.perf_counter()
    n_train = [n // CAMPAIGN_CUT for n in campaign.N_TRAIN]
    shape = campaign.campaign_options()
    source = campaign.build_source(shape, CAMPAIGN_SEED, None, n_train,
                                   [CAMPAIGN_TEST] * len(campaign.LANS))
    print(f"  rendered {len(source.bank)} crops {source.bank.shape[1:]} (train {n_train}, "
          f"test {CAMPAIGN_TEST} a task) in {time.perf_counter() - t0:.1f} s")
    return source


def phase_campaign(out_dir, device, source):
    """This slice's path: the 6-task campaign through ``run_incremental``
    (cuts in CAMPAIGN_*), counting kernel launches; checks (a)-(c) and
    prints (d)-(e) (see the module doc).  Returns the launches."""
    out = os.path.join(out_dir, "campaign")
    opt = _campaign_opt(out, source, device)

    # ---- counted run: the main path, through the entry point
    with fused_train_env(False):
        reset_launches()
        t0 = time.perf_counter()
        learner, steps, sizes, (aia, matrix, seconds) = _campaign_run(opt, source)
        wall = time.perf_counter() - t0
        launches = read_launches()
    ff_batches = -(-CAMPAIGN_TEST // BATCH)
    expected = campaign_launches(len(campaign.LANS), ff_batches)
    print(f"  run_incremental over {len(campaign.LANS)} tasks in {wall:.1f} s; launches "
          f"{launches} (expected {expected}: 6 full + 6 banded attention per step-0 step; "
          f"kernel 4 in the step-1 steps, the validations, test and the matrix rows)")
    if launches != expected:
        raise RuntimeError("the campaign did not run through the kernels as expected")

    # ---- (a) the stream, prefetched, against the same stream built again
    again, memory = _stream_again(opt, source)
    _same_steps("(a) prefetched against rebuilt", steps, again)
    targets = np.concatenate([s[3] for s in steps if s[1] == "routed"])
    if set(targets.tolist()) != {0, 1}:
        raise RuntimeError(f"(a) step-1 router targets are {sorted(set(targets.tolist()))}")
    if [ix.tobytes() for ix in learner.memory_index] != [ix.tobytes() for ix in memory]:
        raise RuntimeError("(a) the learner's memory indices differ from the rebuilt draw")
    print(f"  (a) {len(steps)} batches the loop took with the prefetcher equal the rebuilt "
          f"stream's bitwise; step-1 targets binary ({int((targets == 0).sum())} memory, "
          f"{int((targets == 1).sum())} current); memory indices equal")

    # ---- (b) memory sizes: memory_num / taski each, earlier memories cut
    want = [[int(CAMPAIGN_MEMORY / t)] * t for t in range(1, len(campaign.LANS))]
    print(f"  (b) memory sizes after tasks 1-5: {sizes} (expected {want})")
    if sizes != want:
        raise RuntimeError("(b) the rehearsal memory has the wrong sizes")

    # ---- (d) the accuracy matrix
    print(f"  (d) accuracy matrix {matrix}; AIA per stage {aia}; seconds per stage {seconds}; "
          f"forgetting {campaign.forgetting(matrix)}")
    if [len(r) for r in matrix] != list(range(1, 7)) or not np.all(np.isfinite(aia)):
        raise RuntimeError("(d) the matrix is not 6 stages of finite scores")
    for t in range(len(campaign.LANS)):
        for s, label in ((0, "step 0"), (1, "step 1")):
            recs = [r for r in learner.history if r["task"] == t and r["step"] == s]
            if recs:
                print(f"    task {t} {label}: {len(recs)} steps, loss {recs[0]['loss']:.4f} "
                      f"-> {recs[-1]['loss']:.4f}, last window "
                      f"{1e3 * recs[-1]['seconds']:.1f} ms/step")
    history = learner.history

    # ---- (e) step-0 windows with and without the prefetcher, a trace
    learner._phase = "standalone"
    learner.build_optimizer()
    manager = DatasetManager(opt, dataset_factory=source.train_factory)
    manager.init_start(opt, opt.select_data, None, len(campaign.LANS) - 1)
    with fused_train_env(False):
        windows = {flag: [] for flag in (True, False)}
        for flag in (True, False, True, False):
            windows[flag].append(_step0_window(learner, manager, flag))
        from torch.profiler import ProfilerActivity, profile
        fetch = Prefetcher(manager.get_batch, TRACE_STEPS + 1)
        try:
            learner.train_step(fetch())
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                t1 = time.perf_counter()
                for _ in range(TRACE_STEPS):
                    learner.train_step(fetch())
                torch.cuda.synchronize()
                traced = time.perf_counter() - t1
        finally:
            fetch.close()
    print(f"  (e) composed bf16 step 0, {TIME_STEPS}-step windows after {TIME_WARMUP} steps, "
          f"no validation in them: prefetch on "
          f"{', '.join(f'{1e3 * w:.2f}' for w in windows[True])} ms/step, off "
          f"{', '.join(f'{1e3 * w:.2f}' for w in windows[False])} ms/step")
    idle = print_device_profile(f"(e) bf16 step 0, {TRACE_STEPS} steps, prefetch on", prof,
                                traced)
    print(f"  (e) idle share of the traced window: "
          f"{'not measured' if idle is None else f'{idle:.1%}'}")
    del learner, manager

    # ---- (c) crash and resume in the router phase of task 5
    replay = dict(start_task=len(campaign.LANS) - 0.5, eval_from=len(campaign.LANS))
    ref, ref_steps, _, _ = _campaign_run(_campaign_opt(out, source, device, **replay), source)
    _campaign_run(_campaign_opt(out, source, device, full_ckpt=True, **replay), source,
                  crash_after=CAMPAIGN_CRASH)
    last = len(campaign.LANS) - 1
    path = os.path.join(out, "saved", opt.exp_name,
                        f"{campaign.LANS[last]}_{last}_1_train_state.msgpack")
    if not os.path.exists(path):
        raise RuntimeError("(c) the crashed run left no snapshot")
    resumed, res_steps, _, _ = _campaign_run(
        _campaign_opt(out, source, device, full_ckpt=True, resume_full=True, **replay), source)
    if os.path.exists(path):
        raise RuntimeError("(c) the completed stage kept its snapshot")
    start = len(ref_steps) - len(res_steps)
    _same_steps("(c) resumed against uninterrupted", res_steps, ref_steps[start:])
    loss_rtol, _, share = TRAIN_STEP_TOL["bf16"]
    ref_loss = [r["loss"] for r in ref.history[start:]]
    res_loss = [r["loss"] for r in resumed.history]
    dloss = max(abs(a - b) / abs(b) for a, b in zip(res_loss, ref_loss))
    drouter = max(float((resumed.router_state[k] - v).abs().max()) / max(float(v.abs().max()),
                                                                         1e-12)
                  for k, v in ref.router_state.items())
    print(f"  (c) crash after routed step {CAMPAIGN_CRASH} of task {last}, resumed from step "
          f"{start}: {len(res_steps)} batches equal the uninterrupted replay's bitwise; losses "
          f"max rel diff {dloss:.3e} (tol {loss_rtol:g}), router max |diff| {drouter:.3e} of "
          f"its largest |param| (tol {share:g})")
    if dloss > loss_rtol or drouter > share:
        raise RuntimeError("(c) the resumed run left the uninterrupted one")
    return launches, history


class _BaseMemoryDraw(_MemoryDraw):
    """The base learner's memory draw (WA's and DER's), on its own
    generator."""
    build_rehearsal_memory = BaseLearner.build_rehearsal_memory


def _strategy_opt(out, source, device, il):
    opt = campaign.campaign_options(
        tasks=STRATEGY_TASKS, num_iter=STRATEGY_ITERS, batch_size=BATCH, seed=CAMPAIGN_SEED,
        bf16=True, out=out, il=il, memory_num=CAMPAIGN_MEMORY, val_interval=STRATEGY_VAL,
        fisher_num_iter=STRATEGY_FISHER)
    opt.image_bank = source.device_bank(device)
    return opt


def _strategy_stream(opt, source):
    """A strategy's stream built again without the learner or the
    prefetcher: the joint streams' ``num_iter`` batches, or per task the
    build (the memory draw of a strategy that keeps one), ``num_iter``
    batches and EWC's Fisher batches."""
    manager = DatasetManager(opt, dataset_factory=source.train_factory)
    n = opt.num_iter
    if opt.il.startswith("joint"):
        for t in range(len(opt.lan_list)):
            manager.joint_start(opt, opt.select_data, None, t, len(opt.lan_list))
        return [manager.get_batch()[0] for _ in range(n)]
    manager.init_start(opt, opt.select_data, None, 0)
    draw, batches = _BaseMemoryDraw(opt), []
    for t in range(len(opt.lan_list)):
        if t and opt.memory is not None:
            draw.build_rehearsal_memory(manager, t)
        elif t:
            manager.get_dataset(t, memory=None)
        extra = opt.fisher_num_iter if opt.il == "ewc" else 0
        batches += [manager.get_batch()[0] for _ in range(n + extra)]
    return batches


def strategy_launches(il, tasks, ff_batches):
    """Launches of rows 1, 2 and 4 in one strategy's run: 6 full + 6 banded
    attention per train-mode forward of one network (each step, and EWC's
    Fisher batches); row 4, 12 per network and eval batch: the
    validations (DER's network has t + 1 extractors at task t), ``test``
    and the matrix row over every seen set, LwF's and WA's old network and
    DER's t frozen extractors in each step of task t; the joint run
    validates the all-task set at every point and tests every task after
    iteration 1 and once more at the end."""
    n, points = STRATEGY_ITERS, val_points(STRATEGY_ITERS, STRATEGY_VAL)
    launches = dict(full=0, banded=0, fused=0, train_fwd=0, train_bwd_tail=0, train_bwd_head=0)
    if il.startswith("joint"):
        list_batches = -(-tasks * CAMPAIGN_TEST // BATCH)
        launches.update(full=6 * n, banded=6 * n,
                        fused=12 * (points * list_batches + (points - 1 + 2) * tasks * ff_batches))
        return launches
    for t in range(tasks):
        forwards = n + (STRATEGY_FISHER if il == "ewc" else 0)
        launches["full"] += 6 * forwards
        launches["banded"] += 6 * forwards
        nets = t + 1 if il == "der" else 1
        launches["fused"] += 12 * nets * ff_batches * (points + 2 * (t + 1))
        if t and il in ("lwf", "wa"):
            launches["fused"] += 12 * n
        if il == "der":
            launches["fused"] += 12 * t * n
    return launches


def _param_diff(got, ref):
    """The largest |difference| of two flax trees, as a share of the
    largest |value| of its leaf."""
    worst = 0.0
    for (k, a), (_, b) in zip(_leaves(got), _leaves(ref)):
        scale = max(float(np.abs(b).max(initial=0.0)), 1e-12)
        worst = max(worst, float(np.abs(a - b).max(initial=0.0)) / scale)
    return worst


def _instrument(learner, checks):
    """Wraps the learner's hooks to record what (a) and (b) read: every
    batch it encodes, task 0's draws and trained model, each WA align,
    each EWC Fisher and DER's frozen extractors around each loop."""
    batches = []
    encode, build, after = learner._encode_batch, learner.build_model, learner.after_task

    def recorded_encode(images, labels):
        batches.append(np.asarray(images).copy())
        return encode(images, labels)

    def recorded_build():
        build()
        checks["draws"] = to_flax(learner.model)

    def recorded_after():
        if learner._cur_task == 0:
            checks["task0"] = to_flax(learner.model)
        after()

    learner._encode_batch, learner.build_model = recorded_encode, recorded_build
    learner.after_task = recorded_after
    if hasattr(learner, "_align"):
        align = learner._align

        def checked_align():
            gamma = align()
            kernel = learner.model.fc.kernel.detach().float()
            norms = kernel.norm(dim=0)
            cut = learner._known_classes
            new, old = float(norms[cut:].mean()), float(norms[:cut].mean())
            checks.setdefault("align", []).append((gamma, abs(new - old) / old))
            return gamma

        learner._align = checked_align
    if hasattr(learner, "get_fisher_diagonal"):
        update = learner._update_fisher

        def checked_update(loader):
            update(loader)
            checks.setdefault("fisher", []).append(
                (max(float(f.max()) for f in learner.fisher.values()),
                 all(bool(torch.isfinite(f).all()) for f in learner.fisher.values())))

        learner._update_fisher = checked_update
    if hasattr(learner, "n_experts"):
        run_loop = learner._run_loop

        def checked_loop(*args, **kwargs):
            frozen = [{k: v.detach().clone() for k, v in e.state_dict().items()}
                      for e in learner.model.extractors[:-1]]
            run_loop(*args, **kwargs)
            same = all(torch.equal(v, e.state_dict()[k])
                       for e, state in zip(learner.model.extractors, frozen)
                       for k, v in state.items())
            checks.setdefault("frozen", []).append((len(frozen), same))

        learner._run_loop = checked_loop
    return batches


def _strategy_step_pair(learner, batch, variants, tol, what):
    """One training step of ``learner`` from the same weights, batch and
    DropPath masks under each of two ``variants`` ((label, plain, fused)):
    loss, global grad norm and the fc grad within ``tol`` (as
    ``_step_pair``)."""
    start = copy.deepcopy(learner.model.state_dict())
    gen_state = learner.generator.get_state()
    captured = {}

    def keep_fc_grad(grads):
        captured["fc"] = grads["fc.kernel"].detach().clone()
        return grads

    learner.grad_transform = lambda: keep_fc_grad
    results = []
    for _, plain, fused in variants:
        learner.model.load_state_dict(start)
        learner.generator.set_state(gen_state)
        for model in (learner.model, learner._old_model):
            if model is not None:
                configure_blocks(model, plain=plain)
        learner.build_optimizer()
        with fused_train_env(fused):
            metrics = learner.train_step(batch)
        results.append((float(metrics["loss"]), float(metrics["grad_norm"]), captured["fc"]))
    for model in (learner.model, learner._old_model):
        if model is not None:
            configure_blocks(model, plain=False)
    (lk, gk, fk), (lp, gp, fp) = results
    loss_rtol, norm_rtol, fc_share = tol
    largest = float(fp.abs().max())
    dfc = float((fk - fp).abs().max())
    print(f"  (c) bf16 step, {what}: loss {lk:.7f} vs {lp:.7f} "
          f"(rel {abs(lk - lp) / abs(lp):.2e}, tol {loss_rtol:g}), grad_norm {gk:.6f} vs "
          f"{gp:.6f} (rel {abs(gk - gp) / gp:.2e}, tol {norm_rtol:g}), fc grad max |diff| "
          f"{dfc:.3e} of max |grad| {largest:.3e} (tol {fc_share:g} of it)")
    if abs(lk - lp) > loss_rtol * abs(lp) or abs(gk - gp) > norm_rtol * gp \
            or dfc > fc_share * largest:
        raise RuntimeError(f"(c) the {what} training steps disagree")


def _learner_at(out, source, device, il, task):
    """A fresh ``il`` learner grown to ``task`` (random weights, every
    earlier task ended with ``after_task``) and a batch of that task's
    stream."""
    opt = _strategy_opt(out, source, device, il)
    learner = campaign.build_learner(opt)
    for t in range(task + 1):
        learner._cur_task, learner.character = t, list(source.cumulative_character(t))
        learner.converter = learner.build_converter()
        if t == 0:
            learner.build_model()
        else:
            learner.change_model()
        if t < task:
            learner.after_task()
    manager = DatasetManager(opt, dataset_factory=source.train_factory)
    manager.init_start(opt, opt.select_data, None, task)
    return learner, manager.get_batch()


def phase_strategies(out_dir, device, source):
    """The other strategies through the campaign's entry points (cuts in
    STRATEGY_*), counting the launches of rows 1, 2 and 4; checks (a)-(c),
    prints (d) (see the module doc).  Returns the launches summed over the
    strategies."""
    total = dict(full=0, banded=0, fused=0, train_fwd=0, train_bwd_tail=0, train_bwd_head=0)
    ff_batches = -(-CAMPAIGN_TEST // BATCH)
    task0, loss_rtol = {}, TRAIN_STEP_TOL["bf16"][2]
    for il in STRATEGY_ILS:
        opt = _strategy_opt(os.path.join(out_dir, "strategies"), source, device, il)
        learner = campaign.build_learner(opt)
        checks = {}
        batches = _instrument(learner, checks)
        manager = DatasetManager(opt, dataset_factory=source.train_factory)
        run = campaign.run_joint if il.startswith("joint") else campaign.run_incremental
        with fused_train_env(False):
            reset_launches()
            t0 = time.perf_counter()
            _, aia, matrix, seconds = run(opt, source, learner=learner, manager=manager)
            wall = time.perf_counter() - t0
            launches = read_launches()
        expected = strategy_launches(il, STRATEGY_TASKS, ff_batches)
        print(f"  {il}: {wall:.1f} s, stage seconds {seconds}, AIA {aia}, matrix {matrix}; "
              f"launches {launches} (expected {expected})")
        if launches != expected:
            raise RuntimeError(f"{il}: the run did not go through the kernels as expected")
        for k in total:
            total[k] += launches[k]
        # ---- (a) the stream
        del learner._encode_batch   # the window below records nothing
        again = _strategy_stream(opt, source)
        if len(batches) != len(again) or any(a.tobytes() != b.tobytes()
                                             for a, b in zip(batches, again)):
            raise RuntimeError(f"(a) {il}: the batches differ from the rebuilt stream")
        halves = [lo.batch_size for lo in manager.loaders]
        print(f"  (a) {il}: {len(batches)} batches equal the rebuilt stream's bitwise "
              f"(loaders of {halves} at the end)")
        # ---- (b) invariants
        later = [r for r in learner.history if r["task"] > 0]
        if il in ("lwf", "wa"):
            kd = [r["kd"] for r in later]
            if not kd or not all(np.isfinite(kd)) or min(kd) <= 0:
                raise RuntimeError(f"(b) {il}: KD terms {kd[:4]}...")
            print(f"  (b) {il}: KD from task 1 in [{min(kd):.4f}, {max(kd):.4f}]")
        if il == "wa":
            aligns = checks.get("align", [])
            print(f"  (b) wa: {len(aligns)} aligns, gamma and |new - old| / old mean norm "
                  f"{[(round(g, 5), f'{d:.1e}') for g, d in aligns]}")
            if len(aligns) != 2 * (STRATEGY_TASKS - 1) or max(d for _, d in aligns) > 1e-5:
                raise RuntimeError("(b) wa: an align left the norms apart")
        if il == "ewc":
            fisher, penalty = checks.get("fisher", []), [r["ewc"] for r in later]
            print(f"  (b) ewc: Fisher max per task {[f'{m:.2e}' for m, _ in fisher]}; penalty "
                  f"in [{min(penalty):.3e}, {max(penalty):.3e}]")
            if len(fisher) != STRATEGY_TASKS or any(m > 1e-4 or not ok for m, ok in fisher) \
                    or not all(np.isfinite(penalty)):
                raise RuntimeError("(b) ewc: the Fisher or the penalty is out of its bounds")
        if il == "der":
            frozen = checks.get("frozen", [])
            print(f"  (b) der: frozen extractors per task and unchanged: {frozen}")
            if [n for n, _ in frozen] != list(range(STRATEGY_TASKS)) \
                    or not all(same for _, same in frozen):
                raise RuntimeError("(b) der: a frozen extractor moved")
        if il in ("base", "lwf", "wa", "ewc"):
            task0[il] = (checks["draws"], checks["task0"])
        # ---- (d) a step window on the last task's stream; the step is built
        # again, as a loop would build it, on what after_task left
        learner._train_step = None
        with fused_train_env(False):
            windows = [_step0_window(learner, manager, True) for _ in range(2)]
        print(f"  (d) {il}: bf16 step over {TIME_STEPS} steps after {TIME_WARMUP} on task "
              f"{len(opt.lan_list) - 1 if not il.startswith('joint') else 0}'s stream: "
              f"{', '.join(f'{1e3 * w:.2f}' for w in windows)} ms; stage seconds {seconds}")
        del learner, manager
    # ---- (b) the shared task 0
    ref_draws, ref_model = task0["base"]
    for il in ("lwf", "wa", "ewc"):
        draws, model = task0[il]
        if _param_diff(draws[0], ref_draws[0]) != 0.0:
            raise RuntimeError(f"(b) {il}'s task-0 draws differ from base's")
        diff = max(_param_diff(model[0], ref_model[0]), _param_diff(model[1], ref_model[1]))
        print(f"  (b) task 0 of {il} against base: the same draws; trained model "
              f"{'bitwise equal' if diff == 0.0 else f'max |diff| {diff:.2e} of its leaf'}")
        if diff > loss_rtol:
            raise RuntimeError(f"(b) {il}'s task-0 model differs from base's")
    # ---- (c) kernels against plain versions on the new paths
    out = os.path.join(out_dir, "strategies_c")
    variants = (("kernels", False, False), ("plain", True, False))
    learner, batch = _learner_at(out, source, device, "lwf", 1)
    _strategy_step_pair(learner, batch, variants, TRAIN_STEP_TOL["bf16"],
                        "LwF task 1, composed (row 4 old network, rows 1-2)")
    learner, batch = _learner_at(out, source, device, "der", 2)
    _strategy_step_pair(learner, batch, variants, TRAIN_STEP_TOL["bf16"],
                        "DER task 2, composed (row 4 frozen extractors, rows 1-2)")
    _strategy_step_pair(learner, batch, (("kernels", False, True), ("plain", True, True)),
                        FUSED_STEP_TOL["bf16"],
                        "DER task 2, MRN_FUSED_TRAIN=1 (row 4, rows 5-7)")
    return total


def int8_block(rng, c, heads, mixer, hw, x32, device, dt):
    """A random Block (JAX init distributions, non-trivial LN affine)
    calibrated on float32 ``x32`` with ``quant="calib"`` and quantized
    (``ops.int8.quantize_variables``), as the JAX package's int8 Block test
    does; on ``device`` in ``dt``."""
    params = random_block(rng, c)
    for key in ("norm1_scale", "norm1_bias", "norm2_scale", "norm2_bias"):
        params[key] = params[key] + 0.1 * rng.standard_normal(c).astype(np.float32)
    kw = dict(col_major=mixer == "Local")
    calib = Block(c, heads, mixer, hw, quant="calib", **kw)
    calib.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()}, strict=True)
    with torch.inference_mode():
        calib.to(device).eval()(x32)
    qv = int8.quantize_variables({"params": params, "quant": quant_tree(calib)})
    blk = Block(c, heads, mixer, hw, quant="int8", **kw)
    blk.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in
                         {**qv["params"], **qv["quant"]}.items()}, strict=True)
    return blk.to(device=device, dtype=dt).eval()


def library_block_int8(x, blk):
    """Yardstick: the w8a8 Block from library calls in x's dtype --
    ``torch._int_mm`` (cuBLASLt int8, B column-major as its int8 path takes
    it) for the four projections with the activation quantization and
    dequant as PyTorch ops, ``F.layer_norm``, SDPA held to its fused
    backends (flash, or memory-efficient with the full mask in x's dtype),
    exact GELU.  Timed only.  Returns a function of no arguments."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, n, c = x.shape
    heads = blk.num_heads
    w = blk.int8_weights
    kernels = [k.t().contiguous().t() for k in w.kernels]
    mask = None if blk.mask is None else blk.mask.to(x.dtype)

    def proj(i, h):
        hq = torch.clamp(torch.round(h.float() * w.inv[i]), -127, 127).to(torch.int8)
        acc = torch._int_mm(hq.view(b * n, -1), kernels[i])
        return (acc.float() * w.deqs[i] + w.biases[i]).view(b, n, -1)

    def run():
        h = F.layer_norm(x, (c,), blk.norm1_scale, blk.norm1_bias, 1e-6)
        qkv = proj(0, h).to(x.dtype).view(b, n, 3, heads, c // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=blk.scale)
        x1 = x.float() + proj(1, o.transpose(1, 2).reshape(b, n, c))
        h = F.layer_norm(x1, (c,), blk.norm2_scale.float(), blk.norm2_bias.float(), 1e-6)
        return (x1 + proj(3, F.gelu(proj(2, h)))).to(x.dtype)
    return run


def profile_int8_yardstick(runs):
    """Where the ``torch._int_mm`` yardstick's time goes: ``torch.profiler``
    over one call of each of ``runs`` (one expert's Block shapes, bf16,
    float attention), the device time per kernel summed over them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in runs:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in runs:
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  torch._int_mm yardstick, one call per Block shape, bf16: device busy {busy:.3f} ms;"
          f" top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms:8.3f} ms {ms / max(busy, 1e-9):6.1%} x{e.count:<4d} {e.key[:100]}")


INT8_LAUNCHES = ("qkv", "attention", "proj", "fc1", "fc2")


def profile_launches(fn, launches):
    """The last ``launches`` device kernels of three calls of ``fn`` traced
    by ``torch.profiler`` (after a warm-up call), in launch order, as (name
    without template arguments, device ms).  A trace can miss kernels (its
    first call's, or all of them), so a short one is taken again, up to
    three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(3):
                fn()
                torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)[-launches:]
        if len(kernels) == launches:
            break
    return [(e.name.replace("(anonymous namespace)::", "").split("<")[0].split("(")[0],
             e.time_range.elapsed_us() / 1e3) for e in kernels]


def print_int8_launches(fn):
    """One line: each launch of one w8a8 Block call with its device time."""
    launches = profile_launches(fn, len(INT8_LAUNCHES))
    labels = INT8_LAUNCHES if len(launches) == len(INT8_LAUNCHES) else [""] * len(launches)
    print("    launches (device ms): " + ", ".join(
        f"{label} {name} {ms:.4f}" for label, (name, ms) in zip(labels, launches))
          + f"; sum {sum(ms for _, ms in launches):.4f}")


def int8_block_bound_ms(b, n, c, heads, hidden, dt, pairs, attn_int8, width):
    """(bytes_ms, ops_ms) of the least time of one w8a8 Block call on an
    H100: x in and out in dt, the int8 kernels, the float32 LN, bias and
    dequant rows and the [n, width] mask the kernel reads (the full mask, or
    a Local Block's band mask), each once, over HBM bandwidth; the four
    projections at the int8 tensor peak plus QK^T and PV over the visible
    (query, key) pairs at x's type's peak (or int8's with ``attn_int8``)."""
    isz = torch.tensor([], dtype=dt).element_size()
    m = b * n
    nbytes = (2 * m * c * isz + c * (4 * c + 2 * hidden) + 4 * (4 * c + 2 * (5 * c + hidden))
              + 4 * 8 + (0 if pairs == n * n else 4 * n * width))
    attn_ops = 2 * 2 * b * heads * pairs * (c // heads)
    ops_ms = 1e3 * (2 * m * c * (4 * c + 2 * hidden) / PEAK_INT8_OPS
                    + attn_ops / (PEAK_INT8_OPS if attn_int8 else PEAK_FLOPS[dt]))
    return 1e3 * nbytes / HBM_BYTES_PER_S, ops_ms


def flip_share(got, ref, dt):
    """(share of elements beyond the float noise INT8_NOISE, max |got -
    ref|, max |ref|)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    atol, rtol = INT8_NOISE[dt]
    return (float((err > atol + rtol * ref.abs()).float().mean()), float(err.max()),
            float(ref.abs().max()))


def float_products_q8(h, inv):
    """Control for the int8 checks: activations scaled into the int8 range
    but not rounded, so the plain version's products run on float values."""
    return torch.clamp(h * inv, -127.0, 127.0)


def check_int8(what, got, ref, control, dt):
    """The INT8_NOISE / INT8_FLIP_SHARE / INT8_FLIP_MAX check of the kernel's
    output ``got`` against the plain ``ref``; the ``control`` output must
    fail it.  Returns max |got - ref|."""
    share, mx, top = flip_share(got, ref, dt)
    c_share, c_mx, _ = flip_share(control, ref, dt)
    ok = bool(torch.isfinite(got).all()) and share <= INT8_FLIP_SHARE \
        and mx <= INT8_FLIP_MAX * top
    control_fails = c_share > INT8_FLIP_SHARE or c_mx > INT8_FLIP_MAX * top
    print(f"  {what}: max_abs_err {mx:.3e} ({mx / top:.2e} of max |ref| {top:.3g}, tol "
          f"{INT8_FLIP_MAX:g}), {share:.3%} beyond float noise (tol {INT8_FLIP_SHARE:.0%}) "
          f"{'ok' if ok else 'FAILED'}; control (float products) {c_share:.2%} beyond, max "
          f"{c_mx:.2e}: {'fails, as it must' if control_fails else 'PASSES'}")
    if not ok:
        raise RuntimeError(f"{what}: kernel disagrees with its plain version")
    if not control_fails:
        raise RuntimeError(f"{what}: the float-products control passes the int8 check")
    return mx


def phase_int8_blocks(device, rng):
    """The w8a8 Block kernel vs its plain version at the four Block shapes,
    f32 and bf16, float and int8 attention, with the float-products control;
    profiles the library yardstick once; returns sums over one expert's 12
    Blocks per (dtype, attn_int8)."""
    totals, yardsticks = {}, []
    print_ptxas("svtr_block_int8")
    for dt in (torch.float32, torch.bfloat16):
        for attn_int8 in (False, True):
            tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                       ops_ms=0.0, max_abs_err=0.0)
            for name, hw, c, heads, mixer, count in BLOCK_SHAPES:
                n = hw[0] * hw[1]
                x32 = torch.from_numpy(rng.standard_normal((BATCH, n, c)).astype(np.float32)
                                       ).to(device)
                blk = int8_block(rng, c, heads, mixer, hw, x32, device, dt)
                blk.attn_int8 = attn_int8
                x = x32.to(dt)
                with torch.inference_mode():
                    out_k = blk(x)
                    again = blk(x)
                    torch.cuda.synchronize()
                    if not torch.equal(out_k, again):
                        raise RuntimeError(f"int8 {name}: two kernel launches differ")
                    ms = cuda_ms(lambda: blk(x), 5)
                    print_int8_launches(lambda: blk(x))
                    blk.plain = True
                    out_p = blk(x)
                    plain_ms = cuda_ms(lambda: blk(x), 3)
                    with mock.patch.object(svtr_block, "_q8", float_products_q8):
                        out_c = blk(x)
                    blk.plain = False
                    yardstick = library_block_int8(x, blk)
                    lib_ms = cuda_ms(yardstick, 5)
                    if dt == torch.bfloat16 and not attn_int8:
                        yardsticks.append(yardstick)
                pairs = n * n if blk.mask is None else int((blk.mask == 0).sum())
                plan = svtr_block._Plan(n, blk.mask, blk.band, device)
                bytes_ms, ops_ms = int8_block_bound_ms(BATCH, n, c, heads, 4 * c, dt, pairs,
                                                       attn_int8, plan.width)
                bound = max(bytes_ms, ops_ms)
                err = check_int8(f"int8 {name} {str(dt)[6:]} attn_int8={attn_int8} "
                                 f"[{BATCH},{n},{c}] qb {plan.qb} width {plan.width}",
                                 out_k, out_p, out_c, dt)
                print(f"    ms {ms:.3f}  plain_ms {plain_ms:.3f}  library_ms {lib_ms:.3f}  "
                      f"bound_ms {bound:.4f} ({'operations' if ops_ms >= bytes_ms else 'bytes'}, "
                      f"{bound / ms:.1%} of bound); two launches bitwise equal; "
                      + _block_plan_text(svtr_block._int8_kernel_plan(
                          dt, attn_int8, n, c, heads, 4 * c, plan.qb, plan.width)))
                for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                                 ("bound_ms", bound), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                    tot[key] += count * val
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
            print(f"  int8 Blocks, one expert's 12, {str(dt)[6:]} attn_int8={attn_int8}, batch "
                  f"{BATCH}: " + ", ".join(f"{k} {v:.4g}" for k, v in tot.items()))
            totals[(dt, attn_int8)] = tot
    with torch.inference_mode():
        profile_int8_yardstick(yardsticks)
    return totals


def phase_int8_serve(rng, base):
    """This slice's path: ``evaluate_cli --int8 --taski 0`` on one
    full-width SVTR recognizer (task 0, CLASS_COUNTS[0] classes): the float
    server's score envelope, calibration on INT8_CALIB_BATCHES synthetic
    batches, quantization, INT8_REQUESTS requests per dtype counted, then
    the same batch on the plain versions, and agreement with the float
    server."""
    alphabet = _task_alphabets()[0]
    params, stats = random_recognizer(rng, base, CLASS_COUNTS[0])
    t0 = time.perf_counter()
    loader = SyntheticTaskLoader([alphabet], 0, BATCH, BATCH * INT8_CALIB_BATCHES,
                                 img_h=base.imgH, img_w=base.imgW, seed=SEED)
    calib = [loader.bank[loader.get_batch()[0]] for _ in range(INT8_CALIB_BATCHES)]
    images = loader.bank[loader.get_batch()[0]]
    print(f"  rendered {len(loader.labels)} crops in {time.perf_counter() - t0:.1f} s")
    floats, servers = {}, {}
    for dtype in INT8_REQUESTS:
        opt = base.replace(compute_dtype=dtype)
        floats[dtype] = Server(opt, params, stats, alphabet)
        svtr_attention.launches.update(full=0, banded=0)
        t0 = time.perf_counter()
        servers[dtype] = quantize_int8(Server(opt, params, stats, alphabet), iter(calib),
                                       n_batches=INT8_CALIB_BATCHES)
        torch.cuda.synchronize()
        n_blocks = sum(isinstance(m, Block) for m in servers[dtype].model.modules())
        print(f"  {dtype}: calibrated on {INT8_CALIB_BATCHES} batches of {BATCH} and quantized "
              f"in {time.perf_counter() - t0:.2f} s ({svtr_attention.launches['full']} full "
              f"attention launches, expected {n_blocks * INT8_CALIB_BATCHES})")
        if svtr_attention.launches["full"] != n_blocks * INT8_CALIB_BATCHES:
            raise RuntimeError("calibration did not run the composed Blocks' attention kernel")
    floats["float32"].check_score_envelope(images)

    # ---- counted run: the main path, through the entry points
    svtr_block.int8_launches = 0
    svtr_block.launches = 0
    svtr_attention.launches.update(full=0, banded=0)
    results = {}
    for dtype, n_req in INT8_REQUESTS.items():
        ts = []
        for _ in range(n_req):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[dtype] = servers[dtype].recognize(images)
            ts.append(time.perf_counter() - t0)
            if len(results[dtype]) != BATCH or not all(np.isfinite(c) for _, c in results[dtype]):
                raise RuntimeError("int8 recognize returned a malformed batch")
        print(f"  int8 {dtype}: request seconds {[round(t, 4) for t in ts]}, crops/s "
              f"{[round(BATCH / t, 1) for t in ts]} (first request includes warm-up)")
    launches = svtr_block.int8_launches
    expected = n_blocks * sum(INT8_REQUESTS.values())
    print(f"  int8 Block launches in the served requests: {launches} (expected {expected} = "
          f"{sum(INT8_REQUESTS.values())} requests x {n_blocks} Blocks)")
    if launches != expected or svtr_block.launches or any(svtr_attention.launches.values()):
        raise RuntimeError("the int8 served path did not run through the int8 kernel as expected")

    # ---- the same batch on the plain versions, and against the float server
    failed = []
    for dtype, srv in servers.items():
        dt = getattr(torch, dtype)
        served = []
        hooks = [m.register_forward_hook(lambda m, a, o: served.append((m, a[0], o)))
                 for m in srv.model.modules() if isinstance(m, Block)]
        out_k = srv.forward(images)["logits"].float()
        for h in hooks:
            h.remove()
        with torch.inference_mode():
            for i, (blk, x, out) in enumerate(served):
                blk.plain = True
                ref = blk(x)
                with mock.patch.object(svtr_block, "_q8", float_products_q8):
                    control = blk(x)
                blk.plain = False
                check_int8(f"int8 {dtype} served Block {i} [{','.join(map(str, x.shape))}]",
                           out, ref, control, dt)
        configure_blocks(srv.model, plain=True)
        out_p = srv.forward(images)["logits"].float()
        with mock.patch.object(svtr_block, "_q8", float_products_q8):
            out_c = srv.forward(images)["logits"].float()
        configure_blocks(srv.model, plain=False)
        out_f = floats[dtype].forward(images)["logits"].float()
        shape = (BATCH, base.imgW // 4, CLASS_COUNTS[0])
        if tuple(out_k.shape) != shape or not bool(torch.isfinite(out_k).all()):
            raise RuntimeError(f"int8 logits {tuple(out_k.shape)} != {shape} or not finite")
        share, delta, _ = flip_share(out_k, out_p, dt)
        c_share, c_delta, _ = flip_share(out_c, out_p, dt)
        mean, c_mean = float((out_k - out_p).abs().mean()), float((out_c - out_p).abs().mean())
        top2 = out_p.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > INT8_TIE[dtype]
        agree = out_k.argmax(-1) == out_p.argmax(-1)
        ok = mean <= INT8_LOGIT_MEAN_SHARE * c_mean and bool(agree[decided].all())
        print(f"  int8 {dtype} logits, kernel vs plain: mean |diff| {mean:.3e}, "
              f"{mean / c_mean:.3f} of the float-products control's {c_mean:.3e} (tol "
              f"{INT8_LOGIT_MEAN_SHARE:g}); {share:.2%} beyond float noise (control {c_share:.2%}), "
              f"max |diff| {delta:.3e} (control {c_delta:.3e}, int8 vs float {dtype} "
              f"{float((out_p - out_f).abs().max()):.3e}); greedy picks agree on "
              f"{int(agree.sum())}/{agree.numel()} steps, all {int(decided.sum())} with a top-2 "
              f"margin above {INT8_TIE[dtype]:g} "
              f"{'agree' if bool(agree[decided].all()) else 'DISAGREE'} {'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(dtype)
        words = [w for w, _ in results[dtype]]
        float_words = [w for w, _ in floats[dtype].recognize(images)]
        ned = float(np.mean([metrics.ned_score(w, f) for w, f in zip(words, float_words)]))
        print(f"  int8 {dtype} vs float {dtype} on the same weights (random: information, not "
              f"accuracy): word agreement {metrics.word_accuracy(words, float_words):.2f}%, "
              f"mean NED {ned:.4f}")
    if failed:
        raise RuntimeError(f"int8 {failed}: served logits disagree with the plain path")
    return launches


def cuda_ms_queued(fn, reps):
    """Mean device time of one call of a short kernel: the calls are queued
    behind a ~50 ms device spin, so the device runs them back to back and
    the time is not the host's per-call overhead, which for a kernel of
    tens of microseconds would be as long as the kernel."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def calibrate_random_trba(model, images, text):
    """Random TRBA weights in the JAX init distributions hardly tell crops
    apart: each U(+-1/sqrt(fan_in)) conv shrinks its input's second moment
    about threefold and BatchNorm's initial statistics (0, 1) do not undo
    it, so after the localization net's 4 and the ResNet's 29 convs every
    crop's features are about the biases', every crop takes one expert and
    one word.  On one batch, in place: every BatchNorm's running mean and
    variance become its input's batch statistics (flax's arithmetic; what a
    trained model's running statistics estimate), and for an MRNNet each
    expert's ``channel_route`` bias moves so that all experts have the same
    mean route score over the batch, so that the per-crop part of the
    scores picks the expert.  Returns the model."""
    def set_stats(bn, args):
        x = args[0].float()
        mean = x.mean(dim=(0, 2, 3))
        bn.mean.copy_(mean)
        bn.var.copy_(torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0))

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
             if isinstance(m, BatchNorm)]
    scores = []
    if hasattr(model, "route"):
        hooks.append(model.route.register_forward_hook(
            lambda m, args, out: scores.append(out[..., 0].float())))
    try:
        with torch.no_grad():
            model(images, text)
    finally:
        for h in hooks:
            h.remove()
    if scores:
        mean = scores[0].mean(dim=0)                       # [I]
        bias = model.channel_route.bias
        with torch.no_grad():
            bias -= ((mean - mean.mean()) / model.route.kernel.float().sum()).to(bias.dtype)
    return model


def check_greedy(what, got, ref, counts, atol, rtol):
    """Greedy Attn logits [B, S, C] against the reference path's.  Each
    step feeds its pick back, so a pick may differ only where the
    reference's top-2 margin over the crop's ``counts`` admissible classes
    is within twice the tolerance (a near-tie), and the crop's later steps
    are then not compared.  Every other step's logits must agree.  Returns
    (max_abs_err over the compared steps, a [B] mask of the crops whose pick
    flipped at a near-tie)."""
    got, ref = got.float(), ref.float()
    steps = ref.shape[1]
    col = torch.arange(ref.shape[-1], device=ref.device)
    outside = col[None, None, :] >= counts[:, None, None]
    masked = ref.masked_fill(outside, float("-inf"))
    top2 = masked.topk(2, dim=-1)
    # argmax on both sides: the first of equal maxima, as the decoder picks
    # (topk's index among exact bf16 ties is not the first)
    flip = got.masked_fill(outside, float("-inf")).argmax(-1) != masked.argmax(-1)
    first = torch.where(flip.any(1), flip.float().argmax(1), torch.full_like(counts, steps))
    step = torch.arange(steps, device=ref.device)[None, :]
    upto = step <= first[:, None]                      # a flip step's logits precede it
    margin = top2.values[..., 0] - top2.values[..., 1]
    tie = margin <= 2 * (atol + rtol * top2.values[..., 0].abs())
    flipped = first < steps
    at_tie = tie.gather(1, first.clamp(max=steps - 1)[:, None])[:, 0]
    err = (got - ref).abs()
    ok = (bool(torch.isfinite(got).all()) and bool((err <= atol + rtol * ref.abs())[upto].all())
          and bool(at_tie[flipped].all()))
    mx = float(err[upto].max())
    print(f"  {what}: max_abs_err {mx:.3e} over {int(upto.sum())} of {upto.numel()} decode "
          f"steps (tol atol {atol:g} + rtol {rtol:g}*|ref|); {int(flipped.sum())} crops' picks "
          f"flipped, {int((flipped & at_tie).sum())} of them at a near-tie "
          f"({int(tie.any(1).sum())} crops have a near-tie) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError(f"{what}: served logits disagree with the reference path")
    return mx, flipped


def print_device_profile(label, prof, wall):
    """Device-busy time of a ``torch.profiler`` trace against the host
    clock ``wall`` (s), and the kernels with the most device time."""
    from torch.autograd import DeviceType

    # device-side events only (the operators' own rows repeat their kernels' time)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0:
        print(f"  {label}: the profiler recorded no device time ({1e3 * wall:.1f} ms traced)")
        return None
    print(f"  {label}: device busy {busy:.1f} ms of {1e3 * wall:.1f} ms traced "
          f"({1 - busy / (1e3 * wall):.1%} idle); top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms:8.2f} ms {ms / busy:6.1%} x{e.count:<4d} {e.key[:90]}")
    return 1 - busy / (1e3 * wall)


def _trba_trees(rng, base, images, class_counts=None):
    """Random full-width TRBA trees in the JAX init distributions: an MRN
    ensemble over ``class_counts``, else one recognizer of
    ``CLASS_COUNTS[0]`` classes; ``localization_fc2`` perturbed
    (TRBA_FC2_SCALE) and the model calibrated on ``images`` in float32
    (``calibrate_random_trba``).  Returns (params, batch_stats, characters)."""
    n_classes = max(class_counts or CLASS_COUNTS[:1])
    chars = [chr(0x4E00 + i) for i in range(n_classes - 5)]   # 5 Attn specials
    if class_counts:
        params, stats = random_mrn(rng, base, class_counts)
        expert = params["experts"]
    else:
        params, stats = random_recognizer(rng, base, n_classes)
        expert = params
    fc2 = expert["extractor"]["transformation"]["localization"]["localization_fc2"]
    fc2["kernel"] = (TRBA_FC2_SCALE * rng.standard_normal(fc2["kernel"].shape)).astype(np.float32)
    calib = Server(base.replace(compute_dtype="float32"), params, stats, chars,
                   class_counts=class_counts)
    calibrate_random_trba(calib.model, calib.images(images),
                          torch.full((len(images), 1), calib.converter.sos_id,
                                     device=calib.device))
    params, stats = to_flax(calib.model)
    return params, stats, chars


def phase_trba_serve(rng):
    """This slice's path: TRBA serving at full width of
    ``configs/trba_mrn.py``, the 6-expert TRBA-MRN ensemble in bf16 and f32
    and one TRBA recognizer (no ``experts``) in bf16.  Returns the warp
    launches of the counted requests, the request times, the served batch's
    TPS grids (expert 0, per dtype) and the batch on the card."""
    t0 = time.perf_counter()
    base = load_config(os.path.join(ROOT, "configs", "trba_mrn.py"))
    images = rng.integers(0, 256, (BATCH, base.imgH, base.imgW, base.input_channel),
                          dtype=np.uint8)
    params, stats, chars = _trba_trees(rng, base, images, CLASS_COUNTS)
    servers = {dtype: Server(base.replace(compute_dtype=dtype), params, stats, chars,
                             class_counts=CLASS_COUNTS) for dtype in TRBA_REQUESTS}
    params, stats, chars = _trba_trees(rng, base, images)
    single = Server(base.replace(compute_dtype="bfloat16"), params, stats, chars)
    torch.cuda.synchronize()
    print(f"  weights drawn, calibrated on the batch and loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- counted run: the main path, through the entry points
    grid_sample.launches = 0
    timings, results = {}, {}
    for dtype, n_req in TRBA_REQUESTS.items():
        timings[dtype] = []
        for _ in range(n_req):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[dtype] = servers[dtype].recognize(images)
            timings[dtype].append(time.perf_counter() - t0)
            if len(results[dtype]) != BATCH or not all(np.isfinite(c)
                                                       for _, c in results[dtype]):
                raise RuntimeError("TRBA recognize returned a malformed batch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single_result = single.recognize(images)
    single_s = time.perf_counter() - t0
    if len(single_result) != BATCH or not all(np.isfinite(c) for _, c in single_result):
        raise RuntimeError("single TRBA recognize returned a malformed batch")
    launches = grid_sample.launches
    expected = sum(TRBA_REQUESTS.values()) * N_EXPERTS + 1
    print(f"  TPS warp launches in the served requests: {launches} (expected {expected} = "
          f"{sum(TRBA_REQUESTS.values())} ensemble requests x {N_EXPERTS} experts + 1 "
          f"single-recognizer request)")
    if launches != expected:
        raise RuntimeError("the TRBA served path did not run through the warp kernel as expected")
    for dtype, ts in timings.items():
        print(f"  {dtype}: request seconds {[round(t, 4) for t in ts]}, crops/s "
              f"{[round(BATCH / t, 1) for t in ts]} (first request includes warm-up)")
        print(f"  {dtype}: sample words {[w for w, _ in results[dtype][:3]]}, "
              f"{len(set(w for w, _ in results[dtype]))} distinct words in {BATCH}")
    print(f"  one TRBA recognizer, bfloat16: first request {single_s:.4f} s "
          f"({BATCH / single_s:.1f} crops/s), {len(set(w for w, _ in single_result))} "
          f"distinct words in {BATCH}")
    with torch.inference_mode():
        out_k = single.forward(images)["logits"]
        with mock.patch.object(tps, "grid_sample", grid_sample.grid_sample_reference):
            out_p = single.forward(images)["logits"]
    check_greedy("one TRBA recognizer, bfloat16 logits, kernel vs plain warp", out_k, out_p,
                 torch.full((BATCH,), out_p.shape[-1], device=out_p.device),
                 *TRBA_LOGIT_TOL[torch.bfloat16])

    # ---- the same batch with the warp forced through its plain version
    grids = {}
    for dtype, srv in servers.items():
        atol, rtol = TRBA_LOGIT_TOL[srv.dtype]
        scores = []
        hook = srv.model.route.register_forward_hook(
            lambda mod, inp, out: scores.append(out[..., 0].float()))
        out_k = srv.forward(images)
        words_k = [w for w, _ in srv.recognize(images)]
        with mock.patch.object(tps, "grid_sample", grid_sample.grid_sample_reference):
            out_p = srv.forward(images)
            words_p = [w for w, _ in srv.recognize(images)]
        hook.remove()
        shape = (BATCH, base.batch_max_length + 1, max(CLASS_COUNTS))
        if tuple(out_k["logits"].shape) != shape:
            raise RuntimeError(f"logits shape {tuple(out_k['logits'].shape)} != {shape}")
        check_close(f"TRBA {dtype} route scores", scores[0], scores[2], atol, rtol)
        delta = float((scores[0] - scores[2]).abs().max())
        top2 = scores[2].topk(2, dim=1).values
        near_tie = (top2[:, 0] - top2[:, 1]) <= 2 * delta
        agree = out_k["index"] == out_p["index"]
        print(f"  TRBA {dtype}: expert picks agree on {int(agree.sum())}/{BATCH} samples, "
              f"{int(near_tie.sum())} near-ties (picks per expert "
              f"{torch.bincount(out_k['index'], minlength=N_EXPERTS).tolist()})")
        if bool((~agree & ~near_tie).any()):
            raise RuntimeError("TRBA expert picks disagree between the kernel and plain "
                               "warps beyond score near-ties")
        counts = torch.tensor(CLASS_COUNTS, device=out_p["index"].device)[out_p["index"]]
        _, flipped = check_greedy(f"TRBA {dtype} served logits (samples with the same pick)",
                                  out_k["logits"][agree], out_p["logits"][agree],
                                  counts[agree], atol, rtol)
        flips = int(flipped.sum())
        same = [words_k[i] == words_p[i] for i in range(BATCH) if bool(agree[i])]
        print(f"  TRBA {dtype}: words agree on {sum(same)}/{len(same)} samples with the same "
              f"pick ({flips} with a pick flipped at a decode near-tie)")
        if len(same) - sum(same) > flips:
            raise RuntimeError("TRBA words disagree beyond decode near-ties")
        with torch.inference_mode():
            grids[srv.dtype] = srv.model.experts[0].extractor.transformation.grid(
                srv.images(images))

    # ---- where a request's time goes
    from torch.profiler import ProfilerActivity, profile

    for dtype, srv in servers.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            srv.recognize(images)
            wall = time.perf_counter() - t0
        print_device_profile(f"TRBA {dtype}, one request", prof, wall)
        print(f"    peak device memory of the request {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB (weights of both servers included)")
    return launches, timings, grids, torch.from_numpy(images).cuda()


def grid_sample_bound_ms(image, grid):
    """The two halves of the least time (ms) of one warp on an H100: the
    image and the grid read once and the output written once, over HBM
    bandwidth; the kernel's float32 operations (16 per output pixel for the
    coordinates and weights, 9 per output value for the two interpolations)
    at the float32 peak."""
    isz = image.element_size()
    pixels = grid.numel() // 2
    values = pixels * image.shape[-1]
    nbytes = image.numel() * isz + grid.numel() * 4 + values * isz
    ops = 16 * pixels + 9 * values
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_FLOPS[torch.float32]


def phase_grid_sample(device, rng, tps_grids, images):
    """The TPS warp kernel vs its plain version at the TRBA shape (batch 256,
    32x256x4 -> 32x256) on random grids in [-1.3, 1.3], the identity grid and
    the served batch's TPS grids, float32 and bfloat16 images (the served
    crops, normalised), float32 grids; timed beside the plain version,
    ``F.grid_sample`` on NCHW (timed only) and the bound."""
    b, h, w, _ = images.shape
    ys, xs = torch.linspace(-1, 1, h, device=device), torch.linspace(-1, 1, w, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grids = {"random": torch.from_numpy(rng.uniform(-1.3, 1.3, (b, h, w, 2))
                                        .astype(np.float32)).to(device),
             "identity": torch.stack([gx, gy], -1).expand(b, h, w, 2).contiguous()}
    totals = {}
    for dt in (torch.float32, torch.bfloat16):
        img = ((images.float() / 255.0 - 0.5) / 0.5).to(dt)
        nchw = img.permute(0, 3, 1, 2).contiguous()
        for name, grid in (*grids.items(), ("tps", tps_grids[dt])):
            grid = grid.contiguous()
            with torch.inference_mode():
                out_k = grid_sample.grid_sample(img, grid)
                torch.cuda.synchronize()
                out_p = grid_sample.grid_sample_reference(img, grid)
                g_lib = grid.to(dt)  # F.grid_sample takes the grid in the image's dtype
                lib = lambda: F.grid_sample(nchw, g_lib, mode="bilinear",  # noqa: E731
                                            padding_mode="border", align_corners=True)
                lib_err = float((lib().permute(0, 2, 3, 1).float() - out_p.float()).abs().max())
                ms = cuda_ms_queued(lambda: grid_sample.grid_sample(img, grid), 50)
                plain_ms = cuda_ms_queued(lambda: grid_sample.grid_sample_reference(img, grid), 10)
                lib_ms = cuda_ms_queued(lib, 50)
            bytes_ms, ops_ms = grid_sample_bound_ms(img, grid)
            bound = max(bytes_ms, ops_ms)
            atol, rtol = GRID_SAMPLE_TOL[dt]
            err = check_close(f"warp {name} grid {str(dt)[6:]} [{b},{h},{w},4]", out_k, out_p,
                              atol, rtol)
            print(f"    ms {ms:.5f}  plain_ms {plain_ms:.5f}  library_ms {lib_ms:.5f}  "
                  f"bound_ms {bound:.5f} ({'operations' if ops_ms >= bytes_ms else 'bytes'})  "
                  f"({bound / ms:.1%} of bound); F.grid_sample vs plain max |diff| {lib_err:.3e}")
            totals[(name, dt)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                      bound_ms=bound, bytes_ms=bytes_ms, ops_ms=ops_ms,
                                      max_abs_err=err)
    return totals


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED)
    print("== environment")
    smi = phase_environment()
    print("== build")
    phase_build()
    print("== kernel vs plain, SVTR Block shapes")
    totals = phase_blocks(device, rng)
    print("== SVTR-MRN serving, 6 experts, full width")
    served, _ = phase_serve(rng)
    print("== attention kernels vs plain, SVTR training shapes")
    attn = phase_attention(device, rng)
    # best checkpoints and expert blobs of the training phases, removed at the end
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=os.path.join(ROOT, "build"))
    try:
        base = load_config(os.path.join(ROOT, "configs", "svtr_mrn.py"), output_dir=out_dir,
                           data_log=os.path.join(out_dir, "data_any.txt"))
        alphabets, loader, valid = _train_setup(base)
        character = "".join(alphabets)
        print("== SVTR-MRN training, full width, composed Blocks")
        trained, learners = phase_train(rng, base, character, loader, valid)
        print("== fused training Block kernels vs plain, SVTR Block shapes")
        train_blocks = phase_train_blocks(device, rng)
        print("== SVTR-MRN training, full width, MRN_FUSED_TRAIN=1")
        fused_trained, fused_learners = phase_train_fused(rng, base, character, loader, valid)
        print("== profile of one bf16 training step of each kind")
        phase_profile((("composed step 1", learners["bf16"], False),
                       ("composed step 0", learners["bf16"], False),
                       ("fused step 0", fused_learners["bf16"], True)), loader)
        del learners, fused_learners
        print("== SVTR-MRN checkpoints, validation and test, full width")
        ckpt = phase_checkpoints(base, alphabets, loader)
        del loader
        print("== SVTR-MRN 6-task campaign, full width, bf16")
        source = campaign_source()
        camp, _ = phase_campaign(out_dir, device, source)
        print("== the other strategies, 3 tasks, full width, bf16")
        strat = phase_strategies(out_dir, device, source)
        del source
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print("== w8a8 Block kernel vs plain, SVTR Block shapes")
    int8_totals = phase_int8_blocks(device, rng)
    print("== int8 serving, one SVTR recognizer (task 0), full width")
    int8_served = phase_int8_serve(rng, base)
    print("== TRBA-MRN serving, 6 experts, full width")
    trba_served, _, tps_grids, trba_images = phase_trba_serve(rng)
    print("== TPS warp kernel vs plain, TRBA shape")
    warp = phase_grid_sample(device, rng, tps_grids, trba_images)
    print(f"== done in {time.perf_counter() - t_start:.1f} s")
    bf16 = torch.bfloat16
    rows = [("svtr_fused_block", "svtr_block.cu", "mrn_tpu/ops/svtr_block.py:166",
             served + trained["fused"] + fused_trained["fused"] + ckpt["fused"] + camp["fused"]
             + strat["fused"], totals[bf16]),
            ("svtr_attention_full", "svtr_attention.cu", "mrn_tpu/ops/svtr_attention.py:87",
             trained["full"] + ckpt["full"] + camp["full"] + strat["full"],
             attn[("full", bf16)]),
            ("svtr_attention_banded", "svtr_attention.cu", "mrn_tpu/ops/svtr_attention.py:157",
             trained["banded"] + ckpt["banded"] + camp["banded"] + strat["banded"],
             attn[("banded", bf16)]),
            ("svtr_train_block_forward", "svtr_train_block.cu",
             "mrn_tpu/ops/svtr_train_block.py:124", fused_trained["train_fwd"],
             train_blocks[("fwd", bf16)]),
            ("svtr_train_block_bwd_tail", "svtr_train_block.cu",
             "mrn_tpu/ops/svtr_train_block.py:436", fused_trained["train_bwd_tail"],
             train_blocks[("tail", bf16)]),
            ("svtr_train_block_bwd_head", "svtr_train_block.cu",
             "mrn_tpu/ops/svtr_train_block.py:497", fused_trained["train_bwd_head"],
             train_blocks[("head", bf16)]),
            ("svtr_fused_block_int8", "svtr_block_int8.cu", "mrn_tpu/ops/svtr_block.py:303",
             int8_served, int8_totals[(bf16, False)]),
            ("grid_sample", "grid_sample.cu", "mrn_tpu/ops/grid_sample.py:140", trba_served,
             warp[("tps", bf16)])]
    record = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"mrn_tpu_torch/ops/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": tot["max_abs_err"],
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
        "library_ms": tot["library_ms"],
    } for name, source, replaces, launches, tot in rows]}
    print(f"kernel record: bfloat16 at batch {BATCH}; svtr_fused_block times are one "
          f"expert's 12 Blocks, its launches the served requests ({served}) plus the "
          f"router steps and validations of the training runs ({trained['fused']} composed, "
          f"{fused_trained['fused']} fused), of the checkpoint phase with its test "
          f"({ckpt['fused']}), of the campaign ({camp['fused']}) and of the strategies "
          f"({strat['fused']}); attention times are one "
          f"expert forward's 6 Blocks of each kind, their launches the composed step-0 steps "
          f"of the training, checkpoint, campaign and strategies phases; "
          f"svtr_train_block times are one expert's 12 Blocks, the tail's library_ms "
          f"autograd's backward of the library Block's proj + LayerNorm + MLP sub-graph, "
          f"the head's of its LayerNorm + qkv product; svtr_fused_block_int8 times are one recognizer's 12 "
          f"Blocks with float attention, its launches the int8 served requests, its "
          f"library_ms the torch._int_mm Block; grid_sample times are one warp of the "
          f"served batch's TPS grid (bf16 image, f32 grid), its launches the TRBA served "
          f"requests, its library_ms F.grid_sample on NCHW; on {smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
