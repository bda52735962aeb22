#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (H100):

    python3 chip_smoke.py

1. prints the toolchain and the card (``nvidia-smi`` name and power limit);
2. builds the CUDA kernels from ``mrn_tpu_torch/ops/csrc`` (one ``nvcc``
   per source): the TPS warp's source first, then every other source at
   once in a background thread (``_build.BackgroundBuild``), behind phases
   12, 12b and 14-17, which launch only the warp kernel and so run first
   (see "Run order" below);
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
   the AIA and seconds per stage and (e) one step-0 window mean with and
   one without the prefetcher and a traced window's idle share;
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
   over one window after 3 warm-up steps, its stage seconds and launches;
9e. runs the slice's entry points on an LMDB tree it writes under
   ``build/`` (see ``LMDB_*``: 3 tasks of the campaign's alphabets, 1,024
   train and 256 test crops a task at natural sizes, PNG-encoded without
   PIL): ``train_cli.main`` over the LMDB stream and again with
   ``--device_bank``, ``evaluate_cli.main`` on the final checkpoint and
   with ``--int8`` on task 0's, ``recognize_cli.main`` on a folder of 256
   PNG crops, each called in this process so that every launch is counted
   (the train runs against their expected counts); checks (a) the C++ image
   codec against the committed PIL fixtures bitwise, (b) the LMDB stream's
   batches against the device bank run's bitwise, (c) evaluate_cli's
   scores against train_cli's last ``test()``, (d) the int8 run's row-3
   launches, each served int8 Block against its plain version (beside the
   float-products control) and the logits against the float32 recognizer
   as close as the plain int8 path's (``INT8_VS_FLOAT_*``), (e) recognize_cli's
   words against the eval path's on the same crops; prints the host decode
   rate (PNG and JPEG), the step-0 windows of the LMDB stream and of the
   bank, the LMDB window's idle share and the CLIs' crops/s;
9e''. the dataset tools and the image forms a scene tree brings, on that
   phase's final checkpoint (``FORMS_*``): (a) the g++ build of the codec
   on every file of ``tests/fixtures/torch_forms/`` against the committed
   digests of Pillow's ``convert("RGBA")`` and cv2's ``imdecode``
   (``IMREAD_COLOR`` / ``IMREAD_UNCHANGED``) views, bitwise; (b) ``python
   -m mrn_tpu_torch.tools.crop_by_word`` on the fixtures' scene tree
   against the JAX tool's committed crop names, ``label.txt`` bytes and
   crops; (c) ``create_lmdb.create_dataset`` over those crops and over the
   fixtures' word crops in every new form, keeping what JAX's tool keeps
   (the committed ``jax:kept`` where it is not every crop); (d) ``evaluate_cli.main`` on
   that tree and ``recognize_cli.main`` on the folder of word crops, their
   row-4 launches against the expected counts; then (a)-(d) again on
   ``tests/fixtures/torch_webp/`` (WebP scenes under ``.jpg`` / ``.png``
   names, WebP word crops: lossy, lossless, alpha, animated, two named
   ``.jpg``) and on ``tests/fixtures/torch_tiff/`` (TIFF and BigTIFF
   scenes under ``.jpg`` / ``.png`` names, a 1728-pixel G4 fax page among
   them, a word crop in every TIFF form the codec decodes, two named
   ``.jpg``), rows 4 and 1 counted; prints the one-thread decode + resize
   crops/s of each form Pillow reads, the ms of each view of the fax page
   and the phase's seconds;
9e'. training-time augmentation on that tree (``AUG_*``): (a) the C++
   augment library (``data/csrc/augment.cpp``, built here with g++) on the
   committed fixtures of Pillow's, OpenCV's and the JAX package's outputs
   (``tests/fixtures/torch_augment/``, ``data.augment_fixtures``), bitwise
   or within the stated bounds; the host's augment + resize crops/s on one
   thread per chain beside plain decode + resize; ``train_cli.main`` with
   ``Aug=ABINet`` over the first 2 tasks and ``Aug=Blur5-Crop90-Rot15``
   over task 0, bf16, ``AUG_ITERS`` step-0 iterations a task: (b) the
   launches of rows 1, 2 and 4 against the unaugmented run's count for
   those cuts, (c) the first batch's labels equal to the unaugmented
   stream's and its crops not; the ABINet stream's step-0 window and the
   idle share of a traced window;
9f. trains data- and expert-parallel through ``train_cli`` on that tree
   (see ``PAR_*``: 2 tasks, float32, batch 256, ``--device_bank``): once
   without a process group, then (a) under torchrun's environment in a
   1-rank NCCL world in this process (``--data_parallel 1``: every
   collective runs), compared bitwise with the run without a group and
   beside a second run without a group (the card's own run-to-run
   spread), its NCCL all-reduce shown by a profile of one more step; (b)
   ``torchrun --nproc_per_node 2`` of this script's ``--parallel-rank``
   mode, gloo with both ranks on cuda:0, ``--data_parallel 2`` and
   ``--expert_parallel 2`` at once, each rank's gradient norms step by step and
   leaf by leaf, step losses, experts, router (leaf by leaf), scores and
   validation losses against the run without a group; (c) every run's and rank's launches of rows 1, 2 and 4 against
   their expected counts (an expert rank holds half the experts); (d) the
   step-0 and router step windows of each with the gradient buckets'
   bytes (four ranks on one card share it: no scaling figure);
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
12b. trains ``configs/trba_mrn.py`` at full width, bf16, batch 256, on
   task 2 of 3 (2 frozen random TRBA experts and the new one, crops and
   labels of the campaign suite's first three alphabets) through
   ``MRN.incremental_train``: 6 step-0 steps (train-mode TPS with the
   differentiable warp, teacher-forced decoder) and 3 step-1 steps (the
   router over the experts, teacher-forced, in eval mode), each validated
   on one batch, counting the warp kernel's launches (none in a step-0
   step, one per expert in a step-1 step, 1 per FF and 3 per TF batch);
   checks (a) one step-1 step with the kernel warp against the plain warp
   (loss, grad norm, ``channel_route`` grad; ``TRBA_STEP_TOL``), (b) FF and
   TF validation logits kernel against plain up to each crop's first
   near-tie flip, (c) a finite, non-zero TPS grid gradient in step 0, the
   new expert's localization statistics moved and the frozen experts
   bitwise unchanged in step 1, (d) one WA step at task 1 whose
   teacher-forced old network launches the warp once, kernel against plain
   as (a); prints step-0 and step-1 ``StepMeter`` windows after 3 warm-up
   steps and the idle share of a traced step-0 window;
13. holds the TPS warp kernel against its plain version at batch 256,
   32x256x4 -> 32x256, on random grids in [-1.3, 1.3], the identity grid
   and the served batch's TPS grids, float32 and bfloat16 images (float32
   grids), timed beside the plain version, ``F.grid_sample`` on NCHW
   (timed only) and the bound;
14. serves ``configs/crnn_mrn.py`` at full width (VGG at 512 channels, two
   BiLSTMs of 256, CTC) as a 6-expert CRNN-MRN ensemble over the SVTR
   phase's class counts (random weights, BatchNorm statistics and route
   biases set on the batch): requests of 256 crops in bfloat16 and float32
   through ``serve.Server``, launching none of the port's kernels, then
   the first crops against the same ensemble on the CPU in float32 (route
   scores, picks outside near-ties, logits; ``CRNN_LOGIT_TOL``);
15. trains task 5 of 6 of ``configs/crnn_mrn.py`` at full width through
   ``MRN.incremental_train`` in bf16 and f32 (5 frozen random CRNN
   experts and the new one; 4 step-0 and 2 step-1 steps, validated on one
   batch), checks that step 1 left the experts' statistics bitwise
   (pinned), prints step-0 and step-1 ``StepMeter`` windows after warm-up
   steps and a traced bf16 step-0 window's idle share, then one router
   step with ``mrn_pin_expert_stats=False`` over the f32 run's 6 experts,
   whose running statistics must all move;
16. ``configs/grcnn_mrn.py`` at full width: a bf16 step-0 window of a new
   GRCNN expert and requests of one GRCNN recognizer;
17. the int8 conv path: one CRNN, one TRBA and one GRCNN recognizer at full
   width quantized by ``serve.quantize_int8`` (as ``evaluate_cli --int8``),
   every conv geometry of VGG, ResNet and RCNN at batch 256 through
   ``torch._int_mm`` held bitwise against the exact float64 conv and timed
   beside it; requests of the float and the int8 CRNN and TRBA servers in
   float32 and bfloat16, counting ``_int_mm`` convs (7 and 32 a request)
   and TPS warp launches (1 a TRBA request); the served int8 logits
   against the same servers on the plain convs beside the float-products
   control, which must fail (``check_int8``);
18. the tanh-GELU serving mode (``models.svtr.set_gelu_approximate(True)``,
   the JAX package's switch): the 6-expert SVTR-MRN servers of phase 4 and
   one int8 SVTR recognizer calibrated with the switch on, served with it
   on (counted: 12 tanh-form launches of row 4 per expert and request, 12
   of row 3 per int8 request); every served Block against its plain version
   on its own input (row 4 at ``BLOCK_TOL``, row 3 beside its control), the
   routed outputs against the plain path, the greedy picks against the
   degree-9 form's on the same batch; then rows 4 and 3 in the tanh form
   at the four Block shapes, f32 and bf16, against their plain versions,
   timed beside the degree-9 form, the plain version, the library Block
   with ``F.gelu(approximate="tanh")`` and the bound;
19. the host cost of a custom op's dispatch (``torch.ops.mrn_tpu_torch.*``
   against its CUDA implementation called directly);
20. ``export_cli``'s path: the 6-expert SVTR-MRN, the int8 SVTR recognizer
   of phase 11, the TRBA recognizer of phase 12 and one CRNN recognizer,
   bf16, each exported at batch 256 (``export_cli.export_inference``),
   saved and loaded (``torch.export``) and served, counting the kernels'
   launches (the export's one eager call and the requests); each loaded
   program's logits equal the eager server's bitwise; prints the export,
   save and load seconds, the ``.pt2`` bytes and the first and warm request
   seconds;
21. stage combinations the composer builds (``COMBO_*``), each run counted
   against its predicted launches: (a) TPS/SVTR/BiLSTM/Attn at
   ``configs/svtr_mrn.py``'s width (SVTR-MRN's backbone inside TRBA's
   stages) as a 6-expert ensemble served in bf16 (72 row-4 and 6 row-8
   launches a request), the routed output against the plain versions
   (route scores, picks, greedy logits) and its score envelope; task 1 of
   2 through ``MRN.incremental_train``, router, composed and
   ``MRN_FUSED_TRAIN=1`` step windows, and one f32 step-0 step of each
   route on the kernels against the plain versions, the TPS
   localization's gradient among what is held (it comes back through
   every SVTR Block); one int8 recognizer served and its Blocks held
   against the plain version beside the control; (b) None/VGG/None/Attn
   at ``configs/crnn_mrn.py``'s widths as a 6-expert ensemble in bf16
   against float32 on the CPU, and a step-0 window; (c) all 32
   combinations narrow (``COMBO_SWEEP``, batch ``COMBO_SWEEP_BATCH``): an
   f32 eval forward on the kernels against the plain versions and one
   bf16 step with a finite loss and finite gradients.

Run order: 1, 2 (the warp's source, the rest started), 12, 12b, 14, 15,
16, 17 (their weights and crops from ``EARLY_SEED``'s generator), the
build joined, 13, 3-11, 18-21.  Traces record the card's activity only
(``device_trace``).

Any failed check raises (exit code != 0).  The line before the last is the
per-kernel JSON record, the last line ``{"ok": true, "device": {...}}``.
Exits non-zero without printing a result when no CUDA card is present.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import hashlib
import itertools
import json
import os
import random
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import types
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from mrn_tpu_torch import campaign  # noqa: E402
from mrn_tpu_torch.bridge import quant_tree, state_to_flax, to_flax  # noqa: E402
from mrn_tpu_torch.codec import build_converter  # noqa: E402
from mrn_tpu_torch.config import load_config  # noqa: E402
from mrn_tpu_torch import evaluate_cli, export_cli, recognize_cli, train_cli  # noqa: E402
from mrn_tpu_torch.data import augment_fixtures  # noqa: E402
from mrn_tpu_torch.data import image as image_codec  # noqa: E402
from mrn_tpu_torch.data.lmdb_store import LmdbReader  # noqa: E402
from mrn_tpu_torch.data.manager import DatasetManager, ValDataset  # noqa: E402
from mrn_tpu_torch.data.transform import MoCoAugment, build_transform  # noqa: E402
from mrn_tpu_torch.tools import create_lmdb  # noqa: E402
from mrn_tpu_torch.data.prefetch import Prefetcher  # noqa: E402
from mrn_tpu_torch.data.synthetic import (SyntheticTaskLoader, alphabet_of_size,  # noqa: E402
                                          synthetic_val_set)
from mrn_tpu_torch.models.init import (random_block, random_mrn,  # noqa: E402
                                       random_recognizer, random_router)
from mrn_tpu_torch.models import tps  # noqa: E402
from mrn_tpu_torch.models.common import BatchNorm, TorchConv  # noqa: E402
from mrn_tpu_torch.models.svtr import (Block, configure_blocks,  # noqa: E402
                                       local_attention_mask_col_major, set_gelu_approximate)
from mrn_tpu_torch.ops import _build, int8, metrics, svtr_attention, svtr_block  # noqa: E402
from mrn_tpu_torch.ops import grid_sample, svtr_train_block  # noqa: E402
from mrn_tpu_torch.ops.ctc import ctc_loss_per_sample  # noqa: E402
from mrn_tpu_torch.ops.svtr_block import GELU_TANH  # noqa: E402
from mrn_tpu_torch.serve import Server, quantize_int8  # noqa: E402
from mrn_tpu_torch.train import checkpoint  # noqa: E402
from mrn_tpu_torch.train.learners import mrn as mrn_learner  # noqa: E402
from mrn_tpu_torch.train.learners.base import BaseLearner  # noqa: E402
from mrn_tpu_torch.train.learners.mrn import MRN, tree_hash  # noqa: E402
from mrn_tpu_torch.train.learners.wa import WA  # noqa: E402
from mrn_tpu_torch.utils import StepMeter  # noqa: E402

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
# The LMDB phase's (d) serves a trained checkpoint (task 0 after 20 steps),
# whose activations carry the cascade much further: on an H100 its logits
# read kernel vs plain 0.835 of the control's mean |c - p| with every
# served Block within INT8_FLIP_SHARE, so the logits
# are held instead to the float32 recognizer they approximate: the
# kernel's mean |k - f| at most INT8_VS_FLOAT_RATIO times the plain
# version's mean |p - f|, and its greedy picks agreeing with the float
# model's on no fewer steps than the plain version's less
# INT8_VS_FLOAT_PICKS of them.  A kernel that broke the rounding, the
# scales or a Block would leave the float model far further than the
# plain int8 path does.
INT8_VS_FLOAT_RATIO = 1.25
INT8_VS_FLOAT_PICKS = 0.01
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

# TRBA-MRN training (configs/trba_mrn.py at full width, bf16, batch 256):
# task TRBA_TRAIN_TASK of 3 (2 frozen random experts and the new one), the
# class counts of the campaign suite's first three alphabets (1895, 325 and
# 1620 characters), CROPS_PER_TASK crops a task; num_iter TRBA_TRAIN_ITERS
# with val_interval TRBA_VAL_INTERVAL: 6 step-0 steps validated (FF, one
# batch) at 1, 3 and 6, and 3 step-1 steps validated (TF) at each; then
# StepMeter windows of TRBA_WINDOW steps after TRBA_WARMUP warm-up steps
TRBA_TRAIN_TASK = 2
TRBA_TRAIN_ITERS = 6
TRBA_VAL_INTERVAL = 3
TRBA_WARMUP, TRBA_WINDOW = 3, 5
# a training step with the TPS warp on the kernel against the same step with
# the warp forced through its plain version, bf16: (loss rtol, grad-norm
# rtol, gradient atol as a share of the leaf's largest |grad|).  The two
# warps agree to one bf16 ulp of a warped pixel (GRID_SAMPLE_TOL); a pixel
# rounded one ulp apart feeds the ResNet's 29 bf16 convs and BatchNorms,
# whose roundings then flip in turn, so the loss and the grads agree to a few
# ulps of the bf16 activations (TRAIN_STEP_TOL's reasoning), not to float32
# noise.  Step 1's experts and WA's old network warp on the kernel; the live
# model of a step 0 warps with the training warp on both sides.
TRBA_STEP_TOL = TRAIN_STEP_TOL["bf16"]

# The 6-task campaign phase: mrn_tpu_torch.campaign's run_incremental at
# full width, bf16, batch 256, prefetch on, seed 111, cut against the
# protocol of ACCURACY_RUNS/t6/svtr_mrn.json: the train instance counts / 8
# (336..5926 for 2687..47411), CAMPAIGN_TEST test crops a task (for
# 529..11073), memory_num CAMPAIGN_MEMORY (for 2000; under the smallest cut
# task, 404) and num_iter CAMPAIGN_ITERS with val_interval CAMPAIGN_VAL (for
# 1000 and 500): 10 step-0 steps a task validated at 1, 5 and 10, and 5
# step-1 steps validated at each.
CAMPAIGN_CUT = 8
CAMPAIGN_TEST = 256
CAMPAIGN_MEMORY = 256
CAMPAIGN_ITERS = 10
CAMPAIGN_VAL = 5
CAMPAIGN_SEED = 111
# (c): the crash comes after routed step 3 of task 5; its last snapshot is
# step 3's (one at every validation point before the last)
CAMPAIGN_CRASH = 3
# (e): a step-0 window of TIME_STEPS steps after TIME_WARMUP, no validation
# in it, with the prefetcher and without; TRACE_STEPS of them traced
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

# The LMDB entry-points phase: an LMDB tree written here (the campaign's
# first LMDB_TASKS alphabets, LMDB_TRAIN train and LMDB_TEST test crops a
# task, rendered at natural sizes of LMDB_HEIGHTS x LMDB_WIDTHS pixels and
# PNG-encoded, words of 1 to LMDB_MAX_LEN characters), then
# train_cli / evaluate_cli / recognize_cli on configs/svtr_mrn.py at full
# width, bf16, batch 256, num_iter CAMPAIGN_ITERS, val_interval CAMPAIGN_VAL,
# memory_num CAMPAIGN_MEMORY; host decode rates over LMDB_DECODE_CALLS calls.
LMDB_TASKS = 3
LMDB_TRAIN = 1024
LMDB_TEST = 256
LMDB_HEIGHTS = (24, 48)
LMDB_WIDTHS = (48, 320)
LMDB_MAX_LEN = 8
LMDB_DECODE_CALLS = 1024
# the forms phase: the committed fixtures of tests/fixtures/torch_forms/,
# each word crop's form decoded and resized to 32x256 FORMS_DECODE_REPEAT
# times on one thread for its rate; evaluate_cli (FORMS_SETS sets) and
# recognize_cli run every expert's 12 Blocks on each batch (one a set at
# the config's batch of 256).
# The same checks run on tests/fixtures/torch_webp/ and torch_tiff/ (WebP
# and TIFF scenes and word crops, some under .jpg / .png names).
FORMS_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_forms")
WEBP_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_webp")
TIFF_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_tiff")
FORMS_TREES = (("forms", FORMS_DIR), ("webp", WEBP_DIR), ("tiff", TIFF_DIR))
FORMS_DECODE_REPEAT = 50
# the TIFF tree's G4 fax page (1728 x 1100), each view timed FORMS_PAGE_REPEAT times
FORMS_PAGE, FORMS_PAGE_REPEAT = "t6_g4_page.png", 10
FORMS_SETS = 3
# the augmentation phase: train_cli with Aug over the LMDB phase's tree, cut
# to AUG_ITERS step-0 iterations a task (validated every AUG_VAL); host
# rates over AUG_RATE_CROPS of its PNG crops; the ABINet stream's window of
# AUG_WINDOW steps after AUG_WARMUP and a traced one of AUG_TRACE (the
# host-bound steps take ≈ 0.7 s: the phase stays within a minute)
AUG_ITERS, AUG_VAL = 4, 2
AUG_RATE_CROPS = 128
AUG_WARMUP, AUG_WINDOW, AUG_TRACE = 2, 6, 3
AUG_CHAINS = (("abinet", "ABINet", 2), ("text", "Blur5-Crop90-Rot15", 1))

# The parallel-training phase: train_cli --device_bank on the LMDB phase's
# tree, its first PAR_TASKS tasks, configs/svtr_mrn.py at full width,
# float32 (TF32 off), global batch 256, PAR_ITERS step-0 steps a task
# validated at 1 and PAR_ITERS, PAR_ITERS // 2 router steps validated at
# each; once without a process group, then (a) in a 1-rank NCCL world in
# this process, then (b) in 2-rank gloo worlds with both ranks on cuda:0
# (torchrun, --data_parallel 2 and --expert_parallel 2).  A world sums in
# another order, and so does a second run on the card (F.ctc_loss's CUDA
# backward adds atomically), and Adam turns the noise of a gradient whose
# exact value is 0 (biases before BatchNorm, the patch embedding's weights
# on the crops' constant alpha channel, the route bias) into steps of up to
# its learning rate: parameters are held within two learning rates a step
# (PAR_ADAM_NOISE) with at most PAR_STRAY of their elements outside
# tests/test_torch_parallel.py's PAR_RTOL / PAR_ATOL (tests/test_torch_
# parallel.py's JAX_STRAY) in every leaf, validation and step losses at
# PAR_LOSS_RTOL (the torchrun train_cli test's), scores equal.  Adam hides
# the scale of a gradient, so the gradient each optimizer step sees (after
# the world's all-reduce) is held too: leaf by leaf and step by step, its
# norm within PAR_GRAD_RTOL of the run without a group's, measured against
# that norm plus PAR_GRAD_FLOOR of the step's largest leaf norm (a leaf
# below the floor carries the float noise of an exact-0 gradient).  A
# second run without a group gives the card's own spread (6.1e-5 and
# 1.14e-4 in two runs on an H100 80GB HBM3 at 700 W), which must stay
# PAR_GRAD_MARGIN times under the bound for the bound to tell a fault (a
# sum for a mean reads 1.0) from noise.
PAR_TASKS = 2
PAR_ITERS = 4
PAR_RTOL, PAR_ATOL = 5e-5, 1e-6
PAR_ADAM_NOISE = 2 * (2 * PAR_ITERS + PAR_ITERS // 2) * 5e-4
PAR_LOSS_RTOL = 1e-3
PAR_STRAY = 1e-3
PAR_GRAD_RTOL, PAR_GRAD_FLOOR, PAR_GRAD_MARGIN = 1e-2, 1e-4, 4
# the running means of the BatchNorms after a conv bias whose exact
# gradient is 0 (tests/test_torch_parallel.py's ZERO_GRAD)
PAR_ZERO_GRAD = ("patch_embed.bn1.mean", "patch_embed.bn2.mean")
PAR_TIMEOUT = 300
PAR_DEVICE = "cuda:0"   # every run's --device (the 1-rank world's backend follows it)


# CRNN (configs/crnn_mrn.py) and GRCNN (configs/grcnn_mrn.py) at full
# width (VGG / RCNN at 512 channels, two BiLSTMs of 256, CTC), batch 256,
# random weights whose BatchNorm statistics (and an ensemble's route
# biases) are set on the served batch (calibrate_random_trba): a 6-expert
# CRNN-MRN ensemble over CLASS_COUNTS served CRNN_REQUESTS times per dtype;
# its first CRNN_REF_CROPS crops against the same ensemble on the CPU in
# float32: route scores and the logits of crops with the same pick within
# CRNN_LOGIT_TOL (float32: both float32, TF32 off, other conv algorithms
# and summation orders; bfloat16 against float32: bf16 rounding through 7
# convs, 126 BiLSTM steps and the router), picks equal outside near-ties.
CRNN_REQUESTS = {"bfloat16": 3, "float32": 2}
CRNN_REF_CROPS = 8
CRNN_LOGIT_TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (2.5e-1, 1e-1)}
# task TRAIN_TASK of 6 through MRN.incremental_train, bf16 and f32:
# CRNN_TRAIN_ITERS step-0 steps validated (FF, one batch) at 1, 2 and 4,
# 2 step-1 steps validated (TF) at each; then step windows of TIME_STEPS
# after TIME_WARMUP (GRCNN: GRCNN_WINDOW)
CRNN_TRAIN_ITERS, CRNN_VAL_INTERVAL = 4, 2
GRCNN_WINDOW = 5
# the int8 conv path: INT8_CONV_REQUESTS requests per dtype of one CRNN and
# one TRBA recognizer (CLASS_COUNTS[0] classes), float and int8
INT8_CONV_REQUESTS = 3
# The tanh-GELU serving mode (models.svtr.set_gelu_approximate(True)) and
# the export phase draw from their own generator, so the earlier phases
# see the draws they always saw.  Requests of the 6-expert SVTR-MRN per
# dtype and of one int8 SVTR recognizer (bf16) with the switch on, and of
# each exported program.
TANH_SEED = SEED + 16
TANH_REQUESTS = {"bfloat16": 2, "float32": 1}
TANH_INT8_REQUESTS = 2
EXPORT_REQUESTS = 3
# Stage combinations (models/composer.py builds every one of {None, TPS} x
# {VGG, ResNet, RCNN, SVTR} x {None, BiLSTM} x {CTC, Attn}), from a
# generator of their own: TPS/SVTR/BiLSTM/Attn at SVTR-MRN's full width
# (configs/svtr_mrn.py, its stage fields overridden) as a 6-expert
# ensemble served COMBO_REQUESTS times in bf16 (6 x 12 row-4 and 6 row-8
# launches a request), task 1 of 2 through MRN.incremental_train
# (COMBO_TRAIN_ITERS step-0 steps validated at 1 and the last, half as
# many router steps validated at each), step windows of COMBO_WINDOW after
# COMBO_WARMUP (router, composed, MRN_FUSED_TRAIN=1) and one int8
# recognizer served COMBO_INT8_REQUESTS times; None/VGG/None/Attn at
# CRNN-MRN's widths (configs/crnn_mrn.py) served COMBO_REQUESTS times and
# a step-0 window; every combination at COMBO_SWEEP widths (SVTR at its
# embed widths, depth 2/4/2: 6 Local and 2 Global Blocks) and batch
# COMBO_SWEEP_BATCH.
COMBO_SEED = SEED + 17
COMBO_REQUESTS = 3
COMBO_INT8_REQUESTS = 2
COMBO_TRAIN_ITERS, COMBO_VAL_INTERVAL = 4, 4
COMBO_WARMUP, COMBO_WINDOW = 3, 3
COMBO_SWEEP = dict(output_channel=64, hidden_size=32, svtr=dict(depth=(2, 4, 2)))
COMBO_SWEEP_BATCH = 8
# One f32 step-0 step of TPS/SVTR/BiLSTM/Attn on the kernels against the
# plain versions (composed and fused): the loss and the grad norm at
# TRAIN_STEP_TOL's f32 values; the TPS localization_fc2 gradient, which
# comes back through 12 Blocks, the warp's grid gradient (a difference of
# neighbouring pixels at each tap) and the localization net's 4 train-mode
# BatchNorms, whose cancelling moments leave it float32 summation noise of
# ~1e-4 of its largest value, which does not repeat (the training warp's
# image gradient is an atomic scatter_add): two runs on an H100 80GB HBM3
# read 6.1e-5 and 4.0e-5 composed, 1.2e-4 and 1.7e-4 fused; 1e-3 of it
COMBO_STEP_TOL = (1e-4, 1e-4, 1e-3)
# host cost of a custom op's dispatch: calls of the op and of its CUDA
# implementation directly, on a tiny input (host-bound), in turns
DISPATCH_CALLS = 2000
# The TRBA, CRNN, GRCNN and int8-conv phases and the TPS warp kernel's
# phase launch only EARLY_KERNEL's library: all but the last run while
# nvcc builds the other sources, and all draw from a generator of their own.
EARLY_KERNEL = "grid_sample"
EARLY_SEED = SEED + 18


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


def library_block(x, p, mask, heads, scale, approximate="none"):
    """Yardstick: the same Block composed from library calls (LayerNorm,
    cuBLAS matmuls, SDPA, exact GELU, or its tanh form with ``approximate=
    "tanh"``) in x's dtype.  Timed only."""
    b, n, c = x.shape
    d = c // heads
    h = F.layer_norm(x, (c,), p["norm1_scale"], p["norm1_bias"], 1e-6)
    qkv = (h @ p["qkv_kernel"] + p["qkv_bias"]).view(b, n, 3, heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    x = x + o.transpose(1, 2).reshape(b, n, c) @ p["proj_kernel"] + p["proj_bias"]
    h = F.layer_norm(x, (c,), p["norm2_scale"], p["norm2_bias"], 1e-6)
    h = F.gelu(h @ p["fc1_kernel"] + p["fc1_bias"], approximate=approximate)
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
    """Builds the TPS warp's source, then starts every other source's build
    behind it (``_build.BackgroundBuild``); returns the build in flight."""
    t0 = time.perf_counter()
    _build.load(EARLY_KERNEL)
    print(f"built ['{EARLY_KERNEL}'] in {time.perf_counter() - t0:.1f} s; the other sources "
          "build behind the TRBA, CRNN, GRCNN and int8-conv phases, which launch only "
          "that kernel")
    return _build.BackgroundBuild(), t0


def join_build(build, t0):
    libs = build.wait()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s (from the start of the "
          "build)")
    for name in libs:
        print_ptxas(name)


@contextlib.contextmanager
def gelu_tanh():
    """The JAX package's serving switch ``set_gelu_approximate(True)``: every
    Block MLP takes the tanh-form GELU while it is on."""
    set_gelu_approximate(True)
    try:
        yield
    finally:
        set_gelu_approximate(False)


@contextlib.contextmanager
def gelu_off():
    """The switch off inside a ``gelu_tanh`` block (the degree-9 form)."""
    set_gelu_approximate(False)
    try:
        yield
    finally:
        set_gelu_approximate(True)


def phase_blocks(device, rng, gelu=9):
    """Kernel vs plain at the four Block shapes; returns per-dtype sums over
    one expert's 12 Blocks.  ``gelu=GELU_TANH`` runs them with the serving
    switch on (the tanh form), each timed beside the degree-9 form on the
    same Block, the library Block with ``F.gelu(approximate="tanh")``."""
    tanh = gelu == GELU_TANH
    label = "tanh " if tanh else ""
    totals = {}
    for dt in (torch.float32, torch.bfloat16):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   max_abs_err=0.0, bytes_ms=0.0, ops_ms=0.0)
        if tanh:
            tot["ms_degree9"] = 0.0
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
            with gelu_tanh() if tanh else contextlib.nullcontext(), torch.inference_mode():
                blk.plain = False
                out_k = _launch_twice(f"{label}{name} {str(dt)[6:]} Block", lambda: blk(x))
                ms = cuda_ms(lambda: blk(x), 5)
                if tanh:
                    with gelu_off():
                        ms9 = cuda_ms(lambda: blk(x), 5)
                    tot["ms_degree9"] += count * ms9
                blk.plain = True
                out_p = blk(x)
                plain_ms = cuda_ms(lambda: blk(x), 3)
                blk.plain = False
                params = {k: v for k, v in blk.named_parameters()}
                full_mask = (None if blk.mask is None
                             else blk.mask.to(device=device, dtype=dt))
                lib_ms = cuda_ms(lambda: library_block(
                    x, params, full_mask, heads, blk.scale,
                    approximate="tanh" if tanh else "none"), 5)
            plan = svtr_block._Plan(n, blk.mask, blk.band, x.device)
            bytes_ms, ops_ms = block_bound_ms(BATCH, n, c, heads, 4 * c, dt,
                                              plan.mask, plan.width)
            bound = max(bytes_ms, ops_ms)
            atol, rtol = BLOCK_TOL[dt]
            err = check_close(f"{label}{name} {str(dt)[6:]} [{BATCH},{n},{c}] qb {plan.qb} "
                              f"width {plan.width}", out_k, out_p, atol, rtol)
            print(f"    ms {ms:.3f}" + (f" (degree 9 {ms9:.3f})" if tanh else "")
                  + f"  plain_ms {plain_ms:.3f}  library_ms {lib_ms:.3f}  "
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
        print(f"  {label}one expert's 12 Blocks, {str(dt)[6:]}, batch {BATCH}: "
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

    servers["bfloat16"].recognize(images)
    torch.cuda.synchronize()
    with device_trace() as prof:
        t0 = time.perf_counter()
        servers["bfloat16"].recognize(images)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_device_profile(f"bf16 {N_EXPERTS}-expert SVTR request of {BATCH} crops, warm",
                         prof, wall)
    return launches, timings, servers, images


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
            with device_trace() as prof:
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


def _step0_window(learner, manager, prefetch, warmup=TIME_WARMUP, steps=TIME_STEPS):
    """The mean step-0 step (host clock, synced at both ends) of ``steps``
    steps after ``warmup``, batches from ``manager`` through a prefetcher
    or not."""
    fetch = Prefetcher(manager.get_batch, warmup + steps) if prefetch else manager.get_batch
    try:
        for _ in range(warmup):
            learner.train_step(fetch())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            learner.train_step(fetch())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps
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
        for flag in (True, False):
            windows[flag].append(_step0_window(learner, manager, flag))
        fetch = Prefetcher(manager.get_batch, TRACE_STEPS + 1)
        try:
            learner.train_step(fetch())
            torch.cuda.synchronize()
            with device_trace() as prof:
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
            windows = [_step0_window(learner, manager, True)]
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


def library_block_int8(x, blk, approximate="none"):
    """Yardstick: the w8a8 Block from library calls in x's dtype --
    ``torch._int_mm`` (cuBLASLt int8, B column-major as its int8 path takes
    it) for the four projections with the activation quantization and
    dequant as PyTorch ops, ``F.layer_norm``, SDPA held to its fused
    backends (flash, or memory-efficient with the full mask in x's dtype),
    exact GELU (or its tanh form with ``approximate="tanh"``).  Timed only.
    Returns a function of no arguments."""
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
        return (x1 + proj(3, F.gelu(proj(2, h), approximate=approximate))).to(x.dtype)
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


# ------------------------------------------------------------ LMDB entry points
def check_codec_fixtures():
    """(a): the C++ codec on the committed fixtures (PIL's decode and
    32x256 resize in ``expected.npz``), bitwise.  Returns {name: bytes}."""
    folder = os.path.join(ROOT, "tests", "fixtures", "torch_codec")
    expected = np.load(os.path.join(folder, "expected.npz"))
    files = {}
    for name in sorted(n for n in os.listdir(folder) if not n.endswith(".npz")):
        with open(os.path.join(folder, name), "rb") as f:
            files[name] = f.read()
        if not (np.array_equal(image_codec.decode(files[name]), expected[f"{name}:decode"])
                and np.array_equal(image_codec.decode(files[name], (256, 32)),
                                   expected[f"{name}:resize"])):
            raise RuntimeError(f"(a) the codec's decode of fixture {name} differs from PIL's")
    print(f"  (a) the C++ codec reproduces all {len(files)} committed fixtures bitwise "
          f"(PIL's decode and its bicubic resize to 32x256)")
    return files


def _decode_rate(buffers, size):
    """Crops/s of ``image.decode`` to ``size`` on this thread."""
    t0 = time.perf_counter()
    for buf in buffers:
        image_codec.decode(buf, size)
    return len(buffers) / (time.perf_counter() - t0)


def _write_lmdb_tree(root):
    """The phase's LMDB tree: ``{root}/{train,test}/{language}``."""
    alphabets = campaign.task_alphabets()[:LMDB_TASKS]
    index = {ch: i for i, ch in enumerate("".join(alphabets))}
    for split, n, seed in (("train", LMDB_TRAIN, 0), ("test", LMDB_TEST, 100)):
        for t, lan in enumerate(campaign.LANS[:LMDB_TASKS]):
            create_lmdb.create_synthetic_dataset(
                os.path.join(root, split, lan), alphabets[t], n, seed + t,
                heights=LMDB_HEIGHTS, widths=LMDB_WIDTHS, max_len=LMDB_MAX_LEN,
                char_to_idx=index)


def _lmdb_config(root, name, aug="None", tasks=LMDB_TASKS, iters=CAMPAIGN_ITERS,
                 val=CAMPAIGN_VAL):
    """A config file over ``configs/svtr_mrn.py`` with the phase's tree,
    cuts and output directory (``aug`` its ``Aug``, the first ``tasks``
    languages, ``iters`` step-0 iterations validated every ``val``)."""
    path = os.path.join(root, f"{name}.py")
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"""import runpy
_base = runpy.run_path({os.path.join(ROOT, "configs", "svtr_mrn.py")!r})
common = dict(_base["common"], exp_name={name!r}, memory_num={CAMPAIGN_MEMORY},
              output_dir={os.path.join(root, "saved")!r},
              data_log={os.path.join(root, "data_any.txt")!r})
model = _base["model"]
optimizer = _base["optimizer"]
train = dict(_base["train"], lan_list={campaign.LANS[:tasks]!r},
             select_data=[{os.path.join(root, "train")!r}],
             valid_datas=[{os.path.join(root, "test")!r}], workers=0, Aug={aug!r},
             num_iter={iters}, val_interval={val})
""")
    return path


def lmdb_train_launches(tasks, iters=CAMPAIGN_ITERS, val=CAMPAIGN_VAL):
    """Kernel launches of a train_cli run of ``tasks`` tasks of ``iters``
    step-0 iterations (validated every ``val``) over test sets of one
    batch: 6 full + 6 banded attention per step-0 step; kernel 4 in the FF
    validations (12 a batch) and task 0's ``test``, and from task 1 in the
    step-1 steps, the TF validations and ``test`` ((t + 1) experts x 12 per
    step or batch, t + 1 sets of one batch)."""
    n0, n1 = iters, iters // 2
    fused = 0
    for t in range(tasks):
        experts = (t + 1) * 12
        fused += val_points(n0, val) * 12
        if t == 0:
            fused += 12
            continue
        fused += n1 * experts + val_points(n1, max(1, val // 5)) * (t + 1) * experts
        fused += (t + 1) * experts
    return dict(full=6 * n0 * tasks, banded=6 * n0 * tasks, fused=fused, train_fwd=0,
                train_bwd_tail=0, train_bwd_head=0)


def _recording_steps(record):
    """Patches ``BaseLearner.train_step`` to record each batch the loop
    takes: the sha1 of its crops (a bank batch's indices gathered from the
    bank's host chunks), its labels and its router targets."""
    real = BaseLearner.train_step

    def train_step(self, fetched):
        images = np.asarray(fetched[0])
        if images.dtype != np.uint8:
            bank = self.opt.image_bank
            starts = np.cumsum([0] + [len(c) for c in bank.chunks])
            which = np.searchsorted(starts, images, side="right") - 1
            images = np.stack([bank.chunks[c][i - starts[c]] for c, i in zip(which, images)])
        record.append((hashlib.sha1(images.tobytes()).hexdigest(), list(fetched[1]),
                       np.asarray(fetched[2]).tobytes() if len(fetched) > 2 else None))
        return real(self, fetched)
    return mock.patch.object(BaseLearner, "train_step", train_step)


def _recording_learner(module, seen):
    """Patches ``module.load_learner`` to keep each learner it loads, its
    seconds (``load_s``) and the results of its ``run_validation`` calls."""
    real = module.load_learner

    def load_learner(*args, **kwargs):
        t0 = time.perf_counter()
        learner = real(*args, **kwargs)
        seen["load_s"] = time.perf_counter() - t0
        run = learner.run_validation

        def run_validation(loader, choose="val"):
            res = run(loader, choose)
            seen["results"].append(res)
            return res
        learner.run_validation = run_validation
        seen["learner"] = learner
        return learner
    return mock.patch.object(module, "load_learner", load_learner)


def phase_lmdb(out_dir, device):
    """The entry points a user calls, over an LMDB tree written here (see
    LMDB_*): train_cli (LMDB stream, then --device_bank), evaluate_cli on
    the final checkpoint, evaluate_cli --int8 on task 0's, recognize_cli on
    a folder of PNG crops; checks (a)-(e) and prints the decode rates, step
    windows, an idle share and the CLIs' crops/s.  Returns the launches."""
    root = os.path.join(out_dir, "lmdb")
    fixtures = check_codec_fixtures()
    t0 = time.perf_counter()
    _write_lmdb_tree(root)
    print(f"  wrote {LMDB_TASKS} tasks x ({LMDB_TRAIN} train + {LMDB_TEST} test) PNG crops "
          f"of {LMDB_HEIGHTS[0]}-{LMDB_HEIGHTS[1]} x {LMDB_WIDTHS[0]}-{LMDB_WIDTHS[1]} px in "
          f"{time.perf_counter() - t0:.1f} s")
    env = LmdbReader(os.path.join(root, "train", campaign.LANS[0]))
    pngs = [env.get(b"image-%09d" % (i % LMDB_TRAIN + 1)) for i in range(LMDB_DECODE_CALLS)]
    jpegs = [b for n, b in sorted(fixtures.items()) if n.endswith(".jpg")]
    jpegs = [jpegs[i % len(jpegs)] for i in range(LMDB_DECODE_CALLS)]
    png_rate = _decode_rate(pngs, (256, 32))
    jpeg_rate = _decode_rate(jpegs, (256, 32))
    print(f"  host decode + resize to 32x256, one thread: PNG crops {png_rate:.0f} crops/s "
          f"({1e3 * BATCH / png_rate:.1f} ms a batch of {BATCH}), JPEG fixtures (9-40 x 3-120 "
          f"px) {jpeg_rate:.0f} crops/s ({LMDB_DECODE_CALLS} calls each)")

    launches, runs, windows = {}, {}, {}
    for tag, extra in (("lmdb", []), ("bank", ["--device_bank"])):
        cfg = _lmdb_config(root, f"smoke_lmdb_{tag}")
        record = []
        with fused_train_env(False), _recording_steps(record):
            reset_launches()
            t0 = time.perf_counter()
            run = train_cli.main(["--config", cfg, "--bf16", *extra])
            wall = time.perf_counter() - t0
            launches[tag] = read_launches()
        expected = lmdb_train_launches(LMDB_TASKS)
        print(f"  train_cli {' '.join(extra) or '(LMDB stream)'}: {LMDB_TASKS} tasks in "
              f"{wall:.1f} s, {len(record)} steps, AIA per stage {run.best_scores}; launches "
              f"{launches[tag]} (expected {expected})")
        if launches[tag] != expected:
            raise RuntimeError(f"train_cli {tag} did not run through the kernels as expected")
        runs[tag] = (run, record)
        learner = run.learner
        learner._phase = "standalone"
        learner.build_optimizer()
        manager = DatasetManager(learner.opt)
        manager.init_start(learner.opt, learner.opt.select_data, None, LMDB_TASKS - 1)
        with fused_train_env(False):
            windows[tag] = [_step0_window(learner, manager, True)]
            if tag == "lmdb":
                fetch = Prefetcher(manager.get_batch, TRACE_STEPS + 1)
                try:
                    learner.train_step(fetch())
                    torch.cuda.synchronize()
                    with device_trace() as prof:
                        t1 = time.perf_counter()
                        for _ in range(TRACE_STEPS):
                            learner.train_step(fetch())
                        torch.cuda.synchronize()
                        traced = time.perf_counter() - t1
                finally:
                    fetch.close()
                idle = print_device_profile(f"bf16 step 0 on the LMDB stream, {TRACE_STEPS} "
                                            "steps, prefetch on", prof, traced)
        del learner, manager
    print(f"  step-0 windows ({TIME_STEPS} steps after {TIME_WARMUP}, task "
          f"{LMDB_TASKS - 1}, prefetch on): LMDB stream "
          f"{', '.join(f'{1e3 * w:.2f}' for w in windows['lmdb'])} ms/step, device bank "
          f"{', '.join(f'{1e3 * w:.2f}' for w in windows['bank'])} ms/step; idle share of the "
          f"traced LMDB window {'not measured' if idle is None else f'{idle:.1%}'}")

    # ---- (b) the LMDB stream's batches against the device bank's
    (run, record), (_, bank_record) = runs["lmdb"], runs["bank"]
    if record != bank_record:
        bad = next(i for i, (a, b) in enumerate(zip(record, bank_record)) if a != b) \
            if len(record) == len(bank_record) else "count"
        raise RuntimeError(f"(b) the LMDB stream and the device bank's differ (at {bad})")
    print(f"  (b) the {len(record)} batches of the LMDB stream equal the device bank run's "
          f"bitwise (crops, labels, router targets)")
    del runs

    # ---- (c) evaluate_cli on the final checkpoint against train_cli's test
    cfg = os.path.join(root, "smoke_lmdb_lmdb.py")
    saved = os.path.join(root, "saved", "smoke_lmdb_lmdb")
    last = LMDB_TASKS - 1
    final = os.path.join(saved, f"{campaign.LANS[last]}_{last}_1_best_score.msgpack")
    seen = {"results": []}
    with _recording_learner(evaluate_cli, seen):
        reset_launches()
        t0 = time.perf_counter()
        scores, neds = evaluate_cli.main(["--config", cfg, "--saved_model", final, "--eval_data",
                                          os.path.join(root, "test"),
                                          "--result_dir", os.path.join(root, "result")])
        eval_wall = time.perf_counter() - t0
        launches["evaluate"] = read_launches()
    infer = sum(r.infer_time for r in seen["results"])
    with open(os.path.join(saved, "log_train.txt"), encoding="utf-8") as f:
        log = f.read()
    accs = ast.literal_eval(log.rsplit(f"Task {last} accs: ", 1)[1].split("\n", 1)[0])
    test_neds = ast.literal_eval(log.rsplit(f"Task {last} accs: ", 1)[1].split("ned: ", 1)[1]
                                 .split("\n", 1)[0])
    got = ([round(x, 2) for x in scores], [round(x, 2) for x in neds])
    n_eval = LMDB_TASKS * LMDB_TEST
    print(f"  (c) evaluate_cli on {os.path.basename(final)}: acc {got[0]} ned {got[1]}; "
          f"train_cli's last test(): acc {accs} ned {test_neds}; {n_eval} crops in "
          f"{eval_wall:.2f} s: {n_eval / eval_wall:.0f} crops/s with the checkpoint load "
          f"({seen['load_s']:.2f} s), {n_eval / (eval_wall - seen['load_s']):.0f} without "
          f"(decode included), {n_eval / infer:.0f} in its eval batches alone; launches "
          f"{launches['evaluate']}")
    if got != (accs, test_neds):
        raise RuntimeError("(c) evaluate_cli's scores differ from train_cli's test()")
    if launches["evaluate"]["fused"] < LMDB_TASKS * LMDB_TASKS * 12:
        raise RuntimeError("(c) evaluate_cli did not run kernel 4 on every expert and set")
    eval_words = seen["results"][-1].preds

    # ---- (d) evaluate_cli --int8 on task 0's checkpoint
    first = os.path.join(saved, f"{campaign.LANS[0]}_0_0_best_score.msgpack")
    seen = {"results": []}
    with _recording_learner(evaluate_cli, seen):
        reset_launches()
        svtr_block.int8_launches = 0
        evaluate_cli.main(["--config", cfg, "--saved_model", first, "--taski", "0", "--int8",
                           "--eval_data", os.path.join(root, "test"),
                           "--result_dir", os.path.join(root, "result")])
        launches["int8"] = svtr_block.int8_launches
        int8_other = read_launches()
    print(f"  (d) evaluate_cli --int8 --taski 0: acc {seen['results'][0].score:.2f} ned "
          f"{seen['results'][0].ned:.2f}; int8 Block launches {launches['int8']} (expected "
          f"12, one batch of {LMDB_TEST}); calibration's launches {int8_other}")
    if launches["int8"] != 12 or int8_other["fused"]:
        raise RuntimeError("(d) evaluate_cli --int8 did not run the int8 kernel as expected")
    learner = seen["learner"]
    srv = Server(learner.opt, {}, None, learner.character, device=device, model=learner.model)
    batch = next(iter(ValDataset([os.path.join(root, "test", campaign.LANS[0])],
                                 learner.opt).create_dataset()))[0]
    out_k = check_served_int8_blocks("(d) int8 float32, evaluate_cli's model,", srv, batch,
                                     torch.float32)
    if not bool(torch.isfinite(out_k).all()):
        raise RuntimeError("(d) the int8 evaluate_cli logits are not finite")
    int8_logits_vs_plain("(d) int8 float32, evaluate_cli's model, (information)", srv, batch,
                         "float32", out_k)
    floats = Server(learner.opt, learner.float_params, learner.float_stats, learner.character,
                    device=device)
    with torch.inference_mode():
        out_f = floats.forward(batch)["logits"].float()
        configure_blocks(srv.model, plain=True)
        out_p = srv.forward(batch)["logits"].float()
        configure_blocks(srv.model, plain=False)
    e_k, e_p = float((out_k - out_f).abs().mean()), float((out_p - out_f).abs().mean())
    picks_k = float((out_k.argmax(-1) == out_f.argmax(-1)).float().mean())
    picks_p = float((out_p.argmax(-1) == out_f.argmax(-1)).float().mean())
    ok = e_k <= INT8_VS_FLOAT_RATIO * e_p and picks_k >= picks_p - INT8_VS_FLOAT_PICKS
    print(f"  (d) against the float32 recognizer: kernel mean |k - f| {e_k:.3e}, plain "
          f"{e_p:.3e} (ratio {e_k / e_p:.3f}, tol {INT8_VS_FLOAT_RATIO:g}); greedy picks equal "
          f"to the float model's: kernel {picks_k:.2%}, plain {picks_p:.2%} (tol "
          f"{INT8_VS_FLOAT_PICKS:.0%}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("(d) the int8 kernel path leaves the float model further than the "
                           "plain int8 path")
    del learner, srv, floats

    # ---- (e) recognize_cli on a folder of PNG crops: the eval path's words
    folder = os.path.join(root, "crops")
    os.makedirs(folder, exist_ok=True)
    env = LmdbReader(os.path.join(root, "test", campaign.LANS[last]))
    for i in range(LMDB_TEST):
        with open(os.path.join(folder, f"{i:05d}.png"), "wb") as f:
            f.write(env.get(b"image-%09d" % (i + 1)))
    reset_launches()
    seen = {"results": []}
    t0 = time.perf_counter()
    with _recording_learner(recognize_cli, seen), \
            contextlib.redirect_stdout(open(os.devnull, "w")):
        words = recognize_cli.main(["--config", cfg, "--saved_model", final,
                                    "--image_folder", folder])
    rec_wall = time.perf_counter() - t0
    launches["recognize"] = read_launches()
    print(f"  (e) recognize_cli: {len(words)} crops in {rec_wall:.2f} s: "
          f"{len(words) / rec_wall:.0f} crops/s with the checkpoint load "
          f"({seen['load_s']:.2f} s), {len(words) / (rec_wall - seen['load_s']):.0f} without "
          f"(decode included); launches {launches['recognize']}")
    if [w for _, w, _ in words] != list(eval_words):
        raise RuntimeError("(e) recognize_cli's words differ from the eval path's")
    if launches["recognize"]["fused"] != LMDB_TASKS * 12:
        raise RuntimeError("(e) recognize_cli did not run kernel 4 on every expert")
    print(f"  (e) its {len(words)} words equal evaluate_cli's on the same crops "
          f"(task {last}'s test set)")
    total = {k: sum(launches[t][k] for t in ("lmdb", "bank", "evaluate", "recognize"))
             for k in ("full", "banded", "fused")}
    total["int8"] = launches["int8"]
    return total


def _digest(array):
    """SHA-1 of an array's dtype, shape and bytes, as
    ``scripts/make_torch_forms_fixtures.py`` records the expected views."""
    array = np.ascontiguousarray(array)
    return hashlib.sha1(f"{array.dtype}{array.shape}".encode() + array.tobytes()).hexdigest()


def check_forms_fixtures(fixture_dir=FORMS_DIR):
    """(a): every file of ``fixture_dir`` through the codec's Pillow view
    (``decode``) and cv2 view (``imdecode``), against the committed
    digests.  Returns the expected arrays and {word crop's form: bytes}."""
    expected = np.load(os.path.join(fixture_dir, "expected.npz"))
    forms, views = {}, 0
    for sub in ("imgs", "crops"):
        for name in sorted(os.listdir(os.path.join(fixture_dir, sub))):
            if name.endswith(".txt"):
                continue
            key = f"{sub}/{name}"
            with open(os.path.join(fixture_dir, key), "rb") as f:
                data = f.read()
            got = {}
            for which, view in (("pil", image_codec.decode),
                                ("cv_color", lambda b: image_codec.imdecode(
                                    b, image_codec.IMREAD_COLOR)),
                                ("cv_unchanged", lambda b: image_codec.imdecode(
                                    b, image_codec.IMREAD_UNCHANGED))):
                if f"{key}:{which}" in expected.files:
                    got[which] = view(data)
                    continue
                try:    # no digest: the library fails, or the port's view raises
                    view(data)
                except (image_codec.CorruptImage, image_codec.UnsupportedImage):
                    continue
                raise RuntimeError(f"(a) the codec's {which} view of fixture {key} decodes "
                                   "where the library's does not")
            for which, array in got.items():
                if _digest(array) != expected[f"{key}:{which}"]:
                    raise RuntimeError(f"(a) the codec's {which} view of fixture {key} differs "
                                       "from the committed one")
            views += len(got)
            if sub == "crops":
                forms[name.split("_", 1)[1]] = (data, name)
    print(f"  (a) the g++ codec reproduces all {views} committed views of the "
          f"{len(os.listdir(os.path.join(fixture_dir, 'imgs')))} scenes and {len(forms)} word "
          f"crops bitwise (Pillow's RGBA; cv2's IMREAD_COLOR and IMREAD_UNCHANGED)")
    return expected, forms


def phase_forms(out_dir, cfg, final):
    """The dataset tools and the image forms (see ``FORMS_*``) on the LMDB
    phase's config ``cfg`` and final checkpoint ``final``: checks (a)-(d)
    on each fixture tree of ``FORMS_TREES``; prints the per-form decode
    rates and the phase's seconds.  Returns the launches."""
    t_phase = time.perf_counter()
    launches = {"fused": 0, "full": 0}
    for tag, fixture_dir in FORMS_TREES:
        print(f"  -- {os.path.relpath(fixture_dir, ROOT)}")
        got = forms_tree(os.path.join(out_dir, tag), cfg, final, fixture_dir)
        launches = {k: launches[k] + got[k] for k in launches}
    print(f"  the forms phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def forms_tree(root, cfg, final, fixture_dir):
    """Checks (a)-(d) on one fixture tree, working under ``root``; returns
    its launches."""
    expected, forms = check_forms_fixtures(fixture_dir)
    rates = {}
    for form, data in forms.items():
        if f"crops/{data[1]}:pil" not in expected.files:
            continue   # Pillow does not read it: JAX's dummy crop
        data = data[0]
        t0 = time.perf_counter()
        for _ in range(FORMS_DECODE_REPEAT):
            image_codec.decode(data, (256, 32))
        rates[form] = FORMS_DECODE_REPEAT / (time.perf_counter() - t0)
    print("  host decode + resize to 32x256, one thread, crops/s by form: "
          + ", ".join(f"{f.rsplit('.', 1)[0]} ({f.rsplit('.', 1)[1]}) {r:.0f}"
                      for f, r in rates.items())
          + f"; {len(forms) - len(rates)} forms Pillow does not read")
    page = os.path.join(fixture_dir, "imgs", FORMS_PAGE)
    if os.path.exists(page):
        with open(page, "rb") as f:
            data = f.read()
        ms = {}
        for which, view in (("Pillow's view", image_codec.decode),
                            ("cv2's IMREAD_COLOR", lambda b: image_codec.imdecode(
                                b, image_codec.IMREAD_COLOR))):
            t0 = time.perf_counter()
            for _ in range(FORMS_PAGE_REPEAT):
                shape = view(data).shape
            ms[which] = 1e3 * (time.perf_counter() - t0) / FORMS_PAGE_REPEAT
        print(f"  the {shape[1]}x{shape[0]} G4 fax page ({len(data)} bytes), one thread: "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items()))
    # ---- (b) the port's crop_by_word against the JAX tool's committed output
    crops = os.path.join(root, "crops")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mrn_tpu_torch.tools.crop_by_word", fixture_dir,
                           "--out_dir", crops, "--nproc", "2"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"(b) crop_by_word failed:\n{proc.stdout}{proc.stderr}")
    names = sorted(os.listdir(os.path.join(crops, "imgs")))
    with open(os.path.join(crops, "label.txt"), "rb") as f:
        label = f.read()
    if names != list(expected["jax:names"]) or label != expected["jax:label"].tobytes():
        raise RuntimeError("(b) crop_by_word's crop names or label.txt differ from JAX's")
    for name in names:
        with open(os.path.join(crops, "imgs", name), "rb") as f:
            data = f.read()
        bgr = image_codec.imdecode(data, image_codec.IMREAD_UNCHANGED)
        want = expected[f"jax:crop:{name}"]
        if not (np.array_equal(bgr, want) and np.array_equal(
                image_codec.decode(data)[:, :, 2::-1], want)):
            raise RuntimeError(f"(b) crop {name} differs from the JAX tool's")
    scenes = len(os.listdir(os.path.join(fixture_dir, "imgs")))
    print(f"  (b) crop_by_word --nproc 2 on the {scenes}"
          f"-scene tree: {len(names)} crops in {time.perf_counter() - t0:.1f} s (process "
          f"start included); names, label.txt bytes and every crop (cv2 and Pillow views) "
          f"equal the JAX tool's")
    # ---- (c) create_lmdb over those crops and over the word crops in every form
    test = os.path.join(root, "test")
    sources = [(crops, os.path.join(crops, "label.txt")),
               (os.path.join(fixture_dir, "crops"),
                os.path.join(fixture_dir, "crops", "labels.txt")),
               (crops, os.path.join(crops, "label.txt"))]
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        counts = [create_lmdb.create_dataset(src, gt, os.path.join(test, lan))
                  for (src, gt), lan in zip(sources, campaign.LANS[:FORMS_SETS])]
    # the word crops JAX's create_lmdb keeps (cv2 reads them), where some are not
    kept = len(expected["jax:kept"]) if "jax:kept" in expected.files else len(forms)
    if counts != [len(names), kept, len(names)]:
        raise RuntimeError(f"(c) create_lmdb kept {counts} crops, not JAX's "
                           f"{[len(names), kept, len(names)]}")
    print(f"  (c) create_lmdb: {counts} crops in {FORMS_SETS} sets (the tool's crops, "
          f"{kept} of the {len(forms)} word crops' forms as JAX's tool, the tool's again)")
    # ---- (d) evaluate_cli and recognize_cli on them, row 4 counted
    launches = {}
    reset_launches()
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        scores, neds = evaluate_cli.main(["--config", cfg, "--saved_model", final, "--eval_data",
                                          test, "--result_dir", os.path.join(root, "result")])
    launches["evaluate"] = read_launches()
    reset_launches()
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        words = recognize_cli.main(["--config", cfg, "--saved_model", final, "--image_folder",
                                    os.path.join(fixture_dir, "crops")])
    launches["recognize"] = read_launches()
    # every expert's 12 Blocks on each batch (row 4); evaluate_cli's score
    # envelope check, once a learner, runs them composed on its first batch (row 1)
    batch = load_config(cfg).batch_size
    want = {"evaluate": dict(fused=sum(-(-n // batch) for n in counts) * LMDB_TASKS * 12,
                             full=LMDB_TASKS * 12),
            "recognize": dict(fused=-(-len(words) // batch) * LMDB_TASKS * 12)}
    print(f"  (d) evaluate_cli on the {FORMS_SETS} sets: acc {scores} ned {neds}; "
          f"recognize_cli on the word crops (its jpg and png, as RawDataset lists): "
          f"{len(words)} words; launches {launches['evaluate']} and "
          f"{launches['recognize']} (expected {want['evaluate']} and {want['recognize']})")
    if len(words) != sum(n.rsplit(".", 1)[1] in ("jpg", "png") for n in forms) or \
            not all(isinstance(w, str) for _, w, _ in words):
        raise RuntimeError("(d) recognize_cli did not read every jpg and png word crop")
    for tag in want:
        if any(launches[tag][k] != want[tag].get(k, 0) for k in launches[tag]):
            raise RuntimeError(f"(d) {tag} launched {launches[tag]}, not {want[tag]}")
    return {k: launches["evaluate"][k] + launches["recognize"][k] for k in ("fused", "full")}


def _parallel_config(root, name):
    """A config file over ``configs/svtr_mrn.py`` with the LMDB phase's tree
    (its first PAR_TASKS tasks), float32, the phase's cuts and its own
    output directory."""
    path = os.path.join(root, f"{name}.py")
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"""import runpy
_base = runpy.run_path({os.path.join(ROOT, "configs", "svtr_mrn.py")!r})
common = dict(_base["common"], exp_name={name!r}, memory_num={CAMPAIGN_MEMORY},
              output_dir={os.path.join(root, name)!r},
              data_log={os.path.join(root, name, "data_any.txt")!r})
model = _base["model"]
optimizer = _base["optimizer"]
train = dict(_base["train"], lan_list={campaign.LANS[:PAR_TASKS]!r},
             select_data=[{os.path.join(root, "train")!r}],
             valid_datas=[{os.path.join(root, "test")!r}], workers=0,
             num_iter={PAR_ITERS}, val_interval={PAR_ITERS})
""")
    return path


def parallel_launches(tasks, expert_shards=1):
    """Each rank's launches of rows 1, 2 and 4 in a train_cli run of
    ``tasks`` tasks (test sets of one batch): 6 full and 6 banded attention
    launches a step-0 step; kernel 4 in the FF validations (one set) and
    task 0's ``test``, and from task 1 in the router steps, the TF
    validations and ``test`` (t + 1 sets), 12 per expert this rank holds
    (its block of ``expert_shards``, all of them when the count does not
    divide).  A data shard launches as often as the whole batch."""
    n0, n1 = PAR_ITERS, PAR_ITERS // 2
    fused = 0
    for t in range(tasks):
        fused += val_points(n0, PAR_ITERS) * 12
        if t == 0:
            fused += 12
            continue
        held = (t + 1) // expert_shards if (t + 1) % expert_shards == 0 else t + 1
        fused += (n1 + val_points(n1, max(1, PAR_ITERS // 5)) * (t + 1) + (t + 1)) * held * 12
    return dict(full=6 * n0 * tasks, banded=6 * n0 * tasks, fused=fused)


@contextlib.contextmanager
def grad_log():
    """Yields ``(calls, quiet)``.  ``calls`` gets, for every optimizer step
    inside the block, the names of its leaves and the norms of the gradient
    it steps on (after the world's all-reduce and any grad_transform,
    before the clip), left on the device.  ``quiet`` gets, from the first
    step of each optimizer, a mask of the elements whose gradient is at
    most PAR_GRAD_FLOOR of the step's largest: float noise on an exact 0
    (a conv bias before BatchNorm, the key part of a qkv bias, the route
    bias), which Adam turns into steps of up to its learning rate, by the
    key the parameter has in the phase's records.  The names come from the
    learner train_cli builds, caught on its way out of ``build_learner``."""
    from mrn_tpu_torch.train import optim

    calls, quiet, learners = [], {}, []
    real_step, real_build = optim._Clipped.step, train_cli.build_learner

    def build(*args, **kwargs):
        learners.append(real_build(*args, **kwargs))
        return learners[-1]

    def step(self, grads):
        learner = learners[-1]
        if learner.state.opt is not self:
            raise RuntimeError("an optimizer step outside the learner's state")
        names = list(learner.state.params)
        calls.append((names, torch.stack(torch._foreach_norm(list(grads)))))
        if not getattr(self, "_grad_logged", False):
            self._grad_logged = True
            prefix = "" if learner._phase == "routed" else f"experts.{learner._cur_task}."
            floor = PAR_GRAD_FLOOR * max(float(g.abs().max()) for g in grads if g.numel())
            quiet.update({prefix + n: (g.abs() <= floor).cpu() for n, g in zip(names, grads)})
        return real_step(self, grads)

    optim._Clipped.step, train_cli.build_learner = step, build
    try:
        yield calls, quiet
    finally:
        optim._Clipped.step, train_cli.build_learner = real_step, real_build


def _run_record(run, wall, grads):
    """What the phase compares of a train_cli run: the frozen experts' and
    the router's tensors (port names, on the host), the scores, the logged
    and step losses, the gradient norms of ``grad_log``, the step windows'
    seconds (step 0 of the last task from its second iteration, the router
    steps from their second) and the gradient buckets' bytes (float32: the
    trainable parameters and the step's scalar metrics)."""
    learner = run.learner
    state = {f"experts.{i}.{k}": v.detach().cpu().clone()
             for i, s in enumerate(learner.expert_states) for k, v in s.items()}
    state.update({k: v.detach().cpu().clone() for k, v in learner.router_state.items()})
    last = PAR_TASKS - 1
    hist = [r for r in learner.history if r["task"] == last]
    step0 = [r["seconds"] for r in hist if r["step"] == 0 and r["iteration"] > 1]
    router = [r["seconds"] for r in hist if r["step"] == 1 and r["iteration"] > 1]
    expert_n = sum(v.numel() for v in learner.model.parameters())
    router_n = sum(v.numel() for v in learner.router_state.values()
                   if v.is_floating_point())
    return dict(state=state, best=run.best_scores, ned=run.ned_scores,
                loss=[r["loss"] for r in learner.history],
                valid_loss=[float(x) for x in re.findall(
                    r"Valid_loss: ([-0-9.e]+)", open(learner.log.train_log_path,
                                                     encoding="utf-8").read())],
                step0_ms=1e3 * sum(step0) / len(step0), router_ms=1e3 * sum(router) / len(router),
                grads=[(names, norms.double().cpu()) for names, norms in grads[0]],
                quiet=grads[1],
                bucket=(4 * (expert_n + 1), 4 * (router_n + 4)), launches=read_launches(),
                wall=wall)


def parallel_rank(out_dir, argv):
    """One rank of a torchrun world of the parallel phase: ``train_cli.main``
    of ``argv`` (TF32 off, its launches counted) in a gloo group joined
    first (NCCL, train_cli's backend on the card, refuses two ranks on one
    card; train_cli joins the group it finds), its record saved as
    ``{out_dir}/rank{r}.pt``."""
    from mrn_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(argv[argv.index("--device") + 1], "gloo")
    reset_launches()
    with grad_log() as grads:
        t0 = time.perf_counter()
        run = train_cli.main(argv)
        record = _run_record(run, time.perf_counter() - t0, grads)
    rank = torch.distributed.get_rank()
    torch.save(record, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _parallel_diff(got, ref, quiet):
    """``got`` against ``ref`` (port-named tensors): the largest difference,
    the share of all elements outside PAR_RTOL / PAR_ATOL, and the worst
    leaf's share and name, leaving out the ``quiet`` elements (``grad_log``)
    and the PAR_ZERO_GRAD statistics, which are held only at PAR_ADAM_NOISE
    through the largest difference."""
    largest, stray, total, worst = 0.0, 0, 0, (0.0, "none")
    for key, r in ref.items():
        g, r = got[key].double(), r.double()
        out = (g - r).abs() > PAR_ATOL + PAR_RTOL * r.abs()
        largest = max(largest, float((g - r).abs().max()) if r.numel() else 0.0)
        stray, total = stray + int(out.sum()), total + r.numel()
        loud = ~quiet[key] if key in quiet else torch.ones_like(out)
        share = int((out & loud).sum()) / max(int(loud.sum()), 1)
        if share > worst[0] and not key.endswith(PAR_ZERO_GRAD):
            worst = (share, key)
    return largest, stray / total, worst[0], worst[1]


def _grad_diff(got, ref):
    """``got``'s gradient norms (``grad_log``) against ``ref``'s, step by
    step: the worst leaf's |difference| / (ref's norm + PAR_GRAD_FLOOR of
    the step's largest), with the step's index and the leaf's name."""
    if [names for names, _ in got] != [names for names, _ in ref]:
        raise RuntimeError("the runs stepped on other leaves")
    worst = (0.0, -1, "")
    for k, ((names, g), (_, r)) in enumerate(zip(got, ref)):
        rel = (g - r).abs() / (r + PAR_GRAD_FLOOR * r.max())
        j = int(rel.argmax())
        worst = max(worst, (float(rel[j]), k, names[j]))
    return worst


def _loss_diff(got, ref):
    """The largest relative difference of the step losses."""
    if len(got["loss"]) != len(ref["loss"]):
        raise RuntimeError("the runs took different numbers of steps")
    return max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got["loss"], ref["loss"]))


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_world(tag, root, cfg, extra):
    """Starts ``torchrun --nproc_per_node 2`` of ``parallel_rank`` on cuda:0
    with gloo, its output to files; ``_finish_world`` waits for it."""
    out = os.path.join(root, f"ranks_{tag}")
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           os.path.join(ROOT, "chip_smoke.py"), "--parallel-rank", out, "--config", cfg,
           "--device", PAR_DEVICE, "--device_bank", *extra]
    logs = [open(os.path.join(out, name), "w+") for name in ("stdout.txt", "stderr.txt")]
    proc = subprocess.Popen(cmd, stdout=logs[0], stderr=logs[1],
                            env=dict(os.environ, OMP_NUM_THREADS="4"))
    return tag, out, proc, logs, time.perf_counter()


def _finish_world(world):
    """The ranks' records of a world ``_start_world`` started, or None (and
    the reason) when gloo refuses the CUDA collectives; and its seconds."""
    tag, out, proc, logs, t0 = world
    try:
        rc = proc.wait(timeout=max(1.0, PAR_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.terminate()               # torchrun passes it on to its ranks
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        rc = None
    wall = time.perf_counter() - t0
    text = []
    for log in logs:
        log.seek(0)
        text.append(log.read())
        log.close()
    if rc != 0:
        text = text[0][-3000:] + text[1][-6000:]
        if rc is not None and re.search(r"gloo.*(not supported|unsupported|Unsupported)|"
                                        r"(not supported|unsupported|Unsupported).*[Gg]loo", text):
            return None, text.strip().splitlines()[-1], wall
        raise RuntimeError(f"(b) the {tag} world failed"
                           f"{' (timed out)' if rc is None else ''}:\n{text}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(2)], None, wall


def check_augment_fixtures():
    """(a): the C++ augment library, built here, on the committed fixtures
    (Pillow's, OpenCV's and the JAX package's arrays in ``expected.npz``):
    bitwise, or within the bounds ``data.augment_fixtures`` states."""
    result = augment_fixtures.check(os.path.join(ROOT, "tests", "fixtures", "torch_augment"))
    if result["failures"]:
        raise RuntimeError("(a) the augment library differs from the fixtures: "
                           + "; ".join(result["failures"]))
    print(f"  (a) the C++ augment library reproduces the {result['arrays']} committed fixture "
          f"arrays: {result['bitwise']} bitwise, {len(result['bounded'])} within the stated "
          f"bound ({'; '.join(result['bounded']) or 'none'})")


def _augment_rate(buffers, transform):
    """Crops/s of decoding each PNG at its own size and running
    ``transform`` (which ends in the resize) on this thread."""
    t0 = time.perf_counter()
    for buf in buffers:
        transform(image_codec.decode(buf))
    return len(buffers) / (time.perf_counter() - t0)


def _traced_idle(learner, manager, label, steps):
    """The device-busy share of ``steps`` step-0 steps fed through the
    prefetcher, under ``torch.profiler``."""
    fetch = Prefetcher(manager.get_batch, steps + 1)
    try:
        learner.train_step(fetch())
        torch.cuda.synchronize()
        with device_trace() as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                learner.train_step(fetch())
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
    finally:
        fetch.close()
    return print_device_profile(label, prof, traced)


def phase_augment(out_dir, device):
    """Training-time augmentation over the LMDB phase's tree: (a) the
    fixtures, the host's augment + resize crops/s per chain, then
    train_cli with ``Aug=ABINet`` over its first 2 tasks and with
    ``Blur5-Crop90-Rot15`` over task 0 (bf16, AUG_ITERS a task): (b) the
    launches equal the unaugmented run's count for those tasks and cuts,
    (c) the first batch has the unaugmented stream's labels and other
    crops; the ABINet stream's step-0 window and idle share.  Returns the
    launches."""
    t_phase = time.perf_counter()
    root = os.path.join(out_dir, "lmdb")
    check_augment_fixtures()
    env = LmdbReader(os.path.join(root, "train", campaign.LANS[0]))
    pngs = [env.get(b"image-%09d" % (i % LMDB_TRAIN + 1)) for i in range(AUG_RATE_CROPS)]
    opt = load_config(os.path.join(ROOT, "configs", "svtr_mrn.py"))
    size = (opt.imgW, opt.imgH)
    rates = {"decode + resize": _decode_rate(pngs, size)}
    for tag, aug, _ in AUG_CHAINS:
        transform = build_transform(opt.replace(Aug=aug), "train", rng=random.Random(SEED),
                                    np_rng=np.random.RandomState(SEED))
        rates[aug] = _augment_rate(pngs, transform)
    rates["MoCo, two views"] = _augment_rate(pngs, MoCoAugment(opt, random.Random(SEED)))
    print(f"  host, one thread, {AUG_RATE_CROPS} PNG crops of the tree to {size[1]}x{size[0]}: "
          + ", ".join(f"{k} {v:.0f} crops/s ({1e3 * opt.batch_size / v:.0f} ms a batch of "
                      f"{opt.batch_size})" for k, v in rates.items()))

    launches = {}
    window = idle = None
    for tag, aug, tasks in AUG_CHAINS:
        cfg = _lmdb_config(root, f"smoke_aug_{tag}", aug, tasks, AUG_ITERS, AUG_VAL)
        record = []
        with fused_train_env(False), _recording_steps(record):
            reset_launches()
            t0 = time.perf_counter()
            run = train_cli.main(["--config", cfg, "--bf16"])
            wall = time.perf_counter() - t0
            launches[tag] = read_launches()
        expected = lmdb_train_launches(tasks, AUG_ITERS, AUG_VAL)
        print(f"  (b) train_cli Aug={aug}: {tasks} task(s) of {AUG_ITERS} step-0 iterations in "
              f"{wall:.1f} s, {len(record)} steps, AIA per stage {run.best_scores}; launches "
              f"{launches[tag]} (expected {expected})")
        if launches[tag] != expected:
            raise RuntimeError(f"(b) train_cli Aug={aug} did not run through the kernels as "
                               "expected")
        learner = run.learner
        plain_opt = learner.opt.replace(Aug="None")
        plain = DatasetManager(plain_opt)
        plain.init_start(plain_opt, plain_opt.select_data, None, 0)
        images, labels = plain.get_batch()
        same_crops = hashlib.sha1(np.asarray(images).tobytes()).hexdigest() == record[0][0]
        same_labels = record[0][1] == labels
        print(f"  (c) the first augmented batch: labels {'equal' if same_labels else 'NOT equal'} "
              f"to the unaugmented stream's, crops {'EQUAL' if same_crops else 'different'}")
        if not same_labels or same_crops:
            raise RuntimeError(f"(c) Aug={aug}'s first batch is not the unaugmented stream's "
                               "batch augmented")
        if tag == "abinet":
            learner._phase = "standalone"
            learner.build_optimizer()
            manager = DatasetManager(learner.opt)
            manager.init_start(learner.opt, learner.opt.select_data, None, tasks - 1)
            with fused_train_env(False):
                window = _step0_window(learner, manager, True, AUG_WARMUP, AUG_WINDOW)
                idle = _traced_idle(learner, manager, f"bf16 step 0 on the ABINet-augmented "
                                    f"LMDB stream, {AUG_TRACE} steps, prefetch on", AUG_TRACE)
            del manager
        del learner, run, plain
    print(f"  step-0 window ({AUG_WINDOW} steps after {AUG_WARMUP}, task "
          f"{AUG_CHAINS[0][2] - 1}, Aug=ABINet, prefetch on): {1e3 * window:.2f} ms/step; idle "
          f"share of the traced window {'not measured' if idle is None else f'{idle:.1%}'}; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(v[k] for v in launches.values()) for k in launches["abinet"]}


def phase_parallel(out_dir):
    """train_cli's data- and expert-parallel path at full width (see PAR_*):
    the run without a process group, (a) a 1-rank NCCL world in this process
    (bitwise the same, its NCCL all-reduce in a profile), (b) 2-rank gloo
    worlds on cuda:0 held against the run without a group, (c) each rank's
    launches of rows 1, 2 and 4 against the expected counts, (d) step
    windows with the gradient buckets' bytes.  Returns the launches."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mrn_tpu_torch.parallel import mesh

    root = os.path.join(out_dir, "lmdb")
    t_phase = time.perf_counter()
    launches, records = {}, {}

    def cli_run(tag, world):
        """train_cli in this process, without a group or in a 1-rank world
        (then one more step-0 step is profiled); returns the names of the
        profile's collectives and the world's backend."""
        argv = ["--config", _parallel_config(root, f"par_{tag}"), "--device", PAR_DEVICE,
                "--device_bank"]
        saved, names, backend = {}, [], None
        if world:
            saved = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                                     "WORLD_SIZE", "LOCAL_RANK")}
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0",
                              WORLD_SIZE="1", LOCAL_RANK="0")
            argv += ["--data_parallel", "1"]
        try:
            with fused_train_env(False), grad_log() as grads:
                reset_launches()
                t0 = time.perf_counter()
                run = train_cli.main(argv)
                records[tag] = _run_record(run, time.perf_counter() - t0, grads)
                launches[tag] = records[tag]["launches"]
            if world:
                backend = dist.get_backend()
                if backend != ("nccl" if PAR_DEVICE.startswith("cuda") else "gloo") \
                        or mesh.get_mesh().shape != {"data": 1}:
                    raise RuntimeError(f"(a) train_cli installed a {backend} world, "
                                       f"mesh {mesh.get_mesh()}")
                learner = run.learner
                learner._phase = "standalone"
                learner.build_optimizer()
                manager = DatasetManager(learner.opt)
                manager.init_start(learner.opt, learner.opt.select_data, None, PAR_TASKS - 1)
                learner.train_step(manager.get_batch())
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    learner.train_step(manager.get_batch())
                    torch.cuda.synchronize()
                events = [e for e in prof.key_averages()
                          if "nccl" in e.key.lower() or "allreduce" in e.key.lower()]
                names = sorted({e.key for e in events})
                records[tag]["collective_ms"] = sum(
                    e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
                records[tag]["collective_launches"] = sum(
                    e.count for e in events if e.device_type == DeviceType.CUDA)
        finally:
            if world:
                mesh.clear()
                if dist.is_initialized():
                    dist.destroy_process_group()
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        return names, backend

    def same(a, b):
        return (a["best"], a["ned"], a["loss"]) == (b["best"], b["ned"], b["loss"]) \
            and all(torch.equal(a["state"][k], v) for k, v in b["state"].items())

    def hold(label, rec):
        """Prints ``rec`` against the run without a group; whether it is
        within the phase's bounds."""
        largest, share, leaf_share, leaf = _parallel_diff(rec["state"], alone["state"],
                                                          alone["quiet"])
        grad, step, grad_leaf = _grad_diff(rec["grads"], alone["grads"])
        loss = _loss_diff(rec, alone)
        scores = (rec["best"], rec["ned"]) == (alone["best"], alone["ned"])
        vloss = max(abs(a - b) / max(abs(b), 1e-12)
                    for a, b in zip(rec["valid_loss"], alone["valid_loss"]))
        print(f"  {label}: gradient norms of {len(rec['grads'])} optimizer steps within "
              f"{grad:.3g} relative (worst: step {step}, {grad_leaf}; bound {PAR_GRAD_RTOL:g}); "
              f"step losses within {loss:.2e} and validation losses within {vloss:.2e} "
              f"relative; scores equal: {scores}; parameters: largest difference "
              f"{largest:.3g}, {share:.4%} of all elements and {leaf_share:.3%} of the worst "
              f"leaf's ({leaf}, its elements with a gradient above the floor) outside rtol "
              f"{PAR_RTOL:g} / atol {PAR_ATOL:g}; bitwise: "
              f"{same(rec, alone)}")
        return largest <= PAR_ADAM_NOISE and leaf_share <= PAR_STRAY and scores \
            and grad <= PAR_GRAD_RTOL and loss <= PAR_LOSS_RTOL and vloss <= PAR_LOSS_RTOL \
            and len(rec["valid_loss"]) == len(alone["valid_loss"])

    # a second run without a group gives the card's own run-to-run spread
    # (CTC's backward adds atomically on CUDA)
    cli_run("alone", False)
    cli_run("alone2", False)
    names, backend = cli_run("nccl1", True)
    alone, again, nccl1 = records["alone"], records["alone2"], records["nccl1"]
    expected = parallel_launches(PAR_TASKS)
    print(f"  train_cli without a process group: {PAR_TASKS} tasks in {alone['wall']:.1f} s, "
          f"AIA per stage {alone['best']}; launches {launches['alone']} (expected {expected})")
    repeat = same(again, alone)
    spread = _grad_diff(again["grads"], alone["grads"])[0]
    hold("a second run without a group against the first", again)
    if spread * PAR_GRAD_MARGIN > PAR_GRAD_RTOL:
        raise RuntimeError(f"the card's own spread of the gradient norms, {spread:.3g}, is not "
                           f"{PAR_GRAD_MARGIN} times under the bound {PAR_GRAD_RTOL:g}")
    bitwise = same(nccl1, alone)
    print(f"  (a) 1-rank {backend} world (torchrun's environment, --data_parallel 1): "
          f"{nccl1['wall']:.1f} s; {len(alone['state'])} expert and router tensors, scores and "
          f"{len(alone['loss'])} step losses bitwise equal to the run without a group: "
          f"{bitwise} (a second run without a group: {repeat}); collectives in the profile of "
          f"one more step: {names}, their device kernels {nccl1['collective_launches']} "
          f"launches, {nccl1['collective_ms']:.3f} ms")
    if not hold(f"(a) the 1-rank {backend} world", nccl1) or (repeat and not bitwise):
        raise RuntimeError("(a) the 1-rank NCCL world differs from the run without a group")
    # the collective's op, and under NCCL an NCCL record or kernel beside it
    if not any("allreduce" in n.lower() for n in names) or \
            (backend == "nccl" and not any("nccl" in n.lower() for n in names)):
        raise RuntimeError(f"(a) the profile shows no {backend} all-reduce")

    # ---- (b) 2-rank gloo worlds on cuda:0, both at once, against the run
    # without a group
    torch.cuda.empty_cache()   # the ranks share the card with this process
    shapes = (("data2", ["--data_parallel", "2"], 1), ("expert2", ["--expert_parallel", "2"], 2))
    started, finished, errors = [], [], []
    try:
        for tag, extra, _ in shapes:
            started.append(_start_world(tag, root, _parallel_config(root, f"par_{tag}"), extra))
    finally:
        for world in started:          # every world is waited for
            try:
                finished.append(_finish_world(world))
            except RuntimeError as error:
                errors.append(error)
    if errors:
        raise errors[0]
    worlds = {}
    for (tag, _, shards), (ranks, refused, wall) in zip(shapes, finished):
        if ranks is None:
            print(f"  (b) {tag}: gloo refused a CUDA collective, so the 2-rank world on one "
                  f"card was not run: {refused}")
            continue
        worlds[tag] = ranks
        expected_rank = parallel_launches(PAR_TASKS, shards)
        for r, rec in enumerate(ranks):
            got = {k: rec["launches"][k] for k in expected_rank}
            ok = hold(f"(b) {tag} rank {r} ({rec['wall']:.1f} s in train_cli, {wall:.1f} s "
                      "for torchrun)", rec)
            print(f"  (c) {tag} rank {r}: launches {got} (expected {expected_rank})")
            if not ok:
                raise RuntimeError(f"(b) the {tag} world differs from the run without a group")
            if got != expected_rank:
                raise RuntimeError(f"(c) the {tag} world's rank {r} did not run through the "
                                   "kernels as expected")
            for k in got:
                launches[f"{tag}{r}"] = dict(launches.get(f"{tag}{r}", {}), **{k: got[k]})
    if launches["nccl1"] != launches["alone"] or \
            {k: launches["alone"][k] for k in expected} != expected:
        raise RuntimeError("(c) the runs in this process did not run through the kernels "
                           "as expected")

    # ---- (d) step windows
    rows = [("no group", alone, 1), (f"1-rank {backend}", nccl1, 1)]
    rows += [(f"{tag} (2 gloo ranks on cuda:0, rank {r})", rec, 2)
             for tag, ranks in worlds.items() for r, rec in enumerate(ranks)]
    for label, rec, _ in rows:
        print(f"  (d) {label}: step 0 {rec['step0_ms']:.2f} ms/step (task {PAR_TASKS - 1}, "
              f"iterations 2-{PAR_ITERS}), router step {rec['router_ms']:.2f} ms; gradient "
              f"buckets {rec['bucket'][0]:,} B (step 0) and {rec['bucket'][1]:,} B (router)")
    print("  (d) the two worlds run at once, so four ranks share one card and split its "
          "time: these windows are no multi-GPU scaling figure")
    print(f"  the parallel phase took {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(v.get(k, 0) for v in launches.values()) for k in ("full", "banded", "fused")}


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


def phase_int8_blocks(device, rng, gelu=9):
    """The w8a8 Block kernel vs its plain version at the four Block shapes,
    f32 and bf16, float and int8 attention, with the float-products control;
    profiles the library yardstick once; returns sums over one expert's 12
    Blocks per (dtype, attn_int8).  ``gelu=GELU_TANH`` calibrates and runs
    each Block with the serving switch on (the tanh form), with float
    attention, each timed beside the degree-9 form on the same Block, the
    library Block with ``F.gelu(approximate="tanh")``, and no profile."""
    tanh = gelu == GELU_TANH
    label = "tanh " if tanh else ""
    totals, yardsticks = {}, []
    if not tanh:
        print_ptxas("svtr_block_int8")
    for dt in (torch.float32, torch.bfloat16):
        for attn_int8 in (False,) if tanh else (False, True):
            tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                       ops_ms=0.0, max_abs_err=0.0)
            if tanh:
                tot["ms_degree9"] = 0.0
            for name, hw, c, heads, mixer, count in BLOCK_SHAPES:
                n = hw[0] * hw[1]
                x32 = torch.from_numpy(rng.standard_normal((BATCH, n, c)).astype(np.float32)
                                       ).to(device)
                x = x32.to(dt)
                with gelu_tanh() if tanh else contextlib.nullcontext():
                    blk = int8_block(rng, c, heads, mixer, hw, x32, device, dt)
                    blk.attn_int8 = attn_int8
                    with torch.inference_mode():
                        out_k = _launch_twice(f"{label}int8 {name}", lambda: blk(x))
                        ms = cuda_ms(lambda: blk(x), 5)
                        if tanh:
                            with gelu_off():
                                ms9 = cuda_ms(lambda: blk(x), 5)
                            tot["ms_degree9"] += count * ms9
                        print_int8_launches(lambda: blk(x))
                        blk.plain = True
                        out_p = blk(x)
                        plain_ms = cuda_ms(lambda: blk(x), 3)
                        with mock.patch.object(svtr_block, "_q8", float_products_q8):
                            out_c = blk(x)
                        blk.plain = False
                        yardstick = library_block_int8(x, blk,
                                                       approximate="tanh" if tanh else "none")
                        lib_ms = cuda_ms(yardstick, 5)
                        if dt == torch.bfloat16 and not attn_int8 and not tanh:
                            yardsticks.append(yardstick)
                pairs = n * n if blk.mask is None else int((blk.mask == 0).sum())
                plan = svtr_block._Plan(n, blk.mask, blk.band, device)
                bytes_ms, ops_ms = int8_block_bound_ms(BATCH, n, c, heads, 4 * c, dt, pairs,
                                                       attn_int8, plan.width)
                bound = max(bytes_ms, ops_ms)
                err = check_int8(f"{label}int8 {name} {str(dt)[6:]} attn_int8={attn_int8} "
                                 f"[{BATCH},{n},{c}] qb {plan.qb} width {plan.width}",
                                 out_k, out_p, out_c, dt)
                print(f"    ms {ms:.3f}" + (f" (degree 9 {ms9:.3f})" if tanh else "")
                      + f"  plain_ms {plain_ms:.3f}  library_ms {lib_ms:.3f}  "
                      f"bound_ms {bound:.4f} ({'operations' if ops_ms >= bytes_ms else 'bytes'}, "
                      f"{bound / ms:.1%} of bound); two launches bitwise equal; "
                      + _block_plan_text(svtr_block._int8_kernel_plan(
                          dt, attn_int8, n, c, heads, 4 * c, plan.qb, plan.width)))
                for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                                 ("bound_ms", bound), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                    tot[key] += count * val
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
            print(f"  {label}int8 Blocks, one expert's 12, {str(dt)[6:]} attn_int8={attn_int8}, "
                  f"batch {BATCH}: " + ", ".join(f"{k} {v:.4g}" for k, v in tot.items()))
            totals[(dt, attn_int8)] = tot
    if yardsticks:
        with torch.inference_mode():
            profile_int8_yardstick(yardsticks)
    return totals


def _served_blocks(srv, images):
    """(Block, input, output) of every Block in one ``srv.forward`` of
    ``images``, and that forward's output."""
    served = []
    hooks = [m.register_forward_hook(lambda m, a, o: served.append((m, a[0], o)))
             for m in srv.model.modules() if isinstance(m, Block)]
    try:
        out = srv.forward(images)
    finally:
        for h in hooks:
            h.remove()
    return served, out


def check_served_int8_blocks(what, srv, images, dt):
    """Serves ``images`` and holds each int8 Block, on the input it was
    served, against its plain version beside the float-products control
    (``check_int8``).  Returns the served logits (float32)."""
    served, out = _served_blocks(srv, images)
    with torch.inference_mode():
        for i, (blk, x, out_i) in enumerate(served):
            blk.plain = True
            ref = blk(x)
            with mock.patch.object(svtr_block, "_q8", float_products_q8):
                control = blk(x)
            blk.plain = False
            check_int8(f"{what} served Block {i} [{','.join(map(str, x.shape))}]", out_i, ref,
                       control, dt)
    return out["logits"].float()


def int8_logits_vs_plain(what, srv, images, dtype, out_k, out_f=None):
    """The served int8 logits ``out_k`` of ``images`` against the plain
    versions' (``configure_blocks(plain=True)``) beside the float-products
    control: their mean |diff| at most INT8_LOGIT_MEAN_SHARE of the
    control's, and every greedy pick whose top-2 margin exceeds INT8_TIE
    the same; ``out_f`` (the float server's logits) is printed beside.
    Returns whether it holds."""
    dt = getattr(torch, dtype)
    configure_blocks(srv.model, plain=True)
    out_p = srv.forward(images)["logits"].float()
    with mock.patch.object(svtr_block, "_q8", float_products_q8):
        out_c = srv.forward(images)["logits"].float()
    configure_blocks(srv.model, plain=False)
    share, delta, _ = flip_share(out_k, out_p, dt)
    c_share, c_delta, _ = flip_share(out_c, out_p, dt)
    mean, c_mean = float((out_k - out_p).abs().mean()), float((out_c - out_p).abs().mean())
    top2 = out_p.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > INT8_TIE[dtype]
    agree = out_k.argmax(-1) == out_p.argmax(-1)
    ok = mean <= INT8_LOGIT_MEAN_SHARE * c_mean and bool(agree[decided].all())
    vs_float = "" if out_f is None else \
        f", int8 vs float {dtype} {float((out_p - out_f).abs().max()):.3e}"
    print(f"  {what} logits, kernel vs plain: mean |diff| {mean:.3e}, "
          f"{mean / c_mean:.3f} of the float-products control's {c_mean:.3e} (tol "
          f"{INT8_LOGIT_MEAN_SHARE:g}); {share:.2%} beyond float noise (control {c_share:.2%}), "
          f"max |diff| {delta:.3e} (control {c_delta:.3e}{vs_float}); greedy picks agree on "
          f"{int(agree.sum())}/{agree.numel()} steps, all {int(decided.sum())} with a top-2 "
          f"margin above {INT8_TIE[dtype]:g} "
          f"{'agree' if bool(agree[decided].all()) else 'DISAGREE'} {'ok' if ok else 'FAILED'}")
    return ok


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
        out_k = check_served_int8_blocks(f"int8 {dtype}", srv, images, dt)
        shape = (BATCH, base.imgW // 4, CLASS_COUNTS[0])
        if tuple(out_k.shape) != shape or not bool(torch.isfinite(out_k).all()):
            raise RuntimeError(f"int8 logits {tuple(out_k.shape)} != {shape} or not finite")
        if not int8_logits_vs_plain(f"int8 {dtype}", srv, images, dtype, out_k,
                                    floats[dtype].forward(images)["logits"].float()):
            failed.append(dtype)
        words = [w for w, _ in results[dtype]]
        float_words = [w for w, _ in floats[dtype].recognize(images)]
        ned = float(np.mean([metrics.ned_score(w, f) for w, f in zip(words, float_words)]))
        print(f"  int8 {dtype} vs float {dtype} on the same weights (random: information, not "
              f"accuracy): word agreement {metrics.word_accuracy(words, float_words):.2f}%, "
              f"mean NED {ned:.4f}")
    if failed:
        raise RuntimeError(f"int8 {failed}: served logits disagree with the plain path")
    return launches, servers["bfloat16"], images


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
    """Random TRBA (and CRNN, GRCNN) weights in the JAX init distributions
    hardly tell crops apart: each U(+-1/sqrt(fan_in)) conv shrinks its input's second moment
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


def device_trace():
    """``torch.profiler`` over the card's activity only, for
    ``print_device_profile``, which reads device events: the CPU operators'
    records would add their own host time to the traced window and take
    seconds to gather after it."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA], acc_events=True)


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


def _random_trees(rng, base, images, class_counts=None):
    """Random full-width trees of ``base``'s stages in the JAX init
    distributions: an MRN ensemble over ``class_counts``, else one
    recognizer of ``CLASS_COUNTS[0]`` classes; a TPS's ``localization_fc2``
    perturbed (TRBA_FC2_SCALE) and the model calibrated on ``images`` in
    float32 (``calibrate_random_trba``).  Returns (params, batch_stats,
    characters)."""
    n_classes = max(class_counts or CLASS_COUNTS[:1])
    specials = 5 if base.Prediction == "Attn" else 4
    chars = [chr(0x4E00 + i) for i in range(n_classes - specials)]
    if class_counts:
        params, stats = random_mrn(rng, base, class_counts)
        expert = params["experts"]
    else:
        params, stats = random_recognizer(rng, base, n_classes)
        expert = params
    if base.Transformation == "TPS":
        fc2 = expert["extractor"]["transformation"]["localization"]["localization_fc2"]
        fc2["kernel"] = (TRBA_FC2_SCALE * rng.standard_normal(fc2["kernel"].shape)
                         ).astype(np.float32)
    calib = Server(base.replace(compute_dtype="float32"), params, stats, chars,
                   class_counts=class_counts)
    x = calib.images(images)
    calibrate_random_trba(calib.model, x, calib.sos_column(x))
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
    params, stats, chars = _random_trees(rng, base, images, CLASS_COUNTS)
    servers = {dtype: Server(base.replace(compute_dtype=dtype), params, stats, chars,
                             class_counts=CLASS_COUNTS) for dtype in TRBA_REQUESTS}
    params, stats, chars = _random_trees(rng, base, images)
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

    for dtype, srv in servers.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with device_trace() as prof:
            t0 = time.perf_counter()
            srv.recognize(images)
            wall = time.perf_counter() - t0
        print_device_profile(f"TRBA {dtype}, one request", prof, wall)
        print(f"    peak device memory of the request {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB (weights of both servers included)")
    return launches, timings, grids, torch.from_numpy(images).cuda(), single


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


# ------------------------------------------------------------ TRBA training
def _routed_tf(learner, images):
    """The learner's "TF" ensemble output on ``images`` (greedy from [SOS])."""
    with torch.no_grad():
        return learner._eval_ensemble()(images, learner._sos_column(images), is_train=False)


def _trba_step_pair(what, learner, model, batch, grad_key, optimizer, tol=TRBA_STEP_TOL):
    """One training step of ``learner`` from the same weights, batch and
    DropPath masks on the kernels (the TPS warp, the SVTR Blocks') and
    forced through their plain versions: the loss, the global grad norm
    and the gradient ``grad_key`` within ``tol``.  ``model`` holds the
    trained weights, ``optimizer()`` rebuilds the optimizer."""
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gen_state = learner.generator.get_state()
    captured = {}

    def keep_grad(grads):
        captured["g"] = grads[grad_key].detach().clone()
        return grads

    learner.grad_transform = lambda: keep_grad
    results = []
    for plain in (False, True):
        model.load_state_dict(start)
        learner.generator.set_state(gen_state)
        optimizer()
        warp = (mock.patch.object(tps, "grid_sample", grid_sample.grid_sample_reference)
                if plain else contextlib.nullcontext())
        configure_blocks(model, plain=plain)
        with warp:
            metrics = learner.train_step(batch)
        configure_blocks(model, plain=False)
        results.append((float(metrics["loss"]), float(metrics["grad_norm"]), captured["g"]))
    model.load_state_dict(start)
    learner.grad_transform = lambda: None
    optimizer()
    (lk, gk, fk), (lp, gp, fp) = results
    loss_rtol, norm_rtol, share = tol
    largest = float(fp.abs().max())
    dg = float((fk - fp).abs().max())
    print(f"  {what}: loss {lk:.7f} vs {lp:.7f} (rel {abs(lk - lp) / abs(lp):.2e}, tol "
          f"{loss_rtol:g}), grad_norm {gk:.6f} vs {gp:.6f} (rel {abs(gk - gp) / gp:.2e}, tol "
          f"{norm_rtol:g}), {grad_key} grad max |diff| {dg:.3e} of max |grad| {largest:.3e} "
          f"(tol {share:g} of it)")
    if not all(np.isfinite(v) for v in (lk, lp, gk, gp)) or abs(lk - lp) > loss_rtol * abs(lp) \
            or abs(gk - gp) > norm_rtol * gp or dg > share * largest:
        raise RuntimeError(f"{what}: the kernel and plain warps' steps disagree")


def _trba_window(learner, get_batch, n_warm, n_steps):
    """A ``StepMeter`` window of ``n_steps`` steps after ``n_warm``, synced
    at both ends; returns (mean step s, warp launches in the window)."""
    for _ in range(n_warm):
        learner.train_step(get_batch())
    torch.cuda.synchronize()
    launches = grid_sample.launches
    meter = StepMeter()
    for _ in range(n_steps):
        meter.tick(BATCH)
        learner.train_step(get_batch())
    torch.cuda.synchronize()
    return meter.seconds() / n_steps, grid_sample.launches - launches


def phase_trba_train(rng, out_dir):
    """This slice's path: TRBA-MRN training of ``configs/trba_mrn.py`` at
    full width, bf16, batch 256, on task 2 of 3 (2 frozen random TRBA
    experts and the new one; crops and labels of the campaign suite's first
    three alphabets) through ``MRN.incremental_train``, validated on one
    batch, counting warp launches (none in a step-0 step, one per expert in
    a step-1 step, 1 per FF and 3 per TF batch); checks (a)-(d) and the
    step windows.  Returns the counted launches."""
    t0 = time.perf_counter()
    alphabets = campaign.task_alphabets()[:TRBA_TRAIN_TASK + 1]
    character = "".join(alphabets)
    counts = [build_converter("Attn", "".join(alphabets[:t + 1])).num_classes
              for t in range(TRBA_TRAIN_TASK + 1)]
    loader = SyntheticTaskLoader(alphabets, TRBA_TRAIN_TASK, BATCH, CROPS_PER_TASK,
                                 img_h=32, img_w=256, seed=SEED)
    val_set = synthetic_val_set(alphabets, TRBA_TRAIN_TASK, BATCH, 32, 256, seed=SEED + 1)
    base = load_config(os.path.join(ROOT, "configs", "trba_mrn.py"), output_dir=out_dir,
                       data_log=os.path.join(out_dir, "data_trba.txt"), exp_name="trba_train",
                       num_iter=TRBA_TRAIN_ITERS, val_interval=TRBA_VAL_INTERVAL,
                       train_dtype="bf16", image_bank=loader.bank, manual_seed=SEED)
    valid = ValDataset(["val"], base, {"val": val_set}.__getitem__)
    learner = MRN(base)
    for count in counts[:-1]:
        learner.add_expert(*random_recognizer(rng, base, count), count)
    print(f"  {len(loader.labels)} crops, class counts {counts}, 2 frozen experts drawn in "
          f"{time.perf_counter() - t0:.1f} s")

    # (c) hooks: the frozen experts as step 1 starts, the warp launches of step 0
    seen = {}
    start_router = learner.start_router_phase

    def recorded_start(router=None):
        seen["step0_launches"] = grid_sample.launches
        start_router(router)
        seen["experts"] = {k: v.clone() for k, v in learner.mrn_model.experts.state_dict().items()}
        seen["expert_states"] = [{k: v.clone() for k, v in s.items()}
                                 for s in learner.expert_states]

    learner.start_router_phase = recorded_start
    # ---- counted run: the main path, through the entry point
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid_sample.launches = 0
    learner.incremental_train(TRBA_TRAIN_TASK, character, loader, valid)
    torch.cuda.synchronize()
    launches = grid_sample.launches
    run_s = time.perf_counter() - t0
    n0, n1 = TRBA_TRAIN_ITERS, TRBA_TRAIN_ITERS // 2
    ff = val_points(n0, TRBA_VAL_INTERVAL)
    tf = val_points(n1, max(1, TRBA_VAL_INTERVAL // 5))
    n_exp = TRBA_TRAIN_TASK + 1
    expected0, expected1 = ff, n_exp * n1 + n_exp * tf
    got0 = seen["step0_launches"]
    print(f"  incremental_train of task {TRBA_TRAIN_TASK} in {run_s:.1f} s; warp launches: "
          f"step 0 {got0} (expected {expected0} = {n0} steps x 0 + {ff} FF batches x 1), "
          f"step 1 {launches - got0} (expected {expected1} = {n1} steps x {n_exp} + {tf} TF "
          f"batches x {n_exp})")
    if (got0, launches - got0) != (expected0, expected1):
        raise RuntimeError("the TRBA training path did not run through the warp kernel as "
                           "expected")
    for rec in learner.history:
        print(f"  task {rec['task']} step {rec['step']} iter {rec['iteration']}: loss "
              f"{rec['loss']:.5f}" + (f" (clf {rec['clf']:.5f}, router {rec['router']:.5f})"
                                      if "clf" in rec else "")
              + f", grad_norm {rec['grad_norm']:.4g}, {1e3 * rec['seconds']:.1f} ms/step over "
              f"its window")
    if not all(np.isfinite(rec["loss"]) for rec in learner.history) \
            or len(learner.history) != n0 + n1:
        raise RuntimeError("TRBA training: non-finite loss or missing steps")

    # ---- (c) step 1 left the frozen experts bitwise; step 0 moved the statistics
    after = learner.mrn_model.experts.state_dict()
    same = all(torch.equal(v, after[k]) for k, v in seen["experts"].items()) and all(
        torch.equal(v, s[k]) for old, s in zip(seen["expert_states"], learner.expert_states)
        for k, v in old.items())
    loc = "extractor.transformation.localization.bn0."
    new = learner.expert_states[-1]
    moved = (float(new[loc + "mean"].abs().max()), float((new[loc + "var"] - 1).abs().max()))
    print(f"  (c) step 1: the {n_exp} frozen experts bitwise unchanged: {same}; step 0: the new "
          f"expert's localization bn0 running mean moved {moved[0]:.3e}, var {moved[1]:.3e} "
          f"from their init")
    if not same or min(moved) <= 0.0:
        raise RuntimeError("(c) frozen experts changed in step 1 or step 0 moved no statistics")

    # ---- (a) one step-1 step, kernel warp against plain warp
    batch2 = loader.get_batch2()
    _trba_step_pair("(a) bf16 step-1 step, kernel vs plain warp", learner, learner.mrn_model,
                    batch2, "channel_route.kernel",
                    lambda: learner.build_optimizer(scale=1.0, the=2))

    # ---- (b) FF and TF validation logits, kernel against plain
    images = learner._device_images(loader.get_batch()[0])
    sos = learner._sos_column(images)
    count = grid_sample.launches
    with torch.no_grad():
        ff_k = learner.model(images, sos, train=False)["predict"]
        tf_k = _routed_tf(learner, images)
    launched = grid_sample.launches - count
    with mock.patch.object(tps, "grid_sample", grid_sample.grid_sample_reference), \
            torch.no_grad():
        ff_p = learner.model(images, sos, train=False)["predict"]
        tf_p = _routed_tf(learner, images)
    print(f"  (b) one FF and one TF batch launched the warp {launched} times (expected "
          f"{1 + n_exp})")
    if launched != 1 + n_exp:
        raise RuntimeError("(b) the validation forwards did not launch the warp as expected")
    atol, rtol = TRBA_LOGIT_TOL[torch.float32]
    ff_err, _ = check_greedy("(b) FF logits, kernel vs plain warp", ff_k, ff_p,
                             torch.full((BATCH,), counts[-1], device=ff_p.device), atol, rtol)
    agree = tf_k["index"] == tf_p["index"]
    print(f"  (b) TF expert picks agree on {int(agree.sum())}/{BATCH} crops")
    if not bool(agree.all()):
        raise RuntimeError("(b) TF expert picks differ between the kernel and plain warps")
    tf_counts = torch.tensor(counts, device=tf_p["index"].device)[tf_p["index"]]
    tf_err, _ = check_greedy("(b) TF logits, kernel vs plain warp", tf_k["logits"],
                             tf_p["logits"], tf_counts, atol, rtol)

    # ---- windows: step 1, then step 0 (with (c)'s grid gradient and a trace)
    w1, l1 = _trba_window(learner, loader.get_batch2, TRBA_WARMUP, TRBA_WINDOW)
    learner.change_model()
    learner.build_optimizer()
    grid_grads = []

    def recording_warp(image, grid):
        grid.register_hook(lambda g: grid_grads.append(g.detach().float()))
        return grid_sample.grid_sample_train(image, grid)

    with mock.patch.object(tps, "grid_sample_train", recording_warp):
        learner.train_step(loader.get_batch())
    g = grid_grads[0]
    print(f"  (c) step 0: TPS grid gradient finite {bool(torch.isfinite(g).all())}, max |grad| "
          f"{float(g.abs().max()):.3e}")
    if not bool(torch.isfinite(g).all()) or float(g.abs().max()) <= 0.0:
        raise RuntimeError("(c) the step-0 TPS grid gradient is not finite and non-zero")
    w0, l0 = _trba_window(learner, loader.get_batch, TRBA_WARMUP, TRBA_WINDOW)
    print(f"  StepMeter windows of {TRBA_WINDOW} steps after {TRBA_WARMUP} warm-up steps, bf16, "
          f"batch {BATCH}: step 0 {1e3 * w0:.2f} ms/step ({BATCH / w0:.1f} images/s, {l0} warp "
          f"launches), step 1 {1e3 * w1:.2f} ms/step ({BATCH / w1:.1f} images/s, {l1} warp "
          f"launches)")
    if (l0, l1) != (0, n_exp * TRBA_WINDOW):
        raise RuntimeError("the step windows did not launch the warp as expected")
    with device_trace() as prof:
        t1 = time.perf_counter()
        for _ in range(TRACE_STEPS):
            learner.train_step(loader.get_batch())
        torch.cuda.synchronize()
        traced = time.perf_counter() - t1
    idle = print_device_profile(f"bf16 TRBA step 0, {TRACE_STEPS} steps", prof, traced)
    print(f"  idle share of the traced step-0 window: "
          f"{'not measured' if idle is None else f'{idle:.1%}'}")
    del learner

    # ---- (d) one WA step at task 1: the teacher-forced old network warps once
    wa = WA(base.replace(il="wa", exp_name="trba_wa"))
    wa.character = list(alphabets[0])
    wa.converter = wa.build_converter()
    wa._set_model(*random_recognizer(rng, base, counts[0]))
    wa._cur_task = 0
    wa.after_task()
    wa._cur_task, wa.character = 1, list(alphabets[0] + alphabets[1])
    wa.converter = wa.build_converter()
    wa.change_model()
    wa.build_optimizer()
    batch = loader.get_batch()
    count = grid_sample.launches
    metrics = wa.train_step(batch)
    torch.cuda.synchronize()
    wa_launches = grid_sample.launches - count
    print(f"  (d) WA task 1 step: loss {float(metrics['loss']):.5f}, kd "
          f"{float(metrics['kd']):.5f}; warp launches {wa_launches} (expected 1: the old "
          f"network's eval-mode TPS; the live model warps with the training warp)")
    if wa_launches != 1 or not float(metrics["kd"]) > 0.0:
        raise RuntimeError("(d) the WA step's old network did not warp through the kernel once")
    _trba_step_pair("(d) bf16 WA step, kernel vs plain warp", wa, wa.model, batch, "fc.kernel",
                    wa.build_optimizer)
    return launches


# ------------------------------------------------------- CRNN, GRCNN, int8 convs
def _timed_requests(server, images, n):
    """``n`` requests through ``Server.recognize``; returns (seconds each,
    the last result)."""
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = server.recognize(images)
        ts.append(time.perf_counter() - t0)
        if len(result) != BATCH or not all(np.isfinite(c) for _, c in result):
            raise RuntimeError("recognize returned a malformed batch")
    return ts, result


def _print_requests(what, ts):
    print(f"  {what}: request seconds {[round(t, 4) for t in ts]}, crops/s "
          f"{[round(BATCH / t, 1) for t in ts]} (first request includes warm-up)")


def phase_crnn_serve(rng):
    """This slice's path: 6-expert CRNN-MRN serving of ``configs/crnn_mrn.py``
    at full width, bf16 and f32, counting launches of the port's kernels
    (none on this path), then the first CRNN_REF_CROPS crops against the
    same ensemble on the CPU in float32.  Returns the request times."""
    t0 = time.perf_counter()
    base = load_config(os.path.join(ROOT, "configs", "crnn_mrn.py"))
    images = rng.integers(0, 256, (BATCH, base.imgH, base.imgW, base.input_channel),
                          dtype=np.uint8)
    params, stats, chars = _random_trees(rng, base, images, CLASS_COUNTS)
    servers = {dtype: Server(base.replace(compute_dtype=dtype), params, stats, chars,
                             class_counts=CLASS_COUNTS) for dtype in CRNN_REQUESTS}
    torch.cuda.synchronize()
    print(f"  weights drawn, calibrated on the batch and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    reset_launches()
    grid_sample.launches = 0
    timings = {}
    for dtype, n_req in CRNN_REQUESTS.items():
        timings[dtype], result = _timed_requests(servers[dtype], images, n_req)
        _print_requests(f"CRNN-MRN {dtype}", timings[dtype])
        print(f"  {dtype}: sample words {[w for w, _ in result[:3]]}, "
              f"{len(set(w for w, _ in result))} distinct words in {BATCH}")
    launched = dict(read_launches(), grid_sample=grid_sample.launches)
    print(f"  port kernel launches in the CRNN requests: {launched} (expected none: the "
          f"VGG convs are cuDNN's, the BiLSTMs and the router PyTorch's)")
    if any(launched.values()):
        raise RuntimeError("the CRNN served path launched an SVTR or TRBA kernel")

    cpu = Server(base.replace(compute_dtype="float32"), params, stats, chars,
                 class_counts=CLASS_COUNTS, device="cpu")
    t0 = time.perf_counter()
    ref, ref_scores = _served_with_scores(cpu, images[:CRNN_REF_CROPS])
    print(f"  the CPU reference on {CRNN_REF_CROPS} crops in {time.perf_counter() - t0:.1f} s")
    shape = (BATCH, base.imgW // 4 - 1, max(CLASS_COUNTS))
    for dtype, srv in servers.items():
        out, scores = _served_with_scores(srv, images)
        if tuple(out["logits"].shape) != shape or not bool(torch.isfinite(out["logits"]).all()):
            raise RuntimeError(f"CRNN logits {tuple(out['logits'].shape)} != {shape} or not "
                               "finite")
        atol, rtol = CRNN_LOGIT_TOL[srv.dtype]
        err = check_close(f"CRNN {dtype} route scores vs the CPU",
                          scores[:CRNN_REF_CROPS].cpu(), ref_scores, atol, rtol)
        top2 = ref_scores.topk(2, dim=1).values
        near_tie = (top2[:, 0] - top2[:, 1]) <= 2 * err
        agree = out["index"][:CRNN_REF_CROPS].cpu() == ref["index"]
        print(f"  CRNN {dtype} on the card vs float32 on the CPU: expert picks agree on "
              f"{int(agree.sum())}/{CRNN_REF_CROPS}, {int(near_tie.sum())} near-ties (picks per "
              f"expert on the card {torch.bincount(out['index'], minlength=N_EXPERTS).tolist()})")
        if bool((~agree & ~near_tie).any()):
            raise RuntimeError(f"CRNN {dtype}: expert picks differ from the CPU reference "
                               "beyond near-ties")
        check_close(f"CRNN {dtype} served logits vs the CPU (same pick)",
                    out["logits"][:CRNN_REF_CROPS].cpu()[agree], ref["logits"][agree], atol, rtol)

    # ---- where a request's time goes

    for dtype, srv in servers.items():
        torch.cuda.synchronize()
        with device_trace() as prof:
            t0 = time.perf_counter()
            srv.recognize(images)
            wall = time.perf_counter() - t0
        print_device_profile(f"CRNN-MRN {dtype}, one request", prof, wall)
    del cpu, servers
    return timings


def _served_with_scores(server, images):
    """``Server.forward`` of ``images`` and the router's scores [B, I]."""
    scores = []
    hook = server.model.route.register_forward_hook(
        lambda mod, inp, out: scores.append(out[..., 0].float()))
    try:
        out = server.forward(images)
    finally:
        hook.remove()
    return {k: v.float() if k == "logits" else v for k, v in out.items()}, scores[0]


def _window(learner, get_batch, n_warm, n_steps):
    """A StepMeter window of ``n_steps`` steps after ``n_warm``; returns
    (mean step s, the steps' losses)."""
    for _ in range(n_warm):
        learner.train_step(get_batch())
    torch.cuda.synchronize()
    meter, losses = StepMeter(), []
    for _ in range(n_steps):
        meter.tick(BATCH)
        losses.append(learner.train_step(get_batch())["loss"])
    torch.cuda.synchronize()
    seconds = meter.seconds()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"a non-finite loss in a step window: {losses}")
    return seconds / n_steps, losses


def _expert_buffers(model):
    return {k: v.clone() for k, v in model.experts.named_buffers()}


def phase_crnn_train(rng, out_dir):
    """This slice's path: CRNN-MRN training of ``configs/crnn_mrn.py`` at full
    width, batch 256, task TRAIN_TASK of 6 (5 frozen random CRNN experts
    and the new one) through ``MRN.incremental_train``, bf16 and f32; the
    frozen experts' statistics bitwise unchanged in step 1 (pinned); step
    windows and a traced bf16 step-0 window; then one router step in the
    drifting mode (``mrn_pin_expert_stats=False``), whose experts'
    statistics move.  Returns {dtype: (step 0 s, step 1 s)}."""
    t0 = time.perf_counter()
    alphabets = _task_alphabets()
    character = "".join(alphabets)
    loader = SyntheticTaskLoader(alphabets, TRAIN_TASK, BATCH, CROPS_PER_TASK, img_h=32,
                                 img_w=256, seed=SEED)
    val_set = synthetic_val_set(alphabets, TRAIN_TASK, BATCH, 32, 256, seed=SEED + 1)
    base = load_config(os.path.join(ROOT, "configs", "crnn_mrn.py"), output_dir=out_dir,
                       data_log=os.path.join(out_dir, "data_crnn.txt"), exp_name="crnn_train",
                       num_iter=CRNN_TRAIN_ITERS, val_interval=CRNN_VAL_INTERVAL,
                       image_bank=loader.bank, manual_seed=SEED)
    valid = ValDataset(["val"], base, {"val": val_set}.__getitem__)
    experts = [random_recognizer(rng, base, count) for count in CLASS_COUNTS[:TRAIN_TASK]]
    print(f"  {len(loader.labels)} crops, {TRAIN_TASK} frozen experts drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    windows = {}
    for dtype in TRAIN_DTYPES:
        opt = base.replace(train_dtype=dtype, exp_name=f"crnn_{dtype}")
        learner = MRN(opt)
        for (p, s), count in zip(experts, CLASS_COUNTS):
            learner.add_expert(p, s, count)
        seen = {}
        start_router = learner.start_router_phase

        def recorded_start(router=None, learner=learner, start_router=start_router):
            start_router(router)
            seen["experts"] = _expert_buffers(learner.mrn_model)

        learner.start_router_phase = recorded_start
        reset_launches()
        grid_sample.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learner.incremental_train(TRAIN_TASK, character, loader, valid)
        torch.cuda.synchronize()
        launched = dict(read_launches(), grid_sample=grid_sample.launches)
        for rec in learner.history:
            print(f"  {dtype} task {rec['task']} step {rec['step']} iter {rec['iteration']}: "
                  f"loss {rec['loss']:.5f}" + (f" (clf {rec['clf']:.5f}, router "
                                               f"{rec['router']:.5f})" if "clf" in rec else "")
                  + f", grad_norm {rec['grad_norm']:.4g}")
        n0, n1 = CRNN_TRAIN_ITERS, CRNN_TRAIN_ITERS // 2
        if not all(np.isfinite(rec["loss"]) for rec in learner.history) \
                or len(learner.history) != n0 + n1:
            raise RuntimeError(f"CRNN {dtype} training: non-finite loss or missing steps")
        after = _expert_buffers(learner.mrn_model)
        pinned = all(torch.equal(v, after[k]) for k, v in seen["experts"].items())
        print(f"  {dtype}: incremental_train of task {TRAIN_TASK} in "
              f"{time.perf_counter() - t0:.1f} s; port kernel launches {launched} (expected "
              f"none); step 1 left the {N_EXPERTS} experts' statistics bitwise unchanged "
              f"(pinned): {pinned}")
        if any(launched.values()) or not pinned:
            raise RuntimeError(f"CRNN {dtype}: a port kernel ran or a pinned expert's "
                               "statistics moved")
        w1, _ = _window(learner, loader.get_batch2, TIME_WARMUP, TIME_STEPS)
        learner.change_model()
        learner.build_optimizer()
        w0, _ = _window(learner, loader.get_batch, TIME_WARMUP, TIME_STEPS)
        windows[dtype] = (w0, w1)
        print(f"  CRNN {dtype} StepMeter windows of {TIME_STEPS} steps after {TIME_WARMUP} "
              f"warm-up steps, batch {BATCH}: step 0 {1e3 * w0:.2f} ms/step ({BATCH / w0:.1f} "
              f"images/s), step 1 over {N_EXPERTS} experts {1e3 * w1:.2f} ms/step "
              f"({BATCH / w1:.1f} images/s)")
        if dtype == "bf16":
            with device_trace() as prof:
                t1 = time.perf_counter()
                for _ in range(TRACE_STEPS):
                    learner.train_step(loader.get_batch())
                torch.cuda.synchronize()
                traced = time.perf_counter() - t1
            idle = print_device_profile(f"bf16 CRNN step 0, {TRACE_STEPS} steps", prof, traced)
            print(f"  idle share of the traced CRNN step-0 window: "
                  f"{'not measured' if idle is None else f'{idle:.1%}'}")
        last = learner
    # ---- one router step in the drifting mode over the f32 run's experts
    quirk = MRN(base.replace(mrn_pin_expert_stats=False, exp_name="crnn_quirk"))
    for state, count in zip(last.expert_states, last.class_counts):
        quirk.add_expert(*state_to_flax(state), count)
    quirk._cur_task = TRAIN_TASK
    quirk.character = list(character)
    quirk.converter = quirk.build_converter()
    quirk.start_router_phase()
    before = _expert_buffers(quirk.mrn_model)
    metrics = quirk.train_step(loader.get_batch2())
    torch.cuda.synchronize()
    after = _expert_buffers(quirk.mrn_model)
    moved = [k for k, v in before.items() if not torch.equal(v, after[k])]
    print(f"  drifting mode: one router step (loss {float(metrics['loss']):.5f}) moved "
          f"{len(moved)}/{len(before)} running-statistic tensors of the {N_EXPERTS} experts "
          f"(expected all: bn4 and bn5 mean and var of each)")
    if len(moved) != len(before) or len(before) != N_EXPERTS * 4:
        raise RuntimeError("the drifting mode's router step did not move every expert's "
                           "statistics")
    return windows


def phase_grcnn(rng):
    """``configs/grcnn_mrn.py`` at full width: one bf16 step-0 StepMeter
    window of a new expert (79 train-mode BatchNorms) and served requests
    of one recognizer.  Returns (step 0 s, request seconds)."""
    base = load_config(os.path.join(ROOT, "configs", "grcnn_mrn.py"), train_dtype="bf16",
                       manual_seed=SEED, exp_name="grcnn", output_dir=os.path.join(
                           ROOT, "build", "smoke_grcnn"))
    alphabet = _task_alphabets()[0]
    loader = SyntheticTaskLoader([alphabet], 0, BATCH, CROPS_PER_TASK, img_h=32, img_w=256,
                                 seed=SEED)
    learner = MRN(base.replace(image_bank=loader.bank))
    learner.character = list(alphabet)
    learner.converter = learner.build_converter()
    learner._cur_task = 0
    learner.build_model()
    learner.build_optimizer()
    w0, _ = _window(learner, loader.get_batch, TIME_WARMUP, GRCNN_WINDOW)
    print(f"  GRCNN bf16 step 0, StepMeter window of {GRCNN_WINDOW} steps after "
          f"{TIME_WARMUP} warm-up steps: {1e3 * w0:.2f} ms/step ({BATCH / w0:.1f} images/s)")
    images = loader.bank[loader.get_batch()[0]]
    params, stats = to_flax(learner.model)
    server = Server(base.replace(compute_dtype="bfloat16"), params, stats, alphabet)
    ts, result = _timed_requests(server, images, 2)
    _print_requests("GRCNN recognizer bfloat16", ts)
    logits = server.forward(images)["logits"]
    if tuple(logits.shape) != (BATCH, base.imgW // 4 + 1, len(alphabet) + 4) \
            or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"GRCNN logits {tuple(logits.shape)} malformed or not finite")
    shutil.rmtree(base.output_dir, ignore_errors=True)
    return w0, ts


def _float_products_act(x, amax):
    """Control for the int8 conv checks: activations scaled into the int8
    range but not rounded."""
    scale = torch.clamp(torch.as_tensor(amax).float(), min=1e-12) / 127.0
    return torch.clamp(x.float() / scale, -127, 127), scale


def _float64_conv(x, w, stride=(1, 1), padding=(0, 0)):
    """Control for the int8 conv checks: the conv of unrounded activations."""
    return F.conv2d(x.permute(0, 3, 1, 2).double(), w.permute(3, 2, 0, 1).double(),
                    stride=tuple(stride), padding=tuple(padding)).permute(0, 2, 3, 1)


def _conv_geometries(model, images, text):
    """Each w8a8 conv's (NHWC input shape, HWIO kernel shape, stride,
    padding), in order of first use, from one served forward."""
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.setdefault(
            (tuple(args[0].permute(0, 2, 3, 1).shape), tuple(m.Conv_0.weight.permute(
                2, 3, 1, 0).shape), tuple(m.Conv_0.stride), tuple(m.Conv_0.padding)), None))
        for m in model.modules() if isinstance(m, TorchConv) and m.quant == "int8"]
    try:
        with torch.inference_mode():
            model(images, text)
    finally:
        for h in hooks:
            h.remove()
    return list(seen)


def check_int8_convs(what, geometries, g):
    """``torch._int_mm`` conv against its float64 plain version, bitwise, at
    each geometry on random int8 operands; prints both times."""
    for x_shape, w_shape, stride, padding in geometries:
        x = torch.randint(-127, 128, x_shape, generator=g, dtype=torch.int8, device="cuda")
        w = torch.randint(-127, 128, w_shape, generator=g, dtype=torch.int8, device="cuda")
        got = int8.conv_int8(x, w, stride, padding)
        ref = int8.conv_int8_reference(x, w, stride, padding)
        same = torch.equal(got, ref)
        ms = cuda_ms(lambda: int8.conv_int8(x, w, stride, padding), 3)
        plain_ms = cuda_ms(lambda: int8.conv_int8_reference(x, w, stride, padding), 3)
        print(f"  {what} int8 conv {list(x_shape)} x {list(w_shape)} stride {stride} pad "
              f"{padding}: _int_mm {ms:.3f} ms, float64 plain {plain_ms:.3f} ms, bitwise "
              f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise RuntimeError(f"{what}: the _int_mm conv disagrees with its float64 version")


def phase_int8_convs(rng):
    """The w8a8 conv path: one CRNN and one TRBA recognizer at full width
    (``configs/crnn_mrn.py``, ``configs/trba_mrn.py``; the GRCNN's convs
    too) quantized by ``serve.quantize_int8`` on INT8_CALIB_BATCHES
    batches; every conv geometry of VGG, ResNet and RCNN at batch 256 held
    bitwise against the float64 plain conv; INT8_CONV_REQUESTS requests per
    dtype of the float and the int8 servers, counting ``_int_mm`` convs and
    TPS warp launches; the served int8 logits against the plain convs'
    beside the float-products control (``check_int8``).  Returns the warp
    launches of the counted int8 requests."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    warp_launches = 0
    for name, config in (("CRNN", "crnn_mrn.py"), ("TRBA", "trba_mrn.py"),
                         ("GRCNN", "grcnn_mrn.py")):
        t0 = time.perf_counter()
        base = load_config(os.path.join(ROOT, "configs", config))
        images = rng.integers(0, 256, (BATCH, base.imgH, base.imgW, base.input_channel),
                              dtype=np.uint8)
        calib = [rng.integers(0, 256, images.shape, dtype=np.uint8)
                 for _ in range(INT8_CALIB_BATCHES)]
        params, stats, chars = _random_trees(rng, base, images)
        floats, servers = {}, {}
        for dtype in ("float32", "bfloat16"):
            opt = base.replace(compute_dtype=dtype)
            floats[dtype] = Server(opt, params, stats, chars)
            servers[dtype] = quantize_int8(Server(opt, params, stats, chars), iter(calib),
                                           n_batches=INT8_CALIB_BATCHES)
        torch.cuda.synchronize()
        n_convs = sum(isinstance(m, TorchConv) and m.quant == "int8"
                      for m in servers["float32"].model.modules())
        print(f"  {name}: drawn, calibrated on {INT8_CALIB_BATCHES} batches and quantized "
              f"({n_convs} int8 convs) in {time.perf_counter() - t0:.1f} s")
        srv = servers["float32"]
        x = srv.images(images)
        geometries = _conv_geometries(srv.model, x, srv.sos_column(x))
        check_int8_convs(name, geometries, g)
        if name == "GRCNN":
            continue
        # ---- counted requests, float and int8
        for dtype in ("float32", "bfloat16"):
            ts, _ = _timed_requests(floats[dtype], images, INT8_CONV_REQUESTS)
            _print_requests(f"{name} float {dtype}", ts)
            before, launches = int8.int_mm_convs, grid_sample.launches
            ts, result = _timed_requests(servers[dtype], images, INT8_CONV_REQUESTS)
            convs = int8.int_mm_convs - before
            warps = grid_sample.launches - launches
            warp_launches += warps
            _print_requests(f"{name} int8 {dtype}", ts)
            expect_warps = INT8_CONV_REQUESTS if name == "TRBA" else 0
            print(f"  {name} int8 {dtype}: {convs} _int_mm convs (expected "
                  f"{INT8_CONV_REQUESTS * n_convs} = {INT8_CONV_REQUESTS} requests x {n_convs}), "
                  f"{warps} TPS warp launches (expected {expect_warps}); sample words "
                  f"{[w for w, _ in result[:3]]}")
            if convs != INT8_CONV_REQUESTS * n_convs or warps != expect_warps:
                raise RuntimeError(f"{name} int8 {dtype}: the served path did not run the "
                                   "int8 convs or the warp kernel as expected")
            # ---- the same batch on the plain convs, and the control
            with torch.inference_mode():
                out_k = servers[dtype].forward(images)["logits"].float()
                with mock.patch.object(int8, "conv_int8", int8.conv_int8_reference):
                    out_p = servers[dtype].forward(images)["logits"].float()
                with mock.patch.object(int8, "quantize_act", _float_products_act), \
                        mock.patch.object(int8, "conv_int8", _float64_conv):
                    out_c = servers[dtype].forward(images)["logits"].float()
                out_f = floats[dtype].forward(images)["logits"].float()
            check_int8(f"{name} int8 {dtype} served logits, _int_mm vs plain convs", out_k,
                       out_p, out_c, getattr(torch, dtype))
            print(f"  {name} int8 {dtype} vs float {dtype}: max |diff| of the logits "
                  f"{float((out_k - out_f).abs().max()):.3e}, greedy picks agree on "
                  f"{float((out_k.argmax(-1) == out_f.argmax(-1)).float().mean()):.2%} of the "
                  f"steps (random weights: information)")
        del floats, servers
    return warp_launches


# ------------------------------------------------- the tanh-GELU serving mode
def phase_gelu_tanh(device, servers, images, base):
    """The tanh-GELU serving mode: the 6-expert SVTR-MRN servers of the
    serving phase and one int8 SVTR recognizer calibrated with the switch
    on, served through ``Server.recognize`` with the switch on (counted);
    every served Block against its plain version on its own input (row 4 at
    BLOCK_TOL, row 3 beside its control), the routed outputs against the
    plain path, the greedy picks against the degree-9 form on the same
    batch (bench.py's gelu-approx agreement); then the Blocks alone
    (``phase_blocks`` and ``phase_int8_blocks`` in the tanh form).  Returns
    (row-4 launches, row-3 launches, and the two Blocks' totals)."""
    rng = np.random.default_rng(TANH_SEED)
    alphabet = _task_alphabets()[0]
    params, stats = random_recognizer(rng, base, CLASS_COUNTS[0])
    loader = SyntheticTaskLoader([alphabet], 0, BATCH, BATCH * (INT8_CALIB_BATCHES + 1),
                                 img_h=base.imgH, img_w=base.imgW, seed=TANH_SEED)
    calib = [loader.bank[loader.get_batch()[0]] for _ in range(INT8_CALIB_BATCHES)]
    int8_images = loader.bank[loader.get_batch()[0]]
    with gelu_tanh():
        int8_srv = quantize_int8(Server(base.replace(compute_dtype="bfloat16"), params, stats,
                                        alphabet), iter(calib), n_batches=INT8_CALIB_BATCHES)
        torch.cuda.synchronize()

        # ---- counted run: the main path with the switch on, through the entry points
        svtr_block.launches = svtr_block.int8_launches = 0
        for dtype, n_req in TANH_REQUESTS.items():
            ts, result = _timed_requests(servers[dtype], images, n_req)
            _print_requests(f"tanh-GELU SVTR-MRN {dtype}", ts)
        ts, _ = _timed_requests(int8_srv, int8_images, TANH_INT8_REQUESTS)
        _print_requests("tanh-GELU int8 SVTR recognizer bfloat16", ts)
        launches, int8_launches = svtr_block.launches, svtr_block.int8_launches
        expected = (sum(TANH_REQUESTS.values()) * N_EXPERTS * 12, TANH_INT8_REQUESTS * 12)
        print(f"  tanh-form launches in the served requests: row 4 {launches}, row 3 "
              f"{int8_launches} (expected {expected[0]} = {sum(TANH_REQUESTS.values())} requests x "
              f"{N_EXPERTS} experts x 12 Blocks, {expected[1]} = {TANH_INT8_REQUESTS} x 12)")
        if (launches, int8_launches) != expected:
            raise RuntimeError("the tanh-GELU served path did not run through the kernels "
                               "as expected")

        # ---- each served Block on its own input, the routed outputs, the int8 Blocks
        with torch.inference_mode():
            for dtype, srv in servers.items():
                err = 0.0
                for blk, x, out in _served_blocks(srv, images)[0]:
                    blk.plain = True
                    ref = blk(x)
                    blk.plain = False
                    tol = BLOCK_TOL[srv.dtype]
                    if not bool(((out.float() - ref.float()).abs()
                                 <= tol[0] + tol[1] * ref.float().abs()).all()):
                        check_close(f"tanh {dtype} served Block {tuple(x.shape)}", out, ref, *tol)
                    err = max(err, float((out.float() - ref.float()).abs().max()))
                print(f"  tanh {dtype}: each of the {N_EXPERTS * 12} served Blocks within "
                      f"BLOCK_TOL {BLOCK_TOL[srv.dtype]} of its plain version on its own input, "
                      f"max_abs_err {err:.3e}")
                routed_vs_plain(srv.model, srv.images(images), LOGIT_TOL[srv.dtype],
                                f"tanh {dtype}")
        check_served_int8_blocks("tanh int8 bfloat16", int8_srv, int8_images, torch.bfloat16)
        picks = {dtype: srv.eval_batch(images)["preds_index"] for dtype, srv in servers.items()}
        logits = {dtype: srv.forward(images)["logits"].float() for dtype, srv in servers.items()}
    for dtype, srv in servers.items():
        degree9 = srv.eval_batch(images)["preds_index"]
        delta = float((logits[dtype] - srv.forward(images)["logits"].float()).abs().max())
        print(f"  {dtype}: greedy picks of the tanh form agree with the degree-9 form's on "
              f"{float((picks[dtype] == degree9).mean()):.4f} of the steps (bench.py's "
              f"gelu-approx agreement; random weights), max |logit delta| {delta:.3e}")
    print("== tanh-form Block kernels vs plain, SVTR Block shapes")
    return (launches, int8_launches, phase_blocks(device, rng, GELU_TANH),
            phase_int8_blocks(device, rng, GELU_TANH))


# --------------------------------------------------------------- export phase
def dispatch_cost(device, rng):
    """Host microseconds per call of the fused-Block and warp custom ops
    against their CUDA implementations called directly, on tiny
    host-bound inputs, in turns (op, direct, direct, op)."""
    c = 64
    params = {k: torch.from_numpy(v).to(device) for k, v in random_block(rng, c).items()}
    x = torch.from_numpy(rng.standard_normal((1, 32, c)).astype(np.float32)).to(device)
    weights = list(svtr_block._fold(params, 0.25, torch.float32))
    image = torch.zeros((1, 8, 16, 4), device=device)
    grid = torch.zeros((1, 8, 16, 2), device=device)
    pairs = {"fused_block": (lambda: svtr_block._fused_block_op(x, weights, None, [], 2, 9),
                             lambda: svtr_block._fused_block_op_cuda(x, weights, None, [], 2, 9)),
             "grid_sample": (lambda: grid_sample._grid_sample_op(image, grid),
                             lambda: grid_sample._grid_sample_cuda(image, grid))}
    out = {}
    with torch.inference_mode():
        for name, (op, direct) in pairs.items():
            times = {"op": [], "direct": []}
            for kind, fn in (("op", op), ("direct", direct), ("direct", direct), ("op", op)):
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DISPATCH_CALLS):
                    fn()
                torch.cuda.synchronize()
                times[kind].append(1e6 * (time.perf_counter() - t0) / DISPATCH_CALLS)
            op_us, direct_us = np.mean(times["op"]), np.mean(times["direct"])
            out[name] = op_us - direct_us
            print(f"  {name}: {op_us:.2f} us per call through torch.ops.mrn_tpu_torch."
                  f"{name}, {direct_us:.2f} us calling its CUDA implementation directly "
                  f"({times}): dispatch {op_us - direct_us:.2f} us per call")
    return out


def _export_and_serve(what, learner, opt, dtype_name, x, out_dir):
    """``export_cli.export_inference`` at batch ``BATCH``, ``torch.export.save``,
    ``torch.export.load``, then EXPORT_REQUESTS requests of the loaded
    program on ``x`` (float32 NHWC on the card); prints the seconds and the
    ``.pt2`` bytes; returns the last logits."""
    t0 = time.perf_counter()
    program, shape = export_cli.export_inference(learner, opt, BATCH, dtype_name)
    t_export = time.perf_counter() - t0
    path = os.path.join(out_dir, f"{what.replace(' ', '_')}.pt2")
    t0 = time.perf_counter()
    torch.export.save(program, path)
    t_save = time.perf_counter() - t0
    del program
    t0 = time.perf_counter()
    module = torch.export.load(path).module()
    t_load = time.perf_counter() - t0
    ts = []
    with torch.inference_mode():
        for _ in range(EXPORT_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = module(x)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
    if tuple(logits.shape) != shape or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{what}: the loaded program gave {tuple(logits.shape)} "
                           f"{logits.dtype}, expected finite float32 {shape}")
    print(f"  {what}: export {t_export:.2f} s, save {t_save:.2f} s, {os.path.getsize(path)} "
          f"bytes, load {t_load:.2f} s; requests of {BATCH}: first {ts[0]:.4f} s, warm "
          f"{[round(t, 4) for t in ts[1:]]} s; logits {list(shape)}")
    return logits


def phase_export(rng, programs):
    """``export_cli``'s path on the card: each of ``programs`` -- (name, a
    server, the learner attributes ``export_inference`` reads, images) --
    exported in the server's dtype at batch BATCH, saved, loaded and served
    (counted: the export's one eager call and the requests), then its
    logits held against the eager server on the same images (the same
    kernels in the same order: bitwise).  Returns the launches of rows 4,
    3 and 8."""
    out_dir = tempfile.mkdtemp(prefix="smoke_export_", dir=os.path.join(ROOT, "build"))
    counted = {"fused": 0, "int8": 0, "grid_sample": 0}
    try:
        for what, srv, learner, images, expected in programs:
            dtype_name = "bf16" if srv.dtype == torch.bfloat16 else "f32"
            x = srv.images(images, torch.float32)
            svtr_block.launches = svtr_block.int8_launches = grid_sample.launches = 0
            reset_launches()
            logits = _export_and_serve(what, learner, srv.opt, dtype_name, x, out_dir)
            launched = {"fused": svtr_block.launches, "int8": svtr_block.int8_launches,
                        "grid_sample": grid_sample.launches}
            other = {k: v for k, v in read_launches().items() if k != "fused" and v}
            per_call = {k: v // (EXPORT_REQUESTS + 1) for k, v in launched.items()}
            print(f"  {what}: launches {launched} (expected {expected} per call x "
                  f"{EXPORT_REQUESTS + 1} calls: the export's eager call and the requests)")
            if per_call != expected or any(v % (EXPORT_REQUESTS + 1) for v in launched.values()) \
                    or other:
                raise RuntimeError(f"{what}: the exported program did not run through the "
                                   "kernels as expected")
            for k, v in launched.items():
                counted[k] += v
            with torch.inference_mode():
                eager = srv.forward(images)["logits"].float()
            if not torch.equal(logits, eager):
                diff = float((logits - eager).abs().max())
                raise RuntimeError(f"{what}: the loaded program's logits differ from the eager "
                                   f"server's (max |diff| {diff:.3e})")
            print(f"  {what}: loaded program's logits equal the eager server's bitwise")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return counted


def export_programs(rng, mrn_server, int8_server, int8_images, trba_single, trba_images,
                    images):
    """The four programs of the export phase: the 6-expert SVTR-MRN (bf16),
    the int8 SVTR recognizer of the int8 phase (bf16), the TRBA recognizer
    of the TRBA phase (bf16) and one CRNN recognizer drawn here (bf16),
    with their expected kernel launches per call."""
    crnn_base = load_config(os.path.join(ROOT, "configs", "crnn_mrn.py"))
    crnn_images = rng.integers(0, 256, (BATCH, crnn_base.imgH, crnn_base.imgW,
                                        crnn_base.input_channel), dtype=np.uint8)
    params, stats, chars = _random_trees(rng, crnn_base, crnn_images)
    crnn = Server(crnn_base.replace(compute_dtype="bfloat16"), params, stats, chars)

    def single(srv):
        return types.SimpleNamespace(opt=srv.opt, model=srv.model, _cur_task=0,
                                     converter=srv.converter, device=srv.device)

    ensemble = types.SimpleNamespace(opt=mrn_server.opt, _cur_task=N_EXPERTS - 1,
                                     _eval_ensemble=lambda: mrn_server.model,
                                     converter=mrn_server.converter, device=mrn_server.device)
    none = {"fused": 0, "int8": 0, "grid_sample": 0}
    return [(f"SVTR-MRN {N_EXPERTS} experts bf16", mrn_server, ensemble, images,
             dict(none, fused=N_EXPERTS * 12)),
            ("int8 SVTR recognizer bf16", int8_server, single(int8_server), int8_images,
             dict(none, int8=12)),
            ("TRBA recognizer bf16", trba_single, single(trba_single), trba_images,
             dict(none, grid_sample=1)),
            ("CRNN recognizer bf16", crnn, single(crnn), crnn_images, none)]


# ------------------------------------------------------- stage combinations
def _counted(what, expected, run):
    """``run()`` with every launch counter at 0: its launches must equal
    ``expected`` (missing keys 0).  Returns (run's result, the launches)."""
    reset_launches()
    svtr_block.int8_launches = grid_sample.launches = 0
    out = run()
    torch.cuda.synchronize()
    got = dict(read_launches(), int8=svtr_block.int8_launches, grid_sample=grid_sample.launches)
    want = {k: expected.get(k, 0) for k in got}
    print(f"  {what}: launches {({k: v for k, v in got.items() if v})} (expected "
          f"{({k: v for k, v in want.items() if v})})")
    if got != want:
        raise RuntimeError(f"{what}: the path did not run through the kernels as expected")
    return out, got


def _add_launches(total, got):
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


@contextlib.contextmanager
def _plain_everywhere(model):
    """Within: ``model``'s SVTR Blocks and the TPS warp on their plain
    versions."""
    configure_blocks(model, plain=True)
    try:
        with mock.patch.object(tps, "grid_sample", grid_sample.grid_sample_reference):
            yield
    finally:
        configure_blocks(model, plain=False)


def _ensemble_vs_plain(what, srv, images, tol):
    """A served MRN ensemble's output on the kernels against the same on
    the plain versions: route scores within ``tol``, expert picks equal
    outside near-ties of the scores, and (Attn) the greedy logits of crops
    with the same pick up to each crop's first near-tie flip."""
    atol, rtol = tol
    outs, scores = [], []
    hook = srv.model.route.register_forward_hook(
        lambda mod, inp, out: scores.append(out[..., 0].float()))
    try:
        outs.append(srv.forward(images))
        with _plain_everywhere(srv.model):
            outs.append(srv.forward(images))
    finally:
        hook.remove()
    out_k, out_p = outs
    err = check_close(f"{what} route scores", scores[0], scores[1], atol, rtol)
    top2 = scores[1].topk(2, dim=1).values
    near_tie = (top2[:, 0] - top2[:, 1]) <= 2 * err
    agree = out_k["index"] == out_p["index"]
    print(f"  {what}: expert picks agree on {int(agree.sum())}/{len(agree)} crops, "
          f"{int(near_tie.sum())} near-ties (picks per expert "
          f"{torch.bincount(out_k['index'], minlength=srv.model.n_experts).tolist()})")
    if bool((~agree & ~near_tie).any()):
        raise RuntimeError(f"{what}: expert picks disagree beyond score near-ties")
    counts = torch.tensor(srv.model.class_counts, device=agree.device)[out_p["index"]]
    check_greedy(f"{what} logits (crops with the same pick)", out_k["logits"][agree],
                 out_p["logits"][agree], counts[agree], atol, rtol)


def _combo_options(config, stages, **kw):
    t, f, s, p = stages
    return load_config(os.path.join(ROOT, "configs", config), Transformation=t,
                       FeatureExtraction=f, SequenceModeling=s, Prediction=p, **kw)


@contextlib.contextmanager
def _train_dtype(learner, dtype):
    """Within: the learner's mixed-precision policy is ``dtype``."""
    saved = learner.opt.get("train_dtype")
    learner.opt.train_dtype = dtype
    try:
        yield
    finally:
        learner.opt.train_dtype = saved


def phase_combos(rng):
    """The path of stage combinations the port did not build before,
    driven through the entry points (``serve.Server``,
    ``MRN.incremental_train``, ``serve.quantize_int8``), every launch
    counted against its prediction (COMBO_* above).  Returns the launches
    of the counted runs per kernel."""
    total = {}
    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="smoke_combos_", dir=os.path.join(ROOT, "build"))
    try:
        _combo_tps_svtr(rng, out_dir, total)
        _combo_vgg_attn(rng, out_dir, total)
        _combo_sweep(rng, out_dir, total)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"  the stage-combinations phase took {time.perf_counter() - t_phase:.1f} s; "
          f"its counted launches {total}")
    return total


def _combo_tps_svtr(rng, out_dir, total):
    """TPS/SVTR/BiLSTM/Attn at SVTR-MRN's full width."""
    t0 = time.perf_counter()
    stages = ("TPS", "SVTR", "BiLSTM", "Attn")
    base = _combo_options("svtr_mrn.py", stages)
    images = rng.integers(0, 256, (BATCH, base.imgH, base.imgW, base.input_channel),
                          dtype=np.uint8)
    params, stats, chars = _random_trees(rng, base, images, CLASS_COUNTS)
    server = Server(base.replace(compute_dtype="bfloat16"), params, stats, chars,
                    class_counts=CLASS_COUNTS)
    torch.cuda.synchronize()
    print(f"  TPS/SVTR/BiLSTM/Attn: {N_EXPERTS} experts drawn, calibrated on the batch and "
          f"loaded in {time.perf_counter() - t0:.1f} s")
    (ts, result), got = _counted(
        f"TPS/SVTR/BiLSTM/Attn {N_EXPERTS}-expert bf16 requests",
        dict(fused=COMBO_REQUESTS * N_EXPERTS * 12, grid_sample=COMBO_REQUESTS * N_EXPERTS),
        lambda: _timed_requests(server, images, COMBO_REQUESTS))
    _add_launches(total, got)
    _print_requests(f"TPS/SVTR/BiLSTM/Attn {N_EXPERTS}-expert bfloat16", ts)
    print(f"  sample words {[w for w, _ in result[:3]]}, "
          f"{len(set(w for w, _ in result))} distinct words in {BATCH}")
    logits = server.forward(images)["logits"]
    shape = (BATCH, base.batch_max_length + 1, max(CLASS_COUNTS))
    if tuple(logits.shape) != shape or not bool(torch.isfinite(logits.float()).all()):
        raise RuntimeError(f"TPS/SVTR/BiLSTM/Attn logits {tuple(logits.shape)} != {shape} or "
                           "not finite")
    _ensemble_vs_plain("TPS/SVTR/BiLSTM/Attn bf16, kernels vs plain", server, images,
                       LOGIT_TOL[torch.bfloat16])
    mx = server.check_score_envelope(images)
    if not np.isfinite(mx):
        raise RuntimeError("the score envelope of an Attn ensemble is not finite")
    del server

    # ---- task 1 of 2 through the MRN learner
    alphabets = campaign.task_alphabets()[:2]
    counts = [build_converter("Attn", "".join(alphabets[:t + 1])).num_classes for t in (0, 1)]
    loader = SyntheticTaskLoader(alphabets, 1, BATCH, CROPS_PER_TASK, img_h=32, img_w=256,
                                 seed=COMBO_SEED)
    val_set = synthetic_val_set(alphabets, 1, BATCH, 32, 256, seed=COMBO_SEED + 1)
    opt = base.replace(output_dir=out_dir, data_log=os.path.join(out_dir, "data_tps.txt"),
                       exp_name="tps_svtr", num_iter=COMBO_TRAIN_ITERS,
                       val_interval=COMBO_VAL_INTERVAL, train_dtype="bf16",
                       image_bank=loader.bank, manual_seed=COMBO_SEED)
    valid = ValDataset(["val"], opt, {"val": val_set}.__getitem__)
    learner = MRN(opt)
    learner.add_expert(*random_recognizer(rng, opt, counts[0]), counts[0])
    n0, n1 = COMBO_TRAIN_ITERS, COMBO_TRAIN_ITERS // 2
    ff = val_points(n0, COMBO_VAL_INTERVAL)
    tf = val_points(n1, max(1, COMBO_VAL_INTERVAL // 5))
    expected = dict(full=6 * n0, banded=6 * n0, fused=12 * ff + 2 * 12 * (n1 + tf),
                    grid_sample=ff + 2 * (n1 + tf))
    t0 = time.perf_counter()
    with fused_train_env(False):
        _, got = _counted(f"TPS/SVTR/BiLSTM/Attn incremental_train of task 1 ({n0} step-0 "
                          f"steps, {ff} FF batches, {n1} router steps, {tf} TF batches)",
                          expected, lambda: learner.incremental_train(
                              1, "".join(alphabets), loader, valid))
    _add_launches(total, got)
    losses = [rec["loss"] for rec in learner.history]
    print(f"  incremental_train in {time.perf_counter() - t0:.1f} s; step losses "
          f"{[round(v, 4) for v in losses]}")
    if len(losses) != n0 + n1 or not all(np.isfinite(losses)):
        raise RuntimeError("TPS/SVTR/BiLSTM/Attn training: non-finite loss or missing steps")

    # ---- step windows: the router, then a new expert composed and fused
    with fused_train_env(False):
        (w1, _), got = _counted(
            "router window", dict(fused=2 * 12 * (COMBO_WARMUP + COMBO_WINDOW),
                                  grid_sample=2 * (COMBO_WARMUP + COMBO_WINDOW)),
            lambda: _window(learner, loader.get_batch2, COMBO_WARMUP, COMBO_WINDOW))
        _add_launches(total, got)
        learner.change_model()
        learner.build_optimizer()
        grad_key = "extractor.transformation.localization.localization_fc2.kernel"
        with _train_dtype(learner, "f32"):
            _trba_step_pair("f32 composed step-0 step, kernels vs plain (the TPS grad through "
                            "12 SVTR Blocks)", learner, learner.model, loader.get_batch(),
                            grad_key, learner.build_optimizer, COMBO_STEP_TOL)
        steps = COMBO_WARMUP + COMBO_WINDOW
        (w0, _), got = _counted("composed step-0 window", dict(full=6 * steps, banded=6 * steps),
                                lambda: _window(learner, loader.get_batch, COMBO_WARMUP,
                                                COMBO_WINDOW))
        _add_launches(total, got)
    with fused_train_env(True):
        with _train_dtype(learner, "f32"):
            _trba_step_pair("f32 fused step-0 step, kernels vs plain (row 7's dx into the "
                            "TPS)", learner, learner.model, loader.get_batch(), grad_key,
                            learner.build_optimizer, COMBO_STEP_TOL)
        (wf, _), got = _counted("fused step-0 window (MRN_FUSED_TRAIN=1)",
                                dict(train_fwd=12 * steps, train_bwd_tail=12 * steps,
                                     train_bwd_head=12 * steps),
                                lambda: _window(learner, loader.get_batch, COMBO_WARMUP,
                                                COMBO_WINDOW))
        _add_launches(total, got)
    print(f"  StepMeter windows of {COMBO_WINDOW} steps after {COMBO_WARMUP} warm-up steps, "
          f"bf16, batch {BATCH}: step 0 composed {1e3 * w0:.2f} ms/step, fused "
          f"{1e3 * wf:.2f} ms/step, step 1 (router over 2 experts) {1e3 * w1:.2f} ms/step")
    del learner

    # ---- one int8 recognizer
    params, stats, chars = _random_trees(rng, base, images)
    opt = base.replace(compute_dtype="bfloat16")
    calib = [images[i::INT8_CALIB_BATCHES] for i in range(INT8_CALIB_BATCHES)]
    int8_server = quantize_int8(Server(opt, params, stats, chars), iter(calib),
                                n_batches=INT8_CALIB_BATCHES)
    (ts, _), got = _counted("TPS/SVTR/BiLSTM/Attn int8 recognizer bf16 requests",
                            dict(int8=COMBO_INT8_REQUESTS * 12,
                                 grid_sample=COMBO_INT8_REQUESTS),
                            lambda: _timed_requests(int8_server, images, COMBO_INT8_REQUESTS))
    _add_launches(total, got)
    _print_requests("TPS/SVTR/BiLSTM/Attn int8 recognizer bfloat16", ts)
    check_served_int8_blocks("TPS/SVTR/BiLSTM/Attn int8 bf16", int8_server, images,
                             torch.bfloat16)


def _combo_vgg_attn(rng, out_dir, total):
    """None/VGG/None/Attn (JAX's own MRN test's combination) at CRNN-MRN's
    widths."""
    t0 = time.perf_counter()
    stages = ("None", "VGG", "None", "Attn")
    base = _combo_options("crnn_mrn.py", stages)
    images = rng.integers(0, 256, (BATCH, base.imgH, base.imgW, base.input_channel),
                          dtype=np.uint8)
    params, stats, chars = _random_trees(rng, base, images, CLASS_COUNTS)
    server = Server(base.replace(compute_dtype="bfloat16"), params, stats, chars,
                    class_counts=CLASS_COUNTS)
    torch.cuda.synchronize()
    print(f"  None/VGG/None/Attn: {N_EXPERTS} experts drawn, calibrated and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    (ts, result), got = _counted(f"None/VGG/None/Attn {N_EXPERTS}-expert bf16 requests (no "
                                 "port kernel on this path)", {},
                                 lambda: _timed_requests(server, images, COMBO_REQUESTS))
    _print_requests(f"None/VGG/None/Attn {N_EXPERTS}-expert bfloat16", ts)
    cpu = Server(base.replace(compute_dtype="float32"), params, stats, chars,
                 class_counts=CLASS_COUNTS, device="cpu")
    ref, ref_scores = _served_with_scores(cpu, images[:CRNN_REF_CROPS])
    out, scores = _served_with_scores(server, images[:CRNN_REF_CROPS])
    atol, rtol = CRNN_LOGIT_TOL[torch.bfloat16]
    err = check_close("None/VGG/None/Attn bf16 route scores vs float32 on the CPU",
                      scores.cpu(), ref_scores, atol, rtol)
    top2 = ref_scores.topk(2, dim=1).values
    agree = out["index"].cpu() == ref["index"]
    if bool((~agree & ((top2[:, 0] - top2[:, 1]) > 2 * err)).any()):
        raise RuntimeError("None/VGG/None/Attn: expert picks differ from the CPU beyond "
                           "near-ties")
    counts = torch.tensor(CLASS_COUNTS)[ref["index"]]
    check_greedy("None/VGG/None/Attn bf16 logits vs float32 on the CPU (same pick)",
                 out["logits"].cpu()[agree], ref["logits"][agree], counts[agree], atol, rtol)
    del server, cpu

    alphabet = _task_alphabets()[0]
    loader = SyntheticTaskLoader([alphabet], 0, BATCH, CROPS_PER_TASK, img_h=32, img_w=256,
                                 seed=COMBO_SEED)
    learner = MRN(base.replace(image_bank=loader.bank, train_dtype="bf16",
                               manual_seed=COMBO_SEED, exp_name="vgg_attn",
                               output_dir=out_dir,
                               data_log=os.path.join(out_dir, "data_vgg.txt")))
    learner.character = list(alphabet)
    learner.converter = learner.build_converter()
    learner._cur_task = 0
    learner.build_model()
    learner.build_optimizer()
    (w0, _), _ = _counted("None/VGG/None/Attn step-0 window", {},
                          lambda: _window(learner, loader.get_batch, COMBO_WARMUP,
                                          COMBO_WINDOW))
    print(f"  None/VGG/None/Attn bf16 step 0, StepMeter window of {COMBO_WINDOW} steps after "
          f"{COMBO_WARMUP} warm-up steps: {1e3 * w0:.2f} ms/step ({BATCH / w0:.1f} images/s)")


def _combo_sweep(rng, out_dir, total):
    """All 32 combinations at COMBO_SWEEP widths, batch COMBO_SWEEP_BATCH:
    an eval forward on the kernels against the plain versions (float32),
    then one bf16 step of a new expert with a finite loss and finite
    gradients."""
    alphabet = alphabet_of_size(40)
    loader = SyntheticTaskLoader([alphabet], 0, COMBO_SWEEP_BATCH, 4 * COMBO_SWEEP_BATCH,
                                 img_h=32, img_w=256, seed=COMBO_SEED + 2)
    t0 = time.perf_counter()
    for stages in itertools.product(("None", "TPS"), ("VGG", "ResNet", "RCNN", "SVTR"),
                                    ("None", "BiLSTM"), ("CTC", "Attn")):
        name = "/".join(stages)
        opt = _combo_options("svtr_mrn.py", stages, batch_size=COMBO_SWEEP_BATCH,
                             train_dtype="bf16", manual_seed=COMBO_SEED,
                             image_bank=loader.bank, exp_name="sweep", output_dir=out_dir,
                             data_log=os.path.join(out_dir, "data_sweep.txt"), **COMBO_SWEEP)
        svtr, warp = stages[1] == "SVTR", stages[0] == "TPS"
        n_blocks = sum(COMBO_SWEEP["svtr"]["depth"]) if svtr else 0
        idx, words = loader.get_batch()
        images = loader.bank[idx]
        n_classes = build_converter(stages[3], alphabet).num_classes
        params, stats = random_recognizer(rng, opt, n_classes)
        if warp:
            fc2 = params["extractor"]["transformation"]["localization"]["localization_fc2"]
            fc2["kernel"] = (TRBA_FC2_SCALE * rng.standard_normal(fc2["kernel"].shape)
                             ).astype(np.float32)
        server = Server(opt.replace(compute_dtype="float32"), params, stats, alphabet)
        out_k, got = _counted(f"{name} eval forward", dict(fused=n_blocks, grid_sample=int(warp)),
                              lambda: server.forward(images)["logits"].float())
        _add_launches(total, got)
        with _plain_everywhere(server.model):
            out_p = server.forward(images)["logits"].float()
        atol, rtol = TRBA_LOGIT_TOL[torch.float32]
        if stages[3] == "CTC":
            check_close(f"{name} f32 logits, kernels vs plain", out_k, out_p, atol, rtol)
        else:
            check_greedy(f"{name} f32 logits, kernels vs plain", out_k, out_p,
                         torch.full((len(images),), n_classes, device=out_p.device), atol, rtol)

        learner = MRN(opt)
        learner.character = list(alphabet)
        learner.converter = learner.build_converter()
        learner._cur_task = 0
        learner.build_model()
        learner.build_optimizer()
        grads = {}

        def keep(g):
            grads.update(g)
            return g

        learner.grad_transform = lambda: keep
        metrics, got = _counted(f"{name} bf16 step", dict(full=2 * svtr, banded=6 * svtr),
                                lambda: learner.train_step((idx, words)))
        _add_launches(total, got)
        bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
        print(f"  {name}: bf16 step loss {float(metrics['loss']):.5f}, grad_norm "
              f"{float(metrics['grad_norm']):.4g}, {len(grads)} gradients, "
              f"{len(bad)} not finite")
        if not np.isfinite(float(metrics["loss"])) or bad or not grads:
            raise RuntimeError(f"{name}: a non-finite loss or gradient in the bf16 step")
        del learner, server
    print(f"  the 32 combinations in {time.perf_counter() - t0:.1f} s")


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
    build, t_build = phase_build()
    # these phases launch only the TPS warp's kernel: they run while nvcc
    # builds the SVTR sources, on their own generator
    early_rng = np.random.default_rng(EARLY_SEED)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    try:
        print("== TRBA-MRN serving, 6 experts, full width")
        trba_served, _, tps_grids, trba_images, trba_single = phase_trba_serve(early_rng)
        print("== TRBA-MRN training, task 2 of 3, full width, bf16")
        trba_dir = tempfile.mkdtemp(prefix="smoke_trba_", dir=os.path.join(ROOT, "build"))
        try:
            trba_trained = phase_trba_train(early_rng, trba_dir)
        finally:
            shutil.rmtree(trba_dir, ignore_errors=True)
        print("== CRNN-MRN serving, 6 experts, full width")
        crnn_served = phase_crnn_serve(early_rng)
        print("== CRNN-MRN training, task 5 of 6, full width, bf16 and f32; a drifting-mode step")
        crnn_dir = tempfile.mkdtemp(prefix="smoke_crnn_", dir=os.path.join(ROOT, "build"))
        try:
            crnn_trained = phase_crnn_train(early_rng, crnn_dir)
        finally:
            shutil.rmtree(crnn_dir, ignore_errors=True)
        print("== GRCNN, full width: a bf16 step-0 window and a served recognizer")
        grcnn_step, grcnn_served = phase_grcnn(early_rng)
        print("== the int8 conv path: CRNN, TRBA and GRCNN recognizers, full width")
        int8_warps = phase_int8_convs(early_rng)
        print(f"  CRNN-MRN requests {crnn_served}; CRNN step windows (step 0, step 1) "
              f"{crnn_trained}; GRCNN step 0 {grcnn_step:.4f} s, requests {grcnn_served}")
    except BaseException:
        with contextlib.suppress(BaseException):
            build.wait()          # no nvcc outlives the script
        raise
    print("== build, joined")
    join_build(build, t_build)
    print("== TPS warp kernel vs plain, TRBA shape")
    warp = phase_grid_sample(device, early_rng, tps_grids, trba_images)
    print("== kernel vs plain, SVTR Block shapes")
    totals = phase_blocks(device, rng)
    print("== SVTR-MRN serving, 6 experts, full width")
    served, _, mrn_servers, mrn_images = phase_serve(rng)
    print("== attention kernels vs plain, SVTR training shapes")
    attn = phase_attention(device, rng)
    # best checkpoints and expert blobs of the training phases, removed at the end
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
        print("== LMDB entry points: train_cli, evaluate_cli, recognize_cli, full width, bf16")
        lmdb = phase_lmdb(out_dir, device)
        print("== dataset tools and image forms: the fixtures, crop_by_word, create_lmdb, "
              "evaluate_cli and recognize_cli on the LMDB phase's checkpoint, full width, bf16")
        lmdb_saved = os.path.join(out_dir, "lmdb", "saved", "smoke_lmdb_lmdb")
        forms = phase_forms(out_dir, os.path.join(out_dir, "lmdb", "smoke_lmdb_lmdb.py"),
                            os.path.join(lmdb_saved, f"{campaign.LANS[LMDB_TASKS - 1]}_"
                                         f"{LMDB_TASKS - 1}_1_best_score.msgpack"))
        print("== training-time augmentation: the fixtures, host crops/s, train_cli with "
              "Aug=ABINet and Blur5-Crop90-Rot15 over the LMDB tree, full width, bf16")
        aug = phase_augment(out_dir, device)
        print("== parallel training: train_cli without a process group, in a 1-rank NCCL "
              "world and in 2-rank gloo worlds on one card, full width, f32")
        par = phase_parallel(out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print("== w8a8 Block kernel vs plain, SVTR Block shapes")
    int8_totals = phase_int8_blocks(device, rng)
    print("== int8 serving, one SVTR recognizer (task 0), full width")
    int8_served, int8_server, int8_images = phase_int8_serve(rng, base)
    t_new = time.perf_counter()
    print("== the tanh-GELU serving mode: SVTR-MRN, 6 experts, and one int8 recognizer, "
          "full width")
    tanh_served, tanh_int8_served, tanh_totals, tanh_int8_totals = phase_gelu_tanh(
        device, mrn_servers, mrn_images, base)
    print("== custom-op dispatch cost")
    dispatch_cost(device, np.random.default_rng(TANH_SEED + 1))
    print("== export: SVTR-MRN, int8 SVTR, TRBA and CRNN programs, full width, bf16")
    export_rng = np.random.default_rng(TANH_SEED + 2)
    exported = phase_export(export_rng, export_programs(
        export_rng, mrn_servers["bfloat16"], int8_server, int8_images, trba_single, trba_images,
        mrn_images))
    print(f"  the tanh-GELU, dispatch and export phases took {time.perf_counter() - t_new:.1f} s")
    print("== stage combinations: TPS/SVTR/BiLSTM/Attn at SVTR-MRN's width, None/VGG/None/Attn "
          "at CRNN-MRN's, all 32 narrow")
    combos = phase_combos(np.random.default_rng(COMBO_SEED))
    print(f"== done in {time.perf_counter() - t_start:.1f} s")
    bf16 = torch.bfloat16
    rows = [("svtr_fused_block", "svtr_block.cu", "mrn_tpu/ops/svtr_block.py:166",
             served + trained["fused"] + fused_trained["fused"] + ckpt["fused"] + camp["fused"]
             + strat["fused"] + lmdb["fused"] + forms["fused"] + aug["fused"] + par["fused"]
             + exported["fused"] + combos["fused"], totals[bf16]),
            ("svtr_fused_block_tanh", "svtr_block.cu", "mrn_tpu/ops/svtr_block.py:289",
             tanh_served, tanh_totals[bf16]),
            ("svtr_attention_full", "svtr_attention.cu", "mrn_tpu/ops/svtr_attention.py:87",
             trained["full"] + ckpt["full"] + camp["full"] + strat["full"] + lmdb["full"]
             + forms["full"] + aug["full"] + par["full"] + combos["full"], attn[("full", bf16)]),
            ("svtr_attention_banded", "svtr_attention.cu", "mrn_tpu/ops/svtr_attention.py:157",
             trained["banded"] + ckpt["banded"] + camp["banded"] + strat["banded"]
             + lmdb["banded"] + aug["banded"] + par["banded"] + combos["banded"],
             attn[("banded", bf16)]),
            ("svtr_train_block_forward", "svtr_train_block.cu",
             "mrn_tpu/ops/svtr_train_block.py:124",
             fused_trained["train_fwd"] + combos["train_fwd"],
             train_blocks[("fwd", bf16)]),
            ("svtr_train_block_bwd_tail", "svtr_train_block.cu",
             "mrn_tpu/ops/svtr_train_block.py:436",
             fused_trained["train_bwd_tail"] + combos["train_bwd_tail"],
             train_blocks[("tail", bf16)]),
            ("svtr_train_block_bwd_head", "svtr_train_block.cu",
             "mrn_tpu/ops/svtr_train_block.py:497",
             fused_trained["train_bwd_head"] + combos["train_bwd_head"],
             train_blocks[("head", bf16)]),
            ("svtr_fused_block_int8", "svtr_block_int8.cu", "mrn_tpu/ops/svtr_block.py:303",
             int8_served + lmdb["int8"] + exported["int8"] + combos["int8"],
             int8_totals[(bf16, False)]),
            ("svtr_fused_block_int8_tanh", "svtr_block_int8.cu", "mrn_tpu/ops/svtr_block.py:378",
             tanh_int8_served, tanh_int8_totals[(bf16, False)]),
            ("grid_sample", "grid_sample.cu", "mrn_tpu/ops/grid_sample.py:140",
             trba_served + trba_trained + int8_warps + exported["grid_sample"]
             + combos["grid_sample"],
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
          f"({ckpt['fused']}), of the campaign ({camp['fused']}), of the strategies "
          f"({strat['fused']}) and of the LMDB entry points ({lmdb['fused']}: two train_cli "
          f"runs, evaluate_cli, recognize_cli), of the forms phase ({forms['fused']}: "
          f"evaluate_cli, recognize_cli), of the augmentation phase ({aug['fused']}: "
          f"train_cli with Aug=ABINet and Blur5-Crop90-Rot15), of the parallel phase "
          f"({par['fused']}: "
          f"train_cli without a group, in 1-rank NCCL worlds and on each rank of the 2-rank "
          f"gloo worlds) and of the exported SVTR-MRN program "
          f"({exported['fused']}: its export's eager call and {EXPORT_REQUESTS} requests); "
          f"svtr_fused_block_tanh and svtr_fused_block_int8_tanh are the same kernels in the "
          f"tanh-GELU form (set_gelu_approximate), their launches the tanh phase's served "
          f"requests ({tanh_served}, {tanh_int8_served}), their library_ms the library Blocks "
          f"with F.gelu(approximate='tanh'), their bound the degree-9 rows'; attention times "
          f"are one "
          f"expert forward's 6 Blocks of each kind, their launches the composed step-0 steps "
          f"of the training, checkpoint, campaign, strategies, LMDB, augmentation and parallel "
          f"phases; "
          f"svtr_train_block times are one expert's 12 Blocks, the tail's library_ms "
          f"autograd's backward of the library Block's proj + LayerNorm + MLP sub-graph, "
          f"the head's of its LayerNorm + qkv product; svtr_fused_block_int8 times are one recognizer's 12 "
          f"Blocks with float attention, its launches the int8 served requests, "
          f"evaluate_cli --int8 ({lmdb['int8']}) and the exported int8 program "
          f"({exported['int8']}), its "
          f"library_ms the torch._int_mm Block; grid_sample times are one warp of the "
          f"served batch's TPS grid (bf16 image, f32 grid), its launches the TRBA served "
          f"requests ({trba_served}), the TRBA training run ({trba_trained}: step 1's "
          f"frozen experts, FF and TF validation), the int8 TRBA requests ({int8_warps}) and "
          f"the exported TRBA program ({exported['grid_sample']}), "
          f"its library_ms F.grid_sample on NCHW; every row but the tanh ones also counts "
          f"the stage-combinations phase's counted runs ({combos}); "
          f"on {smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:   # one rank of the parallel phase's worlds
        parallel_rank(sys.argv[2], sys.argv[3:])
    else:
        main()
