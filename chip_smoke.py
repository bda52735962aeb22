#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (H100):

    python3 chip_smoke.py

1. prints the toolchain and the card (``nvidia-smi`` name and power limit);
2. builds the CUDA kernels from ``mrn_tpu_torch/ops/csrc`` (one ``nvcc``
   per source, all started together);
3. holds the fused SVTR Block kernel against its plain PyTorch version at
   the four Block shapes of SVTR at batch 256, in float32 and bfloat16, and
   times kernel, plain version and a library yardstick (a composed Block on
   cuBLAS and ``F.scaled_dot_product_attention``, which the port never
   calls) beside the card's bound for the same work;
4. serves ``configs/svtr_mrn.py`` at full width as a 6-expert SVTR-MRN
   ensemble (4500 classes, random weights from a seed in the JAX init
   distributions, bridged with ``bridge.from_flax``): a few requests of 256
   crops in bfloat16 and float32 through ``serve.Server``, counting kernel
   launches, then the same batch forced through the plain versions on the
   card for comparison;
5. holds the two training attention kernels (full and banded) against their
   plain versions at the four attention shapes of the SVTR training forward
   (f32 and bf16, forward, and f32 gradients through the autograd
   Functions), timed beside the plain version, one
   ``F.scaled_dot_product_attention`` call (timed only) and the bound;
6. trains task 5 of the 6-task SVTR-MRN sequence at full width through
   ``MRN.incremental_train`` (5 frozen random experts plus the new one,
   batch 256 of synthetic crops from a uint8 bank on the card): step 0
   (the new expert) and step 1 (the router over 6 experts), bf16 then f32,
   printing each step's loss, time and images/s and counting kernel
   launches; then, in bf16 and f32, one step-0 step on the kernel path
   against the same step on the plain versions (loss, grad norm, fc grad).

Any failed check raises (exit code != 0).  The line before the last is the
per-kernel JSON record, the last line ``{"ok": true, "device": {...}}``.
Exits non-zero without printing a result when no CUDA card is present.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from mrn_tpu_torch.config import load_config  # noqa: E402
from mrn_tpu_torch.data.synthetic import SyntheticTaskLoader, alphabet_of_size  # noqa: E402
from mrn_tpu_torch.models.init import (random_block, random_mrn,  # noqa: E402
                                       random_recognizer, random_router)
from mrn_tpu_torch.models.svtr import (Block, configure_blocks,  # noqa: E402
                                       local_attention_mask_col_major)
from mrn_tpu_torch.ops import _build, svtr_attention, svtr_block  # noqa: E402
from mrn_tpu_torch.serve import Server  # noqa: E402
from mrn_tpu_torch.train.learners.mrn import MRN  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet) at the full 700 W limit.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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


def check_close(what, got, ref, atol, rtol):
    err = (got.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool((err <= limit).all())
    mx = float(err.max())
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


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        log = _build.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")


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
                out_k = blk(x)
                torch.cuda.synchronize()
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
                  f"bound_ms {bound:.4f}  ({bound / ms:.1%} of bound)")
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
    timings = {}
    for dtype, n_req in REQUESTS.items():
        timings[dtype] = []
        for _ in range(n_req):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = servers[dtype].recognize(images)
            timings[dtype].append(time.perf_counter() - t0)
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
    for dtype, ts in timings.items():
        print(f"  {dtype}: request seconds {[round(t, 4) for t in ts]}, crops/s "
              f"{[round(BATCH / t, 1) for t in ts]} (first request includes warm-up)")
    print(f"  sample words of the last request: {[w for w, _ in results[:3]]}")

    # ---- the same batch through the plain versions on the card.  The route
    # scores are read with a hook on the router's last layer; a pick may
    # differ only on a near-tie of the plain path's top-2 scores.
    for dtype, srv in servers.items():
        atol, rtol = LOGIT_TOL[srv.dtype]
        scores = []
        hook = srv.model.route.register_forward_hook(
            lambda mod, inp, out: scores.append(out[..., 0].float()))
        out_k = srv.forward(images)
        configure_blocks(srv.model, plain=True)
        out_p = srv.forward(images)
        configure_blocks(srv.model, plain=False)
        hook.remove()
        shape = (BATCH, base.imgW // 4, max(CLASS_COUNTS))
        if tuple(out_k["logits"].shape) != shape:
            raise RuntimeError(f"logits shape {tuple(out_k['logits'].shape)} != {shape}")
        check_close(f"{dtype} route scores", scores[0], scores[1], atol, rtol)
        # with every score within delta of its plain value, the order of two
        # experts can flip only where their plain margin is <= 2 * delta
        delta = float((scores[0] - scores[1]).abs().max())
        top2 = scores[1].topk(2, dim=1).values
        near_tie = (top2[:, 0] - top2[:, 1]) <= 2 * delta
        agree = out_k["index"] == out_p["index"]
        print(f"  {dtype}: expert picks agree on {int(agree.sum())}/{BATCH} samples, "
              f"{int(near_tie.sum())} near-ties (picks per expert "
              f"{torch.bincount(out_k['index'], minlength=N_EXPERTS).tolist()})")
        if bool((~agree & ~near_tie).any()):
            raise RuntimeError("expert picks disagree between kernel and plain paths "
                               "beyond score near-ties")
        check_close(f"{dtype} served logits (samples with the same pick)",
                    out_k["logits"][agree], out_p["logits"][agree], atol, rtol)
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


def phase_attention(device, rng):
    """Each attention kernel vs its plain version at the four attention
    shapes of the SVTR training forward, f32 and bf16; timed beside the
    plain version, ``F.scaled_dot_product_attention`` (timed only) and the
    bound.  Returns per-kernel, per-dtype sums over one expert forward."""
    d = 32
    totals = {}
    for dt in (torch.float32, torch.bfloat16):
        for name, hw, heads, kind, count in ATTN_SHAPES:
            n = hw[0] * hw[1]
            qkv = [torch.from_numpy(rng.standard_normal((BATCH, heads, n, d))
                                    .astype(np.float32)).to(device, dt) for _ in range(3)]
            qkv[0] = qkv[0] * d ** -0.5
            q, k, v = qkv
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
                else:
                    kernel = lambda: svtr_attention.attention_forward(q, k, v)  # noqa: E731
                    plain = lambda: svtr_attention.attention_reference(q, k, v)  # noqa: E731
                    mask_bytes, what = 0, "unmasked"
                out_k = kernel()
                torch.cuda.synchronize()
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
                  f"  ({bound / ms:.1%} of bound)")
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
    for (kind, dt), tot in totals.items():
        print(f"  {kind} attention, one expert forward (6 Blocks), {str(dt)[6:]}: "
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


def _kernel_vs_plain_step(base, loader, character, dtype):
    """One step-0 step of a fresh expert from the same weights, batch and
    DropPath masks on the kernel path and forced through the plain
    versions: loss, global grad norm and the fc grad must agree within
    ``TRAIN_STEP_TOL[dtype]``."""
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
    for plain in (False, True):
        learner.model.load_state_dict(start)
        learner.generator.set_state(gen_state)
        configure_blocks(learner.model, plain=plain)
        learner.build_optimizer()
        metrics = learner.train_step(batch)
        results.append((float(metrics["loss"]), float(metrics["grad_norm"]), captured["fc"]))
    (lk, gk, fk), (lp, gp, fp) = results
    loss_rtol, norm_rtol, fc_share = TRAIN_STEP_TOL[dtype]
    largest = float(fp.abs().max())
    dfc = float((fk - fp).abs().max())
    print(f"  {dtype} step-0 step, kernel vs plain: loss {lk:.7f} vs {lp:.7f} "
          f"(rel {abs(lk - lp) / abs(lp):.2e}, tol {loss_rtol:g}), grad_norm {gk:.6f} vs "
          f"{gp:.6f} (rel {abs(gk - gp) / gp:.2e}, tol {norm_rtol:g}), fc grad max |diff| "
          f"{dfc:.3e} of max |grad| {largest:.3e} (tol {fc_share:g} of it)")
    if abs(lk - lp) > loss_rtol * abs(lp) or abs(gk - gp) > norm_rtol * gp \
            or dfc > fc_share * largest:
        raise RuntimeError(f"{dtype}: the kernel and plain training steps disagree")


def phase_train(rng):
    """This slice's main path: SVTR-MRN training of task 5 at full width
    (step 0, the new expert alone; step 1, the router over 6 frozen
    experts) through ``MRN.incremental_train``, bf16 then f32; then, in
    each dtype, one step-0 step on the kernel path against the same step on
    the plain versions."""
    base = load_config(os.path.join(ROOT, "configs", "svtr_mrn.py"))
    alphabets = _task_alphabets()
    character = "".join(alphabets)
    t0 = time.perf_counter()
    loader = SyntheticTaskLoader(alphabets, TRAIN_TASK, BATCH, CROPS_PER_TASK,
                                 img_h=base.imgH, img_w=base.imgW, seed=SEED)
    print(f"  rendered {len(loader.labels)} crops {loader.bank.shape[1:]} into the bank "
          f"in {time.perf_counter() - t0:.1f} s")
    learners = {dtype: _train_learner(base, rng, loader, dtype) for dtype in TRAIN_DTYPES}
    n0, n1 = TRAIN_ITERS, TRAIN_ITERS // 2

    # ---- counted run: the main path, through the entry point
    svtr_attention.launches.update(full=0, banded=0)
    svtr_block.launches = 0
    for dtype, learner in learners.items():
        init_rng = copy.deepcopy(learner.np_rng)
        learner.incremental_train(TRAIN_TASK, character, loader)
        init_fc = random_recognizer(init_rng, learner.opt, CLASS_COUNTS[-1])[0]["fc"]["kernel"]
        init_route = random_router(init_rng, learner.opt, N_EXPERTS)["route"]["kernel"]
        moved = (float((learner.expert_states[-1]["fc.kernel"].cpu()
                        - torch.from_numpy(init_fc)).abs().max()),
                 float((learner.router_state["route.kernel"].cpu()
                        - torch.from_numpy(init_route)).abs().max()))
        for rec in learner.history:
            print(f"  {dtype} task {rec['task']} step {rec['step']} iter {rec['iteration']}: "
                  f"loss {rec['loss']:.5f}"
                  + (f" (clf {rec['clf']:.5f}, router {rec['router']:.5f})" if "clf" in rec else "")
                  + f", grad_norm {rec['grad_norm']:.4g}, lr {rec['lr']:.4g}, "
                  f"{1e3 * rec['seconds']:.1f} ms, {BATCH / rec['seconds']:.1f} images/s")
        print(f"  {dtype}: max |change| of the new expert's fc {moved[0]:.3e}, "
              f"of the router's route kernel {moved[1]:.3e}")
        if not all(np.isfinite(rec["loss"]) for rec in learner.history):
            raise RuntimeError(f"{dtype}: non-finite training loss")
        if len(learner.history) != n0 + n1 or min(moved) <= 0.0:
            raise RuntimeError(f"{dtype}: the trained parameters did not move")
    launches = dict(svtr_attention.launches, fused=svtr_block.launches)
    steps = len(learners)
    expected = dict(full=6 * n0 * steps, banded=6 * n0 * steps, fused=72 * n1 * steps)
    print(f"  launches in the training runs: {launches} (expected {expected}: "
          f"per step-0 step 6 full + 6 banded attention, per step-1 step 72 fused "
          f"Blocks = {N_EXPERTS} experts x 12)")
    if launches != expected:
        raise RuntimeError("the training path did not run through the kernels as expected")

    for dtype in TRAIN_DTYPES:
        _kernel_vs_plain_step(base, loader, character, dtype)
    return launches, learners, loader


def phase_profile(learner, loader):
    """Where one step's device time goes: ``torch.profiler`` over one step-1
    and one step-0 step of the bf16 learner after its counted run (the
    router phase as it ended, then its standalone expert again).  Prints
    the kernels with the most device time, the device-busy time and the
    host-clock step time (the profiler's own overhead is inside the
    latter)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = (("step 1", loader.get_batch2), ("step 0", loader.get_batch))
    for label, get_batch in steps:
        if label == "step 0":
            learner._phase = "standalone"
            learner.build_optimizer()
        batch = get_batch()
        learner.train_step(batch)     # warm-up outside the trace
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            learner.train_step(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only (the operators' own rows repeat their kernels' time)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        if busy == 0:
            print(f"  bf16 {label}: the profiler recorded no device time "
                  f"({1e3 * wall:.1f} ms traced step)")
            continue
        print(f"  bf16 {label}: device busy {busy:.1f} ms of a {1e3 * wall:.1f} ms traced "
              f"step ({1 - busy / (1e3 * wall):.1%} idle); top kernels by device time:")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            ms = e.self_device_time_total / 1e3
            print(f"    {ms:8.2f} ms {ms / busy:6.1%} x{e.count:<4d} {e.key[:90]}")


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
    print("== SVTR-MRN training, full width")
    trained, learners, loader = phase_train(rng)
    print("== profile of one bf16 training step of each kind")
    phase_profile(learners["bf16"], loader)
    print(f"== done in {time.perf_counter() - t_start:.1f} s")
    fused = totals[torch.bfloat16]
    rows = [("svtr_fused_block", "svtr_block.cu", "mrn_tpu/ops/svtr_block.py:166",
             served + trained["fused"], fused),
            ("svtr_attention_full", "svtr_attention.cu", "mrn_tpu/ops/svtr_attention.py:87",
             trained["full"], attn[("full", torch.bfloat16)]),
            ("svtr_attention_banded", "svtr_attention.cu", "mrn_tpu/ops/svtr_attention.py:157",
             trained["banded"], attn[("banded", torch.bfloat16)])]
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
          f"router steps ({trained['fused']}); attention times are one expert forward's "
          f"6 Blocks of each kind; on {smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
