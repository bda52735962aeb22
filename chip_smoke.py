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
   card for comparison.

Any failed check raises (exit code != 0).  The line before the last is the
per-kernel JSON record, the last line ``{"ok": true, "device": {...}}``.
Exits non-zero without printing a result when no CUDA card is present.
"""

from __future__ import annotations

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
from mrn_tpu_torch.models.svtr import Block, configure_blocks  # noqa: E402
from mrn_tpu_torch.ops import _build, svtr_block  # noqa: E402
from mrn_tpu_torch.serve import Server  # noqa: E402

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


# ------------------------------------------------------------ random weights
def _trunc02(rng, shape):
    """truncated_normal(stddev=.02, lower=-2, upper=2), as flax initialises
    SVTR kernels."""
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2.0
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2.0
    return (0.02 * z).astype(np.float32)


def _torch_dense(rng, fan_in, fan_out):
    bound = 1.0 / np.sqrt(fan_in)
    return {"kernel": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, (fan_out,)).astype(np.float32)}


def _conv(rng, cin, cout):
    std = np.sqrt(2.0 / (cin * 9))  # kaiming normal, fan_in
    return {"kernel": (std * rng.standard_normal((3, 3, cin, cout))).astype(np.float32),
            "bias": np.zeros((cout,), np.float32)}


def _affine(c, bias):
    """LayerNorm/BatchNorm scale 1 and a constant bias."""
    return {"scale": np.ones((c,), np.float32),
            "bias": np.full((c,), bias, np.float32)}


def random_block(rng, c, hidden=None):
    hidden = hidden or 4 * c
    ones, zeros = np.ones((c,), np.float32), np.zeros
    return dict(norm1_scale=ones.copy(), norm1_bias=ones.copy(),
                qkv_kernel=_trunc02(rng, (c, 3 * c)), qkv_bias=zeros((3 * c,), np.float32),
                proj_kernel=_trunc02(rng, (c, c)), proj_bias=zeros((c,), np.float32),
                norm2_scale=ones.copy(), norm2_bias=ones.copy(),
                fc1_kernel=_trunc02(rng, (c, hidden)), fc1_bias=zeros((hidden,), np.float32),
                fc2_kernel=_trunc02(rng, (hidden, c)), fc2_bias=zeros((c,), np.float32))


def random_recognizer(rng, opt, num_classes, embed=(64, 128, 256), depth=(3, 6, 3)):
    """One SVTR Recognizer's flax (params, batch_stats) trees, numpy, in the
    JAX package's init distributions."""
    e0, e1, e2 = embed
    h0, w0 = opt.imgH // 4, opt.imgW // 4
    ln = lambda c: _affine(c, 1.0)  # noqa: E731  (SVTR quirk: LN bias 1)
    bn = lambda c: _affine(c, 0.0)  # noqa: E731
    feature = {
        "patch_embed": {"conv1": _conv(rng, opt.input_channel, e0 // 2), "bn1": bn(e0 // 2),
                        "conv2": _conv(rng, e0 // 2, e0), "bn2": bn(e0)},
        "pos_embed": _trunc02(rng, (1, h0 * w0, e0)),
        "sub_sample1": {"conv": _conv(rng, e0, e1), "norm": ln(e1)},
        "sub_sample2": {"conv": _conv(rng, e1, e2), "norm": ln(e2)},
        "sub_sample3": {"conv": _conv(rng, e2, opt.output_channel),
                        "norm": ln(opt.output_channel)},
    }
    for stage, (dim, n) in enumerate(zip(embed, depth), start=1):
        for i in range(n):
            feature[f"blocks{stage}_{i}"] = random_block(rng, dim)
    params = {"extractor": {"feature": feature,
                            "seq_linear": _torch_dense(rng, opt.output_channel,
                                                       opt.hidden_size)},
              "fc": _torch_dense(rng, opt.hidden_size, num_classes)}
    stats = {"extractor": {"feature": {"patch_embed": {
        "bn1": {"mean": np.zeros((e0 // 2,), np.float32),
                "var": np.ones((e0 // 2,), np.float32)},
        "bn2": {"mean": np.zeros((e0,), np.float32),
                "var": np.ones((e0,), np.float32)}}}}}
    return params, stats


def random_mrn(rng, opt, class_counts, **kw):
    """MRNNet trees: experts stacked on axis 0 (each fc zero-padded from its
    own class count to the total, as the JAX learner stacks them) plus a
    fresh router stack."""
    num_classes = max(class_counts)
    trees = []
    for count in class_counts:
        p, s = random_recognizer(rng, opt, count, **kw)
        for leaf, axis in (("kernel", 1), ("bias", 0)):
            pad = [(0, 0)] * p["fc"][leaf].ndim
            pad[axis] = (0, num_classes - count)
            p["fc"][leaf] = np.pad(p["fc"][leaf], pad)
        trees.append((p, s))

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    h, i, t = opt.hidden_size, len(class_counts), opt.imgW // 4
    ln = lambda c: _affine(c, 0.0)  # noqa: E731
    params = {
        "experts": stack(*(p for p, _ in trees)),
        "dm_router": {"norm": ln(h), "proj_1": _torch_dense(rng, h, 2 * h),
                      "spatial_norm": ln(h), "spatial_proj": _torch_dense(rng, i * t, i * t),
                      "proj_2": _torch_dense(rng, h, h), "channel_norm": ln(t),
                      "channel_proj": _torch_dense(rng, i * h, i * h),
                      "proj_3": _torch_dense(rng, h, h)},
        "channel_route": _torch_dense(rng, i * h, i),
        "route": _torch_dense(rng, t, 1),
    }
    return params, {"experts": stack(*(s for _, s in trees))}


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
    launches, _ = phase_serve(rng)
    print(f"== done in {time.perf_counter() - t_start:.1f} s")
    bf = totals[torch.bfloat16]
    record = {"kernels": [{
        "name": "svtr_fused_block",
        "route": "cuda",
        "source": "mrn_tpu_torch/ops/csrc/svtr_block.cu",
        "replaces": "mrn_tpu/ops/svtr_block.py:166",
        "launches": launches,
        "max_abs_err": bf["max_abs_err"],
        "ms": bf["ms"],
        "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"],
        "bound_by": "operations" if bf["ops_ms"] >= bf["bytes_ms"] else "bytes",
        "library_ms": bf["library_ms"],
    }]}
    print(f"kernel record: times are one expert's 12 Blocks at batch {BATCH}, "
          f"bfloat16, on {smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
