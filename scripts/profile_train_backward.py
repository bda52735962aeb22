#!/usr/bin/env python3
"""Device time per kernel of the fused training Block's backward (rows 6
and 7 of PERF.md's kernel table: the tail and the head) at the four SVTR
Block shapes of ``chip_smoke.BLOCK_SHAPES`` (Global stage 2 left out: its
backward has the Local stage 2's shapes), batch 256, bf16 and f32, random
weights and cotangents from a seed.  Needs a CUDA card; from the root of
the repository:

    python3 scripts/profile_train_backward.py

Prints, per shape and dtype, the device time of one tail + head call and
each kernel's share (``torch.profiler`` over three calls, after a warm-up
call), with the card's name and power limit first.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import BATCH, BLOCK_SHAPES, SEED  # noqa: E402
from mrn_tpu_torch.models.init import random_block  # noqa: E402
from mrn_tpu_torch.ops import svtr_train_block as tb  # noqa: E402

CALLS = 3


def short(name):
    return re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))[:110]


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_train_backward: no CUDA card available")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    for dt in (torch.bfloat16, torch.float32):
        for name, hw, c, heads, mixer, _ in BLOCK_SHAPES:
            if name == "stage2-global":
                continue
            n = hw[0] * hw[1]
            p = {k: torch.from_numpy(v).to(dev, dt) for k, v in random_block(rng, c).items()}
            x = torch.from_numpy(rng.standard_normal((BATCH, n, c)).astype(np.float32)).to(dev, dt)
            dm = torch.ones(BATCH, 1, device=dev)
            band = (hw[0], hw[1], 7, 11) if mixer == "Local" else None
            _, (qkv, attn, y, h1) = tb.forward(x, p, dm, dm, heads, (c // heads) ** -0.5, band)
            g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(dev, dt)
            dqkv = torch.from_numpy(rng.standard_normal(qkv.shape).astype(np.float32)).to(dev, dt)

            def backward():
                dy, _, _ = tb.bwd_tail(g, y, h1, attn, p, dm, dm)
                tb.bwd_head(x, dy, dqkv, p)

            backward()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(CALLS):
                    backward()
                torch.cuda.synchronize()
            rows = []
            for e in prof.key_averages():
                t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                if t > 0:
                    rows.append((t / CALLS, e.count // CALLS, short(e.key)))
            rows.sort(reverse=True)
            total = sum(r[0] for r in rows)
            print(f"== {str(dt)[6:]} {name} [{BATCH},{n},{c}]: device us per tail + head "
                  f"{total:.1f}")
            for t, k, kernel in rows:
                print(f"   {t:9.1f} us  x{k}  {kernel}")


if __name__ == "__main__":
    main()
