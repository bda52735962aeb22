"""Step-time readings of the port's SVTR-MRN training loop as
``chip_smoke.py``'s training phase runs it: ``MRN.incremental_train`` of
task 5 of the 6-task sequence (5 frozen random experts and the new one,
full width, bf16 policy, batch 256, a uint8 bank of synthetic crops on the
card, validated on one batch), in a fresh process, with the batches drawn
through the prefetcher or not; with ``--after_phases`` the process first
runs ``chip_smoke.py``'s serving and attention phases, as ``chip_smoke.py``
does before its training phase.

    python3 torch_loop_reading.py [--root CHECKOUT] [--prefetch 0|1]
                                  [--fused 0|1] [--num_iter N]
                                  [--val_interval K] [--after_phases]

Prints one JSON line per ``StepMeter`` window of the loop (its steps, its
mean step in ms, synced at its end, and per step the host time of its
``train_step`` call in ms and the cudaMalloc calls the caching allocator
made in it) and one per process.  ``--root`` names the checkout whose
``mrn_tpu_torch`` and ``chip_smoke.py`` are used, so that two commits can
be read in turns on one card (a checkout without the prefetcher ignores
``--prefetch``)."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--prefetch", type=int, default=1)
    ap.add_argument("--fused", type=int, default=0)
    ap.add_argument("--num_iter", type=int, default=12)
    ap.add_argument("--val_interval", type=int, default=4)
    ap.add_argument("--after_phases", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_loop_reading.py needs a CUDA card")
    import chip_smoke as c
    from mrn_tpu_torch.config import load_config

    def device_allocs() -> int:
        return int(torch.cuda.memory_stats().get("num_device_alloc", -1))

    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="loop_reading_", dir=os.path.join(root, "build"))
    t_start = time.perf_counter()
    try:
        if args.after_phases:
            rng = np.random.default_rng(c.SEED)
            c.phase_serve(rng)
            c.phase_attention(torch.device("cuda", 0), rng)
        base = load_config(os.path.join(root, "configs", "svtr_mrn.py"), output_dir=out_dir,
                           data_log=os.path.join(out_dir, "data_any.txt"))
        alphabets, loader, valid = c._train_setup(base)
        base = base.replace(num_iter=args.num_iter, val_interval=args.val_interval,
                            prefetch=bool(args.prefetch))
        with c.fused_train_env(bool(args.fused)):
            learner = c._train_learner(base, np.random.default_rng(c.SEED), loader, "bf16")
            learner.opt = learner.opt.replace(num_iter=args.num_iter,
                                              val_interval=args.val_interval,
                                              prefetch=bool(args.prefetch))
            allocs, host_ms = [], []
            step = learner.train_step

            def counted(fetched):
                a0, t0 = device_allocs(), time.perf_counter()
                out = step(fetched)
                host_ms.append(round(1e3 * (time.perf_counter() - t0), 2))
                allocs.append(device_allocs() - a0)
                return out

            learner.train_step = counted
            learner.incremental_train(c.TRAIN_TASK, "".join(alphabets), loader, valid)
        windows, i = [], 0
        history = learner.history
        while i < len(history):
            j = i
            while j < len(history) and history[j]["seconds"] == history[i]["seconds"] \
                    and history[j]["step"] == history[i]["step"]:
                j += 1
            windows.append(dict(step=history[i]["step"],
                                iterations=[history[i]["iteration"], history[j - 1]["iteration"]],
                                mean_ms=round(1e3 * history[i]["seconds"], 2),
                                step_host_ms=host_ms[i:j], step_allocs=allocs[i:j]))
            i = j
        for w in windows:
            print(json.dumps(dict(root=root, prefetch=args.prefetch, fused=args.fused,
                                  after_phases=args.after_phases, **w)), flush=True)
        print(json.dumps(dict(root=root, prefetch=args.prefetch, fused=args.fused,
                              after_phases=args.after_phases,
                              process_s=round(time.perf_counter() - t_start, 1))), flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
