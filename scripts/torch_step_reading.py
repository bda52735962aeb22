"""Step-time readings of the port's SVTR-MRN training step 0 (task 5 of
the 6-task sequence at full width, bf16 policy, batch 256, composed and
fused Blocks) on the CUDA card, to tell the two readings of a step's time
apart from what runs between steps:

- ``per_step``: each step timed on the host from fetching its batch to
  reading its loss back (which waits for the device);
- ``window``: N steps with their losses left on the device, one read and
  one sync at the end, the time divided by N (the ``StepMeter`` reading of
  ``BaseLearner._run_loop``);

each of STEPS steps, taken fresh (after warm-up steps), after the host
idles for LONG_PAUSE seconds (about as long as the first validation with
its expert blobs), after an FF validation and a best save
(``run_validation`` + ``_save_best``, where the checkout has them) and
after the host idles for PAUSE seconds.  The readings run in that order,
ROUNDS times.

    python3 scripts/torch_step_reading.py [--root CHECKOUT]

``--root`` names the checkout whose ``mrn_tpu_torch`` and ``chip_smoke.py``
are used (default: the one holding this script), so that two commits can
be read in turns on one card.  Prints one JSON object per reading, with
the cudaMalloc calls the caching allocator made during it (per step for
``per_step``)."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

STEPS, ROUNDS = 8, 2
PAUSE, LONG_PAUSE = 0.2, 1.2   # seconds


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_step_reading.py needs a CUDA card")
    import chip_smoke as c
    from mrn_tpu_torch.config import load_config

    def device_allocs() -> int:
        return int(torch.cuda.memory_stats().get("num_device_alloc", -1))

    def per_step(learner, get_batch, n):
        ms, allocs = [], []
        for _ in range(n):
            a0 = device_allocs()
            t0 = time.perf_counter()
            rec = learner.train_step(get_batch())
            float(rec["loss"])
            ms.append(1e3 * (time.perf_counter() - t0))
            allocs.append(device_allocs() - a0)
        return ms, allocs

    def window(learner, get_batch, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = [learner.train_step(get_batch()) for _ in range(n)]
        torch.stack([r["loss"].float() for r in recs]).cpu()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="step_reading_", dir=os.path.join(root, "build"))
    try:
        base = load_config(os.path.join(root, "configs", "svtr_mrn.py"), output_dir=out_dir,
                           data_log=os.path.join(out_dir, "data_any.txt"))
        setup = c._train_setup(base)
        character, loader = "".join(setup[0]), setup[1]
        valid = setup[2] if len(setup) > 2 else None
        rng = np.random.default_rng(c.SEED)
        for fused in (False, True):
            with c.fused_train_env(fused):
                learner = c._train_learner(base, rng, loader, "bf16")
                # incremental_train's set-up of step 0, without its loop
                learner._cur_task = c.TRAIN_TASK
                learner.character = list(character)
                learner.converter = learner.build_converter()
                learner.change_model()
                learner.build_optimizer()
                per_step(learner, loader.get_batch, 3)   # warm-up
                conditions = [("nothing", None),
                              ("long_pause", lambda: time.sleep(LONG_PAUSE))]
                if valid is not None and hasattr(learner, "run_validation"):
                    def validate(learner=learner):
                        learner.run_validation(valid.create_dataset(), "FF")
                        learner._save_best(c.TRAIN_TASK, step=0)
                    conditions.append(("validation", validate))
                conditions.append(("pause", lambda: time.sleep(PAUSE)))
                for rnd in range(ROUNDS):
                    for after, before in conditions:
                        for reading in ("per_step", "window"):
                            torch.cuda.synchronize()
                            gap = 0.0
                            if before is not None:
                                t0 = time.perf_counter()
                                before()
                                torch.cuda.synchronize()
                                gap = time.perf_counter() - t0
                            allocs = device_allocs()
                            if reading == "per_step":
                                ms, step_allocs = per_step(learner, loader.get_batch, STEPS)
                                mean = sum(ms) / len(ms)
                            else:
                                ms = mean = window(learner, loader.get_batch, STEPS)
                                step_allocs = device_allocs() - allocs
                            print(json.dumps({
                                "root": root, "route": "fused" if fused else "composed",
                                "round": rnd, "after": after, "reading": reading,
                                "steps": STEPS, "gap_s": round(gap, 4),
                                "mean_ms": round(mean, 2),
                                "ms": [round(m, 2) for m in ms] if isinstance(ms, list)
                                else round(ms, 2),
                                "device_allocs": step_allocs}), flush=True)
                del learner
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
