"""One reading of a phase of ``chip_smoke.py`` from the checkout
``--root``, in a fresh process, so that two commits can be read in turns
on one card:

    python3 scripts/torch_phase_reading.py --root CHECKOUT --phase campaign|blocks

``campaign``: the 6-task SVTR-MRN campaign cut to 20 steps a task, its
checks and its (e) step-0 windows and idle share (``phase_campaign``);
``blocks``: the fused inference Block (row 4) against its plain version
at the four Block shapes, timed (``phase_blocks``).  Build the kernels
once (``_build.build_all()``) and copy ``build/mrn_tpu_torch`` into the
other checkout's ``build/`` (same sources, same hashes), then read
parent, change, change, parent.  Needs a CUDA card.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--phase", choices=("campaign", "blocks"), required=True)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_phase_reading.py needs a CUDA card")
    import chip_smoke as c
    if os.path.dirname(os.path.abspath(c.__file__)) != root:
        sys.exit(f"chip_smoke imported from {c.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    print("root", root, flush=True)
    print(c.phase_environment(), flush=True)
    t0 = time.time()
    if args.phase == "blocks":
        totals = c.phase_blocks(device, np.random.default_rng(c.SEED))
        print(f"row 4, 12 Blocks: bf16 {totals[torch.bfloat16]['ms']:.4f} ms, "
              f"f32 {totals[torch.float32]['ms']:.4f} ms")
    else:
        os.makedirs(os.path.join(root, "build"), exist_ok=True)
        out = tempfile.mkdtemp(prefix="phase_reading_", dir=os.path.join(root, "build"))
        try:
            c.phase_campaign(out, device, c.campaign_source())
        finally:
            shutil.rmtree(out, ignore_errors=True)
    print(f"{args.phase} phase seconds {time.time() - t0:.1f}")


if __name__ == "__main__":
    main()
