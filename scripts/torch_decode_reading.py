"""One-thread host decode + resize rate of the port's codec on LMDB-phase
crops, for one checkout: RGBA PNG word crops of the campaign's first
alphabet at the LMDB phase's natural sizes (24-48 x 48-320 px, zlib level
1, as ``create_lmdb.create_synthetic_dataset`` writes them), each decoded
and resized to 32x256 by ``data.image.decode``; the best of ``--rounds``
passes over ``--crops`` crops, as one JSON line.

    python3 scripts/torch_decode_reading.py [--root CHECKOUT]

Compare two checkouts on one machine in turns (parent, change, change,
parent), one process each; the codec builds with g++ into each
checkout's ``build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--crops", type=int, default=256)
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np

    from mrn_tpu_torch import campaign
    from mrn_tpu_torch.data import image
    from mrn_tpu_torch.data.synthetic import synth_word_image_bits

    alphabet = campaign.task_alphabets()[0]
    index = {ch: i for i, ch in enumerate(alphabet)}
    rng = np.random.default_rng(0)
    bufs = []
    for _ in range(args.crops):
        h, w = int(rng.integers(24, 49)), int(rng.integers(48, 321))
        word = "".join(alphabet[int(i)] for i in rng.integers(0, 64, int(rng.integers(1, 9))))
        bufs.append(image.encode_png(synth_word_image_bits(word, index, h, w, rng), level=1))
    image.decode(bufs[0], (256, 32))     # builds or loads the codec
    rates = []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        for buf in bufs:
            image.decode(buf, (256, 32))
        rates.append(len(bufs) / (time.perf_counter() - t0))
    print(json.dumps({"root": os.path.abspath(args.root), "crops": len(bufs),
                      "best_crops_per_s": round(max(rates), 1),
                      "rounds_crops_per_s": [round(r, 1) for r in rates]}))


if __name__ == "__main__":
    main()
