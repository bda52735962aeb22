"""Inference CLI of the port (the port's copy of the JAX package's
``recognize_cli.py``): recognise the text of every jpg/jpeg/png crop in a
folder, no labels needed.

    python3 -m mrn_tpu_torch.recognize_cli --config configs/svtr_mrn.py \\
        --saved_model saved_models/SVTR_MRN/Bangla_5_1_best_score.msgpack \\
        --image_folder ./crops [--taski 5] [--device cpu]

Prints one line per crop, ``path<TAB>prediction<TAB>confidence``, the
confidence the product of the max softmax over the decoded steps (an Attn
word and its probabilities cut at the first "[EOS]", as evaluation does).
The checkpoint is rebuilt as ``evaluate_cli`` rebuilds it (cumulative
dictionary over tasks 0..taski).  Runs on the CUDA card unless ``--device``
names another.
"""

from __future__ import annotations

import argparse
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.data.dataset import RawDataset
from mrn_tpu_torch.data.manager import EpochLoader
from mrn_tpu_torch.data.transform import build_transform
from mrn_tpu_torch.evaluate_cli import load_learner, val_choose

__all__ = ["main", "recognize"]


def recognize(learner, opt, image_folder: str) -> Iterator[Tuple[str, str, float]]:
    """Yields (path, prediction, confidence) for every crop of the folder
    (sorted paths)."""
    ds = RawDataset(image_folder, opt)
    if len(ds) == 0:
        return
    loader = EpochLoader(ds, opt.batch_size, build_transform(opt, mode="test"), shuffle=False,
                         pad_to_batch=True, rng=np.random.default_rng(opt.manual_seed))
    converter = learner.converter
    choose = val_choose(opt, learner._cur_task)
    is_attn = opt.Prediction == "Attn"
    for images, paths, n_valid in loader:
        # empty targets: the batch's loss is not read
        labels_index, lengths = converter.encode([""] * len(paths),
                                                 batch_max_length=opt.batch_max_length)
        out = learner.eval_batch(images, labels_index, lengths, val_choose=choose)
        preds_index, max_probs = out["preds_index"], out["max_probs"]
        words = converter.decode(preds_index, np.full((preds_index.shape[0],),
                                                      preds_index.shape[1]))
        for i in range(n_valid):
            prd, prd_max_prob = words[i], max_probs[i]
            if is_attn:
                eos = prd.find("[EOS]")
                if eos >= 0:
                    prd, prd_max_prob = prd[:eos], prd_max_prob[:eos]
            conf = float(np.prod(prd_max_prob)) if len(prd_max_prob) else 0.0
            yield paths[i], prd, conf


def main(argv: Optional[Sequence[str]] = None):
    """Prints and returns the (path, prediction, confidence) list."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--saved_model", required=True)
    parser.add_argument("--image_folder", required=True)
    parser.add_argument("--taski", type=int, default=None,
                        help="cumulative-dict task index (default: last)")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    opt = load_config(args.config)
    if args.batch_size:
        opt.batch_size = args.batch_size
    np.random.seed(opt.manual_seed)
    last_task = args.taski if args.taski is not None else len(opt.lan_list) - 1
    learner = load_learner(opt, args.saved_model, last_task, device=args.device)
    results = list(recognize(learner, opt, args.image_folder))
    for path, word, conf in results:
        print(f"{path}\t{word}\t{conf:.4f}")
    return results


if __name__ == "__main__":
    main()
