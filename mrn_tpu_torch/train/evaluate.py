"""Validation: word accuracy, ICDAR2019 NED and confidences over an eval
loader (the port's copy of ``mrn_tpu/train/evaluate.py``).

The device side is the learner's ``eval_batch`` (greedy argmax, max softmax
and the loss sums); the host side decodes and scores.  Eval batches are
padded to a fixed size; only the first ``n_valid`` rows of each count.
"""

from __future__ import annotations

import time
from typing import Callable, List

import numpy as np

from mrn_tpu_torch.ops.metrics import ned_score

__all__ = ["ValidationResult", "validation"]


class ValidationResult:
    def __init__(self, loss, score, ned, preds, confidences, labels,
                 infer_time, length_of_data):
        self.loss = loss
        self.score = score
        self.ned = ned
        self.preds = preds
        self.confidences = confidences
        self.labels = labels
        self.infer_time = infer_time
        self.length_of_data = length_of_data


def validation(eval_batch: Callable, eval_loader, converter, opt,
               is_attn: bool = False) -> ValidationResult:
    """``eval_batch(images, labels_index, lengths)`` -> dict(preds_index
    [B, S], max_probs [B, S], loss_sum, loss_count) on the host;
    ``eval_loader`` yields ``(images, labels, n_valid)``.  ``infer_time``
    is the host time of the ``eval_batch`` calls, which end in a copy to
    the host."""
    n_correct = 0
    norm_ed = 0.0
    length_of_data = 0
    infer_time = 0.0
    loss_sum, loss_count = 0.0, 0.0
    all_preds: List[str] = []
    all_confs: List[float] = []
    all_labels: List[str] = []

    for images, labels, n_valid in eval_loader:
        labels_index, lengths = converter.encode(
            labels, batch_max_length=opt.batch_max_length)
        t0 = time.time()
        out = eval_batch(images, labels_index, lengths)
        preds_index = np.asarray(out["preds_index"])
        infer_time += time.time() - t0

        max_probs = np.asarray(out["max_probs"])
        loss_sum += float(out["loss_sum"])
        loss_count += float(out["loss_count"])

        s = preds_index.shape[1]
        preds_str = converter.decode(preds_index, np.full((preds_index.shape[0],), s))
        length_of_data += n_valid

        for i in range(n_valid):
            gt, prd, prd_max_prob = labels[i], preds_str[i], max_probs[i]
            if is_attn:
                # cut at the string index, as the JAX package does (a
                # multi-character token before [EOS] shifts the cut)
                eos = prd.find("[EOS]")
                if eos >= 0:
                    prd = prd[:eos]
                    prd_max_prob = prd_max_prob[:eos]
            if opt.NED:
                norm_ed += ned_score(prd, gt)
            if prd == gt:
                n_correct += 1
            conf = float(np.prod(prd_max_prob)) if len(prd_max_prob) else 0.0
            all_preds.append(prd)
            all_confs.append(conf)
            all_labels.append(gt)

    ned = norm_ed / max(1, length_of_data) * 100 if opt.NED else None
    score = n_correct / max(1, length_of_data) * 100
    loss = loss_sum / max(1.0, loss_count)
    return ValidationResult(loss, score, ned, all_preds, all_confs, all_labels,
                            infer_time, length_of_data)
