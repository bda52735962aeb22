"""Host-side text metrics (the port's copy of ``mrn_tpu/ops/metrics.py``):
Levenshtein edit distance, the ICDAR2019 normalized edit distance of the
evaluation harness, and word accuracy."""

from __future__ import annotations

__all__ = ["edit_distance", "ned_score", "word_accuracy"]


def edit_distance(a: str, b: str) -> int:
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def ned_score(pred: str, gt: str) -> float:
    """Per-sample ICDAR2019 NED contribution."""
    if len(gt) == 0 or len(pred) == 0:
        return 0.0
    if len(gt) > len(pred):
        return 1.0 - edit_distance(pred, gt) / len(gt)
    return 1.0 - edit_distance(pred, gt) / len(pred)


def word_accuracy(preds, gts) -> float:
    """Share of exact matches, in percent."""
    n = sum(1 for p, g in zip(preds, gts) if p == g)
    return n / max(1, len(gts)) * 100.0
