"""Synthetic word crops for driving training without a dataset (the port's
own copies of ``alphabet_of_size`` and ``synth_word_image_bits`` from
``mrn_tpu/data/synthetic.py``) and a loader over a uint8 image bank.

``SyntheticTaskLoader`` renders every task's crops once into one uint8 bank
``[N, H, W, 4]`` (set ``opt.image_bank = loader.bank``; the learner copies
it to the device once and gathers there) and serves ``DatasetManager``-style
batches of bank indices for task ``taski``:

- ``get_batch() -> (indices, words)``: the current task's crops (step 0);
- ``get_batch2() -> (indices, words, task_ids)``: the crops of tasks
  ``0..taski`` (the rehearsal mix of step 1), each tagged with its task id
  (the ``dataset_idx`` of the ``router_labels="task"`` stream).

``synthetic_val_set`` renders a task's validation crops from a generator of
its own, so drawing them leaves the training stream as it was.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from mrn_tpu_torch.data.dataset import ArrayDataset

__all__ = ["SyntheticTaskLoader", "alphabet_of_size", "synth_word_image_bits",
           "synthetic_val_set"]


def alphabet_of_size(n: int, start: int = 0x4E00) -> str:
    """n distinct characters from a contiguous BMP span (default: CJK Unified
    Ideographs)."""
    return "".join(chr(start + i) for i in range(n))


def synth_word_image_bits(word: str, char_to_idx: Dict[str, int],
                          img_h: int = 32, img_w: int = 256, rng=None,
                          grid: Tuple[int, int] = (4, 4)) -> np.ndarray:
    """RGBA uint8 crop for large alphabets: each character's band carries a
    (grid_h x grid_w) block pattern encoding its index in binary, plus a
    coarse class hint on the blue channel and light noise."""
    rng = rng or np.random.default_rng(0)
    gh, gw = grid
    img = np.zeros((img_h, img_w, 4), dtype=np.float32)
    img[..., 3] = 255.0
    n = max(1, len(word))
    band = img_w // n
    for i, ch in enumerate(word):
        k = char_to_idx[ch]
        x_base = i * band
        for r in range(gh):
            y0 = r * img_h // gh
            y1 = (r + 1) * img_h // gh
            for c in range(gw):
                bit = (k >> (r * gw + c)) & 1
                x0 = x_base + c * band // gw
                x1 = x_base + (c + 1) * band // gw
                level = 225.0 if bit else 30.0
                img[y0:y1, x0:x1, 0] = level
                img[y0:y1, x0:x1, 1] = 255.0 - level
        img[:, x_base:x_base + band, 2] = 40 + (k % 199)
    img[..., :3] += rng.normal(0, 6.0, size=img[..., :3].shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _char_index(task_alphabets: Sequence[str]) -> Dict[str, int]:
    char_to_idx: Dict[str, int] = {}
    for alphabet in task_alphabets:
        for ch in alphabet:
            char_to_idx.setdefault(ch, len(char_to_idx))
    return char_to_idx


def _render(alphabet: str, char_to_idx: Dict[str, int], n: int, img_h: int,
            img_w: int, min_len: int, max_len: int, rng
            ) -> Tuple[List[np.ndarray], List[str]]:
    """``n`` crops of words drawn uniformly from ``alphabet``."""
    chars = list(alphabet)
    images, labels = [], []
    for _ in range(n):
        word = "".join(rng.choice(chars, size=int(rng.integers(min_len, max_len + 1))))
        images.append(synth_word_image_bits(word, char_to_idx, img_h, img_w, rng))
        labels.append(word)
    return images, labels


def synthetic_val_set(task_alphabets: Sequence[str], taski: int, n: int,
                      img_h: int = 32, img_w: int = 256, min_len: int = 1,
                      max_len: int = 4, seed: int = 0) -> ArrayDataset:
    """``n`` uint8 crops of task ``taski`` (``SyntheticTaskLoader``'s
    renderer and character indices) from ``default_rng(seed)``."""
    images, labels = _render(task_alphabets[taski], _char_index(task_alphabets), n,
                             img_h, img_w, min_len, max_len, np.random.default_rng(seed))
    return ArrayDataset(np.stack(images), labels)


class SyntheticTaskLoader:
    """``n_per_task`` crops per task, words of ``min_len..max_len``
    characters drawn uniformly from each task's own alphabet; the bit
    pattern encodes a character's index in the cumulative alphabet, so the
    task is readable from the crop."""

    def __init__(self, task_alphabets: Sequence[str], taski: int,
                 batch_size: int, n_per_task: int, img_h: int = 32,
                 img_w: int = 256, min_len: int = 1, max_len: int = 4,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        char_to_idx = _char_index(task_alphabets)
        images: List[np.ndarray] = []
        self.labels: List[str] = []
        for alphabet in task_alphabets[:taski + 1]:
            task_images, task_labels = _render(alphabet, char_to_idx, n_per_task,
                                               img_h, img_w, min_len, max_len, rng)
            images += task_images
            self.labels += task_labels
        self.bank = np.stack(images)
        self.task_ids = np.repeat(np.arange(taski + 1, dtype=np.int32), n_per_task)
        self.current = np.flatnonzero(self.task_ids == taski).astype(np.int32)
        self.batch_size = batch_size
        self.rng = rng

    def _draw(self, pool: np.ndarray) -> np.ndarray:
        return self.rng.choice(pool, self.batch_size,
                               replace=len(pool) < self.batch_size).astype(np.int32)

    def get_batch(self):
        idx = self._draw(self.current)
        return idx, [self.labels[i] for i in idx]

    def get_batch2(self):
        idx = self._draw(np.arange(len(self.labels), dtype=np.int32))
        return idx, [self.labels[i] for i in idx], self.task_ids[idx]
