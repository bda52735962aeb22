"""Synthetic word crops for training and evaluating without a dataset (the
port's own copies of ``mrn_tpu/data/synthetic.py``): crops whose pixels
encode the label, so small models can learn them.

- ``synth_word_image`` ("bands": one intensity per character, for small
  alphabets) and ``synth_word_image_bits`` ("bits": a 4x4 block pattern of
  the character's index, for alphabets of thousands);
- ``make_task_dataset``: one task's crops, characters uniform or
  Zipf-distributed with word lengths ``p(L) ~ 1/L``;
- ``make_task_suite``: every task's train and test sets, with one character
  index across tasks (the bit renderer shows the task) and an optional
  ``shared_alphabet`` prepended to every task;
- ``SyntheticSource``: the suite as ``DatasetManager`` / ``ValDataset``
  factories keyed by language, in bank mode one uint8 bank ``[N, H, W, 4]``
  of every crop (``device_bank(device)`` copies it to the device once) with
  ``BankDataset`` index views, saved to and loaded from an ``.npz`` cache.

Every draw is numpy's, in the JAX package's order, so the same seed gives
the same crops and labels byte for byte.

``SyntheticTaskLoader`` (a per-task bank sampled with replacement) and
``synthetic_val_set`` serve ``chip_smoke.py``'s single-task phases.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mrn_tpu_torch.data.dataset import ArrayDataset, BankDataset

__all__ = ["SyntheticSource", "SyntheticTaskLoader", "alphabet_of_size",
           "make_task_dataset", "make_task_suite", "synth_word_image",
           "synth_word_image_bits", "synthetic_val_set"]


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


def synth_word_image(word: str, alphabet: str, img_h: int = 32, img_w: int = 64,
                     rng=None) -> np.ndarray:
    """RGBA uint8 crop for small alphabets: each character paints a vertical
    band whose intensity identifies it; light noise on top."""
    rng = rng or np.random.default_rng(0)
    img = np.zeros((img_h, img_w, 4), dtype=np.float32)
    img[..., 3] = 255.0
    n = max(1, len(word))
    band = img_w // n
    for i, ch in enumerate(word):
        k = alphabet.index(ch)
        level = 40 + (215 * (k + 1)) // (len(alphabet) + 1)
        x0, x1 = i * band, min(img_w, (i + 1) * band)
        img[:, x0:x1, 0] = level
        img[:, x0:x1, 1] = 255 - level
        img[:, x0:x1, 2] = (level * 2) % 255
    img[..., :3] += rng.normal(0, 4.0, size=img[..., :3].shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_task_dataset(alphabet: str, n_samples: int, img_h: int = 32,
                      img_w: int = 64, min_len: int = 1, max_len: int = 4,
                      seed: int = 0, renderer: str = "bands",
                      pretransformed: bool = False,
                      char_to_idx: Optional[Dict[str, int]] = None,
                      zipf: float = 0.0) -> ArrayDataset:
    """``n_samples`` crops of words over ``alphabet`` from
    ``default_rng(seed)``.  ``renderer`` "bands" or "bits" (whose index map
    ``char_to_idx`` defaults to the alphabet's order); ``pretransformed``
    stores float32 crops normalised to [-1, 1]; ``zipf`` > 0 draws
    characters Zipf(s=zipf) by alphabet rank and lengths ``p(L) ~ 1/L``."""
    rng = np.random.default_rng(seed)
    if char_to_idx is None:
        char_to_idx = {ch: i for i, ch in enumerate(alphabet)}
    chars = list(alphabet)
    char_p = len_p = None
    if zipf > 0:
        char_p = 1.0 / np.arange(1, len(chars) + 1) ** zipf
        char_p /= char_p.sum()
        len_p = 1.0 / np.arange(min_len, max_len + 1)
        len_p /= len_p.sum()
    images, labels = [], []
    for _ in range(n_samples):
        if len_p is not None:
            length = int(rng.choice(np.arange(min_len, max_len + 1), p=len_p))
        else:
            length = int(rng.integers(min_len, max_len + 1))
        word = "".join(rng.choice(chars, size=length, p=char_p))
        if renderer == "bits":
            img = synth_word_image_bits(word, char_to_idx, img_h, img_w, rng)
        else:
            img = synth_word_image(word, alphabet, img_h, img_w, rng)
        if pretransformed:
            img = (img.astype(np.float32) / 255.0 - 0.5) / 0.5
        images.append(img)
        labels.append(word)
    return ArrayDataset(images, labels)


def make_task_suite(task_alphabets: Sequence[str], n_train, n_test,
                    img_h: int = 32, img_w: int = 64, seed: int = 0,
                    min_len: int = 1, max_len: int = 4,
                    renderer: str = "bands", pretransformed: bool = False,
                    zipf: float = 0.0, shared_alphabet: str = ""):
    """Per-task train and test ``ArrayDataset``s and per-task character
    lists ``(trains, tests, dicts)``; task ``i`` draws its train set from
    seed ``seed + 2i`` and its test set from ``seed + 2i + 1``.  ``n_train``
    / ``n_test`` are ints or per-task sequences."""
    if shared_alphabet:
        task_alphabets = [shared_alphabet + a for a in task_alphabets]
    global_map: Dict[str, int] = {}
    for alphabet in task_alphabets:
        for ch in alphabet:
            global_map.setdefault(ch, len(global_map))
    trains, tests, dicts = [], [], []
    for i, alphabet in enumerate(task_alphabets):
        nt = n_train[i] if isinstance(n_train, (list, tuple)) else n_train
        nv = n_test[i] if isinstance(n_test, (list, tuple)) else n_test
        kw = dict(img_h=img_h, img_w=img_w, min_len=min_len, max_len=max_len,
                  renderer=renderer, pretransformed=pretransformed, zipf=zipf,
                  char_to_idx=global_map if renderer == "bits" else None)
        trains.append(make_task_dataset(alphabet, nt, seed=seed + 2 * i, **kw))
        tests.append(make_task_dataset(alphabet, nv, seed=seed + 2 * i + 1, **kw))
        dicts.append(list(alphabet))
    return trains, tests, dicts


class SyntheticSource:
    """The synthetic suite keyed by language name: ``train_factory(root,
    taski, mode)`` for ``DatasetManager``, ``val_factory(".../<lan>")`` for
    ``ValDataset``.  With ``device_bank=True`` every crop (train sets, then
    test sets, in task order) is stored once in the uint8 ``bank`` and the
    datasets are ``BankDataset`` index views into it."""

    def __init__(self, task_alphabets: Sequence[str], lan_list: Sequence[str],
                 n_train=64, n_test=16, img_h: int = 32,
                 img_w: int = 64, seed: int = 0, device_bank: bool = False,
                 **suite_kw):
        if device_bank:  # the bank holds raw uint8 renders
            suite_kw = dict(suite_kw, pretransformed=False)
        trains, tests, dicts = make_task_suite(task_alphabets, n_train, n_test,
                                               img_h, img_w, seed, **suite_kw)
        self.lan_list = list(lan_list)
        self.bank: Optional[np.ndarray] = None
        self._bank_dev: Optional[torch.Tensor] = None
        if device_bank:
            chunks, offset = [], 0
            for store in (trains, tests):
                for i, ds in enumerate(store):
                    chunks.append(np.stack(ds.images))
                    store[i] = BankDataset(offset, ds.labels)
                    offset += len(ds.labels)
            self.bank = np.concatenate(chunks, axis=0)
        self.trains = dict(zip(lan_list, trains))
        self.tests = dict(zip(lan_list, tests))
        self.dicts: Dict[str, List[str]] = dict(zip(lan_list, dicts))

    def save(self, path: str) -> None:
        """Writes a bank-mode suite (the uint8 bank, each split's start and
        labels) as ``.npz``."""
        if self.bank is None:
            raise ValueError("save() needs a bank-mode suite (device_bank=True)")
        payload = {"bank": self.bank}
        for split, store in (("train", self.trains), ("test", self.tests)):
            for lan, ds in store.items():
                payload[f"{split}_{lan}_start"] = np.int64(ds.start)
                payload[f"{split}_{lan}_labels"] = np.array(ds.labels)
        np.savez(path if path.endswith(".npz") else path + ".npz", **payload)

    @classmethod
    def load(cls, path: str, lan_list: Sequence[str],
             task_alphabets: Sequence[str]) -> "SyntheticSource":
        """A bank-mode suite written by ``save`` (the alphabets are passed
        in, not stored)."""
        src = cls.__new__(cls)
        with np.load(path) as z:
            src.bank = z["bank"]
            src.lan_list = list(lan_list)
            src._bank_dev = None
            src.trains, src.tests = {}, {}
            for split, store in (("train", src.trains), ("test", src.tests)):
                for lan in lan_list:
                    store[lan] = BankDataset(int(z[f"{split}_{lan}_start"]),
                                             [str(s) for s in z[f"{split}_{lan}_labels"]])
        src.dicts = {lan: list(a) for lan, a in zip(lan_list, task_alphabets)}
        return src

    def device_bank(self, device) -> Optional[torch.Tensor]:
        """The bank as a uint8 tensor ``[N, H, W, 4]`` on ``device``, copied
        once (``None`` outside bank mode); loaders then move only indices
        and the learner gathers on the device."""
        if self.bank is None:
            return None
        if self._bank_dev is None or self._bank_dev.device != torch.device(device):
            self._bank_dev = torch.as_tensor(self.bank, device=device)
        return self._bank_dev

    def train_factory(self, data_root: str, taski: int, mode: str):
        return self.trains[self.lan_list[taski]]

    def val_factory(self, val_data: str):
        return self.tests[val_data.rstrip("/").rsplit("/", 1)[-1]]

    def cumulative_character(self, upto_task: int) -> List[str]:
        """The characters of tasks ``0..upto_task`` in first-seen order."""
        char: Dict[str, int] = {}
        for i in range(upto_task + 1):
            for ch in self.dicts[self.lan_list[i]]:
                char.setdefault(ch, 1)
        return list(char)


# ------------------------------------------------ single-task smoke loaders
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
    characters drawn uniformly from each task's own alphabet, rendered once
    into one uint8 ``bank`` (set ``opt.image_bank = loader.bank``); batches
    of bank indices drawn with replacement for task ``taski``:

    - ``get_batch() -> (indices, words)``: the current task's crops;
    - ``get_batch2() -> (indices, words, task_ids)``: the crops of tasks
      ``0..taski``, each tagged with its task id.

    Its stream is fixed when it is built and has no rehearsal memory
    (``rehearsal = False``: the learner draws none); ``get_dataset``
    changes nothing."""

    rehearsal = False

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

    def get_dataset(self, taski, memory="random", index_list=None):
        return index_list

    def get_batch(self):
        idx = self._draw(self.current)
        return idx, [self.labels[i] for i in idx]

    def get_batch2(self):
        idx = self._draw(np.arange(len(self.labels), dtype=np.int32))
        return idx, [self.labels[i] for i in idx], self.task_ids[idx]
