"""Datasets (the port's copies of ``ArrayDataset``, ``Subset``,
``ConcatDataset``, ``IndexConcatDataset``, ``BankDataset``,
``DeviceImageBank``, ``bank_dataset``, ``LmdbDataset``, ``RawDataset`` and
``hierarchical_dataset`` from ``mrn_tpu/data/dataset.py``).  An item is
``(image, label)``: a uint8 crop, a float32 crop already normalised, or an
int32 index into the learner's image bank.

``LmdbDataset`` reads the reference's LMDB crop files (``image-%09d`` /
``label-%09d`` records, keys from 1, ``num-samples``; labels longer than
``opt.batch_max_length`` left out) and ``RawDataset`` a folder of
jpg/jpeg/png files (sorted paths, the path as the label).  Their items are
the crop decoded and resized to ``(imgH, imgW)`` RGBA in one call
(``data.image.decode``): what the JAX item, a PIL image, gives after
``ResizeNormalize``'s resize, which then returns it as it is.  Under
``opt.Aug`` (training sets; every ``RawDataset``) the item is the crop at
its own size, as JAX's is, and the augmentation resizes it.  Bytes that
cannot be read give a blank crop labelled ``[dummy_label]``, as JAX's
``except (IOError, OSError)`` does; a valid file of a form the port does
not decode raises.  ``hierarchical_dataset`` opens every leaf directory
under a root (``os.walk`` order) whose path contains one of
``select_data``'s entries, iterated as JAX iterates them (the default
``"/"`` per character), with JAX's log text.

``DeviceImageBank`` is the growable bank: tasks ``add`` their uint8 crops
once (the chunk's global offset comes back, and the device copy is
dropped); ``as_device_array(device)`` concatenates the chunks onto the
device when it is next asked for.  ``bank_dataset`` resizes a dataset's
crops once into the bank and returns the index view.
"""

from __future__ import annotations

import bisect
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mrn_tpu_torch.data import image as image_codec

__all__ = ["ArrayDataset", "BankDataset", "ConcatDataset", "DeviceImageBank",
           "IndexConcatDataset", "LmdbDataset", "RawDataset", "Subset", "bank_dataset",
           "hierarchical_dataset"]


class DeviceImageBank:
    """A growable uint8 image bank ``[N, H, W, C]`` kept as host chunks and
    copied to the device whole, once per growth; ``datasets`` caches the
    banked views a run builds."""

    def __init__(self):
        self.chunks: List[np.ndarray] = []
        self.total = 0
        self._dev: Optional[torch.Tensor] = None
        self.datasets: Dict = {}

    def __len__(self):
        return self.total

    def add(self, images: np.ndarray) -> int:
        """``images`` [n, H, W, C] uint8; returns their global offset."""
        if images.dtype != np.uint8:
            raise ValueError(f"the bank holds uint8 crops, not {images.dtype}")
        offset = self.total
        self.chunks.append(images)
        self.total += len(images)
        self._dev = None
        return offset

    def as_device_array(self, device) -> torch.Tensor:
        device = torch.device(device)
        if self._dev is None or self._dev.device != device:
            host = self.chunks[0] if len(self.chunks) == 1 else np.concatenate(self.chunks)
            self._dev = torch.as_tensor(host, device=device)
        return self._dev


def _augmented(opt) -> bool:
    return opt.get("Aug", "None") not in (None, "None")


def bank_dataset(dataset, opt, bank: DeviceImageBank) -> "BankDataset":
    """Resizes every crop of ``dataset`` once to ``(imgH, imgW)`` RGBA uint8
    (Pillow's bicubic; LMDB items are at that size already), appends them
    to ``bank`` and returns the index view.  Refused under ``opt.Aug``:
    the crops are frozen when banked."""
    if _augmented(opt):
        raise ValueError("device_bank is incompatible with Aug (images are resized and "
                         "frozen once; augmentation needs per-epoch randomness)")
    size = (opt.imgW, opt.imgH)
    images, labels = [], []
    for i in range(len(dataset)):
        img, label = dataset[i]
        images.append(image_codec.resize(img, size))
        labels.append(label)
    offset = bank.add(np.stack(images))
    return BankDataset(offset, labels)


class BankDataset:
    """Items ``(np.int32 global bank index, label)``: the crops live in an
    image bank and loaders move only indices."""

    def __init__(self, start: int, labels: Sequence[str]):
        self.start = start
        self.labels = labels

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        return np.int32(self.start + idx), self.labels[idx]


class ArrayDataset:
    def __init__(self, images: Sequence, labels: Sequence[str]):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images for {len(labels)} labels")
        self.images = images
        self.labels = labels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return self.images[idx], self.labels[idx]


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError("ConcatDataset of no datasets")
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx):
        if idx < 0:
            if -idx > len(self):
                raise ValueError("index out of range")
            idx = len(self) + idx
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if dataset_idx == 0 else idx - self.cumulative_sizes[dataset_idx - 1]
        return dataset_idx, sample_idx

    def __getitem__(self, idx):
        dataset_idx, sample_idx = self._locate(idx)
        return self.datasets[dataset_idx][sample_idx]


class IndexConcatDataset(ConcatDataset):
    """Items ``((image, label), dataset_idx)``: the router's target.  The
    rehearsal memory nests as ONE element, so under
    ``router_labels="reference"`` the index is memory (0) or current (1)."""

    def __getitem__(self, idx):
        dataset_idx, sample_idx = self._locate(idx)
        return self.datasets[dataset_idx][sample_idx], dataset_idx


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]


class LmdbDataset:
    """The reference's LMDB crop dataset; see the module doc."""

    def __init__(self, root: str, opt, mode: str = "train"):
        from mrn_tpu_torch.data.lmdb_store import LmdbReader

        self.root = root
        self.opt = opt
        self.mode = mode
        self.env = LmdbReader(root)
        n = int(self.env.get(b"num-samples").decode())
        self.filtered_index_list: List[int] = []
        for index in range(1, n + 1):  # the keys start at 1
            label = self.env.get(b"label-%09d" % index)
            if label is None or len(label.decode("utf-8")) > opt.batch_max_length:
                continue
            self.filtered_index_list.append(index)

    def __len__(self):
        return len(self.filtered_index_list)

    def __getitem__(self, idx):
        index = self.filtered_index_list[idx]
        label = self.env.get(b"label-%09d" % index).decode("utf-8")
        buf = self.env.get(b"image-%09d" % index) or b""
        size = (self.opt.imgW, self.opt.imgH)
        if self.mode == "train" and _augmented(self.opt):
            size = None     # the augmentation resizes
        try:
            img = image_codec.decode(buf, size, key=f"{self.root} image-{index:09d}")
        except OSError:
            img = np.zeros((self.opt.imgH, self.opt.imgW, 4), np.uint8)
            label = "[dummy_label]"
        return img, label


class RawDataset:
    """A folder of jpg/jpeg/png crops; items ``(crop, path)``."""

    def __init__(self, root: str, opt):
        self.opt = opt
        self.image_path_list = []
        for dirpath, _, filenames in os.walk(root):
            for name in filenames:
                if os.path.splitext(name)[1].lower() in (".jpg", ".jpeg", ".png"):
                    self.image_path_list.append(os.path.join(dirpath, name))
        self.image_path_list.sort()

    def __len__(self):
        return len(self.image_path_list)

    def __getitem__(self, idx):
        path = self.image_path_list[idx]
        try:
            size = None if _augmented(self.opt) else (self.opt.imgW, self.opt.imgH)
            with open(path, "rb") as f:
                img = image_codec.decode(f.read(), size, key=path)
        except OSError:
            img = np.zeros((self.opt.imgH, self.opt.imgW, 4), np.uint8)
        return img, path


def hierarchical_dataset(root: str, opt, select_data="/", mode: str = "train"):
    """``(ConcatDataset of every selected leaf directory, log text)``; see
    the module doc."""
    dataset_list = []
    dataset_log = f"dataset_root:  {root}\t dataset: {select_data}\n"
    for dirpath, dirnames, _ in os.walk(root + "/"):
        if not dirnames:
            if any(sel in dirpath for sel in select_data):
                ds = LmdbDataset(dirpath, opt, mode=mode)
                dataset_log += (f"sub-directory:\t/{os.path.relpath(dirpath, root)}"
                                f"\t num samples: {len(ds)}\n")
                dataset_list.append(ds)
    return ConcatDataset(dataset_list), dataset_log
