"""In-memory datasets (the port's copies of ``ArrayDataset``, ``Subset``,
``ConcatDataset``, ``IndexConcatDataset``, ``BankDataset`` and
``DeviceImageBank`` from ``mrn_tpu/data/dataset.py``).  An item is
``(image, label)``: a uint8 crop already at ``(imgH, imgW)``, a float32
crop already normalised, or an int32 index into the learner's image bank;
the port applies no transform (no PIL resize).

``DeviceImageBank`` is the growable bank: tasks ``add`` their uint8 crops
once (the chunk's global offset comes back, and the device copy is
dropped); ``as_device_array(device)`` concatenates the chunks onto the
device when it is next asked for.  ``bank_dataset`` (decode and resize a
dataset's crops into the bank) waits for the PIL-free transform (ROADMAP.md
§1 item 6).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["ArrayDataset", "BankDataset", "ConcatDataset", "DeviceImageBank",
           "IndexConcatDataset", "Subset"]


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
