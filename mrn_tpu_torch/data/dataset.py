"""In-memory datasets (the port's copies of ``ArrayDataset``, ``Subset``
and ``ConcatDataset`` from ``mrn_tpu/data/dataset.py``).  An item is
``(image, label)``: a uint8 crop already at ``(imgH, imgW)``, a float32
crop already normalised, or an int32 index into the learner's image bank;
the port applies no transform (no PIL resize)."""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np

__all__ = ["ArrayDataset", "ConcatDataset", "Subset"]


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

    def __getitem__(self, idx):
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if dataset_idx == 0 else idx - self.cumulative_sizes[dataset_idx - 1]
        return self.datasets[dataset_idx][sample_idx]


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]
