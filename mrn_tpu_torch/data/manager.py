"""Evaluation loaders (the port's copies of ``EpochLoader`` in its eval
form and ``ValDataset`` from ``mrn_tpu/data/manager.py``).

``ValDataset(val_datas, opt, dataset_factory)`` builds, from
``dataset_factory(val_data) -> dataset``:

- ``create_dataset()``: the current (last) set's loader, the step-0
  validation of a task;
- ``create_list_dataset()``: every set, each capped at 700 crops drawn with
  the ValDataset's generator, concatenated: the routed (step-1) validation.

The loaders run in order (no shuffle) and pad the last batch to the batch
size with zero images and ``""`` labels, yielding ``(images, labels,
n_valid)``.  The training stream (``DatasetManager``) is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from mrn_tpu_torch.data.dataset import ConcatDataset, Subset

__all__ = ["EpochLoader", "ValDataset"]

# the reference caps each test set of the all-task validation at 700 crops
LIST_CAP = 700


class EpochLoader:
    """Batches of ``batch_size`` in dataset order, the last one padded."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def _collate(self, items):
        images = [im for im, _ in items]
        labels = [lb for _, lb in items]
        n_valid = len(images)
        if n_valid < self.batch_size:
            pad = self.batch_size - n_valid
            images += [np.zeros_like(images[0])] * pad
            labels += [""] * pad
        batch = np.stack(images)
        # uint8 crops stay uint8 (normalised on the device); other integer
        # batches are bank indices (int32); images are float32
        if batch.dtype != np.uint8:
            batch = batch.astype(np.int32 if np.issubdtype(batch.dtype, np.integer)
                                 else np.float32)
        return batch, labels, n_valid

    def __iter__(self):
        for start in range(0, len(self.dataset), self.batch_size):
            stop = min(start + self.batch_size, len(self.dataset))
            yield self._collate([self.dataset[i] for i in range(start, stop)])


class ValDataset:
    def __init__(self, val_datas, opt, dataset_factory: Callable):
        self.val_datas = list(val_datas)
        self.current_data = self.val_datas[-1]
        self.opt = opt
        self.rng = np.random.default_rng(opt.manual_seed)
        self._factory = dataset_factory

    def _loader(self, dataset) -> EpochLoader:
        return EpochLoader(dataset, self.opt.batch_size)

    def create_dataset(self, val_data=None) -> EpochLoader:
        return self._loader(self._factory(val_data or self.current_data))

    def create_list_dataset(self, valid_datas=None) -> EpochLoader:
        concat = []
        for val_data in (valid_datas or self.val_datas):
            ds = self._factory(val_data)
            if len(ds) > LIST_CAP:
                idx = self.rng.choice(len(ds), LIST_CAP, replace=False)
                ds = Subset(ds, idx.tolist())
            concat.append(ds)
        return self._loader(ConcatDataset(concat))
