"""Running average of scalar losses (the port's copy of
``mrn_tpu/utils/averager.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["Averager"]


class Averager:
    def __init__(self):
        self.reset()

    def add(self, v) -> None:
        v = np.asarray(v)
        self.n_count += v.size
        self.sum += float(v.sum())

    def reset(self) -> None:
        self.n_count = 0
        self.sum = 0.0

    def val(self) -> float:
        if self.n_count == 0:
            return 0.0
        return self.sum / float(self.n_count)
