"""Learning-rate schedules as plain functions of the update count (mirrors
``mrn_tpu/ops/schedules.py``):

- ``onecycle_schedule``: ``torch.optim.lr_scheduler.OneCycleLR`` with the
  reference's settings (div_factor 20, final_div_factor 1000, cosine
  annealing, pct_start 0.3);
- ``multistep_schedule``: milestone decay, milestones as fractions of
  ``num_iter``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

__all__ = ["multistep_schedule", "onecycle_schedule"]


def onecycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.3,
                      div_factor: float = 20.0,
                      final_div_factor: float = 1000.0) -> Callable[[int], float]:
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_end = float(pct_start * total_steps) - 1.0   # torch's phase ends
    down_end = float(total_steps) - 1.0

    def cos_anneal(start, end, pct):
        pct = min(max(pct, 0.0), 1.0)
        return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))

    def schedule(step: int) -> float:
        if step <= up_end:
            return cos_anneal(initial_lr, max_lr, step / max(up_end, 1e-8))
        return cos_anneal(max_lr, min_lr, (step - up_end) / max(down_end - up_end, 1e-8))

    return schedule


def multistep_schedule(lr: float, milestones: Sequence[float], drop_rate: float,
                       num_iter: int) -> Callable[[int], float]:
    bounds = [float(m) * num_iter for m in milestones]

    def schedule(step: int) -> float:
        out = lr
        for b in bounds:
            if step >= b:
                out *= drop_rate
        return out

    return schedule
