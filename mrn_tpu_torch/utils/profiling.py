"""Steps/s and images/s of the training loop (the port's copy of
``StepMeter``, ``mrn_tpu/utils/profiling.py``).  The host clock runs ahead
of the device: read a window only after the device has finished it."""

from __future__ import annotations

import time
from typing import Optional

__all__ = ["StepMeter"]


class StepMeter:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._images = 0

    def tick(self, batch_size: int) -> None:
        self._steps += 1
        self._images += batch_size

    def seconds(self) -> float:
        """Host seconds since the window opened."""
        return max(time.perf_counter() - self._t0, 1e-9)

    def report(self, seconds: Optional[float] = None) -> str:
        """The window's rates over ``seconds`` (default: until now)."""
        dt = seconds or self.seconds()
        return (f"{self._steps / dt:0.2f} steps/s, "
                f"{self._images / dt:0.1f} imgs/s")
