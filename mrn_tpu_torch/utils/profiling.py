"""Profiling hooks (the port's copies of ``mrn_tpu/utils/profiling.py``):

- ``trace(logdir)``: a ``torch.profiler`` trace of the host and, with a
  card, the device (CUPTI), written to ``logdir`` as a Chrome / TensorBoard
  trace when the block ends; the profiler is yielded, so ``key_averages()``
  can be read after the block;
- ``StepMeter``: steps/s and images/s of the training loop.  The host clock
  runs ahead of the device: read a window only after the device has
  finished it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

__all__ = ["StepMeter", "trace"]


@contextlib.contextmanager
def trace(logdir: str = "./profile") -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


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
