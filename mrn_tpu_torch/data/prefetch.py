"""Background batch prefetching (the port of ``mrn_tpu/data/prefetch.py``):
a thread draws the training loop's batches while the device computes.

Unlike the JAX package's, this prefetcher is told how many batches the loop
takes and draws exactly those, and ``close`` joins its thread.  The stream
with prefetching is therefore the stream without it: no draw past the
loop's last batch moves the manager's generator, which later builds the
next task's memory subset and shuffles, and no draw runs while the next
stream is built.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

__all__ = ["Prefetcher"]


class Prefetcher:
    """Calls ``get_batch`` ``count`` times on a thread, keeping up to
    ``depth`` batches ready; calling the prefetcher returns the next one.
    A producer's exception is raised by the call that would have returned
    its batch."""

    def __init__(self, get_batch: Callable, count: int, depth: int = 2):
        self._get_batch = get_batch
        self._count = int(count)
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        for _ in range(self._count):
            if self._stop.is_set():
                return
            try:
                item = (True, self._get_batch())
            except BaseException as e:  # raised again on the consumer's side
                self._put((False, e))
                return
            if not self._put(item):
                return

    def __call__(self):
        while True:
            try:
                ok, item = self._queue.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._queue.empty():
                    raise RuntimeError("the prefetch thread has ended: every batch it was "
                                       "asked for is served, or it was closed")
        if not ok:
            raise item
        return item

    def close(self):
        """Stops the thread and waits for it."""
        self._stop.set()
        self._thread.join()
        while not self._queue.empty():
            self._queue.get_nowait()
