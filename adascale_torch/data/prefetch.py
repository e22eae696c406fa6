"""Batch prefetching on a background thread.

Counterpart of ``adascale/data/prefetch.py``. ``BatchPrefetcher`` runs
``make_batch()`` (pull pairs from the dataset, collate, start the copy to
the card) on a daemon thread with a bounded queue, so batch N+1 is ready
while the card runs step N. It accounts the time its consumer spends
blocked on a batch (``stall_seconds``), from which the loop reports an
epoch's data-stall share.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional


class BatchPrefetcher:
    """Runs ``make_batch()`` on a daemon thread, keeping up to ``depth``
    ready batches queued. ``get()`` blocks until a batch is ready and adds
    the blocked time to ``stall_seconds``. An exception in ``make_batch`` is
    raised again from ``get()``."""

    def __init__(self, make_batch: Callable[[], Any], depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self.stall_seconds = 0.0
        self.batches_served = 0
        self._thread = threading.Thread(target=self._worker, name="batch-prefetch", daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                batch = self._make()
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:  # noqa: BLE001 — raised again by get()
            self._exc = exc

    def get(self) -> Any:
        """The next ready batch; blocks (and accounts the block) if none is."""
        t0 = time.perf_counter()
        while True:
            if self._exc is not None and self._q.empty():
                raise RuntimeError("batch prefetch thread failed") from self._exc
            try:
                batch = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._exc is None:
                    raise RuntimeError("batch prefetch thread exited early")
        self.stall_seconds += time.perf_counter() - t0
        self.batches_served += 1
        return batch

    def reset_stall_accounting(self) -> None:
        self.stall_seconds = 0.0
        self.batches_served = 0

    def stop(self) -> None:
        """Stop the thread and drop queued batches; a second call does
        nothing more."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            raise RuntimeError("batch prefetch thread did not stop within 30 s")
