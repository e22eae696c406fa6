"""Windowed running means for training logs (counterpart of
``adascale/training/metrics.py``): each tag reports the mean of its most
recent ``avg_num_batches`` values, kept in a ring buffer with a running sum."""
from __future__ import annotations

from typing import Dict, Generic, Hashable, Iterable, Optional, Sequence, TypeVar

_T = TypeVar("_T", bound=Hashable)


class _Window:
    """Ring buffer of at most ``capacity`` floats with a running sum."""

    __slots__ = ("capacity", "buf", "head", "count", "total")

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.buf = [0.0] * capacity
        self.head = 0
        self.count = 0
        self.total = 0.0

    def push(self, value: float) -> float:
        if self.count == self.capacity:
            self.total -= self.buf[self.head]
        else:
            self.count += 1
        self.buf[self.head] = value
        self.total += value
        self.head = (self.head + 1) % self.capacity
        return self.total / self.count


class Metrics(Generic[_T]):
    """Per-tag sliding-window means; tags may be any hashable."""

    def __init__(self, tags: Iterable[_T], avg_num_batches: int):
        self.tags = tuple(tags)
        self.window_size = avg_num_batches
        self._windows: Dict[_T, _Window] = {}
        self._means: Dict[_T, Optional[float]] = {}
        self.reset()

    def reset(self, tags: Optional[Sequence[_T]] = None) -> None:
        for tag in self.tags if tags is None else tags:
            self._windows[tag] = _Window(self.window_size)
            self._means[tag] = None

    def update(self, tag: _T, value: float) -> float:
        mean = self._windows[tag].push(value)
        self._means[tag] = mean
        return mean

    def mean(self, tag: _T) -> Optional[float]:
        return self._means[tag]
