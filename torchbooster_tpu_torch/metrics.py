"""Metrics: accuracy and running averages — the port of
``torchbooster_tpu/metrics.py``. Metrics stay tensors on the device;
:class:`RunningAverage` only reads them to the host when its value is
asked for, so the device→host sync happens at log cadence, not at every
step."""
from __future__ import annotations

from typing import Any

import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             topk: int = 1) -> torch.Tensor:
    """Batch accuracy from logits, as a device scalar."""
    if topk == 1:
        return (logits.argmax(dim=-1) == labels).float().mean()
    top = logits.topk(topk, dim=-1).indices
    return (top == labels[..., None]).any(dim=-1).float().mean()


class Accuracy:
    """Callable-object form of :func:`accuracy`."""

    def __init__(self, topk: int = 1):
        self.topk = topk

    def __call__(self, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        return accuracy(logits, labels, self.topk)


class RunningAverage:
    """Incremental mean that keeps device scalars on the device:
    ``update`` stores the tensor without a sync; ``value`` reads the mean
    (the only host sync). ``max_pending`` bounds the backlog of unread
    values, which also bounds how far the host runs ahead of the card."""

    def __init__(self, max_pending: int = 32) -> None:
        self.max_pending = max_pending
        self.reset()

    def reset(self) -> None:
        self._pending: list[tuple[Any, int]] = []
        self._total = 0.0
        self._count = 0

    def update(self, value: Any, weight: int = 1) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach()
        self._pending.append((value, weight))
        if len(self._pending) >= self.max_pending:
            self._drain()

    def _drain(self) -> None:
        for value, weight in self._pending:
            self._total += float(value) * weight
            self._count += weight
        self._pending = []

    @property
    def value(self) -> float:
        self._drain()
        return self._total / max(self._count, 1)

    def __float__(self) -> float:
        return self.value


class MetricsAccumulator:
    """Dict of :class:`RunningAverage` for whole metric dicts — the unit
    of a train step's ``(state, metrics)`` output."""

    def __init__(self) -> None:
        self._averages: dict[str, RunningAverage] = {}

    def update(self, metrics: dict[str, Any], weight: int = 1) -> None:
        for key, value in metrics.items():
            self._averages.setdefault(key, RunningAverage()).update(
                value, weight)

    def compute(self) -> dict[str, float]:
        return {key: avg.value for key, avg in self._averages.items()}

    def reset(self) -> None:
        self._averages.clear()


__all__ = ["Accuracy", "MetricsAccumulator", "RunningAverage", "accuracy"]
