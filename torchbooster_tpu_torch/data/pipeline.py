"""Host loading — the port of ``torchbooster_tpu/data/pipeline.py``'s
``default_collate`` and single-process ``DataLoader``: the same
``seed + epoch`` shuffle order and ``drop_last`` counts. Batches are
host numpy; moving them to the card (pinned memory, non-blocking copy)
is the caller's job. Thread and process workers, per-process sharding
and ``prefetch_to_device`` wait for the data path (``ROADMAP.md`` A9)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Sequence

import numpy as np

from torchbooster_tpu_torch.dataset import IterableDataset


def default_collate(examples: Sequence[Any]) -> Any:
    """Stack a list of examples into a batch tree (numpy-valued)."""
    first = examples[0]
    if isinstance(first, dict):
        return {k: default_collate([e[k] for e in examples]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):  # namedtuple
        return type(first)(*(default_collate(col) for col in zip(*examples)))
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate(col) for col in zip(*examples))
    return np.stack([np.asarray(e) for e in examples])


class DataLoader:
    """Map or stream dataset → batches of host numpy trees, in this
    process. Shuffling reshuffles every epoch with ``seed + epoch``; one
    epoch is one pass."""

    def __init__(self, dataset: Any, batch_size: int = 32,
                 shuffle: bool = True, drop_last: bool = True,
                 collate_fn: Callable | None = None, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.seed = seed
        self.epoch = 0
        self._iterable = isinstance(dataset, IterableDataset)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def _map_iter(self) -> Iterator[Any]:
        order = self._epoch_indices()
        fetch_many = getattr(self.dataset, "__getitems__", None)
        for start in range(0, len(order), self.batch_size):
            chunk = [int(i) for i in order[start:start + self.batch_size]]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            if fetch_many is not None:
                yield self.collate_fn(fetch_many(chunk))
            else:
                yield self.collate_fn([self.dataset[i] for i in chunk])

    def _iterable_iter(self) -> Iterator[Any]:
        buffer: list[Any] = []
        for item in self.dataset:
            buffer.append(item)
            if len(buffer) == self.batch_size:
                yield self.collate_fn(buffer)
                buffer = []
        if buffer and not self.drop_last:
            yield self.collate_fn(buffer)

    def __iter__(self) -> Iterator[Any]:
        yield from (self._iterable_iter() if self._iterable
                    else self._map_iter())
        self.epoch += 1


__all__ = ["DataLoader", "default_collate"]
