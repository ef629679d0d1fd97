"""Dataset base classes — the port of ``torchbooster_tpu/dataset.py``:
the ``Split`` enum, the map and stream protocols and the in-memory
``ArrayDataset``. The record-store ``BaseDataset`` waits for the data
path (``ROADMAP.md`` A9)."""
from __future__ import annotations

from enum import Enum
from typing import Any, Iterator


class Split(Enum):
    TRAIN = "train"
    VALIDATION = "validation"
    TEST = "test"


class Dataset:
    """Map-style dataset protocol: ``__len__`` + ``__getitem__``."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int) -> Any:
        raise NotImplementedError


class IterableDataset:
    """Marker base for stream datasets; loaders iterate instead of
    indexing."""

    def __iter__(self) -> Iterator[Any]:
        raise NotImplementedError


class ArrayDataset(Dataset):
    """In-memory dataset over parallel arrays (the synthetic sources)."""

    def __init__(self, *arrays: Any):
        if not arrays or any(len(a) != len(arrays[0]) for a in arrays):
            raise ValueError("ArrayDataset needs arrays of one length")
        self.arrays = arrays

    def __len__(self) -> int:
        return len(self.arrays[0])

    def __getitem__(self, index: int) -> Any:
        items = tuple(a[index] for a in self.arrays)
        return items if len(items) > 1 else items[0]


__all__ = ["ArrayDataset", "Dataset", "IterableDataset", "Split"]
