"""Dataset base classes — the port of ``torchbooster_tpu/dataset.py``:
the ``Split`` enum, the map and stream protocols, the in-memory
``ArrayDataset`` and the lazy per-example ``TransformDataset``. The
record-store ``BaseDataset`` waits for the data path (``ROADMAP.md``
A9)."""
from __future__ import annotations

from enum import Enum
from typing import Any, Callable, Iterator


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


class TransformDataset(Dataset):
    """Apply a per-example transform lazily, on the host (the
    augmentation stage of the image recipes)."""

    def __init__(self, base: Dataset, transform: Callable[[Any], Any]):
        self.base = base
        self.transform = transform

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, index: int) -> Any:
        return self.transform(self.base[index])

    def __getitems__(self, indices) -> Any:
        if hasattr(self.base, "__getitems__"):
            return [self.transform(x) for x in self.base.__getitems__(indices)]
        return [self.transform(self.base[int(i)]) for i in indices]


__all__ = ["ArrayDataset", "Dataset", "IterableDataset", "Split",
           "TransformDataset"]
