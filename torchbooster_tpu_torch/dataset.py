"""Dataset base classes — the port of ``torchbooster_tpu/dataset.py``:
the ``Split`` enum, the map and stream protocols, the record-store
``BaseDataset`` (``store.py``), the in-memory ``ArrayDataset`` and the
lazy per-example ``TransformDataset``."""
from __future__ import annotations

import pickle
from enum import Enum
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator

from torchbooster_tpu_torch.store import RecordReader, RecordWriter


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


class BaseDataset(Dataset):
    """Record-store-backed dataset over ``root/<split>.bstore``.

    Subclasses implement :meth:`process` (bytes → example) and may
    override :meth:`prepare` to build the store from a source corpus. The
    store opens at the first read, through the native reader (one C++
    gather a batch for ``__getitems__``), so the dataset pickles as its
    path: cheap to ship to process workers."""

    def __init__(self, root: str | Path, split: Split):
        self.root = Path(root)
        self.split = split
        self.reader = RecordReader(self.store_path(self.root, split),
                                   native=True)

    @classmethod
    def store_path(cls, root: str | Path, split: Split) -> Path:
        """``root/<split>.bstore``."""
        return Path(root) / f"{split.value}.bstore"

    @classmethod
    def prepare(cls, root: str | Path, split: Split,
                examples: Iterable[Any],
                encode: Callable[[Any], bytes] = pickle.dumps) -> Path:
        """Build the record store for ``split`` from ``examples``."""
        path = cls.store_path(root, split)
        with RecordWriter(path) as writer:
            for example in examples:
                writer.append(encode(example))
        return path

    def process(self, raw: bytes) -> Any:
        """bytes → example (decode + transform). Default: unpickle."""
        return pickle.loads(raw)

    def __len__(self) -> int:
        return len(self.reader)

    def __getitem__(self, index: int) -> Any:
        return self.process(self.reader[index])

    def __getitems__(self, indices) -> list[Any]:
        """Batched fetch: one store gather a batch; the loaders use it."""
        return [self.process(raw) for raw in self.reader.get_batch(indices)]


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


__all__ = ["ArrayDataset", "BaseDataset", "Dataset", "IterableDataset",
           "Split", "TransformDataset"]
