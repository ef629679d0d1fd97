"""CIFAR-10 binary reader — a copy of ``torchbooster_tpu/data/cifar.py``:
real CIFAR-10 from the standard binary release (``cifar-10-binary.tar.gz``
→ ``data_batch_{1..5}.bin`` + ``test_batch.bin``) dropped into
``dataset.root``, with no download and no pickle (the ``-py`` release
needs ``pickle.load`` on untrusted bytes; the binary release is a flat
record format).

Binary format (the classic CS-Toronto layout): 10 000 records per
file, each ``1 + 3072`` bytes — a label byte, then 1024 red + 1024
green + 1024 blue bytes in row-major order (CHW). Accepted layouts
under ``root``: the ``.bin`` files directly, the extracted
``cifar-10-batches-bin/`` directory, or the un-extracted
``cifar-10-binary.tar.gz``.
"""
from __future__ import annotations

import tarfile
from pathlib import Path

import numpy as np

_RECORD = 1 + 3 * 32 * 32
_TRAIN_FILES = tuple(f"data_batch_{i}.bin" for i in range(1, 6))
_TEST_FILES = ("test_batch.bin",)
_TARBALL = "cifar-10-binary.tar.gz"
_SUBDIR = "cifar-10-batches-bin"


def _parse_records(raw: bytes, path: str) -> tuple[np.ndarray, np.ndarray]:
    """One batch file → (uint8 images NHWC, int64 labels)."""
    if len(raw) == 0 or len(raw) % _RECORD:
        raise ValueError(
            f"{path}: {len(raw)} bytes is not a whole number of "
            f"{_RECORD}-byte CIFAR-10 records")
    records = np.frombuffer(raw, np.uint8).reshape(-1, _RECORD)
    labels = records[:, 0]
    if labels.max(initial=0) > 9:
        raise ValueError(
            f"{path}: label byte {int(labels.max())} > 9 — not a "
            "CIFAR-10 binary batch")
    # CHW planes → HWC, the layout every model/augmentation here uses
    images = records[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return images, labels.astype(np.int64)


def _batch_dir(root: Path) -> Path | None:
    for cand in (root, root / _SUBDIR):
        if all((cand / f).is_file() for f in _TRAIN_FILES + _TEST_FILES):
            return cand
    return None


def cifar10_available(root: str | Path) -> bool:
    """True when ``root`` holds a complete CIFAR-10 binary release
    (loose ``.bin`` files, the extracted directory, or the tarball)."""
    root = Path(root)
    return _batch_dir(root) is not None or (root / _TARBALL).is_file()


def load_cifar10(root: str | Path, train: bool
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(images, labels): images float32 in [0, 1], (N, 32, 32, 3)
    NHWC; labels int32. ``train``: the five 10k train batches vs the
    10k test batch."""
    root = Path(root)
    wanted = _TRAIN_FILES if train else _TEST_FILES
    batch_dir = _batch_dir(root)
    chunks = []
    if batch_dir is not None:
        for name in wanted:
            chunks.append(_parse_records(
                (batch_dir / name).read_bytes(), str(batch_dir / name)))
    elif (root / _TARBALL).is_file():
        with tarfile.open(root / _TARBALL, "r:gz") as tar:
            members = {Path(m.name).name: m for m in tar.getmembers()
                       if m.isfile()}
            missing = [n for n in wanted if n not in members]
            if missing:
                raise FileNotFoundError(
                    f"{root / _TARBALL} is missing members {missing}")
            for name in wanted:
                fh = tar.extractfile(members[name])
                assert fh is not None
                chunks.append(_parse_records(fh.read(), name))
    else:
        raise FileNotFoundError(
            f"no CIFAR-10 binary release under {root}: expected "
            f"{list(wanted)} (optionally inside {_SUBDIR}/ or "
            f"{_TARBALL})")
    images = np.concatenate([c[0] for c in chunks], axis=0)
    labels = np.concatenate([c[1] for c in chunks], axis=0)
    return images.astype(np.float32) / 255.0, labels.astype(np.int32)


__all__ = ["cifar10_available", "load_cifar10"]
