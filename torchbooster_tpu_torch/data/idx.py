"""IDX file parser — a copy of ``torchbooster_tpu/data/idx.py``: real
MNIST from the standard IDX files (``train-images-idx3-ubyte`` and the
rest, optionally gzipped) that an operator drops into ``dataset.root``,
with no download and no dependency.

IDX format (the classic LeCun layout): 2 zero bytes, a dtype code
byte, an ndim byte, then ``ndim`` big-endian uint32 dims, then the
array data in big-endian C order.
"""
from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

_DTYPES = {
    0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"), 0x0E: np.dtype(">f8"),
}

# canonical file stems per (kind, train?) — .gz variants accepted
_MNIST_FILES = {
    ("images", True): "train-images-idx3-ubyte",
    ("labels", True): "train-labels-idx1-ubyte",
    ("images", False): "t10k-images-idx3-ubyte",
    ("labels", False): "t10k-labels-idx1-ubyte",
}


def read_idx(path: str | Path) -> np.ndarray:
    """Parse one IDX file (gzipped or raw) into a numpy array."""
    path = Path(path)
    raw = path.read_bytes()
    if raw[:2] == b"\x1f\x8b":          # gzip magic, any extension
        raw = gzip.decompress(raw)
    if len(raw) < 4 or raw[0] or raw[1]:
        raise ValueError(f"{path}: not an IDX file (bad magic)")
    code, ndim = raw[2], raw[3]
    if code not in _DTYPES:
        raise ValueError(f"{path}: unknown IDX dtype code {code:#x}")
    dims = np.frombuffer(raw, ">u4", count=ndim, offset=4)
    data = np.frombuffer(raw, _DTYPES[code], offset=4 + 4 * ndim)
    if data.size != int(np.prod(dims)):
        raise ValueError(
            f"{path}: payload has {data.size} items, header says "
            f"{tuple(dims)}")
    return data.reshape(tuple(int(d) for d in dims))


def _find(root: Path, stem: str) -> Path | None:
    for name in (stem, stem + ".gz"):
        if (root / name).is_file():
            return root / name
    return None


def mnist_idx_available(root: str | Path) -> bool:
    """True when ``root`` holds a complete set of MNIST IDX files."""
    root = Path(root)
    return all(_find(root, stem) is not None
               for stem in _MNIST_FILES.values())


def load_mnist_idx(root: str | Path, train: bool
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(images, labels): images float32 in [0, 1], (N, 28, 28);
    labels int32. ``train``: the 60k train files vs the 10k t10k
    files."""
    root = Path(root)
    paths = {kind: _find(root, _MNIST_FILES[(kind, train)])
             for kind in ("images", "labels")}
    missing = [k for k, p in paths.items() if p is None]
    if missing:
        raise FileNotFoundError(
            f"MNIST IDX files missing under {root}: {missing} "
            f"(expected {[_MNIST_FILES[(k, train)] for k in missing]})")
    images = read_idx(paths["images"]).astype(np.float32) / 255.0
    labels = read_idx(paths["labels"]).astype(np.int32)
    if images.shape[0] != labels.shape[0]:
        raise ValueError(
            f"images ({images.shape[0]}) / labels ({labels.shape[0]}) "
            "count mismatch")
    return images, labels


__all__ = ["load_mnist_idx", "mnist_idx_available", "read_idx"]
