"""Record store — the port of ``torchbooster_tpu/store.py``: mmap'd blob
storage for datasets in the BoosterStore format (``_MAGIC``, a
``<8sQQ`` header of magic, count and index offset, then the records, then
one ``<QQ`` offset/size entry per record).

Two readers over the one format:

- ``native=False`` (the default): Python ``mmap`` + ``struct``; slicing an
  mmap is one C memcpy, the fast path from Python for small records;
- ``native=True``: the C++ library of the repository's
  ``native/booster_store.cpp``, the format's reference implementation
  (hard bounds checks, ``madvise``, one gather call a batch).

One writer, :class:`RecordWriter`, in Python: it needs no build, so
``BaseDataset.prepare`` never waits on a compiler, and it writes the bytes
of the native library's writer (the format is fixed; the cost of a
``prepare`` is the pickling of each record).

The library is compiled with ``g++ -O3 -shared -fPIC`` at first use, never
at import, into ``build/torch_ext/`` (which ``.gitignore`` lists), named
after a hash of the source and the flags, as ``ops/_build.py`` names the
CUDA builds; nothing is ever written next to the source. A reader that
asked for the native library raises when it cannot be built or loaded:
there is no quiet fall-back to the Python path.

``RecordWriter.from_lmdb`` migrates an LMDB corpus (``lmdb_compat.py``);
``LMDBReader`` is the reference-era alias of :class:`RecordReader`."""
from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Iterator

_MAGIC = b"BSTORE1\x00"
_HEADER = struct.Struct("<8sQQ")   # magic, count, index_offset
_ENTRY = struct.Struct("<QQ")

_NATIVE_SOURCE = Path(__file__).resolve().parents[1] / "native" \
    / "booster_store.cpp"
_GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def native_library_path() -> Path:
    """Where the native library of the current source and flags lives:
    ``build/torch_ext/libbooster_store_<hash>.so``."""
    from torchbooster_tpu_torch.ops._build import BUILD_DIR

    digest = hashlib.sha256(_NATIVE_SOURCE.read_bytes())
    digest.update(" ".join(_GXX_FLAGS).encode())
    return BUILD_DIR / f"libbooster_store_{digest.hexdigest()[:16]}.so"


def _build_native() -> Path:
    so = native_library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native BoosterStore "
                           "library is built from source at first use")
    so.parent.mkdir(parents=True, exist_ok=True)
    # a private temporary name, then an atomic rename: loader processes
    # that race the first build never load a half-written library
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *_GXX_FLAGS, "-o", str(tmp),
                           str(_NATIVE_SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {_NATIVE_SOURCE.name}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load_native() -> ctypes.CDLL:
    """The native store library, built and loaded on first use. Raises
    when it cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build_native()))
        lib.bs_open.restype = ctypes.c_void_p
        lib.bs_open.argtypes = [ctypes.c_char_p]
        lib.bs_count.restype = ctypes.c_int64
        lib.bs_count.argtypes = [ctypes.c_void_p]
        lib.bs_get.restype = ctypes.c_int
        lib.bs_get.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.bs_get_batch.restype = ctypes.c_int64
        lib.bs_get_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64)]
        lib.bs_close.argtypes = [ctypes.c_void_p]
        lib.bs_error.restype = ctypes.c_char_p
        _lib = lib
        return lib


class RecordReader:
    """Read-only record access. Opens lazily on first use and pickles as
    its path and reader choice, so a dataset holding one ships cheaply to
    process workers (each opens its own mapping)."""

    def __init__(self, path: str | Path, native: bool = False):
        self.path = Path(path)
        self._want_native = native
        self._init_state()

    def _init_state(self) -> None:
        self._handle = None
        self._mmap: mmap.mmap | None = None
        self._file = None
        self._count: int | None = None
        self._index_offset = 0
        self._native = False
        self._open_lock = threading.Lock()

    def __getstate__(self) -> dict:
        return {"path": self.path, "native": self._want_native}

    def __setstate__(self, state: dict) -> None:
        self.path = state["path"]
        self._want_native = state["native"]
        self._init_state()

    # -- lifecycle ---------------------------------------------------

    def open(self) -> "RecordReader":
        # loader worker threads race the first access (num_workers > 0)
        with self._open_lock:
            return self._open_locked()

    def _open_locked(self) -> "RecordReader":
        if self._count is not None:
            return self
        if self._want_native:
            lib = _load_native()
            handle = lib.bs_open(str(self.path).encode())
            if not handle:
                raise OSError(
                    f"cannot open {self.path}: {lib.bs_error().decode()}")
            self._handle = handle
            self._count = int(lib.bs_count(handle))
            self._native = True
            return self
        try:
            self._file = open(self.path, "rb")
            self._mmap = mmap.mmap(self._file.fileno(), 0,
                                   access=mmap.ACCESS_READ)
        except (OSError, ValueError) as error:
            if self._file is not None:
                self._file.close()
                self._file = None
            raise OSError(f"cannot open {self.path}: {error}") from error
        if len(self._mmap) < _HEADER.size:
            self._release_mmap()
            raise OSError(f"{self.path} is not a BoosterStore file (too small)")
        magic, count, index_offset = _HEADER.unpack_from(self._mmap, 0)
        if magic != _MAGIC:
            self._release_mmap()
            raise OSError(f"{self.path} is not a BoosterStore file")
        if index_offset > len(self._mmap) or \
                count > (len(self._mmap) - index_offset) // 16:
            self._release_mmap()
            raise OSError(f"{self.path}: corrupt header, index out of bounds")
        self._count = count
        self._index_offset = index_offset
        return self

    def _release_mmap(self) -> None:
        self._mmap.close()
        self._file.close()
        self._mmap = self._file = None

    def close(self) -> None:
        if self._native and self._handle is not None:
            _load_native().bs_close(self._handle)
            self._handle = None
        if self._mmap is not None:
            self._release_mmap()
        self._count = None

    def __enter__(self) -> "RecordReader":
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- access ------------------------------------------------------

    def __len__(self) -> int:
        self.open()
        return self._count

    def get(self, index: int) -> bytes:
        self.open()
        if not 0 <= index < self._count:
            raise IndexError(f"record {index} out of range [0, {self._count})")
        if self._native:
            lib = _load_native()
            data = ctypes.POINTER(ctypes.c_uint8)()
            size = ctypes.c_uint64()
            if lib.bs_get(self._handle, index, ctypes.byref(data),
                          ctypes.byref(size)) != 0:
                raise OSError(f"read failed: {lib.bs_error().decode()}")
            return ctypes.string_at(data, size.value)
        offset, size = _ENTRY.unpack_from(
            self._mmap, self._index_offset + 16 * index)
        if offset > len(self._mmap) or size > len(self._mmap) - offset:
            raise OSError(f"{self.path}: corrupt index entry {index}")
        return bytes(self._mmap[offset:offset + size])

    def __getitem__(self, index: int) -> bytes:
        return self.get(index)

    def get_batch(self, indices) -> list[bytes]:
        """Gather many records in one pass (the storage half of
        ``__getitems__``): on the native path a size pass and one C++
        memcpy gather a batch, on the Python path direct mmap slices."""
        self.open()
        n = len(indices)
        if n == 0:
            return []
        if self._native:
            lib = _load_native()
            idx_arr = (ctypes.c_uint64 * n)(*[int(i) for i in indices])
            sizes = (ctypes.c_uint64 * n)()
            total = lib.bs_get_batch(self._handle, idx_arr, n, None, 0, sizes)
            if total < 0:
                raise OSError(f"batch read failed: {lib.bs_error().decode()}")
            buffer = (ctypes.c_char * total)()
            written = lib.bs_get_batch(self._handle, idx_arr, n, buffer,
                                       total, sizes)
            if written != total:
                raise OSError(f"batch read failed: {lib.bs_error().decode()}")
            view = memoryview(buffer)
            out, cursor = [], 0
            for i in range(n):
                out.append(bytes(view[cursor:cursor + sizes[i]]))
                cursor += sizes[i]
            return out
        return [self.get(int(i)) for i in indices]

    def __iter__(self) -> Iterator[bytes]:
        for index in range(len(self)):
            yield self.get(index)


class RecordWriter:
    """Sequential store builder (``BaseDataset.prepare`` uses it). Leaving
    a ``with`` block on an exception deletes the partial file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "wb")
        self._file.write(_HEADER.pack(_MAGIC, 0, 0))
        self._index: list[tuple[int, int]] = []
        self._cursor = _HEADER.size
        self._count = 0

    def append(self, data: bytes) -> int:
        """Append one record; returns its index."""
        self._file.write(data)
        self._index.append((self._cursor, len(data)))
        self._cursor += len(data)
        self._count += 1
        return self._count - 1

    def close(self) -> None:
        if self._file is None:
            return
        index_offset = self._cursor
        for offset, size in self._index:
            self._file.write(_ENTRY.pack(offset, size))
        self._file.seek(0)
        self._file.write(_HEADER.pack(_MAGIC, self._count, index_offset))
        self._file.close()
        self._file = None

    def abort(self) -> None:
        """Discard the store: release resources and delete the partial
        file (never leaves a valid-looking header behind)."""
        if self._file is not None:
            self._file.close()
            self._file = None
        self.path.unlink(missing_ok=True)

    def __enter__(self) -> "RecordWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        # a crashed body must not finalize a valid-looking store: a
        # half-built file would pass every store-exists check downstream
        if exc_type is not None:
            self.abort()
        else:
            self.close()

    @classmethod
    def from_lmdb(cls, src: str | Path, dst: str | Path) -> int:
        """Migrate an LMDB corpus into a BoosterStore file; returns the
        record count. With the reference's size key (``b"length"`` holding
        the count, records under ``str(i)``) records migrate in index order
        and ``b"length"`` itself is dropped; otherwise every (key, value)
        pair migrates in key order. Reads through the ``lmdb`` package
        when installed, else the pure-Python parser
        (:mod:`torchbooster_tpu_torch.lmdb_compat`)."""
        from torchbooster_tpu_torch.lmdb_compat import LMDBView

        with LMDBView(src) as view, cls(dst) as writer:
            length = view.length()
            if length is not None:
                for i in range(length):
                    value = view.get(str(i).encode())
                    if value is None:
                        raise KeyError(
                            f"{src}: declares length={length} but key "
                            f"{i!r} is missing")
                    writer.append(value)
            else:
                for _, value in view.items():
                    writer.append(value)
            return writer._count


# the reference-era name (its own spelling was ``LMBDReader``)
LMDBReader = RecordReader

__all__ = ["LMDBReader", "RecordReader", "RecordWriter",
           "native_library_path"]
