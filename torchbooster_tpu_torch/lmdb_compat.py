"""Read-only LMDB interop — a copy of ``torchbooster_tpu/lmdb_compat.py``:
the migration path for corpora that already live in LMDB (the reference's
``LMDBReader`` with its ``b"length"`` size key) into the BoosterStore
(``store.py``).

- :class:`LMDBView`: key→value access over an LMDB database, backed by
  the ``lmdb`` package when it is installed (imported at first use, never
  at import), else by a pure-Python read-only parser of the LMDB file
  format (meta page → B+tree walk, overflow pages included).
- :meth:`torchbooster_tpu_torch.store.RecordWriter.from_lmdb` converts a
  corpus in one call.

The pure parser reads what the reference's corpora hold: the main
(unnamed) database, plain put/get records, overflow values. DUPSORT and
DUPFIXED databases raise.
"""
from __future__ import annotations

import mmap
import struct
from pathlib import Path
from typing import Iterator

# LMDB file-format constants (lmdb.h / mdb.c, stable on-disk ABI)
_MAGIC = 0xBEEFC0DE
_P_INVALID = 0xFFFFFFFFFFFFFFFF
_P_BRANCH, _P_LEAF, _P_OVERFLOW, _P_META = 0x01, 0x02, 0x04, 0x08
_P_LEAF2 = 0x20
_F_BIGDATA, _F_SUBDATA, _F_DUPDATA = 0x01, 0x02, 0x04
_PAGEHDRSZ = 16
# MDB_db struct: md_pad u32, md_flags u16, md_depth u16, then 5 u64s
# (branch/leaf/overflow page counts, entries, root)
_DB_SIZE = 48
# meta struct offsets (relative to the meta struct, which starts right
# after the 16-byte page header): magic u32, version u32, address u64,
# mapsize u64, dbs[2], last_pg u64, txnid u64
_OFF_DBS = 24
_OFF_TXNID = _OFF_DBS + 2 * _DB_SIZE + 8


def _datafile(path: str | Path) -> Path:
    p = Path(path)
    return p / "data.mdb" if p.is_dir() else p


class _PureLMDB:
    """Read-only parser of an LMDB data file (no ``lmdb`` dependency).

    Walks the main DB's B+tree once to index key → value locator;
    values are sliced out of the mmap on demand.
    """

    def __init__(self, path: str | Path):
        self._file = open(_datafile(path), "rb")
        self._map = mmap.mmap(self._file.fileno(), 0,
                              access=mmap.ACCESS_READ)
        m = self._map
        # page size lives in mm_dbs[FREE].md_pad (mdb.c: mm_psize)
        if len(m) < 2 * _PAGEHDRSZ + _OFF_TXNID + 8:
            raise ValueError(f"{path}: too small to be an LMDB file")
        magic0 = struct.unpack_from("<I", m, _PAGEHDRSZ)[0]
        if magic0 != _MAGIC:
            raise ValueError(f"{path}: bad LMDB magic {magic0:#x}")
        self.psize = struct.unpack_from(
            "<I", m, _PAGEHDRSZ + _OFF_DBS)[0]
        # two meta pages; the one with the larger txnid is current
        metas = []
        for pgno in (0, 1):
            base = pgno * self.psize + _PAGEHDRSZ
            if struct.unpack_from("<I", m, base)[0] != _MAGIC:
                continue
            txnid = struct.unpack_from("<Q", m, base + _OFF_TXNID)[0]
            main = base + _OFF_DBS + _DB_SIZE
            flags = struct.unpack_from("<H", m, main + 4)[0]
            root = struct.unpack_from("<Q", m, main + 40)[0]
            entries = struct.unpack_from("<Q", m, main + 32)[0]
            metas.append((txnid, root, entries, flags))
        if not metas:
            raise ValueError(f"{path}: no valid LMDB meta page")
        _, self._root, self.entries, flags = max(metas)
        if flags & 0x04:  # MDB_DUPSORT
            raise NotImplementedError(
                "DUPSORT LMDB databases are not supported by the pure "
                "parser; install the 'lmdb' package")
        self._index: dict[bytes, tuple[int, int]] = {}
        if self._root != _P_INVALID:
            self._walk(self._root)

    def _page(self, pgno: int) -> int:
        off = pgno * self.psize
        if off + _PAGEHDRSZ > len(self._map):
            raise ValueError(f"page {pgno} beyond end of file")
        return off

    def _walk(self, pgno: int) -> None:
        m = self._map
        off = self._page(pgno)
        flags, lower = struct.unpack_from("<HH", m, off + 10)
        nkeys = (lower - _PAGEHDRSZ) >> 1
        if flags & _P_LEAF2:
            raise NotImplementedError("DUPFIXED pages unsupported")
        for i in range(nkeys):
            ptr = struct.unpack_from("<H", m, off + _PAGEHDRSZ + 2 * i)[0]
            node = off + ptr
            lo, hi, nflags, ksize = struct.unpack_from("<HHHH", m, node)
            key = bytes(m[node + 8:node + 8 + ksize])
            if flags & _P_BRANCH:
                child = lo | (hi << 16) | (nflags << 32)
                self._walk(child)
            elif flags & _P_LEAF:
                if nflags & (_F_SUBDATA | _F_DUPDATA):
                    raise NotImplementedError(
                        "sub-database / dup nodes unsupported")
                dsize = lo | (hi << 16)
                if nflags & _F_BIGDATA:
                    opg = struct.unpack_from(
                        "<Q", m, node + 8 + ksize)[0]
                    self._index[key] = (self._page(opg) + _PAGEHDRSZ,
                                        dsize)
                else:
                    self._index[key] = (node + 8 + ksize, dsize)
            else:
                raise ValueError(f"page {pgno}: unexpected flags "
                                 f"{flags:#x} in tree walk")

    def keys(self) -> Iterator[bytes]:
        return iter(sorted(self._index))

    def get(self, key: bytes) -> bytes | None:
        loc = self._index.get(key)
        if loc is None:
            return None
        off, size = loc
        return bytes(self._map[off:off + size])

    def close(self) -> None:
        self._map.close()
        self._file.close()


class LMDBView:
    """Uniform read-only view of an LMDB database.

    Prefers the ``lmdb`` package (full format coverage); falls back to
    the pure-python parser so migration works without it.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        try:
            import lmdb  # optional extra
        except ImportError:
            lmdb = None
        if lmdb is not None:
            self._env = lmdb.open(
                str(path), readonly=True, lock=False, readahead=False,
                subdir=self.path.is_dir(), max_readers=8)
            self._pure = None
        else:
            self._env = None
            self._pure = _PureLMDB(path)

    def get(self, key: bytes) -> bytes | None:
        if self._pure is not None:
            return self._pure.get(key)
        with self._env.begin(write=False) as txn:
            value = txn.get(key)
        return None if value is None else bytes(value)

    def keys(self) -> Iterator[bytes]:
        if self._pure is not None:
            yield from self._pure.keys()
            return
        with self._env.begin(write=False) as txn:
            for key, _ in txn.cursor():
                yield bytes(key)

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        """All (key, value) pairs in key order — one cursor pass in a
        single transaction on the ``lmdb`` backend (bulk migration must
        not pay a txn per record)."""
        if self._pure is not None:
            for key in self._pure.keys():
                yield key, self._pure.get(key)
            return
        with self._env.begin(write=False) as txn:
            for key, value in txn.cursor():
                yield bytes(key), bytes(value)

    def length(self) -> int | None:
        """The reference's dataset-size convention (ref lmdb.py:63):
        the ascii int under ``b"length"``, or None when absent."""
        raw = self.get(b"length")
        return None if raw is None else int(raw.decode())

    def close(self) -> None:
        if self._pure is not None:
            self._pure.close()
        else:
            self._env.close()

    def __enter__(self) -> "LMDBView":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


__all__ = ["LMDBView"]
