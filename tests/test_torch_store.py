"""The port's record store, LMDB migration and ``BaseDataset`` against the
JAX package's (``torchbooster_tpu/store.py``, ``lmdb_compat.py``,
``dataset.py``).

Records come from a numpy seed. Exact equality throughout: the store is a
byte format, so files, records and exceptions must be the JAX package's.
"""
from __future__ import annotations

import pickle
import subprocess
import sys

import numpy as np
import pytest

from tests._lmdb_fixture import build_lmdb
from torchbooster_tpu import store as jstore
from torchbooster_tpu.data.sources import StoreDataset as JStoreDataset
from torchbooster_tpu.dataset import BaseDataset as JBaseDataset
from torchbooster_tpu.dataset import Split as JSplit
from torchbooster_tpu.lmdb_compat import LMDBView as JLMDBView
from torchbooster_tpu_torch import store
from torchbooster_tpu_torch.data.sources import StoreDataset
from torchbooster_tpu_torch.dataset import BaseDataset, Split
from torchbooster_tpu_torch.lmdb_compat import LMDBView
from torchbooster_tpu_torch.ops._build import BUILD_DIR
from torchbooster_tpu_torch.store import RecordReader, RecordWriter

NATIVE = store._NATIVE_SOURCE.parent


def _records(seed: int = 0, n: int = 48) -> list[bytes]:
    """Records of 0-5000 bytes (one empty, one pickled tree)."""
    rs = np.random.RandomState(seed)
    out = [rs.randint(0, 256, rs.randint(0, 5000)).astype(np.uint8).tobytes()
           for _ in range(n)]
    out[3] = b""
    out[7] = pickle.dumps({"x": rs.randn(4).astype(np.float32), "y": 7})
    return out


def _write_port(path, records):
    with RecordWriter(path) as writer:
        for record in records:
            writer.append(record)
    return path


def _write_jax(path, records):
    with jstore.RecordWriter(path) as writer:
        for record in records:
            writer.append(record)
    return path


@pytest.mark.parametrize("native", [True, False])
def test_writers_write_the_jax_writers_bytes(tmp_path, native):
    """The port's one writer writes the JAX writer's bytes (its native
    library's, where that loads), and the file reads back whole through
    each of the port's readers."""
    records = _records()
    ours = _write_port(tmp_path / "port.bstore", records)
    theirs = _write_jax(tmp_path / "jax.bstore", records)
    assert ours.read_bytes() == theirs.read_bytes()
    with RecordReader(ours, native=native) as reader:
        assert list(reader) == records
    # an empty store too
    empty = _write_port(tmp_path / "e.bstore", [])
    assert empty.read_bytes() == \
        _write_jax(tmp_path / "je.bstore", []).read_bytes()
    with RecordReader(empty, native=native) as reader:
        assert len(reader) == 0


def test_each_package_reads_the_others_file(tmp_path):
    records = _records(1)
    theirs = _write_jax(tmp_path / "jax.bstore", records)
    for native in (False, True):
        with RecordReader(theirs, native=native) as reader:
            assert reader._native is native
            assert len(reader) == len(records)
            assert list(reader) == records
    ours = _write_port(tmp_path / "port.bstore", records)
    for jnative in (False, True):
        with jstore.RecordReader(ours, native=jnative) as reader:
            assert [reader[i] for i in range(len(records))] == records


def test_get_batch_equal_on_both_paths_and_to_jax(tmp_path):
    records = _records(2)
    path = _write_jax(tmp_path / "b.bstore", records)
    rs = np.random.RandomState(3)
    indices = [int(i) for i in rs.randint(0, len(records), 40)] + [3, 3]
    want = jstore.RecordReader(path, native=True).get_batch(indices)
    for native in (False, True):
        reader = RecordReader(path, native=native)
        assert reader.get_batch(indices) == want == [records[i]
                                                     for i in indices]
        assert reader.get_batch([]) == []
        reader.close()


def _corrupt_files(tmp_path, good):
    raw = good.read_bytes()
    cases = {
        "missing": tmp_path / "missing.bstore",
        "too_small": tmp_path / "small.bstore",
        "bad_magic": tmp_path / "magic.bstore",
        "index_past_end": tmp_path / "index.bstore",
        "count_too_large": tmp_path / "count.bstore",
    }
    cases["too_small"].write_bytes(raw[:10])
    cases["bad_magic"].write_bytes(b"NOTASTORE" + raw[9:])
    cases["index_past_end"].write_bytes(
        raw[:16] + (len(raw) + 1).to_bytes(8, "little") + raw[24:])
    cases["count_too_large"].write_bytes(
        raw[:8] + (10 ** 6).to_bytes(8, "little") + raw[16:])
    return cases


def _error_of(fn):
    try:
        fn()
    except Exception as error:  # the type is what is compared
        return type(error)
    return None


def test_corrupt_files_and_bad_indices_fail_as_jax(tmp_path):
    good = _write_jax(tmp_path / "good.bstore", _records(4, 8))
    for name, path in _corrupt_files(tmp_path, good).items():
        for native in (False, True):
            got = _error_of(lambda: RecordReader(path, native=native).open())
            want = _error_of(
                lambda: jstore.RecordReader(path, native=native).open())
            assert got is want is OSError, (name, native)
    for native in (False, True):
        for index in (8, -1):
            got = _error_of(lambda: RecordReader(good, native=native)[index])
            want = _error_of(
                lambda: jstore.RecordReader(good, native=native)[index])
            assert got is want is IndexError
        got = _error_of(
            lambda: RecordReader(good, native=native).get_batch([0, 99]))
        want = _error_of(
            lambda: jstore.RecordReader(good, native=native).get_batch([0,
                                                                        99]))
        assert got is want is not None


@pytest.mark.parametrize("native", [True, False])
def test_aborted_writer_leaves_no_store_as_jax(tmp_path, native):
    """An aborted build leaves no file, in both packages, and a reader of
    either kind then fails to open it as JAX's reader of that kind does."""
    for mod in (store, jstore):
        path = tmp_path / f"{mod.__name__.split('.')[0]}.bstore"
        with pytest.raises(RuntimeError, match="crash"):
            with mod.RecordWriter(path) as writer:
                writer.append(b"one")
                raise RuntimeError("crash mid-build")
        assert not path.exists()
        writer = mod.RecordWriter(path)
        writer.append(b"two")
        writer.abort()
        assert not path.exists()
        writer.close()                    # a close after abort is a no-op
        assert not path.exists()
        got = _error_of(lambda: RecordReader(path, native=native).open())
        want = _error_of(
            lambda: jstore.RecordReader(path, native=native).open())
        assert got is want is not None


def test_native_library_is_built_under_build_torch_ext_only(monkeypatch,
                                                           tmp_path):
    """The library lands in ``build/torch_ext/`` named after a hash of the
    source and the flags; ``g++`` writes nothing in ``native/``; without
    ``g++`` a native reader raises instead of reading through Python,
    while the writer, which needs no build, still writes."""
    before = sorted(p.name for p in NATIVE.iterdir())
    source = store._NATIVE_SOURCE.read_bytes()
    path = store.native_library_path()
    assert path.parent == BUILD_DIR and path.name.startswith(
        "libbooster_store_")
    store._load_native()
    assert path.is_file()

    # a fresh flag set (another hash) forces one real build; record it
    calls = []
    real_run = subprocess.run

    def spy(args, *a, **kw):
        calls.append([str(x) for x in args])
        return real_run(args, *a, **kw)

    monkeypatch.setattr(store, "_lib", None)
    monkeypatch.setattr(store, "_GXX_FLAGS",
                        store._GXX_FLAGS + ["-DBSTORE_REBUILD_CHECK"])
    monkeypatch.setattr(store.subprocess, "run", spy)
    fresh = store.native_library_path()
    assert fresh != path and not fresh.exists()
    try:
        store._load_native()
        assert fresh.is_file()
        (cmd,) = calls
        out = cmd[cmd.index("-o") + 1]
        assert out.startswith(str(BUILD_DIR)) and "native" not in out
        assert [a for a in cmd if str(NATIVE) in a] == [str(
            store._NATIVE_SOURCE)]
    finally:
        fresh.unlink(missing_ok=True)
    assert sorted(p.name for p in NATIVE.iterdir()) == before
    assert store._NATIVE_SOURCE.read_bytes() == source

    # no g++: no silent fall-back
    monkeypatch.setattr(store, "_lib", None)
    monkeypatch.setattr(store.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        RecordReader(path, native=True).open()
    written = _write_port(tmp_path / "no_gxx.bstore", [b"a", b"bc"])
    with RecordReader(written) as reader:
        assert list(reader) == [b"a", b"bc"]


def test_reader_pickles_as_its_path(tmp_path):
    records = _records(5, 10)
    path = _write_port(tmp_path / "p.bstore", records)
    for native in (False, True):
        reader = RecordReader(path, native=native).open()
        clone = pickle.loads(pickle.dumps(reader))
        assert clone._count is None and clone._want_native is native
        assert clone[5] == reader[5] == records[5]
        assert len(pickle.dumps(reader)) < 300
        clone.close()
        reader.close()


# ------------------------------------------------------------------ LMDB
@pytest.fixture
def pure_backend(monkeypatch):
    """The pure-Python parser on both sides, even where ``lmdb`` exists."""
    monkeypatch.setitem(sys.modules, "lmdb", None)


def _lmdb_corpus(with_length: bool, n: int = 9) -> dict[bytes, bytes]:
    rs = np.random.RandomState(6)
    if with_length:
        items = {str(i).encode(): pickle.dumps(
            {"id": i, "x": rs.randn(3).astype(np.float32)})
            for i in range(n)}
        items[b"length"] = str(n).encode()
    else:
        items = {f"k{i:02d}".encode(): rs.bytes(rs.randint(1, 60))
                 for i in range(n)}
    items[b"big" if not with_length else b"8"] = rs.bytes(9000)  # overflow
    return items


@pytest.mark.parametrize("with_length", [True, False])
def test_from_lmdb_equals_jax_migration(tmp_path, pure_backend,
                                        with_length):
    db = build_lmdb(tmp_path / "data.mdb", _lmdb_corpus(with_length))
    count = RecordWriter.from_lmdb(db, tmp_path / "port.bstore")
    jcount = jstore.RecordWriter.from_lmdb(db, tmp_path / "jax.bstore")
    assert count == jcount == (9 if with_length else 10)
    assert (tmp_path / "port.bstore").read_bytes() == \
        (tmp_path / "jax.bstore").read_bytes()
    with RecordReader(tmp_path / "port.bstore") as reader:
        assert list(reader) == list(
            jstore.RecordReader(tmp_path / "jax.bstore"))


def test_lmdb_view_and_errors_equal_jax(tmp_path, pure_backend):
    items = {f"key{i:04d}".encode(): b"x" * 40 + str(i).encode()
             for i in range(300)}                      # a branch root
    items[b"big"] = b"B" * 10_000                      # overflow pages
    db = build_lmdb(tmp_path / "data.mdb", items)
    with LMDBView(db) as view, JLMDBView(db) as jview:
        assert list(view.keys()) == list(jview.keys())
        assert list(view.items()) == list(jview.items())
        assert view.get(b"big") == jview.get(b"big") == b"B" * 10_000
        assert view.get(b"nope") is jview.get(b"nope") is None
        assert view.length() is jview.length() is None
    bogus = tmp_path / "bogus.mdb"
    bogus.write_bytes(b"\x00" * 8192)
    with pytest.raises(ValueError, match="magic"):
        LMDBView(bogus)
    broken = _lmdb_corpus(True, 3)
    del broken[b"1"]
    db = build_lmdb(tmp_path / "broken.mdb", broken)
    for writer in (RecordWriter, jstore.RecordWriter):
        with pytest.raises(KeyError, match="length=3"):
            writer.from_lmdb(db, tmp_path / "broken.bstore")
        assert not (tmp_path / "broken.bstore").exists()


# ------------------------------------------------------------- BaseDataset
def test_base_dataset_prepare_read_and_getitems_equal_jax(tmp_path):
    rs = np.random.RandomState(8)
    examples = [(rs.rand(4, 4, 3).astype(np.float32), np.int32(i % 10))
                for i in range(20)]
    path = BaseDataset.prepare(tmp_path / "port", Split.TRAIN, examples)
    jpath = JBaseDataset.prepare(tmp_path / "jax", JSplit.TRAIN, examples)
    assert path == tmp_path / "port" / "train.bstore"
    assert path.read_bytes() == jpath.read_bytes()

    ds = StoreDataset(tmp_path / "port", Split.TRAIN)
    jds = JStoreDataset(tmp_path / "jax", JSplit.TRAIN)
    assert len(ds) == len(jds) == 20
    for i in (0, 7, 19):
        (a, la), (b, lb) = ds[i], jds[i]
        assert a.tobytes() == b.tobytes() and la == lb
    idx = [19, 0, 5, 5]
    got, want = ds.__getitems__(idx), jds.__getitems__(idx)
    assert [g[0].tobytes() for g in got] == [w[0].tobytes() for w in want]
    assert ds.reader._native is True
    # the store opened lazily: the dataset ships as its path
    clone = pickle.loads(pickle.dumps(ds))
    assert clone.reader._count is None
    assert clone[7][0].tobytes() == examples[7][0].tobytes()
    ds.reader.close()
