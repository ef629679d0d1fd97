"""The port's data path against the JAX package's: the loader (threads,
process workers, sharding), ``prefetch_to_device`` on the CPU, the MNIST
IDX / CIFAR-10 binary / image-folder readers, the resolution chain and the
ResNet recipe over a local release.

Inputs come from a numpy seed and go through both packages. Arrays are
held byte for byte, except ``procedural_image``, whose bicubic resize is
numpy in the port and XLA in JAX: held to atol 1e-6.
"""
from __future__ import annotations

import gzip
import inspect
import io
import json
import logging
import math
import tarfile
import threading
import time

import numpy as np
import pytest
import torch

from torchbooster_tpu import distributed as jdist
from torchbooster_tpu.config import DatasetConfig as JDatasetConfig
from torchbooster_tpu.config import LoaderConfig as JLoaderConfig
from torchbooster_tpu.data import DataLoader as JDataLoader
from torchbooster_tpu.data import ShardedIterable as JSharded
from torchbooster_tpu.data import SizedIterable as JSized
from torchbooster_tpu.data import cifar as jcifar
from torchbooster_tpu.data import folder as jfolder
from torchbooster_tpu.data import idx as jidx
from torchbooster_tpu.data import prefetch_to_device as jprefetch
from torchbooster_tpu.data import sources as jsources
from torchbooster_tpu.dataset import ArrayDataset as JArray
from torchbooster_tpu.dataset import BaseDataset as JBaseDataset
from torchbooster_tpu.dataset import IterableDataset as JIterable
from torchbooster_tpu.dataset import Split as JSplit
from torchbooster_tpu.observability import get_registry as jget_registry
from torchbooster_tpu_torch.config import (
    DatasetConfig,
    EnvConfig,
    LoaderConfig,
    OptimizerConfig,
    SchedulerConfig,
)
from torchbooster_tpu_torch.data import (
    DataLoader,
    ShardedIterable,
    SizedIterable,
    cifar,
    folder,
    idx,
    pipeline,
    prefetch_to_device,
    sources,
)
from torchbooster_tpu_torch.dataset import ArrayDataset, BaseDataset
from torchbooster_tpu_torch.dataset import IterableDataset, Split
from torchbooster_tpu_torch.observability import get_registry
from torchbooster_tpu_torch.recipes import resnet as recipe


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, torch.Tensor):
        return [tree.numpy()]
    return [np.asarray(tree)]


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(la, lb))


def _arrays(n=37, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(n, 3).astype(np.float32), rs.randint(0, 10, n).astype(
        np.int32)


# ------------------------------------------------------------------ loader
@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_equal_jax_over_two_epochs(shuffle, drop_last,
                                                  num_workers):
    x, y = _arrays()
    ours = DataLoader(ArrayDataset(x, y), batch_size=8, shuffle=shuffle,
                      drop_last=drop_last, num_workers=num_workers, seed=5)
    theirs = JDataLoader(JArray(x, y), batch_size=8, shuffle=shuffle,
                         drop_last=drop_last, num_workers=num_workers,
                         seed=5)
    assert len(ours) == len(theirs) == (4 if drop_last else 5)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        assert all(_same(g, w) for g, w in zip(got, want))


def test_process_workers_equal_jax_and_keep_their_pool(tmp_path):
    x, y = _arrays(40, 1)
    # a store of (x, y) examples: the workers unpickle it as its path
    BaseDataset.prepare(tmp_path, Split.TRAIN, zip(x, y))
    ds = sources.StoreDataset(tmp_path, Split.TRAIN)
    ours = DataLoader(ds, batch_size=8, seed=2, num_workers=2,
                      workers="process", prefetch=1)
    theirs = JDataLoader(JArray(x, y), batch_size=8, seed=2)
    try:
        for epoch in range(2):
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == len(ours) == 5
            assert all(_same(g, w) for g, w in zip(got, want))
            if epoch == 0:
                pool = ours._pool
            assert ours._pool is pool is not None   # reused across epochs
    finally:
        ours.close()
    assert ours._pool is None
    for loader in (DataLoader, JDataLoader):
        with pytest.raises(ValueError, match="thread"):
            loader([1, 2], workers="greenlet")


def _stream(base, rows):
    class Stream(base):
        def __iter__(self):
            for i, r in enumerate(rows):
                yield {"x": r, "i": np.int64(i)}

        def __len__(self):
            return len(rows)
    return Stream()


def test_stream_loader_and_iterables_equal_jax():
    rows = np.arange(46, dtype=np.int32).reshape(23, 2)
    for drop_last in (True, False):
        ours = DataLoader(_stream(IterableDataset, rows), batch_size=5,
                          drop_last=drop_last)
        theirs = JDataLoader(_stream(JIterable, rows), batch_size=5,
                             drop_last=drop_last)
        assert len(ours) == len(theirs)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) and all(map(_same, got, want))
    for n in (22, 3, 0):
        for shift in range(4):
            a = ShardedIterable(list(range(n)), shift=shift, mod=4)
            b = JSharded(list(range(n)), shift=shift, mod=4)
            assert len(a) == len(b) == len(list(a)) and list(a) == list(b)
    keep = lambda v: v % 3 == 0  # noqa: E731
    a, b = SizedIterable(range(10), 10, keep), JSized(range(10), 10, keep)
    assert list(a) == list(b) == [0, 3, 6, 9] and len(a) == len(b) == 10
    for cls in (SizedIterable, JSized):
        with pytest.raises(TypeError):
            len(cls(range(3), None))


@pytest.mark.parametrize("drop_last", [True, False])
def test_distributed_shard_of_every_rank_equals_jax(monkeypatch, drop_last):
    """World 4: the JAX package's ``distributed`` and the port's topology
    helper patched to the same rank; the global batch 8 gives each rank
    2 examples a step."""
    x, y = _arrays(37, 2)
    rows = np.arange(46, dtype=np.int32).reshape(23, 2)
    for rank in range(4):
        monkeypatch.setattr(jdist, "get_rank", lambda r=rank: r)
        monkeypatch.setattr(jdist, "get_world_size", lambda: 4)
        monkeypatch.setattr(pipeline, "_process_topology",
                            lambda r=rank: (r, 4))
        for shuffle in (True, False):
            ours = DataLoader(ArrayDataset(x, y), batch_size=8,
                              distributed=True, shuffle=shuffle,
                              drop_last=drop_last, seed=3)
            theirs = JDataLoader(JArray(x, y), batch_size=8,
                                 distributed=True, shuffle=shuffle,
                                 drop_last=drop_last, seed=3)
            assert ours.local_batch == theirs.local_batch == 2
            assert len(ours) == len(theirs)
            for _ in range(2):
                got, want = list(ours), list(theirs)
                assert len(got) == len(want) == len(ours)
                assert all(map(_same, got, want))
        ours = DataLoader(_stream(IterableDataset, rows), batch_size=8,
                          distributed=True, drop_last=drop_last)
        theirs = JDataLoader(_stream(JIterable, rows), batch_size=8,
                             distributed=True, drop_last=drop_last)
        assert isinstance(ours.dataset, ShardedIterable)
        assert ours.dataset.shift == rank and ours.dataset.mod == 4
        assert len(ours) == len(theirs)
        assert all(map(_same, list(ours), list(theirs)))
        # the loader configs pass ``distributed`` through alike
        got = list(LoaderConfig(batch_size=8).make(ArrayDataset(x, y),
                                                   distributed=True))
        want = list(JLoaderConfig(batch_size=8).make(JArray(x, y),
                                                     distributed=True))
        assert all(map(_same, got, want))
    for loader, array in ((DataLoader, ArrayDataset), (JDataLoader, JArray)):
        with pytest.raises(ValueError, match="divisible"):
            loader(array(x, y), batch_size=6, distributed=True)


def test_process_topology_reads_torch_distributed(monkeypatch):
    assert pipeline._process_topology() == (0, 1)
    import torch.distributed as tdist

    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_rank", lambda: 2)
    monkeypatch.setattr(tdist, "get_world_size", lambda: 4)
    assert pipeline._process_topology() == (2, 4)
    assert ShardedIterable([]).shift == 2


def test_loader_and_dataset_configs_match_jax():
    x, y = _arrays(40, 4)
    ours = LoaderConfig(batch_size=8, num_workers=2, prefetch=3).make(
        ArrayDataset(x, y), seed=1)
    theirs = JLoaderConfig(batch_size=8, num_workers=2, prefetch=3).make(
        JArray(x, y), seed=1)
    assert (ours.num_workers, ours.prefetch, ours.workers) == (2, 3, "thread")
    assert all(map(_same, list(ours), list(theirs)))
    sig = inspect.signature(DatasetConfig.make).parameters
    jsig = inspect.signature(JDatasetConfig.make).parameters
    assert [(p.name, p.default) for p in sig.values()] == \
        [(p.name, p.default) for p in jsig.values()]


# --------------------------------------------------------------- prefetch
def test_prefetch_to_device_on_the_cpu_equals_jax():
    x, y = _arrays(32, 5)
    mesh = jdist.make_mesh("dp")
    for make in (lambda a, b: (a, b),
                 lambda a, b: {"image": a, "label": (b, b + 1)}):
        examples = [make(a, b) for a, b in zip(x, y)]
        ours = list(prefetch_to_device(
            DataLoader(examples, batch_size=8, shuffle=False), "cpu"))
        theirs = list(jprefetch(
            JDataLoader(examples, batch_size=8, shuffle=False), mesh))
        assert len(ours) == len(theirs) == 4
        for g, w in zip(ours, theirs):
            assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                       for t in _leaves_t(g))
            assert _same(g, w)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(prefetch_to_device([np.ones(2)], "cuda"))


def _leaves_t(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_t(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves_t(v)]
    return [tree]


def test_prefetch_errors_early_break_and_full_queue():
    def bad_loader():
        yield np.ones(8)
        raise RuntimeError("decode failed")

    it = prefetch_to_device(bad_loader(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)

    loader = DataLoader(ArrayDataset(np.arange(256, dtype=np.float32)
                                     .reshape(64, 4)), batch_size=8)
    before = set(threading.enumerate())
    for _ in range(5):
        for _batch in prefetch_to_device(loader, "cpu"):
            break                       # the consumer abandons the generator
    assert [t for t in threading.enumerate()
            if t not in before and t.is_alive()] == []

    # a slow consumer behind a queue of one: the producer finishes while
    # the queue is full, and the sentinel still arrives
    batches = [{"x": np.ones((2, 2)) * i} for i in range(6)]
    seen = []
    for batch in prefetch_to_device(iter(batches), "cpu", size=1):
        time.sleep(0.02)
        seen.append(float(batch["x"][0, 0]))
    assert seen == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


def test_prefetch_series_names_and_help_equal_jax():
    list(prefetch_to_device([np.ones(2)], "cpu"))
    list(jprefetch([np.ones(8)], jdist.make_mesh("dp")))
    names = ("data_batches_total", "data_producer_wait_seconds")

    def series(reg):
        return {m.name: (m.kind, m.help) for m in reg.metrics()
                if m.name in names}

    got, want = series(get_registry()), series(jget_registry())
    assert set(got) == set(names) and got == want


# ----------------------------------------------------------------- readers
def _write_idx(path, arr, gz=False, code=0x08):
    header = bytes([0, 0, code, arr.ndim]) + b"".join(
        int(d).to_bytes(4, "big") for d in arr.shape)
    blob = header + arr.astype(np.uint8).tobytes()
    path.write_bytes(gzip.compress(blob) if gz else blob)


def _mnist_release(root, gz=False, n_train=16, n_test=8):
    rs = np.random.RandomState(0)
    root.mkdir(parents=True, exist_ok=True)
    for stem, n in (("train", n_train), ("t10k", n_test)):
        name = lambda kind: f"{stem}-{kind}" + (".gz" if gz else "")  # noqa
        _write_idx(root / name("images-idx3-ubyte"),
                   rs.randint(0, 256, (n, 28, 28)), gz=gz)
        _write_idx(root / name("labels-idx1-ubyte"),
                   rs.randint(0, 10, (n,)), gz=gz)


def _raises_alike(fn, jfn):
    kinds = []
    for f in (fn, jfn):
        try:
            f()
            kinds.append(None)
        except Exception as error:
            kinds.append(type(error))
    assert kinds[0] is kinds[1] is not None, kinds


@pytest.mark.parametrize("gz", [False, True])
def test_idx_reader_equals_jax(tmp_path, gz):
    _mnist_release(tmp_path, gz=gz)
    assert idx.mnist_idx_available(tmp_path) is \
        jidx.mnist_idx_available(tmp_path) is True
    suffix = ".gz" if gz else ""
    raw = idx.read_idx(tmp_path / f"train-images-idx3-ubyte{suffix}")
    assert _same(raw, jidx.read_idx(tmp_path /
                                    f"train-images-idx3-ubyte{suffix}"))
    for train in (True, False):
        assert _same(idx.load_mnist_idx(tmp_path, train),
                     jidx.load_mnist_idx(tmp_path, train))
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x01\x02\x03\x04")
    trunc = tmp_path / "trunc"
    trunc.write_bytes(bytes([0, 0, 0x08, 1]) + (5).to_bytes(4, "big") + b"\0")
    code = tmp_path / "code"
    _write_idx(code, np.zeros(3), code=0x42)
    for path in (bad, trunc, code, tmp_path / "missing"):
        _raises_alike(lambda: idx.read_idx(path), lambda: jidx.read_idx(path))
    # a labels file of another length than its images
    _write_idx(tmp_path / f"t10k-labels-idx1-ubyte{suffix}",
               np.zeros(3), gz=gz)
    _raises_alike(lambda: idx.load_mnist_idx(tmp_path, False),
                  lambda: jidx.load_mnist_idx(tmp_path, False))
    _raises_alike(lambda: idx.load_mnist_idx(tmp_path / "none", True),
                  lambda: jidx.load_mnist_idx(tmp_path / "none", True))


_CIFAR_NAMES = [f"data_batch_{i}.bin" for i in range(1, 6)] + [
    "test_batch.bin"]


def _cifar_release(root, layout="loose", per_file=4):
    rs = np.random.RandomState(0)
    root.mkdir(parents=True, exist_ok=True)
    payload = {}
    for name in _CIFAR_NAMES:
        labels = rs.randint(0, 10, per_file).astype(np.uint8)
        pixels = rs.randint(0, 256, (per_file, 3072)).astype(np.uint8)
        payload[name] = np.concatenate([labels[:, None], pixels],
                                       axis=1).tobytes()
    if layout == "tar":
        with tarfile.open(root / "cifar-10-binary.tar.gz", "w:gz") as t:
            for name, blob in payload.items():
                info = tarfile.TarInfo(f"cifar-10-batches-bin/{name}")
                info.size = len(blob)
                t.addfile(info, io.BytesIO(blob))
    else:
        base = root / "cifar-10-batches-bin" if layout == "subdir" else root
        base.mkdir(exist_ok=True)
        for name, blob in payload.items():
            (base / name).write_bytes(blob)
    return payload


@pytest.mark.parametrize("layout", ["loose", "subdir", "tar"])
def test_cifar10_reader_equals_jax(tmp_path, layout):
    _cifar_release(tmp_path, layout)
    assert cifar.cifar10_available(tmp_path) is \
        jcifar.cifar10_available(tmp_path) is True
    for train in (True, False):
        got = cifar.load_cifar10(tmp_path, train)
        assert _same(got, jcifar.load_cifar10(tmp_path, train))
        assert got[0].shape == ((20 if train else 4), 32, 32, 3)
    if layout != "loose":
        return
    for name, blob in (("data_batch_3.bin", b"\0" * 100),
                       ("data_batch_2.bin", bytes([11]) + b"\0" * 3072)):
        (tmp_path / name).write_bytes(blob)
        _raises_alike(lambda: cifar.load_cifar10(tmp_path, True),
                      lambda: jcifar.load_cifar10(tmp_path, True))
    _raises_alike(lambda: cifar.load_cifar10(tmp_path / "none", True),
                  lambda: jcifar.load_cifar10(tmp_path / "none", True))


def _image_folder(root, layout):
    from PIL import Image

    def save(path, seed, size=8):
        arr = np.random.RandomState(seed).randint(0, 256, (size, size, 3))
        Image.fromarray(arr.astype(np.uint8)).save(path)

    if layout == "classes":
        for c, (cls, n) in enumerate((("ants", 22), ("bees", 10),
                                      ("tiny", 3))):
            (root / cls).mkdir(parents=True)
            for i in range(n):
                save(root / cls / f"img{i:03d}.png", 100 * c + i,
                     size=8 + i % 3)
        (root / "empty").mkdir()
    elif layout == "explicit":
        for s, split in enumerate(("train", "test")):
            for cls in ("ants", "bees"):
                (root / split / cls).mkdir(parents=True)
                for i in range(4):
                    save(root / split / cls / f"i{i}.png", 10 * s + i)
    else:                               # flat corpus with zip junk
        root.mkdir(parents=True, exist_ok=True)
        for i in range(24):
            save(root / f"photo{i:03d}.png", i)
        (root / "__MACOSX").mkdir()
        (root / "__MACOSX" / "._photo000.png").write_bytes(b"junk")
        (root / ".ipynb_checkpoints").mkdir()
        (root / "._photo999.png").write_bytes(b"junk")


@pytest.mark.parametrize("layout", ["classes", "explicit", "flat"])
def test_image_folder_equals_jax(tmp_path, layout):
    pytest.importorskip("PIL")
    _image_folder(tmp_path, layout)
    for split, jsplit in ((Split.TRAIN, JSplit.TRAIN),
                          (Split.VALIDATION, JSplit.VALIDATION),
                          (Split.TEST, JSplit.TEST)):
        if layout == "explicit" and split == Split.VALIDATION:
            _raises_alike(lambda: folder.ImageFolder(tmp_path, split),
                          lambda: jfolder.ImageFolder(tmp_path, jsplit))
            continue
        ds = folder.ImageFolder(tmp_path, split, size=16)
        jds = jfolder.ImageFolder(tmp_path, jsplit, size=16)
        assert ds.classes == jds.classes and ds.items == jds.items
        for i in (0, len(ds) - 1):
            assert _same(ds[i], jds[i])
    if layout == "classes":
        ds = folder.ImageFolder(tmp_path, "train")
        assert _same(ds[3], jfolder.ImageFolder(tmp_path, "train")[3])
    _raises_alike(lambda: folder.ImageFolder(tmp_path / "nope"),
                  lambda: jfolder.ImageFolder(tmp_path / "nope"))


# ------------------------------------------------------------------ chain
def _link(tmp_path, link):
    """``(name, root, kwargs)`` that resolve through ``link`` of the
    chain."""
    if link == "registry:synthetic_images":
        return "synthetic_images", "unused", {"size": 16, "palette": 0.3}
    if link in ("registry:mnist_idx", "local:mnist_idx"):
        _mnist_release(tmp_path, gz=True)
        return link.split(":")[0] == "local" and "mnist" or "mnist_idx", \
            str(tmp_path), {}
    if link in ("registry:cifar10_bin", "local:cifar10_bin"):
        _cifar_release(tmp_path, "tar")
        return link.split(":")[0] == "local" and "cifar10" or "cifar10_bin", \
            str(tmp_path), {}
    if link == "registry:image_folder":
        pytest.importorskip("PIL")
        _image_folder(tmp_path, "flat")
        return "image_folder", str(tmp_path), {"size": 8}
    if link == "store":
        rs = np.random.RandomState(9)
        for split in (JSplit.TRAIN, JSplit.TEST):
            JBaseDataset.prepare(tmp_path, split, [
                (rs.rand(2, 2).astype(np.float32), i) for i in range(6)])
        return "cifar10", str(tmp_path), {}
    assert link == "synthetic:synthetic_cifar10"
    return "cifar10", str(tmp_path), {}


@pytest.mark.parametrize("link", [
    "registry:synthetic_images", "registry:mnist_idx",
    "registry:cifar10_bin", "registry:image_folder", "store",
    "local:mnist_idx", "local:cifar10_bin", "synthetic:synthetic_cifar10"])
def test_each_link_of_the_chain_equals_jax(tmp_path, caplog, link):
    name, root, kw = _link(tmp_path, link)
    for split, jsplit in ((Split.TRAIN, JSplit.TRAIN),
                          (Split.TEST, JSplit.TEST)):
        with caplog.at_level(logging.WARNING):
            ds = DatasetConfig(name=name, root=root, n_examples=16).make(
                split, **kw)
        jds = JDatasetConfig(name=name, root=root, n_examples=16).make(
            jsplit, **kw)
        assert ds.resolution == jds.resolution == link
        assert len(ds) == len(jds)
        for i in (0, len(ds) - 1):
            if link == "registry:synthetic_images":
                np.testing.assert_allclose(ds[i], jds[i], rtol=0, atol=1e-6)
            else:
                assert _same(ds[i], jds[i])
    if link.startswith("synthetic:"):
        assert "using synthetic_cifar10 stand-in" in caplog.text
    if link == "store":
        assert isinstance(ds, sources.StoreDataset)


def test_unknown_name_exits_and_acceptance_fn_wraps_streams(monkeypatch):
    for conf, resolve in ((DatasetConfig, sources.resolve_dataset),
                          (JDatasetConfig, jsources.resolve_dataset)):
        with pytest.raises(SystemExit):
            resolve(conf(name="definitely_not_a_dataset_xyz", root="unused"),
                    "train")
    rows = np.arange(46, dtype=np.int32).reshape(23, 2)
    monkeypatch.setitem(sources._REGISTRY, "test_stream",
                        lambda conf, split, **kw: _stream(IterableDataset,
                                                          rows))
    monkeypatch.setitem(jsources._REGISTRY, "test_stream",
                        lambda conf, split, **kw: _stream(JIterable, rows))
    keep = lambda item: int(item["i"]) % 4 == 1  # noqa: E731
    ds = DatasetConfig(name="test_stream").make("train", acceptance_fn=keep)
    jds = JDatasetConfig(name="test_stream").make("train", acceptance_fn=keep)
    assert isinstance(ds, SizedIterable) and len(ds) == len(jds) == 23
    assert all(map(_same, list(ds), list(jds))) and len(list(ds)) == 6


def test_huggingface_link_on_a_local_json_folder(tmp_path, monkeypatch):
    datasets = pytest.importorskip("datasets")
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE",
                        tmp_path / "cache")
    d = tmp_path / "hf_corpus"
    d.mkdir()
    (d / "train.jsonl").write_text("\n".join(
        json.dumps({"x": i, "label": i % 2}) for i in range(10)))
    (d / "test.jsonl").write_text("\n".join(
        json.dumps({"x": 100 + i, "label": i % 2}) for i in range(4)))
    for split, jsplit, n in ((Split.TRAIN, JSplit.TRAIN, 8),
                             (Split.TEST, JSplit.TEST, 4),
                             (Split.VALIDATION, JSplit.VALIDATION, 2)):
        ds = sources.resolve_dataset(DatasetConfig(name=str(d)), split)
        jds = jsources.resolve_dataset(JDatasetConfig(name=str(d)), jsplit)
        assert isinstance(ds, sources.HFDataset)
        assert ds.resolution == jds.resolution == "huggingface"
        assert len(ds) == len(jds) == n
        assert _same(ds[n - 1], jds[n - 1])
    # without the package the link answers None and the chain goes on
    monkeypatch.setitem(__import__("sys").modules, "datasets", None)
    assert sources._try_huggingface(DatasetConfig(name=str(d)),
                                    Split.TRAIN) is None


# ------------------------------------------------------------------ recipe
def _recipe_conf(root, workers):
    return recipe.Config(
        epochs=1, seed=42, depth=18, num_classes=10, clip=1.0,
        label_smoothing=0.1, pretrained="", freeze_backbone=False,
        env=EnvConfig(precision="bf16"),
        loader=LoaderConfig(batch_size=4, num_workers=workers),
        optim=OptimizerConfig(name="adamw", lr=1e-3, weight_decay=1e-2),
        scheduler=SchedulerConfig(name="cycle", n_iter=5, warmup=1,
                                  decay=("lin", "cos")),
        dataset=DatasetConfig(name="cifar10", root=str(root)))


def test_resnet_recipe_workers_keep_the_label_order(tmp_path, monkeypatch):
    """``main`` over a small CIFAR-10 binary release with two loader
    threads: the same labels in the same order as without workers, train
    and eval (augmented pixels differ by design: each worker keys its
    generator on its thread)."""
    _cifar_release(tmp_path, "loose", per_file=4)
    seen: list = []
    real = recipe.to_device

    def spy(batch, device):
        images, labels = real(batch, device)
        seen.append(labels.tolist())
        return images, labels

    monkeypatch.setattr(recipe, "to_device", spy)
    # one intra-op thread: beside the loader's threads and other test
    # processes, OpenMP's barriers would otherwise stall on busy cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    orders = []
    try:
        for workers in (0, 2):
            conf = _recipe_conf(tmp_path, workers)
            assert conf.dataset.make(Split.TRAIN).resolution == \
                "local:cifar10_bin"
            seen.clear()
            res = recipe.main(conf, device="cpu")
            assert res["train_steps"] == 5
            assert all(math.isfinite(s["loss"]) for s in res["steps"])
            orders.append(list(seen))
    finally:
        torch.set_num_threads(threads)
    assert len(orders[0]) == 5 + 1 and orders[0] == orders[1]
