"""Dataset resolution — the port of ``torchbooster_tpu/data/sources.py``'s
chain, as far as the data it can serve: the builtin registry (the
synthetic families and the byte-level ``text_file`` corpus, byte-identical
to the JAX package's), then the offline step of the chain that turns
``mnist``, ``cifar10`` and ``imagenet`` into their synthetic twins with
the JAX package's warning.

The local record stores, the raw MNIST/CIFAR readers and HuggingFace wait
for the data path (``ROADMAP.md`` A9): where ``root`` holds a store or a
raw release that the JAX chain would read, the port raises
``NotImplementedError`` rather than train on the twin; any other name the
registry does not hold raises too."""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Callable

import numpy as np

from torchbooster_tpu_torch.dataset import ArrayDataset, Split

_REGISTRY: dict[str, Callable] = {}


def register_dataset(name: str, builder: Callable | None = None):
    """Register a dataset builder ``(conf, split, **kw) -> Dataset``.
    Usable as a decorator."""
    if builder is None:
        return lambda fn: register_dataset(name, fn)
    _REGISTRY[name.lower()] = builder
    return builder


def _synthetic_size(conf: Any, split: Split, default_train: int) -> int:
    n = getattr(conf, "n_examples", 0) or 0
    if n:
        return n if split == Split.TRAIN else max(n // 8, 1)
    return default_train if split == Split.TRAIN else default_train // 8


def _synthetic_classification(n: int, shape: tuple, classes: int,
                              split: Split, seed: int = 0) -> ArrayDataset:
    """Deterministic class-conditional Gaussian images (learnable: a
    linear probe separates them), the JAX package's bytes."""
    rng = np.random.RandomState(seed + {"train": 0, "validation": 1,
                                        "test": 2}[split.value])
    labels = rng.randint(0, classes, n).astype(np.int32)
    prototypes = np.random.RandomState(seed).randn(classes, *shape) \
        .astype(np.float32)
    images = prototypes[labels] + 0.5 * rng.randn(n, *shape).astype(np.float32)
    return ArrayDataset(images.astype(np.float32), labels)


@register_dataset("synthetic_mnist")
def _synthetic_mnist(conf: Any, split: Split, **kw):
    n = _synthetic_size(conf, split, 8_192)
    return _synthetic_classification(n, (28, 28, 1), 10, split)


@register_dataset("synthetic_cifar10")
def _synthetic_cifar10(conf: Any, split: Split, **kw):
    n = _synthetic_size(conf, split, 8_192)
    return _synthetic_classification(n, (32, 32, 3), 10, split)


@register_dataset("synthetic_imagenet")
def _synthetic_imagenet(conf: Any, split: Split, **kw):
    n = _synthetic_size(conf, split, 2_048)
    return _synthetic_classification(n, (224, 224, 3), 1000, split)


@register_dataset("synthetic_lm")
def _synthetic_lm(conf: Any, split: Split, seq_len: int = 256,
                  vocab: int = 1_024, **kw):
    """Token streams from a fixed-transition Markov chain — structure a
    language model can learn. The same split and vocab give the same
    tokens as the JAX package, byte for byte."""
    n = _synthetic_size(conf, split, 4_096)
    rng = np.random.RandomState(0 if split == Split.TRAIN else 1)
    transitions = np.random.RandomState(7).randint(0, vocab, (vocab, 4))
    tokens = np.empty((n, seq_len), np.int32)
    state = rng.randint(0, vocab, n)
    for t in range(seq_len):
        tokens[:, t] = state
        choice = rng.randint(0, 4, n)
        state = transitions[state, choice]
    return ArrayDataset(tokens)


@register_dataset("text_file")
def _text_file(conf: Any, split: Split, seq_len: int = 256,
               stride: int = 0, **kw):
    """Byte-level LM corpus from a local text file (``root`` names the
    file): UTF-8 bytes are the tokens (vocab 256; ``ByteTokenizer``
    decodes samples back to text). A positional 90/5/5 train /
    validation / test split, so the held-out sets are disjoint; windows
    of ``seq_len`` every ``stride`` (default: non-overlapping). The JAX
    package's arrays, byte for byte."""
    from torchbooster_tpu_torch.data.tokenizer import ByteTokenizer

    vocab = kw.get("vocab", 0)
    if vocab and vocab < 256:
        raise ValueError(
            f"text_file dataset emits byte tokens 0..255; model vocab "
            f"{vocab} < 256 would index out of range")
    path = Path(conf.root)
    if not path.is_file():
        raise FileNotFoundError(
            f"text_file dataset: root={conf.root!r} is not a file")
    raw = ByteTokenizer().encode(path.read_bytes())
    cut1, cut2 = int(len(raw) * 0.90), int(len(raw) * 0.95)
    data = {Split.TRAIN: raw[:cut1],
            Split.VALIDATION: raw[cut1:cut2],
            Split.TEST: raw[cut2:]}[split]
    stride = stride or seq_len
    if len(data) < seq_len:
        raise ValueError(
            f"text_file dataset: split {split.value!r} has {len(data)} "
            f"tokens < seq_len={seq_len}")
    windows = np.lib.stride_tricks.sliding_window_view(
        data, seq_len)[::stride].copy()
    return ArrayDataset(windows)


_SYNTHETIC_TWINS = {"mnist": "synthetic_mnist", "cifar10": "synthetic_cifar10",
                    "imagenet": "synthetic_imagenet",
                    "imagenet-1k": "synthetic_imagenet"}
_MNIST_FILES = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
_CIFAR_FILES = tuple(f"data_batch_{i}.bin" for i in range(1, 6)) \
    + ("test_batch.bin",)


def _local_release(name: str, root: Path, split: Split) -> str | None:
    """What the JAX chain would read from ``root`` before falling back
    to a twin (a record store, MNIST IDX files, the CIFAR-10 binary
    release), or None."""
    if (root / f"{split.value}.bstore").exists():
        return f"a record store {root / f'{split.value}.bstore'}"
    if name == "mnist" and all(
            (root / f).is_file() or (root / f"{f}.gz").is_file()
            for f in _MNIST_FILES):
        return f"MNIST IDX files under {root}"
    if name == "cifar10" and (
            (root / "cifar-10-binary.tar.gz").is_file()
            or any(all((d / f).is_file() for f in _CIFAR_FILES)
                   for d in (root, root / "cifar-10-batches-bin"))):
        return f"the CIFAR-10 binary release under {root}"
    return None


def resolve_dataset(conf: Any, split: Split | str, **kwargs: Any) -> Any:
    """The dataset ``conf.name`` names: the registry first, then, with
    nothing local to read and no network, the synthetic twin."""
    if isinstance(split, str):
        split = Split(split)
    name = conf.name.lower()
    if name in _REGISTRY:
        return _REGISTRY[name](conf, split, **kwargs)
    local = _local_release(name, Path(getattr(conf, "root", "") or "."),
                           split)
    if local is not None:
        raise NotImplementedError(
            f"dataset {conf.name!r}: reading {local} is not ported yet "
            f"(ROADMAP.md A9); the port will not train on the synthetic "
            f"twin in its place")
    if name in _SYNTHETIC_TWINS:
        logging.warning("dataset %r unavailable (offline?); using %s "
                        "stand-in", conf.name, _SYNTHETIC_TWINS[name])
        return _REGISTRY[_SYNTHETIC_TWINS[name]](conf, split, **kwargs)
    raise NotImplementedError(
        f"dataset {conf.name!r}: only the builtin registry "
        f"{sorted(_REGISTRY)} and the synthetic twins of "
        f"{sorted(_SYNTHETIC_TWINS)} are ported (stores, raw readers and "
        f"HuggingFace wait for ROADMAP.md A9)")


__all__ = ["register_dataset", "resolve_dataset"]
