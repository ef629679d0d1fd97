"""Dataset resolution — the port of ``torchbooster_tpu/data/sources.py``'s
chain, link for link:

1. **registry** — names registered through :func:`register_dataset`: the
   network-free synthetic families (``synthetic_mnist``,
   ``synthetic_cifar10``, ``synthetic_imagenet``, ``synthetic_lm``,
   ``synthetic_images``), the byte-level ``text_file`` corpus and the
   local readers ``mnist_idx``, ``cifar10_bin`` and ``image_folder``;
2. **local record store** — ``root/<split>.bstore`` (``BaseDataset.prepare``
   builds one) as a :class:`StoreDataset`;
3. **local raw releases** — for ``mnist`` the LeCun IDX files under
   ``root`` (``data/idx.py``), for ``cifar10`` the binary batches or
   tarball (``data/cifar.py``);
4. **HuggingFace ``datasets``** — by name (+ ``task`` as the config name),
   with the 80/20 train-split fallback when a dataset lacks a test split;
   ``datasets`` is imported at this link only, and its absence skips it;
5. the synthetic twin of ``mnist``, ``cifar10`` and ``imagenet``, with
   the JAX package's warning;
6. otherwise ``logging.fatal`` and ``sys.exit(1)``.

Each dataset is tagged with ``resolution``, the link that answered. The
synthetic families give the JAX package's bytes; ``procedural_image``
gives its values (the bicubic resize is numpy here)."""
from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Any, Callable

import numpy as np

from torchbooster_tpu_torch.dataset import (
    ArrayDataset,
    BaseDataset,
    Dataset,
    Split,
)

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


def _keys_cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """``(n_in, n_out)`` float32 weights of ``jax.image.resize``'s
    ``"bicubic"`` along one axis (Keys cubic, a = -0.5, half-pixel
    centres, the kernel widened by the scale when downsampling
    (antialiasing), each output's taps renormalized to sum to 1)."""
    inv_scale = np.float32(1.0) / np.float32(n_out / n_in)
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
        * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / max(inv_scale, np.float32(1.0))
    w = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    w = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                            - np.float32(4.0)) * x + np.float32(2.0), w)
    w = np.where(x >= 2.0, np.float32(0.0), w).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def procedural_image(size: int, seed: int, palette: float = 0.0) -> np.ndarray:
    """One deterministic procedural RGB image in [0, 1]: a smooth random
    colour field (8 × 8 noise, bicubic-upsampled). The offline stand-in
    for downloaded photos (the style recipes' image corpora).
    ``palette`` skews the colour distribution so that two corpora (photos,
    paintings) look different."""
    rng = np.random.RandomState(seed % (2 ** 32 - 1))
    base = rng.rand(8, 8, 3).astype(np.float32)
    if palette:
        base = np.clip(base + palette * np.sin(base * np.pi), 0.0, 1.0)
    wh = _keys_cubic_weights(8, size)
    image = np.einsum("hwc,hH,wW->HWc", base, wh, wh, optimize=True)
    return np.clip(image.astype(np.float32), 0.0, 1.0)


class ProceduralImages(Dataset):
    """Per-index deterministic procedural RGB images (an offline stand-in
    for an image corpus; see :func:`procedural_image`)."""

    def __init__(self, n: int, size: int, seed: int = 0,
                 palette: float = 0.0):
        self.n, self.size, self.seed, self.palette = n, size, seed, palette

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int) -> np.ndarray:
        return procedural_image(self.size,
                                self.seed * 1_000_003 + index,
                                self.palette)


@register_dataset("synthetic_images")
def _synthetic_images(conf: Any, split: Split, size: int = 256,
                      palette: float = 0.0, **kw):
    n = _synthetic_size(conf, split, 2_048)
    seed = {"train": 0, "validation": 1, "test": 2}[split.value]
    return ProceduralImages(n, size, seed=seed, palette=palette)


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


@register_dataset("mnist_idx")
def _mnist_idx(conf: Any, split: Split, **kw):
    """Real MNIST from standard IDX files under ``root`` (no network,
    no HF — data/idx.py). TEST and VALIDATION both read the t10k
    files (MNIST ships no validation split; documented alias)."""
    from torchbooster_tpu_torch.data.idx import load_mnist_idx

    images, labels = load_mnist_idx(conf.root, train=split == Split.TRAIN)
    return ArrayDataset(images, labels)


@register_dataset("cifar10_bin")
def _cifar10_bin(conf: Any, split: Split, **kw):
    """Real CIFAR-10 from the standard binary release under ``root``
    (no network, no HF, no pickle — data/cifar.py). TEST and
    VALIDATION both read test_batch.bin (CIFAR-10 ships no validation
    split; documented alias, same as mnist_idx)."""
    from torchbooster_tpu_torch.data.cifar import load_cifar10

    images, labels = load_cifar10(conf.root, train=split == Split.TRAIN)
    return ArrayDataset(images, labels)


@register_dataset("image_folder")
def _image_folder(conf: Any, split: Split, size: int | None = None,
                  **kw):
    """Local labeled image corpus: ``root/<class>/*.png`` (or
    ``root/{train,test,validation}/<class>/*``) — the zero-egress
    analogue of the torchvision ImageFolder idiom the reference's
    by-name resolution served (ref config.py:571-576); data/folder.py."""
    from torchbooster_tpu_torch.data.folder import ImageFolder

    return ImageFolder(conf.root, split, size=size)


# ---------------------------------------------------------------- stores

class StoreDataset(BaseDataset):
    """Concrete BaseDataset over an existing ``root/<split>.bstore``."""


# ---------------------------------------------------------------- HF

class HFDataset:
    """Map-style wrapper over a HuggingFace dataset split
    (ref config.py:589-614)."""

    def __init__(self, hf_split: Any):
        self.hf_split = hf_split

    def __len__(self) -> int:
        return len(self.hf_split)

    def __getitem__(self, index: int) -> Any:
        item = self.hf_split[int(index)]
        return {k: np.asarray(v) for k, v in item.items()}


def _try_huggingface(conf: Any, split: Split):
    try:
        from datasets import load_dataset  # type: ignore
    except ImportError:
        return None
    name = conf.name
    task = getattr(conf, "task", "") or None
    try:
        # metadata-only split listing (one fetch, not a load per probe);
        # when the listing itself fails (offline with a cached dataset,
        # transient hub error) fall back to probing each needed split
        # from cache — real test/validation splits must win over the
        # 80/20 train fallback whenever they are loadable
        available: set[str] | None
        try:
            from datasets import get_dataset_split_names  # type: ignore

            available = set(get_dataset_split_names(name, task))
        except Exception:
            available = None

        def has_split(wanted: str) -> bool:
            if available is not None:
                return wanted in available
            if wanted == "train":
                return True
            try:
                load_dataset(name, task, split=f"{wanted}[:1]")
                return True
            except Exception:
                return False

        # 80/20 train-split fallback when no test/validation split
        # exists (ref config.py:589-614) — splits must be DISJOINT:
        # whenever ANY eval split falls back onto train[80%:], train
        # must shrink to train[:80%] (eval data must never appear in
        # the training set).
        eval_falls_back = not (has_split("test") and has_split("validation"))
        if split == Split.TEST:
            data = load_dataset(name, task, split="test") \
                if has_split("test") else \
                load_dataset(name, task, split="train[80%:]")
        elif split == Split.VALIDATION:
            data = load_dataset(name, task, split="validation") \
                if has_split("validation") else \
                load_dataset(name, task, split="train[80%:]")
        else:
            data = load_dataset(name, task, split="train[:80%]") \
                if eval_falls_back else \
                load_dataset(name, task, split="train")
        return HFDataset(data)
    except Exception as error:  # offline / unknown dataset
        logging.warning("huggingface load of %r failed: %s", name, error)
        return None


_SYNTHETIC_TWINS = {"mnist": "synthetic_mnist", "cifar10": "synthetic_cifar10",
                    "imagenet": "synthetic_imagenet",
                    "imagenet-1k": "synthetic_imagenet"}


def resolve_dataset(conf: Any, split: Split | str, download: bool = True,
                    distributed: bool = False,
                    acceptance_fn: Callable | None = None,
                    **kwargs: Any) -> Any:
    """The resolution chain (see module docstring). ``distributed`` and
    ``acceptance_fn`` apply to stream datasets (ref config.py:578-587);
    map datasets shard in the loader instead."""
    if isinstance(split, str):
        split = Split(split)
    name = conf.name.lower()

    resolution = None   # which chain link answered (self-describing)
    if name in _REGISTRY:
        dataset = _REGISTRY[name](conf, split, **kwargs)
        resolution = f"registry:{name}"
    else:
        store = StoreDataset.store_path(conf.root, split)
        if Path(store).exists():
            dataset = StoreDataset(conf.root, split)
            resolution = "store"
        else:
            dataset = None
            if name == "mnist":
                # real IDX files dropped under root win over the
                # network path — the zero-egress real-data route
                from torchbooster_tpu_torch.data.idx import mnist_idx_available

                if mnist_idx_available(conf.root):
                    dataset = _REGISTRY["mnist_idx"](conf, split, **kwargs)
                    resolution = "local:mnist_idx"
            elif name == "cifar10":
                # same zero-egress route for the reference's flagship
                # ResNet recipe dataset (ref resnet.yml): a binary
                # release under root wins over the network path
                from torchbooster_tpu_torch.data.cifar import cifar10_available

                if cifar10_available(conf.root):
                    dataset = _REGISTRY["cifar10_bin"](conf, split,
                                                       **kwargs)
                    resolution = "local:cifar10_bin"
            if dataset is None:
                dataset = _try_huggingface(conf, split)
                resolution = "huggingface" if dataset is not None else None
            if dataset is None and name in _SYNTHETIC_TWINS:
                logging.warning(
                    "dataset %r unavailable (offline?); using %s stand-in",
                    conf.name, _SYNTHETIC_TWINS[name])
                dataset = _REGISTRY[_SYNTHETIC_TWINS[name]](conf, split,
                                                            **kwargs)
                resolution = f"synthetic:{_SYNTHETIC_TWINS[name]}"
            if dataset is None:
                # ref config.py:616-617
                logging.fatal("cannot resolve dataset %r", conf.name)
                sys.exit(1)
    try:
        # self-describing provenance: consumers that must report WHAT
        # data trained (real or synthetic) read it instead of
        # re-deriving the chain's decision
        dataset.resolution = resolution
    except (AttributeError, TypeError):  # exotic dataset types: skip
        pass

    if acceptance_fn is not None and hasattr(dataset, "__iter__") \
            and not hasattr(dataset, "__getitem__"):
        from torchbooster_tpu_torch.data.pipeline import SizedIterable

        # pre-filter size when the stream declares one (an upper bound,
        # like the reference's NUM_LINES, ref config.py:578-587)
        size = len(dataset) if hasattr(dataset, "__len__") else None
        dataset = SizedIterable(dataset, size, acceptance_fn)
    return dataset


__all__ = ["HFDataset", "ProceduralImages", "StoreDataset",
           "procedural_image", "register_dataset", "resolve_dataset"]
