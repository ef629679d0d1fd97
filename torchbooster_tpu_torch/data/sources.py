"""Dataset resolution over the builtin registry — the port of the first
link of ``torchbooster_tpu/data/sources.py``'s chain. The local record
stores, the raw MNIST/CIFAR readers and HuggingFace wait for the data
path (``ROADMAP.md`` A9); a name the registry does not hold raises."""
from __future__ import annotations

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


def resolve_dataset(conf: Any, split: Split | str, **kwargs: Any) -> Any:
    """The dataset ``conf.name`` names, from the registry."""
    if isinstance(split, str):
        split = Split(split)
    name = conf.name.lower()
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"dataset {conf.name!r}: only the builtin registry "
            f"{sorted(_REGISTRY)} is ported (stores, raw readers and "
            f"HuggingFace wait for ROADMAP.md A9)")
    return _REGISTRY[name](conf, split, **kwargs)


__all__ = ["register_dataset", "resolve_dataset"]
