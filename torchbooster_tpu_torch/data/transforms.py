"""Host-side image augmentation — the port of
``torchbooster_tpu/data/transforms.py``, which is numpy and scipy only, so
the port carries its own copy: the same transforms, the same draws from
the same ``np.random.Generator``, byte for byte.

Augmentation runs on the host CPU, never on the card: plain numpy, HWC
float32 in, HWC float32 out.

- every transform is a picklable callable ``(rng, image) -> image``
  (module-level classes, not closures);
- :class:`Augment` composes them over dataset examples (tuple, dict, or
  bare image), threading a thread-local ``np.random.Generator`` keyed by
  ``(seed, pid, thread id)`` and rebuilt lazily after unpickling.

scipy is imported when a :class:`Rotation` is built, not at import.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Sequence

import numpy as np


class PadCrop:
    """Pad then random-crop back to ``size`` (ref RandomCrop(32, 4))."""

    def __init__(self, size: int, pad: int, mode: str = "reflect"):
        self.size, self.pad, self.mode = size, pad, mode

    def __call__(self, rng: np.random.Generator,
                 img: np.ndarray) -> np.ndarray:
        pad = self.pad
        padded = np.pad(img, ((pad, pad), (pad, pad), (0, 0)),
                        mode=self.mode)
        # full torchvision range: any offset where the crop fits
        y = int(rng.integers(0, padded.shape[0] - self.size + 1))
        x = int(rng.integers(0, padded.shape[1] - self.size + 1))
        return padded[y:y + self.size, x:x + self.size]


class HorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, rng: np.random.Generator,
                 img: np.ndarray) -> np.ndarray:
        return img[:, ::-1] if rng.random() < self.p else img


class Rotation:
    """Uniform random rotation in ±``degrees`` (ref RandomRotation)."""

    def __init__(self, degrees: float, mode: str = "reflect"):
        from scipy import ndimage  # noqa: F401 — fail fast if absent

        self.degrees, self.mode = degrees, mode

    def __call__(self, rng: np.random.Generator,
                 img: np.ndarray) -> np.ndarray:
        from scipy import ndimage  # cached module lookup

        angle = float(rng.uniform(-self.degrees, self.degrees))
        return ndimage.rotate(img, angle, reshape=False, order=1,
                              mode=self.mode).astype(img.dtype, copy=False)


class ColorJitter:
    """Multiplicative brightness + contrast-about-mean jitter."""

    def __init__(self, brightness: float = 0.0, contrast: float = 0.0):
        self.brightness, self.contrast = brightness, contrast

    def __call__(self, rng: np.random.Generator,
                 img: np.ndarray) -> np.ndarray:
        out = img
        if self.brightness:
            out = out * float(rng.uniform(1 - self.brightness,
                                          1 + self.brightness))
        if self.contrast:
            factor = float(rng.uniform(1 - self.contrast,
                                       1 + self.contrast))
            mean = out.mean(axis=(0, 1), keepdims=True)
            out = (out - mean) * factor + mean
        return out.astype(img.dtype, copy=False)


class RandomErasing:
    """Zero a random rectangle (cutout; the RandAugment-family
    occlusion regularizer)."""

    def __init__(self, p: float = 0.5,
                 scale: tuple[float, float] = (0.02, 0.2)):
        self.p, self.scale = p, scale

    def __call__(self, rng: np.random.Generator,
                 img: np.ndarray) -> np.ndarray:
        if rng.random() >= self.p:
            return img
        h, w = img.shape[:2]
        area = float(rng.uniform(*self.scale)) * h * w
        eh = max(1, min(h, int(round(np.sqrt(area)))))
        ew = max(1, min(w, int(round(area / eh))))
        y = int(rng.integers(0, h - eh + 1))
        x = int(rng.integers(0, w - ew + 1))
        out = img.copy()
        out[y:y + eh, x:x + ew] = 0
        return out


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, rng: np.random.Generator,
                 img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        y, x = (h - self.size) // 2, (w - self.size) // 2
        return img[y:y + self.size, x:x + self.size]


class Normalize:
    """Channel-wise standardization (ref T.Normalize)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, rng: np.random.Generator,
                 img: np.ndarray) -> np.ndarray:
        return ((img - self.mean) / self.std).astype(np.float32)


# factory-style lowercase aliases (the torchvision-ish spelling)
pad_crop = PadCrop
horizontal_flip = HorizontalFlip
rotation = Rotation
color_jitter = ColorJitter
random_erasing = RandomErasing
center_crop = CenterCrop
normalize = Normalize


class Augment:
    """Compose transforms over dataset examples.

    ``Augment(seed, [pad_crop(32, 4), horizontal_flip()])`` is a
    callable for :class:`~torchbooster_tpu_torch.dataset.TransformDataset` (or
    a loader ``collate_fn`` preprocessing stage). Examples may be a bare
    image, an ``(image, label)`` tuple (first element transformed), or a
    dict (``image_key`` selects the field). Thread-safe and picklable:
    each loader worker — thread or process — lazily builds its own
    Generator from ``(seed, thread id)``.
    """

    def __init__(self, seed: int, transforms: Sequence[Any],
                 image_key: str = "image"):
        self.seed = seed
        self.transforms = list(transforms)
        self.image_key = image_key
        self._local = threading.local()

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        del state["_local"]            # rebuilt lazily in the worker
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._local = threading.local()

    def _rng(self) -> np.random.Generator:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            # key by (seed, pid, thread id): thread idents are only
            # unique within a process, so process workers need the pid
            # too or they could replay identical augmentation streams
            rng = self._local.rng = np.random.default_rng(
                [self.seed, os.getpid(),
                 threading.get_ident() % (2 ** 31)])
        return rng

    def _apply(self, img: Any) -> np.ndarray:
        out = np.asarray(img, np.float32)
        rng = self._rng()
        for transform in self.transforms:
            out = transform(rng, out)
        return np.ascontiguousarray(out)

    def __call__(self, example: Any) -> Any:
        if isinstance(example, dict):
            out = dict(example)
            out[self.image_key] = self._apply(example[self.image_key])
            return out
        if isinstance(example, (tuple, list)):
            return (self._apply(example[0]), *example[1:])
        return self._apply(example)


__all__ = ["Augment", "CenterCrop", "ColorJitter", "HorizontalFlip",
           "Normalize", "PadCrop", "RandomErasing", "Rotation",
           "center_crop", "color_jitter", "horizontal_flip", "normalize",
           "pad_crop", "random_erasing", "rotation"]
