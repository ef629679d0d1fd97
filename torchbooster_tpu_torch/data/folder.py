"""Local image-folder dataset — a copy of
``torchbooster_tpu/data/folder.py``: any labeled image corpus, no network,
in the torchvision ``ImageFolder`` idiom (a directory of class
subdirectories). Point ``dataset.root`` at

    root/                      or   root/train/<class>/*.png
      <class_a>/*.png               root/test/<class>/*.png
      <class_b>/*.jpg               (validation | val | valid)

and every image under a class directory becomes one example (a FLAT
directory of images with no class subdirs is one implicit class —
unlabeled corpora for the style recipes). When the
root has no explicit split directories, a deterministic 90/5/5
positional split WITHIN each class serves train/validation/test
(stratified — every split sees every class). Class indices follow sorted
class-directory names — counting only directories that actually contain
images, so zip-artifact junk (``__MACOSX/``, ``.ipynb_checkpoints/``,
AppleDouble ``._*.png`` files) neither becomes a label nor masks a flat
corpus (torchvision ImageFolder semantics otherwise), decoded
lazily per item via PIL (gated import — the loader's worker pool
parallelizes the decode exactly like torchvision's).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from torchbooster_tpu_torch.dataset import Dataset, Split

_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pgm",
               ".webp", ".tif", ".tiff"}
_SPLIT_DIRS = {
    Split.TRAIN: ("train",),
    Split.VALIDATION: ("validation", "val", "valid"),
    Split.TEST: ("test",),
}


def _split_base(root: Path, split: Split) -> Path | None:
    """The explicit split directory when the layout has one."""
    for cand in _SPLIT_DIRS[split]:
        if (root / cand).is_dir():
            return root / cand
    # a root with ANY split dir uses the explicit layout — a missing
    # eval split then means "no such data", not "reuse everything"
    if any((root / d).is_dir()
           for dirs in _SPLIT_DIRS.values() for d in dirs):
        return None
    return root


def _is_image(path: Path) -> bool:
    # skip hidden/AppleDouble files ("._photo.png" from a macOS zip
    # carries a matching suffix but is resource-fork junk, not pixels)
    return (path.suffix.lower() in _EXTENSIONS and path.is_file()
            and not path.name.startswith("."))


def _scan(base: Path) -> tuple[list[tuple[Path, int]], list[str]]:
    # classes = subdirectories that actually CONTAIN images: a stray
    # __MACOSX/ or .ipynb_checkpoints/ next to real photos must not
    # become a label (or mask the flat-corpus fallback below)
    by_class = [(d.name, [p for p in sorted(d.rglob("*"))
                          if _is_image(p)])
                for d in sorted(base.iterdir())
                if d.is_dir() and not d.name.startswith(".")]
    by_class = [(name, files) for name, files in by_class if files]
    if by_class:
        classes = [name for name, _ in by_class]
        items = [(p, idx) for idx, (_, files) in enumerate(by_class)
                 for p in files]
        return items, classes
    # flat unlabeled corpus (photos straight under base): one implicit
    # class — the style-transfer recipes consume images only, and a
    # labels-free folder should not force users to invent a class
    # directory
    flat = [p for p in sorted(base.iterdir()) if _is_image(p)]
    return [(p, 0) for p in flat], (["."] if flat else [])


class ImageFolder(Dataset):
    """``root/<class>/*.png`` → ``(image float32 [0,1] HWC, label)``.

    ``size``: optional side length — images resize (PIL bilinear) so a
    mixed-resolution corpus still batches; without it every image must
    already share a shape (the collate stack fails loudly otherwise).
    ``__getitems__`` is intentionally absent: per-item decode is the
    work the loader's thread/process workers parallelize.
    """

    def __init__(self, root: str | Path, split: Split | str = Split.TRAIN,
                 size: int | None = None):
        split = Split(split) if isinstance(split, str) else split
        root = Path(root)
        if not root.is_dir():
            raise FileNotFoundError(
                f"image_folder dataset: root={str(root)!r} is not a "
                "directory")
        base = _split_base(root, split)
        explicit = base is not None and base != root
        items, self.classes = _scan(base) if base is not None else ([], [])
        if base is not None and not explicit:
            # positional 90/5/5 WITHIN each class (the scan is
            # class-major, so a flat cut would hand validation/test
            # almost entirely the alphabetically last class — a
            # constant predictor would eval perfectly); per-class
            # stratification keeps every split representative and
            # disjoint by construction
            chosen = []
            for cls_idx in range(len(self.classes)):
                cls_items = [it for it in items if it[1] == cls_idx]
                n = len(cls_items)
                cut1 = int(n * 0.90)
                cut2 = int(n * 0.95)
                if n >= 3:
                    # small-class floor: int(n*0.95) == int(n*0.90) up
                    # to n=19, which would hand validation ZERO items
                    # of the class (and 90% rounding can starve test
                    # too) — guarantee >= 1 val and >= 1 test item
                    # whenever the class has >= 3 images, shrinking
                    # train (which keeps >= 1 by construction)
                    cut2 = min(max(cut2, cut1 + 1), n - 1)
                    cut1 = min(cut1, cut2 - 1)
                chosen.extend({Split.TRAIN: cls_items[:cut1],
                               Split.VALIDATION: cls_items[cut1:cut2],
                               Split.TEST: cls_items[cut2:]}[split])
            items = chosen
        if not items:
            raise FileNotFoundError(
                f"image_folder dataset: no images for split "
                f"{split.value!r} under {str(root)!r} (classes are "
                "subdirectories; extensions "
                f"{sorted(_EXTENSIONS)})")
        self.items = items
        self.size = size

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int):
        from PIL import Image  # gated: decoded lazily, per worker

        path, label = self.items[int(index)]
        with Image.open(path) as img:
            img = img.convert("RGB")
            if self.size is not None:
                img = img.resize((self.size, self.size),
                                 Image.Resampling.BILINEAR)
            array = np.asarray(img, np.float32) / 255.0
        return array, np.int32(label)


__all__ = ["ImageFolder"]
