"""ResNet image classification on one card — the port of the JAX recipe
``examples/img_cls/resnet/resnet.py``, driven by the same YAML:

    python -m torchbooster_tpu_torch.recipes.resnet [config.yml]

(``examples/img_cls/resnet/resnet.yml`` by default: ResNet-18 with the
CIFAR stem, batch 512, bf16 over fp32 masters, AdamW, the cycle schedule,
clip 1.0 and label smoothing 0.1; reading a YAML needs PyYAML). The flow
is the JAX recipe's: the train split behind host-side augmentation
(pad-crop, flip, rotation, random erasing; numpy and scipy on the host),
the head swapped onto ``num_classes``, ``utils.make_step`` at the
``env.precision`` compute dtype, and an eval pass over the test split
after every epoch. ``dataset: cifar10`` resolves offline to its
``synthetic_cifar10`` twin, as in the JAX chain. On the card the conv +
GroupNorm pairs run kernels B5-B8.

A ``pretrained`` checkpoint (a ``.pt`` torch ``state_dict`` or an orbax
tree) waits for ``load_torch_state`` and the data path (``ROADMAP.md``
A10, A9) and raises ``NotImplementedError``; so do meshes and loader
workers (A8, A9)."""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.config import (
    BaseConfig,
    DatasetConfig,
    EnvConfig,
    LoaderConfig,
    OptimizerConfig,
    SchedulerConfig,
)
from torchbooster_tpu_torch.dataset import Split, TransformDataset
from torchbooster_tpu_torch.metrics import MetricsAccumulator, accuracy
from torchbooster_tpu_torch.models.resnet import ResNet
from torchbooster_tpu_torch.ops.losses import cross_entropy

DEFAULT_YAML = Path(__file__).resolve().parents[2] / "examples" / "img_cls" \
    / "resnet" / "resnet.yml"


@dataclass
class Config(BaseConfig):
    epochs: int
    seed: int
    depth: int
    num_classes: int
    clip: float
    label_smoothing: float
    pretrained: str         # path to a checkpoint ("" = none)
    freeze_backbone: bool

    env: EnvConfig
    loader: LoaderConfig
    optim: OptimizerConfig
    scheduler: SchedulerConfig
    dataset: DatasetConfig


def augment(seed: int):
    """Host-side train augmentation: pad-crop, flip, rotation, cutout."""
    from torchbooster_tpu_torch.data.transforms import (
        Augment, horizontal_flip, pad_crop, random_erasing, rotation)

    return Augment(seed, [
        pad_crop(32, 4),
        horizontal_flip(),
        rotation(15.0),
        random_erasing(p=0.25),
    ])


def unpack(batch):
    if isinstance(batch, dict):
        return (batch.get("img", batch.get("image", batch.get("images"))),
                batch.get("label", batch.get("labels")))
    return batch


def make_loss_fn(conf: Config, train: bool, norm: str = "group",
                 fused: str | bool = "auto",
                 gn_impl: str = "auto") -> Callable:
    """``loss_fn(params, batch, generator) -> (loss, {"acc"})``: cross
    entropy (label smoothing when training) and top-1 accuracy."""

    def loss_fn(params: dict, batch: Any, generator: Any):
        images, labels = unpack(batch)
        logits = ResNet.apply(params, images, norm=norm, fused=fused,
                              gn_impl=gn_impl)
        loss = cross_entropy(logits, labels,
                             label_smoothing=conf.label_smoothing if train
                             else 0.0)
        return loss, {"acc": accuracy(logits, labels)}

    return loss_fn


def load_pretrained(conf: Config, params: dict,
                    generator: torch.Generator) -> tuple[dict, str]:
    """``pretrained: ""`` swaps the head onto ``num_classes`` and keeps
    GroupNorm. A checkpoint path raises: importing a ``.pt`` state_dict
    waits for ``load_torch_state`` (ROADMAP.md A10), an orbax tree for the
    data path (A9). Returns ``(params, norm)``."""
    path = Path(conf.pretrained) if conf.pretrained else None
    if path and not path.exists():
        raise FileNotFoundError(f"pretrained checkpoint not found: {path}")
    if path and path.suffix in (".pt", ".pth"):
        raise NotImplementedError(
            f"pretrained {path}: importing a torch state_dict needs "
            f"load_torch_state, which is not ported yet (ROADMAP.md A10)")
    if path:
        raise NotImplementedError(
            f"pretrained {path}: restoring an orbax checkpoint is not "
            f"ported yet (ROADMAP.md A9)")
    return ResNet.swap_head(params, generator, conf.num_classes), "group"


def to_device(batch: Any, device: torch.device) -> tuple:
    """Host ``(images, labels)`` numpy → NHWC float and int64 tensors on
    ``device``, copied from pinned memory on a card."""
    images, labels = unpack(batch)
    images = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    labels = torch.from_numpy(np.asarray(labels)).long()
    if device.type == "cuda":
        images, labels = images.pin_memory(), labels.pin_memory()
    return (images.to(device, non_blocking=True),
            labels.to(device, non_blocking=True))


@dataclass
class Trainer:
    """What :func:`setup` builds and :func:`main` drives."""

    conf: Config
    device: torch.device
    state: utils.TrainState
    step: Callable
    eval_step: Callable
    train_loader: Any
    test_loader: Any


def setup(conf: Config, device: str | torch.device = "cuda") -> Trainer:
    """Data, model (head swapped), optimizer and the train and eval
    steps, on ``device``."""
    generator = utils.seed(conf.seed)
    dev = conf.env.make(device)
    train_set = TransformDataset(conf.dataset.make(Split.TRAIN),
                                 augment(conf.seed))
    test_set = conf.dataset.make(Split.TEST)
    train_loader = conf.loader.make(train_set, shuffle=True,
                                    distributed=conf.env.distributed,
                                    seed=conf.seed)
    test_loader = conf.loader.make(test_set, shuffle=False,
                                   distributed=conf.env.distributed)
    params = ResNet.init(generator, depth=conf.depth,
                         num_classes=conf.num_classes, stem="cifar",
                         device=dev)
    params, norm = load_pretrained(conf, params, generator)
    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    if conf.freeze_backbone:
        # only the swapped head trains; frozen paths get no update
        tx = utils.freeze(lambda path: not path.startswith("head"), tx)
    state = utils.TrainState.create(params, tx, generator=generator)
    compute = conf.env.compute_dtype()
    step = utils.make_step(make_loss_fn(conf, train=True, norm=norm), tx,
                           clip=conf.clip, compute_dtype=compute)
    eval_step = utils.make_eval_step(make_loss_fn(conf, train=False,
                                                  norm=norm),
                                     compute_dtype=compute)
    return Trainer(conf=conf, device=dev, state=state, step=step,
                   eval_step=eval_step, train_loader=train_loader,
                   test_loader=test_loader)


def main(conf: Config, device: str | torch.device = "cuda") -> dict:
    """Train ``conf.epochs`` epochs with an eval pass after each. Returns
    the last epoch's record (``train_*``/``test_*`` metrics, ``train_s``
    the wall time of its training loop, ended by reading its metrics)
    plus ``log`` (every epoch's record) and ``steps`` (per train step:
    ``loss``, and ``data_s``, the host time to fetch, augment and copy
    its batch)."""
    t = setup(conf, device)
    results: dict = {}
    log: list[dict] = []
    steps: list[dict] = []
    for epoch in range(conf.epochs):
        metrics = MetricsAccumulator()
        losses, data_s = [], []
        t0 = time.perf_counter()
        batches = iter(t.train_loader)
        while True:
            t_fetch = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            batch = to_device(batch, t.device)
            data_s.append(time.perf_counter() - t_fetch)
            t.state, step_metrics = t.step(t.state, batch)
            metrics.update(step_metrics)
            losses.append(step_metrics["loss"])
        train_metrics = metrics.compute()
        train_s = time.perf_counter() - t0

        metrics = MetricsAccumulator()
        for batch in t.test_loader:
            metrics.update(t.eval_step(t.state.params,
                                       to_device(batch, t.device),
                                       t.state.generator))
        test_metrics = metrics.compute()

        if losses:
            steps.extend({"epoch": epoch, "loss": loss, "data_s": d}
                         for loss, d in zip(torch.stack(losses).tolist(),
                                            data_s))
        results = {"epoch": epoch, "train_steps": len(losses),
                   "train_s": train_s,
                   **{f"train_{k}": v for k, v in train_metrics.items()},
                   **{f"test_{k}": v for k, v in test_metrics.items()}}
        log.append(results)
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in results.items()}, flush=True)
    return {**results, "log": log, "steps": steps}


if __name__ == "__main__":
    main(Config.load(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_YAML))
