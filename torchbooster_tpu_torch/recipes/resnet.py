"""ResNet image classification — the port of the JAX recipe
``examples/img_cls/resnet/resnet.py``, driven by the same YAML:

    python -m torchbooster_tpu_torch.recipes.resnet [config.yml]

which runs :func:`main` under ``distributed.launch`` (:func:`launch_main`):
one process per card of ``env.n_devices``, each in the NCCL group, or
with ``env.distributed: true`` on one card a world-1 group
(``examples/img_cls/resnet/resnet.yml`` by default: ResNet-18 with the
CIFAR stem, batch 512, bf16 over fp32 masters, AdamW, the cycle schedule,
clip 1.0 and label smoothing 0.1; reading a YAML needs PyYAML). The flow
is the JAX recipe's: the train split behind host-side augmentation
(pad-crop, flip, rotation, random erasing; numpy and scipy on the host),
the head swapped onto ``num_classes``, ``utils.make_step`` at the
``env.precision`` compute dtype, and an eval pass over the test split
after every epoch. ``dataset: cifar10`` resolves as in the JAX chain: a
record store ``root/<split>.bstore``, else the CIFAR-10 binary release
under ``root``, else (offline) its ``synthetic_cifar10`` twin. The YAML's
``loader.num_workers`` runs the fetch and augmentation in that many
threads. On the card the conv + GroupNorm pairs run kernels B5-B8.

``pretrained``: a ``.pt``/``.pth`` torchvision-layout ``state_dict``
imports through ``models.resnet.load_torch_state`` (BatchNorms folded,
the model run with ``norm="affine"``, which takes no kernel); a
checkpoint directory written by ``callbacks.SaveCallback`` restores its
parameter tree (``norm="group"``). An orbax checkpoint needs the JAX
package and raises here.

Across ranks (``env.distributed: true``, ``env.mesh: dp`` or
``dp,fsdp:N``): each rank reads its strided shard of every batch, the
state is laid out by ``ResNet.SHARDING_RULES`` (conv kernels' output
channels and the head's input over ``fsdp``), ``make_step`` gathers
the sharded leaves before the loss (B7/B8 take whole kernels) and
averages the gradient over the data axes; the eval metrics are the mean
over the ranks. Only the primary rank prints."""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from torchbooster_tpu_torch import distributed as dist
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.callbacks import STATE_FILE, _like
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


def load_pretrained(conf: Config, params: dict, generator: torch.Generator,
                    device: str | torch.device = "cuda") -> tuple[dict, str]:
    """Restore backbone weights and swap the head onto ``num_classes``
    (JAX ``load_pretrained``). ``pretrained: ""`` keeps ``params``. A
    ``.pt``/``.pth`` file is a torchvision-layout ``state_dict``, read
    with ``torch.load(..., weights_only=True)`` and imported by
    ``load_torch_state`` (head swapped there; ``norm="affine"``). A
    directory is a checkpoint ``callbacks.SaveCallback`` wrote: its
    ``params`` tree (or its ``state``'s) loads into ``params``. Returns
    ``(params, norm)``."""
    from torchbooster_tpu_torch.models.resnet import load_torch_state

    path = Path(conf.pretrained) if conf.pretrained else None
    if path and not path.exists():
        # fail loudly: fine-tuning random weights (perhaps with a frozen
        # backbone) gives plausible-looking garbage
        raise FileNotFoundError(f"pretrained checkpoint not found: {path}")
    if path and path.suffix in (".pt", ".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        params = load_torch_state(sd, num_classes=conf.num_classes,
                                  generator=generator, device=device)
        return params, "affine"
    if path:
        params = restore_params(path, params)
    return ResNet.swap_head(params, generator, conf.num_classes), "group"


def restore_params(path: Path, like: dict) -> dict:
    """The parameter tree of the checkpoint directory ``path`` written by
    ``callbacks.SaveCallback`` (a ``params`` entry, or a train
    ``state``'s), onto the devices and dtypes of ``like``'s leaves. Any
    other directory raises: the JAX package's orbax checkpoints need the
    JAX package to read."""
    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    file = path / STATE_FILE
    if not file.is_file():
        raise ValueError(
            f"pretrained {path}: not a checkpoint of this package (no "
            f"{STATE_FILE}); an orbax checkpoint needs the JAX package "
            f"(torchbooster_tpu) to read")
    saved = torch.load(file, map_location="cpu", weights_only=True)
    tree = saved.get("params")
    if tree is None and isinstance(saved.get("state"), dict):
        tree = saved["state"].get("params")
    if tree is None:
        raise ValueError(f"pretrained {path}: the checkpoint holds no "
                         f"params tree (keys {sorted(saved)})")
    shapes = [[(key, tuple(leaf.shape)) for key, leaf in tree_flatten(t)]
              for t in (tree, like)]
    if shapes[0] != shapes[1]:
        raise ValueError(f"pretrained {path}: its params tree does not "
                         f"match the model's")
    return _like(tree, like)


def to_device(batch: Any, device: torch.device) -> tuple:
    """Host ``(images, labels)`` numpy → NHWC float and int64 tensors on
    ``device``, copied from pinned memory on a card. A batch whose tensors
    are already on ``device`` (``data.prefetch_to_device``'s) passes as it
    is."""
    images, labels = unpack(batch)
    if all(isinstance(x, torch.Tensor) and x.device.type == device.type
           and device.index in (None, x.device.index)
           for x in (images, labels)):
        return images, labels
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
    mesh: Any = None

    def eval_params(self) -> dict:
        """The whole parameter tree for the eval forward: each leaf the
        rule table sharded, all-gathered."""
        from torchbooster_tpu_torch.parallel.sharding import full_tree

        return full_tree(self.state.params, self.mesh)


def setup(conf: Config, device: str | torch.device = "cuda") -> Trainer:
    """Data, model (head swapped), optimizer and the train and eval
    steps, on ``device``."""
    generator = utils.seed(conf.seed)
    dev = conf.env.device(device)
    mesh = dist.get_mesh(conf.env, device=device)
    train_set = TransformDataset(conf.dataset.make(Split.TRAIN),
                                 augment(conf.seed + dist.get_rank()))
    test_set = conf.dataset.make(Split.TEST)
    train_loader = conf.loader.make(train_set, shuffle=True,
                                    distributed=conf.env.distributed,
                                    seed=conf.seed)
    test_loader = conf.loader.make(test_set, shuffle=False,
                                   distributed=conf.env.distributed)
    params = ResNet.init(generator, depth=conf.depth,
                         num_classes=conf.num_classes, stem="cifar",
                         device=dev)
    params, norm = load_pretrained(conf, params, generator, dev)
    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    if conf.freeze_backbone:
        # only the swapped head trains; frozen paths get no update
        tx = utils.freeze(lambda path: not path.startswith("head"), tx)
    state = utils.TrainState.create(params, tx, generator=generator)
    # the YAML mesh lays the state out by the model's rule table (a
    # dp-only mesh replicates it from rank 0)
    state = conf.env.make(state, model=ResNet, device=device)
    compute = conf.env.compute_dtype()
    step = utils.make_step(make_loss_fn(conf, train=True, norm=norm), tx,
                           clip=conf.clip, compute_dtype=compute,
                           mesh=mesh, rules=ResNet.SHARDING_RULES)
    eval_step = utils.make_eval_step(make_loss_fn(conf, train=False,
                                                  norm=norm),
                                     compute_dtype=compute)
    return Trainer(conf=conf, device=dev, state=state, step=step,
                   eval_step=eval_step, train_loader=train_loader,
                   test_loader=test_loader, mesh=mesh)


def main(conf: Config, device: str | torch.device = "cuda") -> dict:
    """:func:`setup`, then :func:`run` (on every rank under
    :func:`launch_main`)."""
    return run(setup(conf, device))


def run(t: Trainer) -> dict:
    """Train ``t.conf.epochs`` epochs with an eval pass after each (the
    image recipes' loop). Returns the last epoch's record
    (``train_*``/``test_*`` metrics, ``train_s`` the wall time of its
    training loop, ended by reading its metrics) plus ``log`` (every
    epoch's record) and ``steps`` (per train step: ``loss``, and
    ``data_s``, the host time to fetch, augment and copy its batch)."""
    results: dict = {}
    log: list[dict] = []
    steps: list[dict] = []
    for epoch in range(t.conf.epochs):
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
        params = t.eval_params()
        for batch in t.test_loader:
            metrics.update(t.eval_step(params, to_device(batch, t.device),
                                       t.state.generator))
        test_metrics = metrics.compute()
        if test_metrics and t.mesh is not None and t.mesh.distributed:
            # each rank evaluated its shard: the mean over the ranks
            test_metrics = {k: float(np.mean(v)) for k, v in
                            dist.gather(test_metrics).items()}

        if losses:
            steps.extend({"epoch": epoch, "loss": loss, "data_s": d}
                         for loss, d in zip(torch.stack(losses).tolist(),
                                            data_s))
        results = {"epoch": epoch, "train_steps": len(losses),
                   "train_s": train_s,
                   **{f"train_{k}": v for k, v in train_metrics.items()},
                   **{f"test_{k}": v for k, v in test_metrics.items()}}
        log.append(results)
        if dist.is_primary():
            print({k: round(v, 4) if isinstance(v, float) else v
                   for k, v in results.items()}, flush=True)
    return {**results, "log": log, "steps": steps}


def launch_main(conf: Config, device: str = "cuda") -> Any:
    """:func:`main` under ``distributed.launch`` with the YAML's ``env``
    (the JAX recipe's ``__main__``): NCCL on the card, gloo with
    ``device="cpu"``; one result a rank (the result itself at world 1
    without ``distributed``)."""
    return dist.launch(main, conf.env.devices(), conf.env.n_machine,
                       conf.env.machine_rank, conf.env.dist_url,
                       args=(conf, device), distributed=conf.env.distributed,
                       device=device)


if __name__ == "__main__":
    utils.boost()
    launch_main(Config.load(sys.argv[1] if len(sys.argv) > 1
                            else DEFAULT_YAML))
