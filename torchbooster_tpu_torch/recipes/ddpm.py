"""DDPM on MNIST — the port of the JAX recipe
``examples/img_gen/ddpm/ddpm.py``, driven by the same YAML:

    python -m torchbooster_tpu_torch.recipes.ddpm [config.yml]

(``examples/img_gen/ddpm/ddpm.yml`` by default, read in place; reading a
YAML needs PyYAML), which runs :func:`main` under ``distributed.launch``
(:func:`launch_main`). The flow is the JAX recipe's: ε-prediction DDPM
with a time-conditioned UNet (``models/unet.py``), the cosine or linear
schedule (``ops/diffusion.py``), ``utils.make_step`` at the
``env.precision`` compute dtype with the EMA ramp of ``ema_decay``,
``scheduler.n_iter: 0`` resolved to epochs × steps an epoch, a
checkpoint every ``save_every`` epochs (the EMA in the state) and a
resume past the epochs done, then samples from the EMA weights: DDIM at
``sample_steps`` steps, or the ancestral chain over all T at 0. With
``model.n_classes > 0`` training drops labels to the NULL class at
``p_uncond`` and sampling runs one sample a class, cycling, under
classifier-free guidance ``guidance``.

On the card each of the UNet's 29 GroupNorms a forward launches B5 and,
in training, B6 (``ops/group_norm.py``); the recipe's images are fp32
(:func:`to_unit`), so every call takes the ``"two_pass"`` route.

Across ranks (``env.distributed: true``): each rank reads its strided
shard of every batch, the state is laid out by ``UNet.SHARDING_RULES``,
``make_step`` gathers the sharded conv kernels before the loss, and the
gradient is averaged over the data axes; the checkpoint is the sharded
one, and the primary rank samples from the gathered EMA tree."""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from torchbooster_tpu_torch import distributed as dist
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.callbacks import SaveCallback
from torchbooster_tpu_torch.config import (
    BaseConfig,
    DatasetConfig,
    EnvConfig,
    LoaderConfig,
    OptimizerConfig,
    SchedulerConfig,
)
from torchbooster_tpu_torch.dataset import Split
from torchbooster_tpu_torch.metrics import MetricsAccumulator
from torchbooster_tpu_torch.models.unet import UNet, UNetConfig
from torchbooster_tpu_torch.ops.diffusion import (
    DiffusionSchedule,
    _ddpm_loss_core,
    _loss_draws,
    cfg_apply,
    ddim_sample,
    ddpm_sample,
    make_schedule,
)

EXAMPLE_DIR = Path(__file__).resolve().parents[2] / "examples" / "img_gen" \
    / "ddpm"
DEFAULT_YAML = EXAMPLE_DIR / "ddpm.yml"


@dataclass
class ModelConfig(BaseConfig):
    in_channels: int = 1
    base: int = 64
    mults: tuple(int, int, int) = (1, 2, 2)
    time_dim: int = 256
    n_classes: int = 0      # > 0: class-conditional (CFG-trained)

    def make(self) -> UNetConfig:
        return UNetConfig(in_channels=self.in_channels, base=self.base,
                          mults=tuple(self.mults), time_dim=self.time_dim,
                          n_classes=self.n_classes)


@dataclass
class Config(BaseConfig):
    epochs: int
    seed: int
    timesteps: int
    schedule: str           # linear | cosine
    n_samples: int
    sample_steps: int       # DDIM steps (0 = full ancestral chain)
    samples_path: str

    model: ModelConfig
    env: EnvConfig
    loader: LoaderConfig
    optim: OptimizerConfig
    scheduler: SchedulerConfig
    dataset: DatasetConfig

    ema_decay: float = 0.999   # 0 disables; sampling uses EMA weights
    p_uncond: float = 0.1      # CFG label-dropout rate (conditional only)
    guidance: float = 2.0      # CFG scale w at sampling time
    save_every: int = 0        # checkpoint every N epochs (0 disables)
    checkpoint_root: str = "checkpoints"


def to_unit(images: torch.Tensor) -> torch.Tensor:
    """Pixels → [−1, 1] (the DDPM data range), in fp32.

    Integer inputs are raw [0, 255] pixels; float inputs are taken as
    already in [0, 1] (the loader convention). Both map linearly; the
    clip guards float pixels slightly outside [0, 1].

    The result is fp32 whatever the batch's dtype, as in the JAX recipe:
    under ``precision: bf16`` the UNet then computes in fp32 on
    bf16-rounded weights (``layers.conv`` and ``dense`` cast a weight to
    their input's dtype), and its GroupNorms take B5/B6's fp32 route.
    That is JAX's flow, kept so that the port computes what the reference
    does; a bf16 flow would be a change of the recipe, not of the port."""
    if not images.is_floating_point():
        return images.float() / 127.5 - 1.0
    return torch.clip(images.float() * 2.0 - 1.0, -1.0, 1.0)


def unpack(batch):
    """(images, labels-or-None) from dict/tuple/bare batches."""
    if isinstance(batch, dict):
        return (batch.get("image", batch.get("images")),
                batch.get("label", batch.get("labels")))
    if isinstance(batch, (tuple, list)):
        return batch[0], (batch[1] if len(batch) > 1 else None)
    return batch, None


def to_device(batch: Any, device: torch.device) -> tuple:
    """A host batch → ``(images, labels-or-None)`` tensors on ``device``;
    the images keep their dtype (integer pixels stay integers for
    :func:`to_unit`), labels become int64."""
    images, labels = unpack(batch)
    images = torch.as_tensor(np.ascontiguousarray(images)) \
        if not isinstance(images, torch.Tensor) else images
    images = images.to(device, non_blocking=True)
    if labels is not None:
        labels = torch.as_tensor(np.asarray(labels)).long() \
            if not isinstance(labels, torch.Tensor) else labels.long()
        labels = labels.to(device, non_blocking=True)
    return images, labels


def _on(sched: DiffusionSchedule, device: torch.device) -> DiffusionSchedule:
    return DiffusionSchedule(*(table.to(device) for table in sched))


@dataclass
class Trainer:
    """What :func:`setup` builds and :func:`run` drives."""

    conf: Config
    cfg: UNetConfig
    sched: DiffusionSchedule
    device: torch.device
    state: utils.TrainState
    step: Any
    loader: Any
    mesh: Any = None
    save_cb: SaveCallback | None = None
    start_epoch: int = 0

    def apply_fn(self, params, x_t, t, labels=None):
        return UNet.apply(params, x_t, t, self.cfg, labels=labels)

    def sample_params(self) -> dict:
        """The sampling weights (the EMA tree, else the parameters),
        whole: each leaf the rule table sharded is all-gathered, so every
        rank calls it."""
        from torchbooster_tpu_torch.parallel.sharding import full_tree

        return full_tree(self.state.params, self.mesh, self.state.ema)


def make_loss_fn(conf: Config, cfg: UNetConfig, sched: DiffusionSchedule,
                 mesh: Any = None):
    """``loss_fn(params, batch, generator) -> (loss, {})``: the DDPM loss
    over the batch's images mapped to [−1, 1], its draws from the train
    state's generator; conditional models take the batch's labels with
    CFG label dropout. On a distributed ``mesh`` the batch is this
    rank's rows of the global one, and the draws are made for the global
    batch and cut to those rows (``distributed.global_draw``)."""
    conditional = cfg.n_classes > 0

    def apply_fn(params, x_t, t, labels=None):
        return UNet.apply(params, x_t, t, cfg, labels=labels)

    def loss_fn(params, batch, generator):
        images, labels = unpack(batch)
        if conditional and labels is None:
            # training would silently collapse to NULL-class-only while
            # sampling still guides per class — refuse instead
            raise ValueError("model.n_classes > 0 needs a labeled "
                             "dataset (batches carry no labels)")
        images = to_unit(images)
        if images.ndim == 3:
            images = images[..., None]
        p_drop = conf.p_uncond if conditional and conf.p_uncond > 0 \
            else None
        t, noise, drop = dist.global_draw(
            lambda n: _loss_draws(generator, (n, *images.shape[1:]),
                                  sched.T, images.dtype, p_drop),
            images.shape[0], mesh)
        dev = images.device
        loss = _ddpm_loss_core(apply_fn, params, images, t.to(dev),
                               noise.to(dev),
                               None if drop is None else drop.to(dev),
                               sched, labels if conditional else None,
                               cfg.n_classes)
        return loss, {}

    return loss_fn


def setup(conf: Config, device: str | torch.device = "cuda") -> Trainer:
    """Data, model, optimizer, the train step and the checkpoint (resumed
    when one is under ``checkpoint_root``), on ``device``.
    ``scheduler.n_iter <= 0`` is set to ``epochs`` × the loader's length,
    in place."""
    generator = utils.seed(conf.seed)
    dev = conf.env.device(device)
    mesh = dist.get_mesh(conf.env, device=device)
    cfg = conf.model.make()
    sched = _on(make_schedule(conf.schedule, conf.timesteps), dev)
    loader = conf.loader.make(conf.dataset.make(Split.TRAIN), shuffle=True,
                              distributed=conf.env.distributed,
                              seed=conf.seed)
    # n_iter: 0 in YAML means "the real run length" — epochs × steps per
    # epoch; a shorter constant pins the lr near its floor for the tail
    if conf.scheduler.n_iter <= 0:
        conf.scheduler.n_iter = conf.epochs * max(len(loader), 1)
    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    # the step's generator lies on the card with the parameters
    state = utils.TrainState.create(UNet.init(generator, cfg, device=dev),
                                    tx, generator=conf.seed,
                                    ema=conf.ema_decay > 0)
    state = conf.env.make(state, model=UNet, device=device)
    step = utils.make_step(make_loss_fn(conf, cfg, sched, mesh), tx,
                           compute_dtype=conf.env.compute_dtype(),
                           ema_decay=conf.ema_decay or None, mesh=mesh,
                           rules=UNet.SHARDING_RULES)
    save_cb, start_epoch = None, 0
    if conf.save_every:
        # the EMA shadow rides in the state, so resumed sampling stays
        # smoothed
        save_cb = SaveCallback(conf.save_every, conf.epochs,
                               root=conf.checkpoint_root,
                               sharded=mesh.distributed)
        if save_cb.restore(like={"state": state}) is not None:
            start_epoch = state.step // max(len(loader), 1)
            if dist.is_primary():
                print(f"resumed at epoch {start_epoch}", flush=True)
    return Trainer(conf=conf, cfg=cfg, sched=sched, device=dev, state=state,
                   step=step, loader=loader, mesh=mesh, save_cb=save_cb,
                   start_epoch=start_epoch)


def run(t: Trainer) -> dict:
    """Train from ``t.start_epoch`` to ``epochs``, checkpointing every
    ``save_every`` epochs, then sample (:func:`sample`) when
    ``n_samples``. Returns the last epoch's record (``epoch``, ``loss``,
    ``train_steps``, ``train_s`` the wall time of its loop, ended by
    reading its metrics) plus ``losses`` (every step's, in order) and
    ``samples`` (the file written)."""
    conf = t.conf
    results: dict = {}
    losses: list = []
    for epoch in range(t.start_epoch, conf.epochs):
        metrics = MetricsAccumulator()
        t0 = time.perf_counter()
        n = 0
        for batch in t.loader:
            t.state, step_metrics = t.step(t.state,
                                           to_device(batch, t.device))
            metrics.update(step_metrics)
            losses.append(step_metrics["loss"])
            n += 1
        results = {"epoch": epoch, **metrics.compute(), "train_steps": n,
                   "train_s": time.perf_counter() - t0}
        if dist.is_primary():
            print({k: round(v, 4) if isinstance(v, float) else v
                   for k, v in results.items()}, flush=True)
        if t.save_cb is not None and (epoch + 1) % conf.save_every == 0:
            t.save_cb.save(epoch + 1, state=t.state)
    if t.save_cb is not None:
        t.save_cb.wait()
    results["losses"] = torch.stack(losses).tolist() if losses else []
    if conf.n_samples:
        weights = t.sample_params()
        if dist.is_primary():
            images = sample(t, weights)
            path = Path(conf.samples_path)
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, images.cpu().numpy())
            results["samples"] = str(path)
            print(f"saved {conf.n_samples} samples to {path}", flush=True)
    return results


def sample(t: Trainer, weights: dict) -> torch.Tensor:
    """``n_samples`` images of one real batch's shape from ``weights``:
    DDIM at ``sample_steps`` steps, or the ancestral chain at 0, from a
    generator on the card seeded with ``seed``; conditional models draw
    one sample a class, cycling, through ``cfg_apply`` at ``guidance``."""
    conf, cfg = t.conf, t.cfg
    probe = to_unit(to_device(next(iter(t.loader)), t.device)[0])
    if probe.ndim == 3:
        probe = probe[..., None]
    shape = (conf.n_samples, *probe.shape[1:])
    gen = torch.Generator(t.device).manual_seed(conf.seed)
    if cfg.n_classes:
        labels = torch.arange(conf.n_samples, device=t.device) \
            % cfg.n_classes

        def denoise(p, x, steps):
            return cfg_apply(t.apply_fn, p, x, steps, labels, cfg.n_classes,
                             conf.guidance)
    else:
        denoise = t.apply_fn
    if conf.sample_steps:
        return ddim_sample(denoise, weights, shape, gen, t.sched,
                           steps=conf.sample_steps)
    return ddpm_sample(denoise, weights, shape, gen, t.sched)


def main(conf: Config, device: str | torch.device = "cuda") -> dict:
    """:func:`setup`, then :func:`run` (on every rank under
    :func:`launch_main`)."""
    return run(setup(conf, device))


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
