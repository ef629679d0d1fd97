"""VAE on MNIST — the port of the JAX recipe
``examples/img_gen/vae/vae.py``, driven by the same YAML:

    python -m torchbooster_tpu_torch.recipes.vae [config.yml]

(``examples/img_gen/vae/vae.yml`` by default, read in place), which runs
:func:`main` under ``distributed.launch`` (:func:`launch_main`). The flow
is the JAX recipe's: the MLP VAE (``models/vae.py``) trained on
BCE-with-logits × pixels an image + ``kld_weight`` × KL through
``utils.make_step`` at the ``env.precision`` compute dtype, the
reparameterization noise drawn from the train state's generator (over
the global batch across ranks, each rank keeping its rows), then
``n_samples`` images decoded from z ~ N(0, I) on the primary rank and
saved. No TPU kernel ran on this path in JAX: the products are cuBLAS.

As in the JAX recipe, :func:`to_unit` returns fp32 pixels, so under
``precision: bf16`` the model computes in fp32 on bf16-rounded weights
(``layers.dense`` casts a kernel to its input's dtype)."""
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
from torchbooster_tpu_torch.models import VAE
from torchbooster_tpu_torch.models.vae import _apply_with, kl_divergence
from torchbooster_tpu_torch.ops.losses import bce_with_logits
from torchbooster_tpu_torch.parallel.sharding import full_tree

DEFAULT_YAML = Path(__file__).resolve().parents[2] / "examples" / "img_gen" \
    / "vae" / "vae.yml"


@dataclass
class Config(BaseConfig):
    epochs: int
    seed: int
    z_dim: int
    kld_weight: float
    n_samples: int          # images sampled after training
    samples_path: str

    env: EnvConfig
    loader: LoaderConfig
    optim: OptimizerConfig
    scheduler: SchedulerConfig
    dataset: DatasetConfig


def to_unit(images: torch.Tensor) -> torch.Tensor:
    """Pixels → [0, 1] BCE targets in fp32: integers scale, floats squash
    (the synthetic stand-in datasets are unbounded floats)."""
    if not images.is_floating_point():
        return images.float() / 255.0
    return torch.sigmoid(images.float())


def unpack(batch):
    if isinstance(batch, dict):
        return batch.get("image", batch.get("images"))
    return batch[0] if isinstance(batch, (tuple, list)) else batch


def images_to_device(batch: Any, device: torch.device) -> torch.Tensor:
    """A host batch's images as a tensor on ``device``, dtype kept."""
    images = unpack(batch)
    if not isinstance(images, torch.Tensor):
        images = torch.as_tensor(np.ascontiguousarray(images))
    return images.to(device, non_blocking=True)


def _eps(generator: torch.Generator, shape: tuple, dtype: torch.dtype,
         mesh: Any) -> torch.Tensor:
    """The reparameterization's ε ~ N(0, I) of ``shape`` for this rank's
    rows: drawn for the global batch and cut by rank
    (``distributed.global_draw``)."""
    return dist.global_draw(
        lambda n: torch.randn((n, *shape[1:]), generator=generator,
                              dtype=dtype, device=generator.device),
        shape[0], mesh)


def make_loss_fn(conf: Config, train: bool, mesh: Any = None) -> Callable:
    """``loss_fn(params, images, generator) -> (loss, {"bce", "kld"})``:
    the per-image BCE sum (the mean × pixels of an image) plus
    ``kld_weight`` × KL. On a distributed ``mesh`` the batch is this
    rank's rows of the global one, and ε is drawn for the global batch
    (:func:`_eps`)."""

    def loss_fn(params: dict, batch: Any, generator: Any):
        images = to_unit(unpack(batch))
        if images.ndim == 3:
            images = images[..., None]
        recon_logits, mu, log_var = _apply_with(
            params, images,
            (lambda shape, dtype: _eps(generator, shape, dtype, mesh))
            if train else None)
        bce = bce_with_logits(recon_logits, images) * images[0].numel()
        kld = kl_divergence(mu, log_var)
        return bce + conf.kld_weight * kld, {"bce": bce, "kld": kld}

    return loss_fn


def sample(conf: Config, params: dict,
           generator: torch.Generator) -> np.ndarray:
    """Decode ``n_samples`` fresh z ~ N(0, I) drawn from ``generator``."""
    dev = next(iter(params["dec1"].values())).device
    z = torch.randn((conf.n_samples, conf.z_dim), generator=generator,
                    device=generator.device).to(dev)
    with torch.no_grad():
        images = torch.sigmoid(VAE.decode(params, z))
    return images.float().cpu().numpy()


def main(conf: Config, device: str | torch.device = "cuda") -> dict:
    """Train ``epochs`` epochs, then sample on the primary rank. Returns
    the last epoch's ``{"epoch", "loss", "bce", "kld", "train_s"}`` (the
    wall time of its loop, ended by reading its metrics) plus ``losses``
    (every step's, in order)."""
    generator = utils.seed(conf.seed)
    dev = conf.env.device(device)
    mesh = dist.get_mesh(conf.env, device=device)
    loader = conf.loader.make(conf.dataset.make(Split.TRAIN), shuffle=True,
                              distributed=conf.env.distributed,
                              seed=conf.seed)
    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    state = utils.TrainState.create(
        VAE.init(generator, z_dim=conf.z_dim, device=dev), tx,
        generator=conf.seed)
    state = conf.env.make(state, model=VAE, device=device)
    step = utils.make_step(make_loss_fn(conf, train=True, mesh=mesh), tx,
                           compute_dtype=conf.env.compute_dtype(),
                           mesh=mesh, rules=VAE.SHARDING_RULES)
    results: dict = {}
    losses: list = []
    for epoch in range(conf.epochs):
        metrics = MetricsAccumulator()
        t0 = time.perf_counter()
        for batch in loader:
            state, step_metrics = step(state, images_to_device(batch, dev))
            metrics.update(step_metrics)
            losses.append(step_metrics["loss"])
        results = {"epoch": epoch, **metrics.compute(),
                   "train_s": time.perf_counter() - t0}
        if dist.is_primary():
            print({k: round(v, 4) if isinstance(v, float) else v
                   for k, v in results.items()}, flush=True)
    results["losses"] = torch.stack(losses).tolist() if losses else []
    params = full_tree(state.params, mesh)
    if dist.is_primary():
        images = sample(conf, params,
                        torch.Generator(dev).manual_seed(conf.seed))
        path = Path(conf.samples_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.save(path, images)
        results["samples"] = str(path)
        print(f"saved {conf.n_samples} samples to {path}", flush=True)
    return results


def launch_main(conf: Config, device: str = "cuda") -> Any:
    """:func:`main` under ``distributed.launch`` with the YAML's ``env``:
    NCCL on the card, gloo with ``device="cpu"``; one result a rank (the
    result itself at world 1 without ``distributed``)."""
    return dist.launch(main, conf.env.devices(), conf.env.n_machine,
                       conf.env.machine_rank, conf.env.dist_url,
                       args=(conf, device), distributed=conf.env.distributed,
                       device=device)


if __name__ == "__main__":
    utils.boost()
    launch_main(Config.load(sys.argv[1] if len(sys.argv) > 1
                            else DEFAULT_YAML))
