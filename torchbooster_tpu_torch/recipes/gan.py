"""Hinge-loss GAN with a gradient penalty on MNIST — the port of the JAX
recipe ``examples/img_gen/gan/gan.py``, driven by the same YAML:

    python -m torchbooster_tpu_torch.recipes.gan [config.yml]

(``examples/img_gen/gan/gan.yml`` by default, read in place), which runs
:func:`main` under ``distributed.launch`` (:func:`launch_main`). Two
models, two optimizers and two cycle schedules: two ``TrainState``s, each
with its own generator. One step (:func:`make_gan_step`) updates D on
the hinge loss + ``gp_weight`` × the penalty (a double backward) with
``x_fake`` detached, then updates G against the updated D; D's
parameters collect no gradient from G's loss.

JAX's step never casts to ``env.compute_dtype()``: the GAN trains in fp32
even under ``precision: bf16``, and so does the port. No TPU kernel ran
on this path in JAX: the products are cuBLAS.

Across ranks each player's step is a ``utils.make_step`` over its own
state, laid out by ``GAN.SHARDING_RULES``; the other player's parameters
enter the loss gathered whole and detached."""
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
from torchbooster_tpu_torch.models import GAN
from torchbooster_tpu_torch.models.gan import (
    _grad_penalty_core,
    hinge_d_loss,
    hinge_g_loss,
)
from torchbooster_tpu_torch.parallel.sharding import full_tree
from torchbooster_tpu_torch.recipes.vae import (
    images_to_device,
    to_unit,
    unpack,
)

DEFAULT_YAML = Path(__file__).resolve().parents[2] / "examples" / "img_gen" \
    / "gan" / "gan.yml"


@dataclass
class Config(BaseConfig):
    epochs: int
    seed: int
    z_dim: int
    gp_weight: float
    n_samples: int
    samples_path: str

    env: EnvConfig
    loader: LoaderConfig
    g_optim: OptimizerConfig
    d_optim: OptimizerConfig
    g_scheduler: SchedulerConfig
    d_scheduler: SchedulerConfig
    dataset: DatasetConfig


def _real(batch: Any) -> torch.Tensor:
    x_real = to_unit(unpack(batch))
    return x_real[..., None] if x_real.ndim == 3 else x_real


def _d_draws(conf: Config, generator: torch.Generator, n: int,
             mesh: Any) -> tuple[torch.Tensor, torch.Tensor]:
    """D's draws for this rank's ``n`` rows, in order: the latents of the
    fakes and the penalty's α (B, 1, 1, 1), both made for the global
    batch and cut by rank (``distributed.global_draw``)."""
    def draw(m: int):
        z = torch.randn((m, conf.z_dim), generator=generator,
                        device=generator.device)
        alpha = torch.rand((m, 1, 1, 1), generator=generator,
                           device=generator.device)
        return z, alpha

    return dist.global_draw(draw, n, mesh)


def _g_draws(conf: Config, generator: torch.Generator, n: int,
             mesh: Any) -> torch.Tensor:
    """G's latents for this rank's ``n`` rows, as :func:`_d_draws`."""
    return dist.global_draw(
        lambda m: torch.randn((m, conf.z_dim), generator=generator,
                              device=generator.device), n, mesh)


def make_gan_step(conf: Config, g_tx: Any, d_tx: Any, mesh: Any = None
                  ) -> Callable:
    """``step(g_state, d_state, batch) -> (g_state, d_state, {"d_loss",
    "g_loss", "gp"})``: D's update on hinge + ``gp_weight`` × penalty
    (z and the penalty's α from D's generator), then G's against the
    updated D (z from G's generator). Each update is a ``make_step`` of
    its own state, in fp32; ``mesh`` (a distributed one) gathers the
    other player's sharded parameters for the loss, and the draws span
    the global batch, each rank keeping its rows."""
    held: dict = {}

    def d_loss_fn(d_params: dict, batch: Any, generator: torch.Generator):
        x_real = _real(batch)
        z, alpha = _d_draws(conf, generator, x_real.shape[0], mesh)
        with torch.no_grad():
            x_fake = GAN.generate(held["G"], z.to(x_real.device))
        loss = hinge_d_loss(d_params, x_real, x_fake)
        gp = _grad_penalty_core(d_params, x_real, x_fake,
                                alpha.to(x_real.device))
        return loss + conf.gp_weight * gp, {"d_loss": loss.detach(),
                                            "gp": gp.detach()}

    def g_loss_fn(g_params: dict, batch: Any, generator: torch.Generator):
        z = _g_draws(conf, generator, batch.shape[0], mesh)
        return hinge_g_loss(held["D"],
                            GAN.generate(g_params, z.to(batch.device))), {}

    rules = GAN.SHARDING_RULES if mesh is not None else None
    d_step = utils.make_step(d_loss_fn, d_tx, mesh=mesh, rules=rules)
    g_step = utils.make_step(g_loss_fn, g_tx, mesh=mesh, rules=rules)

    def step_fn(g_state: utils.TrainState, d_state: utils.TrainState,
                batch: Any):
        held["G"] = utils.detach(full_tree(g_state.params, mesh))
        d_state, d_metrics = d_step(d_state, batch)
        held["D"] = utils.detach(full_tree(d_state.params, mesh))
        g_state, g_metrics = g_step(g_state, batch)
        held.clear()
        return g_state, d_state, {"d_loss": d_metrics["d_loss"],
                                  "g_loss": g_metrics["loss"],
                                  "gp": d_metrics["gp"]}

    return step_fn


def main(conf: Config, device: str | torch.device = "cuda") -> dict:
    """Train ``epochs`` epochs, then save ``n_samples`` generated images
    on the primary rank. Returns the last epoch's ``{"epoch", "d_loss",
    "g_loss", "gp", "train_s"}`` (``train_s`` the wall time of its loop) plus ``steps`` (every step's three metrics)."""
    generator = utils.seed(conf.seed)
    dev = conf.env.device(device)
    mesh = dist.get_mesh(conf.env, device=device)
    loader = conf.loader.make(conf.dataset.make(Split.TRAIN), shuffle=True,
                              distributed=conf.env.distributed,
                              seed=conf.seed)
    params = GAN.init(generator, z_dim=conf.z_dim, device=dev)
    g_tx = conf.g_optim.make(conf.g_scheduler.make(conf.g_optim))
    d_tx = conf.d_optim.make(conf.d_scheduler.make(conf.d_optim))
    g_state, d_state = (
        conf.env.make(utils.TrainState.create(params[k], tx,
                                              generator=conf.seed + i),
                      model=GAN, device=device)
        for i, (k, tx) in enumerate((("G", g_tx), ("D", d_tx))))
    gan_step = make_gan_step(conf, g_tx, d_tx,
                             mesh if mesh.distributed else None)
    results: dict = {}
    steps: list = []
    for epoch in range(conf.epochs):
        metrics = MetricsAccumulator()
        t0 = time.perf_counter()
        for batch in loader:
            g_state, d_state, step_metrics = gan_step(
                g_state, d_state, images_to_device(batch, dev))
            metrics.update(step_metrics)
            steps.append(step_metrics)
        results = {"epoch": epoch, **metrics.compute(),
                   "train_s": time.perf_counter() - t0}
        if dist.is_primary():
            print({k: round(v, 4) if isinstance(v, float) else v
                   for k, v in results.items()}, flush=True)
    results["steps"] = [{k: float(v) for k, v in m.items()} for m in steps]
    g_params = full_tree(g_state.params, mesh)
    if dist.is_primary():
        gen = torch.Generator(dev).manual_seed(conf.seed)
        z = torch.randn((conf.n_samples, conf.z_dim), generator=gen,
                        device=dev)
        with torch.no_grad():
            images = GAN.generate(g_params, z).cpu().numpy()
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
