"""AdaIN arbitrary style transfer — the port of the JAX recipe
``examples/img_stt/adain/adain.py``, driven by the same YAML:

    python -m torchbooster_tpu_torch.recipes.adain [config.yml]

(``examples/img_stt/adain/adain.yml`` by default, read in place), which
runs :func:`main` under ``distributed.launch`` (:func:`launch_main`).
Two dataset configs (content photos and a paintings style corpus, each a
record store, a folder of images or procedural images) and two loaders
zipped through ``utils.iter_loader``; the AdaIN op re-statting content
features to the style's channel statistics; a decoder trained from the
frozen VGG-19's relu4_1 features with a content loss and a style loss
matching channel means and stds. The VGG is random where
``load_torch_features`` finds no torchvision ``nn.Sequential``. Every
conv is ``F.conv2d``: no TPU kernel ran on this path in JAX."""
from __future__ import annotations

import logging
import sys
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any

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
from torchbooster_tpu_torch.data.sources import ProceduralImages
from torchbooster_tpu_torch.dataset import Split
from torchbooster_tpu_torch.metrics import MetricsAccumulator
from torchbooster_tpu_torch.models import VGGFeatures
from torchbooster_tpu_torch.models.stylenet import AdaINDecoder, adain, mu_std
from torchbooster_tpu_torch.ops.losses import mse_loss
from torchbooster_tpu_torch.recipes.offline import random_vgg
from torchbooster_tpu_torch.parallel.sharding import full_tree
from torchbooster_tpu_torch.recipes.online import folder_or_store
from torchbooster_tpu_torch.recipes.vae import images_to_device

DEFAULT_YAML = Path(__file__).resolve().parents[2] / "examples" / "img_stt" \
    / "adain" / "adain.yml"
RELU4_1 = 20                      # torchvision vgg19.features slot


@dataclass
class ContentDatasetConfig(DatasetConfig):
    """Content photos: a record store, a folder of images, or (offline)
    procedural images seeded by the config's name."""

    image_size: int = 256
    n_images: int = 2_048
    palette: float = 0.0

    def make(self, split: Split, **kwargs):
        found = folder_or_store(self, split, **kwargs)
        if found is not None:
            return found
        logging.warning("no %r store or image folder (offline?); "
                        "procedural images", self.name)
        return ProceduralImages(self.n_images, self.image_size,
                                seed=zlib.crc32(self.name.encode()) % 1_000,
                                palette=self.palette)


@dataclass
class PaintingsDatasetConfig(ContentDatasetConfig):
    """The paintings style corpus: the same resolution, a skewed palette
    by default."""

    palette: float = 0.5


@dataclass
class Config(BaseConfig):
    n_iter: int
    seed: int
    style_weight: float
    sample_every: int
    samples_path: str

    env: EnvConfig
    loader: LoaderConfig
    optim: OptimizerConfig
    scheduler: SchedulerConfig
    content: ContentDatasetConfig
    style: PaintingsDatasetConfig


def main(conf: Config, device: str | torch.device = "cuda") -> dict:
    """``n_iter`` steps over content and style batches in pairs; every
    ``sample_every`` a record of the metrics since the last; then a
    stylized preview saved on the primary rank. Returns the last record
    plus ``losses`` (every step's)."""
    generator = utils.seed(conf.seed)
    dev = conf.env.device(device)
    mesh = dist.get_mesh(conf.env, device=device)
    content_loader = conf.loader.make(conf.content.make(Split.TRAIN),
                                      shuffle=True,
                                      distributed=conf.env.distributed,
                                      seed=conf.seed)
    style_loader = conf.loader.make(conf.style.make(Split.TRAIN),
                                    shuffle=True,
                                    distributed=conf.env.distributed,
                                    seed=conf.seed + 1)
    vgg = random_vgg(generator, 19, conf.env, device)
    style_taps = [1, 6, 11, RELU4_1]            # relu1_1 … relu4_1

    def encode(x, taps):
        return VGGFeatures.apply(vgg, VGGFeatures.normalize(x), taps=taps)

    def loss_fn(params, batch, generator):
        del generator
        content_imgs, style_imgs = batch
        c_feat = encode(content_imgs, [RELU4_1])[0]
        s_feats = encode(style_imgs, style_taps)
        target = adain(s_feats[-1], c_feat)
        out = torch.sigmoid(AdaINDecoder.apply(params, target))
        o_feats = encode(out, style_taps)
        c_loss = mse_loss(o_feats[-1], target)
        s_loss = 0.0
        for o, s in zip(o_feats, s_feats):
            (o_mu, o_std), (s_mu, s_std) = mu_std(o), mu_std(s)
            s_loss = s_loss + mse_loss(o_mu, s_mu) + mse_loss(o_std, s_std)
        return c_loss + conf.style_weight * s_loss, {
            "content": c_loss, "style": s_loss}

    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    state = utils.TrainState.create(AdaINDecoder.init(generator, device=dev),
                                    tx)
    state = conf.env.make(state, model=AdaINDecoder, device=device)
    step = utils.make_step(loss_fn, tx,
                           compute_dtype=conf.env.compute_dtype(),
                           mesh=mesh, rules=AdaINDecoder.SHARDING_RULES)
    samples_dir = Path(conf.samples_path)
    metrics = MetricsAccumulator()
    results: dict = {}
    losses = []
    # two loaders zipped through one endless iterator
    pairs = zip(utils.iter_loader(content_loader),
                utils.iter_loader(style_loader))
    for it in range(conf.n_iter):
        (epoch, content_batch), (_, style_batch) = next(pairs)
        batch = (images_to_device(content_batch, dev),
                 images_to_device(style_batch, dev))
        state, step_metrics = step(state, batch)
        metrics.update(step_metrics)
        losses.append(step_metrics["loss"])
        if conf.sample_every and (it + 1) % conf.sample_every == 0:
            results = {"iter": it + 1, "epoch": epoch, **metrics.compute()}
            metrics.reset()
            if dist.is_primary():
                print({k: round(v, 4) if isinstance(v, float) else v
                       for k, v in results.items()}, flush=True)
    results["losses"] = torch.stack(losses).tolist() if losses else []
    params = full_tree(state.params, mesh)
    if dist.is_primary():
        # the final stylization preview
        (_, content_batch), (_, style_batch) = next(pairs)
        c = images_to_device(content_batch[:1], dev)
        s = images_to_device(style_batch[:1], dev)
        with torch.no_grad():
            out = torch.sigmoid(AdaINDecoder.apply(
                params, adain(encode(s, [RELU4_1])[0],
                              encode(c, [RELU4_1])[0])))
        samples_dir.mkdir(parents=True, exist_ok=True)
        path = samples_dir / "adain_final.npy"
        np.save(path, out.float().cpu().numpy())
        results["samples"] = str(path)
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
