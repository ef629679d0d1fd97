"""Fast neural style transfer: StyleNet trained online — the port of the
JAX recipe ``examples/img_stt/online/online.py``, driven by the same
YAML:

    python -m torchbooster_tpu_torch.recipes.online [config.yml]

(``examples/img_stt/online/online.yml`` by default, read in place), which
runs :func:`main` under ``distributed.launch`` (:func:`launch_main`). A
user dataset config (:class:`CocoDatasetConfig`, resolved from the YAML
by its annotation) reads a record store under ``root``, else a folder of
images, else deterministic procedural images; iteration-count training
through ``utils.iter_loader``; a frozen VGG-16 critic (its parameters are
never in the train state; random where ``load_torch_features`` finds no
torchvision ``nn.Sequential``); a preview saved every ``sample_every``
steps. Every conv is ``F.conv2d``: no TPU kernel ran on this path in
JAX."""
from __future__ import annotations

import logging
import sys
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
from torchbooster_tpu_torch.data import resolve_dataset
from torchbooster_tpu_torch.data.sources import ProceduralImages
from torchbooster_tpu_torch.dataset import Split
from torchbooster_tpu_torch.metrics import MetricsAccumulator
from torchbooster_tpu_torch.models import StyleNet, VGGFeatures
from torchbooster_tpu_torch.models.vgg import gram_matrix, total_variation
from torchbooster_tpu_torch.recipes.offline import load_image, random_vgg
from torchbooster_tpu_torch.parallel.sharding import full_tree
from torchbooster_tpu_torch.recipes.vae import images_to_device

DEFAULT_YAML = Path(__file__).resolve().parents[2] / "examples" / "img_stt" \
    / "online" / "online.yml"


def folder_or_store(conf: DatasetConfig, split: Split, **kwargs) -> Any:
    """A record store under ``conf.root``, else a folder of images there
    (pixels only, resized to ``conf.image_size``); None when neither."""
    import operator

    from torchbooster_tpu_torch.data.folder import ImageFolder
    from torchbooster_tpu_torch.data.sources import StoreDataset
    from torchbooster_tpu_torch.dataset import TransformDataset

    if StoreDataset.store_path(conf.root, split).exists():
        return resolve_dataset(conf, split, **kwargs)
    try:
        folder = ImageFolder(conf.root, split, size=conf.image_size)
    except FileNotFoundError:
        return None
    logging.info("resolved %d real images under %r for %s (image folder)",
                 len(folder), conf.root, split.value)
    return TransformDataset(folder, operator.itemgetter(0))


@dataclass
class CocoDatasetConfig(DatasetConfig):
    """COCO content photos: a local record store, a folder of images, or
    (offline) procedural images."""

    image_size: int = 256
    n_images: int = 2_048

    def make(self, split: Split, **kwargs):
        found = folder_or_store(self, split, **kwargs)
        if found is not None:
            return found
        logging.warning(
            "no COCO store or image folder under %r (offline?); using "
            "procedural images", self.root)
        return ProceduralImages(self.n_images, self.image_size,
                                seed={"train": 0, "validation": 1,
                                      "test": 2}[split.value])


@dataclass
class Config(BaseConfig):
    n_iter: int
    seed: int
    style_path: str
    content_layers: list(int)
    style_layers: list(int)
    content_weight: float
    style_weight: float
    tv_weight: float
    sample_every: int
    samples_path: str

    env: EnvConfig
    loader: LoaderConfig
    optim: OptimizerConfig
    scheduler: SchedulerConfig
    dataset: CocoDatasetConfig


def main(conf: Config, device: str | torch.device = "cuda") -> dict:
    """``n_iter`` steps; every ``sample_every`` a record of the metrics
    since the last and a preview on the primary rank. Returns the last
    record plus ``losses`` (every step's)."""
    generator = utils.seed(conf.seed)
    dev = conf.env.device(device)
    mesh = dist.get_mesh(conf.env, device=device)
    loader = conf.loader.make(conf.dataset.make(Split.TRAIN), shuffle=True,
                              distributed=conf.env.distributed,
                              seed=conf.seed)
    # frozen critic: the VGG-16 params never enter the train state
    vgg = random_vgg(generator, 16, conf.env, device)
    style = torch.as_tensor(load_image(conf.style_path,
                                       conf.dataset.image_size,
                                       conf.seed))[None].to(dev)
    taps = sorted(set(conf.content_layers) | set(conf.style_layers))
    by_tap = dict(zip(taps, range(len(taps))))
    with torch.no_grad():
        style_feats = VGGFeatures.apply(vgg, VGGFeatures.normalize(style),
                                        taps=taps)
    style_targets = [gram_matrix(style_feats[by_tap[i]])
                     for i in conf.style_layers]

    def loss_fn(params, batch, generator):
        del generator
        x = batch
        out = torch.sigmoid(StyleNet.apply(params, x))
        x_feats = VGGFeatures.apply(vgg, VGGFeatures.normalize(x), taps=taps)
        o_feats = VGGFeatures.apply(vgg, VGGFeatures.normalize(out),
                                    taps=taps)
        c_loss = sum(torch.mean(torch.square(o_feats[by_tap[i]]
                                             - x_feats[by_tap[i]]))
                     for i in conf.content_layers)
        s_loss = sum(torch.mean(torch.square(gram_matrix(o_feats[by_tap[i]])
                                             - t))
                     for i, t in zip(conf.style_layers, style_targets))
        tv = total_variation(out) / out.numel()
        loss = (conf.content_weight * c_loss + conf.style_weight * s_loss
                + conf.tv_weight * tv)
        return loss, {"content": c_loss, "style": s_loss}

    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    state = utils.TrainState.create(StyleNet.init(generator, device=dev), tx)
    state = conf.env.make(state, model=StyleNet, device=device)
    step = utils.make_step(loss_fn, tx,
                           compute_dtype=conf.env.compute_dtype(),
                           mesh=mesh, rules=StyleNet.SHARDING_RULES)
    samples_dir = Path(conf.samples_path)
    metrics = MetricsAccumulator()
    results: dict = {}
    losses = []
    batches = utils.iter_loader(loader)
    for it in range(conf.n_iter):
        epoch, batch = next(batches)
        batch = images_to_device(batch, dev)
        state, step_metrics = step(state, batch)
        metrics.update(step_metrics)
        losses.append(step_metrics["loss"])
        if conf.sample_every and (it + 1) % conf.sample_every == 0:
            results = {"iter": it + 1, "epoch": epoch, **metrics.compute()}
            metrics.reset()
            params = full_tree(state.params, mesh)
            if dist.is_primary():
                # periodic visual sampling
                with torch.no_grad():
                    preview = torch.sigmoid(StyleNet.apply(params,
                                                           batch[:1]))
                samples_dir.mkdir(parents=True, exist_ok=True)
                np.save(samples_dir / f"styled_{it + 1:06d}.npy",
                        preview.float().cpu().numpy())
                print({k: round(v, 4) if isinstance(v, float) else v
                       for k, v in results.items()}, flush=True)
    results["losses"] = torch.stack(losses).tolist() if losses else []
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
