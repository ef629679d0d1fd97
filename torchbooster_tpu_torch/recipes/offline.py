"""Gatys-style offline style transfer — the port of the JAX recipe
``examples/img_stt/offline/offline.py``, driven by the same YAML:

    python -m torchbooster_tpu_torch.recipes.offline [config.yml]

(``examples/img_stt/offline/offline.yml`` by default, read in place).
The recipe optimizes a tensor, not a module: the image's logits, under
VGG-19 content activations and style grams plus total variation. As in
the JAX recipe there is no loader, no scheduler and no launch: it runs
:func:`main` in this process. Local image files are read where the
configured paths exist (``.npy``, or any format PIL reads), else
deterministic procedural images (``data.sources.procedural_image``).
The VGG weights: ``load_torch_features`` needs a torchvision
``nn.Sequential`` and raises without one, and the recipe goes on with
the random VGG, a valid critic, as the JAX recipe does offline. Every
conv is ``F.conv2d``: no TPU kernel ran on this path in JAX."""
from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.config import (
    BaseConfig,
    EnvConfig,
    OptimizerConfig,
)
from torchbooster_tpu_torch.models import VGGFeatures
from torchbooster_tpu_torch.models.vgg import gram_matrix, total_variation

DEFAULT_YAML = Path(__file__).resolve().parents[2] / "examples" / "img_stt" \
    / "offline" / "offline.yml"


@dataclass
class Config(BaseConfig):
    """A scalar where a list is annotated (``content_layers: 29``)
    coerces to a one-element list."""

    n_iter: int
    seed: int
    image_size: int
    content_path: str
    style_path: str
    content_layers: list(int)
    style_layers: list(int)
    content_weight: float
    style_weight: float
    tv_weight: float
    output_path: str

    env: EnvConfig
    optim: OptimizerConfig


def load_image(path: str, size: int, seed: int) -> np.ndarray:
    """A local image file → [0, 1] HWC float array; a procedural image
    (a smooth random colour field) when the file is absent."""
    file = Path(path)
    if file.exists():
        if file.suffix == ".npy":
            image = np.load(file).astype(np.float32)
        else:
            from PIL import Image

            image = np.asarray(
                Image.open(file).convert("RGB").resize((size, size)),
                np.float32) / 255.0
        return image[:size, :size]
    from torchbooster_tpu_torch.data.sources import procedural_image

    return procedural_image(size, seed)


def random_vgg(generator: torch.Generator, depth: int, env: EnvConfig,
               device: str | torch.device) -> dict:
    """VGG features of ``depth``, the torchvision weights where
    ``load_torch_features`` finds them (it needs an ``nn.Sequential``
    and raises without one: the random VGG stays, a valid critic), whole
    on every rank of ``env``'s mesh, rank 0's. The JAX recipes lay the
    critic out by ``VGGFeatures.SHARDING_RULES`` and XLA gathers it where
    it is used; here ``make_step`` gathers only the train state's leaves,
    and the frozen critic is not in the state."""
    from torchbooster_tpu_torch import distributed as dist
    from torchbooster_tpu_torch.models.vgg import load_torch_features

    vgg = VGGFeatures.init(generator, depth=depth,
                           device=env.device(device))
    try:
        vgg = load_torch_features(vgg)
    except Exception:   # offline: a random VGG still defines a critic
        pass
    return dist.to_env(vgg, dist.get_mesh(env, device=device))


def main(conf: Config, device: str | torch.device = "cuda") -> dict:
    """``n_iter`` steps of the configured optimizer on the image's logits,
    the result saved to ``output_path``. Returns the last step's
    ``{"loss", "content", "style", "tv"}`` plus ``losses`` (every
    step's)."""
    generator = utils.seed(conf.seed)
    dev = conf.env.device(device)
    content = torch.as_tensor(load_image(conf.content_path, conf.image_size,
                                         conf.seed))[None].to(dev)
    style = torch.as_tensor(load_image(conf.style_path, conf.image_size,
                                       conf.seed + 1))[None].to(dev)
    vgg = random_vgg(generator, 19, conf.env, device)

    # fixed targets: content activations and style grams
    taps = sorted(set(conf.content_layers) | set(conf.style_layers))
    by_tap = dict(zip(taps, range(len(taps))))
    with torch.no_grad():
        content_feats = VGGFeatures.apply(vgg, VGGFeatures.normalize(content),
                                          taps=taps)
        style_feats = VGGFeatures.apply(vgg, VGGFeatures.normalize(style),
                                        taps=taps)
    content_targets = [content_feats[by_tap[i]] for i in conf.content_layers]
    style_targets = [gram_matrix(style_feats[by_tap[i]])
                     for i in conf.style_layers]

    def loss_fn(params, batch, generator):
        del batch, generator
        pixels = torch.sigmoid(params["logits"])   # keep pixels in [0,1]
        feats = VGGFeatures.apply(vgg, VGGFeatures.normalize(pixels),
                                  taps=taps)
        c_loss = sum(torch.mean(torch.square(feats[by_tap[i]] - t))
                     for i, t in zip(conf.content_layers, content_targets))
        s_loss = sum(torch.mean(torch.square(gram_matrix(feats[by_tap[i]])
                                             - t))
                     for i, t in zip(conf.style_layers, style_targets))
        tv = total_variation(pixels) / pixels.numel()
        loss = (conf.content_weight * c_loss + conf.style_weight * s_loss
                + conf.tv_weight * tv)
        return loss, {"content": c_loss, "style": s_loss, "tv": tv}

    # the optimized "model" is the image itself, parameterized through a
    # logit so that the pixel range stays valid
    eps = 1e-4
    params = {"logits": torch.log(torch.clip(content, eps, 1 - eps)
                                  / torch.clip(1 - content, eps, 1 - eps))}
    tx = conf.optim.make()
    state = utils.TrainState.create(params, tx)
    step = utils.make_step(loss_fn, tx,
                           compute_dtype=conf.env.compute_dtype())
    metrics: dict = {}
    losses = []
    for _ in range(conf.n_iter):
        state, metrics = step(state, None)
        losses.append(metrics["loss"])
    result = torch.sigmoid(state.params["logits"].detach())[0]
    out = Path(conf.output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.save(out, result.float().cpu().numpy())
    final = {k: float(v) for k, v in metrics.items()}
    print({"output": str(out), **{k: round(v, 6) for k, v in final.items()}},
          flush=True)
    return {**final,
            "losses": torch.stack(losses).tolist() if losses else []}


if __name__ == "__main__":
    # no launch: pixel optimization runs on one device
    utils.boost()
    main(Config.load(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_YAML))
