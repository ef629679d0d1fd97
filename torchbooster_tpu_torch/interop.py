"""The numpy bridge between the JAX package's trees and the port.

The port keeps the JAX parameter layout (stacked ``blocks``, ``(in,
out)`` dense kernels, ``q | k | v`` qkv columns), so a parameter tree
crosses as a leaf-by-leaf copy: JAX → numpy (``jax.device_get``, done
by the caller) → :func:`params_from_jax` (GPT),
:func:`resnet_params_from_jax`, :func:`unet_params_from_jax`,
:func:`vae_params_from_jax`, :func:`gan_params_from_jax`,
:func:`stylenet_params_from_jax` or :func:`adain_decoder_params_from_jax`
→ :func:`to_numpy`, byte-exact.
bfloat16 leaves travel as their raw 16-bit patterns (numpy has no
native bfloat16; ``ml_dtypes`` supplies the dtype JAX hands out)."""
from __future__ import annotations

import numpy as np
import torch

from torchbooster_tpu_torch._device import resolve_device
from torchbooster_tpu_torch.models.gpt import GPTConfig, map_tensors


def tensor_from_numpy(a, device: str | torch.device = "cuda") -> torch.Tensor:
    """One numpy (or ml_dtypes bfloat16) array → tensor, byte-exact."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(resolve_device(device))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor → numpy, byte-exact; bfloat16 comes back as the
    ``ml_dtypes.bfloat16`` dtype the JAX package uses."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _shapes(cfg: GPTConfig, tree: dict) -> dict:
    """The leaves that pin ``cfg``'s widths (the MoE gate and experts
    included), in the tree's own form:
    full precision, or quantized (``models/quant.py``: a per-row int8
    ``qtable``, int8 ``qkernel``s, or int4 ones packed two a byte along
    the input axis as uint8)."""
    n, d, hd = cfg.n_layers, cfg.d_model, cfg.head_dim
    qkv = d + 2 * cfg.kv_heads * hd
    table = "qtable" if "qtable" in tree.get("wte", {}) else "table"
    kernel, din = "kernel", d
    q = tree.get("blocks", {}).get("attn_qkv", {}).get("qkernel")
    if q is not None:
        kernel = "qkernel"
        din = d // 2 if np.asarray(q).dtype == np.uint8 else d
    shapes = {("wte", table): (cfg.vocab, d),
              ("blocks", "attn_qkv", kernel): (n, din, qkv),
              ("blocks", "attn_proj", kernel): (n, din, d),
              ("ln_f", "scale"): (d,)}
    if cfg.n_experts:
        # MoE blocks (models/moe.py): the gate and the stacked experts
        e, h = cfg.n_experts, cfg.mlp_ratio * d
        shapes.update({("blocks", "moe_gate", "kernel"): (n, d, e),
                       ("blocks", "moe_fc1", "kernel"): (n, e, d, h),
                       ("blocks", "moe_fc2", "kernel"): (n, e, h, d)})
    return shapes


def params_from_jax(tree: dict, cfg: GPTConfig,
                    device: str | torch.device = "cuda") -> dict:
    """A JAX GPT parameter tree (numpy leaves) → the port's parameters,
    checked against ``cfg``'s widths so a mismatched checkpoint fails
    here instead of inside the first matmul. Quantized trees cross as
    they are: int8 as int8, packed int4 as uint8, scales as fp32."""
    for path, want in _shapes(cfg, tree).items():
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if tuple(np.shape(leaf)) != want:
            raise ValueError(f"{'/'.join(path)} has shape "
                             f"{tuple(np.shape(leaf))}, cfg wants {want}")
    return _map_leaves(tree, lambda a: tensor_from_numpy(a, device))


def _leaf_shapes(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_leaf_shapes(value, prefix + (key,)))
        return out
    return {prefix: tuple(np.shape(tree))}


def _checked(tree: dict, want: dict, what: str,
             device: str | torch.device) -> dict:
    """``tree`` as tensors on ``device`` once every leaf's path and shape
    equal ``want``'s (the port's ``init`` for the widths read from the
    tree), so that a truncated or mis-shaped checkpoint fails here."""
    got = _leaf_shapes(tree)
    want = _leaf_shapes(want)
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"{what} tree does not match the model its "
                         f"shapes imply; first differing leaves: {bad[:4]}")
    return _map_leaves(tree, lambda a: tensor_from_numpy(a, device))


def resnet_params_from_jax(tree: dict,
                           device: str | torch.device = "cuda") -> dict:
    """A JAX ResNet parameter tree (numpy leaves) → the port's
    parameters, byte-exact. The depth, stem, input channels and class
    count are read from the tree's keys and its stem and head; every leaf
    is then checked against the tree the port's ``ResNet.init`` builds
    for them, so a truncated or mis-shaped checkpoint fails here."""
    from torchbooster_tpu_torch.models.resnet import _CONFIGS, ResNet

    try:
        stages = [tree[f"stage{i}"] for i in range(4)]
        kind = "bottleneck" if "conv3" in stages[0]["block0"] else "basic"
        stem_k, _, in_ch, _ = np.shape(tree["stem"]["conv"]["kernel"])
        classes = np.shape(tree["head"]["kernel"])[1]
    except (KeyError, ValueError) as err:
        raise ValueError(f"not a ResNet parameter tree: {err!r}") from err
    repeats = tuple(len(s) for s in stages)
    depth = next((d for d, cfg in _CONFIGS.items()
                  if cfg == (kind, repeats)), None)
    if depth is None:
        raise ValueError(f"no ResNet depth has {kind} blocks {repeats}")
    want = ResNet.init(0, depth, int(classes),
                       "imagenet" if stem_k == 7 else "cifar", device="cpu",
                       in_channels=int(in_ch))
    return _checked(tree, want, f"ResNet-{depth}", device)


def _unet_config(tree: dict):
    """The ``UNetConfig`` a JAX UNet tree was built with: the levels'
    widths from the ``down{i}_a`` convs (``base`` their greatest common
    divisor), ``time_dim`` from the time MLP, ``in_channels`` from the
    stem and ``n_classes`` from the label table (less its NULL row)."""
    from math import gcd

    from torchbooster_tpu_torch.models.unet import UNetConfig

    try:
        widths = []
        while f"down{len(widths)}_a" in tree:
            kernel = tree[f"down{len(widths)}_a"]["conv1"]["kernel"]
            widths.append(int(np.shape(kernel)[-1]))
        time_dim = int(np.shape(tree["time_mlp1"]["kernel"])[0])
        in_ch = int(np.shape(tree["stem"]["kernel"])[2])
        label = tree.get("label_emb")
        n_classes = int(np.shape(label["table"])[0]) - 1 if label else 0
    except (KeyError, IndexError, TypeError) as err:
        raise ValueError(f"not a UNet parameter tree: {err!r}") from err
    if not widths:
        raise ValueError("not a UNet parameter tree: no down0_a block")
    base = 0
    for w in widths:
        base = gcd(base, w)
    return UNetConfig(in_channels=in_ch, base=base,
                      mults=tuple(w // base for w in widths),
                      time_dim=time_dim, n_classes=n_classes)


def unet_params_from_jax(tree: dict,
                         device: str | torch.device = "cuda") -> dict:
    """A JAX UNet parameter tree (numpy leaves) → the port's parameters,
    byte-exact, once every leaf matches the tree the port's ``UNet.init``
    builds for the config read from it (:func:`_unet_config`)."""
    from torchbooster_tpu_torch.models.unet import UNet

    cfg = _unet_config(tree)
    return _checked(tree, UNet.init(0, cfg, device="cpu"), "UNet", device)


def vae_params_from_jax(tree: dict,
                        device: str | torch.device = "cuda") -> dict:
    """A JAX VAE tree → the port's, checked against ``VAE.init`` at the
    z, image and hidden widths of its ``dec1`` and ``enc1`` kernels."""
    from torchbooster_tpu_torch.models.vae import VAE

    try:
        z_dim = int(np.shape(tree["dec1"]["kernel"])[0])
        image_dim, hidden = map(int, np.shape(tree["enc1"]["kernel"]))
    except (KeyError, ValueError, TypeError) as err:
        raise ValueError(f"not a VAE parameter tree: {err!r}") from err
    return _checked(tree, VAE.init(0, z_dim, image_dim, hidden,
                                   device="cpu"), "VAE", device)


def gan_params_from_jax(tree: dict,
                        device: str | torch.device = "cuda") -> dict:
    """A JAX GAN tree (``{"G", "D"}``) → the port's, checked against
    ``GAN.init`` at the widths of its ``G/fc1`` and ``D/fc1`` kernels."""
    from torchbooster_tpu_torch.models.gan import GAN

    try:
        z_dim, hidden = map(int, np.shape(tree["G"]["fc1"]["kernel"]))
        image_dim = int(np.shape(tree["D"]["fc1"]["kernel"])[0])
    except (KeyError, ValueError, TypeError) as err:
        raise ValueError(f"not a GAN parameter tree: {err!r}") from err
    return _checked(tree, GAN.init(0, z_dim, image_dim, hidden,
                                   device="cpu"), "GAN", device)


def stylenet_params_from_jax(tree: dict,
                             device: str | torch.device = "cuda") -> dict:
    """A JAX StyleNet tree → the port's, checked against
    ``StyleNet.init``."""
    from torchbooster_tpu_torch.models.stylenet import StyleNet

    return _checked(tree, StyleNet.init(0, device="cpu"), "StyleNet",
                    device)


def adain_decoder_params_from_jax(tree: dict,
                                  device: str | torch.device = "cuda"
                                  ) -> dict:
    """A JAX AdaINDecoder tree → the port's, checked against
    ``AdaINDecoder.init``."""
    from torchbooster_tpu_torch.models.stylenet import AdaINDecoder

    return _checked(tree, AdaINDecoder.init(0, device="cpu"),
                    "AdaINDecoder", device)


def pool_from_jax(pool: dict, device: str | torch.device = "cuda") -> dict:
    """A ``make_pool`` pool (``{"k", "v"}``, plain arrays or int8
    ``(values, scales)`` pairs) → tensors, byte-exact."""
    return _map_leaves(pool, lambda a: tensor_from_numpy(a, device))


def to_numpy(tree):
    """Port parameters or pools → numpy leaves (the inverse bridge)."""
    return map_tensors(tree, tensor_to_numpy)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_leaves(v, fn) for v in tree)
    return fn(tree)


__all__ = ["adain_decoder_params_from_jax", "gan_params_from_jax",
           "params_from_jax", "pool_from_jax", "resnet_params_from_jax",
           "stylenet_params_from_jax", "tensor_from_numpy",
           "tensor_to_numpy", "to_numpy", "unet_params_from_jax",
           "vae_params_from_jax"]
