"""VGG-16/19 feature extractor with explicit taps — the port of
``torchbooster_tpu/models/vgg.py``. ``apply(params, x, taps=[...])``
returns the activations after the requested slots, numbered as in
torchvision's ``vgg.features`` Sequential (each conv, ReLU and max-pool
counts one slot), so style layers such as ``[1, 6, 11, 20]`` carry over.

Torchvision-layout weights are imported with :func:`load_torch_features`
from an ``nn.Sequential`` the caller passes; the port never downloads
(there is no network on the machines it runs on, and no torchvision).
Without imported weights the extractor works as a random-feature critic.
The convolutions are plain ``F.conv2d`` (no TPU kernel ran here)."""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from torchbooster_tpu_torch._device import resolve_device, seeded, tree_to
from torchbooster_tpu_torch.models import layers as L

# torchvision cfgs: numbers = conv output channels, "M" = max pool
_CFGS = {
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _plan(depth: int) -> list[tuple[str, Any]]:
    """A cfg as torchvision's slot list: conv → relu → … → maxpool."""
    plan: list[tuple[str, Any]] = []
    cin = 3
    for entry in _CFGS[depth]:
        if entry == "M":
            plan.append(("pool", None))
        else:
            plan.append(("conv", (cin, int(entry))))
            plan.append(("relu", None))
            cin = int(entry)
    return plan


class VGGFeatures:
    """``init(seed, depth=19, device)`` → params; ``apply(params, x,
    taps)`` → the tapped activations (the final map when ``taps`` is
    None)."""

    # fsdp: conv kernels shard their output channels
    SHARDING_RULES = [
        (r"conv[0-9]+/kernel", (None, None, None, "fsdp")),
        (r".*", ()),
    ]

    @staticmethod
    def init(seed: int | torch.Generator = 0, depth: int = 19,
             device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        """Fan-in uniform 3×3 kernels and zero biases drawn on the CPU from
        ``seed``, then moved to ``device``; keys ``conv{slot}``."""
        dev = resolve_device(device)
        gen = seeded(seed)
        params: dict = {}
        for slot, (kind, spec) in enumerate(_plan(depth)):
            if kind == "conv":
                conv = L.conv_init(gen, 3, *spec, dtype=dtype)
                params[f"conv{slot}"] = conv
        return tree_to(params, dev)

    @staticmethod
    def _depth_of(params: dict) -> int:
        # the depth is read back from the conv count: 13 → 16, 16 → 19
        n_convs = sum(1 for k in params if k.startswith("conv"))
        for depth, cfg in _CFGS.items():
            if sum(1 for e in cfg if e != "M") == n_convs:
                return depth
        raise ValueError(f"unrecognized VGG param tree ({n_convs} convs)")

    @staticmethod
    def apply(params: dict, x: torch.Tensor,
              taps: Sequence[int] | None = None) -> list[torch.Tensor]:
        """NHWC ``x`` through the slots up to the last tap; the
        activations after each tapped slot, in slot order."""
        plan = _plan(VGGFeatures._depth_of(params))
        taps = sorted(set(taps)) if taps is not None else []
        last = max(taps) if taps else len(plan) - 1
        out: list[torch.Tensor] = []
        for slot, (kind, _) in enumerate(plan):
            if slot > last:
                break
            if kind == "conv":
                x = L.conv(params[f"conv{slot}"], x)
            elif kind == "relu":
                x = torch.relu(x)
            else:
                x = L.max_pool(x, 2)
            if slot in taps:
                out.append(x)
        if not taps:
            out.append(x)
        return out

    @staticmethod
    def normalize(x: torch.Tensor) -> torch.Tensor:
        """ImageNet-normalize NHWC images in [0, 1]."""
        mean = torch.as_tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.as_tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
        return (x - mean) / std


def load_torch_features(params: dict, features: Any = None) -> dict:
    """Torch VGG feature weights (OIHW conv weights) → ``params`` (HWIO
    kernels), on the device of ``params``. ``features`` is an
    ``nn.Sequential`` in torchvision's VGG layout (Conv2d, ReLU, MaxPool2d
    by slot). The JAX package downloads torchvision's weights when it is
    omitted; the port does not: it raises."""
    if features is None:
        raise ValueError(
            "load_torch_features needs features=: an nn.Sequential in "
            "torchvision's VGG layout (e.g. torchvision's "
            "vgg19(weights=...).features, built where torchvision and its "
            "weights are); the port downloads nothing")
    device = next(iter(params.values()))["kernel"].device
    out = dict(params)
    with torch.no_grad():
        for slot, module in enumerate(features):
            if module.__class__.__name__ == "Conv2d":
                w = module.weight.detach().float().permute(2, 3, 1, 0)
                out[f"conv{slot}"] = {
                    "kernel": w.contiguous().to(device),
                    "bias": module.bias.detach().float().to(device)}
    return out


def gram_matrix(features: torch.Tensor) -> torch.Tensor:
    """Per-sample gram of NHWC features over ``b·c·h·w``."""
    b, h, w, c = features.shape
    flat = features.reshape(b, h * w, c)
    return torch.einsum("bpc,bpd->bcd", flat, flat) / (b * c * h * w)


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic total variation over NHWC."""
    a = (x[:, :, :-1, :] - x[:, :, 1:, :]).abs().sum()
    b = (x[:, :-1, :, :] - x[:, 1:, :, :]).abs().sum()
    return a + b


__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "VGGFeatures", "gram_matrix",
           "load_torch_features", "total_variation"]
