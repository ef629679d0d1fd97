"""Fast style-transfer nets — the port of
``torchbooster_tpu/models/stylenet.py``: :class:`StyleNet` (a 9×9 stem,
two stride-2 encoders, 5 residual bottlenecks at 128 channels, two
upsampling decoders and a 9×9 head) and :class:`AdaINDecoder` (VGG
relu4_1 features back to RGB), with the AdaIN op and the channel
statistics it matches.

The shared vocabulary: reflection-padded convs (``jnp.pad(mode=
"reflect")`` repeats no edge, which is torch's ``"reflect"``), conv →
``layers.instance_norm`` (population variance) → affine → GELU (JAX's
tanh approximation), and a nearest ×2 repeat for upsampling. Every conv
is ``F.conv2d``: no TPU kernel ran on this path in JAX."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torchbooster_tpu_torch._device import resolve_device, seeded, tree_to
from torchbooster_tpu_torch.models import layers as L
from torchbooster_tpu_torch.models.unet import upsample2 as _upsample2
from torchbooster_tpu_torch.models.vae import _gelu


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection padding of NHWC's spatial axes (the edge not
    repeated)."""
    if pad == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return y.permute(0, 2, 3, 1)


def _conv(params: dict, x: torch.Tensor, kernel: int,
          stride: int = 1) -> torch.Tensor:
    """ReflectionPad(k//2) + conv VALID."""
    return L.conv(params, _reflect_pad(x, kernel // 2), stride=stride,
                  padding="VALID")


def _conv_in(params: dict, x: torch.Tensor, kernel: int,
             stride: int = 1) -> torch.Tensor:
    """Conv + affine InstanceNorm + GELU."""
    y = _conv(params["conv"], x, kernel, stride)
    y = L.instance_norm(y)
    y = y * params["in_scale"].to(y.dtype) + params["in_bias"].to(y.dtype)
    return _gelu(y)


def _conv_in_init(gen: torch.Generator, kernel: int, cin: int, cout: int,
                  dtype: torch.dtype) -> dict:
    return {"conv": L.conv_init(gen, kernel, cin, cout, dtype=dtype),
            "in_scale": torch.ones((cout,), dtype=dtype),
            "in_bias": torch.zeros((cout,), dtype=dtype)}


def mu_std(feat: torch.Tensor, eps: float = 1e-5
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel spatial mean and std of NHWC features (population
    variance)."""
    mu = feat.mean(dim=(1, 2), keepdim=True)
    std = torch.sqrt(feat.var(dim=(1, 2), keepdim=True, correction=0) + eps)
    return mu, std


def adain(s_feat: torch.Tensor, c_feat: torch.Tensor) -> torch.Tensor:
    """Adaptive instance norm: content features re-statted to the style's
    channel statistics."""
    (s_mu, s_std), (c_mu, c_std) = mu_std(s_feat), mu_std(c_feat)
    return s_std * (c_feat - c_mu) / c_std + s_mu


# fsdp: conv kernels shard their output channels (3-wide heads
# replicate); the instance norms' scale and bias replicate
_CONV_RULES = [
    (r".*/kernel", (None, None, None, "fsdp")),
    (r".*", ()),
]


class StyleNet:
    """Hourglass transformer net: 9×9 stem → two stride-2 ConvIN encoders
    → 5 residual bottlenecks at 128 channels → two upsample decoders →
    9×9 head."""

    SHARDING_RULES = _CONV_RULES

    @staticmethod
    def init(seed: int | torch.Generator = 0,
             device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        dev = resolve_device(device)
        gen = seeded(seed)
        res = {f"res{i}": {"a": _conv_in_init(gen, 3, 128, 128, dtype),
                           "b": _conv_in_init(gen, 3, 128, 128, dtype)}
               for i in range(5)}
        return tree_to({
            "stem": _conv_in_init(gen, 9, 3, 32, dtype),
            "down1": _conv_in_init(gen, 3, 32, 64, dtype),
            "down2": _conv_in_init(gen, 3, 64, 128, dtype),
            **res,
            "up1": _conv_in_init(gen, 3, 128, 64, dtype),
            "up2": _conv_in_init(gen, 3, 64, 32, dtype),
            "head": L.conv_init(gen, 9, 32, 3, dtype=dtype),
        }, dev)

    @staticmethod
    def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
        x = _conv_in(params["stem"], x, 9)
        x = _conv_in(params["down1"], x, 3, stride=2)
        x = _conv_in(params["down2"], x, 3, stride=2)
        for i in range(5):
            res = params[f"res{i}"]
            y = _conv_in(res["a"], x, 3)
            y = _conv_in(res["b"], y, 3)
            x = x + y
        x = _conv_in(params["up1"], _upsample2(x), 3)
        x = _conv_in(params["up2"], _upsample2(x), 3)
        return _conv(params["head"], x, 9)


class AdaINDecoder:
    """Decoder from VGG relu4_1 features back to RGB: 512→256 → up →
    256×2 → 128 → up → 128 → 64 → up → 64 → 3 with a 9×9 head."""

    SHARDING_RULES = _CONV_RULES

    @staticmethod
    def init(seed: int | torch.Generator = 0,
             device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        dev = resolve_device(device)
        gen = seeded(seed)
        return tree_to({
            "c1": _conv_in_init(gen, 3, 512, 256, dtype),
            "u1": _conv_in_init(gen, 3, 256, 256, dtype),
            "c2": _conv_in_init(gen, 3, 256, 256, dtype),
            "c3": _conv_in_init(gen, 3, 256, 128, dtype),
            "u2": _conv_in_init(gen, 3, 128, 128, dtype),
            "c4": _conv_in_init(gen, 3, 128, 64, dtype),
            "u3": _conv_in_init(gen, 3, 64, 64, dtype),
            "head": L.conv_init(gen, 9, 64, 3, dtype=dtype),
        }, dev)

    @staticmethod
    def apply(params: dict, feat: torch.Tensor) -> torch.Tensor:
        x = _conv_in(params["c1"], feat, 3)
        x = _conv_in(params["u1"], _upsample2(x), 3)
        x = _conv_in(params["c2"], x, 3)
        x = _conv_in(params["c3"], x, 3)
        x = _conv_in(params["u2"], _upsample2(x), 3)
        x = _conv_in(params["c4"], x, 3)
        x = _conv_in(params["u3"], _upsample2(x), 3)
        return _conv(params["head"], x, 9)


__all__ = ["AdaINDecoder", "StyleNet", "adain", "mu_std"]
