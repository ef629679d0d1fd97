"""LeNet-5 over NHWC 28×28×1 images — the port of
``torchbooster_tpu/models/lenet.py``: two conv (5×5, no padding) +
GroupNorm + GELU + 2×2 max-pool blocks, then a 256→120→84→classes GELU
MLP. The GELU is JAX's default, the tanh approximation.

The two GroupNorms (``groups=6`` over 6 channels, ``groups=16`` over 16)
go through ``layers.group_norm``, which on a CUDA tensor launches B5 and
its backward B6 (``ops/group_norm.py``): 6 channels take the
``"two_pass"`` route (``csrc/group_norm.cu``), 16 channels at bf16 the
``"one_pass"`` route (``csrc/group_norm_{fwd,bwd}_sm90.cu``), and 16 at
fp32 ``"two_pass"``. On CPU tensors they run the plain version."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torchbooster_tpu_torch._device import resolve_device, seeded, tree_to
from torchbooster_tpu_torch.models import layers as L


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default: the tanh approximation
    return F.gelu(x, approximate="tanh")


class LeNet:
    """``LeNet.init(seed, num_classes, device)`` → params;
    ``LeNet.apply(params, x)`` → logits."""

    num_classes = 10

    # fsdp: the dense kernels shard their output dim, the head its input
    # (the 6- and 16-wide conv kernels rarely divide the axis and
    # replicate)
    SHARDING_RULES = [
        (r"fc[0-9]/kernel", (None, "fsdp")),
        (r"head/kernel", ("fsdp", None)),
        (r".*", ()),
    ]

    @staticmethod
    def init(seed: int | torch.Generator = 0, num_classes: int = 10,
             device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        """Weights drawn on the CPU from ``seed`` (an int or a
        ``torch.Generator``) with the JAX package's distributions, then
        moved to ``device``."""
        dev = resolve_device(device)
        gen = seeded(seed)
        return tree_to({
            "conv1": L.conv_init(gen, 5, 1, 6, dtype=dtype),
            "norm1": L.norm_init(6, dtype),
            "conv2": L.conv_init(gen, 5, 6, 16, dtype=dtype),
            "norm2": L.norm_init(16, dtype),
            "fc1": L.dense_init(gen, 256, 120, dtype=dtype),
            "fc2": L.dense_init(gen, 120, 84, dtype=dtype),
            "head": L.dense_init(gen, 84, num_classes, dtype=dtype),
        }, dev)

    @staticmethod
    def apply(params: dict, x: torch.Tensor,
              gn_impl: str = "auto") -> torch.Tensor:
        """Logits of NHWC images ``x`` (N, 28, 28, 1). ``gn_impl`` is the
        GroupNorms' ``layers.group_norm`` impl: ``"auto"`` (B5/B6 on the
        card) or ``"plain"``."""
        x = L.conv(params["conv1"], x, padding="VALID")        # 28→24
        x = _gelu(L.group_norm(params["norm1"], x, groups=6, impl=gn_impl))
        x = L.max_pool(x, 2)                                   # 24→12
        x = L.conv(params["conv2"], x, padding="VALID")        # 12→8
        x = _gelu(L.group_norm(params["norm2"], x, groups=16,
                               impl=gn_impl))
        x = L.max_pool(x, 2)                                   # 8→4
        x = x.reshape(x.shape[0], -1)                          # 4·4·16
        x = _gelu(L.dense(params["fc1"], x))
        x = _gelu(L.dense(params["fc2"], x))
        return L.dense(params["head"], x)


__all__ = ["LeNet"]
