"""Compute ops under the models: attention (plain PyTorch and the flash
kernels), losses, paged attention, GroupNorm and the fused conv+GN
blocks, each kernel with its plain version beside it — the port of
``torchbooster_tpu/ops``.

The names below are JAX's (``ops/__init__.py:7-15``). Importing them
builds and loads no CUDA code: every kernel is built at its first launch
(``ops/_build.py``). ``attention`` and ``paged_attention`` are the
functions, as in the JAX package; reach their modules with
``importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")``.
"""
from torchbooster_tpu_torch.ops.attention import attention, mha_reference
from torchbooster_tpu_torch.ops.losses import (
    bce_with_logits,
    cross_entropy,
    l2_loss,
    mse_loss,
)
from torchbooster_tpu_torch.ops.paged_attention import paged_attention

__all__ = [
    "attention", "bce_with_logits", "cross_entropy", "l2_loss",
    "mha_reference", "mse_loss", "paged_attention",
]
