"""Functional layers over plain parameter dicts, in the JAX package's
layouts (``torchbooster_tpu/models/layers.py``): dense kernels are
``(in, out)`` and are never transposed per call."""
from __future__ import annotations

import torch


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["kernel"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def layer_norm(params: dict, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def embedding(params: dict, ids: torch.Tensor,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    rows = params["table"][ids]
    return rows.to(dtype) if dtype is not None else rows


__all__ = ["dense", "embedding", "layer_norm"]
