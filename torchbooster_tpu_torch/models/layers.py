"""Functional layers over plain parameter dicts, in the JAX package's
layouts (``torchbooster_tpu/models/layers.py``): dense kernels are
``(in, out)`` and are never transposed per call; images are NHWC and conv
kernels HWIO at every public function.

Initializers draw from a ``torch.Generator`` with the JAX package's
distributions (fan-in uniform ``±1/sqrt(fan_in)``, unit norms, zero
biases); the numbers differ from JAX's, so the parity tests carry JAX
weights across instead (``interop``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from torchbooster_tpu_torch.models.quant import qmatmul
from torchbooster_tpu_torch.ops import group_norm as gn


# ------------------------------------------------------------- initializers
def _fan_in_uniform(gen: torch.Generator, shape: tuple, fan_in: int,
                    dtype: torch.dtype) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0
            - 1.0).mul_(bound).to(dtype)


def dense_init(gen: torch.Generator, din: int, dout: int,
               use_bias: bool = True,
               dtype: torch.dtype = torch.float32) -> dict:
    params = {"kernel": _fan_in_uniform(gen, (din, dout), din, dtype)}
    if use_bias:
        params["bias"] = torch.zeros((dout,), dtype=dtype)
    return params


def conv_init(gen: torch.Generator, kernel: int | tuple[int, int], cin: int,
              cout: int, use_bias: bool = True,
              dtype: torch.dtype = torch.float32) -> dict:
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    params = {"kernel": _fan_in_uniform(gen, (kh, kw, cin, cout),
                                        kh * kw * cin, dtype)}
    if use_bias:
        params["bias"] = torch.zeros((cout,), dtype=dtype)
    return params


def norm_init(channels: int, dtype: torch.dtype = torch.float32) -> dict:
    return {"scale": torch.ones((channels,), dtype=dtype),
            "bias": torch.zeros((channels,), dtype=dtype)}


# -------------------------------------------------------------------- dense
def dense(params: dict, x: torch.Tensor,
          delta: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ kernel (+ delta) + bias``; a quantized dict (``qkernel``,
    ``models/quant.py``) widens its kernel inside the product. ``delta``
    (a LoRA ranked product) is added before the bias, as the JAX
    package's ``_row_dense`` adds it."""
    if "qkernel" in params:
        y = qmatmul(params, x)
    else:
        y = x @ params["kernel"].to(x.dtype)
    if delta is not None:
        y = y + delta
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


# ---------------------------------------------------------------- convolution
def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA ``"SAME"`` padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(params: dict, x: torch.Tensor, stride: int = 1,
         padding: str | int = "SAME") -> torch.Tensor:
    """NHWC x, HWIO kernel (cast to x's dtype). Integer padding is
    symmetric, as in torch; ``"SAME"`` pads as XLA does. ``x.permute(0,
    3, 1, 2)`` of a contiguous NHWC tensor is already channels-last, so
    ``F.conv2d`` takes it without a copy, and its channels-last output
    permutes back to a contiguous NHWC tensor."""
    w = params["kernel"].to(x.dtype)
    kh, kw = w.shape[:2]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        ph = _same_pads(x.shape[1], kh, stride)
        pw = _same_pads(x.shape[2], kw, stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
            padding = 0
    elif padding == "VALID":
        padding = 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


# ------------------------------------------------------------------- pooling
def max_pool(x: torch.Tensor, window: int = 2, stride: int | None = None,
             padding: int = 0) -> torch.Tensor:
    """Max pool over NHWC with torch-style symmetric padding (the pad
    never wins: ``-inf`` fill)."""
    stride = window if stride is None else stride
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))


# ------------------------------------------------------------- normalization
def group_norm(params: dict, x: torch.Tensor, groups: int = 32,
               eps: float = 1e-5, relu: bool = False,
               impl: str = "auto") -> torch.Tensor:
    """GroupNorm(+ReLU) over NHWC; ``groups`` is clipped to a divisor of
    the channel count. ``impl``: ``"auto"`` runs the B5/B6 kernels
    (``ops/group_norm.py``) on a CUDA tensor and the plain formulation on
    the CPU; ``"plain"`` (or the JAX name ``"xla"``) forces the plain
    formulation.

    The JAX package resolves ``"auto"`` to XLA on a v5e measurement: XLA
    folds the affine and ReLU into the producing convolution's epilogue.
    Eager PyTorch has no such fusion, so the port takes the kernel."""
    c = x.shape[-1]
    groups = min(groups, c)
    while c % groups:
        groups -= 1
    if impl not in ("auto", "plain", "xla"):
        raise ValueError(f"group_norm: unknown impl {impl!r}")
    if impl == "auto" and x.device.type == "cuda":
        return gn.group_norm_fused(params["scale"], params["bias"], x, groups,
                                   eps, relu=relu)
    # the plain formulation (layers.py:189-209; B5's plain version):
    # fp32 per-channel moments, the group combine on the (n, c) sums, the
    # clamped variance and one affine pass, differentiated by autograd
    return gn.group_norm_fwd_reference(x, params["scale"], params["bias"],
                                       groups, eps, relu)[0]


def layer_norm(params: dict, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def embedding(params: dict, ids: torch.Tensor,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    if "qtable" in params:
        # per-row int8 table: dequantize only the gathered rows, in fp32
        out = params["qtable"][ids].float() * params["qscale"][ids].float()
        return out.to(dtype) if dtype is not None else out
    rows = params["table"][ids]
    return rows.to(dtype) if dtype is not None else rows


__all__ = ["conv", "conv_init", "dense", "dense_init", "embedding",
           "global_avg_pool", "group_norm", "layer_norm", "max_pool",
           "norm_init"]
