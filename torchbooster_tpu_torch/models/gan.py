"""MLP GAN for 28×28 images — the port of
``torchbooster_tpu/models/gan.py``: generator z→512→512→784 sigmoid,
discriminator 784→512→512→1 (GELU, JAX's tanh approximation), the hinge
losses and the gradient penalty.

The penalty is a double backward: the per-sample input gradients come
from ``torch.autograd.grad(D(t).sum(), t, create_graph=True)``, valid
because D's rows do not interact, and the penalty's own gradient then
flows back through that graph to D's parameters. The uniform α is drawn
from the ``torch.Generator`` given; :func:`_grad_penalty_core` takes α
as a tensor. No TPU kernel ran here in JAX: the products are cuBLAS."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torchbooster_tpu_torch._device import resolve_device, seeded, tree_to
from torchbooster_tpu_torch.models import layers as L
from torchbooster_tpu_torch.models.vae import _gelu


class GAN:
    """Two independent param trees: ``init(seed, z_dim, device)`` →
    ``{"G": ..., "D": ...}``; ``generate(G, z)``; ``discriminate(D, x)``."""

    # fsdp: both G and D dense kernels shard their output dim (D's 1-wide
    # head replicates)
    SHARDING_RULES = [
        (r".*/kernel", (None, "fsdp")),
        (r".*", ()),
    ]

    @staticmethod
    def init(seed: int | torch.Generator = 0, z_dim: int = 64,
             image_dim: int = 784, hidden: int = 512,
             device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        dev = resolve_device(device)
        gen = seeded(seed)
        return tree_to({
            "G": {
                "fc1": L.dense_init(gen, z_dim, hidden, dtype=dtype),
                "fc2": L.dense_init(gen, hidden, hidden, dtype=dtype),
                "out": L.dense_init(gen, hidden, image_dim, dtype=dtype),
            },
            "D": {
                "fc1": L.dense_init(gen, image_dim, hidden, dtype=dtype),
                "fc2": L.dense_init(gen, hidden, hidden, dtype=dtype),
                "out": L.dense_init(gen, hidden, 1, dtype=dtype),
            },
        }, dev)

    @staticmethod
    def generate(g_params: dict, z: torch.Tensor,
                 image_shape: tuple = (28, 28, 1)) -> torch.Tensor:
        x = _gelu(L.dense(g_params["fc1"], z))
        x = _gelu(L.dense(g_params["fc2"], x))
        x = torch.sigmoid(L.dense(g_params["out"], x))
        return x.reshape(x.shape[0], *image_shape)

    @staticmethod
    def discriminate(d_params: dict, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = _gelu(L.dense(d_params["fc1"], x))
        x = _gelu(L.dense(d_params["fc2"], x))
        return L.dense(d_params["out"], x)[:, 0]


def hinge_g_loss(d_params: dict, x_fake: torch.Tensor) -> torch.Tensor:
    """Generator hinge loss."""
    return F.relu(1.0 - GAN.discriminate(d_params, x_fake)).mean()


def hinge_d_loss(d_params: dict, x_real: torch.Tensor,
                 x_fake: torch.Tensor) -> torch.Tensor:
    """Discriminator hinge loss."""
    return (F.relu(1.0 - GAN.discriminate(d_params, x_real)).mean()
            + F.relu(1.0 + GAN.discriminate(d_params, x_fake)).mean())


def _grad_penalty_core(d_params: dict, x_real: torch.Tensor,
                       x_fake: torch.Tensor,
                       alpha: torch.Tensor) -> torch.Tensor:
    """:func:`grad_penalty` at a given α of shape (B, 1, ..., 1)."""
    t = alpha * x_real - (1.0 - alpha) * x_fake
    if not t.requires_grad:
        t = t.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(GAN.discriminate(d_params, t).sum(), t,
                                   create_graph=True)
    grads = grads.reshape(grads.shape[0], -1)
    norms = torch.sqrt(torch.sum(torch.square(grads), dim=1) + 1e-12)
    return torch.mean(torch.square(norms - 1.0))


def grad_penalty(d_params: dict, x_real: torch.Tensor, x_fake: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """Gradient penalty on interpolates: ``mean((‖∇_t D(t)‖₂ − 1)²)`` with
    ``t = α·x_real − (1−α)·x_fake`` (the reference's interpolation,
    minus sign included) and α ~ U[0, 1) a sample, drawn from
    ``generator`` in x_real's dtype. Differentiable with respect to D's
    parameters (double backward)."""
    shape = (x_real.shape[0],) + (1,) * (x_real.ndim - 1)
    alpha = torch.rand(shape, generator=generator, dtype=x_real.dtype,
                       device=generator.device)
    return _grad_penalty_core(d_params, x_real, x_fake,
                              alpha.to(x_real.device))


__all__ = ["GAN", "grad_penalty", "hinge_d_loss", "hinge_g_loss"]
