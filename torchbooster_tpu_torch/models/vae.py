"""MLP VAE for 28×28 images — the port of
``torchbooster_tpu/models/vae.py``: encoder 784→512→512→2·z (GELU, JAX's
tanh approximation), the reparameterized sample, decoder z→512→512→784
logits (the sigmoid lives in the loss, ``bce_with_logits``).

``apply(train=True)`` draws ε from the ``torch.Generator`` it is given,
where JAX takes a PRNG key; :func:`_reparameterize` takes ε as a tensor,
so that a test can feed JAX's own draw, and :func:`_apply_with` takes
the draw as a function (the recipe's draws span the global batch). The matrices are plain products
(no TPU kernel ran here in JAX either)."""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from torchbooster_tpu_torch._device import resolve_device, seeded, tree_to
from torchbooster_tpu_torch.models import layers as L


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default: the tanh approximation
    return F.gelu(x, approximate="tanh")


def kl_divergence(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KL(q(z|x) ‖ N(0,I)) averaged over the batch."""
    kl = 1.0 + log_var - torch.square(mu) - torch.exp(log_var)
    return (-0.5 * kl.sum(dim=1)).mean()


def _reparameterize(mu: torch.Tensor, log_var: torch.Tensor,
                    eps: torch.Tensor) -> torch.Tensor:
    return mu + torch.exp(0.5 * log_var) * eps


class VAE:
    """``init(seed, z_dim, device)`` → params; ``apply(params, x,
    generator)`` → ``(recon_logits, mu, log_var)``; ``decode(params, z)``
    → image logits."""

    # fsdp: dense kernels shard their output dim (a dim the axis does not
    # divide replicates); dp-only meshes filter the axis away
    SHARDING_RULES = [
        (r".*/kernel", (None, "fsdp")),
        (r".*", ()),
    ]

    @staticmethod
    def init(seed: int | torch.Generator = 0, z_dim: int = 32,
             image_dim: int = 784, hidden: int = 512,
             device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        """Weights drawn on the CPU from ``seed`` with the JAX package's
        distributions, then moved to ``device``."""
        dev = resolve_device(device)
        gen = seeded(seed)
        return tree_to({
            "enc1": L.dense_init(gen, image_dim, hidden, dtype=dtype),
            "enc2": L.dense_init(gen, hidden, hidden, dtype=dtype),
            "enc_out": L.dense_init(gen, hidden, 2 * z_dim, dtype=dtype),
            "dec1": L.dense_init(gen, z_dim, hidden, dtype=dtype),
            "dec2": L.dense_init(gen, hidden, hidden, dtype=dtype),
            "dec_out": L.dense_init(gen, hidden, image_dim, dtype=dtype),
        }, dev)

    @staticmethod
    def encode(params: dict, x: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        x = x.reshape(x.shape[0], -1)
        x = _gelu(L.dense(params["enc1"], x))
        x = _gelu(L.dense(params["enc2"], x))
        mu, log_var = torch.chunk(L.dense(params["enc_out"], x), 2, dim=1)
        return mu, log_var

    @staticmethod
    def decode(params: dict, z: torch.Tensor,
               image_shape: tuple = (28, 28, 1)) -> torch.Tensor:
        """Logits; apply a sigmoid for pixels."""
        z = _gelu(L.dense(params["dec1"], z))
        z = _gelu(L.dense(params["dec2"], z))
        logits = L.dense(params["dec_out"], z)
        return logits.reshape(z.shape[0], *image_shape)

    @staticmethod
    def apply(params: dict, x: torch.Tensor,
              generator: torch.Generator | None = None, train: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``train=True`` samples z = μ + exp(½·log σ²)·ε with ε drawn
        from ``generator`` (on its device, in μ's dtype); ``train=False``
        decodes μ."""
        def draw(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
            return torch.randn(shape, generator=generator, dtype=dtype,
                               device=generator.device)

        return _apply_with(params, x, draw if train else None)


def _apply_with(params: dict, x: torch.Tensor,
                draw: Callable[[tuple, torch.dtype], torch.Tensor] | None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:meth:`VAE.apply` with ε from ``draw(shape, dtype)`` (μ's shape
    and dtype); ``draw=None`` decodes μ."""
    mu, log_var = VAE.encode(params, x)
    z = mu if draw is None else _reparameterize(
        mu, log_var, draw(tuple(log_var.shape), mu.dtype).to(mu.device))
    shape = tuple(x.shape[1:]) if x.ndim > 2 else (28, 28, 1)
    return VAE.decode(params, z, shape), mu, log_var


__all__ = ["VAE", "kl_divergence"]
