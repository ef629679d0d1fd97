"""DDPM machinery — the port of ``torchbooster_tpu/ops/diffusion.py``:
noise schedules, forward corruption, the ε-prediction loss,
classifier-free guidance and the two samplers.

Randomness comes from a ``torch.Generator`` where JAX takes a PRNG key:
``randint`` for the timesteps, ``randn`` for the noise and ``rand <
p_uncond`` for the label drop, each drawn on the generator's device and
moved to the data's. Each public function is its draws and a private
core that takes the draws as tensors (``_ddpm_loss_core``,
``_ddpm_chain``, ``_ddim_chain``), so that a chain can be fed JAX's own
draws. JAX's samplers are one ``lax.scan`` over the schedule; eager
PyTorch has no such loop, so the port's are a Python loop over the
chain, one denoiser call a step.

The tables are fp32, computed as JAX computes them: ``linspace`` by
JAX's formula (``start·(1 − i/div) + stop·i/div``, the end point set),
so that DDIM's rounded step table (half to even) equals JAX's."""
from __future__ import annotations

import math
from typing import Any, Callable, Iterable, NamedTuple

import torch

from torchbooster_tpu_torch.ops.losses import mse_loss


class DiffusionSchedule(NamedTuple):
    """Precomputed per-step tables (all (T,) fp32)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_bars: torch.Tensor

    @property
    def T(self) -> int:  # noqa: N802 - standard diffusion notation
        return self.betas.shape[0]


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in fp32, by JAX's formula."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / float(div)
    a = torch.tensor(start, dtype=torch.float32)
    b = torch.tensor(stop, dtype=torch.float32)
    return torch.cat([a * (1 - step) + b * step, b[None]])


def linear_schedule(T: int, beta1: float = 1e-4,
                    beta2: float = 2e-2) -> DiffusionSchedule:
    """The DDPM paper's linear β ramp."""
    betas = _linspace(beta1, beta2, T)
    alphas = 1.0 - betas
    return DiffusionSchedule(betas, alphas, torch.cumprod(alphas, 0))


def cosine_schedule(T: int, s: float = 8e-3) -> DiffusionSchedule:
    """Improved-DDPM cosine ᾱ — flatter SNR decay at both ends."""
    steps = torch.arange(T + 1, dtype=torch.float32) / T
    f = torch.cos((steps + s) / (1.0 + s) * math.pi / 2.0) ** 2
    alpha_bars = f[1:] / f[0]
    betas = torch.clip(1.0 - alpha_bars / torch.cat(
        [torch.ones(1), alpha_bars[:-1]]), 0.0, 0.999)
    alphas = 1.0 - betas
    return DiffusionSchedule(betas, alphas, torch.cumprod(alphas, 0))


def make_schedule(name: str, T: int) -> DiffusionSchedule:
    if name == "linear":
        return linear_schedule(T)
    if name == "cosine":
        return cosine_schedule(T)
    raise ValueError(f"unknown schedule {name!r}; use 'linear' or 'cosine'")


def _table(table: torch.Tensor, device: torch.device) -> torch.Tensor:
    return table if table.device == device else table.to(device)


def q_sample(x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
             sched: DiffusionSchedule) -> torch.Tensor:
    """Forward corruption x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε; ``t`` is (B,)."""
    ab = _table(sched.alpha_bars, t.device)[t][:, None, None, None]
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def _ddpm_loss_core(apply_fn: Callable, params: Any, x0: torch.Tensor,
                    t: torch.Tensor, noise: torch.Tensor,
                    drop: torch.Tensor | None, sched: DiffusionSchedule,
                    labels: torch.Tensor | None = None,
                    null_label: int | None = None) -> torch.Tensor:
    """:func:`ddpm_loss` on given draws: timesteps ``t`` (B,), ``noise``
    like x0, and ``drop`` (B,) bool (None: keep every label)."""
    x_t = q_sample(x0, t, noise, sched)
    if labels is None:
        pred = apply_fn(params, x_t, t)
    else:
        if drop is not None:
            labels = torch.where(drop, torch.full_like(labels, null_label),
                                 labels)
        pred = apply_fn(params, x_t, t, labels)
    return mse_loss(pred, noise)   # fp32 accumulation (ops/losses.py)


def _loss_draws(rng: torch.Generator, shape: tuple, T: int,
                dtype: torch.dtype, p_drop: float | None) -> tuple:
    """:func:`ddpm_loss`'s draws for a batch of ``shape``, in its order:
    the timesteps (B,), the noise (``dtype``) and, with ``p_drop``, the
    label drop (B,) bool (else None), all on the generator's device."""
    n, dev = shape[0], rng.device
    t = torch.randint(0, T, (n,), generator=rng, device=dev)
    noise = torch.randn(shape, generator=rng, device=dev, dtype=dtype)
    drop = None
    if p_drop is not None:
        drop = torch.rand((n,), generator=rng, device=dev) < p_drop
    return t, noise, drop


def ddpm_loss(apply_fn: Callable, params: Any, x0: torch.Tensor,
              rng: torch.Generator, sched: DiffusionSchedule,
              labels: torch.Tensor | None = None,
              null_label: int | None = None,
              p_uncond: float = 0.1) -> torch.Tensor:
    """ε-prediction MSE at uniformly drawn timesteps (the simple DDPM
    objective). ``apply_fn(params, x_t, t, labels) -> ε̂`` when
    ``labels`` is given (else the 3-arg form). For classifier-free
    guidance training, pass ``null_label``: each label is replaced by
    it with probability ``p_uncond`` so one network learns both the
    conditional and unconditional scores. ``rng`` draws t, the noise
    (in x0's dtype) and the drop, in that order."""
    conditional = labels is not None and null_label is not None
    t, noise, drop = _loss_draws(rng, tuple(x0.shape), sched.T, x0.dtype,
                                 p_uncond if conditional and p_uncond > 0
                                 else None)
    return _ddpm_loss_core(apply_fn, params, x0, t.to(x0.device),
                           noise.to(x0.device),
                           None if drop is None else drop.to(x0.device),
                           sched, labels, null_label)


def cfg_apply(apply_fn: Callable, params: Any, x: torch.Tensor,
              t: torch.Tensor, labels: torch.Tensor, null_label: int,
              guidance: float) -> torch.Tensor:
    """Classifier-free guided score:
    ε̂ = (1+w)·ε̂(x, y) − w·ε̂(x, ∅). ``guidance=0`` short-circuits to
    the plain conditional model (no doubled batch). Both branches run
    in one batched call (2B)."""
    if guidance == 0.0:
        return apply_fn(params, x, t, labels)
    double = torch.cat([x, x], dim=0)
    t2 = torch.cat([t, t], dim=0)
    y2 = torch.cat([labels, torch.full_like(labels, null_label)], dim=0)
    eps = apply_fn(params, double, t2, y2)
    cond, uncond = torch.chunk(eps, 2, dim=0)
    return (1.0 + guidance) * cond - guidance * uncond


def _draws(shape: tuple, rng: torch.Generator, n: int):
    """``n`` fp32 normal draws of ``shape``, one a step, made as the chain
    reaches them."""
    for _ in range(n):
        yield torch.randn(shape, generator=rng, device=rng.device,
                          dtype=torch.float32)


def _steps(x: torch.Tensor, t: int) -> torch.Tensor:
    return torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)


@torch.no_grad()
def _ddpm_chain(apply_fn: Callable, params: Any, x: torch.Tensor,
                zs: Iterable[torch.Tensor],
                sched: DiffusionSchedule) -> torch.Tensor:
    """The ancestral chain from ``x`` (fp32 noise), t = T−1 … 0, with
    ``zs`` the steps' noise in that order. The per-step coefficients are
    fp32 tables, each entry computed as JAX's step computes it."""
    betas, alphas, ab = sched.betas.cpu(), sched.alphas.cpu(), \
        sched.alpha_bars.cpu()
    c_eps = betas / torch.sqrt(1.0 - ab)
    c_den = torch.sqrt(alphas)
    c_z = torch.where(torch.arange(sched.T) > 0, torch.sqrt(betas),
                      torch.zeros(()))
    for t, z in zip(range(sched.T - 1, -1, -1), zs):
        eps = apply_fn(params, x, _steps(x, t)).float()
        x = (x - c_eps[t] * eps) / c_den[t] + c_z[t] * z.to(x.device)
    return x


def ddpm_sample(apply_fn: Callable, params: Any, shape: tuple,
                rng: torch.Generator,
                sched: DiffusionSchedule) -> torch.Tensor:
    """Ancestral sampling: T reverse steps. ``rng`` draws the starting
    noise, then each step's noise; the images come back on its device."""
    x = torch.randn(shape, generator=rng, device=rng.device,
                    dtype=torch.float32)
    return _ddpm_chain(apply_fn, params, x, _draws(shape, rng, sched.T),
                       sched)


def _ddim_ts(T: int, steps: int) -> list[int]:
    """DDIM's step table: ``jnp.linspace(T-1, 0, steps).round()`` in fp32,
    half to even."""
    return [int(v) for v in torch.round(_linspace(T - 1, 0, steps))]


@torch.no_grad()
def _ddim_chain(apply_fn: Callable, params: Any, x: torch.Tensor,
                zs: Iterable[torch.Tensor], sched: DiffusionSchedule,
                ts: list[int], eta: float = 0.0) -> torch.Tensor:
    """The DDIM chain over the steps ``ts`` from ``x``, with ``zs`` the
    steps' noise in order."""
    ab_all = sched.alpha_bars.cpu()
    one = torch.ones((), dtype=torch.float32)
    for t, t_prev, z in zip(ts, ts[1:] + [-1], zs):
        eps = apply_fn(params, x, _steps(x, t)).float()
        ab = ab_all[t]
        ab_prev = ab_all[t_prev] if t_prev >= 0 else one
        x0 = (x - torch.sqrt(1.0 - ab) * eps) / torch.sqrt(ab)
        sigma = eta * torch.sqrt((1.0 - ab_prev) / (1.0 - ab)
                                 * (1.0 - ab / ab_prev))
        dir_xt = torch.sqrt(torch.clip(1.0 - ab_prev - sigma ** 2, 0.0)) \
            * eps
        x = torch.sqrt(ab_prev) * x0 + dir_xt + sigma * z.to(x.device)
    return x


def ddim_sample(apply_fn: Callable, params: Any, shape: tuple,
                rng: torch.Generator, sched: DiffusionSchedule,
                steps: int = 50, eta: float = 0.0) -> torch.Tensor:
    """DDIM: a strided ``steps``-long chain over the same tables;
    ``eta=0`` is fully deterministic given the initial noise (each step
    still draws its noise, scaled by σ = 0)."""
    x = torch.randn(shape, generator=rng, device=rng.device,
                    dtype=torch.float32)
    return _ddim_chain(apply_fn, params, x, _draws(shape, rng, steps),
                       sched, _ddim_ts(sched.T, steps), eta)


__all__ = ["DiffusionSchedule", "cfg_apply", "cosine_schedule",
           "ddim_sample", "ddpm_loss", "ddpm_sample", "linear_schedule",
           "make_schedule", "q_sample"]
