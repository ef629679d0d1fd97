"""The optimizers that torch does not ship with the JAX package's rule:
``Lamb``, ``Lion`` and ``Adafactor``. Each is a ``torch.optim.Optimizer``
that computes exactly the optax chain ``OptimizerConfig.make`` of the JAX
package builds for its name (optax 0.2.6), leaf by leaf:

- :class:`Lamb` — ``optax.lamb``: ``scale_by_adam(b1, b2, eps,
  eps_root=0)`` → ``add_decayed_weights(wd, mask)`` →
  ``scale_by_trust_ratio()`` → ``scale_by_learning_rate(lr)``. The
  trust ratio is ``‖p‖ / ‖u‖`` over the whole leaf (a block leaf is
  stacked over the layers, so its norm spans them all), and 1 where
  either norm is 0;
- :class:`Lion` — ``optax.lion``: ``scale_by_lion(b1, b2)`` →
  ``add_decayed_weights(wd, mask)`` → ``scale_by_learning_rate(lr)``:
  the update is ``sign((1-b1)·g + b1·μ)``, then ``μ ← (1-b2)·g + b2·μ``,
  with no bias correction (``sign(0)`` is 0);
- :class:`Adafactor` — ``optax.adafactor(lr)`` with optax's defaults:
  ``scale_by_factored_rms(min_dim_size_to_factor=128, decay_rate=0.8,
  eps=1e-30)`` → ``clip_by_block_rms(1.0)`` →
  ``scale_by_learning_rate(lr, flip_sign=False)`` →
  ``scale_by_param_block_rms(1e-3)`` → ``scale(-1)``. A leaf factors
  over its two largest dims when the smaller of them is at least 128
  (a stacked ``(L, d, 4d)`` kernel over ``d`` and ``4d``, its layer axis
  kept); every other leaf keeps a full second moment.

The weight decay of Lamb and Lion is a group's ``weight_decay`` (the
``decay_matrices_only`` groups of ``config.Transform.init`` are optax's
``ndim > 1`` mask). Every rule runs in the parameters' dtype, as optax's
does on fp32 leaves. ``torch.optim.Adafactor`` is another rule (no
block-RMS clip, no parameter scale, another decay) and is not used."""
from __future__ import annotations

import numpy as np
import torch


def _init(state: dict, **moments: torch.Tensor) -> None:
    """A leaf's first state: the update count (optax's ``count``, per
    leaf here: every leaf updates together) and its zero moments."""
    state.update(step=torch.zeros((), dtype=torch.int64), **moments)


def _count(state: dict) -> int:
    """Advance the leaf's update count and return it. Every state entry
    is replaced, never written in place, so a state loaded from another
    optimizer's live ``state_dict`` shares nothing with it."""
    state["step"] = state["step"] + 1
    return int(state["step"])


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count``, computed in fp32 as optax does (in
    double it differs by up to 5e-5 relative at ``decay`` 0.999)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _norm(x: torch.Tensor) -> torch.Tensor:
    """A whole leaf's 2-norm. ``square().sum()`` rather than
    ``torch.linalg.vector_norm``: on the CPU the latter accumulates fp32
    in long runs and is 2.6e-3 off at a (50257, 768) leaf, where
    ``sum``'s cascade is within 1e-7 (a whole leaf's update scales by
    the norm)."""
    return x.square().sum().sqrt()


class Lamb(torch.optim.Optimizer):
    """``optax.lamb`` (see the module docstring); state per leaf: the
    ``step`` count and the moments ``mu``, ``nu``."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                if not state:
                    _init(state, mu=torch.zeros_like(p),
                          nu=torch.zeros_like(p))
                t = _count(state)
                state["mu"] = mu = (1 - b1) * g + b1 * state["mu"]
                state["nu"] = nu = (1 - b2) * g.square() + b2 * state["nu"]
                u = (mu / _bias_correction(b1, t)) / (
                    (nu / _bias_correction(b2, t)).sqrt() + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p_norm, u_norm = _norm(p), _norm(u)
                ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                    torch.ones_like(p_norm), p_norm / u_norm)
                p.add_((u * ratio) * -group["lr"])


class Lion(torch.optim.Optimizer):
    """``optax.lion`` (see the module docstring); state per leaf: the
    ``step`` count and the moment ``mu``."""

    def __init__(self, params, lr: float = 1e-4,
                 betas: tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                if not state:
                    _init(state, mu=torch.zeros_like(p))
                _count(state)
                mu = state["mu"]
                u = torch.sign((1.0 - b1) * g + b1 * mu)
                state["mu"] = (1 - b2) * g + b2 * mu
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.add_(u * -group["lr"])


# optax.adafactor's defaults, the only values the JAX package uses
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
EPS = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_SCALE = 1e-3


def factored_dims(shape: tuple[int, ...]) -> tuple[int, int] | None:
    """optax's ``_factored_dims``: ``(d1, d0)``, the second largest and
    the largest dim of ``shape`` (``np.argsort`` order, as optax breaks
    ties), or None when the leaf has fewer than 2 dims or the second
    largest is below ``MIN_DIM_SIZE_TO_FACTOR``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _block_rms(x: torch.Tensor) -> torch.Tensor:
    return x.square().mean().sqrt()


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)`` at optax's defaults (see the module
    docstring); state per leaf: the ``step`` count and either the row and
    column second moments ``v_row``, ``v_col`` (factored leaves) or the
    full ``v``."""

    def __init__(self, params, lr: float = 1e-2):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                self._update(p, p.grad, self.state[p], group["lr"])

    @staticmethod
    def _update(p: torch.Tensor, g: torch.Tensor, state: dict,
                lr: float) -> None:
        dims = factored_dims(tuple(p.shape))
        if not state:
            if dims is None:
                _init(state, v=torch.zeros_like(p))
            else:
                d1, d0 = dims
                _init(state, v_row=p.new_zeros(
                    [n for i, n in enumerate(p.shape) if i != d0]),
                    v_col=p.new_zeros(
                        [n for i, n in enumerate(p.shape) if i != d1]))
        # optax's _decay_rate_pow at the count before this update, in fp32
        t = np.float32(_count(state))
        decay = float(np.float32(1.0) - t ** np.float32(-DECAY_RATE))
        grad_sqr = g.square() + EPS
        if dims is None:
            state["v"] = v = decay * state["v"] + (1.0 - decay) * grad_sqr
            u = g * v.pow(-0.5)
        else:
            d1, d0 = dims
            state["v_row"] = v_row = (decay * state["v_row"] + (1.0 - decay)
                                      * grad_sqr.mean(dim=d0))
            state["v_col"] = v_col = (decay * state["v_col"] + (1.0 - decay)
                                      * grad_sqr.mean(dim=d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)
                          ).pow(-0.5)
            u = g * row_factor.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
        # clip_by_block_rms, the learning rate, scale_by_param_block_rms
        u = u / torch.clamp_min(_block_rms(u) / CLIPPING_THRESHOLD, 1.0)
        u = u * lr
        p_rms = _block_rms(p)
        u = u * torch.where(p_rms <= MIN_SCALE,
                            torch.full_like(p_rms, MIN_SCALE), p_rms)
        p.add_(-u)


__all__ = ["Adafactor", "Lamb", "Lion", "factored_dims"]
