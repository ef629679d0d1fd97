"""The optimizers that torch does not ship with the JAX package's rule:
``Lamb``, ``Lion`` and ``Adafactor``, and ``SGD`` over a learning rate
held on the card. Each is a ``torch.optim.Optimizer`` that computes
exactly the optax chain ``OptimizerConfig.make`` of the JAX package
builds for its name (optax 0.2.6), leaf by leaf:

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
block-RMS clip, no parameter scale, another decay) and is not used.

A step reads nothing back to the host, so that a CUDA graph can hold it
(``utils.make_step``): the update count (optax's ``count``) lies on the
parameters' device and the values made from it (Lamb's bias
corrections, Adafactor's decay) are computed there in fp32, as optax
computes them; every state tensor is written in place, so the addresses
a graph baked in stay the state; and a group's ``lr`` may be a tensor
on the card, which the train step refreshes in place before each step.
"""
from __future__ import annotations

import numpy as np
import torch


class _InPlace(torch.optim.Optimizer):
    """An optimizer whose step writes its state in place: a state loaded
    from another optimizer's live ``state_dict`` is copied first, so the
    two share nothing."""

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        for state in self.state.values():
            for key, value in state.items():
                if isinstance(value, torch.Tensor):
                    state[key] = value.clone()


def _init(state: dict, p: torch.Tensor, **moments: torch.Tensor) -> None:
    """A leaf's first state: the update count (optax's ``count``, per
    leaf here: every leaf updates together), an fp32 scalar on ``p``'s
    device, and its zero moments."""
    state.update(step=torch.zeros((), dtype=torch.float32, device=p.device),
                 **moments)


def _count(state: dict, p: torch.Tensor) -> torch.Tensor:
    """Advance the leaf's update count in place and return it. A count
    restored elsewhere (a CPU tensor, an int64 one) moves onto ``p``'s
    device as fp32 first; that happens before any capture, at the first
    step after the restore."""
    step = state["step"]
    if step.device != p.device or step.dtype != torch.float32:
        step = state["step"] = step.to(p.device, torch.float32)
    return step.add_(1)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """optax's ``1 - decay**count``, computed in fp32 as optax does (in
    double it differs by up to 5e-5 relative at ``decay`` 0.999)."""
    return 1.0 - torch.pow(decay, count)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """A whole leaf's 2-norm. ``square().sum()`` rather than
    ``torch.linalg.vector_norm``: on the CPU the latter accumulates fp32
    in long runs and is 2.6e-3 off at a (50257, 768) leaf, where
    ``sum``'s cascade is within 1e-7 (a whole leaf's update scales by
    the norm)."""
    return x.square().sum().sqrt()


def _ema(value: torch.Tensor, decay, new: torch.Tensor) -> None:
    """``value ← decay·value + (1 - decay)·new`` in place, rounded as the
    optax expression ``(1 - decay) * new + decay * value`` is."""
    torch.add((1.0 - decay) * new, decay * value, out=value)


class SGD(torch.optim.SGD):
    """``torch.optim.SGD``'s momentum and decay rule — the JAX package
    reproduces it — with an ``lr`` that is a float or a scalar tensor on
    the card. torch's own step reads such an lr back to the host
    (``add_(grad, alpha=-lr)``); here the update is ``p + grad·(-lr)``
    for either, the product rounded first, as optax's
    ``scale_by_learning_rate`` then ``apply_updates`` round it."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            wd, momentum = group["weight_decay"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g.add(p, alpha=wd)
                if momentum:
                    state = self.state[p]
                    buf = state.get("momentum_buffer")
                    if buf is None:
                        buf = state["momentum_buffer"] = g.detach().clone()
                    else:
                        buf.mul_(momentum).add_(
                            g, alpha=1 - group["dampening"])
                    g = g.add(buf, alpha=momentum) if group["nesterov"] \
                        else buf
                p.add_(g * -group["lr"])
        return None


class Lamb(_InPlace):
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
                    _init(state, p, mu=torch.zeros_like(p),
                          nu=torch.zeros_like(p))
                t = _count(state, p)
                mu, nu = state["mu"], state["nu"]
                _ema(mu, b1, g)
                _ema(nu, b2, g.square())
                u = (mu / _bias_correction(b1, t)) / (
                    (nu / _bias_correction(b2, t)).sqrt() + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p_norm, u_norm = _norm(p), _norm(u)
                ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                    torch.ones_like(p_norm), p_norm / u_norm)
                p.add_((u * ratio) * -group["lr"])


class Lion(_InPlace):
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
                    _init(state, p, mu=torch.zeros_like(p))
                _count(state, p)
                mu = state["mu"]
                u = torch.sign((1.0 - b1) * g + b1 * mu)
                _ema(mu, b2, g)
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


class Adafactor(_InPlace):
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
                _init(state, p, v=torch.zeros_like(p))
            else:
                d1, d0 = dims
                _init(state, p, v_row=p.new_zeros(
                    [n for i, n in enumerate(p.shape) if i != d0]),
                    v_col=p.new_zeros(
                        [n for i, n in enumerate(p.shape) if i != d1]))
        # optax's _decay_rate_pow(count) = 1 - (count + 1)^-0.8 in fp32,
        # count the updates before this one
        decay = 1.0 - torch.pow(_count(state, p), -DECAY_RATE)
        grad_sqr = g.square() + EPS
        if dims is None:
            v = state["v"]
            _ema(v, decay, grad_sqr)
            u = g * v.pow(-0.5)
        else:
            d1, d0 = dims
            v_row, v_col = state["v_row"], state["v_col"]
            _ema(v_row, decay, grad_sqr.mean(dim=d0))
            _ema(v_col, decay, grad_sqr.mean(dim=d1))
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


__all__ = ["Adafactor", "Lamb", "Lion", "SGD", "factored_dims"]
