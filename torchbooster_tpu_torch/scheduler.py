"""Learning-rate schedules as pure functions of the step count — the
port of ``torchbooster_tpu/scheduler.py``, over plain Python floats (the
training step sets each optimizer group's ``lr`` from them on the host).

The warmup → plateau → anneal cycle with lin/cos/exp/flat segments; the
plateau is a flat segment and phase boundaries are exact, as in the JAX
package."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable


def lin(lr_from: float, lr_to: float, t: float) -> float:
    """Linear interpolation."""
    return lr_from + (lr_to - lr_from) * t


def cos(lr_from: float, lr_to: float, t: float) -> float:
    """Half-cosine anneal."""
    return lr_to + 0.5 * (lr_from - lr_to) * (1.0 + math.cos(math.pi * t))


def exp(lr_from: float, lr_to: float, t: float) -> float:
    """Exponential (geometric) anneal."""
    return lr_from * (lr_to / lr_from) ** t


def flat(lr_from: float, lr_to: float, t: float) -> float:
    """Constant segment."""
    return lr_from


PHASE_2_FUN: dict[str, Callable] = {
    "lin": lin,
    "linear": lin,
    "cos": cos,
    "cosine": cos,
    "exp": exp,
    "flat": flat,
}


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


@dataclass(frozen=True)
class CycleScheduler:
    """Warmup → plateau → anneal cycle as a pure ``step -> lr`` function:

    1. ``decay[0]`` from ``lr * initial_multiplier`` to ``lr`` over
       ``warmup`` steps,
    2. flat ``lr`` for ``plateau`` steps,
    3. ``decay[1]`` from ``lr`` to ``lr * final_multiplier`` over the
       remaining ``n_iter - warmup - plateau`` steps."""

    lr: float
    n_iter: int
    initial_multiplier: float = 4e-2
    final_multiplier: float = 1e-5
    warmup: int = 0
    plateau: int = 0
    decay: tuple = ("cos", "cos")

    def __post_init__(self) -> None:
        for segment in self.decay:
            if segment not in PHASE_2_FUN:
                raise NameError(
                    f"unknown decay segment {segment!r}; "
                    f"expected one of {sorted(PHASE_2_FUN)}")

    def __call__(self, step: int | float) -> float:
        step = float(step)
        warmup_fn = PHASE_2_FUN[self.decay[0]]
        anneal_fn = PHASE_2_FUN[self.decay[1] if len(self.decay) > 1
                                else self.decay[0]]
        w, p = self.warmup, self.plateau
        if step < w:
            return warmup_fn(self.lr * self.initial_multiplier, self.lr,
                             _clip01(step / max(w, 1)))
        if step < w + p:
            return self.lr
        n_anneal = max(self.n_iter - w - p, 1)
        return anneal_fn(self.lr, self.lr * self.final_multiplier,
                         _clip01((step - w - p) / n_anneal))


@dataclass
class BaseScheduler:
    """Stateful adapter over a pure schedule, for host-driven loops and
    save/load: the state is the step count only."""

    schedule: Callable[[int], float]
    step_count: int = 0
    lr: float = field(init=False, default=0.0)

    def __post_init__(self) -> None:
        self.lr = float(self.schedule(self.step_count))

    def step(self) -> float:
        """Advance one step; return the new lr."""
        self.step_count += 1
        self.lr = float(self.schedule(self.step_count))
        return self.lr

    def state_dict(self) -> dict:
        return {"step_count": self.step_count}

    def load_state_dict(self, state: dict) -> None:
        self.step_count = int(state["step_count"])
        self.lr = float(self.schedule(self.step_count))


__all__ = ["BaseScheduler", "CycleScheduler", "PHASE_2_FUN", "cos", "exp",
           "flat", "lin"]
