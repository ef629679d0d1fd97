"""Training utilities — the port of ``torchbooster_tpu/utils.py``:
:class:`TrainState`, :func:`make_step` (forward, backward, global-norm
clip, accumulation, the scheduled optimizer update and the EMA ramp),
:func:`make_eval_step`, :func:`freeze`, :func:`seed`,
:func:`iter_loader` and :func:`instrument_step`.

PyTorch runs eagerly, so the step is a plain function that updates the
state IN PLACE (parameters through the optimizer, the EMA tree with
in-place lerps) and returns it — the counterpart of the JAX step's
donated state. Parameters are a nested dict of leaf tensors (fp32
masters); the loss function casts them to the compute dtype where it
uses them, so their gradients arrive in fp32. Meshes, sharding rules and
gradient comms are not ported yet (``ROADMAP.md`` A8): passing them
raises."""
from __future__ import annotations

import functools
import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensor leaves of a nested dict/tuple/list tree, in insertion
    order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def seed(value: int = 42) -> torch.Generator:
    """Seed Python, numpy and torch; return a CPU ``torch.Generator``
    seeded with ``value`` (the JAX package returns the root PRNG key)."""
    random.seed(value)
    np.random.seed(value)
    torch.manual_seed(value)
    return torch.Generator().manual_seed(value)


def iter_loader(loader: Iterable) -> Iterator[tuple[int, Any]]:
    """Endless ``(epoch, batch)`` iterator over a loader, for
    iteration-count training."""
    epoch = 0
    while True:
        for batch in loader:
            yield epoch, batch
        epoch += 1


@dataclass
class TrainState:
    """Everything the train step threads through: the parameter tree
    (leaf tensors that require grad), the torch optimizer the
    :class:`~torchbooster_tpu_torch.config.Transform` built over it, the
    step count, the generator handed to the loss (on the parameters'
    device; the JAX state's ``rng``), and the EMA tree. ``grad_acc``
    marks gradient accumulation: the running sum of the micro-steps'
    gradients lives in the leaves' ``.grad`` between boundaries (the JAX
    state's ``grad_acc`` tree).

    :meth:`state_dict` and :meth:`load_state_dict` carry all of it but
    the accumulating gradients across a checkpoint
    (``callbacks.SaveCallback``); loading writes into the live tensors,
    optimizer and generator in place."""

    params: Any
    optimizer: torch.optim.Optimizer
    step: int = 0
    generator: torch.Generator | None = None
    grad_acc: bool = False
    ema: Any = None

    @classmethod
    def create(cls, params: Any, tx: Any,
               generator: torch.Generator | int = 0,
               accumulate: bool = False, ema: bool = False) -> "TrainState":
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if isinstance(generator, int):
            device = leaves[0].device if leaves else "cpu"
            generator = torch.Generator(device).manual_seed(generator)
        ema_tree = _tree_map(lambda p: p.detach().clone(), params) \
            if ema else None
        return cls(params=params, optimizer=tx.init(params),
                   generator=generator, grad_acc=accumulate, ema=ema_tree)

    def state_dict(self) -> dict:
        """Live references to what a checkpoint holds: parameters, the
        optimizer's state dict, the step, the generator's state and the
        EMA tree. ``callbacks.SaveCallback`` copies it to the host."""
        return {"params": _tree_map(torch.Tensor.detach, self.params),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step,
                "generator": None if self.generator is None
                else self.generator.get_state(),
                "ema": self.ema}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Load a :meth:`state_dict` (host or device tensors) in place."""
        for p, q in zip(tree_leaves(self.params),
                        tree_leaves(state["params"]), strict=True):
            p.copy_(q)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if self.generator is not None:
            self.generator.set_state(state["generator"])
        if self.ema is not None:
            for e, q in zip(tree_leaves(self.ema), tree_leaves(state["ema"]),
                            strict=True):
                e.copy_(q)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _cast_batch(batch: Any, dtype: torch.dtype) -> Any:
    return _tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                     and x.is_floating_point() else x, batch)


def _split(out: Any, has_aux: bool) -> tuple[torch.Tensor, dict]:
    return out if has_aux else (out, {})


def make_step(loss_fn: Callable, tx: Any, clip: float | None = None,
              accumulate_every: int = 1,
              compute_dtype: torch.dtype | None = None,
              has_aux: bool = True, ema_decay: float | None = None,
              mesh: Any = None, rules: Any = None,
              comms: Any = None) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch, generator) -> loss`` (or ``(loss, aux)``
    with ``has_aux``). Each call runs forward and backward; on an update
    boundary (every ``accumulate_every`` calls) it averages the
    accumulated gradients, clips them to global norm ``clip``
    (``min(1, clip / (norm + 1e-6))``, what ``clip_grad_norm_``
    computes), sets every group's lr from the schedule at the
    optimizer's own update count — the count ``optax.inject_hyperparams``
    feeds the schedule, which advances only on boundaries — and steps
    the optimizer. ``ema_decay`` keeps ``state.ema`` with the
    bias-corrected ramp ``min(decay, (1 + step) / (10 + step))``,
    frozen on non-boundary micro-steps. ``compute_dtype`` casts the
    floating leaves of the parameters and of the batch before the loss
    (mixed precision over fp32 masters)."""
    if mesh is not None or rules is not None or comms is not None:
        raise NotImplementedError("make_step: meshes, sharding rules and "
                                  "gradient comms are not ported yet "
                                  "(ROADMAP.md A8)")
    accumulate = accumulate_every > 1

    def step_fn(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        if accumulate and not state.grad_acc:
            raise ValueError("accumulate_every > 1 needs a state created "
                             "with accumulate=True")
        params = state.params
        if compute_dtype is not None:
            # cast inside the differentiated function: the gradients
            # flow back through the casts onto the fp32 masters
            params = _cast_batch(params, compute_dtype)
            batch = _cast_batch(batch, compute_dtype)
        loss, aux = _split(loss_fn(params, batch, state.generator), has_aux)
        loss.backward()
        boundary = (state.step + 1) % accumulate_every == 0
        if boundary:
            leaves = tree_leaves(state.params)
            if accumulate:
                for p in leaves:
                    if p.grad is not None:
                        p.grad.div_(accumulate_every)
            if clip is not None:
                torch.nn.utils.clip_grad_norm_(leaves, clip)
            tx.clip_units(state.params)
            lr = tx.learning_rate(state.step // accumulate_every)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            # every leaf, not only the optimizer's: a frozen leaf
            # (``freeze``) gets a gradient too, which must not pile up
            for p in leaves:
                p.grad = None
        if ema_decay is not None and state.ema is not None and boundary:
            d = min(ema_decay, (1.0 + state.step) / (10.0 + state.step))
            with torch.no_grad():
                for e, p in zip(tree_leaves(state.ema),
                                tree_leaves(state.params)):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        state.step += 1
        return state, {"loss": loss.detach(),
                       **{k: v.detach() if isinstance(v, torch.Tensor)
                          else v for k, v in aux.items()}}

    return step_fn


def _paths(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``("a/b/c", leaf)`` pairs of a nested dict tree, in insertion
    order (the JAX package's ``path_str`` rendering)."""
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            yield from _paths(value, path)
        else:
            yield path, value


@dataclass(frozen=True)
class Frozen:
    """What :func:`freeze` returns: the wrapped transformation over the
    leaves whose path ``labels`` does not mark frozen. Frozen leaves are
    not in the torch optimizer at all, so they get no update and no
    decoupled weight decay: they stay bit-identical."""

    tx: Any
    labels: Callable[[str], bool]

    def learning_rate(self, count: int) -> float:
        return self.tx.learning_rate(count)

    def clip_units(self, params: Any) -> None:
        self.tx.clip_units(params)

    def init(self, params: Any) -> torch.optim.Optimizer:
        trainable = {path: leaf for path, leaf in _paths(params)
                     if not self.labels(path)}
        if not trainable:
            raise ValueError("freeze: every parameter is frozen")
        return self.tx.init(trainable)


def freeze(labels: Callable[[str], bool], tx: Any) -> Frozen:
    """Freeze parameters under any optimizer (``utils.freeze``, JAX
    :125-142): ``labels(path)`` returns True for frozen paths, rendered
    ``"stage0/block0/conv1/kernel"``; those get no update and no weight
    decay while ``tx`` drives the rest. The global-norm clip of
    ``make_step`` still counts their gradients, as the JAX step's does."""
    return Frozen(tx=tx, labels=labels)


def make_eval_step(loss_fn: Callable, has_aux: bool = True,
                   compute_dtype: torch.dtype | None = None) -> Callable:
    """``eval_step(params, batch, generator) -> metrics``, without
    gradients. Callers pass ``None`` for the generator, as the JAX
    recipes drop the key, so that dropout stays off."""

    @torch.no_grad()
    def eval_fn(params: Any, batch: Any, generator: Any) -> dict:
        if compute_dtype is not None:
            batch = _cast_batch(batch, compute_dtype)
        loss, aux = _split(loss_fn(params, batch, generator), has_aux)
        return {"loss": loss, **aux}

    return eval_fn


def instrument_step(step_fn: Callable, name: str = "train_step",
                    registry: Any = None) -> Callable:
    """Wrap a ``(state, batch) -> (state, metrics)`` step with telemetry
    on the port's registry: a ``step_seconds`` histogram of the host time
    of each call, a ``steps_total`` counter. It adds no device sync; the
    card runs asynchronously, so a call's host time is its enqueue time
    and the steady-state mean tracks the device's step time. Disabled
    telemetry costs one attribute check per call."""
    from torchbooster_tpu_torch.observability import get_registry

    reg = registry if registry is not None else get_registry()
    hist = reg.histogram("step_seconds",
                         "host wall time per train-step call")
    count = reg.counter("steps_total", "train steps called")

    @functools.wraps(step_fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        if not reg.enabled:
            return step_fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = step_fn(*args, **kwargs)
        hist.observe(time.perf_counter() - t0, step=name)
        count.inc(1, step=name)
        return out

    return wrapped


__all__ = ["Frozen", "TrainState", "freeze", "instrument_step",
           "iter_loader", "make_eval_step", "make_step", "seed",
           "tree_leaves"]
