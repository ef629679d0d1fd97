"""Training utilities — the port of ``torchbooster_tpu/utils.py``:
:class:`TrainState`, :func:`make_step` (forward, backward, global-norm
clip, accumulation, the scheduled optimizer update and the EMA ramp),
:func:`make_eval_step`, :func:`freeze`, :func:`seed`, :func:`boost`,
:func:`iter_loader`, :func:`instrument_step`, the tree helpers
:func:`detach`, :func:`to_array` and :func:`stack_dictionaries`, and the
profiler helpers ``trace`` and ``annotate`` (``observability/spans.py``).

PyTorch runs eagerly, so the step is a plain function that updates the
state IN PLACE (parameters through the optimizer, the EMA tree with
in-place lerps) and returns it — the counterpart of the JAX step's
donated state. Parameters are a nested dict of leaf tensors (fp32
masters); the loss function casts them to the compute dtype where it
uses them, so their gradients arrive in fp32.

Across ranks (one process per device, ``distributed.launch``) the step
takes a mesh: the implicit path all-reduces the batch-mean gradient over
the data axes, sharding rules gather ``fsdp``-sharded leaves before the
loss and reduce-scatter their gradients back, and a ``comms`` schedule
replaces the all-reduce with the explicit fp32/bf16/int8 sync and the
ZeRO stages 1-3 (``comms/``)."""
from __future__ import annotations

import functools
import logging
import random
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

# the profiler helpers' home is the telemetry layer; ``utils.trace`` is
# the user-facing name, as in the JAX package
from torchbooster_tpu_torch.observability.spans import (  # noqa: F401
    annotate,
    trace,
)


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensor leaves of a nested dict/tuple/list tree, in insertion
    order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def boost(enable: bool = True) -> None:
    """Speed or debug switch (JAX ``utils.py:44``). ``boost(False)`` is
    debug mode: autograd's anomaly detection, the counterpart of
    ``jax_debug_nans`` (a backward that makes a NaN raises, naming the
    forward op). ``boost(True)`` turns it off again. JAX's other switch,
    ``jax_disable_jit``, has no counterpart in eager PyTorch, and no cuDNN
    setting is touched."""
    if not enable:
        logging.warning("boost disabled: autograd anomaly detection on — "
                        "slow")
    torch.autograd.set_detect_anomaly(not enable)


def seed(value: int = 42, deterministic: bool = True) -> torch.Generator:
    """Seed Python, numpy and torch; return a CPU ``torch.Generator``
    seeded with ``value`` (the JAX package returns the root PRNG key).

    ``deterministic`` is accepted for the call signature the reference's
    examples use and is a no-op, as in the JAX package (``utils.py:105``):
    it sets no global switch (neither ``use_deterministic_algorithms`` nor
    ``CUBLAS_WORKSPACE_CONFIG``), so a recipe that seeds does not make ops
    without a deterministic CUDA implementation raise."""
    del deterministic
    random.seed(value)
    np.random.seed(value)
    torch.manual_seed(value)
    return torch.Generator().manual_seed(value)


def detach(*trees: Any) -> Any:
    """Cut gradients (JAX ``utils.py:145``): each tree's tensors
    detached; one argument gives its value, several a tuple."""
    out = tuple(_tree_map(lambda t: t.detach()
                          if isinstance(t, torch.Tensor) else t, a)
                for a in trees)
    return out[0] if len(out) == 1 else out


def to_array(data: Any, dtype: Any = None) -> Any:
    """Lists, dicts and namedtuples of numbers → numpy arrays (JAX
    ``utils.py:152``), a dict's or namedtuple's fields one by one."""
    if hasattr(data, "_asdict"):
        data = data._asdict()
    if isinstance(data, dict):
        return {k: to_array(v, dtype) for k, v in data.items()}
    arr = np.asarray(data)
    if dtype is not None:
        arr = arr.astype(dtype)
    return arr


def stack_dictionaries(dicts: Sequence[dict]) -> dict:
    """A list of dicts → a dict of stacked numpy arrays, keyed by the
    first dict's keys (JAX ``utils.py:166``)."""
    if not dicts:
        return {}
    return {key: np.stack([to_array(d[key]) for d in dicts])
            for key in dicts[0]}


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
    state's ``grad_acc`` tree). ``comms`` holds this rank's gradient
    communication state, the int8 error-feedback residuals (JAX
    ``TrainState.comms``; ``comms.GradComms.create_state`` fills it).
    Under a ZeRO schedule the optimizer runs over this rank's flat shard
    of the parameters, and at stage 3 ``params`` is that shard.

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
    comms: Any = None

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

    def replace(self, **changes: Any) -> "TrainState":
        """A new state with ``changes`` over this one's fields (the JAX
        state's ``replace``); the fields not named are shared."""
        return replace(self, **changes)

    def state_dict(self) -> dict:
        """Live references to what a checkpoint holds: parameters, the
        optimizer's state dict, the step, the generator's state and the
        EMA tree. ``callbacks.SaveCallback`` copies it to the host."""
        return {"params": _tree_map(torch.Tensor.detach, self.params),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step,
                "generator": None if self.generator is None
                else self.generator.get_state(),
                "ema": self.ema, "comms": self.comms}

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
        if self.comms:
            for key, value in self.comms.items():
                value.copy_(state["comms"][key])


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
    (mixed precision over fp32 masters).

    Across ranks (JAX ``utils.make_step``): with ``mesh`` the gradient
    is the mean over the ranks of the token axes (the data axes and
    ``sp``: each rank's loss is the mean over its rows and sequence
    chunk, so that is the global token mean), all-reduced at the update
    boundary, and the loss and aux metrics are averaged over the same
    ranks. Over ``ep`` the tokens replicate and nothing is reduced.
    ``rules`` (with ``mesh``) gathers each leaf the rule table shards
    over ``fsdp`` before the loss and reduce-scatters its gradient back
    (place the state with ``EnvConfig.make(state, rules=...)``); a leaf
    sharded over ``ep``, ``tp`` or ``pp`` stays this rank's block (its
    experts, its Megatron slice, its stage's layers) and keeps its own
    gradient, and a leaf those axes replicate gets its whole gradient on
    every rank from the model itself (``GPT.apply``), with no all-reduce
    over them. Clipping then sums the norm over the shards, each counted
    once.
    ``comms`` (a ``GradComms`` / ``CommsSchedule``, states from its
    ``create_state``) replaces the all-reduce: ``fp32``/``bf16``/``int8``
    explicit syncs through ``comms.quantized.reduce_flat``, ZeRO-1 through
    ``comms.zero.sharded_update`` and stages 2-3 through
    ``comms.schedule.sharded_step``, with clipping by the global norm
    over the shards (one all-reduce). Explicit comms need replicated
    parameters (no ``rules``), ZeRO does not compose with accumulation,
    and stage 2 or above needs a state with a flat sharded optimizer."""
    accumulate = accumulate_every > 1
    if rules is not None and mesh is None:
        raise ValueError("make_step(rules=...) needs mesh= as well")
    explicit = comms is not None and comms.mode != "implicit"
    zero1 = bool(comms is not None and comms.zero1)
    stage = int(getattr(comms, "stage", 1 if zero1 else 0)) \
        if comms is not None else 0
    if (explicit or zero1) and rules is not None:
        raise ValueError(
            "make_step(comms=...) explicit modes / zero1 need fully "
            "replicated params — rules= is the model-parallel path; "
            "use comms mode: implicit with it")
    if zero1 and accumulate:
        raise ValueError(
            "comms zero1 does not compose with accumulate_every > 1 "
            "(the accumulator would need the scatter layout); "
            "accumulate on the implicit path instead")
    if comms is None and mesh is not None and not mesh.distributed:
        # one process without a group: every leaf is whole and local,
        # there is nothing to gather or to sync
        mesh = rules = None
    sync_mesh = comms.mesh if comms is not None else mesh
    noises: dict = {}

    def noise_for(device: torch.device) -> Any:
        from torchbooster_tpu_torch.comms.quantized import NoiseSource

        key = str(device)
        if key not in noises:
            noises[key] = NoiseSource(device)
        return noises[key]

    def diff_fn(params: Any, batch: Any, generator: Any) -> Any:
        if compute_dtype is not None:
            # cast inside the differentiated function: the gradients
            # flow back through the casts onto the fp32 masters
            params = _cast_batch(params, compute_dtype)
        return loss_fn(params, batch, generator)

    def set_lr(state: TrainState) -> None:
        lr = tx.learning_rate(state.step // accumulate_every)
        for group in state.optimizer.param_groups:
            group["lr"] = lr

    def update_ema(state: TrainState) -> None:
        d = min(ema_decay, (1.0 + state.step) / (10.0 + state.step))
        with torch.no_grad():
            for e, p in zip(tree_leaves(state.ema),
                            tree_leaves(state.params)):
                e.mul_(d).add_(p, alpha=1.0 - d)

    def finish(state: TrainState, loss: torch.Tensor, aux: dict,
               boundary: bool = True) -> tuple[TrainState, dict]:
        if ema_decay is not None and state.ema is not None and boundary:
            update_ema(state)
        state.step += 1
        return state, {"loss": loss.detach(),
                       **{k: v.detach() if isinstance(v, torch.Tensor)
                          else v for k, v in aux.items()}}

    def step_fn(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        if accumulate and not state.grad_acc:
            raise ValueError("accumulate_every > 1 needs a state created "
                             "with accumulate=True")
        if compute_dtype is not None:
            batch = _cast_batch(batch, compute_dtype)
        if stage >= 2:
            from torchbooster_tpu_torch.comms.schedule import sharded_step

            set_lr(state)
            loss, aux = sharded_step(
                comms, diff_fn, tx, clip, state, batch, has_aux=has_aux,
                noise=noise_for(sync_mesh.device))
            return finish(state, loss, aux)
        if explicit:
            from torchbooster_tpu_torch.comms.quantized import (
                value_and_grad_sync,
            )

            # the micro-steps' synced sum so far, apart from this step's
            # local gradients
            held = [p.grad for p in tree_leaves(state.params)]
            for p in tree_leaves(state.params):
                p.grad = None
            (loss, aux), grads, state.comms = value_and_grad_sync(
                diff_fn, state.params, state.comms or {}, batch,
                state.generator, comms, has_aux=has_aux, scatter=zero1,
                step=state.step, noise=noise_for(sync_mesh.device))
            if not zero1:
                _grads_from_flat(state.params, grads, held)
        else:
            loss, aux = _local_grads(diff_fn, state, batch, has_aux, mesh,
                                     rules)
            if sync_mesh is not None:
                from torchbooster_tpu_torch.comms.quantized import (
                    mean_metrics,
                )

                axes = sync_mesh.token_axes()
                loss, aux = mean_metrics(loss.detach(), aux,
                                         sync_mesh.group(axes),
                                         sync_mesh.axes_size(axes))
        boundary = (state.step + 1) % accumulate_every == 0
        if not explicit and sync_mesh is not None and boundary:
            _sync_grads(state.params, sync_mesh)
        if zero1:
            from torchbooster_tpu_torch.comms.quantized import ravel
            from torchbooster_tpu_torch.comms.zero import sharded_update
            from torchbooster_tpu_torch.parallel.sharding import (
                tree_flatten,
            )

            if not explicit:
                leaves = [p for _, p in tree_flatten(state.params)]
                grads = ravel([p.grad if p.grad is not None
                               else torch.zeros_like(p) for p in leaves],
                              comms.padded_size(sum(p.numel()
                                                    for p in leaves)))
                for p in leaves:
                    p.grad = None
            set_lr(state)
            sharded_update(tx, comms, clip, grads, state.optimizer,
                           state.params, scattered=explicit)
            return finish(state, loss, aux)
        if boundary:
            leaves = tree_leaves(state.params)
            if accumulate:
                for p in leaves:
                    if p.grad is not None:
                        p.grad.div_(accumulate_every)
            if clip is not None:
                if mesh is not None and any(
                        any(e is not None for e in _spec(p)) for p in leaves):
                    _clip_sharded(leaves, clip, mesh)
                else:
                    torch.nn.utils.clip_grad_norm_(leaves, clip)
            tx.clip_units(state.params)
            set_lr(state)
            state.optimizer.step()
            # every leaf, not only the optimizer's: a frozen leaf
            # (``freeze``) gets a gradient too, which must not pile up
            for p in leaves:
                p.grad = None
        return finish(state, loss, aux, boundary)

    return step_fn


def _spec(leaf: torch.Tensor) -> tuple:
    """The spec ``parallel.sharding`` recorded on a sharded leaf (``()``:
    replicated)."""
    return getattr(leaf, "spec", ())


def _local_grads(diff_fn: Callable, state: TrainState, batch: Any,
                 has_aux: bool, mesh: Any, rules: Any
                 ) -> tuple[torch.Tensor, dict]:
    """Forward and backward on this rank's batch; with ``rules`` each
    sharded leaf is gathered to full first, its gradient reduce-scattered
    back onto the leaf."""
    params = state.params
    if rules is not None:
        from torchbooster_tpu_torch.parallel.sharding import (
            gather_leaf,
            loss_spec,
            make_param_specs,
            tree_get,
            tree_map_with_path,
        )

        shapes = _tree_map(lambda p: torch.empty(
            getattr(p, "global_shape", p.shape), device="meta"), params)
        specs = make_param_specs(shapes, rules, mesh=mesh)

        def full(path: tuple, leaf: torch.Tensor) -> torch.Tensor:
            spec = tree_get(specs, path)
            if any(e is not None for e in spec) and _spec(leaf) != spec:
                raise ValueError(
                    f"make_step(rules=...): leaf {'/'.join(map(str, path))}"
                    f" is not laid out by the rules; place the state with "
                    f"EnvConfig.make(state, rules=...) first")
            return gather_leaf(leaf, loss_spec(spec), mesh)

        params = tree_map_with_path(full, params)
    loss, aux = _split(diff_fn(params, batch, state.generator), has_aux)
    loss.backward()
    return loss, aux


@torch.no_grad()
def _sync_grads(params: Any, mesh: Any) -> None:
    """The implicit path's gradient sync: each leaf's gradient summed over
    the token axes it replicates over (one coalesced all-reduce per set
    of axes), then divided by the number of token shards — the mean
    over the global batch's tokens."""
    from torchbooster_tpu_torch.distributed import all_reduce
    from torchbooster_tpu_torch.parallel.sharding import replication_axes

    n = mesh.axes_size(mesh.token_axes())
    by_axes: dict[tuple, list] = {}
    for p in tree_leaves(params):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_axes.setdefault(replication_axes(_spec(p), mesh), []).append(p)
    for axes, leaves in by_axes.items():
        # one group over the set where the mesh keeps one, else one axis
        # of size above 1 at a time (e.g. dp and sp beside an fsdp axis
        # the leaf is sharded over): the sums compose
        group = mesh.group(axes) if axes else None
        groups = [group] if group is not None else [
            mesh.group((a,)) for a in axes if mesh.shape[a] > 1]
        if groups:
            flat = torch.cat([p.grad.reshape(-1) for p in leaves])
            for group in groups:
                all_reduce(flat, group)
            off = 0
            for p in leaves:
                p.grad.copy_(flat[off:off + p.numel()].reshape(p.shape))
                off += p.numel()
        if n > 1:
            for p in leaves:
                p.grad.div_(n)


@torch.no_grad()
def _clip_sharded(leaves: list, clip: float, mesh: Any) -> None:
    """Global-norm clipping when some leaves are sharded: the sums of
    squares of the blocks add up over the axes they are sharded over, one
    axis at a time (a leaf replicated over an axis counts once)."""
    from torchbooster_tpu_torch.distributed import all_reduce
    from torchbooster_tpu_torch.parallel.sharding import sharded_dims

    grads = [p for p in leaves if p.grad is not None]
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    by_axes: dict[tuple, torch.Tensor] = {}
    for p in grads:
        axes = tuple(a for a in mesh.axis_names
                     if a in {a for _, ax in sharded_dims(_spec(p))
                              for a in ax})
        sq = p.grad.float().square().sum()
        by_axes[axes] = by_axes.get(axes, 0) + sq
    for axes, sq in sorted(by_axes.items()):
        for axis in axes:
            all_reduce(sq, mesh.group((axis,)))
        total = total + sq
    scale = torch.clamp(clip / (total.sqrt() + 1e-6), max=1.0)
    for p in grads:
        p.grad.mul_(scale)


@torch.no_grad()
def _grads_from_flat(params: Any, flat: torch.Tensor, held: list) -> None:
    """Write a flat gradient (tree order, padded) into the leaves'
    ``.grad``, added to the gradients ``held`` from earlier micro-steps
    (``tree_leaves`` order; ``None`` where there are none)."""
    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    before = {id(p): g for p, g in zip(tree_leaves(params), held)}
    off = 0
    for _, p in tree_flatten(params):
        g = flat[off:off + p.numel()].reshape(p.shape).to(p.dtype)
        prev = before[id(p)]
        p.grad = g if prev is None else prev.add_(g)
        off += p.numel()


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
    of each call, a ``steps_total`` counter, and a ``span(name)`` around
    the call (a profiler range and a ``span_seconds`` observation). It
    adds no device sync; the card runs asynchronously, so a call's host
    time is its enqueue time and the steady-state mean tracks the
    device's step time. Disabled telemetry costs one attribute check per
    call."""
    from torchbooster_tpu_torch.observability import get_registry, span

    reg = registry if registry is not None else get_registry()
    hist = reg.histogram("step_seconds",
                         "host wall time per train-step dispatch")
    count = reg.counter("steps_total", "train steps dispatched")

    @functools.wraps(step_fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        if not reg.enabled:
            return step_fn(*args, **kwargs)
        t0 = time.perf_counter()
        with span(name, reg):
            out = step_fn(*args, **kwargs)
        hist.observe(time.perf_counter() - t0, step=name)
        count.inc(1, step=name)
        return out

    return wrapped


__all__ = ["Frozen", "TrainState", "annotate", "boost", "detach", "freeze",
           "instrument_step", "iter_loader", "make_eval_step", "make_step",
           "seed", "stack_dictionaries", "to_array", "trace",
           "tree_leaves"]
