"""Training utilities — the port of ``torchbooster_tpu/utils.py``:
:class:`TrainState`, :func:`make_step` (forward, backward, global-norm
clip, accumulation, the scheduled optimizer update and the EMA ramp),
:func:`make_eval_step`, :func:`freeze`, :func:`seed`, :func:`boost`,
:func:`iter_loader`, :func:`instrument_step`, the tree helpers
:func:`detach`, :func:`to_array` and :func:`stack_dictionaries`, and the
profiler helpers ``trace`` and ``annotate`` (``observability/spans.py``).

The step updates the state IN PLACE (parameters through the optimizer,
the EMA tree in place) and returns it — the counterpart of the JAX
step's donated state. Parameters are a nested dict of leaf tensors (fp32
masters); the loss function casts them to the compute dtype where it
uses them, so their gradients arrive in fp32. On one card the step is a
CUDA graph, captured at the first call of each operand signature and
replayed after (the JAX step's ``jax.jit``, ``_graphs.py``); on the CPU,
with collectives and inside ``_graphs.eager_steps()`` it runs eagerly.

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
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from torchbooster_tpu_torch import _graphs

# the profiler helpers' home is the telemetry layer; ``utils.trace`` is
# the user-facing name, as in the JAX package
from torchbooster_tpu_torch.observability.spans import (  # noqa: F401
    annotate,
    trace,
)


# train steps since import by route: "graph" (a capture or a replay),
# "eager" (the plan's route: the CPU, collectives) and "eager_steps" (a
# step planned "graph" run eagerly inside ``_graphs.eager_steps()``); and
# the captures among the graph steps. ``chip_smoke.py`` reads them to
# report each phase's route.
steps_by_route = {"graph": 0, "eager": 0, "eager_steps": 0}
step_captures = 0


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
    optimizer state and generator in place, so the addresses a captured
    step baked in stay the state's. ``loads`` counts the loads that could
    not keep them (an optimizer state of another layout): a captured
    step drops its graphs when it changes."""

    params: Any
    optimizer: torch.optim.Optimizer
    step: int = 0
    generator: torch.Generator | None = None
    grad_acc: bool = False
    ema: Any = None
    comms: Any = None
    loads: int = field(default=0, repr=False)

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
        """Load a :meth:`state_dict` (host or device tensors) in place.
        The optimizer's state goes into its live tensors where it has the
        same layout; otherwise ``optimizer.load_state_dict`` replaces it
        and ``loads`` counts one."""
        for p, q in zip(tree_leaves(self.params),
                        tree_leaves(state["params"]), strict=True):
            p.copy_(q)
        # the groups keep their own lr objects (a scalar on the card for
        # a captured step), set to the saved values
        lrs = [g["lr"] for g in self.optimizer.param_groups]
        if not _load_optimizer_in_place(self.optimizer, state["optimizer"]):
            self.optimizer.load_state_dict(state["optimizer"])
            self.loads += 1
        for g, lr, h in zip(self.optimizer.param_groups, lrs,
                            state["optimizer"]["param_groups"]):
            if isinstance(lr, torch.Tensor):
                lr.fill_(float(h["lr"]))
                g["lr"] = lr
            else:
                g["lr"] = float(h["lr"])
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


def _load_optimizer_in_place(opt: torch.optim.Optimizer, saved: dict
                             ) -> bool:
    """Copy an optimizer ``state_dict`` into ``opt``'s live state tensors
    when both hold the same entries, shapes and hyperparameters (the
    groups' ``lr`` apart, which the caller sets); returns False, changing
    nothing, otherwise."""
    groups = saved["param_groups"]
    if len(groups) != len(opt.param_groups) or any(
            len(g["params"]) != len(h["params"])
            for g, h in zip(opt.param_groups, groups)):
        return False
    for g, h in zip(opt.param_groups, groups):
        for key, value in h.items():
            if key in ("params", "lr"):
                continue
            live = g.get(key)
            if isinstance(live, torch.Tensor) or isinstance(
                    value, torch.Tensor) or live != value:
                return False
    leaves = [p for g in opt.param_groups for p in g["params"]]
    pairs = []
    for i, p in enumerate(leaves):
        live, want = opt.state.get(p, {}), saved["state"].get(i, {})
        if set(live) != set(want):
            return False
        for key, value in want.items():
            now = live[key]
            if not (isinstance(now, torch.Tensor)
                    and isinstance(value, torch.Tensor)
                    and now.shape == value.shape):
                return False
            pairs.append((now, value))
    for now, value in pairs:
        now.copy_(value)
    return True


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
    and stage 2 or above needs a state with a flat sharded optimizer.

    On one card, without a mesh or ``comms``
    (``_graphs.plan_steps``; ``step.plan(device)`` gives the route and
    why), the step is a CUDA graph: the forward, the backward with the
    remat recompute, the accumulation, the clip, the optimizer update
    and the EMA. Its first call for each operand signature (the batch's
    shapes and dtypes, and whether the call is an update boundary: with
    accumulation the micro-step and the boundary step are two graphs)
    runs the step for real as the warm-up, which also makes the
    optimizer's lazy state, and captures it; later calls copy the batch
    into the signature's staged buffers, write the learning rate and
    the EMA decay into their scalars on the card, replay the graph and
    return metric tensors cloned out of its outputs. ``state.step``
    advances on the host. The optimizer ``tx.init`` built (float lr) is
    put in the form a graph holds at the step's first call on the card
    (``_graph_form``: the lr a scalar on the card, torch's Adam and
    AdamW capturable); a step with collectives leaves it as it is. The graph reads the state where it lies:
    loads in place (:meth:`TrainState.load_state_dict`) keep it, and
    when a state tensor moved or ``state.loads`` changed the step drops
    its graphs and captures again. The generator the loss draws from is
    registered with the graph, so each replay draws afresh, as the eager
    step would. ``step._cache_size()`` counts the captures (the JAX
    step's compile count); ``step.graphs`` holds them. Inside
    ``_graphs.eager_steps()`` the same step runs eagerly, the counterpart
    of ``jax.disable_jit()``; a failed capture raises. Drop the graph of
    an eager backward over the parameters (its loss tensor) before the
    first call: while it lives, their gradient accumulators stay on the
    stream of that backward, which a capture cannot wait on."""
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

    collectives = comms is not None or mesh is not None
    graphs = _StepGraphs()

    def plan(device: Any) -> tuple[str, str]:
        return _graphs.plan_steps(device, collectives=collectives)

    def set_lr(state: TrainState) -> None:
        lr = tx.learning_rate(state.step // accumulate_every)
        for group in state.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    def ema_decay_of(step: int) -> tuple[float, float]:
        # JAX's fp32 ramp: min(decay, (1 + step) / (10 + step)), 1 - d
        d = np.minimum(np.float32(ema_decay),
                       np.float32(1 + step) / np.float32(10 + step))
        return float(d), float(np.float32(1.0) - d)

    @torch.no_grad()
    def update_ema(state: TrainState, d: Any, keep: Any) -> None:
        # e·d + (1 - d)·p, rounded as the JAX step's expression; d and
        # 1 - d are floats, or scalars on the card in a graph
        ema = tree_leaves(state.ema)
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(
            tree_leaves(state.params), keep))

    def finish(state: TrainState, loss: torch.Tensor, aux: dict,
               boundary: bool = True) -> tuple[TrainState, dict]:
        if ema_decay is not None and state.ema is not None and boundary:
            update_ema(state, *ema_decay_of(state.step))
        state.step += 1
        return state, _metrics(loss, aux)

    def update(state: TrainState, leaves: list) -> None:
        """The boundary's update: the accumulated mean, the clip, agc and
        the optimizer step (its lr already written)."""
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
        state.optimizer.step()

    def body(state: TrainState, batch: Any, boundary: bool) -> dict:
        """What the graph holds: one step on the staged batch."""
        leaves = tree_leaves(state.params)
        if graphs.grads:
            for p, g in graphs.grads.items():
                p.grad = g
        if compute_dtype is not None:
            batch = _cast_batch(batch, compute_dtype)
        loss, aux = _local_grads(diff_fn, state, batch, has_aux, None, None)
        if accumulate and graphs.grads is None:
            # the micro-steps' running sum: the warm-up's gradients
            graphs.grads = {p: p.grad for p in leaves if p.grad is not None}
        if boundary:
            update(state, leaves)
            if ema_decay is not None and state.ema is not None:
                update_ema(state, *graphs.decay)
            if graphs.grads:
                torch._foreach_zero_(list(graphs.grads.values()))
            for p in leaves:
                p.grad = None
        return _metrics(loss, aux)

    def operands(state: TrainState, staged: Any, boundary: bool) -> list:
        """The tensors a graph reads: the staged batch, the parameters,
        the gradient buffers, and at a boundary the optimizer's state and
        lr, the EMA and its decay scalars."""
        out = [t for t in tree_leaves(staged) if isinstance(t, torch.Tensor)]
        out += tree_leaves(state.params)
        out += list((graphs.grads or {}).values())
        if boundary:
            for group in state.optimizer.param_groups:
                out += [group["lr"]] + [
                    v for p in group["params"]
                    for v in state.optimizer.state.get(p, {}).values()
                    if isinstance(v, torch.Tensor)]
            if ema_decay is not None and state.ema is not None:
                out += tree_leaves(state.ema) + list(graphs.decay)
        return out

    def graph_step(state: TrainState, batch: Any, leaves: list
                   ) -> tuple[TrainState, dict]:
        device = leaves[0].device
        boundary = (state.step + 1) % accumulate_every == 0
        sig = _signature(batch, device)
        staged = graphs.staged.get(sig)
        if staged is None:
            staged = graphs.staged[sig] = _tree_map(
                lambda x: torch.empty_like(x)
                if isinstance(x, torch.Tensor) else x, batch)
        with torch.no_grad():
            for buf, x in zip(tree_leaves(staged), tree_leaves(batch)):
                if isinstance(x, torch.Tensor):
                    buf.copy_(x, non_blocking=True)
        if boundary:
            set_lr(state)
            if ema_decay is not None and state.ema is not None:
                if graphs.decay is None:
                    graphs.decay = tuple(torch.zeros(
                        (), dtype=torch.float32, device=device)
                        for _ in range(2))
                for t, v in zip(graphs.decay, ema_decay_of(state.step)):
                    t.fill_(v)
        key = (boundary, sig)
        entry = graphs.steps.get(key)
        if entry is not None and (graphs.loads != state.loads or entry.moved(
                operands(state, staged, boundary))):
            graphs.drop()
            entry = None
        graphs.bind_grads(leaves, accumulate)
        if entry is None:
            gen = state.generator
            entry, metrics = _graphs.capture(
                lambda: body(state, staged, boundary),
                lambda: operands(state, staged, boundary),
                generators=[gen] if gen is not None
                and gen.device.type == "cuda" else [],
                pool=graphs.pool)
            graphs.add(key, entry, state.loads)
        else:
            metrics = {k: v.clone() if isinstance(v, torch.Tensor) else v
                       for k, v in entry.replay().items()}
        if accumulate:
            graphs.grads_zero = boundary
            for p, g in (graphs.grads or {}).items():
                p.grad = None if boundary else g
        state.step += 1
        return state, metrics

    def step_fn(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        if accumulate and not state.grad_acc:
            raise ValueError("accumulate_every > 1 needs a state created "
                             "with accumulate=True")
        leaves = tree_leaves(state.params)
        route = plan(leaves[0].device)[0] if leaves else "eager"
        if route == "graph":
            # the optimizer a graph can hold, for the captured step and
            # for the same step inside eager_steps() alike
            _graph_form(state.optimizer, leaves[0].device)
        if _graphs.captured(route):
            steps_by_route["graph"] += 1
            return graph_step(state, batch, leaves)
        steps_by_route["eager" if route == "eager" else "eager_steps"] += 1
        # an eager step may leave anything in the gradient buffers
        graphs.grads_zero = False
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
            set_lr(state)
            update(state, leaves)
            # every leaf, not only the optimizer's: a frozen leaf
            # (``freeze``) gets a gradient too, which must not pile up
            for p in leaves:
                p.grad = None
        return finish(state, loss, aux, boundary)

    step_fn.plan = plan
    step_fn.graphs = graphs
    step_fn._cache_size = lambda: graphs.captures
    return step_fn


@torch.no_grad()
def _graph_form(optimizer: torch.optim.Optimizer, device: torch.device
                ) -> None:
    """Put ``optimizer`` in the form a captured train step holds, in
    place (once; a later call finds it so): every group's ``lr`` an fp32
    scalar on ``device``, which the step writes before each update (a
    float would be baked into the graph), and torch's Adam and AdamW
    ``capturable`` over the multi-tensor update, their update counts on
    ``device``, so that no bias correction is read back to the host.
    The port's optimizers (``optim.py``) take either lr as they are."""
    for group in optimizer.param_groups:
        lr = group["lr"]
        if not (isinstance(lr, torch.Tensor) and lr.device == device):
            group["lr"] = torch.tensor(float(lr), dtype=torch.float32,
                                       device=device)
        if "capturable" in group and not group["capturable"]:
            group.update(capturable=True, foreach=True)
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                if isinstance(state.get("step"), torch.Tensor):
                    state["step"] = state["step"].to(device, torch.float32)


def _metrics(loss: torch.Tensor, aux: dict) -> dict:
    return {"loss": loss.detach(),
            **{k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in aux.items()}}


def _signature(batch: Any, device: torch.device) -> tuple:
    """A batch's operand signature: its tree, and each leaf's shape and
    dtype (a tensor, which must lie on ``device``) or value (a Python
    scalar or string, which the graph bakes in)."""
    if isinstance(batch, dict):
        return ("dict", tuple((k, _signature(v, device))
                              for k, v in batch.items()))
    if isinstance(batch, (tuple, list)):
        return (type(batch).__name__,
                tuple(_signature(v, device) for v in batch))
    if isinstance(batch, torch.Tensor):
        if batch.device != device:
            raise ValueError(
                f"the captured train step takes the batch on the "
                f"parameters' device {device}, not {batch.device}")
        return ("tensor", tuple(batch.shape), batch.dtype)
    if batch is None or isinstance(batch, (bool, int, float, str)):
        return ("value", batch)
    raise TypeError(f"the captured train step takes a batch of tensors "
                    f"and Python scalars, not {type(batch).__name__}")


class _StepGraphs:
    """The CUDA graphs of one train step (:func:`make_step`): each
    signature's captured step and staged batch, the memory pool they
    share (one graph runs at a time), and the state they were captured
    against (``loads``). With accumulation, ``grads`` are the leaves'
    gradient buffers the graphs accumulate into (zero after a boundary:
    ``grads_zero``)."""

    def __init__(self):
        self.steps: dict = {}
        self.staged: dict = {}
        self.pool = None
        self.loads = 0
        self.captures = 0
        self.grads: dict | None = None
        self.grads_zero = True
        self.decay: tuple | None = None

    @property
    def replays(self) -> int:
        return sum(step.replays for step in self.steps.values())

    def add(self, key: tuple, step: Any, loads: int) -> None:
        global step_captures
        self.steps[key] = step
        self.pool = step.graph.pool()
        self.loads = loads
        self.captures += 1
        step_captures += 1

    def drop(self) -> None:
        """Forget every graph (the next call captures again); the staged
        batches stay, the same for any state."""
        self.steps.clear()
        self.pool = None
        self.grads = None
        self.grads_zero = True

    def bind_grads(self, leaves: list, accumulate: bool) -> None:
        """Point the leaves' ``.grad`` at the buffers the graphs
        accumulate into, holding the running sum the leaves carry (an
        eager micro-step's, or none)."""
        if not accumulate:
            if any(p.grad is not None for p in leaves):
                raise ValueError("the captured train step takes leaves "
                                 "without gradients (.grad None)")
            return
        for p, g in (self.grads or {}).items():
            if p.grad is g:
                continue
            if p.grad is not None:
                g.copy_(p.grad)
            elif not self.grads_zero:
                g.zero_()
            p.grad = g


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
