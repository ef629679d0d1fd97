"""Pipeline parallelism: the GPipe schedule over a ``pp`` mesh axis — the
port of ``torchbooster_tpu/parallel/pipeline.py``.

Layer-stacked parameters split their leading axis over ``pp``: stage
``i`` holds ``L/P`` contiguous layers. The batch splits into ``m``
microbatches; at tick ``t`` stage ``i`` runs microbatch ``t - i`` through
its layers (:func:`stage_tick`), and every stage's result rotates to
stage ``i + 1`` (``distributed.diff_ppermute``, whose backward rotates
the gradient back). The last stage banks each finished microbatch, and
one all-reduce over ``pp`` broadcasts the output (its backward is the
identity, so dL/dout comes back once, on the last stage). The bubble is
the usual ``P - 1`` ticks.

The JAX package runs the schedule as one SPMD program, so every stage
computes on every tick and masks the inactive results; here each rank
is a process of its own and skips its layers on an inactive tick (the
result is the same), but it still takes part in every tick's rotation,
forward and backward: each rotated tensor feeds a zero-weighted term of
the output, so the backward of every rotation runs on every rank, in the
order of the ticks, and no rank waits on a partner that skipped one.

Each rank's ``x`` is its own rows of the batch (``distributed.shard_batch``).
The JAX package's microbatch ``j`` is rows ``[j·B/m, (j+1)·B/m)`` of the
global batch, split over the data shards; with ``dp`` and ``m`` both
above 1 the schedule first hands every rank its shard of each such
microbatch (one all-gather over the data axes, and one to hand the
output back), so that a layer that reads the microbatch index
(``with_mb_index``, per-microbatch dropout) sees it on JAX's rows. (A
layer that depends only on its block of rows, as MoE's per-microbatch
capacity does, sees the same aligned blocks of ``B/(m·n)`` rows either
way.)"""
from __future__ import annotations

from typing import Any, Callable

import torch

from torchbooster_tpu_torch import distributed as dist


def _default_microbatches(batch: int, n_stages: int,
                          dp_size: int) -> int:
    """The deepest schedule the batch supports, up to 4 stages' worth
    (``pipeline.py:61``): 4P, 3P or 2P microbatches where the batch and
    each microbatch's split over the data axes divide, else P."""
    for mult in (4, 3, 2):
        m = mult * n_stages
        if batch % m == 0 and (batch // m) % dp_size == 0:
            return m
    return n_stages


def stage_runner(layer_fn: Callable[..., Any], layers: Any,
                 with_mb_index: bool = False,
                 with_aux: bool = False) -> Callable:
    """``run_stage(h, mb) -> (y, aux)``: a stage's ``layers`` (a stacked
    tree, its leading axis the stage's layers) one after another on
    microbatch ``mb``, ``aux`` the sum of the layers' aux losses (0
    without ``with_aux``)."""
    from torchbooster_tpu_torch.utils import _tree_map, tree_leaves

    n_layers = tree_leaves(layers)[0].shape[0]

    def run_stage(h: torch.Tensor, mb: int):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for j in range(n_layers):
            layer = _tree_map(lambda leaf: leaf[j], layers)
            h = layer_fn(layer, h, mb) if with_mb_index else layer_fn(layer, h)
            if with_aux:
                h, layer_aux = h
                aux = aux + layer_aux
        return h, aux

    return run_stage


def stage_tick(run_stage: Callable, stage: int, n_stages: int,
               x_mb: list, received: torch.Tensor | None,
               t: int) -> tuple[torch.Tensor, Any, int | None]:
    """One tick of stage ``stage`` of ``n_stages``: its input is a fresh
    microbatch (stage 0, clipped to the last) or what it ``received``
    over the ring; microbatch ``t - stage`` runs through the stage's
    layers, ``run_stage(x, mb) -> (y, aux)``, when it exists, and the
    input passes on untouched otherwise. Returns ``(y, aux, mb)``, with
    ``aux`` and ``mb`` None on an inactive tick. :func:`pipeline_apply`
    composes it with the ``pp`` group; a caller can compose it with a
    rotation of its own, as one process holding every stage."""
    m = len(x_mb)
    mb = t - stage
    x_in = x_mb[min(t, m - 1)] if stage == 0 else received
    if not 0 <= mb < m:
        return x_in, None, None
    y, aux = run_stage(x_in, mb)
    return y, aux, mb


def run_schedule(stages: dict, n_stages: int, x_mb: list,
                 rotate: Callable[[dict], dict]) -> tuple[list, torch.Tensor]:
    """The GPipe ticks of the stages this process holds, ``{stage:
    run_stage}``: on every tick each runs :func:`stage_tick`, and
    ``rotate({stage: result})`` gives what each holds for the next tick
    (the ring's rotation). Returns the last stage's outputs by
    microbatch (None where this process does not hold it) and the sum of
    the active ticks' aux."""
    m = len(x_mb)
    # what a stage past the first holds before tick 0: zeros that depend
    # on x, so that x's gradient on every stage arrives through the
    # backward of the first rotation, after every other one (a
    # collective on x's gradient then runs in the same order everywhere)
    held = {i: 0 * x_mb[0] for i in stages}
    bank: list = [None] * m
    aux_sum = torch.zeros((), dtype=torch.float32, device=x_mb[0].device)
    n_ticks = m + n_stages - 1
    for t in range(n_ticks):
        ys = {}
        for i, run_stage in stages.items():
            y, aux, mb = stage_tick(run_stage, i, n_stages, x_mb, held[i], t)
            if mb is not None:
                aux_sum = aux_sum + aux
                if i == n_stages - 1:
                    bank[mb] = y
            ys[i] = y
        if t < n_ticks - 1:
            held = rotate(ys)
    return bank, aux_sum


def microbatch_rows(mb: int, m: int, rows: int, n_data: int = 1,
                    index: int = 0) -> torch.Tensor:
    """The global batch rows that microbatch ``mb`` of ``m`` holds on
    data shard ``index`` of ``n_data``, each shard holding ``rows`` rows
    of the batch: JAX's microbatch ``mb`` is rows ``[mb·B/m, (mb+1)·B/m)``
    of the ``B = rows·n_data``, split over the shards."""
    u = rows // m
    start = (mb * n_data + index) * u
    return torch.arange(start, start + u)


def _regroup(x: torch.Tensor, group: Any, n: int, me: int, m: int,
             to_mb: bool) -> torch.Tensor:
    """``to_mb``: this rank's contiguous block of the batch (shard ``me``
    of ``n``) becomes its shards of the ``m`` microbatches, in order
    (:func:`microbatch_rows`); else the inverse. One all-gather over the
    data axes."""
    b, rest = x.shape[0], x.shape[1:]
    full = torch.empty((n * b, *rest), dtype=x.dtype, device=x.device)
    dist.all_gather(full, x.contiguous(), group)
    u = b // m
    if to_mb:
        # the global rows as (microbatch, shard, row): keep this shard's
        return full.reshape(m, n, u, *rest)[:, me].reshape(b, *rest) \
            .contiguous()
    # every shard's (microbatch, row) blocks back in global order
    rows = full.reshape(n, m, u, *rest).transpose(0, 1).reshape(n * b, *rest)
    return rows[me * b:(me + 1) * b].contiguous()


class _Regroup(torch.autograd.Function):
    """:func:`_regroup`, whose backward is the inverse permutation of the
    global rows."""

    @staticmethod
    def forward(ctx, x, group, n, me, m, to_mb):
        ctx.args = (group, n, me, m, not to_mb)
        return _regroup(x, group, n, me, m, to_mb)

    @staticmethod
    def backward(ctx, grad):
        return _regroup(grad, *ctx.args), None, None, None, None, None


def _check_x_spec(x_spec: tuple, axis: str) -> None:
    if len(x_spec) and x_spec[0] is not None:
        raise ValueError(
            f"x_spec {x_spec} shards the leading (microbatch) axis; it "
            "must stay unsharded")
    for entry in x_spec:
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        if axis in axes:
            raise ValueError(
                f"x_spec {x_spec} shards over the pipeline axis {axis!r}; "
                "activations must replicate across it")


def _local_params(stacked: Any, mesh: Any, specs: Any) -> Any:
    """This rank's slice of a global stacked tree under ``specs``."""
    from torchbooster_tpu_torch.parallel.sharding import (
        _filter_spec,
        local_slice,
        tree_get,
        tree_map_with_path,
    )

    def cut(path: tuple, leaf: torch.Tensor) -> torch.Tensor:
        spec = _filter_spec(tree_get(specs, path), mesh.axis_names)
        return leaf[local_slice(tuple(leaf.shape), spec, mesh)]

    return tree_map_with_path(cut, stacked)


def pipeline_apply(
    layer_fn: Callable[..., Any],
    stacked_params: Any,
    x: torch.Tensor,
    mesh: Any,
    axis: str = "pp",
    n_microbatches: int | None = None,
    batch_axes: tuple[str, ...] | None = None,
    with_mb_index: bool = False,
    with_aux: bool = False,
    param_specs: Any | None = None,
    x_spec: tuple | None = None,
    aux_axes: tuple[str, ...] = (),
    params_local: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Run ``layer_fn`` over ``L`` stacked layers, pipelined over the
    mesh's ``axis`` (``pipeline.py:76``).

    ``layer_fn(layer_params, x) -> x`` applies ONE layer, a slice of the
    leading axis of ``stacked_params``. ``x`` is this rank's block of the
    batch, ``(b, ...)``; it splits into ``n_microbatches`` (default: up
    to 4× the pipeline depth, :func:`_default_microbatches`, counted on
    the global batch ``b × data shards``) along dimension 0. ``L`` must
    divide by the ``axis`` size.

    ``with_mb_index=True`` calls ``layer_fn(layer_params, x, mb)`` with
    the microbatch's index. ``with_aux=True``: ``layer_fn`` also returns
    a scalar aux loss, and ``(out, aux)`` comes back, aux the sum over
    layers of the mean over microbatches, averaged over the batch axes
    and ``aux_axes`` (axes over which the layer's aux is a local
    estimator, e.g. ``sp`` with per-shard MoE routing). Its gradient
    is JAX's: the stages' sum reaches each stage once, and the mean over
    the batch and ``aux_axes`` ranks goes through ``all_reduce_sum``,
    whose backward sums, for ``make_step``'s mean over the token axes.

    ``param_specs`` (default ``P(axis)`` on every leaf) says how the
    global ``stacked_params`` split over the mesh; this rank takes its
    slice. ``params_local=True``: they are this rank's slices already.
    ``x_spec`` is checked as the JAX package checks it: its leading
    (microbatch) entry must be None and no entry may name ``axis``.

    Returns this rank's block of the output, equal (up to float
    reassociation) to running the layers one after another — except for
    layers whose math depends on batch statistics, which see one
    microbatch at a time."""
    from torchbooster_tpu_torch.parallel.sharding import P
    from torchbooster_tpu_torch.utils import _tree_map, tree_leaves

    pp = mesh.axis(axis)
    group, n_stages, stage = pp if pp is not None else (None, 1, 0)
    if batch_axes is None:
        batch_axes = tuple(a for a in ("dp", "fsdp")
                           if a in mesh.axis_names and a != axis)
    dp_size = mesh.axes_size(batch_axes)
    batch = x.shape[0] * dp_size
    m = n_microbatches or _default_microbatches(batch, n_stages, dp_size)
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    if (batch // m) % dp_size:
        raise ValueError(
            f"microbatch size {batch // m} not divisible by data-axes "
            f"product {dp_size} ({batch_axes})")
    if x_spec is not None:
        _check_x_spec(tuple(x_spec), axis)
    n_layers = tree_leaves(stacked_params)[0].shape[0] \
        * (n_stages if params_local else 1)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by "
                         f"{n_stages} pipeline stages")
    if not params_local:
        specs = param_specs if param_specs is not None else _tree_map(
            lambda _: P(axis), stacked_params)
        stacked_params = _local_params(stacked_params, mesh, specs)
    data = None
    if dp_size > 1 and m > 1:
        # JAX's microbatches: this rank's shard of each
        data = (mesh.group(batch_axes), dp_size,
                mesh.linear_index(batch_axes), m)
        if data[0] is None:
            raise ValueError(f"the mesh keeps no process group over "
                             f"{batch_axes}")
        x = _Regroup.apply(x, *data, True)
    x_mb = list(x.reshape(m, x.shape[0] // m, *x.shape[1:]).unbind(0))
    rotated: list = []

    def rotate(ys: dict) -> dict:
        if n_stages == 1:
            return ys
        held = dist.diff_ppermute(ys[stage], group, 1)
        rotated.append(held)
        return {stage: held}

    bank, aux_sum = run_schedule(
        {stage: stage_runner(layer_fn, stacked_params, with_mb_index,
                             with_aux)}, n_stages, x_mb, rotate)
    out = torch.stack(bank) if stage == n_stages - 1 \
        else torch.zeros((m, *x_mb[0].shape), dtype=x.dtype,
                         device=x.device)
    if n_stages > 1:
        out = dist.reduce_from_group(out, group)
        # every rotation feeds the output with weight 0, so its backward
        # runs on every rank (stage 0 never reads what it receives)
        out = out + 0 * sum(h.sum() for h in rotated).to(out.dtype)
    out = out.reshape(x.shape)
    if data is not None:
        out = _Regroup.apply(out, *data, False)
    if not with_aux:
        return out
    aux = aux_sum
    if n_stages > 1:
        aux = dist.reduce_from_group(aux, group)
    aux = aux / m
    mean_axes = tuple(a for a in mesh.axis_names
                      if a in tuple(batch_axes) + tuple(aux_axes))
    n = mesh.axes_size(mean_axes)
    if n > 1:
        aux = dist.all_reduce_sum(aux, mesh.group(mean_axes)) / n
    return out, aux


def fold_apply(layer_fn: Callable[..., Any], stacked_params: Any,
               x: torch.Tensor, n_stages: int, n_microbatches: int,
               with_mb_index: bool = False, with_aux: bool = False):
    """The GPipe schedule of ``n_stages`` stages in ONE process:
    :func:`run_schedule` over every stage, the rotation a shift of the
    stages' results in place of the ring. ``stacked_params`` are global;
    stage ``i`` takes layers ``[i·L/P, (i+1)·L/P)``. Its output (and
    aux, the layers' sum of the microbatch mean) equals
    :func:`pipeline_apply`'s over a ``pp`` group of ``n_stages`` ranks."""
    from torchbooster_tpu_torch.utils import _tree_map, tree_leaves

    n_layers = tree_leaves(stacked_params)[0].shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by "
                         f"{n_stages} pipeline stages")
    per, m = n_layers // n_stages, n_microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by {m} "
                         "microbatches")
    x_mb = list(x.reshape(m, x.shape[0] // m, *x.shape[1:]).unbind(0))
    stages = {i: stage_runner(
        layer_fn, _tree_map(lambda leaf, i=i: leaf[i * per:(i + 1) * per],
                            stacked_params), with_mb_index, with_aux)
        for i in range(n_stages)}
    bank, aux_sum = run_schedule(
        stages, n_stages, x_mb,
        lambda ys: {i: ys[(i - 1) % n_stages] for i in ys})
    out = torch.stack(bank).reshape(x.shape)
    return (out, aux_sum / m) if with_aux else out


__all__ = ["fold_apply", "microbatch_rows", "pipeline_apply",
           "run_schedule", "stage_runner", "stage_tick"]
