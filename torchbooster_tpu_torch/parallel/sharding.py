"""Rule-based parameter partitioning: path regex → spec — the port of
``torchbooster_tpu/parallel/sharding.py``.

A spec is a tuple with one entry per dimension (JAX's ``PartitionSpec``):
``None``, an axis name, or a tuple of axis names. A model ships a list of
``(regex, spec)`` rules; a parameter whose path matches a rule gets that
spec (first match wins), everything else replicates. On the port's
meshes a dimension sharded over ``fsdp`` or ``ep`` is split into
contiguous chunks, one per rank of the axis (``Shard(dim)``), and every
leaf replicates over ``dp`` and ``sp``. ``utils.make_step(mesh=,
rules=)`` gathers an ``fsdp``-sharded leaf to full before the loss and
reduce-scatters its gradient back (JAX's ``_pin`` made explicit); an
``ep``-sharded leaf (a block of experts) is used as it is, by
``models/moe.py``'s expert-parallel path, and keeps its own gradient.

Trees are nested dicts (lists and tuples by index); :func:`tree_flatten`
walks them in the JAX package's order, keys sorted, which is the order
``ravel_pytree`` lays a flat vector out in."""
from __future__ import annotations

import re
from typing import Any, Callable, Sequence

import torch

from torchbooster_tpu_torch.distributed import (
    DATA_AXES,
    UNPORTED_AXES,
    Mesh,
    all_gather,
    reduce_scatter,
    to_env,
)

# axes whose shards a rank computes with as they are (never gathered
# before the loss): the expert axis
LOCAL_AXES = ("ep",)


def P(*entries: Any) -> tuple:
    """A spec: one entry per dimension (``P()`` replicates)."""
    return tuple(entries)


# =========================================================================
# Trees in the JAX package's order
# =========================================================================

def tree_flatten(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in JAX's tree order: dict keys sorted, list
    and tuple entries by index."""
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in tree_flatten(tree[key], prefix + (key,))]
    if isinstance(tree, (tuple, list)):
        return [pair for i, v in enumerate(tree)
                for pair in tree_flatten(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_map_with_path(fn: Callable[[tuple, Any], Any], tree: Any,
                       prefix: tuple = ()) -> Any:
    """Map ``fn(path, leaf)`` over a tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_get(tree: Any, path: tuple) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def path_str(path: tuple) -> str:
    """Render a tree path as ``"a/b/c"`` for regex matching."""
    return "/".join(str(p) for p in path)


# =========================================================================
# Specs
# =========================================================================

def _filter_spec(spec: tuple, mesh_axes: Sequence[str]) -> tuple:
    """Drop axis names not present in the mesh — rules can mention tp/sp
    axes and still work on a plain dp mesh (the one-switch contract)."""

    def keep(entry: Any) -> Any:
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in mesh_axes)
            return kept if kept else None
        return entry if entry in mesh_axes else None

    return tuple(keep(e) for e in spec)


def _entry_axes(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _validate_divisibility(spec: tuple, shape: tuple, mesh: Mesh) -> tuple:
    """A spec entry whose axes do not divide the dimension replicates that
    dimension instead."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    fixed = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            fixed.append(None)
            continue
        size = mesh.axes_size(_entry_axes(entry))
        fixed.append(entry if dim % size == 0 else None)
    return tuple(fixed)


def _check_rule_axes(spec: tuple, mesh: Mesh, name: str) -> None:
    live = sorted({a for e in spec for a in _entry_axes(e)
                   if a in UNPORTED_AXES and mesh.shape.get(a, 1) > 1})
    if live:
        raise NotImplementedError(
            f"sharding rule for {name!r} uses model-parallel axes {live} "
            f"of size > 1, which are not ported yet (ROADMAP.md A-5c)")


def make_param_specs(params: Any, rules: Sequence[tuple[str, tuple]],
                     mesh: Mesh | None = None, default: tuple = P()) -> Any:
    """Map each leaf of ``params`` to a spec via the rule table
    (``re.search`` semantics, first match wins). With ``mesh``, specs are
    filtered to the mesh's axes and an axis that does not divide its
    dimension replicates that dimension."""
    compiled = [(re.compile(pattern), spec) for pattern, spec in rules]
    mesh_axes = tuple(mesh.axis_names) if mesh is not None else None

    def assign(path: tuple, leaf: Any) -> tuple:
        name = path_str(path)
        for pattern, spec in compiled:
            if pattern.search(name):
                if mesh is not None:
                    _check_rule_axes(spec, mesh, name)
                out = _filter_spec(spec, mesh_axes) if mesh_axes else spec
                if mesh is not None and hasattr(leaf, "shape"):
                    out = _validate_divisibility(out, tuple(leaf.shape),
                                                 mesh)
                return out
        return _filter_spec(default, mesh_axes) if mesh_axes else default

    return tree_map_with_path(assign, params)


def sharded_dims(spec: tuple) -> list[tuple[int, tuple[str, ...]]]:
    """``(dim, axes)`` of every dimension the spec shards."""
    return [(d, _entry_axes(e)) for d, e in enumerate(spec) if e is not None]


def make_shardings(specs: Any, mesh: Mesh) -> Any:
    """Spec tree → placement tree: per leaf, ``[("shard", dim, axes), ...,
    ("replicate", axes)]`` — ``Shard(dim)`` over the axes a dimension is
    split over, replication over the mesh's other data axes."""

    def placement(_: tuple, spec: tuple) -> list:
        dims = sharded_dims(spec)
        used = {a for _, axes in dims for a in axes}
        rep = tuple(a for a in mesh.data_axes() if a not in used)
        return [("shard", d, axes) for d, axes in dims] + [("replicate", rep)]

    return tree_map_with_path(placement, specs)


def local_slice(shape: Sequence[int], spec: tuple, mesh: Mesh) -> tuple:
    """The index of this rank's block of a global tensor under ``spec``:
    a contiguous chunk of each sharded dimension, in the axis-major order
    of the dimension's axes."""
    index = [slice(None)] * len(shape)
    for dim, axes in sharded_dims(spec):
        n = mesh.axes_size(axes)
        per = shape[dim] // n
        start = mesh.linear_index(axes) * per
        index[dim] = slice(start, start + per)
    return tuple(index)


def _record(local: torch.Tensor, shape: tuple, spec: tuple,
            index: tuple) -> None:
    """Note on a block its spec, the global shape and where the block
    starts in it (read by ``make_step`` and the sharded checkpoint)."""
    local.global_shape, local.spec = shape, spec
    local.block_start = tuple(sl.start or 0 for sl in index)


def _shard_leaf(leaf: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the full ``leaf`` (already on the rank's
    device), its layout recorded on it."""
    index = local_slice(tuple(leaf.shape), spec, mesh)
    local = leaf.detach()[index].clone().requires_grad_(leaf.requires_grad)
    _record(local, tuple(leaf.shape), spec, index)
    return local


def shard_params(params: Any, mesh: Mesh,
                 rules: Sequence[tuple[str, tuple]],
                 default: tuple = P()) -> Any:
    """Broadcast ``params`` from rank 0 and keep this rank's block of each
    leaf, laid out by the rule table."""
    full = to_env(params, mesh)
    specs = make_param_specs(full, rules, mesh=mesh, default=default)
    return tree_map_with_path(
        lambda path, leaf: _shard_leaf(leaf, tree_get(specs, path), mesh),
        full)


def make_state_specs(state: Any, rules: Sequence[tuple[str, tuple]],
                     mesh: Mesh) -> dict:
    """Specs of a :class:`~torchbooster_tpu_torch.utils.TrainState`: the
    parameters by the rule table; the optimizer's per-parameter state and
    the EMA tree mirror them."""
    param_specs = make_param_specs(state.params, rules, mesh=mesh)
    return {"params": param_specs,
            "ema": param_specs if state.ema is not None else None}


@torch.no_grad()
def shard_state(state: Any, rules: Sequence[tuple[str, tuple]],
                mesh: Mesh) -> Any:
    """Lay a freshly created ``TrainState`` out on the mesh in place:
    each parameter's storage becomes this rank's block (the optimizer
    keeps its references, and builds its state at block size), and any
    optimizer state or EMA leaf of a parameter's full shape is cut the
    same way. Returns the state."""
    specs = make_state_specs(state, rules, mesh)["params"]
    pairs = tree_flatten(state.params)
    emas = tree_flatten(state.ema) if state.ema is not None else None
    for i, (path, p) in enumerate(pairs):
        full = to_env(p.detach(), mesh)
        spec = tree_get(specs, path)
        index = local_slice(tuple(full.shape), spec, mesh)
        shape = tuple(full.shape)
        for value in state.optimizer.state.get(p, {}).values():
            if isinstance(value, torch.Tensor) and tuple(value.shape) == shape:
                value.data = value.data[index].clone()
        p.data = full[index].clone()
        _record(p, shape, spec, index)
        if emas is not None:
            e = emas[i][1]
            e.data = to_env(e.detach(), mesh)[index].clone()
    return state


# =========================================================================
# Gather before the loss, reduce-scatter the gradient back
# =========================================================================

class _GatherDim(torch.autograd.Function):
    """All-gather a leaf's blocks along ``dim`` over ``axes``; the backward
    reduce-scatters (sums) the full gradient back to this rank's block."""

    @staticmethod
    def forward(ctx, local, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        n = mesh.axes_size(axes)
        moved = local.movedim(dim, 0).contiguous()
        out = torch.empty((n * moved.shape[0], *moved.shape[1:]),
                          dtype=local.dtype, device=local.device)
        all_gather(out, moved, mesh.group(axes))
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        n = ctx.mesh.axes_size(ctx.axes)
        moved = grad.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // n, *moved.shape[1:]),
                          dtype=grad.dtype, device=grad.device)
        reduce_scatter(out, moved, ctx.mesh.group(ctx.axes))
        return out.movedim(0, ctx.dim), None, None, None


def gather_leaf(local: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The full tensor of a sharded leaf, differentiable: its gradient
    arrives on ``local`` summed over the ranks of the sharded axes."""
    out = local
    for dim, axes in sharded_dims(spec):
        out = _GatherDim.apply(out, dim, axes, mesh)
    return out


def loss_spec(spec: tuple) -> tuple:
    """The part of ``spec`` gathered before the loss: ``spec`` with the
    :data:`LOCAL_AXES` (``ep``) entries dropped."""
    return tuple(None if set(_entry_axes(e)) & set(LOCAL_AXES) else e
                 for e in spec)


def replication_axes(spec: tuple, mesh: Mesh) -> tuple[str, ...]:
    """The axes a leaf under ``spec`` replicates over that split the
    batch — the data axes and ``sp``: its gradient is summed over them
    after the reduce-scatter. (Over ``ep`` the tokens replicate, and
    every rank already holds its leaves' whole gradient.)"""
    used = {a for _, axes in sharded_dims(spec) for a in axes}
    return tuple(a for a in mesh.token_axes() if a not in used)


__all__ = ["LOCAL_AXES", "P", "gather_leaf", "local_slice", "loss_spec",
           "make_param_specs",
           "make_shardings", "make_state_specs", "path_str",
           "replication_axes", "shard_params", "shard_state",
           "sharded_dims", "tree_flatten", "tree_map_with_path"]
