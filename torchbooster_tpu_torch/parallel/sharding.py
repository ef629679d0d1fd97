"""Rule-based parameter partitioning: path regex → spec — the port of
``torchbooster_tpu/parallel/sharding.py``.

A spec is a tuple with one entry per dimension (JAX's ``PartitionSpec``):
``None``, an axis name, or a tuple of axis names. A model ships a list of
``(regex, spec)`` rules; a parameter whose path matches a rule gets that
spec (first match wins), everything else replicates. A rule may carry a
third entry, ``order(path, shape, spec, mesh, tree)``, the order of the
leaf's last dimension before it is cut (None: as it is). On the port's
meshes a dimension sharded over ``fsdp``, ``ep``, ``tp`` or ``pp`` is
split into contiguous chunks, one per rank of the axis (``Shard(dim)``),
and every leaf replicates over ``dp`` and ``sp``. ``utils.make_step(mesh=,
rules=)`` gathers an ``fsdp``-sharded leaf to full before the loss and
reduce-scatters its gradient back (JAX's ``_pin`` made explicit); a leaf
sharded over ``ep``, ``tp`` or ``pp`` (a block of experts, a Megatron
slice, a stage's layers) is used as it is, by the model's parallel
paths, and keeps its own gradient. A leaf cut in a rule's order (GPT's
qkv columns over ``tp``, rank-major: rank ``i`` holds ``[q_i | k_i |
v_i]``) records the order (``column_perm``), and :func:`full_leaf` and
the sharded checkpoint give the canonical columns back.

Trees are nested dicts (lists and tuples by index); :func:`tree_flatten`
walks them in the JAX package's order, keys sorted, which is the order
``ravel_pytree`` lays a flat vector out in."""
from __future__ import annotations

import re
from typing import Any, Callable, Sequence

import torch

import numpy as np

from torchbooster_tpu_torch.distributed import (
    DATA_AXES,
    MODEL_AXES,
    Mesh,
    all_gather,
    reduce_scatter,
    to_env,
)

# axes whose shards a rank computes with as they are (never gathered
# before the loss): the expert axis, tensor and pipeline parallelism
LOCAL_AXES = ("ep",) + MODEL_AXES


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


def make_param_specs(params: Any, rules: Sequence[tuple[str, tuple]],
                     mesh: Mesh | None = None, default: tuple = P()) -> Any:
    """Map each leaf of ``params`` to a spec via the rule table
    (``re.search`` semantics, first match wins). With ``mesh``, specs are
    filtered to the mesh's axes and an axis that does not divide its
    dimension replicates that dimension."""
    compiled = [(re.compile(rule[0]), rule[1]) for rule in rules]
    mesh_axes = tuple(mesh.axis_names) if mesh is not None else None

    def assign(path: tuple, leaf: Any) -> tuple:
        name = path_str(path)
        for pattern, spec in compiled:
            if pattern.search(name):
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
            index: tuple, perm: np.ndarray | None = None) -> None:
    """Note on a block its spec, the global shape, where the block
    starts in it and, for the qkv columns over tp, their order (read by
    ``make_step`` and the sharded checkpoint)."""
    local.global_shape, local.spec = shape, spec
    local.block_start = tuple(sl.start or 0 for sl in index)
    if perm is not None:
        local.column_perm = perm


def column_order(path: tuple, shape: tuple, spec: tuple, mesh: Mesh,
                 tree: Any, rules: Sequence[tuple]) -> np.ndarray | None:
    """The order of a leaf's last dimension before it is cut: the
    ``order`` of the first rule that matches its path, None without
    one."""
    name = path_str(path)
    for rule in rules:
        if re.search(rule[0], name):
            return rule[2](path, shape, spec, mesh, tree) \
                if len(rule) > 2 else None
    return None


def _cut(full: torch.Tensor, spec: tuple, mesh: Mesh,
         perm: np.ndarray | None) -> tuple[torch.Tensor, tuple]:
    """This rank's block of ``full`` (columns put in ``perm``'s order
    first) and its index."""
    if perm is not None:
        full = full.index_select(-1, torch.as_tensor(perm,
                                                     device=full.device))
    index = local_slice(tuple(full.shape), spec, mesh)
    return full[index].clone(), index


def _shard_leaf(leaf: torch.Tensor, spec: tuple, mesh: Mesh,
                perm: np.ndarray | None = None) -> torch.Tensor:
    """This rank's block of the full ``leaf`` (already on the rank's
    device), its layout recorded on it."""
    local, index = _cut(leaf.detach(), spec, mesh, perm)
    local.requires_grad_(leaf.requires_grad)
    _record(local, tuple(leaf.shape), spec, index, perm)
    return local


def shard_params(params: Any, mesh: Mesh,
                 rules: Sequence[tuple[str, tuple]],
                 default: tuple = P()) -> Any:
    """Broadcast ``params`` from rank 0 and keep this rank's block of each
    leaf, laid out by the rule table."""
    full = to_env(params, mesh)
    specs = make_param_specs(full, rules, mesh=mesh, default=default)

    def one(path: tuple, leaf: torch.Tensor) -> torch.Tensor:
        spec = tree_get(specs, path)
        return _shard_leaf(leaf, spec, mesh, column_order(
            path, tuple(leaf.shape), spec, mesh, full, rules))

    return tree_map_with_path(one, full)


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
        shape = tuple(full.shape)
        perm = column_order(path, shape, spec, mesh, state.params, rules)
        for value in state.optimizer.state.get(p, {}).values():
            if isinstance(value, torch.Tensor) and tuple(value.shape) == shape:
                value.data = _cut(value.data, spec, mesh, perm)[0]
        p.data, index = _cut(full, spec, mesh, perm)
        _record(p, shape, spec, index, perm)
        if emas is not None:
            e = emas[i][1]
            e.data = _cut(to_env(e.detach(), mesh), spec, mesh, perm)[0]
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


def full_leaf(local: torch.Tensor, mesh: Mesh,
              value: torch.Tensor | None = None) -> torch.Tensor:
    """The whole tensor of a block laid out by :func:`shard_params` or
    :func:`shard_state` (or of ``value``, a tensor of the block's layout
    such as its gradient), all-gathered over every axis it is sharded
    over, columns back in canonical order (differentiable, as
    :func:`gather_leaf`)."""
    out = gather_leaf(local if value is None else value,
                      getattr(local, "spec", ()), mesh)
    perm = getattr(local, "column_perm", None)
    if perm is not None:
        out = out.index_select(-1, torch.as_tensor(np.argsort(perm),
                                                   device=out.device))
    return out


def full_tree(tree: Any, mesh: Mesh | None, values: Any = None) -> Any:
    """Every leaf of ``tree`` (laid out by :func:`shard_params` or
    :func:`shard_state`) whole, as :func:`full_leaf` gives it, without
    gradient; with ``values`` (a tree of the same layout, such as the
    EMA) those values whole. Without a distributed mesh the tree (or
    ``values``) comes back as it is. Collective: every rank calls it."""
    if mesh is None or not mesh.distributed:
        return tree if values is None else values
    with torch.no_grad():
        return tree_map_with_path(lambda path, leaf: full_leaf(
            leaf, mesh, None if values is None else tree_get(values, path)),
            tree)


def loss_spec(spec: tuple) -> tuple:
    """The part of ``spec`` gathered before the loss: ``spec`` with the
    :data:`LOCAL_AXES` (``ep``) entries dropped."""
    return tuple(None if set(_entry_axes(e)) & set(LOCAL_AXES) else e
                 for e in spec)


def decode_spec(spec: tuple) -> tuple:
    """The part of ``spec`` gathered before dense decode on a mesh:
    ``spec`` with the entries of its ``tp`` dimensions dropped, which
    stay this rank's Megatron slices (``fsdp``, ``pp`` and ``ep`` are
    gathered whole)."""
    return tuple(None if "tp" in _entry_axes(e) else e for e in spec)


def replication_axes(spec: tuple, mesh: Mesh) -> tuple[str, ...]:
    """The axes a leaf under ``spec`` replicates over that split the
    batch — the data axes and ``sp``: its gradient is summed over them
    after the reduce-scatter. (Over ``ep`` the tokens replicate, and
    every rank already holds its leaves' whole gradient.)"""
    used = {a for _, axes in sharded_dims(spec) for a in axes}
    return tuple(a for a in mesh.token_axes() if a not in used)


__all__ = ["LOCAL_AXES", "P", "column_order", "full_leaf", "full_tree",
           "gather_leaf",
           "decode_spec", "local_slice", "loss_spec",
           "make_param_specs",
           "make_shardings", "make_state_specs", "path_str",
           "replication_axes", "shard_params", "shard_state",
           "sharded_dims", "tree_flatten", "tree_map_with_path"]
