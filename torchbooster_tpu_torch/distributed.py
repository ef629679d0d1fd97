"""Distributed runtime: rank helpers, named meshes over the ranks, and
placement — the port of ``torchbooster_tpu/distributed.py``.

The JAX package runs one process per host, which drives every local chip
through an SPMD mesh. The port runs one process per device, as the
reference did (``mp.spawn`` + NCCL, SURVEY §2.12): :func:`launch` spawns
the processes and starts a ``torch.distributed`` group (NCCL on the
card, gloo on the CPU), and a :class:`Mesh` names axes over the world's
ranks with one process group per axis. Rank ``r`` sits at flat position
``r`` of the mesh, the position whose rows the JAX package's
``batch_sharding`` gives device ``r``.

Without a process group every helper gives the JAX package's
single-process answer (rank 0 of a world of 1), and a mesh's collectives
act on the one process's tensors. The differentiable collectives at the
end (``diff_ppermute``, ``diff_all_to_all``, ``copy_to_group``,
``reduce_from_group``, ``all_reduce_sum``) carry the model-parallel
layers' gradients across ranks, each backward the transpose of its
forward as in JAX's ``shard_map``: the Megatron pair of tensor
parallelism (``tp``) is ``copy_to_group`` / ``reduce_from_group``, and
the pipeline's (``pp``) ring is ``diff_ppermute``."""
from __future__ import annotations

import logging
import os
import socket
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from torchbooster_tpu_torch.utils import _tree_map

# Data-bearing mesh axes: batches shard over these; parameters replicate
# over dp and shard over fsdp (see parallel.sharding).
DATA_AXES = ("dp", "fsdp")
# Model-parallel axes whose leaves a rank holds as its own slice: tensor
# parallelism splits heads and hidden units, the pipeline the layers
MODEL_AXES = ("tp", "pp")
# Axes a batch's tokens are split over: its rows over the data axes, its
# sequence over sp (JAX ``gpt.batch_spec``: P(("dp", "fsdp"), "sp"))
TOKEN_AXES = DATA_AXES + ("sp",)

_MESH_CACHE: dict[tuple, "Mesh"] = {}


def _initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


# =========================================================================
# Process helpers
# =========================================================================

def get_rank() -> int:
    """Global rank of this process (0 without a process group)."""
    return tdist.get_rank() if _initialized() else 0


def get_local_rank() -> int:
    """Index of this process on its machine: the card it drives (0
    without a process group)."""
    if not _initialized():
        return 0
    return int(os.environ.get("LOCAL_RANK", tdist.get_rank()))


def get_world_size() -> int:
    """Number of processes (1 without a process group)."""
    return tdist.get_world_size() if _initialized() else 1


def get_device_count() -> int:
    """Devices across the world: one per process under a group, else the
    cards this process sees (at least 1, the CPU)."""
    if _initialized():
        return tdist.get_world_size()
    return max(torch.cuda.device_count(), 1)


def is_primary() -> bool:
    """True on rank 0."""
    return get_rank() == 0


def synchronize(name: str = "barrier") -> None:
    """Barrier over the world; a no-op for one process."""
    del name
    if _initialized() and tdist.get_world_size() > 1:
        tdist.barrier()


def gather(data: Any) -> Any:
    """All-gather a tree of host values across processes: every rank gets
    each leaf stacked on a new leading axis of length world size (one
    process: ``leaf[None]``)."""
    if not _initialized() or tdist.get_world_size() == 1:
        return _tree_map(lambda x: np.asarray(x)[None, ...], data)
    host = _tree_map(lambda x: x.detach().cpu().numpy()
                     if isinstance(x, torch.Tensor) else np.asarray(x), data)
    trees: list = [None] * tdist.get_world_size()
    tdist.all_gather_object(trees, host)
    return _tree_stack(trees)


def _tree_stack(trees: list) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return np.stack([np.asarray(t) for t in trees])


def find_free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("", 0))
        return sock.getsockname()[1]


# =========================================================================
# Mesh construction
# =========================================================================

def parse_mesh_spec(spec: str, n_devices: int) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """Parse an axis spec string into (names, sizes).

    Grammar: comma-separated ``name`` or ``name:size`` entries, e.g.
    ``"dp"``, ``"dp:2,tp:4"``, ``"dp,tp:2,sp:2"``. At most one axis may
    omit its size; it absorbs the remaining devices."""
    names: list[str] = []
    sizes: list[int] = []
    unsized: int | None = None
    for entry in (e.strip() for e in spec.split(",")):
        if not entry:
            continue
        if ":" in entry:
            name, _, size_text = entry.partition(":")
            name = name.strip()
            try:
                size = int(size_text)
            except ValueError:
                raise ValueError(
                    f"mesh spec {spec!r}: axis {name!r} has "
                    f"non-integer size {size_text.strip()!r}") from None
            if size <= 0:
                raise ValueError(
                    f"mesh spec {spec!r}: axis {name!r} has "
                    f"non-positive size {size}")
            names.append(name)
            sizes.append(size)
        else:
            if unsized is not None:
                raise ValueError(
                    f"mesh spec {spec!r} has more than one unsized axis")
            names.append(entry)
            sizes.append(-1)
            unsized = len(sizes) - 1
    if not names:
        raise ValueError(f"empty mesh spec {spec!r}")
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise ValueError(
            f"mesh spec {spec!r} repeats axis name(s) {dupes}")
    sized_product = int(np.prod([s for s in sizes if s > 0])) if any(
        s > 0 for s in sizes) else 1
    if unsized is not None:
        if n_devices % sized_product:
            raise ValueError(
                f"mesh spec {spec!r}: {n_devices} devices not divisible by "
                f"sized axes product {sized_product}")
        sizes[unsized] = n_devices // sized_product
    elif sized_product != n_devices:
        raise ValueError(
            f"mesh spec {spec!r} wants {sized_product} devices, "
            f"have {n_devices}")
    return tuple(names), tuple(sizes)


@dataclass(eq=False)
class Mesh:
    """Named axes over the world's ranks: ``shape`` maps each axis to its
    size, rank ``r`` sits at flat (row-major) position ``r``, and
    ``group(axes)`` is this rank's process group over ``axes`` — the
    ranks that share its coordinates on every other axis (``None``
    without a process group). ``device`` is this rank's device."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device: torch.device
    rank: int = 0
    groups: dict = field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def distributed(self) -> bool:
        """True when collectives go through a process group (a world-1
        NCCL group included)."""
        return bool(self.groups)

    def coords(self) -> dict[str, int]:
        """This rank's index on each axis."""
        idx = np.unravel_index(self.rank, self.sizes)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def data_axes(self) -> tuple[str, ...]:
        return tuple(a for a in DATA_AXES if a in self.axis_names)

    def token_axes(self) -> tuple[str, ...]:
        """The axes this rank's tokens are split over: the data axes and
        ``sp`` (each rank holds different tokens over these; over ``ep``
        the tokens replicate)."""
        return tuple(a for a in self.axis_names if a in TOKEN_AXES)

    def axis(self, name: str) -> tuple[Any, int, int] | None:
        """``(group, size, index)`` of axis ``name`` for this rank, or
        None when the mesh lacks it or it has size 1."""
        size = self.shape.get(name, 1)
        if size == 1:
            return None
        return self.group((name,)), size, self.coords()[name]

    def group(self, axes: Sequence[str]) -> Any:
        """The process group over ``axes`` (absent axes dropped)."""
        key = tuple(a for a in self.axis_names if a in axes)
        return self.groups.get(key)

    def axes_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes
                            if a in self.shape] or [1]))

    def linear_index(self, axes: Sequence[str]) -> int:
        """This rank's position in the flattened group over ``axes``,
        axis-major — the order a leading dim sharded over ``axes`` is laid
        out in (JAX ``quantized.linear_index``)."""
        coords, idx = self.coords(), 0
        for a in self.axis_names:
            if a in axes:
                idx = idx * self.shape[a] + coords[a]
        return idx


def _axis_subsets(names: tuple[str, ...]) -> list[tuple[str, ...]]:
    """The axis sets a mesh keeps groups for: each axis alone, the data
    axes together, the token axes (data axes and ``sp``) together, and
    every axis (the world)."""
    subsets = [(a,) for a in names]
    for axes in (tuple(a for a in names if a in DATA_AXES),
                 tuple(a for a in names if a in TOKEN_AXES), names):
        if len(axes) > 1 and axes not in subsets:
            subsets.append(axes)
    return subsets


def _new_groups(names: tuple[str, ...], sizes: tuple[int, ...],
                rank: int) -> dict:
    """One process group per axis set of :func:`_axis_subsets`. Every rank
    creates every group in the same order (``new_group`` is collective);
    a group over the whole world is the default group."""
    world = int(np.prod(sizes))
    positions = np.arange(world).reshape(sizes)
    out: dict = {}
    for axes in _axis_subsets(names):
        keep = [names.index(a) for a in axes]
        other = [i for i in range(len(names)) if i not in keep]
        arr = np.transpose(positions, other + keep).reshape(
            -1, int(np.prod([sizes[i] for i in keep])))
        for ranks in arr.tolist():
            if len(ranks) == world:
                group = tdist.group.WORLD
            else:
                group = tdist.new_group(ranks)
            if rank in ranks:
                out[axes] = group
    return out


def _rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This process's device: the card of its local rank under a group on
    the card, else ``device`` (a card unless the caller passes ``"cpu"``)."""
    from torchbooster_tpu_torch._device import resolve_device

    if _initialized():
        if tdist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        if torch.device(device).type == "cuda":
            # gloo over tensors on the card (ranks that share one card,
            # where NCCL refuses a second rank); raises without a card
            resolve_device(device)
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(spec: str = "dp", n_devices: int = 0,
              device: str | torch.device = "cuda") -> Mesh:
    """A mesh from an axis spec over the world's ranks (one process per
    device). ``n_devices`` (0: the world) must equal the world size.
    Every axis gets its process group: ``tp`` carries the Megatron
    all-reduces, ``pp`` the pipeline's ring."""
    world = get_world_size()
    if n_devices and n_devices != world:
        raise ValueError(
            f"make_mesh({spec!r}, n_devices={n_devices}): the port runs "
            f"one process per device, so a mesh spans the world of "
            f"{world} process(es)")
    names, sizes = parse_mesh_spec(spec, world)
    groups = _new_groups(names, sizes, get_rank()) if _initialized() \
        else {}
    return Mesh(axis_names=names, sizes=sizes, device=_rank_device(device),
                rank=get_rank(), groups=groups)


def get_mesh(env: Any = None, device: str | torch.device = "cuda") -> Mesh:
    """Cached mesh for an :class:`~torchbooster_tpu_torch.config.EnvConfig`
    (or the ``dp`` mesh over the world when ``env`` is None);
    ``distributed: false`` degrades any topology to a one-device ``dp``
    mesh, as in the JAX package."""
    spec = "dp" if env is None or not env.distributed else (env.mesh or "dp")
    world = get_world_size()
    if env is not None and not env.distributed and world > 1:
        raise ValueError("env.distributed is false but this process is "
                         f"one of {world}; set distributed: true")
    key = (spec, world, get_rank(), str(_rank_device(device)),
           tdist.get_backend() if _initialized() else None)
    if key not in _MESH_CACHE:
        _MESH_CACHE[key] = make_mesh(spec, device=device)
    return _MESH_CACHE[key]


def local_devices(mesh: Mesh) -> list[torch.device]:
    """This process's slice of the mesh: its one device."""
    return [mesh.device]


# =========================================================================
# Collectives over a mesh group (identity without a process group)
# =========================================================================

class _Done:
    """The handle of a collective that ran inline."""

    def wait(self) -> bool:
        return True


def _collective(name: str) -> Callable:
    # reduce_scatter_single / all_gather_single are the current names of
    # reduce_scatter_tensor / all_gather_into_tensor, with one signature
    single = {"reduce_scatter": ("reduce_scatter_single",
                                 "reduce_scatter_tensor"),
              "all_gather": ("all_gather_single", "all_gather_into_tensor")}
    new, old = single[name]
    return getattr(tdist, new, None) or getattr(tdist, old)


def all_reduce(t: torch.Tensor, group: Any, async_op: bool = False) -> Any:
    """Sum ``t`` in place over ``group``."""
    if group is None:
        return _Done() if async_op else None
    return tdist.all_reduce(t, group=group, async_op=async_op)


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group: Any,
                   async_op: bool = False) -> Any:
    """``out`` = this rank's chunk of the sum of ``inp`` over ``group``."""
    if group is None:
        out.copy_(inp)
        return _Done() if async_op else None
    return _collective("reduce_scatter")(out, inp, group=group,
                                         async_op=async_op)


def all_gather(out: torch.Tensor, inp: torch.Tensor, group: Any,
               async_op: bool = False) -> Any:
    """``out`` = every rank's ``inp`` concatenated in rank order."""
    if group is None:
        out.copy_(inp)
        return _Done() if async_op else None
    return _collective("all_gather")(out, inp, group=group,
                                     async_op=async_op)


def all_to_all(out: torch.Tensor, inp: torch.Tensor, group: Any,
               async_op: bool = False) -> Any:
    """Chunk ``j`` of ``inp`` goes to rank ``j``; ``out``'s chunk ``i``
    comes from rank ``i``."""
    if group is None:
        out.copy_(inp)
        return _Done() if async_op else None
    return tdist.all_to_all_single(out, inp, group=group, async_op=async_op)


def broadcast(t: torch.Tensor, group: Any, src: int = 0) -> None:
    """Overwrite ``t`` with ``src``'s (a global rank)."""
    if group is not None:
        tdist.broadcast(t, src=src, group=group)


def ppermute(t: torch.Tensor, group: Any, shift: int = 1) -> torch.Tensor:
    """A ring rotation over ``group``: group rank ``i``'s ``t`` goes to
    rank ``(i + shift) % n``, and the result is what rank ``(i - shift) %
    n`` sent (JAX ``lax.ppermute`` with ``perm = [(j, (j + shift) % n)]``),
    one send and one receive through ``batch_isend_irecv``. The tensor
    itself without a group or over one rank."""
    if group is None or tdist.get_world_size(group) == 1:
        return t
    n, me = tdist.get_world_size(group), tdist.get_rank(group)
    src = tdist.get_global_rank(group, (me - shift) % n)
    dst = tdist.get_global_rank(group, (me + shift) % n)
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [tdist.P2POp(tdist.isend, t, dst, group),
           tdist.P2POp(tdist.irecv, out, src, group)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return out


# =========================================================================
# Differentiable collectives (the transposes JAX's shard_map takes)
# =========================================================================

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, shift):
        ctx.group, ctx.shift = group, shift
        return ppermute(t, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return ppermute(grad.contiguous(), ctx.group, -ctx.shift), None, None


def diff_ppermute(t: torch.Tensor, group: Any,
                  shift: int = 1) -> torch.Tensor:
    """:func:`ppermute` whose backward rotates the gradient back."""
    return _PPermute.apply(t, group, shift)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.contiguous()
        out = torch.empty_like(t)
        all_to_all(out, t, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        # empty_like keeps a permuted gradient's strides: copy first
        grad = grad.contiguous()
        out = torch.empty_like(grad)
        all_to_all(out, grad, ctx.group)
        return out, None


def diff_all_to_all(t: torch.Tensor, group: Any) -> torch.Tensor:
    """``t`` is ``(n, ...)``, chunk ``j`` for group rank ``j``; returns
    ``(n, ...)`` with chunk ``i`` from rank ``i`` (``all_to_all_single``,
    the form gloo implements). Its backward is the same exchange."""
    return _AllToAll.apply(t, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        all_reduce(grad, ctx.group)
        return grad, None


def copy_to_group(t: torch.Tensor, group: Any) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``group``.
    For a tensor every rank of ``group`` holds alike and feeds into
    rank-local work: each rank's partial gradient adds up to the whole."""
    return _CopyToGroup.apply(t, group)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_from_group(t: torch.Tensor, group: Any) -> torch.Tensor:
    """Sum over ``group`` forward; identity backward (the partner of
    :func:`copy_to_group`: every rank goes on with the same sum)."""
    return _ReduceFromGroup.apply(t, group)


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        n = tdist.get_world_size(group) if group is not None else 1
        ctx.n, ctx.me = n, tdist.get_rank(group) if group is not None else 0
        t = t.contiguous()
        out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        all_gather(out, t, group)
        return torch.cat(out.chunk(n, dim=0), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, dim=-1)[ctx.me].contiguous(), None


def gather_from_group(t: torch.Tensor, group: Any) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the last dimension, in group
    order; the backward keeps this rank's slice of the gradient (every
    rank of ``group`` goes on with the same concatenation). The
    vocabulary-parallel head's logits."""
    return _GatherFromGroup.apply(t, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        all_reduce(grad, ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group: Any) -> torch.Tensor:
    """JAX ``lax.psum`` under ``shard_map``: sum over ``group`` forward,
    and the gradient summed over ``group`` backward — the derivative of
    the sum of every rank's objective, which each rank's loss is one
    term of across the token axes."""
    return _AllReduceSum.apply(t, group)


# =========================================================================
# Placement
# =========================================================================

def batch_rows(n_rows: int, mesh: Mesh) -> slice:
    """The rows of a global batch this rank holds: its contiguous slice
    along the leading axis, split over the data axes (JAX
    ``batch_sharding``: device ``r`` of the mesh holds slice ``r``)."""
    axes = mesh.data_axes()
    n = mesh.axes_size(axes)
    if n_rows % n:
        raise ValueError(f"batch of {n_rows} rows does not split over "
                         f"{n} data shards")
    per = n_rows // n
    start = mesh.linear_index(axes) * per
    return slice(start, start + per)


def seq_chunk(n_cols: int, mesh: Mesh) -> slice:
    """The sequence positions this rank holds: its contiguous chunk
    along the ``sp`` axis (the whole sequence without one)."""
    n = mesh.shape.get("sp", 1)
    if n_cols % n:
        raise ValueError(f"sequence of {n_cols} does not split over "
                         f"sp={n}")
    per = n_cols // n
    start = mesh.coords().get("sp", 0) * per
    return slice(start, start + per)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's block of a global host batch, as tensors on the
    rank's device: its contiguous rows over the mesh's data axes and,
    on an ``sp`` mesh, its contiguous chunk of the sequence (dimension
    1) — JAX's ``P(("dp", "fsdp"), "sp")`` batch spec, so rank (d, r)
    holds data shard d's rows and sequence chunk r."""
    sp = mesh.shape.get("sp", 1) > 1

    def place(leaf: Any) -> torch.Tensor:
        t = leaf if isinstance(leaf, torch.Tensor) \
            else torch.as_tensor(np.asarray(leaf))
        if t.ndim == 0:
            return t.to(mesh.device)
        t = t[batch_rows(t.shape[0], mesh)]
        if sp and t.ndim >= 2:
            t = t[:, seq_chunk(t.shape[1], mesh)]
        return t.to(mesh.device)

    return _tree_map(place, batch)


def to_env(obj: Any, mesh: Mesh, rules: Any = None) -> Any:
    """Place a tree over the mesh. Without ``rules``, every tensor leaf
    goes to the rank's device and is overwritten by rank 0's (DDP's
    initial broadcast); other leaves pass through. With a
    ``(path_regex, spec)`` rule table, parameters (or a ``TrainState``)
    are sharded by it (:mod:`~torchbooster_tpu_torch.parallel.sharding`)."""
    if rules is not None:
        from torchbooster_tpu_torch.parallel.sharding import (
            shard_params,
            shard_state,
        )

        if hasattr(obj, "params") and hasattr(obj, "optimizer"):
            return shard_state(obj, rules, mesh)
        return shard_params(obj, mesh, rules)
    group = mesh.group(mesh.axis_names)

    def place(leaf: Any) -> Any:
        if isinstance(leaf, np.ndarray):
            leaf = torch.as_tensor(leaf)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        out = leaf.detach().to(mesh.device).clone()
        broadcast(out, group)
        return out.requires_grad_(leaf.requires_grad)

    return _tree_map(place, obj)


# =========================================================================
# Launch
# =========================================================================

def _backend(device: str | torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_group(backend: str, url: str, world: int, rank: int,
                local_rank: int) -> None:
    """Join the process group; on the card bind the local rank's card
    first. A failed init raises: there is no fallback to another backend
    or to running without a group."""
    os.environ["LOCAL_RANK"] = str(local_rank)
    kwargs: dict = {}
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
        kwargs["device_id"] = torch.device("cuda", local_rank)
    elif torch.cuda.is_available():
        # gloo ranks may share the cards
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    tdist.init_process_group(backend, init_method=url, world_size=world,
                             rank=rank, **kwargs)
    logging.info("joined %s group: rank %d/%d", backend, rank, world)


def _run_in_group(fn: Callable, args: Sequence[Any], backend: str,
                  url: str, world: int, rank: int, local_rank: int) -> Any:
    """``fn(*args)`` inside the process group, which is destroyed after
    (with the meshes cached over it)."""
    _init_group(backend, url, world, rank, local_rank)
    try:
        return fn(*args)
    finally:
        _MESH_CACHE.clear()
        tdist.destroy_process_group()


def _worker(local_rank: int, fn: Callable, args: Sequence[Any],
            n_devices: int, n_machine: int, machine_rank: int, url: str,
            backend: str, results: Any) -> None:
    rank = machine_rank * n_devices + local_rank
    out = _run_in_group(fn, args, backend, url, n_devices * n_machine, rank,
                        local_rank)
    results.put((rank, out))


def launch(
    fn: Callable,
    n_devices: int = 0,
    n_machine: int = 1,
    machine_rank: int = 0,
    dist_url: str = "auto",
    args: Sequence[Any] = (),
    *,
    distributed: bool = False,
    device: str | torch.device = "cuda",
    backend: str | None = None,
) -> Any:
    """Run ``fn(*args)`` under the distributed runtime.

    With ``n_devices > 1`` (or several machines) it spawns one process per
    device, each joining the group (NCCL when ``device`` is a card, gloo
    on the CPU) at ``dist_url`` (``"auto"``: a free localhost port, one
    machine only) with its card bound, and returns the per-rank results
    in rank order (``fn``'s result must pickle). With one device and
    ``distributed`` it starts a world-1 group in this process, so that
    the same code path runs on one card; without ``distributed`` it calls
    ``fn`` directly. Asking for more cards than exist raises.
    ``backend="gloo"`` with ``device="cuda"`` runs gloo over tensors on
    the cards, the ranks taking the cards in turn (several ranks share a
    card, which NCCL refuses); gloo takes ``all_reduce``, ``broadcast``
    and the gathers on card tensors, not the point-to-point ring."""
    backend = backend or _backend(device)
    if n_machine > 1 and dist_url in ("auto", "", None):
        raise ValueError(
            "multi-host launch needs an explicit coordinator address "
            "(dist_url='host:port'); 'auto' only works single-host")
    n_local = max(n_devices, 1)
    world = n_local * n_machine
    if world == 1 and not distributed:
        return fn(*args)
    if torch.device(device).type == "cuda":
        # a card was asked for, whatever the backend: no CPU fallback
        from torchbooster_tpu_torch._device import resolve_device

        resolve_device(device)
    if backend == "nccl":
        have = torch.cuda.device_count()
        if n_local > have:
            raise ValueError(f"asked for {n_local} devices, have {have}")
    url = dist_url if dist_url not in ("auto", "", None) \
        else f"tcp://localhost:{find_free_port()}"
    if not url.startswith(("tcp://", "file://", "env://")):
        url = f"tcp://{url}"
    if world == 1:
        return _run_in_group(fn, args, backend, url, 1, 0, 0)
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(
        _worker, args=(fn, tuple(args), n_local, n_machine, machine_rank,
                       url, backend, results),
        nprocs=n_local, join=False, start_method="spawn")
    out: dict[int, Any] = {}
    done = False
    while not done:
        # drained before each join: a worker blocks on a full pipe until
        # its result is read. join raises if a worker failed, after
        # terminating the others
        done = procs.join(timeout=0.1)
        while not results.empty():
            rank, value = results.get()
            out[rank] = value
    return [out.get(machine_rank * n_local + i) for i in range(n_local)]


__all__ = [
    "DATA_AXES", "MODEL_AXES", "Mesh", "TOKEN_AXES",
    "all_gather", "all_reduce", "all_reduce_sum", "all_to_all",
    "batch_rows", "broadcast", "copy_to_group",
    "diff_all_to_all", "diff_ppermute", "find_free_port", "gather",
    "gather_from_group",
    "get_device_count", "get_local_rank", "get_mesh", "get_rank",
    "get_world_size", "is_primary", "launch", "local_devices",
    "make_mesh", "parse_mesh_spec", "ppermute", "reduce_from_group",
    "reduce_scatter", "seq_chunk", "shard_batch", "synchronize", "to_env",
]
