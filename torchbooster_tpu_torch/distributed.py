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
act on the one process's tensors."""
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
# Model-parallel axes, which wait for the tensor/sequence/pipeline/expert
# slice of the port (ROADMAP.md A-5b).
MODEL_AXES = ("tp", "sp", "pp", "ep")

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


def check_model_axes(names: Sequence[str], sizes: Sequence[int],
                     what: str) -> None:
    """Raise ``NotImplementedError`` naming A-5b when a model-parallel
    axis has a size above 1."""
    live = [f"{n}:{s}" for n, s in zip(names, sizes)
            if n in MODEL_AXES and s > 1]
    if live:
        raise NotImplementedError(
            f"{what}: model-parallel axes {live} are not ported yet "
            f"(ROADMAP.md A-5b); the port runs dp and fsdp meshes")


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
    axes together, and every axis (the world)."""
    subsets = [(a,) for a in names]
    for axes in (tuple(a for a in names if a in DATA_AXES), names):
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
        return torch.device("cpu")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(spec: str = "dp", n_devices: int = 0,
              device: str | torch.device = "cuda") -> Mesh:
    """A mesh from an axis spec over the world's ranks (one process per
    device). ``n_devices`` (0: the world) must equal the world size.
    Model-parallel axes of size above 1 raise ``NotImplementedError``
    naming A-5b."""
    world = get_world_size()
    if n_devices and n_devices != world:
        raise ValueError(
            f"make_mesh({spec!r}, n_devices={n_devices}): the port runs "
            f"one process per device, so a mesh spans the world of "
            f"{world} process(es)")
    for entry in spec.split(","):
        name, _, size = entry.strip().partition(":")
        if size.strip().lstrip("-").isdigit():
            check_model_axes([name.strip()], [int(size)], f"mesh {spec!r}")
    names, sizes = parse_mesh_spec(spec, world)
    check_model_axes(names, sizes, f"mesh {spec!r}")
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


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's contiguous slice of a global host batch, along its
    leading axis over the mesh's data axes, as tensors on the rank's
    device."""

    def place(leaf: Any) -> torch.Tensor:
        t = leaf if isinstance(leaf, torch.Tensor) \
            else torch.as_tensor(np.asarray(leaf))
        if t.ndim == 0:
            return t.to(mesh.device)
        return t[batch_rows(t.shape[0], mesh)].to(mesh.device)

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
) -> Any:
    """Run ``fn(*args)`` under the distributed runtime.

    With ``n_devices > 1`` (or several machines) it spawns one process per
    device, each joining the group (NCCL when ``device`` is a card, gloo
    on the CPU) at ``dist_url`` (``"auto"``: a free localhost port, one
    machine only) with its card bound, and returns the per-rank results
    in rank order (``fn``'s result must pickle). With one device and
    ``distributed`` it starts a world-1 group in this process, so that
    the same code path runs on one card; without ``distributed`` it calls
    ``fn`` directly. Asking for more cards than exist raises."""
    backend = _backend(device)
    if n_machine > 1 and dist_url in ("auto", "", None):
        raise ValueError(
            "multi-host launch needs an explicit coordinator address "
            "(dist_url='host:port'); 'auto' only works single-host")
    n_local = max(n_devices, 1)
    world = n_local * n_machine
    if world == 1 and not distributed:
        return fn(*args)
    if backend == "nccl":
        from torchbooster_tpu_torch._device import resolve_device

        resolve_device(device)
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
    "DATA_AXES", "MODEL_AXES", "Mesh", "all_gather", "all_reduce",
    "all_to_all", "batch_rows", "broadcast", "check_model_axes",
    "find_free_port", "gather", "get_device_count", "get_local_rank",
    "get_mesh", "get_rank", "get_world_size", "is_primary", "launch",
    "local_devices", "make_mesh", "parse_mesh_spec", "reduce_scatter",
    "shard_batch", "synchronize", "to_env",
]
