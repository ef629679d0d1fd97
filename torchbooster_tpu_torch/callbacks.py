"""Callbacks: step-counted hooks and checkpoint save and restore — the
port of ``torchbooster_tpu/callbacks.py``.

A checkpoint is a directory ``root/prefix_{step}`` (the step zero-padded
to the digits of ``n_iter``, the JAX path scheme) holding one
``torch.save`` file of host tensors: ``{key: state_dict(value)}``. The
save is asynchronous, as the JAX package's orbax save is: only the
device→host copy blocks the caller; a background thread writes the file
into a hidden temporary directory and commits it with a rename, so
:meth:`SaveCallback.latest_step` never sees half a checkpoint. A failed
write raises at the next :meth:`~SaveCallback.wait`,
:meth:`~SaveCallback.save`, :meth:`~SaveCallback.restore` or
:meth:`~SaveCallback.latest_step`.

``sharded=True`` writes the JAX package's ZeRO checkpoint format
(``manifest.json`` and ``arrays.npz``, JAX ``callbacks.save_sharded``):
the same keys, each rank's shard of a flat vector as one chunk, and the
schedule's ``comms`` block. Every rank sends its shards to rank 0, which
writes and commits; a restore reshards onto another data-parallel world
through the bucket plan, so checkpoints cross between the JAX package
and the port and between world sizes."""
from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import torch

from torchbooster_tpu_torch.utils import _tree_map

STATE_FILE = "state.pt"


class BaseCallback:
    """Step-counting callback base: ``__call__`` increments ``current``
    then delegates to ``update``."""

    def __init__(self, every: int, n_iter: int | None = None):
        self.every = every
        self.n_iter = n_iter
        self.current = 0

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        self.current += 1
        return self.update(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError


def state_dict(value: Any) -> Any:
    """The saveable tree of a runtime object: its ``state_dict()`` where
    it has one (a ``TrainState``, a ``BaseScheduler``), else the value."""
    if hasattr(value, "state_dict"):
        return value.state_dict()
    return value


class LogCallback(BaseCallback):
    """Telemetry drain on the training cadence: every ``every`` steps,
    snapshot the observability registry (the one host read of the
    per-step metrics), derive steps/s from the ``steps_total`` counter's
    change, merge the caller's metrics (``log_cb(loss=value)``), log one
    line and return the dict. Pairs with ``utils.instrument_step``,
    which feeds ``steps_total`` and ``step_seconds``."""

    def __init__(self, every: int, n_iter: int | None = None,
                 registry: Any = None, logger: str = "torchbooster"):
        super().__init__(every, n_iter)
        from torchbooster_tpu_torch.observability import get_registry

        self.registry = registry if registry is not None else get_registry()
        self.logger = logging.getLogger(logger)
        # steps taken before this callback existed do not count toward
        # its first steps/s reading
        self._last_steps = self._steps(self.registry.snapshot())
        self._last_t = time.perf_counter()

    @staticmethod
    def _steps(snap: dict[str, Any]) -> float:
        return sum(v for k, v in snap.items()
                   if k.startswith("steps_total"))

    def update(self, **metrics: Any) -> dict[str, Any] | None:
        if self.current % self.every:
            return None
        snap = self.registry.snapshot()
        now = time.perf_counter()
        steps = self._steps(snap)
        dt = now - self._last_t
        # a stable key set: no step since the last drain reads 0.0
        snap["steps_per_s"] = round(
            (steps - self._last_steps) / dt, 2) \
            if steps > self._last_steps and dt > 0 else 0.0
        self._last_steps, self._last_t = steps, now
        out = {"step": self.current, **snap,
               **{k: float(v) for k, v in metrics.items()}}
        self.logger.info("telemetry %s", out)
        return out


class SaveCallback(BaseCallback):
    """Periodic checkpoint writer and restorer.

    ``SaveCallback(every, n_iter, root, prefix)(**kwargs)`` saves
    ``{key: state_dict(value)}`` every ``every`` calls under
    :meth:`path`; :meth:`save` saves at an explicit step. The restore
    half is :meth:`latest_step` and :meth:`restore`. ``saves`` holds a
    record of each save: its host-copy time (``block_s``) and, once
    committed, its file's bytes and the background write's time
    (``write_s``)."""

    def __init__(self, every: int, n_iter: int,
                 root: str | Path = "checkpoints", prefix: str = "ckpt",
                 sharded: bool = False, comms: Any = None):
        super().__init__(every, n_iter)
        self.root = Path(root).absolute()
        self.prefix = prefix
        self.sharded = bool(sharded)
        self.comms = comms
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pending = False          # a sharded save not yet waited for
        self.saves: list[dict[str, Any]] = []

    def path(self, step: int) -> Path:
        """``root/prefix_{step}``, the step zero-padded to the digits of
        ``n_iter``."""
        width = len(str(self.n_iter))
        return self.root / f"{self.prefix}_{step:0{width}d}"

    def update(self, **kwargs: Any) -> Path | None:
        if self.current % self.every:
            return None
        return self.save(self.current, **kwargs)

    def save(self, step: int, **kwargs: Any) -> Path:
        """Copy ``{key: state_dict(value)}`` to host memory (this is the
        part that blocks), then write it in the background. The previous
        save is waited for first. With ``sharded`` it is
        :meth:`save_sharded`."""
        if self.sharded:
            return self.save_sharded(step, **kwargs)
        self.wait()
        t0 = time.perf_counter()
        target = _tree_map(
            lambda v: v.detach().to("cpu", copy=True)
            if isinstance(v, torch.Tensor) else v,
            {key: state_dict(value) for key, value in kwargs.items()})
        block_s = time.perf_counter() - t0
        final = self.path(step)
        tmp = self.root / f".tmp-{final.name}-{os.getpid()}"
        self.root.mkdir(parents=True, exist_ok=True)
        record = {"step": step, "path": final, "block_s": block_s,
                  "bytes": None, "write_s": None}
        self.saves.append(record)

        def commit() -> None:
            t1 = time.perf_counter()
            try:
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                torch.save(target, tmp / STATE_FILE)
                record["bytes"] = (tmp / STATE_FILE).stat().st_size
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)
            except Exception as exc:   # raised again by wait()
                self._error = exc
                return
            record["write_s"] = time.perf_counter() - t1

        self._thread = threading.Thread(target=commit,
                                        name=f"ckpt-{final.name}",
                                        daemon=True)
        self._thread.start()
        logging.info("saving checkpoint %s (async)", final)
        return final

    def save_sharded(self, step: int, **kwargs: Any) -> Path:
        """The ZeRO checkpoint in the JAX package's format. Every rank
        sends its shard of each flat vector (the stage-3 parameters, the
        flat optimizer state, the residuals) to rank 0 over the data
        group — no rank assembles a vector but rank 0, on the host — and
        rank 0 writes ``arrays.npz`` and then ``manifest.json`` into a
        hidden temporary directory in the background and renames it onto
        :meth:`path`. Collective: every rank calls it."""
        import json

        import numpy as np

        self.wait()
        t0 = time.perf_counter()
        group, device = _group_device(self.comms)
        leaves: list[tuple[str, Any, Any]] = []
        for key, value in kwargs.items():
            leaves.extend(_saved_leaves(f"[{key!r}]", value, self.comms))
        primary = _is_writer(group)
        arrays: dict[str, Any] = {}
        manifest: dict[str, Any] = {"format": 1, "step": int(step),
                                    "leaves": {}}
        for key, leaf, layout in leaves:
            chunks = [leaf] if layout is None \
                else _gather_chunks(leaf, group)
            if layout is not None and layout != "rows":
                starts = [c.tolist() for c in _gather_chunks(torch.tensor(
                    layout.block_start, device=device), group)]
            if not primary:
                continue
            chunks = [_host(c) for c in chunks]
            if layout == "rows":
                starts, off = [], 0
                for c in chunks:
                    starts.append([off] + [0] * (c.ndim - 1))
                    off += c.shape[0]
                shape = [off, *chunks[0].shape[1:]]
            elif layout is not None:
                # replicas over dp hold the same block: one copy each
                unique = dict(zip(map(tuple, starts), chunks))
                starts, chunks = list(map(list, unique)), list(unique.values())
                shape = list(layout.global_shape)
                perm = getattr(layout, "column_perm", None)
                if perm is not None:
                    # qkv columns split over tp, rank-major: assembled
                    # and written in the canonical order, as JAX's are
                    full = np.empty(shape, dtype=chunks[0].dtype)
                    for c, st in zip(chunks, starts):
                        full[tuple(slice(o, o + n)
                                   for o, n in zip(st, c.shape))] = c
                    chunks = [np.take(full, np.argsort(perm), axis=-1)]
            if len(chunks) > 1:
                for i, c in enumerate(chunks):
                    arrays[f"{key}##{i}"] = c
                manifest["leaves"][key] = {
                    "sharded": True, "n_chunks": len(chunks),
                    "starts": starts, "shape": shape}
            else:
                arrays[key] = chunks[0]
                manifest["leaves"][key] = {"sharded": False}
        plan = _plan_of(self.comms, kwargs)
        if plan is not None:
            manifest["comms"] = {
                "stage": int(getattr(self.comms, "stage",
                                     1 if self.comms.zero1 else 0)),
                "wire": self.comms.mode,
                "n_shards": plan.n_shards,
                "bucket_size": plan.bucket_size,
                "bucket_raw": list(plan.raw),
            }
        final = self.path(step)
        record = {"step": step, "path": final,
                  "block_s": time.perf_counter() - t0, "bytes": None,
                  "write_s": None}
        self.saves.append(record)
        self._pending = group is not None
        if not primary:
            return final
        self.root.mkdir(parents=True, exist_ok=True)
        tmp = self.root / f".tmp-{final.name}-{os.getpid()}"

        def commit() -> None:
            t1 = time.perf_counter()
            try:
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "arrays.npz", **arrays)
                # manifest last: its presence marks a complete checkpoint
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                record["bytes"] = (tmp / "arrays.npz").stat().st_size
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)
            except Exception as exc:   # raised again by wait()
                self._error = exc
                return
            record["write_s"] = time.perf_counter() - t1

        self._thread = threading.Thread(target=commit,
                                        name=f"ckpt-{final.name}",
                                        daemon=True)
        self._thread.start()
        logging.info("saving sharded checkpoint %s (async, %d leaves)",
                     final, len(manifest["leaves"]))
        return final

    def wait(self) -> None:
        """Block until the save in flight has committed. A failed
        background write raises here: the checkpoint did not commit.
        After a sharded save across ranks every rank waits for rank 0's
        commit (one broadcast), and every rank raises if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            import torch

            from torchbooster_tpu_torch.distributed import broadcast

            self._pending = False
            group, device = _group_device(self.comms)
            failed = torch.tensor([self._error is not None], dtype=torch.int32,
                                  device=device)
            broadcast(failed, group, src=_writer_rank(group))
            if failed.item() and self._error is None:
                self._error = RuntimeError("rank 0's write failed")
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed (the "
                               "checkpoint did NOT commit)") from error

    def latest_step(self) -> int | None:
        """The newest committed checkpoint's step, or None."""
        self.wait()
        if not self.root.exists():
            return None
        steps = []
        for entry in self.root.iterdir():
            suffix = entry.name[len(self.prefix) + 1:]
            if entry.name.startswith(f"{self.prefix}_") and suffix.isdigit():
                steps.append(int(suffix))
        return max(steps) if steps else None

    def restore(self, step: int | None = None,
                like: dict[str, Any] | None = None) -> dict[str, Any] | None:
        """The checkpoint at ``step`` (default: the newest), or None when
        there is none. Without ``like`` it comes back as saved, host
        tensors. ``like`` is a template ``{key: object}``: an object with
        ``load_state_dict`` (a ``TrainState``, a ``BaseScheduler``) is
        loaded in place and comes back as the live object; a tensor tree
        comes back on its template tensors' devices and dtypes; any
        other value as saved."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        else:
            self.wait()
        if (self.path(step) / "manifest.json").exists():
            return self._restore_sharded(step, like)
        restored = torch.load(self.path(step) / STATE_FILE,
                              map_location="cpu", weights_only=True)
        for key, obj in (like or {}).items():
            if key not in restored:
                continue
            if hasattr(obj, "load_state_dict"):
                obj.load_state_dict(restored[key])
                restored[key] = obj
            elif isinstance(obj, (torch.Tensor, dict, list, tuple)):
                restored[key] = _like(restored[key], obj)
        return restored


    def _restore_sharded(self, step: int,
                         like: dict[str, Any] | None) -> dict[str, Any]:
        """Load a :meth:`save_sharded` checkpoint (or one the JAX package
        wrote). Without ``like`` it comes back as ``{key: host array}``
        under the saved keys. A ``TrainState`` in ``like`` is loaded in
        place — each flat vector as this rank's shard, resharded through
        ``comms``' bucket plan when the checkpoint's data-parallel world
        differs (its int8 residuals, per-rank state, then reset to zero
        with a warning); another object with ``load_state_dict`` gets
        its saved tree; any other value comes back as saved."""
        import json

        import numpy as np

        path = self.path(step)
        manifest = json.loads((path / "manifest.json").read_text())
        host: dict[str, np.ndarray] = {}
        with np.load(path / "arrays.npz") as data:
            for key, entry in manifest["leaves"].items():
                if not entry.get("sharded"):
                    host[key] = data[key]
                    continue
                chunks = [data[f"{key}##{i}"]
                          for i in range(entry["n_chunks"])]
                if "starts" not in entry:
                    raise ValueError(
                        f"sharded checkpoint {path.name} leaf {key} has no "
                        f"chunk offsets ('starts') — the manifest is "
                        f"truncated or hand-edited")
                full = np.empty(tuple(entry["shape"]), dtype=chunks[0].dtype)
                for c, st in zip(chunks, entry["starts"]):
                    full[tuple(slice(o, o + n)
                               for o, n in zip(st, c.shape))] = c
                host[key] = full
        if like is None:
            return host
        _plan_of(self.comms, like)      # the restore side's plan, built
        restored: dict[str, Any] = {}
        for key, obj in like.items():
            prefix = f"[{key!r}]"
            if hasattr(obj, "optimizer") and hasattr(obj, "params"):
                _load_state(obj, prefix, host, manifest.get("comms"),
                            self.comms, path.name)
                restored[key] = obj
                continue
            tree = _tree_from_host(state_dict(obj), prefix, host, path.name)
            if hasattr(obj, "load_state_dict"):
                obj.load_state_dict(tree)
                restored[key] = obj
            else:
                restored[key] = tree
        return restored


# ----------------------------------------------------- the ZeRO checkpoint
# torch optimizer state names → the optax state fields a JAX checkpoint
# stores them under (``opt_state[0].<name>``)
_OPT_NAMES = {"step": "count", "exp_avg": "mu", "exp_avg_sq": "nu",
              "max_exp_avg_sq": "nu_max", "momentum_buffer": "trace"}
_TORCH_NAMES = {v: k for k, v in _OPT_NAMES.items()}


def _keystr(path: tuple) -> str:
    """JAX ``keystr`` of a dict/list path: ``['a']['b'][0]``."""
    return "".join(f"[{k!r}]" for k in path)


def _is_state(value: Any) -> bool:
    return hasattr(value, "optimizer") and hasattr(value, "params")


def _stage(comms: Any) -> int:
    if comms is None:
        return 0
    return int(getattr(comms, "stage", 1 if comms.zero1 else 0))


def _block_of(leaf: Any) -> Any:
    """A parameter block laid out by sharding rules (``block_start``
    recorded on it by ``parallel.sharding``), or None."""
    return leaf if hasattr(leaf, "block_start") else None


def _saved_leaves(prefix: str, value: Any, comms: Any) -> list:
    """``(key, leaf, layout)`` of one saved value, under the JAX
    package's keys. ``layout`` is None for a whole leaf, ``"rows"`` for
    this rank's chunk along dimension 0 of a vector sharded over the data
    axes (flat ZeRO state, residuals), or the rule-sharded parameter
    whose block layout the leaf shares."""
    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    if not _is_state(value):
        return [(prefix + _keystr(path), leaf, None)
                for path, leaf in tree_flatten(state_dict(value))]
    import numpy as np

    st, p = value, prefix
    flat = isinstance(st.params, torch.Tensor)
    out: list = []
    if flat:
        out.append((f"{p}.params", st.params, "rows"))
    else:
        out += [(f"{p}.params{_keystr(path)}", leaf, _block_of(leaf))
                for path, leaf in tree_flatten(st.params)]
    suffixes = {} if flat else {id(leaf): _keystr(path)
                                for path, leaf in tree_flatten(st.params)}
    counted = False
    for q in [q for g in st.optimizer.param_groups for q in g["params"]]:
        suffix = suffixes.get(id(q), "")
        layout = "rows" if id(q) not in suffixes and _stage(comms) >= 1 \
            else _block_of(q)
        for name, v in st.optimizer.state.get(q, {}).items():
            jname = _OPT_NAMES.get(name, name)
            if jname == "count":
                if not counted:
                    out.append((f"{p}.opt_state[0].count",
                                np.asarray(int(v), np.int32), None))
                    counted = True
                continue
            out.append((f"{p}.opt_state[0].{jname}{suffix}", v, layout))
    out.append((f"{p}.step", np.asarray(st.step, np.int32), None))
    if st.generator is not None:
        seed = st.generator.initial_seed()
        out.append((f"{p}.rng", np.asarray([seed >> 32, seed & 0xFFFFFFFF],
                                           np.uint32), None))
        out.append((f"{p}.generator", st.generator.get_state(), None))
    if st.ema is not None:
        if flat:
            out.append((f"{p}.ema", st.ema, "rows"))
        else:
            out += [(f"{p}.ema{_keystr(path)}", leaf, _block_of(param))
                    for (path, leaf), (_, param) in zip(
                        tree_flatten(st.ema), tree_flatten(st.params))]
    for name, v in (st.comms or {}).items():
        out.append((f"{p}.comms[{name!r}]", v, "rows"))
    return out


def _count_device(optimizer: Any, q: torch.Tensor) -> torch.device:
    """Where an optimizer keeps a restored update count: on the leaf's
    device for the port's optimizers (``optim.py``) and torch's
    capturable or fused ones, on the CPU for torch's others (as torch's
    own ``load_state_dict`` places it)."""
    from torchbooster_tpu_torch import optim

    group = optimizer.param_groups[0] if optimizer.param_groups else {}
    if isinstance(optimizer, optim._InPlace) or group.get("capturable") \
            or group.get("fused"):
        return q.device
    return torch.device("cpu")


def _plan_of(comms: Any, values: dict) -> Any:
    """The schedule's bucket plan (built from a saved state's parameter
    tree when the schedule has none yet), or None."""
    if comms is None or not hasattr(comms, "plan"):
        return None
    plan = getattr(comms, "_plan", None)
    if plan is None:
        trees = [v.params for v in values.values()
                 if _is_state(v) and not isinstance(v.params, torch.Tensor)]
        plan = comms.plan(trees[0]) if trees else None
    return plan


def _group_device(comms: Any) -> tuple:
    """The group a sharded save gathers over — the schedule's data group,
    else the world (a rule-sharded state: its blocks may split over any
    axis, ``fsdp``, ``ep``, ``tp`` or ``pp``) — and this rank's device;
    ``(None, None)`` without a process group."""
    from torchbooster_tpu_torch import distributed as dist

    # under a group the world's mesh takes the group's device, "cpu" or not
    mesh = comms.mesh if comms is not None else dist.get_mesh(device="cpu")
    if not mesh.distributed:
        return None, None
    if comms is None:
        return mesh.group(mesh.axis_names), mesh.device
    return mesh.group(mesh.data_axes()), mesh.device


def _writer_rank(group: Any) -> int:
    """The global rank of the group's rank 0, which writes."""
    if group is None:
        return 0
    import torch.distributed as tdist

    return tdist.get_global_rank(group, 0)


def _is_writer(group: Any) -> bool:
    from torchbooster_tpu_torch.distributed import get_rank

    return get_rank() == _writer_rank(group)


def _gather_chunks(leaf: torch.Tensor, group: Any) -> list:
    """Every rank's ``leaf`` on the writer, in rank order (one
    ``gather`` over ``group``); ``[]`` on the other ranks."""
    if group is None:
        return [leaf]
    import torch.distributed as tdist

    n = tdist.get_world_size(group)
    if n == 1:
        return [leaf]
    t = leaf.detach().contiguous()
    dst = _writer_rank(group)
    mine = tdist.get_rank() == dst
    out = [torch.empty_like(t) for _ in range(n)] if mine else None
    tdist.gather(t, out, dst=dst, group=group)
    return out if mine else []


def _host(value: Any) -> Any:
    """An npz-safe host array (bf16 widens to fp32)."""
    import numpy as np

    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


def _tree_from_host(template: Any, prefix: str, host: dict,
                    name: str) -> Any:
    """The saved tree under ``prefix``, shaped like ``template`` (tensors
    on their template's device and dtype)."""
    from torchbooster_tpu_torch.parallel.sharding import tree_map_with_path

    def load(path: tuple, leaf: Any) -> Any:
        key = prefix + _keystr(path)
        if key not in host:
            raise KeyError(f"sharded checkpoint {name} has no leaf {key} — "
                           f"template does not match what was saved")
        value = host[key]
        if isinstance(leaf, torch.Tensor):
            return torch.as_tensor(value).to(device=leaf.device,
                                              dtype=leaf.dtype)
        if isinstance(leaf, (int, float)):
            return type(leaf)(value)
        return value

    return tree_map_with_path(load, template)


@torch.no_grad()
def _load_state(st: Any, prefix: str, host: dict, old_meta: Any,
                comms: Any, name: str) -> None:
    """Load a saved ``TrainState`` into ``st`` in place: replicated
    leaves whole, each flat vector as this rank's shard (resharded when
    the world changed), the optimizer state rebuilt under its torch
    names, the generator from its saved state (or seeded from ``rng``)."""
    import numpy as np

    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    plan = getattr(comms, "_plan", None) if comms is not None else None
    mesh = comms.mesh if comms is not None else None
    n = comms.n_shards if comms is not None else 1
    idx = mesh.linear_index(comms.axes) if comms is not None else 0
    cross_world = (old_meta is not None and plan is not None
                   and (int(old_meta["n_shards"]) != plan.n_shards
                        or int(old_meta["bucket_size"]) != plan.bucket_size))

    def get(key: str) -> np.ndarray:
        if key not in host:
            raise KeyError(f"sharded checkpoint {name} has no leaf {key} — "
                           f"template does not match what was saved")
        return host[key]

    def shard_of(key: str, size: int) -> torch.Tensor:
        arr = get(key)
        if cross_world or arr.shape[0] != size * n:
            arr = _reshard_flat_leaf(arr, (size * n,), old_meta, plan, key)
        return torch.as_tensor(np.ascontiguousarray(
            arr[idx * size:(idx + 1) * size]))

    def put(dst: torch.Tensor, value: Any) -> None:
        dst.copy_(torch.as_tensor(np.asarray(value)).reshape(dst.shape))

    def block(arr: np.ndarray, layout: Any) -> np.ndarray:
        """This rank's block of a full array, for a rule-sharded leaf
        (qkv columns over tp taken in their rank-major order first)."""
        if layout is None:
            return arr
        perm = getattr(layout, "column_perm", None)
        if perm is not None:
            arr = np.take(arr, perm, axis=-1)
        return arr[tuple(slice(b, b + n) for b, n in
                         zip(layout.block_start, layout.shape))]

    flat = isinstance(st.params, torch.Tensor)
    if flat:
        put(st.params, shard_of(f"{prefix}.params", st.params.numel()))
    else:
        for path, leaf in tree_flatten(st.params):
            put(leaf, block(get(f"{prefix}.params{_keystr(path)}"),
                            _block_of(leaf)))
    names = {k[len(f"{prefix}.opt_state[0]."):].split("[")[0]
             for k in host if k.startswith(f"{prefix}.opt_state[0].")}
    suffixes = {} if flat else {id(leaf): _keystr(path)
                                for path, leaf in tree_flatten(st.params)}
    for q in [q for g in st.optimizer.param_groups for q in g["params"]]:
        suffix = suffixes.get(id(q), "")
        entry = st.optimizer.state[q]
        for jname in sorted(names):
            tname = _TORCH_NAMES.get(jname, jname)
            if jname == "count":
                count = float(get(f"{prefix}.opt_state[0].count"))
                if isinstance(entry.get(tname), torch.Tensor):
                    entry[tname].fill_(count)
                else:
                    entry[tname] = torch.tensor(
                        count, device=_count_device(st.optimizer, q))
                continue
            key = f"{prefix}.opt_state[0].{jname}{suffix}"
            value = shard_of(key, q.numel()) if id(q) not in suffixes \
                else torch.as_tensor(block(get(key), _block_of(q)))
            value = value.to(device=q.device, dtype=q.dtype).reshape(q.shape)
            live = entry.get(tname)
            # into the live tensor where there is one: a captured train
            # step reads the optimizer's state where it lies
            if isinstance(live, torch.Tensor) and live.shape == value.shape:
                live.copy_(value)
            else:
                entry[tname] = value.clone()
    st.step = int(get(f"{prefix}.step"))
    if st.generator is not None:
        saved = host.get(f"{prefix}.generator")
        if saved is not None and saved.size == st.generator.get_state().numel():
            st.generator.set_state(torch.as_tensor(saved))
        else:
            rng = get(f"{prefix}.rng").astype(np.uint64)
            st.generator.manual_seed(int((rng[0] << np.uint64(32)) | rng[1]))
    if st.ema is not None:
        if flat:
            put(st.ema, shard_of(f"{prefix}.ema", st.ema.numel()))
        else:
            for (path, leaf), (_, param) in zip(tree_flatten(st.ema),
                                                tree_flatten(st.params)):
                put(leaf, block(get(f"{prefix}.ema{_keystr(path)}"),
                                _block_of(param)))
    for cname, value in (st.comms or {}).items():
        arr = get(f"{prefix}.comms[{cname!r}]")
        rows = value.shape[0] if value.ndim == 2 else value.numel()
        if cross_world or arr.shape[0] != rows * n:
            logging.warning(
                "checkpoint leaf %s.comms[%r]: error-feedback residuals are "
                "per-replica state and cannot survive a %s -> %d world "
                "change; reset to zero (one-step quantization bias, then "
                "the feedback re-drains)", prefix, cname,
                old_meta["n_shards"] if old_meta else "?", n)
            value.zero_()
        else:
            put(value, arr[idx * rows:(idx + 1) * rows])


def _reshard_flat_leaf(arr: Any, want: tuple, old_meta: Any,
                       new_plan: Any, key: str) -> Any:
    """Map a flat ZeRO vector saved under one data-parallel world onto
    another: strip the old world's per-bucket pads (shard-major → raw
    bucket order, world-independent), then re-pad for the new plan."""
    from torchbooster_tpu_torch.comms.schedule import BucketPlan, _pad_to

    if old_meta is None or new_plan is None:
        raise ValueError(
            f"checkpoint leaf {key} has shape {tuple(arr.shape)} but "
            f"the template wants {want} — restoring onto a different "
            f"data-parallel world needs the comms schedule on both "
            f"sides: save with SaveCallback(comms=<schedule>) after "
            f"create_state, restore with comms=<the new schedule> "
            f"(plan attached)")
    old_n = int(old_meta["n_shards"])
    bsz = int(old_meta["bucket_size"])
    raw = tuple(int(r) for r in old_meta["bucket_raw"])
    old_geom = BucketPlan(
        n_shards=old_n, bucket_size=bsz, paths=(), shapes=(), dtypes=(),
        raw=raw, padded=tuple(_pad_to(r, old_n * bsz) for r in raw),
        spans=())
    if raw != tuple(new_plan.raw):
        raise ValueError(
            f"checkpoint bucket sizes {raw} do not match the restore "
            f"schedule's plan {tuple(new_plan.raw)} for {key} — the "
            f"model (or bucket_mb) changed, not just the world size")
    if arr.ndim == 1 and arr.shape[0] == old_geom.total_padded \
            and want == (new_plan.total_padded,):
        return new_plan.with_pads_host(old_geom.strip_pads_host(arr))
    raise ValueError(
        f"cannot reshard checkpoint leaf {key}: {tuple(arr.shape)} -> "
        f"{want}")


def _like(saved: Any, template: Any) -> Any:
    """``saved``'s tensors on their ``template`` tensors' devices and in
    their dtypes (the trees match)."""
    if isinstance(template, torch.Tensor):
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        return {k: _like(saved[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(s, t) for s, t in zip(saved, template))
    return saved


__all__ = ["BaseCallback", "LogCallback", "SaveCallback", "state_dict"]
