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
:meth:`~SaveCallback.latest_step`. The JAX package's ZeRO checkpoint
format (``sharded=True``) waits for the sharded optimizer stages
(``ROADMAP.md`` A5)."""
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
        if sharded or comms is not None:
            raise NotImplementedError(
                "SaveCallback(sharded=True, comms=...): the ZeRO checkpoint "
                "format waits for the sharded optimizer stages "
                "(ROADMAP.md A5)")
        super().__init__(every, n_iter)
        self.root = Path(root).absolute()
        self.prefix = prefix
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
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
        save is waited for first."""
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

    def wait(self) -> None:
        """Block until the save in flight has committed. A failed
        background write raises here: the checkpoint did not commit."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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
