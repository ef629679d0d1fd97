"""Typed YAML configuration — the port of ``torchbooster_tpu/config.py``
for the training and serving slices:

- ``BaseConfig.load``: YAML with ``#include`` splicing, string
  pseudo-annotation type resolution (``tuple(float, float)``, nested
  config classes by name) and scalar coercion (``1e-3`` strings,
  ``1_024`` ints, comma tuples such as ``betas: 0.9, 0.95``);
- the factories the GPT recipe uses: ``EnvConfig`` (compute dtype and
  device), ``LoaderConfig``, ``OptimizerConfig`` (adamw/adam/sgd over
  torch optimizers, driven by a schedule), ``SchedulerConfig`` and
  ``DatasetConfig`` (the builtin registry);
- ``ServingConfig`` with its core fields and a single-replica ``make``.

Not ported yet (``ROADMAP.md`` A2, A7, A8): hyperparameter sweeps,
meshes and distributed environments, loader workers, the ``lamb``,
``lion`` and ``adafactor`` optimizers, and the serving router, disagg
and front-door sub-blocks. Configurations that need them raise
``NotImplementedError``. PyYAML is imported only when a file is read."""
from __future__ import annotations

import builtins
import dataclasses
import itertools
import logging
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch

from torchbooster_tpu_torch._device import resolve_device

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def _yaml():
    try:
        import yaml
    except ImportError as err:
        raise ImportError("reading a YAML config needs PyYAML, which is "
                          "not installed; build the config in code "
                          "instead") from err
    return yaml


# ----------------------------------------------------- #include splicing
INCLUDE_PATTERN = re.compile(r"^\s*#include\s+(.+?)\s*$")


def read_lines(path: str | Path, _stack: tuple[Path, ...] = ()) -> list[str]:
    """Read ``path`` splicing ``#include``d files in place, recursively,
    each relative to the including file's directory. A circular chain
    raises ``RecursionError`` naming it."""
    path = Path(path)
    resolved = path.resolve()
    if resolved in _stack:
        chain = " -> ".join(str(p) for p in (*_stack, resolved))
        raise RecursionError(f"circular #include chain: {chain}")
    lines: list[str] = []
    for line in path.read_text().splitlines():
        match = INCLUDE_PATTERN.match(line)
        if match:
            included = (path.parent / match.group(1)).resolve()
            lines.extend(read_lines(included, (*_stack, resolved)))
        else:
            lines.append(line)
    return lines


# ------------------------------------------------------ type resolution
_ANNOTATION_PATTERN = re.compile(r"^(\w+)\s*\((.*)\)$")


def _all_config_subclasses(cls: type) -> list[type]:
    out: list[type] = []
    for sub in cls.__subclasses__():
        out.append(sub)
        out.extend(_all_config_subclasses(sub))
    return out


def _lookup_type(name: str, owner: type) -> type:
    """builtins → the owner's module globals → BaseConfig subclasses by
    class name (so user config classes appear in YAML untouched)."""
    name = name.strip()
    if hasattr(builtins, name):
        return getattr(builtins, name)
    module = sys.modules.get(owner.__module__)
    if module is not None and hasattr(module, name):
        return getattr(module, name)
    for sub in _all_config_subclasses(BaseConfig):
        if sub.__name__ == name:
            return sub
    raise NameError(f"cannot resolve config type {name!r} for "
                    f"{owner.__name__}")


def _cast_scalar(field_type: type, value: Any) -> Any:
    if value is None:
        return None
    if isinstance(field_type, type) and issubclass(field_type, BaseConfig):
        return field_type(**resolve_types(field_type, value or {}))
    if field_type is bool and isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on")
    if field_type is Any:
        return value
    return field_type(value)   # float("1e-3"), int("1_024")


def _split_elements(value: Any) -> list[Any]:
    """A container field's YAML value as a list: YAML lists, comma
    strings (``decay: lin, cos``) and bare scalars (one element)."""
    if isinstance(value, str):
        return [part.strip() for part in value.split(",")]
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value]


def _coerce(owner: type, annotation: str, value: Any) -> Any:
    if value is None:
        return None
    match = _ANNOTATION_PATTERN.match(annotation.strip())
    if match:
        container = _lookup_type(match.group(1), owner)
        names = [e for e in (s.strip() for s in match.group(2).split(","))
                 if e]
        types = [_lookup_type(e, owner) for e in names] or [str]
        return container(_cast_scalar(t, el) for t, el in
                         zip(itertools.cycle(types), _split_elements(value)))
    return _cast_scalar(_lookup_type(annotation, owner), value)


def resolve_types(cls: type, data: dict[str, Any] | None) -> dict[str, Any]:
    """Coerce raw YAML ``data`` into typed kwargs for dataclass ``cls``,
    whose field annotations are strings in the pseudo-syntax ``int``,
    ``tuple(float, float)``, ``SomeConfig``. Container element types
    cycle over the data. Extra keys warn and are ignored."""
    data = dict(data or {})
    fields = {f.name: f for f in dataclasses.fields(cls)}
    extra = sorted(set(data) - set(fields))
    if extra:
        logging.warning("%s received extra config parameters %s (ignored)",
                        cls.__name__, extra)
    kwargs: dict[str, Any] = {}
    for name, f in fields.items():
        if name in data:
            annotation = f.type if isinstance(f.type, str) else getattr(
                f.type, "__name__", str(f.type))
            kwargs[name] = _coerce(cls, annotation, data[name])
    return kwargs


@dataclass
class BaseConfig:
    """Base class for typed YAML configs: ``@dataclass`` subclasses
    whose ``make`` builds the runtime object they describe."""

    def make(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError("BaseConfig subclasses must implement "
                                  "make()")

    @classmethod
    def load(cls, path: str | Path):
        """One config from the YAML file ``path`` (``#include`` spliced)."""
        data = _yaml().safe_load("\n".join(read_lines(path))) or {}
        return cls(**resolve_types(cls, data))


# ----------------------------------------------------- runtime factories
@dataclass
class EnvConfig(BaseConfig):
    """Execution environment: compute precision and the device. One
    card (or the CPU) only: ``distributed``, several devices or machines,
    and meshes with axes beyond a one-device ``dp`` wait for ROADMAP.md
    A8 and raise."""

    distributed: bool = False
    fp16: bool = False                 # alias → bf16 compute
    precision: str = ""                # "" (auto) | "fp32" | "bf16"
    n_gpu: int = -1
    n_devices: int = 0                 # 0 → the one device
    n_machine: int = 1
    machine_rank: int = 0
    dist_url: str = "auto"
    mesh: str = "dp"

    def compute_dtype(self) -> torch.dtype:
        if self.precision == "bf16" or (not self.precision and self.fp16):
            return torch.bfloat16
        return torch.float32

    def make(self, device: str | torch.device = "cuda") -> torch.device:
        """The device to train on (a card unless the caller passes
        ``"cpu"``)."""
        axes = [a.split(":") for a in self.mesh.replace(" ", "").split(",")
                if a]
        one_dp = all(a[0] == "dp" and (len(a) == 1 or int(a[1]) == 1)
                     for a in axes)
        if (self.distributed or self.n_machine > 1 or self.n_devices > 1
                or self.n_gpu > 1 or not one_dp):
            raise NotImplementedError(
                f"env {self}: meshes, sharding and multi-device runs are "
                f"not ported yet (ROADMAP.md A8); use one device, mesh: dp")
        return resolve_device(device)


@dataclass
class LoaderConfig(BaseConfig):
    """Host loader settings. Batches come back as host numpy; the
    caller copies them to the card (``pin_memory`` pins them first)."""

    batch_size: int = 32
    num_workers: int = 0
    pin_memory: bool = False
    drop_last: bool = True
    prefetch: int = 2

    def make(self, dataset: Any, shuffle: bool = True,
             distributed: bool = False, collate_fn: Callable | None = None,
             seed: int = 0) -> Any:
        from torchbooster_tpu_torch.data import DataLoader

        if self.num_workers > 0 or distributed:
            raise NotImplementedError(
                "loader workers and distributed sharding are not ported "
                "yet (ROADMAP.md A9); use num_workers: 0")
        return DataLoader(dataset, batch_size=self.batch_size,
                          shuffle=shuffle, drop_last=self.drop_last,
                          collate_fn=collate_fn, seed=seed)


def _unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    """optax ``unitwise_norm``: vectors whole, rank 2-3 over axis 0,
    rank 4 over axes 0-2, broadcast back to ``x``'s shape."""
    sq = x.float().square()
    if x.squeeze().ndim <= 1:
        norm = sq.sum().sqrt()
    elif x.ndim in (2, 3):
        norm = sq.sum(dim=0, keepdim=True).sqrt()
    elif x.ndim == 4:
        norm = sq.sum(dim=(0, 1, 2), keepdim=True).sqrt()
    else:
        raise ValueError(f"agc takes params of rank 1-4, got {x.shape}")
    return norm.expand(x.shape)


@dataclass(frozen=True)
class Transform:
    """What :meth:`OptimizerConfig.make` returns — the port's counterpart
    of the JAX package's ``optax.inject_hyperparams`` transformation:
    :meth:`init` builds the torch optimizer over a parameter tree, and
    :meth:`learning_rate` gives the lr for the optimizer's own update
    count, which the train step writes into every group before
    ``optimizer.step()``. ``agc`` clips each unit's gradient to
    ``agc·max(‖W‖, 1e-3)`` before the update (optax
    ``adaptive_grad_clip``)."""

    factory: Callable[[list[dict], float], torch.optim.Optimizer]
    schedule: Callable[[int], float] | float
    weight_decay: float = 0.0
    decay_matrices_only: bool = False
    agc: float = 0.0

    def learning_rate(self, count: int) -> float:
        return float(self.schedule(count)) if callable(self.schedule) \
            else float(self.schedule)

    def init(self, params: Any) -> torch.optim.Optimizer:
        from torchbooster_tpu_torch.utils import tree_leaves

        leaves = tree_leaves(params)
        if self.decay_matrices_only:
            # decay masked off every rank <= 1 leaf (optax mask ndim > 1)
            groups = [{"params": [p for p in leaves if p.ndim > 1],
                       "weight_decay": self.weight_decay},
                      {"params": [p for p in leaves if p.ndim <= 1],
                       "weight_decay": 0.0}]
            groups = [g for g in groups if g["params"]]
        else:
            groups = [{"params": leaves, "weight_decay": self.weight_decay}]
        return self.factory(groups, self.learning_rate(0))

    @torch.no_grad()
    def clip_units(self, params: Any) -> None:
        """Adaptive gradient clipping of every leaf's ``.grad`` in place
        (a no-op when ``agc`` is 0)."""
        if not self.agc:
            return
        from torchbooster_tpu_torch.utils import tree_leaves

        for p in tree_leaves(params):
            if p.grad is None:
                continue
            g_norm = _unitwise_norm(p.grad)
            max_norm = self.agc * _unitwise_norm(p).clamp_min(1e-3)
            clipped = p.grad * (max_norm / g_norm.clamp_min(1e-6))
            p.grad.copy_(torch.where(g_norm < max_norm, p.grad, clipped))


@dataclass
class OptimizerConfig(BaseConfig):
    """Optimizer factory: ``adamw``, ``adam`` and ``sgd`` over the torch
    optimizers, with the JAX package's semantics:

    - ``adamw``: ``torch.optim.AdamW`` in its default implementation
      computes what ``optax.adamw`` does — bias-corrected moments, eps
      outside the sqrt, and the decoupled decay ``p − lr·(u + wd·p)``;
    - ``adam``: no weight decay, as ``optax.adam``;
    - ``sgd``: ``torch.optim.SGD``, whose momentum buffer starts at the
      first gradient and then takes ``μ·buf + (1−d)·g`` — the torch
      semantics the JAX package reproduces for ``dampening``; weight
      decay adds ``wd·p`` to the gradient first;
    - ``amsgrad`` (adam/adamw): torch's rule, which the JAX package
      reproduces.

    ``lamb``, ``lion`` and ``adafactor`` are not ported yet (ROADMAP.md
    A2) and raise ``NotImplementedError``."""

    name: str = "adamw"                # sgd | adam | adamw
    lr: float = 1e-3
    momentum: float = 0.0
    dampening: float = 0.0
    betas: tuple(float, float) = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    nesterov: bool = False
    amsgrad: bool = False
    agc: float = 0.0
    decay_matrices_only: bool = False

    def make(self, schedule: Callable[[int], float] | None = None
             ) -> Transform:
        """A :class:`Transform`; ``schedule`` (a pure step → lr function,
        see ``scheduler.py``) drives the learning rate, else ``lr``."""
        name = self.name.lower()
        betas = tuple(float(b) for b in self.betas)
        if name == "sgd":
            if self.nesterov and (self.dampening or not self.momentum):
                raise ValueError(
                    "nesterov requires a momentum and zero dampening")
            factory = lambda groups, lr: torch.optim.SGD(
                groups, lr=lr, momentum=self.momentum,
                dampening=self.dampening, nesterov=self.nesterov)
        elif name == "adam":
            factory = lambda groups, lr: torch.optim.Adam(
                [{**g, "weight_decay": 0.0} for g in groups], lr=lr,
                betas=betas, eps=self.eps, amsgrad=self.amsgrad)
        elif name == "adamw":
            factory = lambda groups, lr: torch.optim.AdamW(
                groups, lr=lr, betas=betas, eps=self.eps,
                amsgrad=self.amsgrad)
        elif name in ("lamb", "lion", "adafactor"):
            raise NotImplementedError(
                f"optimizer {self.name!r} is not ported yet (ROADMAP.md "
                f"A2); use adamw, adam or sgd")
        else:
            raise NameError(f"unknown optimizer {self.name!r}")
        return Transform(factory=factory,
                         schedule=schedule if schedule is not None
                         else self.lr,
                         weight_decay=self.weight_decay,
                         decay_matrices_only=self.decay_matrices_only,
                         agc=self.agc)


@dataclass
class SchedulerConfig(BaseConfig):
    """LR schedule factory (``cycle`` only): a pure step → lr function."""

    name: str = "cycle"
    n_iter: int = 0
    initial_multiplier: float = 4e-2
    final_multiplier: float = 1e-5
    warmup: int = 0
    plateau: int = 0
    decay: tuple(str, str) = ("cos", "cos")

    def make(self, optim: OptimizerConfig):
        from torchbooster_tpu_torch.scheduler import CycleScheduler

        if self.name.lower() != "cycle":
            raise NameError(f"unknown scheduler {self.name!r}")
        return CycleScheduler(
            lr=optim.lr, n_iter=self.n_iter,
            initial_multiplier=self.initial_multiplier,
            final_multiplier=self.final_multiplier, warmup=self.warmup,
            plateau=self.plateau, decay=tuple(self.decay))


@dataclass
class DatasetConfig(BaseConfig):
    """Dataset resolution over the builtin registry
    (``data/sources.py``); other names raise."""

    name: str = "mnist"
    root: str = "dataset"
    task: str = ""
    n_examples: int = 0                # synthetic-family size (0 = default)

    def make(self, split: Any, **kwargs: Any) -> Any:
        from torchbooster_tpu_torch.data import resolve_dataset

        return resolve_dataset(self, split, **kwargs)


# ServingConfig.decode_backend -> the PagedEngine backend: the JAX
# package's names, the port's own, and "" for the engine's device default
_DECODE_BACKENDS = {"": None, "xla": "sweep", "sweep": "sweep",
                    "pallas": "kernel", "kernel": "kernel"}


@dataclass
class ServingConfig:
    """Paged KV geometry and sampling knobs of the continuous-batching
    loop (field meanings as in the JAX package). ``decode_backend``
    takes the JAX package's names, ``"xla"`` (the pool sweep) and
    ``"pallas"`` (the paged flash-decode kernel), and the port's own,
    ``"sweep"`` and ``"kernel"``; ``""`` picks the kernel on the card and
    the sweep on the CPU. Any other name raises in :meth:`make`.
    ``tp > 1``, not ported yet, raises ``NotImplementedError``."""

    page_size: int = 64
    n_pages: int = 256
    max_slots: int = 8
    cache_dtype: str = ""              # "" (compute dtype) | "int8"
    temperature: float = 0.0           # 0 = greedy
    top_k: int = 0                     # 0 = off
    top_p: float = 0.0                 # 0 = off
    prefix_cache: bool = False
    prefill_chunk_pages: int = 4
    speculative: bool = False
    draft_len: int = 4
    ngram_min: int = 2
    spec_tree: bool = False
    spec_tree_width: int = 2
    parallel_sampling: bool = False
    decode_backend: str = ""    # "" auto | "xla"/"sweep" | "pallas"/"kernel"
    tp: int = 1
    seed: int = 0                      # sampling generator seed

    @classmethod
    def from_dict(cls, data: dict | None) -> "ServingConfig":
        """Build from a ``serving:`` mapping; unknown keys are loud
        (a typo must not silently serve the default)."""
        data = dict(data or {})
        names = {f.name: f for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - set(names))
        if unknown:
            raise ValueError(f"unknown serving keys {unknown}; known: "
                             f"{sorted(names)}")
        kw = {}
        for key, value in data.items():
            kind = names[key].type
            if kind == "bool":
                if not isinstance(value, bool):
                    raise TypeError(f"serving.{key} must be true/false, "
                                    f"got {value!r}")
                kw[key] = value
            elif kind == "int":
                kw[key] = int(str(value).replace("_", ""))
            elif kind == "float":
                kw[key] = float(value)   # PyYAML reads 1e-3 as a string
            else:
                kw[key] = "" if value is None else str(value)
        return cls(**kw)

    @classmethod
    def load(cls, path: str | Path) -> "ServingConfig":
        """Read the ``serving:`` block of a YAML file (or the whole
        file when it has no such block)."""
        data = _yaml().safe_load(Path(path).read_text()) or {}
        return cls.from_dict(data.get("serving", data))

    def make(self, params: dict, model_cfg: Any,
             compute_dtype: torch.dtype | str | None = None,
             on_recompile: str = "warn",
             device: str | torch.device = "cuda",
             tracer: Any = None):
        """Build the engine and its batcher (the single-replica branch
        of the JAX ``make``); returns the
        :class:`~torchbooster_tpu_torch.serving.ContinuousBatcher`.
        ``compute_dtype`` defaults to bf16."""
        from torchbooster_tpu_torch.serving import (
            ContinuousBatcher,
            PagedEngine,
        )

        if isinstance(compute_dtype, str):
            compute_dtype = _DTYPES[compute_dtype]
        if self.decode_backend not in _DECODE_BACKENDS:
            raise ValueError(f"serving.decode_backend must be one of "
                             f"{sorted(_DECODE_BACKENDS)}, got "
                             f"{self.decode_backend!r}")
        engine = PagedEngine(
            params, model_cfg, page_size=self.page_size,
            n_pages=self.n_pages, max_slots=self.max_slots,
            cache_dtype=self.cache_dtype or None,
            compute_dtype=compute_dtype or torch.bfloat16,
            temperature=self.temperature, top_k=self.top_k or None,
            top_p=self.top_p or None, seed=self.seed,
            prefix_cache=self.prefix_cache,
            prefill_chunk_pages=self.prefill_chunk_pages,
            decode_backend=_DECODE_BACKENDS[self.decode_backend],
            tp=self.tp,
            speculative=self.speculative, draft_len=self.draft_len,
            ngram_min=self.ngram_min, spec_tree=self.spec_tree,
            tree_width=self.spec_tree_width,
            parallel_sampling=self.parallel_sampling, device=device)
        return ContinuousBatcher(engine, on_recompile=on_recompile,
                                 tracer=tracer)


__all__ = ["BaseConfig", "DatasetConfig", "EnvConfig", "LoaderConfig",
           "OptimizerConfig", "SchedulerConfig", "ServingConfig",
           "Transform", "read_lines", "resolve_types"]
