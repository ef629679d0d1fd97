"""Typed YAML configuration — the port of ``torchbooster_tpu/config.py``
for the training and serving slices:

- ``BaseConfig.load``: YAML with ``#include`` splicing, string
  pseudo-annotation type resolution (``tuple(float, float)``, nested
  config classes by name) and scalar coercion (``1e-3`` strings,
  ``1_024`` ints, comma tuples such as ``betas: 0.9, 0.95``); with
  ``hyperparams=True`` a generator of configs over the sweep leaves
  (``parse_sweep``: ``arange``, ``linspace``, ``logspace``,
  ``geomspace``, ``range`` and quoted literal lists, never ``eval``);
- the factories the GPT recipe uses: ``EnvConfig`` (compute dtype and
  device), ``LoaderConfig``, ``OptimizerConfig`` (adamw, adam, sgd,
  lamb, lion and adafactor, driven by a schedule), ``SchedulerConfig``
  and ``DatasetConfig`` (the builtin registry);
- ``ServingConfig`` with its core fields and a single-replica ``make``.

Not ported yet (``ROADMAP.md`` A-4 to A-6): meshes and distributed
environments, loader workers, and the serving router, disagg and
front-door sub-blocks. Configurations that need them raise
``NotImplementedError``. PyYAML is imported only when a file is read."""
from __future__ import annotations

import ast
import builtins
import copy
import dataclasses
import itertools
import logging
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
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


# ------------------------------------------------------------- sweeps
_SWEEP_CALL = re.compile(
    r"^\s*(arange|linspace|logspace|geomspace|range)\s*\((.*)\)\s*$")


def parse_sweep(text: Any) -> list[Any] | None:
    """The values of a sweep expression in a YAML string leaf, or None
    when the leaf is not one. Parsed without ``eval``:
    ``arange(start, stop[, step])``, ``linspace(a, b, n)``,
    ``logspace(a, b, n)`` and ``geomspace(a, b, n)`` with numpy's
    semantics, ``range(...)`` with Python's, and a quoted literal list
    such as ``"[1, 2, 3]"``."""
    if not isinstance(text, str):
        return None
    stripped = text.strip()
    if stripped.startswith("[") and stripped.endswith("]"):
        try:
            parsed = ast.literal_eval(stripped)
        except (ValueError, SyntaxError):
            return None
        return list(parsed) if isinstance(parsed, (list, tuple)) else None
    match = _SWEEP_CALL.match(stripped)
    if not match:
        return None
    func, args_text = match.groups()
    try:
        args = [ast.literal_eval(arg.strip())
                for arg in args_text.split(",") if arg.strip()]
    except (ValueError, SyntaxError):
        return None
    if not all(isinstance(a, (int, float)) for a in args):
        return None
    try:
        if func == "range":
            return list(range(*[int(a) for a in args]))
        values = getattr(np, func)(*args)
    except (TypeError, ValueError):
        return None
    return [v.item() for v in np.asarray(values).ravel()]


class HyperParameterConfig:
    """The sweep over a YAML document's string leaves that
    :func:`parse_sweep` reads as sweeps: every combination, in
    ``itertools.product`` order over the leaves in document order (the
    last leaf turns fastest), yields one typed config of ``cls``."""

    def __init__(self, cls: type, stream: str):
        self.cls = cls
        self.data = _yaml().safe_load(stream) or {}
        self.axes: list[tuple[tuple[Any, ...], list[Any]]] = []
        self._find(self.data, ())

    def _find(self, node: Any, path: tuple[Any, ...]) -> None:
        if isinstance(node, dict):
            for key, value in node.items():
                self._find(value, (*path, key))
        elif isinstance(node, list):
            for i, value in enumerate(node):
                self._find(value, (*path, i))
        else:
            values = parse_sweep(node)
            if values is not None:
                self.axes.append((path, values))

    def gen_cfg(self) -> Iterator[Any]:
        for combo in itertools.product(*(v for _, v in self.axes)):
            data = copy.deepcopy(self.data)
            for (path, _), value in zip(self.axes, combo):
                node = data
                for key in path[:-1]:
                    node = node[key]
                node[path[-1]] = value
            yield self.cls(**resolve_types(self.cls, data))


@dataclass
class BaseConfig:
    """Base class for typed YAML configs: ``@dataclass`` subclasses
    whose ``make`` builds the runtime object they describe."""

    def make(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError("BaseConfig subclasses must implement "
                                  "make()")

    @classmethod
    def load(cls, path: str | Path, hyperparams: bool = False):
        """One config from the YAML file ``path`` (``#include``
        spliced), or with ``hyperparams`` a generator of one config per
        point of its sweep (:class:`HyperParameterConfig`)."""
        stream = "\n".join(read_lines(path))
        if hyperparams:
            return HyperParameterConfig(cls, stream).gen_cfg()
        data = _yaml().safe_load(stream) or {}
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
    """Optimizer factory with the JAX package's semantics:

    - ``adamw``: ``torch.optim.AdamW`` in its default implementation
      computes what ``optax.adamw`` does — bias-corrected moments, eps
      outside the sqrt, and the decoupled decay ``p − lr·(u + wd·p)``;
    - ``adam``: no weight decay, as ``optax.adam``;
    - ``sgd``: ``torch.optim.SGD``, whose momentum buffer starts at the
      first gradient and then takes ``μ·buf + (1−d)·g`` — the torch
      semantics the JAX package reproduces for ``dampening``; weight
      decay adds ``wd·p`` to the gradient first;
    - ``amsgrad`` (adam/adamw): torch's rule, which the JAX package
      reproduces;
    - ``lamb``, ``lion`` and ``adafactor``: the optax chains of
      ``optim.py`` — lamb with ``betas``, ``eps`` and the decay, lion
      with ``betas`` (``b2`` is ``betas[1]``) and the decay, adafactor at
      optax's defaults, ignoring ``betas``, ``eps``, ``weight_decay`` and
      ``decay_matrices_only`` as the JAX package does.

    ``decay_matrices_only`` keeps the decay off rank <= 1 leaves, and
    ``agc`` clips every unit's gradient before any of them
    (:class:`Transform`)."""

    name: str = "adamw"     # sgd | adam | adamw | lamb | lion | adafactor
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
        from torchbooster_tpu_torch import optim

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
        elif name == "lamb":
            factory = lambda groups, lr: optim.Lamb(
                groups, lr=lr, betas=betas, eps=self.eps)
        elif name == "lion":
            factory = lambda groups, lr: optim.Lion(groups, lr=lr,
                                                    betas=betas)
        elif name == "adafactor":
            factory = lambda groups, lr: optim.Adafactor(
                [{"params": g["params"]} for g in groups], lr=lr)
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


@dataclass
class StructuredConfig(BaseConfig):
    """``serving.structured:`` (``torchbooster_tpu/config.py:735``):
    ``enabled: true`` builds the engine with the token-DFA machinery, so
    requests may carry a constraining ``response_format``
    (``json_object``, ``json_schema``, ``regex``; each needs an
    ``eos_id``). Off, such a request is rejected at submit."""

    enabled: bool = False              # token-DFA constrained decoding


@dataclass
class WeightsConfig(BaseConfig):
    """``serving.weights:`` (``config.py:765``): ``dtype: int8``
    quantizes every block dense kernel per output channel and the
    embedding table per row, once, before the engine is built; ``int4``
    packs two values a byte with scales per ``group_size`` input rows
    (even, dividing every kernel's input dim). ``bf16`` (the default)
    leaves the params untouched."""

    dtype: str = "bf16"                # bf16 (off) | int8 | int4
    group_size: int = 64               # int4 scale group (input rows)

    def quantize(self, params: dict) -> dict:
        """Apply this block to a params tree (identity at bf16)."""
        if self.dtype in ("", "bf16"):
            return params
        from torchbooster_tpu_torch.models.quant import quantize_params

        return quantize_params(params, self.dtype,
                               group_size=self.group_size)


@dataclass
class AdaptersConfig(BaseConfig):
    """``serving.adapters:`` (``config.py:811``): ``rank > 0`` builds
    ``max_live + 1`` device adapter lanes (lane 0 the zero adapter) on
    the attention projections; register adapters through
    ``batcher.engine.adapters.register(name, weights)`` and name them in
    ``Request(adapter=...)``. Smaller ranks zero-pad to ``rank``."""

    rank: int = 0                      # 0 = off; the lanes' rank
    max_live: int = 4                  # device adapter lanes


@dataclass
class HostSpillConfig(BaseConfig):
    """``serving.host_spill:`` (``config.py:704``): ``enabled: true``
    (needs ``prefix_cache: true``) turns LRU eviction of registered
    prefix pages into DEMOTION — the page's K/V go to a host pool as int8
    plus fp32 per-(token, head) scales (int8 pools copy losslessly),
    bounded by ``budget_mb`` — and a later request matching the chain
    promotes them back through one fixed-shape device write instead of
    recomputing their prefill. Off, eviction frees pages and nothing is
    staged."""

    enabled: bool = False              # demote instead of free
    budget_mb: float = 64.0            # host LRU pool byte budget


@dataclass
class DisaggConfig(BaseConfig):
    """``serving.disagg:`` (``config.py:902``): ``enabled: true`` makes
    :meth:`ServingConfig.make` return a
    :class:`~torchbooster_tpu_torch.serving.disagg.DisaggPair` — a
    prefill-only engine and the decode batcher joined by a framed page
    stream in the host-spill demotion format. Requests with at least
    ``min_prefill_pages`` full prompt pages prefill on the prefill pool
    and enter the decode pool through its host tier's promotion write;
    shorter ones go straight to the decode batcher. Needs ``prefix_cache:
    true`` and ``host_spill.enabled: true``. ``prefill_n_pages`` /
    ``prefill_max_slots`` size the prefill pool (0 = the serving
    geometry)."""

    enabled: bool = False              # split prefill/decode pools
    min_prefill_pages: int = 1         # full pages to route long
    prefill_n_pages: int = 0           # 0 = serving.n_pages
    prefill_max_slots: int = 0         # 0 = serving.max_slots


def _from_mapping(cls: type, data: dict, prefix: str):
    """A ``serving:`` dataclass (or one of its nested blocks, named
    ``prefix`` in errors) from a YAML mapping, each value coerced to its
    field's type."""
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - set(names))
    if unknown:
        raise ValueError(f"unknown {prefix} keys {unknown}; known: "
                         f"{sorted(names)}")
    kw = {}
    for key, value in data.items():
        kind = names[key].type
        if kind in _NESTED_SERVING:
            if not isinstance(value, dict):
                raise TypeError(f"{prefix}.{key} must be a mapping, got "
                                f"{value!r}")
            kw[key] = _from_mapping(_NESTED_SERVING[kind], value,
                                    f"{prefix}.{key}")
        elif kind == "bool":
            if not isinstance(value, bool):
                raise TypeError(f"{prefix}.{key} must be true/false, got "
                                f"{value!r}")
            kw[key] = value
        elif kind == "int":
            kw[key] = int(str(value).replace("_", ""))
        elif kind == "float":
            kw[key] = float(value)   # PyYAML reads 1e-3 as a string
        else:
            kw[key] = "" if value is None else str(value)
    return cls(**kw)


_NESTED_SERVING = {"StructuredConfig": StructuredConfig,
                   "WeightsConfig": WeightsConfig,
                   "AdaptersConfig": AdaptersConfig,
                   "HostSpillConfig": HostSpillConfig,
                   "DisaggConfig": DisaggConfig}


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
    ``tp > 1``, not ported yet, raises ``NotImplementedError``, and so
    does a ``router:`` block. The nested ``structured:``, ``weights:``,
    ``adapters:``, ``host_spill:`` and ``disagg:`` blocks are
    :class:`StructuredConfig`, :class:`WeightsConfig`,
    :class:`AdaptersConfig`, :class:`HostSpillConfig` and
    :class:`DisaggConfig`."""

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
    structured: StructuredConfig = dataclasses.field(
        default_factory=StructuredConfig)  # constrained decoding
    weights: WeightsConfig = dataclasses.field(
        default_factory=WeightsConfig)  # int8/int4 weight serving
    adapters: AdaptersConfig = dataclasses.field(
        default_factory=AdaptersConfig)  # batched multi-LoRA lanes
    host_spill: HostSpillConfig = dataclasses.field(
        default_factory=HostSpillConfig)  # host-memory page spill tier
    disagg: DisaggConfig = dataclasses.field(
        default_factory=DisaggConfig)  # split prefill/decode pools

    @classmethod
    def from_dict(cls, data: dict | None) -> "ServingConfig":
        """Build from a ``serving:`` mapping; unknown keys are loud
        (a typo must not silently serve the default)."""
        data = dict(data or {})
        if "router" in data:
            raise NotImplementedError(
                "serving.router: router blocks are not ported (A-4)")
        return _from_mapping(cls, data, "serving")

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
        """Build the engine and its batcher (the single-replica branches
        of the JAX ``make``); returns the
        :class:`~torchbooster_tpu_torch.serving.ContinuousBatcher`, or,
        with ``disagg.enabled``, a
        :class:`~torchbooster_tpu_torch.serving.disagg.DisaggPair` over a
        prefill-only engine and that batcher. ``compute_dtype`` defaults
        to bf16. The ``weights:`` block quantizes ``params`` once, before
        any engine is built."""
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
        params = self.weights.quantize(params)

        def build_engine(*, prefill_only=False, n_pages=None,
                         max_slots=None, host_spill=None):
            return PagedEngine(
                params, model_cfg, page_size=self.page_size,
                n_pages=n_pages or self.n_pages,
                max_slots=max_slots or self.max_slots,
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
                parallel_sampling=self.parallel_sampling,
                structured=self.structured.enabled,
                lora_rank=self.adapters.rank,
                lora_max_live=(self.adapters.max_live
                               if self.adapters.rank > 0 else 0),
                host_spill=(self.host_spill.enabled if host_spill is None
                            else host_spill),
                host_spill_mb=self.host_spill.budget_mb,
                prefill_only=prefill_only, device=device)

        if self.disagg.enabled:
            from torchbooster_tpu_torch.serving.disagg import DisaggPair

            if not (self.prefix_cache and self.host_spill.enabled):
                raise ValueError(
                    "serving.disagg needs prefix_cache: true and "
                    "host_spill.enabled: true — the page stream lands in "
                    "the decode pool's host tier")
            if self.disagg.min_prefill_pages < 1:
                raise ValueError(
                    f"serving.disagg.min_prefill_pages must be >= 1, got "
                    f"{self.disagg.min_prefill_pages}")
            decode = ContinuousBatcher(build_engine(),
                                       on_recompile=on_recompile,
                                       tracer=tracer)
            prefill = build_engine(
                prefill_only=True,
                n_pages=self.disagg.prefill_n_pages or None,
                max_slots=self.disagg.prefill_max_slots or None,
                host_spill=False)
            return DisaggPair(
                prefill, decode,
                min_prefill_pages=self.disagg.min_prefill_pages)
        return ContinuousBatcher(build_engine(), on_recompile=on_recompile,
                                 tracer=tracer)


__all__ = ["AdaptersConfig", "BaseConfig", "DatasetConfig", "DisaggConfig",
           "EnvConfig", "HostSpillConfig", "HyperParameterConfig",
           "LoaderConfig", "OptimizerConfig",
           "SchedulerConfig", "ServingConfig", "StructuredConfig",
           "Transform", "WeightsConfig", "parse_sweep", "read_lines",
           "resolve_types"]
