"""Typed YAML configuration — the port of ``torchbooster_tpu/config.py``
for the training and serving slices:

- ``BaseConfig.load``: YAML with ``#include`` splicing, string
  pseudo-annotation type resolution (``tuple(float, float)``, nested
  config classes by name) and scalar coercion (``1e-3`` strings,
  ``1_024`` ints, comma tuples such as ``betas: 0.9, 0.95``); with
  ``hyperparams=True`` a generator of configs over the sweep leaves
  (``parse_sweep``: ``arange``, ``linspace``, ``logspace``,
  ``geomspace``, ``range`` and quoted literal lists, never ``eval``);
- the factories the recipes use: ``EnvConfig`` (compute dtype, this
  rank's device, and placement over the mesh of ``distributed``,
  ``n_devices`` and ``mesh``), ``CommsConfig`` (the ``comms:`` block:
  ZeRO stage, gradient wire format, overlap, buckets), ``LoaderConfig`` (workers, prefetch depth and the distributed
  shard passed through to the loader), ``OptimizerConfig`` (adamw, adam,
  sgd, lamb, lion and adafactor, driven by a schedule),
  ``SchedulerConfig`` and ``DatasetConfig`` (the whole resolution chain
  of ``data/sources.py``: registry, record store, local release,
  HuggingFace, synthetic twin);
- ``ServingConfig`` with its core fields, its nested blocks (the
  ``frontend:`` scheduler policy and HTTP server and the ``router:``
  engine fleet among them) and its ``make``; ``LoadgenConfig`` (the capture/replay
  workload source); ``ObservabilityConfig`` with its ``tracing:`` and
  ``slo:`` blocks.

Meshes take every axis of the JAX package (``dp``, ``fsdp``, ``sp``,
``ep``, ``tp``, ``pp``), and ``serving.tp`` splits the engine's heads
over a ``tp`` mesh (``serving/tp.py``). PyYAML is imported only when a
file is read."""
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


def do_include(line: str) -> str | None:
    """The include target if ``line`` is a ``#include`` directive, else
    None."""
    match = INCLUDE_PATTERN.match(line)
    return match.group(1) if match else None


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
        target = do_include(line)
        if target is not None:
            included = (path.parent / target).resolve()
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
    """Execution environment: compute precision, the device and the mesh.
    One process runs per device (``distributed.launch``); ``mesh`` names
    axes over the ranks (``dp``, ``fsdp``, ``sp``, ``ep``, ``tp``,
    ``pp``), and ``distributed: false`` degrades any topology to one
    device."""

    distributed: bool = False
    fp16: bool = False                 # alias → bf16 compute
    precision: str = ""                # "" (auto) | "fp32" | "bf16"
    n_gpu: int = -1                    # alias for n_devices (-1 unset)
    n_devices: int = 0                 # 0 → one process's device
    n_machine: int = 1
    machine_rank: int = 0
    dist_url: str = "auto"             # rendezvous ("auto": a free port)
    mesh: str = "dp"                   # axis spec: "dp" | "dp,fsdp:2" | "sp:8"

    def compute_dtype(self) -> torch.dtype:
        if self.precision == "bf16" or (not self.precision and self.fp16):
            return torch.bfloat16
        return torch.float32

    def devices(self) -> int:
        """Processes to launch on this machine (``n_devices``, else
        ``n_gpu``, else one)."""
        return self.n_devices or (self.n_gpu if self.n_gpu > 0 else 1)

    def device(self, device: str | torch.device = "cuda") -> torch.device:
        """This rank's device: its card under a process group on the
        card, else ``device`` (a card unless the caller passes
        ``"cpu"``). The mesh (``distributed.get_mesh``) is validated on
        the way."""
        from torchbooster_tpu_torch import distributed as dist

        return dist.get_mesh(self, device=device).device

    def make(self, *args: Any, model: Any = None, rules: Any = None,
             device: str | torch.device = "cuda") -> Any:
        """Place objects over the mesh (JAX ``EnvConfig.make``): tensor
        trees go to this rank's device, overwritten by rank 0's (DDP's
        initial broadcast). Pass ``model=`` (anything with
        ``SHARDING_RULES``) or ``rules=`` to lay parameters or a
        ``TrainState`` out by the rule table instead; axes absent from
        the mesh are dropped. One argument returns the object, several a
        list; use :meth:`shard_batch` for data."""
        from torchbooster_tpu_torch import distributed as dist

        if rules is None and model is not None:
            rules = getattr(model, "SHARDING_RULES", None)
        mesh = dist.get_mesh(self, device=device)
        if rules is None:
            param_axes = [a for a, s in mesh.shape.items()
                          if a != "dp" and s > 1]
            if param_axes:
                logging.warning(
                    "mesh %r has parameter-sharding axes %s but no "
                    "sharding rules were provided — parameters will "
                    "fully replicate on every device. Pass "
                    "make(..., model=<class with SHARDING_RULES>) or "
                    "rules=[...] to shard.", self.mesh, param_axes)
        placed = [dist.to_env(obj, mesh, rules=rules) for obj in args]
        return placed[0] if len(placed) == 1 else placed

    def shard_batch(self, batch: Any,
                    device: str | torch.device = "cuda") -> Any:
        """This rank's block of a global host batch, on its device: its
        contiguous rows over the mesh's data axes and, on an ``sp`` mesh,
        its contiguous chunk of dimension 1 (JAX's ``P(("dp", "fsdp"),
        "sp")`` batch spec)."""
        from torchbooster_tpu_torch import distributed as dist

        return dist.shard_batch(batch, dist.get_mesh(self, device=device))


# the reference's spelling, kept as an alias (JAX ``config.py:370``)
EnvironementConfig = EnvConfig


@dataclass
class LoaderConfig(BaseConfig):
    """Host loader settings. Batches come back as host numpy; wrap the
    loader in ``data.prefetch_to_device`` to have them copied to the card
    ahead of the step (``pin_memory`` is accepted and unused: that copy
    always stages through pinned buffers)."""

    batch_size: int = 32
    num_workers: int = 0
    pin_memory: bool = False
    drop_last: bool = True
    prefetch: int = 2                  # batches in flight past the one read

    def make(self, dataset: Any, shuffle: bool = True,
             distributed: bool = False, collate_fn: Callable | None = None,
             seed: int = 0) -> Any:
        """The loader over ``dataset``: worker threads when
        ``num_workers > 0``, and this process's shard of every global
        batch when ``distributed``."""
        from torchbooster_tpu_torch.data import DataLoader

        return DataLoader(dataset, batch_size=self.batch_size,
                          shuffle=shuffle, distributed=distributed,
                          drop_last=self.drop_last,
                          num_workers=self.num_workers,
                          prefetch=self.prefetch, collate_fn=collate_fn,
                          seed=seed)


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
    """Dataset resolution (``data/sources.py``): the builtin registry, a
    record store under ``root``, a local MNIST or CIFAR-10 release,
    HuggingFace ``datasets``, the synthetic twin, else exit."""

    name: str = "mnist"
    root: str = "dataset"
    task: str = ""                     # HF config name
    n_examples: int = 0                # synthetic-family size (0 = default)

    def make(self, split: Any, download: bool = True,
             distributed: bool = False,
             acceptance_fn: Callable | None = None, **kwargs: Any) -> Any:
        from torchbooster_tpu_torch.data import resolve_dataset

        return resolve_dataset(
            self, split, download=download, distributed=distributed,
            acceptance_fn=acceptance_fn, **kwargs)


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


@dataclass
class RouterHealthConfig(BaseConfig):
    """``serving.router.health:`` (``config.py:842``): ``enabled: true``
    attaches a :class:`~torchbooster_tpu_torch.serving.router.
    FleetHealth` scorer to the fleet. Every ``every`` fleet steps it
    folds flight-recorder anomalies, queue depth (``queue_limit``),
    claimable pages (``min_free_pages``) and readiness staleness
    (``stale_s``) into a hysteretic healthy/degraded/unhealthy state per
    replica (``degrade_after`` bad observations a level down,
    ``recover_after`` clean ones a level up), exported as
    ``router_replica_health{replica}``. The scorer only observes; routing
    consults it, through ``degraded_weight`` / ``unhealthy_weight``, only
    under ``router.health_aware``."""

    enabled: bool = False              # build the FleetHealth scorer
    every: int = 8                     # fleet steps per observation
    degrade_after: int = 2             # bad obs per level down
    recover_after: int = 4             # clean obs per level up
    queue_limit: int = 32              # queue-depth strike threshold
    min_free_pages: int = 0            # claimable-pages threshold
    stale_s: float = 2.0               # readiness staleness window
    degraded_weight: float = 4.0       # health_aware multiplier
    unhealthy_weight: float = 16.0     # health_aware multiplier

    def make(self) -> Any:
        """The :class:`FleetHealth` scorer (``None`` when disabled)."""
        if not self.enabled:
            return None
        from torchbooster_tpu_torch.serving.router import FleetHealth

        return FleetHealth(
            every=self.every, degrade_after=self.degrade_after,
            recover_after=self.recover_after,
            queue_limit=self.queue_limit,
            min_free_pages=self.min_free_pages, stale_s=self.stale_s,
            degraded_weight=self.degraded_weight,
            unhealthy_weight=self.unhealthy_weight)


@dataclass
class RouterConfig(BaseConfig):
    """``serving.router:`` (``config.py:935``): the engine fleet.

    ``n_replicas: 1`` (the default) changes nothing: ``ServingConfig.
    make`` returns the plain batcher. With ``n_replicas > 1`` it builds
    N identical engines and batchers on the one ``device``, sharing the
    params, one scheduler-policy object and one ``RequestTracer``, and
    returns an :class:`~torchbooster_tpu_torch.serving.router.
    EngineFleet`. ``replicas`` builds a mixed fleet instead: each entry
    is ``inproc`` (a local batcher) or a ``host:port`` endpoint (a
    :class:`~torchbooster_tpu_torch.serving.router.rpc.RemoteReplica` to
    a ``replica_server``); a non-empty list overrides ``n_replicas``.

    ``policy`` is ``round_robin`` or ``affinity`` (prefix affinity over
    at most ``affinity_pages`` full pages, spilling to the least-loaded
    replica when the home replica's backlog is ``spill_queue`` over the
    shallowest). ``rebalance_queue > 0`` migrates queued requests off a
    hot-spot that lasts ``rebalance_after`` steps. ``directory`` keeps
    the fleet-wide prefix directory; ``audit`` sizes the routing
    decision ring (0 = off); ``health:`` is :class:`RouterHealthConfig`,
    and ``health_aware`` (needs ``health.enabled``) lets spill and
    keyless scoring down-weight degraded replicas."""

    n_replicas: int = 1                # 1 = plain single batcher
    replicas: list = dataclasses.field(
        default_factory=list)          # "inproc" | "host:port" specs
    policy: str = "affinity"           # round_robin | affinity
    affinity_pages: int = 2            # full pages hashed into the key
    spill_queue: int = 4               # hot-prefix spill threshold
    rebalance_queue: int = 0           # 0 = hot-spot rebalance off
    rebalance_after: int = 8           # sustained-imbalance steps
    directory: bool = True             # fleet-wide prefix directory
    audit: int = 256                   # decision audit ring (0 = off)
    health_aware: bool = False         # health-weighted spill scoring
    health: RouterHealthConfig = dataclasses.field(
        default_factory=RouterHealthConfig)  # replica health scorer

    def make_routing(self) -> Any:
        from torchbooster_tpu_torch.serving.router import make_routing

        return make_routing(self.policy,
                            affinity_pages=self.affinity_pages,
                            spill_queue=self.spill_queue)

    def make(self, batchers: Any) -> Any:
        """The :class:`EngineFleet` over already-built replicas
        (normally ``ServingConfig.make``'s job)."""
        from torchbooster_tpu_torch.serving.router import EngineFleet

        if self.health_aware and not self.health.enabled:
            raise ValueError(
                "router.health_aware: true needs router.health."
                "enabled: true (there is no scorer to consult)")
        return EngineFleet(batchers, routing=self.make_routing(),
                           rebalance_queue=self.rebalance_queue,
                           rebalance_after=self.rebalance_after,
                           directory=self.directory, audit=self.audit,
                           health=self.health.make(),
                           health_aware=self.health_aware)


@dataclass
class FrontendConfig(BaseConfig):
    """``serving.frontend:`` (``config.py:624``): the scheduler policy
    and the asyncio OpenAI-compatible HTTP server.

    ``policy`` selects the scheduler: ``fcfs`` (the default: strict
    arrival order, never shed, youngest preemption victim) or ``slo``
    (earliest-slack-first admission over ``classes``, 429 +
    Retry-After when a TTFT deadline is already unmeetable, preemption
    victims by re-admission cost). ``classes`` is the priority-class
    table ``"name:ttft_ms:tpot_ms,..."`` in priority order, 0 disabling
    a deadline; ``default_class`` names the class of requests that send
    none (the first listed by default); ``shed_grace`` scales the shed
    threshold. ``max_queue`` bounds the HTTP submit queue (429 beyond
    it). ``capture_path`` records every accepted submit as a versioned
    workload written when the server stops (``capture_scrub: true``
    keeps length + seed recipes, never prompt content).
    :meth:`ServingConfig.make` installs this block's policy on every
    batcher it builds; :meth:`make` wraps a built batcher in the
    server."""

    host: str = "127.0.0.1"
    port: int = 8000                   # 0 = ephemeral (tests, smoke)
    policy: str = "fcfs"               # fcfs | slo
    classes: str = ""                  # "name:ttft_ms:tpot_ms,..."
    default_class: str = ""            # "" = first listed class
    shed_grace: float = 1.0
    max_queue: int = 64
    capture_path: str = ""             # "" = no workload capture
    capture_scrub: bool = False        # capture recipes, not prompts

    def make_policy(self) -> Any:
        """Build the scheduler policy object the batcher consumes."""
        from torchbooster_tpu_torch.serving.frontend import (
            FCFSPolicy, SLOPolicy, parse_classes)

        if self.policy == "fcfs":
            return FCFSPolicy()
        if self.policy == "slo":
            return SLOPolicy(parse_classes(self.classes),
                             default=self.default_class,
                             shed_grace=self.shed_grace)
        raise ValueError(
            f"frontend.policy must be 'fcfs' or 'slo', got "
            f"{self.policy!r}")

    def make(self, batcher: Any, codec: Any = None) -> Any:
        """The :class:`~torchbooster_tpu_torch.serving.frontend.
        ServingFrontend` over an already-built batcher (normally
        ``ServingConfig.make(...)``'s). ``await frontend.start()`` binds
        and serves."""
        from torchbooster_tpu_torch.serving.frontend import ServingFrontend

        return ServingFrontend(batcher, host=self.host,
                               port=self.port, codec=codec,
                               max_queue=self.max_queue,
                               capture_path=self.capture_path or None,
                               capture_scrub=self.capture_scrub)


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
        elif kind == "list":
            items = value.split(",") if isinstance(value, str) else value
            kw[key] = [str(v).strip() for v in items or ()]
        else:
            kw[key] = "" if value is None else str(value)
    return cls(**kw)


_NESTED_SERVING = {"FrontendConfig": FrontendConfig,
                   "StructuredConfig": StructuredConfig,
                   "WeightsConfig": WeightsConfig,
                   "AdaptersConfig": AdaptersConfig,
                   "HostSpillConfig": HostSpillConfig,
                   "DisaggConfig": DisaggConfig,
                   "RouterConfig": RouterConfig,
                   "RouterHealthConfig": RouterHealthConfig}


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
    ``tp > 1`` runs one engine per rank of a ``tp`` mesh axis of that
    size, each over its head shard (``serving/tp.py``; pass the mesh to
    :meth:`make`). The nested ``frontend:``, ``router:``, ``structured:``,
    ``weights:``, ``adapters:``, ``host_spill:`` and ``disagg:`` blocks
    are :class:`FrontendConfig`, :class:`RouterConfig`,
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
    frontend: FrontendConfig = dataclasses.field(
        default_factory=FrontendConfig)  # HTTP front door + scheduler
    router: RouterConfig = dataclasses.field(
        default_factory=RouterConfig)  # engine-fleet replica scale-out
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
        return _from_mapping(cls, dict(data or {}), "serving")

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
             tracer: Any = None, mesh: Any = None):
        """Build the engines and their batchers; returns the
        :class:`~torchbooster_tpu_torch.serving.ContinuousBatcher`, with
        ``disagg.enabled`` a
        :class:`~torchbooster_tpu_torch.serving.disagg.DisaggPair` over a
        prefill-only engine and that batcher, and with a multi-replica
        ``router:`` block an :class:`~torchbooster_tpu_torch.serving.
        router.EngineFleet`. The ``frontend:`` block's scheduler policy
        is built once and installed on every batcher
        (``self.frontend.make(batcher)`` wraps it in the HTTP server).
        ``compute_dtype`` defaults to bf16. The ``weights:`` block
        quantizes ``params`` once, before any engine is built.
        ``tracer`` is installed on every batcher; a fleet without one
        gets one shared ``RequestTracer``. ``mesh`` is the mesh a ``tp >
        1`` engine splits its heads over (``distributed.make_mesh``, its
        ``tp`` axis of exactly that size), checked here before anything
        is built."""
        from torchbooster_tpu_torch.serving import (
            ContinuousBatcher,
            PagedEngine,
        )
        from torchbooster_tpu_torch.serving.tp import check_tp

        check_tp(self.tp, model_cfg, mesh)

        if isinstance(compute_dtype, str):
            compute_dtype = _DTYPES[compute_dtype]
        if self.decode_backend not in _DECODE_BACKENDS:
            raise ValueError(f"serving.decode_backend must be one of "
                             f"{sorted(_DECODE_BACKENDS)}, got "
                             f"{self.decode_backend!r}")
        params = self.weights.quantize(params)
        n_replicas = self.router.n_replicas
        if n_replicas < 1:
            raise ValueError(f"serving.router.n_replicas must be >= 1, got "
                             f"{n_replicas}")
        if n_replicas > 1 and self.tp > 1:
            raise ValueError(
                f"serving.router.n_replicas={n_replicas} with "
                f"tp={self.tp} is not buildable from YAML: every "
                "replica would shard over the SAME tp mesh axis — "
                "build EngineFleet directly with per-replica meshes")

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
                prefill_only=prefill_only, device=device, mesh=mesh)

        # one policy object serves every batcher built here (policies
        # are stateless over their class tables)
        policy = self.frontend.make_policy()
        if self.disagg.enabled:
            from torchbooster_tpu_torch.serving.disagg import DisaggPair

            if n_replicas > 1 or self.router.replicas:
                raise ValueError(
                    "serving.disagg.enabled with a multi-replica router "
                    "block: disaggregate AND replicate by building the "
                    "fleet directly over DisaggPairs")
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
                                       policy=policy, tracer=tracer)
            prefill = build_engine(
                prefill_only=True,
                n_pages=self.disagg.prefill_n_pages or None,
                max_slots=self.disagg.prefill_max_slots or None,
                host_spill=False)
            return DisaggPair(
                prefill, decode,
                min_prefill_pages=self.disagg.min_prefill_pages)
        if self.router.replicas:
            from torchbooster_tpu_torch.serving.router.rpc import (
                RemoteReplica,
            )

            members = []
            for i, spec in enumerate(self.router.replicas):
                spec = str(spec).strip()
                if spec == "inproc":
                    members.append(ContinuousBatcher(
                        build_engine(), on_recompile=on_recompile,
                        policy=policy, tracer=tracer))
                elif ":" in spec:
                    members.append(RemoteReplica(spec, replica_id=i))
                else:
                    raise ValueError(
                        f"serving.router.replicas[{i}]={spec!r}: expected "
                        "'inproc' or a 'host:port' endpoint")
            return self.router.make(members)
        if n_replicas == 1:
            return ContinuousBatcher(build_engine(),
                                     on_recompile=on_recompile,
                                     policy=policy, tracer=tracer)
        # the fleet: N identical replicas on the one device, sharing the
        # params, the policy and ONE tracer ring (so /debug/trace follows
        # a request across replicas by its id)
        if tracer is None:
            from torchbooster_tpu_torch.observability.tracing import (
                RequestTracer,
            )

            tracer = RequestTracer()
        return self.router.make([
            ContinuousBatcher(build_engine(), on_recompile=on_recompile,
                              policy=policy, tracer=tracer)
            for _ in range(n_replicas)])


@dataclass
class LoadgenConfig(BaseConfig):
    """The capture/replay harness's workload source (``config.py:1323``,
    ``serving/loadgen``).

    ``source`` is a synthetic kind (``poisson`` | ``bursty`` |
    ``diurnal`` | ``sharegpt`` | ``longprompt_burst``) or a path to a
    captured workload (recognized by a ``.jsonl``/``.json`` suffix or by
    existing on disk). ``speed`` is the time compression replays default
    to (recorded as the workload's ``meta["speed"]``). ``classes`` is a
    ``"name:weight,..."`` priority mix; ``cancel_frac`` of requests get
    a recorded client disconnect; ``prompt_len`` / ``max_new_tokens``
    are inclusive ``(lo, hi)`` ranges; ``n_frac`` / ``n_max`` give
    parallel-sampling fan-out, ``structured_frac`` a library
    ``response_format``, ``tenants`` / ``prefix_pages`` /
    ``prefix_page_size`` shared page-aligned tenant prefixes, and
    ``long_prompt_len`` / ``long_frac`` the extra long prompts of
    ``longprompt_burst``. ``make()`` returns the
    :class:`~torchbooster_tpu_torch.serving.loadgen.workload.Workload`;
    drive it with ``replay_inprocess(batcher, wl)`` or
    ``replay_http(port, wl)``."""

    source: str = "poisson"            # kind | capture-file path
    n_requests: int = 32
    rate: float = 8.0                  # offered req/s (synthetic)
    speed: float = 1.0                 # replay time-compression x
    seed: int = 0
    vocab: int = 50257
    prompt_len: tuple(int, int) = (16, 64)
    max_new_tokens: tuple(int, int) = (8, 32)
    classes: str = ""                  # "name:weight,..." mix
    cancel_frac: float = 0.0           # recorded client disconnects
    n_frac: float = 0.0                # fraction with n/best_of > 1
    n_max: int = 4                     # largest synthetic n
    structured_frac: float = 0.0       # fraction with response_format
    tenants: int = 0                   # 0 = no shared tenant prefixes
    prefix_pages: int = 0              # tenant system-prompt pages
    prefix_page_size: int = 64         # page alignment of the prefix
    long_prompt_len: tuple(int, int) = (256, 512)  # longprompt_burst
    long_frac: float = 0.25            # extra long requests / n_requests

    def make(self) -> Any:
        from torchbooster_tpu_torch.serving.loadgen.workload import (
            SYNTHETIC_KINDS, Workload, synthesize)

        if self.speed <= 0:
            raise ValueError(
                f"loadgen.speed must be > 0, got {self.speed}")
        src = self.source.strip()
        if src.endswith((".jsonl", ".json")) or Path(src).exists():
            wl = Workload.load(src)
        elif src not in SYNTHETIC_KINDS:
            raise ValueError(
                f"loadgen.source={src!r}: expected a synthetic kind "
                f"{SYNTHETIC_KINDS} or a capture file path (got "
                "neither — a typo'd path would silently synthesize "
                "the wrong traffic)")
        else:
            wl = synthesize(
                src, n_requests=self.n_requests, rate=self.rate,
                seed=self.seed, vocab=self.vocab,
                prompt_len=tuple(self.prompt_len),
                max_new_tokens=tuple(self.max_new_tokens),
                classes=self.classes, cancel_frac=self.cancel_frac,
                n_frac=self.n_frac, n_max=self.n_max,
                structured_frac=self.structured_frac,
                tenants=self.tenants,
                prefix_pages=self.prefix_pages,
                page_size=self.prefix_page_size,
                long_prompt_len=tuple(self.long_prompt_len),
                long_frac=self.long_frac)
        # the replay default: drivers called without an explicit speed=
        # read it back (meta never enters the content fingerprint)
        wl.meta["speed"] = float(self.speed)
        return wl


@dataclass
class CommsConfig(BaseConfig):
    """Gradient-communication schedule (``comms/``): the ZeRO stage, the
    wire format of the data-parallel gradient sync, and whether the sync
    overlaps backward (JAX ``CommsConfig``).

    YAML block::

        comms:
          stage: 0           # ZeRO ladder: 0 | 1 | 2 | 3
          wire: fp32         # fp32 | bf16 | int8 (grad wire format)
          overlap: false     # stage>=2: reduce-scatter inside backward
          bucket_mb: 4.0     # comm-bucket size for the overlapped sync
          bucket_size: 512   # int8 quantization bucket (fp32 scale each)

    ``stage: 0`` all-reduces gradients explicitly; ``1`` shards the
    optimizer update; ``2`` reduce-scatters gradients bucket by bucket —
    during backward with ``overlap: true``; ``3`` also shards the
    parameters at rest and gathers them in forward, inherently
    overlapped, so ``overlap`` normalizes to true. ``wire: bf16``/``int8``
    compress the gradient bytes 2x/about 4x (int8 carries error-feedback
    residuals in ``TrainState.comms``). Omitting the block keeps the
    implicit all-reduce. The legacy keys ``mode:`` and ``zero1:`` still
    load, shimmed onto ``{stage: 0|1, wire: mode}`` with a deprecation
    note, and cannot be mixed with the schedule keys."""

    stage: int = -1                    # 0 | 1 | 2 | 3 (-1: unset/legacy)
    wire: str = ""                     # fp32 | bf16 | int8 ("": unset)
    overlap: bool = False              # stage>=2 only
    bucket_mb: float = 4.0             # comm-bucket target (MB, fp32)
    mode: str = "implicit"             # legacy: implicit|fp32|bf16|int8
    zero1: bool = False                # legacy: stage-1 switch
    bucket_size: int = 512

    def make(self, env: Any = None, mesh: Any = None,
             device: str | torch.device = "cuda") -> Any:
        """The :class:`~torchbooster_tpu_torch.comms.CommsSchedule` for
        ``mesh`` (or the ``env``'s mesh, on ``device``): pass it to
        ``utils.make_step(comms=...)`` and build states with
        ``.create_state(params, tx)``."""
        from torchbooster_tpu_torch import distributed as dist
        from torchbooster_tpu_torch.comms import make_schedule

        if mesh is None:
            mesh = dist.get_mesh(env, device=device)
        selector_keys = {}
        if self.stage != -1:
            selector_keys["stage"] = self.stage
        if self.wire:
            selector_keys["wire"] = self.wire
        if self.overlap:
            selector_keys["overlap"] = self.overlap
        tuning_keys = {}
        if self.bucket_mb != 4.0:
            tuning_keys["bucket_mb"] = self.bucket_mb
        new_keys = {**selector_keys, **tuning_keys}
        legacy_keys = {}
        if self.mode != "implicit":
            legacy_keys["mode"] = self.mode
        if self.zero1:
            legacy_keys["zero1"] = self.zero1
        if new_keys and legacy_keys:
            raise ValueError(
                f"comms: block mixes legacy keys "
                f"{sorted(legacy_keys)} with schedule keys "
                f"{sorted(new_keys)} — express the whole plan as "
                f"stage/wire/overlap (mode: {self.mode!r} zero1: "
                f"{self.zero1} is comms: {{stage: "
                f"{1 if self.zero1 else 0}, wire: {self.mode!r}}})")
        if tuning_keys and not selector_keys:
            raise ValueError(
                f"comms: {{bucket_mb: {self.bucket_mb}}} only shapes "
                f"the stage>=2 comm buckets — on its own it would "
                f"silently replace the implicit psum with an explicit "
                f"stage-0 sync. Add stage: (and wire:) to select the "
                f"schedule, or drop bucket_mb.")
        if new_keys:
            return make_schedule(mesh,
                                 stage=max(0, self.stage),
                                 wire=self.wire or "fp32",
                                 overlap=self.overlap,
                                 bucket_mb=self.bucket_mb,
                                 bucket_size=self.bucket_size)
        # legacy shim: mode/zero1 map onto stages 0/1
        stage = 1 if self.zero1 else 0
        if legacy_keys:
            logging.warning(
                "comms: mode/zero1 are deprecated — this block is the "
                "schedule comms: {stage: %d, wire: %s}; the schedule "
                "keys also unlock stage 2/3 and overlap",
                stage, self.mode)
        from torchbooster_tpu_torch.comms import as_schedule, make_grad_comms

        return as_schedule(make_grad_comms(
            mesh, mode=self.mode, zero1=self.zero1,
            bucket_size=self.bucket_size))


@dataclass
class TracingConfig(BaseConfig):
    """``observability.tracing:`` (``config.py:1548``): ``enabled``
    turns on the per-request lifecycle events of a ``ring_size`` ring.
    ``make()`` builds the
    :class:`~torchbooster_tpu_torch.observability.tracing.RequestTracer`
    (pass it to ``ServingConfig.make(tracer=...)``); ``export(tracer)``
    writes ``trace_path`` (JSONL) / ``chrome_path`` (Chrome trace-event
    JSON) when set."""

    enabled: bool = False
    ring_size: int = 8192
    trace_path: str = ""               # JSONL event dump on export()
    chrome_path: str = ""              # Chrome trace dump on export()

    def make(self) -> Any:
        from torchbooster_tpu_torch.observability.tracing import (
            RequestTracer)

        return RequestTracer(enabled=self.enabled,
                             ring_size=self.ring_size)

    def export(self, tracer: Any) -> list:
        """Write the configured trace file(s) from ``tracer``'s ring;
        returns the paths written (empty when both paths are '')."""
        written = []
        if self.trace_path:
            written.append(tracer.write_jsonl(self.trace_path))
        if self.chrome_path:
            written.append(tracer.write_chrome(self.chrome_path))
        return written


@dataclass
class SLOBurnConfig(BaseConfig):
    """``observability.slo:`` (``config.py:1594``): the multi-window
    burn-rate alerting engine. ``make()`` builds the
    :class:`~torchbooster_tpu_torch.observability.slo.SLOBurnEngine` (or
    None when disabled); ``ObservabilityConfig.make()`` hands it to the
    cadence exporter."""

    enabled: bool = False
    target: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fire_burn: float = 2.0
    resolve_burn: float = 1.0
    goodput_floor_tok_s: float = 0.0   # 0 disables the goodput alert

    def make(self, sink: Any = None) -> Any:
        if not self.enabled:
            return None
        from torchbooster_tpu_torch.observability.slo import SLOBurnEngine

        return SLOBurnEngine(
            target=self.target,
            fast_window_s=self.fast_window_s,
            slow_window_s=self.slow_window_s,
            fire_burn=self.fire_burn,
            resolve_burn=self.resolve_burn,
            goodput_floor_tok_s=self.goodput_floor_tok_s,
            sink=sink)


@dataclass
class ObservabilityConfig(BaseConfig):
    """``observability:`` (``config.py:1641``): the telemetry switch and
    exporter wiring. ``make()`` returns an
    :class:`~torchbooster_tpu_torch.observability.Observability` session
    handle (a context manager that flushes the exporter on exit); with
    ``enabled: false`` it turns the default registry off and the handle
    is inert. ``jsonl_path`` / ``prom_path`` ('' disables each) are
    written every ``cadence_s``; ``on_recompile`` is ``ignore``,
    ``warn`` or ``raise``; ``tracing:`` is :class:`TracingConfig` and
    ``slo:`` :class:`SLOBurnConfig` (its engine rides the exporter
    cadence)."""

    enabled: bool = False
    jsonl_path: str = ""
    prom_path: str = ""
    cadence_s: float = 10.0
    on_recompile: str = "warn"         # ignore | warn | raise
    tracing: TracingConfig = dataclasses.field(
        default_factory=TracingConfig)  # request-scoped tracing
    slo: SLOBurnConfig = dataclasses.field(
        default_factory=SLOBurnConfig)  # burn-rate alerting

    def make(self) -> Any:
        from torchbooster_tpu_torch import observability as obs
        from torchbooster_tpu_torch.observability.recompile import POLICIES

        if self.on_recompile not in POLICIES:
            raise ValueError(
                f"on_recompile={self.on_recompile!r}: expected one "
                f"of {POLICIES}")
        if not self.enabled:
            # authoritative: `enabled: false` turns the process default
            # OFF even if an earlier session enabled it
            return obs.Observability(obs.set_enabled(False),
                                     on_recompile=self.on_recompile)
        return obs.enable(jsonl_path=self.jsonl_path or None,
                          prom_path=self.prom_path or None,
                          cadence_s=self.cadence_s,
                          on_recompile=self.on_recompile,
                          slo=self.slo.make())


__all__ = ["AdaptersConfig", "BaseConfig", "CommsConfig", "DatasetConfig",
           "DisaggConfig", "EnvConfig", "EnvironementConfig",
           "FrontendConfig", "HostSpillConfig", "HyperParameterConfig",
           "LoadgenConfig", "LoaderConfig", "ObservabilityConfig",
           "OptimizerConfig", "SLOBurnConfig", "SchedulerConfig",
           "ServingConfig", "StructuredConfig", "TracingConfig",
           "Transform", "WeightsConfig", "do_include", "parse_sweep",
           "read_lines", "resolve_types"]
