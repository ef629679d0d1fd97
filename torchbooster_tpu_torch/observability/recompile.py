"""Recompile sentinel: turn "this region must not compile" into a
runtime guard.

The serving engine's fixed-shape contract (engine.py: the decode
step's operand shapes depend only on pool geometry) is watched here as
a count of DISTINCT decode-step shape signatures — the port's analogue
of the JAX package's jit cache size, and what a CUDA-graph capture of
the step will need. This module watches such counts around any region
and counts / warns / raises when the region added more than expected —
so a shape leak (a batch remainder, a new prompt length) surfaces in
telemetry instead of as a silent latency cliff.

>>> with RecompileSentinel([step], on_recompile="raise"):
...     state, metrics = step(state, batch)     # steady state: 0 compiles

``expected=`` budgets legitimate compiles (the very first call);
``watch(...)`` is the decorator-style convenience.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Iterable

from torchbooster_tpu_torch.observability.registry import Registry, get_registry

__all__ = ["POLICIES", "RecompileError", "RecompileSentinel",
           "cache_size"]

# the accepted on_recompile policy set — THE single source of truth
# (batcher/config build-time validation imports this; re-inlined
# literals would drift when a policy is added)
POLICIES = ("ignore", "warn", "raise")
_POLICIES = POLICIES


class RecompileError(RuntimeError):
    """Raised under ``on_recompile="raise"`` when a watched region
    compiled more than its budget."""


def cache_size(fn: Any) -> int:
    """Shape-signature count behind a callable: its ``_cache_size()``
    when it has one, else the value of a zero-arg int callable (e.g. a
    lambda over ``PagedEngine.decode_compiles``), else 0."""
    sizer = getattr(fn, "_cache_size", None)
    if sizer is not None:
        return int(sizer())
    if callable(fn):
        try:
            value = fn()
        except TypeError:
            return 0
        if isinstance(value, int):
            return value
    return 0


class RecompileSentinel:
    """Watch jit cache sizes around a region.

    ``fns``: jitted callables (anything with ``_cache_size()``) or
    zero-arg int callables returning a compile count. ``expected``
    budgets compiles that are *supposed* to happen inside the region
    (pass 1 around a first call). On exit, compiles beyond the budget
    increment the ``recompiles_total`` counter (labeled by region
    name) and apply the policy: ``ignore`` | ``warn`` | ``raise``.

    Re-enterable and reusable; ``extra`` holds the last region's
    over-budget compile count for callers that branch on it.
    """

    def __init__(self, fns: Iterable[Any] | Any,
                 on_recompile: str = "warn", expected: int = 0,
                 name: str = "region",
                 registry: Registry | None = None):
        if on_recompile not in _POLICIES:
            raise ValueError(
                f"on_recompile={on_recompile!r}: expected one of "
                f"{_POLICIES}")
        self.fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
        self.on_recompile = on_recompile
        self.expected = expected
        self.name = name
        self.registry = registry if registry is not None else get_registry()
        self.extra = 0
        self._base = 0

    def _size(self) -> int:
        return sum(cache_size(fn) for fn in self.fns)

    def __enter__(self) -> "RecompileSentinel":
        self._base = self._size()
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        compiled = self._size() - self._base
        self.extra = max(0, compiled - self.expected)
        if self.extra and exc_type is None:
            # the counter honors the registry's master switch, but the
            # policy below fires regardless — an explicitly-constructed
            # sentinel is a correctness guard, not telemetry
            self.registry.counter(
                "recompiles_total",
                "unexpected new step shapes inside watched regions").inc(
                    self.extra, region=self.name)
            message = (f"recompile sentinel [{self.name}]: {compiled} "
                       f"compile(s) in a region budgeted for "
                       f"{self.expected}")
            if self.on_recompile == "warn":
                logging.warning(message)
            elif self.on_recompile == "raise":
                raise RecompileError(message)
        return False
