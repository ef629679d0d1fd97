"""Device-side telemetry: allocator gauges and FLOP counts — the port of
``torchbooster_tpu/observability/device.py``.

- :func:`record_memory_gauges` — per-card caching-allocator stats from
  ``torch.cuda.memory_stats(i)`` and ``torch.cuda.mem_get_info(i)``
  into the JAX package's ``device_<key>`` gauges, labelled by the card
  index. Without a CUDA card it returns ``{}`` and sets nothing, as the
  JAX call does on the CPU.
- :func:`flop_count` — the FLOPs of ``fn(*args)`` as
  ``torch.utils.flop_counter.FlopCounterMode`` counts them; it answers
  the JAX package's ``xla_flops``. :func:`flop_check` (a copy) compares
  a hand-derived count against it.

The JAX module's ``cost_analysis`` reads an XLA ``Compiled``'s cost
model; torch has no compiled artifact to ask, so it has no counterpart
here.
"""
from __future__ import annotations

import logging
from typing import Any, Callable

import torch

from torchbooster_tpu_torch.observability.registry import (
    Registry,
    get_registry,
)

__all__ = ["flop_check", "flop_count", "record_memory_gauges"]

# the JAX gauge names (``device.memory_stats()`` keys) and the torch
# allocator stat each one reads; bytes_limit comes from mem_get_info
_TORCH_KEYS = {"bytes_in_use": "allocated_bytes.all.current",
               "peak_bytes_in_use": "allocated_bytes.all.peak",
               "pool_bytes": "reserved_bytes.all.current",
               "num_allocs": "allocation.all.current"}


def record_memory_gauges(registry: Registry | None = None) -> dict:
    """Snapshot every visible card's allocator stats into gauges
    labelled by card index; returns ``{index: stats}`` for direct use
    (``{}`` without a card)."""
    registry = registry if registry is not None else get_registry()
    out: dict[int, dict] = {}
    if not torch.cuda.is_available():
        return out
    for index in range(torch.cuda.device_count()):
        raw = torch.cuda.memory_stats(index)
        stats = {key: int(raw.get(src, 0))
                 for key, src in _TORCH_KEYS.items()}
        stats["bytes_limit"] = int(torch.cuda.mem_get_info(index)[1])
        out[index] = stats
        for key, value in stats.items():
            registry.gauge(
                f"device_{key}",
                "allocator stat from torch.cuda.memory_stats()").set(
                    float(value), device=str(index))
    return out


def flop_count(fn: Callable, *args: Any, **kwargs: Any) -> float | None:
    """FLOPs of one call ``fn(*args, **kwargs)`` as
    ``FlopCounterMode`` counts them (the JAX package's ``xla_flops``;
    None when it counts nothing). The call runs once, for real.

    The counter sees aten operators only. The port's CUDA kernels are
    bound through ``ctypes`` and are invisible to it, so count on the
    plain path (CPU tensors, or the reference attention), which does the
    same arithmetic."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = counter.get_total_flops()
    return float(flops) if flops else None


def flop_check(name: str, formula_flops: float, measured: float | None,
               tolerance: float = 0.10) -> float | None:
    """Compare a hand-derived FLOP count against a measured one; returns
    their ratio (measured/formula) and WARNS when they disagree beyond
    ``tolerance`` — an MFU denominator must not silently drift from the
    graph it describes."""
    if not measured or not formula_flops:
        return None
    ratio = measured / formula_flops
    if abs(ratio - 1.0) > tolerance:
        logging.warning(
            "%s: hand FLOP formula (%.3g) and the measured count "
            "(%.3g) disagree by %.0f%% — the MFU denominator needs "
            "re-deriving", name, formula_flops, measured,
            abs(ratio - 1.0) * 100)
    return round(ratio, 4)
