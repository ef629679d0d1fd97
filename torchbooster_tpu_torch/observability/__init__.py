"""Host-side telemetry the serving batcher imports: the metrics
registry, the recompile (new step shape) sentinel, the per-step flight
recorder and the request tracer — ported from
``torchbooster_tpu/observability``. Everything is off by default."""
from __future__ import annotations

from torchbooster_tpu_torch.observability.flight import FlightRecorder
from torchbooster_tpu_torch.observability.recompile import (
    RecompileError,
    RecompileSentinel,
)
from torchbooster_tpu_torch.observability.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
    set_enabled,
)
from torchbooster_tpu_torch.observability.tracing import RequestTracer

__all__ = ["Counter", "FlightRecorder", "Gauge", "Histogram",
           "RecompileError", "RecompileSentinel", "Registry",
           "RequestTracer", "get_registry", "set_enabled"]
