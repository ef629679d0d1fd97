"""Unified telemetry subsystem — the port of
``torchbooster_tpu/observability``: metrics, spans, recompile guard,
device stats, exporters.

- :mod:`registry`  — Counter/Gauge/Histogram, thread-safe, labelled,
  tensor-friendly (reads deferred), near-zero when off;
- :mod:`spans`     — ``span("decode_step")`` → wall-time histogram +
  JSONL event + ``torch.profiler.record_function`` (and an NVTX range
  on the card); also :class:`~.spans.trace` and :func:`~.spans.annotate`;
- :mod:`recompile` — :class:`RecompileSentinel` over step-shape counts
  (``on_recompile: ignore | warn | raise``);
- :mod:`device`    — allocator gauges from ``torch.cuda.memory_stats``
  and FLOP counts through ``FlopCounterMode`` (:func:`flop_count`, the
  JAX package's ``xla_flops``);
- :mod:`export`    — JSONL event log + Prometheus text snapshots on a
  background cadence thread;
- :mod:`slo`       — :class:`SLOBurnEngine`, multi-window burn rates
  over the serving deadline/goodput counters, ticked by the exporter;
- :mod:`tracing`   — per-request lifecycle events on a bounded sink,
  exported as JSONL / Chrome trace-event JSON;
- :mod:`flight`    — always-on fixed-size ring of per-step engine
  records + a stall/recompile watchdog.

Everything is OFF by default: importing this package configures
nothing, starts no threads, and adds one predictable branch per
instrumented call site. Flip it on via ``ObservabilityConfig`` (YAML
``observability:`` block) or :func:`enable`.
"""
from __future__ import annotations

from torchbooster_tpu_torch.observability.device import (
    flop_check,
    flop_count,
    record_memory_gauges,
)
from torchbooster_tpu_torch.observability.export import (
    JsonlExporter,
    MetricsExporter,
    prometheus_text,
)
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
from torchbooster_tpu_torch.observability.slo import SLOBurnEngine
from torchbooster_tpu_torch.observability.spans import (
    annotate,
    span,
    span_events_subscribe,
    trace,
)
from torchbooster_tpu_torch.observability.tracing import (
    RequestTracer,
    write_chrome_trace,
)

__all__ = [
    "Counter", "FlightRecorder", "Gauge", "Histogram", "JsonlExporter",
    "MetricsExporter", "Observability", "RecompileError",
    "RecompileSentinel", "Registry", "RequestTracer", "SLOBurnEngine",
    "annotate", "enable", "flop_check", "flop_count", "get_registry",
    "prometheus_text", "record_memory_gauges", "set_enabled", "span",
    "span_events_subscribe", "trace", "write_chrome_trace",
]


class Observability:
    """A running telemetry session: the enabled default registry plus
    (optionally) a started cadence exporter. Built by
    ``ObservabilityConfig.make``; usable as a context manager so entry
    points get flush-on-exit for free."""

    def __init__(self, registry: Registry,
                 exporter: MetricsExporter | None = None,
                 on_recompile: str = "warn"):
        self.registry = registry
        self.exporter = exporter
        self.on_recompile = on_recompile

    def sentinel(self, fns, name: str = "region",
                 expected: int = 0) -> RecompileSentinel:
        """A RecompileSentinel pre-wired with this session's policy."""
        return RecompileSentinel(fns, on_recompile=self.on_recompile,
                                 expected=expected, name=name,
                                 registry=self.registry)

    def close(self) -> None:
        global _default_exporter
        if self.exporter is not None:
            self.exporter.stop()
            if _default_exporter is self.exporter:
                _default_exporter = None

    def __enter__(self) -> "Observability":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# the exporter attached to the process-default registry by enable():
# tracked so repeated enable() calls (two entry points in one process)
# replace it instead of stacking threads + duplicate span sinks
_default_exporter: MetricsExporter | None = None


def enable(jsonl_path: str | None = None, prom_path: str | None = None,
           cadence_s: float = 10.0,
           on_recompile: str = "warn",
           slo: SLOBurnEngine | None = None) -> Observability:
    """Programmatic switch-on: enable the default registry and (when any
    path is given) start the cadence exporter. Idempotent on the default
    session: a previously-started default exporter is flushed and
    stopped before the new one starts. An optional
    :class:`SLOBurnEngine` rides the exporter cadence (its burn gauges
    land in the same snapshot; alert events go to the JSONL log)."""
    global _default_exporter

    registry = set_enabled(True)
    if _default_exporter is not None:
        _default_exporter.stop()
        _default_exporter = None
    exporter = None
    if jsonl_path or prom_path:
        exporter = MetricsExporter(
            registry, jsonl_path=jsonl_path, prom_path=prom_path,
            cadence_s=cadence_s, slo=slo).start()
        _default_exporter = exporter
    return Observability(registry, exporter, on_recompile=on_recompile)
