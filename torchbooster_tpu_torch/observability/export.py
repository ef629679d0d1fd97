"""Exporters: JSONL event log + Prometheus text snapshots, on a
background cadence thread — a copy of
``torchbooster_tpu/observability/export.py`` over the port's registry,
spans and device gauges.

Two formats because they answer different questions:

- **JSONL** (one self-describing dict per line, append-only) is the
  repo's lingua franca — bench.py emits it, scripts/run_ab.py records
  it, ab_summary.py reads it. Span events stream as they close;
  registry snapshots land every cadence tick.
- **Prometheus text format** (a whole-file atomic rewrite per tick)
  is what a node_exporter textfile collector or any Prometheus scrape
  sidecar picks up — the ship-to-production path the ROADMAP's
  heavy-traffic story needs.

The cadence thread is a daemon: it can never hold a process open, and
``stop()`` flushes one final snapshot so short runs still export.
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any

from torchbooster_tpu_torch.observability import spans
from torchbooster_tpu_torch.observability.registry import (
    Registry,
    get_registry,
)

__all__ = ["JsonlExporter", "MetricsExporter", "prometheus_text"]


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _prom_label(value: str) -> str:
    """Escape a label value per the exposition format (backslash,
    double quote, newline) — one unescaped user-supplied span name
    would make a textfile collector reject the whole file."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def prometheus_text(registry: Registry | None = None) -> str:
    """Render the registry in the Prometheus exposition text format
    (counters with ``_total`` preserved as-is, histograms as
    cumulative ``_bucket``/``_sum``/``_count`` series)."""
    registry = registry if registry is not None else get_registry()
    lines: list[str] = []
    for metric in registry.metrics():
        name = _prom_name(metric.name)
        help_text = (metric.help or metric.name).replace(
            "\\", "\\\\").replace("\n", "\\n")
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {metric.kind}")
        for key, series in metric.series_items():
            # one atomic read per series: fields read piecemeal could
            # tear against a concurrent self-drain (+Inf disagreeing
            # with the bucket sums breaks histogram_quantile())
            count, total, last, bucket_counts, _ = series.read()
            labels = ",".join(f'{k}="{_prom_label(v)}"' for k, v in key)
            wrap = f"{{{labels}}}" if labels else ""
            if metric.kind == "histogram":
                cumulative = 0
                for bound, bcount in zip(series.buckets,
                                         bucket_counts):
                    cumulative += bcount
                    le = ",".join(filter(None, [labels, f'le="{bound}"']))
                    lines.append(
                        f"{name}_bucket{{{le}}} {cumulative}")
                le = ",".join(filter(None, [labels, 'le="+Inf"']))
                lines.append(f"{name}_bucket{{{le}}} {count}")
                lines.append(f"{name}_sum{wrap} {total}")
                lines.append(f"{name}_count{wrap} {count}")
            else:
                value = last if metric.kind == "gauge" else total
                lines.append(f"{name}{wrap} {value}")
    return "\n".join(lines) + "\n"


class JsonlExporter:
    """Append-only JSONL event writer; subscribes to span events on
    construction. Thread-safe (one lock around write+flush)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._unsubscribe = spans.span_events_subscribe(self.write)

    def write(self, event: dict[str, Any]) -> None:
        line = json.dumps(event, default=str)
        with self._lock:
            if self._file.closed:
                return
            self._file.write(line + "\n")
            self._file.flush()

    def close(self) -> None:
        self._unsubscribe()
        with self._lock:
            if not self._file.closed:
                self._file.close()


class MetricsExporter:
    """Background cadence exporter: every ``cadence_s`` writes (a) a
    ``{"event": "metrics", ...snapshot}`` line to the JSONL log and
    (b) an atomic rewrite of the Prometheus textfile. Also refreshes
    the device memory gauges each tick (CUDA cards; no-op on the
    CPU).

    Either path may be empty/None to skip that format. ``start()`` is
    idempotent; ``stop()`` joins the thread and flushes one final
    snapshot."""

    def __init__(self, registry: Registry | None = None,
                 jsonl_path: str | Path | None = None,
                 prom_path: str | Path | None = None,
                 cadence_s: float = 10.0,
                 slo=None):
        self.registry = registry if registry is not None else get_registry()
        self.jsonl = JsonlExporter(jsonl_path) if jsonl_path else None
        self.prom_path = Path(prom_path) if prom_path else None
        self.cadence_s = max(float(cadence_s), 0.01)
        # optional SLOBurnEngine: ticked first each cycle so the burn
        # gauges it sets land in the very snapshot being exported
        self.slo = slo
        if self.slo is not None and self.jsonl is not None \
                and getattr(self.slo, "sink", None) is None:
            self.slo.sink = self.jsonl.write
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def tick(self) -> None:
        """One export cycle (public: tests and atexit-style flushes)."""
        from torchbooster_tpu_torch.observability.device import (
            record_memory_gauges)

        record_memory_gauges(self.registry)
        if self.slo is not None:
            self.slo.tick()
        if self.jsonl is not None:
            self.jsonl.write({"event": "metrics", "ts": time.time(),
                              **self.registry.snapshot()})
        if self.prom_path is not None:
            self.prom_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.prom_path.with_suffix(
                self.prom_path.suffix + ".tmp")
            tmp.write_text(prometheus_text(self.registry))
            os.replace(tmp, self.prom_path)

    def _run(self) -> None:
        while not self._stop.wait(self.cadence_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — export must never kill work
                pass

    def start(self) -> "MetricsExporter":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="tb-obs-export", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self.tick()
        finally:
            if self.jsonl is not None:
                self.jsonl.close()
