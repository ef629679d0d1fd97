"""Process-wide metrics registry: Counter / Gauge / Histogram.

Design constraints (ported host-side from torchbooster_tpu's
registry):

- **near-zero cost when disabled**: every observation method checks
  one attribute and returns; nothing allocates, nothing locks.
- **device-scalar-friendly**: ``inc``/``set``/``observe`` accept tensors and *defer* the device→host read — values queue un-read and
  only materialize when the registry is read (``snapshot``, exporters,
  ``LogCallback``), so instrumenting a compiled train step never adds
  a per-step host sync. The backlog is bounded: a series that is never
  read self-drains past ``_MAX_PENDING`` queued observations (one
  amortized sync per thousand steps, not a leak).
- **thread-safe**: the serving batcher, the data-pipeline producer
  thread and the export cadence thread all write concurrently; one
  registry lock guards structure, per-metric locks guard hot updates.
- **labels**: each metric family holds one series per label tuple
  (``counter.labels(kv="4").inc()`` — Prometheus child semantics).

The module-level default registry is what the stack instruments into;
tests and scoped users can build private :class:`Registry` instances.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Iterable

__all__ = [
    "Counter", "Gauge", "Histogram", "Metric", "Registry",
    "get_registry", "set_enabled",
]

# default Prometheus-ish latency buckets (seconds) — wide enough for
# TTFT/step-time without configuration
_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# bounded reservoir per histogram series: enough for exact percentiles
# over a bench/serving run, dropped oldest-first beyond the cap
_MAX_SAMPLES = 8192

# un-materialized observation backlog cap per series: a registry that
# is enabled but never read (no exporter, no LogCallback) must not
# leak — past this, push() drains in place, costing one amortized
# host sync per _MAX_PENDING observations (the RunningAverage
# max_pending discipline, scaled up)
_MAX_PENDING = 1024


class _Series:
    """One labeled child of a metric family."""

    __slots__ = ("lock", "pending", "total", "count", "buckets",
                 "bucket_counts", "samples", "last")

    def __init__(self, buckets: tuple[float, ...] | None = None):
        self.lock = threading.Lock()
        self.pending: list[Any] = []   # un-materialized observations
        self.total = 0.0
        self.count = 0
        self.last = 0.0                # gauges: latest value wins
        self.buckets = buckets
        self.bucket_counts = [0] * (len(buckets) + 1) if buckets else None
        self.samples: list[float] | None = [] if buckets else None

    def push(self, value: Any) -> None:
        with self.lock:
            self.pending.append(value)
            overflow = len(self.pending) >= _MAX_PENDING
        if overflow:
            self.drain()

    def drain(self) -> None:
        with self.lock:
            pending, self.pending = self.pending, []
        if not pending:
            return
        # plain numbers pass through; tensors read back here, at the
        # registry's read cadence, never at observation time
        values = [float(v) for v in pending]
        with self.lock:
            for v in values:
                self.total += v
                self.count += 1
                self.last = v
                if self.buckets is not None:
                    self.bucket_counts[
                        bisect.bisect_left(self.buckets, v)] += 1
                    self.samples.append(v)
            if self.samples is not None and len(self.samples) > _MAX_SAMPLES:
                del self.samples[:len(self.samples) - _MAX_SAMPLES]

    def read(self) -> tuple[int, float, float, list[int] | None,
                            list[float] | None]:
        """Drain, then return a CONSISTENT ``(count, total, last,
        bucket_counts, samples)`` view taken under the series lock —
        renderers reading fields piecemeal would tear against a
        concurrent self-drain (a scrape where ``+Inf`` disagrees with
        the bucket sums breaks rate()/histogram_quantile())."""
        self.drain()
        with self.lock:
            return (self.count, self.total, self.last,
                    list(self.bucket_counts)
                    if self.bucket_counts is not None else None,
                    list(self.samples)
                    if self.samples is not None else None)


def _label_key(labels: dict[str, Any]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _percentile(samples: list[float], q: float) -> float:
    """Linear-interpolated percentile of an unsorted sample list."""
    if not samples:
        return 0.0
    ordered = sorted(samples)
    rank = (q / 100.0) * (len(ordered) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(ordered) - 1)
    frac = rank - lo
    return ordered[lo] * (1 - frac) + ordered[hi] * frac


class Metric:
    """A metric family: name + one series per label tuple."""

    kind = "untyped"

    def __init__(self, registry: "Registry", name: str,
                 help: str = "", buckets: tuple[float, ...] | None = None):
        self.registry = registry
        self.name = name
        self.help = help
        self._buckets = buckets
        self._series: dict[tuple, _Series] = {}
        self._lock = threading.Lock()

    def labels(self, **labels: Any) -> _Series:
        key = _label_key(labels)
        series = self._series.get(key)
        if series is None:
            with self._lock:
                series = self._series.setdefault(key, _Series(self._buckets))
        return series

    def _observe(self, value: Any, labels: dict[str, Any]) -> None:
        self.labels(**labels).push(value)

    # ---- read side ----------------------------------------------
    def series_items(self) -> Iterable[tuple[tuple, _Series]]:
        """Label-key → series pairs; read each via ``series.read()``
        for a tear-free view."""
        with self._lock:
            return list(self._series.items())

    def value(self, **labels: Any) -> float:
        """Family scalar view: counters → running total, gauges →
        last set value, histograms → observation count."""
        count, total, last, _, _ = self.labels(**labels).read()
        if self.kind == "gauge":
            return last
        if self.kind == "histogram":
            return float(count)
        return total


class Counter(Metric):
    kind = "counter"

    def inc(self, n: Any = 1, **labels: Any) -> None:
        if self.registry.enabled:
            self._observe(n, labels)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: Any, **labels: Any) -> None:
        if self.registry.enabled:
            self._observe(value, labels)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, registry: "Registry", name: str, help: str = "",
                 buckets: tuple[float, ...] = _DEFAULT_BUCKETS):
        super().__init__(registry, name, help, buckets=tuple(buckets))

    def observe(self, value: Any, **labels: Any) -> None:
        if self.registry.enabled:
            self._observe(value, labels)

    def percentile(self, q: float, **labels: Any) -> float:
        """Exact percentile over the (bounded) sample reservoir —
        0.0 when empty. ``q`` in [0, 100]."""
        _, _, _, _, samples = self.labels(**labels).read()
        return _percentile(samples or [], q)

    def mean(self, **labels: Any) -> float:
        count, total, _, _, _ = self.labels(**labels).read()
        return total / count if count else 0.0


class Registry:
    """Metric namespace + the enabled switch.

    ``enabled`` defaults False for private registries and for the
    process default (flip it via :func:`set_enabled` or
    ``ObservabilityConfig.make``): an un-configured import must cost
    nothing and write nothing."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw) -> Metric:
        metric = self._metrics.get(name)
        if metric is None:
            with self._lock:
                metric = self._metrics.get(name)
                if metric is None:
                    metric = cls(self, name, help, **kw)
                    self._metrics[name] = metric
        if not isinstance(metric, cls):
            raise TypeError(
                f"metric {name!r} already registered as {metric.kind}")
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = _DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def metrics(self) -> list[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict[str, float]:
        """Flat ``{name{labels}: value}`` dict of every series —
        counters as totals, gauges as last value, histograms as
        ``_count``/``_sum``/``_mean``/``_p95`` derived scalars. This
        read (and only this read) materializes pending device values;
        each series is read atomically (``_Series.read``)."""
        out: dict[str, float] = {}
        for metric in self.metrics():
            for key, series in metric.series_items():
                count, total, last, _, samples = series.read()
                suffix = "".join(f"{{{k}={v}}}" for k, v in key)
                base = metric.name + suffix
                if metric.kind == "histogram":
                    out[base + "_count"] = float(count)
                    out[base + "_sum"] = total
                    if count:
                        out[base + "_mean"] = total / count
                        out[base + "_p95"] = _percentile(samples or [],
                                                         95.0)
                else:
                    out[base] = last if metric.kind == "gauge" else total
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_DEFAULT = Registry(enabled=False)


def get_registry() -> Registry:
    """The process-wide default registry the stack instruments into."""
    return _DEFAULT


def set_enabled(enabled: bool = True) -> Registry:
    """Flip the default registry's master switch; returns it."""
    _DEFAULT.enabled = enabled
    return _DEFAULT
