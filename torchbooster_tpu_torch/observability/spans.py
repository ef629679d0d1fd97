"""Nested host-side spans unified with the profiler timeline — the port
of ``torchbooster_tpu/observability/spans.py``.

``span("decode_step")`` measures host wall time (perf_counter), emits
one event into the JSONL event log (via any subscribed sink, see
:mod:`torchbooster_tpu_torch.observability.export`), records a latency
histogram in the registry, AND wraps the body in
``torch.profiler.record_function`` (plus an NVTX range on the card) —
so the same name shows up in a ``torch.profiler`` trace and in Nsight
when one is being captured. One context manager, both timelines.

:class:`trace` is a ``torch.profiler.profile`` window (CPU and CUDA
activities) that writes a Chrome trace on exit, and :func:`annotate` a
bare ``record_function``.

Host spans are *wall-time* measurements: the card runs asynchronously,
so they time the host-side critical path (the launches and any blocking
read the body does), not device execution — device truth comes from the
captured trace.

Overhead discipline: when the registry is disabled, ``span(...)``
returns a shared no-op context manager — no allocation, no clock read,
no annotation, no NVTX range.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

import torch

from torchbooster_tpu_torch.observability.registry import (
    Registry,
    get_registry,
)

__all__ = ["annotate", "current_span_path", "span",
           "span_events_subscribe", "trace"]


_tls = threading.local()

# stamped once (re-reading os.getpid() per span close would cost a
# syscall on a path serving pumps hit thousands of times a second);
# forked workers restamp via the at-fork hook so their span events
# land on their OWN Chrome-trace process track, not the parent's
_PID = os.getpid()


def _restamp_pid() -> None:
    global _PID
    _PID = os.getpid()


if hasattr(os, "register_at_fork"):       # absent on non-posix
    os.register_at_fork(after_in_child=_restamp_pid)

# NVTX ranges exist only in a CUDA build (a CPU build raises "NVTX
# functions not installed"); decided once, at the first live span
_NVTX: bool | None = None


def _nvtx() -> bool:
    global _NVTX
    if _NVTX is None:
        _NVTX = torch.cuda.is_available()
    return _NVTX


# event sinks: callables receiving one dict per closed span
_sinks: list[Callable[[dict], None]] = []
_sinks_lock = threading.Lock()


def span_events_subscribe(sink: Callable[[dict], None]) -> Callable[[], None]:
    """Register a span-event sink (the JSONL exporter does); returns an
    unsubscribe callable."""
    with _sinks_lock:
        _sinks.append(sink)

    def unsubscribe() -> None:
        with _sinks_lock:
            if sink in _sinks:
                _sinks.remove(sink)

    return unsubscribe


def _emit(event: dict) -> None:
    with _sinks_lock:
        sinks = list(_sinks)
    for sink in sinks:
        try:
            sink(event)
        except Exception:  # noqa: BLE001 — telemetry must never kill work
            pass


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _NoopSpan()


class _Span:
    """One live span: wall clock + record_function (+ NVTX) + nesting
    depth."""

    __slots__ = ("name", "registry", "_t0", "_annotation", "_depth",
                 "_nvtx")

    def __init__(self, name: str, registry: Registry):
        self.name = name
        self.registry = registry

    def __enter__(self) -> "_Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._depth = len(stack)
        stack.append(self.name)
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        self._nvtx = _nvtx()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dur = time.perf_counter() - self._t0
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._annotation.__exit__(*exc)
        _tls.stack.pop()
        self.registry.histogram(
            "span_seconds", "host wall time per span").observe(
                dur, name=self.name)
        # skip event construction entirely when nothing subscribed; the
        # event is a valid Chrome trace event (ph/pid/tid + microsecond
        # ts/dur on the perf_counter timebase — the same timebase
        # tracing.py's request events use, so one write_chrome_trace
        # call merges both onto one timeline); dur_s/ok/path/depth ride
        # along for the JSONL readers
        if _sinks:
            _emit({"event": "span", "name": self.name,
                   "path": "/".join((*_tls.stack, self.name)),
                   "depth": self._depth, "dur_s": round(dur, 6),
                   "ph": "X", "cat": "span", "pid": _PID,
                   "tid": threading.get_ident(),
                   "ts": int(self._t0 * 1e6), "dur": int(dur * 1e6),
                   "ok": exc[0] is None})


def span(name: str, registry: Registry | None = None):
    """Context manager: time ``name`` on the host AND annotate it on the
    profiler timeline. No-op (shared singleton) when telemetry is
    disabled."""
    registry = registry if registry is not None else get_registry()
    if not registry.enabled:
        return _NOOP
    return _Span(name, registry)


def current_span_path() -> str:
    """The '/'-joined open-span stack of this thread ('' outside)."""
    return "/".join(getattr(_tls, "stack", ()))


class trace:
    """Profiler capture window: a ``torch.profiler.profile`` over CPU
    and (on the card) CUDA activity whose Chrome trace is written to
    ``path`` on exit — viewable in Perfetto or chrome://tracing.

    >>> with trace("/tmp/profile.json"):
    ...     state, metrics = step(state, batch)

    ``trace(path, annotate="step")`` also wraps the body in a named
    ``record_function`` so the body's ops group under one label. Body
    exceptions propagate — but only after the trace is written, so a
    failed region still leaves a finished, viewable trace. The window
    records the CPU ranges of the thread that opens it (and every
    thread's kernels on the card)."""

    def __init__(self, path: str = "profile.json",
                 annotate: str | None = None):
        self.path = str(path)
        self.annotate = annotate
        self._annotation = None
        self._prof = None

    def __enter__(self) -> "trace":
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        if self.annotate:
            self._annotation = torch.profiler.record_function(self.annotate)
            self._annotation.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        try:
            if self._annotation is not None:
                self._annotation.__exit__(*exc)
        finally:
            self._prof.__exit__(*exc)
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._prof.export_chrome_trace(self.path)


def annotate(name: str) -> Any:
    """Named profiler region for host-side code (an NVTX-range
    analogue)."""
    return torch.profiler.record_function(name)
