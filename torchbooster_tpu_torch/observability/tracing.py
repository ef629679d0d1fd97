"""Request-scoped tracing: per-request lifecycle events on a
lock-cheap bounded sink, exportable as JSONL and Chrome trace-event
JSON.

The registry (registry.py) answers "what is the p99 TTFT"; this module
answers "WHICH request paid it and WHERE" — every request carries a
``request_id`` and the serving batcher emits one event per lifecycle
transition (enqueued, shed, seated + prefix-hit pages, each prefill
chunk, first token, per-step token deltas, spec bursts, preempted +
fold size, cancelled, retired + finish reason) plus one event per
engine step kind (``decode_step`` / ``spec_verify_step`` /
``serving_prefill_chunk`` — deliberately the SAME names spans.py puts
on the profiler timeline, so a host trace and a device capture
cross-link by label).

Hot-path discipline (the host-sync rule stays clean here by design):

- ``emit`` is ONE branch when disabled — the tracing-off batcher runs
  the identical instruction stream it ran before this module existed;
- timestamps are ``time.perf_counter()`` only (monotonic; wall-clock
  ``time.time()`` never appears), taken INSIDE the tracer so tracing
  never consumes the batcher's injectable clock — metric values are
  bit-for-bit identical with tracing on or off;
- the sink is a ``deque(maxlen=ring_size)``: appends are atomic under
  the GIL (no lock on the hot path) and memory is bounded by
  construction — a week-long serving session holds the LAST
  ``ring_size`` events, never all of them;
- no device reads, no ``.item()``, ever: every field is a host int,
  float, or short string the batcher already had.

Export formats:

- :meth:`RequestTracer.jsonl` — one self-describing dict per event
  (the repo's lingua franca; same convention as the span event log);
- :meth:`RequestTracer.chrome_events` + :func:`write_chrome_trace` —
  the Chrome trace-event format Perfetto/chrome://tracing open
  directly: one track (pid "requests", tid per request) per request,
  one track (pid "engine", tid per step kind) per engine step kind.
  ``write_chrome_trace`` is the ONE exporter shared with spans.py,
  whose events are themselves valid trace events (``ph``/``pid``/
  ``tid`` + microsecond ``ts``/``dur``) and can ride the same file.
"""
from __future__ import annotations

import json
from collections import deque
from pathlib import Path
from time import perf_counter
from typing import Any, Iterable

__all__ = ["RequestTracer", "write_chrome_trace"]


class RequestTracer:
    """Bounded per-request event sink.

    ``enabled=False`` (the default) makes :meth:`emit` a single branch
    — construct one unconditionally and flip the flag from config.
    ``ring_size`` bounds retained events (oldest drop first).
    """

    __slots__ = ("enabled", "ring_size", "_ring")

    def __init__(self, enabled: bool = False, ring_size: int = 8192):
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        self.enabled = bool(enabled)
        self.ring_size = int(ring_size)
        # (ts, request_id | None, kind, fields) tuples; deque appends
        # are atomic — the pump thread emits while a /debug handler
        # snapshots, no lock needed on the emit path
        self._ring: deque = deque(maxlen=self.ring_size)

    # ---- hot path ------------------------------------------------
    def emit(self, request_id: str | None, kind: str,
             **fields: Any) -> None:
        """Record one event (no-op when disabled). ``request_id=None``
        puts the event on the engine track (one per step kind) instead
        of a request track."""
        if not self.enabled:
            return
        self._ring.append((perf_counter(), request_id, kind, fields))

    # ---- read side -----------------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    def events(self, request_id: str | None = "*") -> list[dict]:
        """Snapshot as dicts, oldest first. ``request_id="*"`` (the
        default) returns everything; a specific id (or None for the
        engine track) filters to that track."""
        snap = list(self._ring)
        out = []
        for ts, rid, kind, fields in snap:
            if request_id != "*" and rid != request_id:
                continue
            out.append({"ts_us": int(ts * 1e6), "request_id": rid,
                        "kind": kind, **fields})
        return out

    def request_ids(self) -> list[str]:
        """Distinct request ids present in the ring, first-seen order."""
        seen: dict[str, None] = {}
        for _, rid, _, _ in list(self._ring):
            if rid is not None:
                seen.setdefault(rid)
        return list(seen)

    def clear(self) -> None:
        self._ring.clear()

    # ---- exporters -----------------------------------------------
    def jsonl(self) -> str:
        """The ring as JSONL text (one ``{"event": "trace", ...}``
        dict per line — the span event log's convention)."""
        return "".join(
            json.dumps({"event": "trace", **e}) + "\n"
            for e in self.events())

    def write_jsonl(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.jsonl(), encoding="utf-8")
        return path

    def chrome_events(self) -> list[dict]:
        """The ring as Chrome trace events: metadata names the tracks
        (pid 1 "requests", one tid per request; pid 2 "engine", one
        tid per step kind), request lifecycle events are thread-scoped
        instants, engine events carrying ``dur_s`` are complete
        (``ph="X"``) slices so Perfetto renders their width."""
        snap = list(self._ring)
        events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": "requests"}},
            {"name": "process_name", "ph": "M", "pid": 2,
             "args": {"name": "engine"}},
        ]
        req_tid: dict[str, int] = {}
        kind_tid: dict[str, int] = {}
        for ts, rid, kind, fields in snap:
            if rid is not None:
                tid = req_tid.get(rid)
                if tid is None:
                    tid = req_tid[rid] = len(req_tid) + 1
                    events.append(
                        {"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": tid, "args": {"name": rid}})
                pid = 1
            else:
                tid = kind_tid.get(kind)
                if tid is None:
                    tid = kind_tid[kind] = len(kind_tid) + 1
                    events.append(
                        {"name": "thread_name", "ph": "M", "pid": 2,
                         "tid": tid, "args": {"name": kind}})
                pid = 2
            dur_s = fields.get("dur_s")
            if dur_s is not None:
                events.append(
                    {"name": kind, "ph": "X", "pid": pid, "tid": tid,
                     "ts": int((ts - dur_s) * 1e6),
                     "dur": int(dur_s * 1e6), "args": dict(fields)})
            else:
                events.append(
                    {"name": kind, "ph": "i", "s": "t", "pid": pid,
                     "tid": tid, "ts": int(ts * 1e6),
                     "args": dict(fields)})
        return events

    def write_chrome(self, path: str | Path) -> Path:
        return write_chrome_trace(path, self.chrome_events())


def write_chrome_trace(path: str | Path,
                       events: Iterable[dict]) -> Path:
    """Write trace events as a Chrome trace-event JSON file (the
    ``{"traceEvents": [...]}`` object form) that Perfetto /
    chrome://tracing load directly.

    The ONE exporter both sinks share: :meth:`RequestTracer.
    chrome_events` output and spans.py span events (which carry
    ``ph``/``pid``/``tid`` + microsecond ``ts``/``dur`` natively) are
    both valid inputs, separately or concatenated onto one timeline —
    they share the ``perf_counter`` microsecond timebase."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"traceEvents": list(events), "displayTimeUnit": "ms"}
    path.write_text(json.dumps(payload), encoding="utf-8")
    return path
