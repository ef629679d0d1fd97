"""Routing decision audit trail — a copy of ``torchbooster_tpu/serving/
router/audit.py`` (stdlib only), changed in its imports alone.

The fleet appends one bounded-ring record per routing decision: the
chosen replica, the verdict reason (``affinity`` / ``spill`` /
``directory`` / ``bind`` / ``least_loaded`` / ``round_robin``, with a
``readmit+`` prefix when the request re-routes after a death), the
affinity key and a per-candidate row (queue depth, in-flight, the
expected-slack score, affinity pages warm via the map).

Three consumers: ``GET /debug/router`` (``EngineFleet.debug_router()``),
:func:`chrome_router_events` (a router track, pid 3, one thread row per
replica, merged with ``RequestTracer.chrome_events()``), and
:func:`routing_artifact` / :func:`diff_routing` (the complete assignment
sequence, fingerprint-tagged, and its comparison: ``[]`` identical, a
list of divergence lines, or ``ValueError`` for artifacts that are not
comparable). Host bookkeeping only: no clocks, no device reads, and the
ring never feeds back into routing.
"""
from __future__ import annotations

from collections import deque

__all__ = ["RoutingAudit", "chrome_router_events",
           "diff_routing", "routing_artifact"]

ROUTER_PID = 3


class RoutingAudit:
    """Bounded ring of routing-decision records (newest kept)."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(
                f"audit capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self.n_records = 0

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, rec: dict) -> None:
        self._ring.append(rec)
        self.n_records += 1

    def tail(self, n: int | None = None) -> list[dict]:
        out = list(self._ring)
        return out if n is None else out[-n:]

    def reset(self) -> None:
        self._ring.clear()
        self.n_records = 0


def chrome_router_events(records: list[dict],
                         pid: int = ROUTER_PID) -> list[dict]:
    """Chrome trace events for the router track: one instant event
    per decision at its arrival time, on the CHOSEN replica's thread
    row (pid ``3`` "router" — merge with the tracer's pid 1/2 events
    through ``write_chrome_trace``). The full record rides in
    ``args`` so a click in Perfetto shows the candidate table."""
    if not records:
        return []
    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "router"}}]
    for tid in sorted({r["replica"] for r in records}):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": f"replica {tid}"}})
    for rec in records:
        events.append({
            "name": f"{rec['reason']} {rec['request_id']}",
            "ph": "i", "s": "t",
            "ts": rec["arrival"] * 1e6,
            "pid": pid, "tid": rec["replica"],
            "args": dict(rec)})
    return events


def routing_artifact(fleet, fingerprint: str | None = None) -> dict:
    """The diffable routing artifact for one replayed session: the
    COMPLETE ``(request_id, replica)`` assignment sequence (the
    determinism pin's observable, unbounded) plus the audit ring's
    reason tail (bounded — context, not the comparison surface).
    ``fingerprint`` should be the workload's content fingerprint so
    :func:`diff_routing` can refuse cross-workload comparisons."""
    audit = getattr(fleet, "audit", None)
    return {
        "version": 1,
        "kind": "routing",
        "workload_fingerprint": fingerprint,
        "policy": fleet.routing.name,
        "n_replicas": len(fleet.replicas),
        "n_routed": fleet.n_routed,
        "assignments": [[rid, rep]
                        for rid, rep in fleet.assignment_log],
        "reasons": ([] if audit is None else
                    [{"request_id": r["request_id"],
                      "replica": r["replica"],
                      "reason": r["reason"]}
                     for r in audit.tail()]),
    }


def diff_routing(base: dict, cand: dict,
                 max_lines: int = 20) -> list[str]:
    """Compare two routing artifacts. Returns divergence lines
    (empty = identical decision sequences); raises ``ValueError``
    when the artifacts are not comparable (wrong kind, fingerprint
    mismatch)."""
    for art, label in ((base, "baseline"), (cand, "candidate")):
        if not isinstance(art, dict) or art.get("kind") != "routing":
            raise ValueError(
                f"{label} is not a routing artifact (write one with "
                "routing_artifact(fleet, fingerprint))")
    fp_b = base.get("workload_fingerprint")
    fp_c = cand.get("workload_fingerprint")
    if fp_b != fp_c:
        raise ValueError(
            f"workload fingerprints differ ({fp_b!r} vs {fp_c!r}): "
            "refusing to diff routing of different traffic")
    lines: list[str] = []
    for key in ("policy", "n_replicas"):
        if base.get(key) != cand.get(key):
            lines.append(
                f"{key}: {base.get(key)!r} -> {cand.get(key)!r}")
    a = [tuple(row) for row in base.get("assignments", [])]
    b = [tuple(row) for row in cand.get("assignments", [])]
    if len(a) != len(b):
        lines.append(
            f"decision count: {len(a)} -> {len(b)}")
    diverged = [(i, x, y) for i, (x, y) in enumerate(zip(a, b))
                if x != y]
    for i, x, y in diverged[:max_lines]:
        lines.append(
            f"decision {i}: {x[0]} -> replica {x[1]} became "
            f"{y[0]} -> replica {y[1]}")
    if len(diverged) > max_lines:
        lines.append(
            f"... and {len(diverged) - max_lines} more divergences")
    return lines
