"""Engine flight recorder: an always-on fixed-size ring of per-step
records with a stall/anomaly watchdog.

The aggregate counters say *that* p99 step time regressed; the flight
recorder holds the last ``capacity`` engine steps — step kind, slots
live/filling, pages live/free/cached, tokens delivered, accept rate,
queue depth, step wall time, recompile flag — so a post-mortem (the
front door dumps the ring when its pump dies) or a live ``/debug``
read shows exactly what the engine was doing when things went wrong.

Memory is PROVABLY bounded: the ring is one preallocated numpy
structured array (``capacity`` rows of a fixed dtype — :attr:`nbytes`
is a constant, never a function of uptime), records overwrite in
place, and the anomaly log is a ``deque(maxlen=...)``. Recording is
host-only arithmetic on values the batcher already holds — no device
reads, no ``.item()``, no wall-clock (``perf_counter`` deltas the
caller measured anyway), so the always-on default costs one row write
per step.

The watchdog flags two anomaly shapes as it records:

- **stall**: a step whose wall time exceeds ``stall_mult`` x the
  rolling p99 of recorded steps (p99 refreshed every
  ``_P99_REFRESH`` records — never a per-step percentile scan);
- **recompile**: a step that compiled (the batcher diffs the engine's
  jit cache sizes — the same observable the RecompileSentinel
  watches), attributed to the set of in-flight request ids that
  triggered it.
"""
from __future__ import annotations

import json
from collections import deque
from pathlib import Path
from typing import Iterable

import numpy as np

__all__ = ["FlightRecorder", "KIND_NAMES", "step_kind_code"]

# step kind bit encoding: what the scheduling iteration actually did
_PREFILL, _DECODE, _SPEC = 1, 2, 4

KIND_NAMES = {
    0: "idle",
    _PREFILL: "prefill",
    _DECODE: "decode",
    _PREFILL | _DECODE: "prefill+decode",
    _SPEC: "spec",
    _PREFILL | _SPEC: "prefill+spec",
}


def step_kind_code(prefill: bool, decode: bool, spec: bool) -> int:
    return ((_PREFILL if prefill else 0)
            | (_DECODE if decode else 0)
            | (_SPEC if spec else 0))


_DTYPE = np.dtype([
    ("seq", np.int64), ("kind", np.int8),
    ("slots_live", np.int16), ("slots_filling", np.int16),
    ("pages_live", np.int32), ("pages_free", np.int32),
    ("pages_cached", np.int32),
    # the host spill tier (PR 16): host-resident demoted pages plus
    # this step's tier traffic — a TTFT post-mortem must distinguish
    # "recomputed" from "streamed back over PCIe"
    ("pages_host", np.int32), ("spills", np.int32),
    ("promotions", np.int32), ("host_hit_pages", np.int32),
    ("queue_depth", np.int32),
    ("tokens", np.int32), ("accept_rate", np.float32),
    ("wall_s", np.float32), ("recompiled", np.bool_),
    # tensor-parallel head shards the step ran over (1 = single-chip):
    # a post-mortem must show WHICH topology the recorded steps took
    ("tp", np.int16),
    # live slots decoding as a fork branch b > 0 (copy-on-write
    # parallel sampling): a stall under n-way fan-out looks identical
    # to one under plain load unless the record says how many slots
    # were branches
    ("branches", np.int16),
    # live slots decoding under a structured-generation automaton
    # constraint: mask-building is host work on the hot loop, so a
    # stall post-mortem must show how much of the batch was
    # constrained when the step ran
    ("structured", np.int16),
    # live slots decoding through a non-zero LoRA adapter lane
    # (batched multi-adapter serving): per-tenant attribution in the
    # post-mortem — a stall with 7/8 slots on adapters reads very
    # differently from one on pure base-model traffic
    ("adapters", np.int16),
])

# watchdog cadence/thresholds: p99 refresh interval (records), minimum
# sample count before stalls are judged, anomaly-log bound
_P99_REFRESH = 64
_MIN_SAMPLES = 64
_MAX_ANOMALIES = 64


class FlightRecorder:
    """Fixed-size per-step record ring + watchdog.

    ``capacity`` rows of a fixed dtype; :attr:`nbytes` is the whole
    ring's constant byte cost. One writer (the batcher's pump thread);
    readers snapshot via :meth:`tail` / :meth:`anomaly_log`."""

    def __init__(self, capacity: int = 1024, stall_mult: float = 4.0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if stall_mult <= 1.0:
            raise ValueError(
                f"stall_mult must be > 1, got {stall_mult}")
        self.capacity = int(capacity)
        self.stall_mult = float(stall_mult)
        self._ring = np.zeros(self.capacity, _DTYPE)
        self._seq = 0
        self._p99_s = 0.0          # cached rolling p99 of wall_s
        self._anomalies: deque = deque(maxlen=_MAX_ANOMALIES)

    @property
    def nbytes(self) -> int:
        """The ring's constant byte bound (the whole recorder's
        per-step state: anomalies are separately ``deque``-bounded)."""
        return self._ring.nbytes

    @property
    def n_recorded(self) -> int:
        """Total records ever written (ring holds the last
        ``capacity``)."""
        return self._seq

    # ---- hot path ------------------------------------------------
    def record(self, *, kind: int, slots_live: int, slots_filling: int,
               pages_live: int, pages_free: int, pages_cached: int,
               queue_depth: int, tokens: int, accept_rate: float,
               wall_s: float, recompiled: bool = False,
               inflight: Iterable[str] = (), tp: int = 1,
               branches: int = 0, structured: int = 0,
               adapters: int = 0, pages_host: int = 0,
               spills: int = 0, promotions: int = 0,
               host_hit_pages: int = 0) -> None:
        """Write one step record in place and run the watchdog."""
        seq = self._seq
        row = self._ring[seq % self.capacity]
        row["seq"] = seq
        row["kind"] = kind
        row["slots_live"] = slots_live
        row["slots_filling"] = slots_filling
        row["pages_live"] = pages_live
        row["pages_free"] = pages_free
        row["pages_cached"] = pages_cached
        row["pages_host"] = pages_host
        row["spills"] = spills
        row["promotions"] = promotions
        row["host_hit_pages"] = host_hit_pages
        row["queue_depth"] = queue_depth
        row["tokens"] = tokens
        row["accept_rate"] = accept_rate
        row["wall_s"] = wall_s
        row["recompiled"] = recompiled
        row["tp"] = tp
        row["branches"] = branches
        row["structured"] = structured
        row["adapters"] = adapters
        self._seq = seq + 1
        if recompiled:
            self._anomalies.append({
                "what": "recompile", "seq": seq,
                "kind": KIND_NAMES.get(kind, str(kind)),
                "requests": sorted(inflight)})
        n = min(self._seq, self.capacity)
        if self._seq % _P99_REFRESH == 0 or self._p99_s == 0.0:
            # amortized: one percentile over <= capacity float32s per
            # refresh interval, never per step
            self._p99_s = np.percentile(
                self._ring["wall_s"][:n], 99).tolist()
        # the warm-up gate clamps to capacity: a small ring (capacity
        # < _MIN_SAMPLES) must still arm the watchdog once full, not
        # leave it silently dead forever
        if (n >= min(_MIN_SAMPLES, self.capacity)
                and self._p99_s > 0.0
                and wall_s > self.stall_mult * self._p99_s):
            self._anomalies.append({
                "what": "stall", "seq": seq,
                "kind": KIND_NAMES.get(kind, str(kind)),
                "wall_s": round(wall_s, 6),
                "p99_s": round(self._p99_s, 6),
                "mult": round(wall_s / self._p99_s, 2)})

    # ---- read side -----------------------------------------------
    def tail(self, n: int | None = None) -> list[dict]:
        """The last ``n`` (default: all retained) records as dicts,
        oldest first, with the kind decoded to its name."""
        held = min(self._seq, self.capacity)
        n = held if n is None else min(n, held)
        out = []
        for seq in range(self._seq - n, self._seq):
            row = self._ring[seq % self.capacity]
            rec = {name: row[name].tolist() for name in _DTYPE.names}
            rec["kind"] = KIND_NAMES.get(int(row["kind"]),
                                         str(int(row["kind"])))
            rec["accept_rate"] = round(rec["accept_rate"], 4)
            rec["wall_s"] = round(rec["wall_s"], 6)
            out.append(rec)
        return out

    def anomaly_log(self) -> list[dict]:
        """Watchdog verdicts, oldest first (bounded; oldest drop)."""
        return list(self._anomalies)

    def dump(self) -> dict:
        """The post-mortem payload: retained records + anomalies +
        the rolling p99 — what the front door writes when the pump
        dies, and what ``/debug/engine`` serves on demand."""
        return {"n_recorded": self._seq, "capacity": self.capacity,
                "nbytes": self.nbytes,
                "rolling_p99_s": round(self._p99_s, 6),
                "records": self.tail(), "anomalies": self.anomaly_log()}

    def write_jsonl(self, path: str | Path) -> Path:
        """One header line, then one line per retained record, then
        one per anomaly — append-friendly JSONL, the repo's log
        convention."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        lines = [json.dumps({
            "event": "flight_header", "n_recorded": self._seq,
            "capacity": self.capacity,
            "rolling_p99_s": round(self._p99_s, 6)})]
        lines += [json.dumps({"event": "flight_step", **rec})
                  for rec in self.tail()]
        lines += [json.dumps({"event": "flight_anomaly", **a})
                  for a in self.anomaly_log()]
        path.write_text("\n".join(lines) + "\n", encoding="utf-8")
        return path
