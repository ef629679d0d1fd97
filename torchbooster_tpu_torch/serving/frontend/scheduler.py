"""Scheduling policies for the serving batcher: FCFS and SLO-aware.

The batcher (serving/batcher.py) owns the mechanism — seat, chunk,
decode, preempt — and delegates three decisions to a policy object:
*which* queued request to seat next, *which* queued requests to shed
(reject with backpressure instead of letting them miss their deadline
in the queue), and *which* seated request to preempt when the page
pool starves. :class:`FCFSPolicy` answers them exactly the way the
pre-frontend batcher did (strict arrival order, never shed, youngest
victim), so it is the default and the zero-behavior-change control.

:class:`SLOPolicy` makes all three answers deadline-driven:

- requests carry a **priority class** (``Request.priority`` naming a
  :class:`PriorityClass` with per-class TTFT/TPOT targets, normally
  from the ``serving.frontend`` YAML block);
- **admission** is earliest-slack-first: among arrived requests, seat
  the one whose TTFT deadline leaves the least slack after the
  estimated remaining prefill work (measured EWMA chunk times — the
  batcher maintains them), so an urgent short request overtakes an
  earlier-arrived batch request instead of queueing behind it;
- **shedding** fires when the slack goes negative — the queue +
  prefill estimate says the deadline can no longer be met — so the
  client gets an immediate 429 + Retry-After instead of a guaranteed
  SLO miss (the front door surfaces it; ``run()`` traces count it in
  ``n_shed``);
- **preemption victims** are picked by *re-admission cost*: the
  tokens a victim would have to re-prefill when re-seated, net of the
  prompt pages the prefix cache would hand back. A mid-decode slot
  whose prompt is fully resident is nearly free to evict and re-seat;
  a cold long-prompt slot is not. Lower-priority classes are always
  preferred as victims ahead of cost.

Policies are host-side pure bookkeeping — nothing here touches the
device, so the scheduling decisions add no sync to the decode loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:  # batcher imports this module; avoid the cycle
    from torchbooster_tpu_torch.serving.batcher import (
        ContinuousBatcher, Request)


@dataclass(frozen=True)
class PriorityClass:
    """One SLO class: deadline targets in milliseconds (0 disables the
    corresponding deadline) and a rank (0 = highest priority; ties in
    slack break toward lower rank, and preemption victims come from
    the highest rank present)."""
    name: str
    ttft_ms: float = 0.0
    tpot_ms: float = 0.0
    rank: int = 0

    def __post_init__(self):
        if not self.name or not self.name.replace("_", "a").isalnum():
            raise ValueError(
                f"priority class name must be a non-empty identifier, "
                f"got {self.name!r}")
        if self.ttft_ms < 0 or self.tpot_ms < 0:
            raise ValueError(
                f"class {self.name!r}: deadline targets must be >= 0 "
                f"(0 = no deadline), got ttft_ms={self.ttft_ms}, "
                f"tpot_ms={self.tpot_ms}")


def parse_classes(spec: str) -> dict[str, PriorityClass]:
    """Parse the YAML ``classes`` spec — ``"name:ttft_ms:tpot_ms,..."``
    in priority order (first = highest), e.g.
    ``"interactive:250:60,batch:5000:0"``. The compact string form
    follows the repo's mesh-spec idiom (one line of YAML, no nested
    structure); malformed entries and duplicates fail loudly."""
    out: dict[str, PriorityClass] = {}
    for rank, part in enumerate(p.strip() for p in spec.split(",")):
        if not part:
            continue
        bits = part.split(":")
        if len(bits) != 3:
            raise ValueError(
                f"priority class spec {part!r}: expected "
                "name:ttft_ms:tpot_ms")
        name = bits[0].strip()
        if name in out:
            raise ValueError(f"duplicate priority class {name!r}")
        try:
            ttft, tpot = float(bits[1]), float(bits[2])
        except ValueError:
            raise ValueError(
                f"priority class {name!r}: deadline targets must be "
                f"numbers, got {bits[1]!r}/{bits[2]!r}") from None
        out[name] = PriorityClass(name, ttft, tpot, rank=rank)
    return out


class SchedulerPolicy:
    """Policy hook surface. The base class IS the FCFS answers — a
    subclass overrides only the decisions it changes. ``slo`` gates
    the batcher's per-class ``serving_slo_*`` telemetry (off for FCFS
    so the cold path's registry families are untouched);
    ``stop_on_admit_failure`` is FCFS head-of-line blocking (one
    failed seat ends this iteration's admissions — strict arrival
    order needs it; the SLO policy keeps trying other candidates)."""

    name = "fcfs"
    slo = False
    stop_on_admit_failure = True
    classes: dict[str, PriorityClass] = {}

    def validate(self, req: "Request") -> None:
        """Submit-time request validation (the one place class names
        are known). FCFS accepts anything — it ignores priority."""

    def cls_of(self, req: "Request") -> PriorityClass | None:
        return None

    def ttft_deadline_s(self, req: "Request") -> float | None:
        """Seconds from arrival to first token, or None (no deadline).
        ``Request.deadline_ms`` overrides the class target."""
        if req.deadline_ms is not None:
            return req.deadline_ms / 1e3
        return None

    def tpot_deadline_s(self, req: "Request") -> float | None:
        return None

    def shed(self, queue: list, now: float,
             batcher: "ContinuousBatcher") -> list:
        return []

    def next_admission(self, queue: list, now: float,
                       batcher: "ContinuousBatcher"):
        # strict arrival order: the queue head, once it has arrived
        if queue and queue[0].arrival <= now:
            return queue[0]
        return None

    def select_victim(self, admit_order: list[int],
                      seated: dict[int, Any],
                      batcher: "ContinuousBatcher") -> int:
        return admit_order[-1]          # youngest

    def retry_after_s(self, batcher: "ContinuousBatcher") -> float:
        """Advisory Retry-After for shed/backpressure responses."""
        return 1.0


class FCFSPolicy(SchedulerPolicy):
    """The default: byte-for-byte the pre-frontend batcher behavior
    (every inherited answer is the FCFS one)."""


class SLOPolicy(SchedulerPolicy):
    """Deadline-driven scheduling over named priority classes.

    ``classes`` maps name -> :class:`PriorityClass`; ``default``
    names the class of requests submitted without a ``priority``
    (defaults to the first = highest-priority class). ``shed_grace``
    scales the shed threshold: a request is shed when the estimated
    time to its first token exceeds ``grace x`` its REMAINING TTFT
    budget — deadline minus time already waited — (1.0 = shed exactly
    at "cannot meet it"; > 1 sheds later, tolerating estimate
    noise)."""

    name = "slo"
    slo = True
    stop_on_admit_failure = False

    def __init__(self, classes: dict[str, PriorityClass],
                 default: str = "", shed_grace: float = 1.0):
        if not classes:
            raise ValueError(
                "SLOPolicy needs at least one PriorityClass (an empty "
                "table would shed nothing and rank nothing — use "
                "FCFSPolicy if you want no SLO accounting)")
        if shed_grace <= 0:
            raise ValueError(f"shed_grace must be > 0, got {shed_grace}")
        self.classes = dict(classes)
        self.default = default or next(iter(classes))
        if self.default not in self.classes:
            raise ValueError(
                f"default class {self.default!r} is not one of "
                f"{sorted(self.classes)}")
        self.shed_grace = shed_grace

    # ---- class resolution ----------------------------------------
    def validate(self, req: "Request") -> None:
        if req.priority and req.priority not in self.classes:
            raise ValueError(
                f"unknown priority class {req.priority!r}: configured "
                f"classes are {sorted(self.classes)} (frontend.classes)")

    def cls_of(self, req: "Request") -> PriorityClass:
        return self.classes[req.priority or self.default]

    def ttft_deadline_s(self, req: "Request") -> float | None:
        if req.deadline_ms is not None:
            return req.deadline_ms / 1e3
        ms = self.cls_of(req).ttft_ms
        return ms / 1e3 if ms > 0 else None

    def tpot_deadline_s(self, req: "Request") -> float | None:
        ms = self.cls_of(req).tpot_ms
        return ms / 1e3 if ms > 0 else None

    # ---- the three decisions -------------------------------------
    def _slack_s(self, req: "Request", now: float,
                 batcher: "ContinuousBatcher") -> float:
        """Seconds of TTFT budget left after the estimated remaining
        work: deadline - waited - (queued prefill ahead + own
        prefill). +inf when the request has no TTFT deadline."""
        deadline = self.ttft_deadline_s(req)
        if deadline is None:
            return float("inf")
        return (req.arrival + deadline) - now \
            - batcher.est_ttft_s(req)

    def shed(self, queue: list, now: float,
             batcher: "ContinuousBatcher") -> list:
        # negative slack beyond the grace margin: the deadline is
        # already unmeetable per the queue/occupancy estimate — fail
        # fast with backpressure instead of burning pool pages on a
        # guaranteed miss
        out = []
        for req in queue:
            if req.arrival > now:
                continue
            if req.first_token_at is not None:
                # a PREEMPTED request back in the queue: its client is
                # already consuming the stream — the TTFT deadline is
                # history (hit or missed) and shedding now would
                # abandon delivered tokens; it re-admits instead
                continue
            deadline = self.ttft_deadline_s(req)
            if deadline is None:
                continue
            # the documented rule (docs/config.md): shed when the
            # estimated TTFT exceeds grace x the REMAINING budget —
            # grace scales tolerance for estimate noise, not the
            # deadline itself (a negative remainder always sheds)
            remaining = deadline - (now - req.arrival)
            if batcher.est_ttft_s(req) > self.shed_grace * remaining:
                out.append(req)
        return out

    def next_admission(self, queue: list, now: float,
                       batcher: "ContinuousBatcher"):
        arrived = [r for r in queue if r.arrival <= now]
        if not arrived:
            return None
        # earliest slack first; rank breaks ties (and orders the
        # no-deadline tail), then arrival keeps it stable
        return min(arrived, key=lambda r: (
            self._slack_s(r, now, batcher), self.cls_of(r).rank,
            r.arrival))

    def select_victim(self, admit_order: list[int],
                      seated: dict[int, Any],
                      batcher: "ContinuousBatcher") -> int:
        # lowest-priority class first (highest rank), then the victim
        # that is CHEAPEST to re-admit — its re-prefill tokens net of
        # the prompt pages the prefix cache will hand straight back —
        # then youngest (matching FCFS when everything else ties)
        return min(admit_order, key=lambda slot: (
            -self.cls_of(seated[slot]).rank,
            batcher.readmission_cost(seated[slot]),
            -admit_order.index(slot)))

    def retry_after_s(self, batcher: "ContinuousBatcher") -> float:
        # one full-pool drain at the measured decode cadence is the
        # honest "try again when something has retired" horizon;
        # floor at 1s so clients never hot-loop
        est = batcher.est_step_s * batcher.engine.max_slots
        return max(1.0, round(est, 1))


__all__ = ["FCFSPolicy", "PriorityClass", "SLOPolicy",
           "SchedulerPolicy", "parse_classes"]
