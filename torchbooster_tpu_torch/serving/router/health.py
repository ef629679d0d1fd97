"""Per-replica health scoring — the port of ``torchbooster_tpu/serving/
router/health.py`` over the port's telemetry registry.

A hysteretic state per replica: ``healthy`` (2) -> ``degraded`` (1) ->
``unhealthy`` (0), one level per ``degrade_after`` consecutive bad
observations and back up one level per ``recover_after`` clean ones.
The strikes of an observation: new flight-recorder anomalies (read by
``seq``, so each strikes once), queue depth at or over ``queue_limit``,
claimable pages (free + cached) at or under ``min_free_pages``, and a
stale readiness payload (``step_seq`` frozen for ``stale_s`` while the
replica has work; a remote payload's sender-relative ``age_s`` is read
directly). Exported as ``router_replica_health{replica}`` and
``router_health_transitions_total{replica,to}``.

``EngineFleet.step()`` observes every ``every`` fleet steps, reading
host counters only — never the device, the wall clock or the routing
decision. Routing consults :meth:`FleetHealth.weight` only under the
fleet's ``health_aware`` flag.
"""
from __future__ import annotations

from torchbooster_tpu_torch.observability import get_registry

__all__ = ["FleetHealth"]

HEALTHY, DEGRADED, UNHEALTHY = 2, 1, 0
_NAMES = {HEALTHY: "healthy", DEGRADED: "degraded",
          UNHEALTHY: "unhealthy"}


class FleetHealth:
    """Hysteretic per-replica health (see module docstring).

    Constructing the scorer registers its metric families; writes
    stay one branch when the registry is disabled. One instance per
    fleet — state is keyed by replica id and reset per session."""

    def __init__(self, *, every: int = 8,
                 degrade_after: int = 2, recover_after: int = 4,
                 queue_limit: int = 32, min_free_pages: int = 0,
                 stale_s: float = 2.0,
                 degraded_weight: float = 4.0,
                 unhealthy_weight: float = 16.0,
                 registry=None):
        if every < 1:
            raise ValueError(f"health.every must be >= 1, got {every}")
        if degrade_after < 1 or recover_after < 1:
            raise ValueError(
                f"degrade_after/recover_after must be >= 1, got "
                f"{degrade_after}/{recover_after}")
        if queue_limit < 1:
            raise ValueError(
                f"health.queue_limit must be >= 1, got {queue_limit}")
        if min(degraded_weight, unhealthy_weight) < 1.0 \
                or unhealthy_weight < degraded_weight:
            raise ValueError(
                f"need 1.0 <= degraded_weight <= unhealthy_weight, "
                f"got {degraded_weight}/{unhealthy_weight}")
        self.every = int(every)
        self.degrade_after = int(degrade_after)
        self.recover_after = int(recover_after)
        self.queue_limit = int(queue_limit)
        self.min_free_pages = int(min_free_pages)
        self.stale_s = float(stale_s)
        self._weights = {HEALTHY: 1.0,
                         DEGRADED: float(degraded_weight),
                         UNHEALTHY: float(unhealthy_weight)}
        reg = registry if registry is not None else get_registry()
        self._g_state = reg.gauge(
            "router_replica_health",
            "replica health state: 2 healthy / 1 degraded / 0 "
            "unhealthy (label replica)")
        self._c_trans = reg.counter(
            "router_health_transitions_total",
            "health state transitions (labels replica, to)")
        self._states: dict[int, int] = {}
        self._bad: dict[int, int] = {}
        self._good: dict[int, int] = {}
        self._anom_seq: dict[int, int] = {}
        self._stamp: dict[int, tuple] = {}
        self._strikes: dict[int, list[str]] = {}
        self._ticks = 0
        self.n_observations = 0
        self.n_flaps = 0

    def reset(self) -> None:
        """Per-session reset (fleet ``start_session``): every replica
        starts healthy, anomaly cursors and stamps clear."""
        self._states.clear()
        self._bad.clear()
        self._good.clear()
        self._anom_seq.clear()
        self._stamp.clear()
        self._strikes.clear()
        self._ticks = 0
        self.n_observations = 0
        self.n_flaps = 0

    # ---- read surface (routing + debug) ---------------------------
    def state(self, replica_id: int) -> int:
        return self._states.get(replica_id, HEALTHY)

    def state_name(self, replica_id: int) -> str:
        return _NAMES[self.state(replica_id)]

    def weight(self, replica_id: int) -> float:
        """Load-score multiplier for ``health_aware`` routing: 1.0
        healthy, ``degraded_weight``/``unhealthy_weight`` below."""
        return self._weights[self.state(replica_id)]

    def snapshot(self) -> dict:
        return {
            "states": {rid: _NAMES[s]
                       for rid, s in sorted(self._states.items())},
            "last_strikes": {rid: list(v) for rid, v
                             in sorted(self._strikes.items()) if v},
            "n_observations": self.n_observations,
            "n_flaps": self.n_flaps,
            "every": self.every,
            "degrade_after": self.degrade_after,
            "recover_after": self.recover_after,
        }

    # ---- the observation ------------------------------------------
    def observe(self, fleet) -> None:
        """Called by the fleet once per step; actually evaluates every
        ``every``-th call. Host counters only."""
        self._ticks += 1
        if self._ticks % self.every:
            return
        self.n_observations += 1
        for rep in fleet.replicas:
            rid = rep.replica_id
            if not rep.alive:
                if self.state(rid) != UNHEALTHY:
                    self._transition(rid, UNHEALTHY)
                self._strikes[rid] = ["dead"]
                continue
            self._states.setdefault(rid, HEALTHY)
            strikes = self._strikes_for(rep)
            self._strikes[rid] = strikes
            if strikes:
                self._bad[rid] = self._bad.get(rid, 0) + 1
                self._good[rid] = 0
                if self._bad[rid] >= self.degrade_after:
                    self._bad[rid] = 0
                    cur = self.state(rid)
                    if cur > UNHEALTHY:
                        self._transition(rid, cur - 1)
            else:
                self._good[rid] = self._good.get(rid, 0) + 1
                self._bad[rid] = 0
                if self._good[rid] >= self.recover_after:
                    self._good[rid] = 0
                    cur = self.state(rid)
                    if cur < HEALTHY:
                        self._transition(rid, cur + 1)
            self._g_state.set(self.state(rid), replica=str(rid))

    def _strikes_for(self, rep) -> list[str]:
        strikes: list[str] = []
        rid = rep.replica_id
        ready = rep.readiness()
        # flight-recorder anomalies since the last observation, read
        # by seq so a bounded deque never double-strikes
        flight = getattr(getattr(rep, "batcher", None), "flight", None)
        if flight is not None:
            last = self._anom_seq.get(rid, -1)
            new_kinds = {a.get("what") for a in flight.anomaly_log()
                         if a.get("seq", -1) > last}
            seqs = [a.get("seq", -1) for a in flight.anomaly_log()]
            if seqs:
                self._anom_seq[rid] = max(last, *seqs)
            strikes.extend(sorted(k for k in new_kinds if k))
        if ready.get("queue_depth", 0) >= self.queue_limit:
            strikes.append("queue")
        claimable = ready.get("pages_free", 0) \
            + ready.get("pages_cached", 0)
        if claimable <= self.min_free_pages:
            strikes.append("pages")
        # readiness staleness: a frozen step_seq with work on the
        # plate means the replica stopped making progress. Payloads
        # from a REMOTE replica carry `age_s` — how old the payload
        # itself is, summed from SAME-HOST clock deltas on each side
        # of the wire — and the strike reads it directly: no term
        # ever differences two hosts' clocks, so skew can't mark a
        # healthy remote unhealthy, and a hung server's cached
        # payload ages honestly (its frozen stamped_s never would).
        # In-process payloads have no age_s and keep the historic
        # stamped-delta rule (the fleet steps those replicas itself,
        # so this mostly guards the out-of-process path).
        seq = ready.get("step_seq")
        stamped = ready.get("stamped_s")
        age = ready.get("age_s")
        if seq is not None and age is not None:
            prev = self._stamp.get(rid)
            if prev is None or seq != prev[0]:
                self._stamp[rid] = (seq, stamped)
            elif rep.has_work and age >= self.stale_s:
                strikes.append("stale")
        elif seq is not None and stamped is not None:
            prev = self._stamp.get(rid)
            if prev is None or seq != prev[0]:
                self._stamp[rid] = (seq, stamped)
            elif rep.has_work \
                    and stamped - prev[1] >= self.stale_s:
                strikes.append("stale")
        return strikes

    def _transition(self, rid: int, to: int) -> None:
        self._states[rid] = to
        self.n_flaps += 1
        self._c_trans.inc(replica=str(rid), to=_NAMES[to])
        self._g_state.set(to, replica=str(rid))
