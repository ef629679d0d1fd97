"""EngineFleet — the port of ``torchbooster_tpu/serving/router/
fleet.py``: N data-parallel engine replicas behind one front door.

The fleet quacks like a batcher — ``start_session`` / ``submit`` /
``cancel`` / ``step`` / ``finish_session`` plus the probe surface
(``queue_depth``, ``has_work``, ``readiness``, ``debug_snapshot``) — so
``ServingFrontend(fleet)`` serves it over HTTP and
``replay_inprocess(fleet, workload)`` replays a workload against it
under the deterministic clock (the ``clock`` setter swaps every
replica's clock).

One fleet ``step()`` routes the requests whose arrival has come, in
(arrival, request_id) order, through the :mod:`~torchbooster_tpu_torch.
serving.router.routing` policy, then steps every live replica once.
Routing at arrival makes the decision sequence (``assignment_log``) a
pure function of the workload.

Readmission generalizes the batcher's preemption fold: a replica whose
``step()`` raises, or that ``kill()`` forces down, is buried — its
queued and in-flight requests drain with their generated tokens folded
into their prompts and re-enter the admission buffer, so they finish
exactly once elsewhere (``last_error`` keeps the exception; the fleet
raises only when no replica remains). With ``rebalance_queue > 0`` a
sustained hot-spot migrates queued requests off the deepest queue.

The replicas share one telemetry registry and one ``RequestTracer``;
the router adds its ``router_*`` series (requests routed, affinity and
directory hits, spills, readmissions, rebalances, live replicas,
per-replica queue depth, the audit ring). Host-side bookkeeping only —
no device reads, no wall clocks.
"""
from __future__ import annotations

from collections import deque

from torchbooster_tpu_torch.observability import get_registry
from torchbooster_tpu_torch.serving.batcher import ContinuousBatcher, Request
from torchbooster_tpu_torch.serving.router.audit import RoutingAudit
from torchbooster_tpu_torch.serving.router.directory import PrefixDirectory
from torchbooster_tpu_torch.serving.router.replica import (
    InProcessReplica,
    Replica,
)
from torchbooster_tpu_torch.serving.router.routing import (
    RoutingPolicy,
    _load_score,
    make_routing,
)

__all__ = ["EngineFleet"]


class EngineFleet:
    """The fleet front door's core (see module docstring).

    ``replicas`` is a non-empty list of :class:`Replica` (or bare
    ``ContinuousBatcher``s, wrapped in :class:`InProcessReplica`
    automatically); all replicas must share one scheduler-policy
    table (the fleet-level validate/deadline surface is
    ``replicas[0]``'s policy). ``routing`` is a
    :class:`RoutingPolicy` or its YAML name."""

    def __init__(self, replicas: list, routing=None, *,
                 rebalance_queue: int = 0, rebalance_after: int = 8,
                 directory: bool = True, audit: int = 256,
                 health=None, health_aware: bool = False):
        if not replicas:
            raise ValueError("EngineFleet needs at least one replica")
        wrapped: list[Replica] = []
        for i, rep in enumerate(replicas):
            if isinstance(rep, ContinuousBatcher):
                rep = InProcessReplica(i, rep)
            if not isinstance(rep, Replica):
                raise TypeError(
                    f"replica {i} must be a Replica or a "
                    f"ContinuousBatcher, got {type(rep).__name__}")
            rep.replica_id = i
            wrapped.append(rep)
        if rebalance_queue < 0:
            raise ValueError(
                f"rebalance_queue must be >= 0 (0 = off), got "
                f"{rebalance_queue}")
        if rebalance_after < 1:
            raise ValueError(
                f"rebalance_after must be >= 1, got {rebalance_after}")
        self.replicas = wrapped
        if routing is None:
            routing = "affinity"
        if isinstance(routing, str):
            routing = make_routing(routing)
        if not isinstance(routing, RoutingPolicy):
            raise TypeError(
                f"routing must be a RoutingPolicy or its name, got "
                f"{type(routing).__name__}")
        self.routing = routing
        self.rebalance_queue = int(rebalance_queue)
        self.rebalance_after = int(rebalance_after)
        # the fleet-level scheduler-policy surface (validate, retry
        # pricing, deadline lookup): the replicas share one class
        # table by construction (ServingConfig.make passes one policy
        # object to every batcher)
        # every Replica carries these now (a remote ships them in its
        # hello), so remote-first fleets price and validate exactly
        # like in-process ones
        self.policy = self.replicas[0].policy
        self.page_size = self.replicas[0].page_size
        # thread-safe inboxes, the batcher discipline: the event loop
        # submits/cancels while the pump thread steps
        self._inbox_submit: deque[Request] = deque()
        self._inbox_cancel: deque[Request] = deque()
        # arrival-ordered admission buffer (routed at step time) and
        # request -> replica ownership for cancel routing
        self._pending: list[Request] = []
        self._owner: dict[int, Replica] = {}
        self._session = False
        self._t0 = 0.0
        self._hot_streak = 0
        # the fleet-wide prefix directory: key -> {replica:
        # tier}, maintained from every in-process replica's
        # BlockTables tier events, consulted by AffinityRouting on a
        # map miss so a re-arriving tenant lands where its pages
        # actually ARE (HBM or host tier) instead of recomputing.
        # `directory=False` is the A/B control arm. Socket replicas
        # maintain it from their RPC event streams: set_tier_observer
        # asks the server to buffer tier events and the client
        # replays each response's batch through this same observer —
        # which is why the directory lives here and not in the engine.
        self.directory: PrefixDirectory | None = None
        if directory:
            self.directory = PrefixDirectory(
                self.page_size,
                max_pages=getattr(self.routing, "affinity_pages", 2))
            for rep in wrapped:
                rep.set_tier_observer(
                    self.directory.observer(rep.replica_id))
        # router session stats (the metrics-dict "router" block)
        self.n_routed = 0
        self.n_affinity_hits = 0
        self.n_spills = 0
        self.n_directory_hits = 0
        self.n_directory_evictions = 0
        self.n_readmitted = 0
        self.n_rebalanced = 0
        self.n_fleet_cancelled = 0
        # the determinism pin's observable: (request_id, replica_id)
        # in routing order — identical across replays of one workload
        self.assignment_log: list[tuple[str, int]] = []
        self.last_error: BaseException | None = None
        self._inst: dict | None = None
        # lazily-built stand-ins for remote-only fleets (tracer /
        # flight properties): remote batchers trace in their own
        # processes, so the fleet-local objects just keep the front
        # door's hooks satisfied
        self._fallback_tracer = None
        self._fallback_flight = None
        # the routing decision audit trail (audit.py): one bounded
        # record per routed request — 0 disables the ring (and the
        # /debug/router decision tail with it)
        if audit < 0:
            raise ValueError(
                f"audit must be >= 0 (0 = off), got {audit}")
        self.audit: RoutingAudit | None = \
            RoutingAudit(audit) if audit else None
        self._readmitted_ids: set[str] = set()
        # per-replica health scoring (health.py): observed every
        # fleet step when attached; consulted by ROUTING only under
        # the opt-in health_aware flag (decisions stay byte-identical
        # otherwise)
        if health_aware and health is None:
            raise ValueError(
                "health_aware=True needs a FleetHealth scorer "
                "(router.health.enabled in YAML)")
        self.health = health
        self.health_aware = bool(health_aware)
        if self.health_aware:
            self.routing.health = self.health

    # ---- clock plumbing (replay swaps it, every replica follows) --
    @property
    def clock(self):
        return self.replicas[0].clock

    @clock.setter
    def clock(self, fn) -> None:
        for rep in self.replicas:
            rep.clock = fn

    # ---- probe surface -------------------------------------------
    @property
    def live_replicas(self) -> list:
        return [r for r in self.replicas if r.alive]

    @property
    def n_live(self) -> int:
        return len(self.live_replicas)

    @property
    def queue_depth(self) -> int:
        return (len(self._inbox_submit) + len(self._pending)
                + sum(r.queue_depth for r in self.live_replicas))

    @property
    def has_work(self) -> bool:
        return bool(self._inbox_submit or self._inbox_cancel
                    or self._pending
                    or any(r.has_work for r in self.live_replicas))

    @property
    def session_active(self) -> bool:
        return self._session

    @property
    def occupancy(self) -> float:
        live = self.live_replicas
        if not live:
            return 1.0
        return max(r.occupancy for r in live)

    @property
    def est_step_s(self) -> float:
        live = self.live_replicas
        if not live:
            return 0.0
        return sum(r.est_step_s for r in live) / len(live)

    @property
    def engine(self):
        """A REPRESENTATIVE engine (geometry/backpressure pricing —
        all replicas are built identical); never a place to mutate
        fleet state through. Necessarily in-process: a remote-only
        fleet has no local engine object, and the consumers of this
        property (the front door's retry pricing and /debug/engine
        single-batcher form) price from geometry the hello already
        shipped — they should read ``page_size``/probe fields
        instead."""
        for rep in [*self.live_replicas, *self.replicas]:
            if isinstance(rep, InProcessReplica):
                return rep.batcher.engine
        raise RuntimeError(
            "no in-process replica: a remote-only fleet has no local "
            "engine (read geometry from fleet.page_size / the "
            "readiness payload instead)")

    @property
    def tracer(self):
        """The shared request tracer (ServingConfig.make hands one
        tracer to every replica so /debug/trace follows a request
        across the fleet). Remote-only fleets get a local (disabled)
        tracer — remote batchers trace in their own processes."""
        for rep in self.replicas:
            if isinstance(rep, InProcessReplica):
                return rep.batcher.tracer
        if self._fallback_tracer is None:
            from torchbooster_tpu_torch.observability.tracing import (
                RequestTracer)

            self._fallback_tracer = RequestTracer()
        return self._fallback_tracer

    @property
    def flight(self):
        """Replica 0's flight ring (the front door's crash-dump hook;
        per-replica rings are in :meth:`debug_fleet`). Remote-only
        fleets get a local empty ring — remote flight tails arrive
        via ``debug_row`` instead."""
        for rep in self.replicas:
            if isinstance(rep, InProcessReplica):
                return rep.batcher.flight
        if self._fallback_flight is None:
            from torchbooster_tpu_torch.observability.flight import (
                FlightRecorder)

            self._fallback_flight = FlightRecorder()
        return self._fallback_flight

    def session_now(self) -> float:
        if not self._session:
            raise RuntimeError("no active fleet session")
        return self.clock() - self._t0

    def readiness(self) -> dict:
        """Fleet readiness: the aggregate of every live replica's
        :meth:`ContinuousBatcher.readiness` payload plus per-replica
        rows — the ``GET /healthz?full=1`` body for a fleet-fronted
        server, and exactly what the router's load scorer reads."""
        rows = [r.readiness() for r in self.replicas]
        live = [row for row, rep in zip(rows, self.replicas)
                if rep.alive]
        return {
            "status": "ok" if live else "dead",
            "replicas_live": len(live),
            "replicas_total": len(self.replicas),
            "queue_depth": self.queue_depth,
            "pages_free": sum(row["pages_free"] for row in live),
            "pages_cached": sum(row["pages_cached"] for row in live),
            "inflight": sum(row["inflight"] for row in live),
            "occupancy": round(self.occupancy, 4),
            "est_step_s": round(self.est_step_s, 6),
            "replicas": rows,
        }

    # ---- session lifecycle ---------------------------------------
    def start_session(self) -> None:
        if self._session:
            raise RuntimeError(
                "a session is already active on this fleet")
        for rep in self.replicas:
            if not rep.alive:
                raise RuntimeError(
                    f"replica {rep.replica_id} is dead; build a fresh "
                    "fleet (dead replicas never resurrect mid-object)")
            rep.start_session()
        self._inbox_submit.clear()
        self._inbox_cancel.clear()
        self._pending.clear()
        self._owner.clear()
        self.routing.reset()
        self._hot_streak = 0
        self.n_routed = self.n_affinity_hits = self.n_spills = 0
        self.n_directory_hits = self.n_directory_evictions = 0
        self.n_readmitted = self.n_rebalanced = 0
        self.n_fleet_cancelled = 0
        self.assignment_log = []
        self.last_error = None
        self._readmitted_ids.clear()
        if self.audit is not None:
            self.audit.reset()
        if self.health is not None:
            self.health.reset()
        self._t0 = self.clock()
        reg = get_registry()
        self._inst = {
            "routed": reg.counter(
                "router_requests_total",
                "requests routed to a replica (labels replica, "
                "policy)"),
            "aff_hits": reg.counter(
                "router_affinity_hits_total",
                "requests routed to their prefix-affinity replica"),
            "spills": reg.counter(
                "router_spills_total",
                "hot-prefix requests spilled off their affinity "
                "replica by the load threshold"),
            "readmit": reg.counter(
                "router_readmissions_total",
                "requests re-admitted on another replica (labels "
                "reason=death|rebalance)"),
            "rebalanced": reg.counter(
                "router_rebalanced_total",
                "queued requests migrated off a sustained hot-spot"),
            "dir_hits": reg.counter(
                "router_directory_hits_total",
                "affinity-map misses resolved by the fleet prefix "
                "directory (routed to a page holder)"),
            "dir_evict": reg.counter(
                "router_directory_evictions_total",
                "directory entries dropped when their replica died"),
            "live": reg.gauge(
                "router_replicas_live",
                "replicas currently alive in the fleet"),
            "depth": reg.gauge(
                "router_queue_depth",
                "per-replica queue depth (label replica)"),
        }
        if self.audit is not None:
            self._inst["audit_depth"] = reg.gauge(
                "router_audit_depth",
                "routing decisions currently held in the bounded "
                "audit ring")
            self._inst["audit_total"] = reg.counter(
                "router_audit_records_total",
                "routing decisions recorded onto the audit ring")
        self._inst["live"].set(self.n_live)
        self._session = True

    def finish_session(self) -> dict:
        if not self._session:
            raise RuntimeError("no active fleet session")
        self._session = False
        per_replica: list[dict] = []
        for rep in self.replicas:
            try:
                per_replica.append(rep.finish_session())
            except Exception:  # noqa: BLE001 — a dead replica's
                # session is best-effort post-mortem; the survivors'
                # numbers (and the fleet merge) must still land
                per_replica.append({})
        self._inst["live"].set(self.n_live)
        return self._merge_metrics(per_replica)

    # ---- external driver surface ---------------------------------
    def submit(self, req: Request, arrival: float | None = None) -> None:
        """Thread-safe enqueue into the fleet admission buffer; the
        request routes to a replica at its arrival, on the next
        :meth:`step`. Raises (in the caller) when the request can
        never fit a replica's pool or its priority class is unknown —
        the front door maps that to HTTP 400, same as the
        single-batcher path."""
        if not self._session:
            raise RuntimeError(
                "no active session: start_session() first")
        live = self.live_replicas
        if not live:
            raise RuntimeError("no live replicas")
        live[0].check_fits(req)
        if self.policy is not None:
            self.policy.validate(req)
        req.arrival = (self.clock() - self._t0) if arrival is None \
            else arrival
        self._inbox_submit.append(req)

    def cancel(self, req: Request) -> None:
        """Thread-safe cancellation: drained at the next :meth:`step`
        — a still-pending request cancels at the fleet level, a
        routed one through its owning replica's abort paths."""
        self._inbox_cancel.append(req)

    def kill(self, replica_id: int) -> int:
        """Force one replica down (the failure-injection surface the
        replica-death tests and the ops runbook use): marks it dead,
        drains its queued + in-flight requests WITHOUT touching its
        engine, and re-admits them through the router. Returns how
        many requests were re-admitted."""
        rep = self.replicas[replica_id]
        if not rep.alive:
            return 0
        return self._bury(rep, reason="death")

    # ---- internals -----------------------------------------------
    def _bury(self, rep: Replica, reason: str) -> int:
        rep.alive = False
        orphans = rep.drain_unfinished(retire_seated=False)
        for req in orphans:
            self._owner.pop(id(req), None)
            self._pending.append(req)
            # the audit trail tags the re-route (readmit+<reason>)
            self._readmitted_ids.add(req.request_id)
        self.n_readmitted += len(orphans)
        # affinity metadata must not die silently with the replica:
        # death purges every entry naming the dead replica (counted, so an
        # operator sees the fleet's warm-page loss) and RESCUES its
        # host-tier chains: in-process, the dead engine's host-DRAM
        # pool outlives the object, so its payloads copy into a
        # survivor's pool (the directory-mediated host-tier fetch)
        # and re-record under the new holder.
        if self.directory is not None:
            dropped, host_keys = self.directory.purge_replica(
                rep.replica_id)
            self.n_directory_evictions += dropped
            if self._inst is not None and dropped:
                self._inst["dir_evict"].inc(dropped)
            self._reassign_host_pages(rep, host_keys)
        if self._inst is not None:
            self._inst["live"].set(self.n_live)
            if orphans:
                self._inst["readmit"].inc(len(orphans), reason=reason)
        return len(orphans)

    def _reassign_host_pages(self, dead: Replica,
                             host_keys: list) -> int:
        """Copy a dead replica's directory-known host-tier payloads
        into the least-loaded surviving replica's host pool and
        re-record the new holder — numpy copies through process
        memory today; the directory API is the seam where a socket
        fleet's page-fetch RPC slots in. Chains are moved page-ordered
        (shallowest first) so the survivor's LRU never holds a child
        page without its parent longer than one put. Best-effort: no
        survivor with a host pool, nothing to do."""
        if not host_keys or not isinstance(dead, InProcessReplica):
            return 0
        src = dead.batcher.engine.tables.host_pool
        if src is None:
            return 0
        targets = [r for r in self.live_replicas
                   if isinstance(r, InProcessReplica)
                   and r.batcher.engine.tables.host_pool is not None]
        if not targets:
            return 0
        target = min(targets, key=lambda r: (r.queue_depth,
                                             r.replica_id))
        dst = target.batcher.engine.tables.host_pool
        moved = 0
        for key in sorted(host_keys, key=len):
            payload = src.pop(key)
            if payload is None:
                continue        # already LRU-dropped: a stale hint
            dst.put(key, payload)
            self.directory.record(key, target.replica_id, "host")
            moved += 1
        self.directory.n_reassigned += moved
        return moved

    def _route_arrivals(self, now: float) -> None:
        if not self._pending:
            return
        live = self.live_replicas
        if not live:
            return
        # ONE partition pass (removing due items one-by-one would be
        # quadratic in the buffer depth on this step-cadence path)
        due = [r for r in self._pending if r.arrival <= now]
        if not due:
            return
        self._pending = [r for r in self._pending if r.arrival > now]
        # (arrival, request_id) order: the admission buffer's walk is
        # part of the pinned deterministic decision sequence
        due.sort(key=lambda r: (r.arrival, r.request_id))
        for req in due:
            rid = self.routing.choose(req, live, self)
            rep = self.replicas[rid]
            rep.submit(req, arrival=req.arrival)
            self._owner[id(req)] = rep
            self.n_routed += 1
            self.assignment_log.append((req.request_id, rid))
            self._inst["routed"].inc(replica=str(rid),
                                     policy=self.routing.name)
            if getattr(self.routing, "last_affinity_hit", False):
                self.n_affinity_hits += 1
                self._inst["aff_hits"].inc()
            if getattr(self.routing, "last_spill", False):
                self.n_spills += 1
                self._inst["spills"].inc()
            if getattr(self.routing, "last_directory_hit", False):
                self.n_directory_hits += 1
                self._inst["dir_hits"].inc()
            if self.audit is not None:
                self._audit_record(req, rid, live)
        if self.audit is not None:
            self._inst["audit_depth"].set(len(self.audit))

    def _audit_record(self, req: Request, rid: int,
                      live: list) -> None:
        """One audit-ring record per routing decision: the verdict
        (reason + affinity key) and the per-candidate load picture
        the router scored — request-cadence host dicts only."""
        routing = self.routing
        reason = getattr(routing, "last_reason", "") or routing.name
        if req.request_id in self._readmitted_ids:
            reason = f"readmit+{reason}"
        key = getattr(routing, "last_key", None)
        home = None
        key_pages = 0
        if key is not None:
            home = getattr(routing, "_map", {}).get(key)
            key_pages = min(
                len(req.prompt) // max(self.page_size, 1),
                getattr(routing, "affinity_pages", 0))
        rec = {
            "seq": self.audit.n_records,
            "request_id": req.request_id,
            "arrival": round(req.arrival, 6),
            "replica": rid,
            "reason": reason,
            "key": key,
            # the second affinity dimension (multi-LoRA serving):
            # which adapter the key folded in, "" = base traffic
            "adapter": getattr(req, "adapter", ""),
            "candidates": [{
                "replica": r.replica_id,
                "queue_depth": r.queue_depth,
                "inflight": r.inflight,
                "slack_s": round(_load_score(r, req), 6),
                "affinity_pages": (key_pages
                                   if r.replica_id == home else 0),
            } for r in live],
        }
        if self.health is not None:
            rec["health"] = {
                str(r.replica_id): self.health.state_name(
                    r.replica_id) for r in live}
        self.audit.record(rec)
        self._inst["audit_total"].inc()

    def _drain_cancels(self, events: list) -> None:
        while self._inbox_cancel:
            req = self._inbox_cancel.popleft()
            rep = self._owner.get(id(req))
            if rep is not None:
                rep.cancel(req)
                continue
            pending = next((r for r in self._pending if r is req), None)
            if pending is None or req.finished_at is not None:
                continue            # unknown/finished: benign race
            self._pending.remove(req)
            req.cancelled = True
            req.finished_at = self.clock() - self._t0
            req.finish_reason = "cancelled"
            self.n_fleet_cancelled += 1
            # the single-batcher cancel path's observability, one
            # level up: the tracer lifecycle event and (under an SLO
            # policy) the per-class cancel counter must not depend on
            # WHERE in the routing pipeline the cancel caught up
            if self.tracer.enabled:
                self.tracer.emit(req.request_id, "cancelled",
                                 n_tokens=0)
            if self.policy is not None and self.policy.slo:
                get_registry().counter(
                    "serving_slo_cancelled_total",
                    "requests cancelled by the client (per class)"
                ).inc(cls=self.policy.cls_of(req).name)
            events.append((req, []))

    def _rebalance(self) -> None:
        """Sustained hot-spot relief: after ``rebalance_after``
        consecutive steps with the deepest live queue more than
        ``rebalance_queue`` over the shallowest, migrate QUEUED
        requests (no engine state — the cheap end of the
        readmission-cost scale) off the hot replica until the gap
        closes."""
        if self.rebalance_queue <= 0 or self.n_live < 2:
            return
        live = self.live_replicas
        depths = {r.replica_id: r.queue_depth for r in live}
        hot = max(live, key=lambda r: (depths[r.replica_id],
                                       r.replica_id))
        gap = depths[hot.replica_id] - min(depths.values())
        if gap <= self.rebalance_queue:
            self._hot_streak = 0
            return
        self._hot_streak += 1
        if self._hot_streak < self.rebalance_after:
            return
        self._hot_streak = 0
        moved = hot.drain_queued(max(gap // 2, 1))
        others = [r for r in live if r is not hot]
        for req in moved:
            self._owner.pop(id(req), None)
            best = min(others, key=lambda r: (r.queue_depth,
                                              r.replica_id))
            best.submit(req, arrival=req.arrival)
            self._owner[id(req)] = best
            self.n_rebalanced += 1
            self.n_readmitted += 1
            self._inst["rebalanced"].inc()
            self._inst["readmit"].inc(reason="rebalance")

    def step(self) -> list:
        """ONE fleet iteration: drain inboxes, route due arrivals,
        step every live replica once (collecting their token events
        in replica order), bury any replica whose step raises
        (re-admitting its requests), then the hot-spot check. Raises
        only when the LAST replica dies."""
        if not self._session:
            raise RuntimeError(
                "no active session: start_session() first")
        events: list = []
        # submits land in the admission buffer BEFORE cancels drain
        # (the batcher's own inbox ordering): a request submitted and
        # then cancelled between two fleet steps must be findable in
        # _pending, or its cancel would silently drop
        while self._inbox_submit:
            self._pending.append(self._inbox_submit.popleft())
        self._drain_cancels(events)
        now = self.clock() - self._t0
        self._route_arrivals(now)
        for rep in self.replicas:
            if not rep.alive:
                continue
            try:
                events.extend(rep.step())
            except Exception as exc:  # noqa: BLE001 — replica death
                # is a fleet-survivable event; only a fleet with no
                # survivors propagates it
                self.last_error = exc
                self._bury(rep, reason="death")
                if not self.live_replicas:
                    raise
        # ownership ends with the request: popping terminal entries
        # bounds _owner by in-flight work AND closes the stale-id
        # window (id() of a collected Request can be reused — a live
        # entry under that address would misroute a later cancel)
        for req, _ in events:
            if req.finished_at is not None:
                root = req.parent if req.parent is not None else req
                family = root.branches or [root]
                if all(r.finished_at is not None for r in family):
                    # the WHOLE family: readmitted branch children
                    # get their own _owner entries when re-routed,
                    # and a leaked entry under a reused id() would
                    # misroute a later request's cancel
                    for r in family:
                        self._owner.pop(id(r), None)
        self._rebalance()
        if self.health is not None:
            self.health.observe(self)
        for rep in self.replicas:
            self._inst["depth"].set(
                rep.queue_depth if rep.alive else 0,
                replica=str(rep.replica_id))
        return events

    # ---- introspection -------------------------------------------
    def debug_snapshot(self, timeline_tail: int = 20) -> dict:
        """The ``/debug/requests`` payload for a fleet: every
        replica's snapshot merged, requests tagged with their replica
        (fleet-pending requests appear as ``replica: null``). Runs on
        the pump thread, like the single-batcher version."""
        out = {"active_session": self._session,
               "tracing_enabled": self.tracer.enabled,
               "queue_depth": self.queue_depth,
               "replicas_live": self.n_live,
               "requests": []}
        for req in self._pending:
            out["requests"].append({
                "request_id": req.request_id, "state": "routing",
                "replica": None, "priority": req.priority,
                "prompt_len": int(req.base_len),
                "arrival_s": round(req.arrival, 6)})
        for rep in self.replicas:
            if not rep.alive:
                continue
            snap = rep.debug_snapshot(timeline_tail=timeline_tail)
            for row in snap["requests"]:
                row["replica"] = rep.replica_id
                out["requests"].append(row)
        return out

    def debug_fleet(self) -> dict:
        """The ``/debug/engine`` payload for a fleet: router stats +
        one row per replica (alive flag, engine/pool stats, its
        flight-recorder tail) — the per-replica rows the flight dump
        grows in fleet mode. Each replica builds its own row
        (``Replica.debug_row``), so a remote's arrives over the wire
        with its endpoint attached."""
        return {"router": self.router_stats(),
                "replicas": [rep.debug_row()
                             for rep in self.replicas]}

    def debug_router(self, tail: int = 64) -> dict:
        """The ``GET /debug/router`` payload: router stats (policy,
        counters, health/audit blocks) + the audit ring's newest
        ``tail`` decision records. Runs on the pump thread like the
        other debug payloads — host dict reads only."""
        return {
            "router": self.router_stats(),
            "decisions": ([] if self.audit is None
                          else self.audit.tail(tail)),
        }

    def write_chrome(self, path) -> "Path":
        """Chrome trace for the fleet: the shared request tracer's
        tracks (pid 1 requests / pid 2 engine) MERGED with the router
        track (pid 3 — one thread row per replica, one instant per
        routing decision) so Perfetto shows who was routed where on
        the same timeline the requests run on."""
        from torchbooster_tpu_torch.observability.tracing import (
            write_chrome_trace)
        from torchbooster_tpu_torch.serving.router.audit import (
            chrome_router_events)

        events = list(self.tracer.chrome_events())
        if self.audit is not None:
            events += chrome_router_events(self.audit.tail())
        return write_chrome_trace(path, events)

    def router_stats(self) -> dict:
        return {
            "policy": self.routing.name,
            "n_replicas": len(self.replicas),
            "replicas_live": self.n_live,
            "n_routed": self.n_routed,
            "n_affinity_hits": self.n_affinity_hits,
            "n_spills": self.n_spills,
            "n_directory_hits": self.n_directory_hits,
            "n_directory_evictions": self.n_directory_evictions,
            "n_readmitted": self.n_readmitted,
            "n_rebalanced": self.n_rebalanced,
            "n_pending": len(self._pending),
            "directory": (None if self.directory is None else {
                "entries": len(self.directory),
                "n_records": self.directory.n_records,
                "n_hits": self.directory.n_hits,
                "n_evictions": self.directory.n_evictions,
                "n_reassigned": self.directory.n_reassigned,
            }),
            "audit": (None if self.audit is None else {
                "capacity": self.audit.capacity,
                "depth": len(self.audit),
                "n_records": self.audit.n_records,
            }),
            "health_aware": self.health_aware,
            "health": (None if self.health is None
                       else self.health.snapshot()),
        }

    # ---- metrics merge -------------------------------------------
    @staticmethod
    def _wmean(pairs: list) -> float:
        """Weight-averaged mean over (value, weight) pairs (0.0 when
        nothing weighed in)."""
        total = sum(w for _, w in pairs)
        if total <= 0:
            return 0.0
        return sum(v * w for v, w in pairs) / total

    def _merge_metrics(self, per_replica: list) -> dict:
        """One fleet metrics dict from the replicas' session dicts:
        counters sum, throughputs sum (parallel replicas), the
        elapsed window is the longest replica's, latency means are
        completion-weighted and percentiles conservative (max) —
        plus the per-replica dicts and the router block verbatim."""
        live = [m for m in per_replica if m]
        get = lambda m, k: m.get(k, 0) or 0
        weights = [(m, max(get(m, "n_requests"), 0)) for m in live]
        elapsed = max((get(m, "elapsed_s") for m in live), default=0.0)
        new_tokens = sum(get(m, "new_tokens") for m in live)
        # UNIQUE requests offered: a death/rebalance readmission
        # routes the same request twice, but it is still one request
        n_unique = len({rid for rid, _ in self.assignment_log})
        merged = {
            "n_requests": n_unique + self.n_fleet_cancelled,
            "new_tokens": new_tokens,
            "elapsed_s": round(elapsed, 4),
            "decode_tok_s": round(
                sum(get(m, "decode_tok_s") for m in live), 1),
            "total_tok_s": round(
                new_tokens / max(elapsed, 1e-9), 1),
            "latency_mean_s": round(self._wmean(
                [(get(m, "latency_mean_s"), w)
                 for m, w in weights]), 4),
            "latency_p95_s": round(max(
                (get(m, "latency_p95_s") for m in live),
                default=0.0), 4),
            "ttft_mean_s": round(self._wmean(
                [(get(m, "ttft_mean_s"), w) for m, w in weights]), 4),
            "n_admissions": sum(get(m, "n_admissions") for m in live),
            "n_preemptions": sum(get(m, "n_preemptions")
                                 for m in live),
            "n_prefill_chunks": sum(get(m, "n_prefill_chunks")
                                    for m in live),
            "prefix_hit_pages": sum(get(m, "prefix_hit_pages")
                                    for m in live),
            "n_shed": sum(get(m, "n_shed") for m in live),
            "n_cancelled": (sum(get(m, "n_cancelled") for m in live)
                            + self.n_fleet_cancelled),
            "deadline_hit_rate": round(self._wmean(
                [(get(m, "deadline_hit_rate"), w)
                 for m, w in weights]), 4),
            "router": self.router_stats(),
            "replicas": per_replica,
        }
        classes: dict = {}
        for m in live:
            for name, blk in (m.get("classes") or {}).items():
                agg = classes.setdefault(name, {
                    "n_requests": 0, "n_completed": 0, "n_shed": 0,
                    "ttft_p50_s": 0.0, "ttft_p99_s": 0.0,
                    "tpot_p50_s": 0.0, "tpot_p99_s": 0.0})
                for key in ("n_requests", "n_completed", "n_shed"):
                    agg[key] += blk.get(key, 0)
                for key in ("ttft_p50_s", "ttft_p99_s",
                            "tpot_p50_s", "tpot_p99_s"):
                    agg[key] = max(agg[key], blk.get(key) or 0.0)
        merged["classes"] = classes
        return merged
