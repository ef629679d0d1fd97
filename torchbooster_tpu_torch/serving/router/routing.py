"""Routing policies — a copy of ``torchbooster_tpu/serving/router/
routing.py`` (numpy and zlib only), changed in its imports alone. Keys
are byte-equal to the JAX module's for the same prompt, page size and
adapter.

The fleet owns the mechanism (admission buffering, stepping,
readmission) and delegates one decision here: given an arrived request
and the live replicas, pick the replica.

- :class:`RoundRobinRouting` — live replicas in a fixed cycle, the
  control arm.
- :class:`AffinityRouting` — prefix affinity with an SLO-aware spill.
  The key is the page-aligned prompt prefix (at most ``affinity_pages``
  full pages, with the adapter folded in); it maps, first come and
  least loaded, to a replica where later holders of the key land. When
  the mapped replica's backlog sits ``spill_queue`` over the shallowest
  live one the request spills to the least-loaded replica (the map is
  untouched). Keyless requests and spills route by least expected
  slack: queued work times the replica's EWMA chunk/step estimates.

Every input is a host-side counter the replica surface exposes, and ties
break on the replica index, so a decision is a pure function of
(request, replica states). No clocks, no device reads, no randomness.
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["AffinityRouting", "RoundRobinRouting", "RoutingPolicy",
           "make_routing", "prefix_affinity_key"]


def prefix_affinity_key(prompt: np.ndarray, page_size: int,
                        affinity_pages: int,
                        adapter: str = "") -> int | None:
    """The request's affinity key: crc32 over its leading full pages
    (at most ``affinity_pages`` of them — enough to separate tenants'
    system prompts without hashing whole contexts), or ``None`` when
    the prompt has no full page to key by. Page alignment matches the
    prefix index exactly: two prompts sharing a key share at least
    that many cached pages on whatever replica served either first.

    ``adapter`` (multi-LoRA serving) is a SECOND affinity dimension
    folded into the key: same-adapter traffic lands on one replica so
    its lane stays device-resident there (pinned or LRU-cached)
    instead of hot-load-thrashing across the fleet — the adapter
    analogue of the warm-page argument. A sub-page prompt WITH an
    adapter still keys (by the adapter alone); adapter-less requests
    produce byte-identical keys to the pre-adapter router."""
    n_full = len(prompt) // page_size
    base = None
    if n_full >= 1:
        take = min(n_full, max(affinity_pages, 1)) * page_size
        head = np.ascontiguousarray(prompt[:take], np.int32)
        base = zlib.crc32(head.tobytes()) & 0xFFFFFFFF
    if adapter:
        return zlib.crc32(adapter.encode(),
                          0 if base is None else base) & 0xFFFFFFFF
    return base


class RoutingPolicy:
    """Routing hook surface: ``choose`` returns a replica index from
    ``live`` (non-empty, ascending). ``reset()`` clears per-session
    state at fleet session start so replays are reproducible.

    ``last_reason`` / ``last_key`` are per-choice verdict attributes
    (like ``AffinityRouting.last_*``) the fleet's audit trail reads
    back after each ``choose``. ``health`` is ``None`` unless the
    fleet's opt-in ``health_aware`` flag attaches a ``FleetHealth``
    scorer — policies that score load multiply by its per-replica
    weight; with ``None`` (the default) no arithmetic changes and
    decisions stay byte-identical."""

    name = "round_robin"
    last_reason = ""
    last_key: int | None = None
    health = None

    def reset(self) -> None:
        pass

    def choose(self, req, live: list, fleet) -> int:
        raise NotImplementedError


class RoundRobinRouting(RoutingPolicy):
    """Live replicas in a fixed cycle — the control arm."""

    def __init__(self) -> None:
        self._next = 0

    def reset(self) -> None:
        self._next = 0

    def choose(self, req, live: list, fleet) -> int:
        self.last_reason = "round_robin"
        pick = live[self._next % len(live)]
        self._next += 1
        return pick.replica_id


def _load_score(replica, req) -> float:
    """Least-expected-slack load score: a proxy for the seconds until
    ``req`` would see its first token on this replica — queued +
    in-flight work at the replica's measured EWMA cadence (the same
    estimates the SLO policy's slack math consumes). Cold
    replicas (nothing measured yet) score by raw backlog so the very
    first requests still spread; minimizing the score maximizes the
    request's remaining deadline slack."""
    est = max(replica.est_chunk_s, replica.est_step_s)
    backlog = replica.queue_depth + replica.inflight
    if est <= 0.0:
        return 1.0 * backlog
    return backlog * est


class AffinityRouting(RoutingPolicy):
    """Prefix-affinity with load spill (see module docstring).

    ``affinity_pages`` caps the pages hashed into the key;
    ``spill_queue`` is the queue-depth excess over the shallowest
    live replica beyond which the mapped replica is considered hot
    and the request spills to the least-loaded one."""

    name = "affinity"

    def __init__(self, affinity_pages: int = 2, spill_queue: int = 4):
        if affinity_pages < 1:
            raise ValueError(
                f"affinity_pages must be >= 1, got {affinity_pages}")
        if spill_queue < 1:
            raise ValueError(
                f"spill_queue must be >= 1 (0 would spill every "
                f"request off its warm replica), got {spill_queue}")
        self.affinity_pages = int(affinity_pages)
        self.spill_queue = int(spill_queue)
        self._map: dict[int, int] = {}
        # per-choice verdicts the fleet's counters read back (the
        # choose() return is just an index; the router metrics want
        # to know WHY)
        self.last_affinity_hit = False
        self.last_spill = False
        self.last_directory_hit = False

    def reset(self) -> None:
        self._map.clear()
        self.last_affinity_hit = False
        self.last_spill = False
        self.last_directory_hit = False
        self.last_reason = ""
        self.last_key = None

    def _least_loaded(self, req, live: list) -> int:
        # min score, ties toward the lower replica id (determinism).
        # With a health scorer attached (the fleet's opt-in
        # health_aware flag) the score is down-weighted by the
        # replica's health multiplier on a SEPARATE branch: the
        # health=None path runs the exact pre-existing float
        # arithmetic, so disabled routing stays byte-identical.
        if self.health is not None:
            h = self.health
            best = min(live, key=lambda r: (
                _load_score(r, req) * h.weight(r.replica_id),
                r.replica_id))
            return best.replica_id
        best = min(live, key=lambda r: (_load_score(r, req),
                                        r.replica_id))
        return best.replica_id

    def choose(self, req, live: list, fleet) -> int:
        self.last_affinity_hit = False
        self.last_spill = False
        self.last_directory_hit = False
        key = prefix_affinity_key(
            req.prompt, fleet.page_size, self.affinity_pages,
            adapter=getattr(req, "adapter", ""))
        self.last_key = key
        if key is None:
            self.last_reason = "least_loaded"
            return self._least_loaded(req, live)
        by_id = {r.replica_id: r for r in live}
        home = self._map.get(key)
        if home is None or home not in by_id:
            # first sight of this prefix (or its home died): before
            # binding blind, ask the fleet prefix DIRECTORY
            # whether some live replica already holds the chain's
            # pages — HBM- or host-tier. Routing to the holder turns
            # the miss into that replica's own tiered match (an HBM
            # hit or a host promotion) instead of a recompute; the
            # map then re-binds there so later arrivals follow.
            directory = getattr(fleet, "directory", None)
            if directory is not None:
                hit = directory.lookup(req.prompt, live_ids=by_id)
                if hit is not None:
                    self._map[key] = hit[0]
                    self.last_directory_hit = True
                    self.last_reason = "directory"
                    return hit[0]
            # nobody holds it: bind to the least-loaded live replica
            # — the pages warm THERE
            home = self._least_loaded(req, live)
            self._map[key] = home
            self.last_reason = "bind"
            return home
        # backlog = queued + in-flight: a replica with every slot
        # busy and an empty queue is NOT idle — the spill check must
        # read the same load proxy the scorer does, or a hot home
        # replica hides behind its seated work
        busy = {r.replica_id: r.queue_depth + r.inflight for r in live}
        if busy[home] - min(busy.values()) >= self.spill_queue:
            # hot prefix: protect the home replica's queue; the map
            # keeps pointing home so traffic returns once it drains
            self.last_spill = True
            self.last_reason = "spill"
            return self._least_loaded(req, live)
        self.last_affinity_hit = True
        self.last_reason = "affinity"
        return home


def make_routing(policy: str, affinity_pages: int = 2,
                 spill_queue: int = 4) -> RoutingPolicy:
    """Build a routing policy by YAML name (``serving.router.policy``)."""
    if policy == "round_robin":
        return RoundRobinRouting()
    if policy == "affinity":
        return AffinityRouting(affinity_pages=affinity_pages,
                               spill_queue=spill_queue)
    raise ValueError(
        f"router.policy must be 'round_robin' or 'affinity', got "
        f"{policy!r}")
