"""Fleet-wide prefix directory — a copy of ``torchbooster_tpu/serving/
router/directory.py`` (numpy only), changed in its imports alone.

A chain-key bytes -> ``{replica_id: tier}`` index maintained from the
tier events every replica's :class:`~torchbooster_tpu_torch.serving.
kv_pages.BlockTables` emits through ``on_tier_event`` (register/promote
-> ``hbm``, demote -> ``host``, evict/host_evict -> forget), consulted by
the affinity policy on a map miss: route to the holder, whose own tiered
match then serves the pages from the card or promotes them from host
memory instead of recomputing.

Keys are the prefix index's chain-key bytes (the prompt's leading
``(i + 1) * page_size`` int32 tokens), capped at ``max_pages`` deep —
the alignment the affinity key hashes. Entries are hints: a stale one
routes to a replica that cold-prefills, so correctness never depends on
the directory, only TTFT does. :meth:`PrefixDirectory.purge_replica`
drops a dead replica's entries and returns its host-tier keys, which the
fleet copies into a survivor's host pool.

Host-side bookkeeping only: no device reads, no clocks.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PrefixDirectory"]

_TIERS = ("hbm", "host")


class PrefixDirectory:
    """Chain-key bytes -> ``{replica_id: tier}`` (see module
    docstring). ``page_size`` fixes the chain-key stride;
    ``max_pages`` caps recorded depth (the affinity-key cap — deeper
    chains are per-request tails, not routable tenant prefixes)."""

    def __init__(self, page_size: int, max_pages: int = 2):
        if page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {page_size}")
        if max_pages < 1:
            raise ValueError(
                f"max_pages must be >= 1, got {max_pages}")
        self.page_size = int(page_size)
        self.max_pages = int(max_pages)
        self._holders: dict[bytes, dict[int, str]] = {}
        # session-independent counters (the fleet's router_stats and
        # the router_directory_* series read these)
        self.n_records = 0
        self.n_hits = 0
        self.n_evictions = 0    # entries dropped (evict/death purge)
        self.n_reassigned = 0   # host chains re-homed off a dead
        #                         replica (fleet increments)

    def _depth(self, key: bytes) -> int:
        return len(key) // (4 * self.page_size)

    def __len__(self) -> int:
        return len(self._holders)

    # ---- event side ----------------------------------------------
    def record(self, key: bytes, replica_id: int, tier: str) -> None:
        """Note that ``replica_id`` holds ``key``'s page in ``tier``
        (moves between tiers overwrite in place). Chains past the
        depth cap are ignored — they are never routed by."""
        if tier not in _TIERS:
            raise ValueError(f"tier must be one of {_TIERS}, got "
                             f"{tier!r}")
        if not 1 <= self._depth(key) <= self.max_pages:
            return
        self._holders.setdefault(key, {})[int(replica_id)] = tier
        self.n_records += 1

    def forget(self, key: bytes, replica_id: int) -> None:
        """Drop ``replica_id``'s claim on ``key`` (no-op when absent
        — eviction events can outrun recording at session edges)."""
        held = self._holders.get(key)
        if held is None or int(replica_id) not in held:
            return
        del held[int(replica_id)]
        self.n_evictions += 1
        if not held:
            del self._holders[key]

    def observer(self, replica_id: int):
        """The ``BlockTables.on_tier_event`` callback bound to one
        replica — the whole maintenance contract in one place:
        register/promote mean the key's page is HBM-resident there,
        demote means host-resident, evict/host_evict mean gone."""
        rid = int(replica_id)

        def on_event(event: str, key: bytes) -> None:
            if event in ("register", "promote"):
                self.record(key, rid, "hbm")
            elif event == "demote":
                self.record(key, rid, "host")
            elif event in ("evict", "host_evict"):
                self.forget(key, rid)

        return on_event

    # ---- lookup side ---------------------------------------------
    def lookup(self, prompt: np.ndarray,
               live_ids=None) -> tuple[int, str, int] | None:
        """The routing consult: the deepest known holder of
        ``prompt``'s page chain, as ``(replica_id, tier, depth)``.
        Walks depths 1..``max_pages`` (byte-prefixes of the affinity
        head); at the deepest populated depth HBM holders beat host
        holders, ties break on the lower replica id (determinism).
        ``live_ids`` (a container of replica ids) filters dead or
        excluded holders; returns None when nobody useful holds
        anything."""
        prompt = np.ascontiguousarray(prompt, np.int32).reshape(-1)
        limit = min(len(prompt) // self.page_size, self.max_pages)
        best: tuple[int, str, int] | None = None
        for d in range(1, limit + 1):
            held = self._holders.get(
                prompt[:d * self.page_size].tobytes())
            if not held:
                continue
            ranked = [(rid, tier) for rid, tier in held.items()
                      if live_ids is None or rid in live_ids]
            if not ranked:
                continue
            rid, tier = min(ranked,
                            key=lambda rt: (rt[1] != "hbm", rt[0]))
            best = (rid, tier, d)
        if best is not None:
            self.n_hits += 1
        return best

    def entries_for(self, replica_id: int) -> list[tuple[bytes, str]]:
        """Every (key, tier) the replica currently holds — the
        death-reassignment walk's input, and a test observable."""
        rid = int(replica_id)
        return [(key, held[rid])
                for key, held in self._holders.items() if rid in held]

    def purge_replica(self, replica_id: int
                      ) -> tuple[int, list[bytes]]:
        """Death: drop every entry naming ``replica_id``. Returns
        ``(n_dropped, host_keys)`` — the dropped-entry count feeds the
        ``router_directory_evictions`` counter, and the host-tier keys
        are the chains the fleet can still SAVE by copying the dead
        replica's host-pool payloads to a survivor (re-``record`` them
        after the copy)."""
        rid = int(replica_id)
        host_keys: list[bytes] = []
        dropped = 0
        for key in list(self._holders):
            held = self._holders[key]
            tier = held.pop(rid, None)
            if tier is None:
                continue
            dropped += 1
            if tier == "host":
                host_keys.append(key)
            if not held:
                del self._holders[key]
        self.n_evictions += dropped
        return dropped, host_keys

    def check(self) -> None:
        """Structural invariants (test hook): no empty holder sets,
        every depth within the cap, every tier legal."""
        for key, held in self._holders.items():
            assert held, f"empty holder set for key of {len(key)}B"
            assert 1 <= self._depth(key) <= self.max_pages, \
                f"key depth {self._depth(key)} outside [1, " \
                f"{self.max_pages}]"
            for rid, tier in held.items():
                assert tier in _TIERS, (rid, tier)
