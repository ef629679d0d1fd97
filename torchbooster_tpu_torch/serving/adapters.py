"""Batched multi-LoRA serving: the refcounted adapter registry — the
port of ``torchbooster_tpu/serving/adapters.py``.

Many tenants share ONE paged engine: each request may name an adapter,
and every decode step applies each slot's ranked delta ``h @ A[g] @
B[g]`` with the adapters stacked on a device LANE axis — the per-slot
lane ids are a fixed-shape operand of every step (``models/gpt.py``
``_block_core(lora=...)``), so adapter churn (hot-load, evict, mixed
batches) never changes a step's operand shapes.

Lane lifetime mirrors ``kv_pages``'s three-state page lifetime:

- **pinned** — at least one seated slot decodes through the lane
  (``refcount > 0``): never evicted;
- **cached** — loaded, refcount 0: stays device-resident for a later
  :meth:`acquire` hit, evicted LRU when a new adapter needs a lane;
- **free** — never loaded.

Lane 0 is RESERVED for the zero adapter: base-model traffic gathers
all-zero stacks, so its delta is exactly zero and un-adaptered requests
stay token-identical with the feature on.

``acquire`` at SEAT time, ``release`` at retire (the batcher drives
both): a preempted request drops its pin and re-acquires on re-seat —
possibly landing a different lane, which is fine because lanes are
values. ``acquire`` returns ``None`` when every lane is pinned (the
caller keeps the request queued — the same backpressure contract as
``admit_begin`` under pool exhaustion); unknown names raise
``KeyError``.

Hot-loading writes one lane of the four device stacks in place through
the engine's one fixed-shape writer (``PagedEngine.lora_load``). Under
``tp`` the ``b_qkv`` columns are permuted rank-major at registration
(``qkv_tp_permutation``, the base kernel's layout), so that the block's
column slice hands rank ``i`` its ``[q_i | k_i | v_i]``; every rank holds
the whole stacks and cuts its slice in the step.
"""
from __future__ import annotations

from typing import Any

import numpy as np


def random_adapter(seed: int, cfg: Any, rank: int,
                   std: float = 0.02) -> dict[str, np.ndarray]:
    """Synthesize a random LoRA adapter (bench/test traffic): normal
    A factors, normal (NOT zero) B factors — a conventionally-
    initialized fresh adapter has B = 0 and therefore a zero delta,
    which would make multi-adapter parity trivially true and test
    nothing."""
    r = np.random.default_rng(seed)
    d = cfg.d_model
    head_dim = d // cfg.n_heads
    qkv_out = d + 2 * cfg.kv_heads * head_dim
    sh = lambda *s: (std * r.standard_normal(s)).astype(np.float32)
    return {"a_qkv": sh(cfg.n_layers, d, rank),
            "b_qkv": sh(cfg.n_layers, rank, qkv_out),
            "a_proj": sh(cfg.n_layers, d, rank),
            "b_proj": sh(cfg.n_layers, rank, d)}


class AdapterRegistry:
    """Name -> host weights -> refcounted device lane, for ONE engine
    (``PagedEngine(lora_rank=..., lora_max_live=...)`` builds its own).
    Host-side bookkeeping only — the device work is the engine's
    fixed-shape lane writer."""

    def __init__(self, engine: Any):
        if not engine.lora:
            raise ValueError(
                "AdapterRegistry needs an engine with lora enabled "
                "(lora_rank > 0 and lora_max_live > 0)")
        self.engine = engine
        self.rank = engine.lora_rank
        self.max_live = engine.lora_max_live
        self._host: dict[str, dict[str, np.ndarray]] = {}
        self._lane_of: dict[str, int] = {}     # loaded name -> lane
        self._refs: dict[str, int] = {}        # loaded name -> pins
        self._lru: dict[str, int] = {}         # loaded name -> tick
        self._tick = 0
        # telemetry counters (batcher metric families)
        self.loads = 0        # lane writes (cold or re-load)
        self.evictions = 0    # cached lanes displaced
        self.hits = 0         # acquires served by a resident lane

    # ---- registration --------------------------------------------
    def register(self, name: str, weights: dict) -> None:
        """Register adapter ``name``'s host weights: a dict of
        ``a_qkv (L, d, r)``, ``b_qkv (L, r, qkv_out)``, ``a_proj
        (L, d, r)``, ``b_proj (L, r, d)`` with ``r <= lora_rank``
        (smaller ranks zero-pad to the engine's trace-fixed rank —
        rank is a SHAPE, so it cannot vary per adapter without
        recompiling). Registration is host-only; nothing touches the
        device until the first :meth:`acquire`."""
        if not name:
            raise ValueError(
                "adapter name must be non-empty ('' is the base "
                "model, lane 0)")
        cfg = self.engine.cfg
        d = cfg.d_model
        qkv_out = d + 2 * cfg.kv_heads * (d // cfg.n_heads)
        want = {"a_qkv": (cfg.n_layers, d, None),
                "b_qkv": (cfg.n_layers, None, qkv_out),
                "a_proj": (cfg.n_layers, d, None),
                "b_proj": (cfg.n_layers, None, d)}
        stacks: dict[str, np.ndarray] = {}
        r_seen = None
        for key, shape in want.items():
            if key not in weights:
                raise ValueError(
                    f"adapter {name!r} is missing the {key!r} stack")
            w = np.asarray(weights[key], np.float32)
            r_axis = [i for i, s in enumerate(shape) if s is None][0]
            r = w.shape[r_axis]
            fixed = tuple(s if s is not None else r for s in shape)
            if w.shape != fixed:
                raise ValueError(
                    f"adapter {name!r} {key} has shape {w.shape}, "
                    f"expected {fixed} for this model")
            if r_seen is None:
                r_seen = r
            elif r != r_seen:
                raise ValueError(
                    f"adapter {name!r} mixes ranks ({r_seen} vs {r} "
                    f"on {key}) — one rank per adapter")
            stacks[key] = w
        if r_seen > self.rank:
            raise ValueError(
                f"adapter {name!r} has rank {r_seen} > the engine's "
                f"lora_rank {self.rank} — the rank axis is a trace "
                "shape; rebuild the engine with a larger rank")
        if r_seen < self.rank:
            pad = self.rank - r_seen
            stacks["a_qkv"] = np.pad(stacks["a_qkv"],
                                     ((0, 0), (0, 0), (0, pad)))
            stacks["a_proj"] = np.pad(stacks["a_proj"],
                                      ((0, 0), (0, 0), (0, pad)))
            stacks["b_qkv"] = np.pad(stacks["b_qkv"],
                                     ((0, 0), (0, pad), (0, 0)))
            stacks["b_proj"] = np.pad(stacks["b_proj"],
                                      ((0, 0), (0, pad), (0, 0)))
        if self.engine.tp > 1:
            from torchbooster_tpu_torch.models.gpt import qkv_tp_permutation

            perm = qkv_tp_permutation(cfg, self.engine.tp)
            stacks["b_qkv"] = np.take(stacks["b_qkv"], perm, axis=2)
        if name in self._lane_of:
            # re-registering a RESIDENT adapter must refresh its lane
            # (a stale lane would silently serve the old weights);
            # refresh through the same one writer, at the same shapes
            self._host[name] = stacks
            self.engine.lora_load(self._lane_of[name], stacks)
            self.loads += 1
            return
        self._host[name] = stacks

    def known(self, name: str) -> bool:
        """The frontend's 400 predicate: '' (base) is always known."""
        return name == "" or name in self._host

    @property
    def names(self) -> list[str]:
        return sorted(self._host)

    # ---- lane lifecycle ------------------------------------------
    def acquire(self, name: str) -> int | None:
        """Pin ``name`` and return its lane, hot-loading into a free
        or LRU-evictable lane first if needed. ``''`` -> lane 0 (the
        base model — unrefcounted, always resident). Returns ``None``
        when every lane is pinned by seated slots (caller keeps the
        request queued)."""
        if name == "":
            return 0
        if name not in self._host:
            raise KeyError(
                f"unknown adapter {name!r} — register() it first "
                f"(known: {self.names})")
        self._tick += 1
        lane = self._lane_of.get(name)
        if lane is not None:
            self._refs[name] += 1
            self._lru[name] = self._tick
            self.hits += 1
            return lane
        lane = self._free_lane()
        if lane is None:
            return None
        self.engine.lora_load(lane, self._host[name])
        self.loads += 1
        self._lane_of[name] = lane
        self._refs[name] = 1
        self._lru[name] = self._tick
        return lane

    def release(self, name: str) -> None:
        """Drop one pin (retire/preempt/cancel); the lane stays
        cached for the next acquire until eviction needs it."""
        if name == "":
            return
        refs = self._refs.get(name)
        if refs is None or refs <= 0:
            raise RuntimeError(
                f"release({name!r}) without a matching acquire — "
                "refcount bookkeeping is broken")
        self._refs[name] = refs - 1

    def _free_lane(self) -> int | None:
        used = set(self._lane_of.values())
        for lane in range(1, self.max_live + 1):
            if lane not in used:
                return lane
        cached = [n for n, r in self._refs.items() if r == 0]
        if not cached:
            return None                      # every lane is pinned
        victim = min(cached, key=lambda n: self._lru[n])
        lane = self._lane_of.pop(victim)
        del self._refs[victim]
        del self._lru[victim]
        self.evictions += 1
        return lane

    # ---- observability -------------------------------------------
    @property
    def pinned_count(self) -> int:
        return sum(1 for r in self._refs.values() if r > 0)

    @property
    def resident_count(self) -> int:
        return len(self._lane_of)

    def debug(self) -> dict:
        """``/debug/engine`` block: host integers only."""
        return {
            "registered": len(self._host),
            "resident": self.resident_count,
            "pinned": self.pinned_count,
            "max_live": self.max_live,
            "rank": self.rank,
            "loads": self.loads,
            "evictions": self.evictions,
            "hits": self.hits,
            "lanes": {n: {"lane": l, "refs": self._refs[n]}
                      for n, l in sorted(self._lane_of.items())},
        }


__all__ = ["AdapterRegistry", "random_adapter"]
