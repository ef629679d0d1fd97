"""Paged KV cache — the port of ``torchbooster_tpu/serving/kv_pages.py``:
a fixed pool of K/V pages plus per-slot block tables, with REFCOUNTED
pages and a prompt-prefix index so requests sharing a prompt prefix
share the physical pages instead of recomputing them.

Two cooperating halves:

- :func:`make_pool` — the device pool (one K and one V tensor stacked
  on the leading layer axis; bf16/fp32, or int8 + bf16 scales written
  with the same ``_quantize_kv`` the dense int8 cache uses);
- :class:`BlockTables` — HOST-side refcount/evict bookkeeping in plain
  numpy, copied from the JAX package: seating, retiring and evicting
  only change VALUES inside fixed-shape tables, so the decode step's
  operand shapes depend on pool geometry alone.

**Page lifetime.** A page is *referenced* (``refcount > 0``), *cached*
(``refcount == 0`` but a registered prompt prefix, kept resident for a
later request with the same prefix) or *free*. Retire decrements
refcounts; cached prefixes are reclaimed LRU — deepest chain pages
first — whenever an allocation needs more pages than the free list.

**The prefix index.** Full prompt pages register under the exact byte
string of the prompt up to and including that page. The match is capped
at ``(prompt_len - 1) // page_size`` pages so the LAST prompt token is
always recomputed (its logits seed the first sampled token); matched
full pages map shared, everything after allocates private pages, so a
decode write never lands on a shared page.

Page 0 is RESERVED as the null page: free slots' table entries and
inactive slots' write targets point at it, its refcount stays 0, and
every attention read masks it out.

**The host spill tier.** With a :class:`HostPagePool` attached,
eviction of a cached prefix page becomes a DEMOTION: the engine's
``spill_fetch`` callback copies the page's K/V to host memory (int8
values plus fp32 scales) under the same chain key the HBM index uses,
and the pool slot returns to the free list. A host-resident page
occupies no pool id and is never refcounted. :meth:`match_tiered`
walks both tiers in one lookup — the HBM-resident prefix first, then
its host-resident continuation — so the engine maps the HBM pages
shared and PROMOTES the host pages back with one fixed-shape write
instead of recomputing them. The host pool is itself LRU under a byte
budget; pages that fall off its tail are gone for real.
"""
from __future__ import annotations

import numpy as np
import torch

from torchbooster_tpu_torch.models.gpt import GPTConfig

NULL_PAGE = 0


class PoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied even after
    evicting cached prefixes. A ``RuntimeError`` subclass so every
    ``except RuntimeError`` capacity handler keeps working."""


def make_pool(cfg: GPTConfig, page_size: int, n_pages: int,
              cache_dtype: str | None = None,
              compute_dtype: torch.dtype = torch.bfloat16,
              device: str | torch.device = "cuda") -> dict:
    """Allocate the device pool: ``{"k": ..., "v": ...}`` with each
    entry ``(n_layers, n_pages, page_size, kv_heads, head_dim)`` — a
    plain tensor in ``compute_dtype``, or, when ``cache_dtype`` is
    ``"int8"``, the ``(int8 values, bf16 scales (..., 1))`` pair."""
    if cache_dtype not in (None, "int8"):
        raise ValueError(
            f"cache_dtype must be None or 'int8', got {cache_dtype!r}")
    shape = (cfg.n_layers, n_pages, page_size, cfg.kv_heads, cfg.head_dim)
    if cache_dtype == "int8":
        mk = lambda: (torch.zeros(shape, dtype=torch.int8, device=device),
                      torch.ones(shape[:-1] + (1,), dtype=torch.bfloat16,
                                 device=device))
    else:
        mk = lambda: torch.zeros(shape, dtype=compute_dtype, device=device)
    return {"k": mk(), "v": mk()}


class HostPagePool:
    """The host-memory page spill tier: demoted prefix pages as
    ``chain-key bytes -> payload`` entries under a byte budget.

    A payload is an opaque dict of HOST numpy arrays (the engine's
    demotion callback builds it: int8 K/V values + float32 scales for
    one page across every layer) — this class only owns the residency
    policy: LRU by insertion/touch tick, evict-oldest when a ``put``
    would overflow ``budget_bytes``. Pure host bookkeeping with no
    device handles, so entries move between pools with a plain numpy
    copy (disaggregated serving streams them from one engine to
    another).

    Counters: ``n_spills`` pages demoted in, ``n_evictions`` pages
    dropped by the budget, ``used_bytes`` current residency."""

    def __init__(self, budget_bytes: int):
        if budget_bytes < 1:
            raise ValueError(
                f"host pool budget must be >= 1 byte, got "
                f"{budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self._pages: dict[bytes, dict] = {}
        self._nbytes: dict[bytes, int] = {}
        self._lru: dict[bytes, int] = {}
        self._tick = 0
        self.used_bytes = 0
        self.n_spills = 0
        self.n_evictions = 0

    def __contains__(self, key: bytes) -> bool:
        return key in self._pages

    def __len__(self) -> int:
        return len(self._pages)

    def keys(self) -> list[bytes]:
        return list(self._pages)

    def get(self, key: bytes) -> dict | None:
        """Peek a payload (no residency change)."""
        return self._pages.get(key)

    def put(self, key: bytes, payload: dict) -> list[bytes]:
        """Insert (or refresh) a page; returns the keys the byte
        budget pushed out. A payload larger than the whole budget is
        refused by eviction-to-empty — the page just drops (returned
        in the evicted list) rather than wedging the pool."""
        nbytes = sum(int(a.nbytes) for a in payload.values())
        self.pop(key)                    # refresh == replace
        evicted: list[bytes] = []
        while self._lru and self.used_bytes + nbytes > self.budget_bytes:
            old = min(self._lru, key=self._lru.get)
            self.pop(old)
            self.n_evictions += 1
            evicted.append(old)
        if nbytes > self.budget_bytes:
            self.n_evictions += 1
            return evicted + [key]
        self._tick += 1
        self._pages[key] = payload
        self._nbytes[key] = nbytes
        self._lru[key] = self._tick
        self.used_bytes += nbytes
        self.n_spills += 1
        return evicted

    def pop(self, key: bytes) -> dict | None:
        """Remove and return a payload (promotion consumes it)."""
        payload = self._pages.pop(key, None)
        if payload is not None:
            self.used_bytes -= self._nbytes.pop(key)
            del self._lru[key]
        return payload

    def check(self) -> None:
        """Structural invariants (the spill churn tests' assert)."""
        assert self._pages.keys() == self._nbytes.keys() \
            == self._lru.keys(), "host pool key-map drift"
        assert self.used_bytes == sum(self._nbytes.values()), (
            "host pool byte accounting drift")
        assert self.used_bytes <= self.budget_bytes, (
            f"host pool over budget: {self.used_bytes} > "
            f"{self.budget_bytes}")


class BlockTables:
    """Host-side refcounted page bookkeeping for ``max_slots`` serving
    slots over a ``n_pages``-page pool (page 0 reserved null).

    All state is fixed-shape numpy; seat/retire/evict is integer index
    arithmetic. The decode step consumes :meth:`device_args` — the
    VALUES change per step, the shapes never do, so slot churn never
    changes the decode step's operand shapes.

    Arrays:

    - ``tables (max_slots, max_pages_per_slot) int32`` — page ids per
      slot, ``NULL_PAGE`` where unassigned; prefix-shared pages appear
      in several slots' rows at the SAME index;
    - ``lengths (max_slots,) int32`` — tokens currently stored (set at
      :meth:`seat` time, grown by :meth:`advance`);
    - ``refcount (n_pages,) int32`` — number of slots holding the page
      (0 = free or cached);
    - ``refs (n_pages, n_ref_lanes) int32`` — WHICH slots hold the
      page, ``-1`` empty lanes (``n_ref_lanes`` = ``max_slots`` with
      the prefix cache, 1 without — no sharing means one lane
      suffices and the decode sweep pays nothing extra). This is the
      decode sweep's routing table: each page attends one query per
      referencing slot, so a page shared by k live requests serves
      all k in the one pool read;
    - ``page_pos (n_pages,) int32`` — the page's index within its
      holders' sequences (identical for every sharer — shared pages
      are prompt PREFIX pages, which sit at the same table index by
      construction);
    - ``active (max_slots,) bool`` — DECODE-READY slots. A seated slot
      mid-chunked-prefill holds pages and a length but stays inactive
      until :meth:`activate`;
    - ``last_ids (max_slots,) int32`` — each slot's most recent token
      (the decode step's input).

    ``prefix_cache=False`` (the default) degenerates to plain
    alloc/free: nothing is matched or registered, every refcount is 0
    or 1, and retire frees every page — the cold control the parity
    suite measures the cache against.

    ``parallel=True`` keeps the multi-lane ``refs`` table even without
    the prefix cache: :meth:`fork` maps one slot's FULL pages into n
    sibling slots' tables (copy-on-write parallel sampling, OpenAI
    ``n``/``best_of``), so a page needs a lane per potential sharer
    exactly as prefix sharing does.
    """

    def __init__(self, cfg: GPTConfig, page_size: int, n_pages: int,
                 max_slots: int, prefix_cache: bool = False,
                 parallel: bool = False):
        if page_size < 1 or n_pages < 2 or max_slots < 1:
            raise ValueError(
                f"need page_size >= 1, n_pages >= 2 (page 0 is the "
                f"reserved null page) and max_slots >= 1; got "
                f"page_size={page_size}, n_pages={n_pages}, "
                f"max_slots={max_slots}")
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_slots = max_slots
        self.max_pages_per_slot = -(-cfg.seq_len // page_size)
        self.seq_len = cfg.seq_len
        self.prefix_cache = bool(prefix_cache)
        self.parallel = bool(parallel)
        self.tables = np.full((max_slots, self.max_pages_per_slot),
                              NULL_PAGE, np.int32)
        self.lengths = np.zeros(max_slots, np.int32)
        # rewind floors: cow_len is the copy-on-write boundary — the
        # shared/cached prefix pages mapped at seat time (or shared at
        # a fork) end here, so the write cursor (== lengths) must never
        # drop below it; prompt_len is the stricter floor at seat time
        # (registered prefix pages all sit inside the prompt)
        self.cow_len = np.zeros(max_slots, np.int32)
        self.prompt_len = np.zeros(max_slots, np.int32)
        self.refcount = np.zeros(n_pages, np.int32)
        # reference lanes: with the prefix cache (or fork sharing)
        # every slot may share one page, so a page needs max_slots
        # lanes; without either no page ever has more than one holder
        # and the lane axis collapses to 1 — the cold engine's decode
        # sweep then pays ZERO extra query-side compute for the
        # sharing machinery
        share = self.prefix_cache or self.parallel
        self.n_ref_lanes = max_slots if share else 1
        self.refs = np.full((n_pages, self.n_ref_lanes), -1, np.int32)
        self.page_pos = np.zeros(n_pages, np.int32)
        self.active = np.zeros(max_slots, bool)
        self.last_ids = np.zeros(max_slots, np.int32)
        # prefix index: prompt-prefix bytes -> page id (bijective with
        # _page_key); _lru tracks refcount-0 cached pages by last-use
        # tick — retire assigns ticks tail-first so eviction shrinks a
        # cached prefix from its deepest page
        self._index: dict[bytes, int] = {}
        self._page_key: dict[int, bytes] = {}
        self._lru: dict[int, int] = {}
        self._tick = 0
        # LIFO free list: recently-freed pages are re-issued first
        # (their bytes are hottest in cache); page 0 never enters
        self._free = list(range(n_pages - 1, 0, -1))
        # the host spill tier (all optional; None = no tier): host_pool
        # holds demoted pages' payloads, spill_fetch is the ENGINE's
        # demotion callback (page id -> host payload dict — the one
        # deliberate device read of the tier), on_tier_event a
        # directory's feed ((kind, chain-key bytes) on register /
        # demote / promote / evict / host_evict)
        self.host_pool: HostPagePool | None = None
        self.spill_fetch = None
        self.on_tier_event = None

    # ---- queries -------------------------------------------------
    @property
    def n_free_pages(self) -> int:
        return len(self._free)

    @property
    def n_cached_pages(self) -> int:
        """Resident refcount-0 prefix pages (LRU-evictable)."""
        return len(self._lru)

    @property
    def n_available_pages(self) -> int:
        """Free + evictable — the admission capacity check (cached
        prefixes never block an admission; they evict under it)."""
        return len(self._free) + len(self._lru)

    @property
    def n_host_pages(self) -> int:
        """Host-tier resident pages (0 with the spill tier off).
        Deliberately NOT part of :attr:`n_available_pages`: a host
        page occupies no pool id, so it neither consumes nor provides
        admission capacity."""
        return len(self.host_pool) if self.host_pool is not None else 0

    def free_slot(self) -> int | None:
        """Lowest unseated slot id, or None when all are occupied."""
        idle = np.flatnonzero(~self.active & (self.lengths == 0))
        return int(idle[0]) if idle.size else None

    def n_free_slots(self) -> int:
        """How many slots :meth:`free_slot` could hand out — the one
        definition of 'unseated', shared with the batcher's admission
        gate."""
        return int(np.count_nonzero(~self.active & (self.lengths == 0)))

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def slot_pages(self, slot: int) -> np.ndarray:
        """The slot's live page ids, in sequence order."""
        n = self.pages_for(int(self.lengths[slot]))
        return self.tables[slot, :n].copy()

    def match_prefix(self, prompt: np.ndarray) -> int:
        """How many leading full pages of ``prompt`` are resident in the
        prefix index (:meth:`match_pages`'s count, under its cap)."""
        return len(self.match_pages(prompt))

    def match_pages(self, prompt: np.ndarray) -> list[int]:
        """The resident page chain for ``prompt``'s leading full pages,
        capped at ``(len - 1) // page_size`` so the last prompt token
        always recomputes (its logits seed the first sampled token). The walk hashes the prompt
        prefix once per page — callers that need both the capacity
        check and the seating (engine ``admit_begin``) do ONE walk and
        hand the result to :meth:`seat`."""
        if not self.prefix_cache or len(prompt) < 1:
            return []
        prompt = np.ascontiguousarray(prompt, np.int32)
        limit = (len(prompt) - 1) // self.page_size
        pages: list[int] = []
        while len(pages) < limit:
            p = self._index.get(
                prompt[:(len(pages) + 1) * self.page_size].tobytes())
            if p is None:
                break
            pages.append(p)
        return pages

    def match_tiered(self, prompt: np.ndarray
                     ) -> tuple[list[int], list[bytes]]:
        """The two-tier chain walk, ONE lookup per page: the
        HBM-resident prefix (page ids, exactly :meth:`match_pages`)
        followed by its host-resident continuation (chain-key bytes the
        engine promotes). Same ``(len - 1) // page_size`` cap across the
        combined chain. A chain that leaves the host tier and re-enters
        HBM is cut at the host miss — seat maps only a LEADING
        contiguous run, and a mid-chain tier sandwich is a transient
        (the stranded HBM page demotes or evicts on its own)."""
        pages = self.match_pages(prompt)
        if self.host_pool is None or not self.prefix_cache \
                or len(prompt) < 1:
            return pages, []
        prompt = np.ascontiguousarray(prompt, np.int32)
        limit = (len(prompt) - 1) // self.page_size
        keys: list[bytes] = []
        while len(pages) + len(keys) < limit:
            key = prompt[:(len(pages) + len(keys) + 1)
                         * self.page_size].tobytes()
            if key not in self.host_pool:
                break
            keys.append(key)
        return pages, keys

    # ---- mutations -----------------------------------------------
    def seat(self, slot: int, prompt: np.ndarray,
             matched: list[int] | None = None
             ) -> tuple[np.ndarray, int]:
        """Claim ``slot`` for ``prompt``: map the matched cached
        prefix pages into its table (refcount++) and allocate private
        pages for the rest (evicting LRU cached prefixes under
        pressure). ``matched`` short-circuits the index walk with a
        fresh :meth:`match_pages` result (no mutation in between).
        The slot stays INACTIVE (no decode) until :meth:`activate` —
        the engine streams the unmatched prompt in via chunked
        prefill first. Returns ``(page_ids, n_matched)``; raises when
        the slot is busy or pages run out even after eviction (the
        caller checks :attr:`n_available_pages`)."""
        prompt = np.ascontiguousarray(prompt, np.int32).reshape(-1)
        if self.active[slot] or self.lengths[slot]:
            raise ValueError(f"slot {slot} is already occupied")
        if not 0 < len(prompt) < self.seq_len:
            raise ValueError(
                f"prompt length must be in (0, {self.seq_len}), got "
                f"{len(prompt)}")
        n_total = self.pages_for(len(prompt))
        if matched is None:
            matched = self.match_pages(prompt)
        n_matched = len(matched)
        # remember the matched pages' LRU ticks: a failed seat must
        # put them back EXACTLY as found — minting fresh ticks on
        # rollback would promote a chain that keeps failing to seat
        # to most-recently-used, evicting genuinely useful prefixes
        # ahead of it
        old_ticks = {p: self._lru[p] for p in matched if p in self._lru}
        for i, p in enumerate(matched):
            self._ref(slot, i, p)
        try:
            self._alloc(slot, np.arange(n_matched, n_total))
        except RuntimeError:
            for i in reversed(range(n_matched)):
                self._unref(slot, int(self.tables[slot, i]))
            self.tables[slot, :n_matched] = NULL_PAGE
            for p, tick in old_ticks.items():
                if p in self._lru:       # still refcount-0 cached
                    self._lru[p] = tick
            raise
        self.lengths[slot] = len(prompt)
        self.prompt_len[slot] = len(prompt)
        self.cow_len[slot] = n_matched * self.page_size
        self.last_ids[slot] = 0
        return self.tables[slot, :n_total].copy(), n_matched

    def activate(self, slot: int, first_id: int) -> None:
        """Mark a seated slot decode-ready (prefill done); ``first_id``
        seeds its decode input (the prefill's sampled token)."""
        if not self.lengths[slot] or self.active[slot]:
            raise ValueError(
                f"slot {slot} is not seated-and-inactive")
        self.active[slot] = True
        self.last_ids[slot] = first_id

    def fork(self, parent_slot: int, n_children: int) -> list[int]:
        """Fork ``parent_slot`` into ``n_children`` sibling slots for
        copy-on-write parallel sampling: every FULL page of the parent
        maps shared into each child's table (refcount++, a refs lane per
        sharer), and only the partial TAIL page allocates a private page
        per child, since every branch's next writes land there. The
        device copy of the tail is the engine's (``PagedEngine.fork``);
        this is host bookkeeping only.

        The parent's and the children's copy-on-write floors rise to the
        shared-page boundary, so no branch may rewind into a shared
        page. Children come back INACTIVE with the parent's length (the
        caller samples and activates each branch's first token). On
        exhaustion every partially forked child is rolled back and
        :class:`PoolExhausted` propagates."""
        if not self.parallel:
            raise RuntimeError(
                "fork() needs BlockTables(parallel=True): without the "
                "multi-lane refs table a page cannot carry a second "
                "holder")
        if n_children < 1:
            raise ValueError(f"n_children must be >= 1, got {n_children}")
        if not self.active[parent_slot] or not self.lengths[parent_slot]:
            raise ValueError(
                f"slot {parent_slot} is not active — fork at the prefill "
                "boundary, after activate()")
        length = int(self.lengths[parent_slot])
        n_full = length // self.page_size
        n_live = self.pages_for(length)
        parent_row = self.tables[parent_slot]
        children: list[int] = []
        try:
            for _ in range(n_children):
                slot = self.free_slot()
                if slot is None:
                    raise PoolExhausted(
                        f"no free slot to fork into ({self.max_slots} "
                        "slots all seated)")
                mapped = 0
                try:
                    for i in range(n_full):
                        self._ref(slot, i, int(parent_row[i]))
                        mapped += 1
                    if n_live > n_full:
                        self._alloc(slot, np.asarray([n_full]))
                except PoolExhausted:
                    # lengths is not set yet, so retire() would see an
                    # empty slot and leak the refs: unwind by hand
                    for i in reversed(range(mapped)):
                        self._unref(slot, int(self.tables[slot, i]))
                    self.tables[slot, :mapped] = NULL_PAGE
                    raise
                self.lengths[slot] = length
                self.prompt_len[slot] = self.prompt_len[parent_slot]
                self.cow_len[slot] = n_full * self.page_size
                self.last_ids[slot] = 0
                children.append(slot)
        except PoolExhausted:
            for slot in children:
                self.retire(slot)
            raise
        self.cow_len[parent_slot] = max(int(self.cow_len[parent_slot]),
                                        n_full * self.page_size)
        return children

    def register_prefix(self, slot: int, prompt: np.ndarray) -> int:
        """Publish the slot's FULL prompt pages into the prefix index
        (call once prefill has written them — their content is final:
        only the partial tail page ever grows). Returns how many new
        entries landed."""
        if not self.prefix_cache:
            return 0
        prompt = np.ascontiguousarray(prompt, np.int32).reshape(-1)
        n_new = 0
        for i in range(len(prompt) // self.page_size):
            key = prompt[:(i + 1) * self.page_size].tobytes()
            if key in self._index:
                continue                 # first writer wins
            p = int(self.tables[slot, i])
            if p == NULL_PAGE or p in self._page_key:
                continue
            self._index[key] = p
            self._page_key[p] = key
            if self.host_pool is not None:
                # a freshly prefilled copy supersedes a stale host
                # payload (the HBM bytes are exact, the host ones
                # quantized) — one key never lives in both tiers
                self.host_pool.pop(key)
            if self.on_tier_event is not None:
                self.on_tier_event("register", key)
            n_new += 1
        return n_new

    def promote_keys(self, slot: int, keys: list[bytes],
                     start_idx: int) -> None:
        """Publish promoted pages back into the HBM prefix index:
        ``keys[i]`` describes the content the engine's promotion wrote
        into the slot's page at table index ``start_idx + i``. Host
        bookkeeping only; first-writer-wins like
        :meth:`register_prefix`, so a racing cold prefill that
        registered the same chain keeps its entry and the promoted copy
        stays private to its slot."""
        for i, key in enumerate(keys):
            p = int(self.tables[slot, start_idx + i])
            if p == NULL_PAGE or key in self._index \
                    or p in self._page_key:
                continue
            self._index[key] = p
            self._page_key[p] = key
            if self.on_tier_event is not None:
                self.on_tier_event("promote", key)

    def ensure_next_page(self, slot: int) -> bool:
        """Make sure the page that position ``lengths[slot]`` (the next
        write) lands in exists: :meth:`ensure_write_pages` of one
        token."""
        return self.ensure_write_pages(slot, 1)

    def ensure_write_pages(self, slot: int, n_tokens: int = 1) -> bool:
        """Make sure pages exist for the next ``n_tokens`` write
        positions ``[lengths, lengths + n_tokens)`` (clamped to the
        cache horizon); allocates every missing table entry in one
        shot, evicting cached prefix pages under pressure. The
        speculative verify step writes ``1 + draft_len`` positions
        per step, so it needs up to two pages ahead (``draft_len <
        page_size``); positions past a rejected draft keep their
        pages — always PRIVATE ones (the write cursor sits past the
        copy-on-write boundary), overwritten by the next step's
        writes before any visibility mask can reach them. Returns
        False when the pool is truly exhausted (the batcher then
        preempts) — the slot is untouched (:meth:`_alloc` checks
        capacity before evicting anything)."""
        length = int(self.lengths[slot])
        last = min(length + n_tokens, self.seq_len) - 1
        if last < length:
            return True
        idx = [i for i in range(length // self.page_size,
                                last // self.page_size + 1)
               if self.tables[slot, i] == NULL_PAGE]
        if not idx:
            return True
        try:
            self._alloc(slot, np.asarray(idx))
        except RuntimeError:
            return False
        return True

    def rewind(self, slot: int, new_length: int,
               last_id: int | None = None) -> None:
        """Reset the slot's length to drop speculatively written
        positions. ``PagedEngine.spec_step`` never needs it (it only
        advances over accepted tokens, so rejected K/V is born past
        ``lengths``), but any caller that must shrink a slot goes
        through here, so the floors are enforced in one place. Pages
        past ``new_length`` stay allocated: private write-ahead pages,
        never registered. The floor is ``max(prompt_len, cow_len)``:
        below it registered prompt pages or shared pages would be
        reopened to writes. A rewind that drops positions must pass
        ``last_id``, the accepted pending token at ``new_length``, or
        the next step would decode from a rejected token."""
        if not self.lengths[slot]:
            raise ValueError(f"slot {slot} is not seated")
        floor = max(int(self.prompt_len[slot]), int(self.cow_len[slot]))
        if not floor <= new_length <= int(self.lengths[slot]):
            raise ValueError(
                f"rewind target {new_length} outside [prompt_len="
                f"{floor}, lengths={int(self.lengths[slot])}] for slot "
                f"{slot} — a rewind below the prompt (and the "
                f"copy-on-write boundary at {int(self.cow_len[slot])}) "
                "would expose registered/shared prefix pages to decode "
                "writes")
        if new_length < int(self.lengths[slot]):
            if last_id is None:
                raise ValueError(
                    f"rewinding slot {slot} drops the token last_ids "
                    "points at; pass last_id (the accepted pending token "
                    f"at position {new_length})")
            self.last_ids[slot] = last_id
        self.lengths[slot] = new_length

    def advance(self, slot: int, token_id: int) -> None:
        """Record one decoded token (already written on device at
        position ``lengths[slot]`` by the step that produced it)."""
        self.lengths[slot] += 1
        self.last_ids[slot] = token_id

    def retire(self, slot: int) -> None:
        """Release the slot: every page's refcount drops by one; pages
        that hit zero either stay RESIDENT as cached prefixes (if
        registered) or return to the free list. Iterates the table
        tail-first so a cached prefix's deepest pages get the OLDEST
        LRU ticks and evict first — the chain shrinks from its tail,
        never breaking the match walk mid-prefix."""
        if not self.active[slot] and not self.lengths[slot]:
            return
        for p in self.tables[slot][::-1]:
            if p != NULL_PAGE:
                self._unref(slot, int(p))
        self.tables[slot] = NULL_PAGE
        self.lengths[slot] = 0
        self.cow_len[slot] = 0
        self.prompt_len[slot] = 0
        self.active[slot] = False
        self.last_ids[slot] = 0

    # ---- internals -----------------------------------------------
    def _ref(self, slot: int, idx: int, p: int) -> None:
        """Map an existing (cached or live-shared) page into a slot's
        table at index ``idx``."""
        assert self.page_pos[p] == idx, (
            f"prefix page {p} sits at position {self.page_pos[p]}, "
            f"matched at table index {idx}")
        if self.refcount[p] == 0:
            self._lru.pop(p, None)           # cached -> referenced
        lane = int(np.flatnonzero(self.refs[p] == -1)[0])
        self.refs[p, lane] = slot
        self.refcount[p] += 1
        self.tables[slot, idx] = p

    def _unref(self, slot: int, p: int) -> None:
        self.refcount[p] -= 1
        assert self.refcount[p] >= 0, f"page {p} refcount went negative"
        self.refs[p][self.refs[p] == slot] = -1
        if self.refcount[p] == 0:
            if p in self._page_key:          # registered prefix: cache
                self._tick += 1
                self._lru[p] = self._tick
            else:
                self.page_pos[p] = 0
                self._free.append(int(p))

    def _evict(self, n: int) -> int:
        """Reclaim up to ``n`` LRU cached prefix pages into the free
        list (dropping their index entries); returns how many. With the
        spill tier attached the reclaim is a DEMOTION: the page's K/V go
        to the host pool (``spill_fetch``, the engine's quantize-and-copy
        callback) under the same chain key before the pool slot frees,
        so a later request promotes instead of recomputing. The pool
        partition is unchanged either way."""
        got = 0
        while got < n and self._lru:
            p = min(self._lru, key=self._lru.get)
            del self._lru[p]
            key = self._page_key.pop(p)
            del self._index[key]
            if self.host_pool is not None and self.spill_fetch is not None:
                payload = self.spill_fetch(p)
                if payload is not None:
                    dropped = self.host_pool.put(key, payload)
                    if self.on_tier_event is not None:
                        self.on_tier_event("demote", key)
                        for k in dropped:
                            self.on_tier_event("host_evict", k)
                elif self.on_tier_event is not None:
                    self.on_tier_event("evict", key)
            elif self.on_tier_event is not None:
                self.on_tier_event("evict", key)
            self.page_pos[p] = 0
            self._free.append(int(p))
            got += 1
        return got

    def _alloc(self, slot: int, table_idx: np.ndarray) -> np.ndarray:
        if len(table_idx) > len(self._free) + len(self._lru):
            # raise BEFORE evicting: a doomed allocation must not
            # drain unrelated cached prefixes (dropping their index
            # entries for nothing) on its way to failing anyway
            raise PoolExhausted(
                f"KV page pool exhausted: need {len(table_idx)} pages, "
                f"{len(self._free)} free + {len(self._lru)} evictable "
                f"(n_pages={self.n_pages}, page_size={self.page_size})"
                "; size serving.n_pages to the worst-case live-token "
                "total or lower max_slots")
        short = len(table_idx) - len(self._free)
        if short > 0:
            self._evict(short)
        ids = np.array([self._free.pop() for _ in table_idx], np.int32)
        self.tables[slot, table_idx] = ids
        self.refcount[ids] = 1
        self.refs[ids, :] = -1
        self.refs[ids, 0] = slot
        # a page's position within its holders' sequences IS its table
        # index — the sweep reconstructs absolute token positions from it
        self.page_pos[ids] = np.asarray(table_idx, np.int32)
        return ids

    # ---- device view ---------------------------------------------
    def device_args(self) -> dict:
        """The decode step's table operands: numpy SNAPSHOTS (copies —
        the engine hands them to the device while the tables keep
        changing). Fixed shapes by construction — only values change
        across seat/retire/evict, so the step's operand shapes are
        occupancy-independent."""
        return {
            "tables": self.tables.copy(),
            "lengths": self.lengths.copy(),
            "refs": self.refs.copy(),
            "page_pos": self.page_pos.copy(),
            "active": self.active.copy(),
            "last_ids": self.last_ids.copy(),
        }

    def kernel_args(self) -> dict:
        """The paged decode kernel's COMPACTED live-page walk
        (ops/paged_attention.py): fixed ``n_pages - 1`` entries —
        every referenced page once (ascending pool order), then
        padding pinned to the reserved null page with empty lanes.
        The kernel's grid walks this list, one CTA per entry and kv
        head, and skips the all-empty padding tail, so memory reads
        track the LIVE entries. Shapes are geometry-only (values change
        under churn). Cached refcount-0 prefix pages are deliberately
        absent: no live slot references them, so the kernel never pays
        for residency — the cost the pool sweep cannot avoid."""
        n_w = self.n_pages - 1
        live = np.flatnonzero(self.refcount[1:] > 0) + 1
        work_pages = np.zeros(n_w, np.int32)
        work_refs = np.full((n_w, self.n_ref_lanes), -1, np.int32)
        work_pos = np.zeros(n_w, np.int32)
        n = len(live)
        work_pages[:n] = live
        work_refs[:n] = self.refs[live]
        work_pos[:n] = self.page_pos[live]
        return {
            "work_pages": work_pages,
            "work_refs": work_refs,
            "work_pos": work_pos,
        }

    @property
    def n_live_pages(self) -> int:
        """Referenced (refcount > 0) pages — the kernel walk's real
        per-step page reads (the live-bytes term of its bound)."""
        return int(np.count_nonzero(self.refcount[1:] > 0))

    # ---- invariants (tests) --------------------------------------
    def check(self) -> None:
        """Structural invariants, asserted by the churn tests: page 0
        never allocated; referenced ∪ cached ∪ free = pool exactly
        once; refcounts equal the table references (never negative);
        refs lanes agree with the tables; page_pos agrees with every
        holder; the prefix index is a bijection and cached pages all
        carry keys."""
        free = set(self._free)
        cached = set(self._lru)
        assert NULL_PAGE not in free, "null page entered the free list"
        assert NULL_PAGE not in cached, "null page entered the cache"
        assert self.refcount[NULL_PAGE] == 0, "null page got referenced"
        assert len(free) == len(self._free), "free list holds duplicates"
        assert free.isdisjoint(cached)
        want = np.zeros(self.n_pages, np.int64)
        for slot in range(self.max_slots):
            n_live = self.pages_for(int(self.lengths[slot]))
            seen = set()
            for idx, p in enumerate(self.tables[slot]):
                p = int(p)
                if idx < n_live:
                    assert p != NULL_PAGE, (
                        f"slot {slot} live page {idx} unassigned")
                if p == NULL_PAGE:
                    continue
                assert p not in seen, f"slot {slot} holds page {p} twice"
                seen.add(p)
                want[p] += 1
                assert self.page_pos[p] == idx, (slot, idx, p)
                assert slot in set(self.refs[p].tolist()), (slot, p)
                if self.refcount[p] > 1:
                    # shared pages (prefix hits and fork sharing) must
                    # sit entirely BELOW every holder's write floor —
                    # max(cow_len, prompt_len), the floor rewind
                    # enforces — so the write cursor (== lengths, never
                    # below that floor) can never touch one: a CoW tail
                    # page is never shared. Prefix-shared full PROMPT
                    # pages are covered by prompt_len; fork-shared pages
                    # past the prompt by the raised cow_len.
                    assert (idx + 1) * self.page_size <= max(
                        int(self.cow_len[slot]),
                        int(self.prompt_len[slot])), (
                        f"page {p} shared at slot {slot} index {idx} "
                        f"above the write floor (cow_len="
                        f"{int(self.cow_len[slot])}, prompt_len="
                        f"{int(self.prompt_len[slot])})")
                if idx >= n_live:
                    # write-ahead pages past the length: PRIVATE
                    # (a shared page past the live range would serve
                    # poisoned K/V to its sharers) and never reachable
                    # through the prefix index (a cached/registered
                    # page there would replay unwritten K/V into a
                    # later request's context)
                    assert self.refcount[p] == 1, (
                        f"page {p} shared past slot {slot}'s length")
                    assert p not in self._page_key, (
                        f"registered prefix page {p} reachable past "
                        f"slot {slot}'s length")
            if self.lengths[slot]:
                # the rewind floors: the write cursor (== lengths)
                # never re-enters the shared/cached prefix region, nor
                # the registered prompt pages
                assert self.lengths[slot] >= self.cow_len[slot], (
                    f"slot {slot} length {int(self.lengths[slot])} "
                    f"below the copy-on-write boundary "
                    f"{int(self.cow_len[slot])}")
                assert self.lengths[slot] >= self.prompt_len[slot], (
                    f"slot {slot} rewound below its prompt")
            else:
                assert not self.active[slot]
                assert (self.tables[slot] == NULL_PAGE).all()
                assert self.cow_len[slot] == 0
                assert self.prompt_len[slot] == 0
        assert (want == self.refcount).all(), "refcount drift vs tables"
        assert (self.refcount >= 0).all(), "negative refcount"
        for p in range(self.n_pages):
            lanes = [int(s) for s in self.refs[p] if s >= 0]
            assert len(lanes) == self.refcount[p], (p, lanes)
            assert len(set(lanes)) == len(lanes), f"page {p} lane dup"
        referenced = set(np.flatnonzero(self.refcount > 0).tolist())
        assert free.isdisjoint(referenced)
        assert cached.isdisjoint(referenced)
        assert len(free) + len(cached) + len(referenced) \
            == self.n_pages - 1, "pages leaked: partition != pool"
        assert len(self._index) == len(self._page_key)
        for key, p in self._index.items():
            assert self._page_key.get(p) == key, "index/page_key drift"
        for p in cached:
            assert p in self._page_key and self.refcount[p] == 0
        if self.host_pool is not None:
            # the spill tier's side of the partition: host pages occupy
            # NO pool id, are never refcounted, and one chain key never
            # lives in both tiers
            self.host_pool.check()
            for key in self.host_pool.keys():
                assert key not in self._index, (
                    "chain key resident in both tiers")
                assert len(key) % (4 * self.page_size) == 0, (
                    "host pool key is not page-aligned int32 bytes")


__all__ = ["BlockTables", "HostPagePool", "NULL_PAGE", "PoolExhausted",
           "make_pool"]
