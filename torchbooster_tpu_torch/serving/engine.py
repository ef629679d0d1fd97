"""Continuous-batching decode engine over the paged, prefix-shared KV
cache — the port of ``torchbooster_tpu/serving/engine.py``.

- **prefill** streams a prompt in fixed-size page-aligned CHUNKS
  (``prefill_chunk_pages`` pages each, one per batcher iteration): each
  chunk runs the shared block math (``models/gpt.py _block_core``),
  writes its K/V into the pages the block table assigned, and attends
  its prior context by gathering the slot's own pages back out of the
  pool — two flash partials (prior pages in pool dtype, the chunk's own
  causal part in compute dtype) merged with the online-softmax combine.
- **decode** is ONE step over all ``max_slots`` slots: embed each
  slot's last token at its own depth, write this step's K/V into the
  slot's current (always private) page BEFORE the read, then attend.
  The read is the paged flash-decode kernel (``ops/paged_attention.py``
  — the CUDA kernel on the card, its plain version on the CPU) walking
  the compacted live-page list, or the pool sweep (every usable page
  against the queries of every slot referencing it, merged per slot),
  the JAX package's ``"xla"`` backend and the plain version of the
  whole step. ``decode_backend=None`` picks the kernel on CUDA and the
  sweep on the CPU.

PyTorch runs eagerly, so the JAX package's one-compile contract
becomes a fixed operand-shape contract: the decode step's operand
shapes depend only on pool geometry, and ``decode_compiles`` counts
the DISTINCT shape signatures the step has seen (it must stay 1 —
what a CUDA-graph capture of the step will need). The pool is updated
in place.
"""
from __future__ import annotations

import numpy as np
import torch

from torchbooster_tpu_torch._device import resolve_device
from torchbooster_tpu_torch.models import layers as L
from torchbooster_tpu_torch.models.gpt import (
    GPTConfig,
    _block_core,
    _check_pos,
    _grouped_cache_attention,
    _lm_head,
    _make_pick,
    _quantize_kv,
    cast_params,
    layer_params,
    map_tensors,
)
from torchbooster_tpu_torch.ops.paged_attention import paged_attention
from torchbooster_tpu_torch.serving.kv_pages import (
    NULL_PAGE,
    BlockTables,
    make_pool,
)

# options of the JAX engine this slice does not port, and the
# ROADMAP.md item that will
_UNPORTED = {
    "speculative": "A5 speculative verify through B4",
    "parallel_sampling": "A6 copy-on-write fork",
    "spec_tree": "A5 tree verify through B4",
    "structured": "A6 structured generation",
    "lora_rank": "A6 LoRA lanes",
    "lora_max_live": "A6 LoRA lanes",
    "host_spill": "A6 host spill tier",
    "prefill_only": "A7 disaggregated serving",
}


def _layer_pool(pool, i: int):
    return (pool[0][i], pool[1][i]) if isinstance(pool, tuple) else pool[i]


class PagedEngine:
    """Continuous-batching decode over a paged KV pool with an optional
    prompt-prefix cache. ``admit_begin``/``prefill_step``/``step``/
    ``retire`` are the lifecycle the batcher drives; ``admit`` seats
    one request and drains its chunks. ``cache_dtype="int8"`` stores
    quantized pages; ``temperature=0`` decodes greedily, otherwise
    sampling draws from a ``torch.Generator`` seeded with ``seed``.
    ``dense_control`` builds the dense-bytes A/B geometry (one
    ``seq_len`` page per slot; the sweep backend only — such a page is
    too large for the kernel's shared-memory tile)."""

    def __init__(self, params: dict, cfg: GPTConfig, *,
                 page_size: int = 64, n_pages: int = 128,
                 max_slots: int = 8, cache_dtype: str | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None, seed: int = 0,
                 prefix_cache: bool = False, prefill_chunk_pages: int = 4,
                 decode_backend: str | None = None, tp: int = 1,
                 device: str | torch.device = "cuda", **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"PagedEngine got an unexpected option "
                                f"{name!r}")
            if value:
                raise NotImplementedError(
                    f"{name} is not ported yet (ROADMAP.md "
                    f"{_UNPORTED[name]})")
        if tp != 1:
            raise NotImplementedError(
                "tensor-parallel serving (tp > 1) is not ported yet "
                "(ROADMAP.md A8 serving/tp.py)")
        if cfg.seq_len % page_size:
            raise ValueError(f"page_size ({page_size}) must divide "
                             f"cfg.seq_len ({cfg.seq_len})")
        if prefill_chunk_pages < 1:
            raise ValueError(f"prefill_chunk_pages must be >= 1, got "
                             f"{prefill_chunk_pages}")
        if cache_dtype not in (None, "int8"):
            raise ValueError(f"cache_dtype must be None or 'int8', got "
                             f"{cache_dtype!r}")
        self.device = resolve_device(device)
        if decode_backend is None:
            decode_backend = "kernel" if self.device.type == "cuda" \
                else "sweep"
        if decode_backend not in ("kernel", "sweep"):
            raise ValueError(f"decode_backend must be 'kernel' (the paged "
                             f"flash-decode kernel) or 'sweep' (the pool "
                             f"sweep), got {decode_backend!r}")
        _check_pos(params, cfg)
        self.decode_backend = decode_backend
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_slots = max_slots
        self.compute_dtype = compute_dtype
        self.quantized = cache_dtype == "int8"
        self.prefix_cache = bool(prefix_cache)
        self.params = cast_params(
            map_tensors(params, lambda t: t.to(self.device)), compute_dtype)
        self._layers = [layer_params(self.params["blocks"], i)
                        for i in range(cfg.n_layers)]
        self.tables = BlockTables(cfg, page_size, n_pages, max_slots,
                                  prefix_cache=prefix_cache)
        self.prefill_chunk_pages = min(prefill_chunk_pages,
                                       self.tables.max_pages_per_slot)
        self.chunk_tokens = self.prefill_chunk_pages * page_size
        self.pool = make_pool(cfg, page_size, n_pages,
                              cache_dtype=cache_dtype,
                              compute_dtype=compute_dtype,
                              device=self.device)
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self._pick = _make_pick(temperature, top_k, top_p)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._pending: list[dict] = []
        self.prefill_chunks = 0
        self.prefix_hit_pages = 0
        self.prefix_lookup_pages = 0
        self._decode_shapes: set = set()
        self._chunk_shapes: set = set()

    @classmethod
    def dense_control(cls, params: dict, cfg: GPTConfig, *,
                      max_slots: int = 8, **kw) -> "PagedEngine":
        """The dense-bytes A/B control: one ``seq_len``-wide page per
        slot (+ the null page), read by the pool sweep."""
        kw.setdefault("decode_backend", "sweep")
        return cls(params, cfg, page_size=cfg.seq_len,
                   n_pages=max_slots + 1, max_slots=max_slots, **kw)

    # ---- the step math --------------------------------------------
    def _embed(self, ids: torch.Tensor, positions: torch.Tensor):
        x = L.embedding(self.params["wte"], ids, dtype=self.compute_dtype)
        if "wpe" in self.params:
            x = x + L.embedding(self.params["wpe"], positions,
                                dtype=self.compute_dtype)
        return x

    @torch.no_grad()
    def _chunk_fn(self, ids: torch.Tensor, start: int, s0: int,
                  table_row: torch.Tensor) -> torch.Tensor:
        """ONE prefill chunk: forward ``ids`` (1, C) at positions
        ``start + [0, C)``, writing each layer's K/V into the slot's
        pages and attending prior context through the pool. Pad tokens
        of the final chunk write at positions >= ``s0`` (or into the
        null page past the table), which every mask excludes. Returns
        the token picked from position ``s0 - 1`` (meaningful only on
        the chunk that holds it)."""
        cfg, ps, dev = self.cfg, self.page_size, self.device
        C = ids.shape[1]
        n_cp = C // ps
        mp = table_row.shape[0]
        positions = start + torch.arange(C, device=dev)
        x = self._embed(ids, positions[None])
        pidx = start // ps + torch.arange(n_cp, device=dev)
        w_pages = torch.where(pidx < mp, table_row[pidx.clamp(max=mp - 1)],
                              torch.full_like(pidx, NULL_PAGE))
        tok_abs = torch.arange(mp * ps, device=dev)
        vis_prior = (tok_abs < start)[None, None, None, None, :]
        local = torch.arange(C, device=dev)
        vis_chunk = (local[:, None] >= local[None, :])[None, None, None]
        head_dim = cfg.head_dim

        for i, bp in enumerate(self._layers):
            pk = _layer_pool(self.pool["k"], i)
            pv = _layer_pool(self.pool["v"], i)

            def attend(q, k, v, pk=pk, pv=pv):
                g = k.shape[2]
                # prior context: the slot's pages gathered BEFORE this
                # chunk's write (masked to < start either way)
                if self.quantized:
                    gk = tuple(a[table_row].reshape(1, mp * ps, g, -1)
                               for a in pk)
                    gv = tuple(a[table_row].reshape(1, mp * ps, g, -1)
                               for a in pv)
                else:
                    gk = pk[table_row].reshape(1, mp * ps, g, head_dim)
                    gv = pv[table_row].reshape(1, mp * ps, g, head_dim)
                oA, mA, lA = _grouped_cache_attention(q, gk, gv, vis_prior,
                                                      state=True)
                oB, mB, lB = _grouped_cache_attention(q, k, v, vis_chunk,
                                                      state=True)
                kp = k[0].reshape(n_cp, ps, g, head_dim)
                vp = v[0].reshape(n_cp, ps, g, head_dim)
                if self.quantized:
                    for pool, new in ((pk, kp), (pv, vp)):
                        vals, scales = _quantize_kv(new)
                        pool[0][w_pages] = vals
                        pool[1][w_pages] = scales
                else:
                    pk[w_pages] = kp.to(pk.dtype)
                    pv[w_pages] = vp.to(pv.dtype)
                m = torch.maximum(mA, mB)
                wA, wB = torch.exp(mA - m), torch.exp(mB - m)
                l = (lA * wA + lB * wB).clamp_min(1e-30)
                mv = lambda t: t.movedim(-1, 1)[..., None]
                o = (oA * mv(wA) + oB * mv(wB)) / mv(l)
                return o.reshape(1, C, cfg.n_heads, head_dim).to(q.dtype), None

            x, _ = _block_core(bp, x, cfg, attend, positions=positions[None])
        last = x[:, min(max(s0 - 1 - start, 0), C - 1)][:, None]
        logits = _lm_head(self.params, last)[:, 0]
        return self._pick(self._gen, logits)

    @torch.no_grad()
    def _decode_fn(self, tables, lengths, refs, page_pos, active, last_ids,
                   work=None) -> torch.Tensor:
        """One decode step over all slots; returns (max_slots,) ids
        (garbage at inactive slots). ``work`` = the kernel backend's
        ``(work_pages, work_refs, work_pos)``."""
        cfg, ps, dev = self.cfg, self.page_size, self.device
        n_slots = last_ids.shape[0]
        x = self._embed(last_ids[:, None], lengths[:, None])
        if self.decode_backend == "sweep":
            # page -> lane bookkeeping shared by every layer: a page's
            # token j sits at page_pos*ps + j and is visible to a lane
            # iff <= that slot's length; empty lanes divert to the trash
            # segment n_slots; page 0 (the null page) is never read
            refs_t = refs[1:]
            n_lanes = refs_t.shape[1]
            seg = torch.where(refs_t >= 0, refs_t,
                              torch.full_like(refs_t, n_slots)).reshape(-1)
            ref_c = refs_t.clamp(0, n_slots - 1)
            tok_pos = page_pos[1:, None] * ps + torch.arange(ps, device=dev)
            ref_len = torch.where(refs_t >= 0, lengths[ref_c],
                                  torch.full_like(refs_t, -1))
            visible = tok_pos[:, None, :] <= ref_len[:, :, None]
        # this step's write target per slot: the (always private) page
        # holding position ``lengths``; dead slots scribble the null page
        arange = torch.arange(n_slots, device=dev)
        w_page = torch.where(active, tables[arange, lengths // ps],
                             torch.zeros_like(lengths))
        w_off = lengths % ps
        len32 = lengths.to(torch.int32)

        for i, bp in enumerate(self._layers):
            pk = _layer_pool(self.pool["k"], i)
            pv = _layer_pool(self.pool["v"], i)

            def attend(q, k, v, pk=pk, pv=pv):
                # this step's K/V land in the pool BEFORE the read: the
                # token written at ``lengths`` must see itself
                if self.quantized:
                    for pool, new in ((pk, k), (pv, v)):
                        vals, scales = _quantize_kv(new)
                        pool[0][w_page, w_off] = vals[:, 0]
                        pool[1][w_page, w_off] = scales[:, 0]
                else:
                    pk[w_page, w_off] = k[:, 0].to(pk.dtype)
                    pv[w_page, w_off] = v[:, 0].to(pv.dtype)
                if self.decode_backend == "kernel":
                    o = paged_attention(q, pk, pv, *work, len32,
                                        page_size=ps)
                    return o.to(q.dtype), None
                rk = tuple(a[1:] for a in pk) if self.quantized else pk[1:]
                rv = tuple(a[1:] for a in pv) if self.quantized else pv[1:]
                q_lanes = q[:, 0][ref_c]                 # (P, R, H, Dh)
                o_p, m_p, l_p = _grouped_cache_attention(
                    q_lanes, rk, rv, visible[:, None, None], state=True)
                n_pp = o_p.shape[0]
                o_f = o_p.reshape(n_pp * n_lanes, *o_p.shape[2:])
                m_f = m_p.movedim(-1, 1).reshape(n_pp * n_lanes,
                                                 *m_p.shape[1:3])
                l_f = l_p.movedim(-1, 1).reshape(n_pp * n_lanes,
                                                 *l_p.shape[1:3])
                m_s = torch.full((n_slots + 1, *m_f.shape[1:]),
                                 -float("inf"), device=dev)
                m_s = m_s.scatter_reduce(
                    0, seg.view(-1, 1, 1).expand_as(m_f), m_f,
                    reduce="amax")
                w = torch.exp(m_f - m_s[seg])
                l_s = torch.zeros_like(m_s).index_add(0, seg, l_f * w)
                o_s = torch.zeros((n_slots + 1, *o_f.shape[1:]),
                                  device=dev).index_add(0, seg,
                                                        o_f * w[..., None])
                o = o_s[:n_slots] / l_s[:n_slots].clamp_min(1e-30)[..., None]
                return o.reshape(n_slots, 1, cfg.n_heads,
                                 cfg.head_dim).to(q.dtype), None

            x, _ = _block_core(bp, x, cfg, attend, positions=lengths[:, None])
        logits = _lm_head(self.params, x)[:, 0]
        return self._pick(self._gen, logits)

    # ---- lifecycle --------------------------------------------------
    def admit_begin(self, prompt_ids: np.ndarray) -> int | None:
        """Seat one request: map cached prefix pages into its block
        table, allocate private pages for the rest, and queue its
        chunked prefill. Returns the slot, or None when no slot or not
        enough pages (the batcher keeps it queued)."""
        prompt = np.ascontiguousarray(prompt_ids, np.int32).reshape(-1)
        s0 = len(prompt)
        slot = self.tables.free_slot()
        if slot is None or not 0 < s0 < self.cfg.seq_len:
            return None
        # hopeless-case bail before the (quadratic) prefix walk: even a
        # full hit leaves the last page to allocate
        if self.tables.pages_for(s0) - (s0 - 1) // self.page_size \
                > self.tables.n_available_pages:
            return None
        matched = self.tables.match_pages(prompt)
        if self.tables.pages_for(s0) - len(matched) \
                > self.tables.n_available_pages:
            return None
        try:
            self.tables.seat(slot, prompt, matched=matched)
        except RuntimeError:
            # mapping the matched pages made them un-evictable and the
            # private tail came up short: seat() rolled back, stay queued
            return None
        self.prefix_lookup_pages += (s0 - 1) // self.page_size
        self.prefix_hit_pages += len(matched)
        start = len(matched) * self.page_size
        n_chunks = -(-(s0 - start) // self.chunk_tokens)
        padded = np.zeros(start + n_chunks * self.chunk_tokens, np.int32)
        padded[:s0] = prompt
        self._pending.append({"slot": slot, "ids": padded, "s0": s0,
                              "start": start})
        return slot

    @property
    def has_pending(self) -> bool:
        return bool(self._pending)

    @property
    def pending_chunk_count(self) -> int:
        return sum(-(-(p["s0"] - p["start"]) // self.chunk_tokens)
                   for p in self._pending)

    @property
    def pending_slots(self) -> list[int]:
        return [p["slot"] for p in self._pending]

    def prefill_step(self) -> tuple[int, int] | None:
        """Run ONE chunk of the oldest queued prefill. Returns ``(slot,
        first_token)`` when that request's prefill completed (the slot
        is then active and its full prompt pages registered), else
        None."""
        if not self._pending:
            return None
        p = self._pending[0]
        C = self.chunk_tokens
        ids = torch.as_tensor(p["ids"][p["start"]:p["start"] + C],
                              dtype=torch.long).to(self.device)[None]
        table_row = torch.as_tensor(self.tables.tables[p["slot"]],
                                    dtype=torch.long).to(self.device)
        self._chunk_shapes.add((tuple(ids.shape), tuple(table_row.shape)))
        with torch.profiler.record_function("serving_prefill_chunk"):
            tok = self._chunk_fn(ids, p["start"], p["s0"], table_row)
        self.prefill_chunks += 1
        p["start"] += C
        if p["start"] < p["s0"]:
            return None
        self._pending.pop(0)
        first = int(tok[0])
        self.tables.activate(p["slot"], first)
        self.tables.register_prefix(p["slot"], p["ids"][:p["s0"]])
        return p["slot"], first

    def admit(self, prompt_ids: np.ndarray) -> tuple[int, int] | None:
        """Seat one request and drain prefill chunks until ITS first
        token lands; returns ``(slot, first_token)`` or None."""
        slot = self.admit_begin(prompt_ids)
        if slot is None:
            return None
        while True:
            done = self.prefill_step()
            if done is not None and done[0] == slot:
                return done

    def grow_slots(self) -> list[int]:
        """Pre-allocate each active slot's next write page (evicting
        cached prefixes under pressure). Returns the slots that could
        NOT get one (the batcher preempts). Call before every step."""
        return [int(slot) for slot in np.flatnonzero(self.tables.active)
                if not self.tables.ensure_write_pages(int(slot), 1)]

    def _kernel_operands(self) -> tuple | None:
        """The kernel backend's compacted live-page walk on the device;
        None on the sweep."""
        if self.decode_backend != "kernel":
            return None
        ka = self.tables.kernel_args()
        return tuple(torch.as_tensor(ka[k]).to(self.device)
                     for k in ("work_pages", "work_refs", "work_pos"))

    def step(self) -> np.ndarray:
        """One decode step over every ACTIVE slot; advances lengths/
        last_ids for those and returns the (max_slots,) token ids
        (garbage at inactive or mid-prefill slots)."""
        active = self.tables.active.copy()
        if active.any() and (self.tables.lengths[active]
                             >= self.cfg.seq_len).any():
            raise RuntimeError("a slot reached cfg.seq_len; the batcher "
                               "must retire sequences at the horizon")
        args = {k: torch.as_tensor(v).to(self.device)
                for k, v in self.tables.device_args().items()}
        args = {k: v.long() if v.dtype == torch.int32 else v
                for k, v in args.items()}
        work = self._kernel_operands()
        self._decode_shapes.add(tuple(
            (k, tuple(v.shape), str(v.dtype)) for k, v in args.items())
            + tuple(tuple(w.shape) for w in (work or ())))
        with torch.profiler.record_function("decode_step"):
            tokens = self._decode_fn(args["tables"], args["lengths"],
                                     args["refs"], args["page_pos"],
                                     args["active"], args["last_ids"],
                                     work)
        tokens = tokens.cpu().numpy()
        for slot in np.flatnonzero(active):
            self.tables.advance(int(slot), int(tokens[slot]))
        return tokens

    def retire(self, slot: int) -> None:
        """Release the slot (cancelling any in-flight prefill); shared
        prefix pages stay resident for later hits."""
        self._pending = [p for p in self._pending if p["slot"] != slot]
        self.tables.retire(slot)

    @property
    def decode_compiles(self) -> int:
        """Distinct decode-step operand-shape signatures seen — the
        fixed-shape contract's observable (stays 1 across churn)."""
        return len(self._decode_shapes)

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill-chunk shape signatures (stays 1)."""
        return len(self._chunk_shapes)


__all__ = ["PagedEngine"]
