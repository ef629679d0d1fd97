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
- **speculative decoding** (``speculative=True``, ``serving/
  speculative.py``) replaces the decode step with a verify step over
  ``1 + draft_len`` positions a slot, the decode step's forward with
  S query rows (``spec_tree=True`` verifies a tree of drafts through
  an ancestor mask, then compacts the accepted path's K/V).
- **parallel sampling** (``parallel_sampling=True``) forks a prefilled
  slot into n copy-on-write branches (:meth:`fork`), each sampling from
  its own counter-based stream (``models/gpt.py`` ``branch_generator``).
- **structured generation** (``structured=True``, ``serving/
  structured/``) keeps one token-DFA cursor a constrained slot and masks
  every pick (prefill's first token, decode, each verify position) with
  the fused ``(max_slots, vocab)`` legality mask, uploaded each step into
  one preallocated device buffer.
- **LoRA lanes** (``lora_rank``/``lora_max_live``, ``serving/
  adapters.py``) stack ``lora_max_live`` adapters beside the zero
  adapter on a device lane axis; each slot's lane id rides every step in
  a preallocated device buffer and ``_block_core`` adds the slot's ranked
  deltas. Quantized weights (``models/quant.py``) need nothing here: the
  block math dispatches on the tree.
- **the host spill tier** (``host_spill=True``, needs ``prefix_cache``)
  turns LRU eviction of registered prefix pages into DEMOTION to a
  host pool (int8 + fp32 scales, :meth:`_spill_fetch`); a later seat
  that matches the chain there PROMOTES the pages back through one
  fixed-shape write a group of ``prefill_chunk_pages`` pages
  (:meth:`issue_promotions`) instead of recomputing their prefill.
- **prefill-only** (``prefill_only=True``) is the prefill side of
  disaggregated serving (``serving/disagg.py``): it admits and prefills,
  hands its finished pages out through :meth:`export_pages`, and refuses
  to decode.

PyTorch runs eagerly, so the JAX package's one-compile contract
becomes a fixed operand-shape contract: the decode and verify steps'
operand shapes depend only on pool geometry (and ``draft_len``), and
``decode_compiles``/``verify_compiles`` count the DISTINCT shape
signatures each step has seen (each must stay 1 — what a CUDA-graph
capture of the step will need; ``promote_compiles`` likewise counts the
promotion write's). The pool, the legality masks, the lane ids and the
promotion staging are updated in place.
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
    _make_branch_pick,
    _make_pick,
    _mask_logits,
    _quantize_kv,
    branch_generator,
    cast_params,
    layer_params,
    map_tensors,
)
from torchbooster_tpu_torch.ops.paged_attention import (
    check_paged,
    paged_attention,
)
from torchbooster_tpu_torch.serving.adapters import AdapterRegistry
from torchbooster_tpu_torch.models.quant import (
    weight_stream_bytes,
    weights_dtype,
)
from torchbooster_tpu_torch.serving.kv_pages import (
    NULL_PAGE,
    BlockTables,
    HostPagePool,
    make_pool,
)
from torchbooster_tpu_torch.serving.speculative import (
    NO_DRAFT,
    PromptLookupDrafter,
    TreeLookupDrafter,
    accept_count,
    make_verify_fn,
    tree_accept_path,
    tree_masks,
)
from torchbooster_tpu_torch.serving.structured import (
    SlotCursors,
    bytes_vocab,
    compile_response_format,
)

# the demotion payload, one page across every layer: what the host pool
# stores, the promotion stages and the page stream frames
_PAGE_DTYPES = {"k": np.int8, "k_scale": np.float32,
                "v": np.int8, "v_scale": np.float32}
_PAGE_FIELDS = tuple(_PAGE_DTYPES)


def _quantize_page_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side mirror of ``models.gpt._quantize_kv`` for one page slab
    (float32 in): symmetric per-(token, head) int8 over the head dim,
    FLOAT32 scales (the promotion write casts to the pool's scale dtype,
    so an int8 pool round-trips through the host tier exactly and a wide
    pool pays the int8 cache's noise, never more)."""
    scale = np.max(np.abs(x), axis=-1, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-8).astype(np.float32)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


class _Staged:
    """A fixed device buffer refreshed in place from host numpy. On a
    card the values go through a pinned host copy and an asynchronous
    copy; an event keeps the next refresh from overwriting the pinned
    copy before the previous upload has read it. The device tensor keeps
    its shape and address for the engine's lifetime."""

    def __init__(self, shape: tuple, dtype: torch.dtype,
                 device: torch.device):
        self.dev = torch.zeros(shape, dtype=dtype, device=device)
        self._host = self._event = None
        if device.type == "cuda":
            self._host = torch.zeros(shape, dtype=dtype, pin_memory=True)
            self._event = torch.cuda.Event()
        self._recorded = False

    def upload(self, values: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(values))
        if self._host is None:
            self.dev.copy_(src)
            return self.dev
        if self._recorded:
            self._event.synchronize()
        self._host.copy_(src)
        self.dev.copy_(self._host, non_blocking=True)
        self._event.record()
        self._recorded = True
        return self.dev


def _layer_pool(pool, i: int):
    return (pool[0][i], pool[1][i]) if isinstance(pool, tuple) else pool[i]


def _pool_arrays(pool) -> tuple:
    """The pool's stacked tensors: K and V, or their values and scales."""
    return tuple(a for half in (pool["k"], pool["v"])
                 for a in (half if isinstance(half, tuple) else (half,)))


class PagedEngine:
    """Continuous-batching decode over a paged KV pool with an optional
    prompt-prefix cache. ``admit_begin``/``prefill_step``/``step`` (or
    ``spec_step``)/``retire`` are the lifecycle the batcher drives;
    ``admit`` seats one request and drains its chunks.
    ``cache_dtype="int8"`` stores quantized pages; ``temperature=0``
    decodes greedily, otherwise sampling draws from a
    ``torch.Generator`` seeded with ``seed`` (per branch, with
    ``parallel_sampling``). ``speculative`` drafts up to ``draft_len``
    tokens a step by prompt lookup (n-grams from ``ngram_min``) and
    verifies them in one step; ``spec_tree`` drafts up to
    ``tree_width`` branches. ``dense_control`` builds the dense-bytes
    A/B geometry (one ``seq_len`` page per slot; the sweep backend only
    — such a page is too large for the kernel's shared-memory tile).
    ``structured=True`` enables ``response_format`` decoding over
    ``structured_vocab`` (default ``bytes_vocab(cfg.vocab)``);
    ``lora_rank``/``lora_max_live`` (both positive) build the adapter
    lanes and ``self.adapters``, their registry. ``host_spill`` (with
    ``prefix_cache``) demotes evicted prefix pages to a host pool of
    ``host_spill_mb`` MiB and promotes them back on a match;
    ``prefill_only`` builds the prefill side of a
    :class:`~torchbooster_tpu_torch.serving.disagg.DisaggPair`, whose
    ``step``/``spec_step`` raise."""

    def __init__(self, params: dict, cfg: GPTConfig, *,
                 page_size: int = 64, n_pages: int = 128,
                 max_slots: int = 8, cache_dtype: str | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None, seed: int = 0,
                 prefix_cache: bool = False, prefill_chunk_pages: int = 4,
                 speculative: bool = False, draft_len: int = 4,
                 ngram_min: int = 2, spec_tree: bool = False,
                 tree_width: int = 2, parallel_sampling: bool = False,
                 decode_backend: str | None = None, tp: int = 1,
                 structured: bool = False, structured_vocab=None,
                 lora_rank: int = 0, lora_max_live: int = 0,
                 host_spill: bool = False, host_spill_mb: float = 64.0,
                 prefill_only: bool = False,
                 device: str | torch.device = "cuda"):
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
        if speculative and not 1 <= draft_len < page_size:
            # 1 + draft_len writes a step stay within one page past the
            # cursor's
            raise ValueError(
                f"speculative decoding needs 1 <= draft_len < page_size, "
                f"got draft_len={draft_len} with page_size={page_size}")
        if spec_tree and not speculative:
            raise ValueError(
                "spec_tree=True needs speculative=True: tree drafting "
                "generalizes the draft+verify path, there is no tree "
                "without a verify step")
        if spec_tree and temperature != 0:
            raise ValueError(
                f"spec_tree needs greedy decoding (temperature=0, got "
                f"{temperature}): sampling acceptance across sibling "
                "branches needs without-replacement residuals the verify "
                "rule does not carry")
        if parallel_sampling and speculative:
            raise ValueError(
                "parallel_sampling and speculative are mutually exclusive: "
                "the per-branch sampling streams and logprobs ride the "
                "plain decode step — serve n-way traffic on a "
                "non-speculative engine")
        if host_spill and not prefix_cache:
            raise ValueError(
                "host_spill=True needs prefix_cache=True: the spill tier "
                "demotes REGISTERED prefix pages at eviction — without the "
                "prefix index there is nothing to demote or promote")
        if structured_vocab is not None and not structured:
            raise ValueError(
                "structured_vocab without structured=True does nothing: "
                "the token-DFA compiler only runs on a structured engine")
        if (lora_rank > 0) != (lora_max_live > 0):
            raise ValueError(
                f"lora_rank={lora_rank} with lora_max_live={lora_max_live}: "
                "enable batched LoRA with BOTH positive — rank and lane "
                "count are step shapes, half a configuration cannot build")
        self.device = resolve_device(device)
        if decode_backend is None:
            decode_backend = "kernel" if self.device.type == "cuda" \
                else "sweep"
        if decode_backend not in ("kernel", "sweep"):
            raise ValueError(f"decode_backend must be 'kernel' (the paged "
                             f"flash-decode kernel) or 'sweep' (the pool "
                             f"sweep), got {decode_backend!r}")
        _check_pos(params, cfg)
        self.quantized = cache_dtype == "int8"
        self.speculative = bool(speculative)
        self.draft_len = draft_len
        if decode_backend == "kernel":
            # a step shape no B4 route takes must fail here, not at the
            # first step (and never quietly drop to the sweep)
            check_paged(compute_dtype,
                        torch.int8 if self.quantized else compute_dtype,
                        cfg.head_dim, page_size,
                        1 + (draft_len if self.speculative else 0),
                        cfg.n_heads // cfg.kv_heads)
        self.decode_backend = decode_backend
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_slots = max_slots
        self.compute_dtype = compute_dtype
        self.prefix_cache = bool(prefix_cache)
        self.parallel = bool(parallel_sampling)
        self.params = cast_params(
            map_tensors(params, lambda t: t.to(self.device)), compute_dtype)
        self._layers = [layer_params(self.params["blocks"], i)
                        for i in range(cfg.n_layers)]
        self.tables = BlockTables(cfg, page_size, n_pages, max_slots,
                                  prefix_cache=prefix_cache,
                                  parallel=self.parallel)
        self.prefill_chunk_pages = min(prefill_chunk_pages,
                                       self.tables.max_pages_per_slot)
        self.chunk_tokens = self.prefill_chunk_pages * page_size
        self.pool = make_pool(cfg, page_size, n_pages,
                              cache_dtype=cache_dtype,
                              compute_dtype=compute_dtype,
                              device=self.device)
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self._pick = _make_pick(temperature, top_k, top_p)
        self._branch_pick = _make_branch_pick(temperature, top_k, top_p)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._pending: list[dict] = []
        self.prefill_chunks = 0
        self.prefix_hit_pages = 0
        self.prefix_lookup_pages = 0
        # the host spill tier: eviction demotes registered prefix pages
        # to a host pool, and a later seat promotes them back through
        # one fixed-shape write a group of ``lanes`` pages, staged
        # through preallocated pinned buffers (each upload waits on the
        # previous copy's event, so group g+1 never overwrites group g's
        # pages before the copy has read them). Off, nothing is staged.
        self.host_spill = bool(host_spill)
        self.spills = 0          # pages demoted HBM -> host
        self.promotions = 0      # pages promoted host -> HBM
        self.host_hit_pages = 0  # seat-time matches served host-tier
        self.promoted_bytes = 0  # host payload bytes staged for promotion
        self._promote_lanes = 0
        self._promote_shapes: set = set()
        if self.host_spill:
            self.tables.host_pool = HostPagePool(
                max(1, int(host_spill_mb * (1 << 20))))
            self.tables.spill_fetch = self._spill_fetch
            lanes = self._promote_lanes = self.prefill_chunk_pages
            shape = (lanes, cfg.n_layers, page_size, cfg.kv_heads,
                     cfg.head_dim)
            self._stage = {name: np.zeros(shape if name in ("k", "v")
                                          else shape[:-1] + (1,), dtype)
                           for name, dtype in _PAGE_DTYPES.items()}
            self._stage_dev = {
                name: _Staged(a.shape, torch.from_numpy(a).dtype,
                              self.device)
                for name, a in self._stage.items()}
            self._stage_dst = _Staged((lanes,), torch.long, self.device)
        # prefill-only (the prefill side of serving/disagg.py): admits
        # and prefills, exports pages, never decodes
        self.prefill_only = bool(prefill_only)
        self.exported_pages = 0  # pages exported via export_pages
        self.exported_bytes = 0  # their payload bytes (quantized)
        self._decode_shapes: set = set()
        self._verify_shapes: set = set()
        self._chunk_shapes: set = set()
        # speculative decoding: drafter + verify step exist only when on
        self.spec_tree = bool(spec_tree)
        self.tree_width = tree_width
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_steps = 0
        self.spec_slot_steps = 0     # (slot, verify step) pairs
        self.tree_side_accepts = 0
        self._drafter = None
        self._verify = None
        if self.speculative:
            self._drafter = (
                TreeLookupDrafter(draft_len, ngram_min=ngram_min,
                                  width=tree_width) if self.spec_tree
                else PromptLookupDrafter(draft_len, ngram_min=ngram_min))
            self._verify = make_verify_fn(self)
        # parallel sampling: per-slot request seed and branch index
        # (each pick's generator is branch_generator(seed, branch,
        # context length)), and the prompt-final logits fork() samples
        # sibling branches' first tokens from
        self.forks = 0
        self.fork_pages = 0      # pages SHARED into children at fork
        self.cow_copies = 0      # private tail pages copied at fork
        self._seed_of = np.zeros(max_slots, np.int64)
        self._branch_of = np.zeros(max_slots, np.int32)
        self._fork_state: dict[int, dict] = {}
        self.step_logprobs: np.ndarray | None = None
        # structured generation: per-slot automaton cursors fused into
        # one (max_slots, vocab) legality mask on the host, uploaded each
        # step into preallocated device buffers (the seating slot's row
        # for a prefill chunk; one row a position for the verify step)
        self.structured = bool(structured)
        self._cursors = None
        self._svocab = None
        self._sdfa_cache: dict = {}
        self.structured_requests = 0
        if self.structured:
            vocab = (list(structured_vocab) if structured_vocab is not None
                     else bytes_vocab(cfg.vocab))
            if len(vocab) != cfg.vocab:
                raise ValueError(
                    f"structured_vocab has {len(vocab)} entries but the "
                    f"model's vocabulary is {cfg.vocab} — the token-DFA "
                    "mask must cover every logit")
            self._svocab = vocab
            self._cursors = SlotCursors(max_slots, cfg.vocab)
            self._smask = _Staged((max_slots, cfg.vocab), torch.bool,
                                  self.device)
            self._smask_row = _Staged((1, cfg.vocab), torch.bool,
                                      self.device)
            if self.speculative:
                self._smask_verify = np.ones(
                    (max_slots, 1 + draft_len, cfg.vocab), bool)
                self._smask_verify_dev = _Staged(
                    self._smask_verify.shape, torch.bool, self.device)
        # LoRA lanes: (n_layers, max_live + 1, ...) stacks in the compute
        # dtype, lane 0 the zero adapter; each slot's lane id (0 = base)
        # on the host and, every step, in a preallocated device buffer
        self.lora = lora_rank > 0
        self.lora_rank = int(lora_rank)
        self.lora_max_live = int(lora_max_live)
        self._slot_lanes = np.zeros(max_slots, np.int64)
        self._lora_buf = None
        self._lora_write_shapes: set = set()
        self.adapters = None
        if self.lora:
            lanes, d = self.lora_max_live + 1, cfg.d_model
            qkv_out = d + 2 * cfg.kv_heads * cfg.head_dim
            shapes = {"a_qkv": (cfg.n_layers, lanes, d, self.lora_rank),
                      "b_qkv": (cfg.n_layers, lanes, self.lora_rank,
                                qkv_out),
                      "a_proj": (cfg.n_layers, lanes, d, self.lora_rank),
                      "b_proj": (cfg.n_layers, lanes, self.lora_rank, d)}
            self._lora_buf = {k: torch.zeros(v, dtype=compute_dtype,
                                             device=self.device)
                              for k, v in shapes.items()}
            self._lanes_dev = _Staged((max_slots,), torch.long, self.device)
            self._lane_chunk = _Staged((1,), torch.long, self.device)
            self.adapters = AdapterRegistry(self)

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

    def _lora_layer(self, i: int, lanes: torch.Tensor | None):
        """Layer ``i``'s ``_block_core(lora=...)`` operand: its four lane
        stacks and the batch rows' lane ids; None with LoRA off."""
        if lanes is None:
            return None
        b = self._lora_buf
        return ((b["a_qkv"][i], b["b_qkv"][i], b["a_proj"][i],
                 b["b_proj"][i]), lanes)

    @torch.no_grad()
    def _chunk_fn(self, ids: torch.Tensor, start: int, s0: int,
                  table_row: torch.Tensor,
                  lanes: torch.Tensor | None = None) -> torch.Tensor:
        """ONE prefill chunk: forward ``ids`` (1, C) at positions
        ``start + [0, C)``, writing each layer's K/V into the slot's
        pages and attending prior context through the pool. Pad tokens
        of the final chunk write at positions >= ``s0`` (or into the
        null page past the table), which every mask excludes. Returns
        the (1, vocab) logits of position ``s0 - 1`` (meaningful only on
        the chunk that holds it)."""
        cfg, ps, dev = self.cfg, self.page_size, self.device
        C = ids.shape[1]
        n_cp = C // ps
        mp = table_row.shape[0]
        positions = start + torch.arange(C, device=dev)
        # after a prefix hit the final chunk starts on a page, not a chunk,
        # boundary, so its pad rows can pass the horizon: they embed and
        # rope at the last position, as the decode step's do, and every
        # mask keeps them out of the real rows
        positions = positions.clamp(max=cfg.seq_len - 1)
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

            x, _ = _block_core(bp, x, cfg, attend, positions=positions[None],
                               lora=self._lora_layer(i, lanes))
        last = x[:, min(max(s0 - 1 - start, 0), C - 1)][:, None]
        return _lm_head(self.params, last)[:, 0]

    @torch.no_grad()
    def _forward_fn(self, in_ids, tables, lengths, refs, page_pos, active,
                    work=None, depth=None, tree_vis=None,
                    lanes=None) -> torch.Tensor:
        """The paged step over all slots: ``in_ids (max_slots, S)`` at
        storage positions ``lengths + [0, S)``, roped and embedded at
        ``lengths + depth`` (``depth`` None: the storage positions). Every
        position's K/V lands in the slot's pages BEFORE the read — dead
        slots and positions past the horizon write the null page — so
        each query reads its own and its predecessors' K/V back in pool
        dtype; position ``j`` sees ``<= lengths + j`` (with ``tree_vis``:
        prior context and its ancestors). S = 1 is the decode step, S = 1
        + draft_len the speculative verify (``speculative.py:300``).
        ``work`` = the kernel backend's ``(work_pages, work_refs,
        work_pos)``; ``lanes`` the slots' LoRA lane ids. Returns
        (max_slots, S, vocab) logits (garbage at inactive slots)."""
        cfg, ps, dev = self.cfg, self.page_size, self.device
        n_slots, S = in_ids.shape
        mp = tables.shape[1]
        positions = lengths[:, None] + torch.arange(S, device=dev)
        sem_pos = positions if depth is None else lengths[:, None] + depth
        # sentinel ids embed as 0 and horizon positions at the last row:
        # garbage that acceptance and the null-page writes keep out of
        # every live value
        pos_c = sem_pos.clamp(max=cfg.seq_len - 1)
        x = self._embed(in_ids.clamp(0, cfg.vocab - 1), pos_c)
        pidx = positions // ps
        rows = torch.arange(n_slots, device=dev)[:, None]
        w_page = torch.where((pidx < mp) & active[:, None],
                             tables[rows, pidx.clamp(max=mp - 1)],
                             torch.full_like(pidx, NULL_PAGE))
        w_off = positions % ps
        if self.decode_backend == "sweep":
            # (page, lane, position) routing shared by every layer: a
            # page's token t sits at page_pos*ps + t; empty lanes divert
            # to the trash segment n_slots*S; page 0 is never read
            refs_t = refs[1:]
            n_lanes = refs_t.shape[1]
            ref_c = refs_t.clamp(0, n_slots - 1)
            j = torch.arange(S, device=dev)
            seg = torch.where(refs_t[:, :, None] >= 0,
                              ref_c[:, :, None] * S + j,
                              torch.full_like(ref_c[:, :, None],
                                              n_slots * S)).reshape(-1)
            tok_pos = page_pos[1:, None] * ps + torch.arange(ps, device=dev)
            ref_len = torch.where(refs_t >= 0, lengths[ref_c],
                                  torch.full_like(refs_t, -1))
            off = tok_pos[:, None, None, :] - ref_len[:, :, None, None]
            if tree_vis is None:
                visible = off <= j[None, None, :, None]     # (P, R, S, ps)
            else:
                # prior context (offset <= 0) is visible to every node,
                # a draft row at offset i in (0, S) only to the nodes it
                # is an ancestor-or-self of
                off = off[:, :, 0]                          # (P, R, ps)
                tv = tree_vis[ref_c].bool()                 # (P, R, S, S)
                sel = torch.gather(tv, 3, off.clamp(0, S - 1)[:, :, None]
                                   .expand(-1, -1, S, -1))  # (P, R, S, ps)
                visible = (off <= 0)[:, :, None] | (
                    ((off > 0) & (off < S))[:, :, None] & sel)
            visible = visible.reshape(-1, n_lanes * S, ps)
        len32 = lengths.to(torch.int32)

        for i, bp in enumerate(self._layers):
            pk = _layer_pool(self.pool["k"], i)
            pv = _layer_pool(self.pool["v"], i)

            def attend(q, k, v, pk=pk, pv=pv):
                if self.quantized:
                    for pool, new in ((pk, k), (pv, v)):
                        vals, scales = _quantize_kv(new)
                        pool[0][w_page, w_off] = vals
                        pool[1][w_page, w_off] = scales
                else:
                    pk[w_page, w_off] = k.to(pk.dtype)
                    pv[w_page, w_off] = v.to(pv.dtype)
                if self.decode_backend == "kernel":
                    o = paged_attention(q, pk, pv, *work, len32,
                                        page_size=ps, tree_vis=tree_vis)
                    return o.to(q.dtype), None
                rk = tuple(a[1:] for a in pk) if self.quantized else pk[1:]
                rv = tuple(a[1:] for a in pv) if self.quantized else pv[1:]
                # ONE pool read serves every lane's S positions: queries
                # gather to (P, R*S, H, Dh)
                q_lanes = q[ref_c].reshape(ref_c.shape[0], n_lanes * S,
                                           cfg.n_heads, cfg.head_dim)
                o_p, m_p, l_p = _grouped_cache_attention(
                    q_lanes, rk, rv, visible[:, None, None], state=True)
                n_seg = o_p.shape[0] * n_lanes * S
                o_f = o_p.reshape(n_seg, *o_p.shape[2:])
                m_f = m_p.movedim(-1, 1).reshape(n_seg, *m_p.shape[1:3])
                l_f = l_p.movedim(-1, 1).reshape(n_seg, *l_p.shape[1:3])
                m_s = torch.full((n_slots * S + 1, *m_f.shape[1:]),
                                 -float("inf"), device=dev)
                m_s = m_s.scatter_reduce(
                    0, seg.view(-1, 1, 1).expand_as(m_f), m_f,
                    reduce="amax")
                w = torch.exp(m_f - m_s[seg])
                l_s = torch.zeros_like(m_s).index_add(0, seg, l_f * w)
                o_s = torch.zeros((n_slots * S + 1, *o_f.shape[1:]),
                                  device=dev).index_add(0, seg,
                                                        o_f * w[..., None])
                o = o_s[:n_slots * S] / l_s[:n_slots * S].clamp_min(
                    1e-30)[..., None]
                return o.reshape(n_slots, S, cfg.n_heads,
                                 cfg.head_dim).to(q.dtype), None

            x, _ = _block_core(bp, x, cfg, attend, positions=pos_c,
                               lora=self._lora_layer(i, lanes))
        return _lm_head(self.params, x)

    @torch.no_grad()
    def _compact_fn(self, tables, lengths, active, src_off) -> None:
        """Tree verify's post-acceptance K/V compaction (``engine.py:
        971``): offset ``j`` of every slot takes the K/V rows stored at
        offset ``src_off[slot, j]`` (the accepted path's node ids, which
        never sit below their path index), over every layer, values and
        scales. All sources are gathered into a temporary before any
        write lands; identity rows copy onto themselves and inactive
        slots into the null page, so duplicate targets fall on the null
        page only, which nothing reads."""
        ps, dev = self.page_size, self.device
        n_slots, S = src_off.shape
        mp = tables.shape[1]
        rows = torch.arange(n_slots, device=dev)[:, None]

        def locate(pos):
            pidx = pos // ps
            page = torch.where((pidx < mp) & active[:, None],
                               tables[rows, pidx.clamp(max=mp - 1)],
                               torch.full_like(pidx, NULL_PAGE))
            return page, pos % ps

        dst_page, dst_off = locate(lengths[:, None]
                                   + torch.arange(S, device=dev))
        src_page, src_sub = locate(lengths[:, None] + src_off)
        for a in _pool_arrays(self.pool):
            a[:, dst_page, dst_off] = a[:, src_page, src_sub]

    @torch.no_grad()
    def _cow_fn(self, src_pages, dst_pages) -> None:
        """Fork's copy-on-write tail copy (``engine.py:955``): pool page
        ``dst_pages[i]`` becomes a copy of ``src_pages[i]`` across every
        layer, values and scales, in one index copy per pool tensor.
        ``(max_slots,)`` id vectors padded with null->null copies."""
        for a in _pool_arrays(self.pool):
            a[:, dst_pages] = a[:, src_pages]

    # ---- the host spill tier ----------------------------------------
    def _spill_fetch(self, p: int) -> dict:
        """Demotion payload for pool page ``p`` (``engine.py:1009``):
        int8 K/V values plus float32 per-(token, head) scales across every
        layer, as host numpy arrays keyed like the staging buffers. The
        tier's one deliberate device->host read, on the ADMISSION cadence
        (an eviction inside ``seat``), never inside a decode step. int8
        pools ship their stored values and scales verbatim (a lossless
        round trip); wide pools quantize here, as ``_quantize_kv``
        does."""
        if self.quantized:
            (k, ks), (v, vs) = ((vals[:, p].cpu().numpy(),
                                 scales[:, p].float().cpu().numpy())
                                for vals, scales in (self.pool["k"],
                                                     self.pool["v"]))
        else:
            k, ks = _quantize_page_np(self.pool["k"][:, p].float().cpu()
                                      .numpy())
            v, vs = _quantize_page_np(self.pool["v"][:, p].float().cpu()
                                      .numpy())
        self.spills += 1
        return {"k": k, "k_scale": ks, "v": v, "v_scale": vs}

    @torch.no_grad()
    def _promote_fn(self, k_q, k_s, v_q, v_s, dst) -> None:
        """The host->device promotion write (``engine.py:1035``): staged
        pages land at pool ids ``dst`` across every layer, in place, on
        the current stream (so the chunk and the decode step that read
        them are ordered after it). Fixed shapes — the ``(lanes,
        n_layers, page_size, kv_heads, head_dim)`` staging block and a
        ``(lanes,)`` id vector whose pad lanes target the null page,
        which every read masks. Wide pools dequantize as ``(q.float() *
        s).to(pool.dtype)``, the reference's rounding order."""
        for half, q, sc in (("k", k_q, k_s), ("v", v_q, v_s)):
            pool = self.pool[half]
            vals, scl = q.movedim(0, 1), sc.movedim(0, 1)
            if isinstance(pool, tuple):
                pool[0][:, dst] = vals
                pool[1][:, dst] = scl.to(pool[1].dtype)
            else:
                pool[:, dst] = (vals.float() * scl).to(pool.dtype)

    def issue_promotions(self) -> int:
        """Dispatch every queued host->device promotion (``engine.py:
        1059``). The batcher calls this right before chunk issue;
        ``prefill_step`` also fires it for directly driven engines.
        Payloads stream through the fixed staging buffers in
        ``lanes``-sized groups — the same write every group, a short last
        group padded onto the null page — and the promoted keys re-enter
        the prefix index at their seated table positions. Returns the
        number of pages promoted (the copies are asynchronous)."""
        if not self.host_spill:
            return 0
        n = 0
        lanes = self._promote_lanes
        for p in self._pending:
            work = p.pop("promote", None)
            if not work:
                continue
            keys, payloads = work["keys"], work["payloads"]
            start_idx = work["start_idx"]
            row = self.tables.tables[p["slot"]]
            with torch.profiler.record_function("serving_promote"):
                for g in range(0, len(keys), lanes):
                    dst = np.zeros(lanes, np.int64)     # pad -> null page
                    for i, pl in enumerate(payloads[g:g + lanes]):
                        for name in _PAGE_FIELDS:
                            self._stage[name][i] = pl[name]
                        dst[i] = row[start_idx + g + i]
                        self.promoted_bytes += sum(
                            int(a.nbytes) for a in pl.values())
                    ops = [self._stage_dev[name].upload(self._stage[name])
                           for name in _PAGE_FIELDS]
                    ops.append(self._stage_dst.upload(dst))
                    self._promote_shapes.add(self._signature(
                        dict(zip((*_PAGE_FIELDS, "dst"), ops))))
                    k_q, k_s, v_q, v_s, d = ops
                    self._promote_fn(k_q, k_s, v_q, v_s, d)
            self.tables.promote_keys(p["slot"], keys, start_idx)
            self.promotions += len(keys)
            n += len(keys)
        return n

    def export_pages(self, slot: int,
                     prompt_ids: np.ndarray) -> list[tuple[bytes, dict]]:
        """The slot's leading FULL prompt pages as ``(chain_key,
        payload)`` pairs in the demotion format (``engine.py:1109``),
        keyed by the prefix index's chain. The ``(len - 1) // page_size``
        cap matches the matcher's, so the importer always re-runs at
        least the final chunk and samples the first token itself. Call
        before :meth:`retire` frees the pages; device->host reads on the
        per-request cadence, never inside a decode step."""
        prompt = np.ascontiguousarray(prompt_ids, np.int32).reshape(-1)
        limit = (len(prompt) - 1) // self.page_size
        row = self.tables.tables[slot]
        out: list[tuple[bytes, dict]] = []
        for i in range(limit):
            p = int(row[i])
            if p == NULL_PAGE:
                break
            key = prompt[:(i + 1) * self.page_size].tobytes()
            payload = self._spill_fetch(p)
            self.spills -= 1   # an export is not a demotion: the page
            #                    stays seated
            self.exported_pages += 1
            self.exported_bytes += sum(int(a.nbytes)
                                       for a in payload.values())
            out.append((key, payload))
        return out

    # ---- lifecycle --------------------------------------------------
    def admit_begin(self, prompt_ids: np.ndarray, seed: int | None = None,
                    branch: int = 0, adapter_lane: int = 0) -> int | None:
        """Seat one request: map cached prefix pages into its block
        table, allocate private pages for the rest, and queue its
        chunked prefill. Returns the slot, or None when no slot or not
        enough pages (the batcher keeps it queued). ``seed``/``branch``
        matter with ``parallel_sampling``: the slot samples branch
        ``branch`` of the request's stream ``seed``, so branch b of an
        n-way fork equals a run admitted with ``(seed, branch=b)``.
        ``adapter_lane`` (LoRA) is the slot's lane from
        ``AdapterRegistry.acquire``, 0 the base model; the caller holds
        the pin until retire."""
        if adapter_lane and not self.lora:
            raise ValueError(
                f"adapter_lane={adapter_lane} on an engine without lora: "
                "build with lora_rank/lora_max_live")
        if not 0 <= adapter_lane <= self.lora_max_live:
            raise ValueError(f"adapter_lane {adapter_lane} out of range "
                             f"[0, {self.lora_max_live}]")
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
        # ONE walk serves the capacity check and the seat; with the
        # spill tier it continues past the HBM chain into the host pool
        # (host matches still need pool pages allocated — only HBM hits
        # discount the capacity — but skip their prefill)
        matched, host_keys = self.tables.match_tiered(prompt)
        if self.tables.pages_for(s0) - len(matched) \
                > self.tables.n_available_pages:
            return None
        # pop the host payloads BEFORE seating: seat() can evict-demote,
        # and a demotion landing in the host pool could LRU-evict the
        # very pages just matched. Put back if the seat fails (or on a
        # retire that beats the promotion).
        payloads: list[dict] = []
        for i, key in enumerate(host_keys):
            pl = self.tables.host_pool.pop(key)
            if pl is None:             # defensive: cut the chain at a gap
                host_keys = host_keys[:i]
                break
            payloads.append(pl)
        try:
            self.tables.seat(slot, prompt, matched=matched)
        except RuntimeError:
            # mapping the matched pages made them un-evictable and the
            # private tail came up short: seat() rolled back, stay queued
            for key, pl in zip(host_keys, payloads):
                self.tables.host_pool.put(key, pl)
            return None
        self.prefix_lookup_pages += (s0 - 1) // self.page_size
        self.prefix_hit_pages += len(matched)
        self.host_hit_pages += len(host_keys)
        self._seed_of[slot] = 0 if seed is None else int(seed) & 0x7fffffff
        self._branch_of[slot] = int(branch)
        self._slot_lanes[slot] = int(adapter_lane)
        if self._drafter is not None:
            self._drafter.begin(slot, prompt)
        # chunking starts past BOTH tiers' matches: HBM hits are mapped
        # shares, host hits are written by the promotion before the
        # first chunk issues
        start = (len(matched) + len(host_keys)) * self.page_size
        n_chunks = -(-(s0 - start) // self.chunk_tokens)
        padded = np.zeros(start + n_chunks * self.chunk_tokens, np.int32)
        padded[:s0] = prompt
        pend = {"slot": slot, "ids": padded, "s0": s0, "start": start}
        if host_keys:
            pend["promote"] = {"keys": host_keys, "payloads": payloads,
                               "start_idx": len(matched)}
        self._pending.append(pend)
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

    def _branch_gens(self, slots, depths) -> list:
        """One :func:`branch_generator` per listed slot (None under
        greedy, which samples nothing)."""
        if self.temperature == 0:
            return [None] * len(slots)
        return [branch_generator(self._seed_of[s], self._branch_of[s], d,
                                 self.device) for s, d in zip(slots, depths)]

    def prefill_step(self) -> tuple[int, int] | None:
        """Run ONE chunk of the oldest queued prefill. Returns ``(slot,
        first_token)`` when that request's prefill completed (the slot
        is then active and its full prompt pages registered), else
        None. With ``parallel_sampling`` the first token is branch
        ``branch``'s pick at depth ``s0`` and the prompt-final logits
        are kept for :meth:`fork`."""
        if not self._pending:
            return None
        if self.host_spill:
            # a chunk must never attend host-matched pages that were not
            # written yet (the batcher has already promoted; a directly
            # driven engine has not)
            self.issue_promotions()
        p = self._pending[0]
        slot, C = p["slot"], self.chunk_tokens
        ids = torch.as_tensor(p["ids"][p["start"]:p["start"] + C],
                              dtype=torch.long).to(self.device)[None]
        table_row = torch.as_tensor(self.tables.tables[slot],
                                    dtype=torch.long).to(self.device)
        lanes = (self._lane_chunk.upload(self._slot_lanes[slot:slot + 1])
                 if self.lora else None)
        self._chunk_shapes.add((tuple(ids.shape), tuple(table_row.shape)))
        with torch.profiler.record_function("serving_prefill_chunk"):
            logits = self._chunk_fn(ids, p["start"], p["s0"], table_row,
                                    lanes)
        # the seating slot's legality row masks the first-token pick
        # (all-True when unconstrained: an exact no-op); the logits a
        # fork samples its siblings from stay unmasked
        picked = _mask_logits(
            logits, self._smask_row.upload(self._cursors.mask[slot:slot + 1])
            if self.structured else None)
        self.prefill_chunks += 1
        p["start"] += C
        if not self.parallel:
            tok = self._pick(self._gen, picked)
        if p["start"] < p["s0"]:
            return None
        self._pending.pop(0)
        if self.parallel:
            tok, lp = self._branch_pick(
                self._branch_gens([slot], [p["s0"]]), picked)
            # ONE device->host copy for the token and its logprob
            tok, lp = torch.stack([tok.double(), lp.double()]).cpu()
            self._fork_state[slot] = {"logits": logits,
                                      "logprob": float(lp[0]),
                                      "s0": int(p["s0"])}
        first = int(tok[0])
        self.tables.activate(slot, first)
        self.tables.register_prefix(slot, p["ids"][:p["s0"]])
        if self._drafter is not None:
            self._drafter.observe(slot, [first])
        if self.structured:
            # fork() rebases children, so a parent about to fork is
            # already right: branch 0 keeps this very token
            self._cursors.observe(slot, [first])
        return slot, first

    def admit(self, prompt_ids: np.ndarray, seed: int | None = None,
              branch: int = 0) -> tuple[int, int] | None:
        """Seat one request and drain prefill chunks until ITS first
        token lands; returns ``(slot, first_token)`` or None."""
        slot = self.admit_begin(prompt_ids, seed=seed, branch=branch)
        if slot is None:
            return None
        while True:
            done = self.prefill_step()
            if done is not None and done[0] == slot:
                return done

    def fork(self, parent_slot: int, n_branches: int
             ) -> list[tuple[int, int, float]]:
        """Fork a just-prefilled slot into ``n_branches`` sampling
        branches (``engine.py:1457``): every FULL page of the parent is
        SHARED into each child's table (one read serves all branches
        through the refs lanes), the partial tail page is copied once
        per child (:meth:`_cow_fn`), and branch b samples its own first
        token from the parent's prompt-final logits with its own stream
        — so the branches diverge from token one exactly as independent
        runs admitted with ``(seed, branch=b)`` would. Returns ``[(slot,
        first_token, first_logprob)]`` for all branches, branch 0 (the
        parent) first. Must run before the parent's first decode step;
        raises ``PoolExhausted`` when slots or pages run out, leaving
        the parent as it was (the caller preempts and retries)."""
        if not self.parallel:
            raise RuntimeError(
                "fork() needs PagedEngine(parallel_sampling=True)")
        if n_branches < 2:
            raise ValueError(f"n_branches must be >= 2, got {n_branches}")
        st = self._fork_state.get(parent_slot)
        if st is None or int(self.tables.lengths[parent_slot]) \
                != int(self.tables.prompt_len[parent_slot]):
            raise RuntimeError(
                f"slot {parent_slot} is not at its prefill boundary: "
                "fork() must run before the parent's first decode step "
                "(branches diverge from token one)")
        if int(self._branch_of[parent_slot]) != 0:
            raise RuntimeError(
                f"slot {parent_slot} is itself branch "
                f"{int(self._branch_of[parent_slot])}: only branch 0 "
                "forks (re-forking a branch would alias streams)")
        # peek above, pop only past the fallible part: an exhaustion
        # here leaves the stash for the retry
        children = self.tables.fork(parent_slot, n_branches - 1)
        self._fork_state.pop(parent_slot)
        length = int(self.tables.lengths[parent_slot])
        n_full = length // self.page_size
        self.forks += 1
        self.fork_pages += n_full * len(children)
        if length % self.page_size:
            src = np.zeros(self.max_slots, np.int64)
            dst = np.zeros(self.max_slots, np.int64)
            src[:len(children)] = self.tables.tables[parent_slot, n_full]
            dst[:len(children)] = self.tables.tables[children, n_full]
            with torch.profiler.record_function("serving_fork_cow"):
                self._cow_fn(torch.as_tensor(src).to(self.device),
                             torch.as_tensor(dst).to(self.device))
            self.cow_copies += len(children)
        for b, child in enumerate(children, start=1):
            self._seed_of[child] = self._seed_of[parent_slot]
            self._branch_of[child] = b
            # branches decode through the parent's adapter (the batcher
            # pins it once a branch)
            self._slot_lanes[child] = self._slot_lanes[parent_slot]
        logits = st["logits"].expand(len(children), -1).contiguous()
        constrained = self.structured and self._cursors.active(parent_slot)
        if constrained:
            # every branch's first pick replays an independent
            # constrained run: the automaton's START-state row
            logits = _mask_logits(logits, torch.as_tensor(
                self._cursors.start_row(parent_slot)).to(self.device))
        toks, lps = self._branch_pick(
            self._branch_gens(children, [st["s0"]] * len(children)), logits)
        toks, lps = torch.stack([toks.double(), lps.double()]).cpu()
        out = [(parent_slot, int(self.tables.last_ids[parent_slot]),
                st["logprob"])]
        for child, tok, lp in zip(children, toks.tolist(), lps.tolist()):
            self.tables.activate(child, int(tok))
            if constrained:
                # the child's cursor rebases to the start and observes
                # its own first token
                self._cursors.fork_child(parent_slot, child)
                self._cursors.observe(child, [int(tok)])
            out.append((child, int(tok), float(lp)))
        return out

    def take_first_logprob(self, slot: int) -> float:
        """Consume a just-prefilled slot's first-token logprob (parallel
        mode), dropping its fork stash; 0.0 when nothing is stashed."""
        st = self._fork_state.pop(slot, None)
        return 0.0 if st is None else st["logprob"]

    def grow_slots(self) -> list[int]:
        """Pre-allocate each active slot's upcoming write pages (evicting
        cached prefixes under pressure): one position ahead, ``1 +
        draft_len`` in speculative mode (the verify step writes every
        drafted position). Returns the slots that could NOT get them
        (the batcher preempts). Call before every step."""
        ahead = 1 + (self.draft_len if self.speculative else 0)
        return [int(slot) for slot in np.flatnonzero(self.tables.active)
                if not self.tables.ensure_write_pages(int(slot), ahead)]

    def _kernel_operands(self) -> tuple | None:
        """The kernel backend's compacted live-page walk on the device;
        None on the sweep."""
        if self.decode_backend != "kernel":
            return None
        ka = self.tables.kernel_args()
        return tuple(torch.as_tensor(ka[k]).to(self.device)
                     for k in ("work_pages", "work_refs", "work_pos"))

    def _step_args(self) -> tuple[np.ndarray, dict, tuple | None]:
        """The active mask (host), the table operands on the device and
        the kernel's walk; raises when a slot reached the horizon."""
        active = self.tables.active.copy()
        if active.any() and (self.tables.lengths[active]
                             >= self.cfg.seq_len).any():
            raise RuntimeError("a slot reached cfg.seq_len; the batcher "
                               "must retire sequences at the horizon")
        args = {k: torch.as_tensor(v).to(self.device)
                for k, v in self.tables.device_args().items()}
        args = {k: v.long() if v.dtype == torch.int32 else v
                for k, v in args.items()}
        return active, args, self._kernel_operands()

    @staticmethod
    def _signature(tensors: dict) -> tuple:
        return tuple((k, tuple(v.shape), str(v.dtype))
                     for k, v in tensors.items() if v is not None)

    def _mode_operands(self, smask, lanes) -> dict:
        """The structured and LoRA operands of a step, by name, for its
        shape signature (empty with both off)."""
        return {"smask": smask, "lanes": lanes, **(self._lora_buf or {})}

    def step(self) -> np.ndarray:
        """One decode step over every ACTIVE slot; advances lengths/
        last_ids for those and returns the (max_slots,) token ids
        (garbage at inactive or mid-prefill slots). With
        ``parallel_sampling`` each slot samples its branch's stream and
        ``step_logprobs`` holds the picks' logprobs."""
        if self.prefill_only:
            raise RuntimeError(
                "step() on a prefill_only engine: the disaggregated prefill "
                "pool exports pages (export_pages) instead of decoding — "
                "route decode to the decode host")
        active, args, work = self._step_args()
        smask = (self._smask.upload(self._cursors.mask)
                 if self.structured else None)
        lanes = (self._lanes_dev.upload(self._slot_lanes)
                 if self.lora else None)
        self._decode_shapes.add(self._signature(
            {**args, **dict(zip(("wp", "wr", "wpos"), work or ())),
             **self._mode_operands(smask, lanes)}))
        with torch.profiler.record_function("decode_step"):
            logits = self._forward_fn(
                args["last_ids"][:, None], args["tables"], args["lengths"],
                args["refs"], args["page_pos"], args["active"], work,
                lanes=lanes)[:, 0]
            # constrained rows knock illegal tokens to the dtype's
            # minimum; unconstrained rows are all-True (a no-op)
            logits = _mask_logits(logits, smask)
        if self.parallel:
            slots = np.flatnonzero(active)
            gens = [None] * self.max_slots
            for s, gen in zip(slots, self._branch_gens(
                    slots, self.tables.lengths[slots] + 1)):
                gens[s] = gen
            tokens, lps = self._branch_pick(gens, logits)
            # ONE device->host copy for both results
            tokens, lps = torch.stack([tokens.double(), lps.double()]).cpu()
            self.step_logprobs = lps.numpy()
            tokens = tokens.long().numpy()
        else:
            tokens = self._pick(self._gen, logits).cpu().numpy()
        for slot in np.flatnonzero(active):
            self.tables.advance(int(slot), int(tokens[slot]))
            if self._drafter is not None:
                self._drafter.observe(int(slot), [int(tokens[slot])])
            if self.structured:
                self._cursors.observe(int(slot), [int(tokens[slot])])
        return tokens

    def spec_step(self) -> dict[int, list[int]]:
        """One speculative step over every ACTIVE slot (``engine.py:
        1704``): draft on the host, verify all ``1 + draft_len``
        positions in ONE step, accept the longest confirmed prefix (tree
        mode: the accepted root-to-leaf path, compacted into place) and
        advance each slot over its accepted tokens plus the fallback or
        bonus pick — 1 to ``draft_len + 1`` tokens a slot. Rejected
        positions are never advanced over: their K/V sits past
        ``lengths``, invisible, and the next step overwrites it. One
        device->host copy a step. Returns ``{slot: [tokens]}``."""
        if self.prefill_only:
            raise RuntimeError(
                "spec_step() on a prefill_only engine: the disaggregated "
                "prefill pool exports pages (export_pages) instead of "
                "decoding")
        if not self.speculative:
            raise RuntimeError(
                "spec_step() needs a PagedEngine(speculative=True); the "
                "cold engine decodes through step()")
        active, args, work = self._step_args()
        k = self.draft_len
        drafts = np.full((self.max_slots, k), NO_DRAFT, np.int32)
        parents = np.tile(np.arange(k, dtype=np.int32), (self.max_slots, 1))
        vmask = None
        if self.structured:
            vmask = self._smask_verify
            vmask[:] = True
        for slot in np.flatnonzero(active):
            slot = int(slot)
            if self.spec_tree:
                d, parents[slot] = self._drafter.draft_tree(slot)
            else:
                d = self._drafter.draft(slot)
            # horizon cap: drafted position j writes at lengths + 1 + j,
            # which must stay inside the slot's table (the step also
            # diverts overflow writes to the null page)
            room = int(self.cfg.seq_len - self.tables.lengths[slot]) - 1
            if room < k:
                d[max(room, 0):] = NO_DRAFT
            if self.structured and self._cursors.active(slot):
                # drafts checked against the automaton: a chain truncates
                # at its first illegal token, a tree prunes the illegal
                # node and its subtree (to the never-accepted NO_DRAFT);
                # each position's row masks its fallback or bonus pick
                if self.spec_tree:
                    d, rows = self._cursors.tree_rows(slot, d, parents[slot])
                else:
                    d, rows = self._cursors.draft_rows(slot, d)
                vmask[slot] = rows
            drafts[slot] = d
            self.spec_proposed += int((d >= 0).sum())
        in_ids = torch.cat([args["last_ids"][:, None],
                            torch.as_tensor(drafts).to(self.device).long()],
                           dim=1)
        tree = None
        if self.spec_tree:
            depth, vis = tree_masks(parents)
            tree = tuple(torch.as_tensor(a).to(self.device).long()
                         for a in (parents, depth, vis))
        smask = (self._smask_verify_dev.upload(vmask)
                 if self.structured else None)
        lanes = (self._lanes_dev.upload(self._slot_lanes)
                 if self.lora else None)
        self._verify_shapes.add(self._signature(
            {**args, "in_ids": in_ids,
             **dict(zip(("wp", "wr", "wpos"), work or ())),
             **dict(zip(("parents", "depth", "vis"), tree or ())),
             **self._mode_operands(smask, lanes)}))
        with torch.profiler.record_function("spec_verify_step"):
            accept, token = self._verify(
                args["tables"], args["lengths"], args["refs"],
                args["page_pos"], args["active"], in_ids, work, tree,
                smask, lanes)
            # ONE device->host copy for both results
            both = torch.cat([accept.long(), token], dim=1).cpu().numpy()
        accept, token = both[:, :k].astype(bool), both[:, k:]
        self.spec_steps += 1
        self.spec_slot_steps += int(active.sum())
        out: dict[int, list[int]] = {}
        paths: dict[int, list[int]] = {}
        for slot in np.flatnonzero(active):
            slot = int(slot)
            if self.spec_tree:
                path = tree_accept_path(accept[slot], parents[slot])
                a = len(path)
                emitted = [int(drafts[slot, p - 1]) for p in path] \
                    + [int(token[slot, path[-1] if path else 0])]
                paths[slot] = path
                self.tree_side_accepts += int(path != list(range(1, a + 1)))
            else:
                a = accept_count(accept[slot])
                emitted = [int(t) for t in drafts[slot, :a]] \
                    + [int(token[slot, a])]
            # a request may accept its way up to seq_len, never past it
            room = int(self.cfg.seq_len - self.tables.lengths[slot])
            emitted = emitted[:room]
            self.spec_accepted += min(a, len(emitted))
            out[slot] = emitted
        if self.spec_tree:
            # compaction BEFORE lengths advance: the accepted path's rows
            # move down to the positions the new lengths will expose
            src_off = np.tile(np.arange(k + 1), (self.max_slots, 1))
            for slot, path in paths.items():
                src_off[slot, 1:len(path) + 1] = path
            with torch.profiler.record_function("spec_tree_compact"):
                self._compact_fn(args["tables"], args["lengths"],
                                 args["active"],
                                 torch.as_tensor(src_off).to(self.device))
        for slot, emitted in out.items():
            for t in emitted:
                self.tables.advance(slot, t)
            self._drafter.observe(slot, emitted)
            if self.structured:
                # the cursor stops at EOS itself; tokens past it in the
                # burst are the tail the batcher drops
                self._cursors.observe(slot, emitted)
        return out

    def retire(self, slot: int) -> None:
        """Release the slot (cancelling any in-flight prefill); shared
        prefix pages stay resident for later hits."""
        for p in self._pending:
            # a retire that beats the promotion: the popped host payloads
            # go back to the host pool instead of vanishing
            if p["slot"] == slot and "promote" in p:
                work = p.pop("promote")
                for key, pl in zip(work["keys"], work["payloads"]):
                    self.tables.host_pool.put(key, pl)
        self._pending = [p for p in self._pending if p["slot"] != slot]
        if self._drafter is not None:
            self._drafter.reset(slot)
        if self.structured:
            self._cursors.reset(slot)
        self._fork_state.pop(slot, None)
        self._seed_of[slot] = 0
        self._branch_of[slot] = 0
        # a reused slot decodes the base model until its next seat (the
        # registry pin is the batcher's to release)
        self._slot_lanes[slot] = 0
        self.tables.retire(slot)

    # ---- structured generation -----------------------------------
    def structured_compile(self, spec: dict):
        """``response_format`` spec -> token-level DFA over this engine's
        vocabulary (None for ``{"type": "text"}``), through the engine's
        fingerprint cache: each distinct schema compiles once. Raises
        ``ValueError`` on a bad spec or an unsatisfiable schema."""
        if not self.structured:
            raise RuntimeError(
                "structured_compile() needs PagedEngine(structured=True)")
        return compile_response_format(spec, self._svocab,
                                       cache=self._sdfa_cache)

    def structured_begin(self, slot: int, spec: dict, eos_id: int,
                         prefix_tokens=()) -> bool:
        """Bind a seated slot's automaton cursor before its prefill
        chunks run (so the first-token pick is masked). ``prefix_tokens``
        are a preempted request's folded generated tokens, replayed so
        the automaton resumes where it stopped. Returns whether the spec
        constrains (``{"type": "text"}`` does not)."""
        if not self.structured:
            raise RuntimeError(
                "structured_begin() needs PagedEngine(structured=True)")
        dfa = self.structured_compile(spec)
        if dfa is None:
            return False
        self._cursors.begin(slot, dfa, eos_id, prefix_tokens=prefix_tokens)
        self.structured_requests += 1
        return True

    @property
    def structured_slot_count(self) -> int:
        """Seated slots under an automaton constraint (host integers)."""
        return self._cursors.live_count if self._cursors is not None else 0

    @property
    def structured_masked_sum(self) -> float:
        """Cumulative masked-vocabulary fraction over committed cursor
        rows (the numerator of ``structured_masked_frac``)."""
        return self._cursors.masked_sum if self._cursors is not None \
            else 0.0

    @property
    def structured_masked_rows(self) -> int:
        return self._cursors.masked_rows if self._cursors is not None \
            else 0

    # ---- LoRA lanes ------------------------------------------------
    @torch.no_grad()
    def _lora_write_fn(self, lane: torch.Tensor, stacks: dict) -> None:
        """The one adapter writer: lane ``lane`` (a ``(1,)`` device
        tensor, a value) of all four stacks is overwritten in place."""
        for k, buf in self._lora_buf.items():
            buf.index_copy_(1, lane, stacks[k].to(buf.dtype)[:, None])

    def lora_load(self, lane: int, stacks: dict) -> None:
        """Write one adapter's host stacks (lane-less ``(n_layers,
        ...)``, already rank-padded by the registry) into device lane
        ``lane``."""
        if not self.lora:
            raise RuntimeError("lora_load() needs a PagedEngine(lora_rank="
                               "..., lora_max_live=...)")
        if not 1 <= lane <= self.lora_max_live:
            raise ValueError(f"lane {lane} out of range [1, "
                             f"{self.lora_max_live}] — lane 0 is the "
                             "reserved zero adapter")
        lane_t = torch.tensor([lane], device=self.device)
        new = {k: torch.as_tensor(np.asarray(stacks[k])).to(self.device)
               for k in self._lora_buf}
        self._lora_write_shapes.add(self._signature(
            {"lane": lane_t, **new}))
        with torch.profiler.record_function("lora_load"):
            self._lora_write_fn(lane_t, new)

    @property
    def lora_load_compiles(self) -> int:
        """Distinct operand-shape signatures of the adapter writer: 1
        whatever load/evict churn the registry drives, 0 before the first
        load and with LoRA off."""
        return len(self._lora_write_shapes)

    @property
    def adapter_slot_count(self) -> int:
        """Active slots decoding through a non-zero adapter lane."""
        if not self.lora:
            return 0
        return int(np.count_nonzero(self.tables.active
                                    & (self._slot_lanes > 0)))

    @property
    def branch_slot_count(self) -> int:
        """Active slots decoding as a fork branch b > 0."""
        return int(np.count_nonzero(self.tables.active
                                    & (self._branch_of > 0)))

    @property
    def decode_compiles(self) -> int:
        """Distinct decode-step operand-shape signatures seen — the
        fixed-shape contract's observable (stays 1 across churn)."""
        return len(self._decode_shapes)

    @property
    def verify_compiles(self) -> int:
        """Distinct verify-step operand-shape signatures (stays 1 across
        accept-length and slot churn; 0 when not speculative)."""
        return len(self._verify_shapes)

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill-chunk shape signatures (stays 1)."""
        return len(self._chunk_shapes)

    @property
    def promote_compiles(self) -> int:
        """Distinct promotion-write shape signatures: 1 whatever group
        sizes the demote/promote churn produces (fixed staging, pad lanes
        on the null page); 0 before the first host hit and without the
        spill tier."""
        return len(self._promote_shapes)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of eligible prompt pages served from the cache."""
        return self.prefix_hit_pages / max(self.prefix_lookup_pages, 1)

    def debug_stats(self) -> dict:
        """Engine introspection for ``GET /debug/engine`` (``engine.py:
        1875``): pool occupancy, prefix-cache and spill-tier stats, shape
        counts — host integers only, never a device read."""
        t = self.tables
        host = t.host_pool
        return {
            "backend": self.decode_backend,
            "tp": 1,
            "speculative": self.speculative,
            "spec_tree": self.spec_tree,
            "parallel_sampling": self.parallel,
            "quantized": self.quantized,
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "max_slots": self.max_slots,
            "pages_live": int(t.n_live_pages),
            "pages_free": int(t.n_free_pages),
            "pages_cached": int(t.n_cached_pages),
            "pages_available": int(t.n_available_pages),
            "pending_prefill_chunks": self.pending_chunk_count,
            "prefill_chunks": self.prefill_chunks,
            "prefix_hit_pages": self.prefix_hit_pages,
            "prefix_lookup_pages": self.prefix_lookup_pages,
            "prefix_hit_rate": round(self.prefix_hit_rate, 4),
            "host_spill": self.host_spill,
            "pages_host": int(t.n_host_pages),
            "spills": self.spills,
            "promotions": self.promotions,
            "host_hit_pages": self.host_hit_pages,
            "promoted_bytes": self.promoted_bytes,
            "host_bytes_used": int(host.used_bytes) if host else 0,
            "host_evictions": int(host.n_evictions) if host else 0,
            "spec_steps": self.spec_steps,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "forks": self.forks,
            "fork_pages": self.fork_pages,
            "cow_copies": self.cow_copies,
            "branch_slots": self.branch_slot_count,
            "structured": self.structured,
            "structured_requests": self.structured_requests,
            "structured_slots": self.structured_slot_count,
            "structured_schemas": len(self._sdfa_cache),
            "weights_dtype": weights_dtype(self.params),
            "weight_stream_bytes": weight_stream_bytes(self.params),
            "lora": self.lora,
            "lora_rank": self.lora_rank,
            "lora_max_live": self.lora_max_live,
            "adapters": (self.adapters.debug()
                         if self.adapters is not None else None),
            "compiles": {"decode": self.decode_compiles,
                         "prefill": self.prefill_compiles,
                         "verify": self.verify_compiles,
                         "promote": self.promote_compiles,
                         "lora_load": self.lora_load_compiles},
        }


__all__ = ["PagedEngine"]
