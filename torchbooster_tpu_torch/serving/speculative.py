"""Speculative decoding for the paged serving engine — the port of
``torchbooster_tpu/serving/speculative.py``: draft, then one batched
verify step, then accept.

Every non-speculative decode step reads the slots' live pages once to
produce ONE token per slot. Speculative decoding proposes ``k`` tokens
per slot, scores all ``k + 1`` positions in ONE multi-token verify
step, keeps the longest model-confirmed prefix and emits one extra
fallback or bonus token: ``E[accepted] + 1`` tokens per step for about
one step's page reads.

- :class:`PromptLookupDrafter` — model-free drafting by prompt lookup
  (an n-gram match over the slot's own prompt and emitted tokens), host
  numpy; :class:`TreeLookupDrafter` drafts a tree of branches where the
  history is ambiguous. Both are copied from the JAX package.
- :func:`make_verify_fn` — the engine's multi-token verify step: all
  ``k + 1`` positions' K/V are written into the slot's (always private)
  pages FIRST, then read back in pool dtype by the paged flash-decode
  kernel (B4, ``ops/paged_attention.py``, S = ``k + 1`` query rows a
  slot) or the pool sweep, so every verified position attends the same
  bytes a sequence of non-speculative steps would have read, and greedy
  parity is exact. ``k`` is fixed and short drafts are ``NO_DRAFT``
  padded, so the step's operand shapes never change
  (``PagedEngine.verify_compiles`` stays 1).
- acceptance — :func:`accept_count` / :func:`tree_accept_path` (host)
  over the rule of ``models/gpt.py`` ``_make_spec_pick``. Rejected
  positions are rewound by not advancing over them: their K/V sits past
  ``lengths``, invisible to every mask and overwritten by the next step.
"""
from __future__ import annotations

import numpy as np

from torchbooster_tpu_torch.models.gpt import _make_spec_pick

# "no proposal" marker in a fixed-width draft row: never accepted (ids
# are non-negative), and its fallback pick is an ordinary one, so an
# empty draft IS a plain one-token decode through the same step
NO_DRAFT = -1


class PromptLookupDrafter:
    """Per-slot prompt-lookup drafting state.

    ``begin(slot, prompt)`` seeds a slot's token stream, ``observe(slot,
    tokens)`` appends emitted tokens, ``reset(slot)`` drops it,
    ``draft(slot)`` proposes up to ``draft_len`` tokens: the longest
    suffix n-gram of the stream (``ngram_max`` down to ``ngram_min``) is
    searched for an EARLIER occurrence, the most recent match wins, and
    the tokens that followed it are the draft (``NO_DRAFT``-padded). The
    match scans at most the last ``lookback`` tokens."""

    def __init__(self, draft_len: int, ngram_min: int = 2,
                 ngram_max: int = 8, lookback: int = 4096):
        if draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {draft_len}")
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"ngram_min={ngram_min}, ngram_max={ngram_max}")
        if lookback < ngram_max + draft_len:
            raise ValueError(
                f"lookback ({lookback}) shorter than one match + "
                f"continuation (ngram_max={ngram_max} + "
                f"draft_len={draft_len}) can never draft")
        self.draft_len = draft_len
        self.ngram_min = ngram_min
        self.ngram_max = ngram_max
        self.lookback = lookback
        self._streams: dict[int, list[int]] = {}

    def begin(self, slot: int, prompt: np.ndarray) -> None:
        self._streams[slot] = [int(t) for t in np.asarray(prompt)]

    def observe(self, slot: int, tokens) -> None:
        if slot in self._streams:
            self._streams[slot].extend(int(t) for t in tokens)

    def reset(self, slot: int) -> None:
        self._streams.pop(slot, None)

    def _matches(self, slot: int):
        """``(history, n, hits)`` of the longest suffix n-gram with an
        earlier occurrence, or None."""
        stream = self._streams.get(slot)
        if not stream or len(stream) < self.ngram_min + 1:
            return None
        h = np.asarray(stream[-self.lookback:], np.int32)
        hi = min(self.ngram_max, len(h) - 1)
        for n in range(hi, self.ngram_min - 1, -1):
            # candidate starts 0 .. len-n-1: the window ends before the
            # stream's last token, so a continuation token exists
            m = len(h) - n
            if m <= 0:
                continue
            win = np.lib.stride_tricks.sliding_window_view(h, n)[:m]
            hits = np.flatnonzero((win == h[-n:]).all(axis=1))
            if hits.size:
                return h, n, hits
        return None

    def draft(self, slot: int) -> np.ndarray:
        """``(draft_len,)`` int32 proposal for the slot's next tokens."""
        out = np.full(self.draft_len, NO_DRAFT, np.int32)
        found = self._matches(slot)
        if found is not None:
            h, n, hits = found
            s = int(hits[-1])
            cont = h[s + n:s + n + self.draft_len]
            out[:len(cont)] = cont
        return out


class TreeLookupDrafter(PromptLookupDrafter):
    """Prompt-lookup drafting over a TREE of branches: the history's
    matches are grouped by their FIRST continuation token, and up to
    ``width`` distinct continuations each get a branch off the root
    (most recent first; side branches ``max(1, draft_len // (2 *
    width))`` nodes, the primary the rest). With one continuation the
    tree is the linear drafter's chain bit for bit.

    ``draft_tree(slot)`` returns ``(tokens, parents)``: draft node ``j``
    (verify input ``j + 1``) hangs off node ``parents[j] ∈ [0, j]``, node
    0 being the root (the pending token). Siblings carry distinct
    tokens, so at most one child of a node can be accepted."""

    def __init__(self, draft_len: int, ngram_min: int = 2,
                 ngram_max: int = 8, lookback: int = 4096,
                 width: int = 2):
        super().__init__(draft_len, ngram_min=ngram_min,
                         ngram_max=ngram_max, lookback=lookback)
        if not 2 <= width <= draft_len:
            raise ValueError(
                f"tree width must satisfy 2 <= width <= draft_len "
                f"({draft_len}), got {width}: one branch is the linear "
                "drafter, and every branch needs a node")
        self.width = width

    def draft_tree(self, slot: int) -> tuple[np.ndarray, np.ndarray]:
        k = self.draft_len
        tokens = np.full(k, NO_DRAFT, np.int32)
        # chain parents by default: a sentinel-only row still carries a
        # valid topology
        parents = np.arange(k, dtype=np.int32)
        found = self._matches(slot)
        if found is None:
            return tokens, parents
        h, n, hits = found
        groups: dict[int, int] = {}
        for s_i in hits[::-1]:
            c0 = int(h[int(s_i) + n])
            if c0 not in groups:
                groups[c0] = int(s_i)
            if len(groups) == self.width:
                break
        w = len(groups)
        side = max(1, k // (2 * w)) if w > 1 else 0
        node = 1
        for b, s_i in enumerate(groups.values()):
            depth = (k - side * (w - 1)) if b == 0 else side
            parent = 0
            for t in h[s_i + n:s_i + n + depth]:
                tokens[node - 1] = int(t)
                parents[node - 1] = parent
                parent = node
                node += 1
        return tokens, parents


def accept_count(accept_row: np.ndarray) -> int:
    """Length of the leading accepted prefix of one slot's verify result
    — the ``a`` of draft → verify → emit ``draft[:a] + [token[a]]``."""
    rej = np.flatnonzero(~np.asarray(accept_row, bool))
    return int(rej[0]) if rej.size else len(accept_row)


def tree_masks(parents: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """From per-slot parent vectors ``(n_slots, k)`` build ``depth
    (n_slots, S)`` — each node's distance from the root, its rope and
    embedding offset — and ``vis (n_slots, S, S)``, the ancestor-or-self
    matrix (``vis[s, j, i]``: node i's K/V is visible to node j), ``S =
    k + 1``. The chain gives ``depth = arange`` and ``vis[j, i] = i <=
    j``, the linear masks."""
    parents = np.asarray(parents, np.int32)
    n_slots, k = parents.shape
    S = k + 1
    depth = np.zeros((n_slots, S), np.int32)
    vis = np.zeros((n_slots, S, S), bool)
    vis[:, 0, 0] = True
    rows = np.arange(n_slots)
    for j in range(1, S):
        p = parents[:, j - 1]
        depth[:, j] = depth[rows, p] + 1
        vis[:, j] = vis[rows, p]
        vis[rows, j, j] = True
    return depth, vis


def tree_accept_path(accept_row: np.ndarray,
                     parents_row: np.ndarray) -> list[int]:
    """The unique accepted root-to-leaf path of one slot's tree verify
    result, as node indices (empty: nothing accepted, the bonus pick
    comes from the root). On the chain it is ``1 .. accept_count``."""
    accept_row = np.asarray(accept_row, bool)
    parents_row = np.asarray(parents_row, np.int64)
    path: list[int] = []
    cur = 0
    while True:
        nxt = next((j + 1 for j in range(len(parents_row))
                    if parents_row[j] == cur and accept_row[j]), None)
        if nxt is None:
            return path
        path.append(nxt)
        cur = nxt


def make_verify_fn(engine):
    """The engine's multi-token verify step (``speculative.py:300``).

    ``fn(tables, lengths, refs, page_pos, active, in_ids, work=None,
    tree=None) -> (accept, token)``: ``in_ids (max_slots, 1 + k)`` holds
    each slot's pending token then its ``NO_DRAFT``-padded draft;
    ``work`` is the kernel backend's live-page walk; ``tree`` the tree
    mode's ``(parents (B, k), depth (B, S), vis (B, S, S))``. Node ``j``
    writes its K/V at storage position ``lengths + j`` but ropes and
    embeds at ``lengths + depth[j]`` and attends prior context plus its
    ancestors; on the chain both are ``lengths + j``. The forward is the
    engine's (``PagedEngine._forward_fn``, whose S = 1 case is the decode
    step), the pick ``_make_spec_pick``; ``accept`` is ``(B, k)`` bool,
    ``token`` ``(B, 1 + k)``."""
    spec_pick = _make_spec_pick(engine.temperature, engine.top_k,
                                engine.top_p)

    def verify_fn(tables, lengths, refs, page_pos, active, in_ids,
                  work=None, tree=None):
        parents, depth, vis = tree if tree is not None else (None,) * 3
        logits = engine._forward_fn(in_ids, tables, lengths, refs,
                                    page_pos, active, work, depth=depth,
                                    tree_vis=vis)
        return spec_pick(engine._gen, logits, in_ids[:, 1:], parent=parents)

    return verify_fn


__all__ = ["NO_DRAFT", "PromptLookupDrafter", "TreeLookupDrafter",
           "accept_count", "make_verify_fn", "tree_accept_path",
           "tree_masks"]
