"""Per-slot automaton cursors for constrained decoding.

:class:`SlotCursors` is the host-side mirror of the drafter's
per-slot state: one token-DFA cursor per constrained slot, advanced
at exactly the sites the engine calls ``drafter.observe`` — prefill
completion, every decode step, every accepted speculative burst —
and reset at retire. Its single device-facing product is ``mask``, a
fixed-shape ``(max_slots, vocab)`` boolean array: row ``s`` is the
legal-token set for slot ``s``'s NEXT emission (all-True for
unconstrained slots, so masking is a bitwise no-op there and
unconstrained streams stay token-exact). The engine ships it into
the compiled decode/verify steps as a trailing VALUE operand — the
shape depends only on pool geometry, so the zero-recompile contract
holds and cold engines keep byte-identical signatures.

EOS discipline: the token DFA never marks the EOS id legal (the
compiler rejects schemas whose alphabet collides with it); instead
each row's EOS bit is the current state's ACCEPTING flag. A
non-accepting state always has at least one legal token (token-level
trim), and a dead-end accepting state yields an EOS-only row — the
forced stop that makes bounded schemas terminate, and with it the
100% conformance guarantee.

Parallel sampling: ``fork_child`` REBASES a child branch to the DFA
start state; the engine then observes the child's own first token.
The parent's cursor already sits one token past start (prefill
observed branch 0's first token), so every branch's cursor replays
exactly the independent single-slot run with its seed — the CoW
token-parity contract extended to automaton state. Preemption:
``begin(prefix_tokens=...)`` replays the folded generated tokens, so
a re-seated slot resumes at the exact automaton state it was
preempted in.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from torchbooster_tpu_torch.serving.structured.compiler import TokenDFA


class SlotCursors:
    """One automaton cursor per constrained slot + the fused mask.

    Accounting: every committed-row refresh adds its masked fraction
    (share of the vocabulary the constraint forbids, EOS bit
    included) to ``masked_sum``/``masked_rows`` — the
    ``serving_structured_masked_frac`` gauge's numerator and
    denominator. Verify-time draft rows are working copies and are
    not counted."""

    def __init__(self, max_slots: int, vocab_size: int):
        self._V = int(vocab_size)
        self._mask = np.ones((int(max_slots), self._V), bool)
        # slot -> {"dfa": TokenDFA, "eos": int, "state": int}
        # state -1 = done (EOS observed): row is EOS-only
        self._cur: dict[int, dict] = {}
        self.masked_sum = 0.0
        self.masked_rows = 0

    # -- introspection ---------------------------------------------
    @property
    def mask(self) -> np.ndarray:
        """The fused ``(max_slots, vocab)`` legality mask — the
        decode step's trailing operand. Unconstrained rows are
        all-True."""
        return self._mask

    @property
    def live_count(self) -> int:
        return len(self._cur)

    def active(self, slot: int) -> bool:
        return slot in self._cur

    def state_of(self, slot: int) -> int:
        """Current DFA state (-1 = done) — test/debug seam."""
        return self._cur[slot]["state"]

    # -- row construction ------------------------------------------
    def _row_at(self, cur: dict, state: int) -> np.ndarray:
        if state < 0:
            row = np.zeros(self._V, bool)
            row[cur["eos"]] = True
            return row
        dfa: TokenDFA = cur["dfa"]
        row = dfa.mask[state].copy()
        row[cur["eos"]] = bool(dfa.accepting[state])
        return row

    def _refresh(self, slot: int) -> None:
        cur = self._cur[slot]
        row = self._row_at(cur, cur["state"])
        self._mask[slot] = row
        # plain-int arithmetic: this is deliberate host bookkeeping,
        # not a device sync
        legal = int(np.count_nonzero(row))
        self.masked_sum += 1.0 - legal / self._V
        self.masked_rows += 1

    def start_row(self, slot: int) -> np.ndarray:
        """The legality row at the DFA START state (with its EOS
        bit) — what ``fork()`` masks the stashed prefill logits with
        before each child branch's first pick."""
        cur = self._cur[slot]
        return self._row_at(cur, cur["dfa"].start)

    # -- lifecycle -------------------------------------------------
    def begin(self, slot: int, dfa: TokenDFA, eos_id: int,
              prefix_tokens: Sequence[int] = ()) -> None:
        """Bind a cursor at seat time. ``prefix_tokens`` are the
        already-generated tokens a preempted request folded into its
        prompt — replaying them restores the automaton state
        token-exactly."""
        if not 0 <= int(eos_id) < self._V:
            raise ValueError(
                f"eos_id {eos_id} outside the vocabulary "
                f"(size {self._V})")
        if bool(dfa.mask[:, int(eos_id)].any()):
            raise ValueError(
                f"eos_id {eos_id} renders a character the schema can "
                "emit — the EOS bit would shadow a legal content "
                "token; pick an EOS id outside the schema alphabet")
        self._cur[slot] = {"dfa": dfa, "eos": int(eos_id),
                           "state": dfa.start}
        self.observe(slot, prefix_tokens)   # ends with a refresh

    def observe(self, slot: int, tokens: Sequence[int]) -> None:
        """Advance on committed tokens (the engine's post-accept
        hook, same sites as ``drafter.observe``). EOS moves the
        cursor to done; anything after EOS in the same burst is
        ignored — the batcher drops those tokens too. An illegal
        token raises: with masking in the sampling path it means a
        threading bug, and silently desyncing the automaton would
        turn it into garbage masks."""
        cur = self._cur.get(slot)
        if cur is None:
            return
        for tok in tokens:
            tok = int(tok)
            if cur["state"] < 0:
                break
            if tok == cur["eos"]:
                dfa: TokenDFA = cur["dfa"]
                if not bool(dfa.accepting[cur["state"]]):
                    raise ValueError(
                        f"slot {slot}: EOS at a non-accepting "
                        "automaton state — the mask was not applied "
                        "to the step that emitted it")
                cur["state"] = -1
                continue
            nxt = int(cur["dfa"].nxt[cur["state"], tok])
            if nxt < 0:
                raise ValueError(
                    f"slot {slot}: token {tok} is not a legal "
                    "continuation at automaton state "
                    f"{cur['state']} — the mask was not applied to "
                    "the step that emitted it")
            cur["state"] = nxt
        self._refresh(slot)

    def fork_child(self, parent: int, child: int) -> None:
        """Bind ``child`` to the parent's automaton REBASED to the
        start state (branch streams diverge from the first generated
        token; the engine observes the child's own pick next)."""
        cur = self._cur[parent]
        self._cur[child] = {"dfa": cur["dfa"], "eos": cur["eos"],
                            "state": cur["dfa"].start}
        self._refresh(child)

    def reset(self, slot: int) -> None:
        """Retire hook: drop the cursor, restore the all-True row."""
        if self._cur.pop(slot, None) is not None:
            self._mask[slot] = True

    # -- speculative pre-validation --------------------------------
    def draft_rows(self, slot: int, draft: Sequence[int]
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Chain-draft pre-validation: walk ``draft`` from the
        cursor; the first illegal/EOS/sentinel token truncates the
        rest to -1 (the verify kernel's never-accept sentinel), so
        verify cannot accept an illegal branch. Returns the
        truncated draft and the ``(k+1, vocab)`` legality rows for
        verify positions 0..k — position j is the state after j
        accepted draft tokens; rows past the legal prefix repeat the
        last valid row (their picks are unreachable: acceptance
        stops at the first sentinel)."""
        cur = self._cur[slot]
        k = len(draft)
        d = np.asarray(draft, np.int32).copy()
        rows = np.empty((k + 1, self._V), bool)
        state = cur["state"]
        rows[0] = self._row_at(cur, state)
        for j in range(k):
            tok = int(d[j])
            nxt = -1
            if state >= 0 and tok >= 0 and tok != cur["eos"]:
                nxt = int(cur["dfa"].nxt[state, tok])
            if nxt < 0:
                d[j:] = -1
                rows[j + 1:] = rows[j]
                return d, rows
            state = nxt
            rows[j + 1] = self._row_at(cur, state)
        return d, rows

    def tree_rows(self, slot: int, draft: Sequence[int],
                  parents: Sequence[int]
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Tree-draft pre-validation: node j hangs off node
        ``parents[j]`` (node 0 = the pending token, node i>=1 =
        draft i-1). A node whose parent is pruned or whose token is
        illegal at the parent's state is pruned (token -> -1), which
        transitively prunes its subtree — verify never accepts into
        an illegal branch. Row j+1 is the state after node j's path
        (pruned nodes reuse the root row; they can never be the
        bonus position)."""
        cur = self._cur[slot]
        k = len(draft)
        d = np.asarray(draft, np.int32).copy()
        rows = np.empty((k + 1, self._V), bool)
        node_state: list[int | None] = [cur["state"]] + [None] * k
        if cur["state"] < 0:
            node_state[0] = None
        rows[0] = self._row_at(cur, cur["state"])
        for j in range(k):
            parent_state = node_state[int(parents[j])]
            tok = int(d[j])
            nxt = -1
            if parent_state is not None and parent_state >= 0 \
                    and tok >= 0 and tok != cur["eos"]:
                nxt = int(cur["dfa"].nxt[parent_state, tok])
            if nxt < 0:
                d[j] = -1
                node_state[j + 1] = None
                rows[j + 1] = rows[0]
            else:
                node_state[j + 1] = nxt
                rows[j + 1] = self._row_at(cur, nxt)
        return d, rows


__all__ = ["SlotCursors"]
