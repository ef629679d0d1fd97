"""Schema/regex -> token-level DFA compiler for constrained decoding.

The pipeline is classical and runs entirely on the host, once per
schema:

1. a JSON schema (bounded subset, below) or a raw regex pattern is
   lowered to a REGEX over characters (``schema_to_regex``);
2. the regex parses to an AST, compiles to a Thompson character NFA,
   and determinizes by subset construction into a :class:`CharDFA` —
   transitions are stored per RELEVANT character (any character the
   pattern mentions) plus one "every other character" target per
   state, so negated classes and ``.`` cost one edge, not an
   alphabet sweep;
3. :func:`token_dfa` lifts the character DFA to the model's
   VOCABULARY: walking every token's rendered string from every
   reachable DFA state yields a per-state boolean mask over token ids
   (``mask[s, t]`` — emitting token ``t`` at state ``s`` keeps the
   output a viable prefix of the language) and the matching
   next-state table. States from which no token can ever reach an
   accepting state are trimmed, so a non-accepting state always has
   at least one legal token and a dead end can only be an ACCEPTING
   state — where the cursor (state.py) turns on the EOS bit and
   nothing else.

The result is cached by schema FINGERPRINT (sha256 of the canonical
JSON spec) per engine, so serving a mixed-schema trace compiles each
distinct schema exactly once and per-request work is a dict hit.

Vocabulary abstraction: the compiler is generic over ``vocab`` — a
sequence mapping token id -> rendered string, where the empty string
marks an id that must never be emitted under ANY constraint (pad ids,
special ids). :func:`bytes_vocab` is the default byte-level rendering
(id ``i`` -> ``chr(i)`` for ``i < 256``, unrenderable above), which
is what the serving engine uses unless the operator supplies a real
tokenizer rendering.

Supported JSON-schema subset (loud ``ValueError`` outside it):
``enum`` / ``const`` (any scalar), ``type`` in ``string`` (with
``enum``, ``pattern``, ``minLength``/``maxLength``), ``integer``,
``number``, ``boolean``, ``null``, ``object`` (``properties`` emitted
in declaration order, no whitespace — canonical JSON), ``array``
(``items`` + ``minItems``/``maxItems``), and ``oneOf``/``anyOf``
alternation. ``response_format: {type: json_object}`` compiles to a
flat JSON object of string keys and scalar values.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Sequence

import numpy as np

# regex metacharacters outside character classes (escaped by
# :func:`regex_escape`; '-' matters only inside classes and is
# escaped there by construction)
_SPECIAL = set("\\.[](){}*+?|^$")

# hard caps keeping a hostile/degenerate schema from exploding the
# host-side automaton build — both fail loudly, never truncate
_MAX_NFA_STATES = 50_000
_MAX_REPEAT = 1_024


def regex_escape(text: str) -> str:
    """Escape ``text`` so the pattern matches it literally."""
    return "".join("\\" + c if c in _SPECIAL or c == "-" else c
                   for c in text)


# ---- regex AST ---------------------------------------------------
# nodes: ("lit", negated, frozenset(chars)) | ("seq", [nodes]) |
#        ("alt", [nodes]) | ("rep", node, lo, hi | None)

_CLASS_ESCAPES = {
    "d": (False, frozenset("0123456789")),
    "D": (True, frozenset("0123456789")),
    "w": (False, frozenset(
        "abcdefghijklmnopqrstuvwxyz"
        "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")),
    "W": (True, frozenset(
        "abcdefghijklmnopqrstuvwxyz"
        "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")),
    "s": (False, frozenset(" \t\n\r\f\v")),
    "S": (True, frozenset(" \t\n\r\f\v")),
}
_CHAR_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "f": "\f",
                 "v": "\v", "0": "\0"}


class _Parser:
    """Recursive-descent parser for the full-match regex subset.

    Anchors are implicit (the whole output must match), so ``^``/``$``
    are rejected loudly rather than silently re-anchored."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str) -> ValueError:
        return ValueError(
            f"regex error at position {self.i} in {self.p!r}: {msg}")

    def peek(self) -> str | None:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self):
        node = self.alt()
        if self.i != len(self.p):
            raise self.error(f"unexpected {self.p[self.i]!r}")
        return node

    def alt(self):
        parts = [self.seq()]
        while self.peek() == "|":
            self.take()
            parts.append(self.seq())
        return parts[0] if len(parts) == 1 else ("alt", parts)

    def seq(self):
        parts = []
        while self.peek() is not None and self.peek() not in "|)":
            parts.append(self.repeat())
        return ("seq", parts)

    def repeat(self):
        node = self.atom()
        while True:
            c = self.peek()
            if c == "*":
                self.take()
                node = ("rep", node, 0, None)
            elif c == "+":
                self.take()
                node = ("rep", node, 1, None)
            elif c == "?":
                self.take()
                node = ("rep", node, 0, 1)
            elif c == "{":
                node = self.braces(node)
            else:
                return node

    def braces(self, node):
        self.take()                               # '{'
        lo = self.number()
        hi = lo
        if self.peek() == ",":
            self.take()
            hi = None if self.peek() == "}" else self.number()
        if self.peek() != "}":
            raise self.error("malformed {m,n} quantifier")
        self.take()
        if hi is not None and hi < lo:
            raise self.error(f"bad repeat range {{{lo},{hi}}}")
        if lo > _MAX_REPEAT or (hi or 0) > _MAX_REPEAT:
            raise self.error(
                f"repeat bound exceeds the {_MAX_REPEAT} cap")
        return ("rep", node, lo, hi)

    def number(self) -> int:
        digits = ""
        while self.peek() is not None and self.peek().isdigit():
            digits += self.take()
        if not digits:
            raise self.error("expected a number")
        return int(digits)

    def atom(self):
        c = self.peek()
        if c is None:
            raise self.error("unexpected end of pattern")
        if c == "(":
            self.take()
            node = self.alt()
            if self.peek() != ")":
                raise self.error("unbalanced '('")
            self.take()
            return node
        if c == "[":
            return self.char_class()
        if c == ".":
            self.take()
            return ("lit", True, frozenset())     # any character
        if c == "\\":
            return ("lit", *self.escape())
        if c in "*+?{":
            raise self.error(f"quantifier {c!r} with nothing to repeat")
        if c in "^$":
            raise self.error(
                f"{c!r} is not supported: patterns are full-match, "
                "anchors are implicit")
        if c in ")]}":
            raise self.error(f"unbalanced {c!r}")
        self.take()
        return ("lit", False, frozenset(c))

    def escape(self) -> tuple[bool, frozenset]:
        self.take()                               # '\\'
        c = self.peek()
        if c is None:
            raise self.error("dangling escape")
        self.take()
        if c in _CLASS_ESCAPES:
            return _CLASS_ESCAPES[c]
        if c in _CHAR_ESCAPES:
            return (False, frozenset(_CHAR_ESCAPES[c]))
        if c in ("x", "u"):
            n = 2 if c == "x" else 4
            hexits = self.p[self.i:self.i + n]
            if len(hexits) != n \
                    or any(h not in "0123456789abcdefABCDEF"
                           for h in hexits):
                raise self.error(f"malformed \\{c} escape")
            self.i += n
            return (False, frozenset(chr(int(hexits, 16))))
        if c.isalnum():
            raise self.error(f"unsupported escape \\{c}")
        return (False, frozenset(c))              # escaped punctuation

    def char_class(self):
        self.take()                               # '['
        negated = self.peek() == "^"
        if negated:
            self.take()
        chars: set[str] = set()

        def item() -> str | None:
            c = self.peek()
            if c is None:
                raise self.error("unbalanced '['")
            if c == "\\":
                neg, s = self.escape()
                if neg or len(s) != 1:
                    # a class escape (\d, \w, ...) inside [...]:
                    # fold its members in; it cannot anchor a range
                    if neg:
                        raise self.error(
                            "negated escapes are not supported "
                            "inside character classes")
                    chars.update(s)
                    return None
                return next(iter(s))
            self.take()
            return c

        first = True
        while self.peek() != "]" or first and self.peek() is None:
            if self.peek() is None:
                raise self.error("unbalanced '['")
            if self.peek() == "]":
                break
            lo = item()
            first = False
            if lo is None:
                continue
            if self.peek() == "-" and self.p[self.i + 1:self.i + 2] \
                    not in ("]", ""):
                self.take()
                hi = item()
                if hi is None or ord(hi) < ord(lo):
                    raise self.error(f"bad range {lo!r}-{hi!r}")
                chars.update(chr(o) for o in range(ord(lo),
                                                   ord(hi) + 1))
            else:
                chars.add(lo)
        if self.peek() != "]":
            raise self.error("unbalanced '['")
        self.take()
        if not chars:
            raise self.error("empty character class")
        return ("lit", negated, frozenset(chars))


# ---- NFA + subset construction -----------------------------------
def _compile_nfa(node, nfa: list) -> tuple[int, int]:
    """Thompson construction: returns (start, accept) state ids.
    ``nfa[s]`` is a list of ``(symbol, target)`` edges — symbol None
    is epsilon, else ``(negated, frozenset)``."""

    def new() -> int:
        if len(nfa) >= _MAX_NFA_STATES:
            raise ValueError(
                f"pattern compiles past the {_MAX_NFA_STATES} NFA "
                "state cap — simplify the schema or bound its repeats")
        nfa.append([])
        return len(nfa) - 1

    kind = node[0]
    if kind == "lit":
        s, t = new(), new()
        nfa[s].append(((node[1], node[2]), t))
        return s, t
    if kind == "seq":
        s = t = new()
        for child in node[1]:
            cs, ct = _compile_nfa(child, nfa)
            nfa[t].append((None, cs))
            t = ct
        return s, t
    if kind == "alt":
        s, t = new(), new()
        for child in node[1]:
            cs, ct = _compile_nfa(child, nfa)
            nfa[s].append((None, cs))
            nfa[ct].append((None, t))
        return s, t
    if kind == "rep":
        _, child, lo, hi = node
        s = t = new()
        for _ in range(lo):                       # required copies
            cs, ct = _compile_nfa(child, nfa)
            nfa[t].append((None, cs))
            t = ct
        if hi is None:                            # Kleene tail
            cs, ct = _compile_nfa(child, nfa)
            nfa[t].append((None, cs))
            nfa[ct].append((None, cs))
            end = new()
            nfa[t].append((None, end))
            nfa[ct].append((None, end))
            return s, end
        for _ in range(hi - lo):                  # optional copies
            cs, ct = _compile_nfa(child, nfa)
            nfa[t].append((None, cs))
            end = new()
            nfa[t].append((None, end))
            nfa[ct].append((None, end))
            t = end
        return s, t
    raise AssertionError(f"unknown AST node {kind!r}")


def _matches(sym: tuple[bool, frozenset], ch: str) -> bool:
    negated, chars = sym
    return (ch in chars) != negated


@dataclass(frozen=True)
class CharDFA:
    """Deterministic character automaton with full-match semantics.

    ``trans[s]`` maps every RELEVANT character (one the pattern
    mentions) to a next state (-1 = dead); any other character falls
    through to ``other[s]``. States are trimmed co-accessible: from
    every live state some accepting state is reachable, so a -1 step
    is the only way to die."""

    start: int
    accepting: tuple
    trans: tuple
    other: tuple

    @property
    def n_states(self) -> int:
        return len(self.accepting)

    def step(self, state: int, ch: str) -> int:
        if state < 0:
            return -1
        row = self.trans[state]
        return row[ch] if ch in row else self.other[state]

    def matches(self, text: str) -> bool:
        state = self.start
        for ch in text:
            state = self.step(state, ch)
            if state < 0:
                return False
        return bool(self.accepting[state])

    def max_match_len(self) -> int | None:
        """Longest accepted string's length, or None when the
        language is unbounded (a cycle among live states) — the
        loadgen budget hint for library schemas."""
        WHITE, GRAY, BLACK = 0, 1, 2
        color = [WHITE] * self.n_states
        best: dict[int, int | None] = {}

        def targets(s: int) -> set[int]:
            out = {t for t in self.trans[s].values() if t >= 0}
            if self.other[s] >= 0:
                out.add(self.other[s])
            return out

        def dfs(s: int) -> int | None:
            # returns the longest suffix length from s, None = cycle
            if color[s] == GRAY:
                return None
            if color[s] == BLACK:
                return best[s]
            color[s] = GRAY
            longest = 0 if self.accepting[s] else -1
            for t in targets(s):
                sub = dfs(t)
                if sub is None:
                    best[s] = None
                    color[s] = BLACK
                    return None
                longest = max(longest, 1 + sub)
            color[s] = BLACK
            best[s] = longest
            return longest

        return dfs(self.start)


def _build_dfa(nfa: list, start: int, accept: int) -> CharDFA:
    relevant: set[str] = set()
    for edges in nfa:
        for sym, _ in edges:
            if sym is not None:
                relevant.update(sym[1])

    def closure(states: set[int]) -> frozenset:
        stack = list(states)
        seen = set(states)
        while stack:
            s = stack.pop()
            for sym, t in nfa[s]:
                if sym is None and t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    def move(states: frozenset, ch: str | None) -> set[int]:
        # ch None: the "any non-relevant character" pseudo-symbol —
        # a negated edge matches it (its listed chars are all
        # relevant), a positive edge never does
        out = set()
        for s in states:
            for sym, t in nfa[s]:
                if sym is None:
                    continue
                if (sym[0] if ch is None else _matches(sym, ch)):
                    out.add(t)
        return out

    start_set = closure({start})
    ids: dict[frozenset, int] = {start_set: 0}
    sets = [start_set]
    trans: list[dict[str, int]] = []
    other: list[int] = []
    i = 0
    while i < len(sets):
        cur = sets[i]
        i += 1
        row: dict[str, int] = {}
        for ch in relevant:
            nxt = closure(move(cur, ch))
            if not nxt:
                row[ch] = -1
                continue
            if nxt not in ids:
                ids[nxt] = len(sets)
                sets.append(nxt)
            row[ch] = ids[nxt]
        nxt = closure(move(cur, None))
        if not nxt:
            o = -1
        else:
            if nxt not in ids:
                ids[nxt] = len(sets)
                sets.append(nxt)
            o = ids[nxt]
        trans.append(row)
        other.append(o)
    accepting = [accept in s for s in sets]

    # co-accessibility trim: states that can never reach an accepting
    # state become -1 targets, so a live state's every legal character
    # keeps a full match possible
    n = len(sets)
    rev: list[set[int]] = [set() for _ in range(n)]
    for s in range(n):
        for t in trans[s].values():
            if t >= 0:
                rev[t].add(s)
        if other[s] >= 0:
            rev[other[s]].add(s)
    live = [False] * n
    stack = [s for s in range(n) if accepting[s]]
    for s in stack:
        live[s] = True
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if not live[p]:
                live[p] = True
                stack.append(p)
    if not live[0]:
        raise ValueError(
            "pattern matches nothing: no accepting state is "
            "reachable from the start")
    remap = {}
    for s in range(n):
        if live[s]:
            remap[s] = len(remap)
    f_trans = tuple(
        {ch: (remap[t] if t >= 0 and live[t] else -1)
         for ch, t in trans[s].items()}
        for s in range(n) if live[s])
    f_other = tuple(
        (remap[other[s]] if other[s] >= 0 and live[other[s]] else -1)
        for s in range(n) if live[s])
    f_acc = tuple(accepting[s] for s in range(n) if live[s])
    return CharDFA(start=remap[0], accepting=f_acc, trans=f_trans,
                   other=f_other)


_CHAR_DFA_CACHE: dict[str, CharDFA] = {}


def compile_regex(pattern: str) -> CharDFA:
    """Pattern -> trimmed character DFA (full-match semantics),
    cached by pattern text. Raises ``ValueError`` on syntax errors or
    an empty language."""
    dfa = _CHAR_DFA_CACHE.get(pattern)
    if dfa is None:
        nfa: list = []
        start, accept = _compile_nfa(_Parser(pattern).parse(), nfa)
        dfa = _build_dfa(nfa, start, accept)
        _CHAR_DFA_CACHE[pattern] = dfa
    return dfa


# ---- JSON schema -> regex ----------------------------------------
# canonical JSON pieces (no whitespace — what the generator emits and
# json.loads round-trips)
_STR_CHAR = r'([^\x00-\x1f"\\]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})'
_STR = f'"{_STR_CHAR}*"'
_INT = r"\-?(0|[1-9][0-9]*)"
_NUM = _INT + r"(\.[0-9]+)?([eE][\+\-]?[0-9]+)?"
_SCALAR = f"({_STR})|({_NUM})|(true)|(false)|(null)"
_MEMBER = f"({_STR}):({_SCALAR})"
JSON_OBJECT_PATTERN = (
    r"(\{\})|(\{" + _MEMBER + r"(," + _MEMBER + r")*\})")


def _json_literal(value) -> str:
    return regex_escape(json.dumps(
        value, separators=(",", ":"), ensure_ascii=True))


def schema_to_regex(schema: dict) -> str:
    """Lower a JSON schema (the bounded subset in the module doc) to
    a full-match regex over the CANONICAL rendering: properties in
    declaration order, no whitespace, ``ensure_ascii`` escapes.
    Raises ``ValueError`` on anything outside the subset."""
    if not isinstance(schema, dict):
        raise ValueError(
            f"schema must be an object, got {type(schema).__name__}")
    if "enum" in schema:
        values = schema["enum"]
        if not isinstance(values, list) or not values:
            raise ValueError("schema 'enum' must be a non-empty list")
        return "|".join(f"({_json_literal(v)})" for v in values)
    if "const" in schema:
        return _json_literal(schema["const"])
    if "oneOf" in schema or "anyOf" in schema:
        subs = schema.get("oneOf", schema.get("anyOf"))
        if not isinstance(subs, list) or not subs:
            raise ValueError(
                "schema 'oneOf'/'anyOf' must be a non-empty list")
        return "|".join(f"({schema_to_regex(s)})" for s in subs)
    t = schema.get("type")
    if t == "boolean":
        return "(true)|(false)"
    if t == "null":
        return "null"
    if t == "integer":
        return _INT
    if t == "number":
        return _NUM
    if t == "string":
        if "pattern" in schema:
            return f'"({schema["pattern"]})"'
        lo = schema.get("minLength", 0)
        hi = schema.get("maxLength")
        if not isinstance(lo, int) or lo < 0 \
                or (hi is not None and (not isinstance(hi, int)
                                        or hi < lo)):
            raise ValueError(
                f"bad string bounds minLength={lo!r} maxLength={hi!r}")
        rep = f"{{{lo},{hi}}}" if hi is not None else \
            (f"{{{lo},}}" if lo else "*")
        return f'"{_STR_CHAR}{rep}"'
    if t == "object":
        props = schema.get("properties", {})
        if not isinstance(props, dict):
            raise ValueError("schema 'properties' must be an object")
        if not props:
            return r"\{\}"
        members = ":".join(())  # keep linters quiet about f-string
        members = ",".join(
            f"{_json_literal(k)}:({schema_to_regex(v)})"
            for k, v in props.items())
        return r"\{" + members + r"\}"
    if t == "array":
        items = schema.get("items")
        if not isinstance(items, dict):
            raise ValueError(
                "schema arrays need an 'items' sub-schema")
        item = f"({schema_to_regex(items)})"
        lo = schema.get("minItems", 0)
        hi = schema.get("maxItems")
        if not isinstance(lo, int) or lo < 0 \
                or (hi is not None and (not isinstance(hi, int)
                                        or hi < max(lo, 1))):
            raise ValueError(
                f"bad array bounds minItems={lo!r} maxItems={hi!r}")
        tail = f"(,{item})"
        rep = f"{{{max(lo - 1, 0)},{hi - 1}}}" if hi is not None \
            else (f"{{{lo - 1},}}" if lo > 1 else "*")
        body = r"\[" + item + tail + rep + r"\]"
        return body if lo >= 1 else f"(\\[\\])|({body})"
    raise ValueError(
        f"unsupported JSON-schema: type={t!r} (supported: enum/const/"
        "oneOf/anyOf and type string|integer|number|boolean|null|"
        "object|array)")


# ---- response_format parsing -------------------------------------
RESPONSE_FORMAT_TYPES = ("text", "json_object", "json_schema",
                         "regex")


def response_format_regex(spec: dict) -> str | None:
    """The character pattern a ``response_format`` spec constrains
    output to — None for ``{"type": "text"}`` (unconstrained).
    Accepts both the OpenAI nesting (``{"type": "json_schema",
    "json_schema": {"schema": {...}}}``) and a direct ``schema`` key.
    Raises ``ValueError`` (the front door's 400) on an unknown type
    or a malformed/unsupported schema."""
    if not isinstance(spec, dict):
        raise ValueError(
            f"response_format must be an object, got "
            f"{type(spec).__name__}")
    t = spec.get("type")
    if t not in RESPONSE_FORMAT_TYPES:
        raise ValueError(
            f"unknown response_format.type {t!r} (expected one of "
            f"{', '.join(RESPONSE_FORMAT_TYPES)})")
    if t == "text":
        return None
    if t == "json_object":
        return JSON_OBJECT_PATTERN
    if t == "regex":
        pattern = spec.get("pattern")
        if not isinstance(pattern, str) or not pattern:
            raise ValueError(
                "response_format type 'regex' needs a non-empty "
                "'pattern' string")
        return pattern
    schema = spec.get("schema")
    if schema is None and isinstance(spec.get("json_schema"), dict):
        schema = spec["json_schema"].get("schema")
    if schema is None:
        raise ValueError(
            "response_format type 'json_schema' needs a schema under "
            "'schema' or 'json_schema.schema'")
    return schema_to_regex(schema)


def validate_response_format(spec: dict) -> None:
    """Syntactic + compilability validation WITHOUT a vocabulary —
    what the front door runs before queueing (400 on ValueError): the
    spec's type/shape, the schema subset, and the character-level
    automaton (so a regex that matches nothing is rejected at the
    door, not at seat time)."""
    pattern = response_format_regex(spec)
    if pattern is not None:
        compile_regex(pattern)


def response_format_fingerprint(spec: dict) -> str:
    """Stable identity of a spec: sha256 over its canonical JSON.
    The per-engine TokenDFA cache keys on this, and the loadgen v3
    workload fingerprint folds it in for structured requests."""
    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---- token-level DFA ---------------------------------------------
def bytes_vocab(vocab_size: int) -> list[str]:
    """The default byte-level rendering: id ``i`` -> ``chr(i)`` for
    ``i < 256``, unrenderable ("" — never legal under a constraint)
    above."""
    return [chr(i) if i < 256 else "" for i in range(vocab_size)]


@dataclass
class TokenDFA:
    """Per-state token legality over a fixed vocabulary.

    ``mask[s]`` is the boolean legal-token row at state ``s`` (EOS
    excluded — the cursor overlays the EOS bit from ``accepting``);
    ``nxt[s, t]`` the state after emitting token ``t`` (-1 illegal).
    Token-level trimmed: a non-accepting state always has at least
    one legal token, so forced termination can only happen at an
    accepting state (EOS-only row)."""

    fingerprint: str
    start: int
    mask: np.ndarray       # (n_states, vocab) bool
    nxt: np.ndarray        # (n_states, vocab) int16
    accepting: np.ndarray  # (n_states,) bool

    @property
    def n_states(self) -> int:
        return int(self.mask.shape[0])

    @property
    def vocab_size(self) -> int:
        return int(self.mask.shape[1])


def token_dfa(cdfa: CharDFA, vocab: Sequence[str],
              fingerprint: str = "", max_states: int = 512
              ) -> TokenDFA:
    """Lift a character DFA to token-id mask tables over ``vocab``.

    Only character-DFA states REACHABLE by whole-token walks
    materialize (bounded by ``max_states`` — a loud failure, never a
    truncation). Raises ``ValueError`` when the constraint is
    unsatisfiable under this vocabulary (e.g. a schema needing a
    character no token renders)."""
    V = len(vocab)
    states = [cdfa.start]
    index = {cdfa.start: 0}
    rows_mask: list[np.ndarray] = []
    rows_nxt: list[np.ndarray] = []
    i = 0
    while i < len(states):
        cs = states[i]
        i += 1
        m = np.zeros(V, bool)
        nx = np.full(V, -1, np.int16)
        for tid in range(V):
            tok = vocab[tid]
            if not tok:
                continue
            s = cs
            for ch in tok:
                s = cdfa.step(s, ch)
                if s < 0:
                    break
            if s < 0:
                continue
            if s not in index:
                if len(states) >= max_states:
                    raise ValueError(
                        f"schema needs more than {max_states} "
                        "token-DFA states — simplify it or raise "
                        "the cap")
                index[s] = len(states)
                states.append(s)
            m[tid] = True
            nx[tid] = index[s]
        rows_mask.append(m)
        rows_nxt.append(nx)
    mask = np.stack(rows_mask)
    nxt = np.stack(rows_nxt)
    accepting = np.array([cdfa.accepting[s] for s in states], bool)

    # token-level trim: a state is alive iff accepting or some legal
    # token leads to an alive state — kill transitions into dead
    # states so the ONLY dead end is an accepting state (EOS-only)
    alive = accepting.copy()
    changed = True
    while changed:
        changed = False
        for s in range(len(states)):
            if alive[s]:
                continue
            tgt = nxt[s][mask[s]]
            if tgt.size and alive[tgt].any():
                alive[s] = True
                changed = True
    if not alive[0]:
        raise ValueError(
            "constraint is unsatisfiable under this vocabulary: no "
            "token sequence reaches an accepting state")
    for s in range(len(states)):
        legal = mask[s]
        dead_tgt = legal & ~alive[np.clip(nxt[s], 0, len(states) - 1)]
        if dead_tgt.any():
            mask[s] = legal & ~dead_tgt
            nxt[s][dead_tgt] = -1
    return TokenDFA(fingerprint=fingerprint, start=0, mask=mask,
                    nxt=nxt, accepting=accepting)


def compile_response_format(spec: dict, vocab: Sequence[str],
                            cache: dict | None = None
                            ) -> TokenDFA | None:
    """spec -> :class:`TokenDFA` (None for type ``text``), through
    ``cache`` keyed by the spec fingerprint when given — the
    per-engine mixed-schema path compiles each distinct schema
    once."""
    pattern = response_format_regex(spec)
    if pattern is None:
        return None
    fp = response_format_fingerprint(spec)
    if cache is not None and fp in cache:
        return cache[fp]
    dfa = token_dfa(compile_regex(pattern), vocab, fingerprint=fp)
    if cache is not None:
        cache[fp] = dfa
    return dfa


# ---- conformance (bench/test side) -------------------------------
def _check_value(schema: dict, value) -> bool:
    if "enum" in schema:
        return any(type(v) is type(value) and v == value
                   for v in schema["enum"])
    if "const" in schema:
        c = schema["const"]
        return type(c) is type(value) and c == value
    if "oneOf" in schema or "anyOf" in schema:
        subs = schema.get("oneOf", schema.get("anyOf"))
        return any(_check_value(s, value) for s in subs)
    t = schema.get("type")
    if t == "boolean":
        return isinstance(value, bool)
    if t == "null":
        return value is None
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if t == "number":
        return isinstance(value, (int, float)) \
            and not isinstance(value, bool)
    if t == "string":
        if not isinstance(value, str):
            return False
        lo = schema.get("minLength", 0)
        hi = schema.get("maxLength")
        return len(value) >= lo and (hi is None or len(value) <= hi)
    if t == "object":
        props = schema.get("properties", {})
        return (isinstance(value, dict)
                and set(value) == set(props)
                and all(_check_value(v, value[k])
                        for k, v in props.items()))
    if t == "array":
        if not isinstance(value, list):
            return False
        lo = schema.get("minItems", 0)
        hi = schema.get("maxItems")
        if len(value) < lo or (hi is not None and len(value) > hi):
            return False
        return all(_check_value(schema["items"], v) for v in value)
    return False


def conforms(spec: dict, text: str) -> bool:
    """Does ``text`` (the decoded completion, EOS stripped) satisfy
    its ``response_format``? The bench's conformance gate and the
    e2e tests both call this — it is independent of the automaton
    (regex specs use the character DFA; JSON specs parse with the
    stdlib and validate structurally), so a compiler bug cannot
    vacuously pass its own output."""
    t = spec.get("type")
    if t == "text":
        return True
    if t == "regex":
        return compile_regex(spec["pattern"]).matches(text)
    try:
        value = json.loads(text)
    except ValueError:
        return False
    if t == "json_object":
        return isinstance(value, dict)
    schema = spec.get("schema")
    if schema is None and isinstance(spec.get("json_schema"), dict):
        schema = spec["json_schema"].get("schema")
    return _check_value(schema, value)


# ---- the loadgen schema library ----------------------------------
# Every entry is BOUNDED (its DFA is acyclic), so a constrained
# request with budget >= schema_budget(id) always terminates at an
# accepting state with EOS forced — the conformance-rate-1.0 contract
# the serve_structured bench gates on.
SCHEMA_LIBRARY: dict[str, dict] = {
    "enum_color": {"enum": ["red", "green", "blue"]},
    "bool_flag": {"type": "object",
                  "properties": {"ok": {"type": "boolean"}}},
    "label_score": {"type": "object",
                    "properties": {
                        "label": {"enum": ["a", "b", "c"]},
                        "score": {"enum": [0, 1, 2, 3]}}},
    "verdict": {"type": "object",
                "properties": {
                    "answer": {"type": "boolean"},
                    "confidence": {"enum": ["low", "mid", "high"]}}},
    "tags": {"type": "array", "items": {"enum": ["x", "y"]},
             "minItems": 1, "maxItems": 3},
}


def library_response_format(schema_id: str) -> dict:
    """A library schema id -> the full ``response_format`` dict a
    request carries (what capture/replay ship over the wire)."""
    if schema_id not in SCHEMA_LIBRARY:
        raise ValueError(
            f"unknown schema id {schema_id!r} (library: "
            f"{', '.join(sorted(SCHEMA_LIBRARY))})")
    return {"type": "json_schema",
            "json_schema": {"schema": SCHEMA_LIBRARY[schema_id]}}


def schema_budget(schema_id: str) -> int:
    """Token budget guaranteeing termination for a library schema:
    its longest accepted string in characters (every token renders
    >= 1 character) + 1 for the forced EOS."""
    pattern = schema_to_regex(SCHEMA_LIBRARY[schema_id])
    longest = compile_regex(pattern).max_match_len()
    if longest is None:
        raise ValueError(
            f"library schema {schema_id!r} is unbounded — library "
            "entries must compile to acyclic automata")
    return longest + 1


__all__ = [
    "CharDFA", "TokenDFA", "JSON_OBJECT_PATTERN",
    "RESPONSE_FORMAT_TYPES", "SCHEMA_LIBRARY", "bytes_vocab",
    "compile_regex", "compile_response_format", "conforms",
    "library_response_format", "regex_escape",
    "response_format_fingerprint", "response_format_regex",
    "schema_budget", "schema_to_regex", "token_dfa",
    "validate_response_format",
]
