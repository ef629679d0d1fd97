"""Versioned workload format: the one trace shape every load source
and every driver speak — a copy of
``torchbooster_tpu/serving/loadgen/workload.py`` (fingerprints and saved
files are the JAX module's byte for byte).

ROADMAP item 2 names the gap: every perf claim so far rode ad-hoc
Poisson loops coded inside ``bench.py`` — scheduling quality is
invisible under uniform synthetic arrivals, so an SLO-scheduler win
measured there proves little about production traffic. The fix (the
MLPerf-Inference / Orca-style methodology) is capture-then-replay:
record what the front door actually served, then re-offer the
IDENTICAL trace — at ×1 for apples-to-apples A/Bs, compressed ×N for
stress — and let synthetic generators emit the SAME format so one
driver (loadgen/replay.py) serves both.

One JSONL file per workload: a header line
(``{"event": "workload_header", "version": 3, ...}``) then one
``workload_request`` line per request — arrival offset (seconds from
trace start), prompt token ids OR a ``seed``+``length`` recipe
(privacy-scrubbed captures never persist prompt content), priority
class, ``deadline_ms``, ``max_new_tokens``, ``eos_id``, optional
parallel-sampling ``n``/``best_of`` (v2; absent fields mean ``n=1``
and v1 files still load), an optional structured-generation
``response_format`` (v3; absent means unconstrained, and the
fingerprint folds it in only when set so v1/v2 recorded fingerprints
keep verifying), and the client-behavior events:
``cancel_after_tokens`` (the client disconnected after consuming N
tokens — replay re-issues the disconnect at the same token offset)
and ``disconnect_s`` (the recorded wall offset, informational).

The **fingerprint** is a content hash over the canonical request
tuples (arrivals, prompts/recipes, priorities, deadlines, output
budgets, cancel offsets — request ids excluded: identity is not
content). Two A/B arms carrying the same fingerprint provably served
the identical trace; ``bench.py``/``scripts/ab_summary.py`` refuse to
compare arms whose fingerprints differ.

Capture sources:

- :class:`WorkloadCapture` — the front door's submit hook
  (``ServingFrontend(capture_path=...)`` / the
  ``serving.frontend.capture_path`` YAML knob): records each
  submitted ``Request`` (the ORIGINAL prompt — ``base_len`` guards
  against preemption's fold-into-prompt growth) and reads the
  terminal state (cancelled + delivered-token count) off the request
  objects at flush, keyed by their ``request_id``s;
- :meth:`Workload.from_tracer` — a privacy-scrubbed reconstruction
  from the :class:`RequestTracer` ring alone (``enqueued`` /
  ``cancelled`` / ``retired`` lifecycle events carry arrival, prompt
  length, priority, and token counts — never prompt content), for
  when all you kept is the trace.

Synthetic generators (:func:`synthesize`): ``poisson`` (open-loop
exponential inter-arrivals), ``bursty`` (on/off gating — the shape
that separates queue-depth-aware schedulers from FCFS), ``diurnal``
(sinusoidal rate ramp via thinning), ``sharegpt`` (Poisson arrivals
with log-normal mixed prompt/output lengths, the public-trace shape).
All deterministic from ``seed``, all emitting this format.

Host-side numpy only — nothing here touches the device or reads a
wall clock (the one capture-timestamp exception is a
reasoned allowlist entry).
"""
from __future__ import annotations

import hashlib
import json
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from torchbooster_tpu_torch.serving.structured.compiler import (
    SCHEMA_LIBRARY,
    library_response_format,
    schema_budget,
)

__all__ = ["Workload", "WorkloadCapture", "WorkloadRequest",
           "SYNTHETIC_KINDS", "synthesize"]

# v2: optional per-request ``n``/``best_of`` parallel-sampling
# fields — v1 files still load (absent fields mean n = 1), new saves
# stamp v2 and the content fingerprint covers the new fields.
# v3: optional per-request ``response_format`` (structured
# generation) — absent means unconstrained, v1/v2 files still load,
# and the fingerprint folds the spec in ONLY when set, so plain
# traffic keeps verifying against its recorded v1/v2 fingerprints.
# v4: optional per-request ``adapter`` (multi-LoRA serving,
# the HTTP `model` field) — absent/"" means the base model, v1-v3
# files still load, and the fingerprint folds the name in ONLY when
# set (the established only-when-set discipline), so base traffic
# keeps verifying against every earlier recorded fingerprint.
FORMAT_VERSION = 4
SUPPORTED_VERSIONS = (1, 2, 3, 4)

SYNTHETIC_KINDS = ("poisson", "bursty", "diurnal", "sharegpt",
                   "longprompt_burst")


@dataclass
class WorkloadRequest:
    """One request of a workload trace. ``prompt`` holds the token
    ids, or ``None`` for a scrubbed recipe — then ``prompt_seed`` +
    ``prompt_len`` regenerate a same-shape random prompt at replay
    (same seed → same ids across replays, but never the captured
    content). ``cancel_after_tokens`` replays a client disconnect at
    that delivered-token offset; ``disconnect_s`` keeps the recorded
    wall offset for reference."""
    arrival_s: float
    max_new_tokens: int
    prompt: np.ndarray | None = None
    prompt_len: int = 0
    prompt_seed: int | None = None
    priority: str = ""
    deadline_ms: float | None = None
    eos_id: int | None = None
    request_id: str = ""
    cancel_after_tokens: int | None = None
    disconnect_s: float | None = None
    # parallel sampling (OpenAI n/best_of; needs a
    # serving.parallel_sampling engine on replay): n completions
    # returned, best_of (None = n) branches decoded and ranked
    n: int = 1
    best_of: int | None = None
    # structured generation (OpenAI response_format; needs a
    # serving.structured engine on replay): None = unconstrained
    response_format: dict | None = None
    # multi-LoRA serving (the HTTP `model` field; needs a
    # serving.adapters engine with the name registered on replay):
    # "" = the base model
    adapter: str = ""

    def __post_init__(self):
        if self.prompt is not None:
            self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
            if self.prompt.size == 0:
                raise ValueError("empty prompt")
            self.prompt_len = int(self.prompt.size)
        if self.prompt_len < 1:
            raise ValueError(
                f"request needs prompt ids or a prompt_len >= 1 "
                f"recipe, got prompt_len={self.prompt_len}")
        if self.prompt is None and self.prompt_seed is None:
            raise ValueError(
                "scrubbed request needs a prompt_seed (the replay "
                "recipe) when prompt ids are absent")
        if self.arrival_s < 0:
            raise ValueError(
                f"arrival_s must be >= 0, got {self.arrival_s}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got "
                f"{self.max_new_tokens}")
        if self.cancel_after_tokens is not None \
                and self.cancel_after_tokens < 1:
            raise ValueError(
                f"cancel_after_tokens must be >= 1 (a never-served "
                f"client is a queue cancel, not a token offset), got "
                f"{self.cancel_after_tokens}")
        if not isinstance(self.n, int) or self.n < 1:
            raise ValueError(
                f"n must be an int >= 1, got {self.n!r}")
        if self.best_of is not None and (
                not isinstance(self.best_of, int)
                or self.best_of < self.n):
            raise ValueError(
                f"best_of must be an int >= n ({self.n}), got "
                f"{self.best_of!r}")
        if self.response_format is not None:
            if not isinstance(self.response_format, dict) \
                    or not isinstance(
                        self.response_format.get("type"), str):
                raise ValueError(
                    "response_format must be an object with a "
                    f"string 'type', got {self.response_format!r}")
            if self.response_format["type"] != "text" \
                    and self.eos_id is None:
                raise ValueError(
                    "a constraining response_format requires eos_id "
                    "(the automaton terminates by forcing EOS)")
        if not isinstance(self.adapter, str):
            raise ValueError(
                f"adapter must be a name (str, '' = base model), "
                f"got {self.adapter!r}")

    def prompt_ids(self, vocab: int) -> np.ndarray:
        """The prompt to serve: recorded ids, or the scrub recipe's
        deterministic regeneration (same seed+len+vocab → same ids)."""
        if self.prompt is not None:
            return self.prompt
        rs = np.random.RandomState(self.prompt_seed % (1 << 32))
        return rs.randint(0, vocab, self.prompt_len, dtype=np.int32)

    def content_key(self) -> list:
        """The canonical fingerprint tuple — everything that defines
        the OFFERED load (request ids excluded: two captures of the
        same traffic must fingerprint equal)."""
        prompt = ([int(t) for t in self.prompt]
                  if self.prompt is not None
                  else ["seed", int(self.prompt_seed),
                        int(self.prompt_len)])
        key = [round(float(self.arrival_s), 6), prompt, self.priority,
               self.deadline_ms, int(self.max_new_tokens), self.eos_id,
               self.cancel_after_tokens]
        if self.n > 1 or self.best_of is not None:
            # appended only when set so plain-traffic fingerprints
            # stay v1-identical (a v1 capture's recorded fingerprint
            # must keep verifying) while any n/best_of fan-out is
            # provably covered by the hash
            key.append([int(self.n), self.best_of])
        if self.response_format is not None:
            # same only-when-set discipline as n/best_of (v1/v2
            # fingerprints keep verifying); canonical JSON so key
            # order in the spec dict cannot change the hash
            key.append(["response_format", json.dumps(
                self.response_format, sort_keys=True,
                separators=(",", ":"))])
        if self.adapter:
            # only-when-set again: base traffic keeps its v1-v3
            # fingerprints while any adapter routing is provably
            # covered by the hash
            key.append(["adapter", self.adapter])
        return key

    def to_json(self) -> dict:
        return {
            "event": "workload_request",
            "request_id": self.request_id,
            "arrival_s": round(float(self.arrival_s), 6),
            "prompt": ([int(t) for t in self.prompt]
                       if self.prompt is not None else None),
            "prompt_len": int(self.prompt_len),
            "prompt_seed": self.prompt_seed,
            "priority": self.priority,
            "deadline_ms": self.deadline_ms,
            "eos_id": self.eos_id,
            "max_new_tokens": int(self.max_new_tokens),
            "cancel_after_tokens": self.cancel_after_tokens,
            "disconnect_s": (round(float(self.disconnect_s), 6)
                             if self.disconnect_s is not None else None),
            "n": int(self.n),
            "best_of": self.best_of,
            "response_format": self.response_format,
            "adapter": self.adapter,
        }

    @classmethod
    def from_json(cls, d: dict) -> "WorkloadRequest":
        return cls(
            arrival_s=float(d["arrival_s"]),
            max_new_tokens=int(d["max_new_tokens"]),
            prompt=(np.asarray(d["prompt"], np.int32)
                    if d.get("prompt") is not None else None),
            prompt_len=int(d.get("prompt_len", 0)),
            prompt_seed=d.get("prompt_seed"),
            priority=d.get("priority", ""),
            deadline_ms=d.get("deadline_ms"),
            eos_id=d.get("eos_id"),
            request_id=d.get("request_id", ""),
            cancel_after_tokens=d.get("cancel_after_tokens"),
            disconnect_s=d.get("disconnect_s"),
            # v1 files carry neither field: n = 1 (the loader's
            # __post_init__ rejects malformed values loudly); v1/v2
            # files carry no response_format: unconstrained
            n=d.get("n", 1),
            best_of=d.get("best_of"),
            response_format=d.get("response_format"),
            # v1-v3 files carry no adapter: base model
            adapter=d.get("adapter", ""))


@dataclass
class Workload:
    """An ordered request trace + its content fingerprint. Requests
    sort by arrival at construction (replay is open-loop — the offer
    order IS the arrival order)."""
    requests: list = field(default_factory=list)
    kind: str = "synthetic"
    vocab: int = 50257
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.vocab < 2:
            raise ValueError(f"vocab must be >= 2, got {self.vocab}")
        self.requests = sorted(self.requests,
                               key=lambda r: (r.arrival_s, r.request_id))
        seen: set[str] = set()
        for i, r in enumerate(self.requests):
            if not r.request_id:
                r.request_id = f"w-{i:05d}"
            if r.request_id in seen:
                raise ValueError(
                    f"duplicate request_id {r.request_id!r}: replay "
                    "keys outcomes (and the tracer keys timelines) by "
                    "id — a duplicate would merge two requests' "
                    "histories into one lie")
            seen.add(r.request_id)

    def __len__(self) -> int:
        return len(self.requests)

    def __iter__(self):
        return iter(self.requests)

    def fingerprint(self) -> str:
        """Content hash of the offered trace (hex). A/B arms that
        report the same fingerprint provably served the identical
        workload; the bench comparison gates refuse mismatches."""
        payload = json.dumps(
            [r.content_key() for r in self.requests],
            separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    # ---- persistence ---------------------------------------------
    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        lines = [json.dumps({
            "event": "workload_header", "version": FORMAT_VERSION,
            "kind": self.kind, "vocab": int(self.vocab),
            "n_requests": len(self.requests),
            "fingerprint": self.fingerprint(), **self.meta})]
        lines += [json.dumps(r.to_json()) for r in self.requests]
        path.write_text("\n".join(lines) + "\n", encoding="utf-8")
        return path

    @classmethod
    def load(cls, path: str | Path) -> "Workload":
        path = Path(path)
        header: dict | None = None
        requests: list[WorkloadRequest] = []
        for lineno, raw in enumerate(
                path.read_text(encoding="utf-8").splitlines(), 1):
            if not raw.strip():
                continue
            d = json.loads(raw)
            if d.get("event") == "workload_header":
                if d.get("version") not in SUPPORTED_VERSIONS:
                    raise ValueError(
                        f"{path}: workload format version "
                        f"{d.get('version')!r} not in supported "
                        f"{SUPPORTED_VERSIONS}")
                header = d
            elif d.get("event") == "workload_request":
                requests.append(WorkloadRequest.from_json(d))
            else:
                raise ValueError(
                    f"{path}:{lineno}: unknown event "
                    f"{d.get('event')!r} in a workload file")
        if header is None:
            raise ValueError(f"{path}: missing workload_header line")
        meta = {k: v for k, v in header.items()
                if k not in ("event", "version", "kind", "vocab",
                             "n_requests", "fingerprint")}
        wl = cls(requests=requests, kind=header.get("kind", "capture"),
                 vocab=int(header.get("vocab", 50257)), meta=meta)
        want = header.get("fingerprint")
        if want and wl.fingerprint() != want:
            raise ValueError(
                f"{path}: content fingerprint {wl.fingerprint()} != "
                f"recorded {want} — the file was edited after capture")
        return wl

    # ---- tracer reconstruction -----------------------------------
    @classmethod
    def from_tracer(cls, tracer, vocab: int = 50257,
                    default_max_new_tokens: int = 16) -> "Workload":
        """Privacy-scrubbed workload straight from the request tracing
        ring: ``enqueued`` events carry arrival/prompt_len/priority,
        ``cancelled`` the disconnect token offset, ``retired`` the
        served token count (used as the replay output budget —
        ``max_new_tokens`` itself never reaches the tracer). Prompt
        CONTENT is never in the ring, so every request is a
        seed+length recipe (seed derived from the request id).
        Requests whose ``enqueued`` event already fell off the
        bounded ring are skipped — the ring holds the tail, and the
        tail is what this reconstructs."""
        recs: dict[str, dict] = {}
        for e in tracer.events():
            rid = e.get("request_id")
            if rid is None:
                continue
            kind = e["kind"]
            if kind == "enqueued":
                arrival = e.get("arrival", 0.0)
                recs[rid] = {
                    "arrival_s": float(arrival),
                    "prompt_len": int(e.get("prompt_len", 1)),
                    "priority": e.get("priority", ""),
                    "n_tokens": None, "cancel": None}
            elif rid in recs and kind == "retired":
                recs[rid]["n_tokens"] = int(e.get("n_tokens", 0))
            elif rid in recs and kind == "cancelled":
                recs[rid]["cancel"] = int(e.get("n_tokens", 0))
        requests = []
        for rid, rec in recs.items():
            served = rec["cancel"] if rec["cancel"] else rec["n_tokens"]
            requests.append(WorkloadRequest(
                arrival_s=rec["arrival_s"],
                max_new_tokens=max(served or default_max_new_tokens, 1),
                prompt=None, prompt_len=max(rec["prompt_len"], 1),
                prompt_seed=zlib.crc32(rid.encode()),
                priority=rec["priority"], request_id=rid,
                cancel_after_tokens=(rec["cancel"]
                                     if rec["cancel"] else None)))
        return cls(requests=requests, kind="capture:tracer",
                   vocab=vocab, meta={"scrubbed": True})


class WorkloadCapture:
    """The front door's capture hook: :meth:`observe` each submitted
    ``Request`` (the frontend calls it right after a successful
    ``batcher.submit``), then :meth:`finalize`/:meth:`write` once the
    trace is over — terminal state (cancelled + delivered tokens) is
    read off the request objects themselves, keyed by their
    ``request_id``s.

    ``scrub=True`` never retains prompt CONTENT: each record keeps
    only length + a crc32-derived regeneration seed. ``max_requests``
    bounds retention (the batcher deliberately never retains served
    requests; a capture must, so the bound is explicit) — beyond it
    new submissions are counted in ``n_dropped`` but not recorded,
    and the written header says so."""

    def __init__(self, scrub: bool = False,
                 max_requests: int = 1 << 16):
        if max_requests < 1:
            raise ValueError(
                f"max_requests must be >= 1, got {max_requests}")
        self.scrub = bool(scrub)
        self.max_requests = int(max_requests)
        self._reqs: list = []
        self.n_dropped = 0
        # wall-clock TIMESTAMP for the capture header (provenance
        # metadata, not a duration — allowlisted)
        self._captured_at = time.time()

    @property
    def n_observed(self) -> int:
        return len(self._reqs)

    def observe(self, req) -> None:
        """Record one submitted request (call order = submit order)."""
        if len(self._reqs) >= self.max_requests:
            self.n_dropped += 1
            return
        self._reqs.append(req)

    def finalize(self, vocab: int | None = None) -> Workload:
        """Build the workload from the observed requests' CURRENT
        state. Arrival offsets normalize to the first observed
        arrival; prompts are the ORIGINAL ``base_len`` ids (preemption
        folds generated tokens into ``Request.prompt`` — a capture
        replaying those would double-serve them)."""
        t0 = min((r.arrival for r in self._reqs), default=0.0)
        out = []
        # vocab floor 2 (Workload's own bound): an EMPTY capture —
        # the server stopped before any traffic — must still finalize
        # to a valid (zero-request) workload, not crash stop()
        max_id = 2
        for r in self._reqs:
            prompt = np.asarray(r.prompt[:r.base_len], np.int32)
            max_id = max(max_id, int(prompt.max()) + 1)
            cancel = len(r.tokens) if r.cancelled and r.tokens else None
            out.append(WorkloadRequest(
                arrival_s=max(r.arrival - t0, 0.0),
                max_new_tokens=r.max_new_tokens,
                prompt=None if self.scrub else prompt,
                prompt_len=int(r.base_len),
                prompt_seed=(zlib.crc32(prompt.tobytes())
                             if self.scrub else None),
                priority=r.priority, deadline_ms=r.deadline_ms,
                eos_id=r.eos_id, request_id=r.request_id,
                cancel_after_tokens=cancel,
                disconnect_s=(max(r.finished_at - t0, 0.0)
                              if r.cancelled
                              and r.finished_at is not None else None),
                n=r.n, best_of=r.best_of,
                response_format=r.response_format,
                adapter=getattr(r, "adapter", "")))
        return Workload(
            requests=out, kind="capture", vocab=vocab or max_id,
            meta={"captured_at": round(self._captured_at, 3),
                  "scrubbed": self.scrub,
                  "n_dropped": self.n_dropped})

    def write(self, path: str | Path,
              vocab: int | None = None) -> Path:
        return self.finalize(vocab=vocab).save(path)


def _class_names_weights(classes: str) -> tuple[list, np.ndarray]:
    """Parse the ``"name:weight,..."`` mix spec ('' = one unnamed
    class)."""
    if not classes.strip():
        return [""], np.asarray([1.0])
    names, weights = [], []
    for part in classes.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        try:
            weight = float(w) if w else 1.0
        except ValueError:
            raise ValueError(
                f"class mix entry {part!r}: expected name[:weight], "
                f"weight must be a number") from None
        if weight <= 0:
            raise ValueError(
                f"class mix entry {part!r}: weight must be > 0")
        names.append(name.strip())
        weights.append(weight)
    arr = np.asarray(weights, np.float64)
    return names, arr / arr.sum()


def synthesize(kind: str = "poisson", *, n_requests: int = 32,
               rate: float = 8.0, seed: int = 0, vocab: int = 50257,
               prompt_len: tuple = (16, 64),
               max_new_tokens: tuple = (8, 32), classes: str = "",
               cancel_frac: float = 0.0, burst_on_s: float = 1.0,
               burst_off_s: float = 2.0, burst_mult: float = 4.0,
               period_s: float = 60.0, n_frac: float = 0.0,
               n_max: int = 4, structured_frac: float = 0.0,
               tenants: int = 0,
               prefix_pages: int = 0,
               page_size: int = 64,
               adapter_mix: str = "",
               long_prompt_len: tuple = (256, 512),
               long_frac: float = 0.25) -> Workload:
    """Synthetic workloads in the capture format, deterministic from
    ``seed`` — so a synthetic A/B carries a fingerprint exactly like a
    captured one and flows through the same replay driver.

    Kinds: ``poisson`` (exponential inter-arrivals at ``rate`` req/s),
    ``bursty`` (on/off gating: ``burst_on_s`` of ``burst_mult``×rate
    arrivals, then ``burst_off_s`` of silence — queue-depth stress),
    ``diurnal`` (sinusoidal rate ramp with period ``period_s``, via
    thinning), ``sharegpt`` (Poisson arrivals, log-normal mixed
    prompt/output lengths clipped to the given ranges). ``classes``
    is a ``"name:weight,..."`` priority mix; ``cancel_frac`` of
    requests get a recorded client disconnect at a random delivered-
    token offset; ``n_frac`` of requests carry parallel-sampling
    fan-out (``n = best_of`` drawn uniformly in ``[2, n_max]`` —
    replay them against a ``parallel_sampling: true`` engine).

    ``structured_frac`` of requests carry an OpenAI
    ``response_format`` drawn from the built-in schema library
    (``structured.SCHEMA_LIBRARY`` — all bounded, byte-level
    schemas), with ``eos_id = vocab - 1`` (outside every library
    schema's ASCII alphabet; needs ``vocab > 128``) and their output
    budget raised to the schema's worst-case completion length so
    constrained requests can finish with ``stop`` — replay them
    against a ``serving.structured.enabled: true`` engine. The draws
    come from their own seed-derived stream, so ``structured_frac:
    0`` traffic is byte-identical to pre-v3 workloads.

    ``tenants > 0`` (with ``prefix_pages >= 1``) models the
    many-tenant shared-system-prompt shape the host spill tier
    exists for: each request is assigned one of ``tenants`` tenants
    and its prompt is PREPENDED with that tenant's fixed
    ``prefix_pages * page_size``-token system prompt — page-aligned,
    so every tenant's prefix registers as whole pages in the prefix
    index and the affinity/directory keys. With enough tenants the
    working set overflows the HBM prefix cache and re-arrivals
    exercise the host tier. All tenant draws come from their own
    seed-derived stream, so ``tenants: 0`` (the default) traffic is
    byte-identical to pre-knob workloads and the format version is
    unchanged (a tenant prefix is just prompt tokens).

    ``longprompt_burst`` is the disaggregation stressor:
    steady short-prompt decode traffic — the Poisson base, drawn
    byte-identically to ``kind="poisson"`` for the same seed/params —
    plus ``long_frac`` (of ``n_requests``, as EXTRA requests) long
    prompts in ``long_prompt_len`` arriving as periodic bursts, one
    burst every ``period_s`` seconds (mid-window, round-robin across
    bursts). Long requests take the LAST class of ``classes`` (list
    the decode class first and the prefill class last) and are always
    plain (no cancel/fan-out/structured/adapter/tenant decoration —
    they exist to spike prefill work, nothing else). All their draws
    come from their own seed-derived stream, so ``long_frac: 0``
    traffic is byte-identical to plain Poisson for a given seed.

    ``adapter_mix`` (multi-LoRA serving, v4) is a ``"name:weight,
    ..."`` mix assigning each request an adapter by weighted draw —
    the literal name ``base`` (or an empty name) means the base
    model, anything else must be registered on the replay engine
    (``serving.adapters``). Draws come from their own seed-derived
    stream, so ``adapter_mix: ""`` (the default) traffic is
    byte-identical to pre-v4 workloads for a given seed."""
    if kind not in SYNTHETIC_KINDS:
        raise ValueError(
            f"unknown synthetic workload kind {kind!r}: expected one "
            f"of {SYNTHETIC_KINDS} (or pass a capture file path to "
            "the replay entry points instead)")
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0 req/s, got {rate}")
    if not 0.0 <= cancel_frac <= 1.0:
        raise ValueError(
            f"cancel_frac must be in [0, 1], got {cancel_frac}")
    if not 0.0 <= n_frac <= 1.0:
        raise ValueError(f"n_frac must be in [0, 1], got {n_frac}")
    if n_max < 2:
        raise ValueError(
            f"n_max must be >= 2 (n_frac requests fan out), got "
            f"{n_max}")
    if not 0.0 <= structured_frac <= 1.0:
        raise ValueError(
            f"structured_frac must be in [0, 1], got "
            f"{structured_frac}")
    if structured_frac > 0 and vocab <= 128:
        raise ValueError(
            f"structured_frac > 0 needs vocab > 128 (got {vocab}): "
            "structured requests stop on eos_id = vocab - 1, which "
            "must sit outside the library schemas' ASCII alphabet")
    if tenants < 0 or prefix_pages < 0:
        raise ValueError(
            f"tenants/prefix_pages must be >= 0, got "
            f"tenants={tenants}, prefix_pages={prefix_pages}")
    if (tenants > 0) != (prefix_pages > 0):
        raise ValueError(
            f"tenants={tenants} with prefix_pages={prefix_pages}: "
            "both must be set together (a tenant without a shared "
            "prefix, or a prefix with no tenant to own it, is "
            "surely a config typo)")
    if tenants > 0 and page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if not 0.0 <= long_frac <= 1.0:
        raise ValueError(
            f"long_frac must be in [0, 1], got {long_frac}")
    l_lo, l_hi = int(long_prompt_len[0]), int(long_prompt_len[1])
    if kind == "longprompt_burst" and not 1 <= l_lo <= l_hi:
        raise ValueError(
            f"long_prompt_len must satisfy 1 <= lo <= hi, got "
            f"{long_prompt_len}")
    if kind == "longprompt_burst" and period_s <= 0:
        raise ValueError(
            f"period_s must be > 0 (the burst cadence), got "
            f"{period_s}")
    p_lo, p_hi = int(prompt_len[0]), int(prompt_len[1])
    o_lo, o_hi = int(max_new_tokens[0]), int(max_new_tokens[1])
    if not 1 <= p_lo <= p_hi or not 1 <= o_lo <= o_hi:
        raise ValueError(
            f"length ranges must satisfy 1 <= lo <= hi, got "
            f"prompt_len={prompt_len}, max_new_tokens={max_new_tokens}")
    rs = np.random.RandomState(seed)
    names, weights = _class_names_weights(classes)

    if kind == "bursty":
        # walk on/off windows: arrivals only during "on", at the
        # burst rate — the shape where a queue builds and drains
        arrivals, t, cycle = [], 0.0, burst_on_s + burst_off_s
        while len(arrivals) < n_requests:
            t += rs.exponential(1.0 / (rate * burst_mult))
            if (t % cycle) < burst_on_s:
                arrivals.append(t)
        arrivals = np.asarray(arrivals)
    elif kind == "diurnal":
        # thinning at the peak rate against the sinusoidal profile
        arrivals, t = [], 0.0
        while len(arrivals) < n_requests:
            t += rs.exponential(1.0 / rate)
            accept = 0.5 + 0.5 * np.sin(2 * np.pi * t / period_s)
            if rs.random_sample() < accept:
                arrivals.append(t)
        arrivals = np.asarray(arrivals)
    else:  # poisson / sharegpt share the arrival process
        arrivals = np.cumsum(rs.exponential(1.0 / rate, n_requests))

    if kind == "sharegpt":
        # log-normal mixed lengths (the public chat-trace shape),
        # clipped into the configured ranges
        def lengths(lo, hi):
            mid = np.sqrt(lo * hi)
            draw = rs.lognormal(np.log(mid), 0.6, n_requests)
            return np.clip(draw, lo, hi).astype(np.int64)
        plens = lengths(p_lo, p_hi)
        olens = lengths(o_lo, o_hi)
    else:
        plens = rs.randint(p_lo, p_hi + 1, n_requests)
        olens = rs.randint(o_lo, o_hi + 1, n_requests)

    cls_idx = rs.choice(len(names), n_requests, p=weights)
    cancels = rs.random_sample(n_requests) < cancel_frac
    # fan-out draws come from their OWN seed-derived stream: drawing
    # them from `rs` would shift every later prompt/cancel draw, so a
    # given seed's pre-v2 traffic (and an n_frac=0 arm vs an n_frac>0
    # arm's BASE traffic) would silently stop reproducing
    rs_fan = np.random.RandomState((seed ^ 0x5EED5EED) & 0xFFFFFFFF)
    fanout = rs_fan.random_sample(n_requests) < n_frac
    fan_n = rs_fan.randint(2, n_max + 1, n_requests)
    # structured draws from their OWN stream too: structured_frac=0
    # traffic must stay byte-identical to pre-v3 workloads for a
    # given seed
    lib_ids = sorted(SCHEMA_LIBRARY)
    rs_sch = np.random.RandomState((seed ^ 0x5C4E3A01) & 0xFFFFFFFF)
    struct_on = rs_sch.random_sample(n_requests) < structured_frac
    sch_pick = rs_sch.randint(0, len(lib_ids), n_requests)
    # tenant prefixes likewise draw from their OWN stream (same
    # reasoning as the fan-out draws: tenants=0 traffic must stay
    # byte-identical to pre-knob workloads for a given seed)
    # adapter draws from their OWN stream too (same byte-identity
    # argument: adapter_mix="" traffic must reproduce pre-v4 bytes)
    adp_names: list[str] = []
    adp_idx = np.zeros(n_requests, np.int64)
    if adapter_mix:
        adp_names, adp_weights = _class_names_weights(adapter_mix)
        adp_names = ["" if n in ("", "base") else n
                     for n in adp_names]
        rs_adp = np.random.RandomState(
            (seed ^ 0x0ADA97E4) & 0xFFFFFFFF)
        adp_idx = rs_adp.choice(len(adp_names), n_requests,
                                p=adp_weights)
    tenant_prefixes: list[np.ndarray] = []
    tenant_idx = np.zeros(n_requests, np.int64)
    if tenants > 0:
        rs_ten = np.random.RandomState(
            (seed ^ 0x7EA0A77) & 0xFFFFFFFF)
        tenant_prefixes = [
            rs_ten.randint(0, vocab, prefix_pages * page_size,
                           dtype=np.int32)
            for _ in range(tenants)]
        tenant_idx = rs_ten.randint(0, tenants, n_requests)
    requests = []
    for i in range(n_requests):
        out_budget = int(olens[i])
        cancel = None
        if cancels[i]:
            cancel = int(rs.randint(1, out_budget + 1))
        n_i = int(fan_n[i]) if fanout[i] else 1
        prompt = rs.randint(0, vocab, int(plens[i]), dtype=np.int32)
        if tenants > 0:
            prompt = np.concatenate(
                [tenant_prefixes[int(tenant_idx[i])], prompt])
        rf_i, eos_i = None, None
        if struct_on[i]:
            sid = lib_ids[int(sch_pick[i])]
            rf_i = library_response_format(sid)
            eos_i = vocab - 1
            # the output budget must cover the schema's worst-case
            # completion (+ EOS) or a constrained request could only
            # ever finish by length, mid-schema
            out_budget = max(out_budget, schema_budget(sid))
        requests.append(WorkloadRequest(
            arrival_s=float(arrivals[i]),
            max_new_tokens=out_budget,
            prompt=prompt,
            eos_id=eos_i,
            priority=names[int(cls_idx[i])],
            request_id=f"w{seed}-{i:05d}",
            cancel_after_tokens=cancel,
            n=n_i,
            response_format=rf_i,
            adapter=(adp_names[int(adp_idx[i])]
                     if adp_names else "")))
    if kind == "longprompt_burst":
        # long-prompt bursts from their OWN stream (the established
        # byte-identity discipline: the base traffic above must stay
        # identical to plain poisson for a given seed). Bursts land
        # mid-window — every period_s a clump of long prompts arrives
        # together, the moment an interleaved prefill would steal the
        # most decode slots.
        n_long = int(round(n_requests * long_frac))
        rs_long = np.random.RandomState(
            (seed ^ 0x10A6B057) & 0xFFFFFFFF)
        span = float(arrivals[-1])
        n_bursts = max(1, int(np.ceil(span / period_s)))
        for j in range(n_long):
            burst = j % n_bursts
            jitter = rs_long.uniform(0.0, 0.05)
            at = period_s * (burst + 0.5) + float(jitter)
            llen = int(rs_long.randint(l_lo, l_hi + 1))
            requests.append(WorkloadRequest(
                arrival_s=at,
                max_new_tokens=int(rs_long.randint(o_lo, o_hi + 1)),
                prompt=rs_long.randint(0, vocab, llen, dtype=np.int32),
                priority=names[-1],
                request_id=f"w{seed}-L{j:05d}"))
    meta = {"seed": int(seed), "rate": float(rate)}
    if kind == "longprompt_burst":
        meta["long_frac"] = float(long_frac)
        meta["period_s"] = float(period_s)
    if adapter_mix:
        meta["adapter_mix"] = adapter_mix
    if tenants > 0:
        meta["tenants"] = int(tenants)
        meta["prefix_pages"] = int(prefix_pages)
    return Workload(requests=requests, kind=f"synthetic:{kind}",
                    vocab=vocab, meta=meta)
