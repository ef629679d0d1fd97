"""Host-side continuous batching over the paged engine — the port of
``torchbooster_tpu/serving/batcher.py``.

Requests queue; whenever a slot AND enough pages are free, the request
the SCHEDULER POLICY picks is seated (prompt pages allocated, cached
prefix pages mapped in) and its prefill streams in as fixed-size
chunks — each iteration issues ONE prefill chunk, then one decode step
over all live slots, so a long prompt adds at most one chunk of latency
between decode steps. Sequences retire on EOS, ``max_new_tokens`` or
the ``seq_len`` horizon. Under pool pressure the policy's victim is
PREEMPTED: pushed back to the front of the queue with its generated
tokens folded into its prompt (folded once, however often it is
preempted), to re-prefill later.

:meth:`ContinuousBatcher.step` is the pumpable per-iteration core and
:meth:`run` drives it over a whole trace, returning a metrics dict.
Every run feeds the telemetry registry (``serving_*``), lands one row
per step in the flight recorder, and is watched by a
:class:`RecompileSentinel` over the engine's count of distinct decode
step shapes, which must stay 1.

Not ported here (``ROADMAP.md`` A5/A6): n-way ``fork`` sampling,
structured ``response_format`` decoding, LoRA ``adapter`` requests and
speculative bursts — requests asking for them are rejected at submit.
"""
from __future__ import annotations

import time
import uuid
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from torchbooster_tpu_torch.observability import (
    RecompileSentinel,
    get_registry,
)
from torchbooster_tpu_torch.observability.flight import (
    FlightRecorder,
    step_kind_code,
)
from torchbooster_tpu_torch.observability.recompile import POLICIES
from torchbooster_tpu_torch.observability.tracing import RequestTracer
from torchbooster_tpu_torch.serving.engine import PagedEngine
from torchbooster_tpu_torch.serving.frontend.scheduler import (
    FCFSPolicy,
    SchedulerPolicy,
)


@dataclass(eq=False)
class Request:
    """One generation request, compared by identity (the scheduler
    queues and cancels BY OBJECT). ``arrival`` is an offset in seconds
    from the batcher's clock start; ``eos_id=None`` never stops early;
    ``priority``/``deadline_ms`` matter only under an SLO policy. The
    ``n``/``best_of``/``response_format``/``adapter`` fields exist for
    the JAX package's request surface and are rejected at submit unless
    they ask for nothing (n = 1, plain text, base model)."""
    prompt: np.ndarray
    max_new_tokens: int = 32
    eos_id: int | None = None
    arrival: float = 0.0
    priority: str = ""
    deadline_ms: float | None = None
    arrival_time: float | None = None
    n: int = 1
    best_of: int | None = None
    response_format: dict | None = None
    adapter: str = ""
    request_id: str = ""
    # filled by the batcher
    tokens: list = field(default_factory=list)
    admitted_at: float | None = None
    first_token_at: float | None = None
    finished_at: float | None = None
    finish_reason: str | None = None
    shed: bool = False
    cancelled: bool = False

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if not isinstance(self.priority, str):
            raise TypeError(f"priority must be a class NAME (str), got "
                            f"{type(self.priority).__name__}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got "
                             f"{self.deadline_ms}")
        if not self.request_id:
            self.request_id = "req-" + uuid.uuid4().hex[:16]
        # the ORIGINAL prompt length: preemption folds generated tokens
        # into ``prompt``, so the true context is base_len + len(tokens)
        self.base_len = int(self.prompt.size)


class _Session:
    """One pumping session's mutable state (a ``run()`` trace)."""

    MAX_SAMPLES = 8192

    def __init__(self, batcher: "ContinuousBatcher"):
        eng = batcher.engine
        self.queue: list[Request] = []
        self.live: dict[int, Request] = {}       # decoding
        self.filling: dict[int, Request] = {}    # seated, prefill streaming
        self.admit_order: list[int] = []         # oldest-first seated slots
        self.t0 = batcher.clock()
        self.decoded = 0
        self.decode_time = 0.0
        self.n_admissions = 0
        self.n_preemptions = 0
        self.n_shed = 0
        self.n_cancelled = 0
        self.n_seen = 0
        self.new_tokens = 0
        self.lat: list[float] = []
        self.ttft: list[float] = []
        self.per_class: dict[str, dict] = {}
        self.hits0 = eng.prefix_hit_pages
        self.lookups0 = eng.prefix_lookup_pages
        self.chunks0 = eng.prefill_chunks
        self.closed = False

    def sample(self, series: list[float], value: float) -> None:
        series.append(value)
        if len(series) > self.MAX_SAMPLES:
            del series[:len(series) - self.MAX_SAMPLES]


class ContinuousBatcher:
    """Policy-driven admission queue driving a :class:`PagedEngine`.
    ``run(requests)`` processes a whole trace and returns a metrics
    dict; finished requests carry their ``tokens`` and timing fields.
    ``submit``/``cancel`` are thread-safe inboxes the next :meth:`step`
    drains (``start_session``/``finish_session`` bracket an externally
    pumped session). ``clock`` is injectable for deterministic tests
    and must advance on its own."""

    def __init__(self, engine: PagedEngine, clock=time.perf_counter,
                 on_recompile: str = "warn",
                 policy: SchedulerPolicy | None = None,
                 tracer: RequestTracer | None = None,
                 flight: FlightRecorder | None = None):
        if on_recompile not in POLICIES:
            raise ValueError(f"on_recompile={on_recompile!r}: expected "
                             f"one of {POLICIES}")
        if policy is not None and not isinstance(policy, SchedulerPolicy):
            raise TypeError(f"policy must be a SchedulerPolicy, got "
                            f"{type(policy).__name__}")
        self.on_recompile = on_recompile
        self.policy = policy if policy is not None else FCFSPolicy()
        self.tracer = tracer if tracer is not None else RequestTracer()
        self.flight = flight if flight is not None else FlightRecorder()
        self.engine = engine
        self.clock = clock
        self._capacity = (engine.n_pages - 1) * engine.page_size
        self.est_chunk_s = 0.0
        self.est_step_s = 0.0
        self._s: _Session | None = None
        self._sentinel: RecompileSentinel | None = None
        self._inst: dict | None = None
        self._inbox_submit: deque[Request] = deque()
        self._inbox_cancel: deque[Request] = deque()

    # ---- capacity & estimates ------------------------------------
    def _check_fits(self, req: Request) -> None:
        if req.n != 1 or req.best_of not in (None, 1):
            raise ValueError(
                "n/best_of > 1 (copy-on-write fork sampling) is not "
                "ported yet (ROADMAP.md A6)")
        if req.response_format is not None \
                and req.response_format.get("type") != "text":
            raise ValueError(
                "constrained response_format decoding is not ported yet "
                "(ROADMAP.md A6 structured generation)")
        if req.adapter:
            raise ValueError(
                f"request names adapter {req.adapter!r}: LoRA lanes are "
                "not ported yet (ROADMAP.md A6)")
        worst = req.base_len + req.max_new_tokens
        if worst > self.engine.cfg.seq_len:
            raise ValueError(
                f"prompt ({req.base_len}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds cfg.seq_len "
                f"({self.engine.cfg.seq_len})")
        if self.engine.tables.pages_for(worst) > self.engine.n_pages - 1:
            raise ValueError(
                f"request needs {worst} tokens of pages but the pool "
                f"holds {self._capacity}; grow serving.n_pages")

    def est_ttft_s(self, req: Request) -> float:
        """Estimated seconds to ``req``'s first token were it seated
        next: its chunks plus the chunks queued ahead, at the EWMA chunk
        time, plus one decode step."""
        chunks = -(-len(req.prompt) // self.engine.chunk_tokens)
        ahead = self.engine.pending_chunk_count
        return (chunks + ahead) * self.est_chunk_s + self.est_step_s

    def readmission_cost(self, req: Request) -> int:
        """Tokens a preemption victim would re-prefill on re-seat, net
        of the prompt pages the prefix cache would map straight back."""
        folded = len(req.prompt) - req.base_len
        ctx = np.concatenate(
            [req.prompt, np.asarray(req.tokens[folded:], np.int32)])
        matched = self.engine.tables.match_pages(ctx)
        return len(ctx) - len(matched) * self.engine.page_size

    @property
    def occupancy(self) -> float:
        avail = self.engine.tables.n_available_pages
        return 1.0 - avail / max(self.engine.n_pages - 1, 1)

    @property
    def queue_depth(self) -> int:
        s = self._s
        return len(self._inbox_submit) + (len(s.queue) if s else 0)

    # ---- external driver surface ---------------------------------
    def submit(self, req: Request, arrival: float | None = None) -> None:
        if self._s is None:
            raise RuntimeError("no active session: start_session() first")
        self._check_fits(req)
        self.policy.validate(req)
        req.arrival = self.session_now() if arrival is None else arrival
        self._inbox_submit.append(req)

    def cancel(self, req: Request) -> None:
        self._inbox_cancel.append(req)

    def session_now(self) -> float:
        if self._s is None:
            raise RuntimeError("no active session")
        return self.clock() - self._s.t0

    def start_session(self) -> None:
        s = self._begin()
        self._sentinel.__enter__()
        self._s = s

    def finish_session(self) -> dict:
        if self._s is None:
            raise RuntimeError("no active session")
        s = self._s
        try:
            self._sentinel.__exit__(None, None, None)
        finally:
            self._land(s)
        return self._metrics(s)

    # ---- session internals ---------------------------------------
    def _begin(self) -> _Session:
        if self._s is not None:
            raise RuntimeError("a session is already active on this batcher")
        self._inbox_submit.clear()
        self._inbox_cancel.clear()
        # a previous run that aborted mid-loop can leave half-prefilled
        # slots: they belong to the dead trace
        for slot in self.engine.pending_slots:
            self.engine.retire(slot)
        reg = get_registry()
        inst = {
            "lat": reg.histogram("serving_latency_seconds",
                                 "request arrival -> completion"),
            "ttft": reg.histogram("serving_ttft_seconds",
                                  "request arrival -> first token"),
            "slots": reg.gauge("serving_slots_live", "occupied decode slots"),
            "pages": reg.gauge("serving_pages_free",
                               "free KV pages in the pool"),
            "admissions": reg.counter("serving_admissions_total",
                                      "requests seated (re-admissions count)"),
            "preemptions": reg.counter("serving_preemptions_total",
                                       "scheduler-victim preemptions"),
            "retired": reg.counter("serving_retired_total",
                                   "sequences retired (EOS/max/horizon)"),
            "tokens": reg.counter("serving_decode_tokens_total",
                                  "tokens produced by decode steps"),
            "hit_pages": reg.counter("serving_prefix_hit_pages_total",
                                     "prompt pages served from the prefix "
                                     "cache"),
            "chunks": reg.counter("serving_prefill_chunks_total",
                                  "prefill chunks issued"),
            "hit_rate": reg.gauge("serving_prefix_hit_rate",
                                  "prefix-cache page hit rate over this run"),
        }
        if self.policy.slo:
            inst.update({
                "slo_ttft": reg.histogram("serving_slo_ttft_seconds",
                                          "per-class arrival -> first token"),
                "slo_tpot": reg.histogram("serving_slo_tpot_seconds",
                                          "per-class mean inter-token time"),
                "slo_shed": reg.counter("serving_slo_shed_total",
                                        "requests shed by the SLO policy"),
                "slo_cancel": reg.counter("serving_slo_cancelled_total",
                                          "requests cancelled by the client"),
                "slo_hit": reg.counter("serving_slo_deadline_hit_total",
                                       "deadline hits (kind=ttft|tpot)"),
                "slo_miss": reg.counter("serving_slo_deadline_miss_total",
                                        "deadline misses (kind=ttft|tpot)"),
            })
        self._inst = inst
        s = _Session(self)
        if self.policy.slo:
            for name in self.policy.classes:
                s.per_class[name] = {
                    "n": 0, "completed": 0, "shed": 0, "ttft": [],
                    "tpot": [], "ttft_hit": 0, "ttft_n": 0,
                    "tpot_hit": 0, "tpot_n": 0}
        # the decode step's first shape signature is legitimate; any
        # later one is a broken fixed-shape contract
        step_shapes = lambda: self.engine.decode_compiles
        self._sentinel = RecompileSentinel(
            step_shapes, on_recompile=self.on_recompile,
            expected=0 if step_shapes() else 1,
            name="serving_decode", registry=reg)
        return s

    def _class_stats(self, req: Request) -> dict | None:
        if not self.policy.slo:
            return None
        return self._s.per_class[self.policy.cls_of(req).name]

    def _finish_request(self, slot: int) -> None:
        s, inst = self._s, self._inst
        req = s.live.pop(slot)
        s.admit_order.remove(slot)
        req.finished_at = self.clock() - s.t0
        inst["retired"].inc()
        s.new_tokens += len(req.tokens)
        s.sample(s.lat, req.finished_at - req.arrival)
        inst["lat"].observe(req.finished_at - req.arrival)
        if req.first_token_at is not None:
            s.sample(s.ttft, req.first_token_at - req.arrival)
            inst["ttft"].observe(req.first_token_at - req.arrival)
        self.engine.retire(slot)
        if self.tracer.enabled:
            self.tracer.emit(req.request_id, "retired",
                             reason=req.finish_reason or "",
                             n_tokens=len(req.tokens))
        cs = self._class_stats(req)
        if cs is None:
            return
        cls = self.policy.cls_of(req)
        cs["completed"] += 1
        ttft = req.first_token_at - req.arrival
        s.sample(cs["ttft"], ttft)
        inst["slo_ttft"].observe(ttft, cls=cls.name)
        tpot = None
        if len(req.tokens) > 1:
            tpot = (req.finished_at - req.first_token_at) \
                / (len(req.tokens) - 1)
            s.sample(cs["tpot"], tpot)
            inst["slo_tpot"].observe(tpot, cls=cls.name)
        for kind, value, target in (
                ("ttft", ttft, self.policy.ttft_deadline_s(req)),
                ("tpot", tpot, self.policy.tpot_deadline_s(req))):
            if target is None or value is None:
                continue
            hit = value <= target
            cs[f"{kind}_n"] += 1
            cs[f"{kind}_hit"] += int(hit)
            inst["slo_hit" if hit else "slo_miss"].inc(cls=cls.name,
                                                       kind=kind)

    def _maybe_stop(self, slot: int, token: int) -> bool:
        """Append ``token``, evaluate the stop conditions, retire when
        done. Returns True when the request finished."""
        s = self._s
        req = s.live[slot]
        req.tokens.append(int(token))
        if req.first_token_at is None:
            req.first_token_at = self.clock() - s.t0
            if self.tracer.enabled:
                self.tracer.emit(
                    req.request_id, "first_token",
                    ttft_s=round(req.first_token_at - req.arrival, 6))
        hit_eos = req.eos_id is not None and token == req.eos_id
        full = req.base_len + len(req.tokens) >= self.engine.cfg.seq_len
        if hit_eos or len(req.tokens) >= req.max_new_tokens or full:
            req.finish_reason = "stop" if hit_eos else "length"
            self._finish_request(slot)
            return True
        return False

    def _terminal(self, req: Request, events: list, reason: str) -> None:
        """Close a request that never finished (shed or cancelled)."""
        s = self._s
        req.finished_at = self.clock() - s.t0
        req.finish_reason = reason
        if self.tracer.enabled:
            self.tracer.emit(req.request_id, reason,
                             n_tokens=len(req.tokens))
        s.new_tokens += len(req.tokens)
        events.append((req, []))
        cs = self._class_stats(req)
        if reason == "shed":
            req.shed = True
            s.n_shed += 1
            if cs is not None:
                cs["shed"] += 1
                self._inst["slo_shed"].inc(cls=self.policy.cls_of(req).name)
        else:
            req.cancelled = True
            s.n_cancelled += 1
            if cs is not None:
                self._inst["slo_cancel"].inc(
                    cls=self.policy.cls_of(req).name)

    def _drain_cancels(self, events: list) -> None:
        s = self._s
        while self._inbox_cancel:
            req = self._inbox_cancel.popleft()
            if req.finished_at is not None:
                continue                      # raced completion
            if any(req is q for q in s.queue):
                s.queue.remove(req)
                self._terminal(req, events, "cancelled")
                continue
            for table in (s.filling, s.live):
                slot = next((sl for sl, r in table.items() if r is req),
                            None)
                if slot is not None:
                    table.pop(slot)
                    s.admit_order.remove(slot)
                    self.engine.retire(slot)
                    self._terminal(req, events, "cancelled")
                    break

    def _preempt_one(self, s: _Session) -> bool:
        """Evict ONE policy-chosen seated victim to the front of the
        queue with its not-yet-folded generated tokens folded into its
        prompt. Returns False when nothing is seated."""
        if not s.admit_order:
            return False
        seated = {**s.filling, **s.live}
        victim = self.policy.select_victim(list(s.admit_order), seated, self)
        req = s.live.pop(victim) if victim in s.live \
            else s.filling.pop(victim)
        s.admit_order.remove(victim)
        self.engine.retire(victim)
        folded = len(req.prompt) - req.base_len
        if self.tracer.enabled:
            self.tracer.emit(req.request_id, "preempted", slot=victim,
                             fold_tokens=len(req.tokens) - folded)
        req.prompt = np.concatenate(
            [req.prompt, np.asarray(req.tokens[folded:], np.int32)])
        s.queue.insert(0, req)
        s.n_preemptions += 1
        self._inst["preemptions"].inc()
        return True

    def step(self) -> list[tuple[Request, list[int]]]:
        """ONE scheduling iteration: drain the inboxes, shed (policy),
        seat admissible requests (policy order), issue one prefill
        chunk, grow/preempt, then one decode step. Returns this
        iteration's ``(request, tokens)`` events and lands one flight
        recorder row."""
        if self._s is None:
            raise RuntimeError("no active session: start_session() first")
        s, eng = self._s, self.engine
        c0 = eng.decode_compiles + eng.prefill_compiles
        st = {"wall": 0.0, "prefill": False, "decode": False}
        events: list = []
        try:
            self._step_body(s, st, events)
        finally:
            recompiled = (eng.decode_compiles + eng.prefill_compiles) > c0
            self.flight.record(
                kind=step_kind_code(st["prefill"], st["decode"], False),
                slots_live=len(s.live), slots_filling=len(s.filling),
                pages_live=int(eng.tables.n_live_pages),
                pages_free=int(eng.tables.n_free_pages),
                pages_cached=int(eng.tables.n_cached_pages),
                queue_depth=len(s.queue),
                tokens=sum(len(t) for _, t in events), accept_rate=0.0,
                wall_s=st["wall"], recompiled=recompiled,
                inflight=([r.request_id for r in (*s.filling.values(),
                                                  *s.live.values())]
                          if recompiled else ()))
        return events

    def _step_body(self, s: _Session, st: dict, events: list) -> None:
        now = lambda: self.clock() - s.t0
        while self._inbox_submit:
            req = self._inbox_submit.popleft()
            s.n_seen += 1
            s.queue.append(req)
            if self.tracer.enabled:
                self.tracer.emit(req.request_id, "enqueued",
                                 prompt_len=int(req.base_len),
                                 arrival=round(req.arrival, 6))
            cs = self._class_stats(req)
            if cs is not None:
                cs["n"] += 1
        self._drain_cancels(events)
        for req in self.policy.shed(s.queue, now(), self):
            s.queue.remove(req)
            self._terminal(req, events, "shed")
        # --- seat every admissible request the policy picks (FCFS
        # stops at the first failed seat: head-of-line order) ---
        tried: set[int] = set()
        while True:
            pool = [r for r in s.queue if id(r) not in tried]
            req = self.policy.next_admission(pool, now(), self)
            if req is None:
                break
            hits0 = self.engine.prefix_hit_pages
            slot = self.engine.admit_begin(req.prompt)
            if slot is None:
                if self.policy.stop_on_admit_failure:
                    break
                tried.add(id(req))
                continue
            s.queue.remove(req)
            s.filling[slot] = req
            s.admit_order.append(slot)
            s.n_admissions += 1
            self._inst["admissions"].inc()
            if self.tracer.enabled:
                self.tracer.emit(
                    req.request_id, "seated", slot=slot,
                    prefix_hit_pages=int(self.engine.prefix_hit_pages
                                         - hits0),
                    readmission=req.admitted_at is not None)
            if req.admitted_at is None:
                req.admitted_at = now()
        # --- ONE prefill chunk per iteration, interleaved with decode ---
        if self.engine.has_pending:
            t_chunk = self.clock()
            done = self.engine.prefill_step()
            dt = self.clock() - t_chunk
            self.est_chunk_s = dt if not self.est_chunk_s \
                else 0.8 * self.est_chunk_s + 0.2 * dt
            st["prefill"] = True
            st["wall"] += dt
            if self.tracer.enabled:
                self.tracer.emit(None, "serving_prefill_chunk",
                                 dur_s=round(dt, 6))
            if done is not None:
                slot, first = done
                req = s.filling.pop(slot)
                s.live[slot] = req
                self._maybe_stop(slot, first)    # the prefill's token
                events.append((req, [int(first)]))
        self._inst["slots"].set(len(s.live))
        self._inst["pages"].set(self.engine.tables.n_free_pages)
        if not s.live:
            return
        # --- grow: every live slot's next write page must exist;
        # starved slots preempt the policy's victim ---
        starved = self.engine.grow_slots()
        while starved:
            if not self._preempt_one(s):
                break
            starved = self.engine.grow_slots() if s.live else []
        if not s.live:
            return
        t_step = self.clock()
        tokens = self.engine.step()
        dt = self.clock() - t_step
        s.decode_time += dt
        self.est_step_s = dt if not self.est_step_s \
            else 0.8 * self.est_step_s + 0.2 * dt
        st["decode"] = True
        st["wall"] += dt
        if self.tracer.enabled:
            self.tracer.emit(None, "decode_step", dur_s=round(dt, 6),
                             slots=len(s.live))
        s.decoded += len(s.live)
        self._inst["tokens"].inc(len(s.live))
        self._drain_cancels(events)
        for slot in list(s.live):
            req = s.live[slot]
            if self.tracer.enabled:
                self.tracer.emit(req.request_id, "tokens", n=1)
            self._maybe_stop(slot, int(tokens[slot]))
            events.append((req, [int(tokens[slot])]))

    def _land(self, s: _Session) -> None:
        """Gauges and counters land on engine truth at session exit."""
        if s.closed:
            return
        s.closed = True
        inst = self._inst
        inst["slots"].set(len(s.live))
        inst["pages"].set(self.engine.tables.n_free_pages)
        hit_pages = self.engine.prefix_hit_pages - s.hits0
        lookups = self.engine.prefix_lookup_pages - s.lookups0
        inst["hit_pages"].inc(hit_pages)
        inst["chunks"].inc(self.engine.prefill_chunks - s.chunks0)
        inst["hit_rate"].set(hit_pages / max(lookups, 1))
        self._s = None
        self._sentinel = None

    @staticmethod
    def _pct(vals: list[float], q: float) -> float:
        return round(float(np.percentile(
            np.asarray(vals or [0.0], np.float64), q)), 4)

    def _metrics(self, s: _Session) -> dict:
        elapsed = self.clock() - s.t0
        lat, ttft = s.lat or [0.0], s.ttft or [0.0]
        ttft_hit = sum(cs["ttft_hit"] for cs in s.per_class.values())
        ttft_n = sum(cs["ttft_n"] for cs in s.per_class.values())
        classes = {name: {
            "n_requests": cs["n"], "n_completed": cs["completed"],
            "n_shed": cs["shed"],
            "ttft_p50_s": self._pct(cs["ttft"], 50),
            "ttft_p99_s": self._pct(cs["ttft"], 99),
            "tpot_p50_s": self._pct(cs["tpot"], 50),
            "tpot_p99_s": self._pct(cs["tpot"], 99),
            "ttft_hit_rate": round(cs["ttft_hit"] / max(cs["ttft_n"], 1), 4),
            "tpot_hit_rate": round(cs["tpot_hit"] / max(cs["tpot_n"], 1), 4),
        } for name, cs in s.per_class.items()}
        return {
            "n_requests": s.n_seen,
            "new_tokens": s.new_tokens,
            "elapsed_s": round(elapsed, 4),
            "decode_tok_s": round(s.decoded / max(s.decode_time, 1e-9), 1),
            "total_tok_s": round(s.new_tokens / max(elapsed, 1e-9), 1),
            "latency_mean_s": round(float(np.mean(lat)), 4),
            "latency_p95_s": round(float(np.percentile(lat, 95)), 4),
            "ttft_mean_s": round(float(np.mean(ttft)), 4),
            "ttft_p50_s": self._pct(s.ttft, 50),
            "n_admissions": s.n_admissions,
            "n_preemptions": s.n_preemptions,
            "n_prefill_chunks": self.engine.prefill_chunks - s.chunks0,
            "prefix_hit_pages": self.engine.prefix_hit_pages - s.hits0,
            "prefix_hit_rate": round(
                (self.engine.prefix_hit_pages - s.hits0)
                / max(self.engine.prefix_lookup_pages - s.lookups0, 1), 4),
            "n_shed": s.n_shed,
            "n_cancelled": s.n_cancelled,
            "deadline_hit_rate": round(ttft_hit / ttft_n, 4)
            if ttft_n else 1.0,
            "classes": classes,
        }

    # ---- the synchronous trace driver ----------------------------
    def run(self, requests: list[Request]) -> dict:
        """Serve a whole trace (requests wait for their ``arrival``
        offsets) and return the metrics dict."""
        for r in requests:
            self._check_fits(r)
            self.policy.validate(r)
        s = self._begin()
        self._s = s
        s.n_seen = len(requests)
        s.queue = sorted(requests, key=lambda r: r.arrival)
        if self.policy.slo:
            for r in requests:
                s.per_class[self.policy.cls_of(r).name]["n"] += 1
        try:
            with self._sentinel:
                while s.queue or s.live or s.filling:
                    self.step()
                    if not s.live and not s.filling and s.queue:
                        wait = min(r.arrival for r in s.queue) \
                            - (self.clock() - s.t0)
                        if wait > 0:
                            time.sleep(min(wait, 0.05))
        finally:
            self._land(s)
        return self._metrics(s)


__all__ = ["ContinuousBatcher", "Request"]
