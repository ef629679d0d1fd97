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

On a speculative engine each step is a verify step and a slot emits a
burst of 1 to ``draft_len + 1`` tokens; stop checks run per token in
order, so EOS or ``max_new_tokens`` cuts a burst where sequential decode
would stop. On a parallel-sampling engine an ``n``/``best_of`` request
prefills once and forks into ``best_of`` copy-on-write branches, which
ride every scheduling path as internal child requests;
:func:`best_completions` ranks them by cumulative logprob.

:meth:`ContinuousBatcher.step` is the pumpable per-iteration core and
:meth:`run` drives it over a whole trace, returning a metrics dict.
Every run feeds the telemetry registry (``serving_*``), lands one row
per step in the flight recorder, and is watched by a
:class:`RecompileSentinel` over the engine's count of distinct decode
step shapes, which must stay 1.

A request may carry an OpenAI ``response_format`` (a structured engine
binds its automaton cursor at seat time and replays a preempted
request's folded tokens into it) and an ``adapter`` name (a LoRA
engine pins the adapter's lane at seat time, leaving the request queued
while every lane is pinned, and drops the pin wherever the slot is
given up). Both are validated at submit.

On an engine with the host spill tier, queued promotions are issued
right before each prefill chunk, and the tier's traffic lands in the
registry, the flight rows and the metrics. The control surface an
external driver reads — ``has_work``, ``session_active``, ``inflight``,
``readiness``, ``drain_unfinished``, ``drain_queued`` and
``debug_snapshot`` — is the JAX batcher's, so a front door or a
:class:`~torchbooster_tpu_torch.serving.disagg.DisaggPair` pumps this
batcher as it pumps that one.
"""
from __future__ import annotations

import time
import uuid
import zlib
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
from torchbooster_tpu_torch.serving.kv_pages import PoolExhausted
from torchbooster_tpu_torch.serving.structured import (
    validate_response_format,
)
from torchbooster_tpu_torch.serving.frontend.scheduler import (
    FCFSPolicy,
    SchedulerPolicy,
)


@dataclass(eq=False)
class Request:
    """One generation request, compared by identity (the scheduler
    queues and cancels BY OBJECT). ``arrival`` is an offset in seconds
    from the batcher's clock start; ``eos_id=None`` never stops early;
    ``priority``/``deadline_ms`` matter only under an SLO policy.
    ``n`` completions are returned from ``best_of`` (default ``n``)
    decoded branches (a parallel-sampling engine); ``seed`` pins the
    request's sampling streams (branch b samples stream ``(seed, b)``;
    None derives it from the request id). ``response_format`` (None or
    ``{"type": "text"}``: unconstrained; ``json_object``,
    ``json_schema``, ``regex`` need a structured engine and an
    ``eos_id``) constrains the output; ``adapter`` names a registered
    LoRA adapter (``""``: the base model)."""
    prompt: np.ndarray
    max_new_tokens: int = 32
    eos_id: int | None = None
    arrival: float = 0.0
    priority: str = ""
    deadline_ms: float | None = None
    arrival_time: float | None = None
    n: int = 1
    best_of: int | None = None
    seed: int | None = None
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
    # fork bookkeeping: branch 0 is the submitted request; siblings are
    # internal child Requests pointing back via ``parent``; ``branches``
    # (branch 0 only) lists the family once forked; ``cum_logprob``
    # sums the picked tokens' logprobs for best_of ranking
    parent: "Request | None" = None
    branch: int = 0
    branches: "list | None" = None
    cum_logprob: float = 0.0

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
        if not isinstance(self.adapter, str):
            raise TypeError(
                f"adapter must be a registered adapter NAME (str, '' = "
                f"base model), got {type(self.adapter).__name__} "
                f"{self.adapter!r}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got "
                             f"{self.deadline_ms}")
        if not isinstance(self.n, int) or self.n < 1:
            raise ValueError(f"n must be an int >= 1, got {self.n!r}")
        if self.best_of is not None and (
                not isinstance(self.best_of, int) or self.best_of < self.n):
            raise ValueError(f"best_of must be an int >= n ({self.n}), got "
                             f"{self.best_of!r}")
        if self.seed is not None and not isinstance(self.seed, int):
            raise TypeError(f"seed must be an int or None, got "
                            f"{type(self.seed).__name__}")
        if self.response_format is not None:
            if not isinstance(self.response_format, dict):
                raise TypeError(
                    f"response_format must be a dict or None, got "
                    f"{type(self.response_format).__name__}")
            if self.response_format.get("type") != "text" \
                    and self.eos_id is None:
                raise ValueError(
                    "a constraining response_format requires eos_id: the "
                    "automaton terminates the output by forcing EOS at an "
                    "accepting state")
        if not self.request_id:
            self.request_id = "req-" + uuid.uuid4().hex[:16]
        if self.seed is None:
            self.seed = zlib.crc32(self.request_id.encode()) & 0x7fffffff
        # the ORIGINAL prompt length: preemption folds generated tokens
        # into ``prompt``, so the true context is base_len + len(tokens)
        self.base_len = int(self.prompt.size)

    @property
    def n_branches(self) -> int:
        """Branches decoded: ``best_of`` when set, else ``n``."""
        return self.best_of if self.best_of is not None else self.n


def best_completions(req: Request) -> list[Request]:
    """The ``n`` best of a finished request's ``best_of`` branches by
    cumulative logprob (ties keep branch order); ``[req]`` for a
    request that never forked."""
    family = req.branches or [req]
    return sorted(family, key=lambda r: -r.cum_logprob)[:req.n]


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
        self.spills0 = eng.spills
        self.promotions0 = eng.promotions
        self.host_hits0 = eng.host_hit_pages
        self.spec_steps0 = eng.spec_steps
        self.spec_prop0 = eng.spec_proposed
        self.spec_acc0 = eng.spec_accepted
        self.forks0 = eng.forks
        self.fork_pages0 = eng.fork_pages
        self.cow0 = eng.cow_copies
        self.structured0 = eng.structured_requests
        self.smasked0 = eng.structured_masked_sum
        self.srows0 = eng.structured_masked_rows
        # per-adapter attribution ("" = base) and the registry's counter
        # baselines, all zero on an engine without LoRA
        self.per_adapter: dict[str, dict] = {}
        ad = eng.adapters
        self.aloads0 = ad.loads if ad is not None else 0
        self.aevict0 = ad.evictions if ad is not None else 0
        self.ahits0 = ad.hits if ad is not None else 0
        self.closed = False

    def sample(self, series: list[float], value: float) -> None:
        series.append(value)
        if len(series) > self.MAX_SAMPLES:
            del series[:len(series) - self.MAX_SAMPLES]

    @property
    def has_seated(self) -> bool:
        return bool(self.live or self.filling)


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
        tp = getattr(engine, "_tp_attn", None)
        if tp is not None:
            # every rank of a tensor-parallel engine decides on rank 0's
            # clock (serving/tp.py), or their steps would part ways
            from torchbooster_tpu_torch.serving.tp import shared_clock

            clock = shared_clock(clock, tp[0], engine.device)
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
        eng = self.engine
        worst = req.base_len + req.max_new_tokens
        if worst > eng.cfg.seq_len:
            raise ValueError(
                f"prompt ({req.base_len}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds cfg.seq_len "
                f"({eng.cfg.seq_len})")
        nb = req.n_branches
        if nb > 1:
            if not eng.parallel:
                raise ValueError(
                    f"n/best_of > 1 ({req.n}/{req.best_of}) needs a "
                    "parallel-sampling engine: set "
                    "serving.parallel_sampling: true")
            if nb > eng.max_slots:
                raise ValueError(
                    f"best_of ({nb}) exceeds serving.max_slots "
                    f"({eng.max_slots}): every branch decodes in its own "
                    "slot")
            # the whole family alone: the full prompt pages once
            # (shared) + every branch's private tail and output pages
            shared = req.base_len // eng.page_size
            per_branch = eng.tables.pages_for(worst) - shared
            if shared + nb * per_branch > eng.n_pages - 1:
                raise ValueError(
                    f"request needs {shared} shared prompt pages + {nb} x "
                    f"{per_branch} per-branch pages but the pool holds "
                    f"{eng.n_pages - 1}; grow serving.n_pages or lower "
                    "best_of")
        # grow_slots demands 1 + draft_len write positions ahead of the
        # cursor every speculative step: admit against that peak, or a
        # request sized to the pool starves on its last page and
        # preempt-thrashes itself
        reserve = min(worst + eng.draft_len, eng.cfg.seq_len) \
            if eng.speculative else worst
        if eng.tables.pages_for(reserve) > eng.n_pages - 1:
            raise ValueError(
                f"request needs {reserve} tokens of pages "
                + (f"({worst} prompt+output + the speculative write-ahead) "
                   if reserve > worst else "")
                + f"but the pool holds {self._capacity}; grow "
                "serving.n_pages")
        if req.response_format is not None:
            # schema validation first: a bad spec names its fault
            # whatever the engine
            validate_response_format(req.response_format)
            if req.response_format.get("type") != "text":
                if not eng.structured:
                    raise ValueError(
                        "response_format type "
                        f"{req.response_format['type']!r} needs a "
                        "structured-generation engine: set "
                        "serving.structured.enabled: true")
                # compile now (cached on the engine): an unsatisfiable
                # schema or an EOS inside its alphabet fails at submit
                dfa = eng.structured_compile(req.response_format)
                if not 0 <= req.eos_id < eng.cfg.vocab:
                    raise ValueError(
                        f"eos_id {req.eos_id} outside the vocabulary "
                        f"(size {eng.cfg.vocab})")
                if bool(dfa.mask[:, req.eos_id].any()):
                    raise ValueError(
                        f"eos_id {req.eos_id} renders a character the "
                        "schema can emit — the EOS bit would shadow a "
                        "legal content token; pick an EOS id outside the "
                        "schema alphabet")
        if req.adapter:
            # an unknown name, or any adapter on an engine without lanes,
            # fails here; the seat-time acquire fails only on pins
            if not eng.lora:
                raise ValueError(
                    f"request names adapter {req.adapter!r} but the engine "
                    "has no LoRA lanes: set serving.adapters.rank > 0")
            if not eng.adapters.known(req.adapter):
                raise ValueError(f"unknown adapter {req.adapter!r} — "
                                 f"registered: {eng.adapters.names}")

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

    def _reserved_slots(self) -> int:
        """Slots spoken for by mid-prefill n-way requests: their
        ``best_of - 1`` siblings fork the moment prefill completes, so
        plain admissions must not seat into them."""
        s = self._s
        if s is None:
            return 0
        return sum(r.n_branches - 1 for r in s.filling.values()
                   if r.branches is None and r.n_branches > 1)

    def _free_slot_count(self) -> int:
        # the tables' own definition of unseated, shared with seating
        return self.engine.tables.n_free_slots()

    @property
    def occupancy(self) -> float:
        avail = self.engine.tables.n_available_pages
        return 1.0 - avail / max(self.engine.n_pages - 1, 1)

    @property
    def queue_depth(self) -> int:
        s = self._s
        return len(self._inbox_submit) + (len(s.queue) if s else 0)

    @property
    def has_work(self) -> bool:
        """Whether the open session has anything left to pump: queued,
        seated or inboxed requests."""
        s = self._s
        return s is not None and bool(
            s.queue or s.live or s.filling
            or self._inbox_submit or self._inbox_cancel)

    @property
    def session_active(self) -> bool:
        """Whether a pumpable session is open."""
        return self._s is not None

    @property
    def inflight(self) -> int:
        """Seated requests (prefilling + decoding)."""
        s = self._s
        return 0 if s is None else len(s.live) + len(s.filling)

    def readiness(self) -> dict:
        """The readiness payload (``batcher.py:555``): queue depth,
        free/cached/host pages, in-flight count, occupancy, the EWMA step
        estimate, and a staleness stamp (``step_seq``, the flight
        recorder's step count, beside ``stamped_s`` on the session
        clock). Host counters only."""
        eng = self.engine
        return {
            "status": "ok",
            "queue_depth": self.queue_depth,
            "pages_free": int(eng.tables.n_free_pages),
            "pages_cached": int(eng.tables.n_cached_pages),
            "pages_host": int(eng.tables.n_host_pages),
            "inflight": self.inflight,
            "occupancy": round(self.occupancy, 4),
            "est_step_s": round(self.est_step_s, 6),
            "step_seq": int(self.flight.n_recorded),
            "stamped_s": (round(self.clock() - self._s.t0, 6)
                          if self._s is not None else 0.0),
        }

    def drain_unfinished(self, retire_seated: bool = True) -> list:
        """Remove and return EVERY unfinished request of the session.
        Seated requests leave with their generated tokens folded into
        their prompts (the preemption fold), so a re-admission elsewhere
        re-prefills the full context and keeps the delivered tokens.
        ``retire_seated=False`` skips the engine retires (an engine that
        died is not to be trusted); adapter pins drop either way."""
        if self._s is None:
            return []
        s = self._s
        out: list[Request] = []
        while self._inbox_submit:
            out.append(self._inbox_submit.popleft())
        out.extend(s.queue)
        s.queue.clear()
        seated = sorted([*s.filling.items(), *s.live.items()],
                        key=lambda item: item[0])
        s.filling.clear()
        s.live.clear()
        s.admit_order.clear()
        for slot, req in seated:
            if retire_seated:
                self.engine.retire(slot)
            self._release_adapter(req)
            n = self._fold(req)
            if self.tracer.enabled:
                self.tracer.emit(req.request_id, "drained", slot=slot,
                                 fold_tokens=n)
            out.append(req)
        return out

    def drain_queued(self, n: int) -> list:
        """Remove and return up to ``n`` QUEUED (never seated) requests
        from the BACK of the queue, in arrival order — the cheap end of
        the readmission-cost scale (no engine state, no fold)."""
        if self._s is None or n < 1:
            return []
        s = self._s
        while self._inbox_submit:
            s.queue.append(self._inbox_submit.popleft())
        out: list[Request] = []
        while s.queue and len(out) < n:
            out.append(s.queue.pop())
        out.reverse()
        return out

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
            "spec_prop": reg.counter(
                "serving_spec_proposed_total",
                "draft tokens proposed to the speculative verify step"),
            "spec_acc": reg.counter("serving_spec_accepted_total",
                                    "draft tokens the verify step accepted"),
            "spec_rate": reg.gauge(
                "serving_spec_accept_rate",
                "accepted/proposed draft tokens over this run"),
            "fork_pages": reg.counter(
                "serving_fork_pages_total",
                "pages shared into sibling branches at fork "
                "(copy-on-write parallel sampling)"),
            "cow_copies": reg.counter(
                "serving_cow_copies_total",
                "private tail pages copied at fork (the only bytes n-way "
                "sampling duplicates)"),
        }
        if self.engine.structured:
            inst["structured"] = reg.counter(
                "serving_structured_requests_total",
                "constrained (response_format) requests admitted")
            inst["structured_frac"] = reg.gauge(
                "serving_structured_masked_frac",
                "mean masked-vocabulary fraction over committed "
                "constrained cursor rows this run")
        if self.engine.host_spill:
            # spill-tier traffic, only with the tier (the spill-less
            # registry view is unchanged)
            inst["spills"] = reg.counter(
                "serving_page_spills_total",
                "KV pages demoted HBM -> host at eviction")
            inst["promotions"] = reg.counter(
                "serving_page_promotions_total",
                "KV pages promoted host -> HBM at seat time")
            inst["host_hits"] = reg.counter(
                "serving_host_hit_pages_total",
                "prompt pages matched in the host spill tier")
        if self.engine.lora:
            inst["adapter_tokens"] = reg.counter(
                "serving_adapter_tokens_total",
                "tokens delivered per adapter name (per-tenant "
                "billing attribution)")
            inst["adapter_reqs"] = reg.counter(
                "serving_adapter_requests_total",
                "requests reaching a terminal state per adapter name")
            inst["adapter_loads"] = reg.counter(
                "serving_adapter_loads_total",
                "adapter lane hot-loads (cold load or refresh)")
            inst["adapter_evictions"] = reg.counter(
                "serving_adapter_evictions_total",
                "cached adapter lanes displaced (LRU)")
        if getattr(self.engine, "tp", 1) > 1:
            # tensor-parallel serving only (``batcher.py:814``): the
            # modeled per-rank wire bytes of each decode or verify
            # step's decode-output all-reduce, one host add a step
            inst["tp_bytes"] = reg.counter(
                "serving_tp_bytes_total",
                "modeled per-chip decode-output psum wire bytes "
                "(tensor-parallel serving)")
            self._tp_decode_bytes = \
                self.engine.tp_step_traffic(1)["wire_bytes"]
            self._tp_verify_bytes = self.engine.tp_step_traffic(
                1 + self.engine.draft_len)["wire_bytes"]
        if self.policy.slo:
            inst.update({
                "slo_ttft": reg.histogram("serving_slo_ttft_seconds",
                                          "per-class arrival -> first token"),
                "slo_tpot": reg.histogram("serving_slo_tpot_seconds",
                                          "per-class mean inter-token time"),
                "slo_shed": reg.counter(
                    "serving_slo_shed_total",
                    "requests shed by the SLO policy (per class)"),
                "slo_cancel": reg.counter(
                    "serving_slo_cancelled_total",
                    "requests cancelled by the client (per class)"),
                "slo_hit": reg.counter(
                    "serving_slo_deadline_hit_total",
                    "deadline hits (per class, kind=ttft|tpot)"),
                "slo_miss": reg.counter(
                    "serving_slo_deadline_miss_total",
                    "deadline misses (per class, kind=ttft|tpot)"),
                "slo_ttft_rate": reg.gauge(
                    "serving_slo_ttft_hit_rate",
                    "TTFT deadline hit rate over this run (per class)"),
                "slo_tpot_rate": reg.gauge(
                    "serving_slo_tpot_hit_rate",
                    "TPOT deadline hit rate over this run (per class)"),
                # live quantiles from the session reservoirs (labels cls
                # and q=p50|p99), refreshed at every completion
                "slo_ttft_q": reg.gauge(
                    "serving_slo_ttft_quantile",
                    "per-class TTFT quantile over the session "
                    "reservoir (labels cls, q)"),
                "slo_tpot_q": reg.gauge(
                    "serving_slo_tpot_quantile",
                    "per-class TPOT quantile over the session "
                    "reservoir (labels cls, q)"),
            })
        self._inst = inst
        s = _Session(self)
        if self.policy.slo:
            for name in self.policy.classes:
                s.per_class[name] = {
                    "n": 0, "completed": 0, "shed": 0, "ttft": [],
                    "tpot": [], "ttft_hit": 0, "ttft_n": 0,
                    "tpot_hit": 0, "tpot_n": 0}
        # the step's first shape signature is legitimate; any later one
        # is a broken fixed-shape contract (one watch covers the decode
        # and the verify step)
        step_shapes = lambda: (self.engine.decode_compiles
                               + self.engine.verify_compiles)
        self._sentinel = RecompileSentinel(
            step_shapes, on_recompile=self.on_recompile,
            expected=0 if step_shapes() else 1,
            name="serving_decode", registry=reg)
        return s

    def _class_stats(self, req: Request) -> dict | None:
        if not self.policy.slo:
            return None
        return self._s.per_class[self.policy.cls_of(req).name]

    def _release_adapter(self, req: Request) -> None:
        """Drop the request's lane pin: one per seated slot, so every
        path that gives a seated slot up comes through here once."""
        if req.adapter:
            self.engine.adapters.release(req.adapter)

    def _account_adapter(self, req: Request) -> None:
        """Per-adapter attribution at a request's terminal event: tokens
        delivered and requests closed under its adapter name ('' =
        base); nothing on an engine without LoRA."""
        if not self.engine.lora:
            return
        ad = self._s.per_adapter.setdefault(
            req.adapter, {"n_requests": 0, "new_tokens": 0})
        ad["n_requests"] += 1
        ad["new_tokens"] += len(req.tokens)
        label = req.adapter or "base"
        self._inst["adapter_reqs"].inc(adapter=label)
        if req.tokens:
            self._inst["adapter_tokens"].inc(len(req.tokens), adapter=label)

    def _finish_request(self, slot: int) -> None:
        s, inst = self._s, self._inst
        req = s.live.pop(slot)
        s.admit_order.remove(slot)
        req.finished_at = self.clock() - s.t0
        inst["retired"].inc()
        s.new_tokens += len(req.tokens)
        self._account_adapter(req)
        s.sample(s.lat, req.finished_at - req.arrival)
        inst["lat"].observe(req.finished_at - req.arrival)
        if req.first_token_at is not None:
            s.sample(s.ttft, req.first_token_at - req.arrival)
            inst["ttft"].observe(req.first_token_at - req.arrival)
        self.engine.retire(slot)
        self._release_adapter(req)
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
        # one percentile over the bounded reservoir per completion
        for kind, vals in (("ttft", cs["ttft"]), ("tpot", cs["tpot"])):
            if not vals:
                continue
            q50, q99 = np.percentile(np.asarray(vals, np.float64),
                                     [50, 99]).tolist()
            inst[f"slo_{kind}_q"].set(round(q50, 6), cls=cls.name, q="p50")
            inst[f"slo_{kind}_q"].set(round(q99, 6), cls=cls.name, q="p99")
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

    def _maybe_stop(self, slot: int, token: int,
                    finish: bool = True) -> bool:
        """Append ``token``, evaluate the stop conditions, retire when
        done (``finish=False`` leaves the retire to the caller, which
        emits a whole burst's event first). Returns True when the
        request finished."""
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
            if finish:
                self._finish_request(slot)
            return True
        return False

    def _cancel_request(self, req: Request, events: list) -> None:
        """Close a cancelled request; its delivered tokens count and are
        billed."""
        s = self._s
        req.cancelled = True
        req.finished_at = self.clock() - s.t0
        req.finish_reason = "cancelled"
        if self.tracer.enabled:
            self.tracer.emit(req.request_id, "cancelled",
                             n_tokens=len(req.tokens))
        s.n_cancelled += 1
        s.new_tokens += len(req.tokens)
        self._account_adapter(req)
        events.append((req, []))
        if self._class_stats(req) is not None:
            self._inst["slo_cancel"].inc(cls=self.policy.cls_of(req).name)

    def _shed_request(self, req: Request, events: list) -> None:
        """Close a request the policy shed from the queue."""
        s = self._s
        req.shed = True
        req.finished_at = self.clock() - s.t0
        req.finish_reason = "shed"
        if self.tracer.enabled:
            self.tracer.emit(req.request_id, "shed",
                             waited_s=round(req.finished_at
                                            - req.arrival, 6))
        s.n_shed += 1
        self._account_adapter(req)
        events.append((req, []))
        cs = self._class_stats(req)
        if cs is not None:
            cs["shed"] += 1
            self._inst["slo_shed"].inc(cls=self.policy.cls_of(req).name)

    def _drain_cancels(self, events: list) -> None:
        s = self._s
        while self._inbox_cancel:
            root = self._inbox_cancel.popleft()
            # cancelling an n-way request cancels its whole family
            for req in (root.branches or [root]):
                if req.finished_at is not None:
                    continue                  # raced completion
                if any(req is q for q in s.queue):
                    s.queue.remove(req)
                    self._cancel_request(req, events)
                    continue
                for table in (s.filling, s.live):
                    slot = next((sl for sl, r in table.items()
                                 if r is req), None)
                    if slot is not None:
                        table.pop(slot)
                        s.admit_order.remove(slot)
                        self.engine.retire(slot)
                        self._release_adapter(req)
                        self._cancel_request(req, events)
                        break

    @staticmethod
    def _fold(req: Request) -> int:
        """Fold the request's not-yet-folded generated tokens into its
        prompt, so a re-seat resumes from its full context (the prompt
        always holds ``base_len`` + the folded tokens, so a second fold
        never repeats one); returns how many were folded."""
        folded = len(req.prompt) - req.base_len
        req.prompt = np.concatenate(
            [req.prompt, np.asarray(req.tokens[folded:], np.int32)])
        return len(req.tokens) - folded

    def _preempt_one(self, s: _Session,
                     exclude: frozenset | set = frozenset()) -> bool:
        """Evict ONE policy-chosen seated victim to the front of the
        queue with its not-yet-folded generated tokens folded into its
        prompt; ``exclude`` shields slots the caller is working on (a
        forking parent). Returns False when no victim is eligible."""
        order = [sl for sl in s.admit_order if sl not in exclude]
        if not order:
            return False
        seated = {sl: r for sl, r in {**s.filling, **s.live}.items()
                  if sl not in exclude}
        victim = self.policy.select_victim(order, seated, self)
        req = s.live.pop(victim) if victim in s.live \
            else s.filling.pop(victim)
        s.admit_order.remove(victim)
        self.engine.retire(victim)
        # the pin drops with the seat (no billing); the re-seat acquires
        # whatever lane the registry then gives
        self._release_adapter(req)
        n = self._fold(req)
        if self.tracer.enabled:
            self.tracer.emit(req.request_id, "preempted", slot=victim,
                             fold_tokens=n)
        s.queue.insert(0, req)
        s.n_preemptions += 1
        self._inst["preemptions"].inc()
        return True

    def _fork_request(self, slot: int, req: Request, events: list) -> None:
        """Split a just-prefilled n-way request into its ``best_of``
        copy-on-write branches (``batcher.py:1128``): the engine forks
        the pages and samples every branch's first token; siblings ride
        every scheduling path as child Requests from here on. Under pool
        pressure the fork preempts policy victims — never its own
        family — and retries (``_check_fits`` guarantees the family fits
        an empty pool, so this ends)."""
        s = self._s
        while True:
            try:
                branches = self.engine.fork(slot, req.n_branches)
                break
            except PoolExhausted:
                if not self._preempt_one(s, exclude={slot}):
                    raise
        req.branch = 0
        family = [req]
        for b, (sb, _, _) in enumerate(branches[1:], start=1):
            child = Request(
                prompt=req.prompt, max_new_tokens=req.max_new_tokens,
                eos_id=req.eos_id, arrival=req.arrival,
                priority=req.priority, deadline_ms=req.deadline_ms,
                arrival_time=req.arrival_time,
                request_id=f"{req.request_id}#{b}", seed=req.seed,
                response_format=req.response_format, adapter=req.adapter)
            child.parent = req
            child.branch = b
            child.admitted_at = req.admitted_at
            if child.adapter:
                # one pin a seated slot: the sibling pins the lane (held
                # resident by the parent's pin) the fork gave its slot
                self.engine.adapters.acquire(child.adapter)
            s.live[sb] = child
            s.admit_order.append(sb)
            family.append(child)
        req.branches = family
        if self.tracer.enabled:
            self.tracer.emit(req.request_id, "forked",
                             n_branches=req.n_branches,
                             shared_pages=int(req.base_len
                                              // self.engine.page_size))
        for (sb, tok, lp), branch_req in zip(branches, family):
            branch_req.cum_logprob += lp
            self._maybe_stop(sb, int(tok))
            events.append((branch_req, [int(tok)]))

    def step(self) -> list[tuple[Request, list[int]]]:
        """ONE scheduling iteration: drain the inboxes, shed (policy),
        seat admissible requests (policy order), issue one prefill
        chunk, grow/preempt, then one decode step. Returns this
        iteration's ``(request, tokens)`` events and lands one flight
        recorder row."""
        if self._s is None:
            raise RuntimeError("no active session: start_session() first")
        s, eng = self._s, self.engine
        compiles = lambda: (eng.decode_compiles + eng.verify_compiles
                            + eng.prefill_compiles)
        c0 = compiles()
        # this step's tier traffic (deltas of the engine's counters); the
        # promotion write's one shape is the contract, so it is left out
        # of the recompile diff
        sp0, pr0, hh0 = eng.spills, eng.promotions, eng.host_hit_pages
        st = {"wall": 0.0, "prefill": False, "decode": False,
              "spec": False, "prop": 0, "acc": 0}
        events: list = []
        try:
            self._step_body(s, st, events)
        finally:
            recompiled = compiles() > c0
            self.flight.record(
                kind=step_kind_code(st["prefill"], st["decode"],
                                    st["spec"]),
                slots_live=len(s.live), slots_filling=len(s.filling),
                pages_live=int(eng.tables.n_live_pages),
                pages_free=int(eng.tables.n_free_pages),
                pages_cached=int(eng.tables.n_cached_pages),
                pages_host=int(eng.tables.n_host_pages),
                spills=eng.spills - sp0,
                promotions=eng.promotions - pr0,
                host_hit_pages=eng.host_hit_pages - hh0,
                queue_depth=len(s.queue),
                tokens=sum(len(t) for _, t in events),
                accept_rate=st["acc"] / st["prop"] if st["prop"] else 0.0,
                wall_s=st["wall"], recompiled=recompiled,
                inflight=([r.request_id for r in (*s.filling.values(),
                                                  *s.live.values())]
                          if recompiled else ()),
                branches=eng.branch_slot_count,
                structured=eng.structured_slot_count,
                adapters=eng.adapter_slot_count)
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
                                 priority=req.priority,
                                 arrival=round(req.arrival, 6))
            cs = self._class_stats(req)
            if cs is not None:
                cs["n"] += 1
        self._drain_cancels(events)
        for req in self.policy.shed(s.queue, now(), self):
            s.queue.remove(req)
            self._shed_request(req, events)
        # --- seat every admissible request the policy picks (FCFS
        # stops at the first failed seat: head-of-line order) ---
        tried: set[int] = set()
        while True:
            pool = [r for r in s.queue if id(r) not in tried]
            req = self.policy.next_admission(pool, now(), self)
            if req is None:
                break
            hits0 = self.engine.prefix_hit_pages
            # an n-way request needs its whole family's slots free (it
            # seats one now and reserves the rest for its fork); plain
            # requests must not eat into standing reservations
            need = req.n_branches if req.branches is None else 1
            slot = None
            if self._free_slot_count() - self._reserved_slots() >= need:
                # the adapter pin before the seat: None when every lane
                # is pinned keeps the request queued, as a full pool
                # does; a seat that then fails drops the pin again
                lane = (self.engine.adapters.acquire(req.adapter)
                        if req.adapter else 0)
                if lane is not None:
                    slot = self.engine.admit_begin(
                        req.prompt, seed=req.seed, branch=req.branch,
                        adapter_lane=lane)
                    if slot is None:
                        self._release_adapter(req)
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
            if self.engine.structured and req.response_format is not None:
                # bind the cursor at seat time; a preempted request's
                # folded tokens (prompt past base_len) replay into it
                if self.engine.structured_begin(
                        slot, req.response_format, req.eos_id,
                        prefix_tokens=req.prompt[req.base_len:]):
                    self._inst["structured"].inc()
            if self.tracer.enabled:
                self.tracer.emit(
                    req.request_id, "seated", slot=slot,
                    prefix_hit_pages=int(self.engine.prefix_hit_pages
                                         - hits0),
                    readmission=req.admitted_at is not None,
                    # adapter attribution only when one is in play
                    **({"adapter": req.adapter} if req.adapter else {}))
            if req.admitted_at is None:
                req.admitted_at = now()
        # --- ONE prefill chunk per iteration, interleaved with decode ---
        if self.engine.has_pending:
            # host->device promotions go out BEFORE the chunk, on the
            # same stream: the chunk that attends promoted pages runs
            # after their write
            if self.engine.host_spill:
                self.engine.issue_promotions()
            # the chunk's slot, read only when tracing will use it
            fill_slot = (self.engine.pending_slots[0]
                         if self.tracer.enabled else -1)
            t_chunk = self.clock()
            done = self.engine.prefill_step()
            dt = self.clock() - t_chunk
            self.est_chunk_s = dt if not self.est_chunk_s \
                else 0.8 * self.est_chunk_s + 0.2 * dt
            st["prefill"] = True
            st["wall"] += dt
            if self.tracer.enabled:
                self.tracer.emit(None, "serving_prefill_chunk",
                                 dur_s=round(dt, 6), slot=fill_slot)
                fr = s.filling.get(fill_slot)
                if fr is not None:
                    self.tracer.emit(fr.request_id, "prefill_chunk",
                                     slot=fill_slot, dur_s=round(dt, 6))
            if done is not None:
                slot, first = done
                req = s.filling.pop(slot)
                s.live[slot] = req
                if req.n_branches > 1 and req.branches is None:
                    # one prefill, best_of branches from token one
                    self._fork_request(slot, req, events)
                else:
                    # the first token's logprob counts too (n = 1 and
                    # re-admitted branches alike); frees the fork stash
                    req.cum_logprob += self.engine.take_first_logprob(slot)
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
        if getattr(self.engine, "tp", 1) > 1:
            self._inst["tp_bytes"].inc(
                self._tp_verify_bytes if self.engine.speculative
                else self._tp_decode_bytes)
        if self.engine.speculative:
            self._spec_arm(s, st, events, t_step)
            return
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
        lps = self.engine.step_logprobs     # None unless parallel sampling
        for slot in list(s.live):
            req = s.live[slot]
            if lps is not None:
                req.cum_logprob += float(lps[slot])
            if self.tracer.enabled:
                self.tracer.emit(req.request_id, "tokens", n=1)
            self._maybe_stop(slot, int(tokens[slot]))
            events.append((req, [int(tokens[slot])]))

    def _spec_arm(self, s: _Session, st: dict, events: list,
                  t_step: float) -> None:
        """One speculative step (``batcher.py:1434``): each slot emits a
        burst; stop checks run per token in order, so EOS or
        ``max_new_tokens`` cuts the burst where sequential decode would
        stop, and only delivered tokens count."""
        eng = self.engine
        prop0, acc0 = eng.spec_proposed, eng.spec_accepted
        emitted = eng.spec_step()
        dt = self.clock() - t_step
        s.decode_time += dt
        self.est_step_s = dt if not self.est_step_s \
            else 0.8 * self.est_step_s + 0.2 * dt
        st["spec"] = True
        st["wall"] += dt
        st["prop"] = eng.spec_proposed - prop0
        st["acc"] = eng.spec_accepted - acc0
        if self.tracer.enabled:
            self.tracer.emit(None, "spec_verify_step", dur_s=round(dt, 6),
                             slots=len(emitted), proposed=st["prop"],
                             accepted=st["acc"])
        # a cancel that landed while the step ran drops the whole burst
        self._drain_cancels(events)
        delivered = 0
        for slot in sorted(emitted):
            req = s.live.get(slot)
            if req is None:
                continue
            burst: list[int] = []
            finished = False
            for tok in emitted[slot]:
                burst.append(int(tok))
                finished = self._maybe_stop(slot, int(tok), finish=False)
                if finished:
                    break
            delivered += len(burst)
            if self.tracer.enabled:
                self.tracer.emit(req.request_id, "tokens", n=len(burst),
                                 spec=True)
            events.append((req, burst))
            if finished:
                self._finish_request(slot)
        s.decoded += delivered
        self._inst["tokens"].inc(delivered)

    def debug_snapshot(self, timeline_tail: int = 20) -> dict:
        """Live per-request view for ``/debug/requests`` (``batcher.py:
        1521``): every queued, prefilling and decoding request's state
        and, with tracing on, the tail of its event timeline. Runs on the
        thread that drives :meth:`step`."""
        s = self._s
        timelines: dict[str, list] = {}
        if self.tracer.enabled:
            for e in self.tracer.events():
                rid = e["request_id"]
                if rid is not None:
                    timelines.setdefault(rid, []).append(e)

        def view(req: Request, state: str, slot: int | None = None) -> dict:
            d = {
                "request_id": req.request_id, "state": state,
                "priority": req.priority,
                "adapter": req.adapter,
                "prompt_len": int(req.base_len),
                "n_tokens": len(req.tokens),
                "arrival_s": round(req.arrival, 6),
                "admitted_at_s": None if req.admitted_at is None
                else round(req.admitted_at, 6),
                "first_token_at_s": None if req.first_token_at is None
                else round(req.first_token_at, 6),
            }
            if slot is not None:
                d["slot"] = slot
            if self.tracer.enabled:
                d["timeline_tail"] = \
                    timelines.get(req.request_id, [])[-timeline_tail:]
            return d

        out: dict = {"active_session": s is not None,
                     "tracing_enabled": self.tracer.enabled,
                     "queue_depth": self.queue_depth if s is not None
                     else len(self._inbox_submit),
                     "requests": []}
        if s is None:
            return out
        out["session_now_s"] = round(self.clock() - s.t0, 6)
        for req in s.queue:
            out["requests"].append(view(req, "queued"))
        for slot, req in sorted(s.filling.items()):
            out["requests"].append(view(req, "prefill", slot))
        for slot, req in sorted(s.live.items()):
            out["requests"].append(view(req, "decode", slot))
        return out

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
        eng = self.engine
        n_prop = eng.spec_proposed - s.spec_prop0
        n_acc = eng.spec_accepted - s.spec_acc0
        inst["spec_prop"].inc(n_prop)
        inst["spec_acc"].inc(n_acc)
        inst["spec_rate"].set(n_acc / max(n_prop, 1))
        inst["fork_pages"].inc(eng.fork_pages - s.fork_pages0)
        inst["cow_copies"].inc(eng.cow_copies - s.cow0)
        if "structured" in inst:
            rows = eng.structured_masked_rows - s.srows0
            inst["structured_frac"].set(
                (eng.structured_masked_sum - s.smasked0) / max(rows, 1))
        if "spills" in inst:
            inst["spills"].inc(eng.spills - s.spills0)
            inst["promotions"].inc(eng.promotions - s.promotions0)
            inst["host_hits"].inc(eng.host_hit_pages - s.host_hits0)
        if "adapter_loads" in inst:
            inst["adapter_loads"].inc(eng.adapters.loads - s.aloads0)
            inst["adapter_evictions"].inc(eng.adapters.evictions
                                          - s.aevict0)
        if self.policy.slo:
            for name, cs in s.per_class.items():
                for kind in ("ttft", "tpot"):
                    inst[f"slo_{kind}_rate"].set(
                        cs[f"{kind}_hit"] / max(cs[f"{kind}_n"], 1),
                        cls=name)
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
        eng = self.engine
        n_prop = eng.spec_proposed - s.spec_prop0
        n_acc = eng.spec_accepted - s.spec_acc0
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
            # speculation (zero on a non-speculative engine): tokens a
            # step are spec_mean_accepted + 1 (the fallback/bonus pick)
            "n_spec_steps": eng.spec_steps - s.spec_steps0,
            "n_spec_proposed": n_prop,
            "n_spec_accepted": n_acc,
            "spec_accept_rate": round(n_acc / max(n_prop, 1), 4),
            "spec_mean_accepted": round(
                n_acc / max(eng.spec_steps - s.spec_steps0, 1), 4),
            # the host spill tier (zero without it): demotions,
            # promotions, and the prompt pages matched in the host tier
            "n_spills": eng.spills - s.spills0,
            "n_promotions": eng.promotions - s.promotions0,
            "host_hit_pages": eng.host_hit_pages - s.host_hits0,
            # copy-on-write parallel sampling (zero without forks)
            "n_forks": eng.forks - s.forks0,
            "fork_pages": eng.fork_pages - s.fork_pages0,
            "n_cow_copies": eng.cow_copies - s.cow0,
            # structured generation (zero on an unconstrained run)
            "n_structured": eng.structured_requests - s.structured0,
            "structured_masked_frac": round(
                (eng.structured_masked_sum - s.smasked0)
                / max(eng.structured_masked_rows - s.srows0, 1), 4),
            # LoRA lanes: registry churn, and requests and delivered
            # tokens by adapter name (empty without LoRA)
            "n_adapter_loads": (eng.adapters.loads - s.aloads0
                                if eng.adapters is not None else 0),
            "n_adapter_evictions": (eng.adapters.evictions - s.aevict0
                                    if eng.adapters is not None else 0),
            "n_adapter_hits": (eng.adapters.hits - s.ahits0
                               if eng.adapters is not None else 0),
            "adapters": {name: dict(ad) for name, ad
                         in sorted(s.per_adapter.items())},
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
        if self.tracer.enabled:
            for r in s.queue:
                self.tracer.emit(r.request_id, "enqueued",
                                 prompt_len=int(r.base_len),
                                 priority=r.priority,
                                 arrival=round(r.arrival, 6))
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


__all__ = ["ContinuousBatcher", "Request", "best_completions"]
