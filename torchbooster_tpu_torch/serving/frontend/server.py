"""Asyncio OpenAI-compatible serving front door — the port of
``torchbooster_tpu/serving/frontend/server.py``.

:class:`ServingFrontend` is a stdlib-only asyncio HTTP server over a
:class:`~torchbooster_tpu_torch.serving.batcher.ContinuousBatcher`,
exposing

- ``POST /v1/completions`` and ``POST /v1/chat/completions`` —
  OpenAI-dialect JSON, ``stream: true`` for SSE (one event per decoded
  token, or per accepted speculative burst), request ids (a client
  ``X-Request-Id`` header is honored, echoed on the response, and
  becomes the id tracing files carry), usage accounting,
  ``finish_reason`` stop/length; ``n``/``best_of`` parallel sampling
  on a ``parallel_sampling: true`` engine — one prefill forks into
  copy-on-write branches, streamed chunks carry their branch's
  ``index``, ``best_of > n`` returns the n best by sequence logprob
  (unary only — the OpenAI rule), and ``usage`` aggregates every
  decoded branch over the ONE prompt prefill; ``response_format``
  structured generation on a ``serving.structured.enabled: true``
  engine — ``json_object`` | ``json_schema`` | ``regex`` compile to
  a token-DFA that masks every sampling step (malformed or
  unsupported schemas, unknown types, and missing ``eos_id`` all
  answer 400 naming the problem before any pages move);
- ``GET /metrics`` — the telemetry registry's Prometheus exposition
  (the ``serving_*``/``serving_slo_*`` series, scrape-ready);
- ``GET /healthz`` — liveness + pool occupancy; ``?full=1`` upgrades
  it to the readiness payload (free/cached pages, in-flight count,
  EWMA step estimate — the same dict the fleet router's load scorer
  reads, per-replica rows included when serving an ``EngineFleet``);
- ``GET /debug/requests`` — live per-request scheduler state (+ each
  request's trace-timeline tail when tracing is on);
- ``GET /debug/engine`` — pool occupancy, prefix-cache stats, compile
  counts, backend, the flight-recorder tail and its watchdog
  anomalies;
- ``GET /debug/router`` — fleet front doors only: router stats
  (+ per-replica health when scored) and the routing-decision audit
  tail (``?tail=N``); 404 when serving a single batcher;
- ``GET /debug/trace?id=<request_id>`` — one request's full event
  list from the tracing ring.

The ``/debug`` reads run ON the pump executor, serialized with
``batcher.step()`` — introspection can never race the scheduler's
session dicts, and (being host bookkeeping only) can never stall a
device dispatch. When the pump DIES, the terminal-error path dumps
the engine flight recorder (and the request trace, when enabled) to
``crash_dump_path`` before the exception resurfaces at ``stop()`` —
the post-mortem survives the process.

The engine never runs on the event loop: a single pump task drives
``batcher.step()`` through a one-thread executor (the step's launches
and its one device-to-host copy block THAT thread; the loop keeps
accepting, parsing, streaming), and every client-visible effect
travels through the batcher's thread-safe ``submit``/``cancel``
inboxes and per-step token events — host ints the step has already
copied back, so the loop thread never touches a device tensor. Torch's
current device is per thread: the executor's initializer sets the
engine's card on the pump thread, and every engine op (the paged
decode kernel among them) runs on that thread's current stream.
Client disconnects cancel their request mid-prefill or mid-decode
through the engine's abort paths — pages reclaimed, zero recompiles. Backpressure is explicit: a full queue or an SLO-policy
shed answers **429 + Retry-After** before any pool pages move.
Shutdown is graceful by default — stop accepting, drain seated work,
close the telemetry session (and its recompile-sentinel watch).

Nothing here imports beyond the stdlib, numpy and torch; optional
uvloop acceleration (where it is installed) is a pure event-loop swap
via :func:`install_uvloop`.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import json
import time
from pathlib import Path
from urllib.parse import parse_qs

import numpy as np
import torch

from torchbooster_tpu_torch.serving.batcher import ContinuousBatcher, Request
from torchbooster_tpu_torch.serving.frontend.http import (
    SSE_DONE,
    HttpError,
    error_response,
    json_response,
    read_request,
    sse_event,
    sse_head,
    text_response,
)


def install_uvloop() -> bool:
    """Swap in uvloop's event loop policy when it is installed; False —
    and stdlib asyncio, which is fully supported — otherwise. Never
    required: the server is pure asyncio."""
    try:
        import uvloop  # type: ignore[import-not-found]
    except ImportError:
        return False
    uvloop.install()
    return True


class IdCodec:
    """Tokenizer-free text<->ids codec: "text" is whitespace-separated
    token ids (``"12 7 903"``). The front door is model-agnostic —
    callers with a real tokenizer pass any object with this
    ``encode``/``decode`` surface; the default keeps the server (and
    its tests/benches) runnable with no vocab asset at all, and
    OpenAI-style token-array prompts bypass encoding entirely."""

    def encode(self, text: str) -> list[int]:
        try:
            return [int(t) for t in text.split()]
        except ValueError:
            raise HttpError(
                400, "the default codec accepts whitespace-separated "
                "token ids (or pass `prompt` as a token array); "
                "configure a tokenizer codec for raw text") from None

    def decode(self, ids: list[int]) -> str:
        return "".join(f"{i} " for i in ids)


class _Stream:
    """Per-request event mailbox the pump fills and one handler
    drains."""

    __slots__ = ("req", "queue")

    def __init__(self, req: Request):
        self.req = req
        self.queue: asyncio.Queue = asyncio.Queue()


def _pump_initializer(batcher):
    """The pump thread's initializer: make the engine's card torch's
    current device on that thread (the current device is per thread),
    so every engine op it runs lands on the engine's card and that
    card's current stream. Nothing to do for a CPU engine."""
    engine = getattr(batcher, "engine", None)
    device = getattr(engine, "device", None)
    if device is None or device.type != "cuda":
        return None, ()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch.cuda.set_device, (index,)


class ServingFrontend:
    """The asyncio front door over a
    :class:`~torchbooster_tpu_torch.serving.batcher.ContinuousBatcher`.

    ``await start()`` opens the batcher session (instruments + the
    recompile-sentinel watch for the server's whole lifetime) and
    binds ``host:port`` (port 0 = ephemeral; read :attr:`port`).
    ``await stop()`` drains and returns the batcher's session metrics
    dict. ``max_queue`` bounds the submit queue — beyond it requests
    are answered 429 before touching the scheduler; the policy's
    ``retry_after_s`` prices the Retry-After header. ``codec``
    converts text prompts to ids (default :class:`IdCodec`)."""

    def __init__(self, batcher: ContinuousBatcher,
                 host: str = "127.0.0.1", port: int = 0, *,
                 codec=None, max_queue: int = 64,
                 model_name: str = "torchbooster-tpu",
                 crash_dump_path: str | None = None,
                 capture_path: str | None = None,
                 capture_scrub: bool = False):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.batcher = batcher
        self.host = host
        self._port = port
        self.codec = codec if codec is not None else IdCodec()
        self.max_queue = max_queue
        self.model_name = model_name
        # pump post-mortem: a PREFIX — the terminal-error path writes
        # <prefix>.flight.jsonl (the engine ring) and, when tracing is
        # enabled, <prefix>.trace.json (Chrome trace). None keeps the
        # dump in memory only (self.last_flight).
        self.crash_dump_path = crash_dump_path
        self.last_flight: dict | None = None
        # workload capture (serving/loadgen): every accepted submit is
        # observed, and stop() writes the versioned JSONL trace —
        # arrival offsets, prompts (or scrubbed recipes), priorities,
        # deadlines, and client cancel offsets keyed by request_id —
        # that `replay_inprocess`/`replay_http` re-offer verbatim
        self.capture_path = capture_path
        self.capture = None
        if capture_path:
            from torchbooster_tpu_torch.serving.loadgen.workload import (
                WorkloadCapture)

            self.capture = WorkloadCapture(scrub=capture_scrub)
        self._server: asyncio.AbstractServer | None = None
        self._pump_task: asyncio.Task | None = None
        self._exec = None
        self._wake = asyncio.Event()
        self._streams: dict[int, _Stream] = {}
        self._handlers: set[asyncio.Task] = set()
        self._stopping = False
        self.last_metrics: dict | None = None

    # ---- lifecycle -----------------------------------------------
    @property
    def port(self) -> int:
        if self._server is not None:
            return self._server.sockets[0].getsockname()[1]
        return self._port

    async def start(self) -> None:
        if self._server is not None:
            raise RuntimeError("frontend already started")
        self.batcher.start_session()
        # ONE worker thread owns every engine call: the step blocks
        # it, not the event loop, and batcher state never sees
        # two drivers (submit/cancel cross over via the inboxes)
        init, init_args = _pump_initializer(self.batcher)
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tb-serve-pump",
            initializer=init, initargs=init_args)
        self._stopping = False
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self._port)
        self._pump_task = asyncio.create_task(self._pump())

    async def stop(self, drain: bool = True) -> dict:
        """Graceful shutdown: stop accepting, let seated/queued work
        finish (``drain=False`` cancels it instead), stop the pump,
        close the batcher session. Returns the session metrics."""
        if self._server is None:
            raise RuntimeError("frontend not started")
        self._stopping = True
        self._server.close()
        await self._server.wait_closed()
        if not drain:
            for stream in list(self._streams.values()):
                self.batcher.cancel(stream.req)
        self._wake.set()
        pump_exc = None
        if self._pump_task is not None:
            try:
                await self._pump_task
            except Exception as exc:   # close the session, THEN re-raise
                pump_exc = exc
        if self._handlers:
            await asyncio.gather(*self._handlers,
                                 return_exceptions=True)
        self._exec.shutdown(wait=True)
        self._server = None
        self._pump_task = None
        self.last_metrics = self.batcher.finish_session()
        if self.capture is not None:
            # every observed request is terminal by now (drained, or
            # cancelled by the no-drain shutdown above), so cancel
            # offsets are final — write the replayable trace. A
            # failed write is loud on a clean stop, but must never
            # MASK the pump's own terminal error below.
            try:
                self.capture.write(self.capture_path)
            except Exception:
                if pump_exc is None:
                    raise
        if pump_exc is not None:
            raise pump_exc
        return self.last_metrics

    # ---- the pump ------------------------------------------------
    async def _pump(self) -> None:
        """Drive ``batcher.step()`` off-loop and fan its token events
        out to the per-request mailboxes. The loop thread only ever
        parses/streams; the executor thread only ever steps. A step
        that RAISES (engine failure) must not strand handlers blocked
        on their mailboxes forever — every in-flight request gets a
        terminal error event and the exception resurfaces at
        ``stop()``."""
        loop = asyncio.get_running_loop()
        try:
            while True:
                if not self.batcher.has_work:
                    if self._stopping:
                        break
                    self._wake.clear()
                    # the timeout is a liveness belt: submit()/cancel()
                    # always set the event, but a cheap periodic poll
                    # keeps shutdown and clock-driven arrivals honest
                    try:
                        await asyncio.wait_for(self._wake.wait(),
                                               timeout=0.5)
                    except asyncio.TimeoutError:
                        pass
                    continue
                events = await loop.run_in_executor(
                    self._exec, self.batcher.step)
                # a request may get several events in one step (its
                # prefill token, then the same iteration's decode
                # token): the finished flag rides only the LAST one,
                # or a handler would close its stream with tokens
                # still queued behind. Fork-branch events route to
                # the PARENT's stream (one HTTP exchange serves the
                # whole n-way family), carrying their branch index;
                # the stream closes only when EVERY branch is
                # terminal.
                def stream_of(req):
                    s = self._streams.get(id(req))
                    if s is None and req.parent is not None:
                        s = self._streams.get(id(req.parent))
                    return s

                last = {}
                for i, (req, _) in enumerate(events):
                    s = stream_of(req)
                    if s is not None:
                        last[id(s)] = i
                for i, (req, tokens) in enumerate(events):
                    stream = stream_of(req)
                    if stream is None:
                        continue
                    family = (req.parent.branches if req.parent
                              else req.branches) or [req]
                    done = (all(r.finished_at is not None
                                for r in family)
                            and last[id(stream)] == i)
                    stream.queue.put_nowait(
                        (req.branch, tokens,
                         req.finish_reason
                         if req.finished_at is not None else None,
                         done))
        except Exception:
            self._stopping = True
            # the post-mortem FIRST: persist what the engine was doing
            # when the pump died, before any handler unwinds state
            self._crash_dump()
            for stream in list(self._streams.values()):
                if stream.req.finished_at is None:
                    stream.req.finish_reason = "error"
                stream.queue.put_nowait((0, [], "error", True))
            raise

    def _crash_dump(self) -> None:
        """Terminal-error flight dump: snapshot the engine ring into
        ``last_flight`` and (when ``crash_dump_path`` is set) write
        ``<prefix>.flight.jsonl`` + ``<prefix>.trace.json``. A
        fleet-fronted server dumps EVERY replica's ring tagged with
        its replica id plus the router audit-trail tail into the one
        file — a single replica-blind ring would pin the whole
        fleet's death on replica 0. Must never raise — a failed dump
        must not mask the pump's own error."""
        try:
            if hasattr(self.batcher, "replicas"):
                self._crash_dump_fleet()
                return
            self.last_flight = self.batcher.flight.dump()
            if self.crash_dump_path:
                prefix = str(self.crash_dump_path)
                self.batcher.flight.write_jsonl(
                    prefix + ".flight.jsonl")
                if self.batcher.tracer.enabled:
                    self.batcher.tracer.write_chrome(
                        prefix + ".trace.json")
        except Exception:  # noqa: BLE001 — diagnostics only
            pass

    def _crash_dump_fleet(self) -> None:
        """The fleet post-mortem: one ``.flight.jsonl`` holding every
        replica's retained flight records/anomalies (each line tagged
        ``replica``) followed by the router's last routing decisions —
        who was routed where, and why, right up to the death."""
        fleet = self.batcher
        dumps: dict[int, dict] = {}
        for rep in fleet.replicas:
            batcher = getattr(rep, "batcher", None)
            if batcher is None:
                continue
            d = batcher.flight.dump()
            d["alive"] = bool(rep.alive)
            dumps[rep.replica_id] = d
        audit_tail = (fleet.audit.tail()
                      if getattr(fleet, "audit", None) is not None
                      else [])
        self.last_flight = {"replicas": dumps,
                            "router_audit": audit_tail}
        if not self.crash_dump_path:
            return
        prefix = str(self.crash_dump_path)
        path = Path(prefix + ".flight.jsonl")
        path.parent.mkdir(parents=True, exist_ok=True)
        lines = [json.dumps({
            "event": "fleet_flight_header",
            "n_replicas": len(fleet.replicas),
            "n_audit": len(audit_tail)})]
        for rid in sorted(dumps):
            d = dumps[rid]
            lines.append(json.dumps({
                "event": "flight_header", "replica": rid,
                "alive": d["alive"], "n_recorded": d["n_recorded"],
                "capacity": d["capacity"],
                "rolling_p99_s": d["rolling_p99_s"]}))
            lines += [json.dumps({"event": "flight_step",
                                  "replica": rid, **rec})
                      for rec in d["records"]]
            lines += [json.dumps({"event": "flight_anomaly",
                                  "replica": rid, **a})
                      for a in d["anomalies"]]
        lines += [json.dumps({"event": "router_decision", **rec},
                             default=str)
                  for rec in audit_tail]
        path.write_text("\n".join(lines) + "\n", encoding="utf-8")
        if fleet.tracer.enabled:
            # fleet form: request/engine tracks + the router track
            fleet.write_chrome(prefix + ".trace.json")

    def _register(self, req: Request) -> _Stream:
        stream = _Stream(req)
        self._streams[id(req)] = stream
        return stream

    def _unregister(self, req: Request) -> None:
        self._streams.pop(id(req), None)

    # ---- connection handling -------------------------------------
    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._handlers.add(task)
        try:
            await self._serve_one(reader, writer)
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._handlers.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _serve_one(self, reader, writer) -> None:
        try:
            request = await read_request(reader)
            if request is None:
                return
            if self._stopping:
                raise HttpError(503, "server is shutting down")
            path, _, query = request.path.partition("?")
            route = (request.method, path)
            if route == ("POST", "/v1/completions"):
                await self._completion(request, reader, writer,
                                       chat=False)
            elif route == ("POST", "/v1/chat/completions"):
                await self._completion(request, reader, writer,
                                       chat=True)
            elif route == ("GET", "/metrics"):
                from torchbooster_tpu_torch.observability.export import (
                    prometheus_text)

                writer.write(text_response(200, prometheus_text()))
            elif route == ("GET", "/healthz"):
                # ?full=1 upgrades the liveness ping to the READINESS
                # payload (queue depth, free/cached pages, in-flight
                # count, EWMA step estimate) — the same dict the
                # fleet router's load scorer consumes
                # (batcher/fleet.readiness()), so an external health
                # probe and the routing decision can never read
                # different numbers. The bare form keeps its historic
                # key set for existing checks.
                ready = self.batcher.readiness()
                if (parse_qs(query).get("full") or ["0"])[0] \
                        not in ("", "0", "false"):
                    writer.write(json_response(200, ready))
                else:
                    writer.write(json_response(200, {
                        "status": ready["status"],
                        "queue_depth": ready["queue_depth"],
                        "pages_free": ready["pages_free"],
                        "occupancy": ready["occupancy"],
                    }))
            elif route == ("GET", "/debug/requests"):
                # serialized with step() on the pump executor: the
                # snapshot walks the scheduler's session dicts
                snap = await asyncio.get_running_loop() \
                    .run_in_executor(self._exec,
                                     self.batcher.debug_snapshot)
                writer.write(json_response(200, snap))
            elif route == ("GET", "/debug/engine"):
                payload = await asyncio.get_running_loop() \
                    .run_in_executor(self._exec, self._engine_debug)
                writer.write(json_response(200, payload))
            elif route == ("GET", "/debug/router"):
                # fleet front doors only: router stats + the audit
                # ring's decision tail (404 for a single batcher — no
                # router exists to walk)
                if not hasattr(self.batcher, "debug_router"):
                    raise HttpError(
                        404, "no router: this server fronts a single "
                        "batcher, not an EngineFleet")
                tail = int((parse_qs(query).get("tail")
                            or ["64"])[0] or 64)
                payload = await asyncio.get_running_loop() \
                    .run_in_executor(
                        self._exec,
                        lambda: self.batcher.debug_router(tail=tail))
                writer.write(json_response(200, payload))
            elif route == ("GET", "/debug/trace"):
                writer.write(json_response(200, self._trace_of(query)))
            elif path in ("/v1/completions", "/v1/chat/completions",
                          "/metrics", "/healthz", "/debug/requests",
                          "/debug/engine", "/debug/router",
                          "/debug/trace"):
                raise HttpError(405,
                                f"{request.method} not allowed here")
            else:
                raise HttpError(404, f"no route {path}")
            await writer.drain()
        except HttpError as err:
            writer.write(error_response(err))
            await writer.drain()

    # ---- introspection -------------------------------------------
    def _engine_debug(self) -> dict:
        """The ``/debug/engine`` payload (runs on the pump executor):
        engine stats + the flight-recorder tail and its watchdog
        anomalies. A fleet-fronted server returns the fleet form
        instead: router stats + one row per replica (alive flag,
        engine stats, its own flight tail) — the per-replica rows
        keyed by the same ids ``/debug/requests`` tags."""
        if hasattr(self.batcher, "debug_fleet"):
            return self.batcher.debug_fleet()
        flight = self.batcher.flight
        return {
            "engine": self.batcher.engine.debug_stats(),
            "occupancy": round(self.batcher.occupancy, 4),
            "queue_depth": self.batcher.queue_depth,
            "flight": {
                "n_recorded": flight.n_recorded,
                "capacity": flight.capacity,
                "nbytes": flight.nbytes,
                "records": flight.tail(128),
                "anomalies": flight.anomaly_log(),
            },
        }

    def _trace_of(self, query: str) -> dict:
        """The ``/debug/trace?id=`` payload: one request's full event
        list from the tracing ring (a plain deque snapshot — no pump
        round-trip needed)."""
        rid = (parse_qs(query).get("id") or [""])[0]
        if not rid:
            raise HttpError(400, "pass ?id=<request_id> (ids are in "
                            "/debug/requests and on X-Request-Id)")
        tracer = self.batcher.tracer
        if not tracer.enabled:
            raise HttpError(
                404, "tracing is disabled — enable the "
                "observability.tracing block (or RequestTracer"
                "(enabled=True)) to record request timelines")
        events = tracer.events(rid)
        if not events:
            raise HttpError(
                404, f"no trace events for request id {rid!r} (ring "
                "holds the last "
                f"{tracer.ring_size} events; known ids are in "
                "/debug/requests)")
        return {"request_id": rid, "events": events}

    # ---- request construction ------------------------------------
    def _prompt_ids(self, payload: dict, chat: bool) -> np.ndarray:
        if chat:
            messages = payload.get("messages")
            if not isinstance(messages, list) or not messages:
                raise HttpError(400,
                                "chat needs a non-empty `messages` list")
            parts = []
            for m in messages:
                if not isinstance(m, dict) or "content" not in m:
                    raise HttpError(
                        400, "each message needs role+content")
                parts.append(str(m["content"]))
            # the default codec is id-based, so the chat template is
            # pure concatenation of the messages' token text — a real
            # tokenizer codec may impose its own chat template before
            # this server ever sees the text
            ids = []
            for part in parts:
                ids.extend(self.codec.encode(part))
            if not ids:
                raise HttpError(400, "messages tokenize to nothing")
            return np.asarray(ids, np.int32)
        prompt = payload.get("prompt")
        if isinstance(prompt, str):
            ids = self.codec.encode(prompt)
        elif isinstance(prompt, list) and prompt \
                and all(isinstance(t, int) for t in prompt):
            ids = prompt
        else:
            raise HttpError(
                400, "`prompt` must be a string or a non-empty token "
                "array (batched string-list prompts not supported)")
        if not ids:
            raise HttpError(400, "prompt tokenizes to nothing")
        return np.asarray(ids, np.int32)

    @staticmethod
    def _request_id_of(request) -> str:
        """The client's ``X-Request-Id`` header, validated — or ``""``
        so the Request auto-generates one. Honoring the header is what
        lets a caller correlate its own logs with ``/debug/trace`` and
        the exported Perfetto tracks."""
        rid = request.headers.get("x-request-id", "").strip()
        if not rid:
            return ""
        if len(rid) > 128 or not all(
                (c.isascii() and c.isalnum()) or c in "-_.:"
                for c in rid):
            raise HttpError(
                400, "X-Request-Id must be <= 128 chars of "
                "[A-Za-z0-9._:-]")
        return rid

    def _build_request(self, payload: dict, chat: bool,
                       request_id: str = "") -> Request:
        if not isinstance(payload, dict):
            raise HttpError(400, "body must be a JSON object")
        ids = self._prompt_ids(payload, chat)
        max_tokens = payload.get("max_tokens", 16)
        deadline = payload.get("deadline_ms")
        seed = payload.get("seed")
        best_of = payload.get("best_of")
        # the OpenAI `model` field doubles as the ADAPTER selector
        # (multi-LoRA serving): the server's own model name (or an
        # absent field) is the base model; anything else names a
        # registered adapter — validated at submit, where an unknown
        # name maps to a 400 before any pages move
        model = payload.get("model", "")
        if not isinstance(model, str):
            raise HttpError(400, "`model` must be a string (the "
                            "served model or a registered adapter "
                            "name)")
        adapter = "" if model in ("", self.model_name) else model
        try:
            req = Request(
                prompt=ids,
                max_new_tokens=int(max_tokens),
                eos_id=payload.get("eos_id"),
                priority=payload.get("priority", ""),
                deadline_ms=(float(deadline) if deadline is not None
                             else None),
                arrival_time=time.time(),
                request_id=request_id,
                n=payload.get("n", 1),
                best_of=best_of,
                seed=seed,
                # validated by the Request (shape, eos requirement)
                # and again at submit (schema compile) — both map to
                # a 400 naming the offending value here
                response_format=payload.get("response_format"),
                adapter=adapter,
            )
        except (TypeError, ValueError) as exc:
            raise HttpError(400, str(exc)) from None
        return req

    def _submit(self, req: Request) -> None:
        if self.batcher.queue_depth >= self.max_queue:
            raise HttpError(
                429, f"queue full ({self.max_queue} waiting); "
                "retry later", {"Retry-After": str(
                    self.batcher.policy.retry_after_s(self.batcher))})
        try:
            self.batcher.submit(req)
        except (TypeError, ValueError) as exc:
            raise HttpError(400, str(exc)) from None
        if self.capture is not None:
            # AFTER the submit: a rejected request never joined the
            # trace, and the batcher has already stamped req.arrival
            # (the capture's offset source)
            self.capture.observe(req)
        self._wake.set()

    # ---- completion serving --------------------------------------
    async def _completion(self, request, reader, writer,
                          chat: bool) -> None:
        payload = request.json()
        rid_header = self._request_id_of(request)
        if rid_header and any(
                s.req.request_id == rid_header
                for s in self._streams.values()):
            # two CONCURRENT requests on one id would interleave
            # their tracer timelines and Perfetto tracks into one
            # merged lie — reject the duplicate while the first is
            # in flight (sequential reuse, e.g. a retry after a
            # failure, is legitimate and keeps the id's history)
            raise HttpError(
                409, f"X-Request-Id {rid_header!r} is already in "
                "flight; wait for it to finish or pick a fresh id")
        req = self._build_request(payload, chat, rid_header)
        stream_mode = bool(payload.get("stream"))
        if stream_mode and req.n_branches != req.n:
            # the OpenAI rule: best_of > n cannot stream — ranking
            # needs every branch's full logprob before choosing
            # which n to return
            raise HttpError(
                400, f"best_of ({req.best_of}) > n ({req.n}) cannot "
                "stream: ranking happens after all branches finish")
        # the OpenAI envelope id carries the REQUEST id (client-chosen
        # via X-Request-Id or auto-generated), so the response, the
        # /debug/trace query key, and the Perfetto track name all
        # agree on one identifier
        rid = ("chatcmpl-" if chat else "cmpl-") + req.request_id
        created = int(req.arrival_time)
        stream = self._register(req)
        # the disconnect watchdog: this dialect sends nothing after
        # the body, so any read completing means EOF/reset — route it
        # to the batcher's cancel path (mid-prefill abort, mid-decode
        # retire; pages reclaimed, zero recompiles)
        watchdog = asyncio.create_task(self._watch_disconnect(
            reader, req))
        try:
            self._submit(req)
            if stream_mode:
                await self._stream_response(req, stream, writer, rid,
                                            created, chat)
            else:
                await self._unary_response(req, stream, writer, rid,
                                           created, chat)
        finally:
            watchdog.cancel()
            self._unregister(req)

    async def _watch_disconnect(self, reader, req: Request) -> None:
        try:
            await reader.read(1)
        except (asyncio.CancelledError, Exception):
            return
        finally:
            # EOF (or any stray bytes, which this dialect forbids)
            # while the request is unfinished => client is gone
            if req.finished_at is None:
                self.batcher.cancel(req)
                self._wake.set()

    def _shed_error(self) -> HttpError:
        return HttpError(
            429, "shed: the scheduler cannot meet this request's "
            "deadline under current load", {"Retry-After": str(
                self.batcher.policy.retry_after_s(self.batcher))})

    def _model_of(self, req) -> str:
        """The `model` echoed in responses: the adapter name when the
        request decodes through one (OpenAI convention — you get back
        what you asked for), else the served base-model name."""
        return req.adapter or self.model_name

    def _chunk(self, rid: str, created: int, tokens: list[int],
               finish: str | None, chat: bool,
               index: int = 0, model: str | None = None) -> dict:
        text = self.codec.decode(tokens) if tokens else ""
        if chat:
            delta = {"content": text} if text else {}
            choice = {"index": index, "delta": delta,
                      "finish_reason": finish}
            obj = "chat.completion.chunk"
        else:
            choice = {"index": index, "text": text,
                      "token_ids": tokens, "finish_reason": finish}
            obj = "text_completion"
        return {"id": rid, "object": obj, "created": created,
                "model": model if model is not None
                else self.model_name, "choices": [choice]}

    async def _stream_response(self, req, stream, writer, rid,
                               created, chat) -> None:
        head_sent = False
        while True:
            branch, tokens, finish, done = await stream.queue.get()
            if req.shed:
                if head_sent:   # defensive: shed only ever targets
                    # never-started requests, but a malformed custom
                    # policy must not make us write a 429 into an
                    # open SSE stream
                    writer.write(SSE_DONE)
                    await writer.drain()
                    return
                raise self._shed_error()
            if req.cancelled:
                return          # client is gone; nothing to write
            if finish == "error" and not head_sent:
                raise HttpError(500, "engine failure mid-request; "
                                "see server logs")
            if not head_sent:
                writer.write(sse_head(
                    {"X-Request-Id": req.request_id}))
                head_sent = True
            if tokens:
                # one SSE event per decode step's delivery per
                # branch: a single token normally, the whole accepted
                # burst in speculative mode; `index` is the branch —
                # an n-way stream interleaves its choices' chunks
                # exactly as OpenAI's dialect does
                writer.write(sse_event(self._chunk(
                    rid, created, tokens, finish, chat,
                    index=branch, model=self._model_of(req))))
                await writer.drain()
            elif finish is not None:
                # a branch finished without tokens on this event: the
                # finishing chunk carries its finish_reason — "error"
                # included (head already sent: the raise path above
                # only covers pre-head failures, and a crash-truncated
                # stream must not read as a clean completion)
                writer.write(sse_event(self._chunk(
                    rid, created, [], finish, chat, index=branch,
                    model=self._model_of(req))))
                await writer.drain()
            if done:
                writer.write(SSE_DONE)
                await writer.drain()
                return

    async def _unary_response(self, req, stream, writer, rid,
                              created, chat) -> None:
        while True:
            branch, chunk, finish, done = await stream.queue.get()
            if req.shed:
                raise self._shed_error()
            if req.cancelled:
                return
            if finish == "error" or req.finish_reason == "error":
                raise HttpError(500, "engine failure mid-request; "
                                "see server logs")
            if done:
                break
        # every branch is terminal: rank and build the choice list.
        # best_of > n returns the n best branches by cumulative
        # logprob (sequence log-probability under the distribution
        # each token was sampled from), re-indexed 0..n-1; n == 1
        # single-stream requests collapse to the old single choice.
        family = req.branches or [req]
        if req.n_branches > req.n:
            family = sorted(family, key=lambda r: -r.cum_logprob)
            family = family[:req.n]
        choices = []
        completion_tokens = 0
        for r in (req.branches or [req]):
            completion_tokens += len(r.tokens)
        for i, r in enumerate(family):
            text = self.codec.decode(r.tokens)
            if chat:
                choices.append(
                    {"index": i, "message":
                     {"role": "assistant", "content": text},
                     "finish_reason": r.finish_reason})
            else:
                choices.append(
                    {"index": i, "text": text,
                     "token_ids": list(r.tokens),
                     "finish_reason": r.finish_reason})
        obj = "chat.completion" if chat else "text_completion"
        # aggregated usage: the prompt was prefilled ONCE (that is
        # the fork's whole point) but every decoded branch's tokens
        # are real work and bill as completion tokens — the OpenAI
        # best_of convention
        writer.write(json_response(200, {
            "id": rid, "object": obj, "created": created,
            "model": self._model_of(req), "choices": choices,
            "usage": {"prompt_tokens": req.base_len,
                      "completion_tokens": completion_tokens,
                      "total_tokens": req.base_len
                      + completion_tokens}},
            {"X-Request-Id": req.request_id}))


__all__ = ["IdCodec", "ServingFrontend", "install_uvloop"]
