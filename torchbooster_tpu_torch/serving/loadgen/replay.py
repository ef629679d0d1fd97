"""Open-loop replay drivers: re-offer a workload against the batcher
``step()`` core (in-process, deterministic clock) or the real asyncio
HTTP front door, at a configurable time-compression factor — the port
of ``torchbooster_tpu/serving/loadgen/replay.py``. Its outcomes and
reports are the JAX module's; :class:`ReplayResult` also carries each
request's delivered token ids (``streams``), so an HTTP replay can be
held token for token against an in-process one.

Open-loop discipline is the point (the MLPerf-Inference rule): every
request is offered at its RECORDED arrival divided by ``speed``,
whether or not the system has kept up — a closed loop that waits for
responses before offering more would hide exactly the queueing the
SLO scheduler exists to manage. Client disconnects replay at their
recorded delivered-token offsets (``cancel_after_tokens``), so the
cancel/abort paths see the same churn the original trace produced.

Two drivers, one outcome shape (report.py consumes both):

- :func:`replay_inprocess` — drives ``ContinuousBatcher.step()``
  directly under a :class:`ReplayClock`, a virtual clock the driver
  alone advances (a fixed ``step_dt`` per scheduling iteration, plus
  jumps across idle gaps). Two replays of the same workload through
  the same policy produce IDENTICAL token streams and an identical
  scheduler decision sequence — the determinism the regression test
  pins. Latencies are VIRTUAL seconds (deterministic, comparable
  across runs); throughput denominators use the measured wall time
  (virtual tok/s would be meaningless).
- :func:`replay_http` — real asyncio clients against a live
  ``ServingFrontend``: each sleeps to its compressed arrival, POSTs
  ``/v1/completions`` with ``stream: true`` (carrying the recorded
  priority/deadline and its ``X-Request-Id``), times its own SSE
  events, and disconnects mid-stream at the recorded token offset.
  Latencies are client-observed wall seconds — what a user sees.

Both emit per-request OUTCOME dicts (request id, class, TTFT, TPOT,
token count, shed/cancel flags, deadline verdict) that
:func:`~torchbooster_tpu_torch.serving.loadgen.report.conformance_report`
aggregates. The drivers are host-side bookkeeping on the serving hot
path (the in-process one IS the decode loop's thread): no device
reads, ``perf_counter`` only — the one wall-clock stamp on the HTTP
outcome is a reasoned allowlist entry.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from time import perf_counter

import numpy as np

from torchbooster_tpu_torch.observability import get_registry
from torchbooster_tpu_torch.serving.batcher import Request
from torchbooster_tpu_torch.serving.loadgen.report import conformance_report
from torchbooster_tpu_torch.serving.loadgen.workload import Workload

__all__ = ["ReplayClock", "ReplayResult", "replay_http",
           "replay_inprocess"]


class ReplayClock:
    """Deterministic virtual clock for in-process replay: callable
    like ``time.perf_counter`` (the batcher's injectable clock
    surface), advanced ONLY by the driver — a fixed ``step_dt`` per
    scheduling iteration plus jumps across idle arrival gaps — so a
    replay's entire schedule is a pure function of the workload."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        self._now += dt

    def jump_to(self, t: float) -> None:
        self._now = max(self._now, t)


@dataclass
class ReplayResult:
    """One replay's full yield: the conformance ``report`` (the
    comparable artifact), the per-request ``outcomes`` it aggregated,
    the batcher session ``metrics`` dict (in-process only), the served
    ``requests`` (in-process only — their ``tokens`` are the determinism
    test's token streams), keyed in workload order, and ``streams``:
    ``{request_id: delivered token ids}`` from either driver (an HTTP
    stream's ids as the client read them off the SSE events)."""
    report: dict
    outcomes: list
    metrics: dict | None = None
    requests: list | None = None
    streams: dict | None = None


def _outcome(*, request_id: str, cls: str, arrival_s: float,
             ttft_s, tpot_s, n_tokens: int, shed: bool,
             cancelled: bool, deadline_s,
             errored: bool = False) -> dict:
    hit = None
    if deadline_s is not None and not shed and not errored:
        hit = ttft_s is not None and ttft_s <= deadline_s
    return {"request_id": request_id, "cls": cls or "default",
            "arrival_s": round(float(arrival_s), 6),
            "ttft_s": None if ttft_s is None else round(ttft_s, 6),
            "tpot_s": None if tpot_s is None else round(tpot_s, 6),
            "n_tokens": int(n_tokens), "shed": bool(shed),
            "cancelled": bool(cancelled), "errored": bool(errored),
            "deadline_s": deadline_s, "deadline_hit": hit}


def replay_inprocess(batcher, workload: Workload,
                     speed: float | None = None,
                     step_dt: float = 0.005,
                     max_steps: int = 200_000) -> ReplayResult:
    """Replay ``workload`` through the batcher ``step()`` core under a
    deterministic :class:`ReplayClock` at ``speed``× compression
    (arrivals divide by it; relative order is preserved exactly).

    ``batcher`` is a :class:`ContinuousBatcher` (or anything that
    quacks like one: a settable ``clock``, the session and pump
    surface, a ``policy``).

    All requests are submitted up-front with their compressed
    arrivals (the policy gates on arrival vs the virtual now — the
    open-loop offer), then the driver pumps ``step()``, advancing the
    clock ``step_dt`` virtual seconds per iteration and jumping
    across fully-idle gaps. Recorded client disconnects are re-issued
    the moment a request's delivered-token count reaches its
    ``cancel_after_tokens`` — the cancel drains at the next step, so
    the cancelled stream holds EXACTLY the recorded token count on a
    non-speculative engine (a spec burst may overshoot by its burst).

    The batcher's injectable clock is swapped for the replay and
    restored after; sessions must not be active on entry.
    ``speed=None`` takes the workload's own default
    (``meta["speed"]``, the ``loadgen.speed`` YAML knob), falling
    back to x1."""
    if speed is None:
        speed = workload.meta.get("speed", 1.0)
    speed = float(speed)
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    if step_dt <= 0:
        raise ValueError(f"step_dt must be > 0, got {step_dt}")
    reqs = [Request(prompt=rec.prompt_ids(workload.vocab),
                    max_new_tokens=rec.max_new_tokens,
                    eos_id=rec.eos_id, priority=rec.priority,
                    deadline_ms=rec.deadline_ms,
                    request_id=rec.request_id,
                    n=rec.n, best_of=rec.best_of,
                    response_format=rec.response_format,
                    adapter=rec.adapter)
            for rec in workload.requests]
    arrivals = [rec.arrival_s / speed for rec in workload.requests]
    cancels = [(req, rec.cancel_after_tokens)
               for req, rec in zip(reqs, workload.requests)
               if rec.cancel_after_tokens is not None]
    clock = ReplayClock()
    old_clock = batcher.clock
    batcher.clock = clock
    t_wall = perf_counter()
    try:
        batcher.start_session()
        for req, arr in zip(reqs, arrivals):
            batcher.submit(req, arrival=arr)
        steps = 0
        while batcher.has_work:
            events = batcher.step()
            clock.advance(step_dt)
            for req, after in cancels:
                if not req.cancelled and req.finished_at is None \
                        and len(req.tokens) >= after:
                    batcher.cancel(req)
            if not events:
                # fully idle (nothing seated, nothing arrived): jump
                # to the next pending arrival instead of spinning
                # virtual time forward step_dt at a time
                pending = [a for req, a in zip(reqs, arrivals)
                           if req.finished_at is None]
                if pending and min(pending) > clock():
                    clock.jump_to(min(pending))
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"replay exceeded {max_steps} scheduler "
                    "iterations without draining — livelocked "
                    "workload (preempt thrash?) or max_steps too "
                    "small for this trace")
        metrics = batcher.finish_session()
    except Exception:
        # close a half-open session so the batcher stays usable (and
        # the sentinel watch lands) even when the replay dies mid-run
        if batcher.session_active:
            try:
                batcher.finish_session()
            except Exception:  # noqa: BLE001 — the original error wins
                pass
        raise
    finally:
        batcher.clock = old_clock
    wall_s = perf_counter() - t_wall
    get_registry().counter(
        "loadgen_replayed_total",
        "requests offered by the loadgen replay drivers").inc(
        len(reqs), mode="inprocess")
    outcomes = []
    for req in reqs:
        ttft = (req.first_token_at - req.arrival
                if req.first_token_at is not None else None)
        tpot = None
        if req.first_token_at is not None and len(req.tokens) > 1 \
                and req.finished_at is not None:
            tpot = (req.finished_at - req.first_token_at) \
                / (len(req.tokens) - 1)
        outcomes.append(_outcome(
            request_id=req.request_id, cls=req.priority,
            arrival_s=req.arrival, ttft_s=ttft, tpot_s=tpot,
            n_tokens=len(req.tokens), shed=req.shed,
            cancelled=req.cancelled,
            deadline_s=batcher.policy.ttft_deadline_s(req)))
    report = conformance_report(
        workload, outcomes, speed=speed, mode="inprocess",
        elapsed_s=metrics["elapsed_s"], wall_s=wall_s,
        n_preemptions=metrics["n_preemptions"])
    return ReplayResult(report=report, outcomes=outcomes,
                        metrics=metrics, requests=reqs,
                        streams={req.request_id: list(req.tokens)
                                 for req in reqs})


async def replay_http(port: int, workload: Workload,
                      speed: float | None = None,
                      host: str = "127.0.0.1",
                      classes: dict | None = None,
                      timeout_s: float = 300.0) -> ReplayResult:
    """Replay ``workload`` against a live front door over real HTTP:
    one asyncio client per request, sleeping to its compressed
    arrival, streaming SSE, timing its own first/last token, and
    disconnecting mid-stream at the recorded ``cancel_after_tokens``
    offset (the server's watchdog turns that into the batcher cancel
    path, exactly like the original client's vanish).

    ``classes`` (a ``parse_classes`` table) prices class TTFT
    deadlines client-side; a request's own ``deadline_ms`` always
    wins. Shed = the server's 429 answer; any other non-200 — and any
    transport failure or per-client ``timeout_s`` expiry — is an
    ERROR outcome (one dying client never discards the rest of the
    replay's measurements). ``speed=None`` takes the workload's own
    default (``meta["speed"]``, the ``loadgen.speed`` YAML knob),
    falling back to x1."""
    import asyncio
    import json

    if speed is None:
        speed = workload.meta.get("speed", 1.0)
    speed = float(speed)
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    if timeout_s <= 0:
        raise ValueError(f"timeout_s must be > 0, got {timeout_s}")

    def deadline_of(rec) -> float | None:
        if rec.deadline_ms is not None:
            return rec.deadline_ms / 1e3
        cls = (classes or {}).get(rec.priority)
        if cls is not None and cls.ttft_ms > 0:
            return cls.ttft_ms / 1e3
        return None

    async def exchange(rec, t0) -> dict:
        """One request's measured wire exchange (the timed/fallible
        part — ``client`` wraps it in the timeout + error net)."""
        reader, writer = await asyncio.open_connection(host, port)
        try:
            payload = {"prompt": [int(t) for t in
                                  rec.prompt_ids(workload.vocab)],
                       "max_tokens": rec.max_new_tokens,
                       "stream": True, "priority": rec.priority}
            if rec.deadline_ms is not None:
                payload["deadline_ms"] = rec.deadline_ms
            if rec.eos_id is not None:
                payload["eos_id"] = rec.eos_id
            if rec.n > 1:
                # streaming replays n = best_of fan-out (the dialect
                # forbids streaming a best_of > n ranking)
                payload["n"] = payload["best_of"] = (
                    rec.best_of if rec.best_of is not None else rec.n)
            if rec.response_format is not None:
                payload["response_format"] = rec.response_format
            body = json.dumps(payload).encode()
            writer.write(
                b"POST /v1/completions HTTP/1.1\r\nHost: loadgen\r\n"
                + f"X-Request-Id: {rec.request_id}\r\n".encode()
                + b"Content-Length: %d\r\n\r\n" % len(body) + body)
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            status = int(head.split(b" ", 2)[1])
            shed = status == 429
            # any OTHER non-200 (400 mismatched class table, 500
            # engine failure, ...) is an ERROR outcome — never
            # counted as a served-but-empty completion, or a
            # fully-errored run would read as a valid conformance arm
            errored = status not in (200, 429)
            t_first = t_last = None
            n = 0
            disconnected = False
            ids = streams[rec.request_id] = []
            if status == 200:
                while True:
                    line = await reader.readline()
                    if not line:
                        break
                    line = line.strip()
                    if not line.startswith(b"data: "):
                        continue
                    if line == b"data: [DONE]":
                        break
                    got = json.loads(line[6:])["choices"][0]["token_ids"]
                    ids.extend(got)
                    n += len(got)
                    t_last = perf_counter()
                    if t_first is None:
                        t_first = t_last
                    if rec.cancel_after_tokens is not None \
                            and n >= rec.cancel_after_tokens:
                        disconnected = True  # the recorded disconnect
                        break
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass
        ttft = None if t_first is None else t_first - t0
        tpot = ((t_last - t_first) / (n - 1)
                if t_first is not None and n > 1 else None)
        return _outcome(
            request_id=rec.request_id, cls=rec.priority,
            arrival_s=rec.arrival_s / speed, ttft_s=ttft, tpot_s=tpot,
            n_tokens=n, shed=shed,
            # cancelled records what HAPPENED, not the recorded
            # intent: a stream that ended naturally before the
            # recorded offset (EOS under a different config) was
            # served, and its tokens must count
            cancelled=disconnected and not shed and not errored,
            errored=errored, deadline_s=deadline_of(rec))

    async def client(rec) -> dict:
        await asyncio.sleep(rec.arrival_s / speed)
        # wall-clock TIMESTAMP for correlating client-side outcomes
        # with server logs (provenance, not a duration — allowlisted);
        # every latency is a perf_counter delta
        submitted_at = time.time()
        t0 = perf_counter()
        try:
            out = await asyncio.wait_for(exchange(rec, t0), timeout_s)
        except (asyncio.TimeoutError, OSError,
                asyncio.IncompleteReadError, ValueError,
                ConnectionError) as exc:
            # transport failure / hung server / torn response: ONE
            # dying client is an errored outcome, never a replay-wide
            # traceback that discards everyone else's measurements
            out = _outcome(
                request_id=rec.request_id, cls=rec.priority,
                arrival_s=rec.arrival_s / speed, ttft_s=None,
                tpot_s=None, n_tokens=0, shed=False, cancelled=False,
                errored=True, deadline_s=deadline_of(rec))
            out["error"] = f"{type(exc).__name__}: {exc}"[:200]
        out["submitted_at"] = round(submitted_at, 3)
        return out

    streams: dict[str, list] = {}
    t_wall = perf_counter()
    outcomes = list(await asyncio.gather(
        *(client(rec) for rec in workload.requests)))
    wall_s = perf_counter() - t_wall
    get_registry().counter(
        "loadgen_replayed_total",
        "requests offered by the loadgen replay drivers").inc(
        len(outcomes), mode="http")
    report = conformance_report(workload, outcomes, speed=speed,
                                mode="http", elapsed_s=wall_s,
                                wall_s=wall_s)
    return ReplayResult(report=report, outcomes=outcomes,
                        streams=streams)
