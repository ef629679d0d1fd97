"""Replica server — the port of ``torchbooster_tpu/serving/
replica_server.py``: one ``ContinuousBatcher`` behind a socket.

The other half of :mod:`torchbooster_tpu_torch.serving.router.rpc`: an
asyncio stream server that owns one batcher (one engine, one card's
worth of pool) and executes the router's framed ops against it —
hello/clock/session lifecycle, submit/cancel/check, the lockstep
``step`` pump, readiness, the drain paths, debug payloads and the
disaggregation ``import_pages`` seam (framed int8 pages land in the
engine's host pool, from which the promotion write seats them).

Run it standalone::

    python -m torchbooster_tpu_torch.serving.replica_server \
        --config serve.yaml --host 0.0.0.0 --port 7781 [--device cuda]

or in-process with :func:`serve_in_thread` (real sockets, real framing,
a real event loop; only the process boundary is elided).

The protocol is lockstep (one op in flight), so ops execute directly on
the event loop's thread and the batcher is never entered from two
threads; that thread makes the engine's card its current device before
it serves. The probe side-car every response carries is computed after
the op, so what the router reads next reflects the op it just issued.

``ServerHandle.kill()`` aborts the transports mid-whatever: the
client's next read raises, it marks the connection dead, and the
fleet's bury/readmit path takes over.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import threading
from collections import deque
from pathlib import Path

import numpy as np
import torch

from torchbooster_tpu_torch.serving.batcher import ContinuousBatcher, Request
from torchbooster_tpu_torch.serving.router.rpc import (
    PROTO, WireClock, async_recv_msg, async_send_msg,
    decode_request, policy_spec, unpack_pages)

__all__ = ["ReplicaServer", "ServerHandle", "build_from_config", "main",
           "serve_forever", "serve_in_thread"]


def _pin_device(batcher: ContinuousBatcher) -> None:
    """Make the engine's card torch's current device on the calling
    thread (the current device is per thread), so every op the server
    runs there, the decode kernel's launches included, lands on that
    card and its current stream. Nothing to do for a CPU engine."""
    device = batcher.engine.device
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())


class ReplicaServer:
    """Protocol executor: framed op in, framed response out. Owns the
    id->Request table (the server-side mirror of the client's), the
    announced-id set (fork children get a ``new`` descriptor on first
    event), and the tier-event buffer the fleet's prefix directory
    drinks from."""

    def __init__(self, batcher: ContinuousBatcher):
        if not isinstance(batcher, ContinuousBatcher):
            raise TypeError(
                f"ReplicaServer serves a ContinuousBatcher, got "
                f"{type(batcher).__name__}")
        self.batcher = batcher
        self.wire_clock = WireClock()
        batcher.clock = self.wire_clock
        self._by_id: dict[str, Request] = {}
        self._known: set[str] = set()
        self._tier_on = False
        # bounded: the client drains it every response; 8192 events
        # of slack covers any burst a single step can emit
        self._tier_buf: deque = deque(maxlen=8192)
        self.wire_rx_bytes = 0
        self.wire_tx_bytes = 0
        self.pages_imported = 0
        self.page_bytes_imported = 0
        self._writers: set = set()

    # ---- dispatch ------------------------------------------------
    def handle(self, head: dict,
               frames: list[bytes]) -> tuple[dict, list[bytes]]:
        now = head.get("now")
        if now is not None:
            self.wire_clock.set(now)
        resp_frames: list[bytes] = []
        try:
            op = head["op"]
            fn = getattr(self, f"_op_{op}", None)
            if fn is None:
                raise ValueError(f"unknown op {op!r}")
            resp = fn(head, frames, resp_frames) or {}
        except BaseException as exc:  # marshal, never kill the loop
            resp = {"err": {"type": type(exc).__name__,
                            "msg": str(exc)}}
            resp_frames = []
        # probe side-car: computed AFTER the op so the router's next
        # synchronous property read sees the op's effect (a submit's
        # response already counts the submitted request)
        resp["probe"] = self._probe()
        if self._tier_on and self._tier_buf:
            tier = []
            while self._tier_buf:
                ev, key = self._tier_buf.popleft()
                tier.append({"ev": ev, "frame": len(resp_frames)})
                resp_frames.append(bytes(key))
            resp["tier"] = tier
        return resp, resp_frames

    def _probe(self) -> dict:
        b = self.batcher
        ready = b.readiness()
        # sender-relative payload age: stamped just now, on this
        # host's clock — ~0 by construction; the CLIENT adds its own
        # local time-since-receipt. No cross-host clock differencing
        # anywhere (the FleetHealth stale_s fix this PR ships).
        ready["age_s"] = 0.0
        return {
            "queue_depth": b.queue_depth,
            "inflight": b.inflight,
            "est_step_s": round(b.est_step_s, 6),
            "est_chunk_s": round(b.est_chunk_s, 6),
            "occupancy": round(b.occupancy, 4),
            "has_work": b.has_work,
            "readiness": ready,
        }

    # ---- ops -----------------------------------------------------
    def _op_hello(self, head, frames, out_frames):
        if head.get("proto") != PROTO:
            raise ValueError(
                f"client speaks protocol {head.get('proto')}, server "
                f"speaks {PROTO}")
        eng = self.batcher.engine
        return {
            "proto": PROTO,
            "geometry": {
                "page_size": eng.page_size,
                "n_pages": eng.n_pages,
                "max_slots": eng.max_slots,
                "chunk_tokens": eng.chunk_tokens,
                "seq_len": eng.cfg.seq_len,
                "vocab": eng.cfg.vocab,
            },
            "policy": policy_spec(self.batcher.policy),
        }

    def _op_clock(self, head, frames, out_frames):
        self.wire_clock.frozen = bool(head["frozen"])
        return {}

    def _op_start_session(self, head, frames, out_frames):
        self._by_id.clear()
        self._known.clear()
        self._tier_buf.clear()
        self.batcher.start_session()
        return {}

    def _op_finish_session(self, head, frames, out_frames):
        return {"metrics": self.batcher.finish_session()}

    def _op_check(self, head, frames, out_frames):
        req = decode_request(head["req"], frames)
        self.batcher._check_fits(req)
        return {}

    def _op_submit(self, head, frames, out_frames):
        req = decode_request(head["req"], frames)
        self._by_id[req.request_id] = req
        self._known.add(req.request_id)
        self.batcher.submit(req, arrival=head["arrival"])
        return {}

    def _op_cancel(self, head, frames, out_frames):
        req = self._by_id.get(head["id"])
        if req is not None:
            self.batcher.cancel(req)
        return {}

    def _op_step(self, head, frames, out_frames):
        events = self.batcher.step()
        rows = []
        for req, toks in events:
            row = {"id": req.request_id,
                   "admitted_at": req.admitted_at,
                   "first_token_at": req.first_token_at,
                   "finished_at": req.finished_at,
                   "finish_reason": req.finish_reason,
                   "shed": req.shed, "cancelled": req.cancelled,
                   "cum_logprob": req.cum_logprob}
            if toks:
                row["tok"] = len(out_frames)
                out_frames.append(
                    np.asarray(toks, np.int32).tobytes())
            if req.request_id not in self._known:
                # a server-side fork child (parallel sampling): ship
                # the descriptor the client needs to build its mirror
                parent = req.parent
                row["new"] = {
                    "parent": (parent.request_id
                               if parent is not None else None),
                    "branch": req.branch,
                    "base_len": int(req.base_len),
                    "prompt": len(out_frames),
                    "max_new_tokens": req.max_new_tokens,
                    "eos_id": req.eos_id, "seed": req.seed,
                    "arrival": req.arrival, "priority": req.priority,
                    "deadline_ms": req.deadline_ms, "n": req.n,
                    "best_of": req.best_of, "adapter": req.adapter,
                }
                out_frames.append(np.ascontiguousarray(
                    req.prompt, np.int32).tobytes())
                self._known.add(req.request_id)
                self._by_id[req.request_id] = req
            rows.append(row)
            if req.finished_at is not None:
                self._prune(req)
        return {"events": rows}

    def _prune(self, req: Request) -> None:
        root = req.parent if req.parent is not None else req
        family = root.branches or [root]
        if all(r.finished_at is not None for r in family):
            for r in family:
                self._by_id.pop(r.request_id, None)

    def _op_readiness(self, head, frames, out_frames):
        return {}  # the probe side-car carries it

    def _take_out(self, reqs: list, out_frames: list[bytes]) -> dict:
        rows = []
        for req in reqs:
            row = {"id": req.request_id,
                   "prompt": len(out_frames)}
            out_frames.append(np.ascontiguousarray(
                req.prompt, np.int32).tobytes())
            row["tok"] = len(out_frames)
            out_frames.append(np.asarray(req.tokens,
                                         np.int32).tobytes())
            row.update({
                "base_len": int(req.base_len),
                "max_new_tokens": req.max_new_tokens,
                "eos_id": req.eos_id, "arrival": req.arrival,
                "priority": req.priority,
                "deadline_ms": req.deadline_ms,
                "arrival_time": req.arrival_time, "n": req.n,
                "best_of": req.best_of, "seed": req.seed,
                "response_format": req.response_format,
                "adapter": req.adapter,
                "admitted_at": req.admitted_at,
                "first_token_at": req.first_token_at,
                "finished_at": req.finished_at,
                "finish_reason": req.finish_reason,
                "shed": req.shed, "cancelled": req.cancelled,
                "branch": req.branch,
                "cum_logprob": req.cum_logprob})
            self._by_id.pop(req.request_id, None)
        return {"reqs": rows}

    def _op_drain_unfinished(self, head, frames, out_frames):
        reqs = self.batcher.drain_unfinished(
            retire_seated=bool(head["retire_seated"]))
        return self._take_out(reqs, out_frames)

    def _op_drain_queued(self, head, frames, out_frames):
        reqs = self.batcher.drain_queued(int(head["n"]))
        return self._take_out(reqs, out_frames)

    def _op_tier_events(self, head, frames, out_frames):
        self._tier_on = bool(head["on"])
        tables = self.batcher.engine.tables
        if self._tier_on:
            buf = self._tier_buf

            def _observe(event: str, key: bytes) -> None:
                buf.append((event, key))

            tables.on_tier_event = _observe
        else:
            tables.on_tier_event = None
            self._tier_buf.clear()
        return {}

    def _op_import_pages(self, head, frames, out_frames):
        """The disaggregation seam: framed int8 pages (the host spill
        tier's demotion payload) land in the engine's host pool keyed by
        prefix chain — ``admit_begin``'s tiered match then seats them
        through the fixed-shape promotion write, no new step shape."""
        pool = self.batcher.engine.tables.host_pool
        if pool is None:
            raise RuntimeError(
                "import_pages needs host_spill=True on the decode "
                "engine (the host pool IS the import buffer)")
        pages = unpack_pages(head["blob"], frames)
        for key, payload in pages:
            pool.put(key, payload)
        self.pages_imported += len(pages)
        self.page_bytes_imported += int(head["blob"]["page_bytes"])
        return {"imported": len(pages)}

    def _op_debug_snapshot(self, head, frames, out_frames):
        return {"snapshot": self.batcher.debug_snapshot(
            timeline_tail=int(head.get("timeline_tail", 20)))}

    def _op_debug_row(self, head, frames, out_frames):
        flight = self.batcher.flight
        return {"row": {
            "queue_depth": self.batcher.queue_depth,
            "flight": {
                "n_recorded": flight.n_recorded,
                "capacity": flight.capacity,
                "records": flight.tail(32),
                "anomalies": flight.anomaly_log(),
            },
            "engine": self.batcher.engine.debug_stats(),
            "occupancy": round(self.batcher.occupancy, 4),
            "wire_rx_bytes": self.wire_rx_bytes,
            "wire_tx_bytes": self.wire_tx_bytes,
            "pages_imported": self.pages_imported,
        }}

    # ---- asyncio plumbing ----------------------------------------
    async def client_connected(self, reader, writer) -> None:
        self._writers.add(writer)
        lock = asyncio.Lock()
        try:
            while True:
                try:
                    head, frames, n = await async_recv_msg(reader)
                except (asyncio.IncompleteReadError, ConnectionError,
                        OSError):
                    break
                self.wire_rx_bytes += n
                async with lock:
                    resp, resp_frames = self.handle(head, frames)
                try:
                    self.wire_tx_bytes += await async_send_msg(
                        writer, resp, resp_frames)
                except (ConnectionError, OSError):
                    break
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
            except Exception:
                pass


class ServerHandle:
    """What :func:`serve_in_thread` returns: the bound endpoint plus
    graceful ``stop()`` and abrupt ``kill()`` (transport abort — the
    replica-death test's murder weapon)."""

    def __init__(self, server: ReplicaServer):
        self.server = server
        self.endpoint = ""
        self._loop = None
        self._stop_ev = None
        self._thread = None

    def _shutdown(self) -> None:
        if self._loop is None or self._stop_ev is None:
            return
        try:
            self._loop.call_soon_threadsafe(self._stop_ev.set)
        except RuntimeError:
            pass  # loop already closed

    def stop(self) -> None:
        self._shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def kill(self) -> None:
        """Abort every live transport first (the client's next read
        fails mid-stream — process-death semantics), then stop."""
        loop = self._loop
        if loop is not None:
            def _abort():
                for w in list(self.server._writers):
                    try:
                        w.transport.abort()
                    except Exception:
                        pass
            try:
                loop.call_soon_threadsafe(_abort)
            except RuntimeError:
                pass
        self.stop()


def serve_in_thread(batcher: ContinuousBatcher,
                    host: str = "127.0.0.1",
                    port: int = 0) -> ServerHandle:
    """Serve ``batcher`` on a daemon thread's event loop; returns once
    the socket is bound (``handle.endpoint`` is connectable). Real
    sockets on loopback — the parity tests and the chip smoke
    use exactly the wire path a cross-host deployment would."""
    server = ReplicaServer(batcher)
    handle = ServerHandle(server)
    started = threading.Event()

    def _run() -> None:
        async def _main() -> None:
            _pin_device(batcher)
            handle._stop_ev = asyncio.Event()
            handle._loop = asyncio.get_running_loop()
            srv = await asyncio.start_server(
                server.client_connected, host, port)
            bound = srv.sockets[0].getsockname()
            handle.endpoint = f"{bound[0]}:{bound[1]}"
            started.set()
            await handle._stop_ev.wait()
            for w in list(server._writers):
                try:
                    w.transport.abort()
                except Exception:
                    pass
            srv.close()
            await srv.wait_closed()

        try:
            asyncio.run(_main())
        except Exception:
            started.set()  # never leave the caller hanging

    thread = threading.Thread(target=_run, daemon=True,
                              name="replica-server")
    handle._thread = thread
    thread.start()
    if not started.wait(timeout=30) or not handle.endpoint:
        raise RuntimeError("replica server failed to start")
    return handle


async def serve_forever(batcher: ContinuousBatcher, host: str,
                        port: int) -> None:
    _pin_device(batcher)
    server = ReplicaServer(batcher)
    srv = await asyncio.start_server(server.client_connected, host,
                                     port)
    bound = srv.sockets[0].getsockname()
    # one parseable line so a launcher can scrape the bound port
    print(json.dumps({"replica_server": {"host": bound[0],
                                         "port": bound[1]}}),
          flush=True)
    async with srv:
        await srv.serve_forever()


def build_from_config(path: str,
                      device: str | torch.device = "cuda"
                      ) -> ContinuousBatcher:
    """Build the served batcher from a standalone YAML: flat model
    scalars (the ``GPTConfig`` knobs and ``seed``) beside the normal
    ``serving:`` block. The parameters are the port's GPT initializer
    drawn from ``seed`` (a checkpoint loader replaces this builder); the
    engine lives on ``device``."""
    from torchbooster_tpu_torch.config import ServingConfig, _yaml
    from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig

    data = _yaml().safe_load(Path(path).read_text()) or {}
    model = {"vocab": 50257, "n_layers": 2, "d_model": 64, "n_heads": 2,
             "n_kv_heads": 0, "seq_len": 256}
    seed = int(data.pop("seed", 0))
    serving = ServingConfig.from_dict(data.pop("serving", None))
    unknown = sorted(set(data) - set(model))
    if unknown:
        raise ValueError(f"unknown replica config keys {unknown}; known: "
                         f"{sorted({'seed', 'serving', *model})}")
    model.update({k: int(v) for k, v in data.items()})
    if serving.router.n_replicas != 1 or serving.router.replicas:
        raise SystemExit(
            "replica_server hosts ONE batcher: set router.n_replicas "
            "to 1 (or drop the router block) — the fleet lives on "
            "the ROUTER host and dials replica servers")
    model_cfg = GPTConfig(**model)
    params = GPT.init(seed, model_cfg, device=device)
    return serving.make(params, model_cfg, device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchbooster_tpu_torch.serving.replica_server",
        description="Serve one ContinuousBatcher replica over the "
                    "fleet RPC transport.")
    parser.add_argument("--config", required=True,
                        help="YAML config (flat model scalars + a "
                             "serving: block; router must be absent "
                             "or n_replicas: 1 — one server, one "
                             "chip)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="the engine's device (default: the card)")
    args = parser.parse_args(argv)
    batcher = build_from_config(args.config, device=args.device)
    try:
        asyncio.run(serve_forever(batcher, args.host, args.port))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
