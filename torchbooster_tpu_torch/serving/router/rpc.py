"""The router's socket transport — the port of ``torchbooster_tpu/serving/
router/rpc.py``. Its bytes are the JAX module's for the same messages.

**Framing.** Length-prefixed, stdlib only::

    >I header_len | header (UTF-8 JSON) | frame_0 | frame_1 | ...

The JSON header carries the op, its scalar arguments, and ``"f"`` — a
list of raw-frame byte lengths. Bulk payloads (token ids, prompts,
quantized K/V pages) ride the raw frames: numpy ``tobytes()`` on one
end, ``frombuffer`` on the other, never JSON-encoded. The same frames
carry the disaggregation page stream (:func:`pack_pages` /
:func:`unpack_pages` — the host spill tier's demotion payload, int8
values + fp32 scales, byte for byte what ``HostPagePool`` stores).

**Lockstep pump.** :class:`RemoteReplica` speaks the ``Replica`` surface
over a blocking socket to a ``ContinuousBatcher`` pumping in a
:mod:`~torchbooster_tpu_torch.serving.replica_server`, one outstanding
request per connection: each fleet ``step()`` is one ``step`` RPC.
Every client->server message carries ``now``, the router's clock
reading, and the server pins its batcher's clock to it
(:class:`WireClock`), so under the replay clock both arms see the same
clock values and the routing decisions are byte-identical. Every
response piggybacks a probe block (queue depth, in-flight, the EWMA
estimates, the readiness payload) computed after the op.

**Staleness is sender-relative.** ``readiness()`` payloads carry
``age_s``, summed from same-host deltas only (the server's stamp at
send time plus the client's time since receipt), which
``FleetHealth``'s stale strike reads directly.

**Death is a dropped connection.** Any socket error marks the
connection dead and the next ``step()`` raises; the fleet buries the
replica and ``drain_unfinished`` folds each mirror's delivered tokens
into its prompt client-side, so readmission elsewhere loses nothing and
duplicates nothing.

Host-side bookkeeping and socket I/O only — nothing here touches a
device.
"""
from __future__ import annotations

import builtins
import json
import socket
import struct
import time
from typing import Any

import numpy as np

from torchbooster_tpu_torch.serving.batcher import Request
from torchbooster_tpu_torch.serving.engine import _PAGE_DTYPES, _PAGE_FIELDS
from torchbooster_tpu_torch.serving.router.replica import Replica

__all__ = [
    "PROTO", "RemoteReplica", "WireClock", "async_recv_msg",
    "async_send_msg", "decode_request", "encode_request", "frame_blob",
    "pack_pages", "policy_from_spec", "policy_spec", "recv_msg",
    "send_msg", "unframe_blob", "unpack_pages",
]

_LEN = struct.Struct(">I")

# one protocol version, checked at hello: framing changes bump it
PROTO = 1


# ---- framing ------------------------------------------------------
def _jsonable(obj: Any) -> Any:
    """Recursively strip numpy scalar/array types out of a payload so
    the stdlib JSON encoder takes it (metrics dicts carry np floats
    from percentile math)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, bytes):
        return obj.hex()
    return obj


def _encode(header: dict, frames: tuple | list = ()) -> bytes:
    head = dict(header)
    head["f"] = [len(f) for f in frames]
    blob = json.dumps(_jsonable(head),
                      separators=(",", ":")).encode("utf-8")
    return b"".join([_LEN.pack(len(blob)), blob, *frames])


def send_msg(sock: socket.socket, header: dict,
             frames: tuple | list = ()) -> int:
    """Write one framed message on a blocking socket; returns the
    bytes sent (the client-side wire counter's unit)."""
    payload = _encode(header, frames)
    sock.sendall(payload)
    return len(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("connection closed mid-message")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> tuple[dict, list[bytes], int]:
    """Read one framed message; returns ``(header, frames, n_bytes)``."""
    head_len = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    header = json.loads(_recv_exact(sock, head_len))
    frames = [_recv_exact(sock, n) for n in header.get("f", [])]
    total = _LEN.size + head_len + sum(header.get("f", []))
    return header, frames, total


def frame_blob(header: dict, frames: tuple | list = ()) -> bytes:
    """The wire encoding as one in-memory blob — what ``send_msg``
    puts on a socket, byte-for-byte. The disaggregation pair streams
    page payloads through this (same framing whether the two pools
    share a process or a datacenter)."""
    return _encode(header, frames)


def unframe_blob(data: bytes) -> tuple[dict, list[bytes]]:
    """Inverse of :func:`frame_blob`."""
    head_len = _LEN.unpack(data[:_LEN.size])[0]
    header = json.loads(data[_LEN.size:_LEN.size + head_len])
    frames: list[bytes] = []
    off = _LEN.size + head_len
    for n in header.get("f", []):
        frames.append(data[off:off + n])
        off += n
    if off != len(data):
        raise ValueError(
            f"framed blob length mismatch: parsed {off} of "
            f"{len(data)} bytes")
    return header, frames


async def async_send_msg(writer, header: dict,
                         frames: tuple | list = ()) -> int:
    payload = _encode(header, frames)
    writer.write(payload)
    await writer.drain()
    return len(payload)


async def async_recv_msg(reader) -> tuple[dict, list[bytes], int]:
    head_len = _LEN.unpack(await reader.readexactly(_LEN.size))[0]
    header = json.loads(await reader.readexactly(head_len))
    frames = [await reader.readexactly(n)
              for n in header.get("f", [])]
    total = _LEN.size + head_len + sum(header.get("f", []))
    return header, frames, total


# ---- page-stream packing (the disaggregation payload) -------------
def pack_pages(pages: list) -> tuple[dict, list[bytes]]:
    """Encode ``[(chain_key_bytes, payload_dict), ...]`` — the engine
    export / host-pool format exactly (int8 K/V + fp32 scales per
    page) — into a framed header + raw frames. Per page: one key
    frame + four payload frames, shapes in the header. The PAYLOAD
    frame bytes (not keys, not the header) are the disaggregation
    wire-accounting unit ``comms.accounting.disagg_traffic`` models —
    returned as ``header["page_bytes"]`` so both ends count without
    re-summing."""
    frames: list[bytes] = []
    rows = []
    page_bytes = 0
    for key, payload in pages:
        row: dict = {"key": len(frames)}
        frames.append(bytes(key))
        for name in _PAGE_FIELDS:
            arr = np.ascontiguousarray(payload[name],
                                       _PAGE_DTYPES[name])
            row[name] = {"frame": len(frames),
                         "shape": list(arr.shape)}
            frames.append(arr.tobytes())
            page_bytes += arr.nbytes
        rows.append(row)
    return {"pages": rows, "page_bytes": page_bytes}, frames


def unpack_pages(header: dict,
                 frames: list[bytes]) -> list[tuple[bytes, dict]]:
    """Inverse of :func:`pack_pages`: ``[(key, payload), ...]`` with
    host-numpy payload arrays, ready for ``HostPagePool.put`` (and
    from there the fixed-shape promotion write)."""
    out = []
    for row in header["pages"]:
        payload = {
            name: np.frombuffer(
                frames[row[name]["frame"]],
                _PAGE_DTYPES[name]).reshape(row[name]["shape"]).copy()
            for name in _PAGE_FIELDS}
        out.append((bytes(frames[row["key"]]), payload))
    return out


# ---- request codec ------------------------------------------------
_REQ_SCALARS = (
    "max_new_tokens", "eos_id", "arrival", "priority", "deadline_ms",
    "arrival_time", "n", "best_of", "seed", "response_format",
    "adapter", "admitted_at", "first_token_at", "finished_at",
    "finish_reason", "shed", "cancelled", "branch", "cum_logprob",
)


def encode_request(req: Request) -> tuple[dict, list[bytes]]:
    """One request as a wire descriptor + two raw frames (prompt ids,
    delivered tokens). ``base_len`` rides explicitly: a previously
    drained request's prompt has folded tokens appended, and the
    receiver must NOT let ``__post_init__`` re-derive the base."""
    head = {"id": req.request_id, "base_len": int(req.base_len),
            "prompt": 0, "tok": 1}
    for name in _REQ_SCALARS:
        head[name] = getattr(req, name)
    frames = [np.ascontiguousarray(req.prompt, np.int32).tobytes(),
              np.asarray(req.tokens, np.int32).tobytes()]
    return head, frames


def decode_request(head: dict, frames: list[bytes]) -> Request:
    """Rebuild a :class:`Request` from the wire. Construction runs
    ``__post_init__`` (validation), then the progress fields —
    ``base_len``, ``tokens``, timestamps, terminal flags — are laid
    over by attribute assignment, which preserves the fold contract
    (``base_len`` stays the ORIGINAL prompt length across any number
    of drain/readmit hops)."""
    prompt = np.frombuffer(frames[head["prompt"]], np.int32).copy()
    req = Request(
        prompt=prompt,
        max_new_tokens=int(head["max_new_tokens"]),
        eos_id=head["eos_id"],
        priority=head["priority"] or "",
        deadline_ms=head["deadline_ms"],
        arrival_time=head["arrival_time"],
        n=int(head["n"]),
        best_of=head["best_of"],
        seed=head["seed"],
        response_format=head["response_format"],
        adapter=head["adapter"] or "",
        request_id=head["id"])
    req.arrival = head["arrival"]
    req.base_len = int(head["base_len"])
    req.tokens = np.frombuffer(frames[head["tok"]], np.int32).tolist()
    for name in ("admitted_at", "first_token_at", "finished_at",
                 "finish_reason", "cum_logprob"):
        setattr(req, name, head[name])
    req.shed = bool(head["shed"])
    req.cancelled = bool(head["cancelled"])
    req.branch = int(head["branch"])
    return req


# ---- scheduler-policy spec (hello payload) ------------------------
def policy_spec(policy) -> dict:
    """Serialize the replica's scheduler policy so the router can
    reconstruct an equivalent object for its fleet-level validate /
    deadline surface (``replay_inprocess`` reads
    ``fleet.policy.ttft_deadline_s``)."""
    if policy is None or not getattr(policy, "slo", False):
        return {"kind": "fcfs"}
    return {
        "kind": "slo",
        "default": policy.default,
        "shed_grace": policy.shed_grace,
        "classes": [{"name": c.name, "ttft_ms": c.ttft_ms,
                     "tpot_ms": c.tpot_ms, "rank": c.rank}
                    for c in policy.classes.values()],
    }


def policy_from_spec(spec: dict):
    from torchbooster_tpu_torch.serving.frontend import (
        FCFSPolicy, PriorityClass, SLOPolicy)

    if spec.get("kind") != "slo":
        return FCFSPolicy()
    classes = {c["name"]: PriorityClass(
        name=c["name"], ttft_ms=c["ttft_ms"], tpot_ms=c["tpot_ms"],
        rank=c["rank"]) for c in spec["classes"]}
    return SLOPolicy(classes, default=spec["default"],
                     shed_grace=spec["shed_grace"])


# ---- the server-side wire clock -----------------------------------
class WireClock:
    """The replica server's injectable batcher clock, pinned to the
    ROUTER's clock readings: every RPC carries ``now`` and
    :meth:`set` re-anchors. Real-time mode (default) interpolates
    between RPCs with a local monotonic delta — same-host arithmetic
    only, so cross-host skew never enters any timestamp. ``frozen``
    mode (the router replays under a virtual clock) returns the last
    anchored value verbatim, reproducing exactly the
    constant-within-a-step readings an in-process replica sees under
    ``ReplayClock`` — the socket-parity precondition."""

    def __init__(self):
        self._base = 0.0
        self._anchor = time.perf_counter()
        self.frozen = False

    def set(self, now: float) -> None:
        self._base = float(now)
        self._anchor = time.perf_counter()

    def __call__(self) -> float:
        if self.frozen:
            return self._base
        return self._base + (time.perf_counter() - self._anchor)


# ---- the client ---------------------------------------------------
def _parse_endpoint(endpoint) -> tuple[str, int]:
    if isinstance(endpoint, (tuple, list)):
        host, port = endpoint
        return str(host), int(port)
    host, _, port = str(endpoint).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"endpoint must be 'host:port' or (host, port), got "
            f"{endpoint!r}")
    return host, int(port)


class RemoteReplica(Replica):
    """A batcher in another process behind the :class:`Replica`
    surface (module docstring has the protocol contract).

    The client keeps a MIRROR :class:`Request` per in-flight offer —
    the very object the fleet routed, identity-stable across
    readmission hops — and applies every wire event to it (token
    batches, timestamps, terminal flags), so the fleet's event
    consumers and the readmission fold read state byte-equivalent to
    an in-process replica's. Probe properties serve from the cached
    per-response probe block — synchronous, no RPC on the routing
    path."""

    def __init__(self, endpoint, replica_id: int = -1, *,
                 timeout_s: float = 300.0,
                 connect_timeout_s: float = 10.0):
        self.replica_id = int(replica_id)
        self.alive = True
        host, port = _parse_endpoint(endpoint)
        self.endpoint = f"{host}:{port}"
        self._sock = socket.create_connection(
            (host, port), timeout=connect_timeout_s)
        self._sock.settimeout(timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                              1)
        self._conn_dead = False
        self._clock = time.perf_counter
        self._reqs: dict[str, Request] = {}
        self._owned: dict[str, Request] = {}
        self._tier_cb = None
        self._probe: dict = {}
        self._probe_at = 0.0
        self.wire_tx_bytes = 0
        self.wire_rx_bytes = 0
        hello, _ = self._call({"op": "hello", "proto": PROTO})
        if hello.get("proto") != PROTO:
            raise RuntimeError(
                f"replica {self.endpoint} speaks protocol "
                f"{hello.get('proto')}, client speaks {PROTO}")
        self.geometry: dict = hello["geometry"]
        self._policy = policy_from_spec(hello["policy"])

    # -- plumbing --------------------------------------------------
    def _call(self, header: dict,
              frames: tuple | list = ()) -> tuple[dict, list[bytes]]:
        if self._conn_dead:
            raise RuntimeError(
                f"replica {self.replica_id} ({self.endpoint}): "
                "connection is dead")
        header["now"] = self._clock()
        try:
            self.wire_tx_bytes += send_msg(self._sock, header, frames)
            resp, rframes, n = recv_msg(self._sock)
            self.wire_rx_bytes += n
        except (OSError, ConnectionError, EOFError) as exc:
            self._conn_dead = True
            raise RuntimeError(
                f"replica {self.replica_id} ({self.endpoint}): "
                f"connection lost: {exc}") from exc
        probe = resp.get("probe")
        if probe is not None:
            self._probe = probe
            self._probe_at = header["now"]
        if self._tier_cb is not None:
            for ev in resp.get("tier", ()):
                self._tier_cb(ev["ev"], rframes[ev["frame"]])
        err = resp.get("err")
        if err is not None:
            exc_type = getattr(builtins, err.get("type", ""), None)
            if not (isinstance(exc_type, type)
                    and issubclass(exc_type, Exception)):
                exc_type = RuntimeError
            raise exc_type(err.get("msg", "remote error"))
        return resp, rframes

    def close(self) -> None:
        try:
            self._sock.close()
        finally:
            self._conn_dead = True

    # -- lifecycle surface -----------------------------------------
    @property
    def policy(self):
        return self._policy

    @property
    def page_size(self) -> int:
        return int(self.geometry["page_size"])

    @property
    def clock(self):
        return self._clock

    @clock.setter
    def clock(self, fn) -> None:
        # any injected clock is replay semantics: freeze the server's
        # wire clock so both arms see identical constant-within-a-
        # step readings (the parity precondition)
        self._clock = fn
        self._call({"op": "clock",
                    "frozen": fn is not time.perf_counter})

    def start_session(self) -> None:
        self._reqs.clear()
        self._owned.clear()
        self._call({"op": "start_session"})

    def finish_session(self) -> dict:
        head, _ = self._call({"op": "finish_session"})
        return head["metrics"]

    def check_fits(self, req: Request) -> None:
        head, frames = encode_request(req)
        self._call({"op": "check", "req": head}, frames)

    def set_tier_observer(self, fn) -> None:
        self._tier_cb = fn
        self._call({"op": "tier_events", "on": fn is not None})

    # -- offer / withdraw ------------------------------------------
    def submit(self, req: Request, arrival: float) -> None:
        head, frames = encode_request(req)
        self._call({"op": "submit", "req": head,
                    "arrival": float(arrival)}, frames)
        self._reqs[req.request_id] = req
        self._owned[req.request_id] = req

    def cancel(self, req: Request) -> None:
        if self._conn_dead:
            return          # death readmission will handle it
        self._call({"op": "cancel", "id": req.request_id})

    # -- pump ------------------------------------------------------
    def step(self) -> list:
        head, frames = self._call({"op": "step"})
        events: list = []
        for row in head["events"]:
            req = self._reqs.get(row["id"])
            if req is None:
                req = self._adopt_child(row, frames)
            toks = ([] if row.get("tok") is None else
                    np.frombuffer(frames[row["tok"]],
                                  np.int32).tolist())
            req.tokens.extend(toks)
            for name in ("admitted_at", "first_token_at",
                         "finished_at", "finish_reason",
                         "cum_logprob"):
                setattr(req, name, row[name])
            req.shed = bool(row["shed"])
            req.cancelled = bool(row["cancelled"])
            events.append((req, toks))
            if row["finished_at"] is not None:
                self._owned.pop(row["id"], None)
                self._prune(req)
        return events

    def _adopt_child(self, row: dict, frames: list[bytes]) -> Request:
        """First sight of a server-side fork sibling: materialize its
        mirror and link the family exactly as the batcher does, so the
        fleet's whole-family ownership cleanup works unchanged."""
        desc = row.get("new")
        if desc is None:
            raise RuntimeError(
                f"replica {self.replica_id}: event for unknown "
                f"request {row['id']!r} with no descriptor")
        child = Request(
            prompt=np.frombuffer(frames[desc["prompt"]],
                                 np.int32).copy(),
            max_new_tokens=int(desc["max_new_tokens"]),
            eos_id=desc["eos_id"],
            priority=desc["priority"] or "",
            deadline_ms=desc["deadline_ms"],
            n=int(desc["n"]),
            best_of=desc["best_of"],
            seed=desc["seed"],
            adapter=desc["adapter"] or "",
            request_id=row["id"])
        child.arrival = desc["arrival"]
        child.base_len = int(desc["base_len"])
        child.branch = int(desc["branch"])
        parent = self._reqs.get(desc["parent"])
        if parent is not None:
            child.parent = parent
            if parent.branches is None:
                parent.branches = [parent]
            parent.branches.append(child)
            parent.branches.sort(key=lambda r: r.branch)
        self._reqs[row["id"]] = child
        self._owned[row["id"]] = child
        return child

    def _prune(self, req: Request) -> None:
        """Drop finished families from the mirror map (the fleet's
        ``_owner`` discipline: bookkeeping bounded by in-flight
        work)."""
        root = req.parent if req.parent is not None else req
        family = root.branches or [root]
        if all(r.finished_at is not None for r in family):
            for r in family:
                self._reqs.pop(r.request_id, None)

    # -- probe / score inputs --------------------------------------
    @property
    def queue_depth(self) -> int:
        return int(self._probe.get("queue_depth", 0))

    @property
    def inflight(self) -> int:
        return int(self._probe.get("inflight", 0))

    @property
    def est_step_s(self) -> float:
        est = self._probe.get("est_step_s", 0.0)
        return float(est)

    @property
    def est_chunk_s(self) -> float:
        est = self._probe.get("est_chunk_s", 0.0)
        return float(est)

    @property
    def has_work(self) -> bool:
        return bool(self._probe.get("has_work", False))

    @property
    def occupancy(self) -> float:
        occ = self._probe.get("occupancy", 0.0)
        return float(occ)

    def readiness(self) -> dict:
        out = dict(self._probe.get("readiness", {"status": "unknown"}))
        # sender-relative payload age: the wire's own age_s (server
        # now - stamp moment, same-host) plus local time since this
        # client received it (same-host again). No term ever
        # differences two hosts' clocks.
        wire_age = out.get("age_s", 0.0)
        out["age_s"] = round(
            float(wire_age)
            + max(0.0, self._clock() - self._probe_at), 6)
        out["replica"] = self.replica_id
        out["alive"] = self.alive
        return out

    # -- readmission -----------------------------------------------
    def drain_unfinished(self, retire_seated: bool) -> list:
        if self._conn_dead:
            # the wire died with the server: fold DELIVERED tokens
            # into each mirror's prompt locally — the batcher's
            # preemption fold, same arithmetic, applied to the
            # client's ground truth. Nothing delivered is lost,
            # nothing re-delivered after re-admission.
            out = sorted(
                (r for r in self._owned.values()
                 if r.finished_at is None),
                key=lambda r: (r.arrival, r.request_id))
            for req in out:
                folded = len(req.prompt) - req.base_len
                req.prompt = np.concatenate(
                    [req.prompt,
                     np.asarray(req.tokens[folded:], np.int32)])
            self._owned.clear()
            return out
        head, frames = self._call(
            {"op": "drain_unfinished",
             "retire_seated": bool(retire_seated)})
        return self._take_back(head, frames)

    def drain_queued(self, n: int) -> list:
        if self._conn_dead:
            return []
        head, frames = self._call({"op": "drain_queued", "n": int(n)})
        return self._take_back(head, frames)

    def _take_back(self, head: dict, frames: list[bytes]) -> list:
        out: list[Request] = []
        for row in head["reqs"]:
            req = self._reqs.get(row["id"])
            if req is None:
                # a request this client never offered (server-side
                # fork child drained mid-prefill): adopt it cold
                req = decode_request(row, frames)
                self._reqs[row["id"]] = req
            else:
                req.prompt = np.frombuffer(
                    frames[row["prompt"]], np.int32).copy()
                req.tokens = np.frombuffer(
                    frames[row["tok"]], np.int32).tolist()
                for name in ("first_token_at", "admitted_at",
                             "cum_logprob"):
                    setattr(req, name, row[name])
            self._owned.pop(row["id"], None)
            out.append(req)
        return out

    # -- introspection ---------------------------------------------
    def debug_snapshot(self, timeline_tail: int = 20) -> dict:
        head, _ = self._call({"op": "debug_snapshot",
                              "timeline_tail": int(timeline_tail)})
        return head["snapshot"]

    def debug_row(self) -> dict:
        if self._conn_dead or not self.alive:
            # the wire (and the flight ring behind it) is gone; keep
            # the fleet row shape so /debug/engine still renders
            return {"replica": self.replica_id, "alive": False,
                    "queue_depth": 0, "endpoint": self.endpoint,
                    "flight": {"n_recorded": 0, "capacity": 0,
                               "records": [], "anomalies": []}}
        head, _ = self._call({"op": "debug_row"})
        row = head["row"]
        row["replica"] = self.replica_id
        row["alive"] = self.alive
        row["endpoint"] = self.endpoint
        return row
