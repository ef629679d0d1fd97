"""The router's wire codec — the codec half of the port of
``torchbooster_tpu/serving/router/rpc.py``. Its bytes are the JAX
module's for the same input.

**Framing.** Length-prefixed, stdlib only::

    >I header_len | header (UTF-8 JSON) | frame_0 | frame_1 | ...

The JSON header carries the op, its scalar arguments, and ``"f"`` — a
list of raw-frame byte lengths. Bulk payloads (token ids, prompts,
quantized K/V pages) ride the raw frames: numpy ``tobytes()`` on one
end, ``frombuffer`` on the other, never JSON-encoded. The same frames
carry the disaggregation page stream (:func:`pack_pages` /
:func:`unpack_pages` — the host spill tier's demotion payload, int8
values + fp32 scales, byte for byte what ``HostPagePool`` stores).

``RemoteReplica``, the replica server's ``WireClock`` and the scheduler
policy spec of the hello message wait for the router (``ROADMAP.md``
A-4). Host-side bookkeeping and socket I/O only — nothing here touches
a device.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Any

import numpy as np

from torchbooster_tpu_torch.serving.batcher import Request
from torchbooster_tpu_torch.serving.engine import _PAGE_DTYPES, _PAGE_FIELDS

__all__ = [
    "PROTO", "decode_request", "encode_request", "frame_blob",
    "pack_pages", "recv_msg", "send_msg", "unframe_blob", "unpack_pages",
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
