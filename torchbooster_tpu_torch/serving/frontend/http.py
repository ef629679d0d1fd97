"""Minimal stdlib HTTP/1.1 plumbing for the serving front door — a
copy of ``torchbooster_tpu/serving/frontend/http.py``: its bytes are the
JAX module's for the same input.

Deliberately tiny: the server (frontend/server.py) speaks exactly the
OpenAI-completions dialect — small JSON POSTs in, JSON or an SSE
stream out, one request per connection (``Connection: close``) — so a
full framework buys nothing but a dependency. This module is the
whole wire layer: an ``asyncio.StreamReader`` request parser with
hard header/body limits, response serializers, and the three
Server-Sent-Events primitives streaming needs. Anything beyond that
dialect (pipelining, chunked request bodies, upgrades) is rejected
loudly with the right status code rather than half-supported.

Optional acceleration (uvloop, where it is installed) swaps the event
loop under this code, never the code itself — the parser is pure
asyncio and runs identically on either loop.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

# hard limits: this is a front door, not a general proxy — a request
# line + headers beyond 16 KiB or a body beyond 8 MiB is garbage or
# abuse either way
MAX_HEADER_BYTES = 16 * 1024
MAX_BODY_BYTES = 8 * 1024 * 1024

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout",
    409: "Conflict", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    501: "Not Implemented", 503: "Service Unavailable",
}


class HttpError(Exception):
    """Parse/validation failure carrying its HTTP status. ``headers``
    ride into the response (Retry-After on 429s)."""

    def __init__(self, status: int, message: str,
                 headers: dict[str, str] | None = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers or {}


@dataclass
class HttpRequest:
    method: str
    path: str
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    def json(self) -> Any:
        if not self.body:
            raise HttpError(400, "empty body: expected a JSON object")
        try:
            return json.loads(self.body)
        except json.JSONDecodeError as exc:
            raise HttpError(400, f"invalid JSON body: {exc}") from None


async def read_request(reader) -> HttpRequest | None:
    """Parse one request off the stream; None on a clean EOF (client
    closed without sending). Raises :class:`HttpError` on malformed
    or oversized input — the server turns that into a 4xx."""
    import asyncio

    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as exc:
        # subclass of EOFError, so it must be caught FIRST: an empty
        # partial is a clean pre-request close, anything else is a
        # truncated head the client should hear about
        if exc.partial == b"":
            return None
        raise HttpError(400, "connection closed mid-request-head") \
            from None
    except asyncio.LimitOverrunError:
        # no CRLFCRLF within the stream's read limit
        raise HttpError(413, "request head exceeds the stream "
                        "limit") from None
    except EOFError:
        return None
    if len(head) > MAX_HEADER_BYTES:
        raise HttpError(413, "request head exceeds "
                        f"{MAX_HEADER_BYTES} bytes")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HttpError(400, f"malformed request line {lines[0]!r}")
    method, path, _version = parts
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise HttpError(400, f"malformed header line {line!r}")
        headers[name.strip().lower()] = value.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        raise HttpError(501, "chunked request bodies not supported")
    body = b""
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise HttpError(400, "malformed Content-Length") from None
        if n < 0 or n > MAX_BODY_BYTES:
            raise HttpError(413,
                            f"body exceeds {MAX_BODY_BYTES} bytes")
        if n:
            try:
                body = await reader.readexactly(n)
            except Exception:
                raise HttpError(
                    400, "connection closed mid-body") from None
    return HttpRequest(method.upper(), path, headers, body)


def _head(status: int, content_type: str, length: int | None,
          extra: dict[str, str] | None = None) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
             f"Content-Type: {content_type}",
             "Connection: close"]
    if length is not None:
        lines.append(f"Content-Length: {length}")
    for name, value in (extra or {}).items():
        lines.append(f"{name}: {value}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def json_response(status: int, payload: Any,
                  headers: dict[str, str] | None = None) -> bytes:
    body = json.dumps(payload).encode()
    return _head(status, "application/json", len(body), headers) + body


def error_response(err: HttpError) -> bytes:
    # the OpenAI error envelope, so off-the-shelf clients surface the
    # message instead of a bare status
    return json_response(
        err.status,
        {"error": {"message": err.message, "type": "invalid_request_error"
                   if err.status < 500 else "server_error",
                   "code": err.status}},
        err.headers)


def text_response(status: int, text: str,
                  content_type: str = "text/plain; version=0.0.4") \
        -> bytes:
    body = text.encode()
    return _head(status, content_type, len(body)) + body


def sse_head(headers: dict[str, str] | None = None) -> bytes:
    """Response head opening a Server-Sent-Events stream (sent before
    the first event; unknown length, closed by connection close).
    ``headers`` ride along (the echoed X-Request-Id)."""
    return _head(200, "text/event-stream",
                 None, {"Cache-Control": "no-cache", **(headers or {})})


def sse_event(payload: Any) -> bytes:
    return b"data: " + json.dumps(payload).encode() + b"\n\n"


SSE_DONE = b"data: [DONE]\n\n"


__all__ = ["HttpError", "HttpRequest", "MAX_BODY_BYTES",
           "MAX_HEADER_BYTES", "SSE_DONE", "error_response",
           "json_response", "read_request", "sse_event", "sse_head",
           "text_response"]
