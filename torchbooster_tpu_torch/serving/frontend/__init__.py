"""Serving front door: scheduling policies + the asyncio HTTP API — the
port of ``torchbooster_tpu/serving/frontend``.

Two layers, deliberately separable:

- :mod:`scheduler` — the policy objects the batcher consults
  (:class:`FCFSPolicy` — the default, byte-for-byte the pre-frontend
  behavior — and :class:`SLOPolicy` — priority classes, deadline-
  driven admission, cost-aware preemption, load shedding);
- :mod:`server` — the stdlib-only asyncio OpenAI-compatible HTTP
  server (``/v1/completions`` + ``/v1/chat/completions`` with SSE
  streaming, request ids, cancellation on client disconnect,
  429 + Retry-After backpressure, graceful shutdown) that pumps a
  :class:`~torchbooster_tpu_torch.serving.batcher.ContinuousBatcher`
  without ever blocking the event loop on the device.

``server`` (and :mod:`http`, its request parser) are imported lazily:
the batcher itself imports :mod:`scheduler` for its default policy,
and an eager import here would cycle back through the batcher.
"""
from torchbooster_tpu_torch.serving.frontend.scheduler import (
    FCFSPolicy,
    PriorityClass,
    SLOPolicy,
    SchedulerPolicy,
    parse_classes,
)

_SERVER_NAMES = ("ServingFrontend", "IdCodec")

__all__ = ["FCFSPolicy", "IdCodec", "PriorityClass", "SLOPolicy",
           "SchedulerPolicy", "ServingFrontend", "parse_classes"]


def __getattr__(name: str):
    if name in _SERVER_NAMES:
        from torchbooster_tpu_torch.serving.frontend import server

        return getattr(server, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
