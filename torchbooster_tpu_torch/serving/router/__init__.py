"""The engine fleet's router — the port of ``torchbooster_tpu/serving/
router``. Only the wire codec is ported so far (:mod:`rpc`: the framed
transport, the page-stream packing disaggregated serving carries, and
the request codec); the replicas, routing, directory, health, audit and
fleet wait for the router (``ROADMAP.md`` A-4)."""
from __future__ import annotations

from torchbooster_tpu_torch.serving.router.rpc import (
    decode_request,
    encode_request,
    frame_blob,
    pack_pages,
    recv_msg,
    send_msg,
    unframe_blob,
    unpack_pages,
)

__all__ = ["decode_request", "encode_request", "frame_blob", "pack_pages",
           "recv_msg", "send_msg", "unframe_blob", "unpack_pages"]
