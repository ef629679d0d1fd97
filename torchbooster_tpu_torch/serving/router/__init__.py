"""The engine fleet's router — the port of ``torchbooster_tpu/serving/
router``: N data-parallel replicas behind one front door.

- :mod:`replica` — the replica boundary (:class:`Replica`) and its
  in-process implementation (:class:`InProcessReplica`, a
  ``ContinuousBatcher`` stepped by the fleet loop);
- :mod:`rpc` — the socket transport: the framed codec, the page-stream
  packing disaggregated serving carries, the request codec, and
  :class:`~.rpc.RemoteReplica`, a batcher in a ``replica_server``
  behind the same surface;
- :mod:`routing` — the routing decision (:class:`RoundRobinRouting`;
  :class:`AffinityRouting`, page-aligned prefix affinity with a load
  spill over a least-expected-slack score), a pure function of host
  counters;
- :mod:`directory` — :class:`PrefixDirectory`, chain key -> ``{replica:
  tier}`` from the replicas' tier events, consulted on an affinity-map
  miss and purged on replica death;
- :mod:`health` — :class:`FleetHealth`, the hysteretic per-replica
  health scorer;
- :mod:`audit` — :class:`RoutingAudit`, one bounded record per routing
  decision, the pid-3 Chrome track and the diffable routing artifact;
- :mod:`fleet` — :class:`EngineFleet`, the batcher-shaped core:
  arrival routing, one step per live replica per fleet step,
  readmission on replica death or a sustained hot-spot, and the
  ``router_*`` telemetry.

``ServingFrontend(fleet)`` serves a fleet over HTTP,
``replay_inprocess(fleet, workload)`` replays workloads against it, and
the ``serving.router:`` block (``config.RouterConfig``) builds one.
"""
from __future__ import annotations

from torchbooster_tpu_torch.serving.router.audit import (
    RoutingAudit,
    chrome_router_events,
    diff_routing,
    routing_artifact,
)
from torchbooster_tpu_torch.serving.router.directory import PrefixDirectory
from torchbooster_tpu_torch.serving.router.fleet import EngineFleet
from torchbooster_tpu_torch.serving.router.health import FleetHealth
from torchbooster_tpu_torch.serving.router.replica import (
    InProcessReplica,
    Replica,
)
from torchbooster_tpu_torch.serving.router.routing import (
    AffinityRouting,
    RoundRobinRouting,
    RoutingPolicy,
    make_routing,
    prefix_affinity_key,
)
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

__all__ = [
    "AffinityRouting",
    "EngineFleet",
    "FleetHealth",
    "InProcessReplica",
    "PrefixDirectory",
    "Replica",
    "RoundRobinRouting",
    "RoutingAudit",
    "RoutingPolicy",
    "chrome_router_events",
    "decode_request",
    "diff_routing",
    "encode_request",
    "frame_blob",
    "make_routing",
    "pack_pages",
    "prefix_affinity_key",
    "recv_msg",
    "routing_artifact",
    "send_msg",
    "unframe_blob",
    "unpack_pages",
]
