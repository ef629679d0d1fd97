"""Paged serving — the port of ``torchbooster_tpu/serving``: block
tables (kv_pages), the paged engine (engine), speculative drafting and
verify (speculative), the continuous batcher (batcher), its scheduler
policies and the asyncio HTTP front door (frontend), the workload
capture/replay harness (loadgen), structured generation (structured),
the LoRA adapter registry (adapters), prefill/decode disaggregation
(disagg), and the engine fleet (router: ``EngineFleet``, its routing
policies, prefix directory, health scorer, audit trail and socket
replicas; the names below load it lazily) with its replica server
(replica_server). ``ServingFrontend`` loads lazily too (the HTTP layer).
``eager_steps()`` runs the engine's captured steps eagerly on the card
(``_graphs.py``)."""
from __future__ import annotations

from torchbooster_tpu_torch._graphs import eager_steps
from torchbooster_tpu_torch.serving.adapters import (
    AdapterRegistry,
    random_adapter,
)
from torchbooster_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    Request,
    best_completions,
)
from torchbooster_tpu_torch.serving.disagg import DisaggPair
from torchbooster_tpu_torch.serving.engine import PagedEngine
from torchbooster_tpu_torch.serving.frontend import (
    FCFSPolicy,
    PriorityClass,
    SchedulerPolicy,
    SLOPolicy,
)
from torchbooster_tpu_torch.serving.kv_pages import (
    NULL_PAGE,
    BlockTables,
    HostPagePool,
    PoolExhausted,
    make_pool,
)
from torchbooster_tpu_torch.serving.speculative import (
    NO_DRAFT,
    PromptLookupDrafter,
    TreeLookupDrafter,
)

_ROUTER_NAMES = ("EngineFleet", "InProcessReplica", "AffinityRouting",
                 "RoundRobinRouting", "PrefixDirectory")


def __getattr__(name: str):
    if name == "ServingFrontend":     # lazy: pulls in the http layer
        from torchbooster_tpu_torch.serving.frontend import ServingFrontend

        return ServingFrontend
    if name in _ROUTER_NAMES:         # lazy: the fleet layer
        from torchbooster_tpu_torch.serving import router

        return getattr(router, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


__all__ = ["AdapterRegistry", "AffinityRouting", "BlockTables",
           "ContinuousBatcher", "DisaggPair", "EngineFleet", "FCFSPolicy",
           "HostPagePool", "InProcessReplica", "NO_DRAFT", "NULL_PAGE",
           "PagedEngine", "PoolExhausted", "PrefixDirectory",
           "PriorityClass", "PromptLookupDrafter", "Request",
           "RoundRobinRouting", "SLOPolicy", "SchedulerPolicy",
           "ServingFrontend", "TreeLookupDrafter", "best_completions",
           "eager_steps", "make_pool", "random_adapter"]
