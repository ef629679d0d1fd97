"""Paged serving — the port of ``torchbooster_tpu/serving``: block
tables (kv_pages), the paged engine (engine), speculative drafting and
verify (speculative), the continuous batcher (batcher) and its
scheduler policies (frontend.scheduler), structured generation
(structured), the LoRA adapter registry (adapters), prefill/decode
disaggregation (disagg) and the router's wire codec (router.rpc)."""
from __future__ import annotations

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

__all__ = ["AdapterRegistry", "BlockTables", "ContinuousBatcher",
           "DisaggPair", "HostPagePool", "NO_DRAFT", "NULL_PAGE",
           "PagedEngine", "PoolExhausted", "PromptLookupDrafter", "Request",
           "TreeLookupDrafter", "best_completions", "make_pool",
           "random_adapter"]
