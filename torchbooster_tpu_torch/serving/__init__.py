"""Paged serving — the port of ``torchbooster_tpu/serving``: block
tables (kv_pages), the paged engine (engine), speculative drafting and
verify (speculative), the continuous batcher (batcher) and its
scheduler policies (frontend.scheduler)."""
from __future__ import annotations

from torchbooster_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    Request,
    best_completions,
)
from torchbooster_tpu_torch.serving.engine import PagedEngine
from torchbooster_tpu_torch.serving.kv_pages import (
    NULL_PAGE,
    BlockTables,
    PoolExhausted,
    make_pool,
)
from torchbooster_tpu_torch.serving.speculative import (
    NO_DRAFT,
    PromptLookupDrafter,
    TreeLookupDrafter,
)

__all__ = ["BlockTables", "ContinuousBatcher", "NO_DRAFT", "NULL_PAGE",
           "PagedEngine", "PoolExhausted", "PromptLookupDrafter", "Request",
           "TreeLookupDrafter", "best_completions", "make_pool"]
