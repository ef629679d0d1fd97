"""Paged serving — the port of ``torchbooster_tpu/serving``: block
tables (kv_pages), the paged engine (engine), the continuous batcher
(batcher) and its scheduler policies (frontend.scheduler)."""
from __future__ import annotations

from torchbooster_tpu_torch.serving.batcher import ContinuousBatcher, Request
from torchbooster_tpu_torch.serving.engine import PagedEngine
from torchbooster_tpu_torch.serving.kv_pages import (
    NULL_PAGE,
    BlockTables,
    PoolExhausted,
    make_pool,
)

__all__ = ["BlockTables", "ContinuousBatcher", "NULL_PAGE", "PagedEngine",
           "PoolExhausted", "Request", "make_pool"]
