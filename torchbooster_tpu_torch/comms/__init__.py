"""Communication accounting — the port of ``torchbooster_tpu/comms``'s
jax-free ``accounting.py``. The multi-GPU gradient comms
(``quantized.py``, ``zero.py``, ``schedule.py``) are not ported yet
(``ROADMAP.md`` A-5)."""
from __future__ import annotations

from torchbooster_tpu_torch.comms.accounting import (
    disagg_traffic,
    overlap_report,
    promotion_traffic,
    record_step_traffic,
    spill_breakeven,
    step_traffic,
    xla_collective_traffic,
)

__all__ = ["disagg_traffic", "overlap_report", "promotion_traffic",
           "record_step_traffic", "spill_breakeven", "step_traffic",
           "xla_collective_traffic"]
