"""Shared helper of the torch checkpoint importers
(``gpt.load_torch_gpt2``) — the port's own copy of the JAX package's
``models/torch_interop.py``."""
from __future__ import annotations

from typing import Any

import numpy as np


def to_numpy(t: Any) -> np.ndarray:
    """A torch tensor or array-like → numpy (host copy of a tensor)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


__all__ = ["to_numpy"]
