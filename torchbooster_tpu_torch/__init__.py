"""PyTorch/CUDA port of torchbooster_tpu, one slice at a time.

The package mirrors the JAX package's module paths
(``torchbooster_tpu/serving/engine.py`` ↔
``torchbooster_tpu_torch/serving/engine.py``) and imports neither JAX
nor anything of ``torchbooster_tpu``: it keeps its own copies of what
it needs. Every TPU kernel on a ported path becomes a kernel written by
hand for Hopper (``sm_90a``), built from this package's sources at
first use — never at import — and held to a plain PyTorch version that
lives beside it.

Ported so far: the paged GPT serving path — ``ServingConfig.make`` →
``ContinuousBatcher.run`` over ``PagedEngine`` — with the paged
flash-decode kernel in CUDA C++ (``ops/csrc/paged_attention.cu``).

Entry points (``GPT.init``, ``PagedEngine``, ``ServingConfig.make``)
run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; with no card and no explicit CPU device they raise.
"""
from __future__ import annotations

__all__: list[str] = []
