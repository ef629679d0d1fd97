"""Plain attention over (B, S, H, D) tensors — the numerical ground
truth of ``torchbooster_tpu/ops/attention.py``. The flash kernels that
the JAX package dispatches to on a TPU at S >= 4096 belong to the
training slice; the serving path's prefill always runs this."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30   # the JAX package's mask value (never -inf)


def expand_kv_heads(kv: torch.Tensor, rep: int) -> torch.Tensor:
    """Grouped → query head expansion: query head ``h`` reads grouped
    head ``h // rep`` (block-repeat on the head axis)."""
    return kv if rep == 1 else kv.repeat_interleave(rep, dim=2)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  sm_scale: float | None = None) -> torch.Tensor:
    """softmax(QKᵀ·scale + mask)V over (B, S, H, D), softmax in fp32.
    Grouped (GQA) k/v expand to the query head count."""
    head_dim = q.shape[-1]
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k, v = expand_kv_heads(k, rep), expand_kv_heads(v, rep)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    if causal:
        s_q, s_k = scores.shape[-2:]
        mask = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


__all__ = ["NEG_INF", "expand_kv_heads", "mha_reference"]
