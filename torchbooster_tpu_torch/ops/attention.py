"""Attention over (B, S, H, D) tensors — the port of
``torchbooster_tpu/ops/attention.py``: the plain ``mha_reference`` (the
numerical ground truth) and the ``attention`` dispatcher, which sends
CUDA tensors to the flash kernels (``ops/flash_attention.py``) and CPU
tensors to the reference. ``GPT.apply`` and the prefill of the dense
``generate`` both attend through the dispatcher, as in the JAX package."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30   # the JAX package's mask value (never -inf)

# calls of ``mha_reference``: on the card a run shows with it that no
# attention of its path fell back from the flash kernels
reference_calls = 0


def expand_kv_heads(kv: torch.Tensor, rep: int) -> torch.Tensor:
    """Grouped → query head expansion: query head ``h`` reads grouped
    head ``h // rep`` (block-repeat on the head axis)."""
    return kv if rep == 1 else kv.repeat_interleave(rep, dim=2)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  sm_scale: float | None = None) -> torch.Tensor:
    """softmax(QKᵀ·scale + mask)V over (B, S, H, D), softmax in fp32.
    Grouped (GQA) k/v expand to the query head count."""
    global reference_calls
    reference_calls += 1
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


def flash_auto_engaged(seq_len_q: int, seq_len_kv: int | None = None,
                       device: str | torch.device = "cuda",
                       head_dim: int | None = None,
                       dtype: torch.dtype | None = None) -> bool:
    """THE predicate ``attention(impl="auto")`` evaluates: the flash
    kernels on a CUDA device whenever both lengths are tileable and the
    kernels are built for the head dim and dtype (``None`` leaves either
    unchecked); elsewhere the reference, as the JAX dispatcher falls back
    wherever its kernel does not engage. The JAX package's ``S >= 4096``
    threshold is a TPU v5e crossover and does not carry over; the H100
    crossover is measured in PERF.md."""
    from torchbooster_tpu_torch.ops.flash_attention import (
        HEAD_DIMS,
        KERNEL_DTYPES,
        tileable,
    )

    if seq_len_kv is None:
        seq_len_kv = seq_len_q
    return (torch.device(device).type == "cuda"
            and (head_dim is None or head_dim in HEAD_DIMS)
            and (dtype is None or dtype in KERNEL_DTYPES)
            and tileable(seq_len_q) and tileable(seq_len_kv))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, sm_scale: float | None = None,
              impl: str = "auto") -> torch.Tensor:
    """(B, S, H, D) attention. ``impl``: ``"auto"`` (the flash kernels on
    the card when :func:`flash_auto_engaged`, else the reference),
    ``"flash"`` (the kernels on the card, their plain blocked version on
    the CPU) or ``"reference"``."""
    if impl == "auto":
        impl = ("flash" if flash_auto_engaged(
            q.shape[1], k.shape[1], q.device, q.shape[-1], q.dtype)
            else "reference")
    if impl == "reference":
        return mha_reference(q, k, v, causal, sm_scale)
    if impl != "flash":
        raise ValueError(f"unknown attention impl {impl!r}; use 'auto', "
                         "'flash' or 'reference'")
    from torchbooster_tpu_torch.ops.flash_attention import flash_attention

    b, s_q, h, d = q.shape
    s_kv, h_kv = k.shape[1], k.shape[2]
    # heads fold into the batch; grouped k/v fold at their own width (the
    # kernels index grouped rows directly, so no expanded copy exists)
    qf = q.transpose(1, 2).reshape(b * h, s_q, d)
    kf = k.transpose(1, 2).reshape(b * h_kv, s_kv, d)
    vf = v.transpose(1, 2).reshape(b * h_kv, s_kv, d)
    out = flash_attention(qf, kf, vf, causal=causal, sm_scale=sm_scale)
    return out.reshape(b, h, s_q, d).transpose(1, 2)


__all__ = ["NEG_INF", "attention", "expand_kv_heads", "flash_auto_engaged",
           "mha_reference", "reference_calls"]
