"""All-to-all (Ulysses) sequence parallelism, the second strategy beside
the ring — the port of ``torchbooster_tpu/parallel/ulysses.py``.

q/k/v arrive sequence-split (each rank holds an ``S/sp`` chunk of every
head). One all-to-all per tensor re-splits them by head — afterwards
each rank holds the FULL sequence of ``H/sp`` heads — so attention is
one local call through the port's dispatcher (``ops.attention``: B1-B3
on the card) with ordinary causal masking, and one all-to-all brings
the output back to sequence chunks. The exchanges are
``all_to_all_single`` over the ``sp`` group (the form gloo implements)
on ``(sp, ...)`` chunk-first tensors, differentiable
(:func:`~torchbooster_tpu_torch.distributed.diff_all_to_all`).

Grouped K/V ride the exchange un-expanded when their head count divides
``sp``, and stay grouped into the local attention; otherwise
:func:`sequence_attention` expands them first, so any head-count
combination stays correct. ``"auto"`` picks Ulysses when the heads
divide, the ring otherwise, and the ring for grouped K/V that fit only
the ring.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch

from torchbooster_tpu_torch import distributed as dist


def _seq_to_heads(x: torch.Tensor, group: Any, n: int) -> torch.Tensor:
    """``(B, S/n, H, D)`` sequence chunk → ``(B, S, H/n, D)``: head
    group ``j`` goes to rank ``j``, the sequence chunks come back in rank
    order (JAX ``all_to_all(split_axis=2, concat_axis=1, tiled=True)``)."""
    b, s, h, d = x.shape
    t = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    t = dist.diff_all_to_all(t, group)
    return t.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(x: torch.Tensor, group: Any, n: int) -> torch.Tensor:
    """The inverse: ``(B, S, H/n, D)`` → ``(B, S/n, H, D)``."""
    b, s_full, hl, d = x.shape
    s = s_full // n
    t = x.reshape(b, n, s, hl, d).permute(1, 0, 2, 3, 4).contiguous()
    t = dist.diff_all_to_all(t, group)
    return t.permute(1, 2, 0, 3, 4).reshape(b, s, n * hl, d)


def _ulysses_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group: Any, sp_size: int, causal: bool, sm_scale: float,
                   impl: str) -> torch.Tensor:
    """One rank's body (``ulysses.py:46``): sequence chunks in, the
    q-shaped output chunk out."""
    from torchbooster_tpu_torch.ops.attention import attention

    qh, kh, vh = (_seq_to_heads(t, group, sp_size) for t in (q, k, v))
    out = attention(qh, kh, vh, causal=causal, sm_scale=sm_scale, impl=impl)
    return _heads_to_seq(out, group, sp_size)


def _validate_heads(q: torch.Tensor, k: torch.Tensor) -> int:
    n_heads, kv_heads = q.shape[2], k.shape[2]
    if n_heads % kv_heads:
        raise ValueError(f"query heads ({n_heads}) not divisible by "
                         f"kv heads ({kv_heads})")
    return n_heads // kv_heads


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Any, causal: bool = True,
                      sm_scale: float | None = None, axis: str = "sp",
                      impl: str = "auto") -> torch.Tensor:
    """Exact attention over this rank's ``(B, S/sp, H, D)`` chunks
    (``ulysses.py:87``), the contract of ``parallel.ring.ring_attention``;
    the query and grouped k/v head counts must divide by ``sp``. ``impl``
    feeds the local attention dispatch (``"auto"``: the flash kernels on
    the card)."""
    *_, n_heads, head_dim = q.shape
    _validate_heads(q, k)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    sp_size = mesh.shape[axis]
    tp_size = mesh.shape.get("tp", 1)
    for name, heads in (("query", n_heads), ("kv", k.shape[2])):
        if heads % tp_size or (heads // tp_size) % sp_size:
            raise ValueError(
                f"ulysses_attention needs {name} heads ({heads}) "
                f"divisible by tp·sp ({tp_size}·{sp_size}); expand K/V "
                "first or use ring_attention")
    body = functools.partial(_ulysses_local, group=mesh.group((axis,)),
                             sp_size=sp_size, causal=causal,
                             sm_scale=sm_scale, impl=impl)
    return body(q, k, v)


def sequence_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mesh: Any, causal: bool = True,
                       sm_scale: float | None = None, axis: str = "sp",
                       strategy: str = "auto",
                       impl: str = "auto") -> torch.Tensor:
    """One front door for sequence-parallel attention
    (``ulysses.py:121``). ``strategy``: ``"ring"``, ``"ulysses"``, or
    ``"auto"`` (Ulysses whenever the query heads divide, the ring
    otherwise — and the ring when grouped K/V fit the ring but would
    need expanding for the all-to-alls). Grouped K/V that fit neither
    layout are expanded to the query heads first. ``impl`` feeds both
    strategies' local body."""
    from torchbooster_tpu_torch.parallel.ring import ring_attention

    rep = _validate_heads(q, k)
    n_heads, kv_heads = q.shape[2], k.shape[2]
    sp_size = mesh.shape[axis]
    tp_size = mesh.shape.get("tp", 1)

    def divides(heads: int, with_sp: bool) -> bool:
        return heads % tp_size == 0 and (
            not with_sp or (heads // tp_size) % sp_size == 0)

    if strategy == "auto":
        strategy = "ulysses" if divides(n_heads, True) else "ring"
        if (strategy == "ulysses" and rep > 1
                and not divides(kv_heads, True)
                and divides(kv_heads, False)):
            strategy = "ring"
    grouped_ok = (divides(kv_heads, strategy == "ulysses")
                  if rep > 1 else True)
    if rep > 1 and not grouped_ok:
        from torchbooster_tpu_torch.ops.attention import expand_kv_heads

        k, v = expand_kv_heads(k, rep), expand_kv_heads(v, rep)
    if strategy == "ulysses":
        return ulysses_attention(q, k, v, mesh, causal=causal,
                                 sm_scale=sm_scale, axis=axis, impl=impl)
    if strategy == "ring":
        return ring_attention(q, k, v, mesh, causal=causal,
                              sm_scale=sm_scale, axis=axis, impl=impl)
    raise ValueError(f"unknown sequence-parallel strategy {strategy!r}")


__all__ = ["sequence_attention", "ulysses_attention"]
