"""Ring attention: exact attention over a sequence-sharded (``sp``) axis
— the port of ``torchbooster_tpu/parallel/ring.py``.

The sequence axis of q/k/v is split over the mesh's ``sp`` axis: each
rank holds an ``S/sp`` chunk. K/V chunks rotate around the ring (a
:func:`~torchbooster_tpu_torch.distributed.ppermute` over the ``sp``
group) while each rank folds every visiting chunk into its queries'
online-softmax state. There is no ``shard_map``: a rank calls
:func:`ring_attention` on its own chunks.

Two per-chunk bodies (:func:`select_ring_body`):

- ``"reference"`` (:func:`_ring_local`): the blocked online softmax in
  plain PyTorch, each visiting chunk consumed in ``block_k``-wide
  slices, differentiated by autograd through the rotations
  (:func:`~torchbooster_tpu_torch.distributed.diff_ppermute`).
- ``"flash"`` (:class:`_RingFlash`): the flash kernels as the per-chunk
  body. Each step runs B1 on (this rank's queries × the visiting chunk),
  giving a normalized partial output and its lse, folded into a running
  ``(out, lse)`` (:func:`_rf_merge`). The diagonal chunk is peeled at
  ``t = 0`` and takes the causal kernel; wrapped-future chunks are
  skipped under ``causal``; K/V rotate before each step's kernels. The
  backward saves only ``(q, k, v, out, lse)`` and runs the ring again,
  feeding each chunk's B2/B3 the GLOBAL ``(out, lse)``: dQ sums on the
  rank, dK/dV rotate with their chunk and arrive home after the full
  cycle. Grouped K/V ride the ring un-expanded (the kernels index
  grouped rows). On CUDA tensors the kernels launch; on CPU tensors
  their plain versions run.

:func:`ring_fwd_step` and :func:`ring_bwd_step` are one rank's step of
that forward and backward, functions of (local q, the visiting K/V
chunk, its source rank): :class:`_RingFlash` composes them with the
``ppermute``; ``chip_smoke.py`` composes the same functions with an
in-process rotation over all ranks of a ring on one card.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch

from torchbooster_tpu_torch import distributed as dist

NEG_INF = -1e30


def _largest_divisor_block(s_loc: int, target: int) -> int:
    """Largest block size <= target that divides s_loc."""
    blk = min(target, s_loc)
    while s_loc % blk:
        blk -= 1
    return blk


def _ring_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                group: Any, sp_size: int, my: int, causal: bool,
                sm_scale: float, rep: int = 1,
                block_k: int = 512) -> torch.Tensor:
    """The reference body (``ring.py:41``): q ``(B, S_loc, H, D)`` and
    k/v ``(B, S_loc, H/rep, D)`` local chunks, ``my`` this rank's chunk.
    Grouped K/V circulate un-expanded (stacked, one rotation a step) and
    expand inside each block's products. Each visiting chunk folds
    through the online softmax in ``block_k``-wide slices. Autograd
    differentiates it, so a wrapped-future chunk under ``causal`` is
    folded fully masked — an exact identity on ``(m, l, acc)`` — where
    the JAX body skips it: every rank then builds the same graph, and
    its backward issues the rotations' transposes in the same order on
    every rank."""
    b, s_loc, h, d = q.shape
    blk = _largest_divisor_block(s_loc, block_k)
    dev = q.device
    qf = q.float() * sm_scale
    m = torch.full((b, h, s_loc), NEG_INF, device=dev)
    l = torch.zeros((b, h, s_loc), device=dev)
    acc = torch.zeros((b, s_loc, h, d), device=dev)
    iq = torch.arange(s_loc, device=dev)[:, None]
    ik = torch.arange(blk, device=dev)[None, :]
    kv_t = torch.stack([k, v])
    for t in range(sp_size):
        src = (my - t) % sp_size
        if t + 1 < sp_size:
            # the rotation comes before this chunk's math, on every rank
            # in the same order; ``ppermute`` waits for it, so nothing
            # overlaps
            kv_next = dist.diff_ppermute(kv_t, group)
        for j in range(s_loc // blk):
            k_blk, v_blk = kv_t[:, :, j * blk:(j + 1) * blk]
            if rep > 1:
                k_blk = k_blk.repeat_interleave(rep, dim=2)
                v_blk = v_blk.repeat_interleave(rep, dim=2)
            scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())
            if causal and src == my:
                # the diagonal chunk: the lower triangle against this
                # block's column offset
                mask = (iq >= ik + j * blk).expand(scores.shape)
            else:
                # an earlier chunk is visible whole, a later one not at all
                mask = torch.full_like(scores, not (causal and src > my),
                                       dtype=torch.bool)
            scores = torch.where(mask, scores,
                                 torch.full_like(scores, NEG_INF))
            m_cur = torch.maximum(m, scores.amax(dim=-1))
            corr = torch.exp(m - m_cur)
            # masked entries contribute exactly 0
            p = torch.exp(scores - m_cur[..., None]) * mask
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
            acc = acc * corr.transpose(1, 2)[..., None] + pv
            m = m_cur
        if t + 1 < sp_size:
            kv_t = kv_next
    out = acc / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


# =========================================================================
# Ring x flash: B1-B3 as the per-chunk body
# =========================================================================

def _rf_merge(out: torch.Tensor, lse: torch.Tensor, out_c: torch.Tensor,
              lse_c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a chunk's normalized output and lse into the running pair
    (``ring.py:168``). Both lse's are finite: the pair starts from the
    always-visited diagonal chunk and fully masked chunks are skipped."""
    m = torch.maximum(lse, lse_c)
    w = torch.exp(lse - m)
    w_c = torch.exp(lse_c - m)
    denom = w + w_c
    return (out * (w / denom)[..., None]
            + out_c.float() * (w_c / denom)[..., None],
            m + torch.log(denom))


def ring_fwd_step(q: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor,
                  *, src: int, my: int, causal: bool, sm_scale: float,
                  carry: tuple | None = None) -> tuple | None:
    """One rank's forward step against the visiting chunk of rank
    ``src``: q ``(BH, S_loc, D)``, k_t/v_t ``(BH_kv, S_loc, D)``. Runs B1
    causal on the diagonal chunk (``src == my``), non-causal on a
    visible one, nothing on a wrapped-future one under ``causal``, and
    folds the result into ``carry`` — the running ``(out fp32, lse)``,
    None before the first step. Returns the new carry."""
    from torchbooster_tpu_torch.ops.flash_attention import flash_forward

    if causal and src > my:
        return carry
    o, lse = flash_forward(q, k_t, v_t, causal=causal and src == my,
                           sm_scale=sm_scale)
    if carry is None:
        return o.float(), lse
    return _rf_merge(*carry, o, lse)


def ring_bwd_step(q: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  *, src: int, my: int, causal: bool, sm_scale: float,
                  dq: torch.Tensor | None = None,
                  dk: torch.Tensor | None = None,
                  dv: torch.Tensor | None = None) -> tuple:
    """One rank's backward step against the visiting chunk of rank
    ``src``: B2/B3 fed the GLOBAL ``out`` (q's dtype) and ``lse``, the
    flavor and skip of :func:`ring_fwd_step`. ``dq`` is this rank's fp32
    accumulator, ``dk``/``dv`` the accumulators travelling with the
    visiting chunk (None: start from this step's). Returns ``(dq, dk,
    dv)``."""
    from torchbooster_tpu_torch.ops.flash_attention import flash_backward

    if causal and src > my:
        return dq, dk, dv
    dq_c, dk_c, dv_c = flash_backward(q, k_t, v_t, out, lse, do,
                                      causal=causal and src == my,
                                      sm_scale=sm_scale)
    add = lambda acc, c: c.float() if acc is None else acc + c.float()
    return add(dq, dq_c), add(dk, dk_c), add(dv, dv_c)


class _RingFlash(torch.autograd.Function):
    """The ring-flash body (JAX ``_ring_flash`` ``custom_vjp``): forward
    and backward each one pass around the ring of the ``sp`` group."""

    @staticmethod
    def forward(ctx, qf, kf, vf, group, sp_size, my, causal, sm_scale):
        qf, kf, vf = qf.contiguous(), kf.contiguous(), vf.contiguous()
        step = functools.partial(ring_fwd_step, qf, my=my, causal=causal,
                                 sm_scale=sm_scale)
        k_t, v_t, carry = kf, vf, None
        for t in range(sp_size):
            # rotate, then fold: the order keeps every rank's collectives
            # in step (``ppermute`` waits; nothing overlaps)
            if t + 1 < sp_size:
                k_next = dist.ppermute(k_t, group)
                v_next = dist.ppermute(v_t, group)
            carry = step(k_t, v_t, src=(my - t) % sp_size, carry=carry)
            if t + 1 < sp_size:
                k_t, v_t = k_next, v_next
        out = carry[0].to(qf.dtype)
        ctx.save_for_backward(qf, kf, vf, out, carry[1])
        ctx.args = (group, sp_size, my, causal, sm_scale)
        return out

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, out, lse = ctx.saved_tensors
        group, sp_size, my, causal, sm_scale = ctx.args
        step = functools.partial(ring_bwd_step, qf, out=out, lse=lse,
                                 do=do.contiguous(), my=my, causal=causal,
                                 sm_scale=sm_scale)
        k_t, v_t = kf, vf
        dq = dk = dv = None
        for t in range(sp_size):
            if t + 1 < sp_size:
                k_next = dist.ppermute(k_t, group)
                v_next = dist.ppermute(v_t, group)
            dq, dk, dv = step(k_t, v_t, src=(my - t) % sp_size, dq=dq,
                              dk=dk, dv=dv)
            # the gradients travel with their chunk: after sp_size
            # rotations each is home, every rank's share added
            dk, dv = dist.ppermute(dk, group), dist.ppermute(dv, group)
            if t + 1 < sp_size:
                k_t, v_t = k_next, v_next
        return (dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype),
                None, None, None, None, None)


def _ring_flash_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, group: Any, sp_size: int, my: int, causal: bool,
                      sm_scale: float) -> torch.Tensor:
    """Fold heads into rows (group-contiguous, the flash kernels' GQA
    convention: grouped K/V fold at their own width and row ``b`` of q
    reads row ``b // rep``), run the ring, unfold."""
    b, s_loc, h, d = q.shape
    h_kv = k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, s_loc, d)
    kf = k.transpose(1, 2).reshape(b * h_kv, s_loc, d)
    vf = v.transpose(1, 2).reshape(b * h_kv, s_loc, d)
    out = _RingFlash.apply(qf, kf, vf, group, sp_size, my, causal,
                           float(sm_scale))
    return out.reshape(b, h, s_loc, d).transpose(1, 2)


def select_ring_body(impl: str, *, s_loc: int, sp_size: int, my: int,
                     group: Any, causal: bool, sm_scale: float,
                     rep: int = 1, block_k: int = 512,
                     device: str | torch.device = "cpu",
                     head_dim: int | None = None,
                     dtype: torch.dtype | None = None):
    """THE ring body-selection policy (``ring.py:371``): ``"auto"`` takes
    the flash body on the card when the local chunk tiles (and the
    kernels are built for the head dim and dtype), the reference body
    otherwise, as the JAX package does on the TPU; ``"flash"`` forces the
    kernel body (its plain versions on CPU tensors); unknown names raise.
    Returns a per-rank ``fn(q, k, v)``."""
    if impl == "auto":
        from torchbooster_tpu_torch.ops.attention import flash_auto_engaged

        impl = "flash" if flash_auto_engaged(s_loc, s_loc, device, head_dim,
                                             dtype) else "reference"
    if impl == "flash":
        return functools.partial(_ring_flash_local, group=group,
                                 sp_size=sp_size, my=my, causal=causal,
                                 sm_scale=sm_scale)
    if impl == "reference":
        return functools.partial(_ring_local, group=group, sp_size=sp_size,
                                 my=my, causal=causal, sm_scale=sm_scale,
                                 rep=rep, block_k=block_k)
    raise ValueError(f"unknown ring impl {impl!r}")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Any, causal: bool = True,
                   sm_scale: float | None = None, axis: str = "sp",
                   block_k: int = 512, impl: str = "auto") -> torch.Tensor:
    """Exact attention over this rank's ``(B, S/sp, H, D)`` chunks of a
    sequence split over ``axis`` of ``mesh`` (``ring.py:321``); returns
    this rank's chunk of the output. K/V may carry fewer (grouped) heads
    than q. ``block_k`` bounds the reference body's slice width.
    ``impl``: ``"auto"``, ``"flash"`` or ``"reference"``
    (:func:`select_ring_body`)."""
    *_, n_heads, head_dim = q.shape
    kv_heads = k.shape[2]
    if n_heads % kv_heads:
        raise ValueError(f"query heads ({n_heads}) not divisible by "
                         f"kv heads ({kv_heads})")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    sp_size = mesh.shape[axis]
    tp_size = mesh.shape.get("tp", 1)
    if kv_heads % tp_size:
        raise ValueError(
            f"ring_attention: kv heads ({kv_heads}) not divisible by "
            f"tp ({tp_size}); expand K/V to the query head count first")
    body = select_ring_body(
        impl, s_loc=q.shape[1], sp_size=sp_size,
        my=mesh.coords().get(axis, 0), group=mesh.group((axis,)),
        causal=causal, sm_scale=sm_scale, rep=n_heads // kv_heads,
        block_k=block_k, device=q.device, head_dim=head_dim,
        dtype=q.dtype)
    return body(q, k, v)


__all__ = ["ring_attention", "ring_bwd_step", "ring_fwd_step",
           "select_ring_body"]
