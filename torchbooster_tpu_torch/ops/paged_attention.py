"""Paged flash-decode attention over the serving page pool — the port
of ``torchbooster_tpu/ops/paged_attention.py`` (TPU kernel
``_paged_kernel``, :70).

:func:`paged_attention` launches the hand-written CUDA kernel
(``csrc/paged_attention.cu``, two passes: per-(work entry, kv head)
partials, then a per-(slot, head) merge) on CUDA tensors, and runs
:func:`paged_attention_reference` — the same math in plain PyTorch —
only on CPU tensors. There is no fall-back: a failed build or launch
raises. ``launches`` counts kernel launches (pairs of passes); the
plain path never touches it.

Operands are exactly the TPU kernel's: ``q (slots, S, H, Dh)`` with
``S ∈ {1, 1 + draft_len}``, one layer's pool ``(n_pages, page_size,
kv_heads, Dh)`` — a plain bf16/fp32 tensor or an ``(int8 values, bf16
scales (..., 1))`` pair — the compacted live-page walk ``work_pages
(W,)``, ``work_refs (W, lanes)``, ``work_pos (W,)`` from
``BlockTables.kernel_args()``, ``lengths (slots,)`` and an optional
``tree_vis (slots, S, S)``. Returns ``(slots, S, H, Dh)`` in
``q.dtype``; rows of slots no work entry references are zeros here and
garbage in the TPU kernel — callers ignore them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from torchbooster_tpu_torch.ops.attention import NEG_INF

launches = 0    # CUDA kernel launches (the main path's proof of route)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_SMEM = 232_448         # bytes of shared memory a CTA may use on sm_90


def paged_attention_reference(q, pool_k, pool_v, work_pages, work_refs,
                              work_pos, lengths, *, page_size: int,
                              sm_scale: float | None = None,
                              tree_vis=None) -> torch.Tensor:
    """The kernel's math in plain PyTorch: per-(entry, lane) partials
    ``(o, m, l)`` with the probabilities gated by the visibility mask,
    merged per slot with the online-softmax combine. ``sm_scale``
    multiplies q before the dot, as the kernel does."""
    n_slots, s_q, n_heads, head_dim = q.shape
    quantized = isinstance(pool_k, tuple)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    dev = q.device
    wp, wr, wpos = (t.to(dev).long() for t in (work_pages, work_refs,
                                                work_pos))
    lengths = lengths.to(dev).long()
    if quantized:
        k = pool_k[0][wp].float() * pool_k[1][wp].float()
        v = pool_v[0][wp].float() * pool_v[1][wp].float()
    else:
        k, v = pool_k[wp].float(), pool_v[wp].float()
    rep = n_heads // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)                 # (W, ps, H, Dh)
    v = v.repeat_interleave(rep, dim=2)
    valid = wr >= 0                                     # (W, R)
    slot = wr.clamp(0, n_slots - 1)
    qe = q.float()[slot] * sm_scale                     # (W, R, S, H, Dh)
    scores = torch.einsum("wrshd,wthd->wrhst", qe, k)   # (W, R, H, S, ps)
    tok = wpos[:, None] * page_size + torch.arange(page_size, device=dev)
    tok = tok[:, None, None, :]                         # (W, 1, 1, ps)
    length = lengths[slot][:, :, None, None]            # (W, R, 1, 1)
    j = torch.arange(s_q, device=dev)[None, None, :, None]
    if tree_vis is None:
        visible = tok <= length + j                     # (W, R, S, ps)
    else:
        off = tok - length
        tv = tree_vis.to(dev)[slot].bool()              # (W, R, S, S)
        anc = torch.gather(
            tv, 3, off.clamp(0, s_q - 1).expand(-1, -1, s_q, -1))
        visible = (off <= 0) | ((off > 0) & (off < s_q) & anc)
    visible = (visible & valid[:, :, None, None])[:, :, None]  # (W,R,1,S,ps)
    scores = torch.where(visible, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)                             # (W, R, H, S)
    p = torch.where(visible, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    l = p.sum(dim=-1)
    o = torch.einsum("wrhst,wthd->wrhsd", p, v)
    seg = torch.where(valid, wr, n_slots).reshape(-1)   # (W*R,)
    m_f, l_f = m.reshape(-1, n_heads, s_q), l.reshape(-1, n_heads, s_q)
    o_f = o.reshape(-1, n_heads, s_q, head_dim)
    m_s = torch.full((n_slots + 1, n_heads, s_q), NEG_INF, device=dev)
    m_s = m_s.scatter_reduce(0, seg[:, None, None].expand_as(m_f), m_f,
                             reduce="amax")
    wgt = torch.exp(m_f - m_s[seg])
    l_s = torch.zeros_like(m_s).index_add(0, seg, l_f * wgt)
    o_s = torch.zeros(n_slots + 1, n_heads, s_q, head_dim,
                      device=dev).index_add(0, seg, o_f * wgt[..., None])
    out = o_s[:n_slots] / l_s[:n_slots].clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _bind(lib: ctypes.CDLL):
    fn = lib.tb_paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i] + [p] * 14 + [i] * 8 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention(q: torch.Tensor, pool_k, pool_v, work_pages, work_refs,
                    work_pos, lengths, *, page_size: int,
                    sm_scale: float | None = None,
                    tree_vis=None) -> torch.Tensor:
    """Paged flash-decode attention: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors (see the module docstring)."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, pool_k, pool_v, work_pages, work_refs, work_pos, lengths,
            page_size=page_size, sm_scale=sm_scale, tree_vis=tree_vis)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    global launches
    from torchbooster_tpu_torch.ops import _build

    q = q.contiguous()     # the qkv split leaves a strided view
    n_slots, s_q, n_heads, head_dim = q.shape
    quantized = isinstance(pool_k, tuple)
    kv, kv_v = (pool_k[0], pool_v[0]) if quantized else (pool_k, pool_v)
    scales = (pool_k[1], pool_v[1]) if quantized else (None, None)
    n_pages, ps, kv_heads, hd = kv.shape
    if ps != page_size or hd != head_dim or n_heads % kv_heads:
        raise ValueError(
            f"paged_attention: pool {tuple(kv.shape)} does not match q "
            f"{tuple(q.shape)} with page_size={page_size}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or kv.dtype not in _DTYPE_CODE \
            or (kv.dtype == torch.int8) != quantized:
        raise TypeError(f"paged_attention: q {q.dtype} / pool {kv.dtype} "
                        "not supported (q fp32|bf16; pool fp32|bf16 or "
                        "int8 with bf16 scales)")
    if page_size > 1024 or s_q > 32 or head_dim > 256:
        raise ValueError("paged_attention kernel takes page_size <= 1024, "
                         "S <= 32 and head_dim <= 256")
    smem = 4 * (page_size * (2 * head_dim + 1) + 4 * head_dim
                + 4 * page_size)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged_attention: a {page_size}-token page at "
                         f"head_dim {head_dim} needs {smem} B of shared "
                         f"memory, over the card's {_MAX_SMEM}")
    tensors = [q, kv, kv_v, *(s for s in scales if s is not None)]
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged_attention: every operand must be a "
                             "contiguous tensor on q's device")
    if quantized and (scales[0].dtype != torch.bfloat16
                      or scales[0].shape != (*kv.shape[:3], 1)):
        raise TypeError("paged_attention: int8 pools carry bf16 scales "
                        "of shape (..., 1)")
    as_i32 = lambda t: torch.as_tensor(t).to(
        device=q.device, dtype=torch.int32).contiguous()
    wp, wr, wpos, ln = (as_i32(t) for t in (work_pages, work_refs,
                                            work_pos, lengths))
    tv = as_i32(tree_vis) if tree_vis is not None else None
    n_w, n_lanes = wr.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    out = torch.empty_like(q)
    o_part = torch.empty((n_w, n_lanes, n_heads, s_q, head_dim),
                         dtype=torch.float32, device=q.device)
    m_part = torch.empty((n_w, n_lanes, n_heads, s_q), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    fn = _bind(_build.load("paged_attention"))
    err = fn(_DTYPE_CODE[q.dtype], _DTYPE_CODE[kv.dtype], _ptr(q), _ptr(kv),
             _ptr(kv_v), _ptr(scales[0]), _ptr(scales[1]), _ptr(wp),
             _ptr(wr), _ptr(wpos), _ptr(ln), _ptr(tv), _ptr(out),
             _ptr(o_part), _ptr(m_part), _ptr(l_part), n_slots, s_q,
             n_heads, kv_heads, head_dim, page_size, n_w, n_lanes,
             float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


__all__ = ["launches", "paged_attention", "paged_attention_reference"]
