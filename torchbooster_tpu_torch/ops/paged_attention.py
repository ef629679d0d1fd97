"""Paged flash-decode attention over the serving page pool — the port
of ``torchbooster_tpu/ops/paged_attention.py`` (TPU kernel
``_paged_kernel``, :70).

:func:`paged_attention` launches a hand-written CUDA kernel on CUDA
tensors (two passes: per-(work entry, kv head) partials, then a
per-(slot, head) merge), and runs :func:`paged_attention_reference` —
the same math in plain PyTorch — only on CPU tensors. It has two
routes, planned before launch by :func:`plan_paged`: ``"sm90"``
(``csrc/paged_decode_sm90.cu``: bf16 queries over a bf16 or int8 pool at
head dim 32, 48, 64 or 128, TMA-copied page tiles, tensor-core products,
a parallel merge) and
``"simt"`` (``csrc/paged_attention.cu``: CUDA cores, every dtype and
shape the wrapper takes). ``route=`` forces one; a route that cannot
take the operands raises. There is no fall-back: a failed build or
launch raises. ``launches`` counts kernel launches (pairs of passes),
``launches_by_route`` the same by route; the plain path touches
neither. Under a CUDA-graph capture (``_graphs.py``) the wrapper runs
but nothing launches: it counts into the tally of the capture open on
its stream (``launch_tally.capture_tally``, which every kernel family
shares), never into the counters, and each replay of the graph
adds that tally (and counts it in ``launches_replayed`` too), so the
counters follow what the card ran, whatever other threads launch
meanwhile.

Operands are exactly the TPU kernel's: ``q (slots, S, H, Dh)`` with
``S ∈ {1, 1 + draft_len}``, one layer's pool ``(n_pages, page_size,
kv_heads, Dh)`` — a plain bf16/fp32 tensor or an ``(int8 values, bf16
scales (..., 1))`` pair — the compacted live-page walk ``work_pages
(W,)``, ``work_refs (W, lanes)``, ``work_pos (W,)`` from
``BlockTables.kernel_args()``, ``lengths (slots,)`` and an optional
``tree_vis (slots, S, S)``. Returns ``(slots, S, H, Dh)`` in
``q.dtype``; rows of slots no work entry references are zeros here and
garbage in the TPU kernel — callers ignore them. Live entries come
first in the walk (``kernel_args`` puts them there): the ``"sm90"``
kernel ends its walk at the first entry whose lanes are all empty.
"""
from __future__ import annotations

import ctypes
import math

import torch

from torchbooster_tpu_torch.ops import launch_tally
from torchbooster_tpu_torch.ops.attention import NEG_INF

launches = 0    # CUDA kernel launches (the main path's proof of route)
# launches by the route plan_paged chose (or the caller forced)
launches_by_route = {"sm90": 0, "simt": 0}
# the part of launches_by_route that CUDA-graph replays ran
launches_replayed = {"sm90": 0, "simt": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_SMEM = 232_448         # bytes of shared memory a CTA may use on sm_90
# what the "sm90" kernel takes (csrc/paged_decode_sm90.cu checks the same)
SM90_HEAD_DIMS = (32, 48, 64, 128)
SM90_MAX_PAGE = 128         # two ring slots of K/V at Dh 128 + 64 q rows fit
SM90_MAX_ROWS = 64          # query rows per kv head, rep x S


def plan_paged(q_dtype: torch.dtype, kv_dtype: torch.dtype, head_dim: int,
               page_size: int, s_q: int, rep: int) -> str:
    """The route of a B4 launch on the card, chosen before launch:
    ``"sm90"`` (``csrc/paged_decode_sm90.cu``) for bf16 queries over a
    bf16 pool or an int8 pool (bf16 scales), head dim 32, 48, 64 or 128
    (at 48 the kernel's tile rows are 64 columns wide, the last 16 the
    TMA's zero fill), a page size that is a multiple of 16 from 16 to 128 (the largest
    whose two-slot ring of K/V tiles fits beside 64 query rows at head
    dim 128) and at most 64 query rows (``rep * s_q``) per kv head;
    ``"simt"`` (``csrc/paged_attention.cu``) for everything else — fp32
    queries (so the fp32 serving path stays exact to 1e-4), fp32 pools,
    other head dims and page sizes."""
    if (q_dtype == torch.bfloat16
            and kv_dtype in (torch.bfloat16, torch.int8)
            and head_dim in SM90_HEAD_DIMS
            and page_size % 16 == 0 and 16 <= page_size <= SM90_MAX_PAGE
            and rep >= 1 and s_q >= 1 and rep * s_q <= SM90_MAX_ROWS):
        return "sm90"
    return "simt"


def _count_launch(route: str) -> None:
    """One launch on ``route`` (``launch_tally.count``: into the tally of
    the current stream's capture, if the stream is being captured, else
    into the counters; ``launches_replayed`` counts it on each replay
    only)."""
    launch_tally.count(__name__, ("launches", None),
                       ("launches_by_route", route),
                       replayed=(("launches_replayed", route),))


def _simt_limits(head_dim: int, page_size: int, s_q: int) -> None:
    """Raise where the ``"simt"`` kernel cannot take the operands."""
    if page_size > 1024 or s_q > 32 or head_dim > 256:
        raise ValueError(
            f"paged_attention simt kernel takes page_size <= 1024, S <= 32 "
            f"and head_dim <= 256 (got page_size={page_size}, S={s_q}, "
            f"head_dim={head_dim})")
    smem = 4 * (page_size * (2 * head_dim + 1) + 4 * head_dim
                + 4 * page_size)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged_attention: a {page_size}-token page at "
                         f"head_dim {head_dim} needs {smem} B of shared "
                         f"memory, over the card's {_MAX_SMEM}")


def check_paged(q_dtype: torch.dtype, kv_dtype: torch.dtype, head_dim: int,
                page_size: int, s_q: int, rep: int) -> str:
    """The route a launch with these operands takes (:func:`plan_paged`),
    or ``ValueError`` naming the limit when no route takes them — for
    callers that fix the shape up front (the serving engine checks its
    decode and verify steps at construction)."""
    route = plan_paged(q_dtype, kv_dtype, head_dim, page_size, s_q, rep)
    if route == "simt":
        _simt_limits(head_dim, page_size, s_q)
    return route


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


def _bind(lib: ctypes.CDLL, name: str, n_codes: int, n_ints: int):
    """``name`` with its argument types: ``n_codes`` dtype codes, 14
    pointers, ``n_ints`` ints, the scale and the stream."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i] * n_codes + [p] * 14 + [i] * n_ints
                       + [ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def _route_for(route: str | None, planned: str) -> str:
    """The launch's route: the plan's, or ``route`` when the caller
    names one; a route that cannot take the operands raises before any
    launch (the kernel checks pointer alignment itself and returns an
    error code, which raises below)."""
    route = planned if route is None else route
    if route not in launches_by_route:
        raise ValueError(f"paged_attention: unknown route {route!r} "
                         f"(routes {sorted(launches_by_route)})")
    if route == "sm90" and planned != "sm90":
        raise ValueError("paged_attention: route 'sm90' does not take "
                         "these operands (planned 'simt')")
    return route


def paged_attention(q: torch.Tensor, pool_k, pool_v, work_pages, work_refs,
                    work_pos, lengths, *, page_size: int,
                    sm_scale: float | None = None,
                    tree_vis=None, route: str | None = None) -> torch.Tensor:
    """Paged flash-decode attention: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors (see the module docstring).
    ``route`` (``"sm90"`` or ``"simt"``) forces a kernel; by default
    :func:`plan_paged` picks it. On CPU tensors a named route is checked
    against the plan the same way, and the plain version runs."""
    if q.device.type == "cpu":
        if route is not None:
            kv = pool_k[0] if isinstance(pool_k, tuple) else pool_k
            _route_for(route, plan_paged(
                q.dtype, kv.dtype, q.shape[3], page_size, q.shape[1],
                q.shape[2] // kv.shape[2]))
        return paged_attention_reference(
            q, pool_k, pool_v, work_pages, work_refs, work_pos, lengths,
            page_size=page_size, sm_scale=sm_scale, tree_vis=tree_vis)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
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
    route = _route_for(route, plan_paged(q.dtype, kv.dtype, head_dim,
                                         page_size, s_q, n_heads // kv_heads))
    if route == "simt":
        _simt_limits(head_dim, page_size, s_q)
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
    # the sm90 kernel also takes the pool's page count (its tensor maps)
    if route == "sm90":
        fn = _bind(_build.load("paged_decode_sm90"),
                   "tb_paged_attention_sm90", 1, 9)
        codes, pages = (_DTYPE_CODE[kv.dtype],), (n_pages,)
    else:
        fn = _bind(_build.load("paged_attention"), "tb_paged_attention", 2, 8)
        codes, pages = (_DTYPE_CODE[q.dtype], _DTYPE_CODE[kv.dtype]), ()
    err = fn(*codes, _ptr(q), _ptr(kv), _ptr(kv_v), _ptr(scales[0]),
             _ptr(scales[1]), _ptr(wp), _ptr(wr), _ptr(wpos), _ptr(ln),
             _ptr(tv), _ptr(out), _ptr(o_part), _ptr(m_part), _ptr(l_part),
             n_slots, s_q, n_heads, kv_heads, head_dim, page_size, *pages,
             n_w, n_lanes, float(sm_scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"({route}): CUDA error {err}")
    _count_launch(route)
    return out


__all__ = ["SM90_HEAD_DIMS", "SM90_MAX_PAGE", "SM90_MAX_ROWS",
           "check_paged", "launches",
           "launches_by_route", "launches_replayed", "paged_attention",
           "paged_attention_reference", "plan_paged"]
