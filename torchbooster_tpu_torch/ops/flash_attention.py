"""Flash attention, forward and backward — the port of
``torchbooster_tpu/ops/flash_attention.py`` (TPU kernels ``_fwd_kernel``
:104, ``_dq_kernel`` :227 and ``_dkv_kernel`` :265, bound together by the
``custom_vjp`` at :377-399).

:func:`flash_attention` is differentiable through a
``torch.autograd.Function``: its forward launches B1 and its backward
launches B2 then B3, hand-written CUDA kernels (``csrc/flash_attention.cu``
and, for the bf16 ``"sm90"`` routes, ``csrc/flash_fwd_sm90.cu`` and
``csrc/flash_bwd_sm90.cu``), on CUDA tensors. On CPU tensors it runs
:func:`flash_attention_reference` and
:func:`flash_attention_backward_reference` — the same math in plain
PyTorch, blocked exactly like the TPU kernels — and only there. There is
no fall-back: a failed build or launch raises. ``launches_fwd``,
``launches_dq`` and ``launches_dkv`` count kernel launches; the plain
path never touches them. Under a CUDA-graph capture the launches go to
the capture's tally and each replay adds them (``launch_tally.py``).

The forward and the backward each have three CUDA routes, planned before
launch by :func:`plan_flash_fwd` and :func:`plan_flash_bwd` and counted
in ``launches_fwd_by_route``, ``launches_dq_by_route`` and
``launches_dkv_by_route``: ``"sm90"`` (bf16 at head dim 48, 64 or 128
with ``1 <= S_q <= S_kv``, the ``wgmma`` kernels of
``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_bwd_sm90.cu``),
``"mma_sync"`` (other bf16 shapes, D 32 and S_q > S_kv among them: the
``mma.sync`` kernels of ``csrc/flash_attention.cu``) and ``"f32"`` (fp32,
CUDA-core kernels of the same file). The two plans agree on every
shape at a positive ``sm_scale``; at ``sm_scale <= 0`` the forward plans
``"mma_sync"`` (which scales before it masks) and the backward stays on
``"sm90"``, whose kernels scale before they mask too.

Shape contract (the TPU kernels'): q ``(BH, S_q, D)``, k/v ``(BH_kv,
S_kv, D)`` with ``BH % BH_kv == 0``; q row ``b`` reads grouped k/v row
``b // rep`` (GQA), and dK/dV come back at grouped width. Causal rows
align to the LAST keys: query ``i`` sees keys ``[0, i + S_kv - S_q]``.

``block_q``/``block_k`` decide, as on the TPU, which lengths are
tileable (:func:`tileable`; an untileable length raises ``ValueError``)
and the blocking of the plain version. The CUDA kernels tile by their
own constants (64 rows; 128 and 64 on the ``"sm90"`` route) and mask a
ragged last tile. The JAX package's
``TB_FLASH_BLOCK_*`` environment defaults tune TPU tiles and are not
carried over.
"""
from __future__ import annotations

import ctypes
import math

import torch

from torchbooster_tpu_torch.ops import launch_tally
from torchbooster_tpu_torch.ops.attention import NEG_INF

MIN_BLOCK = 8          # the TPU kernel's smallest tile edge
DEFAULT_BLOCK = 1024   # the JAX package's default tile (both axes)
HEAD_DIMS = (32, 48, 64, 128)   # head dims the CUDA kernels are built for
SM90_HEAD_DIMS = (48, 64, 128)  # head dims of B1's "sm90" route
SM90_BWD_HEAD_DIMS = SM90_HEAD_DIMS  # and of B2/B3's
_SM90_MAX_S = 65535 * 64    # at most 65535 64-row tiles along grid.y

launches_fwd = 0    # B1 launches (the main path's proof of route)
launches_dq = 0     # B2 launches, every route
launches_dkv = 0    # B3 launches, every route
# B1 launches by the route plan_flash_fwd chose, B2 / B3 by plan_flash_bwd's
launches_fwd_by_route = {"sm90": 0, "mma_sync": 0, "f32": 0}
launches_dq_by_route = {"sm90": 0, "mma_sync": 0, "f32": 0}
launches_dkv_by_route = {"sm90": 0, "mma_sync": 0, "f32": 0}
# B1 launches by mask: the ring folds causal diagonal chunks and
# non-causal visiting ones
launches_fwd_by_mask = {"causal": 0, "full": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_DTYPES = tuple(_DTYPE_CODE)   # dtypes the CUDA kernels are built for


def _pick_block(block: int, seq: int, name: str) -> int:
    """Shrink ``block`` by halving until it divides ``seq``, stopping at
    ``MIN_BLOCK``: an untileable length is an explicit error."""
    block = min(block, seq)
    while seq % block and block > MIN_BLOCK:
        block //= 2
    if seq % block:
        raise ValueError(
            f"cannot tile {name}={seq}: no power-of-two block >= "
            f"{MIN_BLOCK} divides it; pad the sequence or pass an "
            f"explicit block size that divides it")
    return block


def tileable(seq: int, block: int | None = None) -> bool:
    """True when :func:`flash_attention` can tile ``seq`` — the predicate
    the ``"auto"`` dispatcher checks (it delegates to :func:`_pick_block`
    so the two cannot drift)."""
    try:
        _pick_block(DEFAULT_BLOCK if block is None else block, seq, "seq")
        return True
    except ValueError:
        return False


def _visible(i: int, j: int, block_q: int, block_k: int, offset: int,
             causal: bool) -> bool:
    """Does any key of kv block ``j`` face any query of q block ``i``?"""
    return not causal or (i + 1) * block_q + offset > j * block_k


def _recompute_p(qs, kj, lse_i, i, j, block_q, block_k, offset, causal):
    """Probabilities of one (q block, kv block) pair from the saved lse,
    masked with ``NEG_INF`` BEFORE the exp (``_recompute_p`` :211)."""
    scores = qs @ kj.transpose(1, 2)
    if causal:
        scores = _mask(scores, i, j, block_q, block_k, offset)
    return torch.exp(scores - lse_i[..., None])


def _mask(scores, i, j, block_q, block_k, offset):
    dev = scores.device
    q_pos = i * block_q + offset + torch.arange(block_q, device=dev)[:, None]
    k_pos = j * block_k + torch.arange(block_k, device=dev)[None, :]
    return torch.where(q_pos >= k_pos, scores,
                       torch.full_like(scores, NEG_INF))


def _expand(t: torch.Tensor, rep: int) -> torch.Tensor:
    """Grouped rows → query rows: row ``b`` reads grouped row ``b // rep``."""
    return t.float().repeat_interleave(rep, dim=0)


def flash_attention_reference(q, k, v, causal: bool = True,
                              sm_scale: float | None = None,
                              block_q: int = DEFAULT_BLOCK,
                              block_k: int = DEFAULT_BLOCK):
    """B1's math in plain PyTorch, blocked like ``_fwd_kernel``: per q
    block, an fp32 online softmax over the visible kv blocks. Returns
    ``(o, lse)`` — o in q's dtype, lse fp32 ``(BH, S_q)``."""
    bh, s_q, head_dim = q.shape
    s_kv = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    block_q = _pick_block(block_q, s_q, "seq_q")
    block_k = _pick_block(block_k, s_kv, "seq_kv")
    rep = bh // k.shape[0]
    kf, vf = _expand(k, rep), _expand(v, rep)
    offset = s_kv - s_q
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    for i in range(s_q // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        qs = q[:, rows].float() * sm_scale
        m = torch.full((bh, block_q), NEG_INF, device=q.device)
        l = torch.zeros((bh, block_q), device=q.device)
        acc = torch.zeros((bh, block_q, head_dim), device=q.device)
        for j in range(s_kv // block_k):
            if not _visible(i, j, block_q, block_k, offset, causal):
                continue
            cols = slice(j * block_k, (j + 1) * block_k)
            scores = qs @ kf[:, cols].transpose(1, 2)
            if causal:
                scores = _mask(scores, i, j, block_q, block_k, offset)
            m_cur = torch.maximum(m, scores.amax(dim=-1))
            corr = torch.exp(m - m_cur)
            p = torch.exp(scores - m_cur[..., None])
            l = l * corr + p.sum(dim=-1)
            m = m_cur
            acc = acc * corr[..., None] + p @ vf[:, cols]
        o[:, rows] = (acc / l[..., None]).to(q.dtype)
        lse[:, rows] = m + torch.log(l)
    return o, lse


def _backward_setup(q, k, v, o, do, sm_scale, block_q, block_k):
    bh, s_q, head_dim = q.shape
    s_kv = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    block_q = _pick_block(block_q, s_q, "seq_q")
    block_k = _pick_block(block_k, s_kv, "seq_kv")
    rep = bh // k.shape[0]
    of, dof = o.float(), do.float()
    return dict(sm_scale=sm_scale, block_q=block_q, block_k=block_k,
                kf=_expand(k, rep), vf=_expand(v, rep), qf=q.float(),
                dof=dof, delta=(of * dof).sum(dim=-1), offset=s_kv - s_q,
                n_q=s_q // block_q, n_kv=s_kv // block_k)


def dq_reference(q, k, v, o, lse, do, causal: bool = True,
                 sm_scale: float | None = None,
                 block_q: int = DEFAULT_BLOCK,
                 block_k: int = DEFAULT_BLOCK) -> torch.Tensor:
    """B2's math in plain PyTorch, blocked like ``_dq_kernel``: per q
    block, P recomputed from lse, delta = rowsum(dO∘O), dQ += scale·dS·K
    with dS = P∘(dO·Vᵀ − delta). Returns dq in q's dtype."""
    c = _backward_setup(q, k, v, o, do, sm_scale, block_q, block_k)
    bq, bk, scale = c["block_q"], c["block_k"], c["sm_scale"]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for i in range(c["n_q"]):
        rows = slice(i * bq, (i + 1) * bq)
        qs, do_i = c["qf"][:, rows] * scale, c["dof"][:, rows]
        acc = torch.zeros(qs.shape, device=q.device)
        for j in range(c["n_kv"]):
            if not _visible(i, j, bq, bk, c["offset"], causal):
                continue
            cols = slice(j * bk, (j + 1) * bk)
            kj, vj = c["kf"][:, cols], c["vf"][:, cols]
            p = _recompute_p(qs, kj, lse[:, rows], i, j, bq, bk,
                             c["offset"], causal)
            ds = p * (do_i @ vj.transpose(1, 2) - c["delta"][:, rows, None])
            acc = acc + scale * (ds @ kj)
        dq[:, rows] = acc
    return dq.to(q.dtype)


def dkv_reference(q, k, v, o, lse, do, causal: bool = True,
                  sm_scale: float | None = None,
                  block_q: int = DEFAULT_BLOCK,
                  block_k: int = DEFAULT_BLOCK):
    """B3's math in plain PyTorch, blocked like ``_dkv_kernel``: per kv
    block, dV += Pᵀ·dO and dK += scale·dSᵀ·Q over every visible q block,
    the group's query heads summed into grouped rows. Returns ``(dk,
    dv)`` in the dtypes of k and v."""
    c = _backward_setup(q, k, v, o, do, sm_scale, block_q, block_k)
    bq, bk, scale = c["block_q"], c["block_k"], c["sm_scale"]
    bh, s_kv, head_dim = c["kf"].shape
    dk = torch.empty((bh, s_kv, head_dim), device=q.device)
    dv = torch.empty_like(dk)
    for j in range(c["n_kv"]):
        cols = slice(j * bk, (j + 1) * bk)
        kj, vj = c["kf"][:, cols], c["vf"][:, cols]
        acc_k = torch.zeros(kj.shape, device=q.device)
        acc_v = torch.zeros_like(acc_k)
        for i in range(c["n_q"]):
            if not _visible(i, j, bq, bk, c["offset"], causal):
                continue
            rows = slice(i * bq, (i + 1) * bq)
            qi, do_i = c["qf"][:, rows], c["dof"][:, rows]
            p = _recompute_p(qi * scale, kj, lse[:, rows], i, j, bq, bk,
                             c["offset"], causal)
            acc_v = acc_v + p.transpose(1, 2) @ do_i
            ds = p * (do_i @ vj.transpose(1, 2) - c["delta"][:, rows, None])
            acc_k = acc_k + scale * (ds.transpose(1, 2) @ qi)
        dk[:, cols] = acc_k
        dv[:, cols] = acc_v
    group = lambda t: t.reshape(k.shape[0], -1, s_kv, head_dim).sum(dim=1)
    return group(dk).to(k.dtype), group(dv).to(v.dtype)


def flash_attention_backward_reference(q, k, v, o, lse, do,
                                       causal: bool = True,
                                       sm_scale: float | None = None,
                                       block_q: int = DEFAULT_BLOCK,
                                       block_k: int = DEFAULT_BLOCK):
    """B2 and B3's math in plain PyTorch: ``(dq, dk, dv)``, dK/dV at
    grouped width (:func:`dq_reference`, :func:`dkv_reference`)."""
    args = (q, k, v, o, lse, do, causal, sm_scale, block_q, block_k)
    return (dq_reference(*args), *dkv_reference(*args))


# ------------------------------------------------------------ CUDA route
def plan_flash_bwd(dtype: torch.dtype, head_dim: int, s_q: int, s_kv: int,
                   rep: int) -> str:
    """The route of a B2/B3 pair on the card, chosen before launch:
    ``"f32"`` for fp32; ``"sm90"`` for bf16 at head dim 48, 64 or 128
    with ``1 <= S_q <= S_kv`` (ragged lengths and any GQA group included:
    what ``csrc/flash_bwd_sm90.cu`` checks before it launches; a 48-wide
    row fills 96 bytes of a 128-byte swizzled row there); ``"mma_sync"``
    for every other bf16 shape — D 32, whose 64-byte rows need a 64-byte
    swizzle the ``wgmma`` kernels do not build, and S_q > S_kv, where
    causal rows see no key."""
    if dtype == torch.float32:
        return "f32"
    if (head_dim in SM90_BWD_HEAD_DIMS and rep >= 1
            and 1 <= s_q <= s_kv <= _SM90_MAX_S):
        return "sm90"
    return "mma_sync"


def plan_flash_fwd(dtype: torch.dtype, head_dim: int, s_q: int, s_kv: int,
                   rep: int, *, sm_scale: float | None = None) -> str:
    """The route of a B1 launch on the card, chosen before launch: the
    route :func:`plan_flash_bwd` gives the same shape (``"sm90"`` is the
    ``wgmma`` kernel of ``csrc/flash_fwd_sm90.cu``, which checks the same
    before it launches; ``"mma_sync"`` is ``flash_fwd_mma``, ``"f32"``
    ``flash_fwd``), except that ``sm_scale <= 0`` plans ``"mma_sync"``
    where that would be ``"sm90"``: the ``sm90`` kernel takes its running
    max over the raw scores, which keep the scaled ones' order only for a
    positive scale, and ``flash_fwd_mma`` scales before it masks, as the
    TPU kernel does. ``sm_scale=None`` is the default ``1 / sqrt(D)``."""
    route = plan_flash_bwd(dtype, head_dim, s_q, s_kv, rep)
    if route == "sm90" and sm_scale is not None and not sm_scale > 0:
        return "mma_sync"
    return route


def _bind(lib: ctypes.CDLL, specs: dict) -> None:
    for name, argtypes in specs.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    from torchbooster_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    _bind(lib, {"tb_flash_fwd": [_I, _I] + [_P] * 5 + [_I] * 5 + [_F, _P],
                "tb_flash_dq": [_I, _I] + [_P] * 8 + [_I] * 5 + [_F, _P],
                "tb_flash_dkv": [_I, _I] + [_P] * 8 + [_I] * 5 + [_F, _P]})
    return lib


def _lib_fwd_sm90() -> ctypes.CDLL:
    from torchbooster_tpu_torch.ops import _build

    lib = _build.load("flash_fwd_sm90")
    _bind(lib, {"tb_flash_fwd_sm90": [_I] + [_P] * 5 + [_I] * 5 + [_F, _P]})
    return lib


def _lib_sm90() -> ctypes.CDLL:
    from torchbooster_tpu_torch.ops import _build

    lib = _build.load("flash_bwd_sm90")
    _bind(lib, {"tb_flash_dq_sm90": [_I] + [_P] * 8 + [_I] * 5 + [_F, _P],
                "tb_flash_dkv_sm90": [_I] + [_P] * 8 + [_I] * 5 + [_F, _P],
                "tb_wgmma_probe": [_I, _I] + [_P] * 5})
    return lib


def _check_cuda(q, k, v, *like_q, rows=()) -> None:
    """What the kernels take, checked before any pointer is passed:
    contiguous CUDA tensors on one device in one dtype of fp32/bf16, q
    ``(BH, S_q, D)`` with D 32, 48, 64 or 128, k and v ``(BH_kv, S_kv, D)``
    with ``BH % BH_kv == 0``, ``like_q`` (o, dO) shaped like q, and
    ``rows`` (lse, delta) fp32 ``(BH, S_q)``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        "(fp32 or bf16)")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} not "
                         f"built; the CUDA kernels take {HEAD_DIMS}")
    for t in (q, k, v, *like_q):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attention: every operand must be a "
                             f"{q.dtype} tensor on {q.device}")
    bh, s_q, head_dim = q.shape
    if (k.ndim != 3 or k.shape != v.shape or k.shape[2] != head_dim
            or bh % k.shape[0]
            or any(t.shape != q.shape for t in like_q)
            or any(t.shape != (bh, s_q) or t.dtype != torch.float32
                   or t.device != q.device for t in rows)):
        raise ValueError("flash_attention: operand shapes do not fit q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if not all(t.is_contiguous() for t in (q, k, v, *like_q, *rows)):
        raise ValueError("flash_attention: the kernels take contiguous "
                         "tensors")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(q, k, v, causal, sm_scale, block_q, block_k):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale,
                                         block_q, block_k)
    return launch_fwd(q, k, v, causal, sm_scale)


def launch_fwd(q, k, v, causal, sm_scale, route: str | None = None):
    """B1 on CUDA tensors: ``(o, lse)``. ``route`` defaults to the plan
    of :func:`plan_flash_fwd` for this ``sm_scale`` (the smoke times
    ``"mma_sync"`` beside ``"sm90"`` on the same inputs); a route that
    cannot take the operands raises, and so does a named ``"sm90"`` at
    ``sm_scale <= 0``: its running max is over the raw scores, which keep
    the order of the scaled ones only for a positive scale."""
    _check_cuda(q, k, v)
    bh, s_q, head_dim = q.shape
    bh_kv, s_kv, _ = k.shape
    if route == "sm90" and not sm_scale > 0:
        raise ValueError("flash_attention forward: the sm90 kernel takes "
                         f"sm_scale > 0, not {sm_scale}")
    o = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    route = _held_route(plan_flash_fwd, "forward", q, k, route,
                        (q, k, v, o), sm_scale=sm_scale)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, bh_kv, s_q, s_kv, int(causal), sm_scale,
            _stream(q))
    if route == "sm90":
        err = _lib_fwd_sm90().tb_flash_fwd_sm90(head_dim, *ptrs)
    else:
        err = _lib().tb_flash_fwd(_DTYPE_CODE[q.dtype], head_dim, *ptrs)
    if err != 0:
        raise RuntimeError(f"flash_attention forward kernel launch failed "
                           f"({route}): CUDA error {err}")
    launch_tally.count(__name__, ("launches_fwd", None),
                       ("launches_fwd_by_route", route),
                       ("launches_fwd_by_mask",
                        "causal" if causal else "full"))
    return o, lse


def _held_route(plan, what: str, q, k, route: str | None, tensors,
                **plan_kw) -> str:
    """The route of a launch on checked operands: ``plan``'s (given
    ``plan_kw``), or ``route`` when the caller names one. A route that
    cannot take the operands raises."""
    bh, s_q, head_dim = q.shape
    planned = plan(q.dtype, head_dim, s_q, k.shape[1], bh // k.shape[0],
                   **plan_kw)
    route = planned if route is None else route
    wants = {"sm90": planned == "sm90", "f32": q.dtype == torch.float32,
             "mma_sync": q.dtype == torch.bfloat16}
    if not wants.get(route, False):
        raise ValueError(f"flash_attention {what}: route {route!r} does "
                         f"not take these operands (planned {planned!r})")
    if route == "sm90" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"flash_attention {what}: the sm90 kernels take "
                         "16-byte aligned tensors")
    return route


def _bwd_route(q, k, route: str | None, *tensors) -> str:
    """The backward's route (:func:`_held_route` over
    :func:`plan_flash_bwd`)."""
    return _held_route(plan_flash_bwd, "backward", q, k, route, tensors)


def launch_dq(q, k, v, o, lse, do, causal, sm_scale,
              route: str | None = None):
    """B2 on CUDA tensors: ``(dq, delta)``, delta the fp32 (BH, S_q)
    rowsum(dO∘O) that B3 reads. ``route`` defaults to the plan of
    :func:`plan_flash_bwd`."""
    _check_cuda(q, k, v, o, do, rows=(lse,))
    bh, s_q, head_dim = q.shape
    bh_kv, s_kv, _ = k.shape
    delta = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    route = _bwd_route(q, k, route, q, k, v, o, do, dq)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            bh, bh_kv, s_q, s_kv, int(causal), sm_scale, _stream(q))
    if route == "sm90":
        err = _lib_sm90().tb_flash_dq_sm90(head_dim, *ptrs)
    else:
        err = _lib().tb_flash_dq(_DTYPE_CODE[q.dtype], head_dim, *ptrs)
    if err != 0:
        raise RuntimeError(f"flash_attention dQ kernel launch failed "
                           f"({route}): CUDA error {err}")
    launch_tally.count(__name__, ("launches_dq", None),
                       ("launches_dq_by_route", route))
    return dq, delta


def launch_dkv(q, k, v, lse, do, delta, causal, sm_scale,
               route: str | None = None):
    """B3 on CUDA tensors: grouped ``(dk, dv)``. ``delta`` comes from
    :func:`launch_dq` on the same stream; ``route`` as there."""
    _check_cuda(q, k, v, do, rows=(lse, delta))
    bh, s_q, head_dim = q.shape
    bh_kv, s_kv, _ = k.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    route = _bwd_route(q, k, route, q, k, v, do, dk, dv)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, bh_kv, s_q, s_kv, int(causal), sm_scale, _stream(q))
    if route == "sm90":
        err = _lib_sm90().tb_flash_dkv_sm90(head_dim, *ptrs)
    else:
        err = _lib().tb_flash_dkv(_DTYPE_CODE[q.dtype], head_dim, *ptrs)
    if err != 0:
        raise RuntimeError(f"flash_attention dK/dV kernel launch failed "
                           f"({route}): CUDA error {err}")
    launch_tally.count(__name__, ("launches_dkv", None),
                       ("launches_dkv_by_route", route))
    return dk, dv


def wgmma_probe(mode: int, a: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """One ``wgmma`` tile of ``csrc/flash_bwd_sm90.cu`` on bf16 CUDA
    tensors, for the card tests of the two operand forms B2/B3 rest on:
    ``a``, ``w`` (64, 64) and ``b`` (64, N), N 48, 64 or 128. Mode 0 returns
    ``a @ b`` with b read MN-major (the transpose bit); mode 1 ``bf16(a
    @ w.T) @ b``, the first product's accumulator re-packed as the
    register-A operand of the second. fp32 (64, N)."""
    n = b.shape[1]
    if (a.shape != (64, 64) or w.shape != (64, 64) or b.shape != (64, n)
            or any(t.dtype != torch.bfloat16 or t.device.type != "cuda"
                   or not t.is_contiguous() for t in (a, w, b))):
        raise ValueError("wgmma_probe: a, w (64, 64) and b (64, N) "
                         "contiguous bf16 CUDA tensors")
    c = torch.empty((64, n), dtype=torch.float32, device=a.device)
    err = _lib_sm90().tb_wgmma_probe(mode, n, a.data_ptr(), w.data_ptr(),
                                     b.data_ptr(), c.data_ptr(), _stream(a))
    if err != 0:
        raise RuntimeError(f"wgmma_probe launch failed: CUDA error {err}")
    return c


def _backward(q, k, v, o, lse, do, causal, sm_scale, block_q, block_k):
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, causal, sm_scale, block_q, block_k)
    dq, delta = launch_dq(q, k, v, o, lse, do, causal, sm_scale)
    return (dq, *launch_dkv(q, k, v, lse, do, delta, causal, sm_scale))


def _chunk_blocks(q, k, sm_scale, block):
    s_q, s_kv = q.shape[1], k.shape[1]
    block = DEFAULT_BLOCK if block is None else block
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return (float(sm_scale), _pick_block(block, s_q, "seq_q"),
            _pick_block(block, s_kv, "seq_kv"))


def flash_forward(q, k, v, causal: bool = True,
                  sm_scale: float | None = None,
                  block: int | None = None):
    """B1 with its lse, outside autograd: ``(o, lse)``, o in q's dtype
    and lse fp32 ``(BH, S_q)`` (natural log). The ring-flash body's
    per-chunk forward (``parallel/ring.py``, JAX ``_fwd_pallas(...,
    save_residuals=True)``): non-causal against a visiting chunk, causal
    on the diagonal one. CUDA tensors launch the kernel on its planned
    route; CPU tensors run :func:`flash_attention_reference`."""
    scale, bq, bk = _chunk_blocks(q, k, sm_scale, block)
    return _forward(q.contiguous(), k.contiguous(), v.contiguous(),
                    bool(causal), scale, bq, bk)


def flash_backward(q, k, v, o, lse, do, causal: bool = True,
                   sm_scale: float | None = None,
                   block: int | None = None):
    """B2 then B3 against a GIVEN ``(o, lse)``: ``(dq, dk, dv)``, dK/dV
    at grouped width. The ring-flash backward passes the global output
    and lse of the whole sequence with each chunk's K/V: the
    probabilities recomputed from the global lse are that chunk's columns
    of the global softmax, and ``delta = rowsum(dO∘O)`` (B2's) is the
    global one, so the per-chunk gradients add up exactly. CUDA tensors
    launch the kernels; CPU tensors run their plain versions."""
    scale, bq, bk = _chunk_blocks(q, k, sm_scale, block)
    return _backward(q.contiguous(), k.contiguous(), v.contiguous(),
                     o.contiguous(), lse.contiguous(), do.contiguous(),
                     bool(causal), scale, bq, bk)


class _Flash(torch.autograd.Function):
    """B1 forward, B2 + B3 backward (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, block_q, block_k):
        o, lse = _forward(q, k, v, causal, sm_scale, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: float | None = None,
                    block_q: int | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """Blocked attention over ``(BH, S, D)`` tensors; differentiable.
    Block sizes default to 1024 and shrink by halving (floor 8) to
    divide the lengths; a length no block divides raises ``ValueError``
    (see the module docstring)."""
    bh, s_q, head_dim = q.shape
    bh_kv, s_kv = k.shape[:2]
    if bh % bh_kv:
        raise ValueError(f"flash_attention: q rows ({bh}) not divisible "
                         f"by grouped k/v rows ({bh_kv})")
    if k.shape != v.shape or k.shape[2] != head_dim:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    block_q = _pick_block(DEFAULT_BLOCK if block_q is None else block_q,
                          s_q, "seq_q")
    block_k = _pick_block(DEFAULT_BLOCK if block_k is None else block_k,
                          s_kv, "seq_kv")
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        bool(causal), float(sm_scale), block_q, block_k)


__all__ = ["DEFAULT_BLOCK", "HEAD_DIMS", "KERNEL_DTYPES", "SM90_BWD_HEAD_DIMS",
           "SM90_HEAD_DIMS",
           "dkv_reference", "dq_reference", "flash_attention",
           "flash_backward", "flash_forward",
           "flash_attention_backward_reference", "flash_attention_reference",
           "launch_dkv", "launch_dq", "launch_fwd", "launches_dkv",
           "launches_dkv_by_route", "launches_dq", "launches_dq_by_route",
           "launches_fwd", "launches_fwd_by_mask", "launches_fwd_by_route", "plan_flash_bwd",
           "plan_flash_fwd", "tileable", "wgmma_probe"]
