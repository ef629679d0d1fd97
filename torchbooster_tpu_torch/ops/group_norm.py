"""GroupNorm(+ReLU) over NHWC, forward and backward — the port of
``torchbooster_tpu/ops/group_norm.py`` (TPU kernels ``_fwd_kernel`` :69 and
``_bwd_kernel`` :106, bound together by the ``custom_vjp`` at :190-263).

:func:`group_norm_fused` is differentiable through a
``torch.autograd.Function``: its forward launches B5 and its backward B6,
hand-written CUDA kernels, on CUDA tensors. Each has two routes, chosen
before launch by :func:`plan_gn_fwd` and :func:`plan_gn_bwd`:
``"one_pass"`` (bf16, C a multiple of 8 up to 2048: a sample's run read once
into shared memory, ``csrc/group_norm_fwd_sm90.cu`` and
``csrc/group_norm_bwd_sm90.cu``) and ``"two_pass"`` (fp32 and every other
shape: ``gn_fwd`` and ``gn_bwd`` of ``csrc/group_norm.cu``). On CPU tensors
it runs :func:`group_norm_fwd_reference` and :func:`group_norm_bwd_reference`
— the same math in plain PyTorch — and only there. There is no fall-back: a
failed build or launch raises. ``launches_fwd`` and ``launches_bwd`` count
kernel launches, ``launches_fwd_by_route`` and ``launches_bwd_by_route`` the
same by route; the plain path never touches them. Under a CUDA-graph
capture the launches go to the capture's tally and each replay adds them
(``launch_tally.py``).

Numerics are the TPU kernels', not the docstring's: B5 clamps the group
variance at 0 (:87), B6 recomputes the ReLU mask as ``xhat * scale + bias
> 0`` in fp32 (:123). The TPU layout folds (``_fold``, ``_layout``) are not
ported: the CUDA kernels read NHWC as it lies. The per-sample dscale and
dbias partials are summed over N outside the kernel, as the JAX package
does at :258.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from torchbooster_tpu_torch.ops import launch_tally

launches_fwd = 0    # B5 launches, every route (the main path's proof)
launches_bwd = 0    # B6 launches, every route
# B5 launches by route: "one_pass" (group_norm_fwd_sm90.cu: x read once into
# shared memory) and "two_pass" (gn_fwd of group_norm.cu)
launches_fwd_by_route = {"one_pass": 0, "two_pass": 0}
# B6 launches by route: "one_pass" (group_norm_bwd_sm90.cu: x and dy read
# once into shared memory) and "two_pass" (gn_bwd of group_norm.cu)
launches_bwd_by_route = {"one_pass": 0, "two_pass": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CLUSTER = 8          # CTAs holding one sample (portable cluster size)
_MAX_C = 2048             # channels of one CTA: 8 a thread, 256 threads
_SM_SMEM = 233472         # shared memory of one SM (228 KB), 1 KB a CTA kept
_CTA_SMEM = 232448        # the most one CTA may have (227 KB)
_PACK_MIN_BYTES = 32768   # a sample's x at which B5 packs two a CTA


class GnFwdPlan(NamedTuple):
    """How B5 runs one call: ``route`` ``"one_pass"`` (each sample's H·W
    positions in ``cluster`` runs of ``rows`` positions, one CTA each; or,
    at ``pack`` > 1, ``pack`` whole samples a CTA) or ``"two_pass"``."""
    route: str
    cluster: int
    rows: int
    pack: int


def gn_fwd_smem_bytes(rows: int, c: int, groups: int, pack: int = 1) -> int:
    """Shared memory of one ``"one_pass"`` B5 CTA (``smem_bytes`` of
    ``csrc/group_norm_fwd_sm90.cu``): its x run of ``pack`` x ``rows``
    positions, the partials of its thread rows (one sum at a time and at
    least two rows at pack 1, as they also take the cluster totals; both
    sums of every sample packed), the channel sums and the group
    statistics."""
    trows = 256 // (c // 8)
    red = max(trows, 2) if pack == 1 else 2 * pack * trows
    return 2 * pack * rows * c + red * c * 4 + 8 * pack * c + 8 * pack * groups


def _smem_cap(ctas_per_sm: int) -> int:
    """The most shared memory one CTA may have for ``ctas_per_sm`` to share
    an SM (the card keeps 1 KB a CTA)."""
    return min(_SM_SMEM // ctas_per_sm - 1024, _CTA_SMEM)


def _fewest_ctas(hw: int, fits) -> tuple[int, int] | None:
    """``(cluster, rows)``: the fewest CTAs a sample, at most 8, whose runs
    of ``rows = ceil(H·W / cluster)`` positions ``fits(rows)``; None if no
    count does."""
    for cluster in range(1, _MAX_CLUSTER + 1):
        rows = -(-hw // cluster)
        if fits(rows):
            return -(-hw // rows), rows
    return None


def _one_pass_takes(n: int, hw: int, c: int, groups: int,
                    dtype: torch.dtype) -> bool:
    """The operands both one-pass kernels take: bf16, C a multiple of 8 up
    to 2048, ``groups`` dividing C, at most 65535 samples (the grid's y)."""
    return (dtype == torch.bfloat16 and 1 <= n <= 65535 and hw >= 1
            and c % 8 == 0 and c <= _MAX_C and groups >= 1
            and c % groups == 0)


def gn_fwd_plan(hw: int, c: int, groups: int, ctas_per_sm: int,
                pack: int = 1) -> GnFwdPlan | None:
    """The ``"one_pass"`` B5 plan whose shared memory lets ``ctas_per_sm``
    CTAs share an SM: at ``pack`` 1 the fewest CTAs a sample (at most 8);
    at ``pack`` > 1 one CTA of ``pack`` whole samples. None if none fits."""
    cap = _smem_cap(ctas_per_sm)
    if pack > 1:
        if gn_fwd_smem_bytes(hw, c, groups, pack) <= cap:
            return GnFwdPlan("one_pass", 1, hw, pack)
        return None
    got = _fewest_ctas(hw, lambda rows: gn_fwd_smem_bytes(rows, c, groups)
                       <= cap)
    return None if got is None else GnFwdPlan("one_pass", *got, 1)


def plan_gn_fwd(n: int, hw: int, c: int, groups: int,
                dtype: torch.dtype) -> GnFwdPlan:
    """The route of a B5 call, chosen before launch. ``"one_pass"`` takes
    bf16 with C a multiple of 8 (at most 2048) and at most 65535 samples: a
    sample's H·W positions split into ``cluster`` runs of ``rows =
    ceil(H·W / cluster)``, with the fewest CTAs (at most 8) whose shared
    memory lets three share an SM, else 8 if one CTA's fits the card. A
    sample that one CTA holds, whose x is at least 32 KB, goes two to a CTA
    where that CTA's shared memory still lets two share an SM (the smoke's
    plan sweep: faster at 8² x 256, slower at 4² x 512's 16 KB and where
    only one CTA fits an SM). fp32 and every other shape take
    ``"two_pass"`` (``gn_fwd``)."""
    two_pass = GnFwdPlan("two_pass", 1, hw, 1)
    if not _one_pass_takes(n, hw, c, groups, dtype):
        return two_pass
    plan = gn_fwd_plan(hw, c, groups, 3)
    if plan is not None:
        if plan.cluster == 1 and 2 * hw * c >= _PACK_MIN_BYTES:
            return gn_fwd_plan(hw, c, groups, 2, pack=2) or plan
        return plan
    rows = -(-hw // _MAX_CLUSTER)
    if gn_fwd_smem_bytes(rows, c, groups) <= _CTA_SMEM:
        return GnFwdPlan("one_pass", -(-hw // rows), rows, 1)
    return two_pass


class GnBwdPlan(NamedTuple):
    """How B6 runs one call: ``route`` ``"one_pass"`` (each sample's H·W
    positions in ``cluster`` runs of ``rows`` positions, one CTA each) or
    ``"two_pass"``."""
    route: str
    cluster: int
    rows: int


def gn_bwd_smem_bytes(rows: int, c: int, groups: int) -> int:
    """Shared memory of one ``"one_pass"`` CTA (``smem_bytes`` of
    ``csrc/group_norm_bwd_sm90.cu``): its x and dy runs, the partials of
    its thread rows (at least two rows: they also take the cluster totals),
    the channel sums and the group means."""
    trows = 256 // (c // 8)
    return (rows * c * 4 + max(trows, 2) * c * 4 + 2 * c * 4
            + 2 * groups * 4)


def gn_bwd_plan(hw: int, c: int, groups: int,
                ctas_per_sm: int) -> GnBwdPlan | None:
    """The ``"one_pass"`` plan with the fewest CTAs a sample (at most 8)
    whose shared memory lets ``ctas_per_sm`` of them share an SM; None if
    no count does."""
    cap = _smem_cap(ctas_per_sm)
    got = _fewest_ctas(hw, lambda rows: gn_bwd_smem_bytes(rows, c, groups)
                       <= cap)
    return None if got is None else GnBwdPlan("one_pass", *got)


def plan_gn_bwd(n: int, hw: int, c: int, groups: int,
                dtype: torch.dtype) -> GnBwdPlan:
    """The route of a B6 call, chosen before launch. ``"one_pass"`` takes
    bf16 with C a multiple of 8 (at most 2048): a sample's H·W positions
    split into ``cluster`` runs of ``rows = ceil(H·W / cluster)``, with the
    fewest CTAs (at most 8) whose shared memory lets three share an SM,
    else 8 if one CTA's fits the card. fp32 and every other shape take
    ``"two_pass"`` (``gn_bwd``)."""
    two_pass = GnBwdPlan("two_pass", 1, hw)
    if not _one_pass_takes(n, hw, c, groups, dtype):
        return two_pass
    plan = gn_bwd_plan(hw, c, groups, 3)
    if plan is not None:
        return plan
    rows = -(-hw // _MAX_CLUSTER)
    if gn_bwd_smem_bytes(rows, c, groups) <= _CTA_SMEM:
        return GnBwdPlan("one_pass", -(-hw // rows), rows)
    return two_pass


def _group_combine(per_c: torch.Tensor, groups: int,
                   count: int) -> torch.Tensor:
    """(N, C) per-channel sums → per-channel group means: each channel
    gets its group's sum over ``count`` elements (the TPU kernel's
    same-group one-hot matmul)."""
    n, c = per_c.shape
    g = per_c.reshape(n, groups, c // groups).sum(-1) * (1.0 / count)
    return g.repeat_interleave(c // groups, dim=1)


def group_norm_fwd_reference(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, groups: int,
                             eps: float = 1e-5, relu: bool = False):
    """B5's math in plain PyTorch: ``(y, stats)`` — y in x's dtype, stats
    fp32 ``(N, 2, C)`` (per-channel group mean and ``1/sqrt(var + eps)``,
    var clamped at 0)."""
    n, h, w, c = x.shape
    count = h * w * (c // groups)
    xf = x.float().reshape(n, h * w, c)
    mean = _group_combine(xf.sum(1), groups, count)
    ex2 = _group_combine((xf * xf).sum(1), groups, count)
    inv = torch.rsqrt(torch.clamp(ex2 - mean * mean, min=0.0) + eps)
    a = inv * scale.float()
    b = bias.float() - mean * a
    y = xf * a[:, None, :] + b[:, None, :]
    if relu:
        y = torch.clamp(y, min=0.0)
    return (y.to(x.dtype).reshape(x.shape),
            torch.stack([mean, inv], dim=1))


def group_norm_bwd_reference(x: torch.Tensor, dy: torch.Tensor,
                             stats: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, groups: int,
                             relu: bool = False):
    """B6's math in plain PyTorch: ``(dx, part)`` — dx in x's dtype, part
    fp32 ``(N, 2, C)``, the per-sample dscale and dbias partials."""
    n, h, w, c = x.shape
    count = h * w * (c // groups)
    mean, inv = stats[:, 0, None, :], stats[:, 1, None, :]
    scale32, bias32 = scale.float(), bias.float()
    xhat = (x.float().reshape(n, h * w, c) - mean) * inv
    g = dy.float().reshape(n, h * w, c)
    if relu:
        g = torch.where(xhat * scale32 + bias32 > 0, g,
                        torch.zeros_like(g))
    dxhat = g * scale32
    g1 = _group_combine(dxhat.sum(1), groups, count)[:, None, :]
    g2 = _group_combine((dxhat * xhat).sum(1), groups, count)[:, None, :]
    dx = inv * (dxhat - g1 - xhat * g2)
    part = torch.stack([(g * xhat).sum(1), g.sum(1)], dim=1)
    return dx.to(x.dtype).reshape(x.shape), part


# ------------------------------------------------------------ CUDA route
def _lib() -> ctypes.CDLL:
    from torchbooster_tpu_torch.ops import _build

    lib = _build.load("group_norm")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    specs = {"tb_gn_fwd": [i] + [p] * 5 + [i] * 4 + [f, i, p],
             "tb_gn_bwd": [i] + [p] * 7 + [i] * 4 + [i, p]}
    _bind(lib, specs)
    return lib


def _lib_fwd_sm90() -> ctypes.CDLL:
    from torchbooster_tpu_torch.ops import _build

    lib = _build.load("group_norm_fwd_sm90")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _bind(lib, {"tb_gn_fwd_sm90": [p] * 5 + [i] * 4 + [f] + [i] * 4 + [p],
                "tb_gn_fwd_sm90_occupancy": [i] * 4})
    return lib


def _lib_sm90() -> ctypes.CDLL:
    from torchbooster_tpu_torch.ops import _build

    lib = _build.load("group_norm_bwd_sm90")
    p, i = ctypes.c_void_p, ctypes.c_int
    _bind(lib, {"tb_gn_bwd_sm90": [p] * 7 + [i] * 7 + [p],
                "tb_gn_bwd_sm90_occupancy": [i] * 3})
    return lib


def _bind(lib: ctypes.CDLL, specs: dict) -> None:
    for name, argtypes in specs.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


def _check_cuda(x, scale, bias, groups, *like_x, stats=None) -> None:
    """What the kernels take, checked before any pointer is passed:
    contiguous, 16-byte aligned CUDA tensors on one device; x ``(N, H, W,
    C)`` fp32 or bf16 with ``groups`` dividing C; ``like_x`` (dy) shaped
    and typed like x; scale, bias (and ``stats``) fp32."""
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"group_norm: dtype {x.dtype} not supported (fp32 "
                        f"or bf16)")
    if x.ndim != 4 or x.shape[-1] % groups:
        raise ValueError(f"group_norm: x must be (N, H, W, C) with groups "
                         f"({groups}) dividing C, got {tuple(x.shape)}")
    c = x.shape[-1]
    want = [(t, x.shape, x.dtype) for t in like_x] + [
        (scale, (c,), torch.float32), (bias, (c,), torch.float32)]
    if stats is not None:
        want.append((stats, (x.shape[0], 2, c), torch.float32))
    for t, shape, dtype in want:
        if t.device != x.device or t.dtype != dtype \
                or tuple(t.shape) != tuple(shape):
            raise ValueError(f"group_norm: expected a {dtype} tensor of "
                             f"shape {tuple(shape)} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for t in (x, *like_x, scale, bias, *(() if stats is None else (stats,))):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("group_norm: the kernels take contiguous, "
                             "16-byte aligned tensors")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _held_route(plan, route: str | None, counter: dict, what: str) -> str:
    """``route``, or the planned one when None; a route that is unknown, or
    ``"one_pass"`` where the plan did not choose it, raises."""
    route = plan.route if route is None else route
    if route not in counter or (route == "one_pass"
                                and plan.route != "one_pass"):
        raise ValueError(f"group_norm {what}: route {route!r} does not take "
                         f"these operands (planned {plan.route!r})")
    return route


def launch_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5, relu: bool = False,
               route: str | None = None):
    """B5 on CUDA tensors (scale and bias fp32): ``(y, stats)``. ``route``
    defaults to the plan of :func:`plan_gn_fwd`; ``"two_pass"`` forces
    ``gn_fwd`` on the same inputs, and ``"one_pass"`` where it was not
    planned raises."""
    _check_cuda(x, scale, bias, groups)
    n, h, w, c = x.shape
    plan = plan_gn_fwd(n, h * w, c, groups, x.dtype)
    route = _held_route(plan, route, launches_fwd_by_route, "forward")
    if route == "one_pass":
        res = _launch_fwd_one_pass(x, scale, bias, groups, eps, relu, plan)
    else:
        y = torch.empty_like(x)
        stats = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
        err = _lib().tb_gn_fwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), stats.data_ptr(), n, h * w, c,
            groups, float(eps), int(relu), _stream(x))
        if err != 0:
            raise RuntimeError(f"group_norm forward kernel launch failed "
                               f"(two_pass): CUDA error {err}")
        res = y, stats
    launch_tally.count(__name__, ("launches_fwd", None),
                       ("launches_fwd_by_route", route))
    return res


def _launch_fwd_one_pass(x, scale, bias, groups: int, eps: float, relu: bool,
                         plan: GnFwdPlan):
    """One call of ``tb_gn_fwd_sm90`` at ``plan`` on operands
    :func:`_check_cuda` passed (the smoke also times it at the other plans
    :func:`gn_fwd_plan` offers)."""
    n, h, w, c = x.shape
    y = torch.empty_like(x)
    stats = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
    err = _lib_fwd_sm90().tb_gn_fwd_sm90(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        stats.data_ptr(), n, h * w, c, groups, float(eps), int(relu),
        plan.rows, plan.cluster, plan.pack, _stream(x))
    if err != 0:
        raise RuntimeError(f"group_norm forward kernel launch failed "
                           f"({plan}): CUDA error {err}")
    return y, stats


def ctas_per_sm_fwd(plan: GnFwdPlan, c: int, groups: int) -> int:
    """CTAs of B5's one-pass kernel that share one SM at ``plan``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs the card."""
    return _lib_fwd_sm90().tb_gn_fwd_sm90_occupancy(plan.rows, c, groups,
                                                    plan.pack)


def launch_bwd(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor, groups: int,
               relu: bool = False, route: str | None = None):
    """B6 on CUDA tensors: ``(dx, part)``. ``route`` defaults to the plan of
    :func:`plan_gn_bwd`; ``"two_pass"`` forces ``gn_bwd`` on the same
    inputs, and ``"one_pass"`` where it was not planned raises."""
    _check_cuda(x, scale, bias, groups, dy, stats=stats)
    n, h, w, c = x.shape
    plan = plan_gn_bwd(n, h * w, c, groups, x.dtype)
    route = _held_route(plan, route, launches_bwd_by_route, "backward")
    if route == "one_pass":
        res = _launch_one_pass(x, dy, stats, scale, bias, groups, relu, plan)
    else:
        dx = torch.empty_like(x)
        part = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
        err = _lib().tb_gn_bwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dy.data_ptr(),
            stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            dx.data_ptr(), part.data_ptr(), n, h * w, c, groups, int(relu),
            _stream(x))
        if err != 0:
            raise RuntimeError(f"group_norm backward kernel launch failed "
                               f"(two_pass): CUDA error {err}")
        res = dx, part
    launch_tally.count(__name__, ("launches_bwd", None),
                       ("launches_bwd_by_route", route))
    return res


def _launch_one_pass(x, dy, stats, scale, bias, groups: int, relu: bool,
                     plan: GnBwdPlan):
    """One call of ``tb_gn_bwd_sm90`` at ``plan`` on operands
    :func:`_check_cuda` passed (the smoke also times it at the other plans
    :func:`gn_bwd_plan` offers)."""
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    part = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
    err = _lib_sm90().tb_gn_bwd_sm90(
        x.data_ptr(), dy.data_ptr(), stats.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), dx.data_ptr(), part.data_ptr(), n, h * w, c, groups,
        int(relu), plan.rows, plan.cluster, _stream(x))
    if err != 0:
        raise RuntimeError(f"group_norm backward kernel launch failed "
                           f"({plan}): CUDA error {err}")
    return dx, part


def ctas_per_sm_bwd(plan: GnBwdPlan, c: int, groups: int) -> int:
    """CTAs of B6's one-pass kernel that share one SM at ``plan``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs the card."""
    return _lib_sm90().tb_gn_bwd_sm90_occupancy(plan.rows, c, groups)


class _GroupNorm(torch.autograd.Function):
    """B5 forward, B6 backward (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, relu):
        s32 = scale.detach().float().contiguous()
        b32 = bias.detach().float().contiguous()
        if x.device.type == "cpu":
            y, stats = group_norm_fwd_reference(x, s32, b32, groups, eps,
                                                relu)
        else:
            y, stats = launch_fwd(x, s32, b32, groups, eps, relu)
        ctx.save_for_backward(x, s32, b32, stats)
        ctx.args = (groups, relu, scale.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, s32, b32, stats = ctx.saved_tensors
        groups, relu, s_dtype, b_dtype = ctx.args
        dy = dy.contiguous()
        if x.device.type == "cpu":
            dx, part = group_norm_bwd_reference(x, dy, stats, s32, b32,
                                                groups, relu)
        else:
            dx, part = launch_bwd(x, dy, stats, s32, b32, groups, relu)
        part = part.sum(dim=0)
        return dx, part[0].to(s_dtype), part[1].to(b_dtype), None, None, None


def group_norm_fused(scale: torch.Tensor, bias: torch.Tensor,
                     x: torch.Tensor, groups: int, eps: float = 1e-5,
                     relu: bool = False) -> torch.Tensor:
    """Fused GroupNorm(+ReLU) over NHWC through B5/B6 (the plain versions
    on CPU tensors); differentiable. ``groups`` must divide C (the caller,
    ``layers.group_norm``, clips it)."""
    if x.shape[-1] % groups:
        raise ValueError(f"group_norm_fused: groups ({groups}) must divide "
                         f"C ({x.shape[-1]})")
    return _GroupNorm.apply(x.contiguous(), scale, bias, int(groups),
                            float(eps), bool(relu))


__all__ = ["GnBwdPlan", "GnFwdPlan", "ctas_per_sm_bwd", "ctas_per_sm_fwd",
           "gn_bwd_plan", "gn_bwd_smem_bytes", "gn_fwd_plan",
           "gn_fwd_smem_bytes", "group_norm_bwd_reference",
           "group_norm_fused", "group_norm_fwd_reference", "launch_bwd",
           "launch_fwd", "launches_bwd", "launches_bwd_by_route",
           "launches_fwd", "launches_fwd_by_route", "plan_gn_bwd",
           "plan_gn_fwd"]
