"""Fused convolution + GroupNorm (+ReLU) over NHWC — the port of
``torchbooster_tpu/ops/fused_block.py`` (TPU kernels ``_fwd_kernel`` :70,
the 1×1 conv, and ``_fwd3_kernel`` :238, the 3×3 stride-1 conv).

:func:`conv1x1_gn_relu` (B7) and :func:`conv3x3_gn_relu` (B8) are
differentiable through ``torch.autograd.Function``s whose forwards launch
the hand-written CUDA kernels of ``csrc/conv1x1_gn_sm90.cu``,
``csrc/conv3x3_gn_sm90.cu`` (both instances of ``csrc/conv_gn_sm90.cuh``)
and ``csrc/fused_block.cu`` on CUDA tensors and run
:func:`conv_gn_reference` — the same math in plain PyTorch — on CPU
tensors, and only there. The backwards are plain PyTorch, as the JAX
package's are plain XLA: B7's is ``_conv1x1_gn_bwd`` (:184-216), which
recomputes y from x and w; B8's is the autograd of the reference
formulation ``_ref_conv3x3_gn`` (:283-305) recomputed from (x, w, scale,
bias), as at :345-352. There is no fall-back: a failed build or launch
raises. ``launches_1x1`` and ``launches_3x3`` count kernel launches,
``launches_1x1_by_route`` and ``launches_3x3_by_route`` the same by the
route :func:`plan_conv1x1` or :func:`plan_conv3x3` chose.

What the kernels keep of the TPU ones: the weight is cast to x's dtype
before the product (:365, :397), the product accumulates in fp32, the
group moments come from the fp32 y and are NOT clamped (:84, :273, unlike
``ops/group_norm.py``), and B7 returns per-channel mu and rstd ``(B,
Cout)`` for its backward. The VMEM budget of ``fits``/``fits3`` is a TPU
limit and is not ported: the CUDA kernels tile the product and reduce the
moments across CTAs (see the source notes), so any size runs. The
"pack" routes take up ``_samples_per_cell``'s idea (several samples in
one grid cell) for maps of at most 128 positions.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

launches_1x1 = 0    # B7 launches (the main path's proof of route)
launches_3x3 = 0    # B8 launches, every route
# launches by route: bf16 "cluster" and "pack" (the one-pass kernel of
# conv_gn_sm90.cuh: conv1x1_gn_sm90.cu for B7, conv3x3_gn_sm90.cu for B8),
# bf16 "mma_sync" and fp32 "f32" (the two-pass kernels of fused_block.cu)
launches_1x1_by_route = {"cluster": 0, "pack": 0, "mma_sync": 0, "f32": 0}
launches_3x3_by_route = {"cluster": 0, "pack": 0, "mma_sync": 0, "f32": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODE = {"cluster": 1, "pack": 2}
_SM90_BM = 128          # tile rows of the one-pass kernel
_SM90_BN = (64, 128, 256)
# B7's Cout tiles: at most 128, so two CTAs share an SM (conv_gn_sm90.cuh)
_SM90_BN_1X1 = (64, 128)
_MAX_CLUSTER = 8        # CTAs holding one sample (portable cluster size)
_MAX_PACK = 8           # samples sharing one tile


class ConvPlan(NamedTuple):
    """How B7 or B8 runs one bf16 call: ``route`` ``"cluster"`` (one
    sample over ``cluster`` CTAs of ``bm`` rows), ``"pack"`` (``p``
    samples in one ``bm``-row tile) or ``"mma_sync"`` (the two-pass kernel
    of ``fused_block.cu``), with ``bn`` output channels a tile."""
    route: str
    bm: int
    bn: int
    p: int
    cluster: int


def _plan_one_pass(b: int, m: int, cin: int, cout: int, groups: int,
                   bns: tuple) -> ConvPlan:
    """The one-pass kernel's rule over M = Ho·Wo output rows a sample:
    Cin and Cout multiples of 8 and a Cout tile from ``bns`` that is a
    multiple of the group width; ``ceil(M / 128)`` CTAs of one cluster (at
    most 8) when M > 128, else ``min(8, 128 // M)`` samples a tile. Every
    other shape takes the two-pass ``mma_sync`` kernel, whose tile height
    follows M."""
    mma_bm = 16 if m <= 16 else (32 if m <= 32 else 64)
    fallback = ConvPlan("mma_sync", mma_bm, 64, 1, 1)
    if b < 1 or m < 1 or cin % 8 or cout % 8 or groups < 1 or cout % groups:
        return fallback
    gw = cout // groups
    fits = [n for n in bns if n % gw == 0]
    if not fits:
        return fallback
    want = min(cout, bns[-1])
    bn = next((n for n in fits if n >= want), fits[-1])
    bm = _SM90_BM
    if m <= bm:
        return ConvPlan("pack", bm, bn, min(_MAX_PACK, bm // m), 1)
    cluster = -(-m // bm)
    if cluster > _MAX_CLUSTER or b > 65535:
        return fallback
    return ConvPlan("cluster", bm, bn, 1, cluster)


def plan_conv3x3(b: int, h: int, w: int, cin: int, cout: int,
                 groups: int) -> ConvPlan:
    """The route of a bf16 B8 call (stride 1, M = H·W), chosen before
    launch by :func:`_plan_one_pass` with Cout tiles of 64, 128 or 256.
    Odd widths and M > 1024 (ResNet-50's 56² maps) take ``mma_sync``."""
    return _plan_one_pass(b, h * w, cin, cout, groups, _SM90_BN)


def plan_conv1x1(b: int, h: int, w: int, cin: int, cout: int, groups: int,
                 stride: int = 1) -> ConvPlan:
    """The route of a bf16 B7 call, chosen before launch by
    :func:`_plan_one_pass` over its output map (M = ceil(H / s)·ceil(W /
    s)), with Cout tiles of 64 or 128. Cin 12 and M > 1024 (ResNet-50's
    56² 1×1s) take ``mma_sync``."""
    m = -(-h // stride) * -(-w // stride)
    return _plan_one_pass(b, m, cin, cout, groups, _SM90_BN_1X1)


def _resolve_groups(groups: int, c: int) -> int:
    groups = min(groups, c)
    while c % groups:
        groups -= 1
    return groups


def _nchw_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
               padding: int) -> torch.Tensor:
    """NHWC x, HWIO w → NHWC ``conv(x, w)`` in the operands' dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _group_moments(y32: torch.Tensor, groups: int):
    """Per-channel group mean and second moment of fp32 ``y32`` (B, H, W,
    C): spatial sums first, then the group combine on the (B, C) sums."""
    b, h, w, c = y32.shape
    cpg = c // groups
    denom = h * w * cpg

    def gmean(s):
        g = s.reshape(b, groups, cpg).sum(-1) / denom
        return g.repeat_interleave(cpg, dim=-1)

    return gmean(y32.sum(dim=(1, 2))), gmean((y32 * y32).sum(dim=(1, 2)))


def conv_gn_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, groups: int, eps: float = 1e-5,
                      relu: bool = True, stride: int = 1):
    """B7's (``w`` 1×1) and B8's (``w`` 3×3, padding 1) math in plain
    PyTorch: ``(out, mu, rstd)`` — the fp32 product of x and w (w first
    cast to x's dtype), unclamped group moments of the fp32 y, then
    ``relu(y·a + b)`` with ``a = rstd·scale``, ``b = bias − mu·a``; out
    in x's dtype, mu and rstd fp32 ``(B, Cout)``."""
    ks = w.shape[0]
    y = _nchw_conv(x.float(), w.to(x.dtype).float(), stride, (ks - 1) // 2)
    mean, m2 = _group_moments(y, groups)
    rstd = torch.rsqrt(m2 - mean * mean + eps)
    a = rstd * scale.float()
    b = bias.float() - mean * a
    out = y * a[:, None, None, :] + b[:, None, None, :]
    if relu:
        out = torch.clamp(out, min=0.0)
    return out.to(x.dtype), mean, rstd


def ref_conv3x3_gn(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, groups: int, eps: float = 1e-5,
                   relu: bool = True) -> torch.Tensor:
    """``_ref_conv3x3_gn`` (fused_block.py:283): the convolution in x's
    dtype (its output rounded there), moments of its fp32 copy. B8's
    backward is the autograd of this."""
    y32 = _nchw_conv(x, w.to(x.dtype), 1, 1).float()
    mean, m2 = _group_moments(y32, groups)
    mean, m2 = mean[:, None, None, :], m2[:, None, None, :]
    rstd = torch.rsqrt(m2 - mean * mean + eps)
    out = (y32 - mean) * rstd * scale.float() + bias.float()
    if relu:
        out = torch.clamp(out, min=0.0)
    return out.to(x.dtype)


def conv1x1_gn_backward(x3: torch.Tensor, w2: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor,
                        mu: torch.Tensor, rstd: torch.Tensor,
                        dout: torch.Tensor, groups: int, relu: bool):
    """``_conv1x1_gn_bwd`` (fused_block.py:184): recomputes ``y = x @ w``
    in fp32 from ``x3`` (B, M, Cin) and ``w2`` (Cin, Cout) instead of
    saving it. Returns ``(dx3, dw2, dscale, dbias)``."""
    b, m, cout = dout.shape
    cpg = cout // groups
    y = x3.float() @ w2.float()
    xhat = (y - mu[:, None, :]) * rstd[:, None, :]
    scale32 = scale.float()
    r = dout.float()
    if relu:
        r = r * (xhat * scale32 + bias.float() > 0)
    dbias = r.sum(dim=(0, 1)).to(bias.dtype)
    dscale = (r * xhat).sum(dim=(0, 1)).to(scale.dtype)
    gh = r * scale32

    def gmean(t):
        g = t.sum(dim=1).reshape(b, groups, cpg).sum(-1) / (m * cpg)
        return g.repeat_interleave(cpg, dim=-1)[:, None, :]

    dy = rstd[:, None, :] * (gh - gmean(gh) - xhat * gmean(gh * xhat))
    dx = (dy @ w2.float().T).to(x3.dtype)
    dw = (x3.float().reshape(-1, x3.shape[-1]).T
          @ dy.reshape(-1, cout)).to(w2.dtype)
    return dx, dw, dscale, dbias


# ------------------------------------------------------------ CUDA route
def _lib() -> ctypes.CDLL:
    from torchbooster_tpu_torch.ops import _build

    lib = _build.load("fused_block")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    specs = {"tb_conv_gn_tiles": [i, i],
             "tb_conv_gn": [i] + [p] * 8 + [i] * 9 + [f, i, p]}
    for name, argtypes in specs.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _lib_sm90(name: str) -> ctypes.CDLL:
    """``conv3x3_gn_sm90`` (B8) or ``conv1x1_gn_sm90`` (B7): the one-pass
    kernel of ``csrc/conv_gn_sm90.cuh`` behind one entry point each."""
    from torchbooster_tpu_torch.ops import _build

    lib = _build.load(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    specs = {"conv3x3_gn_sm90": {
        "tb_conv3x3_gn_sm90": [p] * 7 + [i] * 6 + [f] + [i] * 6 + [p]},
        "conv1x1_gn_sm90": {
        "tb_conv1x1_gn_sm90": [p] * 7 + [i] * 7 + [f] + [i] * 6 + [p],
        "tb_conv1x1_gn_sm90_occupancy": [i]}}[name]
    for fname, argtypes in specs.items():
        fn = getattr(lib, fname)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _weight_taps(w: torch.Tensor) -> torch.Tensor:
    """(k, k, Cin, Cout) -> (taps, Cout, Cin): a weight tile loads with Cin
    contiguous, the K-major layout of the tensor-core B operand."""
    ks, cin, cout = w.shape[0], w.shape[2], w.shape[3]
    return w.permute(0, 1, 3, 2).reshape(ks * ks, cout, cin).contiguous()


def _check_cuda(x, w, scale, bias) -> None:
    """What the kernels take, checked before any pointer is passed:
    contiguous, 16-byte aligned CUDA tensors on one device; x ``(B, H, W,
    Cin)`` fp32 or bf16; w ``(k, k, Cin, Cout)`` in x's dtype; scale and
    bias fp32 ``(Cout,)``."""
    if x.device.type != "cuda":
        raise ValueError(f"conv_gn: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv_gn: dtype {x.dtype} not supported (fp32 or "
                        f"bf16)")
    if x.ndim != 4 or w.ndim != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv_gn: x {tuple(x.shape)} (B, H, W, Cin) and w "
                         f"{tuple(w.shape)} (k, k, Cin, Cout) do not fit")
    cout = w.shape[3]
    for t, dtype, shape in ((w, x.dtype, w.shape),
                            (scale, torch.float32, (cout,)),
                            (bias, torch.float32, (cout,))):
        if t.device != x.device or t.dtype != dtype \
                or tuple(t.shape) != tuple(shape):
            raise ValueError(f"conv_gn: every operand must be on {x.device}: "
                             f"w in {x.dtype}, scale and bias fp32 "
                             f"({cout},)")
    for t in (x, w, scale, bias):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("conv_gn: the kernels take contiguous, 16-byte "
                             "aligned tensors")


def _launch(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor, groups: int, eps: float, relu: bool,
            stride: int):
    """One call of ``tb_conv_gn`` (pass 1, moments, pass 2) on operands
    :func:`_check_cuda` passed."""
    b, h, wd, cin = x.shape
    ks, cout = w.shape[0], w.shape[3]
    if cout % groups:
        raise ValueError(f"conv_gn: groups ({groups}) must divide Cout "
                         f"({cout})")
    pad = (ks - 1) // 2
    ho, wo = (h + 2 * pad - ks) // stride + 1, (wd + 2 * pad - ks) // stride + 1
    wt = _weight_taps(w)
    lib = _lib()
    code = _DTYPE_CODE[x.dtype]
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    mu = torch.empty((b, cout), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    part = torch.empty((b, lib.tb_conv_gn_tiles(code, ho * wo), 2, cout),
                       dtype=torch.float32, device=x.device)
    err = lib.tb_conv_gn(
        code, x.data_ptr(), wt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), mu.data_ptr(), rstd.data_ptr(), part.data_ptr(), b, h,
        wd, cin, cout, ks, stride, pad, groups, float(eps), int(relu),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_gn kernel launch failed: CUDA error {err}")
    return out, mu, rstd


def _launch_sm90(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, groups: int, eps: float, relu: bool,
                 stride: int, plan: ConvPlan):
    """One call of the one-pass kernel on checked bf16 operands:
    ``tb_conv3x3_gn_sm90`` (B8) for a 3×3 w, read as its (taps, Cout, Cin)
    copy; ``tb_conv1x1_gn_sm90`` (B7) for a 1×1 w at ``stride``, read as it
    lies."""
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    wt = _weight_taps(w) if w.shape[0] == 3 else w
    ho, wo = -(-h // stride), -(-wd // stride)
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    mu = torch.empty((b, cout), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    ptrs = (x.data_ptr(), wt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), mu.data_ptr(), rstd.data_ptr(), b, h, wd, cin,
            cout, groups)
    tail = (float(eps), int(relu), _ROUTE_CODE[plan.route], plan.bm,
            plan.bn, plan.p, plan.cluster,
            torch.cuda.current_stream(x.device).cuda_stream)
    if w.shape[0] == 3:
        err = _lib_sm90("conv3x3_gn_sm90").tb_conv3x3_gn_sm90(*ptrs, *tail)
    else:
        err = _lib_sm90("conv1x1_gn_sm90").tb_conv1x1_gn_sm90(*ptrs, stride,
                                                             *tail)
    if err != 0:
        raise RuntimeError(f"conv_gn one-pass kernel launch failed "
                           f"({w.shape[0]}x{w.shape[0]}, {plan}): CUDA error "
                           f"{err}")
    return out, mu, rstd


def ctas_per_sm_1x1(plan: ConvPlan) -> int:
    """CTAs of B7's one-pass kernel that share one SM at ``plan``'s Cout
    tile (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs the
    card."""
    return _lib_sm90("conv1x1_gn_sm90").tb_conv1x1_gn_sm90_occupancy(plan.bn)


def _held_route(planned: str, route: str | None, dtype: torch.dtype,
                what: str) -> str:
    """The route of a launch on checked operands: ``planned`` (``"f32"``
    for fp32), or ``route`` when the caller names one. ``"mma_sync"`` takes
    any bf16 operands, the one-pass routes only what they were planned for;
    a route that cannot take the operands raises."""
    if dtype == torch.float32:
        planned = "f32"
    route = planned if route is None else route
    wants = {"f32": dtype == torch.float32,
             "mma_sync": dtype == torch.bfloat16,
             "cluster": planned == "cluster", "pack": planned == "pack"}
    if not wants.get(route, False):
        raise ValueError(f"{what}: route {route!r} does not take these "
                         f"operands (planned {planned!r})")
    return route


def launch_1x1(x, w, scale, bias, groups: int, eps: float = 1e-5,
               relu: bool = True, stride: int = 1, route: str | None = None):
    """B7 on CUDA tensors, w ``(1, 1, Cin, Cout)``: ``(out, mu, rstd)``.
    bf16 takes the route :func:`plan_conv1x1` plans, fp32 the CUDA-core
    two-pass kernel; ``route`` forces another (``"mma_sync"``, B7's earlier
    bf16 kernel, on the same inputs); a route that cannot take the operands
    raises."""
    global launches_1x1
    if w.shape[:2] != (1, 1):
        raise ValueError(f"launch_1x1: w must be (1, 1, Cin, Cout), got "
                         f"{tuple(w.shape)}")
    _check_cuda(x, w, scale, bias)
    plan = plan_conv1x1(*x.shape, w.shape[3], groups, stride)
    route = _held_route(plan.route, route, x.dtype, "launch_1x1")
    if route in _ROUTE_CODE:
        res = _launch_sm90(x, w, scale, bias, groups, eps, relu, stride, plan)
    else:
        res = _launch(x, w, scale, bias, groups, eps, relu, stride)
    launches_1x1 += 1
    launches_1x1_by_route[route] += 1
    return res


def launch_3x3(x, w, scale, bias, groups: int, eps: float = 1e-5,
               relu: bool = True):
    """B8 on CUDA tensors, w ``(3, 3, Cin, Cout)``, stride 1, padding 1:
    ``(out, mu, rstd)``. bf16 takes the route :func:`plan_conv3x3` plans;
    fp32 the CUDA-core two-pass kernel."""
    global launches_3x3
    if w.shape[:2] != (3, 3):
        raise ValueError(f"launch_3x3: w must be (3, 3, Cin, Cout), got "
                         f"{tuple(w.shape)}")
    _check_cuda(x, w, scale, bias)
    plan = plan_conv3x3(*x.shape, w.shape[3], groups)
    route = _held_route(plan.route, None, x.dtype, "launch_3x3")
    if route in _ROUTE_CODE:
        res = _launch_sm90(x, w, scale, bias, groups, eps, relu, 1, plan)
    else:
        res = _launch(x, w, scale, bias, groups, eps, relu, 1)
    launches_3x3 += 1
    launches_3x3_by_route[route] += 1
    return res


class _Conv1x1GN(torch.autograd.Function):
    """B7 forward, ``_conv1x1_gn_bwd`` backward. Takes the whole x and the
    stride: the kernel reads the strided positions itself, and the
    backward scatters dx back onto them."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, groups, eps, relu, stride):
        s32, b32 = scale.detach().float(), bias.detach().float()
        if x.device.type == "cpu":
            out, mu, rstd = conv_gn_reference(x, w, s32, b32, groups, eps,
                                              relu, stride)
        else:
            out, mu, rstd = launch_1x1(x, w, s32.contiguous(),
                                       b32.contiguous(), groups, eps, relu,
                                       stride)
        ctx.save_for_backward(x, w, scale, bias, mu, rstd)
        ctx.args = (groups, relu, stride)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w, scale, bias, mu, rstd = ctx.saved_tensors
        groups, relu, stride = ctx.args
        xs = x[:, ::stride, ::stride, :] if stride != 1 else x
        b, ho, wo, cin = xs.shape
        cout = w.shape[-1]
        dx3, dw2, dscale, dbias = conv1x1_gn_backward(
            xs.reshape(b, ho * wo, cin), w.reshape(cin, cout), scale, bias,
            mu, rstd, dout.reshape(b, ho * wo, cout), groups, relu)
        dx = dx3.reshape(b, ho, wo, cin)
        if stride != 1:
            full = torch.zeros_like(x)
            full[:, ::stride, ::stride, :] = dx
            dx = full
        return dx, dw2.reshape(w.shape), dscale, dbias, None, None, None, None


class _Conv3x3GN(torch.autograd.Function):
    """B8 forward; backward by autograd of :func:`ref_conv3x3_gn`,
    recomputed from (x, w, scale, bias): no activation saved."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, groups, eps, relu):
        s32, b32 = scale.detach().float(), bias.detach().float()
        if x.device.type == "cpu":
            out, _, _ = conv_gn_reference(x, w, s32, b32, groups, eps, relu)
        else:
            out, _, _ = launch_3x3(x, w, s32.contiguous(), b32.contiguous(),
                                   groups, eps, relu)
        ctx.save_for_backward(x, w, scale, bias)
        ctx.args = (groups, eps, relu)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, w, scale, bias)]
            out = ref_conv3x3_gn(*leaves, *ctx.args)
            grads = torch.autograd.grad(out, leaves, dout)
        return (*grads, None, None, None)


def conv1x1_gn_relu(x: torch.Tensor, kernel: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, groups: int = 32,
                    eps: float = 1e-5, relu: bool = True,
                    stride: int = 1) -> torch.Tensor:
    """Fused ``relu(group_norm(conv1x1(x)))`` over NHWC (B7). ``kernel``:
    ``(1, 1, Cin, Cout)`` or ``(Cin, Cout)``; ``stride`` > 1 is the 1×1
    projection (the output keeps every stride-th position, as the JAX
    strided slice does). Differentiable."""
    if kernel.ndim == 2:
        kernel = kernel.reshape(1, 1, *kernel.shape)
    groups = _resolve_groups(groups, kernel.shape[-1])
    return _Conv1x1GN.apply(x.contiguous(), kernel.to(x.dtype).contiguous(),
                            scale, bias, groups, float(eps), bool(relu),
                            int(stride))


def conv3x3_gn_relu(x: torch.Tensor, kernel: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, groups: int = 32,
                    eps: float = 1e-5, relu: bool = True) -> torch.Tensor:
    """Fused ``relu(group_norm(conv3x3(x)))`` over NHWC (B8), stride 1,
    padding 1. ``kernel``: ``(3, 3, Cin, Cout)``. Differentiable."""
    groups = _resolve_groups(groups, kernel.shape[-1])
    return _Conv3x3GN.apply(x.contiguous(), kernel.to(x.dtype).contiguous(),
                            scale, bias, groups, float(eps), bool(relu))


__all__ = ["ConvPlan", "conv1x1_gn_backward", "conv1x1_gn_relu",
           "conv3x3_gn_relu", "conv_gn_reference", "ctas_per_sm_1x1",
           "launch_1x1", "launch_3x3", "launches_1x1",
           "launches_1x1_by_route", "launches_3x3", "launches_3x3_by_route",
           "plan_conv1x1", "plan_conv3x3", "ref_conv3x3_gn"]
