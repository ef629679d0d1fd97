"""ResNet family (18/34/50/101) over NHWC with GroupNorm — the port of
``torchbooster_tpu/models/resnet.py``: basic blocks (two 3×3) for 18/34,
bottlenecks (1-3-1) for 50/101, the CIFAR (3×3/s1) and ImageNet (7×7/s2 +
max pool) stems, ``norm="group"``, the frozen-BN ``"affine"`` norm and the
norm-free ``"ws"`` variant, ``swap_head`` and ``load_torch_state``.
Parameters are nested dicts of tensors in the JAX layout (HWIO conv
kernels, ``(in, out)`` head), so a JAX tree crosses leaf by leaf
(``interop.resnet_params_from_jax``).

Conv + GroupNorm pairs run through the fused kernels of
``ops/fused_block.py`` wherever :func:`_use_fused`'s structural gate
passes: B7 for 1×1 convs (the stride-2 projections included), B8 for
stride-1 3×3 convs. The rest run ``F.conv2d`` + ``layers.group_norm``,
whose GroupNorm is kernel B5/B6 on the card. On CPU tensors every kernel
wrapper runs its plain version. The JAX package's gate also asks that a
sample's working set fit the TPU's VMEM (``fits``/``fits3``); that is a
TPU limit, and the tiled CUDA kernels have none, so it is dropped (the
JAX gate refuses ResNet-50's 56²×64→256 conv3 at bf16; the port fuses it).

``norm="ws"`` is the norm-free variant (NF-ResNet's scaled weight
standardization, :func:`_nf_apply`): the kernels are standardized and
the activations see plain ``F.conv2d`` + bias + scaled ReLU, so it
launches no B-kernel (in the JAX package too it runs no Pallas call).
Pair it with SGD-momentum or ``OptimizerConfig.agc``: large adaptive
learning rates diverge without one of the two. ``stem_s2d`` runs the
7×7/s2 ImageNet stem as a 4×4/s1 conv over a space-to-depth repack
(:func:`_stem_s2d`), exact by construction.

:func:`load_torch_state` imports a torchvision-layout ``state_dict``:
each BatchNorm folds into the exact frozen-BN affine ``a = γ/√(σ²+ε)``,
``b = β − μ·a``, run with ``apply(..., norm="affine")``, whose forward
equals torch's eval-mode forward up to float error.

``SHARDING_RULES`` shards the conv and projection kernels' output
channels over ``fsdp`` and the head's input. The fused kernels need the
whole conv kernel: ``utils.make_step(mesh=, rules=)`` gathers every
sharded leaf before the loss runs (``utils._local_grads`` through
``parallel.sharding.gather_leaf``), so B7/B8 always see whole kernels."""
from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from torchbooster_tpu_torch._device import resolve_device, seeded, tree_to
from torchbooster_tpu_torch.models import layers as L

# depth -> (block kind, stage repeats)
_CONFIGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
}
_STAGE_WIDTHS = (64, 128, 256, 512)
_GROUPS = 32


def _basic_block_init(gen, cin: int, cout: int, stride: int, dtype) -> dict:
    block = {
        "conv1": L.conv_init(gen, 3, cin, cout, use_bias=False, dtype=dtype),
        "norm1": L.norm_init(cout, dtype),
        "conv2": L.conv_init(gen, 3, cout, cout, use_bias=False, dtype=dtype),
        "norm2": L.norm_init(cout, dtype),
    }
    if stride != 1 or cin != cout:
        block["proj"] = L.conv_init(gen, 1, cin, cout, use_bias=False,
                                    dtype=dtype)
        block["proj_norm"] = L.norm_init(cout, dtype)
    return block


def _bottleneck_init(gen, cin: int, cmid: int, stride: int, dtype) -> dict:
    cout = cmid * 4
    block = {
        "conv1": L.conv_init(gen, 1, cin, cmid, use_bias=False, dtype=dtype),
        "norm1": L.norm_init(cmid, dtype),
        "conv2": L.conv_init(gen, 3, cmid, cmid, use_bias=False, dtype=dtype),
        "norm2": L.norm_init(cmid, dtype),
        "conv3": L.conv_init(gen, 1, cmid, cout, use_bias=False, dtype=dtype),
        "norm3": L.norm_init(cout, dtype),
    }
    if stride != 1 or cin != cout:
        block["proj"] = L.conv_init(gen, 1, cin, cout, use_bias=False,
                                    dtype=dtype)
        block["proj_norm"] = L.norm_init(cout, dtype)
    return block


def _norm(params: dict, x: torch.Tensor, norm: str, relu: bool,
          gn_impl: str) -> torch.Tensor:
    """``norm="group"``: GroupNorm. ``norm="affine"``: the frozen-BN
    per-channel affine (same {scale, bias} shapes)."""
    if norm == "affine":
        y = x * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)
        return torch.relu(y) if relu else y
    return L.group_norm(params, x, _GROUPS, relu=relu, impl=gn_impl)


def _use_fused(fused: str | bool, norm: str, x: torch.Tensor, cout: int,
               stride: int, three: bool) -> bool:
    """The conv+GN fusion gate, its structural conditions only:
    GroupNorm, stride 1 for a 3×3, and at least 8 input and output
    channels. ``fused`` True or ``"auto"`` engages the kernels wherever
    the gate passes; False never does."""
    if fused not in (True, False, "auto"):
        raise ValueError(f"fused must be True, False or 'auto', got "
                         f"{fused!r}")
    if norm != "group" or fused is False:
        return False
    if three and stride != 1:
        return False
    return x.shape[-1] >= 8 and cout >= 8


def _conv1x1_norm(conv_p: dict, norm_p: dict, x: torch.Tensor, norm: str,
                  relu: bool, stride: int, fused: str | bool,
                  gn_impl: str) -> torch.Tensor:
    cout = conv_p["kernel"].shape[-1]
    if _use_fused(fused, norm, x, cout, stride, three=False):
        from torchbooster_tpu_torch.ops.fused_block import conv1x1_gn_relu

        return conv1x1_gn_relu(x, conv_p["kernel"], norm_p["scale"],
                               norm_p["bias"], groups=_GROUPS, relu=relu,
                               stride=stride)
    return _norm(norm_p, L.conv(conv_p, x, stride=stride), norm, relu,
                 gn_impl)


def _conv3x3_norm(conv_p: dict, norm_p: dict, x: torch.Tensor, norm: str,
                  stride: int, fused: str | bool, relu: bool,
                  gn_impl: str) -> torch.Tensor:
    cout = conv_p["kernel"].shape[-1]
    if _use_fused(fused, norm, x, cout, stride, three=True):
        from torchbooster_tpu_torch.ops.fused_block import conv3x3_gn_relu

        return conv3x3_gn_relu(x, conv_p["kernel"], norm_p["scale"],
                               norm_p["bias"], groups=_GROUPS, relu=relu)
    return _norm(norm_p, L.conv(conv_p, x, stride=stride, padding=1), norm,
                 relu, gn_impl)


def _basic_block(params: dict, x: torch.Tensor, stride: int, norm: str,
                 fused: str | bool, gn_impl: str) -> torch.Tensor:
    y = _conv3x3_norm(params["conv1"], params["norm1"], x, norm, stride,
                      fused, True, gn_impl)
    y = _conv3x3_norm(params["conv2"], params["norm2"], y, norm, 1, fused,
                      False, gn_impl)
    if "proj" in params:
        x = _conv1x1_norm(params["proj"], params["proj_norm"], x, norm,
                          False, stride, fused, gn_impl)
    return torch.relu(x + y)


def _bottleneck(params: dict, x: torch.Tensor, stride: int, norm: str,
                fused: str | bool, gn_impl: str) -> torch.Tensor:
    y = _conv1x1_norm(params["conv1"], params["norm1"], x, norm, True, 1,
                      fused, gn_impl)
    y = _conv3x3_norm(params["conv2"], params["norm2"], y, norm, stride,
                      fused, True, gn_impl)
    y = _conv1x1_norm(params["conv3"], params["norm3"], y, norm, False, 1,
                      fused, gn_impl)
    if "proj" in params:
        x = _conv1x1_norm(params["proj"], params["proj_norm"], x, norm,
                          False, stride, fused, gn_impl)
    return torch.relu(x + y)


def _stem_s2d(kernel: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The 7×7/s2/pad-3 stem conv as a 4×4/s1 conv over a space-to-depth
    repack (JAX ``resnet.py:160``): x (B, H, W, C) → (B, H/2, W/2, 4C),
    channel ``(sy·2 + sx)·C + c`` = ``x[2u + sy, 2v + sx, c]``; tap ``ky``
    lands on s2d row ``u = (ky + 1) // 2``, phase ``sy = (ky + 1) % 2``,
    so the kernel, given one zero tap in front (8×8), reshapes to (4, 2,
    4, 2, C, O) → (4, 4, 4C, O) with no per-tap loop. Padding (2, 1) on
    each side, asymmetric, so x is padded before ``F.conv2d``. The same
    products as the plain stem, summed in another order."""
    b, h, w, c = x.shape
    cout = kernel.shape[-1]
    s = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    s = s.reshape(b, h // 2, w // 2, 4 * c)
    kp = F.pad(kernel, (0, 0, 0, 0, 1, 0, 1, 0))             # (8, 8, C, O)
    kp = kp.reshape(4, 2, 4, 2, c, cout).permute(0, 2, 1, 3, 4, 5)
    kp = kp.reshape(4, 4, 4 * c, cout).to(s.dtype)
    sc = F.pad(s.permute(0, 3, 1, 2), (2, 1, 2, 1))
    return F.conv2d(sc, kp.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def _use_s2d(stem_s2d: bool, stem_stride: int, x: torch.Tensor) -> bool:
    return stem_s2d and stem_stride == 2 and x.shape[1] % 2 == 0 \
        and x.shape[2] % 2 == 0


# -------------------------------------------------------- norm-free variant
# ``norm="ws"`` (JAX ``resnet.py:227-272``, ``:394-431``): every conv
# kernel is standardized per output channel and scaled by the norm's
# ``scale`` (the WS gain), the norm's ``bias`` is added after the conv,
# and blocks run pre-activation with analytic variance tracking,
# h_out = h + α·f(relu(h/β)·γ), β² growing by α² a block and reset at a
# transition — all Python floats.

# relu gain: Var(γ·relu(z)) = 1 for z ~ N(0, 1)
_GAMMA_RELU = float(np.sqrt(2.0 / (1.0 - 1.0 / np.pi)))
_NF_ALPHA = 0.2


def _ws_kernel(kernel: torch.Tensor, gain: torch.Tensor,
               eps: float = 1e-4) -> torch.Tensor:
    """Scaled weight standardization: per output channel zero mean and
    ``1/fan_in`` variance (the population variance over every dim but the
    last; ``fan_in`` = H·W·I), times the gain; statistics in fp32."""
    k = kernel.float()
    red = tuple(range(k.ndim - 1))
    mu = k.mean(dim=red, keepdim=True)
    var = k.var(dim=red, keepdim=True, correction=0)
    fan_in = float(math.prod(k.shape[:-1]))
    w = (k - mu) * torch.rsqrt(var * fan_in + eps)
    return (w * gain.float()).to(kernel.dtype)


def _nf_conv(conv_p: dict, norm_p: dict, x: torch.Tensor, stride: int = 1,
             padding: Any = 0) -> torch.Tensor:
    """WS conv + the per-channel bias (the norm's ``bias``)."""
    y = L.conv({"kernel": _ws_kernel(conv_p["kernel"], norm_p["scale"])},
               x, stride=stride, padding=padding)
    return y + norm_p["bias"].to(y.dtype)


def _nf_act(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x) * _GAMMA_RELU


def _nf_block(params: dict, x: torch.Tensor, stride: int,
              beta: float) -> torch.Tensor:
    """Pre-activation NF residual block (basic or bottleneck by key)."""
    y0 = _nf_act(x / beta)
    if "conv3" in params:
        y = _nf_act(_nf_conv(params["conv1"], params["norm1"], y0))
        y = _nf_act(_nf_conv(params["conv2"], params["norm2"], y,
                             stride=stride, padding=1))
        y = _nf_conv(params["conv3"], params["norm3"], y)
    else:
        y = _nf_act(_nf_conv(params["conv1"], params["norm1"], y0,
                             stride=stride, padding=1))
        y = _nf_conv(params["conv2"], params["norm2"], y, padding=1)
    if "proj" in params:
        x = _nf_conv(params["proj"], params["proj_norm"], y0, stride=stride)
    return x + _NF_ALPHA * y


def _nf_apply(params: dict, x: torch.Tensor, pool_stem: bool | None,
              stem_s2d: bool) -> torch.Tensor:
    """The ``norm="ws"`` forward: WS stem, pre-activation NF blocks with
    analytic β tracking, a last scaled activation, the head."""
    stem = params["stem"]
    stem_stride = 2 if stem["conv"]["kernel"].shape[0] == 7 else 1
    if pool_stem is None:
        pool_stem = stem_stride == 2
    if _use_s2d(stem_s2d, stem_stride, x):
        # s2d re-indexes exactly, so it takes the standardized kernel
        ws = _ws_kernel(stem["conv"]["kernel"], stem["norm"]["scale"])
        y = _stem_s2d(ws, x)
        x = y + stem["norm"]["bias"].to(y.dtype)
    else:
        x = _nf_conv(stem["conv"], stem["norm"], x, stride=stem_stride,
                     padding=3 if stem_stride == 2 else 1)
    if pool_stem:
        x = L.max_pool(x, 3, 2, padding=1)
    expected_var = 1.0
    si = 0
    while f"stage{si}" in params:
        stage = params[f"stage{si}"]
        bi = 0
        while f"block{bi}" in stage:
            block = stage[f"block{bi}"]
            stride = 2 if (bi == 0 and si > 0) else 1
            x = _nf_block(block, x, stride, float(np.sqrt(expected_var)))
            # a transition block's shortcut re-standardizes the signal
            expected_var = ((1.0 if "proj" in block else expected_var)
                            + _NF_ALPHA ** 2)
            bi += 1
        si += 1
    x = _nf_act(x / float(np.sqrt(expected_var)))
    return L.dense(params["head"], L.global_avg_pool(x))


# fsdp: conv and projection kernels shard their output channels, the head
# its input; a mesh without fsdp filters the rules away (replication)
SHARDING_RULES = [
    (r"(conv[0-9]*|proj)/kernel", (None, None, None, "fsdp")),
    (r"head/kernel", ("fsdp", None)),
    (r".*", ()),
]


class ResNet:
    """``ResNet.init(seed, depth, num_classes, stem, device)`` → params;
    ``ResNet.apply(params, x)`` → logits. The structure is read back from
    the parameter tree itself (block kind, stem, stages)."""

    SHARDING_RULES = SHARDING_RULES

    @staticmethod
    def init(seed: int | torch.Generator = 0, depth: int = 18,
             num_classes: int = 10, stem: str = "imagenet",
             device: str | torch.device = "cuda", in_channels: int = 3,
             dtype: torch.dtype = torch.float32) -> dict:
        """Weights drawn on the CPU from ``seed`` (an int or a
        ``torch.Generator``), so the same seed gives the same weights on
        every device, then moved to ``device``."""
        if depth not in _CONFIGS:
            raise ValueError(f"depth {depth} not in {sorted(_CONFIGS)}")
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"stem must be 'imagenet' or 'cifar', got "
                             f"{stem!r}")
        dev = resolve_device(device)
        gen = seeded(seed)
        kind, repeats = _CONFIGS[depth]
        params: dict = {"stem": {
            "conv": L.conv_init(gen, 7 if stem == "imagenet" else 3,
                                in_channels, 64, use_bias=False, dtype=dtype),
            "norm": L.norm_init(64, dtype)}}
        cin = 64
        for si, (width, n_blocks) in enumerate(zip(_STAGE_WIDTHS, repeats)):
            stage = {}
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                if kind == "basic":
                    stage[f"block{bi}"] = _basic_block_init(gen, cin, width,
                                                            stride, dtype)
                    cin = width
                else:
                    stage[f"block{bi}"] = _bottleneck_init(gen, cin, width,
                                                           stride, dtype)
                    cin = width * 4
            params[f"stage{si}"] = stage
        params["head"] = L.dense_init(gen, cin, num_classes, dtype=dtype)
        return tree_to(params, dev)

    @staticmethod
    def apply(params: dict, x: torch.Tensor, norm: str = "group",
              fused: str | bool = "auto", pool_stem: bool | None = None,
              gn_impl: str = "auto", stem_s2d: bool = False) -> torch.Tensor:
        """Logits of NHWC images ``x``. ``fused``: the conv+GN kernels
        (B7/B8) where the gate passes (``_use_fused``); ``gn_impl``: the
        remaining GroupNorms' ``layers.group_norm`` impl (B5/B6 on the
        card by default). ``pool_stem`` defaults to the stem's own (on for
        the 7×7/s2 ImageNet stem). ``norm="ws"``: the norm-free variant
        (:func:`_nf_apply`), which takes no fused kernel. ``stem_s2d``:
        the ImageNet stem as a space-to-depth conv (:func:`_stem_s2d`) on
        even H and W."""
        if norm == "ws":
            if fused not in ("auto", False):
                # no conv+GN kernel applies: there is no norm to fuse
                raise ValueError(
                    "fused conv+GN kernels do not apply to norm='ws' "
                    "(there is no norm in the activation path); drop "
                    "fused= or use norm='group'")
            return _nf_apply(params, x, pool_stem, stem_s2d)
        if norm not in ("group", "affine"):
            raise ValueError(f"norm must be 'group', 'affine' or 'ws', got "
                             f"{norm!r}")
        stem = params["stem"]
        stem_stride = 2 if stem["conv"]["kernel"].shape[0] == 7 else 1
        if pool_stem is None:
            pool_stem = stem_stride == 2
        if _use_s2d(stem_s2d, stem_stride, x):
            x = _stem_s2d(stem["conv"]["kernel"].to(x.dtype), x)
            if "bias" in stem["conv"]:
                x = x + stem["conv"]["bias"].to(x.dtype)
        else:
            x = L.conv(stem["conv"], x, stride=stem_stride,
                       padding=3 if stem_stride == 2 else 1)
        x = _norm(stem["norm"], x, norm, True, gn_impl)
        if pool_stem:
            x = L.max_pool(x, 3, 2, padding=1)
        si = 0
        while f"stage{si}" in params:
            stage = params[f"stage{si}"]
            bi = 0
            while f"block{bi}" in stage:
                block = stage[f"block{bi}"]
                stride = 2 if (bi == 0 and si > 0) else 1
                run = _bottleneck if "conv3" in block else _basic_block
                x = run(block, x, stride, norm, fused, gn_impl)
                bi += 1
            si += 1
        return L.dense(params["head"], L.global_avg_pool(x))

    @staticmethod
    def nf_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
        """``apply(params, x, norm="ws")``: the norm-free variant."""
        return ResNet.apply(params, x, norm="ws")

    @staticmethod
    def swap_head(params: dict, seed: int | torch.Generator,
                  num_classes: int) -> dict:
        """Transfer-learning head swap: a fresh ``(din, num_classes)``
        head on the device of the old one."""
        old = params["head"]["kernel"]
        gen = seeded(seed)
        head = L.dense_init(gen, old.shape[0], num_classes)
        return {**params, "head": tree_to(head, old.device)}


def _host(value: Any) -> torch.Tensor:
    """A state-dict value (tensor or array) → a CPU fp32 tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(value, np.float32))


def _fold_bn(sd: Mapping[str, Any], prefix: str, eps: float = 1e-5) -> dict:
    """A BatchNorm's running statistics and affine → the exact frozen-BN
    per-channel affine ``{scale: a, bias: b}``, in fp32."""
    gamma, beta = _host(sd[f"{prefix}.weight"]), _host(sd[f"{prefix}.bias"])
    mean = _host(sd[f"{prefix}.running_mean"])
    var = _host(sd[f"{prefix}.running_var"])
    a = gamma / torch.sqrt(var + eps)
    return {"scale": a, "bias": beta - mean * a}


def _conv_kernel(sd: Mapping[str, Any], key: str) -> dict:
    """torch OIHW conv weight → HWIO kernel."""
    return {"kernel": _host(sd[key]).permute(2, 3, 1, 0).contiguous()}


def load_torch_state(state_dict: Mapping[str, Any],
                     num_classes: int | None = None,
                     generator: int | torch.Generator | None = None,
                     device: str | torch.device = "cuda") -> dict:
    """ResNet parameters from a torchvision-layout ``state_dict`` (JAX
    ``resnet.py:434``; tensors or arrays, so a ``torch.load``-ed file
    works without torchvision). Depth and block kind are read from the
    keys; conv kernels go OIHW → HWIO, ``fc`` is transposed, and each
    BatchNorm folds into its frozen-BN affine (ε 1e-5): run the result
    with ``ResNet.apply(..., norm="affine")``.

    ``num_classes`` (with ``generator``, a seed or a
    ``torch.Generator``) swaps the classifier head for transfer learning;
    without it the imported head stays. The tree lands on ``device``."""
    dev = resolve_device(device)
    sd = state_dict
    params: dict = {"stem": {"conv": _conv_kernel(sd, "conv1.weight"),
                             "norm": _fold_bn(sd, "bn1")}}
    for si in range(4):
        lp = f"layer{si + 1}"
        stage: dict = {}
        bi = 0
        while f"{lp}.{bi}.conv1.weight" in sd:
            bp = f"{lp}.{bi}"
            block = {"conv1": _conv_kernel(sd, f"{bp}.conv1.weight"),
                     "norm1": _fold_bn(sd, f"{bp}.bn1"),
                     "conv2": _conv_kernel(sd, f"{bp}.conv2.weight"),
                     "norm2": _fold_bn(sd, f"{bp}.bn2")}
            if f"{bp}.conv3.weight" in sd:
                block["conv3"] = _conv_kernel(sd, f"{bp}.conv3.weight")
                block["norm3"] = _fold_bn(sd, f"{bp}.bn3")
            if f"{bp}.downsample.0.weight" in sd:
                block["proj"] = _conv_kernel(sd, f"{bp}.downsample.0.weight")
                block["proj_norm"] = _fold_bn(sd, f"{bp}.downsample.1")
            stage[f"block{bi}"] = block
            bi += 1
        params[f"stage{si}"] = stage
    w = _host(sd["fc.weight"])                          # (classes, cin)
    params["head"] = {"kernel": w.t().contiguous(),
                      "bias": _host(sd["fc.bias"])}
    params = tree_to(params, dev)
    if num_classes is not None and num_classes != w.shape[0]:
        if generator is None:
            raise ValueError("load_torch_state: a num_classes swap needs a "
                             "generator")
        params = ResNet.swap_head(params, generator, num_classes)
    return params


__all__ = ["SHARDING_RULES", "ResNet", "load_torch_state"]
