"""ResNet family (18/34/50/101) over NHWC with GroupNorm — the port of
``torchbooster_tpu/models/resnet.py``: basic blocks (two 3×3) for 18/34,
bottlenecks (1-3-1) for 50/101, the CIFAR (3×3/s1) and ImageNet (7×7/s2 +
max pool) stems, ``norm="group"`` and the frozen-BN ``"affine"`` norm, and
``swap_head``. Parameters are nested dicts of tensors in the JAX layout
(HWIO conv kernels, ``(in, out)`` head), so a JAX tree crosses leaf by
leaf (``interop.resnet_params_from_jax``).

Conv + GroupNorm pairs run through the fused kernels of
``ops/fused_block.py`` wherever :func:`_use_fused`'s structural gate
passes: B7 for 1×1 convs (the stride-2 projections included), B8 for
stride-1 3×3 convs. The rest run ``F.conv2d`` + ``layers.group_norm``,
whose GroupNorm is kernel B5/B6 on the card. On CPU tensors every kernel
wrapper runs its plain version. The JAX package's gate also asks that a
sample's working set fit the TPU's VMEM (``fits``/``fits3``); that is a
TPU limit, and the tiled CUDA kernels have none, so it is dropped (the
JAX gate refuses ResNet-50's 56²×64→256 conv3 at bf16; the port fuses it).

Not ported yet (``ROADMAP.md`` A10), each raising ``NotImplementedError``:
the norm-free ``norm="ws"`` variant, the space-to-depth stem
(``stem_s2d``) and ``load_torch_state``. ``SHARDING_RULES`` waits for the
meshes of A8."""
from __future__ import annotations

import torch

from torchbooster_tpu_torch._device import resolve_device
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


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md A10)")


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


class ResNet:
    """``ResNet.init(seed, depth, num_classes, stem, device)`` → params;
    ``ResNet.apply(params, x)`` → logits. The structure is read back from
    the parameter tree itself (block kind, stem, stages)."""

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
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(int(seed))
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
        return _to(params, dev)

    @staticmethod
    def apply(params: dict, x: torch.Tensor, norm: str = "group",
              fused: str | bool = "auto", pool_stem: bool | None = None,
              gn_impl: str = "auto", stem_s2d: bool = False) -> torch.Tensor:
        """Logits of NHWC images ``x``. ``fused``: the conv+GN kernels
        (B7/B8) where the gate passes (``_use_fused``); ``gn_impl``: the
        remaining GroupNorms' ``layers.group_norm`` impl (B5/B6 on the
        card by default). ``pool_stem`` defaults to the stem's own (on for
        the 7×7/s2 ImageNet stem)."""
        if norm == "ws":
            raise _unported("norm='ws' (the norm-free WS variant)")
        if norm not in ("group", "affine"):
            raise ValueError(f"norm must be 'group' or 'affine', got "
                             f"{norm!r}")
        if stem_s2d:
            raise _unported("stem_s2d (the space-to-depth stem)")
        stem = params["stem"]
        stem_stride = 2 if stem["conv"]["kernel"].shape[0] == 7 else 1
        if pool_stem is None:
            pool_stem = stem_stride == 2
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
    def swap_head(params: dict, seed: int | torch.Generator,
                  num_classes: int) -> dict:
        """Transfer-learning head swap: a fresh ``(din, num_classes)``
        head on the device of the old one."""
        old = params["head"]["kernel"]
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(int(seed))
        head = L.dense_init(gen, old.shape[0], num_classes)
        return {**params, "head": _to(head, old.device)}


def _to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def load_torch_state(*args, **kwargs):
    """Import of a torchvision ``state_dict`` (BN folded to frozen
    affines): not ported yet."""
    raise _unported("load_torch_state")


__all__ = ["ResNet", "load_torch_state"]
