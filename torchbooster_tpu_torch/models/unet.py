"""Time-conditioned UNet, the denoiser of the DDPM family — the port of
``torchbooster_tpu/models/unet.py``. NHWC throughout, GroupNorm of 8
groups, downsampling by a stride-2 3×3 conv, upsampling by a nearest ×2
repeat and a 3×3 conv.

Structure (per resolution level ``i`` with width ``base·mults[i]``):
down: 2 × ResBlock → strided conv; middle: 2 × ResBlock; up: concat skip
→ 2 × ResBlock → upsample-conv; then GroupNorm, SiLU and the output conv.
Every ResBlock adds a per-block projection of the sinusoidal time
embedding to its hidden activation.

Each of the 29 GroupNorms of a forward at the default widths (two a
ResBlock, 14 ResBlocks, and ``out_norm``) goes through
``layers.group_norm`` with ``impl="auto"``: on a CUDA tensor B5 forward
and B6 backward (``ops/group_norm.py``), on the route their plans give.
SiLU stays a separate op: the kernels
fuse only ReLU. The time embedding is fp32 (JAX ``:43-50``), and an
fp32 tensor added to a bf16 one promotes to fp32, in torch as in JAX:
with bf16 images and weights only the first GroupNorm sees bf16, and
every activation after the first ResBlock's time projection is fp32.

Across ranks ``SHARDING_RULES`` shards the conv kernels' output
channels and the time projections' input over ``fsdp``;
``utils.make_step(mesh=, rules=)`` gathers each sharded leaf before the
loss (``utils._local_grads``), so ``F.conv2d`` sees whole kernels."""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from torchbooster_tpu_torch._device import resolve_device, seeded, tree_to
from torchbooster_tpu_torch.models import layers as L

_GROUPS = 8


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 1
    base: int = 64
    mults: tuple = (1, 2, 2)
    time_dim: int = 256
    # class-conditional generation: n_classes > 0 adds a label
    # embedding folded into the time embedding; label id n_classes is
    # the NULL class (classifier-free guidance's unconditional token)
    n_classes: int = 0


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of integer timesteps t (B,) → (B, dim); fp32
    angles (bf16 t·freq products alias at large T)."""
    half = dim // 2
    # filled on the device, not copied from the host: a CUDA-graph
    # capture of the step cannot copy
    log = torch.log(torch.full((), 10_000.0, device=t.device))
    freqs = torch.exp(-log * torch.arange(half, dtype=torch.float32,
                                          device=t.device) / half)
    angles = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 over NHWC: each pixel repeated into a 2×2 block (what
    ``jax.image.resize(..., "nearest")`` gives at exactly twice the
    size)."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, h * 2, w * 2, c)


def _resblock_init(gen: torch.Generator, cin: int, cout: int, time_dim: int,
                   dtype: torch.dtype) -> dict:
    block = {
        "norm1": L.norm_init(cin, dtype),
        "conv1": L.conv_init(gen, 3, cin, cout, dtype=dtype),
        "time_proj": L.dense_init(gen, time_dim, cout, dtype=dtype),
        "norm2": L.norm_init(cout, dtype),
        "conv2": L.conv_init(gen, 3, cout, cout, dtype=dtype),
    }
    if cin != cout:
        block["skip"] = L.conv_init(gen, 1, cin, cout, dtype=dtype)
    return block


def _resblock(bp: dict, x: torch.Tensor, temb: torch.Tensor,
              gn_impl: str) -> torch.Tensor:
    h = F.silu(L.group_norm(bp["norm1"], x, _GROUPS, impl=gn_impl))
    h = L.conv(bp["conv1"], h, padding=1)
    h = h + L.dense(bp["time_proj"], F.silu(temb))[:, None, None, :]
    h = F.silu(L.group_norm(bp["norm2"], h, _GROUPS, impl=gn_impl))
    h = L.conv(bp["conv2"], h, padding=1)
    if "skip" in bp:
        x = L.conv(bp["skip"], x)
    return x + h


# fsdp: conv kernels shard the output-channel dim, the dense time
# projections their input dim; dp-only meshes filter these away
SHARDING_RULES = [
    (r"time_mlp[12]/kernel", ("fsdp", None)),
    (r"time_proj/kernel", ("fsdp", None)),
    # every remaining kernel is a 4-d conv (stem, res conv1/2, skip,
    # *_pool, up*_conv, out_conv)
    (r"kernel", (None, None, None, "fsdp")),
    (r".*", ()),
]


class UNet:
    """``init(seed, cfg, device)`` → params; ``apply(params, x, t, cfg)``
    → predicted noise ε with x's shape. ``t`` is (B,) integer steps."""

    Config = UNetConfig
    SHARDING_RULES = SHARDING_RULES

    @staticmethod
    def init(seed: int | torch.Generator = 0, cfg: UNetConfig = UNetConfig(),
             device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        """Weights drawn on the CPU from ``seed`` (an int or a
        ``torch.Generator``) with the JAX package's distributions, then
        moved to ``device``."""
        if cfg.time_dim % 2:
            # sinusoidal embedding emits 2*(dim//2) features; an odd
            # dim would die later as an opaque matmul shape mismatch
            raise ValueError(f"time_dim must be even, got {cfg.time_dim}")
        dev = resolve_device(device)
        gen = seeded(seed)
        widths = [cfg.base * m for m in cfg.mults]
        n_levels = len(widths)
        td = cfg.time_dim
        params: dict = {
            "time_mlp1": L.dense_init(gen, td, td, dtype=dtype),
            "time_mlp2": L.dense_init(gen, td, td, dtype=dtype),
            "stem": L.conv_init(gen, 3, cfg.in_channels, widths[0],
                                dtype=dtype),
        }
        if cfg.n_classes:
            # +1 row: the NULL (unconditional) class for CFG
            params["label_emb"] = L.embedding_init(
                gen, cfg.n_classes + 1, td, dtype=dtype)
        cin = widths[0]
        for i, w in enumerate(widths):
            params[f"down{i}_a"] = _resblock_init(gen, cin, w, td, dtype)
            params[f"down{i}_b"] = _resblock_init(gen, w, w, td, dtype)
            cin = w
            if i < n_levels - 1:
                params[f"down{i}_pool"] = L.conv_init(gen, 3, w, w,
                                                      dtype=dtype)
        params["mid_a"] = _resblock_init(gen, cin, cin, td, dtype)
        params["mid_b"] = _resblock_init(gen, cin, cin, td, dtype)
        for i in reversed(range(n_levels)):
            w = widths[i]
            # input: current features + the level's skip (concat)
            params[f"up{i}_a"] = _resblock_init(gen, cin + w, w, td, dtype)
            params[f"up{i}_b"] = _resblock_init(gen, w, w, td, dtype)
            cin = w
            if i > 0:
                params[f"up{i}_conv"] = L.conv_init(gen, 3, w,
                                                    widths[i - 1],
                                                    dtype=dtype)
                cin = widths[i - 1]
        params["out_norm"] = L.norm_init(cin, dtype)
        params["out_conv"] = L.conv_init(gen, 3, cin, cfg.in_channels,
                                         dtype=dtype)
        return tree_to(params, dev)

    @staticmethod
    def apply(params: dict, x: torch.Tensor, t: torch.Tensor,
              cfg: UNetConfig = UNetConfig(),
              labels: torch.Tensor | None = None,
              gn_impl: str = "auto") -> torch.Tensor:
        """ε̂ for NHWC ``x`` at steps ``t``. ``gn_impl`` is the
        GroupNorms' ``layers.group_norm`` impl: ``"auto"`` (B5/B6 on the
        card) or ``"plain"``."""
        n_levels = len(cfg.mults)
        temb = time_embedding(t, cfg.time_dim)
        temb = L.dense(params["time_mlp2"],
                       F.silu(L.dense(params["time_mlp1"], temb)))
        if cfg.n_classes:
            if labels is None:   # unconditional: the NULL class
                labels = torch.full((x.shape[0],), cfg.n_classes,
                                    dtype=torch.long, device=x.device)
            temb = temb + L.embedding(params["label_emb"], labels)

        h = L.conv(params["stem"], x, padding=1)
        skips = []
        for i in range(n_levels):
            h = _resblock(params[f"down{i}_a"], h, temb, gn_impl)
            h = _resblock(params[f"down{i}_b"], h, temb, gn_impl)
            skips.append(h)
            if i < n_levels - 1:
                h = L.conv(params[f"down{i}_pool"], h, stride=2, padding=1)
        h = _resblock(params["mid_a"], h, temb, gn_impl)
        h = _resblock(params["mid_b"], h, temb, gn_impl)
        for i in reversed(range(n_levels)):
            h = torch.cat([h, skips[i]], dim=-1)
            h = _resblock(params[f"up{i}_a"], h, temb, gn_impl)
            h = _resblock(params[f"up{i}_b"], h, temb, gn_impl)
            if i > 0:
                h = L.conv(params[f"up{i}_conv"], upsample2(h), padding=1)
        h = F.silu(L.group_norm(params["out_norm"], h, _GROUPS,
                                impl=gn_impl))
        return L.conv(params["out_conv"], h, padding=1)


__all__ = ["SHARDING_RULES", "UNet", "UNetConfig", "time_embedding",
           "upsample2"]
