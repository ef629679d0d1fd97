"""GPT language model — the port of ``torchbooster_tpu/models/gpt.py``:
config, init, the training forward ``GPT.apply`` (per-block remat
under the JAX package's policy, attention through the ``ops.attention``
dispatcher), the block math, the cached-attention numerics core shared
by the dense ``generate`` control and the paged engine, the next-token
rules, and ``load_torch_gpt2``, the import of a HuggingFace GPT-2
checkpoint.

Layouts follow the JAX package so parameters cross frameworks with a
plain copy (``interop.params_from_jax``): block tensors are stacked on
a leading layer axis, dense kernels are ``(in, out)``, and the qkv
projection's columns are ``q | k | v`` at GQA widths. Not ported here
(``ROADMAP.md``): the tensor/expert/sequence/pipeline-parallel
branches (so LoRA deltas run at tp 1 only) and MoE blocks.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from torchbooster_tpu_torch._device import resolve_device
from torchbooster_tpu_torch.models import layers as L
from torchbooster_tpu_torch.models.torch_interop import to_numpy
from torchbooster_tpu_torch.ops.attention import NEG_INF, attention


@dataclass(frozen=True)
class GPTConfig:
    """GPT-2 small by default (``torchbooster_tpu/models/gpt.py:39``)."""
    vocab: int = 50257
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 0           # 0 → = n_heads (MHA)
    seq_len: int = 1024
    mlp_ratio: int = 4
    dropout: float = 0.0
    tie_embeddings: bool = True
    n_experts: int = 0
    pos: str = "learned"          # "learned" (wpe table) | "rope"
    rope_base: float = 10_000.0
    mlp: str = "gelu"             # "gelu" (tanh approx.) | "swiglu"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _check_cfg(cfg: GPTConfig) -> None:
    if cfg.n_heads % cfg.kv_heads:
        raise ValueError(f"n_heads={cfg.n_heads} not divisible by "
                         f"n_kv_heads={cfg.kv_heads}")
    if cfg.pos not in ("learned", "rope"):
        raise ValueError(f"unknown pos {cfg.pos!r}; use 'learned' or 'rope'")
    if cfg.mlp not in ("gelu", "swiglu"):
        raise ValueError(f"unknown mlp {cfg.mlp!r}; use 'gelu' or 'swiglu'")
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE blocks are not ported yet (ROADMAP.md A8)")


def _check_pos(params: dict, cfg: GPTConfig) -> None:
    """A rope checkpoint served with pos='learned' (or vice versa)
    would decode with no position signal: make it loud."""
    if cfg.pos == "rope" and "wpe" in params:
        raise ValueError("params carry a wpe table but cfg.pos='rope'")
    if cfg.pos != "rope" and "wpe" not in params:
        raise ValueError(f"params have no wpe table but cfg.pos={cfg.pos!r}")


class GPT:
    """``init(seed, cfg, device=...)`` → params (blocks stacked over the
    layer axis); ``apply(params, ids, cfg)`` → logits (B, S, vocab)."""

    Config = GPTConfig

    @staticmethod
    def init(seed: int | torch.Generator = 0, cfg: GPTConfig = GPTConfig(),
             device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        """GPT-2 init — N(0, 0.02), residual projections N(0, 0.02/√(2L)),
        wpe N(0, 0.01), zero biases, unit norms — drawn on the CPU from
        ``seed`` (an int or a ``torch.Generator``) so the same seed gives
        the same weights on every device, then moved to ``device``."""
        _check_cfg(cfg)
        dev = resolve_device(device)
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(int(seed))
        n, d = cfg.n_layers, cfg.d_model
        h = cfg.mlp_ratio * d
        res_std = 0.02 / math.sqrt(2 * n)
        qkv_out = d + 2 * cfg.kv_heads * cfg.head_dim

        def normal(shape, std):
            return torch.randn(shape, generator=gen) * std

        def norm():
            return {"scale": torch.ones(n, d), "bias": torch.zeros(n, d)}

        def dense(din, dout, std):
            return {"kernel": normal((n, din, dout), std),
                    "bias": torch.zeros(n, dout)}

        blocks = {"ln1": norm(), "attn_qkv": dense(d, qkv_out, 0.02),
                  "attn_proj": dense(d, d, res_std), "ln2": norm()}
        if cfg.mlp == "swiglu":
            hs = max((-(-2 * h // 3) + 7) // 8 * 8, 8)
            blocks.update({"mlp_fc1": dense(d, hs, 0.02),
                           "mlp_fc3": dense(d, hs, 0.02),
                           "mlp_fc2": dense(hs, d, res_std)})
        else:
            blocks.update({"mlp_fc1": dense(d, h, 0.02),
                           "mlp_fc2": dense(h, d, res_std)})
        params = {"wte": {"table": normal((cfg.vocab, d), 0.02)},
                  "blocks": blocks,
                  "ln_f": {"scale": torch.ones(d), "bias": torch.zeros(d)}}
        if cfg.pos != "rope":
            params["wpe"] = {"table": normal((cfg.seq_len, d), 0.01)}
        if not cfg.tie_embeddings:
            params["head"] = {"kernel": normal((d, cfg.vocab), 0.02)}
        return map_tensors(params, lambda t: t.to(device=dev, dtype=dtype))

    @staticmethod
    def apply(params: dict, ids: torch.Tensor, cfg: GPTConfig = GPTConfig(),
              compute_dtype: torch.dtype = torch.bfloat16,
              remat: bool = True, attn_impl: str = "auto",
              return_aux: bool = False, return_hidden: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Full causal forward → logits (B, S, vocab), or the final-norm
        hidden states (B, S, d) with ``return_hidden`` (for the chunked
        LM-head loss, ``ops.losses.lm_head_cross_entropy`` with
        :meth:`head_table`). Every leaf is cast to ``compute_dtype``
        where it is used, inside the differentiated function, so the
        gradients land on the fp32 masters. ``return_aux`` adds the MoE
        load-balance loss, 0 for these dense blocks.

        ``remat`` checkpoints each block under the JAX package's policy,
        ``dots_with_no_batch_dims_saveable``: the outputs of the block's
        dense products (``aten.mm``/``aten.addmm``, which a ``(B, S, d)
        @ (d, n)`` folds to) are saved, and everything else, the
        attention products with their batch dims among it, is recomputed
        in backward (non-reentrant ``torch.utils.checkpoint`` with a
        selective-checkpoint context). The attention kernels run outside
        the dispatcher's view, so the flash forward runs again in the
        recompute: twice per layer and step, as in the JAX package,
        whose policy saves no ``pallas_call`` output either.

        ``generator`` turns on ``cfg.dropout`` (the JAX ``dropout_rng``):
        inverted dropout on the embedding sum and on each block's
        attention-projection and MLP branches, masks drawn on the
        generator's device. Without one the forward is deterministic
        (eval, sampling). Each block's masks are drawn from a copy of
        the generator's state taken before the block runs (the JAX
        package splits its layer keys before the scan), so the remat
        recompute draws the forward's masks again, bit for bit; the
        generator then moves on past the block's draws."""
        b, s = ids.shape
        _check_pos(params, cfg)
        if s > cfg.seq_len:
            raise ValueError(f"sequence length {s} exceeds "
                             f"cfg.seq_len={cfg.seq_len}")
        drop = cfg.dropout if generator is not None else 0.0
        x = _dropout(_embed(params, ids, compute_dtype), drop, generator)

        def attend(q, k, v):
            # grouped K/V go to the dispatcher as they are: the flash
            # kernels index grouped rows, the reference expands them
            return attention(q, k, v, causal=True, impl=attn_impl), None

        def block(bp: dict, x: torch.Tensor, rng_state, after: list):
            gen = None
            if drop:
                gen = torch.Generator(generator.device)
                gen.set_state(rng_state)
            x = _block_core(bp, x, cfg, attend, dropout=drop,
                            generator=gen)[0]
            if drop:
                after[:] = [gen.get_state()]
            return x

        for i in range(cfg.n_layers):
            bp = layer_params(params["blocks"], i)
            rng_state = generator.get_state() if drop else None
            after: list = []
            if remat and torch.is_grad_enabled():
                x = checkpoint(block, bp, x, rng_state, after,
                               use_reentrant=False,
                               context_fn=_REMAT_CONTEXT)
            else:
                x = block(bp, x, rng_state, after)
            if drop:
                generator.set_state(after[0])
        out = L.layer_norm(params["ln_f"], x) if return_hidden \
            else _lm_head(params, x)
        if return_aux:
            return out, torch.zeros((), device=out.device)
        return out

    @staticmethod
    def head_table(params: dict) -> torch.Tensor:
        """(vocab, d) output-projection table — the ``table`` argument of
        ``ops.losses.lm_head_cross_entropy`` (tied: the wte table;
        untied: the head kernel transposed)."""
        if "head" in params:
            return params["head"]["kernel"].T
        return params["wte"]["table"]

    @staticmethod
    def generate(params: dict, ids: torch.Tensor, cfg: GPTConfig = GPTConfig(),
                 **kw) -> torch.Tensor:
        return generate(params, ids, cfg, **kw)


# the JAX remat policy: products without batch dims are saved
_SAVED_PRODUCTS = frozenset({torch.ops.aten.mm.default,
                             torch.ops.aten.addmm.default})


def _dots_with_no_batch_dims_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                   _dots_with_no_batch_dims_saveable)


def map_tensors(tree, fn):
    """Apply ``fn`` to every tensor leaf of a nested dict/tuple tree."""
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map_tensors(v, fn) for v in tree)
    return fn(tree)


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Floating leaves cast to ``dtype`` ONCE — numerically what the
    JAX package's per-op ``astype(x.dtype)`` computes, without paying
    the cast on every step. Quantized weights (``models/quant.py``) keep
    their integer leaves and their fp32 ``qscale``: the int4 unpack and
    the quantized embedding multiply by the scale in fp32."""
    return {k: cast_params(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if v.is_floating_point() and k != "qscale"
            else v for k, v in params.items()}


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``'s view of the stacked block tensors (no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _rope(x: torch.Tensor, positions: torch.Tensor,
          base: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding (rotate-half) over (B, S, H, D); ``positions``
    is (S,) shared or (B, S) per slot. Angles in fp32."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions.to(torch.float32)[..., None] * freqs
    if positions.ndim == 1:
        cos, sin = angles.cos()[None, :, None, :], angles.sin()[None, :, None, :]
    else:
        cos, sin = angles.cos()[:, :, None, :], angles.sin()[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _dropout(x: torch.Tensor, rate: float,
             generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout (``gpt.py:759``): keep each element with
    probability ``1 - rate`` and scale it by ``1 / (1 - rate)``, in x's
    dtype; the identity at rate 0 or without a generator. The mask is
    drawn on x's device from ``generator``, which lies there too."""
    if not rate or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _block_core(bp: dict, x: torch.Tensor, cfg: GPTConfig, attend,
                positions: torch.Tensor | None = None, dropout: float = 0.0,
                generator: torch.Generator | None = None, lora=None):
    """The transformer block shared by every path (full forward,
    prefill chunk, cached decode). ``attend(q, k, v) -> (o, extras)``
    supplies the attention flavor; ``dropout`` with a ``generator``
    drops the two residual branches (:func:`_dropout`). ``lora`` =
    ``((a_qkv, b_qkv, a_proj, b_proj), lane_ids)``, this layer's
    adapter stacks ``(lanes, ...)`` and one lane id a batch row
    (``gpt.py:872``): row b adds ``h @ A[g] @ B[g]`` of its lane g to the
    qkv output and to the O projection before its bias, each stack cast
    to the activations' dtype, so lane 0's zero stacks are an exact
    no-op. Returns ``(x, extras)``."""
    b, s, d = x.shape
    n_heads, kv_heads, head_dim = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    h = L.layer_norm(bp["ln1"], x)
    qkv = L.dense(bp["attn_qkv"], h)
    if lora is not None:
        (la_q, lb_q, la_p, lb_p), lane_ids = lora
        dq = torch.einsum("bsd,bdr->bsr", h, la_q[lane_ids].to(h.dtype))
        qkv = qkv + torch.einsum("bsr,bro->bso", dq,
                                 lb_q[lane_ids].to(h.dtype))
    q_width, kv_dim = n_heads * head_dim, kv_heads * head_dim
    q = qkv[..., :q_width].reshape(b, s, n_heads, head_dim)
    k = qkv[..., q_width:q_width + kv_dim].reshape(b, s, kv_heads, head_dim)
    v = qkv[..., q_width + kv_dim:].reshape(b, s, kv_heads, head_dim)
    if cfg.pos == "rope":
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = _rope(q, positions, cfg.rope_base)
        k = _rope(k, positions, cfg.rope_base)
    o, extras = attend(q, k, v)
    o_flat = o.reshape(b, s, q_width)
    proj_delta = None
    if lora is not None:
        dp = torch.einsum("bsd,bdr->bsr", o_flat,
                          la_p[lane_ids].to(o_flat.dtype))
        proj_delta = torch.einsum("bsr,bro->bso", dp,
                                  lb_p[lane_ids].to(o_flat.dtype))
    x = x + _dropout(L.dense(bp["attn_proj"], o_flat, delta=proj_delta),
                     dropout, generator)
    h = L.layer_norm(bp["ln2"], x)
    if "mlp_fc3" in bp:
        h = F.silu(L.dense(bp["mlp_fc1"], h)) * L.dense(bp["mlp_fc3"], h)
    else:   # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(L.dense(bp["mlp_fc1"], h), approximate="tanh")
    return x + _dropout(L.dense(bp["mlp_fc2"], h), dropout,
                        generator), extras


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(token, head) int8: ``q = round(x / s)``, ``s =
    absmax/127`` stored bf16, and the division uses the ROUNDED bf16
    scale so the stored pair is self-consistent. Returns ``(int8
    values, bf16 scales (..., 1))``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-8).to(torch.bfloat16)
    q = torch.round(xf / scale.float()).clamp(-127, 127).to(torch.int8)
    return q, scale


def _grouped_cache_attention(q: torch.Tensor, cache_k, cache_v,
                             visible: torch.Tensor, *, state: bool = False):
    """The cached-attention numerics core (``gpt.py:956``) shared by
    the dense decode control and the paged engine. q is (B, S_q, H,
    Dh); caches are (B, T, H_kv, Dh) — plain tensors or ``(int8
    values, bf16 scales)`` pairs; ``visible`` broadcasts against the
    (B, g, rep, S_q, T) scores. Dot operands are the cache dtype (the
    query dtype for int8 caches) with fp32 accumulation; the int8
    scales factor out of both dots.

    ``state=False`` → normalized (B, S_q, H, Dh) in ``q.dtype``;
    ``state=True`` → the flash partial ``(o fp32 (B, S_q, g, rep, Dh),
    m (B, g, rep, S_q), l (B, g, rep, S_q))``."""
    b, s_q, n_heads, head_dim = q.shape
    quantized = isinstance(cache_k, tuple)
    if quantized:
        (ck, ck_s), (cv, cv_s) = cache_k, cache_v
    else:
        ck, cv = cache_k, cache_v
    kv_heads = ck.shape[2]
    rep = n_heads // kv_heads
    qg = q.reshape(b, s_q, kv_heads, rep, head_dim)
    dot_t = q.dtype if quantized else ck.dtype
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(dot_t).float(),
                          ck.to(dot_t).float()) / (head_dim ** 0.5)
    if quantized:
        scores = scores * ck_s[..., 0].float().transpose(1, 2)[:, :, None, None, :]
    scores = torch.where(visible, scores, torch.full_like(scores, NEG_INF))
    if state:
        m = scores.amax(dim=-1)
        probs = torch.exp(scores - m[..., None])
        l = probs.sum(dim=-1)
    else:
        probs = torch.softmax(scores, dim=-1)
    if quantized:
        probs = probs * cv_s[..., 0].float().transpose(1, 2)[:, :, None, None, :]
        probs = probs.to(dot_t).float()
        pv = cv.to(dot_t).float()
    else:
        pv = cv.float()
    o = torch.einsum("bgrqk,bkgd->bqgrd", probs, pv)
    if state:
        return o, m, l
    return o.to(q.dtype).reshape(b, s_q, n_heads, head_dim)


def _cached_block(bp: dict, x: torch.Tensor, cache_k, cache_v, pos: int,
                  cfg: GPTConfig) -> torch.Tensor:
    """One decode step through one block at position ``pos``: this
    token's K/V are written into the (B, S_cache, H_kv, Dh) caches IN
    PLACE, then attended with everything ``<= pos``."""
    quantized = isinstance(cache_k, tuple)
    s_cache = (cache_k[0] if quantized else cache_k).shape[1]

    def attend(q, k, v):
        if quantized:
            for cache, new in ((cache_k, k), (cache_v, v)):
                vals, scales = _quantize_kv(new)
                cache[0][:, pos] = vals[:, 0]
                cache[1][:, pos] = scales[:, 0]
        else:
            cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
            cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
        visible = torch.arange(s_cache, device=x.device) <= pos
        return _grouped_cache_attention(q, cache_k, cache_v, visible), None

    x, _ = _block_core(bp, x, cfg, attend,
                       positions=torch.tensor([pos], device=x.device))
    return x


def _lm_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.layer_norm(params["ln_f"], x)
    if "head" in params:
        return L.dense(params["head"], x)
    wte = params["wte"]
    if "qtable" in wte:
        # tied head over the per-row int8 table: each row's scale lands
        # on the vocab axis of the logits (``gpt.py:1091``)
        y = x @ wte["qtable"].to(x.dtype).T
        return y * wte["qscale"][:, 0].to(x.dtype)
    return x @ wte["table"].to(x.dtype).T


def _mask_logits(logits: torch.Tensor,
                 mask: torch.Tensor | None) -> torch.Tensor:
    """Legality mask: forbidden positions drop to the dtype's finite
    minimum (never -inf); ``None`` is an exact no-op."""
    if mask is None:
        return logits
    return torch.where(mask, logits,
                       torch.full_like(logits, torch.finfo(logits.dtype).min))


def _filter_logits(logits: torch.Tensor, temperature: float,
                   top_k: int | None, top_p: float | None,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Temperature-scaled, top-k then top-p filtered fp32 logits (top-p
    mass measured over the top-k-filtered distribution)."""
    logits = _mask_logits(logits, mask).float() / temperature
    if top_k is not None or top_p is not None:
        desc = torch.sort(logits, dim=-1, descending=True).values
        neg = torch.tensor(-math.inf, device=logits.device)
        if top_k is not None:
            logits = torch.where(logits < desc[..., top_k - 1:top_k],
                                 neg, logits)
            keep_k = torch.arange(desc.shape[-1], device=desc.device) < top_k
            desc = torch.where(keep_k, desc, neg)
        if top_p is not None:
            probs = torch.softmax(desc, dim=-1)
            keep = probs.cumsum(dim=-1) - probs < top_p
            thresh = torch.where(keep, desc, -neg).amin(dim=-1, keepdim=True)
            logits = torch.where(logits >= thresh, logits, neg)
    return logits


def _make_pick(temperature: float, top_k: int | None, top_p: float | None):
    """``pick(generator, logits) -> ids``: greedy argmax at temperature
    0 (ties go to the LOWEST id), else a categorical draw over
    :func:`_filter_logits` from the given ``torch.Generator``."""

    def pick(gen: torch.Generator | None,
             logits: torch.Tensor) -> torch.Tensor:
        if temperature == 0:
            return torch.argmax(logits, dim=-1)
        return _sample(gen, _filter_logits(logits, temperature, top_k, top_p))

    return pick


def _sample(gen: torch.Generator | None,
            logits: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row of ``(..., vocab)`` fp32 logits."""
    probs = torch.softmax(logits.reshape(-1, logits.shape[-1]), dim=-1)
    return torch.multinomial(probs, 1, generator=gen).reshape(
        logits.shape[:-1])


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def branch_generator(seed: int, branch: int, depth: int,
                     device: torch.device) -> torch.Generator:
    """The generator of branch ``branch``'s pick at context length
    ``depth``: seeded from a fixed mix of the three integers, so the
    token a branch samples there is a pure function of ``(seed, branch,
    depth, logits)``, whatever else shares the batch — the port's
    counterpart of the JAX engine's ``fold_in(fold_in(key, branch),
    depth)`` (JAX PRNG streams cannot be reproduced in torch)."""
    mixed = _splitmix64(_splitmix64(_splitmix64(int(seed)) ^ int(branch))
                        ^ int(depth))
    return torch.Generator(device=device).manual_seed(mixed >> 1)


def _make_branch_pick(temperature: float, top_k: int | None,
                      top_p: float | None):
    """``pick(gens, logits) -> (ids, logprobs)``, the per-branch rule of
    copy-on-write parallel sampling (``gpt.py:1181``): ``logits`` is
    ``(B, vocab)`` and ``gens`` one :func:`branch_generator` per row
    (``None`` rows take the filtered argmax: slots nobody reads).
    ``logprobs`` are the picked ids' log-probabilities under the
    distribution sampled from — the filtered one at ``temperature > 0``,
    the raw softmax under greedy — which ``best_of`` ranks by."""

    def pick(gens, logits: torch.Tensor):
        if temperature == 0:
            ids = torch.argmax(logits, dim=-1)
            lp = torch.log_softmax(logits.float(), dim=-1)
        else:
            f = _filter_logits(logits, temperature, top_k, top_p)
            ids = torch.argmax(f, dim=-1)
            for i, gen in enumerate(gens):
                if gen is not None:
                    ids[i] = _sample(gen, f[i])
            lp = torch.log_softmax(f, dim=-1)
        return ids, torch.gather(lp, -1, ids[:, None])[:, 0]

    return pick


def _make_spec_pick(temperature: float, top_k: int | None,
                    top_p: float | None):
    """``verify(gen, logits, draft, parent=None) -> (accept, token)``,
    the per-position pick and acceptance rule of speculative decoding
    (``gpt.py:1216``). ``logits`` is ``(B, K + 1, vocab)``, ``draft``
    ``(B, K)`` proposed ids with ``-1`` for no proposal (never
    accepted). Greedy: ``accept = argmax == draft`` and ``token`` the
    argmax chain, so emitting ``draft[:a] + [token[a]]`` is the
    non-speculative greedy stream exactly. ``temperature > 0``:
    rejection sampling against the point-mass draft over
    :func:`_filter_logits` — accept ``d_j`` with probability
    ``p_j(d_j)``, on rejection sample ``p_j`` without ``d_j``, and a
    bonus sample from ``p_K``; draws come from ``gen``. ``parent``
    (greedy only) tests each tree node's token against the pick at its
    parent node; the chain ``parent[j] = j`` is the linear rule."""

    def verify(gen: torch.Generator | None, logits: torch.Tensor,
               draft: torch.Tensor, parent: torch.Tensor | None = None):
        k = draft.shape[1]
        valid = draft >= 0
        if temperature == 0:
            picks = torch.argmax(logits, dim=-1)
            at = picks[:, :k] if parent is None \
                else torch.gather(picks, 1, parent.long())
            return valid & (at == draft), picks
        if parent is not None:
            raise ValueError(
                "tree-structured speculative verification is greedy-only: "
                "sampling acceptance over sibling branches needs "
                "without-replacement residuals (set temperature=0 for "
                "spec_tree)")
        f = _filter_logits(logits, temperature, top_k, top_p)
        d_c = draft.clamp(0, logits.shape[-1] - 1).long()
        p_d = torch.gather(torch.softmax(f[:, :k], dim=-1), 2,
                           d_c[..., None])[..., 0]
        u = torch.rand(draft.shape, generator=gen, device=logits.device)
        accept = valid & (u < p_d)
        hit = F.one_hot(d_c, logits.shape[-1]).bool() & valid[..., None]
        resid = f[:, :k].masked_fill(hit, -math.inf)
        # a draft that held all the filtered mass leaves an empty
        # residual; it is always accepted (u < 1), so its stand-in, the
        # unmasked row, is never emitted
        empty = torch.isneginf(resid).all(dim=-1, keepdim=True)
        resid = torch.where(empty, f[:, :k], resid)
        bonus = _sample(gen, f[:, k])
        return accept, torch.cat([_sample(gen, resid), bonus[:, None]], dim=1)

    return verify


def _embed(params: dict, ids: torch.Tensor,
           compute_dtype: torch.dtype) -> torch.Tensor:
    """Token (+ learned position) embeddings in ``compute_dtype``."""
    x = L.embedding(params["wte"], ids, dtype=compute_dtype)
    if "wpe" in params:
        x = x + L.embedding(params["wpe"],
                            torch.arange(ids.shape[1], device=ids.device),
                            dtype=compute_dtype)
    return x


def _prefill_forward(params: dict, ids: torch.Tensor, cfg: GPTConfig,
                     compute_dtype: torch.dtype):
    """Full prompt forward collecting per-layer K/V, attending through
    the dispatcher as ``gpt.py:1320`` does. Returns ``(x, ks, vs)`` with
    x (B, S, d) and ks/vs stacked (L, B, S, kv_heads, Dh)."""
    x = _embed(params, ids, compute_dtype)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _block_core(
            layer_params(params["blocks"], i), x, cfg,
            lambda q, k, v: (attention(q, k, v, causal=True), (k, v)))
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def generate(params: dict, ids: torch.Tensor, cfg: GPTConfig = GPTConfig(),
             n_new: int = 32, generator: torch.Generator | None = None,
             temperature: float = 1.0, top_k: int | None = None,
             top_p: float | None = None,
             compute_dtype: torch.dtype = torch.bfloat16,
             cache_dtype: str | None = None) -> torch.Tensor:
    """Dense KV-cache decoding — the control every serving test is
    held to (``gpt.py:1329``). Prefill runs the whole prompt once, then
    ``n_new`` tokens decode one at a time against a static-shape cache
    (``cache_dtype="int8"`` stores ``_quantize_kv`` pairs). Returns
    (B, S_prompt + n_new) ids."""
    b, s0 = ids.shape
    if s0 + n_new > cfg.seq_len:
        raise ValueError(f"prompt {s0} + n_new {n_new} exceeds "
                         f"cfg.seq_len={cfg.seq_len}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if cache_dtype not in (None, "int8"):
        raise ValueError(f"cache_dtype must be None or 'int8', got "
                         f"{cache_dtype!r}")
    if n_new == 0:
        return ids
    _check_pos(params, cfg)
    params = cast_params(params, compute_dtype)
    x, ks, vs = _prefill_forward(params, ids, cfg, compute_dtype)
    s_total = s0 + n_new

    def padded(t):
        out = torch.zeros((*t.shape[:2], s_total, *t.shape[3:]),
                          dtype=t.dtype, device=t.device)
        out[:, :, :s0] = t
        return out

    if cache_dtype == "int8":
        cache_k = tuple(padded(t) for t in _quantize_kv(ks))
        cache_v = tuple(padded(t) for t in _quantize_kv(vs))
        layer_cache = lambda c, i: (c[0][i], c[1][i])
    else:
        cache_k = padded(ks.to(compute_dtype))
        cache_v = padded(vs.to(compute_dtype))
        layer_cache = lambda c, i: c[i]
    pick = _make_pick(temperature, top_k, top_p)
    last = pick(generator, _lm_head(params, x[:, -1:])[:, 0])
    out = [last]
    for pos in range(s0, s_total - 1):
        x = L.embedding(params["wte"], last[:, None], dtype=compute_dtype)
        if "wpe" in params:
            x = x + params["wpe"]["table"][pos].to(compute_dtype)
        for i in range(cfg.n_layers):
            x = _cached_block(layer_params(params["blocks"], i), x,
                              layer_cache(cache_k, i),
                              layer_cache(cache_v, i), pos, cfg)
        last = pick(generator, _lm_head(params, x)[:, 0])
        out.append(last)
    return torch.cat([ids, torch.stack(out, dim=1).to(ids.dtype)], dim=1)


# GPT-2's published widths: d_model → heads
_GPT2_HEADS = {768: 12, 1024: 16, 1280: 20, 1600: 25}


def load_torch_gpt2(state_dict, n_heads: int | None = None,
                    device: str | torch.device = "cuda"
                    ) -> tuple[dict, GPTConfig]:
    """``(params, cfg)`` from a HuggingFace GPT-2 ``state_dict``
    (``gpt.py:1456``): ``GPT2Model`` or ``GPT2LMHeadModel`` keys, with
    or without the ``transformer.`` prefix, torch tensors or numpy
    arrays. HF's Conv1D weights are ``(in, out)``, this package's dense
    ``kernel`` layout, so every tensor maps without a transpose; the
    per-layer tensors stack onto the leading layer axis. GPT-2 ties its
    head to ``wte``, so ``lm_head.weight`` is ignored and the model is
    tied; so are HF's attention buffers. ``n_heads`` defaults from
    d_model through GPT-2's family table (768, 1024, 1280, 1600) and
    raises ``ValueError`` for other widths. The params come back in fp32
    on ``device``; ``cfg.seq_len`` is the checkpoint's ``n_positions``."""
    sd = {(k[12:] if k.startswith("transformer.") else k): v
          for k, v in state_dict.items()}
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("h."))
    vocab, d_model = to_numpy(sd["wte.weight"]).shape
    n_pos = to_numpy(sd["wpe.weight"]).shape[0]
    if n_heads is None:
        if d_model not in _GPT2_HEADS:
            raise ValueError(f"n_heads not inferable for d_model={d_model}; "
                             f"pass n_heads= explicitly")
        n_heads = _GPT2_HEADS[d_model]
    cfg = GPTConfig(vocab=vocab, n_layers=n_layers, d_model=d_model,
                    n_heads=n_heads, seq_len=n_pos, tie_embeddings=True)
    dev = resolve_device(device)

    def leaf(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.float32)).to(dev)

    def one(key: str) -> torch.Tensor:
        return leaf(to_numpy(sd[key]))

    def stack(fmt: str) -> torch.Tensor:
        return leaf(np.stack([to_numpy(sd[fmt.format(i)])
                              for i in range(n_layers)]))

    def pair(fmt: str, names=("kernel", "bias")) -> dict:
        return {names[0]: stack(f"h.{{}}.{fmt}.weight"),
                names[1]: stack(f"h.{{}}.{fmt}.bias")}

    norm = ("scale", "bias")
    blocks = {"ln1": pair("ln_1", names=norm),
              "attn_qkv": pair("attn.c_attn"),
              "attn_proj": pair("attn.c_proj"),
              "ln2": pair("ln_2", names=norm),
              "mlp_fc1": pair("mlp.c_fc"),
              "mlp_fc2": pair("mlp.c_proj")}
    params = {"wte": {"table": one("wte.weight")},
              "wpe": {"table": one("wpe.weight")},
              "blocks": blocks,
              "ln_f": {"scale": one("ln_f.weight"), "bias": one("ln_f.bias")}}
    return params, cfg


__all__ = ["GPT", "GPTConfig", "cast_params", "generate", "layer_params",
           "load_torch_gpt2", "map_tensors"]
