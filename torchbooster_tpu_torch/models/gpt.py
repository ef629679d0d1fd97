"""GPT language model — the port of ``torchbooster_tpu/models/gpt.py``:
config, init, the training forward ``GPT.apply`` (per-block remat
under the JAX package's policy, attention through the ``ops.attention``
dispatcher, or on an ``sp`` mesh through
``parallel.ulysses.sequence_attention``), the block math with dense or
MoE (``models/moe.py``) MLPs, the cached-attention numerics core shared
by the dense ``generate`` control and the paged engine, the next-token
rules, and ``load_torch_gpt2``, the import of a HuggingFace GPT-2
checkpoint.

Layouts follow the JAX package so parameters cross frameworks with a
plain copy (``interop.params_from_jax``): block tensors are stacked on
a leading layer axis, dense kernels are ``(in, out)``, and the qkv
projection's columns are ``q | k | v`` at GQA widths.

On a mesh with ``tp`` (JAX ``gpt.py:794``) every rank computes each block
on its heads and hidden units, Megatron-style: qkv, fc1 and fc3 are
column slices, proj and fc2 row slices with one all-reduce each before
the bias (``_block_core(tp=...)``); the serving engine's layout splits
the attention only (``tp_attn``). A rank's qkv slice is ``[q_i | k_i |
v_i]``, the canonical columns taken in :func:`qkv_tp_permutation`'s
rank-major order. On a mesh with ``pp`` the blocks run through the GPipe
schedule (``parallel/pipeline.py``, ``_pipelined_blocks``), each rank
holding ``L/pp`` contiguous layers.
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

from torchbooster_tpu_torch._device import resolve_device, seeded
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
    n_experts: int = 0            # > 0: MoE blocks (models/moe.py)
    top_k: int = 2
    capacity_factor: float = 1.25
    sp_strategy: str = "auto"     # "auto" | "ring" | "ulysses" on sp meshes
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


def _check_pos(params: dict, cfg: GPTConfig,
               allow_tp_major: bool = False) -> None:
    """A rope checkpoint served with pos='learned' (or vice versa)
    would decode with no position signal: make it loud (``gpt.py:359``).
    Params whose qkv columns :func:`qkv_to_tp_major` permuted are refused
    on every path that reads canonical columns; ``allow_tp_major`` only
    on the pp×tp path, which checks the marker against the mesh."""
    has_wpe = "wpe" in params
    if cfg.pos == "rope" and has_wpe:
        raise ValueError("params carry a wpe table but cfg.pos='rope' "
                         "— checkpoint/config mismatch")
    if cfg.pos != "rope" and not has_wpe:
        raise ValueError("params have no wpe table but cfg.pos="
                         f"{cfg.pos!r} — was this checkpoint trained "
                         "with pos='rope'?")
    stamped = _qkv_tp_marker(params)
    if stamped is not None and not allow_tp_major:
        raise ValueError(
            f"params' qkv columns are tp-major for tp={stamped} "
            "(qkv_to_tp_major) but this path reads the canonical "
            "layout — attention would be silently scrambled; restore "
            "with qkv_to_tp_major(..., inverse=True) or run the pp×tp "
            "pipeline with qkv_tp_major=True")


# key prefix of the layout marker qkv_to_tp_major stamps into the
# attn_qkv block dict, f"{_TP_MAJOR_PREFIX}{tp}" (``gpt.py:389``): the tp
# size lives in the KEY, the value is a zero (n_layers,) leaf
_TP_MAJOR_PREFIX = "_tp_major"


def _qkv_tp_marker(params: dict) -> int | None:
    """The tp size :func:`qkv_to_tp_major` stamped on these params, or
    None for the canonical layout (``gpt.py:396``)."""
    qkv = params.get("blocks", {}).get("attn_qkv", {})
    marks = [k for k in qkv if k.startswith(_TP_MAJOR_PREFIX)]
    if not marks:
        return None
    if len(marks) > 1:
        raise ValueError(
            f"params carry multiple tp-major markers {sorted(marks)} — "
            "corrupted layout bookkeeping")
    return int(marks[0][len(_TP_MAJOR_PREFIX):])


def qkv_columns(d_model: int, kv_dim: int, tp_size: int) -> np.ndarray:
    """The rank-major order of the ``[q | k | v]`` columns (``d_model +
    2·kv_dim`` of them): rank ``i`` of ``tp_size`` holds ``[q_i | k_i |
    v_i]``, the contiguous ``i``-th part of each section."""
    sections = np.split(np.arange(d_model + 2 * kv_dim),
                        [d_model, d_model + kv_dim])
    return np.concatenate([
        np.concatenate([sec.reshape(tp_size, -1)[i] for sec in sections])
        for i in range(tp_size)])


def qkv_tp_permutation(cfg: GPTConfig, tp_size: int) -> np.ndarray:
    """``perm`` with ``tp_major[..., j] = canonical[..., perm[j]]``
    (``gpt.py:433``); invert with ``argsort``."""
    return qkv_columns(cfg.d_model, cfg.kv_heads * cfg.head_dim, tp_size)


def qkv_to_tp_major(params: dict, cfg: GPTConfig, tp_size: int,
                    inverse: bool = False) -> dict:
    """Permute the stacked qkv columns rank-major for a ``tp_size`` split
    and stamp the ``_tp_major<tp>`` marker (``gpt.py:454``); ``inverse``
    restores the canonical layout. The kernel, the quantized pair and
    the bias permute together; a second permute, an inverse of another
    tp, or of a tree never permuted, raises."""
    if cfg.n_heads % tp_size or cfg.kv_heads % tp_size:
        raise ValueError(
            f"qkv_to_tp_major needs n_heads ({cfg.n_heads}) and "
            f"kv_heads ({cfg.kv_heads}) divisible by tp ({tp_size})")
    stamped = _qkv_tp_marker(params)
    if inverse and stamped != tp_size:
        raise ValueError(
            f"qkv_to_tp_major(inverse=True, tp_size={tp_size}) on "
            + ("params that were never permuted (no _tp_major marker)"
               if stamped is None else
               f"params permuted for tp={stamped}")
            + " — inverting the wrong permutation scrambles attention")
    if not inverse and stamped is not None:
        raise ValueError(
            f"params are already tp-major (tp={stamped}) — a second "
            "permute would scramble the qkv columns; restore with "
            "inverse=True first")
    perm = qkv_tp_permutation(cfg, tp_size)
    if inverse:
        perm = np.argsort(perm)
    qkv = params["blocks"]["attn_qkv"]
    new_qkv = {k: v for k, v in qkv.items()
               if k not in ("kernel", "qkernel", "qscale", "bias")
               and not k.startswith(_TP_MAJOR_PREFIX)}
    for key in ("kernel", "qkernel", "qscale", "bias"):
        if key in qkv:
            new_qkv[key] = _take_columns(qkv[key], perm)
    if not inverse:
        ref = qkv.get("kernel", qkv.get("qkernel"))
        new_qkv[f"{_TP_MAJOR_PREFIX}{tp_size}"] = torch.zeros(
            ref.shape[0], device=ref.device,
            dtype=ref.dtype if ref.is_floating_point() else torch.float32)
    return {**params, "blocks": {**params["blocks"], "attn_qkv": new_qkv}}


def _take_columns(t: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    return t.index_select(-1, torch.as_tensor(perm, device=t.device))


@torch.no_grad()
def qkv_state_to_tp_major(state, cfg: GPTConfig, tp_size: int,
                          inverse: bool = False):
    """:func:`qkv_to_tp_major` for a whole ``TrainState``, in place
    (``gpt.py:531``): the qkv leaves, their optimizer moments and EMA
    permute together, so a canonical checkpoint resumes rank-major
    without dividing a gradient by another column's moment. Run it on
    the global state, before it is sharded. Returns the state."""
    new = qkv_to_tp_major(state.params, cfg, tp_size, inverse=inverse)
    old_qkv = state.params["blocks"]["attn_qkv"]
    perm = qkv_tp_permutation(cfg, tp_size)
    if inverse:
        perm = np.argsort(perm)
    for key in ("kernel", "bias"):
        if key not in old_qkv:
            continue
        p = old_qkv[key]
        for value in state.optimizer.state.get(p, {}).values():
            if isinstance(value, torch.Tensor) and value.shape == p.shape:
                value.copy_(_take_columns(value, perm))
        if state.ema is not None:
            e = state.ema["blocks"]["attn_qkv"][key]
            e.copy_(_take_columns(e, perm))
        p.copy_(new["blocks"]["attn_qkv"][key])
        new["blocks"]["attn_qkv"][key] = p
    marks = [k for k in old_qkv if k.startswith(_TP_MAJOR_PREFIX)]
    for k in marks:
        del old_qkv[k]
    for k, v in new["blocks"]["attn_qkv"].items():
        if k.startswith(_TP_MAJOR_PREFIX):
            old_qkv[k] = v
            if state.ema is not None:
                state.ema["blocks"]["attn_qkv"][k] = v.clone()
    if inverse and state.ema is not None:
        for k in marks:
            state.ema["blocks"]["attn_qkv"].pop(k, None)
    return state


def _mlp_hidden(cfg: GPTConfig) -> int:
    """The dense MLP's hidden width: ``mlp_ratio·d``, or swiglu's
    ``2/3`` of it rounded up to a multiple of 8 (``gpt.py:144``)."""
    h = cfg.mlp_ratio * cfg.d_model
    return max((-(-2 * h // 3) + 7) // 8 * 8, 8) if cfg.mlp == "swiglu" \
        else h


# layers whose output columns split over tp (their kernel's last dim and
# their bias), and whose input rows do (the kernel's dim -2)
_TP_COLUMNS = ("attn_qkv", "mlp_fc1", "mlp_fc3", "moe_fc1")
_TP_ROWS = ("attn_proj", "mlp_fc2", "moe_fc2")


def _tp_dim(layer: str, kind: str) -> int | None:
    """The dimension of a block leaf that tp splits, or None."""
    if layer in _TP_COLUMNS and kind in ("kernel", "bias"):
        return -1
    if layer in _TP_ROWS and kind == "kernel":
        return -2
    return None


def local_blocks(blocks: dict, cfg: GPTConfig, mesh,
                 axes: tuple[str, ...] = ("pp", "ep", "tp")) -> dict:
    """This rank's view of the stacked blocks on ``mesh``: on ``pp`` its
    ``L/pp`` contiguous layers, on ``ep`` its experts, on ``tp`` its
    heads and hidden units
    (qkv columns in :func:`qkv_tp_permutation`'s order unless the tree
    carries the tp-major marker, whose columns are rank-major already).
    Leaves that are this rank's slices already (``make_step(rules=)``
    places them so) pass through; a whole leaf is cut, and its gradient
    lands on the cut's positions. Only the mesh axes among ``axes`` cut
    (dense decode keeps every layer and expert and cuts over tp)."""
    def active(name: str):
        return mesh.axis(name) if mesh is not None and name in axes \
            else None

    pp, tp = active("pp"), active("tp")
    ep = active("ep") if cfg.n_experts else None
    if pp is None and tp is None and ep is None:
        return blocks
    if tp is not None and (cfg.n_heads % tp[1] or cfg.kv_heads % tp[1]):
        raise ValueError(
            f"tp needs n_heads ({cfg.n_heads}) and kv_heads "
            f"({cfg.kv_heads}) divisible by tp ({tp[1]})")
    tp_major = _qkv_tp_marker({"blocks": blocks}) is not None
    hidden = _mlp_hidden(cfg)
    widths = {"attn_qkv": cfg.d_model + 2 * cfg.kv_heads * cfg.head_dim,
              "attn_proj": cfg.d_model, "moe_fc1": cfg.mlp_ratio
              * cfg.d_model, "moe_fc2": cfg.mlp_ratio * cfg.d_model,
              "mlp_fc1": hidden, "mlp_fc3": hidden, "mlp_fc2": hidden}

    def cut(layer: str, kind: str, leaf: torch.Tensor) -> torch.Tensor:
        if pp is not None and leaf.shape[0] == cfg.n_layers:
            per = cfg.n_layers // pp[1]
            leaf = leaf[pp[2] * per:(pp[2] + 1) * per]
        if ep is not None and layer in ("moe_fc1", "moe_fc2") \
                and leaf.shape[1] == cfg.n_experts:
            per = cfg.n_experts // ep[1]
            leaf = leaf[:, ep[2] * per:(ep[2] + 1) * per]
        dim = _tp_dim(layer, kind) if tp is not None else None
        if dim is None:
            return leaf
        _, size, index = tp
        full = widths[layer]
        if leaf.shape[dim] != full:
            return leaf
        per = full // size
        if layer == "attn_qkv" and not tp_major:
            cols = qkv_columns(cfg.d_model, cfg.kv_heads * cfg.head_dim,
                               size)[index * per:(index + 1) * per]
            return leaf.index_select(dim, torch.as_tensor(
                cols, device=leaf.device))
        return leaf.narrow(dim, index * per, per)

    return {layer: {kind: cut(layer, kind, leaf)
                    for kind, leaf in leaves.items()}
            for layer, leaves in blocks.items()}


def qkv_column_order(path: tuple, shape: tuple, spec: tuple, mesh,
                     tree: dict) -> np.ndarray | None:
    """The rule table's order for the qkv kernel and bias
    (``parallel.sharding``): where their columns split over ``tp``, the
    canonical ``[q | k | v]`` columns rank-major (:func:`qkv_columns`),
    so that rank ``i``'s contiguous block is ``[q_i | k_i | v_i]``; None
    otherwise, and for a tree whose qkv columns are rank-major already
    (the ``_tp_major`` marker)."""
    from torchbooster_tpu_torch.parallel.sharding import tree_get

    last = (tuple(spec) + (None,) * len(shape))[len(shape) - 1]
    axes = last if isinstance(last, (tuple, list)) else (last,)
    if "tp" not in axes or mesh.shape.get("tp", 1) == 1:
        return None
    qkv = tree_get(tree, path[:-1])
    if any(str(k).startswith(_TP_MAJOR_PREFIX) for k in qkv):
        return None
    kernel = qkv["kernel"]
    d_model = getattr(kernel, "global_shape", kernel.shape)[-2]
    return qkv_columns(d_model, (shape[-1] - d_model) // 2,
                       mesh.shape["tp"])


# path-regex → spec (``parallel.sharding``; leading entry = the stacked
# layer axis), a copy of the JAX package's table: axes absent from the
# mesh are dropped, so the blocks' kernels shard over fsdp, the experts
# over ep, and everything else replicates. The qkv rows carry their
# column order over tp (:func:`qkv_column_order`).
SHARDING_RULES = [
    (r"wte/table", ()),
    (r"wpe/table", (None, None)),
    (r"attn_qkv/kernel", ("pp", "fsdp", "tp"), qkv_column_order),
    (r"attn_qkv/bias", ("pp", "tp"), qkv_column_order),
    (r"attn_proj/kernel", ("pp", "tp", "fsdp")),
    (r"mlp_fc1/kernel", ("pp", "fsdp", "tp")),
    (r"mlp_fc1/bias", ("pp", "tp")),
    (r"mlp_fc3/kernel", ("pp", "fsdp", "tp")),
    (r"mlp_fc3/bias", ("pp", "tp")),
    (r"mlp_fc2/kernel", ("pp", "tp", "fsdp")),
    (r"head/kernel", ("fsdp", "tp")),
    (r"moe_gate/kernel", ("pp",)),
    (r"moe_fc1/kernel", ("pp", "ep", None, "tp")),
    (r"moe_fc1/bias", ("pp", "ep", "tp")),
    (r"moe_fc2/kernel", ("pp", "ep", "tp", None)),
    (r"moe_fc2/bias", ("pp", "ep", None)),
    (r"blocks/", ("pp",)),
    (r".*", ()),
]


class GPT:
    """``init(seed, cfg, device=...)`` → params (blocks stacked over the
    layer axis); ``apply(params, ids, cfg)`` → logits (B, S, vocab)."""

    Config = GPTConfig
    SHARDING_RULES = SHARDING_RULES

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
        gen = seeded(seed)
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
        if cfg.n_experts > 0:
            from torchbooster_tpu_torch.models.moe import moe_init

            blocks.update(moe_init(gen, cfg.n_experts, d, h, std=0.02,
                                   out_std=res_std, lead=(n,)))
        elif cfg.mlp == "swiglu":
            hs = _mlp_hidden(cfg)
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
              generator: torch.Generator | None = None,
              mesh=None, qkv_tp_major: bool = False) -> torch.Tensor:
        """Full causal forward → logits (B, S, vocab), or the final-norm
        hidden states (B, S, d) with ``return_hidden`` (for the chunked
        LM-head loss, ``ops.losses.lm_head_cross_entropy`` with
        :meth:`head_table`). Every leaf is cast to ``compute_dtype``
        where it is used, inside the differentiated function, so the
        gradients land on the fp32 masters. ``return_aux`` adds the MoE
        load-balance loss, the mean over layers (0 for dense blocks).

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
        generator then moves on past the block's draws.

        ``mesh`` (a ``distributed.Mesh`` under a process group): ``ids``
        is this rank's block of the global batch — its rows over the
        data axes and, on an ``sp`` mesh, its ``S/sp`` chunk of the
        sequence (``distributed.shard_batch``). Attention then goes
        through ``parallel.ulysses.sequence_attention`` with
        ``cfg.sp_strategy``; learned and rope positions are the global
        ones, offset by the rank's chunk; each dropout mask is this
        rank's slice of the mask one device draws over the whole
        sequence from the same generator state, so an ``sp:N`` run
        equals the ``sp:1`` run. MoE blocks route over the global batch
        (``moe.token_shards``) and, on an ``ep`` mesh, hold this rank's
        slice of the experts. On a ``tp`` mesh each block runs on this
        rank's heads and hidden units (:func:`local_blocks`,
        ``_block_core(tp=...)``); the embeddings, norms, row biases and
        head are whole on every rank and get whole, equal gradients. On
        a ``pp`` mesh the blocks run through the GPipe schedule
        (``_pipelined_blocks``); the embedding's gradient comes back to
        every stage (it is summed over ``pp``, where only stage 0 has
        it), and each stage computes the head and loss on the broadcast
        output. ``qkv_tp_major``: the tree's qkv columns are rank-major
        (:func:`qkv_to_tp_major`), allowed on the pp×tp path only, with
        its marker checked against the mesh's ``tp`` (``gpt.py:259``)."""
        b, s = ids.shape
        _check_pos(params, cfg, allow_tp_major=qkv_tp_major)
        sp = mesh.axis("sp") if mesh is not None else None
        tp = mesh.axis("tp") if mesh is not None else None
        pp = mesh.axis("pp") if mesh is not None else None
        sp_size, sp_index = (sp[1], sp[2]) if sp is not None else (1, 0)
        if s * sp_size > cfg.seq_len:
            raise ValueError(f"sequence length {s * sp_size} exceeds "
                             f"cfg.seq_len={cfg.seq_len}")
        if qkv_tp_major and (pp is None or tp is None):
            raise ValueError(
                "qkv_tp_major=True but the mesh has no active pp+tp "
                "axes — these params' qkv columns are rank-major and "
                "the canonical paths would read them scrambled; "
                "restore with qkv_to_tp_major(..., inverse=True)")
        if qkv_tp_major:
            stamped = _qkv_tp_marker(params)
            if stamped != tp[1]:
                raise ValueError(
                    "qkv_tp_major=True but params carry "
                    + ("no _tp_major marker — qkv_to_tp_major was "
                       "never applied" if stamped is None else
                       f"a tp={stamped} marker")
                    + f"; this mesh has tp={tp[1]}")
        blocks = local_blocks(params["blocks"], cfg, mesh)
        offset = sp_index * s
        seq = (sp_index, sp_size) if sp is not None else None
        positions = torch.arange(offset, offset + s, device=ids.device) \
            if sp is not None else None
        drop = cfg.dropout if generator is not None else 0.0
        x = _dropout(_embed(params, ids, compute_dtype, offset), drop,
                     generator, seq)
        if pp is not None:
            x, aux = _pipelined_blocks(blocks, x, cfg, mesh, remat,
                                       attn_impl, drop, generator,
                                       positions, seq)
        else:
            moe = _moe_layout(mesh) if cfg.n_experts > 0 else {}

            def attend(q, k, v):
                if sp is not None:
                    from torchbooster_tpu_torch.parallel.ulysses import (
                        sequence_attention,
                    )

                    # grouped K/V ride the sp exchanges un-expanded
                    return sequence_attention(
                        q, k, v, mesh, causal=True,
                        strategy=cfg.sp_strategy, impl=attn_impl,
                        tp_local=tp is not None), None
                # grouped K/V go to the dispatcher as they are: the flash
                # kernels index grouped rows, the reference expands them
                return attention(q, k, v, causal=True, impl=attn_impl), None

            def block(bp: dict, x: torch.Tensor, rng_state, after: list):
                gen = None
                if drop:
                    gen = torch.Generator(generator.device)
                    gen.set_state(rng_state)
                x, aux, _ = _block_core(bp, x, cfg, attend,
                                        positions=positions, dropout=drop,
                                        generator=gen, seq=seq, tp=tp,
                                        **moe)
                if drop:
                    after[:] = [gen.get_state()]
                return x, aux

            aux = 0.0
            for i in range(cfg.n_layers):
                bp = layer_params(blocks, i)
                rng_state = generator.get_state() if drop else None
                after: list = []
                x, layer_aux = _run_block(block, bp, x, remat, rng_state,
                                          after)
                aux = aux + layer_aux
                if drop:
                    generator.set_state(after[0])
        out = L.layer_norm(params["ln_f"], x) if return_hidden \
            else _lm_head(params, x, tp)
        if return_aux:
            # the mean load-balance loss over layers (0 for dense blocks)
            aux = aux / max(cfg.n_layers, 1) if torch.is_tensor(aux) \
                else torch.zeros((), device=out.device)
            return out, aux
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

    @staticmethod
    def jit_generate(cfg: GPTConfig = GPTConfig(), *args, **kw):
        return jit_generate(cfg, *args, **kw)


# the JAX remat policy: products without batch dims are saved
_SAVED_PRODUCTS = frozenset({torch.ops.aten.mm.default,
                             torch.ops.aten.addmm.default})


def _dots_with_no_batch_dims_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                   _dots_with_no_batch_dims_saveable)


def _run_block(fn, bp: dict, x: torch.Tensor, remat: bool, *args):
    """``fn(bp, x, *args)``, checkpointed under the remat policy when
    ``remat`` and gradients are on. The block's tensors enter the
    checkpoint as positional tensors, not inside a dict, so that the
    saved-tensor hooks around the forward (ZeRO-3's re-gather,
    ``comms/schedule.py``) see them too."""
    if not (remat and torch.is_grad_enabled()):
        return fn(bp, x, *args)
    # a block's leaves are two levels deep: layer name, then kind
    paths = [(k, kk) for k, v in bp.items() for kk in v]

    def flat_fn(x, n_args, *rest):
        tree: dict = {}
        for (k, kk), t in zip(paths, rest[n_args:]):
            tree.setdefault(k, {})[kk] = t
        return fn(tree, x, *rest[:n_args])

    return checkpoint(flat_fn, x, len(args), *args,
                      *[bp[k][kk] for k, kk in paths],
                      use_reentrant=False, context_fn=_REMAT_CONTEXT)


def tensor_leaves(tree) -> list:
    """The tensor leaves of a nested dict/tuple tree, in key order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, tuple):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree]


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


def _moe_layout(mesh) -> dict:
    """``_block_core``'s MoE keywords on ``mesh``: the global token
    layout and, on an ``ep`` mesh, this rank's expert slice."""
    from torchbooster_tpu_torch.models.moe import token_shards

    if mesh is None:
        return {}
    return {"shards": token_shards(mesh), "ep": mesh.axis("ep")}


def _dropout(x: torch.Tensor, rate: float,
             generator: torch.Generator | None,
             seq: tuple[int, int] | None = None,
             rows: tuple[torch.Tensor, int] | None = None) -> torch.Tensor:
    """Inverted dropout (``gpt.py:759``): keep each element with
    probability ``1 - rate`` and scale it by ``1 / (1 - rate)``, in x's
    dtype; the identity at rate 0 or without a generator. The mask is
    drawn on x's device from ``generator``, which lies there too.
    ``seq=(index, n)``: x is chunk ``index`` of ``n`` along the sequence
    (dimension 1); ``rows=(lines, n)``: x's rows are rows ``lines`` (an
    index) of a batch of ``n`` (a pipeline microbatch). The mask is
    drawn over the whole sequence and batch and x's part kept, so the
    pipelined and sequence-parallel forwards draw the masks of the
    forward on one device."""
    if not rate or generator is None:
        return x
    keep = 1.0 - rate
    shape, cols, lines = list(x.shape), slice(None), slice(None)
    if seq is not None:
        index, n = seq
        shape[1] = x.shape[1] * n
        cols = slice(index * x.shape[1], (index + 1) * x.shape[1])
    if rows is not None:
        lines, shape[0] = rows
        lines = lines.to(x.device)
    mask = torch.rand(shape, generator=generator,
                      device=x.device)[lines, cols] < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _row_dense(params: dict, x: torch.Tensor, reduce=None,
               delta: torch.Tensor | None = None) -> torch.Tensor:
    """Row-parallel dense (``gpt.py:770``): ``reduce`` (the all-reduce
    over the tp group, or None) runs BETWEEN the product and the bias, so
    the partial products of the row slices sum and the replicated bias
    is added once. ``delta`` (a LoRA product, its A-factor row-sliced
    like the kernel) adds to the partial products and rides the same
    all-reduce."""
    if "qkernel" in params:
        y = L.qmatmul(params, x)
    else:
        y = x @ params["kernel"].to(x.dtype)
    if delta is not None:
        y = y + delta
    if reduce is not None:
        y = reduce(y)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def _block_core(bp: dict, x: torch.Tensor, cfg: GPTConfig, attend,
                positions: torch.Tensor | None = None, dropout: float = 0.0,
                generator: torch.Generator | None = None, lora=None,
                capacity_factor: float | None = None, ep=None, shards=None,
                seq: tuple[int, int] | None = None, tp=None, tp_attn=None,
                rows: tuple[torch.Tensor, int] | None = None):
    """The transformer block shared by every path (full forward,
    prefill chunk, cached decode). ``attend(q, k, v) -> (o, extras)``
    supplies the attention flavor; ``dropout`` with a ``generator``
    drops the two residual branches (:func:`_dropout`; ``seq`` and
    ``rows`` slice the masks of a sequence chunk or a microbatch). MoE
    blocks run ``moe_apply`` at ``capacity_factor`` (default
    ``cfg.capacity_factor``) with ``ep`` and ``shards``
    (``models/moe.py``). ``lora`` = ``((a_qkv, b_qkv, a_proj, b_proj),
    lane_ids)``, this layer's adapter stacks ``(lanes, ...)`` and one
    lane id a batch row (``gpt.py:872``): row b adds ``h @ A[g] @ B[g]``
    of its lane g to the qkv output and to the O projection before its
    bias, each stack cast to the activations' dtype, so lane 0's zero
    stacks are an exact no-op.

    ``tp=(group, size, index)`` (``gpt.py:794``): ``bp`` holds this
    rank's Megatron slices — qkv, fc1 and fc3 columns (its heads and
    hidden units), proj and fc2 rows — and one all-reduce over ``group``
    sums each row product before its bias
    (``distributed.reduce_from_group``); the column products' input goes
    through ``copy_to_group``, whose backward sums the partial input
    gradients, so the norms and everything before them get whole, equal
    gradients on every rank. MoE blocks split their experts' hidden the
    same way. ``tp_attn=(group, size, index)`` is the serving layout:
    only qkv and proj are split, the MLP runs whole on every rank, one
    all-reduce a layer; ``lora`` rides it, its full stacks cut to this
    rank's ``b_qkv`` columns (rank-major, as the adapter registry lays
    them out) and ``a_proj`` rows. Returns ``(x, aux_loss, extras)``; a
    dense block's aux loss is the number 0.0 (no device work on the
    serving paths)."""
    from torchbooster_tpu_torch import distributed as dist

    if tp is not None and tp_attn is not None:
        raise ValueError("_block_core: tp and tp_attn are mutually "
                         "exclusive manual-parallelism modes")
    if lora is not None and tp is not None:
        raise ValueError(
            "_block_core: lora rides the serving layouts (single-chip "
            "or tp_attn) — the training tp path shards the MLP too "
            "and has no adapter surface")
    b, s, d = x.shape
    n_heads, kv_heads, head_dim = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    split = tp if tp is not None else tp_attn
    attn_in = mlp_in = lambda t: t
    reduce = attn_reduce = None
    if split is not None:
        group, size, index = split
        n_heads //= size
        kv_heads //= size
        attn_in = lambda t: dist.copy_to_group(t, group)
        attn_reduce = lambda y: dist.reduce_from_group(y, group)
        if tp is not None:
            mlp_in, reduce = attn_in, attn_reduce
    q_width, kv_dim = n_heads * head_dim, kv_heads * head_dim
    h = L.layer_norm(bp["ln1"], x)
    qkv = L.dense(bp["attn_qkv"], attn_in(h))
    if lora is not None:
        (la_q, lb_q, la_p, lb_p), lane_ids = lora
        if tp_attn is not None:
            w_loc = qkv.shape[-1]
            lb_q = lb_q[..., index * w_loc:(index + 1) * w_loc]
            la_p = la_p[:, index * q_width:(index + 1) * q_width]
        dq = torch.einsum("bsd,bdr->bsr", h, la_q[lane_ids].to(h.dtype))
        qkv = qkv + torch.einsum("bsr,bro->bso", dq,
                                 lb_q[lane_ids].to(h.dtype))
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
    x = x + _dropout(_row_dense(bp["attn_proj"], o_flat, attn_reduce,
                                delta=proj_delta),
                     dropout, generator, seq, rows)
    h = L.layer_norm(bp["ln2"], x)
    if cfg.n_experts > 0:
        from torchbooster_tpu_torch.models.moe import moe_apply

        m, aux = moe_apply(
            bp, h, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor if capacity_factor is None
            else capacity_factor, ep=ep, shards=shards, tp=tp)
        return x + _dropout(m, dropout, generator, seq, rows), aux, extras
    h = mlp_in(h)
    if "mlp_fc3" in bp:
        h = F.silu(L.dense(bp["mlp_fc1"], h)) * L.dense(bp["mlp_fc3"], h)
    else:   # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(L.dense(bp["mlp_fc1"], h), approximate="tanh")
    return x + _dropout(_row_dense(bp["mlp_fc2"], h, reduce), dropout,
                        generator, seq, rows), 0.0, extras


def pipeline_layer(cfg: GPTConfig, remat: bool, attn_impl: str, n_mb: int,
                   tp=None, sp=None, ep=None, drop: float = 0.0,
                   states: list | None = None,
                   generator: torch.Generator | None = None,
                   positions: torch.Tensor | None = None,
                   seq: tuple[int, int] | None = None,
                   shard: tuple[int, int] = (1, 0)):
    """``layer_fn((bp, layer_id), h, mb) -> (h, aux)``, one block of the
    GPipe schedule (``gpt.py:643``): ``_block_core`` on microbatch ``mb``
    of ``n_mb``, checkpointed under the remat policy, with this rank's
    ``tp``/``ep`` slices; under ``sp`` the ring body ``select_ring_body``
    picks for ``attn_impl``; with ``drop`` the masks come from
    ``states[layer_id]``, the generator state the un-pipelined forward
    has before that layer, kept at the rows the microbatch holds on data
    shard ``index`` of ``shard = (n, index)``
    (``parallel.pipeline.microbatch_rows``; the un-pipelined forward of
    every data shard draws its rows from a generator in that state).
    Shared by ``_pipelined_blocks`` and ``parallel.pipeline.fold_apply``."""
    from torchbooster_tpu_torch.parallel.pipeline import microbatch_rows

    if sp is not None:
        from torchbooster_tpu_torch.parallel.ring import select_ring_body

        def attend(q, k, v):
            body = select_ring_body(
                attn_impl, s_loc=q.shape[1], sp_size=sp[1], my=sp[2],
                group=sp[0], causal=True,
                sm_scale=1.0 / math.sqrt(cfg.head_dim),
                rep=q.shape[2] // k.shape[2], device=q.device,
                head_dim=cfg.head_dim, dtype=q.dtype)
            return body(q, k, v), None
    else:
        def attend(q, k, v):
            return attention(q, k, v, causal=True, impl=attn_impl), None

    def block(bp: dict, h: torch.Tensor, layer: int, mb: int):
        gen, rows = None, None
        if drop:
            gen = torch.Generator(generator.device)
            gen.set_state(states[layer])
            n_rows = h.shape[0] * n_mb
            rows = (microbatch_rows(mb, n_mb, n_rows, *shard)
                    % n_rows, n_rows)
        out, aux, _ = _block_core(
            bp, h, cfg, attend, positions=positions, dropout=drop,
            generator=gen, seq=seq, tp=tp, ep=ep, rows=rows)
        return out, aux

    def layer_fn(layer_in: tuple, h: torch.Tensor, mb: int):
        bp, layer = layer_in
        out, aux = _run_block(block, bp, h, remat, int(layer), mb)
        return out, aux if torch.is_tensor(aux) else torch.zeros(
            (), dtype=torch.float32, device=h.device)

    return layer_fn


def _pipelined_blocks(blocks: dict, x: torch.Tensor, cfg: GPTConfig, mesh,
                      remat: bool, attn_impl: str, drop: float,
                      generator: torch.Generator | None,
                      positions: torch.Tensor | None,
                      seq: tuple[int, int] | None):
    """The blocks through the GPipe schedule on a ``pp`` mesh
    (``gpt.py:559``; ``parallel.pipeline.pipeline_apply``): ``blocks``
    are this rank's ``L/pp`` layers (and its tp slices, :func:`
    local_blocks`), and every (layer, microbatch) runs ``_block_core``,
    checkpointed under the remat policy. Returns ``(x, aux)``.

    - tp: the blocks' Megatron slices as in the un-pipelined forward
      (the qkv columns in :func:`qkv_tp_permutation`'s order, or
      rank-major already under the marker).
    - sp: attention is the ring body ``select_ring_body`` picks for
      ``attn_impl`` (``gpt.py:643``), positions offset by the chunk.
    - ep: each rank's experts, routing every token of the microbatch.
    - MoE: ``m = pp`` microbatches, JAX's rows (each data shard's part
      of rows ``[j·B/m, (j+1)·B/m)``); capacity, dropped tokens and the
      aux estimator are per microbatch and per data shard and, under
      ``sp``, per sequence shard (routing stays on the rank's ``S/sp``
      tokens), the aux averaged over the data and ``sp`` ranks
      (``gpt.py:577``).
    - dropout: layer ``l``'s masks come from the generator state the
      un-pipelined forward has before layer ``l``, drawn over the rank's
      whole batch and kept at the rows the microbatch holds, so the
      pipelined forward equals the un-pipelined one (with the generator
      in one state on every data shard, as ``TrainState`` seeds it)."""
    from torchbooster_tpu_torch import distributed as dist
    from torchbooster_tpu_torch.parallel.pipeline import pipeline_apply

    pp_group = mesh.axis("pp")[0]
    tp = mesh.axis("tp")
    sp = mesh.axis("sp")
    ep = mesh.axis("ep") if cfg.n_experts > 0 else None
    if ep is not None and cfg.n_experts % ep[1]:
        raise ValueError(
            f"pp x ep needs n_experts ({cfg.n_experts}) divisible "
            f"by ep ({ep[1]})")
    if tp is not None and cfg.n_experts > 0:
        hidden = cfg.mlp_ratio * cfg.d_model
        if hidden % tp[1]:
            raise ValueError(
                f"pp x tp MoE needs expert hidden ({hidden}) "
                f"divisible by tp ({tp[1]})")
    states = None
    if drop:
        # the generator states the un-pipelined forward has before each
        # layer: two draws of the rank's (B, S, d) masks a layer
        shape = (x.shape[0], x.shape[1] * (seq[1] if seq else 1),
                 x.shape[2])
        states = []
        for _ in range(cfg.n_layers):
            states.append(generator.get_state())
            for _ in range(2):
                torch.rand(shape, generator=generator, device=x.device)
    from torchbooster_tpu_torch.parallel.pipeline import (
        _default_microbatches,
    )

    data = mesh.data_axes()
    n_mb = mesh.shape["pp"] if cfg.n_experts > 0 else _default_microbatches(
        x.shape[0] * mesh.axes_size(data), mesh.shape["pp"],
        mesh.axes_size(data))
    pp_layer = pipeline_layer(cfg, remat, attn_impl, n_mb, tp=tp, sp=sp,
                              ep=ep, drop=drop, states=states,
                              generator=generator, positions=positions,
                              seq=seq, shard=(mesh.axes_size(data),
                                              mesh.linear_index(data)))
    n_local = next(iter(next(iter(blocks.values())).values())).shape[0]
    first = mesh.coords()["pp"] * n_local
    layer_ids = torch.arange(first, first + n_local)
    # the embedding output reaches the schedule on stage 0 only: its
    # gradient is summed over pp, so every stage's embedding gets it
    x = dist.copy_to_group(x, pp_group)
    return pipeline_apply(pp_layer, (blocks, layer_ids), x, mesh,
                          n_microbatches=n_mb, with_mb_index=True,
                          with_aux=True, params_local=True,
                          aux_axes=("sp",) if sp is not None else ())


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
                  cfg: GPTConfig, tp=None) -> torch.Tensor:
    """One decode step through one block at position ``pos``: this
    token's K/V are written into the (B, S_cache, H_kv, Dh) caches IN
    PLACE, then attended with everything ``<= pos``. MoE capacity floors
    at ``n_experts`` so a decode micro-batch never drops a token
    (``gpt.py:1083``). ``tp``: ``bp`` holds this rank's Megatron slices
    and the caches its ``kv_heads / tp`` heads (``_block_core(tp=)``)."""
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

    x, _, _ = _block_core(bp, x, cfg, attend,
                          positions=torch.tensor([pos], device=x.device),
                          capacity_factor=serving_capacity(cfg), tp=tp)
    return x


def _cached_block_at(bp: dict, x: torch.Tensor, cache_k, cache_v,
                     at: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """:func:`_cached_block` at a position read on the device (``at``, a
    (1,) long tensor), so that its shapes and addresses are the same for
    every token: K/V are written at ``at`` with ``index_copy_`` and the
    whole cache is attended under a ``<= at`` mask. The step
    :func:`jit_generate` captures."""
    quantized = isinstance(cache_k, tuple)
    s_cache = (cache_k[0] if quantized else cache_k).shape[1]

    def attend(q, k, v):
        if quantized:
            for cache, new in ((cache_k, k), (cache_v, v)):
                vals, scales = _quantize_kv(new)
                cache[0].index_copy_(1, at, vals)
                cache[1].index_copy_(1, at, scales)
        else:
            cache_k.index_copy_(1, at, k.to(cache_k.dtype))
            cache_v.index_copy_(1, at, v.to(cache_v.dtype))
        visible = torch.arange(s_cache, device=x.device) <= at
        return _grouped_cache_attention(q, cache_k, cache_v, visible), None

    x, _, _ = _block_core(bp, x, cfg, attend, positions=at,
                          capacity_factor=serving_capacity(cfg))
    return x


def serving_capacity(cfg: GPTConfig) -> float:
    """The capacity factor of every serving forward (decode, the paged
    engine's prefill and verify; JAX ``engine.py:760``): at least
    ``n_experts``, so no token of a serving batch drops."""
    return max(cfg.capacity_factor, float(cfg.n_experts))


def _lm_head(params: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Final norm and the head (tied: the wte table). On a ``tp`` mesh an
    untied head whose vocabulary columns are this rank's slice (the rule
    ``P("fsdp", "tp")`` where tp divides the vocabulary) computes its
    slice of the logits and gathers the rest over the tp group."""
    x = L.layer_norm(params["ln_f"], x)
    if "head" in params:
        head = params["head"]
        wte = params["wte"]
        n_vocab = wte.get("table", wte.get("qtable")).shape[0]
        if tp is not None and head.get(
                "kernel", head.get("qkernel")).shape[-1] != n_vocab:
            from torchbooster_tpu_torch import distributed as dist

            return dist.gather_from_group(
                L.dense(head, dist.copy_to_group(x, tp[0])), tp[0])
        return L.dense(head, x)
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
           compute_dtype: torch.dtype, offset: int = 0) -> torch.Tensor:
    """Token (+ learned position) embeddings in ``compute_dtype``; the
    positions start at ``offset`` (a sequence chunk's first)."""
    x = L.embedding(params["wte"], ids, dtype=compute_dtype)
    if "wpe" in params:
        x = x + L.embedding(params["wpe"],
                            torch.arange(offset, offset + ids.shape[1],
                                         device=ids.device),
                            dtype=compute_dtype)
    return x


def _prefill_forward(params: dict, ids: torch.Tensor, cfg: GPTConfig,
                     compute_dtype: torch.dtype, tp=None):
    """Full prompt forward collecting per-layer K/V, attending through
    the dispatcher as ``gpt.py:1320`` does. Returns ``(x, ks, vs)`` with
    x (B, S, d) and ks/vs stacked (L, B, S, kv_heads, Dh); with ``tp``
    the blocks are this rank's slices and ks/vs its ``kv_heads / tp``
    heads."""
    x = _embed(params, ids, compute_dtype)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, _, (k, v) = _block_core(
            layer_params(params["blocks"], i), x, cfg,
            lambda q, k, v: (attention(q, k, v, causal=True), (k, v)), tp=tp)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def _decode_params(params: dict, cfg: GPTConfig, mesh) -> dict:
    """This rank's tree for dense decode on ``mesh``: every leaf laid out
    by ``parallel.sharding.shard_params`` gathered whole over every axis
    but ``tp`` (``fsdp``, ``pp``, ``ep``); a dimension split over ``tp``
    stays this rank's Megatron slice (the qkv columns in the order
    ``shard_params`` recorded, rank-major), and a whole tree is cut to
    that slice (:func:`local_blocks` over ``tp`` alone)."""
    from torchbooster_tpu_torch.parallel.sharding import (
        decode_spec,
        gather_leaf,
        tree_map_with_path,
    )

    tree = tree_map_with_path(lambda _, leaf: gather_leaf(
        leaf, decode_spec(getattr(leaf, "spec", ())), mesh), params)
    return {**tree, "blocks": local_blocks(tree["blocks"], cfg, mesh,
                                           axes=("tp",))}


@torch.no_grad()
def generate(params: dict, ids: torch.Tensor, cfg: GPTConfig = GPTConfig(),
             n_new: int = 32, generator: torch.Generator | None = None,
             temperature: float = 1.0, top_k: int | None = None,
             top_p: float | None = None,
             compute_dtype: torch.dtype = torch.bfloat16,
             cache_dtype: str | None = None, mesh=None) -> torch.Tensor:
    """Dense KV-cache decoding — the control every serving test is
    held to (``gpt.py:1329``). Prefill runs the whole prompt once, then
    ``n_new`` tokens decode one at a time against a static-shape cache
    (``cache_dtype="int8"`` stores ``_quantize_kv`` pairs). Greedy at
    ``temperature=0``; sampling draws from ``generator``, which it
    needs. Returns (B, S_prompt + n_new) ids.

    ``mesh`` (a ``distributed.Mesh`` under a process group): ``params``
    are this rank's blocks as ``parallel.sharding.shard_params(params,
    mesh, GPT.SHARDING_RULES)`` lays them out, or the whole tree.
    Every leaf is gathered whole over every axis but ``tp`` once, before
    the prefill (:func:`_decode_params`); each block then runs on this
    rank's heads and hidden units with two all-reduces over ``tp``
    (``_block_core(tp=)``), the cache holds its ``kv_heads / tp`` heads,
    and a vocabulary-sliced head gathers its logits. ``ids`` is the
    whole batch on every rank, and every rank returns the whole ids: the
    reduced logits are equal on every rank, so are greedy picks, and so
    are sampled ones when every rank's generator is seeded alike."""
    _check_decode(ids, cfg, n_new, generator, temperature, top_p,
                  cache_dtype)
    b, s0 = ids.shape
    if n_new == 0:
        return ids
    _check_pos(params, cfg)
    tp = None
    if mesh is not None and mesh.distributed and mesh.size > 1:
        params = _decode_params(params, cfg, mesh)
        tp = mesh.axis("tp")
    params = cast_params(params, compute_dtype)
    x, ks, vs = _prefill_forward(params, ids, cfg, compute_dtype, tp)
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
    last = pick(generator, _lm_head(params, x[:, -1:], tp)[:, 0])
    out = [last]
    for pos in range(s0, s_total - 1):
        x = L.embedding(params["wte"], last[:, None], dtype=compute_dtype)
        if "wpe" in params:
            x = x + params["wpe"]["table"][pos].to(compute_dtype)
        for i in range(cfg.n_layers):
            x = _cached_block(layer_params(params["blocks"], i), x,
                              layer_cache(cache_k, i),
                              layer_cache(cache_v, i), pos, cfg, tp)
        last = pick(generator, _lm_head(params, x, tp)[:, 0])
        out.append(last)
    return torch.cat([ids, torch.stack(out, dim=1).to(ids.dtype)], dim=1)


def _check_decode(ids: torch.Tensor, cfg: GPTConfig, n_new: int,
                  generator, temperature: float, top_p: float | None,
                  cache_dtype: str | None) -> None:
    """The argument checks of :func:`generate` and :func:`jit_generate`."""
    if ids.shape[1] + n_new > cfg.seq_len:
        raise ValueError(f"prompt {ids.shape[1]} + n_new {n_new} exceeds "
                         f"cfg.seq_len={cfg.seq_len}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs generator=")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if cache_dtype not in (None, "int8"):
        raise ValueError(f"cache_dtype must be None or 'int8', got "
                         f"{cache_dtype!r}")


class _DecodeState:
    """:func:`jit_generate`'s fixed-shape decode for one (batch, prompt
    length): the KV cache of ``s_total`` positions, ``(n_layers, B,
    s_total, H_kv, Dh)`` in ``dtype`` or ``_quantize_kv`` pairs
    (``cache_dtype="int8"``), shaped from the prefill's ``ks``; the token
    and the position its step reads on the device; its captured step."""

    def __init__(self, ks: torch.Tensor, s_total: int,
                 cache_dtype: str | None, dtype: torch.dtype):
        shape = (*ks.shape[:2], s_total, *ks.shape[3:])
        zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                                 device=ks.device)
        pair = lambda: (zeros(shape, torch.int8),
                        zeros((*shape[:-1], 1), torch.bfloat16))
        self.k, self.v = ((pair(), pair()) if cache_dtype == "int8"
                          else (zeros(shape, dtype), zeros(shape, dtype)))
        self.tok = zeros((ks.shape[1],), torch.long)
        self.pos = zeros((1,), torch.long)
        self.graph = None

    def load(self, ks: torch.Tensor, vs: torch.Tensor) -> None:
        """The prompt's K/V at positions ``[0, s0)``, zeros past them."""
        s0 = ks.shape[2]
        for cache, new in ((self.k, ks), (self.v, vs)):
            parts = _quantize_kv(new) if isinstance(cache, tuple) else (new,)
            for c, p in zip(cache if isinstance(cache, tuple) else (cache,),
                            parts):
                c[:, :, :s0] = p
                c[:, :, s0:] = 0

    def step(self, params: dict, cfg: GPTConfig,
             compute_dtype: torch.dtype) -> torch.Tensor:
        """One token a row (``tok``) through every block at ``pos``, its
        K/V written into the cache in place: the (B, vocab) logits."""
        x = L.embedding(params["wte"], self.tok[:, None],
                        dtype=compute_dtype)
        if "wpe" in params:
            x = x + params["wpe"]["table"][self.pos].to(compute_dtype)
        at = lambda c, i: (c[0][i], c[1][i]) if isinstance(c, tuple) \
            else c[i]
        for i in range(cfg.n_layers):
            x = _cached_block_at(layer_params(params["blocks"], i), x,
                                 at(self.k, i), at(self.v, i), self.pos,
                                 cfg)
        return _lm_head(params, x)[:, 0]

    def operands(self, params: dict) -> list:
        return [*tensor_leaves(params), *tensor_leaves((self.k, self.v)),
                self.tok, self.pos]


def jit_generate(cfg: GPTConfig = GPTConfig(), n_new: int = 32,
                 temperature: float = 1.0, top_k: int | None = None,
                 top_p: float | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 cache_dtype: str | None = None, mesh=None):
    """The one-entry decode of ``gpt.py:1428``: ``fn(params, ids,
    generator=None) -> (B, S_prompt + n_new) ids``, :func:`generate`'s
    tokens with the decode knobs closed over.

    On the card (:func:`~torchbooster_tpu_torch._graphs.plan_steps`) the
    prefill runs eagerly (B1), then a fixed-shape decode step: it reads
    its position from a device tensor, writes K/V there in place and
    attends the whole ``S_prompt + n_new`` cache under a ``<= pos`` mask
    (:func:`_cached_block_at`), so its shapes depend on ``(batch, prompt
    length)`` alone. That step is captured once a shape as a CUDA graph
    and replayed ``n_new - 1`` times; the draws run after each replay
    from ``generator``, and the tokens stay on the device until the end.
    The graph reads the params where they lie: the leaves already in
    ``compute_dtype`` are the caller's, and each leaf that needs a cast
    is cast into a buffer of ``fn``'s own (kept, one copy in
    ``compute_dtype``, and refreshed in place each call). Params at other
    addresses than the capture's (a new tree) capture that shape again.
    On the CPU and under ``eager_steps()`` the same step runs eagerly;
    with a ``mesh`` (collectives) ``fn`` runs :func:`generate`.

    ``fn._cache_size()`` counts the ``(batch, prompt length)`` shapes
    ``fn`` has run, plus one for each capture that params at new
    addresses forced: the counterpart of JAX's compile cache (as
    ``PagedEngine.decode_compiles`` is of the engine's)."""
    from torchbooster_tpu_torch._graphs import capture, captured, plan_steps

    states: dict = {}     # (batch, prompt length) -> _DecodeState
    casts: dict = {}      # key path -> fn's compute-dtype copy of a leaf
    recaptures = [0]

    def staged_params(tree: dict, path: tuple = ()) -> dict:
        # cast_params's rule, each cast landing in its kept buffer
        out = {}
        for k, v in tree.items():
            at = (*path, k)
            if isinstance(v, dict):
                out[k] = staged_params(v, at)
            elif not v.is_floating_point() or k == "qscale" \
                    or v.dtype == compute_dtype:
                out[k] = v
            else:
                buf = casts.get(at)
                if buf is None or buf.shape != v.shape \
                        or buf.device != v.device:
                    buf = casts[at] = torch.empty_like(v, dtype=compute_dtype)
                out[k] = buf.copy_(v)
        return out

    @torch.no_grad()
    def fn(params: dict, ids: torch.Tensor,
           generator: torch.Generator | None = None) -> torch.Tensor:
        b, s0 = ids.shape
        collectives = mesh is not None and mesh.distributed and mesh.size > 1
        route = plan_steps(ids.device, collectives=collectives)[0]
        if collectives:
            out = generate(params, ids, cfg, n_new=n_new,
                           generator=generator, temperature=temperature,
                           top_k=top_k, top_p=top_p,
                           compute_dtype=compute_dtype,
                           cache_dtype=cache_dtype, mesh=mesh)
            states.setdefault((b, s0), None)
            return out
        _check_decode(ids, cfg, n_new, generator, temperature, top_p,
                      cache_dtype)
        if n_new == 0:
            return ids
        _check_pos(params, cfg)
        params = staged_params(params)
        x, ks, vs = _prefill_forward(params, ids, cfg, compute_dtype)
        st = states.get((b, s0))
        if st is None:
            st = states[(b, s0)] = _DecodeState(ks, s0 + n_new, cache_dtype,
                                                compute_dtype)
        st.load(ks, vs)
        pick = _make_pick(temperature, top_k, top_p)
        last = pick(generator, _lm_head(params, x[:, -1:])[:, 0])
        out = [last]
        step = lambda: st.step(params, cfg, compute_dtype)
        for pos in range(s0, s0 + n_new - 1):
            st.tok.copy_(last)
            st.pos.fill_(pos)
            if not captured(route):
                logits = step()
            elif st.graph is None or st.graph.moved(st.operands(params)):
                recaptures[0] += st.graph is not None
                st.graph, logits = capture(step, st.operands(params))
            else:
                logits = st.graph.replay()
            last = pick(generator, logits)
            out.append(last)
        return torch.cat([ids, torch.stack(out, dim=1).to(ids.dtype)], dim=1)

    fn._cache_size = lambda: len(states) + recaptures[0]
    return fn


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


__all__ = ["GPT", "GPTConfig", "cast_params", "generate", "jit_generate",
           "layer_params", "load_torch_gpt2", "local_blocks", "map_tensors",
           "qkv_columns", "qkv_state_to_tp_major", "qkv_tp_permutation",
           "qkv_to_tp_major", "serving_capacity"]
