"""Quantized weight serving — the port of ``torchbooster_tpu/models/
quant.py``: int8/int4 parameter trees with the dequant inside the
matmul's operand read.

Two formats, told apart by the ``qkernel`` leaf's dtype (never by a
flag), so every path dispatches on the tree alone:

- **int8** — symmetric per-OUTPUT-channel absmax (``scale = absmax /
  127`` over the input axis), round to nearest. The scales factor out of
  the product: ``y = (x @ q) * s``.
- **int4** — per-GROUP absmax along the INPUT axis (``group_size``
  consecutive input rows share an ``absmax / 7`` scale), stored offset 8
  in ``[1, 15]`` and packed two a byte along the input axis (even input
  index in the low nibble): ``qkernel`` is uint8 at half the input
  length. Group scales do not factor out, so the kernel is unpacked to
  the compute dtype right before the product.

The token embedding (``wte``) quantizes to per-row int8 in both formats
(``qtable`` + ``qscale (vocab, 1)``): rows stay gather-addressable, and
the tied head's ``x @ table.T`` takes each row's scale on the vocab axis
of the logits. ``wpe``, norms and biases stay full precision.

``qscale`` stays fp32 at every compute dtype (``gpt.cast_params`` leaves
it alone): int4's unpack and the embedding multiply in fp32 and cast
afterwards, and only the int8 product casts its scale to ``x.dtype``, as
the JAX package does. Rounding is ``torch.round`` (half to even, as
``jnp.round``), so the leaves are bit-equal to the JAX package's on the
same fp32 input.

``quantize_params`` is a one-shot pass at engine build time
(``ServingConfig.make``), never inside a step."""
from __future__ import annotations

import torch

# dense sub-dicts under params["blocks"] whose kernels quantize
_BLOCK_KERNELS = ("attn_qkv", "attn_proj", "mlp_fc1", "mlp_fc2",
                  "mlp_fc3")


def _quantize_int8(kernel: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8: scale over the input axis
    (-2), shape ``(..., 1, dout)`` fp32."""
    k32 = kernel.float()
    scale = (k32.abs().amax(dim=-2, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.round(k32 / scale).clamp(-127, 127).to(torch.int8)
    return {"qkernel": q, "qscale": scale}


def _quantize_int4(kernel: torch.Tensor, group_size: int) -> dict:
    """Per-(input-group, output-channel) int4, offset 8 and packed two a
    byte along the input axis, the even input index in the low nibble."""
    din = kernel.shape[-2]
    if group_size < 2 or group_size % 2:
        raise ValueError(f"weights.group_size must be an even int >= 2, "
                         f"got {group_size}")
    if din % group_size:
        raise ValueError(
            f"weights.group_size={group_size} does not divide the kernel "
            f"input dim {din} — int4 groups must tile the input axis "
            "exactly")
    lead, dout = kernel.shape[:-2], kernel.shape[-1]
    k32 = kernel.float().reshape(*lead, din // group_size, group_size, dout)
    scale = (k32.abs().amax(dim=-2, keepdim=True) / 7.0).clamp_min(1e-8)
    q = torch.round(k32 / scale).clamp(-7, 7).to(torch.int16) + 8
    q = q.reshape(*lead, din, dout)
    packed = (q[..., 0::2, :] | (q[..., 1::2, :] << 4)).to(torch.uint8)
    return {"qkernel": packed, "qscale": scale[..., 0, :]}


def _unpack_int4(qkernel: torch.Tensor, qscale: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Packed ``(..., din/2, dout)`` uint8 + ``(..., G, dout)`` group
    scales -> the ``(..., din, dout)`` kernel in ``dtype`` (the nibbles
    are split in int16, whose shifts every device path has)."""
    wide = qkernel.to(torch.int16)
    lo, hi = (wide & 0xF) - 8, (wide >> 4) - 8
    lead = qkernel.shape[:-2]
    din, dout = qkernel.shape[-2] * 2, qkernel.shape[-1]
    k = torch.stack([lo, hi], dim=-2)          # (..., din/2, 2, dout)
    n_groups = qscale.shape[-2]
    k = k.reshape(*lead, n_groups, din // n_groups, dout)
    k = k.float() * qscale.float()[..., :, None, :]
    return k.reshape(*lead, din, dout).to(dtype)


def qmatmul(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(kernel)`` for a quantized dense dict (no bias). int8:
    the product runs over the 1-byte kernel widened to ``x.dtype`` and
    the per-output-channel scale multiplies the output; int4: the
    unpacked kernel feeds the product."""
    q, s = params["qkernel"], params["qscale"]
    if q.dtype == torch.int8:
        return (x @ q.to(x.dtype)) * s[..., 0, :].to(x.dtype)
    if q.dtype == torch.uint8:
        return x @ _unpack_int4(q, s, x.dtype)
    raise ValueError(f"qkernel dtype {q.dtype} is not a quantized weight "
                     "format (int8 = per-channel, uint8 = packed int4)")


def dequant_kernel(params: dict,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Full-precision reconstruction of one quantized dense kernel, for
    offline use (parity checks, merged references); the serving paths go
    through :func:`qmatmul`."""
    q, s = params["qkernel"], params["qscale"]
    if q.dtype == torch.int8:
        return (q.float() * s.float()).to(dtype)
    return _unpack_int4(q, s, dtype)


def _quantize_table(table: torch.Tensor) -> dict:
    """Per-row int8 for the embedding table: ``qtable (vocab, d)`` +
    ``qscale (vocab, 1)`` fp32."""
    t32 = table.float()
    scale = (t32.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.round(t32 / scale).clamp(-127, 127).to(torch.int8)
    return {"qtable": q, "qscale": scale}


def quantize_params(params: dict, dtype: str = "int8",
                    group_size: int = 64) -> dict:
    """One-shot weight quantization of a GPT params tree: every block
    dense kernel and the untied head kernel move to ``qkernel``/``qscale``
    in ``dtype``; ``wte`` moves to per-row int8 ``qtable``/``qscale`` in
    both formats. Biases, norms and ``wpe`` pass through. Quantized
    params are rejected: a second pass would re-round rounded values."""
    if dtype not in ("int8", "int4"):
        raise ValueError(f"weights dtype must be 'int8' or 'int4', got "
                         f"{dtype!r}")
    if is_quantized(params):
        raise ValueError(
            "params are already weight-quantized "
            f"({weights_dtype(params)}) — a second quantize_params pass "
            "would re-round already-rounded values")

    def q_dense(p: dict) -> dict:
        out = {k: v for k, v in p.items() if k != "kernel"}
        out.update(_quantize_int8(p["kernel"]) if dtype == "int8"
                   else _quantize_int4(p["kernel"], group_size))
        return out

    blocks = dict(params["blocks"])
    for name in _BLOCK_KERNELS:
        if name in blocks:
            blocks[name] = q_dense(blocks[name])
    out = {**params, "blocks": blocks}
    out["wte"] = {k: v for k, v in params["wte"].items() if k != "table"}
    out["wte"].update(_quantize_table(params["wte"]["table"]))
    if "head" in params:
        out["head"] = q_dense(params["head"])
    return out


def is_quantized(params: dict) -> bool:
    """True when the tree carries quantized weights (the ``qtable`` leaf:
    wte quantizes in every format)."""
    return "qtable" in params.get("wte", {})


def weights_dtype(params: dict) -> str:
    """``"bf16"`` (full-precision kernels, whatever their float dtype),
    ``"int8"`` or ``"int4"``, read off the tree."""
    if not is_quantized(params):
        return "bf16"
    q = params.get("blocks", {}).get("attn_qkv", {}).get("qkernel")
    if q is not None and q.dtype == torch.uint8:
        return "int4"
    return "int8"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def weight_stream_bytes(params: dict) -> int:
    """Modeled weight bytes a decode step reads: every block dense leaf
    (kernel or qkernel + qscale, plus bias), the LM head (the untied
    kernel, or the tied wte table the head product reads whole) and the
    final norm. Embedding gathers and ``wpe`` are excluded. Host
    arithmetic only."""
    total = 0

    def leaf_bytes(p: dict) -> int:
        return sum(_nbytes(p[k]) for k in ("kernel", "qkernel", "qscale",
                                           "bias") if k in p)

    for name in _BLOCK_KERNELS:
        if name in params["blocks"]:
            total += leaf_bytes(params["blocks"][name])
    if "head" in params:
        total += leaf_bytes(params["head"])
    else:
        wte = params["wte"]
        total += sum(_nbytes(wte[k]) for k in ("table", "qtable", "qscale")
                     if k in wte)
    total += sum(_nbytes(params["ln_f"][k]) for k in ("scale", "bias")
                 if k in params.get("ln_f", {}))
    return int(total)


__all__ = ["dequant_kernel", "is_quantized", "qmatmul", "quantize_params",
           "weight_stream_bytes", "weights_dtype"]
