"""Static traffic models — the port of ``torchbooster_tpu/comms/
accounting.py``, a copy (that module imports only ``re`` and
``typing``). The serving path reads three of them:
:func:`promotion_traffic` (bytes of promoting spilled KV pages host ->
device), :func:`disagg_traffic` (bytes one request's page stream
carries from a prefill engine to a decode engine) and
:func:`spill_breakeven` (the spill tier's stream-versus-recompute
roofline). The gradient-sync models (:func:`step_traffic`,
:func:`overlap_report`, :func:`record_step_traffic`) and the compiled
HLO reader (:func:`xla_collective_traffic`) come along unchanged; their
collectives are ring conventions:

- all-reduce of ``B`` bytes:        ``2 * (N-1)/N * B``
- reduce-scatter / all-to-all:      ``(N-1)/N * B``   (B = full input)
- all-gather:                       ``(N-1)/N * B``   (B = gathered out)
"""
from __future__ import annotations

import re
from typing import Any

__all__ = ["disagg_traffic", "overlap_report", "promotion_traffic",
           "spill_breakeven", "step_traffic", "record_step_traffic",
           "xla_collective_traffic"]

SCALE_BYTES = 4      # fp32 per-bucket scales
GRAD_BYTES = 4       # fp32 gradients / master params

_WIRE_BYTES = {"fp32": 4.0, "bf16": 2.0}


def padded_size(n_params: int, n_shards: int, bucket_size: int) -> int:
    """Flat length padded so every replica's chunk is a whole number of
    quantization buckets (the JAX package's ``comms/zero.py``
    ``padded_size``)."""
    multiple = n_shards * bucket_size
    return n_params + (-n_params) % multiple


def step_traffic(n_params: int, n_shards: int, mode: str,
                 zero1: bool, bucket_size: int, stage: int | None = None,
                 overlap: bool = False, padded: int | None = None
                 ) -> dict:
    """Per-replica bytes the gradient sync of one train step moves,
    broken down per collective. ``n_params`` is the raw parameter
    count; the model accounts for padding to
    ``n_shards * bucket_size`` and, for int8, the fp32 scale
    sidecars. ``implicit`` mode models the all-reduce XLA inserts on
    its own (fp32 ring) so A/B deltas are computable before flipping
    the YAML line.

    ``stage`` prices the full ZeRO ladder (None maps the legacy
    ``zero1`` flag onto stages 0/1). Stage 2 moves the same bytes as
    stage 1 with an explicit wire — the reduce-scatter just splits
    into per-bucket collectives issued during backward (pass the
    bucket plan's ``padded`` total, which carries per-bucket padding).
    Stage 3 moves the grad reduce-scatter plus ONE fp32 param
    all-gather: it happens before forward instead of after the
    update, and the ``jax.checkpoint`` backward re-gather is CSE'd by
    XLA while the gathered buffer is live (the HLO-validation tests
    pin this — on a backend that keeps the re-gather, add
    ``frac·4·padded``). ``overlap`` never changes the byte count,
    only whether compute hides it (see :func:`overlap_report`)."""
    n = max(1, n_shards)
    if stage is None:
        stage = 1 if zero1 else 0
    zero1 = stage >= 1
    if padded is None:
        padded = padded_size(n_params, n, bucket_size)
    frac = (n - 1) / n
    per: dict[str, float] = {}
    if stage >= 2 and mode == "implicit":
        raise ValueError("step_traffic: stage >= 2 needs an explicit "
                         "wire format (fp32/bf16/int8)")
    if mode in ("implicit", "fp32"):
        if zero1 and mode == "fp32":
            per["grad_reduce_scatter"] = frac * GRAD_BYTES * padded
        else:
            # implicit+zero1 still pays the full implicit all-reduce:
            # the replicated grads are sliced locally, for free
            per["grad_all_reduce"] = 2 * frac * GRAD_BYTES * padded
    elif mode in _WIRE_BYTES or mode == "int8":
        if mode == "int8":
            payload = padded * (1 + SCALE_BYTES / bucket_size)
        else:
            payload = padded * _WIRE_BYTES[mode]
        per["grad_all_to_all"] = frac * payload
        if not zero1:
            per["grad_all_gather"] = frac * payload
    else:
        raise ValueError(f"step_traffic: unknown mode {mode!r}")
    if zero1:
        per["param_all_gather"] = frac * GRAD_BYTES * padded
    total = sum(per.values())
    return {
        "mode": mode, "zero1": bool(zero1), "n_shards": n,
        "stage": stage, "overlap": bool(overlap),
        "padded_params": padded,
        "per_collective": {k: round(v, 1) for k, v in per.items()},
        "total_bytes": round(total, 1),
        "grad_bytes": round(total - per.get("param_all_gather", 0.0), 1),
    }


def overlap_report(step_s_on: float, step_s_off: float,
                   grad_bytes: float,
                   bandwidth_gbs: float | None = None,
                   tolerance: float = 0.05) -> dict:
    """The overlap-verification gate: prove bytes are actually hidden
    by comparing wall-clock step time against the serialized model.

    The serialized roofline says ``step = compute + comms``; the
    overlapped roofline says ``step = max(compute, comms)``. Both arms
    move IDENTICAL bytes (``overlap`` is a scheduling choice, not a
    wire change), so the overlap-off arm measures
    ``compute + comms_exposed`` and every second the overlap-on arm
    shaves off is communication hidden behind backward compute:
    ``hidden_bytes = grad_bytes · hidden_s / comms_s``. With a
    ``bandwidth_gbs`` estimate the report also models ``comms_s`` and
    the hidden fraction; without one it still answers the gate
    question — overlap-on must not be slower than overlap-off (within
    ``tolerance``, the measurement noise floor). Mirrors the
    accounting-vs-HLO 10% gate in spirit: a schedule that *claims*
    overlap but serializes anyway fails loudly in the bench instead
    of shipping a no-op knob."""
    out = {
        "step_s_on": round(step_s_on, 6),
        "step_s_off": round(step_s_off, 6),
        "speedup": round(step_s_off / step_s_on, 4) if step_s_on else None,
        "hidden_s": round(max(0.0, step_s_off - step_s_on), 6),
        "grad_bytes": round(grad_bytes, 1),
        "overlap_ok": step_s_on <= step_s_off * (1.0 + tolerance),
    }
    if bandwidth_gbs:
        comms_s = grad_bytes / (bandwidth_gbs * 1e9)
        out["modeled_comms_s"] = round(comms_s, 6)
        out["serialized_model_s"] = round(step_s_off, 6)
        out["overlapped_model_s"] = round(
            max(step_s_off - comms_s, comms_s), 6)
        if comms_s > 0:
            frac = min(1.0, out["hidden_s"] / comms_s)
            out["hidden_frac"] = round(frac, 4)
            out["hidden_bytes"] = round(grad_bytes * frac, 1)
    return out


def record_step_traffic(traffic: dict, registry: Any = None) -> None:
    """Land one step's modeled bytes on the ``comms_bytes_total``
    counter, labeled per collective — the export path the YAML
    ``observability:`` block drains."""
    from torchbooster_tpu_torch.observability import get_registry

    reg = registry if registry is not None else get_registry()
    if not reg.enabled:
        return
    counter = reg.counter(
        "comms_bytes_total",
        "modeled per-replica gradient-sync bytes moved")
    for name, n_bytes in traffic["per_collective"].items():
        counter.inc(n_bytes, collective=name, mode=traffic["mode"])


def promotion_traffic(n_pages: int, *, page_size: int, kv_heads: int,
                      head_dim: int, n_layers: int,
                      scale_bytes: int = SCALE_BYTES) -> dict:
    """Host->HBM bytes of promoting ``n_pages`` spilled KV pages —
    the PCIe (or, for a peer fetch, ICI) stream the spill tier pays
    INSTEAD of recompute FLOPs. The payload is the engine's demotion
    format exactly: per page, K and V as int8 (1 byte/elem over
    ``n_layers * page_size * kv_heads * head_dim``) plus one fp32
    scale per (layer, token, head) — per-(token, head) symmetric
    quantization, ``models/gpt._quantize_kv``'s shape. Integer bytes:
    the serve_spill bench gates this model EQUAL to the engine's
    measured ``promoted_bytes`` counter, not approximately so."""
    if n_pages < 0:
        raise ValueError(f"n_pages must be >= 0, got {n_pages}")
    elems = n_layers * page_size * kv_heads
    per_page = 2 * elems * head_dim + 2 * elems * scale_bytes
    return {
        "n_pages": int(n_pages),
        "payload_bytes_per_page": 2 * elems * head_dim,
        "scale_bytes_per_page": 2 * elems * scale_bytes,
        "per_page_bytes": per_page,
        "total_bytes": per_page * int(n_pages),
    }


def disagg_traffic(prompt_len: int, *, page_size: int, kv_heads: int,
                   head_dim: int, n_layers: int,
                   scale_bytes: int = SCALE_BYTES) -> dict:
    """Prefill->decode wire bytes of disaggregating ONE request —
    what the page stream between a prefill pool and a decode pool
    carries instead of the decode pool burning prefill FLOPs. The
    stream ships the request's leading FULL prompt pages
    (``(prompt_len - 1) // page_size`` — the prefix matcher's cap;
    the decode side always re-runs the final chunk itself) in the
    demotion payload format, so the per-page cost is byte-identical
    to :func:`promotion_traffic`'s: K and V as int8 plus one fp32
    scale per (layer, token, head). Integer bytes: the serve_disagg
    bench gates this model EQUAL to the pair's measured
    ``page_bytes_streamed`` counter (payload frames only — the JSON
    routing header is transport overhead the model deliberately
    excludes, reported separately as ``framed_bytes_streamed``)."""
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    n_pages = (int(prompt_len) - 1) // int(page_size)
    out = promotion_traffic(
        n_pages, page_size=page_size, kv_heads=kv_heads,
        head_dim=head_dim, n_layers=n_layers, scale_bytes=scale_bytes)
    out["prompt_len"] = int(prompt_len)
    return out


def spill_breakeven(*, n_params: int, page_size: int,
                    per_page_bytes: int, h2d_gbs: float,
                    flops_tps: float, launch_s: float = 50e-6,
                    n_pages: int | None = None) -> dict:
    """The spill tier's roofline (docs/performance.md "Page spill
    tier"): a host-tier hit streams ``per_page_bytes`` per page over
    PCIe at ``h2d_gbs`` GB/s; a cold miss recomputes prefill at ``2 *
    n_params`` FLOPs per token on a ``flops_tps`` TFLOP/s chip. Both
    costs are LINEAR in pages, so which side wins per page never
    changes with prefix length — what makes short prefixes lose is
    the fixed ``launch_s`` overhead of the promotion dispatch
    (staging device_put + one executable launch). Break-even prefix
    length::

        P* = launch_s / (recompute_s_per_page - host_s_per_page)

    — float('inf') when the stream is no faster per page than
    recompute (then the tier only ever saves FLOPs, never TTFT, and
    the operator should shrink ``budget_mb`` to zero). Pass
    ``n_pages`` to also evaluate both modeled TTFTs at a concrete
    prefix."""
    if h2d_gbs <= 0 or flops_tps <= 0:
        raise ValueError(
            f"h2d_gbs and flops_tps must be > 0, got {h2d_gbs}, "
            f"{flops_tps}")
    host_s = per_page_bytes / (h2d_gbs * 1e9)
    rec_s = 2.0 * n_params * page_size / (flops_tps * 1e12)
    gain = rec_s - host_s
    out = {
        "host_s_per_page": host_s,
        "recompute_s_per_page": rec_s,
        "launch_s": float(launch_s),
        "breakeven_pages": (launch_s / gain) if gain > 0
        else float("inf"),
        "host_wins_per_page": gain > 0,
    }
    if n_pages is not None:
        out["n_pages"] = int(n_pages)
        out["ttft_host_s"] = launch_s + n_pages * host_s
        out["ttft_recompute_s"] = n_pages * rec_s
    return out


# `= f32[2,4]{1,0} all-reduce(` / `= (s8[512]{0}, f32[4]{0}) all-to-all(`
_COLLECTIVE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\]\S*)\s+"
    r"(all-reduce|all-gather|all-to-all|reduce-scatter|"
    r"collective-permute)(?:-start)?\(")
_SHAPE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")
_GROUPS_LIST = re.compile(r"replica_groups=\{\{([0-9,]+)\}")
_GROUPS_IOTA = re.compile(r"replica_groups=\[([0-9]+),([0-9]+)\]")

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
                "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "f32": 4,
                "s64": 8, "u64": 8, "f64": 8}


def _shape_bytes(text: str) -> float:
    total = 0.0
    for dtype, dims in _SHAPE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        count = 1
        for d in dims.split(","):
            if d:
                count *= int(d)
        total += count * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_LIST.search(line)
    if m:
        return len(m.group(1).split(","))
    m = _GROUPS_IOTA.search(line)
    if m:                     # iota v2: [num_groups, group_size]
        return int(m.group(2))
    return default


def xla_collective_traffic(compiled: Any,
                           default_group: int = 1) -> dict:
    """Price the collectives in a compiled executable with the same
    ring conventions as :func:`step_traffic`. Shapes in the
    SPMD-partitioned module are per-replica, so: all-to-all and
    all-reduce read their printed (local) shape directly; all-gather's
    printed shape is the gathered output ((G-1)/G of it crosses the
    wire); reduce-scatter's printed output is 1/G of the input it
    reduced. Returns ``{"total_bytes", "ops": [...]}`` — the
    validation anchor the accounting tests compare the static model
    against."""
    text = compiled.as_text() if hasattr(compiled, "as_text") else str(
        compiled)
    ops = []
    total = 0.0
    for match in _COLLECTIVE.finditer(text):
        shape_text, kind = match.group(1), match.group(2)
        line = text[match.start():text.find("\n", match.start())]
        g = _group_size(line, default_group)
        if g <= 1:
            continue
        payload = _shape_bytes(shape_text)
        frac = (g - 1) / g
        if kind == "all-reduce":
            wire = 2 * frac * payload
        elif kind == "reduce-scatter":
            wire = frac * payload * g      # printed shape = output = in/G
        elif kind == "collective-permute":
            wire = payload
        else:                              # all-gather / all-to-all
            wire = frac * payload
        total += wire
        ops.append({"op": kind, "group": g,
                    "payload_bytes": round(payload, 1),
                    "wire_bytes": round(wire, 1)})
    return {"total_bytes": round(total, 1), "ops": ops}
