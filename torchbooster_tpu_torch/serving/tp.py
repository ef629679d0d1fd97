"""Tensor-parallel serving: the paged engine's head split over a ``tp``
mesh axis — the port of ``torchbooster_tpu/serving/tp.py``.

Decode reads the KV pool, so dividing its bytes is how the engine grows
past one card: every serving step's ATTENTION splits over the ``tp``
(heads) axis, Megatron-style, and everything else runs whole on every
rank. One process runs per rank, each holding:

- ``attn_qkv``: its columns, rank-major (``models.gpt.qkv_columns``:
  rank ``i`` holds ``[q_i | k_i | v_i]``), the quantized ``qkernel`` and
  ``qscale`` columns with them;
- ``attn_proj``: its input rows (the rows of its heads), int4's group
  ``qscale`` rows with them; the int8 per-output-channel scale is the
  same for every row slice and stays whole. One all-reduce after the
  product and before the bias is the step's one collective a layer
  (:func:`step_traffic` prices it);
- the KV page pool: ``kv_heads / tp`` heads of every page;
- everything else (embeddings, norms, MLP, head) whole.

GQA splits by KV-head groups, so ``tp`` must divide ``n_kv_heads`` (MHA:
``n_heads``). The engine's host bookkeeping (block tables, refcounts,
the prefix index, seat, retire, evict, copy-on-write) is the same on
every rank, which walks it over its own head shard; the batcher reads
its clock on the group's rank 0 (:func:`shared_clock`) so that every
rank takes the same decisions, and the sampling generators are seeded
alike on every rank. The JAX package's ``shard_engine_fn`` (a
``shard_map`` around each compiled step) has no counterpart here."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def check_tp(tp: int, cfg: Any, mesh: Any) -> None:
    """Validate a serving ``tp`` request (``tp.py:62``), with the JAX
    package's messages: ``tp`` positive, dividing the KV-head count
    (``n_kv_heads`` under GQA) and ``n_heads``, and at ``tp > 1`` a mesh
    whose ``tp`` axis has exactly that size."""
    if tp < 1:
        raise ValueError(f"serving.tp must be >= 1, got {tp}")
    if tp == 1:
        return
    if cfg.n_kv_heads and cfg.kv_heads % tp:
        raise ValueError(
            f"serving.tp={tp} does not divide n_kv_heads="
            f"{cfg.kv_heads}: GQA shards by KV-head groups (query "
            "heads follow their group), so tp must divide the "
            "KV-head count")
    if cfg.n_heads % tp:
        raise ValueError(
            f"serving.tp={tp} does not divide n_heads={cfg.n_heads}: "
            "tensor-parallel serving shards attention by heads")
    if mesh is None:
        raise ValueError(
            f"serving.tp={tp} needs a committed mesh with a 'tp' "
            f"axis of size {tp} (e.g. make_mesh('tp:{tp}')); got no "
            "mesh — the engine will not guess a device topology")
    if "tp" not in mesh.axis_names:
        raise ValueError(
            f"serving.tp={tp} but the mesh axes {mesh.axis_names} "
            "have no 'tp' axis to shard heads over")
    size = mesh.shape["tp"]
    if tp > size:
        raise ValueError(
            f"serving.tp={tp} exceeds the mesh's tp axis size "
            f"{size}: there are not enough chips on the axis")
    if tp != size:
        raise ValueError(
            f"serving.tp={tp} mismatches the mesh's tp axis size "
            f"{size}: the head shard_map split must be exact — "
            f"commit a mesh with tp:{tp}")


def param_specs(params: dict) -> dict:
    """Per leaf, the dimension this rank's slice is cut along, or None
    for a whole leaf (``tp.py:109``): qkv's kernel, quantized kernel,
    scale and bias along their columns; proj's kernel and quantized
    kernel along their rows, and its scale too where it has a row per
    group (int4), not one for all rows (int8)."""
    from torchbooster_tpu_torch.parallel.sharding import (
        path_str,
        tree_map_with_path,
    )

    def assign(path: tuple, leaf: Any) -> int | None:
        name = path_str(path)
        if name.endswith(("attn_qkv/kernel", "attn_qkv/qkernel",
                          "attn_qkv/qscale", "attn_qkv/bias")):
            return -1
        if name.endswith(("attn_proj/kernel", "attn_proj/qkernel")):
            return 1
        if name.endswith("attn_proj/qscale"):
            return 1 if leaf.shape[1] > 1 else None
        return None

    return tree_map_with_path(assign, params)


def place(params: dict, cfg: Any, tp: tuple, device: Any) -> dict:
    """This rank's serving tree (``tp.py:148``): each leaf's slice by
    :func:`param_specs` — qkv columns in rank-major order, unless the
    tree carries the ``_tp_major`` marker and is rank-major already —
    on ``device``."""
    from torchbooster_tpu_torch.models.gpt import (
        _TP_MAJOR_PREFIX,
        qkv_tp_permutation,
    )
    from torchbooster_tpu_torch.parallel.sharding import (
        tree_get,
        tree_map_with_path,
    )

    _, size, index = tp
    specs = param_specs(params)
    qkv = params["blocks"]["attn_qkv"]
    stamped = any(k.startswith(_TP_MAJOR_PREFIX) for k in qkv)
    perm = None if stamped else torch.as_tensor(
        qkv_tp_permutation(cfg, size))

    def cut(path: tuple, leaf: torch.Tensor) -> torch.Tensor:
        dim = tree_get(specs, path)
        leaf = leaf.to(device)
        if dim is None:
            return leaf
        if dim == -1 and perm is not None:
            leaf = leaf.index_select(-1, perm.to(leaf.device))
        per = leaf.shape[dim] // size
        return leaf.narrow(dim, index * per, per).contiguous()

    return tree_map_with_path(cut, params)


def local_cfg(cfg: Any, tp: int) -> Any:
    """The geometry of one rank's pool: ``kv_heads / tp`` heads of the
    same head dim."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, d_model=cfg.d_model // tp,
                               n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.kv_heads // tp)


def shared_clock(clock: Callable[[], float], group: Any,
                 device: Any) -> Callable:
    """``clock`` read on the group's rank 0 and broadcast: every rank of
    a tensor-parallel engine decides deadlines, SLO classes, shedding and
    preemption on the same reading, so their steps stay in lockstep. The
    reading travels on ``device``, the engine's (NCCL takes only tensors
    on the card)."""
    from torchbooster_tpu_torch import distributed as dist

    def read() -> float:
        t = torch.tensor([clock()], dtype=torch.float64, device=device)
        dist.broadcast(t, group, src=_group_root(group))
        return float(t.item())

    return read


def _group_root(group: Any) -> int:
    import torch.distributed as tdist

    return tdist.get_global_rank(group, 0) if group is not None else 0


def step_traffic(tp: int, cfg: Any, max_slots: int,
                 compute_dtype: torch.dtype, s_q: int = 1) -> dict:
    """Per-rank wire bytes of ONE serving step's decode-output
    all-reduce (``tp.py:197``), priced as a ring all-reduce,
    ``2·(N-1)/N`` of the payload ``max_slots · s_q · d_model`` in the
    compute dtype, once a layer."""
    if tp <= 1:
        return {"tp": max(tp, 1), "payload_bytes": 0,
                "per_layer_wire_bytes": 0.0, "wire_bytes": 0.0,
                "psums_per_step": 0}
    itemsize = torch.empty((), dtype=compute_dtype).element_size()
    payload = max_slots * s_q * cfg.d_model * itemsize
    per_layer = 2 * (tp - 1) / tp * payload
    return {"tp": tp, "payload_bytes": payload,
            "per_layer_wire_bytes": round(per_layer, 1),
            "wire_bytes": round(cfg.n_layers * per_layer, 1),
            "psums_per_step": cfg.n_layers}


__all__ = ["check_tp", "local_cfg", "param_specs", "place",
           "shared_clock", "step_traffic"]
