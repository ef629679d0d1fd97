"""ZeRO-1: the optimizer update sharded across data-parallel ranks — the
port of ``torchbooster_tpu/comms/zero.py``.

Parameters ravel into ONE flat fp32 vector, in the JAX package's
``ravel_pytree`` order (keys sorted), padded to a multiple of
``n_shards * bucket_size``; rank *r* owns chunk *r*. The torch optimizer
is built over that chunk alone — a flat fp32 leaf of chunk size — so its
state (adam's moments) is created at shard size on the first step and
never materialized whole. Gradients reduce-scatter, each rank updates
its chunk, and the updated chunks all-gather back into the parameters.

The flat layout requires an elementwise optimizer: sgd, adam, adamw and
lion update a chunk bit-identically to the replicated update of the same
elements. A per-leaf one changes meaning on one flat leaf, as in the JAX
package, and the port keeps that behaviour: ``decay_matrices_only`` sees
a 1-D vector and turns weight decay off everywhere, lamb's trust ratio
becomes a per-chunk ratio, adafactor does not factor."""
from __future__ import annotations

from typing import Any

import torch

from torchbooster_tpu_torch.distributed import Mesh, all_gather, all_reduce

__all__ = ["flat_param", "init_opt_state", "opt_state_specs",
           "padded_size", "sharded_update"]


def padded_size(n_params: int, n_shards: int, bucket_size: int) -> int:
    """Flat length padded so every rank's chunk is a whole number of
    quantization buckets. The pad is zeros end to end: zero gradients
    give zero updates, so the pad region stays inert."""
    multiple = n_shards * bucket_size
    return n_params + (-n_params) % multiple


def opt_state_specs(optimizer: torch.optim.Optimizer,
                    axes: tuple[str, ...]) -> dict:
    """Spec of each per-parameter state entry of a flat-built optimizer:
    entries as long as the rank's chunk (adam's moments, momentum
    buffers) shard over the data axes, everything else (step counts)
    replicates."""
    out = {}
    for p, entries in optimizer.state.items():
        for key, value in entries.items():
            flat = isinstance(value, torch.Tensor) and value.ndim >= 1 \
                and value.shape[0] == p.numel()
            out[key] = (axes,) if flat else ()
    return out


def init_opt_state(tx: Any, params: Any, mesh: Mesh,
                   axes: tuple[str, ...], bucket_size: int,
                   shard: torch.Tensor | None = None
                   ) -> torch.optim.Optimizer:
    """The ZeRO-1 replacement for ``tx.init(params)``: the optimizer over
    this rank's chunk of the flat padded parameter vector (``shard``
    when given, else sliced from ``params``)."""
    if shard is None:
        from torchbooster_tpu_torch.comms.quantized import ravel
        from torchbooster_tpu_torch.parallel.sharding import tree_flatten

        leaves = [leaf.detach() for _, leaf in tree_flatten(params)]
        n = mesh.axes_size(axes)
        padded = padded_size(sum(p.numel() for p in leaves), n, bucket_size)
        chunk = padded // n
        start = mesh.linear_index(axes) * chunk
        shard = ravel(leaves, padded)[start:start + chunk].clone()
    shard.requires_grad_(True)
    return tx.init({"flat": shard})


def flat_param(optimizer: torch.optim.Optimizer, size: int) -> torch.Tensor:
    """The optimizer's one flat parameter of ``size`` elements. A state
    built by plain ``TrainState.create`` (one optimizer entry a leaf)
    fails with a pointer instead of a shape error."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if len(params) != 1 or params[0].ndim != 1 \
            or params[0].numel() != size:
        raise ValueError(
            "zero1 needs a flat sharded optimizer state — build the "
            "TrainState with GradComms.create_state(params, tx) (or "
            "comms.zero.init_opt_state), not TrainState.create")
    return params[0]


def clip_shard(g_shard: torch.Tensor, clip: float, group: Any) -> None:
    """Global-norm clipping of a sharded gradient in place: the chunks'
    sums of squares add up in one all-reduce (the pad is zero), then
    ``g · min(1, clip / (norm + 1e-6))``."""
    sq = (g_shard * g_shard).sum()
    all_reduce(sq, group)
    g_shard.mul_(torch.clamp(clip / (sq.sqrt() + 1e-6), max=1.0))


def sharded_update(tx: Any, comms: Any, clip: float | None,
                   grads: torch.Tensor, optimizer: torch.optim.Optimizer,
                   params: Any, scattered: bool = False) -> None:
    """One ZeRO-1 optimizer step, in place: this rank's gradient chunk
    (``grads`` is the chunk with ``scattered``, else the global-mean flat
    vector to slice), global-norm clipping, the update of the local
    chunk, and the all-gather of the updated chunks into ``params``. The
    optimizer's learning rate is the caller's to set."""
    from torchbooster_tpu_torch.comms.quantized import ravel
    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    mesh, axes, n = comms.mesh, comms.axes, comms.n_shards
    group = mesh.group(axes)
    leaves = [leaf for _, leaf in tree_flatten(params)]
    flat_n = sum(p.numel() for p in leaves)
    padded = comms.padded_size(flat_n)
    chunk = padded // n
    shard = flat_param(optimizer, chunk)
    start = mesh.linear_index(axes) * chunk
    with torch.no_grad():
        shard.copy_(ravel([p.detach() for p in leaves],
                          padded)[start:start + chunk])
        g_shard = grads if scattered else grads[start:start + chunk].clone()
        if clip is not None:
            clip_shard(g_shard, clip, group)
    shard.grad = g_shard
    tx.clip_units({"flat": shard})
    optimizer.step()
    shard.grad = None
    with torch.no_grad():
        full = torch.empty(padded, dtype=torch.float32, device=shard.device)
        all_gather(full, shard.detach(), group)
        off = 0
        for p in leaves:
            p.copy_(full[off:off + p.numel()].reshape(p.shape))
            off += p.numel()
