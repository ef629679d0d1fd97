"""Mixture-of-Experts layer with expert parallelism — the port of
``torchbooster_tpu/models/moe.py``.

Tokens route top-k into per-expert capacity buffers — by flat-index
scatter/gather (``"scatter"``, the default) or by the GShard one-hot
dispatch/combine einsums (``"einsum"``, the parity oracle) — the expert
MLPs run as one batched matmul pair over the stacked expert weights,
and the results combine back weighted by the gate. Capacity is static:
``C = int(k·T/E · capacity_factor + 0.5)``, never below ``k``; overflow
tokens drop (their contribution is zero; the residual around the block
carries them). The Switch load-balance loss ``E · Σ_e frac_e ·
mean_prob_e`` comes back beside the output.

Across ranks (no JAX counterpart is needed for what GSPMD does there):

- **Global capacity** (``shards``). The JAX package's ``moe_apply`` sees
  the global ``(B·S, d)`` token array, so capacity and each token's
  position in its expert's buffer are taken over the whole batch in
  ``b·S + s`` order. A rank holds only its rows and its sequence chunk:
  it gathers every rank's per-(row, chunk, expert) counts over the data
  and ``sp`` axes and builds each token's position from them, and
  ``frac`` and ``mean_prob`` are sums over the same ranks divided by the
  global token count. The same tokens drop as under JAX.
- **Expert parallelism** (``ep``, JAX ``:164-194``). Each rank holds
  ``E/size`` experts, routes every token globally, scatters only to its
  own experts, and one all-reduce over the ``ep`` group adds the results
  up. The tokens and gate weights enter through
  :func:`~torchbooster_tpu_torch.distributed.copy_to_group` (identity,
  gradient all-reduced) and the result leaves through
  :func:`~torchbooster_tpu_torch.distributed.reduce_from_group`
  (all-reduce, identity gradient), so the replicated tokens' gradient
  equals JAX's, where ``shard_map`` sums a replicated input's cotangent.
- **Tensor parallelism** (``tp``, JAX ``reduce=``, ``:89-108``). Each
  rank holds a slice of every expert's hidden units: fc1's columns and
  fc2's rows. Routing runs whole on every rank; the tokens enter the
  experts through ``copy_to_group`` and fc2's partial products are
  all-reduced over the ``tp`` group before its bias, as the dense
  blocks' ``_row_dense`` does. It composes with ``ep``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F

from torchbooster_tpu_torch import distributed as dist
from torchbooster_tpu_torch.models import layers as L

# rules fragment for a stacked-MoE block (leading axis = the layer axis):
# experts shard over ep, hidden over tp (``moe.py:39``)
SHARDING_RULES = [
    (r"moe_gate/kernel", (None, None, None)),
    (r"moe_fc1/kernel", (None, "ep", None, "tp")),
    (r"moe_fc1/bias", (None, "ep", "tp")),
    (r"moe_fc2/kernel", (None, "ep", "tp", None)),
    (r"moe_fc2/bias", (None, "ep", None)),
]

def moe_init(gen: torch.Generator, n_experts: int, d_model: int,
             hidden: int, std: float = 0.02, out_std: float | None = None,
             dtype: torch.dtype = torch.float32, lead: tuple = ()) -> dict:
    """Stacked expert MLPs and the gate (``moe.py:48``): gate ``(d, E)``
    without a bias, fc1 ``(E, d, h)``, fc2 ``(E, h, d)``, zero biases,
    each with ``lead`` dimensions in front (GPT's stacked layer axis),
    drawn on the CPU from ``gen``."""
    out_std = std if out_std is None else out_std

    def normal(shape, s):
        return (torch.randn((*lead, *shape), generator=gen) * s).to(dtype)

    def zeros(shape):
        return torch.zeros((*lead, *shape), dtype=dtype)

    return {
        "moe_gate": {"kernel": normal((d_model, n_experts), std)},
        "moe_fc1": {"kernel": normal((n_experts, d_model, hidden), std),
                    "bias": zeros((n_experts, hidden))},
        "moe_fc2": {"kernel": normal((n_experts, hidden, d_model), out_std),
                    "bias": zeros((n_experts, d_model))},
    }


@dataclass(frozen=True)
class TokenShards:
    """Where this rank's ``(b, s)`` tokens sit in the global batch:
    ``group`` spans the data and ``sp`` axes, ``members[i]`` is group rank
    ``i``'s ``(data index, sp index)``, and this rank is ``(data, sp)``
    of ``n_data`` row shards and ``n_sp`` sequence chunks."""

    group: Any
    members: tuple
    n_data: int
    n_sp: int
    data: int
    sp: int

    @property
    def n(self) -> int:
        return self.n_data * self.n_sp


def token_shards(mesh: Any) -> TokenShards | None:
    """The :class:`TokenShards` of ``mesh``'s token axes (data axes and
    ``sp``), or None when this rank holds every token (no group, or one
    rank over those axes)."""
    if mesh is None or not mesh.distributed:
        return None
    axes = mesh.token_axes()
    if mesh.axes_size(axes) == 1:
        return None
    sizes = [mesh.shape[a] for a in axes]
    data_axes = [a for a in axes if a != "sp"]
    members = []
    for i in range(mesh.axes_size(axes)):
        coords = dict(zip(axes, _unravel(i, sizes)))
        d = 0
        for a in data_axes:
            d = d * mesh.shape[a] + coords[a]
        members.append((d, coords.get("sp", 0)))
    return TokenShards(group=mesh.group(axes), members=tuple(members),
                       n_data=mesh.axes_size(data_axes),
                       n_sp=mesh.shape.get("sp", 1),
                       data=mesh.linear_index(data_axes),
                       sp=mesh.coords().get("sp", 0))


def _unravel(i: int, sizes: list) -> list:
    out = []
    for size in reversed(sizes):
        out.append(i % size)
        i //= size
    return out[::-1]


def _positions(onehots: torch.Tensor, b: int, s: int,
               shards: TokenShards | None) -> torch.Tensor:
    """Each (round, token)'s position in its expert's buffer, ``(k, T)``:
    the number of assignments to the same expert before it in the global
    ``b·S + s`` order, rounds after rounds (``moe.py:126-140``: a cumsum
    over tokens, ``fill`` carried across rounds). ``onehots`` is the
    ``(k, T, E)`` int64 routing of this rank's tokens."""
    k, _, n_e = onehots.shape
    local = onehots.reshape(k, b, s, n_e)
    counts = local.sum(2)                                   # (k, b, E)
    if shards is None:
        n_data = n_sp = 1
        mine = (0, 0)
        glob = counts[:, None, :, None]                 # (k, 1, b, 1, E)
    else:
        n_data, n_sp = shards.n_data, shards.n_sp
        mine = (shards.data, shards.sp)
        got = torch.empty((shards.n * k, b, n_e), dtype=counts.dtype,
                          device=counts.device)
        dist.all_gather(got, counts.contiguous(), shards.group)
        got = got.reshape(shards.n, k, b, n_e)
        glob = torch.zeros((k, n_data, b, n_sp, n_e), dtype=counts.dtype,
                           device=counts.device)
        for g, (d, r) in enumerate(shards.members):
            glob[:, d, :, r] = got[g]
    flat = glob.reshape(k, -1, n_e)                     # global (row, chunk)
    before = flat.cumsum(1) - flat                      # exclusive prefix
    total = flat.sum(1)                                 # (k, E)
    fill = total.cumsum(0) - total                      # earlier rounds'
    base = before.reshape(k, n_data, b, n_sp, n_e)[:, mine[0], :, mine[1]]
    position = local.cumsum(2) - 1 + base[:, :, None] + fill[:, None, None]
    return (position * local).sum(-1).reshape(k, b * s)


def moe_apply(params: dict, x: torch.Tensor, top_k: int = 2,
              capacity_factor: float = 1.25,
              activation: Callable | None = None,
              impl: str = "scatter",
              ep: tuple[Any, int, int] | None = None,
              shards: TokenShards | None = None,
              tp: tuple[Any, int, int] | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, d) → ((B, S, d), aux_loss) (``moe.py:70``). Top-``top_k``
    routing with static per-expert capacity over the global token count;
    dropped tokens give zeros. ``activation`` defaults to JAX's gelu
    (the tanh approximation).

    ``impl``: ``"scatter"`` (tokens scatter into an ``(E·C, d)`` buffer
    by flat slot id and gather back; no ``(T, E, C)`` tensor exists) or
    ``"einsum"`` (the one-hot dispatch/combine oracle).

    ``ep=(group, size, index)``: this rank holds expert slice ``index``
    of ``size`` (``E/size`` experts each; the gate stays whole) and the
    tokens replicate over ``group``; scatter only.

    ``shards``: this rank's tokens are one block of a batch split over
    ranks (:func:`token_shards`); capacity, positions and the aux loss
    are then the global batch's.

    ``tp=(group, size, index)``: this rank holds hidden slice ``index``
    of ``size`` of every expert (fc1 columns and bias, fc2 rows); fc2's
    partial products are summed over ``group`` before its bias
    (``moe.py:142-151``); scatter only."""
    if activation is None:
        activation = lambda h: F.gelu(h, approximate="tanh")
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    t_local = tokens.shape[0]
    t = t_local * (shards.n if shards is not None else 1)
    n_experts = params["moe_gate"]["kernel"].shape[-1]
    capacity = int((top_k * t / n_experts) * capacity_factor + 0.5)
    capacity = max(capacity, top_k)

    gate_logits = L.dense(params["moe_gate"], tokens)      # (T, E)
    probs = torch.softmax(gate_logits.float(), dim=-1)

    experts, weights, onehots = [], [], []
    remaining = probs
    for _ in range(top_k):
        expert = torch.argmax(remaining, dim=-1)           # (T,)
        weights.append(torch.gather(remaining, -1, expert[:, None])[:, 0])
        onehot = F.one_hot(expert, n_experts)
        experts.append(expert)
        onehots.append(onehot)
        remaining = remaining * (1.0 - onehot.float())
    pos = _positions(torch.stack(onehots), b, s, shards)   # (k, T)
    keep = pos < capacity

    def expert_mlps(expert_in: torch.Tensor) -> torch.Tensor:
        w1 = params["moe_fc1"]["kernel"].to(x.dtype)
        w2 = params["moe_fc2"]["kernel"].to(x.dtype)
        h = activation(torch.bmm(expert_in, w1)
                       + params["moe_fc1"]["bias"].to(x.dtype)[:, None, :])
        out = torch.bmm(h, w2)
        if tp is not None:
            out = dist.reduce_from_group(out, tp[0])
        return out + params["moe_fc2"]["bias"].to(x.dtype)[:, None, :]

    if impl == "scatter":
        w = torch.stack(weights)                           # (k, T) fp32
        if ep is not None:
            group, ep_size, ep_index = ep
            local_e = params["moe_fc1"]["kernel"].shape[0]
            if local_e * ep_size != n_experts:
                raise ValueError(
                    f"moe_apply(ep=size {ep_size}): local expert slice "
                    f"{local_e} x {ep_size} != gate's {n_experts} experts")
            lo = ep_index * local_e
            tokens = dist.copy_to_group(tokens, group)
            w = dist.copy_to_group(w, group)
        else:
            local_e, lo = n_experts, 0
        if tp is not None:
            tokens = dist.copy_to_group(tokens, tp[0])
        # one spare row takes every dropped or foreign assignment: a
        # scatter there is discarded, a gather there reads zeros
        spare = local_e * capacity
        flat = torch.zeros((spare + 1, d), dtype=x.dtype, device=x.device)
        dsts = []
        for r in range(top_k):
            local_idx = experts[r] - lo
            ok = keep[r] & (local_idx >= 0) & (local_idx < local_e)
            dst = torch.where(ok, local_idx * capacity + pos[r],
                              torch.full_like(pos[r], spare))
            dsts.append(dst)
            flat = flat.index_add(0, dst, tokens)
        expert_out = expert_mlps(flat[:spare].reshape(local_e, capacity, d))
        flat_out = torch.cat([expert_out.reshape(spare, d),
                              torch.zeros((1, d), dtype=x.dtype,
                                          device=x.device)])
        out = torch.zeros((t_local, d), dtype=x.dtype, device=x.device)
        for r in range(top_k):
            # index_select, whose backward is an index_add: each real
            # slot is read by one assignment (the spare row by many)
            out = out + w[r].to(x.dtype)[:, None] \
                * flat_out.index_select(0, dsts[r])
        if ep is not None:
            out = dist.reduce_from_group(out, ep[0])
    elif impl == "einsum":
        if ep is not None or tp is not None:
            raise ValueError(
                "manual ep is wired for the scatter impl only (the "
                "einsum oracle is a global-dispatch parity check)")
        slots = torch.arange(capacity, device=x.device)
        combine = torch.zeros((t_local, n_experts, capacity),
                              dtype=torch.float32, device=x.device)
        dispatch = torch.zeros(combine.shape, dtype=torch.bool,
                               device=x.device)
        for r in range(top_k):
            pos_oh = (pos[r][:, None] == slots).float()
            slot = onehots[r].float()[:, :, None] * pos_oh[:, None, :]
            slot = slot * keep[r][:, None, None].float()
            combine = combine + weights[r][:, None, None] * slot
            dispatch = dispatch | (slot > 0)
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), tokens)
        out = torch.einsum("tec,ecd->td", combine.to(x.dtype),
                           expert_mlps(expert_in))
    else:
        raise ValueError(f"unknown moe impl {impl!r}")

    # Switch-style load-balance loss: E * sum_e(frac_e * mean_prob_e)
    top1 = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top1, n_experts).float().sum(0)
    prob = probs.sum(0)
    if shards is not None:
        frac = frac.clone()
        dist.all_reduce(frac, shards.group)
        prob = dist.all_reduce_sum(prob, shards.group)
    aux = n_experts * torch.sum((frac / t) * (prob / t))
    return out.reshape(b, s, d), aux


__all__ = ["SHARDING_RULES", "TokenShards", "moe_apply", "moe_init",
           "token_shards"]
