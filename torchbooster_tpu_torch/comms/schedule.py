"""The comms schedule: ZeRO-2/3 and the backward-overlapped gradient sync
— the port of ``torchbooster_tpu/comms/schedule.py``.

- **stage 2 (ZeRO-2)**: gradients reduce-scatter bucket by bucket into
  the flat shard the ZeRO-1 optimizer owns. With ``overlap`` each
  bucket's reduce-scatter is issued from a gradient hook
  (``register_post_accumulate_grad_hook``) as soon as the bucket's last
  gradient has accumulated, while backward goes on with the earlier
  layers; every bucket is waited for before the update. Without
  ``overlap`` the same reduce-scatters run once after backward.
- **stage 3 (ZeRO-3)**: parameters stay sharded at rest —
  ``TrainState.params`` is this rank's flat fp32 shard. The forward
  all-gathers each bucket through an ``autograd.Function`` whose
  backward issues that bucket's reduce-scatter, so the gradient sync is
  inside backward by construction. Nothing holds a gathered bucket from
  the forward to the backward: saved-tensor hooks put a token in place
  of every saved view of a bucket, and the backward gathers that bucket
  again from the shard (JAX re-gathers under ``jax.checkpoint``) when
  it first needs it, in the order autograd visits the saved tensors —
  the same on every rank, whose graphs are the same — and keeps it to
  the end of the backward.

Collectives issued from autograd's thread run on the stream the backward
runs on: the collective waits on it, and waiting for the result orders
the update after the collective without a host sync.

Layout: parameters (in the JAX package's order, keys sorted) partition
into comm buckets of whole leaves, greedily grouped to ``bucket_mb``,
each padded to a multiple of ``n_shards * bucket_size``. The global flat
vector is the concatenation of the padded buckets, SHARD-MAJOR: rank
*r*'s shard is the concatenation of chunk *r* of every bucket. The
update is elementwise, so this layout updates as the ZeRO-1 ravel does.

Every bucket draws its int8 rounding noise from a generator seeded by
the step, the rank and the bucket, whether its reduce-scatter is issued
in a hook or after backward: overlap on and off give bit-identical
trajectories."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from torchbooster_tpu_torch.comms import GradComms, MODES, make_grad_comms

__all__ = ["BucketPlan", "CommsSchedule", "STAGES", "WIRES",
           "as_schedule", "make_schedule", "sharded_step"]

STAGES = (0, 1, 2, 3)
WIRES = ("fp32", "bf16", "int8")


def _pad_to(n: int, multiple: int) -> int:
    return n + (-n) % multiple


# =========================================================================
# BucketPlan: the static leaf → comm-bucket partition
# =========================================================================

@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static partition of a parameter tree into comm buckets (Python ints
    and the leaves' paths; the plan holds no tensors). The grouping
    depends only on leaf sizes and ``bucket_mb``, never on the shard
    count, so plans for different data-parallel worlds agree on the
    bucket boundaries — what the cross-world checkpoint restore relies
    on."""

    n_shards: int
    bucket_size: int                       # quantization bucket (elems)
    paths: tuple[tuple, ...]               # per leaf, in tree order
    shapes: tuple[tuple[int, ...], ...]    # per leaf
    dtypes: tuple[Any, ...]
    raw: tuple[int, ...]                   # per-bucket unpadded elems
    padded: tuple[int, ...]                # per-bucket padded elems
    spans: tuple[tuple[int, int], ...]     # per-bucket [leaf_lo, leaf_hi)

    @classmethod
    def build(cls, params: Any, n_shards: int, bucket_size: int,
              bucket_mb: float) -> "BucketPlan":
        from torchbooster_tpu_torch.parallel.sharding import tree_flatten

        pairs = tree_flatten(params)
        if not pairs:
            raise ValueError("BucketPlan.build: empty parameter pytree")
        sizes = [int(np.prod(leaf.shape)) if len(leaf.shape) else 1
                 for _, leaf in pairs]
        limit = float("inf") if bucket_mb <= 0 else bucket_mb * 1e6 / 4.0
        spans, raw = [], []
        lo, acc = 0, 0
        for i, size in enumerate(sizes):
            if acc > 0 and acc + size > limit:
                spans.append((lo, i))
                raw.append(acc)
                lo, acc = i, 0
            acc += size
        spans.append((lo, len(sizes)))
        raw.append(acc)
        multiple = max(1, n_shards) * bucket_size
        padded = tuple(_pad_to(r, multiple) for r in raw)
        return cls(n_shards=max(1, n_shards), bucket_size=bucket_size,
                   paths=tuple(p for p, _ in pairs),
                   shapes=tuple(tuple(leaf.shape) for _, leaf in pairs),
                   dtypes=tuple(leaf.dtype for _, leaf in pairs),
                   raw=tuple(raw), padded=padded, spans=tuple(spans))

    # ---- derived geometry ----

    @property
    def n_buckets(self) -> int:
        return len(self.raw)

    @property
    def total_raw(self) -> int:
        return sum(self.raw)

    @property
    def total_padded(self) -> int:
        return sum(self.padded)

    @property
    def chunks(self) -> tuple[int, ...]:
        """Per-bucket chunk (one rank's slice of that bucket)."""
        return tuple(p // self.n_shards for p in self.padded)

    @property
    def shard_size(self) -> int:
        return self.total_padded // self.n_shards

    def full_offset(self, b: int) -> int:
        return sum(self.padded[:b])

    def shard_offset(self, b: int) -> int:
        return sum(self.chunks[:b])

    # ---- packing and unpacking ----

    def _bucket_leaves(self, b: int, leaves: list) -> list:
        lo, hi = self.spans[b]
        return leaves[lo:hi]

    def ravel_bucket(self, b: int, bucket_leaves: list) -> torch.Tensor:
        """One bucket's leaves concatenated to fp32 and zero-padded to the
        bucket's padded size."""
        from torchbooster_tpu_torch.comms.quantized import ravel

        return ravel(bucket_leaves, self.padded[b])

    def unravel_bucket(self, b: int, flat: torch.Tensor) -> list:
        lo, hi = self.spans[b]
        out, off = [], 0
        for shape, dtype in zip(self.shapes[lo:hi], self.dtypes[lo:hi]):
            size = int(np.prod(shape)) if shape else 1
            out.append(flat[off:off + size].reshape(shape).to(dtype))
            off += size
        return out

    def leaves(self, params: Any) -> list:
        from torchbooster_tpu_torch.parallel.sharding import tree_flatten

        return [leaf for _, leaf in tree_flatten(params)]

    def tree(self, leaves: list) -> dict:
        """Nested dicts from the plan's paths and ``leaves``."""
        out: dict = {}
        for path, leaf in zip(self.paths, leaves):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        return out

    def pack(self, params: Any) -> torch.Tensor:
        """Full flat padded vector ``(total_padded,)`` in SHARD-MAJOR
        layout: ``flat[r·S : (r+1)·S]`` is rank *r*'s shard."""
        leaves = self.leaves(params)
        buckets = [self.ravel_bucket(b, self._bucket_leaves(b, leaves))
                   for b in range(self.n_buckets)]
        return torch.cat([bucket[r * c:(r + 1) * c]
                          for r in range(self.n_shards)
                          for bucket, c in zip(buckets, self.chunks)])

    def pack_shard(self, params: Any, idx: int) -> torch.Tensor:
        """Rank ``idx``'s shard ``(shard_size,)`` of :meth:`pack`."""
        leaves = self.leaves(params)
        return torch.cat([
            self.ravel_bucket(b, self._bucket_leaves(b, leaves))[
                idx * c:(idx + 1) * c]
            for b, c in enumerate(self.chunks)])

    def unpack(self, flat: torch.Tensor) -> dict:
        """Inverse of :meth:`pack` (full shard-major vector → tree)."""
        S = self.shard_size
        leaves = []
        for b in range(self.n_buckets):
            off, c = self.shard_offset(b), self.chunks[b]
            bucket = torch.cat([flat[r * S + off: r * S + off + c]
                                for r in range(self.n_shards)])
            leaves.extend(self.unravel_bucket(b, bucket))
        return self.tree(leaves)

    @torch.no_grad()
    def gather_into(self, shard: torch.Tensor, group: Any,
                    leaves: list) -> None:
        """Per-bucket all-gather of this rank's chunks, copied into the
        replicated parameter ``leaves`` — the ZeRO-2 tail param gather."""
        from torchbooster_tpu_torch.distributed import all_gather

        for b in range(self.n_buckets):
            off = self.shard_offset(b)
            full = torch.empty(self.padded[b], dtype=torch.float32,
                               device=shard.device)
            all_gather(full, shard[off:off + self.chunks[b]], group)
            for leaf, value in zip(self._bucket_leaves(b, leaves),
                                   self.unravel_bucket(b, full)):
                leaf.copy_(value)

    # ---- host-side (numpy) repacking for checkpoint resharding ----

    def strip_pads_host(self, flat: np.ndarray) -> np.ndarray:
        """``(total_padded,)`` shard-major host vector → ``(total_raw,)``
        raw elements in bucket order (pads dropped) — the world-size
        INDEPENDENT form checkpoints reshard through."""
        S = self.shard_size
        parts = []
        for b in range(self.n_buckets):
            off, c = self.shard_offset(b), self.chunks[b]
            bucket = np.concatenate(
                [flat[r * S + off: r * S + off + c]
                 for r in range(self.n_shards)])
            parts.append(bucket[:self.raw[b]])
        return np.concatenate(parts)

    def with_pads_host(self, raw: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`strip_pads_host` for THIS plan's world size
        — the restore-on-a-different-dp repacking step."""
        buckets, off = [], 0
        for r, p in zip(self.raw, self.padded):
            buckets.append(np.concatenate(
                [raw[off:off + r], np.zeros(p - r, dtype=raw.dtype)]))
            off += r
        shards = []
        for rep in range(self.n_shards):
            shards.extend(bucket[rep * c:(rep + 1) * c]
                          for bucket, c in zip(buckets, self.chunks))
        return np.concatenate(shards)


# =========================================================================
# The per-bucket hooks
# =========================================================================

class _GatherBucket(torch.autograd.Function):
    """ZeRO-3's just-in-time materialization of bucket ``b``: the forward
    all-gathers this rank's chunk into the full padded bucket; the
    backward hands the bucket's gradient to ``launch``, which issues its
    reduce-scatter (the all-gather's transpose) — the result is collected
    after backward, so no gradient flows on to the shard."""

    @staticmethod
    def forward(ctx, chunk, b, padded, group, launch):
        from torchbooster_tpu_torch.distributed import all_gather

        ctx.b, ctx.launch = b, launch
        full = torch.empty(padded, dtype=torch.float32, device=chunk.device)
        all_gather(full, chunk.detach(), group)
        return full

    @staticmethod
    def backward(ctx, grad):
        ctx.launch(ctx.b, grad.contiguous())
        return None, None, None, None, None


def gathered_params(plan: BucketPlan, shard: torch.Tensor, group: Any,
                    launch: Callable[[int, torch.Tensor], None],
                    regather: "_Regather | None" = None) -> dict:
    """Stage-3 forward: the full parameter tree from the flat shard,
    bucket by bucket, through the gather hooks. With ``regather`` each
    gathered bucket is registered with it, so that its saved views are
    gathered again in backward instead of being held."""
    leaves: list = []
    for b in range(plan.n_buckets):
        off = plan.shard_offset(b)
        full = _GatherBucket.apply(shard[off:off + plan.chunks[b]], b,
                                   plan.padded[b], group, launch)
        if regather is not None:
            regather.register(b, full)
        leaves.extend(plan.unravel_bucket(b, full))
    return plan.tree(leaves)


class _Regather:
    """Saved-tensor hooks for the stage-3 forward (``with regather:``).
    ``pack`` puts ``(bucket, size, stride, offset)`` in place of a saved
    tensor that views a gathered bucket's storage; ``unpack`` gathers the
    bucket again from this rank's chunk of the (not yet updated) shard
    the first time one of its views is asked for, and gives the same
    view of it. A re-gathered bucket is kept to the end of the backward
    (a stacked leaf spans every layer, so each layer's backward reads
    the same buckets); the order of the gathers is the order autograd
    unpacks in, the same on every rank."""

    def __init__(self, plan: BucketPlan, shard: torch.Tensor, group: Any):
        self.plan, self.shard, self.group = plan, shard, group
        self.storages: dict[int, int] = {}
        self.cached: dict[int, torch.Tensor] = {}
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                               self.unpack)

    def register(self, b: int, full: torch.Tensor) -> None:
        self.storages[full.untyped_storage().data_ptr()] = b

    def pack(self, t: torch.Tensor) -> Any:
        b = self.storages.get(t.untyped_storage().data_ptr()) \
            if t.device.type != "meta" else None
        if b is None:
            return t
        return (b, tuple(t.shape), t.stride(), t.storage_offset())

    def unpack(self, packed: Any) -> torch.Tensor:
        if isinstance(packed, torch.Tensor):
            return packed
        b, size, stride, offset = packed
        if b not in self.cached:
            from torchbooster_tpu_torch.distributed import all_gather

            off = self.plan.shard_offset(b)
            chunk = self.shard.detach()[off:off + self.plan.chunks[b]]
            full = torch.empty(self.plan.padded[b], dtype=torch.float32,
                               device=self.shard.device)
            all_gather(full, chunk, self.group)
            self.cached[b] = full
        return self.cached[b].as_strided(size, stride, offset)

    def __enter__(self) -> "_Regather":
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._hooks.__exit__(*exc)
        self.storages.clear()


def hook_buckets(plan: BucketPlan, leaves: list,
                 launch: Callable[[int, torch.Tensor], None]) -> list:
    """Stage-2 overlap: a post-accumulate-grad hook on every leaf; when
    the last leaf of a bucket has its gradient, the bucket's gradients
    are raveled (and dropped from the leaves) and its reduce-scatter is
    launched. Returns the hook handles."""
    owner = {}
    remaining = []
    for b, (lo, hi) in enumerate(plan.spans):
        remaining.append(hi - lo)
        for i in range(lo, hi):
            owner[i] = b

    def make_hook(i: int) -> Callable:
        def hook(_: torch.Tensor) -> None:
            b = owner[i]
            remaining[b] -= 1
            if remaining[b] == 0:
                launch(b, _ravel_grads(plan, b, leaves))
        return hook

    return [leaf.register_post_accumulate_grad_hook(make_hook(i))
            for i, leaf in enumerate(leaves)]


def _ravel_grads(plan: BucketPlan, b: int, leaves: list) -> torch.Tensor:
    """Bucket ``b``'s gradients raveled (zeros for a leaf without one),
    then dropped from the leaves: they live on in the shard."""
    mine = plan._bucket_leaves(b, leaves)
    flat = plan.ravel_bucket(b, [p.grad if p.grad is not None
                                 else torch.zeros_like(p) for p in mine])
    for p in mine:
        p.grad = None
    return flat


# =========================================================================
# CommsSchedule
# =========================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class CommsSchedule(GradComms):
    """The full gradient-communication plan: ZeRO stage, wire format,
    overlap and bucketing. ``mode``/``zero1`` stay consistent with
    ``stage``/``wire`` so the stage 0-1 paths are the legacy ones. Build
    with :func:`make_schedule` (validated), not the raw constructor."""

    stage: int = 0
    overlap: bool = False
    bucket_mb: float = 4.0

    @property
    def wire(self) -> str:
        """The gradient wire format (``implicit`` only via the legacy
        ``mode`` shim, stages 0-1)."""
        return self.mode

    def plan(self, params: Any = None) -> BucketPlan:
        """The (cached) bucket plan. Needs a parameter tree the first
        time — ``create_state`` builds and caches it; a restored stage-3
        state (flat params) needs :meth:`attach_plan` with a template."""
        cached = getattr(self, "_plan", None)
        if cached is not None:
            return cached
        if params is None:
            raise ValueError(
                "CommsSchedule has no bucket plan yet — build states "
                "with create_state(params, tx), or attach_plan(params)"
                " with a template pytree first")
        bucket_mb = self.bucket_mb if self.stage >= 2 else 0.0
        built = BucketPlan.build(params, self.n_shards, self.bucket_size,
                                 bucket_mb)
        object.__setattr__(self, "_plan", built)
        return built

    def attach_plan(self, params: Any) -> BucketPlan:
        """(Re)build the bucket plan from a template tree."""
        object.__setattr__(self, "_plan", None)
        return self.plan(params)

    def init_state(self, params: Any) -> dict:
        if self.stage < 2:
            return super().init_state(params)
        if self.wire != "int8":
            return {}
        plan = self.plan(params)
        return {"ef1": torch.zeros((1, plan.total_padded),
                                   dtype=torch.float32,
                                   device=self.mesh.device)}

    def create_state(self, params: Any, tx: Any, generator: Any = 0,
                     accumulate: bool = False, ema: bool = False):
        """Stage ≥ 2 states: the optimizer over this rank's flat shard
        (built at shard size) and, for stage 3, params stored AS the flat
        shard. The parameters are broadcast from rank 0 first."""
        if self.stage < 2:
            return super().create_state(params, tx, generator=generator,
                                        accumulate=accumulate, ema=ema)
        if accumulate:
            raise ValueError(
                "comms stage >= 2 does not compose with gradient "
                "accumulation (the accumulator would need the scatter "
                "layout); accumulate on the implicit path instead")
        from torchbooster_tpu_torch.comms import _NoOpt
        from torchbooster_tpu_torch.comms.zero import init_opt_state
        from torchbooster_tpu_torch.distributed import to_env
        from torchbooster_tpu_torch.utils import TrainState

        params = to_env(params, self.mesh)
        with torch.no_grad():
            shard = self.plan(params).pack_shard(
                params, self.mesh.linear_index(self.axes)).clone()
        state = TrainState.create(shard if self.stage >= 3 else params,
                                  _NoOpt(), generator=generator, ema=ema)
        state.optimizer = init_opt_state(tx, None, self.mesh, self.axes,
                                         self.bucket_size, shard=shard)
        state.comms = self.init_state(params)
        return state

    def gather_params(self, state_or_flat: Any) -> Any:
        """The full parameter tree of a stage-3 flat shard (or of a
        ``TrainState`` holding one), all-gathered; stage ≤ 2 states pass
        through unchanged."""
        flat = getattr(state_or_flat, "params", state_or_flat)
        if self.stage < 3:
            return flat
        from torchbooster_tpu_torch.distributed import all_gather

        plan = self.plan()
        full = torch.empty(plan.total_padded, dtype=torch.float32,
                           device=flat.device)
        all_gather(full, flat.detach(), self.mesh.group(self.axes))
        return plan.unpack(full)

    def step_traffic(self, n_params: int) -> dict:
        from torchbooster_tpu_torch.comms import accounting

        plan = getattr(self, "_plan", None)
        regathered = sum(plan.padded[b] for b in getattr(
            self, "_regathered", ())) if plan is not None else 0
        return accounting.step_traffic(
            n_params, self.n_shards, self.mode, self.zero1,
            self.bucket_size, stage=self.stage, overlap=self.overlap,
            padded=plan.total_padded if plan is not None else None,
            regathered=regathered)

    def collectives_per_step(self, clip: bool = False) -> dict:
        """The collectives one ``make_step(comms=self)`` step issues, by
        kind: the buckets times each wire's collectives a bucket, the
        parameter gathers, the clip's norm all-reduce and the metrics'
        all-reduce."""
        out = dict.fromkeys(("all_reduce", "reduce_scatter", "all_to_all",
                             "all_gather"), 0)
        out["all_reduce"] += 1              # the loss and metrics
        scatter = {"fp32": ("reduce_scatter", 1), "bf16": ("all_to_all", 1),
                   "int8": ("all_to_all", 2)}
        if self.wire == "implicit":
            out["all_reduce"] += 1
        elif self.stage == 0 and self.wire == "fp32":
            out["all_reduce"] += 1
        else:
            kind, k = scatter[self.wire]
            out[kind] += k * (self.plan().n_buckets if self.stage >= 2
                              else 1)
            if self.stage == 0:              # phase 2 gathers the mean
                out["all_gather"] += 1 if self.wire == "bf16" else 2
        if self.stage >= 1:
            # stage 1: one gather of the flat vector; 2: one a bucket
            # after the update; 3: one a bucket before the loss, and in
            # backward one for each bucket the loss saved a view of
            # (those of the last step)
            out["all_gather"] += self.plan().n_buckets \
                if self.stage >= 2 else 1
            if self.stage >= 3:
                out["all_gather"] += len(getattr(self, "_regathered", ()))
            out["all_reduce"] += int(clip)
        return out


def make_schedule(mesh: Any, stage: int = 0, wire: str = "fp32",
                  overlap: bool = False, bucket_mb: float = 4.0,
                  bucket_size: int = 512) -> CommsSchedule:
    """Validated :class:`CommsSchedule` constructor. Errors name the YAML
    keys."""
    if stage not in STAGES:
        raise ValueError(
            f"comms.stage: {stage!r} — expected one of {STAGES}")
    if wire not in WIRES and wire != "implicit":
        raise ValueError(
            f"comms.wire: {wire!r} — expected one of {WIRES}")
    if wire == "implicit" and stage >= 2:
        raise ValueError(
            f"comms.stage: {stage} needs an explicit wire format (the "
            f"reduce-scatter is explicit); set comms.wire to one of "
            f"{WIRES}")
    if overlap and stage < 2:
        raise ValueError(
            f"comms.overlap: true needs comms.stage: 2 or 3 (got "
            f"comms.stage: {stage}) — stages 0/1 sync once at the "
            f"tail; only the per-bucket backward reduce-scatter "
            f"overlaps")
    if bucket_mb <= 0:
        raise ValueError(
            f"comms.bucket_mb must be positive, got {bucket_mb}")
    # stage 3 has no serialized variant: the gather hooks' backward IS
    # the reduce-scatter
    if stage == 3:
        overlap = True
    make_grad_comms(mesh, mode=wire if wire in MODES else "fp32",
                    zero1=stage >= 1, bucket_size=bucket_size)
    return CommsSchedule(mesh=mesh, mode=wire, zero1=stage >= 1,
                         bucket_size=int(bucket_size), stage=int(stage),
                         overlap=bool(overlap),
                         bucket_mb=float(bucket_mb))


def as_schedule(comms: Any) -> CommsSchedule:
    """Normalize a legacy :class:`GradComms` (or a schedule) to a
    :class:`CommsSchedule` — the ``mode``/``zero1`` → stage mapping."""
    if isinstance(comms, CommsSchedule):
        return comms
    return CommsSchedule(mesh=comms.mesh, mode=comms.mode,
                         zero1=comms.zero1,
                         bucket_size=comms.bucket_size,
                         stage=1 if comms.zero1 else 0, overlap=False)


# =========================================================================
# The stage-2/3 step
# =========================================================================

def sharded_step(sched: CommsSchedule, loss_fn: Callable, tx: Any,
                 clip: float | None, state: Any, batch: Any,
                 has_aux: bool = True, noise: Any = None
                 ) -> tuple[torch.Tensor, dict]:
    """One ZeRO-2/3 train step on ``state``, in place: forward and
    backward on this rank's batch, the per-bucket gradient reduce-scatter
    (from the hooks inside backward when ``overlap``, after it
    otherwise; identical math), global-norm clipping, the update of this
    rank's flat shard, and the parameters gathered back (stage 2) or kept
    as the shard (stage 3). The optimizer's learning rate is the
    caller's to set. Returns the loss and aux averaged over the ranks."""
    from torchbooster_tpu_torch.comms.quantized import (
        NoiseSource,
        mean_metrics,
    )
    from torchbooster_tpu_torch.comms.zero import clip_shard, flat_param

    mesh, axes, n = sched.mesh, sched.axes, sched.n_shards
    group = mesh.group(axes)
    wire, stage, overlap = sched.wire, sched.stage, sched.overlap
    int8 = wire == "int8"
    plan = sched.plan(state.params if stage == 2 else None)
    shard = flat_param(state.optimizer, plan.shard_size)
    idx = mesh.linear_index(axes)
    noise = noise or NoiseSource(shard.device)
    ef_row = state.comms["ef1"].reshape(-1) if int8 else None
    pending: list = [None] * plan.n_buckets

    def launch(b: int, flat: torch.Tensor) -> None:
        from torchbooster_tpu_torch.comms.quantized import start_scatter

        ef = None
        if ef_row is not None:
            off = plan.full_offset(b)
            ef = ef_row[off:off + plan.padded[b]]
        pending[b] = start_scatter(flat, group, n, wire, plan.bucket_size,
                                   noise(state.step, idx, b) if int8
                                   else None, ef)

    def call_loss(params: Any) -> tuple:
        out = loss_fn(params, batch, state.generator)
        return out if has_aux else (out, {})

    if stage >= 3:
        regather = _Regather(plan, state.params, group)
        with regather:
            loss, aux = call_loss(gathered_params(plan, state.params, group,
                                                  launch, regather))
        loss.backward()
        # the buckets gathered again, for the plan's count and traffic
        object.__setattr__(sched, "_regathered", tuple(regather.cached))
        regather.cached = {}
    else:
        leaves = plan.leaves(state.params)
        handles = hook_buckets(plan, leaves, launch) if overlap else []
        try:
            loss, aux = call_loss(state.params)
            loss.backward()
        finally:
            for handle in handles:
                handle.remove()
        for b in range(plan.n_buckets):
            if pending[b] is None:     # overlap off, or an unused bucket
                launch(b, _ravel_grads(plan, b, leaves))
        with torch.no_grad():
            shard.copy_(plan.pack_shard(state.params, idx))
    done = [p.wait() for p in pending]
    g_shard = torch.cat([chunk for chunk, _ in done])
    if int8:
        state.comms = {"ef1": torch.cat([ef for _, ef in done])[None]}
    if clip is not None:
        clip_shard(g_shard, clip, group)
    shard.grad = g_shard
    tx.clip_units({"flat": shard})
    state.optimizer.step()
    shard.grad = None
    if stage == 2:
        plan.gather_into(shard.detach(), group, leaves)
    return mean_metrics(loss.detach(), aux, group, n)
