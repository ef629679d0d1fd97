"""Explicit gradient communication — the port of
``torchbooster_tpu/comms``: quantized collectives and the ZeRO ladder
over a mesh's data axes.

- :mod:`quantized` — the explicit sync over the data group: ``fp32``
  (the control arm), ``bf16`` (2x fewer bytes) and ``int8`` (about 4x
  fewer: per-bucket scales, stochastic rounding and error-feedback
  residuals carried in ``TrainState.comms``);
- :mod:`zero` — the ZeRO-1 update: the optimizer over this rank's chunk
  of the flat parameter vector, updated chunks all-gathered;
- :mod:`schedule` — ZeRO-2 (gradients reduce-scattered bucket by bucket,
  inside backward with ``overlap``) and ZeRO-3 (parameters sharded at
  rest, gathered in forward), with any wire format, as one
  :class:`~torchbooster_tpu_torch.comms.schedule.CommsSchedule`;
- :mod:`accounting` — the static per-step traffic model.

Front door: a ``comms:`` YAML block
(:class:`~torchbooster_tpu_torch.config.CommsConfig`) builds a
schedule; pass it to ``utils.make_step(comms=...)`` and create states
with its ``create_state``. Explicit modes treat every data axis
(``dp``/``fsdp``) as pure data parallelism: parameters are replicated."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

MODES = ("implicit", "fp32", "bf16", "int8")


@dataclasses.dataclass(frozen=True, eq=False)
class GradComms:
    """The gradient-communication plan for one mesh: the wire format of
    the all-reduce, whether the optimizer update is ZeRO-1 sharded, and
    the quantization bucket size. Built by :func:`make_grad_comms` /
    ``CommsConfig.make``; consumed by ``utils.make_step(comms=...)``."""

    mesh: Any
    mode: str = "implicit"
    zero1: bool = False
    bucket_size: int = 512

    @property
    def axes(self) -> tuple[str, ...]:
        return self.mesh.data_axes()

    @property
    def n_shards(self) -> int:
        return self.mesh.axes_size(self.axes)

    @property
    def active(self) -> bool:
        """True when make_step must build the explicit path at all."""
        return self.mode != "implicit" or self.zero1

    def padded_size(self, n_params: int) -> int:
        from torchbooster_tpu_torch.comms.zero import padded_size

        return padded_size(n_params, self.n_shards, self.bucket_size)

    def init_state(self, params: Any) -> dict:
        """This rank's error-feedback residuals for ``TrainState.comms``:
        int8 carries a full-gradient residual (phase 1, ``(1, padded)``,
        this rank's row) and, unless ZeRO-1, the residual of its reduced
        chunk (phase 2, ``(padded / n,)``). Other modes carry nothing."""
        if self.mode != "int8":
            return {}
        from torchbooster_tpu_torch.utils import tree_leaves

        padded = self.padded_size(sum(t.numel() for t in tree_leaves(params)))
        dev = self.mesh.device
        state = {"ef1": torch.zeros((1, padded), dtype=torch.float32,
                                    device=dev)}
        if not self.zero1:
            state["ef2"] = torch.zeros((padded // self.n_shards,),
                                       dtype=torch.float32, device=dev)
        return state

    def create_state(self, params: Any, tx: Any, generator: Any = 0,
                     accumulate: bool = False, ema: bool = False):
        """The :class:`~torchbooster_tpu_torch.utils.TrainState` this plan
        needs: parameters broadcast from rank 0 (DDP's initial
        broadcast), the optimizer over this rank's flat chunk when ZeRO-1
        is on, and the int8 residuals in ``.comms``."""
        from torchbooster_tpu_torch.distributed import to_env
        from torchbooster_tpu_torch.utils import TrainState

        params = to_env(params, self.mesh)
        state = TrainState.create(params, tx if not self.zero1 else _NoOpt(),
                                  generator=generator, accumulate=accumulate,
                                  ema=ema)
        if self.zero1:
            from torchbooster_tpu_torch.comms import zero

            state.optimizer = zero.init_opt_state(
                tx, params, self.mesh, self.axes, self.bucket_size)
        state.comms = self.init_state(params)
        return state

    def step_traffic(self, n_params: int) -> dict:
        from torchbooster_tpu_torch.comms import accounting

        return accounting.step_traffic(
            n_params, self.n_shards, self.mode, self.zero1,
            self.bucket_size)


class _NoOpt:
    """A stand-in transformation for ``TrainState.create`` when the real
    optimizer is built over the flat chunk."""

    def init(self, params: Any) -> None:
        return None


def make_grad_comms(mesh: Any, mode: str = "implicit", zero1: bool = False,
                    bucket_size: int = 512) -> GradComms:
    """Validated :class:`GradComms` constructor. Explicit modes and ZeRO-1
    need a pure data-parallel mesh: every non-data axis of size 1."""
    from torchbooster_tpu_torch.distributed import DATA_AXES

    if mode not in MODES:
        raise ValueError(f"comms mode {mode!r}: expected one of {MODES}")
    if bucket_size <= 0:
        raise ValueError(f"comms bucket_size must be positive, "
                         f"got {bucket_size}")
    comms = GradComms(mesh=mesh, mode=mode, zero1=bool(zero1),
                      bucket_size=int(bucket_size))
    if comms.active:
        model_axes = [a for a in mesh.axis_names
                      if a not in DATA_AXES and mesh.shape[a] > 1]
        if model_axes:
            raise ValueError(
                f"comms mode={mode!r}/zero1={zero1} needs a pure "
                f"data-parallel mesh (params replicated); mesh has "
                f"model-parallel axes {model_axes} — keep mode: "
                f"implicit for tp/sp/pp/ep layouts")
        if not comms.axes:
            raise ValueError(
                f"mesh {tuple(mesh.axis_names)} has no data axis "
                f"(dp/fsdp); explicit comms has nothing to reduce over")
    return comms


from torchbooster_tpu_torch.comms.accounting import (  # noqa: E402
    disagg_traffic,
    overlap_report,
    promotion_traffic,
    record_step_traffic,
    spill_breakeven,
    step_traffic,
    xla_collective_traffic,
)
from torchbooster_tpu_torch.comms.quantized import (  # noqa: E402
    dequantize,
    quantize,
    quantize_with_noise,
    reduce_flat,
)
from torchbooster_tpu_torch.comms.zero import (  # noqa: E402
    init_opt_state,
    opt_state_specs,
    padded_size,
)
from torchbooster_tpu_torch.comms.schedule import (  # noqa: E402
    STAGES,
    WIRES,
    BucketPlan,
    CommsSchedule,
    as_schedule,
    make_schedule,
)

__all__ = [
    "BucketPlan", "CommsSchedule", "GradComms", "MODES", "STAGES",
    "WIRES", "as_schedule", "dequantize", "disagg_traffic",
    "init_opt_state", "make_grad_comms", "make_schedule",
    "opt_state_specs", "overlap_report", "padded_size",
    "promotion_traffic", "quantize", "quantize_with_noise",
    "record_step_traffic", "reduce_flat", "spill_breakeven",
    "step_traffic", "xla_collective_traffic",
]
