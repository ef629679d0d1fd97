"""Quantized gradient all-reduce over the data axes — the port of
``torchbooster_tpu/comms/quantized.py``.

The explicit replacement for the implicit fp32 all-reduce, as explicit
``torch.distributed`` collectives over a mesh's data group, so the wire
format is a choice:

1. each rank quantizes its **local** flat gradient (per-bucket absmax
   scales, stochastic rounding) and ``all_to_all``s the chunks as int8
   codes and fp32 scales — the bytes ``accounting.step_traffic`` counts;
   rank *i* ends up holding every rank's chunk *i*;
2. chunks are dequantized and accumulated **in fp32**;
3. the reduced chunk is re-quantized and ``all_gather``ed back — or,
   under ZeRO-1, kept as the reduce-scatter output the sharded update
   consumes.

Quantization error is carried: each rank keeps the residual
``v - deq(quant(v))`` (error feedback) and adds it into the next step's
value, in ``TrainState.comms``.

The rounding noise cannot be the JAX package's bits, so
:func:`quantize` draws it from a ``torch.Generator`` and hands it to
:func:`quantize_with_noise`, the deterministic body: given JAX's
``jax.random.uniform`` draw, it gives JAX's int8 codes and scales. The
generators are re-seeded every step from the step, the rank and the
bucket (:class:`NoiseSource`), so a run resumed from a checkpoint draws
what the uninterrupted run drew."""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from torchbooster_tpu_torch.distributed import (
    all_gather,
    all_reduce,
    all_to_all,
    reduce_scatter,
)

__all__ = ["NoiseSource", "dequantize", "quantize", "quantize_with_noise",
           "reduce_flat", "start_scatter", "value_and_grad_sync"]


def quantize_with_noise(flat: torch.Tensor, bucket_size: int,
                        noise: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with per-bucket absmax scales and
    stochastic rounding ``floor(x/s + u)``, ``u`` given as ``noise``
    (``(size/bucket, bucket)``, uniform in [0, 1)). ``flat`` is fp32 with
    ``size % bucket_size == 0``; returns ``(int8 codes, fp32 scales)``."""
    buckets = flat.reshape(-1, bucket_size)
    scale = buckets.abs().amax(dim=1) / 127.0
    inv = torch.where(scale > 0.0, 1.0 / scale,
                      torch.zeros_like(scale))[:, None]
    q = torch.clamp(torch.floor(buckets * inv + noise), -127.0, 127.0)
    return q.to(torch.int8).reshape(-1), scale


def quantize(flat: torch.Tensor, bucket_size: int,
             generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_with_noise` with the noise drawn from ``generator``
    (on ``flat``'s device)."""
    noise = torch.rand((flat.numel() // bucket_size, bucket_size),
                       generator=generator, device=flat.device)
    return quantize_with_noise(flat, bucket_size, noise)


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               bucket_size: int) -> torch.Tensor:
    return (q.reshape(-1, bucket_size).to(torch.float32)
            * scales[:, None]).reshape(-1)


def seed_of(*parts: int) -> int:
    """A 63-bit seed mixed from integers (host only, no device sync)."""
    state = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


class NoiseSource:
    """Generators for the rounding noise, one per key on ``device``,
    re-seeded on each use from the key and the step: the same
    ``(step, rank, bucket, phase)`` always draws the same noise, whether
    the bucket's reduce-scatter is issued inside backward or after it."""

    def __init__(self, device: torch.device, seed: int = 0):
        self.device, self.seed = device, seed
        self._gens: dict[tuple, torch.Generator] = {}

    def __call__(self, step: int, *key: int) -> torch.Generator:
        gen = self._gens.get(key)
        if gen is None:
            gen = self._gens[key] = torch.Generator(self.device)
        return gen.manual_seed(seed_of(self.seed, step, *key))


class Scatter:
    """A reduce-scatter of one flat vector in flight: :meth:`wait` gives
    ``(this rank's chunk of the mean, the new phase-1 residual or None)``.
    Waiting orders the caller's stream after the collective; it does not
    block the host on the card."""

    def __init__(self, finish: Callable[[], torch.Tensor], works: list,
                 new_ef: torch.Tensor | None, keep: tuple):
        self._finish, self._works, self.new_ef = finish, works, new_ef
        self._keep = keep            # buffers the collectives read

    def wait(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        for work in self._works:
            work.wait()
        return self._finish(), self.new_ef


def start_scatter(flat: torch.Tensor, group: Any, n: int, wire: str,
                  bucket_size: int, generator: torch.Generator | None = None,
                  ef: torch.Tensor | None = None) -> Scatter:
    """Issue the mean-reduce-scatter of ``flat`` (fp32, padded to a
    multiple of ``n * bucket_size``) over ``group`` in ``wire`` format,
    asynchronously: fp32 a ``reduce_scatter``, bf16 an ``all_to_all`` of
    bf16 chunks, int8 two ``all_to_all``s (codes, scales) of the
    error-fed quantized gradient."""
    chunk = flat.numel() // n
    if wire == "fp32":
        out = torch.empty(chunk, dtype=torch.float32, device=flat.device)
        work = reduce_scatter(out, flat, group, async_op=True)
        return Scatter(lambda: out / n, [work], None, (flat,))
    if wire == "bf16":
        sent = flat.to(torch.bfloat16)
        recv = torch.empty_like(sent)
        work = all_to_all(recv, sent, group, async_op=True)
        return Scatter(
            lambda: recv.reshape(n, chunk).to(torch.float32).sum(0) / n,
            [work], None, (sent,))
    if wire != "int8":
        raise ValueError(f"reduce_flat: unknown mode {wire!r}")
    v1 = flat if ef is None else flat + ef
    q1, s1 = quantize(v1, bucket_size, generator)
    new_ef = v1 - dequantize(q1, s1, bucket_size)
    q_recv, s_recv = torch.empty_like(q1), torch.empty_like(s1)
    works = [all_to_all(q_recv, q1, group, async_op=True),
             all_to_all(s_recv, s1, group, async_op=True)]

    def finish() -> torch.Tensor:
        deq = (q_recv.reshape(n, -1, bucket_size).to(torch.float32)
               * s_recv.reshape(n, -1, 1)).reshape(n, chunk)
        return deq.sum(0) / n

    return Scatter(finish, works, new_ef, (q1, s1))


def reduce_flat(flat: torch.Tensor, group: Any, n_shards: int, mode: str,
                bucket_size: int,
                generators: tuple[Any, Any] = (None, None),
                ef1: torch.Tensor | None = None,
                ef2: torch.Tensor | None = None, scatter: bool = False
                ) -> tuple[torch.Tensor, Any, Any]:
    """Mean-reduce a rank's flat gradient (fp32, padded to a multiple of
    ``n_shards * bucket_size``) over ``group``. Returns ``(reduced,
    new_ef1, new_ef2)``: ``reduced`` is the full global mean, or with
    ``scatter`` only this rank's chunk of it (phase 2 and its residual
    are then skipped). ``generators`` draw the int8 rounding noise of
    phases 1 and 2; ``ef2`` is this rank's chunk of the phase-2
    residual."""
    if mode == "fp32" and not scatter:
        out = flat.clone()
        all_reduce(out, group)
        return out / n_shards, ef1, ef2
    red, new_ef1 = start_scatter(flat, group, n_shards, mode, bucket_size,
                                 generators[0], ef1).wait()
    if mode == "fp32":
        return red, ef1, ef2
    if mode == "int8":
        ef1 = new_ef1
    if scatter:
        return red, ef1, ef2
    if mode == "bf16":
        sent = red.to(torch.bfloat16)
        out = torch.empty(flat.numel(), dtype=torch.bfloat16,
                          device=flat.device)
        all_gather(out, sent, group)
        return out.to(torch.float32), ef1, ef2
    # phase 2: re-quantize the reduced chunk, gather the full gradient
    v2 = red if ef2 is None else red + ef2
    q2, s2 = quantize(v2, bucket_size, generators[1])
    new_ef2 = v2 - dequantize(q2, s2, bucket_size)
    q_all = torch.empty(flat.numel(), dtype=torch.int8, device=flat.device)
    s_all = torch.empty(flat.numel() // bucket_size, dtype=torch.float32,
                        device=flat.device)
    all_gather(q_all, q2, group)
    all_gather(s_all, s2, group)
    return dequantize(q_all, s_all, bucket_size), ef1, new_ef2


def ravel(leaves: list[torch.Tensor], padded: int) -> torch.Tensor:
    """The leaves (in tree order) concatenated to one fp32 vector,
    zero-padded to ``padded`` elements."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
    if padded > flat.numel():
        flat = torch.cat([flat, flat.new_zeros(padded - flat.numel())])
    return flat


def value_and_grad_sync(loss_fn: Callable, params: Any, comms_state: dict,
                        batch: Any, generator: Any, comms: Any,
                        has_aux: bool = True, scatter: bool = False,
                        step: int = 0, noise: NoiseSource | None = None
                        ) -> tuple[tuple[torch.Tensor, dict], Any, dict]:
    """The explicit-comms replacement for forward + backward: each rank
    runs the loss on its batch, its gradients stay local, and they sync
    through :func:`reduce_flat` in the configured wire format.

    Returns ``((loss, aux), grads, new_comms_state)``, loss and aux
    averaged over the ranks. ``grads`` is the global-mean flat gradient
    (``(padded,)``, params in tree order), or with ``scatter`` (ZeRO-1)
    this rank's chunk of it. The parameters' ``.grad`` are cleared."""
    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    mesh, n = comms.mesh, comms.n_shards
    group = mesh.group(comms.axes)
    leaves = [leaf for _, leaf in tree_flatten(params)]
    padded = comms.padded_size(sum(p.numel() for p in leaves))
    out = loss_fn(params, batch, generator)
    loss, aux = out if has_aux else (out, {})
    loss.backward()
    flat = ravel([p.grad if p.grad is not None else torch.zeros_like(p)
                  for p in leaves], padded)
    for p in leaves:
        p.grad = None
    idx = mesh.linear_index(comms.axes)
    noise = noise or NoiseSource(flat.device)
    ef1 = comms_state.get("ef1")
    ef2 = comms_state.get("ef2")
    reduced, new_ef1, new_ef2 = reduce_flat(
        flat, group, n, comms.mode, comms.bucket_size,
        (noise(step, idx, 0), noise(step, idx, 1)),
        None if ef1 is None else ef1.reshape(-1), ef2, scatter=scatter)
    new_state = {}
    if new_ef1 is not None and "ef1" in comms_state:
        new_state["ef1"] = new_ef1.reshape(1, -1)
    if new_ef2 is not None and "ef2" in comms_state:
        new_state["ef2"] = new_ef2
    loss, aux = mean_metrics(loss.detach(), aux, group, n)
    return (loss, aux), reduced, new_state


def mean_metrics(loss: torch.Tensor, aux: dict, group: Any, n: int
                 ) -> tuple[torch.Tensor, dict]:
    """Loss and tensor aux metrics averaged over ``group`` in one
    all-reduce (JAX's ``pmean``); without a group they pass through."""
    if group is None:
        return loss, aux
    keys = [k for k, v in aux.items() if isinstance(v, torch.Tensor)]
    stacked = torch.stack([loss.detach().to(torch.float32).reshape(())]
                          + [aux[k].detach().to(torch.float32).reshape(())
                             for k in keys])
    all_reduce(stacked, group)
    stacked = stacked / n
    return stacked[0], {**aux, **{k: stacked[i + 1]
                                  for i, k in enumerate(keys)}}
