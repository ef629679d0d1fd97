"""CUDA-graph capture of the port's fixed-shape steps: its counterpart of
the JAX package's ``jax.jit`` over the serving steps
(``torchbooster_tpu/serving/engine.py:558-617``), over ``generate``
(``models/gpt.py:1428`` ``jit_generate``) and over the train step
(``utils.py:233`` ``make_step``).

A step here is a function of no arguments that reads only tensors which
keep their shapes and addresses between calls (device buffers refreshed
in place, a pool, the params) and returns its outputs. :func:`capture`
runs it once for real on a side stream (the warm-up: that run IS the
call's step, so its kernel launches happen and count once), then
captures it into a ``torch.cuda.CUDAGraph`` on the calling thread
(``capture_error_mode="thread_local"``, so other threads' CUDA work does
not break the capture), which runs nothing. Each later call replays the
graph (:meth:`CapturedStep.replay`): the same kernels on the same
addresses, with no Python dispatch. A failed capture raises; nothing
falls back to the eager step.

The kernel wrappers (B1-B8) count their launches in Python, which a
replay never runs: under the capture each counts into the capture's own
tally (``ops/launch_tally.py``; the capture stream's, so the backward's
launches from autograd's thread join it and another thread's launches
meanwhile stay theirs), and each replay adds that tally, by counter and
route. A step that draws random numbers from a card generator names it
at the capture: the graph registers it, so that each replay draws at the
generator's offset then and advances it, as the eager step would.

:func:`plan_steps` decides from the device and the configuration alone
whether a step is captured; :func:`eager_steps` is the one way to run a
captured kind of step eagerly on the card, the counterpart of
``jax.disable_jit()``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterable

import torch

from torchbooster_tpu_torch.ops import launch_tally

_EAGER = contextvars.ContextVar("torchbooster_eager_steps", default=False)


@contextlib.contextmanager
def eager_steps():
    """Run the fixed-shape steps eagerly inside the block (in this thread
    or task): no graph is captured or replayed, the counterpart of
    ``jax.disable_jit()``. Graphs captured before stay, and replay again
    after the block."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


def plan_steps(device: str | torch.device, *,
               collectives: bool = False) -> tuple[str, str]:
    """``(route, reason)`` of a fixed-shape step: ``"graph"`` (captured
    once, replayed) or ``"eager"``, from the device and the configuration
    only, never from a failed attempt.

    - The CPU is eager: CUDA graphs exist only on the card.
    - A step with collectives (a ``tp > 1`` engine, a decode on a mesh,
      a train step on a mesh or with a ``comms`` schedule) is eager: its
      all-reduces go over a process group, gloo through the host in the
      port's tp serving (``serving/tp.py``), which a graph cannot hold;
      a train step's NCCL syncs are not captured either (N cards are not
      measured).
    - Everything else on the card is captured. That includes MoE
      models: the serving forward's capacity (``serving_capacity``) and
      its routing are static shapes and device ops (``moe_apply``:
      argmax, ``one_hot`` with a given class count, cumsum, index_add),
      so nothing in the step reads a value back to the host."""
    if torch.device(device).type != "cuda":
        return "eager", "the CPU has no CUDA graphs"
    if collectives:
        return "eager", ("the step's collectives go over a process group "
                         "(gloo through the host in the port's tp "
                         "serving; a mesh train step's syncs), which "
                         "the port runs eagerly")
    return "graph", ("one card, fixed operand shapes and addresses, no "
                     "host read inside the step: captured once, replayed")


def captured(route: str) -> bool:
    """Whether a step planned ``route`` runs through its graph now (not
    inside :func:`eager_steps`)."""
    return route == "graph" and not _EAGER.get()


class CapturedStep:
    """One captured step: its graph, its static outputs (rewritten by each
    replay: read them before the next), the addresses of the operands it
    baked in, and the tally of kernel launches each replay runs
    (``launch_tally``)."""

    def __init__(self, graph, outputs, operands: list, held: dict):
        self.graph = graph
        self.outputs = outputs
        self.held = held
        self._operands = operands
        self._ptrs = [t.data_ptr() for t in operands]
        self.replays = 0

    def moved(self, operands: list | None = None) -> bool:
        """Whether the operands lie elsewhere than at the capture: the
        capture's own tensors, or ``operands``, the tensors the step would
        read now in their place."""
        now = self._operands if operands is None else operands
        return [t.data_ptr() for t in now] != self._ptrs

    def replay(self):
        """Run the graph on the current stream; returns its outputs."""
        if self.moved():
            raise RuntimeError(
                "an operand of a captured step moved since its capture: "
                "the graph would read freed memory (update pools, "
                "buffers and params in place)")
        self.graph.replay()
        launch_tally.count_replay(self.held)
        self.replays += 1
        return self.outputs


def capture(fn: Callable, operands, generators: Iterable = (),
            pool=None) -> tuple[CapturedStep, object]:
    """Warm ``fn`` up on a side stream (this call's step: its result is
    returned), then capture a second call of it into a CUDA graph on the
    calling thread. ``operands`` are the tensors ``fn`` reads whose
    addresses the graph bakes in (or a function that lists them after
    the warm-up, for state the warm-up makes, such as an optimizer's);
    :meth:`CapturedStep.replay` refuses to run once one has moved.
    ``generators``: the card generators ``fn`` draws from, registered
    with the graph. ``pool``: another graph's memory pool to share (its
    graphs never run at once with this one). Returns ``(step, warm-up
    outputs)``."""
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    # on the warm-up's own stream: two threads capturing at once
    # (replica servers of one process) never share a capture stream
    with launch_tally.capture_tally(side) as held, torch.cuda.graph(
            graph, pool=pool, stream=side,
            capture_error_mode="thread_local"):
        outputs = fn()
    listed = operands() if callable(operands) else operands
    return CapturedStep(graph, outputs, list(listed), held), out


__all__ = ["CapturedStep", "capture", "captured", "eager_steps",
           "plan_steps"]
