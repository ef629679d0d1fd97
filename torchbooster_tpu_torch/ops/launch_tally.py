"""The kernel wrappers' launch counters under CUDA-graph capture.

Every wrapper that launches a hand-written kernel (B1-B3 in
``flash_attention.py``, B4 in ``paged_attention.py``, B5/B6 in
``group_norm.py``, B7/B8 in ``fused_block.py``) counts its launches in
module-level Python counters: a plain int (``launches_fwd``) or a dict by
route or mask (``launches_fwd_by_route["sm90"]``). A replay of a CUDA
graph runs no Python, so a counter bumped only where the wrapper runs
would miss every replay. :func:`count` is the one place a wrapper counts:

- outside a capture it adds one at each named site, at once;
- on a stream under capture with a tally open (:func:`capture_tally`)
  it adds nothing to the counters and records the sites in that tally
  instead. The tally is the capture stream's, not the thread's: a
  captured backward launches from autograd's device thread, on the
  forward's stream. Another thread's launches on other streams
  meanwhile stay theirs; a capture with no tally open, as a timing
  harness's, counts nothing;
- :func:`count_replay` adds a tally once for each replay of its graph.

A site is ``(name, key)``: ``key`` None for an int counter, else the key
of a dict counter. ``replayed`` sites count on replays only (B4's
``launches_replayed``). A tally maps ``(module name, name, key)`` to the
launches one run of the graph makes there.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from collections import Counter

import torch

_lock = threading.Lock()
_tallies: dict = {}     # a capture stream's handle -> its open tally


@contextlib.contextmanager
def capture_tally(stream):
    """Inside the block, launches on ``stream`` (a ``torch.cuda.Stream``
    being captured) go to the tally it yields, not to the counters."""
    key = stream.cuda_stream
    outer = _tallies.get(key)
    _tallies[key] = held = Counter()
    try:
        yield held
    finally:
        if outer is None:
            del _tallies[key]
        else:
            _tallies[key] = outer


def _add(module: str, name: str, key, n: int) -> None:
    mod = sys.modules[module]
    if key is None:
        setattr(mod, name, getattr(mod, name) + n)
    else:
        getattr(mod, name)[key] += n


def count(module: str, *sites: tuple, replayed: tuple = ()) -> None:
    """One launch by ``module`` (its ``__name__``) on the current stream,
    at each of ``sites``; see the module docstring."""
    if torch.cuda.is_current_stream_capturing():
        held = _tallies.get(torch.cuda.current_stream().cuda_stream)
        if held is not None:
            for name, key in (*sites, *replayed):
                held[(module, name, key)] += 1
        return
    with _lock:
        for name, key in sites:
            _add(module, name, key, 1)


def count_replay(held: Counter) -> None:
    """One replay of a graph whose capture held ``held``."""
    with _lock:
        for (module, name, key), n in held.items():
            _add(module, name, key, n)


def by_key(held: Counter, module: str, name: str) -> dict:
    """The part of a tally at one dict counter, by key (e.g. B4's
    launches by route a replay runs)."""
    return {key: n for (mod, nm, key), n in held.items()
            if mod == module and nm == name}


__all__ = ["by_key", "capture_tally", "count", "count_replay"]
