"""Prefill/decode disaggregation — the port of ``torchbooster_tpu/
serving/disagg.py``: two pools joined by one framed page stream.

Long prompts are the decode batch's worst neighbour: every prefill
chunk the scheduler interleaves delays every request mid-generation.
The split runs them on a **prefill engine** (``prefill_only=True``) and
lets the **decode batcher** see only prompts whose KV pages already
exist. What crosses between them is the KV state in the host spill
tier's demotion format (int8 K/V plus fp32 per-(layer, token, head)
scales, ``PagedEngine.export_pages``), framed by the router's codec
(:func:`~torchbooster_tpu_torch.serving.router.rpc.pack_pages` /
:func:`~torchbooster_tpu_torch.serving.router.rpc.frame_blob`) — the
bytes a socket between two hosts would carry. The decode side puts the
pages in its host pool, and its normal admission promotes them through
the fixed-shape promotion write.

- ``submit`` routes by prompt length: at least ``min_prefill_pages``
  FULL prompt pages (``(len - 1) // page_size``, the prefix matcher's
  cap) go to the prefill pool, everything else straight to the decode
  batcher.
- a background **prefill worker** thread drains the long-prompt queue
  one request at a time (``admit_begin`` → ``prefill_step`` until done →
  ``export_pages`` → ``retire``) and frames the pages. It runs torch ops
  off the main thread: it sets the prefill engine's device as its own
  current device, and on a card both engines share that device's
  default stream, so their work serializes.
- ``step`` (the driver's pump) lands finished transfers — unframe,
  ``host_pool.put`` on the decode engine, ``submit`` to the decode
  batcher with the request's ORIGINAL arrival stamp — then runs one
  decode-batcher step.

The int8 round trip is exact for an int8 pool, and the decode side
re-runs the last chunk from the real token ids, so the token stream
equals the same request's through one unified batcher. The first
token the prefill pool sampled is discarded: the decode side owns
sampling from token one.

A worker that dies marks itself dead and ``step`` re-raises its
exception on the pump thread — never a silent hang.
"""
from __future__ import annotations

import threading
from collections import deque

import torch

from torchbooster_tpu_torch.serving.batcher import ContinuousBatcher, Request
from torchbooster_tpu_torch.serving.engine import PagedEngine
from torchbooster_tpu_torch.serving.router.rpc import (
    frame_blob,
    pack_pages,
    unframe_blob,
    unpack_pages,
)

__all__ = ["DisaggPair"]


class DisaggPair:
    """A prefill engine and a decode batcher joined by a framed page
    stream (see module docstring). Pump-compatible with a
    :class:`ContinuousBatcher`: ``start_session`` / ``submit`` /
    ``step`` / ``has_work`` / ``finish_session``."""

    def __init__(self, prefill_engine: PagedEngine,
                 decode_batcher: ContinuousBatcher, *,
                 min_prefill_pages: int = 1):
        if not isinstance(prefill_engine, PagedEngine):
            raise TypeError(
                f"prefill_engine must be a PagedEngine, got "
                f"{type(prefill_engine).__name__}")
        if not isinstance(decode_batcher, ContinuousBatcher):
            raise TypeError(
                f"decode_batcher must be a ContinuousBatcher, got "
                f"{type(decode_batcher).__name__}")
        if decode_batcher.engine.tables.host_pool is None:
            raise ValueError(
                "disaggregation needs the decode engine's host spill "
                "tier (host_spill=True): streamed pages land in its "
                "host pool and enter through the promotion lane")
        if min_prefill_pages < 1:
            raise ValueError(
                f"min_prefill_pages must be >= 1, got "
                f"{min_prefill_pages}")
        if prefill_engine.page_size != decode_batcher.engine.page_size:
            raise ValueError(
                f"page_size mismatch: prefill "
                f"{prefill_engine.page_size} vs decode "
                f"{decode_batcher.engine.page_size} — chain keys "
                f"would never match")
        self.prefill = prefill_engine
        self.decode = decode_batcher
        self.min_prefill_pages = int(min_prefill_pages)
        # one-at-a-time worker pipeline: submit() feeds _q, the worker
        # moves finished transfers to _out, step() lands them
        self._q: deque[tuple[Request, float]] = deque()
        self._out: deque[tuple[Request, float, bytes]] = deque()
        self._inflight = 0  # routed to prefill, not yet handed over
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None
        self._worker_exc: BaseException | None = None
        self._worker_device: int | None = None
        # transfer accounting (worker-thread writes, read after join or
        # between steps — plain ints are fine under the GIL)
        self.prefill_requests = 0
        self.pages_streamed = 0
        self.page_bytes_streamed = 0   # payload frames only (the
        #                                disagg_traffic() unit)
        self.framed_bytes_streamed = 0  # full blobs incl. headers

    # ---- lifecycle -----------------------------------------------
    def start_session(self) -> None:
        self.decode.start_session()
        self._q.clear()
        self._out.clear()
        self._inflight = 0
        self._worker_exc = None
        dev = self.prefill.device
        self._worker_device = None if dev.type != "cuda" else (
            dev.index if dev.index is not None
            else torch.cuda.current_device())
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._run_worker, name="disagg-prefill",
            daemon=True)
        self._worker.start()

    def finish_session(self) -> dict:
        """Stop the worker, close the decode session, and return its
        metrics with a ``disagg`` block merged in. Callers should
        pump :meth:`step` until ``has_work`` clears first — anything
        still queued here is reported, not served."""
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=30.0)
            self._worker = None
        metrics = self.decode.finish_session()
        metrics["disagg"] = {
            "min_prefill_pages": self.min_prefill_pages,
            "prefill_requests": self.prefill_requests,
            "pages_streamed": self.pages_streamed,
            "page_bytes_streamed": self.page_bytes_streamed,
            "framed_bytes_streamed": self.framed_bytes_streamed,
            "stranded": self._inflight,
        }
        return metrics

    # ---- offer ---------------------------------------------------
    def submit(self, req: Request, arrival: float | None = None) -> None:
        """Route one request: long prompts to the prefill pool, short
        ones straight to decode. Raises (caller-side) when the
        request can never fit EITHER pool — same submit-time contract
        as the batcher's."""
        self.decode._check_fits(req)
        full_pages = (req.base_len - 1) // self.prefill.page_size
        if full_pages < self.min_prefill_pages:
            self.decode.submit(req, arrival=arrival)
            return
        if req.base_len + 1 > self.prefill.cfg.seq_len:
            raise ValueError(
                f"prompt ({req.base_len}) exceeds the prefill pool's "
                f"seq_len ({self.prefill.cfg.seq_len})")
        need = self.prefill.tables.pages_for(req.base_len + 1)
        if need > self.prefill.tables.n_pages:
            raise ValueError(
                f"prompt needs {need} pages; the prefill pool has "
                f"{self.prefill.tables.n_pages} total")
        stamp = arrival if arrival is not None \
            else self.decode.session_now()
        with self._lock:
            self._inflight += 1
            self._q.append((req, float(stamp)))

    # ---- pump ----------------------------------------------------
    def step(self) -> list:
        """One driver iteration: land finished page transfers on the
        decode side, then run one decode-batcher step."""
        if self._worker_exc is not None:
            raise RuntimeError(
                "disagg prefill worker died") from self._worker_exc
        while True:
            with self._lock:
                if not self._out:
                    break
                req, stamp, blob = self._out.popleft()
            header, frames = unframe_blob(blob)
            pool = self.decode.engine.tables.host_pool
            for key, payload in unpack_pages(header, frames):
                pool.put(key, payload)
            self.decode.submit(req, arrival=stamp)
            with self._lock:
                self._inflight -= 1
        return self.decode.step()

    @property
    def has_work(self) -> bool:
        with self._lock:
            pending = self._inflight > 0 or bool(self._q) \
                or bool(self._out)
        return pending or self.decode.has_work

    # ---- the prefill worker --------------------------------------
    def _run_worker(self) -> None:
        try:
            if self._worker_device is not None:
                # the current device is per thread
                torch.cuda.set_device(self._worker_device)
            while not self._stop.is_set():
                with self._lock:
                    item = self._q.popleft() if self._q else None
                if item is None:
                    self._stop.wait(0.001)
                    continue
                req, stamp = item
                blob = self._prefill_one(req)
                if blob is None:  # stopped mid-request
                    return
                with self._lock:
                    self._out.append((req, stamp, blob))
        except BaseException as exc:  # surfaced by step()
            self._worker_exc = exc

    def _prefill_one(self, req: Request) -> bytes | None:
        eng = self.prefill
        slot = None
        while slot is None:
            if self._stop.is_set():
                return None
            slot = eng.admit_begin(req.prompt, seed=req.seed)
            if slot is None:
                # pool momentarily full (cached pages from earlier
                # exports); allocation evicts them as decode-side
                # admission would, so just retry
                self._stop.wait(0.001)
        while True:
            done = eng.prefill_step()
            if done is not None and done[0] == slot:
                break  # first token discarded: decode owns sampling
            if done is None and not eng.has_pending:
                raise RuntimeError(
                    f"prefill pipeline lost slot {slot} for "
                    f"{req.request_id}")
        pages = eng.export_pages(slot, req.prompt)
        eng.retire(slot)
        header, frames = pack_pages(pages)
        header["op"] = "page_stream"
        header["request_id"] = req.request_id
        blob = frame_blob(header, frames)
        self.prefill_requests += 1
        self.pages_streamed += len(pages)
        self.page_bytes_streamed += int(header["page_bytes"])
        self.framed_bytes_streamed += len(blob)
        return blob
