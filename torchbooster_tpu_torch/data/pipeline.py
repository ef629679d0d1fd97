"""Host loading pipeline — the port of ``torchbooster_tpu/data/pipeline.py``:
shard → decode → batch → prefetch to the card.

- per-process index sharding (the ``DistributedSampler`` contract: a
  strided shard of equal length on every rank);
- worker *threads* decode concurrently by default (numpy decode releases
  the GIL); ``workers="process"`` runs a spawn ``ProcessPoolExecutor`` for
  transforms that hold the GIL;
- batches are yielded in submission order with ``prefetch + 1`` in flight;
- :func:`prefetch_to_device` overlaps host decode with the step: a
  producer thread copies each batch from pinned memory on a side stream
  and keeps ``size`` batches ready on the card;
- ``drop_last`` defaults True: static shapes.

``batch_size`` is the **global** batch: each process yields
``batch_size // world`` examples a step. Rank and world size come from
``torch.distributed`` when a process group is initialized, else 0 and 1,
which is what the JAX package gives for one process."""
from __future__ import annotations

import collections
import multiprocessing
import queue
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from torchbooster_tpu_torch.dataset import IterableDataset


def _process_topology() -> tuple[int, int]:
    """``(rank, world size)`` of this process: ``torch.distributed``'s when
    a process group is initialized, else ``(0, 1)``."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def default_collate(examples: Sequence[Any]) -> Any:
    """Stack a list of examples into a batch tree (numpy-valued)."""
    first = examples[0]
    if isinstance(first, dict):
        return {k: default_collate([e[k] for e in examples]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):  # namedtuple
        return type(first)(*(default_collate(col) for col in zip(*examples)))
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate(col) for col in zip(*examples))
    return np.stack([np.asarray(e) for e in examples])


class SizedIterable(IterableDataset):
    """Iterable with a declared length and an optional acceptance filter.
    ``size`` is the *pre-filter* count (an upper bound when a filter is
    set); ``None`` means unsized (``len()`` raises)."""

    def __init__(self, iterable: Iterable, size: int | None,
                 acceptance_fn: Callable[[Any], bool] | None = None):
        self.iterable = iterable
        self.size = size
        self.acceptance_fn = acceptance_fn

    def __len__(self) -> int:
        if self.size is None:
            raise TypeError("unsized iterable dataset has no len()")
        return self.size

    def __iter__(self) -> Iterator[Any]:
        for item in self.iterable:
            if self.acceptance_fn is None or self.acceptance_fn(item):
                yield item


class ShardedIterable(IterableDataset):
    """Modulo-shard a stream across processes: yield the items where
    ``(i + shift) % mod == 0`` (``shift`` and ``mod`` default to this
    process's rank and world size)."""

    def __init__(self, base: Iterable, shift: int | None = None,
                 mod: int | None = None):
        rank, world = _process_topology()
        self.base = base
        self.shift = rank if shift is None else shift
        self.mod = world if mod is None else mod

    def __len__(self) -> int:
        # exact count of i in [0, n) with (i + shift) % mod == 0: the
        # first match is (-shift) % mod, then every mod-th item
        n = len(self.base)
        first = (-self.shift) % self.mod
        return max(0, -(-(n - first) // self.mod)) if first < n else 0

    def __iter__(self) -> Iterator[Any]:
        for i, item in enumerate(self.base):
            if (i + self.shift) % self.mod == 0:
                yield item


# worker-process state, set once a process by the pool initializer
# (shipping the dataset with each task would pickle it every batch)
_WORKER: dict = {}


def _worker_init(dataset: Any, collate_fn: Callable) -> None:
    _WORKER["dataset"] = dataset
    _WORKER["collate"] = collate_fn


def _worker_assemble(chunk: list[int]) -> Any:
    dataset, collate = _WORKER["dataset"], _WORKER["collate"]
    fetch_many = getattr(dataset, "__getitems__", None)
    if fetch_many is not None:
        return collate(fetch_many(chunk))
    return collate([dataset[i] for i in chunk])


class DataLoader:
    """Map or stream dataset → batches of host numpy trees.

    One epoch is one pass; shuffling reshuffles every epoch with
    ``seed + epoch``. ``workers``: ``"thread"`` (the default) or
    ``"process"`` (a spawn pool; the dataset and ``collate_fn`` must
    pickle). Process workers keep the copy of the dataset taken when the
    pool first starts, across epochs: mutate the dataset between epochs
    only in thread mode, or call :meth:`close` first."""

    def __init__(
        self,
        dataset: Any,
        batch_size: int = 32,
        shuffle: bool = True,
        distributed: bool = False,
        drop_last: bool = True,
        num_workers: int = 0,
        prefetch: int = 2,
        collate_fn: Callable | None = None,
        seed: int = 0,
        workers: str = "thread",
    ):
        if workers not in ("thread", "process"):
            raise ValueError(f"workers={workers!r}: 'thread' or 'process'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.distributed = distributed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.collate_fn = collate_fn or default_collate
        self.seed = seed
        self.workers = workers
        self.epoch = 0
        self._pool: ProcessPoolExecutor | None = None

        world = _process_topology()[1] if distributed else 1
        if batch_size % world:
            raise ValueError(
                f"global batch_size {batch_size} not divisible by "
                f"process count {world}")
        self.local_batch = batch_size // world
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable and distributed and not isinstance(
                dataset, ShardedIterable):
            self.dataset = ShardedIterable(dataset)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self._iterable:
            if self.drop_last:
                return n // self.local_batch
            return -(-n // self.local_batch)
        world = _process_topology()[1] if self.distributed else 1
        per_process = n // world if self.drop_last else -(-n // world)
        if self.drop_last:
            return per_process // self.local_batch
        return -(-per_process // self.local_batch)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch) \
                .permutation(n)
        else:
            order = np.arange(n)
        if self.distributed:
            rank, world = _process_topology()
            # strided shard of equal length on every rank
            per = n // world if self.drop_last else -(-n // world)
            order = np.resize(order, per * world)[rank::world] \
                if not self.drop_last else order[:per * world][rank::world]
        return order

    def _batches_of_indices(self) -> Iterator[np.ndarray]:
        order = self._epoch_indices()
        limit = (len(order) // self.local_batch) * self.local_batch \
            if self.drop_last else len(order)
        for start in range(0, limit, self.local_batch):
            chunk = order[start:start + self.local_batch]
            if self.drop_last and len(chunk) < self.local_batch:
                return
            yield chunk

    def _process_pool(self) -> ProcessPoolExecutor:
        """Started at first use and reused across epochs. Spawn, not
        fork: a forked copy of a process with a live CUDA context cannot
        use the card and may deadlock on inherited locks."""
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init,
                initargs=(self.dataset, self.collate_fn))
        return self._pool

    def close(self) -> None:
        """Retire the worker processes (thread mode has nothing to
        close)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __del__(self):  # best effort; close() is the explicit path
        try:
            self.close()
        except Exception:  # pragma: no cover - interpreter teardown
            pass

    def _map_iter(self) -> Iterator[Any]:
        fetch = self.dataset.__getitem__
        fetch_many = getattr(self.dataset, "__getitems__", None)
        if fetch_many is not None:
            # batched-fetch protocol: one storage gather a batch
            def assemble(chunk):
                return self.collate_fn(fetch_many([int(i) for i in chunk]))
        else:
            def assemble(chunk):
                return self.collate_fn([fetch(int(i)) for i in chunk])
        if self.num_workers > 0:
            if self.workers == "process":
                pool = self._process_pool()
                submit_one = lambda chunk: pool.submit(  # noqa: E731
                    _worker_assemble, [int(i) for i in chunk])
            else:
                pool = ThreadPoolExecutor(self.num_workers)
                submit_one = lambda chunk: pool.submit(  # noqa: E731
                    assemble, chunk)
            try:
                pending: collections.deque = collections.deque()
                depth = self.prefetch + 1
                for chunk in self._batches_of_indices():
                    pending.append(submit_one(chunk))
                    if len(pending) >= depth:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                if self.workers == "thread":
                    pool.shutdown()
        else:
            for chunk in self._batches_of_indices():
                yield assemble(chunk)

    def _iterable_iter(self) -> Iterator[Any]:
        buffer: list[Any] = []
        for item in self.dataset:
            buffer.append(item)
            if len(buffer) == self.local_batch:
                yield self.collate_fn(buffer)
                buffer = []
        if buffer and not self.drop_last:
            yield self.collate_fn(buffer)

    def __iter__(self) -> Iterator[Any]:
        iterator = self._iterable_iter() if self._iterable else self._map_iter()
        yield from iterator
        self.epoch += 1


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of a batch tree (dicts, namedtuples, tuples
    and lists; anything else is a leaf)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.ascontiguousarray(leaf))


class _Staging:
    """One batch's pinned host buffers, reused for a later batch of the
    same leaf shapes once ``event`` (its copy to the card) has
    completed."""

    def __init__(self) -> None:
        self.buffers: list[torch.Tensor] = []
        self.event: torch.cuda.Event | None = None

    def stage(self, leaves: list[torch.Tensor]) -> list[torch.Tensor]:
        if self.event is not None:
            # the previous copy out of these buffers must have finished
            self.event.synchronize()
        if [(b.shape, b.dtype) for b in self.buffers] != \
                [(x.shape, x.dtype) for x in leaves]:
            self.buffers = [torch.empty(x.shape, dtype=x.dtype,
                                        pin_memory=True) for x in leaves]
        for buf, x in zip(self.buffers, leaves):
            buf.copy_(x)
        return self.buffers


def prefetch_to_device(loader: Iterable, device: str | torch.device = "cuda",
                       size: int = 2) -> Iterator[Any]:
    """Overlap host loading with the step: a background thread keeps
    ``size`` batches ready on ``device`` ahead of the consumer, every leaf
    of each batch tree a tensor there. On a card the producer binds the
    card, copies each batch from reused pinned buffers on a side stream
    and records an event; the consumer's current stream waits on that
    event and every tensor is recorded on it, so the caching allocator
    keeps its memory until the step that reads it is done. With
    ``device="cpu"`` the batches come as CPU tensors, without streams.
    Errors in the producer re-raise in the consumer; a consumer that stops
    early retires the thread."""
    from torchbooster_tpu_torch.observability import get_registry

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"prefetch_to_device({str(device)!r}): no CUDA card; pass "
                f"device='cpu' for host tensors")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()
    error: list[BaseException] = []
    # pipeline telemetry: batches produced, and how long the producer sat
    # blocked on a full queue (about 0 when the card sets the pace; a
    # growing wait means host decode outruns the card and the depth only
    # masks it, while a starved consumer shows in the step time instead)
    reg = get_registry()
    batches_ctr = reg.counter("data_batches_total",
                              "batches placed on device by prefetch")
    wait_hist = reg.histogram("data_producer_wait_seconds",
                              "producer time blocked on a full queue")

    def place(batch: Any, stream, staging: _Staging) -> tuple:
        """``(tree of tensors on device, event of their copy or None)``."""
        if not cuda:
            return _tree_map(_host_tensor, batch), None
        leaves: list[torch.Tensor] = []

        def collect(leaf: Any) -> int:
            leaves.append(_host_tensor(leaf))
            return len(leaves) - 1

        tree = _tree_map(collect, batch)
        pinned = staging.stage(leaves)
        with torch.cuda.stream(stream):
            on_card = [p.to(device, non_blocking=True) for p in pinned]
            staging.event = torch.cuda.Event()
            staging.event.record(stream)
        return _tree_map(lambda i: on_card[i], tree), staging.event

    def producer() -> None:
        try:
            stream = None
            if cuda:
                # the current device is per thread: bind the card first
                torch.cuda.set_device(device)
                stream = torch.cuda.Stream(device)
            # a buffer set is reused only after its copy's event: one set
            # per batch the queue and the consumer can hold, plus one
            ring = [_Staging() for _ in range(size + 2)]
            for n, batch in enumerate(loader):
                placed = place(batch, stream, ring[n % len(ring)])
                t_wait = time.perf_counter()
                while not stop.is_set():
                    try:
                        q.put(placed, timeout=0.1)
                        batches_ctr.inc()
                        wait_hist.observe(time.perf_counter() - t_wait)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as exc:  # re-raised in the consumer
            error.append(exc)
        finally:
            # the sentinel takes the same stop-aware blocking put as the
            # batches: put_nowait on a full queue would drop it and leave
            # the consumer blocked on q.get() for ever
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            tree, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                _tree_map(lambda t: t.record_stream(current), tree)
            yield tree
    finally:
        # the consumer stopped (break, exception, GeneratorExit): unblock
        # and retire the producer, so neither the thread nor its batches
        # outlive this generator
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)


__all__ = ["DataLoader", "ShardedIterable", "SizedIterable",
           "default_collate", "prefetch_to_device"]
