"""The replica boundary — the port of ``torchbooster_tpu/serving/router/
replica.py`` over the port's :class:`~torchbooster_tpu_torch.serving.
batcher.ContinuousBatcher`.

A replica is one pumpable serving stack: an in-process batcher stepped
by the fleet's own loop (:class:`InProcessReplica`) or a socket to a
batcher in another process (:class:`~torchbooster_tpu_torch.serving.
router.rpc.RemoteReplica`). The router consumes only the
:class:`Replica` surface:

- **offer/withdraw** — ``submit(req, arrival)`` / ``cancel(req)``;
- **pump** — ``step()``, the iteration's token events;
- **probe** — ``readiness()``, the payload ``GET /healthz?full=1``
  serves, and the load scorer's inputs ``queue_depth`` / ``inflight`` /
  ``est_step_s`` / ``est_chunk_s``, every one a host-side counter;
- **drain** — ``drain_unfinished()`` (the readmission path: generated
  tokens folded into the prompt) and ``drain_queued()`` (the hot-spot
  donor path);
- **lifecycle** — ``start_session`` / ``finish_session``, the ``clock``
  property, ``check_fits``, ``set_tier_observer`` (the prefix
  directory's feed), ``policy`` / ``page_size`` and the debug payloads.

Death is a state, not an exception: the fleet marks a replica dead when
its ``step()`` raises (or ``EngineFleet.kill`` forces it) and never
steps it again. Host-side bookkeeping only — nothing here touches the
device or a wall clock.
"""
from __future__ import annotations

from torchbooster_tpu_torch.serving.batcher import ContinuousBatcher, Request

__all__ = ["InProcessReplica", "Replica"]


class Replica:
    """Abstract replica surface (see module docstring). Subclasses
    implement every method; the base exists so a socket-backed
    replica can slot in without the router changing."""

    replica_id: int = -1
    alive: bool = True

    # ---- lifecycle -----------------------------------------------
    @property
    def policy(self):
        """The replica's scheduler policy (shared table in-process;
        reconstructed from the hello spec over a socket)."""
        raise NotImplementedError

    @property
    def page_size(self) -> int:
        raise NotImplementedError

    @property
    def clock(self):
        raise NotImplementedError

    @clock.setter
    def clock(self, fn) -> None:
        raise NotImplementedError

    def start_session(self) -> None:
        raise NotImplementedError

    def finish_session(self) -> dict:
        raise NotImplementedError

    def check_fits(self, req: Request) -> None:
        """Raise if ``req`` can never be admitted (the fleet's
        submit-time geometry/validation gate)."""
        raise NotImplementedError

    def set_tier_observer(self, fn) -> None:
        """Feed page tier events (register/promote/demote/evict) to
        ``fn(event, key)`` — the fleet prefix directory's input."""
        raise NotImplementedError

    # ---- offer/withdraw ------------------------------------------
    def submit(self, req: Request, arrival: float) -> None:
        raise NotImplementedError

    def cancel(self, req: Request) -> None:
        raise NotImplementedError

    # ---- pump ----------------------------------------------------
    def step(self) -> list:
        raise NotImplementedError

    # ---- probe / score inputs ------------------------------------
    @property
    def queue_depth(self) -> int:
        raise NotImplementedError

    @property
    def inflight(self) -> int:
        raise NotImplementedError

    @property
    def est_step_s(self) -> float:
        raise NotImplementedError

    @property
    def est_chunk_s(self) -> float:
        raise NotImplementedError

    @property
    def has_work(self) -> bool:
        raise NotImplementedError

    @property
    def occupancy(self) -> float:
        raise NotImplementedError

    def readiness(self) -> dict:
        raise NotImplementedError

    # ---- readmission ---------------------------------------------
    def drain_unfinished(self, retire_seated: bool) -> list:
        raise NotImplementedError

    def drain_queued(self, n: int) -> list:
        """Pop up to ``n`` queued (never seated) requests — the
        fleet's hot-spot rebalance donor path."""
        raise NotImplementedError

    # ---- introspection -------------------------------------------
    def debug_snapshot(self, timeline_tail: int = 20) -> dict:
        raise NotImplementedError

    def debug_row(self) -> dict:
        """One ``/debug/engine`` fleet row: queue depth, the flight
        ring tail, engine/pool stats, occupancy."""
        raise NotImplementedError


class InProcessReplica(Replica):
    """A :class:`ContinuousBatcher` behind the replica boundary — the
    fleet's own loop pumps it (one ``step()`` per fleet step, so N
    in-process replicas model N chips stepping in parallel: under the
    replay harness's virtual clock one fleet iteration costs one
    ``step_dt`` regardless of N, exactly as concurrent hardware
    would)."""

    def __init__(self, replica_id: int, batcher: ContinuousBatcher):
        if not isinstance(batcher, ContinuousBatcher):
            raise TypeError(
                f"InProcessReplica wraps a ContinuousBatcher, got "
                f"{type(batcher).__name__}")
        self.replica_id = int(replica_id)
        self.batcher = batcher
        self.alive = True

    # ---- lifecycle -----------------------------------------------
    @property
    def policy(self):
        return self.batcher.policy

    @property
    def page_size(self) -> int:
        return self.batcher.engine.page_size

    @property
    def clock(self):
        return self.batcher.clock

    @clock.setter
    def clock(self, fn) -> None:
        self.batcher.clock = fn

    def start_session(self) -> None:
        self.batcher.start_session()

    def finish_session(self) -> dict:
        return self.batcher.finish_session()

    def check_fits(self, req: Request) -> None:
        self.batcher._check_fits(req)

    def set_tier_observer(self, fn) -> None:
        self.batcher.engine.tables.on_tier_event = fn

    def submit(self, req: Request, arrival: float) -> None:
        self.batcher.submit(req, arrival=arrival)

    def cancel(self, req: Request) -> None:
        self.batcher.cancel(req)

    def step(self) -> list:
        return self.batcher.step()

    @property
    def queue_depth(self) -> int:
        return self.batcher.queue_depth

    @property
    def inflight(self) -> int:
        return self.batcher.inflight

    @property
    def est_step_s(self) -> float:
        return self.batcher.est_step_s

    @property
    def est_chunk_s(self) -> float:
        return self.batcher.est_chunk_s

    @property
    def has_work(self) -> bool:
        return self.batcher.has_work

    @property
    def occupancy(self) -> float:
        return self.batcher.occupancy

    def readiness(self) -> dict:
        out = self.batcher.readiness()
        out["replica"] = self.replica_id
        out["alive"] = self.alive
        return out

    def drain_unfinished(self, retire_seated: bool) -> list:
        return self.batcher.drain_unfinished(
            retire_seated=retire_seated)

    def drain_queued(self, n: int) -> list:
        return self.batcher.drain_queued(n)

    # ---- introspection -------------------------------------------
    def debug_snapshot(self, timeline_tail: int = 20) -> dict:
        return self.batcher.debug_snapshot(
            timeline_tail=timeline_tail)

    def debug_row(self) -> dict:
        flight = self.batcher.flight
        row = {
            "replica": self.replica_id,
            "alive": self.alive,
            "queue_depth": self.batcher.queue_depth if self.alive
            else 0,
            "flight": {
                "n_recorded": flight.n_recorded,
                "capacity": flight.capacity,
                "records": flight.tail(32),
                "anomalies": flight.anomaly_log(),
            },
        }
        if self.alive:
            # a DEAD replica's engine is not to be trusted: no stats
            row["engine"] = self.batcher.engine.debug_stats()
            row["occupancy"] = round(self.batcher.occupancy, 4)
        return row
