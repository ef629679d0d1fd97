"""Port parity: the engine fleet's router (``torchbooster_tpu_torch/
serving/router``: ``audit``, ``directory``, ``routing``, ``health``,
``replica``, ``fleet`` and the ``router:`` block) against the JAX
package on the CPU (vocab 97, 2 layers, d_model 32, 4 heads over 2,
pages of 4, 24 pages, 2 slots, decisive tied head, fp32, greedy).

- ``audit``, ``directory``, ``routing`` and ``health`` give JAX's keys,
  choices, records and state walks on the same inputs: the audit ring,
  the pid-3 Chrome track, ``diff_routing``'s lines and refusals, the
  directory's lookups and death purge, ``prefix_affinity_key`` with and
  without an adapter, the spill verdicts, and the health scorer's
  validation, hysteresis, dead replica, strike kinds and sub-cadence;
- one fingerprinted tenant workload replayed through a two-replica JAX
  fleet and a two-replica port fleet gives the same ``assignment_log``,
  the same token streams and the same audit records under
  ``round_robin`` and under ``affinity`` (the slice's end-to-end parity);
  two port replays are identical and equal a one-replica replay;
- the fleet's properties: replica death readmits without loss or
  duplication; the fleet raises only when the last replica dies; a
  sustained hot-spot rebalances; a cancel between submit and the first
  step cancels in the admission buffer; validation is loud; death
  purges the prefix directory and rescues host-tier chains onto the
  survivor; the observing signal plane leaves routing byte-identical;
- the front door over a fleet: completions, ``/healthz`` (bare and
  ``?full=1``), ``/debug/engine``, ``/debug/requests`` and
  ``/debug/router`` (404 on a single batcher); the fleet crash dump;
  ``write_chrome``'s router track;
- ``_merge_metrics`` equals JAX's on the same per-replica dicts, a dead
  replica's ``{}`` among them, and the readiness and merged-metrics
  schemas survive a dead replica;
- the ``router:`` block builds a fleet (one policy, one tracer), its
  ``health:`` and ``audit`` knobs, and refuses what JAX refuses.
"""
import asyncio
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_frontend import _get, _unary
from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.observability.registry import Registry as JRegistry
from torchbooster_tpu.serving import ContinuousBatcher as JaxBatcher
from torchbooster_tpu.serving import PagedEngine as JaxEngine
from torchbooster_tpu.serving import router as jrouter
from torchbooster_tpu.serving.loadgen import Workload as JWorkload
from torchbooster_tpu.serving.loadgen import (
    WorkloadRequest as JWorkloadRequest)
from torchbooster_tpu.serving.loadgen import (
    replay_inprocess as jax_replay_inprocess)
from torchbooster_tpu_torch.interop import params_from_jax
from torchbooster_tpu_torch.models.gpt import GPTConfig
from torchbooster_tpu_torch.observability.export import prometheus_text
from torchbooster_tpu_torch.observability.registry import Registry
from torchbooster_tpu_torch.observability.tracing import RequestTracer
from torchbooster_tpu_torch.serving import (
    ContinuousBatcher,
    PagedEngine,
    Request,
)
from torchbooster_tpu_torch.serving import router
from torchbooster_tpu_torch.serving.loadgen import (
    ReplayClock,
    Workload,
    WorkloadRequest,
    replay_inprocess,
)
from torchbooster_tpu_torch.serving.router import EngineFleet

_KW = dict(vocab=97, n_layers=2, d_model=32, n_heads=4, seq_len=64,
           n_kv_heads=2)
_ENGINE = dict(page_size=4, n_pages=24, max_slots=2)
_CACHE: dict = {}


def _model():
    if "model" not in _CACHE:
        jcfg = JCfg(**_KW)
        jp = JGPT.init(jax.random.PRNGKey(0), jcfg)
        jp = {**jp, "wte": {"table": jp["wte"]["table"] * 4.0}}
        cfg = GPTConfig(**_KW)
        _CACHE["model"] = (jp, jcfg, params_from_jax(jax.device_get(jp),
                                                     cfg, "cpu"), cfg)
    return _CACHE["model"]


def _batcher(policy=None, tracer=None, **kw):
    _, _, tp, cfg = _model()
    return ContinuousBatcher(PagedEngine(
        tp, cfg, compute_dtype=torch.float32, device="cpu",
        **{**_ENGINE, **kw}), policy=policy, tracer=tracer)


def _jax_batcher(policy=None, **kw):
    jp, jcfg, _, _ = _model()
    return JaxBatcher(JaxEngine(jp, jcfg, compute_dtype=jnp.float32,
                                **{**_ENGINE, **kw}), policy=policy)


def _fleet(n=2, routing="round_robin", **kw):
    return EngineFleet([_batcher() for _ in range(n)], routing=routing,
                       **kw)


def _tenant_workload(n=10, tenants=2, seed=0, page=4, rate=100.0,
                     jax_side=False):
    """A shared-system-prompt trace (``tests/test_router.py``'s): each
    prompt is its tenant's fixed 2-page prefix + a private tail, tenants
    drawn at random (seeded)."""
    W, R = (JWorkload, JWorkloadRequest) if jax_side \
        else (Workload, WorkloadRequest)
    rs = np.random.RandomState(seed)
    arrivals = np.cumsum(rs.exponential(1.0 / rate, n))
    prefixes = [rs.randint(0, 97, 2 * page).astype(np.int32)
                for _ in range(tenants)]
    reqs = []
    for i in range(n):
        t = int(rs.randint(tenants))
        tail = rs.randint(0, 97, rs.randint(2, 5)).astype(np.int32)
        reqs.append(R(arrival_s=float(arrivals[i]),
                      max_new_tokens=int(rs.randint(3, 6)),
                      prompt=np.concatenate([prefixes[t], tail]),
                      request_id=f"t{t}-{i:03d}"))
    return W(requests=reqs, vocab=97)


def _body(raw: bytes) -> dict:
    return json.loads(raw.split(b"\r\n\r\n")[-1] or raw)


# =====================================================================
# audit, routing, directory: the same inputs, JAX's outputs
# =====================================================================

def _decision(i, replica=0, reason="round_robin"):
    return {"seq": i, "request_id": f"r{i}", "arrival": i * 0.25,
            "replica": replica, "reason": reason, "key": None,
            "candidates": []}


def _artifact(assignments, fingerprint="fp", policy="round_robin",
              n_replicas=2):
    return {"version": 1, "kind": "routing",
            "workload_fingerprint": fingerprint, "policy": policy,
            "n_replicas": n_replicas, "n_routed": len(assignments),
            "assignments": [list(a) for a in assignments],
            "reasons": []}


def test_audit_ring_and_chrome_track_equal_jax():
    for mod in (router, jrouter):
        with pytest.raises(ValueError, match="capacity"):
            mod.RoutingAudit(0)
    rings = [mod.RoutingAudit(capacity=4) for mod in (router, jrouter)]
    for ring in rings:
        for i in range(10):
            ring.record(_decision(i, replica=i % 2))
    port, ref = rings
    assert len(port) == len(ref) == 4
    assert port.n_records == ref.n_records == 10
    assert port.tail() == ref.tail() and port.tail(2) == ref.tail(2)
    assert [r["seq"] for r in port.tail()] == [6, 7, 8, 9]
    recs = [_decision(0, replica=1), _decision(1, replica=0)]
    assert router.chrome_router_events([]) == []
    events = router.chrome_router_events(recs)
    assert events == jrouter.chrome_router_events(recs)
    assert all(e["pid"] == 3 for e in events)
    assert [e["tid"] for e in events if e["ph"] == "i"] == [1, 0]
    port.reset()
    assert len(port) == 0 and port.n_records == 0


def test_diff_routing_lines_and_refusals_equal_jax():
    base = _artifact([("a", 0), ("b", 1), ("c", 0)])
    many = [(f"r{i}", 0) for i in range(30)]
    flipped = [(f"r{i}", 1) for i in range(30)]
    cases = [
        (base, _artifact([("a", 0), ("b", 1), ("c", 0)]), {}),
        (base, _artifact([("a", 0), ("b", 0), ("c", 0)]), {}),
        (base, _artifact([("a", 0)], policy="affinity", n_replicas=3), {}),
        (_artifact(many), _artifact(flipped), {"max_lines": 5}),
    ]
    got = [router.diff_routing(a, b, **kw) for a, b, kw in cases]
    assert got == [jrouter.diff_routing(a, b, **kw) for a, b, kw in cases]
    assert got[0] == []
    assert got[1] == ["decision 1: b -> replica 1 became b -> replica 0"]
    assert len(got[3]) == 6 and got[3][-1] == "... and 25 more divergences"
    for mod in (router, jrouter):
        with pytest.raises(ValueError, match="not a routing artifact"):
            mod.diff_routing({"kind": "tokens"}, base)
        with pytest.raises(ValueError, match="fingerprints differ"):
            mod.diff_routing(base, _artifact([("a", 0)],
                                             fingerprint="other"))


def test_prefix_affinity_key_equals_jax_with_and_without_adapters():
    rs = np.random.RandomState(0)
    for _ in range(40):
        prompt = rs.randint(0, 97, rs.randint(1, 20)).astype(np.int32)
        page, pages = int(rs.randint(1, 6)), int(rs.randint(0, 4))
        for adapter in ("", "fr", "de"):
            assert router.prefix_affinity_key(prompt, page, pages,
                                              adapter=adapter) \
                == jrouter.prefix_affinity_key(prompt, page, pages,
                                               adapter=adapter)
    prompt = rs.randint(0, 97, 11).astype(np.int32)
    base = router.prefix_affinity_key(prompt, 4, 2)
    assert base == zlib.crc32(prompt[:8].tobytes()) & 0xFFFFFFFF
    ka = router.prefix_affinity_key(prompt, 4, 2, adapter="fr")
    kb = router.prefix_affinity_key(prompt, 4, 2, adapter="de")
    assert len({base, ka, kb}) == 3
    assert router.prefix_affinity_key(prompt[:3], 4, 2) is None
    assert router.prefix_affinity_key(prompt[:3], 4, 2, adapter="fr") \
        == router.prefix_affinity_key(prompt[:2], 4, 2, adapter="fr")


class _Stub:
    def __init__(self, replica_id, depth):
        self.replica_id = replica_id
        self.queue_depth = depth
        self.inflight = 0
        self.est_step_s = 0.01
        self.est_chunk_s = 0.01
        self.alive = True


def test_affinity_spill_and_least_loaded_verdicts_equal_jax():
    class _Fleet:
        page_size = 4

    class _Req:
        prompt = np.arange(1, 9, dtype=np.int32)   # 2 full pages

    walks = []
    for mod in (router, jrouter):
        routing = mod.AffinityRouting(affinity_pages=2, spill_queue=2)
        a, b = _Stub(0, 0), _Stub(1, 0)
        walk = []
        for depth in (0, 5, 1):
            a.queue_depth = depth
            walk.append((routing.choose(_Req, [a, b], _Fleet),
                         routing.last_reason, routing.last_key,
                         routing.last_spill, routing.last_affinity_hit))
        rr = mod.RoundRobinRouting()
        walk.append([rr.choose(_Req, [a, b], _Fleet) for _ in range(3)])
        walks.append(walk)
        with pytest.raises(ValueError, match="affinity_pages"):
            mod.AffinityRouting(affinity_pages=0)
        with pytest.raises(ValueError, match="spill_queue"):
            mod.AffinityRouting(spill_queue=0)
        with pytest.raises(ValueError, match="round_robin.*affinity"):
            mod.make_routing("sticky")
    assert walks[0] == walks[1]
    assert [w[1] for w in walks[0][:3]] == ["bind", "spill", "affinity"]
    assert walks[0][3] == [0, 1, 0]


def test_directory_walk_and_death_purge_equal_jax():
    """One event history through both directories: the same lookups,
    entries, counters and purge result."""
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 97, 10).astype(np.int32) for _ in range(4)]
    keys = [p[:d * 4].tobytes() for p in prompts for d in (1, 2, 3)]
    events = [("register", 0), ("register", 1), ("demote", 0),
              ("promote", 1), ("evict", 0), ("host_evict", 1),
              ("demote", 1), ("register", 0)]
    out = []
    for mod in (router, jrouter):
        for bad in ({"page_size": 0}, {"page_size": 4, "max_pages": 0}):
            with pytest.raises(ValueError):
                mod.PrefixDirectory(**bad)
        d = mod.PrefixDirectory(4, max_pages=2)
        obs = [d.observer(0), d.observer(1)]
        walk = []
        for i, key in enumerate(keys * 2):
            ev, rid = events[(i * 5) % len(events)]
            obs[rid](ev, key)
            walk.append(tuple(d.lookup(p) or () for p in prompts))
        walk.append(tuple(d.lookup(p, live_ids={1}) or ()
                          for p in prompts))
        d.check()
        walk.append((sorted(d.entries_for(0)), sorted(d.entries_for(1)),
                     len(d), d.n_records, d.n_hits, d.n_evictions))
        walk.append(d.purge_replica(0))
        walk.append((len(d), d.n_evictions, d.entries_for(0)))
        d.check()
        with pytest.raises(ValueError, match="tier"):
            d.record(keys[0], 0, "disk")
        out.append(walk)
    assert out[0] == out[1]


# =====================================================================
# health: the same fake replicas, JAX's state walks
# =====================================================================

class _FakeFlight:
    def __init__(self):
        self.anomalies = []

    def anomaly_log(self):
        return list(self.anomalies)


class _FakeRep:
    def __init__(self, rid=0):
        self.replica_id = rid
        self.alive = True
        self.has_work = False
        self.batcher = type("B", (), {})()
        self.batcher.flight = _FakeFlight()
        self.ready = {"queue_depth": 0, "pages_free": 8,
                      "pages_cached": 0, "step_seq": 0,
                      "stamped_s": 0.0}

    def readiness(self):
        return dict(self.ready)


class _FakeFleet:
    def __init__(self, *reps):
        self.replicas = list(reps)


def _healths(**kw):
    kw = {"every": 1, "degrade_after": 2, "recover_after": 2,
          "queue_limit": 4, **kw}
    return (router.FleetHealth(registry=Registry(enabled=True), **kw),
            jrouter.FleetHealth(registry=JRegistry(enabled=True), **kw))


def test_health_validation_is_loud_like_jax():
    for bad, match in (({"every": 0}, "every"),
                       ({"degrade_after": 0}, "degrade_after"),
                       ({"queue_limit": 0}, "queue_limit"),
                       ({"degraded_weight": 8.0, "unhealthy_weight": 2.0},
                        "degraded_weight")):
        for mod in (router, jrouter):
            with pytest.raises(ValueError, match=match):
                mod.FleetHealth(registry=None, **bad)


def _walk(h, script) -> list:
    """Run ``script`` (a list of callables on the fake replica, each
    followed by one observation) and record the scorer's view."""
    rep = _FakeRep()
    fleet = _FakeFleet(rep)
    walk = []
    for step in script:
        step(rep)
        h.observe(fleet)
        walk.append((h.state_name(0), h.weight(0), h.snapshot()))
    return walk


def test_health_hysteresis_dead_replica_and_strikes_walk_like_jax():
    def queue(n):
        return lambda rep: rep.ready.update(queue_depth=n)

    hysteresis = [queue(10)] * 4 + [queue(0)] * 4
    walks = [_walk(h, hysteresis) for h in _healths()]
    assert walks[0] == walks[1]
    assert [w[0] for w in walks[0]] == [
        "healthy", "degraded", "degraded", "unhealthy", "unhealthy",
        "degraded", "degraded", "healthy"]

    def anomaly(what, seq):
        return lambda rep: rep.batcher.flight.anomalies.append(
            {"what": what, "seq": seq})

    def set_ready(**kw):
        return lambda rep: rep.ready.update(**kw)

    def clear(rep):
        rep.batcher.flight.anomalies = []

    def work(rep):
        rep.has_work = True
        rep.ready.update(pages_free=8, pages_cached=0, step_seq=7,
                         stamped_s=10.0)

    def dead(rep):
        rep.alive = False

    strikes = [anomaly("stall", 0), lambda rep: None,
               anomaly("recompile", 1), clear,
               set_ready(pages_free=1, pages_cached=1), work,
               set_ready(stamped_s=11.5),
               set_ready(step_seq=8, stamped_s=12.0),
               set_ready(age_s=0.5), set_ready(age_s=5.0), dead]
    walks = [_walk(h, strikes) for h in _healths(min_free_pages=2,
                                                 stale_s=1.0)]
    assert walks[0] == walks[1]
    seen = [w[2]["last_strikes"].get(0) for w in walks[0]]
    assert seen[:8] == [["stall"], None, ["recompile"], None, ["pages"],
                        None, ["stale"], None]
    assert seen[-2:] == [["stale"], ["dead"]]
    assert walks[0][-1][0] == "unhealthy"


def test_health_subcadence_and_metrics_equal_jax():
    reg, jreg = Registry(enabled=True), JRegistry(enabled=True)
    hs = (router.FleetHealth(registry=reg, every=3, degrade_after=1),
          jrouter.FleetHealth(registry=jreg, every=3, degrade_after=1))
    for h in hs:
        rep = _FakeRep()
        rep.ready["queue_depth"] = 40
        fleet = _FakeFleet(rep)
        h.observe(fleet)
        h.observe(fleet)
        assert h.n_observations == 0
        h.observe(fleet)
        assert h.n_observations == 1 and h.state_name(0) == "degraded"
    for r in (reg, jreg):
        assert r.gauge("router_replica_health", "t").value(
            replica="0") == 1
        assert r.counter("router_health_transitions_total", "t").value(
            replica="0", to="degraded") == 1
    assert hs[0].snapshot() == hs[1].snapshot()
    hs[0].reset()
    assert hs[0].n_flaps == 0 and hs[0].snapshot()["states"] == {}


# =====================================================================
# the fleet: JAX parity end to end, then the fleet's own properties
# =====================================================================

@pytest.mark.parametrize("routing", ["round_robin", "affinity"])
def test_fleet_replay_equals_jax_and_is_deterministic(routing):
    """One workload through a two-replica JAX fleet and a two-replica
    port fleet: the same assignment_log, token streams and audit
    records. Two port replays are identical and equal a one-replica
    replay (routing is placement, never content)."""
    wl = _tenant_workload(n=12)
    jwl = _tenant_workload(n=12, jax_side=True)
    assert wl.fingerprint() == jwl.fingerprint()
    jfleet = jrouter.EngineFleet([_jax_batcher() for _ in range(2)],
                                 routing=routing)
    jres = jax_replay_inprocess(jfleet, jwl, speed=1.0)
    runs = []
    for _ in range(2):
        fleet = _fleet(routing=routing)
        res = replay_inprocess(fleet, wl, speed=1.0)
        runs.append((list(fleet.assignment_log), res.streams,
                     fleet.audit.tail()))
    assert runs[0] == runs[1]
    log, streams, audit = runs[0]
    assert log == list(jfleet.assignment_log)
    assert streams == {r.request_id: list(r.tokens) for r in jres.requests}
    assert audit == jfleet.audit.tail()
    assert {rid for rid, _ in log} == {r.request_id for r in wl}
    assert {rep for _, rep in log} == {0, 1}
    single = replay_inprocess(_fleet(n=1), wl, speed=1.0)
    assert single.streams == streams
    if routing == "affinity":
        homes: dict = {}
        for rid, rep in log:
            homes.setdefault(rid.split("-")[0], set()).add(rep)
        assert all(len(v) == 1 for v in homes.values()), homes
        assert res.metrics["router"]["n_affinity_hits"] > 0


def test_replica_death_readmits_without_loss_or_duplication():
    def run(kill_at_step):
        fleet = _fleet(n=2)
        clock = ReplayClock()
        fleet.clock = clock
        fleet.start_session()
        rs = np.random.RandomState(3)
        reqs = [Request(prompt=rs.randint(0, 97, 6).astype(np.int32),
                        max_new_tokens=8, request_id=f"r{i}")
                for i in range(6)]
        for r in reqs:
            fleet.submit(r, arrival=0.0)
        steps = killed = 0
        while fleet.has_work and steps < 3000:
            fleet.step()
            clock.advance(0.005)
            steps += 1
            if steps == kill_at_step:
                killed = fleet.kill(0)
                assert killed > 0, "the kill must orphan in-flight work"
        return fleet, reqs, fleet.finish_session(), killed

    _, control, _, _ = run(kill_at_step=-1)
    fleet, reqs, metrics, killed = run(kill_at_step=4)
    assert fleet.n_live == 1 and fleet.kill(0) == 0
    by_id = {r.request_id: r for r in reqs}
    for c in control:
        r = by_id[c.request_id]
        assert r.finished_at is not None and not r.cancelled
        assert r.tokens == c.tokens, f"{r.request_id}: death changed it"
    assert metrics["router"]["n_readmitted"] == killed
    assert metrics["n_requests"] == len(reqs)
    txt = prometheus_text()
    assert "router_replicas_live" in txt
    assert "router_readmissions_total" in txt


def test_fleet_raises_only_when_last_replica_dies():
    fleet = _fleet(n=2)
    fleet.start_session()
    rs = np.random.RandomState(0)
    for i in range(2):
        fleet.submit(Request(prompt=rs.randint(0, 97, 5).astype(np.int32),
                             max_new_tokens=2), arrival=0.0)
    boom = lambda: (_ for _ in ()).throw(RuntimeError("card fell over"))
    fleet.replicas[0].batcher.step = boom
    fleet.step()                     # survivable: replica 0 is buried
    assert fleet.n_live == 1 and isinstance(fleet.last_error, RuntimeError)
    fleet.replicas[1].batcher.step = boom
    with pytest.raises(RuntimeError, match="card fell over"):
        fleet.step()
    assert fleet.n_live == 0


def test_hot_spot_rebalance_migrates_queued_requests():
    wl = _tenant_workload(n=12, tenants=1, rate=1000.0)
    fleet = _fleet(n=2, routing="affinity", rebalance_queue=2,
                   rebalance_after=2)
    res = replay_inprocess(fleet, wl, speed=1.0)
    assert fleet.n_rebalanced > 0
    assert all(r.finished_at is not None for r in res.requests)
    assert all(m.get("new_tokens", 0) > 0 for m in res.metrics["replicas"])


def test_fleet_cancel_between_submit_and_first_step():
    fleet = _fleet(n=2)
    fleet.clock = ReplayClock()
    fleet.start_session()
    req = Request(prompt=np.arange(1, 6, dtype=np.int32),
                  max_new_tokens=4, request_id="cxl")
    fleet.submit(req, arrival=0.0)
    fleet.cancel(req)
    events = fleet.step()
    assert req.cancelled and req.finish_reason == "cancelled"
    assert "cxl" not in {rid for rid, _ in fleet.assignment_log}
    assert any(r is req for r, _ in events)
    assert fleet.finish_session()["n_cancelled"] == 1


def test_fleet_validation_loud():
    with pytest.raises(ValueError, match="at least one replica"):
        EngineFleet([])
    with pytest.raises(TypeError, match="Replica"):
        EngineFleet([object()])
    with pytest.raises(ValueError, match="rebalance_queue"):
        EngineFleet([_batcher()], rebalance_queue=-1)
    with pytest.raises(ValueError, match="audit"):
        EngineFleet([_batcher()], audit=-1)
    with pytest.raises(ValueError, match="health_aware"):
        EngineFleet([_batcher()], health_aware=True)
    with pytest.raises(TypeError, match="routing"):
        EngineFleet([_batcher()], routing=3)
    bare = EngineFleet([_batcher()], audit=0)
    assert bare.audit is None and bare.debug_router()["decisions"] == []
    assert bare.router_stats()["audit"] is None
    fleet = _fleet(n=2)
    with pytest.raises(RuntimeError, match="start_session"):
        fleet.submit(Request(prompt=np.arange(1, 5), max_new_tokens=2))
    fleet.start_session()
    with pytest.raises(ValueError, match="seq_len"):
        fleet.submit(Request(prompt=np.arange(1, 60), max_new_tokens=60))
    fleet.finish_session()


def test_replica_death_purges_directory_and_rescues_host_pages():
    """The tenant's pages are host-tier on its home replica when that
    replica dies: the directory purges its entries (counted), the host
    chains move onto the survivor's host pool (numpy, no device read),
    and the re-arrival routes to the survivor and promotes there."""
    fleet = EngineFleet([_batcher(
        n_pages=16, prefix_cache=True, prefill_chunk_pages=2,
        host_spill=True, host_spill_mb=4.0) for _ in range(2)],
        routing="affinity")
    clock = ReplayClock()
    fleet.clock = clock
    rs = np.random.RandomState(7)
    prefix = rs.randint(0, 97, 12).astype(np.int32)

    def drain():
        for _ in range(4000):
            if not fleet.has_work:
                return
            fleet.step()
            clock.advance(0.005)
        raise AssertionError("fleet wedged")

    fleet.start_session()
    fleet.submit(Request(prompt=rs.randint(0, 97, 3).astype(np.int32),
                         max_new_tokens=12, request_id="junk"), arrival=0.0)
    fleet.submit(Request(prompt=np.concatenate([prefix, np.int32([5, 9])]),
                         max_new_tokens=3, request_id="ta-0"), arrival=0.0)
    drain()
    home = dict(fleet.assignment_log)["ta-0"]
    rep = fleet.replicas[home].batcher
    for i in range(20):          # churn demotes the prefix to host
        rep.submit(Request(prompt=np.full(8, 1 + i % 90, np.int32),
                           max_new_tokens=2, request_id=f"ch{i}"))
        while rep.has_work:
            rep.step()
    fleet.finish_session()
    assert rep.engine.tables.n_host_pages >= 3
    survivor = fleet.replicas[1 - home].batcher

    fleet.start_session()
    assert len(fleet.directory) > 0
    fleet.kill(home)
    assert fleet.n_directory_evictions > 0
    assert fleet.directory.entries_for(home) == []
    assert fleet.directory.n_reassigned > 0
    assert survivor.engine.tables.n_host_pages >= 3
    fleet.directory.check()
    h0, d0 = survivor.engine.host_hit_pages, fleet.n_directory_hits
    fleet.submit(Request(prompt=np.concatenate([prefix, np.int32([2, 8])]),
                         max_new_tokens=3, request_id="ta-2"), arrival=0.0)
    drain()
    assert dict(fleet.assignment_log)["ta-2"] == 1 - home
    assert fleet.n_directory_hits > d0
    assert survivor.engine.host_hit_pages > h0
    assert fleet.finish_session()["router"]["n_directory_evictions"] > 0
    assert "router_directory_evictions_total" in prometheus_text()


def test_signal_plane_off_routing_is_byte_identical_and_audited():
    """A health scorer observing and the audit ring recording, with
    health_aware off, move no routing decision; the audit records carry
    the load picture, the artifact of two replays diffs empty, and a new
    session clears the plane."""
    wl = _tenant_workload(n=8)
    bare = EngineFleet([_batcher() for _ in range(2)], routing="affinity",
                       audit=0)
    replay_inprocess(bare, wl, speed=1.0)
    arts = []
    for _ in range(2):
        plane = EngineFleet(
            [_batcher() for _ in range(2)], routing="affinity", audit=64,
            health=router.FleetHealth(every=2,
                                      registry=Registry(enabled=False)))
        replay_inprocess(plane, wl, speed=1.0)
        arts.append(router.routing_artifact(plane, wl.fingerprint()))
    assert plane.assignment_log == bare.assignment_log
    assert router.diff_routing(*arts) == []
    assert plane.health.n_observations > 0
    recs = plane.audit.tail()
    assert [r["seq"] for r in recs] == list(range(len(recs)))
    for rec in recs:
        assert set(rec) == {"seq", "request_id", "arrival", "replica",
                            "reason", "key", "candidates", "health",
                            "adapter"}
        for cand in rec["candidates"]:
            assert set(cand) == {"replica", "queue_depth", "inflight",
                                 "slack_s", "affinity_pages"}
    assert {r["request_id"] for r in arts[0]["reasons"]} \
        == {rid for rid, _ in arts[0]["assignments"]}
    stats = plane.router_stats()
    assert stats["audit"] == {"capacity": 64, "depth": len(recs),
                              "n_records": len(recs)}
    assert set(plane.debug_router(tail=3)) == {"router", "decisions"}
    assert len(plane.debug_router(tail=3)["decisions"]) == 3
    plane.start_session()
    assert len(plane.audit) == 0 and plane.health.n_observations == 0
    plane.finish_session()


# =====================================================================
# the front door over a fleet; the crash dump; the Chrome trace
# =====================================================================

def test_front_door_over_a_fleet_healthz_debug_and_router():
    from torchbooster_tpu_torch.serving.frontend import ServingFrontend

    async def scenario():
        fleet = _fleet(n=2, routing="affinity", audit=64)
        fe = ServingFrontend(fleet, port=0)
        await fe.start()
        out = {"completion": await _unary(
            fe.port, "/v1/completions",
            {"prompt": [1, 2, 3, 4, 5], "max_tokens": 3})}
        for path in ("/healthz", "/healthz?full=1", "/debug/engine",
                     "/debug/requests", "/debug/router",
                     "/debug/router?tail=1"):
            status, raw = await _get(fe.port, path)
            out[path] = (status, _body(raw))
        await fe.stop()
        fe = ServingFrontend(_batcher(), port=0)
        await fe.start()
        status, raw = await _get(fe.port, "/debug/router")
        out["single"] = (status, _body(raw))
        await fe.stop()
        return out

    out = asyncio.run(scenario())
    status, _, body = out["completion"]
    assert status == 200 and body["choices"][0]["token_ids"]
    status, bare = out["/healthz"]
    assert status == 200 and set(bare) == {"status", "queue_depth",
                                           "pages_free", "occupancy"}
    status, full = out["/healthz?full=1"]
    assert status == 200 and full["replicas_live"] == 2
    assert len(full["replicas"]) == 2
    status, engine = out["/debug/engine"]
    assert status == 200 and engine["router"]["policy"] == "affinity"
    assert [row["replica"] for row in engine["replicas"]] == [0, 1]
    assert all("flight" in row for row in engine["replicas"])
    status, snap = out["/debug/requests"]
    assert status == 200 and "replicas_live" in snap
    status, routed = out["/debug/router"]
    assert status == 200 and set(routed) == {"router", "decisions"}
    assert len(routed["decisions"]) >= 1
    assert len(out["/debug/router?tail=1"][1]["decisions"]) == 1
    status, err = out["single"]
    assert status == 404 and "single batcher" in err["error"]["message"]


def test_fleet_crash_dump_and_chrome_track(tmp_path):
    from torchbooster_tpu_torch.serving.frontend import ServingFrontend

    fleet = EngineFleet([_batcher()], routing="affinity", audit=64)
    fe = ServingFrontend(fleet, port=0,
                         crash_dump_path=str(tmp_path / "crash"))

    async def run():
        await fe.start()

        def boom():
            raise RuntimeError("synthetic replica death")

        fleet.replicas[0].batcher.engine.step = boom
        status, _, _ = await _unary(fe.port, "/v1/completions",
                                    {"prompt": [1, 2, 3], "max_tokens": 4})
        assert status == 500
        with pytest.raises(RuntimeError, match="synthetic"):
            await fe.stop()

    asyncio.run(run())
    assert set(fe.last_flight) == {"replicas", "router_audit"}
    assert fe.last_flight["router_audit"]
    lines = [json.loads(l) for l in
             (tmp_path / "crash.flight.jsonl").read_text().splitlines()]
    assert lines[0]["event"] == "fleet_flight_header"
    assert lines[0]["n_replicas"] == 1
    assert {"flight_header", "flight_step", "router_decision"} \
        <= {l["event"] for l in lines}
    assert [l for l in lines if l["event"] == "router_decision"][-1][
        "replica"] == 0

    tracer = RequestTracer(enabled=True)
    fleet = EngineFleet([_batcher(tracer=tracer) for _ in range(2)],
                        routing="round_robin", audit=64)
    assert fleet.tracer is tracer
    replay_inprocess(fleet, _tenant_workload(n=6), speed=1.0)
    fleet.write_chrome(tmp_path / "fleet.trace.json")
    trace = json.loads((tmp_path / "fleet.trace.json").read_text())
    pids = {e["pid"] for e in trace["traceEvents"]}
    assert 3 in pids and pids - {3}
    assert len([e for e in trace["traceEvents"]
                if e["pid"] == 3 and e["ph"] == "i"]) \
        == len(fleet.assignment_log)


# =====================================================================
# the merge and the schemas
# =====================================================================

_MERGED_KEYS = {"n_requests", "new_tokens", "elapsed_s", "decode_tok_s",
                "total_tok_s", "latency_mean_s", "latency_p95_s",
                "ttft_mean_s", "n_admissions", "n_preemptions",
                "n_prefill_chunks", "prefix_hit_pages", "n_shed",
                "n_cancelled", "deadline_hit_rate", "router", "replicas",
                "classes"}


def test_merge_metrics_equals_jax_on_the_same_replica_dicts():
    """Both packages' ``_merge_metrics`` over the same per-replica
    dicts (one replica's ``{}``: dead), router state set alike."""
    rs = np.random.RandomState(2)

    def replica_dict():
        d = {k: float(np.round(rs.uniform(0, 5), 4)) for k in (
            "elapsed_s", "decode_tok_s", "latency_mean_s",
            "latency_p95_s", "ttft_mean_s", "deadline_hit_rate")}
        d.update({k: int(rs.randint(0, 20)) for k in (
            "n_requests", "new_tokens", "n_admissions", "n_preemptions",
            "n_prefill_chunks", "prefix_hit_pages", "n_shed",
            "n_cancelled")})
        d["classes"] = {c: {"n_requests": int(rs.randint(9)),
                            "n_completed": int(rs.randint(9)),
                            "n_shed": int(rs.randint(3)),
                            "ttft_p50_s": float(rs.uniform()),
                            "ttft_p99_s": float(rs.uniform()),
                            "tpot_p50_s": None if c == "rt" else 0.1,
                            "tpot_p99_s": float(rs.uniform())}
                        for c in ("rt", "batch")[:int(rs.randint(1, 3))]}
        return d

    per = [replica_dict(), {}, replica_dict()]
    fleets = (_fleet(n=3), jrouter.EngineFleet(
        [_jax_batcher() for _ in range(3)], routing="round_robin"))
    merged = []
    for fleet in fleets:
        fleet.assignment_log = [("a", 0), ("b", 2), ("a", 2), ("c", 0)]
        fleet.n_fleet_cancelled = 2
        fleet.n_routed, fleet.n_readmitted = 4, 1
        fleet.replicas[1].alive = False
        merged.append(fleet._merge_metrics([dict(m) for m in per]))
    assert merged[0] == merged[1]
    assert set(merged[0]) == _MERGED_KEYS
    assert merged[0]["n_requests"] == 3 + 2
    assert merged[0]["router"]["replicas_live"] == 2


def test_readiness_and_merged_schemas_survive_a_dead_replica():
    fleet = _fleet(n=2)
    clock = ReplayClock()
    fleet.clock = clock
    fleet.start_session()
    rs = np.random.RandomState(5)
    for i in range(4):
        fleet.submit(Request(prompt=rs.randint(0, 97, 6).astype(np.int32),
                             max_new_tokens=4, request_id=f"r{i}"),
                     arrival=0.0)
    steps = 0
    while fleet.has_work and steps < 2000:
        fleet.step()
        clock.advance(0.005)
        steps += 1
        if steps == 3:
            fleet.kill(0)
            ready = fleet.readiness()
    m = fleet.finish_session()
    assert set(ready) == {"status", "replicas_live", "replicas_total",
                          "queue_depth", "pages_free", "pages_cached",
                          "inflight", "occupancy", "est_step_s",
                          "replicas"}
    assert ready["status"] == "ok" and ready["replicas_live"] == 1
    for row in ready["replicas"]:
        assert set(row) == {"status", "queue_depth", "pages_free",
                            "pages_cached", "pages_host", "inflight",
                            "occupancy", "est_step_s", "step_seq",
                            "stamped_s", "replica", "alive"}
    assert [r["replica"] for r in ready["replicas"] if not r["alive"]] \
        == [0]
    assert set(m) == _MERGED_KEYS and len(m["replicas"]) == 2
    assert m["n_requests"] == 4 and m["router"]["replicas_live"] == 1
    assert m["router"]["n_readmitted"] > 0
    assert set(m["router"]) == {
        "policy", "n_replicas", "replicas_live", "n_routed",
        "n_affinity_hits", "n_spills", "n_directory_hits",
        "n_directory_evictions", "n_readmitted", "n_rebalanced",
        "n_pending", "directory", "audit", "health_aware", "health"}


# =====================================================================
# the router: block
# =====================================================================

def test_router_yaml_block_builds_fleet(tmp_path):
    from torchbooster_tpu_torch.config import (RouterConfig,
                                               RouterHealthConfig,
                                               ServingConfig)

    pytest.importorskip("yaml")
    _, _, tp, cfg = _model()
    path = tmp_path / "serve.yml"
    path.write_text(
        "page_size: 4\nn_pages: 24\nmax_slots: 2\nprefix_cache: true\n"
        "frontend:\n  policy: slo\n  classes: 'rt:60000:0,batch:0:0'\n"
        "  default_class: batch\n"
        "router:\n  n_replicas: 3\n  policy: affinity\n"
        "  affinity_pages: 1\n  spill_queue: 2\n  rebalance_queue: 4\n"
        "  audit: 32\n  health_aware: true\n"
        "  health:\n    enabled: true\n    every: 2\n    queue_limit: 8\n")
    sc = ServingConfig.load(path)
    fleet = sc.make(tp, cfg, compute_dtype="float32", device="cpu")
    assert isinstance(fleet, EngineFleet) and len(fleet.replicas) == 3
    assert fleet.routing.name == "affinity"
    assert fleet.routing.affinity_pages == 1 and fleet.rebalance_queue == 4
    assert fleet.audit.capacity == 32 and fleet.health.every == 2
    assert fleet.routing.health is fleet.health
    assert len({id(r.batcher.policy) for r in fleet.replicas}) == 1
    assert len({id(r.batcher.tracer) for r in fleet.replicas}) == 1
    assert fleet.policy.classes.keys() == {"rt", "batch"}

    sc.router.n_replicas, sc.router.health_aware = 1, False
    assert isinstance(sc.make(tp, cfg, compute_dtype="float32",
                              device="cpu"), ContinuousBatcher)
    sc.router.n_replicas = 0
    with pytest.raises(ValueError, match="n_replicas"):
        sc.make(tp, cfg, compute_dtype="float32", device="cpu")
    sc.router.n_replicas, sc.router.policy = 2, "sticky"
    with pytest.raises(ValueError, match="round_robin.*affinity"):
        sc.make(tp, cfg, compute_dtype="float32", device="cpu")
    sc = ServingConfig.from_dict({"router": {"n_replicas": 2,
                                             "health_aware": True}})
    with pytest.raises(ValueError, match="health_aware"):
        sc.make(tp, cfg, compute_dtype="float32", device="cpu")
    sc = ServingConfig.from_dict({
        "prefix_cache": True, "host_spill": {"enabled": True},
        "disagg": {"enabled": True}, "router": {"n_replicas": 2}})
    with pytest.raises(ValueError, match="disagg"):
        sc.make(tp, cfg, compute_dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="unknown serving.router keys"):
        ServingConfig.from_dict({"router": {"n_replica": 2}})
    assert RouterHealthConfig().make() is None
    assert RouterHealthConfig(enabled=True, every=3).make().every == 3
    with pytest.raises(ValueError, match="health_aware"):
        RouterConfig(n_replicas=2, health_aware=True).make([])
