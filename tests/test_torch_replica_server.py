"""Port parity: socket replicas (``torchbooster_tpu_torch/serving/router/
rpc.py``'s ``RemoteReplica``, ``WireClock`` and policy spec) and the
replica server (``torchbooster_tpu_torch/serving/replica_server.py``) on
the CPU, over real loopback sockets (vocab 97, 2 layers, d_model 32, 4
heads over 2, pages of 4, 24 pages, 2 slots, decisive tied head, fp32,
greedy).

- a fleet of one in-process and one socket replica gives the token
  streams and the ``assignment_log`` of a two-in-process fleet, and
  ``diff_routing`` of their routing artifacts is empty;
- killing the server mid-decode is replica death: every request
  finishes exactly once with the streams of a no-death run, and the
  readmission counter equals what the death orphaned;
- a remote readiness payload's ``age_s`` is sender-relative and grows on
  the client's clock; ``FleetHealth`` strikes on it;
- ``router.replicas`` builds a mixed fleet and refuses a bad entry;
- ``build_from_config(path, device="cpu")`` serves the streams of an
  in-process port batcher built from the same config and seed, and
  refuses a multi-replica router block;
- wire bytes equal JAX's: ``policy_spec`` and the responses of one
  hello / clock / session / submit / step exchange, the port's server and
  JAX's each over the same weights;
- the server's thread pins the engine's card by index.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.serving import ContinuousBatcher as JaxBatcher
from torchbooster_tpu.serving import PagedEngine as JaxEngine
from torchbooster_tpu.serving import replica_server as jserver
from torchbooster_tpu.serving.batcher import Request as JaxRequest
from torchbooster_tpu.serving.frontend import SLOPolicy as JaxSLOPolicy
from torchbooster_tpu.serving.frontend import parse_classes as jax_classes
from torchbooster_tpu.serving.router import rpc as jrpc
from torchbooster_tpu_torch.interop import params_from_jax
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
from torchbooster_tpu_torch.observability.export import prometheus_text
from torchbooster_tpu_torch.serving import (
    ContinuousBatcher,
    PagedEngine,
    Request,
)
from torchbooster_tpu_torch.serving.frontend import SLOPolicy, parse_classes
from torchbooster_tpu_torch.serving.replica_server import (
    ReplicaServer,
    build_from_config,
    serve_in_thread,
)
from torchbooster_tpu_torch.serving.router import EngineFleet, rpc
from torchbooster_tpu_torch.serving.router.audit import (
    diff_routing,
    routing_artifact,
)
from torchbooster_tpu_torch.serving.router.health import (
    DEGRADED,
    HEALTHY,
    FleetHealth,
)
from torchbooster_tpu_torch.serving.router.rpc import RemoteReplica

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


def _make(policy=None):
    _, _, tp, cfg = _model()
    return ContinuousBatcher(PagedEngine(
        tp, cfg, compute_dtype=torch.float32, device="cpu", **_ENGINE),
        policy=policy)


def _requests(req_cls=Request, seed=7, n_new=6):
    rs = np.random.RandomState(seed)
    return [req_cls(prompt=rs.randint(0, 97, n).astype(np.int32),
                    max_new_tokens=n_new, request_id=f"r{i}")
            for i, n in enumerate((20, 6, 25, 14, 4, 10))]


def _pump(srv, reqs, cap=5000):
    srv.start_session()
    for r in reqs:
        srv.submit(r, arrival=0.0)
    n = 0
    while srv.has_work and n < cap:
        srv.step()
        n += 1
    assert n < cap, "drive loop did not drain"
    return srv.finish_session()


def test_socket_replica_parity_tokens_and_assignments():
    def run(members):
        fleet = EngineFleet(members, routing="affinity", audit=256)
        reqs = _requests()
        _pump(fleet, reqs)
        return [r.tokens for r in reqs], list(fleet.assignment_log), \
            routing_artifact(fleet, "parity-trace")

    ta, la, aa = run([_make(), _make()])
    handle = serve_in_thread(_make())
    try:
        remote = RemoteReplica(handle.endpoint, replica_id=1)
        tb, lb, ab = run([_make(), remote])
        assert remote.wire_tx_bytes > 0 and remote.wire_rx_bytes > 0
        remote.close()
    finally:
        handle.stop()
    assert ta == tb, "the socket changed a stream"
    assert la == lb and {rep for _, rep in la} == {0, 1}
    assert diff_routing(aa, ab) == []


def test_socket_replica_death_readmits_and_metrics_survive():
    def run(kill_at_step):
        handle = serve_in_thread(_make())
        fleet = EngineFleet(
            [_make(), RemoteReplica(handle.endpoint, replica_id=1)],
            routing="round_robin")
        fleet.start_session()
        reqs = _requests(seed=11, n_new=8)
        for r in reqs:
            fleet.submit(r, arrival=0.0)
        steps = 0
        while fleet.has_work and steps < 5000:
            fleet.step()
            steps += 1
            if steps == kill_at_step:
                handle.kill()
        metrics = fleet.finish_session()
        handle.stop()
        return fleet, reqs, metrics

    _, control, _ = run(kill_at_step=-1)
    fleet, reqs, metrics = run(kill_at_step=3)
    assert fleet.n_live == 1
    assert isinstance(fleet.last_error, RuntimeError)
    assert "connection" in str(fleet.last_error)
    by_id = {r.request_id: r for r in reqs}
    for c in control:
        r = by_id[c.request_id]
        assert r.finished_at is not None and not r.cancelled
        assert r.tokens == c.tokens, f"{r.request_id}: death changed it"
    assert metrics["router"]["n_readmitted"] > 0
    assert metrics["n_requests"] == len(reqs)
    txt = prometheus_text()
    assert "router_readmissions_total" in txt
    assert "router_replicas_live" in txt
    assert fleet.debug_fleet()["replicas"][1]["alive"] is False


def test_remote_readiness_age_is_sender_relative_and_health_strikes():
    handle = serve_in_thread(_make())
    try:
        rep = RemoteReplica(handle.endpoint, replica_id=0)
        assert rep.page_size == 4 and rep.geometry["n_pages"] == 24
        rep.start_session()
        rep.step()
        r1 = rep.readiness()
        assert r1["age_s"] >= 0.0 and "stamped_s" in r1
        time.sleep(0.05)
        r2 = rep.readiness()
        assert r2["age_s"] >= r1["age_s"] + 0.04
        assert rep.debug_row()["endpoint"] == handle.endpoint
        rep.finish_session()
        rep.close()
    finally:
        handle.stop()

    class _Stub:
        replica_id, alive, has_work, age = 0, True, True, 0.0

        def readiness(self):
            return {"step_seq": 7, "stamped_s": 123.0, "age_s": self.age,
                    "queue_depth": 0, "pages_free": 64, "pages_cached": 0}

    class _Fleet:
        replicas = [_Stub()]

    stub = _Fleet.replicas[0]
    health = FleetHealth(every=1, degrade_after=1, stale_s=2.0)
    health.observe(_Fleet)
    stub.age = 0.5
    health.observe(_Fleet)
    assert health.state(0) == HEALTHY
    stub.age = 5.0
    health.observe(_Fleet)
    assert health.state(0) == DEGRADED
    assert "stale" in health.snapshot()["last_strikes"][0]


def test_router_replicas_yaml_builds_and_validates():
    from torchbooster_tpu_torch.config import ServingConfig

    _, _, tp, cfg = _model()
    handle = serve_in_thread(_make())
    try:
        sc = ServingConfig.from_dict({
            "page_size": 4, "n_pages": 24, "max_slots": 2,
            "router": {"replicas": ["inproc", handle.endpoint]}})
        fleet = sc.make(tp, cfg, compute_dtype="float32", device="cpu")
        assert isinstance(fleet, EngineFleet) and len(fleet.replicas) == 2
        assert isinstance(fleet.replicas[1], RemoteReplica)
        assert fleet.replicas[1].replica_id == 1
        reqs = _requests()[:3]
        _pump(fleet, reqs)
        assert all(len(r.tokens) == 6 for r in reqs)
        fleet.replicas[1].close()
    finally:
        handle.stop()
    sc = ServingConfig.from_dict({"router": {"replicas": "inproc,inproc"}})
    assert sc.router.replicas == ["inproc", "inproc"]
    sc.router.replicas = ["carrier-pigeon"]
    with pytest.raises(ValueError, match="replicas"):
        sc.make(tp, cfg, compute_dtype="float32", device="cpu")


def test_replica_server_build_from_config(tmp_path):
    pytest.importorskip("yaml")
    path = tmp_path / "replica.yml"
    path.write_text(
        "seed: 3\nvocab: 97\nn_layers: 1\nd_model: 16\nn_heads: 2\n"
        "seq_len: 64\n"
        "serving:\n  page_size: 4\n  n_pages: 16\n  max_slots: 2\n")
    served = build_from_config(str(path), device="cpu")
    assert isinstance(served, ContinuousBatcher)
    assert served.engine.page_size == 4 and served.engine.device.type \
        == "cpu"
    cfg = GPTConfig(vocab=97, n_layers=1, d_model=16, n_heads=2,
                    seq_len=64)
    local = PagedEngine(GPT.init(3, cfg, device="cpu"), cfg, page_size=4,
                        n_pages=16, max_slots=2, device="cpu")
    handle = serve_in_thread(served)
    try:
        remote = RemoteReplica(handle.endpoint)
        fleet = EngineFleet([remote])
        a, b = _requests()[:3], _requests()[:3]
        _pump(fleet, a)
        _pump(ContinuousBatcher(local), b)
        remote.close()
    finally:
        handle.stop()
    assert [r.tokens for r in a] == [r.tokens for r in b]
    path.write_text("seq_len: 64\nserving:\n  router:\n    n_replicas: 2\n")
    with pytest.raises(SystemExit, match="ONE batcher"):
        build_from_config(str(path), device="cpu")
    path.write_text("n_layer: 1\n")
    with pytest.raises(ValueError, match="unknown replica config keys"):
        build_from_config(str(path), device="cpu")


def test_wire_bytes_equal_jax():
    """The port's ``ReplicaServer`` and JAX's over the same weights:
    the framed response to each op of one exchange is byte-equal, and
    so is the ``policy_spec`` a hello carries."""
    jp, jcfg, _, _ = _model()
    spec = "interactive:1000:0,batch:0:0"
    policy = SLOPolicy(parse_classes(spec), default="batch")
    jpolicy = JaxSLOPolicy(jax_classes(spec), default="batch")
    assert rpc.frame_blob(rpc.policy_spec(policy)) \
        == jrpc.frame_blob(jrpc.policy_spec(jpolicy))
    assert rpc.policy_spec(None) == jrpc.policy_spec(None) \
        == {"kind": "fcfs"}
    back = rpc.policy_from_spec(rpc.policy_spec(policy))
    assert back.classes == policy.classes and back.default == "batch"

    servers = [ReplicaServer(_make(policy)), jserver.ReplicaServer(
        JaxBatcher(JaxEngine(jp, jcfg, compute_dtype=jnp.float32,
                             **_ENGINE), policy=jpolicy))]
    mods = (rpc, jrpc)
    reqs = [_requests(req_cls=cls)[:3] for cls in (Request, JaxRequest)]
    script = [({"op": "hello", "proto": rpc.PROTO}, None),
              ({"op": "clock", "frozen": True}, None),
              ({"op": "tier_events", "on": True}, None),
              ({"op": "start_session"}, None)]
    script += [({"op": "submit", "arrival": 0.0}, i) for i in range(3)]
    script += [({"op": "step"}, None)] * 12
    script += [({"op": "drain_unfinished", "retire_seated": True}, None),
               ({"op": "finish_session"}, None)]
    n_events = 0
    for k, (head, req_i) in enumerate(script):
        blobs = []
        for server, mod, rs in zip(servers, mods, reqs):
            msg, frames = dict(head, now=0.005 * k), []
            if req_i is not None:
                msg["req"], frames = mod.encode_request(rs[req_i])
            resp, out = server.handle(msg, frames)
            if head["op"] == "finish_session":
                resp["metrics"] = {key: v for key, v in resp[
                    "metrics"].items() if key in ("n_requests",
                                                  "new_tokens")}
            blobs.append(mod.frame_blob(resp, out))
        assert blobs[0] == blobs[1], f"op {k} ({head['op']}) differs"
        n_events += len(rpc.unframe_blob(blobs[0])[0].get("events", ()))
    assert n_events >= 3 * 6, "the exchange streamed no tokens"


def test_server_thread_pins_the_engines_card(monkeypatch):
    """The server's thread makes the engine's card its current device,
    by index: an index-less ``cuda`` engine pins the current card (torch
    refuses ``set_device`` of an index-less device); a CPU engine pins
    nothing."""
    from torchbooster_tpu_torch.serving import replica_server

    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    fake = lambda dev: type("B", (), {"engine": type(
        "E", (), {"device": torch.device(dev)})()})()
    for dev in ("cuda", "cuda:1", "cpu"):
        replica_server._pin_device(fake(dev))
    assert calls == [3, 1]
