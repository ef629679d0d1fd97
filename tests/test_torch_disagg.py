"""Port parity: prefill/decode disaggregation (``serving/disagg.py``
``DisaggPair``), the router's wire codec (``serving/router/rpc.py``) and
the batcher's control surface, against the JAX package on the CPU (vocab
128, 2 layers, d_model 32, 2 heads, pages of 16, int8 pool, decisive
tied head, fp32).

- ``frame_blob``/``unframe_blob``, ``send_msg``/``recv_msg`` over a
  socketpair and ``pack_pages``/``unpack_pages``: the port's bytes equal
  the JAX module's for the same input, and each side decodes the other's;
- the request codec round-trips the fold contract, byte-equal to JAX's;
- ``DisaggPair`` over a mixed trace: the port's tokens equal the port's
  unified batcher's and the JAX ``DisaggPair``'s; streamed payload bytes
  equal ``disagg_traffic``; one decode, prefill and promotion shape on
  the decode engine, no decode on the prefill engine;
- a dead prefill worker re-raises on the pump thread; validation is
  loud, in JAX's words;
- ``has_work``, ``inflight``, ``readiness``, ``drain_queued``,
  ``drain_unfinished`` and ``debug_snapshot``'s keys equal the JAX
  batcher's on one scripted trace, timing fields aside.
"""
import socket
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu import config as jconfig
from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.serving import (ContinuousBatcher as JaxBatcher,
                                      PagedEngine as JaxEngine,
                                      Request as JaxRequest)
from torchbooster_tpu.serving.disagg import DisaggPair as JaxDisaggPair
from torchbooster_tpu.serving.router import rpc as jrpc
from torchbooster_tpu_torch import config as tconfig
from torchbooster_tpu_torch.comms.accounting import disagg_traffic
from torchbooster_tpu_torch.config import (DisaggConfig, HostSpillConfig,
                                           ServingConfig)
from torchbooster_tpu_torch.interop import params_from_jax
from torchbooster_tpu_torch.models.gpt import GPTConfig
from torchbooster_tpu_torch.serving import (ContinuousBatcher, DisaggPair,
                                            PagedEngine, Request)
from torchbooster_tpu_torch.serving.router import rpc

VOCAB = 128
PAGE = 16
_KW = dict(vocab=VOCAB, n_layers=2, d_model=32, n_heads=2, seq_len=128)
_CACHE: dict = {}


def _model():
    """JAX-initialized decisive model and its port twin (cached)."""
    if "model" not in _CACHE:
        jcfg = JCfg(**_KW)
        jp = JGPT.init(jax.random.PRNGKey(0), jcfg)
        jp = {**jp, "wte": {"table": jp["wte"]["table"] * 4.0}}
        cfg = GPTConfig(**_KW)
        _CACHE["model"] = (jp, jcfg, params_from_jax(jax.device_get(jp),
                                                     cfg, "cpu"), cfg)
    return _CACHE["model"]


def _conf(mod, disagg=False, min_prefill_pages=2):
    sc = mod.ServingConfig(page_size=PAGE, n_pages=64, max_slots=4,
                           cache_dtype="int8", prefix_cache=True)
    sc.host_spill = mod.HostSpillConfig(enabled=True, budget_mb=64.0)
    if disagg:
        sc.disagg = mod.DisaggConfig(enabled=True,
                                     min_prefill_pages=min_prefill_pages)
    return sc


def _make(disagg=False, **kw):
    _, _, tp, cfg = _model()
    return _conf(tconfig, disagg, **kw).make(
        tp, cfg, compute_dtype="float32", device="cpu")


def _make_jax(disagg=False, **kw):
    jp, jcfg, _, _ = _model()
    return _conf(jconfig, disagg, **kw).make(jp, jcfg,
                                             compute_dtype=jnp.float32)


def _pump(srv, reqs, timeout=120.0):
    srv.start_session()
    for r in reqs:
        srv.submit(r, arrival=0.0)
    deadline = time.time() + timeout
    while srv.has_work:
        assert time.time() < deadline, "drive loop did not drain"
        srv.step()
        decode = getattr(srv, "decode", None)
        if decode is not None and not decode.has_work:
            time.sleep(0.001)        # only the prefill worker has work
    return srv.finish_session()


def _mixed_requests(req_cls, seed=5, n_new=6):
    rs = np.random.RandomState(seed)
    lens = (40, 12, 50, 34, 8, 20)
    prompts = [rs.randint(0, VOCAB, n).astype(np.int32) for n in lens]
    return [req_cls(prompt=p, max_new_tokens=n_new, request_id=f"r{i}")
            for i, p in enumerate(prompts)]


# ---- the framed codec ------------------------------------------------

def test_frame_blob_bytes_equal_jax_and_socket():
    """The blob is the JAX module's byte for byte, each side unframes
    the other's, truncation is loud, and the bytes a socketpair carries
    (``send_msg``) equal the blob and read back through ``recv_msg``."""
    header = {"op": "page_stream", "request_id": "r7", "n": 3,
              "x": np.float32(0.5), "ids": np.arange(3)}
    frames = [b"abc", b"", b"\x00" * 17]
    blob = rpc.frame_blob(header, frames)
    assert blob == jrpc.frame_blob(header, frames)
    for unframe in (rpc.unframe_blob, jrpc.unframe_blob):
        h2, f2 = unframe(blob)
        assert h2["request_id"] == "r7" and h2["ids"] == [0, 1, 2]
        assert f2 == frames
    a, b = socket.socketpair()
    try:
        sent = rpc.send_msg(a, header, frames)
        data = b.recv(1 << 20)
        assert sent == len(data) and data == blob
        jrpc.send_msg(a, header, frames)
        h3, f3, n = rpc.recv_msg(b)
        assert f3 == frames and n == len(blob) and h3["n"] == 3
    finally:
        a.close()
        b.close()
    with pytest.raises(ValueError, match="length mismatch"):
        rpc.unframe_blob(blob[:-1])


def test_pack_pages_bytes_equal_jax():
    rs = np.random.RandomState(1)
    pages = []
    for p in range(3):
        payload = {
            "k": rs.randint(-120, 120, (2, 4, 2, 8)).astype(np.int8),
            "k_scale": rs.rand(2, 4, 2, 1).astype(np.float32),
            "v": rs.randint(-120, 120, (2, 4, 2, 8)).astype(np.int8),
            "v_scale": rs.rand(2, 4, 2, 1).astype(np.float32)}
        pages.append((f"chain{p}".encode(), payload))
    header, frames = rpc.pack_pages(pages)
    jheader, jframes = jrpc.pack_pages(pages)
    assert header == jheader and frames == jframes
    assert header["page_bytes"] == sum(
        arr.nbytes for _, pl in pages for arr in pl.values())
    assert rpc.frame_blob(header, frames) \
        == jrpc.frame_blob(jheader, jframes)
    for unpack in (rpc.unpack_pages, jrpc.unpack_pages):
        out = unpack(header, frames)
        assert [k for k, _ in out] == [k for k, _ in pages]
        for (_, got), (_, want) in zip(out, pages):
            for name in ("k", "k_scale", "v", "v_scale"):
                assert got[name].dtype == want[name].dtype
                np.testing.assert_array_equal(got[name], want[name])


def test_request_codec_round_trip_equals_jax():
    """A folded request crosses with its ORIGINAL ``base_len`` and its
    delivered tokens; the port's descriptor and frames are JAX's, and
    each side decodes the other's."""
    reqs = []
    for cls in (Request, JaxRequest):
        req = cls(prompt=np.arange(8, dtype=np.int32), max_new_tokens=6,
                  request_id="fold-1", priority="batch", deadline_ms=500,
                  seed=7)
        req.tokens = [3, 5]
        req.prompt = np.concatenate([req.prompt, np.int32([3, 5])])
        req.first_token_at = 0.25
        reqs.append(req)
    head, frames = rpc.encode_request(reqs[0])
    jhead, jframes = jrpc.encode_request(reqs[1])
    assert head == jhead and frames == jframes
    assert rpc.frame_blob(head, frames) == jrpc.frame_blob(jhead, jframes)
    for decode, cls in ((rpc.decode_request, Request),
                        (jrpc.decode_request, JaxRequest)):
        back = decode(head, frames)
        assert isinstance(back, cls)
        assert back.request_id == "fold-1" and back.base_len == 8
        assert back.tokens == [3, 5]
        assert back.prompt.tolist() == reqs[0].prompt.tolist()
        assert (back.max_new_tokens, back.priority, back.deadline_ms,
                back.seed) == (6, "batch", 500, 7)
        assert back.first_token_at == 0.25 and back.finished_at is None


# ---- DisaggPair ------------------------------------------------------

def test_disagg_pair_parity_bytes_and_compile_contract():
    """The port's pair gives the tokens of the port's unified batcher and
    of the JAX pair; measured payload bytes equal ``disagg_traffic``;
    pages enter the decode engine through one promotion shape and the
    prefill engine never decodes."""
    uni = _make(disagg=False)
    assert isinstance(uni, ContinuousBatcher)
    ra = _mixed_requests(Request)
    _pump(uni, ra)
    pair = _make(disagg=True, min_prefill_pages=2)
    assert isinstance(pair, DisaggPair) and pair.prefill.prefill_only
    rb = _mixed_requests(Request)
    metrics = _pump(pair, rb)
    jpair = _make_jax(disagg=True, min_prefill_pages=2)
    rc = _mixed_requests(JaxRequest)
    jmetrics = _pump(jpair, rc)
    for x, y, z in zip(ra, rb, rc):
        assert x.tokens == y.tokens == z.tokens, x.request_id
        assert y.finished_at is not None
    d, jd = metrics["disagg"], jmetrics["disagg"]
    assert d == jd
    longs = [r for r in rb if (r.base_len - 1) // PAGE >= 2]
    assert d["prefill_requests"] == len(longs) == 3
    assert d["stranded"] == 0
    _, _, _, cfg = _model()
    assert d["page_bytes_streamed"] == sum(
        disagg_traffic(r.base_len, page_size=PAGE, kv_heads=cfg.kv_heads,
                       head_dim=cfg.head_dim,
                       n_layers=cfg.n_layers)["total_bytes"] for r in longs)
    assert d["framed_bytes_streamed"] > d["page_bytes_streamed"]
    assert d["pages_streamed"] == sum((r.base_len - 1) // PAGE
                                      for r in longs)
    de = pair.decode.engine
    assert de.decode_compiles == de.prefill_compiles \
        == de.promote_compiles == 1
    assert pair.prefill.prefill_compiles == 1
    assert pair.prefill.decode_compiles == 0
    assert pair.prefill.exported_pages == d["pages_streamed"]
    assert metrics["host_hit_pages"] == d["pages_streamed"]
    de.tables.check()


def test_disagg_pair_thread_handoff_under_a_short_switch_interval():
    """The worker and the pump share the transfer queues and the
    in-flight count: with the interpreter switching threads every 10 µs,
    twelve requests (eight routed to the prefill worker) all finish with
    their full budgets, none stranded, the count back at 0 and the worker
    joined."""
    import sys

    pair = _make(disagg=True, min_prefill_pages=1)
    rs = np.random.RandomState(8)
    reqs = [Request(prompt=rs.randint(0, VOCAB, int(n)).astype(np.int32),
                    max_new_tokens=3, request_id=f"s{i}")
            for i, n in enumerate(rs.choice([9, 17, 33, 49], 12))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        metrics = _pump(pair, reqs, timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert all(len(r.tokens) == 3 and r.finished_at is not None
               for r in reqs)
    d = metrics["disagg"]
    assert d["stranded"] == 0 and pair._inflight == 0
    assert d["prefill_requests"] == sum(r.base_len > PAGE for r in reqs)
    assert pair._worker is None


def test_disagg_pair_worker_death_is_loud():
    pair = _make(disagg=True, min_prefill_pages=2)
    pair.start_session()

    def fall_over(*a, **kw):
        raise RuntimeError("prefill card fell over")

    pair.prefill.admit_begin = fall_over
    [long_req] = [r for r in _mixed_requests(Request)
                  if r.request_id == "r2"]
    pair.submit(long_req, arrival=0.0)
    with pytest.raises(RuntimeError, match="prefill worker died") as err:
        deadline = time.time() + 30
        while time.time() < deadline:
            pair.step()
            time.sleep(0.005)
    assert "fell over" in str(err.value.__cause__)
    assert pair.finish_session()["disagg"]["stranded"] == 1


def test_disagg_validation_loud():
    """The pair's and ``make``'s refusals, in the JAX package's words;
    the prefill engine refuses to decode."""
    _, _, tp, cfg = _model()
    errs = []
    for pair_cls in (DisaggPair, JaxDisaggPair):
        with pytest.raises(TypeError, match="PagedEngine") as e:
            pair_cls(object(), object())
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    jp, jcfg, _, _ = _model()
    for mutate, match in (
            (lambda sc: setattr(sc.host_spill, "enabled", False),
             "host_spill"),
            (lambda sc: setattr(sc, "prefix_cache", False), "prefix_cache"),
            (lambda sc: setattr(sc.disagg, "min_prefill_pages", 0),
             "min_prefill_pages"),
            (lambda sc: setattr(sc.router, "n_replicas", 2),
             "multi-replica router")):
        msgs = []
        for mod, build in (
                (tconfig, lambda sc: sc.make(tp, cfg,
                                             compute_dtype="float32",
                                             device="cpu")),
                (jconfig, lambda sc: sc.make(jp, jcfg,
                                             compute_dtype=jnp.float32))):
            sc = _conf(mod, disagg=True)
            mutate(sc)
            with pytest.raises(ValueError, match=match) as e:
                build(sc)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    pair = _make(disagg=True, min_prefill_pages=2)
    with pytest.raises(RuntimeError, match="prefill_only"):
        pair.prefill.step()
    eng = PagedEngine(tp, cfg, page_size=PAGE, n_pages=16, device="cpu",
                      prefix_cache=True)
    with pytest.raises(ValueError, match="host spill"):
        DisaggPair(pair.prefill, ContinuousBatcher(eng))
    pair.start_session()
    with pytest.raises(ValueError):
        pair.submit(Request(prompt=np.zeros(4096, np.int32),
                            max_new_tokens=2, request_id="too-long"),
                    arrival=0.0)
    pair.finish_session()


def test_serving_yaml_disagg_block_builds_a_pair(tmp_path):
    path = tmp_path / "serve.yaml"
    path.write_text("serving:\n  page_size: 16\n  n_pages: 32\n"
                    "  cache_dtype: int8\n  prefix_cache: true\n"
                    "  host_spill: {enabled: true, budget_mb: 16}\n"
                    "  disagg: {enabled: true, min_prefill_pages: 3,\n"
                    "           prefill_n_pages: 20, prefill_max_slots: 2}\n")
    conf = ServingConfig.load(path)
    assert isinstance(conf.disagg, DisaggConfig)
    assert isinstance(conf.host_spill, HostSpillConfig)
    assert (conf.disagg.min_prefill_pages, conf.disagg.prefill_n_pages,
            conf.disagg.prefill_max_slots) == (3, 20, 2)
    _, _, tp, cfg = _model()
    pair = conf.make(tp, cfg, compute_dtype="float32", device="cpu")
    assert isinstance(pair, DisaggPair) and pair.min_prefill_pages == 3
    assert (pair.prefill.n_pages, pair.prefill.max_slots) == (20, 2)
    assert pair.prefill.prefill_only and not pair.prefill.host_spill
    assert pair.decode.engine.host_spill
    assert pair.decode.engine.n_pages == 32


# ---- the batcher's control surface -----------------------------------

class _Clock:
    """A clock that advances by itself, 1 ms a read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


_TIMING = {"arrival_s", "admitted_at_s", "first_token_at_s",
           "session_now_s", "timeline_tail"}


def _surface(b) -> dict:
    ready = {k: v for k, v in b.readiness().items()
             if k not in ("est_step_s", "stamped_s")}
    snap = b.debug_snapshot()
    return {"has_work": b.has_work, "inflight": b.inflight,
            "session_active": b.session_active, "readiness": ready,
            "snapshot": {**{k: v for k, v in snap.items()
                            if k not in ("requests", "session_now_s")},
                         "requests": [{k: v for k, v in r.items()
                                       if k not in _TIMING}
                                      for r in snap["requests"]]},
            "snapshot_keys": sorted(snap),
            "request_keys": sorted({k for r in snap["requests"]
                                    for k in r})}


def test_batcher_surface_equals_jax_on_a_scripted_trace():
    """Submit 6, step, cancel one queued and one seated, step, drain 2
    from the queue's back, step, drain the rest: every read of the
    surface equals the JAX batcher's at the same point."""
    jp, jcfg, tp, cfg = _model()
    kw = dict(page_size=PAGE, n_pages=12, max_slots=2, prefix_cache=True,
              prefill_chunk_pages=1)
    port = ContinuousBatcher(PagedEngine(tp, cfg, compute_dtype=torch.float32,
                                         device="cpu", **kw), clock=_Clock())
    jax_b = JaxBatcher(JaxEngine(jp, jcfg, compute_dtype=jnp.float32, **kw),
                       clock=_Clock())
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, VOCAB, n).astype(np.int32)
               for n in (20, 40, 9, 30, 17, 25)]
    trace = {}
    for name, b, cls in (("port", port, Request), ("jax", jax_b, JaxRequest)):
        reads = [_surface(b)]
        assert not b.has_work and not b.session_active
        b.start_session()
        reqs = [cls(prompt=p, max_new_tokens=5, request_id=f"q{i}")
                for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r, arrival=0.0)
        reads.append(_surface(b))
        for _ in range(3):
            b.step()
            reads.append(_surface(b))
        b.cancel(reqs[5])                   # queued
        b.cancel(reqs[0])                   # seated
        b.step()
        reads.append(_surface(b))
        queued = b.drain_queued(2)
        reads.append(_surface(b))
        for _ in range(4):
            b.step()
            reads.append(_surface(b))
        left = b.drain_unfinished()
        reads.append(_surface(b))
        metrics = b.finish_session()
        trace[name] = {
            "reads": reads,
            "queued": [r.request_id for r in queued],
            "left": [(r.request_id, r.prompt.tolist(), list(r.tokens),
                      r.base_len) for r in left],
            "done": [(r.request_id, list(r.tokens), r.finish_reason,
                      r.cancelled, r.shed) for r in reqs],
            "metrics": {k: metrics[k] for k in (
                "n_requests", "new_tokens", "n_admissions", "n_cancelled",
                "n_shed", "n_spills", "n_promotions", "host_hit_pages")}}
    assert trace["port"] == trace["jax"]
    reads = trace["port"]["reads"]
    assert any(r["inflight"] == 2 for r in reads)
    assert trace["port"]["queued"] and trace["port"]["left"]
    assert trace["port"]["metrics"]["n_cancelled"] == 2
    assert not port.session_active and port.drain_unfinished() == []
    assert port.drain_queued(3) == []
