"""Port parity: the HTTP front door (``torchbooster_tpu_torch/serving/
frontend``: ``http.py``, ``server.py`` and the ``frontend:`` block)
against the JAX package on the CPU (vocab 97, 2 layers, d_model 32, 4
heads over 2, pages of 4, decisive tied head, fp32, greedy).

- ``http.py`` parses a table of raw requests, good and malformed, into
  JAX's requests and JAX's errors, and its serializers write JAX's
  bytes;
- a port ``ServingFrontend`` and a JAX one over the same weights answer
  the same HTTP exchanges (a streamed completion, a streamed chat
  completion, a unary ``n=2, best_of=3`` on a parallel-sampling engine,
  a 400, a 404, a 405) with equal raw responses, ``created`` masked;
  the streamed tokens equal the dense ``generate``; ``/healthz``,
  ``/debug/*`` and ``/metrics`` answer with JAX's keys;
- a client that disconnects mid-decode is cancelled: every page comes
  back, the tables check, no new step shape; a step that raises ends
  the pump with a 500 and re-raises at ``stop()``;
- under ``policy: slo`` an unmeetable deadline answers 429 +
  Retry-After before any page moves;
- ``capture_path`` writes a workload both packages load to the same
  fingerprint;
- the ``frontend:`` YAML block installs ``SLOPolicy`` on the batcher
  ``ServingConfig.make`` returns; a ``router: {n_replicas: 2}`` block
  builds an ``EngineFleet`` under that policy.
"""
import asyncio
import importlib.util
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.serving import ContinuousBatcher as JaxBatcher
from torchbooster_tpu.serving import PagedEngine as JaxEngine
from torchbooster_tpu.serving.frontend import ServingFrontend as JaxFrontend
from torchbooster_tpu.serving.frontend import http as jhttp
from torchbooster_tpu_torch.interop import params_from_jax
from torchbooster_tpu_torch.models.gpt import GPTConfig, generate
from torchbooster_tpu_torch.observability.tracing import RequestTracer
from torchbooster_tpu_torch.serving import ContinuousBatcher, PagedEngine
from torchbooster_tpu_torch.serving.frontend import ServingFrontend, http
from torchbooster_tpu.observability.tracing import (
    RequestTracer as JaxTracer)

_KW = dict(vocab=97, n_layers=2, d_model=32, n_heads=4, seq_len=32,
           n_kv_heads=2)
_ENGINE = dict(page_size=4, n_pages=24, max_slots=4)
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


def _port_batcher(policy=None, tracing=False, **kw):
    _, _, tp, cfg = _model()
    engine = PagedEngine(tp, cfg, compute_dtype=torch.float32,
                         device="cpu", **{**_ENGINE, **kw})
    return ContinuousBatcher(engine, policy=policy,
                             tracer=RequestTracer(enabled=tracing))


def _jax_batcher(policy=None, tracing=False, **kw):
    jp, jcfg, _, _ = _model()
    engine = JaxEngine(jp, jcfg, compute_dtype=jnp.float32,
                       **{**_ENGINE, **kw})
    return JaxBatcher(engine, policy=policy,
                      tracer=JaxTracer(enabled=tracing))


# ---- raw HTTP helpers -----------------------------------------------

async def _exchange(port, raw: bytes) -> bytes:
    """Send raw request bytes; return the whole raw response."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(raw)
    await writer.drain()
    data = await reader.read()
    writer.close()
    return data


def _post(path, payload, rid=None) -> bytes:
    body = json.dumps(payload).encode()
    extra = f"X-Request-Id: {rid}\r\n" if rid else ""
    return (f"POST {path} HTTP/1.1\r\nHost: t\r\n{extra}"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


def _get(path) -> bytes:
    return f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode()


def _mask(raw: bytes) -> bytes:
    return re.sub(rb'"created": \d+', b'"created": 0', raw)


def _split(raw: bytes) -> tuple[int, dict, bytes]:
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    headers = {}
    for line in lines[1:]:
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    return int(lines[0].split(" ")[1]), headers, body


def _sse_tokens(body: bytes) -> list:
    return [t for line in body.split(b"\n")
            if line.startswith(b"data: {")
            for t in json.loads(line[6:])["choices"][0]["token_ids"]]


def _serve(frontend, raws: list, gets: list) -> tuple[list, list, dict]:
    async def scenario():
        await frontend.start()
        out = [await _exchange(frontend.port, raw) for raw in raws]
        got = [await _exchange(frontend.port, _get(p)) for p in gets]
        metrics = await frontend.stop()
        return out, got, metrics

    return asyncio.run(scenario())


# ---- http.py ---------------------------------------------------------

_RAW_REQUESTS = [
    b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n"
    b"\r\n{}",
    b"GET /healthz?full=1 HTTP/1.1\r\nX-Request-Id: a-1\r\n\r\n",
    b"get /metrics HTTP/1.0\r\n\r\n",
    b"",                                                  # clean EOF
    b"POST /v1/completions HTTP/1.1\r\nHost: x",          # torn head
    b"BROKEN\r\n\r\n",
    b"GET / HTTP/2\r\n\r\n",
    b"GET / HTTP/1.1\r\nno colon here\r\n\r\n",
    b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n",
    b"POST / HTTP/1.1\r\nContent-Length: nan\r\n\r\n",
    b"POST / HTTP/1.1\r\nContent-Length: 99999999999\r\n\r\n",
    b"POST / HTTP/1.1\r\nContent-Length: 10\r\n\r\nshort",
    b"GET / HTTP/1.1\r\n" + b"X-Pad: " + b"a" * 17000 + b"\r\n\r\n",
]


def _parse(module, raw: bytes):
    async def go():
        reader = asyncio.StreamReader(limit=1 << 16)
        reader.feed_data(raw)
        reader.feed_eof()
        try:
            req = await module.read_request(reader)
        except module.HttpError as err:
            return ("error", err.status, err.message)
        if req is None:
            return None
        try:
            payload = req.json()
        except module.HttpError as err:
            payload = ("error", err.status, err.message)
        return (req.method, req.path, req.headers, req.body, payload)

    return asyncio.run(go())


def test_http_parser_and_serializers_equal_jax():
    for raw in _RAW_REQUESTS:
        assert _parse(http, raw) == _parse(jhttp, raw), raw[:40]
    err = http.HttpError(429, "busy", {"Retry-After": "0.5"})
    jerr = jhttp.HttpError(429, "busy", {"Retry-After": "0.5"})
    assert http.error_response(err) == jhttp.error_response(jerr)
    for status in (200, 404, 418, 500):
        payload = {"a": [1, 2.5, None, "é"], "status": status}
        assert http.json_response(status, payload, {"X-Request-Id": "r"}) \
            == jhttp.json_response(status, payload, {"X-Request-Id": "r"})
    assert http.text_response(200, "m 1\n") \
        == jhttp.text_response(200, "m 1\n")
    assert http.sse_head({"X-Request-Id": "r"}) \
        == jhttp.sse_head({"X-Request-Id": "r"})
    event = {"id": "cmpl-r", "choices": [{"token_ids": [1, 2]}]}
    assert http.sse_event(event) == jhttp.sse_event(event)
    assert http.SSE_DONE == jhttp.SSE_DONE == b"data: [DONE]\n\n"


# ---- the server ------------------------------------------------------

def test_server_exchanges_equal_jax_and_stream_equals_generate():
    _, _, tp, cfg = _model()
    prompt = [5, 17, 33, 2, 60, 11]
    raws = [
        _post("/v1/completions", {"prompt": prompt, "max_tokens": 8,
                                  "stream": True}, rid="s1"),
        _post("/v1/chat/completions",
              {"messages": [{"role": "user", "content": "5 17 33"},
                            {"role": "user", "content": "2 60"}],
               "max_tokens": 5, "stream": True}, rid="c1"),
        _post("/v1/chat/completions",
              {"messages": [{"role": "user", "content": "4 8 15"}],
               "max_tokens": 4}, rid="c2"),
        _post("/v1/completions", {"prompt": "9 9 1 3", "max_tokens": 6,
                                  "n": 2, "best_of": 3}, rid="b1"),
        (b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
         b"Content-Length: 3\r\n\r\nnop"),
        _post("/v1/completions", {"prompt": "not ids", "max_tokens": 2}),
        _post("/v1/completions", {"prompt": [1, 2], "max_tokens": 2,
                                  "n": 2, "stream": True, "best_of": 3}),
        _get("/nope"),
        _get("/v1/completions"),
        _post("/v1/completions", {"prompt": [1, 2], "max_tokens": 2},
              rid="bad id!"),
    ]
    gets = ["/healthz", "/healthz?full=1", "/debug/engine",
            "/debug/requests", "/debug/trace?id=s1", "/debug/router",
            "/debug/trace", "/metrics"]
    ours = _serve(ServingFrontend(_port_batcher(
        tracing=True, parallel_sampling=True)), raws, gets)
    theirs = _serve(JaxFrontend(_jax_batcher(
        tracing=True, parallel_sampling=True)), raws, gets)
    for i, (a, b) in enumerate(zip(ours[0], theirs[0])):
        assert _mask(a) == _mask(b), (i, a[:300], b[:300])
    status = [_split(r)[0] for r in ours[0]]
    assert status == [200, 200, 200, 200, 400, 400, 400, 404, 405, 400]
    # the streamed completion is the dense generate
    want = generate(tp, torch.as_tensor([prompt]), cfg, n_new=8,
                    temperature=0.0, compute_dtype=torch.float32)
    assert _sse_tokens(_split(ours[0][0])[2]) == want[0, 6:].tolist()
    unary = json.loads(_split(ours[0][3])[2])
    assert [c["index"] for c in unary["choices"]] == [0, 1]
    assert unary["usage"]["completion_tokens"] == 18
    # introspection: the same statuses and keys (values are timings)
    for path, a, b in zip(gets, ours[1], theirs[1]):
        sa, _, ba = _split(a)
        sb, _, bb = _split(b)
        assert sa == sb, path
        if path == "/metrics":
            assert "serving_decode_tokens_total" in ba.decode()
            continue
        da, db = json.loads(ba), json.loads(bb)
        assert set(da) == set(db), path
        if path == "/debug/engine":
            assert set(da["flight"]) == set(db["flight"])
        if path == "/debug/trace?id=s1":
            assert [e["kind"] for e in da["events"]] \
                == [e["kind"] for e in db["events"]]
    assert [_split(r)[0] for r in ours[1]] \
        == [200, 200, 200, 200, 200, 404, 400, 200]
    assert ours[2]["n_requests"] == theirs[2]["n_requests"] == 4


def test_disconnect_mid_decode_reclaims_pages_with_no_new_shape():
    batcher = _port_batcher()
    engine = batcher.engine
    fe = ServingFrontend(batcher)

    async def scenario():
        await fe.start()
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       fe.port)
        writer.write(_post("/v1/completions",
                           {"prompt": [3, 1, 4, 1, 5], "max_tokens": 24,
                            "stream": True}, rid="gone"))
        await writer.drain()
        await reader.readuntil(b"\r\n\r\n")
        seen = 0
        while seen < 3:
            line = await reader.readline()
            seen += line.startswith(b"data: {")
        writer.close()
        for _ in range(400):
            if not batcher.has_work and batcher.inflight == 0:
                break
            await asyncio.sleep(0.01)
        health = _split(await _exchange(fe.port, _get("/healthz")))
        return await fe.stop(), json.loads(health[2])

    metrics, health = asyncio.run(scenario())
    assert metrics["n_cancelled"] == 1
    assert health["pages_free"] == engine.n_pages - 1
    engine.tables.check()
    assert engine.tables.n_free_pages == engine.n_pages - 1
    assert engine.decode_compiles == 1 and engine.prefill_compiles == 1


def test_a_dying_pump_answers_500_and_resurfaces_at_stop(tmp_path):
    """A step that raises ends the pump: the in-flight client gets a
    500, the flight recorder is dumped, and ``stop()`` re-raises the
    step's error after closing the session (JAX ``server.py:212-260``);
    nothing is logged and swallowed."""
    from torchbooster_tpu_torch.serving.frontend import server

    batcher = _port_batcher()

    def broken_step():
        raise RuntimeError("device lost")

    batcher.step = broken_step
    fe = ServingFrontend(batcher, crash_dump_path=str(tmp_path / "crash"))

    async def scenario():
        await fe.start()
        got = await _exchange(fe.port, _post(
            "/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 2}))
        with pytest.raises(RuntimeError, match="device lost"):
            await fe.stop()
        return got

    status, _, body = _split(asyncio.run(scenario()))
    assert status == 500 and "engine failure" in body.decode()
    assert fe.last_flight is not None and not batcher.session_active
    assert (tmp_path / "crash.flight.jsonl").exists()
    if importlib.util.find_spec("uvloop") is None:
        assert server.install_uvloop() is False


def test_slo_policy_answers_429_with_retry_after():
    from torchbooster_tpu_torch.serving.frontend import (SLOPolicy,
                                                         parse_classes)

    pol = SLOPolicy(parse_classes("rt:200:0,batch:0:0"), default="batch")
    batcher = _port_batcher(policy=pol)
    raws = [_post("/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 2}),
            _post("/v1/completions", {"prompt": [4, 5, 6], "max_tokens": 2,
                                      "priority": "rt", "deadline_ms": 1e-6,
                                      "stream": True})]
    out, _, metrics = _serve(ServingFrontend(batcher), raws, [])
    ok, shed = _split(out[0]), _split(out[1])
    assert ok[0] == 200
    assert len(json.loads(ok[2])["choices"][0]["token_ids"]) == 2
    assert shed[0] == 429 and float(shed[1]["retry-after"]) >= 0
    assert "shed" in json.loads(shed[2])["error"]["message"]
    assert metrics["n_shed"] == 1
    batcher.engine.tables.check()
    assert batcher.engine.tables.n_free_pages == batcher.engine.n_pages - 1


def test_capture_path_round_trips(tmp_path):
    from torchbooster_tpu.serving.loadgen import Workload as JaxWorkload
    from torchbooster_tpu_torch.serving.loadgen import Workload

    path = tmp_path / "capture.jsonl"
    fe = ServingFrontend(_port_batcher(), capture_path=str(path))
    raws = [_post("/v1/completions", {"prompt": [7, 8, 9], "max_tokens": 3},
                  rid="k1"),
            _post("/v1/completions", {"prompt": [1, 2, 3, 4],
                                      "max_tokens": 2, "eos_id": 96},
                  rid="k2")]
    _serve(fe, raws, [])
    wl, jwl = Workload.load(path), JaxWorkload.load(path)
    assert wl.fingerprint() == jwl.fingerprint()
    assert [(r.request_id, r.prompt.tolist(), r.max_new_tokens, r.eos_id)
            for r in wl] == [("k1", [7, 8, 9], 3, None),
                             ("k2", [1, 2, 3, 4], 2, 96)]
    again = tmp_path / "again.jsonl"
    wl.save(again)
    assert Workload.load(again).fingerprint() == wl.fingerprint()


def test_frontend_yaml_block_installs_policy_and_router_raises(tmp_path):
    from torchbooster_tpu_torch.config import FrontendConfig, ServingConfig
    from torchbooster_tpu_torch.serving.frontend import (FCFSPolicy,
                                                         SLOPolicy)

    pytest.importorskip("yaml")
    yml = tmp_path / "serve.yml"
    yml.write_text(
        "serving:\n  page_size: 4\n  n_pages: 16\n  max_slots: 2\n"
        "  frontend:\n    policy: slo\n"
        "    classes: \"interactive:250:60,batch:5000:0\"\n"
        "    default_class: batch\n    port: 0\n    max_queue: 8\n")
    sc = ServingConfig.load(yml)
    assert isinstance(sc.frontend, FrontendConfig)
    _, _, tp, cfg = _model()
    batcher = sc.make(tp, cfg, compute_dtype="float32", device="cpu")
    assert isinstance(batcher.policy, SLOPolicy)
    assert batcher.policy.default == "batch"
    assert batcher.policy.classes["interactive"].tpot_ms == 60
    fe = sc.frontend.make(batcher)
    assert isinstance(fe, ServingFrontend) and fe.max_queue == 8
    assert isinstance(FrontendConfig().make_policy(), FCFSPolicy)
    assert isinstance(ServingConfig(page_size=4, n_pages=16).make(
        tp, cfg, compute_dtype="float32", device="cpu").policy, FCFSPolicy)
    with pytest.raises(ValueError, match="fcfs.*or.*slo"):
        FrontendConfig(policy="lifo").make_policy()
    with pytest.raises(ValueError, match="unknown serving.frontend keys"):
        ServingConfig.from_dict({"frontend": {"polcy": "slo"}})
    # the name predates the router's port: a router: block now builds
    # the engine fleet, every replica under the frontend's policy
    from torchbooster_tpu_torch.serving.router import EngineFleet

    fleet = ServingConfig.from_dict({
        "page_size": 4, "n_pages": 16, "max_slots": 2,
        "frontend": {"policy": "slo", "classes": "rt:250:0,batch:0:0"},
        "router": {"n_replicas": 2}}).make(
        tp, cfg, compute_dtype="float32", device="cpu")
    assert isinstance(fleet, EngineFleet) and len(fleet.replicas) == 2
    assert isinstance(fleet.policy, SLOPolicy)
