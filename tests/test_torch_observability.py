"""Port parity: the telemetry layer (``torchbooster_tpu_torch/
observability``: spans, export, device, slo, the facade and their config
blocks) against the JAX package on the CPU.

- the same registry operations on the JAX and port registries render
  byte-equal Prometheus text;
- a nested ``span`` closes into events with JAX's keys and values
  (timing aside) and a ``span_seconds`` observation; a disabled
  registry returns the shared no-op; ``utils.instrument_step`` opens
  its span; ``trace`` writes its Chrome trace when the body raises;
- ``MetricsExporter.tick`` writes the JSONL event kinds JAX's writes;
- ``SLOBurnEngine`` fed the same counter history at the same ``now``s
  gives equal ``tick``/``snapshot`` results and alert events;
- ``record_memory_gauges`` without a card returns ``{}`` and sets no
  gauge; ``flop_check`` returns JAX's ratios;
- ``flop_count`` of a 2-layer GPT forward is within 10% of JAX's
  ``xla_flops`` of the same forward;
- ``ObservabilityConfig`` / ``TracingConfig`` / ``SLOBurnConfig`` from
  one YAML mapping have JAX's fields; ``enable`` is idempotent;
- the paged engine emits its seven span names when telemetry is on.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchbooster_tpu import config as jconfig
from torchbooster_tpu import observability as jobs
from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.observability.registry import Registry as JRegistry
from torchbooster_tpu_torch import config as tconfig
from torchbooster_tpu_torch import observability as obs
from torchbooster_tpu_torch.interop import params_from_jax
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
from torchbooster_tpu_torch.observability import spans
from torchbooster_tpu_torch.observability.registry import Registry


@pytest.fixture
def global_obs():
    """Enable the port's process-default registry, restore after."""
    registry = obs.get_registry()
    was = registry.enabled
    registry.reset()
    registry.enabled = True
    yield registry
    registry.enabled = was
    registry.reset()


def _script(reg):
    """One fixed sequence of registry operations, label escapes and a
    histogram included."""
    c = reg.counter("serving_decode_tokens_total", "decoded tokens")
    c.inc(3)
    c.inc(2, cls="rt")
    g = reg.gauge("serving_pages_free", "free KV pages")
    g.set(7)
    g.set(5, device="0")
    h = reg.histogram("span_seconds", "host wall time per span")
    for v in (0.001, 0.004, 0.02, 0.3, 2.5):
        h.observe(v, name="decode_step")
    h.observe(0.01, name='we"ird\\name\n')
    reg.counter("odd.name-total", "help with \\ and\nnewline").inc(1)


def test_prometheus_text_bytes_equal_jax():
    ours, theirs = Registry(enabled=True), JRegistry(enabled=True)
    _script(ours)
    _script(theirs)
    text = obs.prometheus_text(ours)
    assert text == jobs.prometheus_text(theirs)
    assert 'span_seconds_bucket{name="decode_step",le="+Inf"} 5' in text
    assert ours.snapshot() == theirs.snapshot()


def _nested(span_fn, reg, sink_events):
    with span_fn("outer", reg):
        with span_fn("inner", reg):
            pass
    with pytest.raises(ValueError):
        with span_fn("boom", reg):
            raise ValueError("x")
    return [{k: e[k] for k in ("event", "name", "path", "depth", "ph",
                               "cat", "ok")} for e in sink_events]


def test_span_events_match_jax_and_observe_span_seconds():
    ours, theirs = Registry(enabled=True), JRegistry(enabled=True)
    got, want = [], []
    unsub = spans.span_events_subscribe(got.append)
    junsub = jobs.span_events_subscribe(want.append)
    try:
        ev = _nested(obs.span, ours, got)
        jev = _nested(jobs.span, theirs, want)
    finally:
        unsub()
        junsub()
    assert ev == jev
    assert [e["path"] for e in ev] == ["outer/inner", "outer", "boom"]
    assert [e["depth"] for e in ev] == [1, 0, 0]
    assert [e["ok"] for e in ev] == [True, True, False]
    # the full key set and a Chrome-trace-valid event
    assert set(got[0]) == set(want[0])
    assert got[0]["pid"] > 0 and got[0]["dur"] >= 0
    snap = ours.snapshot()
    for name in ("outer", "inner", "boom"):
        assert snap[f"span_seconds{{name={name}}}_count"] == 1.0
    assert spans.current_span_path() == ""


def test_disabled_span_is_the_shared_noop_and_instrument_step(global_obs):
    assert obs.span("x", Registry(enabled=False)) is spans._NOOP
    global_obs.enabled = False
    assert obs.span("x") is spans._NOOP
    global_obs.enabled = True
    from torchbooster_tpu_torch.utils import instrument_step

    seen = []
    step = instrument_step(lambda s: seen.append(spans.current_span_path())
                           or s + 1, name="train_step")
    assert step(1) == 2
    assert seen == ["train_step"]
    snap = global_obs.snapshot()
    assert snap["span_seconds{name=train_step}_count"] == 1.0
    assert snap["steps_total{step=train_step}"] == 1.0


def test_trace_writes_a_chrome_trace_even_when_the_body_raises(tmp_path):
    path = tmp_path / "traces" / "window.json"
    with pytest.raises(ValueError, match="boom"):
        with obs.trace(str(path), annotate="step"):
            with obs.annotate("inner"):
                torch.ones(4) * 2
            raise ValueError("boom")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"step", "inner"} <= names


def test_metrics_exporter_tick_event_kinds_match_jax(tmp_path):
    kinds = {}
    for side, reg_cls, ns in (("port", Registry, obs),
                              ("jax", JRegistry, jobs)):
        reg = reg_cls(enabled=True)
        _script(reg)
        path = tmp_path / f"{side}.jsonl"
        prom = tmp_path / f"{side}.prom"
        ex = ns.MetricsExporter(reg, jsonl_path=path, prom_path=prom,
                                cadence_s=3600)
        with ns.span("exported", reg):
            pass
        ex.tick()
        ex.stop()
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        kinds[side] = [e["event"] for e in lines]
        metric_keys = set(lines[-1]) - {"ts"}
        kinds[side + "_keys"] = metric_keys
        # the exported span's own duration is the one timing field
        kinds[side + "_prom"] = [
            x for x in prom.read_text().splitlines()
            if not x.startswith('span_seconds_sum{name="exported"}')]
    assert kinds["port"] == kinds["jax"] == ["span", "metrics", "metrics"]
    assert kinds["port_keys"] == kinds["jax_keys"]
    assert kinds["port_prom"] == kinds["jax_prom"]


def test_enable_is_idempotent_and_close_stops_the_exporter(tmp_path):
    registry = obs.get_registry()
    was = registry.enabled
    try:
        a = obs.enable(jsonl_path=str(tmp_path / "a.jsonl"), cadence_s=3600)
        b = obs.enable(jsonl_path=str(tmp_path / "b.jsonl"), cadence_s=3600)
        assert a.exporter._thread is None and b.exporter._thread.is_alive()
        b.close()
        assert obs._default_exporter is None and b.exporter._thread is None
    finally:
        registry.enabled = was


def _slo_history(reg, engine, history):
    hit = reg.counter("serving_slo_deadline_hit_total", "hits")
    miss = reg.counter("serving_slo_deadline_miss_total", "misses")
    tok = reg.counter("serving_decode_tokens_total", "decoded tokens")
    out = []
    for now, (h_rt, m_rt, h_b, m_b, toks) in history:
        hit.inc(h_rt, cls="rt", kind="ttft")
        miss.inc(m_rt, cls="rt", kind="ttft")
        hit.inc(h_b, cls="batch", kind="tpot")
        miss.inc(m_b, cls="batch", kind="tpot")
        tok.inc(toks)
        out.append(engine.tick(now=now))
    return out


def test_slo_burn_engine_equals_jax():
    history = [(0.0, (10, 0, 5, 0, 100)), (10.0, (10, 0, 5, 1, 100)),
               (20.0, (2, 8, 5, 0, 10)), (30.0, (1, 9, 5, 0, 10)),
               (40.0, (0, 10, 5, 0, 10)), (50.0, (10, 0, 5, 0, 400)),
               (60.0, (10, 0, 5, 0, 400)), (70.0, (10, 0, 5, 0, 400))]
    kw = dict(target=0.9, fast_window_s=15.0, slow_window_s=40.0,
              fire_burn=2.0, resolve_burn=1.0, goodput_floor_tok_s=5.0)
    got, want = [], []
    reg, jreg = Registry(enabled=True), JRegistry(enabled=True)
    ours = obs.SLOBurnEngine(reg, sink=got.append, **kw)
    theirs = jobs.SLOBurnEngine(jreg, sink=want.append, **kw)
    ticks = _slo_history(reg, ours, history)
    jticks = _slo_history(jreg, theirs, history)
    assert ticks == jticks
    assert ours.snapshot() == theirs.snapshot()
    assert got == want
    assert [e["state"] for e in got].count("firing") >= 1
    assert obs.prometheus_text(reg) == jobs.prometheus_text(jreg)
    with pytest.raises(ValueError, match="target"):
        obs.SLOBurnEngine(reg, target=1.0)


def test_memory_gauges_without_a_card_and_flop_check():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the gauges are real there")
    reg = Registry(enabled=True)
    assert obs.record_memory_gauges(reg) == {}
    assert list(reg.metrics()) == []
    for args in (("x", 100.0, 104.0), ("x", 100.0, 150.0),
                 ("x", 0.0, 5.0), ("x", 100.0, None)):
        assert obs.flop_check(*args) == jobs.flop_check(*args)


def test_flop_count_within_ten_percent_of_xla_flops():
    """XLA's cost analysis counts a ``lax.scan`` body once, whatever its
    trip count, and the JAX forward scans its layers; so JAX's count of
    the 2-layer forward is ``xla_flops`` of the forward plus one more
    block's ``xla_flops`` (the scan body's own block core)."""
    from torchbooster_tpu.models import gpt as jgpt
    from torchbooster_tpu.ops.attention import mha_reference as jax_mha

    kw = dict(vocab=512, n_layers=2, d_model=256, n_heads=4, seq_len=64)
    jcfg = JCfg(**kw)
    jp = JGPT.init(jax.random.PRNGKey(0), jcfg)
    cfg = GPTConfig(**kw)
    tp = params_from_jax(jax.device_get(jp), cfg, "cpu")
    ids = np.random.RandomState(0).randint(0, 512, (2, 64)).astype(np.int32)
    forward = jobs.xla_flops(
        lambda p, x: JGPT.apply(p, x, jcfg, compute_dtype=jnp.float32,
                                remat=False), jp, jnp.asarray(ids))
    block = jobs.xla_flops(
        lambda bp, x: jgpt._block_core(
            bp, x, jcfg,
            lambda q, k, v: (jax_mha(q, k, v, causal=True), None))[0],
        jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]),
        jnp.zeros((2, 64, 256), jnp.float32))
    want = forward + (kw["n_layers"] - 1) * block
    with torch.no_grad():
        got = obs.flop_count(GPT.apply, tp, torch.as_tensor(ids).long(),
                             cfg, compute_dtype=torch.float32, remat=False)
    assert forward and block and got
    assert abs(got / want - 1.0) < 0.10, (got, want)


_YAML_BLOCK = {"enabled": True, "jsonl_path": "logs/t.jsonl",
               "prom_path": "", "cadence_s": "2.5", "on_recompile": "raise",
               "tracing": {"enabled": True, "ring_size": "1_024",
                           "chrome_path": "t.json"},
               "slo": {"enabled": "true", "target": "0.95",
                       "fast_window_s": 30, "goodput_floor_tok_s": "1e2"}}


def test_observability_config_fields_equal_jax():
    ours = tconfig.ObservabilityConfig(**tconfig.resolve_types(
        tconfig.ObservabilityConfig, _YAML_BLOCK))
    theirs = jconfig.ObservabilityConfig(**jconfig.resolve_types(
        jconfig.ObservabilityConfig, _YAML_BLOCK))
    for a, b in ((ours, theirs), (ours.tracing, theirs.tracing),
                 (ours.slo, theirs.slo)):
        assert type(a).__name__ == type(b).__name__
        assert vars(a).keys() == vars(b).keys()
        for key in vars(a):
            if key not in ("tracing", "slo"):
                assert getattr(a, key) == getattr(b, key), key
    tracer = ours.tracing.make()
    assert tracer.enabled and tracer.ring_size == 1024
    engine = ours.slo.make()
    assert isinstance(engine, obs.SLOBurnEngine) and engine.target == 0.95
    assert tconfig.SLOBurnConfig().make() is None
    with pytest.raises(ValueError, match="on_recompile"):
        tconfig.ObservabilityConfig(on_recompile="loud").make()
    registry = obs.get_registry()
    was = registry.enabled
    try:
        registry.enabled = True
        handle = tconfig.ObservabilityConfig(enabled=False).make()
        assert not registry.enabled and handle.exporter is None
        with tconfig.ObservabilityConfig(enabled=True).make() as handle:
            assert registry.enabled and handle.exporter is None
    finally:
        registry.enabled = was


# ---- the engine's seven spans ---------------------------------------

_KW = dict(vocab=97, n_layers=2, d_model=32, n_heads=2, seq_len=64)
_ENGINE_SPANS = {"serving_promote", "serving_prefill_chunk",
                 "serving_fork_cow", "decode_step", "spec_verify_step",
                 "spec_tree_compact", "lora_load"}


def _tokens(engine, prompt, n_new):
    slot, first = engine.admit(prompt)
    toks = [first]
    for _ in range(n_new - 1):
        engine.grow_slots()
        toks.append(int(engine.step()[slot]))
    engine.retire(slot)
    return toks


def test_engine_emits_its_seven_span_names(global_obs):
    from torchbooster_tpu_torch.config import AdaptersConfig, ServingConfig
    from torchbooster_tpu_torch.serving import (PagedEngine, Request,
                                                random_adapter)

    cfg = GPTConfig(**_KW)
    params = GPT.init(0, cfg, device="cpu")
    params["wte"]["table"] *= 4.0
    names = []
    unsub = spans.span_events_subscribe(lambda e: names.append(e["name"]))
    try:
        # prefill chunks, decode steps, a fork's tail copy, a lane load
        b = ServingConfig(page_size=4, n_pages=32, max_slots=4,
                          parallel_sampling=True,
                          adapters=AdaptersConfig(rank=2, max_live=1)).make(
            params, cfg, compute_dtype="float32", device="cpu")
        b.engine.adapters.register("a0", random_adapter(1, cfg, 2))
        rs = np.random.RandomState(0)
        b.run([Request(prompt=rs.randint(0, 97, 6), max_new_tokens=3, n=2),
               Request(prompt=rs.randint(0, 97, 5), max_new_tokens=3,
                       adapter="a0")])
        # a tree-verify step and its compaction
        spec = PagedEngine(params, cfg, page_size=4, n_pages=16, max_slots=2,
                           compute_dtype=torch.float32, device="cpu",
                           speculative=True, draft_len=3, spec_tree=True)
        spec.admit(np.tile(np.int32([3, 5, 7, 9]), 3))
        spec.grow_slots()
        spec.spec_step()
        # a host-tier promotion: demote a prefix by churn, then hit it
        spill = PagedEngine(params, cfg, page_size=4, n_pages=16,
                            max_slots=2, compute_dtype=torch.float32,
                            device="cpu", prefix_cache=True,
                            prefill_chunk_pages=2, host_spill=True,
                            host_spill_mb=4.0)
        probe = rs.randint(0, 97, 18).astype(np.int32)
        _tokens(spill, probe, 2)
        for i in range(20):
            junk = (np.arange(8, dtype=np.int32) % 3) + 1 + (i % 90)
            junk[0] = 1 + i
            _tokens(spill, junk, 2)
        assert spill.tables.n_host_pages >= 4
        _tokens(spill, probe, 2)
        assert spill.promotions > 0
    finally:
        unsub()
    assert _ENGINE_SPANS <= set(names), _ENGINE_SPANS - set(names)
    snap = global_obs.snapshot()
    for name in _ENGINE_SPANS:
        assert snap[f"span_seconds{{name={name}}}_count"] >= 1
