"""Port parity: the capture/replay harness (``torchbooster_tpu_torch/
serving/loadgen``: workload, report, replay, the ``loadgen:`` block)
against the JAX package on the CPU.

- ``synthesize`` of every synthetic kind, and one with structured,
  fan-out, tenant and cancel decoration, gives JAX's fingerprint and
  request contents; ``save`` writes JAX's bytes and each side loads the
  other's file; ``from_tracer`` and the ``WorkloadCapture`` of the same
  requests give JAX's workloads;
- ``conformance_report``, ``diff_reports``, ``fingerprints_comparable``
  and ``max_sustainable_speed`` give JAX's results on the same inputs;
- ``replay_inprocess`` of one SLO workload that preempts, sheds and
  cancels (vocab 97, 2 layers, pages of 4, decisive head, fp32, greedy)
  gives the JAX batcher's per-request tokens, shed and cancel flags and
  virtual TTFT/TPOT, and every report field that does not divide by
  wall time; two port replays are identical;
- the batcher's request-trace events equal JAX's, timings aside (the
  ``enqueued`` priority, ``run()``'s ``enqueued`` events, the
  per-request ``prefill_chunk`` and the chunk's slot);
- ``LoadgenConfig.make`` gives JAX's fingerprint and speed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchbooster_tpu import config as jconfig
from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.observability.tracing import (
    RequestTracer as JaxTracer)
from torchbooster_tpu.serving import ContinuousBatcher as JaxBatcher
from torchbooster_tpu.serving import PagedEngine as JaxEngine
from torchbooster_tpu.serving import Request as JaxRequest
from torchbooster_tpu.serving import loadgen as jlg
from torchbooster_tpu.serving.frontend import SLOPolicy as JaxSLO
from torchbooster_tpu.serving.frontend import parse_classes as jparse
from torchbooster_tpu_torch import config as tconfig
from torchbooster_tpu_torch.interop import params_from_jax
from torchbooster_tpu_torch.models.gpt import GPTConfig
from torchbooster_tpu_torch.observability.tracing import RequestTracer
from torchbooster_tpu_torch.serving import (ContinuousBatcher, PagedEngine,
                                            Request)
from torchbooster_tpu_torch.serving import loadgen as lg
from torchbooster_tpu_torch.serving.frontend import SLOPolicy, parse_classes

_KW = dict(vocab=97, n_layers=2, d_model=32, n_heads=4, seq_len=64,
           n_kv_heads=2)
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


def _contents(wl) -> list:
    return [(r.request_id, r.content_key(), r.to_json()) for r in wl]


# ---- the workload format ---------------------------------------------

_SYNTH = [dict(kind=k) for k in lg.SYNTHETIC_KINDS] + [dict(
    kind="poisson", structured_frac=0.5, n_frac=0.3, tenants=3,
    prefix_pages=2, page_size=16, cancel_frac=0.25, classes="rt:2,batch:1",
    adapter_mix="base:1,a0:1")]


@pytest.mark.parametrize("spec", _SYNTH,
                         ids=[s["kind"] + str(len(s)) for s in _SYNTH])
def test_synthesize_fingerprints_and_files_equal_jax(spec, tmp_path):
    kw = dict(spec)
    kind = kw.pop("kind")
    kw = {"n_requests": 12, "seed": 3, "vocab": 300, "rate": 20.0, **kw}
    wl, jwl = lg.synthesize(kind, **kw), jlg.synthesize(kind, **kw)
    assert wl.fingerprint() == jwl.fingerprint()
    assert _contents(wl) == _contents(jwl)
    assert (wl.kind, wl.vocab, wl.meta) == (jwl.kind, jwl.vocab, jwl.meta)
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    wl.save(ours)
    jwl.save(theirs)
    assert ours.read_bytes() == theirs.read_bytes()
    assert lg.Workload.load(theirs).fingerprint() == jwl.fingerprint()
    assert jlg.Workload.load(ours).fingerprint() == wl.fingerprint()


def test_workload_validation_and_tamper_are_loud(tmp_path):
    with pytest.raises(ValueError, match="unknown synthetic"):
        lg.synthesize("uniform")
    with pytest.raises(ValueError, match="duplicate request_id"):
        lg.Workload([lg.WorkloadRequest(0.0, 2, prompt=[1], request_id="a"),
                     lg.WorkloadRequest(0.1, 2, prompt=[2], request_id="a")])
    path = tmp_path / "w.jsonl"
    lg.synthesize("bursty", n_requests=4, vocab=50).save(path)
    path.write_text(path.read_text().replace('"max_new_tokens": ',
                                             '"max_new_tokens": 1', 1))
    with pytest.raises(ValueError, match="fingerprint"):
        lg.Workload.load(path)


def test_capture_and_from_tracer_equal_jax():
    """One capture over the same requests, and the tracer reconstruction
    of the same trace, on both sides."""
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, 97, n).astype(np.int32) for n in (5, 9, 7)]
    out = {}
    for side, req_cls, capture_cls, tracer_cls in (
            ("port", Request, lg.WorkloadCapture, RequestTracer),
            ("jax", JaxRequest, jlg.WorkloadCapture, JaxTracer)):
        reqs = [req_cls(prompt=p, max_new_tokens=4, priority="rt",
                        request_id=f"c{i}") for i, p in enumerate(prompts)]
        cap = capture_cls(scrub=side == "jax")
        tracer = tracer_cls(enabled=True)
        for i, r in enumerate(reqs):
            r.arrival = 0.25 * i
            r.tokens = [1, 2] if i == 1 else [1, 2, 3, 4]
            r.cancelled = i == 1
            r.finished_at = r.arrival + 0.5
            cap.observe(r)
            tracer.emit(r.request_id, "enqueued", prompt_len=r.base_len,
                        priority=r.priority, arrival=r.arrival)
            tracer.emit(r.request_id, "cancelled" if r.cancelled
                        else "retired", n_tokens=len(r.tokens))
        cap.scrub = True
        out[side] = (cap.finalize(vocab=97),
                     (lg if side == "port" else jlg).Workload.from_tracer(
                         tracer, vocab=97))
    for a, b in zip(out["port"], out["jax"]):
        assert a.fingerprint() == b.fingerprint()
        assert _contents(a) == _contents(b)


# ---- reports ---------------------------------------------------------

def _outcomes(rs, n=24):
    out = []
    for i in range(n):
        shed, cancelled = rs.rand() < 0.1, rs.rand() < 0.1
        ttft = None if shed else float(rs.uniform(0.01, 0.5))
        out.append({"request_id": f"o{i}",
                    "cls": ("rt", "batch", "default")[i % 3],
                    "arrival_s": 0.1 * i, "ttft_s": ttft,
                    "tpot_s": None if ttft is None else 0.02,
                    "n_tokens": 0 if shed else int(rs.randint(1, 40)),
                    "shed": shed, "cancelled": cancelled,
                    "errored": i == 5, "deadline_s": 0.2 if i % 3 == 0
                    else None,
                    "deadline_hit": (None if i % 3 or shed
                                     else ttft <= 0.2)})
    return out


def test_reports_equal_jax():
    wl = lg.synthesize("sharegpt", n_requests=8, vocab=97)
    jwl = jlg.synthesize("sharegpt", n_requests=8, vocab=97)
    outs = _outcomes(np.random.RandomState(0))
    kw = dict(speed=2.0, mode="inprocess", elapsed_s=3.25, wall_s=1.5,
              n_preemptions=3)
    rep = lg.conformance_report(wl, outs, **kw)
    assert rep == jlg.conformance_report(jwl, outs, **kw)
    worse = lg.conformance_report(wl, outs[:-6], **{**kw, "wall_s": 3.0})
    assert lg.diff_reports(rep, worse) == jlg.diff_reports(rep, worse)
    assert lg.diff_reports(rep, worse)
    other = {**rep, "workload_fingerprint": "0" * 16}
    assert not lg.fingerprints_comparable(rep, other)
    assert lg.fingerprints_comparable(rep, {"x": 1})
    with pytest.raises(ValueError, match="fingerprints differ"):
        lg.diff_reports(rep, other)

    def run_at(speed):
        return {"n_shed": int(speed > 5.3), "n_errors": 0,
                "deadline_hit_rate": 1.0 if speed < 4.1 else 0.9}

    for lo, hi in ((1.0, 16.0), (6.0, 16.0), (1.0, 3.0)):
        assert lg.max_sustainable_speed(run_at, lo=lo, hi=hi, iters=6) \
            == jlg.max_sustainable_speed(run_at, lo=lo, hi=hi, iters=6)


# ---- in-process replay -----------------------------------------------

def _slo_workload(mod):
    """Six requests that overflow a 7-page pool (preemption), one
    recorded cancel, and a straggler whose 1 ms deadline sheds it."""
    wl = mod.synthesize("poisson", n_requests=6, seed=0, rate=50.0,
                        vocab=97, prompt_len=(6, 8), max_new_tokens=(8, 10),
                        classes="rt:1,batch:1")
    wl.requests[3].cancel_after_tokens = 2
    wl.requests[-1].deadline_ms = 1.0
    return wl


def _port_replay(tracer=None):
    _, _, tp, cfg = _model()
    engine = PagedEngine(tp, cfg, page_size=4, n_pages=8, max_slots=2,
                         compute_dtype=torch.float32, device="cpu")
    b = ContinuousBatcher(engine, policy=SLOPolicy(
        parse_classes("rt:60000:0,batch:0:0"), default="batch"),
        tracer=tracer)
    return lg.replay_inprocess(b, _slo_workload(lg), speed=1.0), engine


def _view(res):
    toks = {r.request_id: list(r.tokens) for r in res.requests}
    flags = {r.request_id: (r.shed, r.cancelled, r.finish_reason)
             for r in res.requests}
    return toks, flags, res.outcomes


_WALL_FIELDS = ("goodput_tok_s", "total_tok_s", "wall_s")


def _report_sans_wall(rep):
    out = {k: v for k, v in rep.items() if k not in _WALL_FIELDS}
    out["classes"] = {c: {k: v for k, v in blk.items()
                          if k not in _WALL_FIELDS}
                      for c, blk in rep["classes"].items()}
    return out


def test_replay_inprocess_equals_jax_with_preempt_shed_cancel():
    jp, jcfg, _, _ = _model()
    jeng = JaxEngine(jp, jcfg, page_size=4, n_pages=8, max_slots=2,
                     compute_dtype=jnp.float32)
    jb = JaxBatcher(jeng, policy=JaxSLO(jparse("rt:60000:0,batch:0:0"),
                                        default="batch"))
    want = jlg.replay_inprocess(jb, _slo_workload(jlg), speed=1.0)
    got, engine = _port_replay()
    again, _ = _port_replay()
    assert _view(got) == _view(again), "two port replays differ"
    toks, flags, outcomes = _view(got)
    jtoks, jflags, joutcomes = _view(want)
    assert toks == jtoks
    assert flags == jflags
    assert outcomes == joutcomes
    assert _report_sans_wall(got.report) == _report_sans_wall(want.report)
    assert got.streams == toks
    assert got.metrics["n_preemptions"] == want.metrics["n_preemptions"] > 0
    assert got.metrics["n_shed"] == 1 and got.metrics["n_cancelled"] == 1
    assert engine.decode_compiles == 1 and engine.prefill_compiles == 1
    engine.tables.check()


def _events(tracer):
    timing = {"ts_us", "dur_s", "ttft_s", "waited_s", "arrival"}
    return [{k: v for k, v in e.items() if k not in timing}
            for e in tracer.events()]


def test_request_trace_events_equal_jax():
    """The port batcher's request-trace events (``/debug/trace``,
    ``Workload.from_tracer``) are JAX's, timings aside: through the
    replay's ``step()`` path and through ``run()``."""
    jp, jcfg, _, _ = _model()
    jeng = JaxEngine(jp, jcfg, page_size=4, n_pages=8, max_slots=2,
                     compute_dtype=jnp.float32)
    jtracer, tracer = JaxTracer(enabled=True), RequestTracer(enabled=True)
    jb = JaxBatcher(jeng, policy=JaxSLO(jparse("rt:60000:0,batch:0:0"),
                                        default="batch"), tracer=jtracer)
    jlg.replay_inprocess(jb, _slo_workload(jlg), speed=1.0)
    _port_replay(tracer)
    assert _events(tracer) == _events(jtracer)
    assert lg.Workload.from_tracer(tracer).fingerprint() \
        == jlg.Workload.from_tracer(jtracer).fingerprint()
    # run(): enqueued events for the whole trace, with the priority
    _, _, tp, cfg = _model()
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 97, n) for n in (6, 9)]
    run_events = []
    for mk in ("port", "jax"):
        t = RequestTracer(enabled=True) if mk == "port" \
            else JaxTracer(enabled=True)
        if mk == "port":
            b = ContinuousBatcher(PagedEngine(
                tp, cfg, page_size=4, n_pages=16, max_slots=2,
                compute_dtype=torch.float32, device="cpu"), tracer=t)
            reqs = [Request(prompt=p, max_new_tokens=3, priority="x",
                            request_id=f"q{i}") for i, p in enumerate(prompts)]
        else:
            b = JaxBatcher(JaxEngine(jp, jcfg, page_size=4, n_pages=16,
                                     max_slots=2, compute_dtype=jnp.float32),
                           tracer=t)
            reqs = [JaxRequest(prompt=p, max_new_tokens=3, priority="x",
                               request_id=f"q{i}")
                    for i, p in enumerate(prompts)]
        b.run(reqs)
        run_events.append(_events(t))
    assert run_events[0] == run_events[1]
    assert run_events[0][0] == {"request_id": "q0", "kind": "enqueued",
                                "prompt_len": 6, "priority": "x"}


def test_loadgen_config_make_equals_jax(tmp_path):
    block = {"source": "poisson", "n_requests": "32",
             "classes": "interactive:3,batch:1", "cancel_frac": 0.125,
             "prompt_len": "64, 512", "max_new_tokens": [16, 32],
             "vocab": 50257, "speed": "2.0"}
    ours = tconfig.LoadgenConfig(**tconfig.resolve_types(
        tconfig.LoadgenConfig, block))
    theirs = jconfig.LoadgenConfig(**jconfig.resolve_types(
        jconfig.LoadgenConfig, block))
    assert vars(ours) == vars(theirs)
    wl, jwl = ours.make(), theirs.make()
    assert wl.fingerprint() == jwl.fingerprint()
    assert wl.meta == jwl.meta and wl.meta["speed"] == 2.0
    path = tmp_path / "w.jsonl"
    jwl.save(path)
    again = tconfig.LoadgenConfig(source=str(path)).make()
    assert again.fingerprint() == jwl.fingerprint()
    with pytest.raises(ValueError, match="synthetic kind"):
        tconfig.LoadgenConfig(source="poisonn").make()
    with pytest.raises(ValueError, match="speed"):
        tconfig.LoadgenConfig(speed=0).make()
