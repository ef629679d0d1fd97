"""Port parity: the batcher's SLO telemetry (``torchbooster_tpu_torch/
serving/batcher.py``) against the JAX package on the CPU (vocab 97, 2
layers, d_model 32, 4 heads over 2, pages of 4, decisive tied head,
fp32, greedy).

- the JAX package's own SLO-gauge assertions hold on the port's batcher:
  the per-class shed counter, TTFT histogram and hit-rate gauge of a
  shed trace, and the live per-class TTFT/TPOT quantile gauges (labels
  ``cls`` and ``q=p50|p99``), every TTFT quantile positive;
- one loadgen trace replayed on the virtual clock through a
  ``prefix_cache`` batcher of each package renders the same Prometheus
  text line for line, ``# HELP`` and ``# TYPE`` lines included, under
  ``SLOPolicy("interactive:1000:0,batch:0:0")`` and under FCFS. Sample
  values that are not integers are masked, and so are the buckets and
  sums of ``span_seconds`` (host wall time per span); every integer
  value (counters, token counts, histogram counts) is compared as is;
- an empty session on a batcher with every optional family (prefix
  cache, host spill, structured, LoRA, SLO) registers JAX's ``# HELP``
  and ``# TYPE`` lines, in JAX's order; the train-step instrument's help
  strings equal JAX's.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchbooster_tpu.observability as jobs
import torchbooster_tpu_torch.observability as obs
from torchbooster_tpu.config import LoadgenConfig as JaxLoadgenConfig
from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.observability.export import (
    prometheus_text as jax_prometheus_text)
from torchbooster_tpu.serving import ContinuousBatcher as JaxBatcher
from torchbooster_tpu.serving import PagedEngine as JaxEngine
from torchbooster_tpu.serving.frontend import SLOPolicy as JaxSLOPolicy
from torchbooster_tpu.serving.frontend import parse_classes as jax_classes
from torchbooster_tpu.serving.loadgen import (
    replay_inprocess as jax_replay_inprocess)
from torchbooster_tpu_torch.config import LoadgenConfig
from torchbooster_tpu_torch.interop import params_from_jax
from torchbooster_tpu_torch.models.gpt import GPTConfig
from torchbooster_tpu_torch.observability.export import prometheus_text
from torchbooster_tpu_torch.serving import (
    ContinuousBatcher,
    PagedEngine,
    Request,
)
from torchbooster_tpu_torch.serving.frontend import SLOPolicy, parse_classes
from torchbooster_tpu_torch.serving.loadgen import replay_inprocess

_KW = dict(vocab=97, n_layers=2, d_model=32, n_heads=4, seq_len=64,
           n_kv_heads=2)
_ENGINE = dict(page_size=4, n_pages=24, max_slots=2)
_CLASSES = "interactive:1000:0,batch:0:0"
_LOAD = dict(source="poisson", n_requests=8,
             classes="interactive:3,batch:1", cancel_frac=0.125,
             prompt_len=(4, 12), max_new_tokens=(3, 6), vocab=97)
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


def _port_batcher(policy=None, **kw):
    _, _, tp, cfg = _model()
    return ContinuousBatcher(PagedEngine(
        tp, cfg, compute_dtype=torch.float32, device="cpu",
        **{**_ENGINE, **kw}), policy=policy)


def _jax_batcher(policy=None, **kw):
    jp, jcfg, _, _ = _model()
    return JaxBatcher(JaxEngine(jp, jcfg, compute_dtype=jnp.float32,
                                **{**_ENGINE, **kw}), policy=policy)


@pytest.fixture
def registry():
    """Enable both packages' process-default registries, empty;
    restore after."""
    regs = (obs.get_registry(), jobs.get_registry())
    was = [r.enabled for r in regs]
    for r in regs:
        r.reset()
        r.enabled = True
    yield regs[0]
    for r, w in zip(regs, was):
        r.enabled = w
        r.reset()


def test_jax_slo_gauge_assertions_hold_on_the_port(registry):
    """``tests/test_frontend.py``'s shed trace and ``tests/
    test_tracing.py``'s quantile trace, asserted as JAX asserts them."""
    b = _port_batcher(policy=SLOPolicy(parse_classes("rt:200:50,batch:0:0"),
                                       default="batch"))
    ok = Request(prompt=np.arange(1, 5), max_new_tokens=2)
    doomed = Request(prompt=np.arange(2, 6), max_new_tokens=2,
                     priority="rt", deadline_ms=1e-6)
    m = b.run([ok, doomed])
    prom = prometheus_text(registry)
    assert doomed.shed and doomed.finish_reason == "shed"
    assert not ok.shed and len(ok.tokens) == 2
    assert m["n_shed"] == 1 and m["classes"]["rt"]["n_shed"] == 1
    assert m["classes"]["batch"]["n_completed"] == 1
    assert 'serving_slo_shed_total{cls="rt"} 1' in prom
    assert 'serving_slo_ttft_seconds_count{cls="batch"} 1' in prom
    assert 'serving_slo_ttft_hit_rate{cls="batch"}' in prom
    b.engine.tables.check()

    registry.reset()
    b = _port_batcher(policy=SLOPolicy(parse_classes("rt:5000:0,batch:0:0"),
                                       default="batch"))
    b.run([Request(prompt=np.arange(1, 5), max_new_tokens=4,
                   priority="rt"),
           Request(prompt=np.arange(2, 6), max_new_tokens=4)])
    prom = prometheus_text(registry)
    assert 'serving_slo_ttft_quantile{cls="rt",q="p50"}' in prom
    assert 'serving_slo_ttft_quantile{cls="rt",q="p99"}' in prom
    assert 'serving_slo_ttft_quantile{cls="batch",q="p50"}' in prom
    assert 'serving_slo_tpot_quantile{cls="rt",q="p50"}' in prom
    assert 'serving_slo_tpot_hit_rate{cls="rt"}' in prom
    for line in prom.splitlines():
        if line.startswith("serving_slo_ttft_quantile"):
            assert float(line.rsplit(" ", 1)[1]) > 0.0


_SAMPLE = re.compile(r"^(?P<series>[^ ]+) (?P<value>[^ ]+)$")


def _masked(text: str) -> list[str]:
    """Prometheus text with non-integer sample values, and the buckets
    and sums of the host wall-time spans, replaced by ``<v>``."""
    out = []
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if line.startswith("#") or m is None:
            out.append(line)
            continue
        series, value = m["series"], m["value"]
        wall = series.startswith(("span_seconds_bucket",
                                  "span_seconds_sum"))
        integral = re.fullmatch(r"-?\d+(\.0)?", value) is not None
        out.append(f"{series} <v>" if wall or not integral else line)
    return out


@pytest.mark.parametrize("policy", ["slo", "fcfs"])
def test_prometheus_text_equals_jax_line_for_line(registry, policy):
    """One SLO-policy (or FCFS) trace through a ``prefix_cache`` batcher
    of each package: the masked texts are equal, line for line. Under
    ``slo`` the four per-class gauges are among them, set at completion
    (quantiles) and when the session lands (hit rates)."""
    jax_reg = jobs.get_registry()
    make = (lambda cls, classes: cls(classes(_CLASSES), default="batch")
            ) if policy == "slo" else (lambda cls, classes: None)
    jwl = JaxLoadgenConfig(**_LOAD).make()
    wl = LoadgenConfig(**_LOAD).make()
    assert wl.fingerprint() == jwl.fingerprint()
    jres = jax_replay_inprocess(
        _jax_batcher(make(JaxSLOPolicy, jax_classes), prefix_cache=True),
        jwl)
    res = replay_inprocess(
        _port_batcher(make(SLOPolicy, parse_classes), prefix_cache=True),
        wl)
    assert res.streams == {r.request_id: list(r.tokens)
                           for r in jres.requests}
    jtext, text = jax_prometheus_text(jax_reg), prometheus_text(registry)
    assert _masked(text) == _masked(jtext)
    gauges = ("serving_slo_ttft_hit_rate", "serving_slo_tpot_hit_rate",
              "serving_slo_ttft_quantile", "serving_slo_tpot_quantile")
    for name in gauges:
        assert (f"# TYPE {name} gauge" in text) == (policy == "slo")
    if policy == "slo":
        for cls in ("interactive", "batch"):
            assert f'serving_slo_ttft_hit_rate{{cls="{cls}"}}' in text
            assert f'serving_slo_ttft_quantile{{cls="{cls}",q="p99"}}' \
                in text


def test_train_step_instrument_help_equals_jax():
    from torchbooster_tpu.observability.registry import (
        Registry as JaxRegistry)
    from torchbooster_tpu.utils import instrument_step as jax_instrument
    from torchbooster_tpu_torch.observability.registry import Registry
    from torchbooster_tpu_torch.utils import instrument_step

    reg, jreg = Registry(enabled=True), JaxRegistry(enabled=True)
    instrument_step(lambda: None, registry=reg)()
    jax_instrument(lambda: None, registry=jreg)()
    helps = lambda text: [l for l in text.splitlines()
                          if l.startswith("# HELP")]
    assert helps(prometheus_text(reg)) == helps(jax_prometheus_text(jreg))


def test_help_lines_equal_jax_with_every_batcher_family(registry):
    """An empty session on a batcher with every optional family (prefix
    cache, host spill tier, structured generation, LoRA lanes, an SLO
    policy): the ``# HELP`` and ``# TYPE`` lines equal JAX's."""
    kw = dict(prefix_cache=True, host_spill=True, structured=True,
              lora_rank=2, lora_max_live=1)
    for make, cls, classes in ((_port_batcher, SLOPolicy, parse_classes),
                               (_jax_batcher, JaxSLOPolicy, jax_classes)):
        b = make(cls(classes(_CLASSES), default="batch"), **kw)
        b.start_session()
        b.finish_session()
    heads = lambda text: [l for l in text.splitlines() if l.startswith("#")]
    jtext = jax_prometheus_text(jobs.get_registry())
    assert heads(prometheus_text(registry)) == heads(jtext)
    assert "# HELP serving_adapter_tokens_total" in jtext
