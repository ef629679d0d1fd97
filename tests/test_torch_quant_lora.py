"""Port parity: int8/int4 weights (``models/quant.py``) and LoRA lanes
(``serving/adapters.py``, ``_block_core(lora=...)``, the engine's lane
buffers, the batcher's adapter surface) against the JAX package on the
CPU (vocab 97, 2 layers, d_model 32, 4 heads, decisive tied head, fp32).

- ``quantize_params``: int8 and int4 leaves bit-equal to JAX's, from
  fp32 and from bf16 trees, and so is ``weight_stream_bytes``; the int4
  unpack (``dequant_kernel``) bit-equal to JAX's over odd and even input
  rows; the group-size, dtype and re-quantize errors in JAX's words;
- ``params_from_jax`` of a quantized JAX tree equals the port's own
  quantization; int8 and int4 engines give the JAX engine's tokens and
  the port's dense ``generate`` over the same tree; a bf16 engine keeps
  ``qscale`` fp32 and its integer leaves as they were;
- the registry's lane lifetime, rank padding and registration errors;
  lane 0 a bitwise no-op (block outputs and served streams);
- a multi-adapter batch equals the JAX engine request by request with
  lane backpressure, eviction churn, one decode and one lane-writer
  shape; a fork pins its adapter once a branch;
- int8 weights + int8 KV pages + speculative verify (tp 1) equal JAX;
- the YAML ``weights:`` and ``adapters:`` blocks.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models import quant as jq
from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.serving import (ContinuousBatcher as JaxBatcher,
                                      PagedEngine as JaxEngine,
                                      Request as JaxRequest)
from torchbooster_tpu.serving.adapters import random_adapter as jax_adapter
from torchbooster_tpu_torch.config import HostSpillConfig, ServingConfig
from torchbooster_tpu_torch.interop import params_from_jax, to_numpy
from torchbooster_tpu_torch.models import quant as q
from torchbooster_tpu_torch.models.gpt import (GPTConfig, _block_core,
                                               cast_params, generate,
                                               layer_params)
from torchbooster_tpu_torch.serving import (ContinuousBatcher, PagedEngine,
                                            Request, random_adapter)

_KW = dict(vocab=97, n_layers=2, d_model=32, n_heads=4, seq_len=64)
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


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _bit_equal(a: dict, b: dict) -> None:
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k].view(np.uint8),
                                      b[k].view(np.uint8), err_msg=str(k))


def _prompts(n, seed=0, length=6):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 97, length).astype(np.int32) for _ in range(n)]


# ---- quantized formats -------------------------------------------


@pytest.mark.parametrize("wdtype", ["int8", "int4"])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_quantize_params_bit_equal_to_jax(wdtype, pdtype):
    jp, _, tp, _ = _model()
    if pdtype == "bfloat16":
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
        tp = cast_params(tp, torch.bfloat16)
    want = jax.device_get(jq.quantize_params(jp, wdtype, group_size=16))
    got = q.quantize_params(tp, wdtype, group_size=16)
    _bit_equal(to_numpy(got), want)
    assert q.weight_stream_bytes(got) == jq.weight_stream_bytes(want)
    assert q.weights_dtype(got) == jq.weights_dtype(want) == wdtype
    assert q.is_quantized(got) and not q.is_quantized(tp)
    assert q.weights_dtype(tp) == "bf16"


def test_int4_unpack_and_qmatmul_equal_jax():
    """The int4 unpack over odd and even input rows (low and high
    nibbles) is bit-equal to JAX's; ``qmatmul`` is ``x @ dequant`` for
    both formats."""
    jp, _, tp, _ = _model()
    for wdtype in ("int4", "int8"):
        jqp = jq.quantize_params(jp, wdtype, group_size=16)
        pq = q.quantize_params(tp, wdtype, group_size=16)
        leaf = {k: v[0] for k, v in pq["blocks"]["mlp_fc1"].items()
                if k != "bias"}
        jleaf = {k: v[0] for k, v in jqp["blocks"]["mlp_fc1"].items()
                 if k != "bias"}
        rec = q.dequant_kernel(leaf).numpy()
        want = np.asarray(jq.dequant_kernel(jleaf))
        np.testing.assert_array_equal(rec[0::2], want[0::2])
        np.testing.assert_array_equal(rec[1::2], want[1::2])
        x = torch.randn(3, rec.shape[0], generator=torch.Generator()
                        .manual_seed(3))
        np.testing.assert_allclose(q.qmatmul(leaf, x).numpy(),
                                   x.numpy() @ rec, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(dtype="int4", group_size=24),
                                dict(dtype="int4", group_size=3),
                                dict(dtype="fp8"), "requantize"])
def test_quantize_errors_use_jax_wording(kw):
    jp, _, tp, _ = _model()
    if kw == "requantize":
        jp = jq.quantize_params(jp, "int8")
        tp = q.quantize_params(tp, "int8")
        kw = dict(dtype="int8")
    with pytest.raises(ValueError) as jerr:
        jq.quantize_params(jp, **kw)
    with pytest.raises(ValueError) as err:
        q.quantize_params(tp, **kw)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("wdtype", ["int8", "int4"])
def test_quantized_engine_equals_jax_and_dense(wdtype):
    """``params_from_jax`` carries a quantized JAX tree byte for byte
    (it equals the port's own quantization), and the port's engine over
    it gives the JAX engine's greedy tokens and its own dense
    ``generate``'s over the same tree; one decode shape."""
    jp, jcfg, tp, cfg = _model()
    jqp = jax.device_get(jq.quantize_params(jp, wdtype, group_size=16))
    crossed = params_from_jax(jqp, cfg, "cpu")
    _bit_equal(to_numpy(crossed), to_numpy(q.quantize_params(
        tp, wdtype, group_size=16)))
    prompts = _prompts(2, seed=4)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=8) for p in prompts]
    JaxBatcher(JaxEngine(jqp, jcfg, page_size=4, n_pages=32, max_slots=2,
                         compute_dtype=jnp.float32)).run(jreqs)
    eng = PagedEngine(crossed, cfg, page_size=4, n_pages=32, max_slots=2,
                      compute_dtype=torch.float32, device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts]
    ContinuousBatcher(eng, on_recompile="raise").run(reqs)
    for r, jr, p in zip(reqs, jreqs, prompts):
        dense = generate(crossed, torch.as_tensor(p).long()[None], cfg,
                         n_new=8, temperature=0.0,
                         compute_dtype=torch.float32)[0, len(p):].tolist()
        assert r.tokens == list(jr.tokens) == dense
    assert eng.decode_compiles == 1


def test_bf16_engine_keeps_qscale_fp32():
    _, _, tp, cfg = _model()
    for wdtype, qdt in (("int8", torch.int8), ("int4", torch.uint8)):
        eng = PagedEngine(q.quantize_params(tp, wdtype, group_size=16), cfg,
                          page_size=4, n_pages=16, max_slots=2,
                          compute_dtype=torch.bfloat16, device="cpu")
        qkv = eng.params["blocks"]["attn_qkv"]
        assert qkv["qkernel"].dtype == qdt
        assert qkv["qscale"].dtype == torch.float32
        assert qkv["bias"].dtype == torch.bfloat16
        assert eng.params["wte"]["qscale"].dtype == torch.float32
        assert eng.params["wte"]["qtable"].dtype == torch.int8
        slot, first = eng.admit(_prompts(1)[0])
        assert 0 <= first < cfg.vocab


# ---- the adapter registry ----------------------------------------


def _lora_engine(tp, cfg, rank=4, max_live=2, **kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("n_pages", 32)
    kw.setdefault("max_slots", 4)
    return PagedEngine(tp, cfg, lora_rank=rank, lora_max_live=max_live,
                       compute_dtype=torch.float32, device="cpu", **kw)


def test_random_adapter_equals_jax():
    _, jcfg, _, cfg = _model()
    _bit_equal(random_adapter(3, cfg, 4, std=0.5),
               jax_adapter(3, jcfg, 4, std=0.5))


def test_registry_lane_lifetime():
    """Pinned / cached / free lanes: acquire pins, release caches, LRU
    eviction takes the stalest cached lane, all-pinned acquire returns
    None; lane 0 is the unpinned base."""
    _, _, tp, cfg = _model()
    reg = _lora_engine(tp, cfg).adapters
    for i in range(3):
        reg.register(f"a{i}", random_adapter(i + 1, cfg, 4))
    assert reg.acquire("") == 0
    l0, l1 = reg.acquire("a0"), reg.acquire("a1")
    assert sorted((l0, l1)) == [1, 2] and reg.loads == 2
    assert reg.acquire("a2") is None
    assert reg.acquire("a0") == l0 and reg.hits == 1
    reg.release("a0")
    reg.release("a0")
    reg.release("a1")
    assert reg.pinned_count == 0 and reg.resident_count == 2
    assert reg.acquire("a0") == l0 and reg.hits == 2
    reg.release("a0")
    assert reg.acquire("a2") == l1
    assert reg.evictions == 1 and reg.loads == 3
    with pytest.raises(KeyError, match="unknown adapter"):
        reg.acquire("nope")
    with pytest.raises(RuntimeError, match="without a matching"):
        reg.release("a1")
    assert reg.known("") and reg.known("a0") and not reg.known("x")
    assert reg.engine.lora_load_compiles == 1


def test_registry_rank_padding_and_errors():
    _, _, tp, cfg = _model()
    eng = _lora_engine(tp, cfg)
    reg = eng.adapters
    reg.register("small", random_adapter(1, cfg, 2))
    assert reg._host["small"]["a_qkv"].shape[-1] == 4
    assert reg._host["small"]["b_proj"].shape[-2] == 4
    assert reg.acquire("small") == 1
    # the padded rank is zeros in the device lane
    assert not eng._lora_buf["a_qkv"][:, 1, :, 2:].any()
    with pytest.raises(ValueError, match="rank 6 > the engine"):
        reg.register("big", random_adapter(2, cfg, 6))
    bad = random_adapter(3, cfg, 4)
    bad["b_qkv"] = bad["b_qkv"][:, :2, :]
    with pytest.raises(ValueError, match="mixes ranks"):
        reg.register("mixed", bad)
    with pytest.raises(ValueError, match="missing"):
        reg.register("partial", {"a_qkv": bad["a_qkv"]})
    with pytest.raises(ValueError, match="non-empty"):
        reg.register("", random_adapter(4, cfg, 4))
    loads0 = reg.loads
    fresh = random_adapter(5, cfg, 4)
    reg.register("small", fresh)
    assert reg.loads == loads0 + 1 and reg._lane_of["small"] == 1
    np.testing.assert_array_equal(eng._lora_buf["b_proj"][:, 1].numpy(),
                                  fresh["b_proj"])
    with pytest.raises(ValueError, match="both positive|BOTH positive"):
        PagedEngine(tp, cfg, page_size=4, n_pages=8, lora_rank=4,
                    device="cpu")
    with pytest.raises(ValueError, match="adapter_lane"):
        PagedEngine(tp, cfg, page_size=4, n_pages=8,
                    device="cpu").admit_begin(np.arange(3), adapter_lane=1)


def test_lane0_is_a_bitwise_no_op():
    """Lane 0's zero stacks leave a block's output bit for bit, and a
    LoRA engine serving base traffic emits the LoRA-off engine's
    streams."""
    _, _, tp, cfg = _model()
    eng = _lora_engine(tp, cfg)
    eng.adapters.register("a0", random_adapter(1, cfg, 4, std=1.0))
    eng.adapters.acquire("a0")
    bp = layer_params(tp["blocks"], 0)
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    attend = lambda q_, k, v: (q_, None)
    plain = _block_core(bp, x, cfg, attend)[0]
    lanes = torch.zeros(2, dtype=torch.long)
    assert torch.equal(_block_core(bp, x, cfg, attend,
                                   lora=eng._lora_layer(0, lanes))[0], plain)
    assert not torch.equal(_block_core(bp, x, cfg, attend, lora=eng
                                       ._lora_layer(0, lanes + 1))[0], plain)
    prompts = _prompts(3, seed=2)
    off = [Request(prompt=p, max_new_tokens=8) for p in prompts]
    ContinuousBatcher(PagedEngine(tp, cfg, page_size=4, n_pages=32,
                                  max_slots=4, compute_dtype=torch.float32,
                                  device="cpu")).run(off)
    on = [Request(prompt=p, max_new_tokens=8) for p in prompts]
    eng2 = _lora_engine(tp, cfg)
    ContinuousBatcher(eng2).run(on)
    assert [r.tokens for r in on] == [r.tokens for r in off]
    assert eng2.decode_compiles == 1


# ---- engine + batcher LoRA ---------------------------------------


def test_multi_adapter_batch_equals_jax():
    """Base riders and three adapters over two lanes in one trace: every
    stream equals the JAX engine's; adapters steer; the third adapter
    waits on a lane, and later churn evicts; one decode and one writer
    shape; per-adapter metrics equal JAX's; every pin returns."""
    jp, jcfg, tp, cfg = _model()
    prompts = _prompts(5, seed=0)
    mix = ["", "a0", "a1", "", "a2"]
    jeng = JaxEngine(jp, jcfg, page_size=4, n_pages=32, max_slots=4,
                     compute_dtype=jnp.float32, lora_rank=4,
                     lora_max_live=2)
    eng = _lora_engine(tp, cfg)
    for i in range(3):
        jeng.adapters.register(f"a{i}", jax_adapter(i + 1, jcfg, 4, std=1.0))
        eng.adapters.register(f"a{i}", random_adapter(i + 1, cfg, 4,
                                                      std=1.0))
    jreqs = [JaxRequest(prompt=p, max_new_tokens=6, adapter=a)
             for p, a in zip(prompts, mix)]
    reqs = [Request(prompt=p, max_new_tokens=6, adapter=a)
            for p, a in zip(prompts, mix)]
    jm = JaxBatcher(jeng).run(jreqs)
    batcher = ContinuousBatcher(eng, on_recompile="raise")
    m = batcher.run(reqs)
    assert [r.tokens for r in reqs] == [list(r.tokens) for r in jreqs]
    base = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    ContinuousBatcher(PagedEngine(tp, cfg, page_size=4, n_pages=32,
                                  max_slots=4, compute_dtype=torch.float32,
                                  device="cpu")).run(base)
    for r, b in zip(reqs, base):
        assert (r.tokens == b.tokens) == (r.adapter == "")
    for key in ("adapters", "n_adapter_loads", "n_adapter_evictions",
                "n_adapter_hits"):
        assert m[key] == jm[key], key
    for i in range(3):
        batcher.run([Request(prompt=p, max_new_tokens=4, adapter=f"a{i}")
                     for p in prompts[:2]])
    assert eng.adapters.evictions > 0 and eng.adapters.pinned_count == 0
    assert eng.decode_compiles == 1 and eng.lora_load_compiles == 1
    assert any(rec["adapters"] > 0 for rec in batcher.flight.tail(40))
    eng.tables.check()


def test_fork_pins_the_adapter_once_a_branch():
    """An ``n = 2`` adapter request: each branch decodes through the
    parent's lane with its own pin, every pin returns, and the branches
    equal the JAX engine's."""
    jp, jcfg, tp, cfg = _model()
    prompt = _prompts(1, seed=5, length=5)[0]
    kw = dict(prompt=prompt, max_new_tokens=4, n=2, seed=5, adapter="a0")
    jeng = JaxEngine(jp, jcfg, page_size=4, n_pages=32, max_slots=6,
                     compute_dtype=jnp.float32, lora_rank=4,
                     lora_max_live=2, parallel_sampling=True)
    jeng.adapters.register("a0", jax_adapter(1, jcfg, 4, std=1.0))
    jfam = JaxRequest(**kw)
    JaxBatcher(jeng).run([jfam])
    eng = _lora_engine(tp, cfg, parallel_sampling=True, max_slots=6)
    eng.adapters.register("a0", random_adapter(1, cfg, 4, std=1.0))
    fam = Request(**kw)
    m = ContinuousBatcher(eng).run([fam])
    assert m["n_forks"] == 1
    assert [b.tokens for b in fam.branches] \
        == [list(b.tokens) for b in jfam.branches]
    assert eng.adapters.pinned_count == 0
    assert eng.adapters.resident_count == 1
    assert m["adapters"]["a0"]["new_tokens"] == 8
    eng.tables.check()


@pytest.mark.parametrize("case", ["unknown", "no_lanes", "not_str"])
def test_adapter_submit_errors_use_jax_wording(case):
    jp, jcfg, tp, cfg = _model()
    kw = dict(prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=2,
              adapter=3 if case == "not_str" else "ghost")
    lanes = dict(lora_rank=4, lora_max_live=2) if case == "unknown" else {}

    def port():
        ContinuousBatcher(PagedEngine(tp, cfg, page_size=4, n_pages=16,
                                      max_slots=2, device="cpu",
                                      **lanes)).run([Request(**kw)])

    def ref():
        JaxBatcher(JaxEngine(jp, jcfg, page_size=4, n_pages=16,
                             max_slots=2, **lanes)).run([JaxRequest(**kw)])

    errors = []
    for fn in (port, ref):
        with pytest.raises((TypeError, ValueError)) as err:
            fn()
        errors.append((err.type, str(err.value)))
    assert errors[0] == errors[1]


def test_int8_weights_int8_kv_speculative_equals_jax():
    """int8 weights x int8 KV pages x speculative verify at tp 1: the
    port's verify stream equals the JAX engine's, one verify shape."""
    jp, jcfg, tp, cfg = _model()
    rs = np.random.RandomState(5)
    prompt = np.resize(rs.randint(0, 97, 4), 20).astype(np.int32)
    jqp = jq.quantize_params(jp, "int8")
    jeng = JaxEngine(jqp, jcfg, page_size=8, n_pages=16, max_slots=2,
                     cache_dtype="int8", speculative=True, draft_len=3,
                     compute_dtype=jnp.float32)
    eng = PagedEngine(q.quantize_params(tp, "int8"), cfg, page_size=8,
                      n_pages=16, max_slots=2, cache_dtype="int8",
                      speculative=True, draft_len=3,
                      compute_dtype=torch.float32, device="cpu")
    out = []
    for e in (jeng, eng):
        slot, first = e.admit(prompt)
        toks = [first]
        while len(toks) < 10:
            assert e.grow_slots() == []
            toks.extend(int(t) for t in e.spec_step()[slot])
        out.append(toks[:10])
    assert out[0] == out[1]
    assert eng.verify_compiles == 1 and eng.spec_accepted > 0
    eng.tables.check()


def test_weights_adapters_yaml_blocks(tmp_path):
    """``serving.weights``/``serving.adapters`` quantize the tree before
    the engine is built and light the lanes; a bad dtype fails."""
    _, _, tp, cfg = _model()
    path = tmp_path / "s.yml"
    path.write_text("serving:\n  page_size: 4\n  n_pages: 32\n"
                    "  max_slots: 2\n  weights:\n    dtype: int4\n"
                    "    group_size: 16\n"
                    "  adapters:\n    rank: 4\n    max_live: 2\n")
    conf = ServingConfig.load(path)
    assert (conf.weights.dtype, conf.weights.group_size) == ("int4", 16)
    assert (conf.adapters.rank, conf.adapters.max_live) == (4, 2)
    batcher = conf.make(tp, cfg, compute_dtype="float32", device="cpu")
    eng = batcher.engine
    assert q.weights_dtype(eng.params) == "int4"
    assert not q.is_quantized(tp)
    assert eng.lora and eng.adapters.max_live == 2 and eng.lora_rank == 4
    eng.adapters.register("a0", random_adapter(1, cfg, 4, std=1.0))
    req = Request(prompt=np.arange(1, 6), max_new_tokens=3, adapter="a0")
    m = batcher.run([req])
    assert len(req.tokens) == 3 and m["adapters"]["a0"]["n_requests"] == 1
    assert eng.lora_load_compiles == 1
    with pytest.raises(ValueError, match="weights dtype"):
        ServingConfig(page_size=4, n_pages=8).from_dict(
            {"weights": {"dtype": "fp8"}}).make(tp, cfg, device="cpu")
    # the host_spill: block is ported: it resolves into HostSpillConfig
    spill = ServingConfig.from_dict(
        {"prefix_cache": True,
         "host_spill": {"enabled": True, "budget_mb": 8}}).host_spill
    assert isinstance(spill, HostSpillConfig)
    assert (spill.enabled, spill.budget_mb) == (True, 8.0)
