"""Port parity: the paged serving slice of ``torchbooster_tpu_torch``
against the JAX package on the CPU (2 layers, d_model 32, 4 heads,
vocab 97, 4-token pages, decisive tied head).

- the whole slice: the port's ``ContinuousBatcher.run`` (through
  ``ServingConfig.make``) is greedy token-exact against the JAX
  ``PagedEngine`` on both of its decode backends and against JAX
  ``jit_generate`` — fp32 and int8 pages, GQA and MHA — on both of the
  port's decode backends (the pool sweep, and the kernel wrapper's
  plain version);
- a prefix-shared two-slot case: two live slots share resident prompt
  pages (one work entry, two lanes) and each stream matches;
- ``BlockTables.check()`` holds under randomized churn, and the port's
  tables evolve exactly like the JAX package's under the same ops;
- one decode shape across admit/retire/evict churn; preemption keeps
  every stream token-exact;
- ``ServingConfig`` YAML knobs reach the engine; options not ported yet
  raise, naming the ROADMAP item; structured and LoRA engines build, and
  a plain engine rejects their requests with the JAX package's errors.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models import gpt as jgpt
from torchbooster_tpu.serving import PagedEngine as JaxEngine
from torchbooster_tpu.serving.kv_pages import BlockTables as JaxTables
from torchbooster_tpu_torch.config import ServingConfig
from torchbooster_tpu_torch.serving import (
    BlockTables,
    ContinuousBatcher,
    PagedEngine,
    Request,
)
from tests.test_torch_gpt import _model

PROMPT_LENS = (5, 9, 3)
N_NEW = 7


def _prompts(seed=1):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 97, n).astype(np.int32) for n in PROMPT_LENS]


def _jax_dense(jp, jcfg, prompt, cache_dtype):
    fn = jgpt.jit_generate(jcfg, n_new=N_NEW, temperature=0.0,
                           compute_dtype=jnp.float32,
                           cache_dtype=cache_dtype)
    out = fn(jp, jnp.asarray(prompt)[None], jax.random.PRNGKey(0))
    return np.asarray(out)[0, len(prompt):].tolist()


def _jax_paged(jp, jcfg, prompt, cache_dtype, backend):
    eng = JaxEngine(jp, jcfg, page_size=4, n_pages=16, max_slots=2,
                    cache_dtype=cache_dtype, compute_dtype=jnp.float32,
                    decode_backend=backend)
    slot, first = eng.admit(prompt)
    toks = [first]
    for _ in range(N_NEW - 1):
        assert eng.grow_slots() == []
        toks.append(int(eng.step()[slot]))
    return toks


def _port_run(tp, cfg, prompts, cache_dtype, backend, **kw):
    conf = ServingConfig(page_size=4, n_pages=kw.pop("n_pages", 24),
                         max_slots=kw.pop("max_slots", 3),
                         cache_dtype=cache_dtype or "",
                         decode_backend=backend, **kw)
    batcher = conf.make(tp, cfg, compute_dtype="float32", device="cpu",
                        on_recompile="raise")
    reqs = [Request(prompt=p, max_new_tokens=N_NEW) for p in prompts]
    metrics = batcher.run(reqs)
    batcher.engine.tables.check()
    return batcher, reqs, metrics


@pytest.mark.parametrize("cache_dtype,n_kv_heads", [
    (None, 2), ("int8", 2), ("int8", 0)])
def test_batcher_matches_jax_engines_and_jit_generate(cache_dtype,
                                                      n_kv_heads):
    jp, jcfg, tp, cfg = _model(n_kv_heads)
    prompts = _prompts()
    dense = [_jax_dense(jp, jcfg, p, cache_dtype) for p in prompts]
    # the JAX engine on the first prompt (the paged math is per-slot;
    # the batcher below runs all three together), on both backends
    # except in the MHA case, whose interpret-mode kernel run is the
    # slowest piece of this file
    for backend in ("xla", "pallas") if n_kv_heads else ("xla",):
        assert _jax_paged(jp, jcfg, prompts[0], cache_dtype,
                          backend) == dense[0]
    for backend in ("sweep", "kernel"):
        batcher, reqs, m = _port_run(tp, cfg, prompts, cache_dtype, backend)
        assert [r.tokens for r in reqs] == dense, backend
        assert batcher.engine.decode_compiles == 1
        assert m["n_requests"] == 3 and m["new_tokens"] == 3 * N_NEW


def test_prefix_shared_two_slot_matches_jax():
    jp, jcfg, tp, cfg = _model()
    rs = np.random.RandomState(2)
    shared = rs.randint(0, 97, 8).astype(np.int32)       # 2 full pages
    p_a = np.concatenate([shared, rs.randint(0, 97, 3).astype(np.int32)])
    p_b = np.concatenate([shared, rs.randint(0, 97, 5).astype(np.int32)])
    eng = PagedEngine(tp, cfg, page_size=4, n_pages=16, max_slots=2,
                      compute_dtype=torch.float32, prefix_cache=True,
                      prefill_chunk_pages=1, decode_backend="kernel",
                      device="cpu")
    slot, _ = eng.admit(p_a)                             # registers prefix
    eng.retire(slot)
    slot_a, first_a = eng.admit(p_a)
    slot_b, first_b = eng.admit(p_b)
    assert eng.prefix_hit_pages >= 4
    ka = eng.tables.kernel_args()
    live = ka["work_pages"][ka["work_pages"] != 0]
    assert len(set(live.tolist())) == len(live)
    assert ((ka["work_refs"] >= 0).sum(axis=1) >= 2).any()
    toks_a, toks_b = [first_a], [first_b]
    for _ in range(N_NEW - 1):
        assert eng.grow_slots() == []
        t = eng.step()
        toks_a.append(int(t[slot_a]))
        toks_b.append(int(t[slot_b]))
    assert toks_a == _jax_dense(jp, jcfg, p_a, None)
    assert toks_b == _jax_dense(jp, jcfg, p_b, None)
    eng.retire(slot_a)
    eng.retire(slot_b)
    eng.tables.check()
    assert eng.decode_compiles == 1


def test_block_tables_churn_matches_jax_tables():
    """Randomized seat/activate/advance/grow/retire churn with the
    prefix cache: ``check()`` holds after every op and the port's
    tables stay identical to the JAX package's under the same ops."""
    jcfg = jgpt.GPTConfig(vocab=97, n_layers=1, d_model=8, n_heads=2,
                          seq_len=32)
    _, _, _, cfg = _model()
    port = BlockTables(cfg, 4, 14, 4, prefix_cache=True)
    ref = JaxTables(jcfg, 4, 14, 4, prefix_cache=True)
    rs = np.random.RandomState(0)
    base = rs.randint(0, 5, 12).astype(np.int32)
    for _ in range(300):
        op = rs.randint(4)
        seated = np.flatnonzero(port.lengths > 0)
        if op == 0 and port.free_slot() is not None:
            n = rs.randint(1, 14)
            prompt = base[:n].copy() if rs.rand() < 0.5 \
                else rs.randint(0, 5, n).astype(np.int32)
            slot = port.free_slot()
            try:
                port.seat(slot, prompt)
            except RuntimeError:
                with pytest.raises(RuntimeError):
                    ref.seat(slot, prompt)
                continue
            ref.seat(slot, prompt)
            port.activate(slot, 1)
            ref.activate(slot, 1)
            port.register_prefix(slot, prompt)
            ref.register_prefix(slot, prompt)
        elif op == 1 and seated.size:
            slot = int(rs.choice(seated))
            if port.lengths[slot] < cfg.seq_len - 1 \
                    and port.ensure_write_pages(slot, 1):
                assert ref.ensure_write_pages(slot, 1)
                port.advance(slot, 2)
                ref.advance(slot, 2)
        elif op == 2 and seated.size:
            slot = int(rs.choice(seated))
            port.retire(slot)
            ref.retire(slot)
        port.check()
        for name in ("tables", "lengths", "refcount", "refs", "page_pos",
                     "active", "last_ids"):
            np.testing.assert_array_equal(getattr(port, name),
                                          getattr(ref, name), name)
        ka, kb = port.kernel_args(), ref.kernel_args()
        for key in ka:
            np.testing.assert_array_equal(ka[key], np.asarray(kb[key]))


def test_one_decode_shape_across_churn_and_preemption():
    """Admit/retire/evict churn and pool-pressure preemption leave the
    decode step at ONE operand-shape signature, and every preempted
    stream stays token-exact."""
    jp, jcfg, tp, cfg = _model()
    prompts = _prompts(3) + _prompts(4)
    batcher, reqs, m = _port_run(tp, cfg, prompts, None, "kernel",
                                 n_pages=7, max_slots=3, prefix_cache=True,
                                 prefill_chunk_pages=1)
    assert m["n_preemptions"] >= 1
    assert batcher.engine.decode_compiles == 1
    assert batcher.engine.prefill_compiles == 1
    for r, p in zip(reqs[:3], prompts[:3]):
        assert r.tokens == _jax_dense(jp, jcfg, p, None)


def test_serving_config_yaml_and_unported_options(tmp_path):
    path = tmp_path / "serve.yaml"
    path.write_text("serving:\n  page_size: 4\n  n_pages: 1_6\n"
                    "  max_slots: 2\n  cache_dtype: int8\n"
                    "  decode_backend: sweep\n")
    conf = ServingConfig.load(path)
    assert (conf.page_size, conf.n_pages, conf.cache_dtype) == (4, 16, "int8")
    _, _, tp, cfg = _model()
    batcher = conf.make(tp, cfg, compute_dtype=torch.float32, device="cpu")
    assert isinstance(batcher, ContinuousBatcher)
    assert batcher.engine.quantized
    with pytest.raises(ValueError, match="unknown serving keys"):
        ServingConfig.from_dict({"page_sise": 4})
    # speculative decoding and parallel sampling are ported: they build
    # on the CPU (n = 2 needs the parallel-sampling engine)
    for key in ("speculative", "parallel_sampling"):
        eng = ServingConfig(page_size=4, n_pages=8, draft_len=3,
                            **{key: True}).make(tp, cfg, device="cpu").engine
        assert getattr(eng, key if key == "speculative" else "parallel")
    with pytest.raises(ValueError, match="parallel_sampling"):
        batcher.run([Request(prompt=np.arange(3), max_new_tokens=4, n=2)])
    # tensor-parallel serving is ported (tests/test_torch_tensor_parallel
    # .py): without a tp mesh it raises JAX's error
    with pytest.raises(ValueError, match="needs a committed mesh"):
        PagedEngine(tp, cfg, page_size=4, n_pages=8, tp=2, device="cpu")
    # structured generation and LoRA lanes are ported: they build
    eng = PagedEngine(tp, cfg, page_size=4, n_pages=8, device="cpu",
                      structured=True, lora_rank=2, lora_max_live=1)
    assert eng.structured and eng.lora and eng.adapters is not None
    # the host spill tier and prefill-only engines are ported: they
    # build, with the JAX package's validation; unknown options still
    # raise TypeError
    with pytest.raises(ValueError, match="host_spill=True needs "
                                         "prefix_cache=True"):
        PagedEngine(tp, cfg, page_size=4, n_pages=8, device="cpu",
                    host_spill=True)
    eng = PagedEngine(tp, cfg, page_size=4, n_pages=8, device="cpu",
                      host_spill=True, prefix_cache=True)
    assert eng.host_spill and eng.tables.host_pool is not None
    eng = PagedEngine(tp, cfg, page_size=4, n_pages=8, device="cpu",
                      prefill_only=True)
    with pytest.raises(RuntimeError, match="prefill_only"):
        eng.step()
    with pytest.raises(TypeError, match="unexpected keyword"):
        PagedEngine(tp, cfg, page_size=4, n_pages=8, device="cpu",
                    host_spil=True)
    # on a plain engine both requests fail with the JAX package's errors
    for bad, err in ((dict(adapter="a0"), "engine has no LoRA lanes"),
                     (dict(response_format={"type": "json_object"},
                           eos_id=1),
                      "needs a structured-generation engine")):
        with pytest.raises(ValueError, match=err):
            batcher.run([Request(prompt=np.arange(3), max_new_tokens=4,
                                 **bad)])


def test_serving_config_yaml_draft_and_tree_knobs_reach_the_engine(tmp_path):
    """``draft_len``, ``ngram_min`` and ``spec_tree_width`` of a YAML
    ``serving:`` block reach the engine (``make`` passes all three, as
    the JAX ``make`` does)."""
    path = tmp_path / "serve.yaml"
    path.write_text("serving:\n  page_size: 4\n  n_pages: 16\n"
                    "  speculative: true\n  draft_len: 3\n"
                    "  ngram_min: 1\n  spec_tree: true\n"
                    "  spec_tree_width: 3\n")
    _, _, tp, cfg = _model()
    eng = ServingConfig.load(path).make(tp, cfg, compute_dtype="float32",
                                        device="cpu").engine
    assert eng.draft_len == 3
    assert eng._drafter.ngram_min == 1
    assert eng.tree_width == eng._drafter.width == 3


def _docs_serving_block() -> str:
    """The ``serving:`` YAML block that ``docs/config.md`` documents."""
    from pathlib import Path

    text = (Path(__file__).resolve().parents[1] / "docs" /
            "config.md").read_text()
    section = text.split("### The `serving:` block", 1)[1]
    return section.split("```yaml\n", 1)[1].split("```", 1)[0]


def _seq64_model():
    """A port-only small GPT whose context (64) the documented 64-token
    pages divide."""
    from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = GPTConfig(vocab=97, n_layers=2, d_model=32, n_heads=4, seq_len=64)
    return GPT.init(0, cfg, device="cpu"), cfg


def test_serving_config_docs_block_builds_the_sweep(tmp_path):
    """The documented ``serving:`` block (``decode_backend: xla``, the JAX
    name of the pool sweep) loads and builds, and its engine serves."""
    path = tmp_path / "serve.yaml"
    path.write_text(_docs_serving_block())
    conf = ServingConfig.load(path)
    assert (conf.page_size, conf.n_pages, conf.decode_backend) == (
        64, 256, "xla")
    params, cfg = _seq64_model()
    batcher = conf.make(params, cfg, compute_dtype="float32", device="cpu")
    assert batcher.engine.decode_backend == "sweep"
    req = Request(prompt=np.arange(5), max_new_tokens=2)
    batcher.run([req])
    assert len(req.tokens) == 2


@pytest.mark.parametrize("name,backend", [
    ("xla", "sweep"), ("sweep", "sweep"), ("pallas", "kernel"),
    ("kernel", "kernel"), ("", "sweep")])
def test_serving_config_decode_backend_names(name, backend):
    """The JAX package's names (``xla``, ``pallas``) and the port's own
    (``sweep``, ``kernel``) pick the engine's backend; ``""`` is the
    device default, the sweep on the CPU. Built, not run."""
    params, cfg = _seq64_model()
    batcher = ServingConfig(page_size=4, n_pages=8, max_slots=2,
                            decode_backend=name).make(
        params, cfg, compute_dtype="float32", device="cpu")
    assert batcher.engine.decode_backend == backend


def test_serving_config_unknown_decode_backend_raises():
    params, cfg = _seq64_model()
    with pytest.raises(ValueError, match="'kernel', 'pallas', 'sweep', "
                                         "'xla'.*'triton'"):
        ServingConfig(page_size=4, n_pages=8,
                      decode_backend="triton").make(params, cfg,
                                                    device="cpu")
