"""Port parity: the dense decode entry points and the serving methods
of ``torchbooster_tpu_torch`` against the JAX package on the CPU, at a
small size (2 layers, d_model 32, 4 heads, vocab 64 or 97).

- ``generate``'s argument checks are JAX's: sampling needs a
  generator, the horizon and the temperature are checked, ``n_new=0``
  returns the prompt (``tests/test_models.py:342``);
- ``jit_generate`` is greedy token-exact against JAX ``jit_generate``
  (MHA and GQA, plain and int8 caches), sampled equal to ``generate``
  from the same generator seed, and ``_cache_size()`` counts the
  shapes it ran (``tests/test_models.py:313``, ``:371``);
- ``BlockTables.slot_pages``, ``ensure_next_page`` and
  ``match_prefix``, ``PagedEngine.can_admit`` and
  ``spec_accept_rate``, the batcher session's ``has_seated``,
  ``layers.dense_init(std=)`` and ``TrainState.replace`` behave as the
  JAX package's on the same operations.

Mesh decode (``generate(mesh=)``) and ``can_admit`` at tp:2 are in
``tests/test_torch_tensor_parallel.py``, whose rank pools they share."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models import gpt as jgpt
from torchbooster_tpu_torch.interop import params_from_jax
from torchbooster_tpu_torch.models import gpt as tgpt
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
from tests.test_torch_gpt import _model

# JAX's jit_generate test model (``tests/test_models.py:378``)
JIT_CFG = dict(vocab=64, n_layers=2, d_model=32, n_heads=2, seq_len=32)


def _jax_twin(cfg_kw: dict, seed: int = 0):
    jcfg = jgpt.GPTConfig(**cfg_kw)
    jp = jgpt.GPT.init(jax.random.PRNGKey(seed), jcfg)
    cfg = GPTConfig(**cfg_kw)
    return jp, jcfg, params_from_jax(jax.device_get(jp), cfg, "cpu"), cfg


# =========================================================================
# generate's checks (C10) and jit_generate
# =========================================================================

def test_generate_sampling_and_checks_match_jax():
    """The twin of JAX's ``test_gpt_generate_sampling``: greedy needs no
    generator; one seed gives one stream, in the vocabulary; a prompt
    past the horizon, sampling without a generator and a negative
    temperature raise; ``n_new=0`` returns the prompt unchanged."""
    cfg = GPTConfig(vocab=50, n_layers=1, d_model=16, n_heads=2, seq_len=16)
    params = GPT.init(0, cfg, device="cpu")
    ids = torch.zeros((1, 3), dtype=torch.long)
    greedy = tgpt.generate(params, ids, cfg, n_new=4, temperature=0.0,
                           compute_dtype=torch.float32)
    assert greedy.shape == (1, 7)

    def sampled(seed: int) -> torch.Tensor:
        return tgpt.generate(params, ids, cfg, n_new=5, temperature=0.8,
                             top_k=5, generator=torch.Generator().manual_seed(
                                 seed), compute_dtype=torch.float32)

    a, b = sampled(7), sampled(7)
    assert torch.equal(a, b) and a.shape == (1, 8)
    assert int(a.max()) < cfg.vocab and torch.equal(a[:, :3], ids)
    with pytest.raises(ValueError, match="exceeds"):
        tgpt.generate(params, ids, cfg, n_new=100, temperature=0.0)
    with pytest.raises(ValueError, match="generator"):
        tgpt.generate(params, ids, cfg, n_new=2, temperature=1.0)
    with pytest.raises(ValueError, match="generator"):
        GPT.jit_generate(cfg, n_new=2)(params, ids)
    with pytest.raises(ValueError, match="temperature"):
        tgpt.generate(params, ids, cfg, n_new=2, temperature=-0.5)
    assert torch.equal(tgpt.generate(params, ids, cfg, n_new=0,
                                     temperature=0.0), ids)


@pytest.mark.parametrize("n_kv_heads", [0, 1], ids=["mha", "gqa"])
@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_jit_generate_matches_jax_jit_generate(n_kv_heads, cache_dtype):
    """Greedy fp32 ``jit_generate`` of the port equals JAX's on the same
    weights (its test model, ``tests/test_models.py:378``, with 2 or 1
    KV heads), plain cache and int8 (``:313``); a second call at a new
    batch of the same shape stays one cached shape."""
    jp, jcfg, tp, cfg = _jax_twin({**JIT_CFG, "n_kv_heads": n_kv_heads})
    ids = np.random.RandomState(1).randint(0, 64, (2, 8)).astype(np.int32)
    want = np.asarray(jgpt.jit_generate(
        jcfg, n_new=6, temperature=0.0, compute_dtype=jnp.float32,
        cache_dtype=cache_dtype)(jp, jnp.asarray(ids), jax.random.PRNGKey(5)))
    fn = tgpt.jit_generate(cfg, n_new=6, temperature=0.0,
                           compute_dtype=torch.float32,
                           cache_dtype=cache_dtype)
    got = fn(tp, torch.as_tensor(ids).long())
    np.testing.assert_array_equal(got.numpy(), want)
    assert fn(tp, torch.as_tensor((ids + 1) % 64).long()).shape == got.shape
    assert fn._cache_size() == 1


def test_jit_generate_sampled_equals_generate_and_counts_shapes():
    """``jit_generate(temperature=0.8, top_k=4)`` draws what ``generate``
    draws from a generator of the same seed (JAX ``:384-394``); a
    repeated shape leaves ``_cache_size()`` as it was, a new prompt
    length adds one; ``GPT.jit_generate`` is the same entry."""
    _, _, tp, cfg = _jax_twin(JIT_CFG)
    ids = torch.as_tensor(np.random.RandomState(1).randint(0, 64, (2, 8)))
    kw = dict(n_new=6, temperature=0.8, top_k=4, compute_dtype=torch.float32)
    want = tgpt.generate(tp, ids, cfg, generator=torch.Generator()
                         .manual_seed(5), **kw)
    fn = GPT.jit_generate(cfg, **kw)
    got = fn(tp, ids, torch.Generator().manual_seed(5))
    assert torch.equal(got, want)
    assert fn._cache_size() == 1
    fn(tp, ids, torch.Generator().manual_seed(6))
    assert fn._cache_size() == 1, "a seen shape counted again"
    fn(tp, ids[:, :5], torch.Generator().manual_seed(5))
    assert fn._cache_size() == 2


# =========================================================================
# the serving methods (C11)
# =========================================================================

def test_block_tables_slot_pages_and_ensure_next_page_match_jax():
    """JAX's randomized seat/advance/retire churn
    (``tests/test_serving.py:273``) on the port's tables and JAX's side
    by side: ``ensure_next_page`` answers alike, and every seated slot's
    ``slot_pages`` are JAX's after every operation."""
    from torchbooster_tpu.serving import BlockTables as JTables
    from torchbooster_tpu_torch.serving import NULL_PAGE, BlockTables

    port = BlockTables(GPTConfig(seq_len=64), page_size=4, n_pages=32,
                       max_slots=4)
    ref = JTables(jgpt.GPTConfig(seq_len=64), page_size=4, n_pages=32,
                  max_slots=4)
    rng = np.random.RandomState(7)
    live: dict = {}
    for _ in range(300):
        roll = rng.rand()
        slot = port.free_slot()
        assert slot == ref.free_slot()
        if roll < 0.35 and slot is not None:
            n = int(rng.randint(1, 12))
            if port.pages_for(n) <= port.n_free_pages:
                prompt = rng.randint(0, 97, n).astype(np.int32)
                first = int(rng.randint(0, 97))
                for t in (port, ref):
                    t.seat(slot, prompt)
                    t.activate(slot, first)
                live[slot] = n
        elif roll < 0.8 and live:
            slot = int(rng.choice(sorted(live)))
            token = int(rng.randint(0, 97))
            if port.lengths[slot] < 64:
                ok = port.ensure_next_page(slot)
                assert ok == ref.ensure_next_page(slot)
                if ok:
                    port.advance(slot, token)
                    ref.advance(slot, token)
        elif live:
            slot = int(rng.choice(sorted(live)))
            port.retire(slot)
            ref.retire(slot)
            del live[slot]
        port.check()
        for s in range(4):
            np.testing.assert_array_equal(port.slot_pages(s),
                                          ref.slot_pages(s))
    for slot in list(live):
        port.retire(slot)
    assert port.n_free_pages == port.n_pages - 1
    assert (port.tables == NULL_PAGE).all()


def _engines(**kw):
    """The JAX ``PagedEngine`` over the decisive model of
    ``tests/test_serving.py:34`` and the port's over the same weights."""
    from torchbooster_tpu.serving import PagedEngine as JEngine
    from torchbooster_tpu_torch.serving import PagedEngine

    jp, jcfg, tp, cfg = _model(2)
    ref = JEngine(jp, jcfg, compute_dtype=jnp.float32, **kw)
    port = PagedEngine(tp, cfg, compute_dtype=torch.float32, device="cpu",
                       **kw)
    return port, ref


def test_match_prefix_after_tail_first_eviction_matches_jax():
    """The twin of JAX's ``test_admit_begin_matched_pages_not_counted_as_
    capacity`` (``tests/test_serving.py:510``): a cached two-page prefix,
    a pool left exactly full, an admission that must stay queued and
    roll back, then one eviction that shrinks the chain from its tail —
    ``match_prefix`` counts what JAX's counts at every point, and
    ``can_admit`` answers as JAX's does."""
    port, ref = _engines(page_size=4, n_pages=5, max_slots=2,
                         prefix_cache=True, prefill_chunk_pages=1)
    rs = np.random.RandomState(4)
    shared = rs.randint(0, 97, 8).astype(np.int32)
    first = np.concatenate([shared, rs.randint(0, 97, 1).astype(np.int32)])
    other = rs.randint(0, 97, 7).astype(np.int32)
    long = np.concatenate([shared, rs.randint(0, 97, 7).astype(np.int32)])
    probe = np.concatenate([shared, rs.randint(0, 97, 1).astype(np.int32)])
    counts = {}
    for name, eng in (("port", port), ("jax", ref)):
        seen = []
        slot, _ = eng.admit(first)
        eng.retire(slot)
        seen += [eng.tables.n_cached_pages, eng.tables.match_prefix(long),
                 eng.can_admit(long)]
        slot_a, _ = eng.admit(other)
        seen += [eng.tables.n_free_pages, eng.can_admit(long),
                 eng.admit_begin(long)]
        eng.tables.check()
        seen.append(eng.tables.n_cached_pages)
        eng.retire(slot_a)
        seen += [eng.tables._evict(1), eng.tables.match_prefix(probe),
                 eng.can_admit(probe)]
        eng.tables.check()
        counts[name] = seen
    assert counts["port"] == counts["jax"]
    assert counts["port"][:2] == [2, 2] and counts["port"][-2] == 1


def test_can_admit_refuses_a_prompt_length():
    port, ref = _engines(page_size=4, n_pages=8, max_slots=1)
    for eng in (port, ref):
        with pytest.raises(TypeError, match="token array"):
            eng.can_admit(5)
        assert eng.can_admit(np.arange(5)) is True
        assert eng.can_admit(np.arange(0)) is False
        assert eng.can_admit(np.arange(40) % 97) is False    # horizon 32


def test_spec_accept_rate_equals_the_batcher_metric():
    """``PagedEngine.spec_accept_rate`` (JAX ``engine.py:2030``) is the
    accepted share of the proposed drafts, the batcher's
    ``spec_accept_rate`` over a session on a fresh engine; a tiled
    prompt gets some drafts accepted."""
    from torchbooster_tpu_torch.config import ServingConfig
    from torchbooster_tpu_torch.serving import Request

    _, _, tp, cfg = _model(2)
    b = ServingConfig(page_size=8, n_pages=16, max_slots=2,
                      speculative=True, draft_len=3).make(
        tp, cfg, compute_dtype="float32", device="cpu")
    eng = b.engine
    assert eng.spec_accept_rate == 0.0
    tiled = np.tile(np.asarray([5, 9, 13, 2], np.int32), 3)
    metrics = b.run([Request(prompt=tiled, max_new_tokens=8),
                     Request(prompt=tiled[:7], max_new_tokens=8)])
    assert eng.spec_proposed > 0 and eng.spec_accepted > 0
    assert eng.spec_accept_rate == eng.spec_accepted / eng.spec_proposed
    assert round(eng.spec_accept_rate, 4) == metrics["spec_accept_rate"]


def test_session_has_seated_follows_its_requests():
    """The batcher session's ``has_seated`` (JAX ``batcher.py:317``) is
    true while a request is seated, filling or decoding, and false once
    every one has finished."""
    from torchbooster_tpu_torch.config import ServingConfig
    from torchbooster_tpu_torch.serving import Request

    _, _, tp, cfg = _model(2)
    b = ServingConfig(page_size=4, n_pages=16, max_slots=2).make(
        tp, cfg, compute_dtype="float32", device="cpu")
    b.start_session()
    assert not b._s.has_seated
    b.submit(Request(prompt=np.arange(1, 7, dtype=np.int32),
                     max_new_tokens=3), arrival=0.0)
    seen = []
    while b.has_work:
        b.step()
        seen.append(b._s.has_seated)
    assert seen[0] and not seen[-1]
    b.finish_session()


def test_dense_init_std_draws_a_normal_kernel():
    """``dense_init(..., std=0.02)`` (JAX ``layers.py:47``): a normal
    kernel whose sample std is within 10% of 0.02 and mean near 0, a
    zero bias; without ``std`` the fan-in uniform kernel of before."""
    from torchbooster_tpu_torch.models import layers as L

    p = L.dense_init(torch.Generator().manual_seed(0), 256, 256, std=0.02)
    k = p["kernel"]
    assert k.shape == (256, 256) and k.dtype == torch.float32
    assert abs(float(k.std()) - 0.02) < 0.002
    assert abs(float(k.mean())) < 0.002 and not p["bias"].any()
    plain = L.dense_init(torch.Generator().manual_seed(0), 256, 256)
    assert float(plain["kernel"].abs().max()) <= 1 / 16
    assert float(plain["kernel"].abs().max()) > 0.06


def test_train_state_replace_keeps_the_other_fields():
    """``TrainState.replace`` (the JAX state's flax ``replace``): a new
    state with the named fields changed, the rest shared, the original
    untouched."""
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.config import OptimizerConfig

    params = {"w": torch.zeros(3)}
    state = utils.TrainState.create(params, OptimizerConfig(
        name="adamw", lr=1e-3).make())
    moved = state.replace(step=5)
    assert moved is not state and moved.step == 5 and state.step == 0
    assert moved.params is state.params
    assert moved.optimizer is state.optimizer
    assert moved.generator is state.generator


@pytest.mark.parametrize("spec, want", [
    ((), ()),
    (("fsdp", "tp"), ("fsdp", None)),
    (("pp", None, "tp"), ("pp", None, None)),
    ((("fsdp", "tp"), "ep"), (None, "ep")),
], ids=["replicated", "fsdp_tp", "pp_tp", "fsdp_with_tp_ep"])
def test_decode_spec_gathers_every_axis_but_tp(spec, want):
    """``sharding.decode_spec``: what mesh decode gathers of a leaf laid
    out by ``spec`` — every sharded dimension but those split over
    ``tp`` (there a rank keeps its Megatron slice, whatever else the
    dimension is split over)."""
    from torchbooster_tpu_torch.parallel.sharding import decode_spec

    assert decode_spec(spec) == want
