"""Port parity: the GPT model of ``torchbooster_tpu_torch`` against the
JAX package on the CPU, at a small size (2 layers, d_model 32, 4
heads, vocab 97), with parameters crossing through the numpy bridge.

- ``params_from_jax``/``to_numpy`` round trip is byte-exact (fp32 and
  bf16 trees, and an int8 ``(values, scales)`` page pool);
- ``GPT.init`` builds the JAX tree's exact structure and shapes;
- forward logits (MHA/GQA × learned/rope), ``_block_core`` and
  ``_grouped_cache_attention`` (plain/int8, normalized/state) match at
  fp32 tolerance;
- ``_filter_logits`` masks the same positions; greedy picks break ties
  to the lowest id;
- the dense ``generate`` control is token-exact against JAX
  ``jit_generate`` (fp32 and int8 caches);
- entry points default to the card and raise without one.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models import gpt as jgpt
from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.serving.kv_pages import make_pool as jax_make_pool
from torchbooster_tpu_torch.interop import params_from_jax, pool_from_jax, \
    to_numpy
from torchbooster_tpu_torch.models import gpt as tgpt
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig

SMALL = dict(vocab=97, n_layers=2, d_model=32, n_heads=4, seq_len=32)


@functools.lru_cache(maxsize=None)
def _model(n_kv_heads=2, pos="learned", scale=4.0, dtype=jnp.float32):
    """JAX-initialized small GPT (decisive head: tied embeddings x
    ``scale``) and its port twin on the CPU — cached, so callers must
    not mutate either tree."""
    jcfg = JCfg(**SMALL, n_kv_heads=n_kv_heads, pos=pos)
    jp = JGPT.init(jax.random.PRNGKey(0), jcfg, dtype=dtype)
    jp = {**jp, "wte": {"table": jp["wte"]["table"] * scale}}
    cfg = GPTConfig(**SMALL, n_kv_heads=n_kv_heads, pos=pos)
    return jp, jcfg, params_from_jax(jax.device_get(jp), cfg, "cpu"), cfg


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip_byte_exact(dtype):
    jp, _, tp, _ = _model(dtype=dtype)
    back = dict(_leaves(to_numpy(tp)))
    want = dict(_leaves(jax.device_get(jp)))
    assert back.keys() == want.keys()
    for path, a in want.items():
        b = back[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_int8_pool_round_trip_byte_exact():
    jcfg = JCfg(**SMALL, n_kv_heads=2)
    pool = jax_make_pool(jcfg, 4, 6, cache_dtype="int8")
    rs = np.random.RandomState(0)
    pool = {k: (jnp.asarray(rs.randint(-127, 128, v[0].shape), jnp.int8),
                jnp.asarray(rs.rand(*v[1].shape), jnp.bfloat16))
            for k, v in pool.items()}
    port = pool_from_jax(jax.device_get(pool), "cpu")
    assert port["k"][0].dtype == torch.int8
    assert port["k"][1].dtype == torch.bfloat16
    back, want = dict(_leaves(to_numpy(port))), dict(_leaves(
        jax.device_get(pool)))
    for path, a in want.items():
        assert a.dtype == back[path].dtype
        assert a.tobytes() == back[path].tobytes(), path


def test_init_matches_jax_structure():
    for kw in (dict(n_kv_heads=2), dict(pos="rope", mlp="swiglu"),
               dict(tie_embeddings=False)):
        jp = JGPT.init(jax.random.PRNGKey(0), JCfg(**SMALL, **kw))
        tp = GPT.init(0, GPTConfig(**SMALL, **kw), device="cpu")
        want = {p: a.shape for p, a in _leaves(jax.device_get(jp))}
        got = {p: a.shape for p, a in _leaves(to_numpy(tp))}
        assert got == want, kw


@pytest.mark.parametrize("n_kv_heads,pos", [
    (0, "learned"), (2, "learned"), (0, "rope"), (2, "rope")])
def test_forward_logits_match_jax(n_kv_heads, pos):
    jp, jcfg, tp, cfg = _model(n_kv_heads, pos, scale=1.0)
    ids = np.random.RandomState(1).randint(0, 97, (2, 11)).astype(np.int32)
    want = np.asarray(JGPT.apply(jp, jnp.asarray(ids), jcfg,
                                 compute_dtype=jnp.float32, remat=False))
    got = GPT.apply(tp, torch.as_tensor(ids).long(), cfg,
                    compute_dtype=torch.float32, remat=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_block_core_matches_jax():
    jp, jcfg, tp, cfg = _model(2, "rope")
    x = np.random.RandomState(2).randn(2, 7, 32).astype(np.float32)
    from torchbooster_tpu.ops.attention import mha_reference as jax_mha
    from torchbooster_tpu_torch.ops.attention import mha_reference

    jbp = jax.tree_util.tree_map(lambda a: a[1], jp["blocks"])
    want, _, _ = jgpt._block_core(
        jbp, jnp.asarray(x), jcfg,
        lambda q, k, v: (jax_mha(q, k, v, causal=True), None))
    got, _ = tgpt._block_core(
        tgpt.layer_params(tp["blocks"], 1), torch.as_tensor(x), cfg,
        lambda q, k, v: (mha_reference(q, k, v, causal=True), None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("state", [False, True])
def test_grouped_cache_attention_matches_jax(quantized, state):
    rs = np.random.RandomState(3)
    q = rs.randn(2, 3, 4, 8).astype(np.float32)
    ck = rs.randn(2, 9, 2, 8).astype(np.float32)
    cv = rs.randn(2, 9, 2, 8).astype(np.float32)
    vis = (np.arange(9)[None, :] <= np.array([[4], [8]]))
    vis = vis[:, None, None, None, :]
    if quantized:
        jk, jv = jgpt._quantize_kv(jnp.asarray(ck)), jgpt._quantize_kv(
            jnp.asarray(cv))
        tk = pool_from_jax(jax.device_get({"a": jk}), "cpu")["a"]
        tv = pool_from_jax(jax.device_get({"a": jv}), "cpu")["a"]
    else:
        jk, jv = jnp.asarray(ck), jnp.asarray(cv)
        tk, tv = torch.as_tensor(ck), torch.as_tensor(cv)
    want = jgpt._grouped_cache_attention(jnp.asarray(q), jk, jv,
                                         jnp.asarray(vis), state=state)
    got = tgpt._grouped_cache_attention(torch.as_tensor(q), tk, tv,
                                        torch.as_tensor(vis), state=state)
    want = want if state else (want,)
    got = got if state else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_filter_logits_and_pick_match_jax():
    logits = np.random.RandomState(4).randn(3, 97).astype(np.float32)
    for top_k, top_p in ((5, None), (None, 0.7), (8, 0.5)):
        want = np.asarray(jgpt._filter_logits(jnp.asarray(logits), 0.8,
                                              top_k, top_p))
        got = tgpt._filter_logits(torch.as_tensor(logits), 0.8, top_k,
                                  top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        keep = ~np.isinf(want)
        np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
    tie = torch.tensor([[0.0, 2.0, 2.0, 1.0]])
    assert tgpt._make_pick(0.0, None, None)(None, tie).tolist() == [1]


@pytest.mark.parametrize("cache_dtype,n_kv_heads", [(None, 2), ("int8", 0)])
def test_generate_matches_jit_generate(cache_dtype, n_kv_heads):
    jp, jcfg, tp, cfg = _model(n_kv_heads)
    ids = np.random.RandomState(5).randint(0, 97, (2, 6)).astype(np.int32)
    fn = jgpt.jit_generate(jcfg, n_new=8, temperature=0.0,
                           compute_dtype=jnp.float32,
                           cache_dtype=cache_dtype)
    want = np.asarray(fn(jp, jnp.asarray(ids), jax.random.PRNGKey(0)))
    got = tgpt.generate(tp, torch.as_tensor(ids).long(), cfg, n_new=8,
                        temperature=0.0, compute_dtype=torch.float32,
                        cache_dtype=cache_dtype).numpy()
    np.testing.assert_array_equal(got, want)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = GPTConfig(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT.init(0, cfg)
    from torchbooster_tpu_torch.serving import PagedEngine

    params = GPT.init(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedEngine(params, cfg, page_size=4, n_pages=8, max_slots=2)
