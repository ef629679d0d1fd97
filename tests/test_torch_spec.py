"""Port parity: speculative decoding (linear and tree verify) of
``torchbooster_tpu_torch`` against the JAX package on the CPU (2 layers,
d_model 32, 4 heads, vocab 97, 4-token pages, decisive tied head).

- the drafters, ``tree_masks``, ``tree_accept_path`` and
  ``accept_count`` equal the JAX package's on seeded random streams;
- one verify step equals JAX ``make_verify_fn`` on the same pool,
  tables and drafts (linear, tree, int8 pool): ``accept`` and ``token``
  exactly, the written K/V within 1e-6 (int8: scales exactly);
- speculative greedy decode is token-exact against the JAX
  ``PagedEngine(speculative=True)`` and ``jit_generate`` (fp32 GQA on
  both backends with a draft crossing a page boundary; bf16 with int8
  pages, MHA), with one verify shape across accept-length churn;
- tree verify: a rigged side-branch acceptance compacts its K/V rows
  into place and later tokens stay exact; organic ambiguous prompts
  stay exact;
- the batcher's speculative arm cuts a burst at EOS, counts only
  delivered tokens and reserves the write-ahead; the engine validates
  its options and refuses a draft length no B4 route takes.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from torchbooster_tpu.models import gpt as jgpt
from torchbooster_tpu.serving import PagedEngine as JaxEngine
from torchbooster_tpu.serving import speculative as jspec
from torchbooster_tpu_torch.interop import pool_from_jax
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig, _make_spec_pick
from torchbooster_tpu_torch.serving import (
    ContinuousBatcher,
    PagedEngine,
    Request,
)
from torchbooster_tpu_torch.serving import speculative as tspec
from tests.test_torch_gpt import _model

GEOM = dict(page_size=4, n_pages=16, max_slots=2)


def _repetitive(seed, n_base=3, reps=4):
    rs = np.random.RandomState(seed)
    return np.tile(rs.randint(0, 97, n_base).astype(np.int32), reps)


def _dense(jp, jcfg, prompt, n_new, dtype=jnp.float32, cache_dtype=None):
    out = jgpt.jit_generate(jcfg, n_new=n_new, temperature=0.0,
                            compute_dtype=dtype, cache_dtype=cache_dtype)(
        jp, jnp.asarray(prompt)[None], jax.random.PRNGKey(0))
    return np.asarray(out)[0, len(prompt):].tolist()


def _port(tp, cfg, **kw):
    kw = {**GEOM, "compute_dtype": torch.float32, "device": "cpu", **kw}
    return PagedEngine(tp, cfg, **kw)


def _spec_tokens(engine, prompt, n_new, crossings=None):
    """Admit, spec-step until ``n_new`` tokens, retire; ``crossings``
    collects the accepted counts of steps whose accepted tokens crossed
    into a new page."""
    slot, first = engine.admit(prompt)
    toks = [first]
    while len(toks) < n_new:
        assert engine.grow_slots() == []
        length = int(engine.tables.lengths[slot])
        burst = engine.spec_step()[slot]
        if crossings is not None and len(burst) > 1 \
                and (length + len(burst) - 1) // engine.page_size \
                != length // engine.page_size:
            crossings.append(len(burst) - 1)
        toks.extend(burst)
    engine.retire(slot)
    return toks[:n_new]


# ---- host pieces ---------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), draft_len=st.integers(2, 6),
       ngram_min=st.integers(1, 3), n=st.integers(1, 40),
       alphabet=st.integers(2, 6))
def test_drafters_masks_and_accept_paths_match_jax(seed, draft_len,
                                                   ngram_min, n, alphabet):
    rs = np.random.RandomState(seed)
    stream = rs.randint(0, alphabet, n).astype(np.int32)
    width = int(rs.randint(2, draft_len + 1))
    pairs = [(tspec.PromptLookupDrafter(draft_len, ngram_min=ngram_min),
              jspec.PromptLookupDrafter(draft_len, ngram_min=ngram_min)),
             (tspec.TreeLookupDrafter(draft_len, ngram_min=ngram_min,
                                      width=width),
              jspec.TreeLookupDrafter(draft_len, ngram_min=ngram_min,
                                      width=width))]
    for port, ref in pairs:
        port.begin(0, stream[:n // 2])
        ref.begin(0, stream[:n // 2])
        port.observe(0, stream[n // 2:])
        ref.observe(0, stream[n // 2:])
    np.testing.assert_array_equal(pairs[0][0].draft(0), pairs[0][1].draft(0))
    toks, parents = pairs[1][0].draft_tree(0)
    want_toks, want_parents = pairs[1][1].draft_tree(0)
    np.testing.assert_array_equal(toks, want_toks)
    np.testing.assert_array_equal(parents, want_parents)
    rand_parents = np.stack([rs.randint(0, j + 1, 1)[0]
                             for j in range(draft_len)])[None]
    for par in (parents[None], rand_parents):
        for got, want in zip(tspec.tree_masks(par), jspec.tree_masks(par)):
            np.testing.assert_array_equal(got, want)
        row = rs.rand(draft_len) < 0.6
        assert tspec.tree_accept_path(row, par[0]) \
            == jspec.tree_accept_path(row, par[0])
        assert tspec.accept_count(row) == jspec.accept_count(row)


def test_spec_pick_mechanics():
    """Greedy accepts exactly argmax == draft (at the parent node in tree
    form); sampling accepts a near-point mass always and a filtered-out
    draft never, and its fallback never re-emits the rejected token."""
    logits = torch.full((1, 3, 10), -5.0)
    for j, t in enumerate((7, 3, 5)):
        logits[0, j, t] = 5.0
    verify = _make_spec_pick(0.0, None, None)
    accept, token = verify(None, logits, torch.tensor([[7, 9]]))
    assert accept.tolist() == [[True, False]]
    assert token.tolist() == [[7, 3, 5]]
    accept, _ = verify(None, logits, torch.tensor([[7, -1]]))
    assert accept.tolist() == [[True, False]]
    accept, _ = verify(None, logits, torch.tensor([[7, 7]]),
                       parent=torch.tensor([[0, 0]]))
    assert accept.tolist() == [[True, True]]
    logits = torch.zeros((1, 3, 10))
    logits[0, 0, 7] = 50.0
    logits[0, 1, 3], logits[0, 1, 4], logits[0, 1, 9] = 5.0, 4.0, 3.0
    verify = _make_spec_pick(1.0, 2, None)
    gen = torch.Generator().manual_seed(0)
    for _ in range(8):
        accept, token = verify(gen, logits, torch.tensor([[7, 9]]))
        assert accept[0, 0] and not accept[0, 1]
        assert int(token[0, 1]) in (3, 4)
    with pytest.raises(ValueError, match="greedy-only"):
        verify(gen, logits, torch.tensor([[7, 9]]),
               parent=torch.tensor([[0, 0]]))


# ---- one verify step against JAX make_verify_fn -------------------

@pytest.mark.parametrize("mode", ["linear", "tree", "int8"])
def test_verify_step_matches_jax_make_verify_fn(mode):
    """Both engines hold the same two prefilled slots; the port's pool
    is overwritten with the JAX pool, then one verify step runs on the
    same drafts (slot 0 accepts two, slot 1 nothing; in tree form slot 0
    accepts a side branch)."""
    jp, jcfg, tp, cfg = _model()
    cache = "int8" if mode == "int8" else None
    tree = mode == "tree"
    kw = dict(GEOM, cache_dtype=cache, speculative=True, draft_len=3,
              spec_tree=tree)
    jeng = JaxEngine(jp, jcfg, compute_dtype=jnp.float32, **kw)
    peng = _port(tp, cfg, decode_backend="sweep", **kw)
    prompts = [_repetitive(1, reps=2), _repetitive(2, n_base=5, reps=1)]
    truth = [_dense(jp, jcfg, p, 4, cache_dtype=cache) for p in prompts]
    for p in prompts:
        assert jeng.admit(p)[1] == peng.admit(p)[1]
    assert jeng.grow_slots() == [] and peng.grow_slots() == []
    peng.pool = pool_from_jax(jax.device_get(jeng.pool), "cpu")
    t0, t1 = truth
    drafts = np.array([[t0[1], t0[2], (t0[3] + 1) % 97],
                       [(t1[1] + 1) % 97, t1[2], t1[3]]], np.int32)
    parents = np.tile(np.arange(3, dtype=np.int32), (2, 1))
    if tree:
        drafts[0] = [(t0[1] + 1) % 97, t0[1], t0[2]]
        parents[0] = [0, 0, 2]
    jargs = jeng.tables.device_args()
    in_ids = np.concatenate([np.asarray(jargs["last_ids"])[:, None], drafts],
                            axis=1)
    extra = ()
    if tree:
        depth, vis = jspec.tree_masks(parents)
        extra = (jnp.asarray(parents), jnp.asarray(depth), jnp.asarray(vis))
    j_acc, j_tok, j_pk, j_pv = jax.device_get(jeng._verify_jit(
        jeng.params, jeng.pool["k"], jeng.pool["v"], jargs["tables"],
        jargs["lengths"], jargs["refs"], jargs["page_pos"], jargs["active"],
        jnp.asarray(in_ids), jax.random.PRNGKey(0), *extra))
    _, args, work = peng._step_args()
    tree_ops = None
    if tree:
        tree_ops = tuple(torch.as_tensor(a).long()
                         for a in (parents, *tspec.tree_masks(parents)))
    p_acc, p_tok = peng._verify(args["tables"], args["lengths"], args["refs"],
                                args["page_pos"], args["active"],
                                torch.as_tensor(in_ids).long(), work, tree_ops)
    np.testing.assert_array_equal(p_acc.numpy(), np.asarray(j_acc))
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok))
    assert p_acc[0].tolist() == ([False, True, True] if tree
                                 else [True, True, False])
    assert not p_acc[1, 0]
    for name, want in (("k", j_pk), ("v", j_pv)):
        got = peng.pool[name]
        if cache:
            np.testing.assert_array_equal(
                got[1].float().numpy(), np.asarray(want[1], np.float32))
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[0]))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)


# ---- engine-level greedy parity ------------------------------------

@pytest.mark.parametrize("dtype,cache,kv", [
    (jnp.float32, None, 2),
    (jnp.bfloat16, "int8", 0),
    pytest.param(jnp.bfloat16, None, 2, marks=pytest.mark.slow),
    pytest.param(jnp.float32, "int8", 0, marks=pytest.mark.slow),
])
def test_spec_greedy_matches_jax_engine_and_jit_generate(dtype, cache, kv):
    jp, jcfg, tp, cfg = _model(kv)
    prompt = _repetitive(0)
    n_new = 12
    want = _dense(jp, jcfg, prompt, n_new, dtype, cache)
    jeng = JaxEngine(jp, jcfg, **GEOM, cache_dtype=cache, compute_dtype=dtype,
                     speculative=True, draft_len=3)
    assert _spec_tokens(jeng, prompt, n_new) == want
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    backends = ("sweep", "kernel") if dtype == jnp.float32 else ("sweep",)
    for backend in backends:
        eng = _port(tp, cfg, cache_dtype=cache, compute_dtype=tdtype,
                    speculative=True, draft_len=3, decode_backend=backend)
        crossings: list = []
        assert _spec_tokens(eng, prompt, n_new, crossings) == want, backend
        assert eng.spec_accepted > 0
        # a step whose accepted draft crossed into the next page read
        # its write-ahead page back
        assert crossings, "no accepted draft crossed a page boundary"
        assert eng.verify_compiles == 1 and eng.decode_compiles == 0
        eng.tables.check()


def test_one_verify_shape_across_accept_length_churn():
    """Admits/retires with repetitive (multi-token bursts), random (no
    draft) and near-horizon (capped) prompts leave ONE verify shape."""
    _, _, tp, cfg = _model()
    rs = np.random.RandomState(5)
    eng = _port(tp, cfg, n_pages=24, max_slots=3, speculative=True,
                draft_len=3)
    burst_lens = set()
    for _ in range(3):
        prompts = [_repetitive(int(rs.randint(100)), reps=3),
                   rs.randint(0, 97, int(rs.randint(3, 9))).astype(np.int32),
                   _repetitive(int(rs.randint(100)), n_base=2, reps=14)]
        slots = {eng.admit(p)[0] for p in prompts}
        for _ in range(4):
            assert eng.grow_slots() == []
            burst_lens.update(len(v) for v in eng.spec_step().values())
            eng.tables.check()
            for slot in list(slots):
                if eng.tables.lengths[slot] >= cfg.seq_len - 1:
                    eng.retire(slot)
                    slots.discard(slot)
        for slot in slots:
            eng.retire(slot)
        eng.tables.check()
    assert len(burst_lens) > 1
    assert eng.verify_compiles == 1 and eng.decode_compiles == 0


# ---- tree verify ---------------------------------------------------

@pytest.mark.parametrize("backend", ["sweep", "kernel"])
def test_tree_rigged_side_branch_compacts_and_stays_exact(backend):
    """A rigged drafter proposes a wrong primary node and the true
    continuation on a side branch: the verify step accepts the side
    path, compacts its K/V rows into place, and every later token still
    equals ``jit_generate`` (mis-compacted rows would flip later picks)."""
    jp, jcfg, tp, cfg = _model()
    prompt = np.random.RandomState(5).randint(0, 97, 9).astype(np.int32)
    truth = _dense(jp, jcfg, prompt, 15)
    eng = _port(tp, cfg, speculative=True, draft_len=3, spec_tree=True,
                tree_width=2, decode_backend=backend)
    slot, first = eng.admit(prompt)
    out = [first]
    calls = {"n": 0}

    def rigged(_slot):
        calls["n"] += 1
        i = len(out)
        toks = np.full(3, -1, np.int32)
        parents = np.arange(3, dtype=np.int32)
        if calls["n"] in (1, 3) and i + 1 < len(truth):
            toks[:] = [(truth[i] + 1) % 97, truth[i], truth[i + 1]]
            parents[:] = [0, 0, 2]
        return toks, parents

    eng._drafter.draft_tree = rigged
    for _ in range(8):
        assert eng.grow_slots() == []
        out.extend(eng.spec_step()[slot])
    n = min(len(out), len(truth))
    assert out[:n] == truth[:n]
    assert eng.tree_side_accepts == 2
    assert eng.spec_accepted >= 4
    assert eng.verify_compiles == 1
    eng.tables.check()


def test_tree_organic_ambiguous_prompts_match_jax_tree_engine():
    """Ambiguous repetitive prompts draft real trees: the port's tree
    engine equals the JAX tree engine and ``jit_generate``."""
    jp, jcfg, tp, cfg = _model()
    rs = np.random.RandomState(1)
    pat = rs.randint(0, 97, 5).astype(np.int32)
    prompt = np.concatenate([pat, [11], pat, [13], pat, [11], pat]
                            ).astype(np.int32)
    want = _dense(jp, jcfg, prompt, 8)
    kw = dict(GEOM, n_pages=24, speculative=True, draft_len=3,
              spec_tree=True, tree_width=2)
    jeng = JaxEngine(jp, jcfg, compute_dtype=jnp.float32, **kw)
    assert _spec_tokens(jeng, prompt, 8) == want
    eng = _port(tp, cfg, **kw)
    assert _spec_tokens(eng, prompt, 8) == want
    assert eng.spec_accepted > 0
    assert eng.verify_compiles == 1
    eng.tables.check()


# ---- batcher and validation ----------------------------------------

def test_batcher_spec_arm_cuts_bursts_and_counts_delivered_tokens():
    """EOS and ``max_new_tokens`` cut a burst where sequential decode
    would stop; only delivered tokens count; the fit check reserves the
    speculative write-ahead."""
    jp, jcfg, tp, cfg = _model()
    prompt = _repetitive(3)
    truth = _dense(jp, jcfg, prompt, 10)
    eos = truth[6]
    stop_at = truth.index(eos) + 1
    batcher = ContinuousBatcher(_port(tp, cfg, n_pages=24,
                                      speculative=True, draft_len=3),
                                on_recompile="raise")
    reqs = [Request(prompt=prompt, max_new_tokens=10, eos_id=eos),
            Request(prompt=prompt, max_new_tokens=5)]
    m = batcher.run(reqs)
    assert reqs[0].tokens == truth[:stop_at]
    assert reqs[0].finish_reason == "stop"
    assert reqs[1].tokens == truth[:5]
    assert m["new_tokens"] == stop_at + 5
    assert m["n_spec_steps"] > 0
    assert m["n_spec_proposed"] >= m["n_spec_accepted"] > 0
    assert m["spec_mean_accepted"] > 0
    assert 0 < m["spec_accept_rate"] <= 1
    assert any(rec["accept_rate"] > 0 for rec in batcher.flight.tail())
    batcher.engine.tables.check()
    # 12 prompt + 4 output fill the 4 usable pages exactly, but the
    # write-ahead peaks 3 positions later
    tight = ContinuousBatcher(_port(tp, cfg, n_pages=5, max_slots=1,
                                    speculative=True, draft_len=3))
    with pytest.raises(ValueError, match="write-ahead"):
        tight.run([Request(prompt=prompt, max_new_tokens=4)])
    roomy = ContinuousBatcher(_port(tp, cfg, n_pages=6, max_slots=1,
                                    speculative=True, draft_len=3))
    req = Request(prompt=prompt, max_new_tokens=4)
    assert roomy.run([req])["n_preemptions"] == 0
    assert req.tokens == truth[:4]


def test_engine_spec_validation_and_kernel_route_limit():
    _, _, tp, cfg = _model()
    with pytest.raises(ValueError, match="draft_len"):
        _port(tp, cfg, speculative=True, draft_len=4)
    with pytest.raises(ValueError, match="speculative=True"):
        _port(tp, cfg, spec_tree=True)
    with pytest.raises(ValueError, match="greedy"):
        _port(tp, cfg, speculative=True, draft_len=3, spec_tree=True,
              temperature=0.5)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _port(tp, cfg, speculative=True, draft_len=3,
              parallel_sampling=True)
    with pytest.raises(RuntimeError, match="speculative"):
        _port(tp, cfg).spec_step()
    # the kernel backend: S = 1 + draft_len past what both B4 routes take
    # (fp32 plans "simt", which takes S <= 32) raises at construction
    wide = GPTConfig(vocab=97, n_layers=1, d_model=32, n_heads=4,
                     seq_len=128)
    params = GPT.init(0, wide, device="cpu")
    with pytest.raises(ValueError, match="S <= 32"):
        PagedEngine(params, wide, page_size=64, n_pages=4, max_slots=1,
                    compute_dtype=torch.float32, speculative=True,
                    draft_len=32, decode_backend="kernel", device="cpu")
    eng = PagedEngine(params, wide, page_size=64, n_pages=4, max_slots=1,
                      compute_dtype=torch.float32, speculative=True,
                      draft_len=31, decode_backend="kernel", device="cpu")
    assert eng.decode_backend == "kernel"
