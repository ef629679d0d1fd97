"""Port parity: copy-on-write parallel sampling (OpenAI ``n``/
``best_of``) of ``torchbooster_tpu_torch`` against the JAX package on the
CPU (2 layers, d_model 32, 4 heads, vocab 97, 4-token pages, decisive
tied head).

- ``BlockTables.fork`` and ``rewind`` evolve exactly like the JAX
  package's under the same randomized operation sequence (tables,
  refcounts, refs lanes, ``cow_len``), ``check()`` holding throughout,
  and a fork that runs out of pages rolls back as JAX's does;
- engine fork, greedy: every branch equals the JAX engine's fork and
  ``jit_generate``, with one decode shape across fork churn;
- seeded sampling: each branch of an n = 2 request is token-exact
  against the port's own independent run admitted with ``(seed,
  branch=b)``, and the first token's logprob counts once;
- the batcher: ``best_of`` ranking by cumulative logprob, family
  cancel, and a fork under pool pressure that preempts (never its own
  family) and retries.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models import gpt as jgpt
from torchbooster_tpu.serving import PagedEngine as JaxEngine
from torchbooster_tpu.serving.kv_pages import BlockTables as JaxTables
from torchbooster_tpu_torch.serving import (
    BlockTables,
    ContinuousBatcher,
    PagedEngine,
    PoolExhausted,
    Request,
    best_completions,
)
from tests.test_torch_gpt import _model

TABLE_FIELDS = ("tables", "lengths", "refcount", "refs", "page_pos",
                "active", "last_ids", "cow_len", "prompt_len")


def _port(tp, cfg, **kw):
    kw = {"page_size": 4, "n_pages": 32, "max_slots": 6,
          "compute_dtype": torch.float32, "device": "cpu",
          "parallel_sampling": True, **kw}
    return PagedEngine(tp, cfg, **kw)


def _same_tables(port, ref):
    port.check()
    for name in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), name)


def test_block_tables_fork_and_rewind_match_jax_tables():
    """Randomized seat/fork/advance/rewind/retire with the prefix cache
    and fork sharing on: both tables take the same ops and stay equal."""
    jcfg = jgpt.GPTConfig(vocab=97, n_layers=1, d_model=8, n_heads=2,
                          seq_len=32)
    _, _, _, cfg = _model()
    port = BlockTables(cfg, 4, 40, 8, prefix_cache=True, parallel=True)
    ref = JaxTables(jcfg, 4, 40, 8, prefix_cache=True, parallel=True)
    rs = np.random.RandomState(0)
    saw = {"fork": 0, "rewind": 0, "exhausted": 0}
    for _ in range(400):
        op = rs.randint(5)
        seated = np.flatnonzero(port.active)
        if op == 0 and port.free_slot() is not None:
            prompt = rs.randint(0, 5, rs.randint(1, 14)).astype(np.int32)
            slot = port.free_slot()
            try:
                port.seat(slot, prompt)
            except RuntimeError:
                with pytest.raises(RuntimeError):
                    ref.seat(slot, prompt)
                continue
            ref.seat(slot, prompt)
            for t in (port, ref):
                t.activate(slot, 1)
                t.register_prefix(slot, prompt)
        elif op == 1 and seated.size:
            parent, k = int(rs.choice(seated)), int(rs.randint(1, 4))
            try:
                kids = port.fork(parent, k)
            except PoolExhausted:
                with pytest.raises(RuntimeError):
                    ref.fork(parent, k)
                saw["exhausted"] += 1
                continue
            assert ref.fork(parent, k) == kids
            saw["fork"] += 1
            for t in (port, ref):
                for c in kids:
                    t.activate(c, 2)
        elif op == 2 and seated.size:
            slot = int(rs.choice(seated))
            room = cfg.seq_len - int(port.lengths[slot])
            n = min(int(rs.randint(1, 5)), room)
            if n > 0 and port.ensure_write_pages(slot, n):
                assert ref.ensure_write_pages(slot, n)
                for t in (port, ref):
                    for _ in range(n):
                        t.advance(slot, 3)
        elif op == 3 and seated.size:
            slot = int(rs.choice(seated))
            floor = max(int(port.prompt_len[slot]), int(port.cow_len[slot]))
            target = int(rs.randint(floor - 1, int(port.lengths[slot]) + 1))
            if target < floor:
                for t in (port, ref):
                    with pytest.raises(ValueError, match="rewind target"):
                        t.rewind(slot, target, last_id=4)
            else:
                for t in (port, ref):
                    t.rewind(slot, target, last_id=4)
                saw["rewind"] += 1
        elif op == 4 and seated.size:
            slot = int(rs.choice(seated))
            port.retire(slot)
            ref.retire(slot)
        _same_tables(port, ref)
    assert all(saw.values()), saw


def test_fork_rolls_back_on_exhaustion_and_needs_lanes():
    _, _, _, cfg = _model()
    jcfg = jgpt.GPTConfig(vocab=97, n_layers=1, d_model=8, n_heads=2,
                          seq_len=32)
    cold = BlockTables(cfg, 4, 8, 4)
    cold.seat(0, np.arange(1, 6, dtype=np.int32))
    cold.activate(0, 9)
    with pytest.raises(RuntimeError, match="parallel=True"):
        cold.fork(0, 1)
    port = BlockTables(cfg, 4, 6, 6, parallel=True)    # 5 usable pages
    ref = JaxTables(jcfg, 4, 6, 6, parallel=True)
    for t in (port, ref):
        t.seat(0, np.arange(1, 11, dtype=np.int32))    # 3 pages
        t.activate(0, 9)
    with pytest.raises(PoolExhausted):
        port.fork(0, 3)                                # needs 3 tail pages
    with pytest.raises(RuntimeError):
        ref.fork(0, 3)
    _same_tables(port, ref)
    assert port.n_free_pages == 2 and not port.lengths[1]


def test_engine_fork_greedy_matches_jax_fork_and_jit_generate():
    """Every greedy branch of a 3-way fork equals the JAX engine's
    branches and ``jit_generate``; page sharing and tail copies count as
    JAX's do; fork churn leaves one decode shape."""
    jp, jcfg, tp, cfg = _model()
    prompt = np.random.RandomState(1).randint(0, 97, 6).astype(np.int32)
    want = np.asarray(jgpt.jit_generate(
        jcfg, n_new=6, temperature=0.0, compute_dtype=jnp.float32)(
        jp, jnp.asarray(prompt)[None], jax.random.PRNGKey(0)))[0, 6:].tolist()

    def streams(eng, fork_toks):
        slot, first = eng.admit(prompt, seed=3)
        branches = eng.fork(slot, 3)
        assert branches[0][:2] == (slot, first)
        out = {s: [int(tok)] for s, tok, _ in branches}
        fork_toks.append([tok for _, tok, _ in branches])
        for _ in range(5):
            assert eng.grow_slots() == []
            toks = eng.step()
            for s in out:
                out[s].append(int(toks[s]))
        return out

    jeng = JaxEngine(jp, jcfg, page_size=4, n_pages=32, max_slots=6,
                     compute_dtype=jnp.float32, parallel_sampling=True)
    jfirst: list = []
    for stream in streams(jeng, jfirst).values():
        assert stream == want
    eng = _port(tp, cfg)
    pfirst: list = []
    for _ in range(2):                         # fork churn rounds
        out = streams(eng, pfirst)
        assert list(out.values()) == [want] * 3
        eng.tables.check()
        for s in out:
            eng.retire(s)
    assert pfirst[0] == jfirst[0]
    assert (eng.forks, eng.fork_pages, eng.cow_copies) == (
        2, 2 * jeng.fork_pages, 2 * jeng.cow_copies)
    assert eng.fork_pages == 4 and eng.cow_copies == 4
    assert eng.decode_compiles == 1
    eng.tables.check()
    assert eng.tables.n_free_pages == eng.n_pages - 1


def test_seeded_n2_branches_equal_independent_runs_and_logprobs():
    """Seeded n = 2 sampling: each branch equals the port's own run
    admitted alone with ``(seed, branch=b)``; the branches diverge; the
    first token's logprob counts once (branch 0 equals a plain n = 1
    run with the same seed, tokens and cumulative logprob)."""
    _, _, tp, cfg = _model()
    prompt = np.arange(1, 7, dtype=np.int32)

    def run(req):
        ContinuousBatcher(_port(tp, cfg, temperature=0.8, top_k=20,
                                n_pages=24, max_slots=4)).run([req])
        return req

    fam = run(Request(prompt=prompt, max_new_tokens=6, n=2, seed=17,
                      request_id="p"))
    assert [r.branch for r in fam.branches] == [0, 1]
    assert fam.branches[0].tokens != fam.branches[1].tokens
    for b in range(2):
        ind = Request(prompt=prompt, max_new_tokens=6, seed=17)
        ind.branch = b
        run(ind)
        assert ind.tokens == fam.branches[b].tokens
        assert abs(ind.cum_logprob - fam.branches[b].cum_logprob) < 1e-5
    assert fam.branches[0].cum_logprob < 0.0


def test_batcher_best_of_ranking_metrics_and_family_cancel():
    _, _, tp, cfg = _model()
    eng = _port(tp, cfg, temperature=0.7, top_k=30)
    batcher = ContinuousBatcher(eng)
    req = Request(prompt=np.arange(1, 11, dtype=np.int32), max_new_tokens=4,
                  n=2, best_of=3, seed=1, request_id="fam")
    m = batcher.run([req])
    assert [r.request_id for r in req.branches] == ["fam", "fam#1", "fam#2"]
    assert all(len(r.tokens) == 4 for r in req.branches)
    best = best_completions(req)
    assert len(best) == 2
    ranked = sorted(r.cum_logprob for r in req.branches)[::-1][:2]
    assert [r.cum_logprob for r in best] == ranked
    # 10 prompt tokens on 4-token pages: 2 full pages shared a child
    assert (m["n_forks"], m["fork_pages"], m["n_cow_copies"]) == (1, 4, 2)
    assert any(rec["branches"] == 2 for rec in batcher.flight.tail())
    assert eng.decode_compiles == 1
    # cancelling the request cancels its whole family
    batcher.start_session()
    req = Request(prompt=np.arange(1, 10, dtype=np.int32),
                  max_new_tokens=20, n=3, seed=2)
    batcher.submit(req)
    for _ in range(4):
        batcher.step()
    assert req.branches is not None and len(req.branches) == 3
    batcher.cancel(req)
    batcher.step()
    m = batcher.finish_session()
    assert m["n_cancelled"] == 3
    assert all(r.cancelled for r in req.branches)
    eng.tables.check()
    assert eng.tables.n_free_pages == eng.n_pages - 1
    with pytest.raises(ValueError, match="parallel_sampling"):
        ContinuousBatcher(_port(tp, cfg, parallel_sampling=False)).run(
            [Request(prompt=np.arange(1, 5), max_new_tokens=2, n=2)])


def test_fork_under_pool_pressure_preempts_and_retries():
    """A fork whose sibling tail pages cannot allocate preempts a policy
    victim (never its own family) and retries; the family still equals
    the ample-pool run and the victim still finishes."""
    _, _, tp, cfg = _model()
    rs = np.random.RandomState(2)
    prompt = rs.randint(0, 97, 6).astype(np.int32)
    ref = Request(prompt=prompt, max_new_tokens=4, n=3, seed=9)
    ContinuousBatcher(_port(tp, cfg)).run([ref])
    eng = _port(tp, cfg, n_pages=8, max_slots=5)      # 7 usable pages
    filler = Request(prompt=rs.randint(0, 97, 10).astype(np.int32),
                     max_new_tokens=8, arrival=0.0)
    fam = Request(prompt=prompt, max_new_tokens=4, n=3, seed=9, arrival=0.01)
    m = ContinuousBatcher(eng).run([filler, fam])
    assert m["n_preemptions"] > 0 and m["n_forks"] == 1
    assert [r.tokens for r in fam.branches] == \
        [r.tokens for r in ref.branches]
    assert len(filler.tokens) == 8
    eng.tables.check()
