"""Port parity: the host spill tier (``serving/kv_pages.py``
``HostPagePool``, demoting eviction, ``match_tiered``, ``promote_keys``;
``serving/engine.py`` ``_spill_fetch``, the promotion write,
``issue_promotions``, the tiered ``admit_begin``; ``comms/accounting.py``;
the ``host_spill:`` block) against the JAX package on the CPU (vocab 97,
2 layers, d_model 32, 4 heads over 2 KV heads, decisive tied head, fp32).

- ``HostPagePool``: the same scripted put/pop/get sequences give the
  same evictions, counters and residency as JAX's pool;
- ``BlockTables``: demote-on-evict and ``match_tiered`` as JAX's tables,
  and 500 ops of randomized churn in lockstep with JAX's tables
  (``check()`` after every op, tables and host keys equal after each);
- the engine: a probe served cold, as an HBM prefix hit and as a host
  hit gives the JAX engine's tokens at ``cache_dtype`` None and int8,
  promoting 4 pages through 2-lane staging (2 groups), with one decode,
  prefill and promotion shape and ``promoted_bytes`` equal to
  ``promotion_traffic``;
- ``_spill_fetch`` of the same page contents: bit-equal to JAX's for an
  int8 pool; for a wide pool int8 values within 1 level and scales within
  rtol 1e-5 (both are the same numpy quantization of the same fp32
  values, so in practice equal);
- a retire that beats the promotion puts the payloads back;
- the validation errors in JAX's words; the spill-less engine;
- the accounting models equal JAX's; the ``host_spill:`` YAML block.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.comms import accounting as jacc
from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.serving import PagedEngine as JaxEngine
from torchbooster_tpu.serving import kv_pages as jkv
from torchbooster_tpu_torch.comms import accounting as acc
from torchbooster_tpu_torch.config import HostSpillConfig, ServingConfig
from torchbooster_tpu_torch.interop import params_from_jax
from torchbooster_tpu_torch.models.gpt import GPTConfig
from torchbooster_tpu_torch.serving import (ContinuousBatcher, PagedEngine,
                                            Request)
from torchbooster_tpu_torch.serving import kv_pages as tkv
from torchbooster_tpu_torch.serving.engine import _quantize_page_np

_KW = dict(vocab=97, n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
           seq_len=64)
_PAGE = 4
_PAGE_BYTES = 384      # one _fake_fetch payload
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


def _fake_fetch(page_size=_PAGE):
    """A demotion payload in the engine's format (int8 K/V + fp32 scales
    over 2 layers, 2 KV heads, head dim 8: 384 bytes a page) whose
    content is the page id."""
    def fetch(p):
        return {"k": np.full((2, page_size, 2, 8), p % 120, np.int8),
                "k_scale": np.ones((2, page_size, 2, 1), np.float32),
                "v": np.full((2, page_size, 2, 8), p % 120, np.int8),
                "v_scale": np.ones((2, page_size, 2, 1), np.float32)}
    return fetch


# ---- HostPagePool ----------------------------------------------------

_SCRIPTS = {
    # the JAX suite's sequence: fill, overflow, refresh, pop, oversize
    "lru_refresh_pop_oversize": [
        ("put", b"a", 1), ("put", b"b", 2), ("put", b"c", 3),
        ("get", b"a"), ("put", b"d", 4), ("put", b"b", 5),
        ("put", b"e", 6), ("pop", b"d"), ("pop", b"d"),
        ("put", b"huge", "huge")],
    # a pool one page wide: every put evicts its predecessor
    "one_page_budget": [
        ("put", b"x", 1), ("put", b"y", 2), ("pop", b"x"),
        ("put", b"x", 3), ("put", b"x", 4), ("pop", b"x"), ("pop", b"y")],
    # pops free budget: later puts fit without evicting
    "pop_makes_room": [
        ("put", b"a", 1), ("put", b"b", 2), ("put", b"c", 3),
        ("pop", b"b"), ("put", b"d", 4), ("put", b"e", 5),
        ("get", b"c"), ("put", b"f", 6)],
}
_BUDGETS = {"lru_refresh_pop_oversize": 3, "one_page_budget": 1,
            "pop_makes_room": 3}


def _run_script(pool, script):
    fetch, out = _fake_fetch(), []
    for op, key, *arg in script:
        if op == "put":
            payload = ({"k": np.zeros(4 * _PAGE_BYTES, np.int8)}
                       if arg[0] == "huge" else fetch(arg[0]))
            out.append(("put", pool.put(key, payload)))
        elif op == "pop":
            got = pool.pop(key)
            out.append(("pop", None if got is None else int(got["k"].flat[0])))
        else:
            got = pool.get(key)
            out.append(("get", None if got is None else int(got["k"].flat[0])))
        pool.check()
        out.append((sorted(pool.keys()), pool.used_bytes, pool.n_spills,
                    pool.n_evictions, len(pool)))
    return out


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_host_page_pool_lru_budget_and_counters(name):
    budget = _BUDGETS[name] * _PAGE_BYTES
    got = _run_script(tkv.HostPagePool(budget), _SCRIPTS[name])
    want = _run_script(jkv.HostPagePool(budget), _SCRIPTS[name])
    assert got == want
    if name == "lru_refresh_pop_oversize":
        # the JAX suite's checkpoints: the oldest untouched key goes
        # first, a refresh mints a new tick, an oversize payload drops
        assert got[8] == ("put", [b"a"]) and got[12] == ("put", [b"c"])
        assert got[-2] == ("put", [b"b", b"e", b"huge"])
        assert got[-1] == ([], 0, 6, 5, 0)
    for cls in (tkv.HostPagePool, jkv.HostPagePool):
        with pytest.raises(ValueError, match="budget must be >= 1 byte"):
            cls(budget_bytes=0)


# ---- BlockTables -----------------------------------------------------

def _tables(kv, cfg, n_pages, max_slots, budget):
    bt = kv.BlockTables(cfg, page_size=_PAGE, n_pages=n_pages,
                        max_slots=max_slots, prefix_cache=True)
    bt.host_pool = kv.HostPagePool(budget)
    bt.spill_fetch = _fake_fetch()
    events = []
    bt.on_tier_event = lambda kind, key: events.append((kind, key))
    return bt, events


def test_block_tables_demote_on_evict_and_match_tiered():
    """Eviction DEMOTES into the host pool under the chain key, and
    ``match_tiered`` returns the HBM chain plus its host continuation,
    capped at ``(len - 1) // page_size`` and cut at the first host miss
    — the same pages, keys and tier events as JAX's tables."""
    jax_bt, jax_ev = _tables(jkv, JCfg(seq_len=64), 12, 2, 1 << 20)
    bt, ev = _tables(tkv, GPTConfig(seq_len=64), 12, 2, 1 << 20)
    prompt = np.arange(12, dtype=np.int32)          # 3 full pages
    ext = np.concatenate([prompt, np.int32([50, 51])])
    keys = [prompt[:(i + 1) * _PAGE].tobytes() for i in range(3)]
    seen = []
    for tables in (jax_bt, bt):
        tables.seat(0, prompt)
        tables.activate(0, 1)
        tables.register_prefix(0, prompt)
        tables.retire(0)
        tables.check()
        assert tables._evict(2) == 2 and tables.n_host_pages == 2
        tables.check()
        full = tables.match_tiered(ext)
        capped = tables.match_tiered(prompt)
        tables.host_pool.pop(keys[1])
        cut = tables.match_tiered(ext)
        tables.check()
        seen.append((full, capped, cut))
    assert seen[0] == seen[1]
    (pages, hkeys), (cp, ck), (xp, xk) = seen[1]
    assert len(pages) == 1 and hkeys == keys[1:]
    assert len(cp) == 1 and ck == [keys[1]]
    assert len(xp) == 1 and xk == []
    assert ev == jax_ev
    assert [k for k, _ in ev] == ["register"] * 3 + ["demote"] * 2


def test_block_tables_spill_churn_invariants():
    """500 ops of randomized seat (with the engine's pop / seat /
    ``promote_keys`` sequence) / advance / retire churn over three
    tenants' prefixes, a tight pool and a 6-page host budget, in lockstep
    on the port's and JAX's tables: ``check()`` holds after every op and
    both tables agree after each; demote, promote and host eviction all
    fire."""
    cfgs = (GPTConfig(seq_len=64), JCfg(seq_len=64))
    pair = [_tables(kv, c, 16, 4, 6 * _PAGE_BYTES)
            for kv, c in ((tkv, cfgs[0]), (jkv, cfgs[1]))]
    bt, jax_bt = pair[0][0], pair[1][0]
    rng = np.random.RandomState(13)
    tenants = [rng.randint(0, 97, 12).astype(np.int32) for _ in range(3)]
    live: dict = {}
    host_hits = 0
    for _ in range(500):
        roll = rng.rand()
        slot = bt.free_slot()
        if roll < 0.45 and slot is not None:
            tail = rng.randint(0, 97, int(rng.randint(1, 16))).astype(np.int32)
            shared = tenants[int(rng.randint(3))]
            prompt = (np.concatenate([shared, tail])
                      if rng.rand() < 0.6 else tail)
            first = int(rng.randint(0, 97))
            if bt.pages_for(len(prompt)) > bt.n_available_pages:
                continue
            outcomes = []
            for tables in (bt, jax_bt):
                matched, hkeys = tables.match_tiered(prompt)
                payloads = [tables.host_pool.pop(k) for k in hkeys]
                try:
                    _, n_matched = tables.seat(slot, prompt, matched=matched)
                except RuntimeError:
                    for k, pl in zip(hkeys, payloads):
                        tables.host_pool.put(k, pl)
                    outcomes.append(None)
                    continue
                tables.activate(slot, first)
                tables.promote_keys(slot, hkeys, n_matched)
                tables.register_prefix(slot, prompt)
                outcomes.append(len(hkeys))
            assert outcomes[0] == outcomes[1]
            if outcomes[0] is not None:
                host_hits += outcomes[0]
                live[slot] = True
        elif roll < 0.8 and live:
            slot = int(rng.choice(sorted(live)))
            tok = int(rng.randint(0, 97))
            if bt.lengths[slot] < 64:
                grown = [t.ensure_write_pages(slot, 1) for t in (bt, jax_bt)]
                assert grown[0] == grown[1]
                if grown[0]:
                    bt.advance(slot, tok)
                    jax_bt.advance(slot, tok)
        elif live:
            slot = int(rng.choice(sorted(live)))
            bt.retire(slot)
            jax_bt.retire(slot)
            del live[slot]
        bt.check()
        for name in ("tables", "lengths", "refcount", "refs", "page_pos"):
            np.testing.assert_array_equal(getattr(bt, name),
                                          getattr(jax_bt, name))
        assert bt.host_pool.keys() == jax_bt.host_pool.keys()
        assert bt._index == jax_bt._index
    assert pair[0][1] == pair[1][1]            # the same tier events
    kinds = {k for k, _ in pair[0][1]}
    assert {"register", "demote", "promote", "host_evict"} <= kinds, kinds
    assert host_hits > 0 and bt.host_pool.n_evictions > 0
    for slot in list(live):
        bt.retire(slot)
    bt.check()
    assert bt.n_available_pages == bt.n_pages - 1


# ---- the engine ------------------------------------------------------

def _engines(cache_dtype, spill=True):
    """The JAX engine and the port's on the same params and geometry:
    16 pages of 4 tokens, 2 slots, 2-page chunks (so 2 promotion lanes)."""
    jp, jcfg, tp, cfg = _model()
    kw = dict(page_size=_PAGE, n_pages=16, max_slots=2,
              cache_dtype=cache_dtype, prefix_cache=True,
              prefill_chunk_pages=2, host_spill=spill, host_spill_mb=4.0)
    return (JaxEngine(jp, jcfg, compute_dtype=jnp.float32, **kw),
            PagedEngine(tp, cfg, compute_dtype=torch.float32,
                        device="cpu", **kw))


def _paged_tokens(engine, prompt, n_new):
    slot, first = engine.admit(prompt)
    toks = [first]
    for _ in range(n_new - 1):
        assert engine.grow_slots() == []
        toks.append(int(engine.step()[slot]))
    engine.retire(slot)
    return toks


def _churn(engine, n=20):
    for i in range(n):
        junk = np.full(2 * _PAGE, 1 + (i % 90), np.int32) \
            + np.arange(2 * _PAGE, dtype=np.int32) % 3
        junk[0] = 1 + i
        _paged_tokens(engine, junk, 2)


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_engine_host_hit_parity_and_one_promotion_shape(cache_dtype):
    """The probe served cold, as an HBM hit and (after churn demotes its
    4 prefix pages) as a host hit gives the JAX engine's tokens each
    time; the 4 pages promote through 2-lane staging, i.e. two groups
    back to back, with one promotion shape and ``promoted_bytes`` equal
    to ``promotion_traffic`` to the byte."""
    jeng, eng = _engines(cache_dtype)
    rs = np.random.RandomState(5)
    prefix = rs.randint(0, 97, 4 * _PAGE).astype(np.int32)
    probe = np.concatenate([prefix, np.int32([5, 9])])
    keys = [prefix[:(i + 1) * _PAGE].tobytes() for i in range(4)]
    streams = {}
    for name, e in (("jax", jeng), ("port", eng)):
        cold = _paged_tokens(e, probe, 6)
        hbm = _paged_tokens(e, probe, 6)
        assert e.prefix_hit_pages >= 4 and e.host_hit_pages == 0
        assert e.promote_compiles == 0
        _churn(e)
        assert e.spills >= 4 and e.tables.n_host_pages >= 4
        assert all(k in e.tables.host_pool for k in keys)
        h0 = e.host_hit_pages
        host = _paged_tokens(e, probe, 6)
        assert e.host_hit_pages - h0 == 4
        streams[name] = (cold, hbm, host)
        e.tables.check()
    cold, hbm, host = streams["port"]
    assert cold == hbm == host, "the tier a prefix is served from " \
        "changed its tokens"
    assert streams["port"] == streams["jax"]
    assert (eng.spills, eng.promotions) == (jeng.spills, jeng.promotions)
    assert eng._promote_lanes == 2 and eng.promotions > eng._promote_lanes
    assert eng.decode_compiles == eng.prefill_compiles == 1
    assert eng.promote_compiles == 1
    model = acc.promotion_traffic(
        eng.promotions, page_size=_PAGE, kv_heads=2, head_dim=8, n_layers=2)
    assert eng.promoted_bytes == model["total_bytes"] == jeng.promoted_bytes
    stats, jstats = eng.debug_stats(), jeng.debug_stats()
    for key in ("host_spill", "pages_host", "spills", "promotions",
                "host_hit_pages", "promoted_bytes", "host_bytes_used",
                "host_evictions", "pages_free", "pages_cached"):
        assert stats[key] == jstats[key], key
    assert stats["compiles"]["promote"] == 1
    assert set(stats) == set(jstats)


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_spill_fetch_payload_matches_jax(cache_dtype):
    """``_spill_fetch`` of the same page contents in both engines' pools:
    the int8 pool ships its stored values and scales verbatim, bit-equal
    to JAX's payload; the fp32 pool quantizes, held to within one int8
    level and rtol 1e-5 on the scales. Also after a real prefill of the
    same prompt (fp32 pool), under the same tolerance."""
    jeng, eng = _engines(cache_dtype)
    rs = np.random.RandomState(11)
    shape = (2, 16, _PAGE, 2, 8)
    k, v = (rs.standard_normal(shape).astype(np.float32) for _ in range(2))
    if cache_dtype == "int8":
        kq, ks = _quantize_page_np(k)
        vq, vs = _quantize_page_np(v)
        ks, vs = (s.astype(jnp.bfloat16).astype(np.float32)
                  for s in (ks, vs))
        jeng.pool = {"k": (jnp.asarray(kq), jnp.asarray(ks, jnp.bfloat16)),
                     "v": (jnp.asarray(vq), jnp.asarray(vs, jnp.bfloat16))}
        for half, q, s in (("k", kq, ks), ("v", vq, vs)):
            eng.pool[half][0].copy_(torch.from_numpy(q))
            eng.pool[half][1].copy_(torch.from_numpy(s))
    else:
        jeng.pool = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
        eng.pool["k"].copy_(torch.from_numpy(k))
        eng.pool["v"].copy_(torch.from_numpy(v))

    def same(got, want, exact):
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            assert got[name].shape == want[name].shape, name
            if exact:
                np.testing.assert_array_equal(got[name], want[name])
            elif name.endswith("scale"):
                np.testing.assert_allclose(got[name], want[name], rtol=1e-5)
            else:
                assert np.abs(got[name].astype(np.int32)
                              - want[name].astype(np.int32)).max() <= 1

    for p in (1, 7, 15):
        same(eng._spill_fetch(p), jeng._spill_fetch(p),
             exact=cache_dtype == "int8")
    assert eng.spills == jeng.spills == 3
    if cache_dtype is None:
        jeng, eng = _engines(None)
        probe = np.random.RandomState(2).randint(0, 97, 14).astype(np.int32)
        for e in (jeng, eng):
            e.admit(probe)
        for p in eng.tables.tables[0, :3]:
            same(eng._spill_fetch(int(p)), jeng._spill_fetch(int(p)),
                 exact=False)
        exported = eng.export_pages(0, probe)
        jexported = jeng.export_pages(0, probe)
        assert [k for k, _ in exported] == [k for k, _ in jexported]
        assert eng.exported_pages == jeng.exported_pages == 3
        assert eng.exported_bytes == jeng.exported_bytes


def test_engine_retire_beats_promotion_reputs_payloads():
    """``admit_begin`` pops the host payloads; a retire before the
    promotion puts them back, and the next request still host-hits."""
    _, eng = _engines(None)
    rs = np.random.RandomState(9)
    prefix = rs.randint(0, 97, 3 * _PAGE).astype(np.int32)
    probe = np.concatenate([prefix, np.int32([2, 7])])
    _paged_tokens(eng, probe, 3)
    for i in range(16):
        _paged_tokens(eng, np.full(2 * _PAGE, 1 + i, np.int32), 2)
    keys = [prefix[:(i + 1) * _PAGE].tobytes() for i in range(3)]
    assert all(k in eng.tables.host_pool for k in keys)
    slot = eng.admit_begin(probe)
    assert slot is not None
    assert all(k not in eng.tables.host_pool for k in keys)
    eng.retire(slot)
    assert all(k in eng.tables.host_pool for k in keys), \
        "retire-before-promote dropped the popped payloads"
    assert eng.promotions == 0
    eng.tables.check()
    h0 = eng.host_hit_pages
    toks = _paged_tokens(eng, probe, 3)
    assert eng.host_hit_pages - h0 == 3 and len(toks) == 3
    assert eng.promotions == 3


def test_engine_spill_validation_and_off_collapse():
    """The invalid combination fails with JAX's exact words; without the
    tier, eviction frees pages, nothing is staged and the tier's debug
    fields read zero as JAX's do."""
    jp, jcfg, tp, cfg = _model()
    errs = []
    for build in (
            lambda: JaxEngine(jp, jcfg, page_size=4, n_pages=16,
                              max_slots=2, compute_dtype=jnp.float32,
                              host_spill=True),
            lambda: PagedEngine(tp, cfg, page_size=4, n_pages=16,
                                max_slots=2, compute_dtype=torch.float32,
                                host_spill=True, device="cpu")):
        with pytest.raises(ValueError, match="needs prefix_cache") as e:
            build()
        errs.append(" ".join(str(e.value).split()))
    assert errs[0] == errs[1]
    jeng, eng = _engines(None, spill=False)
    for e in (jeng, eng):
        _paged_tokens(e, np.arange(10, dtype=np.int32), 4)
        for i in range(16):
            _paged_tokens(e, np.full(8, 1 + i, np.int32), 2)
    assert eng.tables.host_pool is None and not hasattr(eng, "_stage")
    assert eng.promote_compiles == 0 and eng.issue_promotions() == 0
    stats, jstats = eng.debug_stats(), jeng.debug_stats()
    for key in ("host_spill", "pages_host", "spills", "promoted_bytes",
                "pages_free", "pages_cached", "prefix_hit_pages"):
        assert stats[key] == jstats[key], key
    assert stats["compiles"]["promote"] == 0


def test_prefix_hit_final_chunk_past_the_horizon():
    """Fault C4 (``ROADMAP.md`` §C): after a prefix hit the final chunk
    starts on a page boundary, so a prompt near ``seq_len`` puts its pad
    rows past the horizon. The port indexed the position table there
    (IndexError on the CPU, a device-side assert on the card); it now
    clamps them as its decode step does, and the HBM hit and the host hit
    give the cold stream — the JAX engine's cold stream. (The JAX
    engine's own hit fills those rows with NaN and decodes token 0; the
    JAX package is the reference and stays as it is.)"""
    jp, jcfg, tp, cfg = _model()
    prompt = np.random.RandomState(0).randint(0, 97, 60).astype(np.int32)
    kw = dict(page_size=_PAGE, n_pages=40, max_slots=2, prefix_cache=True,
              prefill_chunk_pages=4)
    want = _paged_tokens(JaxEngine(jp, jcfg, compute_dtype=jnp.float32,
                                   **kw), prompt, 4)
    eng = PagedEngine(tp, cfg, compute_dtype=torch.float32, device="cpu",
                      host_spill=True, **kw)
    cold = _paged_tokens(eng, prompt, 4)
    hbm = _paged_tokens(eng, prompt, 4)
    assert eng.prefix_hit_pages == 14        # start 56: the chunk ends at 72
    eng.tables._evict(eng.tables.n_cached_pages)
    host = _paged_tokens(eng, prompt, 4)
    assert eng.host_hit_pages == 14
    assert cold == hbm == host == want
    eng.tables.check()


# ---- accounting, config, batcher -------------------------------------

def test_accounting_models_equal_jax():
    for n in (0, 3, 8):
        kw = dict(page_size=64, kv_heads=12, head_dim=64, n_layers=12)
        assert acc.promotion_traffic(n, **kw) == jacc.promotion_traffic(n, **kw)
    for length in (1, 64, 65, 960):
        kw = dict(page_size=64, kv_heads=12, head_dim=64, n_layers=12)
        assert acc.disagg_traffic(length, **kw) \
            == jacc.disagg_traffic(length, **kw)
    for gbs in (1.0, 16.0, 50.0):
        kw = dict(n_params=124_000_000, page_size=64,
                  per_page_bytes=1_327_104, h2d_gbs=gbs, flops_tps=989.0,
                  n_pages=8)
        assert acc.spill_breakeven(**kw) == jacc.spill_breakeven(**kw)
    kw = dict(n_params=1000, n_shards=4, mode="int8", zero1=True,
              bucket_size=64)
    assert acc.step_traffic(**kw) == jacc.step_traffic(**kw)
    with pytest.raises(ValueError):
        acc.promotion_traffic(-1, page_size=4, kv_heads=2, head_dim=8,
                              n_layers=2)


def test_host_spill_yaml_block_resolves_and_serves(tmp_path):
    """``serving: {host_spill: ...}`` resolves into ``HostSpillConfig``
    (off by default) and ``make`` builds a batcher whose engine has the
    tier; a trace that demotes and promotes reports it in the metrics,
    the registry and the flight rows, with the JAX batcher's tokens."""
    from torchbooster_tpu.serving import (ContinuousBatcher as JaxBatcher,
                                          Request as JaxRequest)
    path = tmp_path / "serve.yaml"
    path.write_text("serving:\n  page_size: 4\n  n_pages: 8\n"
                    "  max_slots: 2\n  prefix_cache: true\n"
                    "  prefill_chunk_pages: 2\n"
                    "  decode_backend: sweep\n"
                    "  host_spill:\n    enabled: true\n    budget_mb: 4\n")
    conf = ServingConfig.load(path)
    assert isinstance(conf.host_spill, HostSpillConfig)
    assert conf.host_spill.enabled and conf.host_spill.budget_mb == 4.0
    assert not ServingConfig().host_spill.enabled
    jp, jcfg, tp, cfg = _model()
    batcher = conf.make(tp, cfg, compute_dtype="float32", device="cpu")
    assert isinstance(batcher, ContinuousBatcher)
    assert batcher.engine.host_spill and batcher.engine.prefix_cache
    jeng = JaxEngine(jp, jcfg, page_size=4, n_pages=8, max_slots=2,
                     compute_dtype=jnp.float32, prefix_cache=True,
                     prefill_chunk_pages=2, host_spill=True,
                     host_spill_mb=4.0)
    jbatcher = JaxBatcher(jeng)
    rs = np.random.RandomState(3)
    shared = rs.randint(0, 97, 12).astype(np.int32)
    prompts = [np.concatenate([shared, np.int32([i + 1, 2])])
               if i % 3 == 0 else rs.randint(0, 97, 10).astype(np.int32)
               for i in range(7)]
    outs = []
    for b, req_cls in ((batcher, Request), (jbatcher, JaxRequest)):
        reqs = [req_cls(prompt=p, max_new_tokens=4) for p in prompts]
        metrics = [b.run([r]) for r in reqs]
        outs.append(([r.tokens for r in reqs],
                     [{k: m[k] for k in ("n_spills", "n_promotions",
                                         "host_hit_pages")}
                      for m in metrics]))
    assert outs[0] == outs[1]
    assert sum(m["host_hit_pages"] for m in outs[0][1]) > 0
    assert sum(m["n_spills"] for m in outs[0][1]) > 0
    # the tier's registry counters exist only with the tier
    assert {"spills", "promotions", "host_hits"} <= set(batcher._inst)
    plain = ServingConfig(page_size=4, n_pages=12).make(tp, cfg,
                                                        device="cpu")
    plain.run([Request(prompt=prompts[1], max_new_tokens=2)])
    assert "spills" not in plain._inst
    rows = batcher.flight.tail()
    assert sum(int(r["promotions"]) for r in rows) \
        == batcher.engine.promotions > 0
    assert sum(int(r["host_hit_pages"]) for r in rows) \
        == batcher.engine.host_hit_pages
    assert batcher.engine.promote_compiles == 1
    batcher.engine.tables.check()
