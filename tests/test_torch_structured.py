"""Port parity: structured generation (``serving/structured/``, the
engine's legality masks, the batcher's ``response_format`` surface)
against the JAX package on the CPU, at the JAX suite's
``_decisive_model`` widths (vocab 300, 2 layers, d_model 32, 4 heads,
8-token pages, decisive tied head, EOS 299 outside the byte alphabet).

- the compiler: for every ``SCHEMA_LIBRARY`` schema, a regex and
  ``json_object``, the port's token DFA (``mask``, ``nxt``,
  ``accepting``, ``start``) equals JAX's array for array;
- ``SlotCursors``: the mask sequence along a token walk equals JAX's,
  through ``draft_rows``, ``tree_rows``, ``fork_child`` and prefix
  replay;
- the engine: a mixed batch (two schemas and a rider) gives the JAX
  engine's tokens at fp32 plainly, under linear and under tree verify
  (the JAX suite holds its speculative streams to its plain ones), and
  an ``n = 2`` greedy fork gives the JAX engine's tokens on every
  branch; preemption resumes token-exact; one decode and one verify
  shape across schema churn;
- the submit errors carry JAX's wording, and the YAML ``structured:``
  block builds a structured engine.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.serving import (ContinuousBatcher as JaxBatcher,
                                      PagedEngine as JaxEngine,
                                      Request as JaxRequest)
from torchbooster_tpu.serving import structured as jst
from torchbooster_tpu_torch.config import ServingConfig
from torchbooster_tpu_torch.interop import params_from_jax
from torchbooster_tpu_torch.models.gpt import GPTConfig
from torchbooster_tpu_torch.serving import (ContinuousBatcher, PagedEngine,
                                            Request)
from torchbooster_tpu_torch.serving import structured as st

EOS = 299
_CACHE: dict = {}


def _model(seq_len=128):
    """The JAX suite's decisive model and its port twin (cached; callers
    must not mutate either tree)."""
    if seq_len not in _CACHE:
        kw = dict(vocab=300, n_layers=2, d_model=32, n_heads=4,
                  seq_len=seq_len)
        jcfg = JCfg(**kw)
        jp = JGPT.init(jax.random.PRNGKey(0), jcfg)
        jp = {**jp, "wte": {"table": jp["wte"]["table"] * 4.0}}
        cfg = GPTConfig(**kw)
        _CACHE[seq_len] = (jp, jcfg, params_from_jax(jax.device_get(jp),
                                                     cfg, "cpu"), cfg)
    return _CACHE[seq_len]


def _engine(tp, cfg, **kw):
    kw.setdefault("page_size", 8)
    kw.setdefault("n_pages", 64)
    kw.setdefault("max_slots", 4)
    kw.setdefault("structured", True)
    return PagedEngine(tp, cfg, compute_dtype=torch.float32, device="cpu",
                       **kw)


def _text(tokens):
    toks = tokens[:-1] if tokens and tokens[-1] == EOS else tokens
    return "".join(chr(int(t)) for t in toks if int(t) < 256)


_SPECS = {**{sid: st.library_response_format(sid)
             for sid in sorted(st.SCHEMA_LIBRARY)},
          "regex": {"type": "regex", "pattern": "(ab|cd)+[0-9]{1,3}"},
          "json_object": {"type": "json_object"}}


@pytest.mark.parametrize("name", sorted(_SPECS))
def test_token_dfa_equals_jax(name):
    spec = _SPECS[name]
    assert st.library_response_format("tags") \
        == jst.library_response_format("tags")
    got = st.compile_response_format(spec, st.bytes_vocab(300))
    want = jst.compile_response_format(spec, jst.bytes_vocab(300))
    assert (got.start, got.n_states) == (want.start, want.n_states)
    for field in ("mask", "nxt", "accepting"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert st.schema_budget(name) == jst.schema_budget(name) \
        if name in st.SCHEMA_LIBRARY else True


def test_slot_cursors_walk_equals_jax():
    """Both packages' cursors through one script of begin, observe,
    draft_rows, tree_rows, fork_child, reset and prefix replay: every
    mask and every returned draft and row array is equal."""
    spec = st.library_response_format("label_score")
    dfa = st.compile_response_format(spec, st.bytes_vocab(300))
    jdfa = jst.compile_response_format(spec, jst.bytes_vocab(300))
    text = [ord(c) for c in '{"label":"b","score":3}']
    sides = []
    for mod, d in ((st, dfa), (jst, jdfa)):
        c = mod.SlotCursors(4, 300)
        out = []
        c.begin(0, d, EOS)
        out.append(c.mask.copy())
        for t in text[:5]:
            c.observe(0, [t])
            out.append(c.mask.copy())
        out.extend(c.draft_rows(0, text[5:9] + [ord("z")]))
        out.extend(c.tree_rows(0, [text[5], ord("x"), text[6], text[7]],
                               [0, 0, 1, 3]))
        c.fork_child(0, 2)
        c.observe(2, [text[0]])
        out.append(c.mask.copy())
        c.reset(0)
        c.begin(1, d, EOS, prefix_tokens=text)
        out.extend([c.mask.copy(), c.start_row(1),
                    np.asarray([c.state_of(1), c.live_count,
                                c.masked_rows])])
        out.append(np.asarray(c.masked_sum))
        sides.append(out)
    assert len(sides[0]) == len(sides[1])
    for a, b in zip(*sides):
        np.testing.assert_array_equal(a, b)


def _mixed(R):
    return [R(prompt=np.arange(1, 9), max_new_tokens=40, eos_id=EOS,
              response_format=st.library_response_format("label_score")),
            R(prompt=np.arange(3, 11), max_new_tokens=12),
            R(prompt=np.arange(5, 13), max_new_tokens=40, eos_id=EOS,
              response_format=st.library_response_format("tags"))]


def _jax_mixed():
    if "mixed" not in _CACHE:
        jp, jcfg, _, _ = _model()
        reqs = _mixed(JaxRequest)
        JaxBatcher(JaxEngine(jp, jcfg, page_size=8, n_pages=64, max_slots=4,
                             compute_dtype=jnp.float32,
                             structured=True)).run(reqs)
        _CACHE["mixed"] = [list(r.tokens) for r in reqs]
    return _CACHE["mixed"]


@pytest.mark.parametrize("mode", ["plain", "linear", "tree"])
def test_mixed_batch_equals_jax(mode):
    """Constrained and unconstrained requests in one batch: the port's
    streams equal the JAX engine's, every constrained one conforms and
    stops on EOS; one step shape."""
    _, _, tp, cfg = _model()
    kw = {"plain": {}, "linear": dict(speculative=True, draft_len=4),
          "tree": dict(speculative=True, draft_len=4, spec_tree=True)}[mode]
    eng = _engine(tp, cfg, **kw)
    reqs = _mixed(Request)
    m = ContinuousBatcher(eng, on_recompile="raise").run(reqs)
    assert [r.tokens for r in reqs] == _jax_mixed()
    for r in reqs:
        if r.response_format is not None:
            assert r.finish_reason == "stop"
            assert st.conforms(r.response_format, _text(r.tokens))
    assert m["n_structured"] == 2 and 0.0 < m["structured_masked_frac"] < 1
    if mode == "plain":
        assert eng.decode_compiles == 1 and eng.verify_compiles == 0
    else:
        assert eng.verify_compiles == 1 and eng.decode_compiles == 0
    assert eng.structured_slot_count == 0
    eng.tables.check()


def test_nway_fork_equals_jax():
    """A constrained ``n = 2`` request on a greedy parallel-sampling
    engine: each branch's cursor rebases at the fork, every branch equals
    the JAX engine's branch and conforms."""
    jp, jcfg, tp, cfg = _model()
    rf = st.library_response_format("verdict")
    kw = dict(prompt=np.arange(1, 9), max_new_tokens=st.schema_budget(
        "verdict"), eos_id=EOS, response_format=rf, n=2, seed=7)
    jreq = JaxRequest(**kw)
    JaxBatcher(JaxEngine(jp, jcfg, page_size=8, n_pages=64, max_slots=4,
                         compute_dtype=jnp.float32, structured=True,
                         parallel_sampling=True)).run([jreq])
    req = Request(**kw)
    eng = _engine(tp, cfg, parallel_sampling=True)
    m = ContinuousBatcher(eng, on_recompile="raise").run([req])
    assert m["n_forks"] == 1 and len(req.branches) == 2
    assert [b.tokens for b in req.branches] \
        == [list(b.tokens) for b in jreq.branches]
    for b in req.branches:
        assert b.finish_reason == "stop" and st.conforms(rf, _text(b.tokens))
    assert eng.decode_compiles == 1
    eng.tables.check()


def test_preemption_resumes_token_exact():
    """A constrained request evicted mid-decode re-seats with its folded
    tokens replayed into the cursor: the stream equals the unpreempted
    run's."""
    _, _, tp, cfg = _model(seq_len=64)
    rf = st.library_response_format("label_score")
    budget = st.schema_budget("label_score")
    ref = Request(prompt=np.arange(1, 7), max_new_tokens=budget, eos_id=EOS,
                  response_format=rf)
    ContinuousBatcher(_engine(tp, cfg, page_size=4, n_pages=32)).run([ref])
    assert ref.finish_reason == "stop"
    eng = _engine(tp, cfg, page_size=4, n_pages=10, max_slots=2)
    filler = Request(prompt=np.arange(11, 17), max_new_tokens=16)
    req = Request(prompt=np.arange(1, 7), max_new_tokens=budget, eos_id=EOS,
                  response_format=rf, arrival=0.01)
    m = ContinuousBatcher(eng).run([filler, req])
    assert m["n_preemptions"] > 0
    assert req.tokens == ref.tokens and st.conforms(rf, _text(req.tokens))
    eng.tables.check()


def test_schema_churn_keeps_one_step_shape():
    """Every library schema through one plain and one speculative engine:
    each conforms, and the decode and verify steps keep one shape."""
    _, _, tp, cfg = _model()
    for kw in ({}, dict(speculative=True, draft_len=3)):
        eng = _engine(tp, cfg, **kw)
        batcher = ContinuousBatcher(eng, on_recompile="raise")
        batcher.run([Request(prompt=np.arange(1, 7), max_new_tokens=4)])
        for i, sid in enumerate(sorted(st.SCHEMA_LIBRARY)):
            req = Request(prompt=np.arange(1 + i, 9 + i),
                          max_new_tokens=st.schema_budget(sid), eos_id=EOS,
                          response_format=st.library_response_format(sid))
            batcher.run([req])
            assert req.finish_reason == "stop"
            assert st.conforms(req.response_format, _text(req.tokens))
        assert eng.decode_compiles + eng.verify_compiles == 1
        assert eng.prefill_compiles == 1
        assert len(eng._sdfa_cache) == len(st.SCHEMA_LIBRARY)


def _error(fn):
    try:
        fn()
    except (TypeError, ValueError) as err:
        return type(err).__name__, str(err)
    return None


@pytest.mark.parametrize("case", ["no_eos", "not_dict", "bad_type",
                                  "plain_engine", "eos_in_alphabet",
                                  "eos_outside_vocab"])
def test_submit_errors_use_jax_wording(case):
    jp, jcfg, tp, cfg = _model()
    rf = st.library_response_format("bool_flag")
    kw = dict(prompt=np.arange(4), max_new_tokens=4)
    structured = case != "plain_engine"
    kw.update({"no_eos": dict(response_format=rf),
               "not_dict": dict(response_format="json_object"),
               "bad_type": dict(eos_id=EOS,
                                response_format={"type": "json_schemaa"}),
               "plain_engine": dict(eos_id=EOS, response_format=rf),
               "eos_in_alphabet": dict(eos_id=ord("t"), response_format=rf),
               "eos_outside_vocab": dict(eos_id=300, response_format=rf),
               }[case])

    def port():
        ContinuousBatcher(_engine(tp, cfg, structured=structured)).run(
            [Request(**kw)])

    def ref():
        JaxBatcher(JaxEngine(jp, jcfg, page_size=8, n_pages=64, max_slots=4,
                             compute_dtype=jnp.float32,
                             structured=structured)).run([JaxRequest(**kw)])

    got = _error(port)
    assert got is not None and got == _error(ref)


def test_plain_text_format_is_a_no_op():
    """``{"type": "text"}`` serves on an engine without structured
    generation and binds no cursor."""
    _, _, tp, cfg = _model()
    req = Request(prompt=np.arange(1, 7), max_new_tokens=4,
                  response_format={"type": "text"})
    m = ContinuousBatcher(_engine(tp, cfg, structured=False)).run([req])
    assert len(req.tokens) == 4 and m["n_structured"] == 0
    assert m["structured_masked_frac"] == 0.0


def test_serving_yaml_structured_block(tmp_path):
    _, _, tp, cfg = _model()
    path = tmp_path / "s.yml"
    path.write_text("serving:\n  page_size: 8\n  n_pages: 32\n"
                    "  max_slots: 2\n  structured:\n    enabled: true\n")
    conf = ServingConfig.load(path)
    assert conf.structured.enabled is True
    batcher = conf.make(tp, cfg, compute_dtype="float32", device="cpu")
    assert batcher.engine.structured is True
    req = Request(prompt=np.arange(1, 9), max_new_tokens=st.schema_budget(
        "enum_color"), eos_id=EOS,
        response_format=st.library_response_format("enum_color"))
    batcher.run([req])
    assert st.conforms(req.response_format, _text(req.tokens))
    with pytest.raises(ValueError, match="unknown serving.structured keys"):
        ServingConfig.from_dict({"structured": {"enabeld": True}})
