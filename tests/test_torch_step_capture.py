"""The captured serving steps on the CPU: what a CUDA-graph capture of
the engine's decode, verify and compaction steps and of ``jit_generate``'s
decode step rests on, at a small size (2-3 layers, d_model 32).

- (a) every tensor the decode, chain and tree verify and compaction steps
  read (seen through a dispatch mode) is one of the engine's step operands
  (``PagedEngine._step_operands``), and each keeps its ``data_ptr`` across
  a churn run: admit, decode, verify, fork, a structured slot, an adapter
  load, a host-spill promotion, retire;
- (b) the plan (``_graphs.plan_steps``): the CPU and steps with
  collectives are eager, each with its reason; a card with none plans
  ``"graph"``; the engine reports its route;
- (c) B4's launches under a capture go to that capture's tally, not
  the counters, and only its own thread's (another thread's launches
  meanwhile stay theirs); a replay adds the tally, by route (in
  ``launches_replayed`` too), and refuses to run once an operand moved;
- (d) ``jit_generate``'s fixed-shape decode step (position on the
  device, the whole cache under a ``<= pos`` mask) is greedy token-exact
  against JAX's ``jit_generate`` (run as the JAX suite runs it) and the
  port's ``generate``, fp32 and int8 caches, GQA and rope, one cached
  shape over two calls; on the graph route (a stand-in graph that
  replays the step it captured, on what it captured) an in-place update
  of the params is read by the next replay and a new tree captures again.

The captures themselves run on the card (``tests/test_torch_cuda.py``).
"""
import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax
import jax.numpy as jnp

from torchbooster_tpu.models import gpt as jgpt
from torchbooster_tpu_torch import _graphs
from torchbooster_tpu_torch.interop import params_from_jax
from torchbooster_tpu_torch.models import gpt as tgpt
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
from torchbooster_tpu_torch.serving import PagedEngine, random_adapter
from torchbooster_tpu_torch.serving import structured as st

pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

EOS = 299
CFG = GPTConfig(vocab=300, n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                seq_len=64, pos="rope")


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _Reads(TorchDispatchMode):
    """The storages a region reads that it did not make itself."""

    def __init__(self):
        super().__init__()
        self.made, self.read = set(), set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and t.numel() \
                    and _storage(t) not in self.made:
                self.read.add(_storage(t))
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.numel():
                self.made.add(_storage(t))
        return out


def _watched(eng: PagedEngine) -> dict:
    """Wrap the engine's step runner: each step kind's reads, by kind."""
    reads: dict = {}
    run = eng._run

    def spy(kind, sig, fn):
        with _Reads() as r:
            out = run(kind, sig, fn)
        reads.setdefault(kind, set()).update(r.read)
        return out

    eng._run = spy
    return reads


def _drain(eng, slot):
    while True:
        done = eng.prefill_step()
        if done is not None and done[0] == slot:
            return done


def _decode(eng, n):
    for _ in range(n):
        assert eng.grow_slots() == []
        eng.step()


def _spec(eng, n):
    for _ in range(n):
        assert eng.grow_slots() == []
        eng.spec_step()


def _churn_plain(eng, rs):
    """Adapter load, a LoRA slot forked into branches, decode, a
    structured slot, retire, then junk traffic that demotes the first
    prompt's prefix pages to the host and a re-admission that promotes
    them back."""
    eng.adapters.register("a", random_adapter(1, CFG, 2))
    lane = eng.adapters.acquire("a")
    first = rs.randint(0, 256, 17).astype(np.int32)
    slot = eng.admit_begin(first, seed=3, adapter_lane=lane)
    _drain(eng, slot)
    kids = [s for s, _, _ in eng.fork(slot, 3)]
    _decode(eng, 2)
    spec = st.library_response_format(sorted(st.SCHEMA_LIBRARY)[0])
    s2 = eng.admit_begin(rs.randint(0, 256, 6).astype(np.int32))
    assert eng.structured_begin(s2, spec, eos_id=EOS)
    _drain(eng, s2)
    _decode(eng, 2)
    for s in (*kids, s2):
        eng.retire(s)
    eng.adapters.release("a")
    for i in range(12):
        junk = np.full(8, 1 + i, np.int32) + np.arange(8, dtype=np.int32)
        s = eng.admit_begin(junk)
        _drain(eng, s)
        _decode(eng, 1)
        eng.retire(s)
    assert eng.spills > 0
    hits = eng.host_hit_pages
    slot = eng.admit_begin(first)
    _drain(eng, slot)
    assert eng.host_hit_pages > hits and eng.promotions > 0
    _decode(eng, 2)
    eng.retire(slot)


def _churn_spec(eng, rs):
    """Repetitive prompts (drafts that hit), verify steps, a retire and
    a re-seat mid-run."""
    prompts = [np.tile(rs.randint(0, 256, n).astype(np.int32), r)
               for n, r in ((3, 5), (5, 3))]
    slots = [eng.admit(p)[0] for p in prompts]
    _spec(eng, 3)
    eng.retire(slots[0])
    eng.admit(prompts[0][:9])
    _spec(eng, 3)


ENGINES = {
    "plain": (dict(prefix_cache=True, host_spill=True, host_spill_mb=4.0,
                   prefill_chunk_pages=2, parallel_sampling=True,
                   temperature=0.8, top_k=20, structured=True, lora_rank=2,
                   lora_max_live=1), _churn_plain, {"decode"}),
    "chain": (dict(speculative=True, draft_len=3), _churn_spec, {"verify"}),
    "tree": (dict(speculative=True, draft_len=3, spec_tree=True,
                  tree_width=2), _churn_spec, {"verify", "compact"}),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_step_operands_keep_their_addresses_through_churn(name):
    """(a) Every tensor a step reads is a step operand, and every step
    operand keeps its address through the churn run. The engines take
    the card's backend, the kernel's (its plain version here), so the
    live-page walk is among the operands."""
    kw, churn, kinds = ENGINES[name]
    params = GPT.init(0, CFG, device="cpu")
    eng = PagedEngine(params, CFG, page_size=4, n_pages=16, max_slots=4,
                      compute_dtype=torch.float32, device="cpu",
                      decode_backend="kernel", **kw)
    before = [t.data_ptr() for t in eng._step_operands()]
    reads = _watched(eng)
    churn(eng, np.random.RandomState(0))
    operands = eng._step_operands()
    assert [t.data_ptr() for t in operands] == before
    assert set(reads) == kinds
    owned = {_storage(t) for t in operands}
    for kind, seen in reads.items():
        assert seen <= owned, f"{kind} read {len(seen - owned)} tensors " \
            "that are no step operand"
    assert eng.decode_compiles + eng.verify_compiles == 1
    eng.tables.check()


def test_kernel_walk_is_staged_in_its_launch_dtype():
    """(a) The kernel backend's walk and the table operands are staged
    once in their final dtypes (int32 for the kernel, int64 indices) and
    refreshed in place, by value."""
    params = GPT.init(0, CFG, device="cpu")
    eng = PagedEngine(params, CFG, page_size=4, n_pages=16, max_slots=4,
                      compute_dtype=torch.float32, device="cpu",
                      decode_backend="kernel")
    slot = eng.admit(np.arange(1, 10, dtype=np.int32))[0]
    eng.grow_slots()
    _, args, work = eng._step_args()
    assert [w.dtype for w in work] == [torch.int32] * 3
    assert all(a.dtype == torch.long for k, a in args.items()
               if k != "active") and args["active"].dtype == torch.bool
    ka = eng.tables.kernel_args()
    for w, k in zip(work, ("work_pages", "work_refs", "work_pos")):
        np.testing.assert_array_equal(w.numpy(), ka[k])
    ptrs = [w.data_ptr() for w in work]
    eng.step()
    eng.retire(slot)
    _, args2, work2 = eng._step_args()
    assert [w.data_ptr() for w in work2] == ptrs
    assert args2["tables"].data_ptr() == args["tables"].data_ptr()
    assert not args2["active"].any()


@pytest.mark.parametrize("device,collectives,route,reason", [
    ("cpu", False, "eager", "CPU"),
    ("cpu", True, "eager", "CPU"),
    ("cuda", True, "eager", "process group"),
    ("cuda", False, "graph", "captured once"),
])
def test_plan_decides_from_device_and_configuration(device, collectives,
                                                    route, reason):
    """(b) The plan's route and reason from the device and whether the
    step has collectives (a tp > 1 engine, a mesh decode); a card with
    none captures. No card is needed to ask."""
    got, why = _graphs.plan_steps(torch.device(device),
                                  collectives=collectives)
    assert got == route and reason in why


def test_engine_reports_its_route_and_eager_steps_nests():
    """(b) A CPU engine plans eager and says why, in ``debug_stats()``
    too, MoE or not (MoE's serving routing reads nothing back to the
    host; the plan does not look at it); ``eager_steps()`` forces the
    eager route inside the block only, nested, and per thread."""
    import threading

    moe = GPTConfig(vocab=64, n_layers=1, d_model=32, n_heads=4,
                    seq_len=32, n_experts=4)
    for cfg in (CFG, moe):
        eng = PagedEngine(GPT.init(0, cfg, device="cpu"), cfg, page_size=4,
                          n_pages=8, max_slots=2, device="cpu",
                          compute_dtype=torch.float32)
        assert eng.step_route == "eager" and "CPU" in eng.step_route_reason
        comp = eng.debug_stats()["compiles"]
        assert (comp["step_route"], comp["graphs"],
                comp["graph_replays"]) == ("eager", 0, 0)
    assert _graphs.captured("graph")
    seen = []
    with _graphs.eager_steps():
        assert not _graphs.captured("graph")
        worker = threading.Thread(
            target=lambda: seen.append(_graphs.captured("graph")))
        worker.start()
        worker.join(timeout=30)
        with _graphs.eager_steps():
            assert not _graphs.captured("graph")
        assert not _graphs.captured("graph")
    assert _graphs.captured("graph") and not _graphs.captured("eager")
    assert not worker.is_alive() and seen == [True]


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def saved_counts():
    saved = (pa.launches, dict(pa.launches_by_route),
             dict(pa.launches_replayed))
    yield saved
    pa.launches = saved[0]
    pa.launches_by_route.update(saved[1])
    pa.launches_replayed.update(saved[2])


def test_replay_adds_the_launches_its_capture_held(saved_counts,
                                                    monkeypatch):
    """(c) Launches under a capture go to its tally, not the counters;
    each replay adds the tally by route; a replay whose operand moved
    raises before it runs."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    pa.launches = 5
    pa.launches_by_route.update(sm90=3, simt=2)
    before = dict(pa.launches_by_route)
    with pa.capture_tally() as held:
        for route in ["sm90"] * 12 + ["simt"] * 2:
            pa._count_launch(route)
    assert held == {"sm90": 12, "simt": 2}
    assert (pa.launches, pa.launches_by_route) == (5, before)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    x = torch.zeros(4)
    graph = _FakeGraph()
    step = _graphs.CapturedStep(graph, "logits", [x], held)
    assert step.replay() == "logits" and step.replay() == "logits"
    assert pa.launches == 5 + 28 and graph.replays == 2
    assert pa.launches_by_route == {"sm90": 27, "simt": 6}
    assert {r: pa.launches_replayed[r] - saved_counts[2][r]
            for r in held} == {"sm90": 24, "simt": 4}
    assert step.replays == 2 and not step.moved() and not step.moved([x])
    assert step.moved([torch.zeros(4)])
    x.set_(torch.zeros(8))
    assert step.moved()
    with pytest.raises(RuntimeError, match="moved"):
        step.replay()
    assert graph.replays == 2 and pa.launches == 33


def test_capture_holds_only_its_own_threads_launches(saved_counts,
                                                     monkeypatch):
    """(c) While one thread captures (``_graphs.capture`` over a fake
    graph and stream), another thread's launches count as its own: the
    capture's tally holds only the launches its step made, and a replay
    adds exactly those."""
    import contextlib
    import threading

    capturing = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(capturing, "on", False))

    class _Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def graph_ctx(graph, stream=None, capture_error_mode=None):
        assert capture_error_mode == "thread_local"
        capturing.on = True
        try:
            yield
        finally:
            capturing.on = False

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph_ctx)
    pa.launches = 0
    pa.launches_by_route.update(sm90=0, simt=0)

    def other():
        for _ in range(7):
            pa._count_launch("simt")

    def step():
        for _ in range(3):     # this thread's launches, on both routes
            pa._count_launch("sm90")
        pa._count_launch("simt")
        if capturing.__dict__.get("on"):
            worker = threading.Thread(target=other)
            worker.start()
            worker.join(timeout=30)
        return "logits"

    captured, out = _graphs.capture(step, [torch.zeros(2)])
    assert out == "logits" and captured.outputs == "logits"
    assert captured.held == {"sm90": 3, "simt": 1}
    # the warm-up's 4 launches and the other thread's 7, nothing else
    assert pa.launches_by_route == {"sm90": 3, "simt": 1 + 7}
    assert pa.launches == 11
    captured.replay()
    assert pa.launches_by_route == {"sm90": 6, "simt": 9}
    assert pa.launches == 15


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_fixed_shape_decode_matches_jax_jit_generate_and_generate(
        cache_dtype):
    """(d) Greedy fp32 ``jit_generate`` (GQA 4 over 2, rope, 3 layers)
    equals JAX's ``jit_generate`` and the port's ``generate`` token for
    token, plain and int8 caches; two calls of one shape stay one cached
    shape, and a second prompt of that shape decodes its own tokens (the
    cache is reloaded, not carried over)."""
    kw = dict(vocab=64, n_layers=3, d_model=32, n_heads=4, n_kv_heads=2,
              seq_len=32, pos="rope")
    jcfg = jgpt.GPTConfig(**kw)
    jp = jgpt.GPT.init(jax.random.PRNGKey(0), jcfg)
    cfg = GPTConfig(**kw)
    params = params_from_jax(jax.device_get(jp), cfg, "cpu")
    rs = np.random.RandomState(2)
    jfn = jgpt.jit_generate(jcfg, n_new=7, temperature=0.0,
                            compute_dtype=jnp.float32, cache_dtype=cache_dtype)
    fn = tgpt.jit_generate(cfg, n_new=7, temperature=0.0,
                           compute_dtype=torch.float32,
                           cache_dtype=cache_dtype)
    for _ in range(2):
        ids = rs.randint(0, 64, (2, 9)).astype(np.int32)
        want = np.asarray(jfn(jp, jnp.asarray(ids), jax.random.PRNGKey(1)))
        got = fn(params, torch.as_tensor(ids).long())
        np.testing.assert_array_equal(got.numpy(), want)
        plain = tgpt.generate(params, torch.as_tensor(ids).long(), cfg,
                              n_new=7, temperature=0.0,
                              compute_dtype=torch.float32,
                              cache_dtype=cache_dtype)
        assert torch.equal(got, plain)
    assert fn._cache_size() == 1


class _Replayed:
    """A stand-in CUDA graph for the CPU: a replay runs the captured step
    again, on the tensors it captured, into the static output."""

    def __init__(self, fn, static):
        self.fn, self.static = fn, static

    def replay(self):
        self.static.copy_(self.fn())


@pytest.mark.parametrize("dtype,captures", [
    (torch.float32, 2), (torch.bfloat16, 1)], ids=["fp32", "bf16_cast"])
def test_jit_generate_graph_route_reads_the_params_it_is_given(
        monkeypatch, dtype, captures):
    """(d) ``jit_generate``'s graph route on the CPU, through a stand-in
    graph: every call returns ``generate``'s ids for the params it was
    given. Params in ``compute_dtype`` are read where the caller keeps
    them (an in-place update reaches the replay; a new tree captures
    again, counted in ``_cache_size()``); fp32 params at bf16 are cast
    into kept buffers, so a new tree of the same shapes replays."""
    def fake_capture(fn, operands):
        out = fn()
        static = fn()
        return _graphs.CapturedStep(_Replayed(fn, static), static,
                                    list(operands),
                                    dict.fromkeys(pa.launches_by_route, 0)), out

    monkeypatch.setattr(_graphs, "capture", fake_capture)
    monkeypatch.setattr(_graphs, "plan_steps",
                        lambda device, collectives=False: (
                            "eager" if collectives else "graph", "stand-in"))
    cfg = GPTConfig(vocab=64, n_layers=2, d_model=32, n_heads=4, seq_len=32)
    params = GPT.init(0, cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    # weights of std 0.1, so that every block steers the picks (at the
    # init's 0.02 each row repeats its last prompt token)
    redraw = lambda t: t.copy_(0.1 * torch.randn(t.shape, generator=g))
    for leaf in (params["wte"]["table"], *(
            params["blocks"][k]["kernel"] for k in (
                "attn_qkv", "attn_proj", "mlp_fc1", "mlp_fc2"))):
        redraw(leaf)
    ids = torch.as_tensor(np.random.RandomState(3).randint(0, 64, (2, 7)))
    kw = dict(n_new=6, temperature=0.0, compute_dtype=dtype)
    fn = tgpt.jit_generate(cfg, **kw)
    want = lambda p: tgpt.generate(p, ids, cfg, **kw)
    first = want(params)
    assert torch.equal(fn(params, ids), first)
    redraw(params["blocks"]["mlp_fc1"]["kernel"])
    redrawn = want(params)
    assert not torch.equal(redrawn, first)
    assert torch.equal(fn(params, ids), redrawn)
    assert fn._cache_size() == 1
    other = tgpt.map_tensors(params, lambda t: t.flip(0).contiguous())
    flipped = want(other)
    assert not torch.equal(flipped, redrawn)
    assert torch.equal(fn(other, ids), flipped)
    assert fn._cache_size() == captures
