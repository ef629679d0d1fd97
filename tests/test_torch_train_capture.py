"""The captured train step on the CPU: what a CUDA-graph capture of
``utils.make_step``'s single-card step rests on, at a small size (2
layers, d_model 32, one torch thread).

- (a) the plan (``step.plan``): the CPU and a step on a mesh or with a
  ``comms`` schedule are eager, each with its reason; a card with
  neither plans ``"graph"``;
- (b) through a dispatch mode: every tensor a replay of the step reads
  is one of its operands (the staged batch, the parameters, the
  gradient buffers, the optimizer's state and lr, the EMA and its decay
  scalars), and each keeps its ``data_ptr`` across steps, lr changes, an
  accumulation boundary, the EMA and a ``load_state_dict``;
- (c) no host read inside the step body (``aten._local_scalar_dense``,
  ``is_nonzero``, ``equal``) for sgd, adam, adamw, lamb, lion and
  adafactor, with clip, agc, ``accumulate_every`` 2 and the EMA;
- (d) 3-update trajectories of sgd (momentum, nesterov, weight decay),
  adam, adamw (accumulation over 2, the EMA), lamb and adafactor in the
  form the card runs on the graph route (a device lr, capturable Adam
  and AdamW, the device counts and fp32 corrections) against JAX
  ``make_step``, run as the JAX suite runs it;
- (e) the graph route's bookkeeping: distinct metric tensors each step,
  one capture over a run (``RecompileSentinel``), two with accumulation,
  a new one for a new batch shape, another after a ``load_state_dict``
  that replaced the optimizer's state; the replays take the eager twin's
  steps bit for bit;
- (f) B1-B3 and B5-B8 launches under a capture go to its tally, not to
  the counters, and a replay adds them by counter and route.

The graph route runs on a stand-in graph: the capture runs the step once
(the warm-up, as on the card), and a replay runs it again on the tensors
it captured, writing the static outputs, under a dispatch mode that sees
what it reads. torch's capturable Adam is run on the CPU by widening its
device check, so that the CPU runs the optimizer code the card runs. The
captures themselves run on the card (``tests/test_torch_cuda.py``).
"""
import contextlib
import importlib
from collections import Counter
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from tests.test_torch_train import _assert_trees_close, _trajectory
from torchbooster_tpu_torch import _graphs, utils
from torchbooster_tpu_torch.config import OptimizerConfig, SchedulerConfig
from torchbooster_tpu_torch.interop import to_numpy
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
from torchbooster_tpu_torch.observability.recompile import (
    RecompileError,
    RecompileSentinel,
)
from torchbooster_tpu_torch.ops import flash_attention as fa
from torchbooster_tpu_torch.ops import fused_block as fb
from torchbooster_tpu_torch.ops import group_norm as gn
from torchbooster_tpu_torch.ops import launch_tally, losses

pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

CFG = GPTConfig(vocab=64, n_layers=2, d_model=32, n_heads=4, seq_len=16)
HOST_READS = {torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.is_nonzero.default,
              torch.ops.aten.equal.default}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _Reads(TorchDispatchMode):
    """The storages a region reads that it did not make itself, and the
    ops of it that read a value back to the host."""

    def __init__(self):
        super().__init__()
        self.made, self.read, self.host = set(), set(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in HOST_READS:
            self.host.append(str(func))
        if func is torch.ops.aten.lift_fresh.default:
            # a constant the region made (``torch.tensor(1.0)``)
            self.made.add(_storage(args[0]))
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and t.numel() \
                    and _storage(t) not in self.made:
                self.read.add(_storage(t))
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.numel():
                self.made.add(_storage(t))
        return out


class _Replayed:
    """A stand-in CUDA graph for the CPU: a replay runs the captured step
    again on what it captured and writes the static outputs."""

    def __init__(self, fn, static):
        self.fn, self.static, self.seen = fn, static, []

    def replay(self):
        with _Reads() as seen:
            out = self.fn()
        self.seen.append(seen)
        for k, v in out.items():
            if isinstance(v, torch.Tensor):
                self.static[k].copy_(v)

    def pool(self):
        return None


@pytest.fixture
def graph_route(monkeypatch):
    """Plan ``"graph"`` on the CPU (eager with collectives, as on the
    card), capture through the stand-in; returns the captured steps."""
    made = []

    def capture(fn, operands, generators=(), pool=None):
        out = fn()
        static = {k: v.clone() if isinstance(v, torch.Tensor) else v
                  for k, v in out.items()}
        listed = operands() if callable(operands) else operands
        step = _graphs.CapturedStep(_Replayed(fn, static), static,
                                    list(listed), Counter())
        made.append(step)
        return step, out

    monkeypatch.setattr(_graphs, "capture", capture)
    monkeypatch.setattr(_graphs, "plan_steps",
                        lambda device, collectives=False: (
                            "eager" if collectives else "graph", "stand-in"))
    widened = lambda supports_xla=True: ["cuda", "cpu"]
    for mod in (importlib.import_module("torch.optim.adam"),
                importlib.import_module("torch.optim.optimizer")):
        monkeypatch.setattr(mod, "_get_capturable_supported_devices",
                            widened)
    return made


def _batches(n: int, rows: int = 2, seed: int = 0) -> list:
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = torch.as_tensor(rs.randint(0, CFG.vocab,
                                       (rows, CFG.seq_len + 1))).long()
        out.append({"ids": t[:, :-1], "labels": t[:, 1:]})
    return out


def _loss(params, batch, generator):
    logits = GPT.apply(params, batch["ids"], CFG,
                       compute_dtype=torch.float32, generator=generator)
    loss = losses.cross_entropy(logits, batch["labels"])
    return loss, {"ppl": torch.exp(loss.detach())}


def _trainer(name="adamw", accumulate_every=1, ema_decay=None, agc=0.0,
             clip=1.0, **opt):
    conf = OptimizerConfig(name=name, lr=1e-2, agc=agc, **opt)
    tx = conf.make(SchedulerConfig(name="cycle", n_iter=8, warmup=2).make(
        conf))
    state = utils.TrainState.create(
        GPT.init(0, CFG, device="cpu"), tx, accumulate=accumulate_every > 1,
        ema=ema_decay is not None)
    step = utils.make_step(_loss, tx, clip=clip,
                           accumulate_every=accumulate_every,
                           ema_decay=ema_decay)
    return state, step


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("device,kind,route,reason", [
    ("cpu", None, "eager", "CPU"),
    ("cuda", "mesh", "eager", "process group"),
    ("cuda", "comms", "eager", "process group"),
    ("cuda", None, "graph", "captured once"),
])
def test_plan_decides_from_device_and_configuration(device, kind, route,
                                                    reason):
    """(a) A step's plan from its device and configuration alone: the
    CPU is eager, a step on a mesh (a process group) or with a ``comms``
    schedule is eager, a card with neither captures. No card is needed
    to ask."""
    kw = {}
    if kind == "mesh":
        kw["mesh"] = SimpleNamespace(distributed=True)
    if kind == "comms":
        kw["comms"] = SimpleNamespace(mode="implicit", zero1=False, stage=0,
                                      mesh=None)
    step = utils.make_step(_loss, OptimizerConfig().make(), **kw)
    got, why = step.plan(torch.device(device))
    assert got == route and reason in why
    # a mesh of one process without a group holds nothing to sync
    solo = utils.make_step(_loss, OptimizerConfig().make(),
                           mesh=SimpleNamespace(distributed=False))
    assert solo.plan(torch.device("cuda"))[0] == "graph"


# ------------------------------------------------------------------ (b)
def test_replays_read_only_their_operands_which_stay_put(graph_route):
    """(b) AdamW with clip, accumulation over 2 and the EMA: each
    replay reads only the operands its capture listed, and every operand
    keeps its address over 8 steps (4 boundaries, an lr that moves each
    update) and a ``load_state_dict`` of an earlier state (in place: no
    new capture)."""
    state, step = _trainer("adamw", accumulate_every=2, ema_decay=0.9,
                           weight_decay=0.1)
    batches = _batches(10)
    saved = None
    ptrs = {}
    for i, batch in enumerate(batches):
        state, _ = step(state, batch)
        if i == 3:
            saved = {k: v for k, v in state.state_dict().items()}
            saved = _copy(saved)
        if i == 7:
            state.load_state_dict(saved)
            assert state.step == 4 and state.loads == 0
        for key, entry in step.graphs.steps.items():
            now = [t.data_ptr() for t in entry._operands]
            assert ptrs.setdefault(key, now) == now
    assert step._cache_size() == 2 and len(graph_route) == 2
    for entry in graph_route:
        listed = {_storage(t) for t in entry._operands}
        assert entry.graph.seen, "the step never replayed"
        for seen in entry.graph.seen:
            assert seen.read <= listed, seen.read - listed
    boundary = step.graphs.steps[(True, next(iter(step.graphs.staged)))]
    lrs = [g["lr"] for g in state.optimizer.param_groups]
    assert all(isinstance(lr, torch.Tensor) for lr in lrs)
    assert {_storage(lr) for lr in lrs} <= {_storage(t)
                                            for t in boundary._operands}


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


# ------------------------------------------------------------------ (c)
@pytest.mark.parametrize("name,opt", [
    ("sgd", dict(momentum=0.9, nesterov=True, weight_decay=1e-3)),
    ("adam", dict()),
    ("adamw", dict(weight_decay=0.1, amsgrad=True)),
    ("lamb", dict(weight_decay=0.1)),
    ("lion", dict(weight_decay=0.1)),
    ("adafactor", dict()),
])
def test_step_body_reads_nothing_back_to_the_host(graph_route, name, opt):
    """(c) The step body (what the graph holds) with clip, agc,
    accumulation over 2 and the EMA reads no value back to the host in
    any optimizer; the update counts lie with the parameters."""
    state, step = _trainer(name, accumulate_every=2, ema_decay=0.9,
                           agc=0.05, **opt)
    for batch in _batches(6):
        state, _ = step(state, batch)
    assert step._cache_size() == 2
    for entry in graph_route:
        assert entry.graph.seen
        for seen in entry.graph.seen:
            assert seen.host == [], seen.host
    for entry in state.optimizer.state.values():
        assert all(v.device.type == "cpu" for v in entry.values()
                   if isinstance(v, torch.Tensor))
        if name not in ("sgd",):
            assert float(entry["step"]) == 3


# ------------------------------------------------------------------ (d)
CYCLE3 = dict(name="cycle", n_iter=3, warmup=1, decay=("lin", "cos"))
# test_torch_train's bounds for each update rule: SGD's updates are
# linear in the gradients (1e-6); the adaptive ones divide by a root of
# their second moment, so fp32 noise of the two frameworks' sums turns
# into an O(lr) difference in an entry whose gradient is near zero
# (losses 1e-4 relative, parameters 2e-4 absolute)
SGD_TOL = dict(loss_rtol=1e-6, atol=1e-6, rtol=1e-6)
ADAPTIVE_TOL = dict(loss_rtol=1e-4, atol=2e-4, rtol=0)


@pytest.mark.parametrize("optim,sched,clip,accumulate_every,ema,tol", [
    (dict(name="sgd", lr=0.5, momentum=0.9, nesterov=True,
          weight_decay=1e-3), None, None, 1, None, SGD_TOL),
    (dict(name="adam", lr=1e-2, betas=(0.9, 0.95)), CYCLE3, 0.5, 1, None,
     ADAPTIVE_TOL),
    (dict(name="adamw", lr=1e-2, weight_decay=0.1, betas=(0.9, 0.95)),
     CYCLE3, 0.5, 2, 0.9, ADAPTIVE_TOL),
    (dict(name="lamb", lr=1e-2, weight_decay=0.1), CYCLE3, 0.5, 1, None,
     ADAPTIVE_TOL),
    (dict(name="adafactor", lr=1e-2), CYCLE3, 0.5, 1, None, ADAPTIVE_TOL),
], ids=["sgd", "adam", "adamw", "lamb", "adafactor"])
def test_graph_route_trajectory_matches_jax(graph_route, optim, sched, clip,
                                            accumulate_every, ema, tol):
    """(d) 3 updates on the graph route, in the optimizer form the card
    runs there (an lr scalar on the parameters' device; torch's Adam and
    AdamW capturable; SGD's own update with momentum, nesterov and
    weight decay; lamb's and adafactor's count on the parameters' device
    with their bias correction and decay computed there in fp32), from
    JAX's parameters and batches, against JAX ``make_step``; AdamW with
    accumulation over 2 and the EMA. Bounds: ``SGD_TOL`` and
    ``ADAPTIVE_TOL``."""
    n_steps = 3 * accumulate_every
    jl, jstate, tl, state = _trajectory(
        optim, sched, clip=clip, accumulate_every=accumulate_every,
        ema_decay=ema, n_steps=n_steps)
    np.testing.assert_allclose(tl, jl, rtol=tol["loss_rtol"])
    _assert_trees_close(to_numpy(state.params),
                        jax.device_get(jstate.params), atol=tol["atol"],
                        rtol=tol["rtol"])
    if ema is not None:
        _assert_trees_close(to_numpy(state.ema), jax.device_get(jstate.ema),
                            atol=tol["atol"], rtol=tol["rtol"])
    assert len(graph_route) == accumulate_every
    assert sum(g.replays for g in graph_route) == n_steps - accumulate_every
    assert state.step == int(jstate.step) == n_steps
    for group in state.optimizer.param_groups:
        assert isinstance(group["lr"], torch.Tensor)
        assert group.get("capturable", True)
    if optim["name"] != "sgd":
        counts = {float(e["step"]) for e in state.optimizer.state.values()}
        assert counts == {3.0}


# ------------------------------------------------------------------ (e)
def test_graph_route_keeps_one_capture_and_the_eager_steps(graph_route):
    """(e) Six steps on the graph route against the eager twin from the
    same start: losses and parameters bit for bit, a metric tensor of
    its own each step, one capture (the sentinel budgets one); a new
    batch shape captures again; a ``load_state_dict`` that replaces the
    optimizer's state (one saved before any update) drops the graphs."""
    batches = _batches(6)
    graph, step = _trainer("adamw", ema_decay=0.9, weight_decay=0.1)
    eager, twin = _trainer("adamw", ema_decay=0.9, weight_decay=0.1)
    fresh = _copy(graph.state_dict())
    seen, sentinel = [], RecompileSentinel(step, on_recompile="raise",
                                           expected=1)
    with sentinel:
        for batch in batches:
            graph, m = step(graph, batch)
            with _graphs.eager_steps():
                eager, e = twin(eager, batch)
            assert torch.equal(m["loss"], e["loss"])
            seen.append(m["loss"])
    assert sentinel.extra == 0 and step._cache_size() == 1
    assert len({t.data_ptr() for t in seen}) == len(seen)
    assert [t.item() for t in seen] == [float(x) for x in seen]
    for p, q in zip(utils.tree_leaves(graph.params),
                    utils.tree_leaves(eager.params), strict=True):
        assert torch.equal(p, q)
    for p, q in zip(utils.tree_leaves(graph.ema),
                    utils.tree_leaves(eager.ema), strict=True):
        assert torch.equal(p, q)
    assert twin._cache_size() == 0 and step.graphs.replays == 5
    with pytest.raises(RecompileError):
        with RecompileSentinel(step, on_recompile="raise"):
            step(graph, _batches(1, rows=3)[0])
    assert step._cache_size() == 2
    lrs = [g["lr"] for g in graph.optimizer.param_groups]
    graph.load_state_dict(fresh)
    assert graph.loads == 1 and not graph.optimizer.state
    # the groups keep their live lr scalars (a saved one lies on the host)
    assert all(g["lr"] is lr for g, lr in zip(graph.optimizer.param_groups,
                                              lrs))
    for batch in batches[:3]:
        graph, _ = step(graph, batch)
    assert step._cache_size() == 3 and len(step.graphs.steps) == 1


def test_accumulation_takes_two_graphs(graph_route):
    """(e) With ``accumulate_every`` 2 the micro-step and the boundary
    step are one graph each over eight steps; between boundaries the
    leaves' ``.grad`` hold the running sum, after one they are None, as
    in the eager twin, whose steps the replays take bit for bit."""
    graph, step = _trainer("lion", accumulate_every=2, weight_decay=0.1)
    eager, twin = _trainer("lion", accumulate_every=2, weight_decay=0.1)
    for i, batch in enumerate(_batches(8)):
        graph, m = step(graph, batch)
        with _graphs.eager_steps():
            eager, e = twin(eager, batch)
        assert torch.equal(m["loss"], e["loss"])
        for p, q in zip(utils.tree_leaves(graph.params),
                        utils.tree_leaves(eager.params), strict=True):
            assert torch.equal(p, q)
            if i % 2:
                assert p.grad is None and q.grad is None
            else:
                assert torch.equal(p.grad, q.grad)
    assert step._cache_size() == 2 and step.graphs.replays == 6


def test_step_takes_its_optimizer_into_the_graph_form(graph_route):
    """The optimizer ``tx.init`` builds is torch's (float lr, AdamW not
    capturable), as for any route; the step's first call on a graph
    route puts it in the graph form in place (lr scalars on the
    parameters' device, AdamW capturable with its counts there), and the
    same step inside ``eager_steps()`` does too. A step with collectives
    leaves it as built. A batch on another device than the parameters
    is refused."""
    for eager in (False, True):
        state, step = _trainer("adamw")
        groups = state.optimizer.param_groups
        assert all(isinstance(g["lr"], float) and not g["capturable"]
                   for g in groups)
        with _graphs.eager_steps() if eager else contextlib.nullcontext():
            state, _ = step(state, _batches(1)[0])
        assert all(isinstance(g["lr"], torch.Tensor) and g["capturable"]
                   and g["foreach"] for g in groups)
        assert step._cache_size() == (0 if eager else 1)
    state, _ = _trainer("adamw")
    mesh_step = utils.make_step(_loss, OptimizerConfig(
        name="adamw", lr=1e-2).make(), clip=1.0,
        comms=SimpleNamespace(mode="implicit", zero1=False, stage=0,
                              mesh=None))
    assert mesh_step.plan(torch.device("cpu"))[0] == "eager"
    state, _ = mesh_step(state, _batches(1)[0])
    assert all(isinstance(g["lr"], float) and not g["capturable"]
               for g in state.optimizer.param_groups)
    assert all(e["step"].device.type == "cpu"
               for e in state.optimizer.state.values())
    with pytest.raises(ValueError, match="parameters' device"):
        utils._signature({"ids": torch.zeros(2, device="meta")},
                         torch.device("cpu"))


# ------------------------------------------------------------------ (f)
class _FakeLib:
    """Every kernel entry point of a library launches nothing and
    returns CUDA's success."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def fake_launches(monkeypatch):
    """B1-B3 and B5-B8's wrappers on CPU tensors, down to their count
    sites: the checks and the libraries stand in, the counters are
    restored after."""
    lib = lambda *args: _FakeLib()
    for mod in (fa, gn):
        for name in ("_lib", "_lib_sm90"):
            monkeypatch.setattr(mod, name, lib)
        monkeypatch.setattr(mod, "_lib_fwd_sm90", lib)
        monkeypatch.setattr(mod, "_check_cuda", lambda *a, **k: None)
        monkeypatch.setattr(mod, "_stream", lambda t: 0)
    monkeypatch.setattr(fb, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(fb, "_launch", lambda *a: (None, None, None))
    monkeypatch.setattr(fb, "_launch_sm90", lambda *a: (None, None, None))
    names = {fa: ("launches_fwd", "launches_dq", "launches_dkv",
                  "launches_fwd_by_route", "launches_dq_by_route",
                  "launches_dkv_by_route", "launches_fwd_by_mask"),
             gn: ("launches_fwd", "launches_bwd", "launches_fwd_by_route",
                  "launches_bwd_by_route"),
             fb: ("launches_1x1", "launches_3x3", "launches_1x1_by_route",
                  "launches_3x3_by_route")}
    saved = {(m, n): _copy(getattr(m, n)) if isinstance(getattr(m, n), dict)
             else getattr(m, n) for m, ns in names.items() for n in ns}
    for (m, n), v in saved.items():
        if isinstance(v, dict):
            getattr(m, n).update(dict.fromkeys(v, 0))
        else:
            setattr(m, n, 0)
    yield
    for (m, n), v in saved.items():
        if isinstance(v, dict):
            getattr(m, n).update(v)
        else:
            setattr(m, n, v)


def _launch_all():
    """One launch of each wrapper: B1-B3 on both flash routes' operands
    (bf16 at D 64: ``"sm90"``; fp32: ``"f32"``), B5/B6 (fp32:
    ``"two_pass"``), B7/B8 (fp32: ``"f32"``)."""
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(2, 64, 64, dtype=dtype)
        lse = torch.zeros(2, 64)
        fa.launch_fwd(q, q, q, True, 0.125)
        fa.launch_dq(q, q, q, q, lse, q, True, 0.125)
        fa.launch_dkv(q, q, q, lse, q, lse, True, 0.125)
    x = torch.zeros(2, 4, 4, 8)
    c = torch.zeros(8)
    gn.launch_fwd(x, c, c, 2)
    gn.launch_bwd(x, x, torch.zeros(2, 2, 8), c, c, 2)
    fb.launch_1x1(x, torch.zeros(1, 1, 8, 8), c, c, 2)
    fb.launch_3x3(x, torch.zeros(3, 3, 8, 8), c, c, 2)


def test_kernel_launches_under_a_capture_count_on_each_replay(
        fake_launches, monkeypatch):
    """(f) Under a capture the wrappers of B1-B3 and B5-B8 count into the
    tally of the stream being captured (a captured backward launches
    from autograd's thread on that stream) and leave the counters alone;
    each replay adds the tally, by counter and route; outside a capture
    a launch counts at once."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    capturing, other = (SimpleNamespace(cuda_stream=n) for n in (7, 8))
    current = capturing
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: current)
    with launch_tally.capture_tally(capturing) as held:
        _launch_all()
    assert (fa.launches_fwd, gn.launches_fwd, fb.launches_1x1) == (0, 0, 0)
    assert launch_tally.by_key(held, fa.__name__, "launches_fwd_by_route") \
        == {"sm90": 1, "f32": 1}
    assert launch_tally.by_key(held, gn.__name__, "launches_bwd_by_route") \
        == {"two_pass": 1}
    assert launch_tally.by_key(held, fb.__name__, "launches_3x3_by_route") \
        == {"f32": 1}
    assert not launch_tally.by_key(held, pa.__name__, "launches_by_route")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)

    class _Graph:
        def replay(self):
            pass

    step = _graphs.CapturedStep(_Graph(), None, [], held)
    for _ in range(3):
        step.replay()
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == (6, 6, 6)
    for counts in (fa.launches_fwd_by_route, fa.launches_dq_by_route,
                   fa.launches_dkv_by_route):
        assert counts == {"sm90": 3, "mma_sync": 0, "f32": 3}
    assert fa.launches_fwd_by_mask == {"causal": 6, "full": 0}
    assert (gn.launches_fwd, gn.launches_bwd) == (3, 3)
    assert gn.launches_fwd_by_route == {"one_pass": 0, "two_pass": 3}
    assert (fb.launches_1x1, fb.launches_3x3) == (3, 3)
    assert fb.launches_1x1_by_route["f32"] == 3
    _launch_all()
    assert (fa.launches_fwd, gn.launches_bwd, fb.launches_3x3) == (8, 4, 4)
    # a capture with no tally open on its stream (a timing harness's,
    # or another stream's while one is open) counts nothing
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    _launch_all()
    current = other
    with launch_tally.capture_tally(capturing) as held:
        _launch_all()
    assert not held
    assert (fa.launches_fwd, gn.launches_bwd, fb.launches_3x3) == (8, 4, 4)
