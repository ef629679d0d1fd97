"""Port parity: the training slice of ``torchbooster_tpu_torch`` against
the JAX package on the CPU, at a small size (2 layers, d_model 32, 4
heads, vocab 97), inputs and batches from a numpy seed, parameters
crossing through ``interop.params_from_jax``.

- ``cross_entropy`` and ``lm_head_cross_entropy`` (with and without
  label smoothing; a token count the chunk does not divide), values and
  gradients;
- ``GPT.apply`` logits and parameter gradients against ``jax.grad`` of
  the JAX loss at fp32, MHA and GQA, attention through the flash route
  (its plain blocked version here; interpret mode in JAX) and through
  the reference; ``return_hidden`` + the chunked loss against the full
  logits; ``return_aux``;
- ``CycleScheduler`` values and the stateful ``BaseScheduler``;
- ``make_step`` over 10 steps from the same parameters and batches: SGD
  with momentum and weight decay; AdamW + cycle schedule + clip (with
  AGC and decay masking), with and without ``accumulate_every=2`` (and
  the EMA ramp); its ``compute_dtype`` cast and a loss without metrics;
- accuracy and the running averages;
- ``synthetic_lm`` tokens byte-equal and ``DataLoader`` batch order equal
  for the same seed, and a stream dataset's batches; ``Config.load`` of
  ``examples/lm/gpt/gpt.yml`` and of a file that ``#include``s it giving
  the JAX loader's field values;
- the recipe's ``main`` for 3 steps on the CPU; the entry points
  defaulting to the card and the unported options raising.
"""
import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu import utils as jutils
from torchbooster_tpu.config import (
    DatasetConfig as JDatasetConfig,
    OptimizerConfig as JOptimizerConfig,
    SchedulerConfig as JSchedulerConfig,
)
from torchbooster_tpu.data.pipeline import DataLoader as JDataLoader
from torchbooster_tpu.data.sources import resolve_dataset as jax_resolve
from torchbooster_tpu.dataset import Split as JSplit
from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.ops import losses as jlosses
from torchbooster_tpu.scheduler import CycleScheduler as JCycle
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.config import (
    DatasetConfig,
    EnvConfig,
    LoaderConfig,
    OptimizerConfig,
    SchedulerConfig,
)
from torchbooster_tpu_torch.data import DataLoader, resolve_dataset
from torchbooster_tpu_torch.dataset import Split
from torchbooster_tpu_torch.interop import params_from_jax, to_numpy
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
from torchbooster_tpu_torch.ops import losses
from torchbooster_tpu_torch.recipes import gpt as recipe
from torchbooster_tpu_torch.scheduler import CycleScheduler

ROOT = Path(__file__).resolve().parents[1]
GPT_YML = ROOT / "examples" / "lm" / "gpt" / "gpt.yml"
SMALL = dict(vocab=97, n_layers=2, d_model=32, n_heads=4, seq_len=32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _assert_trees_close(got, want, **tol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, err_msg=str(path), **tol)


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    """fp32 both sides, one log-softmax per row: 1e-6."""
    rs = np.random.RandomState(0)
    logits = rs.randn(4, 7, 97).astype(np.float32)
    labels = rs.randint(0, 97, (4, 7)).astype(np.int32)
    want, want_g = jax.value_and_grad(
        lambda x: jlosses.cross_entropy(x, jnp.asarray(labels), smoothing))(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = losses.cross_entropy(x, torch.as_tensor(labels).long(), smoothing)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_lm_head_cross_entropy_matches_jax(smoothing):
    """26 tokens in chunks of 8 (the last one short); fp32 both sides,
    sums in another order: 1e-5."""
    rs = np.random.RandomState(1)
    hidden = rs.randn(2, 13, 32).astype(np.float32)
    table = rs.randn(97, 32).astype(np.float32) * 0.2
    labels = rs.randint(0, 97, (2, 13)).astype(np.int32)
    want, (wg_h, wg_t) = jax.value_and_grad(
        lambda h, t: jlosses.lm_head_cross_entropy(
            h, t, jnp.asarray(labels), smoothing, chunk_size=8),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(table))
    h = torch.tensor(hidden, requires_grad=True)
    t = torch.tensor(table, requires_grad=True)
    got = losses.lm_head_cross_entropy(h, t, torch.as_tensor(labels).long(),
                                       smoothing, chunk_size=8)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(wg_h), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg_t), atol=1e-5,
                               rtol=1e-5)


def test_other_losses_match_jax():
    rs = np.random.RandomState(2)
    a, b = rs.randn(3, 5).astype(np.float32), rs.rand(3, 5).astype(np.float32)
    for name in ("bce_with_logits", "mse_loss", "l2_loss"):
        want = float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(losses, name)(torch.as_tensor(a), torch.as_tensor(b))
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)


# -------------------------------------------------------------- GPT.apply
def _small_model(n_kv_heads):
    jcfg = JCfg(**SMALL, n_kv_heads=n_kv_heads)
    jp = JGPT.init(jax.random.PRNGKey(0), jcfg)
    cfg = GPTConfig(**SMALL, n_kv_heads=n_kv_heads)
    return jp, jcfg, params_from_jax(jax.device_get(jp), cfg, "cpu"), cfg


@pytest.mark.parametrize("impl", ["flash", "reference"])
@pytest.mark.parametrize("n_kv_heads", [0, 2])
def test_gpt_apply_logits_and_grads_match_jax(n_kv_heads, impl):
    """fp32, remat on both sides; attention through the flash route
    (interpret mode in JAX) or the reference. Logits 1e-5; gradients
    1e-5 absolute (entries are O(1e-2) and both sides sum in fp32)."""
    jp, jcfg, tp, cfg = _small_model(n_kv_heads)
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 97, (2, 16)).astype(np.int32)
    labels = rs.randint(0, 97, (2, 16)).astype(np.int32)
    jimpl = "flash_interpret" if impl == "flash" else "reference"

    def jloss(p):
        logits = JGPT.apply(p, jnp.asarray(ids), jcfg,
                            compute_dtype=jnp.float32, remat=True,
                            attn_impl=jimpl)
        return jlosses.cross_entropy(logits, jnp.asarray(labels)), logits

    (want, want_logits), want_g = jax.value_and_grad(jloss, has_aux=True)(jp)
    for p in utils.tree_leaves(tp):
        p.requires_grad_(True)
    logits = GPT.apply(tp, torch.as_tensor(ids).long(), cfg,
                       compute_dtype=torch.float32, remat=True,
                       attn_impl=impl)
    got = losses.cross_entropy(logits, torch.as_tensor(labels).long())
    got.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    _assert_trees_close(to_numpy(utils._tree_map(lambda t: t.grad, tp)),
                        jax.device_get(want_g), atol=1e-5, rtol=1e-4)


def test_return_hidden_chunked_loss_equals_full_logits():
    """The chunked head over ``return_hidden`` computes the full-logits
    loss: same fp32 math in another grouping, 1e-6 on the loss, 1e-6 on
    the gradients."""
    _, _, tp, cfg = _small_model(2)
    rs = np.random.RandomState(4)
    ids = torch.as_tensor(rs.randint(0, 97, (2, 16))).long()
    labels = torch.as_tensor(rs.randint(0, 97, (2, 16))).long()
    results = []
    for chunked in (False, True):
        params = utils._tree_map(lambda t: t.clone().requires_grad_(), tp)
        out = GPT.apply(params, ids, cfg, compute_dtype=torch.float32,
                        return_hidden=chunked)
        loss = losses.lm_head_cross_entropy(
            out, GPT.head_table(params), labels, chunk_size=5) if chunked \
            else losses.cross_entropy(out, labels)
        loss.backward()
        results.append((loss.item(), to_numpy(
            utils._tree_map(lambda t: t.grad, params))))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-6)
    _assert_trees_close(results[1][1], results[0][1], atol=1e-6, rtol=1e-5)


def test_gpt_apply_return_aux_matches_jax():
    """Dense blocks: the MoE load-balance term is 0 on both sides, and
    the logits are the plain forward's (fp32, 1e-5)."""
    jp, jcfg, tp, cfg = _small_model(0)
    ids = np.random.RandomState(7).randint(0, 97, (2, 8)).astype(np.int32)
    want, want_aux = JGPT.apply(jp, jnp.asarray(ids), jcfg,
                                compute_dtype=jnp.float32, return_aux=True)
    got, aux = GPT.apply(tp, torch.as_tensor(ids).long(), cfg,
                         compute_dtype=torch.float32, return_aux=True)
    assert float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_gpt_apply_rejects_dropout_and_overlong_input():
    """An input longer than ``cfg.seq_len`` raises. (Dropout no longer
    raises: ``tests/test_torch_long.py`` holds it to the JAX rule.)"""
    params = GPT.init(0, GPTConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="seq_len"):
        GPT.apply(params, torch.zeros(1, 33).long(), GPTConfig(**SMALL))


# -------------------------------------------------------------- schedules
@pytest.mark.parametrize("decay", [("lin", "cos"), ("cos", "exp"),
                                   ("flat", "lin")])
def test_cycle_scheduler_matches_jax(decay):
    """JAX evaluates in fp32, the port in Python floats: 1e-6 relative,
    and 1e-6·lr absolute for the end of a cos anneal, where JAX's fp32
    ``1 + cos(πt)`` cancels down to a few ulp."""
    kw = dict(lr=3e-4, n_iter=100, warmup=10, plateau=5, decay=decay)
    want, got = JCycle(**kw), CycleScheduler(**kw)
    for step in (0, 1, 5, 9, 10, 12, 15, 16, 50, 99, 100, 150):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-6 * kw["lr"],
                                   err_msg=f"step {step}")
    # the stateful adapter: steps and a state_dict round trip
    from torchbooster_tpu.scheduler import BaseScheduler as JBase
    from torchbooster_tpu_torch.scheduler import BaseScheduler

    jbase, base = JBase(want), BaseScheduler(got)
    for _ in range(12):
        np.testing.assert_allclose(base.step(), jbase.step(), rtol=1e-6,
                                   atol=1e-6 * kw["lr"])
    restored = BaseScheduler(got)
    restored.load_state_dict(base.state_dict())
    assert (restored.step_count, restored.lr) == (base.step_count, base.lr)


# ---------------------------------------------------------------- make_step
def _trajectory(optim, sched, clip, accumulate_every, ema_decay=None,
                n_steps=10, widths=SMALL):
    """10 steps of the JAX and of the port ``make_step`` from the same
    parameters and batches, at ``widths``; returns both loss lists and
    final states."""
    jcfg, cfg = JCfg(**widths), GPTConfig(**widths)
    jp = JGPT.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp), cfg, "cpu")
    rs = np.random.RandomState(5)
    batches = [rs.randint(0, widths["vocab"], (4, 17)).astype(np.int32)
               for _ in range(n_steps)]

    jopt = JOptimizerConfig(**optim)
    jtx = jopt.make(JSchedulerConfig(**sched).make(jopt) if sched else None)

    def jloss(params, batch, rng):
        logits = JGPT.apply(params, batch["ids"], jcfg,
                            compute_dtype=jnp.float32)
        return jlosses.cross_entropy(logits, batch["labels"]), {}

    jstate = jutils.TrainState.create(jp, jtx, rng=0,
                                      accumulate=accumulate_every > 1,
                                      ema=ema_decay is not None)
    jstep = jutils.make_step(jloss, jtx, clip=clip,
                             accumulate_every=accumulate_every,
                             ema_decay=ema_decay)
    opt = OptimizerConfig(**optim)
    tx = opt.make(SchedulerConfig(**sched).make(opt) if sched else None)

    def loss(params, batch, generator):
        logits = GPT.apply(params, batch["ids"], cfg,
                           compute_dtype=torch.float32)
        return losses.cross_entropy(logits, batch["labels"]), {}

    state = utils.TrainState.create(tp, tx, accumulate=accumulate_every > 1,
                                    ema=ema_decay is not None)
    step = utils.make_step(loss, tx, clip=clip,
                           accumulate_every=accumulate_every,
                           ema_decay=ema_decay)
    j_losses, t_losses = [], []
    for b in batches:
        jstate, jm = jstep(jstate, {"ids": jnp.asarray(b[:, :-1]),
                                    "labels": jnp.asarray(b[:, 1:])})
        tb = torch.as_tensor(b).long()
        state, m = step(state, {"ids": tb[:, :-1], "labels": tb[:, 1:]})
        j_losses.append(float(jm["loss"]))
        t_losses.append(m["loss"].item())
    return j_losses, jstate, t_losses, state


def test_make_step_sgd_trajectory_matches_jax():
    """SGD with momentum and weight decay, constant lr: updates are
    linear in the gradients, so fp32 noise stays at its own size:
    losses and parameters 1e-6."""
    jl, jstate, tl, state = _trajectory(
        dict(name="sgd", lr=0.5, momentum=0.9, weight_decay=1e-3), None,
        clip=None, accumulate_every=1)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _assert_trees_close(to_numpy(state.params),
                        jax.device_get(jstate.params), atol=1e-6, rtol=1e-6)
    assert state.step == int(jstate.step) == 10


ADAMW = dict(name="adamw", lr=1e-2, weight_decay=0.1, betas=(0.9, 0.95))
CYCLE = dict(name="cycle", n_iter=10, warmup=3, decay=("lin", "cos"))


@pytest.mark.parametrize("accumulate_every,extra,ema", [
    (1, dict(agc=0.5, decay_matrices_only=True), None),
    (2, {}, 0.9),
])
def test_make_step_adamw_trajectory_matches_jax(accumulate_every, extra,
                                                ema):
    """AdamW + cycle schedule + clip 0.5 (active: the gradient norm is
    above it). Losses 1e-4 relative. Parameters 2e-4 absolute: AdamW
    divides each update by √v, so a gradient entry near zero turns the
    fp32 noise of the two frameworks' sums into an O(lr) difference in
    that entry; 2e-4 is 2% of one lr-sized update."""
    jl, jstate, tl, state = _trajectory(
        {**ADAMW, **extra}, CYCLE, clip=0.5,
        accumulate_every=accumulate_every, ema_decay=ema)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_trees_close(to_numpy(state.params),
                        jax.device_get(jstate.params), atol=2e-4, rtol=0)
    if ema is not None:
        _assert_trees_close(to_numpy(state.ema), jax.device_get(jstate.ema),
                            atol=2e-4, rtol=0)


def test_make_step_casts_inside_and_takes_a_bare_loss():
    """``compute_dtype`` casts parameters and batch inside the
    differentiated function, so a bf16 step updates the fp32 masters;
    ``has_aux=False`` takes a loss without metrics. SGD lr 0.1 on a
    linear model: the bf16 update stays within 1e-3 of the fp32 one
    (bf16 keeps 8 mantissa bits; the update is lr x a gradient of O(1))."""
    rs = np.random.RandomState(8)
    w0 = rs.randn(6, 5).astype(np.float32)
    batch = {"x": torch.as_tensor(rs.randn(16, 6).astype(np.float32)),
             "y": torch.as_tensor(rs.randint(0, 5, 16)).long()}
    tx = OptimizerConfig(name="sgd", lr=0.1).make()

    def loss(params, batch, generator):
        return losses.cross_entropy(batch["x"] @ params["w"], batch["y"])

    out = {}
    for dtype in (None, torch.bfloat16):
        state = utils.TrainState.create({"w": torch.tensor(w0)}, tx)
        step = utils.make_step(loss, tx, compute_dtype=dtype, has_aux=False)
        state, metrics = step(state, batch)
        assert set(metrics) == {"loss"} and state.step == 1
        assert state.params["w"].dtype == torch.float32
        out[dtype] = state.params["w"].detach().numpy()
    assert np.abs(out[None] - w0).max() > 1e-2       # the step moved w
    np.testing.assert_allclose(out[torch.bfloat16], out[None], atol=1e-3,
                               rtol=0)


# ------------------------------------------------------------------ metrics
def test_metrics_match_jax():
    """Accuracy (top-1 and top-3) and the running averages: exact up to
    fp32 rounding of the means, 1e-6."""
    from torchbooster_tpu import metrics as jmetrics
    from torchbooster_tpu_torch import metrics

    rs = np.random.RandomState(9)
    logits = rs.randn(12, 7).astype(np.float32)
    labels = rs.randint(0, 7, 12).astype(np.int32)
    for topk in (1, 3):
        want = float(jmetrics.Accuracy(topk)(jnp.asarray(logits),
                                              jnp.asarray(labels)))
        got = metrics.Accuracy(topk)(torch.as_tensor(logits),
                                     torch.as_tensor(labels).long())
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    jacc, acc = jmetrics.MetricsAccumulator(), metrics.MetricsAccumulator()
    for i, value in enumerate(rs.rand(40).astype(np.float32)):
        jacc.update({"loss": jnp.asarray(value)}, weight=1 + i % 3)
        acc.update({"loss": torch.as_tensor(value)}, weight=1 + i % 3)
    np.testing.assert_allclose(acc.compute()["loss"],
                               jacc.compute()["loss"], rtol=1e-6)
    acc.reset()
    assert acc.compute() == {}


# --------------------------------------------------------------------- data
def test_synthetic_lm_and_loader_order_match_jax():
    for split, jsplit in ((Split.TRAIN, JSplit.TRAIN),
                          (Split.VALIDATION, JSplit.VALIDATION)):
        port = resolve_dataset(DatasetConfig(name="synthetic_lm",
                                             n_examples=64), split,
                               seq_len=33, vocab=97)
        ref = jax_resolve(JDatasetConfig(name="synthetic_lm",
                                         n_examples=64), jsplit,
                          seq_len=33, vocab=97)
        assert port.arrays[0].tobytes() == ref.arrays[0].tobytes()
    loader = DataLoader(port, batch_size=5, shuffle=True, seed=3)
    jloader = JDataLoader(ref, batch_size=5, shuffle=True, seed=3)
    assert len(loader) == len(jloader) == 1         # 8 rows, drop_last
    for _ in range(3):                               # seed + epoch reshuffle
        got, want = list(loader), list(jloader)
        assert [b.tobytes() for b in got] == [b.tobytes() for b in want]
    # a name no link of the chain answers exits, as the JAX chain does
    with pytest.raises(SystemExit):
        resolve_dataset(DatasetConfig(name="coco"), "train")


def test_stream_loader_and_collate_match_jax():
    """A stream dataset of dict examples, with and without ``drop_last``:
    the same batches, keys and counts as the JAX loader."""
    from torchbooster_tpu.dataset import IterableDataset as JIterable
    from torchbooster_tpu_torch.dataset import IterableDataset

    rows = np.arange(22, dtype=np.int32).reshape(11, 2)

    def stream(base):
        class Stream(base):
            def __iter__(self):
                for i, r in enumerate(rows):
                    yield {"x": r, "pair": (i, -i)}
        return Stream()

    for drop_last in (True, False):
        got = list(DataLoader(stream(IterableDataset), batch_size=4,
                              drop_last=drop_last))
        want = list(JDataLoader(stream(JIterable), batch_size=4,
                                drop_last=drop_last))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for g, w in zip(got, want):
            assert g.keys() == w.keys() == {"x", "pair"}
            np.testing.assert_array_equal(g["x"], w["x"])
            for gp, wp in zip(g["pair"], w["pair"]):
                np.testing.assert_array_equal(gp, wp)


# ------------------------------------------------------------------ config
def _jax_recipe(monkeypatch):
    directory = GPT_YML.parent
    monkeypatch.chdir(directory)
    spec = importlib.util.spec_from_file_location("jax_example_lm_gpt",
                                                  directory / "gpt.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def test_config_load_matches_jax(monkeypatch, tmp_path):
    jgpt = _jax_recipe(monkeypatch)
    want = dataclasses.asdict(jgpt.Config.load(GPT_YML))
    got = dataclasses.asdict(recipe.Config.load(GPT_YML))
    # the port's recipe also takes a comms: block, which the JAX example
    # has no field for; gpt.yml has none
    assert got.pop("comms") is None
    assert got == want
    assert got["optim"]["lr"] == 3e-4 and got["optim"]["betas"] == (0.9, 0.95)
    assert got["scheduler"]["decay"] == ("lin", "cos")
    assert got["model"]["vocab"] == 1024
    included = tmp_path / "more.yml"
    included.write_text(f"#include {GPT_YML}\neval_batches: 3\n")
    got = dataclasses.asdict(recipe.Config.load(included))
    assert got.pop("comms") is None
    assert got == dataclasses.asdict(jgpt.Config.load(included))
    assert got["eval_batches"] == 3 and got["n_iter"] == 2000


# ------------------------------------------------------------------ recipe
def _tiny_conf(n_iter=3):
    return recipe.Config(
        n_iter=n_iter, seed=42, clip=1.0, accumulate_every=1, log_every=1,
        save_every=0, checkpoint_root="checkpoints",
        model=recipe.ModelConfig(vocab=97, n_layers=2, d_model=32,
                                 n_heads=4, seq_len=32, chunked_head=True),
        env=EnvConfig(precision="bf16"), loader=LoaderConfig(batch_size=4),
        optim=OptimizerConfig(**ADAMW),
        scheduler=SchedulerConfig(name="cycle", n_iter=n_iter, warmup=1,
                                  decay=("lin", "cos")),
        dataset=DatasetConfig(name="synthetic_lm", n_examples=64),
        sample_tokens=4, eval_batches=1)


def test_recipe_main_runs_on_the_cpu():
    res = recipe.main(_tiny_conf(), device="cpu")
    losses_ = [r["loss"] for r in res["log"]]
    assert len(losses_) == 3 and all(map(math.isfinite, losses_))
    assert math.isfinite(res["val_loss"])
    assert len(res["sample"]) == 8 + 4 and all(0 <= t < 97
                                               for t in res["sample"])


def test_entry_points_default_to_the_card_and_unported_options_raise():
    conf = _tiny_conf()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            recipe.setup(conf)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            EnvConfig().device()
    # meshes over dp and fsdp are ported (tests/test_torch_distributed.py),
    # sp and ep too (tests/test_torch_sequence.py, tests/test_torch_moe.py),
    # tp and pp too (tests/test_torch_tensor_parallel.py,
    # tests/test_torch_pipeline.py): at world 1 a size of 2 is JAX's
    # device-count error
    with pytest.raises(ValueError, match="devices"):
        EnvConfig(distributed=True, mesh="dp,tp:2").device("cpu")
    with pytest.raises(ValueError, match="devices"):
        EnvConfig(distributed=True, mesh="dp,pp:2").device("cpu")
    assert EnvConfig(distributed=True).device("cpu") == torch.device("cpu")
    assert EnvConfig(distributed=True, mesh="dp,sp:1,ep:1").device(
        "cpu") == torch.device("cpu")
    # MoE blocks are ported: the recipe takes n_experts
    moe_conf = _tiny_conf(n_iter=1)
    moe_conf.model.n_experts, moe_conf.sample_tokens = 2, 0
    moe_conf.eval_batches = 0
    res = recipe.main(moe_conf, device="cpu")
    assert math.isfinite(res["loss"]) and res["aux"] >= 0.9
    # lamb, lion and adafactor are ported (tests/test_torch_optim.py)
    for name in ("lamb", "lion", "adafactor"):
        tx = OptimizerConfig(name=name).make()
        assert isinstance(tx.init({"w": torch.zeros(2, 2)}),
                          torch.optim.Optimizer)
    # loader workers are ported (tests/test_torch_data_path.py)
    loader = LoaderConfig(batch_size=2, num_workers=2).make([0, 1],
                                                            shuffle=False)
    assert loader.num_workers == 2 and [b.tolist() for b in loader] == \
        [[0, 1]]
    from torchbooster_tpu_torch.distributed import Mesh

    tp = Mesh(axis_names=("dp", "tp"), sizes=(1, 2),
              device=torch.device("cpu"))
    assert callable(utils.make_step(lambda *a: None, None, mesh=tp,
                                    rules=[(r".*", ())]))
    # what still raises raises with JAX's message: tp > 1 serving with
    # n_replicas > 1 from YAML
    from torchbooster_tpu_torch.config import ServingConfig

    conf = ServingConfig.from_dict({"tp": 2, "page_size": 4,
                                    "router": {"n_replicas": 2}})
    with pytest.raises(ValueError, match="not buildable from YAML"):
        conf.make({}, recipe.ModelConfig(vocab=97, n_layers=2, d_model=32,
                                         n_heads=4, seq_len=32).make(),
                  device="cpu", mesh=tp)
    sp_ep = Mesh(axis_names=("sp", "ep"), sizes=(2, 2),
                 device=torch.device("cpu"))
    assert callable(utils.make_step(lambda *a: None, None, mesh=sp_ep,
                                    rules=[(r".*", ())]))
