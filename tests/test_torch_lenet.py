"""Port parity: LeNet (``models/lenet.py``) and the lenet recipe
(``recipes/lenet.py``) against the JAX package and its recipe
``examples/img_cls/lenet/lenet.py`` on the CPU. Inputs are made once
with numpy from a seed and fed to both; fp32 throughout.

- LeNet's logits and every parameter gradient from the same parameters
  (1e-4), and the JAX suite's shape and gradient-flow checks
  (``tests/test_models.py:17``, ``:25``) on the port's own init;
- a 5-step ``make_step`` trajectory of the recipe's loss and optimizer
  (``lenet.yml``'s AdamW and cycle schedule) against JAX's;
- ``Config.load`` of ``lenet.yml`` field by field against the JAX
  recipe's; the recipe's ``main`` on the CPU (no kernel launch, ``n_iter:
  0`` resolved to epochs × steps); ``lenet-sweep.yml`` running one
  ``main`` a point (JAX ``tests/test_examples.py:65``).

The recipe across ranks is in ``tests/test_torch_image_ranks.py``."""
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
    OptimizerConfig as JOptimizerConfig,
    SchedulerConfig as JSchedulerConfig,
)
from torchbooster_tpu.models.lenet import LeNet as JLeNet
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.config import OptimizerConfig, SchedulerConfig
from torchbooster_tpu_torch.interop import tensor_from_numpy, to_numpy
from torchbooster_tpu_torch.models import LeNet
from torchbooster_tpu_torch.ops import group_norm as gn
from torchbooster_tpu_torch.recipes import lenet as recipe

ROOT = Path(__file__).resolve().parents[1]
LENET_DIR = ROOT / "examples" / "img_cls" / "lenet"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _from_jax(tree):
    if isinstance(tree, dict):
        return {k: _from_jax(v) for k, v in tree.items()}
    return tensor_from_numpy(tree, "cpu")


def _jax_recipe(monkeypatch):
    monkeypatch.chdir(LENET_DIR)
    spec = importlib.util.spec_from_file_location("jax_example_lenet",
                                                  LENET_DIR / "lenet.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(JLeNet.init(jax.random.PRNGKey(0)))


# conv biases ahead of a GroupNorm of one channel a group: the norm takes
# any per-channel constant out, so their exact gradient is 0 and both
# sides hold fp32 noise there
ZERO_GRAD = {("conv1", "bias"), ("conv2", "bias")}


def test_lenet_apply_and_grads_match_jax(jparams):
    """Logits and the gradient of every leaf of a squared-logit loss:
    1e-4 relative plus 1e-4 of the leaf's largest entry (five layers of
    fp32 sums in another order, and the tanh GELU on both sides); the
    conv biases, whose exact gradient is 0, within 1e-6 of the largest
    gradient entry of the model."""
    x = np.random.RandomState(1).randn(3, 28, 28, 1).astype(np.float32)

    def jloss(p):
        logits = JLeNet.apply(p, jnp.asarray(x))
        return (logits ** 2).sum(), logits

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = _from_jax(jparams)
    for p in utils.tree_leaves(params):
        p.requires_grad_(True)
    before = (gn.launches_fwd, gn.launches_bwd)
    got = LeNet.apply(params, torch.as_tensor(x))
    (got ** 2).sum().backward()
    assert (gn.launches_fwd, gn.launches_bwd) == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    grads = dict(_leaves(to_numpy(utils._tree_map(lambda t: t.grad,
                                                  params))))
    want_leaves = dict(_leaves(jax.device_get(want_g)))
    assert grads.keys() == want_leaves.keys()
    top = max(np.abs(w).max() for w in want_leaves.values())
    for path, w in want_leaves.items():
        if path in ZERO_GRAD:
            assert np.abs(grads[path]).max() <= 1e-6 * top, path
            continue
        np.testing.assert_allclose(grads[path], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=str(path))


def test_lenet_forward_and_grads_flow_on_the_ports_init():
    """JAX ``test_lenet_forward`` and ``test_lenet_grads_flow``: (4, 10)
    finite logits at zeros, a non-zero gradient on every leaf, and the
    port's init has JAX's tree and shapes."""
    params = LeNet.init(0, device="cpu")
    want = jax.device_get(JLeNet.init(jax.random.PRNGKey(0)))
    assert {p: v.shape for p, v in _leaves(to_numpy(params))} == \
        {p: v.shape for p, v in _leaves(want)}
    logits = LeNet.apply(params, torch.zeros(4, 28, 28, 1))
    assert logits.shape == (4, 10) and torch.isfinite(logits).all()
    for p in utils.tree_leaves(params):
        p.requires_grad_(True)
    x = torch.as_tensor(np.random.RandomState(1).randn(2, 28, 28, 1)
                        .astype(np.float32))
    LeNet.apply(params, x).sum().backward()
    assert all(p.grad.abs().sum() > 0 for p in utils.tree_leaves(params))


def test_lenet_recipe_trajectory_matches_jax(monkeypatch, jparams):
    """Five steps of the recipes' own loss functions (grayscale batches
    without a channel axis, as the MNIST readers give) under
    ``lenet.yml``'s optimizer — AdamW lr 2e-3, wd 1e-4, the cycle
    schedule with cos/cos decay, here over 5 iterations with warmup 2 —
    from the same parameters and batches, fp32: losses 1e-4 relative,
    parameters 1e-4 absolute (AdamW divides by √v, so fp32 noise on a
    near-zero gradient entry moves that entry by a fraction of lr). The
    conv biases' exact gradient is 0 (``ZERO_GRAD``): AdamW turns each
    side's noise into steps of up to lr, so they are held to that drift
    bound, 5 × lr from where they started."""
    jrecipe = _jax_recipe(monkeypatch)
    conf = recipe.Config.load(recipe.DEFAULT_YAML)
    optim = dict(name=conf.optim.name, lr=conf.optim.lr,
                 weight_decay=conf.optim.weight_decay)
    sched = dict(name=conf.scheduler.name, n_iter=5, warmup=2,
                 decay=conf.scheduler.decay)
    rs = np.random.RandomState(6)
    batches = [(rs.rand(8, 28, 28).astype(np.float32),
                rs.randint(0, 10, 8).astype(np.int32)) for _ in range(5)]

    jopt = JOptimizerConfig(**optim)
    jtx = jopt.make(JSchedulerConfig(**sched).make(jopt))
    jstate = jutils.TrainState.create(jax.tree.map(jnp.asarray, jparams),
                                      jtx, rng=0)
    jstep = jutils.make_step(jrecipe.make_loss_fn(train=True), jtx)
    opt = OptimizerConfig(**optim)
    tx = opt.make(SchedulerConfig(**sched).make(opt))
    state = utils.TrainState.create(_from_jax(jparams), tx)
    step = utils.make_step(recipe.make_loss_fn(train=True), tx)
    jl, tl, ja, ta = [], [], [], []
    for x, y in batches:
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        state, m = step(state, (torch.as_tensor(x),
                                torch.as_tensor(y).long()))
        jl.append(float(jm["loss"]))
        tl.append(m["loss"].item())
        ja.append(float(jm["acc"]))
        ta.append(float(m["acc"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert ta == ja
    got = dict(_leaves(to_numpy(state.params)))
    start = dict(_leaves(jparams))
    for path, w in _leaves(jax.device_get(jstate.params)):
        if path in ZERO_GRAD:
            for side in (got[path], w):
                assert np.abs(side - start[path]).max() <= 5 * optim["lr"]
            continue
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-4,
                                   err_msg=str(path))


def test_lenet_config_load_matches_jax(monkeypatch):
    jrecipe = _jax_recipe(monkeypatch)
    want = dataclasses.asdict(jrecipe.Config.load(recipe.DEFAULT_YAML))
    got = dataclasses.asdict(recipe.Config.load(recipe.DEFAULT_YAML))
    for block in ("env", "loader", "optim", "scheduler", "dataset"):
        shared = got[block].keys() & want[block].keys()
        assert {k: got[block][k] for k in shared} == \
            {k: want[block][k] for k in shared}, block
        got.pop(block), want.pop(block)
    assert got == want == {"epochs": 5, "seed": 42}


def _small(conf, n_examples: int = 256):
    conf.epochs, conf.loader.batch_size = 1, 32
    conf.env.precision = "fp32"
    conf.dataset.n_examples = n_examples
    return conf


def test_lenet_recipe_main_runs_on_the_cpu():
    """``main`` from ``lenet.yml`` on the ``mnist`` twin (no release under
    its root), one epoch at batch 32: ``n_iter: 0`` becomes the epoch's
    steps, the results are finite, and the CPU launches no kernel."""
    conf = _small(recipe.Config.load(recipe.DEFAULT_YAML))
    conf.env.precision = "bf16"
    assert conf.scheduler.n_iter == 0
    before = (gn.launches_fwd, gn.launches_bwd)
    res = recipe.main(conf, device="cpu")
    assert (gn.launches_fwd, gn.launches_bwd) == before
    assert conf.scheduler.n_iter == res["train_steps"] == 8
    assert all(math.isfinite(s["loss"]) for s in res["steps"])
    assert math.isfinite(res["test_loss"]) and 0 <= res["test_acc"] <= 1


def test_lenet_sweep_runs_one_main_a_point(monkeypatch):
    """JAX ``test_lenet_sweep_runs_each_point``: ``lenet-sweep.yml``'s
    quoted lr list runs one ``main`` a point, in order, each outcome
    tagged with its lr."""
    shrunk = []
    real_main = recipe.main

    def small_main(conf, device="cuda"):
        shrunk.append(conf.optim.lr)
        return real_main(_small(conf), device)

    monkeypatch.setattr(recipe, "main", small_main)
    outcomes = recipe.sweep(recipe.SWEEP_YAML, device="cpu")
    assert shrunk == [2e-3, 1e-3]
    assert [o["lr"] for o in outcomes] == [2e-3, 1e-3]
    assert all(0.0 <= o["test_acc"] <= 1.0 for o in outcomes)
