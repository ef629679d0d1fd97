"""Port parity: the optimizers of ``torchbooster_tpu_torch/optim.py``
(lamb, lion, adafactor) against the optax chains the JAX package's
``OptimizerConfig.make`` builds, on the CPU:

- each optimizer alone: 5 identical fp32 gradient trees through the
  port's ``Transform`` (``clip_units``, the scheduled lr, ``step``) and
  through the JAX transformation, with a cycle schedule, decay on every
  leaf or on matrices only, and ``agc``; the tree holds a stacked
  (2, 160, 256) leaf (adafactor factors it), a (2, 256) leaf (it does
  not), a (160, 128) leaf and an all-zero leaf (lamb's zero-norm rule);
  adafactor's row and column moments against optax's;
- a 10-step ``make_step`` trajectory per optimizer against JAX
  ``make_step`` at d_model 128 and vocab 160, where adafactor factors;
- a save at step 2 and a resume through ``SaveCallback`` that continues
  bit for bit (params, every moment, the step counts).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_train import _assert_trees_close, _trajectory
from torchbooster_tpu.config import (
    OptimizerConfig as JOptimizerConfig,
    SchedulerConfig as JSchedulerConfig,
)
from torchbooster_tpu_torch import optim, utils
from torchbooster_tpu_torch.callbacks import SaveCallback
from torchbooster_tpu_torch.config import OptimizerConfig, SchedulerConfig
from torchbooster_tpu_torch.interop import to_numpy
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
from torchbooster_tpu_torch.ops import losses

SHAPES = {"stacked": (2, 160, 256), "bias": (2, 256), "matrix": (160, 128),
          "zero": (4, 8)}
CYCLE = dict(name="cycle", n_iter=5, warmup=2, decay=("lin", "cos"))
# d_model and vocab at least 128: adafactor factors the stacked kernels
WIDE = dict(vocab=160, n_layers=2, d_model=128, n_heads=4, seq_len=32)
CASES = {
    "lamb": dict(name="lamb", lr=1e-2, betas=(0.9, 0.95), weight_decay=0.1),
    "lamb_masked_agc": dict(name="lamb", lr=1e-2, weight_decay=0.1,
                            decay_matrices_only=True, agc=0.05),
    "lion": dict(name="lion", lr=1e-3, betas=(0.9, 0.95), weight_decay=0.1),
    "lion_masked_agc": dict(name="lion", lr=1e-3, weight_decay=0.1,
                            decay_matrices_only=True, agc=0.05),
    "adafactor": dict(name="adafactor", lr=1e-2),
    "adafactor_agc": dict(name="adafactor", lr=1e-2, agc=0.05,
                          weight_decay=0.1, decay_matrices_only=True),
}


def _gradients(rs, n, lion):
    """``n`` gradient trees. For lion every entry keeps one sign over the
    steps and its size in [0.5, 1.5) x 1e-2, so the momentum sum that
    lion takes the sign of stays far from 0 and fp32 noise cannot flip
    it."""
    if not lion:
        return [{k: (rs.randn(*s) * 1e-2).astype(np.float32)
                 for k, s in SHAPES.items()} for _ in range(n)]
    signs = {k: np.where(rs.rand(*s) < 0.5, -1.0, 1.0)
             for k, s in SHAPES.items()}
    return [{k: (signs[k] * (0.5 + rs.rand(*s)) * 1e-2).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(n)]


def _factored_state(jstate):
    """optax's FactoredState inside inject_hyperparams (and the agc chain
    ahead of adafactor's)."""
    found = []

    def visit(node):
        if type(node).__name__ == "FactoredState":
            found.append(node)
        elif isinstance(node, tuple):
            for child in node:
                visit(child)

    visit(jstate.inner_state)
    (state,) = found
    return state


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_optimizer_matches_optax(case):
    """Parameters after each of 5 updates: 1e-6 absolute. Both sides
    compute the same fp32 expressions leaf by leaf; the leaf norms,
    means and the products of several factors round in another order,
    a few ulp of entries of at most 0.3."""
    kw = CASES[case]
    rs = np.random.RandomState(0)
    params = {k: (rs.randn(*s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()}
    params["zero"][:] = 0.0
    grads = _gradients(rs, 5, kw["name"] == "lion")

    jopt = JOptimizerConfig(**kw)
    jtx = jopt.make(JSchedulerConfig(**CYCLE).make(jopt))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    opt = OptimizerConfig(**kw)
    tx = opt.make(SchedulerConfig(**CYCLE).make(opt))
    tp = {k: torch.tensor(v) for k, v in params.items()}
    torch_opt = tx.init(tp)
    for count, g in enumerate(grads):
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                     jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        tx.clip_units(tp)
        for group in torch_opt.param_groups:
            group["lr"] = tx.learning_rate(count)
        torch_opt.step()
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{case} {k} update {count}")
    assert all(int(s["step"]) == 5 for s in torch_opt.state.values())
    if kw["name"] == "adafactor":
        want = _factored_state(jstate)
        state = torch_opt.state[tp["stacked"]]
        assert optim.factored_dims(SHAPES["stacked"]) == (1, 2)
        assert optim.factored_dims(SHAPES["bias"]) is None
        assert set(torch_opt.state[tp["bias"]]) == {"step", "v"}
        for key in ("v_row", "v_col"):
            np.testing.assert_allclose(
                state[key].numpy(), np.asarray(getattr(want, key)["stacked"]),
                rtol=1e-5, atol=0, err_msg=key)
        np.testing.assert_allclose(
            torch_opt.state[tp["bias"]]["v"].numpy(),
            np.asarray(want.v["bias"]), rtol=1e-5, atol=0)


def test_lamb_trust_ratio_holds_on_a_large_leaf():
    """One lamb update at lr 1 of a (4096, 1024) leaf, where a whole-leaf
    norm summed in long fp32 runs drifts (``torch.linalg.vector_norm`` on
    the CPU is 1e-4 off here, 2.6e-3 at GPT-2's wte), and the trust
    ratio scales the leaf's whole update by it. Against the rule in
    float64: 1e-5 of the largest update entry (fp32 rounding of the
    update and of ``p + u`` is 1.6e-6). Against optax: 3e-5 (XLA's own
    fp32 norm of the Adam direction is 6e-6 off the float64 one)."""
    rs = np.random.RandomState(4)
    p0 = (rs.randn(4096, 1024) * 1e-3).astype(np.float32)
    g = (rs.randn(4096, 1024) * 1e-2).astype(np.float32)
    p64, g64 = p0.astype(np.float64), g.astype(np.float64)
    u = g64 / (np.abs(g64) + 1e-8)        # the first Adam step, debiased
    want = p64 - np.linalg.norm(p64) / np.linalg.norm(u) * u
    t = torch.tensor(p0)
    t.grad = torch.tensor(g)
    optim.Lamb([t], lr=1.0, eps=1e-8).step()
    scale = np.abs(want - p64).max()
    assert np.abs(t.numpy() - want).max() <= 1e-5 * scale
    jtx = JOptimizerConfig(name="lamb", lr=1.0).make()
    updates, _ = jtx.update({"w": jnp.asarray(g)},
                            jtx.init({"w": jnp.asarray(p0)}),
                            {"w": jnp.asarray(p0)})
    jp = np.asarray(optax.apply_updates({"w": jnp.asarray(p0)}, updates)["w"])
    assert np.abs(t.numpy() - jp).max() <= 3e-5 * scale


TRAJ_CYCLE = dict(name="cycle", n_iter=10, warmup=3, decay=("lin", "cos"))


@pytest.mark.parametrize("name,lr", [("lamb", 1e-2), ("lion", 1e-3),
                                     ("adafactor", 1e-2)])
def test_make_step_trajectory_matches_jax(name, lr):
    """10 steps of ``make_step`` (cycle schedule, clip 0.5) from the same
    parameters and batches at d_model 128, vocab 160. Losses 1e-4
    relative. Lamb and adafactor parameters 2e-4 absolute, as AdamW's
    trajectory (their updates divide by a root of the second moment, so
    a near-zero gradient entry turns fp32 noise into an O(lr) change of
    that entry). Lion parameters 1e-6 absolute, but for the key bias
    (the middle third of ``attn_qkv``'s bias): its exact gradient is 0,
    since softmax ignores the shift ``q·b_k`` that every key shares, so
    each side takes the sign of its own rounding noise there, and the
    entries are held only to the most two lion runs can drift apart,
    2·Σ lr_t·(1 + wd·|p|)."""
    decay = 0.1 if name != "adafactor" else 0.0
    jl, jstate, tl, state = _trajectory(
        dict(name=name, lr=lr, weight_decay=decay), TRAJ_CYCLE, clip=0.5,
        accumulate_every=1, widths=WIDE)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    got, want = to_numpy(state.params), jax.device_get(jstate.params)
    if name != "lion":
        _assert_trees_close(got, want, atol=2e-4, rtol=0)
    else:
        d = WIDE["d_model"]
        key_bias = (slice(None), slice(d, 2 * d))
        g_bias = got["blocks"]["attn_qkv"]["bias"].copy()
        w_bias = np.asarray(want["blocks"]["attn_qkv"]["bias"]).copy()
        schedule = SchedulerConfig(**TRAJ_CYCLE).make(
            OptimizerConfig(name=name, lr=lr))
        drift = 2 * sum(schedule(t) for t in range(10)) * (
            1 + decay * np.abs(w_bias[key_bias]).max())
        np.testing.assert_array_less(
            np.abs(g_bias[key_bias] - w_bias[key_bias]), drift)
        g_bias[key_bias] = w_bias[key_bias] = 0.0
        got["blocks"]["attn_qkv"]["bias"] = g_bias
        want["blocks"]["attn_qkv"]["bias"] = w_bias
        _assert_trees_close(got, want, atol=1e-6, rtol=0)
    if name == "adafactor":
        kernel = state.params["blocks"]["mlp_fc1"]["kernel"]
        assert set(state.optimizer.state[kernel]) == {"step", "v_row",
                                                      "v_col"}


def _wide_state(name):
    cfg = GPTConfig(**WIDE)
    opt = OptimizerConfig(name=name, lr=1e-2, weight_decay=0.1)
    tx = opt.make(SchedulerConfig(name="cycle", n_iter=6, warmup=2).make(opt))
    state = utils.TrainState.create(GPT.init(0, cfg, device="cpu"), tx)

    def loss_fn(params, batch, generator):
        logits = GPT.apply(params, batch["ids"], cfg,
                           compute_dtype=torch.float32)
        return losses.cross_entropy(logits, batch["labels"]), {}

    return state, utils.make_step(loss_fn, tx, clip=1.0)


@pytest.mark.parametrize("name", ["lamb", "lion", "adafactor"])
def test_save_and_resume_bit_for_bit(name, tmp_path):
    """Two steps, a save, two more steps; a fresh state restored from the
    save takes the same two steps: params, every moment (adafactor's
    factored row and column moments among them) and the step counts
    equal bit for bit."""
    rs = np.random.RandomState(1)
    batches = [torch.as_tensor(rs.randint(0, 160, (2, 17))).long()
               for _ in range(4)]
    feed = [{"ids": b[:, :-1], "labels": b[:, 1:]} for b in batches]
    state, step = _wide_state(name)
    cb = SaveCallback(every=2, n_iter=4, root=tmp_path)
    for i, batch in enumerate(feed):
        state, _ = step(state, batch)
        if i == 1:
            cb.save(2, state=state)
    cb.wait()
    fresh, fresh_step = _wide_state(name)
    cb.restore(like={"state": fresh})
    assert fresh.step == 2
    for batch in feed[2:]:
        fresh, _ = fresh_step(fresh, batch)
    for p, q in zip(utils.tree_leaves(fresh.params),
                    utils.tree_leaves(state.params), strict=True):
        assert torch.equal(p, q)
    got, want = fresh.optimizer.state_dict(), state.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    assert got["state"].keys() == want["state"].keys()
    for i, entry in want["state"].items():
        assert got["state"][i].keys() == entry.keys()
        for key, value in entry.items():
            assert torch.equal(got["state"][i][key], value), (i, key)
    assert int(want["state"][0]["step"]) == 4 and fresh.step == 4
    if name == "adafactor":
        assert any("v_row" in entry for entry in want["state"].values())
