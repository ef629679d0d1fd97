"""Port parity for the long-context recipe (``examples/lm/gpt/gpt-long.yml``)
on the CPU, at small sizes, inputs from a numpy seed:

- B1-B3 at head dim 48 (gpt-long's, d_model 768 / 16 heads): the port's
  flash path (its plain blocked version here) against the JAX
  dispatcher's interpret-mode kernel, forward and gradients, GQA 4 over
  2, S 128, causal, fp32: 1e-5, the tolerance of ``test_torch_flash.py``;
- the byte-level ``text_file`` source: windows of every split and of a
  non-default stride equal the JAX arrays exactly, its errors match
  JAX's, and ``ByteTokenizer`` round-trips and replaces split code points
  as JAX's does;
- dropout: the rule (kept share, kept values exactly ``x / keep`` in x's
  dtype, identity at rate 0 or without a generator, one state one mask),
  ``GPT.apply`` at ``dropout: 0.1`` without a generator against JAX
  ``apply`` without ``dropout_rng`` (fp32, 1e-5), and the remat trap: the
  same generator state with remat on and off gives bit-equal loss and
  gradients;
- ``Config.load`` of ``gpt-long.yml`` against the JAX loader, and
  ``chip_smoke.py``'s in-code ``train_long`` config against that load
  except for its listed overrides;
- the recipe at gpt-long's knobs shrunk (2 layers, d 64, 4 heads over 2,
  seq 64, rope, chunked head, AdamW with decay on matrices only, a cos/cos
  cycle, dropout 0) on a temp corpus: 6 steps of losses and parameters
  against JAX ``make_step`` at the AdamW trajectory test's tolerances;
- save and resume through the recipe: ``save_every: 2`` over 4 steps
  writes ``ckpt_2`` and ``ckpt_4``, a second ``main`` over 6 resumes from
  step 4 and logs iters 5 and 6, and the restored state equals the saved
  one bit for bit at dropout 0.1.
"""
import dataclasses
import importlib.util
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
from torchbooster_tpu.data.sources import resolve_dataset as jax_resolve
from torchbooster_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from torchbooster_tpu.dataset import Split as JSplit
from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.ops import losses as jlosses
from torchbooster_tpu.ops.attention import attention as jax_attention
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.config import (
    DatasetConfig,
    EnvConfig,
    LoaderConfig,
    OptimizerConfig,
    SchedulerConfig,
)
from torchbooster_tpu_torch.data import ByteTokenizer, resolve_dataset
from torchbooster_tpu_torch.dataset import Split
from torchbooster_tpu_torch.interop import params_from_jax, to_numpy
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig, _dropout
from torchbooster_tpu_torch.ops import losses
from torchbooster_tpu_torch.ops.attention import attention
from torchbooster_tpu_torch.recipes import gpt as recipe

ROOT = Path(__file__).resolve().parents[1]
LONG_YML = ROOT / "examples" / "lm" / "gpt" / "gpt-long.yml"
TOL = dict(atol=1e-5, rtol=1e-5)
TEXT = ("Byte-level corpus: ünïcödé, 日本語, emoji 🙂, and code "
        "`def f(x): return x`.\n")
SMALL = dict(vocab=256, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             seq_len=64, pos="rope")


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


def _corpus(tmp_path, repeats=400):
    path = tmp_path / "corpus.txt"
    path.write_text(TEXT * repeats, encoding="utf-8")
    return path


# ------------------------------------------------------ B1-B3 at head dim 48
def test_flash_head_dim_48_gqa_matches_jax_interpret():
    """gpt-long's head dim through the port's flash route and the JAX
    dispatcher's interpret-mode kernel: (B 2, S 128, H 4 over 2, D 48),
    causal, fp32; outputs and dq/dk/dv (``jax.vjp``) to 1e-5."""
    rs = np.random.RandomState(11)
    q = rs.randn(2, 128, 4, 48).astype(np.float32)
    k = rs.randn(2, 128, 2, 48).astype(np.float32)
    v = rs.randn(2, 128, 2, 48).astype(np.float32)
    do = rs.randn(2, 128, 4, 48).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b, c: jax_attention(
        a, b, c, causal=True, impl="flash_interpret"),
        *(jnp.asarray(t) for t in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    got = attention(tq, tk, tv, causal=True, impl="flash")
    got.backward(torch.as_tensor(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL)


# -------------------------------------------------------------- text data
@pytest.mark.parametrize("split,stride", [
    ("train", 0), ("validation", 0), ("test", 0), ("train", 5)])
def test_text_file_windows_match_jax(tmp_path, split, stride):
    """Every split's windows (and a stride of 5 over the train split)
    equal the JAX source's arrays exactly."""
    root = str(_corpus(tmp_path))
    kw = dict(seq_len=17, vocab=256, **({"stride": stride} if stride else {}))
    got = resolve_dataset(DatasetConfig(name="text_file", root=root),
                          Split(split), **kw)
    want = jax_resolve(JDatasetConfig(name="text_file", root=root),
                       JSplit(split), **kw)
    assert len(got.arrays) == len(want.arrays) == 1
    assert got.arrays[0].dtype == want.arrays[0].dtype
    np.testing.assert_array_equal(got.arrays[0], want.arrays[0])
    assert len(got) > 1


def test_text_file_errors_match_jax(tmp_path):
    corpus = _corpus(tmp_path, repeats=2)
    cases = [
        (dict(name="text_file", root=str(corpus)), dict(vocab=97)),
        (dict(name="text_file", root=str(tmp_path / "missing.txt")), {}),
        (dict(name="text_file", root=str(tmp_path)), {}),
        (dict(name="text_file", root=str(corpus)), dict(seq_len=4096)),
    ]
    for conf, kw in cases:
        with pytest.raises((ValueError, FileNotFoundError)) as want:
            jax_resolve(JDatasetConfig(**conf), JSplit.TRAIN, **kw)
        with pytest.raises(want.type) as got:
            resolve_dataset(DatasetConfig(**conf), Split.TRAIN, **kw)
        assert str(got.value) == str(want.value)


def test_byte_tokenizer_matches_jax():
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    for text in (TEXT, b"raw \xff bytes", ""):
        ids = tok.encode(text)
        np.testing.assert_array_equal(ids, jtok.encode(text))
        assert ids.dtype == np.int32
    ids = tok.encode(TEXT)
    assert tok.decode(ids) == TEXT and tok.vocab_size == 256
    # a sample may cut a multi-byte code point: replaced, never raised
    for cut in (ids[:-3], ids[1:], ids[5:40]):
        assert tok.decode(cut) == jtok.decode(cut)
    first_lead = ids.tolist().index(0xC3)      # "ü" is C3 BC
    assert tok.decode(ids[:first_lead + 1]).endswith("\ufffd")


# ------------------------------------------------------------------ dropout
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_rule(dtype):
    """10^6 elements at rate 0.1: kept share 0.9 +- 0.005; kept values
    exactly ``x / 0.9`` in x's dtype, dropped ones 0; rate 0 or no
    generator is the identity; one generator state, one mask."""
    x = torch.as_tensor(np.random.RandomState(0).randn(1000, 1000)).to(dtype)
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    y = _dropout(x, 0.1, gen)
    assert y.dtype == dtype
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) <= 0.005
    assert torch.equal(y[kept], (x / 0.9)[kept])
    assert _dropout(x, 0.0, gen) is x and _dropout(x, 0.1, None) is x
    gen.set_state(state)
    assert torch.equal(_dropout(x, 0.1, gen), y)
    assert not torch.equal(_dropout(x, 0.1, gen), y)


def test_gpt_apply_dropout_without_generator_matches_jax():
    """``dropout: 0.1`` is off without a generator (eval, sampling), as
    JAX ``apply`` without ``dropout_rng``: fp32 logits to 1e-5."""
    jcfg = JCfg(**SMALL, dropout=0.1)
    jp = JGPT.init(jax.random.PRNGKey(0), jcfg)
    cfg = GPTConfig(**SMALL, dropout=0.1)
    tp = params_from_jax(jax.device_get(jp), cfg, "cpu")
    ids = np.random.RandomState(1).randint(0, 256, (2, 32)).astype(np.int32)
    want = JGPT.apply(jp, jnp.asarray(ids), jcfg, compute_dtype=jnp.float32)
    got = GPT.apply(tp, torch.as_tensor(ids).long(), cfg,
                    compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _loss_and_grads(params, cfg, ids, labels, seed, remat):
    params = utils._tree_map(lambda t: t.clone().requires_grad_(), params)
    gen = torch.Generator().manual_seed(seed)
    hidden = GPT.apply(params, ids, cfg, compute_dtype=torch.float32,
                       remat=remat, return_hidden=True, generator=gen)
    loss = losses.lm_head_cross_entropy(hidden, GPT.head_table(params),
                                        labels)
    loss.backward()
    return loss, [p.grad for p in utils.tree_leaves(params)], gen


def test_dropout_masks_survive_remat_bit_for_bit():
    """The remat trap: ``torch.utils.checkpoint`` restores only the
    default generators, so a mask drawn from the step's generator inside
    a recomputed block would be drawn again from an advanced state. The
    same generator state with remat on and off gives bit-equal loss and
    gradients (and leaves the generator in the same state); another
    state gives another loss."""
    cfg = GPTConfig(**SMALL, dropout=0.1)
    params = GPT.init(0, cfg, device="cpu")
    rs = np.random.RandomState(2)
    ids = torch.as_tensor(rs.randint(0, 256, (2, 48))).long()
    labels = torch.as_tensor(rs.randint(0, 256, (2, 48))).long()
    on = _loss_and_grads(params, cfg, ids, labels, 7, remat=True)
    off = _loss_and_grads(params, cfg, ids, labels, 7, remat=False)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))
    assert torch.equal(on[2].get_state(), off[2].get_state())
    other = _loss_and_grads(params, cfg, ids, labels, 8, remat=True)
    assert not torch.equal(other[0], on[0])


# ------------------------------------------------------------------- config
def _jax_recipe(monkeypatch):
    directory = LONG_YML.parent
    monkeypatch.chdir(directory)
    spec = importlib.util.spec_from_file_location("jax_example_lm_gpt_long",
                                                  directory / "gpt.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flat(value, name + "."))
        else:
            out[name] = value
    return out


def test_gpt_long_config_load_matches_jax(monkeypatch):
    jgpt = _jax_recipe(monkeypatch)
    want = dataclasses.asdict(jgpt.Config.load(LONG_YML))
    got = dataclasses.asdict(recipe.Config.load(LONG_YML))
    # the port's recipe also takes a comms: block, which the JAX example
    # has no field for; gpt-long.yml has none
    assert got.pop("comms") is None
    assert got == want
    assert got["model"]["dropout"] == 0.1 and got["save_every"] == 1000
    assert got["dataset"]["name"] == "text_file"
    assert got["scheduler"]["decay"] == ("cos", "cos")


def test_chip_smoke_train_long_config_is_the_yaml_but_its_overrides(
        tmp_path):
    """The smoke builds ``gpt-long.yml`` in code (the card's machine has
    no PyYAML): every value equals the YAML's but the overrides it lists,
    and those take the values its table states."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    conf = chip_smoke.gpt_long_config(tmp_path / "corpus.txt",
                                      tmp_path / "checkpoints")
    got = _flat(dataclasses.asdict(conf))
    want = _flat(dataclasses.asdict(recipe.Config.load(LONG_YML)))
    assert got.keys() == want.keys()
    differ = {k for k in got if got[k] != want[k]}
    assert differ == set(chip_smoke.LONG_OVERRIDES)
    assert {k: got[k] for k in sorted(differ)} == {
        "checkpoint_root": str(tmp_path / "checkpoints"),
        "dataset.root": str(tmp_path / "corpus.txt"),
        "env.distributed": False, "env.mesh": "dp", "eval_batches": 1,
        "log_every": 1, "n_iter": 12, "save_every": 4,
        "scheduler.n_iter": 12, "scheduler.warmup": 2}


# ------------------------------------------------------------------- recipe
def _long_conf(corpus, n_iter, *, save_every=0, root="checkpoints",
               dropout=0.0, sched_iter=None):
    """gpt-long's knobs shrunk: 2 layers, d 64, 4 heads over 2, seq 64."""
    return recipe.Config(
        n_iter=n_iter, seed=42, clip=1.0, accumulate_every=1, log_every=1,
        save_every=save_every, checkpoint_root=str(root),
        model=recipe.ModelConfig(**SMALL, dropout=dropout, remat=True,
                                 chunked_head=True),
        env=EnvConfig(precision="fp32"), loader=LoaderConfig(batch_size=4),
        optim=OptimizerConfig(name="adamw", lr=3e-4, weight_decay=0.1,
                              decay_matrices_only=True),
        scheduler=SchedulerConfig(name="cycle",
                                  n_iter=sched_iter or n_iter, warmup=2,
                                  decay=("cos", "cos")),
        dataset=DatasetConfig(name="text_file", root=str(corpus)))


def test_recipe_trajectory_matches_jax_make_step(tmp_path):
    """6 steps of the recipe's ``run`` from JAX's initial parameters,
    against JAX ``make_step`` with the JAX recipe's loss on the same
    batches: losses 1e-4 relative, parameters 2e-4 absolute (the AdamW
    trajectory test's tolerances and reasons)."""
    conf = _long_conf(_corpus(tmp_path), 6)
    jcfg = JCfg(**SMALL)
    jp = JGPT.init(jax.random.PRNGKey(0), jcfg)
    t = recipe.setup(conf, device="cpu")
    start = dict(utils._paths(params_from_jax(jax.device_get(jp), t.cfg,
                                              "cpu")))
    with torch.no_grad():
        for path, p in utils._paths(t.state.params):
            p.copy_(start.pop(path))
    assert not start
    seen = []

    def recorded(batches):
        for epoch, tokens in batches:
            seen.append(np.asarray(tokens))
            yield epoch, tokens

    t.batches = recorded(t.batches)
    res = recipe.run(t)
    got = [r["loss"] for r in res["log"]]

    def jloss(params, batch, rng):
        hidden = JGPT.apply(params, batch["ids"], jcfg,
                            compute_dtype=jnp.float32, remat=True,
                            return_hidden=True, dropout_rng=rng)
        return jlosses.lm_head_cross_entropy(
            hidden, JGPT.head_table(params), batch["labels"]), {}

    jopt = JOptimizerConfig(name="adamw", lr=3e-4, weight_decay=0.1,
                            decay_matrices_only=True)
    jtx = jopt.make(JSchedulerConfig(name="cycle", n_iter=6, warmup=2,
                                     decay=("cos", "cos")).make(jopt))
    jstate = jutils.TrainState.create(jp, jtx, rng=0)
    jstep = jutils.make_step(jloss, jtx, clip=1.0)
    want = []
    for tokens in seen[:6]:
        jstate, m = jstep(jstate, {"ids": jnp.asarray(tokens[:, :-1]),
                                   "labels": jnp.asarray(tokens[:, 1:])})
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _assert_trees_close(to_numpy(t.state.params),
                        jax.device_get(jstate.params), atol=2e-4, rtol=0)


def _assert_states_equal(a, b):
    for x, y in zip(utils.tree_leaves(a.params), utils.tree_leaves(b.params),
                    strict=True):
        assert torch.equal(x, y)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for key in sa["state"][i]:
            assert torch.equal(sa["state"][i][key], sb["state"][i][key])
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_recipe_saves_and_resumes(tmp_path, capsys):
    """``save_every: 2`` over 4 steps writes ``ckpt_2`` and ``ckpt_4``
    (the step padded to the digits of ``n_iter``); a second run over 6
    steps restores step 4 bit for bit (params, AdamW moments, step and
    the dropout generator at rate 0.1), says so, and logs iters 5 and
    6 only."""
    corpus, root = _corpus(tmp_path), tmp_path / "ckpt"
    first = _long_conf(corpus, 4, save_every=2, root=root, dropout=0.1,
                       sched_iter=6)
    t1 = recipe.setup(first, device="cpu")
    res = recipe.run(t1)
    assert [r["iter"] for r in res["log"]] == [1, 2, 3, 4]
    assert sorted(p.name for p in root.iterdir()) == ["ckpt_2", "ckpt_4"]
    assert "resumed" not in capsys.readouterr().out

    second = dataclasses.replace(first, n_iter=6)
    t2 = recipe.setup(second, device="cpu")
    assert "resumed from step 4" in capsys.readouterr().out
    assert t2.start_iter == 4
    _assert_states_equal(t2.state, t1.state)
    res = recipe.run(t2)
    assert [r["iter"] for r in res["log"]] == [5, 6]
    assert sorted(p.name for p in root.iterdir()) == ["ckpt_2", "ckpt_4",
                                                      "ckpt_6"]
