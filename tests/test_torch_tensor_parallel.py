"""The port's tensor parallelism against the JAX package: Megatron ``tp``
blocks in ``GPT.apply(mesh=...)`` and ``make_step(rules=...)``,
``moe_apply(tp=...)``, the tp-sharded checkpoint, the tensor-parallel
paged engine (``serving/tp.py``) and what still raises.

The port runs on gloo process groups on the CPU (the rank pool of
``tests/test_torch_distributed.py``, spawned once per file): every rank
of a ``tp`` axis holds its heads and hidden units. The JAX package runs
the same numpy inputs on its virtual CPU devices, its parameters placed
by ``GPT.SHARDING_RULES`` (GSPMD), imported inside the functions that
run it. fp32 throughout; greedy serving streams are token-exact."""
from __future__ import annotations

import functools
import json

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import RankPool
from tests.test_torch_moe import (
    capacity_of,
    jax_probs,
    routing_drops,
    spied_positions,
)
from tests.test_torch_sequence import _grads_np, _np_tree, _torch_tree
from torchbooster_tpu_torch import distributed as dist
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig

# fp32 on both sides, partial products summed over tp in another order:
# outputs and gradients 2e-5 absolute
ATOL = 2e-5
TINY = dict(vocab=64, n_layers=2, d_model=32, n_heads=4, seq_len=16)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module", autouse=True)
def spawned(pool, pool4):
    """Both pools spawn as the file starts: their ranks import while the
    first tests run JAX."""
    pool.start()
    pool4.start()


def gpt_problem(cfg_kw: dict, b: int = 4, seed: int = 0):
    params = _np_tree(GPT.init(seed, GPTConfig(**cfg_kw), device="cpu"))
    rs = np.random.RandomState(seed + 3)
    host = {"ids": rs.randint(0, cfg_kw["vocab"], (b, cfg_kw["seq_len"])),
            "labels": rs.randint(0, cfg_kw["vocab"], (b, cfg_kw["seq_len"]))}
    return params, host


def jax_mesh(spec: str):
    from torchbooster_tpu import distributed as jdist

    n = int(np.prod([int(e.split(":")[1]) for e in spec.split(",")]))
    return jdist.make_mesh(spec, n)


def jax_grads(spec: str, cfg_kw: dict, params: dict, host: dict,
              aux_weight: float = 0.0):
    """JAX's loss, logits and gradients with the parameters placed on a
    ``spec`` mesh by ``GPT.SHARDING_RULES``."""
    import jax
    import jax.numpy as jnp

    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
    from torchbooster_tpu.ops.losses import cross_entropy as jce

    mesh = jax_mesh(spec)
    cfg = JCfg(**cfg_kw)
    p = jdist.to_env(jax.tree.map(jnp.asarray, params), mesh,
                     rules=JGPT.SHARDING_RULES)

    def loss(p, ids, labels):
        logits, aux = JGPT.apply(p, ids, cfg, mesh=mesh,
                                 compute_dtype=jnp.float32, remat=False,
                                 return_aux=True)
        return jce(logits.reshape(-1, cfg.vocab), labels.reshape(-1)) \
            + aux_weight * aux, logits

    (value, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        p, jnp.asarray(host["ids"].astype(np.int32)),
        jnp.asarray(host["labels"].astype(np.int32)))
    return float(value), jax.tree.map(np.asarray, grads), np.asarray(logits)


# =========================================================================
# GPT.apply on a tp mesh: forward and gradients
# =========================================================================

def case_gpt_tp(spec: str, cfg_kw: dict, params: dict, host: dict,
                remat: bool = False, aux_weight: float = 0.0) -> dict:
    """Every rank holds the whole tree and the whole batch; ``GPT.apply``
    cuts the blocks to this rank's slices. Its loss, logits and the
    gradient of every whole leaf (zero outside this rank's slices)."""
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    mesh = dist.make_mesh(spec, device="cpu")
    cfg = GPTConfig(**cfg_kw)
    p = _torch_tree(params, grad=True)
    b = {k: torch.from_numpy(v) for k, v in host.items()}
    with spied_positions() as seen:
        logits, aux = GPT.apply(p, b["ids"], cfg, compute_dtype=torch.float32,
                                remat=remat, mesh=mesh, return_aux=True)
    loss = cross_entropy(logits, b["labels"]) + aux_weight * aux
    loss.backward()
    return {"loss": float(loss.detach()), "grads": _grads_np(p),
            "logits": logits.detach().numpy(),
            "positions": [s.numpy() for s in seen]}


# block leaves tp splits (the rest replicate over tp)
TP_SPLIT = ("attn_qkv", "attn_proj", "mlp_fc1", "mlp_fc2", "mlp_fc3",
            "moe_fc1", "moe_fc2")


def check_tp_grads(got: list, want: dict) -> None:
    """Leaves tp splits: the ranks' gradients add up to JAX's (each is
    zero outside its slice). Every other leaf: whole and equal on every
    rank, and JAX's, with no all-reduce over tp."""
    def walk(path, want_leaf, leaves):
        if isinstance(want_leaf, dict):
            for k in want_leaf:
                walk(path + (k,), want_leaf[k], [t[k] for t in leaves])
            return
        name = "/".join(path)
        split = (path[0] == "blocks" and path[1] in TP_SPLIT
                 and not (path[1] in ("attn_proj", "mlp_fc2", "moe_fc2")
                          and path[2] == "bias"))
        if split:
            np.testing.assert_allclose(sum(leaves), want_leaf, atol=ATOL,
                                       rtol=0, err_msg=name)
        else:
            for leaf in leaves:
                np.testing.assert_array_equal(leaf, leaves[0], err_msg=name)
            np.testing.assert_allclose(leaves[0], want_leaf, atol=ATOL,
                                       rtol=0, err_msg=name)

    walk((), want, [r["grads"] for r in got])


@pytest.mark.parametrize("extra", [
    dict(),
    dict(pos="rope", n_kv_heads=2, mlp="swiglu"),
    dict(tie_embeddings=False, dropout=0.1)],
    ids=["learned_gelu", "rope_gqa_swiglu", "untied_vocab_parallel_head"])
def test_gpt_tp2_matches_jax(pool, extra):
    """GPT.apply at tp:2 (``_block_core(tp=...)``: qkv, fc1 and fc3
    column slices, proj and fc2 row slices, one all-reduce each): every
    rank's logits and loss equal JAX's with the rule table's tp
    placement, the sliced leaves' gradients add up to JAX's and every
    other leaf's is whole and bit-equal on both ranks (2e-5). An untied
    head splits its vocabulary over tp (the rule ``P("fsdp", "tp")``
    where tp divides it); dropout is off without a generator."""
    cfg_kw = {**TINY, **extra}
    params, host = gpt_problem(cfg_kw)
    want_loss, want_g, want_logits = jax_grads("dp:1,tp:2", cfg_kw, params,
                                               host)
    got = pool.run(case_gpt_tp, "tp:2", cfg_kw, params, host,
                   bool(extra.get("dropout")))
    for res in got:
        np.testing.assert_allclose(res["logits"], want_logits, atol=ATOL,
                                   rtol=0)
        assert abs(res["loss"] - want_loss) < 1e-5
    check_tp_grads(got, want_g)


def test_moe_gpt_tp2_matches_jax_with_the_same_drops(pool):
    """MoE blocks at tp:2: each rank holds half of every expert's hidden
    units (fc1 columns, fc2 rows, the all-reduce before fc2's bias,
    ``moe_apply(tp=...)``), routing runs whole on both; at a tight
    capacity factor the dropped assignments are JAX's exactly (its
    router's probabilities through ``routing_drops``), the logits and
    aux-weighted loss JAX's and the gradients as above (2e-5)."""
    cfg_kw = {**TINY, "n_experts": 4, "top_k": 2, "capacity_factor": 0.5}
    params, host = gpt_problem(cfg_kw)
    want_loss, want_g, want_logits = jax_grads("dp:1,tp:2", cfg_kw, params,
                                               host, aux_weight=0.01)
    got = pool.run(case_gpt_tp, "tp:2", cfg_kw, params, host, False, 0.01)
    cap = capacity_of(host["ids"].size, cfg_kw)
    n_dropped = 0
    for res in got:
        np.testing.assert_allclose(res["logits"], want_logits, atol=ATOL,
                                   rtol=0)
        assert abs(res["loss"] - want_loss) < 1e-5
        for pos in res["positions"]:
            n_dropped += int((pos >= cap).sum())
        np.testing.assert_array_equal(res["positions"][0],
                                      got[0]["positions"][0])
    assert n_dropped > 0
    check_tp_grads(got, want_g)


# =========================================================================
# moe_apply at ep:2,tp:2 (tests/test_moe.py:72)
# =========================================================================

def case_moe_ep_tp(params: dict, x: np.ndarray, cot: np.ndarray,
                   cf: float) -> dict:
    from torchbooster_tpu_torch.models import moe
    from torchbooster_tpu_torch.parallel.sharding import local_slice

    mesh = dist.make_mesh("ep:2,tp:2", device="cpu")
    specs = {"moe_gate": {"kernel": ()},
             "moe_fc1": {"kernel": ("ep", None, "tp"), "bias": ("ep", "tp")},
             "moe_fc2": {"kernel": ("ep", "tp", None), "bias": ("ep", None)}}
    p = {g: {k: torch.from_numpy(np.ascontiguousarray(
        v[local_slice(v.shape, specs[g][k], mesh)])).requires_grad_()
        for k, v in params[g].items()} for g in params}
    xt = torch.from_numpy(x).requires_grad_()
    with spied_positions() as seen:
        out, aux = moe.moe_apply(p, xt, capacity_factor=cf,
                                 ep=mesh.axis("ep"), tp=mesh.axis("tp"))
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    return {"out": out.detach().numpy(), "aux": float(aux.detach()),
            "grads": _grads_np(p), "dx": xt.grad.numpy(),
            "positions": seen[0].numpy(), "coords": mesh.coords()}


def test_moe_ep2_tp2_matches_jax(pool4):
    """Each rank holds two of four experts and half of their hidden
    units; its output, the tokens' and gate's gradients equal JAX's
    single-device ``moe_apply`` on every rank, its slices' gradients are
    JAX's slices (2e-5), and the dropped assignments at capacity factor
    0.5 are JAX's."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_moe import jax_moe_case
    from torchbooster_tpu.models.moe import moe_apply as jmoe

    params, x = jax_moe_case(shape=(2, 8))
    cot = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    cf = 0.5

    def jloss(p, xx):
        out, aux = jmoe(p, xx, capacity_factor=cf)
        return (out * cot).sum() + aux, out

    (_, single), (jg, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    jg = jax.tree.map(np.asarray, jg)
    probs = jax_probs(params["moe_gate"]["kernel"], x)
    cap = capacity_of(x.shape[0] * x.shape[1],
                      {"top_k": 2, "n_experts": 4, "capacity_factor": cf})
    want_drops = routing_drops(probs, 2, cap)
    assert want_drops.any()
    for res in pool4.run(case_moe_ep_tp, params, x, cot, cf):
        np.testing.assert_allclose(res["out"], np.asarray(single),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(res["dx"], np.asarray(jdx), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(res["positions"] >= cap, want_drops)
        np.testing.assert_allclose(res["grads"]["moe_gate"]["kernel"],
                                   jg["moe_gate"]["kernel"], atol=ATOL,
                                   rtol=0)
        e, t = res["coords"]["ep"], res["coords"]["tp"]
        half = params["moe_fc1"]["kernel"].shape[-1] // 2
        es, hs = slice(2 * e, 2 * e + 2), slice(half * t, half * (t + 1))
        for key, want in (("kernel", jg["moe_fc1"]["kernel"][es, :, hs]),
                          ("bias", jg["moe_fc1"]["bias"][es, hs])):
            np.testing.assert_allclose(res["grads"]["moe_fc1"][key], want,
                                       atol=ATOL, rtol=0)
        np.testing.assert_allclose(res["grads"]["moe_fc2"]["kernel"],
                                   jg["moe_fc2"]["kernel"][es, hs],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(res["grads"]["moe_fc2"]["bias"],
                                   jg["moe_fc2"]["bias"][es], atol=ATOL,
                                   rtol=0)


# =========================================================================
# make_step with rules on dp:2,tp:2, and the tp-sharded checkpoint
# =========================================================================

def _state_and_step(spec: str, cfg_kw: dict):
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.config import EnvConfig, OptimizerConfig
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    env = EnvConfig(distributed=True, mesh=spec)
    mesh = dist.get_mesh(env, "cpu")
    cfg = GPTConfig(**cfg_kw)
    tx = OptimizerConfig(name="adamw", lr=1e-2, weight_decay=1e-4).make()
    state = utils.TrainState.create(GPT.init(0, cfg, device="cpu"), tx)
    state = env.make(state, model=GPT, device="cpu")

    def loss_fn(p, b, g):
        logits = GPT.apply(p, b["ids"], cfg, compute_dtype=torch.float32,
                           remat=True, mesh=mesh)
        return cross_entropy(logits, b["labels"]), {}

    step = utils.make_step(loss_fn, tx, clip=0.5, mesh=mesh,
                           rules=GPT.SHARDING_RULES)
    return env, mesh, state, step


def _full(state, mesh) -> dict:
    from torchbooster_tpu_torch.parallel.sharding import (
        full_leaf,
        tree_flatten,
    )

    with torch.no_grad():
        return {"/".join(path): full_leaf(p, mesh).numpy().copy()
                for path, p in tree_flatten(state.params)}


def case_tp_train(spec: str, cfg_kw: dict, host: dict, steps: int,
                  root: str | None = None) -> dict:
    """``steps`` of ``make_step(rules=GPT.SHARDING_RULES)`` on ``spec``:
    the losses and the whole parameters (canonical qkv columns); with
    ``root`` the state is saved there, sharded, after the last step."""
    from torchbooster_tpu_torch.callbacks import SaveCallback

    env, mesh, state, step = _state_and_step(spec, cfg_kw)
    batch = env.shard_batch(host, "cpu")
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    if root is not None:
        cb = SaveCallback(1, 100, root=root, sharded=True)
        cb.save(steps, state=state)
        cb.wait()
    qkv = state.params["blocks"]["attn_qkv"]["kernel"]
    return {"losses": losses, "params": _full(state, mesh),
            "qkv_local": qkv.detach().numpy(),
            "perm": getattr(qkv, "column_perm", None)}


def case_tp_restore(spec: str, cfg_kw: dict, host: dict, root: str,
                    step_no: int) -> dict:
    """A fresh state on ``spec`` restored from ``root``, then one step."""
    from torchbooster_tpu_torch.callbacks import SaveCallback

    env, mesh, state, step = _state_and_step(spec, cfg_kw)
    cb = SaveCallback(1, 100, root=root, sharded=True)
    state = cb.restore(step_no, like={"state": state})["state"]
    params = _full(state, mesh)
    state, m = step(state, env.shard_batch(host, "cpu"))
    return {"step": state.step - 1, "params": params,
            "next_loss": float(m["loss"])}


def jax_tp_train(spec: str, cfg_kw: dict, host: dict, steps: int):
    import jax
    import jax.numpy as jnp
    import optax

    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
    from torchbooster_tpu.ops.losses import cross_entropy as jce
    from torchbooster_tpu.utils import TrainState as JState, make_step

    mesh = jax_mesh(spec)
    cfg = JCfg(**cfg_kw)
    full = GPT.init(0, GPTConfig(**cfg_kw), device="cpu")
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), full)
    params = jdist.to_env(params, mesh, rules=JGPT.SHARDING_RULES)

    def loss_fn(p, b, rng):
        logits = JGPT.apply(p, b["ids"], cfg, mesh=mesh,
                            compute_dtype=jnp.float32, remat=False)
        return jce(logits.reshape(-1, cfg.vocab), b["labels"].reshape(-1)), {}

    tx = optax.adamw(1e-2, weight_decay=1e-4)
    state = JState.create(params, tx)
    step = make_step(loss_fn, tx, clip=0.5, mesh=mesh,
                     rules=JGPT.SHARDING_RULES)
    batch = jdist.shard_batch({k: v.astype(np.int32)
                               for k, v in host.items()}, mesh)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    flat, _ = jax.tree_util.tree_flatten_with_path(state.params)
    return losses, {"/".join(str(k.key) for k in path): np.asarray(v)
                    for path, v in flat}


def test_make_step_dp2_tp2_and_sharded_checkpoint(pool, pool4, tmp_path):
    """Three adamw steps (clip 0.5) at dp:2,tp:2 with the rule table:
    losses 1e-5 relative and whole parameters 2e-5 absolute against
    JAX's make_step on the same mesh (AdamW divides by √v, which turns
    fp32 noise of a near-zero gradient into an update difference; the
    clip counts each shard once). The qkv block is this rank's
    ``[q_i | k_i | v_i]``. The sharded checkpoint holds the canonical
    columns, JAX's format, and restores at tp:2 on two ranks and in one
    process bit for bit."""
    import jax  # noqa: F401 (the JAX side runs in this process)

    from torchbooster_tpu_torch.callbacks import SaveCallback
    from torchbooster_tpu_torch.models.gpt import qkv_tp_permutation

    cfg_kw = {**TINY, "tie_embeddings": False}
    _, host = gpt_problem(cfg_kw)
    want_l, want_p = jax_tp_train("dp:2,tp:2", cfg_kw, host, 3)
    got = pool4.run(case_tp_train, "dp:2,tp:2", cfg_kw, host, 3,
                    str(tmp_path))
    cfg = GPTConfig(**cfg_kw)
    perm = qkv_tp_permutation(cfg, 2)
    for rank, res in enumerate(got):
        np.testing.assert_allclose(res["losses"], want_l, rtol=1e-5)
        for key, value in want_p.items():
            np.testing.assert_allclose(res["params"][key], value, atol=2e-5,
                                       rtol=0, err_msg=key)
        t = rank % 2
        whole = res["params"]["blocks/attn_qkv/kernel"]
        np.testing.assert_array_equal(
            res["qkv_local"], whole[..., perm[t * 48:(t + 1) * 48]])
    manifest = json.loads((tmp_path / "ckpt_003" / "manifest.json")
                          .read_text())
    key = "['state'].params['blocks']['attn_qkv']['kernel']"
    assert manifest["leaves"][key] == {"sharded": False}
    with np.load(tmp_path / "ckpt_003" / "arrays.npz") as data:
        np.testing.assert_array_equal(
            data[key], got[0]["params"]["blocks/attn_qkv/kernel"])
    for res in pool.run(case_tp_restore, "tp:2", cfg_kw, host,
                        str(tmp_path), 3):
        assert res["step"] == 3 and np.isfinite(res["next_loss"])
        for k, v in got[0]["params"].items():
            np.testing.assert_array_equal(res["params"][k], v, err_msg=k)
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.config import OptimizerConfig
    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    tx = OptimizerConfig(name="adamw", lr=1e-2).make()
    one = utils.TrainState.create(GPT.init(1, cfg, device="cpu"), tx)
    SaveCallback(1, 100, root=tmp_path, sharded=True).restore(
        3, like={"state": one})
    for path, leaf in tree_flatten(one.params):
        np.testing.assert_array_equal(leaf.detach().numpy(),
                                      got[0]["params"]["/".join(path)])


# =========================================================================
# explicit comms refuse model-parallel meshes; tp and pp meshes run
# =========================================================================

def case_comms_refuse(spec: str) -> list:
    from torchbooster_tpu_torch.comms import make_grad_comms
    from torchbooster_tpu_torch.comms.schedule import make_schedule

    mesh = dist.make_mesh(spec, device="cpu")
    out = []
    for make in (lambda: make_grad_comms(mesh, mode="int8"),
                 lambda: make_schedule(mesh, stage=2),
                 lambda: make_schedule(mesh, stage=3, wire="bf16")):
        try:
            make()
            out.append("built")
        except ValueError as exc:
            out.append(str(exc))
    out.append(make_grad_comms(mesh).mode)
    return out


@pytest.mark.parametrize("spec", ["dp:2,tp:2", "dp:2,pp:2"])
def test_explicit_comms_refuse_tp_and_pp_meshes_as_jax(pool4, spec):
    """``make_grad_comms`` with a wire and ``make_schedule`` at any stage
    on a mesh with tp or pp above 1 raise JAX's "model-parallel"
    ValueError (``tests/test_comms.py:440``, ``tests/test_zero23.py:
    314``); implicit mode builds on any mesh."""
    for res in pool4.run(case_comms_refuse, spec):
        assert all("model-parallel" in m for m in res[:3]), res
        assert res[3] == "implicit"


# =========================================================================
# the recipe on tp:2,sp:2 and dp:2,ep:2,tp:2
# =========================================================================

def _recipe_conf(spec: str, n_experts: int = 0, n: int = 1):
    from torchbooster_tpu_torch.config import DatasetConfig, EnvConfig
    from torchbooster_tpu_torch.recipes import gpt as recipe
    from tests.test_torch_train import _tiny_conf

    conf = _tiny_conf(n_iter=3)
    conf.env = EnvConfig(distributed=spec != "", mesh=spec or "dp",
                         n_devices=n, precision="fp32")
    conf.dataset = DatasetConfig(name="synthetic_lm", n_examples=64)
    conf.model.n_experts = n_experts
    conf.sample_tokens = 0
    conf.eval_batches = 0
    return recipe, conf


def case_recipe(spec: str, n_experts: int, n: int) -> dict:
    recipe, conf = _recipe_conf(spec, n_experts, n)
    res = recipe.main(conf, device="cpu")
    return {"losses": [r["loss"] for r in res["log"]]}


@pytest.mark.parametrize("spec,n_experts,n", [
    ("tp:2,sp:2", 0, 4), ("dp:1,ep:2,tp:2", 4, 4),
    pytest.param("dp:1,fsdp:2,tp:2,sp:2", 0, 8, marks=pytest.mark.slow),
    pytest.param("dp:2,ep:2,tp:2", 4, 8, marks=pytest.mark.slow)])
def test_recipe_on_tp_meshes_trains_as_one_device(pool4, spec, n_experts, n):
    """``recipes.gpt.main`` on a mesh with tp (every rank of ``tp``,
    ``sp`` and ``ep`` reads the global batch and keeps its block, the
    state laid out by the rule table; the JAX example's 4-D mesh and its
    MoE mesh, ``tests/test_examples.py:297``, ``:370``, at 8 ranks):
    each logged loss equals the one-process run of the same
    configuration to 1e-4 relative (the sums in another order over 3
    adamw steps; the MoE blocks' capacity is the global batch's on
    both)."""
    recipe, conf = _recipe_conf("", n_experts, 1)
    want = [r["loss"] for r in recipe.main(conf, device="cpu")["log"]]
    ranks = pool4 if n == 4 else RankPool(n)
    try:
        got = ranks.run(case_recipe, spec, n_experts, n, timeout=300.0)
    finally:
        if ranks is not pool4:
            ranks.close()
    assert len(want) == 3
    for res in got:
        np.testing.assert_allclose(res["losses"], want, rtol=1e-4)


# =========================================================================
# tensor-parallel serving: the paged engine at tp:2
# =========================================================================

SERVE_CFG = dict(vocab=97, n_layers=2, d_model=32, n_heads=4, seq_len=64)


def serve_params(cfg_kw: dict) -> dict:
    """A decisive head (``wte.table * 4``), so fp32 greedy streams are
    exact against another order of sums."""
    params = _np_tree(GPT.init(0, GPTConfig(**cfg_kw), device="cpu"))
    params["wte"]["table"] = params["wte"]["table"] * 4
    return params


PROMPTS = [[5, 9, 13, 2, 7, 7, 1], [3, 3, 3, 8, 1, 4, 4, 4, 4, 9, 2],
           [60, 61, 62, 63, 60, 61, 62, 63, 60]]


def case_serve_tp(cfg_kw: dict, params: dict, serving: dict,
                  n_new: int, adapter: bool = False) -> dict:
    """A ``ServingConfig`` batcher at tp:2 over this rank's head shard:
    its streams, its pool's bytes and debug stats."""
    from torchbooster_tpu_torch.config import ServingConfig
    from torchbooster_tpu_torch.observability import get_registry
    from torchbooster_tpu_torch.serving import Request, random_adapter

    mesh = dist.make_mesh("tp:2", device="cpu")
    cfg = GPTConfig(**cfg_kw)
    get_registry().enabled = True
    conf = ServingConfig.from_dict({"tp": 2, **serving})
    b = conf.make(_torch_tree(params), cfg, compute_dtype="float32",
                  device="cpu", mesh=mesh)
    if adapter:
        b.engine.adapters.register("a0", random_adapter(1, cfg, 4, std=1.0))
    reqs = [Request(prompt=np.asarray(p, np.int32), max_new_tokens=n_new,
                    adapter="a0" if adapter and i % 2 else "")
            for i, p in enumerate(PROMPTS)]
    real, clock_devices = dist.broadcast, []

    def spy(t, group, src=0):
        clock_devices.append(t.device)
        return real(t, group, src)

    dist.broadcast = spy
    try:
        b.run(reqs)
    finally:
        dist.broadcast = real
    pool = b.engine.pool["k"]
    pool = pool[0] if isinstance(pool, tuple) else pool
    snap = get_registry().snapshot() if hasattr(get_registry(),
                                                "snapshot") else {}
    tp_bytes = [v for k, v in snap.items() if "serving_tp_bytes_total" in k]
    get_registry().enabled = False
    return {"tokens": [list(r.tokens) for r in reqs],
            "kv_heads": pool.shape[3], "stats": b.engine.debug_stats(),
            "traffic": b.engine.tp_step_traffic(1),
            "decode_compiles": b.engine.decode_compiles,
            "tp_bytes": tp_bytes,
            "clock_on_engine": bool(clock_devices) and all(
                d == b.engine.device for d in clock_devices)}


def jax_streams(cfg_kw: dict, params: dict, n_new: int,
                adapter: bool = False, wq: str | None = None) -> list:
    """JAX's dense greedy ``jit_generate`` on each prompt (over the
    adapter-merged weights for the odd requests; over the quantized tree
    with ``wq``)."""
    import jax
    import jax.numpy as jnp

    from torchbooster_tpu.models.gpt import GPTConfig as JCfg, jit_generate

    cfg = JCfg(**cfg_kw)
    tree = jax.tree.map(jnp.asarray, params)
    if wq is not None:
        from torchbooster_tpu.models.quant import quantize_params

        tree = quantize_params(tree, dtype=wq, group_size=16)
    merged = tree
    if adapter:
        from torchbooster_tpu_torch.serving import random_adapter

        a = random_adapter(1, GPTConfig(**cfg_kw), 4, std=1.0)
        blocks = dict(tree["blocks"])
        blocks["attn_qkv"] = {**blocks["attn_qkv"], "kernel":
                              blocks["attn_qkv"]["kernel"]
                              + jnp.asarray(a["a_qkv"] @ a["b_qkv"])}
        blocks["attn_proj"] = {**blocks["attn_proj"], "kernel":
                               blocks["attn_proj"]["kernel"]
                               + jnp.asarray(a["a_proj"] @ a["b_proj"])}
        merged = {**tree, "blocks": blocks}
    gen = jit_generate(cfg, n_new=n_new, temperature=0.0)
    out = []
    for i, p in enumerate(PROMPTS):
        use = merged if adapter and i % 2 else tree
        ids = jnp.asarray(np.asarray(p, np.int32)[None])
        out.append(np.asarray(gen(use, ids, jax.random.PRNGKey(0)))[
            0, len(p):].tolist())
    return out


@pytest.mark.parametrize("serving,extra", [
    (dict(page_size=4, n_pages=48, max_slots=2), {}),
    (dict(page_size=4, n_pages=48, max_slots=2, cache_dtype="int8",
          prefix_cache=True), dict(n_kv_heads=2)),
    (dict(page_size=8, n_pages=32, max_slots=2, speculative=True,
          draft_len=3), {}),
    (dict(page_size=4, n_pages=48, max_slots=2,
          adapters={"rank": 4, "max_live": 2}), {}),
    (dict(page_size=16, n_pages=16, max_slots=2, prefix_cache=True,
          decode_backend="kernel"), dict(n_kv_heads=2))],
    ids=["mha", "gqa_int8_prefix", "speculative", "lora", "b4_kernel_gqa"])
def test_tp2_engine_streams_match_jax_generate(pool, serving, extra):
    """The paged engine at tp:2 (``serving/tp.py``: qkv columns
    rank-major, proj rows, one all-reduce a layer, a pool of kv_heads/2
    heads a rank; host bookkeeping and the clock shared by both ranks)
    decodes JAX's dense greedy ``jit_generate`` streams token for token
    — MHA and GQA, int8 pages with the prefix cache, the fused
    speculative verify, LoRA lanes (the odd requests on an adapter,
    held to JAX over the merged weights) — with one decode shape, half
    the KV heads a rank, ``debug_stats()["tp"] == 2``, JAX's
    ``step_traffic`` and ``serving_tp_bytes_total`` counted. The kernel
    backend (``tests/test_paged_kernel.py:350``) runs B4's plain version
    over each rank's head shard of the pool."""
    from torchbooster_tpu.serving.tp import step_traffic as jtraffic
    from torchbooster_tpu.models.gpt import GPTConfig as JCfg

    cfg_kw = {**SERVE_CFG, **extra}
    params = serve_params(cfg_kw)
    lora = "adapters" in serving
    n_new = 6
    want = jax_streams(cfg_kw, params, n_new, adapter=lora)
    got = pool.run(case_serve_tp, cfg_kw, params, serving, n_new, lora)
    cfg = GPTConfig(**cfg_kw)
    import jax.numpy as jnp

    want_traffic = jtraffic(2, JCfg(**cfg_kw), serving["max_slots"],
                            jnp.float32)
    for res in got:
        assert res["tokens"] == want
        assert res["kv_heads"] == cfg.kv_heads // 2
        assert res["stats"]["tp"] == 2
        assert res["traffic"] == want_traffic
        assert res["decode_compiles"] <= 1
        assert res["clock_on_engine"]
        if res["tp_bytes"]:
            assert sum(res["tp_bytes"]) > 0


def case_serve_tp_wq(cfg_kw: dict, params: dict, wq: str) -> dict:
    from torchbooster_tpu_torch.config import ServingConfig
    from torchbooster_tpu_torch.serving import Request

    mesh = dist.make_mesh("tp:2", device="cpu")
    conf = ServingConfig.from_dict({
        "tp": 2, "page_size": 4, "n_pages": 48, "max_slots": 2,
        "cache_dtype": "int8", "speculative": True, "draft_len": 3,
        "weights": {"dtype": wq, "group_size": 16}})
    b = conf.make(_torch_tree(params), GPTConfig(**cfg_kw),
                  compute_dtype="float32", device="cpu", mesh=mesh)
    reqs = [Request(prompt=np.asarray(p, np.int32), max_new_tokens=6)
            for p in PROMPTS]
    b.run(reqs)
    qkv = b.engine.params["blocks"]["attn_qkv"]
    proj = b.engine.params["blocks"]["attn_proj"]
    return {"tokens": [list(r.tokens) for r in reqs],
            "qkv_cols": qkv["qkernel"].shape[-1],
            "proj_scale": tuple(proj["qscale"].shape)}


@pytest.mark.parametrize("wq", ["int8", pytest.param("int4",
                                                     marks=pytest.mark.slow)])
def test_tp2_quantized_weights_int8_kv_speculative(pool, wq):
    """Quantized weights at tp:2 with an int8 pool and speculative verify
    (``tests/test_quant_lora.py:399``): qkv's quantized columns and
    their scales follow the rank-major split, proj's rows and int4's
    group scales the row split, the int8 per-channel proj scale stays
    whole; the streams are JAX's ``jit_generate`` over its own
    quantized tree, token for token."""
    cfg_kw = dict(SERVE_CFG)
    params = serve_params(cfg_kw)
    want = jax_streams(cfg_kw, params, 6, wq=wq)
    for res in pool.run(case_serve_tp_wq, cfg_kw, params, wq):
        assert res["tokens"] == want
        assert res["qkv_cols"] == (32 + 2 * 32) // 2
        # int8: one scale row for all input rows, whole on every rank;
        # int4: 32 input rows / group 16 = 2 group rows, one a rank
        assert res["proj_scale"] == (2, 1, 32)


def test_shared_clock_broadcasts_on_the_engine_device(monkeypatch):
    """The batcher's shared clock (``serving/tp.py``) broadcasts its
    reading in a tensor on the device it is given, the engine's: an NCCL
    group takes no CPU tensor. A spy on the broadcast sees the device (a
    meta tensor here, which no CPU default would give) and stops the
    read."""
    from torchbooster_tpu_torch.serving.tp import shared_clock

    seen = []

    class Seen(Exception):
        pass

    def spy(t, group, src=0):
        seen.append((t.device, t.dtype, src))
        raise Seen

    monkeypatch.setattr(dist, "broadcast", spy)
    with pytest.raises(Seen):
        shared_clock(lambda: 1.5, None, torch.device("meta"))()
    assert seen == [(torch.device("meta"), torch.float64, 0)]


def test_tp_serving_validation_matches_jax():
    """What tensor-parallel serving refuses, with JAX's messages: a tp
    that does not divide the KV heads, a missing or mismatched mesh,
    host_spill with tp > 1, and ``n_replicas > 1`` with tp > 1 from
    YAML."""
    from torchbooster_tpu_torch.config import ServingConfig
    from torchbooster_tpu_torch.serving.engine import PagedEngine
    from torchbooster_tpu_torch.serving.tp import check_tp

    cfg = GPTConfig(**SERVE_CFG)
    mesh = dist.Mesh(axis_names=("tp",), sizes=(2,),
                     device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide n_kv_heads"):
        check_tp(2, GPTConfig(**{**SERVE_CFG, "n_kv_heads": 1}), mesh)
    with pytest.raises(ValueError, match="does not divide n_heads"):
        check_tp(3, cfg, mesh)
    with pytest.raises(ValueError, match="needs a committed mesh"):
        check_tp(2, cfg, None)
    with pytest.raises(ValueError, match="no 'tp' axis"):
        check_tp(2, cfg, dist.Mesh(axis_names=("dp",), sizes=(2,),
                                   device=torch.device("cpu")))
    with pytest.raises(ValueError, match="mismatches the mesh's tp"):
        check_tp(2, cfg, dist.Mesh(axis_names=("tp",), sizes=(4,),
                                   device=torch.device("cpu")))
    with pytest.raises(ValueError, match="must be >= 1"):
        check_tp(0, cfg, None)
    params = _torch_tree(serve_params(SERVE_CFG))
    with pytest.raises(ValueError, match="host_spill with tp=2"):
        PagedEngine(params, cfg, page_size=4, n_pages=16, max_slots=2,
                    prefix_cache=True, host_spill=True, tp=2, mesh=mesh,
                    device="cpu")
    conf = ServingConfig.from_dict({"tp": 2, "page_size": 4, "n_pages": 16,
                                    "router": {"n_replicas": 2}})
    with pytest.raises(ValueError, match="not buildable from YAML"):
        conf.make(params, cfg, compute_dtype="float32", device="cpu",
                  mesh=mesh)


# =========================================================================
# dense decode on a mesh: generate(mesh=) over rule-sharded params
# =========================================================================

# JAX's sharded-decode test model (``tests/test_models.py:399``)
MESH_CFG = dict(vocab=64, n_layers=2, d_model=32, n_heads=4, seq_len=32,
                n_kv_heads=2)


@functools.lru_cache(maxsize=None)
def mesh_problem() -> tuple[dict, np.ndarray]:
    """JAX's initialisation of :data:`MESH_CFG` (seed 0) as numpy, and
    its ids (2, 8) (``jax.random.randint(PRNGKey(1), ...)``); cached, so
    callers must not mutate them."""
    import jax

    from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg

    params = jax.tree.map(np.asarray, JGPT.init(jax.random.PRNGKey(0),
                                                JCfg(**MESH_CFG)))
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                        64))
    return params, ids


def jax_generate(cache_dtype=None, spec: str | None = None) -> np.ndarray:
    """JAX's greedy fp32 decode of :func:`mesh_problem`'s ids: its
    ``jit_generate`` on one device, or with ``spec`` over the params
    placed on that mesh by ``GPT.SHARDING_RULES``
    (``tests/test_models.py:417``)."""
    import jax
    import jax.numpy as jnp

    from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
    from torchbooster_tpu.models.gpt import jit_generate

    params, ids = mesh_problem()
    tree = jax.tree.map(jnp.asarray, params)
    gen = jit_generate(JCfg(**MESH_CFG), n_new=6, temperature=0.0,
                       compute_dtype=jnp.float32, cache_dtype=cache_dtype)
    if spec is None:
        return np.asarray(gen(tree, jnp.asarray(ids),
                              jax.random.PRNGKey(0)))
    from torchbooster_tpu.parallel.sharding import shard_params as jshard

    mesh = jax_mesh(spec)
    placed = jshard(tree, mesh, JGPT.SHARDING_RULES)
    with mesh:
        return np.asarray(gen(placed, jnp.asarray(ids),
                              jax.random.PRNGKey(0)))


def case_mesh_generate(spec: str, cfg_kw: dict, params: dict,
                       ids: np.ndarray, cache_dtype=None,
                       temperature: float = 0.0, sharded: bool = True,
                       seed: int = 5) -> dict:
    """This rank's ``jit_generate(mesh=)`` decode of the whole ``ids``
    over its blocks of the rule-laid tree (or the whole tree), every
    rank's generator seeded alike; with the leaf shapes it held."""
    from torchbooster_tpu_torch.models.gpt import jit_generate
    from torchbooster_tpu_torch.parallel.sharding import shard_params

    mesh = dist.make_mesh(spec, device="cpu")
    cfg = GPTConfig(**cfg_kw)
    tree = _torch_tree(params)
    if sharded:
        tree = shard_params(tree, mesh, GPT.SHARDING_RULES)
    fn = jit_generate(cfg, n_new=6, temperature=temperature, top_k=4,
                      compute_dtype=torch.float32, cache_dtype=cache_dtype,
                      mesh=mesh)
    gen = torch.Generator().manual_seed(seed) if temperature else None
    out = fn(tree, torch.from_numpy(ids).long(), gen)
    return {"ids": out.numpy(), "cache_size": fn._cache_size(),
            "qkv": tuple(tree["blocks"]["attn_qkv"]["kernel"].shape)}


def case_mesh_generate_sampled(params: dict, ids: np.ndarray) -> list:
    """:func:`case_mesh_generate`'s sampled ids at tp:2, from the
    rule-laid tree and from the whole tree."""
    return [case_mesh_generate("tp:2", MESH_CFG, params, ids, None, 0.8,
                               sharded)["ids"] for sharded in (True, False)]


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_mesh_generate_fsdp2_tp2_matches_jax(pool4, cache_dtype):
    """``generate(mesh=)`` at ``fsdp:2,tp:2`` on the rule-sharded tree
    (JAX ``test_gpt_jit_generate_with_sharded_params``'s model, ids and
    6 new tokens): each rank gathers its leaves over fsdp, keeps its
    Megatron slices over tp (its 2 of 4 heads, qkv columns rank-major),
    and returns JAX's one-device greedy fp32 decode token for token,
    with the plain cache and the int8 cache (which JAX holds to the
    same one-device ids)."""
    params, ids = mesh_problem()
    want = jax_generate()
    for res in pool4.run(case_mesh_generate, "fsdp:2,tp:2", MESH_CFG,
                         params, ids, cache_dtype):
        np.testing.assert_array_equal(res["ids"], want)
        # d_model rows over fsdp, (32 + 2 * 16) columns over tp
        assert res["qkv"] == (2, 16, 32) and res["cache_size"] == 1


def test_mesh_generate_sampled_tp2_equals_world1(pool):
    """Sampled decode at ``tp:2`` (temperature 0.8, top-k 4), each rank's
    generator seeded alike: both ranks draw the ids the one-process run
    draws from the same seed — from the rule-sharded tree and from the
    whole tree, which ``generate`` cuts to the rank's heads."""
    from torchbooster_tpu_torch.models.gpt import generate

    params, ids = mesh_problem()
    want = generate(_torch_tree(params), torch.from_numpy(ids).long(),
                    GPTConfig(**MESH_CFG), n_new=6, temperature=0.8,
                    top_k=4, compute_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(5)).numpy()
    for res in pool.run(case_mesh_generate_sampled, params, ids):
        for got in res:
            np.testing.assert_array_equal(got, want)


@pytest.mark.slow
@pytest.mark.parametrize("spec,against", [
    ("dp:2,tp:2,fsdp:2", "dp:2,tp:2,fsdp:2"), ("pp:2,tp:2", None)])
def test_mesh_generate_eight_and_pp_ranks_match_jax(spec, against):
    """JAX's exact mesh, ``dp:2,tp:2,fsdp:2`` at 8 ranks, held to JAX's
    own ``jit_generate`` on its 8-device mesh (plain and int8 caches);
    ``pp:2,tp:2`` (each rank gathers the other stage's layers) to the
    one-device decode."""
    params, ids = mesh_problem()
    n = int(np.prod([int(e.split(":")[1]) for e in spec.split(",")]))
    ranks = RankPool(n)
    try:
        for cache_dtype in (None, "int8"):
            want = jax_generate(cache_dtype, against)
            for res in ranks.run(case_mesh_generate, spec, MESH_CFG, params,
                                 ids, cache_dtype, timeout=300.0):
                np.testing.assert_array_equal(res["ids"], want)
    finally:
        ranks.close()


def case_recipe_sample(spec: str, n: int) -> dict:
    recipe, conf = _recipe_conf(spec, 0, n)
    conf.sample_tokens = 8
    res = recipe.main(conf, device="cpu")
    return {"sample": res["sample"],
            "losses": [r["loss"] for r in res["log"]]}


def test_recipe_tp2_samples_on_every_rank_as_one_device(pool):
    """The GPT recipe at ``tp:2`` samples on the rule-sharded state on
    both ranks (``generate(mesh=)``, as the JAX recipe samples on its
    sharded state, ``examples/lm/gpt/gpt.py:247``): each rank's sample
    is the one-process run's from the same seed."""
    want = case_recipe_sample("", 1)
    for res in pool.run(case_recipe_sample, "tp:2", 2, timeout=300.0):
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=1e-4)
        assert res["sample"] == want["sample"]


# =========================================================================
# can_admit under tp churn (``tests/test_serving.py:1303``)
# =========================================================================

def can_admit_churn(engine) -> list:
    """JAX's tp churn on ``engine``: 24 random admit / step / retire ops
    (seed 11), each ``can_admit`` answer and admitted slot recorded,
    ``tables.check()`` after every op. Before each op a dry run of a
    probe of 6 pages, which the pool can seat only while it has room
    (the churn's own prompts always fit), adds its answer."""
    rs = np.random.RandomState(11)
    probe = np.arange(24, dtype=np.int32) % 97
    live: list[int] = []
    seen: list = []
    for _ in range(24):
        seen.append(("probe", bool(engine.can_admit(probe))))
        op = rs.randint(3)
        if op == 0 and len(live) < 2:
            prompt = rs.randint(0, 97, rs.randint(2, 11)).astype(np.int32)
            ok = engine.can_admit(prompt)
            seen.append(("can_admit", bool(ok)))
            if ok:
                got = engine.admit(prompt)
                seen.append(("admit", None if got is None else got[0]))
                if got is not None:
                    live.append(got[0])
        elif op == 1 and live:
            if engine.grow_slots() == []:
                engine.step()
        elif op == 2 and live:
            engine.retire(live.pop(rs.randint(len(live))))
        engine.tables.check()
    seen.append(("decode_compiles", min(engine.decode_compiles, 1)))
    return seen


def case_can_admit_churn(params: dict, tp: int) -> list:
    from torchbooster_tpu_torch.serving import PagedEngine

    mesh = dist.make_mesh(f"tp:{tp}", device="cpu") if tp > 1 else None
    cfg = GPTConfig(vocab=97, n_layers=2, d_model=32, n_heads=4,
                    seq_len=32, n_kv_heads=2)
    engine = PagedEngine(_torch_tree(params), cfg, page_size=4, n_pages=10,
                         max_slots=2, prefix_cache=True,
                         compute_dtype=torch.float32, tp=tp, mesh=mesh,
                         device="cpu")
    return can_admit_churn(engine)


def test_can_admit_under_tp2_churn_matches_jax(pool):
    """``PagedEngine.can_admit`` (JAX ``engine.py:1148``) through JAX's
    randomized tp:2 churn with the prefix cache under eviction pressure:
    the port's engine at tp:2 on both ranks, and at tp 1, answers every
    ``can_admit`` and seats every admission as JAX's engine at tp:2 on
    its 2-device mesh does, its tables consistent after every op."""
    import jax.numpy as jnp

    from tests.test_torch_gpt import _model
    from torchbooster_tpu.serving import PagedEngine as JEngine
    from torchbooster_tpu_torch.interop import to_numpy

    jp, jcfg, tp_params, _ = _model(2)
    ref = JEngine(jp, jcfg, page_size=4, n_pages=10, max_slots=2,
                  prefix_cache=True, compute_dtype=jnp.float32, tp=2,
                  mesh=jax_mesh("tp:2"))
    want = can_admit_churn(ref)
    assert ("probe", True) in want and ("probe", False) in want
    params = to_numpy(tp_params)
    assert case_can_admit_churn(params, 1) == want
    for got in pool.run(case_can_admit_churn, params, 2):
        assert got == want
