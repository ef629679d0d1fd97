"""The port's Mixture-of-Experts (``models/moe.py``, MoE blocks of
``models/gpt.py``) and expert parallelism against the JAX package.

Single-process cases run in the test process. Multi-rank cases run on
gloo process groups on the CPU: two rank pools (``RankPool`` of
``tests/test_torch_distributed.py``, spawned once per file), of 2 and of
4 ranks; the test assembles the ranks' blocks. The JAX package runs the
same numpy inputs on its virtual CPU devices (GSPMD: its ``moe_apply``
sees the global token array), imported inside the functions that run
it. fp32 throughout. Dropped-token sets are compared exactly.
"""
from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import RankPool
from torchbooster_tpu_torch import distributed as dist
from torchbooster_tpu_torch.models import moe
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig

# fp32, the sums in another order: outputs and grads 2e-5 absolute
ATOL = 2e-5
TINY = dict(vocab=64, n_layers=2, d_model=32, n_heads=4, seq_len=16,
            n_experts=4, top_k=2, capacity_factor=1.0)
AUX_WEIGHT = 0.5


@pytest.fixture(scope="module")
def pool2():
    p = RankPool(2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module", autouse=True)
def spawned(pool2, pool4):
    """Both pools spawn as the file starts: their ranks import while the
    first tests run JAX."""
    pool2.start()
    pool4.start()


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def torch_tree(tree, grad: bool = False):
    if isinstance(tree, dict):
        return {k: torch_tree(v, grad) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(grad)


def grads_of(tree):
    if isinstance(tree, dict):
        return {k: grads_of(v) for k, v in tree.items()}
    return tree.grad.numpy()


def assert_tree_close(got, want, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=path)


def routing_drops(probs: np.ndarray, top_k: int, capacity: int) -> np.ndarray:
    """JAX's routing (``moe.py:117-140``) on JAX's probabilities, one
    token at a time: the ``(top_k, T)`` mask of dropped assignments."""
    probs = np.array(probs, np.float32)
    t, n_e = probs.shape
    fill = np.zeros(n_e, int)
    dropped = np.zeros((top_k, t), bool)
    for r in range(top_k):
        expert = probs.argmax(-1)
        for i in range(t):
            dropped[r, i] = fill[expert[i]] >= capacity
            fill[expert[i]] += 1
        probs[np.arange(t), expert] = 0.0
    return dropped


def jax_probs(gate: np.ndarray, h: np.ndarray) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    tokens = jnp.asarray(h).reshape(-1, h.shape[-1])
    return np.asarray(jax.nn.softmax((tokens @ jnp.asarray(gate))
                                     .astype(jnp.float32), axis=-1))


def capacity_of(t: int, cfg: dict) -> int:
    c = int((cfg["top_k"] * t / cfg["n_experts"]) * cfg["capacity_factor"]
            + 0.5)
    return max(c, cfg["top_k"])


@contextlib.contextmanager
def spied_positions():
    """A spy on ``moe._positions`` (which ``moe_apply`` looks up at call
    time): yields the list that each call's ``(top_k, T)`` positions in
    expert are appended to. An assignment is dropped where its position
    reaches the capacity."""
    real, seen = moe._positions, []

    def spy(*args, **kwargs):
        pos = real(*args, **kwargs)
        seen.append(pos.detach())
        return pos

    moe._positions = spy
    try:
        yield seen
    finally:
        moe._positions = real


# =========================================================================
# moe_apply against JAX's: both dispatches, drops, aux, gradients
# =========================================================================

def jax_moe_case(n_experts=4, d=8, hidden=16, shape=(2, 16), seed=0):
    import jax

    from torchbooster_tpu.models.moe import moe_init as jinit

    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(seed),
                                            n_experts=n_experts, d_model=d,
                                            hidden=hidden))
    x = np.random.RandomState(seed + 1).randn(*shape, d).astype(np.float32)
    return params, x


@pytest.mark.parametrize("impl", ["scatter", "einsum"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_matches_jax(impl, cf):
    """Output and aux (2e-5), the gradients of ``sum(out²) + aux`` (2e-5)
    and the dropped assignments (exactly, against JAX's routing on JAX's
    probabilities); cf 0.5 forces drops."""
    import jax
    import jax.numpy as jnp

    from torchbooster_tpu.models.moe import moe_apply as jmoe

    params, x = jax_moe_case()

    def jloss(p, xx):
        out, aux = jmoe(p, xx, capacity_factor=cf, impl=impl)
        return (out ** 2).sum() + aux, (out, aux)

    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    p = torch_tree(params, grad=True)
    capacity = capacity_of(32, dict(top_k=2, n_experts=4, capacity_factor=cf))
    with spied_positions() as seen:
        out, aux = moe.moe_apply(p, torch.from_numpy(x), capacity_factor=cf,
                                 impl=impl)
    dropped = (seen[0] >= capacity).numpy()
    ((out ** 2).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=ATOL)
    assert_tree_close(grads_of(p), jax.tree.map(np.asarray, jg), ATOL)
    want = routing_drops(jax_probs(params["moe_gate"]["kernel"], x), 2,
                         capacity)
    np.testing.assert_array_equal(dropped, want)
    assert want.any() == (cf == 0.5)


def test_moe_capacity_drops_like_jax():
    """``tests/test_moe.py:61``: a capacity factor near 0 drops tokens;
    the output shrinks and stays finite, on both sides alike."""
    from torchbooster_tpu.models.moe import moe_apply as jmoe

    import jax

    params, x = jax_moe_case(n_experts=2, d=4, hidden=8, shape=(1, 16))
    p = torch_tree(params)
    outs = {}
    for cf in (4.0, 0.1):
        got = moe.moe_apply(p, torch.from_numpy(x), top_k=1,
                            capacity_factor=cf)[0].numpy()
        want = np.asarray(jax.jit(lambda pp, xx: jmoe(
            pp, xx, top_k=1, capacity_factor=cf)[0])(params, x))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        outs[cf] = got
    assert np.isfinite(outs[0.1]).all()
    assert np.abs(outs[0.1]).sum() <= np.abs(outs[4.0]).sum()


# =========================================================================
# ep:2 — test_moe_ep_sharded_matches_single
# =========================================================================

def case_moe_ep(params: dict, x: np.ndarray, cot: np.ndarray) -> dict:
    from torchbooster_tpu_torch.parallel.sharding import local_slice

    mesh = dist.make_mesh("ep:2", device="cpu")

    def block(path, a):
        if path[0] == "moe_gate":
            return torch.from_numpy(a).requires_grad_()
        s = ("ep",) + (None,) * (a.ndim - 1)
        return torch.from_numpy(
            np.ascontiguousarray(a[local_slice(a.shape, s, mesh)])
        ).requires_grad_()

    p = {g: {k: block((g, k), v) for k, v in params[g].items()}
         for g in params}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_apply(p, xt, ep=mesh.axis("ep"))
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    return {"out": out.detach().numpy(), "aux": float(aux.detach()),
            "grads": grads_of(p), "dx": xt.grad.numpy()}


def test_moe_ep2_matches_jax(pool2):
    """Each rank holds two of four experts and routes every token; the
    all-reduce over ep adds the results: both ranks' outputs equal JAX's
    single-device ``moe_apply`` and its ep:2,tp:2-sharded one
    (``tests/test_moe.py:72``), the gate's and the tokens' gradients are
    whole on every rank, each expert slice's gradient is JAX's slice
    (2e-5)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from torchbooster_tpu.models.moe import moe_apply as jmoe

    params, x = jax_moe_case(shape=(2, 8))
    cot = np.random.RandomState(5).randn(*x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe(p, xx)
        return (out * cot).sum() + aux, out

    (_, single), (jg, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("ep", "tp"))
    specs = {"moe_gate": {"kernel": P()},
             "moe_fc1": {"kernel": P("ep", None, "tp"), "bias": P("ep", "tp")},
             "moe_fc2": {"kernel": P("ep", "tp", None), "bias": P("ep", None)}}
    placed = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params, specs)
    with mesh:
        sharded = jax.jit(lambda p, xx: jmoe(p, xx)[0])(placed, x)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               atol=1e-5)
    got = pool2.run(case_moe_ep, params, x, cot)
    jg = jax.tree.map(np.asarray, jg)
    for rank, res in enumerate(got):
        np.testing.assert_allclose(res["out"], np.asarray(single), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(res["dx"], np.asarray(jdx), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(res["grads"]["moe_gate"]["kernel"],
                                   jg["moe_gate"]["kernel"], atol=ATOL,
                                   rtol=0)
        for g in ("moe_fc1", "moe_fc2"):
            for k in ("kernel", "bias"):
                np.testing.assert_allclose(
                    res["grads"][g][k], jg[g][k][2 * rank:2 * rank + 2],
                    atol=ATOL, rtol=0, err_msg=f"{g}/{k}")


# =========================================================================
# the MoE GPT over dp:2 and dp:2,sp:2: global capacity
# =========================================================================

def gpt_problem(cfg_kw: dict, b: int = 4, seed: int = 0):
    params = np_tree(GPT.init(seed, GPTConfig(**cfg_kw), device="cpu"))
    rs = np.random.RandomState(seed + 3)
    host = {"ids": rs.randint(0, cfg_kw["vocab"], (b, cfg_kw["seq_len"])),
            "labels": rs.randint(0, cfg_kw["vocab"], (b, cfg_kw["seq_len"]))}
    return params, host


def case_moe_gpt(spec: str, cfg_kw: dict, params: dict, host: dict) -> dict:
    """This rank's loss (its chunk's mean CE + AUX_WEIGHT · aux), aux, the
    gradients of its backward and each layer's dropped assignments."""
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    mesh = dist.make_mesh(spec, device="cpu")
    p = torch_tree(params, grad=True)
    b = dist.shard_batch(host, mesh)
    capacity = capacity_of(host["ids"].size, cfg_kw)
    with spied_positions() as seen:
        logits, aux = GPT.apply(p, b["ids"], GPTConfig(**cfg_kw),
                                compute_dtype=torch.float32, remat=False,
                                return_aux=True, mesh=mesh)
    drops = [(pos >= capacity).numpy() for pos in seen]
    loss = cross_entropy(logits, b["labels"]) + AUX_WEIGHT * aux
    loss.backward()
    return {"loss": float(loss.detach()), "aux": float(aux.detach()),
            "grads": grads_of(p), "drops": np.stack(drops),
            "coords": mesh.coords(), "rows": b["ids"].shape}


def jax_moe_gpt(spec: str, n: int, cfg_kw: dict, params: dict, host: dict,
                monkeypatch):
    """JAX's loss, aux and gradients on the mesh, and each layer's MoE
    input (caught by a spy on ``moe_apply``) for its dropped sets."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import torchbooster_tpu.models.moe as jmoe_mod
    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
    from torchbooster_tpu.ops.losses import cross_entropy as jce

    seen: list = []
    real = jmoe_mod.moe_apply

    def spy(p, x, **kw):
        # the layer's input and gate: the callbacks' order is JAX's own
        jax.debug.callback(
            lambda a, g: seen.append((np.asarray(a), np.asarray(g))), x,
            p["moe_gate"]["kernel"])
        return real(p, x, **kw)

    monkeypatch.setattr(jmoe_mod, "moe_apply", spy)
    mesh = jdist.make_mesh(spec, n)
    cfg = JCfg(**cfg_kw)
    data = tuple(a for a in ("dp", "fsdp") if a in mesh.axis_names) or None
    seq = "sp" if "sp" in mesh.axis_names else None
    put = lambda a: jax.device_put(jnp.asarray(a.astype(np.int32)),
                                   NamedSharding(mesh, P(data, seq)))

    def loss(p, ids, labels):
        logits, aux = JGPT.apply(p, ids, cfg, mesh=mesh,
                                 compute_dtype=jnp.float32, remat=False,
                                 return_aux=True)
        ce = jce(logits.reshape(-1, cfg.vocab), labels.reshape(-1))
        return ce + AUX_WEIGHT * aux, aux

    (value, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params), put(host["ids"]),
        put(host["labels"]))
    jax.effects_barrier()
    t = host["ids"].size
    gates = params["blocks"]["moe_gate"]["kernel"]
    layer = {i: h for h, g in seen for i in range(cfg.n_layers)
             if np.array_equal(g, gates[i])}
    assert sorted(layer) == list(range(cfg.n_layers))
    drops = [routing_drops(jax_probs(gates[i], layer[i]), cfg.top_k,
                           capacity_of(t, cfg_kw))
             for i in range(cfg.n_layers)]
    return float(value), float(aux), jax.tree.map(np.asarray, grads), \
        np.stack(drops)


def global_drops(got: list, host: dict, n_sp: int) -> np.ndarray:
    """The ranks' ``(L, k, b·s)`` drop masks laid out over the global
    ``(L, k, B·S)`` tokens in ``b·S + s`` order."""
    b_all, s_all = host["ids"].shape
    n_layers, k = got[0]["drops"].shape[:2]
    out = np.zeros((n_layers, k, b_all, s_all), bool)
    for res in got:
        b, s = res["rows"]
        d = res["coords"].get("dp", 0)
        r = res["coords"].get("sp", 0)
        out[:, :, d * b:(d + 1) * b, r * s:(r + 1) * s] = \
            res["drops"].reshape(n_layers, k, b, s)
    return out.reshape(n_layers, k, -1)


def mean_grads(got: list) -> dict:
    def walk(trees):
        if isinstance(trees[0], dict):
            return {k: walk([t[k] for t in trees]) for k in trees[0]}
        return np.mean(trees, axis=0)
    return walk([r["grads"] for r in got])


def check_moe_gpt(got: list, want: tuple, host: dict, n_sp: int) -> None:
    value, aux, grads, drops = want
    # the global token mean is the mean of the ranks' equal-sized means
    np.testing.assert_allclose(np.mean([r["loss"] for r in got]), value,
                               rtol=1e-5)
    for res in got:
        np.testing.assert_allclose(res["aux"], aux, rtol=1e-5)
    assert_tree_close(mean_grads(got), grads, ATOL)
    mine = global_drops(got, host, n_sp)
    np.testing.assert_array_equal(mine, drops)
    assert 0 < drops.sum() < drops.size


def test_moe_gpt_dp2_matches_jax(pool2, monkeypatch):
    """dp:2: each rank holds two of four rows; capacity, positions and
    aux are the global batch's, so the dropped sets equal JAX's exactly,
    the loss (CE + 0.5·aux) 1e-5 relative and the gradients 2e-5."""
    params, host = gpt_problem(TINY)
    got = pool2.run(case_moe_gpt, "dp:2", TINY, params, host)
    check_moe_gpt(got, jax_moe_gpt("dp:2", 2, TINY, params, host,
                                   monkeypatch), host, 1)


def test_moe_gpt_dp2_sp2_matches_jax(pool4, monkeypatch):
    """dp:2,sp:2: each rank holds two rows and half the sequence;
    positions in expert come from counts gathered over all four ranks in
    ``b·S + s`` order. Dropped sets exact; loss and gradients as above."""
    params, host = gpt_problem(TINY)
    got = pool4.run(case_moe_gpt, "dp:2,sp:2", TINY, params, host)
    check_moe_gpt(got, jax_moe_gpt("dp:2,sp:2", 4, TINY, params, host,
                                   monkeypatch), host, 2)


# =========================================================================
# dp:2,ep:2: make_step with the rules (experts local), clipping
# =========================================================================

STEP_CFG = {**TINY, "capacity_factor": 1.25}


def case_moe_step(params: dict, host: dict, steps: int) -> dict:
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.config import EnvConfig, OptimizerConfig
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    env = EnvConfig(distributed=True, mesh="dp:2,ep:2")
    mesh = dist.get_mesh(env, "cpu")
    cfg = GPTConfig(**STEP_CFG)
    tx = OptimizerConfig(name="adamw", lr=1e-2, weight_decay=1e-4).make()
    state = utils.TrainState.create(torch_tree(params), tx)
    state = env.make(state, model=GPT, device="cpu")

    def loss_fn(p, b, g):
        logits, aux = GPT.apply(p, b["ids"], cfg, compute_dtype=torch.float32,
                                remat=True, return_aux=True, mesh=mesh)
        return cross_entropy(logits, b["labels"]) + AUX_WEIGHT * aux, \
            {"aux": aux}

    step = utils.make_step(loss_fn, tx, clip=0.05, mesh=mesh,
                           rules=GPT.SHARDING_RULES)
    batch = env.shard_batch(host, "cpu")
    losses, auxes = [], []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux"]))
    return {"losses": losses, "aux": auxes, "coords": mesh.coords(),
            "params": np_tree(state.params)}


def test_moe_gpt_dp2_ep2_make_step_matches_jax(pool4):
    """Two AdamW steps clipped at 0.05 (the clip engages: the norm
    counts each expert block once) on dp:2,ep:2 against JAX's
    ``make_step`` on the same mesh and rules: losses and aux 1e-5
    relative; every parameter 5e-5 (each rank's expert blocks are JAX's
    slice; the replicated leaves whole): 0.5% of one lr-sized update,
    because AdamW divides each update by √v and so turns the fp32 noise
    of a near-zero gradient entry into an update difference. Remat on:
    the recompute's collectives run again in backward."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
    from torchbooster_tpu.ops.losses import cross_entropy as jce
    from torchbooster_tpu.utils import TrainState as JState, make_step

    params, host = gpt_problem(STEP_CFG, seed=1)
    mesh = jdist.make_mesh("dp:2,ep:2", 4)
    cfg = JCfg(**STEP_CFG)
    placed = jdist.to_env(jax.tree.map(jnp.asarray, params), mesh,
                          rules=JGPT.SHARDING_RULES)

    def loss_fn(p, b, rng):
        # remat changes no number: the JAX side compiles without it
        logits, aux = JGPT.apply(p, b["ids"], cfg, mesh=mesh,
                                 compute_dtype=jnp.float32, remat=False,
                                 return_aux=True)
        ce = jce(logits.reshape(-1, cfg.vocab), b["labels"].reshape(-1))
        return ce + AUX_WEIGHT * aux, {"aux": aux}

    tx = optax.adamw(1e-2)
    state = JState.create(placed, tx)
    step = make_step(loss_fn, tx, clip=0.05, mesh=mesh,
                     rules=JGPT.SHARDING_RULES)
    batch = {k: jax.device_put(jnp.asarray(v.astype(np.int32)),
                               NamedSharding(mesh, P(("dp",))))
             for k, v in host.items()}
    losses, auxes = [], []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux"]))
    want = jax.tree.map(np.asarray, state.params)
    for res in pool4.run(case_moe_step, params, host, 2):
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(res["aux"], auxes, rtol=1e-5)
        e = res["coords"]["ep"]
        sliced = {g: {k: v[:, 2 * e:2 * e + 2] if g.startswith("moe_fc")
                      else v for k, v in want["blocks"][g].items()}
                  if isinstance(want["blocks"][g], dict) else
                  want["blocks"][g] for g in want["blocks"]}
        assert_tree_close(res["params"], {**want, "blocks": sliced}, 5e-5)


# =========================================================================
# the recipe on dp:2,ep:2; its sharded checkpoint across worlds/packages
# =========================================================================

RECIPE_YAML = """\
n_iter: 2
seed: 7
clip: 1.0
accumulate_every: 1
log_every: 1
save_every: 2
checkpoint_root: {root}
sample_tokens: 4
eval_batches: 1
model: {{vocab: 64, n_layers: 2, d_model: 32, n_heads: 4, seq_len: 16,
         remat: true, n_experts: 4, top_k: 2, capacity_factor: 1.25,
         aux_weight: 0.01}}
env: {{distributed: true, precision: fp32, mesh: "dp:2,ep:2", n_devices: 4}}
loader: {{batch_size: 8, num_workers: 0, drop_last: true}}
optim: {{name: adamw, lr: 1e-3, weight_decay: 0.1, betas: "0.9, 0.95"}}
scheduler: {{name: cycle, n_iter: 2, warmup: 1, decay: "lin, cos"}}
dataset: {{name: synthetic_lm, n_examples: 64}}
"""
FC1 = "['state'].params['blocks']['moe_fc1']['kernel']"


def case_recipe(path: str) -> dict:
    """The recipe's ``main`` on this rank of the world-4 group."""
    from torchbooster_tpu_torch.recipes import gpt as recipe

    return recipe.main(recipe.Config.load(path), device="cpu")


def case_restore_ep(root: str) -> dict:
    """A fresh dp:2,ep:2 state of the recipe's model restored from the
    checkpoint under ``root``: this rank's blocks of the expert kernel."""
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.callbacks import SaveCallback
    from torchbooster_tpu_torch.config import EnvConfig, OptimizerConfig

    env = EnvConfig(distributed=True, mesh="dp:2,ep:2")
    mesh = dist.get_mesh(env, "cpu")
    cfg = GPTConfig(vocab=64, n_layers=2, d_model=32, n_heads=4, seq_len=16,
                    n_experts=4)
    tx = OptimizerConfig(name="adamw", lr=1e-3).make()
    state = utils.TrainState.create(GPT.init(0, cfg, device="cpu"), tx,
                                    generator=7)
    state = env.make(state, model=GPT, device="cpu")
    SaveCallback(1, 2, root=root, sharded=True).restore(
        like={"state": state})
    fc1 = state.params["blocks"]["moe_fc1"]["kernel"]
    return {"fc1": fc1.detach().numpy(), "step": state.step,
            "ep": mesh.coords()["ep"]}


def test_recipe_main_on_dp2_ep2_and_its_checkpoint(tmp_path, pool4):
    """The recipe's ``main`` on every rank of a world-4 group (dp:2,ep:2,
    what ``launch_main`` runs in each process) from a YAML: finite losses,
    ``aux`` reported and >= 0.9 (JAX's ``test_gpt_moe_expert_parallel``),
    the same logs on every rank, the same sample on every rank (each
    samples on the rule-sharded state, ``generate(mesh=)``). The sharded
    checkpoint holds the experts as two blocks; JAX's ``SaveCallback``
    reads it whole, a fresh dp:2,ep:2 state restores its blocks and a
    world-1 state the whole; a checkpoint JAX writes restores into the
    dp:2,ep:2 ranks' blocks."""
    from torchbooster_tpu.callbacks import SaveCallback as JSaveCallback
    from torchbooster_tpu_torch.recipes import gpt as recipe

    path = tmp_path / "gpt.yml"
    path.write_text(RECIPE_YAML.format(root=tmp_path / "ckpt"))
    assert recipe.Config.load(path).env.devices() == 4
    ranks = pool4.run(case_recipe, str(path))
    assert len(ranks) == 4
    for res in ranks:
        assert [r["loss"] for r in res["log"]] == \
            [r["loss"] for r in ranks[0]["log"]]
        assert all(np.isfinite(r["loss"]) and r["aux"] >= 0.9
                   for r in res["log"])
        assert np.isfinite(res["val_loss"])
    assert all(r["sample"] == ranks[0]["sample"] for r in ranks)
    ckpt = tmp_path / "ckpt" / "ckpt_2"
    entry = json.loads((ckpt / "manifest.json").read_text())["leaves"][FC1]
    assert entry == {"sharded": True, "n_chunks": 2,
                     "starts": [[0, 0, 0, 0], [0, 2, 0, 0]],
                     "shape": [2, 4, 32, 128]}
    whole = JSaveCallback(1, 2, root=tmp_path / "ckpt", sharded=True) \
        .restore(2)[FC1]
    assert whole.shape == (2, 4, 32, 128)
    for res in pool4.run(case_restore_ep, str(tmp_path / "ckpt")):
        e = res["ep"]
        np.testing.assert_array_equal(res["fc1"], whole[:, 2 * e:2 * e + 2])
        assert res["step"] == 2
    # across worlds: the same checkpoint into a world-1 state, whole
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.callbacks import SaveCallback
    from torchbooster_tpu_torch.config import OptimizerConfig

    cfg = GPTConfig(vocab=64, n_layers=2, d_model=32, n_heads=4, seq_len=16,
                    n_experts=4)
    one = utils.TrainState.create(GPT.init(0, cfg, device="cpu"),
                                  OptimizerConfig(name="adamw").make(),
                                  generator=7)
    SaveCallback(1, 2, root=tmp_path / "ckpt", sharded=True).restore(
        like={"state": one})
    np.testing.assert_array_equal(
        one.params["blocks"]["moe_fc1"]["kernel"].detach().numpy(), whole)
    # across packages the other way: JAX writes its state, the dp:2,ep:2
    # ranks restore their blocks of it
    import jax
    import optax

    from torchbooster_tpu.utils import TrainState as JState

    jparams = jax.tree.map(lambda t: jax.numpy.asarray(t.detach().numpy()),
                           GPT.init(5, cfg, device="cpu"))
    writer = JSaveCallback(1, 2, root=tmp_path / "jckpt", sharded=True)
    writer.save(2, state=JState.create(jparams, optax.adamw(1e-3)))
    writer.wait()
    jfc1 = np.asarray(jparams["blocks"]["moe_fc1"]["kernel"])
    for res in pool4.run(case_restore_ep, str(tmp_path / "jckpt")):
        e = res["ep"]
        np.testing.assert_array_equal(res["fc1"], jfc1[:, 2 * e:2 * e + 2])
        assert res["step"] == 0        # the saved state's own count


# =========================================================================
# serving MoE blocks; the interop of a JAX MoE tree
# =========================================================================

def test_moe_served_by_the_engine_token_exact():
    """The paged engine serves MoE blocks at ``capacity_factor =
    max(cf, n_experts)`` (JAX ``engine.py:760``): no token of a serving
    batch drops, so every stream equals the dense ``generate`` at that
    capacity (greedy fp32, decisive head), whose prefill and decode are
    held to JAX's by the parity tests of ``moe_apply`` and the GPT."""
    import dataclasses

    from torchbooster_tpu_torch.config import ServingConfig
    from torchbooster_tpu_torch.models.gpt import generate, serving_capacity
    from torchbooster_tpu_torch.serving import Request

    cfg = GPTConfig(**{**TINY, "seq_len": 32, "vocab": 97})
    params = GPT.init(3, cfg, device="cpu")
    params["wte"]["table"] = params["wte"]["table"] * 4
    prompts = [np.random.RandomState(i).randint(0, 97, n).tolist()
               for i, n in enumerate((5, 9, 3))]
    batcher = ServingConfig(page_size=4, n_pages=24, max_slots=2).make(
        params, cfg, compute_dtype="float32", device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    batcher.run(reqs)
    assert serving_capacity(cfg) == 4.0
    served = dataclasses.replace(cfg, capacity_factor=serving_capacity(cfg))
    for req, prompt in zip(reqs, prompts):
        dense = generate(params, torch.tensor([prompt]), served, n_new=6,
                         temperature=0.0,
                         compute_dtype=torch.float32)[0, len(prompt):]
        assert req.tokens == dense.tolist()


def test_jax_moe_tree_converts_and_is_checked():
    """``interop.params_from_jax`` carries a JAX MoE tree over leaf for
    leaf (the gate and the stacked experts), and refuses a tree whose
    experts do not fit the config."""
    import dataclasses

    import jax

    from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
    from torchbooster_tpu_torch.interop import params_from_jax

    jp = jax.tree.map(np.asarray, jax.jit(JGPT.init, static_argnums=1)(
        jax.random.PRNGKey(0), JCfg(**TINY)))
    cfg = GPTConfig(**TINY)
    got = params_from_jax(jp, cfg, device="cpu")
    for g in ("moe_gate", "moe_fc1", "moe_fc2"):
        for k, v in jp["blocks"][g].items():
            np.testing.assert_array_equal(got["blocks"][g][k].numpy(), v)
    with pytest.raises(ValueError, match="moe_gate"):
        params_from_jax(jp, dataclasses.replace(cfg, n_experts=2),
                        device="cpu")
