"""The port's pipeline parallelism (``parallel/pipeline.py``,
``GPT.apply`` on a ``pp`` mesh and its compositions with ``tp``, ``sp``
and ``ep``) and the tp-major qkv layout against the JAX package.

The port runs on gloo process groups on the CPU (the rank pool of
``tests/test_torch_distributed.py``, spawned once per file): each rank
of ``pp`` holds ``L/pp`` contiguous layers and runs its stage's ticks of
the GPipe schedule. The JAX package runs the same numpy inputs on its
virtual CPU devices, its parameters placed by ``GPT.SHARDING_RULES``,
imported inside the functions that run it. fp32 throughout."""
from __future__ import annotations

import contextlib

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
from tests.test_torch_sequence import _grads_np, _torch_tree
from tests.test_torch_tensor_parallel import (
    TP_SPLIT,
    gpt_problem,
    jax_grads,
    jax_mesh,
)
from torchbooster_tpu_torch import distributed as dist
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig

# fp32 on both sides, microbatched and summed in another order: outputs
# and gradients 2e-5 absolute
ATOL = 2e-5
TINY = dict(vocab=64, n_layers=4, d_model=32, n_heads=4, seq_len=16)


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
    pool.start()
    pool4.start()


# =========================================================================
# pipeline_apply on a toy layer: sequential parity, gradients, dp×pp
# =========================================================================

L_TOY, D_TOY = 4, 8


def toy_problem(batch: int = 8, seed: int = 0):
    rs = np.random.RandomState(seed)
    return ({"w": (rs.randn(L_TOY, D_TOY, D_TOY) / 3).astype(np.float32),
             "b": rs.randn(L_TOY, D_TOY).astype(np.float32)},
            rs.randn(batch, D_TOY).astype(np.float32),
            rs.randn(batch, D_TOY).astype(np.float32))


def toy_layer(p, x, mb=None):
    y = torch.tanh(x @ p["w"] + p["b"])
    if mb is None:
        return y
    return y, (y * y).mean()


def case_toy(spec: str, params: dict, x: np.ndarray, cot: np.ndarray,
             m: int | None, with_aux: bool) -> dict:
    from torchbooster_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = dist.make_mesh(spec, device="cpu")
    p = _torch_tree(params, grad=True)
    xb = dist.shard_batch({"x": x}, mesh)["x"].requires_grad_()
    cb = dist.shard_batch({"c": cot}, mesh)["c"]
    out = pipeline_apply(toy_layer, p, xb, mesh, n_microbatches=m,
                         with_mb_index=with_aux, with_aux=with_aux)
    aux = None
    if with_aux:
        out, aux = out
    loss = (out * cb).sum() + (aux if aux is not None else 0)
    loss.backward()
    return {"out": out.detach().numpy(), "grads": _grads_np(p),
            "dx": xb.grad.numpy(),
            "aux": None if aux is None else float(aux.detach())}


def jax_toy(spec: str, params: dict, x: np.ndarray, cot: np.ndarray,
            m: int | None, with_aux: bool):
    """JAX's ``pipeline_apply`` on the same layer and its sequential
    scan: the output, the aux, and the sequential gradients."""
    import jax
    import jax.numpy as jnp

    from torchbooster_tpu.parallel.pipeline import pipeline_apply as jpipe

    mesh = jax_mesh(spec)

    def layer(p, h, mb=None):
        y = jnp.tanh(h @ p["w"] + p["b"])
        return y if mb is None else (y, (y * y).mean())

    def piped(p, xx):
        return jpipe(layer, p, xx, mesh, n_microbatches=m,
                     with_mb_index=with_aux, with_aux=with_aux)

    jp = jax.tree.map(jnp.asarray, params)
    out = jax.jit(piped)(jp, jnp.asarray(x))

    def sequential(p, xx):
        h, aux = xx, 0.0
        for i in range(L_TOY):
            h = jnp.tanh(h @ p["w"][i] + p["b"][i])
            aux = aux + (h * h).mean()
        return (h * cot).sum() + (aux if with_aux else 0.0)

    grads, dx = jax.grad(sequential, argnums=(0, 1))(jp, jnp.asarray(x))
    if with_aux:
        out, aux = out
        return np.asarray(out), float(aux), jax.tree.map(np.asarray, grads), \
            np.asarray(dx)
    return np.asarray(out), None, jax.tree.map(np.asarray, grads), \
        np.asarray(dx)


@pytest.mark.parametrize("spec,m,with_aux", [
    ("pp:2", None, False), ("pp:2", 8, False), ("pp:4", 4, True),
    ("dp:2,pp:2", None, False)],
    ids=["pp2_default", "pp2_more_microbatches", "pp4_aux", "dp2_pp2"])
def test_pipeline_matches_sequential_and_jax(pool, pool4, spec, m, with_aux):
    """``pipeline_apply`` over 4 stacked layers (``tests/test_pipeline.py:
    44-120``): every rank's output block equals JAX's pipelined output
    (2e-5); each stage's layers get the sequential gradient (JAX's
    ``jax.grad`` of the scan; ``test_pipeline_gradients``), so the
    broadcast epilogue carries dL/dout back once; dx reaches stage 0's
    input; the aux (the layers' sum of the microbatch mean,
    ``test_pipeline_aux_grads_match_sequential``) is JAX's, and its
    gradient lands on each stage's layers once. dp×pp: each data group
    runs its own ring on its rows."""
    params, x, cot = toy_problem()
    want, want_aux, want_g, want_dx = jax_toy(spec, params, x, cot, m,
                                              with_aux)
    ranks = pool4 if "dp" in spec or spec == "pp:4" else pool
    got = ranks.run(case_toy, spec, params, x, cot, m, with_aux)
    shape = dict(e.split(":") for e in spec.split(","))
    n_pp, n_dp = int(shape["pp"]), int(shape.get("dp", 1))
    rows = x.shape[0] // n_dp
    for rank, res in enumerate(got):
        d = rank // n_pp
        np.testing.assert_allclose(res["out"], want[d * rows:(d + 1) * rows],
                                   atol=ATOL, rtol=0)
        if with_aux:
            assert abs(res["aux"] - want_aux) < 1e-6
    for key in ("w", "b"):
        total = sum(r["grads"][key] for r in got)
        np.testing.assert_allclose(total, want_g[key], atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.concatenate(
        [got[d * n_pp]["dx"] for d in range(n_dp)]), want_dx, atol=ATOL,
        rtol=0)


def mb_layer(p, h, mb):
    """A layer whose output depends on the microbatch index."""
    return torch.tanh(h @ p["w"] + p["b"]) * (1.0 + 0.5 * mb)


def case_toy_mb(spec: str, params: dict, x: np.ndarray,
                cot: np.ndarray, m: int) -> dict:
    from torchbooster_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = dist.make_mesh(spec, device="cpu")
    p = _torch_tree(params, grad=True)
    xb = dist.shard_batch({"x": x}, mesh)["x"].requires_grad_()
    cb = dist.shard_batch({"c": cot}, mesh)["c"]
    out = pipeline_apply(mb_layer, p, xb, mesh, n_microbatches=m,
                         with_mb_index=True)
    (out * cb).sum().backward()
    return {"out": out.detach().numpy(), "grads": _grads_np(p),
            "dx": xb.grad.numpy(), "coords": mesh.coords()}


def test_pipeline_microbatch_index_follows_jax_under_dp(pool4):
    """dp:2,pp:2 with a layer that reads its microbatch index, batch 8 in
    4 microbatches: JAX's microbatch ``j`` is rows ``[2j, 2j+2)``, one
    row a data shard, so shard 0 runs rows 0, 2, 4, 6 (not its own rows
    0-3) as microbatches 0-3. Each rank's output block, the summed
    weight gradients and stage 0's dx equal JAX's (``jax.grad`` through its
    pipelined forward; 2e-5)."""
    import jax
    import jax.numpy as jnp

    from torchbooster_tpu.parallel.pipeline import pipeline_apply as jpipe

    params, x, cot = toy_problem()
    mesh = jax_mesh("dp:2,pp:2")

    def layer(p, h, mb):
        return jnp.tanh(h @ p["w"] + p["b"]) * (1.0 + 0.5 * mb)

    def loss(p, xx):
        out = jpipe(layer, p, xx, mesh, n_microbatches=4,
                    with_mb_index=True)
        return (out * cot).sum(), out

    (_, want), (want_g, want_dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    got = pool4.run(case_toy_mb, "dp:2,pp:2", params, x, cot, 4)
    for res in got:
        d = res["coords"]["dp"]
        np.testing.assert_allclose(res["out"], np.asarray(want)[
            4 * d:4 * d + 4], atol=ATOL, rtol=0)
        if res["coords"]["pp"] == 0:
            # x enters the schedule on stage 0
            np.testing.assert_allclose(res["dx"], np.asarray(want_dx)[
                4 * d:4 * d + 4], atol=ATOL, rtol=0)
    for key in ("w", "b"):
        # each data shard's ranks hold their shard's gradient
        total = sum(r["grads"][key] for r in got)
        np.testing.assert_allclose(total, np.asarray(want_g[key]),
                                   atol=ATOL, rtol=0)


def test_pipeline_validates_like_jax():
    """JAX's errors (``tests/test_pipeline.py:87``): layers that do not
    divide over the stages, a batch that does not divide into the
    microbatches, and an ``x_spec`` that shards the microbatch or the
    pipeline axis."""
    from torchbooster_tpu_torch.parallel.pipeline import (
        _default_microbatches,
        pipeline_apply,
    )

    mesh = dist.Mesh(axis_names=("pp",), sizes=(2,),
                     device=torch.device("cpu"))
    params = {"w": torch.zeros(3, 4, 4)}
    with pytest.raises(ValueError, match="not divisible by 2 pipeline"):
        pipeline_apply(toy_layer, params, torch.zeros(4, 4), mesh)
    params = {"w": torch.zeros(2, 4, 4), "b": torch.zeros(2, 4)}
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        pipeline_apply(toy_layer, params, torch.zeros(4, 4), mesh,
                       n_microbatches=3)
    with pytest.raises(ValueError, match="leading"):
        pipeline_apply(toy_layer, params, torch.zeros(4, 4), mesh,
                       x_spec=("pp", None))
    with pytest.raises(ValueError, match="pipeline axis"):
        pipeline_apply(toy_layer, params, torch.zeros(4, 4), mesh,
                       x_spec=(None, "pp"))
    from torchbooster_tpu.parallel.pipeline import (
        _default_microbatches as jdefault,
    )

    for args in ((8, 2, 1), (16, 4, 1), (12, 2, 2), (6, 2, 1), (4, 4, 1)):
        assert _default_microbatches(*args) == jdefault(*args)


# =========================================================================
# GPT on pp meshes against JAX
# =========================================================================

def case_gpt(spec: str, cfg_kw: dict, params: dict, host: dict,
             aux_weight: float = 0.0, tp_major: int = 0) -> dict:
    """Every rank holds the whole tree and batch (its sequence chunk on
    ``sp``); ``GPT.apply`` cuts its layers and slices. Its loss, logits,
    aux, the gradient of every whole leaf and the MoE positions."""
    from torchbooster_tpu_torch.models.gpt import qkv_to_tp_major
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    mesh = dist.make_mesh(spec, device="cpu")
    cfg = GPTConfig(**cfg_kw)
    p = _torch_tree(params, grad=True)
    tree = qkv_to_tp_major(p, cfg, tp_major) if tp_major else p
    b = dist.shard_batch(host, mesh)
    with spied_positions() as seen, spied_moe_inputs() as inputs:
        logits, aux = GPT.apply(tree, b["ids"], cfg,
                                compute_dtype=torch.float32, remat=True,
                                mesh=mesh, return_aux=True,
                                qkv_tp_major=bool(tp_major))
        loss = cross_entropy(logits, b["labels"]) + aux_weight * aux
        loss.backward()
    return {"loss": float(loss.detach()), "grads": _grads_np(p),
            "logits": logits.detach().numpy(), "aux": float(aux.detach()),
            "positions": [s.numpy() for s in seen], "moe_in": inputs,
            "coords": mesh.coords()}


@contextlib.contextmanager
def spied_moe_inputs():
    """A spy on the port's ``moe_apply`` (``_block_core`` looks it up at
    call time): yields the list of each call's ``(input, gate kernel)``,
    in the order of :func:`spied_positions`'s entries (one a call)."""
    from torchbooster_tpu_torch.models import moe

    real, seen = moe.moe_apply, []

    def spy(bp, h, **kw):
        seen.append((h.detach().numpy().copy(),
                     bp["moe_gate"]["kernel"].detach().numpy().copy()))
        return real(bp, h, **kw)

    moe.moe_apply = spy
    try:
        yield seen
    finally:
        moe.moe_apply = real


def jax_moe_inputs(monkeypatch, *args) -> tuple:
    """:func:`jax_grads` with a spy on JAX's ``moe_apply``: its results
    and every ``(input, gate kernel)`` that JAX's pipelined forward
    routed, on every device and tick (the inactive ticks' inputs too)."""
    import jax

    import torchbooster_tpu.models.moe as jmoe_mod

    seen: list = []
    real = jmoe_mod.moe_apply

    def spy(p, x, **kw):
        jax.debug.callback(
            lambda a, g: seen.append((np.asarray(a), np.asarray(g))), x,
            p["moe_gate"]["kernel"])
        return real(p, x, **kw)

    monkeypatch.setattr(jmoe_mod, "moe_apply", spy)
    out = jax_grads(*args)
    jax.effects_barrier()
    return out, seen


def check_drops(got: list, jax_seen: list, cfg_kw: dict,
                some: bool) -> None:
    """Every MoE call on every rank routed an input that JAX's pipelined
    forward also routed (the same layer's gate, 1e-4), and dropped
    exactly the assignments JAX's routing drops on it (``(top_k, T)``
    masks at the call's capacity); the ranks of an ep or tp group
    (equal coordinates on the other axes) dropped the same sets; with
    ``some``, at least one assignment dropped."""
    cfg = GPTConfig(**cfg_kw)
    kw = {"top_k": cfg.top_k, "n_experts": cfg.n_experts,
          "capacity_factor": cfg.capacity_factor}
    n_dropped = 0
    for res in got:
        assert len(res["moe_in"]) == len(res["positions"]) > 0
        for (h, gate), pos in zip(res["moe_in"], res["positions"]):
            cap = capacity_of(h.shape[0] * h.shape[1], kw)
            mine = pos >= cap
            twins = [a for a, g in jax_seen
                     if a.shape == h.shape and np.array_equal(g, gate)
                     and np.allclose(a, h, atol=1e-4, rtol=0)]
            assert twins, "a port MoE input JAX never routed"
            want = routing_drops(jax_probs(gate, twins[0]), cfg.top_k, cap)
            np.testing.assert_array_equal(mine, want)
            n_dropped += int(mine.sum())
    groups: dict = {}
    for res in got:
        key = tuple(sorted((a, i) for a, i in res["coords"].items()
                           if a not in ("ep", "tp")))
        groups.setdefault(key, []).append(res["positions"])
    for members in groups.values():
        for other in members[1:]:
            for a, b in zip(members[0], other):
                np.testing.assert_array_equal(a, b)
    if some:
        assert n_dropped > 0


def check_grads(got: list, want: dict, sizes: dict) -> None:
    """Each leaf's gradient on each rank is zero outside its slices: the
    ranks' sum is JAX's gradient times the number of ranks that hold each
    element (2e-5 a rank). Leaves outside the blocks are whole on every
    rank and, without ``sp`` (where each rank differentiates its own
    chunk's loss), equal across the ranks of one data shard: the
    embeddings' over pp come from stage 0 through one all-reduce. Under
    ``dp`` each rank holds its own shard's gradient, and the ranks' sum
    still counts JAX's once a rank that holds the element."""
    n = len(got)
    dps = [r["coords"].get("dp", 0) for r in got]

    def walk(path, want_leaf, leaves):
        if isinstance(want_leaf, dict):
            for k in want_leaf:
                walk(path + (k,), want_leaf[k], [t[k] for t in leaves])
            return
        name = "/".join(path)
        split = 1
        if path[0] == "blocks":
            split *= sizes.get("pp", 1)
            if path[1] in TP_SPLIT and not (
                    path[1] in ("attn_proj", "mlp_fc2", "moe_fc2")
                    and path[2] == "bias"):
                split *= sizes.get("tp", 1)
            if path[1] in ("moe_fc1", "moe_fc2"):
                split *= sizes.get("ep", 1)
        elif sizes.get("sp", 1) == 1:
            # whole and equal on the ranks of one data shard
            for leaf, d in zip(leaves, dps):
                np.testing.assert_allclose(leaf, leaves[dps.index(d)],
                                           atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(sum(leaves), want_leaf * (n // split),
                                   atol=ATOL * n, rtol=0, err_msg=name)

    walk((), want, [r["grads"] for r in got])


def _sizes(spec: str) -> dict:
    return {k: int(v) for k, v in (e.split(":") for e in spec.split(","))}


GPT_CASES = [
    ("pp:2", {}, 0.0),
    ("pp:2,tp:2", dict(pos="rope", n_kv_heads=2), 0.0),
    ("pp:2,sp:2", dict(pos="rope"), 0.0),
    ("pp:2,ep:2", dict(n_experts=4, capacity_factor=0.5), 0.01),
    ("pp:2,tp:2", dict(n_experts=4, capacity_factor=4.0), 0.01),
    ("pp:2,sp:2", dict(n_experts=4, capacity_factor=0.5), 0.01),
]


@pytest.mark.slow
def test_gpt_pipeline_full_composition_pp_tp_sp():
    """pp:2,tp:2,sp:2 on 8 ranks (``tests/test_pipeline.py:433``): the
    Megatron slices, the ring body and the GPipe schedule together give
    JAX's logits and gradients (2e-5)."""
    cfg_kw = {**TINY, "pos": "rope"}
    params, host = gpt_problem(cfg_kw)
    spec = "pp:2,tp:2,sp:2"
    want_loss, want_g, want_logits = jax_grads(spec, cfg_kw, params, host)
    ranks = RankPool(8)
    try:
        got = ranks.run(case_gpt, spec, cfg_kw, params, host, 0.0,
                        timeout=300.0)
    finally:
        ranks.close()
    s_loc = cfg_kw["seq_len"] // 2
    for res in got:
        sp = res["coords"]["sp"]
        np.testing.assert_allclose(
            res["logits"], want_logits[:, sp * s_loc:(sp + 1) * s_loc],
            atol=ATOL, rtol=0)
    assert abs(np.mean([r["loss"] for r in got]) - want_loss) < 1e-5
    check_grads(got, want_g, _sizes(spec))



@pytest.mark.parametrize("spec,extra,aux_weight", GPT_CASES,
                         ids=["pp2", "pp2_tp2_rope_gqa", "pp2_sp2_rope",
                              "pp2_ep2_moe_tight", "pp2_tp2_moe",
                              "pp2_sp2_moe_tight"])
def test_gpt_pipeline_matches_jax(pool, pool4, spec, extra, aux_weight,
                                  monkeypatch):
    """GPT.apply on a pp mesh (``_pipelined_blocks``, remat on) against
    JAX's GPipe forward (``tests/test_pipeline.py:121-584``): logits,
    loss (with the MoE aux) and every gradient (2e-5). pp×tp: the
    blocks' Megatron slices with canonical qkv columns cut rank-major;
    pp×sp: the ring body and positions offset by the chunk; MoE: ``m =
    pp`` microbatches, capacity and drops per microbatch (and per
    sequence shard under sp, the aux averaged over sp), experts split
    over ep or their hidden over tp. Every MoE call drops exactly the
    assignments JAX's routing drops on the same input (caught by a spy
    on JAX's ``moe_apply``), the same on every rank of an ep or tp
    group; at capacity factor 0.5 some drop."""
    cfg_kw = {**TINY, **extra}
    params, host = gpt_problem(cfg_kw)
    moe = cfg_kw.get("n_experts", 0) > 0
    args = (spec, cfg_kw, params, host, aux_weight)
    (want_loss, want_g, want_logits), jax_seen = \
        jax_moe_inputs(monkeypatch, *args) if moe else (jax_grads(*args),
                                                         None)
    sizes = _sizes(spec)
    n = int(np.prod(list(sizes.values())))
    got = (pool4 if n == 4 else pool).run(case_gpt, spec, cfg_kw, params,
                                          host, aux_weight)
    n_sp = sizes.get("sp", 1)
    s_loc = cfg_kw["seq_len"] // n_sp
    for res in got:
        sp = res["coords"].get("sp", 0)
        np.testing.assert_allclose(
            res["logits"], want_logits[:, sp * s_loc:(sp + 1) * s_loc],
            atol=ATOL, rtol=0)
    if n_sp == 1:
        for res in got:
            assert abs(res["loss"] - want_loss) < 1e-5
    else:
        # each sp rank's loss is its chunk's mean: JAX's is their mean
        assert abs(np.mean([r["loss"] for r in got]) - want_loss) < 1e-5
    if moe:
        check_drops(got, jax_seen, cfg_kw,
                    some=cfg_kw["capacity_factor"] < 1.0)
    check_grads(got, want_g, sizes)


DP_PP_MOE = {**TINY, "n_experts": 4, "capacity_factor": 0.5}


def check_dp_rows(got: list, want_loss: float, want_logits: np.ndarray):
    """Each rank's logits are its data shard's rows of JAX's; its loss
    is its shard's mean, and JAX's the mean of the shards'."""
    n_dp = max(r["coords"].get("dp", 0) for r in got) + 1
    b = want_logits.shape[0] // n_dp
    for res in got:
        d = res["coords"].get("dp", 0)
        np.testing.assert_allclose(res["logits"],
                                   want_logits[d * b:(d + 1) * b],
                                   atol=ATOL, rtol=0)
    assert abs(np.mean([r["loss"] for r in got]) - want_loss) < 1e-5


def test_gpt_pipeline_dp_pp_moe_groups_jax_microbatches(pool4, monkeypatch):
    """dp:2,pp:2 MoE at capacity factor 0.5, batch 8 (``m = pp = 2``):
    each rank's two microbatches are its data shard's part of JAX's
    (rows ``[4j, 4j+4)`` of the batch, split over the shards: rows 0-1
    and 4-5 on shard 0), and each MoE call routes one such block of two
    rows at its own capacity. Each call drops JAX's set exactly; logits,
    loss (with the aux) and gradients as JAX's (2e-5)."""
    params, host = gpt_problem(DP_PP_MOE, b=8)
    (want_loss, want_g, want_logits), jax_seen = jax_moe_inputs(
        monkeypatch, "dp:2,pp:2", DP_PP_MOE, params, host, 0.01)
    got = pool4.run(case_gpt, "dp:2,pp:2", DP_PP_MOE, params, host, 0.01)
    check_dp_rows(got, want_loss, want_logits)
    check_drops(got, jax_seen, DP_PP_MOE, some=True)
    check_grads(got, want_g, {"dp": 2, "pp": 2})


@pytest.mark.slow
def test_gpt_pipeline_dp_pp_ep_moe_matches_jax(monkeypatch):
    """dp:2,pp:2,ep:2 on 8 ranks at capacity factor 0.5, batch 8: JAX's
    microbatch rows on each data shard, experts split over ep, the
    dropped sets JAX's exactly and equal over ep; logits, loss and
    gradients (2e-5)."""
    spec = "dp:2,pp:2,ep:2"
    params, host = gpt_problem(DP_PP_MOE, b=8)
    (want_loss, want_g, want_logits), jax_seen = jax_moe_inputs(
        monkeypatch, spec, DP_PP_MOE, params, host, 0.01)
    ranks = RankPool(8)
    try:
        got = ranks.run(case_gpt, spec, DP_PP_MOE, params, host, 0.01,
                        timeout=300.0)
    finally:
        ranks.close()
    check_dp_rows(got, want_loss, want_logits)
    check_drops(got, jax_seen, DP_PP_MOE, some=True)
    check_grads(got, want_g, _sizes(spec))


def test_gpt_pipeline_tp_major_layout_matches_canonical(pool4):
    """``qkv_tp_major=True`` (``tests/test_pipeline.py:245``): params
    permuted once by ``qkv_to_tp_major`` for tp=2, marker and all, give
    the canonical run's logits and gradients at pp:2,tp:2 (the
    gradient flows back through the permute onto the canonical leaf)."""
    cfg_kw = dict(TINY)
    params, host = gpt_problem(cfg_kw)
    canon = pool4.run(case_gpt, "pp:2,tp:2", cfg_kw, params, host, 0.0, 0)
    major = pool4.run(case_gpt, "pp:2,tp:2", cfg_kw, params, host, 0.0, 2)
    for a, b in zip(canon, major):
        np.testing.assert_allclose(b["logits"], a["logits"], atol=1e-6,
                                   rtol=0)
        for g in ("attn_qkv", "mlp_fc1"):
            np.testing.assert_allclose(b["grads"]["blocks"][g]["kernel"],
                                       a["grads"]["blocks"][g]["kernel"],
                                       atol=1e-6, rtol=0)


def case_dropout(spec: str, cfg_kw: dict, params: dict, host: dict) -> dict:
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    mesh = dist.make_mesh(spec, device="cpu") if spec else None
    cfg = GPTConfig(**cfg_kw)
    p = _torch_tree(params, grad=True)
    b = dist.shard_batch(host, mesh) if mesh is not None else {
        k: torch.from_numpy(v) for k, v in host.items()}
    gen = torch.Generator().manual_seed(7)
    logits = GPT.apply(p, b["ids"], cfg, compute_dtype=torch.float32,
                       remat=True, mesh=mesh, generator=gen)
    cross_entropy(logits, b["labels"]).backward()
    return {"logits": logits.detach().numpy(), "grads": _grads_np(p),
            "after": gen.get_state().numpy(),
            "coords": mesh.coords() if mesh is not None else {}}


def test_gpt_pipeline_dropout_equals_the_unpipelined_run(pool):
    """Dropout at pp:2 (``tests/test_pipeline.py:158``): each layer's
    masks come from the generator state the un-pipelined forward has
    before that layer, drawn over the whole batch and kept at the
    microbatch's rows, so every microbatch draws its own mask and the
    pipelined logits and gradients equal the port's own un-pipelined
    run with the same generator (2e-5; the port's masks are not JAX's
    bits), which leaves the generator in the same state."""
    cfg_kw = {**TINY, "dropout": 0.2}
    params, host = gpt_problem(cfg_kw)
    want = case_dropout("", cfg_kw, params, host)
    got = pool.run(case_dropout, "pp:2", cfg_kw, params, host)
    for res in got:
        np.testing.assert_allclose(res["logits"], want["logits"], atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(res["after"], want["after"])
    check_grads(got, want["grads"], {"pp": 2})


def test_gpt_pipeline_dropout_under_dp_equals_the_unpipelined_run(pool,
                                                                 pool4):
    """Dropout at dp:2,pp:2, batch 4 in 2 microbatches: a rank's
    microbatches are JAX's rows (rows 0 and 2 on shard 0), and each
    row's masks are the ones the un-pipelined dp:2 run draws for it
    (every shard's generator in one state), so each rank's logits equal
    its shard's in the port's un-pipelined dp:2 run (2e-5) and the
    ranks' gradients sum to that run's (every leaf outside the blocks
    counted once a pp rank; 4e-5)."""
    cfg_kw = {**TINY, "dropout": 0.2}
    params, host = gpt_problem(cfg_kw)
    want = {r["coords"]["dp"]: r for r in
            pool.run(case_dropout, "dp:2", cfg_kw, params, host)}
    got = pool4.run(case_dropout, "dp:2,pp:2", cfg_kw, params, host)
    for res in got:
        ref = want[res["coords"]["dp"]]
        np.testing.assert_allclose(res["logits"], ref["logits"], atol=ATOL,
                                   rtol=0)
    for path, _ in _spec_items(want[0]["grads"]):
        def leaf(tree):
            for k in path:
                tree = tree[k]
            return tree

        # a row's loss gradient reaches the rank that ran its
        # microbatch, so the data ranks' sum is what compares; a leaf
        # outside the blocks is whole on both pp ranks
        total = sum(leaf(r["grads"]) for r in got)
        scale = 1 if path[0] == "blocks" else 2
        np.testing.assert_allclose(
            total, scale * sum(leaf(r["grads"]) for r in want.values()),
            atol=2 * ATOL, rtol=0, err_msg="/".join(path))


# =========================================================================
# the tp-major layout: marker guards and the state permute
# =========================================================================

def test_qkv_tp_major_marker_guards_match_jax():
    """``tests/test_pipeline.py:293``: the permutation is JAX's; a second
    permute, an inverse of another tp or of a tree never permuted raise;
    every canonical path refuses a marked tree with JAX's message
    (``GPT.apply`` without pp×tp, ``generate``, the paged engine);
    ``qkv_tp_major=True`` without a pp+tp mesh, or with a marker of
    another tp, raises; the inverse restores the tree bit for bit."""
    from torchbooster_tpu.models.gpt import (
        GPTConfig as JCfg,
        qkv_tp_permutation as jperm,
    )
    from torchbooster_tpu_torch.models.gpt import (
        generate,
        qkv_to_tp_major,
        qkv_tp_permutation,
    )
    from torchbooster_tpu_torch.serving.engine import PagedEngine

    for kw in (TINY, {**TINY, "n_kv_heads": 2}):
        for tp in (2, 4):
            if kw.get("n_kv_heads", 4) % tp == 0:
                np.testing.assert_array_equal(
                    qkv_tp_permutation(GPTConfig(**kw), tp),
                    jperm(JCfg(**kw), tp))
    cfg = GPTConfig(**TINY)
    params = GPT.init(0, cfg, device="cpu")
    marked = qkv_to_tp_major(params, cfg, 2)
    assert "_tp_major2" in marked["blocks"]["attn_qkv"]
    with pytest.raises(ValueError, match="already tp-major"):
        qkv_to_tp_major(marked, cfg, 2)
    with pytest.raises(ValueError, match="permuted for tp=2"):
        qkv_to_tp_major(marked, cfg, 4, inverse=True)
    with pytest.raises(ValueError, match="never permuted"):
        qkv_to_tp_major(params, cfg, 2, inverse=True)
    with pytest.raises(ValueError, match="divisible by tp"):
        qkv_to_tp_major(params, cfg, 3)
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="tp-major for tp=2"):
        GPT.apply(marked, ids, cfg, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="tp-major for tp=2"):
        generate(marked, ids, cfg, n_new=2, temperature=0.0)
    with pytest.raises(ValueError, match="tp-major for tp=2"):
        PagedEngine(marked, cfg, page_size=4, n_pages=8, max_slots=1,
                    device="cpu")
    with pytest.raises(ValueError, match="no active pp\\+tp"):
        GPT.apply(marked, ids, cfg, compute_dtype=torch.float32,
                  qkv_tp_major=True)
    fake = dist.Mesh(axis_names=("pp", "tp"), sizes=(2, 4),
                     device=torch.device("cpu"))
    with pytest.raises(ValueError, match="a tp=2 marker"):
        GPT.apply(marked, ids, cfg, compute_dtype=torch.float32,
                  qkv_tp_major=True, mesh=fake)
    with pytest.raises(ValueError, match="no _tp_major marker"):
        GPT.apply(params, ids, cfg, compute_dtype=torch.float32,
                  qkv_tp_major=True, mesh=fake)
    back = qkv_to_tp_major(marked, cfg, 2, inverse=True)
    assert set(back["blocks"]["attn_qkv"]) == {"kernel", "bias"}
    for key in ("kernel", "bias"):
        assert torch.equal(back["blocks"]["attn_qkv"][key],
                           params["blocks"]["attn_qkv"][key])


def test_qkv_state_to_tp_major_permutes_moments_in_lockstep():
    """``qkv_state_to_tp_major`` (``gpt.py:531``) on a trained state: the
    qkv leaves, their adam moments and EMA permute with the same columns
    (a canonical checkpoint resumes rank-major without dividing one
    column's gradient by another's moment); the inverse restores all of
    it bit for bit."""
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.config import OptimizerConfig
    from torchbooster_tpu_torch.models.gpt import (
        qkv_state_to_tp_major,
        qkv_tp_permutation,
    )

    cfg = GPTConfig(**TINY)
    tx = OptimizerConfig(name="adamw", lr=1e-2).make()
    state = utils.TrainState.create(GPT.init(0, cfg, device="cpu"), tx,
                                    ema=True)
    _, host = gpt_problem(TINY)

    def loss_fn(p, b, g):
        logits = GPT.apply(p, b["ids"], cfg, compute_dtype=torch.float32,
                           remat=False)
        from torchbooster_tpu_torch.ops.losses import cross_entropy
        return cross_entropy(logits, b["labels"]), {}

    step = utils.make_step(loss_fn, tx, ema_decay=0.9)
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in host.items()})
    kernel = state.params["blocks"]["attn_qkv"]["kernel"]
    before = {n: v.clone() for n, v in state.optimizer.state[kernel].items()
              if torch.is_tensor(v) and v.shape == kernel.shape}
    k0 = kernel.detach().clone()
    e0 = state.ema["blocks"]["attn_qkv"]["kernel"].clone()
    perm = torch.as_tensor(qkv_tp_permutation(cfg, 2))
    qkv_state_to_tp_major(state, cfg, 2)
    assert "_tp_major2" in state.params["blocks"]["attn_qkv"]
    assert torch.equal(kernel, k0[..., perm])
    assert torch.equal(state.ema["blocks"]["attn_qkv"]["kernel"],
                       e0[..., perm])
    for name, value in before.items():
        assert torch.equal(state.optimizer.state[kernel][name],
                           value[..., perm])
    qkv_state_to_tp_major(state, cfg, 2, inverse=True)
    assert "_tp_major2" not in state.params["blocks"]["attn_qkv"]
    assert torch.equal(kernel, k0)
    for name, value in before.items():
        assert torch.equal(state.optimizer.state[kernel][name], value)


# =========================================================================
# the rule table over pp, and resuming a canonical checkpoint at pp×tp
# =========================================================================

def test_gpt_sharding_rules_place_blocks_over_pp_and_tp():
    """``tests/test_pipeline.py:677``: on a pp:2,tp:2 mesh the rule
    table puts every block leaf's layer axis over pp and the Megatron
    dims over tp, and leaves the embeddings, ``ln_f`` and a head whose
    vocabulary tp does not divide whole — the specs JAX's
    ``make_param_specs`` gives."""
    import jax
    import jax.numpy as jnp

    from torchbooster_tpu.models.gpt import GPT as JGPT
    from torchbooster_tpu.parallel.sharding import (
        make_param_specs as jspecs,
    )
    from torchbooster_tpu_torch.parallel.sharding import make_param_specs

    cfg = GPTConfig(**{**TINY, "vocab": 65, "tie_embeddings": False,
                       "n_experts": 4})
    params = GPT.init(0, cfg, device="cpu")
    mesh = dist.Mesh(axis_names=("pp", "tp", "ep"), sizes=(2, 2, 2),
                     device=torch.device("cpu"))
    got = dict(_spec_items(make_param_specs(params, GPT.SHARDING_RULES,
                                            mesh=mesh)))
    jtree = jax.tree.map(lambda t: jnp.zeros(t.shape), params)
    want = jspecs(jtree, JGPT.SHARDING_RULES, jax_mesh("pp:2,tp:2,ep:2"))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    for path, spec in flat:
        key = tuple(str(k.key) for k in path)
        mine, spec = tuple(got[key]), tuple(spec)
        width = max(len(mine), len(spec))
        assert mine + (None,) * (width - len(mine)) == \
            spec + (None,) * (width - len(spec)), key
    assert got[("blocks", "ln1", "scale")][0] == "pp"
    assert got[("blocks", "attn_qkv", "kernel")] == ("pp", None, "tp")
    assert got[("head", "kernel")] == (None, None)


def _spec_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def case_pp_tp_resume(root: str, cfg_kw: dict, host: dict) -> dict:
    """At pp:2,tp:2: a fresh state restored from a canonical checkpoint
    written in one process, then one step: the loss and the whole
    parameters."""
    from tests.test_torch_tensor_parallel import _full, _state_and_step
    from torchbooster_tpu_torch.callbacks import SaveCallback

    env, mesh, state, step = _state_and_step("pp:2,tp:2", cfg_kw)
    state = SaveCallback(1, 100, root=root, sharded=True).restore(
        1, like={"state": state})["state"]
    state, m = step(state, env.shard_batch(host, "cpu"))
    return {"loss": float(m["loss"]), "params": _full(state, mesh)}


def test_gpt_pipeline_tp_resumes_from_a_canonical_checkpoint(pool4,
                                                            tmp_path):
    """``tests/test_pipeline.py:337``: a canonical sharded checkpoint
    (written by one process) restores at pp:2,tp:2 — each rank's layers,
    its rank-major qkv columns and the adam moments cut the same way —
    and the next step's loss and parameters equal the one-process
    resume's (1e-5 relative, 2e-5 absolute)."""
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.callbacks import SaveCallback
    from torchbooster_tpu_torch.config import OptimizerConfig
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    cfg_kw = dict(TINY)
    cfg = GPTConfig(**cfg_kw)
    _, host = gpt_problem(cfg_kw)
    tx = OptimizerConfig(name="adamw", lr=1e-2, weight_decay=1e-4).make()
    state = utils.TrainState.create(GPT.init(0, cfg, device="cpu"), tx)

    def loss_fn(p, b, g):
        logits = GPT.apply(p, b["ids"], cfg, compute_dtype=torch.float32,
                           remat=True)
        return cross_entropy(logits, b["labels"]), {}

    step = utils.make_step(loss_fn, tx, clip=0.5)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    state, _ = step(state, batch)
    cb = SaveCallback(1, 100, root=tmp_path, sharded=True)
    cb.save(1, state=state)
    cb.wait()
    state, m = step(state, batch)
    want = {"/".join(p): v.detach().numpy() for p, v in
            _spec_items(state.params)}
    for res in pool4.run(case_pp_tp_resume, str(tmp_path), cfg_kw, host):
        assert abs(res["loss"] - float(m["loss"])) < 1e-5 * abs(
            float(m["loss"]))
        for key, value in want.items():
            np.testing.assert_allclose(res["params"][key], value, atol=2e-5,
                                       rtol=0, err_msg=key)


# =========================================================================
# the schedule folded into one process (what the card's smoke runs)
# =========================================================================

def fold_gpt(cfg, params, ids, n_stages, m, remat=True):
    """GPT-2's blocks through ``fold_apply`` (every stage in this
    process, the port's ``pipeline_layer``), the embedding and head
    around them as ``GPT.apply`` has them."""
    from torchbooster_tpu_torch.models.gpt import (
        _embed,
        _lm_head,
        pipeline_layer,
    )
    from torchbooster_tpu_torch.parallel.pipeline import fold_apply

    ran: list = []
    x = _embed(params, ids, torch.float32)
    layer = pipeline_layer(cfg, remat, "auto", m)

    def counted(layer_in, h, mb):
        ran.append((int(layer_in[1]), mb))
        return layer(layer_in, h, mb)

    ids_l = torch.arange(cfg.n_layers)
    h, _ = fold_apply(counted, (params["blocks"], ids_l), x, n_stages, m,
                      with_mb_index=True, with_aux=True)
    return _lm_head(params, h), ran


def test_fold_apply_equals_the_unpipelined_forward_and_gradients():
    """``fold_apply`` (the pp:4 schedule in one process, each stage's
    ticks through ``stage_tick``) gives the un-pipelined ``GPT.apply``'s
    logits and gradients (2e-5), runs each (layer, microbatch) once and
    no stage on an inactive tick."""
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    cfg_kw = {**TINY, "n_layers": 8}
    cfg = GPTConfig(**cfg_kw)
    params, host = gpt_problem(cfg_kw, b=8)
    ids = torch.from_numpy(host["ids"])
    labels = torch.from_numpy(host["labels"])
    ref = _torch_tree(params, grad=True)
    want = GPT.apply(ref, ids, cfg, compute_dtype=torch.float32, remat=True)
    cross_entropy(want, labels).backward()
    p = _torch_tree(params, grad=True)
    got, ran = fold_gpt(cfg, p, ids, 4, 8)
    cross_entropy(got, labels).backward()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    # the layers' calls in order: tick t, then stage s on microbatch
    # t - s where it exists, its two layers; nothing on an inactive tick
    assert ran == [(2 * s + j, t - s) for t in range(8 + 4 - 1)
                   for s in range(4) if 0 <= t - s < 8 for j in range(2)]
    for path, leaf in _spec_items(p):
        want_leaf = ref
        for k in path:
            want_leaf = want_leaf[k]
        torch.testing.assert_close(leaf.grad, want_leaf.grad, atol=ATOL,
                                   rtol=0, msg="/".join(path))
