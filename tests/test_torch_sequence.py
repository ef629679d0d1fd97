"""The port's sequence parallelism (``parallel/ring.py``,
``parallel/ulysses.py``, ``GPT.apply(mesh=...)`` on an ``sp`` mesh)
against the JAX package.

The port runs on gloo process groups on the CPU (the rank pool of
``tests/test_torch_distributed.py``, spawned once per file): each rank
holds its ``S/sp`` chunk and the test assembles the chunks in rank
order. The JAX package runs the same numpy inputs on ``sp`` meshes over
its virtual CPU devices, imported inside the functions that run it (the
ranks import this file to find their cases). fp32 throughout.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import RankPool
from torchbooster_tpu_torch import distributed as dist
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig

B, S, H, D = 2, 32, 4, 8
# fp32 on both sides, the sums in another order (blocked online softmax,
# lse merges, per-chunk backward): outputs and gradients 2e-5 absolute
ATOL = 2e-5
GPT_TINY = dict(vocab=64, n_layers=2, d_model=32, n_heads=4, seq_len=32)


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


def host_qkv(h_kv: int, seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    return {"q": rs.randn(B, S, H, D).astype(np.float32),
            "k": rs.randn(B, S, h_kv, D).astype(np.float32),
            "v": rs.randn(B, S, h_kv, D).astype(np.float32),
            "cot": rs.randn(B, S, H, D).astype(np.float32)}


# =========================================================================
# ring and Ulysses attention: outputs and gradients
# =========================================================================

def case_seq_attention(spec: str, strategy: str, impl: str, causal: bool,
                       host: dict) -> dict:
    from torchbooster_tpu_torch.parallel import (
        ring_attention,
        ulysses_attention,
    )

    mesh = dist.make_mesh(spec, device="cpu")
    cols = dist.seq_chunk(S, mesh)
    q, k, v = (torch.from_numpy(host[n][:, cols]).requires_grad_()
               for n in ("q", "k", "v"))
    fn = ring_attention if strategy == "ring" else ulysses_attention
    out = fn(q, k, v, mesh, causal=causal, impl=impl)
    (out * torch.from_numpy(host["cot"][:, cols])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def jax_seq_attention(spec: str, n: int, strategy: str, impl: str,
                      causal: bool, host: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.parallel.ring import ring_attention
    from torchbooster_tpu.parallel.ulysses import ulysses_attention

    mesh = jdist.make_mesh(spec, n)
    fn = ring_attention if strategy == "ring" else ulysses_attention
    jimpl = {"flash": "flash_interpret"}.get(impl, impl)

    def loss(q, k, v):
        out = fn(q, k, v, mesh, causal=causal, impl=jimpl)
        return (out * host["cot"]).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(host[n]) for n in ("q", "k", "v")))
    return {"out": np.asarray(out),
            **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}


def assemble(per_rank: list, key: str) -> np.ndarray:
    return np.concatenate([r[key] for r in per_rank], axis=1)


# (strategy, impl): the ring's reference body, the ring-flash fold (the
# kernels' plain versions on the CPU; JAX's pallas kernels in interpret
# mode) and Ulysses with the local attention through the dispatcher
BODIES = [("ring", "reference"), ("ring", "flash"), ("ulysses", "reference")]


@pytest.mark.parametrize("strategy,impl", BODIES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h_kv", [H, 2], ids=["mha", "gqa"])
def test_sequence_attention_at_sp2_matches_jax(pool, strategy, impl, causal,
                                               h_kv):
    host = host_qkv(h_kv)
    got = pool.run(case_seq_attention, "sp:2", strategy, impl, causal, host)
    want = jax_seq_attention("sp:2", 2, strategy, impl, causal, host)
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(assemble(got, key), want[key],
                                   atol=ATOL, rtol=0, err_msg=key)


def test_ring_flash_at_sp4_matches_jax(pool4):
    """One sp:4 case: the ring-flash fold with GQA, causal (wrapped-future
    chunks skipped, dK/dV home after four rotations)."""
    host = host_qkv(2, seed=1)
    got = pool4.run(case_seq_attention, "sp:4", "ring", "flash", True, host)
    want = jax_seq_attention("sp:4", 4, "ring", "flash", True, host)
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(assemble(got, key), want[key],
                                   atol=ATOL, rtol=0, err_msg=key)


# =========================================================================
# sequence_attention's choice of strategy
# =========================================================================

@pytest.mark.parametrize("sp,heads,kv_heads", [
    (2, 4, 4),     # heads divide: ulysses
    (2, 4, 2),     # grouped K/V divide too: ulysses, grouped
    (4, 4, 2),     # grouped K/V fit only the ring: ring
    (4, 4, 1),     # MQA: ring, grouped
    (8, 4, 4),     # heads do not divide: ring
    (3, 6, 6)])
@pytest.mark.parametrize("strategy", ["auto", "ring", "ulysses"])
def test_sequence_attention_choices_match_jax(monkeypatch, sp, heads,
                                              kv_heads, strategy):
    """Which body ``sequence_attention`` calls and with what K/V width,
    spied on both sides (no attention runs)."""
    import jax.numpy as jnp

    import torchbooster_tpu.parallel.ring as jring
    import torchbooster_tpu.parallel.ulysses as julysses
    from torchbooster_tpu.parallel.ulysses import (
        sequence_attention as jsequence,
    )
    from torchbooster_tpu_torch.parallel import ring, ulysses

    calls: list = []

    def spy(name):
        def fn(q, k, v, mesh, **kw):
            calls.append((name, k.shape[2]))
            return q
        return fn

    class FakeMesh:
        shape = {"sp": sp}
        axis_names = ("sp",)

    for mod, name in ((jring, "ring_attention"), (ring, "ring_attention"),
                      (julysses, "ulysses_attention"),
                      (ulysses, "ulysses_attention")):
        monkeypatch.setattr(mod, name, spy(name))
    q = np.zeros((1, 2 * sp, heads, 2), np.float32)
    kv = np.zeros((1, 2 * sp, kv_heads, 2), np.float32)
    outcome = []
    for fn, arr, mesh in ((jsequence, jnp.asarray, FakeMesh()),
                          (ulysses.sequence_attention, torch.from_numpy,
                           FakeMesh())):
        calls.clear()
        try:
            fn(arr(q), arr(kv), arr(kv), mesh, strategy=strategy)
            outcome.append(list(calls))
        except ValueError as err:
            outcome.append(str(err))
    assert outcome[1] == outcome[0]


# =========================================================================
# GPT on an sp mesh: learned and rope positions, GQA; dropout
# =========================================================================

def gpt_host(cfg_kw: dict, seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    return {"ids": rs.randint(0, cfg_kw["vocab"], (2, cfg_kw["seq_len"])),
            "labels": rs.randint(0, cfg_kw["vocab"], (2, cfg_kw["seq_len"]))}


def gpt_params_np(cfg_kw: dict) -> dict:
    params = GPT.init(0, GPTConfig(**cfg_kw), device="cpu")
    return {k: v for k, v in _np_tree(params).items()}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _torch_tree(tree, grad: bool = False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, grad) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(grad)


def _grads_np(tree):
    if isinstance(tree, dict):
        return {k: _grads_np(v) for k, v in tree.items()}
    return tree.grad.numpy()


def case_gpt_sp(spec: str, cfg_kw: dict, params: dict, host: dict,
                dropout_seed: int | None = None, remat: bool = False,
                attn_impl: str = "auto") -> dict:
    """This rank's loss (mean CE over its chunk) and the gradients of
    every leaf from its backward."""
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    mesh = dist.make_mesh(spec, device="cpu") if spec else None
    cfg = GPTConfig(**cfg_kw)
    p = _torch_tree(params, grad=True)
    b = dist.shard_batch(host, mesh) if mesh is not None else \
        {k: torch.from_numpy(v) for k, v in host.items()}
    gen = None if dropout_seed is None \
        else torch.Generator().manual_seed(dropout_seed)
    logits = GPT.apply(p, b["ids"], cfg, compute_dtype=torch.float32,
                       remat=remat, generator=gen, mesh=mesh,
                       attn_impl=attn_impl)
    loss = cross_entropy(logits, b["labels"])
    loss.backward()
    return {"loss": float(loss.detach()), "grads": _grads_np(p),
            "logits": logits.detach().numpy()}


def mean_grads(per_rank: list) -> dict:
    def walk(trees):
        if isinstance(trees[0], dict):
            return {k: walk([t[k] for t in trees]) for k in trees[0]}
        return np.mean(trees, axis=0)
    return walk([r["grads"] for r in per_rank])


def jax_gpt(spec: str, n: int, cfg_kw: dict, params: dict, host: dict):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
    from torchbooster_tpu.ops.losses import cross_entropy as jce

    mesh = jdist.make_mesh(spec, n)
    cfg = JCfg(**cfg_kw)
    data = tuple(a for a in ("dp", "fsdp") if a in mesh.axis_names) or None
    put = lambda a: jax.device_put(jnp.asarray(a.astype(np.int32)),
                                   NamedSharding(mesh, P(data, "sp")))

    def loss(p, ids, labels):
        logits = JGPT.apply(p, ids, cfg, mesh=mesh,
                            compute_dtype=jnp.float32, remat=False)
        return jce(logits.reshape(-1, cfg.vocab), labels.reshape(-1)), logits

    (value, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params), put(host["ids"]),
        put(host["labels"]))
    return float(value), jax.tree.map(np.asarray, grads), np.asarray(logits)


def assert_tree_close(got, want, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=path)


@pytest.mark.parametrize("extra,attn_impl", [
    (dict(pos="learned"), "auto"),
    (dict(pos="rope", n_kv_heads=2), "auto"),
    (dict(pos="rope", n_kv_heads=2, sp_strategy="ring"), "auto"),
    (dict(pos="rope", n_kv_heads=2, sp_strategy="ring"), "flash")],
    ids=["learned", "rope_gqa", "rope_gqa_ring", "rope_gqa_ring_flash"])
def test_gpt_at_sp2_matches_jax(pool, extra, attn_impl):
    """Logits, the loss (the mean of the two chunks' means) and every
    gradient (the mean over the ranks) against JAX's ``GPT.apply`` on an
    sp:2 mesh (its reference bodies): positions offset by the chunk,
    attention through ``sequence_attention`` — Ulysses, the ring's
    reference body, and the ring-flash body (``attn_impl="flash"``: the
    kernels' plain versions on the CPU; JAX's
    ``test_gpt_ring_flash_sequence_parallel_matches_single``). Losses
    1e-5 relative, logits 2e-5 and gradients 2e-5 absolute (fp32, other
    summation orders)."""
    cfg_kw = {**GPT_TINY, **extra}
    params = gpt_params_np(cfg_kw)
    host = gpt_host(cfg_kw)
    got = pool.run(case_gpt_sp, "sp:2", cfg_kw, params, host, None, False,
                   attn_impl)
    want_loss, want_grads, want_logits = jax_gpt("sp:2", 2, cfg_kw, params,
                                                 host)
    np.testing.assert_allclose(np.mean([r["loss"] for r in got]),
                               want_loss, rtol=1e-5)
    np.testing.assert_allclose(assemble(got, "logits"), want_logits,
                               atol=2e-5, rtol=0)
    assert_tree_close(mean_grads(got), want_grads, 2e-5)


def test_gpt_dropout_at_sp2_equals_sp1_and_replays_under_remat(pool):
    """Dropout 0.1 with one generator seed: each rank's masks are its
    slice of the masks one process draws over the whole sequence, so the
    sp:2 logits and gradients equal the port's sp:1 run (2e-5 absolute:
    the attention sums in another order), and at sp:2 remat on and off
    give bit-equal gradients (the recompute draws the same masks)."""
    cfg_kw = {**GPT_TINY, "pos": "rope", "dropout": 0.1}
    params = gpt_params_np(cfg_kw)
    host = gpt_host(cfg_kw, seed=2)
    one = case_gpt_sp("", cfg_kw, params, host, dropout_seed=7)
    got = pool.run(case_gpt_sp, "sp:2", cfg_kw, params, host, 7)
    remat = pool.run(case_gpt_sp, "sp:2", cfg_kw, params, host, 7, True)
    np.testing.assert_allclose(assemble(got, "logits"), one["logits"],
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(np.mean([r["loss"] for r in got]),
                               one["loss"], rtol=1e-5)
    assert_tree_close(mean_grads(got), one["grads"], 2e-5)
    for a, b in zip(got, remat):
        assert_tree_close(b["grads"], a["grads"], 0.0)


# =========================================================================
# gpt-long.yml's sp:8 mesh; ZeRO and explicit wires on model axes
# =========================================================================

def test_gpt_long_yml_loads_with_its_sp8_mesh_and_a_world_of_1_fails_as_jax():
    """``examples/lm/gpt/gpt-long.yml`` as published (``mesh: "sp:8"``,
    ``sp_strategy: auto``) loads, and a world that does not match the
    mesh fails with JAX's own mesh error."""
    pytest.importorskip("yaml")
    from pathlib import Path

    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu_torch.recipes import gpt as recipe

    path = Path(__file__).resolve().parents[1] / "examples" / "lm" / "gpt" \
        / "gpt-long.yml"
    conf = recipe.Config.load(path)
    assert conf.env.mesh == "sp:8" and conf.model.sp_strategy == "auto"
    assert conf.model.make().sp_strategy == "auto"
    with pytest.raises(ValueError) as want:
        jdist.parse_mesh_spec(conf.env.mesh, 1)
    with pytest.raises(ValueError) as got:
        conf.env.device("cpu")
    assert str(got.value) == str(want.value)


def case_comms_on(spec: str, kind: dict) -> str:
    from torchbooster_tpu_torch.comms import make_grad_comms, make_schedule

    mesh = dist.make_mesh(spec, device="cpu")
    try:
        if "legacy" in kind:
            make_grad_comms(mesh, *kind["legacy"])
        else:
            make_schedule(mesh, **kind)
    except ValueError as err:
        return str(err)
    return "ok"


@pytest.mark.parametrize("spec", ["sp:2", "ep:2"])
@pytest.mark.parametrize("kind", [{"stage": 1}, {"stage": 2, "wire": "int8"},
                                  {"legacy": ("bf16", False)},
                                  {"stage": 0, "wire": "implicit"}],
                         ids=["zero1", "zero2_int8", "bf16", "implicit"])
def test_comms_on_sp_and_ep_meshes_do_what_jax_does(pool, spec, kind):
    """ZeRO and explicit wires on a mesh with a live sp or ep axis raise
    JAX's message word for word; the implicit schedule builds."""
    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.comms import make_grad_comms, make_schedule

    mesh = jdist.make_mesh(spec, 2)
    try:
        if "legacy" in kind:
            make_grad_comms(mesh, *kind["legacy"])
        else:
            make_schedule(mesh, **kind)
        want = "ok"
    except ValueError as err:
        want = str(err)
    for got in pool.run(case_comms_on, spec, kind):
        assert got == want


@pytest.mark.parametrize("d,h,h_kv,s_chunk,fwd_route,bwd_route", [
    (48, 16, 8, 1024, "sm90", "sm90"),        # gpt-long's sp:8 chunk
    (64, 12, 12, 1024, "sm90", "sm90"),       # a 1024-long chunk at D 64
    (64, 12, 12, 128, "sm90", "sm90")])       # the MoE width's sp:8 chunk
def test_ring_chunk_routes(d, h, h_kv, s_chunk, fwd_route, bwd_route):
    """What ``plan_flash_fwd`` and ``plan_flash_bwd`` pick for the ring's
    chunk calls (S_q == S_kv == S/sp, bf16): B1 and B2/B3 take
    ``"sm90"`` at D 48 and D 64, at any chunk length."""
    from torchbooster_tpu_torch.ops import flash_attention as fa

    args = (torch.bfloat16, d, s_chunk, s_chunk, h // h_kv)
    assert fa.plan_flash_fwd(*args) == fwd_route
    assert fa.plan_flash_bwd(*args) == bwd_route
