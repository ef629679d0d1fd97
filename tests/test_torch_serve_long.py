"""Port parity at gpt-long's head geometry on the CPU: the serving path
whose B4 launches run ``paged_decode_sm90.cu`` at head dim 48 on the
card, held to the JAX package.

- a gpt-long-shaped small model (``examples/lm/gpt/gpt-long.yml``'s
  vocab 256, rope, 16 heads over 8 of 48 cut to 2 layers, d_model 192,
  4 heads over 2 of 48; decisive tied head; fp32) served through
  ``ServingConfig.make(..., device="cpu")`` on both decode backends,
  greedy token-exact against JAX ``jit_generate`` and JAX's
  ``PagedEngine`` on its ``"xla"`` backend; the engine's construction
  check plans B4's ``"sm90"`` route for the same geometry at bf16;
- ``paged_attention_reference`` (the card kernel's plain version) at
  head dim 48 against JAX's Pallas ``paged_attention`` in interpret
  mode: bf16 and int8 pools, decode, GQA verify S 5, a tree at S 5, two
  lanes sharing a page;
- the flash forward's plan at ``sm_scale <= 0``: ``"mma_sync"`` where
  the backward plans ``"sm90"``.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models import gpt as jgpt
from torchbooster_tpu.models.gpt import _quantize_kv as jax_quantize_kv
from torchbooster_tpu.ops.paged_attention import paged_attention as jax_paged
from torchbooster_tpu.serving import PagedEngine as JaxEngine
from torchbooster_tpu_torch.config import ServingConfig
from torchbooster_tpu_torch.interop import params_from_jax, to_numpy
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig, _quantize_kv
from torchbooster_tpu_torch.ops import flash_attention as fa
from torchbooster_tpu_torch.serving import Request
pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

LONG_SMALL = dict(vocab=256, n_layers=2, d_model=192, n_heads=4,
                  n_kv_heads=2, seq_len=128, pos="rope")
PROMPT_LENS = (23, 47, 70)
N_NEW = 6
PAGE = 16


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test processes, OpenMP's
    barriers would otherwise stall on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _model():
    """One numpy tree in JAX's layout (the port's ``GPT.init`` at seed 0,
    tied embeddings x4: a decisive head) as JAX's parameters and, through
    ``params_from_jax``, the port's on the CPU; cached, so callers must
    not mutate either tree."""
    cfg = GPTConfig(**LONG_SMALL)
    tree = to_numpy(GPT.init(0, cfg, device="cpu"))
    tree["wte"]["table"] = tree["wte"]["table"] * 4.0
    return (jax.tree.map(jnp.asarray, tree), jgpt.GPTConfig(**LONG_SMALL),
            params_from_jax(tree, cfg, "cpu"), cfg)


def _prompts():
    rs = np.random.RandomState(3)
    return [rs.randint(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


@functools.lru_cache(maxsize=None)
def _jax_streams():
    """JAX ``jit_generate`` per prompt, and JAX's paged engine (``"xla"``
    backend) over all three prompts in one pool."""
    jp, jcfg, _, _ = _model()
    fn = jgpt.jit_generate(jcfg, n_new=N_NEW, temperature=0.0,
                           compute_dtype=jnp.float32)
    dense = [np.asarray(fn(jp, jnp.asarray(p)[None], jax.random.PRNGKey(0))
                        )[0, len(p):].tolist() for p in _prompts()]
    eng = JaxEngine(jp, jcfg, page_size=PAGE, n_pages=24, max_slots=3,
                    compute_dtype=jnp.float32, decode_backend="xla")
    seated = [eng.admit(p) for p in _prompts()]
    paged = [[first] for _, first in seated]
    for _ in range(N_NEW - 1):
        assert eng.grow_slots() == []
        toks = eng.step()
        for (slot, _), out in zip(seated, paged):
            out.append(int(toks[slot]))
    return dense, paged


@pytest.mark.parametrize("backend", ["sweep", "kernel"])
def test_gpt_long_shaped_model_serves_token_exact_against_jax(backend):
    _, _, tp, cfg = _model()
    assert cfg.head_dim == 48
    dense, paged = _jax_streams()
    assert paged == dense
    batcher = ServingConfig(page_size=PAGE, n_pages=24, max_slots=3,
                            decode_backend=backend).make(
        tp, cfg, compute_dtype="float32", device="cpu",
        on_recompile="raise")
    reqs = [Request(prompt=p, max_new_tokens=N_NEW) for p in _prompts()]
    m = batcher.run(reqs)
    batcher.engine.tables.check()
    assert [r.tokens for r in reqs] == dense
    assert batcher.engine.decode_compiles == 1
    assert m["n_requests"] == 3 and m["new_tokens"] == 3 * N_NEW
    # the same geometry at bf16 passes the card engine's construction
    # check on B4's "sm90" route, over a bf16 and an int8 pool
    rep = cfg.n_heads // cfg.kv_heads
    for pool in (torch.bfloat16, torch.int8):
        assert pa.check_paged(torch.bfloat16, pool, 48, PAGE, 1, rep) \
            == "sm90"


def _d48_case(rs, *, s_q, quantized, tree, kv_heads=2, n_heads=4,
              n_pages=10):
    """Three slots over 16-token pages at head dim 48; slots 0 and 1 share
    their first page (one work entry, two lanes); two trailing entries
    are null padding. bf16 queries; the pool bf16, or int8 with bf16
    scales. Returns the port's and JAX's operands from one numpy draw."""
    lens = np.array([20, 37, 9], np.int32)
    tables = {0: [4, 7], 1: [4, 2, 9], 2: [1]}
    holders = {}
    for s, pages in tables.items():
        for idx, p in enumerate(pages):
            holders.setdefault(p, []).append((s, idx))
    live = sorted(holders)
    n_w, lanes = len(live) + 2, 2
    wp = np.zeros(n_w, np.int32)
    wr = np.full((n_w, lanes), -1, np.int32)
    wpos = np.zeros(n_w, np.int32)
    for i, p in enumerate(live):
        wp[i], wpos[i] = p, holders[p][0][1]
        for lane, (s, _) in enumerate(holders[p]):
            wr[i, lane] = s
    bf16 = lambda a: torch.as_tensor(a).bfloat16()
    shape = (n_pages, PAGE, kv_heads, 48)
    k, v = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    q = bf16(rs.randn(3, s_q, n_heads, 48).astype(np.float32))
    if quantized:
        pk, pv = _quantize_kv(torch.as_tensor(k)), _quantize_kv(
            torch.as_tensor(v))
        jk, jv = (tuple(jax_quantize_kv(jnp.asarray(a))) for a in (k, v))
    else:
        pk, pv = bf16(k), bf16(v)
        jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (pk, pv))
    tvis = None
    if tree:
        tvis = np.zeros((3, s_q, s_q), np.int32)
        parents = [0, 0, 0, 1, 1][:s_q]       # two branches off the root
        for s in range(3):
            for j in range(s_q):
                node = j
                while True:
                    tvis[s, j, node] = 1
                    if node == 0:
                        break
                    node = parents[node]
    port = (q, pk, pv, *(torch.as_tensor(a) for a in (wp, wr, wpos, lens)))
    jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    jx = (jq, jk, jv, *(jnp.asarray(a) for a in (wp, wr, wpos, lens)))
    return port, jx, tvis


@pytest.mark.parametrize("s_q,quantized,tree", [
    (1, False, False), (1, True, False), (5, False, False),
    (5, True, True)])
def test_paged_reference_d48_matches_jax_kernel(s_q, quantized, tree):
    """bf16 q at head dim 48, GQA rep 2, every slot referenced (two
    through a shared page): both sides widen to fp32 and round o to bf16
    once, so they agree within one bf16 rounding (rtol 2^-7)."""
    port, jx, tvis = _d48_case(np.random.RandomState(4), s_q=s_q,
                               quantized=quantized, tree=tree)
    want = np.asarray(jax_paged(
        *jx, page_size=PAGE, tree_vis=None if tvis is None
        else jnp.asarray(tvis), interpret=True).astype(jnp.float32))
    got = pa.paged_attention_reference(
        *port, page_size=PAGE,
        tree_vis=None if tvis is None else torch.as_tensor(tvis))
    assert got.dtype == torch.bfloat16 and got.shape == port[0].shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5,
                               rtol=2.0 ** -7)


@pytest.mark.parametrize("head_dim", [48, 64, 128])
def test_flash_fwd_plans_mma_sync_at_non_positive_scale(head_dim):
    """At bf16 D 48/64/128 (S 8192, GQA 2) the backward plans ``"sm90"``;
    the forward plans ``"mma_sync"`` at ``sm_scale <= 0`` and the
    backward's route at a positive scale, and a forward launch on checked
    operands is held to that plan."""
    bf16 = torch.bfloat16
    assert fa.plan_flash_bwd(bf16, head_dim, 8192, 8192, 2) == "sm90"
    for scale in (0.0, -head_dim ** -0.5):
        assert fa.plan_flash_fwd(bf16, head_dim, 8192, 8192, 2,
                                 sm_scale=scale) == "mma_sync"
    for scale in (None, head_dim ** -0.5):
        assert fa.plan_flash_fwd(bf16, head_dim, 8192, 8192, 2,
                                 sm_scale=scale) == "sm90"
    q = torch.zeros(4, 64, head_dim, dtype=bf16)
    k = torch.zeros(2, 64, head_dim, dtype=bf16)
    held = lambda scale: fa._held_route(fa.plan_flash_fwd, "forward", q, k,
                                        None, (q, k), sm_scale=scale)
    assert held(0.0) == "mma_sync" and held(head_dim ** -0.5) == "sm90"
