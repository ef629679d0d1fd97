"""The port's CUDA kernels (B1-B8) against their plain PyTorch versions,
on a card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a card every test here skips (the CUDA kernels have no CPU
mode). ``paged_inputs`` is the small paged case that
``tests/test_torch_ops.py`` also holds against the JAX kernel.
"""
import numpy as np
import pytest
import torch

from torchbooster_tpu_torch.models.gpt import _quantize_kv
from torchbooster_tpu_torch.ops import paged_attention as pa

LAYOUTS = [(False, False, 1), (True, False, 3), (False, True, 3),
           (True, True, 3)]


def paged_inputs(rs, *, s_q, quantized, tree, kv_heads=2, n_heads=4,
                 head_dim=8, ps=4, n_pages=12, n_slots=3):
    """A small pool with three slots; slots 0 and 1 share their first
    page (one work entry, two lanes); slot 2 is referenced by nothing
    beyond its own pages; trailing work entries are null padding.
    Returns numpy ``k``/``v`` beside the port's pool tensors ``pk``/
    ``pv`` (``_quantize_kv`` pairs when ``quantized``)."""
    lens = np.array([6, 9, 3], np.int32)
    tables = {0: [3, 7, 5], 1: [3, 2, 9, 10], 2: [1, 4]}
    holders = {}
    for s, pages in tables.items():
        for idx, p in enumerate(pages):
            holders.setdefault(p, []).append((s, idx))
    live = sorted(holders)
    n_w, lanes = n_pages - 1, n_slots
    wp = np.zeros(n_w, np.int32)
    wr = np.full((n_w, lanes), -1, np.int32)
    wpos = np.zeros(n_w, np.int32)
    for i, p in enumerate(live):
        wp[i], wpos[i] = p, holders[p][0][1]
        for lane, (s, _) in enumerate(holders[p]):
            wr[i, lane] = s
    shape = (n_pages, ps, kv_heads, head_dim)
    k = rs.randn(*shape).astype(np.float32)
    v = rs.randn(*shape).astype(np.float32)
    q = rs.randn(n_slots, s_q, n_heads, head_dim).astype(np.float32)
    tvis = None
    if tree:
        tvis = np.zeros((n_slots, s_q, s_q), np.int32)
        parents = [0, 0, 1][:s_q]
        for s in range(n_slots):
            for j in range(s_q):
                node = j
                while True:
                    tvis[s, j, node] = 1
                    if node == 0:
                        break
                    node = parents[node]
    if quantized:
        pk, pv = _quantize_kv(torch.as_tensor(k)), _quantize_kv(
            torch.as_tensor(v))
    else:
        pk, pv = torch.as_tensor(k), torch.as_tensor(v)
    return dict(q=q, k=k, v=v, pk=pk, pv=pv, wp=wp, wr=wr, wpos=wpos,
                lens=lens, tvis=tvis, ps=ps,
                referenced=sorted({s for s in wr.reshape(-1) if s >= 0}))


def _on_card(x):
    """The case's kernel operands as CUDA tensors."""
    cuda = lambda t: t.cuda() if isinstance(t, torch.Tensor) \
        else tuple(a.cuda() for a in t)
    args = (cuda(torch.as_tensor(x["q"])), cuda(x["pk"]), cuda(x["pv"]),
            *(cuda(torch.as_tensor(x[n])) for n in ("wp", "wr", "wpos",
                                                    "lens")))
    tv = None if x["tvis"] is None else cuda(torch.as_tensor(x["tvis"]))
    return args, tv


@pytest.mark.cuda
@pytest.mark.parametrize("quantized,tree,s_q", LAYOUTS)
def test_paged_kernel_matches_plain_version_on_card(quantized, tree, s_q):
    """Every layout (plain/int8 pool, with/without tree mask), fp32 q:
    both sides accumulate in fp32, so 1e-5 covers summation order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    x = paged_inputs(np.random.RandomState(5), s_q=s_q,
                     quantized=quantized, tree=tree)
    args, tv = _on_card(x)
    before = pa.launches
    got = pa.paged_attention(*args, page_size=x["ps"], tree_vis=tv)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = pa.paged_attention_reference(*args, page_size=x["ps"],
                                        tree_vis=tv)
    ref = x["referenced"]
    torch.testing.assert_close(got[ref], want[ref], atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_paged_kernel_masked_lane_and_bad_operands_on_card():
    """A lane whose page is wholly past its slot's length adds nothing
    (no NaN); operands the kernel does not take raise, never fall back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    x = paged_inputs(np.random.RandomState(3), s_q=1, quantized=False,
                     tree=False)
    x["lens"] = x["lens"].copy()
    x["lens"][1] = 2                  # slot 1's later pages all masked
    args, _ = _on_card(x)
    got = pa.paged_attention(*args, page_size=x["ps"])
    torch.cuda.synchronize()
    want = pa.paged_attention_reference(*args, page_size=x["ps"])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=1e-5)
    before = pa.launches
    with pytest.raises(ValueError):   # pool left on the CPU
        pa.paged_attention(args[0], x["pk"], x["pv"], *args[3:],
                           page_size=x["ps"])
    with pytest.raises(ValueError):   # pool geometry != page_size
        pa.paged_attention(*args, page_size=2 * x["ps"])
    assert pa.launches == before


# B4's "sm90" route at GPT-2-small serving geometry (12 heads of 64,
# 64-token pages, 8 slots): name -> (kv heads, pool, S, tree mask, pages of
# a prefix every slot shares). Every case plans "sm90". The two GQA verify
# cases behind a shared prefix give an item 8 lanes x rep 3 x S 5 = 120
# query rows, more than the 64 a ring slot holds, so the kernel stages
# them in two rounds.
SM90_PAGED = {
    "gpt2_small_bf16_decode": (12, "bf16", 1, False, 0),
    "gpt2_small_gqa4_verify5": (4, "bf16", 5, False, 0),
    "gpt2_small_int8_tree5": (12, "int8", 5, True, 0),
    "gpt2_small_8lane_shared_prefix": (12, "bf16", 1, False, 4),
    "gpt2_small_gqa4_verify5_8lane_prefix": (4, "bf16", 5, False, 2),
    "gpt2_small_gqa4_int8_tree5_8lane_prefix": (4, "int8", 5, True, 2),
}


def gpt2_paged_case(rs, *, kv_heads, pool, s_q, tree, prefix_pages,
                    n_slots=8, ps=64, n_pages=80, n_heads=12, head_dim=64):
    """bf16 queries over a pool at GPT-2-small width, the compacted walk
    of ``BlockTables.kernel_args`` (live pages first, one lane per holder
    when pages are shared) and, with ``tree``, a random candidate tree
    per slot. Returns the kernel's operands on the card."""
    lens = rs.randint(prefix_pages * ps + 1, 500, n_slots)
    free = list(rs.permutation(np.arange(1, n_pages)))
    tables = [[int(free.pop()) for _ in range(-(-int(n + s_q) // ps))]
              for n in lens]
    for t in tables[1:]:
        t[:prefix_pages] = tables[0][:prefix_pages]
    holders = {}
    for s, pages in enumerate(tables):
        for idx, p in enumerate(pages):
            holders.setdefault(p, []).append((s, idx))
    n_lanes = n_slots if prefix_pages else 1
    wp = np.zeros(n_pages - 1, np.int32)
    wr = np.full((n_pages - 1, n_lanes), -1, np.int32)
    wpos = np.zeros(n_pages - 1, np.int32)
    for i, p in enumerate(sorted(holders)):
        wp[i], wpos[i] = p, holders[p][0][1]
        for lane, (s, _) in enumerate(holders[p]):
            wr[i, lane] = s
    shape = (n_pages, ps, kv_heads, head_dim)
    k = torch.as_tensor(rs.randn(*shape).astype(np.float32))
    v = torch.as_tensor(rs.randn(*shape).astype(np.float32))
    if pool == "int8":
        pk = tuple(a.cuda() for a in _quantize_kv(k))
        pv = tuple(a.cuda() for a in _quantize_kv(v))
    else:
        pk, pv = k.cuda().bfloat16(), v.cuda().bfloat16()
    q = torch.as_tensor(rs.randn(n_slots, s_q, n_heads, head_dim).astype(
        np.float32)).cuda().bfloat16()
    tv = None
    if tree:
        tv = np.zeros((n_slots, s_q, s_q), np.int32)
        for s in range(n_slots):
            parent = [0] + [int(rs.randint(0, j)) for j in range(1, s_q)]
            for j in range(s_q):
                node = j
                while True:
                    tv[s, j, node] = 1
                    if node == 0:
                        break
                    node = parent[node]
        tv = torch.as_tensor(tv).cuda()
    args = (q, pk, pv, *(torch.as_tensor(a).cuda() for a in
                         (wp, wr, wpos, lens.astype(np.int32))))
    return args, dict(page_size=ps, tree_vis=tv)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SM90_PAGED))
def test_paged_sm90_and_simt_match_plain_version_on_card(name):
    """The planned "sm90" route and "simt" forced on the same inputs, each
    held to the plain version. bf16 q: the sm90 kernel rounds P to bf16
    before P V (a tensor-core operand), so 2e-2 as in the smoke."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    kv_heads, pool, s_q, tree, prefix = SM90_PAGED[name]
    args, kw = gpt2_paged_case(np.random.RandomState(7), kv_heads=kv_heads,
                               pool=pool, s_q=s_q, tree=tree,
                               prefix_pages=prefix)
    kv = args[1][0] if pool == "int8" else args[1]
    assert pa.plan_paged(torch.bfloat16, kv.dtype, 64, 64, s_q,
                         12 // kv_heads) == "sm90"
    want = pa.paged_attention_reference(*args, **kw).float()
    for route in ("sm90", "simt"):
        before = pa.launches_by_route[route]
        got = pa.paged_attention(*args, **kw, route=route)
        torch.cuda.synchronize()
        assert pa.launches_by_route[route] == before + 1
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SM90_PAGED))
def test_paged_sm90_repeats_bit_for_bit_on_card(name):
    """Fixed-order sums and no atomics: two calls agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    kv_heads, pool, s_q, tree, prefix = SM90_PAGED[name]
    args, kw = gpt2_paged_case(np.random.RandomState(11), kv_heads=kv_heads,
                               pool=pool, s_q=s_q, tree=tree,
                               prefix_pages=prefix)
    a = pa.paged_attention(*args, **kw)
    b = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_paged_sm90_masked_lane_and_refused_operands_on_card():
    """A shared page wholly past one holder's length adds l = 0 and no NaN
    to that slot; a forced "sm90" on operands it does not take (fp32 q,
    page size 4) raises before any launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args, kw = gpt2_paged_case(np.random.RandomState(3), kv_heads=12,
                               pool="bf16", s_q=1, tree=False,
                               prefix_pages=4)
    lens = args[6].clone()
    lens[1] = 70                 # slot 1 sees 71 tokens of its 4 prefix pages
    args = (*args[:6], lens)
    got = pa.paged_attention(*args, **kw, route="sm90")
    torch.cuda.synchronize()
    want = pa.paged_attention_reference(*args, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    before = (pa.launches, dict(pa.launches_by_route))
    with pytest.raises(ValueError):   # fp32 queries are "simt"'s
        pa.paged_attention(args[0].float(), *args[1:], **kw, route="sm90")
    x = paged_inputs(np.random.RandomState(3), s_q=1, quantized=False,
                     tree=False)
    small, _ = _on_card(x)
    with pytest.raises(ValueError):   # 4-token pages, fp32
        pa.paged_attention(small[0].bfloat16(), small[1].bfloat16(),
                           small[2].bfloat16(), *small[3:],
                           page_size=x["ps"], route="sm90")
    assert (pa.launches, pa.launches_by_route) == before


def _spec_engines(spec_tree):
    """A small bf16 GPT on the card (head dim 64, 16-token pages, decisive
    head) served speculatively with draft_len 4 (S = 5) by two engines:
    B4 (``"kernel"``) and the pool sweep."""
    from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
    from torchbooster_tpu_torch.serving import PagedEngine

    cfg = GPTConfig(vocab=97, n_layers=2, d_model=128, n_heads=2,
                    seq_len=128)
    params = GPT.init(0, cfg, device="cuda")
    params["wte"]["table"] *= 4.0
    kw = dict(page_size=16, n_pages=24, max_slots=3, speculative=True,
              draft_len=4, spec_tree=spec_tree,
              compute_dtype=torch.bfloat16)
    return {b: PagedEngine(params, cfg, decode_backend=b, **kw)
            for b in ("kernel", "sweep")}


@pytest.mark.cuda
@pytest.mark.parametrize("spec_tree", [False, True], ids=["linear", "tree"])
def test_engine_spec_verify_on_sm90_matches_sweep_on_card(spec_tree,
                                                          monkeypatch):
    """The engine's verify step at S = 5 (and its tree mask) through B4 on
    ``"sm90"``: every launch on that route, each launch's output within
    2e-2 of the plain version on the same operands, and every token equal
    to the same engine on the pool sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from torchbooster_tpu_torch.serving import engine as engine_mod

    errs, s_qs = [], set()

    def checked(q, pk, pv, *walk, page_size, tree_vis=None):
        out = pa.paged_attention(q, pk, pv, *walk, page_size=page_size,
                                 tree_vis=tree_vis)
        want = pa.paged_attention_reference(q, pk, pv, *walk,
                                            page_size=page_size,
                                            tree_vis=tree_vis)
        live = walk[1][walk[1] >= 0].unique().long()
        errs.append(float((out[live].float() - want[live].float())
                          .abs().max()))
        s_qs.add(q.shape[1])
        return out

    monkeypatch.setattr(engine_mod, "paged_attention", checked)
    rs = np.random.RandomState(0)
    prompts = [np.tile(rs.randint(0, 97, n).astype(np.int32), r)
               for n, r in ((3, 6), (5, 4), (7, 3))]
    if spec_tree:                      # ambiguous: two continuations
        pat = rs.randint(0, 97, 5).astype(np.int32)
        prompts[0] = np.concatenate([pat, [11], pat, [13], pat, [11], pat])
    streams = {}
    before = dict(pa.launches_by_route)
    for backend, eng in _spec_engines(spec_tree).items():
        slots = {eng.admit(p)[0]: [] for p in prompts}
        for _ in range(10):
            assert eng.grow_slots() == []
            for slot, toks in eng.spec_step().items():
                slots[slot].extend(toks)
        streams[backend] = [slots[s][:20] for s in sorted(slots)]
        assert eng.verify_compiles == 1 and eng.decode_compiles == 0
        eng.tables.check()
        if backend == "kernel":
            n_steps = eng.spec_steps
            assert eng.spec_accepted > 0
    torch.cuda.synchronize()
    assert pa.launches_by_route["sm90"] - before["sm90"] == 2 * n_steps
    assert pa.launches_by_route["simt"] == before["simt"]
    assert s_qs == {5} and max(errs) <= 2e-2, max(errs)
    assert streams["kernel"] == streams["sweep"]


# B1-B3: (B, H, H_kv, S_q, S_kv, D, dtype, causal) — GPT-2-small training
# geometry (also with 4 kv heads and the KV-cache alignment S_q < S_kv), the
# GPT recipe default (d_model 256 / 8 heads = D 32, S 256, batch 32), head
# dim 128 at S 1024 and a non-causal case
FLASH_CASES = {
    "gpt2_small_bf16": (8, 12, 12, 1024, 1024, 64, torch.bfloat16, True),
    "gpt2_small_fp32": (8, 12, 12, 1024, 1024, 64, torch.float32, True),
    "gpt2_small_gqa4_bf16": (8, 12, 4, 1024, 1024, 64, torch.bfloat16, True),
    "sq256_skv1024_bf16": (8, 12, 12, 256, 1024, 64, torch.bfloat16, True),
    "recipe_default_d32_bf16": (32, 8, 8, 256, 256, 32, torch.bfloat16, True),
    # the third head dim built, with GQA and ragged lengths
    "d128_gqa2_ragged200_bf16": (2, 4, 2, 200, 200, 128, torch.bfloat16,
                                 True),
    "d128_ragged130_fp32": (2, 4, 4, 130, 130, 128, torch.float32, True),
    "d128_s1024_bf16": (4, 8, 8, 1024, 1024, 128, torch.bfloat16, True),
    "noncausal_s512_bf16": (4, 12, 12, 512, 512, 64, torch.bfloat16, False),
    # gpt-long's head dim (768 / 16 heads) and its GQA group of 2
    "gpt_long_d48_gqa2_bf16": (2, 16, 8, 1024, 1024, 48, torch.bfloat16,
                               True),
    "d48_gqa2_ragged200_fp32": (2, 4, 2, 200, 200, 48, torch.float32, True),
}
# the route each case's B1 (plan_flash_fwd) and B2/B3 (plan_flash_bwd) must
# take: the two plans agree on every case
FLASH_ROUTE = {"gpt2_small_bf16": "sm90", "gpt2_small_fp32": "f32",
               "gpt2_small_gqa4_bf16": "sm90", "sq256_skv1024_bf16": "sm90",
               "recipe_default_d32_bf16": "mma_sync",
               "d128_gqa2_ragged200_bf16": "sm90",
               "d128_ragged130_fp32": "f32", "d128_s1024_bf16": "sm90",
               "noncausal_s512_bf16": "sm90",
               "gpt_long_d48_gqa2_bf16": "mma_sync",
               "d48_gqa2_ragged200_fp32": "f32"}


def _flash_operands(name, seed=0):
    b, h, h_kv, s_q, s_kv, d, dtype, _ = FLASH_CASES[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(rows, s, d, generator=gen,
                             device="cuda").to(dtype)
                 for rows, s in ((b * h, s_q), (b * h_kv, s_kv),
                                 (b * h_kv, s_kv), (b * h, s_q)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain_versions_on_card(name):
    """B1 (o, lse), B2 (dq) and B3 (dk, dv) against their plain versions
    on the same inputs; all three on the route the case names (their
    per-route counters move). bf16: the tensor-core kernels round P and
    dS to bf16 before their second product, the plain version keeps them
    fp32, so a few bf16 ulp: 2e-2; fp32: summation order only, 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import flash_attention as fa

    dtype, causal = FLASH_CASES[name][6:]
    q, k, v, do = _flash_operands(name)
    d = q.shape[-1]
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    scale = d ** -0.5
    route = FLASH_ROUTE[name]
    shape = (dtype, d, q.shape[1], k.shape[1], q.shape[0] // k.shape[0])
    assert fa.plan_flash_bwd(*shape) == route
    assert fa.plan_flash_fwd(*shape) == route
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv,
              fa.launches_fwd_by_route[route],
              fa.launches_dq_by_route[route], fa.launches_dkv_by_route[route])
    o, lse = fa.launch_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, scale)
    dq, delta = fa.launch_dq(q, k, v, o_ref, lse_ref, do, causal, scale)
    dk, dv = fa.launch_dkv(q, k, v, lse_ref, do, delta, causal, scale)
    torch.cuda.synchronize()
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv,
            fa.launches_fwd_by_route[route],
            fa.launches_dq_by_route[route],
            fa.launches_dkv_by_route[route]) == tuple(n + 1 for n in before)
    want = (o_ref, lse_ref,
            fa.dq_reference(q, k, v, o_ref, lse_ref, do, causal, scale),
            *fa.dkv_reference(q, k, v, o_ref, lse_ref, do, causal, scale))
    for got, ref in zip((o, lse, dq, dk, dv), want):
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gpt2_small_gqa4_bf16",
                                  "d128_gqa2_ragged200_bf16",
                                  "noncausal_s512_bf16"])
def test_flash_bwd_sm90_repeats_bit_for_bit_on_card(name):
    """Two calls of B2 and of B3 on the ``"sm90"`` route, on the same
    inputs, give the same dq, delta, dk and dv bit for bit: every sum runs
    in a fixed order, the GQA group's included, with no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import flash_attention as fa

    causal = FLASH_CASES[name][7]
    q, k, v, do = _flash_operands(name, seed=2)
    scale = q.shape[-1] ** -0.5
    o, lse = fa.launch_fwd(q, k, v, causal, scale)
    runs = []
    for _ in range(2):
        dq, delta = fa.launch_dq(q, k, v, o, lse, do, causal, scale,
                                 route="sm90")
        runs.append((dq, delta, *fa.launch_dkv(q, k, v, lse, do, delta,
                                               causal, scale, route="sm90")))
    torch.cuda.synchronize()
    for one, two in zip(*runs):
        assert torch.equal(one, two)


# the bf16 cases B1 takes on its "sm90" route
SM90_FWD_CASES = sorted(n for n, r in FLASH_ROUTE.items() if r == "sm90")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SM90_FWD_CASES)
def test_flash_fwd_sm90_repeats_and_holds_to_mma_sync_on_card(name):
    """B1 on ``"sm90"`` twice on the same inputs: o and lse bit for bit
    (fixed-order sums, no atomics); and against B1 on ``"mma_sync"``
    (``flash_fwd_mma``) on the same inputs, within the bf16 allowance
    (2e-2): both round P to bf16, after other running maxima."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import flash_attention as fa

    causal = FLASH_CASES[name][7]
    q, k, v, _ = _flash_operands(name, seed=3)
    scale = q.shape[-1] ** -0.5
    before = dict(fa.launches_fwd_by_route)
    one = fa.launch_fwd(q, k, v, causal, scale)
    two = fa.launch_fwd(q, k, v, causal, scale, route="sm90")
    old = fa.launch_fwd(q, k, v, causal, scale, route="mma_sync")
    torch.cuda.synchronize()
    assert fa.launches_fwd_by_route == {
        **before, "sm90": before["sm90"] + 2,
        "mma_sync": before["mma_sync"] + 1}
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    for a, b in zip(one, old):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.cuda
def test_flash_autograd_step_takes_sm90_forward_on_card():
    """A bf16 autograd step through ``flash_attention`` (GQA 2, ragged
    S 200, D 64): B1, B2 and B3 each launch once on ``"sm90"``; o and the
    grads hold to the plain versions (2e-2, as the flash cases). A forward
    route that cannot take the operands raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, do = (torch.randn(8, 200, 64, generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn(4, 200, 64, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    counts = (fa.launches_fwd_by_route, fa.launches_dq_by_route,
              fa.launches_dkv_by_route)
    before = [dict(c) for c in counts]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    for now, was in zip(counts, before):
        assert now == {**was, "sm90": was["sm90"] + 1}
    scale = 64 ** -0.5
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True, scale)
    want = (o_ref, *fa.flash_attention_backward_reference(
        q, k, v, o_ref, lse_ref, do, True, scale))
    for got, ref in zip((out, *(t.grad for t in leaves)), want):
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    with pytest.raises(ValueError, match="forward: route"):
        fa.launch_fwd(q.float(), k.float(), v.float(), True, scale,
                      route="sm90")
    with pytest.raises(ValueError, match="forward: route"):
        fa.launch_fwd(q[:, :, :32].contiguous(), k[:, :, :32].contiguous(),
                      v[:, :, :32].contiguous(), True, scale, route="sm90")
    assert fa.launches_fwd_by_route == {**before[0],
                                        "sm90": before[0]["sm90"] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("mode", [0, 1], ids=["mn_major_b", "register_a"])
def test_wgmma_operand_forms_match_matmul_on_card(mode, n):
    """The two operand forms the ``"sm90"`` backward rests on, one 64-row
    tile each, against ``torch.matmul`` on the same bf16 tiles: B read
    MN-major through the transpose bit (N 128 spans two 64-column blocks,
    the descriptor's leading offset), and an accumulator re-packed as the
    register-A operand. Small integers keep every product and sum exact,
    so the two must be equal: a wrong layout is not a rounding error."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    a, w, b = (torch.randint(-2, 3, shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for shape in ((64, 64), (64, 64), (64, n)))
    got = fa.wgmma_probe(mode, a, w, b)
    lhs = a.float() if mode == 0 else (a.float() @ w.float().T).bfloat16()
    torch.cuda.synchronize()
    assert torch.equal(got, lhs.float() @ b.float())


@pytest.mark.cuda
def test_flash_autograd_and_bad_operands_on_card():
    """``flash_attention`` differentiates through B1-B3 (grads against the
    plain versions'); operands the kernels do not take raise, never fall
    back: a head dim that is not built, mixed dtypes, a strided operand,
    an lse of the wrong shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(8, 1000, 64, generator=gen, device="cuda")
                   for _ in range(4))       # ragged: no 64-tile divides 1000
    grads = []
    for route in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        if route == "kernel":
            out = fa.flash_attention(*leaves)
        else:
            out = fa._Flash.apply(*(t.cpu() for t in leaves), True,
                                  64 ** -0.5, 1000, 1000).cuda()
        out.backward(do)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    before = fa.launches_fwd
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(*(torch.randn(2, 64, 96, device="cuda")
                             for _ in range(3)))
    with pytest.raises(ValueError, match="every operand"):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.launch_fwd(q[:, ::2], k[:, ::2], v[:, ::2], True, 0.125)
    with pytest.raises(ValueError, match="shapes"):
        fa.launch_dq(q, k, v, q, q[:, :1, 0], do, True, 0.125)
    assert fa.launches_fwd == before
    # a route that cannot take the operands raises before any launch:
    # "sm90" at D 32 (and for fp32), "mma_sync" for fp32
    dq_before = dict(fa.launches_dq_by_route)
    q32 = torch.randn(4, 64, 32, device="cuda", dtype=torch.bfloat16)
    o32, lse32 = fa.launch_fwd(q32, q32, q32, True, 0.125)
    with pytest.raises(ValueError, match="route"):
        fa.launch_dq(q32, q32, q32, o32, lse32, q32, True, 0.125,
                     route="sm90")
    o, lse = fa.launch_fwd(q, k, v, True, 0.125)
    for route in ("sm90", "mma_sync"):
        with pytest.raises(ValueError, match="route"):
            fa.launch_dq(q, k, v, o, lse, do, True, 0.125, route=route)
    assert fa.launches_dq_by_route == dq_before


# B5-B8: ResNet-18 CIFAR geometries (batch 32 of the recipe's 512):
# (kind, B, H, W, Cin, Cout, stride) — the stem norm, a stride-2
# projection, the first and last stages' stride-1 3x3s
CONV_CASES = {
    "stem_gn": ("gn", 32, 32, 32, 64, 64, 1),
    "stage3_gn": ("gn", 32, 4, 4, 512, 512, 1),
    "stage1_proj_1x1_s2": ("1x1", 32, 32, 32, 64, 128, 2),
    "stage0_3x3": ("3x3", 32, 32, 32, 64, 64, 1),
    "stage3_3x3": ("3x3", 32, 4, 4, 512, 512, 1),
    # B8's one-pass routes at small batch: a cluster of 8 CTAs per sample
    # (B 3), a pack of 8 whose only pack holds 5 samples, a pack of 2
    "cluster_b3_3x3": ("3x3", 3, 32, 32, 64, 64, 1),
    "pack_rem_b5_3x3": ("3x3", 5, 4, 4, 512, 512, 1),
    "pack2_8sq_3x3": ("3x3", 4, 8, 8, 256, 256, 1),
    # a cluster whose second tile is partial (M = 196), and a pack of 2
    # 7x7 maps with Cin below one 64-channel step and a ragged Cout tile
    "cluster_partial_14sq_3x3": ("3x3", 2, 14, 14, 256, 256, 1),
    "pack_cin24_7sq_3x3": ("3x3", 3, 7, 7, 24, 48, 1),
    # widths off the 16-byte vectors: one-element loads, a ragged Cout
    # tile, 12 and 20 groups (clipped from 32)
    "odd_c12_gn": ("gn", 4, 7, 9, 12, 12, 1),
    "odd_cin12_cout40_3x3": ("3x3", 4, 7, 9, 12, 40, 1),
    # B7's one-pass routes: packs of 2 and 8 (the last pack partial), a
    # non-square map (20 outputs, 6 a tile), a ragged Cout tile; its
    # "mma_sync" route at Cin 12. B6's one-pass route over a cluster of 2,
    # of 7 (ResNet-50's 7² x 2048 norm) and of 1, the last over more
    # samples than the card holds CTAs at once
    "stage2_proj_1x1_s2": ("1x1", 4, 16, 16, 128, 256, 2),
    "pack_rem_b5_proj_1x1_s2": ("1x1", 5, 8, 8, 256, 512, 2),
    "nonsquare_7x9_1x1_s2": ("1x1", 3, 7, 9, 64, 128, 2),
    "cout40_1x1_s1": ("1x1", 2, 9, 9, 64, 40, 1),
    "odd_cin12_cout40_1x1_s2": ("1x1", 4, 7, 9, 12, 40, 2),
    "stage1_gn": ("gn", 4, 16, 16, 128, 128, 1),
    "r50_7sq_gn_2048": ("gn", 2, 7, 7, 2048, 2048, 1),
    "many_samples_7x9_gn": ("gn", 1000, 7, 9, 64, 64, 1),
    # B5's two samples a CTA (ResNet-18's 8² x 256 norm), the last CTA one
    "pack_rem_b3_8sq_gn": ("gn", 3, 8, 8, 256, 256, 1),
}
# the route each bf16 3x3 case must take (fp32 always takes "f32")
CONV3_ROUTE = {"stage0_3x3": "cluster", "stage3_3x3": "pack",
               "cluster_b3_3x3": "cluster", "pack_rem_b5_3x3": "pack",
               "pack2_8sq_3x3": "pack", "odd_cin12_cout40_3x3": "mma_sync",
               "cluster_partial_14sq_3x3": "cluster",
               "pack_cin24_7sq_3x3": "pack"}
# bf16: both sides compute in fp32 from the same bf16 values and round the
# output once (one bf16 ulp); fp32: summation order only
CONV_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def no_tf32():
    """Full-fp32 products in the plain versions: cuDNN runs fp32
    convolutions in TF32 unless told not to, which alone moves them by
    ~1e-3 from the kernels' fp32 sums."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _conv_operands(kind, b, h, w, cin, cout, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 3 if kind == "3x3" else 1
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    return dict(x=(rand(b, h, w, cin) * 2 + 0.5).to(dtype),
                dy=rand(b, h, w, cin).to(dtype),
                w=(rand(k, k, cin, cout) / (k * k * cin) ** 0.5).to(dtype),
                scale=1 + 0.1 * rand(cout), bias=0.1 * rand(cout))


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv_gn_kernels_match_plain_versions_on_card(name, dtype, relu,
                                                     no_tf32):
    """B5 (y, stats) and B6 (dx, partials), or B7/B8 (out, mu, rstd),
    against their plain versions on the same inputs (TF32 off); B8 on the
    route its case names (its per-route counter moves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gn

    kind, b, h, w, cin, cout, stride = CONV_CASES[name]
    a = _conv_operands(kind, b, h, w, cin, cout, dtype)
    tol = CONV_TOL[dtype]
    g = fb._resolve_groups(32, cout)
    if kind == "gn":
        before = (gn.launches_fwd, gn.launches_bwd)
        y, st = gn.launch_fwd(a["x"], a["scale"], a["bias"], g, 1e-5, relu)
        dx, part = gn.launch_bwd(a["x"], a["dy"], st, a["scale"], a["bias"],
                                 g, relu)
        torch.cuda.synchronize()
        assert (gn.launches_fwd, gn.launches_bwd) == tuple(
            n + 1 for n in before)
        y_ref, st_ref = gn.group_norm_fwd_reference(
            a["x"], a["scale"], a["bias"], g, 1e-5, relu)
        dx_ref, part_ref = gn.group_norm_bwd_reference(
            a["x"], a["dy"], st, a["scale"], a["bias"], g, relu)
        pairs = ((y, y_ref), (st, st_ref), (dx, dx_ref), (part, part_ref))
    else:
        launch = fb.launch_1x1 if kind == "1x1" else fb.launch_3x3
        extra = {"stride": stride} if kind == "1x1" else {}
        counter = "launches_1x1" if kind == "1x1" else "launches_3x3"
        before = getattr(fb, counter)
        route = CONV3_ROUTE.get(name) if dtype == torch.bfloat16 else "f32"
        if kind == "3x3":
            by_route = fb.launches_3x3_by_route[route]
        got = launch(a["x"], a["w"], a["scale"], a["bias"], g, 1e-5, relu,
                     **extra)
        torch.cuda.synchronize()
        assert getattr(fb, counter) == before + 1
        if kind == "3x3":
            assert fb.launches_3x3_by_route[route] == by_route + 1
        want = fb.conv_gn_reference(a["x"], a["w"], a["scale"], a["bias"],
                                    g, 1e-5, relu, stride)
        pairs = tuple(zip(got, want))
    for g, r in pairs:
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stage0_3x3", "pack_rem_b5_3x3",
                                  "odd_cin12_cout40_3x3"])
def test_conv3x3_repeats_bit_for_bit_on_card(name):
    """Two bf16 B8 calls on the same inputs give the same out, mu and rstd
    bit for bit: every sum, across CTAs of a cluster too, runs in a fixed
    order with no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import fused_block as fb

    kind, b, h, w, cin, cout, _ = CONV_CASES[name]
    a = _conv_operands(kind, b, h, w, cin, cout, torch.bfloat16, seed=2)
    g = fb._resolve_groups(32, cout)
    first, second = (fb.launch_3x3(a["x"], a["w"], a["scale"], a["bias"], g)
                     for _ in range(2))
    torch.cuda.synchronize()
    for one, two in zip(first, second):
        assert torch.equal(one, two)


@pytest.mark.cuda
def test_conv_gn_autograd_and_bad_operands_on_card(no_tf32):
    """``group_norm_fused``, ``conv1x1_gn_relu`` (stride 2) and
    ``conv3x3_gn_relu`` differentiate on the card (fp32, TF32 off) as the
    same calls do on the CPU (1e-4); operands the kernels do not take
    raise, never fall back: a weight or scale left on the CPU, fp16, a
    strided x."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gn

    a = _conv_operands("3x3", 4, 9, 7, 64, 64, torch.float32, seed=1)
    calls = {
        "gn": lambda x, w, s, b: gn.group_norm_fused(s, b, x, 32,
                                                     relu=True),
        "1x1": lambda x, w, s, b: fb.conv1x1_gn_relu(
            x, w[1:2, 1:2], s, b, 32, relu=True, stride=2),
        "3x3": lambda x, w, s, b: fb.conv3x3_gn_relu(x, w, s, b, 32),
    }
    for name, call in calls.items():
        grads = []
        for dev in ("cuda", "cpu"):
            leaves = [a[k].detach().to(dev).requires_grad_()
                      for k in ("x", "w", "scale", "bias")]
            out = call(*leaves)
            out.backward(torch.ones_like(out) * 0.1 + out.detach())
            grads.append([t.grad.cpu() if t.grad is not None
                          else torch.zeros(()) for t in leaves])
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4,
                                       msg=name)
    x, w, s, b = (a[k] for k in ("x", "w", "scale", "bias"))
    before = (gn.launches_fwd, fb.launches_3x3)
    with pytest.raises(ValueError, match="on cuda|expected"):
        gn.launch_fwd(x, s.cpu(), b, 32)
    with pytest.raises(TypeError, match="dtype"):
        gn.launch_fwd(x.half(), s, b, 32)
    with pytest.raises(ValueError, match="contiguous"):
        gn.launch_fwd(x[:, :, ::2], s, b, 32)
    with pytest.raises(ValueError, match="every operand"):
        fb.launch_3x3(x, w.cpu(), s, b, 32)
    with pytest.raises(ValueError, match="every operand"):
        fb.launch_3x3(x, w.bfloat16(), s, b, 32)
    with pytest.raises(ValueError, match="contiguous"):
        fb.launch_3x3(x.transpose(1, 2), w, s, b, 32)
    assert (gn.launches_fwd, fb.launches_3x3) == before


# the older route each one-pass route is forced onto, on the same inputs
OLDER_ROUTE = {"one_pass": "two_pass", "cluster": "mma_sync",
               "pack": "mma_sync"}


def _planned(name, dtype):
    """B6's or B7's planned route for a ``CONV_CASES`` entry."""
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gn

    kind, b, h, w, cin, cout, stride = CONV_CASES[name]
    if kind == "gn":
        return gn.plan_gn_bwd(b, h * w, cin, fb._resolve_groups(32, cin),
                              dtype).route
    if dtype == torch.float32:
        return "f32"
    return fb.plan_conv1x1(b, h, w, cin, cout, fb._resolve_groups(32, cout),
                           stride).route


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(n for n, c in CONV_CASES.items()
                                        if c[0] in ("gn", "1x1")))
def test_gn_bwd_and_conv1x1_routes_match_plain_versions_on_card(
        name, dtype, relu, no_tf32):
    """B6 (dx, partials) and B7 (out, mu, rstd) on the route their plans
    name, each launch moving its per-route counter there; a one-pass case
    also forced onto the older route on the same inputs; every result
    against the plain version (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gn

    kind, b, h, w, cin, cout, stride = CONV_CASES[name]
    a = _conv_operands(kind, b, h, w, cin, cout, dtype)
    tol = CONV_TOL[dtype]
    g = fb._resolve_groups(32, cout)
    planned = _planned(name, dtype)
    routes = [None] + ([OLDER_ROUTE[planned]] if planned in OLDER_ROUTE
                       else [])
    if kind == "gn":
        _, st = gn.group_norm_fwd_reference(a["x"], a["scale"], a["bias"], g,
                                            1e-5, relu)
        want = gn.group_norm_bwd_reference(a["x"], a["dy"], st, a["scale"],
                                           a["bias"], g, relu)
        counter = gn.launches_bwd_by_route
        call = lambda r: gn.launch_bwd(a["x"], a["dy"], st, a["scale"],  # noqa: E731
                                       a["bias"], g, relu, route=r)
    else:
        want = fb.conv_gn_reference(a["x"], a["w"], a["scale"], a["bias"],
                                    g, 1e-5, relu, stride)
        counter = fb.launches_1x1_by_route
        call = lambda r: fb.launch_1x1(a["x"], a["w"], a["scale"],  # noqa: E731
                                       a["bias"], g, 1e-5, relu, stride,
                                       route=r)
    for route in routes:
        before = dict(counter)
        got = call(route)
        torch.cuda.synchronize()
        took = route or planned
        assert counter == {**before, took: before[took] + 1}
        for one, ref in zip(got, want):
            torch.testing.assert_close(one.float(), ref.float(), atol=tol,
                                       rtol=tol)
    if kind == "gn" and planned == "one_pass":
        # the one-pass kernel at the fewest CTAs a sample that fit one an SM
        plan = gn.gn_bwd_plan(h * w, cin, g, 1)
        got = gn._launch_one_pass(a["x"], a["dy"], st, a["scale"], a["bias"],
                                  g, relu, plan)
        for one, ref in zip(got, want):
            torch.testing.assert_close(one.float(), ref.float(), atol=tol,
                                       rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stage1_proj_1x1_s2",
                                  "pack_rem_b5_proj_1x1_s2", "stem_gn",
                                  "stage1_gn", "many_samples_7x9_gn",
                                  "r50_7sq_gn_2048"])
def test_gn_bwd_and_conv1x1_one_pass_repeat_bit_for_bit_on_card(name):
    """Two bf16 calls on B7's "cluster" and "pack" routes, and on B6's
    "one_pass" route at clusters of 4, 2, 1 and 7 CTAs, give the same
    results bit for bit: every sum runs in a fixed order with no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gn

    kind, b, h, w, cin, cout, stride = CONV_CASES[name]
    a = _conv_operands(kind, b, h, w, cin, cout, torch.bfloat16, seed=2)
    g = fb._resolve_groups(32, cout)
    assert _planned(name, torch.bfloat16) in OLDER_ROUTE
    if kind == "gn":
        _, st = gn.group_norm_fwd_reference(a["x"], a["scale"], a["bias"], g)
        first, second = (gn.launch_bwd(a["x"], a["dy"], st, a["scale"],
                                       a["bias"], g, True) for _ in range(2))
    else:
        first, second = (fb.launch_1x1(a["x"], a["w"], a["scale"], a["bias"],
                                       g, 1e-5, False, stride)
                         for _ in range(2))
    torch.cuda.synchronize()
    for one, two in zip(first, second):
        assert torch.equal(one, two)


@pytest.mark.cuda
def test_gn_bwd_and_conv1x1_refuse_routes_that_do_not_fit_on_card():
    """A one-pass route named where the plan did not choose it (Cin 12, C
    12, fp32, a pack forced onto "cluster") raises, as does an unknown
    route; nothing launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gn

    before = (dict(fb.launches_1x1_by_route), dict(gn.launches_bwd_by_route))
    for name, dtype, route in (("odd_cin12_cout40_1x1_s2", torch.bfloat16,
                                "pack"),
                               ("stage1_proj_1x1_s2", torch.float32,
                                "cluster"),
                               ("stage2_proj_1x1_s2", torch.bfloat16,
                                "cluster"),
                               ("stage1_proj_1x1_s2", torch.bfloat16,
                                "sm90")):
        kind, b, h, w, cin, cout, stride = CONV_CASES[name]
        a = _conv_operands(kind, b, h, w, cin, cout, dtype)
        with pytest.raises(ValueError, match="route"):
            fb.launch_1x1(a["x"], a["w"], a["scale"], a["bias"],
                          fb._resolve_groups(32, cout), stride=stride,
                          route=route)
    for name, dtype, route in (("odd_c12_gn", torch.bfloat16, "one_pass"),
                               ("stem_gn", torch.float32, "one_pass"),
                               ("stem_gn", torch.bfloat16, "cluster")):
        kind, b, h, w, cin, cout, _ = CONV_CASES[name]
        a = _conv_operands(kind, b, h, w, cin, cout, dtype)
        g = fb._resolve_groups(32, cin)
        _, st = gn.group_norm_fwd_reference(a["x"], a["scale"], a["bias"], g)
        with pytest.raises(ValueError, match="route"):
            gn.launch_bwd(a["x"], a["dy"], st, a["scale"], a["bias"], g,
                          route=route)
    assert (fb.launches_1x1_by_route, gn.launches_bwd_by_route) == before


# B5's GroupNorm geometries (its planned route: "one_pass" at bf16 but C 12)
GN_CASES = sorted(n for n, c in CONV_CASES.items() if c[0] == "gn")


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("name", GN_CASES)
def test_gn_fwd_routes_match_plain_version_on_card(name, relu):
    """B5 (y, stats) at bf16 on the route ``plan_gn_fwd`` names, its
    per-route counter moving there, and forced onto ``"two_pass"`` on the
    same inputs; both against the plain version within one bf16 ulp of y.
    B6 on its planned route from the one-pass stats holds to the plain
    backward; the one-pass kernel at the sweep's other plans (four or three
    CTAs an SM, two samples a CTA) holds too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gn

    kind, b, h, w, cin, cout, _ = CONV_CASES[name]
    a = _conv_operands(kind, b, h, w, cin, cout, torch.bfloat16)
    tol = CONV_TOL[torch.bfloat16]
    g = fb._resolve_groups(32, cin)
    x, s, bi = a["x"], a["scale"], a["bias"]
    plan = gn.plan_gn_fwd(b, h * w, cin, g, torch.bfloat16)
    assert plan.route == ("two_pass" if cin % 8 else "one_pass")
    want = gn.group_norm_fwd_reference(x, s, bi, g, 1e-5, relu)
    results = {}
    for route in [None] + (["two_pass"] if plan.route == "one_pass" else []):
        before = dict(gn.launches_fwd_by_route)
        results[route] = gn.launch_fwd(x, s, bi, g, 1e-5, relu, route=route)
        torch.cuda.synchronize()
        took = route or plan.route
        assert gn.launches_fwd_by_route == {**before, took: before[took] + 1}
        for one, ref in zip(results[route], want):
            torch.testing.assert_close(one.float(), ref.float(), atol=tol,
                                       rtol=tol)
    y, st = results[None]
    dx, part = gn.launch_bwd(x, a["dy"], st, s, bi, g, relu)
    for one, ref in zip((dx, part), gn.group_norm_bwd_reference(
            x, a["dy"], st, s, bi, g, relu)):
        torch.testing.assert_close(one.float(), ref.float(), atol=tol,
                                   rtol=tol)
    if plan.route == "one_pass":
        for other in (gn.gn_fwd_plan(h * w, cin, g, 4),
                      gn.gn_fwd_plan(h * w, cin, g, 3),
                      gn.gn_fwd_plan(h * w, cin, g, 1, pack=2)):
            if other is None:
                continue
            got = gn._launch_fwd_one_pass(x, s, bi, g, 1e-5, relu, other)
            for one, ref in zip(got, want):
                torch.testing.assert_close(one.float(), ref.float(),
                                           atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stem_gn", "stage1_gn", "stage3_gn",
                                  "many_samples_7x9_gn", "r50_7sq_gn_2048",
                                  "pack_rem_b3_8sq_gn"])
def test_gn_fwd_one_pass_repeats_bit_for_bit_on_card(name):
    """Two bf16 B5 calls on ``"one_pass"`` (clusters of 2, 1 and 5 CTAs;
    two samples a CTA) give the same y and stats bit for bit: every sum
    runs in a fixed order with no atomics, across a cluster's CTAs too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gn

    kind, b, h, w, cin, cout, _ = CONV_CASES[name]
    a = _conv_operands(kind, b, h, w, cin, cout, torch.bfloat16, seed=2)
    g = fb._resolve_groups(32, cin)
    assert gn.plan_gn_fwd(b, h * w, cin, g, torch.bfloat16).route \
        == "one_pass"
    first, second = (gn.launch_fwd(a["x"], a["scale"], a["bias"], g, 1e-5,
                                   True) for _ in range(2))
    torch.cuda.synchronize()
    for one, two in zip(first, second):
        assert torch.equal(one, two)


@pytest.mark.cuda
def test_gn_fwd_refuses_routes_and_operands_it_does_not_take_on_card():
    """``"one_pass"`` named where the plan did not choose it (C 12, fp32)
    raises, as do an unknown route and operands the kernels do not take
    (fp16, a strided x, scale on the CPU, stats-shaped scale); nothing
    launches and no counter moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gn

    before = (gn.launches_fwd, dict(gn.launches_fwd_by_route))
    for name, dtype, route in (("odd_c12_gn", torch.bfloat16, "one_pass"),
                               ("stem_gn", torch.float32, "one_pass"),
                               ("stem_gn", torch.bfloat16, "cluster")):
        kind, b, h, w, cin, cout, _ = CONV_CASES[name]
        a = _conv_operands(kind, b, h, w, cin, cout, dtype)
        with pytest.raises(ValueError, match="route"):
            gn.launch_fwd(a["x"], a["scale"], a["bias"],
                          fb._resolve_groups(32, cin), route=route)
    a = _conv_operands("gn", 4, 16, 16, 128, 128, torch.bfloat16)
    x, s, bi = a["x"], a["scale"], a["bias"]
    with pytest.raises(TypeError, match="dtype"):
        gn.launch_fwd(x.half(), s, bi, 32)
    with pytest.raises(ValueError, match="contiguous"):
        gn.launch_fwd(x[:, :, ::2], s, bi, 32)
    with pytest.raises(ValueError, match="expected"):
        gn.launch_fwd(x, s.cpu(), bi, 32)
    with pytest.raises(ValueError, match="expected"):
        gn.launch_fwd(x, s.bfloat16(), bi, 32)
    assert (gn.launches_fwd, gn.launches_fwd_by_route) == before


@pytest.mark.cuda
def test_dropout_masks_on_a_cuda_generator_on_card():
    """The model's dropout draws its mask on the card from a generator
    there: kept share 0.9 +- 0.005 over 10^6 elements, kept values
    exactly ``x / 0.9`` in bf16, one generator state one mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA generator has no CPU mode")
    from torchbooster_tpu_torch.models.gpt import _dropout

    x = torch.randn(1000, 1000, device="cuda").bfloat16()
    gen = torch.Generator("cuda").manual_seed(0)
    state = gen.get_state()
    y = _dropout(x, 0.1, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) <= 0.005
    assert torch.equal(y[kept], (x / 0.9)[kept])
    gen.set_state(state)
    assert torch.equal(_dropout(x, 0.1, gen), y)
    assert not torch.equal(_dropout(x, 0.1, gen), y)


@pytest.mark.cuda
def test_save_callback_round_trip_of_a_cuda_train_state_on_card(tmp_path):
    """A ``TrainState`` on the card (params, AdamW moments after a step,
    the step and its CUDA generator) saved and restored into a fresh one
    in place, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torchbooster_tpu_torch.callbacks import SaveCallback
    from torchbooster_tpu_torch.config import OptimizerConfig
    from torchbooster_tpu_torch.utils import TrainState, tree_leaves

    tx = OptimizerConfig(name="adamw", lr=1e-2, weight_decay=0.1).make()

    def fresh(seed):
        gen = torch.Generator("cuda").manual_seed(seed)
        params = {"w": torch.randn(64, 32, device="cuda", generator=gen),
                  "b": torch.zeros(32, device="cuda")}
        return TrainState.create(params, tx, generator=seed)

    state = fresh(1)
    loss = (state.params["w"].square().sum() + state.params["b"].sum())
    loss.backward()
    state.optimizer.step()
    state.step = 1
    torch.rand(3, generator=state.generator, device="cuda")
    assert state.generator.device.type == "cuda"
    cb = SaveCallback(every=1, n_iter=10, root=tmp_path)
    cb.save(1, state=state)
    other = fresh(2)
    restored = cb.restore(like={"state": other})
    assert restored["state"] is other and other.step == 1
    for a, b in zip(tree_leaves(other.params), tree_leaves(state.params)):
        assert a.device.type == "cuda" and torch.equal(a, b)
    sa = other.optimizer.state_dict()["state"]
    sb = state.optimizer.state_dict()["state"]
    for i in sb:
        for key in sb[i]:
            assert torch.equal(sa[i][key].cpu(), sb[i][key].cpu())
    assert torch.equal(other.generator.get_state(),
                       state.generator.get_state())
    assert torch.equal(torch.rand(5, generator=other.generator,
                                  device="cuda"),
                       torch.rand(5, generator=state.generator,
                                  device="cuda"))
