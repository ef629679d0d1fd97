"""The port's CUDA kernels (B1-B8) against their plain PyTorch versions,
on a card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a card every test here skips (the CUDA kernels have no CPU
mode). ``paged_inputs`` is the small paged case that
``tests/test_torch_ops.py`` also holds against the JAX kernel.
"""
import importlib
import numpy as np
import pytest
import torch

from torchbooster_tpu_torch.models.gpt import _quantize_kv
pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

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
# 64-token pages, 8 slots) and at gpt-long's (16 heads over 8 kv heads of
# 48): name -> (kv heads, pool, S, tree mask, pages of a prefix every slot
# shares, heads, head dim). Every case plans "sm90". The two GQA verify
# cases behind a shared prefix give an item 8 lanes x rep 3 x S 5 = 120
# query rows, more than the 64 a ring slot holds, so the kernel stages
# them in two rounds. At head dim 48 the kernel's tile rows are 64 columns
# wide, the last 16 the TMA's zero fill.
SM90_PAGED = {
    "gpt2_small_bf16_decode": (12, "bf16", 1, False, 0, 12, 64),
    "gpt2_small_gqa4_verify5": (4, "bf16", 5, False, 0, 12, 64),
    "gpt2_small_int8_tree5": (12, "int8", 5, True, 0, 12, 64),
    "gpt2_small_8lane_shared_prefix": (12, "bf16", 1, False, 4, 12, 64),
    "gpt2_small_gqa4_verify5_8lane_prefix": (4, "bf16", 5, False, 2, 12, 64),
    "gpt2_small_gqa4_int8_tree5_8lane_prefix": (4, "int8", 5, True, 2, 12,
                                                64),
    "gpt_long_d48_bf16_decode": (8, "bf16", 1, False, 0, 16, 48),
    "gpt_long_d48_gqa2_verify5": (8, "bf16", 5, False, 0, 16, 48),
    "gpt_long_d48_int8_tree5": (8, "int8", 5, True, 0, 16, 48),
    "gpt_long_d48_8lane_shared_prefix": (8, "bf16", 1, False, 4, 16, 48),
}


def gpt2_paged_case(rs, *, kv_heads, pool, s_q, tree, prefix_pages,
                    n_slots=8, ps=64, n_pages=80, n_heads=12, head_dim=64):
    """bf16 queries over a pool at GPT-2-small width (or the heads and head
    dim given), the compacted walk
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
    kv_heads, pool, s_q, tree, prefix, n_heads, head_dim = SM90_PAGED[name]
    args, kw = gpt2_paged_case(np.random.RandomState(7), kv_heads=kv_heads,
                               pool=pool, s_q=s_q, tree=tree,
                               prefix_pages=prefix, n_heads=n_heads,
                               head_dim=head_dim)
    kv = args[1][0] if pool == "int8" else args[1]
    assert pa.plan_paged(torch.bfloat16, kv.dtype, head_dim, 64, s_q,
                         n_heads // kv_heads) == "sm90"
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
    kv_heads, pool, s_q, tree, prefix, n_heads, head_dim = SM90_PAGED[name]
    args, kw = gpt2_paged_case(np.random.RandomState(11), kv_heads=kv_heads,
                               pool=pool, s_q=s_q, tree=tree,
                               prefix_pages=prefix, n_heads=n_heads,
                               head_dim=head_dim)
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
    to the same engine on the pool sweep. The steps run under
    ``eager_steps()``: the check reads each launch's output back, which a
    captured step cannot (the captured twin is held to this eager step
    below)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from torchbooster_tpu_torch.serving import eager_steps
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
            with eager_steps():
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
    # gpt-long's head dim (768 / 16 heads) and its GQA group of 2; ragged,
    # the KV-cache alignment, and non-causal at S 1024 (the sp:8 ring's
    # visiting chunks)
    "gpt_long_d48_gqa2_bf16": (2, 16, 8, 1024, 1024, 48, torch.bfloat16,
                               True),
    "d48_gqa2_ragged200_fp32": (2, 4, 2, 200, 200, 48, torch.float32, True),
    "d48_gqa2_ragged200_bf16": (2, 16, 8, 200, 200, 48, torch.bfloat16,
                                True),
    "d48_sq256_skv1024_bf16": (2, 16, 8, 256, 1024, 48, torch.bfloat16,
                               True),
    "d48_noncausal_s1024_bf16": (2, 16, 8, 1024, 1024, 48, torch.bfloat16,
                                 False),
}
# the route each case's B1 (plan_flash_fwd) and B2/B3 (plan_flash_bwd)
# must take: the two plans agree, bf16 D 48 on "sm90"
FLASH_FWD_ROUTE = {"gpt2_small_bf16": "sm90", "gpt2_small_fp32": "f32",
                   "gpt2_small_gqa4_bf16": "sm90",
                   "sq256_skv1024_bf16": "sm90",
                   "recipe_default_d32_bf16": "mma_sync",
                   "d128_gqa2_ragged200_bf16": "sm90",
                   "d128_ragged130_fp32": "f32", "d128_s1024_bf16": "sm90",
                   "noncausal_s512_bf16": "sm90",
                   "gpt_long_d48_gqa2_bf16": "sm90",
                   "d48_gqa2_ragged200_fp32": "f32",
                   "d48_gqa2_ragged200_bf16": "sm90",
                   "d48_sq256_skv1024_bf16": "sm90",
                   "d48_noncausal_s1024_bf16": "sm90"}
FLASH_BWD_ROUTE = dict(FLASH_FWD_ROUTE)
# bf16 cases at head dim 48: B1-B3 on "sm90", also held to "mma_sync"
D48_BF16_CASES = sorted(n for n, c in FLASH_CASES.items()
                        if c[5] == 48 and c[6] == torch.bfloat16)


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
    on the same inputs; B1 on the forward route the case names and B2/B3
    on its backward route (their per-route counters move). bf16: the
    tensor-core kernels round P and
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
    fwd_route, route = FLASH_FWD_ROUTE[name], FLASH_BWD_ROUTE[name]
    shape = (dtype, d, q.shape[1], k.shape[1], q.shape[0] // k.shape[0])
    assert fa.plan_flash_bwd(*shape) == route
    assert fa.plan_flash_fwd(*shape) == fwd_route
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv,
              fa.launches_fwd_by_route[fwd_route],
              fa.launches_dq_by_route[route], fa.launches_dkv_by_route[route])
    o, lse = fa.launch_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, scale)
    dq, delta = fa.launch_dq(q, k, v, o_ref, lse_ref, do, causal, scale)
    dk, dv = fa.launch_dkv(q, k, v, lse_ref, do, delta, causal, scale)
    torch.cuda.synchronize()
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv,
            fa.launches_fwd_by_route[fwd_route],
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
                                  "noncausal_s512_bf16", *D48_BF16_CASES])
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", D48_BF16_CASES)
def test_flash_bwd_d48_sm90_holds_to_mma_sync_on_card(name):
    """B2 and B3 at head dim 48 on ``"sm90"`` (the planned route) and on
    ``"mma_sync"`` (named) on the same inputs: each within the bf16
    allowance (2e-2) of the plain versions, and of each other; each
    route's counters move once a kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import flash_attention as fa

    causal = FLASH_CASES[name][7]
    q, k, v, do = _flash_operands(name, seed=6)
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_attention_reference(q, k, v, causal, scale)
    before = (dict(fa.launches_dq_by_route), dict(fa.launches_dkv_by_route))
    outs = {}
    for route in ("sm90", "mma_sync"):
        dq, delta = fa.launch_dq(q, k, v, o, lse, do, causal, scale,
                                 route=None if route == "sm90" else route)
        outs[route] = (dq, delta, *fa.launch_dkv(
            q, k, v, lse, do, delta, causal, scale,
            route=None if route == "sm90" else route))
    torch.cuda.synchronize()
    for now, was in zip((fa.launches_dq_by_route, fa.launches_dkv_by_route),
                        before):
        assert now == {**was, "sm90": was["sm90"] + 1,
                       "mma_sync": was["mma_sync"] + 1}
    args = (q, k, v, o, lse, do, causal, scale)
    want = (fa.dq_reference(*args), (o.float() * do.float()).sum(-1),
            *fa.dkv_reference(*args))
    for new, old, ref in zip(outs["sm90"], outs["mma_sync"], want):
        for got in (new, old):
            torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                                       rtol=2e-2)
        torch.testing.assert_close(new.float(), old.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", D48_BF16_CASES)
def test_flash_fwd_d48_sm90_holds_to_mma_sync_on_card(name):
    """B1 at head dim 48 on ``"sm90"`` (the planned route,
    ``flash_fwd_sm90<48>``) and on ``"mma_sync"`` (named) on the same
    inputs: o and lse of each within the bf16 allowance (2e-2) of the
    plain version; ``"sm90"`` bit for bit on a repeat; each call moves
    ``launches_fwd_by_route`` on the route it ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import flash_attention as fa

    causal = FLASH_CASES[name][7]
    q, k, v, _ = _flash_operands(name, seed=7)
    scale = q.shape[-1] ** -0.5
    assert fa.plan_flash_fwd(q.dtype, 48, q.shape[1], k.shape[1],
                             q.shape[0] // k.shape[0]) == "sm90"
    outs = {}
    for route in ("sm90", "mma_sync", "sm90"):
        before = dict(fa.launches_fwd_by_route)
        outs.setdefault(route, []).append(fa.launch_fwd(
            q, k, v, causal, scale, route=None if route == "sm90" else route))
        torch.cuda.synchronize()
        assert fa.launches_fwd_by_route == {**before,
                                            route: before[route] + 1}
    want = fa.flash_attention_reference(q, k, v, causal, scale)
    for got in (outs["sm90"][0], outs["mma_sync"][0]):
        for a, ref in zip(got, want):
            torch.testing.assert_close(a.float(), ref.float(), atol=2e-2,
                                       rtol=2e-2)
    for a, b in zip(*outs["sm90"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.0, -48 ** -0.5])
def test_flash_fwd_sm90_refuses_non_positive_scale_on_card(scale):
    """``flash_fwd_sm90`` takes its running max over the raw scores, which
    keep the scaled scores' order only for ``sm_scale > 0``: at any other
    scale ``launch_fwd`` named onto ``"sm90"`` raises and the C entry
    point returns an error without launching; by default the plan sends
    the call to ``"mma_sync"``, which scales first and holds to the plain
    version within the bf16 allowance (2e-2), as it does named."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_operands("d48_gqa2_ragged200_bf16", seed=5)
    bh, s_q, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    before = dict(fa.launches_fwd_by_route)
    with pytest.raises(ValueError, match="sm_scale > 0"):
        fa.launch_fwd(q, k, v, True, scale, route="sm90")
    err = fa._lib_fwd_sm90().tb_flash_fwd_sm90(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, k.shape[0], s_q, k.shape[1], 1, scale,
        fa._stream(q))
    assert err != 0
    assert fa.launches_fwd_by_route == before
    want = fa.flash_attention_reference(q, k, v, True, scale)
    for route in (None, "mma_sync"):
        got = fa.launch_fwd(q, k, v, True, scale, route=route)
        torch.cuda.synchronize()
        for a, ref in zip(got, want):
            torch.testing.assert_close(a.float(), ref.float(), atol=2e-2,
                                       rtol=2e-2)
    assert fa.launches_fwd_by_route == {
        **before, "mma_sync": before["mma_sync"] + 2}


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [48, 64])
@pytest.mark.parametrize("sign", [0, -1], ids=["zero", "negative"])
def test_flash_attention_non_positive_scale_with_grads_on_card(sign,
                                                               head_dim):
    """``flash_attention(q, k, v, sm_scale=s)`` at s = 0 and s = -1/sqrt(D),
    bf16, causal, GQA 2, ragged S 200, with gradients: B1 launches on
    ``"mma_sync"`` (the ``sm90`` forward takes ``sm_scale > 0`` only),
    B2 and B3 on ``"sm90"`` (they scale before they mask); o, dq, dk and
    dv within the bf16 allowance (2e-2) of the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import flash_attention as fa

    scale = sign * head_dim ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, do = (torch.randn(8, 200, head_dim, generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn(4, 200, head_dim, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    counts = (fa.launches_fwd_by_route, fa.launches_dq_by_route,
              fa.launches_dkv_by_route)
    before = [dict(c) for c in counts]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, sm_scale=scale)
    out.backward(do)
    torch.cuda.synchronize()
    for now, was, route in zip(counts, before,
                               ("mma_sync", "sm90", "sm90")):
        assert now == {**was, route: was[route] + 1}
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True, scale)
    want = (o_ref, *fa.flash_attention_backward_reference(
        q, k, v, o_ref, lse_ref, do, True, scale))
    for got, ref in zip((out, *(t.grad for t in leaves)), want):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)


# the bf16 cases B1 takes on its "sm90" route
SM90_FWD_CASES = sorted(n for n, r in FLASH_FWD_ROUTE.items() if r == "sm90")


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
@pytest.mark.parametrize("n", [48, 64, 128])
@pytest.mark.parametrize("mode", [0, 1], ids=["mn_major_b", "register_a"])
def test_wgmma_operand_forms_match_matmul_on_card(mode, n):
    """The two operand forms the ``"sm90"`` backward rests on, one 64-row
    tile each, against ``torch.matmul`` on the same bf16 tiles: B read
    MN-major through the transpose bit (N 128 spans two 64-column blocks,
    the descriptor's leading offset; N 48, head dim 48's dQ, dK and dV
    products, reads six of a 128-byte row's eight chunks), and an
    accumulator re-packed as the
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


@pytest.mark.cuda
def test_prefetch_to_device_on_card_equals_host_batches():
    """``prefetch_to_device`` over two epochs with more batches than its
    staging ring: every batch lands on the card, equal byte for byte to
    the host batch of the same seed and epoch, though its pinned buffer
    was reused for later batches while the consumer still held it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned side-stream copy has "
                    "no CPU mode")
    from torchbooster_tpu_torch.data import DataLoader, prefetch_to_device
    from torchbooster_tpu_torch.dataset import ArrayDataset

    rs = np.random.RandomState(0)
    x = rs.rand(160, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 10, 160).astype(np.int32)
    host = DataLoader(ArrayDataset(x, y), batch_size=16, seed=1)
    fast = DataLoader(ArrayDataset(x, y), batch_size=16, seed=1,
                      num_workers=2)
    for _ in range(2):
        held = list(prefetch_to_device(fast, "cuda", size=2))
        want = list(host)
        assert len(held) == len(want) == 10
        for (images, labels), (wx, wy) in zip(held, want):
            assert images.is_cuda and labels.is_cuda
            assert images.cpu().numpy().tobytes() == wx.tobytes()
            assert labels.cpu().numpy().tobytes() == wy.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,h_kv", [(64, 4, 4), (48, 4, 2)],
                         ids=["sm90_d64", "sm90_d48_gqa"])
def test_ring_fold_matches_whole_sequence_flash_on_card(d, h, h_kv):
    """The ring's per-rank steps (``parallel/ring.py`` ``ring_fwd_step`` /
    ``ring_bwd_step``) for four ranks in one process, the rotation done
    by indexing, held to the plain versions and to one whole-sequence
    B1-B3 call on the same bf16 inputs: out, lse, dQ, dK and dV within
    the flash checks' bf16 allowance, atol = rtol = 2e-2 (each chunk's
    kernel output is rounded to bf16 before the fp32 merge or sum), and
    ||err|| / ||ref|| at most 2^-6 (four bf16 unit roundoffs). B1 runs
    causal on the 4 diagonal chunks and non-causal on the 6 visible
    ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.ops import flash_attention as fa
    from torchbooster_tpu_torch.parallel import ring

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, b, s = 4, 2, 512
    rand = lambda *shape: torch.randn(*shape, generator=gen,
                                      device="cuda").to(torch.bfloat16)
    q, do = rand(b * h, s, d), rand(b * h, s, d)
    k, v = rand(b * h_kv, s, d), rand(b * h_kv, s, d)
    scale, sl = d ** -0.5, s // n
    chunk = lambda x: [x[:, r * sl:(r + 1) * sl].contiguous()
                       for r in range(n)]
    qs, ks, vs, dos = chunk(q), chunk(k), chunk(v), chunk(do)
    masks = dict(fa.launches_fwd_by_mask)
    outs, lses = [], []
    for my in range(n):
        carry = None
        for t in range(n):
            src = (my - t) % n
            carry = ring.ring_fwd_step(qs[my], ks[src], vs[src], src=src,
                                       my=my, causal=True, sm_scale=scale,
                                       carry=carry)
        outs.append(carry[0].to(torch.bfloat16))
        lses.append(carry[1])
    assert fa.launches_fwd_by_mask["causal"] - masks["causal"] == n
    assert fa.launches_fwd_by_mask["full"] - masks["full"] == 6
    dq, dk, dv = [None] * n, [None] * n, [None] * n
    for t in range(n):
        for my in range(n):
            src = (my - t) % n
            dq[my], dk[src], dv[src] = ring.ring_bwd_step(
                qs[my], ks[src], vs[src], outs[my], lses[my], dos[my],
                src=src, my=my, causal=True, sm_scale=scale, dq=dq[my],
                dk=dk[src], dv=dv[src])
    o_ref, lse_ref = fa.launch_fwd(q, k, v, True, scale)
    dq_ref, delta = fa.launch_dq(q, k, v, o_ref, lse_ref, do, True, scale)
    dk_ref, dv_ref = fa.launch_dkv(q, k, v, lse_ref, do, delta, True, scale)
    o_pl, lse_pl = fa.flash_attention_reference(q, k, v, True, scale)
    plain = (o_pl, lse_pl, *fa.flash_attention_backward_reference(
        q, k, v, o_pl, lse_pl, do, True, scale))
    cat = lambda xs: torch.cat(xs, dim=1).float()
    fold = (cat(outs), cat(lses), cat(dq), cat(dk), cat(dv))
    for refs in (plain, (o_ref, lse_ref, dq_ref, dk_ref, dv_ref)):
        for got, want in zip(fold, refs):
            want = want.float()
            torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
            assert (got - want).norm() <= 2.0 ** -6 * want.norm()


@pytest.mark.cuda
def test_pipeline_fold_matches_unpipelined_gpt_on_card():
    """The pp:4 GPipe schedule folded into one process on the card
    (``parallel.pipeline.fold_apply``; 8 layers, 8 microbatches, fp32,
    remat): its logits and gradients equal the un-pipelined
    ``GPT.apply`` on the card to 1e-4, and B1-B3 launch once per
    (layer, microbatch) forward, twice with the remat recompute."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    from torchbooster_tpu_torch.models.gpt import (
        GPT,
        GPTConfig,
        _embed,
        _lm_head,
        pipeline_layer,
    )
    from torchbooster_tpu_torch.ops import flash_attention as fa
    from torchbooster_tpu_torch.ops.losses import cross_entropy
    from torchbooster_tpu_torch.parallel.pipeline import fold_apply

    cfg = GPTConfig(vocab=128, n_layers=8, d_model=128, n_heads=2,
                    seq_len=128)
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, 128, (8, 128))).cuda()
    labels = torch.from_numpy(rs.randint(0, 128, (8, 128))).cuda()
    ref = GPT.init(0, cfg, device="cuda")
    for leaf in _leaves(ref):
        leaf.requires_grad_(True)
    want = GPT.apply(ref, ids, cfg, compute_dtype=torch.float32)
    cross_entropy(want, labels).backward()
    p = GPT.init(0, cfg, device="cuda")
    for leaf in _leaves(p):
        leaf.requires_grad_(True)
    before = fa.launches_fwd
    layer = pipeline_layer(cfg, True, "auto", 8)
    h, _ = fold_apply(layer, (p["blocks"], torch.arange(8)),
                      _embed(p, ids, torch.float32), 4, 8,
                      with_mb_index=True, with_aux=True)
    got = _lm_head(p, h)
    cross_entropy(got, labels).backward()
    torch.cuda.synchronize()
    assert fa.launches_fwd - before == 2 * 8 * 8
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for a, b in zip(_leaves(p), _leaves(ref)):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lenet_group_norms_take_their_routes_on_card(dtype):
    """LeNet's two GroupNorms on the card, forward and backward: at bf16
    the 6-channel norm takes B5/B6's ``"two_pass"`` route and the
    16-channel one ``"one_pass"``; at fp32 both ``"two_pass"``. Logits
    and every gradient against the plain GroupNorm on the same inputs:
    1e-4 (fp32) or 2e-2 (bf16) of the largest entry (the conv biases'
    exact gradient is 0, so no per-leaf scale is used)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torchbooster_tpu_torch.models import LeNet
    from torchbooster_tpu_torch.ops import group_norm as gn
    from torchbooster_tpu_torch.utils import _cast_batch

    dt = getattr(torch, dtype)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    params = LeNet.init(0, device="cuda")
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    x = torch.rand(64, 28, 28, 1, generator=torch.Generator().manual_seed(0))
    x = x.cuda().to(dt)
    runs = {}
    for impl in ("auto", "plain"):
        before = (dict(gn.launches_fwd_by_route),
                  dict(gn.launches_bwd_by_route))
        out = LeNet.apply(_cast_batch(params, dt), x, gn_impl=impl)
        (out.float() ** 2).mean().backward()
        torch.cuda.synchronize()
        moved = tuple({r: a[r] - b[r] for r in a} for a, b in zip(
            (gn.launches_fwd_by_route, gn.launches_bwd_by_route), before))
        runs[impl] = (out.detach().float(), [p.grad.clone() for p in leaves],
                      moved)
        for p in leaves:
            p.grad = None
    want = {"float32": {"one_pass": 0, "two_pass": 2},
            "bfloat16": {"one_pass": 1, "two_pass": 1}}[dtype]
    assert runs["auto"][2] == (want, want)
    assert all(sum(m.values()) == 0 for m in runs["plain"][2])
    (ya, ga, _), (yp, gp, _) = runs["auto"], runs["plain"]
    assert torch.isfinite(ya).all()
    assert (ya - yp).abs().max() <= tol * yp.abs().max()
    top = max(g.abs().max() for g in gp)
    for a, b in zip(ga, gp):
        assert (a - b).abs().max() <= tol * top


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["ws", "group"])
def test_resnet50_s2d_stem_matches_plain_stem_on_card(norm):
    """The space-to-depth stem on the card at 224² (ResNet-50, ImageNet
    stem, batch 4, fp32 with TF32 off): logits within 2e-4 of the largest
    (JAX's bound for the same check) of the plain 7×7/s2 stem's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torchbooster_tpu_torch.models import ResNet

    params = ResNet.init(0, 50, 1000, "imagenet", device="cuda")
    x = torch.randn(4, 224, 224, 3,
                    generator=torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        plain = ResNet.apply(params, x, norm=norm)
        s2d = ResNet.apply(params, x, norm=norm, stem_s2d=True)
    assert torch.isfinite(s2d).all()
    assert (s2d - plain).abs().max() <= 2e-4 * plain.abs().max()


def unet_gn_calls(cfg, size: int, dtype) -> list[tuple]:
    """Each GroupNorm of one UNet forward over ``size``² images with
    weights of ``dtype``, in order, as ``(H·W, C, groups, dtype)``:
    recorded from a one-image forward on the CPU through a hook on the
    plain GroupNorm, which ``layers.group_norm`` calls there with the
    group count it settled on. The forward states the structure; nothing
    here repeats it."""
    from torchbooster_tpu_torch.models.unet import UNet
    from torchbooster_tpu_torch.ops import group_norm as gnk
    from torchbooster_tpu_torch.utils import _cast_batch

    real, seen = gnk.group_norm_fwd_reference, []

    def hook(x, scale, bias, groups, *args):
        seen.append((x.shape[1] * x.shape[2], x.shape[-1], groups, x.dtype))
        return real(x, scale, bias, groups, *args)

    gnk.group_norm_fwd_reference = hook
    try:
        with torch.no_grad():
            UNet.apply(_cast_batch(UNet.init(0, cfg, device="cpu"), dtype),
                       torch.zeros(1, size, size, cfg.in_channels,
                                   dtype=dtype),
                       torch.zeros(1, dtype=torch.long), cfg)
    finally:
        gnk.group_norm_fwd_reference = real
    return seen


def unet_routes(cfg, size, n, dtype):
    """B5's and B6's launches by route in one UNet forward and backward,
    from :func:`unet_gn_calls` and the plan functions."""
    from torchbooster_tpu_torch.ops import group_norm as gn

    fwd = {"one_pass": 0, "two_pass": 0}
    bwd = dict(fwd)
    for hw, c, groups, dt in unet_gn_calls(cfg, size, dtype):
        fwd[gn.plan_gn_fwd(n, hw, c, groups, dt).route] += 1
        bwd[gn.plan_gn_bwd(n, hw, c, groups, dt).route] += 1
    return fwd, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_group_norms_take_their_routes_on_card(dtype):
    """The UNet at ``ddpm.yml``'s widths (base 64, mults 1, 2, 2, time_dim
    256), batch 4 at 28², forward and backward through B5/B6 against the
    plain GroupNorm on the same inputs: at fp32 all 29 calls each way on
    ``"two_pass"``; with bf16 images and weights the first norm (C 64 at
    28², bf16) on ``"one_pass"`` and the 28 after the fp32 time
    projection on ``"two_pass"``, as the recorded calls and the plans
    say.
    Output and every gradient within 1e-4 (fp32) or 2e-2 (bf16) of the
    largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torchbooster_tpu_torch.models.unet import UNet, UNetConfig
    from torchbooster_tpu_torch.ops import group_norm as gn
    from torchbooster_tpu_torch.utils import _cast_batch

    dt = getattr(torch, dtype)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    cfg = UNetConfig()
    params = UNet.init(0, cfg, device="cuda")
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 28, 28, 1, generator=gen).cuda().to(dt)
    t = torch.randint(0, 1000, (4,), generator=gen).cuda()
    runs = {}
    for impl in ("auto", "plain"):
        before = (dict(gn.launches_fwd_by_route),
                  dict(gn.launches_bwd_by_route))
        out = UNet.apply(_cast_batch(params, dt), x, t, cfg, gn_impl=impl)
        (out.float() ** 2).mean().backward()
        torch.cuda.synchronize()
        moved = tuple({r: a[r] - b[r] for r in a} for a, b in zip(
            (gn.launches_fwd_by_route, gn.launches_bwd_by_route), before))
        runs[impl] = (out.detach().float(), [p.grad.clone() for p in leaves],
                      moved)
        for p in leaves:
            p.grad = None
    assert runs["auto"][2] == unet_routes(cfg, 28, 4, dt)
    assert sum(runs["auto"][2][0].values()) == 29
    assert runs["auto"][2][0]["one_pass"] == (1 if dtype == "bfloat16"
                                              else 0)
    assert all(sum(m.values()) == 0 for m in runs["plain"][2])
    (ya, ga, _), (yp, gp, _) = runs["auto"], runs["plain"]
    assert torch.isfinite(ya).all()
    assert (ya - yp).abs().max() <= tol * yp.abs().max()
    top = max(g.abs().max() for g in gp)
    for a, b in zip(ga, gp):
        assert (a - b).abs().max() <= tol * top


@pytest.mark.cuda
def test_gan_penalty_double_backward_on_card_matches_cpu():
    """The GAN's gradient penalty and hinge D loss at the recipe's widths
    (z 64, batch 64), fp32 with TF32 off: the loss and its gradient with
    respect to D's parameters, the double backward included, on the card
    against the CPU on the same weights, images and α (1e-4 of the
    largest entry)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from torchbooster_tpu_torch.models import GAN
    from torchbooster_tpu_torch.models import gan

    gen = torch.Generator().manual_seed(0)
    x_real = torch.rand(64, 28, 28, 1, generator=gen)
    z = torch.randn(64, 64, generator=gen)
    alpha = torch.rand(64, 1, 1, 1, generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        params = GAN.init(1, device=dev)
        d = params["D"]
        for p in _leaves(d):
            p.requires_grad_(True)
        with torch.no_grad():
            fake = GAN.generate(params["G"], z.to(dev))
        loss = gan.hinge_d_loss(d, x_real.to(dev), fake) + 10.0 * \
            gan._grad_penalty_core(d, x_real.to(dev), fake, alpha.to(dev))
        loss.backward()
        out[dev] = (loss.item(), [p.grad.cpu() for p in _leaves(d)])
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    top = max(g.abs().max() for g in gc)
    for a, b in zip(gg, gc):
        assert (a - b).abs().max() <= 1e-4 * top


@pytest.mark.cuda
def test_jit_generate_on_card_equals_generate():
    """``jit_generate`` on the card (bf16, GPT-2 small's 12 heads of 64
    at 2 layers) returns ``generate``'s ids; each call's prefill launches
    B1 once a layer, on ``"sm90"``, and a repeated shape stays one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.models.gpt import (
        GPT,
        GPTConfig,
        generate,
        jit_generate,
    )
    from torchbooster_tpu_torch.ops import flash_attention as fa

    cfg = GPTConfig(vocab=1024, n_layers=2, d_model=768, n_heads=12,
                    seq_len=128)
    params = GPT.init(0, cfg, device="cuda")
    ids = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 40)), device="cuda")
    fn = jit_generate(cfg, n_new=8, temperature=0.0,
                      compute_dtype=torch.bfloat16)
    before = dict(fa.launches_fwd_by_route)
    got = fn(params, ids)
    again = fn(params, ids)
    torch.cuda.synchronize()
    assert fa.launches_fwd_by_route == {**before,
                                        "sm90": before["sm90"] + 4}
    want = generate(params, ids, cfg, n_new=8, temperature=0.0,
                    compute_dtype=torch.bfloat16)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert fn._cache_size() == 1


# ---- captured serving steps (CUDA graphs) --------------------------------
def _graph_model(dtype_cfg=None):
    """A small GPT on the card (head dim 64, decisive head)."""
    from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = dtype_cfg or GPTConfig(vocab=97, n_layers=2, d_model=128,
                                 n_heads=2, seq_len=128)
    params = GPT.init(0, cfg, device="cuda")
    params["wte"]["table"] *= 4.0
    return params, cfg


def _graph_streams(eng, prompts, n_steps, spec=False):
    """Each prompt's first token and ``n_steps`` steps' tokens, and the
    B4 launches by route the steps ran."""
    streams = {}
    for p in prompts:
        slot, first = eng.admit(p)
        streams[slot] = [first]
    before = dict(pa.launches_by_route)
    for _ in range(n_steps):
        assert eng.grow_slots() == []
        if spec:
            for slot, toks in eng.spec_step().items():
                streams[slot].extend(toks)
        else:
            toks = eng.step()
            for slot in streams:
                streams[slot].append(int(toks[slot]))
    torch.cuda.synchronize()
    by_route = {r: n - before[r] for r, n in pa.launches_by_route.items()}
    return [streams[s] for s in sorted(streams)], by_route


def _captured_and_eager(kw, prompts, n_steps, spec=False, cfg=None):
    """The same engine twice on one model: captured, and under
    ``eager_steps()``."""
    from torchbooster_tpu_torch.serving import PagedEngine, eager_steps

    params, cfg = _graph_model(cfg)
    kw = dict(dict(page_size=16, n_pages=24, max_slots=3), **kw)
    graph = PagedEngine(params, cfg, **kw)
    assert graph.step_route == "graph", graph.step_route_reason
    got = _graph_streams(graph, prompts, n_steps, spec)
    eager = PagedEngine(params, cfg, **kw)
    with eager_steps():
        want = _graph_streams(eager, prompts, n_steps, spec)
    assert eager.graph_replays == 0 and not eager._graphs
    return graph, got, want


def _prompts(rs, vocab=97):
    return [np.tile(rs.randint(0, vocab, n).astype(np.int32), r)
            for n, r in ((3, 6), (5, 4), (7, 3))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cache,route", [
    (torch.bfloat16, None, "sm90"), (torch.bfloat16, "int8", "sm90"),
    (torch.float32, None, "simt")], ids=["bf16_sm90", "int8_sm90",
                                         "fp32_simt"])
def test_captured_decode_equals_eager_on_card(dtype, cache, route):
    """The decode step captured once and replayed is token-exact against
    the same engine under ``eager_steps()``, with the same B4 launches by
    route (two a step, all on the planned route): the warm-up runs the
    first step for real, the capture counts nothing, each replay adds
    its two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    eng, (got, g_routes), (want, e_routes) = _captured_and_eager(
        dict(compute_dtype=dtype, cache_dtype=cache),
        _prompts(np.random.RandomState(0)), 12)
    assert got == want
    assert g_routes == e_routes and g_routes[route] == 2 * 12
    assert eng.decode_compiles == 1 and len(eng._graphs) == 1
    assert eng.graph_replays == 11
    assert eng.debug_stats()["compiles"]["graph_replays"] == 11


@pytest.mark.cuda
@pytest.mark.parametrize("spec_tree", [False, True], ids=["chain", "tree"])
def test_captured_verify_equals_eager_on_card(spec_tree):
    """The verify step (chain, and the tree with its compaction, a
    second graph) captured is token-exact against ``eager_steps()``, on
    B4's ``"sm90"`` route at S = 5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    rs = np.random.RandomState(0)
    prompts = _prompts(rs)
    if spec_tree:                      # ambiguous: two continuations
        pat = rs.randint(0, 97, 5).astype(np.int32)
        prompts[0] = np.concatenate([pat, [11], pat, [13], pat, [11], pat])
    eng, (got, g_routes), (want, e_routes) = _captured_and_eager(
        dict(compute_dtype=torch.bfloat16, speculative=True, draft_len=4,
             spec_tree=spec_tree), prompts, 10, spec=True)
    assert got == want and g_routes == e_routes
    assert g_routes["sm90"] == 2 * 10 and g_routes["simt"] == 0
    assert eng.verify_compiles == 1 and eng.spec_accepted > 0
    assert len(eng._graphs) == (2 if spec_tree else 1)
    eng.tables.check()


@pytest.mark.cuda
def test_captured_sampled_decode_equals_eager_on_card():
    """Sampling (temperature 0.8, top-k 20) draws after the captured
    forward from the engine's seeded generator, so the stream equals the
    eager step's from the same seed; so do parallel-sampling branches
    (per-branch generators) and a MoE model's (its serving routing reads
    nothing back to the host, so it captures)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    from torchbooster_tpu_torch.models.gpt import GPTConfig

    prompts = _prompts(np.random.RandomState(3))
    _, (got, _), (want, _) = _captured_and_eager(
        dict(compute_dtype=torch.bfloat16, temperature=0.8, top_k=20,
             seed=7), prompts, 12)
    assert got == want
    _, (got, _), (want, _) = _captured_and_eager(
        dict(compute_dtype=torch.bfloat16, temperature=0.8, top_k=20,
             parallel_sampling=True), prompts, 12)
    assert got == want
    moe = GPTConfig(vocab=97, n_layers=2, d_model=128, n_heads=2,
                    seq_len=128, n_experts=4)
    _, (got, g_routes), (want, e_routes) = _captured_and_eager(
        dict(compute_dtype=torch.float32), prompts, 8, cfg=moe)
    assert got == want and g_routes == e_routes


@pytest.mark.cuda
def test_captured_steps_from_a_stepping_thread_on_card():
    """A batcher run on another thread captures there while this thread
    keeps the card busy (``capture_error_mode="thread_local"``): its
    streams equal the eager run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    import threading

    from torchbooster_tpu_torch.serving import (
        ContinuousBatcher,
        PagedEngine,
        Request,
        eager_steps,
    )

    params, cfg = _graph_model()
    prompts = _prompts(np.random.RandomState(4))
    kw = dict(page_size=16, n_pages=24, max_slots=3,
              compute_dtype=torch.bfloat16)

    def reqs():
        return [Request(prompt=p, max_new_tokens=10, request_id=str(i))
                for i, p in enumerate(prompts)]

    threaded, eager = reqs(), reqs()
    batcher = ContinuousBatcher(PagedEngine(params, cfg, **kw),
                                on_recompile="raise")
    worker = threading.Thread(target=batcher.run, args=(threaded,))
    x = torch.randn(1024, 1024, device="cuda")
    worker.start()
    while worker.is_alive():
        x = torch.tanh(x @ x)
        worker.join(timeout=0.001)
    torch.cuda.synchronize()
    assert batcher.engine.graph_replays > 0
    with eager_steps():
        ContinuousBatcher(PagedEngine(params, cfg, **kw)).run(eager)
    assert [r.tokens for r in threaded] == [r.tokens for r in eager]


@pytest.mark.cuda
@pytest.mark.parametrize("cache", [None, "int8"])
def test_captured_jit_generate_equals_generate_on_card(cache):
    """``jit_generate``'s decode step, captured once a (batch, prompt
    length) and replayed, returns ``generate``'s ids greedy and sampled
    (the same seeded generator), at bf16 with a plain and an int8 cache;
    a second prompt of the shape replays the same graph on its own cache
    contents, and under ``eager_steps()`` the same ids come back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    from torchbooster_tpu_torch.models.gpt import (
        GPT,
        GPTConfig,
        generate,
        jit_generate,
    )
    from torchbooster_tpu_torch.serving import eager_steps

    cfg = GPTConfig(vocab=512, n_layers=2, d_model=256, n_heads=4,
                    n_kv_heads=2, seq_len=128, pos="rope")
    params = GPT.init(0, cfg, device="cuda")
    rs = np.random.RandomState(1)
    kw = dict(n_new=9, compute_dtype=torch.bfloat16, cache_dtype=cache)
    for temperature in (0.0, 0.9):
        fn = jit_generate(cfg, temperature=temperature, top_k=40, **kw)
        for _ in range(2):
            ids = torch.as_tensor(rs.randint(0, 512, (2, 21)), device="cuda")
            gen = lambda: torch.Generator(device="cuda").manual_seed(5)
            got = fn(params, ids, gen())
            want = generate(params, ids, cfg, generator=gen(),
                            temperature=temperature, top_k=40, **kw)
            assert torch.equal(got, want)
            with eager_steps():
                assert torch.equal(fn(params, ids, gen()), want)
        assert fn._cache_size() == 1


@pytest.mark.cuda
def test_captured_jit_generate_follows_params_to_new_addresses_on_card():
    """``jit_generate``'s graph reads params already in ``compute_dtype``
    where the caller keeps them: an in-place update is read by the next
    replay, and a new tree (new addresses) captures the shape again,
    counted in ``_cache_size()``; every call returns ``generate``'s ids
    for the params it was given."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    from torchbooster_tpu_torch.models.gpt import (
        GPT,
        GPTConfig,
        cast_params,
        generate,
        jit_generate,
        map_tensors,
    )

    cfg = GPTConfig(vocab=64, n_layers=2, d_model=32, n_heads=4,
                    seq_len=32)
    params = cast_params(GPT.init(0, cfg, device="cuda"), torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    # weights of std 0.1, so that every block steers the picks
    redraw = lambda t: t.copy_(0.1 * torch.randn(t.shape, generator=g,
                                                 device="cuda"))
    for leaf in (params["wte"]["table"], *(
            params["blocks"][k]["kernel"] for k in (
                "attn_qkv", "attn_proj", "mlp_fc1", "mlp_fc2"))):
        redraw(leaf)
    ids = torch.as_tensor(np.random.RandomState(3).randint(0, 64, (2, 7)),
                          device="cuda")
    kw = dict(n_new=6, temperature=0.0, compute_dtype=torch.bfloat16)
    fn = jit_generate(cfg, **kw)
    first = generate(params, ids, cfg, **kw)
    assert torch.equal(fn(params, ids), first)
    redraw(params["blocks"]["mlp_fc1"]["kernel"])
    redrawn = generate(params, ids, cfg, **kw)
    assert not torch.equal(redrawn, first)
    assert torch.equal(fn(params, ids), redrawn)
    assert fn._cache_size() == 1
    other = map_tensors(params, lambda t: t.flip(0).contiguous())
    flipped = generate(other, ids, cfg, **kw)
    assert not torch.equal(flipped, redrawn)
    assert torch.equal(fn(other, ids), flipped)
    assert fn._cache_size() == 2


# ---- captured train step (CUDA graphs) -----------------------------------
def _train_pair(name: str, dropout: float = 0.0):
    """A small GPT (bf16 compute over fp32 masters, remat, head dim 64:
    B1-B3 on ``"sm90"``) twice from one seed, its optimizer ``name``
    through ``OptimizerConfig.make`` on the card, and one step function."""
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.config import OptimizerConfig, SchedulerConfig
    from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    cfg = GPTConfig(vocab=97, n_layers=2, d_model=128, n_heads=2,
                    seq_len=128, dropout=dropout)
    conf = OptimizerConfig(name=name, lr=1e-2, weight_decay=0.1)
    tx = conf.make(SchedulerConfig(name="cycle", n_iter=6, warmup=2).make(
        conf))

    def loss_fn(params, batch, generator):
        logits = GPT.apply(params, batch["ids"], cfg, remat=True,
                           compute_dtype=torch.bfloat16, generator=generator)
        return cross_entropy(logits, batch["labels"]), {}

    states = [utils.TrainState.create(GPT.init(0, cfg, device="cuda"), tx,
                                      generator=7, ema=True)
              for _ in range(2)]
    step = utils.make_step(loss_fn, tx, clip=1.0, ema_decay=0.99)
    rs = np.random.RandomState(0)
    batches = []
    for _ in range(6):
        t = torch.as_tensor(rs.randint(0, 97, (4, 129)), device="cuda")
        batches.append({"ids": t[:, :-1], "labels": t[:, 1:]})
    return states, step, batches


def _same_states(a, b) -> None:
    from torchbooster_tpu_torch import utils

    for p, q in zip(utils.tree_leaves(a.params), utils.tree_leaves(b.params),
                    strict=True):
        assert torch.equal(p, q)
    for p, q in zip(utils.tree_leaves(a.ema), utils.tree_leaves(b.ema),
                    strict=True):
        assert torch.equal(p, q)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("name,dropout", [
    ("adamw", 0.0), ("lamb", 0.0), ("lion", 0.0), ("adafactor", 0.0),
    ("adamw", 0.1)], ids=["adamw", "lamb", "lion", "adafactor",
                          "adamw_dropout"])
def test_captured_train_step_equals_eager_on_card(name, dropout):
    """``make_step`` on the card: 5 steps captured once and replayed (the
    optimizer's lr, count and bias corrections on the card, the EMA's
    decay staged) against the same step function's eager twin inside
    ``eager_steps()``, in turns: losses, parameters, EMA and generator
    bit for bit. At dropout 0.1 under remat each replay draws new masks
    (the losses differ from a replay of the first step's masks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch._graphs import eager_steps
    from torchbooster_tpu_torch.ops import flash_attention as fa

    (graph, eager), step, batches = _train_pair(name, dropout)
    assert step.plan(torch.device("cuda"))[0] == "graph"
    before = fa.launches_dq_by_route["sm90"]
    losses = []
    for batch in batches[:5]:
        graph, m = step(graph, batch)
        with eager_steps():
            eager, e = step(eager, batch)
        assert torch.equal(m["loss"], e["loss"])
        losses.append(m["loss"].item())
    torch.cuda.synchronize()
    _same_states(graph, eager)
    assert step._cache_size() == 1 and step.graphs.replays == 4
    # B2 once a layer a step, replays counted, the twin's too
    assert fa.launches_dq_by_route["sm90"] - before == 2 * 2 * 5
    if dropout:
        assert len(set(losses)) == len(losses)


@pytest.mark.cuda
def test_captured_train_step_resumes_in_place_on_card(tmp_path):
    """A save after 2 captured steps, 2 more; a fresh state restored from
    the save (``SaveCallback``) into the captured step: nothing captures
    again (the load writes into the live tensors), and its 2 steps take
    the original's bit for bit (dropout on). A cold state (no optimizer
    state yet) restored the same way takes them too, its lr a scalar on
    the card from its first step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torchbooster_tpu_torch.callbacks import SaveCallback

    (state, fresh), step, batches = _train_pair("adamw", 0.1)
    cb = SaveCallback(every=2, n_iter=4, root=tmp_path)
    for i, batch in enumerate(batches[:4]):
        state, _ = step(state, batch)
        if i == 1:
            cb.save(2, state=state)
    cb.wait()
    captures = step._cache_size()
    # the fresh state takes one step first, so that its optimizer state
    # exists and the restore writes into it
    fresh, _ = step(fresh, batches[0])
    assert step._cache_size() == captures + 1
    cb.restore(like={"state": fresh})
    assert fresh.step == 2 and fresh.loads == 0
    for batch in batches[2:4]:
        fresh, _ = step(fresh, batch)
    assert step._cache_size() == captures + 1
    torch.cuda.synchronize()
    _same_states(fresh, state)
    (cold, _), _, _ = _train_pair("adamw", 0.1)
    cb.restore(like={"state": cold})
    assert cold.step == 2 and cold.loads == 1
    for batch in batches[2:4]:
        cold, _ = step(cold, batch)
    assert all(g["lr"].is_cuda for g in cold.optimizer.param_groups)
    torch.cuda.synchronize()
    _same_states(cold, state)
