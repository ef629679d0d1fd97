"""The flash launch plans (``ops.flash_attention.plan_flash_fwd`` for B1,
``plan_flash_bwd`` for B2/B3): which route each shape takes, the
invariants the ``"sm90"`` CUDA kernels check before they launch, and how
an explicitly named route is refused; the ``"auto"`` dispatcher's
predicate (``flash_auto_engaged``) for head dims and dtypes the kernels
are not built for; the kernel build's cache key over included headers.
Pure Python: no card, no nvcc, no JAX."""
import itertools

import pytest
import torch

from torchbooster_tpu_torch.ops import _build
from torchbooster_tpu_torch.ops import flash_attention as fa
from torchbooster_tpu_torch.ops.attention import (
    attention,
    flash_auto_engaged,
    mha_reference,
)

BF16, F32 = torch.bfloat16, torch.float32

# (dtype, head_dim, S_q, S_kv, rep) -> route, the same for the forward
# (B1) and the backward (B2/B3)
PLANS = {
    # GPT-2 small's training path (12 heads of 64, S 1024), and at fp32
    "gpt2_small_bf16": ((BF16, 64, 1024, 1024, 1), "sm90"),
    "gpt2_small_fp32": ((F32, 64, 1024, 1024, 1), "f32"),
    # head dim 128, GQA groups of 3 and 4, ragged lengths
    "d128_bf16": ((BF16, 128, 1024, 1024, 1), "sm90"),
    "gqa4_bf16": ((BF16, 64, 1024, 1024, 3), "sm90"),
    "d128_gqa2_ragged200": ((BF16, 128, 200, 200, 2), "sm90"),
    "ragged1000_bf16": ((BF16, 64, 1000, 1000, 1), "sm90"),
    "ragged1_bf16": ((BF16, 64, 1, 1, 1), "sm90"),
    # the KV-cache alignment S_q < S_kv (queries on the last keys)
    "sq256_skv1024_bf16": ((BF16, 64, 256, 1024, 1), "sm90"),
    # the GPT recipe default (d_model 256 / 8 heads): 64-byte rows
    "d32_recipe_default": ((BF16, 32, 256, 256, 1), "mma_sync"),
    "d32_fp32": ((F32, 32, 256, 256, 1), "f32"),
    # more queries than keys: causal rows that see no key
    "sq_over_skv": ((BF16, 64, 1024, 256, 1), "mma_sync"),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_flash_bwd_routes(name):
    args, want = PLANS[name]
    assert fa.plan_flash_bwd(*args) == want


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_flash_fwd_routes(name):
    args, want = PLANS[name]
    assert fa.plan_flash_fwd(*args) == want


@pytest.mark.parametrize("head_dim", (16, 32, 48, 64, 96, 128, 256))
def test_plan_flash_fwd_invariants(head_dim):
    """What ``tb_flash_fwd_sm90`` checks before it launches (head dim 64
    or 128, ``1 <= S_q <= S_kv``, at most 65535 64-row kv tiles, a whole
    GQA group) holds for every ``"sm90"`` plan of B1; fp32 plans
    ``"f32"``; every other bf16 shape ``"mma_sync"``."""
    lengths = (1, 63, 64, 65, 128, 129, 1000, 1024, 65535 * 64,
               65535 * 64 + 1)
    for s_q, s_kv, rep in itertools.product(lengths, lengths, (1, 3, 12)):
        assert fa.plan_flash_fwd(F32, head_dim, s_q, s_kv, rep) == "f32"
        route = fa.plan_flash_fwd(BF16, head_dim, s_q, s_kv, rep)
        fits = (head_dim in (64, 128) and 1 <= s_q <= s_kv
                and -(-s_kv // 64) <= 65535)
        assert route == ("sm90" if fits else "mma_sync")


@pytest.mark.parametrize("head_dim", (16, 32, 48, 64, 96, 128, 256))
def test_plan_flash_bwd_invariants(head_dim):
    """What ``tb_flash_dq_sm90`` / ``tb_flash_dkv_sm90`` check before they
    launch (``shape_ok``: head dim 64 or 128, ``1 <= S_q <= S_kv``, at
    most 65535 tiles of 64 rows, a whole GQA group) holds for every
    ``"sm90"`` plan; fp32 always plans ``"f32"``; every other bf16 shape
    plans ``"mma_sync"``."""
    lengths = (1, 63, 64, 65, 200, 1000, 1024, 4096, 65535 * 64,
               65535 * 64 + 1)
    for s_q, s_kv, rep in itertools.product(lengths, lengths, (1, 2, 3, 12)):
        assert fa.plan_flash_bwd(F32, head_dim, s_q, s_kv, rep) == "f32"
        route = fa.plan_flash_bwd(BF16, head_dim, s_q, s_kv, rep)
        assert route in ("sm90", "mma_sync")
        fits = (head_dim in (64, 128) and 1 <= s_q <= s_kv
                and -(-s_kv // 64) <= 65535)
        assert (route == "sm90") == fits


def test_route_counters_start_with_every_route():
    for counts in (fa.launches_fwd_by_route, fa.launches_dq_by_route,
                   fa.launches_dkv_by_route):
        assert set(counts) == {"sm90", "mma_sync", "f32"}


@pytest.mark.parametrize("dtype,head_dim,route,ok", [
    (BF16, 64, None, "sm90"),
    (BF16, 64, "sm90", "sm90"),
    (BF16, 64, "mma_sync", "mma_sync"),
    (BF16, 64, "f32", None),
    (BF16, 32, None, "mma_sync"),
    (BF16, 32, "sm90", None),
    (F32, 64, None, "f32"),
    (F32, 64, "sm90", None),
    (F32, 64, "mma_sync", None),
    (BF16, 64, "wgmma", None),
])
def test_named_route_is_held_to_the_plan(dtype, head_dim, route, ok):
    """A route the caller names must take the operands, else ``ValueError``
    before any launch: there is no fall-back to another route."""
    q = torch.zeros(4, 128, head_dim, dtype=dtype)
    k = torch.zeros(2, 128, head_dim, dtype=dtype)
    if ok is None:
        with pytest.raises(ValueError, match="route"):
            fa._bwd_route(q, k, route, q, k)
    else:
        assert fa._bwd_route(q, k, route, q, k) == ok


def test_plain_backward_counts_no_route():
    """The CPU path runs the plain versions and moves no counter."""
    before = (dict(fa.launches_dq_by_route), dict(fa.launches_dkv_by_route))
    q, k, v = (torch.randn(2, 16, 64, requires_grad=True) for _ in range(3))
    fa.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and k.grad is not None
    assert (fa.launches_dq_by_route, fa.launches_dkv_by_route) == before


@pytest.mark.parametrize("dtype,head_dim,route,ok", [
    (BF16, 64, None, "sm90"),
    (BF16, 128, "sm90", "sm90"),
    (BF16, 64, "mma_sync", "mma_sync"),
    (BF16, 64, "f32", None),
    (BF16, 32, None, "mma_sync"),
    (BF16, 32, "sm90", None),
    (F32, 64, None, "f32"),
    (F32, 64, "sm90", None),
    (F32, 64, "mma_sync", None),
    (BF16, 64, "wgmma", None),
])
def test_named_fwd_route_is_held_to_the_plan(dtype, head_dim, route, ok):
    """``launch_fwd(..., route=)``: a named B1 route must take the
    operands, else ``ValueError`` before any launch."""
    q = torch.zeros(4, 128, head_dim, dtype=dtype)
    k = torch.zeros(2, 128, head_dim, dtype=dtype)
    held = lambda: fa._held_route(fa.plan_flash_fwd, "forward", q, k,
                                  route, (q, k))
    if ok is None:
        with pytest.raises(ValueError, match="forward: route"):
            held()
    else:
        assert held() == ok


def test_fwd_route_with_more_queries_than_keys_is_refused():
    """S_q > S_kv (causal rows that see no key) is not the sm90
    kernel's: the plan says ``"mma_sync"`` and naming ``"sm90"`` raises."""
    q = torch.zeros(2, 256, 64, dtype=BF16)
    k = torch.zeros(2, 128, 64, dtype=BF16)
    assert fa._held_route(fa.plan_flash_fwd, "forward", q, k, None,
                          (q, k)) == "mma_sync"
    with pytest.raises(ValueError, match="planned 'mma_sync'"):
        fa._held_route(fa.plan_flash_fwd, "forward", q, k, "sm90", (q, k))


def test_plain_forward_counts_no_route():
    """The CPU forward runs the plain version and moves no counter."""
    before = (fa.launches_fwd, dict(fa.launches_fwd_by_route))
    q, k, v = (torch.randn(2, 16, 64) for _ in range(3))
    o = fa.flash_attention(q, k, v)
    assert o.shape == q.shape and torch.isfinite(o).all()
    assert (fa.launches_fwd, fa.launches_fwd_by_route) == before


@pytest.mark.parametrize("head_dim,dtype,engaged", [
    (48, BF16, True), (96, BF16, False), (16, BF16, False),
    (48, F32, True), (64, torch.float16, False),
    (32, BF16, True), (64, BF16, True), (128, BF16, True),
    (32, F32, True), (64, F32, True), (128, F32, True),
])
def test_flash_auto_engaged_only_where_kernels_are_built(head_dim, dtype,
                                                         engaged):
    """On CUDA, ``"auto"`` takes the kernels only at a head dim and dtype
    they are built for (``HEAD_DIMS``, fp32/bf16), else the reference,
    as the JAX dispatcher falls back wherever flash does not engage. The
    predicate takes the device as a string, so no card is needed."""
    assert flash_auto_engaged(1024, 1024, "cuda", head_dim,
                              dtype) is engaged
    assert flash_auto_engaged(1024, 1024, "cuda", head_dim=head_dim) is (
        head_dim in fa.HEAD_DIMS)
    assert flash_auto_engaged(1024, 1024, "cuda", dtype=dtype) is (
        dtype in (BF16, F32))
    assert flash_auto_engaged(1024, 1024, "cpu", head_dim, dtype) is False


def test_attention_auto_on_the_cpu_is_the_reference_at_any_head_dim():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 4, 48, generator=gen) for _ in range(3))
    torch.testing.assert_close(attention(q, k, v), mha_reference(q, k, v),
                               atol=0, rtol=0)


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edited header a source includes (transitively, with quotes)
    gives the library another name, so a stale build is never loaded; a
    header nobody includes does not."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <math.h>\n'
                                   '#include "a.cuh"\nint f();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    (tmp_path / "unused.cuh").write_text("// one\n")
    first = _build.library_path("k")
    assert first.name.startswith("libk_") and first.suffix == ".so"
    assert _build.library_path("k") == first
    (tmp_path / "unused.cuh").write_text("// two\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// two\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n\n')
    assert _build.library_path("k") not in (first, second)
