"""The flash backward's launch plan (``ops.flash_attention.plan_flash_bwd``):
which route each B2/B3 shape takes, the invariants the ``"sm90"`` CUDA
kernels check before they launch, and how an explicitly named route is
refused. Pure Python: no card, no JAX."""
import itertools

import pytest
import torch

from torchbooster_tpu_torch.ops import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32

# (dtype, head_dim, S_q, S_kv, rep) -> route
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
    for counts in (fa.launches_dq_by_route, fa.launches_dkv_by_route):
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
