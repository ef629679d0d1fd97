"""B5's and B6's launch plans (``ops.group_norm.plan_gn_fwd``,
``plan_gn_bwd``): which route each GroupNorm forward and backward takes,
and the invariants the one-pass CUDA kernels check before they launch; and
the launch counters that the CPU path of the fused conv and GroupNorm
functions never moves. Pure Python and CPU torch: no card, no JAX."""
import itertools

import pytest
import torch

from torchbooster_tpu_torch.ops import fused_block as fb
from torchbooster_tpu_torch.ops import group_norm as gn

# (N, H·W, C) -> (route, cluster, rows) with 32 groups, bf16
PLANS = {
    # ResNet-18 CIFAR's four fused norms at the recipe's batch 512: a
    # sample's x + dy slab is 256, 128, 64 and 32 KB, over the fewest CTAs
    # that let three share an SM
    "r18_stem": ((512, 32 * 32, 64), ("one_pass", 4, 256)),
    "r18_stage1": ((512, 16 * 16, 128), ("one_pass", 2, 128)),
    "r18_stage2": ((512, 8 * 8, 256), ("one_pass", 1, 64)),
    "r18_stage3": ((512, 4 * 4, 512), ("one_pass", 1, 16)),
    # ResNet-50's 7² x 2048 norm: 401 KB, no 3-an-SM fit, 7 CTAs of 7
    "r50_7sq_2048": ((32, 7 * 7, 2048), ("one_pass", 7, 7)),
    "nonsquare_7x9": ((8, 7 * 9, 64), ("one_pass", 1, 63)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_gn_bwd_routes(name):
    (n, hw, c), want = PLANS[name]
    groups = fb._resolve_groups(32, c)
    assert tuple(gn.plan_gn_bwd(n, hw, c, groups, torch.bfloat16)) == want


@pytest.mark.parametrize("n,hw,c,groups,dtype", [
    (8, 63, 12, 12, torch.bfloat16),       # C off the 16-byte vectors
    (512, 1024, 64, 32, torch.float32),    # fp32 stays on gn_bwd
    (32, 3136, 256, 32, torch.bfloat16),   # 392 positions a CTA at 8
    (4, 16, 4096, 32, torch.bfloat16),     # more channels than 256 x 8
])
def test_plan_gn_bwd_falls_back_to_two_pass(n, hw, c, groups, dtype):
    assert gn.plan_gn_bwd(n, hw, c, groups, dtype).route == "two_pass"


def _smem_bytes(rows: int, c: int, groups: int) -> int:
    """``smem_bytes`` of ``csrc/group_norm_bwd_sm90.cu``, written out."""
    trows = 256 // (c // 8)
    return rows * c * 4 + max(trows, 2) * c * 4 + 2 * c * 4 + 2 * groups * 4


@pytest.mark.parametrize("hw", (1, 7, 16, 49, 63, 64, 256, 1024, 3136))
def test_plan_gn_bwd_invariants(hw):
    """What ``tb_gn_bwd_sm90`` checks before it launches holds for every
    one-pass plan: C a multiple of 8 and at most 2048, at most 8 CTAs a
    sample, every CTA holding at least one position and together all of
    them, and the shared memory within the card's 227 KB; the fewest CTAs
    that let three share an SM (75 KB each), else 8."""
    for c, groups in itertools.product((8, 24, 64, 128, 512, 1000, 2048),
                                       (1, 4, 32)):
        groups = fb._resolve_groups(groups, c)
        plan = gn.plan_gn_bwd(16, hw, c, groups, torch.bfloat16)
        if plan.route == "two_pass":
            assert _smem_bytes(-(-hw // 8), c, groups) > 227 * 1024
            continue
        assert c % 8 == 0 and c <= 2048
        assert 1 <= plan.cluster <= 8
        assert plan.rows * plan.cluster >= hw > plan.rows * (plan.cluster - 1)
        smem = _smem_bytes(plan.rows, c, groups)
        assert smem == gn.gn_bwd_smem_bytes(plan.rows, c, groups)
        assert smem <= 227 * 1024
        fewer = [_smem_bytes(-(-hw // k), c, groups)
                 for k in range(1, plan.cluster)]
        assert all(b > 75 * 1024 for b in fewer)
        assert smem <= 75 * 1024 or plan.rows == -(-hw // 8)


@pytest.mark.parametrize("per_sm", (1, 2, 3))
def test_gn_bwd_plan_fits_the_ctas_an_sm_it_names(per_sm):
    """``gn_bwd_plan`` (the smoke's plan sweep) gives the fewest CTAs a
    sample whose shared memory, with the 1 KB the card keeps a CTA, lets
    ``per_sm`` share an SM's 228 KB, or None."""
    for hw, c in itertools.product((16, 49, 64, 256, 1024), (64, 512, 2048)):
        plan = gn.gn_bwd_plan(hw, c, 32, per_sm)
        cap = min(233472 // per_sm - 1024, 232448)
        if plan is None:
            assert _smem_bytes(-(-hw // 8), c, 32) > cap
            continue
        assert _smem_bytes(plan.rows, c, 32) <= cap
        assert all(_smem_bytes(-(-hw // k), c, 32) > cap
                   for k in range(1, plan.cluster))


# (N, H·W, C) -> (route, cluster, rows, pack) with 32 groups (clipped), bf16
FWD_PLANS = {
    # ResNet-18 CIFAR's four norms at batch 512: a sample's x is 128, 64,
    # 32 and 16 KB, over the fewest CTAs that let three share an SM; the 32
    # KB samples two to a CTA (two CTAs an SM), the 64 KB ones not (two
    # would not share an SM), the 16 KB ones not (below 32 KB)
    "r18_stem": ((512, 32 * 32, 64), ("one_pass", 2, 512, 1)),
    "r18_stage1": ((512, 16 * 16, 128), ("one_pass", 1, 256, 1)),
    "r18_stage2": ((512, 8 * 8, 256), ("one_pass", 1, 64, 2)),
    "r18_stage3": ((512, 4 * 4, 512), ("one_pass", 1, 16, 1)),
    # the smoke's and card tests' other GroupNorm geometries: ResNet-50's
    # 7² x 2048 norm (5 CTAs of 10 positions), a non-square map, more
    # samples than the card holds CTAs at once
    "r50_7sq_2048": ((32, 7 * 7, 2048), ("one_pass", 5, 10, 1)),
    "nonsquare_7x9": ((8, 7 * 9, 64), ("one_pass", 1, 63, 1)),
    "many_samples_7x9": ((1000, 7 * 9, 64), ("one_pass", 1, 63, 1)),
    "b32_stem": ((32, 32 * 32, 64), ("one_pass", 2, 512, 1)),
    "b4_stage1": ((4, 16 * 16, 128), ("one_pass", 1, 256, 1)),
    "b3_stage2": ((3, 8 * 8, 256), ("one_pass", 1, 64, 2)),
    "r50_14sq_256": ((32, 14 * 14, 256), ("one_pass", 2, 98, 1)),
}


@pytest.mark.parametrize("name", sorted(FWD_PLANS))
def test_plan_gn_fwd_routes(name):
    (n, hw, c), want = FWD_PLANS[name]
    groups = fb._resolve_groups(32, c)
    assert tuple(gn.plan_gn_fwd(n, hw, c, groups, torch.bfloat16)) == want


@pytest.mark.parametrize("n,hw,c,groups,dtype", [
    (512, 1024, 64, 32, torch.float32),    # fp32 stays on gn_fwd
    (8, 63, 12, 12, torch.bfloat16),       # C off the 16-byte vectors
    (4, 16, 4096, 32, torch.bfloat16),     # more channels than 256 x 8
    (65536, 16, 64, 32, torch.bfloat16),   # more samples than the grid's y
    (8, 63, 64, 24, torch.bfloat16),       # groups not dividing C
    (2, 3136, 512, 32, torch.bfloat16),    # 392 positions a CTA at 8: 400 KB
])
def test_plan_gn_fwd_falls_back_to_two_pass(n, hw, c, groups, dtype):
    assert tuple(gn.plan_gn_fwd(n, hw, c, groups, dtype)) == (
        "two_pass", 1, hw, 1)


def _fwd_smem_bytes(rows: int, c: int, groups: int, pack: int = 1) -> int:
    """``smem_bytes`` of ``csrc/group_norm_fwd_sm90.cu``, written out."""
    trows = 256 // (c // 8)
    red = max(trows, 2) if pack == 1 else 2 * pack * trows
    return (pack * rows * c * 2 + red * c * 4 + pack * 2 * c * 4
            + pack * 2 * groups * 4)


@pytest.mark.parametrize("hw", (1, 7, 16, 49, 63, 64, 256, 1024, 3136))
def test_plan_gn_fwd_invariants(hw):
    """What ``tb_gn_fwd_sm90`` checks before it launches holds for every
    one-pass plan: C a multiple of 8 and at most 2048, at most 8 CTAs a
    sample, every CTA holding at least one position and together all of
    them, and the shared memory within the card's 227 KB; the fewest CTAs
    that let three share an SM (75 KB each), else 8; two whole samples a
    CTA only where one CTA held one sample of at least 32 KB and the pair
    still lets two share an SM (113 KB)."""
    for c, groups in itertools.product((8, 24, 64, 128, 512, 1000, 2048),
                                       (1, 4, 32)):
        groups = fb._resolve_groups(groups, c)
        plan = gn.plan_gn_fwd(16, hw, c, groups, torch.bfloat16)
        if plan.route == "two_pass":
            assert c % 8 or _fwd_smem_bytes(-(-hw // 8), c, groups) \
                > 227 * 1024
            continue
        assert c % 8 == 0 and c <= 2048 and plan.pack in (1, 2)
        assert 1 <= plan.cluster <= 8
        assert plan.rows * plan.cluster >= hw > plan.rows * (plan.cluster - 1)
        pair = _fwd_smem_bytes(hw, c, groups, 2)
        if plan.pack == 2:
            assert plan.cluster == 1 and 2 * hw * c >= 32 * 1024
            assert _fwd_smem_bytes(hw, c, groups) <= 75 * 1024
            assert pair == gn.gn_fwd_smem_bytes(hw, c, groups, 2)
            assert pair <= 113 * 1024
            continue
        assert not (plan.cluster == 1 and 2 * hw * c >= 32 * 1024
                    and pair <= 113 * 1024)
        smem = _fwd_smem_bytes(plan.rows, c, groups)
        assert smem == gn.gn_fwd_smem_bytes(plan.rows, c, groups)
        assert smem <= 227 * 1024
        fewer = [_fwd_smem_bytes(-(-hw // k), c, groups)
                 for k in range(1, plan.cluster)]
        assert all(b > 75 * 1024 for b in fewer)
        assert smem <= 75 * 1024 or plan.rows == -(-hw // 8)


@pytest.mark.parametrize("per_sm", (1, 2, 3, 4))
def test_gn_fwd_plan_fits_the_ctas_an_sm_it_names(per_sm):
    """``gn_fwd_plan`` (the smoke's plan sweep) gives the fewest CTAs a
    sample, or at ``pack`` > 1 one CTA of ``pack`` whole samples, whose
    shared memory, with the 1 KB the card keeps a CTA, lets ``per_sm``
    share an SM's 228 KB, or None."""
    cap = min(233472 // per_sm - 1024, 232448)
    for hw, c in itertools.product((16, 49, 64, 256, 1024), (64, 512, 2048)):
        plan = gn.gn_fwd_plan(hw, c, 32, per_sm)
        if plan is None:
            assert _fwd_smem_bytes(-(-hw // 8), c, 32) > cap
        else:
            assert plan.pack == 1
            assert _fwd_smem_bytes(plan.rows, c, 32) <= cap
            assert all(_fwd_smem_bytes(-(-hw // k), c, 32) > cap
                       for k in range(1, plan.cluster))
        for pack in (2, 4, 8):
            plan = gn.gn_fwd_plan(hw, c, 32, per_sm, pack)
            fits = _fwd_smem_bytes(hw, c, 32, pack) <= cap
            assert plan == (("one_pass", 1, hw, pack) if fits else None)
            if fits:
                assert plan.rows * plan.cluster == hw


def test_cpu_path_leaves_every_route_counter_at_zero():
    """The plain versions run on CPU tensors: a forward and backward of
    ``conv1x1_gn_relu`` (stride 2) and ``group_norm_fused`` moves no launch
    counter of B5, B6 or B7, by route or in all (B5's by-route counter
    reads zero where no card ran a kernel)."""
    counters = (fb.launches_1x1_by_route, gn.launches_fwd_by_route,
                gn.launches_bwd_by_route)
    before = [dict(c) for c in counters] + [
        fb.launches_1x1, gn.launches_fwd, gn.launches_bwd]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 8, 16, generator=gen, requires_grad=True)
    w = torch.randn(16, 32, generator=gen, requires_grad=True)
    s32 = torch.ones(32, requires_grad=True)
    b32 = torch.zeros(32, requires_grad=True)
    y = fb.conv1x1_gn_relu(x, w, s32, b32, groups=8, stride=2)
    z = gn.group_norm_fused(s32, b32, y, 8, relu=True)
    z.sum().backward()
    assert x.grad is not None and w.grad is not None
    after = [dict(c) for c in counters] + [
        fb.launches_1x1, gn.launches_fwd, gn.launches_bwd]
    assert after == before
    if not torch.cuda.is_available():
        assert gn.launches_fwd_by_route == {"one_pass": 0, "two_pass": 0}
