"""B8's launch plan (``ops.fused_block.plan_conv3x3``): which route each
3x3 conv + GroupNorm shape takes, and the invariants the one-pass CUDA
kernel checks before it launches. Pure Python: no card, no JAX."""
import itertools

import pytest

from torchbooster_tpu_torch.ops import fused_block as fb

# (B, H, W, Cin, Cout) -> (route, bm, bn, p, cluster) with 32 groups
PLANS = {
    # ResNet-18 CIFAR stride-1 3x3s at the recipe's batch 512
    "r18_stage0": ((512, 32, 32, 64, 64), ("cluster", 128, 64, 1, 8)),
    "r18_stage1": ((512, 16, 16, 128, 128), ("cluster", 128, 128, 1, 2)),
    "r18_stage2": ((512, 8, 8, 256, 256), ("pack", 128, 256, 2, 1)),
    "r18_stage3": ((512, 4, 4, 512, 512), ("pack", 128, 256, 8, 1)),
    # ResNet-50 at 224² (bottleneck 3x3s, batch 32): 56² has M = 3136
    "r50_56sq": ((32, 56, 56, 64, 64), ("mma_sync", 64, 64, 1, 1)),
    "r50_28sq": ((32, 28, 28, 128, 128), ("cluster", 128, 128, 1, 7)),
    "r50_14sq": ((32, 14, 14, 256, 256), ("cluster", 128, 256, 1, 2)),
    "r50_7sq": ((32, 7, 7, 512, 512), ("pack", 128, 256, 2, 1)),
    # the card tests' small batches: a cluster at B 3, a partial pack
    "cluster_b3": ((3, 32, 32, 64, 64), ("cluster", 128, 64, 1, 8)),
    "pack_rem_b5": ((5, 4, 4, 512, 512), ("pack", 128, 256, 8, 1)),
    # widths off the 16-byte vectors, and a 4x4 map's 16-row mma tile
    "odd_cin12_cout40": ((8, 7, 9, 12, 40), ("mma_sync", 64, 64, 1, 1)),
    "odd_cout36_4sq": ((8, 4, 4, 64, 36), ("mma_sync", 16, 64, 1, 1)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_conv3x3_routes(name):
    (b, h, w, cin, cout), want = PLANS[name]
    groups = fb._resolve_groups(32, cout)
    assert tuple(fb.plan_conv3x3(b, h, w, cin, cout, groups)) == want


@pytest.mark.parametrize("hw", (1, 2, 4, 7, 8, 11, 14, 16, 28, 32, 33, 56))
def test_plan_conv3x3_invariants(hw):
    """What ``tb_conv3x3_gn_sm90`` checks before it launches holds for
    every plan of the one-pass routes, over batches, widths and groups;
    every other shape plans ``"mma_sync"``."""
    m = hw * hw
    for b, cin, cout, groups in itertools.product(
            (1, 3, 512), (3, 8, 12, 64, 512),
            (8, 24, 40, 64, 96, 512, 2048), (1, 2, 8, 32)):
        groups = fb._resolve_groups(groups, cout)
        plan = fb.plan_conv3x3(b, hw, hw, cin, cout, groups)
        if plan.route == "mma_sync":
            continue
        assert cin % 8 == 0 and cout % 8 == 0
        assert plan.bm == 128 and plan.bn in (64, 128, 256)
        assert plan.bn % (cout // groups) == 0
        if plan.route == "pack":
            assert m <= plan.bm and plan.cluster == 1
            assert 1 <= plan.p <= 8 and plan.p * m <= plan.bm
        else:
            assert plan.route == "cluster" and plan.p == 1
            assert m > plan.bm and plan.cluster == -(-m // plan.bm) <= 8


@pytest.mark.parametrize("cin,cout,groups,hw", [
    (12, 40, 20, 8),      # Cin off the 16-byte vectors
    (64, 44, 11, 8),      # Cout off them
    (64, 64, 32, 56),     # M = 3136: a sample needs 25 CTAs of 128 rows
    (64, 512, 1, 8),      # a group 512 wide fits no Cout tile
    (64, 768, 32, 8),     # a group 24 wide divides no Cout tile
])
def test_plan_conv3x3_falls_back_to_mma_sync(cin, cout, groups, hw):
    assert fb.plan_conv3x3(4, hw, hw, cin, cout, groups).route == "mma_sync"


# B7 (1x1 conv + GroupNorm, ``plan_conv1x1``): (B, H, W, Cin, Cout, stride)
# -> (route, bm, bn, p, cluster) with 32 groups; the rule is B8's over the
# output map, with Cout tiles of at most 128
PLANS_1X1 = {
    # ResNet-18 CIFAR's stride-2 projections at the recipe's batch 512
    "r18_stage1_proj": ((512, 32, 32, 64, 128, 2),
                        ("cluster", 128, 128, 1, 2)),
    "r18_stage2_proj": ((512, 16, 16, 128, 256, 2), ("pack", 128, 128, 2, 1)),
    "r18_stage3_proj": ((512, 8, 8, 256, 512, 2), ("pack", 128, 128, 8, 1)),
    # a non-square map: 7 x 9 at stride 2 is 4 x 5 = 20 outputs, 6 a tile
    "nonsquare_7x9_s2": ((8, 7, 9, 64, 128, 2), ("pack", 128, 128, 6, 1)),
    # ResNet-50's 56² 1x1 (M = 3136) and Cin 12 take the two-pass kernel
    "r50_56sq_64to256": ((32, 56, 56, 64, 256, 1),
                         ("mma_sync", 64, 64, 1, 1)),
    "odd_cin12_cout40_s2": ((8, 7, 9, 12, 40, 2), ("mma_sync", 32, 64, 1, 1)),
}


@pytest.mark.parametrize("name", sorted(PLANS_1X1))
def test_plan_conv1x1_routes(name):
    (b, h, w, cin, cout, stride), want = PLANS_1X1[name]
    groups = fb._resolve_groups(32, cout)
    assert tuple(fb.plan_conv1x1(b, h, w, cin, cout, groups, stride)) == want


@pytest.mark.parametrize("stride", (1, 2, 3))
def test_plan_conv1x1_invariants(stride):
    """What ``tb_conv1x1_gn_sm90`` checks before it launches holds for every
    plan of the one-pass routes, over maps, batches, widths and groups: M
    counts the strided output map, and Cout tiles stop at 128 (two CTAs an
    SM); every other shape plans ``"mma_sync"``."""
    for hw, b, cin, cout, groups in itertools.product(
            (1, 4, 7, 8, 16, 32, 33, 56), (1, 3, 512), (8, 12, 64, 256),
            (8, 40, 64, 96, 512, 2048), (1, 2, 8, 32)):
        groups = fb._resolve_groups(groups, cout)
        plan = fb.plan_conv1x1(b, hw, hw, cin, cout, groups, stride)
        m = (-(-hw // stride)) ** 2
        if plan.route == "mma_sync":
            continue
        assert cin % 8 == 0 and cout % 8 == 0
        assert plan.bm == 128 and plan.bn in (64, 128)
        assert plan.bn % (cout // groups) == 0
        if plan.route == "pack":
            assert m <= plan.bm and plan.cluster == 1
            assert 1 <= plan.p <= 8 and plan.p * m <= plan.bm
        else:
            assert plan.route == "cluster" and plan.p == 1
            assert m > plan.bm and plan.cluster == -(-m // plan.bm) <= 8


@pytest.mark.parametrize("cin,cout,groups,hw,stride", [
    (12, 40, 20, 8, 2),     # Cin off the 16-byte vectors
    (64, 44, 11, 8, 2),     # Cout off them
    (64, 256, 32, 56, 1),   # M = 3136: a sample needs 25 CTAs of 128 rows
    (64, 64, 32, 66, 2),    # M = 33² = 1089 > 1024 at stride 2
    (64, 512, 2, 8, 2),     # a group 256 wide fits no Cout tile of <= 128
    (64, 768, 32, 8, 2),    # a group 24 wide divides no Cout tile
])
def test_plan_conv1x1_falls_back_to_mma_sync(cin, cout, groups, hw, stride):
    assert fb.plan_conv1x1(4, hw, hw, cin, cout, groups,
                           stride).route == "mma_sync"


def test_plan_conv1x1_at_stride_1_is_plan_conv3x3_up_to_the_cout_tile():
    """One rule for both kernels: at stride 1 the 1x1 plan differs from the
    3x3 plan of the same map only where the 3x3 plan takes a 256 tile."""
    for hw, cout in itertools.product((4, 8, 14, 16, 32), (64, 128, 256,
                                                           512)):
        one = fb.plan_conv1x1(16, hw, hw, 64, cout, 32, 1)
        three = fb.plan_conv3x3(16, hw, hw, 64, cout, 32)
        assert one.route == three.route
        assert one._replace(bn=0) == three._replace(bn=0)
        assert one.bn == min(three.bn, 128)
