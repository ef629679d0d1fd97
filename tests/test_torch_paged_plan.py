"""B4's launch plan (``ops.paged_attention.plan_paged``): which route each
serving shape takes, the invariants the ``"sm90"`` kernel checks before it
launches, how a named route is held to the plan, and that the smoke's
build phase builds every CUDA source. Pure Python: no card, no nvcc."""
import importlib
import itertools
import numpy as np
import pytest
import torch

import chip_smoke
from torchbooster_tpu_torch.ops import _build
pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8

# (q dtype, pool dtype, head_dim, page_size, S, rep) -> route
PLANS = {
    # GPT-2 small's bf16 decode (12 heads of 64, 64-token pages)
    "gpt2_small_bf16_decode": ((BF16, BF16, 64, 64, 1, 1), "sm90"),
    "bf16_q_int8_pool": ((BF16, I8, 64, 64, 1, 1), "sm90"),
    "gqa_rep3_verify5": ((BF16, BF16, 64, 64, 5, 3), "sm90"),
    "d32": ((BF16, BF16, 32, 64, 1, 1), "sm90"),
    # gpt-long's 16 heads over 8 of 48: decode, verify 5, and an int8 pool
    "d48": ((BF16, BF16, 48, 64, 1, 2), "sm90"),
    "d48_verify5": ((BF16, BF16, 48, 64, 5, 2), "sm90"),
    "d48_int8_pool": ((BF16, I8, 48, 64, 1, 2), "sm90"),
    "fp32_q": ((F32, BF16, 64, 64, 1, 1), "simt"),
    "fp32_pool": ((BF16, F32, 64, 64, 1, 1), "simt"),
    # the small parity case of tests/test_torch_cuda.py (4-token pages)
    "page4": ((BF16, BF16, 8, 4, 1, 2), "simt"),
    "d40": ((BF16, BF16, 40, 64, 1, 1), "simt"),
    "rows_over_64": ((BF16, BF16, 64, 64, 5, 13), "simt"),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_paged_routes(name):
    args, want = PLANS[name]
    assert pa.plan_paged(*args) == want


@pytest.mark.parametrize("page_size,want", [
    (8, "simt"), (16, "sm90"), (24, "simt"), (32, "sm90"), (128, "sm90"),
    (144, "simt"), (256, "simt")])
def test_plan_paged_page_size_edges(page_size, want):
    """A multiple of 16 from 16 to 128: the kernel's 16-token blocks, and
    the largest page whose two-slot K/V ring fits beside 64 query rows at
    head dim 128."""
    assert pa.SM90_MAX_PAGE == 128
    for head_dim in pa.SM90_HEAD_DIMS:
        assert pa.plan_paged(BF16, BF16, head_dim, page_size, 1, 1) == want


@pytest.mark.parametrize("s_q,rep,want", [
    (1, 64, "sm90"), (1, 65, "simt"), (4, 16, "sm90"), (5, 13, "simt"),
    (64, 1, "sm90"), (65, 1, "simt")])
def test_plan_paged_row_limit(s_q, rep, want):
    """At most 64 query rows (rep x S) per kv head, one staged group."""
    assert pa.plan_paged(BF16, I8, 64, 64, s_q, rep) == want


@pytest.mark.parametrize("pool", [BF16, I8])
def test_plan_paged_d48_takes_every_row_count_to_64(pool):
    """Head dim 48 (gpt-long's) plans ``"sm90"`` over a bf16 or an int8
    pool at 64-token pages for every ``rep * S <= 64``, ``"simt"`` above."""
    for rep, s_q in itertools.product((1, 2, 3, 4, 8, 16), range(1, 33)):
        want = "sm90" if rep * s_q <= 64 else "simt"
        assert pa.plan_paged(BF16, pool, 48, 64, s_q, rep) == want
        assert pa.check_paged(BF16, pool, 48, 64, s_q, rep) == want


def _cpu_case(q_dtype=BF16, page_size=64, head_dim=64):
    rs = np.random.RandomState(0)
    q = torch.as_tensor(rs.randn(2, 1, 4, head_dim)).to(q_dtype)
    pool = torch.as_tensor(rs.randn(3, page_size, 4, head_dim)).to(BF16)
    work = (torch.tensor([1, 2]), torch.tensor([[0], [1]]),
            torch.tensor([0, 0]), torch.tensor([5, 9]))
    return (q, pool, pool.clone(), *work), dict(page_size=page_size)


@pytest.mark.parametrize("route", ["sm90", "simt"])
def test_named_route_on_cpu_runs_the_plain_version(route):
    """A route the plan allows is accepted on CPU tensors, where the plain
    version runs and no launch is counted."""
    args, kw = _cpu_case()
    before = dict(pa.launches_by_route)
    got = pa.paged_attention(*args, **kw, route=route)
    torch.testing.assert_close(got, pa.paged_attention_reference(*args,
                                                                  **kw))
    assert pa.launches_by_route == before


@pytest.mark.parametrize("case,route", [
    (dict(q_dtype=F32), "sm90"), (dict(page_size=4), "sm90"),
    (dict(head_dim=40), "sm90"), (dict(), "tensor_cores")])
def test_named_route_that_cannot_take_the_operands_raises(case, route):
    args, kw = _cpu_case(**case)
    with pytest.raises(ValueError, match="route"):
        pa.paged_attention(*args, **kw, route=route)


def test_launch_counters_by_route():
    assert set(pa.launches_by_route) == {"sm90", "simt"}


def test_every_cuda_source_is_built_by_the_smoke():
    """The smoke's build phase compiles ``SOURCES``: every ``csrc/*.cu``,
    B4's ``paged_decode_sm90`` among them."""
    on_disk = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert on_disk == set(chip_smoke.SOURCES)
    assert "paged_decode_sm90" in on_disk
    assert len(chip_smoke.SOURCES) == len(set(chip_smoke.SOURCES))


def test_sm90_source_key_covers_its_header():
    """The build's cache key hashes ``sm90_wgmma.cuh``, which the B4
    ``sm90`` source includes."""
    names = [p.name for p in _build._sources(
        _build.CSRC / "paged_decode_sm90.cu", [])]
    assert names == ["paged_decode_sm90.cu", "sm90_wgmma.cuh"]
