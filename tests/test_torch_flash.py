"""Port parity: the flash attention of ``torchbooster_tpu_torch`` (the
plain blocked versions of kernels B1-B3, which its CPU path runs)
against the JAX package's ``flash_attention`` in interpret mode, on the
CPU, at a small size (BH <= 8, S <= 48, D 16), inputs from a numpy seed.

- forward ``o`` and ``lse``, and ``dq``/``dk``/``dv`` (``jax.vjp`` of the
  JAX kernel), causal and non-causal, GQA rep 2, ``S_q < S_kv`` (the
  KV-cache alignment) and a multi-block sweep (block 8 over S 32);
- the untileable-length ``ValueError`` and the ``tileable`` predicate;
- the ``attention`` dispatcher on the CPU, and its flash route against
  the JAX dispatcher's interpret-mode flash route;
- the plain path never counts a kernel launch, and a tensor on a device
  that is neither the CPU nor a card raises instead of falling back.

Tolerance: both sides compute in fp32 with the same blocking, and differ
only in summation order inside a product, so 1e-5 absolute and relative.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.ops import flash_attention as jfa
from torchbooster_tpu.ops.attention import attention as jax_attention
from torchbooster_tpu_torch.ops import flash_attention as fa
from torchbooster_tpu_torch.ops.attention import (
    attention,
    flash_auto_engaged,
    mha_reference,
)

TOL = dict(atol=1e-5, rtol=1e-5)

GEOMETRIES = {
    # name: (bh, bh_kv, s_q, s_kv, causal, block_q, block_k)
    "causal": (8, 8, 32, 32, True, None, None),
    "noncausal": (8, 8, 32, 32, False, None, None),
    "gqa_rep2": (8, 4, 32, 32, True, None, None),
    "kv_cache_sq16_skv48": (8, 8, 16, 48, True, None, None),
    "multiblock_8_over_32": (8, 8, 32, 32, True, 8, 8),
}


def _inputs(seed, bh, bh_kv, s_q, s_kv, d=16):
    rs = np.random.RandomState(seed)
    q = rs.randn(bh, s_q, d).astype(np.float32)
    k = rs.randn(bh_kv, s_kv, d).astype(np.float32)
    v = rs.randn(bh_kv, s_kv, d).astype(np.float32)
    do = rs.randn(bh, s_q, d).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_flash_forward_and_grads_match_jax(name):
    bh, bh_kv, s_q, s_kv, causal, bq, bk = GEOMETRIES[name]
    q, k, v, do = _inputs(0, bh, bh_kv, s_q, s_kv)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    # lse from the JAX forward with residuals (8-lane padded there)
    j_bq = jfa._pick_block(bq or 1024, s_q, "seq_q")
    j_bk = jfa._pick_block(bk or 1024, s_kv, "seq_kv")
    _, j_lse = jfa._fwd_pallas(jq, jk, jv, causal=causal, sm_scale=scale,
                               block_q=j_bq, block_k=j_bk, interpret=True,
                               save_residuals=True)
    j_o, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, block_q=bq, block_k=bk, interpret=True),
        jq, jk, jv)
    j_grads = vjp(jnp.asarray(do))

    o, lse = fa.flash_attention_reference(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), causal,
        None, bq or fa.DEFAULT_BLOCK, bk or fa.DEFAULT_BLOCK)
    np.testing.assert_allclose(o.numpy(), np.asarray(j_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], **TOL)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                             block_k=bk)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_o), **TOL)
    out.backward(torch.as_tensor(do))
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        assert got.shape == want.shape       # dK/dV at grouped width
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_untileable_length_raises_like_jax():
    q, k, v, _ = _inputs(1, 4, 4, 36, 36)
    with pytest.raises(ValueError, match="cannot tile"):
        fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                           torch.as_tensor(v), block_q=32)
    with pytest.raises(ValueError, match="cannot tile"):
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            block_q=32, interpret=True)
    for seq, block in ((36, 32), (36, None), (1000, None), (1000, 64),
                       (1500, None), (4096, None), (1001, 64)):
        assert fa.tileable(seq, block) == jfa.tileable(seq, block), (seq,
                                                                     block)


def test_attention_dispatch_on_the_cpu():
    rs = np.random.RandomState(2)
    q = rs.randn(2, 16, 4, 16).astype(np.float32)
    k = rs.randn(2, 16, 2, 16).astype(np.float32)
    v = rs.randn(2, 16, 2, 16).astype(np.float32)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    # "auto" on a CPU tensor is the reference, as off-TPU in JAX
    assert not flash_auto_engaged(16, 16, "cpu")
    assert flash_auto_engaged(1024, 1024, "cuda")
    assert flash_auto_engaged(1000, device="cuda")      # one 1000 block
    assert not flash_auto_engaged(1500, 1024, "cuda")   # untileable
    torch.testing.assert_close(attention(tq, tk, tv),
                               mha_reference(tq, tk, tv), atol=0, rtol=0)
    # "flash" on the CPU runs the plain blocked version: held to the JAX
    # dispatcher's interpret-mode kernel (grouped k/v folded at their width)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         impl="flash_interpret")
    got = attention(tq, tk, tv, impl="flash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        attention(tq, tk, tv, impl="reference").numpy(),
        np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), impl="reference")), **TOL)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(tq, tk, tv, impl="pallas")


def test_plain_path_counts_no_launch_and_other_devices_raise():
    q, k, v, do = _inputs(3, 4, 4, 16, 16)
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    tq = torch.tensor(q, requires_grad=True)
    fa.flash_attention(tq, torch.as_tensor(k), torch.as_tensor(v)).backward(
        torch.as_tensor(do))
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before
    meta = torch.empty((4, 16, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(meta, meta, meta)
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before
