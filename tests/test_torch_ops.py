"""Port parity: attention ops of ``torchbooster_tpu_torch`` against the
JAX package on the CPU.

- ``mha_reference`` / ``expand_kv_heads`` vs the JAX reference (fp32);
- ``paged_attention_reference`` (the CUDA kernel's plain version) vs
  the JAX Pallas ``paged_attention`` in interpret mode, for all four
  layouts (plain or int8 pool, with or without a tree mask), with a
  prefix page shared by two lanes, at fp32 atol 1e-5 on the slots the
  work list references;
- the wrapper runs the plain version on CPU tensors and leaves the
  launch counter alone;
- ``_quantize_kv`` is bit-exact.

The CUDA kernel itself is held to its plain version in
``tests/test_torch_cuda.py`` (on a card) and in ``chip_smoke.py``.
"""
import importlib
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models.gpt import _quantize_kv as jax_quantize_kv
from torchbooster_tpu.ops.attention import mha_reference as jax_mha
from torchbooster_tpu.ops.paged_attention import paged_attention as jax_paged
from torchbooster_tpu_torch.models.gpt import _quantize_kv
from torchbooster_tpu_torch.ops.attention import mha_reference
from tests.test_torch_cuda import paged_inputs
pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_mha_reference_matches_jax(kv_heads):
    rs = np.random.RandomState(0)
    q = rs.randn(2, 6, 4, 8).astype(np.float32)
    k = rs.randn(2, 6, kv_heads, 8).astype(np.float32)
    v = rs.randn(2, 6, kv_heads, 8).astype(np.float32)
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True))
    got = mha_reference(torch.as_tensor(q), torch.as_tensor(k),
                        torch.as_tensor(v), causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _paged_inputs(rs, *, s_q, quantized, tree):
    """The shared small paged case, plus the JAX operands built from the
    same numpy pool (``_quantize_kv`` is bit-exact across the two)."""
    x = paged_inputs(rs, s_q=s_q, quantized=quantized, tree=tree)
    if quantized:
        x["jax_k"] = tuple(jax_quantize_kv(jnp.asarray(x["k"])))
        x["jax_v"] = tuple(jax_quantize_kv(jnp.asarray(x["v"])))
    else:
        x["jax_k"], x["jax_v"] = jnp.asarray(x["k"]), jnp.asarray(x["v"])
    return x


@pytest.mark.parametrize("quantized,tree,s_q", [
    (False, False, 1), (True, False, 3), (False, True, 3), (True, True, 3)])
def test_paged_reference_matches_jax_kernel(quantized, tree, s_q):
    x = _paged_inputs(np.random.RandomState(1), s_q=s_q,
                      quantized=quantized, tree=tree)
    want = np.asarray(jax_paged(
        jnp.asarray(x["q"]), x["jax_k"], x["jax_v"], jnp.asarray(x["wp"]),
        jnp.asarray(x["wr"]), jnp.asarray(x["wpos"]), jnp.asarray(x["lens"]),
        page_size=x["ps"], tree_vis=None if x["tvis"] is None
        else jnp.asarray(x["tvis"]), interpret=True))
    got = pa.paged_attention_reference(
        torch.as_tensor(x["q"]), x["pk"], x["pv"], torch.as_tensor(x["wp"]),
        torch.as_tensor(x["wr"]), torch.as_tensor(x["wpos"]),
        torch.as_tensor(x["lens"]), page_size=x["ps"],
        tree_vis=None if x["tvis"] is None else torch.as_tensor(x["tvis"]))
    ref = x["referenced"]
    assert got.dtype == torch.float32 and got.shape == x["q"].shape
    np.testing.assert_allclose(got.numpy()[ref], want[ref], atol=1e-5,
                               rtol=1e-5)


def test_paged_wrapper_cpu_runs_plain_version_without_launch():
    x = _paged_inputs(np.random.RandomState(2), s_q=1, quantized=False,
                      tree=False)
    args = (torch.as_tensor(x["q"]), x["pk"], x["pv"],
            torch.as_tensor(x["wp"]), torch.as_tensor(x["wr"]),
            torch.as_tensor(x["wpos"]), torch.as_tensor(x["lens"]))
    before = pa.launches
    got = pa.paged_attention(*args, page_size=x["ps"])
    assert pa.launches == before
    torch.testing.assert_close(
        got, pa.paged_attention_reference(*args, page_size=x["ps"]),
        atol=0, rtol=0)


def test_paged_reference_fully_masked_lane_contributes_nothing():
    """A write-ahead page past a slot's length: every token masked —
    the lane must add l = 0 (not page_size phantom tokens), no NaN."""
    x = _paged_inputs(np.random.RandomState(3), s_q=1, quantized=False,
                      tree=False)
    lens = x["lens"].copy()
    lens[1] = 2                      # slot 1's later pages are all masked
    args = (torch.as_tensor(x["q"]), x["pk"], x["pv"],
            torch.as_tensor(x["wp"]), torch.as_tensor(x["wr"]),
            torch.as_tensor(x["wpos"]))
    got = pa.paged_attention_reference(*args, torch.as_tensor(lens),
                                       page_size=x["ps"])
    want = np.asarray(jax_paged(
        jnp.asarray(x["q"]), x["jax_k"], x["jax_v"], jnp.asarray(x["wp"]),
        jnp.asarray(x["wr"]), jnp.asarray(x["wpos"]), jnp.asarray(lens),
        page_size=x["ps"], interpret=True))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy()[1], want[1], atol=1e-5, rtol=1e-5)


def test_quantize_kv_bit_exact():
    x = (np.random.RandomState(4).randn(3, 5, 2, 16) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                 # an all-zero row takes the 1e-8 floor
    jq, js = jax_quantize_kv(jnp.asarray(x))
    tq, ts = _quantize_kv(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        ts.view(torch.int16).numpy(),
        np.asarray(js).view(np.int16))
