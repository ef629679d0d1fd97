"""Port parity: ``GPT.apply(..., remat=True)`` under the JAX package's
remat policy, ``dots_with_no_batch_dims_saveable``, on the CPU at fp32
(2 layers, d_model 32, 4 heads, vocab 97):

- gradients with ``remat=True`` equal ``remat=False`` bit for bit, and
  JAX's ``remat=True`` gradients at the tolerance of the GPT gradient
  parity test, attention through the flash route (its plain blocked
  version here, interpret mode in JAX) and through the reference;
- counted by a ``TorchDispatchMode`` over the backward: no forward
  ``mm``/``addmm`` of a block runs again (backward takes as many as
  without remat), while every attention ``bmm`` of the forward does;
- the reference's own count: JAX's gradient jaxpr holds the flash
  forward's ``pallas_call`` twice under the policy, so B1 launching twice
  a layer on the card is the reference's behaviour too.
"""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_torch_train import SMALL, _assert_trees_close
from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JCfg
from torchbooster_tpu.ops import losses as jlosses
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.interop import params_from_jax, to_numpy
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
from torchbooster_tpu_torch.ops import losses

PRODUCTS = ("aten.mm.default", "aten.addmm.default", "aten.bmm.default")


class _Count(TorchDispatchMode):
    """Counts the aten ops that run under it."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _model():
    jcfg = JCfg(**SMALL)
    jp = JGPT.init(jax.random.PRNGKey(0), jcfg)
    cfg = GPTConfig(**SMALL)
    return jp, jcfg, params_from_jax(jax.device_get(jp), cfg, "cpu"), cfg


def _batch():
    rs = np.random.RandomState(11)
    return (rs.randint(0, 97, (2, 16)).astype(np.int32),
            rs.randint(0, 97, (2, 16)).astype(np.int32))


def _grads(tp, cfg, ids, labels, remat, impl):
    """Loss and gradients of the port's forward, and the products counted
    in the forward and in the backward."""
    params = utils._tree_map(lambda t: t.clone().requires_grad_(), tp)
    with _Count() as fwd:
        logits = GPT.apply(params, torch.as_tensor(ids).long(), cfg,
                           compute_dtype=torch.float32, remat=remat,
                           attn_impl=impl)
        loss = losses.cross_entropy(logits, torch.as_tensor(labels).long())
    with _Count() as bwd:
        loss.backward()
    return (loss, utils._tree_map(lambda t: t.grad, params),
            {k: fwd.ops[k] for k in PRODUCTS},
            {k: bwd.ops[k] for k in PRODUCTS})


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_remat_gradients_bit_equal_and_match_jax(impl):
    """Loss and every gradient bit for bit with and without remat (the
    saved products are the forward's own values; the rest recomputes the
    same fp32 ops); against JAX's ``remat=True`` gradients 1e-5 absolute,
    1e-4 relative, as the GPT gradient parity test."""
    jp, jcfg, tp, cfg = _model()
    ids, labels = _batch()
    on = _grads(tp, cfg, ids, labels, True, impl)
    off = _grads(tp, cfg, ids, labels, False, impl)
    assert torch.equal(on[0], off[0])
    for a, b in zip(utils.tree_leaves(on[1]), utils.tree_leaves(off[1]),
                    strict=True):
        assert torch.equal(a, b)

    def jloss(p):
        logits = JGPT.apply(p, jnp.asarray(ids), jcfg,
                            compute_dtype=jnp.float32, remat=True,
                            attn_impl="flash_interpret" if impl == "flash"
                            else "reference")
        return jlosses.cross_entropy(logits, jnp.asarray(labels))

    want, want_g = jax.value_and_grad(jloss)(jp)
    np.testing.assert_allclose(on[0].item(), float(want), rtol=1e-6)
    _assert_trees_close(to_numpy(on[1]), jax.device_get(want_g), atol=1e-5,
                        rtol=1e-4)


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_remat_saves_the_dense_products_and_recomputes_attention(impl):
    """The policy's proof by count: with remat the backward runs exactly
    as many ``mm``/``addmm`` as without (the block's dense products are
    saved, none is recomputed; a whole-block recompute would add the
    forward's 4 a layer), and the forward's attention ``bmm``s once more
    each (they have batch dims, so they are recomputed)."""
    _, _, tp, cfg = _model()
    ids, labels = _batch()
    _, _, fwd, bwd_on = _grads(tp, cfg, ids, labels, True, impl)
    _, _, fwd_off, bwd_off = _grads(tp, cfg, ids, labels, False, impl)
    assert fwd == fwd_off
    dense = fwd["aten.mm.default"] + fwd["aten.addmm.default"]
    # 4 dense products a layer and the tied head
    assert dense == 4 * cfg.n_layers + 1
    assert fwd["aten.bmm.default"] > 0
    for op in ("aten.mm.default", "aten.addmm.default"):
        assert bwd_on[op] == bwd_off[op]
    assert bwd_on["aten.bmm.default"] == (bwd_off["aten.bmm.default"]
                                          + fwd["aten.bmm.default"])


def _count_primitive(jaxpr, name: str) -> int:
    """Equations of primitive ``name`` in a jaxpr and every jaxpr nested
    in its equations' parameters (scan bodies, checkpoints, custom
    rules)."""
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == name
        for value in eqn.params.values():
            for sub in value if isinstance(value, (tuple, list)) else (value,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    n += _count_primitive(inner, name)
    return n


def test_jax_policy_recomputes_the_flash_forward_too():
    """Why B1 launches twice a layer under the port's policy: the JAX
    reference's ``dots_with_no_batch_dims_saveable`` saves only
    ``dot_general`` outputs, so its gradient recomputes the flash
    forward's ``pallas_call``. The scanned block body of ``jax.grad``
    holds 4 (forward, its recompute, dq, dkv) with ``remat=True`` and 3
    without."""
    jp, jcfg, _, _ = _model()
    ids, labels = _batch()

    def counts(remat):
        def jloss(p):
            logits = JGPT.apply(p, jnp.asarray(ids), jcfg,
                                compute_dtype=jnp.float32, remat=remat,
                                attn_impl="flash_interpret")
            return jlosses.cross_entropy(logits, jnp.asarray(labels))

        return _count_primitive(jax.make_jaxpr(jax.grad(jloss))(jp).jaxpr,
                                "pallas_call")

    assert (counts(True), counts(False)) == (4, 3)
