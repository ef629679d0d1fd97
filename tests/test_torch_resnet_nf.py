"""Port parity: ResNet's norm-free variant (``norm="ws"``) and its
space-to-depth stem (``stem_s2d``) against the JAX package on the CPU,
from the same parameters (the port's init, carried to JAX as numpy), in
fp32, each tolerance stated where it is used:

- NF-ResNet at depths 18 and 50 and its signal scale (JAX
  ``tests/test_models.py:550``, ``:577``);
- the space-to-depth stem against the plain stem and against JAX's
  (``:605``), under both norms.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models.resnet import ResNet as JResNet
from torchbooster_tpu_torch.interop import to_numpy
from torchbooster_tpu_torch.models import layers as L
from torchbooster_tpu_torch.models.resnet import ResNet
from torchbooster_tpu_torch.ops import fused_block as fb
from torchbooster_tpu_torch.ops import group_norm as gn


@pytest.mark.parametrize("depth", [18, 50])
def test_nf_resnet_matches_jax_and_keeps_its_signal(depth):
    """NF-ResNet (``norm="ws"``, ImageNet stem) at 2 × 32² from the same
    parameters (the port's init, carried to JAX as numpy): logits 1e-4
    relative plus 1e-4 of the largest, and no kernel counter moves; the
    pre-head features keep an O(1) scale through the four stages (JAX
    ``test_nf_resnet_forward_and_signal_propagation``: std in (0.1, 10)
    with an identity head, at 2 × 64²)."""
    params = ResNet.init(depth, depth, 10, "imagenet", device="cpu")
    x = np.random.RandomState(depth).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(JResNet.apply(
        jax.tree.map(jnp.asarray, to_numpy(params)), jnp.asarray(x),
        norm="ws"))
    before = (gn.launches_fwd, fb.launches_1x1, fb.launches_3x3)
    got = ResNet.apply(params, torch.as_tensor(x), norm="ws").numpy()
    assert (gn.launches_fwd, fb.launches_1x1, fb.launches_3x3) == before
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    width = params["head"]["kernel"].shape[0]
    params["head"] = {"kernel": torch.eye(width), "bias": torch.zeros(width)}
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    feats = ResNet.nf_apply(params, x)
    assert torch.isfinite(feats).all()
    assert 0.1 < feats.std().item() < 10.0


@pytest.mark.parametrize("norm", ["ws", "group"])
def test_stem_s2d_matches_the_plain_stem_and_jax(norm):
    """The space-to-depth stem against the plain 7×7/s2 stem (2e-4, JAX
    ``test_nf_resnet_s2d_stem_matches_plain``'s bound) and against JAX's
    s2d model from the same parameters (1e-4); the repack alone against
    the strided conv and JAX's repack (1e-5)."""
    from torchbooster_tpu.models.resnet import _stem_s2d as jstem
    from torchbooster_tpu_torch.models.resnet import _stem_s2d

    params = ResNet.init(2, 18, 10, "imagenet", device="cpu")
    jp = jax.tree.map(jnp.asarray, to_numpy(params))
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    plain = ResNet.apply(params, torch.as_tensor(x), norm=norm)
    s2d = ResNet.apply(params, torch.as_tensor(x), norm=norm, stem_s2d=True)
    np.testing.assert_allclose(s2d.numpy(), plain.numpy(), rtol=2e-4,
                               atol=2e-4)
    want = np.asarray(JResNet.apply(jp, jnp.asarray(x), norm=norm,
                                    stem_s2d=True))
    np.testing.assert_allclose(s2d.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    k = params["stem"]["conv"]["kernel"]
    got = _stem_s2d(k, torch.as_tensor(x))
    ref = L.conv({"kernel": k}, torch.as_tensor(x), stride=2, padding=3)
    scale = ref.abs().max().item()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jstem(jnp.asarray(k.numpy()),
                                      jnp.asarray(x))),
        rtol=1e-5, atol=1e-5 * scale)
