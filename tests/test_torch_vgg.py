"""Port parity: the VGG feature extractor (``models/vgg.py``) against the
JAX package on the CPU, inputs made once with numpy from a seed and fed
to both, fp32:

- VGG-19's taps at the style layers ``[1, 6, 11, 20]`` and VGG-16's final
  map from the same parameters (1e-4), the JAX suite's slot-numbering
  check (``tests/test_models.py:87``) and gradients through a tap
  (``:231``);
- ``load_torch_features`` from a plain ``nn.Sequential`` in torchvision's
  layout: equal to the JAX import leaf for leaf, and the imported
  extractor's final map equal to the Sequential's own forward
  (``tests/test_torch_import.py:114``);
- ``gram_matrix``, ``total_variation`` and ``normalize`` (1e-5);
- every image model's ``SHARDING_RULES`` giving JAX's spec on every leaf.
"""
import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from torchbooster_tpu.models import vgg as jvgg
from torchbooster_tpu_torch.interop import tensor_from_numpy, to_numpy
from torchbooster_tpu_torch.models import VGGFeatures, vgg

STYLE_LAYERS = [1, 6, 11, 20]


def _from_jax(tree):
    if isinstance(tree, dict):
        return {k: _from_jax(v) for k, v in tree.items()}
    return tensor_from_numpy(tree, "cpu")


def _torch_features(depth: int) -> nn.Sequential:
    mods, cin = [], 3
    for item in vgg._CFGS[depth]:
        if item == "M":
            mods.append(nn.MaxPool2d(2, 2))
        else:
            mods.append(nn.Conv2d(cin, item, 3, 1, 1))
            mods.append(nn.ReLU())
            cin = item
    return nn.Sequential(*mods)


@pytest.fixture(scope="module")
def vgg19():
    return jax.device_get(jvgg.VGGFeatures.init(jax.random.PRNGKey(0),
                                                depth=19))


def test_vgg19_style_taps_match_jax(vgg19):
    """Four taps of VGG-19 on a 2 × 32² batch: each 1e-4 relative plus
    1e-4 of its largest entry (up to 9 layers of fp32 conv sums in
    another order)."""
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    want = jvgg.VGGFeatures.apply(vgg19, jnp.asarray(x), taps=STYLE_LAYERS)
    got = VGGFeatures.apply(_from_jax(vgg19), torch.as_tensor(x),
                            taps=STYLE_LAYERS)
    assert len(got) == len(want) == 4
    for tap, g, w in zip(STYLE_LAYERS, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, tap
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"tap {tap}")


def test_vgg_slot_numbering_and_grads():
    """JAX ``test_vgg_taps_match_torchvision_indexing`` and
    ``test_vgg_usable_under_jit_and_grad`` on the port's own VGG-16: the
    taps' channels and sizes follow torchvision's slot numbers, the
    depth is read back from the tree, and an image gradient through a
    tap is finite and non-zero."""
    params = VGGFeatures.init(0, depth=16, device="cpu")
    assert VGGFeatures._depth_of(params) == 16
    taps = VGGFeatures.apply(params, torch.zeros(1, 64, 64, 3),
                             taps=[1, 6, 11])
    assert [t.shape[-1] for t in taps] == [64, 128, 256]
    assert taps[0].shape[1] == 64 and taps[1].shape[1] == 32
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(1),
                   requires_grad=True)
    VGGFeatures.apply(params, x, taps=[1, 6])[0].sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="unrecognized VGG"):
        VGGFeatures._depth_of({"conv0": params["conv0"]})


def test_load_torch_features_matches_jax_and_torch():
    """A VGG-16 ``nn.Sequential`` with random weights: the port's import
    equals JAX's byte for byte, and the imported extractor's final map
    equals the Sequential's forward (1e-4; the JAX suite's 1e-3)."""
    torch.manual_seed(2)
    features = _torch_features(16)
    jparams = jvgg.load_torch_features(
        jvgg.VGGFeatures.init(jax.random.PRNGKey(0), depth=16),
        features=features)
    params = vgg.load_torch_features(VGGFeatures.init(0, 16, device="cpu"),
                                     features=features)
    got = to_numpy(params)
    assert got.keys() == jparams.keys()
    for key, leaf in jparams.items():
        for name in ("kernel", "bias"):
            want = np.asarray(leaf[name])
            assert got[key][name].tobytes() == want.tobytes(), (key, name)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = features(x).permute(0, 2, 3, 1).numpy()
        out = VGGFeatures.apply(params, x.permute(0, 2, 3, 1).contiguous())
    np.testing.assert_allclose(out[-1].numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_gram_total_variation_and_normalize_match_jax():
    rs = np.random.RandomState(4)
    feats = rs.randn(2, 5, 6, 7).astype(np.float32)
    img = rs.rand(2, 9, 8, 3).astype(np.float32)
    cases = ((vgg.gram_matrix, jvgg.gram_matrix, feats),
             (vgg.total_variation, jvgg.total_variation, img),
             (VGGFeatures.normalize, jvgg.VGGFeatures.normalize, img))
    for fn, jfn, a in cases:
        got = fn(torch.as_tensor(a))
        want = np.asarray(jfn(jnp.asarray(a)))
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=fn.__name__)
    assert np.array_equal(vgg.IMAGENET_MEAN, jvgg.IMAGENET_MEAN)
    assert np.array_equal(vgg.IMAGENET_STD, jvgg.IMAGENET_STD)


def _spec_tree(specs):
    if isinstance(specs, dict):
        return {k: _spec_tree(v) for k, v in specs.items()}
    return tuple(specs)


@pytest.mark.parametrize("name", ["ResNet", "LeNet", "VGGFeatures"])
def test_sharding_rules_give_jax_specs(name):
    """``make_param_specs`` over each image model's rule table gives, on
    every leaf, the ``PartitionSpec`` JAX's rules give (unfiltered, as
    written)."""
    from torchbooster_tpu import models as jmodels
    from torchbooster_tpu.parallel.sharding import (
        make_param_specs as jspecs,
    )
    from torchbooster_tpu_torch import models
    from torchbooster_tpu_torch.parallel import make_param_specs

    jmodel, model = getattr(jmodels, name), getattr(models, name)
    if name == "ResNet":
        jp = jmodel.init(jax.random.PRNGKey(0), depth=18, num_classes=10)
        p = model.init(0, 18, 10, device="cpu")
    elif name == "LeNet":
        jp, p = jmodel.init(jax.random.PRNGKey(0)), model.init(0, device="cpu")
    else:
        jp = jmodel.init(jax.random.PRNGKey(0), depth=16)
        p = model.init(0, 16, device="cpu")
    want = _spec_tree(jax.tree.map(tuple, jspecs(jp, jmodel.SHARDING_RULES),
                                   is_leaf=lambda s: isinstance(
                                       s, jax.sharding.PartitionSpec)))
    got = _spec_tree(make_param_specs(p, model.SHARDING_RULES))
    assert got == want
