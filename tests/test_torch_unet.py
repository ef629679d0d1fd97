"""Port parity: the UNet (``models/unet.py``) and its weights' converter
(``interop.unet_params_from_jax``) against the JAX package on the CPU,
inputs made once with numpy from a seed, fp32.

- ``time_embedding`` at t up to 999 (1e-4: XLA's and torch's ``exp`` may
  give a frequency one ulp apart, and an fp32 angle near 1000 carries an
  ulp of 6e-5, which sin and cos pass on);
- the port's init has JAX's tree and shapes, with and without classes;
- forward (1e-5 of the largest entry) and every parameter gradient (1e-4
  of the leaf's largest entry) at ``base 16, mults (1, 2), time_dim 32``,
  16², batch 2, with and without classes (JAX ``tests/test_models.py:979``,
  ``:1021``), and the NULL class for ``labels=None``;
- the nearest ×2 upsample equal to ``jax.image.resize`` on a
  non-symmetric input;
- the GroupNorm calls of a forward, by shape and dtype, equal JAX's, at
  fp32 and with bf16 images and weights (only the first sees bf16), and
  29 calls at ``ddpm.yml``'s widths;
- the converter reads the config from the tree and refuses a tree that
  does not match;
- ``SHARDING_RULES`` giving JAX's spec on every leaf. The placement on a
  gloo pool is in ``tests/test_torch_image_ranks.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models import unet as junet
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.interop import (
    _unet_config,
    to_numpy,
    unet_params_from_jax,
)
from torchbooster_tpu_torch.models import layers as L
from torchbooster_tpu_torch.models import unet
from torchbooster_tpu_torch.models.unet import UNet, UNetConfig

SMALL = dict(in_channels=1, base=16, mults=(1, 2), time_dim=32)

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test processes, OpenMP's
    barriers would otherwise stall on busy cores (a UNet epoch took 35x
    its time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


@pytest.fixture(scope="module", params=[0, 4], ids=["uncond", "classes"])
def model(request):
    jcfg = junet.UNetConfig(**SMALL, n_classes=request.param)
    jp = jax.device_get(junet.UNet.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, UNetConfig(**SMALL, n_classes=request.param)


def test_time_embedding_matches_jax():
    t = np.array([0, 1, 3, 77, 500, 999])
    for dim in (32, 256):
        want = np.asarray(junet.time_embedding(jnp.asarray(t), dim))
        got = unet.time_embedding(torch.as_tensor(t), dim)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_init_has_jax_tree_and_shapes(model):
    jcfg, jp, cfg = model
    got = {p: v.shape for p, v in _leaves(to_numpy(UNet.init(
        0, cfg, device="cpu")))}
    assert got == {p: v.shape for p, v in _leaves(jp)}
    assert _unet_config(jp) == cfg
    if cfg.n_classes:
        assert jp["label_emb"]["table"].shape[0] == cfg.n_classes + 1
    with pytest.raises(ValueError, match="even"):
        UNet.init(0, UNetConfig(time_dim=31), device="cpu")


def test_forward_and_grads_match_jax(model):
    """Forward and the gradient of every leaf of a squared-output loss
    from the same weights, labels where the model has classes."""
    jcfg, jp, cfg = model
    rs = np.random.RandomState(1)
    x = rs.randn(2, 16, 16, 1).astype(np.float32)
    t = np.array([3, 77])
    y = np.array([0, 3]) if cfg.n_classes else None

    def jloss(p):
        out = junet.UNet.apply(p, jnp.asarray(x), jnp.asarray(t), jcfg,
                               labels=None if y is None else jnp.asarray(y))
        return (out ** 2).sum(), out

    # jitted: one compile is cheaper than the eager op-by-op gradient
    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    params = unet_params_from_jax(jp, "cpu")
    for p in utils.tree_leaves(params):
        p.requires_grad_(True)
    got = UNet.apply(params, torch.as_tensor(x), torch.as_tensor(t), cfg,
                     labels=None if y is None else torch.as_tensor(y))
    (got ** 2).sum().backward()
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= \
        1e-5 * np.abs(want).max()
    grads = dict(_leaves(to_numpy(utils._tree_map(lambda q: q.grad,
                                                  params))))
    for path, w in _leaves(jax.device_get(want_g)):
        np.testing.assert_allclose(grads[path], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=str(path))
    if cfg.n_classes:
        # labels=None is the NULL class on both sides
        null = UNet.apply(params, torch.as_tensor(x), torch.as_tensor(t),
                          cfg).detach().numpy()
        jnull = np.asarray(junet.UNet.apply(jp, jnp.asarray(x),
                                            jnp.asarray(t), jcfg))
        assert np.abs(null - jnull).max() <= 1e-5 * np.abs(jnull).max()


def test_upsample_equals_jax_nearest_resize():
    x = np.arange(2 * 3 * 5 * 2, dtype=np.float32).reshape(2, 3, 5, 2)
    want = jax.image.resize(jnp.asarray(x), (2, 6, 10, 2), "nearest")
    got = unet.upsample2(torch.as_tensor(x))
    assert np.array_equal(got.numpy(), np.asarray(want))


def _spy(monkeypatch, module, seen):
    """Record each ``module.group_norm`` call's ``(H·W, C, dtype)``."""
    real = module.group_norm

    def spy(params, x, *args, **kwargs):
        seen.append((x.shape[1] * x.shape[2], x.shape[-1], str(x.dtype)))
        return real(params, x, *args, **kwargs)

    monkeypatch.setattr(module, "group_norm", spy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_group_norms_match_jax(monkeypatch, dtype):
    """Spies on both packages' ``layers.group_norm`` record each call's
    ``(H·W, C, dtype)`` in a forward of the small UNet with classes, from
    images and weights of ``dtype``: the port's calls equal JAX's, in
    order. Only the first call sees bf16: the fp32 time projection
    promotes the rest, in torch as in JAX. At ``ddpm.yml``'s widths and
    28² a forward makes 29 calls over seven shapes."""
    from torchbooster_tpu.models import layers as JL

    cfg = UNetConfig(**SMALL, n_classes=3)
    jcfg = junet.UNetConfig(**SMALL, n_classes=3)
    seen, jseen = [], []
    _spy(monkeypatch, L, seen)
    _spy(monkeypatch, JL, jseen)
    dt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    params = utils._cast_batch(UNet.init(0, cfg, device="cpu"), dt)
    UNet.apply(params, torch.zeros(2, 16, 16, 1, dtype=dt),
               torch.tensor([1, 2]), cfg, labels=torch.tensor([0, 2]))
    jp = jax.tree.map(lambda a: a.astype(jdt),
                      junet.UNet.init(jax.random.PRNGKey(0), jcfg))
    junet.UNet.apply(jp, jnp.zeros((2, 16, 16, 1), jdt), jnp.array([1, 2]),
                     jcfg, labels=jnp.array([0, 2]))
    assert [c[:2] for c in seen] == [c[:2] for c in jseen]
    assert [c[2].split(".")[-1] for c in seen] == [c[2] for c in jseen]
    assert [c[2] for c in seen].count("torch.bfloat16") == \
        (1 if dtype == "bfloat16" else 0)
    seen.clear()
    UNet.apply(UNet.init(0, device="cpu"), torch.zeros(1, 28, 28, 1),
               torch.tensor([0]))
    assert len(seen) == 29
    assert sorted({(hw, c) for hw, c, _ in seen}) == [
        (49, 128), (49, 256), (196, 64), (196, 128), (196, 256), (784, 64),
        (784, 128)]


def test_converter_refuses_a_tree_that_does_not_match(model):
    jcfg, jp, cfg = model
    params = unet_params_from_jax(jp, "cpu")
    assert all(a.tobytes() == b.tobytes() for (_, a), (_, b) in zip(
        _leaves(to_numpy(params)), _leaves(jp)))
    cut = {k: v for k, v in jp.items() if k != "mid_b"}
    with pytest.raises(ValueError, match="does not match"):
        unet_params_from_jax(cut, "cpu")
    bent = dict(jp, out_conv={"kernel": jp["out_conv"]["kernel"][:, :, :8],
                              "bias": jp["out_conv"]["bias"]})
    with pytest.raises(ValueError, match="does not match"):
        unet_params_from_jax(bent, "cpu")
    with pytest.raises(ValueError, match="not a UNet"):
        unet_params_from_jax({"stem": jp["stem"]}, "cpu")


def test_sharding_rules_give_jax_specs():
    """``make_param_specs`` over ``UNet.SHARDING_RULES`` gives, on every
    leaf, the ``PartitionSpec`` JAX's rules give (unfiltered)."""
    from torchbooster_tpu.parallel.sharding import (
        make_param_specs as jspecs,
    )
    from torchbooster_tpu_torch.parallel import make_param_specs

    jcfg = junet.UNetConfig(**SMALL, n_classes=4)
    jp = junet.UNet.init(jax.random.PRNGKey(0), jcfg)
    want = dict(_spec_leaves(jax.tree.map(
        tuple, jspecs(jp, junet.SHARDING_RULES),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))))
    got = dict(_spec_leaves(make_param_specs(
        UNet.init(0, UNetConfig(**SMALL, n_classes=4), device="cpu"),
        UNet.SHARDING_RULES)))
    assert got == want
    assert got[("stem", "kernel")] == (None, None, None, "fsdp")
    assert got[("time_mlp1", "kernel")] == ("fsdp", None)


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], path + (k,))
    else:
        yield path, tuple(tree)
