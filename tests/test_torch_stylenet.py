"""Port parity: StyleNet, the AdaIN decoder and the AdaIN op
(``models/stylenet.py``) against the JAX package on the CPU, inputs made
once with numpy from a seed and fed to both, fp32.

- reflection padding equal to ``jnp.pad(mode="reflect")`` (no edge
  repeated) on a non-symmetric input;
- ``mu_std`` (population variance) and ``adain`` (1e-5), and JAX's
  statistics check (``tests/test_models.py:104``) on the port;
- StyleNet on 2 × 32² images: the port's init has JAX's tree, the output
  within 1e-4 of its largest entry (17 conv + instance-norm layers of
  fp32 sums in another order) and every gradient within 1e-4 of the
  leaf's largest entry, but the biases of the convs an instance norm
  follows: the norm takes any per-channel constant out, so their exact
  gradient is 0 and both sides hold fp32 noise there, held within 1e-6
  of the model's largest gradient entry; the shape kept (JAX ``:97``);
- the AdaIN decoder from 4² × 512 features to 32² RGB (8× up, JAX
  ``:116``), output within 1e-4 of its largest entry;
- the checked converters, and both rule tables giving JAX's specs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models import stylenet as jsn
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.interop import (
    adain_decoder_params_from_jax,
    stylenet_params_from_jax,
    to_numpy,
)
from torchbooster_tpu_torch.models import stylenet as sn

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


def _close_of_max(got, want, tol, what=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), what


@pytest.fixture(scope="module")
def stylenet():
    return jax.device_get(jsn.StyleNet.init(jax.random.PRNGKey(0)))


def test_reflect_pad_mu_std_and_adain_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 7, 3).astype(np.float32)
    assert np.array_equal(sn._reflect_pad(torch.as_tensor(x), 2).numpy(),
                          np.asarray(jsn._reflect_pad(jnp.asarray(x), 2)))
    c = (rs.randn(2, 8, 8, 4) * 3.0 + 1.0).astype(np.float32)
    s = (rs.randn(2, 8, 8, 4) * 0.5 - 2.0).astype(np.float32)
    for got, want in zip(sn.mu_std(torch.as_tensor(c)),
                         jsn.mu_std(jnp.asarray(c))):
        _close_of_max(got, want, 1e-5)
    _close_of_max(sn.adain(torch.as_tensor(s), torch.as_tensor(c)),
                  jsn.adain(jnp.asarray(s), jnp.asarray(c)), 1e-5)
    # JAX test_adain_transfers_statistics on the port
    out = sn.adain(torch.as_tensor(s), torch.as_tensor(c))
    (s_mu, s_std), (o_mu, o_std) = sn.mu_std(torch.as_tensor(s)), \
        sn.mu_std(out)
    np.testing.assert_allclose(o_mu.numpy(), s_mu.numpy(), atol=1e-4)
    np.testing.assert_allclose(o_std.numpy(), s_std.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_stylenet_matches_jax(stylenet):
    jp = stylenet
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    assert {p: v.shape for p, v in _leaves(to_numpy(sn.StyleNet.init(
        0, device="cpu")))} == {p: v.shape for p, v in _leaves(jp)}

    def jloss(p):
        out = jsn.StyleNet.apply(p, jnp.asarray(x))
        return (out ** 2).mean(), out

    # jitted: one compile is cheaper than the eager op-by-op gradient
    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    params = stylenet_params_from_jax(jp, "cpu")
    for p in utils.tree_leaves(params):
        p.requires_grad_(True)
    got = sn.StyleNet.apply(params, torch.as_tensor(x))
    assert got.shape == x.shape
    _close_of_max(got, want, 1e-4, "output")
    (got ** 2).mean().backward()
    grads = dict(_leaves(to_numpy(utils._tree_map(lambda q: q.grad,
                                                  params))))
    want_g = dict(_leaves(jax.device_get(want_g)))
    top = max(np.abs(w).max() for w in want_g.values())
    for path, w in want_g.items():
        if path[-2:] == ("conv", "bias"):
            assert np.abs(grads[path]).max() <= 1e-6 * top, path
            continue
        np.testing.assert_allclose(grads[path], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=str(path))


def test_adain_decoder_matches_jax_and_upsamples_8x():
    jp = jax.device_get(jsn.AdaINDecoder.init(jax.random.PRNGKey(1)))
    feat = np.random.RandomState(2).rand(1, 4, 4, 512).astype(np.float32)
    params = adain_decoder_params_from_jax(jp, "cpu")
    got = sn.AdaINDecoder.apply(params, torch.as_tensor(feat))
    assert got.shape == (1, 32, 32, 3)
    _close_of_max(got, jsn.AdaINDecoder.apply(jp, jnp.asarray(feat)), 1e-4)
    assert {p: v.shape for p, v in _leaves(to_numpy(sn.AdaINDecoder.init(
        0, device="cpu")))} == {p: v.shape for p, v in _leaves(jp)}


def test_converters_refuse_trees_that_do_not_match(stylenet):
    cut = dict(stylenet)
    cut.pop("res4")
    with pytest.raises(ValueError, match="does not match"):
        stylenet_params_from_jax(cut, "cpu")
    with pytest.raises(ValueError, match="does not match"):
        adain_decoder_params_from_jax(stylenet, "cpu")


@pytest.mark.parametrize("name", ["StyleNet", "AdaINDecoder"])
def test_sharding_rules_give_jax_specs(name):
    from torchbooster_tpu.parallel.sharding import (
        make_param_specs as jspecs,
    )
    from torchbooster_tpu_torch.parallel import make_param_specs

    jmodel, model = getattr(jsn, name), getattr(sn, name)
    want = {k: tuple(v) for k, v in _leaves(jax.tree.map(
        tuple, jspecs(jmodel.init(jax.random.PRNGKey(0)),
                      jmodel.SHARDING_RULES),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))}
    got = {k: tuple(v) for k, v in _leaves(make_param_specs(
        model.init(0, device="cpu"), model.SHARDING_RULES))}
    assert got == want
