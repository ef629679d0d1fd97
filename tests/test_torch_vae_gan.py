"""Port parity: the VAE (``models/vae.py``) and the GAN
(``models/gan.py``) against the JAX package on the CPU, inputs made once
with numpy from a seed and fed to both, fp32.

- VAE: the port's init has JAX's tree; ``encode``, ``decode`` and
  ``apply(train=False)`` (1e-5 of the largest entry); the
  reparameterization at JAX's own ε (``jax.random.normal`` of the key
  ``apply`` gets) through ``_reparameterize``; ``kl_divergence``; every
  gradient of the recipe's loss (1e-4 of the leaf's largest entry); JAX
  ``tests/test_models.py:57`` on the port's init; ``apply(train=True)``
  equal to the core fed its generator's draw;
- GAN: the port's init has JAX's tree; ``generate``, ``discriminate``,
  the hinge losses (1e-5); the gradient penalty at JAX's own α (1e-5
  relative) and its gradient with respect to D's parameters against
  ``jax.grad`` of JAX's ``grad_penalty`` (the double backward; 1e-4 of
  the leaf's largest entry); JAX ``tests/test_models.py:67`` on the
  port's init;
- the checked converters, and each model's ``SHARDING_RULES`` giving
  JAX's spec on every leaf.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models import gan as jgan
from torchbooster_tpu.models import vae as jvae
from torchbooster_tpu.ops.losses import bce_with_logits as jbce
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.interop import (
    gan_params_from_jax,
    to_numpy,
    vae_params_from_jax,
)
from torchbooster_tpu_torch.models import GAN, VAE
from torchbooster_tpu_torch.models import gan, vae
from torchbooster_tpu_torch.ops.losses import bce_with_logits

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
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), what


def _grads_close(params, want_g):
    """Each leaf's gradient within 1e-4 of the leaf's largest entry of
    JAX's; a leaf autograd never reached (D's output bias under the
    penalty alone: ∇_t D does not depend on it) has JAX's zeros."""
    grads = dict(_leaves(to_numpy(utils._tree_map(
        lambda q: torch.zeros_like(q) if q.grad is None else q.grad,
        params))))
    for path, w in _leaves(jax.device_get(want_g)):
        np.testing.assert_allclose(grads[path], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=str(path))


@pytest.fixture(scope="module")
def vae_params():
    return jax.device_get(jvae.VAE.init(jax.random.PRNGKey(0), z_dim=8))


@pytest.fixture(scope="module")
def gan_params():
    return jax.device_get(jgan.GAN.init(jax.random.PRNGKey(0), z_dim=16))


def test_vae_matches_jax(vae_params):
    jp = vae_params
    rs = np.random.RandomState(1)
    x = rs.rand(4, 28, 28, 1).astype(np.float32)
    z = rs.randn(4, 8).astype(np.float32)
    params = vae_params_from_jax(jp, "cpu")
    assert {p: v.shape for p, v in _leaves(to_numpy(VAE.init(
        0, 8, device="cpu")))} == {p: v.shape for p, v in _leaves(jp)}
    mu, log_var = VAE.encode(params, torch.as_tensor(x))
    jmu, jlv = jvae.VAE.encode(jp, jnp.asarray(x))
    _close_of_max(mu, jmu, 1e-5, "mu")
    _close_of_max(log_var, jlv, 1e-5, "log_var")
    _close_of_max(VAE.decode(params, torch.as_tensor(z)),
                  jvae.VAE.decode(jp, jnp.asarray(z)), 1e-5, "decode")
    rng = jax.random.PRNGKey(2)
    jrec, jmu, jlv = jvae.VAE.apply(jp, jnp.asarray(x), rng, train=True)
    eps = np.asarray(jax.random.normal(rng, jlv.shape, jlv.dtype))
    rec = VAE.decode(params, vae._reparameterize(mu, log_var,
                                                 torch.as_tensor(eps)))
    _close_of_max(rec, jrec, 1e-5, "reparameterized")
    jrec0, _, _ = jvae.VAE.apply(jp, jnp.asarray(x), rng, train=False)
    rec0, _, _ = VAE.apply(params, torch.as_tensor(x), None, train=False)
    _close_of_max(rec0, jrec0, 1e-5, "train=False")
    np.testing.assert_allclose(
        vae.kl_divergence(mu, log_var).item(),
        float(jvae.kl_divergence(jmu, jlv)), rtol=1e-5)

    def jloss(p):
        rec, m, lv = jvae.VAE.apply(p, jnp.asarray(x), rng, train=False)
        return jbce(rec, jnp.asarray(x)) * 784 + jvae.kl_divergence(m, lv)

    want_g = jax.grad(jloss)(jp)
    for p in utils.tree_leaves(params):
        p.requires_grad_(True)
    rec, m, lv = VAE.apply(params, torch.as_tensor(x), None, train=False)
    (bce_with_logits(rec, torch.as_tensor(x)) * 784
     + vae.kl_divergence(m, lv)).backward()
    _grads_close(params, want_g)


def test_vae_roundtrip_and_generator_draw():
    """JAX ``test_vae_roundtrip`` on the port's init; ``train=True``
    decodes μ + exp(½·log σ²)·ε with ε its generator's next draw."""
    params = VAE.init(0, z_dim=8, device="cpu")
    x = torch.rand(4, 28, 28, 1, generator=torch.Generator().manual_seed(1))
    recon, mu, log_var = VAE.apply(params, x,
                                   torch.Generator().manual_seed(2))
    assert recon.shape == x.shape and mu.shape == (4, 8)
    kld = vae.kl_divergence(mu, log_var)
    assert kld.shape == () and torch.isfinite(kld)
    eps = torch.randn((4, 8), generator=torch.Generator().manual_seed(2))
    want = VAE.decode(params, vae._reparameterize(mu, log_var, eps))
    assert torch.equal(recon, want)


def test_gan_matches_jax_penalty_double_backward(gan_params):
    jp = gan_params
    rs = np.random.RandomState(1)
    z = rs.randn(4, 16).astype(np.float32)
    x_real = rs.rand(4, 28, 28, 1).astype(np.float32)
    params = gan_params_from_jax(jp, "cpu")
    assert {p: v.shape for p, v in _leaves(to_numpy(GAN.init(
        0, 16, device="cpu")))} == {p: v.shape for p, v in _leaves(jp)}
    x_fake = GAN.generate(params["G"], torch.as_tensor(z))
    jfake = jgan.GAN.generate(jp["G"], jnp.asarray(z))
    _close_of_max(x_fake, jfake, 1e-5, "generate")
    _close_of_max(GAN.discriminate(params["D"], torch.as_tensor(x_real)),
                  jgan.GAN.discriminate(jp["D"], jnp.asarray(x_real)), 1e-5,
                  "discriminate")
    xf = x_fake.detach()
    np.testing.assert_allclose(
        gan.hinge_g_loss(params["D"], xf).item(),
        float(jgan.hinge_g_loss(jp["D"], jfake)), rtol=1e-5)
    np.testing.assert_allclose(
        gan.hinge_d_loss(params["D"], torch.as_tensor(x_real), xf).item(),
        float(jgan.hinge_d_loss(jp["D"], jnp.asarray(x_real), jfake)),
        rtol=1e-5)
    rng = jax.random.PRNGKey(3)
    alpha = np.asarray(jax.random.uniform(rng, (4, 1, 1, 1), jnp.float32))

    def jgp(d):
        return jgan.grad_penalty(d, jnp.asarray(x_real), jfake, rng)

    jval, want_g = jax.value_and_grad(jgp)(jp["D"])
    for p in utils.tree_leaves(params["D"]):
        p.requires_grad_(True)
    gp = gan._grad_penalty_core(params["D"], torch.as_tensor(x_real), xf,
                                torch.as_tensor(alpha))
    np.testing.assert_allclose(gp.item(), float(jval), rtol=1e-5)
    gp.backward()
    _grads_close(params["D"], want_g)


def test_gan_losses_and_penalty_on_the_ports_init():
    """JAX ``test_gan_losses_and_penalty``: finite losses and penalty, a
    finite, non-zero gradient of the penalty with respect to D; the
    public penalty equals the core at its generator's α."""
    params = GAN.init(0, z_dim=16, device="cpu")
    gen = torch.Generator().manual_seed(1)
    x_fake = GAN.generate(params["G"], torch.randn(4, 16, generator=gen))
    x_real = torch.rand(4, 28, 28, 1, generator=gen)
    for p in utils.tree_leaves(params["D"]):
        p.requires_grad_(True)
    g = gan.hinge_g_loss(params["D"], x_fake)
    d = gan.hinge_d_loss(params["D"], x_real, x_fake.detach())
    gp = gan.grad_penalty(params["D"], x_real, x_fake.detach(),
                          torch.Generator().manual_seed(3))
    assert all(torch.isfinite(v) for v in (g, d, gp))
    alpha = torch.rand((4, 1, 1, 1), generator=torch.Generator()
                       .manual_seed(3))
    assert gp.item() == gan._grad_penalty_core(
        params["D"], x_real, x_fake.detach(), alpha).item()
    gp.backward()
    total = sum(p.grad.abs().sum() for p in utils.tree_leaves(params["D"])
                if p.grad is not None)
    assert torch.isfinite(total) and total > 0


def test_converters_refuse_trees_that_do_not_match(vae_params, gan_params):
    for fn, jp, what in ((vae_params_from_jax, vae_params, "VAE"),
                         (gan_params_from_jax, gan_params, "GAN")):
        out = fn(jp, "cpu")
        assert all(a.tobytes() == b.tobytes() for (_, a), (_, b) in zip(
            _leaves(to_numpy(out)), _leaves(jp)))
        with pytest.raises(ValueError, match=f"not a {what}"):
            fn({"x": 1}, "cpu")
    cut = dict(vae_params)
    cut.pop("dec2")
    with pytest.raises(ValueError, match="does not match"):
        vae_params_from_jax(cut, "cpu")
    bent = {"G": gan_params["G"], "D": dict(gan_params["D"], out={
        "kernel": np.zeros((512, 2), np.float32),
        "bias": np.zeros(2, np.float32)})}
    with pytest.raises(ValueError, match="does not match"):
        gan_params_from_jax(bent, "cpu")


@pytest.mark.parametrize("name", ["VAE", "GAN"])
def test_sharding_rules_give_jax_specs(name):
    from torchbooster_tpu import models as jmodels
    from torchbooster_tpu.parallel.sharding import (
        make_param_specs as jspecs,
    )
    from torchbooster_tpu_torch import models
    from torchbooster_tpu_torch.parallel import make_param_specs

    jmodel, model = getattr(jmodels, name), getattr(models, name)
    want = dict(_leaves(jax.tree.map(
        tuple, jspecs(jmodel.init(jax.random.PRNGKey(0)),
                      jmodel.SHARDING_RULES),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))))
    want = {k: tuple(v) for k, v in want.items()}
    got = {k: tuple(v) for k, v in _leaves(make_param_specs(
        model.init(0, device="cpu"), model.SHARDING_RULES))}
    assert got == want
