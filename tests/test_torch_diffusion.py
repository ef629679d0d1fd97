"""Port parity: the DDPM machinery (``ops/diffusion.py``) against the JAX
package's ``torchbooster_tpu/ops/diffusion.py`` on the CPU.

- the linear and cosine tables at T 10, 100 and 1000: within 1e-6 (fp32
  ``cumprod`` and ``cos`` in another order; the tables lie in [0, 1]);
- DDIM's rounded step table equal to JAX's at (T, steps) = (1000, 50),
  (24, 6) and (50, 5), the last with a ``.5`` that rounds to even;
- ``q_sample`` (1e-6), and the JAX suite's invariants
  (``tests/test_models.py:952``, ``:998``, ``:1051``) on the port;
- the loss and both samplers' chains through the private cores, fed the
  draws JAX makes from its own key (``jax.random.split`` as in JAX
  ``ops/diffusion.py:77``, ``:114``, ``:139``), with a stand-in denoiser
  and with the small UNet: the loss within 1e-5 relative, a chain within
  1e-5 (stand-in) or 1e-4 (UNet, 24 steps of fp32 rounding carried
  through the chain) of its largest entry;
- the public functions' draw order: each equals its core fed the draws
  that an identically seeded generator makes in the documented order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu.models.unet import UNet as JUNet
from torchbooster_tpu.models.unet import UNetConfig as JUNetConfig
from torchbooster_tpu.ops import diffusion as jd
from torchbooster_tpu_torch.interop import unet_params_from_jax
from torchbooster_tpu_torch.models.unet import UNet, UNetConfig
from torchbooster_tpu_torch.ops import diffusion as td

SMALL = dict(in_channels=1, base=16, mults=(1, 2), time_dim=32)
SHAPE = (2, 16, 16, 1)

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test processes, OpenMP's
    barriers would otherwise stall on busy cores (a UNet epoch took 35x
    its time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.mark.parametrize("T", [10, 100, 1000])
@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_schedule_tables_match_jax(name, T):
    want = jd.make_schedule(name, T)
    got = td.make_schedule(name, T)
    assert got.T == T
    for field, w, g in zip(want._fields, want, got):
        assert g.dtype == torch.float32, field
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6, err_msg=f"{name} {field}")


@pytest.mark.parametrize("T,steps", [(1000, 50), (24, 6), (50, 5)])
def test_ddim_step_table_equals_jax(T, steps):
    want = jnp.linspace(T - 1, 0, steps).round().astype(jnp.int32)
    assert td._ddim_ts(T, steps) == np.asarray(want).tolist()


def test_q_sample_and_schedule_invariants():
    """JAX ``test_diffusion_schedule_invariants`` on the port, and
    ``q_sample`` against JAX's on the same inputs."""
    for name in ("linear", "cosine"):
        sched = td.make_schedule(name, 100)
        ab = sched.alpha_bars.numpy()
        assert (np.diff(ab) < 0).all(), name
        assert 0 < ab[-1] < ab[0] <= 1.0, name
        assert torch.allclose(sched.alphas, 1.0 - sched.betas)
    sched = td.make_schedule("cosine", 100)
    rs = np.random.RandomState(0)
    x0 = np.ones((2, 8, 8, 1), np.float32)
    noise = rs.randn(*x0.shape).astype(np.float32)
    early = td.q_sample(torch.as_tensor(x0), torch.zeros(2, dtype=torch.long),
                        torch.as_tensor(noise), sched)
    late = td.q_sample(torch.as_tensor(x0), torch.full((2,), 99),
                       torch.as_tensor(noise), sched)
    assert (early - torch.as_tensor(x0)).abs().mean() < 0.15
    assert (late - torch.as_tensor(noise)).abs().mean() < 0.15
    with pytest.raises(ValueError, match="schedule"):
        td.make_schedule("sigmoid", 10)
    x = rs.randn(3, 4, 4, 2).astype(np.float32)
    eps = rs.randn(3, 4, 4, 2).astype(np.float32)
    t = np.array([0, 37, 99])
    want = jd.q_sample(jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps),
                       jd.make_schedule("cosine", 100))
    got = td.q_sample(torch.as_tensor(x), torch.as_tensor(t),
                      torch.as_tensor(eps), sched)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _stand_in(scale):
    """A denoiser without a network: ε̂ = s·x + t/T·0.1, the same function
    on both sides."""
    def jfn(p, x, t, y=None):
        return p * x + 0.1 * t[:, None, None, None].astype(x.dtype) / 24.0

    def fn(p, x, t, y=None):
        return p * x + 0.1 * t[:, None, None, None].to(x.dtype) / 24.0

    return jfn, fn, jnp.float32(scale), torch.tensor(scale)


@pytest.fixture(scope="module")
def small_unet():
    cfg = JUNetConfig(**SMALL, n_classes=4)
    jp = jax.device_get(JUNet.init(jax.random.PRNGKey(0), cfg))
    return cfg, jp, unet_params_from_jax(jp, "cpu"), UNetConfig(**SMALL,
                                                                n_classes=4)


def _jax_chain_draws(rng, shape, n):
    k_init, k_steps = jax.random.split(rng)
    x = np.asarray(jax.random.normal(k_init, shape, jnp.float32))
    # one vmapped draw: the same values as a draw a key
    zs = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape,
                                                         jnp.float32))(
        jax.random.split(k_steps, n)))
    return torch.as_tensor(x), [torch.as_tensor(z) for z in zs]


def _close_of_max(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("denoiser", ["stand_in", "unet"])
def test_chains_at_jax_draws_match_jax(denoiser, small_unet):
    """DDPM (T 24) and DDIM (6 steps, eta 0 and 0.5) from JAX's own draws
    of the starting noise and each step's z."""
    sched_j, sched = jd.make_schedule("cosine", 24), \
        td.make_schedule("cosine", 24)
    rng = jax.random.PRNGKey(5)
    if denoiser == "stand_in":
        jfn, fn, jp, p = _stand_in(0.3)
        tol = 1e-5
    else:
        jcfg, jp, p, cfg = small_unet

        def jfn(q, x, t):
            return JUNet.apply(q, x, t, jcfg)

        def fn(q, x, t):
            return UNet.apply(q, x, t, cfg)
        tol = 1e-4
    x, zs = _jax_chain_draws(rng, SHAPE, 24)
    want = jd.ddpm_sample(jfn, jp, SHAPE, rng, sched_j)
    _close_of_max(td._ddpm_chain(fn, p, x, zs, sched).numpy(), want, tol)
    for eta in (0.0, 0.5):
        x, zs = _jax_chain_draws(rng, SHAPE, 6)
        want = jd.ddim_sample(jfn, jp, SHAPE, rng, sched_j, steps=6, eta=eta)
        got = td._ddim_chain(fn, p, x, zs, sched, td._ddim_ts(24, 6), eta)
        _close_of_max(got.numpy(), want, tol)


def test_loss_core_at_jax_draws_matches_jax(small_unet):
    """The conditional loss with label dropout (p_uncond 0.5) from JAX's
    draws of t, the noise and the drop (``jax.random.split(rng, 3)``);
    and the unconditional loss with a stand-in denoiser."""
    jcfg, jp, p, cfg = small_unet
    sched_j, sched = jd.make_schedule("cosine", 10), \
        td.make_schedule("cosine", 10)
    x0 = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)
    labels = np.array([1, 3])
    rng = jax.random.PRNGKey(2)
    k_t, k_eps, k_drop = jax.random.split(rng, 3)
    t = torch.as_tensor(np.asarray(jax.random.randint(k_t, (2,), 0, 10)))
    noise = torch.as_tensor(np.asarray(jax.random.normal(k_eps, SHAPE)))
    drop = torch.as_tensor(np.asarray(jax.random.bernoulli(k_drop, 0.5,
                                                           (2,))))

    def jfn(q, x, s, y=None):
        return JUNet.apply(q, x, s, jcfg, labels=y)

    def fn(q, x, s, y=None):
        return UNet.apply(q, x, s, cfg, labels=y)

    want = jd.ddpm_loss(jfn, jp, jnp.asarray(x0), rng, sched_j,
                        labels=jnp.asarray(labels), null_label=4,
                        p_uncond=0.5)
    got = td._ddpm_loss_core(fn, p, torch.as_tensor(x0), t.long(), noise,
                             drop, sched, labels=torch.as_tensor(labels),
                             null_label=4)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    jfn, fn, js, s = _stand_in(0.7)
    want = jd.ddpm_loss(jfn, js, jnp.asarray(x0), rng, sched_j)
    got = td._ddpm_loss_core(fn, s, torch.as_tensor(x0), t.long(), noise,
                             None, sched)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_public_functions_draw_in_the_documented_order():
    """``ddpm_loss`` draws t, the noise and the drop; the samplers the
    start, then each step's z: each equals its core fed those draws from
    an identically seeded generator."""
    _, fn, _, s = _stand_in(0.7)
    sched = td.make_schedule("linear", 12)
    x0 = torch.as_tensor(np.random.RandomState(3).randn(*SHAPE)
                         .astype(np.float32))
    labels = torch.tensor([2, 0])
    got = td.ddpm_loss(fn, s, x0, torch.Generator().manual_seed(9), sched,
                       labels=labels, null_label=3, p_uncond=0.5)
    gen = torch.Generator().manual_seed(9)
    t = torch.randint(0, 12, (2,), generator=gen)
    noise = torch.randn(SHAPE, generator=gen)
    drop = torch.rand((2,), generator=gen) < 0.5
    want = td._ddpm_loss_core(fn, s, x0, t, noise, drop, sched, labels, 3)
    assert got.item() == want.item()
    for name in ("ddpm", "ddim"):
        gen = torch.Generator().manual_seed(4)
        x = torch.randn(SHAPE, generator=gen)
        if name == "ddpm":
            got = td.ddpm_sample(fn, s, SHAPE,
                                 torch.Generator().manual_seed(4), sched)
            zs = [torch.randn(SHAPE, generator=gen) for _ in range(12)]
            want = td._ddpm_chain(fn, s, x, zs, sched)
        else:
            got = td.ddim_sample(fn, s, SHAPE,
                                 torch.Generator().manual_seed(4), sched,
                                 steps=4, eta=0.3)
            zs = [torch.randn(SHAPE, generator=gen) for _ in range(4)]
            want = td._ddim_chain(fn, s, x, zs, sched, td._ddim_ts(12, 4),
                                  0.3)
        assert torch.equal(got, want), name


def test_ddim_deterministic_ddpm_finite_and_label_dropout(small_unet):
    """JAX ``test_ddim_deterministic_and_ddpm_finite`` and
    ``test_ddpm_loss_label_dropout`` on the port: eta-0 DDIM is a
    function of the generator's seed, both samplers give finite images of
    the shape, and at p_uncond 1 every label is the NULL class (the loss
    equals the all-NULL loss from the same generator state)."""
    _, _, p, cfg = small_unet

    def fn(q, x, t, y=None):
        return UNet.apply(q, x, t, cfg, labels=y)

    sched = td.make_schedule("cosine", 24)
    a = td.ddim_sample(fn, p, SHAPE, torch.Generator().manual_seed(5),
                       sched, steps=6)
    b = td.ddim_sample(fn, p, SHAPE, torch.Generator().manual_seed(5),
                       sched, steps=6)
    assert torch.equal(a, b) and a.shape == SHAPE and torch.isfinite(a).all()
    c = td.ddpm_sample(fn, p, SHAPE, torch.Generator().manual_seed(5),
                       td.make_schedule("cosine", 10))
    assert c.shape == SHAPE and torch.isfinite(c).all()
    sched = td.make_schedule("cosine", 10)
    x0 = torch.as_tensor(np.random.RandomState(1).randn(*SHAPE)
                         .astype(np.float32))
    dropped = td.ddpm_loss(fn, p, x0, torch.Generator().manual_seed(2),
                           sched, labels=torch.tensor([1, 3]), null_label=4,
                           p_uncond=1.0)
    nulled = td.ddpm_loss(fn, p, x0, torch.Generator().manual_seed(2),
                          sched, labels=torch.full((2,), 4), null_label=4,
                          p_uncond=1.0)
    assert dropped.item() == nulled.item()


def test_cfg_apply_matches_jax(small_unet):
    """``cfg_apply`` at w 0 (the conditional call itself, no doubled
    batch) and w 2 against JAX's on the same weights: 1e-5 of the
    largest entry."""
    jcfg, jp, p, cfg = small_unet
    x = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)
    t, y = np.array([5, 9]), np.array([0, 1])

    def jfn(q, xx, s, yy):
        return JUNet.apply(q, xx, s, jcfg, labels=yy)

    calls = []

    def fn(q, xx, s, yy):
        calls.append(xx.shape[0])
        return UNet.apply(q, xx, s, cfg, labels=yy)

    for w in (0.0, 2.0):
        want = jd.cfg_apply(jfn, jp, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(y), 4, w)
        got = td.cfg_apply(fn, p, torch.as_tensor(x), torch.as_tensor(t),
                           torch.as_tensor(y), 4, w)
        _close_of_max(got.numpy(), want, 1e-5)
    assert calls == [2, 4]
