"""The generative and style recipes of the port (``recipes/{ddpm,vae,gan,
offline,online,adain}.py``) on the CPU against the JAX recipes of
``examples/img_gen`` and ``examples/img_stt``.

- each recipe's ``Config.load`` of its YAML equal to the JAX recipe's,
  field by field;
- each recipe's ``main(conf, device="cpu")`` at the sizes JAX
  ``tests/test_examples.py`` uses (``:244``, ``:256``, ``:268``, ``:281``,
  ``:414``, ``:458``, ``:478``, ``:509``, ``:530``), with its checks:
  finite falling-or-positive losses, the files written, ddpm's symmetric
  ``to_unit`` and ``n_iter: 0`` spanning the run, its conditional run
  and its save and resume past the epochs done;
- the slice as a whole: one ``make_step`` of the recipe's DDPM loss on
  the small UNet with ``ddpm.yml``'s AdamW and the EMA, fp32, held to
  JAX's ``make_step`` from the same weights and batch. JAX's draws are
  rebuilt from the step key (JAX ``utils.py:341``, then
  ``ops/diffusion.py:77``) and fed to the port's loss core; parameters
  and the EMA after the step within 1e-5, where the gradient entry is
  not at fp32 noise (under 1e-7: Adam's first step is lr·g/(|g| + 1e-8)
  there, held to lr);
- the vae recipe's step (BCE × pixels + ``kld_weight`` × KL) and the gan
  recipe's two-player step (D on hinge + ``gp_weight`` × penalty, then G
  against the updated D, which collects no gradient from G's loss) held
  to the JAX recipes' steps in the same way: JAX's weights, JAX's draws
  rebuilt from its keys and fed to the recipe's own step (its draw
  functions patched), losses within 1e-5 relative, parameters as above.

The style recipes held to JAX are in ``tests/test_torch_style_recipes.py``,
the recipes across ranks in ``tests/test_torch_image_ranks.py``."""
import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
RECIPES = {"ddpm": ("img_gen", "ddpm"), "vae": ("img_gen", "vae"),
           "gan": ("img_gen", "gan"), "offline": ("img_stt", "offline"),
           "online": ("img_stt", "online"), "adain": ("img_stt", "adain")}

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test processes, OpenMP's
    barriers would otherwise stall on busy cores (a UNet epoch took 35x
    its time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _port(name):
    return importlib.import_module(f"torchbooster_tpu_torch.recipes.{name}")


def _jax_recipe(monkeypatch, name):
    directory = EXAMPLES.joinpath(*RECIPES[name])
    monkeypatch.chdir(directory)
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  directory / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def tiny_env(conf):
    """JAX ``tests/test_examples.py:33``'s ``tiny_env``."""
    conf.env.precision = "fp32"
    conf.env.distributed = False
    conf.env.mesh = "dp"
    conf.env.n_devices = 0
    if hasattr(conf, "dataset") and hasattr(conf.dataset, "n_examples"):
        conf.dataset.n_examples = 256


def _load(name):
    recipe = _port(name)
    return recipe, recipe.Config.load(recipe.DEFAULT_YAML)


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_config_load_matches_jax(monkeypatch, name):
    jrecipe = _jax_recipe(monkeypatch, name)
    recipe = _port(name)
    path = EXAMPLES.joinpath(*RECIPES[name], f"{name}.yml")
    assert recipe.DEFAULT_YAML == path
    want = dataclasses.asdict(jrecipe.Config.load(path))
    got = dataclasses.asdict(recipe.Config.load(path))
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, dict):
            # the port's blocks may carry fields JAX lacks: the shared ones
            shared = got[key].keys() & value.keys()
            assert {k: got[key][k] for k in shared} == \
                {k: value[k] for k in shared}, key
        else:
            assert got[key] == value, key


def test_vae_recipe(tmp_path):
    vae, conf = _load("vae")
    conf.epochs, conf.loader.batch_size = 1, 32
    conf.samples_path = str(tmp_path / "samples.npy")
    conf.n_samples = 4
    tiny_env(conf)
    results = vae.main(conf, device="cpu")
    assert results["kld"] >= 0.0 and math.isfinite(results["loss"])
    assert np.load(tmp_path / "samples.npy").shape == (4, 28, 28, 1)


def test_gan_recipe(tmp_path):
    gan, conf = _load("gan")
    conf.epochs, conf.loader.batch_size = 1, 32
    conf.samples_path = str(tmp_path / "samples.npy")
    conf.n_samples = 4
    tiny_env(conf)
    results = gan.main(conf, device="cpu")
    assert all(math.isfinite(results[k]) for k in ("d_loss", "g_loss", "gp"))
    assert len(results["steps"]) == 8
    samples = np.load(tmp_path / "samples.npy")
    assert samples.shape == (4, 28, 28, 1) and np.isfinite(samples).all()


def _held_to_jax(got, want, what, grads, lr):
    """Every leaf of the port's tree ``got`` within 1e-5 of JAX's
    ``want`` after one Adam step, by path, where JAX's gradient entry
    ``grads`` is not at fp32 noise; under 1e-7 the first step
    lr·g/(|g| + 1e-8) hangs on that noise, and the entry is held to
    ``lr``."""
    from torchbooster_tpu_torch.interop import to_numpy

    got = dict(_leaves(to_numpy(got)))
    tiny = {path: np.abs(g) < 1e-7 for path, g in _leaves(grads)}
    want = list(_leaves(want))
    assert got.keys() == {path for path, _ in want}, what
    for path, w in want:
        err = np.abs(got[path] - w)
        assert err[~tiny[path]].max(initial=0) <= 1e-5, (what, path)
        assert err[tiny[path]].max(initial=0) <= lr, (what, path)


def test_vae_step_matches_jax_step(monkeypatch):
    """One step of the recipe's loss (BCE × pixels + ``kld_weight`` × KL
    at ε from the step's generator) under ``vae.yml``'s AdamW, fp32,
    against the JAX recipe's ``make_loss_fn`` under JAX's ``make_step``
    from the same weights and batch. The port's ε is JAX's: the step key
    is ``jax.random.split(state.rng)[1]``, and ``VAE.apply`` draws ε from
    it. The warmup is set to 0 on both, so that the first step moves the
    weights. Loss, BCE and KL within 1e-5 relative, parameters as
    :func:`_held_to_jax` holds them."""
    import jax
    import jax.numpy as jnp

    from torchbooster_tpu import utils as jutils
    from torchbooster_tpu.models import VAE as JVAE
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.interop import vae_params_from_jax

    jvae = _jax_recipe(monkeypatch, "vae")
    vae, conf = _load("vae")
    jconf = jvae.Config.load(vae.DEFAULT_YAML)
    for c in (conf, jconf):
        c.z_dim, c.scheduler.warmup = 8, 0
    images = np.random.RandomState(5).randn(6, 28, 28).astype(np.float32)
    jp = jax.device_get(JVAE.init(jax.random.PRNGKey(0), z_dim=8))
    jtx = jconf.optim.make(jconf.scheduler.make(jconf.optim))
    jstate = jutils.TrainState.create(jax.tree.map(jnp.asarray, jp), jtx,
                                      rng=jax.random.PRNGKey(7))
    jstate, jm = jutils.make_step(jvae.make_loss_fn(jconf, True), jtx)(
        jstate, jnp.asarray(images))
    _, step_rng = jax.random.split(jax.random.PRNGKey(7))
    grads = jax.grad(lambda p: jvae.make_loss_fn(jconf, True)(
        p, jnp.asarray(images), step_rng)[0])(jp)
    eps = torch.as_tensor(np.array(jax.random.normal(step_rng, (6, 8))))
    monkeypatch.setattr(vae, "_eps", lambda g, shape, dtype, mesh: eps)

    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    state = utils.TrainState.create(vae_params_from_jax(jp, "cpu"), tx)
    state, m = utils.make_step(vae.make_loss_fn(conf, True), tx)(
        state, torch.as_tensor(images))
    for key in ("loss", "bce", "kld"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    _held_to_jax(state.params, jax.device_get(jstate.params), "params",
                 grads, conf.optim.lr)


def test_gan_step_updates_d_then_g_against_the_updated_d(monkeypatch):
    """One step of the recipe's ``make_gan_step`` against the JAX
    recipe's from the same weights and batch under ``gan.yml``'s two
    Adams: D's update on hinge + ``gp_weight`` × penalty with x_fake
    detached, then G's against the updated D. The port's draws are
    JAX's: ``split(g_rng)`` gives G's latent key, ``split(d_rng, 3)`` D's
    latent key and the penalty's (``gan.py:86-87``), and the penalty
    draws α in x_real's dtype. d_loss, g_loss and gp within 1e-5
    relative, both players' parameters as :func:`_held_to_jax` holds
    them; D's parameters end with no gradient from G's loss."""
    import jax
    import jax.numpy as jnp

    from torchbooster_tpu import utils as jutils
    from torchbooster_tpu.models import GAN as JGAN
    from torchbooster_tpu.models import gan as jgm
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.interop import gan_params_from_jax

    jgan = _jax_recipe(monkeypatch, "gan")
    gan, conf = _load("gan")
    jconf = jgan.Config.load(gan.DEFAULT_YAML)
    conf.z_dim = jconf.z_dim = 8
    n = 6
    images = np.random.RandomState(0).randn(n, 28, 28, 1).astype(np.float32)
    jp = jax.device_get(JGAN.init(jax.random.PRNGKey(1), z_dim=8))
    rng_g, rng_d = jax.random.split(jax.random.PRNGKey(2))

    def txs(c):
        return (c.g_optim.make(c.g_scheduler.make(c.g_optim)),
                c.d_optim.make(c.d_scheduler.make(c.d_optim)))

    # the keys of the step's draws (the step donates the states' keys)
    _, z_g = jax.random.split(rng_g)
    _, z_d, gp_rng = jax.random.split(rng_d, 3)
    jg_tx, jd_tx = txs(jconf)
    jg, jd = (jutils.TrainState.create(jax.tree.map(jnp.asarray, jp[k]), tx,
                                       rng=rng)
              for k, tx, rng in (("G", jg_tx, rng_g), ("D", jd_tx, rng_d)))
    jg, jd, jm = jgan.make_gan_step(jconf, jg_tx, jd_tx)(
        jg, jd, jnp.asarray(images))
    # JAX's gradients of both players' losses, as its step takes them
    x_real = jax.nn.sigmoid(jnp.asarray(images))
    x_fake = JGAN.generate(jp["G"], jax.random.normal(z_d, (n, 8)))
    d_grads = jax.grad(lambda d: jgm.hinge_d_loss(d, x_real, x_fake)
                       + jconf.gp_weight * jgm.grad_penalty(
                           d, x_real, x_fake, gp_rng))(jp["D"])
    g_grads = jax.grad(lambda g: jgm.hinge_g_loss(jd.params, JGAN.generate(
        g, jax.random.normal(z_g, (n, 8)))))(jp["G"])

    def t(a):
        return torch.as_tensor(np.array(a))

    d_draws = (t(jax.random.normal(z_d, (n, 8))),
               t(jax.random.uniform(gp_rng, (n, 1, 1, 1), jnp.float32)))
    monkeypatch.setattr(gan, "_d_draws", lambda c, g, rows, mesh: d_draws)
    monkeypatch.setattr(gan, "_g_draws", lambda c, g, rows, mesh:
                        t(jax.random.normal(z_g, (n, 8))))

    g_tx, d_tx = txs(conf)
    params = gan_params_from_jax(jp, "cpu")
    g_state, d_state = (utils.TrainState.create(params[k], tx)
                        for k, tx in (("G", g_tx), ("D", d_tx)))
    g_state, d_state, m = gan.make_gan_step(conf, g_tx, d_tx)(
        g_state, d_state, torch.as_tensor(images))
    assert all(p.grad is None for p in utils.tree_leaves(d_state.params))
    for key in ("d_loss", "g_loss", "gp"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    _held_to_jax(d_state.params, jax.device_get(jd.params), "D",
                 d_grads, conf.d_optim.lr)
    _held_to_jax(g_state.params, jax.device_get(jg.params), "G",
                 g_grads, conf.g_optim.lr)


def test_offline_recipe(tmp_path):
    offline, conf = _load("offline")
    conf.n_iter, conf.image_size = 2, 32
    conf.output_path = str(tmp_path / "out.npy")
    results = offline.main(conf, device="cpu")
    assert results["loss"] >= 0.0 and len(results["losses"]) == 2
    assert np.load(tmp_path / "out.npy").shape == (32, 32, 3)
    # a scalar where a list is annotated coerces to a one-element list
    assert conf.content_layers == [29]


def test_online_recipe(tmp_path):
    online, conf = _load("online")
    conf.n_iter, conf.sample_every = 2, 2
    conf.dataset.image_size, conf.dataset.n_images = 32, 16
    conf.loader.batch_size = 4
    conf.samples_path = str(tmp_path / "samples")
    tiny_env(conf)
    results = online.main(conf, device="cpu")
    assert results["loss"] >= 0.0 and results["iter"] == 2
    assert list(Path(conf.samples_path).glob("styled_*.npy"))


def test_adain_recipe(tmp_path):
    adain, conf = _load("adain")
    conf.n_iter, conf.sample_every = 2, 2
    for dataset in (conf.content, conf.style):
        dataset.image_size, dataset.n_images = 32, 16
    conf.loader.batch_size = 4
    conf.samples_path = str(tmp_path / "samples")
    tiny_env(conf)
    results = adain.main(conf, device="cpu")
    assert results["style"] >= 0.0
    out = np.load(Path(conf.samples_path) / "adain_final.npy")
    assert out.shape == (1, 32, 32, 3)


def _ddpm_small(conf, tmp_path=None):
    conf.epochs, conf.loader.batch_size = 1, 32
    conf.model.base, conf.model.mults, conf.model.time_dim = 16, (1, 2), 32
    if tmp_path is not None:
        conf.samples_path = str(tmp_path / "samples.npy")
    tiny_env(conf)


def test_ddpm_recipe_and_conditional_cfg(tmp_path):
    """JAX ``test_ddpm`` and ``test_ddpm_conditional_cfg``: the loss over
    an epoch and finite DDIM samples; class-conditional training with
    label dropout and guided per-class sampling."""
    ddpm, conf = _load("ddpm")
    _ddpm_small(conf, tmp_path)
    conf.timesteps, conf.sample_steps = 50, 5
    conf.n_samples = 2
    results = ddpm.main(conf, device="cpu")
    assert results["loss"] > 0.0 and results["train_steps"] == 8
    samples = np.load(tmp_path / "samples.npy")
    assert samples.shape == (2, 28, 28, 1) and np.isfinite(samples).all()
    conf.model.n_classes = 10
    conf.n_samples, conf.guidance = 4, 1.5
    results = ddpm.main(conf, device="cpu")
    assert results["loss"] > 0.0
    samples = np.load(tmp_path / "samples.npy")
    assert samples.shape == (4, 28, 28, 1) and np.isfinite(samples).all()


def test_ddpm_to_unit_symmetric_and_scheduler_spans_run():
    ddpm, conf = _load("ddpm")
    x = torch.linspace(0.0, 1.0, 5)
    np.testing.assert_allclose(ddpm.to_unit(x).numpy(),
                               np.linspace(-1.0, 1.0, 5), atol=1e-6)
    ints = torch.tensor([0, 255], dtype=torch.uint8)
    np.testing.assert_allclose(ddpm.to_unit(ints).numpy(), [-1.0, 1.0])
    assert ddpm.to_unit(x.to(torch.bfloat16)).dtype == torch.float32
    assert conf.scheduler.n_iter == 0          # YAML defers to the recipe
    _ddpm_small(conf)
    conf.epochs = 2
    conf.timesteps, conf.sample_steps, conf.n_samples = 20, 0, 0
    ddpm.main(conf, device="cpu")
    steps = conf.scheduler.n_iter
    assert steps == 16, "recipe must compute the real run length"
    sched = conf.scheduler.make(conf.optim)
    # mid-run lr must still be alive (not collapsed to the final floor)
    assert float(sched(steps // 2)) > 0.1 * conf.optim.lr


def test_ddpm_checkpoint_resume(tmp_path, capsys):
    """JAX ``test_ddpm_checkpoint_resume``: a checkpoint an epoch, the
    EMA in the state, and a rerun resumes past the epochs done."""
    from torchbooster_tpu_torch.callbacks import SaveCallback

    ddpm, conf = _load("ddpm")
    _ddpm_small(conf)
    conf.timesteps, conf.sample_steps, conf.n_samples = 20, 0, 0
    conf.save_every = 1
    conf.checkpoint_root = str(tmp_path / "ckpt")
    first = ddpm.setup(conf, "cpu")
    ddpm.run(first)
    conf.epochs = 2
    second = ddpm.setup(conf, "cpu")           # resumes at epoch 1
    assert "resumed at epoch 1" in capsys.readouterr().out
    assert second.start_epoch == 1 and second.state.step == 8
    for a, b in zip(_flat(first.state.ema), _flat(second.state.ema)):
        assert torch.equal(a, b)
    results = ddpm.run(second)
    assert results["epoch"] == 1
    assert SaveCallback(1, 2, root=conf.checkpoint_root).latest_step() == 2


def _flat(tree):
    from torchbooster_tpu_torch.utils import tree_leaves

    return tree_leaves(tree)


def test_ddpm_make_step_matches_jax_make_step():
    """The slice as a whole: one step of the recipe's loss (small UNet,
    fp32) under ``ddpm.yml``'s AdamW (decay on matrices only) with the
    EMA at 0.999, against JAX's ``make_step`` on the same weights and
    batch. The port's loss takes JAX's draws: the step key is
    ``jax.random.split(state.rng)[1]`` and ``ddpm_loss`` splits it in 3.
    Parameters and the EMA within 1e-5 after the step."""
    import jax
    import jax.numpy as jnp

    from torchbooster_tpu import utils as jutils
    from torchbooster_tpu.config import OptimizerConfig as JOptimizerConfig
    from torchbooster_tpu.config import SchedulerConfig as JSchedulerConfig
    from torchbooster_tpu.models.unet import UNet as JUNet
    from torchbooster_tpu.models.unet import UNetConfig as JUNetConfig
    from torchbooster_tpu.ops import diffusion as jd
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.config import OptimizerConfig, SchedulerConfig
    from torchbooster_tpu_torch.interop import to_numpy, unet_params_from_jax
    from torchbooster_tpu_torch.models.unet import UNet, UNetConfig
    from torchbooster_tpu_torch.ops import diffusion as td
    from torchbooster_tpu_torch.recipes import ddpm

    conf = ddpm.Config.load(ddpm.DEFAULT_YAML)
    optim = dict(name=conf.optim.name, lr=conf.optim.lr,
                 decay_matrices_only=conf.optim.decay_matrices_only)
    sched_kw = dict(name="cycle", n_iter=10, warmup=0,
                    decay=conf.scheduler.decay)
    small = dict(in_channels=1, base=16, mults=(1, 2), time_dim=32)
    jcfg, cfg = JUNetConfig(**small), UNetConfig(**small)
    jp = jax.device_get(JUNet.init(jax.random.PRNGKey(0), jcfg))
    T = 50
    sched_j, sched = jd.make_schedule("cosine", T), \
        td.make_schedule("cosine", T)
    images = np.random.RandomState(3).rand(4, 16, 16).astype(np.float32)

    jopt = JOptimizerConfig(**optim)
    jtx = jopt.make(JSchedulerConfig(**sched_kw).make(jopt))
    jstate = jutils.TrainState.create(jax.tree.map(jnp.asarray, jp), jtx,
                                      rng=jax.random.PRNGKey(7), ema=True)

    def jloss(params, batch, rng):
        x0 = jnp.clip(batch * 2.0 - 1.0, -1.0, 1.0)[..., None]
        return jd.ddpm_loss(lambda p, x, t: JUNet.apply(p, x, t, jcfg),
                            params, x0, rng, sched_j), {}

    jstep = jutils.make_step(jloss, jtx, ema_decay=conf.ema_decay)
    jstate, jm = jstep(jstate, jnp.asarray(images))
    # JAX's draws: the step key, then ddpm_loss's three
    _, step_rng = jax.random.split(jax.random.PRNGKey(7))
    k_t, k_eps, _ = jax.random.split(step_rng, 3)
    t = torch.as_tensor(np.asarray(jax.random.randint(k_t, (4,), 0, T)))
    noise = torch.as_tensor(np.asarray(jax.random.normal(
        k_eps, (4, 16, 16, 1), jnp.float32)))

    def loss(params, batch, generator):
        x0 = ddpm.to_unit(batch)[..., None]
        return td._ddpm_loss_core(
            lambda p, x, s: UNet.apply(p, x, s, cfg), params, x0, t.long(),
            noise, None, sched), {}

    params = unet_params_from_jax(jp, "cpu")
    for p in utils.tree_leaves(params):
        p.requires_grad_(True)
    loss(params, torch.as_tensor(images), None)[0].backward()
    tiny = {path: np.abs(g) < 1e-7 for path, g in _leaves(to_numpy(
        utils._tree_map(lambda q: q.grad, params)))}
    opt = OptimizerConfig(**optim)
    tx = opt.make(SchedulerConfig(**sched_kw).make(opt))
    state = utils.TrainState.create(unet_params_from_jax(jp, "cpu"), tx,
                                    ema=True)
    step = utils.make_step(loss, tx, ema_decay=conf.ema_decay)
    state, m = step(state, torch.as_tensor(images))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    for name, got, want in (("params", state.params, jstate.params),
                            ("ema", state.ema, jstate.ema)):
        got = dict(_leaves(to_numpy(got)))
        for path, w in _leaves(jax.device_get(want)):
            err = np.abs(got[path] - w)
            assert err[~tiny[path]].max(initial=0) <= 1e-5, (name, path)
            assert err[tiny[path]].max(initial=0) <= conf.optim.lr, \
                (name, path)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)
