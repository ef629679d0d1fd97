"""The image recipes across ranks on the CPU: gloo process groups of 2
(``RankPool`` of ``tests/test_torch_distributed.py``, spawned once for
this file). The ranks import this file to find their cases, so it
imports no JAX.

- the lenet recipe at ``fsdp:2`` (JAX ``tests/test_examples.py:54``, the
  one-switch distributed flip): every rank logs the same losses (the
  mean over the ranks), the dense kernels are laid out by
  ``LeNet.SHARDING_RULES``, the test accuracy is a fraction;
- the ResNet recipe at ``fsdp:2`` (JAX ``tests/test_examples.py:193``):
  the conv kernels' spec is ``(None, None, None, "fsdp")`` and a dp-only
  mesh replicates them; a 2-step fp32 trajectory from the same global
  batches equals world 1's (losses 1e-5 relative, parameters 2e-4
  absolute: AdamW divides by √v, so fp32 noise on a near-zero gradient
  entry moves that entry by a fraction of lr);
- ``launch_main`` of the lenet recipe as a world-1 gloo group;
- ``UNet.SHARDING_RULES`` placed on an ``fsdp:2`` pool: every leaf's spec
  equals JAX's placement on ``dp:2,fsdp:4`` (JAX
  ``tests/test_models.py:1098``; JAX is imported inside the test);
- the ddpm recipe's trainer at world 2, ``dp:2`` and ``fsdp:2``, against
  world 1: 2 fp32 steps of its own step (its loss and its draws) on its
  UNet and EMA from the same global batches, each rank its rows. The
  draws (t, noise) are made for the global batch and cut by rank, so
  world 2 takes world 1's step only if every rank's rows get their own
  draws: losses 1e-5 relative, parameters and the gathered EMA 2e-4
  absolute (AdamW, as above); the conv kernels laid out over ``fsdp``;
  then the recipe's ``main`` at ``fsdp:2``: both ranks log the same
  finite losses and the primary writes samples from the gathered EMA;
- the vae and gan recipes' own steps (ε; the latents and the penalty's
  α) at ``fsdp:2`` against world 1 in the same way, 2 fp32 steps:
  losses 1e-5 relative, parameters 2e-4 absolute;
- the vae, gan, online and adain recipes' ``main`` at ``fsdp:2`` at JAX
  ``tests/test_examples.py``'s sizes: both ranks log the same finite
  metrics (the mean over the ranks), and the primary alone writes the
  outputs, from the gathered parameters.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import RankPool
from torchbooster_tpu_torch.config import (
    DatasetConfig,
    EnvConfig,
    LoaderConfig,
    OptimizerConfig,
    SchedulerConfig,
)
from torchbooster_tpu_torch.interop import to_numpy


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread in the test process: beside the ranks and the
    other test processes, OpenMP's barriers would otherwise stall on busy
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


def lenet_conf(mesh: str, distributed: bool, n_devices: int):
    from torchbooster_tpu_torch.recipes import lenet

    return lenet.Config(
        epochs=1, seed=42,
        env=EnvConfig(distributed=distributed, precision="fp32",
                      n_devices=n_devices, mesh=mesh),
        loader=LoaderConfig(batch_size=16, drop_last=True),
        optim=OptimizerConfig(name="adamw", lr=2e-3, weight_decay=1e-4),
        scheduler=SchedulerConfig(name="cycle", n_iter=0, warmup=2,
                                  decay=("cos", "cos")),
        dataset=DatasetConfig(name="synthetic_mnist", n_examples=256))


def resnet_conf(mesh: str, distributed: bool, n_devices: int):
    from torchbooster_tpu_torch.recipes import resnet

    return resnet.Config(
        epochs=1, seed=42, depth=18, num_classes=10, clip=1.0,
        label_smoothing=0.1, pretrained="", freeze_backbone=False,
        env=EnvConfig(distributed=distributed, precision="fp32",
                      n_devices=n_devices, mesh=mesh),
        loader=LoaderConfig(batch_size=4, drop_last=True),
        optim=OptimizerConfig(name="adamw", lr=1e-3, weight_decay=1e-2),
        scheduler=SchedulerConfig(name="cycle", n_iter=4, warmup=1,
                                  decay=("lin", "cos")),
        dataset=DatasetConfig(name="synthetic_cifar10", n_examples=16))


def resnet_batches():
    rs = np.random.RandomState(8)
    return [(rs.randn(4, 8, 8, 3).astype(np.float32),
             rs.randint(0, 10, 4).astype(np.int64)) for _ in range(2)]


def resnet_trajectory(conf, mesh=None) -> dict:
    """Two recipe steps on :func:`resnet_batches` (this rank's rows of
    each under ``mesh``): the losses and the whole parameters after."""
    from torchbooster_tpu_torch import distributed as dist
    from torchbooster_tpu_torch.recipes import resnet

    t = resnet.setup(conf, "cpu")
    losses = []
    for images, labels in resnet_batches():
        rows = dist.batch_rows(len(labels), t.mesh) if mesh else slice(None)
        batch = resnet.to_device((images[rows], labels[rows]), t.device)
        t.state, m = t.step(t.state, batch)
        losses.append(m["loss"].item())
    return {"losses": losses, "params": to_numpy(t.eval_params()),
            "spec": getattr(t.state.params["stage1"]["block0"]["conv1"]
                            ["kernel"], "spec", None),
            "head_spec": getattr(t.state.params["head"]["kernel"], "spec",
                                 None)}


def resnet_fsdp_rank() -> dict:
    """Rank case: the ResNet trajectory at ``fsdp:2``, and the specs a
    dp-only mesh gives the same tree."""
    from torchbooster_tpu_torch import distributed as dist
    from torchbooster_tpu_torch.models import ResNet
    from torchbooster_tpu_torch.parallel import make_param_specs

    out = resnet_trajectory(resnet_conf("fsdp:2", True, 2), mesh=True)
    dp = dist.make_mesh("dp:2", device="cpu")
    specs = make_param_specs(ResNet.init(0, 18, 10, "cifar", device="cpu"),
                             ResNet.SHARDING_RULES, mesh=dp)
    out["dp_spec"] = specs["stage1"]["block0"]["conv1"]["kernel"]
    return out


def lenet_rank() -> dict:
    """Rank case: the lenet recipe at ``fsdp:2`` through ``setup`` and
    ``run``."""
    from torchbooster_tpu_torch.recipes import lenet, resnet

    t = lenet.setup(lenet_conf("fsdp:2", True, 2), "cpu")
    res = resnet.run(t)
    return {"losses": [s["loss"] for s in res["steps"]],
            "train_loss": res["train_loss"], "test_acc": res["test_acc"],
            "fc1_spec": t.state.params["fc1"]["kernel"].spec,
            "head_spec": t.state.params["head"]["kernel"].spec,
            "conv_spec": getattr(t.state.params["conv1"]["kernel"], "spec",
                                 None)}


def test_lenet_recipe_at_fsdp_2(pool):
    ranks = pool.run(lenet_rank)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert len(ranks[0]["losses"]) == 16    # 256 examples, global batch 16
    assert all(map(math.isfinite, ranks[0]["losses"]))
    for r in ranks:
        assert 0.0 <= r["test_acc"] <= 1.0
        assert r["fc1_spec"] == (None, "fsdp")
        assert r["head_spec"] == ("fsdp", None)
        assert not any(r["conv_spec"])          # replicated


def test_resnet_recipe_fsdp_2_matches_world_1(pool):
    ranks = pool.run(resnet_fsdp_rank)
    want = resnet_trajectory(resnet_conf("dp", False, 0))
    for r in ranks:
        assert r["spec"] == (None, None, None, "fsdp")
        assert r["head_spec"] == ("fsdp", None)
        assert not any(r["dp_spec"])            # replicated
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
    got = dict(_leaves(ranks[0]["params"]))
    for path, w in _leaves(want["params"]):
        np.testing.assert_allclose(got[path], w, rtol=0, atol=2e-4,
                                   err_msg=str(path))
    for path, a in _leaves(ranks[1]["params"]):
        assert a.tobytes() == got[path].tobytes(), path


def test_lenet_launch_main_in_a_world_1_group():
    """``launch_main`` with ``env.distributed: true`` at one device runs
    ``main`` inside a world-1 gloo group and returns its result."""
    from torchbooster_tpu_torch.recipes import lenet

    res = lenet.launch_main(lenet_conf("dp", True, 1), device="cpu")
    assert res["train_steps"] == 16 and math.isfinite(res["train_loss"])
    assert not torch.distributed.is_initialized()


def _leaves(tree, path=(), raw=False):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,), raw)
    else:
        yield path, tree if raw else np.asarray(tree)


UNET_SMALL = dict(in_channels=1, base=16, mults=(1, 2), time_dim=32)


def unet_placement_rank() -> dict:
    """Rank case: ``UNet.SHARDING_RULES`` laid out on ``fsdp:2``; each
    leaf's spec by path."""
    from torchbooster_tpu_torch import distributed as dist
    from torchbooster_tpu_torch.models.unet import UNet, UNetConfig
    from torchbooster_tpu_torch.parallel.sharding import shard_params

    mesh = dist.make_mesh("fsdp:2", device="cpu")
    placed = shard_params(UNet.init(0, UNetConfig(**UNET_SMALL, n_classes=4),
                                    device="cpu"), mesh, UNet.SHARDING_RULES)
    return {path: tuple(getattr(leaf, "spec", ()))
            for path, leaf in _leaves(placed, raw=True)}


def test_unet_placement_on_fsdp_matches_jax(pool):
    import jax

    from torchbooster_tpu.distributed import make_mesh
    from torchbooster_tpu.models.unet import UNet as JUNet
    from torchbooster_tpu.models.unet import UNetConfig as JUNetConfig
    from torchbooster_tpu.parallel import shard_params

    params = JUNet.init(jax.random.PRNGKey(0),
                        JUNetConfig(**UNET_SMALL, n_classes=4))
    placed = shard_params(params, make_mesh("dp:2,fsdp:4"),
                          JUNet.SHARDING_RULES)
    want = {path: tuple(leaf.sharding.spec) + (None,) * (
        leaf.ndim - len(leaf.sharding.spec))
        for path, leaf in _leaves(placed, raw=True)}
    for got in pool.run(unet_placement_rank):
        got = {p: s + (None,) * (len(want[p]) - len(s))
               for p, s in got.items()}
        assert got == want
        assert got[("stem", "kernel")] == (None, None, None, "fsdp")
        assert got[("time_mlp1", "kernel")] == ("fsdp", None)
        assert not any(got[("label_emb", "table")])


def ddpm_conf(mesh: str, distributed: bool, n_devices: int, root: str = ""):
    from torchbooster_tpu_torch.recipes import ddpm

    return ddpm.Config(
        epochs=1, seed=42, timesteps=20, schedule="cosine", n_samples=2,
        sample_steps=2, samples_path=f"{root}/samples.npy",
        model=ddpm.ModelConfig(**UNET_SMALL),
        env=EnvConfig(distributed=distributed, precision="fp32",
                      n_devices=n_devices, mesh=mesh),
        loader=LoaderConfig(batch_size=8, drop_last=True),
        optim=OptimizerConfig(name="adamw", lr=2e-4,
                              decay_matrices_only=True),
        scheduler=SchedulerConfig(name="cycle", n_iter=4, warmup=1,
                                  decay=("cos", "cos")),
        dataset=DatasetConfig(name="synthetic_mnist", n_examples=32))


def ddpm_batches():
    rs = np.random.RandomState(9)
    return [rs.rand(4, 16, 16).astype(np.float32) for _ in range(2)]


def ddpm_trajectory(conf, mesh: bool = False) -> dict:
    """Two steps of the ddpm trainer (``setup``, its own step) on
    :func:`ddpm_batches` (this rank's rows of each under ``mesh``): the
    losses, the whole parameters and EMA after."""
    from torchbooster_tpu_torch import distributed as dist
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.recipes import ddpm

    t = ddpm.setup(conf, "cpu")
    losses = []
    for images in ddpm_batches():
        rows = dist.batch_rows(4, t.mesh) if mesh else slice(None)
        t.state, m = t.step(t.state, torch.as_tensor(images[rows]))
        losses.append(m["loss"].item())
    whole = t.state.params
    if mesh:
        from torchbooster_tpu_torch.parallel.sharding import full_leaf

        with torch.no_grad():
            whole = utils._tree_map(lambda p: full_leaf(p, t.mesh), whole)
    return {"losses": losses, "params": to_numpy(whole),
            "ema": to_numpy(t.sample_params()),
            "spec": getattr(t.state.params["down0_a"]["conv1"]["kernel"],
                            "spec", None)}


def ddpm_rank(mesh: str) -> dict:
    return ddpm_trajectory(ddpm_conf(mesh, True, 2), mesh=True)


def ddpm_main_rank(root: str) -> dict:
    from torchbooster_tpu_torch.recipes import ddpm

    res = ddpm.main(ddpm_conf("fsdp:2", True, 2, root), "cpu")
    return {"losses": res["losses"], "samples": res.get("samples")}


@pytest.mark.parametrize("mesh", ["dp:2", "fsdp:2"])
def test_ddpm_recipe_at_world_2_matches_world_1(pool, mesh):
    ranks = pool.run(ddpm_rank, mesh)
    want = ddpm_trajectory(ddpm_conf("dp", False, 0))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        if mesh == "fsdp:2":
            assert r["spec"] == (None, None, None, "fsdp")
        else:
            assert not any(r["spec"] or ())
        for key in ("params", "ema"):
            got = dict(_leaves(r[key]))
            for path, w in _leaves(want[key]):
                np.testing.assert_allclose(got[path], w, rtol=0, atol=2e-4,
                                           err_msg=f"{key} {path}")


def test_ddpm_recipe_main_at_fsdp_2(pool, tmp_path):
    ranks = pool.run(ddpm_main_rank, str(tmp_path))
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert len(ranks[0]["losses"]) == 4      # 32 examples, global batch 8
    assert all(map(math.isfinite, ranks[0]["losses"]))
    assert ranks[0]["samples"] and ranks[1]["samples"] is None
    samples = np.load(tmp_path / "samples.npy")
    assert samples.shape == (2, 28, 28, 1) and np.isfinite(samples).all()


def gen_trajectory(name: str, mesh: str | None) -> dict:
    """Two fp32 steps of the vae or gan recipe's own step (its loss and
    its draws, from the state's generators at the recipe's seeds) on two
    global batches of 4 images: on this rank's rows under ``mesh`` (a
    world-2 spec), else whole in one process. The losses and the whole
    parameters after."""
    import importlib

    from torchbooster_tpu_torch import distributed as dist
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.models import GAN, VAE
    from torchbooster_tpu_torch.parallel.sharding import full_tree

    recipe = importlib.import_module(f"torchbooster_tpu_torch.recipes.{name}")
    conf = recipe.Config.load(recipe.DEFAULT_YAML)
    conf.z_dim = 8
    conf.env = EnvConfig(distributed=mesh is not None, precision="fp32",
                         n_devices=2 if mesh else 0, mesh=mesh or "dp")
    m = dist.get_mesh(conf.env, device="cpu")
    rs = np.random.RandomState(4)
    rows = dist.batch_rows(4, m) if mesh else slice(None)
    batches = [torch.as_tensor(rs.randn(4, 28, 28, 1).astype(np.float32)[rows])
               for _ in range(2)]

    def state(params, tx, seed, model):
        return conf.env.make(utils.TrainState.create(params, tx,
                                                     generator=seed),
                             model=model, device="cpu")

    losses = []
    if name == "vae":
        # warmup 0: the first step moves the weights; lr as the ddpm case
        conf.optim.lr, conf.scheduler.warmup = 2e-4, 0
        tx = conf.optim.make(conf.scheduler.make(conf.optim))
        s = state(VAE.init(0, z_dim=8, device="cpu"), tx, conf.seed, VAE)
        step = utils.make_step(recipe.make_loss_fn(conf, True, m), tx,
                               mesh=m, rules=VAE.SHARDING_RULES)
        for batch in batches:
            s, metrics = step(s, batch)
            losses.append(metrics["loss"].item())
        return {"losses": losses, "params": to_numpy(full_tree(s.params, m))}
    params = GAN.init(0, z_dim=8, device="cpu")
    g_tx = conf.g_optim.make(conf.g_scheduler.make(conf.g_optim))
    d_tx = conf.d_optim.make(conf.d_scheduler.make(conf.d_optim))
    g, d = state(params["G"], g_tx, conf.seed, GAN), \
        state(params["D"], d_tx, conf.seed + 1, GAN)
    step = recipe.make_gan_step(conf, g_tx, d_tx,
                                m if m.distributed else None)
    for batch in batches:
        g, d, metrics = step(g, d, batch)
        losses += [metrics[k].item() for k in ("d_loss", "g_loss", "gp")]
    return {"losses": losses,
            "params": to_numpy({"G": full_tree(g.params, m),
                                "D": full_tree(d.params, m)})}


@pytest.mark.parametrize("name", ["vae", "gan"])
def test_gen_recipe_step_at_world_2_matches_world_1(pool, name):
    ranks = pool.run(gen_trajectory, name, "fsdp:2")
    want = gen_trajectory(name, None)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        got = dict(_leaves(r["params"]))
        for path, w in _leaves(want["params"]):
            np.testing.assert_allclose(got[path], w, rtol=0, atol=2e-4,
                                       err_msg=f"{path}")


def small_recipe_conf(name: str, root: str):
    """JAX ``tests/test_examples.py``'s sizes for ``name``, fp32, on
    ``fsdp:2``."""
    import importlib

    recipe = importlib.import_module(f"torchbooster_tpu_torch.recipes.{name}")
    conf = recipe.Config.load(recipe.DEFAULT_YAML)
    conf.env = EnvConfig(distributed=True, precision="fp32", n_devices=2,
                         mesh="fsdp:2")
    if name in ("vae", "gan"):
        conf.epochs, conf.loader.batch_size = 1, 32
        conf.dataset.n_examples = 128
        conf.samples_path, conf.n_samples = f"{root}/samples.npy", 4
    else:
        conf.n_iter, conf.sample_every = 2, 2
        conf.loader.batch_size = 4
        conf.samples_path = f"{root}/samples"
        for ds in ((conf.dataset,) if name == "online"
                   else (conf.content, conf.style)):
            ds.image_size, ds.n_images = 32, 16
    return recipe, conf


def recipe_main_rank(name: str, root: str) -> dict:
    recipe, conf = small_recipe_conf(name, root)
    res = recipe.main(conf, "cpu")
    steps = res.get("steps")
    return {"losses": res.get("losses") or [
        v for m in steps for v in m.values()],
        "samples": res.get("samples")}


@pytest.mark.parametrize("name", ["vae", "gan", "online", "adain"])
def test_recipe_main_at_fsdp_2(pool, tmp_path, name):
    from pathlib import Path

    ranks = pool.run(recipe_main_rank, name, str(tmp_path))
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["losses"] and all(map(math.isfinite,
                                          ranks[0]["losses"]))
    if name in ("vae", "gan", "adain"):
        assert ranks[0]["samples"] and ranks[1]["samples"] is None
        assert Path(ranks[0]["samples"]).exists()
    else:
        assert list((tmp_path / "samples").glob("styled_*.npy"))
