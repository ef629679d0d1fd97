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
- ``launch_main`` of the lenet recipe as a world-1 gloo group.
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


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)
