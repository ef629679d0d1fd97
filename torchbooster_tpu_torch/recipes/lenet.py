"""LeNet on MNIST — the port of the JAX recipe
``examples/img_cls/lenet/lenet.py``, driven by the same YAML:

    python -m torchbooster_tpu_torch.recipes.lenet [config.yml]
    python -m torchbooster_tpu_torch.recipes.lenet --sweep [sweep.yml]

(``examples/img_cls/lenet/lenet.yml`` and ``lenet-sweep.yml`` by
default, read in place; reading a YAML needs PyYAML). The first form runs
:func:`main` under ``distributed.launch`` (:func:`launch_main`), the
second :func:`sweep`, one :func:`main` a point of the sweep grammar. The
flow is the JAX recipe's: ``dataset: mnist`` resolves as in the JAX
chain (a record store ``root/<split>.bstore``, an MNIST IDX release
under ``root``, else offline its ``synthetic_mnist`` twin);
``scheduler.n_iter: 0`` becomes epochs × steps an epoch; ``LeNet.apply``
at the ``env.precision`` compute dtype over fp32 masters through
``utils.make_step``; an eval pass over the test split after every epoch.
On the card the two GroupNorms launch B5/B6: the 6-channel one on the
``"two_pass"`` route, the 16-channel one at bf16 on ``"one_pass"``.

Across ranks (``env.distributed: true``): each rank reads its strided
shard of every batch, the state is laid out by ``LeNet.SHARDING_RULES``
and the gradient averaged over the data axes (the training loop is the
ResNet recipe's :func:`~torchbooster_tpu_torch.recipes.resnet.run`)."""
from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch

from torchbooster_tpu_torch import distributed as dist
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.config import (
    BaseConfig,
    DatasetConfig,
    EnvConfig,
    LoaderConfig,
    OptimizerConfig,
    SchedulerConfig,
)
from torchbooster_tpu_torch.dataset import Split
from torchbooster_tpu_torch.metrics import accuracy
from torchbooster_tpu_torch.models.lenet import LeNet
from torchbooster_tpu_torch.ops.losses import cross_entropy
from torchbooster_tpu_torch.recipes.resnet import Trainer, run, unpack

EXAMPLE_DIR = Path(__file__).resolve().parents[2] / "examples" / "img_cls" \
    / "lenet"
DEFAULT_YAML = EXAMPLE_DIR / "lenet.yml"
SWEEP_YAML = EXAMPLE_DIR / "lenet-sweep.yml"


@dataclass
class Config(BaseConfig):
    epochs: int
    seed: int

    env: EnvConfig
    loader: LoaderConfig
    optim: OptimizerConfig
    scheduler: SchedulerConfig
    dataset: DatasetConfig


def make_loss_fn(train: bool, gn_impl: str = "auto") -> Callable:
    """``loss_fn(params, batch, generator) -> (loss, {"acc"})``: cross
    entropy and top-1 accuracy; grayscale images without a channel axis
    get one. ``gn_impl``: the GroupNorms' impl (``"plain"`` skips
    B5/B6)."""
    del train

    def loss_fn(params: dict, batch: Any, generator: Any):
        images, labels = unpack(batch)
        if images.ndim == 3:
            images = images[..., None]
        logits = LeNet.apply(params, images, gn_impl=gn_impl)
        return cross_entropy(logits, labels), {"acc": accuracy(logits,
                                                               labels)}

    return loss_fn


def setup(conf: Config, device: str | torch.device = "cuda") -> Trainer:
    """Data, model, optimizer and the train and eval steps on ``device``
    (this rank's card under a group). ``scheduler.n_iter <= 0`` is set to
    ``epochs`` × the train loader's length, in place."""
    generator = utils.seed(conf.seed)
    dev = conf.env.device(device)
    mesh = dist.get_mesh(conf.env, device=device)
    train_loader = conf.loader.make(conf.dataset.make(Split.TRAIN),
                                    shuffle=True,
                                    distributed=conf.env.distributed,
                                    seed=conf.seed)
    test_loader = conf.loader.make(conf.dataset.make(Split.TEST),
                                   shuffle=False,
                                   distributed=conf.env.distributed)
    if conf.scheduler.n_iter <= 0:
        # the run's real length: a stale constant would hold the lr near
        # its final value for the tail of a full-size dataset's run
        conf.scheduler.n_iter = conf.epochs * max(len(train_loader), 1)
    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    state = utils.TrainState.create(LeNet.init(generator, device=dev), tx,
                                    generator=generator)
    state = conf.env.make(state, model=LeNet, device=device)
    compute = conf.env.compute_dtype()
    step = utils.make_step(make_loss_fn(train=True), tx,
                           compute_dtype=compute, mesh=mesh,
                           rules=LeNet.SHARDING_RULES)
    eval_step = utils.make_eval_step(make_loss_fn(train=False),
                                     compute_dtype=compute)
    return Trainer(conf=conf, device=dev, state=state, step=step,
                   eval_step=eval_step, train_loader=train_loader,
                   test_loader=test_loader, mesh=mesh)


def main(conf: Config, device: str | torch.device = "cuda") -> dict:
    """:func:`setup`, then the image recipes' ``run``: the last epoch's
    record plus ``log`` and ``steps`` (``recipes.resnet.run``)."""
    return run(setup(conf, device))


def sweep(path: str | Path = SWEEP_YAML,
          device: str | torch.device = "cuda") -> list[dict]:
    """One :func:`main` a point of the sweep file (``hyperparams=True``),
    in order; each outcome tagged with its ``lr``."""
    outcomes = []
    for conf in Config.load(path, hyperparams=True):
        if dist.is_primary():
            print(f"sweep point: lr={conf.optim.lr}", flush=True)
        outcomes.append({"lr": conf.optim.lr, **main(conf, device)})
    if dist.is_primary():
        best = max(outcomes, key=lambda r: r.get("test_acc", 0.0))
        print({"best_lr": best["lr"], "best_test_acc": best["test_acc"]},
              flush=True)
    return outcomes


def launch_main(conf: Config, device: str = "cuda") -> Any:
    """:func:`main` under ``distributed.launch`` with the YAML's ``env``
    (the JAX recipe's ``__main__``): NCCL on the card, gloo with
    ``device="cpu"``; one result a rank (the result itself at world 1
    without ``distributed``)."""
    return dist.launch(main, conf.env.devices(), conf.env.n_machine,
                       conf.env.machine_rank, conf.env.dist_url,
                       args=(conf, device), distributed=conf.env.distributed,
                       device=device)


if __name__ == "__main__":
    utils.boost()
    paths = [a for a in sys.argv[1:] if a != "--sweep"]
    if "--sweep" in sys.argv:
        sweep(paths[0] if paths else SWEEP_YAML)
    else:
        launch_main(Config.load(paths[0] if paths else DEFAULT_YAML))
