"""PyTorch/CUDA port of torchbooster_tpu.

The package mirrors the JAX package's module paths
(``torchbooster_tpu/serving/engine.py`` ↔
``torchbooster_tpu_torch/serving/engine.py``) and exports the same names
from each (``tests/test_torch_package.py`` walks every ``__all__``). It
imports neither JAX nor anything of ``torchbooster_tpu``: it keeps its
own copies of what it needs. Every TPU kernel becomes a kernel written by
hand for Hopper (``sm_90a``, ``ops/csrc/``), built from this package's
sources at first use — never at import — and held to a plain PyTorch
version that lives beside it.

What runs: YAML configs and sweeps; GPT training (``recipes/gpt.py``)
and paged GPT serving (``ServingConfig.make``) with every engine feature,
the HTTP front door and the engine fleet; the image classifiers ResNet
(GroupNorm, frozen-BN ``"affine"`` imports of torchvision state dicts and
the norm-free ``"ws"`` variant), LeNet and the VGG feature extractor,
with the lenet and resnet recipes; the data path; and the mesh axes
``dp``, ``fsdp``, ``sp``, ``ep``, ``tp`` and ``pp`` across processes.

Entry points (``GPT.init``, ``ResNet.init``, ``PagedEngine``,
``ServingConfig.make``, the recipes' ``main``) run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``; with no
card and no explicit CPU device they raise.

Importing the package sets up logging as the JAX package does: INFO to
the root logger (through ``coloredlogs`` when it is installed), only when
the root logger has no handler yet, and not at all under
``TORCHBOOSTER_NO_LOG_SETUP=1``.
"""
from __future__ import annotations

import logging
import os


def _setup_logging() -> None:
    """Import-time logging, only into a root logger that has no handler
    yet and not under ``TORCHBOOSTER_NO_LOG_SETUP=1`` (JAX
    ``__init__.py:22-43``)."""
    if os.environ.get("TORCHBOOSTER_NO_LOG_SETUP", "").strip().lower() \
            in ("1", "true", "yes"):
        return
    if logging.getLogger().handlers:
        return
    try:
        import coloredlogs  # type: ignore

        coloredlogs.install(level=logging.INFO)
    except ImportError:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s[%(process)d] %(levelname)s "
                   "%(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        )


_setup_logging()

__version__ = "0.1.0"
