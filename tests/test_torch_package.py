"""Package guards of ``torchbooster_tpu_torch``.

- importing every module of the port loads neither ``jax`` nor anything
  of ``torchbooster_tpu`` nor PyYAML nor ``transformers`` nor
  ``datasets``, PIL or ``lmdb`` (the card's machine lacks them), runs no
  recipe and starts neither ``nvcc`` nor ``g++`` (kernels and the native
  record store build at first use, never at import);
- ``chip_smoke.py`` refuses to run without a CUDA card: non-zero exit and
  no result line;
- every name a JAX module exports (its ``__all__``) exists on the port
  module of the same path, but for a stated list of exemptions, each
  with its reason (C8: the package surface).
"""
import importlib
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_GUARD = r"""
import importlib, json, pkgutil, subprocess, sys
started = []
_popen_init = subprocess.Popen.__init__
def _record(self, args, *a, **kw):
    started.append(str(args))
    return _popen_init(self, args, *a, **kw)
subprocess.Popen.__init__ = _record
import torchbooster_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from torchbooster_tpu_torch.ops import _build
print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "jax_pkg": sorted(m for m in sys.modules if m == "torchbooster_tpu"
                      or m.startswith("torchbooster_tpu.")),
    "yaml": sorted(m for m in sys.modules if m == "yaml"),
    "transformers": sorted(m for m in sys.modules if m == "transformers"
                           or m.startswith("transformers.")),
    "scipy": sorted(m for m in sys.modules if m == "scipy"),
    "lazy": sorted(m for m in sys.modules
                   if m.split(".")[0] in ("datasets", "PIL", "lmdb")),
    "nvcc": [a for a in started if "nvcc" in a],
    "gxx": [a for a in started if "g++" in a],
    "built": sorted(_build.build_seconds),
}))
"""


def test_port_imports_neither_jax_nor_the_jax_package_nor_nvcc():
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "torchbooster_tpu_torch.serving.engine" in got["modules"]
    assert "torchbooster_tpu_torch.ops.paged_attention" in got["modules"]
    for name in ("ops.flash_attention", "ops.losses", "utils", "scheduler",
                 "metrics", "dataset", "data.sources", "data.pipeline",
                 "recipes.gpt", "ops.group_norm", "ops.fused_block",
                 "models.layers", "models.resnet", "data.transforms",
                 "recipes.resnet", "interop", "optim",
                 "models.torch_interop", "models.quant",
                 "serving.adapters", "serving.structured",
                 "serving.structured.compiler",
                 "serving.structured.state", "comms", "comms.accounting",
                 "serving.disagg", "serving.router", "serving.router.rpc",
                 "observability", "observability.spans",
                 "observability.export", "observability.device",
                 "observability.slo", "serving.frontend",
                 "serving.frontend.http", "serving.frontend.server",
                 "serving.loadgen", "serving.loadgen.workload",
                 "serving.loadgen.report", "serving.loadgen.replay",
                 "serving.router.audit", "serving.router.directory",
                 "serving.router.routing", "serving.router.health",
                 "serving.router.replica", "serving.router.fleet",
                 "serving.replica_server", "store", "lmdb_compat",
                 "data.idx", "data.cifar", "data.folder", "distributed",
                 "parallel", "parallel.sharding", "comms.quantized",
                 "comms.zero", "comms.schedule", "models.moe",
                 "parallel.ring", "parallel.ulysses", "parallel.pipeline",
                 "serving.tp", "models.lenet", "models.vgg",
                 "recipes.lenet", "ops.diffusion", "models.unet",
                 "models.vae", "models.gan", "models.stylenet",
                 "recipes.ddpm", "recipes.vae", "recipes.gan",
                 "recipes.offline", "recipes.online", "recipes.adain"):
        assert f"torchbooster_tpu_torch.{name}" in got["modules"]
    assert got["jax"] == [] and got["jax_pkg"] == [] and got["yaml"] == []
    # the GPT-2 import reads a state dict; it never imports transformers
    assert got["transformers"] == []
    # scipy (the rotation augmentation) is imported when a transform is
    # built, not at import
    assert got["scipy"] == []
    # the data path imports its optional readers where they are used
    assert got["lazy"] == []
    assert got["nvcc"] == [] and got["built"] == [] and got["gxx"] == []


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script runs for real there")
    # alone in a directory, and from the repository root: both must fail
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    for cwd, script in ((tmp_path, alone), (ROOT, ROOT / "chip_smoke.py")):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


# JAX names with no port counterpart of the same name, each with why.
# Where the port answers the need another way, the reason names it.
XLA_ONLY = "an XLA sharding or jit object; the port has no XLA"
EXEMPT_NAMES = {
    "models.gpt.batch_spec": f"{XLA_ONLY}: the batch's PartitionSpec; the "
    "port keeps a rank's block with distributed.shard_batch",
    "comms.quantized.data_spec": f"{XLA_ONLY}: the flat vector's "
    "PartitionSpec; the port's ranks hold their chunk of it "
    "(comms.quantized.ravel)",
    "distributed.batch_sharding": f"{XLA_ONLY}: a NamedSharding; "
    "distributed.shard_batch and batch_rows place the rows",
    "distributed.replicated": f"{XLA_ONLY}: a NamedSharding; "
    "distributed.to_env broadcasts rank 0's tree",
    "parallel.sharding.is_param_shaped": "matches optax state pytrees to "
    "the params; parallel.sharding.shard_state cuts the torch optimizer's "
    "per-parameter state by shape instead",
    "serving.tp.POOL_SPEC": f"{XLA_ONLY}: the page pool's PartitionSpec; "
    "each port rank allocates its kv_heads/tp heads (serving.tp.local_cfg)",
    "serving.tp.shard_engine_fn": f"{XLA_ONLY}: wraps an engine step in "
    "shard_map and jit; the port's engine runs eagerly on each rank",
    "observability.device.cost_analysis": "reads an XLA Compiled object; "
    "observability.device.flop_count counts a call's FLOPs",
    "observability.device.xla_flops": "reads an XLA Compiled object; "
    "observability.device.flop_count counts a call's FLOPs",
    "observability.cost_analysis": "re-export of "
    "observability.device.cost_analysis (above)",
    "observability.xla_flops": "re-export of observability.device."
    "xla_flops (above)",
    "ops.fused_block.fits": "the TPU's VMEM budget for a B7 call; the "
    "tiled CUDA kernels have none (models.resnet._use_fused)",
    "ops.fused_block.fits3": "the TPU's VMEM budget for a B8 call; the "
    "tiled CUDA kernels have none (models.resnet._use_fused)",
    "models.gpt.jit_generate": "ROADMAP A-8: not ported yet",
}
EXEMPT_MODULES = {
    "_jax_compat": "JAX-version shims; the port imports no JAX",
    "ops._pallas_util": "Pallas helpers; the port's kernels are CUDA C++ "
    "built by ops/_build.py",
}


def test_port_exports_every_name_the_jax_package_exports():
    """C8: walk every module of the JAX package; each name of its
    ``__all__`` must be an attribute of the port module at the same path
    (``torchbooster_tpu.X`` ↔ ``torchbooster_tpu_torch.X``), unless
    exempted above with its reason. An exemption the port has caught up
    with fails too, so the lists shrink as slices land."""
    import torchbooster_tpu as jpkg

    missing, stale = [], []
    for info in pkgutil.walk_packages(jpkg.__path__, "torchbooster_tpu."):
        rel = info.name[len("torchbooster_tpu."):]
        jmod = importlib.import_module(info.name)
        try:
            port = importlib.import_module(f"torchbooster_tpu_torch.{rel}")
        except ModuleNotFoundError:
            if rel not in EXEMPT_MODULES:
                missing.append(rel)
            continue
        if rel in EXEMPT_MODULES:
            stale.append(rel)
        for name in getattr(jmod, "__all__", ()):
            key = f"{rel}.{name}"
            if not hasattr(port, name):
                if key not in EXEMPT_NAMES and rel not in EXEMPT_MODULES:
                    missing.append(key)
            elif key in EXEMPT_NAMES:
                stale.append(key)
    assert missing == [], f"names the port lacks: {missing}"
    assert stale == [], f"exempted but present in the port: {stale}"
    assert all(EXEMPT_NAMES.values()) and all(EXEMPT_MODULES.values())


def test_package_surface_c8_names():
    """C8's names import from the package paths the JAX recipes use, and
    the port's package carries JAX's version and logging bootstrap
    (``TORCHBOOSTER_NO_LOG_SETUP=1`` leaves the root logger alone)."""
    import torchbooster_tpu
    import torchbooster_tpu_torch as pkg
    from torchbooster_tpu_torch import config, ops, serving
    from torchbooster_tpu_torch.models import (  # noqa: F401
        GAN,
        GPT,
        VAE,
        LeNet,
        ResNet,
        StyleNet,
        UNet,
        VGGFeatures,
        layers,
    )
    from torchbooster_tpu_torch.ops.attention import attention

    assert pkg.__version__ == torchbooster_tpu.__version__
    assert ops.attention is attention and callable(ops.paged_attention)
    assert serving.ServingFrontend.__name__ == "ServingFrontend"
    assert {"FCFSPolicy", "SLOPolicy", "PriorityClass",
            "SchedulerPolicy"} <= set(serving.__all__)
    assert config.EnvironementConfig is config.EnvConfig
    assert config.do_include("  #include base.yml ") == "base.yml"
    assert config.do_include("lr: 1e-3") is None
    code = ("import logging, torchbooster_tpu_torch; "
            "print(len(logging.getLogger().handlers))")
    for env, want in (({"TORCHBOOSTER_NO_LOG_SETUP": "1"}, "0"), ({}, "1")):
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
            text=True, timeout=300,
            env={k: v for k, v in __import__("os").environ.items()
                 if k != "TORCHBOOSTER_NO_LOG_SETUP"} | env)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip().splitlines()[-1] == want, env
