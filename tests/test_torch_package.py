"""Package guards of ``torchbooster_tpu_torch``.

- importing every module of the port loads neither ``jax`` nor anything
  of ``torchbooster_tpu`` nor PyYAML nor ``transformers`` nor
  ``datasets``, PIL or ``lmdb`` (the card's machine lacks them), runs no
  recipe and starts neither ``nvcc`` nor ``g++`` (kernels and the native
  record store build at first use, never at import);
- ``chip_smoke.py`` refuses to run without a CUDA card: non-zero exit and
  no result line.
"""
import json
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
                 "parallel.ring", "parallel.ulysses"):
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
