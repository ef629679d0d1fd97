"""Build the port's CUDA kernels from this package's sources at first
use and bind them with ``ctypes``.

Each ``csrc/*.cu`` file exposes a plain C interface (no PyTorch
headers, so ``nvcc`` takes seconds, not minutes) and is compiled for
``sm_90a`` into ``build/torch_ext/`` at the repository root — a
directory ``.gitignore`` lists. The library name carries a hash of the
source, of every header it includes with quotes (``csrc/*.cuh``) and of
the flags, so an edited source or header never loads a stale build.
Nothing here runs at import time: the CPU test suite imports every
module on a machine with no ``nvcc``. A failed build raises; there is
no fall-back to the plain PyTorch version."""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}   # source name -> nvcc wall time
ptxas_info: dict[str, str] = {}        # source name -> `-Xptxas -v` output


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: list[Path]) -> list[Path]:
    """``path`` and, depth first, every file it includes with quotes
    (resolved beside the including file, as ``nvcc`` does), each once."""
    if path not in seen:
        seen.append(path)
        for inc in _QUOTED_INCLUDE.findall(path.read_text()):
            _sources(path.parent / inc, seen)
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu", []):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    ptxas_info[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it first)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib


__all__ = ["BUILD_DIR", "build", "build_seconds", "library_path", "load",
           "ptxas_info"]
