"""Serving configuration — the port of ``ServingConfig``
(``torchbooster_tpu/config.py:1046``) with its core fields, a
single-replica :meth:`ServingConfig.make`, and a small YAML loader for
a ``serving:`` block. The JAX package's full ``Config`` system
(``#include``, sweeps) and the router/disagg/front-door sub-blocks wait
for later slices (``ROADMAP.md`` A2, A7)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


@dataclass
class ServingConfig:
    """Paged KV geometry and sampling knobs of the continuous-batching
    loop (field meanings as in the JAX package). ``decode_backend``:
    ``""`` picks the CUDA kernel on the card and the pool sweep on the
    CPU; ``"kernel"`` or ``"sweep"`` force one. Options of the JAX
    engine that are not ported yet (``speculative``, ``spec_tree``,
    ``parallel_sampling``, ``tp > 1``) raise ``NotImplementedError``
    when enabled."""

    page_size: int = 64
    n_pages: int = 256
    max_slots: int = 8
    cache_dtype: str = ""              # "" (compute dtype) | "int8"
    temperature: float = 0.0           # 0 = greedy
    top_k: int = 0                     # 0 = off
    top_p: float = 0.0                 # 0 = off
    prefix_cache: bool = False
    prefill_chunk_pages: int = 4
    speculative: bool = False
    draft_len: int = 4
    ngram_min: int = 2
    spec_tree: bool = False
    spec_tree_width: int = 2
    parallel_sampling: bool = False
    decode_backend: str = ""           # "" auto | "kernel" | "sweep"
    tp: int = 1
    seed: int = 0                      # sampling generator seed

    @classmethod
    def from_dict(cls, data: dict | None) -> "ServingConfig":
        """Build from a ``serving:`` mapping; unknown keys are loud
        (a typo must not silently serve the default)."""
        data = dict(data or {})
        names = {f.name: f for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - set(names))
        if unknown:
            raise ValueError(f"unknown serving keys {unknown}; known: "
                             f"{sorted(names)}")
        kw = {}
        for key, value in data.items():
            kind = names[key].type
            if kind == "bool":
                if not isinstance(value, bool):
                    raise TypeError(f"serving.{key} must be true/false, "
                                    f"got {value!r}")
                kw[key] = value
            elif kind == "int":
                kw[key] = int(str(value).replace("_", ""))
            elif kind == "float":
                kw[key] = float(value)   # PyYAML reads 1e-3 as a string
            else:
                kw[key] = "" if value is None else str(value)
        return cls(**kw)

    @classmethod
    def load(cls, path: str | Path) -> "ServingConfig":
        """Read the ``serving:`` block of a YAML file (or the whole
        file when it has no such block)."""
        import yaml

        data = yaml.safe_load(Path(path).read_text()) or {}
        return cls.from_dict(data.get("serving", data))

    def make(self, params: dict, model_cfg: Any,
             compute_dtype: torch.dtype | str | None = None,
             on_recompile: str = "warn",
             device: str | torch.device = "cuda",
             tracer: Any = None):
        """Build the engine and its batcher (the single-replica branch
        of the JAX ``make``); returns the
        :class:`~torchbooster_tpu_torch.serving.ContinuousBatcher`.
        ``compute_dtype`` defaults to bf16."""
        from torchbooster_tpu_torch.serving import (
            ContinuousBatcher,
            PagedEngine,
        )

        if isinstance(compute_dtype, str):
            compute_dtype = _DTYPES[compute_dtype]
        engine = PagedEngine(
            params, model_cfg, page_size=self.page_size,
            n_pages=self.n_pages, max_slots=self.max_slots,
            cache_dtype=self.cache_dtype or None,
            compute_dtype=compute_dtype or torch.bfloat16,
            temperature=self.temperature, top_k=self.top_k or None,
            top_p=self.top_p or None, seed=self.seed,
            prefix_cache=self.prefix_cache,
            prefill_chunk_pages=self.prefill_chunk_pages,
            decode_backend=self.decode_backend or None, tp=self.tp,
            speculative=self.speculative, spec_tree=self.spec_tree,
            parallel_sampling=self.parallel_sampling, device=device)
        return ContinuousBatcher(engine, on_recompile=on_recompile,
                                 tracer=tracer)


__all__ = ["ServingConfig"]
