"""Parallelism over the data axes — the port of
``torchbooster_tpu/parallel``'s ``sharding.py``. A mesh names axes over
the ranks (``distributed.make_mesh``): ``dp`` replicates parameters and
splits the batch, ``fsdp`` splits the batch and shards the parameters
that the rule table names. The model axes (``tp``, ``sp``, ``pp``,
``ep``) with ring and Ulysses attention and the pipeline schedule are
not ported yet (``ROADMAP.md`` A-5b)."""
from torchbooster_tpu_torch.parallel.sharding import (
    P,
    make_param_specs,
    make_shardings,
    make_state_specs,
    path_str,
    shard_params,
    shard_state,
)

__all__ = ["P", "make_param_specs", "make_shardings", "make_state_specs",
           "path_str", "shard_params", "shard_state"]
