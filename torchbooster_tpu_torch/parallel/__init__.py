"""Parallelism over the mesh axes — the port of
``torchbooster_tpu/parallel``'s ``sharding.py``, ``ring.py`` and
``ulysses.py``. A mesh names axes over the ranks
(``distributed.make_mesh``): ``dp`` replicates parameters and splits the
batch, ``fsdp`` splits the batch and shards the parameters that the rule
table names, ``sp`` splits the sequence (attention through ring or
Ulysses, ``sequence_attention``) and ``ep`` the experts of MoE blocks.
The ``tp`` and ``pp`` axes with the pipeline schedule are not ported yet
(``ROADMAP.md`` A-5c)."""
from torchbooster_tpu_torch.parallel.ring import ring_attention
from torchbooster_tpu_torch.parallel.sharding import (
    P,
    make_param_specs,
    make_shardings,
    make_state_specs,
    path_str,
    shard_params,
    shard_state,
)
from torchbooster_tpu_torch.parallel.ulysses import (
    sequence_attention,
    ulysses_attention,
)

__all__ = ["P", "make_param_specs", "make_shardings", "make_state_specs",
           "path_str", "ring_attention", "sequence_attention",
           "shard_params", "shard_state", "ulysses_attention"]
