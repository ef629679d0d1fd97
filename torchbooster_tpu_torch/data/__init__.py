"""Host data path: the single-process loader and the builtin dataset
registry (the port of ``torchbooster_tpu/data``)."""
from torchbooster_tpu_torch.data.pipeline import DataLoader, default_collate
from torchbooster_tpu_torch.data.sources import (
    register_dataset,
    resolve_dataset,
)
from torchbooster_tpu_torch.data.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "DataLoader", "default_collate",
           "register_dataset", "resolve_dataset"]
