"""Host data path: loaders, sharding, device prefetch, dataset sources,
augmentation (the port of ``torchbooster_tpu/data``)."""
from torchbooster_tpu_torch.data.pipeline import (
    DataLoader,
    ShardedIterable,
    SizedIterable,
    default_collate,
    prefetch_to_device,
)
from torchbooster_tpu_torch.data.sources import (
    register_dataset,
    resolve_dataset,
)
from torchbooster_tpu_torch.data.tokenizer import ByteTokenizer
from torchbooster_tpu_torch.data.transforms import Augment

__all__ = [
    "Augment", "ByteTokenizer", "DataLoader", "ShardedIterable",
    "SizedIterable", "default_collate", "prefetch_to_device",
    "register_dataset", "resolve_dataset",
]
