"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of
    every entry point) requires a card: there is no silent CPU
    fallback — the CPU runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain "
            "PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    return dev


def seeded(seed: int | torch.Generator) -> torch.Generator:
    """``seed`` itself when it is a ``torch.Generator``, else a CPU
    generator seeded with it (the models' ``init`` draws on the CPU)."""
    return seed if isinstance(seed, torch.Generator) \
        else torch.Generator().manual_seed(int(seed))


def tree_to(tree, device: torch.device):
    """A nested dict of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


__all__ = ["resolve_device", "seeded", "tree_to"]
