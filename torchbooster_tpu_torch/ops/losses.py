"""Loss functions — the port of ``torchbooster_tpu/ops/losses.py``. All
reduce to scalar means and compute in fp32, whatever the input dtype.
Plain PyTorch: the JAX package has no kernel here."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         label_smoothing: float) -> torch.Tensor:
    """Per-token smoothed negative log-likelihood, in fp32."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(-1, labels[..., None].long())[..., 0]
    if label_smoothing:
        smooth = -log_probs.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Softmax cross entropy with integer labels (+ label smoothing)."""
    return _nll(logits, labels, label_smoothing).mean()


def lm_head_cross_entropy(hidden: torch.Tensor, table: torch.Tensor,
                          labels: torch.Tensor,
                          label_smoothing: float = 0.0,
                          chunk_size: int = 4096) -> torch.Tensor:
    """Mean cross-entropy of ``hidden @ table.T`` against ``labels``
    without keeping the (T, vocab) logits alive: tokens stream through
    the head ``chunk_size`` at a time, and each chunk's logits are
    recomputed in backward (``torch.utils.checkpoint``), so the peak is
    one (chunk, vocab) block. Same math as :func:`cross_entropy` on the
    full logits; the mean is over the true token count.

    ``hidden``: (..., d); ``table``: (vocab, d) (an embedding table, or
    an untied head kernel transposed)."""
    d = hidden.shape[-1]
    x2 = hidden.reshape(-1, d)
    y = labels.reshape(-1)
    t = x2.shape[0]

    def chunk_nll(xc: torch.Tensor, yc: torch.Tensor,
                  tab: torch.Tensor) -> torch.Tensor:
        logits = xc @ tab.to(xc.dtype).T
        return _nll(logits, yc, label_smoothing).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, t, chunk_size):
        part = slice(start, start + chunk_size)
        if torch.is_grad_enabled():
            total = total + checkpoint(chunk_nll, x2[part], y[part], table,
                                       use_reentrant=False)
        else:
            total = total + chunk_nll(x2[part], y[part], table)
    return total / t


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy from logits."""
    logits, targets = logits.float(), targets.float()
    return torch.mean(logits.clamp_min(0.0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - target.float()))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return 0.5 * mse_loss(pred, target)


__all__ = ["bce_with_logits", "cross_entropy", "l2_loss",
           "lm_head_cross_entropy", "mse_loss"]
