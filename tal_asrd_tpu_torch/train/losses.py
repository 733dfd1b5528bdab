"""Loss functions of training.

Counterpart of tal_asrd_tpu/train/losses.py. Label smoothing puts weight
smoothing/(V-1) on every other token and 1-smoothing on the target; the
smoothed loss is masked per position before the mean, as the reference's.
Softmax and losses run in float32 whatever the logits' dtype.
"""
from __future__ import annotations

import torch


def log_softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                              smoothing: float = 0.0) -> torch.Tensor:
    """Per-position (label-smoothed) cross entropy, float32: logits
    [..., V], targets [...] int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    if smoothing == 0.0:
        return nll
    off = smoothing / (logits.shape[-1] - 1.0)
    # -(w * logp).sum = -[(1-s) * logp_t + off * (sum(logp) - logp_t)]
    return (1.0 - smoothing - off) * nll - off * logp.sum(dim=-1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the positions where mask is true."""
    m = mask.to(torch.float32)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def masked_token_loss(logits: torch.Tensor, targets: torch.Tensor,
                      mask: torch.Tensor, smoothing: float = 0.0) -> torch.Tensor:
    """logits [B, L, V], targets [B, L], mask [B, L] true on real positions."""
    return masked_mean(log_softmax_cross_entropy(logits, targets, smoothing), mask)


def masked_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    return masked_mean((logits.argmax(dim=-1) == targets).to(torch.float32), mask)
