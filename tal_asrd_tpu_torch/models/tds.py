"""Time-Depth-Separable (TDS) convolutional acoustic encoder.

Counterpart of tal_asrd_tpu/models/tds.py. Structure: 3 groups; each opens
with a stride-2 grouped conv (kernel 21, VALID, groups = n_mels) that changes
the channel count along the plan [80, 800, 1120, 1440], followed by `depth`
TDSBlocks (kernel 21, SAME). Total time reduction 8x. Residuals are
ReZero-gated: one scalar `resweight` (init 0) per block gates both the conv
and the feed-forward residual.

Activations are [B, T, C] and every layer computes in their dtype (f32
parameters train under bf16 compute: models/layers.py). Construction leaves
the modules in eval mode, as serving wants them; `.train()` turns on the
three dropouts of each block. With `remat=True` each block's activations are
recomputed in the backward pass (`torch.utils.checkpoint`), trading compute
for the memory the encoder dominates in training.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tal_asrd_tpu_torch.models.layers import Linear
from tal_asrd_tpu_torch.ops.grouped_conv import GroupedConv1D


class TDSBlock(nn.Module):
    """Grouped conv (k, SAME) -> ReLU -> dropout, then pointwise
    feed-forward (1x1 conv, ReLU, dropout, 1x1 conv, dropout); both residuals
    scaled by `resweight`. The 1x1 convs are `Linear` on [B, T, C]."""

    def __init__(self, hidden: int, kernel: int, groups: int,
                 dropout: float = 0.1):
        super().__init__()
        self.resweight = nn.Parameter(torch.zeros(()))
        self.conv = GroupedConv1D(hidden, hidden, kernel, groups, padding="SAME")
        self.fc1 = Linear(hidden, hidden)
        self.fc2 = Linear(hidden, hidden)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rw = self.resweight.to(x.dtype)
        x = x + rw * self.drop(F.relu(self.conv(x)))
        h = self.drop(F.relu(self.fc1(x)))
        h = self.drop(self.fc2(h))
        return x + rw * h


class TDS(nn.Module):
    """Full TDS encoder. `stage` selects 'all', 'extract' (the first
    `extract_groups` groups) or 'aggregate' (the rest)."""

    def __init__(self, input_size: int, sizes: Sequence[int],
                 depths: Sequence[int], kernel: int = 21, dropout: float = 0.1,
                 extract_groups: int = 1, remat: bool = False):
        super().__init__()
        self.input_size = input_size
        self.sizes = tuple(sizes)
        self.depths = tuple(depths)
        self.extract_groups = extract_groups
        self.remat = remat
        for gi in range(len(self.sizes) - 1):
            setattr(self, f"down_{gi}", GroupedConv1D(
                self.sizes[gi], self.sizes[gi + 1], kernel, input_size,
                stride=2, padding="VALID"))
            for bi in range(self.depths[gi]):
                setattr(self, f"group_{gi}_block_{bi}", TDSBlock(
                    self.sizes[gi + 1], kernel, input_size, dropout))
        self.eval()

    def forward(self, x: torch.Tensor, stage: str = "all") -> torch.Tensor:
        """x: [B, T, n_mels] -> [B, ~T/8, sizes[-1]]."""
        n_groups = len(self.sizes) - 1
        if stage == "extract":
            groups = range(0, self.extract_groups)
        elif stage == "aggregate":
            groups = range(self.extract_groups, n_groups)
        elif stage == "all":
            groups = range(n_groups)
        else:
            raise ValueError(f"unknown stage {stage!r}")
        for gi in groups:
            x = getattr(self, f"down_{gi}")(x)
            for bi in range(self.depths[gi]):
                block = getattr(self, f"group_{gi}_block_{bi}")
                if self.remat and self.training and torch.is_grad_enabled():
                    # the saved RNG state replays each dropout mask exactly
                    x = checkpoint(block, x, use_reentrant=False)
                else:
                    x = block(x)
        return x


def tds_output_length(t: int, n_groups: int = 3, kernel: int = 21) -> int:
    """Output frame count of the encoder for input length t: each group
    applies one VALID stride-2 conv, t -> (t - kernel) // 2 + 1."""
    for _ in range(n_groups):
        t = (t - kernel) // 2 + 1
    return t
