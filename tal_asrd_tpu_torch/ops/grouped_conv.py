"""Grouped 1-D convolution on [B, T, C] activations.

Counterpart of tal_asrd_tpu/ops/grouped_conv.py `GroupedConv1D`. The TDS
encoder's convolutions are n_mels-group convs with 1-18 channels per group.
The reference computed them with XLA outside any hand-written kernel (its
three lowerings `xla / packed / tap` were TPU tuning and are not ported), so
here they are one `F.conv1d(groups=G)`.

Activations keep the reference's [B, T, C] layout at the module boundary
(the transpose to PyTorch's [B, C, T] happens inside). The weight is stored
in PyTorch's conv layout [C_out, C_in / G, K]; core/convert.py permutes the
reference's [K, C_in / G, C_out] into it. The weight and bias are cast to
the input's dtype, so f32 parameters can train under bf16 compute.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tal_asrd_tpu_torch.models.layers import lecun_normal_


class GroupedConv1D(nn.Module):
    """Grouped conv with 'SAME' (odd kernels pad (k-1)/2 on both sides, e.g.
    (10, 10) for k=21) or 'VALID' padding and a stride."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 groups: int, stride: int = 1, padding: str = "SAME",
                 use_bias: bool = True):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        if in_features % groups or features % groups:
            raise ValueError(
                f"groups {groups} must divide in_features {in_features} and "
                f"features {features}")
        if padding == "SAME" and stride != 1:
            raise NotImplementedError("SAME padding is implemented for stride 1")
        self.kernel = kernel
        self.groups = groups
        self.stride = stride
        self.padding = padding
        c_pg = in_features // groups
        self.weight = nn.Parameter(torch.empty(features, c_pg, kernel))
        # lecun_normal, as the reference: fan_in = kernel * c_in_per_group
        lecun_normal_(self.weight, kernel * c_pg)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, C_in] -> [B, T_out, C_out]."""
        x = x.transpose(1, 2)
        if self.padding == "SAME":
            lo = (self.kernel - 1) // 2
            x = F.pad(x, (lo, self.kernel - 1 - lo))
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv1d(x, self.weight.to(x.dtype), bias, stride=self.stride,
                     groups=self.groups)
        return y.transpose(1, 2)
