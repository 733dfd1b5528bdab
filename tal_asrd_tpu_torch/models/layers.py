"""A dense layer that computes in the dtype of its input.

flax's `Dense(dtype=bf16)` keeps its parameters in float32 and casts them,
with its input, to bf16 for the product; the reference trains that way. This
`Linear` does the same: its weight and bias are cast to the input's dtype
(a no-op when they already have it, as in bf16 serving), so one set of f32
parameters serves an f32 or a bf16 forward, and the gradient flows back to
the f32 parameters through the cast.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """`nn.Linear` (same parameters, same state_dict keys) whose weight and
    bias follow the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)
