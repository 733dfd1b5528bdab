"""A dense layer that computes in the dtype of its input, and the initial
distribution of the reference's matrices.

flax's `Dense(dtype=bf16)` keeps its parameters in float32 and casts them,
with its input, to bf16 for the product; the reference trains that way. This
`Linear` does the same: its weight and bias are cast to the input's dtype
(a no-op when they already have it, as in bf16 serving), so one set of f32
parameters serves an f32 or a bf16 forward, and the gradient flows back to
the f32 parameters through the cast.

`lecun_normal_` draws what flax's `lecun_normal` initialiser draws:
`variance_scaling(1, "fan_in", "truncated_normal")`, a standard normal cut
at +-2 and scaled by 1 / (0.87962566 sqrt(fan_in)), so the std is
1 / sqrt(fan_in) and no value lies beyond 2.2737 / sqrt(fan_in).

A `Linear` that `parallel.tensor.parallelize` marks holds a shard of its
weight on the mesh's model axis: column-parallel ("col", output features)
or row-parallel ("row", input features; the partial products are summed
over the axis before the bias).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


# std of the standard normal truncated to [-2, 2]
TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill `t` in place with flax's lecun_normal for `fan_in`, drawn in f32
    on the CPU from `generator` (the global RNG if None), wherever t lives."""
    draw = torch.empty(t.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    draw *= 1.0 / (TRUNCATED_STD * math.sqrt(fan_in))
    return t.copy_(draw)


class Linear(nn.Linear):
    """`nn.Linear` (same parameters, same state_dict keys) whose weight and
    bias follow the input's dtype."""

    tp_mode: Optional[str] = None     # "col" | "row" on a tensor-parallel layer
    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.tp_mode is None:
            return F.linear(x, self.weight.to(x.dtype), bias)
        from tal_asrd_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model
        if self.tp_mode == "col":
            return F.linear(copy_to_model(x, self.tp_group), self.weight.to(x.dtype), bias)
        y = reduce_from_model(F.linear(x, self.weight.to(x.dtype)), self.tp_group)
        return y if bias is None else y + bias
