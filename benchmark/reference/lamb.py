"""LAMB (You et al., arXiv:1904.00962) as the paper's trainer configures it:
no bias correction, eps after the square root, the weight norm clamped to
[0, 10], a trust ratio of 1 where either norm is 0, one ratio a tensor."""
from __future__ import annotations

from typing import Dict

import torch


@torch.no_grad()
def lamb_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict[str, Dict[str, torch.Tensor]], lr: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 0.0,
              clamp_norm: float = 10.0) -> None:
    """One update of every tensor of `params` in place; `state` holds each
    tensor's first and second moments ("m", "v"), made on the first call."""
    for name, p in params.items():
        g = grads[name]
        st = state.setdefault(name, {"m": torch.zeros_like(p), "v": torch.zeros_like(p)})
        st["m"] = b1 * st["m"] + (1.0 - b1) * g
        st["v"] = b2 * st["v"] + (1.0 - b2) * g * g
        step = st["m"] / (st["v"].sqrt() + eps) + weight_decay * p
        w_norm = p.norm().clamp(0.0, clamp_norm)
        s_norm = step.norm()
        trust = torch.where((w_norm == 0) | (s_norm == 0), torch.ones_like(w_norm),
                            w_norm / s_norm)
        p -= lr * trust * step
