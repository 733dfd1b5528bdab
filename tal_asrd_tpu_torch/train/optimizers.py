"""LAMB with the reference's exact update rule.

Counterpart of tal_asrd_tpu/train/optimizers.py `lamb` (the optimizer the
reference trains with):

    m <- b1 m + (1 - b1) g ;  v <- b2 v + (1 - b2) g^2     (no bias correction)
    adam_step = m / (sqrt(v) + eps) + weight_decay * p     (eps after the sqrt)
    trust = clamp(||p||, 0, 10) / ||adam_step||, or 1 when either norm is 0
    p <- p - lr * trust * adam_step

with `always_adam` forcing trust to 1. `lr` is a number or a schedule
step -> lr; step counts the updates made before this one, so the first
update uses lr(0). RAdam, Adafactor and Lookahead are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Iterable, Union

import torch

LearningRate = Union[float, Callable[[int], float]]


class LAMB(torch.optim.Optimizer):
    """Per-parameter state: `step` (updates made), `exp_avg` (m) and
    `exp_avg_sq` (v), in the parameter's dtype."""

    def __init__(self, params: Iterable, lr: LearningRate, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 0.0,
                 always_adam: bool = False, clamp_weight_norm: float = 10.0):
        defaults = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                        always_adam=always_adam, clamp_weight_norm=clamp_weight_norm)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                lr = group["lr"]
                lr = lr(state["step"]) if callable(lr) else lr
                g = p.grad
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.copy_(b1 * m + (1.0 - b1) * g)
                v.copy_(b2 * v + (1.0 - b2) * (g * g))
                adam_step = m / (v.sqrt() + eps)
                if wd != 0.0:
                    adam_step = adam_step + wd * p
                if group["always_adam"]:
                    scale = torch.tensor(-lr, dtype=torch.float32, device=p.device)
                else:
                    w_norm = p.float().pow(2).sum().sqrt().clamp(
                        0.0, group["clamp_weight_norm"])
                    a_norm = adam_step.float().pow(2).sum().sqrt()
                    trust = torch.where((w_norm == 0.0) | (a_norm == 0.0),
                                        torch.ones_like(w_norm), w_norm / a_norm)
                    scale = -lr * trust
                p.add_((scale * adam_step).to(p.dtype))
                state["step"] += 1
        return loss
