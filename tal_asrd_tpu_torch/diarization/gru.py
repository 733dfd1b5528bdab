"""Multi-layer GRU for UIS-RNN.

Counterpart of tal_asrd_tpu/diarization/gru.py, whose gate maths is
torch.nn.GRU's:
    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h
so `GRU` runs `nn.GRU` (cuDNN on the card) with the flax leaves carried
across: `layer_{i}_wi_kernel [D, 3H]` is `weight_ih_l{i}` transposed,
`layer_{i}_wh_kernel [H, 3H]` `weight_hh_l{i}`, the biases `bias_ih_l{i}`
and `bias_hh_l{i}` as they are (the [r|z|n] blocks in the same order).

The reference's GRU takes a per-step mask, and a masked step keeps the
carried state. UIS-RNN only ever masks a suffix (`pack_batch`: each row is
real up to its length, then zero padding), and no output after a row's
length reaches the loss (the truth there is 0, so the prediction is
multiplied by 0) or the beam search (which steps without a mask). So `GRU`
takes no mask: its outputs past a row's length differ from the reference's,
and nothing reads them. `gru_loop`, the plain cell loop, keeps the
reference's masked semantics for any mask.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def gru_cell(x, h, wi_k, wi_b, wh_k, wh_b):
    """One GRU step. x [B, D], h [B, H]; kernels [D, 3H] / [H, 3H] (flax
    layout), biases [3H]."""
    gi = x @ wi_k + wi_b
    gh = h @ wh_k + wh_b
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_loop(params: Dict[str, torch.Tensor], x: torch.Tensor, depth: int,
             h0: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's stacked GRU step by step from its flax leaves
    (`layer_{i}_w{i,h}_{kernel,bias}`): x [B, T, D], h0 [depth, B, H],
    mask [B, T] (True = real step; a masked step keeps the carried state)
    -> (outputs [B, T, H], final states [depth, B, H])."""
    b, t, _ = x.shape
    h_sz = params["layer_0_wh_kernel"].shape[0]
    if h0 is None:
        h0 = x.new_zeros((depth, b, h_sz))
    out, finals = x, []
    for li in range(depth):
        leaves = [params[f"layer_{li}_{n}"] for n in
                  ("wi_kernel", "wi_bias", "wh_kernel", "wh_bias")]
        h, ys = h0[li], []
        for s in range(t):
            h_new = gru_cell(out[:, s], h, *leaves)
            if mask is not None:
                h_new = torch.where(mask[:, s, None], h_new, h)
            h = h_new
            ys.append(h)
        out = torch.stack(ys, dim=1)
        finals.append(h)
    return out, torch.stack(finals, dim=0)


class GRUCell(nn.Module):
    """One GRU step with its own leaves in flax's layout (`wi_kernel`
    [D, 3H], `wi_bias`, `wh_kernel` [H, 3H], `wh_bias`), kept for the
    reference's API; zero-initialised (load the leaves to use it)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.wi_kernel = nn.Parameter(torch.zeros(input_size, 3 * hidden_size))
        self.wi_bias = nn.Parameter(torch.zeros(3 * hidden_size))
        self.wh_kernel = nn.Parameter(torch.zeros(hidden_size, 3 * hidden_size))
        self.wh_bias = nn.Parameter(torch.zeros(3 * hidden_size))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return gru_cell(x, h, self.wi_kernel, self.wi_bias, self.wh_kernel, self.wh_bias)


class GRU(nn.Module):
    """Stacked GRU over [B, T, D] (batch first) from an initial state
    [depth, B, H] (zeros if None) -> (outputs [B, T, H], final states
    [depth, B, H])."""

    def __init__(self, input_size: int, hidden_size: int, depth: int = 1):
        super().__init__()
        self.hidden_size = hidden_size
        self.depth = depth
        self.rnn = nn.GRU(input_size, hidden_size, depth, batch_first=True)

    def forward(self, x: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.rnn(x, h0)


def gru_leaf_names(depth: int):
    """(flax leaf, nn.GRU parameter, transposed) of each GRU leaf."""
    out = []
    for i in range(depth):
        out += [(f"layer_{i}_wi_kernel", f"weight_ih_l{i}", True),
                (f"layer_{i}_wi_bias", f"bias_ih_l{i}", False),
                (f"layer_{i}_wh_kernel", f"weight_hh_l{i}", True),
                (f"layer_{i}_wh_bias", f"bias_hh_l{i}", False)]
    return out


def gru_params_to_state_dict(tree: dict, depth: int) -> Dict[str, torch.Tensor]:
    """The reference GRU's flax leaves -> nn.GRU's state_dict."""
    out = {}
    for leaf, name, t in gru_leaf_names(depth):
        a = np.array(tree[leaf], dtype=np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(a.T) if t else a)
    return out


def gru_state_dict_to_params(sd: Dict[str, torch.Tensor], depth: int) -> dict:
    """nn.GRU's state_dict -> the reference GRU's flax leaves (numpy f32)."""
    out = {}
    for leaf, name, t in gru_leaf_names(depth):
        a = sd[name].detach().cpu().numpy()
        out[leaf] = np.ascontiguousarray(a.T if t else a)
    return out
