"""ReZero transformer decoder with explicit attention-weight outputs and KV
caches.

Counterpart of tal_asrd_tpu/models/decoder.py; this is the unfused path that
the fused layer-step kernel (ops/cuda_decode.py) is held against.

  * Cross-attention weights are return values: every call returns (hidden,
    per-layer mean-over-heads attention weights).
  * Incremental decoding uses explicit caches: cross-attention K/V are
    computed once per encoder window; self-attention K/V live in a fixed-size
    buffer [B, L, H, dh] addressed by a step index. The buffer is UPDATED IN
    PLACE (the reference returns a fresh array per step); the returned cache
    dict holds the same tensors.
  * Attention logits and softmax run in float32; the rest follows the dtype
    of the activations (bfloat16 in production), to which every dense layer
    casts its parameters (models/layers.py), so f32 parameters can train
    under bf16 compute.
  * Dropout, active only in train() mode, sits where the reference has it:
    on the attention probabilities after the head mean is taken and before
    the PV product, and on each residual branch (two drops on the
    feed-forward path).

As in torch.nn.MultiheadAttention, returned attention weights are averaged
over heads, scaling is 1/sqrt(head_dim), and a key_padding_mask is True
where a key is ignored. `resweight` (init 0) gates the self-attention and
feed-forward residuals, `resweight_src` the cross-attention residual.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tal_asrd_tpu_torch.models.layers import Linear

NEG_INF = -1e9  # additive mask value; softmax runs in f32


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal table [max_len, d_model], float32 (built in float64)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(0, max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionalEncoding(nn.Module):
    """Adds the sinusoidal table from row `offset` on. The table is a
    non-persistent buffer: it follows `.to()` but is not a checkpoint key.
    An offset past the table is clamped as the reference's `dynamic_slice`
    clamps it: rows start at most at max_len - seq_len."""

    def __init__(self, d_model: int, max_len: int = 512, dropout: float = 0.1):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positions(max_len, d_model)),
            persistent=False)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        seq_len = x.shape[1]
        start = min(max(offset, 0), self.pe.shape[0] - seq_len)
        x = x + self.pe[start:start + seq_len].to(x.dtype)[None]
        return self.drop(x)


def _attend(
    q: torch.Tensor,  # [B, Tq, H, Dh]
    k: torch.Tensor,  # [B, Tk, H, Dh]
    v: torch.Tensor,  # [B, Tk, H, Dh]
    bias: Optional[torch.Tensor],  # additive [B or 1, 1 or H, Tq, Tk] in f32
    dropout: float = 0.0,
    training: bool = False,
    head_group=None,
    n_head: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled dot-product attention. Returns (out [B, Tq, H, Dh] in q's
    dtype, mean-over-heads weights [B, Tq, Tk] in float32). Logits are
    accumulated and soft-maxed in f32; the probabilities are cast to the
    value dtype for the weighted sum, which accumulates in f32. In training
    the probabilities are dropped after the head mean is taken, so the
    returned weights never carry dropout. With `head_group` the heads are
    this process's share of `n_head` and the mean is taken over all of
    them (parallel/tensor.py)."""
    dtype = q.dtype
    dh = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(dh)
    if bias is not None:
        logits = logits + bias
    weights = torch.softmax(logits, dim=-1)  # f32
    if head_group is None:
        mean_weights = weights.mean(dim=1)   # [B, Tq, Tk]
    else:
        from tal_asrd_tpu_torch.parallel.tensor import reduce_from_model
        mean_weights = reduce_from_model(weights.sum(dim=1), head_group) / n_head
    if training and dropout > 0.0:
        weights = F.dropout(weights, dropout, training=True)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(dtype).float(), v.float())
    return out.to(dtype), mean_weights


class SelfAttention(nn.Module):
    """Fused-QKV self-attention with an optional fixed-size KV cache. On a
    tensor-parallel model (`head_group` set) the projections hold this
    process's heads."""

    head_group = None

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.n_head = n_head
        self.dropout = dropout
        self.qkv = Linear(d_model, 3 * d_model)
        self.out_proj = Linear(d_model, d_model)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, D]
        *,
        causal: bool = True,
        cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: Optional[int] = None,
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, T] True = ignore
    ):
        b, t, _ = x.shape
        dh = self.d_model // self.n_head
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q = q.reshape(b, t, -1, dh)
        k = k.reshape(b, t, -1, dh)
        v = v.reshape(b, t, -1, dh)
        heads = dict(head_group=self.head_group, n_head=self.n_head)

        new_cache = None
        if cache is not None:
            # Incremental decode: write k/v at cache_index IN PLACE, attend
            # to positions <= cache_index + t - 1 of the fixed-size buffer.
            ck, cv = cache["k"], cache["v"]
            ck[:, cache_index:cache_index + t] = k.to(ck.dtype)
            cv[:, cache_index:cache_index + t] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv}
            pos = torch.arange(ck.shape[1], device=x.device)
            qpos = cache_index + torch.arange(t, device=x.device)
            bias = torch.where(pos[None, :] <= qpos[:, None], 0.0, NEG_INF)
            out, w = _attend(q, ck.to(q.dtype), cv.to(q.dtype), bias[None, None],
                             self.dropout, self.training, **heads)
        else:
            bias = None
            if causal:
                i = torch.arange(t, device=x.device)
                bias = torch.where(i[:, None] >= i[None, :], 0.0, NEG_INF)[None, None]
            if key_padding_mask is not None:
                kp = torch.where(key_padding_mask[:, None, None, :], NEG_INF, 0.0)
                bias = kp if bias is None else bias + kp
            out, w = _attend(q, k, v, bias, self.dropout, self.training, **heads)

        return self.out_proj(out.reshape(b, t, -1)), w, new_cache


class CrossAttention(nn.Module):
    """Encoder-decoder attention; memory K/V precomputable once per window.
    On a tensor-parallel model (`head_group` set) the projections hold this
    process's heads."""

    head_group = None

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.n_head = n_head
        self.dropout = dropout
        self.q = Linear(d_model, d_model)
        self.kv = Linear(d_model, 2 * d_model)
        self.out_proj = Linear(d_model, d_model)

    def precompute_kv(self, memory: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, s, _ = memory.shape
        dh = self.d_model // self.n_head
        k, v = self.kv(memory).chunk(2, dim=-1)
        return {"k": k.reshape(b, s, -1, dh), "v": v.reshape(b, s, -1, dh)}

    def forward(
        self,
        x: torch.Tensor,                        # [B, T, D]
        memory: Optional[torch.Tensor] = None,  # [B, S, D] (or None with mem_kv)
        *,
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] True = ignore
        mem_kv: Optional[Dict[str, torch.Tensor]] = None,
    ):
        b, t, _ = x.shape
        dh = self.d_model // self.n_head
        q = self.q(x).reshape(b, t, -1, dh)
        if mem_kv is None:
            mem_kv = self.precompute_kv(memory)
        bias = None
        if key_padding_mask is not None:
            bias = torch.where(key_padding_mask[:, None, None, :], NEG_INF, 0.0)
        out, w = _attend(q, mem_kv["k"], mem_kv["v"], bias, self.dropout,
                         self.training, head_group=self.head_group, n_head=self.n_head)
        return self.out_proj(out.reshape(b, t, -1)), w


class RZDecoderLayer(nn.Module):
    """ReZero decoder layer: x += sa*rw; x += ca*rw_src; x += ff*rw."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: int,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = SelfAttention(d_model, n_head, dropout)
        self.cross_attn = CrossAttention(d_model, n_head, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.resweight = nn.Parameter(torch.zeros(()))
        self.resweight_src = nn.Parameter(torch.zeros(()))
        self.drop = nn.Dropout(dropout)

    def forward(
        self,
        tgt: torch.Tensor,
        memory: Optional[torch.Tensor] = None,
        *,
        causal: bool = True,
        memory_key_padding_mask: Optional[torch.Tensor] = None,
        self_cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: Optional[int] = None,
        mem_kv: Optional[Dict[str, torch.Tensor]] = None,
        tgt_key_padding_mask: Optional[torch.Tensor] = None,
    ):
        rw = self.resweight.to(tgt.dtype)
        rw_src = self.resweight_src.to(tgt.dtype)

        sa, _, new_cache = self.self_attn(
            tgt, causal=causal, cache=self_cache, cache_index=cache_index,
            key_padding_mask=tgt_key_padding_mask,
        )
        tgt = tgt + self.drop(sa) * rw

        ca, src_attn_weights = self.cross_attn(
            tgt, memory, key_padding_mask=memory_key_padding_mask, mem_kv=mem_kv,
        )
        tgt = tgt + self.drop(ca) * rw_src

        ff = self.linear2(self.drop(F.relu(self.linear1(tgt))))
        tgt = tgt + self.drop(ff) * rw
        return tgt, src_attn_weights, new_cache

    def precompute_mem_kv(self, memory: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.cross_attn.precompute_kv(memory)


class RZDecoder(nn.Module):
    """Stack of RZDecoderLayers. Returns hidden states and stacked per-layer
    cross-attention weights [n_layers, B, Tq, S] (float32)."""

    def __init__(self, n_layers: int, d_model: int, n_head: int,
                 dim_feedforward: int, dropout: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.n_head = n_head
        self.layers = nn.ModuleList(
            RZDecoderLayer(d_model, n_head, dim_feedforward, dropout)
            for _ in range(n_layers))

    def forward(
        self,
        tgt: torch.Tensor,
        memory: Optional[torch.Tensor] = None,
        *,
        causal: bool = True,
        memory_key_padding_mask: Optional[torch.Tensor] = None,
        caches: Optional[Tuple[Dict[str, torch.Tensor], ...]] = None,
        cache_index: Optional[int] = None,
        mem_kvs: Optional[Tuple[Dict[str, torch.Tensor], ...]] = None,
        tgt_key_padding_mask: Optional[torch.Tensor] = None,
    ):
        attn_all = []
        new_caches = []
        for li, layer in enumerate(self.layers):
            tgt, attn_w, nc = layer(
                tgt,
                memory,
                causal=causal,
                memory_key_padding_mask=memory_key_padding_mask,
                self_cache=None if caches is None else caches[li],
                cache_index=cache_index,
                mem_kv=None if mem_kvs is None else mem_kvs[li],
                tgt_key_padding_mask=tgt_key_padding_mask,
            )
            attn_all.append(attn_w)
            new_caches.append(nc)
        attn = torch.stack(attn_all, dim=0)
        return tgt, attn, (tuple(new_caches) if caches is not None else None)

    def precompute_mem_kvs(self, memory: torch.Tensor):
        """Per-layer cross-attention K/V for `memory` (one-time per window)."""
        return tuple(layer.precompute_mem_kv(memory) for layer in self.layers)

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None):
        """Zeroed self-attention caches [B, L, H, dh] per layer, in the
        decoder's parameter dtype and device unless told otherwise."""
        ref = self.layers[0].linear1.weight
        dtype = dtype or ref.dtype
        device = device or ref.device
        dh = self.d_model // self.n_head
        return tuple(
            {
                "k": torch.zeros((batch, max_len, self.n_head, dh), dtype=dtype, device=device),
                "v": torch.zeros((batch, max_len, self.n_head, dh), dtype=dtype, device=device),
            }
            for _ in range(self.n_layers)
        )

    @property
    def n_layers(self) -> int:
        return len(self.layers)
