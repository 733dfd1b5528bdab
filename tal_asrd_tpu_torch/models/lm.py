"""Decoder-only transformer language model for shallow fusion.

Counterpart of tal_asrd_tpu/models/lm.py: a stack of ReZero blocks
(self-attention and feed-forward, both gated by one zero-init scalar) over a
tied token embedding, built from the ASR decoder's own `SelfAttention`,
`PositionalEncoding` and `Linear` (models/decoder.py, models/layers.py).

  * `forward(tokens)` -> logits [B, L, vocab] (causal by default);
  * `init_cache` / `decode_step`: KV-cached single-token steps, caches
    [B, L, H, dh] per layer (the layout of `RZDecoder.init_cache`), written
    in place at the step's index;
  * `decode_prefill(tokens, cache_len)`: a causal pass over a history buffer
    that fills the caches from position 0 (the unaligned state machine
    prefills the LM over the same re-sliced history as the ASR decoder).

Positions past `max_positions` reuse the last row of the table, as the
reference's clamped `dynamic_slice` does. Callers clamp speaker tokens to
`vocab_size - 1` before they reach the LM (decode/beam.py,
decode/unaligned.py). Parameters are drawn from a CPU generator as the
reference's initialisers draw them (embedding uniform in +-1/sqrt(hidden),
matrices lecun_normal, biases and ReZero scalars zero), in f32 (the
reference's LM is f32 in training and in fusion), then moved to `device`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tal_asrd_tpu_torch.core.config import LMConfig
from tal_asrd_tpu_torch.models.decoder import PositionalEncoding, SelfAttention
from tal_asrd_tpu_torch.models.layers import Linear, lecun_normal_

Cache = Dict[str, torch.Tensor]


class RZLMLayer(nn.Module):
    """ReZero block: x += sa * rw; x += ff * rw."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.1):
        super().__init__()
        self.self_attn = SelfAttention(d_model, n_head, dropout)
        self.linear1 = Linear(d_model, 4 * d_model)
        self.linear2 = Linear(4 * d_model, d_model)
        self.resweight = nn.Parameter(torch.zeros(()))
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, *, causal: bool = True,
                cache: Optional[Cache] = None, cache_index: Optional[int] = None):
        rw = self.resweight
        sa, _, new_cache = self.self_attn(x, causal=causal, cache=cache,
                                          cache_index=cache_index)
        x = x + self.drop(sa) * rw
        ff = self.linear2(self.drop(F.relu(self.linear1(x))))
        x = x + self.drop(ff) * rw
        return x, new_cache


class DecoderLMModel(nn.Module):
    def __init__(self, cfg: LMConfig = LMConfig(), device: str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.pos = PositionalEncoding(c.hidden_size, c.max_positions, c.dropout)
        self.layers = nn.ModuleList(
            RZLMLayer(c.hidden_size, c.n_head, c.dropout) for _ in range(c.n_layers))
        self.reset_parameters(generator)
        self.to(device=device)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for name, p in self.named_parameters():
            if p.dim() <= 1:
                p.zero_()
            elif name == "embedding.weight":
                bound = 1.0 / p.shape[1] ** 0.5
                p.copy_(torch.empty(p.shape, dtype=torch.float32).uniform_(
                    -bound, bound, generator=generator))
            else:                                   # Linear [out, in]
                lecun_normal_(p, p.shape[1], generator)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied output head: hidden -> vocab."""
        return x @ self.embedding.weight.T

    def forward(self, tokens: torch.Tensor, causal: bool = True) -> torch.Tensor:
        """tokens [B, L] -> logits [B, L, vocab]."""
        x = self.pos(self.embedding(tokens))
        for blk in self.layers:
            x, _ = blk(x, causal=causal)
        return self._logits(x)

    # -- incremental decoding ------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Tuple[Cache, ...]:
        """Zeroed caches [B, L, H, dh] per layer, on the parameters' device."""
        dh = self.cfg.hidden_size // self.cfg.n_head
        return tuple(
            {key: torch.zeros((batch, max_len, self.cfg.n_head, dh),
                              device=self.embedding.weight.device) for key in ("k", "v")}
            for _ in range(self.cfg.n_layers))

    def decode_step(self, y_tok: torch.Tensor, caches: Tuple[Cache, ...], index: int):
        """[B, 1] token at position `index` -> ([B, vocab] logits, caches);
        the caches are written in place."""
        x = self.pos(self.embedding(y_tok), offset=index)
        new_caches = []
        for blk, cache in zip(self.layers, caches):
            x, nc = blk(x, cache=cache, cache_index=index)
            new_caches.append(nc)
        return self._logits(x)[:, -1], tuple(new_caches)

    def decode_prefill(self, tokens: torch.Tensor, cache_len: int):
        """Causal pass over a history buffer [B, P] (positions from 0) that
        fills fresh caches of `cache_len`. Returns (logits [B, P, vocab],
        caches)."""
        caches = self.init_cache(tokens.shape[0], cache_len)
        x = self.pos(self.embedding(tokens))
        new_caches = []
        for blk, cache in zip(self.layers, caches):
            x, nc = blk(x, cache=cache, cache_index=0)
            new_caches.append(nc)
        return self._logits(x), tuple(new_caches)
