"""Fused-kernel decoder: the model's decode surface backed by the fused
layer-step kernel (ops/cuda_decode.py).

Counterpart of tal_asrd_tpu/decode/fused_step.py. `FusedASRDecoder` offers
the four methods the decode loops use — `init_decode_state`, `decode_step`,
`precompute_mem_kvs`, `decode_prefill` — so it can be passed in place of the
model into decode/beam.py `beam_search`. Only the per-token inner step
changes: one kernel launch per layer instead of some twenty small operators.

Numerics: attention math in f32 like models/decoder.py; hidden dtype follows
the wrapped model (bf16 in production). Token embedding, positional add and
the tied factorized output head stay plain PyTorch. Prefill goes through the
model's full-sequence path (it is large-matmul-bound) and its caches are
viewed in the kernel layout ([B, L, H*dh]).

Layer weights are packed once, at construction: the decoder holds its own
[in, out] copies and does not follow later changes to the model's parameters.

Not ported yet (raise NotImplementedError): `kv8` and `w8` (int8 operand
modes of the kernel) and `stacked` (the all-layers kernel).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from tal_asrd_tpu_torch.models.asr import ASRModel
from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step, pack_decoder


class FusedASRDecoder:
    """Drop-in decode-surface replacement for an ASRModel (inference only)."""

    def __init__(self, model: ASRModel, kv8: bool = False, w8: bool = False,
                 stacked: bool = False):
        if kv8 or w8:
            raise NotImplementedError(
                "int8 cross K/V (kv8) and int8 weights (w8) are not ported yet")
        if stacked:
            raise NotImplementedError(
                "the stacked all-layers kernel is not ported yet")
        self.model = model
        self.cfg = model.cfg
        self.dtype = model.dtype
        self.packed = pack_decoder(model.decoder, self.dtype)
        self._pe = model.pos_dec.pe.to(self.dtype)

    def encode(self, *args, **kwargs):
        raise AttributeError(
            "FusedASRDecoder is decode-only; run ASRModel.encode separately")

    # -- decode surface --------------------------------------------------
    def init_decode_state(self, encoder_out: Dict[str, Any], batch: int,
                          max_len: int) -> Dict[str, Any]:
        mem = encoder_out["encoder_out"]
        d = self.cfg.d_decoder
        caches = tuple(
            {
                "k": torch.zeros((batch, max_len, d), dtype=self.dtype, device=mem.device),
                "v": torch.zeros((batch, max_len, d), dtype=self.dtype, device=mem.device),
            }
            for _ in range(self.cfg.n_decoder_layers)
        )
        return {
            "mem_kvs": self.precompute_mem_kvs(mem),
            "caches": caches,
            "index": 0,
            "mask": encoder_out["encoder_padding_mask"],
        }

    def precompute_mem_kvs(self, memory: torch.Tensor):
        """Per-layer cross K/V, flattened [B, S, H*dh] (a plain matmul; it
        runs once per window, outside the token loop)."""
        d = self.cfg.d_decoder
        out = []
        for layer in self.model.decoder.layers:
            kv = layer.cross_attn.kv(memory)
            out.append({"k": kv[..., :d].contiguous(),
                        "v": kv[..., d:].contiguous()})
        return tuple(out)

    def decode_step(self, y_tok: torch.Tensor, state: Dict[str, Any]):
        """[B, 1] token -> (logits [B, V], None, mean-layer cross-attn [B, S],
        new_state), as ASRModel.decode_step. The caches inside `state` are
        written in place."""
        idx = state["index"]
        x = self.model.embed_tokens(y_tok[:, 0]) + self._pe[idx]   # [B, D]

        bias = state.get("mem_bias")
        if bias is None:  # built at the first step, then carried in the state
            bias = self._pad_bias(state["mask"], x.shape[0],
                                  state["mem_kvs"][0]["k"].shape[1], x.device)

        new_caches = []
        attn_sum = None
        for li, w in enumerate(self.packed):
            kv = state["mem_kvs"][li]
            cache = state["caches"][li]
            x, attn, ck, cv = fused_layer_step(
                x, w, cache["k"], cache["v"], kv["k"], kv["v"], bias, idx,
                n_head=self.cfg.n_head)
            new_caches.append({"k": ck, "v": cv})
            attn_sum = attn if attn_sum is None else attn_sum + attn

        logits = self.model.output_logits(x)
        attn_mean = attn_sum / len(self.packed)
        new_state = dict(state, caches=tuple(new_caches), index=idx + 1,
                         mem_bias=bias)
        return logits, None, attn_mean, new_state

    @staticmethod
    def _pad_bias(mask: Optional[torch.Tensor], b: int, s: int,
                  device) -> torch.Tensor:
        """Additive f32 pad bias [B, S] (0 / -1e9) from a bool mask [B or 1, S]
        (True = padding) or None."""
        if mask is None:
            return torch.zeros((b, s), dtype=torch.float32, device=device)
        bias = torch.where(mask, -1e9, 0.0).to(torch.float32)
        if bias.shape[0] == 1 and b > 1:
            bias = bias.expand(b, s)
        return bias.contiguous()

    def decode_prefill(self, y: torch.Tensor, mem_kvs,
                       mem_mask: Optional[torch.Tensor], cache_len: int):
        """Full-sequence prefill through the model, caches returned in the
        kernel layout. `mem_kvs` are the flattened per-layer dicts of this
        class's precompute_mem_kvs; they are viewed as [B, S, H, dh] for the
        model and the returned caches are viewed as [B, L, H*dh]."""
        h, d = self.cfg.n_head, self.cfg.d_decoder
        dh = d // h
        model_kvs = tuple(
            {"k": kv["k"].reshape(*kv["k"].shape[:2], h, dh),
             "v": kv["v"].reshape(*kv["v"].shape[:2], h, dh)}
            for kv in mem_kvs)
        logits, attn, caches = self.model.decode_prefill(
            y, model_kvs, mem_mask, cache_len)
        flat = tuple(
            {"k": c["k"].reshape(*c["k"].shape[:2], d),
             "v": c["v"].reshape(*c["v"].shape[:2], d)}
            for c in caches)
        return logits, attn, flat
