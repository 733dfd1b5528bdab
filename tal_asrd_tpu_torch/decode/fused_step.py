"""Fused-kernel decoder: the model's decode surface backed by the fused
decoder-step kernels (ops/cuda_decode.py, ops/cuda_decode_stacked.py).

Counterpart of tal_asrd_tpu/decode/fused_step.py. `FusedASRDecoder` offers
the four methods the decode loops use — `init_decode_state`, `decode_step`,
`precompute_mem_kvs`, `decode_prefill` — so it can be passed in place of the
model into decode/beam.py `beam_search` (with `speaker_rows`, which the
speaker-embedding track reads). Only the per-token inner step
changes: one kernel launch per layer (or one for the whole stack) instead of
some twenty small operators per layer.

Configurations, any combination of three flags:
  * kv8: the precomputed cross K/V is stored int8 with per-channel f32 scales
    (`quantize_mem_kv`, reduced over the whole batch and window);
  * w8: the layers' weight matrices are stored int8 with per-output-channel
    f32 scales (`quantize_packed`);
  * stacked: one launch of the all-layers kernel per token. Caches and cross
    K/V then carry a leading layer axis ([L, B, cap, D], [L, B, S, D]), so
    beam search gathers beams along axis 1 (`cache_beam_axis`).

Numerics: attention math in f32 like models/decoder.py; hidden dtype follows
the wrapped model (bf16 in production). Token embedding, positional add and
the tied factorized output head stay plain PyTorch. Prefill goes through the
model's full-sequence path (it is large-matmul-bound) and its caches are
viewed in the kernel layout ([B, L, H*dh], stacked under `stacked`).

The fused decoder covers the speaker-token mode only: a model with the
separate speaker head (a second decoder stack) is refused, as the
reference's assert refuses it, and its decode loops run the model itself
(eval/runner.py routes them so).

Layer weights are packed (and quantized under w8) once, at construction,
per layer or stacked: the decoder holds its own [in, out] copies and, in
bf16 and int8, the same weights in the kernels' tensor-core order (`tc_*`,
ops/cuda_decode.py::with_fragments), and does not follow later changes to
the model's parameters.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from tal_asrd_tpu_torch.models.asr import ASRModel
from tal_asrd_tpu_torch.ops.cuda_decode import (
    fused_layer_step,
    pack_decoder,
    quantize_mem_kv,
    quantize_packed,
)
from tal_asrd_tpu_torch.ops.cuda_decode_stacked import (
    pack_decoder_stacked,
    stacked_decoder_step,
)


class FusedASRDecoder:
    """Drop-in decode-surface replacement for an ASRModel (inference only)."""

    def __init__(self, model: ASRModel, kv8: bool = False, w8: bool = False,
                 stacked: bool = False):
        if model.cfg.use_speaker_head:
            raise ValueError(
                "the fused decoder covers the speaker-token mode; a model with the "
                "separate speaker head decodes through the model itself")
        self.model = model
        self.cfg = model.cfg
        self.dtype = model.compute_dtype
        self.kv8 = kv8
        self.w8 = w8
        self.stacked = stacked
        # Beam axis of the self-attention caches for beam_search's reorder:
        # 0 for per-layer [B*K, L, D] caches, 1 for the stacked [L, B*K, cap, D].
        self.cache_beam_axis = 1 if stacked else 0
        if stacked:
            self.packed = pack_decoder_stacked(model.decoder, self.dtype, w8=w8)
        else:
            packed = pack_decoder(model.decoder, self.dtype)
            self.packed = tuple(quantize_packed(w) for w in packed) if w8 else packed
        self._pe = model.pos_dec.pe.to(self.dtype)

    def encode(self, *args, **kwargs):
        raise AttributeError(
            "FusedASRDecoder is decode-only; run ASRModel.encode separately")

    # -- decode surface --------------------------------------------------
    def speaker_rows(self) -> torch.Tensor:
        return self.model.speaker_rows()

    def init_decode_state(self, encoder_out: Dict[str, Any], batch: int,
                          max_len: int) -> Dict[str, Any]:
        mem = encoder_out["encoder_out"]
        d = self.cfg.d_decoder
        n_layers = self.cfg.n_decoder_layers
        zeros = lambda *shape: torch.zeros(shape, dtype=self.dtype, device=mem.device)
        if self.stacked:
            caches = {"k": zeros(n_layers, batch, max_len, d),
                      "v": zeros(n_layers, batch, max_len, d)}
        else:
            caches = tuple({"k": zeros(batch, max_len, d), "v": zeros(batch, max_len, d)}
                           for _ in range(n_layers))
        return {
            "mem_kvs": self.precompute_mem_kvs(mem),
            "caches": caches,
            "index": 0,
            "mask": encoder_out["encoder_padding_mask"],
        }

    def precompute_mem_kvs(self, memory: torch.Tensor):
        """Per-layer cross K/V, flattened [B, S, H*dh] (a plain matmul; it
        runs once per window, outside the token loop); int8 + "sk"/"sv" [D]
        scales under kv8. Under `stacked` one dict of [L, ...] arrays."""
        d = self.cfg.d_decoder
        out = []
        for layer in self.model.decoder.layers:
            kv = layer.cross_attn.kv(memory)
            k, v = kv[..., :d].contiguous(), kv[..., d:].contiguous()
            if self.kv8:
                k8, sk, v8, sv = quantize_mem_kv(k, v)
                out.append({"k": k8, "v": v8, "sk": sk, "sv": sv})
            else:
                out.append({"k": k, "v": v})
        if self.stacked:
            return {key: torch.stack([kv[key] for kv in out]) for key in out[0]}
        return tuple(out)

    def decode_step(self, y_tok: torch.Tensor, state: Dict[str, Any]):
        """[B, 1] token -> (logits [B, V], None, mean-layer cross-attn [B, S],
        new_state), as ASRModel.decode_step. The caches inside `state` are
        written in place."""
        idx = state["index"]
        # a position past the table takes its last row (the reference's clamp)
        x = self.model.embed_tokens(y_tok[:, 0]) + self._pe[min(idx, len(self._pe) - 1)]
        mem = state["mem_kvs"]

        # The pad bias [B, S] is carried in the state beside the mask it was
        # built from, and built again when the state holds another mask object
        # (dict(state, mask=...)) or the lanes or the window's length changed
        # (a None mask stays None when the cross K/V are swapped for another
        # window). Masks are never written in place.
        mask = state["mask"]
        s = mem["k"].shape[2] if self.stacked else mem[0]["k"].shape[1]
        bias = state.get("mem_bias")
        if bias is None or state["mem_bias_of"] is not mask or \
                tuple(bias.shape) != (x.shape[0], s):
            bias = self._pad_bias(mask, x.shape[0], s, x.device)

        if self.stacked:
            caches = state["caches"]
            x, attn_mean, ck, cv = stacked_decoder_step(
                x, self.packed, caches["k"], caches["v"], mem["k"], mem["v"],
                bias, idx, n_head=self.cfg.n_head,
                mem_k_scale=mem.get("sk"), mem_v_scale=mem.get("sv"))
            new_caches = {"k": ck, "v": cv}
        else:
            new_caches = []
            attn_sum = None
            for li, w in enumerate(self.packed):
                kv = mem[li]
                cache = state["caches"][li]
                x, attn, ck, cv = fused_layer_step(
                    x, w, cache["k"], cache["v"], kv["k"], kv["v"], bias, idx,
                    n_head=self.cfg.n_head,
                    mem_k_scale=kv.get("sk"), mem_v_scale=kv.get("sv"))
                new_caches.append({"k": ck, "v": cv})
                attn_sum = attn if attn_sum is None else attn_sum + attn
            new_caches = tuple(new_caches)
            attn_mean = attn_sum / len(self.packed)

        logits = self.model.output_logits(x)
        new_state = dict(state, caches=new_caches, index=idx + 1, mem_bias=bias,
                         mem_bias_of=mask)
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
        kernel layout. `mem_kvs` are this class's precompute_mem_kvs (per-layer
        dicts, or one stacked dict); int8 K/V is dequantized for the model,
        everything is viewed as [B, S, H, dh] for it, and the returned caches
        are viewed as [B, L, H*dh] (stacked to [L, B, L, H*dh] under
        `stacked`)."""
        h, d = self.cfg.n_head, self.cfg.d_decoder
        dh = d // h
        if self.stacked:
            mem_kvs = tuple({key: t[li] for key, t in mem_kvs.items()}
                            for li in range(self.cfg.n_decoder_layers))

        def unflat(kv):
            k, v = kv["k"], kv["v"]
            if "sk" in kv:  # kv8: dequantize (once per window, off the token loop)
                k = (k.to(torch.float32) * kv["sk"]).to(self.dtype)
                v = (v.to(torch.float32) * kv["sv"]).to(self.dtype)
            return {"k": k.reshape(*k.shape[:2], h, dh),
                    "v": v.reshape(*v.shape[:2], h, dh)}

        logits, attn, caches = self.model.decode_prefill(
            y, tuple(unflat(kv) for kv in mem_kvs), mem_mask, cache_len)
        flat = tuple(
            {"k": c["k"].reshape(*c["k"].shape[:2], d),
             "v": c["v"].reshape(*c["v"].shape[:2], d)}
            for c in caches)
        if self.stacked:
            flat = {key: torch.stack([c[key] for c in flat]) for key in ("k", "v")}
        return logits, attn, flat
