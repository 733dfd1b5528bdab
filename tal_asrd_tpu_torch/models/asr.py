"""Joint ASR + speaker-diarization encoder-decoder model.

Counterpart of tal_asrd_tpu/models/asr.py: log-mel frontend -> TDS conv
encoder (8x time reduction) -> linear projection to decoder width -> ReZero
transformer decoder with cross-attention, factorized tied token embeddings
(embed_size 64), vocabulary = text BPE + appended speaker tokens, or, with
`use_speaker_head`, text BPE alone and a separate speaker head: a second
encoder projection (`spk_enc_proj`) feeding a half-depth decoder
(`spk_decoder`, the same token embedding and positions) and a two-layer
projection (`speaker_head_1`, `speaker_head_2`) to per-token speaker logits.

  * decode() returns (logits, per-layer cross-attention weights);
  * init_decode_state()/decode_step() provide KV-cached single-token decoding
    for the beam search. The decode state is a plain dict whose `index` is a
    Python int; the self-attention caches in it are updated in place;
  * parameters are stored in `dtype` (bfloat16 for serving, float32 for
    training and the parity tests) and the model computes in
    `compute_dtype` (default: `dtype`). With f32 parameters and bf16
    compute, as the reference trains, the log-mel is cast to bf16 and every
    layer casts its parameters to its input's dtype (explicit casts,
    models/layers.py; no autocast), so the gradients land on the f32
    parameters. The frontend and SpecAugment stay float32;
  * construction leaves the model in eval mode, as serving wants it;
    `.train()` turns on every dropout, and `extract_features(train=True)`
    applies SpecAugment (ops/specaug.py, kernel K4 on the card) to the f32
    log-mel before the cast;
  * the speaker head's modules are registered after the main decoder, so a
    model without the head draws the same initial weights either way;
  * in data-parallel training (`data_group` set by train/system.py) the
    batch is this process's rows of a global batch: the frontend's mean and
    `pad_mask_mode="batch_max"`'s longest audio are the global batch's,
    reduced over the group; on a tensor-parallel model (`vocab_shard` set by
    parallel/tensor.py) the embedding holds a block of vocabulary rows.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from tal_asrd_tpu_torch.core.config import (
    FrontendConfig,
    ModelConfig,
    SpecAugmentConfig,
)
from tal_asrd_tpu_torch.models.decoder import (
    PositionalEncoding,
    RZDecoder,
    sinusoidal_positions,
)
from tal_asrd_tpu_torch.models.layers import Linear, lecun_normal_
from tal_asrd_tpu_torch.models.tds import TDS
from tal_asrd_tpu_torch.ops.logmel import batch_mean, batch_sum_count, log_mel_spectrogram
from tal_asrd_tpu_torch.ops.specaug import spec_augment_seeded


def encoder_padding_mask(audio_lens: torch.Tensor, max_audio_len: int,
                         enc_t: int, mode: str = "buffer",
                         batch_max_len: Optional[int] = None) -> torch.Tensor:
    """[B] sample lengths -> [B, enc_t] bool mask, True = padding.

    mode='buffer' (default): integer-division scaling
    `scaled_lens = audio_lens // (max_audio_len // enc_t)` with the padded
    buffer length as the maximum — well-defined under bucketed static shapes.

    mode='batch_max': the divisor is derived from the BATCH max length, so
    when the longest sample underfills the buffer every sample's scaled
    length grows by max_audio_len / batch_max. `batch_max_len` gives that
    length when `audio_lens` is one part of the batch (decode/sharded.py)."""
    if mode == "batch_max":
        top = audio_lens.max() if batch_max_len is None else torch.tensor(
            batch_max_len, device=audio_lens.device)
        factor = torch.clamp(top // max(enc_t, 1), min=1)
    else:
        factor = max(max_audio_len // max(enc_t, 1), 1)
    scaled = audio_lens // factor
    pos = torch.arange(enc_t, device=audio_lens.device)
    return pos[None, :] >= scaled[:, None]


class ASRModel(nn.Module):
    data_group = None      # data-parallel training: the group of the batch's rows
    vocab_shard = None     # tensor parallel: (group, first row, rows) of the embedding

    def __init__(self, cfg: ModelConfig,
                 frontend: FrontendConfig = FrontendConfig(),
                 specaug: SpecAugmentConfig = SpecAugmentConfig(),
                 dtype: torch.dtype = torch.float32,
                 device: str = "cuda",
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        """Parameters are drawn on the CPU from `generator` (the global RNG
        if None), then moved to `device` in `dtype`; the forward computes in
        `compute_dtype` (`dtype` if None)."""
        super().__init__()
        self.cfg = cfg
        self.frontend = frontend
        self.specaug = specaug
        self.dtype = dtype
        self.compute_dtype = compute_dtype or dtype
        c = cfg
        d = c.d_decoder
        self.encoder = TDS(
            input_size=c.n_mels, sizes=c.tds_channels, depths=c.tds_depths,
            kernel=c.tds_kernel, dropout=c.tds_dropout, remat=c.remat,
        )
        self.decoder_proj = Linear(c.tds_channels[-1], d)
        self.enc_drop = nn.Dropout(c.dropout)

        embed_dim = c.embed_size if c.embed_size else d
        self.embedding = nn.Embedding(c.num_tokens, embed_dim)
        if c.embed_size:
            # Factorized-embedding projection [E, D], used forward
            # (embed -> d) and transposed on the output head: a bare
            # parameter because both directions share it.
            self.embedding_proj = nn.Parameter(torch.empty(embed_dim, d))
        self.pos_dec = PositionalEncoding(d, c.max_positions, c.dropout)
        if c.enc_posenc:
            self.mem_pos_alpha = nn.Parameter(torch.zeros(()))
        self.decoder = RZDecoder(
            n_layers=c.n_decoder_layers, d_model=d, n_head=c.n_head,
            dim_feedforward=4 * d, dropout=c.dropout,
        )
        if c.use_speaker_head:
            self.spk_enc_proj = Linear(c.tds_channels[-1], d)
            self.spk_decoder = RZDecoder(
                n_layers=c.n_decoder_layers // 2, d_model=d, n_head=c.n_head,
                dim_feedforward=4 * d, dropout=c.dropout,
            )
            self.speaker_head_1 = Linear(d, c.spk_embed)
            self.speaker_head_2 = Linear(c.spk_embed, c.num_speakers)
        self.reset_parameters(generator)
        self.to(device=device, dtype=dtype)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The reference's initial distribution, drawn from a CPU
        `generator` (the global RNG if None): matrices, conv kernels and
        `embedding_proj` lecun_normal (models/layers.py), the embedding table
        uniform in +-1/sqrt(embed_dim), biases and the ReZero scalars zero.
        With the scalars at zero every decoder branch is multiplied away, so
        parity probes set them to a non-zero value first."""
        for name, p in self.named_parameters():
            if p.dim() <= 1:
                p.zero_()
            elif name == "embedding.weight":
                # drawn in f32 on the CPU (a CPU generator), wherever p lives
                bound = 1.0 / p.shape[1] ** 0.5
                p.copy_(torch.empty(p.shape, dtype=torch.float32).uniform_(
                    -bound, bound, generator=generator))
            elif name == "embedding_proj":          # [E, D], fan_in E
                lecun_normal_(p, p.shape[0], generator)
            else:  # Linear [out, in] or conv [C_out, C_in / G, K]
                lecun_normal_(p, p[0].numel(), generator)

    # ------------------------------------------------------------------
    # Encoder side
    # ------------------------------------------------------------------
    def log_mel(self, audio: torch.Tensor) -> torch.Tensor:
        """Raw audio [B, T] (float, or int16 PCM scaled here on the device:
        lossless, and half the host->device transfer) -> the f32 log-mel
        [B, F, n_mels] before the batch mean is subtracted."""
        if audio.dtype == torch.int16:
            audio = audio.to(torch.float32) / 32768.0
        return log_mel_spectrogram(audio.to(torch.float32), self.frontend, mean_subtract=False)

    def extract_features(self, audio: torch.Tensor,
                         audio_lens: Optional[torch.Tensor] = None,
                         train: bool = False,
                         specaug_seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Raw audio [B, T] -> log-mel [B, F, n_mels] in the compute dtype:
        `log_mel` less the batch mean (ops/logmel.py; audio_lens enables the
        masked mean). With `train`, SpecAugment zeroes the spans of
        `specaug_seeds` ([B] int32, on the audio's device) in the f32
        log-mel before the cast."""
        mel = self.log_mel(audio)
        if self.frontend.mean_subtract:
            if self.data_group is None:
                mel = mel - batch_mean(mel, audio_lens, self.frontend)
            else:
                total, count = batch_sum_count(mel, audio_lens, self.frontend)
                both = torch.stack([total.double(), count.double()])
                torch.distributed.all_reduce(both, group=self.data_group)
                mel = mel - (both[0] / both[1].clamp(min=mel.shape[-1])).to(mel.dtype)
        if train:
            if specaug_seeds is None:
                raise ValueError("train=True needs the SpecAugment seeds")
            mel = spec_augment_seeded(specaug_seeds, mel, self.specaug)
        return mel.to(self.compute_dtype)

    def encode_features(
        self, feats: torch.Tensor, audio_lens: Optional[torch.Tensor] = None,
        max_audio_len: Optional[int] = None, batch_max_len: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Log-mel -> encoder memory dict (`speaker_out`: the speaker head's
        memory, None without the head). `batch_max_len`: the whole batch's
        longest audio when `audio_lens` is a part of it (`encoder_padding_mask`)."""
        h = self.encoder(feats)  # [B, S, C_enc]
        spk_h = self.spk_enc_proj(h) if self.cfg.use_speaker_head else None
        x = self.decoder_proj(h)
        mask = None
        if audio_lens is not None:
            if max_audio_len is None:
                raise ValueError("audio_lens given without max_audio_len")
            mask = encoder_padding_mask(audio_lens, max_audio_len, x.shape[1],
                                        mode=self.cfg.pad_mask_mode,
                                        batch_max_len=batch_max_len)
        return {"encoder_out": x, "speaker_out": spk_h,
                "encoder_padding_mask": mask}

    def encode(self, audio: torch.Tensor,
               audio_lens: Optional[torch.Tensor] = None,
               train: bool = False,
               specaug_seeds: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        feats = self.extract_features(audio, audio_lens=audio_lens, train=train,
                                      specaug_seeds=specaug_seeds)
        batch_max = None
        if (self.data_group is not None and audio_lens is not None
                and self.cfg.pad_mask_mode == "batch_max"):
            top = audio_lens.max().double().reshape(1)
            torch.distributed.all_reduce(top, op=torch.distributed.ReduceOp.MAX,
                                         group=self.data_group)
            batch_max = int(top)
        return self.encode_features(feats, audio_lens, audio.shape[-1],
                                    batch_max_len=batch_max)

    # ------------------------------------------------------------------
    # Decoder side
    # ------------------------------------------------------------------
    def add_mem_posenc(self, mem: torch.Tensor) -> torch.Tensor:
        """Gated positional code on decode-side memory (enc_posenc), applied
        wherever memory enters cross-attention K/V, after any window slicing,
        so positions are window-relative."""
        if not self.cfg.enc_posenc:
            return mem
        pe = torch.from_numpy(
            sinusoidal_positions(mem.shape[1], mem.shape[-1])
        ).to(device=mem.device, dtype=mem.dtype)
        return mem + self.mem_pos_alpha.to(mem.dtype) * pe[None]

    def embed_tokens(self, y: torch.Tensor) -> torch.Tensor:
        if self.vocab_shard is None:
            e = self.embedding(y)
        else:   # this process's rows, zeros for the others', summed over the axis
            from tal_asrd_tpu_torch.parallel.tensor import reduce_from_model
            group, first, rows = self.vocab_shard
            local = y - first
            held = (local >= 0) & (local < rows)
            e = self.embedding(local.clamp(0, rows - 1)) * held[..., None]
            e = reduce_from_model(e, group)
        e = e.to(self.compute_dtype)
        if self.cfg.embed_size:
            e = e @ self.embedding_proj.to(e.dtype)
        return e

    def speaker_rows(self) -> torch.Tensor:
        """The speaker tokens' rows of the tied embedding table [S, E] (the
        last num_speakers ids), as beam search's collect_spk_embed track
        reads them."""
        return self.embedding.weight[self.cfg.num_tokens - self.cfg.num_speakers:]

    def output_logits(self, h: torch.Tensor) -> torch.Tensor:
        """Tied factorized head: h -> embed space -> vocab."""
        if self.cfg.embed_size:
            h = h @ self.embedding_proj.to(h.dtype).T
        if self.vocab_shard is None:
            return h @ self.embedding.weight.to(h.dtype).T
        from tal_asrd_tpu_torch.parallel.tensor import copy_to_model, gather_from_model
        group = self.vocab_shard[0]
        return gather_from_model(copy_to_model(h, group) @ self.embedding.weight.to(h.dtype).T,
                                 group)

    def decode(
        self,
        y_prev: torch.Tensor,             # [B, L] token ids
        encoder_out: Dict[str, Any],
        causal: bool = True,
        tgt_key_padding_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced / full-prefix decode. Returns (logits
        [B, L, num_tokens], cross-attn weights [layers, B, L, S])."""
        mem = self.add_mem_posenc(self.enc_drop(encoder_out["encoder_out"]))
        y = self.pos_dec(self.embed_tokens(y_prev))
        h, attn, _ = self.decoder(
            y, mem, causal=causal,
            memory_key_padding_mask=encoder_out["encoder_padding_mask"],
            tgt_key_padding_mask=tgt_key_padding_mask,
        )
        return self.output_logits(h), attn

    def decode_spk(
        self,
        y_prev: torch.Tensor,             # [B, L] token ids
        encoder_out: Dict[str, Any],
        causal: bool = True,
    ) -> torch.Tensor:
        """The speaker head's teacher-forced decode: the shared token
        embedding and positions over the speaker memory -> per-token speaker
        logits [B, L, num_speakers]."""
        mem = self.add_mem_posenc(self.enc_drop(encoder_out["speaker_out"]))
        y = self.pos_dec(self.embed_tokens(y_prev))
        h, _, _ = self.spk_decoder(
            y, mem, causal=causal,
            memory_key_padding_mask=encoder_out["encoder_padding_mask"],
        )
        return self.speaker_head_2(self.speaker_head_1(h))

    def forward(self, audio: torch.Tensor, y_prev: torch.Tensor,
                audio_lens: torch.Tensor, train: bool = False,
                specaug_seeds: Optional[torch.Tensor] = None):
        """Full forward. Returns ((lm_logits, spk_logits), encoder_out);
        spk_logits is None without the speaker head. `train` applies
        SpecAugment with `specaug_seeds`; dropout follows the module's
        train() / eval() mode."""
        encoder_out = self.encode(audio, audio_lens, train=train,
                                  specaug_seeds=specaug_seeds)
        lm_logits, _ = self.decode(y_prev, encoder_out, causal=True)
        spk_logits = (self.decode_spk(y_prev, encoder_out, causal=True)
                      if self.cfg.use_speaker_head else None)
        return (lm_logits, spk_logits), encoder_out

    # ------------------------------------------------------------------
    # KV-cached incremental decoding
    # ------------------------------------------------------------------
    def init_decode_state(self, encoder_out: Dict[str, Any], batch: int,
                          max_len: int) -> Dict[str, Any]:
        """Decode state: per-layer cross-attn K/V (one-time) + empty
        self-attn caches + step index (a Python int); with the speaker head
        also its own cross K/V and caches (`spk_mem_kvs`, `spk_caches`)."""
        state = {
            "mem_kvs": self.decoder.precompute_mem_kvs(
                self.add_mem_posenc(encoder_out["encoder_out"])),
            "caches": self.decoder.init_cache(batch, max_len,
                                              dtype=self.compute_dtype),
            "index": 0,
            "mask": encoder_out["encoder_padding_mask"],
        }
        if self.cfg.use_speaker_head:
            state["spk_mem_kvs"] = self.spk_decoder.precompute_mem_kvs(
                self.add_mem_posenc(encoder_out["speaker_out"]))
            state["spk_caches"] = self.spk_decoder.init_cache(
                batch, max_len, dtype=self.compute_dtype)
        return state

    def decode_step(self, y_tok: torch.Tensor, state: Dict[str, Any]):
        """One decode step with KV caches.

        y_tok: [B, 1] current input token. Returns (logits [B, num_tokens],
        speaker logits [B, num_speakers] or None, mean-layer cross-attn
        [B, S], new_state). The speaker head steps on the same embedded token
        and cache index, when the state holds its caches (a state built by
        hand without them, as the state machine's, decodes without it). The
        caches inside `state` are written in place."""
        idx = state["index"]
        y = self.pos_dec(self.embed_tokens(y_tok), offset=idx)
        h, attn, new_caches = self.decoder(
            y, None,
            memory_key_padding_mask=state["mask"],
            caches=state["caches"], cache_index=idx, mem_kvs=state["mem_kvs"],
        )
        logits = self.output_logits(h)[:, -1]
        new_state = dict(state, caches=new_caches, index=idx + 1)
        spk_logits = None
        if self.cfg.use_speaker_head and "spk_caches" in state:
            hs, _, new_spk_caches = self.spk_decoder(
                y, None,
                memory_key_padding_mask=state["mask"],
                caches=state["spk_caches"], cache_index=idx,
                mem_kvs=state["spk_mem_kvs"],
            )
            spk_logits = self.speaker_head_2(self.speaker_head_1(hs))[:, -1]
            new_state["spk_caches"] = new_spk_caches
        # attn: [layers, B, 1, S] -> mean over layers -> [B, S]
        attn_mean = attn[:, :, 0, :].mean(dim=0)
        return logits, spk_logits, attn_mean, new_state

    # ------------------------------------------------------------------
    # Window-based decoding helpers
    # ------------------------------------------------------------------
    def precompute_mem_kvs(self, memory: torch.Tensor):
        """Cross-attention K/V for an (already sliced) encoder window."""
        return self.decoder.precompute_mem_kvs(self.add_mem_posenc(memory))

    def decode_prefill(
        self,
        y: torch.Tensor,                      # [B, P] history token buffer
        mem_kvs,
        mem_mask: Optional[torch.Tensor],     # [B, S] True = pad
        cache_len: int,
    ):
        """Causal full decode of a history buffer that also fills the
        self-attention KV caches (positions restart at 0). Returns (logits
        [B, P, V], mean-layer cross-attn [B, P, S], caches)."""
        caches = self.decoder.init_cache(y.shape[0], cache_len,
                                         dtype=self.compute_dtype)
        e = self.pos_dec(self.embed_tokens(y))
        h, attn, caches = self.decoder(
            e, None, memory_key_padding_mask=mem_mask,
            caches=caches, cache_index=0, mem_kvs=mem_kvs,
        )
        return self.output_logits(h), attn.mean(dim=0), caches
