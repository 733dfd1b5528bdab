"""The separate speaker-diarization baseline: a frame-level speaker classifier.

Counterpart of tal_asrd_tpu/models/sd.py `SDModel`: log-mel -> TDS encoder
(the ASR model's, 8x time reduction) -> dropout -> 128-dim speaker embedding
(`spk_embed_proj`) -> speaker logits over the whole inventory
(`spk_logit_proj`, 6008 speakers). Each output frame covers 0.08 s of audio
with a 1.41 s receptive field; baseline/reconcile.py reads the embeddings
and the argmax ids frame by frame.

As in ASRModel (models/asr.py), parameters are stored in `dtype` and the
model computes in `compute_dtype`: the log-mel (K2 on the card) and
SpecAugment (K4) stay float32 and the features are cast after them, every
layer casting its parameters to its input's dtype. The batch mean of the
log-mel is taken over the real frames of `audio_lens` when they are given.
Audio is cast to float32 as it is, as the reference does: int16 PCM is not
rescaled here. Construction leaves the model in eval mode; `.train()` turns
on every dropout, and `train=True` applies SpecAugment with seeds drawn
from an explicit generator. The parameter names are the reference's
(`encoder`, `spk_embed_proj`, `spk_logit_proj`), so core/convert.py carries
the tree both ways.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from tal_asrd_tpu_torch.core.config import FrontendConfig, SDModelConfig, SpecAugmentConfig
from tal_asrd_tpu_torch.models.asr import encoder_padding_mask
from tal_asrd_tpu_torch.models.layers import Linear, lecun_normal_
from tal_asrd_tpu_torch.models.tds import TDS
from tal_asrd_tpu_torch.ops.logmel import log_mel_spectrogram
from tal_asrd_tpu_torch.ops.specaug import spec_augment


class SDModel(nn.Module):
    def __init__(self, cfg: SDModelConfig = SDModelConfig(),
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
        self.compute_dtype = compute_dtype or dtype
        self.encoder = TDS(input_size=cfg.n_mels, sizes=cfg.tds_channels,
                           depths=cfg.tds_depths, kernel=cfg.tds_kernel,
                           dropout=cfg.dropout)
        self.drop = nn.Dropout(cfg.dropout)
        self.spk_embed_proj = Linear(cfg.tds_channels[-1], cfg.embed_size)
        self.spk_logit_proj = Linear(cfg.embed_size, cfg.num_speakers)
        self.reset_parameters(generator)
        self.to(device=device, dtype=dtype)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The reference's initial distribution: matrices and conv kernels
        lecun_normal (models/layers.py), biases and the ReZero scalars zero."""
        for p in self.parameters():
            if p.dim() <= 1:
                p.zero_()
            else:  # Linear [out, in] or conv [C_out, C_in / G, K]
                lecun_normal_(p, p[0].numel(), generator)

    def extract_features(self, audio: torch.Tensor, train: bool = False,
                         use_specaug: bool = True,
                         audio_lens: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Raw audio [B, T] -> log-mel [B, F, n_mels] in the compute dtype,
        with SpecAugment (one seed an example from `generator`) when `train`
        and `use_specaug`."""
        mel = log_mel_spectrogram(audio.to(torch.float32), self.frontend,
                                  audio_lens=audio_lens)
        if train and use_specaug:
            mel = spec_augment(mel, self.specaug, generator)
        return mel.to(self.compute_dtype)

    def encode(self, audio: torch.Tensor, audio_lens: Optional[torch.Tensor] = None,
               train: bool = False,
               generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Audio -> {"encoder_out": [B, S, 1440], "encoder_padding_mask":
        [B, S] bool (True = padding) or None without `audio_lens`}."""
        feats = self.extract_features(audio, train=train, audio_lens=audio_lens,
                                      generator=generator)
        h = self.encoder(feats)
        mask = None
        if audio_lens is not None:
            mask = encoder_padding_mask(audio_lens, audio.shape[-1], h.shape[1])
        return {"encoder_out": h, "encoder_padding_mask": mask}

    def embed(self, encoder_out: Dict[str, Any]) -> torch.Tensor:
        """Frame-level speaker embeddings [B, S, embed_size] (the pre-logit
        layer); dropout follows the module's train() / eval() mode."""
        return self.spk_embed_proj(self.drop(encoder_out["encoder_out"]))

    def decode(self, encoder_out: Dict[str, Any]) -> torch.Tensor:
        """Frame-level speaker logits [B, S, num_speakers]."""
        return self.spk_logit_proj(self.embed(encoder_out))

    def forward(self, audio: torch.Tensor, audio_lens: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        encoder_out = self.encode(audio, audio_lens, train=train, generator=generator)
        return self.decode(encoder_out), encoder_out
