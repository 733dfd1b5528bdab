"""Typed configuration for the frontend, the model, the speaker baseline,
the shallow-fusion LM, SpecAugment, training and decoding.

Own copy of the dataclasses the serving, training and evaluation paths read
(counterpart: tal_asrd_tpu/core/config.py). Field names and defaults are the
same, so a test can build both packages' configs from one set of keyword
arguments. Fields that only select a TPU lowering (`use_pallas`,
`spectrum_impl`, `conv_impl`) have no meaning here and are left out.
`MeshConfig` is the ('data', 'model') mesh's shape (parallel/mesh.py).
`to_json` writes a config as the reference's does.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class FrontendConfig:
    """Log-mel frontend: 16 kHz, 80 HTK mels, 25 ms periodic Hann window,
    10 ms hop, power 2, log(mel + 1e-6), global mean subtraction."""

    sample_rate: int = 16000
    n_mels: int = 80
    n_fft: int = 400
    win_length: int = 400
    hop_length: int = 160
    f_min: float = 0.0
    f_max: Optional[float] = None  # defaults to sample_rate / 2
    log_eps: float = 1e-6
    center: bool = True            # reflect-pad n_fft // 2 on both sides
    mean_subtract: bool = True

    @property
    def effective_f_max(self) -> float:
        return self.f_max if self.f_max is not None else self.sample_rate / 2.0


@dataclass(frozen=True)
class SpecAugmentConfig:
    """SpecAugment: 2 frequency masks of width < 27 and 2 time masks of
    width < 100 per example. Zero masks turn it off."""

    freq_mask_param: int = 27
    num_freq_masks: int = 2
    time_mask_param: int = 100
    num_time_masks: int = 2


@dataclass(frozen=True)
class ModelConfig:
    """Joint ASR model. model_type '1x' -> d_decoder 256, '2x' -> 512; both
    4 decoder layers. TDS channel plan [n_mels, 10n, 14n, 18n], depths
    [2, 3, 6], kernel 21, stride 2 between groups => 8x time reduction."""

    model_type: str = "2x"
    num_speakers: int = 0
    n_mels: int = 80
    vocab_size: int = 10000
    n_head: int = 4
    max_positions: int = 512
    dropout: float = 0.2
    embed_size: int = 64       # factorized embedding dim; 0 disables
    spk_embed: int = 128
    use_speaker_head: bool = False
    tds_depths: Tuple[int, ...] = (2, 3, 6)
    tds_kernel: int = 21
    tds_dropout: float = 0.2
    remat: bool = False        # recompute encoder blocks in the backward pass
    # Encoder padding-mask scaling: 'buffer' or 'batch_max'
    # (models/asr.py encoder_padding_mask).
    pad_mask_mode: str = "buffer"
    # Gated sinusoidal positional code on the decode-side memory
    # (`mem_pos_alpha`, init 0).
    enc_posenc: bool = False
    # Debug-only architecture shrink for CPU tests: width_mult scales the TDS
    # group widths, d_decoder_override replaces the decoder width.
    width_mult: float = 1.0
    d_decoder_override: Optional[int] = None

    def __post_init__(self):
        if self.model_type not in ("1x", "2x"):
            raise ValueError(f"Invalid model type {self.model_type!r}")

    @property
    def tds_channels(self) -> Tuple[int, ...]:
        n = self.n_mels
        if self.width_mult != 1.0:
            # Widths stay integer multiples of n_mels (grouped-conv view).
            return (n,) + tuple(max(1, round(w * self.width_mult)) * n
                                for w in (10, 14, 18))
        return (n, 10 * n, 14 * n, 18 * n)

    @property
    def d_decoder(self) -> int:
        if self.d_decoder_override is not None:
            return self.d_decoder_override
        return 256 if self.model_type == "1x" else 512

    @property
    def n_decoder_layers(self) -> int:
        return 4

    @property
    def num_tokens(self) -> int:
        """Output vocabulary: text BPE ids plus appended speaker tokens unless
        a separate speaker head is used."""
        return self.vocab_size if self.use_speaker_head else self.vocab_size + self.num_speakers

    @property
    def time_reduction(self) -> int:
        return 2 ** (len(self.tds_channels) - 1)


@dataclass(frozen=True)
class SDModelConfig:
    """The separate speaker-diarization baseline (models/sd.py): the ASR
    model's TDS encoder under a 128-dim frame embedding and a speaker
    classifier over the whole inventory (6008 speakers)."""

    num_speakers: int = 6008
    n_mels: int = 80
    dropout: float = 0.2
    embed_size: int = 128
    tds_depths: Tuple[int, ...] = (2, 3, 6)
    tds_kernel: int = 21

    @property
    def tds_channels(self) -> Tuple[int, ...]:
        n = self.n_mels
        return (n, 10 * n, 14 * n, 18 * n)


@dataclass(frozen=True)
class LMConfig:
    """Decoder-only LM of shallow fusion: the shape the eval CLI loads
    (vocab 10000, hidden 512, 4 heads, 6 layers, max_len 512) by default."""

    vocab_size: int = 10000
    hidden_size: int = 512
    n_head: int = 4
    n_layers: int = 6
    max_positions: int = 512
    dropout: float = 0.1


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters. `lr` is the base rate per sqrt(example):
    the optimizer runs at `scaled_lr`."""

    batch_size: int = 64
    val_batch_size: Optional[int] = None
    lr: Optional[float] = 1e-4
    grad_acc: int = 1
    num_data_shards: int = 1
    max_steps: Optional[int] = None
    max_epochs: int = 100
    smoothing: float = 0.0
    spk_weight: float = 0.0
    lm_weight: float = 0.0
    max_secs: float = 20.0
    token_replace_prob: float = 0.01  # random input-token replacement
    seed: int = 42

    @property
    def effective_batch_size(self) -> int:
        return self.num_data_shards * self.batch_size * self.grad_acc

    @property
    def scaled_lr(self) -> Optional[float]:
        """Square-root scaling rule: lr * sqrt(effective batch)."""
        if self.lr is None:
            return None
        return self.lr * (self.effective_batch_size ** 0.5)


@dataclass(frozen=True)
class DecodeConfig:
    """Decoding knobs, the reference's fields. A field whose path is not
    ported yet is listed in `_UNPORTED_DECODE_FIELDS` (none at present):
    it is accepted at its default only, and any other value raises
    NotImplementedError naming its ROADMAP item. `self_attn_mode` is read
    by no runner, as in the reference: the non-causal reference decode is
    `decode/reference_mode.py::greedy_noncausal`, called directly."""

    beam_size: int = 5
    max_length: int = 512
    # LM shallow fusion weight (read only when an LM is given)
    lm_weight: float = 0.0
    # The unaligned sliding-window decoder's state machine (decode/unaligned.py)
    chunk_size: int = 357     # encoder frames per window (~28.5 s of audio)
    thresh_prct: float = 0.5
    shift_prct: float = 0.25
    stall_patience: int = 25
    rep_n: int = 5
    skip_prct: float = 0.1
    max_iters: int = 20000    # the reference's field; its runner does not read it
    history_evict_block: int = 64
    eos_advance: bool = False
    stall_rollback: bool = False
    # 'causal': KV-cached causal decoding; 'noncausal_ref': the reference's
    # bidirectional prefix re-encode per step (decode/reference_mode.py).
    self_attn_mode: str = "causal"
    # Run per-token decode steps through the fused layer-step kernel
    # (ops/cuda_decode.py) — speaker-token models only.
    use_fused_decode: bool = False

    def __post_init__(self):
        for name, item in _UNPORTED_DECODE_FIELDS.items():
            default = DecodeConfig.__dataclass_fields__[name].default
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"DecodeConfig.{name}={getattr(self, name)!r}: only the default "
                    f"{default!r} is supported until ROADMAP {item} is ported")


@dataclass(frozen=True)
class MeshConfig:
    """Process mesh shape (parallel/mesh.py `make_mesh`). The reference's
    only parallelism is data parallel; `model` adds tensor parallelism."""

    data: int = -1   # -1: every process not on the model axis is on the data axis
    model: int = 1


# Fields read only by paths not ported yet, and the ROADMAP item of each path.
_UNPORTED_DECODE_FIELDS: dict = {}


def to_json(cfg) -> str:
    def default(o):
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        raise TypeError(type(o))

    return json.dumps(dataclasses.asdict(cfg), indent=2, default=default)
