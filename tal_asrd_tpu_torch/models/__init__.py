from tal_asrd_tpu_torch.models.asr import ASRModel, encoder_padding_mask
from tal_asrd_tpu_torch.models.sd import SDModel
from tal_asrd_tpu_torch.models.lm import DecoderLMModel
from tal_asrd_tpu_torch.models.tds import TDS, TDSBlock, tds_output_length
from tal_asrd_tpu_torch.models.decoder import (
    PositionalEncoding,
    RZDecoder,
    RZDecoderLayer,
    SelfAttention,
    CrossAttention,
    sinusoidal_positions,
)

__all__ = [
    "ASRModel",
    "SDModel",
    "DecoderLMModel",
    "TDS",
    "TDSBlock",
    "tds_output_length",
    "PositionalEncoding",
    "RZDecoder",
    "RZDecoderLayer",
    "SelfAttention",
    "CrossAttention",
    "sinusoidal_positions",
    "encoder_padding_mask",
]
