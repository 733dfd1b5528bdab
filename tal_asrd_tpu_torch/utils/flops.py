"""Analytic FLOP and byte counts of the ASR model, and its roofline.

Counterpart of tal_asrd_tpu/utils/flops.py, with the same functions and
arithmetic: an estimate of the work that does not come from a profiler,
the denominator of an MFU share.

Counts multiply-accumulates as 2 FLOPs, matmul / conv terms only
(elementwise, softmax and layernorm work is < 1 % here and left out: this
is the count the H100's tensor cores see). Architecture mirrored from
ModelConfig / TDS / ASRModel:

  * grouped TDS convs (groups = n_mels) carry 1/n_mels the FLOPs of a dense
    conv: the structural reason the encoder's arithmetic intensity, and so
    its achievable MFU, is far below a dense conv's;
  * decoder: 4 layers, d_model = d_decoder, ff = 4d, per-step
    self-attention over the cached history and cross-attention over the
    encoder memory;
  * factorized tied embeddings: logits cost d*embed + embed*num_tokens per
    token, not d*num_tokens.

The roofline's default peaks are one H100 SXM's (`PEAK_FLOPS`,
`PEAK_BYTES_PER_S`); `chip_smoke.py` reckons every kernel's bound from them.
"""
from __future__ import annotations

from tal_asrd_tpu_torch.core.config import ModelConfig
from tal_asrd_tpu_torch.models.tds import tds_output_length


def _conv_flops(t_out: int, kernel: int, c_in: int, c_out: int,
                groups: int) -> float:
    return 2.0 * t_out * kernel * (c_in // groups) * c_out


def mel_frames(t_samples: int, hop: int = 160) -> int:
    return t_samples // hop + 1


def encode_flops(cfg: ModelConfig, batch: int, t_samples: int) -> float:
    """FLOPs of ASRModel.encode for a [batch, t_samples] window."""
    sizes = cfg.tds_channels
    g = cfg.n_mels
    k = cfg.tds_kernel
    t = mel_frames(t_samples)
    total = 0.0
    for gi, depth in enumerate(cfg.tds_depths):
        c_in, c_out = sizes[gi], sizes[gi + 1]
        t = (t - k) // 2 + 1                      # VALID stride-2 subsample
        total += _conv_flops(t, k, c_in, c_out, g)
        for _ in range(depth):                    # TDSBlock: grouped conv+2 fc
            total += _conv_flops(t, k, c_out, c_out, g)
            total += 2 * (2.0 * t * c_out * c_out)
    d = cfg.d_decoder
    total += 2.0 * t * sizes[-1] * d              # decoder_proj
    return batch * total


def decode_step_flops(cfg: ModelConfig, batch: int, hist_len: int,
                      enc_len: int, n_layers: int = 4) -> float:
    """FLOPs of ONE greedy decode step (KV-cached) for `batch` lanes.

    hist_len: current self-attention history length; enc_len: encoder memory
    length (cross-attention K/V are prefilled once, counted in prefill_flops).
    """
    d = cfg.d_decoder
    ff = 4 * d
    per_layer = (
        2.0 * d * 3 * d        # self qkv
        + 2.0 * d * d          # self out
        + 2.0 * 2 * hist_len * d   # self attn dots (scores + values)
        + 2.0 * d * d          # cross q
        + 2.0 * d * d          # cross out
        + 2.0 * 2 * enc_len * d    # cross attn dots
        + 2.0 * d * ff * 2     # feedforward
    )
    logits = 2.0 * d * cfg.embed_size + 2.0 * cfg.embed_size * cfg.num_tokens
    embed_in = 2.0 * cfg.embed_size * d           # factorized embed -> d
    return batch * (n_layers * per_layer + logits + embed_in)


def prefill_flops(cfg: ModelConfig, batch: int, enc_len: int,
                  n_layers: int = 4) -> float:
    """Cross-attention K/V projection over the encoder memory (once/window)."""
    d = cfg.d_decoder
    return batch * n_layers * 2.0 * enc_len * d * 2 * d


def greedy_decode_flops(cfg: ModelConfig, batch: int, t_samples: int,
                        max_new: int, beam: int = 1) -> float:
    """Total FLOPs of a greedy generate: encode + prefill + max_new
    KV-cached steps with linearly growing history (beam multiplies the
    decode lanes, not the encode)."""
    enc_len = tds_output_length(mel_frames(t_samples), len(cfg.tds_depths),
                                cfg.tds_kernel)
    total = encode_flops(cfg, batch, t_samples)
    total += prefill_flops(cfg, batch * beam, enc_len)
    for i in range(max_new):
        total += decode_step_flops(cfg, batch * beam, i + 1, enc_len)
    return total


# ---------------------------------------------------------------------------
# Roofline: the achievable MFU ceiling of this architecture.
#
# The grouped TDS convs carry 1/n_mels the FLOPs of dense convs at the same
# activation traffic, and autoregressive decode re-reads the decoder weights
# and the whole KV cache every step: both put the arithmetic intensity far
# below the H100's ridge point (989e12 / 3.35e12 ~ 295 FLOP/byte in bf16).
# The functions below count the least device-memory traffic of each stage
# (bf16 = 2 B, activations read and written once per fused op, weights once
# per pass, the KV cache re-read each step) and turn it into a
# speed-of-light time, sol = max(flops / peak, bytes / bw), summed over the
# stages that run one after another. achievable_mfu = flops / (sol * peak):
# an implementation at 100 % of it cannot be faster without changing the
# architecture.
#
# Published dense peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W
# limit): device memory 3.35 TB/s; float32 outside the tensor cores, and
# TF32 and bf16 on them.
# ---------------------------------------------------------------------------
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12}
_B = 2.0                   # bf16 bytes


def encode_bytes(cfg: ModelConfig, batch: int, t_samples: int) -> float:
    """Minimum HBM traffic of ASRModel.encode: per fused op, read input acts +
    weights, write output acts. Grouped-conv weights are tiny; activation
    traffic dominates (the structural reason encode AI ~ k*c/g per element)."""
    sizes = cfg.tds_channels
    g = cfg.n_mels
    k = cfg.tds_kernel
    t = mel_frames(t_samples)
    total = 0.0
    for gi, depth in enumerate(cfg.tds_depths):
        c_in, c_out = sizes[gi], sizes[gi + 1]
        t_in, t = t, (t - k) // 2 + 1
        total += batch * (t_in * c_in + t * c_out) * _B \
            + k * (c_in // g) * c_out * _B
        for _ in range(depth):
            # grouped conv + residual read + 2 fc (read+write each)
            total += batch * (2 * t * c_out + t * c_out) * _B \
                + k * (c_out // g) * c_out * _B
            total += 2 * (batch * 2 * t * c_out * _B + c_out * c_out * _B)
    d = cfg.d_decoder
    total += batch * (t * sizes[-1] + t * d) * _B + sizes[-1] * d * _B
    return total


def _decoder_weight_bytes(cfg: ModelConfig, n_layers: int = 4,
                          w8: bool = False) -> float:
    d = cfg.d_decoder
    per_layer = 3 * d * d + d * d + d * d + d * d + 2 * d * 4 * d  # qkv,out,xq,xout,ff
    logits = d * cfg.embed_size + cfg.embed_size * cfg.num_tokens
    # w8 (quantize_packed): the per-layer matmul weights are int8 (1 B) plus
    # per-output-channel f32 scales; the embedding/logit weights stay bf16
    # (they live outside the fused kernel).
    layer_b = 1.0 if w8 else _B
    scales = (n_layers * (3 * d + 5 * d + 4 * d) * 4.0) if w8 else 0.0
    return n_layers * per_layer * layer_b + logits * _B + scales


def decode_step_bytes(cfg: ModelConfig, batch: int, hist_len: int,
                      enc_len: int, n_layers: int = 4,
                      kv8: bool = False, w8: bool = False) -> float:
    """Minimum HBM traffic of ONE KV-cached decode step.

    Every step re-reads (a) ALL decoder weights — batch-amortized, and
    (b) the per-lane KV caches: self-attention K+V over the history and
    cross-attention K+V over the encoder memory. At bench shapes (B=32,
    enc_len=357, d=512) the cross-KV re-read alone is ~190 MB/step — decode
    is memory-bound by construction and its achievable MFU scales ~linearly
    with batch until the ridge point.

    kv8: cross K/V stored int8 (+ per-channel f32 scales) by the fused
    kernel path (decode/fused_step.py, kernels K1 / K3) — 1 byte/entry
    instead of _B for the dominant term.
    w8: decoder matmul weights stored int8 (quantize_packed) — halves the
    next-largest stream after kv8."""
    d = cfg.d_decoder
    cross_b = 1 if kv8 else _B
    kv = batch * n_layers * 2 * (hist_len * _B + enc_len * cross_b) * d
    scales = (n_layers * 2 * d * 4) if kv8 else 0.0             # f32 scales
    new_kv = batch * n_layers * 2 * d * _B                      # K+V writes
    acts = batch * (cfg.embed_size + d + cfg.num_tokens) * _B   # in/out
    return (_decoder_weight_bytes(cfg, n_layers, w8=w8) + kv + scales
            + new_kv + acts)


def prefill_bytes(cfg: ModelConfig, batch: int, enc_len: int,
                  n_layers: int = 4) -> float:
    """Cross K/V projection traffic: read encoder memory, write K+V caches."""
    d = cfg.d_decoder
    return (batch * enc_len * d * _B                 # memory read
            + n_layers * 2 * d * d * _B              # K,V weights
            + batch * n_layers * 2 * enc_len * d * _B)  # cache writes


def greedy_decode_roofline(cfg: ModelConfig, batch: int, t_samples: int,
                           max_new: int, beam: int = 1,
                           peak: float = PEAK_FLOPS["bfloat16"],
                           bw: float = PEAK_BYTES_PER_S,
                           kv8: bool = False, w8: bool = False) -> dict:
    """Speed-of-light analysis of a greedy generate (`greedy_decode_flops`).

    Returns total analytic flops/bytes, the per-stage and total
    speed-of-light seconds, and achievable_mfu_pct — the MFU an ideal
    implementation of THIS architecture would reach on this chip. Compare
    measured MFU against this, not against 100. `peak` and `bw` default
    to the H100's bf16 tensor-core and memory rates."""
    enc_len = tds_output_length(mel_frames(t_samples), len(cfg.tds_depths),
                                cfg.tds_kernel)
    lanes = batch * beam
    f_enc = encode_flops(cfg, batch, t_samples)
    b_enc = encode_bytes(cfg, batch, t_samples)
    f_pre = prefill_flops(cfg, lanes, enc_len)
    b_pre = prefill_bytes(cfg, lanes, enc_len)
    sol = max(f_enc / peak, b_enc / bw) + max(f_pre / peak, b_pre / bw)
    flops, bytes_ = f_enc + f_pre, b_enc + b_pre
    for i in range(max_new):
        f = decode_step_flops(cfg, lanes, i + 1, enc_len)
        b = decode_step_bytes(cfg, lanes, i + 1, enc_len, kv8=kv8, w8=w8)
        sol += max(f / peak, b / bw)  # steps serialize: per-step roofline
        flops += f
        bytes_ += b
    return {
        "flops": flops,
        "bytes": bytes_,
        "sol_secs": sol,
        "encode_sol_secs": max(f_enc / peak, b_enc / bw),
        "achievable_mfu_pct": 100.0 * flops / (sol * peak),
        "encode_achievable_mfu_pct":
            100.0 * f_enc / (max(f_enc / peak, b_enc / bw) * peak),
    }
