"""Frozen analytic counts: FLOPs and least bytes of the ASR model's work, the
H100's published peaks, and the operations and bytes of one call of the
kernels K1 (the fused decoder layer step) and K2 (the log-mel projection).

The encode and decode arithmetic is a copy of the port's
`tal_asrd_tpu_torch/utils/flops.py` as it stood when this benchmark was
written (tests/test_bench_counts.py holds the two equal at the cells'
shapes); it lives here so that a change to the program cannot change the
yardstick. Counts multiply-accumulates as 2 FLOPs, matmul and conv terms
only. Training is three times the forward (encoder and teacher-forced
decoder). Nothing here imports torch or the program: a configuration is
the `Shape` of its JSON file.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

# Published dense peaks of one H100 SXM (NVIDIA's data sheet, 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12}
_B = 2.0                   # bf16 bytes


@dataclass(frozen=True)
class Shape:
    """The sizes the counts read, from a configuration file."""
    n_mels: int
    tds_depths: Tuple[int, ...]
    tds_kernel: int
    d_decoder: int
    embed_size: int
    vocab_size: int
    num_speakers: int
    n_decoder_layers: int = 4
    width_mult: float = 1.0

    @property
    def tds_channels(self) -> Tuple[int, ...]:
        n = self.n_mels
        if self.width_mult != 1.0:
            return (n,) + tuple(max(1, round(w * self.width_mult)) * n for w in (10, 14, 18))
        return (n, 10 * n, 14 * n, 18 * n)

    @property
    def num_tokens(self) -> int:
        return self.vocab_size + self.num_speakers

    @classmethod
    def of(cls, config: dict) -> "Shape":
        d = config.get("d_decoder_override") or (256 if config["model_type"] == "1x" else 512)
        return cls(n_mels=config["n_mels"], tds_depths=tuple(config["tds_depths"]),
                   tds_kernel=config["tds_kernel"], d_decoder=d,
                   embed_size=config["embed_size"], vocab_size=config["vocab_size"],
                   num_speakers=config["num_speakers"],
                   width_mult=config.get("width_mult", 1.0))


def tds_output_length(t: int, n_groups: int = 3, kernel: int = 21) -> int:
    for _ in range(n_groups):
        t = (t - kernel) // 2 + 1
    return t


def mel_frames(t_samples: int, hop: int = 160) -> int:
    return t_samples // hop + 1


def enc_len(cfg: Shape, t_samples: int) -> int:
    return tds_output_length(mel_frames(t_samples), len(cfg.tds_depths), cfg.tds_kernel)


def _conv_flops(t_out: int, kernel: int, c_in: int, c_out: int, groups: int) -> float:
    return 2.0 * t_out * kernel * (c_in // groups) * c_out


def encode_flops(cfg: Shape, batch: int, t_samples: int) -> float:
    sizes = cfg.tds_channels
    g = cfg.n_mels
    k = cfg.tds_kernel
    t = mel_frames(t_samples)
    total = 0.0
    for gi, depth in enumerate(cfg.tds_depths):
        c_in, c_out = sizes[gi], sizes[gi + 1]
        t = (t - k) // 2 + 1
        total += _conv_flops(t, k, c_in, c_out, g)
        for _ in range(depth):
            total += _conv_flops(t, k, c_out, c_out, g)
            total += 2 * (2.0 * t * c_out * c_out)
    total += 2.0 * t * sizes[-1] * cfg.d_decoder
    return batch * total


def decode_step_flops(cfg: Shape, batch: int, hist_len: int, enc_len_: int,
                      n_layers: int = 4) -> float:
    d = cfg.d_decoder
    ff = 4 * d
    per_layer = (2.0 * d * 3 * d + 2.0 * d * d + 2.0 * 2 * hist_len * d
                 + 2.0 * d * d + 2.0 * d * d + 2.0 * 2 * enc_len_ * d + 2.0 * d * ff * 2)
    logits = 2.0 * d * cfg.embed_size + 2.0 * cfg.embed_size * cfg.num_tokens
    embed_in = 2.0 * cfg.embed_size * d
    return batch * (n_layers * per_layer + logits + embed_in)


def prefill_flops(cfg: Shape, batch: int, enc_len_: int, n_layers: int = 4) -> float:
    d = cfg.d_decoder
    return batch * n_layers * 2.0 * enc_len_ * d * 2 * d


def greedy_decode_flops(cfg: Shape, batch: int, t_samples: int, max_new: int,
                        beam: int = 1) -> float:
    """encode + prefill + max_new KV-cached steps (beam multiplies the decode
    lanes, not the encode): utils/flops.py's count of a generate."""
    s = enc_len(cfg, t_samples)
    total = encode_flops(cfg, batch, t_samples) + prefill_flops(cfg, batch * beam, s)
    for i in range(max_new):
        total += decode_step_flops(cfg, batch * beam, i + 1, s)
    return total


def encode_bytes(cfg: Shape, batch: int, t_samples: int) -> float:
    sizes = cfg.tds_channels
    g = cfg.n_mels
    k = cfg.tds_kernel
    t = mel_frames(t_samples)
    total = 0.0
    for gi, depth in enumerate(cfg.tds_depths):
        c_in, c_out = sizes[gi], sizes[gi + 1]
        t_in, t = t, (t - k) // 2 + 1
        total += batch * (t_in * c_in + t * c_out) * _B + k * (c_in // g) * c_out * _B
        for _ in range(depth):
            total += batch * (2 * t * c_out + t * c_out) * _B + k * (c_out // g) * c_out * _B
            total += 2 * (batch * 2 * t * c_out * _B + c_out * c_out * _B)
    d = cfg.d_decoder
    total += batch * (t * sizes[-1] + t * d) * _B + sizes[-1] * d * _B
    return total


def _decoder_weight_bytes(cfg: Shape, n_layers: int = 4) -> float:
    d = cfg.d_decoder
    per_layer = 3 * d * d + d * d + d * d + d * d + 2 * d * 4 * d
    logits = d * cfg.embed_size + cfg.embed_size * cfg.num_tokens
    return n_layers * per_layer * _B + logits * _B


def decode_step_bytes(cfg: Shape, batch: int, hist_len: int, enc_len_: int,
                      n_layers: int = 4) -> float:
    d = cfg.d_decoder
    kv = batch * n_layers * 2 * (hist_len * _B + enc_len_ * _B) * d
    new_kv = batch * n_layers * 2 * d * _B
    acts = batch * (cfg.embed_size + d + cfg.num_tokens) * _B
    return _decoder_weight_bytes(cfg, n_layers) + kv + new_kv + acts


def teacher_forced_flops(cfg: Shape, batch: int, t_samples: int, text_len: int) -> float:
    """One training forward: the encoder and the causal decoder over
    `text_len` positions (the cross K/V projected once, position i
    attending to i + 1 positions), as the decode counts reckon them."""
    s = enc_len(cfg, t_samples)
    total = encode_flops(cfg, batch, t_samples) + prefill_flops(cfg, batch, s)
    for i in range(text_len):
        total += decode_step_flops(cfg, batch, i + 1, s)
    return total


def train_step_flops(cfg: Shape, batch: int, t_samples: int, text_len: int) -> float:
    """A training step: forward, and a backward of twice the forward."""
    return 3.0 * teacher_forced_flops(cfg, batch, t_samples, text_len)


# ---------------------------------------------------------------------------
# Kernel calls
# ---------------------------------------------------------------------------
def k1_call(lanes: int, d: int, s: int, index: int, es: int = 2,
            windows: int = None) -> Tuple[float, float]:
    """(least bytes, operations) of one K1 launch: one decoder layer for one
    token of `lanes` lanes, cache position `index`, S = `s` cross K/V rows,
    storage `es` bytes an element. Each input read once and each output
    written once: the layer's weights (14 D^2) with biases and ReZero scalars,
    the cross K/V and the pad bias of each of `windows` encoder memories
    (the beams of one window share one; `windows` defaults to `lanes`), the
    live self cache, the new cache row, x in and out, and the attention
    weights out. Operations are each lane's own."""
    f = 4 * d
    windows = lanes if windows is None else windows
    n_w = 4 * d * d + 2 * d * f + 2 * d * d
    n_out = 3 * d + 4 * d + f
    bytes_moved = (n_w * es + n_out * 4 + 8
                   + 2 * windows * s * d * es
                   + 2 * lanes * (index + 1) * d * es
                   + 2 * lanes * d * es
                   + 2 * lanes * d * es
                   + windows * s * 4 + lanes * s * 4)
    ops = 2.0 * lanes * (n_w + 2 * (index + 1) * d + 2 * s * d)
    return float(bytes_moved), ops


def k2_call(rows: int, n_freq: int = 201, n_mels: int = 80) -> Tuple[float, float]:
    """(least bytes, operations) of one K2 launch: power [rows, n_freq] f32
    times the filterbank [n_freq, n_mels], log, out [rows, n_mels] f32."""
    bytes_moved = 4.0 * (rows * n_freq + n_freq * n_mels + rows * n_mels)
    return bytes_moved, 2.0 * rows * n_freq * n_mels


def least_seconds(bytes_moved: float, ops: float, peak: float) -> float:
    """The roofline's least time of a call: the larger of its bytes over the
    memory bandwidth and its operations over `peak`."""
    return max(bytes_moved / PEAK_BYTES_PER_S, ops / peak)


def k1_calls_of_generate(windows: int, beam: int, d: int, s: int, steps: int,
                         n_layers: int) -> Sequence[Tuple[float, float]]:
    """(bytes, operations) of every K1 launch of one generate over `windows`
    windows of `beam` lanes each: `steps` decode steps (the prime's and every
    search step's but the last), each one launch a layer at cache index 0,
    1, ...; the cross K/V read once a window."""
    return [k1_call(windows * beam, d, s, i, windows=windows)
            for i in range(steps) for _ in range(n_layers)]
