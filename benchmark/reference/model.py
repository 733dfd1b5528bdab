"""The model's equations, written from the published description.

Frontend: 16 kHz audio, 25 ms periodic Hann window, 10 ms hop, centred with
reflect padding, |rfft|^2, 80 triangular HTK-mel filters without
normalisation, log(mel + 1e-6), less one mean over the batch's real frames
(frame k of an utterance of n samples is real when k <= n // hop).
SpecAugment zeroes 2 frequency spans (width < 27) and 2 time spans (width <
100) an utterance, drawn by a counter-based 32-bit hash of the utterance's
seed. Encoder: three groups, each a stride-2 grouped convolution (kernel
21, VALID, groups = n_mels) to 800 / 1120 / 1440 channels and then 2 / 3 / 6
TDS blocks: x + rw * drop(relu(conv_same(x))), then x + rw * drop(fc2(
drop(relu(fc1(x))))); a linear projection to the decoder width. Padding
mask of the encoder frames: lengths scaled by the padded length over the
frame count. Decoder: the token's 64-wide embedding times a 64 x D
projection, plus sinusoidal positions, then 4 ReZero layers (self-attention,
cross-attention, feed-forward 4D with ReLU; residuals gated by `resweight`
and `resweight_src`), 4 heads, attention weights dropped after the softmax;
logits through the transposed projection and the embedding table.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e9
HOP, N_FFT, SR, N_MELS = 160, 400, 16000, 80


@contextlib.contextmanager
def exact():
    """Float32 products without TF32 (matmuls and cuDNN convolutions) inside
    the block; the settings are put back after it."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Precision:
    """The type the model computes in: "float32" (exact), "bfloat16" or
    "fp8" (e4m3 with one scale a tensor, amax / 448). The operands and
    results of every product and the residual stream after every layer are
    rounded to it, as a program that keeps its activations in that type
    rounds them; products accumulate in float32, softmax and the loss run
    in float32, as the program runs them."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "bfloat16", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return t
        if self.kind == "bfloat16":
            return t.to(torch.bfloat16).to(torch.float32)
        scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        rounded = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return t + (rounded - t.detach())       # the rounding, with an identity gradient

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).T
        return self.q(y if b is None else y + b)

    def conv(self, x, w, b, stride: int, groups: int, same: bool):
        """x [B, T, C] -> [B, T', C_out]; w [C_out, C_in / groups, K]."""
        x = x.transpose(1, 2)
        if same:
            k = w.shape[-1]
            x = F.pad(x, ((k - 1) // 2, k - 1 - (k - 1) // 2))
        y = F.conv1d(self.q(x), self.q(w), b, stride=stride, groups=groups)
        return self.q(y.transpose(1, 2))

    def bmm(self, a, b):
        return self.q(self.q(a) @ self.q(b))


class Drops:
    """Dropout as the reference applies it: `masks` are the keep-masks of
    one forward, in the order of the model's dropout calls, each with its
    rate; None: no dropout (evaluation)."""

    def __init__(self, masks: Optional[List[Tuple[torch.Tensor, float]]] = None,
                 rows: Optional[slice] = None):
        self.masks = masks
        self.rows = rows
        self.i = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.masks is None:
            return x
        keep, p = self.masks[self.i]
        self.i += 1
        if self.rows is not None:
            keep = keep[self.rows]
        if tuple(keep.shape) != tuple(x.shape):
            raise ValueError(f"dropout {self.i - 1}: mask {tuple(keep.shape)} for {tuple(x.shape)}")
        return x * keep.to(x.device, torch.float32) / (1.0 - p)

    def done(self) -> bool:
        return self.masks is None or self.i == len(self.masks)


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------
def _mel_fb(n_freqs: int = N_FFT // 2 + 1, n_mels: int = N_MELS, sr: int = SR) -> np.ndarray:
    hz2mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)
    mel2hz = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    pts = mel2hz(np.linspace(hz2mel(0.0), hz2mel(sr / 2.0), n_mels + 2))
    fb = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        lo, mid, hi = pts[m], pts[m + 1], pts[m + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        fb[:, m] = np.maximum(0.0, np.minimum(rise, fall))
    return fb


def log_mel(audio: torch.Tensor) -> torch.Tensor:
    """[B, T] float32 audio in [-1, 1] -> [B, T // hop + 1, 80] log-mel."""
    x = F.pad(audio[:, None, :], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)
    n = torch.arange(N_FFT, dtype=torch.float64, device=audio.device)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * n / N_FFT)).to(torch.float32)
    spec = torch.fft.rfft(frames * window, n=N_FFT, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(_mel_fb()).to(device=audio.device, dtype=torch.float32)
    return torch.log(power @ fb + 1e-6)


def masked_batch_mean(mel: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    real = torch.arange(mel.shape[1], device=mel.device)[None, :] <= (lens[:, None] // HOP)
    total = (mel * real[..., None]).sum(dtype=torch.float64)
    return (total / (real.sum() * mel.shape[-1])).to(torch.float32)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    m = 0xFFFFFFFF
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & m
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & m
    return x ^ (x >> 15)


def _spans(seeds: torch.Tensor, n: int, param: int, dim: int, first: int):
    key = _mix32(seeds.to(torch.int64) & 0xFFFFFFFF)[:, None]
    g = torch.arange(first, first + n, device=seeds.device)
    draw = lambda k: _mix32(key ^ (3 * g + k))
    width = draw(0) % param
    room = dim - width
    start = torch.where(room > 0, draw(1) % room.clamp(min=1), 0)
    length = torch.where(width > 0, draw(2) % width.clamp(min=1), 0)
    return start, torch.clamp(start + length, max=dim)


def specaug_keep(seeds: torch.Tensor, t: int, m: int, freq_param: int = 27, n_freq: int = 2,
                 time_param: int = 100, n_time: int = 2) -> torch.Tensor:
    """[B] int32 seeds -> [B, t, m] keep-mask of SpecAugment's spans
    (frequency masks 0, 1; time masks 2, 3 of the hash's mask counter)."""
    def keep(start, end, dim):
        pos = torch.arange(dim, device=seeds.device)[None, None, :]
        return ~((pos >= start[..., None]) & (pos < end[..., None])).any(dim=1)
    fk = keep(*_spans(seeds, n_freq, freq_param, m, 0), m)
    tk = keep(*_spans(seeds, n_time, time_param, t, n_freq), t)
    return tk[:, :, None] & fk[:, None, :]


def features(audio: torch.Tensor, lens: torch.Tensor, rows_per_block: int = 16,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw audio of a whole batch (float, or int16 PCM) -> its log-mel less
    the batch's mean, computed in blocks of rows; `keep` zeroes SpecAugment's
    spans after the mean."""
    if audio.dtype == torch.int16:
        audio = audio.to(torch.float32) / 32768.0
    mel = torch.cat([log_mel(audio[i:i + rows_per_block].to(torch.float32))
                     for i in range(0, audio.shape[0], rows_per_block)])
    mel = mel - masked_batch_mean(mel, lens)
    return mel if keep is None else mel * keep


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------
def encode(w: Dict[str, torch.Tensor], feats: torch.Tensor, depths, n_mels: int,
           prec: Precision, drop: Drops) -> torch.Tensor:
    """[B, F, n_mels] features -> encoder memory [B, S, D]."""
    x = prec.q(feats)
    for gi, depth in enumerate(depths):
        p = f"encoder.down_{gi}."
        x = prec.conv(x, w[p + "weight"], w[p + "bias"], 2, n_mels, same=False)
        for bi in range(depth):
            p = f"encoder.group_{gi}_block_{bi}."
            rw = w[p + "resweight"]
            x = prec.q(x + rw * drop(torch.relu(prec.conv(x, w[p + "conv.weight"],
                                                          w[p + "conv.bias"], 1, n_mels,
                                                          same=True))))
            h = drop(torch.relu(prec.linear(x, w[p + "fc1.weight"], w[p + "fc1.bias"])))
            h = drop(prec.linear(h, w[p + "fc2.weight"], w[p + "fc2.bias"]))
            x = prec.q(x + rw * h)
    return prec.linear(x, w["decoder_proj.weight"], w["decoder_proj.bias"])


def padding_mask(lens: torch.Tensor, t_audio: int, s: int) -> torch.Tensor:
    """[B] sample lengths -> [B, S] bool, True on encoder frames past the
    audio: lengths divided by t_audio // s."""
    scaled = lens // max(t_audio // s, 1)
    return torch.arange(s, device=lens.device)[None, :] >= scaled[:, None]


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def positions(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((n, d), dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(torch.float32)


def _attention(q, k, v, bias, n_head: int, prec: Precision, drop: Drops):
    """q [B, Tq, D], k / v [B, Tk, D], additive bias broadcast to
    [B, H, Tq, Tk] -> [B, Tq, D]."""
    b, tq, d = q.shape
    dh = d // n_head
    split = lambda t: t.reshape(b, t.shape[1], n_head, dh).transpose(1, 2)
    logits = prec.bmm(split(q), split(k).transpose(-1, -2)) / math.sqrt(dh) + bias
    probs = drop(torch.softmax(logits, dim=-1))
    return prec.bmm(probs, split(v)).transpose(1, 2).reshape(b, tq, d)


def decoder_logits(w: Dict[str, torch.Tensor], tokens: torch.Tensor, mem: torch.Tensor,
                   mem_mask: Optional[torch.Tensor], n_layers: int, n_head: int,
                   prec: Precision, drop: Drops) -> torch.Tensor:
    """Teacher-forced causal decode: tokens [B, L] over memory [B, S, D] ->
    logits [B, L, V]."""
    mem = drop(mem)
    d = mem.shape[-1]
    table, proj = w["embedding.weight"], w["embedding_proj"]
    x = prec.q(drop(prec.linear(table[tokens], proj.T)
                    + positions(tokens.shape[1], d, mem.device)))
    n = tokens.shape[1]
    i = torch.arange(n, device=mem.device)
    causal = torch.where(i[:, None] >= i[None, :], 0.0, NEG)[None, None]
    cross = 0.0 if mem_mask is None else torch.where(mem_mask[:, None, None, :], NEG, 0.0)
    for li in range(n_layers):
        p = f"decoder.layers.{li}."
        rw, rw_src = w[p + "resweight"], w[p + "resweight_src"]
        q, k, v = prec.linear(x, w[p + "self_attn.qkv.weight"],
                              w[p + "self_attn.qkv.bias"]).chunk(3, dim=-1)
        sa = _attention(q, k, v, causal, n_head, prec, drop)
        sa = prec.linear(sa, w[p + "self_attn.out_proj.weight"], w[p + "self_attn.out_proj.bias"])
        x = prec.q(x + drop(sa) * rw)
        q = prec.linear(x, w[p + "cross_attn.q.weight"], w[p + "cross_attn.q.bias"])
        k, v = prec.linear(mem, w[p + "cross_attn.kv.weight"],
                           w[p + "cross_attn.kv.bias"]).chunk(2, dim=-1)
        ca = _attention(q, k, v, cross, n_head, prec, drop)
        ca = prec.linear(ca, w[p + "cross_attn.out_proj.weight"], w[p + "cross_attn.out_proj.bias"])
        x = prec.q(x + drop(ca) * rw_src)
        h = drop(torch.relu(prec.linear(x, w[p + "linear1.weight"], w[p + "linear1.bias"])))
        x = prec.q(x + drop(prec.linear(h, w[p + "linear2.weight"], w[p + "linear2.bias"])) * rw)
    return prec.linear(prec.linear(x, proj), table)


def token_loss(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
               smoothing: float = 0.0, count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Label-smoothed cross entropy (weight smoothing / (V - 1) on every other
    token), summed over real positions and divided by their number (or by
    `count`, the whole batch's, when these rows are a block of it)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    if smoothing:
        off = smoothing / (logits.shape[-1] - 1.0)
        nll = (1.0 - smoothing) * nll - off * (logp.sum(dim=-1) + nll)
    m = mask.to(torch.float32)
    return (nll * m).sum() / (m.sum() if count is None else count).clamp(min=1.0)
