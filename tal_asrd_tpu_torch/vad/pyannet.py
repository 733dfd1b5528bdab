"""Trainable neural speech-activity detection: PyanNet.

Counterpart of tal_asrd_tpu/vad/pyannet.py: a SincNet band-pass filterbank
over the raw waveform (80 channels, kernel 251, stride 10) -> |.| ->
maxpool 3 -> LayerNorm -> 2 x [conv(60, k=5, SAME) -> leaky_relu ->
maxpool 3 -> LayerNorm] -> 2 x BiLSTM(128) -> 2 x [Dense(128) ->
leaky_relu] -> Dense(1) in float32: one speech logit per 270-sample frame
(16.875 ms). Where the two frameworks part, the port follows the reference:

  * SincConv's filters are rebuilt from (low_hz, band_hz) on every forward:
    the left half windowed by a half-Hamming over linspace(0, K/2 - 1, 125)
    with K/2 = 125.5, the centre tap, the mirrored right half, each filter
    divided by 2 (high - low). XLA's SAME padding at stride 10 pads
    max((ceil(T/10) - 1) * 10 + 251 - T, 0) in total, the smaller half on
    the left; it is padded explicitly here (F.conv1d takes no SAME with a
    stride);
  * |x| is `jnp.abs`'s: its derivative at 0 is 1, where torch.abs's is 0
    (`_abs`); the mel-spaced initialisation puts 27 of the 160 cut-off
    parameters at exactly 0;
  * LayerNorm's epsilon is flax's 1e-6; max pooling drops the remainder;
    leaky_relu's slope is 0.01;
  * each BiLSTM layer is one bidirectional `nn.LSTM` (gate order i, f, g,
    o, zero initial state, over the whole window, the backward direction's
    outputs in time order, concatenated after the forward ones); flax's
    cells hold their bias on the hidden kernels only, so `bias_ih` is zero
    and frozen (left out of the optimizer: `trainable_parameters`) and
    `bias_hh` holds it.

There is no Pallas kernel on this path in the reference (one XLA conv, two
scans) and none here: PyanNet launches no hand-written kernel.

`params_to_state_dict` / `state_dict_to_params` carry the flax tree
(SincConv_0, LayerNorm_0-2, Conv_0-1, OptimizedLSTMCell_0-3 — cells 0 and 1
the first layer's forward and backward directions, 2 and 3 the second's —
and Dense_0-2) both ways; the tree is what `pyannet.msgpack` holds.
`PyanNet.reset_parameters` draws flax's initial distribution (lecun_normal
kernels, orthogonal recurrent kernels, zero biases, unit LayerNorm scales,
mel-spaced bands) from a CPU generator.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tal_asrd_tpu_torch.models.layers import lecun_normal_

SAMPLE_RATE = 16000
# SincNet stride 10 then three maxpool(3): a 270-sample frame hop.
FRAME_HOP = 270
LN_EPS = 1e-6
GATES = ("i", "f", "g", "o")


def _mel_spaced_bands(n: int, sr: int, min_low: float, min_band: float):
    """Initial (low, band) cutoffs mel-spaced over [30 Hz, sr/2 - 100 Hz],
    less the minimum low cutoff and band (SincNet's initialisation)."""
    to_mel = lambda hz: 2595.0 * np.log10(1.0 + hz / 700.0)
    to_hz = lambda mel: 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    edges = to_hz(np.linspace(to_mel(30.0), to_mel(sr / 2 - 100.0), n + 1))
    low = edges[:-1]
    band = np.diff(edges)
    return (np.maximum(low - min_low, 0.0).astype(np.float32),
            np.maximum(band - min_band, 0.0).astype(np.float32))


def same_padding(n: int, kernel: int, stride: int):
    """(left, right) padding of XLA's SAME at this stride."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class SincConv(nn.Module):
    """Learnable band-pass filterbank over the raw waveform: 2 x out_channels
    cut-off parameters instead of out_channels x kernel free weights."""

    def __init__(self, out_channels: int = 80, kernel_size: int = 251, stride: int = 10,
                 sample_rate: int = SAMPLE_RATE, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.sample_rate = sample_rate
        self.min_low_hz = min_low_hz
        self.min_band_hz = min_band_hz
        low0, band0 = _mel_spaced_bands(out_channels, sample_rate, min_low_hz, min_band_hz)
        self.low_hz = nn.Parameter(torch.from_numpy(low0))
        self.band_hz = nn.Parameter(torch.from_numpy(band0))

    def filters(self) -> torch.Tensor:
        """[C, K] band-pass filters of the current cut-offs, float32."""
        low = self.min_low_hz + _abs(self.low_hz)
        high = torch.clamp(low + self.min_band_hz + _abs(self.band_hz),
                           self.min_low_hz, self.sample_rate / 2.0)
        half = (self.kernel_size - 1) // 2
        dev = self.low_hz.device
        t = torch.arange(-half, 0, dtype=torch.float32, device=dev) / self.sample_rate
        window = 0.54 - 0.46 * torch.cos(
            2.0 * math.pi
            * torch.linspace(0.0, float(self.kernel_size) / 2.0 - 1.0, half,
                             dtype=torch.float32, device=dev)
            / self.kernel_size)
        arg = 2.0 * math.pi * t[None, :]
        left = ((torch.sin(high[:, None] * arg) - torch.sin(low[:, None] * arg))
                / (arg / 2.0)) * window[None, :]
        center = 2.0 * (high - low)[:, None]
        filters = torch.cat([left, center, left.flip(1)], dim=1)
        return filters / (2.0 * (high - low)[:, None])

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, ceil(T / stride), out_channels]."""
        lo, hi = same_padding(wav.shape[-1], self.kernel_size, self.stride)
        x = F.pad(wav[:, None, :], (lo, hi))
        out = F.conv1d(x, self.filters()[:, None, :], stride=self.stride)
        return out.transpose(1, 2)


class PyanNet(nn.Module):
    """SincNet -> conv stack -> BiLSTM -> feed-forward -> per-frame logit.
    forward returns LOGITS [B, frames]; apply sigmoid for scores."""

    def __init__(self, lstm_hidden: int = 128, ff_hidden: int = 128,
                 conv_channels: int = 60, device: str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sinc = SincConv()
        n_sinc = 80
        self.norms = nn.ModuleList([nn.LayerNorm(n_sinc, eps=LN_EPS),
                                    nn.LayerNorm(conv_channels, eps=LN_EPS),
                                    nn.LayerNorm(conv_channels, eps=LN_EPS)])
        self.convs = nn.ModuleList([nn.Conv1d(n_sinc, conv_channels, 5),
                                    nn.Conv1d(conv_channels, conv_channels, 5)])
        self.lstms = nn.ModuleList([
            nn.LSTM(conv_channels, lstm_hidden, batch_first=True, bidirectional=True),
            nn.LSTM(2 * lstm_hidden, lstm_hidden, batch_first=True, bidirectional=True)])
        self.ff = nn.ModuleList([nn.Linear(2 * lstm_hidden, ff_hidden),
                                 nn.Linear(ff_hidden, ff_hidden)])
        self.out = nn.Linear(ff_hidden, 1)
        for lstm in self.lstms:              # flax's cells have no input bias
            lstm.bias_ih_l0.requires_grad_(False)
            lstm.bias_ih_l0_reverse.requires_grad_(False)
        self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initial distribution, drawn on the CPU from `generator`."""
        low0, band0 = _mel_spaced_bands(80, SAMPLE_RATE, self.sinc.min_low_hz,
                                        self.sinc.min_band_hz)
        self.sinc.low_hz.copy_(torch.from_numpy(low0))
        self.sinc.band_hz.copy_(torch.from_numpy(band0))
        for norm in self.norms:
            norm.weight.fill_(1.0)
            norm.bias.zero_()
        for layer in list(self.convs) + list(self.ff) + [self.out]:
            lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
            layer.bias.zero_()
        for lstm in self.lstms:
            h = lstm.hidden_size
            for sfx in ("_l0", "_l0_reverse"):
                w_ih = getattr(lstm, "weight_ih" + sfx)
                w_hh = getattr(lstm, "weight_hh" + sfx)
                for g in range(4):
                    lecun_normal_(w_ih[g * h:(g + 1) * h], w_ih.shape[1], generator)
                    w_hh[g * h:(g + 1) * h].copy_(_orthogonal(h, generator))
                getattr(lstm, "bias_ih" + sfx).zero_()
                getattr(lstm, "bias_hh" + sfx).zero_()

    def trainable_parameters(self):
        """The parameters flax trains: all but the LSTMs' zero input bias."""
        return [p for p in self.parameters() if p.requires_grad]

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = _abs(self.sinc(wav.to(torch.float32)))                  # [B, T/10, 80]
        x = self.norms[0](_pool3(x))
        for conv, norm in zip(self.convs, self.norms[1:]):
            h = F.conv1d(F.pad(x.transpose(1, 2), (2, 2)), conv.weight, conv.bias)
            x = norm(_pool3(F.leaky_relu(h.transpose(1, 2), 0.01)))
        for lstm in self.lstms:
            x = lstm(x)[0]                                          # [B, F, 256]
        for ff in self.ff:
            x = F.leaky_relu(ff(x), 0.01)
        return self.out(x.to(torch.float32))[..., 0]                # [B, F]


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: +1 at 0 (and at -0)."""
    return torch.where(x >= 0, x, -x)


def _pool3(x: torch.Tensor) -> torch.Tensor:
    """max_pool((3,), strides=(3,)) over the time axis of [B, T, C]."""
    return F.max_pool1d(x.transpose(1, 2), 3, 3).transpose(1, 2)


def _orthogonal(n: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """An n x n orthogonal matrix, as flax's orthogonal initialiser draws it
    (QR of a standard normal, signs fixed by R's diagonal)."""
    a = torch.randn(n, n, generator=generator)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


def n_frames(n_samples: int) -> int:
    """Output frames for an input of n_samples (SAME conv, floor pooling)."""
    f = -(-n_samples // 10)
    for _ in range(3):
        f = f // 3
    return f


def frame_labels(bounds, n_samples: int, sample_rate: int = SAMPLE_RATE,
                 offset_s: float = 0.0) -> np.ndarray:
    """Per-output-frame speech labels from (start_s, end_s) bounds: frame i
    covers samples [i*270, (i+1)*270) and is speech when its centre (shifted
    by offset_s) falls inside a bound."""
    f = n_frames(n_samples)
    centers = offset_s + (np.arange(f) + 0.5) * FRAME_HOP / sample_rate
    lab = np.zeros(f, np.float32)
    for s, e in bounds:
        lab[(centers >= s) & (centers < e)] = 1.0
    return lab


@torch.no_grad()
def score_episode(model: PyanNet, wav: np.ndarray, window_s: float = 2.0,
                  batch: int = 16) -> np.ndarray:
    """Frame speech probabilities for a whole episode: non-overlapping
    windows snapped to a multiple of FRAME_HOP (so window-local frames land
    on the global 270-sample grid), scored `batch` at a time on the model's
    device (the last batch zero-padded to `batch`), cut to n_frames(total)."""
    dev = next(model.parameters()).device
    win = FRAME_HOP * max(1, round(window_s * SAMPLE_RATE / FRAME_HOP))
    total = len(wav)
    n_win = -(-total // win)
    padded = np.zeros(n_win * win, np.float32)
    padded[:total] = wav
    windows = padded.reshape(n_win, win)
    fw = n_frames(win)
    out = []
    for i in range(0, n_win, batch):
        chunk = windows[i:i + batch]
        if len(chunk) < batch:
            chunk = np.concatenate(
                [chunk, np.zeros((batch - len(chunk), win), np.float32)])
        out.append(torch.sigmoid(model(torch.from_numpy(chunk).to(dev))).cpu().numpy())
    scores = np.concatenate(out)[:n_win, :fw].reshape(-1)
    return scores[: n_frames(total)]


# ---------------------------------------------------------------------------
# flax tree <-> state_dict
# ---------------------------------------------------------------------------
def _cell_names(layer: int, reverse: bool):
    return f"OptimizedLSTMCell_{2 * layer + int(reverse)}", \
        f"lstms.{layer}.{{}}_l0" + ("_reverse" if reverse else "")


def params_to_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """PyanNet's flax parameter tree (with or without a top-level 'params')
    -> the port's state_dict."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    sd = {"sinc.low_hz": t(tree["SincConv_0"]["low_hz"]),
          "sinc.band_hz": t(tree["SincConv_0"]["band_hz"])}
    for i in range(3):
        sd[f"norms.{i}.weight"] = t(tree[f"LayerNorm_{i}"]["scale"])
        sd[f"norms.{i}.bias"] = t(tree[f"LayerNorm_{i}"]["bias"])
    for i in range(2):                       # [K, in, out] -> [out, in, K]
        sd[f"convs.{i}.weight"] = t(tree[f"Conv_{i}"]["kernel"]).permute(2, 1, 0).contiguous()
        sd[f"convs.{i}.bias"] = t(tree[f"Conv_{i}"]["bias"])
    for layer in range(2):
        for reverse in (False, True):
            cell_name, key = _cell_names(layer, reverse)
            cell = tree[cell_name]
            sd[key.format("weight_ih")] = torch.cat(
                [t(cell["i" + g]["kernel"]).T for g in GATES]).contiguous()
            sd[key.format("weight_hh")] = torch.cat(
                [t(cell["h" + g]["kernel"]).T for g in GATES]).contiguous()
            bias = torch.cat([t(cell["h" + g]["bias"]) for g in GATES])
            sd[key.format("bias_ih")] = torch.zeros_like(bias)
            sd[key.format("bias_hh")] = bias
    for i, name in enumerate(("ff.0", "ff.1", "out")):
        sd[f"{name}.weight"] = t(tree[f"Dense_{i}"]["kernel"]).T.contiguous()
        sd[f"{name}.bias"] = t(tree[f"Dense_{i}"]["bias"])
    return sd


def state_dict_to_params(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state_dict -> PyanNet's flax parameter tree of float32
    numpy arrays. The LSTMs' `bias_ih` is added to the hidden kernels'
    bias, where flax keeps the whole gate bias (it is zero in the port's
    own models)."""
    a = lambda x: x.detach().to("cpu", torch.float32).numpy().copy()
    tree: Dict[str, Any] = {"SincConv_0": {"low_hz": a(sd["sinc.low_hz"]),
                                           "band_hz": a(sd["sinc.band_hz"])}}
    for i in range(3):
        tree[f"LayerNorm_{i}"] = {"scale": a(sd[f"norms.{i}.weight"]),
                                  "bias": a(sd[f"norms.{i}.bias"])}
    for i in range(2):
        tree[f"Conv_{i}"] = {"kernel": a(sd[f"convs.{i}.weight"].permute(2, 1, 0)),
                             "bias": a(sd[f"convs.{i}.bias"])}
    for layer in range(2):
        for reverse in (False, True):
            cell_name, key = _cell_names(layer, reverse)
            w_ih, w_hh = sd[key.format("weight_ih")], sd[key.format("weight_hh")]
            bias = sd[key.format("bias_ih")] + sd[key.format("bias_hh")]
            h = w_hh.shape[1]
            cell = {}
            for g, gate in enumerate(GATES):
                rows = slice(g * h, (g + 1) * h)
                cell["i" + gate] = {"kernel": a(w_ih[rows].T)}
                cell["h" + gate] = {"kernel": a(w_hh[rows].T), "bias": a(bias[rows])}
            tree[cell_name] = cell
    for i, name in enumerate(("ff.0", "ff.1", "out")):
        tree[f"Dense_{i}"] = {"kernel": a(sd[f"{name}.weight"].T),
                              "bias": a(sd[f"{name}.bias"])}
    return tree


def load_pyannet(tree: Dict[str, Any], device: str = "cuda") -> PyanNet:
    """A PyanNet on `device` holding the flax tree `tree`."""
    model = PyanNet(device="cpu")
    model.load_state_dict(params_to_state_dict(tree), strict=True)
    return model.to(device)
