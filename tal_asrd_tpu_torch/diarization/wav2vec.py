"""wav2vec-style convolutional speaker-feature extractor.

Counterpart of tal_asrd_tpu/diarization/wav2vec.py: fairseq's wav2vec
(v1) `feature_extractor` + `feature_aggregator` architecture, frozen and
inference only, at full width:

  * feature extractor: 1-D convolutions (dim, kernel, stride) [(512, 10, 5),
    (512, 8, 4), (512, 4, 2), (512, 4, 2), (512, 4, 2)] over raw 16 kHz
    audio, VALID padding, each with a bias, GroupNorm(1 group, eps 1e-5)
    and ReLU, then log(|h| + 1);
  * aggregator: 9 convolutions (512, 3, 1), SAME padding, GroupNorm and
    ReLU, with a residual skip wherever the shape is unchanged.

The convolutions are `F.conv1d` and the norms `F.group_norm` (cuDNN and
PyTorch's own kernels on the card): there is no Pallas kernel on this path
in the reference (XLA convolutions) and none here. A VALID convolution
whose input is shorter than its kernel gives no frame, as XLA's does
(F.conv1d would raise): an utterance under 465 samples has no features.

Parameters are the reference's flax tree (`feature_extractor` /
`feature_aggregator` -> `conv_i` {kernel [k, in, out], bias}, `norm_i`
{scale, bias}), loaded by `Wav2VecFeatures.load_params`.
`convert_fairseq_weights` maps a fairseq state dict onto that tree,
`init_wav2vec` draws flax's initial distribution (lecun_normal kernels,
zero biases, unit scales) from a CPU generator (JAX's draws cannot be
reproduced).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tal_asrd_tpu_torch.models.layers import lecun_normal_

EXTRACTOR_PLAN = [(512, 10, 5), (512, 8, 4), (512, 4, 2), (512, 4, 2), (512, 4, 2)]
AGGREGATOR_PLAN = [(512, 3, 1)] * 9
GN_EPS = 1e-5


class _ConvStack(nn.Module):
    """conv -> GroupNorm(1) -> ReLU blocks over [B, C, T]; `same` pads as
    XLA's SAME at stride 1 and adds a residual where shapes agree."""

    def __init__(self, plan: Sequence[Tuple[int, int, int]], in_dim: int, same: bool):
        super().__init__()
        self.plan = [tuple(p) for p in plan]
        self.same = same
        self.kernels = nn.ParameterList()
        self.biases = nn.ParameterList()
        self.scales = nn.ParameterList()
        self.shifts = nn.ParameterList()
        for dim, k, _ in self.plan:
            self.kernels.append(nn.Parameter(torch.zeros(dim, in_dim, k)))
            self.biases.append(nn.Parameter(torch.zeros(dim)))
            self.scales.append(nn.Parameter(torch.ones(dim)))
            self.shifts.append(nn.Parameter(torch.zeros(dim)))
            in_dim = dim

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for i, (dim, k, s) in enumerate(self.plan):
            inp = h
            if self.same:
                total = k - 1                      # SAME at stride 1
                h = F.pad(h, (total // 2, total - total // 2))
            if h.shape[-1] < k:                    # no complete window: no frame
                h = h.new_zeros((h.shape[0], dim, 0))
            else:
                h = F.conv1d(h, self.kernels[i], self.biases[i], stride=s)
                h = F.group_norm(h, 1, self.scales[i], self.shifts[i], eps=GN_EPS)
                h = F.relu(h)
            if self.same and inp.shape == h.shape:
                h = h + inp                        # residual skip
        return h

    def load_tree(self, tree: dict) -> None:
        with torch.no_grad():
            for i in range(len(self.plan)):
                conv, norm = tree[f"conv_{i}"], tree[f"norm_{i}"]
                leaf = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
                self.kernels[i].copy_(leaf(np.asarray(conv["kernel"]).transpose(2, 1, 0)))
                self.biases[i].copy_(leaf(conv["bias"]))
                self.scales[i].copy_(leaf(norm["scale"]))
                self.shifts[i].copy_(leaf(norm["bias"]))


class ConvFeatureExtractor(nn.Module):
    """[B, T] raw audio -> [B, frames, 512]."""

    def __init__(self, plan: Sequence[Tuple[int, int, int]] = tuple(EXTRACTOR_PLAN),
                 log_compression: bool = True):
        super().__init__()
        self.stack = _ConvStack(plan, 1, same=False)
        self.log_compression = log_compression

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.stack(x[:, None, :])
        if self.log_compression:
            h = torch.log(torch.abs(h) + 1.0)
        return h.transpose(1, 2)


class ConvAggregator(nn.Module):
    """[B, frames, C] -> [B, frames, 512]."""

    def __init__(self, plan: Sequence[Tuple[int, int, int]] = tuple(AGGREGATOR_PLAN),
                 in_dim: int = EXTRACTOR_PLAN[-1][0]):
        super().__init__()
        self.stack = _ConvStack(plan, in_dim, same=True)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.stack(h.transpose(1, 2)).transpose(1, 2)


class Wav2VecFeatures(nn.Module):
    """The extractor then the aggregator: [B, T] audio -> [B, frames, 512]."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.feature_extractor = ConvFeatureExtractor()
        self.feature_aggregator = ConvAggregator()
        self.to(device)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return self.feature_aggregator(self.feature_extractor(audio.to(torch.float32)))

    def load_params(self, params: dict) -> "Wav2VecFeatures":
        """Load the reference's flax `params` tree."""
        self.feature_extractor.stack.load_tree(params["feature_extractor"])
        self.feature_aggregator.stack.load_tree(params["feature_aggregator"])
        return self


def _initial_tree(plan, in_dim: int, generator: torch.Generator) -> dict:
    tree = {}
    for i, (dim, k, _) in enumerate(plan):
        fan_in = k * in_dim
        kernel = lecun_normal_(torch.empty(k, in_dim, dim), fan_in, generator).numpy()
        tree[f"conv_{i}"] = {"kernel": kernel, "bias": np.zeros(dim, np.float32)}
        tree[f"norm_{i}"] = {"scale": np.ones(dim, np.float32),
                             "bias": np.zeros(dim, np.float32)}
        in_dim = dim
    return tree


def init_wav2vec(seed: int = 0, device="cuda"):
    """(model, {"params": tree}) with flax's initial distribution drawn from
    a CPU generator seeded `seed`, in the order flax creates the leaves."""
    g = torch.Generator().manual_seed(seed)
    params = {"feature_extractor": _initial_tree(EXTRACTOR_PLAN, 1, g),
              "feature_aggregator": _initial_tree(AGGREGATOR_PLAN, EXTRACTOR_PLAN[-1][0], g)}
    return Wav2VecFeatures(device).load_params(params), {"params": params}


def load_wav2vec(params: dict, device="cuda") -> Wav2VecFeatures:
    """The model with a flax `params` tree (e.g. `load_pytree` of a
    converted checkpoint) loaded."""
    return Wav2VecFeatures(device).load_params(params)


def convert_fairseq_weights(state_dict: Dict[str, np.ndarray],
                            variables=None) -> Dict:
    """Map a fairseq wav2vec state dict onto this module's param tree.

    fairseq's wav2vec (v1) lays blocks out as
    ``{feature_extractor,feature_aggregator}.conv_layers.{i}.{j}.*`` where the
    Sequential index ``j`` of the conv/norm submodules varies with config
    (dropout / padding modules shift it), so tensors are classified by SHAPE
    within each block instead of by index:

      * 3-D ``weight`` [out, in, k]  -> conv kernel, transposed to [k, in, out]
      * 1-D ``weight`` / ``bias``    -> Fp32GroupNorm(1, dim) affine scale/bias

    fairseq convs are bias-free; when `variables` (an `init_wav2vec` tree) is
    given, conv biases absent from the state dict are zero-filled against it
    and the mapped tree is validated leaf-by-leaf (shape match) so a layout
    drift fails loudly instead of silently running random weights.
    """
    params: Dict = {"feature_extractor": {}, "feature_aggregator": {}}
    for key, val in state_dict.items():
        parts = key.split(".")
        if parts[0] not in params or "conv_layers" not in key:
            continue
        val = np.asarray(val)
        idx = int(parts[2])
        mod = params[parts[0]]
        if val.ndim == 3 and parts[-1] == "weight":
            mod.setdefault(f"conv_{idx}", {})["kernel"] = val.transpose(2, 1, 0)
        elif val.ndim == 1 and parts[-1] == "weight":
            mod.setdefault(f"norm_{idx}", {})["scale"] = val
        elif val.ndim == 1 and parts[-1] == "bias":
            mod.setdefault(f"norm_{idx}", {})["bias"] = val

    if variables is not None:
        ref = variables["params"]
        for group, blocks in ref.items():
            for bname, leaves in blocks.items():
                got = params.setdefault(group, {}).setdefault(bname, {})
                for lname, leaf in leaves.items():
                    if lname not in got:
                        assert lname == "bias" and bname.startswith("conv_"), (
                            f"missing converted leaf {group}/{bname}/{lname}"
                        )
                        got[lname] = np.zeros(leaf.shape, np.float32)
                    assert got[lname].shape == leaf.shape, (
                        group, bname, lname, got[lname].shape, leaf.shape
                    )
    return params


def plan_from_state_dict(state_dict: Dict[str, np.ndarray], prefix: str,
                         strides: Optional[Sequence[int]] = None
                         ) -> List[Tuple[int, int, int]]:
    """Derive a (dim, kernel, stride) conv plan from fairseq conv weight
    shapes (so e.g. wav2vec_large's 12-layer kernel-2..13 aggregator maps
    without hardcoding). Strides are not recoverable from weights: defaults
    to the known wav2vec extractor strides / all-1 aggregator."""
    kernels = {}
    for key, val in state_dict.items():
        val = np.asarray(val)
        if key.startswith(prefix + ".conv_layers.") and val.ndim == 3:
            kernels[int(key.split(".")[2])] = (val.shape[0], val.shape[2])
    plan = []
    default_strides = ([s for _, _, s in EXTRACTOR_PLAN]
                       if prefix == "feature_extractor" else None)
    for i in sorted(kernels):
        dim, k = kernels[i]
        if strides is not None:
            s = strides[i]
        elif default_strides is not None and i < len(default_strides):
            s = default_strides[i]
        else:
            s = 1
        plan.append((dim, k, s))
    return plan


@torch.no_grad()
def extract_utterance_features(
    model: Wav2VecFeatures, audio: np.ndarray,
    window_s: Optional[float] = 0.4, sample_rate: int = 16000,
) -> np.ndarray:
    """Features [frames, 512] of one utterance on the model's device,
    optionally averaged over non-overlapping windows of `window_s`."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(audio), dtype=torch.float32).to(dev)
    feats = model(x[None])[0].cpu().numpy()
    if window_s is None:
        return feats
    # extractor hop: product of strides = 160 samples = 10 ms
    hop_s = np.prod([s for _, _, s in EXTRACTOR_PLAN]) / sample_rate
    per_win = max(int(round(window_s / hop_s)), 1)
    n_win = len(feats) // per_win
    if n_win == 0:
        return feats.mean(axis=0, keepdims=True)
    return feats[: n_win * per_win].reshape(n_win, per_win, -1).mean(axis=1)


def extract_corpus_features(
    model: Wav2VecFeatures, dataset, out_path: str,
    checkpoint_every: int = 10, window_s: Optional[float] = 0.4,
):
    """Corpus-wide extraction with incremental checkpoint and resume: items
    done are skipped on a re-run; an item that raises is recorded in the
    errors (`out_path.ERRORS.pkl`) and the run goes on. Returns (features
    by str(index), errors by str(index))."""
    ckpt = out_path + ".CHECKPOINT.pkl"
    errors_path = out_path + ".ERRORS.pkl"
    done: Dict = {}
    errors: Dict = {}
    if os.path.exists(ckpt):
        with open(ckpt, "rb") as f:
            done = pickle.load(f)
    for i in range(len(dataset)):
        key = str(i)
        if key in done:
            continue
        try:
            item = dataset[i]
            audio = item[0] if isinstance(item, tuple) else item
            done[key] = extract_utterance_features(model, audio, window_s)
        except Exception as e:  # quarantine, keep going (the reference's)
            errors[key] = repr(e)
        if len(done) % checkpoint_every == 0:
            with open(ckpt, "wb") as f:
                pickle.dump(done, f)
    with open(ckpt, "wb") as f:
        pickle.dump(done, f)
    if errors:
        with open(errors_path, "wb") as f:
            pickle.dump(errors, f)
    with open(out_path, "wb") as f:
        pickle.dump(done, f)
    return done, errors
