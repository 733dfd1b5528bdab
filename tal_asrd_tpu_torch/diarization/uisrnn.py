"""UIS-RNN: unbounded interleaved-state RNN speaker diarization.

Counterpart of tal_asrd_tpu/diarization/uisrnn.py (itself Google's UIS-RNN
re-implemented), part for part:

  * `CoreRNN`: the stacked GRU (`nn.GRU`, cuDNN on the card) and the
    two-layer head that predicts the observation mean;
  * the data shaping (`sample_permuted_segments`, `resize_sequence`,
    `pack_batch`, `estimate_transition_bias`, `concatenate_training_data`):
    numpy, call for call, on the same `RandomState` streams;
  * the three losses: the masked weighted MSE, the inverse-gamma sigma^2
    prior, the L2 norms of the parameters (JAX's safe norm,
    sqrt(sum p^2 + 1e-12), over the parameter leaves only);
  * `UISRNN.fit`: one training step on the card is the loss, its gradients
    for the parameters, `init_hidden` and (when learned) `sigma2`, optax's
    `clip_by_global_norm` (kept below the limit, else times max_norm / norm,
    no epsilon: `torch.nn.utils.clip_grad_norm_` adds one, so the clip is
    written out) and optax's Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
    root, bias corrections in f32), then the clamp of sigma2 at 1e-6. The
    floor inside the loss is `torch.maximum`, which splits the gradient
    0.5 / 0.5 at a tie as `jnp.maximum` does (after a clamp, sigma2 can sit
    exactly at 1e-6); `torch.clamp` would pass all of it;
  * `UISRNN.predict`: the CRP beam search on the host in numpy float32,
    call for call (`np.argsort(..., axis=None)`, the running means, the
    padding with inf). The reference's docstring says every candidate's GRU
    step of an iteration is batched; its code steps each candidate alone,
    and so does the port: one `_step` a candidate, each a GRU step on the
    card and a copy back.

`UISRNN(cfg, seed)` draws flax's initial distribution (lecun_normal
kernels, zero biases) from a CPU generator seeded `seed`; JAX's
PRNGKey draws cannot be reproduced. `save` writes the reference's msgpack
tree (`params` in flax's names and layouts, `init_hidden`, `sigma2`, the
transition bias, its denominator, crp_alpha), so either package loads the
other's file; `params_to_state_dict` / `state_dict_to_params` carry the
parameter tree both ways.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tal_asrd_tpu_torch.core.checkpoint import load_pytree, save_pytree
from tal_asrd_tpu_torch.diarization.gru import (
    GRU,
    gru_leaf_names,
    gru_params_to_state_dict,
    gru_state_dict_to_params,
)
from tal_asrd_tpu_torch.models.layers import lecun_normal_

_INITIAL_SIGMA2_VALUE = 0.1
_SIGMA2_FLOOR = 1e-6


@dataclass
class UISRNNConfig:
    observation_dim: int = 256
    rnn_hidden_size: int = 512
    rnn_depth: int = 1
    rnn_dropout: float = 0.0
    transition_bias: Optional[float] = None   # None = estimate from data
    crp_alpha: float = 1.0
    sigma2: Optional[float] = None            # None = learn


@dataclass
class UISRNNTrainConfig:
    learning_rate: float = 1e-3
    train_iteration: int = 20000
    batch_size: Optional[int] = 10
    num_permutations: Optional[int] = 10
    sigma_alpha: float = 1.0
    sigma_beta: float = 1.0
    regularization_weight: float = 1e-5
    grad_max_norm: float = 5.0
    quick_test: bool = False
    log_iter: int = 1000


@dataclass
class UISRNNInferenceConfig:
    beam_size: int = 10
    look_ahead: int = 1
    test_iteration: int = 2


class CoreRNN(nn.Module):
    """GRU core + mean head: relu(Dense(H)) -> Dense(observation_dim)."""

    def __init__(self, hidden_size: int, depth: int, observation_dim: int):
        super().__init__()
        self.depth = depth
        self.gru = GRU(observation_dim, hidden_size, depth)
        self.linear_mean1 = nn.Linear(hidden_size, hidden_size)
        self.linear_mean2 = nn.Linear(hidden_size, observation_dim)

    def forward(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None):
        out, h = self.gru(x, h0)
        return self.linear_mean2(F.relu(self.linear_mean1(out))), h


# ---------------------------------------------------------------------------
# The parameter tree (flax names and layouts) <-> CoreRNN's state_dict
# ---------------------------------------------------------------------------
def param_leaves(depth: int) -> List[Tuple[Tuple[str, str], str, bool]]:
    """(flax path, CoreRNN parameter, transposed) of every parameter leaf,
    in the order of the flax tree's leaves (keys sorted)."""
    leaves = [(("gru", leaf), f"gru.rnn.{name}", t) for leaf, name, t in gru_leaf_names(depth)]
    for n in ("linear_mean1", "linear_mean2"):
        leaves += [((n, "kernel"), f"{n}.weight", True), ((n, "bias"), f"{n}.bias", False)]
    return sorted(leaves)


def params_to_state_dict(tree: dict, depth: int) -> Dict[str, torch.Tensor]:
    """The reference's `params` tree -> CoreRNN's state_dict (float32)."""
    sd = {f"gru.rnn.{k}": v for k, v in gru_params_to_state_dict(tree["gru"], depth).items()}
    for n in ("linear_mean1", "linear_mean2"):
        sd[f"{n}.weight"] = torch.from_numpy(np.array(tree[n]["kernel"], np.float32).T.copy())
        sd[f"{n}.bias"] = torch.from_numpy(np.array(tree[n]["bias"], np.float32))
    return sd


def state_dict_to_params(sd: Dict[str, torch.Tensor], depth: int) -> dict:
    """CoreRNN's state_dict -> the reference's `params` tree (numpy f32)."""
    tree = {"gru": gru_state_dict_to_params(
        {k[len("gru.rnn."):]: v for k, v in sd.items() if k.startswith("gru.rnn.")}, depth)}
    for n in ("linear_mean1", "linear_mean2"):
        tree[n] = {"kernel": sd[f"{n}.weight"].detach().cpu().numpy().T.copy(),
                   "bias": sd[f"{n}.bias"].detach().cpu().numpy().copy()}
    return tree


def init_params(cfg: UISRNNConfig, seed: int = 0) -> dict:
    """flax's initial `params` for `cfg` (lecun_normal kernels in flax's
    layout, zero biases), drawn in the order flax creates them from a CPU
    generator seeded `seed`."""
    g = torch.Generator().manual_seed(seed)
    h, obs = cfg.rnn_hidden_size, cfg.observation_dim

    def kernel(fan_in, fan_out):
        return lecun_normal_(torch.empty(fan_in, fan_out), fan_in, g).numpy()

    zeros = lambda n: np.zeros(n, np.float32)
    gru = {}
    for li in range(cfg.rnn_depth):
        d_in = obs if li == 0 else h
        gru[f"layer_{li}_wi_kernel"] = kernel(d_in, 3 * h)
        gru[f"layer_{li}_wi_bias"] = zeros(3 * h)
        gru[f"layer_{li}_wh_kernel"] = kernel(h, 3 * h)
        gru[f"layer_{li}_wh_bias"] = zeros(3 * h)
    return {"gru": gru,
            "linear_mean1": {"kernel": kernel(h, h), "bias": zeros(h)},
            "linear_mean2": {"kernel": kernel(h, obs), "bias": zeros(obs)}}


# ---------------------------------------------------------------------------
# Data shaping (numpy, as the reference)
# ---------------------------------------------------------------------------
def sample_permuted_segments(index_sequence, number_samples, rng):
    """Block-permutation augmentation: split the index set at
    discontinuities, then emit permutations of the blocks."""
    segments = []
    current = [index_sequence[0]]
    for prev, nxt in zip(index_sequence[:-1], index_sequence[1:]):
        if nxt == prev + 1:
            current.append(nxt)
        else:
            segments.append(current)
            current = [nxt]
    segments.append(current)
    out = []
    for _ in range(number_samples):
        perm = rng.permutation(len(segments))
        out.append(np.concatenate([np.asarray(segments[p]) for p in perm]))
    return out


def resize_sequence(sequence, cluster_id, num_permutations=None, seed=0):
    """Group observations by cluster into subsequences."""
    rng = np.random.RandomState(seed)
    unique_id = np.unique(cluster_id)
    sub_sequences, seq_lengths = [], []
    for uid in unique_id:
        idx = np.where(cluster_id == uid)[0]
        if num_permutations and num_permutations > 1:
            for perm in sample_permuted_segments(idx, num_permutations, rng):
                sub_sequences.append(sequence[perm, :])
                seq_lengths.append(len(idx) + 1)
        else:
            sub_sequences.append(sequence[idx, :])
            seq_lengths.append(len(idx) + 1)
    return sub_sequences, seq_lengths


def pack_batch(sub_sequences, seq_lengths, batch_indices, observation_dim):
    """Zero-prefixed padded batch [B, T, D], its truth [B, T - 1, D] and the
    per-step mask (True up to each row's length: always a prefix)."""
    lens = [seq_lengths[i] for i in batch_indices]
    t_max = max(lens)
    b = len(batch_indices)
    x = np.zeros((b, t_max, observation_dim), np.float32)
    mask = np.zeros((b, t_max), bool)
    for bi, si in enumerate(batch_indices):
        seq = sub_sequences[si]
        x[bi, 1 : len(seq) + 1] = seq      # input row 0 stays zero
        mask[bi, : len(seq) + 1] = True
    truth = x[:, 1:, :]
    return x, truth, mask


def estimate_transition_bias(cluster_ids, smooth=1):
    """Speaker-change probability with smoothing."""
    transit_num = smooth
    denom = 2 * smooth
    for seq in cluster_ids:
        for a, b in zip(seq[:-1], seq[1:]):
            transit_num += int(a != b)
            denom += 1
    return transit_num / denom, denom


def concatenate_training_data(sequences, cluster_ids, enforce_uniqueness=True):
    """Concatenate utterances, optionally uniquifying cluster ids per
    utterance."""
    all_seq = []
    all_ids = []
    for k, (seq, ids) in enumerate(zip(sequences, cluster_ids)):
        all_seq.append(np.asarray(seq, float))
        prefix = f"seq{k}_" if enforce_uniqueness else ""
        all_ids.extend(prefix + str(i) for i in ids)
    return np.concatenate(all_seq, axis=0), np.asarray(all_ids)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def weighted_mse_loss(input_tensor, target_tensor, weight):
    """Sum over entries of diff^2 * w, over the number of rows whose first
    entry differs (at least 1)."""
    d = input_tensor.shape[-1]
    diff2 = ((input_tensor - target_tensor) ** 2).reshape(-1, d)
    non_zero = torch.clamp((diff2[:, 0] != 0).sum(), min=1)
    return torch.sum(diff2 * weight.reshape(1, -1)) / non_zero


def sigma2_prior_loss(num_non_zero, sigma_alpha, sigma_beta, sigma2):
    nnz = torch.clamp(num_non_zero, min=1.0)
    return (torch.sum((2 * sigma_alpha + nnz + 2) / (2 * nnz) * torch.log(sigma2))
            + torch.sum(sigma_beta / (sigma2 * nnz)))


def regularization_loss(params, weight):
    """weight x the sum of the leaves' safe L2 norms (the gradient of
    sqrt(sum p^2) is NaN at p == 0, and the biases start at 0)."""
    return weight * sum(torch.sqrt(torch.sum(p.to(torch.float32) ** 2) + 1e-12)
                        for p in params)


# ---------------------------------------------------------------------------
# One training step
# ---------------------------------------------------------------------------
class FitStep:
    """fit's state and its step on the model's device: the trainable leaves
    in the order of the reference's tree (`init_hidden`, the parameter
    leaves, `sigma2` when it is learned; the parameters in CoreRNN's own
    layout) and Adam's moments and count.

    `set_state` / `state` exchange all of it in the reference's names and
    layouts, so a step can start from the reference's state."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, model: "UISRNN", args: UISRNNTrainConfig):
        self.model = model
        self.args = args
        self.depth = model.cfg.rnn_depth
        core = model.core
        named = dict(core.named_parameters())
        self.init_hidden = model.init_hidden.clone().requires_grad_(True)
        self.sigma2 = model.sigma2.clone().requires_grad_(model.estimate_sigma2)
        self.param_names = [("params/" + "/".join(path), named[name], t)
                            for path, name, t in param_leaves(self.depth)]
        self.names = ["init_hidden"] + [n for n, _, _ in self.param_names]
        self.leaves = [self.init_hidden] + [p for _, p, _ in self.param_names]
        self.transposed = [False] + [t for _, _, t in self.param_names]
        if model.estimate_sigma2:
            self.names.append("sigma2")
            self.leaves.append(self.sigma2)
            self.transposed.append(False)
        self.mu = [torch.zeros_like(t) for t in self.leaves]
        self.nu = [torch.zeros_like(t) for t in self.leaves]
        self.count = 0
        self._floor = torch.tensor(_SIGMA2_FLOOR, dtype=torch.float32,
                                   device=model.device)

    def loss(self, x: torch.Tensor, truth: torch.Tensor):
        """(total, (mse, sigma2 prior, regularization)) on a packed batch."""
        args = self.args
        sigma2 = torch.maximum(self.sigma2, self._floor)
        b = x.shape[0]
        h0 = self.init_hidden.repeat(1, b, 1)
        mean, _ = self.model.core(x, h0)
        # cumulative-mean prediction
        csum = torch.cumsum(mean, dim=1)
        denom = torch.arange(1, mean.shape[1] + 1, dtype=torch.float32, device=x.device)
        mean = csum / denom[None, :, None]

        # `truth != 0` masks elementwise: a real zero in an observation too
        truth_nonzero = (truth != 0).to(torch.float32)
        pred = truth_nonzero * mean[:, :-1, :]
        weight = 1.0 / (2.0 * sigma2)
        loss1 = weighted_mse_loss(pred, truth, weight)

        w2 = ((pred - truth) ** 2).reshape(-1, truth.shape[-1])
        num_non_zero = (w2 != 0).to(torch.float32).sum(dim=0)
        loss2 = sigma2_prior_loss(num_non_zero, args.sigma_alpha, args.sigma_beta, sigma2)
        loss3 = regularization_loss([p for _, p, _ in self.param_names],
                                    args.regularization_weight)
        return loss1 + loss2 + loss3, (loss1, loss2, loss3)

    def grads(self, x: torch.Tensor, truth: torch.Tensor):
        """(loss, aux, gradients of the trainable leaves)."""
        for t in self.leaves:
            t.grad = None
        loss, aux = self.loss(x, truth)
        loss.backward()
        return loss.detach(), tuple(a.detach() for a in aux), [t.grad for t in self.leaves]

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        """optax.chain(clip_by_global_norm(max_norm), adam(lr)), applied."""
        max_norm, lr = self.args.grad_max_norm, self.args.learning_rate
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < max_norm
        grads = [torch.where(keep, g, (g / g_norm) * max_norm) for g in grads]
        self.count += 1
        # the bias corrections 1 - b**count in f32, as optax computes them
        one, n = np.float32(1), np.float32(self.count)
        bc1 = float(one - np.float32(self.B1) ** n)
        bc2 = float(one - np.float32(self.B2) ** n)
        for i, (t, g) in enumerate(zip(self.leaves, grads)):
            self.mu[i] = (1 - self.B1) * g + self.B1 * self.mu[i]
            self.nu[i] = (1 - self.B2) * (g ** 2) + self.B2 * self.nu[i]
            step = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2 + 0.0) + self.EPS)
            t.add_(step * -lr)
        if self.model.estimate_sigma2:
            self.sigma2.copy_(torch.maximum(self.sigma2, self._floor))   # clamp

    def step(self, x: torch.Tensor, truth: torch.Tensor):
        """One training step: (loss, aux), both on the device."""
        loss, aux, grads = self.grads(x, truth)
        self.update(grads)
        return loss, aux

    # -- the state in the reference's names and layouts ------------------
    def _tree(self, tensors) -> dict:
        tree: dict = {}
        for name, t, tr in zip(self.names, tensors, self.transposed):
            a = t.detach().cpu().numpy()
            a = np.ascontiguousarray(a.T) if tr else a.copy()
            node = tree
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a
        return tree

    def _leaf(self, tree: dict, name: str) -> np.ndarray:
        node = tree
        for p in name.split("/"):
            node = node[p]
        return np.array(node, dtype=np.float32)

    def state(self) -> dict:
        """{"trainable", "mu", "nu": trees as the reference's, "count"}."""
        return {"trainable": self._tree(self.leaves), "mu": self._tree(self.mu),
                "nu": self._tree(self.nu), "count": self.count}

    @torch.no_grad()
    def set_state(self, state: dict) -> None:
        """Load a `state()`-shaped dict (e.g. the reference's state)."""
        dev = self.model.device
        for i, (name, tr) in enumerate(zip(self.names, self.transposed)):
            for key, dst in (("mu", self.mu), ("nu", self.nu)):
                a = self._leaf(state[key], name)
                dst[i] = torch.from_numpy(np.ascontiguousarray(a.T if tr else a)).to(dev)
            a = self._leaf(state["trainable"], name)
            self.leaves[i].copy_(torch.from_numpy(np.ascontiguousarray(a.T if tr else a)))
        self.count = int(state["count"])

    def commit(self) -> None:
        """Write the trained init_hidden and sigma2 back to the model."""
        self.model.init_hidden = self.init_hidden.detach().clone()
        if self.model.estimate_sigma2:
            self.model.sigma2 = self.sigma2.detach().clone()


# ---------------------------------------------------------------------------
# Beam state (host side)
# ---------------------------------------------------------------------------
class BeamState:
    """CRP beam search bookkeeping."""

    def __init__(self, source: Optional["BeamState"] = None):
        if source is None:
            self.mean_set: List[np.ndarray] = []
            self.hidden_set: List[np.ndarray] = []
            self.neg_likelihood = 0.0
            self.trace: List[int] = []
            self.block_counts: List[int] = []
        else:
            self.mean_set = list(source.mean_set)
            self.hidden_set = list(source.hidden_set)
            self.trace = list(source.trace)
            self.block_counts = list(source.block_counts)
            self.neg_likelihood = source.neg_likelihood

    def append(self, mean, hidden, cluster):
        self.mean_set.append(np.array(mean))
        self.hidden_set.append(np.array(hidden))
        self.block_counts.append(1)
        self.trace.append(cluster)


class UISRNN:
    def __init__(self, cfg: UISRNNConfig, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.core = CoreRNN(cfg.rnn_hidden_size, cfg.rnn_depth,
                            cfg.observation_dim).to(self.device)
        self.params = init_params(cfg, seed)
        self.init_hidden = torch.zeros((cfg.rnn_depth, 1, cfg.rnn_hidden_size),
                                       device=self.device)
        self.estimate_sigma2 = cfg.sigma2 is None
        self.estimate_transition_bias = cfg.transition_bias is None
        sigma2 = _INITIAL_SIGMA2_VALUE if self.estimate_sigma2 else cfg.sigma2
        self.sigma2 = torch.full((cfg.observation_dim,), sigma2, dtype=torch.float32,
                                 device=self.device)
        self.transition_bias = cfg.transition_bias
        self.transition_bias_denominator = 0.0
        self.crp_alpha = cfg.crp_alpha

    # -- the parameter tree ------------------------------------------------
    @property
    def params(self) -> dict:
        """The reference's `params` tree (flax names and layouts, numpy f32)."""
        return state_dict_to_params(self.core.state_dict(), self.cfg.rnn_depth)

    @params.setter
    def params(self, tree: dict) -> None:
        self.core.load_state_dict(params_to_state_dict(tree, self.cfg.rnn_depth))

    # -- persistence ----------------------------------------------------
    def save(self, path: str):
        save_pytree(path, {
            "params": self.params,
            "init_hidden": self.init_hidden.detach().cpu().numpy(),
            "sigma2": self.sigma2.detach().cpu().numpy(),
            "transition_bias": np.asarray(np.float64(self.transition_bias or 0.0)),
            "transition_bias_denominator": np.asarray(
                np.float64(self.transition_bias_denominator)),
            "crp_alpha": np.asarray(np.float64(self.crp_alpha)),
        })

    def load(self, path: str):
        d = load_pytree(path)
        self.params = d["params"]
        self.init_hidden = torch.tensor(np.asarray(d["init_hidden"]), device=self.device)
        self.sigma2 = torch.tensor(np.asarray(d["sigma2"]), device=self.device)
        self.transition_bias = float(d["transition_bias"])
        self.transition_bias_denominator = float(d["transition_bias_denominator"])
        self.crp_alpha = float(d["crp_alpha"])

    # -- training -------------------------------------------------------
    def fit_concatenated(self, train_sequence, train_cluster_id,
                         args: UISRNNTrainConfig, seed: int = 0):
        train_sequence = np.asarray(train_sequence, np.float64)
        train_cluster_id = np.asarray(train_cluster_id)
        assert train_sequence.ndim == 2
        assert train_sequence.shape[0] == len(train_cluster_id)
        assert train_sequence.shape[1] == self.cfg.observation_dim

        sub_sequences, seq_lengths = resize_sequence(
            train_sequence, train_cluster_id, args.num_permutations, seed
        )
        n_clusters = len(sub_sequences)
        rng = np.random.RandomState(seed)
        fit = FitStep(self, args)

        n_iter = 5 if args.quick_test else args.train_iteration
        batch_size = args.batch_size or n_clusters
        batch_size = min(batch_size, n_clusters)
        nll = []
        for it in range(n_iter):
            batch_idx = np.sort(rng.choice(n_clusters, batch_size, replace=False))
            # the mask is a prefix: no masked step reaches the loss (gru.py)
            x, truth, _ = pack_batch(
                sub_sequences, seq_lengths, batch_idx, self.cfg.observation_dim
            )
            loss, aux = fit.step(torch.from_numpy(x).to(self.device),
                                 torch.from_numpy(np.ascontiguousarray(truth)).to(self.device))
            nll.append(aux[0])
            if it % args.log_iter == 0 or it == n_iter - 1:
                print(f"[uisrnn] iter {it} loss {float(loss):.4f} nll {float(aux[0]):.4f}")

        fit.commit()
        return torch.stack(nll).cpu().tolist() if nll else []

    def fit(self, train_sequences, train_cluster_ids, args: UISRNNTrainConfig):
        """Estimate the transition bias across sequences, concatenate, fit."""
        if isinstance(train_sequences, np.ndarray):
            train_sequences = [train_sequences]
            train_cluster_ids = [train_cluster_ids]
        if self.estimate_transition_bias:
            bias, denom = estimate_transition_bias(train_cluster_ids)
            if self.transition_bias is None:
                self.transition_bias = bias
                self.transition_bias_denominator = denom
            else:
                self.transition_bias = (
                    self.transition_bias * self.transition_bias_denominator
                    + bias * denom
                ) / (self.transition_bias_denominator + denom)
                self.transition_bias_denominator += denom
        seq, ids = concatenate_training_data(train_sequences, train_cluster_ids)
        return self.fit_concatenated(seq, ids, args)

    # -- inference ------------------------------------------------------
    @torch.no_grad()
    def _step(self, x_rows: np.ndarray, hiddens: np.ndarray):
        """One GRU step of B rows on the card: x_rows [B, D], hiddens
        [B, depth, 1, H] -> (means [B, D], new hiddens), numpy."""
        b = x_rows.shape[0]
        depth, h_sz = self.cfg.rnn_depth, self.cfg.rnn_hidden_size
        h = torch.from_numpy(np.asarray(hiddens, np.float32)).to(self.device)
        h = h.permute(1, 0, 2, 3).reshape(depth, b, h_sz)
        x = torch.from_numpy(np.asarray(x_rows, np.float32)).to(self.device)
        mean, h_out = self.core(x[:, None, :], h)
        h_np = h_out.reshape(depth, b, 1, h_sz).permute(1, 0, 2, 3).cpu().numpy()
        return mean[:, -1, :].cpu().numpy(), h_np

    def _update_beam_state(self, beam_state: BeamState, look_ahead_seq,
                           cluster_seq, host=None) -> BeamState:
        """One candidate: the beam state after `cluster_seq`'s assignments."""
        sigma2, init_hidden = host or self._host_state()
        weight = 1.0 / (2.0 * sigma2)
        new = BeamState(beam_state)
        loss = 0.0
        for sub_idx, cluster in enumerate(cluster_seq):
            obs = np.asarray(look_ahead_seq[sub_idx])
            k = len(new.mean_set)
            if cluster > k:
                new.neg_likelihood = float("inf")
                break
            if cluster < k:  # existing cluster
                last = new.trace[-1]
                diff2 = (np.asarray(new.mean_set[cluster]).reshape(-1) - obs) ** 2
                loss = float(np.sum(diff2 * weight))
                if cluster == last:
                    loss -= math.log(1 - self.transition_bias)
                else:
                    loss -= (
                        math.log(self.transition_bias)
                        + math.log(new.block_counts[cluster])
                        - math.log(sum(new.block_counts) + self.crp_alpha)
                    )
                mean, hidden = self._step(obs[None], new.hidden_set[cluster][None])
                count = sum(1 for t in new.trace if t == cluster)
                new.mean_set[cluster] = (
                    np.asarray(new.mean_set[cluster]) * (count - 1) + mean[0]
                ) / count
                new.hidden_set[cluster] = hidden[0]
                if cluster != last:
                    new.block_counts[cluster] += 1
                new.trace.append(cluster)
            else:  # new cluster
                init_h = init_hidden.reshape(
                    self.cfg.rnn_depth, 1, self.cfg.rnn_hidden_size
                )[:, None]
                init_h = init_h.transpose(1, 0, 2, 3)  # [1, depth, 1, H]
                mean0, h0 = self._step(
                    np.zeros((1, self.cfg.observation_dim), np.float32), init_h
                )
                diff2 = (mean0[0] - obs) ** 2
                loss = float(np.sum(diff2 * weight))
                loss -= (
                    math.log(self.transition_bias)
                    + math.log(self.crp_alpha)
                    - math.log(sum(new.block_counts) + self.crp_alpha)
                )
                mean, hidden = self._step(obs[None], h0)
                new.append(mean[0], hidden[0], cluster)
            new.neg_likelihood += loss
        return new

    def _host_state(self):
        """sigma2 and init_hidden as numpy float32 (the beam search's)."""
        return (self.sigma2.detach().cpu().numpy(),
                self.init_hidden.detach().cpu().numpy())

    def _calculate_score(self, beam_state: BeamState, look_ahead_seq, host=None):
        look_ahead = look_ahead_seq.shape[0]
        k = len(beam_state.mean_set)
        shape = tuple(k + 1 + np.arange(look_ahead))
        scores = np.full(shape, np.inf)
        for cluster_seq in np.ndindex(*shape):
            updated = self._update_beam_state(beam_state, look_ahead_seq, cluster_seq, host)
            scores[cluster_seq] = updated.neg_likelihood
        return scores

    def predict_single(self, test_sequence, args: UISRNNInferenceConfig):
        """The cluster id of each observation, by CRP beam search."""
        test_sequence = np.asarray(test_sequence, float)
        assert test_sequence.ndim == 2
        n, d = test_sequence.shape
        assert d == self.cfg.observation_dim
        assert self.transition_bias is not None, "fit or set transition_bias first"
        host = self._host_state()

        seq = np.tile(test_sequence, (args.test_iteration, 1)).astype(np.float32)
        beam_set = [BeamState()]
        for start in range(0, args.test_iteration * n, args.look_ahead):
            look = seq[start : start + args.look_ahead]
            max_clusters = max(len(b.mean_set) for b in beam_set)
            shape = (args.beam_size,) + tuple(
                max_clusters + 1 + np.arange(look.shape[0])
            )
            score_set = np.full(shape, np.inf)
            for rank, bs in enumerate(beam_set):
                s = self._calculate_score(bs, look, host)
                pad = [(0, shape[1 + ax] - s.shape[ax]) for ax in range(s.ndim)]
                score_set[rank] = np.pad(s, pad, constant_values=np.inf)
            flat_order = np.argsort(score_set, axis=None)
            n_finite = int(np.isfinite(np.sort(score_set, axis=None)).sum())
            new_set = []
            for r in range(min(n_finite, args.beam_size)):
                idx = np.unravel_index(flat_order[r], score_set.shape)
                new_set.append(
                    self._update_beam_state(beam_set[idx[0]], look, idx[1:], host)
                )
            beam_set = new_set
        return beam_set[0].trace[-n:]

    def predict(self, test_sequences, args: UISRNNInferenceConfig):
        if isinstance(test_sequences, np.ndarray):
            return self.predict_single(test_sequences, args)
        return [self.predict_single(s, args) for s in test_sequences]


def output_result(model_cfg: UISRNNConfig, train_cfg: UISRNNTrainConfig,
                  test_record) -> str:
    """Experiment summary string."""
    accuracies = [acc for acc, _ in test_record]
    lines = [
        f"sigma_alpha: {train_cfg.sigma_alpha}",
        f"sigma_beta: {train_cfg.sigma_beta}",
        f"crp_alpha: {model_cfg.crp_alpha}",
        f"learning rate: {train_cfg.learning_rate}",
        f"regularization: {train_cfg.regularization_weight}",
        f"batch size: {train_cfg.batch_size}",
        f"averaged accuracy: {np.mean(accuracies):.6f}",
    ] + [f"  {a:.6f}" for a in accuracies]
    return "\n".join(lines)
