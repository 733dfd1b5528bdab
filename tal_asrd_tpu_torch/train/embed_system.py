"""Contrastive speaker-embedding metric head.

Counterpart of tal_asrd_tpu/train/embed_system.py: a 3-layer MLP (64 ->
256 -> 256 -> 10, ReLU) trained contrastively on exported speaker
embeddings (eval/gen_embed.py): each batch row is [anchor, positive,
negatives...]; the outputs are normalised, the logits are the cosines of
the anchor against the supports, and the loss is the cross entropy with the
positive at index 0. Plain PyTorch: the head is small enough that its step
is a handful of cuBLAS calls, and it runs on no TPU kernel's path.

The layers are named `Dense_0`, `Dense_1`, `Dense_2`, as flax names them,
so `core/convert.py`'s `state_dict_to_params` / `params_to_state_dict` carry
the head to and from the flax tree {"Dense_i": {"kernel" [in, out],
"bias"}} that the JAX package reads (`EmbedSystem.params`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tal_asrd_tpu_torch.core.convert import params_to_state_dict, state_dict_to_params
from tal_asrd_tpu_torch.models.layers import lecun_normal_


class EmbedMLP(nn.Module):
    def __init__(self, in_dim: int = 64, hidden: int = 256, out_dim: int = 10,
                 generator: Optional[torch.Generator] = None):
        """flax `Dense` initialisation: lecun-normal kernels drawn from the
        CPU `generator` (the global RNG if None), zero biases."""
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, out_dim)
        for layer in (self.Dense_0, self.Dense_1, self.Dense_2):
            lecun_normal_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


def contrastive_loss(model: nn.Module, batch: torch.Tensor):
    """batch [B, n_way, D]: row 0 the anchor, 1 the positive, the rest
    negatives. Returns (loss, accuracy), 0-dim tensors."""
    feats = model(batch)
    feats = feats / (torch.linalg.norm(feats, dim=-1, keepdim=True) + 1e-8)
    anchor, support = feats[:, :1], feats[:, 1:]
    logits = torch.einsum("bif,bjf->bj", anchor, support)
    loss = -torch.log_softmax(logits, dim=-1)[:, 0].mean()
    acc = (logits.argmax(dim=-1) == 0).to(torch.float32).mean()
    return loss, acc


class ContrastiveDataset:
    """n-way episodes from (embeddings, speaker_ids): [anchor, positive from
    the same speaker, n-2 negatives from other speakers], drawn in call
    order from numpy's RandomState(seed) with the JAX package's draws, so
    both packages give the same episodes for a seed."""

    def __init__(self, embeddings: np.ndarray, speaker_ids: np.ndarray,
                 n_way: int = 6, seed: int = 0, epoch_len: int = 5000):
        self.emb = np.asarray(embeddings, np.float32)
        self.ids = np.asarray(speaker_ids)
        self.n_way = n_way
        self.rng = np.random.RandomState(seed)
        self.epoch_len = epoch_len
        self.by_speaker: Dict[int, list] = {}
        for i, s in enumerate(self.ids):
            self.by_speaker.setdefault(int(s), []).append(i)
        # speakers with >= 2 samples can anchor
        self.anchors = [s for s, idx in self.by_speaker.items() if len(idx) >= 2]
        if not self.anchors:
            raise ValueError("need at least one speaker with 2+ embeddings")

    def __len__(self) -> int:
        return self.epoch_len

    def __getitem__(self, i: int) -> np.ndarray:
        spk = self.anchors[self.rng.randint(len(self.anchors))]
        a, p = self.rng.choice(self.by_speaker[spk], 2, replace=False)
        negatives = []
        others = [s for s in self.by_speaker if s != spk]
        while len(negatives) < self.n_way - 2 and others:
            s = others[self.rng.randint(len(others))]
            negatives.append(self.rng.choice(self.by_speaker[s]))
        return self.emb[[a, p] + negatives]


class ContrastiveCollator:
    def __call__(self, samples) -> np.ndarray:
        return np.stack(samples, axis=0)


class EmbedSystem:
    """Trainer of the metric head: Adam at lr x sqrt(batch_size), eps 1e-8
    outside the square root, bias-corrected (optax.adam's update), f32.
    `params`, a flax tree as `EmbedSystem.params` returns it, replaces the
    seeded initial weights."""

    def __init__(self, in_dim: int = 64, hidden: int = 256, out_dim: int = 10,
                 lr: float = 1e-4, batch_size: int = 64, seed: int = 0,
                 params: Optional[Dict[str, Any]] = None, device: str = "cuda"):
        self.device = torch.device(device)
        self.model = EmbedMLP(in_dim, hidden, out_dim,
                              generator=torch.Generator().manual_seed(seed))
        if params is not None:
            self.model.load_state_dict(params_to_state_dict(params), strict=True)
        self.model.to(self.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=lr * math.sqrt(batch_size), eps=1e-8)

    @property
    def params(self) -> Dict[str, Any]:
        """The head as a flax tree of numpy arrays."""
        return state_dict_to_params(self.model.state_dict())

    def _batch(self, batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch, np.float32)).to(self.device)

    def train_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        loss, acc = contrastive_loss(self.model, self._batch(batch))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), acc

    def fit(self, batches: Iterator, steps: Optional[int] = None):
        """One Adam step a batch (at most `steps`); returns the per-step
        (losses, accuracies), taken before each update."""
        losses, accs = [], []
        for i, batch in enumerate(batches):
            loss, acc = self.train_step(batch)
            losses.append(float(loss))
            accs.append(float(acc))
            if steps is not None and i + 1 >= steps:
                break
        return losses, accs

    def evaluate(self, batches: Iterator) -> Tuple[float, float]:
        losses, accs = [], []
        with torch.no_grad():
            for batch in batches:
                loss, acc = contrastive_loss(self.model, self._batch(batch))
                losses.append(float(loss))
                accs.append(float(acc))
        return float(np.mean(losses)), float(np.mean(accs))

    def embed(self, x) -> np.ndarray:
        with torch.no_grad():
            return self.model(self._batch(x)).cpu().numpy()
