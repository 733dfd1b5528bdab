"""Training of the shallow-fusion LM.

Counterpart of tal_asrd_tpu/train/lm_system.py:

  * `LMTextDataset`: transcripts encoded without BOS and with EOS, joined
    into one token stream and cut into rows of `max_len` tokens; the rows
    start at 0, max_len, ... below len(stream) - max_len, so the tail row is
    dropped (one row of the whole stream when it is shorter);
  * `LMSystem`: Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    bias-corrected) at lr * sqrt(batch_size); the loss is the masked cross
    entropy of tokens[:, 1:] given tokens[:, :-1], without dropout (the
    reference's loss applies the model in inference mode); `perplexity` is
    exp of the mean of the batches' losses;
  * `batch_iterator`: rows in `np.random.RandomState(seed).permutation`
    order, the tail batch dropped.

Batches are numpy (tokens [B, L] int, mask [B, L] bool), moved to the
system's device. `params()` gives the model's parameters in the reference's
tree (flax names and layouts, core/convert.py), which the checkpoint manager
writes.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from tal_asrd_tpu_torch.core.config import LMConfig
from tal_asrd_tpu_torch.core.convert import state_dict_to_params
from tal_asrd_tpu_torch.models.lm import DecoderLMModel
from tal_asrd_tpu_torch.train.losses import masked_token_loss


class LMTextDataset:
    """Token stream -> fixed-length training rows <EOS> t1 .. tN."""

    def __init__(self, texts: Sequence[str], tokenizer, max_len: int = 512):
        stream: List[int] = []
        for t in texts:
            stream.extend(tokenizer.encode(t, bos_token=False, eos_token=True))
        self.rows = [stream[i:i + max_len]
                     for i in range(0, max(len(stream) - max_len, 1), max_len)]
        if not self.rows:
            self.rows = [stream[:max_len]]
        self.max_len = max_len
        self.pad = tokenizer.pad_token_id

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        row = self.rows[i]
        out = np.full(self.max_len, self.pad, np.int32)
        out[:len(row)] = row
        mask = np.zeros(self.max_len, bool)
        mask[:len(row)] = True
        return out, mask


class LMSystem:
    """Owns the LM (f32 parameters, drawn from seed 0), its Adam optimizer
    and the step."""

    def __init__(self, cfg: LMConfig, lr: float = 1e-4, batch_size: int = 64,
                 device: str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = DecoderLMModel(cfg, device=device,
                                    generator=torch.Generator().manual_seed(0))
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=lr * float(np.sqrt(batch_size)),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.step = 0

    def _loss(self, tokens, mask) -> torch.Tensor:
        tokens = torch.as_tensor(tokens).to(self.device, torch.long)
        mask = torch.as_tensor(mask).to(self.device)
        logits = self.model(tokens[:, :-1])
        return masked_token_loss(logits, tokens[:, 1:], mask[:, 1:])

    def train_step(self, tokens, mask) -> torch.Tensor:
        """One Adam update; returns the batch's loss (a device scalar)."""
        loss = self._loss(tokens, mask)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    def fit(self, batches: Iterator, steps: Optional[int] = None) -> List[float]:
        losses = []
        for i, (tokens, mask) in enumerate(batches):
            losses.append(float(self.train_step(tokens, mask)))
            if steps is not None and i + 1 >= steps:
                break
        return losses

    def perplexity(self, batches: Iterator) -> float:
        with torch.no_grad():
            losses = [float(self._loss(t, m)) for t, m in batches]
        return float(np.exp(np.mean(losses)))

    def params(self) -> Dict[str, Any]:
        """The parameter tree in the reference's names and layouts (numpy)."""
        return state_dict_to_params(self.model.state_dict())


def batch_iterator(dataset: LMTextDataset, batch_size: int, seed: int = 0,
                   epochs: int = 1):
    rng = np.random.RandomState(seed)
    for _ in range(epochs):
        order = rng.permutation(len(dataset))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            rows = [dataset[j] for j in order[i:i + batch_size]]
            yield np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])
