"""Training system of the separate speaker-diarization baseline.

Counterpart of tal_asrd_tpu/baseline/sd_system.py `SDSystem`: SDModel
trained as a frame-level speaker classifier. Each sample is one utterance
whose speaker id is broadcast over its encoder frames; the loss is the
masked cross entropy and the metric the masked accuracy, both over the
unpadded frames. LAMB runs at `constant_schedule(1e-3)` when the config has
no learning rate, else at the square-root-scaled rate, decayed linearly over
`max_steps` when that is set and constant otherwise.

The system is stateful, as ASRSystem (train/system.py): it owns the model
(f32 parameters, bf16 compute by default), the optimizer and the step.
Each training step draws its SpecAugment seeds from a generator seeded by
(TrainConfig.seed, step); dropout uses PyTorch's default generator.
`params_tree` gives the parameters in the reference's names and layouts
(what the training CLI saves).

Batches are dicts of numpy arrays or tensors: audio [B, T], audio_lens [B],
speaker [B] (data/collate.py SDCollater).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tal_asrd_tpu_torch.core.config import (
    FrontendConfig,
    SDModelConfig,
    SpecAugmentConfig,
    TrainConfig,
)
from tal_asrd_tpu_torch.core.convert import load_into, state_dict_to_params
from tal_asrd_tpu_torch.models.sd import SDModel
from tal_asrd_tpu_torch.train.losses import masked_accuracy, masked_token_loss
from tal_asrd_tpu_torch.train.optimizers import LAMB
from tal_asrd_tpu_torch.train.schedules import constant_schedule, linear_decay_schedule

Batch = Dict[str, Any]


class SDSystem:
    def __init__(self, model_cfg: SDModelConfig,
                 train_cfg: TrainConfig = TrainConfig(),
                 frontend_cfg: FrontendConfig = FrontendConfig(),
                 specaug_cfg: SpecAugmentConfig = SpecAugmentConfig(),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: str = "cuda",
                 generator: Optional[torch.Generator] = None):
        """Parameters are drawn from the CPU `generator` (SDModel)."""
        self.cfg = model_cfg
        self.train_cfg = train_cfg
        self.device = torch.device(device)
        self.model = SDModel(model_cfg, frontend_cfg, specaug_cfg, dtype=torch.float32,
                             device=device, generator=generator,
                             compute_dtype=compute_dtype)
        scaled = train_cfg.scaled_lr
        if scaled is None:
            schedule = constant_schedule(1e-3)
        elif train_cfg.max_steps is not None:
            schedule = linear_decay_schedule(scaled, train_cfg.max_steps)
        else:
            schedule = constant_schedule(scaled)
        self.optimizer = LAMB(self.model.parameters(), schedule)
        self.step = 0

    def _to_device(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def step_generator(self) -> torch.Generator:
        """The generator of this step's SpecAugment seeds, seeded by
        (seed, step)."""
        seed = (self.train_cfg.seed * 2 ** 32 + self.step) % 2 ** 63
        return torch.Generator(device=self.device).manual_seed(seed)

    def loss_fn(self, batch: Batch, train: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"loss", "spk_acc"}) of one batch; `train` also puts the
        model in train mode (dropout, SpecAugment)."""
        batch = self._to_device(batch)
        self.model.train(train)
        logits, enc = self.model(batch["audio"], batch["audio_lens"], train=train,
                                 generator=self.step_generator() if train else None)
        b, s, _ = logits.shape
        target = batch["speaker"].long()[:, None].expand(b, s)
        mask = ~enc["encoder_padding_mask"]
        loss = masked_token_loss(logits, target, mask)
        return loss, {"loss": loss, "spk_acc": masked_accuracy(logits, target, mask)}

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One LAMB step; returns 0-dim metric tensors without waiting for
        the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(batch, True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return self.loss_fn(batch, False)[1]

    @torch.no_grad()
    def frame_features(self, audio, audio_lens) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(embeddings [B, S, embed_size] float32, argmax speaker ids [B, S],
        padding mask [B, S] bool) as numpy, in eval mode: what the
        reconciliation pipeline reads."""
        batch = self._to_device({"audio": audio, "audio_lens": audio_lens})
        self.model.eval()
        enc = self.model.encode(batch["audio"], batch["audio_lens"])
        emb = self.model.embed(enc)
        logits = self.model.spk_logit_proj(emb)
        return (emb.float().cpu().numpy(), logits.argmax(-1).cpu().numpy(),
                enc["encoder_padding_mask"].cpu().numpy())

    def params_tree(self) -> Dict[str, Any]:
        """The parameters as a numpy tree with the reference's names."""
        return state_dict_to_params(self.model.state_dict())

    def load_params(self, tree: Dict[str, Any]) -> None:
        """Fill the model from a reference parameter tree (every leaf, shapes
        checked)."""
        load_into(self.model, tree)
