"""ASR training system: loss, train and eval steps, optimizer wiring.

Counterpart of tal_asrd_tpu/train/system.py `ASRSystem`:

  * `loss_fn`: unknown speaker tokens clamped to the last speaker id (when
    there are speakers and no speaker loss), 1 % of the input tokens
    replaced by random text tokens, SpecAugment on the log-mel (kernel K4 on
    the card), label-smoothed masked cross entropy; validation uses no
    smoothing. With `spk_weight > 0` (a model with the separate speaker
    head) the loss is lm_loss + spk_weight * spk_loss, the speaker loss the
    same masked cross entropy of the head's logits against `spk_ids[:, 1:]`
    (padding is excluded by the text mask, not by its id);
  * `train_step`: `grad_acc` micro-batches, their gradients averaged, one
    optimizer update; metrics loss, lm_loss, spk_loss, grad_norm (the
    global norm of the averaged gradient);
  * `_make_optimizer`: LAMB at the square-root-scaled learning rate with
    linear decay over `max_steps` (constant without it), as the
    reference's; a subclass overrides it to train with another optimizer
    (`train/optimizers.py`: RAdam, Adafactor, Lookahead), as a JAX user
    would;
  * the model keeps f32 parameters and computes in `compute_dtype` (bf16
    by default, as the reference trains).

The system is stateful, as PyTorch is: it owns the model, the optimizer and
the step count; `state_tree` / `load_state_tree` carry them in the layout of
the reference's TrainState ({"step", "params", "opt_state"}, flax parameter
names; `opt_state` the layout of the optimizer's JAX state, LAMB's
{"count", "mu", "nu"}), which the checkpoint manager writes.
`load_state_tree` restores LAMB's alone (no path of the reference resumes
another optimizer). `step`
and the optimizer's update count (`update_count`, the schedule's count)
part when the training CLI restores the step without the optimizer state,
as the reference's do. `params_spec` / `load_params` carry a partial load
(`core.checkpoint.load_params_partial`) on the reference's names, and
`make_generation_spotcheck` builds the Trainer's spot check.

Randomness. Each step's draws — one SpecAugment seed per example and the
token replacement — come from a generator seeded by (TrainConfig.seed,
step), and are drawn for the whole batch
before it is split into micro-batches, so `grad_acc` does not change them
and a resumed run draws what an uninterrupted one would. Dropout uses
PyTorch's default generator.

Batches are dicts: audio [B, T] f32 (or int16), audio_lens [B] int,
text [B, L] int, text_mask [B, L] bool, spk_ids [B, L] int; numpy arrays or
tensors, moved to the system's device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tal_asrd_tpu_torch.core.config import (
    FrontendConfig,
    ModelConfig,
    SpecAugmentConfig,
    TrainConfig,
)
from tal_asrd_tpu_torch.core.convert import (
    load_partial_into,
    params_spec,
    params_to_state_dict,
    state_dict_to_params,
)
from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, beam_search
from tal_asrd_tpu_torch.models.asr import ASRModel
from tal_asrd_tpu_torch.ops.specaug import draw_seeds
from tal_asrd_tpu_torch.train.losses import masked_token_loss
from tal_asrd_tpu_torch.train.optimizers import LAMB
from tal_asrd_tpu_torch.train.schedules import constant_schedule, linear_decay_schedule

Batch = Dict[str, Any]
METRIC_KEYS = ("loss", "lm_loss", "spk_loss")


class ASRSystem:
    """Owns the model (f32 parameters), the optimizer and the step."""

    def __init__(self, model_cfg: ModelConfig,
                 train_cfg: TrainConfig = TrainConfig(),
                 frontend_cfg: FrontendConfig = FrontendConfig(),
                 specaug_cfg: SpecAugmentConfig = SpecAugmentConfig(),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: str = "cuda",
                 generator: Optional[torch.Generator] = None):
        """Parameters are drawn from the CPU `generator` (see
        ASRModel.reset_parameters). A speaker loss (`spk_weight > 0`) needs
        the speaker head (`use_speaker_head`)."""
        if train_cfg.spk_weight > 0 and not model_cfg.use_speaker_head:
            raise ValueError("spk_weight > 0 trains the separate speaker head: "
                             "set use_speaker_head")
        self.cfg = model_cfg
        self.train_cfg = train_cfg
        self.device = torch.device(device)
        self.model = ASRModel(model_cfg, frontend_cfg, specaug_cfg,
                              dtype=torch.float32, device=device,
                              generator=generator, compute_dtype=compute_dtype)
        self.optimizer = self._make_optimizer()
        self.step = 0

    def _make_optimizer(self) -> torch.optim.Optimizer:
        """The reference's optimizer: LAMB at `_schedule()`, built from the
        named parameters (an optimizer that needs the reference's names,
        Adafactor, finds them there)."""
        return LAMB(self.model.named_parameters(), self._schedule())

    def _schedule(self):
        tc = self.train_cfg
        if tc.scaled_lr is None:
            return constant_schedule(1e-3)
        if tc.max_steps is not None:
            return linear_decay_schedule(tc.scaled_lr, tc.max_steps)
        return constant_schedule(tc.scaled_lr)

    def init_state(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh parameters from the CPU `generator`, zero optimizer
        moments, step 0."""
        self.model.reset_parameters(generator)
        self.optimizer.reset_state()
        self.step = 0


    # ------------------------------------------------------------------
    def _to_device(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def step_generator(self) -> torch.Generator:
        """The generator of this step's draws, seeded by (seed, step)."""
        seed = (self.train_cfg.seed * 2 ** 32 + self.step) % 2 ** 63
        return torch.Generator(device=self.device).manual_seed(seed)

    def draw_noise(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A batch's random draws from the step's generator: SpecAugment
        seeds [B] and the token replacement of the inputs y[:, :-1] ([B, L-1]
        mask and tokens)."""
        generator = self.step_generator()
        b, l = batch["text"].shape
        noise = {"specaug_seeds": draw_seeds(b, generator, self.device)}
        p = self.train_cfg.token_replace_prob
        if p > 0:
            shape = (b, l - 1)
            noise["replace"] = torch.rand(shape, generator=generator,
                                          device=self.device) < p
            noise["replace_tok"] = torch.randint(
                0, self.cfg.vocab_size, shape, generator=generator, device=self.device)
        return noise

    # ------------------------------------------------------------------
    def loss_fn(self, batch: Batch, train: bool,
                noise: Optional[Dict[str, torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of one batch. `train` also puts the model in
        train mode; its random draws are `noise` (`draw_noise`), or drawn
        from the step's generator. Validation uses no label smoothing."""
        cfg, tc = self.cfg, self.train_cfg
        batch = self._to_device(batch)
        self.model.train(train)
        y = batch["text"].long()
        if cfg.num_speakers > 0 and tc.spk_weight == 0:
            # unknown-speaker tokens -> the last speaker id
            y = torch.clamp(y, max=cfg.vocab_size + cfg.num_speakers - 1)
        y_prev, y_target = y[:, :-1], y[:, 1:]
        seeds = None
        if train:
            if noise is None:
                noise = self.draw_noise(batch)
            seeds = noise["specaug_seeds"]
            if "replace" in noise:
                y_prev = torch.where(noise["replace"], noise["replace_tok"], y_prev)
        (lm_logits, spk_logits), _ = self.model(batch["audio"], y_prev, batch["audio_lens"],
                                                train=train, specaug_seeds=seeds)
        smooth = tc.smoothing if train else 0.0
        mask = batch["text_mask"][:, 1:]
        lm_loss = masked_token_loss(lm_logits, y_target, mask, smooth)
        spk_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        if tc.spk_weight > 0:
            spk_loss = masked_token_loss(spk_logits, batch["spk_ids"][:, 1:].long(), mask,
                                         smooth)
        loss = lm_loss + tc.spk_weight * spk_loss
        return loss, {"loss": loss, "lm_loss": lm_loss, "spk_loss": spk_loss}

    def compute_grads(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Average gradient of the batch over `grad_acc` micro-batches into
        the parameters' `.grad`; returns the averaged metrics."""
        acc = self.train_cfg.grad_acc
        batch = self._to_device(batch)
        b = batch["audio"].shape[0]
        if b % acc:
            raise ValueError(f"batch {b} does not split into grad_acc={acc} parts")
        noise = self.draw_noise(batch)
        self.optimizer.zero_grad(set_to_none=True)
        sums = {k: torch.zeros((), device=self.device) for k in METRIC_KEYS}
        mb = b // acc
        for i in range(acc):
            part = slice(i * mb, (i + 1) * mb)
            loss, metrics = self.loss_fn({k: v[part] for k, v in batch.items()}, True,
                                         noise={k: v[part] for k, v in noise.items()})
            (loss / acc).backward()
            for k in METRIC_KEYS:
                sums[k] += metrics[k].detach()
        return {k: v / acc for k, v in sums.items()}

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns 0-dim metric tensors (loss, lm_loss,
        spk_loss, grad_norm) without waiting for the device."""
        metrics = self.compute_grads(batch)
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        metrics["grad_norm"] = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        self.optimizer.step()
        self.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        _, metrics = self.loss_fn(batch, False)
        return metrics

    def make_generation_spotcheck(self, tokenizer, batch: Batch,
                                  max_len: Optional[int] = None):
        """The validation-time spot check: greedy decoding (beam 1,
        force_output) of the first sample of `batch` through the unfused
        model, at most `max_len` or 1.5 x the batch's text length new
        tokens; its GOLD (the target's text tokens) and GENERATED text go to
        `logger.log_generation`. Returns the Trainer's generation_hook,
        hook(step, logger)."""
        one = {k: torch.as_tensor(np.asarray(v)[:1]) for k, v in batch.items()}
        n_text = len(tokenizer)
        spec = BeamSearchSpec(
            beam_size=1,
            max_new_tokens=max_len or int(one["text"].shape[1] * 1.5),
            eos_id=tokenizer.eos_token_id,
            vocab_size=self.cfg.num_tokens,
            text_vocab_size=n_text,
            force_output=True,
        )
        tgt_n = int(one["text_mask"][0].sum())
        ref_ids = [int(t) for t in one["text"][0, : tgt_n - 1] if t < n_text]

        def hook(step: int, logger) -> None:
            model = self.model.eval()
            with torch.inference_mode():
                enc = model.encode(one["audio"].to(self.device),
                                   one["audio_lens"].to(self.device))
                out = beam_search(model, enc, one["text"][:, :1].to(self.device), spec)
                n = int(out["lengths"][0])
                row = out["tokens"][0, :n].cpu().tolist()
            hyp_ids = [t for t in row if t < n_text]
            logger.log_generation(one["audio"][0].numpy(), tokenizer.decode(ref_ids),
                                  tokenizer.decode(hyp_ids), step=step)

        return hook

    # ------------------------------------------------------------------
    def params_tree(self) -> Dict[str, Any]:
        """The parameters as a numpy tree with the reference's names."""
        return state_dict_to_params(self.model.state_dict())

    def state_tree(self) -> Dict[str, Any]:
        """The training state as numpy trees in the reference TrainState's
        layout, its `opt_state` that of the optimizer's JAX state
        (`reference_state()`); moments are zero before the first step."""
        return {"step": np.asarray(self.step, np.int32), "params": self.params_tree(),
                "opt_state": self.optimizer.reference_state()}

    def update_count(self) -> int:
        """Optimizer updates made since its state was last reset: the
        learning rate schedule's count. It equals `step` unless the step
        counter was restored without the optimizer state (a params-only
        warm start)."""
        return self.optimizer.update_count()

    def params_spec(self) -> Dict[str, Any]:
        """The parameter tree's shapes and dtypes (`core.convert.params_spec`),
        the target of `core.checkpoint.load_params_partial`."""
        return params_spec(self.model)

    def load_params(self, tree: Dict[str, Any]) -> None:
        """Copy in what `load_params_partial` returned on `params_spec()`;
        the parameters it kept stay as they are. Optimizer state and step
        are untouched."""
        load_partial_into(self.model, tree)

    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        """Restore parameters, moments and step from `state_tree`'s layout.
        LAMB only: no path of the reference resumes another optimizer."""
        if type(self.optimizer) is not LAMB:
            raise TypeError(f"load_state_tree restores LAMB's state; this system trains "
                            f"with {type(self.optimizer).__name__}, which no path of the "
                            "reference resumes")
        self.model.load_state_dict(params_to_state_dict(tree["params"]), strict=True)
        count = int(tree["opt_state"]["count"])
        mu = params_to_state_dict(tree["opt_state"]["mu"])
        nu = params_to_state_dict(tree["opt_state"]["nu"])
        self.optimizer.state.clear()
        if count > 0:
            for n, p in self.model.named_parameters():
                self.optimizer.state[p] = {
                    "step": count, "exp_avg": mu[n].to(p.device, p.dtype),
                    "exp_avg_sq": nu[n].to(p.device, p.dtype)}
        self.step = int(tree["step"])
