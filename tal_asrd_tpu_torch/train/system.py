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

With a `mesh` (parallel/mesh.py; one process per position, every process
building the system with the same arguments and initial weights), the step
is the one-process step on the global batch:

  * `train_step` and `eval_step` take the global batch on every process
    and keep this process's rows, in JAX's order: with `grad_acc` the
    batch is cut into micro-batches first and each micro-batch split over
    the data axes. The random draws are made for the global batch and
    sliced alike;
  * the losses are masked sums over the process's tokens divided by the
    global micro-batch's token count (an all-reduce), the frontend's mean
    and the longest audio are the global batch's (models/asr.py), and the
    gradients are summed over the data axes in one all-reduce; the metrics
    are global;
  * on a model axis of more than one process the model is tensor-parallel
    (parallel/tensor.py): parameters, their gradients and the optimizer's
    moments are shards; `grad_norm` and LAMB's trust ratios are over whole
    leaves; `params_tree`, `state_tree` and `params_spec` are the full
    trees, gathered (collectives: every process calls them), and the loads
    take full trees and keep the shards;
  * dropout draws from PyTorch's default generator, seeded by (seed, data
    index) on a data axis of more than one process (with one, as the
    caller seeded it: the CLI seeds every process alike): the processes of
    one data index draw the same masks, so their replicated activations
    stay equal;
  * the spot check gathers the parameters on every process and decodes on
    process 0 alone, through a plain replica.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
from tal_asrd_tpu_torch.train.losses import log_softmax_cross_entropy, masked_token_loss
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
                 generator: Optional[torch.Generator] = None,
                 mesh=None):
        """Parameters are drawn from the CPU `generator` (see
        ASRModel.reset_parameters). A speaker loss (`spk_weight > 0`) needs
        the speaker head (`use_speaker_head`). `mesh`: a DeviceMesh of
        parallel/mesh.py (see the module's notes)."""
        if train_cfg.spk_weight > 0 and not model_cfg.use_speaker_head:
            raise ValueError("spk_weight > 0 trains the separate speaker head: "
                             "set use_speaker_head")
        self.cfg = model_cfg
        self.train_cfg = train_cfg
        self.device = torch.device(device)
        self.model = ASRModel(model_cfg, frontend_cfg, specaug_cfg,
                              dtype=torch.float32, device=device,
                              generator=generator, compute_dtype=compute_dtype)
        self.mesh = mesh
        self.shards = None
        self.data_group, self.data_rank, self.data_size = None, 0, 1
        if mesh is not None:
            from tal_asrd_tpu_torch.parallel.mesh import mesh_group
            from tal_asrd_tpu_torch.parallel.tensor import parallelize
            self.data_group, members = mesh_group(mesh, "data")
            self.data_rank, self.data_size = members.index(dist.get_rank()), len(members)
            self.shards = parallelize(self.model, mesh)
            self.model.data_group = self.data_group
            if self.data_size > 1:
                torch.manual_seed(train_cfg.seed * 1_000_003 + self.data_rank)
        self._replica = None
        self.optimizer = self._make_optimizer()
        if self.shards is not None:
            self.optimizer.set_shards(self.shards)
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
        if self.shards is None:
            self.model.reset_parameters(generator)
        else:       # drawn whole, as one process draws them, then cut
            fresh = ASRModel(self.cfg, self.model.frontend, self.model.specaug,
                             device="cpu", generator=generator)
            self.load_state_dict_full(fresh.state_dict())
        self.optimizer.reset_state()
        self.step = 0

    # ------------------------------------------------------------------
    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict with every sharded entry gathered whole
        (a collective on a tensor-parallel model)."""
        sd = self.model.state_dict()
        if self.shards is None:
            return sd
        return {n: self.shards.gather(n, t) if self.shards.sharded(n) else t
                for n, t in sd.items()}

    def load_state_dict_full(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load a full state_dict, keeping this process's shards."""
        self.model.load_state_dict(self._localize(sd), strict=True)

    def _localize(self, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.shards is None:
            return sd
        return {n: self.shards.local(n, t) if self.shards.sharded(n) else t
                for n, t in sd.items()}


    # ------------------------------------------------------------------
    def _to_device(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _rows(self, b: int) -> np.ndarray:
        """This process's rows of a global batch of `b`: each of the
        `grad_acc` micro-batches split over the data axes, in order."""
        acc = self.train_cfg.grad_acc
        if b % acc:
            raise ValueError(f"batch {b} does not split into grad_acc={acc} parts")
        mb = b // acc
        if mb % self.data_size:
            raise ValueError(f"a micro-batch of {mb} does not split over the data axes "
                             f"({self.data_size})")
        part = mb // self.data_size
        return np.concatenate([np.arange(i * mb + self.data_rank * part,
                                         i * mb + (self.data_rank + 1) * part)
                               for i in range(acc)])

    def _global(self, values: torch.Tensor, group) -> torch.Tensor:
        """Partial sums (of this process's rows, or of its shards) summed
        over `group`."""
        if group is not None:
            values = values.clone()
            dist.all_reduce(values, group=group)
        return values

    def _token_loss(self, logits, targets, mask, smoothing) -> torch.Tensor:
        """masked_token_loss; with a data group, this process's masked sum
        over the global token count."""
        group = self.model.data_group
        if group is None:
            return masked_token_loss(logits, targets, mask, smoothing)
        m = mask.to(torch.float32)
        count = self._global(m.sum(), group)
        return (log_softmax_cross_entropy(logits, targets, smoothing) * m).sum() / \
            count.clamp(min=1.0)

    def step_generator(self) -> torch.Generator:
        """The generator of this step's draws, seeded by (seed, step)."""
        seed = (self.train_cfg.seed * 2 ** 32 + self.step) % 2 ** 63
        return torch.Generator(device=self.device).manual_seed(seed)

    def draw_noise(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A batch's random draws from the step's generator: SpecAugment
        seeds [B] and the token replacement of the inputs y[:, :-1] ([B, L-1]
        mask and tokens)."""
        generator = self.step_generator()
        b, l = tuple(batch["text"].shape)
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
        lm_loss = self._token_loss(lm_logits, y_target, mask, smooth)
        spk_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        if tc.spk_weight > 0:
            spk_loss = self._token_loss(spk_logits, batch["spk_ids"][:, 1:].long(), mask,
                                        smooth)
        loss = lm_loss + tc.spk_weight * spk_loss
        return loss, {"loss": loss, "lm_loss": lm_loss, "spk_loss": spk_loss}

    def compute_grads(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Average gradient of the batch over `grad_acc` micro-batches into
        the parameters' `.grad`; returns the averaged metrics."""
        acc = self.train_cfg.grad_acc
        b = len(batch["audio"])
        if b % acc:
            raise ValueError(f"batch {b} does not split into grad_acc={acc} parts")
        noise = self.draw_noise(batch)
        if self.mesh is not None:     # this process's rows of the global batch
            rows = self._rows(b)
            batch = {k: v[rows] for k, v in batch.items()}
            idx = torch.as_tensor(rows, device=self.device)
            noise = {k: v[idx] for k, v in noise.items()}
            b = len(rows)
        batch = self._to_device(batch)
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
        if self.data_group is not None:
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.data_group)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
            total = self._global(torch.stack([sums[k] for k in METRIC_KEYS]),
                                 self.data_group)
            sums = dict(zip(METRIC_KEYS, total))
        return {k: v / acc for k, v in sums.items()}

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns 0-dim metric tensors (loss, lm_loss,
        spk_loss, grad_norm) without waiting for the device."""
        metrics = self.compute_grads(batch)
        named = [(n, p.grad) for n, p in self.model.named_parameters() if p.grad is not None]
        if self.shards is None:
            sq = sum(g.float().pow(2).sum() for _, g in named)
        else:   # the sharded leaves' squares summed over the model axis
            cut = [self.shards.sharded(n) for n, _ in named]
            zero = torch.zeros((), device=self.device)
            parts = torch.stack([sum((g.float().pow(2).sum() for (_, g), c in zip(named, cut)
                                      if c == keep), zero) for keep in (True, False)])
            sq = self._global(parts[0], self.shards.group) + parts[1]
        metrics["grad_norm"] = torch.sqrt(sq)
        self.optimizer.step()
        self.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Metrics of a batch (the global batch with a mesh: split over the
        data axes when it divides, else evaluated whole on every process)."""
        group = self.data_group
        if group is not None:
            b = len(batch["audio"])
            if b % self.data_size:
                group = None
            else:
                part = b // self.data_size
                batch = {k: v[self.data_rank * part:(self.data_rank + 1) * part]
                         for k, v in batch.items()}
        self.model.data_group = group
        try:
            _, metrics = self.loss_fn(batch, False)
        finally:
            self.model.data_group = self.data_group
        if group is not None:
            total = self._global(torch.stack([metrics[k] for k in METRIC_KEYS]), group)
            metrics = dict(zip(METRIC_KEYS, total))
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
            model = self._spotcheck_model()
            if model is None:       # another process of a mesh
                return
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

    def _spotcheck_model(self):
        """The model the spot check decodes with, in eval mode: the model
        itself without a mesh; with one, on process 0 a plain replica
        holding the gathered parameters (None on the others, which take
        part in the gather only)."""
        if self.mesh is None:
            return self.model.eval()
        full = self.full_state_dict()
        if dist.get_rank() != 0:
            return None
        if self._replica is None:
            # nn.Module constructors draw from the default generator: keep its
            # state, so that the dropout stream is a one-process run's
            with torch.random.fork_rng(devices=[]):
                self._replica = ASRModel(self.cfg, self.model.frontend, self.model.specaug,
                                         device=self.device, generator=torch.Generator(),
                                         compute_dtype=self.model.compute_dtype)
        self._replica.load_state_dict(full, strict=True)
        return self._replica.eval()

    # ------------------------------------------------------------------
    def params_tree(self) -> Dict[str, Any]:
        """The parameters as a numpy tree with the reference's names (whole
        leaves: a collective on a tensor-parallel model)."""
        return state_dict_to_params(self.full_state_dict())

    def state_tree(self) -> Dict[str, Any]:
        """The training state as numpy trees in the reference TrainState's
        layout, its `opt_state` that of the optimizer's JAX state
        (`reference_state()`); moments are zero before the first step."""
        return {"step": np.asarray(self.step, np.int32), "params": self.params_tree(),
                "opt_state": self.optimizer.reference_state()}

    # ------------------------------------------------------------------
    def _sharded(self, name: str, t: torch.Tensor, dim: Optional[int]):
        """`t`, a state tensor of parameter `name` that is its shard on
        `dim` (None: whole), as a DTensor on the mesh (replicated over the
        data axes) when sharded."""
        if dim is None or self.shards is None or not self.shards.sharded(name):
            return t
        from torch.distributed.tensor import DTensor, Replicate, Shard
        placements = [Replicate()] * (self.mesh.ndim - 1) + [Shard(dim)]
        return DTensor.from_local(t, self.mesh, placements, run_check=False)

    def _opt_state_dims(self, opt, name: str, key: str, t: torch.Tensor) -> Optional[int]:
        """The sharded axis of optimizer state `key` of parameter `name`."""
        from tal_asrd_tpu_torch.train.optimizers import Adafactor
        if self.shards is None or not self.shards.sharded(name):
            return None
        plan = self.shards.plans[name]
        if not isinstance(opt, Adafactor):
            return plan.dim if t.shape == self.model.get_parameter(name).shape else None
        a, n = plan.ref_dim, len(plan.ref_shape)      # Adafactor: the reference's layout
        return {"vr": None if a == n - 1 else a,
                "vc": None if a == n - 2 else min(a, n - 2)}.get(key, a)

    def _opt_tree(self, opt) -> Dict[str, Any]:
        tree: Dict[str, Any] = {}
        for group in opt.param_groups:
            for name, p in zip(group["param_names"], group["params"]):
                tree[name] = {k: self._sharded(name, v, self._opt_state_dims(opt, name, k, v))
                              if isinstance(v, torch.Tensor)
                              else torch.tensor(v, dtype=torch.int64)
                              for k, v in opt.state.get(p, {}).items()}
        inner = getattr(opt, "inner", None)
        return tree if inner is None else {"outer": tree, "inner": self._opt_tree(inner)}

    @torch.no_grad()
    def sync_replicas(self) -> None:
        """Give every process of the model axis its first process's copy of
        the replicated parameters and of their optimizer state (a broadcast
        over the axis; every process calls it). Each process computes the
        replicated parameters' gradients itself, and the card's
        nondeterministic kernels can part the copies by rounding."""
        if self.shards is None:
            return
        from tal_asrd_tpu_torch.parallel.mesh import mesh_group
        group, members = mesh_group(self.mesh, "model")
        params = [p for n, p in self.model.named_parameters() if not self.shards.sharded(n)]
        opts = [self.optimizer] + ([self.optimizer.inner]
                                   if hasattr(self.optimizer, "inner") else [])
        tensors = [p.data for p in params] + [
            v for opt in opts for p in params for v in opt.state.get(p, {}).values()
            if isinstance(v, torch.Tensor)]
        for dtype in {t.dtype for t in tensors}:
            same = [t for t in tensors if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.broadcast(flat, src=members[0], group=group)
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))

    def sharded_state(self) -> Dict[str, Any]:
        """The training state for `ShardedCheckpointManager`: {"step",
        "params", "opt_state"} keyed by state_dict name, each sharded leaf a
        DTensor over the mesh holding this process's shard (its storage:
        loading into the tree writes into the system). The replicas are
        made equal first (`sync_replicas`), so the checkpoint holds the
        state every process holds."""
        self.sync_replicas()
        return {"step": torch.tensor(self.step, dtype=torch.int64),
                "params": {n: self._sharded(n, p.detach(), self.shards.plans[n].dim
                                            if self.shards is not None else None)
                           for n, p in self.model.named_parameters()},
                "opt_state": self._opt_tree(self.optimizer)}

    @torch.no_grad()
    def load_sharded_state(self, tree: Dict[str, Any]) -> None:
        """Copy a tree of `sharded_state`'s keys into the system."""
        from torch.distributed.tensor import DTensor

        def local(v):
            return v.to_local() if isinstance(v, DTensor) else v

        def restore(opt, sub):
            inner = getattr(opt, "inner", None)
            if inner is not None:
                restore(inner, sub["inner"])
                sub = sub["outer"]
            for group in opt.param_groups:
                for name, p in zip(group["param_names"], group["params"]):
                    state = opt.state[p]
                    for k, v in sub.get(name, {}).items():
                        if k in ("step", "counter"):        # the counts, Python ints
                            state[k] = int(local(v))
                        elif k in state:
                            state[k].copy_(local(v))
                        else:
                            state[k] = local(v).clone()

        for n, p in self.model.named_parameters():
            p.copy_(local(tree["params"][n]))
        restore(self.optimizer, tree["opt_state"])
        self.step = int(tree["step"])

    def update_count(self) -> int:
        """Optimizer updates made since its state was last reset: the
        learning rate schedule's count. It equals `step` unless the step
        counter was restored without the optimizer state (a params-only
        warm start)."""
        return self.optimizer.update_count()

    def params_spec(self) -> Dict[str, Any]:
        """The parameter tree's shapes and dtypes (`core.convert.params_spec`,
        whole leaves), the target of `core.checkpoint.load_params_partial`."""
        if self.shards is None:
            return params_spec(self.model)
        return params_spec({n: torch.empty(self.shards.plans[n].shape if self.shards.sharded(n)
                                           else t.shape, dtype=t.dtype, device="meta")
                            for n, t in self.model.state_dict().items()})

    def load_params(self, tree: Dict[str, Any]) -> None:
        """Copy in what `load_params_partial` returned on `params_spec()`;
        the parameters it kept stay as they are. Optimizer state and step
        are untouched."""
        load_partial_into(self.model, tree, self._localize)

    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        """Restore parameters, moments and step from `state_tree`'s layout.
        LAMB only: no path of the reference resumes another optimizer."""
        if type(self.optimizer) is not LAMB:
            raise TypeError(f"load_state_tree restores LAMB's state; this system trains "
                            f"with {type(self.optimizer).__name__}, which no path of the "
                            "reference resumes")
        self.load_state_dict_full(params_to_state_dict(tree["params"]))
        count = int(tree["opt_state"]["count"])
        mu = self._localize(params_to_state_dict(tree["opt_state"]["mu"]))
        nu = self._localize(params_to_state_dict(tree["opt_state"]["nu"]))
        self.optimizer.state.clear()
        if count > 0:
            for n, p in self.model.named_parameters():
                self.optimizer.state[p] = {
                    "step": count, "exp_avg": mu[n].to(p.device, p.dtype),
                    "exp_avg_sq": nu[n].to(p.device, p.dtype)}
        self.step = int(tree["step"])
