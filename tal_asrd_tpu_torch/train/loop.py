"""Training loop over any iterable of batch dicts.

Counterpart of tal_asrd_tpu/train/loop.py `Trainer`: per-epoch keep-all
parameter checkpoints, early stopping (patience on the validation loss),
validation every epoch or every `val_check_interval` steps, and the smoke
modes `quick_test` (one train and one validation batch) and `overfit_pct`
(train on a fraction of the loader, early stopping off). The full training
state (parameters, LAMB moments, step) is written on the last epoch, or on
every checkpoint epoch with `state_ckpt="every"`, and `fit(resume=True)`
continues from the newest one. `generation_hook(step, logger)` (the
system's `make_generation_spotcheck`) runs after each epoch-end
validation; as in the reference, an exception there is printed and
training goes on (the hook's records in the metrics file show whether it
ran).

With a mesh (the system's, parallel/mesh.py) every process runs the loop
on the same global batches; only process 0 logs and writes the msgpack
checkpoints, which hold the gathered full trees (the files of a
one-process run). The validation loss is process 0's, broadcast, so early
stopping decides alike everywhere, and `resume` restores on every process
the state process 0 finds.

A logged step's `step_time_s` is taken after its metrics are read back, so
it includes the device's work. Each epoch's record also carries `train_s`
(the wall time of its training batches, loader included), `loader_wait_s`
(the part of it spent waiting for the next batch) and `audio_s` (the
seconds of audio trained on).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from tal_asrd_tpu_torch.core.checkpoint import CheckpointManager
from tal_asrd_tpu_torch.utils.logging import MetricsLogger


@dataclass
class TrainerConfig:
    max_epochs: int = 100
    max_steps: Optional[int] = None
    early_stop_patience: int = 10
    val_check_interval: Optional[int] = None  # steps; None = per epoch
    quick_test: bool = False
    overfit_pct: float = 0.0
    checkpoint_dir: str = "./checkpoints"
    log_every: int = 50
    ckpt_every: int = 1          # checkpoint every N epochs (the last always)
    # Training-state checkpoints: 'last' writes it only on the final epoch,
    # 'every' on every checkpoint epoch (parameters are always written).
    state_ckpt: str = "last"


def _timed(iterable: Iterable, waits: list):
    """The items of `iterable`, adding the seconds spent waiting for each
    to waits[0]."""
    it = iter(iterable)
    while True:
        t = time.time()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            waits[0] += time.time() - t
        yield item


class _Quiet:
    """The logger of a process other than 0: records nothing."""

    def log_metrics(self, *args, **kwargs) -> None:
        pass

    log_generation = log_metrics


class Trainer:
    def __init__(self, system, cfg: TrainerConfig,
                 logger: Optional[MetricsLogger] = None,
                 generation_hook: Optional[Callable] = None, mesh=None):
        if cfg.state_ckpt not in ("last", "every"):
            raise ValueError(f"state_ckpt must be 'last' or 'every', got {cfg.state_ckpt!r}")
        self.system = system
        self.cfg = cfg
        self.mesh = system.mesh if mesh is None else mesh
        self.lead = self.mesh is None or dist.get_rank() == 0
        self.logger = (logger or MetricsLogger(name="train")) if self.lead else _Quiet()
        self.generation_hook = generation_hook
        self.ckpt = CheckpointManager(cfg.checkpoint_dir)

    def _say(self, text: str) -> None:
        if self.lead:
            print(text)

    def _from_lead(self, value: float) -> float:
        """Process 0's value on every process of a mesh."""
        if self.mesh is None:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self.system.device)
        dist.broadcast(t, 0)
        return float(t)

    def fit(self, train_loader: Iterable, val_loader: Iterable,
            resume: bool = False) -> None:
        """Train the system in place until max_epochs, max_steps or early
        stopping."""
        cfg, system = self.cfg, self.system
        latest = self.ckpt.latest_state_step() if resume else None
        if resume and self.mesh is not None:
            latest = int(self._from_lead(-1 if latest is None else latest))
            latest = None if latest < 0 else latest
        if latest is not None:
            system.load_state_tree(self.ckpt.load_state(step=latest))
            self._say(f"[trainer] resumed the full state at step {system.step}")

        best_val = float("inf")
        bad_epochs = 0
        stop = False
        n_batches = None
        if cfg.quick_test:
            n_batches = 1
        elif cfg.overfit_pct > 0:
            n_batches = max(1, int(len(train_loader) * cfg.overfit_pct))

        for epoch in range(cfg.max_epochs):
            if hasattr(train_loader, "sampler") and hasattr(train_loader.sampler, "set_epoch"):
                train_loader.sampler.set_epoch(epoch)
            t_epoch = time.time()
            waits, samples = [0.0], 0
            for bi, batch in enumerate(_timed(train_loader, waits)):
                if n_batches is not None and bi >= n_batches:
                    break
                # a device tensor's sum stays on the device until the epoch ends
                lens = batch["audio_lens"]
                samples = samples + (lens.sum() if hasattr(lens, "sum") else np.sum(lens))
                t0 = time.time()
                metrics = system.train_step(batch)
                step = system.step
                if step % cfg.log_every == 0 or cfg.quick_test:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    metrics["step_time_s"] = time.time() - t0
                    metrics["epoch"] = epoch
                    self.logger.log_metrics(metrics, step=step)
                if cfg.max_steps is not None and step >= cfg.max_steps:
                    stop = True
                    break
                if cfg.val_check_interval and step % cfg.val_check_interval == 0:
                    self._validate(val_loader, step)
            train_s = time.time() - t_epoch
            audio_s = float(samples) / system.model.frontend.sample_rate
            val_loss = self._validate(val_loader, system.step, n_batches=n_batches)
            if self.generation_hook is not None:
                try:
                    self.generation_hook(system.step, self.logger)
                except Exception as e:  # the spot check never stops training
                    self._say(f"[trainer] generation hook failed: {e!r}")
            # the early-stop decision comes first, so a stopping epoch is
            # checkpointed as the last one (state included)
            if cfg.overfit_pct == 0:
                if val_loss < best_val - 1e-6:
                    best_val = val_loss
                    bad_epochs = 0
                else:
                    bad_epochs += 1
                    if bad_epochs >= cfg.early_stop_patience:
                        self._say(f"[trainer] early stop at epoch {epoch}")
                        stop = True
            last_epoch = stop or cfg.quick_test or epoch == cfg.max_epochs - 1
            if (epoch + 1) % cfg.ckpt_every == 0 or last_epoch:
                with_state = cfg.state_ckpt == "every" or last_epoch
                tree = system.state_tree() if with_state else None
                params = tree["params"] if with_state else system.params_tree()
                if self.lead:
                    self.ckpt.save(system.step, params,
                                   extra={"epoch": epoch, "val_loss": val_loss})
                    if with_state:
                        self.ckpt.save_state(system.step, tree)
                if self.mesh is not None:
                    dist.barrier()      # the files exist for every process
            self.logger.log_metrics(
                {"epoch_time_s": time.time() - t_epoch, "val_loss": val_loss,
                 "train_s": train_s, "loader_wait_s": waits[0], "audio_s": audio_s},
                step=system.step)
            if stop or cfg.quick_test:
                break

    def _validate(self, val_loader: Iterable, step: int,
                  n_batches: Optional[int] = None) -> float:
        losses = []
        for bi, batch in enumerate(val_loader):
            if n_batches is not None and bi >= n_batches:
                break
            losses.append(float(self.system.eval_step(batch)["loss"]))
            if self.cfg.quick_test:
                break
        val = self._from_lead(float(np.mean(losses)) if losses else float("nan"))
        self.logger.log_metrics({"val_loss_step": val}, step=step)
        return val
