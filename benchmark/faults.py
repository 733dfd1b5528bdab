"""Faults planted under the timed path, to show that a run's check comes out
not correct: the comparison's own test (tests/test_bench_faults.py) and the
readings of faults at a cell's size (`run.py --calibrate --fault NAME`).
`int8_decoder` is no fault but the program's own lower-precision path (the
fused decoder with int8 cross K/V and int8 weights, kv8 + w8), read beside
a served cell's control.

  * stale_state: a step that returns its state unchanged (the decode step
    does not advance its cache index; the optimizer keeps its moments up to
    date and puts the parameters back as they were);
  * half_batch: half of the batch left out and the mean taken over the rest
    (the frontend's batch mean; in training the loss's mean too);
  * altered_token: a token altered where it is produced (every 8th search
    step's chosen tokens); a served cell's fault, since a training step
    produces no token.
"""
from __future__ import annotations

import contextlib

import torch

NAMES = ("stale_state", "half_batch", "altered_token")
TRAINING = ("stale_state", "half_batch")
# the program's own lower-precision path, read beside a served cell's control
LOWER = "int8_decoder"


@contextlib.contextmanager
def planted(name: str):
    if name is None:
        yield
        return
    if name not in NAMES + (LOWER,):
        raise ValueError(f"unknown fault {name!r}; one of {NAMES + (LOWER,)}")
    from tal_asrd_tpu_torch.decode import beam, fused_step
    from tal_asrd_tpu_torch.models import asr
    from tal_asrd_tpu_torch.train import optimizers, system
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == LOWER:
        init = fused_step.FusedASRDecoder.__init__

        def int8_init(self, model, kv8=False, w8=False, stacked=False):
            init(self, model, kv8=True, w8=True, stacked=stacked)
        patch(fused_step.FusedASRDecoder, "__init__", int8_init)
    elif name == "stale_state":
        step = fused_step.FusedASRDecoder.decode_step

        def stale(self, y_tok, state):
            logits, spk, attn, _ = step(self, y_tok, state)
            return logits, spk, attn, state
        patch(fused_step.FusedASRDecoder, "decode_step", stale)
        lamb_step = optimizers.LAMB.step

        def unmoved(self, closure=None):
            params = [p for g in self.param_groups for p in g["params"]]
            with torch.no_grad():
                kept = [p.detach().clone() for p in params]
            out = lamb_step(self, closure)
            with torch.no_grad():
                for p, k in zip(params, kept):
                    p.copy_(k)
            return out
        patch(optimizers.LAMB, "step", unmoved)
    elif name == "half_batch":
        mean, loss = asr.batch_mean, system.masked_token_loss

        def half_mean(mel, audio_lens=None, cfg=None):
            h = max(mel.shape[0] // 2, 1)
            return mean(mel[:h], None if audio_lens is None else audio_lens[:h], cfg)

        def half_loss(logits, targets, mask, smoothing=0.0):
            h = max(logits.shape[0] // 2, 1)
            return loss(logits[:h], targets[:h], mask[:h], smoothing)
        patch(asr, "batch_mean", half_mean)
        patch(system, "masked_token_loss", half_loss)
    else:
        top_k = beam.top_k
        calls = [0]

        def altered_top_k(x, k):
            values, index = top_k(x, k)
            calls[0] += 1
            if calls[0] % 8 == 0:
                v = x.shape[-1] // k
                index = index.clone()
                index[:, 0] = index[:, 0] // v * v + (index[:, 0] % v + 1) % v
            return values, index
        patch(beam, "top_k", altered_top_k)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
