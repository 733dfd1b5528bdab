"""Unaligned full-episode decoding: the sliding-window attention-tracked
state machine, as a host loop over device tensors.

Counterpart of tal_asrd_tpu/decode/unaligned.py (which runs the machine as
two nested on-device while_loops and vmaps them over episodes). A
`chunk_size`-frame encoder window (357 frames ~ 28.5 s) and a
<= max_positions text-history window walk over the episode; per generated
token the mean cross-attention (over layers and heads) gives an
attention-centroid progress estimate that drives the machine:

  * progress > thresh_prct      -> advance the window by shift_prct and
                                   delete the proportional history prefix;
  * stall (no progress for stall_patience steps) or n-gram repetition
                                -> skip ahead skip_prct, roll back the
                                   repeated tokens, reset history to EOS;
  * a reset inside the last window terminates;
  * history at max_positions    -> evict `history_evict_block` tokens and
                                   prefill again (1 = the reference's slide);
  * extensions, both off by default: `eos_advance` (an emitted EOS advances
    the window to the attention centroid and re-primes the history) and
    `stall_rollback` (a stall reset also rolls back the tokens emitted since
    the last progress).

Each window event ("outer" step) slices the window (clamped at the last
window start, zero-padded when the episode is shorter than a chunk),
precomputes its cross K/V and prefills the decoder cache causally over the
history slice (positions restart at 0). Each token ("inner" step) takes the
argmax of the previous logits, reads it and the progress on the host (one
sync a token, as beam search), runs the state machine's arithmetic on host
integers, and runs the next decode step only when the inner loop goes on
(JAX computes it always and throws it away at an event). Every event, clamp
and budget is JAX's, including the buffers' quirks: the history slice of
`max_positions` tokens starts at most at `max_tokens - max_positions`
(`dynamic_slice` clamps its start), and the n-gram test reads the history
before the token just emitted.

LM shallow fusion (an LM given and `lm_weight` > 0): at every window event
the LM (models/lm.py) prefills over the same history slice, speaker tokens
clamped to `text_vocab_size - 1`, and its logits at the history's last
token are kept; each token is the argmax of the decoder's f32 log-softmax
plus `lm_weight` times the LM's over their common width; the LM then steps
on that token at the decoder's cache index, in step with the decoder.

`model` is an ASRModel or a FusedASRDecoder (anything with
`precompute_mem_kvs`, `decode_prefill` and `decode_step`). The window's pad
mask is a new tensor at every window event, so FusedASRDecoder rebuilds its
pad bias there (the last window is the only one with padding).

Batch: `unaligned_decode_batched` encodes nothing; it runs the single-lane
machine on each lane of a batched encoder output in turn (each lane with
LM caches of its own). The kernels take
one cache index per launch, and lanes of the machine stand at different
indices, so lanes share no launch; each lane's result is its single-lane
run, bit for bit, and each lane's kv8 scales are its own, as in JAX's
vmapped machine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from tal_asrd_tpu_torch.decode.beam import fuse_lm
from tal_asrd_tpu_torch.ops.ngram import RepeatCounter


@dataclass
class UnalignedSpec:
    eos_id: int
    chunk_size: int = 357
    max_positions: int = 512
    thresh_prct: float = 0.5
    shift_prct: float = 0.25
    stall_patience: int = 25
    rep_n: int = 5
    skip_prct: float = 0.1
    max_tokens: int = 4096        # generated-token buffer (fixed)
    max_iters: int = 100000       # total decode-step budget
    max_outer: int = 4096         # window-reconfiguration budget
    history_evict_block: int = 64 # tokens evicted when history hits cap (1 = reference)
    warmup_window_steps: int = 5  # progress floor not raised in the first steps
    # LM shallow fusion: read only when an LM is given
    lm_weight: float = 0.0
    text_vocab_size: Optional[int] = None
    # Extensions beyond the reference (both off = parity); see the module
    # docstring and tal_asrd_tpu/decode/unaligned.py.
    eos_advance: bool = False
    stall_rollback: bool = False


EVENT_KEYS = ("windows", "shifts", "stall_resets", "repeat_resets", "evictions",
              "eos_advances", "terminations")


def unaligned_decode(
    model,
    encoder_out: Dict[str, Any],
    encoder_len: int,
    spec: UnalignedSpec,
    lm=None,
) -> Dict[str, Any]:
    """Decode one episode. encoder_out['encoder_out']: [1, S_full, D];
    `lm` a DecoderLMModel on the same device, or None.

    Returns:
      tokens      [1, max_tokens] int32 (CPU; starts with the EOS prime)
      num_tokens  int                   total tokens incl. the prime
      align_attn  [max_tokens, chunk_size] bf16 (the model's device)
      align_chunk [max_tokens] int32 (CPU) window offset per generated token
      iters       int                   decode steps taken
      events      {windows, shifts, stall_resets, repeat_resets, evictions,
                   eos_advances, terminations}: counts (a window is one
                   prefill; a reset that is both counts as a repeat)
    """
    use_lm = lm is not None and spec.lm_weight > 0
    if use_lm and spec.text_vocab_size is None:
        raise ValueError("LM fusion needs spec.text_vocab_size")
    enc = encoder_out["encoder_out"]
    if enc.shape[0] != 1:
        raise ValueError(f"unaligned_decode takes one episode, got {enc.shape[0]}")
    dev = enc.device
    s_full = enc.shape[1]
    chunk, p_max, l_max = spec.chunk_size, spec.max_positions, spec.max_tokens
    skip_amt = int(chunk * spec.skip_prct)
    shift_amt = int(chunk * spec.shift_prct)
    del_prct = np.float32(spec.shift_prct / spec.thresh_prct)
    thresh = np.float32(spec.thresh_prct)    # compared in f32, as JAX does
    rollback = 2 * spec.rep_n - 1
    eos = spec.eos_id

    encoder_len = min(int(encoder_len), s_full)
    last_chunk_start = max(encoder_len - chunk, 0)
    attn_range = torch.arange(chunk, dtype=torch.float32, device=dev) / chunk

    gen = np.zeros((l_max,), np.int32)
    gen[0] = eos
    align_attn = torch.zeros((l_max, chunk), dtype=torch.bfloat16, device=dev)
    align_chunk = np.zeros((l_max,), np.int32)
    gen_len, chunk_start, history_start = 1, 0, 0
    highest = np.float32(0.0)
    no_improve = window_time = iters = outer = 0
    done = False
    events = dict.fromkeys(EVENT_KEYS, 0)
    repeats = RepeatCounter(spec.rep_n, p_max)

    def hist_slice_start(hs: int) -> int:
        # dynamic_slice of p_max tokens from hs, clamped into the buffer
        return min(max(hs, 0), l_max - p_max)

    with torch.inference_mode():
        while (not done and iters < spec.max_iters and outer < spec.max_outer
               and gen_len < l_max - 1):
            chunk_start = min(chunk_start, last_chunk_start)
            # ---- window slice, its pad mask and cross K/V ----
            window = enc[:, chunk_start:chunk_start + min(chunk, s_full)]
            if chunk > s_full:          # short episode: pad the window to a chunk
                window = torch.nn.functional.pad(window, (0, 0, 0, chunk - s_full))
            wmask = ((chunk_start + torch.arange(chunk, device=dev)) >= encoder_len)[None]
            mem_kvs = model.precompute_mem_kvs(window)

            # ---- prefill the cache over the history slice ----
            h0 = hist_slice_start(history_start)
            hist = torch.from_numpy(gen[h0:h0 + p_max].astype(np.int64))[None].to(dev)
            valid = gen_len - history_start
            logits_all, attn_all, caches = model.decode_prefill(hist, mem_kvs, wmask, p_max)
            at = min(max(valid - 1, 0), p_max - 1)
            last_logits = logits_all[0, at]
            last_attn = attn_all[0, at].to(torch.float32)
            if use_lm:
                lm_all, lm_caches = lm.decode_prefill(
                    hist.clamp(max=spec.text_vocab_size - 1), p_max)
                lm_last = lm_all[0, at]
            events["windows"] += 1
            is_last = (encoder_len - chunk_start) <= chunk
            state = {"mem_kvs": mem_kvs, "caches": caches, "index": valid, "mask": wmask}
            cache_idx = valid
            event = False

            def token_loop_goes_on() -> bool:
                return (not event and not done and iters < spec.max_iters
                        and gen_len < l_max - 1 and cache_idx < p_max)

            # ---- token steps until a window event ----
            while token_loop_goes_on():
                # one read: the argmax token (kept on the device too, as the
                # next step's input) and the attention centroid
                if use_lm:
                    tok = fuse_lm(last_logits, lm_last, spec.lm_weight,
                                  min(last_logits.shape[-1], lm_last.shape[-1])).argmax()
                else:
                    tok = last_logits.argmax()
                tok_f, prct = torch.stack([
                    tok.to(torch.float32), (last_attn * attn_range).sum()]).cpu().numpy()
                next_tok = int(tok_f)
                prct = np.float32(prct)
                old_len = gen_len
                gen[gen_len] = next_tok
                align_attn[gen_len - 1] = last_attn.to(torch.bfloat16)
                align_chunk[gen_len - 1] = chunk_start
                gen_len += 1

                # progress
                improved = bool(prct > highest)
                no_improve = 0 if improved else no_improve + 1
                if improved and window_time > spec.warmup_window_steps:
                    highest = prct
                stalling = no_improve >= spec.stall_patience

                # repetition over the model's input: the history before this token
                h0 = hist_slice_start(history_start)
                n_rep = repeats.count(gen[h0:h0 + p_max], old_len - history_start,
                                      key=(h0, history_start, outer))
                repeating = n_rep > 2 * spec.rep_n

                eos_fire = spec.eos_advance and next_tok == eos
                at_end = chunk_start >= last_chunk_start
                eos_go = eos_fire and not at_end
                eos_adv = max(int(prct * np.float32(chunk)), skip_amt)

                reset = (stalling or repeating) and not eos_fire
                do_shift = (not reset and not eos_fire and bool(prct > thresh)
                            and not is_last)
                do_reset = reset and not is_last
                if (reset and is_last) or (eos_fire and at_end):
                    done = True
                    events["terminations"] += 1

                if do_reset:
                    amt = rollback if repeating else 0
                    if spec.stall_rollback and stalling:
                        amt = max(amt, no_improve)
                    gen_len = max(gen_len - amt, 1)
                    gen[gen_len - 1] = eos
                    events["repeat_resets" if repeating else "stall_resets"] += 1
                events["shifts"] += do_shift
                events["eos_advances"] += eos_go
                chunk_start += ((skip_amt if do_reset else 0) + (shift_amt if do_shift else 0)
                                + (eos_adv if eos_go else 0))
                history_size = gen_len - history_start
                if do_reset or eos_go:
                    history_start = gen_len - 1
                elif do_shift:
                    history_start += int(np.floor(del_prct * np.float32(history_size - 1)))
                moved = do_reset or do_shift or eos_go
                if moved:
                    highest = np.float32(0.0)
                window_time = 0 if moved else window_time + 1

                # bounds; history at capacity: evict a block and prefill again
                chunk_start = min(chunk_start, last_chunk_start)
                history_start = max(history_start, max(gen_len - p_max, 0))
                hit_cap = (gen_len - history_start) >= p_max
                if hit_cap:
                    history_start = min(history_start + spec.history_evict_block,
                                        gen_len - 1)
                    events["evictions"] += 1
                event = moved or hit_cap
                iters += 1
                cache_idx += 1

                # the next decode step, only when the token loop goes on
                if token_loop_goes_on():
                    logits, _, attn_mean, state = model.decode_step(
                        tok.view(1, 1), dict(state, index=cache_idx - 1))
                    last_logits = logits[0]
                    last_attn = attn_mean[0].to(torch.float32)
                    if use_lm:
                        lm_logits, lm_caches = lm.decode_step(
                            tok.clamp(max=spec.text_vocab_size - 1).view(1, 1), lm_caches,
                            cache_idx - 1)
                        lm_last = lm_logits[0]
            outer += 1

    return {
        "tokens": torch.from_numpy(gen)[None],
        "num_tokens": gen_len,
        "align_attn": align_attn,
        "align_chunk": torch.from_numpy(align_chunk),
        "iters": iters,
        "events": events,
    }


def unaligned_decode_batched(
    model,
    encoder_outs: Dict[str, Any],
    encoder_lens,
    spec: UnalignedSpec,
    lm=None,
) -> Dict[str, Any]:
    """Decode N episodes of one batched encoder output ([N, S, D], encoded
    together: the frontend's mean is one scalar over the batch), each lane
    through the single-lane machine. Returns the single-lane keys stacked:
    tokens [N, max_tokens], num_tokens [N], align_attn [N, max_tokens,
    chunk], align_chunk [N, max_tokens], iters [N] (tensors), events (a list
    of N dicts)."""
    enc = encoder_outs["encoder_out"]
    lens = [int(n) for n in torch.as_tensor(encoder_lens).tolist()]
    outs = [unaligned_decode(model, {"encoder_out": enc[lane:lane + 1]}, lens[lane], spec,
                             lm=lm)
            for lane in range(enc.shape[0])]
    return {
        "tokens": torch.cat([o["tokens"] for o in outs]),
        "num_tokens": torch.tensor([o["num_tokens"] for o in outs]),
        "align_attn": torch.stack([o["align_attn"] for o in outs]),
        "align_chunk": torch.stack([o["align_chunk"] for o in outs]),
        "iters": torch.tensor([o["iters"] for o in outs]),
        "events": [o["events"] for o in outs],
    }
