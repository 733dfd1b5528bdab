"""Reference-parity decoding: non-causal full-prefix re-decode per step.

Counterpart of tal_asrd_tpu/decode/reference_mode.py. The reference decodes
with causal_mask=False: every step re-decodes the WHOLE prefix
bidirectionally, so earlier tokens' hidden states (and the deep layers'
keys and values) change as new tokens arrive, and a KV cache does not apply
(so no fused layer step either). The default decoders (decode/beam.py,
decode/unaligned.py) decode causally over KV caches, as the model trains;
this module gives the reference's computation for parity studies
(`DecodeConfig.self_attn_mode = "noncausal_ref"`, which no runner reads).

Each step decodes the first `step` positions of the token buffer, the
exact-length prefix the reference feeds, with `causal=False` and no padding
mask. The JAX package decodes the whole fixed-size buffer with the slots
past the prefix masked as keys; the masked keys get zero weight, so the
logits at the prefix's positions are the same up to rounding. A host loop
with one sync a step (are all rows done?), as the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch


@torch.no_grad()
def greedy_noncausal(
    model,
    encoder_out: Dict[str, Any],
    prime: torch.Tensor,          # [B, P]
    max_len: int,
    eos_id: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Greedy generation with a full non-causal re-decode per step.

    `model` is an ASRModel (its `decode`). Returns device tensors: tokens
    [B, max_len] int64 (the prime first; after EOS a row holds `eos_id`),
    lengths [B] (the first EOS after the prime + 1, else the last step),
    attn [B, max_len, S] float32: attn[b, t] is the mean-over-layers
    cross-attention of the position that emitted token t (zero at the
    prime's positions and past the last step)."""
    b, p = prime.shape
    s = encoder_out["encoder_out"].shape[1]
    device = prime.device
    tokens = torch.zeros((b, max_len), dtype=torch.long, device=device)
    tokens[:, :p] = prime
    attn_buf = torch.zeros((b, max_len, s), dtype=torch.float32, device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)

    step = p
    while step < max_len and not bool(done.all()):
        logits, attn = model.decode(tokens[:, :step], encoder_out, causal=False)
        nxt = logits[:, step - 1].argmax(dim=-1)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tokens[:, step] = nxt
        # attn: [layers, B, step, S] -> mean over layers, the last position
        attn_buf[:, step] = attn[:, :, step - 1].mean(dim=0).float()
        step += 1

    if eos_id is not None:
        after = tokens[:, p:] == eos_id
        first = after.to(torch.int32).argmax(dim=1)
        lengths = torch.where(after.any(dim=1), p + first + 1,
                              torch.full_like(first, step))
    else:
        lengths = torch.full((b,), step, dtype=torch.long, device=device)
    return {"tokens": tokens, "lengths": lengths, "attn": attn_buf}
