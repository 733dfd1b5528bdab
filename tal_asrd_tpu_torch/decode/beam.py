"""Batched beam search with KV caches, as an eager loop on the device.

Counterpart of tal_asrd_tpu/decode/beam.py (which runs the same search as one
compiled while-loop). Shapes are static per call and all bookkeeping stays on
the device; the host reads one flag per step (are all slots done?).

  * score accumulation + top-k over [B, K*V], with first-step fan-out
    expressed as -1e30 initial scores on beams 1..K-1;
  * beam reordering gathers the self-attention KV caches along the flat beam
    axis — the model's `cache_beam_axis`, 0 unless it says otherwise — and
    is skipped at K = 1, where it is the identity;
  * retirement semantics are the reference's: `done` flags are per SLOT and
    are NOT reordered with the beams, so a slot that produced EOS stays
    masked for the rest of the search — including the quirk that a live
    continuation written into a dead slot is lost. Kept for parity; each
    retired row is stored into a fixed [B, K] finished pool;
  * length-normalized selection at the end (score / row length), considering
    the live rows too under `force_output`;
  * LM shallow fusion when an LM is given and `lm_weight` > 0: the LM
    (models/lm.py) steps beside the decoder over the prime and then once a
    search step, its input the chosen token clamped to `text_vocab_size - 1`
    (speaker tokens never reach it), and `lm_weight` times its f32
    log-softmax is added to the first min(text_vocab_size, vocab_size)
    columns of the decoder's log-probabilities; its caches are reordered
    with the beams (at K > 1 only). An LM weight without an LM is inert;
  * with `collect_spk_embed`, the expected speaker embedding of each step
    (f32 softmax over the last `num_speakers` logits x the speaker rows of
    the tied embedding table, from the decoder's `speaker_rows()`, stored in
    bf16), a track reordered with the beams, copied into the finished pool
    at retirement and returned as `spk_embed` for the chosen row. As in the
    reference, a step's row is written in the order of the beams BEFORE the
    reorder: new row r gets the expectation of old row r, not of the beam it
    continues;
  * with `collect_spk` (a model with the separate speaker head), the
    speaker head's logits of each step in bf16, a track [B*K, max_new, S]
    reordered with the beams and written, like the embedding track, with
    the previous decode step's logits in the beams' order before the
    reorder; copied into the finished pool at retirement (and for the live
    rows under `force_output`) and returned as `spk` for the chosen row. The
    speaker head's caches (`spk_caches`) are reordered with the decoder's.

Equal scores are common: logits come in bf16, two tokens of one beam with
the same bf16 logit get the same f32 score, and the order of the chosen
beams decides their slots. The reference's top-k (`lax.top_k`) puts the
lower index first among equal values; `torch.topk` promises no order, so
the selection is a stable descending sort (`top_k`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

NEG_INF = -1e30


@dataclass
class BeamSearchSpec:
    """Static parameters of a beam search invocation."""

    beam_size: int
    max_new_tokens: int
    eos_id: int
    vocab_size: int            # full output vocab (text + speaker tokens)
    text_vocab_size: int       # LM vocab (speaker tokens clamped away)
    lm_weight: float = 0.0
    force_output: bool = False
    collect_spk: bool = False
    num_speakers: int = 0
    # Track the expected speaker embedding per emitted token (speaker-token
    # models).
    collect_spk_embed: bool = False


def beam_search(
    model,
    encoder_out: Dict[str, Any],
    prime: torch.Tensor,           # [B, P] prime tokens (first is usually EOS)
    spec: BeamSearchSpec,
    lm=None,
) -> Dict[str, torch.Tensor]:
    """Run beam search. `model` is an ASRModel or a FusedASRDecoder (anything
    with `init_decode_state` and `decode_step`, and `speaker_rows` under
    `collect_spk_embed`); `lm` a DecoderLMModel on the same device, or None.
    Returns device tensors:
      tokens     [B, P + max_new]      best row per batch item
      lengths    [B]                   valid row length (incl. prime and EOS)
      scores     [B]                   length-normalized score of the chosen row
      found      [B]                   whether any beam terminated
      spk        [B, max_new, S] bf16  speaker-head logits per step
                                       (under collect_spk)
      spk_embed  [B, max_new, E] bf16  expected speaker embedding per step
                                       (under collect_spk_embed)
    """
    b, p = prime.shape
    k = spec.beam_size
    v = spec.vocab_size
    bk = b * k
    l_buf = p + spec.max_new_tokens
    device = prime.device
    prime = prime.to(torch.long)
    use_lm = lm is not None and spec.lm_weight > 0

    # --- Expand encoder outputs across beams ---------------------------------
    mask = encoder_out.get("encoder_padding_mask")
    spk_out = encoder_out.get("speaker_out")
    enc = {
        "encoder_out": encoder_out["encoder_out"].repeat_interleave(k, dim=0),
        "speaker_out": None if spk_out is None else spk_out.repeat_interleave(k, dim=0),
        "encoder_padding_mask": (
            None if mask is None else mask.repeat_interleave(k, dim=0)),
    }
    state = model.init_decode_state(enc, bk, l_buf)
    # The stacked fused decoder keeps its caches [L, B*K, cap, D]: the beam
    # axis is 1 there (a gather along 0 would reorder layers, not beams).
    cache_axis = getattr(model, "cache_beam_axis", 0)

    tokens = torch.zeros((bk, l_buf), dtype=torch.long, device=device)
    tokens[:, :p] = prime.repeat_interleave(k, dim=0)

    # Prefill the caches on the prime prefix (small P; the last token feeds
    # the first search step).
    logits = spk_logits = lm_logits = lm_caches = None
    if use_lm:
        lm_caches = lm.init_cache(bk, l_buf)
    for i in range(p):
        cur_tok = prime[:, i:i + 1].repeat_interleave(k, dim=0)  # [BK, 1]
        logits, spk_logits, _, state = model.decode_step(cur_tok, state)
        if use_lm:
            lm_logits, lm_caches = lm.decode_step(
                cur_tok.clamp(max=spec.text_vocab_size - 1), lm_caches, i)
    lm_width = min(spec.text_vocab_size, v)

    # --- Search state --------------------------------------------------------
    # Beams 1..K-1 start at -inf so step 0 fans out from beam 0 only.
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    done = torch.zeros((bk,), dtype=torch.bool, device=device)
    fin_tokens = torch.zeros((b, k, l_buf), dtype=torch.long, device=device)
    fin_norm = torch.full((b, k), NEG_INF, dtype=torch.float32, device=device)
    fin_len = torch.zeros((b, k), dtype=torch.long, device=device)
    fin_valid = torch.zeros((b, k), dtype=torch.bool, device=device)
    batch_offset = (torch.arange(b, device=device) * k)[:, None]  # [B, 1]
    if spec.collect_spk:
        if spk_logits is None or spk_logits.shape[-1] != spec.num_speakers:
            raise ValueError(f"collect_spk: spec.num_speakers={spec.num_speakers}, but the "
                             f"decoder's speaker head gives "
                             f"{None if spk_logits is None else spk_logits.shape[-1]}")
        spk_track = torch.zeros((bk, spec.max_new_tokens, spec.num_speakers),
                                dtype=torch.bfloat16, device=device)
        fin_spk = torch.zeros((b, k) + spk_track.shape[1:], dtype=torch.bfloat16,
                              device=device)
    if spec.collect_spk_embed:
        spk_rows = model.speaker_rows().to(device=device, dtype=torch.float32)  # [S, E]
        if spk_rows.shape[0] != spec.num_speakers or spec.num_speakers < 1:
            raise ValueError(f"collect_spk_embed: spec.num_speakers={spec.num_speakers}, "
                             f"but the model has {spk_rows.shape[0]} speaker rows")
        emb_track = torch.zeros((bk, spec.max_new_tokens, spk_rows.shape[1]),
                                dtype=torch.bfloat16, device=device)
        fin_emb = torch.zeros((b, k) + emb_track.shape[1:], dtype=torch.bfloat16,
                              device=device)

    step = 0
    while step < spec.max_new_tokens and not bool(done.all()):
        if use_lm:
            logprobs = fuse_lm(logits, lm_logits, spec.lm_weight, lm_width)  # [BK, V]
        else:
            logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
        total = logprobs + scores.reshape(-1, 1)
        total = torch.where(done[:, None], NEG_INF, total)
        scores, idx = top_k(total.reshape(b, k * v), k)                  # [B, K]
        best_tok = idx % v                                              # [B, K]
        flat_beams = (idx // v + batch_offset).reshape(-1)              # [BK]

        # Reorder rows + caches by source beam; at K = 1 the gather is the
        # identity and skipping it saves two full cache copies per step.
        if k > 1:
            tokens = tokens.index_select(0, flat_beams)
            state = dict(state)
            state["caches"] = _gather(state["caches"], cache_axis, flat_beams)
            if "spk_caches" in state:
                state["spk_caches"] = _gather(state["spk_caches"], 0, flat_beams)
            if use_lm:
                lm_caches = _gather(lm_caches, 0, flat_beams)
        tokens[:, p + step] = best_tok.reshape(-1)
        if spec.collect_spk:
            if k > 1:
                spk_track = spk_track.index_select(0, flat_beams)
            spk_track[:, step] = spk_logits.to(torch.bfloat16)
        if spec.collect_spk_embed:
            probs = torch.softmax(logits[:, v - spec.num_speakers:].to(torch.float32), dim=-1)
            if k > 1:
                emb_track = emb_track.index_select(0, flat_beams)
            emb_track[:, step] = (probs @ spk_rows).to(torch.bfloat16)

        # Retirement: slots whose chosen token is EOS and that are not already
        # dead store their row and die. Slot done flags are NOT reordered.
        is_eos = best_tok.reshape(-1) == spec.eos_id
        newly_bk = (is_eos & ~done).reshape(b, k)
        row_len = p + step + 1
        fin_tokens = torch.where(newly_bk[..., None],
                                 tokens.reshape(b, k, -1), fin_tokens)
        fin_norm = torch.where(newly_bk, scores / float(row_len), fin_norm)
        fin_len = torch.where(newly_bk, row_len, fin_len)
        fin_valid = fin_valid | newly_bk
        if spec.collect_spk:
            fin_spk = torch.where(newly_bk[..., None, None],
                                  spk_track.reshape(fin_spk.shape), fin_spk)
        if spec.collect_spk_embed:
            fin_emb = torch.where(newly_bk[..., None, None],
                                  emb_track.reshape(fin_emb.shape), fin_emb)
        done = done | is_eos
        step += 1

        # Next-step logits from the chosen tokens (not needed after the last
        # step: nothing reads them).
        if step < spec.max_new_tokens:
            cur = best_tok.reshape(-1, 1)
            logits, spk_logits, _, state = model.decode_step(cur, state)
            if use_lm:
                lm_logits, lm_caches = lm.decode_step(
                    cur.clamp(max=spec.text_vocab_size - 1), lm_caches, p + step - 1)

    # --- Final selection -------------------------------------------------------
    if spec.force_output:
        # Add the live rows as candidates with length-normalized running scores.
        live_norm = scores / float(p + step)
        live_valid = ~done.reshape(b, k)
        take_live = live_valid & (~fin_valid | (live_norm > fin_norm))
        fin_norm = torch.where(take_live, live_norm, fin_norm)
        fin_tokens = torch.where(take_live[..., None],
                                 tokens.reshape(b, k, -1), fin_tokens)
        fin_len = torch.where(take_live, p + step, fin_len)
        if spec.collect_spk:
            fin_spk = torch.where(take_live[..., None, None],
                                  spk_track.reshape(fin_spk.shape), fin_spk)
        if spec.collect_spk_embed:
            fin_emb = torch.where(take_live[..., None, None],
                                  emb_track.reshape(fin_emb.shape), fin_emb)
        fin_valid = fin_valid | live_valid

    sel_norm = torch.where(fin_valid, fin_norm, NEG_INF)
    best = sel_norm.argmax(dim=1)                                        # [B]
    rows = torch.arange(b, device=device)
    out = {
        "tokens": fin_tokens[rows, best],
        "lengths": fin_len[rows, best],
        "scores": fin_norm[rows, best],
        "found": fin_valid.any(dim=1),
    }
    if spec.collect_spk:
        out["spk"] = fin_spk[rows, best]
    if spec.collect_spk_embed:
        out["spk_embed"] = fin_emb[rows, best]
    return out


def fuse_lm(logits: torch.Tensor, lm_logits: torch.Tensor, weight: float,
            width: int) -> torch.Tensor:
    """Shallow fusion: the decoder's f32 log-softmax with `weight` times the
    LM's f32 log-softmax added to its first `width` columns."""
    logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    lm_logprobs = torch.log_softmax(lm_logits.to(torch.float32), dim=-1)
    logprobs[..., :width] += weight * lm_logprobs[..., :width]
    return logprobs


def top_k(x: torch.Tensor, k: int):
    """The k largest values of each row and their indices, in descending
    order, the lower index first among equal values (as lax.top_k)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _gather(tree, axis: int, index: torch.Tensor):
    """index_select(axis, index) on every tensor of a tree of tuples / dicts."""
    if isinstance(tree, dict):
        return {key: _gather(t, axis, index) for key, t in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_gather(t, axis, index) for t in tree)
    return tree.index_select(axis, index)


def make_generate_fn(model, spec: BeamSearchSpec, decoder=None, device: str = "cuda",
                     lm=None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the serving entry point: generate(audio, audio_lens, prime) ->
    {tokens, lengths, scores, found} = model.encode + beam_search, under
    torch.inference_mode().

    `model` is the ASRModel (it encodes); `decoder` steps the search and
    defaults to the model itself — pass a FusedASRDecoder built on the same
    model to decode through the fused layer-step kernel; `lm`, a
    DecoderLMModel on `device`, fuses when spec.lm_weight > 0. Inputs may be numpy
    arrays or tensors on any device; they are moved to `device`, where the
    model must already live."""
    dec = model if decoder is None else decoder
    dev = torch.device(device)

    def generate(audio, audio_lens, prime) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            audio_t = torch.as_tensor(audio).to(dev)
            lens_t = None if audio_lens is None else torch.as_tensor(audio_lens).to(dev)
            prime_t = torch.as_tensor(prime).to(dev)
            enc = model.encode(audio_t, lens_t)
            return beam_search(dec, enc, prime_t, spec, lm=lm)

    return generate
