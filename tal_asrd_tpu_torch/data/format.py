"""Utterance-stream token formatting.

Counterpart of tal_asrd_tpu/data/format.py. The serialization contract of
the joint model:

    <EOS> <utt tokens> [<spk token>] <EOS> <utt tokens> [<spk token>] <EOS> ... [<EOT>]

with a parallel per-token speaker-id track when requested. Word-aligned
truncation uses forced-alignment word times to cut boundary utterances
exactly at the segment bounds.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from tal_asrd_tpu_torch.utils.wordtok import detokenize, tweet_tokenize


def tokenize_utterances(
    utterances: Sequence[dict],
    selected: Sequence[Tuple[int, dict]],
    tokenizer,
    add_eot: bool = False,
    tokenize_speaker: bool = False,
    speaker_to_id: Callable[[str], int] = lambda s: 0,
    return_spk_ids: bool = False,
) -> Tuple[List[int], Optional[List[int]]]:
    """Format a run of utterances.

    `utterances` is the full episode list (used to detect first/last);
    `selected` is the (index, utterance) subset to emit.
    """
    tokens: List[int] = []
    spk_ids: List[int] = []

    def push(tok: int, spk: int):
        tokens.append(tok)
        if return_spk_ids:
            spk_ids.append(spk)

    for _, utt in selected:
        spk = speaker_to_id(utt["speaker"])
        if utt is utterances[0] or utt == utterances[0]:
            push(tokenizer.eos_token_id, spk)
        text = utt["utterance"].strip()
        for t in tokenizer.encode(text, bos_token=False, eos_token=False):
            push(t, spk)
        if tokenize_speaker:
            push(spk, spk)
        push(tokenizer.eos_token_id, spk)
        if (utt is utterances[-1] or utt == utterances[-1]) and add_eot:
            push(tokenizer.eot_token_id, spk)

    if return_spk_ids:
        return tokens, spk_ids
    return tokens, None


def tokenize_utterances_word_align(
    utterances: Sequence[dict],
    selected: Sequence[Tuple[int, dict]],
    start_time: float,
    end_time: float,
    tokenizer,
    add_eot: bool = False,
    tokenize_speaker: bool = False,
    speaker_to_id: Callable[[str], int] = lambda s: 0,
) -> List[int]:
    """Word-alignment-exact truncation of boundary utterances. Each
    utterance dict carries `alignments`:
    [(word_start_s, word_end_s, word_token_ix), ...] from the forced aligner.
    """
    section_start = selected[0][1]["utterance_start"]
    section_end = selected[-1][1]["utterance_end"]
    start_bound = max(section_start, start_time)
    end_bound = min(end_time, section_end)

    first_u = selected[0][1]
    start_t_ix = 0
    need_start_truncate = False
    for w_start, _w_end, ix in first_u.get("alignments", []):
        if w_start >= start_bound:
            start_t_ix = ix
            need_start_truncate = True
            break

    last_ix = len(selected) - 1
    last_u = selected[last_ix][1]
    end_t_ix = None
    need_end_truncate = False
    for _w_start, w_end, ix in reversed(last_u.get("alignments", [])):
        if w_end <= end_bound:
            end_t_ix = ix
            need_end_truncate = True
            break

    tokens: List[int] = []
    for pos, (_, utt) in enumerate(selected):
        if pos in (0, last_ix) and (need_start_truncate or need_end_truncate):
            words = tweet_tokenize(utt["utterance"])
            lo = start_t_ix if (pos == 0 and need_start_truncate) else 0
            hi = end_t_ix if (pos == last_ix and need_end_truncate) else None
            text = detokenize(words[lo:hi])
        else:
            text = utt["utterance"].strip()

        is_first = utt == utterances[0] and not need_start_truncate
        is_last = utt == utterances[-1] and not need_end_truncate
        if is_first:
            tokens.append(tokenizer.eos_token_id)
        tokens.extend(tokenizer.encode(text, bos_token=False, eos_token=False))
        if tokenize_speaker:
            tokens.append(speaker_to_id(utt["speaker"]))
        tokens.append(tokenizer.eos_token_id)
        if is_last and add_eot:
            tokens.append(tokenizer.eot_token_id)
    return tokens
