"""Test/evaluation runner: the reference test_step workflow as a library.

Counterpart of tal_asrd_tpu/eval/runner.py `EvalRunner`:
  * aligned batches (one utterance a segment): teacher-forced cross entropy
    on the unpadded positions, then beam generation through
    `make_generate_fn` (encode + beam search), terminated on EOS, with the
    expected-speaker-embedding track for speaker-token models;
    `decode_speakers` splits each chosen row into utterances with their
    speaker ids, and each utterance gets the track's row at its speaker
    token as `speakerEmbed`; a model with the separate speaker head keeps
    the head's logits track instead, and each utterance gets its rows
    `spk[last : split + 1]` as `speakerLogits` (consecutive utterances share
    the row at their boundary, as in the reference);
  * whole episodes through the sliding-window state machine
    (decode/unaligned.py), one episode or a group of equal-length episodes
    encoded together; each utterance carries its `attention`, `chunkStart`
    and `utteranceTokens` slices for the WDER converter;
  * whole episodes through VAD-gated windows (vad/windows.py), bucketed to
    5, 10, 20 and 30 s and decoded by the aligned beam search in fixed
    [batch_lanes, bucket] batches, stitched in window order;
  * outputs: test_result.pkl [(ref_utts, hyp_utts)] rewritten after every
    step, hyp.txt / ref.txt one line per segment or episode, and the mean
    test loss (0 for each unaligned episode, as the reference).

`use_fused_decode` decodes through FusedASRDecoder (kernel K1 on the card)
in every leg, except for a model with the separate speaker head: that one
decodes through the model itself (its second decoder has no fused form), as
the reference's runner routes it. The state machine builds its decode state
by hand without the head's caches, so there a speaker-head model decodes
without its head; the VAD windows' beam search keeps the track and writes
no `speakerLogits`, as the reference's. With an `lm` (a DecoderLMModel,
models/lm.py) every leg fuses it at the DecodeConfig's `lm_weight` (the
beam search and the state machine: decode/beam.py, decode/unaligned.py);
the LM itself runs unfused beside the fused decoder. Without an LM the
weight is not read.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from tal_asrd_tpu_torch.core.config import DecodeConfig
from tal_asrd_tpu_torch.data.collate import pick_bucket
from tal_asrd_tpu_torch.data.loader import to_device
from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, make_generate_fn
from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
from tal_asrd_tpu_torch.decode.unaligned import UnalignedSpec, unaligned_decode_batched
from tal_asrd_tpu_torch.models.asr import ASRModel
from tal_asrd_tpu_torch.train.losses import masked_token_loss
from tal_asrd_tpu_torch.vad.windows import vad_decode_windows

# the VAD leg's audio buckets (seconds) and its sample rate
VAD_BUCKETS_S = (5, 10, 20, 30)
SAMPLE_RATE = 16000


class EvalRunner:
    def __init__(self, model: ASRModel, tokenizer,
                 decode_cfg: DecodeConfig = DecodeConfig(),
                 out_dir: str = "out", device: str = "cuda", lm=None,
                 spk_weight: float = 0.0):
        """`model` (and `lm`, if given) live on `device` already; batches are
        moved there. `spk_weight` > 0 (a model with the separate speaker
        head, trained with the speaker loss) leaves the unknown-speaker
        tokens of the teacher-forced loss unclamped, as the reference."""
        self.model = model.eval()
        self.spk_weight = spk_weight
        self.lm = lm
        self.lm_weight = decode_cfg.lm_weight if lm is not None else 0.0
        self.tokenizer = tokenizer
        self.cfg = decode_cfg
        self.out_dir = out_dir
        self.device = torch.device(device)
        self._decode_model = (FusedASRDecoder(model) if decode_cfg.use_fused_decode
                              and not model.cfg.use_speaker_head else model)
        self.test_outputs: List = []
        self._losses: List[float] = []
        self._generate = {}
        os.makedirs(out_dir, exist_ok=True)
        for name in ("hyp.txt", "ref.txt"):          # fresh output files
            open(os.path.join(out_dir, name), "w").close()

    # ------------------------------------------------------------------
    def _teacher_forced_loss(self, batch: Dict[str, torch.Tensor]) -> float:
        cfg = self.model.cfg
        y = batch["text"].long()
        if cfg.num_speakers > 0 and self.spk_weight == 0:
            # unknown-speaker tokens -> the last speaker id
            y = torch.clamp(y, max=cfg.vocab_size + cfg.num_speakers - 1)
        with torch.inference_mode():
            (logits, _), _ = self.model(batch["audio"], y[:, :-1], batch["audio_lens"])
            loss = masked_token_loss(logits, y[:, 1:], batch["text_mask"][:, 1:])
        return float(loss)

    def _generate_fn(self, max_new: int):
        if max_new in self._generate:
            return self._generate[max_new]
        cfg = self.model.cfg
        spec = BeamSearchSpec(
            beam_size=self.cfg.beam_size,
            max_new_tokens=max_new,
            eos_id=self.tokenizer.eos_token_id,
            vocab_size=cfg.num_tokens,
            text_vocab_size=len(self.tokenizer),
            collect_spk=cfg.use_speaker_head,
            num_speakers=cfg.num_speakers,
            # speaker-token models: the expected speaker embedding per step,
            # for the embedding-clustering WDER chain
            collect_spk_embed=cfg.num_speakers > 0 and not cfg.use_speaker_head,
            lm_weight=self.lm_weight,
        )
        run = make_generate_fn(self.model, spec, decoder=self._decode_model,
                               device=str(self.device), lm=self.lm)
        self._generate[max_new] = run
        return run

    # ------------------------------------------------------------------
    def test_step_aligned(self, batch, ref_utts_per_sample: List[List[dict]]):
        """One aligned test batch (numpy arrays or tensors; see
        data/collate.py). ref_utts_per_sample: the original utterance dicts
        of each sample. Returns the loss and the beam's chosen rows (numpy:
        tokens, lengths, scores, found)."""
        batch = to_device(batch, self.device)
        loss = self._teacher_forced_loss(batch)
        self._losses.append(loss)

        b, l = batch["text"].shape
        max_new = int(l * 1.1) + 2
        out = self._generate_fn(max_new)(batch["audio"], batch["audio_lens"],
                                         batch["text"][:, :1])
        tokens = out["tokens"].cpu().numpy()
        lengths = out["lengths"].cpu().numpy()
        found = out["found"].cpu().numpy()
        spk = out["spk"].float().cpu().numpy() if "spk" in out else None
        emb = out["spk_embed"].float().cpu().numpy() if "spk_embed" in out else None
        text_vocab = self.model.cfg.vocab_size

        hyp_dec, ref_dec = [], []
        for i in range(b):
            if found[i] and lengths[i] > 1:
                hyp = list(tokens[i, : lengths[i] - 1])  # drop the final EOS
                utts, splits = self.tokenizer.decode_speakers(hyp)
                entries = [{"utterance": text, "speakerId": sid} for text, sid in utts]
                if spk is not None:
                    # each utterance's rows of the speaker-logit track
                    last = 0
                    for e, s in zip(entries, splits):
                        e["speakerLogits"] = spk[i, last:s + 1]
                        last = s
                if emb is not None:
                    # Expected speaker embedding at each utterance's speaker
                    # token: hyp[j] was emitted at beam step j-1 (index 0 is
                    # the prime), so its track row is emb[i, j-1].
                    last = 0
                    for e, s in zip(entries, splits):
                        for j in range(last, min(s + 1, len(hyp))):
                            if hyp[j] >= text_vocab and j >= 1:
                                e["speakerEmbed"] = emb[i, j - 1]
                                break
                        last = s
                hyp_dec.append(entries)
            else:
                hyp_dec.append([])
            ref_dec.append(ref_utts_per_sample[i])

        self._append_outputs(ref_dec, hyp_dec)
        return {"loss": loss, "tokens": tokens, "lengths": lengths,
                "scores": out["scores"].cpu().numpy(), "found": found}

    # ------------------------------------------------------------------
    def _default_unaligned_spec(self) -> UnalignedSpec:
        """The state machine at the DecodeConfig's knobs. As in the
        reference runner, the budgets (max_tokens, max_iters, max_outer)
        stay at UnalignedSpec's defaults: DecodeConfig.max_iters is not
        read."""
        return UnalignedSpec(
            eos_id=self.tokenizer.eos_token_id,
            chunk_size=self.cfg.chunk_size,
            max_positions=self.model.cfg.max_positions,
            thresh_prct=self.cfg.thresh_prct,
            shift_prct=self.cfg.shift_prct,
            stall_patience=self.cfg.stall_patience,
            rep_n=self.cfg.rep_n,
            skip_prct=self.cfg.skip_prct,
            history_evict_block=self.cfg.history_evict_block,
            eos_advance=self.cfg.eos_advance,
            stall_rollback=self.cfg.stall_rollback,
            lm_weight=self.lm_weight,
            text_vocab_size=len(self.tokenizer),
        )

    def _finish_unaligned(self, out: Dict, lane: int, ref_utts: List[dict]):
        """One episode's entries from lane `lane` of the machine's batched
        output: the final token is dropped, as the reference does, and each
        utterance gets its slices of the alignment buffers."""
        n = int(out["num_tokens"][lane])
        gen = out["tokens"][lane, :n].tolist()
        attn = out["align_attn"][lane, : n - 1].float().cpu().numpy()
        chunks = out["align_chunk"][lane, : n - 1].numpy()
        hyp = gen[:-1]
        utts, splits = self.tokenizer.decode_speakers(hyp)
        entries = []
        last = 0
        for (text, sid), split_i in zip(utts, splits):
            entries.append({
                "utterance": text,
                "speakerId": sid,
                "attention": attn[last:split_i + 1],
                "chunkStart": chunks[last:split_i + 1],
                "utteranceTokens": hyp[last:split_i + 1],
            })
            last = split_i
        self._append_outputs([ref_utts], [entries])
        self._losses.append(0.0)
        return {"num_tokens": len(gen), "num_utterances": len(entries),
                "iters": int(out["iters"][lane]), "events": out["events"][lane],
                "tokens": gen, "align_chunk": chunks.tolist()}

    def _encode(self, audio: np.ndarray, lens: np.ndarray):
        """Encode a batch of whole episodes together (one frontend mean over
        the batch, as the reference); returns the encoder output and each
        row's valid encoder frames."""
        with torch.inference_mode():
            a = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
            n = torch.from_numpy(np.asarray(lens, np.int64)).to(self.device)
            enc = self.model.encode(a, n)
        mask = enc["encoder_padding_mask"]
        if mask is None:
            enc_lens = [enc["encoder_out"].shape[1]] * len(lens)
        else:
            enc_lens = (~mask).sum(-1).tolist()
        return enc, enc_lens

    def test_step_unaligned(self, audio: np.ndarray, audio_len: int,
                            ref_utts: List[dict],
                            spec: Optional[UnalignedSpec] = None):
        """One full episode (batch of 1, as the reference; the batched form
        of one lane is the single-lane machine)."""
        enc, enc_lens = self._encode(audio[None], np.asarray([audio_len]))
        out = unaligned_decode_batched(self._decode_model, enc, enc_lens,
                                       spec or self._default_unaligned_spec(), lm=self.lm)
        return self._finish_unaligned(out, 0, ref_utts)

    def test_step_unaligned_batched(self, audios: List[np.ndarray], audio_len: int,
                                    ref_utts_list: List[List[dict]],
                                    spec: Optional[UnalignedSpec] = None):
        """N equal-length episodes encoded together, then each through the
        state machine (unaligned_decode_batched): a lane's result is its
        single-lane run on the group's encoder output. Equal lengths are
        required (callers group by length), so no lane is padded: padding
        would move the encoder's boundary."""
        if not all(len(a) == audio_len for a in audios):
            raise ValueError("batched unaligned eval requires equal-length episodes; "
                             "group by length at the call site")
        enc, enc_lens = self._encode(np.stack(audios), np.full((len(audios),), audio_len))
        out = unaligned_decode_batched(self._decode_model, enc, enc_lens,
                                       spec or self._default_unaligned_spec(), lm=self.lm)
        return [self._finish_unaligned(out, lane, ref_utts)
                for lane, ref_utts in enumerate(ref_utts_list)]

    def test_step_unaligned_vad(self, audio: np.ndarray, audio_len: int,
                                ref_utts: List[dict], max_window_s: float = 20.0,
                                vad_cfg=None, batch_lanes: int = 16):
        """Long-form decode through VAD-gated windows: each speech region is
        a decode window through the aligned beam search. Windows are bucketed
        to the collater's audio lengths and decoded in fixed
        [batch_lanes, bucket] batches (rows of zeros with audio_lens=1 fill
        a short batch and are dropped), then stitched in window order; each
        utterance's chunkStart is the window's start in encoder frames, its
        attention a uniform row."""
        sr = SAMPLE_RATE
        wav = np.asarray(audio[:audio_len], np.float32)
        windows = vad_decode_windows(wav, sr, vad_cfg=vad_cfg, max_window_s=max_window_s,
                                     device=str(self.device))
        buckets = [int(s * sr) for s in VAD_BUCKETS_S]
        eos = self.tokenizer.eos_token_id

        by_bucket: Dict[int, List[int]] = {}
        for w_ix, (s, e) in enumerate(windows):
            by_bucket.setdefault(pick_bucket(e - s, buckets), []).append(w_ix)

        results: Dict[int, List[int]] = {}
        for bucket, ixs in sorted(by_bucket.items()):
            max_new = max(32, int(bucket / sr * 6))
            for g in range(0, len(ixs), batch_lanes):
                part = ixs[g:g + batch_lanes]
                batch_audio = np.zeros((batch_lanes, bucket), np.float32)
                lens = np.ones((batch_lanes,), np.int32)
                for row, w_ix in enumerate(part):
                    s, e = windows[w_ix]
                    n = min(e - s, bucket)
                    batch_audio[row, :n] = wav[s:s + n]
                    lens[row] = n
                prime = np.full((batch_lanes, 1), eos, np.int64)
                out = self._generate_fn(max_new)(batch_audio, lens, prime)
                tokens = out["tokens"].cpu().numpy()
                lengths = out["lengths"].cpu().numpy()
                found = out["found"].cpu().numpy()
                for row, w_ix in enumerate(part):
                    # no EOS inside max_new: the tokens are kept all the same
                    n = lengths[row] - 1 if found[row] and lengths[row] > 1 else lengths[row]
                    results[w_ix] = [int(t) for t in tokens[row, :n]]

        entries = []
        n_tok_total = 2
        frame = sr // 100 * self.model.cfg.time_reduction   # samples per encoder frame
        for w_ix, (s, _e) in enumerate(windows):
            hyp = results.get(w_ix, [])
            if not hyp:
                continue
            utts, splits = self.tokenizer.decode_speakers(hyp)
            chunk0 = s // frame
            last = 0
            for (text, sid), split_i in zip(utts, splits):
                u_tok = hyp[last:split_i + 1]
                entries.append({
                    "utterance": text,
                    "speakerId": sid,
                    "utteranceTokens": u_tok,
                    "attention": np.full((len(u_tok), 1), 1.0, np.float32),
                    "chunkStart": np.full((len(u_tok),), chunk0, np.int64),
                })
                last = split_i
            n_tok_total += len(hyp)
        self._append_outputs([ref_utts], [entries])
        self._losses.append(0.0)
        return {"num_tokens": n_tok_total, "num_utterances": len(entries),
                "num_windows": len(windows), "windows": windows,
                "window_tokens": [results[w] for w in range(len(windows))],
                "buckets": {b // sr: len(ixs) for b, ixs in sorted(by_bucket.items())}}

    # ------------------------------------------------------------------
    def _append_outputs(self, ref_dec, hyp_dec):
        self.test_outputs += list(zip(ref_dec, hyp_dec))
        with open(os.path.join(self.out_dir, "test_result.pkl"), "wb") as f:
            pickle.dump(self.test_outputs, f)
        with open(os.path.join(self.out_dir, "hyp.txt"), "a") as f:
            for utts in hyp_dec:
                f.write(" ".join(u["utterance"] for u in utts) + "\n")
        with open(os.path.join(self.out_dir, "ref.txt"), "a") as f:
            for utts in ref_dec:
                f.write(" ".join(u["utterance"] for u in utts) + "\n")

    def test_end(self) -> Dict[str, float]:
        mean = float(np.mean(self._losses)) if self._losses else float("nan")
        print("Loss", mean)
        return {"test_loss": mean}
