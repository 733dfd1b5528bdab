"""Test/evaluation runner, its aligned leg.

Counterpart of tal_asrd_tpu/eval/runner.py `EvalRunner` for aligned
batches (one utterance a segment):
  * teacher-forced cross entropy on the unpadded positions;
  * beam generation through `make_generate_fn` (encode + beam search),
    terminated on EOS, with the expected-speaker-embedding track for
    speaker-token models; `decode_speakers` splits each chosen row into
    utterances with their speaker ids, and each utterance gets the track's
    row at its speaker token as `speakerEmbed`;
  * outputs: test_result.pkl [(ref_utts, hyp_utts)] rewritten after every
    batch, hyp.txt / ref.txt one line per segment, and the mean test loss.

`use_fused_decode` decodes through FusedASRDecoder (kernel K1 on the card).
The unaligned legs (the sliding-window state machine, its batched form and
the VAD windows) are ROADMAP A9 and A10: their methods raise.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np
import torch

from tal_asrd_tpu_torch.core.config import DecodeConfig
from tal_asrd_tpu_torch.data.loader import to_device
from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, make_generate_fn
from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
from tal_asrd_tpu_torch.models.asr import ASRModel
from tal_asrd_tpu_torch.train.losses import masked_token_loss


class EvalRunner:
    def __init__(self, model: ASRModel, tokenizer,
                 decode_cfg: DecodeConfig = DecodeConfig(),
                 out_dir: str = "out", device: str = "cuda"):
        """`model` lives on `device` already; batches are moved there. The
        reference's `spk_weight` (a separate speaker head, ROADMAP A12.2)
        and LM fusion (A14) are not ported."""
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.cfg = decode_cfg
        self.out_dir = out_dir
        self.device = torch.device(device)
        self._decode_model = FusedASRDecoder(model) if decode_cfg.use_fused_decode else model
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
        if cfg.num_speakers > 0:   # unknown-speaker tokens -> the last speaker id
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
            num_speakers=cfg.num_speakers,
            # speaker-token models: the expected speaker embedding per step,
            # for the embedding-clustering WDER chain
            collect_spk_embed=cfg.num_speakers > 0 and not cfg.use_speaker_head,
        )
        run = make_generate_fn(self.model, spec, decoder=self._decode_model,
                               device=str(self.device))
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
        emb = out["spk_embed"].float().cpu().numpy() if "spk_embed" in out else None
        text_vocab = self.model.cfg.vocab_size

        hyp_dec, ref_dec = [], []
        for i in range(b):
            if found[i] and lengths[i] > 1:
                hyp = list(tokens[i, : lengths[i] - 1])  # drop the final EOS
                utts, splits = self.tokenizer.decode_speakers(hyp)
                entries = [{"utterance": text, "speakerId": sid} for text, sid in utts]
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

    def test_step_unaligned(self, *args, **kwargs):
        raise NotImplementedError("the unaligned state machine is ROADMAP A9")

    def test_step_unaligned_batched(self, *args, **kwargs):
        raise NotImplementedError("the batched unaligned state machine is ROADMAP A9")

    def test_step_unaligned_vad(self, *args, **kwargs):
        raise NotImplementedError("the VAD-windowed decode is ROADMAP A10")

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
