"""Evaluation utilities.

Counterpart of tal_asrd_tpu/eval/tools.py:
  * strip_punct / strip_output: punctuation, speaker tokens and EOS / EOT
    markers removed;
  * splice_at_eot and eval_transcripts: shard texts joined and split into
    episodes at <EOT>, punctuation-stripped corpus WER;
  * merge_outputs: jsonl shards -> one pickle, in order;
  * prune_bad_utterances: utterances whose loss exceeds a threshold dropped;
  * apply_role_names: id -> name and id -> role maps joined onto eval pickles;
  * export_tsne: vector and metadata TSVs for projector.tensorflow.org.
"""
from __future__ import annotations

import json
import os
import pickle
import re
import string
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tal_asrd_tpu_torch.eval.editdist import eval_distance

_PUNCT_RE = re.compile(rf"[{re.escape(string.punctuation)}]")
_SPEAKER_RE = re.compile(r"<S\d+>")
_MARKER_RE = re.compile(r"<EOT>|<EOS>|<PAD>|<UNK>", re.IGNORECASE)


def strip_punct(text: str) -> str:
    return _PUNCT_RE.sub("", text)


def strip_output(text: str) -> str:
    """Remove speaker tokens, EOS/EOT markers and punctuation."""
    text = _SPEAKER_RE.sub(" ", text)
    text = _MARKER_RE.sub(" ", text)
    return " ".join(strip_punct(text).split())


def splice_at_eot(shards: Sequence[str]) -> List[str]:
    """Join shard texts then split into episodes at <EOT> markers."""
    joined = " ".join(shards)
    return [seg.strip() for seg in joined.split("<EOT>") if seg.strip()]


def eval_transcripts(ref_texts: Sequence[str], hyp_texts: Sequence[str]) -> float:
    """Punct-stripped corpus WER (utils/eval_transcripts.py semantics)."""
    total_dist = 0
    total_ref = 0
    for ref, hyp in zip(ref_texts, hyp_texts):
        r = strip_output(ref).lower().split()
        h = strip_output(hyp).lower().split()
        total_dist += eval_distance(r, h)
        total_ref += len(r)
    return total_dist / max(total_ref, 1)


def merge_outputs(jsonl_paths: Sequence[str], out_pkl: str) -> list:
    """Concatenate jsonl shards into one pickle, preserving order."""
    rows = []
    for path in jsonl_paths:
        with open(path) as f:
            rows.extend(json.loads(line) for line in f if line.strip())
    with open(out_pkl, "wb") as f:
        pickle.dump(rows, f)
    return rows


def prune_bad_utterances(utterances: Sequence[dict], losses: Sequence[float],
                         threshold: float) -> List[dict]:
    """Drop utterances whose per-utterance loss exceeds the threshold."""
    return [u for u, l in zip(utterances, losses) if l <= threshold]


def apply_role_names(
    paired_results,
    speaker_name_map: Optional[Dict[int, str]] = None,
    role_map: Optional[Dict[int, str]] = None,
):
    """Join id->name / id->role onto (ref, hyp) eval pickles."""
    out = []
    for refs, hyps in paired_results:
        new_refs = []
        for entry in refs:
            utt, spk = entry[0], entry[1]
            name = (speaker_name_map or {}).get(spk, spk)
            role = entry[2] if len(entry) > 2 else (role_map or {}).get(spk, "subject")
            new_refs.append((utt, name, role))
        new_hyps = []
        for entry in hyps:
            utt, spk = entry[0], entry[1]
            sid = spk[1] if isinstance(spk, tuple) else spk
            role = entry[2] if len(entry) > 2 else (role_map or {}).get(sid, "subject")
            new_hyps.append((utt, spk, role))
        out.append((new_refs, new_hyps))
    return out


def export_tsne(
    embeddings: np.ndarray,
    labels: Sequence,
    roles: Optional[Sequence] = None,
    out_dir: str = "out/tsne",
    prefix: str = "embeddings",
) -> Tuple[str, str]:
    """TSVs for projector.tensorflow.org: vectors + metadata."""
    os.makedirs(out_dir, exist_ok=True)
    vec_path = os.path.join(out_dir, f"{prefix}_vectors.tsv")
    meta_path = os.path.join(out_dir, f"{prefix}_metadata.tsv")
    embeddings = np.asarray(embeddings)
    with open(vec_path, "w") as f:
        for row in embeddings:
            f.write("\t".join(f"{x:.6f}" for x in row) + "\n")
    with open(meta_path, "w") as f:
        if roles is not None:
            f.write("label\trole\n")
            for l, r in zip(labels, roles):
                f.write(f"{l}\t{r}\n")
        else:
            for l in labels:
                f.write(f"{l}\n")
    return vec_path, meta_path
