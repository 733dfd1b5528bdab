#!/usr/bin/env python3
"""The reference alignments of the model-based forced aligner, from the JAX
package on the CPU.

    python3 scripts/torch_align_reference.py

Writes tests/fixtures/torch_align_reference.json and, for the arrays,
tests/fixtures/torch_align_reference_arrays.npz (JAX_PLATFORMS=cpu): the
tracked checkpoint (accuracy_release/avg_last_3.bf16.msgpack) in float32
through `align_episode` over the first UTTERANCES utterances of episode 0
of scripts/ensure_corpus.sh's test split (4 x 180 s, seed 202, 8 speakers):
each utterance's token ids, word alignments [(begin_s, end_s, word_ix)] and
mean cross-attention [tokens, encoder frames]
(`attention_alignment_matrix`), and its accumulated DTW cost D of
-log(attention + 1e-8) (`dtw_cost_matrix`).

The committed fixture was made on an 8-core x86 CPU (no accelerator);
`seconds` holds the run's time.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_align_reference.json")
ARRAYS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_align_reference_arrays.npz")
CKPT = os.path.join("accuracy_release", "avg_last_3.bf16.msgpack")
TOKENIZER = os.path.join("accuracy_release", "bpe.model")
SPLIT = dict(n_episodes=4, episode_seconds=180.0, n_speakers=8, seed=202)
UTTERANCES = 6


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [ROOT]
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tal_asrd_tpu.align import forced
    from tal_asrd_tpu.align.dtw import dtw_cost_matrix
    from tal_asrd_tpu.core.checkpoint import load_pytree
    from tal_asrd_tpu.core.config import ModelConfig
    from tal_asrd_tpu.data.audio_io import load_audio_segment
    from tal_asrd_tpu.data.synth import build_synth_corpus
    from tal_asrd_tpu.models.asr import ASRModel
    from tal_asrd_tpu.text import BpeTokenizer

    t0 = time.perf_counter()
    tok = BpeTokenizer(model_path=os.path.join(ROOT, TOKENIZER))
    model = ASRModel(ModelConfig(model_type="1x", num_speakers=8, vocab_size=len(tok)),
                     dtype=jnp.float32)
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                    load_pytree(os.path.join(ROOT, CKPT)))
    variables = {"params": params}
    with tempfile.TemporaryDirectory() as tmp:
        split = os.path.join(tmp, "test")
        utts = build_synth_corpus(split, **SPLIT)["ep0"][:UTTERANCES]
        aligned = forced.align_episode(model, variables, tok, split, "ep0", utts)
        arrays, rows = {}, []
        for i, (u, a) in enumerate(zip(utts, aligned)):
            ids = tok.encode(u["utterance"], bos_token=False, eos_token=False)
            audio = load_audio_segment(os.path.join(split, "ep0.wav"), u["utterance_start"],
                                       u["utterance_end"])
            attn = forced.attention_alignment_matrix(model, variables, audio, ids)
            arrays[f"attn/{i}"] = attn
            arrays[f"d/{i}"] = np.asarray(dtw_cost_matrix(jnp.asarray(-np.log(attn + 1e-8))))
            rows.append({"utterance_start": u["utterance_start"],
                         "utterance_end": u["utterance_end"], "utterance": u["utterance"],
                         "token_ids": list(map(int, ids)),
                         "alignments": [list(map(float, w[:2])) + [int(w[2])]
                                        for w in a["alignments"]]})
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    fixture = {"what": "JAX CPU reference of the forced aligner "
                       "(scripts/torch_align_reference.py)",
               "checkpoint": CKPT, "tokenizer": TOKENIZER, "split": SPLIT,
               "episode": "ep0", "compute_dtype": "float32", "utterances": rows,
               "commit": commit, "seconds": time.perf_counter() - t0}
    np.savez_compressed(ARRAYS_NPZ, **arrays)
    with open(FIXTURE, "w") as f:
        json.dump(fixture, f, indent=None, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {FIXTURE} ({len(rows)} utterances, {fixture['seconds']:.1f} s)")


if __name__ == "__main__":
    main()
