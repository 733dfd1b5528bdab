"""Corpus and checkpoint tools.

    python -m tal_asrd_tpu_torch.cli.tools average-ckpt --ckpt-dir DIR --last-k 3 --out F
    python -m tal_asrd_tpu_torch.cli.tools expand-speakers --ckpt F --num-tokens N --out G
    python -m tal_asrd_tpu_torch.cli.tools synth-corpus --out-dir DIR [--episodes 8 ...]
    python -m tal_asrd_tpu_torch.cli.tools train-tokenizer --input TXT --model-prefix P
    python -m tal_asrd_tpu_torch.cli.tools chunk-audio --src WAV_OR_GLOB --out-dir DIR

Counterpart of tal_asrd_tpu/cli/tools.py for the subcommands of the
training recipe (`scripts/ensure_corpus.sh`, `scripts/accuracy.sh`), with
the same arguments and output files: `average-ckpt` writes the leaf-wise
mean of the last k checkpoints of a run (`CheckpointManager.average_last`),
`expand-speakers` grows a checkpoint's embedding table for new speaker
tokens. The reference's other subcommands are not ported yet: they exit
non-zero naming the ROADMAP item that ports them (`UNPORTED`).
"""
from __future__ import annotations

import argparse
import os
import sys
from glob import glob
from typing import List, Optional

UNPORTED = {
    "convert-audio": "A16.2 (the rest of cli/tools.py)",
    "merge-outputs": "A16.2 (eval/tools.py)",
    "librispeech-format": "A16.2 (the rest of cli/tools.py)",
    "wder-format": "A16.2 (the SD-feature and word-level cases of eval/convert.py)",
    "diar-features": "A17 (diarization features)",
    "synth-sad-stress": "A18 (build_sad_stress_corpus)",
}


def _files(src: str) -> List[str]:
    return sorted(glob(src)) if any(ch in src for ch in "*?") else [src]


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser("tal_asrd_tpu_torch tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train-tokenizer")
    t.add_argument("--input", required=True, help="text corpus file")
    t.add_argument("--model-prefix", required=True)
    t.add_argument("--vocab-size", type=int, default=10000)
    t.add_argument("--character-coverage", type=float, default=1.0)

    ch = sub.add_parser("chunk-audio")
    ch.add_argument("--src", required=True)
    ch.add_argument("--out-dir", required=True)
    ch.add_argument("--chunk-secs", type=float, default=30.0)

    a = sub.add_parser("average-ckpt")
    a.add_argument("--ckpt-dir", required=True)
    a.add_argument("--last-k", type=int, default=5)
    a.add_argument("--out", required=True)

    e = sub.add_parser("expand-speakers")
    e.add_argument("--ckpt", required=True)
    e.add_argument("--num-tokens", type=int, required=True)
    e.add_argument("--out", required=True)

    sy = sub.add_parser("synth-corpus",
                        help="synthetic-speech corpus in the reference's layout "
                             "(the audio encodes the text)")
    sy.add_argument("--out-dir", required=True)
    sy.add_argument("--episodes", type=int, default=8)
    sy.add_argument("--episode-seconds", type=float, default=120.0)
    sy.add_argument("--speakers", type=int, default=4)
    sy.add_argument("--seed", type=int, default=0)

    for name, item in UNPORTED.items():
        sub.add_parser(name, help=f"not ported yet: ROADMAP {item}")

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in UNPORTED:
        sys.exit(f"tal_asrd_tpu_torch.cli.tools {argv[0]}: not ported yet, "
                 f"ROADMAP {UNPORTED[argv[0]]}")
    args = p.parse_args(argv)

    if args.cmd == "train-tokenizer":
        from tal_asrd_tpu_torch.text.bpe import BpeTrainer

        model = BpeTrainer(args.vocab_size, args.character_coverage).train_file(
            args.input, args.model_prefix + ".model")
        print(f"trained {len(model)}-piece model -> {args.model_prefix}.model")

    elif args.cmd == "chunk-audio":
        from tal_asrd_tpu_torch.data.audio_io import (
            get_duration, load_audio_segment, write_wav)

        files = _files(args.src)
        os.makedirs(args.out_dir, exist_ok=True)
        for f in files:
            stub = os.path.splitext(os.path.basename(f))[0]
            dur = get_duration(f)
            i, t = 0, 0.0
            while t < dur:
                seg = load_audio_segment(f, t, min(t + args.chunk_secs, dur))
                write_wav(os.path.join(args.out_dir, f"{stub}_{i:04d}.wav"), seg)
                t += args.chunk_secs
                i += 1
        print(f"chunked {len(files)} files")

    elif args.cmd == "average-ckpt":
        from tal_asrd_tpu_torch.core.checkpoint import CheckpointManager, save_pytree

        mgr = CheckpointManager(args.ckpt_dir)
        save_pytree(args.out, mgr.average_last(args.last_k))
        print(f"averaged last {args.last_k} of {len(mgr.steps())} -> {args.out}")

    elif args.cmd == "expand-speakers":
        from tal_asrd_tpu_torch.core.checkpoint import (
            expand_speaker_embeddings, load_pytree, save_pytree)

        params = load_pytree(args.ckpt)
        emb = params["embedding"]["embedding"]
        params["embedding"]["embedding"] = expand_speaker_embeddings(emb, args.num_tokens)
        save_pytree(args.out, params)
        print(f"expanded embedding {emb.shape[0]} -> {args.num_tokens} rows")

    elif args.cmd == "synth-corpus":
        from tal_asrd_tpu_torch.data.synth import build_synth_corpus

        tr = build_synth_corpus(args.out_dir, n_episodes=args.episodes,
                                episode_seconds=args.episode_seconds,
                                n_speakers=args.speakers, seed=args.seed)
        n_utts = sum(len(u) for u in tr.values())
        print(f"wrote {len(tr)} episodes ({n_utts} utterances) to {args.out_dir}")


if __name__ == "__main__":
    main()
