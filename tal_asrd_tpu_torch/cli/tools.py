"""Corpus and checkpoint tools.

    python -m tal_asrd_tpu_torch.cli.tools average-ckpt --ckpt-dir DIR --last-k 3 --out F
    python -m tal_asrd_tpu_torch.cli.tools expand-speakers --ckpt F --num-tokens N --out G
    python -m tal_asrd_tpu_torch.cli.tools synth-corpus --out-dir DIR [--episodes 8 ...]
    python -m tal_asrd_tpu_torch.cli.tools synth-sad-stress --out-dir DIR [--episodes 6 ...]
    python -m tal_asrd_tpu_torch.cli.tools train-tokenizer --input TXT --model-prefix P
    python -m tal_asrd_tpu_torch.cli.tools chunk-audio --src WAV_OR_GLOB --out-dir DIR
    python -m tal_asrd_tpu_torch.cli.tools convert-audio --src FILE_OR_GLOB --out-dir DIR
    python -m tal_asrd_tpu_torch.cli.tools merge-outputs --inputs A.jsonl B.jsonl --out P
    python -m tal_asrd_tpu_torch.cli.tools librispeech-format --src SPLIT --out-dir DIR
    python -m tal_asrd_tpu_torch.cli.tools wder-format --test-result PKL --out PKL \
        [--role-map JSON] [--sd-features NPY] [--chunk 357] [--device cuda]

Counterpart of tal_asrd_tpu/cli/tools.py, with the same arguments and
output files: `average-ckpt` writes the leaf-wise mean of the last k
checkpoints of a run (`CheckpointManager.average_last`), `expand-speakers`
grows a checkpoint's embedding table for new speaker tokens,
`convert-audio` writes mono 16 kHz wavs (ffmpeg for other containers),
`merge-outputs` joins jsonl shards into one pickle, `librispeech-format`
lays a LibriSpeech split out as a transcript.pkl corpus (one episode a
chapter), `wder-format` turns a test_result.pkl into the wder-ready pickle
(with --sd-features, attention-windowed embeddings on --device),
`synth-sad-stress` writes the SAD stress corpus (data/synth.py). The
reference's other subcommands are not ported yet: they exit non-zero
naming the ROADMAP item that ports them (`UNPORTED`).
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
from glob import glob
from typing import List, Optional

UNPORTED = {
    "diar-features": "A17 (diarization features)",
}


def _files(src: str) -> List[str]:
    return sorted(glob(src)) if any(ch in src for ch in "*?") else [src]


def librispeech_format(src: str, out_dir: str) -> None:
    """One episode a chapter: the chapter's utterance files (wav, or flac
    through ffmpeg) concatenated into <speaker>-<chapter>.wav, each an
    utterance dict at its place in it; transcript.pkl and speaker_map.json."""
    import numpy as np

    from tal_asrd_tpu_torch.data.audio_io import (
        DEFAULT_SR, convert_audio, load_audio_segment, write_wav)

    os.makedirs(out_dir, exist_ok=True)
    transcripts, speakers = {}, {}
    for spk_dir in sorted(os.listdir(src)):
        spk_path = os.path.join(src, spk_dir)
        if not os.path.isdir(spk_path):
            continue
        for chap_dir in sorted(os.listdir(spk_path)):
            chap_path = os.path.join(spk_path, chap_dir)
            trans = glob(os.path.join(chap_path, "*.trans.txt"))
            if not trans:
                continue
            lines = {}
            with open(trans[0]) as f:
                for line in f:
                    utt_id, _, text = line.strip().partition(" ")
                    lines[utt_id] = text
            chunks, utts, t = [], [], 0.0
            for utt_id in sorted(lines):
                for ext in (".wav", ".flac"):
                    ap = os.path.join(chap_path, utt_id + ext)
                    if os.path.exists(ap):
                        break
                else:
                    continue
                if ap.endswith(".flac"):
                    tmp = os.path.join(out_dir, utt_id + ".tmp.wav")
                    convert_audio(ap, tmp)
                    ap = tmp
                x = load_audio_segment(ap, 0.0, None)
                dur = len(x) / DEFAULT_SR
                utts.append({"utterance": lines[utt_id].lower(), "speaker": spk_dir,
                             "utterance_start": t, "utterance_end": t + dur,
                             "role": "subject"})
                chunks.append(x)
                t += dur
                if ap.endswith(".tmp.wav"):
                    os.remove(ap)
            if not chunks:
                continue
            stub = f"{spk_dir}-{chap_dir}"
            write_wav(os.path.join(out_dir, stub + ".wav"), np.concatenate(chunks))
            transcripts[stub] = utts
            speakers.setdefault(spk_dir.lower(), len(speakers))
    with open(os.path.join(out_dir, "transcript.pkl"), "wb") as f:
        pickle.dump(transcripts, f)
    with open(os.path.join(out_dir, "speaker_map.json"), "w") as f:
        json.dump(speakers, f)
    print(f"wrote {len(transcripts)} episodes to {out_dir}")


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser("tal_asrd_tpu_torch tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train-tokenizer")
    t.add_argument("--input", required=True, help="text corpus file")
    t.add_argument("--model-prefix", required=True)
    t.add_argument("--vocab-size", type=int, default=10000)
    t.add_argument("--character-coverage", type=float, default=1.0)

    c = sub.add_parser("convert-audio")
    c.add_argument("--src", required=True)
    c.add_argument("--out-dir", required=True)
    c.add_argument("--sr", type=int, default=16000)

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

    m = sub.add_parser("merge-outputs")
    m.add_argument("--inputs", nargs="+", required=True)
    m.add_argument("--out", required=True)

    ls = sub.add_parser("librispeech-format",
                        help="LibriSpeech layout -> transcript.pkl corpus")
    ls.add_argument("--src", required=True,
                    help="LibriSpeech split dir (speaker/chapter/*.flac|wav + .trans.txt)")
    ls.add_argument("--out-dir", required=True)

    wf = sub.add_parser("wder-format", help="test_result.pkl -> wder_ready.pkl")
    wf.add_argument("--test-result", required=True)
    wf.add_argument("--out", required=True)
    wf.add_argument("--role-map", default=None, help="optional speaker->role json")
    wf.add_argument("--sd-features", default=None,
                    help="optional .npy of separate-SD frame features for "
                         "attention-weighted speaker embeddings")
    wf.add_argument("--chunk", type=int, default=357)
    wf.add_argument("--device", default="cuda",
                    help="where the attention-weighted embeddings are computed")

    sy = sub.add_parser("synth-corpus",
                        help="synthetic-speech corpus in the reference's layout "
                             "(the audio encodes the text)")
    sy.add_argument("--out-dir", required=True)
    sy.add_argument("--episodes", type=int, default=8)
    sy.add_argument("--episode-seconds", type=float, default=120.0)
    sy.add_argument("--speakers", type=int, default=4)
    sy.add_argument("--seed", type=int, default=0)

    ss = sub.add_parser("synth-sad-stress",
                        help="SAD stress corpus: noise floor, SNR sweep, "
                             "crossfaded bounds, hum/burst distractors")
    ss.add_argument("--out-dir", required=True)
    ss.add_argument("--episodes", type=int, default=6)
    ss.add_argument("--episode-seconds", type=float, default=90.0)
    ss.add_argument("--speakers", type=int, default=8)
    ss.add_argument("--seed", type=int, default=0)
    ss.add_argument("--snr-low", type=float, default=0.0)
    ss.add_argument("--snr-high", type=float, default=20.0)
    ss.add_argument("--noise-rms", type=float, default=0.02)

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

    elif args.cmd == "convert-audio":
        from tal_asrd_tpu_torch.data.audio_io import convert_audio

        files = _files(args.src)
        os.makedirs(args.out_dir, exist_ok=True)
        for f in files:
            stub = os.path.splitext(os.path.basename(f))[0]
            convert_audio(f, os.path.join(args.out_dir, stub + ".wav"), args.sr)
        print(f"converted {len(files)} files")

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

    elif args.cmd == "merge-outputs":
        from tal_asrd_tpu_torch.eval.tools import merge_outputs

        rows = merge_outputs(args.inputs, args.out)
        print(f"merged {len(rows)} rows -> {args.out}")

    elif args.cmd == "librispeech-format":
        librispeech_format(args.src, args.out_dir)

    elif args.cmd == "wder-format":
        import numpy as np

        from tal_asrd_tpu_torch.eval.convert import convert_results

        with open(args.test_result, "rb") as f:
            results = pickle.load(f)
        role_map = None
        if args.role_map:
            with open(args.role_map) as f:
                role_map = json.load(f)
        sd = np.load(args.sd_features) if args.sd_features else None
        out = convert_results(results, role_map=role_map, sd_features=sd,
                              chunk=args.chunk, device=args.device)
        with open(args.out, "wb") as f:
            pickle.dump(out, f)
        print(f"wrote {len(out)} wder-ready pairs to {args.out}")

    elif args.cmd == "synth-corpus":
        from tal_asrd_tpu_torch.data.synth import build_synth_corpus

        tr = build_synth_corpus(args.out_dir, n_episodes=args.episodes,
                                episode_seconds=args.episode_seconds,
                                n_speakers=args.speakers, seed=args.seed)
        n_utts = sum(len(u) for u in tr.values())
        print(f"wrote {len(tr)} episodes ({n_utts} utterances) to {args.out_dir}")

    elif args.cmd == "synth-sad-stress":
        from tal_asrd_tpu_torch.data.synth import build_sad_stress_corpus

        tr = build_sad_stress_corpus(
            args.out_dir, n_episodes=args.episodes,
            episode_seconds=args.episode_seconds, n_speakers=args.speakers,
            seed=args.seed, snr_db=(args.snr_low, args.snr_high),
            noise_rms=args.noise_rms)
        n_utts = sum(len(u) for u in tr.values())
        print(f"wrote {len(tr)} stress episodes ({n_utts} utterances) "
              f"to {args.out_dir}")


if __name__ == "__main__":
    main()
