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
    python -m tal_asrd_tpu_torch.cli.tools diar-features --data DIR --out-dir DIR \
        [--features logmel|wav2vec] [--wav2vec-ckpt MSGPACK] [--device cuda]

Counterpart of tal_asrd_tpu/cli/tools.py, with the same arguments and
output files: `average-ckpt` writes the leaf-wise mean of the last k
checkpoints of a run (`CheckpointManager.average_last`), `expand-speakers`
grows a checkpoint's embedding table for new speaker tokens,
`convert-audio` writes mono 16 kHz wavs (ffmpeg for other containers),
`merge-outputs` joins jsonl shards into one pickle, `librispeech-format`
lays a LibriSpeech split out as a transcript.pkl corpus (one episode a
chapter), `wder-format` turns a test_result.pkl into the wder-ready pickle
(with --sd-features, attention-windowed embeddings on --device),
`synth-sad-stress` writes the SAD stress corpus (data/synth.py),
`diar-features` writes one (sequences, cluster_ids) pickle an episode for
UIS-RNN (cli/uisrnn.py): per utterance of at least 400 samples either the
mean and standard deviation (ddof 0) over frames of its log-mel (no mean
subtracted: 160-d), on --device through the frontend's K2 kernel, one
launch an episode with the utterances' frames stacked (each utterance
framed alone: the reflect padding is its own), or the frame mean of the
wav2vec-style features (diarization/wav2vec.py; --wav2vec-ckpt is a flax
msgpack tree, else the port's own initial draw).
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from glob import glob
from typing import List, Optional


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


def utterance_power(audios, cfg, device):
    """The power spectra of each utterance (framed alone, reflect-padded),
    stacked: [sum of frames, n_fft // 2 + 1] f32 on `device`."""
    import torch

    from tal_asrd_tpu_torch.ops.logmel import power_spectrogram

    return torch.cat([power_spectrogram(torch.from_numpy(a).to(device)[None], cfg)[0]
                      for a in audios]).contiguous()


def logmel_stats(audios, cfg, device):
    """[n, 2 * n_mels] float32: each utterance's log-mel (no mean subtracted)
    mean and standard deviation (ddof 0) over its frames, the projection and
    log of all the utterances' frames in one `fused_logmel_project` launch."""
    import torch

    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.ops.logmel import mel_filterbank

    fb = torch.from_numpy(mel_filterbank(
        cfg.n_fft // 2 + 1, cfg.f_min, cfg.effective_f_max, cfg.n_mels,
        cfg.sample_rate)).to(device)
    mel = fused_logmel_project(utterance_power(audios, cfg, device), fb, cfg.log_eps)
    frames = [1 + len(a) // cfg.hop_length for a in audios]
    rows = []
    for part in mel.split(frames):
        std, mean = torch.std_mean(part.double(), dim=0, correction=0)
        rows.append(torch.cat([mean, std]))
    return torch.stack(rows).to(torch.float32).cpu().numpy()


def diar_features(data: str, out_dir: str, features: str = "logmel",
                  wav2vec_ckpt: Optional[str] = None, device="cuda") -> None:
    """The diar-features subcommand."""
    import numpy as np

    from tal_asrd_tpu_torch.core.config import FrontendConfig
    from tal_asrd_tpu_torch.data.audio_io import load_audio_segment

    with open(os.path.join(data, "transcript.pkl"), "rb") as f:
        transcripts = pickle.load(f)
    os.makedirs(out_dir, exist_ok=True)
    if features == "wav2vec":
        from tal_asrd_tpu_torch.core.checkpoint import load_pytree
        from tal_asrd_tpu_torch.diarization.wav2vec import (
            extract_utterance_features, init_wav2vec, load_wav2vec)

        model = (load_wav2vec(load_pytree(wav2vec_ckpt), device) if wav2vec_ckpt
                 else init_wav2vec(device=device)[0])
    fe_cfg = FrontendConfig(mean_subtract=False)
    for stub, utts in transcripts.items():
        wav = os.path.join(data, stub + ".wav")
        audios, ids = [], []
        for u in utts:
            audio = load_audio_segment(wav, u["utterance_start"], u["utterance_end"])
            if len(audio) < 400:
                continue
            audios.append(audio)
            ids.append(u["speaker"])
        if not audios:
            continue
        if features == "logmel":
            feats = logmel_stats(audios, fe_cfg, device)
        else:
            feats = np.stack([extract_utterance_features(model, a, window_s=None)
                              .mean(axis=0).astype(np.float32) for a in audios])
        with open(os.path.join(out_dir, stub + ".pkl"), "wb") as f:
            pickle.dump((feats, ids), f)
        print(f"{stub}: {len(feats)} utterances x {feats.shape[1]}-d")
    print(f"wrote {len(transcripts)} episode feature files to {out_dir}")


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

    df = sub.add_parser("diar-features",
                        help="per-utterance diarization features over a corpus -> "
                             "per-episode (sequences, cluster_ids) pickles for UIS-RNN")
    df.add_argument("--data", required=True, help="corpus dir (transcript.pkl)")
    df.add_argument("--out-dir", required=True)
    df.add_argument("--features", choices=["logmel", "wav2vec"], default="logmel",
                    help="logmel: mean+std pooled log-mel (160-d); wav2vec: "
                         "mean-pooled aggregator features")
    df.add_argument("--wav2vec-ckpt", default=None,
                    help="optional wav2vec parameters (a flax msgpack tree)")
    df.add_argument("--device", default="cuda",
                    help="where the features are computed")

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

    elif args.cmd == "diar-features":
        from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project

        before = fused_logmel_project.launches
        diar_features(args.data, args.out_dir, args.features, args.wav2vec_ckpt,
                      args.device)
        print(f"fused_logmel_project launches: {fused_logmel_project.launches - before}")

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
