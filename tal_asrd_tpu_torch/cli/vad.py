"""VAD CLI: speech detection over a directory, and its evaluation.

    python -m tal_asrd_tpu_torch.cli.vad --data-dir D --out-dir OUT
        [--detector energy|gmm] [--eval-transcripts] [--json-out F] [--device cpu]

Counterpart of tal_asrd_tpu/cli/vad.py: runs the VAD over a directory,
writes bounds pickles and speech-only wavs, optionally scores against the
transcripts' utterance bounds. The energy detector runs on --device
(default cuda); the gmm detector and the trigger state machine on the host.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("VAD pipeline")
    p.add_argument("--data-dir", type=str, required=True)
    p.add_argument("--out-dir", type=str, required=True)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--vad-level", type=int, default=3)
    # trigger / detrigger ring-buffer proportions
    p.add_argument("--prop-start", type=float, default=0.9)
    p.add_argument("--prop-end", type=float, default=0.9)
    p.add_argument("--detector", choices=["energy", "gmm"], default="energy")
    p.add_argument("--no-speech-wav", action="store_true", default=False)
    p.add_argument("--eval-transcripts", action="store_true", default=False,
                   help="score against transcript.pkl utterance bounds")
    p.add_argument("--json-out", type=str, default=None,
                   help="write mean P/R/F1/compression as JSON")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the energy detector ('cpu' for a run "
                        "without a GPU)")
    return p


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the VAD; returns {"bounds": {wav path: bounds}, "metrics": the
    mean scores (empty without --eval-transcripts)}."""
    args = get_parser().parse_args(argv)

    from tal_asrd_tpu_torch.vad import VadConfig, evaluate_vad, run_vad_directory

    cfg = VadConfig(vad_level=args.vad_level, prop_voice_start=args.prop_start,
                    prop_unvoice_end=args.prop_end, detector=args.detector)
    bounds_map = run_vad_directory(args.data_dir, args.out_dir, cfg, workers=args.workers,
                                   write_speech_wav=not args.no_speech_wav,
                                   device=args.device)
    print(f"Processed {len(bounds_map)} files")

    metrics = {}
    if args.eval_transcripts:
        from tal_asrd_tpu_torch.data.audio_io import get_duration
        from tal_asrd_tpu_torch.data.transcript import load_transcripts
        from tal_asrd_tpu_torch.vad.eval import utterance_gold_bounds

        transcripts = load_transcripts(args.data_dir)
        scores = []
        for path, bounds in bounds_map.items():
            stub = os.path.splitext(os.path.basename(path))[0]
            if stub not in transcripts:
                continue
            s = evaluate_vad(bounds, utterance_gold_bounds(transcripts[stub]),
                             get_duration(path))
            scores.append(s)
            print(f"{stub}: P {s.precision:.3f} R {s.recall:.3f} "
                  f"F1 {s.f1:.3f} compression {s.compression:.3f}")
        if scores:
            mean = lambda k: sum(getattr(s, k) for s in scores) / len(scores)
            metrics = {"vad_precision_pct": round(100 * mean("precision"), 2),
                       "vad_recall_pct": round(100 * mean("recall"), 2),
                       "vad_f1_pct": round(100 * mean("f1"), 2),
                       "vad_compression_pct": round(100 * mean("compression"), 2)}
        if args.json_out and metrics:
            with open(args.json_out, "w") as f:
                json.dump(metrics, f)
            print(f"VAD metrics -> {args.json_out}")
    return {"bounds": bounds_map, "metrics": metrics}


if __name__ == "__main__":
    main()
