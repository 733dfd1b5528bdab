"""Standalone windowed transcription CLI.

    python -m tal_asrd_tpu_torch.cli.transcribe --audio WAV_OR_DIR --load CKPT \
        --tokenizer accuracy_release/bpe.model --model-type 1x --num-speakers 8 \
        [--out-dir out/transcripts] [--fused-decode] [--bf16-params] [--device cpu]

Counterpart of tal_asrd_tpu/cli/transcribe.py: transcribes a directory (or
one file) of wavs with overlapped windows and splicing, optional VAD gating,
and skips a file whose transcript exists. The model computes in bf16 on
--device (default cuda); the checkpoint loads non-strictly, as the
reference's does.
"""
from __future__ import annotations

import argparse
import os
from glob import glob
from typing import Dict, List, Optional

import torch

from tal_asrd_tpu_torch.cli.test import cast_parameters_to_bf16, load_weights
from tal_asrd_tpu_torch.core.config import ModelConfig
from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
from tal_asrd_tpu_torch.decode.transcribe import TranscribeConfig, Transcriber
from tal_asrd_tpu_torch.models.asr import ASRModel
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--audio", type=str, required=True, help="wav file or directory of wavs")
    p.add_argument("--out-dir", type=str, default="out/transcripts")
    p.add_argument("--load", type=str, required=True)
    p.add_argument("--tokenizer", type=str, required=True)
    p.add_argument("--model-type", type=str, default="2x")
    p.add_argument("--num-speakers", type=int, default=0)
    p.add_argument("--window-secs", type=float, default=30.0)
    p.add_argument("--overlap", type=float, default=0.25)
    p.add_argument("--batch-size", type=int, default=15)
    p.add_argument("--beam-size", type=int, default=4)
    p.add_argument("--lm-weight", type=float, default=0.0,
                   help="LM fusion weight; inert, as in the reference: this CLI "
                        "loads no LM")
    p.add_argument("--length", type=int, default=120)
    p.add_argument("--truncate", type=float, default=-1.0)
    p.add_argument("--speech-only", action="store_true", default=False)
    p.add_argument("--no-splice", action="store_true", default=False)
    p.add_argument("--use-eos", action="store_true", default=False,
                   help="terminate on EOS instead of EOT")
    p.add_argument("--bf16-params", action="store_true", default=False,
                   help="cast the loaded f32 parameters to bf16 before decoding")
    p.add_argument("--fused-decode", action="store_true", default=False,
                   help="per-token decode through the fused layer-step kernel")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model and the decode ('cpu' for a "
                        "run without a GPU)")
    return p


def main(argv: Optional[List[str]] = None) -> Dict[str, str]:
    """Transcribe; returns {wav path: transcript} for the files written."""
    args = get_parser().parse_args(argv)
    tokenizer = BpeTokenizer(model_path=args.tokenizer)
    cfg = ModelConfig(model_type=args.model_type, num_speakers=args.num_speakers,
                      vocab_size=len(tokenizer))
    model = ASRModel(cfg, device=args.device, compute_dtype=torch.bfloat16).eval()
    load_weights(model, args.load, strict=False)
    if args.bf16_params:
        cast_parameters_to_bf16(model)

    tc = TranscribeConfig(
        window_seconds=args.window_secs, overlap=args.overlap, batch_size=args.batch_size,
        beam_size=args.beam_size, lm_weight=args.lm_weight, max_new_tokens=args.length,
        use_eot=not args.use_eos,
        speech_only=args.speech_only, splice=not args.no_splice)
    tr = Transcriber(model, tokenizer, tc, device=args.device,
                     decoder=FusedASRDecoder(model) if args.fused_decode else None)

    files = (sorted(glob(os.path.join(args.audio, "*.wav"))) if os.path.isdir(args.audio)
             else [args.audio])
    os.makedirs(args.out_dir, exist_ok=True)
    written = {}
    for path in files:
        stub = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.out_dir, stub + ".txt")
        if os.path.exists(out_path):  # resume
            print(f"skip {stub} (exists)")
            continue
        result = tr.transcribe_file(path, truncate=args.truncate, log=True)
        text = result if isinstance(result, str) else "\n".join(result)
        with open(out_path, "w") as f:
            f.write(text + "\n")
        written[path] = text
        print(f"wrote {out_path}")
    return written


if __name__ == "__main__":
    main()
