"""The CLIs' argument parsers and `build_configs`.

Counterpart of tal_asrd_tpu/cli/args.py (`get_argparser(is_train)`,
`get_lm_argparser`, `build_configs`): the same flags, so a reference
invocation of `python -m tal_asrd_tpu.cli.test`, `.train` or `.train_lm`
runs unchanged as `python -m tal_asrd_tpu_torch.cli.test`, `.train` or
`.train_lm`, plus `--device`. --spk-weight > 0 builds the model with the
separate speaker head (`use_speaker_head`). --mesh-data / --mesh-model
shape the training CLI's process mesh (parallel/mesh.py; run it under
torchrun).

With the environment variable TAL_TINY_ARCH set, `build_configs` shrinks
the model to the reference's debug architecture (TDS depths (1, 1, 1),
width x 0.1, decoder width 64) for CPU runs of the whole CLI chain; the
training and the evaluation run must both set it.
"""
from __future__ import annotations

import argparse
import os

from tal_asrd_tpu_torch.core.config import DecodeConfig, ModelConfig, TrainConfig


def get_argparser(is_train: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--load", type=str, default=None)
    p.add_argument("--load-encoder", type=str, default=None)
    p.add_argument("--load-decoder", type=str, default=None)
    p.add_argument("--train-data", type=str, action="append", required=True)
    p.add_argument("--valid-data", type=str, action="append", required=True)
    p.add_argument("--test-data", type=str, action="append")
    p.add_argument("--cache-path", type=str, default="./cache")
    p.add_argument("--tokenizer", type=str, required=True)
    p.add_argument("--model-type", type=str, required=True, choices=["1x", "2x"])
    p.add_argument("--max-epochs", type=int, default=100)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--val-batch-size", type=int, default=None)
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--fused-decode", action="store_true", default=False,
                   help="per-token decode through the fused layer-step kernel "
                        "(speaker-token models)")
    p.add_argument("--bf16-params", action="store_true", default=False,
                   help="cast the loaded f32 parameters to bf16 before decoding")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--grad-acc", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-secs", type=float, default=20)
    p.add_argument("--no-strict", action="store_true", default=False)
    p.add_argument("--num-speakers", type=int, default=0)
    p.add_argument("--quick-test", action="store_true", default=False)
    p.add_argument("--unaligned", action="store_true", default=False,
                   help="long-form decode of whole episodes (the sliding-window "
                        "state machine, or VAD windows with --vad-windows)")
    p.add_argument("--unaligned-lanes", type=int, default=8,
                   help="encode up to N equal-length episodes together and run "
                        "them through the state machine as one group; 1 = one "
                        "episode at a time")
    # The unaligned state machine's knobs (DecodeConfig)
    p.add_argument("--thresh-prct", type=float, default=None)
    p.add_argument("--shift-prct", type=float, default=None)
    p.add_argument("--stall-patience", type=int, default=None)
    p.add_argument("--skip-prct", type=float, default=None)
    p.add_argument("--evict-block", type=int, default=None,
                   help="history-cap eviction block (1 = the reference's slide by 1)")
    p.add_argument("--eos-advance", action="store_true", default=False,
                   help="extension: an emitted EOS advances the window to the "
                        "attention centroid and re-primes the history")
    p.add_argument("--vad-windows", action="store_true", default=False,
                   help="long-form decode through VAD-gated windows instead of "
                        "the sliding-window state machine")
    p.add_argument("--vad-max-window", type=float, default=20.0,
                   help="longest VAD decode window in seconds before the "
                        "quietest-frame split")
    p.add_argument("--stall-rollback", action="store_true", default=False,
                   help="extension: stall resets also roll back the tokens "
                        "emitted since the last progress")
    p.add_argument("--shiftaug", action="store_true", default=False)
    p.add_argument("--alignaug", action="store_true", default=False)
    p.add_argument("--spk-weight", type=float, default=0)
    p.add_argument("--enc-posenc", action="store_true", default=False,
                   help="ReZero-gated sinusoidal positional code on the "
                        "decode-side memory; must match the checkpoint's training")
    p.add_argument("--val-check-interval", type=int, default=None)
    p.add_argument("--lm-weight", type=float, default=0)
    p.add_argument("--smoothing", type=float, default=0)
    p.add_argument("--lm-path", type=str, default=None)
    p.add_argument("--out-dir", type=str, default="out")
    p.add_argument("--mesh-data", type=int, default=-1)
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model and the decode ('cpu' for a "
                        "run without a GPU)")
    if is_train:
        p.add_argument("--no-specaug", action="store_true", default=False,
                       help="disable SpecAugment (narrowband/synthetic data)")
        p.add_argument("--audio-int16", action="store_true", default=False,
                       help="ship audio to the device as int16 (half the "
                            "transfer; lossless for 16-bit PCM sources)")
        p.add_argument("--ckpt-every", type=int, default=1,
                       help="checkpoint every N epochs (and on the last)")
        p.add_argument("--state-ckpt", choices=["last", "every"], default="last",
                       help="write the full resume state (optimizer moments) on "
                            "the final epoch only ('last') or on every "
                            "checkpoint epoch")
        p.add_argument("--cache-items", action="store_true", default=False,
                       help="cache decoded aligned items in RAM (small corpora)")
        p.add_argument("--num-utterances", type=str, default="1",
                       help="consecutive utterances per aligned item; a comma "
                            "list ('1,4') concatenates one aligned dataset per "
                            "value")
        p.add_argument("--no-restore-step", action="store_true", default=False,
                       help="do not restore the step counter when --load points "
                            "at this run's own checkpoint directory")
        p.add_argument("--name", type=str, required=True)
        p.add_argument("--project", type=str, default="asr")
        p.add_argument("--checkpoint-path", type=str, default="./models/tal-asrd-tpu")
        p.add_argument("--overfit-pct", type=float, default=0)
    return p


def get_lm_argparser() -> argparse.ArgumentParser:
    """The LM-training CLI's flags (cli/train_lm.py), plus --device. Its
    defaults (hidden 768, 4 layers) are the reference's: the eval CLI loads
    only the 512 / 4-head / 6-layer shape."""
    p = argparse.ArgumentParser()
    p.add_argument("--train-data", type=str, required=True)
    p.add_argument("--valid-data", type=str, required=True)
    p.add_argument("--epoch-len", type=int, default=5000)
    p.add_argument("--cache-path", type=str, default="./cache")
    p.add_argument("--tokenizer", type=str, required=True)
    p.add_argument("--max-epochs", type=int, default=100)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--hidden-size", type=int, default=768)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--attn-heads", type=int, default=4)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--name", type=str, required=True)
    p.add_argument("--checkpoint-path", type=str, default="./models/tal-asrd-tpu")
    p.add_argument("--load", type=str, default=None)
    p.add_argument("--quick-test", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the LM ('cpu' for a run without a GPU)")
    return p


def build_configs(args, tokenizer=None):
    """argparse Namespace -> (ModelConfig, TrainConfig, DecodeConfig).

    `tokenizer`, when given, sizes the text vocabulary (num_tokens =
    len(tokenizer) + num_speakers); without it ModelConfig's 10000 stays."""
    tiny = {}
    if os.environ.get("TAL_TINY_ARCH"):
        tiny = dict(tds_depths=(1, 1, 1), width_mult=0.1, d_decoder_override=64)
        print("[args] TAL_TINY_ARCH set: depths (1,1,1), width_mult 0.1, "
              "d_decoder 64 — debug smoke architecture, NOT the 1x/2x model")
    model_cfg = ModelConfig(
        model_type=args.model_type,
        num_speakers=args.num_speakers,
        use_speaker_head=args.spk_weight > 0,
        enc_posenc=args.enc_posenc,
        **({"vocab_size": len(tokenizer)} if tokenizer is not None else {}),
        **tiny,
    )
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        val_batch_size=args.val_batch_size,
        lr=args.lr,
        grad_acc=args.grad_acc,
        max_steps=args.max_steps,
        max_epochs=args.max_epochs,
        smoothing=args.smoothing,
        spk_weight=args.spk_weight,
        lm_weight=args.lm_weight,
        max_secs=args.max_secs,
    )
    dc_over = {
        k: v for k, v in (
            ("thresh_prct", args.thresh_prct),
            ("shift_prct", args.shift_prct),
            ("stall_patience", args.stall_patience),
            ("skip_prct", args.skip_prct),
            ("history_evict_block", args.evict_block),
        ) if v is not None
    }
    decode_cfg = DecodeConfig(beam_size=args.beam_size, lm_weight=args.lm_weight,
                              use_fused_decode=args.fused_decode,
                              eos_advance=args.eos_advance,
                              stall_rollback=args.stall_rollback,
                              **dc_over)
    return model_cfg, train_cfg, decode_cfg
