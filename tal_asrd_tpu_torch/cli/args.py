"""The evaluation CLI's argument parser and `build_configs`.

Counterpart of the test side of tal_asrd_tpu/cli/args.py (`get_argparser(
is_train=False)`, `build_configs`): the same flags, so a reference
invocation of `python -m tal_asrd_tpu.cli.test` runs unchanged as
`python -m tal_asrd_tpu_torch.cli.test`, plus `--device`. LM fusion
(--lm-path / --lm-weight, ROADMAP A14) and the separate speaker head
(--spk-weight > 0, A12.2) are not ported yet: cli/test.py refuses them,
naming the item.
"""
from __future__ import annotations

import argparse

from tal_asrd_tpu_torch.core.config import DecodeConfig, ModelConfig, TrainConfig


def get_argparser() -> argparse.ArgumentParser:
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
    return p


def build_configs(args, tokenizer=None):
    """argparse Namespace -> (ModelConfig, TrainConfig, DecodeConfig).

    `tokenizer`, when given, sizes the text vocabulary (num_tokens =
    len(tokenizer) + num_speakers); without it ModelConfig's 10000 stays."""
    model_cfg = ModelConfig(
        model_type=args.model_type,
        num_speakers=args.num_speakers,
        use_speaker_head=args.spk_weight > 0,
        enc_posenc=args.enc_posenc,
        **({"vocab_size": len(tokenizer)} if tokenizer is not None else {}),
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
