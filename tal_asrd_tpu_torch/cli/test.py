"""ASR evaluation CLI, its aligned leg.

    python -m tal_asrd_tpu_torch.cli.test --train-data D --valid-data D --test-data D \
        --tokenizer accuracy_release/bpe.model --model-type 1x --num-speakers 8 \
        --load accuracy_release/avg_last_3.bf16.msgpack --out-dir OUT [--fused-decode] \
        [--device cpu]

Counterpart of tal_asrd_tpu/cli/test.py without --unaligned: builds the
system's model (f32 parameters, bf16 compute), loads the checkpoint through
the port's msgpack reader and converter, segments the test split into single
utterances of 3 s to --max-secs, batches them in order (no shuffle, the last
batch short), and runs teacher-forced loss + beam generation over them with
EvalRunner. Writes OUT/test_result.pkl, hyp.txt and ref.txt and prints the
mean test loss. Everything runs on --device (default cuda).

--unaligned (ROADMAP A9), --lm-path / --lm-weight (A14), --spk-weight > 0
(A12.2) and --bf16-params (A8) are not ported: they exit with a message.
"""
from __future__ import annotations

import os
import sys
from dataclasses import replace
from typing import Dict, List, Optional

from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
from tal_asrd_tpu_torch.core.checkpoint import load_pytree
from tal_asrd_tpu_torch.core.convert import params_to_state_dict
from tal_asrd_tpu_torch.data.aligned import AlignedDataset
from tal_asrd_tpu_torch.data.collate import BucketedCollater
from tal_asrd_tpu_torch.data.loader import DataLoader, ShardedSampler
from tal_asrd_tpu_torch.eval.runner import EvalRunner
from tal_asrd_tpu_torch.models.asr import ASRModel
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
from tal_asrd_tpu_torch.train.system import ASRSystem

# Flags of paths that are not ported, with the ROADMAP item of each.
UNPORTED = (
    (lambda a: a.unaligned, "--unaligned: the unaligned legs are ROADMAP A9/A10"),
    (lambda a: a.lm_path is not None or a.lm_weight != 0,
     "--lm-path / --lm-weight: LM shallow fusion is ROADMAP A14"),
    (lambda a: a.spk_weight > 0, "--spk-weight > 0: the separate speaker head is ROADMAP A12.2"),
    (lambda a: a.bf16_params, "--bf16-params: bf16 parameters for decoding are ROADMAP A8"),
)


def load_weights(model: ASRModel, path: str, strict: bool = True) -> None:
    """Fill `model` from a flax msgpack checkpoint. A checkpoint without the
    enc_posenc gate leaves its zero init (the gated model then equals the
    checkpoint's). With strict=False, leaves that are missing or of another
    shape keep the model's values."""
    loaded = params_to_state_dict(load_pytree(path))
    own = model.state_dict()
    if not strict:
        loaded = {k: t for k, t in loaded.items()
                  if k in own and tuple(t.shape) == tuple(own[k].shape)}
    missing, unexpected = model.load_state_dict(loaded, strict=False)  # shapes checked
    if strict and (set(missing) - {"mem_pos_alpha"} or unexpected):
        raise KeyError(f"checkpoint {path}: missing {missing}, unexpected {unexpected}")


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the aligned evaluation. Returns {"test_loss", "runner", "steps"}:
    the EvalRunner (its model, its outputs) and, per batch, the dataset
    indices and what test_step_aligned returned."""
    args = get_argparser().parse_args(argv)
    for refused, message in UNPORTED:
        if refused(args):
            sys.exit(f"tal_asrd_tpu_torch.cli.test: {message}, not ported yet")
    if not args.test_data:
        sys.exit("--test-data required")
    if not args.load:
        sys.exit("--load (checkpoint) required")

    tokenizer = BpeTokenizer(model_path=args.tokenizer)
    model_cfg, train_cfg, decode_cfg = build_configs(args, tokenizer)
    decode_cfg = replace(decode_cfg, beam_size=args.beam_size)

    # the system's model: f32 parameters that hold the checkpoint's values,
    # bf16 compute
    system = ASRSystem(model_cfg, train_cfg, device=args.device)
    load_weights(system.model, args.load, strict=not args.no_strict)

    data_dir = args.test_data[0]
    ds = AlignedDataset(
        data_dir, tokenizer,
        num_utterances=1,
        min_segment_duration=3,
        max_segment_duration=args.max_secs,
        speaker_map_loc=os.path.join(data_dir, "speaker_map.json"),
        tokenizer_speakers=args.num_speakers > 0,
        return_spk_ids=True,
    )
    runner = EvalRunner(system.model, tokenizer, decode_cfg, out_dir=args.out_dir,
                        device=args.device)
    loader = DataLoader(
        ds, args.val_batch_size or args.batch_size, BucketedCollater(tokenizer.pad_token_id),
        ShardedSampler(len(ds), shuffle=False), args.num_workers, drop_last=False,
    )
    steps = []
    for batch in loader:
        idxs = batch["idx"]
        refs = [ds.index[int(i)][1] for i in idxs]
        steps.append(dict(runner.test_step_aligned(batch, refs), idx=idxs))
    result = runner.test_end()
    print(result)
    return dict(result, runner=runner, steps=steps)


if __name__ == "__main__":
    main()
