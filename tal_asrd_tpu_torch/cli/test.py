"""ASR evaluation CLI (aligned and unaligned).

    python -m tal_asrd_tpu_torch.cli.test --train-data D --valid-data D --test-data D \
        --tokenizer accuracy_release/bpe.model --model-type 1x --num-speakers 8 \
        --load accuracy_release/avg_last_3.bf16.msgpack --out-dir OUT [--fused-decode] \
        [--unaligned [--vad-windows]] [--bf16-params] [--lm-path LM --lm-weight W] \
        [--device cpu]

Counterpart of tal_asrd_tpu/cli/test.py: builds the system's model (f32
parameters, bf16 compute; bf16 parameters under --bf16-params), loads the
checkpoint through the port's msgpack reader and converter, and runs the
test split through EvalRunner, everything on --device (default cuda):

  * aligned (the default): the split segmented into single utterances of
    3 s to --max-secs, batched in order (no shuffle, the last batch short),
    teacher-forced loss + beam generation;
  * --unaligned: whole episodes; episodes of equal length form a group,
    encoded together and decoded in groups of up to --unaligned-lanes
    through the sliding-window state machine;
  * --unaligned --vad-windows: each episode alone, through VAD-gated
    windows decoded by the aligned beam search.

With --lm-path and --lm-weight > 0, every leg fuses the LM checkpoint (a
flax msgpack tree, as cli/train_lm.py writes it) at that weight; the LM is
built at LMConfig's shape (hidden 512, 4 heads, 6 layers, 512 positions)
over the tokenizer's vocabulary and stays f32 under --bf16-params. With
only one of the two flags the run decodes without an LM, as the
reference's does.

With --spk-weight > 0 the model carries the separate speaker head and no
speaker tokens (the test split is tokenized without them): the aligned
leg writes each utterance's rows of the head's logits as `speakerLogits`,
and decodes through the model itself even under --fused-decode (the fused
decoder covers the speaker-token mode only), as the reference's does.

Writes OUT/test_result.pkl, hyp.txt and ref.txt and prints the mean test
loss.
"""
from __future__ import annotations

import os
import sys
from dataclasses import replace
from typing import Dict, List, Optional

import torch

from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
from tal_asrd_tpu_torch.core.checkpoint import load_pytree
from tal_asrd_tpu_torch.core.config import LMConfig
from tal_asrd_tpu_torch.core.convert import load_into, params_to_state_dict
from tal_asrd_tpu_torch.data.aligned import AlignedDataset
from tal_asrd_tpu_torch.data.audio_io import load_audio_segment
from tal_asrd_tpu_torch.data.collate import BucketedCollater
from tal_asrd_tpu_torch.data.loader import DataLoader, ShardedSampler
from tal_asrd_tpu_torch.eval.runner import EvalRunner
from tal_asrd_tpu_torch.models.asr import ASRModel
from tal_asrd_tpu_torch.models.lm import DecoderLMModel
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
from tal_asrd_tpu_torch.train.system import ASRSystem


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


def cast_parameters_to_bf16(model: ASRModel) -> None:
    """--bf16-params: every f32 parameter becomes bf16 (the reference casts
    its f32 parameter leaves), so the decode loops read half the weight
    bytes. The model computes in bf16 either way; the tracked checkpoint's
    values are bf16 already, so its results do not change."""
    for p in model.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the evaluation. Returns {"test_loss", "runner", "steps"}: the
    EvalRunner (its model, its outputs) and what each test step returned
    (aligned: per batch, with its dataset indices; unaligned: per episode,
    with its dataset index)."""
    args = get_argparser().parse_args(argv)
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
    if args.bf16_params:
        cast_parameters_to_bf16(system.model)

    data_dir = args.test_data[0]
    ds = AlignedDataset(
        data_dir, tokenizer,
        num_utterances=None if args.unaligned else 1,
        min_segment_duration=None if args.unaligned else 3,
        max_segment_duration=None if args.unaligned else args.max_secs,
        speaker_map_loc=os.path.join(data_dir, "speaker_map.json"),
        tokenizer_speakers=args.num_speakers > 0 and args.spk_weight == 0,
        return_spk_ids=True,
    )
    lm = None
    if args.lm_path and args.lm_weight > 0:
        lm = load_into(DecoderLMModel(LMConfig(vocab_size=len(tokenizer)), device=args.device),
                       load_pytree(args.lm_path))
    runner = EvalRunner(system.model, tokenizer, decode_cfg, out_dir=args.out_dir,
                        device=args.device, lm=lm, spk_weight=args.spk_weight)
    steps = unaligned(args, ds, runner, data_dir) if args.unaligned else aligned(args, ds, runner)
    result = runner.test_end()
    print(result)
    return dict(result, runner=runner, steps=steps)


def aligned(args, ds, runner) -> List[Dict]:
    loader = DataLoader(
        ds, args.val_batch_size or args.batch_size, BucketedCollater(runner.tokenizer.pad_token_id),
        ShardedSampler(len(ds), shuffle=False), args.num_workers, drop_last=False,
    )
    steps = []
    for batch in loader:
        idxs = batch["idx"]
        refs = [ds.index[int(i)][1] for i in idxs]
        steps.append(dict(runner.test_step_aligned(batch, refs), idx=idxs))
    return steps


def unaligned(args, ds, runner, data_dir) -> List[Dict]:
    """Whole episodes, grouped by exact audio length (only equal lengths
    share an encode: padding would move the encoder's boundary). Each group
    goes through the state machine in parts of --unaligned-lanes, or, with
    --vad-windows, episode by episode through VAD windows."""
    lanes = max(1, args.unaligned_lanes)
    groups: Dict[int, List] = {}
    for i in range(len(ds)):
        stub, utts = ds.index[i]
        wav = load_audio_segment(os.path.join(data_dir, f"{stub}.wav"), 0.0, None)
        groups.setdefault(len(wav), []).append((i, wav, utts))
    steps = []
    for wav_len, items in groups.items():
        if args.vad_windows:
            for i, wav, utts in items:
                info = runner.test_step_unaligned_vad(wav, wav_len, utts,
                                                      max_window_s=args.vad_max_window)
                print("vad-windows:", {k: info[k] for k in (
                    "num_tokens", "num_utterances", "num_windows")})
                steps.append(dict(info, idx=i))
            continue
        for j in range(0, len(items), lanes):
            part = items[j:j + lanes]
            if len(part) == 1:
                infos = [runner.test_step_unaligned(part[0][1], wav_len, part[0][2])]
            else:
                infos = runner.test_step_unaligned_batched(
                    [w for _, w, _ in part], wav_len, [u for _, _, u in part])
            steps += [dict(info, idx=i) for info, (i, _, _) in zip(infos, part)]
    return steps


if __name__ == "__main__":
    main()
