"""Speaker-embedding export CLI.

    python -m tal_asrd_tpu_torch.cli.gen_embed --train-data D --valid-data D \
        --tokenizer accuracy_release/bpe.model --model-type 1x --num-speakers 8 \
        --load CKPT --out-path OUT/spk [--num-workers 0] [--device cpu]

Counterpart of tal_asrd_tpu/cli/gen_embed.py: the eval CLI's flags plus
--out-path. Builds the system's model (f32 parameters, bf16 compute) on
--device (default cuda), loads --load through the partial load
(--no-strict keeps the leaves the checkpoint lacks), cuts the first
--train-data split into single utterances of 3 s to --max-secs, batched in
order (--val-batch-size or --batch-size, the last batch short), and writes
the expected speaker embedding of every speaker-token position to
OUT.train.pkl and OUT.valid.pkl (80/20, in order; eval/gen_embed.py).
Batch membership matters: the frontend subtracts one mean over each
batch's real frames, so the batches are the JAX CLI's.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

import numpy as np

from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
from tal_asrd_tpu_torch.core.checkpoint import load_params_partial, load_pytree
from tal_asrd_tpu_torch.data.aligned import AlignedDataset
from tal_asrd_tpu_torch.data.collate import BucketedCollater
from tal_asrd_tpu_torch.data.loader import DataLoader, ShardedSampler
from tal_asrd_tpu_torch.eval.gen_embed import generate_speaker_embeddings, save_split
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
from tal_asrd_tpu_torch.train.system import ASRSystem


def main(argv: Optional[List[str]] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Run the export; returns (embeddings, speaker_ids) as saved."""
    p = get_argparser()
    p.add_argument("--out-path", type=str, required=True)
    args = p.parse_args(argv)
    if not args.load:
        sys.exit("Specify path to weights.")

    tokenizer = BpeTokenizer(model_path=args.tokenizer)
    model_cfg, train_cfg, _ = build_configs(args, tokenizer)
    system = ASRSystem(model_cfg, train_cfg, device=args.device)

    data_dir = args.train_data[0]
    ds = AlignedDataset(
        data_dir, tokenizer, num_utterances=1,
        max_segment_duration=args.max_secs,
        speaker_map_loc=os.path.join(data_dir, "speaker_map.json")
        if args.num_speakers > 0 else None,
        tokenizer_speakers=args.num_speakers > 0,
        return_spk_ids=True,
    )
    loader = DataLoader(ds, args.val_batch_size or args.batch_size,
                        BucketedCollater(tokenizer.pad_token_id),
                        ShardedSampler(len(ds), shuffle=False), args.num_workers,
                        drop_last=False)

    system.load_params(load_params_partial(system.params_spec(), load_pytree(args.load),
                                           strict=not args.no_strict))
    embs, sids = generate_speaker_embeddings(system.model, loader)
    print("Generated embeddings", embs.shape, sids.shape)
    save_split(embs, sids, args.out_path)
    print("Done.")
    return embs, sids


if __name__ == "__main__":
    main()
