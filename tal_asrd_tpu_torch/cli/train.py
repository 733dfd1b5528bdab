"""ASR training CLI.

    python -m tal_asrd_tpu_torch.cli.train --train-data DIR --valid-data DIR \
        --tokenizer bpe.model --model-type 1x --name run1 [--num-speakers N] \
        [--load CKPT] [--shiftaug | --alignaug] [--device cpu]
    torchrun --nproc-per-node N -m tal_asrd_tpu_torch.cli.train ... \
        --mesh-data D --mesh-model M        # D x M = N processes, one a card

Counterpart of tal_asrd_tpu/cli/train.py, with the same flags (plus
`--device`, default cuda): aligned datasets (one per
`--num-utterances` value) plus, with --shiftaug / --alignaug, the
shift-augmented `SegmentDataset` windows (validation also on windows fixed
by det_seed 1234); the partial loads --load (strict unless --no-strict),
--load-encoder (the encoder subtree) and --load-decoder (not strict, the
speaker-token rows grown); the step counter restored when --load names one
of this run's own checkpoints; then `Trainer.fit` with per-epoch
checkpoints, early stopping and the generation spot check after each
validation.

Randomness follows the reference: `set_seed(42)` seeds Python's and numpy's
generators, from which the sampler's shuffle and the segment windows are
drawn (with --num-workers 0 in the reference's order), and PyTorch's
(dropout), and gives the CPU generator of the initial weights. --spk-weight > 0 trains the separate
speaker head beside the decoder (its loss weighted by the flag; the data
then carries no speaker tokens).

Under torchrun (or in a process group the caller made) the CLI trains on a
('data', 'model') mesh of --mesh-data x --mesh-model processes
(parallel/mesh.py; -1 data: every process not on the model axis), NCCL on
CUDA, gloo on the CPU. As the JAX CLI does, every process builds the same
loader order, collates --batch-size rows a step as the global batch and
keeps its rows; the learning rate scales by the square root of
(data axis) x --batch-size x --grad-acc (TrainConfig.num_data_shards is
the data axis's size); only process 0 logs and writes the checkpoints
(the gathered full trees). Without a process group the mesh must be one
process; a --batch-size that --grad-acc x the data axis does not divide is
refused.
"""
from __future__ import annotations

import dataclasses
import os
import re
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch.distributed as dist

from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
from tal_asrd_tpu_torch.core.checkpoint import (
    filter_subtree,
    load_params_partial,
    load_pytree,
    merge_subtree,
    tree_leaves,
)
from tal_asrd_tpu_torch.core.config import SpecAugmentConfig
from tal_asrd_tpu_torch.core.utils import count_parameters, set_seed
from tal_asrd_tpu_torch.data.aligned import AlignedDataset
from tal_asrd_tpu_torch.data.collate import BucketedCollater
from tal_asrd_tpu_torch.data.loader import DataLoader, ShardedSampler
from tal_asrd_tpu_torch.data.segment import SegmentDataset
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
from tal_asrd_tpu_torch.train.loop import Trainer, TrainerConfig
from tal_asrd_tpu_torch.train.system import ASRSystem
from tal_asrd_tpu_torch.utils.logging import MetricsLogger



class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, i):
        di = int(np.searchsorted(self.offsets, i, side="right")) - 1
        return self.datasets[di][i - int(self.offsets[di])]


def build_datasets(args, tokenizer):
    """(train, valid) ConcatDatasets: per split directory one AlignedDataset
    per --num-utterances value, plus a SegmentDataset with --shiftaug /
    --alignaug (random windows for training; for validation windows fixed
    by det_seed 1234, the same every epoch)."""
    tokenizer_speakers = args.num_speakers > 0 and args.spk_weight == 0
    n_utts = [int(v) for v in str(args.num_utterances).split(",")]

    def aligned(p, n_utt):
        return AlignedDataset(
            p, tokenizer, num_utterances=n_utt, max_segment_duration=args.max_secs,
            speaker_map_loc=os.path.join(p, "speaker_map.json"),
            tokenizer_speakers=tokenizer_speakers, return_spk_ids=True,
            cache_items=args.cache_items)

    def segments(p, det_seed=None):
        return SegmentDataset(
            p, tokenizer, segment_size=args.max_secs,
            speaker_map_loc=os.path.join(p, "speaker_map.json"),
            tokenizer_speakers=tokenizer_speakers,
            aligned_truncation=args.alignaug, return_spk_ids=not args.alignaug,
            det_seed=det_seed)

    windows = args.shiftaug or args.alignaug
    train_parts = []
    for p in args.train_data:
        train_parts += [aligned(p, n_utt) for n_utt in n_utts]
        if windows:
            train_parts.append(segments(p))
    valid_parts = [aligned(p, n_utt) for p in args.valid_data for n_utt in n_utts]
    if windows:
        valid_parts += [segments(p, det_seed=1234) for p in args.valid_data]
    return ConcatDataset(train_parts), ConcatDataset(valid_parts)


def maybe_restore_step(args, system: ASRSystem) -> int:
    """When --load names one of this run's own epoch checkpoints
    (<checkpoint-path>/<name>/ckpt_<N>.msgpack: a retry after a crash), set
    the system's step counter to N, so checkpoint numbering and --max-steps
    continue where the run stopped. The optimizer state is not restored:
    the learning-rate schedule counts its own updates from 0, as the
    reference's does after a parameters-only load. Other loads (a phase
    hand-off, a warm start) and --no-restore-step keep step 0. Returns the
    step."""
    if not args.load or args.no_restore_step:
        return system.step
    m = re.match(r"ckpt_(\d+)\.msgpack$", os.path.basename(args.load))
    own_dir = os.path.abspath(os.path.join(args.checkpoint_path, args.name))
    if m and os.path.dirname(os.path.abspath(args.load)) == own_dir:
        system.step = int(m.group(1))
        print(f"[train] restored step counter to {system.step} (same-run warm start)")
    return system.step


def load_weights(args, system: ASRSystem, num_tokens: int) -> None:
    """--load, --load-encoder, --load-decoder, in that order, each on the
    parameter tree's names (`params_spec`), so a later one overrides."""
    if args.load:
        system.load_params(load_params_partial(
            system.params_spec(), load_pytree(args.load), strict=not args.no_strict))
    if args.load_encoder:
        donor = load_pytree(args.load_encoder)
        system.load_params(merge_subtree(system.params_spec(), "encoder",
                                         filter_subtree(donor, "encoder")))
    if args.load_decoder:
        system.load_params(load_params_partial(
            system.params_spec(), load_pytree(args.load_decoder), strict=False,
            expand_embeddings_to=num_tokens))


def make_cli_mesh(args):
    """(mesh or None, device, data axis size): the mesh of --mesh-data x
    --mesh-model over the process group (torchrun's, or the caller's);
    without one, a mesh of one process, or exit naming torchrun."""
    from tal_asrd_tpu_torch.parallel.mesh import _resolve, init_distributed, layout_of, make_mesh
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        device = init_distributed(args.device)
        mesh = make_mesh(args.mesh_data, args.mesh_model, device_type=device.type)
        return mesh, device, layout_of(mesh).data_size
    try:
        _resolve(1, (args.mesh_data, args.mesh_model))
    except ValueError as e:
        sys.exit(f"tal_asrd_tpu_torch.cli.train: {e} (no process group): launch a mesh with "
                 f"torchrun --nproc-per-node N")
    return None, args.device, 1


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train. Returns {"system", "trainer", "metrics_path"} (metrics_path
    None on a process other than 0 of a mesh)."""
    args = get_argparser(is_train=True).parse_args(argv)
    mesh, device, data = make_cli_mesh(args)
    if args.batch_size % (args.grad_acc * data):
        sys.exit(f"tal_asrd_tpu_torch.cli.train: --batch-size {args.batch_size} does not split "
                 f"into --grad-acc {args.grad_acc} micro-batches over a data axis of {data}")
    lead = mesh is None or dist.get_rank() == 0
    generator = set_seed(42)

    tokenizer = BpeTokenizer(model_path=args.tokenizer if os.path.exists(args.tokenizer)
                             else os.path.join(args.cache_path, "tokenizer", args.tokenizer))
    model_cfg, train_cfg, _ = build_configs(args, tokenizer)
    train_cfg = dataclasses.replace(train_cfg, num_data_shards=data)
    specaug = (SpecAugmentConfig(num_freq_masks=0, num_time_masks=0)
               if args.no_specaug else SpecAugmentConfig())
    system = ASRSystem(model_cfg, train_cfg, specaug_cfg=specaug, device=device,
                       generator=generator, mesh=mesh)

    train_ds, valid_ds = build_datasets(args, tokenizer)
    coll = BucketedCollater(tokenizer.pad_token_id, audio_int16=args.audio_int16)
    train_loader = DataLoader(train_ds, args.batch_size, coll,
                              ShardedSampler(len(train_ds), shuffle=True), args.num_workers)
    val_loader = DataLoader(valid_ds, args.val_batch_size or args.batch_size, coll,
                            ShardedSampler(len(valid_ds), shuffle=False), args.num_workers)
    batch0 = next(iter(val_loader))
    if lead:
        n = (count_parameters(system.model) if system.shards is None else
             sum(int(np.prod(s.shape)) for _, s in tree_leaves(system.params_spec())))
        print(f"Trainable params: {n:,}")

    load_weights(args, system, model_cfg.num_tokens)
    maybe_restore_step(args, system)

    logger = (MetricsLogger(out_dir=args.out_dir, name=args.name, project=args.project,
                            config=vars(args)) if lead else None)
    trainer = Trainer(
        system,
        TrainerConfig(
            max_epochs=args.max_epochs,
            max_steps=args.max_steps,
            early_stop_patience=args.patience,
            quick_test=args.quick_test,
            overfit_pct=args.overfit_pct,
            val_check_interval=args.val_check_interval,
            checkpoint_dir=os.path.join(args.checkpoint_path, args.name),
            ckpt_every=args.ckpt_every,
            state_ckpt=args.state_ckpt,
        ),
        logger=logger,
        generation_hook=system.make_generation_spotcheck(tokenizer, batch0),
    )
    trainer.fit(train_loader, val_loader)
    if logger is None:
        return {"system": system, "trainer": trainer, "metrics_path": None}
    logger.close()
    return {"system": system, "trainer": trainer, "metrics_path": logger.path}


if __name__ == "__main__":
    main()
