"""Shallow-fusion LM training CLI.

    python -m tal_asrd_tpu_torch.cli.train_lm --train-data D --valid-data D \
        --tokenizer accuracy_release/bpe.model --name lm \
        --hidden-size 512 --layers 6 --attn-heads 4 --max-len 512 \
        [--checkpoint-path models/lm] [--device cpu]

Counterpart of tal_asrd_tpu/cli/train_lm.py, with its flags (plus
--device, default cuda): the LM trains on the utterance texts of the train
split's transcript.pkl. An epoch is min(--epoch-len, rows // batch) Adam
steps over `batch_iterator(seed=epoch)`, then the validation perplexity is
printed and the parameters are saved as CHECKPOINT_PATH/NAME/ckpt_<step>
(flax msgpack, latest.json holding the perplexity); the run stops after
--max-epochs or once --max-steps is reached (--quick-test: one epoch of two
steps). As in the reference, --load is parsed and not read, and the default
shape (hidden 768, 4 layers) is not the one the eval CLI loads (512, 6
layers): pass the flags above for an LM that `cli.test --lm-path` takes.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

from tal_asrd_tpu_torch.cli.args import get_lm_argparser
from tal_asrd_tpu_torch.core.checkpoint import CheckpointManager
from tal_asrd_tpu_torch.core.config import LMConfig
from tal_asrd_tpu_torch.data.transcript import load_transcripts
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
from tal_asrd_tpu_torch.train.lm_system import LMSystem, LMTextDataset, batch_iterator


def transcript_texts(data_dir: str) -> List[str]:
    texts = []
    for utts in load_transcripts(data_dir).values():
        texts.extend(u["utterance"] for u in utts)
    return texts


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train; returns {"system": the LMSystem, "epochs": [{"epoch", "step",
    "losses", "ppl", "path"}, ...]}."""
    args = get_lm_argparser().parse_args(argv)
    tokenizer = BpeTokenizer(model_path=args.tokenizer)
    cfg = LMConfig(vocab_size=len(tokenizer), hidden_size=args.hidden_size,
                   n_head=args.attn_heads, n_layers=args.layers,
                   max_positions=args.max_len)
    system = LMSystem(cfg, lr=args.lr, batch_size=args.batch_size, device=args.device)

    train_ds = LMTextDataset(transcript_texts(args.train_data), tokenizer, args.max_len)
    valid_ds = LMTextDataset(transcript_texts(args.valid_data), tokenizer, args.max_len)

    mgr = CheckpointManager(os.path.join(args.checkpoint_path, args.name))
    epochs = 1 if args.quick_test else args.max_epochs
    steps_per_epoch = 2 if args.quick_test else args.epoch_len
    step = 0
    records = []
    for epoch in range(epochs):
        losses = system.fit(batch_iterator(train_ds, args.batch_size, seed=epoch),
                            steps=steps_per_epoch)
        step += len(losses)
        ppl = system.perplexity(batch_iterator(valid_ds, args.batch_size))
        print(f"epoch {epoch}: loss {losses[-1]:.4f} valid ppl {ppl:.2f}")
        path = mgr.save(step, system.params(), extra={"ppl": ppl})
        records.append({"epoch": epoch, "step": step, "losses": losses, "ppl": ppl,
                        "path": path})
        if args.max_steps and step >= args.max_steps:
            break
    return {"system": system, "epochs": records}


if __name__ == "__main__":
    main()
