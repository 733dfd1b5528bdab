#!/usr/bin/env python3
"""The reference figures of the training CLI, from the JAX package on the CPU.

    python3 scripts/torch_train_reference.py [--sections load_parity,tiny_cli]

Writes tests/fixtures/torch_train_cli_reference.json (and, for the tiny
runs' checkpoints, tests/fixtures/torch_train_cli_reference_ckpts.npz), one
section per run below, each in its own process with JAX_PLATFORMS=cpu:

load_parity: the validation loss of the tracked checkpoint
(accuracy_release/avg_last_3.bf16.msgpack) at the full width of the 1x
model in bf16 compute, through the JAX CLI's own `build_datasets`,
`BucketedCollater` and `DataLoader` and the system's `eval_step`, over the
valid split of scripts/ensure_corpus.sh cut to 2 episodes (seed 101,
120 s, 8 speakers), at the flags of scripts/accuracy.sh's last phase:

    --model-type 1x --num-speakers 8 --batch-size 16 --max-secs 28.5
    --num-workers 0 --shiftaug --cache-items --audio-int16

tiny_cli: two runs of `python -m tal_asrd_tpu.cli.train` with TAL_TINY_ARCH
set on a tiny synthetic corpus (train: 2 episodes of 40 s, seed 0; valid: 1
of 40 s, seed 101; 8 speakers), from a seeded initial checkpoint
(tests/test_torch_helpers.py `seeded_params`, seed 11, ReZero scalars 0.1;
at 0.4 the run is chaotic: a relative change of 1e-7 in the initial weights
moves the step-8 validation loss by 3e-4 in either package, so 1e-4 parity
is out of reach there; at 0.1 the same change moves it by 7e-7): run 1 for 2 epochs
(--shiftaug --audio-int16 --cache-items --no-specaug, batch 4, --max-secs
12), run 2 from run 1's last checkpoint in the same run directory (the
step counter restored) to --max-steps 12. The CLI is patched at run time,
in the child process only, to compute in f32 with dropout 0 and token
replacement 0 and to log every step (`TrainerConfig.log_every=1`); the
JAX files are not touched. The section holds each run's arguments (paths
as placeholders), its per-step losses, its validation losses, its
spot-check texts, the names of its checkpoints and, for each state
file, its step and its optimizer's update count; the .npz holds each
checkpoint's leaves as float16 differences from the initial tree (the
largest rounding error of that storage is in the section).

The committed fixture was made on an 8-core x86 CPU (no accelerator); the
seconds of each section are in it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_train_cli_reference.json")
CKPTS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_train_cli_reference_ckpts.npz")
CHECKPOINT = "accuracy_release/avg_last_3.bf16.msgpack"
TOKENIZER = "accuracy_release/bpe.model"

# load parity: scripts/ensure_corpus.sh's valid split, cut to 2 episodes
LOAD_SPLIT = dict(n_episodes=2, episode_seconds=120.0, n_speakers=8, seed=101)
LOAD_ARGV = ["--train-data", "VALID", "--valid-data", "VALID", "--tokenizer", TOKENIZER,
             "--model-type", "1x", "--num-speakers", "8", "--batch-size", "16",
             "--max-secs", "28.5", "--num-workers", "0", "--shiftaug", "--cache-items",
             "--audio-int16", "--load", CHECKPOINT, "--name", "load_parity"]

# the tiny CLI runs
TINY_SPLITS = {"train": dict(n_episodes=2, episode_seconds=40.0, n_speakers=8, seed=0),
               "valid": dict(n_episodes=1, episode_seconds=40.0, n_speakers=8, seed=101)}
TINY_INIT_SEED = 11
TINY_SCALARS = 0.1       # the ReZero scalars of the initial tree
TINY_COMMON = ["--train-data", "TRAIN", "--valid-data", "VALID", "--tokenizer", TOKENIZER,
               "--model-type", "1x", "--num-speakers", "8", "--batch-size", "4",
               "--max-secs", "12", "--num-workers", "0", "--max-epochs", "2",
               "--no-specaug", "--shiftaug", "--cache-items", "--audio-int16",
               "--ckpt-every", "1", "--name", "tiny", "--checkpoint-path", "CKPTS",
               "--out-dir", "OUT"]
TINY_RUNS = {"run1": TINY_COMMON + ["--load", "INIT"],
             "run2": TINY_COMMON + ["--load", "CKPTS/tiny/ckpt_00000008.msgpack",
                                    "--max-steps", "12"]}

# Runs in the child: the JAX CLI, patched in this process only
TINY_CHILD = r"""
import functools, sys
from dataclasses import replace
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from tal_asrd_tpu.cli import train as cli_train

orig_build = cli_train.build_configs
def build_configs(args, tokenizer=None):
    model_cfg, train_cfg, decode_cfg = orig_build(args, tokenizer)
    return (replace(model_cfg, dropout=0.0, tds_dropout=0.0, conv_impl="xla"),
            replace(train_cfg, token_replace_prob=0.0), decode_cfg)
cli_train.build_configs = build_configs
cli_train.ASRSystem = functools.partial(cli_train.ASRSystem, dtype=jnp.float32)
cli_train.TrainerConfig = functools.partial(cli_train.TrainerConfig, log_every=1)
cli_train.main(sys.argv[1:])
"""

LOAD_CHILD = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from tal_asrd_tpu.cli.args import build_configs, get_argparser
from tal_asrd_tpu.cli.train import build_datasets
from tal_asrd_tpu.core.checkpoint import load_params_partial, load_pytree
from tal_asrd_tpu.core.config import SpecAugmentConfig
from tal_asrd_tpu.core.utils import set_seed
from tal_asrd_tpu.data import BucketedCollater, DataLoader, ShardedSampler
from tal_asrd_tpu.text import BpeTokenizer
from tal_asrd_tpu.train import ASRSystem

args = get_argparser(is_train=True).parse_args(sys.argv[2:])
rng = set_seed(42)
tok = BpeTokenizer(model_path=args.tokenizer)
model_cfg, train_cfg, _ = build_configs(args, tok)
system = ASRSystem(model_cfg, train_cfg,
                   specaug_cfg=SpecAugmentConfig(num_freq_masks=0, num_time_masks=0))
_, valid = build_datasets(args, tok)
loader = DataLoader(valid, args.val_batch_size or args.batch_size,
                    BucketedCollater(tok.pad_token_id, audio_int16=args.audio_int16),
                    ShardedSampler(len(valid), shuffle=False), args.num_workers)
batches = list(loader)
state = system.init_state(rng, batches[0])
state = state.replace(params=load_params_partial(state.params, load_pytree(args.load)))
eval_step = system.make_eval_step()
losses = [float(eval_step(state, b)["loss"]) for b in batches]
with open(sys.argv[1], "w") as f:
    json.dump({"batch_losses": losses, "val_loss": float(np.mean(losses)),
               "n_items": len(valid),
               "audio_shapes": [list(b["audio"].shape) for b in batches],
               "text_shapes": [list(b["text"].shape) for b in batches],
               "idx": [b["idx"].tolist() for b in batches]}, f)
"""


def run(cmd, env):
    print("+", " ".join("<child>" if c in (TINY_CHILD, LOAD_CHILD) else c for c in cmd),
          flush=True)
    subprocess.run(cmd, check=True, cwd=ROOT, env=env)


def fill(argv, paths):
    out = []
    for a in argv:
        for key, path in paths.items():
            if a == key or a.startswith(key + "/"):
                a = path + a[len(key):]
        out.append(a)
    return out


def load_parity(tmp, env):
    from tal_asrd_tpu.data.synth import build_synth_corpus
    valid = os.path.join(tmp, "valid")
    build_synth_corpus(valid, **LOAD_SPLIT)
    rec_path = os.path.join(tmp, "load_parity.json")
    run([sys.executable, "-c", LOAD_CHILD, rec_path] + fill(LOAD_ARGV, {"VALID": valid}), env)
    with open(rec_path) as f:
        rec = json.load(f)
    return dict(rec, split=dict(LOAD_SPLIT, made_by="tal_asrd_tpu.data.synth.build_synth_corpus"),
                argv=LOAD_ARGV, checkpoint=CHECKPOINT, compute_dtype="bfloat16")


def tiny_cli(tmp, env):
    from tal_asrd_tpu.core.checkpoint import load_pytree, save_pytree
    from tal_asrd_tpu.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
    from tal_asrd_tpu_torch.core.convert import params_spec
    from tal_asrd_tpu_torch.models.asr import ASRModel
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
    from tests.test_torch_helpers import seeded_params

    paths = {k: os.path.join(tmp, k.lower()) for k in ("TRAIN", "VALID", "CKPTS", "OUT")}
    paths["INIT"] = os.path.join(tmp, "init.msgpack")
    for name, split in TINY_SPLITS.items():
        build_synth_corpus(paths[name.upper()], **split)
    # the initial tree: seeded numbers in the shapes of the tiny model
    os.environ["TAL_TINY_ARCH"] = "1"
    args = get_argparser(is_train=True).parse_args(fill(TINY_RUNS["run1"], paths))
    model_cfg = build_configs(args, BpeTokenizer(model_path=TOKENIZER))[0]
    spec = params_spec(ASRModel(model_cfg, device="cpu"))
    init = seeded_params(spec, TINY_INIT_SEED, scalar_bump=TINY_SCALARS)
    save_pytree(paths["INIT"], init)

    env = dict(env, TAL_TINY_ARCH="1")
    section = {"splits": {k: dict(v, made_by="tal_asrd_tpu.data.synth.build_synth_corpus")
                          for k, v in TINY_SPLITS.items()},
               "init_seed": TINY_INIT_SEED, "init_scalars": TINY_SCALARS, "runs": {}}
    deltas, worst = {}, 0.0
    metrics = os.path.join(paths["OUT"], "tiny.metrics.jsonl")
    for run_name, argv in TINY_RUNS.items():
        seen = os.path.getsize(metrics) if os.path.exists(metrics) else 0
        ckpt_dir = os.path.join(paths["CKPTS"], "tiny")
        before = set(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else set()
        run([sys.executable, "-c", TINY_CHILD] + fill(argv, paths), env)
        with open(metrics) as f:
            f.seek(seen)
            recs = [json.loads(line) for line in f if line.strip()]
        new = sorted(set(os.listdir(ckpt_dir)) - before)
        section["runs"][run_name] = {
            "argv": argv,
            "step_losses": [[r["step"], r["loss"]] for r in recs if "loss" in r],
            "val_losses": [[r["step"], r["val_loss"]] for r in recs if "val_loss" in r],
            "generations": [[r["step"], r["ref"], r["hyp"]] for r in recs
                            if r.get("type") == "generation"],
            "checkpoints": [n for n in new if n.startswith("ckpt_")],
            "states": [n for n in new if n.startswith("state_")],
        }
        counts = []
        for name in section["runs"][run_name]["states"]:
            state = load_pytree(os.path.join(ckpt_dir, name))
            n = {int(np.asarray(v)) for p, v in _flat(state["opt_state"])
                 if p.split("/")[-1] == "count"}
            if len(n) != 1:
                raise SystemExit(f"{name}: optimizer counts {n}")
            counts.append([int(np.asarray(state["step"])), n.pop()])
        section["runs"][run_name]["state_counts"] = counts
        for name in section["runs"][run_name]["checkpoints"]:
            tree = load_pytree(os.path.join(ckpt_dir, name))
            for path, value in _flat(tree):
                d = np.asarray(value, np.float32) - _get(init, path)
                stored = d.astype(np.float16)
                worst = max(worst, float(np.abs(stored.astype(np.float32) - d).max(initial=0)))
                deltas[f"{name}:{path}"] = stored
    section["float16_storage_max_abs_err"] = worst
    return section, deltas


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


def _get(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return np.asarray(tree, np.float32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default="load_parity,tiny_cli")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    fixture = {}
    if os.path.exists(FIXTURE):
        with open(FIXTURE) as f:
            fixture = json.load(f)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    fixture.update(what="JAX CPU reference of the training CLI "
                        "(scripts/torch_train_reference.py)", tokenizer=TOKENIZER)
    for name in args.sections.split(","):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            if name == "load_parity":
                fixture[name] = load_parity(tmp, env)
            elif name == "tiny_cli":
                fixture[name], deltas = tiny_cli(tmp, env)
                np.savez_compressed(CKPTS_NPZ, **deltas)
            else:
                raise SystemExit(f"unknown section {name}")
        fixture[name].update(commit=commit, seconds=time.perf_counter() - t0)
        print(json.dumps({name: {k: v for k, v in fixture[name].items()
                                 if k in ("val_loss", "seconds", "float16_storage_max_abs_err")}}))
    with open(FIXTURE, "w") as f:
        json.dump(fixture, f, indent=1)
        f.write("\n")
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
