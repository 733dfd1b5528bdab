#!/usr/bin/env python3
"""The reference figures of the separate speaker head, from the JAX package on the CPU.

    python3 scripts/torch_spk_reference.py [--sections tiny_cli,seeded_eval,seeded_train]

Writes tests/fixtures/torch_spk_reference.json and, for the arrays,
tests/fixtures/torch_spk_reference_arrays.npz. Each JAX step runs in its own
process with JAX_PLATFORMS=cpu:

  (a) tiny_cli: `python -m tal_asrd_tpu.cli.train` at TAL_TINY_ARCH with
      `--spk-weight 0.5 --num-speakers 8` on the tiny corpus of
      scripts/torch_train_reference.py (batch 4, 12 s windows, 2 epochs
      without SpecAugment), from a seeded initial tree
      (tests/test_torch_helpers.py `seeded_params`, seed 11, ReZero scalars
      0.1), patched in the child to compute in f32 with dropout 0 and token
      replacement 0 and to log every step. It records each step's loss,
      lm_loss and spk_loss, each validation's (the means over its batches),
      the spot checks, and the last checkpoint's leaves as float16
      differences from the initial tree ("tiny_cli/<leaf path>").
  (b) seeded_eval: `python -m tal_asrd_tpu.cli.test` aligned on the
      synthetic test split (seed 202, 4 x 180 s, 8 speakers, as
      scripts/ensure_corpus.sh makes it) with `--model-type 1x
      --num-speakers 8 --spk-weight 0.5 --load TREE`, TREE the tracked
      checkpoint's text weights with a seeded head (`seeded_spk_tree`), in
      f32 (scripts/torch_lm_reference.py's F32_PATCH) and in bf16 as the
      CLI runs. Each run records WER / WDER (`cli.tools wder-format` +
      `cli.wder`), the test loss, every segment's hypothesis tokens (prime
      and EOS included) and every `speakerLogits` array of
      test_result.pkl, stored as bfloat16 bits (the track is bf16) under
      "seeded_eval/<run>/<segment>/<utterance>".
  (c) seeded_train: `python -m tal_asrd_tpu.cli.train` from TREE at the
      flags of chip_smoke.py's train_cli_1x (batch 16, --max-secs 28.5,
      --shiftaug --cache-items --audio-int16, lr 2e-4) with `--spk-weight
      0.5`, 2 epochs without SpecAugment, on scripts/ensure_corpus.sh's
      train and valid splits cut to 8 and 2 episodes, patched in the child
      to train in f32 without dropout and token replacement. Dropout and
      the replacement draw from each package's own random stream; and in
      bf16 XLA's CPU backend sums a bf16 reduction in bf16, so the JAX
      CLI's gradients of the ReZero scalars and biases saturate at this
      width (ROADMAP C18): the two bf16 runs' validation losses part by
      several percent after 15 steps. It records each validation's loss,
      lm_loss and spk_loss.

`seeded_spk_tree` needs numpy alone, so a machine without JAX (the card's,
chip_smoke.py) rebuilds the same tree from the tracked checkpoint.

The committed fixture was made on an 8-core x86 CPU (no accelerator); its
`seconds` hold each section's time.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = "accuracy_release/bpe.model"
CHECKPOINT = "accuracy_release/avg_last_3.bf16.msgpack"
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_spk_reference.json")
ARRAYS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_spk_reference_arrays.npz")

SPK_WEIGHT = 0.5
SEEDED_SEED, SEEDED_SCALARS = 0, 0.4
EVAL_SPLIT = dict(n_episodes=4, episode_seconds=180.0, n_speakers=8, seed=202)

TINY_SPLITS = {"train": dict(n_episodes=2, episode_seconds=40.0, n_speakers=8, seed=0),
               "valid": dict(n_episodes=1, episode_seconds=40.0, n_speakers=8, seed=101)}
TINY_INIT_SEED, TINY_SCALARS = 11, 0.1
TINY_ARGV = ["--train-data", "TRAIN", "--valid-data", "VALID", "--tokenizer", TOKENIZER,
             "--model-type", "1x", "--num-speakers", "8", "--spk-weight", str(SPK_WEIGHT),
             "--batch-size", "4", "--max-secs", "12", "--num-workers", "0",
             "--max-epochs", "2", "--no-specaug", "--shiftaug", "--cache-items",
             "--audio-int16", "--ckpt-every", "1", "--name", "tiny",
             "--checkpoint-path", "CKPTS", "--out-dir", "OUT", "--load", "INIT"]

TRAIN_SPLITS = {"train": dict(n_episodes=8, episode_seconds=120.0, n_speakers=8, seed=0),
                "valid": dict(n_episodes=2, episode_seconds=120.0, n_speakers=8, seed=101)}
TRAIN_ARGV = ["--train-data", "TRAIN", "--valid-data", "VALID", "--tokenizer", TOKENIZER,
              "--model-type", "1x", "--num-speakers", "8", "--spk-weight", str(SPK_WEIGHT),
              "--batch-size", "16", "--max-secs", "28.5", "--num-workers", "0",
              "--lr", "2e-4", "--max-epochs", "2", "--ckpt-every", "1", "--no-specaug",
              "--shiftaug", "--cache-items", "--audio-int16", "--name", "seeded_spk",
              "--checkpoint-path", "CKPTS", "--out-dir", "OUT", "--load", "TREE"]

# the speaker head's shape in the 1x model (tal_asrd_tpu/models/asr.py:123-134)
HEAD_SHAPE = dict(enc_channels=1440, d=256, ff=1024, layers=2, spk_embed=128, speakers=8)
# BPE ids that no reference utterance of scripts/ensure_corpus.sh's splits
# uses (word-internal pieces: "e", "eac", "wi", "bo", "fo", "foll", "bef",
# "befo"); the tree puts the tracked checkpoint's speaker rows there
SPEAKER_SLOTS = (281, 282, 285, 287, 292, 293, 297, 298)
MEMORY_GAIN = 0.01      # the head's memory at unit scale (see seeded_spk_tree)


def seeded_spk_tree(tracked_tree: dict, n_text: int, seed: int, scalars: float,
                    enc_channels: int = 1440, d: int = 256, ff: int = 1024, layers: int = 2,
                    spk_embed: int = 128, speakers: int = 8,
                    speaker_slots=SPEAKER_SLOTS, memory_gain: float = MEMORY_GAIN) -> dict:
    """A speaker-head model's parameter tree (flax names and layouts): the
    text weights of `tracked_tree` (a speaker-token checkpoint's params) —
    `encoder`, `decoder_proj`, `decoder`, `embedding_proj`, `mem_pos_alpha`
    if present, and `embedding` cut to its first `n_text` rows (a head model
    has no speaker tokens) — as they are, except that the rows of the text
    ids `speaker_slots` hold the checkpoint's `speakers` speaker rows. A
    speaker-token model closes an utterance with its speaker token and then
    EOS; cut to its text rows alone it never reaches EOS, and every search
    would run to its length. With the speaker rows in slots that no
    reference text uses, it emits one of those ids where it would name the
    speaker, then EOS, as a text-only model does. The head is drawn in
    float32 by
    `np.random.default_rng(seed)` in this order: `spk_enc_proj` [enc, d];
    each `spk_decoder` layer's self_attn/qkv [d, 3d], self_attn/out_proj,
    cross_attn/q, cross_attn/kv [d, 2d], cross_attn/out_proj, linear1
    [d, ff], linear2 [ff, d]; `speaker_head_1` [d, spk_embed];
    `speaker_head_2` [spk_embed, speakers]. Each kernel is normal /
    sqrt(fan_in) (lecun-normal scale) followed by its bias, normal x 0.02,
    and `spk_enc_proj`'s kernel is then scaled by `memory_gain`: the tracked
    encoder's output has an RMS of ~160, and at lecun scale alone the
    head's memory would too, its logits reaching ~100 (a speaker loss of
    ~65);
    every ReZero scalar of the head is `scalars` (at 0, their initial value,
    its layers would add nothing)."""
    rng = np.random.default_rng(seed)

    def dense(fan_in, fan_out):
        return {"kernel": (rng.standard_normal((fan_in, fan_out)) / np.sqrt(fan_in))
                .astype(np.float32),
                "bias": (rng.standard_normal((fan_out,)) * 0.02).astype(np.float32)}

    tree = {k: tracked_tree[k] for k in ("encoder", "decoder_proj", "decoder",
                                         "embedding_proj", "mem_pos_alpha")
            if k in tracked_tree}
    table = np.asarray(tracked_tree["embedding"]["embedding"])
    text = table[:n_text].copy()
    text[list(speaker_slots)] = table[n_text:n_text + speakers]
    tree["embedding"] = {"embedding": text}
    tree["spk_enc_proj"] = dense(enc_channels, d)
    tree["spk_enc_proj"]["kernel"] *= np.float32(memory_gain)
    head = {}
    for i in range(layers):
        layer = {"self_attn": {"qkv": dense(d, 3 * d), "out_proj": dense(d, d)}}
        layer["cross_attn"] = {"q": dense(d, d), "kv": dense(d, 2 * d), "out_proj": dense(d, d)}
        layer["linear1"] = dense(d, ff)
        layer["linear2"] = dense(ff, d)
        layer["resweight"] = np.asarray(scalars, np.float32)
        layer["resweight_src"] = np.asarray(scalars, np.float32)
        head[f"layers_{i}"] = layer
    tree["spk_decoder"] = head
    tree["speaker_head_1"] = dense(d, spk_embed)
    tree["speaker_head_2"] = dense(spk_embed, speakers)
    return tree


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 values that are bfloat16 numbers -> their 16-bit patterns."""
    x = np.ascontiguousarray(x, np.float32)
    bits = x.view(np.uint32)
    if np.any(bits & 0xFFFF):
        raise ValueError("not bfloat16 values")
    return (bits >> 16).astype(np.uint16)


def from_bf16_bits(b: np.ndarray) -> np.ndarray:
    return (np.asarray(b, np.uint32) << 16).view(np.float32)


# Runs in the child: the JAX training CLI, patched in this process only
# (no dropout and no token replacement under TAL_SPK_NO_NOISE, f32 compute
# under TAL_SPK_F32, every step logged), with each validation's batch
# metrics recorded.
TRAIN_CHILD = r"""
import functools, json, os, sys
from dataclasses import replace
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import tal_asrd_tpu.train.loop as loop_mod
from tal_asrd_tpu.cli import train as cli_train

vals = []
orig_validate = loop_mod.Trainer._validate
def _validate(self, state, val_loader, eval_step, step, n_batches=None):
    batches = []
    def recorded(st, batch):
        m = eval_step(st, batch)
        batches.append({k: float(m[k]) for k in ("loss", "lm_loss", "spk_loss")})
        return m
    val = orig_validate(self, state, val_loader, recorded, step, n_batches)
    vals.append(dict({k: float(np.mean([b[k] for b in batches])) for k in batches[0]},
                     step=int(step), batches=len(batches)))
    return val
loop_mod.Trainer._validate = _validate
if os.environ.get("TAL_SPK_NO_NOISE"):
    orig_build = cli_train.build_configs
    def build_configs(args, tokenizer=None):
        model_cfg, train_cfg, decode_cfg = orig_build(args, tokenizer)
        return (replace(model_cfg, dropout=0.0, tds_dropout=0.0, conv_impl="xla"),
                replace(train_cfg, token_replace_prob=0.0), decode_cfg)
    cli_train.build_configs = build_configs
if os.environ.get("TAL_SPK_F32"):
    cli_train.ASRSystem = functools.partial(cli_train.ASRSystem, dtype=jnp.float32)
cli_train.TrainerConfig = functools.partial(cli_train.TrainerConfig, log_every=1)
cli_train.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump(vals, f)
"""


def run(cmd, env, child=None):
    print("+", " ".join("<child>" if c == child else c for c in cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=ROOT, env=env)


def fill(argv, paths):
    out = []
    for a in argv:
        for key, path in paths.items():
            if a == key or a.startswith(key + "/"):
                a = path + a[len(key):]
        out.append(a)
    return out


def train_run(argv, paths, env, tag):
    """One JAX training CLI run under TRAIN_CHILD: (step records,
    validations, spot checks, new checkpoint names)."""
    rec_path = os.path.join(os.path.dirname(paths["OUT"]), f"{tag}_vals.json")
    run([sys.executable, "-c", TRAIN_CHILD, rec_path] + fill(argv, paths), env, TRAIN_CHILD)
    name = argv[argv.index("--name") + 1]
    with open(os.path.join(paths["OUT"], f"{name}.metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    with open(rec_path) as f:
        vals = json.load(f)
    ckpts = sorted(n for n in os.listdir(os.path.join(paths["CKPTS"], name))
                   if n.startswith("ckpt_"))
    steps = [[r["step"], r["loss"], r["lm_loss"], r["spk_loss"]] for r in recs if "loss" in r]
    gens = [[r["step"], r["ref"], r["hyp"]] for r in recs if r.get("type") == "generation"]
    return steps, vals, gens, ckpts


def tiny_cli(tmp, env):
    """Section (a). Returns (section, arrays)."""
    from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree, save_pytree, tree_leaves
    from tal_asrd_tpu_torch.core.convert import params_spec
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.models.asr import ASRModel
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
    from tests.test_torch_helpers import seeded_params

    paths = {k: os.path.join(tmp, "tiny_" + k.lower()) for k in ("TRAIN", "VALID", "CKPTS", "OUT")}
    paths["INIT"] = os.path.join(tmp, "tiny_init.msgpack")
    for name, split in TINY_SPLITS.items():
        build_synth_corpus(paths[name.upper()], **split)
    os.environ["TAL_TINY_ARCH"] = "1"
    try:
        args = get_argparser(is_train=True).parse_args(fill(TINY_ARGV, paths))
        model_cfg = build_configs(args, BpeTokenizer(model_path=TOKENIZER))[0]
    finally:
        del os.environ["TAL_TINY_ARCH"]
    init = seeded_params(params_spec(ASRModel(model_cfg, device="cpu")), TINY_INIT_SEED,
                         scalar_bump=TINY_SCALARS)
    save_pytree(paths["INIT"], init)
    steps, vals, gens, ckpts = train_run(
        TINY_ARGV, paths, dict(env, TAL_TINY_ARCH="1", TAL_SPK_NO_NOISE="1", TAL_SPK_F32="1"),
        "tiny")
    last = dict(tree_leaves(load_pytree(os.path.join(paths["CKPTS"], "tiny", ckpts[-1]))))
    arrays, worst = {}, 0.0
    for path, v0 in tree_leaves(init):
        d = np.asarray(last[path], np.float32) - np.asarray(v0, np.float32)
        stored = d.astype(np.float16)
        worst = max(worst, float(np.abs(stored.astype(np.float32) - d).max(initial=0)))
        arrays["tiny_cli/" + "/".join(path)] = stored
    section = {"argv": TINY_ARGV, "splits": TINY_SPLITS, "init_seed": TINY_INIT_SEED,
               "init_scalars": TINY_SCALARS, "step_losses": steps, "validations": vals,
               "generations": gens, "checkpoints": ckpts, "last_checkpoint": ckpts[-1],
               "float16_storage_max_abs_err": worst}
    return section, arrays


def write_tree(tmp):
    """The seeded speaker-head tree on the tracked checkpoint, as a flax
    msgpack file; returns its path."""
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree, save_pytree
    path = os.path.join(tmp, "seeded_spk.msgpack")
    save_pytree(path, seeded_spk_tree(load_pytree(os.path.join(ROOT, CHECKPOINT)), 300,
                                      SEEDED_SEED, SEEDED_SCALARS, **HEAD_SHAPE))
    return path


def seeded_eval(tmp, env, tree):
    """Section (b). Returns (section, arrays)."""
    import torch_eval_reference as er
    from torch_lm_reference import f32_recorder
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus

    t0 = time.perf_counter()
    split = os.path.join(tmp, "test")
    build_synth_corpus(split, **EVAL_SPLIT)
    runs, arrays = {}, {}
    for name, recorder in (("f32", f32_recorder(er.RECORDER)), ("bf16", er.RECORDER)):
        out = os.path.join(tmp, f"out-{name}")
        rec_path = os.path.join(tmp, f"record-{name}.json")
        test_args = ["--train-data", split, "--valid-data", split, "--test-data", split,
                     "--tokenizer", TOKENIZER, "--model-type", "1x", "--num-speakers", "8",
                     "--spk-weight", str(SPK_WEIGHT), "--num-workers", "0", "--load", tree,
                     "--out-dir", out]
        t1 = time.perf_counter()
        run([sys.executable, "-c", recorder, rec_path] + test_args, env, recorder)
        t_cli = time.perf_counter() - t1
        ready = os.path.join(out, "wder_ready.pkl")
        run([sys.executable, "-m", "tal_asrd_tpu.cli.tools", "wder-format",
             "--test-result", os.path.join(out, "test_result.pkl"), "--out", ready], env)
        run([sys.executable, "-m", "tal_asrd_tpu.cli.wder", "--eval-file", ready,
             "--workers", "1"], env)
        with open(os.path.join(out, "wder_ready-wder.pkl"), "rb") as f:
            scored = pickle.load(f)
        with open(rec_path) as f:
            record = json.load(f)
        with open(os.path.join(out, "test_result.pkl"), "rb") as f:
            results = pickle.load(f)
        segments = [batch["tokens"][row][:batch["lengths"][row]]
                    for batch in record["batches"] for row in range(len(batch["idx"]))]
        shapes = []
        for seg, (_, hyp) in enumerate(results):
            shapes.append([list(np.shape(u["speakerLogits"])) for u in hyp])
            for u, utt in enumerate(hyp):
                arrays[f"seeded_eval/{name}/{seg:03d}/{u}"] = bf16_bits(utt["speakerLogits"])
        runs[name] = {
            "commands": ["JAX_PLATFORMS=cpu python -m tal_asrd_tpu.cli.test " + " ".join(
                test_args).replace(split, "SPLIT").replace(out, "OUT").replace(tree, "TREE")],
            "compute_dtype": "float32" if name == "f32" else "bfloat16",
            "wer_pct": 100.0 * scored["overall_wer"], "wder_pct": 100.0 * scored["overall_wder"],
            "n_words": int(sum(scored["n_words"])), "dist": int(sum(scored["dist"])),
            "test_loss": record["test_end"]["test_loss"], "segment_tokens": segments,
            "speaker_logits_shapes": shapes, "seconds_cli": t_cli}
        print(json.dumps({name: {k: runs[name][k] for k in ("wer_pct", "wder_pct", "n_words",
                                                            "seconds_cli")}}), flush=True)
    return {"runs": runs, "split": dict(EVAL_SPLIT,
                                        made_by="tal_asrd_tpu_torch.data.synth.build_synth_corpus"),
            "seconds": time.perf_counter() - t0}, arrays


def seeded_train(tmp, env, tree):
    """Section (c)."""
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus

    paths = {k: os.path.join(tmp, "train_" + k.lower()) for k in ("TRAIN", "VALID", "CKPTS", "OUT")}
    paths["TREE"] = tree
    for name, split in TRAIN_SPLITS.items():
        build_synth_corpus(paths[name.upper()], **split)
    steps, vals, gens, ckpts = train_run(
        TRAIN_ARGV, paths, dict(env, TAL_SPK_NO_NOISE="1", TAL_SPK_F32="1"), "seeded_train")
    return {"argv": TRAIN_ARGV, "splits": TRAIN_SPLITS, "compute_dtype": "float32",
            "no_noise": "dropout 0, tds_dropout 0, token_replace_prob 0",
            "cut": "train 8 of 100 episodes, valid 2 of 3 (scripts/ensure_corpus.sh)",
            "step_losses": steps, "validations": vals, "generations": gens,
            "checkpoints": ckpts}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default="tiny_cli,seeded_eval,seeded_train")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    fixture, arrays = {}, {}
    if os.path.exists(FIXTURE):
        with open(FIXTURE) as f:
            fixture = json.load(f)
    if os.path.exists(ARRAYS_NPZ):
        arrays = dict(np.load(ARRAYS_NPZ))
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    fixture.update(what="JAX CPU reference of the separate speaker head "
                        "(scripts/torch_spk_reference.py)", tokenizer=TOKENIZER,
                   spk_weight=SPK_WEIGHT,
                   tree={"checkpoint": CHECKPOINT, "n_text": 300, "seed": SEEDED_SEED,
                         "scalars": SEEDED_SCALARS, **HEAD_SHAPE,
                         "speaker_slots": list(SPEAKER_SLOTS), "memory_gain": MEMORY_GAIN,
                         "made_by": "scripts/torch_spk_reference.py::seeded_spk_tree"})
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_tree(tmp)
        for name in args.sections.split(","):
            t0 = time.perf_counter()
            if name == "tiny_cli":
                fixture[name], new = tiny_cli(tmp, env)
            elif name == "seeded_eval":
                fixture[name], new = seeded_eval(tmp, env, tree)
            elif name == "seeded_train":
                fixture[name], new = seeded_train(tmp, env, tree), {}
            else:
                raise SystemExit(f"unknown section {name}")
            arrays = {k: v for k, v in arrays.items() if not k.startswith(name + "/")}
            arrays.update(new)
            fixture[name].update(commit=commit, seconds=time.perf_counter() - t0)
            print(json.dumps({name: fixture[name]["seconds"]}), flush=True)
            np.savez_compressed(ARRAYS_NPZ, **arrays)
            with open(FIXTURE, "w") as f:
                json.dump(fixture, f, indent=None, separators=(",", ":"))
                f.write("\n")
            print(f"wrote {FIXTURE}", flush=True)


if __name__ == "__main__":
    main()
