#!/usr/bin/env python3
"""The reference figures of LM shallow fusion, from the JAX package on the CPU.

    python3 scripts/torch_lm_reference.py [--sections tiny_cli,seeded_eval]
        [--out tests/fixtures/torch_lm_reference.json]

Two sections, each step in its own process with JAX_PLATFORMS=cpu:

  (a) tiny_cli: `python -m tal_asrd_tpu.cli.train_lm` at a tiny shape
      (TINY_ARGV: hidden 32, 2 layers, 2 heads, rows of 32 tokens, batch 4,
      3 epochs) on tiny synthetic splits (TINY_SPLITS). The reference
      ignores --load, so its LMSystem is patched, after its own init, to
      start from `seeded_lm_params(..., TINY_SEED, TINY_SCALARS)` (optimizer
      state made anew for it); a recorder keeps each epoch's step losses and
      validation perplexity. The checkpoints it writes go to
      tests/fixtures/torch_lm_reference_ckpts.npz ("<ckpt file>/<leaf
      path>"), with the initial tree under "init/...".
  (b) seeded_eval: `python -m tal_asrd_tpu.cli.test` on the tracked
      checkpoint over the synthetic test split (seed 202, 4 x 180 s, as
      scripts/ensure_corpus.sh makes it), its ASRSystem patched to compute
      in float32 (F32_PATCH; the CLI computes in bfloat16), with
      `--lm-path` an LM drawn by
      `seeded_lm_params(300, SEEDED_SEED, SEEDED_SCALARS)` at the eval CLI's
      shape (hidden 512, 6 layers) and `--lm-weight SEEDED_WEIGHT`, for the
      three legs (aligned; --unaligned, the state machine; --unaligned
      --vad-windows), each scored by `cli.tools wder-format` + `cli.wder`,
      under the recorders of scripts/torch_eval_reference.py and
      scripts/torch_unaligned_reference.py; plus the aligned leg without an
      LM, against which `words_changed_share` counts the hypothesis words
      that fusion changed (word edit distance over the unfused words).
      Float32 because in bfloat16 two implementations of the same model part
      by up to 0.9 in a logit at some decode steps (the JAX CLI's CPU
      arithmetic against its own float32 at the state machine's 17th token
      of episode 1: 3.797 against 2.898), which the LM's continuous scores
      turn into other tokens; in float32 the two packages agree there to
      5e-6.

`seeded_lm_params` needs numpy alone, so a machine without JAX (the card's,
chip_smoke.py) rebuilds the same LM from the fixture's seed.

The committed fixture was made on an 8-core x86 CPU (no accelerator); its
`seconds` holds each step's time.
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
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_lm_reference.json")
CKPTS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_lm_reference_ckpts.npz")

TINY_SPLITS = {"train": dict(n_episodes=4, episode_seconds=60.0, n_speakers=8, seed=0),
               "valid": dict(n_episodes=2, episode_seconds=60.0, n_speakers=8, seed=101)}
TINY_SEED, TINY_SCALARS = 5, 0.4
TINY_SHAPE = dict(hidden=32, layers=2)
TINY_ARGV = ["--train-data", "TRAIN", "--valid-data", "VALID", "--tokenizer", TOKENIZER,
             "--hidden-size", "32", "--layers", "2", "--attn-heads", "2", "--max-len", "32",
             "--batch-size", "4", "--lr", "1e-3", "--max-epochs", "3", "--name", "tiny",
             "--checkpoint-path", "CKPTS", "--load", "IGNORED.msgpack"]

SEEDED_SEED, SEEDED_SCALARS, SEEDED_WEIGHT = 0, 0.4, 0.1
EVAL_SPLIT = dict(n_episodes=4, episode_seconds=180.0, n_speakers=8, seed=202)


def seeded_lm_params(vocab: int, seed: int, scalars: float, hidden: int = 512,
                     layers: int = 6) -> dict:
    """A DecoderLMModel parameter tree (flax names and layouts, float32)
    drawn by `np.random.default_rng(seed)` in this order: the embedding
    [vocab, hidden] normal / sqrt(hidden); then each layer's linear1,
    linear2, self_attn/qkv, self_attn/out_proj, each kernel [in, out]
    normal / sqrt(in) then its bias normal x 0.02; every ReZero scalar
    `scalars` (at 0, their initial value, the blocks would add nothing)."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def dense(fan_in, fan_out):
        return {"kernel": normal((fan_in, fan_out), 1.0 / np.sqrt(fan_in)),
                "bias": normal((fan_out,), 0.02)}

    d = hidden
    tree = {"embedding": {"embedding": normal((vocab, d), 1.0 / np.sqrt(d))}}
    for i in range(layers):
        layer = {"linear1": dense(d, 4 * d), "linear2": dense(4 * d, d)}
        layer["self_attn"] = {"qkv": dense(d, 3 * d), "out_proj": dense(d, d)}
        layer["resweight"] = np.asarray(scalars, np.float32)
        tree[f"layers_{i}"] = layer
    return tree


def words_changed_share(unfused, fused) -> float:
    """Word edit distance between the lines of two hyp.txt files, over the
    unfused lines' words."""
    dist = total = 0
    for a, b in zip(unfused, fused):
        a, b = a.split(), b.split()
        row = list(range(len(b) + 1))
        for i, x in enumerate(a, 1):
            prev, row[0] = row[0], i
            for j, y in enumerate(b, 1):
                prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1, prev + (x != y))
        dist, total = dist + row[-1], total + len(a)
    return dist / max(total, 1)


# Runs in the child: cli.train_lm.main from the seeded initial tree, recording
# each epoch's step losses and validation perplexity.
TINY_RECORDER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import tal_asrd_tpu.train.lm_system as lm_mod
from tal_asrd_tpu.cli import train_lm as cli
from tal_asrd_tpu.core.checkpoint import load_pytree

init_path, rec_path = sys.argv[1], sys.argv[2]
record = {"epochs": []}
System = lm_mod.LMSystem
orig_init, orig_fit, orig_ppl = System.__init__, System.fit, System.perplexity

def __init__(self, *args, **kwargs):
    orig_init(self, *args, **kwargs)
    params = jax.tree_util.tree_map(jnp.asarray, load_pytree(init_path))
    self.state = self.state.replace(params=params, opt_state=self.tx.init(params))

def fit(self, *args, **kwargs):
    losses = orig_fit(self, *args, **kwargs)
    record["epochs"].append({"losses": losses})
    return losses

def perplexity(self, *args, **kwargs):
    ppl = orig_ppl(self, *args, **kwargs)
    record["epochs"][-1]["ppl"] = ppl
    return ppl

System.__init__, System.fit, System.perplexity = __init__, fit, perplexity
cli.main(sys.argv[3:])
with open(rec_path, "w") as f:
    json.dump(record, f)
"""


# Put before the recorders' `cli_test.main`: the CLI's system in float32.
F32_PATCH = """
import functools
import tal_asrd_tpu.train as _train
cli_test.ASRSystem = functools.partial(_train.ASRSystem, dtype=jax.numpy.float32)
"""


def f32_recorder(recorder: str) -> str:
    anchor = "from tal_asrd_tpu.cli import test as cli_test\n"
    if anchor not in recorder:
        raise SystemExit("the recorder no longer imports cli_test as expected")
    return recorder.replace(anchor, anchor + F32_PATCH, 1)


def run(cmd, env, recorder=None):
    print("+", " ".join("<recorder>" if c == recorder else c for c in cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=ROOT, env=env)


def fill(argv, paths):
    return [paths.get(a, a) for a in argv]


def tiny_cli(tmp, env):
    """Section (a). Returns (fixture section, npz arrays)."""
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree, save_pytree, tree_leaves
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus

    t0 = time.perf_counter()
    paths = {k: os.path.join(tmp, "tiny_" + k.lower()) for k in ("TRAIN", "VALID", "CKPTS")}
    for name, split in TINY_SPLITS.items():
        build_synth_corpus(paths[name.upper()], **split)
    init = seeded_lm_params(300, TINY_SEED, TINY_SCALARS, **TINY_SHAPE)
    init_path = os.path.join(tmp, "tiny_init.msgpack")
    save_pytree(init_path, init)
    rec_path = os.path.join(tmp, "tiny_record.json")
    run([sys.executable, "-c", TINY_RECORDER, init_path, rec_path] + fill(TINY_ARGV, paths),
        env, TINY_RECORDER)
    with open(rec_path) as f:
        record = json.load(f)
    ckpt_dir = os.path.join(paths["CKPTS"], "tiny")
    arrays = {"init/" + "/".join(p): v for p, v in tree_leaves(init)}
    names = sorted(n for n in os.listdir(ckpt_dir) if n.startswith("ckpt_"))
    for name in names:
        for p, v in tree_leaves(load_pytree(os.path.join(ckpt_dir, name))):
            arrays[f"{name}/" + "/".join(p)] = np.asarray(v)
    with open(os.path.join(ckpt_dir, "latest.json")) as f:
        latest = json.load(f)
    section = {"argv": TINY_ARGV, "splits": TINY_SPLITS, "init_seed": TINY_SEED,
               "init_scalars": TINY_SCALARS, "shape": TINY_SHAPE, "epochs": record["epochs"],
               "checkpoints": names, "latest": latest,
               "seconds": time.perf_counter() - t0}
    return section, arrays


def aligned_leg(name, flags, split, tmp, env):
    """The aligned leg under scripts/torch_eval_reference.py's recorder,
    scored by the JAX chain. Returns the leg's figures and hyp.txt lines."""
    import torch_eval_reference as er

    out = os.path.join(tmp, f"out-{name}")
    rec_path = os.path.join(tmp, f"record-{name}.json")
    test_args = ["--train-data", split, "--valid-data", split, "--test-data", split,
                 "--tokenizer", TOKENIZER, "--model-type", "1x", "--num-speakers", "8",
                 "--num-workers", "0", "--load", CHECKPOINT, "--out-dir", out] + flags
    t0 = time.perf_counter()
    recorder = f32_recorder(er.RECORDER)
    run([sys.executable, "-c", recorder, rec_path] + test_args, env, recorder)
    t_test = time.perf_counter() - t0
    ready = os.path.join(out, "wder_ready.pkl")
    run([sys.executable, "-m", "tal_asrd_tpu.cli.tools", "wder-format",
         "--test-result", os.path.join(out, "test_result.pkl"), "--out", ready], env)
    run([sys.executable, "-m", "tal_asrd_tpu.cli.wder", "--eval-file", ready,
         "--workers", "1"], env)
    with open(os.path.join(out, "wder_ready-wder.pkl"), "rb") as f:
        scored = pickle.load(f)
    with open(rec_path) as f:
        record = json.load(f)
    with open(os.path.join(out, "hyp.txt")) as f:
        hyps = f.read().splitlines()
    segments = [batch["tokens"][row][:batch["lengths"][row]]
                for batch in record["batches"] for row in range(len(batch["idx"]))]
    leg = {"commands": ["JAX_PLATFORMS=cpu python -m tal_asrd_tpu.cli.test " + " ".join(
               test_args).replace(split, "SPLIT").replace(out, "OUT")],
           "flags": flags, "wer_pct": 100.0 * scored["overall_wer"],
           "wder_pct": 100.0 * scored["overall_wder"],
           "n_words": int(sum(scored["n_words"])), "dist": int(sum(scored["dist"])),
           "test_loss": record["test_end"]["test_loss"], "segment_tokens": segments,
           "seconds_cli": t_test, "seconds": time.perf_counter() - t0}
    return leg, hyps


def seeded_eval(tmp, env):
    """Section (b)."""
    import torch_unaligned_reference as ur
    from tal_asrd_tpu_torch.core.checkpoint import save_pytree
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus

    t0 = time.perf_counter()
    split = os.path.join(tmp, "test")
    build_synth_corpus(split, **EVAL_SPLIT)
    lm_path = os.path.join(tmp, "seeded_lm.msgpack")
    save_pytree(lm_path, seeded_lm_params(300, SEEDED_SEED, SEEDED_SCALARS))
    lm_flags = ["--lm-path", lm_path, "--lm-weight", str(SEEDED_WEIGHT)]
    legs = {}
    no_lm, hyps_no_lm = aligned_leg("aligned_no_lm", [], split, tmp, env)
    legs["aligned"], hyps = aligned_leg("aligned", lm_flags, split, tmp, env)

    def unaligned_args(out):
        return ["--train-data", split, "--valid-data", split, "--test-data", split,
                "--tokenizer", TOKENIZER, "--model-type", "1x", "--num-speakers", "8",
                "--num-workers", "0", "--unaligned", "--load", CHECKPOINT, "--out-dir", out]

    ur.RECORDER = f32_recorder(ur.RECORDER)      # run_leg runs the module's recorder
    for name, flags in (("sm", lm_flags), ("vad", ["--vad-windows"] + lm_flags)):
        legs[name] = ur.run_leg(name, flags, split, tmp, env, unaligned_args)
    for leg in legs.values():
        leg["flags"] = [("LM" if f == lm_path else f) for f in leg["flags"]]
        leg["commands"] = [c.replace(lm_path, "LM") for c in leg["commands"]]
    share = words_changed_share(hyps_no_lm, hyps)
    for name, leg in legs.items():
        print(json.dumps({name: {k: leg[k] for k in ("wer_pct", "wder_pct", "n_words",
                                                     "seconds")}}), flush=True)
    return {"compute_dtype": "float32",
            "lm": {"seed": SEEDED_SEED, "scalars": SEEDED_SCALARS, "weight": SEEDED_WEIGHT,
                   "vocab": 300, "hidden": 512, "layers": 6,
                   "made_by": "scripts/torch_lm_reference.py::seeded_lm_params"},
            "split": dict(EVAL_SPLIT, made_by="tal_asrd_tpu_torch.data.synth.build_synth_corpus"),
            "checkpoint": CHECKPOINT, "tokenizer": TOKENIZER,
            "aligned_without_lm": {k: no_lm[k] for k in ("wer_pct", "wder_pct", "n_words",
                                                          "test_loss")},
            "words_changed_share": share, "legs": legs,
            "seconds": time.perf_counter() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default="tiny_cli,seeded_eval")
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    fixture = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            fixture = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        sections = args.sections.split(",")
        if "tiny_cli" in sections:
            fixture["tiny_cli"], arrays = tiny_cli(tmp, env)
            np.savez_compressed(CKPTS_NPZ, **arrays)
            print(json.dumps({"tiny_cli": [e["ppl"] for e in fixture["tiny_cli"]["epochs"]]}))
        if "seeded_eval" in sections:
            fixture["seeded_eval"] = seeded_eval(tmp, env)
            print(json.dumps({"words_changed_share":
                              fixture["seeded_eval"]["words_changed_share"]}))
    fixture["what"] = "JAX CPU reference of LM shallow fusion (scripts/torch_lm_reference.py)"
    fixture["commit"] = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                       capture_output=True, text=True).stdout.strip() or None
    with open(args.out, "w") as f:
        json.dump(fixture, f, indent=None, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
