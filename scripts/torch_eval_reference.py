#!/usr/bin/env python3
"""The reference figure of the aligned evaluation, from the JAX package on the CPU.

    python3 scripts/torch_eval_reference.py [--out tests/fixtures/torch_aligned_eval_reference.json]

Builds the synthetic test split (`tal_asrd_tpu.data.synth.build_synth_corpus`,
seed 202, 4 episodes of 180 s, 8 speakers, as scripts/ensure_corpus.sh makes
it) in a temporary directory, then runs the JAX package's aligned chain with
the flags of scripts/accuracy.sh's aligned leg (no --unaligned, no
--fused-decode), each step in its own process with JAX_PLATFORMS=cpu:

    python -m tal_asrd_tpu.cli.test --train-data D --valid-data D --test-data D
        --tokenizer accuracy_release/bpe.model --model-type 1x --num-speakers 8
        --num-workers 0 --load accuracy_release/avg_last_3.bf16.msgpack --out-dir OUT
    python -m tal_asrd_tpu.cli.tools wder-format --test-result OUT/test_result.pkl
        --out OUT/wder_ready_aligned.pkl
    python -m tal_asrd_tpu.cli.wder --eval-file OUT/wder_ready_aligned.pkl --workers 1

The first step runs `tal_asrd_tpu.cli.test.main` with those arguments under a
recorder that only reads what the beam search returns (each row's tokens,
length, score and whether it ended in EOS) and the test loss; it changes
nothing the CLI computes. The fixture holds WER, WDER, the test loss, every
segment's hypothesis tokens (prime and EOS included) and beam score, the
git commit and the commands. ACCURACY.json's figures (58.53 / 0.0) come from
the f32 checkpoint, which is not in the repository: they are printed beside
the result and are no gate.

The committed fixture was made on an 8-core x86 CPU (no accelerator) in
74.5 s: 3.2 s for the split, 64.4 s for the CLI (the 1x model in bf16 over
118 segments in two batches, beam 5, each beam search one jit-compiled
while-loop at 320 and 270 lanes) and the rest for the two scoring steps
(an earlier run of the same script: 85.6 s, the same contents).
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = "accuracy_release/avg_last_3.bf16.msgpack"
TOKENIZER = "accuracy_release/bpe.model"
SPLIT = dict(n_episodes=4, episode_seconds=180.0, n_speakers=8, seed=202)

# Runs in the child: cli.test.main under a recorder of the beam's outputs.
RECORDER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import tal_asrd_tpu.eval.runner as runner_mod
from tal_asrd_tpu.cli import test as cli_test

record = {"batches": [], "test_end": None}
Runner = runner_mod.EvalRunner
orig_generate, orig_step, orig_end = Runner._generate_fn, Runner.test_step_aligned, Runner.test_end

def generate_fn(self, shape, max_new):
    run = orig_generate(self, shape, max_new)
    def recorded(*args):
        out = run(*args)
        record["batches"][-1].update(
            {k: np.asarray(out[k]).tolist() for k in ("tokens", "lengths", "scores", "found")})
        return out
    return recorded

def test_step_aligned(self, batch, refs):
    record["batches"].append({"idx": np.asarray(batch["idx"]).tolist(),
                              "text_shape": list(batch["text"].shape)})
    res = orig_step(self, batch, refs)
    record["batches"][-1]["loss"] = res["loss"]
    return res

def test_end(self):
    record["test_end"] = orig_end(self)
    return record["test_end"]

Runner._generate_fn, Runner.test_step_aligned, Runner.test_end = generate_fn, test_step_aligned, test_end
cli_test.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump(record, f)
"""


def run(cmd, env):
    print("+", " ".join("<recorder>" if c == RECORDER else c for c in cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=ROOT, env=env)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "fixtures", "torch_aligned_eval_reference.json"))
    args = ap.parse_args()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        split, out = os.path.join(tmp, "test"), os.path.join(tmp, "out-test-aligned")
        sys.path.insert(0, ROOT)
        from tal_asrd_tpu.data.synth import build_synth_corpus
        build_synth_corpus(split, **SPLIT)
        t_split = time.perf_counter() - t0

        test_args = ["--train-data", split, "--valid-data", split, "--test-data", split,
                     "--tokenizer", TOKENIZER, "--model-type", "1x", "--num-speakers", "8",
                     "--num-workers", "0", "--load", CHECKPOINT, "--out-dir", out]
        rec_path = os.path.join(tmp, "record.json")
        t1 = time.perf_counter()
        run([sys.executable, "-c", RECORDER, rec_path] + test_args, env)
        t_test = time.perf_counter() - t1
        ready = os.path.join(out, "wder_ready_aligned.pkl")
        run([sys.executable, "-m", "tal_asrd_tpu.cli.tools", "wder-format",
             "--test-result", os.path.join(out, "test_result.pkl"), "--out", ready], env)
        run([sys.executable, "-m", "tal_asrd_tpu.cli.wder", "--eval-file", ready,
             "--workers", "1"], env)
        with open(os.path.join(out, "wder_ready_aligned-wder.pkl"), "rb") as f:
            scored = pickle.load(f)
        with open(rec_path) as f:
            record = json.load(f)

    segments = []
    for batch in record["batches"]:
        for row, idx in enumerate(batch["idx"]):
            n = batch["lengths"][row]
            segments.append({"idx": idx, "tokens": batch["tokens"][row][:n],
                             "score": batch["scores"][row], "found": batch["found"][row]})
    if [s["idx"] for s in segments] != list(range(len(segments))):
        raise SystemExit("segments did not come in dataset order")
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    fixture = {
        "what": "JAX CPU reference of the aligned evaluation (scripts/torch_eval_reference.py)",
        "commit": commit,
        "commands": [
            "JAX_PLATFORMS=cpu python -m tal_asrd_tpu.cli.test " + " ".join(
                test_args).replace(split, "SPLIT").replace(out, "OUT"),
            "python -m tal_asrd_tpu.cli.tools wder-format --test-result OUT/test_result.pkl "
            "--out OUT/wder_ready_aligned.pkl",
            "python -m tal_asrd_tpu.cli.wder --eval-file OUT/wder_ready_aligned.pkl --workers 1"],
        "split": dict(SPLIT, made_by="tal_asrd_tpu.data.synth.build_synth_corpus"),
        "checkpoint": CHECKPOINT, "tokenizer": TOKENIZER,
        "n_segments": len(segments), "n_batches": len(record["batches"]),
        "batch_text_shapes": [b["text_shape"] for b in record["batches"]],
        "overall_wer": scored["overall_wer"], "overall_wder": scored["overall_wder"],
        "wer_pct": 100.0 * scored["overall_wer"], "wder_pct": 100.0 * scored["overall_wder"],
        "n_words": int(sum(scored["n_words"])), "dist": int(sum(scored["dist"])),
        "test_loss": record["test_end"]["test_loss"],
        "batch_losses": [b["loss"] for b in record["batches"]],
        "seconds": {"split": t_split, "cli_test": t_test, "total": time.perf_counter() - t0},
        "segments": segments,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(fixture, f, indent=1)
        f.write("\n")
    with open(os.path.join(ROOT, "ACCURACY.json")) as f:
        published = json.load(f)
    print(json.dumps({k: fixture[k] for k in (
        "n_segments", "n_batches", "wer_pct", "wder_pct", "test_loss", "seconds")}))
    print(f"ACCURACY.json (f32 checkpoint, not in the repository; no gate): "
          f"WER {published['wer_pct']} / WDER {published['wder_pct']}")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
