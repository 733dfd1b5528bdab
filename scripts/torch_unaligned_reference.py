#!/usr/bin/env python3
"""The reference figures of the long-form evaluation, from the JAX package on the CPU.

    python3 scripts/torch_unaligned_reference.py
        [--out tests/fixtures/torch_unaligned_eval_reference.json]
        [--legs vad,sm] [--sm-flags "--eos-advance --stall-patience 8 --stall-rollback"]

Builds the synthetic test split (`tal_asrd_tpu.data.synth.build_synth_corpus`,
seed 202, 4 episodes of 180 s, 8 speakers, as scripts/ensure_corpus.sh makes
it) in a temporary directory, then runs the JAX package's unaligned chain with
the flags of scripts/accuracy.sh's unaligned leg, each step in its own
process with JAX_PLATFORMS=cpu, for two legs:

  (a) vad: `python -m tal_asrd_tpu.cli.test ... --num-workers 0 --unaligned
      --vad-windows` (accuracy.sh's default UNALIGNED_FLAGS): per episode the
      VAD decode windows (sample bounds) and each window's beam-5 tokens;
  (b) sm: `python -m tal_asrd_tpu.cli.test ... --num-workers 0 --unaligned`
      [--sm-flags]: the sliding-window state machine, the split's 4
      equal-length episodes in one lockstep group of 4 lanes; per episode
      its tokens, `iters`, the `align_chunk` trajectory, the argmax of each
      `align_attn` row and the window moves read from the trajectory;

each followed by

    python -m tal_asrd_tpu.cli.tools wder-format --test-result OUT/test_result.pkl
        --out OUT/wder_ready.pkl
    python -m tal_asrd_tpu.cli.wder --eval-file OUT/wder_ready.pkl --workers 1

The CLI runs under a recorder that only reads what the decode functions
return; it changes nothing the CLI computes. The fixture holds each leg's
WER, WDER, its records, its commands and its seconds, and the git commit.
ACCURACY.json's long-form figures (56.85 / 17.79, `--vad-windows`) come from
the f32 checkpoint, which is not in the repository: they are printed beside
the result and are no gate.

The committed fixture was made on an 8-core x86 CPU (no accelerator) in
121 s: 4.0 s for the split, 64.6 s for the VAD leg (57.5 s of it the CLI:
the 1x model in bf16, 129 windows in 13 beam-5 batches, one jit-compiled
search per bucket) and 52.3 s for the state machine at its defaults (45.5
s the CLI: the 4 episodes in one vmapped group of 4 lanes, 151-327 steps
each); the fixture's `seconds` holds them.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shlex
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = "accuracy_release/avg_last_3.bf16.msgpack"
TOKENIZER = "accuracy_release/bpe.model"
SPLIT = dict(n_episodes=4, episode_seconds=180.0, n_speakers=8, seed=202)

# Runs in the child: cli.test.main under a recorder of the decode outputs.
RECORDER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import tal_asrd_tpu.eval.runner as runner_mod
import tal_asrd_tpu.vad.windows as windows_mod
from tal_asrd_tpu.cli import test as cli_test

record = {"episodes": [], "calls": []}
Runner = runner_mod.EvalRunner

orig_windows = windows_mod.vad_decode_windows
def vad_decode_windows(*args, **kwargs):
    w = orig_windows(*args, **kwargs)
    record["episodes"].append({"windows": [[int(s), int(e)] for s, e in w], "calls": []})
    return w
windows_mod.vad_decode_windows = vad_decode_windows

orig_generate = Runner._generate_fn
def generate_fn(self, shape, max_new):
    run = orig_generate(self, shape, max_new)
    def recorded(variables, audio, lens, prime):
        out = run(variables, audio, lens, prime)
        record["episodes"][-1]["calls"].append({
            "shape": list(shape), "max_new": max_new, "lens": np.asarray(lens).tolist(),
            **{k: np.asarray(out[k]).tolist() for k in ("tokens", "lengths", "found")}})
        return out
    return recorded
Runner._generate_fn = generate_fn

def lanes_of(out, lanes):
    for lane in range(lanes):
        n = int(np.asarray(out["num_tokens"])[lane]) if lanes > 1 or np.ndim(out["num_tokens"]) else int(out["num_tokens"])
        tok = np.asarray(out["tokens"])[lane] if lanes > 1 else np.asarray(out["tokens"])[0]
        chunk = np.asarray(out["align_chunk"])[lane] if lanes > 1 else np.asarray(out["align_chunk"])
        attn = np.asarray(out["align_attn"], np.float32)
        attn = attn[lane] if lanes > 1 else attn
        iters = np.asarray(out["iters"])
        record["episodes"].append({
            "tokens": tok[:n].tolist(), "num_tokens": n,
            "iters": int(iters[lane] if iters.ndim else iters),
            "align_chunk": chunk[: n - 1].tolist(),
            "align_attn_argmax": attn[: n - 1].argmax(-1).tolist(),
            "align_attn_rowsum": attn[: n - 1].sum(-1).tolist()})

orig_batched = runner_mod.unaligned_decode_batched
def unaligned_decode_batched(*args, **kwargs):
    out = orig_batched(*args, **kwargs)
    lanes_of(out, int(np.asarray(out["num_tokens"]).shape[0]))
    record["calls"].append({"kind": "batched", "spec": repr(args[4])})
    return out
runner_mod.unaligned_decode_batched = unaligned_decode_batched

orig_single = runner_mod.unaligned_decode
def unaligned_decode(*args, **kwargs):
    out = orig_single(*args, **kwargs)
    lanes_of(out, 1)
    record["calls"].append({"kind": "single", "spec": repr(args[4])})
    return out
runner_mod.unaligned_decode = unaligned_decode

cli_test.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump(record, f)
"""


def run(cmd, env):
    print("+", " ".join("<recorder>" if c == RECORDER else c for c in cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=ROOT, env=env)


def window_moves(chunks, chunk_size=357, shift_prct=0.25, skip_prct=0.1):
    """Moves of the window read from an align_chunk trajectory: by the shift
    amount, by the skip amount (a reset), or by another amount (a move cut
    at the last window, or an EOS advance)."""
    shift, skip = int(chunk_size * shift_prct), int(chunk_size * skip_prct)
    moves = {"shift": 0, "skip": 0, "other": 0}
    for a, b in zip(chunks[:-1], chunks[1:]):
        if b != a:
            moves["shift" if b - a == shift else "skip" if b - a == skip else "other"] += 1
    return moves


def vad_windows_of(episode, sr=16000):
    """Each window's bounds and tokens, in window order: the calls' rows
    mapped back to windows as EvalRunner.test_step_unaligned_vad groups them
    (by bucket, ascending; window order inside a bucket; batches of the
    call's row count)."""
    buckets = [int(s * sr) for s in (5, 10, 20, 30)]
    by_bucket = {}
    for w_ix, (s, e) in enumerate(episode["windows"]):
        bucket = next((b for b in buckets if e - s <= b), buckets[-1])
        by_bucket.setdefault(bucket, []).append(w_ix)
    lanes = episode["calls"][0]["shape"][0] if episode["calls"] else 1
    groups = [(bucket, ixs[g:g + lanes]) for bucket, ixs in sorted(by_bucket.items())
              for g in range(0, len(ixs), lanes)]
    if len(groups) != len(episode["calls"]):
        raise SystemExit(f"{len(episode['calls'])} decode calls for {len(groups)} batches")
    out = [None] * len(episode["windows"])
    for (bucket, part), call in zip(groups, episode["calls"]):
        for r, w_ix in enumerate(part):
            s, e = episode["windows"][w_ix]
            if call["shape"][1] != bucket or call["lens"][r] != min(e - s, bucket):
                raise SystemExit(f"window {w_ix}: row {r} of a call at {call['shape']} "
                                 f"holds {call['lens'][r]} samples, not {e - s}")
            n = call["lengths"][r]
            out[w_ix] = {"start": s, "end": e, "bucket": bucket, "max_new": call["max_new"],
                         "tokens": call["tokens"][r][:n], "length": n,
                         "found": call["found"][r]}
    return out


def run_leg(name, flags, split, tmp, env, test_args_of):
    out = os.path.join(tmp, f"out-{name}")
    test_args = test_args_of(out) + flags
    rec_path = os.path.join(tmp, f"record-{name}.json")
    t0 = time.perf_counter()
    run([sys.executable, "-c", RECORDER, rec_path] + test_args, env)
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
    leg = {
        "commands": [
            "JAX_PLATFORMS=cpu python -m tal_asrd_tpu.cli.test " + " ".join(
                test_args).replace(split, "SPLIT").replace(out, "OUT"),
            "python -m tal_asrd_tpu.cli.tools wder-format --test-result OUT/test_result.pkl "
            "--out OUT/wder_ready.pkl",
            "python -m tal_asrd_tpu.cli.wder --eval-file OUT/wder_ready.pkl --workers 1"],
        "flags": flags,
        "overall_wer": scored["overall_wer"], "overall_wder": scored["overall_wder"],
        "wer_pct": 100.0 * scored["overall_wer"], "wder_pct": 100.0 * scored["overall_wder"],
        "n_words": int(sum(scored["n_words"])), "dist": int(sum(scored["dist"])),
        "seconds_cli": t_test, "seconds": time.perf_counter() - t0,
    }
    if name == "vad":
        leg["episodes"] = [{"windows": vad_windows_of(ep)} for ep in record["episodes"]]
    else:
        leg["calls"] = record["calls"]
        leg["episodes"] = [dict(ep, window_moves=window_moves(ep["align_chunk"]))
                           for ep in record["episodes"]]
    return leg


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "fixtures", "torch_unaligned_eval_reference.json"))
    ap.add_argument("--legs", default="vad,sm")
    ap.add_argument("--sm-flags", default="",
                    help="extra state-machine flags for leg (b), e.g. "
                         "'--eos-advance --stall-patience 8 --stall-rollback'")
    args = ap.parse_args()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        split = os.path.join(tmp, "test")
        sys.path.insert(0, ROOT)
        from tal_asrd_tpu.data.synth import build_synth_corpus
        build_synth_corpus(split, **SPLIT)
        t_split = time.perf_counter() - t0

        def test_args_of(out):
            return ["--train-data", split, "--valid-data", split, "--test-data", split,
                    "--tokenizer", TOKENIZER, "--model-type", "1x", "--num-speakers", "8",
                    "--num-workers", "0", "--unaligned", "--load", CHECKPOINT,
                    "--out-dir", out]

        for name in args.legs.split(","):
            flags = ["--vad-windows"] if name == "vad" else shlex.split(args.sm_flags)
            legs[name] = run_leg(name, flags, split, tmp, env, test_args_of)
            print(json.dumps({name: {k: legs[name][k] for k in (
                "wer_pct", "wder_pct", "n_words", "seconds")}}), flush=True)

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    fixture = {
        "what": "JAX CPU reference of the long-form evaluation "
                "(scripts/torch_unaligned_reference.py)",
        "commit": commit,
        "split": dict(SPLIT, made_by="tal_asrd_tpu.data.synth.build_synth_corpus"),
        "checkpoint": CHECKPOINT, "tokenizer": TOKENIZER,
        "seconds": {"split": t_split, **{k: v["seconds"] for k, v in legs.items()},
                    "total": time.perf_counter() - t0},
        "legs": legs,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(fixture, f, indent=None, separators=(",", ":"))
        f.write("\n")
    with open(os.path.join(ROOT, "ACCURACY.json")) as f:
        published = json.load(f)
    print(f"ACCURACY.json (f32 checkpoint, not in the repository; no gate): "
          f"unaligned WER {published['unaligned_wer_pct']} / WDER "
          f"{published['unaligned_wder_pct']} ({published['unaligned_flags']})")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
