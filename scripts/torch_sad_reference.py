#!/usr/bin/env python3
"""The reference figures of the neural SAD (PyanNet), from the JAX package
on the CPU.

    python3 scripts/torch_sad_reference.py [--sections corpus,scores,train]

Writes tests/fixtures/torch_sad_reference.json and, for the arrays,
tests/fixtures/torch_sad_reference_arrays.npz (JAX_PLATFORMS=cpu):

  (a) corpus: the SAD stress corpus as scripts/sad_stress.sh builds it
      (`build_sad_stress_corpus`: train 6 x 90 s seed 0, test 3 x 90 s
      seed 99): the sha256 of every file;
  (b) scores: `score_episode` (window 2 s, batch 16) of the full-size
      PyanNet on the tree of `seeded_pyannet_tree` over the test split's
      first episode (ep0);
  (c) train: 25 float32 Adam steps (optax.adam(1e-3), the mean
      sigmoid_binary_cross_entropy) from the same tree on the batches the
      SAD CLI draws with `np.random.default_rng(0)` (16 windows of 2 s from
      the stress train split): each step's loss; and the same run from a
      twin of the tree whose Dense_2 kernel is one ulp larger
      (`twin_losses`): how far rounding alone moves JAX's own losses, step
      by step (Adam amplifies it).

`seeded_pyannet_tree` needs numpy alone, so a machine without JAX (the
card's, chip_smoke.py) rebuilds the same tree.

The committed fixture was made on an 8-core x86 CPU (no accelerator); its
`seconds` hold each section's time.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_sad_reference.json")
ARRAYS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_sad_reference_arrays.npz")

SEED = 0
SPLITS = {"train": dict(n_episodes=6, episode_seconds=90.0, seed=0),
          "test": dict(n_episodes=3, episode_seconds=90.0, seed=99)}
WINDOW_S, SCORE_BATCH = 2.0, 16
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR, TRAIN_SEED = 25, 16, 1e-3, 0
LSTM, FF, CONV, SINC = 128, 128, 60, 80


def _mel_bands(n=SINC, sr=16000, min_low=50.0, min_band=50.0):
    """SincConv's initial cut-offs (vad/pyannet.py `_mel_spaced_bands`)."""
    to_mel = lambda hz: 2595.0 * np.log10(1.0 + hz / 700.0)
    to_hz = lambda mel: 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    edges = to_hz(np.linspace(to_mel(30.0), to_mel(sr / 2 - 100.0), n + 1))
    return (np.maximum(edges[:-1] - min_low, 0.0).astype(np.float32),
            np.maximum(np.diff(edges) - min_band, 0.0).astype(np.float32))


def seeded_pyannet_tree(seed: int = SEED) -> dict:
    """A full-size PyanNet parameter tree (flax names and layouts, float32):
    SincConv_0 at its mel-spaced initial cut-offs, and every other leaf
    drawn by `np.random.default_rng(seed)` in this order: LayerNorm_0-2
    (scale 1 + 0.1 normal, bias 0.1 normal), Conv_0-1 (kernel [5, in, out]
    normal / sqrt(5 in), bias 0.02 normal), OptimizedLSTMCell_0-3 (for each
    gate i, f, g, o: the input kernel [in, 128] normal / sqrt(in), the
    hidden kernel [128, 128] normal / sqrt(128), its bias 0.02 normal),
    Dense_0-2 (kernel normal / sqrt(in), bias 0.02 normal)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    low, band = _mel_bands()
    tree = {"SincConv_0": {"low_hz": low, "band_hz": band}}
    for i, n in enumerate((SINC, CONV, CONV)):
        tree[f"LayerNorm_{i}"] = {"scale": (1 + 0.1 * rng.standard_normal(n)).astype(f32),
                                  "bias": (0.1 * rng.standard_normal(n)).astype(f32)}
    for i, cin in enumerate((SINC, CONV)):
        tree[f"Conv_{i}"] = {
            "kernel": (rng.standard_normal((5, cin, CONV)) / np.sqrt(5 * cin)).astype(f32),
            "bias": (0.02 * rng.standard_normal(CONV)).astype(f32)}
    for c, cin in enumerate((CONV, CONV, 2 * LSTM, 2 * LSTM)):
        cell = {}
        for g in "ifgo":
            cell["i" + g] = {"kernel": (rng.standard_normal((cin, LSTM)) / np.sqrt(cin))
                             .astype(f32)}
            cell["h" + g] = {"kernel": (rng.standard_normal((LSTM, LSTM)) / np.sqrt(LSTM))
                             .astype(f32),
                             "bias": (0.02 * rng.standard_normal(LSTM)).astype(f32)}
        tree[f"OptimizedLSTMCell_{c}"] = cell
    for i, (cin, cout) in enumerate(((2 * LSTM, FF), (FF, FF), (FF, 1))):
        tree[f"Dense_{i}"] = {"kernel": (rng.standard_normal((cin, cout)) / np.sqrt(cin))
                              .astype(f32),
                              "bias": (0.02 * rng.standard_normal(cout)).astype(f32)}
    return tree


def file_hashes(root: str) -> dict:
    """sha256 of every file directly under `root`, by name."""
    out = {}
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def corpus(tmp: str):
    """Section (a), over the splits main() built. Returns (section, arrays)."""
    return {"splits": SPLITS,
            "sha256": {name: file_hashes(os.path.join(tmp, name)) for name in SPLITS}}, {}


def scores(tmp: str, tree: dict):
    """Section (b). Returns (section, arrays)."""
    from tal_asrd_tpu.data.audio_io import get_duration, load_audio_segment
    from tal_asrd_tpu.vad.pyannet import score_episode
    path = os.path.join(tmp, "test", "ep0.wav")
    wav = np.asarray(load_audio_segment(path, 0.0, get_duration(path), 16000), np.float32)
    s = score_episode(tree, wav, window_s=WINDOW_S, batch=SCORE_BATCH)
    return ({"episode": "test/ep0", "samples": int(len(wav)), "frames": int(len(s)),
             "window_s": WINDOW_S, "batch": SCORE_BATCH},
            {"scores/ep0": np.asarray(s, np.float32)})


def train(tmp: str, tree: dict):
    """Section (c): the SAD CLI's training loop (tal_asrd_tpu/cli/sad.py),
    from `tree` and from its one-ulp twin. Returns (section, arrays)."""
    twin = dict(tree, Dense_2=dict(tree["Dense_2"]))
    twin["Dense_2"]["kernel"] = np.nextafter(tree["Dense_2"]["kernel"], np.float32(np.inf))
    section = train_run(tmp, tree)
    section["twin_losses"] = train_run(tmp, twin)["losses"]
    section["twin"] = "Dense_2/kernel one ulp up (np.nextafter)"
    return section, {}


def train_run(tmp: str, tree: dict) -> dict:
    """TRAIN_STEPS of the SAD CLI's loop from `tree`."""
    import jax
    import jax.numpy as jnp
    import optax
    from tal_asrd_tpu.data.audio_io import get_duration, load_audio_segment
    from tal_asrd_tpu.data.transcript import load_transcripts
    from tal_asrd_tpu.vad.eval import utterance_gold_bounds
    from tal_asrd_tpu.vad.pyannet import FRAME_HOP, SAMPLE_RATE, PyanNet, frame_labels

    data_dir = os.path.join(tmp, "train")
    train_split = {}
    for stub, utts in load_transcripts(data_dir).items():
        path = os.path.join(data_dir, f"{stub}.wav")
        dur = get_duration(path)
        train_split[stub] = (np.asarray(load_audio_segment(path, 0.0, dur, SAMPLE_RATE),
                                        np.float32), utterance_gold_bounds(utts), dur)
    win = FRAME_HOP * max(1, round(WINDOW_S * SAMPLE_RATE / FRAME_HOP))
    rng = np.random.default_rng(TRAIN_SEED)
    model = PyanNet()
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = optax.adam(TRAIN_LR)
    opt_state = tx.init(params)

    def sample_batch():
        stubs = list(train_split)
        xs, ys = [], []
        for _ in range(TRAIN_BATCH):
            wav, bounds, _ = train_split[stubs[rng.integers(len(stubs))]]
            start = int(rng.integers(0, max(1, len(wav) - win)))
            xs.append(wav[start:start + win])
            ys.append(frame_labels(bounds, win, offset_s=start / SAMPLE_RATE))
        return jnp.asarray(np.stack(xs)), jnp.asarray(np.stack(ys))

    @jax.jit
    def step(params, opt_state, x, y):
        def loss_fn(p):
            logits = model.apply({"params": p}, x)
            return optax.sigmoid_binary_cross_entropy(logits, y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for i in range(TRAIN_STEPS):
        x, y = sample_batch()
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))
        print(f"step {i}: bce {losses[-1]:.6f}", flush=True)
    return {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "lr": TRAIN_LR, "seed": TRAIN_SEED,
            "window_samples": win, "losses": losses}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default="corpus,scores,train")
    args = ap.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [ROOT]
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tal_asrd_tpu.data.synth import build_sad_stress_corpus

    fixture, arrays = {}, {}
    if os.path.exists(FIXTURE):
        with open(FIXTURE) as f:
            fixture = json.load(f)
    if os.path.exists(ARRAYS_NPZ):
        arrays = dict(np.load(ARRAYS_NPZ))
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    fixture.update(what="JAX CPU reference of the neural SAD "
                        "(scripts/torch_sad_reference.py)",
                   tree={"seed": SEED,
                         "made_by": "scripts/torch_sad_reference.py::seeded_pyannet_tree"})
    tree = seeded_pyannet_tree()
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw in SPLITS.items():
            build_sad_stress_corpus(os.path.join(tmp, name), **kw)
        for name in args.sections.split(","):
            t0 = time.perf_counter()
            if name == "corpus":
                fixture[name], new = corpus(tmp)
            elif name == "scores":
                fixture[name], new = scores(tmp, tree)
            elif name == "train":
                fixture[name], new = train(tmp, tree)
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
