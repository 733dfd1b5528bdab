#!/usr/bin/env python3
"""The reference figures of first diarization (UIS-RNN, the wav2vec
extractor, diar-features), from the JAX package on the CPU.

    python3 scripts/torch_diar_reference.py [--sections features,wav2vec,kfold,steps,predict]

Writes tests/fixtures/torch_diar_reference.json, the arrays to
tests/fixtures/torch_diar_reference_arrays.npz and a UIS-RNN checkpoint to
tests/fixtures/torch_diar_reference_uisrnn.msgpack (JAX_PLATFORMS=cpu):

  (a) features: `cli.tools diar-features --features logmel` over the train
      split of scripts/ensure_corpus.sh cut to its first SPLIT episodes
      (seed 0, 120 s, 8 speakers): each episode's [utterances, 160]
      features and speaker ids;
  (b) wav2vec: `diar-features --features wav2vec --wav2vec-ckpt` over the
      split's first episode alone, with the fairseq-layout state dict of
      `seeded_fairseq_state_dict` converted by `convert_fairseq_weights`
      against `init_wav2vec`'s tree (full width, 512 channels);
  (c) kfold: `cli.uisrnn --mode kfold` on (a)'s pickles at
      scripts/uisrnn_der.sh's flags (obs 160, hidden 256, beam 6, look-ahead
      1, test-iteration 2, k 5) with --train-iteration cut to KFOLD_ITERS,
      at `kfold_experiment` seed 0 (the CLI) and seed 1: the DER band of
      the port's own initial draws rests on their spread;
  (d) steps: STEP_COUNT fit steps at a small width (STEP_CFG; the first
      STEP_CFG["observation_dim"] feature dimensions of (a)'s first three
      episodes): the state before each step and after the last (trainable
      leaves, Adam's moments and count), each step's batch, gradients and
      loss terms, recorded from JAX's own jitted step (`record_fit`);
  (e) predict: a UIS-RNN at PREDICT_CFG trained PREDICT_ITERS iterations on
      (a)'s episodes 2-9, saved (the .msgpack fixture), and its
      `predict_single` traces of episodes 0 and 1 at (c)'s inference flags.

`seeded_fairseq_state_dict`, `flat_tree` and `unflat_tree` need numpy
alone, so a machine without JAX (the card's, chip_smoke.py) rebuilds the
same inputs.

The committed fixture was made on an 8-core x86 CPU (no accelerator); its
`seconds` hold each section's time.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_diar_reference.json")
ARRAYS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_diar_reference_arrays.npz")
UISRNN_CKPT = os.path.join(ROOT, "tests", "fixtures", "torch_diar_reference_uisrnn.msgpack")

SPLIT = dict(n_episodes=10, episode_seconds=120.0, n_speakers=8, seed=0)
SPLIT_NOTE = "scripts/ensure_corpus.sh's train split (100 x 120 s, seed 0) cut to its first 10"
UISRNN_FLAGS = ["--observation-dim", "160", "--rnn-hidden-size", "256", "--k-folds", "5",
                "--beam-size", "6", "--look-ahead", "1", "--test-iteration", "2"]
KFOLD_ITERS = 500
KFOLD_SEEDS = (0, 1)
W2V_SEED = 0
STEP_CFG = dict(observation_dim=8, rnn_hidden_size=16, rnn_depth=2)
STEP_TRAIN = dict(batch_size=10, num_permutations=10)
STEP_COUNT = 5
STEP_EPISODES = 3
PREDICT_CFG = dict(observation_dim=160, rnn_hidden_size=32, rnn_depth=1)
PREDICT_ITERS = 300
PREDICT_INFER = dict(beam_size=6, look_ahead=1, test_iteration=2)
PREDICT_TEST = (0, 1)


def seeded_fairseq_state_dict(seed: int = W2V_SEED) -> dict:
    """A full-width wav2vec (v1) state dict in fairseq's layout (numpy f32,
    bias-free convolutions, Fp32GroupNorm affines): extractor block i as
    `feature_extractor.conv_layers.{i}.0.weight` [512, in, k] and `.2.weight`
    / `.2.bias` (a Dropout sits at index 1), aggregator block i as
    `feature_aggregator.conv_layers.{i}.1.weight` (a padding module at 0)
    and `.3.weight` / `.3.bias`; kernels normal / sqrt(k in), scales 1 + 0.1
    normal, biases 0.1 normal, drawn by `np.random.default_rng(seed)` in
    that order."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    sd = {}
    plans = (("feature_extractor", [(512, 10), (512, 8), (512, 4), (512, 4), (512, 4)], 0, 2),
             ("feature_aggregator", [(512, 3)] * 9, 1, 3))
    for prefix, plan, jc, jn in plans:
        cin = 1 if prefix == "feature_extractor" else 512
        for i, (dim, k) in enumerate(plan):
            base = f"{prefix}.conv_layers.{i}"
            sd[f"{base}.{jc}.weight"] = (rng.standard_normal((dim, cin, k))
                                         / np.sqrt(k * cin)).astype(f32)
            sd[f"{base}.{jn}.weight"] = (1 + 0.1 * rng.standard_normal(dim)).astype(f32)
            sd[f"{base}.{jn}.bias"] = (0.1 * rng.standard_normal(dim)).astype(f32)
            cin = dim
    return sd


def flat_tree(tree, prefix: str) -> dict:
    """A nested dict of arrays -> {prefix/a/b: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def unflat_tree(arrays, prefix: str) -> dict:
    """The inverse of `flat_tree` over the keys under `prefix/`."""
    out: dict = {}
    for key in arrays.keys():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arrays[key])
    return out


def leaves_of(tree, prefix=""):
    """(path, array) of every leaf of a nested dict, keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves_of(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def step_gaps(want: dict, got: dict, lr: float, eps: float = 1e-8) -> dict:
    """How far a fit step's state `got` lies from `want` (both
    {"trainable", "mu", "nu", "count"}): each leaf's largest error over its
    largest value, for the moments and for the trainable elements whose
    root mean square gradient sqrt(nu_hat) is at least 100 eps. Below
    that, Adam's step g / (|g| + eps) is decided by the gradient's rounding
    (a gradient that cancels to ~1e-5 of its leaf's largest, clipped by the
    global norm, is within a few eps of 0), so those elements are held to
    Adam's own bound, |error| <= lr: `noise_abs` is their largest error,
    `noise_elements` their count."""
    bc2 = float(np.float32(1) - np.float32(0.999) ** np.float32(want["count"]))
    out = {"trainable": 0.0, "mu": 0.0, "nu": 0.0, "noise_abs": 0.0, "noise_elements": 0}
    rel = lambda e, w: float(e.max() / max(np.abs(w).max(), 1e-30)) if e.size else 0.0
    nus = dict(leaves_of(want["nu"]))
    for part in ("mu", "nu", "trainable"):
        got_leaves = dict(leaves_of(got[part]))
        for path, w in leaves_of(want[part]):
            err = np.abs(w - got_leaves[path])
            if part != "trainable":
                out[part] = max(out[part], rel(err, w))
                continue
            noise = np.sqrt(nus[path] / bc2) < 100 * eps
            out["trainable"] = max(out["trainable"], rel(err[~noise], w))
            if noise.any():
                out["noise_abs"] = max(out["noise_abs"], float(err[noise].max()))
                out["noise_elements"] += int(noise.sum())
    out["noise_bound"] = lr
    return out


def load_episodes(arrays, ids) -> list:
    """[(features [n, 160], speaker ids)] of section (a), by episode."""
    return [(np.asarray(arrays[f"features/ep{i}"]), ids[f"ep{i}"])
            for i in range(len(ids))]


def record_fit(model, seqs, ids, args):
    """`model.fit(seqs, ids, args)` with every jitted train step recorded:
    [{"state": {"trainable", "mu", "nu", "count"} in, "x", "truth",
    "grads", "loss", "aux", "out": the state after}], numpy."""
    import jax
    import optax

    steps, grads = [], []
    real_jit, real_chain = jax.jit, optax.chain

    def state_of(tr, opt):
        adam = opt[1][0]
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)
        return {"trainable": host(tr), "mu": host(adam.mu), "nu": host(adam.nu),
                "count": int(adam.count)}

    def recording_jit(fn):
        jitted = real_jit(fn)

        def call(tr, opt, x, truth, mask):
            out = jitted(tr, opt, x, truth, mask)
            steps.append({"state": state_of(tr, opt), "x": np.asarray(x),
                          "truth": np.asarray(truth), "loss": float(out[2]),
                          "aux": [float(a) for a in out[3]],
                          "out": state_of(out[0], out[1])})
            return out
        return call

    def recording_chain(*parts):
        tx = real_chain(*parts)

        def update(g, state, params=None):
            jax.debug.callback(lambda g: grads.append(
                jax.tree_util.tree_map(np.asarray, g)), g)
            return tx.update(g, state, params)
        return optax.GradientTransformation(tx.init, update)

    jax.jit, optax.chain = recording_jit, recording_chain
    try:
        model.fit(seqs, ids, args)
    finally:
        jax.jit, optax.chain = real_jit, real_chain
    assert len(grads) == len(steps), (len(grads), len(steps))
    for s, g in zip(steps, grads):
        s["grads"] = g
    return steps


def features(tmp: str):
    """Section (a). Returns (section, arrays)."""
    import pickle

    from tal_asrd_tpu.cli import tools
    from tal_asrd_tpu.data.synth import build_synth_corpus

    split = os.path.join(tmp, "split")
    build_synth_corpus(split, **SPLIT)
    out = os.path.join(tmp, "diarfeat")
    tools.main(["diar-features", "--data", split, "--out-dir", out, "--features", "logmel"])
    arrays, ids, n_utts = {}, {}, {}
    for i in range(SPLIT["n_episodes"]):
        with open(os.path.join(out, f"ep{i}.pkl"), "rb") as f:
            feats, spk = pickle.load(f)
        arrays[f"features/ep{i}"] = np.asarray(feats, np.float32)
        ids[f"ep{i}"] = list(spk)
        n_utts[f"ep{i}"] = len(spk)
    return {"split": SPLIT, "split_note": SPLIT_NOTE, "ids": ids, "utterances": n_utts,
            "dim": int(arrays["features/ep0"].shape[1])}, arrays


def wav2vec(tmp: str):
    """Section (b). Returns (section, arrays)."""
    import pickle

    from tal_asrd_tpu.cli import tools
    from tal_asrd_tpu.core.checkpoint import save_pytree
    from tal_asrd_tpu.data.synth import build_synth_corpus
    from tal_asrd_tpu.diarization.wav2vec import convert_fairseq_weights, init_wav2vec

    split = os.path.join(tmp, "split1")
    build_synth_corpus(split, **dict(SPLIT, n_episodes=1))
    _, variables = init_wav2vec()
    tree = convert_fairseq_weights(seeded_fairseq_state_dict(), variables)
    ckpt = os.path.join(tmp, "w2v.msgpack")
    save_pytree(ckpt, tree)
    out = os.path.join(tmp, "w2vfeat")
    tools.main(["diar-features", "--data", split, "--out-dir", out, "--features", "wav2vec",
                "--wav2vec-ckpt", ckpt])
    with open(os.path.join(out, "ep0.pkl"), "rb") as f:
        feats, spk = pickle.load(f)
    return ({"episode": "ep0", "seed": W2V_SEED, "utterances": len(spk), "ids": list(spk),
             "made_by": "scripts/torch_diar_reference.py::seeded_fairseq_state_dict"},
            {"wav2vec/ep0": np.asarray(feats, np.float32)})


def kfold(tmp: str, arrays, ids):
    """Section (c). Returns (section, arrays)."""
    import pickle

    from tal_asrd_tpu.cli import uisrnn as cli_uisrnn
    from tal_asrd_tpu.diarization import (UISRNNConfig, UISRNNInferenceConfig,
                                          UISRNNTrainConfig, kfold_experiment)

    feat_dir = os.path.join(tmp, "kfold_feats")
    os.makedirs(feat_dir, exist_ok=True)
    for i, (feats, spk) in enumerate(load_episodes(arrays, ids)):
        with open(os.path.join(feat_dir, f"ep{i}.pkl"), "wb") as f:
            pickle.dump((feats, spk), f)
    runs = {}
    for seed in KFOLD_SEEDS:
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if seed == 0:        # the CLI itself
                cli_uisrnn.main(["--features", os.path.join(feat_dir, "*.pkl"), "--mode",
                                 "kfold", "--train-iteration", str(KFOLD_ITERS)]
                                + UISRNN_FLAGS)
            else:
                flags = dict(zip(UISRNN_FLAGS[::2], UISRNN_FLAGS[1::2]))
                acc, _ = kfold_experiment(
                    load_episodes(arrays, ids),
                    UISRNNConfig(observation_dim=int(flags["--observation-dim"]),
                                 rnn_hidden_size=int(flags["--rnn-hidden-size"])),
                    UISRNNTrainConfig(train_iteration=KFOLD_ITERS, batch_size=10),
                    UISRNNInferenceConfig(beam_size=int(flags["--beam-size"]),
                                          look_ahead=int(flags["--look-ahead"]),
                                          test_iteration=int(flags["--test-iteration"])),
                    k=int(flags["--k-folds"]), seed=seed)
                print(f"mean accuracy: {acc:.4f} (DER {1-acc:.4f})")
        text = buf.getvalue()
        line = [ln for ln in text.splitlines() if ln.startswith("mean accuracy:")][-1]
        fold_accs = [float(ln) for ln in text.splitlines() if ln.startswith("  0.")
                     or ln.startswith("  1.")]
        der = float(line.split("DER ")[1].rstrip(")"))
        runs[str(seed)] = {"line": line, "der": der, "accuracies": fold_accs,
                           "seconds": time.perf_counter() - t0}
        print(json.dumps({"kfold_seed": seed, **runs[str(seed)]}), flush=True)
    ders = [r["der"] for r in runs.values()]
    return {"flags": UISRNN_FLAGS + ["--train-iteration", str(KFOLD_ITERS)],
            "seeds": list(KFOLD_SEEDS), "runs": runs,
            "der_spread": max(ders) - min(ders)}, {}


def steps(arrays, ids):
    """Section (d). Returns (section, arrays)."""
    from tal_asrd_tpu.diarization import UISRNN, UISRNNConfig, UISRNNTrainConfig

    d = STEP_CFG["observation_dim"]
    eps = load_episodes(arrays, ids)[:STEP_EPISODES]
    model = UISRNN(UISRNNConfig(**STEP_CFG), seed=0)
    args = UISRNNTrainConfig(train_iteration=STEP_COUNT, log_iter=1, **STEP_TRAIN)
    rec = record_fit(model, [f[:, :d] for f, _ in eps], [s for _, s in eps], args)
    out = {}
    states = [s["state"] for s in rec] + [rec[-1]["out"]]     # step i's output: state i + 1
    for i, state in enumerate(states):
        for part in ("mu", "nu", "trainable"):
            out.update(flat_tree(state[part], f"steps/state{i}/{part}"))
    for i, s in enumerate(rec):
        out.update(flat_tree(s["grads"], f"steps/{i}/grads"))
        out[f"steps/{i}/x"] = s["x"]
        out[f"steps/{i}/truth"] = s["truth"]
    return ({"cfg": STEP_CFG, "train": STEP_TRAIN, "count": STEP_COUNT,
             "episodes": STEP_EPISODES, "transition_bias": model.transition_bias,
             "losses": [s["loss"] for s in rec], "aux": [s["aux"] for s in rec],
             "counts": [s["count"] for s in states]}, out)


def predict(arrays, ids):
    """Section (e). Returns (section, arrays)."""
    from tal_asrd_tpu.diarization import (UISRNN, UISRNNConfig, UISRNNInferenceConfig,
                                          UISRNNTrainConfig)

    eps = load_episodes(arrays, ids)
    train = [e for i, e in enumerate(eps) if i not in PREDICT_TEST]
    model = UISRNN(UISRNNConfig(**PREDICT_CFG), seed=0)
    losses = model.fit([f for f, _ in train], [s for _, s in train],
                       UISRNNTrainConfig(train_iteration=PREDICT_ITERS, batch_size=10))
    model.save(UISRNN_CKPT)
    traces, seconds = {}, {}
    for i in PREDICT_TEST:
        t0 = time.perf_counter()
        traces[f"ep{i}"] = [int(c) for c in model.predict_single(
            eps[i][0], UISRNNInferenceConfig(**PREDICT_INFER))]
        seconds[f"ep{i}"] = time.perf_counter() - t0
    return ({"cfg": PREDICT_CFG, "iterations": PREDICT_ITERS, "infer": PREDICT_INFER,
             "test_episodes": list(PREDICT_TEST), "train_episodes":
                 [i for i in range(len(eps)) if i not in PREDICT_TEST],
             "checkpoint": os.path.relpath(UISRNN_CKPT, ROOT), "last_nll": losses[-1],
             "transition_bias": model.transition_bias, "traces": traces,
             "predict_seconds": seconds}, {})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default="features,wav2vec,kfold,steps,predict")
    args = ap.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [ROOT]
    import jax
    jax.config.update("jax_platforms", "cpu")

    fixture, arrays = {}, {}
    if os.path.exists(FIXTURE):
        with open(FIXTURE) as f:
            fixture = json.load(f)
    if os.path.exists(ARRAYS_NPZ):
        arrays = dict(np.load(ARRAYS_NPZ))
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    fixture.update(what="JAX CPU reference of first diarization "
                        "(scripts/torch_diar_reference.py)")
    tmp = tempfile.mkdtemp()
    try:
        for name in args.sections.split(","):
            t0 = time.perf_counter()
            if name == "features":
                fixture[name], new = features(tmp)
            elif name == "wav2vec":
                fixture[name], new = wav2vec(tmp)
            elif name == "kfold":
                fixture[name], new = kfold(tmp, arrays, fixture["features"]["ids"])
            elif name == "steps":
                fixture[name], new = steps(arrays, fixture["features"]["ids"])
            elif name == "predict":
                fixture[name], new = predict(arrays, fixture["features"]["ids"])
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
