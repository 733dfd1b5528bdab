#!/usr/bin/env python3
"""The reference figures of the speaker baseline (SDModel / SDSystem), from
the JAX package on the CPU.

    python3 scripts/torch_sd_reference.py [--sections features,train]

Writes tests/fixtures/torch_sd_reference.json and, for the arrays,
tests/fixtures/torch_sd_reference_arrays.npz. Both sections run the JAX
package's SDSystem in float32 (JAX_PLATFORMS=cpu) on the full-width tree of
`seeded_sd_tree`: the tracked checkpoint's TDS encoder
(accuracy_release/avg_last_3.bf16.msgpack, the same TDS as SDModelConfig's)
under seeded `spk_embed_proj` [1440, 128] and `spk_logit_proj`
[128, 6008]:

  (a) features: `frame_features` on the first two samples of
      `SDUtteranceDataset` over the test split (scripts/ensure_corpus.sh's,
      seed 202), collated by `SDCollater` into one ragged batch: the
      embeddings, the argmax ids, the gap between each frame's two largest
      logits (a gap under 1e-5 is a near-tie) and the padding mask;
  (b) train: 6 LAMB steps of `SDSystem` (dropout 0, SpecAugment off,
      TrainConfig(batch_size=4, lr=1e-4): constant lr 2e-4) on the first
      four samples of `SDUtteranceDataset(max_segment_duration=10)` over the
      train split (ensure_corpus.sh's, cut to 8 episodes), padded to 10 s:
      each step's loss and spk_acc.

`seeded_sd_tree` needs numpy alone, so a machine without JAX (the card's,
chip_smoke.py) rebuilds the same tree from the tracked checkpoint.

The committed fixture was made on an 8-core x86 CPU (no accelerator); its
`seconds` hold each section's time.
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
CHECKPOINT = "accuracy_release/avg_last_3.bf16.msgpack"
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_sd_reference.json")
ARRAYS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_sd_reference_arrays.npz")

SEED = 0
EMBED_GAIN = 0.01       # the tracked encoder's output has an rms near 150
NUM_SPEAKERS, EMBED_SIZE, ENC_CHANNELS = 6008, 128, 1440
TEST_SPLIT = dict(n_episodes=4, episode_seconds=180.0, n_speakers=8, seed=202)
TRAIN_SPLIT = dict(n_episodes=8, episode_seconds=120.0, n_speakers=8, seed=0)
FEATURE_ITEMS = (0, 1)
TRAIN_ITEMS, TRAIN_MAX_SECS, TRAIN_STEPS = 4, 10.0, 6
TRAIN_CFG = dict(batch_size=4, lr=1e-4)


def as_float32(a) -> np.ndarray:
    """A checkpoint leaf as float32: bfloat16 arrays (ml_dtypes) and the
    port's tagged uint16 bit patterns are widened exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    meta = a.dtype.metadata
    if meta is not None and meta.get("bits_of") == "bfloat16":
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def seeded_sd_tree(tracked_tree: dict, seed: int = SEED, num_speakers: int = NUM_SPEAKERS,
                   embed_size: int = EMBED_SIZE, enc_channels: int = ENC_CHANNELS,
                   embed_gain: float = EMBED_GAIN) -> dict:
    """An SDModel parameter tree (flax names and layouts, float32): the
    `encoder` of `tracked_tree` (a speaker-token checkpoint's params) widened
    to float32, and the two heads drawn by `np.random.default_rng(seed)` in
    this order: spk_embed_proj kernel [enc, embed] (normal x embed_gain /
    sqrt(enc): the tracked encoder's output has an rms near 150, and the
    gain brings the embeddings near unit scale) and bias (normal x 0.02),
    spk_logit_proj kernel [embed, speakers] (normal / sqrt(embed)) and bias
    (normal x 0.02)."""
    if set(tracked_tree) == {"params"}:
        tracked_tree = tracked_tree["params"]
    rng = np.random.default_rng(seed)

    def dense(fan_in, fan_out, gain=1.0):
        return {"kernel": (rng.standard_normal((fan_in, fan_out)) * gain / np.sqrt(fan_in))
                .astype(np.float32),
                "bias": (rng.standard_normal((fan_out,)) * 0.02).astype(np.float32)}

    def widen(node):
        return {k: widen(v) if isinstance(v, dict) else as_float32(v)
                for k, v in node.items()}

    return {"encoder": widen(tracked_tree["encoder"]),
            "spk_embed_proj": dense(enc_channels, embed_size, embed_gain),
            "spk_logit_proj": dense(embed_size, num_speakers)}


def split_dirs(tmp: str):
    """The test and train splits, built with the JAX package's synthesiser."""
    from tal_asrd_tpu.data.synth import build_synth_corpus
    test, train = os.path.join(tmp, "test"), os.path.join(tmp, "train")
    build_synth_corpus(test, **TEST_SPLIT)
    build_synth_corpus(train, **TRAIN_SPLIT)
    return test, train


def jax_system(tree: dict):
    import jax
    import jax.numpy as jnp
    from tal_asrd_tpu.baseline import SDSystem
    from tal_asrd_tpu.core.config import SDModelConfig, SpecAugmentConfig, TrainConfig
    system = SDSystem(SDModelConfig(dropout=0.0), TrainConfig(**TRAIN_CFG),
                      specaug_cfg=SpecAugmentConfig(num_freq_masks=0, num_time_masks=0),
                      dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return system, params


def features(tree: dict, test: str):
    """Section (a). Returns (section, arrays)."""
    import jax
    import jax.numpy as jnp
    from tal_asrd_tpu.models.sd import SDModel
    from tal_asrd_tpu.data import SDCollater, SDUtteranceDataset
    system, params = jax_system(tree)
    ds = SDUtteranceDataset(test, speaker_map_loc=os.path.join(test, "speaker_map.json"))
    batch = SDCollater()([ds[i] for i in FEATURE_ITEMS])
    emb, ids, pad = system.frame_features(params, batch["audio"], batch["audio_lens"])
    enc = system.model.apply({"params": params}, jnp.asarray(batch["audio"]),
                             jnp.asarray(batch["audio_lens"]), False, method=SDModel.encode)
    logits = np.asarray(system.model.apply({"params": params}, enc, False,
                                           method=SDModel.decode))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    section = {"items": list(FEATURE_ITEMS), "audio_lens": batch["audio_lens"].tolist(),
               "audio_shape": list(batch["audio"].shape), "speaker": batch["speaker"].tolist(),
               "frames": list(emb.shape[:2]), "jax": jax.__version__}
    return section, {"features/emb": np.asarray(emb, np.float32), "features/ids": ids,
                     "features/top2_gap": (top2[..., 1] - top2[..., 0]).astype(np.float32),
                     "features/pad": pad}


def train(tree: dict, train_dir: str):
    """Section (b). Returns (section, arrays)."""
    import jax
    from tal_asrd_tpu.data import SDCollater, SDUtteranceDataset
    from tal_asrd_tpu.train.system import TrainState
    system, params = jax_system(tree)
    ds = SDUtteranceDataset(train_dir, speaker_map_loc=os.path.join(train_dir,
                                                                      "speaker_map.json"),
                            max_segment_duration=TRAIN_MAX_SECS)
    batch = SDCollater(audio_bucket_seconds=(TRAIN_MAX_SECS,))(
        [ds[i] for i in range(TRAIN_ITEMS)])
    state = TrainState(step=jax.numpy.zeros((), jax.numpy.int32), params=params,
                       opt_state=system.tx.init(params))
    step = system.make_train_step()
    losses, accs = [], []
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["spk_acc"]))
        print(f"step {i}: loss {losses[-1]:.6f} acc {accs[-1]:.4f}", flush=True)
    return {"items": TRAIN_ITEMS, "max_secs": TRAIN_MAX_SECS, "steps": TRAIN_STEPS,
            "train_cfg": TRAIN_CFG, "audio_lens": batch["audio_lens"].tolist(),
            "speaker": batch["speaker"].tolist(), "losses": losses, "spk_acc": accs}, {}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default="features,train")
    args = ap.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [ROOT]
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree

    fixture, arrays = {}, {}
    if os.path.exists(FIXTURE):
        with open(FIXTURE) as f:
            fixture = json.load(f)
    if os.path.exists(ARRAYS_NPZ):
        arrays = dict(np.load(ARRAYS_NPZ))
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    fixture.update(what="JAX CPU reference of the speaker baseline "
                        "(scripts/torch_sd_reference.py)",
                   tree={"checkpoint": CHECKPOINT, "seed": SEED, "num_speakers": NUM_SPEAKERS,
                         "embed_size": EMBED_SIZE, "embed_gain": EMBED_GAIN,
                         "made_by": "scripts/torch_sd_reference.py::seeded_sd_tree"},
                   splits={"test": TEST_SPLIT, "train": TRAIN_SPLIT})
    tree = seeded_sd_tree(load_pytree(os.path.join(ROOT, CHECKPOINT)))
    with tempfile.TemporaryDirectory() as tmp:
        test, train_dir = split_dirs(tmp)
        for name in args.sections.split(","):
            t0 = time.perf_counter()
            if name == "features":
                fixture[name], new = features(tree, test)
            elif name == "train":
                fixture[name], new = train(tree, train_dir)
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
