#!/usr/bin/env python3
"""The reference trajectories of RAdam, Adafactor and Lookahead on the
tracked checkpoint's leaves, from the JAX package on the CPU.

    python3 scripts/torch_optim_reference.py

Writes tests/fixtures/torch_optim_reference.json and, for the arrays,
tests/fixtures/torch_optim_reference.npz (JAX_PLATFORMS=cpu): one leaf of
each layout of the tracked checkpoint (accuracy_release/avg_last_3.bf16.msgpack,
in float32) — a TDS grouped-conv kernel, a pointwise kernel, a decoder
Dense kernel, the embedding, a bias and a ReZero scalar — through STEPS
optax steps of each optimizer configuration of `chip_smoke.py --phases
optim` (CONFIGS), at the learning-rate schedule of ASRSystem at B = 16
(`TrainConfig(batch_size=16, max_steps=STEPS)`: linear decay from 4e-4).
Step s's gradients are `leaf_gradients(leaves, s)`: N(0, 1) draws of
np.random.RandomState(SEED + s), leaf after leaf in LEAVES' order, each
scaled by a tenth of its leaf's RMS.

Stored, for each configuration: the final leaves and every state leaf
(the moments, Lookahead's slow weights), flattened to '/'-joined paths.
A leaf over SAMPLE_ABOVE entries is stored as `sample(x)` (every
stride-th entry of the flattened leaf) with its float64 sum of squares;
every leaf's largest magnitude is stored beside it. And each step's
update of each leaf (`tx.update`'s output, before `optax.apply_updates`
adds it) as `sample(u, UPDATE_SAMPLE)`, the steps stacked, with each
step's largest magnitude over the whole leaf: at the schedule's 4e-4 the
eight steps move a leaf by about 1e-4 of its largest value, too little
for its final value to show the update rule (RAdam's rectified steps in
particular) above float32's rounding.

`leaf_gradients`, `sample` and `flat_state` import numpy alone:
`chip_smoke.py` replays the trajectories on the card with them.
The committed fixture was made on an 8-core x86 CPU (no accelerator).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_optim_reference.json")
ARRAYS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_optim_reference.npz")
CKPT = os.path.join("accuracy_release", "avg_last_3.bf16.msgpack")
SEED = 1234
STEPS = 8
BATCH = 16
SAMPLE_ABOVE = 65536
SAMPLE_SIZE = 4096
UPDATE_SAMPLE = 1024
LEAVES = ["encoder/group_0_block_0/conv/kernel",      # grouped conv [21, 10, 800]
          "encoder/group_0_block_0/fc1/kernel",       # pointwise [1, 800, 800]
          "decoder/layers_0/linear1/kernel",          # Dense [256, 1024]
          "embedding/embedding",                      # [308, 64]
          "decoder/layers_0/linear1/bias",            # [1024]
          "decoder/layers_0/resweight"]               # ReZero scalar []
# name -> (optimizer, keyword arguments); "schedule" stands for the system's
CONFIGS = {
    "radam": ("radam", {"learning_rate": "schedule"}),
    "adafactor": ("adafactor", {}),
    "adafactor_b1_wd": ("adafactor", {"learning_rate": "schedule", "relative_step": False,
                                      "beta1": 0.9, "weight_decay": 0.01}),
    "lookahead_lamb": ("lookahead", {"inner": ("lamb", {"learning_rate": "schedule"})}),
    "lookahead_radam": ("lookahead", {"inner": ("radam", {"learning_rate": "schedule"})}),
}


def leaf_gradients(leaves, step):
    """Step `step`'s gradients (float32), one for each of `leaves` (float32
    arrays in LEAVES' order), in the same order."""
    rng = np.random.RandomState(SEED + step)
    out = []
    for x in leaves:
        scale = np.float32(0.1) * np.sqrt(np.mean(np.square(x, dtype=np.float64))
                                          ).astype(np.float32)
        out.append((rng.standard_normal(np.shape(x)).astype(np.float32) * scale))
    return out


def sample(x, size=SAMPLE_SIZE):
    """Every stride-th entry of the flattened x (about `size` of them), and
    the stride."""
    flat = np.asarray(x).reshape(-1)
    stride = max(1, flat.size // size)
    return flat[::stride].copy(), stride


def flat_state(tree, prefix=""):
    """{path: array} of a nested state: dicts, NamedTuples and arrays."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_state(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def store(arrays, record, key, x):
    """x (the final value of `key`) into the npz arrays and the JSON record."""
    x = np.asarray(x, np.float32)
    entry = {"shape": list(x.shape), "max_abs": float(np.max(np.abs(x))) if x.size else 0.0}
    if x.size > SAMPLE_ABOVE:
        arrays[key], entry["stride"] = sample(x)
        entry["sumsq"] = float(np.sum(np.square(x, dtype=np.float64)))
    else:
        arrays[key] = x
    record[key] = entry


def store_updates(arrays, record, key, steps):
    """Each step's update of one leaf (`steps`, in order) into the npz
    arrays ([steps, samples]) and the JSON record."""
    arrays[key] = np.stack([sample(np.asarray(u, np.float32), UPDATE_SAMPLE)[0]
                            for u in steps])
    record[key] = {"stride": sample(steps[0], UPDATE_SAMPLE)[1],
                   "max_abs": [float(np.max(np.abs(u))) for u in steps]}


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [ROOT]
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    from tal_asrd_tpu.core.checkpoint import load_pytree
    from tal_asrd_tpu.core.config import TrainConfig
    from tal_asrd_tpu.train import optimizers as opt
    from tal_asrd_tpu.train.schedules import linear_decay_schedule

    t0 = time.perf_counter()
    tree = load_pytree(os.path.join(ROOT, CKPT))
    leaves = []
    for path in LEAVES:
        node = tree
        for part in path.split("/"):
            node = node[part]
        leaves.append(np.asarray(jnp.asarray(node, jnp.float32)))
    tc = TrainConfig(batch_size=BATCH, max_steps=STEPS)
    schedule = linear_decay_schedule(tc.scaled_lr, STEPS)

    def build(name, kwargs):
        kwargs = dict(kwargs)
        if kwargs.get("learning_rate") == "schedule":
            kwargs["learning_rate"] = schedule
        if "inner" in kwargs:
            kwargs["inner"] = build(*kwargs["inner"])
        return {"radam": opt.radam, "adafactor": opt.adafactor, "lamb": opt.lamb,
                "lookahead": opt.lookahead}[name](**kwargs)

    grads = [leaf_gradients(leaves, s) for s in range(STEPS)]
    arrays, record, updates = {}, {}, {}
    for config, (name, kwargs) in CONFIGS.items():
        tx = build(name, kwargs)
        params = {p: jnp.asarray(x) for p, x in zip(LEAVES, leaves)}
        state = tx.init(params)
        steps = {p: [] for p in LEAVES}
        for s in range(STEPS):
            g = {p: jnp.asarray(x) for p, x in zip(LEAVES, grads[s])}
            upd, state = tx.update(g, state, params)
            for p in LEAVES:
                steps[p].append(np.asarray(upd[p]))
            params = optax.apply_updates(params, upd)
        for p in LEAVES:
            store(arrays, record, f"{config}/params/{p}", params[p])
            store_updates(arrays, updates, f"{config}/updates/{p}", steps[p])
        for k, x in flat_state(state).items():
            if np.issubdtype(x.dtype, np.floating):
                store(arrays, record, f"{config}/state/{k}", x)
            else:
                record[f"{config}/state/{k}"] = {"value": int(x)}
    np.savez_compressed(ARRAYS_NPZ, **arrays)
    with open(FIXTURE, "w") as f:
        json.dump({"checkpoint": CKPT, "seed": SEED, "steps": STEPS, "batch_size": BATCH,
                   "schedule": {"scaled_lr": tc.scaled_lr, "max_steps": STEPS},
                   "leaves": LEAVES, "configs": {k: [n, v] for k, (n, v) in CONFIGS.items()},
                   "sample_above": SAMPLE_ABOVE, "entries": record,
                   "update_sample": UPDATE_SAMPLE, "updates": updates,
                   "seconds": time.perf_counter() - t0}, f, indent=1)
    print(f"wrote {FIXTURE} and {ARRAYS_NPZ} in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
