#!/usr/bin/env python3
"""The reference figures of the training CLI on a mesh, from the JAX package
on the CPU.

    python3 scripts/torch_parallel_reference.py

Writes tests/fixtures/torch_parallel_cli_reference.json and
tests/fixtures/torch_parallel_cli_reference_ckpts.npz: run 1 of
scripts/torch_train_reference.py's tiny CLI runs (TAL_TINY_ARCH, the same
corpus, seeded initial tree, patches and flags: 2 epochs of 4 steps at
batch 4, every step logged) with `--mesh-data 2 --mesh-model 2` on 4
virtual CPU devices and with `--mesh-data 2 --mesh-model 1` on 2, each in
its own process with JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=N. The JAX CLI scales the
learning rate by sqrt(2 x 4 x 1) in both (num_data_shards is the data
axis). Each section holds its arguments (paths as placeholders), per-step
and validation losses, spot-check texts, checkpoint and state names; the
.npz the last checkpoint's leaves as float16 differences from the initial
tree, keyed "<section>:<path>".

The JAX mesh step departs from its one-device step where both axes exceed
1 (the encoder's grouped-convolution gradients, see
tests/test_torch_parallel_train.py), so mesh_2x2's trajectory parts from
mesh_2x1's; the port's 2 x 2 run is held to mesh_2x1.

The committed fixture was made on an 8-core x86 CPU (no accelerator); the
seconds of each section are in it.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_parallel_cli_reference.json")
CKPTS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_parallel_cli_reference_ckpts.npz")
MESHES = {"mesh_2x2": (2, 2), "mesh_2x1": (2, 1)}


def _train_reference():
    spec = importlib.util.spec_from_file_location(
        "torch_train_reference", os.path.join(ROOT, "scripts", "torch_train_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    sys.path.insert(0, ROOT)
    ref = _train_reference()
    from tal_asrd_tpu.core.checkpoint import load_pytree, save_pytree
    from tal_asrd_tpu.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
    from tal_asrd_tpu_torch.core.convert import params_spec
    from tal_asrd_tpu_torch.models.asr import ASRModel
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
    from tests.test_torch_helpers import seeded_params

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    fixture = {"what": "JAX CPU reference of the training CLI on a mesh "
                       "(scripts/torch_parallel_reference.py)",
               "splits": ref.TINY_SPLITS, "init_seed": ref.TINY_INIT_SEED,
               "init_scalars": ref.TINY_SCALARS, "runs": {}}
    deltas, worst = {}, 0.0
    for name, (data, model) in MESHES.items():
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            paths = {k: os.path.join(tmp, k.lower()) for k in ("TRAIN", "VALID", "CKPTS", "OUT")}
            paths["INIT"] = os.path.join(tmp, "init.msgpack")
            for split, kw in ref.TINY_SPLITS.items():
                build_synth_corpus(paths[split.upper()], **kw)
            os.environ["TAL_TINY_ARCH"] = "1"
            argv = ref.TINY_RUNS["run1"] + ["--mesh-data", str(data), "--mesh-model", str(model)]
            args = get_argparser(is_train=True).parse_args(ref.fill(argv, paths))
            model_cfg = build_configs(args, BpeTokenizer(model_path=ref.TOKENIZER))[0]
            init = seeded_params(params_spec(ASRModel(model_cfg, device="cpu")),
                                 ref.TINY_INIT_SEED, scalar_bump=ref.TINY_SCALARS)
            save_pytree(paths["INIT"], init)
            env = dict(os.environ, JAX_PLATFORMS="cpu", TAL_TINY_ARCH="1",
                       XLA_FLAGS=f"--xla_force_host_platform_device_count={data * model}")
            ref.run([sys.executable, "-c", ref.TINY_CHILD] + ref.fill(argv, paths), env)
            with open(os.path.join(paths["OUT"], "tiny.metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f if line.strip()]
            ckpt_dir = os.path.join(paths["CKPTS"], "tiny")
            files = sorted(os.listdir(ckpt_dir))
            ckpts = [n for n in files if n.startswith("ckpt_")]
            fixture["runs"][name] = {
                "argv": argv, "mesh": [data, model],
                "step_losses": [[r["step"], r["loss"]] for r in recs if "loss" in r],
                "val_losses": [[r["step"], r["val_loss"]] for r in recs if "val_loss" in r],
                "generations": [[r["step"], r["ref"], r["hyp"]] for r in recs
                                if r.get("type") == "generation"],
                "checkpoints": ckpts, "states": [n for n in files if n.startswith("state_")],
                "commit": commit}
            tree = load_pytree(os.path.join(ckpt_dir, ckpts[-1]))
            for path, value in ref._flat(tree):
                d = np.asarray(value, np.float32) - ref._get(init, path)
                stored = d.astype(np.float16)
                worst = max(worst, float(np.abs(stored.astype(np.float32) - d).max(initial=0)))
                deltas[f"{name}:{path}"] = stored
        fixture["runs"][name]["seconds"] = time.perf_counter() - t0
        print(json.dumps({name: fixture["runs"][name]["step_losses"][-1]}), flush=True)
    fixture["float16_storage_max_abs_err"] = worst
    np.savez_compressed(CKPTS_NPZ, **deltas)
    with open(FIXTURE, "w") as f:
        json.dump(fixture, f, indent=1)
        f.write("\n")
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
