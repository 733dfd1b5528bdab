#!/usr/bin/env python3
"""The reference figures of the non-causal decode and the embedding chain, from the JAX package on the CPU.

    python3 scripts/torch_embed_reference.py [--sections noncausal,gen_embed,train_embed,embed_system]

Writes tests/fixtures/torch_embed_reference.json and, for the arrays,
tests/fixtures/torch_embed_reference_arrays.npz. Each JAX step runs in its
own process with JAX_PLATFORMS=cpu, on the tracked checkpoint
(accuracy_release/avg_last_3.bf16.msgpack) in float32:

  (a) noncausal: `tal_asrd_tpu.decode.reference_mode.greedy_noncausal` and
      the causal greedy `beam_search` (beam 1, force_output) on the first
      batch of the eval CLI's loader (AlignedDataset of single utterances of
      3-20 s, BucketedCollater, in order) at the batch sizes of BATCH, at
      the eval runner's length (max_new = int(1.1 L) + 2, the non-causal
      buffer one longer for the prime), on two splits: "card",
      scripts/ensure_corpus.sh's test split (seed 202, 4 x 180 s, 8
      speakers; its first 16 segments), and "cpu", its first episode cut to
      5 utterances (4 segments, one batch), which the CPU tests rebuild.
      Batches of 16, not the eval CLI's 64, keep the CPU's memory small;
      the frontend's batch mean makes the batch part of the input, so the
      card's gate decodes the same batch. Tokens and lengths
      of every segment; `attn` of the first ATTN_ROWS segments ("card") or
      all of them ("cpu"), in the arrays.
  (b) gen_embed: `python -m tal_asrd_tpu.cli.gen_embed` (the JAX
      ASRSystem patched to compute in float32), with each batch's speaker
      posteriors recorded beside it, at `--batch-size` BATCH, on the "card"
      test split and the "cpu" split, and on scripts/ensure_corpus.sh's
      train split cut to 8 episodes as chip_smoke.py's train_cli_1x cuts
      it ("train8"). The rows, speaker ids and posteriors go to the arrays.
  (c) train_embed: `python -m tal_asrd_tpu.cli.train_embed` at its
      defaults (2000 steps, batch 64, 6-way) on (b)'s "train8" pickles: the
      train and valid accuracy it prints, the losses every 100 steps.
  (d) embed_system: the JAX EmbedSystem's initial parameters (seed 0, 64 ->
      256 -> 256 -> 10), and its first 20 steps' losses and accuracies on
      fixed episodes (ContrastiveDataset seed 0, 6-way, batch 64) over (b)'s
      "train8" train rows, with the parameters after them, and at each
      step the hidden layers' pre-activations within NEAR_ZERO of 0 (step,
      layer, flat index into [batch, n_way, 256], value): the ReLU gates
      that a rounding difference can flip.

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
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_embed_reference.json")
ARRAYS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_embed_reference_arrays.npz")

SPLITS = {"card": dict(n_episodes=4, episode_seconds=180.0, n_speakers=8, seed=202),
          "cpu": dict(n_episodes=1, episode_seconds=30.0, n_speakers=8, seed=202),
          "train8": dict(n_episodes=8, episode_seconds=120.0, n_speakers=8, seed=0)}
CPU_UTTERANCES = 5          # the "cpu" split keeps its episode's first 5 utterances
ATTN_ROWS = 8
BATCH = {"card": 16, "cpu": 4, "train8": 16}
EMBED_STEPS = 20
NEAR_ZERO = 1e-4            # (d) records the hidden pre-activations this close to 0

# Runs in the child: greedy_noncausal and the causal greedy search of the
# JAX package on the eval loader's first batch, f32.
NONCAUSAL_CHILD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from tal_asrd_tpu.core.checkpoint import load_pytree
from tal_asrd_tpu.core.config import ModelConfig
from tal_asrd_tpu.data import AlignedDataset, BucketedCollater, DataLoader, ShardedSampler
from tal_asrd_tpu.decode.beam import BeamSearchSpec, beam_search
from tal_asrd_tpu.decode.reference_mode import greedy_noncausal
from tal_asrd_tpu.models.asr import ASRModel
from tal_asrd_tpu.text import BpeTokenizer

out, split, batch_size, ckpt, tok_path = sys.argv[1:6]
tok = BpeTokenizer(model_path=tok_path)
ds = AlignedDataset(split, tok, num_utterances=1, min_segment_duration=3,
                    max_segment_duration=20, speaker_map_loc=split + "/speaker_map.json",
                    tokenizer_speakers=True, return_spk_ids=True)
loader = DataLoader(ds, int(batch_size), BucketedCollater(tok.pad_token_id),
                    ShardedSampler(len(ds), shuffle=False), 0, drop_last=False)
batch = next(iter(loader))
model = ASRModel(ModelConfig(model_type="1x", num_speakers=8, vocab_size=len(tok)),
                 dtype=jnp.float32)
params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), load_pytree(ckpt))
variables = {"params": params}
enc = jax.jit(lambda v, a, l: model.apply(v, a, l, False, method=ASRModel.encode))(
    variables, jnp.asarray(batch["audio"]), jnp.asarray(batch["audio_lens"]))
l = batch["text"].shape[1]
max_new = int(l * 1.1) + 2
prime = jnp.asarray(batch["text"][:, :1])
nc = jax.jit(lambda v, e, p: greedy_noncausal(model, v, e, p, max_new + 1,
                                              eos_id=tok.eos_token_id))(variables, enc, prime)
spec = BeamSearchSpec(beam_size=1, max_new_tokens=max_new, eos_id=tok.eos_token_id,
                      vocab_size=model.cfg.num_tokens, text_vocab_size=len(tok),
                      force_output=True)
causal = jax.jit(lambda v, e, p: beam_search(model, v, e, p, spec))(variables, enc, prime)
np.savez(out, idx=batch["idx"], text_len=l, max_new=max_new,
         tokens=np.asarray(nc["tokens"]), lengths=np.asarray(nc["lengths"]),
         attn=np.asarray(nc["attn"]), causal_tokens=np.asarray(causal["tokens"]),
         causal_lengths=np.asarray(causal["lengths"]))
"""

# Runs in the child: the JAX gen_embed CLI in f32, each batch's speaker
# posteriors at its speaker-token positions recorded beside the CLI's rows.
GEN_EMBED_CHILD = r"""
import functools, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import tal_asrd_tpu.train as train_pkg
import tal_asrd_tpu.eval.gen_embed as ge
from tal_asrd_tpu.cli import gen_embed as cli

train_pkg.ASRSystem = functools.partial(train_pkg.ASRSystem, dtype=jnp.float32)
probs_rows = []
orig_make = ge.make_embed_fn

def make_embed_fn(model):
    fn = orig_make(model)
    vocab = model.cfg.vocab_size

    @jax.jit
    def posteriors(variables, audio, audio_lens, text):
        (logits, _), _ = model.apply(variables, audio, text[:, :-1], audio_lens, train=False)
        return jax.nn.softmax(logits[..., vocab:].astype(jnp.float32), axis=-1)

    def recorded(variables, audio, audio_lens, text):
        out = fn(variables, audio, audio_lens, text)
        probs = np.asarray(posteriors(variables, audio, audio_lens, text))
        probs_rows.append(probs[np.asarray(out[1])])
        return out
    return recorded

ge.make_embed_fn = make_embed_fn
cli.main(sys.argv[2:])
np.save(sys.argv[1], np.concatenate(probs_rows, 0))
"""

# Runs in the child: the JAX train_embed CLI with every step's loss kept.
TRAIN_EMBED_CHILD = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import tal_asrd_tpu.train.embed_system as es
from tal_asrd_tpu.cli import train_embed as cli

record = {}
orig_fit, orig_eval = es.EmbedSystem.fit, es.EmbedSystem.evaluate
def fit(self, batches, steps=None):
    losses, accs = orig_fit(self, batches, steps)
    record.update(losses=losses, accs=accs)
    return losses, accs
def evaluate(self, batches):
    record["valid"] = orig_eval(self, batches)
    return record["valid"]
es.EmbedSystem.fit, es.EmbedSystem.evaluate = fit, evaluate
cli.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump(record, f)
"""

# Runs in the child: EmbedSystem's initial parameters and its first steps on
# fixed episodes.
EMBED_SYSTEM_CHILD = r"""
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from tal_asrd_tpu.train.embed_system import ContrastiveCollator, ContrastiveDataset, EmbedSystem

out, pkl, steps, near_zero = sys.argv[1], sys.argv[2], int(sys.argv[3]), float(sys.argv[4])
with open(pkl, "rb") as f:
    emb, ids = pickle.load(f)
system = EmbedSystem(in_dim=emb.shape[1], batch_size=64, seed=0)
init = jax.tree_util.tree_map(np.asarray, system.params)
ds = ContrastiveDataset(emb, ids, n_way=6, seed=0, epoch_len=steps * 64)
coll = ContrastiveCollator()
episodes = np.stack([coll([ds[i * 64 + j] for j in range(64)]) for i in range(steps)])
# each step's hidden pre-activations within NEAR_ZERO of 0, before its update:
# where a ReLU gate sits at rounding distance from zero
hidden = jax.jit(lambda p, b: system.model.apply({"params": p}, b,
                                                 capture_intermediates=True)[1]["intermediates"])
near = {"step": [], "layer": [], "index": [], "value": []}
losses, accs = [], []
for t, batch in enumerate(episodes):
    inter = hidden(system.params, jnp.asarray(batch))
    for layer in (0, 1):
        h = np.asarray(inter[f"Dense_{layer}"]["__call__"][0]).reshape(-1)
        idx = np.nonzero(np.abs(h) < near_zero)[0]
        near["step"] += [t] * len(idx)
        near["layer"] += [layer] * len(idx)
        near["index"] += idx.tolist()
        near["value"] += h[idx].tolist()
    loss, acc = system.fit(iter(batch[None]))
    losses += loss
    accs += acc
final = jax.tree_util.tree_map(np.asarray, system.params)
arrays = {"losses": np.asarray(losses, np.float64), "accs": np.asarray(accs)}
arrays.update({f"near_zero/{k}": np.asarray(v, np.float32 if k == "value" else np.int32)
               for k, v in near.items()})
for tag, tree in (("init", init), ("final", final)):
    for layer, leaves in tree.items():
        for leaf, v in leaves.items():
            arrays[f"{tag}/{layer}/{leaf}"] = v
np.savez(out, **arrays)
"""


def run(cmd, env, child=None):
    print("+", " ".join("<child>" if c == child else c for c in cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=ROOT, env=env)


def build_split(path: str, name: str) -> str:
    """The split `name` of SPLITS at `path` (the "cpu" split cut to its
    first CPU_UTTERANCES utterances), built by the port's synthesiser."""
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    transcripts = build_synth_corpus(path, **SPLITS[name])
    if name == "cpu":
        with open(os.path.join(path, "transcript.pkl"), "wb") as f:
            pickle.dump({"ep0": transcripts["ep0"][:CPU_UTTERANCES]}, f)
    return path


def noncausal(tmp, env, splits):
    section, arrays = {}, {}
    for name in ("card", "cpu"):
        out = os.path.join(tmp, f"noncausal_{name}.npz")
        run([sys.executable, "-c", NONCAUSAL_CHILD, out, splits[name], str(BATCH[name]),
             CHECKPOINT, TOKENIZER], env, NONCAUSAL_CHILD)
        r = np.load(out)
        agree = []
        for i in range(len(r["idx"])):
            nc = r["tokens"][i, 1:r["lengths"][i]].tolist()
            c = r["causal_tokens"][i, 1:r["causal_lengths"][i]].tolist()
            n = min(len(nc), len(c))
            agree.append(sum(a == b for a, b in zip(nc[:n], c[:n])) / max(len(nc), len(c), 1))
        section[name] = {
            "segments": len(r["idx"]), "idx": r["idx"].tolist(), "text_len": int(r["text_len"]),
            "max_new": int(r["max_new"]), "max_len": int(r["max_new"]) + 1,
            "tokens": [r["tokens"][i, :r["lengths"][i]].tolist() for i in range(len(r["idx"]))],
            "lengths": r["lengths"].tolist(),
            "causal_tokens": [r["causal_tokens"][i, :r["causal_lengths"][i]].tolist()
                              for i in range(len(r["idx"]))],
            "agreement": agree, "mean_agreement": float(np.mean(agree)),
            "attn_rows": ATTN_ROWS if name == "card" else len(r["idx"])}
        arrays[f"noncausal/{name}/attn"] = r["attn"][:section[name]["attn_rows"]]
        print(json.dumps({name: {"mean_agreement": section[name]["mean_agreement"]}}), flush=True)
    return section, arrays


def gen_embed(tmp, env, splits):
    section, arrays = {}, {}
    for name in ("card", "cpu", "train8"):
        out = os.path.join(tmp, f"spk_{name}")
        argv = ["--train-data", splits[name], "--valid-data", splits[name],
                "--tokenizer", TOKENIZER, "--model-type", "1x", "--num-speakers", "8",
                "--num-workers", "0", "--batch-size", str(BATCH[name]), "--load", CHECKPOINT,
                "--out-path", out]
        probs_path = os.path.join(tmp, f"probs_{name}.npy")
        t0 = time.perf_counter()
        run([sys.executable, "-c", GEN_EMBED_CHILD, probs_path] + argv, env, GEN_EMBED_CHILD)
        rows, ids = [], []
        for part in ("train", "valid"):
            with open(f"{out}.{part}.pkl", "rb") as f:
                e, s = pickle.load(f)
            rows.append(e)
            ids.append(s)
        rows, ids, probs = np.concatenate(rows), np.concatenate(ids), np.load(probs_path)
        if len(probs) != len(rows):
            raise SystemExit(f"{name}: {len(probs)} posteriors for {len(rows)} rows")
        arrays.update({f"gen_embed/{name}/rows": rows, f"gen_embed/{name}/ids": ids,
                       f"gen_embed/{name}/probs": probs})
        section[name] = {
            "command": "JAX_PLATFORMS=cpu python -m tal_asrd_tpu.cli.gen_embed " + " ".join(
                argv).replace(splits[name], "SPLIT").replace(out, "OUT"),
            "compute_dtype": "float32", "rows": len(rows),
            "n_train": int(len(rows) * 0.8), "seconds_cli": time.perf_counter() - t0}
        print(json.dumps({name: section[name]["rows"]}), flush=True)
    return section, arrays


def train8_pickles(tmp, arrays) -> str:
    """(b)'s "train8" rows as the JAX CLI's save_split writes them; returns
    the path stem."""
    from tal_asrd_tpu_torch.eval.gen_embed import save_split
    out = os.path.join(tmp, "spk_train8")
    save_split(arrays["gen_embed/train8/rows"], arrays["gen_embed/train8/ids"], out)
    return out


def train_embed(tmp, env, arrays):
    out = train8_pickles(tmp, arrays)
    rec_path, head = os.path.join(tmp, "train_embed.json"), os.path.join(tmp, "head.msgpack")
    argv = ["--train-data", out + ".train.pkl", "--valid-data", out + ".valid.pkl",
            "--out", head]
    t0 = time.perf_counter()
    run([sys.executable, "-c", TRAIN_EMBED_CHILD, rec_path] + argv, env, TRAIN_EMBED_CHILD)
    with open(rec_path) as f:
        rec = json.load(f)
    return {"command": "JAX_PLATFORMS=cpu python -m tal_asrd_tpu.cli.train_embed "
                       "--train-data OUT.train.pkl --valid-data OUT.valid.pkl --out HEAD",
            "pickles": "gen_embed/train8 (f32)",
            "train_acc": float(np.mean(rec["accs"][-50:])), "valid_loss": rec["valid"][0],
            "valid_acc": rec["valid"][1], "losses_every_100": rec["losses"][::100],
            "seconds_cli": time.perf_counter() - t0}, {}


def embed_system(tmp, env, arrays):
    out = os.path.join(tmp, "embed_system.npz")
    run([sys.executable, "-c", EMBED_SYSTEM_CHILD, out,
         train8_pickles(tmp, arrays) + ".train.pkl", str(EMBED_STEPS), str(NEAR_ZERO)],
        env, EMBED_SYSTEM_CHILD)
    r = dict(np.load(out))
    section = {"steps": EMBED_STEPS, "batch_size": 64, "n_way": 6, "episode_seed": 0,
               "near_zero": NEAR_ZERO,
               "init_seed": 0, "rows": "gen_embed/train8 train rows (the first 80 %)",
               "losses": r.pop("losses").tolist(), "accs": r.pop("accs").tolist()}
    return section, {f"embed_system/{k}": v for k, v in r.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default="noncausal,gen_embed,train_embed,embed_system")
    args = ap.parse_args()
    sys.path[:0] = [ROOT]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    fixture, arrays = {}, {}
    if os.path.exists(FIXTURE):
        with open(FIXTURE) as f:
            fixture = json.load(f)
    if os.path.exists(ARRAYS_NPZ):
        arrays = dict(np.load(ARRAYS_NPZ))
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    fixture.update(what="JAX CPU reference of the non-causal decode and the embedding chain "
                        "(scripts/torch_embed_reference.py)", checkpoint=CHECKPOINT,
                   tokenizer=TOKENIZER, splits=SPLITS, cpu_utterances=CPU_UTTERANCES,
                   batch=BATCH, made_by="tal_asrd_tpu_torch.data.synth.build_synth_corpus")
    with tempfile.TemporaryDirectory() as tmp:
        splits = {name: build_split(os.path.join(tmp, name), name) for name in SPLITS}
        for name in args.sections.split(","):
            t0 = time.perf_counter()
            if name == "noncausal":
                fixture[name], new = noncausal(tmp, env, splits)
            elif name == "gen_embed":
                fixture[name], new = gen_embed(tmp, env, splits)
            elif name == "train_embed":
                fixture[name], new = train_embed(tmp, env, arrays)
            elif name == "embed_system":
                fixture[name], new = embed_system(tmp, env, arrays)
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
