#!/usr/bin/env python3
"""Where a batch split in two parts from the whole batch, on the card.

    python3 scripts/torch_split_probe.py [--out chiprun_out/split_probe.json]

On scripts/ensure_corpus.sh's test split (seed 202, 4 episodes of 180 s),
with the tracked checkpoint (accuracy_release/avg_last_3.bf16.msgpack) in
bf16 and in f32 compute, it compares the two-part path of
decode/sharded.py with the whole batch of 4, stage by stage:

  * each part's log-mel (`ASRModel.log_mel`) against the whole batch's;
  * the frontend mean's sum as a float32 sum of the whole batch and as the
    sum of the two parts' float32 sums (what the parts would subtract if
    each took its own terms);
  * the parts' features (`sharded_features`) against the whole batch's;
  * the encoder run twice on the whole batch's features, and run on them
    two episodes at a time, against the whole batch: the output and each
    of the encoder's top-level modules.

Prints one JSON object a compute dtype and writes them all to --out. Needs
a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tal_asrd_tpu_torch.core.checkpoint import load_pytree  # noqa: E402
from tal_asrd_tpu_torch.core.config import ModelConfig  # noqa: E402
from tal_asrd_tpu_torch.core.convert import load_into  # noqa: E402
from tal_asrd_tpu_torch.data.audio_io import load_audio_segment  # noqa: E402
from tal_asrd_tpu_torch.data.synth import build_synth_corpus  # noqa: E402
from tal_asrd_tpu_torch.decode.sharded import sharded_features  # noqa: E402
from tal_asrd_tpu_torch.models.asr import ASRModel  # noqa: E402


def apart(a, b):
    a, b = a.float(), b.float()
    return {"share_differing": float((a != b).float().mean()),
            "max_abs_diff": float((a - b).abs().max())}


def probe(model, dev, audio, lens):
    t = audio.shape[-1]
    mel = model.log_mel(audio)
    out = {"log_mel_by_part": apart(torch.cat([model.log_mel(audio[:2]),
                                               model.log_mel(audio[2:])]), mel)}
    # every frame is real (equal full lengths): the f32 sums as the mean took them
    out["f32_sum_whole"] = float(mel.sum(dtype=torch.float32))
    out["f32_sum_of_parts"] = float(mel[:2].sum(dtype=torch.float32)
                                    + mel[2:].sum(dtype=torch.float32))
    feats = model.extract_features(audio, lens)
    parts = sharded_features([model, model], [dev, dev], audio, lens)
    out["features_two_parts"] = apart(torch.cat([f for f, _ in parts]), feats)

    seen = {}

    def hook(name):
        def record(module, inputs, output):
            seen.setdefault(name, []).append(output)
        return record
    handles = [m.register_forward_hook(hook(n)) for n, m in model.encoder.named_children()]
    try:
        whole = model.encode_features(feats, lens, t)["encoder_out"]
        again = model.encode_features(feats, lens, t)["encoder_out"]
        by_part = torch.cat([model.encode_features(feats[i:i + 2], lens[i:i + 2], t,
                                                   batch_max_len=t)["encoder_out"]
                             for i in (0, 2)])
    finally:
        for h in handles:
            h.remove()
    out["encoder_run_to_run"] = apart(again, whole)
    out["encoder_whole_features_by_part"] = apart(by_part, whole)
    out["encoder_modules_by_part"] = {n: apart(torch.cat(v[2:4]), v[0]) for n, v in seen.items()}
    split_out = torch.cat([model.encode_features(f, l, t, batch_max_len=t)["encoder_out"]
                           for f, l in parts])
    out["encoder_two_parts"] = dict(apart(split_out, whole),
                                    rms=float(whole.float().pow(2).mean().sqrt()))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "split_probe.json"))
    ap.add_argument("--split", default=os.path.join("out", "split_probe"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda:0"
    if not os.path.exists(os.path.join(args.split, "transcript.pkl")):
        build_synth_corpus(args.split, n_episodes=4, episode_seconds=180.0, n_speakers=8,
                           seed=202)
    wavs = [load_audio_segment(os.path.join(args.split, n), 0.0, None)
            for n in sorted(os.listdir(args.split)) if n.endswith(".wav")]
    audio = torch.from_numpy(np.stack(wavs).astype(np.float32)).to(dev)
    lens = torch.full((len(wavs),), audio.shape[1], dtype=torch.long, device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    res = {"card": smi.stdout.strip() or torch.cuda.get_device_name(0)}
    for name, compute in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = ASRModel(ModelConfig(model_type="1x", num_speakers=8, vocab_size=300),
                         dtype=torch.float32, compute_dtype=compute, device="cpu")
        load_into(model, load_pytree(os.path.join(ROOT, "accuracy_release",
                                                  "avg_last_3.bf16.msgpack")))
        model = model.to(dev)
        with torch.inference_mode():
            res[name] = probe(model, dev, audio, lens)
        print(json.dumps({name: res[name]}), flush=True)
        del model
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
