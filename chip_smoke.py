#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, needs one card
    python3 chip_smoke.py --phases kernels   # build + kernel checks only
    python3 chip_smoke.py --phases train     # ... + the training phases, no serving
    python3 chip_smoke.py --phases eval      # ... + the aligned evaluation only
    python3 chip_smoke.py --phases unaligned # ... + the long-form evaluation only
    python3 chip_smoke.py --phases train_cli # ... + the training CLI only
    python3 chip_smoke.py --phases lm        # ... + LM shallow fusion only
    python3 chip_smoke.py --phases spk       # ... + the separate speaker head only
    python3 chip_smoke.py --phases noncausal # ... + the non-causal and sharded decode only
    python3 chip_smoke.py --phases embed     # ... + the speaker-embedding chain only
    python3 chip_smoke.py --phases cluster   # ... + the embedding chain's clustering half only
    python3 chip_smoke.py --phases sd        # ... + the speaker baseline and its reconciliation only
    python3 chip_smoke.py --phases sad       # ... + the neural SAD only
    python3 chip_smoke.py --phases diar      # ... + first diarization (UIS-RNN) only
    python3 chip_smoke.py --phases align     # ... + forced alignment only
    python3 chip_smoke.py --phases optim     # ... + RAdam, Adafactor, Lookahead only
    python3 chip_smoke.py --phases parallel  # ... + parallelism (torchrun, gloo meshes) only

Builds the port's CUDA kernels from tal_asrd_tpu_torch/csrc/ with nvcc, holds
each against its plain PyTorch version on the card at the shapes its paths
give it — the layer step K1 in bf16/f32 storage and with int8 cross K/V
(kv8), int8 weights (w8) or both, the stacked all-layers step K3 in each of
those modes (K1 and K3 are one cluster kernel at two sets of rounding
points), K3 against a chain of four K1 launches, K1's and K3's determinism
(two launches, equal bits) with their cluster launch plans, the log-mel projection
K2 (also at 1, 3 and 1003 rows), SpecAugment K4 (bit for bit) — and times
each. Then it drives the
serving path (`make_generate_fn`: log-mel -> TDS encoder -> fused decoder
step -> beam search) at full width through each decoder configuration — the
`2x` model (seeded weights) per layer, kv8, w8, kv8+w8, stacked and stacked
kv8+w8; the `1x` model (the tracked checkpoint
accuracy_release/avg_last_3.bf16.msgpack) per layer and stacked kv8+w8 — and
holds each against the unfused decoder.

Then it runs the aligned evaluation (`eval_aligned_1x`): the port's eval
CLI (`python -m tal_asrd_tpu_torch.cli.test`: test split -> AlignedDataset
-> DataLoader -> EvalRunner -> teacher-forced loss + beam 5 with the
speaker-embedding track -> test_result.pkl) on the tracked checkpoint over
the synthetic test split (118 segments in batches of 64 and 54), unfused and
with the fused decoder (K1), each scored to WER / WDER and held against the
JAX CPU reference tests/fixtures/torch_aligned_eval_reference.json; K1 is
checked before at that path's lanes (B = 320 and 270, S = 108, cache 38) and
K2 at N = 64064.

Then it runs the long-form evaluation (`eval_unaligned_1x`): the eval CLI
with --unaligned over the same split's 4 episodes of 180 s, both legs — the
sliding-window state machine (the 4 equal-length episodes encoded together,
K2 at N = 72004; each episode's windows of 357 encoder frames and history of
512 tokens, K1 at B = 1) and VAD windows decoded by beam 5 in [16, bucket]
batches (K1 at 80 lanes, S = 46 / 108) — unfused and fused, each scored
under keys of its own leg and held against the JAX CPU reference
tests/fixtures/torch_unaligned_eval_reference.json. K1 and K2 are checked
before at that path's shapes, and K1 continuing from the state machine's
prefill (`check_prefill_handoff`).

Then it drives the training path (`ASRSystem` + `Trainer.fit`: log-mel with
K2 -> SpecAugment, kernel K4 -> TDS -> decoder -> masked cross entropy ->
LAMB): `train_2x` trains the seeded 2x model at full width and depth for 10
steps at TrainConfig's defaults (B=64 windows of 20 s, f32 parameters, bf16
compute) and holds bf16 against f32 and grad_acc=2 against 1;
`train_1x_checkpoint` takes 2 steps from the tracked checkpoint, saves and
reloads it, and decodes with both sets of weights through K1.

Then LM shallow fusion (`lm_fusion_1x`, `--phases lm`): `python -m
tal_asrd_tpu_torch.cli.train_lm` at the eval CLI's LM shape (512 / 4 heads /
6 layers, batch 64) on scripts/ensure_corpus.sh's splits extended at their
seeds, then the eval CLI's three legs with the seeded LM of
tests/fixtures/torch_lm_reference.json (rebuilt with numpy), unfused and
fused, in f32 as that JAX CPU reference, held against its figures; then the
three legs fused with the trained LM and without an LM, in bf16 as users
run them. K1 is checked in f32 at the parity runs' shapes.

Then the separate speaker head (`spk_head_1x`, `--phases spk`): the
tracked checkpoint's text weights with a head seeded by
scripts/torch_spk_reference.py's `seeded_spk_tree` (rebuilt with numpy)
through the eval CLI at --spk-weight 0.5 — aligned in f32 against the JAX
CLI's f32 tokens and speakerLogits (tests/fixtures/torch_spk_reference.json),
in bf16 unfused and with --fused-decode (a head model decodes through the
model itself: K1 is launched no time), each against the same tree without
the head; both long-form legs — then the training CLI for 2 epochs against
the JAX CLI's validation losses, one resumed epoch with SpecAugment (K4),
and the eval CLI on the last checkpoint.

Then the non-causal reference decode and the sharded decode
(`noncausal_1x`, `--phases noncausal`): on the test split's two batches the
causal greedy search and `greedy_noncausal` at the same length (their
token agreement printed), `greedy_noncausal` in f32 against the JAX CPU
reference (tests/fixtures/torch_embed_reference.json), and
`make_sharded_decode` / `make_sharded_unaligned` on one and two shards of
the card against the unsharded decode, in bf16 and in f32 (K2 on the first
part's device at the whole batch's N = 64064 / 72004, for its mean; at a
part's N = 32032 / 36002 on the other).

Then the speaker-embedding chain (`embed_1x`, `--phases embed`,
scripts/embed_chain.sh steps 1-2): `python -m
tal_asrd_tpu_torch.cli.gen_embed` on the test split in f32 against the JAX
CLI's rows and in bf16 as users run it, and on the train split cut to 8
episodes; `python -m tal_asrd_tpu_torch.cli.train_embed` at its defaults on
the port's pickles and on the JAX CLI's, against its valid accuracy.

Then the embedding chain's clustering half (`cluster_1x`, `--phases
cluster`, scripts/embed_chain.sh step 3): the eval CLI aligned with
--fused-decode (K2, K1), `cli.tools wder-format`, the metric head, and
`python -m tal_asrd_tpu_torch.cli.wder --cluster` (agglomerative, cos_dist)
raw and through the head; then the engines at the chain's size: every
parameter set of the WDER grid and cli.wder's methods and metrics on the
JAX CLI's rows of the test split, one segment an episode, raw and through
the JAX CLI's head (the distances and the head on the card), against the
JAX CPU reference tests/fixtures/torch_cluster_reference.json, and
`cli.wder_search`'s TSV against the JAX CLI's.

Then the speaker baseline (`sd_baseline_1x`, `--phases sd`): SDModel at
the 1x TDS's full width (6008 speakers) from scripts/torch_sd_reference.py's
`seeded_sd_tree` (the tracked encoder under seeded heads) — its frame
features in f32 and bf16 and 6 f32 LAMB steps against the JAX CPU reference
(tests/fixtures/torch_sd_reference.json) — then `python -m
tal_asrd_tpu_torch.cli.train_sd` at its defaults for 20 steps (K2, K4), and
the reconciliation chain with that checkpoint: `dump_episode_features`
over the test split (K2), the eval CLI --unaligned --fused-decode on its
first episode (K1, K2), `cli.tools wder-format --sd-features`, `cli.wder
--cluster` and `merge_asr_sd`. Then the neural SAD (`sad_1x`, `--phases
sad`): the stress corpus through `cli.tools synth-sad-stress` byte for byte,
PyanNet's scores and 25 Adam steps from scripts/torch_sad_reference.py's
`seeded_pyannet_tree` against the JAX CPU reference
(tests/fixtures/torch_sad_reference.json), `python -m
tal_asrd_tpu_torch.cli.sad --steps 500` and its --load (PyanNet launches no
hand-written kernel).

Then first diarization (`diar_1x`, `--phases diar`, scripts/uisrnn_der.sh's
chain): `cli.tools diar-features --features logmel` over the train split
cut to 10 episodes (K2 one launch an episode) against the JAX CLI's
pickles, `--features wav2vec` at full width from a converted seeded tree,
UIS-RNN's fit steps one at a time from JAX's states and its traces on
JAX's trained tree (tests/fixtures/torch_diar_reference*), `python -m
tal_asrd_tpu_torch.cli.uisrnn --mode kfold` at the script's flags (its DER
in the band of the JAX CLI's two seeds), a traced window, `--mode stream`
with a resume, and fit / predict at the CLI's default width. Then forced
alignment (`align_1x`, `--phases align`): `full_force_align` of the
tracked checkpoint in f32 over the test split (K2 one launch an
utterance), against the JAX CPU reference's alignments
(tests/fixtures/torch_align_reference*), and MFCCs of its episodes.

Then it runs the training CLI (`train_cli_1x`): `python -m
tal_asrd_tpu_torch.cli.train`'s `main` at scripts/accuracy.sh's last
phase's flags (B = 16, --max-secs 28.5, --shiftaug --cache-items
--audio-int16, lr 2e-4) on scripts/ensure_corpus.sh's train and valid
splits cut to 8 and 2 episodes: the tracked checkpoint's validation loss
through the CLI's datasets against the JAX CPU reference
(tests/fixtures/torch_train_cli_reference.json), run 1 from the tracked
checkpoint for 3 epochs of 15 steps without SpecAugment, run 2 resuming
from run 1's last checkpoint (step counter restored) for one epoch with
SpecAugment (K4), `cli.tools average-ckpt --last-k 3`, and the eval CLI on
the average over the test split; K2 at every audio shape the phase saw and
K4 at [16, 3001, 80], both on int16 audio.

Then the optimizers (`optim_1x`, `--phases optim`, also in `train` and
`all`): RAdam, Adafactor and Lookahead replayed on the tracked checkpoint's
leaves against the JAX CPU trajectories of
tests/fixtures/torch_optim_reference.* (scripts/torch_optim_reference.py);
then the tracked checkpoint trained through `ASRSystem._make_optimizer`
for 8 steps of 16 x 30 s windows of the synthetic train split (K2, K4)
with each of RAdam, Adafactor (defaults), Adafactor (beta1 0.9, wd 0.01,
the system's schedule), Lookahead(LAMB), Lookahead(RAdam) and LAMB, each
step's update held against the same optimizer on the CPU, each `step()`
timed (`utils.profiling`), one step traced; and one fused greedy 1x
generate (K1, K2) beside `utils.flops`' roofline at the H100's peaks.

Then parallelism (`parallel_1x`, `--phases parallel`, also in `train` and
`all`; `run_parallel_1x`): the training CLI under `torchrun
--nproc-per-node 1` (NCCL, a 1 x 1 mesh) against it without, bit for bit;
gloo groups of 2 and 4 processes sharing the card for meshes (2, 1), (1,
2), (2, 2), 4 steps of the tracked checkpoint at 16 x 30 s in f32 against
one process (every rank's K2 and K4 launches, its step times and
collectives' share); `ShardedCheckpointManager` on (1, 2); the sharded
decode on two parts of the card; and, on the CPU, 8 gloo processes for the
2 x 2 x 2 multi-slice step against a flat 4 x 2 one.

Prints one JSON object per line: `device`, one `kernel` line per check,
`k3_vs_k1_chain`, `k1_determinism`, `k3_determinism`, `kernel_timing`, one `serve_*` line per configuration,
`eval_aligned_1x`, `prefill_handoff`, `eval_unaligned_1x`, `lm_fusion_1x`, `spk_head_1x`,
`noncausal_1x`, `embed_1x`, `cluster_1x`, `sd_baseline_1x`, `sad_1x`, `diar_1x`,
`align_1x`, `train_2x`, `train_1x_checkpoint`, `train_cli_1x`, `optim_fixture_replay`, `optim_1x`,
`parallel_1x`,
`kernels` (every kernel of each path with
its launch count in that path's one timed run, its error against the plain
version, its time, the plain version's, a library call's where one exists,
and the least time the card could take), and last
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero, without that line, if there is no CUDA device, if a kernel
does not build or launch, or if any comparison misses its tolerance.

Imports torch and the port only — nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import filecmp
import functools
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np

WINDOW_SAMPLES = 456_960          # 28.56 s at 16 kHz -> 2857 frames -> 340 enc frames
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `reps` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms with the host taken out: fn's launches
    are captured once into a CUDA graph and the graph is replayed. An eager
    loop over a kernel that is faster than Python can enqueue it would
    measure the enqueue instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


def bound(bytes_moved: float, flops: float, dtype_name: str):
    """The least time in ms the card could take: the larger of the bytes
    over its memory rate and the operations over its peak for the type
    (an H100 SXM's published dense peaks, `utils/flops.py`)."""
    from tal_asrd_tpu_torch.utils.flops import PEAK_BYTES_PER_S, PEAK_FLOPS
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: fused_logmel_project
# ---------------------------------------------------------------------------
def check_logmel(torch, dev, b, samples=WINDOW_SAMPLES, audio=None, power=None):
    """Kernel vs plain version and timings at N = b x num_frames(samples),
    on seeded normal audio or on `audio` ([b, samples] f32 on the card), or
    at the rows of `power` ([N, n_freqs] f32 on the card) as they are."""
    from tal_asrd_tpu_torch.core.config import FrontendConfig
    from tal_asrd_tpu_torch.ops.cuda_kernels import (
        fused_logmel_project, logmel_project_plain)
    from tal_asrd_tpu_torch.ops.logmel import mel_filterbank, power_spectrogram

    cfg = FrontendConfig()
    rng = np.random.default_rng(SEED)
    if power is None:
        if audio is None:
            audio = torch.from_numpy(
                (rng.standard_normal((b, samples)) * 0.1).astype(np.float32)).to(dev)
        power = power_spectrogram(audio, cfg)
        power = power.reshape(-1, power.shape[2]).contiguous()
    n = power.shape[0]
    fb = torch.from_numpy(mel_filterbank(
        cfg.n_fft // 2 + 1, cfg.f_min, cfg.effective_f_max, cfg.n_mels,
        cfg.sample_rate)).to(dev)
    eps = cfg.log_eps

    out = fused_logmel_project(power, fb, eps)
    torch.cuda.synchronize()
    ref = logmel_project_plain(power, fb, eps)
    err = float((out - ref).abs().max())
    # row counts below one 64-frame tile and across a ragged last tile
    edge_errs = {}
    for n_r in (1, 3, 1003):
        out_r = fused_logmel_project(power[:n_r].contiguous(), fb, eps)
        edge_errs[n_r] = float((out_r - ref[:n_r]).abs().max())
    err_r = max(edge_errs.values())
    tol = 1e-5
    f, m = power.shape[1], fb.shape[1]
    ms = time_ms(lambda: fused_logmel_project(power, fb, eps), 20)
    plain_ms = time_ms(lambda: logmel_project_plain(power, fb, eps), 20)
    library_ms = time_ms(lambda: torch.log(power @ fb + eps), 20)
    # K2 runs its products on the tensor cores in 3xTF32: three TF32 products
    # for each f32 one
    bound_ms, bound_by = bound((n * f + f * m + n * m) * 4.0,
                               3 * 2.0 * n * f * m, "tf32")
    rec = {
        "phase": "kernel", "name": "fused_logmel_project", "route": "cuda",
        "source": "tal_asrd_tpu_torch/csrc/logmel_project.cu",
        "replaces": "tal_asrd_tpu/ops/pallas_kernels.py:48",
        "shape": {"N": n, "n_freqs": f, "n_mels": m}, "dtype": "float32",
        "max_abs_err": max(err, err_r), "edge_max_abs_err": edge_errs, "tolerance": tol,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms, "bound_share": bound_ms / ms,
        "note": "bound: max(bytes / 3.35 TB/s, 3 x 2NFM / 494.7 TFLOP/s): 3xTF32 on "
                "the tensor cores; library: torch.log(power @ fb + eps), f32 cuBLAS",
    }
    emit(rec)
    if not (np.isfinite(err) and max(err, err_r) <= tol):
        fail(f"fused_logmel_project differs from its plain version by "
             f"{max(err, err_r)} (> {tol})")
    return rec


# ---------------------------------------------------------------------------
# Phase 2b: SpecAugment (K4)
# ---------------------------------------------------------------------------
TRAIN_SAMPLES = 320_000            # 20 s windows (TrainConfig.max_secs) -> 2001 frames
K4_SOURCE = ("tal_asrd_tpu_torch/csrc/specaug.cu", "tal_asrd_tpu/ops/pallas_kernels.py:121")


def check_specaug(torch, dev, b, edge_cases=False, spec_in=None):
    """K4 against its plain version, bit for bit, at a trainer's shape
    [b, 2001, 80] (or on `spec_in`, a log-mel [b, T, 80] on the card) with
    the default config; with `edge_cases` also at [3, 37, 80] (T below the
    time mask parameter; there through the backward pass too) and with zero
    masks (the wrapper passes the input through; the kernel launched with
    zero masks copies it). Then its time at the trainer's shape beside its
    bound, reckoned from this draw, and a plain `torch.where` with the mask
    given."""
    from tal_asrd_tpu_torch.core.config import SpecAugmentConfig
    from tal_asrd_tpu_torch.ops.cuda_specaug import launch_specaug
    from tal_asrd_tpu_torch.ops.specaug import (
        draw_seeds, spec_augment_seeded, specaug_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED + b)
    cfg, off = SpecAugmentConfig(), SpecAugmentConfig(num_freq_masks=0, num_time_masks=0)
    n_frames = 1 + TRAIN_SAMPLES // 160 if spec_in is None else spec_in.shape[1]
    cases = [("trainer", (b, n_frames, 80), cfg)]
    if edge_cases:
        cases += [("short_T", (3, 37, 80), cfg), ("zero_masks", (b, n_frames, 80), off)]
    checks = {}
    for name, shape, c in cases:
        spec = (spec_in if name == "trainer" and spec_in is not None
                else torch.randn(shape, device=dev, generator=gen))
        seeds = draw_seeds(shape[0], gen, dev)
        out = spec_augment_seeded(seeds, spec, c)
        torch.cuda.synchronize()
        ref = specaug_plain(seeds, spec, c)
        checks[name] = {"bit_equal": bool(torch.equal(out, ref)),
                        "max_abs_err": float((out - ref).abs().max()),
                        "masked_share": float((ref == 0).float().mean())}
        if name == "trainer":
            timed = spec, seeds
        if name == "zero_masks":
            raw = launch_specaug(seeds, spec, 27, 0, 100, 0)
            checks[name]["kernel_copy_bit_equal"] = bool(torch.equal(raw, spec))
        if name == "short_T":
            s = spec.clone().requires_grad_(True)
            g = torch.randn_like(s)
            spec_augment_seeded(seeds, s, c).backward(g)
            checks[name]["backward_bit_equal"] = bool(torch.equal(s.grad, specaug_plain(seeds, g, c)))
    bad = [(n, k) for n, r in checks.items() for k, v in r.items()
           if k.endswith("equal") and not v]
    spec, seeds = timed
    t, m = spec.shape[1:]
    keep = specaug_plain(seeds, torch.ones_like(spec), cfg) != 0
    ms = time_ms(lambda: spec_augment_seeded(seeds, spec, cfg), 20)
    graph_ms = time_graph_ms(lambda: launch_specaug(
        seeds, spec, cfg.freq_mask_param, cfg.num_freq_masks, cfg.time_mask_param,
        cfg.num_time_masks), 20)
    plain_ms = time_ms(lambda: specaug_plain(seeds, spec, cfg), 20)
    zero = torch.zeros((), device=dev)
    where_ms = time_ms(lambda: torch.where(keep, spec, zero), 20)
    # the least the function must move: one write of every value and one read
    # of each value it keeps (this draw's spans); one select per value
    kept = int(keep.sum())
    bound_ms, bound_by = bound(4.0 * (spec.numel() + kept), float(spec.numel()), "float32")
    rec = {"phase": "kernel", "name": "spec_augment", "route": "cuda",
           "source": K4_SOURCE[0], "replaces": K4_SOURCE[1],
           "shape": {"B": b, "T": t, "M": m}, "dtype": "float32",
           "checks": checks, "tolerance": "bit-equal", "kept_share": kept / spec.numel(),
           "max_abs_err": max(r["max_abs_err"] for r in checks.values()),
           "ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms, "where_ms": where_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "note": "ms: 20 eager calls (CUDA events); graph_ms: CUDA-graph replay of the "
                   "launch; bound: 4 bytes x (every value written + each kept value "
                   "read); where_ms: torch.where(keep, spec, 0) with the mask given, "
                   "for scale (no PyTorch call draws the spans)"}
    emit(rec)
    if bad:
        fail(f"spec_augment differs from its plain version: {bad}")
    return rec


# ---------------------------------------------------------------------------
# Phase 3: fused_layer_step
# ---------------------------------------------------------------------------
def make_layer_inputs(torch, dev, rng, b, d, s, dtype):
    """Seeded packed weights (ReZero scalars 0.3; in bf16 also in fragment
    order), cross K/V, pad bias and three inputs x, from numpy."""
    from tal_asrd_tpu_torch.ops.cuda_decode import with_fragments
    f = 4 * d

    def mat(k, n):
        return torch.from_numpy(
            (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
        ).to(dev).to(dtype)

    def vec(n):
        return torch.from_numpy(
            (rng.standard_normal(n) * 0.1).astype(np.float32)).to(dev)

    rw = torch.tensor([0.3, 0.3], dtype=torch.float32, device=dev)
    w = with_fragments({
        "wqkv": mat(d, 3 * d), "bqkv": vec(3 * d), "wso": mat(d, d), "bso": vec(d),
        "wcq": mat(d, d), "bcq": vec(d), "wco": mat(d, d), "bco": vec(d),
        "wf1": mat(d, f), "bf1": vec(f), "wf2": mat(f, d), "bf2": vec(d),
        "rw": rw, "resweight": rw[0], "resweight_src": rw[1]})
    mk, mv = (torch.from_numpy(
        rng.standard_normal((b, s, d)).astype(np.float32)).to(dev).to(dtype)
        for _ in range(2))
    mask = np.zeros((b, s), bool)
    for lane in range(0, b, 3):          # a padded tail on some lanes
        mask[lane, s - 5 - 7 * (lane % 5):] = True
    bias = torch.from_numpy(np.where(mask, -1e9, 0.0).astype(np.float32)).to(dev)
    xs = torch.from_numpy(
        (rng.standard_normal((3, b, d)) * 0.5).astype(np.float32)).to(dev).to(dtype)
    return w, mk, mv, bias, xs


def bf16_ulp(t):
    """Size of one bf16 step at each value of t (f32 tensor), taken at
    max(|t|, 2^-6): two f32 sums of O(1) terms in different orders differ by
    ~1e-6 absolute, which is many steps of a value that happens to be ~0."""
    import torch
    exp = torch.floor(torch.log2(t.abs().clamp(min=2.0 ** -6)))
    return torch.pow(2.0, exp - 7)


def check_layer_step(torch, dev, name, b, d, h, s, l_buf, dtype, first_index):
    """Three chained steps at first_index, +1, +2 through the kernel and the
    plain version. Both start from the same cache of seeded O(1) rows: the
    rows below first_index are live (self-attention over many rows, as late
    in a decode), the rows above are stale and must be masked."""
    from tal_asrd_tpu_torch.ops.cuda_decode import (
        fused_layer_step, layer_step_plain)

    rng = np.random.default_rng(SEED + d + s + 1000 * first_index + b)
    w, mk, mv, bias, xs = make_layer_inputs(torch, dev, rng, b, d, s, dtype)
    ck, cv = (torch.from_numpy(
        rng.standard_normal((b, l_buf, d)).astype(np.float32)).to(dev).to(dtype)
        for _ in range(2))

    def step(fn):
        return lambda x, ck_, cv_, index, h_: fn(x, w, ck_, cv_, mk, mv, bias, index, h_)
    errs, attn_max = chained_errors(torch, step(fused_layer_step), step(layer_step_plain),
                                    xs, ck, cv, h, first_index, dtype)
    tol = TOL[("K1", str(dtype).replace("torch.", ""))]
    rec = {"phase": "kernel", "name": "fused_layer_step", "config": name,
           "route": "cuda", "source": "tal_asrd_tpu_torch/csrc/layer_step.cu",
           "replaces": "tal_asrd_tpu/ops/pallas_decode.py:188",
           "shape": {"B": b, "D": d, "H": h, "S": s, "L": l_buf},
           "indices": [first_index, first_index + 1, first_index + 2],
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": errs, "tolerance": tol, "attn_max": attn_max,
           "plan": plan_of("K1")}
    emit(rec)
    for key, t in tol.items():
        if not errs[key] <= t:
            fail(f"fused_layer_step[{name}] {key} differs from its plain "
                 f"version by {errs[key]} (> {t})")
    return rec


# ---------------------------------------------------------------------------
# Phase 3b: K1's int8 modes and K3 (stacked_decoder_step)
# ---------------------------------------------------------------------------
MODES = {"none": (False, False), "kv8": (True, False), "w8": (False, True),
         "kv8+w8": (True, True)}
N_LAYERS = 4
K1_SOURCE = ("tal_asrd_tpu_torch/csrc/layer_step.cu", "tal_asrd_tpu/ops/pallas_decode.py:188")
K3_SOURCE = ("tal_asrd_tpu_torch/csrc/stacked_step.cu",
             "tal_asrd_tpu/ops/pallas_decode_stacked.py:192")


def seeded_decoder_inputs(torch, dev, seed, b, d, s, l_buf):
    """f32 inputs for N_LAYERS layers, made on the card from one seeded
    generator: weights [in, out] (std 1/sqrt(in)), biases (std 0.1), ReZero
    scalars 0.3, cross K/V [L, B, S, D] and a self cache of O(1) rows
    [L, B, l_buf, D] (std 1), three inputs x (std 0.5) and a pad bias with
    padded tails on some lanes."""
    from tal_asrd_tpu_torch.ops.cuda_decode import BIAS_KEYS, WEIGHT_KEYS
    g = torch.Generator(device=dev).manual_seed(seed)
    f = 4 * d

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    layers = []
    for _ in range(N_LAYERS):
        w = {wk: randn(k, n) / k ** 0.5 for wk, (k, n) in zip(
            WEIGHT_KEYS, ((d, 3 * d), (d, d), (d, d), (d, d), (d, f), (f, d)))}
        w.update({bk: randn(n) * 0.1 for bk, n in zip(
            BIAS_KEYS, (3 * d, d, d, d, f, d))})
        w["rw"] = torch.tensor([0.3, 0.3], dtype=torch.float32, device=dev)
        layers.append(w)
    mask = np.zeros((b, s), bool)
    for lane in range(0, b, 3):          # a padded tail on some lanes
        mask[lane, s - 5 - 7 * (lane % 5):] = True
    return {"layers": layers, "mk": randn(N_LAYERS, b, s, d), "mv": randn(N_LAYERS, b, s, d),
            "ck": randn(N_LAYERS, b, l_buf, d), "cv": randn(N_LAYERS, b, l_buf, d),
            "xs": randn(3, b, d) * 0.5,
            "bias": torch.from_numpy(np.where(mask, -1e9, 0.0).astype(np.float32)).to(dev)}


def realize(torch, inp, dtype, mode):
    """The operands of one storage dtype and int8 mode: per-layer packs
    (int8 + scales under w8; bf16 and int8 weights also in fragment order),
    their stack, and the cross K/V in `dtype`
    (int8 + [L, D] scales under kv8, quantized layer by layer over the whole
    batch, as the serving path does)."""
    from tal_asrd_tpu_torch.ops.cuda_decode import (
        WEIGHT_KEYS, quantize_mem_kv, quantize_packed, with_fragments)
    from tal_asrd_tpu_torch.ops.cuda_decode_stacked import stack_packed
    kv8, w8 = MODES[mode]
    packs = []
    for w in inp["layers"]:
        pk = {k: (t.to(dtype) if k in WEIGHT_KEYS else t) for k, t in w.items()}
        packs.append(quantize_packed(pk) if w8 else with_fragments(pk))
    mk, mv = inp["mk"].to(dtype), inp["mv"].to(dtype)
    sk = sv = None
    if kv8:
        qs = [quantize_mem_kv(mk[li], mv[li]) for li in range(N_LAYERS)]
        mk, sk, mv, sv = (torch.stack([q[i] for q in qs]) for i in range(4))
    return {"packs": packs, "stacked": stack_packed(packs), "mk": mk, "mv": mv,
            "sk": sk, "sv": sv, "ck": inp["ck"].to(dtype), "cv": inp["cv"].to(dtype),
            "xs": inp["xs"].to(dtype), "bias": inp["bias"]}


def _layer(t, li):
    return None if t is None else t[li]


def k1_step(op, li=0):
    """K1 and its plain version on layer li of `op`: fn(x, ck, cv, index)."""
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step, layer_step_plain

    def make(fn):
        return lambda x, ck, cv, index, h: fn(
            x, op["packs"][li], ck, cv, op["mk"][li], op["mv"][li], op["bias"], index, h,
            _layer(op["sk"], li), _layer(op["sv"], li))
    return make(fused_layer_step), make(layer_step_plain)


def k3_step(op):
    from tal_asrd_tpu_torch.ops.cuda_decode_stacked import (
        stacked_decoder_step, stacked_step_plain)

    def make(fn):
        return lambda x, ck, cv, index, h: fn(
            x, op["stacked"], ck, cv, op["mk"], op["mv"], op["bias"], index, h,
            op["sk"], op["sv"])
    return make(stacked_decoder_step), make(stacked_step_plain)


def plan_of(kern):
    """The launch plan of the last launch of K1 or K3: G lanes per cluster of
    C CTAs."""
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_decode_stacked import stacked_decoder_step
    return (fused_layer_step if kern == "K1" else stacked_decoder_step).last_plan.as_dict()


def chained_errors(torch, kernel, plain, xs, ck, cv, h, first_index, dtype):
    """Three chained steps at first_index, +1, +2 through `kernel` and
    `plain` from copies of the same caches: max |kernel - plain| of x_out,
    attn and the caches, and in bf16 the same in bf16 steps."""
    ck_k, cv_k, ck_p, cv_p = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    errs = {"x_out": 0.0, "attn": 0.0, "cache": 0.0}
    if dtype == torch.bfloat16:
        errs.update({"x_out_ulps": 0.0, "cache_ulps": 0.0})
    attn_max = 0.0
    for step in range(3):
        index = first_index + step
        xo, at, ck_k, cv_k = kernel(xs[step], ck_k, cv_k, index, h)
        torch.cuda.synchronize()
        xr, ar, ck_p, cv_p = plain(xs[step], ck_p, cv_p, index, h)
        if not all(torch.isfinite(t.float()).all() for t in (xo, at)):
            fail(f"non-finite kernel output at index {index}")
        attn_max = max(attn_max, float(ar.max()))
        pairs = (("x_out", xo, xr), ("attn", at, ar), ("cache", ck_k, ck_p),
                 ("cache", cv_k, cv_p))
        for key, a, r in pairs:
            diff = (a.float() - r.float()).abs()
            errs[key] = max(errs[key], float(diff.max()))
            if key + "_ulps" in errs:
                errs[key + "_ulps"] = max(errs[key + "_ulps"],
                                          float((diff / bf16_ulp(r.float())).max()))
    return errs, attn_max


# Kernel vs plain limits, set from the readings (PERF.md). attn is a mean of
# softmax rows over S = 340, a typical value 1/340 = 2.9e-3: its limits sit
# far below that. int8 modes get the limits of the same kernel without them:
# both sides consume the same int8 tensors.
TOL = {
    ("K1", "float32"): {"x_out": 1e-5, "attn": 1e-6, "cache": 1e-5},
    ("K1", "bfloat16"): {"x_out": 3e-2, "attn": 5e-5, "cache_ulps": 1.0},
    # K3 rounds the hidden to bf16 after every layer and feeds it to the next,
    # so a rounding that falls the other way in layer l moves an input of
    # layer l+1 by one bf16 step (0.0156 at |x| ~ 2-4), and that input moves
    # every output and cache value of the later layers, near-zero ones too:
    # the bf16 limits of x and the caches are absolute, a few steps of O(1)
    # values (readings: <= 0.0234 and 0.0156). A wrong layer is off by O(0.1-1).
    ("K3", "float32"): {"x_out": 1e-5, "attn": 1e-6, "cache": 1e-5},
    ("K3", "bfloat16"): {"x_out": 0.0625, "attn": 5e-5, "cache": 0.0625},
}


def check_decode_modes(torch, dev, name, b, d, h, s, l_buf, modes_k1, modes_k3):
    """K1 (layer 0) in `modes_k1` and K3 (all layers) in `modes_k3`, f32 and
    bf16, at the first and the last three indices of a decode, against their
    plain versions. Returns {(kernel, mode, dtype): record}."""
    inp = seeded_decoder_inputs(torch, dev, SEED + 31 * b + d + l_buf, b, d, s, l_buf)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        dt_name = str(dt).replace("torch.", "")
        for mode in sorted(set(modes_k1) | set(modes_k3)):
            op = realize(torch, inp, dt, mode)
            for kern, steps, caches in (
                    ("K1", k1_step(op), (op["ck"][0], op["cv"][0])),
                    ("K3", k3_step(op), (op["ck"], op["cv"]))):
                if mode not in (modes_k1 if kern == "K1" else modes_k3):
                    continue
                errs, attn_max = {}, 0.0
                for first_index in (0, l_buf - 4):
                    e, a = chained_errors(torch, *steps, op["xs"], *caches, h,
                                          first_index, dt)
                    errs = {k: max(v, errs.get(k, 0.0)) for k, v in e.items()}
                    attn_max = max(attn_max, a)
                tol = TOL[(kern, dt_name)]
                src, repl = K1_SOURCE if kern == "K1" else K3_SOURCE
                rec = {"phase": "kernel",
                       "name": "fused_layer_step" if kern == "K1" else "stacked_decoder_step",
                       "mode": mode, "config": f"{name},B={b},S={s}", "route": "cuda",
                       "source": src, "replaces": repl,
                       "shape": {"B": b, "D": d, "H": h, "S": s, "L": l_buf,
                                 "n_layers": 1 if kern == "K1" else N_LAYERS},
                       "indices": [0, 1, 2, l_buf - 4, l_buf - 3, l_buf - 2],
                       "dtype": dt_name, "max_abs_err": errs, "tolerance": tol,
                       "attn_max": attn_max}
                rec["plan"] = plan_of(kern)
                emit(rec)
                for key, t in tol.items():
                    if not errs[key] <= t:
                        fail(f"{rec['name']}[{mode}, {name}, B={b}, {dt_name}] {key} "
                             f"differs from its plain version by {errs[key]} (> {t})")
                out[(kern, mode, dt_name)] = rec
    return out


# K3 against a chain of four K1 launches on the same operands. The two
# kernels round at different points (K1 rounds the scaled query and the
# probabilities to bf16, K3 keeps them f32; under kv8 K1 folds the scales
# into q and the PV sum, K3 into the K/V entries), so in bf16 they agree only
# within a band; in f32 the points coincide up to f32 rounding.
CHAIN_BAND = {"float32": {"x_out": 1e-4, "attn": 1e-6, "cache": 1e-4},
              "bfloat16": {"x_out": 0.125, "attn": 2e-4, "cache": 0.125}}


def check_k3_against_k1_chain(torch, dev, name, b, d, h, s, l_buf):
    out = {}
    inp = seeded_decoder_inputs(torch, dev, SEED + 77, b, d, s, l_buf)
    for dt in (torch.float32, torch.bfloat16):
        dt_name = str(dt).replace("torch.", "")
        for mode in ("none", "kv8+w8"):
            op = realize(torch, inp, dt, mode)
            k3 = k3_step(op)[0]
            k1s = [k1_step(op, li)[0] for li in range(N_LAYERS)]

            def chain(x, ck, cv, index, h_):
                attn = 0.0
                for li, k1 in enumerate(k1s):
                    x, a, _, _ = k1(x, ck[li], cv[li], index, h_)
                    attn = attn + a
                return x, attn / N_LAYERS, ck, cv

            errs = {}
            for first_index in (0, l_buf - 4):
                e, _ = chained_errors(torch, k3, chain, op["xs"], op["ck"], op["cv"],
                                      h, first_index, dt)
                errs = {k: max(v, errs.get(k, 0.0)) for k, v in e.items()}
            band = CHAIN_BAND[dt_name]
            rec = {"phase": "k3_vs_k1_chain", "mode": mode, "config": f"{name},B={b},S={s}",
                   "dtype": dt_name, "difference": errs, "band": band}
            emit(rec)
            for key, t in band.items():
                if not errs[key] <= t:
                    fail(f"stacked_decoder_step[{mode}, {dt_name}] differs from four "
                         f"fused_layer_step launches by {errs[key]} in {key} (> {t})")
            out[(mode, dt_name)] = errs
    return out


def check_determinism(torch, dev, kern, name, b, d, h, s, l_buf):
    """Two launches of K1 (layer 0) or K3 on the same operands (the caches
    cloned) give equal bits — x_out, attn and both caches — in bf16 and in
    kv8+w8, at the last index of a decode."""
    inp = seeded_decoder_inputs(torch, dev, SEED + 91 + b, b, d, s, l_buf)
    equal = {}
    for mode in ("none", "kv8+w8"):
        op = realize(torch, inp, torch.bfloat16, mode)
        if kern == "K1":
            step, ck, cv = k1_step(op)[0], op["ck"][0], op["cv"][0]
        else:
            step, ck, cv = k3_step(op)[0], op["ck"], op["cv"]
        runs = [step(op["xs"][0], ck.clone(), cv.clone(), l_buf - 2, h) for _ in range(2)]
        torch.cuda.synchronize()
        equal[mode] = all(torch.equal(a, r) for a, r in zip(*runs))
    emit({"phase": f"{kern.lower()}_determinism", "config": f"{name},B={b},S={s}",
          "dtype": "bfloat16", "bit_equal": equal, "plan": plan_of(kern)})
    bad = [m for m, ok in equal.items() if not ok]
    if bad:
        fail(f"{kern}[{bad}, {name}, B={b}]: two launches on the same operands differ")


def decode_bytes_flops(b, d, s, index, es, kv8, w8, n_layers):
    """Least bytes a decode step over n_layers layers must move, reckoned as
    tal_asrd_tpu/utils/flops.py's decode_step_bytes does: 1 byte per int8
    entry plus its f32 scales; each input read once, each output written
    once. And its operations (two per multiply-add)."""
    f = 4 * d
    n_w = 4 * d * d + 2 * d * f + 2 * d * d       # wqkv+wso, wf1+wf2, wcq+wco
    n_out = 3 * d + 4 * d + f                     # biases (and w8 scales)
    per_layer = (
        n_w * (1 if w8 else es) + (n_out * 4 if w8 else 0)    # weights (+ scales)
        + n_out * 4 + 8                                        # biases, rw
        + 2 * b * s * d * (1 if kv8 else es) + (2 * d * 4 if kv8 else 0)  # cross K/V
        + 2 * b * (index + 1) * d * es                         # live self cache read
        + 2 * b * d * es)                                      # cache row written
    bytes_moved = (n_layers * per_layer
                   + 2 * b * d * es                            # x in, x out
                   + 2 * b * s * 4)                            # pad bias in, attn out
    flops = 2.0 * b * n_layers * (n_w + 2 * (index + 1) * d + 2 * s * d)
    return bytes_moved, flops


def time_decode(torch, dev, kern, mode, b, d, h, s, l_buf, index, dtype):
    """Kernel, plain version and bound at one serving shape. K1 cycles the
    four layers' operands, as the decode loop does; K3 takes them all in one
    launch. The cross K/V (above the L2 size at 2x) thus comes from device
    memory, as it does for the real caller."""
    inp = seeded_decoder_inputs(torch, dev, SEED + 7, b, d, s, l_buf)
    op = realize(torch, inp, dtype, mode)
    x = op["xs"][0]
    if kern == "K1":
        steps = [k1_step(op, li) for li in range(N_LAYERS)]
        caches = [(op["ck"][li], op["cv"][li]) for li in range(N_LAYERS)]

        def run(which):
            def go():
                for st, (ck, cv) in zip(steps, caches):
                    st[which](x, ck, cv, index, h)
            return go
        per, n_layers = N_LAYERS, 1
    else:
        st = k3_step(op)

        def run(which):
            return lambda: st[which](x, op["ck"], op["cv"], index, h)
        per, n_layers = 1, N_LAYERS
    ms = time_graph_ms(run(0), 25) / per
    eager_ms = time_ms(run(0), 25) / per
    plain_ms = time_ms(run(1), 10) / per
    kv8, w8 = MODES[mode]
    bytes_moved, flops = decode_bytes_flops(b, d, s, index, x.element_size(), kv8, w8,
                                            n_layers)
    bound_ms, bound_by = bound(bytes_moved, flops, str(dtype).replace("torch.", ""))
    rec = {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "timed_shape": {"B": b, "D": d, "H": h, "S": s, "L": l_buf, "index": index,
                           "n_layers": n_layers},
           "bytes": bytes_moved, "plan": plan_of(kern)}
    return rec


# ---------------------------------------------------------------------------
# Phases 4-5: the serving path
# ---------------------------------------------------------------------------
def lockstep_trace(torch, model, fused, enc, prime, n_steps):
    """Step the unfused and the fused decoder side by side on the unfused
    path's greedy tokens. Per step and lane: the max logit deviation, the
    unfused top-1 margin, and whether the argmax agrees or the flip is
    excused (margin <= 2 x deviation: a correct kernel cannot flip a wider
    one). Returns a summary; `rel` is the deviation over the logit range."""
    b = prime.shape[0]
    st_r = model.init_decode_state(enc, b, n_steps + 1)
    st_f = fused.init_decode_state(enc, b, n_steps + 1)
    toks = prime[:, :1]
    maxdiff, rel, flips, unexcused = 0.0, 0.0, [], []
    for step in range(n_steps):
        lo_r, _, at_r, st_r = model.decode_step(toks, st_r)
        lo_f, _, at_f, st_f = fused.decode_step(toks, st_f)
        lo_r32, lo_f32 = lo_r.float(), lo_f.float()
        diff_lane = (lo_f32 - lo_r32).abs().amax(dim=-1)
        maxdiff = max(maxdiff, float(diff_lane.max()))
        rel = max(rel, float(diff_lane.max() / (lo_r32.max() - lo_r32.min() + 1e-9)))
        nxt_r = lo_r32.argmax(dim=-1)
        nxt_f = lo_f32.argmax(dim=-1)
        t2 = lo_r32.topk(2, dim=-1).values
        margin = t2[:, 0] - t2[:, 1]
        flip = nxt_r != nxt_f
        bad = flip & ~(margin <= 2.0 * diff_lane)
        flips += [(step, lane) for lane in torch.nonzero(flip).flatten().tolist()]
        for lane in torch.nonzero(bad).flatten().tolist():
            unexcused.append({"step": step, "lane": lane,
                              "margin": float(margin[lane]),
                              "deviation": float(diff_lane[lane])})
        if not (torch.isfinite(lo_f32).all() and torch.isfinite(at_f).all()):
            fail(f"non-finite fused decode output at step {step}")
        toks = nxt_r[:, None]
    return {"steps": n_steps, "logit_maxdiff": maxdiff, "logit_rel_maxdiff": rel,
            "argmax_flips": flips, "unexcused_flips": unexcused}


def rescore(torch, model, enc, tokens, p, lengths=None):
    """Length-normalized teacher-forced score of each row of `tokens` under
    the unfused full-sequence decoder: what a consistent search reports.
    Row i counts its tokens p .. lengths[i] - 1 (all of them without
    `lengths`) and is divided by its length."""
    n = tokens.shape[1]
    if lengths is None:
        lengths = torch.full((tokens.shape[0],), n, device=tokens.device)
    logits, _ = model.decode(tokens[:, :-1], enc)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_lp = logp.gather(-1, tokens[:, 1:, None])[..., 0]       # [B, L-1]: token j at j-1
    j = torch.arange(1, n, device=tokens.device)[None]
    counted = (j >= p) & (j < lengths[:, None])
    return (tok_lp * counted).sum(dim=-1) / lengths


def first_divergence(a, b):
    """Per lane: index of the first differing token, or -1."""
    ne = a != b
    return [int(np.argmax(row)) if row.any() else -1 for row in ne]


def profile_call(torch, tag, gen, args):
    """One traced call of `gen(*args)`: wall time, the device's busy time
    (sum of kernel durations; kernels of one stream do not overlap), and the
    kernels and host operators that take most of each."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # Rows of device type CUDA are the kernels and copies themselves; operator
    # rows repeat their kernels' time and are left out of the device sums, as
    # are user annotations on the device timeline (the optimizer's step
    # range), which span kernels counted on their own.
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
    dev_time = lambda e: e.self_device_time_total
    busy = sum(dev_time(e) for e in on_device) / 1e6
    top_dev = sorted(on_device, key=dev_time, reverse=True)[:8]
    top_cpu = sorted((e for e in events
                      if e.device_type != torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    rec = {"phase": "profile", "of": tag, "wall_seconds_traced": wall,
           "device_busy_seconds": busy,
           "device_idle_share": (1.0 - busy / wall) if busy > 0 else None,
           "device_launches": sum(e.count for e in on_device),
           "device_ranges": [{"name": e.key[:60], "ms": dev_time(e) / 1e3}
                             for e in events if getattr(e, "is_user_annotation", False)
                             and e.device_type == torch.autograd.DeviceType.CUDA],
           "top_device": [{"name": e.key[:60], "calls": e.count,
                           "ms": dev_time(e) / 1e3} for e in top_dev],
           "top_host": [{"name": e.key[:60], "calls": e.count,
                         "ms": e.self_cpu_time_total / 1e3} for e in top_cpu]}
    emit(rec)
    return rec


def serve(torch, dev, tag, model, audio_np, max_new, greedy_b, beam_b,
          trace=False, **decoder_flags):
    """One serving configuration: `decoder_flags` (kv8, w8, stacked) go to
    FusedASRDecoder; beam_b None skips the beam-5 leg."""
    from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, make_generate_fn
    from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_decode_stacked import stacked_decoder_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project

    counters = {"fused_layer_step": fused_layer_step,
                "stacked_decoder_step": stacked_decoder_step,
                "fused_logmel_project": fused_logmel_project}
    cfg = model.cfg
    fused = FusedASRDecoder(model, **decoder_flags)
    lens = np.full((audio_np.shape[0],), audio_np.shape[1], np.int64)
    out = {"phase": tag, "model_type": cfg.model_type, "d_decoder": cfg.d_decoder,
           "num_tokens": cfg.num_tokens, "dtype": str(model.dtype).replace("torch.", ""),
           "decoder_flags": decoder_flags,
           "window_samples": int(audio_np.shape[1]), "max_new_tokens": max_new}

    def spec(k):
        return BeamSearchSpec(beam_size=k, max_new_tokens=max_new, eos_id=-1,
                              vocab_size=cfg.num_tokens,
                              text_vocab_size=cfg.vocab_size, force_output=True)

    def run(gen, b):
        prime = np.ones((b, 1), np.int64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gen(audio_np[:b], lens[:b], prime)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # --- greedy, fused vs unfused, through the serving entry point ----------
    gen_f = make_generate_fn(model, spec(1), decoder=fused, device=dev)
    gen_u = make_generate_fn(model, spec(1), device=dev)
    run(gen_f, greedy_b)                                  # warm-up (cuDNN, caches)
    # The main path's run: counts set to 0 just before it, read just after.
    for fn in counters.values():
        fn.launches = 0
    res_f, secs_f = run(gen_f, greedy_b)
    launches_per_generate = {name: fn.launches for name, fn in counters.items()}
    res_u, secs_u = run(gen_u, greedy_b)
    if trace:
        profile_call(torch, tag + ":greedy_fused", gen_f,
                         (audio_np[:greedy_b], lens[:greedy_b],
                          np.ones((greedy_b, 1), np.int64)))
    tok_f = res_f["tokens"].cpu().numpy()
    tok_u = res_u["tokens"].cpu().numpy()
    p = 1
    expect_len = p + max_new
    if tok_f.shape != (greedy_b, expect_len) or \
            not bool((res_f["lengths"] == expect_len).all()) or \
            not bool(torch.isfinite(res_f["scores"]).all()) or \
            tok_f.min() < 0 or tok_f.max() >= cfg.num_tokens:
        fail(f"{tag}: malformed greedy output")
    # one decode step per token but the last; K1 once per layer and step, or
    # K3 once per step (and K1 never) in the stacked configurations
    steps = p + max_new - 1
    stacked = decoder_flags.get("stacked", False)
    expected = {"fused_layer_step": 0 if stacked else cfg.n_decoder_layers * steps,
                "stacked_decoder_step": steps if stacked else 0,
                "fused_logmel_project": 1}
    if launches_per_generate != expected:
        fail(f"{tag}: launches per generate {launches_per_generate}, expected {expected}")
    div = first_divergence(tok_f, tok_u)
    out["greedy"] = {
        "batch": greedy_b,
        "seconds_per_batch_fused": secs_f, "seconds_per_batch_unfused": secs_u,
        "audio_seconds_per_second_fused": greedy_b * audio_np.shape[1] / 16000.0 / secs_f,
        "audio_seconds_per_second_unfused": greedy_b * audio_np.shape[1] / 16000.0 / secs_u,
        "equal_token_share": float((tok_f == tok_u).mean()),
        "lanes_equal": int(sum(d < 0 for d in div)), "first_divergence": div,
        "launches_per_generate": launches_per_generate,
    }

    # --- lockstep logits: margin-aware agreement ------------------------------
    with torch.inference_mode():
        audio_t = torch.from_numpy(audio_np[:greedy_b]).to(dev)
        lens_t = torch.from_numpy(lens[:greedy_b]).to(dev)
        enc = model.encode(audio_t, lens_t)
        prime_t = torch.ones((greedy_b, 1), dtype=torch.long, device=dev)
        trace = lockstep_trace(torch, model, fused, enc, prime_t, max_new)
        resc = rescore(torch, model, enc, res_f["tokens"], p)
    out["lockstep"] = trace
    score_gap = float((resc - res_f["scores"]).abs().max())
    out["greedy"]["rescore_max_gap"] = score_gap
    if trace["logit_rel_maxdiff"] > 0.10:
        fail(f"{tag}: fused logits deviate by {trace['logit_rel_maxdiff']:.4f} "
             f"of the logit range (> 0.10)")
    if trace["unexcused_flips"]:
        fail(f"{tag}: fused argmax flips outside 2x the logit deviation: "
             f"{trace['unexcused_flips'][:4]}")
    # Every free-running divergence must start at a flip the trace saw and
    # excused (until then both paths were fed the same tokens).
    stray = [(lane, d) for lane, d in enumerate(div)
             if d >= 0 and (d - p, lane) not in trace["argmax_flips"]]
    if stray:
        fail(f"{tag}: greedy tokens diverge where the logits do not flip: "
             f"(lane, position) {stray[:4]}")
    out["greedy"]["divergences_excused_by_margin"] = sum(d >= 0 for d in div)
    trace["argmax_flips"] = len(trace["argmax_flips"])
    if score_gap > 0.05:
        fail(f"{tag}: greedy scores disagree with teacher-forced rescoring "
             f"by {score_gap}")

    if beam_b is None:
        out["launches_whole_phase"] = {name: fn.launches for name, fn in counters.items()}
        emit(out)
        return out

    # --- beam 5 through the fused path (exercises the cache reorder) ---------
    gen_b = make_generate_fn(model, spec(5), decoder=fused, device=dev)
    res_b, secs_b = run(gen_b, beam_b)
    with torch.inference_mode():
        # encoded again at the beam batch: the frontend's mean is one scalar
        # over the batch, so features depend on who shares the batch
        enc_b = model.encode(audio_t[:beam_b], lens_t[:beam_b])
        resc_b = rescore(torch, model, enc_b, res_b["tokens"], p)
    gap_b = float((resc_b - res_b["scores"]).abs().max())
    beats = float((res_b["scores"] - res_f["scores"][:beam_b]).min())
    out["beam5"] = {"batch": beam_b, "seconds_per_batch_fused": secs_b,
                    "rescore_max_gap": gap_b,
                    "min_score_gain_over_greedy": beats,
                    "lengths_ok": bool((res_b["lengths"] == expect_len).all())}
    if not out["beam5"]["lengths_ok"] or \
            not bool(torch.isfinite(res_b["scores"]).all()):
        fail(f"{tag}: malformed beam-5 output")
    # A search whose caches were gathered wrongly reports scores that its own
    # token rows do not earn when they are decoded again from scratch.
    if gap_b > 0.05:
        fail(f"{tag}: beam-5 scores disagree with teacher-forced rescoring "
             f"by {gap_b}")
    out["launches_whole_phase"] = {            # warm-up excluded
        name: fn.launches for name, fn in counters.items()}
    emit(out)
    return out


def build_2x(torch, dev):
    from tal_asrd_tpu_torch.core.config import ModelConfig
    from tal_asrd_tpu_torch.models.asr import ASRModel

    cfg = ModelConfig(model_type="2x", num_speakers=64, vocab_size=10000)
    gen = torch.Generator().manual_seed(SEED)
    model = ASRModel(cfg, dtype=torch.bfloat16, device="cpu", generator=gen)
    with torch.no_grad():
        for prm in model.parameters():
            if prm.dim() == 0:
                prm.fill_(0.3)     # raw-init ReZero scalars are 0: no branch would count
    return model.to(dev)


def build_1x_checkpoint(torch, dev, root):
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree
    from tal_asrd_tpu_torch.core.config import ModelConfig
    from tal_asrd_tpu_torch.core.convert import load_into, params_to_state_dict
    from tal_asrd_tpu_torch.models.asr import ASRModel

    path = os.path.join(root, "accuracy_release", "avg_last_3.bf16.msgpack")
    tree = load_pytree(path)
    n_leaves = len(params_to_state_dict(tree))
    cfg = ModelConfig(model_type="1x", num_speakers=8, vocab_size=300)
    model = ASRModel(cfg, dtype=torch.bfloat16, device="cpu")
    load_into(model, tree)
    return model.to(dev), n_leaves


def speechlike_audio(rng, b, n):
    """Noise plus a few amplitude-modulated sines per lane."""
    t = np.arange(n, dtype=np.float32) / 16000.0
    audio = rng.standard_normal((b, n)).astype(np.float32) * 0.02
    for lane in range(b):
        for _ in range(4):
            f0 = rng.uniform(100.0, 3000.0)
            am = 0.5 * (1.0 + np.sin(2 * np.pi * rng.uniform(0.5, 4.0) * t))
            audio[lane] += (0.1 * am * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
    return audio


# ---------------------------------------------------------------------------
# Phase 5b: the aligned evaluation of the tracked checkpoint (eval_aligned_1x)
# ---------------------------------------------------------------------------
# The synthetic test split as scripts/ensure_corpus.sh builds it; the CLI at
# its defaults cuts it into 118 segments of 3-8.3 s, in two batches of 64
# and 54 in the 10 s audio bucket (160000 samples, 1001 frames, S = 108
# encoder frames) and the 32-token text bucket (max_new = 37, caches of 38).
EVAL_SPLIT = dict(n_episodes=4, episode_seconds=180.0, n_speakers=8, seed=202)
EVAL_SAMPLES = 160_000
EVAL_S, EVAL_CAP = 108, 38
EVAL_LANES = (320, 270)              # beam 5 x 64 and x 54
EVAL_FIXTURE = os.path.join("tests", "fixtures", "torch_aligned_eval_reference.json")


def check_eval_kernels(torch, dev):
    """K1 (bf16, per layer) at the eval path's beam lanes, S = 108, cap 38, at
    the first and the last indices, and timed at 320 lanes, last step; K2 at
    N = 64 x 1001 = 64064 rows."""
    k1 = {}
    for b in EVAL_LANES:
        worst = None
        for first_index in (0, EVAL_CAP - 4):
            rec = check_layer_step(torch, dev, f"eval_1x,B={b},S={EVAL_S},L={EVAL_CAP}",
                                   b, 256, 4, EVAL_S, EVAL_CAP, torch.bfloat16, first_index)
            if worst is not None:
                for k, v in worst["max_abs_err"].items():
                    rec["max_abs_err"][k] = max(rec["max_abs_err"][k], v)
            worst = rec
        k1[b] = worst
    k1[EVAL_LANES[0]].update(time_decode(torch, dev, "K1", "none", EVAL_LANES[0], 256, 4,
                                         EVAL_S, EVAL_CAP, EVAL_CAP - 2, torch.bfloat16))
    k2 = check_logmel(torch, dev, 64, EVAL_SAMPLES)
    return k1, k2


def run_eval_aligned_1x(torch, dev, root, out_dir, card, k1_plans, trace=False):
    """`python -m tal_asrd_tpu_torch.cli.test` on the card at its defaults
    (batch 64, beam 5, segments of 3 s to 20 s) with the tracked checkpoint,
    on the test split built by the port's build_synth_corpus: once unfused
    and once with --fused-decode (K1 four launches a decode step), after an
    unfused warm-up run that is neither counted nor timed. Each run
    is scored by the port's convert_results + corpus WER / WDER, and every
    chosen row's beam score is given back by teacher-forced rescoring under
    the unfused model. Gates: fused within 0.5 points of unfused, unfused
    within 1.0 point of the JAX CPU reference (EVAL_FIXTURE), rescoring
    within 0.05, the launch counts. With `trace`, each run is repeated once
    under torch.profiler (after its counted run)."""
    from tal_asrd_tpu_torch.cli import test as cli_test
    from tal_asrd_tpu_torch.data.aligned import AlignedDataset
    from tal_asrd_tpu_torch.data.collate import BucketedCollater
    from tal_asrd_tpu_torch.data.loader import DataLoader
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
    from tal_asrd_tpu_torch.eval.convert import score_test_result
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

    split = os.path.join(out_dir, "eval_split")
    t0 = time.perf_counter()
    build_synth_corpus(split, **EVAL_SPLIT)
    split_seconds = time.perf_counter() - t0
    bpe = os.path.join(root, "accuracy_release", "bpe.model")
    ds = AlignedDataset(split, BpeTokenizer(model_path=bpe), num_utterances=1,
                        min_segment_duration=3, max_segment_duration=20,
                        speaker_map_loc=os.path.join(split, "speaker_map.json"),
                        tokenizer_speakers=True, return_spk_ids=True)
    batches = list(DataLoader(ds, 64, BucketedCollater(2), num_workers=0, drop_last=False))
    audio_seconds = sum(float(b["audio_lens"].sum()) for b in batches) / 16000.0
    with open(os.path.join(root, EVAL_FIXTURE)) as f:
        ref = json.load(f)
    with open(os.path.join(root, "ACCURACY.json")) as f:
        published = json.load(f)

    counters = {"fused_layer_step": fused_layer_step,
                "fused_logmel_project": fused_logmel_project}
    steps_taken = [0]
    step_of = FusedASRDecoder.decode_step

    def counted_step(self, *args, **kwargs):
        steps_taken[0] += 1
        return step_of(self, *args, **kwargs)

    def cli_argv(name):
        return ["--train-data", split, "--valid-data", split, "--test-data", split,
                "--tokenizer", bpe, "--model-type", "1x", "--num-speakers", "8",
                "--load", os.path.join(root, "accuracy_release", "avg_last_3.bf16.msgpack"),
                "--out-dir", os.path.join(out_dir, f"eval_{name}"), "--device", dev
                ] + (["--fused-decode"] if name == "fused" else [])

    # Warm-up at this path's shapes, outside the counted and timed runs:
    # cuDNN and cuBLAS pick their kernels for the encoder's shapes and the
    # allocator grows (the first run in a process took ~4 s more).
    cli_test.main(cli_argv("unfused"))
    runs = {}
    for name in ("unfused", "fused"):
        out, argv = os.path.join(out_dir, f"eval_{name}"), cli_argv(name)
        FusedASRDecoder.decode_step = counted_step
        steps_taken[0] = 0
        try:
            # The main path's run: counts set to 0 just before it, read just after.
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = cli_test.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
        finally:
            FusedASRDecoder.decode_step = step_of
        plan = plan_of("K1") if name == "fused" else None
        if trace:
            profile_call(torch, f"eval_aligned_1x:{name}", cli_test.main, (argv,))
        scored = score_test_result(os.path.join(out, "test_result.pkl"))

        # every chosen row's score, rescored under the unfused model
        model, gaps = res["runner"].model, []
        with torch.inference_mode():
            for batch, step in zip(batches, res["steps"]):
                if not np.array_equal(batch["idx"], step["idx"]):
                    fail(f"eval_aligned_1x[{name}]: the CLI's batches are not the loader's")
                audio = torch.from_numpy(batch["audio"]).to(dev)
                enc = model.encode(audio, torch.from_numpy(batch["audio_lens"]).to(dev))
                lengths = torch.from_numpy(step["lengths"]).to(dev)
                resc = rescore(torch, model, enc, torch.from_numpy(step["tokens"]).to(dev), 1,
                               lengths)
                gaps.append(float((resc.cpu() - torch.from_numpy(step["scores"])).abs().max()))
        hyps = [step["tokens"][i, :step["lengths"][i]].tolist()
                for step in res["steps"] for i in range(len(step["idx"]))]
        equal = sum(h == r["tokens"] for h, r in zip(hyps, ref["segments"]))
        runs[name] = {
            "wer_pct": 100.0 * scored["overall_wer"], "wder_pct": 100.0 * scored["overall_wder"],
            "n_words": int(sum(scored["n_words"])), "test_loss": res["test_loss"],
            "seconds": secs, "audio_seconds_per_second": audio_seconds / secs,
            "launches": launches, "decode_steps": steps_taken[0],
            "rescore_max_gap": max(gaps),
            "all_found": bool(all(step["found"].all() for step in res["steps"])),
            "hypotheses_equal_to_reference": equal,
            "hypotheses_equal_share": equal / len(hyps),
            **({"k1_last_plan": plan} if plan else {})}
        del res, model
        torch.cuda.empty_cache()

    u, fz = runs["unfused"], runs["fused"]
    rec = {"phase": "eval_aligned_1x", "card": card, "segments": len(ds),
           "batches": [len(b["idx"]) for b in batches], "audio_seconds": audio_seconds,
           "split_seconds": split_seconds, "unfused": u, "fused": fz,
           "k1_plans": k1_plans, "k2_rows": [len(b["idx"]) * (1 + EVAL_SAMPLES // 160)
                                             for b in batches],
           "reference_jax_cpu": {k: ref[k] for k in ("wer_pct", "wder_pct", "test_loss",
                                                     "n_segments")},
           "accuracy_json_f32_checkpoint": {"wer_pct": published["wer_pct"],
                                            "wder_pct": published["wder_pct"]},
           "note": "accuracy_json_f32_checkpoint: the f32 checkpoint's figures, "
                   "not in the repository; printed, no gate"}
    emit(rec)
    n_batches = len(batches)
    if len(ds) != ref["n_segments"] or rec["batches"] != [64, 54]:
        fail(f"eval_aligned_1x: {len(ds)} segments in batches {rec['batches']}, "
             f"expected {ref['n_segments']} in [64, 54]")
    for name, r in runs.items():
        k1_want = 4 * r["decode_steps"] if name == "fused" else 0
        want = {"fused_layer_step": k1_want, "fused_logmel_project": 2 * n_batches}
        if r["launches"] != want or (name == "fused" and r["decode_steps"] < 2 * n_batches):
            fail(f"eval_aligned_1x[{name}]: launches {r['launches']} after "
                 f"{r['decode_steps']} fused decode steps, expected {want}")
        if r["rescore_max_gap"] > 0.05 or not np.isfinite(r["test_loss"]):
            fail(f"eval_aligned_1x[{name}]: beam scores disagree with teacher-forced "
                 f"rescoring by {r['rescore_max_gap']} (> 0.05), loss {r['test_loss']}")
    for key in ("wer_pct", "wder_pct"):
        if abs(fz[key] - u[key]) > 0.5:
            fail(f"eval_aligned_1x: fused {key} {fz[key]} is more than 0.5 points from "
                 f"unfused {u[key]}")
        if abs(u[key] - ref[key]) > 1.0:
            fail(f"eval_aligned_1x: unfused {key} {u[key]} is more than 1.0 point from "
                 f"the JAX CPU reference's {ref[key]}")
    return rec


# ---------------------------------------------------------------------------
# Phase 5c: the long-form evaluation of the tracked checkpoint (eval_unaligned_1x)
# ---------------------------------------------------------------------------
# The CLI's --unaligned legs over the same split. The state machine encodes
# the 4 equal-length episodes together (K2 at N = 4 x 18001 rows) and runs
# each through windows of chunk_size = 357 encoder frames and a history of
# max_positions = 512 tokens: K1 takes one cache index per launch, so a lane
# decodes alone (B = 1, S = 357, caches of 512). The VAD leg decodes the
# windows in [16, bucket] batches, beam 5: K1 at 80 lanes with S = 46, 108,
# 233 and caches of 33, 61, 121 (5, 10, 20 s buckets; max_new 32, 60, 120),
# K2 at N = 16 x 501, 1001, 2001.
UNALIGNED_FIXTURE = os.path.join("tests", "fixtures", "torch_unaligned_eval_reference.json")
SM_GROUP, SM_EPISODE_SAMPLES = 4, 2_880_000
SM_S, SM_CAP = 357, 512
SM_LANES = (1, 4)                    # 1: the path's; 4: the group's lanes side by side
VAD_LANES = 80                       # 16 windows x beam 5
VAD_SHAPES = ((5, 80_000, 46, 33), (10, 160_000, 108, 61), (20, 320_000, 233, 121))
HANDOFF_HISTORY = (1, 64, 448)       # 448 = 512 - 64: the history after an eviction


def worst_of(records):
    """The first record with each error the worst over all of them."""
    rec = dict(records[0])
    rec["max_abs_err"] = {k: max(r["max_abs_err"][k] for r in records)
                          for k in records[0]["max_abs_err"]}
    rec["indices"] = sorted({i for r in records for i in r["indices"]})
    return rec


def check_unaligned_kernels(torch, dev):
    """K1 (bf16, per layer) at the long-form path's shapes — the state
    machine's lanes (B = 1, 4; S = 357; cache 512) at the first index, the
    middle and cap - 1, the VAD leg's 80 lanes at each bucket's S and cache,
    first and last indices — each timed; K2 at the state machine's group
    (N = 72004) and at each VAD bucket (N = 16 x frames)."""
    k1, k2 = {}, {}
    for b in SM_LANES:
        k1[("sm", b)] = worst_of([
            check_layer_step(torch, dev, f"eval_unaligned_1x:sm,B={b},S={SM_S},L={SM_CAP}",
                             b, 256, 4, SM_S, SM_CAP, torch.bfloat16, first)
            for first in (0, SM_CAP // 2 - 2, SM_CAP - 3)])
    k1[("sm", 1)].update(time_decode(torch, dev, "K1", "none", 1, 256, 4, SM_S, SM_CAP,
                                     SM_CAP // 2 - 1, torch.bfloat16))
    for secs, _, s, cap in VAD_SHAPES:
        k1[("vad", secs)] = worst_of([
            check_layer_step(torch, dev, f"eval_unaligned_1x:vad,B={VAD_LANES},S={s},L={cap}",
                             VAD_LANES, 256, 4, s, cap, torch.bfloat16, first)
            for first in (0, cap - 4)])
        k1[("vad", secs)].update(time_decode(torch, dev, "K1", "none", VAD_LANES, 256, 4, s,
                                             cap, cap - 2, torch.bfloat16))
    k2["sm"] = check_logmel(torch, dev, SM_GROUP, SM_EPISODE_SAMPLES)
    for secs, samples, _, _ in VAD_SHAPES:
        k2[("vad", secs)] = check_logmel(torch, dev, 16, samples)
    return k1, k2


def check_prefill_handoff(torch, dev, model, card):
    """FusedASRDecoder.decode_prefill writes the caches through the model's
    full-sequence path; K1 continues from them at every window event of the
    state machine. On one 357-frame window of the tracked checkpoint's
    encoder output (the last 20 frames padded) and a history of L tokens
    (L = 1, 64, 448; the rest of the 512-token buffer other tokens): the
    prefill, then one token step, each layer through K1 and through its
    plain version on the same inputs (the chain carried on by the plain
    version), per layer and under kv8 (the prefill dequantizes the int8
    cross K/V). Gate: K1's bf16 limits (TOL)."""
    from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step, layer_step_plain

    rng = np.random.default_rng(SEED + 17)
    audio = torch.from_numpy(speechlike_audio(rng, 1, 480_000)).to(dev)
    tol = TOL[("K1", "bfloat16")]
    out = {}
    with torch.inference_mode():
        window = model.encode(audio)["encoder_out"][:, :SM_S]
        if window.shape[1] != SM_S:
            fail(f"prefill hand-off: a window of {window.shape[1]} frames, not {SM_S}")
        mask = torch.zeros((1, SM_S), dtype=torch.bool, device=dev)
        mask[:, -20:] = True
        hist = torch.from_numpy(rng.integers(3, 300, (1, SM_CAP))).to(dev)
        for kv8 in (False, True):
            fused = FusedASRDecoder(model, kv8=kv8)
            mem = fused.precompute_mem_kvs(window)
            bias = fused._pad_bias(mask, 1, SM_S, window.device)
            for hl in HANDOFF_HISTORY:
                _, attn_all, caches = fused.decode_prefill(hist, mem, mask, SM_CAP)
                if not bool(caches[0]["k"][:, :hl].float().abs().sum(-1).gt(0).all()):
                    fail(f"prefill hand-off: the prefill left empty cache rows below {hl}")
                x = model.embed_tokens(hist[:, hl]) + fused._pe[hl]
                errs = {k: 0.0 for k in ("x_out", "attn", "cache", "x_out_ulps", "cache_ulps")}
                for li, w in enumerate(fused.packed):
                    kv, c = mem[li], caches[li]
                    runs = [fn(x, w, c["k"].clone(), c["v"].clone(), kv["k"], kv["v"], bias, hl,
                               4, kv.get("sk"), kv.get("sv"))
                            for fn in (fused_layer_step, layer_step_plain)]
                    torch.cuda.synchronize()
                    (xk, ak, ckk, cvk), (xp, ap, ckp, cvp) = runs
                    for key, a, r in (("x_out", xk, xp), ("attn", ak, ap),
                                      ("cache", ckk, ckp), ("cache", cvk, cvp)):
                        diff = (a.float() - r.float()).abs()
                        errs[key] = max(errs[key], float(diff.max()))
                        if key + "_ulps" in errs:
                            errs[key + "_ulps"] = max(errs[key + "_ulps"], float(
                                (diff / bf16_ulp(r.float())).max()))
                    x = xp
                out[(kv8, hl)] = errs
                for key, t in tol.items():
                    if not errs[key] <= t:
                        fail(f"prefill hand-off[kv8={kv8}, history {hl}]: K1 {key} differs "
                             f"from its plain version by {errs[key]} (> {t})")
    emit({"phase": "prefill_handoff", "card": card, "window": SM_S, "cache": SM_CAP,
          "tolerance": tol, "errors": {f"{'kv8' if k else 'bf16'},history={h}": e
                                       for (k, h), e in out.items()}})
    return out


def vad_near_ties(torch, dev, vad_calls):
    """Where the fused and the unfused VAD runs part. Per batch of windows
    (the same batches in both runs): the rows whose chosen tokens differ,
    and for each the gap between the two rows' length-normalized scores
    under the unfused model (teacher-forced), printed; and a greedy decode
    of the batch by both decoders in lockstep (`lockstep_trace`), whose
    argmax flips must each lie within twice the logit deviation of a tie
    (a gate)."""
    from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder

    model = vad_calls["model"]
    fused = FusedASRDecoder(model)
    differing, gaps, steps, flips, unexcused = 0, [0.0], 0, 0, []
    with torch.inference_mode():
        for cu, cf in zip(vad_calls["unfused"], vad_calls["fused"]):
            enc = model.encode(torch.from_numpy(cu["audio"]).to(dev),
                               torch.from_numpy(cu["lens"]).to(dev))
            tr = lockstep_trace(torch, model, fused, enc,
                                torch.from_numpy(cu["prime"]).to(dev), cu["tokens"].shape[1] - 1)
            steps, flips = steps + tr["steps"], flips + len(tr["argmax_flips"])
            unexcused += tr["unexcused_flips"]
            rows = [r for r in range(len(cu["lens"])) if cu["lens"][r] > 1 and not torch.equal(
                cu["tokens"][r, :cu["lengths"][r]], cf["tokens"][r, :cf["lengths"][r]])]
            for r in rows:
                one = {k: (v[r:r + 1] if torch.is_tensor(v) else v) for k, v in enc.items()}
                su, sf = (float(rescore(torch, model, one, c["tokens"][r:r + 1].to(dev), 1,
                                        c["lengths"][r:r + 1].to(dev)))
                          for c in (cu, cf))
                gaps.append(abs(su - sf))
            differing += len(rows)
    return {"windows": sum(int((c["lens"] > 1).sum()) for c in vad_calls["unfused"]),
            "differing_rows": differing, "max_score_gap_of_differing_rows": max(gaps),
            "greedy_lockstep_steps": steps, "greedy_argmax_flips": flips,
            "unexcused_flips": unexcused}


def run_eval_unaligned_1x(torch, dev, root, out_dir, card, trace=False):
    """`python -m tal_asrd_tpu_torch.cli.test --unaligned [--vad-windows]`
    on the card with the tracked checkpoint over the synthetic test split:
    each leg once unfused and once with --fused-decode (K1 four launches a
    decode step), after an unfused warm-up run of that leg that is neither
    counted nor timed. Each run is scored by the port's convert_results +
    corpus WER / WDER under keys of its own leg (unaligned_sm_*,
    unaligned_vad_*) and held against the JAX CLI's figures on the CPU
    (UNALIGNED_FIXTURE). Gates: the VAD windows equal the reference's, VAD
    unfused within 1.0 point of it, fused within 0.5 of unfused (or, where
    not, both within 0.5 of the reference, on either side of it), no
    fused-vs-unfused greedy flip wider than twice the logit deviation
    (`vad_near_ties`, which also prints the windows whose chosen rows
    differ), each chosen beam row re-earned by teacher-forced rescoring
    within 0.05; the state machine unfused within 2.0 (WER) / 3.0
    (WDER) points of the reference, fused within 2.0 / 3.0 of unfused,
    every episode inside max_iters; the launch counts. Prints each
    episode's first token that differs from the reference's and its event
    counts."""
    from tal_asrd_tpu_torch.cli import test as cli_test
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
    from tal_asrd_tpu_torch.decode.unaligned import UnalignedSpec
    from tal_asrd_tpu_torch.eval.convert import score_test_result
    from tal_asrd_tpu_torch.eval.runner import EvalRunner
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project

    split = os.path.join(out_dir, "eval_split")
    if not os.path.exists(os.path.join(split, "transcript.pkl")):
        build_synth_corpus(split, **EVAL_SPLIT)
    bpe = os.path.join(root, "accuracy_release", "bpe.model")
    with open(os.path.join(root, UNALIGNED_FIXTURE)) as f:
        ref = json.load(f)["legs"]
    with open(os.path.join(root, "ACCURACY.json")) as f:
        published = json.load(f)
    audio_seconds = EVAL_SPLIT["n_episodes"] * EVAL_SPLIT["episode_seconds"]
    max_iters = UnalignedSpec(eos_id=1).max_iters

    counters = {"fused_layer_step": fused_layer_step,
                "fused_logmel_project": fused_logmel_project}
    steps_taken = [0]
    calls = []
    step_of, generate_of = FusedASRDecoder.decode_step, EvalRunner._generate_fn

    def counted_step(self, *args, **kwargs):
        steps_taken[0] += 1
        return step_of(self, *args, **kwargs)

    def recorded_generate(self, max_new):
        # each beam search of the VAD leg: its batch, its chosen rows and the
        # launches it made (read off the counters around the call)
        run = generate_of(self, max_new)

        def call(audio, lens, prime):
            before = {k: fn.launches for k, fn in counters.items()}
            out = run(audio, lens, prime)
            torch.cuda.synchronize()
            calls.append({"audio": audio, "lens": lens, "prime": prime,
                          "bucket": audio.shape[1],
                          **{k: out[k].cpu() for k in ("tokens", "lengths", "scores", "found")},
                          "launches": {k: fn.launches - before[k]
                                       for k, fn in counters.items()}})
            return out
        return call

    def cli_argv(leg, name):
        return ["--train-data", split, "--valid-data", split, "--test-data", split,
                "--tokenizer", bpe, "--model-type", "1x", "--num-speakers", "8",
                "--load", os.path.join(root, "accuracy_release", "avg_last_3.bf16.msgpack"),
                "--out-dir", os.path.join(out_dir, f"unaligned_{leg}_{name}"),
                "--device", dev, "--unaligned"] + (
                    ["--vad-windows"] if leg == "vad" else []) + (
                    ["--fused-decode"] if name == "fused" else [])

    runs, vad_calls = {}, {}
    for leg in ("vad", "sm"):
        cli_test.main(cli_argv(leg, "unfused"))          # warm-up, not counted
        for name in ("unfused", "fused"):
            argv = cli_argv(leg, name)
            FusedASRDecoder.decode_step = counted_step
            EvalRunner._generate_fn = recorded_generate
            steps_taken[0] = 0
            calls.clear()
            try:
                # The main path's run: counts set to 0 just before it, read just after.
                for fn in counters.values():
                    fn.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = cli_test.main(argv)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches = {k: fn.launches for k, fn in counters.items()}
            finally:
                FusedASRDecoder.decode_step = step_of
                EvalRunner._generate_fn = generate_of
            if trace and name == "fused":
                profile_call(torch, f"eval_unaligned_1x:{leg}:{name}", cli_test.main, (argv,))
            scored = score_test_result(os.path.join(out_dir, f"unaligned_{leg}_{name}",
                                                    "test_result.pkl"))
            r = {f"unaligned_{leg}_wer_pct": 100.0 * scored["overall_wer"],
                 f"unaligned_{leg}_wder_pct": 100.0 * scored["overall_wder"],
                 "n_words": int(sum(scored["n_words"])), "seconds": secs,
                 "audio_seconds_per_second": audio_seconds / secs, "launches": launches,
                 "decode_steps": steps_taken[0]}
            if leg == "vad":
                model, gaps, by_bucket = res["runner"].model, [], {}
                with torch.inference_mode():
                    for c in calls:
                        # the windows' rows that ended in EOS (zero rows fill a batch)
                        rows = torch.from_numpy(np.flatnonzero(
                            (c["lens"] > 1) & c["found"].numpy()))
                        enc = model.encode(torch.from_numpy(c["audio"]).to(dev),
                                           torch.from_numpy(c["lens"]).to(dev))
                        resc = rescore(torch, model, enc, c["tokens"].to(dev), 1,
                                       c["lengths"].to(dev)).cpu()
                        gaps.append(float((resc - c["scores"])[rows].abs().max()))
                        b = by_bucket.setdefault(c["bucket"] // 16000, {
                            "calls": 0, "fused_layer_step": 0, "fused_logmel_project": 0})
                        b["calls"] += 1
                        for k, v in c["launches"].items():
                            b[k] += v
                vad_calls[name] = list(calls)
                vad_calls["model"] = model
                windows_equal = [st["windows"] == [(w["start"], w["end"]) for w in ep["windows"]]
                                 for st, ep in zip(res["steps"], ref["vad"]["episodes"])]
                want = [[w["tokens"][:-1] if w["found"] and w["length"] > 1 else w["tokens"]
                         for w in ep["windows"]] for ep in ref["vad"]["episodes"]]
                r.update({
                    "rescore_max_gap": max(gaps), "windows_equal": windows_equal,
                    "rows_rescored": sum(int(((c["lens"] > 1) & c["found"].numpy()).sum())
                                         for c in calls),
                    "rows": sum(int((c["lens"] > 1).sum()) for c in calls),
                    "windows": [st["num_windows"] for st in res["steps"]],
                    "windows_per_bucket": [st["buckets"] for st in res["steps"]],
                    "by_bucket": by_bucket,
                    "windows_with_reference_tokens": sum(
                        a == b for st, w in zip(res["steps"], want)
                        for a, b in zip(st["window_tokens"], w))})
                del model
            else:
                r["episodes"] = [{
                    "idx": st["idx"], "num_tokens": st["num_tokens"], "iters": st["iters"],
                    "events": st["events"],
                    "reference_num_tokens": ep["num_tokens"], "reference_iters": ep["iters"],
                    "first_divergence": next(
                        (i for i, (a, b) in enumerate(zip(st["tokens"], ep["tokens"])) if a != b),
                        -1 if len(st["tokens"]) == len(ep["tokens"])
                        else min(len(st["tokens"]), len(ep["tokens"])))}
                    for st, ep in zip(res["steps"], ref["sm"]["episodes"])]
            runs[(leg, name)] = r
            del res
            torch.cuda.empty_cache()

    near_ties = vad_near_ties(torch, dev, vad_calls)
    rec = {"phase": "eval_unaligned_1x", "card": card, "audio_seconds": audio_seconds,
           "vad_fused_vs_unfused": near_ties,
           **{f"{leg}_{name}": r for (leg, name), r in runs.items()},
           "reference_jax_cpu": {f"unaligned_{leg}_{k}": ref[leg][k]
                                 for leg in ("vad", "sm") for k in ("wer_pct", "wder_pct")},
           "accuracy_json_f32_checkpoint": {
               "unaligned_wer_pct": published["unaligned_wer_pct"],
               "unaligned_wder_pct": published["unaligned_wder_pct"],
               "unaligned_flags": published["unaligned_flags"]},
           "note": "accuracy_json_f32_checkpoint: the f32 checkpoint's figures (VAD "
                   "windows), not in the repository; printed, no gate"}
    emit(rec)

    for (leg, name), r in runs.items():
        k1_want = 4 * r["decode_steps"] if name == "fused" else 0
        if r["launches"]["fused_layer_step"] != k1_want or (
                name == "fused" and r["decode_steps"] == 0):
            fail(f"eval_unaligned_1x[{leg}, {name}]: K1 launches {r['launches']} after "
                 f"{r['decode_steps']} fused decode steps, expected {k1_want}")
        k2_want = (sum(b["calls"] for b in r["by_bucket"].values()) if leg == "vad" else 1)
        if r["launches"]["fused_logmel_project"] != k2_want:
            fail(f"eval_unaligned_1x[{leg}, {name}]: K2 launches {r['launches']}, "
                 f"expected {k2_want}")
        if leg == "vad":
            if not all(r["windows_equal"]):
                fail(f"eval_unaligned_1x[vad, {name}]: windows differ from the reference's "
                     f"({r['windows_equal']})")
            if r["rescore_max_gap"] > 0.05:
                fail(f"eval_unaligned_1x[vad, {name}]: beam scores disagree with "
                     f"teacher-forced rescoring by {r['rescore_max_gap']} (> 0.05)")
        elif not all(0 < ep["iters"] < max_iters for ep in r["episodes"]):
            fail(f"eval_unaligned_1x[sm, {name}]: an episode ran out of max_iters "
                 f"({[ep['iters'] for ep in r['episodes']]})")
    if near_ties["unexcused_flips"]:
        fail(f"eval_unaligned_1x[vad]: fused and unfused greedy decodes of the VAD batches "
             f"part at a margin wider than twice the logit deviation: "
             f"{near_ties['unexcused_flips'][:5]}")
    for leg, to_ref, fused_band in (("vad", (1.0, 1.0), (0.5, 0.5)),
                                     ("sm", (2.0, 3.0), (2.0, 3.0))):
        u, fz = runs[(leg, "unfused")], runs[(leg, "fused")]
        for key, limit_ref, limit_fused in zip(("wer_pct", "wder_pct"), to_ref, fused_band):
            k = f"unaligned_{leg}_{key}"
            # The VAD leg: beyond the band only where the two runs lie on either
            # side of the JAX reference, each within the band of it
            straddle = (leg == "vad" and abs(fz[k] - ref[leg][key]) <= limit_fused
                        and abs(u[k] - ref[leg][key]) <= limit_fused)
            if abs(fz[k] - u[k]) > limit_fused and not straddle:
                fail(f"eval_unaligned_1x: fused {k} {fz[k]} is more than {limit_fused} "
                     f"points from unfused {u[k]}")
            if abs(u[k] - ref[leg][key]) > limit_ref:
                fail(f"eval_unaligned_1x: unfused {k} {u[k]} is more than {limit_ref} "
                     f"points from the JAX CPU reference's {ref[leg][key]}")
    return runs


# ---------------------------------------------------------------------------
# Phases 6-7: the training path
# ---------------------------------------------------------------------------
def train_batch(torch, dev, seed, b, n_tokens, l=128, lo=64):
    """b seeded 20 s windows and text [b, l] with lengths drawn from lo..l,
    made on the card. The second half's lengths are a permutation of the
    first half's, so two micro-batches of b/2 hold the same number of real
    tokens (the grad_acc gate needs it; see gate_grad_acc)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    half = torch.randint(lo, l + 1, (b // 2,), generator=g, device=dev)
    perm = torch.randperm(b // 2, generator=g, device=dev)
    lens = torch.cat([half, half[perm]])
    return {
        "audio": torch.randn((b, TRAIN_SAMPLES), generator=g, device=dev) * 0.1,
        "audio_lens": torch.full((b,), TRAIN_SAMPLES, dtype=torch.int32, device=dev),
        "text": torch.randint(0, n_tokens, (b, l), generator=g, device=dev),
        "text_mask": torch.arange(l, device=dev)[None, :] < lens[:, None],
        "spk_ids": torch.zeros((b, l), dtype=torch.long, device=dev),
    }


def make_system(torch, dev, cfg, tc, state, compute_dtype, frontend=None):
    """An ASRSystem on the card with f32 parameters `state`."""
    from tal_asrd_tpu_torch.core.config import FrontendConfig
    from tal_asrd_tpu_torch.train.system import ASRSystem
    system = ASRSystem(cfg, tc, frontend or FrontendConfig(), compute_dtype=compute_dtype,
                       device=dev)
    system.model.load_state_dict(state)
    return system


def flat_grad(torch, system):
    return torch.cat([p.grad.float().flatten() for p in system.model.parameters()])


def run_train_2x(torch, dev, out_dir, trace=False):
    """The 2x model (D=512, 10064 tokens, seeded weights, ReZero scalars 0.3)
    trained by Trainer.fit for 10 steps on one repeated batch of 64 windows
    of 20 s at TrainConfig's defaults: f32 parameters, bf16 compute, LAMB at
    1e-4 * sqrt(64) with linear decay, dropout 0.2, SpecAugment, token
    replacement 0.01. Then the precision and accumulation gates."""
    import dataclasses
    from tal_asrd_tpu_torch.core.config import FrontendConfig, ModelConfig, TrainConfig
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.ops.specaug import spec_augment
    from tal_asrd_tpu_torch.train.loop import Trainer, TrainerConfig
    from tal_asrd_tpu_torch.utils.logging import MetricsLogger

    from tal_asrd_tpu_torch.models.asr import ASRModel

    steps, b = 10, 64
    cfg = ModelConfig(model_type="2x", num_speakers=64, vocab_size=10000)
    tc = TrainConfig(max_steps=steps)
    seeded = ASRModel(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for prm in seeded.parameters():
            if prm.dim() == 0:
                prm.fill_(0.3)     # raw-init ReZero scalars are 0: no branch would count
    state = seeded.state_dict()
    system = make_system(torch, dev, cfg, tc, state, torch.bfloat16)
    batch = train_batch(torch, dev, SEED + 1, b, cfg.num_tokens)
    logger = MetricsLogger(out_dir=out_dir, name="train_2x")
    trainer = Trainer(system, TrainerConfig(max_epochs=1, max_steps=steps, log_every=1,
                                            checkpoint_dir=os.path.join(out_dir, "ckpt_2x")),
                      logger)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # The main path's run: counts set to 0 just before it, read just after.
    for fn in (spec_augment, fused_logmel_project):
        fn.launches = 0
    spec_augment.backward_launches = 0
    t0 = time.perf_counter()
    trainer.fit([batch] * steps, [batch])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"spec_augment": spec_augment.launches,
                "spec_augment_backward": spec_augment.backward_launches,
                "fused_logmel_project": fused_logmel_project.launches}
    peak = torch.cuda.max_memory_allocated()
    logger.close()
    if trace:   # one more step, traced, after the counts were read
        profile_call(torch, "train_2x:step", system.train_step, (batch,))
    recs = [json.loads(line) for line in open(logger.path)]
    step_recs = [r for r in recs if "loss" in r and "step_time_s" in r]
    losses = [r["loss"] for r in step_recs]
    step_ms = [1e3 * r["step_time_s"] for r in step_recs]
    med = float(np.median(step_ms[2:]))
    out = {"phase": "train_2x", "model_type": "2x", "d_decoder": cfg.d_decoder,
           "num_tokens": cfg.num_tokens, "batch": b, "window_seconds": TRAIN_SAMPLES / 16000,
           "text_len": 128, "grad_acc": tc.grad_acc, "lr": tc.scaled_lr,
           "params_dtype": "float32", "compute_dtype": "bfloat16", "steps": system.step,
           "losses": losses, "grad_norms": [r["grad_norm"] for r in step_recs],
           "step_ms": step_ms, "median_step_ms_3_10": med,
           "audio_seconds_per_second": b * TRAIN_SAMPLES / 16000 / (med / 1e3),
           "fit_seconds_with_checkpoints": fit_s, "max_memory_allocated_bytes": peak,
           "launches": launches}
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"train_2x: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train_2x: the last loss {losses[-1]} is not below the first {losses[0]}")
    micro = steps * tc.grad_acc
    # K2 also runs once for the validation batch at the epoch's end
    want = {"spec_augment": micro, "spec_augment_backward": 0,
            "fused_logmel_project": micro + 1}
    if launches != want:
        fail(f"train_2x: launches {launches}, expected {want}")
    del trainer, system
    torch.cuda.empty_cache()

    # bf16 against f32: one step's loss and whole gradient, same weights,
    # batch and draws, dropout off
    no_drop = dataclasses.replace(cfg, dropout=0.0, tds_dropout=0.0)
    grads, loss = {}, {}
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        sys_ = make_system(torch, dev, no_drop, tc, state, dt)
        m = sys_.compute_grads(batch)
        loss[name], grads[name] = float(m["loss"]), flat_grad(torch, sys_)
        del sys_
    cos = float(torch.nn.functional.cosine_similarity(
        grads["bfloat16"], grads["float32"], dim=0))
    rel_loss = abs(loss["bfloat16"] - loss["float32"]) / abs(loss["float32"])
    out["bf16_vs_f32"] = {"loss": loss, "loss_rel_diff": rel_loss, "grad_cosine": cos}
    if not (rel_loss <= 0.02 and cos >= 0.99):
        fail(f"train_2x: bf16 against f32 loss {rel_loss:.4f} (> 0.02) or gradient "
             f"cosine {cos:.4f} (< 0.99)")
    del grads
    out["grad_acc_2_vs_1"] = gate_grad_acc(torch, dev, no_drop, tc, state, batch)
    emit(out)
    return out


def gate_grad_acc(torch, dev, cfg, tc, state, batch):
    """f32, dropout off: grad_acc=2 against grad_acc=1 on the same batch and
    draws. As tests/test_train.py does, the frontend's batch-wide mean
    subtraction is off (it couples the examples of a batch, so a micro-batch
    would see another mean) and the halves hold equal token counts
    (train_batch), so that the mean of the two halves' masked means is the
    full batch's."""
    import dataclasses
    from tal_asrd_tpu_torch.core.config import FrontendConfig
    fe = FrontendConfig(mean_subtract=False)
    res = {}
    for acc in (1, 2):
        sys_ = make_system(torch, dev, cfg, dataclasses.replace(tc, grad_acc=acc), state,
                           torch.float32, frontend=fe)
        m = sys_.compute_grads(batch)
        res[acc] = (float(m["loss"]), flat_grad(torch, sys_))
        del sys_
    rel_loss = abs(res[2][0] - res[1][0]) / abs(res[1][0])
    rel_grad = float((res[2][1] - res[1][1]).norm() / res[1][1].norm())
    rec = {"loss": [res[1][0], res[2][0]], "loss_rel_diff": rel_loss,
           "grad_rel_norm_diff": rel_grad}
    if not (rel_loss <= 1e-5 and rel_grad <= 1e-4):
        fail(f"train_2x: grad_acc=2 against 1: loss {rel_loss} (> 1e-5) or gradient "
             f"{rel_grad} (> 1e-4)")
    return rec


def run_train_1x_checkpoint(torch, dev, root, out_dir):
    """The tracked checkpoint in f32 parameters: 2 steps at B=8, a save
    through CheckpointManager, a reload through the port's reader (bit for
    bit), and a greedy fused generate (K1, K2) on both sets of weights."""
    from tal_asrd_tpu_torch.core.checkpoint import CheckpointManager, load_pytree
    from tal_asrd_tpu_torch.core.config import ModelConfig, TrainConfig
    from tal_asrd_tpu_torch.core.convert import load_into, params_to_state_dict
    from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, make_generate_fn
    from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
    from tal_asrd_tpu_torch.models.asr import ASRModel
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.ops.specaug import spec_augment

    tree = load_pytree(os.path.join(root, "accuracy_release", "avg_last_3.bf16.msgpack"))
    cfg = ModelConfig(model_type="1x", num_speakers=8, vocab_size=300)
    tc = TrainConfig(batch_size=8, max_steps=2)
    system = make_system(torch, dev, cfg, tc, params_to_state_dict(tree), torch.bfloat16)
    batch = train_batch(torch, dev, SEED + 2, 8, cfg.num_tokens)
    counters = {"spec_augment": spec_augment, "fused_logmel_project": fused_logmel_project,
                "fused_layer_step": fused_layer_step}
    for fn in counters.values():
        fn.launches = 0
    losses = [float(system.train_step(batch)["loss"]) for _ in range(2)]
    train_launches = {k: fn.launches for k, fn in counters.items()}
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt_1x"))
    path = mgr.save(system.step, system.params_tree())
    reloaded = ASRModel(cfg, dtype=torch.float32, compute_dtype=torch.bfloat16, device="cpu")
    load_into(reloaded, load_pytree(path))
    reloaded = reloaded.to(dev)
    mine = system.model.eval()
    unequal = [n for (n, a), b in zip(mine.state_dict().items(),
                                      reloaded.state_dict().values())
               if not torch.equal(a, b)]
    if unequal or not all(np.isfinite(losses)):
        fail(f"train_1x_checkpoint: losses {losses}, reloaded parameters differ: {unequal[:4]}")

    spec = BeamSearchSpec(beam_size=1, max_new_tokens=32, eos_id=-1,
                          vocab_size=cfg.num_tokens, text_vocab_size=cfg.vocab_size,
                          force_output=True)
    audio = speechlike_audio(np.random.default_rng(SEED + 3), 8, WINDOW_SAMPLES)
    lens = np.full((8,), WINDOW_SAMPLES, np.int64)
    prime = np.ones((8, 1), np.int64)
    toks = {}
    for name, model in (("in_memory", mine), ("reloaded", reloaded)):
        gen = make_generate_fn(model, spec, decoder=FusedASRDecoder(model), device=dev)
        for fn in counters.values():
            fn.launches = 0
        toks[name] = gen(audio, lens, prime)["tokens"].cpu().numpy()
        gen_launches = {k: fn.launches for k, fn in counters.items()}
    out = {"phase": "train_1x_checkpoint", "losses": losses, "steps": system.step,
           "checkpoint_bytes": os.path.getsize(path), "params_bit_equal": True,
           "tokens_equal": bool((toks["in_memory"] == toks["reloaded"]).all()),
           "train_launches": train_launches, "generate_launches": gen_launches}
    emit(out)
    want_train = {"spec_augment": 2, "fused_logmel_project": 2, "fused_layer_step": 0}
    want_gen = {"spec_augment": 0, "fused_logmel_project": 1,
                "fused_layer_step": cfg.n_decoder_layers * 32}
    if train_launches != want_train or gen_launches != want_gen:
        fail(f"train_1x_checkpoint: launches {train_launches} / {gen_launches}, "
             f"expected {want_train} / {want_gen}")
    if not out["tokens_equal"]:
        fail("train_1x_checkpoint: greedy tokens differ between the in-memory and the "
             "reloaded weights")
    return out


# ---------------------------------------------------------------------------
# Phase 7b: the training CLI on the tracked checkpoint (train_cli_1x)
# ---------------------------------------------------------------------------
# scripts/ensure_corpus.sh's train and valid splits (8 speakers, 120 s
# episodes, seeds 0 and 101), cut from 100 and 3 episodes to 8 and 2: at
# --max-secs 28.5 and --shiftaug, 150 aligned items and 96 windows a training
# epoch (15 steps at B = 16), 37 + 24 validation items (3 batches).
# scripts/accuracy.sh's last phase's flags, from the tracked checkpoint:
# run 1 three epochs without SpecAugment, run 2 resumes from run 1's last
# checkpoint in the same run directory for one more epoch with SpecAugment
# (K4), then average-ckpt --last-k 3 and the eval CLI on the average.
TRAIN_CLI_SPLITS = {"train": dict(n_episodes=8, episode_seconds=120.0, n_speakers=8, seed=0),
                    "valid": dict(n_episodes=2, episode_seconds=120.0, n_speakers=8, seed=101)}
TRAIN_CLI_CUT = "train 8 of 100 episodes, valid 2 of 3 (scripts/ensure_corpus.sh)"
TRAIN_CLI_EPOCH = 15                  # steps an epoch: 246 items // 16
TRAIN_CLI_FIXTURE = os.path.join("tests", "fixtures", "torch_train_cli_reference.json")
TRAIN_CLI_WER = 59.11                 # the tracked checkpoint, eval_aligned_1x unfused (PERF.md)


class _Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def int16_speech(rng, b, n):
    """speechlike_audio through 16-bit PCM, scaled back as the model scales
    int16 batches (what --audio-int16 gives the frontend)."""
    pcm = np.clip(np.rint(speechlike_audio(rng, b, n) * 32768.0), -32768, 32767)
    return pcm.astype(np.int16).astype(np.float32) / 32768.0


def run_train_cli_1x(torch, dev, root, out_dir, card, trace=False):
    """`python -m tal_asrd_tpu_torch.cli.train` (its `main`) twice from the
    tracked checkpoint at scripts/accuracy.sh's last phase's flags, then
    `cli.tools average-ckpt --last-k 3` and `cli.test` on the average. Gates:
    the load parity (the tracked checkpoint's validation loss through the
    CLI's own datasets, collater, loader and the system's eval_step, within
    1 % of the JAX CPU reference, TRAIN_CLI_FIXTURE), finite losses, run 2's
    last validation loss at most 5 % above the load parity's, one spot-check
    record with GOLD text per epoch validation, the restored step (logged;
    first new checkpoint past it; the run stops at --max-steps), every
    checkpoint 151 leaves of the tracked checkpoint's shapes, a state file
    on each run's last epoch, the average bit-equal to average_params, its
    WER within 10 points of TRAIN_CLI_WER; K2 at every audio shape the phase
    saw and K4 at [16, 3001, 80] against their plain versions on int16
    audio; K4 only in run 2, once a training step. With `trace`, run 2 is
    repeated once under torch.profiler (after the counted runs)."""
    from tal_asrd_tpu_torch.cli import test as cli_test
    from tal_asrd_tpu_torch.cli import tools as cli_tools
    from tal_asrd_tpu_torch.cli import train as cli_train
    from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
    from tal_asrd_tpu_torch.core.checkpoint import (
        CheckpointManager, average_params, load_pytree, tree_leaves)
    from tal_asrd_tpu_torch.core.config import FrontendConfig, SpecAugmentConfig
    from tal_asrd_tpu_torch.data.collate import BucketedCollater
    from tal_asrd_tpu_torch.data.loader import DataLoader, ShardedSampler
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.eval.convert import score_test_result
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.ops.logmel import log_mel_spectrogram
    from tal_asrd_tpu_torch.ops.specaug import spec_augment
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
    from tal_asrd_tpu_torch.train.system import ASRSystem

    base = os.path.join(out_dir, "train_cli")
    dirs = {k: os.path.join(base, k) for k in ("train", "valid", "test", "ckpts", "out")}
    t0 = time.perf_counter()
    for name, split in TRAIN_CLI_SPLITS.items():
        build_synth_corpus(dirs[name], **split)
    build_synth_corpus(dirs["test"], **EVAL_SPLIT)
    split_seconds = time.perf_counter() - t0
    bpe = os.path.join(root, "accuracy_release", "bpe.model")
    tracked = os.path.join(root, "accuracy_release", "avg_last_3.bf16.msgpack")
    with open(os.path.join(root, TRAIN_CLI_FIXTURE)) as f:
        ref = json.load(f)["load_parity"]
    def leaf_shapes(tree):
        return {path: np.shape(leaf) for path, leaf in tree_leaves(tree)}
    tracked_tree = leaf_shapes(load_pytree(tracked))
    counters = {"fused_logmel_project": fused_logmel_project, "spec_augment": spec_augment}

    # every audio batch shape the phase's collaters make (K2's shapes)
    shapes = set()
    collate = BucketedCollater.__call__

    def recording(self, samples):
        out = collate(self, samples)
        shapes.add(tuple(out["audio"].shape))
        return out
    BucketedCollater.__call__ = recording
    # every step's metrics logged, as scripts/torch_train_reference.py does
    trainer_config = cli_train.TrainerConfig
    cli_train.TrainerConfig = functools.partial(trainer_config, log_every=1)
    try:
        # ---- load parity: the tracked checkpoint through the CLI's data -------
        args = get_argparser(is_train=True).parse_args(
            [dirs["valid"] if a == "VALID" else os.path.join(root, a)
             if a.startswith("accuracy_release/") else a for a in ref["argv"]]
            + ["--device", dev])
        tokenizer = BpeTokenizer(model_path=bpe)
        model_cfg, train_cfg, _ = build_configs(args, tokenizer)
        system = ASRSystem(model_cfg, train_cfg, device=dev, specaug_cfg=SpecAugmentConfig(
            num_freq_masks=0, num_time_masks=0))
        cli_train.load_weights(args, system, model_cfg.num_tokens)
        _, valid = cli_train.build_datasets(args, tokenizer)
        loader = DataLoader(valid, args.val_batch_size or args.batch_size,
                            BucketedCollater(tokenizer.pad_token_id, audio_int16=True),
                            ShardedSampler(len(valid), shuffle=False), args.num_workers)
        batches = list(loader)
        losses = [float(system.eval_step(b)["loss"]) for b in batches]
        parity = {"val_loss": float(np.mean(losses)), "batch_losses": losses,
                  "reference_val_loss": ref["val_loss"],
                  "reference_batch_losses": ref["batch_losses"],
                  "audio_shapes": [list(b["audio"].shape) for b in batches]}
        parity["rel_err"] = abs(parity["val_loss"] - ref["val_loss"]) / ref["val_loss"]
        same_batches = (parity["audio_shapes"] == ref["audio_shapes"] and
                        [b["idx"].tolist() for b in batches] == ref["idx"])
        del system, batches
        torch.cuda.empty_cache()

        # ---- run 1, run 2 ---------------------------------------------------------
        common = ["--train-data", dirs["train"], "--valid-data", dirs["valid"],
                  "--tokenizer", bpe, "--model-type", "1x", "--num-speakers", "8",
                  "--batch-size", "16", "--max-secs", "28.5", "--num-workers", "0",
                  "--lr", "2e-4", "--max-epochs", "1000", "--ckpt-every", "1",
                  "--shiftaug", "--cache-items", "--audio-int16", "--name", "train_cli_1x",
                  "--checkpoint-path", dirs["ckpts"], "--out-dir", dirs["out"],
                  "--device", dev]
        run_dir = os.path.join(dirs["ckpts"], "train_cli_1x")
        n1 = 3 * TRAIN_CLI_EPOCH
        last1 = os.path.join(run_dir, f"ckpt_{n1:08d}.msgpack")
        argvs = {"run1": common + ["--max-steps", str(n1), "--load", tracked, "--no-specaug"],
                 "run2": common + ["--max-steps", str(n1 + TRAIN_CLI_EPOCH), "--load", last1]}
        metrics = os.path.join(dirs["out"], "train_cli_1x.metrics.jsonl")
        runs = {}
        for name, argv in argvs.items():
            seen = os.path.getsize(metrics) if os.path.exists(metrics) else 0
            before = set(os.listdir(run_dir)) if os.path.isdir(run_dir) else set()
            tee = _Tee(sys.stdout)
            torch.cuda.reset_peak_memory_stats()
            # The main path's run: counts set to 0 just before it, read just after.
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sys.stdout = tee
            try:
                out = cli_train.main(argv)
            finally:
                sys.stdout = tee.out
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            with open(metrics) as f:
                f.seek(seen)
                recs = [json.loads(line) for line in f if line.strip()]
            new = sorted(set(os.listdir(run_dir)) - before)
            steps = [r for r in recs if "loss" in r]
            epochs = [r for r in recs if "epoch_time_s" in r]
            train_s = sum(r["train_s"] for r in epochs)
            runs[name] = {
                "seconds": secs, "steps": len(steps), "epochs": len(epochs),
                "final_step": out["system"].step, "update_count": out["system"].update_count(),
                "first_step": steps[0]["step"] if steps else None,
                "step_time_ms_median": 1e3 * float(np.median(
                    [r["step_time_s"] for r in steps[1:]])),
                "audio_seconds": sum(r["audio_s"] for r in epochs),
                "audio_seconds_per_second": sum(r["audio_s"] for r in epochs) / train_s,
                "loader_wait_share": sum(r["loader_wait_s"] for r in epochs) / train_s,
                "loader_wait_share_of_run": sum(r["loader_wait_s"] for r in epochs) / secs,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "losses_finite": bool(all(np.isfinite(r["loss"]) for r in steps)),
                "first_loss": steps[0]["loss"] if steps else None,
                "last_loss": steps[-1]["loss"] if steps else None,
                "val_losses": [[r["step"], r["val_loss"]] for r in epochs],
                "generations": [[r["step"], r["ref"], r["hyp"]] for r in recs
                                if r.get("type") == "generation"],
                "checkpoints": [n for n in new if n.startswith("ckpt_")],
                "states": [n for n in new if n.startswith("state_")],
                "restored_log": "restored step counter to" in "".join(tee.parts),
                "launches": launches}
            del out
            torch.cuda.empty_cache()

        # ---- average-ckpt --last-k 3, then the eval CLI on the average ------------
        avg_path = os.path.join(base, "avg_last_3.msgpack")
        cli_tools.main(["average-ckpt", "--ckpt-dir", run_dir, "--last-k", "3",
                        "--out", avg_path])
        mgr = CheckpointManager(run_dir)
        avg, want = load_pytree(avg_path), average_params([mgr.load(s)
                                                           for s in mgr.steps()[-3:]])
        avg_leaves, want_leaves = dict(tree_leaves(avg)), dict(tree_leaves(want))
        avg_equal = (sorted(avg_leaves) == sorted(want_leaves) and all(
            v.dtype == np.float32 and v.tobytes() == want_leaves[k].tobytes()
            for k, v in avg_leaves.items()))
        ckpt_shapes_ok = {n: leaf_shapes(mgr.load(int(n[5:13]))) == tracked_tree
                          for n in sorted(os.listdir(run_dir)) if n.startswith("ckpt_")}
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        cli_test.main(["--train-data", dirs["test"], "--valid-data", dirs["test"],
                       "--test-data", dirs["test"], "--tokenizer", bpe, "--model-type", "1x",
                       "--num-speakers", "8", "--load", avg_path,
                       "--out-dir", os.path.join(base, "eval"), "--device", dev])
        torch.cuda.synchronize()
        eval_seconds = time.perf_counter() - t0
        eval_launches = {k: fn.launches for k, fn in counters.items()}
        scored = score_test_result(os.path.join(base, "eval", "test_result.pkl"))
        if trace:
            profile_call(torch, "train_cli_1x:run2", cli_train.main, (argvs["run2"],))
    finally:
        BucketedCollater.__call__ = collate
        cli_train.TrainerConfig = trainer_config

    # ---- K2 at every audio shape the phase saw, K4 at [16, 3001, 80], ----------
    # both on int16 audio
    rng = np.random.default_rng(SEED + 8)
    k2_recs = {}
    for b, n in sorted(shapes | {(1, n) for _, n in shapes}):
        audio = torch.from_numpy(int16_speech(rng, b, n)).to(dev)
        k2_recs[(b, n)] = check_logmel(torch, dev, b, n, audio=audio)
    audio = torch.from_numpy(int16_speech(rng, 16, 480_000)).to(dev)
    spec = log_mel_spectrogram(audio, FrontendConfig(),
                               audio_lens=torch.full((16,), 480_000, device=dev))
    k4 = check_specaug(torch, dev, 16, spec_in=spec.contiguous())
    k2 = k2_recs.get((16, 480_000)) or k2_recs[max(k2_recs)]
    k2_err = max(r["max_abs_err"] for r in k2_recs.values())

    r1, r2 = runs["run1"], runs["run2"]
    rec = {"phase": "train_cli_1x", "card": card, "cut": TRAIN_CLI_CUT,
           "splits": TRAIN_CLI_SPLITS, "split_seconds": split_seconds,
           "argv": {k: [a.replace(base, "OUT") for a in v] for k, v in argvs.items()},
           "load_parity": parity, "load_parity_same_batches": same_batches,
           "run1": r1, "run2": r2,
           "average": {"bit_equal_to_average_params": avg_equal,
                       "of": mgr.steps()[-3:], "leaves": len(avg_leaves)},
           "checkpoints_readback_ok": ckpt_shapes_ok,
           "eval_of_average": {"wer_pct": 100.0 * scored["overall_wer"],
                               "wder_pct": 100.0 * scored["overall_wder"],
                               "seconds": eval_seconds, "launches": eval_launches,
                               "tracked_checkpoint_wer_pct": TRAIN_CLI_WER},
           "k2_shapes": {f"{b}x{n}": {k: r[k] for k in ("shape", "max_abs_err", "ms",
                                                        "bound_ms", "plain_ms")}
                         for (b, n), r in k2_recs.items()},
           "k4": {k: k4[k] for k in ("shape", "checks", "ms", "graph_ms", "bound_ms",
                                     "plain_ms", "where_ms")}}
    emit(rec)

    # ---- gates -----------------------------------------------------------------
    problems = []
    if not same_batches or parity["rel_err"] > 0.01:
        problems.append(f"load parity {parity['val_loss']} vs the reference's "
                        f"{ref['val_loss']} (rel {parity['rel_err']:.4g} > 0.01, or other "
                        f"batches: {same_batches})")
    for name, r in runs.items():
        if not r["losses_finite"] or r["steps"] == 0:
            problems.append(f"{name}: {r['steps']} logged steps, finite {r['losses_finite']}")
        if len(r["generations"]) != r["epochs"] or not all(g[1] for g in r["generations"]):
            problems.append(f"{name}: {len(r['generations'])} spot checks with GOLD text "
                            f"for {r['epochs']} epoch validations")
        last = f"state_{r['final_step']:08d}.msgpack"
        if r["states"] != [last]:
            problems.append(f"{name}: state files {r['states']}, expected [{last}]")
    if r1["final_step"] != n1 or r1["checkpoints"] != [
            f"ckpt_{TRAIN_CLI_EPOCH * e:08d}.msgpack" for e in (1, 2, 3)]:
        problems.append(f"run1: step {r1['final_step']}, checkpoints {r1['checkpoints']}")
    if not (r2["restored_log"] and r2["first_step"] == n1 + 1
            and r2["final_step"] == n1 + TRAIN_CLI_EPOCH and r2["update_count"] == TRAIN_CLI_EPOCH
            and r2["checkpoints"] == [f"ckpt_{n1 + TRAIN_CLI_EPOCH:08d}.msgpack"]):
        problems.append(f"run2: the restore (logged {r2['restored_log']}, first step "
                        f"{r2['first_step']}, final {r2['final_step']}, updates "
                        f"{r2['update_count']}, checkpoints {r2['checkpoints']})")
    if r2["val_losses"][-1][1] > 1.05 * parity["val_loss"]:
        problems.append(f"run2's last validation loss {r2['val_losses'][-1][1]} is more than "
                        f"5 % above the tracked checkpoint's {parity['val_loss']}")
    if not avg_equal or not all(ckpt_shapes_ok.values()) or len(tracked_tree) != 151:
        problems.append(f"average bit-equal {avg_equal}; checkpoints read back with the "
                        f"tracked shapes {ckpt_shapes_ok}")
    if abs(rec["eval_of_average"]["wer_pct"] - TRAIN_CLI_WER) > 10.0:
        problems.append(f"the average's WER {rec['eval_of_average']['wer_pct']} is more than "
                        f"10 points from {TRAIN_CLI_WER}")
    if (r1["launches"]["spec_augment"] != 0 or r2["launches"]["spec_augment"] != r2["steps"]
            or min(r1["launches"]["fused_logmel_project"],
                   r2["launches"]["fused_logmel_project"],
                   eval_launches["fused_logmel_project"]) <= 0):
        problems.append(f"launches: run1 {r1['launches']}, run2 {r2['launches']}, "
                        f"eval {eval_launches}")
    if problems:
        fail("train_cli_1x: " + "; ".join(problems))
    return {"record": rec, "k2": dict(k2, max_abs_err=k2_err), "k4": k4,
            "launches": {"run1": r1["launches"], "run2": r2["launches"],
                         "eval": eval_launches},
            "k2_eval": k2_recs.get((64, EVAL_SAMPLES), k2)}


# ---------------------------------------------------------------------------
# Phase 8: LM shallow fusion (lm_fusion_1x)
# ---------------------------------------------------------------------------
# The LM trains at the eval CLI's LM shape (hidden 512, 4 heads, 6 layers,
# rows of 512 tokens) with --batch-size 64. scripts/ensure_corpus.sh's valid
# split (3 episodes of 120 s) holds 574 tokens, one row, and its train split
# (100 episodes) 37 rows: no batch of 64 at all, and the reference's
# perplexity of no batch is NaN. So both splits are extended at their seeds
# (the synthesiser draws episode after episode from one seeded stream, so
# the first 100 and 3 episodes are ensure_corpus.sh's): valid to 200
# episodes (one batch of 64 rows), train to 400 (two batches an epoch).
LM_FIXTURE = os.path.join("tests", "fixtures", "torch_lm_reference.json")
LM_SPLITS = {"train": dict(episodes=400, seed=0), "valid": dict(episodes=200, seed=101)}
LM_SPLITS_NOTE = ("scripts/ensure_corpus.sh's train (100 episodes) and valid (3) splits "
                  "extended at their seeds to 400 and 200 episodes of 120 s, built by "
                  "`cli.tools synth-corpus`: at 512 tokens a row its valid split is one "
                  "row, and batches of 64 need 64")
LM_TRAIN_FLAGS = ["--hidden-size", "512", "--layers", "6", "--attn-heads", "4",
                  "--max-len", "512", "--batch-size", "64", "--max-epochs", "16"]
LM_LEGS = {"aligned": [], "sm": ["--unaligned"], "vad": ["--unaligned", "--vad-windows"]}


def reference_script(root, name):
    """scripts/<name>.py (torch_lm_reference: `seeded_lm_params`;
    torch_spk_reference: `seeded_spk_tree`), for its seeded trees and
    constants (it needs numpy alone)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_eval_counted(torch, argv, counters, compute_dtype=None):
    """`cli.test.main(argv)` with the kernel counts set to 0 just before it
    and read just after; the fused decoder's steps and the LM's steps and
    prefills counted; each beam search's launches kept with its audio
    bucket. `compute_dtype` replaces the CLI's system's (bf16). Returns
    (result, seconds, record)."""
    from tal_asrd_tpu_torch.cli import test as cli_test
    from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
    from tal_asrd_tpu_torch.eval.runner import EvalRunner
    from tal_asrd_tpu_torch.models.lm import DecoderLMModel

    counts = {"decode_steps": 0, "lm_steps": 0, "lm_prefills": 0}
    by_bucket = {}
    patched = [(FusedASRDecoder, "decode_step"), (DecoderLMModel, "decode_step"),
               (DecoderLMModel, "decode_prefill"), (EvalRunner, "_generate_fn"),
               (cli_test, "ASRSystem")]
    originals = {(obj, name): getattr(obj, name) for obj, name in patched}

    def counting(cls, name, key):
        fn = originals[(cls, name)]

        def wrapped(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    def bucketed(self, max_new):
        run = originals[(EvalRunner, "_generate_fn")](self, max_new)

        def call(audio, lens, prime):
            before = {k: fn.launches for k, fn in counters.items()}
            out = run(audio, lens, prime)
            b = by_bucket.setdefault(int(audio.shape[1]) // 16000,
                                     dict.fromkeys(["calls", *counters], 0))
            b["calls"] += 1
            for k, fn in counters.items():
                b[k] += fn.launches - before[k]
            return out
        return call

    FusedASRDecoder.decode_step = counting(FusedASRDecoder, "decode_step", "decode_steps")
    DecoderLMModel.decode_step = counting(DecoderLMModel, "decode_step", "lm_steps")
    DecoderLMModel.decode_prefill = counting(DecoderLMModel, "decode_prefill", "lm_prefills")
    EvalRunner._generate_fn = bucketed
    if compute_dtype is not None:
        cli_test.ASRSystem = functools.partial(cli_test.ASRSystem, compute_dtype=compute_dtype)
    try:
        # The main path's run: counts set to 0 just before it, read just after.
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli_test.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        for (obj, name), fn in originals.items():
            setattr(obj, name, fn)
    return res, secs, dict(counts, launches=launches, by_bucket=by_bucket)


def against_reference(leg, steps, ref_leg):
    """Where the run's tokens part from the JAX CLI's: per episode of the
    state machine the first differing token (-1: none, or the shorter
    length), and the VAD windows whose chosen rows equal the reference's."""
    if leg == "sm":
        return [next((i for i, (a, b) in enumerate(zip(st["tokens"], ep["tokens"])) if a != b),
                     -1 if len(st["tokens"]) == len(ep["tokens"])
                     else min(len(st["tokens"]), len(ep["tokens"])))
                for st, ep in zip(steps, ref_leg["episodes"])]
    want = [[w["tokens"][:-1] if w["found"] and w["length"] > 1 else w["tokens"]
             for w in ep["windows"]] for ep in ref_leg["episodes"]]
    return {"windows_equal": sum(a == b for st, w in zip(steps, want)
                                 for a, b in zip(st["window_tokens"], w)),
            "windows": sum(len(w) for w in want)}


def run_lm_fusion_1x(torch, dev, root, out_dir, card, trace=False):
    """LM shallow fusion on the card. (1) `python -m
    tal_asrd_tpu_torch.cli.train_lm` (its `main`) at the eval CLI's LM
    shape, batch 64, 16 epochs of two steps on the LM_SPLITS; gates: the
    last validation perplexity below the first, the last checkpoint read
    back equal to the trained parameters leaf for leaf. (2) The eval CLI on
    the tracked checkpoint with the fixture's seeded LM (rebuilt here with
    numpy) at its weight, over the three legs, each unfused and fused, its
    system computing in f32 as the fixture's JAX CLI does (in bf16 the two
    packages' logits part by up to 0.9 at some steps, and the LM's
    continuous scores turn that into other tokens; see
    scripts/torch_lm_reference.py). Gates against the JAX CLI's figures on
    the CPU (LM_FIXTURE): aligned, unfused within 1.0 point and fused within
    0.5 of unfused; the state machine 2.0 (WER) / 3.0 (WDER) for both; VAD
    windows unfused within 1.0, fused within 0.5 of unfused or both within
    0.5 of the reference; K1 four launches a fused decode step, K2
    launched, the LM stepped. (3) The
    three legs fused with the trained LM, and without an LM, recorded, in
    bf16 as users run them. With `trace`, each fused run of (3) with the
    trained LM is repeated once under torch.profiler."""
    from tal_asrd_tpu_torch.cli import train_lm as cli_train_lm
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree, save_pytree, tree_leaves
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.eval.convert import score_test_result
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.train.lm_system import LMSystem

    ref_script = reference_script(root, "torch_lm_reference")
    with open(os.path.join(root, LM_FIXTURE)) as f:
        ref = json.load(f)["seeded_eval"]
    base = os.path.join(out_dir, "lm_fusion")
    split = os.path.join(base, "test")
    bpe = os.path.join(root, "accuracy_release", "bpe.model")
    tracked = os.path.join(root, "accuracy_release", "avg_last_3.bf16.msgpack")
    counters = {"fused_layer_step": fused_layer_step,
                "fused_logmel_project": fused_logmel_project}

    # the LM's splits, synthesised in two processes while (2) runs
    lm_dirs = {k: os.path.join(base, "lm_" + k) for k in LM_SPLITS}
    t_splits = time.perf_counter()
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "tal_asrd_tpu_torch.cli.tools", "synth-corpus",
         "--out-dir", lm_dirs[k], "--episodes", str(s["episodes"]), "--episode-seconds",
         "120", "--speakers", "8", "--seed", str(s["seed"])],
        cwd=root, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for k, s in LM_SPLITS.items()}
    try:
        build_synth_corpus(split, **EVAL_SPLIT)
        lm = ref["lm"]
        seeded = os.path.join(base, "seeded_lm.msgpack")
        save_pytree(seeded, ref_script.seeded_lm_params(lm["vocab"], lm["seed"], lm["scalars"],
                                                        hidden=lm["hidden"], layers=lm["layers"]))

        def cli_argv(leg, name, lm_path, fused):
            return (["--train-data", split, "--valid-data", split, "--test-data", split,
                     "--tokenizer", bpe, "--model-type", "1x", "--num-speakers", "8",
                     "--load", tracked, "--out-dir", os.path.join(base, f"{leg}_{name}"),
                     "--device", dev] + LM_LEGS[leg]
                    + (["--lm-path", lm_path, "--lm-weight", str(lm["weight"])]
                       if lm_path else []) + (["--fused-decode"] if fused else []))

        def leg_run(leg, name, lm_path, fused, compute_dtype=None):
            res, secs, r = run_eval_counted(torch, cli_argv(leg, name, lm_path, fused), counters,
                                            compute_dtype)
            scored = score_test_result(os.path.join(base, f"{leg}_{name}", "test_result.pkl"))
            r.update(wer_pct=100.0 * scored["overall_wer"],
                     wder_pct=100.0 * scored["overall_wder"],
                     n_words=int(sum(scored["n_words"])), seconds=secs,
                     audio_seconds_per_second=EVAL_SPLIT["n_episodes"]
                     * EVAL_SPLIT["episode_seconds"] / secs)
            if compute_dtype is not None and leg != "aligned":
                r["against_reference"] = against_reference(leg, res["steps"], ref["legs"][leg])
            del res
            torch.cuda.empty_cache()
            return r

        # ---- (2) the seeded LM against the JAX CLI -------------------------------
        leg_run("aligned", "warmup", seeded, False)          # not counted
        seeded_runs = {}
        for leg in LM_LEGS:
            for name, fused in (("unfused", False), ("fused", True)):
                seeded_runs[(leg, name)] = leg_run(leg, f"seeded_{name}", seeded, fused,
                                                   torch.float32)

        # ---- (1) train the LM ---------------------------------------------------------
        t_wait = time.perf_counter()
        for k, p in procs.items():
            if p.wait() != 0:
                fail(f"lm_fusion_1x: synth-corpus of the LM's {k} split failed: "
                     f"{p.stderr.read()[-2000:]}")
        split_seconds = time.perf_counter() - t_splits
        split_wait_seconds = time.perf_counter() - t_wait
        step_of, step_times, tokens = LMSystem.train_step, [], [0]

        def timed_step(self, toks, mask):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step_of(self, toks, mask)
            torch.cuda.synchronize()
            step_times.append(time.perf_counter() - t0)
            tokens[0] += int(mask[:, 1:].sum())
            return loss

        LMSystem.train_step = timed_step
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            trained = cli_train_lm.main(
                ["--train-data", lm_dirs["train"], "--valid-data", lm_dirs["valid"],
                 "--tokenizer", bpe, "--name", "lm", "--checkpoint-path",
                 os.path.join(base, "ckpts"), "--device", dev] + LM_TRAIN_FLAGS)
        finally:
            LMSystem.train_step = step_of
        torch.cuda.synchronize()
        train_seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for d in lm_dirs.values():            # 2.3 GB of wavs the LM never read
            shutil.rmtree(d, ignore_errors=True)
        last = trained["epochs"][-1]["path"]
        written, held = dict(tree_leaves(load_pytree(last))), dict(tree_leaves(
            trained["system"].params()))
        round_trip = sorted(written) == sorted(held) and all(
            written[k].dtype == held[k].dtype and written[k].tobytes() == held[k].tobytes()
            for k in held)
        ppls = [e["ppl"] for e in trained["epochs"]]
        train_rec = {
            "splits": LM_SPLITS, "splits_note": LM_SPLITS_NOTE,
            "split_seconds_before_training": split_seconds,
            "split_wait_seconds": split_wait_seconds,
            "flags": LM_TRAIN_FLAGS, "steps": trained["system"].step,
            "epochs": len(trained["epochs"]), "ppl_per_epoch": ppls,
            "losses": [e["losses"] for e in trained["epochs"]],
            "step_ms_median": 1e3 * float(np.median(step_times[1:])),
            "step_ms_first": 1e3 * step_times[0],
            "tokens_per_step": tokens[0] / len(step_times),
            "tokens_per_second": tokens[0] / len(step_times) / float(np.median(step_times[1:])),
            "train_seconds_with_checkpoints": train_seconds, "peak_memory_gb": peak / 1e9,
            "checkpoint_round_trip_equal": round_trip, "leaves": len(held)}
        del trained
        torch.cuda.empty_cache()

        # ---- (3) the trained LM, and no LM, fused --------------------------------------
        trained_runs = {leg: leg_run(leg, "trained_fused", last, True) for leg in LM_LEGS}
        if trace:
            from tal_asrd_tpu_torch.cli import test as cli_test
            for leg in LM_LEGS:
                profile_call(torch, f"lm_fusion_1x:{leg}:trained_fused", cli_test.main,
                             (cli_argv(leg, "trained_traced", last, True),))
        no_lm_runs = {leg: leg_run(leg, "no_lm_fused", None, True) for leg in LM_LEGS}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()

    keep = ("wer_pct", "wder_pct", "n_words", "seconds", "audio_seconds_per_second",
            "launches", "decode_steps", "lm_steps", "lm_prefills", "by_bucket",
            "against_reference")
    rec = {"phase": "lm_fusion_1x", "card": card, "train_lm": train_rec,
           "seeded": {f"{leg}_{name}": {k: r[k] for k in keep if k in r}
                      for (leg, name), r in seeded_runs.items()},
           "seeded_lm": ref["lm"],
           "reference_jax_cpu": {leg: {k: ref["legs"][leg][k] for k in ("wer_pct", "wder_pct")}
                                 for leg in LM_LEGS},
           "reference_words_changed_share": ref["words_changed_share"],
           "trained_fused": {leg: {k: r[k] for k in keep if k in r}
                             for leg, r in trained_runs.items()},
           "no_lm_fused": {leg: {k: r[k] for k in keep if k in r}
                           for leg, r in no_lm_runs.items()}}
    emit(rec)

    # ---- gates -----------------------------------------------------------------
    problems = []
    if not (np.isfinite(ppls).all() and ppls[-1] < ppls[0]):
        problems.append(f"the validation perplexity did not fall: {ppls}")
    if not round_trip:
        problems.append("the trained LM's last checkpoint does not read back leaf for leaf")
    runs = {**seeded_runs, **{(leg, "trained"): r for leg, r in trained_runs.items()},
            **{(leg, "no_lm"): r for leg, r in no_lm_runs.items()}}
    for (leg, name), r in runs.items():
        fused = name != "unfused"
        want_k1 = 4 * r["decode_steps"] if fused else 0
        if (r["launches"]["fused_layer_step"] != want_k1 or (fused and r["decode_steps"] == 0)
                or r["launches"]["fused_logmel_project"] <= 0
                or (r["lm_steps"] == 0) != (name == "no_lm")):
            problems.append(f"{leg}/{name}: launches {r['launches']} after {r['decode_steps']} "
                            f"fused steps, {r['lm_steps']} LM steps")
    # The bands of eval_aligned_1x and eval_unaligned_1x, both sides in f32
    for leg, to_ref, fused_band, runs_to_ref in (
            ("aligned", (1.0, 1.0), (0.5, 0.5), ("unfused",)),
            ("sm", (2.0, 3.0), (2.0, 3.0), ("unfused", "fused")),
            ("vad", (1.0, 1.0), (0.5, 0.5), ("unfused",))):
        u, fz = seeded_runs[(leg, "unfused")], seeded_runs[(leg, "fused")]
        for key, limit_ref, limit_fused in zip(("wer_pct", "wder_pct"), to_ref, fused_band):
            want = ref["legs"][leg][key]
            straddle = (leg == "vad" and abs(fz[key] - want) <= limit_fused
                        and abs(u[key] - want) <= limit_fused)
            if abs(fz[key] - u[key]) > limit_fused and not straddle:
                problems.append(f"{leg}: fused {key} {fz[key]} is more than {limit_fused} "
                                f"from unfused {u[key]}")
            for name in runs_to_ref:
                r = seeded_runs[(leg, name)]
                if abs(r[key] - want) > limit_ref:
                    problems.append(f"{leg}: {name} {key} {r[key]} is more than {limit_ref} "
                                    f"from the JAX CPU reference's {want}")
    if ref["words_changed_share"] < 0.02:
        problems.append(f"the seeded LM changed {ref['words_changed_share']} of the words")
    if problems:
        fail("lm_fusion_1x: " + "; ".join(problems))
    return runs


def check_lm_kernels(torch, dev):
    """K1 in f32 at the shapes of lm_fusion_1x's parity runs, which compute
    in f32: the aligned leg's beam lanes (320, 270; S = 108, cap 38), the
    state machine's lane (B = 1, S = 357, cache 512) and the VAD leg's 80
    lanes at each bucket, first and last indices, each timed."""
    f32 = torch.float32
    recs = {}
    # the aligned leg's record: timed at 320 lanes, the worst error of both
    recs["aligned"] = worst_of([
        check_layer_step(torch, dev, f"lm_fusion_1x:aligned,B={b},S={EVAL_S},L={EVAL_CAP}",
                         b, 256, 4, EVAL_S, EVAL_CAP, f32, first)
        for b in EVAL_LANES for first in (0, EVAL_CAP - 4)])
    recs["aligned"].update(time_decode(torch, dev, "K1", "none", EVAL_LANES[0], 256, 4, EVAL_S,
                                       EVAL_CAP, EVAL_CAP - 2, f32))
    recs[("sm", 1)] = worst_of([
        check_layer_step(torch, dev, f"lm_fusion_1x:sm,B=1,S={SM_S},L={SM_CAP}",
                         1, 256, 4, SM_S, SM_CAP, f32, first)
        for first in (0, SM_CAP // 2 - 2, SM_CAP - 3)])
    recs[("sm", 1)].update(time_decode(torch, dev, "K1", "none", 1, 256, 4, SM_S, SM_CAP,
                                       SM_CAP // 2 - 1, f32))
    for secs, _, s, cap in VAD_SHAPES:
        recs[("vad", secs)] = worst_of([
            check_layer_step(torch, dev, f"lm_fusion_1x:vad,B={VAD_LANES},S={s},L={cap}",
                             VAD_LANES, 256, 4, s, cap, f32, first) for first in (0, cap - 4)])
        recs[("vad", secs)].update(time_decode(torch, dev, "K1", "none", VAD_LANES, 256, 4, s,
                                               cap, cap - 2, f32))
    return recs


def lm_entries(runs, k1_f32, k1_eval, k2_eval, k1_long, k2_long):
    """The LM path's kernels in each fused run of lm_fusion_1x: K2 at its N
    and K1 at its shape and dtype (the parity runs f32, the others bf16),
    with their launches in that run (the VAD leg's by bucket)."""
    entries = []
    for (leg, name), r in runs.items():
        if name == "unfused":
            continue
        config = f"lm_fusion_1x:{leg}:{'seeded_f32' if name == 'fused' else name}"
        k1 = k1_f32 if name == "fused" else {"aligned": k1_eval, **k1_long}
        if leg == "aligned":
            parts = [(config, k1["aligned"], k2_eval, r["launches"])]
        elif leg == "sm":
            parts = [(config, k1[("sm", 1)], k2_long["sm"], r["launches"])]
        else:
            parts = [(f"{config}:{secs}s", k1[("vad", secs)], k2_long[("vad", secs)], got)
                     for secs, got in sorted(r["by_bucket"].items())]
        for cfg, k1_rec, k2, got in parts:
            entries.append(kernel_entry(cfg, k1_rec, got["fused_layer_step"],
                                        k1_rec["max_abs_err"]["x_out"], "none"))
            entries.append(kernel_entry(cfg, k2, got["fused_logmel_project"],
                                        k2["max_abs_err"]))
    return entries


# ---------------------------------------------------------------------------
# Phase 9: the separate speaker head (spk_head_1x)
# ---------------------------------------------------------------------------
# No tracked checkpoint has the head. The phase rebuilds, with numpy alone,
# the tree of scripts/torch_spk_reference.py's fixture: the tracked
# checkpoint's text weights (the speaker rows moved to text slots that no
# reference uses) and a head seeded at ReZero scalars 0.4. A head model
# decodes through the model itself (the fused decoder covers the
# speaker-token mode only, as the reference's runner routes it), so K1 is
# launched no time on its legs; K2 runs in every encode and K4 in training.
SPK_FIXTURE = os.path.join("tests", "fixtures", "torch_spk_reference.json")
SPK_ARRAYS = os.path.join("tests", "fixtures", "torch_spk_reference_arrays.npz")
SPK_HEAD_LEAVES = ("spk_enc_proj", "spk_decoder", "speaker_head_1", "speaker_head_2")
SPK_RESUME_STEPS = 15                 # one epoch: 246 items // 16
# The compared training run (f32, no dropout, no token replacement) follows
# the JAX CLI's to within 1e-4 for its first 6 steps; from the 7th its text
# loss parts with the arithmetic's order: two runs of this phase on the card
# part from each other by up to 2.7 % a step, as they part from JAX (PERF.md,
# PR 11), while the speaker loss stays within 0.3 % of JAX's. So the first 6
# steps are held to 0.1 %, each validation's speaker loss to 1 % and its
# loss and text loss to 10 %.
SPK_EXACT_STEPS, SPK_STEP_BAND, SPK_VAL_BAND, SPK_TEXT_BAND = 6, 0.001, 0.01, 0.10


def bf16_steps_apart(a, b):
    """How many bfloat16 numbers apart two arrays of bfloat16 values are."""
    def ordered(x):
        bits = (np.ascontiguousarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits >= 0x8000, 0x8000 - bits, bits)
    return np.abs(ordered(a) - ordered(b))


def speaker_logits_of(path):
    """Each segment's list of speakerLogits arrays from a test_result.pkl
    (None for an entry without one)."""
    import pickle
    with open(path, "rb") as f:
        return [[u.get("speakerLogits") for u in hyp] for _, hyp in pickle.load(f)]


def run_spk_head_1x(torch, dev, root, out_dir, card, trace=False):
    """The speaker head on the card. (1) The seeded tree (SPK_FIXTURE's
    `tree`, rebuilt with numpy) through the eval CLI's aligned leg at
    --spk-weight 0.5 on the test split: in f32 against the JAX CLI's f32
    run (every segment's tokens equal, every speakerLogits value within one
    bf16 step); in bf16, unfused and with --fused-decode (WER within 1.0 of
    the JAX CLI's bf16 run, speakerLogits argmax equal on at least 90 % of
    the rows of the segments whose tokens equal JAX's, the two runs'
    tokens equal, K1 launched no time, K2 four times a run); in f32 and
    bf16 the tokens equal those of the same tree without the head at
    --num-speakers 0. (2) --unaligned and --unaligned --vad-windows in bf16:
    tokens equal the headless tree's, no speakerLogits. (3) The training CLI
    at the fixture's seeded_train flags, 2 epochs, in f32 without dropout
    and token replacement as the fixture's JAX run (their random streams
    differ between the packages, and in bf16 the JAX CLI's CPU reductions
    saturate, ROADMAP C18): the first SPK_EXACT_STEPS steps' losses and each
    validation within the bands above, spk_loss falling; one resumed epoch
    as users run it, in bf16 with SpecAugment (K4 once a step) and dropout;
    the last checkpoint read back leaf for leaf; the eval CLI on it writes
    speakerLogits of width 8. With `trace`, the bf16 aligned run is repeated
    once under torch.profiler. Returns the runs' launches and the kernel
    records."""
    from tal_asrd_tpu_torch.cli import test as cli_test
    from tal_asrd_tpu_torch.cli import train as cli_train
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree, save_pytree, tree_leaves
    from tal_asrd_tpu_torch.core.config import FrontendConfig
    from tal_asrd_tpu_torch.data.collate import BucketedCollater
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.eval.convert import score_test_result
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.ops.logmel import log_mel_spectrogram
    from tal_asrd_tpu_torch.ops.specaug import spec_augment
    from tal_asrd_tpu_torch.train.loop import Trainer
    from tal_asrd_tpu_torch.train.system import ASRSystem

    ref_script = reference_script(root, "torch_spk_reference")
    with open(os.path.join(root, SPK_FIXTURE)) as f:
        ref = json.load(f)
    ref_arrays = np.load(os.path.join(root, SPK_ARRAYS))
    base = os.path.join(out_dir, "spk_head")
    split = os.path.join(base, "test")
    bpe = os.path.join(root, "accuracy_release", "bpe.model")
    tracked = os.path.join(root, "accuracy_release", "avg_last_3.bf16.msgpack")
    t0 = time.perf_counter()
    build_synth_corpus(split, **EVAL_SPLIT)
    t = ref["tree"]
    tree = ref_script.seeded_spk_tree(
        load_pytree(tracked), t["n_text"], t["seed"], t["scalars"],
        enc_channels=t["enc_channels"], d=t["d"], ff=t["ff"], layers=t["layers"],
        spk_embed=t["spk_embed"], speakers=t["speakers"], speaker_slots=t["speaker_slots"],
        memory_gain=t["memory_gain"])
    trees = {"head": os.path.join(base, "seeded_spk.msgpack"),
             "headless": os.path.join(base, "seeded_headless.msgpack")}
    save_pytree(trees["head"], tree)
    save_pytree(trees["headless"], {k: v for k, v in tree.items() if k not in SPK_HEAD_LEAVES})
    setup_seconds = time.perf_counter() - t0
    counters = {"fused_layer_step": fused_layer_step,
                "fused_logmel_project": fused_logmel_project}
    spk = str(ref["spk_weight"])

    def cli_argv(leg, name, head, fused=False, load=None, data=split):
        return (["--train-data", data, "--valid-data", data, "--test-data", data,
                 "--tokenizer", bpe, "--model-type", "1x",
                 "--num-speakers", "8" if head else "0"]
                + (["--spk-weight", spk] if head else [])
                + ["--load", load or trees["head" if head else "headless"],
                   "--out-dir", os.path.join(base, f"{leg}_{name}"), "--device", dev]
                + LM_LEGS[leg] + (["--fused-decode"] if fused else []))

    def leg_run(leg, name, head, fused=False, compute_dtype=None):
        argv = cli_argv(leg, name, head, fused)
        res, secs, r = run_eval_counted(torch, argv, counters, compute_dtype)
        out = os.path.join(base, f"{leg}_{name}")
        scored = score_test_result(os.path.join(out, "test_result.pkl"))
        if leg == "aligned":
            r["tokens"] = [s["tokens"][i, :s["lengths"][i]].tolist()
                           for s in res["steps"] for i in range(len(s["idx"]))]
        elif leg == "sm":
            r["tokens"] = [s["tokens"] for s in res["steps"]]
        else:
            r["tokens"] = [s["window_tokens"] for s in res["steps"]]
        r.update(wer_pct=100.0 * scored["overall_wer"], wder_pct=100.0 * scored["overall_wder"],
                 n_words=int(sum(scored["n_words"])), seconds=secs,
                 speaker_logits=speaker_logits_of(os.path.join(out, "test_result.pkl")))
        if trace and leg == "aligned" and name == "bf16_unfused":
            profile_call(torch, "spk_head_1x:aligned:bf16_unfused", cli_test.main, (argv,))
        del res
        torch.cuda.empty_cache()
        return r

    # ---- (1), (2): the eval CLI -------------------------------------------------
    leg_run("aligned", "warmup", True)                     # not counted
    f32 = torch.float32
    runs = {"f32_head": leg_run("aligned", "f32_head", True, compute_dtype=f32),
            "f32_headless": leg_run("aligned", "f32_headless", False, compute_dtype=f32),
            "bf16_unfused": leg_run("aligned", "bf16_unfused", True),
            "bf16_fused": leg_run("aligned", "bf16_fused", True, fused=True),
            "bf16_headless": leg_run("aligned", "bf16_headless", False)}
    for leg in ("sm", "vad"):
        leg_run(leg, "warmup", True)      # not counted: this leg's encoder shapes
        runs[f"{leg}_head"] = leg_run(leg, "head", True)
        runs[f"{leg}_headless"] = leg_run(leg, "headless", False)

    ref_runs = ref["seeded_eval"]["runs"]
    problems = []

    def jax_logits(run, seg):
        n = len(ref_runs[run]["speaker_logits_shapes"][seg])
        return [ref_script.from_bf16_bits(ref_arrays[f"seeded_eval/{run}/{seg:03d}/{u}"])
                for u in range(n)]

    # (a) f32 parity
    a = runs["f32_head"]
    n_seg = len(ref_runs["f32"]["segment_tokens"])
    f32_equal = sum(x == y for x, y in zip(a["tokens"], ref_runs["f32"]["segment_tokens"]))
    worst_steps = 0
    if f32_equal != n_seg or len(a["tokens"]) != n_seg or len(a["speaker_logits"]) != n_seg:
        problems.append(f"f32: {f32_equal} of {n_seg} segments' tokens equal the JAX CLI's "
                        f"({len(a['tokens'])} segments)")
    else:
        for seg, ours in enumerate(a["speaker_logits"]):
            theirs = jax_logits("f32", seg)
            if len(ours) != len(theirs) or any(
                    o is None or o.shape != th.shape for o, th in zip(ours, theirs)):
                problems.append(f"f32: segment {seg}'s speakerLogits are not JAX's in number "
                                f"or shape")
                break
            for o, th in zip(ours, theirs):
                worst_steps = max(worst_steps, int(bf16_steps_apart(o, th).max(initial=0)))
    if worst_steps > 1:
        problems.append(f"f32: speakerLogits {worst_steps} bf16 steps from JAX's (> 1)")
    # (b) bf16 as users run it
    b16 = runs["bf16_unfused"]
    agree = rows = 0
    bf16_equal = 0
    for seg, (ours, toks, want) in enumerate(zip(b16["speaker_logits"], b16["tokens"],
                                                 ref_runs["bf16"]["segment_tokens"])):
        if toks != want:
            continue
        bf16_equal += 1
        for o, th in zip(ours, jax_logits("bf16", seg)):
            agree += int((o.argmax(-1) == th.argmax(-1)).sum())
            rows += o.shape[0]
    argmax_share = agree / max(rows, 1)
    if abs(b16["wer_pct"] - ref_runs["bf16"]["wer_pct"]) > 1.0:
        problems.append(f"bf16: WER {b16['wer_pct']} is more than 1.0 from the JAX CLI's "
                        f"{ref_runs['bf16']['wer_pct']}")
    if argmax_share < 0.9 or rows == 0:
        problems.append(f"bf16: speakerLogits argmax equal on {agree} of {rows} rows (< 90 %)")
    if runs["bf16_fused"]["tokens"] != b16["tokens"]:
        problems.append("bf16: --fused-decode changed the tokens of a speaker-head model")
    for name in ("f32_head", "bf16_unfused", "bf16_fused", "sm_head", "vad_head"):
        got = runs[name]["launches"]
        if got["fused_layer_step"] != 0 or runs[name]["decode_steps"] != 0:
            problems.append(f"{name}: K1 launched {got['fused_layer_step']} times "
                            f"({runs[name]['decode_steps']} fused steps) on a speaker-head leg")
        if name.startswith(("f32", "bf16")) and got["fused_logmel_project"] != 4:
            problems.append(f"{name}: K2 launched {got['fused_logmel_project']} times, "
                            f"expected 4")
        if got["fused_logmel_project"] <= 0:
            problems.append(f"{name}: K2 never launched")
    # (c) invariance, and (2) the long-form legs
    for head, headless in (("f32_head", "f32_headless"), ("bf16_unfused", "bf16_headless"),
                           ("sm_head", "sm_headless"), ("vad_head", "vad_headless")):
        if runs[head]["tokens"] != runs[headless]["tokens"]:
            problems.append(f"{head}: tokens differ from the headless tree's ({headless})")
    for name in ("sm_head", "vad_head"):
        if any(x is not None for seg in runs[name]["speaker_logits"] for x in seg):
            problems.append(f"{name}: a long-form leg wrote speakerLogits")
    if any(x is None or x.shape[1] != 8 for seg in b16["speaker_logits"] for x in seg):
        problems.append("bf16: an utterance without speakerLogits of width 8")

    # ---- (3) the training CLI ---------------------------------------------------
    tr = ref["seeded_train"]
    dirs = {k: os.path.join(base, "train_" + k.lower()) for k in ("TRAIN", "VALID", "CKPTS",
                                                                  "OUT")}
    for name, s in tr["splits"].items():
        build_synth_corpus(dirs[name.upper()], **s)
    fill = dict(dirs, TREE=trees["head"])
    argv1 = [fill.get(x, x) for x in tr["argv"]] + ["--device", dev]
    run_name = argv1[argv1.index("--name") + 1]
    run_dir = os.path.join(dirs["CKPTS"], run_name)
    n1 = tr["checkpoints"][-1]
    last1 = os.path.join(run_dir, n1)
    steps1 = int(n1[5:13])
    argv2 = [x for x in argv1 if x != "--no-specaug"]
    argv2[argv2.index("--load") + 1] = last1
    argv2 += ["--max-steps", str(steps1 + SPK_RESUME_STEPS), "--max-epochs", "1000"]
    tcounters = {"fused_logmel_project": fused_logmel_project, "spec_augment": spec_augment}
    shapes = set()
    collate = BucketedCollater.__call__

    def recording(self, samples):
        out = collate(self, samples)
        shapes.add(tuple(out["audio"].shape))
        return out

    vals = []
    validate, eval_step = Trainer._validate, ASRSystem.eval_step

    def recording_validate(self, val_loader, step, n_batches=None):
        vals.append({"step": step, "batches": []})
        return validate(self, val_loader, step, n_batches)

    def recording_eval_step(self, batch):
        m = eval_step(self, batch)
        vals[-1]["batches"].append({k: float(m[k]) for k in ("loss", "lm_loss", "spk_loss")})
        return m

    def no_noise(build):
        # the fixture's JAX run trains in f32 without dropout and token
        # replacement (each package draws them from its own random stream;
        # in bf16 the JAX CLI's CPU reductions saturate, ROADMAP C18)
        def build_configs(args, tokenizer=None):
            model_cfg, train_cfg, decode_cfg = build(args, tokenizer)
            return (dataclasses.replace(model_cfg, dropout=0.0, tds_dropout=0.0),
                    dataclasses.replace(train_cfg, token_replace_prob=0.0), decode_cfg)
        return build_configs

    trainer_config, build_configs = cli_train.TrainerConfig, cli_train.build_configs
    system_of = cli_train.ASRSystem
    BucketedCollater.__call__ = recording
    Trainer._validate, ASRSystem.eval_step = recording_validate, recording_eval_step
    cli_train.TrainerConfig = functools.partial(trainer_config, log_every=1)
    metrics = os.path.join(dirs["OUT"], f"{run_name}.metrics.jsonl")
    train_runs = {}
    try:
        for name, argv in (("run1", argv1), ("run2", argv2)):
            cli_train.build_configs = no_noise(build_configs) if name == "run1" else build_configs
            cli_train.ASRSystem = (functools.partial(system_of, compute_dtype=torch.float32)
                                   if name == "run1" else system_of)
            seen = os.path.getsize(metrics) if os.path.exists(metrics) else 0
            vals.clear()
            torch.cuda.reset_peak_memory_stats()
            # The main path's run: counts set to 0 just before it, read just after.
            for fn in tcounters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = cli_train.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            with open(metrics) as f:
                f.seek(seen)
                recs = [json.loads(line) for line in f if line.strip()]
            steps = [r for r in recs if "loss" in r]
            epochs = [r for r in recs if "epoch_time_s" in r]
            train_runs[name] = {
                "seconds": secs, "steps": len(steps), "final_step": out["system"].step,
                "step_time_ms_median": 1e3 * float(np.median(
                    [r["step_time_s"] for r in steps[1:]])),
                "audio_seconds_per_second": sum(r["audio_s"] for r in epochs)
                / sum(r["train_s"] for r in epochs),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "losses_finite": bool(all(np.isfinite(r["loss"]) for r in steps)),
                "step_losses": [[r["step"], r["loss"], r["lm_loss"], r["spk_loss"]]
                                for r in steps],
                "validations": [dict({k: float(np.mean([b[k] for b in v["batches"]]))
                                      for k in ("loss", "lm_loss", "spk_loss")},
                                     step=v["step"]) for v in vals],
                "launches": {k: fn.launches for k, fn in tcounters.items()}}
            if name == "run2":
                last = os.path.join(run_dir, f"ckpt_{out['system'].step:08d}.msgpack")
                written = dict(tree_leaves(load_pytree(last)))
                held = dict(tree_leaves(out["system"].params_tree()))
                round_trip = sorted(written) == sorted(held) and all(
                    np.asarray(written[k]).dtype == np.asarray(held[k]).dtype
                    and np.asarray(written[k]).tobytes() == np.asarray(held[k]).tobytes()
                    for k in held)
                head_leaves = sum(k[0] in SPK_HEAD_LEAVES for k in held)
            del out
            torch.cuda.empty_cache()
    finally:
        BucketedCollater.__call__ = collate
        Trainer._validate, ASRSystem.eval_step = validate, eval_step
        cli_train.TrainerConfig, cli_train.build_configs = trainer_config, build_configs
        cli_train.ASRSystem = system_of
    # the trained checkpoint through the eval CLI
    for fn in counters.values():
        fn.launches = 0
    t1 = time.perf_counter()
    cli_test.main(cli_argv("aligned", "trained", True, load=last))
    torch.cuda.synchronize()
    trained_eval = {"seconds": time.perf_counter() - t1,
                    "launches": {k: fn.launches for k, fn in counters.items()}}
    trained_logits = speaker_logits_of(os.path.join(base, "aligned_trained", "test_result.pkl"))
    trained_eval.update(score_test_result(os.path.join(base, "aligned_trained",
                                                       "test_result.pkl")))
    trained_eval = {k: trained_eval[k] for k in ("seconds", "launches", "overall_wer",
                                                 "overall_wder")}

    r1, r2 = train_runs["run1"], train_runs["run2"]
    want_vals = tr["validations"]
    if [v["step"] for v in r1["validations"]] != [v["step"] for v in want_vals]:
        problems.append(f"train: validations at {[v['step'] for v in r1['validations']]}, "
                        f"the JAX CLI's at {[v['step'] for v in want_vals]}")
    rel = lambda a, b: abs(a - b) / abs(b)
    first_steps_err = max(rel(g, w) for got, want in zip(r1["step_losses"][:SPK_EXACT_STEPS],
                                                         tr["step_losses"][:SPK_EXACT_STEPS])
                          for g, w in zip(got[1:], want[1:]))
    if [s[0] for s in r1["step_losses"][:SPK_EXACT_STEPS]] != list(range(1, SPK_EXACT_STEPS + 1)) \
            or first_steps_err > SPK_STEP_BAND:
        problems.append(f"train: the first {SPK_EXACT_STEPS} steps' losses are "
                        f"{first_steps_err:.3g} from the JAX CLI's (> {SPK_STEP_BAND})")
    for got, want in zip(r1["validations"], want_vals):
        for k, band in (("loss", SPK_TEXT_BAND), ("lm_loss", SPK_TEXT_BAND),
                        ("spk_loss", SPK_VAL_BAND)):
            if rel(got[k], want[k]) > band:
                problems.append(f"train: step {got['step']} {k} {got[k]} is more than "
                                f"{band:.0%} from the JAX CLI's {want[k]}")
    if not r1["validations"][-1]["spk_loss"] < r1["validations"][0]["spk_loss"]:
        problems.append(f"train: spk_loss did not fall: {r1['validations']}")
    if not (r1["losses_finite"] and r2["losses_finite"]):
        problems.append("train: a loss is not finite")
    k2_launched = min(r["launches"]["fused_logmel_project"] for r in (r1, r2))
    if (r1["launches"]["spec_augment"] != 0 or r2["launches"]["spec_augment"] != r2["steps"]
            or r2["steps"] != SPK_RESUME_STEPS or k2_launched <= 0):
        problems.append(f"train: launches {r1['launches']} / {r2['launches']} after "
                        f"{r1['steps']} / {r2['steps']} steps")
    if not round_trip or head_leaves == 0:
        problems.append(f"train: the last checkpoint does not read back leaf for leaf "
                        f"({head_leaves} head leaves)")
    if trained_eval["launches"]["fused_layer_step"] != 0 or not trained_logits or any(
            x is None or x.shape[1] != 8 for seg in trained_logits for x in seg):
        problems.append(f"trained eval: launches {trained_eval['launches']}, speakerLogits "
                        f"not of width 8 throughout")

    # ---- K2 at the training shapes and K4 at [16, 3001, 80], on int16 audio ------
    rng = np.random.default_rng(SEED + 9)
    k2_recs = {}
    for b, n in sorted(shapes | {(1, n) for _, n in shapes}):
        audio = torch.from_numpy(int16_speech(rng, b, n)).to(dev)
        k2_recs[(b, n)] = check_logmel(torch, dev, b, n, audio=audio)
    audio = torch.from_numpy(int16_speech(rng, 16, 480_000)).to(dev)
    spec = log_mel_spectrogram(audio, FrontendConfig(),
                               audio_lens=torch.full((16,), 480_000, device=dev))
    k4 = check_specaug(torch, dev, 16, spec_in=spec.contiguous())
    k2_train = k2_recs.get((16, 480_000)) or k2_recs[max(k2_recs)]

    keep = ("wer_pct", "wder_pct", "n_words", "seconds", "launches", "decode_steps")
    rec = {"phase": "spk_head_1x", "card": card, "setup_seconds": setup_seconds,
           "tree": ref["tree"], "eval": {k: {f: r[f] for f in keep} for k, r in runs.items()},
           "reference_jax_cpu": {k: {f: ref_runs[k][f] for f in ("wer_pct", "wder_pct")}
                                 for k in ref_runs},
           "f32_segments_equal": f32_equal, "f32_speaker_logits_max_bf16_steps": worst_steps,
           "bf16_segments_equal_to_jax": bf16_equal, "bf16_argmax_rows": [agree, rows],
           "bf16_argmax_share": argmax_share,
           "seconds_per_run": {"aligned": [runs["bf16_unfused"]["seconds"],
                                           runs["bf16_headless"]["seconds"]],
                               "sm": [runs["sm_head"]["seconds"],
                                      runs["sm_headless"]["seconds"]],
                               "vad": [runs["vad_head"]["seconds"],
                                       runs["vad_headless"]["seconds"]],
                               "note": "[with the head, without]"},
           "train": {"run1": r1, "run2": r2, "reference_validations": want_vals,
                     "first_steps_max_rel_err": first_steps_err,
                     "validations_rel_err": [{k: rel(g[k], w[k]) for k in (
                         "loss", "lm_loss", "spk_loss")} for g, w in zip(r1["validations"],
                                                                        want_vals)],
                     "checkpoint_round_trip_equal": round_trip, "head_leaves": head_leaves,
                     "eval_of_last": trained_eval},
           "k2_shapes": {f"{b}x{n}": {k: r[k] for k in ("max_abs_err", "ms", "bound_ms",
                                                        "plain_ms", "library_ms")}
                         for (b, n), r in k2_recs.items()},
           "k4": {k: k4[k] for k in ("shape", "checks", "ms", "graph_ms", "bound_ms",
                                     "plain_ms", "where_ms")}}
    emit(rec)
    if problems:
        fail("spk_head_1x: " + "; ".join(problems))
    return {"runs": runs, "train": train_runs, "trained_eval": trained_eval,
            "k2_train": dict(k2_train, max_abs_err=max(r["max_abs_err"]
                                                       for r in k2_recs.values())),
            "k4": k4}


def spk_entries(s, k2_eval, k2_long):
    """The speaker-head path's kernels, each with its launches in one run:
    K2 in the aligned runs (N = 64064 / 54054), the state machine's
    (72004) and the VAD windows' (by bucket), K2 and K4 in training. K1 is
    launched no time on this path (run_spk_head_1x gates the zero)."""
    entries = []
    for name in ("f32_head", "bf16_unfused", "bf16_fused"):
        entries.append(kernel_entry(f"spk_head_1x:aligned:{name}", k2_eval,
                                    s["runs"][name]["launches"]["fused_logmel_project"],
                                    k2_eval["max_abs_err"]))
    entries.append(kernel_entry("spk_head_1x:sm", k2_long["sm"],
                                s["runs"]["sm_head"]["launches"]["fused_logmel_project"],
                                k2_long["sm"]["max_abs_err"]))
    for secs, got in sorted(s["runs"]["vad_head"]["by_bucket"].items()):
        rec = k2_long[("vad", secs)]
        entries.append(kernel_entry(f"spk_head_1x:vad:{secs}s", rec,
                                    got["fused_logmel_project"], rec["max_abs_err"]))
    t, k2 = s["train"], s["k2_train"]
    entries += [
        kernel_entry("spk_head_1x:train_run1", k2, t["run1"]["launches"]["fused_logmel_project"],
                     k2["max_abs_err"]),
        kernel_entry("spk_head_1x:train_run2", k2, t["run2"]["launches"]["fused_logmel_project"],
                     k2["max_abs_err"]),
        kernel_entry("spk_head_1x:train_run2", s["k4"], t["run2"]["launches"]["spec_augment"],
                     s["k4"]["max_abs_err"]),
        kernel_entry("spk_head_1x:eval_trained", k2_eval,
                     s["trained_eval"]["launches"]["fused_logmel_project"],
                     k2_eval["max_abs_err"])]
    return entries


def train_cli_entries(t):
    """The training CLI's kernels, each with its launches in one run."""
    return [
        kernel_entry("train_cli_1x:run1", t["k2"], t["launches"]["run1"]["fused_logmel_project"],
                     t["k2"]["max_abs_err"]),
        kernel_entry("train_cli_1x:run2", t["k2"], t["launches"]["run2"]["fused_logmel_project"],
                     t["k2"]["max_abs_err"]),
        kernel_entry("train_cli_1x:run2", t["k4"], t["launches"]["run2"]["spec_augment"],
                     t["k4"]["max_abs_err"]),
        kernel_entry("train_cli_1x:eval", t["k2_eval"],
                     t["launches"]["eval"]["fused_logmel_project"], t["k2"]["max_abs_err"]),
    ]


# ---------------------------------------------------------------------------
# Phase 10: the non-causal reference decode and the sharded decode (noncausal_1x)
# ---------------------------------------------------------------------------
# The tracked checkpoint as the eval CLI builds it (f32 parameters, bf16
# compute) on the test split's 118 segments in the eval CLI's batches of 64
# and 54 (K2 at N = 64064 / 54054); the sharded beam search splits the first
# batch in two, the sharded state machine the 4 episodes of 180 s (K2 at
# the whole batch's N = 64064 / 72004 on the first part's device, which takes
# the batch mean there, and at a part's N = 32032 / 2 x 18001 = 36002 on the
# other).
EMBED_FIXTURE = os.path.join("tests", "fixtures", "torch_embed_reference.json")
EMBED_ARRAYS = os.path.join("tests", "fixtures", "torch_embed_reference_arrays.npz")
NC_ATTN_TOL = 1e-4                   # the f32 attn rows against the JAX CPU reference's
SHARD_DEVICES = (("cuda:0",), ("cuda:0", "cuda:0"))


def token_agreement(a, b):
    """tests/test_deviations.py's deviation-A measure: equal tokens over
    the common prefix, divided by the longer length."""
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    return sum(int(x == y) for x, y in zip(a[:n], b[:n])) / max(len(a), len(b))


def tracked_1x(torch, dev, root, compute_dtype):
    """The eval CLI's model: f32 parameters holding the tracked checkpoint,
    computing in `compute_dtype`."""
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree
    from tal_asrd_tpu_torch.core.config import ModelConfig
    from tal_asrd_tpu_torch.core.convert import load_into
    from tal_asrd_tpu_torch.models.asr import ASRModel
    model = ASRModel(ModelConfig(model_type="1x", num_speakers=8, vocab_size=300),
                     dtype=torch.float32, compute_dtype=compute_dtype, device="cpu")
    load_into(model, load_pytree(os.path.join(root, "accuracy_release",
                                              "avg_last_3.bf16.msgpack")))
    return model.to(dev)


def eval_split_of(out_dir):
    """The test split as scripts/ensure_corpus.sh builds it, shared by the
    phases (built by the first that needs it)."""
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    split = os.path.join(out_dir, "eval_split")
    if not os.path.exists(os.path.join(split, "transcript.pkl")):
        build_synth_corpus(split, **EVAL_SPLIT)
    return split


def run_noncausal_1x(torch, dev, root, out_dir, card):
    """The non-causal reference decode and the sharded decode on the card.
    (1) The main path, bf16 as the eval CLI computes: each batch encoded,
    then the causal greedy search (`beam_search`, beam 1, unfused) and
    `greedy_noncausal` at the same length; their seconds and steps, and the
    token agreement per segment and mean (a property of the causally
    trained checkpoint: printed, no gate); K2 once a batch, K1 never. (2)
    In f32, `greedy_noncausal` on the first 16 segments as one batch: every
    segment's tokens and length equal the JAX CPU reference's, the first
    8 rows' `attn` within NC_ATTN_TOL. (3) `make_sharded_decode` (beam 5,
    the first batch) and `make_sharded_unaligned` (the 4 episodes) on one
    and two shards of cuda:0, in bf16 and in f32: every row's tokens and
    length equal the unsharded `beam_search` / `unaligned_decode_batched`'s.
    Printed beside them: the state machine's WER / WDER, sharded and not,
    and where the two-part encode parts from the whole batch's (features,
    and the encoder on the whole batch's features a part at a time)."""
    from tal_asrd_tpu_torch.core.config import DecodeConfig
    from tal_asrd_tpu_torch.data.aligned import AlignedDataset
    from tal_asrd_tpu_torch.data.audio_io import load_audio_segment
    from tal_asrd_tpu_torch.data.collate import BucketedCollater
    from tal_asrd_tpu_torch.data.loader import DataLoader, to_device
    from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, beam_search
    from tal_asrd_tpu_torch.decode.reference_mode import greedy_noncausal
    from tal_asrd_tpu_torch.decode.sharded import (
        make_sharded_decode, make_sharded_unaligned, sharded_features)
    from tal_asrd_tpu_torch.decode.unaligned import unaligned_decode_batched
    from tal_asrd_tpu_torch.eval.convert import score_test_result
    from tal_asrd_tpu_torch.eval.runner import EvalRunner
    from tal_asrd_tpu_torch.models.asr import ASRModel
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

    split = eval_split_of(out_dir)
    tok = BpeTokenizer(model_path=os.path.join(root, "accuracy_release", "bpe.model"))
    ds = AlignedDataset(split, tok, num_utterances=1, min_segment_duration=3,
                        max_segment_duration=20,
                        speaker_map_loc=os.path.join(split, "speaker_map.json"),
                        tokenizer_speakers=True, return_spk_ids=True)
    coll = BucketedCollater(tok.pad_token_id)
    batches = list(DataLoader(ds, 64, coll, num_workers=0, drop_last=False))
    with open(os.path.join(root, EMBED_FIXTURE)) as f:
        ref = json.load(f)["noncausal"]["card"]
    ref_attn = np.load(os.path.join(root, EMBED_ARRAYS))["noncausal/card/attn"]
    eos = tok.eos_token_id
    counters = {"fused_layer_step": fused_layer_step,
                "fused_logmel_project": fused_logmel_project}
    calls = {"decode_step": 0, "decode": 0}
    originals = {name: getattr(ASRModel, name) for name in calls}

    def counting(name):
        def wrapped(self, *args, **kwargs):
            calls[name] += 1
            return originals[name](self, *args, **kwargs)
        return wrapped

    def spec_of(model, batch, k):
        return BeamSearchSpec(beam_size=k, max_new_tokens=int(batch["text"].shape[1] * 1.1) + 2,
                              eos_id=eos, vocab_size=model.cfg.num_tokens,
                              text_vocab_size=len(tok), force_output=k == 1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def both_greedy(model, batch):
        t = to_device({k: batch[k] for k in ("audio", "audio_lens", "text")}, dev)
        prime = t["text"][:, :1].long()
        spec = spec_of(model, batch, 1)
        with torch.inference_mode():
            enc, enc_s = timed(lambda: model.encode(t["audio"], t["audio_lens"]))
            calls.update(decode_step=0, decode=0)
            causal, causal_s = timed(lambda: beam_search(model, enc, prime, spec))
            causal_steps = calls["decode_step"] - prime.shape[1]
            nc, nc_s = timed(lambda: greedy_noncausal(model, enc, prime,
                                                      spec.max_new_tokens + 1, eos_id=eos))
        return {"encode_s": enc_s, "causal_s": causal_s, "causal_steps": causal_steps,
                "noncausal_s": nc_s, "noncausal_steps": calls["decode"],
                "causal": {k: causal[k].cpu() for k in ("tokens", "lengths")},
                "noncausal": {k: nc[k].cpu() for k in ("tokens", "lengths", "attn")}}

    model = tracked_1x(torch, dev, root, torch.bfloat16)
    for name in calls:
        setattr(ASRModel, name, counting(name))
    try:
        both_greedy(model, batches[0])          # warm-up: cuDNN picks, the allocator grows
        # The main path's run: counts set to 0 just before it, read just after.
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs = [both_greedy(model, b) for b in batches]
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        for name, fn in originals.items():
            setattr(ASRModel, name, fn)

    agreement = []
    for r in runs:
        c, nc = r["causal"], r["noncausal"]
        for i in range(len(c["lengths"])):
            agreement.append(token_agreement(c["tokens"][i, 1:int(c["lengths"][i])].tolist(),
                                             nc["tokens"][i, 1:int(nc["lengths"][i])].tolist()))

    # (2) f32 against the JAX CPU reference: the first 16 segments, one batch
    model32 = tracked_1x(torch, dev, root, torch.float32)
    first = next(iter(DataLoader(ds, len(ref["idx"]), coll, num_workers=0, drop_last=False)))
    if first["idx"].tolist() != ref["idx"]:
        fail(f"noncausal_1x: the f32 batch holds segments {first['idx'].tolist()}, the "
             f"reference's {ref['idx']}")
    t = to_device({k: first[k] for k in ("audio", "audio_lens", "text")}, dev)
    with torch.inference_mode():
        enc32 = model32.encode(t["audio"], t["audio_lens"])
        got32 = greedy_noncausal(model32, enc32, t["text"][:, :1].long(), ref["max_len"],
                                 eos_id=eos)
    lengths32 = got32["lengths"].tolist()
    tokens32 = [got32["tokens"][i, :n].tolist() for i, n in enumerate(lengths32)]
    f32_equal = sum(a == b for a, b in zip(tokens32, ref["tokens"]))
    n_attn = min(len(ref_attn), len(lengths32))
    attn_err = float(np.abs(got32["attn"][:n_attn].cpu().numpy() - ref_attn[:n_attn]).max())

    # (3) the sharded decode, in bf16 and in f32
    b0 = batches[0]
    # the episodes in the eval CLI's --unaligned order, with their references
    eps_ds = AlignedDataset(split, tok, num_utterances=None, min_segment_duration=None,
                            max_segment_duration=None,
                            speaker_map_loc=os.path.join(split, "speaker_map.json"),
                            tokenizer_speakers=True, return_spk_ids=True)
    refs = [eps_ds.index[i][1] for i in range(len(eps_ds))]
    wavs = [load_audio_segment(os.path.join(split, f"{eps_ds.index[i][0]}.wav"), 0.0, None)
            for i in range(len(eps_ds))]
    episodes = np.stack(wavs).astype(np.float32)
    ep_lens = np.full((len(wavs),), episodes.shape[1], np.int32)
    sm_spec = EvalRunner(model, tok, DecodeConfig(), out_dir=out_dir,
                         device=dev)._default_unaligned_spec()

    def sm_scored(m, out, tag):
        """The state machine's outputs scored as the eval CLI's --unaligned
        leg scores them (corpus WER / WDER, percent)."""
        where = os.path.join(out_dir, f"noncausal_sm_{tag}")
        runner = EvalRunner(m, tok, DecodeConfig(), out_dir=where, device=dev)
        host = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in out.items()}
        for lane, utts in enumerate(refs):
            runner._finish_unaligned(host, lane, utts)
        scored = score_test_result(os.path.join(where, "test_result.pkl"))
        return {"wer_pct": 100.0 * scored["overall_wer"],
                "wder_pct": 100.0 * scored["overall_wder"]}

    def split_witness(m, devs):
        """Where the parts' encoder output parts from the whole batch's:
        their features against the whole batch's (the frontend mean), and
        the encoder run on the whole batch's own features a part at a time
        against the whole batch (the kernels at another batch size)."""
        ea, el = torch.from_numpy(episodes).to(dev), torch.from_numpy(ep_lens).to(dev)
        n = len(wavs) // len(devs)
        feats = m.extract_features(ea, el)
        whole = m.encode_features(feats, el, ea.shape[-1])["encoder_out"].float()
        parts = sharded_features([m] * len(devs), devs, episodes, ep_lens)
        by_part = torch.cat([m.encode_features(feats[i * n:(i + 1) * n], el[i * n:(i + 1) * n],
                                               ea.shape[-1], batch_max_len=ea.shape[-1])
                             ["encoder_out"] for i in range(len(devs))]).float()
        split_out = torch.cat([m.encode_features(f, l, ea.shape[-1], batch_max_len=ea.shape[-1])
                               ["encoder_out"] for f, l in parts]).float()

        def apart(a, b):
            a, b = a.float(), b.float()
            return {"share_differing": float((a != b).float().mean()),
                    "max_abs_diff": float((a - b).abs().max())}
        return {"features": apart(torch.cat([f for f, _ in parts]), feats),
                "encoder_whole_features_by_part": apart(by_part, whole),
                "encoder_out": dict(apart(split_out, whole),
                                    rms=float(whole.pow(2).mean().sqrt()))}

    sharded = {}
    for dtype_name, m in (("bf16", model), ("f32", model32)):
        spec5 = spec_of(m, b0, 5)
        a, l = torch.from_numpy(b0["audio"]).to(dev), torch.from_numpy(b0["audio_lens"]).to(dev)
        prime = torch.from_numpy(b0["text"][:, :1]).long().to(dev)
        with torch.inference_mode():
            want, want_s = timed(lambda: beam_search(m, m.encode(a, l), prime, spec5))
            ea, el = torch.from_numpy(episodes).to(dev), torch.from_numpy(ep_lens).to(dev)

            def unsharded_sm():
                enc = m.encode(ea, el)
                return unaligned_decode_batched(m, enc, (~enc["encoder_padding_mask"]).sum(-1),
                                                sm_spec)
            want_sm, want_sm_s = timed(unsharded_sm)
        rec = {"beam": {"unsharded_s": want_s}, "sm": {"unsharded_s": want_sm_s}}
        for devs in SHARD_DEVICES:
            for fn in counters.values():
                fn.launches = 0
            got, secs = timed(lambda: make_sharded_decode(m, spec5, devs)(
                b0["audio"], b0["audio_lens"], b0["text"][:, :1]))
            k2_beam = fused_logmel_project.launches
            rows = sum(bool(torch.equal(got["tokens"][i].cpu(), want["tokens"][i].cpu())
                            and int(got["lengths"][i]) == int(want["lengths"][i]))
                       for i in range(len(b0["idx"])))
            rec["beam"][f"{len(devs)}_shards"] = {"s": secs, "rows_equal": rows,
                                                  "k2_launches": k2_beam}
            for fn in counters.values():
                fn.launches = 0
            got_sm, secs = timed(lambda: make_sharded_unaligned(m, sm_spec, devs)(
                episodes, ep_lens))
            k2_sm = fused_logmel_project.launches
            eps_equal = sum(bool(torch.equal(got_sm["tokens"][i].cpu(), want_sm["tokens"][i].cpu())
                                 and int(got_sm["num_tokens"][i]) == int(want_sm["num_tokens"][i]))
                            for i in range(len(wavs)))
            rec["sm"][f"{len(devs)}_shards"] = {
                "s": secs, "episodes_equal": eps_equal, "k2_launches": k2_sm,
                "k1_launches": fused_layer_step.launches,
                "first_divergence": first_divergence(got_sm["tokens"].cpu().numpy(),
                                                     want_sm["tokens"].cpu().numpy()),
                "num_tokens": got_sm["num_tokens"].tolist(),
                **sm_scored(m, got_sm, f"{dtype_name}_{len(devs)}_shards")}
        rec["sm"]["unsharded"] = {"num_tokens": want_sm["num_tokens"].tolist(),
                                  **sm_scored(m, want_sm, f"{dtype_name}_unsharded")}
        with torch.inference_mode():
            rec["sm"]["two_shards_witness"] = split_witness(m, SHARD_DEVICES[-1])
        sharded[dtype_name] = rec

    out = {"phase": "noncausal_1x", "card": card, "segments": len(ds),
           "batches": [len(b["idx"]) for b in batches], "main_s": main_s,
           "launches": launches,
           "runs": [{k: r[k] for k in ("encode_s", "causal_s", "causal_steps", "noncausal_s",
                                       "noncausal_steps")} for r in runs],
           "agreement_mean": float(np.mean(agreement)), "agreement": agreement,
           "agreement_jax_cpu_f32_first16": ref["mean_agreement"],
           "f32_vs_jax": {"segments": len(ref["idx"]), "tokens_equal": f32_equal,
                          "lengths_equal": lengths32 == ref["lengths"],
                          "attn_max_abs_err": attn_err, "attn_rows": len(ref_attn),
                          "attn_tolerance": NC_ATTN_TOL},
           "sharded": sharded, "shards_of": list(map(list, SHARD_DEVICES)),
           "k2_rows": {"main": [len(b["idx"]) * (1 + EVAL_SAMPLES // 160) for b in batches],
                       "beam_part": (len(b0["idx"]) // 2) * (1 + EVAL_SAMPLES // 160),
                       "sm_part": (len(wavs) // 2) * (1 + episodes.shape[1] // 160)}}
    emit(out)
    del model, model32
    torch.cuda.empty_cache()
    want = {"fused_layer_step": 0, "fused_logmel_project": len(batches)}
    if launches != want:
        fail(f"noncausal_1x: launches {launches}, expected {want}")
    if len(ds) != 118 or out["batches"] != [64, 54]:
        fail(f"noncausal_1x: {len(ds)} segments in batches {out['batches']}, expected 118 "
             f"in [64, 54]")
    if f32_equal != len(ref["idx"]) or lengths32 != ref["lengths"] or attn_err > NC_ATTN_TOL:
        fail(f"noncausal_1x: f32 tokens of {f32_equal} of {len(ref['idx'])} segments equal the "
             f"JAX CPU reference's, lengths equal {lengths32 == ref['lengths']}, attn "
             f"{attn_err} (> {NC_ATTN_TOL}?)")
    for dtype_name, rec in sharded.items():
        for devs in SHARD_DEVICES:
            key = f"{len(devs)}_shards"
            beam, sm = rec["beam"][key], rec["sm"][key]
            if beam["k2_launches"] != len(devs) or sm["k2_launches"] != len(devs) or \
                    sm["k1_launches"]:
                fail(f"noncausal_1x: sharded {dtype_name} {key}: K2 {beam['k2_launches']} / "
                     f"{sm['k2_launches']} launches, expected one a part; K1 {sm['k1_launches']}")
            if beam["rows_equal"] != len(b0["idx"]) or sm["episodes_equal"] != len(wavs):
                fail(f"noncausal_1x: sharded {dtype_name} {key}: {beam['rows_equal']} of "
                     f"{len(b0['idx'])} beam rows and {sm['episodes_equal']} of {len(wavs)} "
                     f"episodes equal the unsharded decode's")
    return out


# ---------------------------------------------------------------------------
# Phase 11: speaker-embedding export and the contrastive head (embed_1x)
# ---------------------------------------------------------------------------
# scripts/embed_chain.sh steps 1-2 on the tracked checkpoint: cli.gen_embed
# on the test split (f32 against the JAX CLI at its fixture's batch of 16;
# bf16 at the CLI's default batch 64, K2 at N = 64064 / 54054) and on the
# train split cut to 8 episodes (bf16, timed; K2 at its batches' rows);
# cli.train_embed at its defaults on the port's pickles and on the JAX CLI's.
EMBED_ROWS_TOL = 1e-4                # f32 rows against the JAX CLI's
EMBED_ARGMAX_SHARE = 0.97            # bf16 posteriors' argmax against the JAX CLI's f32
EMBED_VALID_ACC_BAND = 0.05          # cli.train_embed's valid accuracy, port vs JAX
EMBED_LOSS_TOL = 1e-5                # EmbedSystem's first steps against JAX's


def run_embed_1x(torch, dev, root, out_dir, card):
    """The speaker-embedding chain's producer half on the card.
    (1) `cli.gen_embed` on the test split in f32 at the JAX fixture's
    batch: the same rows in the same order, the same speaker ids, rows
    within EMBED_ROWS_TOL. (2) The same in bf16 at the CLI's defaults, as
    users run it: the posteriors' argmax equal to the JAX CLI's f32 ones on
    at least EMBED_ARGMAX_SHARE of the rows; K2 once a batch. (3) On the
    train split cut to 8 episodes (embed_chain.sh step 1), bf16, timed.
    (4) `cli.train_embed` at its defaults (2000 steps, batch 64, 6-way) on
    (3)'s pickles, timed; and on the JAX CLI's f32 pickles of the same
    split, its valid accuracy within EMBED_VALID_ACC_BAND of the JAX CLI's.
    (5) EmbedSystem from the JAX EmbedSystem's initial parameters on the
    fixture's episodes: the first steps' losses within EMBED_LOSS_TOL.
    Returns the record, with each counted run's K2 launches and the audio
    shapes its batches gave K2."""
    import tal_asrd_tpu_torch.eval.gen_embed as gen_embed
    from tal_asrd_tpu_torch.cli import gen_embed as cli_gen_embed
    from tal_asrd_tpu_torch.cli import train_embed as cli_train_embed
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.train.embed_system import (
        ContrastiveCollator, ContrastiveDataset, EmbedSystem)

    with open(os.path.join(root, EMBED_FIXTURE)) as f:
        ref = json.load(f)
    arrays = np.load(os.path.join(root, EMBED_ARRAYS))
    base = os.path.join(out_dir, "embed")
    splits = {"card": eval_split_of(out_dir), "train8": os.path.join(base, "train8")}
    if ref["splits"]["train8"] != TRAIN_CLI_SPLITS["train"]:
        fail(f"embed_1x: the fixture's train split {ref['splits']['train8']} is not "
             f"train_cli_1x's {TRAIN_CLI_SPLITS['train']}")
    t0 = time.perf_counter()
    build_synth_corpus(splits["train8"], **TRAIN_CLI_SPLITS["train"])
    split_s = time.perf_counter() - t0
    real_posteriors = gen_embed.speaker_posteriors

    def export(split, tag, compute_dtype=None, batch=None):
        """cli.gen_embed.main with the counts set to 0 just before it and
        read just after; each batch's posteriors at the speaker positions
        and its audio shape recorded."""
        probs, shapes = [], []

        def recording(model, audio, audio_lens, text):
            before = fused_logmel_project.launches
            out = real_posteriors(model, audio, audio_lens, text)
            probs.append(out[0][out[1]].cpu().numpy())
            shapes.append((tuple(audio.shape), fused_logmel_project.launches - before))
            return out

        argv = ["--train-data", splits[split], "--valid-data", splits[split],
                "--tokenizer", os.path.join(root, "accuracy_release", "bpe.model"),
                "--model-type", "1x", "--num-speakers", "8", "--num-workers", "0",
                "--load", os.path.join(root, "accuracy_release", "avg_last_3.bf16.msgpack"),
                "--out-path", os.path.join(base, f"spk_{tag}"), "--device", dev] + (
                    ["--batch-size", str(batch)] if batch else [])
        system = cli_gen_embed.ASRSystem
        gen_embed.speaker_posteriors = recording
        if compute_dtype is not None:
            cli_gen_embed.ASRSystem = functools.partial(system, compute_dtype=compute_dtype)
        try:
            fused_logmel_project.launches = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows, ids = cli_gen_embed.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            k2 = fused_logmel_project.launches
        finally:
            gen_embed.speaker_posteriors = real_posteriors
            cli_gen_embed.ASRSystem = system
        return {"rows": rows, "ids": ids, "probs": np.concatenate(probs), "shapes": shapes,
                "s": secs, "k2_launches": k2, "batches": len(shapes),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}

    def train_head(tag, pickles):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli_train_embed.main(["--train-data", pickles + ".train.pkl",
                                    "--valid-data", pickles + ".valid.pkl",
                                    "--out", os.path.join(base, f"head_{tag}.msgpack"),
                                    "--device", dev])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return {"s": secs, "ms_a_step": 1e3 * secs / len(res["losses"]),
                "steps": len(res["losses"]), "train_acc": res["train_acc"],
                "valid_acc": res["valid_acc"], "valid_loss": res["valid_loss"],
                "loss_first_last": [res["losses"][0], res["losses"][-1]],
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}

    export("card", "warmup", batch=ref["batch"]["card"])     # cuDNN picks, not counted
    f32 = export("card", "card_f32", torch.float32, ref["batch"]["card"])
    bf16 = export("card", "card_bf16")
    train8 = export("train8", "train8")
    want_rows, want_ids = arrays["gen_embed/card/rows"], arrays["gen_embed/card/ids"]
    want_argmax = arrays["gen_embed/card/probs"].argmax(-1)
    same_rows = len(f32["rows"]) == len(want_rows) and np.array_equal(f32["ids"], want_ids)
    f32_err = float(np.abs(f32["rows"] - want_rows).max()) if same_rows else float("inf")
    bf16_same = len(bf16["rows"]) == len(want_rows) and np.array_equal(bf16["ids"], want_ids)
    argmax_share = (float(np.mean(bf16["probs"].argmax(-1) == want_argmax))
                    if bf16_same else 0.0)

    port_head = train_head("port", os.path.join(base, "spk_train8"))
    jax_pickles = os.path.join(base, "jax_train8")
    gen_embed.save_split(arrays["gen_embed/train8/rows"], arrays["gen_embed/train8/ids"],
                         jax_pickles)
    jax_head = train_head("jax_pickles", jax_pickles)

    es = ref["embed_system"]
    rows, ids = arrays["gen_embed/train8/rows"], arrays["gen_embed/train8/ids"]
    n_train = ref["gen_embed"]["train8"]["n_train"]
    ds = ContrastiveDataset(rows[:n_train], ids[:n_train], n_way=es["n_way"],
                            seed=es["episode_seed"], epoch_len=es["steps"] * es["batch_size"])
    episodes = [ContrastiveCollator()([ds[i * es["batch_size"] + j]
                                       for j in range(es["batch_size"])])
                for i in range(es["steps"])]
    init = {}
    for key in arrays.files:
        if key.startswith("embed_system/init/"):
            _, _, layer, leaf = key.split("/")
            init.setdefault(layer, {})[leaf] = arrays[key]
    losses, accs = EmbedSystem(batch_size=es["batch_size"], params=init, device=dev).fit(
        iter(episodes))
    loss_err = float(np.abs(np.asarray(losses) - es["losses"]).max())

    def summary(r):
        by_shape = {}
        for shape, n in r["shapes"]:
            by_shape[shape] = by_shape.get(shape, 0) + n
        return {k: r[k] for k in ("s", "k2_launches", "batches", "peak_memory_gb")} | {
            "rows": len(r["rows"]), "k2_launches_by_shape": {
                f"{b}x{t}": n for (b, t), n in sorted(by_shape.items())}}

    out = {"phase": "embed_1x", "card": card, "train8_split_s": split_s,
           "gen_embed": {"card_f32": summary(f32), "card_bf16": summary(bf16),
                         "train8_bf16": summary(train8)},
           "f32_vs_jax": {"rows": len(f32["rows"]), "jax_rows": len(want_rows),
                          "ids_equal": same_rows, "max_abs_err": f32_err,
                          "tolerance": EMBED_ROWS_TOL},
           "bf16_vs_jax_f32": {"ids_equal": bf16_same, "argmax_equal_share": argmax_share,
                               "min_share": EMBED_ARGMAX_SHARE},
           "train_embed": {"port_pickles": port_head, "jax_pickles": jax_head,
                           "jax_cli_on_jax_pickles": {k: ref["train_embed"][k] for k in (
                               "train_acc", "valid_acc")}},
           "embed_system_vs_jax": {"steps": len(losses), "loss_max_abs_err": loss_err,
                                   "accs_equal": list(accs) == list(es["accs"]),
                                   "tolerance": EMBED_LOSS_TOL}}
    emit(out)
    if not same_rows or f32_err > EMBED_ROWS_TOL:
        fail(f"embed_1x: f32 rows {len(f32['rows'])} (JAX {len(want_rows)}), ids equal "
             f"{same_rows}, max error {f32_err} (> {EMBED_ROWS_TOL}?)")
    if argmax_share < EMBED_ARGMAX_SHARE:
        fail(f"embed_1x: bf16 argmax equal on {argmax_share} of the rows (ids equal "
             f"{bf16_same}), < {EMBED_ARGMAX_SHARE}")
    for name, r in (("card_f32", f32), ("card_bf16", bf16), ("train8", train8)):
        if r["k2_launches"] != r["batches"] or r["batches"] < 1:
            fail(f"embed_1x: {name}: K2 launched {r['k2_launches']} times for "
                 f"{r['batches']} batches")
    if abs(jax_head["valid_acc"] - ref["train_embed"]["valid_acc"]) > EMBED_VALID_ACC_BAND:
        fail(f"embed_1x: valid accuracy {jax_head['valid_acc']} on the JAX CLI's pickles, "
             f"the JAX CLI's {ref['train_embed']['valid_acc']} (band {EMBED_VALID_ACC_BAND})")
    if loss_err > EMBED_LOSS_TOL or not out["embed_system_vs_jax"]["accs_equal"]:
        fail(f"embed_1x: EmbedSystem's first {len(losses)} losses {loss_err} from JAX's "
             f"(> {EMBED_LOSS_TOL}?), accuracies equal {out['embed_system_vs_jax']['accs_equal']}")
    return out


CLUSTER_FIXTURE = os.path.join("tests", "fixtures", "torch_cluster_reference.json")
CLUSTER_ARRAYS = os.path.join("tests", "fixtures", "torch_cluster_reference_arrays.npz")
CLUSTER_TIE_GAP = 1e-6               # a parting is a near-tie if the inputs differ by less
CLUSTER_HEAD_TOL = 1e-5              # the head's images on the card against the JAX CLI's


def same_partition(a, b) -> bool:
    """Equal label lists up to renumbering."""
    pairs = {}
    for x, y in zip(a, b):
        if pairs.setdefault(x, y) != y:
            return False
    return len(a) == len(b) and len(set(a)) == len(set(b))


def run_cluster_1x(torch, dev, root, out_dir, card):
    """The embedding chain's clustering half on the card
    (scripts/embed_chain.sh step 3). (a) The chain: the eval CLI aligned,
    --fused-decode, bf16 (K2, K1; the counts set to 0 just before it and
    read just after), `cli.tools wder-format`, the metric head (embed_1x's
    where that phase ran, else `cli.gen_embed` on the train split cut to 8
    episodes and `cli.train_embed` at their defaults), `cli.wder --cluster
    --cluster-method agglomerative --metric cos_dist` raw and with
    --embed-head. On the aligned split each segment holds one reference
    utterance, so (a) checks the path, not the engines. (b) The engines at
    the chain's real size on the JAX CLI's rows of the test split
    (CLUSTER_FIXTURE): every parameter set of default_param_grid() and
    cli.wder's four methods x five metrics on each episode, raw and through
    the JAX CLI's head on the card, against JAX's partitions. A parting
    passes only with a witness: the port given JAX's inputs (XLA's cosine
    matrix, the JAX CLI's head images) gives JAX's labels and the inputs
    differ by less than CLUSTER_TIE_GAP; or, for the Bayesian GMM, the same
    input and k-means labels, a JAX fit that did not converge and a first
    lower bound within CLUSTER_TIE_GAP (relative) of JAX's: the host's
    rounding amplified by the steps (ROADMAP C23). Then the port's
    cli.wder_search TSV against the JAX CLI's and the chain's -wder.pkl
    fields."""
    import tal_asrd_tpu_torch.eval.clustering as clustering
    import tal_asrd_tpu_torch.eval.engines as engines
    import tal_asrd_tpu_torch.eval.wder_search as wder_search
    from tal_asrd_tpu_torch.cli import gen_embed as cli_gen_embed
    from tal_asrd_tpu_torch.cli import tools as cli_tools
    from tal_asrd_tpu_torch.cli import train_embed as cli_train_embed
    from tal_asrd_tpu_torch.cli import wder as cli_wder
    from tal_asrd_tpu_torch.cli import wder_search as cli_wder_search
    from tal_asrd_tpu_torch.core.checkpoint import save_pytree
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project

    ref = reference_script(root, "torch_cluster_reference")
    with open(os.path.join(root, CLUSTER_FIXTURE)) as f:
        fx = json.load(f)
    arrays = np.load(os.path.join(root, CLUSTER_ARRAYS))
    base = os.path.join(out_dir, "cluster")
    os.makedirs(base, exist_ok=True)
    bpe = os.path.join(root, "accuracy_release", "bpe.model")
    ckpt = os.path.join(root, "accuracy_release", "avg_last_3.bf16.msgpack")

    # ---- (a) the chain ------------------------------------------------------------
    split = eval_split_of(out_dir)
    counters = {"fused_layer_step": fused_layer_step,
                "fused_logmel_project": fused_logmel_project}
    argv = ["--train-data", split, "--valid-data", split, "--test-data", split,
            "--tokenizer", bpe, "--model-type", "1x", "--num-speakers", "8", "--load", ckpt,
            "--out-dir", os.path.join(base, "eval"), "--fused-decode", "--device", dev]
    _, eval_s, rec = run_eval_counted(torch, argv, counters)
    ready = os.path.join(base, "wder_ready_aligned.pkl")
    cli_tools.main(["wder-format", "--test-result", os.path.join(base, "eval", "test_result.pkl"),
                    "--out", ready, "--device", dev])
    head = os.path.join(out_dir, "embed", "head_port.msgpack")
    head_from = "embed_1x"
    if not os.path.exists(head):
        head_from = "this phase: cli.gen_embed (train split cut to 8 episodes) + cli.train_embed"
        train8 = os.path.join(base, "train8")
        build_synth_corpus(train8, **TRAIN_CLI_SPLITS["train"])
        cli_gen_embed.main(["--train-data", train8, "--valid-data", train8, "--tokenizer", bpe,
                            "--model-type", "1x", "--num-speakers", "8", "--num-workers", "0",
                            "--load", ckpt, "--out-path", os.path.join(base, "spk"),
                            "--device", dev])
        head = os.path.join(base, "embed_head.msgpack")
        cli_train_embed.main(["--train-data", os.path.join(base, "spk.train.pkl"),
                              "--valid-data", os.path.join(base, "spk.valid.pkl"),
                              "--out", head, "--device", dev])
    chain = {}
    for tag, extra in (("raw", []), ("head", ["--embed-head", head])):
        t0 = time.perf_counter()
        fields = cli_wder.main(["--eval-file", ready, "--workers", "1", "--cluster",
                                "--cluster-method", "agglomerative", "--metric", "cos_dist",
                                "--device", dev] + extra)
        chain[tag] = {"wder_pct": 100 * fields["overall_wder"],
                      "wer_pct": 100 * fields["overall_wer"], "s": time.perf_counter() - t0}

    # ---- (b) the engines at the chain's real size ----------------------------------------
    jax_head = os.path.join(base, "jax_head.msgpack")
    save_pytree(jax_head, ref.head_tree(arrays))
    raw = ref.paired_results(fx, arrays)
    mapped = wder_search.apply_embed_head(raw, jax_head, dev)
    head_rows = np.stack([e for _, hyps in mapped for _, (e, _), _ in hyps])
    want_rows = np.stack([arrays["head_rows"][u["row"]] for seg in fx["segments"] for u in seg])
    head_err = float(np.abs(head_rows - want_rows).max())
    inputs = {"raw": raw, "head": mapped}
    jax_inputs = {"raw": raw, "head": ref.paired_results(fx, arrays, head=True)}

    real_cos = clustering.cosine_distance_matrix
    seen = {}

    def recording_cos(x, device="cuda"):
        d = real_cos(x, device)
        seen[x.shape[1]] = d
        return d

    def witness(call, variant, seg, dims):
        """Rerun `call` (from the same draws) with JAX's inputs: XLA's cosine
        matrix and the JAX CLI's head images. Returns (labels, input gap)."""
        jax_d = arrays[f"cos/{variant}/seg{seg}/d{dims}"] if \
            f"cos/{variant}/seg{seg}/d{dims}" in arrays.files else None
        gaps = []
        if jax_d is not None and dims in seen:
            gaps.append(float(np.abs(seen[dims] - jax_d).max()))
        if variant == "head":
            gaps.append(head_err)
        clustering.cosine_distance_matrix = (lambda x, device="cuda": jax_d) \
            if jax_d is not None else real_cos
        try:
            got = call()
        except ValueError as e:
            got = f"ValueError: {e}"
        finally:
            clustering.cosine_distance_matrix = recording_cos
        return got, max(gaps) if gaps else float("inf")

    def held(variant, seg, name, got, want, rerun, dims):
        """One comparison: equal, witnessed near-tie, or a failure."""
        if isinstance(got, str) or isinstance(want, str):
            ok = got == want
        else:
            ok = same_partition(got, want)
        if ok:
            return None
        if name.startswith("('gmm'"):
            return {"variant": variant, "segment": seg, "set": name, "witnessed": False,
                    "port": str(got)[:200], "jax": str(want)[:200]}
        again, gap = witness(rerun, variant, seg, dims)
        tie = (again == want if isinstance(want, str) else
               not isinstance(again, str) and same_partition(again, want)) and \
            gap < CLUSTER_TIE_GAP
        return {"variant": variant, "segment": seg, "set": name, "gap": gap,
                "witnessed": bool(tie), "port": str(got)[:200], "jax": str(want)[:200]}

    # of every Bayesian GMM: its input, its k-means labels, its lower bounds
    real_gmm, real_km, real_lb = engines.bayesian_gmm, engines.kmeans_labels, \
        engines._gmm_lower_bound
    fit = {}

    def recording_gmm(x, *a, **k):
        fit.update(x=np.array(x), lb=[])
        return real_gmm(x, *a, **k)

    def recording_km(*a, **k):
        fit["km"] = real_km(*a, **k)
        return fit["km"]

    def recording_lb(*a, **k):
        fit["lb"].append(real_lb(*a, **k))
        return fit["lb"][-1]

    def gmm_witness(variant, seg, index):
        """A GMM that parts from the same input (within CLUSTER_TIE_GAP) and
        the same k-means labels, whose JAX fit did not converge, and whose
        first lower bound is within CLUSTER_TIE_GAP (relative) of JAX's: the
        host's rounding, amplified by the non-converging steps."""
        key = f"gmm/{variant}/seg{seg}/{index}"
        info = fx["gmm"][variant].get(f"{seg}/{index}")
        if info is None or key + "/x" not in arrays.files or "x" not in fit:
            return None
        jx, jlb = arrays[key + "/x"], arrays[key + "/lb"]
        x_gap = float(np.abs(fit["x"] - jx).max()) if fit["x"].shape == jx.shape else \
            float("inf")
        lb_gap = float(abs(fit["lb"][0] - jlb[0]) / abs(jlb[0])) if len(fit["lb"]) and \
            len(jlb) else float("inf")
        same_init = key + "/km" in arrays.files and "km" in fit and \
            np.array_equal(fit["km"], arrays[key + "/km"])
        return {"input_gap": x_gap, "kmeans_equal": bool(same_init),
                "first_lower_bound_rel_gap": lb_gap, "jax_steps": info["n_iter"],
                "jax_converged": info["converged"], "port_steps": len(fit["lb"]),
                "witnessed": bool(x_gap < CLUSTER_TIE_GAP and same_init
                                  and not info["converged"] and lb_gap < CLUSTER_TIE_GAP)}

    partings, n_compared = [], 0
    clustering.cosine_distance_matrix = recording_cos
    engines.bayesian_gmm, engines.kmeans_labels, engines._gmm_lower_bound = \
        recording_gmm, recording_km, recording_lb
    grid_s = {}
    try:
        for variant in ("raw", "head"):
            rng = np.random.RandomState(2020)
            t0 = time.perf_counter()
            for seg, (_, hyp_us) in enumerate(inputs[variant]):
                table = wder_search.get_word_speakers(hyp_us, embeddings=True)[4]
                jtable = wder_search.get_word_speakers(jax_inputs[variant][seg][1],
                                                       embeddings=True)[4]
                for index, pset in enumerate(wder_search.default_param_grid()[1:]):
                    state = rng.get_state()
                    seen.clear()
                    fit.clear()
                    try:
                        got = np.asarray(wder_search.cluster_param_labels(
                            table, pset, dev, rng)).tolist()
                    except ValueError as e:
                        got = f"ValueError: {e}"

                    def rerun(pset=pset, state=state, jtable=jtable):
                        r = np.random.RandomState()
                        r.set_state(state)
                        return np.asarray(wder_search.cluster_param_labels(
                            jtable, pset, dev, r)).tolist()
                    dims = 16 if pset[-2] == 16 and variant == "raw" else (
                        64 if variant == "raw" else 10)
                    n_compared += 1
                    p = held(variant, seg, ref.pset_key(pset), got,
                             fx["grid"][variant][seg][ref.pset_key(pset)], rerun, dims)
                    if p and pset[0] == "gmm":
                        p["gmm"] = gmm_witness(variant, seg, index)
                        p["witnessed"] = bool(p["gmm"] and p["gmm"]["witnessed"])
                    if p:
                        partings.append(p)
            grid_s[variant] = time.perf_counter() - t0

        # cli.wder --cluster, each method x metric, labels of every segment
        real_make = cli_wder.make_cluster_fn
        for variant, extra in (("raw", []), ("head", ["--embed-head", jax_head])):
            eval_file = os.path.join(base, f"ready_{variant}", "wder_ready.pkl")
            os.makedirs(os.path.dirname(eval_file), exist_ok=True)
            with open(eval_file, "wb") as f:
                pickle.dump(raw, f)
            for key, want in fx["wder"][variant].items():
                method, metric = key.split("/")
                got = []

                def make(*a, **k):
                    fn = real_make(*a, **k)

                    def rec_fn(emb, **extra_kw):
                        state, seg = k["rng"].get_state(), len(got)
                        seen.clear()
                        lab = np.asarray(fn(emb, **extra_kw)).tolist()
                        got.append((lab, state, [np.asarray(e) for e in emb]))
                        return lab
                    return rec_fn

                cli_wder.make_cluster_fn = make
                raises = None
                try:
                    cli_wder.main(["--eval-file", eval_file, "--cluster", "--cluster-method",
                                   method, "--metric", metric, "--workers", "1",
                                   "--device", dev] + extra)
                except ValueError as e:
                    raises = f"ValueError: {e}"
                finally:
                    cli_wder.make_cluster_fn = real_make
                n_compared += 1
                if (raises or None) != want["raises"] or len(got) != len(want["labels"]):
                    partings.append({"variant": variant, "set": f"cli.wder {key}",
                                     "witnessed": False, "port": str(raises),
                                     "jax": str(want["raises"]),
                                     "segments": [len(got), len(want["labels"])]})
                    continue
                for seg, ((lab, state, emb), w) in enumerate(zip(got, want["labels"])):
                    n_compared += 1
                    jemb = [h[1][0] for h in jax_inputs[variant][seg][1]]

                    def rerun(state=state, jemb=jemb, method=method, metric=metric):
                        r = np.random.RandomState()
                        r.set_state(state)
                        return np.asarray(clustering.cluster_embeddings(
                            jemb, method=method, metric=metric, device=dev, rng=r)).tolist()
                    p = held(variant, seg, f"cli.wder {key}", lab, w, rerun,
                             64 if variant == "raw" else 10)
                    if p:
                        partings.append(p)
    finally:
        clustering.cosine_distance_matrix = real_cos
        engines.bayesian_gmm, engines.kmeans_labels, engines._gmm_lower_bound = \
            real_gmm, real_km, real_lb

    # the grid CLI's TSV and the chain's -wder.pkl against the JAX CLIs'
    tsv, pkl = {}, {}
    for variant, extra in (("raw", []), ("head", ["--embed-head", jax_head])):
        out_tsv = os.path.join(base, f"grid_{variant}.tsv")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            cli_wder_search.main(["--eval-file", os.path.join(base, "ready_raw", "wder_ready.pkl"),
                                  "--workers", "1", "--out-tsv", out_tsv, "--device", dev] + extra)
            with open(out_tsv) as f:
                got = {"text": f.read(), "raises": None}
        except ValueError as e:
            got = {"text": None, "raises": f"ValueError: {e}"}
        tsv[variant] = {"equal": got == fx["tsv"][variant], "s": time.perf_counter() - t0,
                        "raises": got["raises"], "lines": len((got["text"] or "").splitlines())}
        fields = cli_wder.main(["--eval-file", os.path.join(base, "ready_raw", "wder_ready.pkl"),
                                "--cluster", "--cluster-method", fx["chain"][0], "--metric",
                                fx["chain"][1], "--workers", "1", "--device", dev] + extra)
        want = fx["wder_pkl"][variant]
        pkl[variant] = {
            "wder_pct": 100 * fields["overall_wder"], "jax_wder_pct": 100 * want["overall_wder"],
            "equal": fields["overall_wder"] == want["overall_wder"]
            and fields["overall_wer"] == want["overall_wer"]
            and [np.asarray(h).tolist() for h in fields["hyp_speakers"]] == want["hyp_speakers"]
            and [np.asarray(r).tolist() for r in fields["ref_speakers"]] == want["ref_speakers"]}

    unwitnessed = [p for p in partings if not p["witnessed"]]
    out = {"phase": "cluster_1x", "card": card,
           "chain": {"note": "each aligned segment holds one reference utterance: this "
                             "checks the path, not the engines",
                     "cluster_wder_pct": chain["raw"]["wder_pct"],
                     "cluster_head_wder_pct": chain["head"]["wder_pct"],
                     "jax_cluster_wder_pct": 0.0, "jax_cluster_head_wder_pct": 0.0,
                     "eval_s": eval_s, "launches": rec["launches"],
                     "decode_steps": rec["decode_steps"], "head_from": head_from,
                     "wder_s": {k: v["s"] for k, v in chain.items()}},
           "engines": {"segments": len(fx["segments"]),
                       "rows": [len(seg) for seg in fx["segments"]],
                       "compared": n_compared, "partings": partings,
                       "head_rows_max_abs_err": head_err, "head_tolerance": CLUSTER_HEAD_TOL,
                       "grid_s": grid_s, "tsv": tsv, "wder_pkl": pkl}}
    emit(out)
    if rec["launches"]["fused_layer_step"] <= 0 or rec["launches"]["fused_logmel_project"] <= 0:
        fail(f"cluster_1x: the chain's eval launched {rec['launches']}")
    if unwitnessed:
        fail(f"cluster_1x: {len(unwitnessed)} partitions part from JAX's without a "
             f"near-tie witness: {unwitnessed[:4]}")
    if head_err > CLUSTER_HEAD_TOL:
        fail(f"cluster_1x: the head's images {head_err} from the JAX CLI's")
    # a witnessed parting may move the figures it feeds, and nothing else may
    for variant in ("raw", "head"):
        mine = [p["set"] for p in partings if p["variant"] == variant]
        if not tsv[variant]["equal"] and not any(not m.startswith("cli.wder") for m in mine):
            fail(f"cluster_1x: the cli.wder_search TSV ({variant}) differs from the JAX "
                 f"CLI's: {tsv[variant]}")
        if not pkl[variant]["equal"] and "cli.wder " + "/".join(fx["chain"]) not in mine:
            fail(f"cluster_1x: the chain's -wder.pkl fields ({variant}) differ from the JAX "
                 f"CLI's: {pkl[variant]}")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the speaker baseline (SD) and its reconciliation
# ---------------------------------------------------------------------------
SD_FIXTURE = os.path.join("tests", "fixtures", "torch_sd_reference.json")
SD_ARRAYS = os.path.join("tests", "fixtures", "torch_sd_reference_arrays.npz")
SD_FEATURE_TOL = 1e-4                 # f32 frame embeddings against the JAX CPU reference's
SD_TIE_GAP = 1e-5                     # top-2 logits closer than this: an argmax tie
SD_ARGMAX_SHARE = 0.97                # bf16 argmax ids against JAX's f32 ids
SD_LOSS_TOL = 1e-4                    # f32 LAMB losses (relative) against JAX's
SD_CLI_STEPS = 20
SD_WINDOW_TOL = 1e-5                  # the card's window embeddings against the host einsum


def counted_steps(torch, cls, counters):
    """Wrap cls.train_step to record each batch's audio shape and the
    kernel launches its step made (read off the counters around it).
    Returns (shapes, restore)."""
    shapes = {}
    real = cls.train_step

    def step(self, batch):
        before = {k: fn.launches for k, fn in counters.items()}
        out = real(self, batch)
        rec = shapes.setdefault("x".join(map(str, np.shape(batch["audio"]))),
                                dict.fromkeys(["steps", *counters], 0))
        rec["steps"] += 1
        for k, fn in counters.items():
            rec[k] += fn.launches - before[k]
        return out
    cls.train_step = step
    return shapes, lambda: setattr(cls, "train_step", real)


def window_gap(test_result, ready, feats, chunk=357):
    """Largest gap between the card's attention-windowed SD embeddings in
    the wder-ready pickle and the host's numpy einsum of the same inputs
    (eval/convert.py `_window_embed`'s arithmetic), over every hypothesis
    utterance; and how many there were."""
    with open(test_result, "rb") as f:
        results = pickle.load(f)
    with open(ready, "rb") as f:
        pairs = pickle.load(f)
    feats = np.asarray(feats, np.float32)
    t_total, d = feats.shape
    padded = np.concatenate([feats, np.zeros((chunk, d), np.float32)])
    gap, n = 0.0, 0
    for (_, hyps), (_, entries) in zip(results, pairs):
        for h, (_, (emb, _), _) in zip(hyps, entries):
            att = np.asarray(h["attention"], np.float32)[..., :chunk]
            idx = np.minimum(np.asarray(h["chunkStart"], np.int64)[:, None]
                             + np.arange(att.shape[1])[None, :], t_total + chunk - 1)
            host = np.einsum("tc,tcd->td", att * (idx < t_total), padded[idx])
            gap = max(gap, float(np.abs(host - emb).max()))
            n += 1
    return gap, n


def hyp_times(hyps, hop=0.08):
    """A separate-ASR hypothesis utterance's times, from the machine's
    alignment: its tokens' attention peaks (chunkStart + argmax), the first
    peak's frame to one past the last's."""
    out = []
    for h in hyps:
        frames = (np.asarray(h["chunkStart"], np.int64)
                  + np.asarray(h["attention"], np.float32).argmax(-1))
        out.append({"utterance": h["utterance"], "utterance_start": float(frames.min() * hop),
                    "utterance_end": float((frames.max() + 1) * hop)})
    return out


def run_sd_baseline_1x(torch, dev, root, out_dir, card, trace=False):
    """The speaker baseline at the 1x TDS's full width (SDModelConfig: 6008
    speakers) on the card. (a) `SDSystem.frame_features` on the seeded tree
    (scripts/torch_sd_reference.py `seeded_sd_tree`: the tracked encoder
    under seeded heads) over the first two SDUtteranceDataset samples of the
    test split, f32 (TF32 off) against the JAX CPU reference (SD_FIXTURE)
    and bf16 against JAX's f32 ids. (b) 6 f32 LAMB steps of SDSystem at
    B = 4 x 10 s against JAX's losses. (c) `python -m
    tal_asrd_tpu_torch.cli.train_sd` at its defaults (batch 64, --max-secs
    20, bf16, SpecAugment on) on the train split cut to 8 episodes,
    --max-steps 20, K2 and K4 counted by batch shape. (d) The
    reconciliation chain with that checkpoint: `dump_episode_features` over
    the test split's episodes (K2), the eval CLI --unaligned --fused-decode
    on a split of the first episode alone (K1, K2; the counts set to 0 just
    before it and read just after), `cli.tools wder-format --sd-features`
    (its window embeddings against the host's einsum) and `cli.wder` on it
    (`--cluster` raises there, as JAX's does: ROADMAP C27), and
    `merge_asr_sd` of the machine's utterances (times from its attention
    peaks) with the SD frame tracks, scored by `cli.wder` on the SD ids and
    `cli.wder --cluster` on the mean SD embeddings."""
    from tal_asrd_tpu_torch.baseline import SDSystem, dump_episode_features, merge_asr_sd
    from tal_asrd_tpu_torch.cli import tools as cli_tools
    from tal_asrd_tpu_torch.cli import train_sd as cli_train_sd
    from tal_asrd_tpu_torch.cli import wder as cli_wder
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree
    from tal_asrd_tpu_torch.core.config import SDModelConfig, SpecAugmentConfig, TrainConfig
    from tal_asrd_tpu_torch.data import SDCollater, SDUtteranceDataset
    from tal_asrd_tpu_torch.data.audio_io import load_audio_segment
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.data.transcript import load_transcripts
    from tal_asrd_tpu_torch.eval.convert import convert_results
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.ops.specaug import spec_augment

    ref = reference_script(root, "torch_sd_reference")
    with open(os.path.join(root, SD_FIXTURE)) as f:
        fx = json.load(f)
    arrays = np.load(os.path.join(root, SD_ARRAYS))
    base = os.path.join(out_dir, "sd")
    os.makedirs(base, exist_ok=True)
    tree = ref.seeded_sd_tree(load_pytree(os.path.join(root, ref.CHECKPOINT)))
    test = eval_split_of(out_dir)
    no_aug = SpecAugmentConfig(num_freq_masks=0, num_time_masks=0)
    f32 = torch.float32
    out = {"phase": "sd_baseline_1x", "card": card}

    # ---- (a) frame features -----------------------------------------------------
    ds = SDUtteranceDataset(test, speaker_map_loc=os.path.join(test, "speaker_map.json"))
    batch = SDCollater()([ds[i] for i in ref.FEATURE_ITEMS])
    if batch["audio_lens"].tolist() != fx["features"]["audio_lens"]:
        fail(f"sd_baseline_1x: the test samples' lengths {batch['audio_lens'].tolist()} are "
             f"not the fixture's {fx['features']['audio_lens']}")
    want_emb, want_ids = arrays["features/emb"], arrays["features/ids"]
    gap, want_pad = arrays["features/top2_gap"], arrays["features/pad"]
    feats = {}
    for name, dtype in (("f32", f32), ("bf16", torch.bfloat16)):
        system = SDSystem(SDModelConfig(dropout=0.0), TrainConfig(**ref.TRAIN_CFG),
                          specaug_cfg=no_aug, compute_dtype=dtype, device=dev)
        system.load_params(tree)
        emb, ids, pad = system.frame_features(batch["audio"], batch["audio_lens"])
        real = ~want_pad
        rec = {"pad_equal": bool(np.array_equal(pad, want_pad)),
               "frames": int(real.sum()),
               "argmax_share": float((ids == want_ids)[real].mean()),
               "max_abs_err": float(np.abs(emb - want_emb).max())}
        if name == "f32":
            parted = (ids != want_ids) & real
            rec["argmax_parted"] = int(parted.sum())
            rec["argmax_parted_ties"] = int((parted & (gap < SD_TIE_GAP)).sum())
        feats[name] = rec
        del system
    out["features"] = feats
    torch.cuda.empty_cache()

    # ---- (b) training parity ------------------------------------------------------
    train8 = os.path.join(base, "train8")
    build_synth_corpus(train8, **ref.TRAIN_SPLIT)
    tr = SDUtteranceDataset(train8, speaker_map_loc=os.path.join(train8, "speaker_map.json"),
                            max_segment_duration=ref.TRAIN_MAX_SECS)
    tb = SDCollater(audio_bucket_seconds=(ref.TRAIN_MAX_SECS,))(
        [tr[i] for i in range(ref.TRAIN_ITEMS)])
    system = SDSystem(SDModelConfig(dropout=0.0), TrainConfig(**ref.TRAIN_CFG),
                      specaug_cfg=no_aug, compute_dtype=f32, device=dev)
    system.load_params(tree)
    losses = [float(system.train_step(tb)["loss"]) for _ in range(ref.TRAIN_STEPS)]
    want = fx["train"]["losses"]
    out["train_parity"] = {"losses": losses, "jax_losses": want,
                           "max_rel_err": max(abs(a - b) / abs(b) for a, b in zip(losses, want))}
    del system
    torch.cuda.empty_cache()

    # ---- (c) the training CLI -------------------------------------------------------
    counters = {"fused_logmel_project": fused_logmel_project, "spec_augment": spec_augment}
    shapes, restore = counted_steps(torch, SDSystem, counters)
    ckpts = os.path.join(base, "ckpts")
    argv = ["--train-data", train8, "--valid-data", train8, "--name", "sd",
            "--checkpoint-path", ckpts, "--max-steps", str(SD_CLI_STEPS), "--device", dev]
    try:
        # The main path's run: counts set to 0 just before it, read just after.
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = cli_train_sd.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        restore()
    out["cli"] = {"argv": argv[4:], "steps": res["steps"], "seconds": secs,
                  "ms_per_step": 1e3 * secs / res["steps"], "losses": res["losses"],
                  "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                  "launches": launches, "by_shape": shapes,
                  "checkpoints": len(res["paths"])}
    sd_ckpt = res["paths"][-1]
    del res
    torch.cuda.empty_cache()
    if trace:
        profile_call(torch, "sd_baseline_1x:cli.train_sd (5 steps)", cli_train_sd.main,
                     (["--train-data", train8, "--valid-data", train8, "--name", "sd_traced",
                       "--checkpoint-path", ckpts, "--max-steps", "5", "--device", dev],))

    # ---- (d) the reconciliation chain ------------------------------------------------
    system = SDSystem(SDModelConfig(), device=dev)
    system.load_params(load_pytree(sd_ckpt))
    transcripts = load_transcripts(test)
    dumps = os.path.join(base, "dump")
    dump_shapes = {}
    fused_logmel_project.launches = 0
    for stub, utts in sorted(transcripts.items()):
        audio = load_audio_segment(os.path.join(test, stub + ".wav"))
        before = fused_logmel_project.launches
        dump_episode_features(system, audio, utts, dumps, stub)
        key = f"1x{len(audio)}"
        dump_shapes[key] = dump_shapes.get(key, 0) + fused_logmel_project.launches - before
    del system
    torch.cuda.empty_cache()
    first = sorted(transcripts)[0]
    one = os.path.join(base, "one_episode")
    os.makedirs(one, exist_ok=True)
    shutil.copy(os.path.join(test, first + ".wav"), one)
    shutil.copy(os.path.join(test, "speaker_map.json"), one)
    with open(os.path.join(one, "transcript.pkl"), "wb") as f:
        pickle.dump({first: transcripts[first]}, f)
    bpe = os.path.join(root, "accuracy_release", "bpe.model")
    ckpt = os.path.join(root, "accuracy_release", "avg_last_3.bf16.msgpack")
    eval_out = os.path.join(base, "eval")
    argv = ["--train-data", one, "--valid-data", one, "--test-data", one, "--tokenizer", bpe,
            "--model-type", "1x", "--num-speakers", "8", "--load", ckpt, "--out-dir", eval_out,
            "--unaligned", "--fused-decode", "--device", dev]
    _, eval_s, rec = run_eval_counted(torch, argv, {"fused_layer_step": fused_layer_step,
                                                    "fused_logmel_project": fused_logmel_project})
    test_result = os.path.join(eval_out, "test_result.pkl")
    feats_path = os.path.join(dumps, f"{first}.sd_features.npy")
    ready = os.path.join(base, "wder_ready_sd.pkl")
    cli_tools.main(["wder-format", "--test-result", test_result, "--out", ready,
                    "--sd-features", feats_path, "--device", dev])
    sd_feats = np.load(feats_path)
    w_gap, n_utts = window_gap(test_result, ready, sd_feats)
    wder_argv = ["--workers", "1", "--device", dev]
    cluster_argv = ["--cluster", "--cluster-method", "agglomerative", "--metric", "cos_dist"]
    fields = cli_wder.main(["--eval-file", ready] + wder_argv)
    # --sd-features gives each utterance its tokens' window embeddings
    # [n_tok, 128]; the clustering stacks one row an utterance and raises on
    # them, as the JAX package's does (ROADMAP C27)
    try:
        cli_wder.main(["--eval-file", ready] + wder_argv + cluster_argv)
        cluster_raises = None
    except ValueError as e:
        cluster_raises = str(e)[:120]
    with open(test_result, "rb") as f:
        results = pickle.load(f)
    sd_ids = np.load(os.path.join(dumps, f"{first}.sd_ids.npy"))
    merged = [(convert_results([(refs, [])])[0][0],
               merge_asr_sd(hyp_times(hyps), sd_ids, sd_feats)) for refs, hyps in results]
    merged_ready = os.path.join(base, "wder_ready_merged.pkl")
    with open(merged_ready, "wb") as f:
        pickle.dump(merged, f)
    m_ids = cli_wder.main(["--eval-file", merged_ready] + wder_argv)
    m_cl = cli_wder.main(["--eval-file", merged_ready] + wder_argv + cluster_argv)
    with open(os.path.join(dumps, f"{first}.gold_speakers.pkl"), "rb") as f:
        gold = pickle.load(f)
    out["chain"] = {
        "sd_checkpoint": os.path.relpath(sd_ckpt, out_dir), "episodes": len(transcripts),
        "dump_k2_launches_by_shape": dump_shapes, "sd_frames": int(len(sd_feats)),
        "gold_frames_known": int(sum(g != -1 for g in gold)),
        "eval_seconds": eval_s, "launches": rec["launches"],
        "decode_steps": rec["decode_steps"], "hyp_utterances": n_utts,
        "window_embed_gap": w_gap,
        "sd_format_wder_pct": 100 * fields["overall_wder"],
        "sd_format_wer_pct": 100 * fields["overall_wer"],
        "sd_format_cluster_raises": cluster_raises,
        "merge_wder_pct": 100 * m_ids["overall_wder"],
        "merge_cluster_wder_pct": 100 * m_cl["overall_wder"],
        "merge_wer_pct": 100 * m_ids["overall_wer"],
        "merge_sd_speakers": len({s for _, (_, s), _ in merged[0][1]})}
    emit(out)

    problems = []
    fe = out["features"]
    if not fe["f32"]["pad_equal"] or not fe["bf16"]["pad_equal"]:
        problems.append("the padding mask differs from JAX's")
    if fe["f32"]["max_abs_err"] > SD_FEATURE_TOL:
        problems.append(f"f32 embeddings {fe['f32']['max_abs_err']} from JAX's (> {SD_FEATURE_TOL})")
    if fe["f32"]["argmax_parted"] != fe["f32"]["argmax_parted_ties"]:
        problems.append(f"f32 argmax parts from JAX's on {fe['f32']['argmax_parted']} frames, "
                        f"{fe['f32']['argmax_parted_ties']} of them near-ties")
    if fe["bf16"]["argmax_share"] < SD_ARGMAX_SHARE:
        problems.append(f"bf16 argmax agreement {fe['bf16']['argmax_share']} < {SD_ARGMAX_SHARE}")
    if out["train_parity"]["max_rel_err"] > SD_LOSS_TOL:
        problems.append(f"f32 LAMB losses {out['train_parity']['max_rel_err']} (relative) from "
                        f"JAX's (> {SD_LOSS_TOL})")
    cl = out["cli"]
    if cl["steps"] != SD_CLI_STEPS or not np.isfinite(cl["losses"]).all() \
            or not cl["losses"][-1] < cl["losses"][0]:
        problems.append(f"cli.train_sd: {cl['steps']} steps, losses {cl['losses']}")
    if min(cl["launches"].values()) <= 0:
        problems.append(f"cli.train_sd launched a kernel no time: {cl['launches']}")
    ch = out["chain"]
    if not w_gap <= SD_WINDOW_TOL or n_utts == 0:
        problems.append(f"window embeddings {w_gap} from the host einsum over {n_utts} "
                        f"utterances (> {SD_WINDOW_TOL})")
    for k in ("sd_format_wder_pct", "sd_format_wer_pct", "merge_wder_pct",
              "merge_cluster_wder_pct", "merge_wer_pct"):
        if not np.isfinite(ch[k]):
            problems.append(f"{k} = {ch[k]}")
    if ch["sd_format_cluster_raises"] is None:
        problems.append("cli.wder --cluster took per-token window embeddings (C27)")
    if problems:
        fail("sd_baseline_1x: " + "; ".join(problems))
    return out


def sd_entries(sd, k1_sm, k2_sm_one, k2_cli):
    """The speaker baseline's kernels: K2 and K4 in cli.train_sd's run (by
    batch shape: `k2_cli` "BxT" -> (K2 record, K4 record)), K2 in the
    episode dump and K1 and K2 in the chain's eval CLI run (one episode: the
    state machine at B = 1, N = 18001)."""
    entries = []
    for shape, n in sd["cli"]["by_shape"].items():
        k2_rec, k4_rec = k2_cli[shape]
        entries.append(kernel_entry(f"sd_baseline_1x:train_sd:{shape}", k2_rec,
                                    n["fused_logmel_project"], k2_rec["max_abs_err"]))
        entries.append(kernel_entry(f"sd_baseline_1x:train_sd:{shape}", k4_rec,
                                    n["spec_augment"], k4_rec["max_abs_err"]))
    ch = sd["chain"]
    for shape, n in ch["dump_k2_launches_by_shape"].items():
        entries.append(kernel_entry(f"sd_baseline_1x:dump:{shape}", k2_sm_one, n,
                                    k2_sm_one["max_abs_err"]))
    entries += [kernel_entry("sd_baseline_1x:eval", k1_sm, ch["launches"]["fused_layer_step"],
                             k1_sm["max_abs_err"]["x_out"], "none"),
                kernel_entry("sd_baseline_1x:eval", k2_sm_one,
                             ch["launches"]["fused_logmel_project"], k2_sm_one["max_abs_err"])]
    return entries


# ---------------------------------------------------------------------------
# Phase 14: the neural SAD (PyanNet)
# ---------------------------------------------------------------------------
SAD_FIXTURE = os.path.join("tests", "fixtures", "torch_sad_reference.json")
SAD_ARRAYS = os.path.join("tests", "fixtures", "torch_sad_reference_arrays.npz")
SAD_SCORE_TOL = 1e-4                  # episode scores against the JAX CPU reference's
SAD_LOSS_TOL = 1e-3                   # Adam losses against JAX's, of the run's first loss
SAD_CLI_STEPS = 500                   # scripts/sad_stress.sh's
SAD_F1_MIN = 90.0
SAD_JAX_F1 = 99.13                    # ACCURACY.json sad_stress_f1_pct (JAX on the CPU, its init)


def run_sad_1x(torch, dev, root, out_dir, card):
    """The neural SAD on the card (scripts/sad_stress.sh's chain). (a) The
    stress corpus through `cli.tools synth-sad-stress` (train 6 x 90 s seed
    0, test 3 x 90 s seed 99): every file's sha256 against the JAX
    reference's (SAD_FIXTURE). (b) `score_episode` of the seeded tree
    (scripts/torch_sad_reference.py `seeded_pyannet_tree`) on the test
    split's first episode against JAX's scores. (c) 25 f32 Adam steps from
    that tree on default_rng(0)'s batches against JAX's losses: Adam
    amplifies rounding step by step (the fixture's one-ulp twin of JAX's own
    run parts from it; ROADMAP C24), so each step's loss is held within
    SAD_LOSS_TOL of the run's first loss, and its relative gap printed. (d)
    `python -m tal_asrd_tpu_torch.cli.sad --steps 500` from the port's own
    initial draw, with no hand-written kernel launched (PyanNet has none):
    s a step, precision / recall / F1, beside the JAX CPU record; then
    --load of the written pyannet.msgpack gives the same bounds."""
    from tal_asrd_tpu_torch.cli import sad as cli_sad
    from tal_asrd_tpu_torch.cli import tools as cli_tools
    from tal_asrd_tpu_torch.data.audio_io import load_audio_segment
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_decode_stacked import stacked_decoder_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.ops.specaug import spec_augment
    from tal_asrd_tpu_torch.vad.pyannet import FRAME_HOP, load_pyannet, score_episode

    ref = reference_script(root, "torch_sad_reference")
    with open(os.path.join(root, SAD_FIXTURE)) as f:
        fx = json.load(f)
    arrays = np.load(os.path.join(root, SAD_ARRAYS))
    base = os.path.join(out_dir, "sad")
    out = {"phase": "sad_1x", "card": card}

    # ---- (a) the stress corpus ------------------------------------------------------
    splits = {}
    t0 = time.perf_counter()
    for name, kw in ref.SPLITS.items():
        splits[name] = os.path.join(base, name)
        cli_tools.main(["synth-sad-stress", "--out-dir", splits[name], "--episodes",
                        str(kw["n_episodes"]), "--episode-seconds", str(kw["episode_seconds"]),
                        "--seed", str(kw["seed"])])
    hashes = {name: ref.file_hashes(path) for name, path in splits.items()}
    out["corpus"] = {"seconds": time.perf_counter() - t0,
                     "files": sum(len(h) for h in hashes.values()),
                     "sha256_equal": hashes == fx["corpus"]["sha256"]}

    # ---- (b) episode scores ---------------------------------------------------------------
    tree = ref.seeded_pyannet_tree()
    model = load_pyannet(tree, dev)
    wav = np.asarray(load_audio_segment(os.path.join(splits["test"], "ep0.wav")), np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = score_episode(model, wav, window_s=ref.WINDOW_S, batch=ref.SCORE_BATCH)
    torch.cuda.synchronize()
    want = arrays["scores/ep0"]
    out["scores"] = {"frames": int(len(scores)), "seconds": time.perf_counter() - t0,
                     "max_abs_err": float(np.abs(scores - want).max())
                     if scores.shape == want.shape else float("inf")}

    # ---- (c) training parity --------------------------------------------------------------
    train = cli_sad.load_split(splits["train"])
    model = load_pyannet(tree, dev)
    losses = cli_sad.train_steps(model, train, ref.TRAIN_STEPS, ref.TRAIN_BATCH,
                                 fx["train"]["window_samples"], ref.TRAIN_LR, ref.TRAIN_SEED,
                                 log=lambda _: None)
    jl, twin = fx["train"]["losses"], fx["train"]["twin_losses"]
    out["train_parity"] = {
        "losses": losses, "jax_losses": jl,
        "rel_err": [abs(a - b) / b for a, b in zip(losses, jl)],
        "twin_rel_err": [abs(a - b) / b for a, b in zip(twin, jl)],
        "max_err_of_first_loss": max(abs(a - b) for a, b in zip(losses, jl)) / jl[0]}
    del model

    # ---- (d) the CLI --------------------------------------------------------------------------
    counters = {"fused_layer_step": fused_layer_step, "stacked_decoder_step": stacked_decoder_step,
                "fused_logmel_project": fused_logmel_project, "spec_augment": spec_augment}
    real_steps, timed = cli_sad.train_steps, {}

    def timed_steps(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_steps(*args, **kwargs)
        torch.cuda.synchronize()
        timed["seconds"] = time.perf_counter() - t
        return res
    cli_sad.train_steps = timed_steps
    runs = {}
    try:
        for fn in counters.values():
            fn.launches = 0
        for name, extra in (("trained", ["--steps", str(SAD_CLI_STEPS)]),
                            ("loaded", ["--load", os.path.join(base, "trained",
                                                               "pyannet.msgpack")])):
            o = os.path.join(base, name)
            t0 = time.perf_counter()
            res = cli_sad.main(["--train-data", splits["train"], "--test-data", splits["test"],
                                "--out-dir", o, "--json-out", o + ".json", "--device", dev]
                               + extra)
            torch.cuda.synchronize()
            runs[name] = {"seconds": time.perf_counter() - t0, "metrics": res["metrics"],
                          "bounds": res["bounds"], "losses": res["losses"]}
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        cli_sad.train_steps = real_steps
    tr = runs["trained"]
    out["cli"] = {"steps": SAD_CLI_STEPS, "seconds": tr["seconds"],
                  "train_seconds": timed["seconds"],
                  "s_per_step": timed["seconds"] / SAD_CLI_STEPS,
                  "first_loss": tr["losses"][0], "last_loss": tr["losses"][-1],
                  "metrics": tr["metrics"], "jax_cpu_sad_stress_f1_pct": SAD_JAX_F1,
                  "regions": sum(len(b) for b in tr["bounds"].values()),
                  "load_seconds": runs["loaded"]["seconds"],
                  "load_bounds_equal": runs["loaded"]["bounds"] == tr["bounds"],
                  "load_metrics_equal": runs["loaded"]["metrics"] == tr["metrics"],
                  "kernel_launches": launches, "frame_hop": FRAME_HOP}
    emit(out)

    problems = []
    if not out["corpus"]["sha256_equal"]:
        problems.append("the stress corpus's files differ from JAX's")
    if not out["scores"]["max_abs_err"] <= SAD_SCORE_TOL:
        problems.append(f"scores {out['scores']['max_abs_err']} from JAX's (> {SAD_SCORE_TOL})")
    if not out["train_parity"]["max_err_of_first_loss"] <= SAD_LOSS_TOL:
        problems.append(f"Adam losses {out['train_parity']['max_err_of_first_loss']} of the "
                        f"first loss from JAX's (> {SAD_LOSS_TOL})")
    cl = out["cli"]
    if not cl["metrics"] or cl["metrics"]["sad_f1_pct"] < SAD_F1_MIN:
        problems.append(f"cli.sad F1 {cl['metrics']} < {SAD_F1_MIN}")
    if not (cl["load_bounds_equal"] and cl["load_metrics_equal"]):
        problems.append("cli.sad --load of its own pyannet.msgpack gives other bounds")
    if any(launches.values()):
        problems.append(f"PyanNet launched a hand-written kernel: {launches}")
    if problems:
        fail("sad_1x: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# Phase 15: first diarization (UIS-RNN, wav2vec, diar-features)
# ---------------------------------------------------------------------------
DIAR_FIXTURE = os.path.join("tests", "fixtures", "torch_diar_reference.json")
DIAR_ARRAYS = os.path.join("tests", "fixtures", "torch_diar_reference_arrays.npz")
DIAR_CKPT = os.path.join("tests", "fixtures", "torch_diar_reference_uisrnn.msgpack")
DIAR_FEATURE_TOL = 1e-4               # logmel features against the JAX CLI's pickles
DIAR_W2V_TOL = 1e-4                   # wav2vec features, of the largest, against JAX's
DIAR_STEP_TOL = 1e-4                  # a fit step's loss, gradients, moments and leaves
                                      # (cuDNN's GRU sums in its own order: the f64 witness)
DIAR_STREAM_ITERS = 20                # --mode stream: fit iterations a batch of files
DIAR_PROFILE_ITERS = 20               # the traced window: fit steps, then the first
DIAR_PROFILE_OBS = 8                  # observations of one episode (the profiler's own
                                      # processing grows with its events: ~70 s at 67k)
DIAR_DEFAULT = dict(observation_dim=256, rnn_hidden_size=512)    # cli.uisrnn's defaults
DIAR_DEFAULT_STEPS = 20


def timed_calls(torch, owner, name, log):
    """Patch owner.name with a wrapper that appends (seconds, result) of each
    call, synchronised, to `log`; returns the original to restore."""
    real = getattr(owner, name)

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real(*a, **k)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t, res))
        return res
    setattr(owner, name, wrapper)
    return real


def run_diar_1x(torch, dev, root, out_dir, card):
    """First diarization on the card (scripts/uisrnn_der.sh's chain). (a)
    `cli.tools diar-features --features logmel` over the train split cut to
    its first 10 episodes: K2 one launch an episode, the features against
    the JAX CLI's pickles (DIAR_ARRAYS). (b) `--features wav2vec` at full
    width from the seeded fairseq state dict converted by the port, against
    JAX's pickle, and `extract_corpus_features` over the episode with no
    error. (c) The fixture's fit steps one at a time from JAX's states
    (loss, gradients, moments, leaves). (d) `predict_single` on JAX's
    trained tree (DIAR_CKPT): the traces equal. (e) `cli.uisrnn --mode
    kfold` at the script's flags on (a)'s pickles, from the port's own
    initial draws: the DER within the band of JAX's two seeds; seconds, ms a
    fit step, GRU steps a predicted observation. (f) A traced window (fit
    steps, then part of one episode's prediction): the device's idle
    share. (g)
    `--mode stream`, stopped after its first batch and resumed. (h) fit and
    predict at the CLI's default width (obs 256, hidden 512), timed."""
    from tal_asrd_tpu_torch.cli import tools as cli_tools
    from tal_asrd_tpu_torch.cli import uisrnn as cli_uisrnn
    from tal_asrd_tpu_torch.core.checkpoint import save_pytree
    from tal_asrd_tpu_torch.core.config import FrontendConfig
    from tal_asrd_tpu_torch.data.audio_io import load_audio_segment
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.diarization import uisrnn, wav2vec
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_decode_stacked import stacked_decoder_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.ops.specaug import spec_augment

    ref = reference_script(root, "torch_diar_reference")
    with open(os.path.join(root, DIAR_FIXTURE)) as f:
        fx = json.load(f)
    arrays = np.load(os.path.join(root, DIAR_ARRAYS))
    base = os.path.join(out_dir, "diar")
    out = {"phase": "diar_1x", "card": card, "split": ref.SPLIT_NOTE}
    counters = {"fused_layer_step": fused_layer_step, "stacked_decoder_step": stacked_decoder_step,
                "fused_logmel_project": fused_logmel_project, "spec_augment": spec_augment}
    problems, stamps = [], {}

    # ---- (a) diar-features --features logmel ---------------------------------------
    stamps["features"] = time.perf_counter()
    split = os.path.join(base, "split")
    t0 = time.perf_counter()
    build_synth_corpus(split, **ref.SPLIT)
    synth_s = time.perf_counter() - t0
    feat_dir = os.path.join(base, "diarfeat")
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_tools.main(["diar-features", "--data", split, "--out-dir", feat_dir, "--device", dev])
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    ids, errs, rows = fx["features"]["ids"], [], 0
    for i in range(ref.SPLIT["n_episodes"]):
        with open(os.path.join(feat_dir, f"ep{i}.pkl"), "rb") as f:
            got, got_ids = pickle.load(f)
        want = arrays[f"features/ep{i}"]
        errs.append(float(np.abs(got - want).max()) if got.shape == want.shape
                    and got_ids == ids[f"ep{i}"] else float("inf"))
        rows += len(got_ids)
    # K2 at the largest episode's rows, as diar-features stacks them
    with open(os.path.join(split, "transcript.pkl"), "rb") as f:
        transcripts = pickle.load(f)
    sizes = {}
    for stub, utts in transcripts.items():
        audios = [load_audio_segment(os.path.join(split, stub + ".wav"), u["utterance_start"],
                                     u["utterance_end"]) for u in utts]
        sizes[stub] = [a for a in audios if len(a) >= 400]
    biggest = max(sizes, key=lambda k: sum(len(a) for a in sizes[k]))
    power = cli_tools.utterance_power(sizes[biggest], FrontendConfig(mean_subtract=False), dev)
    k2 = check_logmel(torch, dev, 1, power=power)
    out["features"] = {"synth_seconds": synth_s, "seconds": feat_s, "episodes": len(errs),
                       "utterances": rows, "max_abs_err": max(errs), "by_episode": errs,
                       "launches": launches, "k2_rows_timed": int(power.shape[0]),
                       "k2_episode_timed": biggest}
    if not max(errs) <= DIAR_FEATURE_TOL:
        problems.append(f"logmel features {max(errs)} from JAX's (> {DIAR_FEATURE_TOL})")
    if launches["fused_logmel_project"] != ref.SPLIT["n_episodes"]:
        problems.append(f"diar-features launched K2 {launches['fused_logmel_project']} times "
                        f"(one an episode: {ref.SPLIT['n_episodes']})")

    # ---- (b) wav2vec ---------------------------------------------------------------------
    stamps["wav2vec"] = time.perf_counter()
    split1 = os.path.join(base, "split1")
    build_synth_corpus(split1, **dict(ref.SPLIT, n_episodes=1))
    _, variables = wav2vec.init_wav2vec(device="cpu")
    tree = wav2vec.convert_fairseq_weights(ref.seeded_fairseq_state_dict(), variables)
    ckpt = os.path.join(base, "w2v.msgpack")
    save_pytree(ckpt, tree)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_tools.main(["diar-features", "--data", split1, "--out-dir", os.path.join(base, "w2v"),
                    "--features", "wav2vec", "--wav2vec-ckpt", ckpt, "--device", dev])
    torch.cuda.synchronize()
    w2v_s = time.perf_counter() - t0
    with open(os.path.join(base, "w2v", "ep0.pkl"), "rb") as f:
        got, got_ids = pickle.load(f)
    want = arrays["wav2vec/ep0"]
    w2v_err = (float(np.abs(got - want).max() / np.abs(want).max())
               if got.shape == want.shape and got_ids == fx["wav2vec"]["ids"] else float("inf"))
    with open(os.path.join(split1, "transcript.pkl"), "rb") as f:
        utts = pickle.load(f)["ep0"]
    items = [load_audio_segment(os.path.join(split1, "ep0.wav"), u["utterance_start"],
                                u["utterance_end"]) for u in utts]
    model = wav2vec.load_wav2vec(tree, dev)
    done, errors = wav2vec.extract_corpus_features(model, items, os.path.join(base, "w2v.pkl"))
    # the same features under PyTorch's default (cuDNN convolutions in TF32),
    # as diar-features runs outside this script: reported, not gated
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = np.stack([wav2vec.extract_utterance_features(model, a, window_s=None).mean(0)
                         for a in items if len(a) >= 400])
    finally:
        torch.backends.cudnn.allow_tf32 = False
    out["wav2vec"] = {"seconds": w2v_s, "utterances": len(got_ids), "max_rel_err": w2v_err,
                      "corpus_items": len(done), "corpus_errors": errors,
                      "windows": sum(len(v) for v in done.values()),
                      "tf32": "off (the script's setting)",
                      "max_rel_err_cudnn_tf32_on": float(np.abs(tf32 - want).max()
                                                         / np.abs(want).max())
                      if tf32.shape == want.shape else None}
    if not w2v_err <= DIAR_W2V_TOL:
        problems.append(f"wav2vec features {w2v_err} from JAX's (> {DIAR_W2V_TOL})")
    if errors or len(done) != len(items) or not all(np.isfinite(v).all() for v in done.values()):
        problems.append(f"extract_corpus_features on the card: errors {errors}")
    del model, variables, tree

    # ---- (c) fit steps one at a time along JAX's trajectory --------------------------------
    stamps["steps"] = time.perf_counter()
    # beside each step's f32 gradients, the same step's in float64 on the card
    # (nn.GRU's own kernels, not cuDNN's): how far each package's f32 sums lie
    # from them
    st = fx["steps"]
    step_model = uisrnn.UISRNN(uisrnn.UISRNNConfig(**st["cfg"]), device=dev)
    args = uisrnn.UISRNNTrainConfig(**st["train"])
    fit = uisrnn.FitStep(step_model, args)
    wide = uisrnn.UISRNN(uisrnn.UISRNNConfig(**st["cfg"]), device=dev)
    wide.core.double()
    wide.init_hidden, wide.sigma2 = wide.init_hidden.double(), wide.sigma2.double()
    fit64 = uisrnn.FitStep(wide, args)
    rel = lambda a, b: max(float(np.abs(w - b[p]).max() / np.abs(w).max())
                           for p, w in ref.leaves_of(a))
    gaps = []
    for i in range(st["count"]):
        state = {**{part: ref.unflat_tree(arrays, f"steps/state{i}/{part}")
                    for part in ("trainable", "mu", "nu")}, "count": st["counts"][i]}
        fit.set_state(state)
        fit64.set_state(state)
        x = torch.from_numpy(arrays[f"steps/{i}/x"]).to(dev)
        truth = torch.from_numpy(arrays[f"steps/{i}/truth"]).to(dev)
        loss, _, grads = fit.grads(x, truth)
        want_g = ref.unflat_tree(arrays, f"steps/{i}/grads")
        got_g = dict(ref.leaves_of(fit._tree(grads)))
        f64_g = fit64._tree(fit64.grads(x.double(), truth.double())[2])
        g_err = rel(want_g, got_g)
        f64_err = {"card_f32": rel(f64_g, got_g), "jax_f32": rel(f64_g, dict(ref.leaves_of(want_g)))}
        fit.update(grads)
        want = {**{part: ref.unflat_tree(arrays, f"steps/state{i + 1}/{part}")
                   for part in ("trainable", "mu", "nu")}, "count": st["counts"][i + 1]}
        gap = ref.step_gaps(want, fit.state(), args.learning_rate)
        gap.update(step=i, loss_rel_err=abs(float(loss) - st["losses"][i]) / st["losses"][i],
                   grad_rel_err=g_err, grad_rel_err_of_f64=f64_err)
        gaps.append(gap)
    worst = max(max(g["trainable"], g["mu"], g["nu"], g["loss_rel_err"], g["grad_rel_err"])
                for g in gaps)
    out["steps"] = {"cfg": st["cfg"], "by_step": gaps, "worst_rel_err": worst}
    if not worst <= DIAR_STEP_TOL or any(g["noise_abs"] > g["noise_bound"] for g in gaps):
        problems.append(f"fit steps from JAX's states: {gaps}")
    del fit, step_model, fit64, wide

    # ---- (d) traces on JAX's trained tree ------------------------------------------------------
    stamps["predict"] = time.perf_counter()
    pr = fx["predict"]
    pm = uisrnn.UISRNN(uisrnn.UISRNNConfig(**pr["cfg"]), device=dev)
    pm.load(os.path.join(root, DIAR_CKPT))
    traces, pred_s = {}, {}
    for i in pr["test_episodes"]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traces[f"ep{i}"] = pm.predict_single(arrays[f"features/ep{i}"],
                                             uisrnn.UISRNNInferenceConfig(**pr["infer"]))
        pred_s[f"ep{i}"] = time.perf_counter() - t0
    equal = traces == pr["traces"]
    out["predict"] = {"cfg": pr["cfg"], "traces_equal": equal, "seconds": pred_s,
                      "jax_cpu_seconds": pr["predict_seconds"],
                      **({} if equal else {"traces": traces, "jax_traces": pr["traces"]})}
    if not equal:
        problems.append("predict_single's traces on JAX's trained tree differ from JAX's")
    del pm

    # ---- (e) cli.uisrnn --mode kfold at the script's flags ------------------------------------
    stamps["kfold"] = time.perf_counter()
    kf = fx["kfold"]
    fits, steps_n = [], []
    real_fit = timed_calls(torch, uisrnn.UISRNN, "fit_concatenated", fits)
    real_step = uisrnn.UISRNN._step

    def counted_step(self, *a, **k):
        steps_n.append(1)
        return real_step(self, *a, **k)
    uisrnn.UISRNN._step = counted_step
    buf = io.StringIO()
    try:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_uisrnn.main(["--features", os.path.join(feat_dir, "*.pkl"), "--mode",
                                   "kfold", "--device", dev] + kf["flags"])
        torch.cuda.synchronize()
        kf_s = time.perf_counter() - t0
        kf_launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        uisrnn.UISRNN.fit_concatenated = real_fit
        uisrnn.UISRNN._step = real_step
    text = buf.getvalue()
    line = [ln for ln in text.splitlines() if ln.startswith("mean accuracy:")][-1]
    der = float(line.split("DER ")[1].rstrip(")"))
    jax_ders = [r["der"] for r in kf["runs"].values()]
    band = (min(jax_ders) - kf["der_spread"], max(jax_ders) + kf["der_spread"])
    iters = int(kf["flags"][kf["flags"].index("--train-iteration") + 1])
    fit_s = sum(t for t, _ in fits)
    observations = 2 * rows                      # every episode predicted once, test-iteration 2
    out["kfold"] = {"line": line, "der": der, "der_pct": 100 * der, "jax_ders": jax_ders,
                    "band": band, "seconds": kf_s, "fit_seconds": fit_s,
                    "ms_per_fit_step": 1e3 * fit_s / (len(fits) * iters),
                    "predict_seconds": kf_s - fit_s, "gru_steps": len(steps_n),
                    "gru_steps_per_observation": len(steps_n) / observations,
                    "ms_per_gru_step": 1e3 * (kf_s - fit_s) / max(len(steps_n), 1),
                    "jax_cpu_seconds": {s: r["seconds"] for s, r in kf["runs"].items()},
                    "launches": kf_launches}
    if not band[0] <= der <= band[1]:
        problems.append(f"cli.uisrnn DER {der} outside JAX's band {band}")

    # ---- (f) a traced window: fit steps, then part of one episode's prediction -------------
    stamps["profile"] = time.perf_counter()
    flags = dict(zip(kf["flags"][::2], kf["flags"][1::2]))
    cfg = uisrnn.UISRNNConfig(observation_dim=int(flags["--observation-dim"]),
                              rnn_hidden_size=int(flags["--rnn-hidden-size"]))
    infer = uisrnn.UISRNNInferenceConfig(beam_size=int(flags["--beam-size"]),
                                         look_ahead=int(flags["--look-ahead"]),
                                         test_iteration=int(flags["--test-iteration"]))
    eps = ref.load_episodes(arrays, ids)

    def window():
        m = uisrnn.UISRNN(cfg, seed=0, device=dev)
        m.fit([f for f, _ in eps[1:]], [s for _, s in eps[1:]],
              uisrnn.UISRNNTrainConfig(train_iteration=DIAR_PROFILE_ITERS,
                                       log_iter=DIAR_PROFILE_ITERS))
        m.predict_single(eps[0][0][:DIAR_PROFILE_OBS], infer)
    with contextlib.redirect_stdout(io.StringIO()):
        prof = profile_call(torch, "diar_1x: uisrnn fit + predict", window, ())
    out["profile"] = {k: prof[k] for k in ("wall_seconds_traced", "device_busy_seconds",
                                            "device_idle_share", "device_launches")}

    # ---- (g) --mode stream, stopped after its first batch and resumed --------------------------
    stamps["stream"] = time.perf_counter()
    stream_ckpt = os.path.join(base, "stream", "uisrnn.msgpack")
    shutil.rmtree(os.path.dirname(stream_ckpt), ignore_errors=True)
    argv = ["--features", os.path.join(feat_dir, "*.pkl"), "--mode", "stream",
            "--files-per-batch", "4", "--train-iteration", str(DIAR_STREAM_ITERS),
            "--checkpoint", stream_ckpt, "--device", dev] + kf["flags"][:4]
    real_fit, calls = uisrnn.UISRNN.fit, []

    def stop_after_one(self, *a, **k):
        if calls:
            raise KeyboardInterrupt
        calls.append(1)
        return real_fit(self, *a, **k)
    uisrnn.UISRNN.fit = stop_after_one
    stopped = False
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli_uisrnn.main(argv)
    except KeyboardInterrupt:
        stopped = True
    finally:
        uisrnn.UISRNN.fit = real_fit
    with open(stream_ckpt + ".progress") as f:
        after_stop = f.read()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_uisrnn.main(argv)
    torch.cuda.synchronize()
    with open(stream_ckpt + ".progress") as f:
        after_resume = f.read()
    reloaded = uisrnn.UISRNN(cfg, device=dev)
    reloaded.load(stream_ckpt)
    out["stream"] = {"stopped": stopped, "progress_after_stop": after_stop,
                     "progress_after_resume": after_resume,
                     "resumed": "resuming from batch 1" in buf.getvalue(),
                     "resume_seconds": time.perf_counter() - t0,
                     "transition_bias": reloaded.transition_bias}
    if not (stopped and after_stop == "1" and after_resume == "3" and out["stream"]["resumed"]):
        problems.append(f"--mode stream did not resume: {out['stream']}")

    # ---- (h) the CLI's default width ------------------------------------------------------------
    stamps["default_width"] = time.perf_counter()
    rng = np.random.default_rng(SEED)
    d = DIAR_DEFAULT["observation_dim"]
    centres = rng.standard_normal((4, d)) * 3
    seqs, labels = [], []
    for _ in range(8):
        lab = rng.integers(0, 4, 20)
        seqs.append(centres[lab] + 0.3 * rng.standard_normal((20, d)))
        labels.append([str(x) for x in lab])
    big = uisrnn.UISRNN(uisrnn.UISRNNConfig(**DIAR_DEFAULT), device=dev)
    big_fits, big_steps = [], []
    real_fit = timed_calls(torch, uisrnn.UISRNN, "fit_concatenated", big_fits)
    real_step = uisrnn.UISRNN._step

    def counted_big(self, *a, **k):
        big_steps.append(1)
        return real_step(self, *a, **k)
    uisrnn.UISRNN._step = counted_big
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            big.fit(seqs[1:], labels[1:], uisrnn.UISRNNTrainConfig(
                train_iteration=DIAR_DEFAULT_STEPS, log_iter=DIAR_DEFAULT_STEPS))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big.predict_single(seqs[0], uisrnn.UISRNNInferenceConfig())
        big_pred_s = time.perf_counter() - t0
    finally:
        uisrnn.UISRNN.fit_concatenated = real_fit
        uisrnn.UISRNN._step = real_step
    out["default_width"] = {"cfg": DIAR_DEFAULT, "fit_steps": DIAR_DEFAULT_STEPS,
                            "ms_per_fit_step": 1e3 * big_fits[0][0] / DIAR_DEFAULT_STEPS,
                            "predict_seconds": big_pred_s, "observations": len(seqs[0]),
                            "gru_steps": len(big_steps),
                            "ms_per_gru_step": 1e3 * big_pred_s / len(big_steps),
                            "beam": dataclasses.asdict(uisrnn.UISRNNInferenceConfig())}
    names, t_end = list(stamps), time.perf_counter()
    out["section_seconds"] = {n: (stamps[names[k + 1]] if k + 1 < len(names) else t_end)
                              - stamps[n] for k, n in enumerate(names)}
    emit(out)
    if problems:
        fail("diar_1x: " + "; ".join(problems))
    return out, k2


def diar_entries(dr, k2):
    """The diarization phase's kernel: K2 in diar-features' run (one launch
    an episode), held and timed at its largest episode's stacked rows."""
    return [kernel_entry("diar_1x:diar_features", k2,
                         dr["features"]["launches"]["fused_logmel_project"], k2["max_abs_err"])]


# ---------------------------------------------------------------------------
# Phase 16: forced alignment
# ---------------------------------------------------------------------------
ALIGN_FIXTURE = os.path.join("tests", "fixtures", "torch_align_reference.json")
ALIGN_ARRAYS = os.path.join("tests", "fixtures", "torch_align_reference_arrays.npz")
ALIGN_ATTN_TOL = 1e-4                 # the f32 attention against the JAX CPU reference's
ALIGN_D_TOL = 1e-6                    # D of JAX's own cost on the card, of the largest
ALIGN_TIE_GAP = 1e-4                  # a backtrace parting at options closer than this: a tie
MFCC_TOL = 1e-5                       # MFCCs on the card against the port's on the CPU, of
                                      # the largest (f32 FFTs part in the bins of quiet frames)


def parting_gap(d, path_a, path_b):
    """Where two backtraces over D part (from the end), the gap between the
    D values each chose, over their size; 0 if they never part."""
    a, b = path_a[::-1], path_b[::-1]
    for pa, pb in zip(a[1:], b[1:]):
        if pa != pb:
            return abs(float(d[pa]) - float(d[pb])) / max(abs(float(d[pa])), 1e-30)
    return 0.0


def run_align_1x(torch, dev, root, out_dir, card):
    """Forced alignment on the card: `full_force_align` of the tracked
    checkpoint in f32 over the test split's utterances of at most 30 s
    (K2 in each utterance's encode, the teacher-forced decode, the DTW's
    wavefront), with no utterance failed (the reference's `align_episode`
    prints a failure and goes on: the phase records them), the fixture's
    utterances against JAX's alignments (equal, or a witnessed DTW tie),
    JAX's own cost through the card's DTW (D and path), a resumed run
    (every episode skipped), and MFCCs of the split's episodes (one K2
    launch) against the port's on the CPU. Times the DTW against the
    attention matrix, utterance by utterance."""
    from tal_asrd_tpu_torch.align import dtw, forced
    from tal_asrd_tpu_torch.align.mfcc import mfcc
    from tal_asrd_tpu_torch.data.audio_io import load_audio_segment
    from tal_asrd_tpu_torch.data.transcript import load_transcripts
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_decode_stacked import stacked_decoder_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.ops.specaug import spec_augment
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

    with open(os.path.join(root, ALIGN_FIXTURE)) as f:
        fx = json.load(f)
    arrays = np.load(os.path.join(root, ALIGN_ARRAYS))
    split = eval_split_of(out_dir)
    tok = BpeTokenizer(model_path=os.path.join(root, fx["tokenizer"]))
    model = tracked_1x(torch, dev, root, torch.float32)
    out = {"phase": "align_1x", "card": card, "compute_dtype": "float32"}
    counters = {"fused_layer_step": fused_layer_step, "stacked_decoder_step": stacked_decoder_step,
                "fused_logmel_project": fused_logmel_project, "spec_augment": spec_augment}
    problems = []

    failures, attn_t, dtw_t = [], [], []
    real_align = forced.align_utterance

    def recording(*a, **k):
        try:
            return real_align(*a, **k)
        except Exception as e:
            failures.append(repr(e))
            raise
    forced.align_utterance = recording
    real_attn = timed_calls(torch, forced, "attention_alignment_matrix", attn_t)
    real_seg = timed_calls(torch, forced, "monotonic_segmentation", dtw_t)
    aligned_path = os.path.join(out_dir, "align", "transcript-aligned.pkl")
    os.makedirs(os.path.dirname(aligned_path), exist_ok=True)
    try:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = forced.full_force_align(model, tok, split, aligned_path)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        n_calls = len(attn_t)
        t0 = time.perf_counter()
        again = forced.full_force_align(model, tok, split, aligned_path)
        resume_s = time.perf_counter() - t0
        resumed_calls = len(attn_t) - n_calls
    finally:
        forced.align_utterance = real_align
        forced.attention_alignment_matrix = real_attn
        forced.monotonic_segmentation = real_seg
    utts = [u for us in load_transcripts(split).values() for u in us]
    in_range = [u for u in utts if 0 < u["utterance_end"] - u["utterance_start"] <= 30.0]
    words = sum(len(u["alignments"]) for us in done.values() for u in us)
    out["run"] = {"seconds": seconds, "episodes": len(done), "utterances": len(utts),
                  "aligned_utterances": n_calls, "utterances_at_most_30s": len(in_range),
                  "words": words, "failures": failures, "launches": launches,
                  "attention_ms": 1e3 * sum(t for t, _ in attn_t[:n_calls]) / n_calls,
                  "dtw_ms": 1e3 * sum(t for t, _ in dtw_t) / len(dtw_t),
                  "resume_seconds": resume_s, "resume_aligned": resumed_calls,
                  "resume_equal": again == done}
    if failures:
        problems.append(f"{len(failures)} utterances failed: {failures[:3]}")
    if n_calls != len(in_range) or launches["fused_logmel_project"] != n_calls:
        problems.append(f"aligned {n_calls} of {len(in_range)} utterances with "
                        f"{launches['fused_logmel_project']} K2 launches (one an utterance)")
    if resumed_calls or again != done:
        problems.append("the resumed run aligned again or wrote another file")

    # the fixture's utterances against JAX's
    rows, checks = fx["utterances"], []
    wav = os.path.join(split, "ep0.wav")
    for i, (u, want) in enumerate(zip(done["ep0"], rows)):
        audio = load_audio_segment(wav, u["utterance_start"], u["utterance_end"])
        attn = forced.attention_alignment_matrix(model, audio, want["token_ids"])
        got_al = [list(map(float, a[:2])) + [int(a[2])] for a in u["alignments"]]
        cost = -np.log(attn + 1e-8)
        d_port = dtw.dtw_cost_matrix(torch.from_numpy(cost).to(dev)).cpu().numpy()
        jax_cost = -np.log(arrays[f"attn/{i}"] + 1e-8)
        d_of_jax = dtw.dtw_cost_matrix(torch.from_numpy(jax_cost).to(dev)).cpu().numpy()
        want_d = arrays[f"d/{i}"]
        rec = {"utterance": i, "tokens": len(want["token_ids"]), "frames": int(attn.shape[1]),
               "attn_max_abs_err": float(np.abs(attn - arrays[f"attn/{i}"]).max()),
               "jax_cost_d_rel_err": float(np.abs(d_of_jax - want_d).max()
                                           / np.abs(want_d).max()),
               "jax_cost_path_equal": dtw.backtrace(d_of_jax) == dtw.backtrace(want_d),
               "alignments_equal": got_al == want["alignments"]}
        if not rec["alignments_equal"]:
            rec["tie_gap"] = parting_gap(d_port, dtw.backtrace(d_port), dtw.backtrace(want_d))
        checks.append(rec)
    out["fixture"] = checks
    for rec in checks:
        if not (rec["attn_max_abs_err"] <= ALIGN_ATTN_TOL
                and rec["jax_cost_d_rel_err"] <= ALIGN_D_TOL and rec["jax_cost_path_equal"]
                and (rec["alignments_equal"] or rec["tie_gap"] <= ALIGN_TIE_GAP)):
            problems.append(f"utterance {rec['utterance']} against JAX: {rec}")

    # MFCCs of the split's episodes (one K2 launch)
    waves = [load_audio_segment(os.path.join(split, f"ep{e}.wav"))
             for e in range(EVAL_SPLIT["n_episodes"])]
    audio = np.stack([w[:min(map(len, waves))] for w in waves]).astype(np.float32)
    fused_logmel_project.launches = 0
    x = torch.from_numpy(audio)
    got = mfcc(x.to(dev)).cpu().numpy()
    mfcc_launches = fused_logmel_project.launches
    want = mfcc(x).numpy()
    err = float(np.abs(got - want).max())
    out["mfcc"] = {"shape": list(got.shape), "max_abs_err": err,
                   "max_rel_err": err / float(np.abs(want).max()), "launches": mfcc_launches}
    if not out["mfcc"]["max_rel_err"] <= MFCC_TOL:
        problems.append(f"MFCCs {out['mfcc']['max_rel_err']} of the largest from the CPU's "
                        f"(> {MFCC_TOL})")
    emit(out)
    if problems:
        fail("align_1x: " + "; ".join(problems))
    # K2 at the longest aligned utterance, and at the MFCC batch
    longest = max(in_range, key=lambda u: u["utterance_end"] - u["utterance_start"])
    ep = [s for s, us in load_transcripts(split).items() if longest in us][0]
    one = load_audio_segment(os.path.join(split, f"{ep}.wav"), longest["utterance_start"],
                             longest["utterance_end"])
    k2_utt = check_logmel(torch, dev, 1, len(one), audio=torch.from_numpy(one[None]).to(dev))
    k2_mfcc = check_logmel(torch, dev, audio.shape[0], audio.shape[1],
                           audio=torch.from_numpy(audio).to(dev))
    return out, k2_utt, k2_mfcc


# ---------------------------------------------------------------------------
# Phase 17: RAdam, Adafactor and Lookahead on the tracked checkpoint (optim_1x)
# ---------------------------------------------------------------------------
OPTIM_FIXTURE = os.path.join("tests", "fixtures", "torch_optim_reference")
OPTIM_TOL = 1e-5
# the first 11 episodes of scripts/ensure_corpus.sh's train split (100 x 120 s,
# seed 0): 132 windows of 10-30 s, padded to the 30 s bucket, 8 batches of 16
OPTIM_SPLIT = dict(n_episodes=11, episode_seconds=120.0, n_speakers=8, seed=0)
OPTIM_STEPS, OPTIM_BATCH = 8, 16
# the card's configurations: the fixture's five, and LAMB for scale
OPTIM_CONFIGS = {"lamb": ["lamb", {"learning_rate": "schedule"}]}
# TrainConfig.lr of each training run (scaled by sqrt(16)): RAdam's first
# five steps are the reference's unrectified branch, plain SGD with momentum
# at lr, and at LAMB's 1e-4 the tracked checkpoint diverges within four
# steps (its ReZero scalars' gradients reach 425); at 1e-6 it does not
OPTIM_TRAIN_LR = {"radam": 1e-6, "lookahead_radam": 1e-6}
ROOFLINE_NEW = 64


def port_optimizer(name, kwargs, named, schedule):
    """The port's counterpart of a scripts/torch_optim_reference.py
    configuration (optax's keyword names; "schedule" for the system's)."""
    from tal_asrd_tpu_torch.train.optimizers import LAMB, Adafactor, Lookahead, RAdam
    kw = dict(kwargs)
    lr = schedule if kw.pop("learning_rate", None) == "schedule" else None
    if name == "lookahead":
        return Lookahead(port_optimizer(*kw.pop("inner"), named, schedule), **kw)
    if name == "adafactor":
        return Adafactor(named, lr, **kw)
    return {"radam": RAdam, "lamb": LAMB}[name](named, lr, **kw)


def replay_optim_fixture(torch, dev, root):
    """The JAX CPU trajectories of tests/fixtures/torch_optim_reference.*
    replayed with the port's optimizers on `dev`: the tracked checkpoint's
    six leaves, the same regenerated gradients, 8 steps of each
    configuration. Returns {configuration: (the largest error, its key)}
    over two kinds of error: a final leaf's or state leaf's over that
    leaf's largest magnitude in JAX's run (a sampled leaf: over its
    sample, and its sum of squares relative); and each step's update, the
    change the step made to a leaf against JAX's update at that step (on
    its sample), over JAX's largest update of the leaf at that step, less
    the float32 ulps of the parameter where the final add's rounding parts
    once the updates differ in their last bits (one; two for Lookahead,
    whose slow interpolation rounds too). The eight steps move a leaf by
    about 1e-4 of its largest value: the final values alone cannot show
    the update rule above float32's rounding, its updates do."""
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree, to_tensor, tree_from_leaves
    from tal_asrd_tpu_torch.core.convert import params_to_state_dict, unconvert_entry
    from tal_asrd_tpu_torch.train.schedules import linear_decay_schedule

    mod = reference_script(root, "torch_optim_reference")
    with open(os.path.join(root, OPTIM_FIXTURE + ".json")) as f:
        ref = json.load(f)
    arrays = np.load(os.path.join(root, OPTIM_FIXTURE + ".npz"))
    tree = load_pytree(os.path.join(root, ref["checkpoint"]))
    leaves = []
    for path in ref["leaves"]:
        node = tree
        for part in path.split("/"):
            node = node[part]
        leaves.append(to_tensor(node).float().numpy())

    def port_layout(path, x):
        ((name, t),) = params_to_state_dict(
            tree_from_leaves([(tuple(path.split("/")), x)])).items()
        return name, t.contiguous()

    grads = [[port_layout(p, g)[1].to(dev) for p, g in zip(ref["leaves"], mod.leaf_gradients(
        leaves, s))] for s in range(ref["steps"])]
    schedule = linear_decay_schedule(ref["schedule"]["scaled_lr"], ref["schedule"]["max_steps"])
    worst = {}
    for config, (name, kwargs) in ref["configs"].items():
        named = [(n, torch.nn.Parameter(t.to(dev))) for n, t in
                 (port_layout(p, x) for p, x in zip(ref["leaves"], leaves))]
        opt = port_optimizer(name, kwargs, named, schedule)
        n_ulps = 2.0 if name == "lookahead" else 1.0
        errs = []
        for s in range(ref["steps"]):
            for (_, prm), g in zip(named, grads[s]):
                prm.grad = g.clone()
            before = [prm.detach().clone() for _, prm in named]
            opt.step()
            for (n, prm), p0, path in zip(named, before, ref["leaves"]):
                key = f"{config}/updates/{path}"
                entry = ref["updates"][key]
                p0, p1 = (unconvert_entry(n, t)[1].cpu().numpy().reshape(-1)[::entry["stride"]]
                          for t in (p0, prm.detach()))
                diff = np.abs(p1.astype(np.float64) - p0 - arrays[key][s])
                excess = diff - n_ulps * np.spacing(np.maximum(np.abs(p0), np.abs(p1)))
                errs.append((float(np.max(excess.clip(min=0.0), initial=0.0))
                             / max(entry["max_abs"][s], 1e-30), f"{key}@{s + 1}"))
        got = {f"params/{'/'.join(unconvert_entry(n, prm)[0])}":
               unconvert_entry(n, prm.detach())[1].cpu().numpy() for n, prm in named}
        got.update({f"state/{k}": v for k, v in
                    mod.flat_state(opt.reference_state()).items()})
        for key, entry in ref["entries"].items():
            if not key.startswith(config + "/"):
                continue
            x = np.asarray(got[key[len(config) + 1:]])
            if "value" in entry:                  # counts
                errs.append((0.0 if int(x) == entry["value"] else float("inf"), key))
                continue
            want = arrays[key]
            if "stride" in entry:
                errs.append((abs(float(np.sum(np.square(x, dtype=np.float64)))
                                 - entry["sumsq"]) / max(entry["sumsq"], 1e-30), key + ":sumsq"))
                x = x.reshape(-1)[::entry["stride"]]
            errs.append((float(np.max(np.abs(x.astype(np.float64) - want), initial=0.0))
                         / max(entry["max_abs"], 1e-30), key))
        worst[config] = max(errs)
    return worst


def optim_train_batches(torch, dev, root, out_dir):
    """OPTIM_STEPS batches of OPTIM_BATCH windows of OPTIM_SPLIT (fixed
    windows, det_seed 1234, through the training CLI's collater at its 30 s
    bucket), on the card."""
    from tal_asrd_tpu_torch.data.collate import BucketedCollater
    from tal_asrd_tpu_torch.data.loader import DataLoader, ShardedSampler
    from tal_asrd_tpu_torch.data.segment import SegmentDataset
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

    split = os.path.join(out_dir, "optim_train")
    build_synth_corpus(split, **OPTIM_SPLIT)
    tokenizer = BpeTokenizer(model_path=os.path.join(root, "accuracy_release", "bpe.model"))
    ds = SegmentDataset(split, tokenizer, segment_size=30.0, tokenizer_speakers=True,
                        speaker_map_loc=os.path.join(split, "speaker_map.json"),
                        return_spk_ids=True, det_seed=1234)
    loader = DataLoader(ds, OPTIM_BATCH, BucketedCollater(tokenizer.pad_token_id),
                        ShardedSampler(len(ds), shuffle=False), 0)
    batches = []
    for batch in loader:
        batches.append({k: torch.as_tensor(v).to(dev) for k, v in batch.items()
                        if k in ("audio", "audio_lens", "text", "text_mask", "spk_ids")})
        if len(batches) == OPTIM_STEPS:
            break
    return batches, len(tokenizer)


def run_optim_1x(torch, dev, root, out_dir, card, k1_rec):
    """RAdam, Adafactor and Lookahead (A12.3) on the card. The fixture replay
    (`replay_optim_fixture`: final leaves and states within OPTIM_TOL of
    each leaf's largest magnitude in JAX's run, each step's update within
    OPTIM_TOL of JAX's largest update beside the parameter's ulps); then the tracked checkpoint in f32 parameters,
    bf16 compute, SpecAugment on, trained through `ASRSystem._make_optimizer`
    for OPTIM_STEPS steps with each configuration of the fixture and with
    LAMB, at `TrainConfig(batch_size=16, max_steps=8)`'s schedule (lr
    OPTIM_TRAIN_LR for RAdam's): each
    step's update held against the same optimizer stepped on the CPU from
    the card's parameters, gradients and state (gate: OPTIM_TOL of the
    leaf's largest update, beside one float32 ulp of the parameter, where
    the final add's rounding parts once the updates differ in their last
    bits; two for Lookahead, whose slow interpolation rounds too), every
    loss finite, every parameter given a gradient, each
    `step()` timed with `utils.profiling.StepTimer` and `sync`; one traced
    step through `utils.profiling.trace`; then the roofline leg: one fused
    greedy generate of the tracked checkpoint (bf16) at B = 8 windows of the
    test split, ROOFLINE_NEW tokens (K1, K2), beside `utils.flops`'
    `greedy_decode_flops` and `greedy_decode_roofline` at the H100's peaks
    (printed, not gated). Returns the record and the K2 / K4 checks at the
    training batches' shape."""
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree
    from tal_asrd_tpu_torch.core.config import ModelConfig, TrainConfig
    from tal_asrd_tpu_torch.core.convert import params_to_state_dict
    from tal_asrd_tpu_torch.data.audio_io import load_audio_segment
    from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, make_generate_fn
    from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.ops.specaug import spec_augment
    from tal_asrd_tpu_torch.train.system import ASRSystem
    from tal_asrd_tpu_torch.utils import flops as fl
    from tal_asrd_tpu_torch.utils.profiling import StepTimer, sync, trace

    t_phase = time.perf_counter()
    # ---- the fixture replay ------------------------------------------------------
    replay = replay_optim_fixture(torch, dev, root)
    emit({"phase": "optim_fixture_replay", "worst_rel_err": replay, "tolerance": OPTIM_TOL})
    if not max(err for err, _ in replay.values()) <= OPTIM_TOL:
        fail(f"optim_1x: the fixture replay parts from JAX's by {replay} (> {OPTIM_TOL})")
    with open(os.path.join(root, OPTIM_FIXTURE + ".json")) as f:
        configs = dict(OPTIM_CONFIGS, **json.load(f)["configs"])

    # ---- training ----------------------------------------------------------------
    batches, n_text = optim_train_batches(torch, dev, root, out_dir)
    cfg = ModelConfig(model_type="1x", num_speakers=8, vocab_size=n_text)
    tracked = params_to_state_dict(load_pytree(
        os.path.join(root, "accuracy_release", "avg_last_3.bf16.msgpack")))
    counters = {"fused_logmel_project": fused_logmel_project, "spec_augment": spec_augment}
    runs = {}
    for fn in counters.values():
        fn.launches = 0
    for config, (name, kwargs) in configs.items():
        class System(ASRSystem):
            def _make_optimizer(self):
                return port_optimizer(name, kwargs, self.model.named_parameters(),
                                      self._schedule())

        tc = TrainConfig(batch_size=OPTIM_BATCH, max_steps=OPTIM_STEPS,
                         lr=OPTIM_TRAIN_LR.get(config, 1e-4))
        system = System(cfg, tc, device=dev)
        system.model.load_state_dict(tracked)
        named = list(system.model.named_parameters())
        params = [p for _, p in named]
        timer = StepTimer(window=OPTIM_STEPS)
        losses, gaps, gaps_raw, no_grad, differing = [], [], [], set(), 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            metrics = system.compute_grads(batch)
            no_grad |= {n for n, p in named if p.grad is None}
            cpu_named = [(n, torch.nn.Parameter(p.detach().cpu())) for n, p in named]
            for (_, c), p in zip(cpu_named, params):
                c.grad = None if p.grad is None else p.grad.detach().cpu()
            twin = port_optimizer(name, kwargs, cpu_named, system._schedule())
            twin.copy_state_from(system.optimizer)
            before = [p.detach().clone() for p in params]
            sync(params)
            with timer:
                system.optimizer.step()
                sync(params)
            system.step += 1
            twin.step()
            gap = gap_raw = 0.0
            # roundings after the update that can part: the final add, and
            # for Lookahead also the slow interpolation (two ulps)
            n_ulps = 2.0 if name == "lookahead" else 1.0
            for p, p0, (_, c) in zip(params, before, cpu_named):
                c = c.detach()
                u_cpu = c - p0.cpu()
                diff = ((p.detach() - p0).cpu() - u_cpu).abs()
                ulp = n_ulps * (torch.nextafter(c.abs(), torch.tensor(float("inf"))) - c.abs())
                scale = max(float(u_cpu.abs().max()), 1e-30)
                gap = max(gap, float((diff - ulp).clamp_min(0.0).max()) / scale)
                gap_raw = max(gap_raw, float(diff.max()) / scale)
                differing += int((diff > 0).sum())
            gaps.append(gap)
            gaps_raw.append(gap_raw)
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        runs[config] = {
            "lr": tc.scaled_lr, "optimizer": type(system.optimizer).__name__ + (
                f"({type(system.optimizer.inner).__name__})"
                if hasattr(system.optimizer, "inner") else ""),
            "losses": losses, "update_count": system.update_count(),
            "step_ms": [1e3 * t for t in timer.times],
            "step_ms_mean_after_first": 1e3 * float(np.mean(list(timer.times)[1:])),
            "card_vs_cpu_update_gap": gaps, "card_vs_cpu_update_gap_raw": gaps_raw,
            "elements_differing": differing, "params_without_grad": sorted(no_grad),
            "seconds_with_checks": time.perf_counter() - t0}
        if name == "lamb":
            last_system = system
        else:
            del system
        torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in counters.items()}
    # one traced step (LAMB's system, a ninth step), its top device operations
    trace_dir = os.path.join(out_dir, "optim_trace")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(trace_dir) as prof:
        last_system.train_step(batches[0])
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in on_device) / 1e6
    top = sorted(on_device, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    traced = {"wall_seconds": traced_s, "device_busy_seconds": busy,
              "trace_bytes": os.path.getsize(os.path.join(trace_dir, "trace.json")),
              "top_device": [{"name": e.key[:60], "calls": e.count,
                              "ms": e.self_device_time_total / 1e3} for e in top]}
    del last_system
    torch.cuda.empty_cache()
    # K2 and K4 at the training batches' shape
    b, n = batches[0]["audio"].shape
    k2 = check_logmel(torch, dev, b, n)
    k4 = check_specaug(torch, dev, b, spec_in=torch.randn((b, 1 + n // 160, 80), device=dev))

    # ---- the roofline leg: one fused greedy generate through K1 -------------------
    model, _ = build_1x_checkpoint(torch, dev, root)
    split = eval_split_of(out_dir)
    audio = np.stack([load_audio_segment(os.path.join(split, f"ep{e}.wav"), start)[
        :WINDOW_SAMPLES] for e in range(4) for start in (10.0, 90.0)])
    lens = np.full((8,), WINDOW_SAMPLES, np.int64)
    prime = np.ones((8, 1), np.int64)
    spec = BeamSearchSpec(beam_size=1, max_new_tokens=ROOFLINE_NEW, eos_id=-1,
                          vocab_size=model.cfg.num_tokens,
                          text_vocab_size=model.cfg.vocab_size, force_output=True)
    gen = make_generate_fn(model, spec, decoder=FusedASRDecoder(model), device=dev)
    gen(audio, lens, prime)                          # warm-up
    counters["fused_layer_step"] = fused_layer_step
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = gen(audio, lens, prime)["tokens"]
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = {k: fn.launches for k, fn in counters.items()}
    del model, gen
    torch.cuda.empty_cache()
    roof = fl.greedy_decode_roofline(cfg, 8, WINDOW_SAMPLES, ROOFLINE_NEW)
    gen_flops = fl.greedy_decode_flops(cfg, 8, WINDOW_SAMPLES, ROOFLINE_NEW)
    roofline = {"batch": 8, "window_samples": WINDOW_SAMPLES, "new_tokens": ROOFLINE_NEW,
                "seconds": gen_s, "launches": gen_launches,
                "tokens_shape": list(tokens.shape),
                "greedy_decode_flops": gen_flops, "roofline": roof,
                "roofline_share_of_measured": roof["sol_secs"] / gen_s,
                "mfu_pct_bf16": 100.0 * gen_flops / (gen_s * fl.PEAK_FLOPS["bfloat16"]),
                "peaks": {"bytes_per_s": fl.PEAK_BYTES_PER_S, "flops": fl.PEAK_FLOPS}}

    out = {"phase": "optim_1x", "card": card, "fixture_replay": replay, "runs": runs,
           "train_launches": launches, "traced_step": traced,
           "k2": {k: k2[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                     "shape")},
           "k4": {k: k4[k] for k in ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                                     "where_ms", "shape")},
           "step_ms_vs_lamb": {c: r["step_ms_mean_after_first"] for c, r in runs.items()},
           "roofline_leg": roofline, "seconds": time.perf_counter() - t_phase}
    emit(out)
    n_steps = len(configs) * OPTIM_STEPS
    bad = {c: r for c, r in runs.items()
           if not all(np.isfinite(r["losses"])) or max(r["card_vs_cpu_update_gap"]) > OPTIM_TOL
           or r["params_without_grad"] or r["update_count"] != OPTIM_STEPS}
    if bad:
        fail(f"optim_1x: {sorted(bad)}: a loss not finite, a card update more than "
             f"{OPTIM_TOL} of its leaf's largest from the CPU's, a parameter without a "
             f"gradient or a wrong update count: "
             f"{ {c: (r['losses'], r['card_vs_cpu_update_gap']) for c, r in bad.items()} }")
    if launches != {"fused_logmel_project": n_steps, "spec_augment": n_steps}:
        fail(f"optim_1x: training launches {launches}, expected {n_steps} of K2 and K4")
    want_gen = {"fused_logmel_project": 1, "spec_augment": 0,
                "fused_layer_step": cfg.n_decoder_layers * ROOFLINE_NEW}
    if gen_launches != want_gen:
        fail(f"optim_1x: the generate's launches {gen_launches}, expected {want_gen}")
    return out, k2, k4


def optim_entries(op, k2, k4, k1_rec, k2_gen):
    """optim_1x's kernels: K2 and K4 in the training runs, K1 and K2 in the
    roofline leg's generate."""
    tl, gl = op["train_launches"], op["roofline_leg"]["launches"]
    return [kernel_entry("optim_1x:train", k2, tl["fused_logmel_project"], k2["max_abs_err"]),
            kernel_entry("optim_1x:train", k4, tl["spec_augment"], k4["max_abs_err"]),
            kernel_entry("optim_1x:roofline", k1_rec, gl["fused_layer_step"],
                         k1_rec["max_abs_err"]["x_out"], "none"),
            kernel_entry("optim_1x:roofline", k2_gen, gl["fused_logmel_project"],
                         k2_gen["max_abs_err"])]


def align_entries(al, k2_utt, k2_mfcc):
    """The alignment phase's kernels: K2 in full_force_align's run (one
    launch an utterance; held and timed at the longest) and in the MFCCs of
    the split's 4 episodes (one launch)."""
    return [kernel_entry("align_1x:full_force_align", k2_utt,
                         al["run"]["launches"]["fused_logmel_project"], k2_utt["max_abs_err"]),
            kernel_entry("align_1x:mfcc", k2_mfcc, al["mfcc"]["launches"],
                         k2_mfcc["max_abs_err"])]


def cluster_entries(cl, k1_rec, k2_eval):
    """The clustering chain's kernels: K1 and K2 in its eval CLI run (the
    eval_aligned_1x shapes)."""
    launches = cl["chain"]["launches"]
    return [kernel_entry("cluster_1x:eval", k1_rec, launches["fused_layer_step"],
                         k1_rec["max_abs_err"]["x_out"], "none"),
            kernel_entry("cluster_1x:eval", k2_eval, launches["fused_logmel_project"],
                         k2_eval["max_abs_err"])]


def noncausal_entries(nc, k2_eval, k2_beam_part, k2_sm_part):
    """The non-causal phase's kernels, each with its launches in one run: K2
    in the main run (N = 64064 / 54054) and in the two-shard bf16 runs
    (the whole batch on the first part's device and a part, N = 32032 beam,
    36002 state machine, on the other; held here at the part's N, the
    whole batch's N by eval_aligned_1x and eval_unaligned_1x). K1 is
    launched no time
    (run_noncausal_1x gates the zero)."""
    two = nc["sharded"]["bf16"]
    return [
        kernel_entry("noncausal_1x:main", k2_eval, nc["launches"]["fused_logmel_project"],
                     k2_eval["max_abs_err"]),
        kernel_entry("noncausal_1x:sharded_beam:2_shards", k2_beam_part,
                     two["beam"]["2_shards"]["k2_launches"], k2_beam_part["max_abs_err"]),
        kernel_entry("noncausal_1x:sharded_sm:2_shards", k2_sm_part,
                     two["sm"]["2_shards"]["k2_launches"], k2_sm_part["max_abs_err"])]


def embed_entries(em, k2_eval, k2_train8):
    """The embedding chain's kernels: K2 in the bf16 test-split export (N =
    64064 / 54054) and in the train-split export, by batch shape
    (`k2_train8`: "BxT" -> its record), each with the launches its batches
    made (read off the counter around each batch)."""
    g = em["gen_embed"]
    return [kernel_entry("embed_1x:gen_embed:test", k2_eval, g["card_bf16"]["k2_launches"],
                         k2_eval["max_abs_err"])] + [
        kernel_entry(f"embed_1x:gen_embed:train8:{shape}", k2_train8[shape], n,
                     k2_train8[shape]["max_abs_err"])
        for shape, n in g["train8_bf16"]["k2_launches_by_shape"].items()]


def kernel_entry(config, rec, launches_n, err, mode=None):
    """One record of the `kernels` line."""
    return {"name": rec["name"], "mode": mode or rec.get("mode", "none"),
            "config": config, "route": rec["route"], "source": rec["source"],
            "replaces": rec["replaces"], "launches": launches_n,
            "max_abs_err": err, "errors": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "eager_ms": rec.get("eager_ms"),
            "shape": rec.get("timed_shape", rec["shape"]), "dtype": rec["dtype"],
            **({"plan": rec["plan"]} if "plan" in rec else {})}


def unaligned_entries(runs, k1, k2):
    """The long-form path's kernels: per leg and run, K2 at its N and K1 at
    its shape, with their launches in that run (the VAD leg's split by
    bucket, read off the counters around each beam search)."""
    entries = []
    for name in ("unfused", "fused"):
        sm = runs[("sm", name)]
        entries.append(kernel_entry(f"eval_unaligned_1x:sm:{name}", k2["sm"],
                                    sm["launches"]["fused_logmel_project"],
                                    k2["sm"]["max_abs_err"]))
        if name == "fused":
            rec = k1[("sm", 1)]
            entries.append(kernel_entry("eval_unaligned_1x:sm:fused", rec,
                                        sm["launches"]["fused_layer_step"],
                                        rec["max_abs_err"]["x_out"], "none"))
        by_bucket = runs[("vad", name)]["by_bucket"]
        for secs, _, _, _ in VAD_SHAPES:
            got = by_bucket.get(secs)
            if got is None:          # no window of this bucket in the split
                continue
            entries.append(kernel_entry(f"eval_unaligned_1x:vad:{name}:{secs}s", k2[("vad", secs)],
                                        got["fused_logmel_project"],
                                        k2[("vad", secs)]["max_abs_err"]))
            if name == "fused":
                rec = k1[("vad", secs)]
                entries.append(kernel_entry(f"eval_unaligned_1x:vad:fused:{secs}s", rec,
                                            got["fused_layer_step"],
                                            rec["max_abs_err"]["x_out"], "none"))
    return entries


def serving_phases(torch, dev, root, args, k1, k2, checks, timed):
    """Phases 4-5: the serving path in every decoder configuration. Returns
    the launches per configuration and their `kernels` entries."""
    # ---- 4-5. the serving path --------------------------------------------------
    # Each configuration: greedy B=32 x 96 tokens (2x) / B=8 x 64 (1x) through
    # `make_generate_fn`, fused against unfused in lockstep, and beam 5 at B=8
    # (the kv8-only and w8-only configurations run greedy only).
    rng = np.random.default_rng(SEED)
    model_2x = build_2x(torch, dev)
    audio_2x = (rng.standard_normal((32, WINDOW_SAMPLES)) * 0.1).astype(np.float32)
    launches = {}
    for config, flags, beam_b in (
            ("2x", {}, 8),
            ("2x_kv8", {"kv8": True}, None),
            ("2x_w8", {"w8": True}, None),
            ("2x_kv8_w8", {"kv8": True, "w8": True}, 8),
            ("2x_stacked", {"stacked": True}, 8),
            ("2x_stacked_kv8_w8", {"stacked": True, "kv8": True, "w8": True}, 8)):
        launches[config] = serve(torch, dev, "serve_" + config, model_2x, audio_2x,
                                 max_new=96, greedy_b=32, beam_b=beam_b,
                                 trace=args.profile, **flags
                                 )["greedy"]["launches_per_generate"]
    del model_2x
    torch.cuda.empty_cache()

    model_1x, n_leaves = build_1x_checkpoint(torch, dev, root)
    if n_leaves != 151:
        fail(f"checkpoint: {n_leaves} leaves placed, expected 151")
    audio_1x = speechlike_audio(rng, 8, WINDOW_SAMPLES)
    for config, flags in (("1x", {}),
                          ("1x_stacked_kv8_w8", {"stacked": True, "kv8": True, "w8": True})):
        tag = "serve_1x_checkpoint" + config[2:]
        launches[config] = serve(torch, dev, tag, model_1x, audio_1x, max_new=64,
                                 greedy_b=8, beam_b=8, trace=args.profile, **flags
                                 )["greedy"]["launches_per_generate"]

    # every kernel of each configuration's path, with its launches in that
    # configuration's one timed fused greedy generate (counts zeroed just
    # before it)
    entries = []
    for config, kern, mode in (
            ("2x", "K1", "none"), ("1x", "K1", "none"),
            ("2x_kv8", "K1", "kv8"), ("2x_w8", "K1", "w8"), ("2x_kv8_w8", "K1", "kv8+w8"),
            ("2x_stacked", "K3", "none"), ("2x_stacked_kv8_w8", "K3", "kv8+w8"),
            ("1x_stacked_kv8_w8", "K3", "kv8+w8")):
        model = config[:2]
        if kern == "K1" and mode == "none":       # the records of phase 3
            rec = k1[model]
        else:
            rec = dict(checks[(model, kern, mode, "bfloat16")], **timed[(model, kern, mode)])
        entries.append(kernel_entry(config, rec, launches[config][rec["name"]],
                             rec["max_abs_err"]["x_out"], mode))
        entries.append(kernel_entry(config, k2[model], launches[config]["fused_logmel_project"],
                             k2[model]["max_abs_err"]))
    return launches, entries


# ---------------------------------------------------------------------------
# Phase 18: parallelism (parallel_1x)
# ---------------------------------------------------------------------------
PARALLEL_SPLITS = {"train": dict(n_episodes=6, episode_seconds=120.0, n_speakers=8, seed=0),
                   "valid": dict(n_episodes=1, episode_seconds=120.0, n_speakers=8, seed=101),
                   "cli_train": dict(n_episodes=2, episode_seconds=120.0, n_speakers=8, seed=0)}
PARALLEL_CLI_STEPS = 2
PARALLEL_MESHES = ((2, 1), (1, 2), (2, 2))
PARALLEL_STEPS, PARALLEL_BATCH = 4, 16
# N ranks against one on the same global batches, f32 compute, dropout 0
PARALLEL_LOSS_RTOL = 1e-4
PARALLEL_LEAF_ATOL = 1e-4
# the torchrun CLI leg against the CLI without it (bf16, dropout on, both
# fresh processes: the same draws; training on the card is not bitwise
# repeatable, and LAMB carries a rounding into steps of near-zero gradients)
PARALLEL_CLI_RTOL = 1e-3
PARALLEL_CLI_ATOL = 1e-3
PARALLEL_TINY = dict(model_type="1x", num_speakers=4, n_mels=8, vocab_size=32, n_head=2,
                     max_positions=64, dropout=0.0, embed_size=16, tds_depths=(1, 1, 1),
                     tds_kernel=5, tds_dropout=0.0)


def tiny_parallel_batch(seed, b=8, t=3200, l=12):
    """A seeded batch of the tiny configuration (numpy)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(l // 2, l + 1, b)
    return {"audio": (rng.randn(b, t) * 0.1).astype(np.float32),
            "audio_lens": rng.randint(t // 2, t + 1, b).astype(np.int32),
            "text": rng.randint(0, 36, (b, l)).astype(np.int32),
            "text_mask": np.arange(l)[None, :] < lens[:, None],
            "spk_ids": rng.randint(0, 4, (b, l)).astype(np.int32)}


def tree_gap(a, b, relative=False):
    """The largest absolute difference between two trees' float leaves
    (with `relative`, each leaf's over its largest magnitude in `b`)."""
    from tal_asrd_tpu_torch.core.checkpoint import tree_leaves
    b = dict(tree_leaves(b))
    gaps = []
    for p, v in tree_leaves(a):
        if np.asarray(v).dtype.kind != "f":
            continue
        w = np.asarray(b[p], np.float64)
        gap = float(np.abs(np.asarray(v, np.float64) - w).max(initial=0.0))
        gaps.append(gap / max(float(np.abs(w).max(initial=0.0)), 1e-30) if relative else gap)
    return max(gaps)


def parallel_batches(torch, root, split, n, b):
    """n batches of b windows of `split` (fixed windows, det_seed 1234,
    through the training CLI's collater at its 30 s bucket), numpy."""
    from tal_asrd_tpu_torch.data.collate import BucketedCollater
    from tal_asrd_tpu_torch.data.loader import DataLoader, ShardedSampler
    from tal_asrd_tpu_torch.data.segment import SegmentDataset
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
    tokenizer = BpeTokenizer(model_path=os.path.join(root, "accuracy_release", "bpe.model"))
    ds = SegmentDataset(split, tokenizer, segment_size=30.0, tokenizer_speakers=True,
                        speaker_map_loc=os.path.join(split, "speaker_map.json"),
                        return_spk_ids=True, det_seed=1234)
    loader = DataLoader(ds, b, BucketedCollater(tokenizer.pad_token_id, audio_int16=True),
                        ShardedSampler(len(ds), shuffle=False), 0)
    out = []
    for batch in loader:
        out.append({k: np.asarray(batch[k]) for k in
                    ("audio", "audio_lens", "text", "text_mask", "spk_ids")})
        if len(out) == n:
            return out
    fail(f"parallel_1x: {split} gives fewer than {n} batches of {b}")


def run_parallel_1x(torch, dev, root, out_dir, card):
    """Parallelism (A13) on the card. (a) `torchrun --nproc-per-node 1 -m
    tal_asrd_tpu_torch.cli.train --mesh-data 1 --mesh-model 1` (NCCL) from
    the tracked checkpoint, PARALLEL_CLI_STEPS steps at 16 x 30 s, beside
    the same CLI run without torchrun (`python -m`, a fresh process too):
    logged validation losses and the files, byte for byte (leaf by leaf
    where they differ). (b) gloo groups sharing cuda:0 for meshes (2, 1),
    (1, 2) (one group of 2 processes, in turn) and (2, 2): 4 steps of the
    tracked checkpoint (f32, dropout 0, SpecAugment and token replacement
    on) against one process on the same global batches, each rank's K2 and
    K4 launches, the step time and its collectives' share. (c)
    `ShardedCheckpointManager` on (1, 2), in the 2-process group after its
    legs: an asynchronous save and the restore into another state, bit for
    bit with its placements. (d) `decode/sharded.py` on ['cuda:0', 'cuda:0'] against
    the unsplit greedy decode. (e) on the CPU, 8 gloo processes: one step
    of the tiny configuration on a 2 x 2 x 2 multi-slice mesh against a
    flat 4 x 2."""
    import dataclasses

    from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree
    from tal_asrd_tpu_torch.core.config import TrainConfig
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, beam_search
    from tal_asrd_tpu_torch.decode.sharded import make_sharded_decode
    from tal_asrd_tpu_torch.parallel.launch import (
        build_system, save_batches, sequence_worker, start_group, train_steps, train_worker)
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

    t_phase = time.perf_counter()
    base = os.path.join(out_dir, "parallel")
    dirs = {k: os.path.join(base, k) for k in ("train", "valid", "cli_train", "ckpts", "out",
                                                 "sharded")}
    for name, split in PARALLEL_SPLITS.items():
        build_synth_corpus(dirs[name], **split)
    bpe = os.path.join(root, "accuracy_release", "bpe.model")
    tracked = os.path.join(root, "accuracy_release", "avg_last_3.bf16.msgpack")
    rec = {"phase": "parallel_1x", "card": card}

    # (e) starts first: CPU processes, beside the card's legs
    tiny = {"model": PARALLEL_TINY, "resweight": 0.4, "return": "params",
            "frontend": dict(n_mels=8, n_fft=64, win_length=64, hop_length=32),
            "specaug": dict(num_freq_masks=0, num_time_masks=0),
            "train": dict(batch_size=8, lr=1e-3, max_steps=50, token_replace_prob=0.0),
            "batches": [tiny_parallel_batch(0)]}
    slices = {shape: start_group(train_worker, 8, dict(tiny, mesh=shape), device="cpu",
                                 timeout=400) for shape in ((2, 2, 2), (4, 2))}

    # (a) the CLI under torchrun on NCCL, and without it
    common = ["--train-data", dirs["cli_train"], "--valid-data", dirs["valid"],
              "--tokenizer", bpe, "--model-type", "1x", "--num-speakers", "8",
              "--batch-size", str(PARALLEL_BATCH), "--max-secs", "28.5", "--num-workers", "0",
              "--lr", "2e-4", "--max-steps", str(PARALLEL_CLI_STEPS), "--shiftaug",
              "--cache-items", "--audio-int16", "--load", tracked,
              "--checkpoint-path", dirs["ckpts"], "--out-dir", dirs["out"], "--device", dev]
    cli = {}
    # both in fresh processes, one thread each (torchrun sets
    # OMP_NUM_THREADS=1 for its processes)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    launchers = {"plain": [sys.executable, "-m", "tal_asrd_tpu_torch.cli.train"],
                 "torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc-per-node", "1", "-m", "tal_asrd_tpu_torch.cli.train"]}
    # the two runs side by side on the card (each run's kernels give the
    # same bits whatever else the card runs)
    t0 = time.perf_counter()
    procs = {}
    for name, launcher in launchers.items():
        with open(os.path.join(base, f"{name}.stderr"), "w") as err:
            procs[name] = subprocess.Popen(
                launcher + common + ["--name", name]
                + (["--mesh-data", "1", "--mesh-model", "1"] if name == "torchrun" else []),
                cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=err)
    for name, proc in procs.items():
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
        cli[f"{name}_s"] = time.perf_counter() - t0
    for name, proc in procs.items():
        if proc.returncode != 0:
            for p in procs.values():
                p.kill()
            with open(os.path.join(base, f"{name}.stderr")) as f:
                fail(f"parallel_1x: {name} cli.train exited {proc.returncode}: "
                     f"{f.read()[-3000:]}")
    logs = {}
    for name in ("plain", "torchrun"):
        with open(os.path.join(dirs["out"], f"{name}.metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        logs[name] = [(r["step"], k, r[k]) for r in recs for k in ("val_loss_step", "val_loss")
                      if k in r]
    if [x[:2] for x in logs["plain"]] != [x[:2] for x in logs["torchrun"]] or not logs["plain"]:
        fail(f"parallel_1x: the torchrun CLI logged {logs['torchrun']}, without it "
             f"{logs['plain']}")
    cli["logged"] = logs
    cli["loss_gap_rel"] = max(abs(a[2] - b[2]) / abs(b[2])
                              for a, b in zip(logs["torchrun"], logs["plain"]))
    ckpts = {name: sorted(f for f in os.listdir(os.path.join(dirs["ckpts"], name))
                          if f.startswith(("ckpt_", "state_"))) for name in logs}
    if ckpts["plain"] != ckpts["torchrun"]:
        fail(f"parallel_1x: the CLI runs wrote {ckpts}")
    cli["files"] = ckpts["plain"]

    def files_gap(prefix, relative):
        gaps = [0.0]
        for f in ckpts["plain"]:
            a, b = (os.path.join(dirs["ckpts"], name, f) for name in ("torchrun", "plain"))
            if f.startswith(prefix) and not filecmp.cmp(a, b, shallow=False):
                gaps.append(tree_gap(load_pytree(a), load_pytree(b), relative))
        return max(gaps)
    cli["leaf_gap"] = files_gap("ckpt_", False)
    cli["state_gap_rel"] = files_gap("state_", True)
    print(f"parallel_1x: torchrun CLI vs without: loss gap {cli['loss_gap_rel']:.3g} "
          f"(relative), leaf gap {cli['leaf_gap']:.3g}, state gap {cli['state_gap_rel']:.3g} "
          f"(relative to each leaf's largest)", flush=True)
    rec["cli"] = cli
    if not (cli["loss_gap_rel"] <= PARALLEL_CLI_RTOL and cli["leaf_gap"] <= PARALLEL_CLI_ATOL):
        fail(f"parallel_1x: the torchrun CLI parts from the CLI without it: {cli}")

    # (b) gloo groups on cuda:0
    batches = parallel_batches(torch, root, dirs["train"], PARALLEL_STEPS, PARALLEL_BATCH)
    batches_path = os.path.join(base, "batches.npz")
    save_batches(batches_path, batches)
    args = get_argparser(is_train=True).parse_args(common + ["--name", "spec"])
    model_cfg = build_configs(args, BpeTokenizer(model_path=bpe))[0]
    model_cfg = dataclasses.replace(model_cfg, dropout=0.0, tds_dropout=0.0)
    spec = {"model": dataclasses.asdict(model_cfg),
            "train": dataclasses.asdict(TrainConfig(batch_size=PARALLEL_BATCH, lr=2e-4)),
            "compute_dtype": "float32", "load": tracked, "batches_path": batches_path,
            "no_tf32": True, "return": "params", "time_collectives": True}
    one = build_system(spec, dev)
    one_run = train_steps(one, batches, dev)
    one_params = one.params_tree()
    del one
    torch.cuda.empty_cache()
    # one group a world size, its runs one after another (one start-up each):
    # the 2-process group runs (2, 1), (1, 2) and the sharded checkpoint
    seqs = {2: [], 4: []}
    for shape in PARALLEL_MESHES:
        seqs[shape[0] * shape[1]].append(
            (f"{shape[0]}x{shape[1]}", "train_worker", dict(spec, mesh=shape)))
    seqs[2].append(("checkpoint", "checkpoint_worker",
                    dict(spec, mesh=(1, 2), dir=dirs["sharded"])))
    runs = {}
    for world, seq in seqs.items():
        t0 = time.perf_counter()
        for rank_out in start_group(sequence_worker, world, {"sequence": seq}, device=dev,
                                    timeout=600).wait():
            for key, out in rank_out.items():
                runs.setdefault(key, []).append(out)
        rec[f"group_{world}_s"] = time.perf_counter() - t0
    legs = {}
    for shape in PARALLEL_MESHES:
        key = f"{shape[0]}x{shape[1]}"
        ranks = runs[key]
        leg = {"rows_per_rank": PARALLEL_BATCH // shape[0],
               "loss_gap_rel": max(abs(r["metrics"][i]["loss"] - m["loss"]) / abs(m["loss"])
                                   for r in ranks for i, m in enumerate(one_run["metrics"])),
               "leaf_gap": tree_gap(ranks[0]["state"], one_params),
               "launches_by_rank": [r["launches"] for r in ranks],
               "step_ms_by_rank": [[1e3 * x for x in r["step_s"]] for r in ranks],
               "collective_share_by_rank": [r["collective_s"] / sum(r["step_s"])
                                            for r in ranks],
               "collective_calls_by_rank": [r["collective_calls"] for r in ranks],
               "losses": [m["loss"] for m in ranks[0]["metrics"]]}
        legs[key] = leg
        print(f"parallel_1x: mesh {key}: loss gap {leg['loss_gap_rel']:.3g}, leaf gap "
              f"{leg['leaf_gap']:.3g}, launches {leg['launches_by_rank']}", flush=True)
        short = [r for r in ranks if min(r["launches"].values()) < PARALLEL_STEPS]
        if short:
            fail(f"parallel_1x: mesh {key}: a rank launched K2 or K4 fewer than "
                 f"{PARALLEL_STEPS} times: {leg['launches_by_rank']}")
        if not (leg["loss_gap_rel"] <= PARALLEL_LOSS_RTOL
                and leg["leaf_gap"] <= PARALLEL_LEAF_ATOL):
            fail(f"parallel_1x: mesh {key} parts from one process: {leg}")
    rec["one_process"] = {"losses": [m["loss"] for m in one_run["metrics"]],
                          "step_ms": [1e3 * x for x in one_run["step_s"]],
                          "launches": one_run["launches"]}
    rec["legs"] = legs

    # (c) the sharded checkpoint (run above in the 2-process group)
    ck = runs["checkpoint"]
    rec["sharded_checkpoint"] = {k: [r[k] for r in ck] for k in
                                 ("bit_equal", "placements_kept", "sharded_leaves",
                                  "save_return_s", "wait_s", "load_s")}
    print(f"parallel_1x: sharded checkpoint {rec['sharded_checkpoint']}", flush=True)
    if not all(r["bit_equal"] and r["placements_kept"] for r in ck):
        fail(f"parallel_1x: the sharded checkpoint did not come back whole: {ck}")

    # (d) the sharded decode, two parts on the card
    model = tracked_1x(torch, dev, root, torch.float32)
    tok = BpeTokenizer(model_path=bpe)
    dspec = BeamSearchSpec(beam_size=1, max_new_tokens=32, eos_id=tok.eos_token_id,
                           vocab_size=model.cfg.num_tokens, text_vocab_size=len(tok),
                           force_output=True)
    b0 = batches[0]
    audio = torch.from_numpy(b0["audio"][:4].astype(np.float32) / 32768.0)
    lens = torch.from_numpy(b0["audio_lens"][:4])
    prime = torch.from_numpy(b0["text"][:4, :1]).long()
    with torch.inference_mode():
        whole = beam_search(model, model.encode(audio.to(dev), lens.to(dev)), prime.to(dev),
                            dspec)
    parts = make_sharded_decode(model, dspec, [dev, dev])(audio, lens, prime)
    same = (torch.equal(whole["tokens"].cpu(), parts["tokens"].cpu())
            and torch.equal(whole["lengths"].cpu(), parts["lengths"].cpu()))
    rec["sharded_decode"] = {"rows": 4, "tokens_equal": same,
                             "lengths": parts["lengths"].cpu().tolist()}
    if not same:
        fail("parallel_1x: the sharded decode on two parts of cuda:0 parts from the unsplit")
    del model

    # (e) the multi-slice step
    got = {shape: g.wait() for shape, g in slices.items()}
    a, b = got[(2, 2, 2)][0], got[(4, 2)][0]
    rec["multislice_cpu"] = {"loss": [a["metrics"][0]["loss"], b["metrics"][0]["loss"]],
                             "leaf_gap": tree_gap(a["state"], b["state"]),
                             "note": "8 gloo processes on the CPU, tiny configuration"}
    if rec["multislice_cpu"]["leaf_gap"] > 1e-7 or abs(
            a["metrics"][0]["loss"] - b["metrics"][0]["loss"]) > 1e-6 * abs(b["metrics"][0]["loss"]):
        fail(f"parallel_1x: the 2x2x2 step parts from the 4x2 one: {rec['multislice_cpu']}")
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def parallel_entries(torch, dev, pr):
    """K2 and K4 of each gloo leg, checked and timed at a rank's rows; the
    launches are the fewest any rank made."""
    entries = []
    for key, leg in pr["legs"].items():
        rows = leg["rows_per_rank"]
        k2 = check_logmel(torch, dev, rows, 480_000)
        k4 = check_specaug(torch, dev, rows, spec_in=torch.randn((rows, 3001, 80), device=dev))
        low = {k: min(r[k] for r in leg["launches_by_rank"]) for k in leg["launches_by_rank"][0]}
        entries += [kernel_entry(f"parallel_1x:{key}", k2, low["fused_logmel_project"],
                                 k2["max_abs_err"]),
                    kernel_entry(f"parallel_1x:{key}", k4, low["spec_augment"],
                                 k4["max_abs_err"])]
    return entries


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="all",
                    choices=("all", "kernels", "train", "eval", "unaligned", "train_cli",
                             "lm", "spk", "noncausal", "embed", "cluster", "sd", "sad",
                             "diar", "align", "optim", "parallel"),
                    help="'kernels' stops after the build and the kernel checks; "
                         "'train' skips the serving and eval phases; 'eval' runs "
                         "eval_aligned_1x after the kernel checks, nothing else; "
                         "'unaligned' runs eval_unaligned_1x after them; "
                         "'train_cli' runs train_cli_1x after them; 'lm' runs "
                         "lm_fusion_1x after them; 'spk' runs spk_head_1x after them; "
                         "'noncausal' runs noncausal_1x after them; 'embed' runs "
                         "embed_1x after them; 'cluster' runs cluster_1x after them; "
                         "'sd' runs sd_baseline_1x after them; 'sad' runs sad_1x after them; "
                         "'diar' runs diar_1x after them; 'align' runs align_1x after them; "
                         "'optim' runs optim_1x after them (also in 'train'); 'parallel' "
                         "runs parallel_1x after them (also in 'train')")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one fused greedy generate per model, each eval "
                         "CLI run, one 2x training step, the training CLI's second "
                         "run, each fused leg with the seeded LM, the speaker "
                         "head's bf16 aligned run and 5 steps of cli.train_sd with "
                         "torch.profiler and print where the time goes")
    args = ap.parse_args()
    t_start = time.perf_counter()

    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not installed ({e})")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from tal_asrd_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the tal_asrd_tpu_torch package is not beside this script ({e})")

    # f32 comparisons must not run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"

    # ---- 1. device + build ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stdout.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.load_library()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_sources": [
              os.path.relpath(s, root) for s in _build.sources()],
          "build_seconds": _build.build_seconds})

    # ---- 2-3. kernels against their plain versions ----------------------------
    # K2 at both models' request batches (32 and 8 windows of 28.56 s) and at
    # the trainers' batches (64 and 8 windows of 20 s)
    k2 = {"2x": check_logmel(torch, dev, 32), "1x": check_logmel(torch, dev, 8),
          "train_2x": check_logmel(torch, dev, 64, TRAIN_SAMPLES),
          "train_1x": check_logmel(torch, dev, 8, TRAIN_SAMPLES)}
    # K4 at the trainers' shapes [64 | 8, 2001, 80] and at the edge cases
    k4 = {"train_2x": check_specaug(torch, dev, 64, edge_cases=True),
          "train_1x": check_specaug(torch, dev, 8)}
    bf16, f32 = torch.bfloat16, torch.float32
    # K1 at the shapes the serving phases give it, S=340: greedy lanes (2x:
    # B=32, L=97; 1x: B=8, L=65) and beam-5 lanes (B=40), at the first and the
    # last indices of a decode; at S=357, an unaligned chunk's window; and at
    # the shape of train_1x_checkpoint's generate (B=8, L=33). `key` names the
    # records the kernels line gives.
    k1 = {}
    for key, name, d, b, s, l_buf in (
            (None, "2x", 512, 32, 357, 97), (None, "1x", 256, 32, 357, 97),
            ("2x", "2x", 512, 32, 340, 97), ("1x", "1x", 256, 8, 340, 65),
            (None, "2x", 512, 40, 340, 97), (None, "1x", 256, 40, 340, 65),
            ("train_1x", "1x", 256, 8, 340, 33)):
        for first_index in (0, l_buf - 4):
            for dt in (f32, bf16):
                rec = check_layer_step(torch, dev, f"{name},B={b},S={s},L={l_buf}", b, d, 4,
                                       s, l_buf, dt, first_index)
                if key is not None and dt == bf16:
                    if key in k1:       # the worst over both index ranges
                        for k, v in k1[key]["max_abs_err"].items():
                            rec["max_abs_err"][k] = max(rec["max_abs_err"][k], v)
                    k1[key] = rec
    # timings at those shapes: the greedy lanes, last step of the run
    for key, b, d, l_buf in (("2x", 32, 512, 97), ("1x", 8, 256, 65),
                             ("train_1x", 8, 256, 33)):
        k1[key].update(time_decode(torch, dev, "K1", "none", b, d, 4, 340, l_buf,
                                   l_buf - 2, bf16))
    emit({"phase": "kernel_timing", "name": "fused_layer_step", "card": card,
          "note": "ms = CUDA-graph replay (device time); eager_ms = eager loop (includes the host)",
          **{key: {k: v[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                     "bound_by", "timed_shape", "plan")}
             for key, v in k1.items()}})

    # ---- 3b. K1's int8 modes and K3 against their plain versions, at the -----
    # shapes the new serving configurations give them: greedy lanes (2x B=32,
    # L=97; 1x B=8, L=65) and beam-5 lanes (B=40), S=340
    k1_modes, k3_modes = ("kv8", "w8", "kv8+w8"), ("none", "kv8", "w8", "kv8+w8")
    checks = {}
    for name, d, b, l_buf in (("2x", 512, 32, 97), ("1x", 256, 8, 65),
                              ("2x", 512, 40, 97), ("1x", 256, 40, 65)):
        for key, rec in check_decode_modes(torch, dev, name, b, d, 4, 340, l_buf,
                                           k1_modes, k3_modes).items():
            if b != 40:                      # the greedy lanes: the kernels line's errors
                checks[(name,) + key] = rec
    chain = check_k3_against_k1_chain(torch, dev, "2x", 32, 512, 4, 340, 97)
    for name, d, b, l_buf in (("2x", 512, 32, 97), ("1x", 256, 8, 65), ("2x", 512, 40, 97)):
        for kern in ("K1", "K3"):
            check_determinism(torch, dev, kern, name, b, d, 4, 340, l_buf)
    # timings at the greedy serving shapes, last step of the run
    timed = {}
    for name, b, d, l_buf in (("2x", 32, 512, 97), ("1x", 8, 256, 65)):
        for kern, modes in (("K1", k1_modes), ("K3", k3_modes)):
            for mode in modes:
                timed[(name, kern, mode)] = time_decode(
                    torch, dev, kern, mode, b, d, 4, 340, l_buf, l_buf - 2, bf16)
    emit({"phase": "kernel_timing", "name": "int8 modes and stacked_decoder_step",
          "card": card, "note": "ms per launch, CUDA-graph replay; K3 is one launch "
                                "for all four layers, beside it 4 x K1's time",
          "k3_vs_k1_chain": {f"{m},{dt}": e for (m, dt), e in chain.items()},
          **{f"{name},{kern},{mode}": {
              k: t[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                                "timed_shape", "plan") if k in t}
              for (name, kern, mode), t in timed.items()},
          "four_k1_ms": {f"{name},{mode}": 4 * (k1[name] if mode == "none" else
                                                timed[(name, "K1", mode)])["ms"]
                         for name in ("2x", "1x") for mode in k3_modes}})
    # ---- 3c. K1 and K2 at the eval path's shapes --------------------------------
    k1_eval, k2_eval = check_eval_kernels(torch, dev)
    emit({"phase": "kernel_timing", "name": "fused_layer_step", "card": card,
          "of": "eval_aligned_1x", "note": "ms = CUDA-graph replay, per launch",
          **{k: k1_eval[EVAL_LANES[0]][k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                      "bound_by", "timed_shape", "plan")},
          "plans": {str(b): k1_eval[b]["plan"] for b in EVAL_LANES}})
    # ---- 3d. K1 and K2 at the long-form path's shapes; the prefill -> K1 ------
    # hand-off on the tracked checkpoint
    k1_long, k2_long = check_unaligned_kernels(torch, dev)
    model_1x, _ = build_1x_checkpoint(torch, dev, root)
    check_prefill_handoff(torch, dev, model_1x, card)
    del model_1x
    torch.cuda.empty_cache()
    emit({"phase": "kernel_timing", "name": "fused_layer_step", "card": card,
          "of": "eval_unaligned_1x", "note": "ms = CUDA-graph replay, per launch",
          **{f"{leg},{key}": {k: v[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                 "bound_by", "timed_shape", "plan")}
             for (leg, key), v in k1_long.items() if "ms" in v}})
    if args.phases == "kernels":
        print("chip_smoke: kernel checks passed (serving phases skipped)", flush=True)
        return
    out_dir = os.path.join(root, "out", "chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    entries = []
    if args.phases == "all":
        entries += serving_phases(torch, dev, root, args, k1, k2, checks, timed)[1]

    # K1's record of the aligned leg's path: at 320 lanes (timed there), with
    # the worst error of both lane counts
    k1_rec = dict(k1_eval[EVAL_LANES[0]], max_abs_err={
        k: max(k1_eval[b]["max_abs_err"][k] for b in EVAL_LANES)
        for k in k1_eval[EVAL_LANES[0]]["max_abs_err"]})
    # ---- 5b. the aligned evaluation ------------------------------------------
    if args.phases in ("all", "eval"):
        ev = run_eval_aligned_1x(torch, dev, root, out_dir, card,
                                 {str(b): k1_eval[b]["plan"] for b in EVAL_LANES},
                                 trace=args.profile)
        entries += [
            kernel_entry("eval_aligned_1x:fused", k1_rec,
                         ev["fused"]["launches"]["fused_layer_step"],
                         k1_rec["max_abs_err"]["x_out"], "none"),
            kernel_entry("eval_aligned_1x:fused", k2_eval,
                         ev["fused"]["launches"]["fused_logmel_project"],
                         k2_eval["max_abs_err"]),
            kernel_entry("eval_aligned_1x:unfused", k2_eval,
                         ev["unfused"]["launches"]["fused_logmel_project"],
                         k2_eval["max_abs_err"])]
    # ---- 5c. the long-form evaluation ----------------------------------------
    if args.phases in ("all", "unaligned"):
        un = run_eval_unaligned_1x(torch, dev, root, out_dir, card, trace=args.profile)
        entries += unaligned_entries(un, k1_long, k2_long)
    if args.phases in ("eval", "unaligned"):
        shutil.rmtree(out_dir, ignore_errors=True)
        finish(torch, entries, card, t_start)
        return
    # ---- 8. LM shallow fusion ---------------------------------------------------
    if args.phases in ("all", "lm"):
        k1_lm = check_lm_kernels(torch, dev)
        emit({"phase": "kernel_timing", "name": "fused_layer_step", "card": card,
              "of": "lm_fusion_1x (f32)", "note": "ms = CUDA-graph replay, per launch",
              **{str(key): {k: v[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                               "bound_by", "timed_shape", "plan")}
                 for key, v in k1_lm.items() if "ms" in v}})
        entries += lm_entries(run_lm_fusion_1x(torch, dev, root, out_dir, card,
                                               trace=args.profile),
                              k1_lm, k1_rec, k2_eval, k1_long, k2_long)
    if args.phases == "lm":
        shutil.rmtree(out_dir, ignore_errors=True)
        finish(torch, entries, card, t_start)
        return
    # ---- 9. the separate speaker head --------------------------------------------
    if args.phases in ("all", "spk"):
        entries += spk_entries(run_spk_head_1x(torch, dev, root, out_dir, card,
                                               trace=args.profile), k2_eval, k2_long)
    if args.phases == "spk":
        shutil.rmtree(out_dir, ignore_errors=True)
        finish(torch, entries, card, t_start)
        return
    # ---- 10. the non-causal reference decode and the sharded decode -------------
    if args.phases in ("all", "noncausal"):
        nc = run_noncausal_1x(torch, dev, root, out_dir, card)
        # K2 at the parts' rows: half the first batch, half the 4 episodes
        k2_beam_part = check_logmel(torch, dev, 32, EVAL_SAMPLES)
        k2_sm_part = check_logmel(torch, dev, SM_GROUP // 2, SM_EPISODE_SAMPLES)
        entries += noncausal_entries(nc, k2_eval, k2_beam_part, k2_sm_part)
    # ---- 11. speaker-embedding export and the contrastive head -------------------
    if args.phases in ("all", "embed"):
        em = run_embed_1x(torch, dev, root, out_dir, card)
        # K2 at every batch shape of the train-split export
        k2_train8 = {shape: check_logmel(torch, dev, *map(int, shape.split("x")))
                     for shape in em["gen_embed"]["train8_bf16"]["k2_launches_by_shape"]}
        entries += embed_entries(em, k2_eval, k2_train8)
    # ---- 12. the embedding chain's clustering half -------------------------------
    if args.phases in ("all", "cluster"):
        entries += cluster_entries(run_cluster_1x(torch, dev, root, out_dir, card),
                                   k1_rec, k2_eval)
    # ---- 13. the speaker baseline and its reconciliation ----------------------------
    if args.phases in ("all", "sd"):
        sd = run_sd_baseline_1x(torch, dev, root, out_dir, card, trace=args.profile)
        # K2 and K4 at each batch shape of cli.train_sd's run; K2 at one
        # episode of 180 s (the dump and the chain's eval run)
        k2_cli = {}
        for shape in sd["cli"]["by_shape"]:
            b, t = map(int, shape.split("x"))
            k2_cli[shape] = (check_logmel(torch, dev, b, t), check_specaug(
                torch, dev, b, spec_in=torch.randn((b, 1 + t // 160, 80), device=dev)))
        k2_one = check_logmel(torch, dev, 1, SM_EPISODE_SAMPLES)
        entries += sd_entries(sd, k1_long[("sm", 1)], k2_one, k2_cli)
    # ---- 14. the neural SAD ------------------------------------------------------------
    if args.phases in ("all", "sad"):
        run_sad_1x(torch, dev, root, out_dir, card)
    # ---- 15. first diarization: UIS-RNN, wav2vec, diar-features --------------------------
    if args.phases in ("all", "diar"):
        entries += diar_entries(*run_diar_1x(torch, dev, root, out_dir, card))
    # ---- 16. forced alignment ----------------------------------------------------------------
    if args.phases in ("all", "align"):
        entries += align_entries(*run_align_1x(torch, dev, root, out_dir, card))
    if args.phases in ("noncausal", "embed", "cluster", "sd", "sad", "diar", "align"):
        shutil.rmtree(out_dir, ignore_errors=True)
        finish(torch, entries, card, t_start)
        return
    # ---- 18. parallelism --------------------------------------------------------------------
    if args.phases == "parallel":
        entries += parallel_entries(torch, dev, run_parallel_1x(torch, dev, root, out_dir, card))
        shutil.rmtree(out_dir, ignore_errors=True)
        finish(torch, entries, card, t_start)
        return
    # ---- 17. RAdam, Adafactor and Lookahead ---------------------------------------------
    if args.phases == "optim":
        entries += optim_entries(*run_optim_1x(torch, dev, root, out_dir, card, k1["1x"]),
                                 k1["1x"], k2["1x"])
        shutil.rmtree(out_dir, ignore_errors=True)
        finish(torch, entries, card, t_start)
        return
    # ---- 7b. the training CLI --------------------------------------------------
    if args.phases == "train_cli":
        entries += train_cli_entries(run_train_cli_1x(torch, dev, root, out_dir, card,
                                                      trace=args.profile))
        shutil.rmtree(out_dir, ignore_errors=True)
        finish(torch, entries, card, t_start)
        return

    # ---- 6-7. the training path ------------------------------------------------
    t2 = run_train_2x(torch, dev, out_dir, trace=args.profile)
    t1 = run_train_1x_checkpoint(torch, dev, root, out_dir)
    tc = run_train_cli_1x(torch, dev, root, out_dir, card, trace=args.profile)
    op = run_optim_1x(torch, dev, root, out_dir, card, k1["1x"])
    pr = run_parallel_1x(torch, dev, root, out_dir, card)
    shutil.rmtree(out_dir, ignore_errors=True)
    # each training path's kernels, each with the record of the shape that
    # path gave it: train_1x_checkpoint trains at B=8 x 20 s and generates at
    # B=8 x 28.56 s, 32 tokens
    t1_train, t1_gen = t1["train_launches"], t1["generate_launches"]
    entries += [
        kernel_entry("train_2x", k2["train_2x"], t2["launches"]["fused_logmel_project"],
                     k2["train_2x"]["max_abs_err"]),
        kernel_entry("train_2x", k4["train_2x"], t2["launches"]["spec_augment"],
                     k4["train_2x"]["max_abs_err"]),
        kernel_entry("train_1x_checkpoint:train", k4["train_1x"], t1_train["spec_augment"],
                     k4["train_1x"]["max_abs_err"]),
        kernel_entry("train_1x_checkpoint:train", k2["train_1x"],
                     t1_train["fused_logmel_project"], k2["train_1x"]["max_abs_err"]),
        kernel_entry("train_1x_checkpoint:generate", k2["1x"],
                     t1_gen["fused_logmel_project"], k2["1x"]["max_abs_err"]),
        kernel_entry("train_1x_checkpoint:generate", k1["train_1x"],
                     t1_gen["fused_layer_step"], k1["train_1x"]["max_abs_err"]["x_out"],
                     "none"),
    ] + train_cli_entries(tc) + optim_entries(*op, k1["1x"], k2["1x"]) + parallel_entries(
        torch, dev, pr)
    finish(torch, entries, card, t_start)


def finish(torch, entries, card, t_start) -> None:
    """The `kernels` line, then the contract line."""
    never = [(e["config"], e["name"]) for e in entries if e["launches"] <= 0]
    if never:
        fail(f"a kernel of a path was never launched: {never}")
    emit({"kernels": entries, "card": card, "seconds_total": time.perf_counter() - t_start})

    # ---- 8. the contract line ---------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
