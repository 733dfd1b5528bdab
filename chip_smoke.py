#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, needs one card
    python3 chip_smoke.py --phases kernels   # build + kernel checks only

Builds the port's CUDA kernels from tal_asrd_tpu_torch/csrc/ with nvcc, holds
each against its plain PyTorch version on the card at the serving path's
shapes, then drives the serving path (`make_generate_fn`: log-mel -> TDS
encoder -> fused decoder step -> beam search) at full width for the `2x`
model (seeded weights) and the `1x` model (the tracked checkpoint
accuracy_release/avg_last_3.bf16.msgpack), each through the fused kernels and
through the unfused decoder, and compares the two.

Prints one JSON object per line: `device`, one `kernel` line per check,
`serve_2x`, `serve_1x_checkpoint`, `kernels` (every kernel of each model's
path with its launch count in that model's one timed fused greedy generate,
its error against the plain version, its time, the plain version's, a library
call's where one exists, and the least time the card could take), and last
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero, without that line, if there is no CUDA device, if a kernel
does not build or launch, or if any comparison misses its tolerance.

Imports torch and the port only — nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM (dense): device memory rate, f32 rate
# outside the tensor cores, bf16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

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
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: fused_logmel_project
# ---------------------------------------------------------------------------
def check_logmel(torch, dev, b):
    """Kernel vs plain version and timings at N = b x 2857 frames."""
    from tal_asrd_tpu_torch.core.config import FrontendConfig
    from tal_asrd_tpu_torch.ops.cuda_kernels import (
        fused_logmel_project, logmel_project_plain)
    from tal_asrd_tpu_torch.ops.logmel import mel_filterbank, power_spectrogram

    cfg = FrontendConfig()
    rng = np.random.default_rng(SEED)
    audio = torch.from_numpy(
        (rng.standard_normal((b, WINDOW_SAMPLES)) * 0.1).astype(np.float32)).to(dev)
    power = power_spectrogram(audio, cfg)
    n = power.shape[0] * power.shape[1]
    power = power.reshape(n, power.shape[2]).contiguous()
    fb = torch.from_numpy(mel_filterbank(
        cfg.n_fft // 2 + 1, cfg.f_min, cfg.effective_f_max, cfg.n_mels,
        cfg.sample_rate)).to(dev)
    eps = cfg.log_eps

    out = fused_logmel_project(power, fb, eps)
    torch.cuda.synchronize()
    ref = logmel_project_plain(power, fb, eps)
    err = float((out - ref).abs().max())
    # a ragged row count exercises the partial last tile
    out_r = fused_logmel_project(power[:1003].contiguous(), fb, eps)
    err_r = float((out_r - ref[:1003]).abs().max())
    tol = 1e-5
    f, m = power.shape[1], fb.shape[1]
    ms = time_ms(lambda: fused_logmel_project(power, fb, eps), 20)
    plain_ms = time_ms(lambda: logmel_project_plain(power, fb, eps), 20)
    library_ms = time_ms(lambda: torch.log(power @ fb + eps), 20)
    bound_ms, bound_by = bound((n * f + f * m + n * m) * 4.0,
                               2.0 * n * f * m, "float32")
    rec = {
        "phase": "kernel", "name": "fused_logmel_project", "route": "cuda",
        "source": "tal_asrd_tpu_torch/csrc/logmel_project.cu",
        "replaces": "tal_asrd_tpu/ops/pallas_kernels.py:48",
        "shape": {"N": n, "n_freqs": f, "n_mels": m}, "dtype": "float32",
        "max_abs_err": max(err, err_r), "tolerance": tol,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }
    emit(rec)
    if not (np.isfinite(err) and max(err, err_r) <= tol):
        fail(f"fused_logmel_project differs from its plain version by "
             f"{max(err, err_r)} (> {tol})")
    return rec


# ---------------------------------------------------------------------------
# Phase 3: fused_layer_step
# ---------------------------------------------------------------------------
def make_layer_inputs(torch, dev, rng, b, d, h, s, l_buf, dtype, n_sets=1):
    """Seeded packed weights (ReZero scalars 0.3), cross K/V, pad bias."""
    f = 4 * d

    def mat(k, n):
        return torch.from_numpy(
            (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
        ).to(dev).to(dtype)

    def vec(n):
        return torch.from_numpy(
            (rng.standard_normal(n) * 0.1).astype(np.float32)).to(dev)

    sets = []
    for _ in range(n_sets):
        rw = torch.tensor([0.3, 0.3], dtype=torch.float32, device=dev)
        w = {"wqkv": mat(d, 3 * d), "bqkv": vec(3 * d), "wso": mat(d, d),
             "bso": vec(d), "wcq": mat(d, d), "bcq": vec(d), "wco": mat(d, d),
             "bco": vec(d), "wf1": mat(d, f), "bf1": vec(f), "wf2": mat(f, d),
             "bf2": vec(d), "rw": rw, "resweight": rw[0], "resweight_src": rw[1]}
        mk = torch.from_numpy(
            rng.standard_normal((b, s, d)).astype(np.float32)).to(dev).to(dtype)
        mv = torch.from_numpy(
            rng.standard_normal((b, s, d)).astype(np.float32)).to(dev).to(dtype)
        sets.append((w, mk, mv))
    mask = np.zeros((b, s), bool)
    for lane in range(0, b, 3):          # a padded tail on some lanes
        mask[lane, s - 5 - 7 * (lane % 5):] = True
    bias = torch.from_numpy(np.where(mask, -1e9, 0.0).astype(np.float32)).to(dev)
    xs = torch.from_numpy(
        (rng.standard_normal((3, b, d)) * 0.5).astype(np.float32)).to(dev).to(dtype)
    return sets, bias, xs


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
    sets, bias, xs = make_layer_inputs(torch, dev, rng, b, d, h, s, l_buf, dtype)
    w, mk, mv = sets[0]
    ck_k, cv_k = (torch.from_numpy(
        rng.standard_normal((b, l_buf, d)).astype(np.float32)).to(dev).to(dtype)
        for _ in range(2))
    ck_p, cv_p = ck_k.clone(), cv_k.clone()
    errs = {"x_out": 0.0, "attn": 0.0, "cache": 0.0, "cache_ulps": 0.0}
    attn_max = 0.0
    for step in range(3):               # chained: the caches carry over
        index = first_index + step
        xo, at, ck_k, cv_k = fused_layer_step(
            xs[step], w, ck_k, cv_k, mk, mv, bias, index, n_head=h)
        torch.cuda.synchronize()
        xr, ar, ck_p, cv_p = layer_step_plain(
            xs[step], w, ck_p, cv_p, mk, mv, bias, index, h)
        attn_max = max(attn_max, float(ar.max()))
        errs["x_out"] = max(errs["x_out"], float((xo.float() - xr.float()).abs().max()))
        errs["attn"] = max(errs["attn"], float((at - ar).abs().max()))
        for a, r in ((ck_k, ck_p), (cv_k, cv_p)):
            diff = (a.float() - r.float()).abs()
            errs["cache"] = max(errs["cache"], float(diff.max()))
            if dtype == torch.bfloat16:
                errs["cache_ulps"] = max(
                    errs["cache_ulps"], float((diff / bf16_ulp(r.float())).max()))
        if not all(torch.isfinite(t.float()).all() for t in (xo, at)):
            fail(f"{name}: non-finite kernel output at index {index}")
    # attn is a mean of softmax rows over S, so a typical value is 1/S ~ 3e-3:
    # its limits sit far below that (a uniform or unmasked attention misses
    # them by orders of magnitude). In bf16 a rounding of x1 that falls the
    # other way moves the cross query by one step, hence the wider limit.
    if dtype == torch.float32:
        tol = {"x_out": 1e-5, "attn": 1e-6, "cache": 1e-5}
    else:
        tol = {"x_out": 3e-2, "attn": 5e-5, "cache_ulps": 1.0}
    rec = {"phase": "kernel", "name": "fused_layer_step", "config": name,
           "route": "cuda", "source": "tal_asrd_tpu_torch/csrc/layer_step.cu",
           "replaces": "tal_asrd_tpu/ops/pallas_decode.py:188",
           "shape": {"B": b, "D": d, "H": h, "S": s, "L": l_buf},
           "indices": [first_index, first_index + 1, first_index + 2],
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": errs, "tolerance": tol, "attn_max": attn_max}
    emit(rec)
    for key, t in tol.items():
        if not errs[key] <= t:
            fail(f"fused_layer_step[{name}] {key} differs from its plain "
                 f"version by {errs[key]} (> {t})")
    return rec


def time_layer_step(torch, dev, b, d, h, s, l_buf, index, dtype):
    """Kernel, plain version and bound at one serving shape. Four layers'
    weights and cross K/V are cycled, as the decode loop does, so the cross
    K/V (4 x 2*B*S*D elements, above the L2 size at the 2x shape) is read
    from device memory as the real caller reads it."""
    from tal_asrd_tpu_torch.ops.cuda_decode import (
        fused_layer_step, layer_step_plain)

    rng = np.random.default_rng(SEED + 7)
    sets, bias, xs = make_layer_inputs(torch, dev, rng, b, d, h, s, l_buf,
                                       dtype, n_sets=4)
    caches = [(torch.randn((b, l_buf, d), device=dev).to(dtype),
               torch.randn((b, l_buf, d), device=dev).to(dtype)) for _ in sets]
    x = xs[0]

    def run(fn):
        def go():
            for (w, mk, mv), (ck, cv) in zip(sets, caches):
                fn(x, w, ck, cv, mk, mv, bias, index, h)
        return go

    ms = time_graph_ms(run(fused_layer_step), 25) / len(sets)
    eager_ms = time_ms(run(fused_layer_step), 25) / len(sets)
    plain_ms = time_ms(run(layer_step_plain), 10) / len(sets)
    es = x.element_size()
    f = 4 * d
    n_w = 4 * d * d + 2 * d * f + 2 * d * d       # wqkv+wso, wf1+wf2, wcq+wco
    bytes_moved = (
        n_w * es + (3 * d + 4 * d + f) * 4 + 8     # weights, biases, rw
        + 2 * b * s * d * es                       # cross K/V
        + 2 * b * (index + 1) * d * es             # live self cache read
        + 2 * b * d * es                           # cache row written
        + 2 * b * d * es                           # x in, x out
        + 2 * b * s * 4)                           # pad bias in, attn out
    flops = 2.0 * b * (n_w + 2 * (index + 1) * d + 2 * s * d)
    bound_ms, bound_by = bound(bytes_moved, flops,
                               str(dtype).replace("torch.", ""))
    return {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "timed_shape": {"B": b, "D": d, "H": h, "S": s, "L": l_buf,
                            "index": index},
            "bytes": bytes_moved}


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


def rescore(torch, model, enc, tokens, p):
    """Length-normalized teacher-forced score of each row of `tokens` under
    the unfused full-sequence decoder: what a consistent search reports."""
    logits, _ = model.decode(tokens[:, :-1], enc)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_lp = logp.gather(-1, tokens[:, 1:, None])[..., 0]       # [B, L-1]
    return tok_lp[:, p - 1:].sum(dim=-1) / tokens.shape[1]


def first_divergence(a, b):
    """Per lane: index of the first differing token, or -1."""
    ne = a != b
    return [int(np.argmax(row)) if row.any() else -1 for row in ne]


def profile_generate(torch, tag, gen, args):
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
    # rows repeat their kernels' time and are left out of the device sums.
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_time = lambda e: e.self_device_time_total
    busy = sum(dev_time(e) for e in on_device) / 1e6
    top_dev = sorted(on_device, key=dev_time, reverse=True)[:8]
    top_cpu = sorted((e for e in events
                      if e.device_type != torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    emit({"phase": "profile", "of": tag, "wall_seconds_traced": wall,
          "device_busy_seconds": busy,
          "device_idle_share": (1.0 - busy / wall) if busy > 0 else None,
          "device_launches": sum(e.count for e in on_device),
          "top_device": [{"name": e.key[:60], "calls": e.count,
                          "ms": dev_time(e) / 1e3} for e in top_dev],
          "top_host": [{"name": e.key[:60], "calls": e.count,
                        "ms": e.self_cpu_time_total / 1e3} for e in top_cpu]})


def serve(torch, dev, tag, model, audio_np, max_new, greedy_b, beam_b,
          trace=False):
    from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, make_generate_fn
    from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project

    cfg = model.cfg
    fused = FusedASRDecoder(model)
    lens = np.full((audio_np.shape[0],), audio_np.shape[1], np.int64)
    out = {"phase": tag, "model_type": cfg.model_type, "d_decoder": cfg.d_decoder,
           "num_tokens": cfg.num_tokens, "dtype": str(model.dtype).replace("torch.", ""),
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
    fused_layer_step.launches = 0
    fused_logmel_project.launches = 0
    res_f, secs_f = run(gen_f, greedy_b)
    launches_per_generate = {
        "fused_layer_step": fused_layer_step.launches,
        "fused_logmel_project": fused_logmel_project.launches}
    res_u, secs_u = run(gen_u, greedy_b)
    if trace:
        profile_generate(torch, tag + ":greedy_fused", gen_f,
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
    expected_k1 = cfg.n_decoder_layers * (p + max_new - 1)
    if launches_per_generate != {"fused_layer_step": expected_k1,
                                 "fused_logmel_project": 1}:
        fail(f"{tag}: launches per generate {launches_per_generate}, expected "
             f"fused_layer_step={expected_k1}, fused_logmel_project=1")
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
        "fused_layer_step": fused_layer_step.launches,
        "fused_logmel_project": fused_logmel_project.launches}
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="all", choices=("all", "kernels"),
                    help="'kernels' stops after the build and the kernel checks")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one fused greedy generate per model with "
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
    # K2 at both models' request batches (32 and 8 windows)
    k2 = {"2x": check_logmel(torch, dev, 32), "1x": check_logmel(torch, dev, 8)}
    bf16, f32 = torch.bfloat16, torch.float32
    # K1 at the shapes the serving phases give it, S=340: greedy lanes (2x:
    # B=32, L=97; 1x: B=8, L=65) and beam-5 lanes (B=40), at the first and the
    # last indices of a decode; and at S=357, an unaligned chunk's window.
    k1 = {}
    for name, d, b, s, l_buf in (
            ("2x", 512, 32, 357, 97), ("1x", 256, 32, 357, 97),
            ("2x", 512, 32, 340, 97), ("1x", 256, 8, 340, 65),
            ("2x", 512, 40, 340, 97), ("1x", 256, 40, 340, 65)):
        for first_index in (0, l_buf - 4):
            for dt in (f32, bf16):
                rec = check_layer_step(torch, dev, f"{name},B={b},S={s}", b, d, 4,
                                       s, l_buf, dt, first_index)
                if s == 340 and b in (32, 8) and dt == bf16:
                    if name in k1:      # the worst over both index ranges
                        for key, v in k1[name]["max_abs_err"].items():
                            rec["max_abs_err"][key] = max(rec["max_abs_err"][key], v)
                    k1[name] = rec
    # timings at the serving shapes: the greedy lanes, last step of the run
    k1["2x"].update(time_layer_step(torch, dev, 32, 512, 4, 340, 97, 95, bf16))
    k1["1x"].update(time_layer_step(torch, dev, 8, 256, 4, 340, 65, 63, bf16))
    emit({"phase": "kernel_timing", "name": "fused_layer_step", "card": card,
          "note": "ms = CUDA-graph replay (device time); eager_ms = eager loop (includes the host)",
          **{name: {k: k1[name][k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                              "bound_by", "timed_shape")}
             for name in ("2x", "1x")}})
    if args.phases == "kernels":
        print("chip_smoke: kernel checks passed (serving phases skipped)", flush=True)
        return

    # ---- 4-5. the serving path --------------------------------------------------
    rng = np.random.default_rng(SEED)
    model_2x = build_2x(torch, dev)
    audio_2x = (rng.standard_normal((32, WINDOW_SAMPLES)) * 0.1).astype(np.float32)
    launches_2x = serve(torch, dev, "serve_2x", model_2x, audio_2x, max_new=96,
                        greedy_b=32, beam_b=8, trace=args.profile
                        )["greedy"]["launches_per_generate"]
    del model_2x
    torch.cuda.empty_cache()

    model_1x, n_leaves = build_1x_checkpoint(torch, dev, root)
    if n_leaves != 151:
        fail(f"checkpoint: {n_leaves} leaves placed, expected 151")
    audio_1x = speechlike_audio(rng, 8, WINDOW_SAMPLES)
    launches_1x = serve(torch, dev, "serve_1x_checkpoint", model_1x, audio_1x,
                        max_new=64, greedy_b=8, beam_b=8, trace=args.profile
                        )["greedy"]["launches_per_generate"]

    # ---- 6. every kernel of each model's path, with its launches in that ------
    # model's one timed fused greedy generate (counts zeroed just before it)
    if min(*launches_2x.values(), *launches_1x.values()) <= 0:
        fail(f"a kernel of the serving path was never launched: "
             f"2x {launches_2x}, 1x {launches_1x}")

    def entry(config, rec, launches, err):
        return {"name": rec["name"], "config": config, "route": rec["route"],
                "source": rec["source"],
                "replaces": rec["replaces"], "launches": launches,
                "max_abs_err": err, "errors": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"], "eager_ms": rec.get("eager_ms"),
                "shape": rec.get("timed_shape", rec["shape"]), "dtype": rec["dtype"]}

    emit({"kernels": [
        entry(name, rec, launches[rec["name"]], err)
        for name, launches in (("2x", launches_2x), ("1x", launches_1x))
        for rec, err in ((k1[name], k1[name]["max_abs_err"]["x_out"]),
                         (k2[name], k2[name]["max_abs_err"]))
    ], "card": card, "seconds_total": time.perf_counter() - t_start})

    # ---- 7. the contract line ---------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
