#!/usr/bin/env python3
"""Probes of the PyTorch port's CUDA kernels on one NVIDIA GPU, for the
questions chip_smoke.py does not answer. Imports torch and the port only.

    python3 scripts/torch_kernel_probe.py ptxas          # registers and spills per kernel
    python3 scripts/torch_kernel_probe.py build-time     # nvcc seconds per source, +- --split-compile
    python3 scripts/torch_kernel_probe.py ab PARENT_DIR  # K1 bf16 ms: PARENT_DIR's tree vs this
                                                         # one, alternating (parent, this, this, parent)
    python3 scripts/torch_kernel_probe.py serve-ab PARENT_DIR  # the 2x per-layer greedy generate,
                                                         # traced, with each tree (the same order)
    python3 scripts/torch_kernel_probe.py checks [PHASES]  # chip_smoke.py --phases PHASES (default
                                                         # kernels) with every miss printed instead
                                                         # of ending the run
    python3 scripts/torch_kernel_probe.py k2-designs     # K2 (3xTF32) vs its exact-FMA design
                                                         # (scripts/k2_exact_fma.cu) vs the library
    python3 scripts/torch_kernel_probe.py k3-plans       # K3 ms under its plan and the alternatives
    python3 scripts/torch_kernel_probe.py k1-plans       # the same for K1 (four layers' launches)
    python3 scripts/torch_kernel_probe.py k3-phases      # where K3's time goes, phase by phase
    python3 scripts/torch_kernel_probe.py k1-phases      # the same for K1 (one layer)

PARENT_DIR is an unpacked copy of another commit (`git archive`), in a
directory that .gitignore lists.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nvcc_cmd(src, extra=()):
    sys.path.insert(0, ROOT)
    from tal_asrd_tpu_torch.ops import _build
    flags = [f for f in _build.NVCC_FLAGS if not f.startswith("--split-compile")]
    return [_build._find_nvcc(), *flags, *extra, "-I", _build.CSRC_DIR, "-c", src,
            "-o", os.devnull]


def ptxas() -> None:
    sys.path.insert(0, ROOT)
    from tal_asrd_tpu_torch.ops import _build
    procs = [(src, subprocess.Popen(_nvcc_cmd(src, ["-Xptxas", "-v"]), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for src in _build.sources()]
    for src, proc in procs:
        out, _ = proc.communicate()
        print(f"== {os.path.basename(src)} rc {proc.returncode}")
        kernel, spill = None, ""
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and kernel:
                print(f"  {kernel[:90]}: {line.split('Used')[1].split(',')[0].strip()}; {spill}")
                kernel = None


def build_time() -> None:
    sys.path.insert(0, ROOT)
    from tal_asrd_tpu_torch.ops import _build
    for extra in ([], ["--split-compile=8"]):
        for src in _build.sources():
            t0 = time.perf_counter()
            res = subprocess.run(_nvcc_cmd(src, extra), capture_output=True, text=True)
            print(json.dumps({"source": os.path.basename(src), "flags": extra,
                              "rc": res.returncode,
                              "seconds": time.perf_counter() - t0}), flush=True)


def time_k1(tree: str) -> None:
    """K1 bf16 per launch at the 2x and 1x greedy serving shapes, with the
    package and chip_smoke.py of `tree` (run in a process of its own)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from tal_asrd_tpu_torch.ops import _build
    assert _build.__file__.startswith(tree), _build.__file__
    _build.load_library()
    out = {"tree": tree}
    for name, b, d, l_buf, index in (("2x", 32, 512, 97, 95), ("1x", 8, 256, 65, 63)):
        if hasattr(cs, "time_decode"):
            rec = cs.time_decode(torch, "cuda", "K1", "none", b, d, 4, 340, l_buf, index,
                                 torch.bfloat16)
        else:   # the first slice's script
            rec = cs.time_layer_step(torch, "cuda", b, d, 4, 340, l_buf, index, torch.bfloat16)
        out[name] = rec["ms"]
    print(json.dumps(out), flush=True)


def ab(parent: str) -> None:
    for tree in (parent, ROOT, ROOT, parent):
        res = subprocess.run([sys.executable, __file__, "time-k1", tree],
                             capture_output=True, text=True)
        print((res.stdout.strip().splitlines() or [res.stderr[-800:]])[-1], flush=True)


def serve_once(tree: str) -> None:
    """chip_smoke.py's `serve_2x` configuration (per-layer decoder, greedy
    B=32 x 96 tokens) with the package and chip_smoke.py of `tree`, its
    fused generate traced once (run in a process of its own): seconds per
    batch on the host clock, and the device's busy seconds and idle share."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    assert cs.__file__.startswith(tree), cs.__file__
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    recs = []
    cs.emit = recs.append
    audio = (np.random.default_rng(cs.SEED).standard_normal((32, cs.WINDOW_SAMPLES)) * 0.1
             ).astype(np.float32)
    cs.serve(torch, "cuda", "serve_2x", cs.build_2x(torch, "cuda"), audio, max_new=96,
             greedy_b=32, beam_b=None, trace=True)
    prof = next(r for r in recs if r.get("phase") == "profile")
    out = next(r for r in recs if r.get("phase") == "serve_2x")
    k1 = [e for e in prof["top_device"] if "cluster_step" in e["name"] or "layer_step" in e["name"]]
    print(json.dumps({"tree": tree, "card": _card(),
                      "seconds_per_batch_fused": out["greedy"]["seconds_per_batch_fused"],
                      "wall_seconds_traced": prof["wall_seconds_traced"],
                      "device_busy_seconds": prof["device_busy_seconds"],
                      "device_idle_share": prof["device_idle_share"],
                      "k1_device_ms": k1[0]["ms"] if k1 else None,
                      "launches": out["greedy"]["launches_per_generate"]}), flush=True)


def serve_ab(parent: str) -> None:
    for tree in (parent, ROOT, ROOT, parent):
        res = subprocess.run([sys.executable, __file__, "serve-once", tree],
                             capture_output=True, text=True)
        print((res.stdout.strip().splitlines() or [res.stderr[-800:]])[-1], flush=True)


def checks(phases: str) -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    misses = []

    def report(msg):
        misses.append(msg)
        print("MISS:", msg, flush=True)

    cs.fail = report
    sys.argv = ["chip_smoke.py", "--phases", phases]
    cs.main()
    print(json.dumps({"misses": len(misses)}))


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def k2_designs() -> None:
    """K2 as shipped (3xTF32 on the tensor cores) against its exact-FMA
    design (scripts/k2_exact_fma.cu, the same function with fmaf on the CUDA
    cores) and the library call, at the four path shapes: CUDA-graph replays
    (no host time) and each design's error against the plain version."""
    sys.path.insert(0, ROOT)
    import ctypes

    import torch

    import chip_smoke as cs
    from tal_asrd_tpu_torch.core.config import FrontendConfig
    from tal_asrd_tpu_torch.ops import _build
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project, logmel_project_plain
    from tal_asrd_tpu_torch.ops.logmel import mel_filterbank, power_spectrogram
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "libk2_exact_fma.so")
    subprocess.run([_build._find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
                    os.path.join(ROOT, "scripts", "k2_exact_fma.cu")], check=True)
    fma = ctypes.CDLL(so).tal_logmel_project_exact_fma
    fma.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    cfg = FrontendConfig()
    fb = torch.from_numpy(mel_filterbank(cfg.n_fft // 2 + 1, cfg.f_min, cfg.effective_f_max,
                                         cfg.n_mels, cfg.sample_rate)).cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for name, b, samples in (("serve_2x", 32, cs.WINDOW_SAMPLES), ("serve_1x", 8, cs.WINDOW_SAMPLES),
                             ("train_2x", 64, cs.TRAIN_SAMPLES), ("train_1x", 8, cs.TRAIN_SAMPLES)):
        audio = torch.randn((b, samples), device="cuda", generator=gen) * 0.1
        power = power_spectrogram(audio, cfg)
        power = power.reshape(-1, power.shape[-1]).contiguous()
        n, f = power.shape
        out = torch.empty((n, fb.shape[1]), device="cuda")

        def exact_fma():
            err = fma(power.data_ptr(), fb.data_ptr(), out.data_ptr(), n, f, fb.shape[1],
                      cfg.log_eps, sms, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        ref = logmel_project_plain(power, fb, cfg.log_eps)
        exact_fma()
        print(json.dumps({
            "shape": name, "N": n, "card": _card(),
            "tf32x3_ms": cs.time_graph_ms(lambda: fused_logmel_project(power, fb, cfg.log_eps), 20),
            "exact_fma_ms": cs.time_graph_ms(exact_fma, 20),
            "library_ms": cs.time_graph_ms(lambda: torch.log(power @ fb + cfg.log_eps), 20),
            "tf32x3_err": float((fused_logmel_project(power, fb, cfg.log_eps) - ref).abs().max()),
            "exact_fma_err": float((out - ref).abs().max())}), flush=True)


def _decode_run(cs, kern, op, l_buf):
    """One timed unit at the last step of a decode: K3 once, or K1 once for
    each of the four layers (their cross K/V, as the decode loop cycles them)."""
    if kern == "K3":
        step = cs.k3_step(op)[0]
        return lambda: step(op["xs"][0], op["ck"], op["cv"], l_buf - 2, 4)
    steps = [cs.k1_step(op, li)[0] for li in range(cs.N_LAYERS)]

    def run():
        for li, step in enumerate(steps):
            step(op["xs"][0], op["ck"][li], op["cv"][li], l_buf - 2, 4)
    return run


def plans(kern: str) -> None:
    """K1 or K3 at the 2x (B=32) and 1x (B=8) greedy shapes, last step of the
    decode, bf16 and kv8+w8: CUDA-graph replays (ms a launch) under the plan
    the wrapper picks and under the alternatives (every slot of 8-CTA
    clusters; a cluster per lane; all lanes in 4-lane groups of 16 CTAs, in
    waves; 8-lane groups of 16 CTAs)."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from tal_asrd_tpu_torch.ops import cuda_decode as cd
    from tal_asrd_tpu_torch.ops import cuda_decode_stacked as cds
    torch.backends.cuda.matmul.allow_tf32 = False
    wrapper, name = ((cd.fused_layer_step, "tal_layer_step") if kern == "K1" else
                     (cds.stacked_decoder_step, "tal_stacked_step"))
    per = cs.N_LAYERS if kern == "K1" else 1
    n_layers = 1 if kern == "K1" else cs.N_LAYERS
    for tag, b, d, l_buf in (("2x", 32, 512, 97), ("1x", 8, 256, 65)):
        inp = cs.seeded_decoder_inputs(torch, "cuda", cs.SEED + 7, b, d, 340, l_buf)
        for mode in ("none", "kv8+w8"):
            kv8, w8 = cs.MODES[mode]
            op = cs.realize(torch, inp, torch.bfloat16, mode)
            run = _decode_run(cs, kern, op, l_buf)
            run()
            chosen = wrapper.last_plan
            slots = cd.cluster_slots(name, torch.bfloat16, w8, kv8,
                                     (b, d, 4 * d, 4, l_buf, 340, 0, n_layers))
            alts = [chosen, cd.LaunchPlan(-(-b // min(slots[8], b)), 8, min(slots[8], b), slots[8]),
                    cd.LaunchPlan(1, 8, b, slots[8]), cd.LaunchPlan(4, 16, -(-b // 4), slots[16]),
                    cd.LaunchPlan(8, 16, -(-b // 8), slots[16])]
            orig = cd.launch_plan
            try:
                for i, plan in enumerate(alts):
                    if plan in alts[:i] or plan.group > cd.MAX_GROUP:
                        continue
                    cd.launch_plan = lambda *a, plan=plan, **k: plan
                    print(json.dumps({"kernel": kern, "shape": tag, "B": b, "mode": mode,
                                      "chosen": i == 0, "plan": plan.as_dict(),
                                      "ms": cs.time_graph_ms(run, 25) / per,
                                      "card": _card()}), flush=True)
            finally:
                cd.launch_plan = orig


# Stamps the trace copy takes: (pattern in csrc/cluster_step.cuh, where the
# stamp goes). A stamp is clock64() and %globaltimer, by thread 0 of a CTA.
_STAMPS = (
    ("  extern __shared__ __align__(16) float smem[];\n  cg::cluster_group cluster = cg::this_cluster();\n",
     "after", "reset"),
    ("cluster_wait();\n", "after", "stamp"),
    ("    ns = product_fma<TW>(W, K, N, c0, ncols, src, lds, c, m);\n  }\n", "after", "stamp"),
    ("  if (!(OP == OP_F2 && x_out != nullptr))\n", "before", "stamp"),
    ("  cluster_arrive();\n}\n", "before", "stamp"),
    ("  // softmax over the n logits\n", "before", "stamp"),
    ("  // out[c] = sum_r p[r] * v[r][c]", "before", "stamp"),
    ("    if (sub == 0) out[j] = s;\n  }\n  gr.sync();\n", "after", "stamp"),
    ("  cluster_arrive();\n\n  for (int l = 0;", "before", "stamp"),
    ("  cluster.sync();       // no CTA exits while its rows are read\n", "both", "stamp"),
)
_SEGMENTS = [f"{p} {s}" for p, kind in (("P1", "mma"), ("P2", "att"), ("P3", "mma"), ("P4", "mma"),
                                        ("P5", "att"), ("P6", "mma"), ("P7", "mma"), ("P8", "mma"))
             for s in (("wait", "product", "epilogue", "push") if kind == "mma" else
                       ("wait", "logits", "softmax", "pv"))]
_TRACE_SOURCE = {"K1": "layer_step.cu", "K3": "stacked_step.cu"}


def phases(kern: str) -> None:
    """Where K1's or K3's time goes, phase by phase: the package is copied
    into tal_asrd_tpu_torch/_build/phase_trace/ with time stamps added to
    csrc/cluster_step.cuh (each kernel source keeps its own stamp buffer), the
    kernel runs once per shape and mode under its own plan (after warm-up),
    and the stamps of CTA 0 give each phase's segments (cluster wait,
    product, epilogue, push; or wait, logits, softmax, PV), averaged over the
    layers, in microseconds, and the launch's prologue (input load, attn rows
    zeroed; the first segment) and epilogue (the wait for the last layer,
    the attn rows added, the last cluster barrier). The launch itself, before
    the first stamp, is what the replay time has beyond kernel_us."""
    sys.path.insert(0, ROOT)
    import shutil

    from tal_asrd_tpu_torch.ops import _build
    tree = os.path.join(_build.BUILD_DIR, "phase_trace")
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.dirname(_build.CSRC_DIR), os.path.join(tree, "tal_asrd_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(tree, "tal_asrd_tpu_torch", "csrc")
    src = os.path.join(csrc, "cluster_step.cuh")
    text = open(src).read()
    stamp = ("if (threadIdx.x == 0) { unsigned long long t_; "
             "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
             "const int e_ = stamp_n[blockIdx.x]; stamps[blockIdx.x * 512 + e_] = clock64(); "
             "stamps[blockIdx.x * 512 + 256 + e_] = t_; stamp_n[blockIdx.x] = e_ + 1; }\n")
    for pattern, where, what in _STAMPS:
        if pattern not in text:
            sys.exit(f"phases: csrc/cluster_step.cuh no longer has {pattern!r}")
        code = ("if (threadIdx.x == 0) stamp_n[blockIdx.x] = 0;\n" + stamp) if what == "reset" else stamp
        text = text.replace(pattern, {"after": pattern + code, "before": code + pattern,
                                      "both": code + pattern + code}[where])
    text = text.replace("namespace {\n", "namespace {\n"
                        "__device__ unsigned long long stamps[1024 * 512];\n"
                        "__device__ int stamp_n[1024];\n", 1)
    open(src, "w").write(text)
    for k, name in _TRACE_SOURCE.items():     # each source reads its own buffer
        with open(os.path.join(csrc, name), "a") as f:
            f.write(f'\nextern "C" int tal_{k.lower()}_stamps(void* out, int clear) {{\n'
                    '  if (clear) { void* p = nullptr; cudaGetSymbolAddress(&p, stamps);\n'
                    '    return (int)cudaMemset(p, 0, sizeof(stamps)); }\n'
                    '  return (int)cudaMemcpyFromSymbol(out, stamps, sizeof(stamps));\n}\n')
    res = subprocess.run([sys.executable, __file__, "phases-run", kern, tree])
    sys.exit(res.returncode)


def phases_run(kern: str, tree: str) -> None:
    sys.path.insert(0, tree)
    sys.path.insert(1, ROOT)
    import ctypes

    import numpy as np
    import torch

    import chip_smoke as cs
    from tal_asrd_tpu_torch.ops import _build
    from tal_asrd_tpu_torch.ops import cuda_decode as cd
    from tal_asrd_tpu_torch.ops import cuda_decode_stacked as cds
    assert cd.__file__.startswith(tree), cd.__file__
    fn = getattr(_build.load_library(), f"tal_{kern.lower()}_stamps")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    wrapper = cd.fused_layer_step if kern == "K1" else cds.stacked_decoder_step
    n_layers = 1 if kern == "K1" else cs.N_LAYERS
    for tag, b, d, l_buf in (("2x", 32, 512, 97), ("1x", 8, 256, 65)):
        inp = cs.seeded_decoder_inputs(torch, "cuda", cs.SEED + 7, b, d, 340, l_buf)
        for mode in ("none", "kv8", "w8", "kv8+w8"):
            op = cs.realize(torch, inp, torch.bfloat16, mode)
            if kern == "K1":
                step = cs.k1_step(op)[0]
                run = lambda: step(op["xs"][0], op["ck"][0], op["cv"][0], l_buf - 2, 4)
            else:
                step = cs.k3_step(op)[0]
                run = lambda: step(op["xs"][0], op["ck"], op["cv"], l_buf - 2, 4)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            assert fn(None, 1) == 0
            run()
            torch.cuda.synchronize()
            buf = np.zeros((1024, 512), dtype=np.uint64)
            assert fn(buf.ctypes.data, 0) == 0
            cyc, ns = buf[0, :256].astype(np.int64), buf[0, 256:].astype(np.int64)
            n_ev = int((cyc > 0).sum())
            per_layer = len(_SEGMENTS)
            if n_ev != 5 + n_layers * per_layer:
                print(json.dumps({"kernel": kern, "shape": tag, "mode": mode, "stamps": n_ev,
                                  "note": "CTA 0 holds other than one attention item"}))
                continue
            scale = (ns[n_ev - 1] - ns[0]) / (cyc[n_ev - 1] - cyc[0]) / 1e3   # us a cycle
            # [prologue, layers x per_layer segments, final wait, attn rows, last barrier]
            seg = np.diff(cyc[:n_ev]) * scale
            layers = seg[1:1 + n_layers * per_layer].reshape(n_layers, per_layer).mean(axis=0)
            print(json.dumps({
                "kernel": kern, "shape": tag, "B": b, "mode": mode,
                "plan": wrapper.last_plan.as_dict(), "card": _card(),
                "kernel_us": float((ns[n_ev - 1] - ns[0]) / 1e3),
                "prologue_us": round(float(seg[0]), 3),
                "epilogue_us": {k: round(float(v), 3) for k, v in zip(
                    ("final wait", "attn rows", "last barrier"), seg[-3:])},
                "per_layer_us": {k: round(float(v), 3) for k, v in zip(_SEGMENTS, layers)}}),
                flush=True)


def main() -> None:
    cmds = {"ptxas": ptxas, "build-time": build_time,
            "checks": lambda: checks(sys.argv[2] if len(sys.argv) > 2 else "kernels"),
            "ab": lambda: ab(sys.argv[2]), "time-k1": lambda: time_k1(sys.argv[2]),
            "serve-ab": lambda: serve_ab(sys.argv[2]), "serve-once": lambda: serve_once(sys.argv[2]),
            "k2-designs": k2_designs,
            "k1-plans": lambda: plans("K1"), "k3-plans": lambda: plans("K3"),
            "k1-phases": lambda: phases("K1"), "k3-phases": lambda: phases("K3"),
            "phases-run": lambda: phases_run(sys.argv[2], sys.argv[3])}
    if len(sys.argv) < 2 or sys.argv[1] not in cmds:
        sys.exit(__doc__)
    cmd = sys.argv[1]
    if cmd in ("ab", "time-k1", "serve-ab", "serve-once") and len(sys.argv) != 3 or cmd == "phases-run" and len(sys.argv) != 4:
        sys.exit(__doc__)
    cmds[cmd]()


if __name__ == "__main__":
    main()
