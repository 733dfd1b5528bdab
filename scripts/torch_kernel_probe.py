#!/usr/bin/env python3
"""Probes of the PyTorch port's CUDA kernels on one NVIDIA GPU, for the
questions chip_smoke.py does not answer. Imports torch and the port only.

    python3 scripts/torch_kernel_probe.py ptxas          # registers and spills per kernel
    python3 scripts/torch_kernel_probe.py build-time     # nvcc seconds per source, +- --split-compile
    python3 scripts/torch_kernel_probe.py ab PARENT_DIR  # K1 bf16 ms: PARENT_DIR's tree vs this
                                                         # one, alternating (parent, this, this, parent)
    python3 scripts/torch_kernel_probe.py checks [PHASES]  # chip_smoke.py --phases PHASES (default
                                                         # kernels) with every miss printed instead
                                                         # of ending the run
    python3 scripts/torch_kernel_probe.py k2-designs     # K2 (3xTF32) vs its exact-FMA design
                                                         # (scripts/k2_exact_fma.cu) vs the library
    python3 scripts/torch_kernel_probe.py k3-plans       # K3 ms under its plan and the alternatives
    python3 scripts/torch_kernel_probe.py k3-phases      # where K3's time goes, phase by phase

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


def k3_plans() -> None:
    """K3 at the 2x (B=32) and 1x (B=8) greedy shapes, last step of the
    decode, bf16 and kv8+w8: CUDA-graph replays under the plan the wrapper
    picks and under the alternatives (every slot of 8-CTA clusters; a cluster
    per lane; all lanes in 4-lane groups of 16 CTAs, in waves)."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from tal_asrd_tpu_torch.ops import cuda_decode_stacked as cds
    torch.backends.cuda.matmul.allow_tf32 = False
    for tag, b, d, l_buf in (("2x", 32, 512, 97), ("1x", 8, 256, 65)):
        inp = cs.seeded_decoder_inputs(torch, "cuda", cs.SEED + 7, b, d, 340, l_buf)
        for mode in ("none", "kv8+w8"):
            kv8, w8 = cs.MODES[mode]
            op = cs.realize(torch, inp, torch.bfloat16, mode)
            step = cs.k3_step(op)[0]
            run = lambda: step(op["xs"][0], op["ck"], op["cv"], l_buf - 2, 4)
            run()
            chosen = cds.stacked_decoder_step.last_plan
            slots = cds.cluster_slots(torch.bfloat16, w8, kv8, (b, d, 4 * d, 4, l_buf, 340, 0, 4))
            plans = [chosen, cds.LaunchPlan(-(-b // min(slots[8], b)), 8, min(slots[8], b), slots[8]),
                     cds.LaunchPlan(1, 8, b, slots[8]), cds.LaunchPlan(4, 16, -(-b // 4), slots[16])]
            orig = cds.launch_plan
            try:
                for i, plan in enumerate(plans):
                    if plan in plans[:i] or plan.group > cds.MAX_GROUP:
                        continue
                    cds.launch_plan = lambda *a, plan=plan, **k: plan
                    print(json.dumps({"shape": tag, "B": b, "mode": mode, "chosen": i == 0,
                                      "plan": dataclass_dict(plan), "ms": cs.time_graph_ms(run, 25),
                                      "card": _card()}), flush=True)
            finally:
                cds.launch_plan = orig


def dataclass_dict(plan) -> dict:
    return {"group": plan.group, "cluster": plan.cluster, "clusters": plan.clusters,
            "ctas": plan.ctas, "slots": plan.slots, "waves": plan.waves}


# Stamps K3's trace copy takes: (pattern in csrc/stacked_step.cu, where the
# stamp goes). A stamp is clock64() and %globaltimer, by thread 0 of a CTA.
_K3_STAMPS = (
    ("  extern __shared__ __align__(16) float smem[];\n  cg::cluster_group cluster = cg::this_cluster();\n",
     "after", "reset"),
    ("cluster_wait();\n", "after", "stamp"),
    ("    ns = product_fma<TW>(W, K, N, c0, ncols, src, lds, c, m);\n  }\n", "after", "stamp"),
    ("  if (!(OP == OP_F2 && x_out != nullptr))\n", "before", "stamp"),
    ("  cluster_arrive();\n}\n", "before", "stamp"),
    ("  // softmax over the n logits\n", "before", "stamp"),
    ("  // out[c] = sum_r p[r] * v[r][c]", "before", "stamp"),
    ("    if (sub == 0) out[j] = s;\n  }\n  gr.sync();\n", "after", "stamp"),
)
_K3_SEGMENTS = [f"{p} {s}" for p, kind in (("P1", "mma"), ("P2", "att"), ("P3", "mma"), ("P4", "mma"),
                                           ("P5", "att"), ("P6", "mma"), ("P7", "mma"), ("P8", "mma"))
                for s in (("wait", "product", "epilogue", "push") if kind == "mma" else
                          ("wait", "logits", "softmax", "pv"))]


def k3_phases() -> None:
    """Where K3's time goes, phase by phase: the package is copied into
    tal_asrd_tpu_torch/_build/k3_trace/ with time stamps added to
    csrc/stacked_step.cu, K3 runs once per shape and mode under its own plan
    (after warm-up), and the stamps of CTA 0 give each phase's segments
    (cluster wait, product, epilogue, push; or wait, logits, softmax, PV),
    averaged over the 4 layers, in microseconds."""
    sys.path.insert(0, ROOT)
    import shutil

    from tal_asrd_tpu_torch.ops import _build
    tree = os.path.join(_build.BUILD_DIR, "k3_trace")
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.dirname(_build.CSRC_DIR), os.path.join(tree, "tal_asrd_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = os.path.join(tree, "tal_asrd_tpu_torch", "csrc", "stacked_step.cu")
    text = open(src).read()
    stamp = ("if (threadIdx.x == 0) { unsigned long long t_; "
             "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
             "const int e_ = k3_stamp_n[blockIdx.x]; k3_stamps[blockIdx.x * 512 + e_] = clock64(); "
             "k3_stamps[blockIdx.x * 512 + 256 + e_] = t_; k3_stamp_n[blockIdx.x] = e_ + 1; }\n")
    for pattern, where, what in _K3_STAMPS:
        if pattern not in text:
            sys.exit(f"k3-phases: csrc/stacked_step.cu no longer has {pattern!r}")
        code = ("if (threadIdx.x == 0) k3_stamp_n[blockIdx.x] = 0;\n" + stamp) if what == "reset" else stamp
        text = text.replace(pattern, pattern + code if where == "after" else code + pattern)
    text = text.replace("namespace cg = cooperative_groups;\n",
                        "namespace cg = cooperative_groups;\n"
                        "__device__ unsigned long long k3_stamps[1024 * 512];\n"
                        "__device__ int k3_stamp_n[1024];\n", 1)
    text += ('\nextern "C" int tal_k3_stamps(void* out, int clear) {\n'
             '  if (clear) { void* p = nullptr; cudaGetSymbolAddress(&p, k3_stamps);\n'
             '    return (int)cudaMemset(p, 0, sizeof(k3_stamps)); }\n'
             '  return (int)cudaMemcpyFromSymbol(out, k3_stamps, sizeof(k3_stamps));\n}\n')
    open(src, "w").write(text)
    res = subprocess.run([sys.executable, __file__, "k3-phases-run", tree])
    sys.exit(res.returncode)


def k3_phases_run(tree: str) -> None:
    sys.path.insert(0, tree)
    sys.path.insert(1, ROOT)
    import ctypes

    import numpy as np
    import torch

    import chip_smoke as cs
    from tal_asrd_tpu_torch.ops import _build
    from tal_asrd_tpu_torch.ops import cuda_decode_stacked as cds
    assert cds.__file__.startswith(tree), cds.__file__
    fn = _build.load_library().tal_k3_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for tag, b, d, l_buf in (("2x", 32, 512, 97), ("1x", 8, 256, 65)):
        inp = cs.seeded_decoder_inputs(torch, "cuda", cs.SEED + 7, b, d, 340, l_buf)
        for mode in ("none", "kv8+w8"):
            op = cs.realize(torch, inp, torch.bfloat16, mode)
            step = cs.k3_step(op)[0]
            for _ in range(3):
                step(op["xs"][0], op["ck"], op["cv"], l_buf - 2, 4)
            torch.cuda.synchronize()
            assert fn(None, 1) == 0
            step(op["xs"][0], op["ck"], op["cv"], l_buf - 2, 4)
            torch.cuda.synchronize()
            buf = np.zeros((1024, 512), dtype=np.uint64)
            assert fn(buf.ctypes.data, 0) == 0
            cyc, ns = buf[0, :256].astype(np.int64), buf[0, 256:].astype(np.int64)
            n_ev = int((cyc > 0).sum())
            per_layer = len(_K3_SEGMENTS)
            if n_ev != 2 + 4 * per_layer:
                print(json.dumps({"shape": tag, "mode": mode, "stamps": n_ev,
                                  "note": "CTA 0 holds other than one attention item"}))
                continue
            scale = (ns[n_ev - 1] - ns[0]) / (cyc[n_ev - 1] - cyc[0]) / 1e3   # us a cycle
            seg = np.diff(cyc[:n_ev]) * scale        # [4 x per_layer segments, final wait]
            layers = seg[:4 * per_layer].reshape(4, per_layer).mean(axis=0)
            print(json.dumps({"shape": tag, "B": b, "mode": mode, "plan": dataclass_dict(
                cds.stacked_decoder_step.last_plan), "card": _card(),
                "kernel_us": float((ns[n_ev - 1] - ns[0]) / 1e3),
                "per_layer_us": {k: round(float(v), 3) for k, v in zip(_K3_SEGMENTS, layers)}}),
                flush=True)


def main() -> None:
    cmds = {"ptxas": ptxas, "build-time": build_time,
            "checks": lambda: checks(sys.argv[2] if len(sys.argv) > 2 else "kernels"),
            "ab": lambda: ab(sys.argv[2]), "time-k1": lambda: time_k1(sys.argv[2]),
            "k2-designs": k2_designs, "k3-plans": k3_plans, "k3-phases": k3_phases,
            "k3-phases-run": lambda: k3_phases_run(sys.argv[2])}
    if len(sys.argv) < 2 or sys.argv[1] not in cmds:
        sys.exit(__doc__)
    cmd = sys.argv[1]
    if cmd in ("ab", "time-k1", "k3-phases-run") and len(sys.argv) != 3:
        sys.exit(__doc__)
    cmds[cmd]()


if __name__ == "__main__":
    main()
