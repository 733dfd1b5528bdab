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


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] not in ("ptxas", "build-time", "ab", "time-k1",
                                                 "checks"):
        sys.exit(__doc__)
    cmd = sys.argv[1]
    if cmd in ("ab", "time-k1") and len(sys.argv) != 3:
        sys.exit(__doc__)
    {"ptxas": ptxas, "build-time": build_time,
     "checks": lambda: checks(sys.argv[2] if len(sys.argv) > 2 else "kernels"),
     "ab": lambda: ab(sys.argv[2]), "time-k1": lambda: time_k1(sys.argv[2])}[cmd]()


if __name__ == "__main__":
    main()
