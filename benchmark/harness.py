"""One run of one cell: set-up, the measured window, the traced stretch, the
check, and the result's line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

With `--trace 0` the result's metrics are the cell's end-to-end metrics;
with `--trace 1` its per-layer metrics, read by metrics/<name>.py from the
window's host spans and counts and from a profiled stretch of
`trace_calls` (`trace_steps`) more calls after it. Both check the outputs
against the plain reference and print each number compared beside its
limit, last on standard error and last in the result's line (`checks`).

`--calibrate` (never used by a check) runs the cell at its own size once a
seed in one process, with a window of `--seconds`, and prints a line a seed
of the numbers the check compares: the program's, with `--fault NAME`
planted under it (benchmark/faults.py), and with `--control` also those of
the float32 reference against the fp8 reference in the program's place.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

T_IMPORT = time.time()

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tal_asrd_tpu")
GIB = 2.0 ** 30


def process_age() -> float:
    """Seconds since this process started (its start time from /proc), or
    since this module was imported where /proc has none."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - T_IMPORT


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> Tuple[bool, Dict[str, dict]]:
    """Every number at or under its limit; a number without a limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            ok = False
    return ok, checks


def run_cell(bench, workload: str, seed: int, seconds: float, trace: bool, device,
             config: Optional[dict] = None, mix: Optional[dict] = None,
             limits: Optional[dict] = None) -> dict:
    """One run; returns the result's line as a dict. `config`, `mix` and
    `limits` replace the cell's own (the CPU tests' small sizes)."""
    import torch
    from benchmark import registry, trace as tracing
    cell = bench.cell(workload)
    config = config or bench.config(cell["config"])
    mix = mix or bench.mix(cell["traffic"])
    limits = bench.limits(workload) if limits is None else limits
    on_card = device.type == "cuda"
    run = registry.kind_module(mix["kind"]).Run(config, mix, seed, device)
    before = process_age()
    run.setup()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age()
    print(f"set-up: {before:.2f} s of start-up and imports, "
          f"{setup_s - before:.2f} s of the cell's own", file=sys.stderr)
    spans: Optional[Dict[str, List[float]]] = {} if trace else None
    stats = run.window(seconds, spans)
    if stats.get("call_s"):
        import numpy as np
        q = np.percentile(stats["call_s"], [10, 50, 90])
        print(f"call seconds p10 {q[0]:.4f} p50 {q[1]:.4f} p90 {q[2]:.4f}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    profile = tracing.run_profiled(run.traced, device) if trace else None
    failed = run.failed()
    run.release()
    ok, checks = judge(run.check(), limits)
    attempted = stats["attempted"]
    result = {"correct": bool(ok and failed == 0 and attempted > 0),
              "attempted": attempted, "failed": failed}
    if trace:
        from benchmark.reading import Reading
        reading = Reading(config=config, mix=mix, stats=stats, spans=spans, profile=profile)
        metrics = {}
        for m in bench.per_layer(workload):
            value = bench.reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.end_to_end(stats), setup_s=setup_s, peak_mem_gib=peak / GIB)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench.end_to_end(workload)}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if on_card else device.type,
                        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                        "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        result["device"]["busy_s"] = profile.busy_s
        result["device"]["window_s"] = profile.wall_s
        result["breakdown"] = {"device_ops": profile.top_kernels(),
                               "idle_gaps": profile.top_gaps()}
    result["checks"] = checks
    return result


def calibrate(bench, workload: str, seeds: List[int], seconds: float, device,
              control: bool, fault: Optional[str]) -> None:
    import torch
    from benchmark import faults, registry
    cell = bench.cell(workload)
    config, mix = bench.config(cell["config"]), bench.mix(cell["traffic"])
    for seed in seeds:
        run = registry.kind_module(mix["kind"]).Run(config, mix, seed, device)
        t0 = time.perf_counter()
        with faults.planted(fault):
            run.setup()
            stats = run.window(seconds)
        failed = run.failed()
        run.release()
        line = {"workload": workload, "seed": seed, "fault": fault,
                "attempted": stats["attempted"], "failed": failed,
                "program": run.check(detail=True)}
        if control:
            line["control"] = run.check(control=True, detail=True)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", action="store_true")
    p.add_argument("--seeds", type=int, default=1, help="with --calibrate: seeds from --seed on")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)

    from benchmark import registry
    try:
        bench = registry.Bench()
        cell = bench.cell(args.workload)
        import torch
        import tal_asrd_tpu_torch  # noqa: F401  (the system under test)
    except (OSError, KeyError, ImportError) as e:
        print(f"cannot run {args.workload}: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    if args.calibrate:
        calibrate(bench, args.workload, list(range(args.seed, args.seed + args.seeds)),
                  args.seconds, device, args.control, args.fault)
        return 0
    if args.trace:
        print(f"card: {power_limit()}", file=sys.stderr)
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), device)
    from tal_asrd_tpu_torch.ops import _build
    print(f"nvcc build seconds: {_build.build_seconds}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded after the window: {found}; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
