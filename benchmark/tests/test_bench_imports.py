"""What the benchmark loads: no JAX, no Flax, no optax and not the JAX
package (top-level module names compared whole: tal_asrd_tpu_torch is the
system under test, tal_asrd_tpu is not), and a reference that loads nothing
of the program. Each check runs in a fresh interpreter."""
import json
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "tal_asrd_tpu"]

LOAD_ALL = """
import glob, json, os, runpy, sys
sys.argv = ["run.py", "--help"]
try:
    runpy.run_path("benchmark/run.py", run_name="__main__")
except SystemExit:
    pass
import torch
from benchmark import registry, harness, drive_generate, drive_train, faults, reference
from benchmark.tests import tiny
bench = registry.Bench()
for m in bench.spec["per_layer"]:
    bench.reader(m["name"])
for c in bench.spec["configs"]:
    bench.config(c["name"])
for path in glob.glob("benchmark/traffic/*.json"):
    json.load(open(path))
# a whole run of a small cell on the CPU loads what the program loads
harness.run_cell(bench, "tal-1x.eval-beam5", 3, 0.0, True, torch.device("cpu"),
                 config=tiny.config(), mix=tiny.mix("eval-beam5"), limits={})
harness.run_cell(bench, "tal-1x.train-b64x20s", 3, 0.0, False, torch.device("cpu"),
                 config=tiny.config(), mix=tiny.mix("train-b64x20s"), limits={})
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

LOAD_REFERENCE = """
import json, sys
from benchmark import reference
print(json.dumps(sorted(sys.modules)))
"""


def loaded(code):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_benchmark_loads_no_jax():
    tops = loaded("import sys; sys.path.insert(0, '.')\n" + LOAD_ALL)
    assert "tal_asrd_tpu_torch" in tops and "torch" in tops
    assert not set(FORBIDDEN) & set(tops), sorted(set(FORBIDDEN) & set(tops))


def test_reference_loads_nothing_of_the_program():
    mods = loaded("import sys; sys.path.insert(0, '.')\n" + LOAD_REFERENCE)
    assert "benchmark.reference" in mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN + ["tal_asrd_tpu_torch"]]


def test_forbidden_names_are_whole(monkeypatch):
    from benchmark.harness import forbidden_modules
    for name in ("tal_asrd_tpu_torch.probe", "jaxtyping", "flaxen.probe"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not set(forbidden_modules()) & {"tal_asrd_tpu", "jax", "flax"}
    monkeypatch.setitem(sys.modules, "tal_asrd_tpu.core", types.ModuleType("tal_asrd_tpu.core"))
    assert "tal_asrd_tpu" in forbidden_modules()


def test_no_result_when_a_forbidden_module_loads_after_the_window(monkeypatch, capsys):
    """A module loaded after the window (a metric's reader, the reference)
    that is on the forbidden list stops the run before its result's line."""
    import torch
    from benchmark import harness

    def run_cell(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
                "checks": {}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", run_cell)
    rc = harness.main(["--workload", "tal-1x.eval-beam5", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0
    assert "{" not in out.out
    assert "jax" in out.err
