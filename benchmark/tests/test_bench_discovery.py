"""A new traffic mix and a new per-layer metric are new files and new
entries in BENCHMARK.json: in a copy of the benchmark's folder, the
harness finds a dummy mix and a dummy metric by their names, with no other
file changed, and a whole small run reports the metric."""
import json
import os
import shutil

import torch

import tiny
from benchmark import harness, registry

ROOT = tiny.ROOT


def test_new_mix_and_metric_are_found(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    before = {p: open(p, "rb").read() for p in
              map(str, (tmp_path / "benchmark").rglob("*")) if os.path.isfile(p)}

    mix = tiny.mix("serve-greedy-b128", batch=2, max_new_tokens=4)
    (tmp_path / "benchmark" / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark" / "metrics" / "dummy_calls.py").write_text(
        "def read(r):\n    return float(r.stats['calls'])\n")
    spec["workloads"].append({"name": "tal-1x.dummy-mix", "config": "tal-1x",
                              "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("tal-1x.dummy-mix")
    spec["per_layer"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "decode loop",
                              "moves": "decode_audio_s_per_s",
                              "workloads": ["tal-1x.dummy-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = registry.Bench(root=str(tmp_path), folder=str(tmp_path / "benchmark"))
    assert bench.mix("dummy-mix") == mix
    names = [m["name"] for m in bench.per_layer("tal-1x.dummy-mix")]
    assert "dummy_calls" in names and "mfu.decode" not in names
    assert bench.reader("dummy_calls") is not None
    out = harness.run_cell(bench, "tal-1x.dummy-mix", 4, 0.0, True, torch.device("cpu"),
                           config=tiny.config(), limits={})
    assert out["metrics"]["dummy_calls"] == {"value": 1.0, "unit": "calls"}
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
