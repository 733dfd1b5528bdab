"""The control at each cell's own size, on the card: the plain reference in
fp8 put in the program's place fails at least one of the cell's limits on
every seed, while the program passes them (three seeds each; a window of
one step in training, of 5 s in serving, which holds the calls that the
checked rows are drawn from). The
program's own int8 decode path is no control: it reads within 1.6 x of bf16
on every number (PERF.md). Marked `gpu`; run on a machine with the card:

    python -m pytest benchmark/tests/test_bench_control.py -q
"""
import pytest
import torch

from benchmark import harness, registry

SEEDS = (9001, 9002, 9003)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in registry.Bench().spec["workloads"]])
def test_control_fails_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench = registry.Bench()
    w = bench.cell(cell)
    config, mix, limits = bench.config(w["config"]), bench.mix(w["traffic"]), bench.limits(cell)
    seconds = 5.0 if mix["kind"] == "generate" else 0.0
    for seed in SEEDS:
        run = registry.kind_module(mix["kind"]).Run(config, mix, seed, torch.device("cuda", 0))
        run.setup()
        run.window(seconds)
        run.release()
        ok, checks = harness.judge(run.check(), limits)
        assert ok, checks
        ok, checks = harness.judge(run.check(control=True), limits)
        assert not ok, checks
        del run
        torch.cuda.empty_cache()
