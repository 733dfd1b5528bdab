"""The check catches a broken timed path. The harness runs a small cell on
the CPU (the look for a chip skipped), the program in float32 so that a
sound run reads rounding alone, first sound (correct), then with each
fault of benchmark/faults.py planted under it (not correct): a step that
returns its state unchanged, half of the batch left out with the mean
taken over the rest, and in the served cells a token altered where it is
produced. One chip: no exchange between chips to leave out."""
import pytest
import torch

import tiny
from benchmark import faults, harness, registry

LIMITS = {"score_gap": 1e-3, "token_gap": 1e-3, "logit_err": 1e-3, "loss_gap": 1e-4,
          "grad_gap": 1e-2, "change_gap": 1e-2}
CELLS = {"tal-1x.eval-beam5": "eval-beam5", "tal-2x.serve-greedy-b128": "serve-greedy-b128",
         "tal-1x.train-b64x20s": "train-b64x20s"}


def run(cell, fault=None, seed=9):
    bench = registry.Bench()
    config = tiny.config(bench.cell(cell)["config"], compute_dtype="float32")
    with faults.planted(fault):
        return harness.run_cell(bench, cell, seed, 0.0, False, torch.device("cpu"),
                                config=config, mix=tiny.mix(CELLS[cell]),
                                limits={k: {"limit": v} for k, v in LIMITS.items()})


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS) for f in faults.NAMES
                                        if "train" not in c or f in faults.TRAINING])
def test_fault_is_not_correct(cell, fault):
    out = run(cell, fault)
    assert not out["correct"], out["checks"]
