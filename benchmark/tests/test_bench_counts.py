"""benchmark/counts.py holds a frozen copy of the program's
tal_asrd_tpu_torch/utils/flops.py: the two agree at the cells' shapes."""
import json
import math
import os

import pytest

from benchmark import build, counts

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = [("tal-1x", "eval-beam5"), ("tal-2x", "serve-greedy-b128"),
         ("tal-1x", "train-b64x20s"), ("tal-2x", "train-b64x20s")]


def load(kind, name):
    with open(os.path.join(ROOT, "benchmark", kind, name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("config,traffic", CELLS)
def test_counts_equal_the_programs(config, traffic):
    from tal_asrd_tpu_torch.utils import flops
    cfg = load("configs", config)
    mix = load("traffic", traffic)
    ours, theirs = counts.Shape.of(cfg), build.model_config(cfg)
    if mix["kind"] == "generate":
        b, n = mix["batch"], int(round(mix["window_seconds"] * 16000))
        steps, beam = mix["max_new_tokens"], mix["beam"]
    else:
        b, n, steps, beam = mix["batch"], int(mix["max_seconds"] * 16000), 127, 1
    s = counts.enc_len(ours, n)
    assert s == flops.tds_output_length(flops.mel_frames(n), 3, 21)
    pairs = [
        (counts.encode_flops(ours, b, n), flops.encode_flops(theirs, b, n)),
        (counts.encode_bytes(ours, b, n), flops.encode_bytes(theirs, b, n)),
        (counts.greedy_decode_flops(ours, b, n, steps, beam),
         flops.greedy_decode_flops(theirs, b, n, steps, beam)),
        (counts.prefill_flops(ours, b * beam, s), flops.prefill_flops(theirs, b * beam, s)),
        (counts.decode_step_flops(ours, b * beam, steps, s),
         flops.decode_step_flops(theirs, b * beam, steps, s)),
        (counts.decode_step_bytes(ours, b * beam, steps, s),
         flops.decode_step_bytes(theirs, b * beam, steps, s)),
    ]
    for a, t in pairs:
        assert a == t


def test_training_is_three_forwards():
    sh = counts.Shape.of(load("configs", "tal-1x"))
    fwd = counts.teacher_forced_flops(sh, 64, 320000, 127)
    assert counts.train_step_flops(sh, 64, 320000, 127) == 3 * fwd
    # the decoder over 127 positions is the greedy count's 127 steps
    s = counts.enc_len(sh, 320000)
    assert math.isclose(fwd, counts.greedy_decode_flops(sh, 64, 320000, 127), rel_tol=1e-12)
    assert fwd > counts.encode_flops(sh, 64, 320000) + counts.prefill_flops(sh, 64, s)


def test_kernel_calls():
    # K1 at the eval cell: 320 lanes, D = 256, S = 340, the first index
    b, ops = counts.k1_call(320, 256, 340, 0)
    weights = 14 * 256 * 256 * 2
    assert b > weights + 2 * 320 * 340 * 256 * 2
    assert ops == 2.0 * 320 * (14 * 256 * 256 + 2 * 256 + 2 * 340 * 256)
    # 64 windows of 5 beams: one cross K/V and pad bias a window, not a lane
    shared, ops_shared = counts.k1_call(320, 256, 340, 0, windows=64)
    assert b - shared == (320 - 64) * (2 * 340 * 256 * 2 + 340 * 4) and ops_shared == ops
    calls = counts.k1_calls_of_generate(64, 5, 256, 340, 96, 4)
    assert calls[0] == (shared, ops) and len(calls) == 384
    # bytes-bound at every index of a generate
    for bb, oo in calls:
        assert bb / counts.PEAK_BYTES_PER_S > oo / counts.PEAK_FLOPS["bfloat16"]
    rows = 64 * counts.mel_frames(456960)
    b2, o2 = counts.k2_call(rows)
    assert b2 == 4.0 * (rows * 201 + 201 * 80 + rows * 80) and o2 == 2.0 * rows * 201 * 80
