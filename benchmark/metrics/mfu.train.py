"""The whole training step's share of the card's bf16 dense peak (989
TFLOP/s): the FLOPs of the window's steps at their padded shapes
(benchmark/counts.py: three times the forward) over the window's wall
time, in %."""
from benchmark import counts


def read(r):
    shapes, wall = r.stats.get("shapes"), r.stats.get("wall_s")
    if not shapes or not wall:
        return None
    b = r.mix["batch"]
    flops = sum(counts.train_step_flops(r.shape, b, t, l) for t, l in shapes)
    return 100.0 * flops / (wall * counts.PEAK_FLOPS["bfloat16"])
