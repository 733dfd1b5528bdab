"""The whole generate's share of the card's bf16 dense peak (989 TFLOP/s):
the FLOPs of the window's calls (benchmark/counts.py, encode, prefill and
the decode steps of every lane) over the window's wall time, in %."""
from benchmark import counts


def read(r):
    calls, wall = r.stats.get("calls"), r.stats.get("wall_s")
    if not calls or not wall:
        return None
    mix = r.mix
    n = int(round(mix["window_seconds"] * 16000))
    flops = calls * counts.greedy_decode_flops(r.shape, mix["batch"], n, mix["max_new_tokens"],
                                               mix["beam"])
    return 100.0 * flops / (wall * counts.PEAK_FLOPS["bfloat16"])
