"""K1's share of its roofline over the profiled generate calls: the sum over
its launches of the least time (the larger of its least bytes over 3.35
TB/s and its operations over 989 TFLOP/s, benchmark/counts.py; the cross
K/V counted once a window, as the beams of a window share it) over the sum
of their traced times, in %. Nothing when the trace holds another number of
launches than the calls make."""
from benchmark import counts


def read(r):
    if not r.traced():
        return None
    times = [s for name, s in r.profile.kernels if "cluster_step_kernel" in name]
    sh, mix = r.shape, r.mix
    n = int(round(mix["window_seconds"] * 16000))
    calls = counts.k1_calls_of_generate(mix["batch"], mix["beam"], sh.d_decoder,
                                        counts.enc_len(sh, n), mix["max_new_tokens"],
                                        sh.n_decoder_layers) * r.profile.calls
    if not times or len(times) != len(calls):
        return None
    least = sum(counts.least_seconds(b, ops, counts.PEAK_FLOPS["bfloat16"])
                for b, ops in calls)
    return 100.0 * least / sum(times)
