"""K2's share of its roofline over the profiled generate calls: one launch a
call over every frame of the batch; the least time (bytes over 3.35 TB/s or
operations over the TF32 tensor cores' 494.7 TFLOP/s, benchmark/counts.py)
over the traced time, in %."""
from benchmark import counts


def read(r):
    if not r.traced():
        return None
    times = [s for name, s in r.profile.kernels if "logmel_project_kernel" in name]
    if not times or len(times) != r.profile.calls:
        return None
    n = int(round(r.mix["window_seconds"] * 16000))
    b, ops = counts.k2_call(r.mix["batch"] * counts.mel_frames(n))
    least = len(times) * counts.least_seconds(b, ops, counts.PEAK_FLOPS["tf32"])
    return 100.0 * least / sum(times)
