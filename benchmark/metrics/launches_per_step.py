"""Device operations a decode step: the kernels and copies launched inside
the benchmark's `bench.search` range (beam_search and the fused step), over
the profiled calls' decode steps."""


def read(r):
    ranges = r.profile.ranges.get("bench.search") if r.traced() else None
    if not ranges:
        return None
    return sum(n for _, n in ranges) / (len(ranges) * r.mix["max_new_tokens"])
