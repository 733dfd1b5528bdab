"""Device time of the frontend and encoder a generate call: the kernels
launched inside the benchmark's `bench.encode` range (ASRModel.encode: K2,
the TDS encoder, the projection), per call, in ms."""


def read(r):
    ranges = r.profile.ranges.get("bench.encode") if r.traced() else None
    if not ranges:
        return None
    return 1e3 * sum(s for s, _ in ranges) / len(ranges)
