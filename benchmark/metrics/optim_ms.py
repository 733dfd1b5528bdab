"""Device time of the optimizer a training step: the kernels launched inside
PyTorch's own `Optimizer.step#...` range (LAMB's loops over the
parameters), per step, in ms."""


def read(r):
    if not r.traced():
        return None
    ranges = [x for name, xs in r.profile.ranges.items()
              if name.startswith("Optimizer.step#") for x in xs]
    if not ranges:
        return None
    return 1e3 * sum(s for s, _ in ranges) / len(ranges)
