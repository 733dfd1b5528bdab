"""Share of the profiled stretch of training steps in which no operation ran
on the device, in %."""


def read(r):
    if not r.traced():
        return None
    return 100.0 * (1.0 - r.profile.busy_s / r.profile.wall_s)
