"""device_idle: the share of the profiled stretch in which the device
ran nothing (no kernel, copy or fill), from the profiler's trace."""

UNIT = "%"


def read(run):
    if run.profile is None or run.profile.window_s <= 0:
        return None
    return 100.0 * run.profile.idle_share
