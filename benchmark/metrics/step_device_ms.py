"""Device step: milliseconds of device time (kernels, copies and memsets,
graph replays included, from the profiler's device timeline) in the
traced window, per device step the panel managers counted."""

import devtrace


def read(t):
    if t.device is None:
        return None
    steps = sum(s["stats"].get("steps", 0) for s in t.searches
                if s["stats"])
    sec = sum(devtrace.by_name(devtrace.clipped(t.device.intervals,
                                                *t.window)).values())
    return 1e3 * sec / steps if steps and sec > 0 else None
