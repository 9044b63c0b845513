"""Device: the share of the traced window in which no kernel, copy or
memset runs on the card."""

import devtrace


def read(t):
    if t.device is None or not t.device.intervals:
        return None
    t0, t1 = t.window
    busy, _ = devtrace.busy_and_gaps(t.device.intervals, t0, t1)
    return 100.0 * (1.0 - busy / (t1 - t0))
