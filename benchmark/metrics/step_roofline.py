"""Kernels: the sum over the window's device steps of each step's least
time (roofline.least_seconds) over the device time of all kernels in the
traced window."""

import devtrace
import roofline


def read(t):
    if t.device is None or not t.split.steps:
        return None
    kernels = sum(devtrace.by_name(devtrace.clipped(t.device.intervals,
                                                    *t.window),
                                   ("kernel",)).values())
    least = sum(roofline.least_seconds(s) for s in t.split.steps)
    return 100.0 * least / kernels if kernels > 0 and least > 0 else None
