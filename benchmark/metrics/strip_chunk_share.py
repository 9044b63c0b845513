"""Kernels: the share of the screen_dp chunks the window's steps queued
that run on the kernel's strip path (windows wider than its widest
register width), from the counters screen.chunks.strip and
screen.chunks.reg the program counts at each step's submission."""

import progtrace


def read(t):
    ss = progtrace.searches(t)
    strip = sum(s.counters.get("screen.chunks.strip", 0) for s in ss)
    reg = sum(s.counters.get("screen.chunks.reg", 0) for s in ss)
    return 100.0 * strip / (strip + reg) if strip + reg else None
