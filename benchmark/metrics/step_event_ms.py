"""Device step: the mean device milliseconds of the window's steps, from
the program's own counter: the device_ms of each step.submit span, read
from two timing events on the step's stream (after its payload is pinned,
and after its replay's output copies), graph replays included."""

import progtrace


def read(t):
    ms = [x.attrs["device_ms"] for s in progtrace.searches(t)
          for x in s.spans
          if x.name == "step.submit" and "device_ms" in x.attrs]
    return sum(ms) / len(ms) if ms else None
