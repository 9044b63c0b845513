"""Device step: the mean milliseconds of a step.group span (one panel
group's part of step.submit on the main thread: its fragments packed and
its step queued), over every such span of the window's searches; the
program's own span."""

import progtrace


def read(t):
    ms = [1e3 * (x.end - x.start) for s in progtrace.searches(t)
          for x in s.spans if x.name == "step.group"]
    return sum(ms) / len(ms) if ms else None
