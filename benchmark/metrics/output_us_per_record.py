"""CLI: microseconds in cli.output (the results written and the output
files closed) over the hits the window's searches handed to the output
writer (the counter output.records); the program's own span."""

import progtrace


def read(t):
    ss = progtrace.searches(t)
    n = sum(s.counters.get("output.records", 0) for s in ss)
    sec = sum(x.end - x.start for s in ss for x in s.spans
              if x.name == "cli.output")
    return 1e6 * sec / n if n and sec > 0 else None
