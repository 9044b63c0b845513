"""CLI, per search: milliseconds in cli.output (the results written and
the output files closed), the mean over the window's searches; the
program's own span."""

import progtrace


def read(t):
    return progtrace.mean_ms(t, "cli.output")
