"""CLI, per search: milliseconds from the entry into local_main to the end
of the search's first device step (options and assays read, database
opened, melt engine, panel manager and device panels built, the first
step queued), the mean over the window's searches that ran a step."""


def read(t):
    ms = [1e3 * (s["first_step_end"] - s["start"]) for s in t.searches
          if s["first_step_end"] is not None]
    return sum(ms) / len(ms) if ms else None
