"""Host loop: worker-thread milliseconds in host.frag_index and
host.seed_inject (each fragment context's native index and the device's
seeds handed to it) over the work items of the window's searches (the
counter host.fragments); the program's own spans."""

import progtrace


def read(t):
    ss = progtrace.searches(t)
    frags = sum(s.counters.get("host.fragments", 0) for s in ss)
    sec = sum(x.end - x.start for s in ss for x in s.spans
              if x.name in ("host.frag_index", "host.seed_inject"))
    return 1e3 * sec / frags if frags and sec > 0 else None
