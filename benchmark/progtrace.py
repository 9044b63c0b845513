"""The program's own spans in a traced window: the records that
tntblast_tpu_torch/trace.py keeps of each traced search (its spans, with
their threads and attributes, and its counters), those whose root span
lies inside the window.  A program without that tracer has none, and
every reader here then returns None."""


def searches(t):
    """The trace records of the window's searches, oldest first."""
    try:
        from tntblast_tpu_torch import trace
    except ImportError:
        return []
    t0, t1 = t.window
    return [s for s in trace.searches()
            if s.root is not None and t0 <= s.root.start
            and s.root.end <= t1]


def _spans(s, name, main):
    return [x for x in s.spans if x.name == name
            and (not main or x.thread == s.root.thread)]


def mean_ms(t, name, main=False):
    """Milliseconds a search in the spans `name` (on the search's main
    thread alone where `main`), the mean over the window's searches; None
    where no search has such a span."""
    ss = searches(t)
    spans = [_spans(s, name, main) for s in ss]
    if not any(spans):
        return None
    return 1e3 * sum(x.end - x.start for sp in spans for x in sp) / len(ss)


def ms_per_mb(t, name):
    """Milliseconds in the spans `name` over every thread of the window's
    searches, per Mb of database searched in the window."""
    spans = [x for s in searches(t) for x in _spans(s, name, False)]
    if not spans or t.mb <= 0:
        return None
    return 1e3 * sum(x.end - x.start for x in spans) / t.mb
