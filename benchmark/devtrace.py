"""The card's timeline from torch.profiler, on the host's clock.

`DeviceTrace` records the device activity (kernels, copies, memsets) of a
window through CUPTI, graph replays included, and places it on the
host's perf_counter clock by a marker span recorded at a known host time.
"""

import time

MARK = "bench.clock_mark"


class DeviceTrace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.intervals = []         # (name, kind, start s, end s), host clock
        self._mark = None

    def __enter__(self):
        from torch.profiler import record_function

        self._prof.__enter__()
        with record_function(MARK):
            self._mark = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from torch.autograd import DeviceType

        self._prof.__exit__(*exc)
        events = self._prof.events()
        marks = [e.time_range.start for e in events if e.name == MARK]
        offset = self._mark - (marks[0] / 1e6 if marks else 0.0)
        for e in events:
            if (e.device_type != DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)):
                continue
            name = e.name
            kind = ("copy" if name.startswith("Memcpy")
                    else "memset" if name.startswith("Memset") else "kernel")
            self.intervals.append((name, kind,
                                   e.time_range.start / 1e6 + offset,
                                   e.time_range.end / 1e6 + offset))
        self.intervals.sort(key=lambda x: x[2])
        return False


def clipped(intervals, t0, t1):
    return [(n, k, max(a, t0), min(b, t1)) for n, k, a, b in intervals
            if b > t0 and a < t1]


def busy_and_gaps(intervals, t0, t1):
    """(seconds in which some device activity runs within [t0, t1], the
    idle gaps as (start, end))."""
    busy, gaps, cur = 0.0, [], t0
    for _, _, a, b in sorted(clipped(intervals, t0, t1), key=lambda x: x[2]):
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < t1:
        gaps.append((cur, t1))
    return busy, gaps


def by_name(intervals, kinds=("kernel", "copy", "memset")):
    """{name: device seconds} of the activities of `kinds`."""
    out = {}
    for n, k, a, b in intervals:
        if k in kinds:
            out[n] = out.get(n, 0.0) + (b - a)
    return out


def label_gap(gap, host_intervals, outer="search"):
    """The host span that covers most of `gap`, summed over threads; the
    `outer` span (the whole search loop) counts only the part that no
    other span covers; "no span" where none covers any of it (outside
    the search loop: options, output)."""
    a, b = gap
    cover = {}
    for name, _, s, e in host_intervals:
        if e > a and s < b:
            cover[name] = cover.get(name, 0.0) + min(e, b) - max(s, a)
    if not cover:
        return "no span"
    inner = sum(v for k, v in cover.items() if k != outer)
    if outer in cover:
        cover[outer] = max(0.0, cover[outer] - inner)
    return max(cover.items(), key=lambda kv: kv[1])[0]
