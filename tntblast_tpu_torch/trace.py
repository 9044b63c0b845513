"""Spans and counters of a search, recorded where the work happens.

A traced search is one `Search`: the spans of every thread that works for
it and its counters.  A span is a `Span` record (its id, the search's id,
its parent's id, the id of the span it waits for on another thread, the
thread, its name, start and end on the `time.perf_counter` clock, and a
dict of attributes).  The parent is the innermost open span of the same
thread; a span on a worker or resolve thread, where the search's work was
handed over by `bind`, has the search's root as its parent.

Tracing is decided once a search, where `search` opens its root
(`cli.local_main`): on where TNTBLAST_TPU_PROFILE is set, or where a
torch.profiler session is recording (the process-wide flag: a session
records every thread).  The decision holds for every span of the search
on every thread.  With tracing off, `span` returns a shared null context
after one read of a module global.

The last KEEP searches stay in memory (`searches()`); there is no file.

The spans, by layer (thread):

  CLI          cli.search (main: the root), cli.options, cli.melt_engine,
               cli.output
  database     io.open, io.read, io.decode (a record parsed; the counter
  reader       io.bytes_decoded)
  host loop    engine.plan, engine.drain (the main thread waiting for a
               worker's result), engine.apply (the result merged, with
               its secondary-structure Tms); on the workers host.wait (a
               batch's resolve), host.frag_index (the native fragment
               index), host.seed_inject (the device's seeds and
               evaluations handed to it, one native call a panel group;
               the counters host.inject.slots, host.inject.seeds and
               host.inject.dropped: slots filled, seeds handed over, seeds
               the device's evaluations dropped), host.panel_search (the
               native search of all of a work item's assays in one call,
               where it holds more than one; the counters host.panel.calls
               and host.panel.assays: the calls and the assays they
               searched), host.search (the hits of one assay, and its
               native search where no panel call ran)
  panel        panel.build (the manager; the counters panel.groups and
  manager      panel.slots), panel.device_panel (a panel's tables, on the
               device)
  device step  step.submit (a batch queued; on a card its `device_ms`,
               from two timing events around the step's work on its
               stream), inside it step.group (one panel group's step, with
               the group's index and slot count; the counters
               screen.chunks.reg and screen.chunks.strip: the screen_dp
               chunks queued on each route) and step.capture; on the
               resolve thread step.sync (the wait for the step's end
               event) and step.resolve

The host loop counts its work items (fragments) in host.fragments, and
cli.output the hits it hands to the output writer in output.records.
"""

import collections
import contextlib
import itertools
import os
import sys
import threading
import time

KEEP = 64

NAMES = ("cli.search", "cli.options", "io.open", "cli.melt_engine",
         "panel.build", "engine.plan", "io.read", "io.decode",
         "panel.device_panel", "step.submit", "step.group", "step.capture",
         "step.sync", "step.resolve", "engine.drain", "engine.apply",
         "host.wait", "host.frag_index", "host.seed_inject",
         "host.panel_search", "host.search", "cli.output")

Span = collections.namedtuple(
    "Span", "id search parent cause thread name start end attrs")

_active = 0                     # traced searches open in the process
_lock = threading.Lock()
_ids = itertools.count(1)
_done = collections.deque(maxlen=KEEP)
_local = threading.local()      # .search, .stack: this thread's open spans


class Search:
    """One traced search: its closed spans (any thread), its counters, and
    its root's record once it has ended."""

    def __init__(self):
        self.id = next(_ids)
        self.spans = []
        self.counters = {}
        self.root = None
        self.root_id = None
        self._open_root = None
        self._lock = threading.Lock()

    def count(self, name, n):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n


class _Null:
    """The span of an untraced search: records nothing."""

    id = None
    events = None
    traced = False
    search = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def time_device(self):
        pass


_NULL = _Null()


class _Open:
    """A span being recorded; its record joins the search when it ends."""

    __slots__ = ("search", "id", "parent", "cause", "name", "attrs",
                 "start", "events")
    traced = True

    def __init__(self, search, name, cause, attrs):
        self.search, self.name, self.cause = search, name, cause
        self.attrs = attrs
        self.events = None

    def __enter__(self):
        stack = _local.stack
        self.parent = stack[-1].id if stack else self.search.root_id
        self.id = next(_ids)
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _local.stack.pop()
        self.search.spans.append(Span(
            self.id, self.search.id, self.parent, self.cause,
            threading.get_ident(), self.name, self.start, end, self.attrs))
        return False

    def set(self, **attrs):
        """Adds attributes; the record shares them, also after the end."""
        self.attrs.update(attrs)

    def time_device(self):
        """The step queued inside this span is timed by device events:
        step_graph.run appends a (start, end) pair a step to `events`."""
        self.events = []


def _wanted():
    if os.environ.get("TNTBLAST_TPU_PROFILE"):
        return True
    prof = sys.modules.get("torch.autograd.profiler")
    return bool(getattr(prof, "_is_profiler_enabled", False))


@contextlib.contextmanager
def search(name="cli.search", **attrs):
    """The root span of a search on this thread, traced where tracing is
    wanted now; yields the root (the null span where untraced)."""
    if not _wanted():
        yield _NULL
        return
    global _active
    s = Search()
    saved = (getattr(_local, "search", None), getattr(_local, "stack", None))
    _local.search, _local.stack = s, []
    with _lock:
        _active += 1
    try:
        with _Open(s, name, None, attrs) as root:
            s.root_id, s._open_root = root.id, root
            yield root
    finally:
        with _lock:
            _active -= 1
        _local.search, _local.stack = saved
        s.root = next((x for x in reversed(s.spans) if x.id == s.root_id),
                      None)
        _done.append(s)


def span(name, cause=None, **attrs):
    """A span of this thread's traced search, or the null span."""
    if not _active:
        return _NULL
    s = getattr(_local, "search", None)
    if s is None:
        return _NULL
    return _Open(s, name, cause, attrs)


def count(name, n=1):
    """Adds `n` to the counter `name` of this thread's traced search."""
    if not _active:
        return
    s = getattr(_local, "search", None)
    if s is not None:
        s.count(name, n)


def current():
    """The innermost open span of this thread, or the null span."""
    if not _active:
        return _NULL
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else _NULL


def device_timer():
    """The innermost open span of this thread whose steps are timed by
    device events (`time_device`), or the null span."""
    if not _active:
        return _NULL
    for sp in reversed(getattr(_local, "stack", None) or ()):
        if sp.events is not None:
            return sp
    return _NULL


def annotate(**attrs):
    """Adds attributes to the root of this thread's traced search."""
    s = getattr(_local, "search", None) if _active else None
    if s is not None:
        s._open_root.set(**attrs)


def bind(fn):
    """`fn`, to run on another thread as part of this thread's traced
    search (`fn` itself where the search is untraced)."""
    s = getattr(_local, "search", None) if _active else None
    if s is None:
        return fn

    def bound(*args, **kw):
        saved = (getattr(_local, "search", None),
                 getattr(_local, "stack", None))
        _local.search, _local.stack = s, []
        try:
            return fn(*args, **kw)
        finally:
            _local.search, _local.stack = saved
    return bound


def searches():
    """The last KEEP traced searches that have ended, oldest first."""
    return list(_done)


def self_times(s):
    """{span name: (self seconds, count)} of search `s`: each span's
    duration less that of its children on the same thread."""
    by_id = {x.id: x for x in s.spans}
    inner = {}
    for x in s.spans:
        p = by_id.get(x.parent)
        if p is not None and p.thread == x.thread:
            inner[p.id] = inner.get(p.id, 0.0) + (x.end - x.start)
    out = {}
    for x in s.spans:
        sec, n = out.get(x.name, (0.0, 0))
        out[x.name] = (sec + x.end - x.start - inner.get(x.id, 0.0), n + 1)
    return out


def step_device_ms(s):
    """The `device_ms` of each step of search `s` that has one."""
    return [x.attrs["device_ms"] for x in s.spans
            if x.name == "step.submit" and "device_ms" in x.attrs]


def summary(s):
    """One line: the self ms and count of each span name of search `s`,
    its counters and the mean device ms of its steps."""
    times = self_times(s)
    order = [n for n in NAMES if n in times] + sorted(set(times) - set(NAMES))
    parts = [f"{n} {1e3 * times[n][0]:.3f} ({times[n][1]})" for n in order]
    line = "spans (self ms, count): " + " ".join(parts)
    if s.counters:
        line += " | counters: " + " ".join(
            f"{k} {v}" for k, v in sorted(s.counters.items()))
    ms = step_device_ms(s)
    if ms:
        line += (f" | step device_ms mean {sum(ms) / len(ms):.4f} over "
                 f"{len(ms)} steps")
    return line
