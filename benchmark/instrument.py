"""Spans and counters around the program's layers, for the traced run.

`WallSplit` is a copy of tntblast_tpu_torch/profile_slice.py::WallSplit,
kept here so that the yardstick stays where the program cannot move it,
with three additions: each span's interval (thread, start, end) on the
host clock, the panel managers built while it is active (their `stats`),
and one record a device step (the work its inputs ask for: each slot's
candidates, the panel's slots and conditions, the payload, table, header
and kept bytes).  It wraps the functions that do each part of a search;
each runs as before.  A function the program no longer has is not
wrapped, and its span stays empty.

  main thread:    "manager build", "panel build", "first step", "step",
                  "search" (engine.run_search);
  resolve threads: "resolve sync", "resolve";
  worker threads: "handle wait" (_BatchHandle.get), "fragment context"
                  (NativeFragContext), "host search" (search_assay).
"""

import contextlib
import threading
import time


class WallSplit:
    def __init__(self):
        self.spans = {}             # name -> [seconds, calls]
        self.intervals = []         # (name, thread id, start, end)
        self.managers = []
        self.steps = []             # one dict a resolved step
        self._lock = threading.Lock()
        self._keys = set()
        self._events = {}
        self._payload = {}
        self._local = threading.local()
        self._saved = []

    def _add(self, name, t0, t1):
        with self._lock:
            s = self.spans.setdefault(name, [0.0, 0])
            s[0] += t1 - t0
            s[1] += 1
            self.intervals.append((name, threading.get_ident(), t0, t1))

    @contextlib.contextmanager
    def span(self, name):
        # a span inside another of the same name on the same thread counts
        # once
        open_ = self._local.__dict__.setdefault("open", set())
        if name in open_:
            yield
            return
        open_.add(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            open_.discard(name)
            self._add(name, t0, time.perf_counter())

    def _timed(self, name, fn):
        def timed(*args, **kw):
            with self.span(name):
                return fn(*args, **kw)
        return timed

    def _wrap(self, owner, attr, make):
        fn = getattr(owner, attr, None)
        if fn is None:
            return
        self._saved.append((owner, attr, fn))
        setattr(owner, attr, make(fn))

    def __enter__(self):
        import torch

        from tntblast_tpu_torch import engine
        from tntblast_tpu_torch.parallel import panel
        from tntblast_tpu_torch.parallel.device_search import DevicePanel

        split = self
        mgr = panel.FragmentPanelManager

        def manager_init(real):
            def init(m, *args, **kw):
                with split.span("manager build"):
                    real(m, *args, **kw)
                with split._lock:
                    split.managers.append(m)
            return init

        def step(real):
            def wrapped(dp, payload, full=False, device=None, tabs=None,
                        timer=None):
                key = dp.graph_key(len(payload[0]), full, device)
                with split._lock:
                    first = key not in split._keys
                    split._keys.add(key)
                with split.span("first step" if first else "step"):
                    out = real(dp, payload, full, device, tabs, timer)
                nbytes = sum(int(getattr(a, "nbytes", 0)) for a in payload)
                ev = None
                if out[0].is_cuda:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(out[0].device))
                with split._lock:
                    split._events[id(out[0])] = ev
                    split._payload[id(out[0])] = nbytes
                return out
            return wrapped

        def resolve(real):
            def wrapped(dp, pending):
                with split._lock:
                    ev = split._events.pop(id(pending[1][0]), None)
                    nbytes = split._payload.pop(id(pending[1][0]), 0)
                if ev is not None:
                    with split.span("resolve sync"):
                        ev.synchronize()
                with split.span("resolve"):
                    res = real(dp, pending)
                split._record_step(dp, pending, res, nbytes)
                return res
            return wrapped

        self._wrap(mgr, "__init__", manager_init)
        for owner, attr, name in (
                (DevicePanel, "__init__", "panel build"),
                (DevicePanel, "_tables_on", "panel build"),
                (engine._BatchHandle, "get", "handle wait"),
                (engine, "run_search", "search"),
                (engine, "NativeFragContext", "fragment context"),
                (engine, "search_assay", "host search")):
            self._wrap(owner, attr, lambda fn, n=name: self._timed(n, fn))
        self._wrap(DevicePanel, "step", step)
        self._wrap(DevicePanel, "resolve_fragments", resolve)
        return self

    def _record_step(self, dp, pending, res, payload_bytes):
        """The inputs of one resolved step, for the step's least time."""
        cfg = dp.config
        tables = sum(int(a.nbytes) for a in dp.host_tables)
        thr = dp.host_tables[3]         # (num_cond, num_os); INT_MIN = off
        conds = [int((thr[:, i] > -(1 << 31)).sum())
                 for i in range(dp.n_real)]
        with self._lock:
            self.steps.append({
                "slot_len": [m[0] for m in dp.slot_meta],
                "conds": conds, "eval_on": bool(dp.eval_on),
                "flank": (cfg.wt - cfg.wq_max) // 2,
                "counts": [[int(c) for c in r["counts"]] for r in res],
                "n_kept": sum(int(r["n_kept"]) for r in res),
                "payload_bytes": payload_bytes, "table_bytes": tables,
                "header_bytes": int(pending[1][0].numel()
                                    * pending[1][0].element_size())})

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []
        return False
