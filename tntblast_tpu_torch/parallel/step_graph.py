"""One CUDA graph a device step: the port's counterpart of the JAX step's
jax.jit (tntblast_tpu/parallel/device_search.py `_panel_step`).

The JAX step is one compiled program, held in an lru_cache keyed by the
step's static configuration and the digest of the panel's tables, so that
a fresh panel per search replays it instead of compiling it again.  Here
`run` does the same for `panel_step_core` on a card: the first step of a
key runs the step eagerly (the warm-up: lazy set-up such as a plan's
layout for a window width, and the step's own outputs) and then captures
it in a CUDA graph; every later step of that key, from any panel with the
same key, copies its payload into the graph's static inputs and replays
the graph.  A step is then a few copies and one launch, where the eager
step dispatches about 150 torch ops from Python.

What a graph reads.  A captured graph holds raw pointers: to its static
inputs (the seven payload arrays at the shapes `DevicePanel._pack_host`
fixes), to the device tables and plans of the panel that captured it, and
to its intermediates and outputs in the device's graph pool.  The cache
entry owns all of them.  A panel of the same key (same configuration,
same digest of its seven host tables, same card) replays the entry's graph
on the entry's tables, which hold the same values.

Inputs.  Each step copies its host payload into pinned memory from the
caching host allocator and from there into the static inputs with
non_blocking=True, on the caller's current stream.  The copy records an
event on its pinned block, and the allocator hands the block out again
only once that event has passed: the staging is not reused before its
copy has run.  The copy is queued after every earlier replay on the
stream, so it never overwrites inputs that a replay still reads.

Outputs.  A replay writes the graph's output tensors.  The resolve of a
step runs later, on another thread, with several steps in flight
(engine.py _BatchHandle), so each replay is followed, on the stream, by a
copy of the outputs the resolve reads: header and kept_block, and with
`full` the five per-candidate outputs.  That is (2 + 2n + num_os + n *
num_os) * 4 + 9 * bkcap * 4 bytes a step, 9.7 MB on a bench step of 8
fragments (bkcap 270336), plus 11 * n * cap bytes with `full`.

Launch counts.  A kernel wrapper counts a launch where Python calls it
(ops/__init__.py).  A capture calls every wrapper without launching
anything, and a replay launches every captured kernel without calling a
wrapper.  So the capture records the counts its call made and takes them
back, and every replay adds them again.

Memory.  At most MAX_GRAPHS graphs are kept, the least recently used
dropped first (a graph dropped while its replay is in flight is freed
when the replay ends).  All graphs of one card capture into one memory
pool, so the pool holds the intermediates of one step (up to M_ROWS_BYTES
of eval-condition M rows a chunk: 1.14 GB on a bench step) about once,
not once a graph, plus each kept graph's outputs; the captures of a card
run on one stream, since the allocator hands a block that one capture
freed to another only on the stream that freed it.  Sharing is safe
because the graphs of a card never run at the same time and nothing reads
a graph's pool between its replays: every step of a card is queued on one
stream (`run` raises for a step queued on another), a caller only ever
sees the copies of the outputs, and the static inputs and tables live
outside the pool.  The eager first step of a key runs on the caller's
stream in the regular pool, so its intermediates go back to that stream's
cache for the steps after it.  Each entry also keeps its tables, static
inputs and outputs: some tens of MB at the bench shapes.

Timing.  Inside a traced step.submit span that asked for it
(trace.py, `time_device`; the innermost such span of the thread,
`device_timer`, so that a step.group span inside it changes nothing),
each step records two timing events on the caller's stream: one after its
payload is pinned, before the copies into the inputs, and one after the
replay's output copies (or after the eager step of a capture).  The
resolve reads their elapsed time.  With tracing off no event is made.

Capture beside other threads.  A new tile length builds a new panel, and
captures, while resolve threads copy earlier outputs to the host.  The
capture runs on a side stream in thread-local capture mode, so those
threads' copies and synchronisations neither join nor break it; the
step's plans read the current stream at each call, which during capture
is the side stream.  A capture or a replay that fails raises: there is no
quiet return to the eager step on a card.
"""

import collections
import threading
import time

import numpy as np
import torch

from tntblast_tpu_torch import ops
from tntblast_tpu_torch import trace

# graphs kept at once, the least recently used dropped first
MAX_GRAPHS = 16

_GRAPHS = collections.OrderedDict()     # key -> StepGraph
_POOLS = {}                             # card -> graph pool handle
_SIDE = {}                              # card -> stream of its captures
_STREAM = {}                            # card -> stream of its steps
_LOCK = threading.Lock()

# captures and replays since the process started (tests, tools)
stats = {"captures": 0, "replays": 0}


class StepGraph:
    """One captured step: its graph, its static inputs and outputs, the
    tables it reads, the launch counts a replay makes, and what its capture
    cost (`warm_ms`: the eager first step's host time; `capture_ms`: the
    capture's, instantiation included)."""

    def __init__(self, graph, inputs, outputs, tabs, launches, warm_ms,
                 capture_ms):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.tabs = tabs
        self.launches = launches
        self.warm_ms = warm_ms
        self.capture_ms = capture_ms
        self.replays = 0


def card(device):
    """`device` with its index (the current card's where it has none)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def graphs():
    """{key: StepGraph} of the graphs kept now, oldest use first."""
    with _LOCK:
        return dict(_GRAPHS)


def clear():
    """Drops every kept graph (their pool goes with the last of them),
    once the work queued on their cards has run."""
    with _LOCK:
        for device in _POOLS:
            torch.cuda.synchronize(device)
        _GRAPHS.clear()
        _POOLS.clear()
        _SIDE.clear()
        _STREAM.clear()


def pool_bytes(device):
    """Bytes the graph pool of card `device` holds from the device."""
    pool = _POOLS.get(card(device))
    if pool is None:
        return 0
    index = card(device).index
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if s["device"] == index
               and tuple(s["segment_pool_id"]) == tuple(pool))


def _stage(payload, inputs, start=None):
    """Copies the host payload into the static inputs, on the current
    stream, through pinned staging (see the module docstring); records the
    timing event `start` between the pinning and the copies."""
    pinned = []
    for dst, a in zip(inputs, payload):
        src = torch.from_numpy(np.ascontiguousarray(a))
        if src.dtype != dst.dtype or src.shape != dst.shape:
            raise ValueError(
                f"step graph: payload array {tuple(src.shape)} {src.dtype}, "
                f"the graph's input is {tuple(dst.shape)} {dst.dtype}")
        pinned.append(src.pin_memory())
    if start is not None:
        start.record(torch.cuda.current_stream(inputs[0].device))
    for dst, src in zip(inputs, pinned):
        dst.copy_(src, non_blocking=True)


def _capture(dp, payload, full, device, tabs, events=None):
    """The first step of a key: the eager step on the caller's stream (its
    outputs are this step's), then the capture of the same step on the
    same inputs on the card's capture stream.  `events`, where given, time
    the staging and the eager step.  Returns (StepGraph, the eager
    outputs)."""
    n = len(payload[0])
    inputs = tuple(torch.empty_like(torch.from_numpy(np.ascontiguousarray(a)),
                                    device=device) for a in payload)
    _stage(payload, inputs, events and events[0])
    if device not in _POOLS:
        _POOLS[device] = torch.cuda.graph_pool_handle()
        # one capture stream a card: the allocator hands a block freed in
        # one capture to a later one only on the stream that freed it
        _SIDE[device] = torch.cuda.Stream(device)
    pool, side = _POOLS[device], _SIDE[device]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        t0 = time.perf_counter()
        eager = dp.step_core(inputs, tabs, n, full)
        if events:
            events[1].record(torch.cuda.current_stream(device))
        t1 = time.perf_counter()
        side.wait_stream(torch.cuda.current_stream(device))
        before = ops.counts()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                outputs = dp.step_core(inputs, tabs, n, full)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass    # the capture is void; the step's error is raised
                raise
            finally:
                launched = {k: v - before[k] for k, v in ops.counts().items()}
                ops.add({k: -v for k, v in launched.items()})
            graph.capture_end()
        t2 = time.perf_counter()
    return (StepGraph(graph, inputs, outputs, tabs, launched,
                      (t1 - t0) * 1e3, (t2 - t1) * 1e3), eager)


def run(dp, payload, full, device, tabs):
    """Queues the step of panel `dp` on the host payload `payload` on card
    `device` with the tables `tabs`: replays the graph of its key, which
    the first step of the key captures.  Returns the step's seven outputs
    as panel_step_core does, except that the graph's hands back copies of
    header and kept_block (None for the other five) unless `full`."""
    device = card(device)
    key = dp.graph_key(len(payload[0]), full, device)
    sp = trace.device_timer()
    events = None
    if sp.events is not None:
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        sp.events.append(events)
    with _LOCK:
        entry = _GRAPHS.get(key)
        cur = torch.cuda.current_stream(device)
        if _STREAM.setdefault(device, cur) != cur:
            raise RuntimeError(
                f"step graph: a step of {device} queued on {cur}, where its "
                f"graphs' steps run on {_STREAM[device]}")
        if entry is None:
            with trace.span("step.capture"):
                entry, out = _capture(dp, payload, full, device, tabs,
                                      events)
            if events:
                sp.set(captured=True)
            _GRAPHS[key] = entry
            stats["captures"] += 1
            while len(_GRAPHS) > MAX_GRAPHS:
                _GRAPHS.popitem(last=False)
            if not full:
                out = (*out[:2], None, None, None, None, None)
            return out
        _GRAPHS.move_to_end(key)
        _stage(payload, entry.inputs, events and events[0])
        entry.graph.replay()
        ops.add(entry.launches)
        entry.replays += 1
        stats["replays"] += 1
        kept = entry.outputs if full else entry.outputs[:2]
        out = tuple(t.clone() for t in kept)
        if events:
            events[1].record(cur)
        return out if full else (*out, None, None, None, None, None)
