"""The device step alone: its screening throughput without the host search.

Counterpart of bench.py's `_device_microbench` for an NVIDIA GPU.  Run from
the repository root:

    python -m tntblast_tpu_torch.tools.device_bench [--probes [wide]]

It builds the bench configuration (bench_data.py: 8 Mb synthetic genome,
10-assay PCR panel), takes the first `batch` real fragments (8 on one
card), runs the bench panel's device step on them once to warm up (on a
card that step captures the step's CUDA graph) and then `reps` times, and
prints the card's name and power limit and one JSON line: Mbases/s of
fragment data screened (seeding + exact DP at both screening temperatures
+ the eval condition + the gapless evaluator), ms per batch from CUDA
events over the queued steps (`batch_ms`) and from the host clock around a
final synchronise (`batch_wall_ms`); on a card those steps replay the
graph, and as many eager steps are timed in turns with them (graph,
eager, eager, graph: `batch_ms_turns`, `eager_batch_ms`), beside the host
time of the key's capture (`capture_ms`) and of the eager step before it
(`first_step_ms`) and the bytes of the card's graph pool
(`graph_pool_bytes`); the kept seeds and candidates of the batch, DP
cells per second against the card's ceiling, the launches of each of the
step's kernels a step (`<kernel>_launches_per_step`, over every turn,
replays included), the CUDA-event extent of each stage of one eager step
(the tnt.* stages of parallel/device_search.py) with the profiler off, and
the part of the per-chunk stages spent in the chunks wholly past the
pooled candidates (`empty_chunk_stage_ms`; `live_chunks` of `chunks`, the
chunks of device_search.chunk_entries: one at the bench shapes).  It runs
on `cuda` and raises when there is no card; `run(..., device="cpu")` gives
the counts and host-clock times only.  With --probes the step is the
long-probe search's (tools/probe_bench.py: 64 slots of 60 nt, dense
seeding, eleven chunks a step; `seeding` says which path the panel
takes), with --probes wide the wide one's (32 slots of 150 nt, -W 8, 28
chunks a step).

The ceiling.  A DP cell needs 13 int32 operations on this card, 19 in the
eval condition (add-max counted once; chip_smoke.py OPS_PER_CELL).  An H100
SXM has 64 int32 lanes on each of 132 SMs per clock; at the SM clock
nvidia-smi reports after the run (1980 MHz at most on an NVIDIA H100 80GB
HBM3) that is 1.67e13 operations a second, so with two screening conditions
and the eval condition (15 operations a cell on average) about 1.1e12 cells
a second.  The header arithmetic counts every candidate at the full
wq_max x (wq_max + 8) grid in every condition, as bench.py does, so the
utilization it gives is an upper estimate of the work done.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import torch

INT32_LANES = 64 * 132             # int32 lanes per SM x SMs, per clock
OPS_PER_CELL = {"screen": 13, "eval": 19}
STAGES = ("tnt.seed", "tnt.pool", "tnt.decode", "tnt.screen_dp", "tnt.eval",
          "tnt.compact")
CHUNK_STAGES = ("tnt.screen_dp", "tnt.eval")    # once a chunk; decode once


class StageTimer:
    """Times the named stages of a device step: CUDA events on a card (the
    extent of a stage on the device's timeline, read after a synchronise),
    the host clock on the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._spans = []        # (name, start, end) events or seconds

    @contextlib.contextmanager
    def span(self, name):
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(torch.cuda.current_stream(self.device))
            yield
            b.record(torch.cuda.current_stream(self.device))
        else:
            a = time.perf_counter()
            yield
            b = time.perf_counter()
        self._spans.append((name, a, b))

    def spans_ms(self):
        """{stage: [ms of each of its spans, in the order they ran]}."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        out = {}
        for name, a, b in self._spans:
            out.setdefault(name, []).append(
                a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
        return out

    def totals_ms(self):
        """{stage: [ms over all its spans, spans]}."""
        return {k: [sum(v), len(v)] for k, v in self.spans_ms().items()}


def bench_fragments(opt, db, n):
    """The first `n` fragments of the database as the engine cuts them."""
    from tntblast_tpu_torch.io.fastx import seq_len_increment

    mpl = opt.max_product_length() + 2
    frags = []
    for tgt in range(db.size()):
        tlen = db.approx_seq_len(tgt)
        delta = seq_len_increment(tlen, opt.fragment_target_threshold)[0]
        start, stop = 0, delta
        while True:
            _, seq_codes = db.read(tgt, start, stop + mpl)
            frags.append(seq_codes)
            if stop == tlen - 1:
                break
            start, stop = stop + 1, min(stop + delta, tlen - 1)
        if len(frags) >= n:
            break
    return frags[:n]


def header_counts(dp, n_frags, header):
    """(kept seeds, candidates, pooled entries) of a batch from the step's
    packed header: the per-fragment candidate counts live after [n_kept,
    overflow(n), reserved(num_os)]; a fragment pools at most `cap` of its
    candidates."""
    n_kept, _, _, n_cand, _ = dp._unpack_header(n_frags, header)
    return (int(n_kept), int(n_cand.sum()),
            int(n_cand.clip(max=dp.config.cap).sum()))


def dp_cells(n_cand, wq_max, nc_all):
    """DP cell-condition updates of a batch by the header arithmetic: each
    candidate window as a (wq_max) x (wq_max + 8) grid in every condition."""
    return n_cand * wq_max * (wq_max + 8) * nc_all


def cell_ceiling(num_cond, eval_on, clock_hz):
    """Cells a second the card could do at `clock_hz`: its int32 rate over
    the operations of an average cell of the step's conditions."""
    ops = num_cond * OPS_PER_CELL["screen"] + (
        OPS_PER_CELL["eval"] if eval_on else 0)
    nc_all = num_cond + (1 if eval_on else 0)
    return INT32_LANES * clock_hz / (ops / nc_all)


def summarize(batch_bases, dt_s, n_frags, n_kept, n_cand, cells):
    """The microbench's result fields from a batch's counts and its time."""
    return {
        "mbases_per_s": batch_bases / dt_s / 1e6,
        "batch_ms": dt_s * 1e3,
        "n_frags": n_frags,
        "kept_seeds": n_kept,
        "candidates": n_cand,
        "dp_cells_per_s": cells / dt_s,
    }


def _sm_clock_hz():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_bench: no CUDA device is available")
    return device


def run(fna, panel, device="cuda", reps=6, args=None):
    """The microbench on the bench files `fna`, `panel` (with `args`, the
    search arguments of bench_inputs.bench_options: the long-probe search
    for --probes); returns the result dict."""
    from tntblast_tpu_torch.engine import make_melt_engine
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.parallel.device_search import chunk_entries
    from tntblast_tpu_torch.parallel.panel import FragmentPanelManager
    from tntblast_tpu_torch.tools import launches as counted
    from tntblast_tpu_torch.tools.bench_inputs import (
        BENCH_ARGS, bench_options, eager_step)

    device = _device(device)
    cuda = device.type == "cuda"

    opt = bench_options(fna, panel, os.devnull, args or BENCH_ARGS)
    mgr = FragmentPanelManager(opt, make_melt_engine(opt, n_threads=1),
                               device)
    frags = bench_fragments(opt, open_database(opt.dbase_filename),
                            mgr.batch)
    n = len(frags)
    batch_bases = sum(len(f) for f in frags)
    dp = mgr.groups[0].device_panel(
        mgr._tile_len(max(len(f) for f in frags)))
    payload = dp._pack_host(frags)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    out = dp.step(payload)       # build + warm; on a card, the capture
    n_kept, n_cand, n_pool = header_counts(dp, n, out[0].cpu().numpy())

    def timed(eager):
        """(seconds a step by CUDA events or the host clock, seconds a step
        by the host clock around a final synchronise) of `reps` queued
        steps."""
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
        sync()
        t0 = time.perf_counter()
        if cuda:
            a.record()
        for _ in range(reps):
            if eager:
                eager_step(dp, payload)
            else:
                dp.step(payload)
        if cuda:
            b.record()
        sync()
        wall = (time.perf_counter() - t0) / reps
        return (a.elapsed_time(b) / 1e3 / reps if cuda else wall), wall

    # on a card the graph's replays and the eager step in turns (graph,
    # eager, eager, graph); the CPU step is eager
    turns = [False, True, True, False] if cuda else [True]
    for eager in sorted(set(turns)):    # warm: the pinned staging cached
        timed(eager)
    launches0 = counted.counts()
    times = {False: [], True: []}
    for i, eager in enumerate(turns):
        times[eager].append(timed(eager))
        if cuda and i == 0:
            clock_hz = _sm_clock_hz()       # right after the steps
    launches = {k: (v - launches0[k]) / len(turns)
                for k, v in counted.counts().items()}
    main = times[False] or times[True]
    dt = sum(t for t, _ in main) / len(main)
    wall = sum(w for _, w in main) / len(main)

    timer = StageTimer(device)
    t0 = time.perf_counter()
    dp.step(payload, timer=timer)
    spans = timer.spans_ms()
    staged_wall = time.perf_counter() - t0
    # the chunks of the pooled stream: those wholly past the pool hold no
    # valid entry and still run every per-chunk stage
    cfg = dp.config
    chunk = chunk_entries(n * cfg.cap, cfg.wq_max, cfg.wq_max + 8)
    n_chunks = -(-n * cfg.cap // chunk)
    live = min(n_chunks, -(-n_pool // chunk))

    nc_all = cfg.num_cond + (1 if dp.eval_on else 0)
    cells = dp_cells(n_cand, cfg.wq_max, nc_all)
    res = summarize(batch_bases, dt, n, n_kept, n_cand, cells)
    res.update({
        "device": str(device),
        "batch_wall_ms": wall * 1e3,
        "reps": reps,
        **{f"{k}_launches_per_step": v / reps for k, v in launches.items()},
        "batch_ms_turns": {"graph" if not e else "eager":
                           [t * 1e3 for t, _ in times[e]]
                           for e in (False, True) if times[e]},
        "stage_ms": {k: sum(v) for k, v in spans.items()},
        "stage_spans": {k: len(v) for k, v in spans.items()},
        "staged_step_wall_ms": staged_wall * 1e3,
        "chunks": n_chunks,
        "live_chunks": live,
        "seeding": "dense" if dp.host_tables[1].shape[0] == 1 else "table",
        "empty_chunk_stage_ms": {k: sum(spans[k][live:])
                                 for k in CHUNK_STAGES if k in spans},
    })
    if cuda:
        from tntblast_tpu_torch.parallel import step_graph
        graph = step_graph.graphs()[dp.graph_key(n, False)]
        ceiling = cell_ceiling(cfg.num_cond, dp.eval_on, clock_hz)
        res.update({
            "eager_batch_ms": sum(t for t, _ in times[True]) * 1e3
                              / len(times[True]),
            "capture_ms": graph.capture_ms,
            "first_step_ms": graph.warm_ms,
            "graph_pool_bytes": step_graph.pool_bytes(device),
            "card": torch.cuda.get_device_name(device),
            "sm_clock_mhz": clock_hz / 1e6,
            "cell_ceiling_per_s": ceiling,
            "utilization_pct": 100 * res["dp_cells_per_s"] / ceiling,
        })
    return res


def main(argv=None):
    from tntblast_tpu_torch.tools.screen_probe import card_name

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--probes", nargs="?", const="long", default=None,
                    choices=("long", "wide"),
                    help="a long-probe search (tools/probe_bench.py: long, "
                         "32 probes of 60 nt; wide, 16 probes of 150 nt; "
                         "-A PROBE, the dense seeding path) in place of the "
                         "bench PCR panel")
    args = ap.parse_args(argv)
    device = _device(args.device)      # before the bench files are built
    sys.path.insert(0, os.getcwd())
    import bench_data

    work = os.path.join(os.getcwd(), "bench_work")
    fna, panel = bench_data.build(work)
    search = None
    if args.probes:
        from tntblast_tpu_torch.tools import probe_bench
        panel = probe_bench.build(fna, work, args.probes)
        search = probe_bench.CONFIGS[args.probes]["args"]
    if device.type == "cuda":
        print(card_name())
    print(json.dumps(run(fna, panel, device, args.reps, search)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
