"""Where the time goes on the port's main path, on one CUDA device.

Runs the bench configuration (bench_data.py: 8 Mb synthetic genome, 10-assay
PCR panel) through the port's local_main: once on each device path to warm
up (the first search, which captures the step's CUDA graphs, traced), then
the device path (--tpu-screen T), the host-only path and the mesh path
(--mesh T, all visible cards) in turns (device, host, mesh, mesh, host,
device), then two ranks of the multi-process runtime
(parallel/multiproc.py, --tpu-screen T) on the card, then the device and
host paths once more traced (where each path's wall goes: the self time of
each of the program's spans, trace.py), then the device path under
torch.profiler twice: as a search runs it, its steps replaying the step's
CUDA graph, and with every step eager (tools/bench_inputs.eager_step),
whose tnt.* spans break the step down by stage.  Prints the wall times,
the launches of the step's kernels (seed, seed_dense, pool, win_decode,
screen_dp, eval_pack, kept) a run on each path and in each rank
(tools/launches.py), each wall split, and for each profiled run the device
busy time (kernels + copies) and its share of the profiled wall, the
hand-written kernels' rows and the top device kernels; for the graphed run
the device time of each stage's kernels (a kernel's stage is the tnt.* span
that launched it in the eager run), for the eager run each stage's kernel,
extent and host time and the torch ops whose kernels take most of its
device time.

Run from the repository root (needs a CUDA device):

    python -m tntblast_tpu_torch.profile_slice [--probes]

With --probes the slice is the long-probe search (tools/probe_bench.py: 32
probes of 60 nt over the bench genome, -A PROBE, the dense seeding path,
eleven chunks a step): the device and host paths in turns (device, host,
host, device), their wall splits and the two profiled device runs; no mesh
path and no ranks.

With --scaled it is BASELINE config 5 at the smoke's depth
(tools/scaled_bench.py: the first of its eight 128 Mb sequences, the PCR
and the padlock batch) on two host threads, as the tool's screen mode runs
it: for each family a first device-path search (captures), the device
path's and the host path's wall splits, and a profiled device-path run
(graph replays) with the card's busy share and the hand-written kernels'
rows.
"""

import contextlib
import io
import os
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tntblast_tpu_torch import _kernels, cli, trace
from tntblast_tpu_torch.io.fastx import open_database
from tntblast_tpu_torch.tools import launches

BENCH_ARGS = ["-A", "PCR", "-e", "40", "-E", "45", "-l", "2000", "-v", "F"]


def traced(run, *args):
    """`run(*args)`, a function that runs one search and returns its wall,
    with the search traced (trace.py; TNTBLAST_TPU_PROFILE set, so the
    search prints its [profile] lines too); (wall, the search's record)."""
    prev = os.environ.get("TNTBLAST_TPU_PROFILE")
    os.environ["TNTBLAST_TPU_PROFILE"] = "1"
    try:
        wall = run(*args)
    finally:
        if prev is None:
            del os.environ["TNTBLAST_TPU_PROFILE"]
        else:
            os.environ["TNTBLAST_TPU_PROFILE"] = prev
    return wall, trace.searches()[-1]


def split_lines(path, wall, search):
    """The wall split of a traced search of `wall` seconds: one line a span
    of trace.NAMES, its self seconds (its own less its children's on its
    thread) and calls summed over every thread (the parts of other threads
    overlap the main thread's and each other), and the step graphs it
    captured (the root's counter)."""
    times = trace.self_times(search)
    out = [f"{path} path wall split: wall {wall:.6f} s, "
           f"{search.root.attrs.get('captures', 0)} graph captures"]
    for name in trace.NAMES:
        total, calls = times.get(name, (0.0, 0))
        out.append(f"  {name}: {total:.6f} s in {calls} calls "
                   f"({100 * total / wall:.2f}% of the wall)")
    return out


@contextlib.contextmanager
def eager_steps():
    """Every device step of a search dispatched op by op while active."""
    from tntblast_tpu_torch.parallel.device_search import DevicePanel
    from tntblast_tpu_torch.tools.bench_inputs import eager_step

    real = DevicePanel.step

    def step(dp, payload, full=False, device=None, tabs=None, timer=None):
        return eager_step(dp, payload, full, device, tabs)

    DevicePanel.step = step
    try:
        yield
    finally:
        DevicePanel.step = real


def span_ops(events, span, top=10):
    """[(op name, device ms, calls)] of the torch ops called inside the
    profiler spans named `span`, by the device time of the kernels each op
    launched itself (an op's children count under their own names), the
    `top` largest."""
    by_name = {}
    for e in _ops_in(events, span):
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.self_device_time_total / 1e3, calls + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return [(name, ms, calls) for name, (ms, calls) in rows]


def _ops_in(events, span):
    """The torch ops called inside the profiler spans named `span`."""
    ranges = [e.time_range for e in events
              if e.name == span and e.device_type == DeviceType.CPU]
    for e in events:
        if (e.device_type != DeviceType.CPU or e.is_user_annotation
                or e.name.startswith("cuda")):       # runtime calls
            continue
        r = e.time_range
        if any(a.start <= r.start and r.end <= a.end for a in ranges):
            yield e


def kernel_stages(events, spans):
    """{kernel name: the tnt.* span whose torch ops launched it, or
    "several stages"} from an eager run's profiler events."""
    stage = {}
    for span in spans:
        for e in _ops_in(events, span):
            for k in e.kernels:
                stage[k.name] = (span if stage.get(k.name, span) == span
                                 else "several stages")
    return stage


def device_rows(rows):
    """The kernels' and copies' rows of a profile's key_averages()."""
    return [r for r in rows if r.device_type == DeviceType.CUDA
            and not r.is_user_annotation]


def busy_line(label, rows, wall, card):
    busy_us = sum(r.self_device_time_total for r in device_rows(rows))
    return (f"{label}: wall {wall:.3f} s, device busy {busy_us / 1e3:.3f} "
            f"ms = {100 * busy_us / 1e6 / wall:.2f}% of wall on {card}")


def kernel_lines(rows):
    """The hand-written kernels' rows, by kernel; screen_dp's
    instantiations (one per register width and for the eval condition) are
    rows of their own."""
    out = []
    for name in launches.STEP_KERNELS:
        k_rows = [r for r in device_rows(rows)
                  if launches.kernel_of(r.key) == name]
        for row in k_rows:
            out.append(f"{row.key}: {row.self_device_time_total / 1e3:.3f} "
                       f"ms in {row.count} launches")
        out.append(f"{name} kernels together: "
                   f"{sum(r.self_device_time_total for r in k_rows) / 1e3:.3f}"
                   f" ms in {sum(r.count for r in k_rows)} launches")
    return out


def ranks_phase(argv, work, card):
    """Two ranks of the multi-process runtime on the card: their launches
    and the wall of both with their start-up."""
    rank_wall, ranks = launches.run_ranks(
        argv[:-2] + ["-o", os.path.join(work, "profile_ranks.txt"),
                     "--tpu-screen", "T"], os.getcwd())
    for rank, (rc, log) in enumerate(ranks):
        line = launches.profile_line(log, rank)
        if rc != 0 or line is None:
            raise SystemExit(f"rank {rank}: exit {rc}\n{log[-2000:]}")
        print(f"multi-process path, rank {rank} of 2 on the card: launches "
              f"{launches.rank_counts(line)}; {line}")
    print(f"multi-process path: wall {rank_wall:.3f} s for 2 ranks incl. "
          f"their start-up on {card}")


def scaled_split(card):
    """--scaled: the wall split of config 5's device path at 128 Mb."""
    from tntblast_tpu_torch.tools import scaled_bench as sb

    os.environ["TNTBLAST_TPU_THREADS"] = "2"        # the tool's screen mode
    work = os.path.join(os.getcwd(), "bench_work")
    fna, pcr, pad = sb.build(work, nseq=1)
    mb = sb.SEQLEN / 1e6
    for fmt in sb.FAMILIES:
        out = os.path.join(work, f"profile_scaled_{fmt}.out")
        argv = sb.family_argv(fmt, pcr if fmt == "PCR" else pad, fna,
                              out) + ["-v", "F"]

        def run(flag):
            launches.reset()
            t0 = time.perf_counter()
            rc = cli.local_main(argv + flag, stdout=io.StringIO(),
                                device="cuda")
            torch.cuda.synchronize()
            if rc != 0:
                raise SystemExit(f"local_main returned {rc}")
            return time.perf_counter() - t0

        device = ["--tpu-screen", "T"]
        wall = run(device)
        print(f"scaled {fmt} ({mb:.0f} Mb, 2 host threads): first device "
              f"search (captures) wall {wall:.3f} s, launches "
              f"{launches.counts()} on {card}")
        for path, flag in (("device", device), ("host", [])):
            wall, search = traced(run, flag)
            print("\n".join(split_lines(f"scaled {fmt} {path}", wall, search))
                  + f"  ({mb / wall:.3f} Mb/s; {card})")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run(device)
        rows = prof.key_averages()
        print(busy_line(f"scaled {fmt} profiled device-path run (graph "
                        f"replays)", rows, wall, card))
        print("\n".join(kernel_lines(rows)))
    return 0


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probes", action="store_true",
                    help="the long-probe slice (tools/probe_bench.py) on the "
                         "device and host paths only")
    ap.add_argument("--scaled", action="store_true",
                    help="BASELINE config 5 at 128 Mb "
                         "(tools/scaled_bench.py, one sequence): the "
                         "device and host paths' wall splits and the "
                         "card's busy share, PCR and PADLOCK")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 2
    if opts.scaled:
        for name in _kernels.KERNELS:
            _kernels.load(name)
        from tntblast_tpu_torch.tools.screen_probe import card_name
        return scaled_split(card_name())
    sys.path.insert(0, os.getcwd())
    import bench_data

    work = os.path.join(os.getcwd(), "bench_work")
    fna, panel = bench_data.build(work)
    out = os.path.join(work, "profile_out.txt")
    argv = ["-i", panel, "-d", fna, *BENCH_ARGS, "-o", out]
    if opts.probes:
        from tntblast_tpu_torch.tools import probe_bench
        argv = probe_bench.probe_argv(fna, probe_bench.build(fna, work),
                                      out) + ["-v", "F"]
    db = open_database(fna)
    mb = sum(db.approx_seq_len(i) for i in range(db.size())) / 1e6

    flags = {"device": ["--tpu-screen", "T"], "host": []}
    if not opts.probes:
        flags["mesh"] = ["--mesh", "T"]

    counted = {}

    def run(path):
        launches.reset()
        t0 = time.perf_counter()
        rc = cli.local_main(argv + flags[path], stdout=io.StringIO(),
                            device="cuda")
        torch.cuda.synchronize()
        if rc != 0:
            raise SystemExit(f"local_main returned {rc}")
        counted[path] = launches.counts()
        return time.perf_counter() - t0

    card = torch.cuda.get_device_name(0)
    # the kernels built first, so that no panel build of a search waits
    # for nvcc
    for name in _kernels.KERNELS:
        _kernels.load(name)
    # the first search of the process captures its steps' graphs
    wall, search = traced(run, "device")
    print("\n".join(split_lines("device (first search: captures)", wall,
                                search)) + f"  ({card})")
    if opts.probes:
        turns = ("device", "host", "host", "device")
    else:
        run("mesh")
        turns = ("device", "host", "mesh", "mesh", "host", "device")
    walls = {name: [] for name in flags}
    for path in turns:
        walls[path].append(run(path))
    for path, runs in walls.items():
        w = statistics.median(runs)
        print(f"{path} path: wall {w:.3f} s ({mb / w:.3f} Mb/s), runs "
              f"{[round(x, 3) for x in runs]}, launches a run "
              f"{counted[path]} on {card}")
    if not opts.probes:
        ranks_phase(argv, work, card)

    for path in ("device", "host"):
        wall, search = traced(run, path)
        print("\n".join(split_lines(path, wall, search)) + f"  ({card})")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run("device")
    graph_rows = prof.key_averages()
    with eager_steps(), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        eager_wall = run("device")
    rows = prof.key_averages()
    events = prof.events()

    print(busy_line("profiled device-path run (graph replays)", graph_rows,
                    wall, card))
    print("\n".join(kernel_lines(graph_rows)))
    # a span's CPU-side row sums the kernels its torch ops launched (not
    # the hand-written kernels, launched through ctypes); its device-side row
    # is the span's extent on the device timeline, idle gaps included
    extent = {r.key: r.device_time_total for r in rows
              if r.key.startswith("tnt.") and r.device_type == DeviceType.CUDA}
    stage_of = kernel_stages(events, sorted(extent))
    for r in device_rows(graph_rows):
        name = launches.kernel_of(r.key)
        if name is not None:
            stage_of.setdefault(r.key, f"{name} kernel")
    by_stage = {}
    for r in device_rows(graph_rows):
        stage = stage_of.get(r.key, "no stage (copies: payloads, outputs, "
                                    "resolves)")
        ms, n = by_stage.get(stage, (0.0, 0))
        by_stage[stage] = (ms + r.self_device_time_total / 1e3, n + r.count)
    for stage, (ms, n) in sorted(by_stage.items()):
        print(f"graph run, {stage}: kernels {ms:.3f} ms in {n} launches")

    print(busy_line("profiled device-path run (eager steps)", rows,
                    eager_wall, card))
    for row in sorted((r for r in rows if r.key.startswith("tnt.")
                       and r.device_type == DeviceType.CPU),
                      key=lambda r: r.key):
        print(f"stage {row.key}: torch-op kernels "
              f"{row.device_time_total / 1e3:.3f} ms, device extent "
              f"{extent.get(row.key, 0) / 1e3:.3f} ms, host "
              f"{row.cpu_time_total / 1e3:.3f} ms, calls {row.count}")
    for span in sorted(extent):
        ops = [op for op in span_ops(events, span) if op[1] > 0]
        if ops:
            print(f"stage {span}, torch ops by their kernels' device time: "
                  + "; ".join(f"{name} {ms:.3f} ms in {calls} calls"
                              for name, ms, calls in ops))
    print("\n".join(kernel_lines(rows)))
    # the plain evaluator's mark: it alone made thousands of these a run
    print("aten::where calls: "
          f"{sum(r.count for r in rows if r.key == 'aten::where')}")
    for label, r in (("graph replays", graph_rows), ("eager steps", rows)):
        print(f"top device kernels, {label}:")
        print(r.table(sort_by="self_device_time_total", row_limit=20,
                      max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
