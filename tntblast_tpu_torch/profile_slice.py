"""Where the time goes on the port's main path, on one CUDA device.

Runs the bench configuration (bench_data.py: 8 Mb synthetic genome, 10-assay
PCR panel) through the port's local_main: once to warm up, then the device
path (--tpu-screen T), the host-only path and the mesh path (--mesh T, all
visible cards) in turns (device, host, mesh, mesh, host, device), then two
ranks of the multi-process runtime (parallel/multiproc.py, --tpu-screen T)
on the card, then the device path once more under torch.profiler.  Prints
the wall times, the launches of the step's kernels (seed, win_decode,
screen_dp, eval_pack) a run on each path and in each rank (tools/launches.py), the
device busy time (kernels + copies) and its share of the profiled wall, the
kernel and host time of each step stage (the tnt.* spans of
parallel/device_search.py), the torch ops whose kernels take most of each
stage's device time, the hand-written kernels' rows and the top device
kernels.

Run from the repository root (needs a CUDA device):

    python -m tntblast_tpu_torch.profile_slice
"""

import io
import os
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tntblast_tpu_torch import cli
from tntblast_tpu_torch.io.fastx import open_database
from tntblast_tpu_torch.tools import launches

BENCH_ARGS = ["-A", "PCR", "-e", "40", "-E", "45", "-l", "2000", "-v", "F"]


def span_ops(events, span, top=10):
    """[(op name, device ms, calls)] of the torch ops called inside the
    profiler spans named `span`, by the device time of the kernels each op
    launched itself (an op's children count under their own names), the
    `top` largest."""
    ranges = [e.time_range for e in events
              if e.name == span and e.device_type == DeviceType.CPU]
    by_name = {}
    for e in events:
        if (e.device_type != DeviceType.CPU or e.is_user_annotation
                or e.name.startswith("cuda")):       # runtime calls
            continue
        r = e.time_range
        if any(a.start <= r.start and r.end <= a.end for a in ranges):
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.self_device_time_total / 1e3,
                               calls + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return [(name, ms, calls) for name, (ms, calls) in rows]


def main():
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import bench_data

    work = os.path.join(os.getcwd(), "bench_work")
    fna, panel = bench_data.build(work)
    out = os.path.join(work, "profile_out.txt")
    argv = ["-i", panel, "-d", fna, *BENCH_ARGS, "-o", out]
    db = open_database(fna)
    mb = sum(db.approx_seq_len(i) for i in range(db.size())) / 1e6

    flags = {"device": ["--tpu-screen", "T"], "host": [],
             "mesh": ["--mesh", "T"]}

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
    run("device")
    run("mesh")
    walls = {name: [] for name in flags}
    for path in ("device", "host", "mesh", "mesh", "host", "device"):
        walls[path].append(run(path))
    for path, runs in walls.items():
        w = statistics.median(runs)
        print(f"{path} path: wall {w:.3f} s ({mb / w:.3f} Mb/s), runs "
              f"{[round(x, 3) for x in runs]}, launches a run "
              f"{counted[path]} on {card}")
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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run("device")
    rows = prof.key_averages()
    # kernels and copies; the device-side copies of the tnt.* spans are
    # user annotations and do not count (as in the profiler's own total)
    busy_us = sum(r.self_device_time_total for r in rows
                  if r.device_type == DeviceType.CUDA
                  and not r.is_user_annotation)
    print(f"profiled device-path run: wall {wall:.3f} s, device busy "
          f"{busy_us / 1e3:.3f} ms = {100 * busy_us / 1e6 / wall:.2f}% of "
          f"wall on {card}")
    # a span's CPU-side row sums the kernels its torch ops launched (not
    # the hand-written kernels, launched through ctypes); its device-side row
    # is the span's extent on the device timeline, idle gaps included
    extent = {r.key: r.device_time_total for r in rows
              if r.key.startswith("tnt.") and r.device_type == DeviceType.CUDA}
    for row in sorted((r for r in rows if r.key.startswith("tnt.")
                       and r.device_type == DeviceType.CPU),
                      key=lambda r: r.key):
        print(f"stage {row.key}: torch-op kernels "
              f"{row.device_time_total / 1e3:.3f} ms, device extent "
              f"{extent.get(row.key, 0) / 1e3:.3f} ms, host "
              f"{row.cpu_time_total / 1e3:.3f} ms, calls {row.count}")
    events = prof.events()
    for span in sorted(extent):
        ops = [op for op in span_ops(events, span) if op[1] > 0]
        if ops:
            print(f"stage {span}, torch ops by their kernels' device time: "
                  + "; ".join(f"{name} {ms:.3f} ms in {calls} calls"
                              for name, ms, calls in ops))
    # the hand-written kernels; screen_dp's instantiations (one per register
    # width and for the eval condition) are rows of their own
    for name in launches.STEP_KERNELS:
        k_rows = [r for r in rows if name in r.key
                  and r.device_type == DeviceType.CUDA
                  and not r.is_user_annotation]
        for row in k_rows:
            print(f"{row.key}: {row.self_device_time_total / 1e3:.3f} ms in "
                  f"{row.count} launches")
        print(f"{name} kernels together: "
              f"{sum(r.self_device_time_total for r in k_rows) / 1e3:.3f} ms "
              f"in {sum(r.count for r in k_rows)} launches")
    # the plain evaluator's mark: it alone made thousands of these a run
    print("aten::where calls: "
          f"{sum(r.count for r in rows if r.key == 'aten::where')}")
    print(rows.table(sort_by="self_device_time_total", row_limit=20,
                     max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
