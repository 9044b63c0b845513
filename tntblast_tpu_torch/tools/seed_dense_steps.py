"""Time the dense seeding kernel against earlier versions and design steps
of its source, and show where a tile's time goes.

    python -m tntblast_tpu_torch.tools.seed_dense_steps [--parent-csrc DIR]
                                                        [--timeline]
                                                        [--probes wide]

builds csrc/seed_dense.cu as it ships, each design step below (the shipped
source with one of its choices undone, by a substitution in its text), and
the earlier sources in DIR when given (as `parent`); checks that each
build gives the shipped kernel's seven outputs on the long-probe step's 8
fragments (tools/probe_bench.py, `--probes wide` the wide configuration)
and times each one alone: 20 calls captured in a CUDA graph
(tools/screen_probe.py graph_ms), three rounds, going through the list and
back.  The design steps:

    span_1024     tiles of 1024 diagonals (the shipped 2048 below 512 words)
    span_4096     tiles of 4096 diagonals
    threads_512   blocks of 512 threads

--timeline also builds the shipped source (and the parent's) with a
timestamp (the global timer) after each barrier of a tile, and prints the
mean and 90th percentile of each phase over the diagonal tiles, a tile's
lifetime and the launch's span.  Builds go to _build/steps/.  One JSON line
at the end holds the times with the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import re
import statistics
import sys

import numpy as np
import torch

from tntblast_tpu_torch import _kernels
from tntblast_tpu_torch.ops import seed as S
from tntblast_tpu_torch.tools.seed_steps import build_variant, substituted

SOURCE = os.path.join(_kernels.CSRC, "seed_dense.cu")

STEPS = {
    "span_1024": [("#define DENSE_SPAN 2048", "#define DENSE_SPAN 1024")],
    "span_4096": [("#define DENSE_SPAN 2048", "#define DENSE_SPAN 4096")],
    "threads_512": [("#define DENSE_THREADS 256", "#define DENSE_THREADS 512")],
}

# the timeline: the global timer after each barrier of a tile (and at its
# start), into a __device__ array the host reads with steps_read
TIMELINE_HEADER = r'''
__device__ unsigned long long steps_t[16384][16];
__device__ __forceinline__ unsigned long long steps_gtime()
{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#define TS(k) do { if (threadIdx.x == 0 && blockIdx.x < 16384) \
    steps_t[blockIdx.x][k] = steps_gtime(); } while (0)
extern "C" int steps_read(void* host)
{
    return (int)cudaMemcpyFromSymbol(host, steps_t, sizeof(steps_t));
}
'''
# a tile's block function, as it ships and in the first form
SIGNATURES = ("__device__ void dense_tile_block(const DenseArgs& a, "
              "DenseShared& s",
              "__device__ void dense_block(const DenseArgs& a, DenseShared& s")


def with_timeline(text):
    """The source with TS(k) at the start of a tile's block function and
    after each of its barriers and block scans; (text, stamps)."""
    sig = next(x for x in SIGNATURES if x in text)
    i = text.rindex(sig)               # the definition, not the declaration
    i = text.index("{", text.index(")", i))
    j = text.index("\n}\n", i)
    k = [0]

    def stamp(m):
        k[0] += 1
        return f"{m.group(0)} TS({k[0]});"

    body = re.sub(r"__syncthreads\(\);|block_scan\(s\.part, s\.wsum, "
                  r"&s\.total\);", stamp, text[i:j])
    body = body.replace("{", "{ TS(0);", 1)
    text = text[:i] + body + text[j:]
    return substituted(text, [("#include <stdint.h>\n",
                               "#include <stdint.h>\n" + TIMELINE_HEADER)],
                       "timeline"), k[0] + 1


def bind(path):
    """A seed_dense library's entry points, typed (an earlier one has no
    seed_dense_plan_tiling)."""
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, types, res in (
            ("seed_dense_plan_bytes", [], I),
            ("seed_dense_plan", [P] * 4 + [I] * 7, I),
            ("seed_dense_scratch_words", [P, I], ctypes.c_longlong),
            ("seed_dense_launch_plan", [P] * 15 + [I] * 3 + [P], I)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = res
    return lib


def runner(path, plan, payload, cfg):
    """A call of the library's kernel on `payload` under `plan`'s tables
    and shapes, allocating its outputs and scratch, on the current
    stream."""
    lib = bind(path)
    eplan, per = S.make_dense_plan(
        lib, plan._tables, L=cfg.tile_len, word_len=cfg.word_len,
        num_os=cfg.num_os, max_words=cfg.max_words, cap=cfg.cap,
        index=plan.index)
    n = payload[0].shape[0]

    def run():
        out = S.empty_outputs(n, *plan.shape, plan.device)
        scratch = torch.empty(n * per, dtype=torch.int32, device=plan.device)
        rc = lib.seed_dense_launch_plan(
            *S.launch_args(eplan, payload, out, scratch),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"seed_dense launch failed: CUDA error {rc}")
        return out
    run.lib = lib
    return run


def timeline(run, stamps):
    """Per phase of the diagonal tiles (the blocks that passed every
    stamp; a fill tile returns early), mean and 90th percentile in us;
    their lifetimes and the launch's span."""
    run()
    torch.cuda.synchronize()
    buf = np.zeros((16384, 16), np.uint64)
    if run.lib.steps_read(ctypes.c_void_p(buf.ctypes.data)) != 0:
        raise RuntimeError("steps_read failed")
    st = buf[:, :stamps].astype(np.float64)
    done = st[:, stamps - 1] > 0                 # diagonal tiles end here
    d = np.diff(st[done], axis=1) / 1e3
    life = (st[done, stamps - 1] - st[done, 0]) / 1e3
    used = st[st[:, 0] > 0]
    return {"tiles": int(done.sum()), "of_blocks": int(len(used)),
            "phase_us_mean": [round(x, 3) for x in d.mean(axis=0)],
            "phase_us_p90": [round(x, 3) for x in
                             np.percentile(d, 90, axis=0)],
            "tile_us_mean": round(float(life.mean()), 3),
            "tile_us_p90": round(float(np.percentile(life, 90)), 3),
            "launch_us": round(float((used.max() - used[:, 0].min()) / 1e3),
                               3)}


def main(argv=None):
    from tntblast_tpu_torch.tools.screen_probe import card_name, graph_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-csrc", default=None)
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--probes", default="long", choices=("long", "wide"))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("seed_dense_steps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import bench_data

    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.tools import probe_bench
    from tntblast_tpu_torch.tools.bench_inputs import (
        bench_options, bench_panel)
    from tntblast_tpu_torch.tools.device_bench import bench_fragments

    card = card_name()
    print(card)
    work = os.path.join(os.getcwd(), "bench_work")
    fna, _ = bench_data.build(work)
    probes = probe_bench.build(fna, work, opts.probes)
    search = probe_bench.CONFIGS[opts.probes]["args"]
    dp = bench_panel(fna, probes, args=search)
    frags = bench_fragments(bench_options(fna, probes, os.devnull, search),
                            open_database(fna), 8)
    payload = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                    for a in dp._pack_host(frags)[:6])
    plan, cfg = dp.tabs["seed_dense_plan"], dp.config
    with open(SOURCE) as fh:
        text = fh.read()
    builds = {name: build_variant(name, substituted(text, subs, name),
                                  "seed_dense")[0]
              for name, subs in STEPS.items()}
    if opts.parent_csrc:
        builds["parent"] = _kernels.build("seed_dense", force=True,
                                          tag="_parent",
                                          csrc=opts.parent_csrc)
    runs = {"shipped": lambda: plan(*payload)}
    want = runs["shipped"]()
    for name, path in builds.items():
        runs[name] = runner(path, plan, payload, cfg)
        got = runs[name]()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"seed_dense_steps: {name} differs from the "
                             f"shipped kernel")
    times = {name: [] for name in runs}
    order = list(runs)
    for rnd in range(3):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            times[name].append(graph_ms(runs[name]))
    result = {"card": card, "probes": opts.probes,
              "ms": {k: statistics.median(v) for k, v in times.items()},
              "ms_runs": times}
    for name, ms in result["ms"].items():
        print(f"seed_dense {name}: {ms:.4f} ms alone (CUDA graph of 20 "
              f"calls; runs {[round(x, 4) for x in times[name]]}) on "
              f"{card}")
    if opts.timeline:
        sources = {"shipped": text}
        if opts.parent_csrc:
            with open(os.path.join(opts.parent_csrc, "seed_dense.cu")) as fh:
                sources["parent"] = fh.read()
        result["timeline"] = {}
        for name, src in sources.items():
            ttext, stamps = with_timeline(src)
            path = build_variant(f"timeline_{name}", ttext, "seed_dense")[0]
            report = timeline(runner(path, plan, payload, cfg), stamps)
            result["timeline"][name] = report
            print(f"timeline {name}: {json.dumps(report)}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
