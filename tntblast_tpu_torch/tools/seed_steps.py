"""Time the seeding kernel against earlier versions and design steps of its
source, and show where a block's time goes.

    python -m tntblast_tpu_torch.tools.seed_steps [--parent-csrc DIR]
                                                  [--timeline]

builds csrc/seed.cu as it ships, each design step below (the shipped
source with one of its choices undone, by a substitution in its text), and
the earlier sources in DIR when given; checks that each build gives the
shipped kernel's seven outputs on the bench step's 8 fragments (the panel
and fragments of tools/device_bench.py) and times each one alone: 20 calls
captured in a CUDA graph, replayed between CUDA events
(tools/screen_probe.py graph_ms), going through the list and back, then
each launch by torch.profiler.  The design steps:

    acquire        the look-back's status words read with ld.acquire and
                   written with st.release (an acquire load empties the
                   SM's L1 at every read of the spin)
    slot_atomics   the per-slot counts by one shared atomic a key, in place
                   of the warp vote
    cluster_1      clusters of one block: each block of the words launch
                   reads the fragment's whole run and exception lists

--parent-csrc names a directory with an earlier version of the sources
(`git archive <commit> tntblast_tpu_torch/csrc | tar -x -C DIR
--strip-components=2`), timed as `parent`.  --timeline also builds the
shipped source with a timestamp at each phase of each block (clock64 and
the global timer, into a __device__ array the host reads after one call)
and prints, for each launch, the blocks' lifetimes, the cycles of each
phase and how many blocks are live over the call.  Builds go to
_build/steps/.  One JSON line at the end holds the times with the card's
name and power limit.
"""

import argparse
import ctypes
import json
import os
import shutil
import statistics
import sys
import threading

import numpy as np
import torch

from tntblast_tpu_torch import _kernels
from tntblast_tpu_torch.ops import seed as S

SOURCE = os.path.join(_kernels.CSRC, "seed.cu")

STEPS = {
    "acquire": [
        ('asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(at));',
         'asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(at)'
         ' : "memory");'),
        ('asm volatile("st.relaxed.gpu.u64 [%0], %1;" :: "l"(at), "l"(v));',
         'asm volatile("st.release.gpu.u64 [%0], %1;" :: "l"(at), "l"(v)'
         ' : "memory");')],
    "slot_atomics": [
        ("__device__ void slot_counts(KeysShared& s)\n{\n",
         "__device__ void slot_counts(KeysShared& s)\n{\n"
         "    for (unsigned m = own_sets(s, threadIdx.x); m != 0;"
         " m &= m - 1) {\n"
         "        const int d = threadIdx.x * SEED_PER_THREAD"
         " + __ffs((int)m) - 1;\n"
         "        for (unsigned x = s.ulo[d]; x; x &= x - 1)\n"
         "            atomicAdd(&s.scount[__ffs((int)x) - 1], 1);\n"
         "        for (unsigned x = s.uhi[d]; x; x &= x - 1)\n"
         "            atomicAdd(&s.scount[31 + __ffs((int)x)], 1);\n"
         "    }\n    return;\n")],
    "cluster_1": [("#define SEED_CLUSTER 8 ", "#define SEED_CLUSTER 1 ")],
}

# the timeline: a timestamp after each phase of a block (after a barrier),
# into a __device__ array the host reads with steps_read (also
# tools/compact_steps.py)
TIMELINE_HEADER = r'''
__device__ unsigned long long steps_t[16384][12];
__device__ __forceinline__ unsigned long long steps_gtime()
{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
__device__ __forceinline__ unsigned steps_smid()
{
    unsigned r;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
    return r;
}
#define TS(id, k) do { __syncthreads(); if (threadIdx.x == 0) { \
    steps_t[id][k] = clock64(); steps_t[id][9] = steps_gtime(); \
    if (k == 0) { steps_t[id][10] = steps_gtime(); \
                  steps_t[id][11] = steps_smid(); } } } while (0)
extern "C" int steps_read(void* host)
{
    return (int)cudaMemcpyFromSymbol(host, steps_t, sizeof(steps_t));
}
'''
WORDS_ID = "f * a.gx + j"
KEYS_ID = "8192 + s.tile"
TIMELINE = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n" + TIMELINE_HEADER),
    ("    words_init(a, s, f, j);\n    cluster_sync();\n"
     "    words_scatter(a, s, f, j);\n    cluster_sync();\n",
     f"    TS({WORDS_ID}, 0);\n    words_init(a, s, f, j);\n"
     f"    cluster_sync();\n    TS({WORDS_ID}, 1);\n"
     f"    words_scatter(a, s, f, j);\n    cluster_sync();\n"
     f"    TS({WORDS_ID}, 2);\n"),
    ("        __syncthreads();\n    }\n    if (j >= a.nb1) return;",
     f"        __syncthreads();\n    }}\n    TS({WORDS_ID}, 3);\n"
     "    if (j >= a.nb1) return;"),
    ("            words_group(a, s, f, x0, hi, q_first + SEED_GROUP * g, "
     "slow);\n    __syncthreads();\n",
     "            words_group(a, s, f, x0, hi, q_first + SEED_GROUP * g, "
     f"slow);\n    TS({WORDS_ID}, 4);\n"),
    ("        if (j == 0 && f == 0 && t == 0) *a.ticket = 0;\n    }\n}",
     "        if (j == 0 && f == 0 && t == 0) *a.ticket = 0;\n    }\n"
     f"    TS({WORDS_ID}, 5);\n}}"),
    ("    const int f = s.tile / a.nb2, j = s.tile % a.nb2;\n",
     "    const int f = s.tile / a.nb2, j = s.tile % a.nb2;\n"
     f"    TS({KEYS_ID}, 0);\n"),
    ("    block_scan(s.part, s.wsum, &s.base);\n",
     f"    block_scan(s.part, s.wsum, &s.base);\n    TS({KEYS_ID}, 1);\n"),
    ("    for (int i = 0; i < BLOCK_THREADS; ++i) keys_truncate(a, s, "
     "THREAD(i));\n    __syncthreads();\n",
     "    for (int i = 0; i < BLOCK_THREADS; ++i) keys_truncate(a, s, "
     f"THREAD(i));\n    TS({KEYS_ID}, 2);\n"),
    ("        keys_scatter(a, s, f, j, THREAD(i));\n    __syncthreads();\n",
     f"        keys_scatter(a, s, f, j, THREAD(i));\n    TS({KEYS_ID}, 3);\n"),
    ("    block_scan(s.part, s.wsum, &s.total);\n    keys_publish(a, s, f, j);"
     "\n    __syncthreads();\n",
     f"    block_scan(s.part, s.wsum, &s.total);\n    TS({KEYS_ID}, 4);\n"
     f"    keys_publish(a, s, f, j);\n    TS({KEYS_ID}, 5);\n"),
    ("    for (int i = 0; i < BLOCK_THREADS; ++i) keys_emit(a, s, f, j, "
     "THREAD(i));\n}",
     "    for (int i = 0; i < BLOCK_THREADS; ++i) keys_emit(a, s, f, j, "
     f"THREAD(i));\n    TS({KEYS_ID}, 6);\n}}"),
]
PHASES = {"words": ("init", "scatter", "codes (blocks with overrides)",
                    "words and stores", "bits, count, resets"),
          "keys": ("counts before the tile", "truncation and list",
                   "scatter into U", "counts, slot counts, scan",
                   "look-back", "emit")}


def substituted(text, subs, what):
    """`text` with each (old, new) of `subs` replaced once."""
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{what}: the source no longer holds "
                               f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variant(name, text, kernel="seed"):
    """(library, source directory) of <kernel>.cu with the given text,
    beside the other sources, built into _build/steps/<kernel>_<name>."""
    d = os.path.join(_kernels.BUILD_DIR, "steps", f"{kernel}_{name}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_kernels.CSRC, d)
    with open(os.path.join(d, f"{kernel}.cu"), "w") as fh:
        fh.write(text)
    return _kernels.build(kernel, force=True, tag="_" + name, csrc=d), d


def earlier_seed_plan(lib_path, csrc, tables, **shapes):
    """(plan, scratch words a fragment, library) of a seed library built
    from the sources in `csrc`: until the tables derived from KS and VF
    (ops/seed.py::aux_tables) took its place, seed_plan read VF."""
    lib = S.bind(ctypes.CDLL(lib_path))
    with open(os.path.join(csrc, "seed.cu")) as fh:
        takes_aux = "const void* aux" in fh.read()
    if takes_aux:
        return (*S.make_plan(lib, *tables, **shapes), lib)
    plan = (ctypes.c_uint64 * -(-lib.seed_plan_bytes() // 8))()
    rc = lib.seed_plan(plan, tables[0].data_ptr(), tables[1].data_ptr(),
                       shapes["L"], shapes["word_len"], shapes["num_os"],
                       shapes["max_words"], shapes["cap"], shapes["index"])
    if rc != 0:
        raise RuntimeError(f"the earlier seed_plan refused the shapes: {rc}")
    return plan, lib.seed_scratch_words(plan, 1), lib


def runner(lib_path, csrc, plan, payload):
    """A call of the library's kernel on `payload` under `plan`'s tables
    and shapes, allocating its outputs and scratch, on the current
    stream."""
    cap, num_os, nw_pos = plan.shape
    L = payload[0].shape[1] * 4
    eplan, per, lib = earlier_seed_plan(
        lib_path, csrc, plan._tables, L=L, word_len=L - nw_pos + 1,
        num_os=num_os, max_words=plan._tables[0].shape[1], cap=cap,
        index=plan.index)
    n = payload[0].shape[0]

    def run():
        out = S.empty_outputs(n, *plan.shape, plan.device)
        scratch = torch.empty(n * per, dtype=torch.int32, device=plan.device)
        rc = lib.seed_launch_plan(*S.launch_args(eplan, payload, out,
                                                 scratch),
                                  torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"seed launch failed: CUDA error {rc}")
        return out
    run.lib = lib
    return run


def launch_ms(run, reps=20, kernel="seed"):
    """{kernel name: device ms a call} of the kernels whose names hold
    `kernel`, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    return {r.key.split("(")[0]: r.self_device_time_total / reps / 1e3
            for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA and kernel in r.key}


def timeline(run):
    """Per launch: its blocks' lifetimes and phases, from one call of the
    timeline build."""
    run()
    torch.cuda.synchronize()
    out = run()
    torch.cuda.synchronize()
    buf = np.zeros((16384, 12), np.uint64)
    run.lib.steps_read.argtypes = [ctypes.c_void_p]
    if run.lib.steps_read(buf.ctypes.data) != 0:
        raise RuntimeError("seed_steps: the timestamps did not copy")
    report = {}
    for name, rows in (("words", buf[:8192]), ("keys", buf[8192:])):
        rows = rows[rows[:, 10] != 0].astype(np.int64)
        t0 = rows[:, 10].min()
        start, end = (rows[:, 10] - t0) / 1e3, (rows[:, 9] - t0) / 1e3
        life = end - start
        phases = {}
        for k, phase in enumerate(PHASES[name], start=1):
            ok = rows[:, k] != 0
            d = rows[ok, k] - rows[ok, k - 1]
            phases[phase] = (float(np.median(d)), float(np.percentile(d, 90)))
        live = {f"{q:.2f}": int(((start <= q * end.max())
                                 & (end >= q * end.max())).sum())
                for q in (0.1, 0.3, 0.5, 0.7, 0.9)}
        report[name] = {
            "blocks": int(len(rows)), "sms": int(len(set(rows[:, 11]))),
            "span_us": float(end.max()),
            "lifetime_us_median": float(np.median(life)),
            "lifetime_us_p90": float(np.percentile(life, 90)),
            "phase_cycles_median_p90": phases,
            "live_at_share_of_span": live}
    return report, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-csrc", default=None)
    ap.add_argument("--timeline", action="store_true")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("seed_steps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import bench_data

    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.tools.bench_inputs import (
        bench_options, bench_panel)
    from tntblast_tpu_torch.tools.device_bench import bench_fragments
    from tntblast_tpu_torch.tools.screen_probe import card_name, graph_ms

    with open(SOURCE) as fh:
        text = fh.read()
    jobs = {"shipped": text}
    jobs.update((name, substituted(text, subs, name))
                for name, subs in STEPS.items())
    if opts.timeline:
        jobs["timeline"] = substituted(text, TIMELINE, "timeline")
    built, errors = {}, {}

    def build(name):
        try:
            built[name] = build_variant(name, jobs[name])
        except Exception as e:      # noqa: BLE001 — reported below
            errors[name] = e

    threads = [threading.Thread(target=build, args=(n,)) for n in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise SystemExit(f"seed_steps: builds failed: {errors}")
    if opts.parent_csrc:
        built["parent"] = (_kernels.build("seed", force=True, tag="_parent",
                                          csrc=opts.parent_csrc),
                           opts.parent_csrc)
    card = card_name()
    for name in built:
        for line in _kernels.ptxas_summary(
                _kernels.build_log["seed_" + name], "."):
            print(f"{name}: ptxas: {line}")

    work = os.path.join(os.getcwd(), "bench_work")
    fna, panel = bench_data.build(work)
    dp = bench_panel(fna, panel)
    plan = dp.tabs["seed_plan"]
    frags = bench_fragments(bench_options(fna, panel, os.devnull),
                            open_database(fna), 8)
    payload = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                    for a in dp._pack_host(frags)[:6])
    want = plan(*payload)
    torch.cuda.synchronize()
    runs, same = {}, {}
    for name, (lib, csrc) in built.items():
        runs[name] = runner(lib, csrc, plan, payload)
        got = runs[name]()
        torch.cuda.synchronize()
        same[name] = all(torch.equal(g, w) for g, w in zip(got, want))
    timed = [n for n in runs if n != "timeline"]
    times = {n: [] for n in timed}
    for order in (timed, timed[::-1]):
        for name in order:
            times[name].append(graph_ms(runs[name]))
    result = {"card": card, "builds": {}}
    for name in timed:
        ms = statistics.median(times[name])
        per = launch_ms(runs[name])
        print(f"{name}: alone {ms:.4f} ms (runs "
              f"{[round(t, 4) for t in times[name]]}), per launch "
              f"{ {k: round(v, 4) for k, v in per.items()} }, outputs "
              f"{'equal to the shipped kernel' if same[name] else 'DIFFER'}"
              f"; on {card}")
        result["builds"][name] = {"ms": ms, "runs": times[name],
                                  "launch_ms": per, "equal": same[name]}
    if opts.timeline:
        report, out = timeline(runs["timeline"])
        if not all(torch.equal(g, w) for g, w in zip(out, want)):
            raise SystemExit("seed_steps: the timeline build differs")
        for name, r in report.items():
            print(f"timeline {name}: {json.dumps(r)}")
        result["timeline"] = report
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
