"""Time the pool and kept kernels against earlier versions and design steps
of their sources, and show where a block's time goes.

    python -m tntblast_tpu_torch.tools.compact_steps [--parent-csrc DIR]
                                                     [--timeline]

builds csrc/pool.cu and csrc/kept.cu as they ship, each design step below
(the shipped source with one of its choices undone, by a substitution in
its text), and the earlier sources in DIR when given; checks that each
build gives the shipped kernel's outputs on the bench step's own inputs
(the stage's call in the eager step of the bench panel on the 8 fragments
of tools/device_bench.py) and times each one alone: 20 calls captured in a
CUDA graph, replayed between CUDA events (tools/screen_probe.py graph_ms),
going through the list and back, then each launch by torch.profiler.  The
design steps:

  pool
    tile_2048      tiles of 2048 ranks (POOL_ITEMS 8): half the tiles with
                   valid ranks, a count table half as large
    match_ballots  a group's lanes of one key found by seven ballots, one a
                   bit of the key, in place of __match_any_sync
    pass_32        the count table's runs read 32 counts a pass (two
                   dependent passes on the bench step), not 64
    no_staging     each valid entry stored at its own place, a warp's lanes
                   into as many runs as it holds slots
    no_lean_tail   tiles without a valid rank through the full path (keys,
                   matches, shared tables)
  kept
    tile_512       tiles of 512 entries (KEPT_ITEMS 2)
    tile_2048      tiles of 2048 entries (KEPT_ITEMS 8)
    kmin_batch_16  kmin's rounds of 16 word indices an entry, not 8
    kmin_warp      kmin by a warp: the 32 lanes load 32 consecutive word
                   indices of one kept entry coalesced, 4 entries at a
                   time, one ballot each
    kmin_segments  kmin by segments of 8 lanes: a warp load reads 4 kept
                   entries' 8 consecutive words, 32 entries in flight
    whole_stream   every tile reads its entries and joins the look-back, and
                   every zero waits for n_kept (n_pool taken as Bp)
    late_count     a tile publishes its count only at its look-back, after
                   kmin

--parent-csrc names a directory with an earlier version of the sources
(`git archive <commit> tntblast_tpu_torch/csrc | tar -x -C DIR
--strip-components=2`), timed as `parent`. --timeline also builds each
shipped source with a timestamp at each phase of each block of its last
launch (clock64 and the global timer, into a __device__ array the host
reads after one call; tools/seed_steps.py's header) and prints the blocks'
lifetimes by role, the cycles of each phase and how many blocks are live
over the call. Builds go to _build/steps/. The last line is one JSON object
with the times and the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import statistics
import sys
import threading

import numpy as np
import torch

from tntblast_tpu_torch import _kernels
from tntblast_tpu_torch.ops import kept as K
from tntblast_tpu_torch.ops import pool as P
from tntblast_tpu_torch.tools.seed_steps import (
    TIMELINE_HEADER, build_variant, launch_ms, substituted)

# kmin by a warp: the 32 lanes test 32 consecutive word indices of one
# kept entry, 4 entries' loads in flight, one ballot each (the card's form
# only)
KEPT_KMIN_WARP = r'''__device__ __forceinline__ bool word_hit(const KeptArgs& a, const int* ow,
                                         int p, int f, int k)
{
    const int q = p + k;
    const size_t at = (size_t)f * a.nw_pos + clampi(q, 0, a.nw_pos - 1);
    const int o = ow[min(k, a.max_words - 1)];
    const int w = a.word[at];
    const uint8_t v = a.word_valid[at];
    return k < a.max_words && q >= 0 && q < a.nw_pos && o >= 0 && v != 0
        && w == o;
}

__device__ void kmin_warp(const KeptArgs& a, KeptShared& s, int w, int lane)
{
    for (int k = 0; k < KEPT_ITEMS; ++k) {
        const int g = k * KEPT_WARPS + w;
        unsigned m = s.mask[g];
        while (m != 0) {
            int x[4], p[4], f[4];
            const int* ow[4];
            bool live[4], hit[4];
            unsigned b[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                live[u] = m != 0;
                x[u] = g * 32 + (live[u] ? __ffs((int)m) - 1 : 0);
                m &= m - 1;
                p[u] = s.p[x[u]];
                f[u] = s.f[x[u]];
                ow[u] = a.ow + (size_t)clampi(s.sl[x[u]], 0, a.num_os - 1)
                    * a.max_words;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                hit[u] = word_hit(a, ow[u], p[u], f[u], lane);
#pragma unroll
            for (int u = 0; u < 4; ++u)
                b[u] = __ballot_sync(0xffffffffu, hit[u]);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                if (!live[u]) break;
                int km = b[u] != 0 ? __ffs((int)b[u]) - 1 : a.max_words;
                for (int k0 = 32; b[u] == 0 && k0 < a.max_words; k0 += 32) {
                    b[u] = __ballot_sync(0xffffffffu, word_hit(
                        a, ow[u], p[u], f[u], k0 + lane));
                    if (b[u] != 0) km = k0 + __ffs((int)b[u]) - 1;
                }
                if (lane == 0) s.kmin[x[u]] = km;
            }
        }
    }
}

// The places KEPT_ROWS rows'''

# seven ballots, one a bit of the key, find a group's lanes of one key
POOL_MATCH_BALLOTS = """    const unsigned v = (unsigned)(key + 1);
    unsigned peers = 0xffffffffu;
#pragma unroll
    for (int b = 0; b < 7; ++b) {
        const unsigned m = __ballot_sync(0xffffffffu, (v >> b) & 1u);
        peers &= (v >> b) & 1u ? m : ~m;
    }
    return peers;
"""

# kmin by segments of 8 lanes: a warp lists its kept entries in shared
# memory, and each segment tests 8 consecutive word indices of one entry a
# pass, so that a warp load reads 4 entries' words; 8 loads of each kind in
# flight (32 entries), one ballot each
KEPT_KMIN_SEGMENTS = r'''#define KMIN_SEG 8
#define KMIN_SEGS (32 / KMIN_SEG)
#define KMIN_LOADS 8
// Lane u of a kmin segment's test: word index k of a kept entry at
// diagonal p of fragment f whose oligo's words are `ow`.  Every load
// clamped into its row and issued without a branch, so that the loads of
// several entries go out together.
__device__ __forceinline__ bool word_hit(const KeptArgs& a, const int* ow,
                                         int p, int f, int k)
{
    const int q = p + k;
    const size_t at = (size_t)f * a.nw_pos + clampi(q, 0, a.nw_pos - 1);
    const int o = ow[min(k, a.max_words - 1)];
    const int w = a.word[at];
    const uint8_t v = a.word_valid[at];
    return k < a.max_words && q >= 0 && q < a.nw_pos && o >= 0 && v != 0
        && w == o;
}

// Thread t's kept entries into its warp's list (at warp * KEPT_ITEMS *
// 32), in the warp's order: round by round, lane by lane.
__device__ __forceinline__ void list_kept(KeptShared& s, int t)
{
    const int w = t >> 5;
    int pos = w * KEPT_ITEMS * 32;
    for (int k = 0; k < KEPT_ITEMS; ++k) {
        const int x = k * KEPT_THREADS + t;
        const unsigned m = s.mask[k * KEPT_WARPS + w];
        if (s.flag[x] != 0)
            s.list[pos + __popc(m & ((1u << (t & 31)) - 1u))] = x;
        pos += __popc(m);
    }
}

// kmin of entries i0 + q * KMIN_SEGS + seg (q < KMIN_LOADS) of a warp's
// list of n kept entries, by segment seg (lane / KMIN_SEG) of the warp: a
// pass tests KMIN_SEG word indices of each entry, one a lane, so that a
// warp load reads KMIN_SEGS entries' consecutive words coalesced; the
// loads of all the entries go out together, one ballot each gives every
// segment its entry's matches.  The lanes of a segment agree on every
// value; lane 0 of the segment writes kmin.
__device__ __forceinline__ void kmin_segment(const KeptArgs& a,
                                             KeptShared& s, const int* list,
                                             int n, int i0, int lane)
{
    const int seg = lane / KMIN_SEG, u = lane % KMIN_SEG;
    int x[KMIN_LOADS], p[KMIN_LOADS], f[KMIN_LOADS], km[KMIN_LOADS];
    const int* ow[KMIN_LOADS];
    bool open[KMIN_LOADS];
#pragma unroll
    for (int q = 0; q < KMIN_LOADS; ++q) {
        const int i = i0 + q * KMIN_SEGS + seg;
        open[q] = i < n;
        x[q] = list[min(i, n - 1)];
        p[q] = s.p[x[q]];
        f[q] = s.f[x[q]];
        ow[q] = a.ow + (size_t)clampi(s.sl[x[q]], 0, a.num_os - 1)
            * a.max_words;
        km[q] = a.max_words;
    }
    for (int k0 = 0; k0 < a.max_words; k0 += KMIN_SEG) {
        bool any = false;
        unsigned mine[KMIN_LOADS];
#pragma unroll
        for (int q = 0; q < KMIN_LOADS; ++q) any = any || open[q];
#ifdef KEPT_HOST
        if (!any) break;
        for (int q = 0; q < KMIN_LOADS; ++q) {
            mine[q] = 0;
            for (int v = 0; v < KMIN_SEG; ++v)
                mine[q] |= (unsigned)word_hit(a, ow[q], p[q], f[q], k0 + v)
                    << v;
        }
#else
        if (!__any_sync(0xffffffffu, any)) break;
        bool hit[KMIN_LOADS];
#pragma unroll
        for (int q = 0; q < KMIN_LOADS; ++q)
            hit[q] = open[q] && word_hit(a, ow[q], p[q], f[q], k0 + u);
#pragma unroll
        for (int q = 0; q < KMIN_LOADS; ++q)
            mine[q] = (__ballot_sync(0xffffffffu, hit[q]) >> (seg * KMIN_SEG))
                & (0xffffffffu >> (32 - KMIN_SEG));
#endif
#pragma unroll
        for (int q = 0; q < KMIN_LOADS; ++q)
            if (open[q] && mine[q] != 0) {
                km[q] = k0 + __ffs((int)mine[q]) - 1;
                open[q] = false;
            }
    }
    if (u == 0)
#pragma unroll
        for (int q = 0; q < KMIN_LOADS; ++q)
            if (i0 + q * KMIN_SEGS + seg < n) s.kmin[x[q]] = km[q];
}

// kmin of warp w's kept entries, KMIN_SEGS * KMIN_LOADS at a time.
__device__ void kmin_warp(const KeptArgs& a, KeptShared& s, int w, int lane)
{
    int n = 0;
    for (int k = 0; k < KEPT_ITEMS; ++k)
        n += __popc(s.mask[k * KEPT_WARPS + w]);
    const int* list = s.list + w * KEPT_ITEMS * 32;
    for (int i0 = 0; i0 < n; i0 += KMIN_SEGS * KMIN_LOADS) {
#ifdef KEPT_HOST
        for (int seg = 0; seg < KMIN_SEGS; ++seg)
            kmin_segment(a, s, list, n, i0, seg * KMIN_SEG);
#else
        kmin_segment(a, s, list, n, i0, lane);
#endif
    }
}

// The places KEPT_ROWS rows'''

KEPT_KMIN_CALL = ("    for (int i = 0; i < BLOCK_THREADS; ++i) kmin_rows(a, s, "
                  "THREAD(i));\n")
KEPT_WARP_CALL = ("    for (int i = 0; i < BLOCK_THREADS; ++i)\n"
                  "        kmin_warp(a, s, THREAD(i) >> 5, THREAD(i) & 31);\n")

STEPS = {
    "pool": {
        "tile_2048": [("#define POOL_ITEMS 4 ", "#define POOL_ITEMS 8 ")],
        "match_ballots": [("    return __match_any_sync(0xffffffffu, key);\n",
                           POOL_MATCH_BALLOTS)],
        "pass_32": [("#define POOL_PASS 64 ", "#define POOL_PASS 32 ")],
        "no_staging": [
            ("            s.st_p[at] = s.pv[x];\n"
             "            s.st_x[at] = (uint16_t)x;\n",
             "            const int g = s.base[key] + (at - s.loc[key]);\n"
             "            a.slot_str[g] = key;\n"
             "            a.p_str[g] = s.pv[x];\n"
             "            a.frag_str[g] = f;\n"
             "            a.order_str[g] = (int)(row + j * POOL_TILE + x);\n"),
            ("    const int nv = min(s.ncomp - j * POOL_TILE, POOL_TILE);\n",
             "    const int nv = 0;\n")],
        "no_lean_tail": [("    if (j * POOL_TILE >= s.ncomp) {     // the lean "
                          "path\n", "    if (false) {\n")],
    },
    "kept": {
        "tile_512": [("#define KEPT_ITEMS 4 ", "#define KEPT_ITEMS 2 ")],
        "tile_2048": [("#define KEPT_ITEMS 4 ", "#define KEPT_ITEMS 8 ")],
        "kmin_batch_16": [("#define KMIN_BATCH 8 ", "#define KMIN_BATCH 16 ")],
        "kmin_warp": [("// The places KEPT_ROWS rows", KEPT_KMIN_WARP),
                      (KEPT_KMIN_CALL, KEPT_WARP_CALL)],
        "kmin_segments": [
            ("// The places KEPT_ROWS rows", KEPT_KMIN_SEGMENTS),
            ("    int kmin[KEPT_TILE];                // of the kept entries\n",
             "    int kmin[KEPT_TILE];\n    int list[KEPT_TILE];\n"),
            (KEPT_KMIN_CALL,
             "    for (int i = 0; i < BLOCK_THREADS; ++i) list_kept(s, "
             "THREAD(i));\n    __syncwarp();\n" + KEPT_WARP_CALL)],
        "whole_stream": [("            if (t == 0) s.n_pool = np;\n",
                          "            if (t == 0) s.n_pool = a.Bp;\n")],
        "late_count": [
            ("            if (t == 0)\n"
             "                status_store(a.status + j, (j == 0 ? "
             "ST_INCLUSIVE\n",
             "            if (t == 0 && j == 0)\n"
             "                status_store(a.status + j, (j == 0 ? "
             "ST_INCLUSIVE\n"),
            ("            const long long excl = j == 0 ? 0 : lookback(a, j);\n",
             "            if (t == 0 && j > 0)\n"
             "                status_store(a.status + j, ST_AGGREGATE\n"
             "                             | (unsigned long long)s.total);\n"
             "            __syncwarp();\n"
             "            const long long excl = j == 0 ? 0 : lookback(a, j);\n"
             )],
    },
}

POOL_ID = "blockIdx.y * gridDim.x + blockIdx.x"
TIMELINE = {
    "pool": [
        ("#include <stdint.h>\n", "#include <stdint.h>\n" + TIMELINE_HEADER),
        ("    __syncthreads();\n    if (j * POOL_TILE >= s.ncomp) {",
         f"    TS({POOL_ID}, 0);\n    if (j * POOL_TILE >= s.ncomp) {{"),
        ("tail_tile(a, s, f, j, THREAD(i));\n        return;",
         f"tail_tile(a, s, f, j, THREAD(i));\n        TS({POOL_ID}, 5);\n"
         "        return;"),
        ("            (&s.place[0][0])[x] = 0;\n    }\n    __syncthreads();\n",
         "            (&s.place[0][0])[x] = 0;\n    }\n"
         f"    TS({POOL_ID}, 1);\n"),
        ("    // the runs' sums before each run; each slot's segments of groups\n",
         f"    TS({POOL_ID}, 2);\n"),
        ("    // the valid entries staged in the tile's order\n",
         f"    TS({POOL_ID}, 3);\n"),
        ("    // the runs out, consecutive threads at consecutive places; the "
         "invalid\n", f"    TS({POOL_ID}, 4);\n"),
        ("            a.order_str[at] = (int)(row + r);\n        }\n    }\n}\n",
         "            a.order_str[at] = (int)(row + r);\n        }\n    }\n"
         f"    TS({POOL_ID}, 5);\n}}\n"),
    ],
    "kept": [
        ("#include <stdint.h>\n", "#include <stdint.h>\n" + TIMELINE_HEADER),
        ("    __syncthreads();\n    if (s.tile >= a.tiles)\n",
         "    TS(s.tile, 0);\n    if (s.tile >= a.tiles)\n"),
        ("keep_flags(a, s, base, THREAD(i));\n    __syncthreads();\n",
         "keep_flags(a, s, base, THREAD(i));\n    TS(s.tile, 1);\n"),
        ("    // the first warp: the groups' prefix, the tile's count published\n",
         "    TS(s.tile, 2);\n"),
        ("    // the first warp: the tile's place, its inclusive count, n_kept\n",
         "    TS(s.tile, 3);\n"),
        ("    for (int i = 0; i < BLOCK_THREADS; ++i) kept_rows(a, s, base, "
         "THREAD(i));\n}",
         "    TS(s.tile, 4);\n    for (int i = 0; i < BLOCK_THREADS; ++i) "
         "kept_rows(a, s, base, THREAD(i));\n    TS(s.tile, 5);\n}"),
        ("    // a tile past the pooled prefix: nothing to read, and no tile "
         "reads\n    // its status word\n",
         "    TS(s.tile, 6);\n"),
    ],
}
PHASES = {"pool": ("fragment sums", "keys and count runs", "matches",
                   "scans and places", "staging", "stores"),
          "kept": ("ticket and n_pool", "flags", "ballots", "count and kmin",
                   "look-back", "gathers and rows", "end")}


def pool_runner(lib_path, args, *, num_os, cap, index):
    """A call of the pool library `lib_path` on `args` (slot, p, n_cand on
    a card) that allocates its outputs and scratch as that library asks,
    on the current stream; run.lib is the library."""
    lib = P.bind(ctypes.CDLL(lib_path))
    plan = P.make_plan(lib, num_os=num_os, cap=cap, index=index)
    n = args[0].shape[0]
    words = lib.pool_scratch_words(plan, n)
    dev = args[0].device

    def run():
        out = P.empty_outputs(n, cap, dev)
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        rc = lib.pool_launch_plan(*P.launch_args(plan, *args, out, scratch),
                                  torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pool launch failed: CUDA error {rc}")
        return out
    run.lib = lib
    return run


def kept_runner(lib_path, largs, bkcap, ow, thr, *, nw_pos, index):
    """A call of the kept library `lib_path` on a KeptPlan call's arguments
    `largs` and bkcap, under the oligo words and thresholds (ow, thr), that
    allocates its outputs and scratch as that library asks, on the current
    stream; run.lib is the library."""
    lib = K.bind(ctypes.CDLL(lib_path))
    num_os, max_words = ow.shape
    plan = K.make_plan(lib, ow, thr, num_os=num_os, num_cond=thr.shape[0],
                       max_words=max_words, nw_pos=nw_pos, index=index)
    Bp, n = largs[1].shape[0], largs[12].shape[0]
    words = lib.kept_scratch_words(Bp)
    dev = largs[1].device

    def run():
        out = K.empty_outputs(n, num_os, bkcap, dev)
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        rc = lib.kept_launch_plan(*K.launch_args(
            plan, largs[0], largs[1:7], largs[7], largs[8:10], largs[10:14],
            out, scratch, bkcap), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kept launch failed: CUDA error {rc}")
        return out
    run.lib = lib
    return run


def timeline(kernel, run, tiles):
    """The last launch's blocks by role: lifetimes, phase cycles and blocks
    live over the call, from one call of the timeline build (`tiles`: the
    kept launch's stream tiles, before its fill tiles)."""
    run()
    out = run()
    torch.cuda.synchronize()
    buf = np.zeros((16384, 12), np.uint64)
    run.lib.steps_read.argtypes = [ctypes.c_void_p]
    if run.lib.steps_read(buf.ctypes.data) != 0:
        raise RuntimeError("compact_steps: the timestamps did not copy")
    ids = np.nonzero(buf[:, 10])[0]
    rows = buf[ids].astype(np.int64)
    t0 = rows[:, 10].min()
    start, end = (rows[:, 10] - t0) / 1e3, (rows[:, 9] - t0) / 1e3
    last = len(PHASES[kernel]) - 1
    if kernel == "kept":
        role = np.where(ids >= tiles, "fill",
                        np.where(rows[:, 5] != 0, "pooled tile",
                                 "past the pool"))
    else:
        role = np.where(rows[:, 1] != 0, "valid tile", "lean tile")
    report = {"span_us": float(end.max()), "blocks": int(len(rows)),
              "sms": int(len(set(rows[:, 11]))), "roles": {},
              "live_at_share_of_span": {
                  f"{q:.2f}": int(((start <= q * end.max())
                                   & (end >= q * end.max())).sum())
                  for q in (0.1, 0.3, 0.5, 0.7, 0.9)}}
    for name in sorted(set(role)):
        mine = rows[role == name]
        life = (end - start)[role == name]
        phases = {}
        for k in range(1, last + 1):
            ok = (mine[:, k] != 0) & (mine[:, k - 1] != 0)
            if ok.any():
                d = mine[ok, k] - mine[ok, k - 1]
                phases[PHASES[kernel][k]] = (float(np.median(d)),
                                             float(np.percentile(d, 90)))
        report["roles"][name] = {
            "blocks": int(len(mine)),
            "lifetime_us_median": float(np.median(life)),
            "lifetime_us_p90": float(np.percentile(life, 90)),
            "end_us_max": float(end[role == name].max()),
            "phase_cycles_median_p90": phases}
    return report, out


def bench_calls():
    """The bench panel's pool and kept calls of one eager step on the 8
    bench fragments: (panel, pool args, kept args, bkcap)."""
    sys.path.insert(0, os.getcwd())
    import bench_data

    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.tools.bench_inputs import (
        bench_options, bench_panel, step_plan_inputs)
    from tntblast_tpu_torch.tools.device_bench import bench_fragments

    fna, panel = bench_data.build(os.path.join(os.getcwd(), "bench_work"))
    dp = bench_panel(fna, panel)
    frags = bench_fragments(bench_options(fna, panel, os.devnull),
                            open_database(fna), 8)
    pargs = step_plan_inputs(dp, frags, "pool_plan")[0]
    largs, lkw = step_plan_inputs(dp, frags, "kept_plan")
    return dp, pargs, largs, lkw["bkcap"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-csrc", default=None)
    ap.add_argument("--timeline", action="store_true")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compact_steps: no CUDA device", file=sys.stderr)
        return 2
    from tntblast_tpu_torch.tools.screen_probe import card_name, graph_ms

    jobs = {}
    for kernel in ("pool", "kept"):
        with open(os.path.join(_kernels.CSRC, f"{kernel}.cu")) as fh:
            text = fh.read()
        jobs[kernel, "shipped"] = text
        jobs.update(((kernel, name), substituted(text, subs, name))
                    for name, subs in STEPS[kernel].items())
        if opts.timeline:
            jobs[kernel, "timeline"] = substituted(text, TIMELINE[kernel],
                                                   "timeline")
    built, errors = {}, {}

    def build(key):
        try:
            built[key] = build_variant(key[1], jobs[key], kernel=key[0])[0]
        except Exception as e:      # noqa: BLE001 — reported below
            errors[key] = e

    threads = [threading.Thread(target=build, args=(k,)) for k in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise SystemExit(f"compact_steps: builds failed: {errors}")
    if opts.parent_csrc:
        for kernel in ("pool", "kept"):
            built[kernel, "parent"] = _kernels.build(
                kernel, force=True, tag="_parent", csrc=opts.parent_csrc)
    card = card_name()
    for kernel, name in built:
        for line in _kernels.ptxas_summary(
                _kernels.build_log[f"{kernel}_{name}"], "."):
            print(f"{kernel} {name}: ptxas: {line}")

    dp, pargs, largs, bkcap = bench_calls()
    cfg = dp.config
    index = pargs[0].device.index
    runs = {}
    for (kernel, name), lib in built.items():
        if kernel == "pool":
            runs[kernel, name] = pool_runner(lib, pargs, num_os=cfg.num_os,
                                             cap=cfg.cap, index=index)
        else:
            runs[kernel, name] = kept_runner(
                lib, largs, bkcap, dp.tabs["ow"], dp.tabs["slots"]["thr"],
                nw_pos=cfg.tile_len - cfg.word_len + 1, index=index)
    want = {"pool": dp.tabs["pool_plan"](*pargs),
            "kept": dp.tabs["kept_plan"](*largs, bkcap=bkcap)}
    torch.cuda.synchronize()
    same = {}
    for key, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        same[key] = all(torch.equal(g, w) for g, w in zip(got, want[key[0]]))
    result = {"card": card, "builds": {}}
    for kernel in ("pool", "kept"):
        timed = [k for k in runs if k[0] == kernel and k[1] != "timeline"]
        times = {k: [] for k in timed}
        for order in (timed, timed[::-1]):
            for key in order:
                times[key].append(graph_ms(runs[key]))
        for key in timed:
            ms = statistics.median(times[key])
            per = launch_ms(runs[key], kernel=kernel)
            print(f"{kernel} {key[1]}: alone {ms:.4f} ms (runs "
                  f"{[round(t, 4) for t in times[key]]}), per launch "
                  f"{ {k: round(v, 4) for k, v in per.items()} }, outputs "
                  f"{'equal to the shipped kernel' if same[key] else 'DIFFER'}"
                  f"; on {card}")
            result["builds"][f"{kernel} {key[1]}"] = {
                "ms": ms, "runs": times[key], "launch_ms": per,
                "equal": same[key]}
        if opts.timeline:
            tiles = -(-largs[1].shape[0]
                      // (_kernels.define("kept", "KEPT_THREADS")
                          * _kernels.define("kept", "KEPT_ITEMS")))
            report, out = timeline(kernel, runs[kernel, "timeline"], tiles)
            if not all(torch.equal(g, w) for g, w in zip(out, want[kernel])):
                raise SystemExit(f"compact_steps: the {kernel} timeline build "
                                 "differs")
            print(f"timeline {kernel}: {json.dumps(report)}")
            result[f"timeline_{kernel}"] = report
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
