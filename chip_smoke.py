"""Smoke run of the PyTorch/CUDA port (tntblast_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. print the card (nvidia-smi name, power limit); build the eight CUDA
     kernels from csrc/ with nvcc, one compiler process per source, all at
     once; print what ptxas reports and fail if a kernel that keeps its DP
     row in registers, seed, seed_dense, pool, win_decode, eval_pack or
     kept has a stack frame or spills;
  2. screen_dp vs its plain PyTorch version on the card, at the main path's
     shapes: one 32768-window chunk of the bench panel's own tables (mixed
     slots, some invalid entries); best, mgmax and the valid M rows must be
     equal bit for bit; both times from CUDA events (launches queued back
     to back); the kernel's bound from this chunk's own cell and byte
     counts; the same windows slot-major, as the device step streams them;
     then one width of every other path of the kernel against the plain
     version: a narrow register width, one between two widths, and windows
     too wide for registers on the strip path (wt_max 64, 136, 308 and
     1032, the widest the kernel takes: oligos of 1024 nt), with the strip
     path's time alone and bound at each; the host time a call of the
     checked wrapper and of the panel's lean call (ScreenDpPlan);
  3. screen_probe vs its plain version at the TPU probe's full shapes
     (280 blocks of 512 windows), three variants, bit for bit; then the
     probe's own entry point (tntblast_tpu_torch.tools.screen_probe) with
     the launch count read around it;
  3b. eval_pack vs its plain version on the card at the main path's shapes:
     the bench panel's own oligos and tables, one 32768-entry chunk with
     planted sites (mixed slots, then slot-major), the M rows written by
     the screen_dp kernel just before; all five words of every entry must
     be equal bit for bit (dH/dS as int32), through the checked call and
     through the panel's lean call (EvalPackPlan); then synthetic panels
     at wq_max 16, 24, 56 with 1, 31, 4099 and 32768 entries, and at
     wq_max 150, 300 and 1024 (pieces of each row staged, 32-word pair
     bits) with 1, 31 and up to 4099 entries, each wide width's time alone
     and bound; the kernel's
     time alone from a CUDA graph of 20 launches (mixed, slot-major, and a
     chunk without a valid entry), each wrapper's host time a call, the
     plain version's time; the kernel's bound from the bytes this chunk's
     entries need, and its staging layout; where an earlier version of the
     sources is given (as for phase 3c), that version's eval_pack kernel
     checked and timed in turns with the shipped one on the bench chunk;
  3c. win_decode vs its plain version on the card, torch.equal on all six
     outputs, through the checked call and through the panel's lean call
     (WinDecodePlan): the bench step's real pooled stream (8 bench
     fragments, 360448 entries), then synthetic streams at wq_max 16, 17,
     24, 56 and 120 with 1, 31, 129, 4099 and 360448 entries (both
     strands, windows cut by a fragment's ends, N runs and degenerate
     bases; 129 ends one entry into a block, wq_max 17 makes a thread's
     four words cross entries), at wq_max 121, 300 and 1024 with up to
     40000 entries, and a stream without a valid entry; the
     kernel's time alone (CUDA graph of 20 launches) on the bench stream
     and on as many entries past the pool, each wrapper's host time a
     call, the plain version's time and the bound by bytes; where an
     earlier version of the sources is given (--parent-csrc DIR, default
     parent_csrc/ when it holds win_decode.cu), that version's kernel is
     checked and timed in turns with the shipped one (earlier, shipped,
     shipped, earlier); then the bench step's whole stream through the
     screen_dp and eval_pack kernels, as the step launches them (one
     launch each), each against its plain version, with their times alone;
  3d. seed vs its plain version on the card, torch.equal on all seven
     outputs (slot, p, n_cand, counts, overflow, word, word_valid), through
     the checked call and the panel's lean call (SeedPlan): the bench step's
     8 fragments, then synthetic payloads (tools/bench_inputs.seed_inputs)
     at word lengths 3, 7, 8 and 4, 8 to 64 slots, 1 to 31 words, shared
     and repeated words, N runs and exceptions, fragment lengths 0, below
     the word and below the tile, tiles past a block's end and of 8
     positions, and a cap that overflows; the bench step's lean call back
     to back on one plan, on scratch and outputs of 0xFF, and through 20
     replays of a CUDA graph of it; the kernel's time alone (CUDA graph of
     20 calls, its two launches each) and each launch's (torch.profiler),
     each wrapper's host time a call, the plain version's time, the bounds
     by bytes (the call's, each launch's) and the ptxas line; where an
     earlier version of the sources is given (as for phase 3c), that
     version's seed kernel is checked and timed in turns with the shipped
     one;
  3f. pool vs its plain version (a stable torch.sort and gathers) on the
     card, torch.equal on all five outputs (slot_str, p_str, frag_str,
     order_str, valid), through the checked call and the panel's lean call
     (PoolPlan): the bench step's real seed outputs (8 bench fragments, as
     the step hands them over), then synthetic ones (POOL_CASES: an
     overflowing and an empty fragment, 64 slots around the kernel's tile,
     a cap of 1, every entry invalid, one slot in every lane, a fragment
     whose candidates end on a tile's edge); 25 replays of a CUDA graph of
     the lean call, outputs set to 0xFF before each; the kernel's time
     alone (CUDA graph of 20 calls, two launches each) and each launch's
     (torch.profiler), each wrapper's host time a call, the plain version's
     time and the bound by bytes; beside them, as a yardstick of the
     primitive inside the function (not a call that computes it), one
     stable torch.sort of the bench step's keys; where an earlier version
     of the sources is given (as for phase 3c), that version's pool kernel
     is checked and timed in turns with the shipped one;
  3g. kept vs its plain version on the card, torch.equal on the header and
     the whole kept block, through the checked call and the panel's lean
     call (KeptPlan): the bench step's real stream (scores, routing, pool,
     words and the evaluator's words, as the step hands them over), then
     synthetic ones (KEPT_CASES: n_kept above bkcap, one condition without
     the evaluator, every entry invalid, oligos of 32 and 40 words as on
     the dense path); 25 replays of a CUDA graph of the lean call (its
     look-back's tile counter and status words reset inside each), outputs
     set to 0xFF before each; its times, host times, plain time and byte
     bound as for pool, beside them one torch.nonzero of its keep flags as
     a yardstick, and the earlier kept kernel in turns as for pool;
  3h. seed_dense vs its plain version on the card, torch.equal on all
     seven outputs, through the checked call and the long-probe panel's
     lean call (DenseSeedPlan): the long-probe step's 8 fragments
     (tools/probe_bench.py: 64 slots of 54 words, tiles of 2^19, cap
     131072), then synthetic payloads (SEED_DENSE_SHAPES: more non-empty
     diagonals than cap, more pairs than cap with every diagonal taken, 64
     slots of 113 words with hits in slot 63, 64 slots of 300 words, word
     length 3, a tile of 8; hits at negative diagonals in each); the lean
     call back to back on one
     plan, on scratch and outputs of 0xFF, and through 20 replays of a
     CUDA graph of it; the kernel's time alone (CUDA graph of 20 calls, its
     four launches each) and each launch's (torch.profiler), each wrapper's
     host time a call, the plain version's time (its (n, L + 54, 64)
     bitmap), the bound by bytes and the ptxas line; where an earlier
     version of the sources is given (as for phase 3c), that version's
     seed_dense kernel is checked and timed in turns with the shipped one;
  3e. the device step's CUDA graph (parallel/step_graph.py) against the
     eager step on the bench panel: three payloads of 8 bench fragments,
     full False and True, six graph steps in flight (the first of a key
     its capture) resolved last first; header, the used kept block and the
     five full outputs bit for bit; the card's reserved memory before and
     after the captures; the step's time by CUDA events and its host time
     to queue, graph and eager in turns, the capture's host time a key and
     the graph pool's bytes;
  4. the slice: the 8 Mb / 10-assay PCR bench config (bench_data.py)
     through the port's local_main with --tpu-screen T on the card, twice;
     the output's sha256 must equal the reference binary's, the step's
     kernels must have run as often as the steps ask (seed on the
     word-table path, pool, win_decode and kept once a step, screen_dp and
     eval_pack once a chunk of device_search.chunk_entries: once a step at
     the bench shapes; a count of 0 or another count fails, here and on
     every later path of the device step; the steps are counted where DevicePanel.step
     queues them, so a graph's replays count as its launches), no fragment
     may fall back to the host, and the second run, with a fresh panel
     manager, must replay the graphs of the first: no capture, no call of
     panel_step_core;
  4b. (run after phase 6) the long-probe search (tools/probe_bench.py: 32
     probes of 60 nt, 16 cut from the bench genome, -A PROBE -E 40 over its
     8 Mb) through local_main with --tpu-screen T on the card, twice, and
     through the host path: the device path's output sha256 must equal the
     host path's, with hits, 0 fallbacks, every panel on the dense seeding
     path (a (1, num_os) table and a DenseSeedPlan), and each kernel
     launched as often as its steps ask (seed_dense once a step, no seed,
     screen_dp and eval_pack once a chunk: eleven a step); the second run
     makes no capture; then the step's first chunk of its real stream
     (98304 entries) through one screen_dp launch at wt_max 68 (the strip
     path) against the plain version, its time alone and bound, and where
     an earlier version of the sources is given, that version's screen_dp
     (rows in shared memory) checked and timed in turns with it; then
     tools/device_bench --probes (graphed and eager batch_ms, chunks, stage
     extents, the graph pool); then the same search with --mesh T (a
     MeshPanel on the dense path, one fragment a card a step, seed_dense
     once a step) and on two ranks of parallel/multiproc.py on the card
     with --tpu-screen T (each rank's fragments, steps and launches its
     share's, tools/scaled_bench.py step_plan: seed_dense once a step,
     screen_dp and eval_pack once a chunk), each sha256-equal to the host
     path's with 0 fallbacks;
  4c. (run after phase 4b) the wide search (tools/probe_bench.py wide: 16
     probes of 150 nt, 8 cut from the bench genome, -A PROBE -E 40 -W 8
     over its 8 Mb; windows of 158 columns, past the 128 a window of the
     register and earlier kernels held) through local_main with
     --tpu-screen T on the card, twice, and through the host path, under
     phase 4b's gates (sha256 equal to the host path's, hits, 0 fallbacks,
     the dense path, launches as the steps ask: screen_dp and eval_pack 28
     times a step); then the step's first chunk (22400 entries) through
     one screen_dp and one eval_pack launch against their plain versions,
     their times alone and bounds; then tools/device_bench --probes wide;
  4d. (run after phase 4c) BASELINE config 5 (tools/scaled_bench.py: 10
     PCR assays, 5 planted 40 times a sequence, and 6 padlock assays, 4
     planted) at a reduced depth, the first of its eight 128 Mb sequences
     (a byte prefix of the 1.024 Gb database; 260 fragments of 500 kb):
     PCR and PADLOCK through local_main on the device path and the host
     path, sha256-equal, at least the planted sites as hits, 0 fallbacks,
     the fragments, steps and launches the database and the panel ask for
     (step_plan: steps of 8 fragments); PCR's device path again with a
     fresh panel manager (graph replays only), PCR on the mesh path, and
     PADLOCK on two ranks with --tpu-screen T --device cuda:0 (rank 0's
     output equal to the host path's, each rank's launches its share's);
     the phase prints its added seconds;
  5. the mesh path: the same config with --mesh T over make_mesh() (every
     visible card), under the same gates;
  6. three golden configs through `python -m tntblast_tpu_torch` on the
     card, byte-identical to the reference output; then the twelve
     configurations tests/test_e2e_screen.py holds for the JAX device path,
     through local_main(..., device="cuda") in this process, byte-identical
     with no fallback; then pcr_small with -W 3, whose 64-word table takes
     the dense seeding path (the seed_dense kernel once a step, no seed
     launch, no tensor-code seeding): byte-identical to pcr_small's
     recorded golden on the card;
  7. the multi-process runtime at full width: the bench config through two
     ranks of `python -m tntblast_tpu_torch.parallel.multiproc` on the card
     with --tpu-screen T; rank 0's output sha256 must equal the reference's,
     and every rank's profile line (TNTBLAST_TPU_PROFILE=1) must show
     win_decode launches and as many of seed, pool, screen_dp, eval_pack
     and kept (one chunk a step), no fallback and no module of jax or of
     the JAX package in that process; then pcr_frag with --mesh T on two
     ranks, byte-identical to its golden; a free port from the OS per run;
  8. the per-window screen: on seeded windows of the bench genome
     dp_max_score on the card == dp_scores_canon (the screen_dp kernel) ==
     dp_max_score on the CPU, bit for bit; with degenerate codes the card
     equals the CPU; screen_windows behind search/bind.py keeps every window
     the exact evaluator reports as a hit on the pcr_small golden, and every
     batch that path scores (its own padded shapes) equals dp_max_score on
     the card and on the CPU, bit for bit;
  9. the step entry point: entry("cuda") equals entry("cpu") on every
     output, then dryrun_multichip over every visible card;
 10. the device microbench (tools/device_bench.py): one run, its JSON line;
 11. nothing of jax or of the JAX package may have been imported, here
     (sys.modules) or in a rank (its profile line); the step graphs kept
     (each key's capture time) and the graph pool's bytes; one JSON line
     describing the kernels, then the result line.

On the card every step of phases 4 to 10 replays the step's CUDA graph of
its key (the first step of a key captures it); entry() calls
panel_step_core itself, eagerly.  From phase 3e to phase 10 every capture
in this process keeps its graph's template and its nodes are dumped:
its kernel nodes, by name, must be the launches the capture recorded (the
counts each replay adds), and none of them may sort; the ranks' and the
CLI runs' captures, in processes of their own, are held only by their
counts.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over 3.35e12 B/s (HBM3), and
its int32 operations over 64 lanes x 132 SMs x the SM clock nvidia-smi
reports while the kernel runs.  Operations per DP cell are the fewest the
recurrence needs on this card, a fused add-max counted once (OPS_PER_CELL
below).  eval_pack does a compare and a select a cell of its M block:
its bound is the block's bytes.  win_decode's arithmetic is a few integer
operations a column: its bound is the bytes of its outputs and of the
stream and words it reads.  seed's too: a few integer operations a
position, and its bytes are the payload and the panel's seed tables read
once and the words, their validity and the keys written once.  pool's
bytes are the pooled entries' slots and every p read once and its five
outputs written once; kept's what this run's entries need (kept_work) and
the header and the whole kept block written once.  seed_dense's are the
payload, the filter bits and the hash rows and entries of the held words
at valid positions read once, and its seven outputs written once.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

# sha256 of the reference tntblast v2.77 output on the bench config
# (the gate of bench.py:62 BENCH_GOLDEN_SHA256)
BENCH_GOLDEN_SHA256 = (
    "4394383a49dbcbe751377f977fa7509c124c243350c755a72bbf876156d66b05")
GOLDENS = ("pcr_small", "taqman", "padlock")
# through local_main in this process (tests/test_e2e_screen.py CONFIGS)
GOLDENS_IN_PROCESS = (
    "probe_small", "probe_dg", "pcr_small", "pcr_lowtm", "taqman", "degen",
    "padlock", "mips", "pcr_frag", "pcr_dinkelbach", "query_seg",
    "query_seg_frag")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, HBM3
INT32_LANES = 64 * 132             # int32 lanes per SM x SMs, per clock
# int32 operations a DP cell needs on this card, where an add followed by
# a max is one operation (DPX add-max): two adds and five add-max for M,
# I_target and I_query (7), the two clamps the next row reads (2), the
# column test and the best max (2), the table address from the packed pair
# value (2).  A cell of the eval condition adds the gapped-best channel
# (test, add, select, max, and its own best max: 5) and the M-row store (1).
OPS_PER_CELL = {"screen": 13, "eval": 19}
# (wq_max, windows) of the widths phase 2 holds against the plain version
# beside the bench's: wt_max = wq_max + 8 = 24 (the narrow register width),
# 28 (between the two: runs on width 32), 64, 136, 308 and 1032 (the strip
# path, to the widest window the kernel takes)
OTHER_WIDTHS = ((16, 8192), (20, 8192), (56, 2048), (128, 2048),
                (300, 1024), (1024, 256))
# windows of the strip path's time without the eval condition: 16384 fill
# the card's 132 SMs (3 blocks of 128 an SM, 32 blocks of them each)
STRIP_FILL = 16384
# eval_pack is held at these widths (wt_max + 1 odd at each up to 128: the
# span is copied as its image; the even pitch is held in tier-1; past a
# window of 128 columns pieces of each row are staged) and entry counts
# (around a warp and a block, and a whole chunk; fewer at the wide widths,
# whose M rows are 0.6-1.1 GB at the largest) beside the bench chunks
EVAL_WIDTHS = (16, 24, 56, 150, 300, 1024)
EVAL_BATCHES = (1, 31, 4099, 32768)
EVAL_WIDE_BATCHES = {150: (1, 31, 4099), 300: (1, 31, 2048),
                     1024: (1, 31, 256)}
# int32 operations eval_pack needs a cell of the M block: compare, select
EVAL_OPS_PER_CELL = 2
# win_decode is held at these widths (wt_max 24 .. 128; 25 is odd, so a
# thread's four words cross entries) and entry counts (around a warp and a
# block of 128 entries, and a bench step's whole stream) beside the bench
# step's stream
DECODE_WIDTHS = (16, 17, 24, 56, 120, 121, 300, 1024)
DECODE_BATCHES = (1, 31, 129, 4099, 360448)
# past wq_max 120 no more entries than this (a stream of 360448 windows of
# 1032 columns would be 3 GB of rows in each output and more in the plain
# version)
DECODE_WIDE_MAX_B = 40000
# int32 operations win_decode needs a column of a window (an estimate: the
# column test, the reversed index and its clamp, the word's shift and mask,
# the complement, the pair index and the store); its bound is bytes anyway
DECODE_OPS_PER_COLUMN = 8
# seed is held at these shapes beside the bench step's: (fragments, tile,
# word length, slots, words, cap, shared words, repeated words); the
# second overflows (word length 3: nearly every position is an any-match
# position), the third has 64 slots and 31-word oligos, the fourth a tile
# 4 positions past two blocks of 2048, the last a tile of 8
SEED_SHAPES = ((8, 1 << 19, 7, 40, 18, 45056, 0, 0),
               (2, 8192, 3, 8, 1, 512, 0, 0),
               (4, 65536, 8, 64, 31, 4096, 10, 10),
               (8, 2 * 2048 + 4, 7, 8, 18, 64, 6, 8),
               (1, 8, 4, 8, 2, 16, 0, 0))
# int32 operations seed needs a position (an estimate: the word's shift,
# mask and or and the validity test for each of its w bases, the table
# lookup and the bit): its bound is bytes anyway
SEED_OPS_PER_BASE = 4
# csrc/seed.cu's two launches' kernels, by name
SEED_LAUNCHES = ("seed_words_kernel", "seed_keys_kernel")
# csrc/seed_dense.cu's four launches' kernels, by name
SEED_DENSE_LAUNCHES = ("seed_dense_head_kernel", "seed_dense_kernel",
                       "seed_dense_scan_kernel", "seed_dense_emit_kernel")
# seed_dense is held at these shapes beside the long-probe step's
# (seed_dense_inputs; every panel has hits at negative diagonals): word
# length 4, where nearly every diagonal holds pairs, with a cap below the
# non-empty diagonals (n_pos > cap, n_cand > cap) and one between them and
# the pairs (sum(counts) > cap, n_pos <= cap); 64 slots of 113 words with
# hits in slot 63, shared and repeated words; word length 3 (the pcr_small
# -W 3 shapes); a tile of 8
SEED_DENSE_SHAPES = (
    (dict(n=2, L=16384, word_len=4, num_os=40, max_words=32, cap=3000),
     "more diagonals than cap"),
    (dict(n=2, L=16384, word_len=4, num_os=40, max_words=32, cap=60000),
     "more pairs than cap, every diagonal taken"),
    (dict(n=4, L=65536, word_len=7, num_os=64, max_words=113, cap=8192,
          share=10, repeat=10, empty=0), "64 slots of 113 words"),
    (dict(n=4, L=65536, word_len=7, num_os=64, max_words=300, cap=65536,
          share=10, repeat=10), "64 slots of 300 words"),
    (dict(n=2, L=8192, word_len=3, num_os=40, max_words=32, cap=2048),
     "word length 3"),
    (dict(n=1, L=8, word_len=4, num_os=8, max_words=2, cap=16),
     "a tile of 8"))
# the bench step's lean call back to back on one plan, and replays of a
# CUDA graph of it
SEED_BACK_TO_BACK = 4
SEED_REPLAYS = 20
# steps of each turn of the graph phase's timing
GRAPH_REPS = 6
# pool is held at these shapes beside the bench step's: (slots, cap,
# n_cand of each fragment, one slot for every entry); an overflowing and an
# empty fragment, 64 slots around two of the kernel's tiles of 1024, a cap
# of 1, every entry invalid, one slot in every lane of a group, and
# candidates that end on a tile's edge beside tiles without any
POOL_CASES = ((40, 45056, (9000, 45073, 0, 12000, 11000, 15000, 45056, 1),
               False),
              (64, 2049, (2049, 1024, 0, 5000), False),
              (8, 1, (1, 0, 2), False), (16, 3000, (0, 0, 0), False),
              (16, 5000, (5000, 4999, 100), True),
              (40, 10240, (2048, 4096, 0, 10240, 1), False))
# csrc/pool.cu's and csrc/kept.cu's launches' kernels, by name
POOL_LAUNCHES = ("pool_count_kernel", "pool_scatter_kernel")
KEPT_LAUNCHES = ("kept_head_kernel", "kept_kernel")
# kept is held at these shapes beside the bench step's (kept_inputs: n
# fragments of cap, screening conditions, the evaluator, bkcap, the share
# of candidates, words an oligo, the alphabet of the words): n_kept above
# bkcap, one condition without the evaluator, n_kept below bkcap, every
# entry invalid, and oligos of 32 and 40 words as the dense path takes,
# their words from 64 letters (many entries match no word of the first 32)
KEPT_CASES = ((8, 45056, 2, True, 4096, 0.3, 12, 4),
              (8, 5000, 1, False, 30000, 0.6, 12, 4),
              (4, 9000, 2, True, 20000, 0.6, 12, 4),
              (3, 4100, 2, True, 12000, 0.0, 12, 4),
              (4, 9000, 2, True, 30000, 0.6, 32, 64),
              (4, 9000, 2, True, 30000, 0.6, 40, 64))
# replays of a CUDA graph of the pool's and the kept compaction's lean
# calls on the bench step (the kept look-back's reset inside each replay)
STAGE_REPLAYS = 25
# int32 operations the pool needs an entry (an estimate: validity, key,
# the match, the rank, the place) and kept an entry (its flag and
# thresholds): their bound is bytes anyway
POOL_OPS_PER_ENTRY = 8
KEPT_OPS_PER_ENTRY = 8


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


class StepLaunches:
    """While active, counts the device steps that DevicePanel.step queues on
    a card, replays of the step's CUDA graph and captures alike, and the
    launches of the step's kernels they should make: seed once a step of a
    panel on the word-table path (its tables hold a seed plan), seed_dense
    once a step of one on the dense path (a dense seed plan), win_decode
    once a step, screen_dp once a chunk of chunk_entries, and eval_pack as
    often as screen_dp where the panel evaluates.  It counts steps, not
    calls of panel_step_core (which a replay does not make), so it holds
    the counts a graph's capture recorded to the steps that ran.  pool and
    kept run once a step on every path."""

    def __enter__(self):
        import torch

        from tntblast_tpu_torch.parallel import device_search as ds
        from tntblast_tpu_torch.tools import launches

        self.expected = dict.fromkeys(launches.STEP_KERNELS, 0)
        self._cls, self._real = ds.DevicePanel, ds.DevicePanel.step
        real = self._real

        def counted(dp, payload, full=False, device=None, tabs=None,
                    timer=None):
            on = dp.device if device is None else torch.device(device)
            if on.type == "cuda":
                cfg = dp.config
                chunks = len(ds.chunk_starts(len(payload[0]) * cfg.cap,
                                             cfg.wq_max, cfg.wt))
                self.expected["win_decode"] += 1
                self.expected["pool"] += 1
                self.expected["kept"] += 1
                on_tabs = dp.tabs if tabs is None else tabs
                if "seed_plan" in on_tabs:
                    self.expected["seed"] += 1
                if "seed_dense_plan" in on_tabs:
                    self.expected["seed_dense"] += 1
                self.expected["screen_dp"] += chunks
                if dp.eval_on:
                    self.expected["eval_pack"] += chunks
            return real(dp, payload, full, device, tabs, timer)

        ds.DevicePanel.step = counted
        launches.reset()
        return self

    def __exit__(self, *exc):
        self._cls.step = self._real
        return False

    def read(self, path, evaluator=True, table=True):
        """The launch counts since __enter__; a kernel of the step that
        `path` never launched, or launched another number of times than
        its steps ask, fails the run.  A panel without the device evaluator
        (`evaluator` False: --dinkelbach) must not launch eval_pack; a
        panel on the word-table path (`table`) seeds through the seed
        kernel every step, one on the dense path through the seed_dense
        kernel every step, and never through the other."""
        from tntblast_tpu_torch.tools import launches

        got = launches.counts()
        check(got["win_decode"] > 0 and got["screen_dp"] > 0,
              f"{path} never launched the step's kernels: {got}")
        check(evaluator == (self.expected["eval_pack"] > 0),
              f"{path}: the evaluator is {'on' if not evaluator else 'off'}")
        steps = self.expected["win_decode"]
        check(self.expected["seed"] == (steps if table else 0)
              and self.expected["seed_dense"] == (0 if table else steps),
              f"{path}: {self.expected['seed']} steps seeded by the table "
              f"kernel and {self.expected['seed_dense']} by the dense one "
              f"of {steps}, the {'table' if table else 'dense'} path "
              f"expected")
        check(got == self.expected,
              f"{path}: launches {got}, its steps ask for {self.expected}")
        return got


class CoreCalls:
    """While active, counts the calls of panel_step_core and the captures
    of the step's CUDA graph (`calls`, `captures`)."""

    def __enter__(self):
        from tntblast_tpu_torch.parallel import device_search as ds
        from tntblast_tpu_torch.parallel import step_graph

        self._ds, self._real = ds, ds.panel_step_core
        self._captures = step_graph.stats["captures"]
        self.calls = 0

        def counted(*args, **kw):
            self.calls += 1
            return self._real(*args, **kw)

        ds.panel_step_core = counted
        return self

    def __exit__(self, *exc):
        from tntblast_tpu_torch.parallel import step_graph

        self._ds.panel_step_core = self._real
        self.captures = step_graph.stats["captures"] - self._captures
        return False


def graph_launches(dot, eval_on):
    """{wrapper: launches} that a CUDA graph makes, from the kernel nodes
    of its cudaGraphDebugDotPrint dump `dot` (text), by their mangled
    names: a seed launch is seed_words_kernel and seed_keys_kernel; a
    seed_dense launch seed_dense_head_kernel, seed_dense_kernel,
    seed_dense_scan_kernel and seed_dense_emit_kernel; a pool
    launch pool_count_kernel and pool_scatter_kernel; a
    kept launch kept_head_kernel and kept_kernel; a screen_dp launch one
    kernel of its screening conditions (screen_dp_kernel<W, false> or
    screen_dp_strip_kernel<false>: Lb0E) and, where the panel evaluates
    (`eval_on`), one of the eval condition (Lb1E); win_decode and
    eval_pack one kernel each.  No node may sort (a cub or radix sort)."""
    names = re.findall(r"\| (_Z\w+)\\<\\<\\<", dot)
    check(names, "the graph's dump holds no kernel node")
    sorts = [k for k in names if "sort" in k.lower() or "radix" in k.lower()]
    check(not sorts, f"a step graph sorts: {sorts[:3]}")

    def ran(name, flag=""):
        return sum(1 for k in names if name in k and flag in k)

    def whole(parts):
        got = [ran(k) for k in parts]
        check(len(set(got)) == 1,
              f"a graph of {dict(zip(parts, got))} nodes: not whole launches")
        return got[0]

    seed = whole(SEED_LAUNCHES)
    seed_dense = whole(SEED_DENSE_LAUNCHES)
    screen = ran("screen_dp_", "Lb0E")
    evals = ran("screen_dp_", "Lb1E")
    check(evals == (screen if eval_on else 0),
          f"a graph of {screen} screen_dp nodes of the screening conditions "
          f"and {evals} of the eval condition (eval {eval_on})")
    return {"seed": seed, "seed_dense": seed_dense,
            "pool": whole(POOL_LAUNCHES),
            "win_decode": ran("win_decode_kernel"), "screen_dp": screen,
            "eval_pack": ran("eval_pack_kernel"),
            "kept": whole(KEPT_LAUNCHES)}


class GraphKernels:
    """While active, every capture of the step's CUDA graph keeps the
    graph's template (keep_graph, instantiated at the end of its capture as
    without it), and before the cache keeps the graph its nodes are dumped
    (cudaGraphDebugDotPrint, into `work`) and read: its kernel nodes, by
    name, must be the launches the capture recorded (the counts every
    replay of the graph adds to the wrappers'), so that the counts a
    replay adds are the kernels it launches.  `checked` counts the graphs
    held so."""

    def __init__(self, work):
        self.work = work

    def __enter__(self):
        import torch

        from tntblast_tpu_torch.parallel import step_graph

        self._sg, self._real = step_graph, step_graph._capture
        self.checked = 0
        real = self._real
        plain = torch.cuda.CUDAGraph

        class KeptGraph(plain):
            def __new__(cls):
                return super().__new__(cls, True)

            def __init__(self):
                super().__init__(True)     # keep_graph

            def capture_end(self):
                super().capture_end()
                self.instantiate()

        def captured(dp, payload, full, device, tabs):
            torch.cuda.CUDAGraph = KeptGraph
            try:
                entry, out = real(dp, payload, full, device, tabs)
            finally:
                torch.cuda.CUDAGraph = plain
            path = os.path.join(self.work, "step_graph.dot")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")     # debug_dump's notes
                entry.graph.debug_dump(path)
            check(os.path.exists(path), "the step graph was not dumped")
            with open(path) as fh:
                dot = fh.read()
            os.remove(path)
            got = graph_launches(dot, dp.eval_on)
            want = {name: entry.launches.get(name, 0) for name in got}
            check(got == want,
                  f"a step graph's kernel nodes {got}, its capture recorded "
                  f"{want} (tile {dp.config.tile_len}, full {full})")
            self.checked += 1
            return entry, out

        step_graph._capture = captured
        return self

    def __exit__(self, *exc):
        self._sg._capture = self._real
        return False


def sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def sm_clock_hz(torch, fn, ms):
    """The SM clock nvidia-smi reports while `fn` (one launch of about
    `ms` milliseconds) keeps the card busy for about a second."""
    for _ in range(max(10, int(1000.0 / max(ms, 0.01)))):
        fn()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def bound_ms(n_bytes, n_ops, clock_hz):
    """(bound in ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / (INT32_LANES * clock_hz) * 1e3
    return ((t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations"))


def screen_dp_work(args, n_real, eval_on):
    """(bytes, int32 operations, cells) screen_dp needs on its arguments
    `args` (ptb, slot, ql, wt_e, qp, tcan): invalid entries leave the kernel
    at once, a valid one runs ql rows of wt_max columns for every condition
    and, in the eval condition, stores ql M rows of wt_max + 1 words."""
    ptb, slot, ql = args[:3]
    B, wt_max = ptb.shape
    wq_max = args[4].shape[1]
    nc_all = args[5].shape[0]
    ok = (slot >= 0) & (slot < n_real)
    rows = int(ql.clamp(0, wq_max)[ok].long().sum())
    n_eval = 1 if eval_on else 0
    n_ops = rows * wt_max * ((nc_all - n_eval) * OPS_PER_CELL["screen"]
                             + n_eval * OPS_PER_CELL["eval"])
    n_bytes = (sum(a.numel() * a.element_size() for a in args)
               + 4 * (nc_all * B + B)
               + (4 * rows * (wt_max + 1) if eval_on else 0))
    return n_bytes, n_ops, rows * nc_all * wt_max


def kernel_vs_plain(torch, card, fna, panel):
    """Phase 2: screen_dp against screen_dp_reference on the card, its
    times and its bound."""
    import numpy as np

    from tntblast_tpu_torch.ops.screen_dp import (
        ScreenDpPlan, kernel_tables, kernel_width, screen_dp,
        screen_dp_reference)
    from tntblast_tpu_torch.parallel.device_search import (
        SCREEN_CHUNK, chunk_entries)
    from tntblast_tpu_torch.tools.bench_inputs import (
        bench_chunk, bench_panel, chunk_inputs, dp_errors)
    from tntblast_tpu_torch.tools.screen_probe import (
        cuda_ms, graph_ms, host_ms)

    dp = bench_panel(fna, panel)
    cfg = dp.config
    nc_all = dp.tabs["tc_all"].shape[0]
    print(f"bench panel: slots={dp.n_real} num_os={cfg.num_os} "
          f"wq_max={cfg.wq_max} num_cond={cfg.num_cond} nc_all={nc_all} "
          f"eval_on={dp.eval_on} tile={cfg.tile_len} cap={cfg.cap} "
          f"s_max={dp.s_max} k_max={dp.k_max}")

    B = SCREEN_CHUNK
    wt_max = cfg.wq_max + 8
    args, _, _ = bench_chunk(dp, B)
    # the tables as the kernel reads them: the panel's own, as the device
    # step passes them (every chunk below uses the panel's tc_all)
    tables = dp.tabs["tc_kernel"]
    check(torch.equal(tables, kernel_tables(dp.tabs["tc_all"])),
          "the panel's kernel tables are not kernel_tables(tc_all)")

    def compare(args, eval_on, what):
        got = screen_dp(*args, eval_on=eval_on, tables=tables)
        torch.cuda.synchronize()
        want = screen_dp_reference(*args, eval_on=eval_on)
        torch.cuda.synchronize()
        err = dp_errors(got, want, args, eval_on)
        wq = args[4].shape[1]
        print(f"screen_dp vs plain, {what}: B={args[0].shape[0]} "
              f"wq_max={wq} wt_max={wq + 8} nc_all={args[5].shape[0]} "
              f"eval_on={eval_on} (register width {kernel_width(wq + 8)}; "
              f"0 = the strip path): max_abs_err={max(err)} "
              f"(best, mgmax, M_rows = {err})")
        check(max(err) == 0,
              f"screen_dp kernel disagrees with its plain version ({what})")
        return max(err)

    max_err = compare(args, dp.eval_on, "bench chunk, mixed slots")
    sargs, _, _ = bench_chunk(dp, B, slot_major=True)
    max_err = max(max_err, compare(sargs, dp.eval_on,
                                   "bench chunk, slot-major"))
    # the panel's lean call, as the step makes it, gives the checked call's
    plan = dp.tabs["screen_plan"]
    for a in (args, sargs):
        lean = plan(*a[:4])
        err = dp_errors(lean, screen_dp(*a, eval_on=dp.eval_on,
                                         tables=tables), a, dp.eval_on)
        check(max(err) == 0, f"screen_dp lean call differs: {err}")
    # the other paths: the bench's tables, random qpair rows at other widths
    rng = np.random.default_rng(20261016)
    widths, strips = {}, []
    for wq, nb in OTHER_WIDTHS:
        qp = torch.from_numpy(
            rng.integers(0, 30, (12, wq)).astype(np.int32)).cuda()
        ql_slot = rng.integers(wq - 6, wq + 1, 12).astype(np.int32)
        oargs, _, _ = chunk_inputs(rng, nb, qp, ql_slot, dp.tabs["tc_all"],
                                   qp.device)
        for eval_on in (True, False):
            e = compare(oargs, eval_on, f"width path wt_max {wq + 8}")
            max_err = max(max_err, e)
        widths[str(wq + 8)] = kernel_width(wq + 8)
        if kernel_width(wq + 8) == 0:       # the strip path: timed below
            strips.append((wq, qp, ql_slot))

    def run_kernel():
        screen_dp(*args, eval_on=dp.eval_on, tables=tables)

    def run_plain():
        screen_dp_reference(*args, eval_on=dp.eval_on)

    # plain, kernel, kernel, plain
    p1 = cuda_ms(run_plain, 3, batches=1)
    k1 = cuda_ms(run_kernel, 20)
    k2 = cuda_ms(run_kernel, 20)
    p2 = cuda_ms(run_plain, 3, batches=1)
    k_ms = statistics.median([k1, k2])
    p_ms = statistics.median([p1, p2])
    print(f"screen_dp kernel: {k_ms:.4f} ms per 32768-window chunk "
          f"(runs {k1:.4f}, {k2:.4f}) on {card}")
    print(f"screen_dp plain PyTorch: {p_ms:.4f} ms per 32768-window chunk "
          f"(runs {p1:.4f}, {p2:.4f}) on {card}")
    # the same chunk without the eval outputs (no M-row store, no
    # gapped-best channel): what the recurrence and the table reads cost
    s_ms = cuda_ms(
        lambda: screen_dp(*args, eval_on=False, tables=tables), 20)
    print(f"screen_dp kernel with eval_on=False (same {nc_all} tables, no "
          f"M rows, no mgmax): {s_ms:.4f} ms per chunk on {card}")
    # the same windows in the order the device step streams them: a warp's
    # lanes then share their query pair and read one table row
    m_ms = cuda_ms(
        lambda: screen_dp(*sargs, eval_on=dp.eval_on, tables=tables), 20)
    ms_ms = cuda_ms(
        lambda: screen_dp(*sargs, eval_on=False, tables=tables), 20)
    print(f"screen_dp kernel, slot-major chunk: {m_ms:.4f} ms "
          f"(eval_on=False {ms_ms:.4f} ms) on {card}")
    # each wrapper's host time a call, on a chunk without a valid entry
    eargs = list(sargs)
    eargs[1] = torch.full_like(sargs[1], cfg.num_os)
    h_checked = host_ms(lambda: screen_dp(*eargs, eval_on=dp.eval_on,
                                          tables=tables))
    h_lean = host_ms(lambda: plan(*eargs[:4]))
    print(f"screen_dp host time a call on a chunk without a valid entry: "
          f"checked {1e3 * h_checked:.1f} us, lean (ScreenDpPlan) "
          f"{1e3 * h_lean:.1f} us; on {card}")

    n_bytes, n_ops, cells = screen_dp_work(args, dp.n_real, dp.eval_on)
    clock = sm_clock_hz(torch, run_kernel, k_ms)
    b_ms, b_by = bound_ms(n_bytes, n_ops, clock)
    print(f"screen_dp bound: {b_ms:.4f} ms by {b_by} ({cells} cells, "
          f"{OPS_PER_CELL['screen']} int32 ops a cell and "
          f"{OPS_PER_CELL['eval']} in the eval condition, at "
          f"{clock / 1e6:.0f} MHz; {n_bytes} bytes, "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); kernel is at "
          f"{100 * b_ms / k_ms:.1f}% of it "
          f"(slot-major {100 * b_ms / m_ms:.1f}%) on {card}")
    # the strip path alone at each of its widths: with the eval condition
    # on a chunk of the step's size at that width (chunk_entries: its M
    # rows within M_ROWS_BYTES), and without it on STRIP_FILL windows, which
    # fill the card at every width
    strip_rows = {}
    for wq, qp, ql_slot in strips:
        wt = wq + 8
        for eval_on, nb in ((True, min(SCREEN_CHUNK, chunk_entries(
                1 << 30, wq, wt))), (False, STRIP_FILL)):
            targs, _, _ = chunk_inputs(rng, nb, qp, ql_slot,
                                       dp.tabs["tc_all"], qp.device)
            splan = ScreenDpPlan(qp, dp.tabs["tc_all"], eval_on=eval_on,
                                 tables=tables)
            o_ms = graph_ms(lambda: splan(*targs[:4]))
            o_bytes, o_ops, o_cells = screen_dp_work(targs, 12, eval_on)
            ob_ms, ob_by = bound_ms(o_bytes, o_ops, clock)
            what = "eval on, a step's chunk" if eval_on else "eval off"
            print(f"screen_dp strip path at wt_max {wt} ({what}): {nb} "
                  f"windows ({o_cells} cells), kernel alone {o_ms:.4f} ms "
                  f"(CUDA graph of 20 launches), bound {ob_ms:.4f} ms by "
                  f"{ob_by} ({100 * ob_ms / o_ms:.1f}%); on {card}")
            key = f"wt{wt}" + ("" if eval_on else "_eval_off")
            strip_rows[f"ms_{key}"] = o_ms
            strip_rows[f"bound_ms_{key}"] = ob_ms
            del targs
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "host_ms_checked": h_checked, "host_ms_lean": h_lean,
            "ms_eval_off": s_ms,
            "ms_slot_major": m_ms, "ms_slot_major_eval_off": ms_ms,
            "width_of_wt_max": {str(wt_max): kernel_width(wt_max),
                                **widths}, **strip_rows}


def probe_phase(torch, card):
    """Phase 3: screen_probe against screen_probe_reference at the TPU
    probe's shapes, then its entry point with the launch count around it."""
    from tntblast_tpu_torch.ops.screen_probe import (
        screen_probe, screen_probe_reference)
    from tntblast_tpu_torch.tools import screen_probe as tool

    meta_np, ptb_np = tool.probe_inputs()
    dev = torch.device("cuda")
    meta = torch.from_numpy(meta_np).to(dev)
    ptb = torch.from_numpy(ptb_np).to(dev)
    kw = dict(wq_max=tool.WQ_MAX, nc_all=tool.NC_ALL)
    max_err = 0
    for name, n_sel in tool.VARIANTS:
        got = screen_probe(meta, ptb, n_sel, **kw)
        torch.cuda.synchronize()
        want = screen_probe_reference(meta, ptb, n_sel, **kw)
        err = int((got.long() - want.long()).abs().max())
        print(f"screen_probe {name} vs plain at n_blocks={tool.N_BLOCKS} "
              f"BB={tool.BB} wq_max={tool.WQ_MAX} wt_max={tool.WT_MAX} "
              f"nc_all={tool.NC_ALL}: max_abs_err={err} "
              f"best_max={int(got.max())}")
        check(err == 0, f"screen_probe {name} disagrees with its plain "
                        "version")
        max_err = max(max_err, err)

    # the probe's own path: the entry point a user calls
    screen_probe.launches = 0
    results = tool.run_variants("cuda")
    launches = screen_probe.launches
    check(launches > 0, "the probe entry point never launched screen_probe")
    cells = (tool.N_BLOCKS * tool.BB * tool.NC_ALL * tool.WQ_MAX
             * tool.WT_MAX)
    n_bytes = (meta.numel() + ptb.numel()
               + tool.N_BLOCKS * tool.NC_ALL * tool.BB) * 4
    out = {"max_abs_err": max_err, "launches": launches,
           "library_ms": None}
    for res in results:
        check(res["max_abs_err"] == 0,
              f"entry point: {res['variant']} disagrees")
        name, ms = res["variant"], res["ms"]
        print(f"screen_probe {name}: kernel {ms:.4f} ms, plain PyTorch "
              f"{res['plain_ms']:.4f} ms (median CUDA-event times) on "
              f"{card}")
        out[f"ms_{name}"] = ms
        out[f"plain_ms_{name}"] = res["plain_ms"]
    # the kernel's row in the table is its full variant, sel30
    out["ms"], out["plain_ms"] = out["ms_sel30"], out["plain_ms_sel30"]
    clock = sm_clock_hz(
        torch, lambda: screen_probe(meta, ptb, 30, **kw), out["ms"])
    screen_probe.launches = 0
    n_ops = cells * OPS_PER_CELL["screen"]
    out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, n_ops, clock)
    print(f"screen_probe sel30 bound: {out['bound_ms']:.4f} ms by "
          f"{out['bound_by']} ({cells} cells x {OPS_PER_CELL['screen']} int32 "
          f"ops at {clock / 1e6:.0f} MHz; {n_bytes} bytes); kernel is at "
          f"{100 * out['bound_ms'] / out['ms']:.1f}% of it on {card}")
    return out


def eval_pack_work(a):
    """(bytes, M cells) eval_pack needs on its arguments `a` (M_rows ..
    ent_valid, qc, ev_tabs, ev_loop): an invalid entry reads its flag and
    writes its five words; a valid one reads its ql x (wt_e + 1) M cells, its
    wt_e window codes, mgmax, slot, ql, wt_e and both flags; the panel's
    tables are read once."""
    import numpy as np

    valid = a[7].cpu().numpy()
    ql = a[4].cpu().numpy()[valid].astype(np.int64)
    wt_e = a[5].cpu().numpy()[valid].astype(np.int64)
    cells = int((ql * (wt_e + 1)).sum())
    n_bytes = (4 * cells + 4 * int(wt_e.sum()) + int(valid.sum()) * 17
               + len(valid) * (1 + 20)
               + sum(t.numel() * t.element_size() for t in a[8:11]))
    return n_bytes, cells


def eval_phase(torch, card, fna, panel, parent_lib=None):
    """Phase 3b: eval_pack against eval_pack_reference on the card (the
    checked call and the step's lean call), the kernel's time without the
    host's, each wrapper's host time a call, and the bound; and the kernel
    of an earlier version of the sources (`parent_lib`, a library built
    from them, or None) checked and timed in turns with it on the bench
    chunk."""
    import numpy as np

    from tntblast_tpu_torch import _kernels
    from tntblast_tpu_torch.ops.eval_pack import (
        EvalPackPlan, eval_pack, eval_pack_reference, layout)
    from tntblast_tpu_torch.parallel.device_search import (
        SCREEN_CHUNK, chunk_entries)
    from tntblast_tpu_torch.tools.bench_inputs import (
        bench_eval_chunk, bench_panel, eval_inputs, eval_stage_args,
        synthetic_eval_panel)
    from tntblast_tpu_torch.tools.screen_probe import (
        cuda_ms, graph_ms, host_ms)

    dp = bench_panel(fna, panel)
    check(dp.eval_on, "the bench panel runs without the evaluator")
    st = dp.tabs["slots"]
    B = SCREEN_CHUNK
    plan = dp.tabs["eval_plan"]     # the panel's lean call, as the step's

    def compare(args, const, what, lean=None):
        got = eval_pack(*args, const)
        torch.cuda.synchronize()
        want = eval_pack_reference(*args, const)
        torch.cuda.synchronize()
        n_bad = int((got != want).any(dim=1).sum())
        err = int((got.long() - want.long()).abs().max()) if len(got) else 0
        if lean is not None:
            n_lean = int((lean(*args[:8]) != want).any(dim=1).sum())
            check(n_lean == 0, f"eval_pack lean call: {n_lean} entries "
                               f"differ ({what})")
        valid = args[7]
        w0 = want[valid][:, 0]
        wq, n, w1 = args[0].shape
        print(f"eval_pack vs plain, {what}: B={n} wq_max={wq} "
              f"wt_max={w1 - 1} slots={args[9].shape[0]}: {n_bad} entries "
              f"differ, max_abs_err={err} over all five words (dH/dS as "
              f"int32){'; lean call equal' if lean is not None else ''}; "
              f"{int(valid.sum())} valid entries, "
              f"{int((w0 & 1).sum())} trusted, "
              f"{int(((w0 & 3) == 1).sum())} of them with a Tm to compute, "
              f"{int((((w0 >> 10) & 63) > 0).sum())} with mismatches")
        check(n_bad == 0 and err == 0,
              f"eval_pack kernel disagrees with its plain version ({what})")
        check(bool((got[~valid] == 0).all()),
              f"eval_pack: an invalid entry's words are not zero ({what})")
        check(n < 1000 or int(((w0 & 3) == 1).sum()) > n // 16,
              f"eval_pack: the chunk holds too few evaluated entries ({what})")
        return err

    tabs = (st["qc"], dp.tabs["ev_tabs"], dp.tabs["ev_loop"])
    args = eval_stage_args(bench_eval_chunk(dp, B), *tabs,
                           dp.tabs["tc_kernel"])
    max_err = compare(args, dp.eval_const, "bench chunk, mixed slots", plan)
    sargs = eval_stage_args(bench_eval_chunk(dp, B, slot_major=True), *tabs,
                            dp.tabs["tc_kernel"])
    max_err = max(max_err, compare(sargs, dp.eval_const,
                                   "bench chunk, slot-major", plan))
    # the kernel's one general path at other widths (odd and even pitch)
    # and at B around a warp and a block, behind the screen_dp kernel
    rng = np.random.default_rng(20261017)
    wide = []
    for wq in EVAL_WIDTHS:
        pan = synthetic_eval_panel(rng, 12, wq, "cuda")
        ptabs = (pan["qc"], pan["ev_tabs"], pan["ev_loop"])
        lean = EvalPackPlan(*ptabs, pan["eval_const"])
        for nb in EVAL_WIDE_BATCHES.get(wq, EVAL_BATCHES):
            oargs = eval_stage_args(
                eval_inputs(rng, nb, pan["qp"], pan["qc"], pan["ql_slot"],
                            pan["tcan"], "cuda", slot_major=True,
                            invalid=0.0 if nb == 1 else 0.03), *ptabs)
            max_err = max(max_err, compare(
                oargs, pan["eval_const"],
                f"synthetic panel, wq_max {wq}, B {nb}", lean))
        if wq in EVAL_WIDE_BATCHES:         # timed below
            wide.append((wq, pan, ptabs, lean))

    # the kernel alone: launches captured in a CUDA graph
    k_ms = graph_ms(lambda: plan(*args[:8]))
    turns = None
    if parent_lib is not None:
        import ctypes

        from tntblast_tpu_torch.ops import eval_pack as EP

        saved = _kernels._libs.get("eval_pack")
        _kernels._libs["eval_pack"] = EP.bind(ctypes.CDLL(parent_lib))
        try:
            eplan = EvalPackPlan(*tabs, dp.eval_const)
        finally:
            _kernels._libs["eval_pack"] = saved
        turns = _in_turns(torch, "eval_pack", card,
                          lambda: plan(*args[:8]),
                          lambda: (eplan(*args[:8]),),
                          (eval_pack_reference(*args, dp.eval_const),),
                          ("words",))
    m_ms = graph_ms(lambda: plan(*sargs[:8]))
    eargs = list(sargs)
    eargs[7] = torch.zeros_like(sargs[7])
    e_ms = graph_ms(lambda: plan(*eargs[:8]))
    # what a queue of launches through each wrapper sees (host time and
    # kernel overlapped), and each wrapper's host time a call on a chunk
    # without a valid entry, the case of 8 of a bench step's 11 chunks
    q_ms = cuda_ms(lambda: eval_pack(*sargs, dp.eval_const), 20)
    ql_ms = cuda_ms(lambda: plan(*sargs[:8]), 20)
    h_checked = host_ms(lambda: eval_pack(*eargs, dp.eval_const))
    h_lean = host_ms(lambda: plan(*eargs[:8]))

    def run_plain():
        eval_pack_reference(*args, dp.eval_const)

    p1 = cuda_ms(run_plain, 3, batches=1)
    p2 = cuda_ms(run_plain, 3, batches=1)
    p_ms = statistics.median([p1, p2])
    lay = layout(dp.config.wq_max + 8)
    print(f"eval_pack ptxas: "
          f"{_kernels.ptxas_summary(_kernels.build_log['eval_pack'], '.')}; "
          f"staging layout at the bench shapes: {lay} (dynamic shared "
          f"memory {lay['smem']} B a block of {lay['warps']} warps)")
    print(f"eval_pack kernel alone (CUDA graph of 20 launches): {k_ms:.4f} "
          f"ms per 32768-entry chunk, mixed slots; slot-major {m_ms:.4f} "
          f"ms; a chunk without a valid entry {e_ms:.4f} ms; on {card}")
    print(f"eval_pack queued through the wrapper, slot-major: checked call "
          f"{q_ms:.4f} ms, lean call {ql_ms:.4f} ms a launch; host time a "
          f"call on a chunk without a valid entry: checked "
          f"{1e3 * h_checked:.1f} us, lean {1e3 * h_lean:.1f} us; on {card}")
    print(f"eval_pack plain PyTorch (eval_flat + pack_eval): {p_ms:.4f} ms "
          f"per chunk (runs {p1:.4f}, {p2:.4f}) on {card}")

    n_bytes, cells = eval_pack_work(args)
    clock = sm_clock_hz(torch, lambda: plan(*args[:8]), k_ms)
    b_ms, b_by = bound_ms(n_bytes, cells * EVAL_OPS_PER_CELL, clock)
    s_bytes, s_cells = eval_pack_work(sargs)
    sb_ms = bound_ms(s_bytes, s_cells * EVAL_OPS_PER_CELL, clock)[0]
    print(f"eval_pack bound: {b_ms:.4f} ms by {b_by} ({n_bytes} bytes; "
          f"{cells} cells x {EVAL_OPS_PER_CELL} int32 ops at "
          f"{clock / 1e6:.0f} MHz take "
          f"{cells * EVAL_OPS_PER_CELL / (INT32_LANES * clock) * 1e3:.4f} "
          f"ms); the kernel alone is at {100 * b_ms / k_ms:.1f}% of it "
          f"(slot-major {100 * sb_ms / m_ms:.1f}% of its own {sb_ms:.4f} "
          f"ms) on {card}")
    # past a window of 128 columns: pieces of each row staged, the pair
    # bits in shared memory
    wide_rows = {}
    for wq, pan, ptabs, lean in wide:
        # a chunk of the step's size at this width
        nb = min(SCREEN_CHUNK, chunk_entries(1 << 30, wq, wq + 8))
        oargs = eval_stage_args(
            eval_inputs(rng, nb, pan["qp"], pan["qc"], pan["ql_slot"],
                        pan["tcan"], "cuda", slot_major=True, invalid=0.03),
            *ptabs)
        w_ms = graph_ms(lambda: lean(*oargs[:8]))
        w_bytes, w_cells = eval_pack_work(oargs)
        wb_ms, wb_by = bound_ms(w_bytes, w_cells * EVAL_OPS_PER_CELL, clock)
        print(f"eval_pack at wq_max {wq} (wt_max {wq + 8}, layout "
              f"{layout(wq + 8)}): {oargs[0].shape[1]} entries ({w_cells} "
              f"cells), kernel alone {w_ms:.4f} ms (CUDA graph of 20 "
              f"launches), bound {wb_ms:.4f} ms by {wb_by} "
              f"({100 * wb_ms / w_ms:.1f}%); on {card}")
        wide_rows[f"ms_wq{wq}"] = w_ms
        wide_rows[f"bound_ms_wq{wq}"] = wb_ms
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_slot_major": m_ms, "bound_ms_slot_major": sb_ms,
            "ms_all_invalid": e_ms, "ms_queued_checked": q_ms,
            "ms_queued_lean": ql_ms, "host_ms_checked": h_checked,
            "host_ms_lean": h_lean, "layout": lay, **wide_rows,
            **({"ms_turns": turns,
                "ms_earlier": statistics.median(turns["earlier"])}
               if turns else {})}


def decode_phase(torch, card, fna, panel, parent_lib=None):
    """Phase 3c: win_decode against win_decode_reference on the card,
    through the checked call and the panel's lean call, its times and
    bound, and beside it the kernel of an earlier version of the sources
    (`parent_lib`, a library built from them, or None); then the bench
    step's whole stream through the screen_dp and eval_pack kernels against
    their plain versions."""
    import ctypes

    import numpy as np

    from tntblast_tpu_torch import _kernels
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.ops.eval_pack import eval_pack_reference
    from tntblast_tpu_torch.ops.screen_dp import screen_dp_reference
    from tntblast_tpu_torch.ops.win_decode import (
        WinDecodePlan, empty_outputs, launch_args, win_decode,
        win_decode_reference)
    from tntblast_tpu_torch.tools.bench_inputs import (
        bench_options, bench_panel, decode_inputs, dp_errors,
        step_decode_inputs)
    from tntblast_tpu_torch.tools.device_bench import bench_fragments
    from tntblast_tpu_torch.tools.screen_probe import (
        cuda_ms, graph_ms, host_ms)

    names = ("needs_host", "tb5", "ptb", "ql", "wt_e", "ent_valid")
    statics = ("L", "wt_max", "word_len", "nw_pos", "num_os")

    def lean_of(args, kw):
        return WinDecodePlan(args[6], args[7],
                             **{k: kw[k] for k in statics})

    def compare(args, kw, what, lean=None):
        got = win_decode(*args, **kw)
        lean_got = (lean or lean_of(args, kw))(*args[:6])
        torch.cuda.synchronize()
        want = win_decode_reference(*args, **kw)
        torch.cuda.synchronize()
        bad = [n for n, g, w in zip(names, got, want)
               if not torch.equal(g, w)]
        bad_lean = [n for n, g, w in zip(names, lean_got, want)
                    if not torch.equal(g, w)]
        err = max((int((g.long() - w.long()).abs().max()) if g.numel()
                   else 0) for out in (got, lean_got)
                  for g, w in zip(out, want))
        nh, ev = want[0], want[5]
        minus = args[7][args[0].clamp(0, kw["num_os"]).long()] & ev
        print(f"win_decode vs plain, {what}: B={args[0].shape[0]} "
              f"wt_max={kw['wt_max']} word_len={kw['word_len']}: checked "
              f"call {'equal on all six outputs' if not bad else bad}, "
              f"lean call {'equal' if not bad_lean else bad_lean} "
              f"(max_abs_err={err}); {int(ev.sum())} valid entries, "
              f"{int(minus.sum())} on the minus strand, "
              f"{int(nh.sum())} need the host")
        check(not bad and not bad_lean and err == 0,
              f"win_decode kernel disagrees with its plain version ({what}): "
              f"checked {bad}, lean {bad_lean}")
        check(not bool(torch.cat([o.reshape(len(o), -1)[~ev].reshape(-1)
                                  .long() for o in got]).any()),
              f"win_decode: an entry past the pool is not zeros ({what})")
        return got, err

    dp = bench_panel(fna, panel)
    opt = bench_options(fna, panel, os.devnull)
    frags = bench_fragments(opt, open_database(fna), 8)
    args, kw = step_decode_inputs(dp, frags)
    B = args[0].shape[0]
    check(B == 8 * dp.config.cap, f"the bench step's stream has {B} entries")
    plan = dp.tabs["decode_plan"]   # the panel's lean call, as the step's
    out, max_err = compare(args, kw, "the bench step's pooled stream", plan)
    rng = np.random.default_rng(20261018)
    for wq in DECODE_WIDTHS:
        batches = sorted({min(nb, DECODE_WIDE_MAX_B) if wq > 120 else nb
                          for nb in DECODE_BATCHES})
        for nb in batches:
            sargs, skw = decode_inputs(rng, nb, wq, "cuda",
                                       invalid=0.0 if nb == 1 else 0.25)
            max_err = max(max_err, compare(
                sargs, skw, f"synthetic stream, wq_max {wq}")[1])
    iargs, ikw = decode_inputs(rng, 4099, 24, "cuda", invalid=1.0)
    max_err = max(max_err, compare(iargs, ikw, "a stream past the pool")[1])

    def run_kernel():
        plan(*args[:6])

    # the same number of entries, every one past the pool: what the stores
    # of zeros cost alone
    zargs = (torch.full_like(args[0], kw["num_os"]), *args[1:])
    runs = {"shipped": (run_kernel, lambda: plan(*zargs[:6]))}
    if parent_lib is not None:
        P, I = ctypes.c_void_p, ctypes.c_int
        entry = ctypes.CDLL(parent_lib).win_decode_launch
        entry.argtypes = [P] * 14 + [I] * 8 + [P]
        entry.restype = ctypes.c_int

        def earlier(a):
            def run():
                o = empty_outputs(B, kw["wt_max"], "cuda")
                # the current stream, read each call: a graph's capture
                rc = entry(*launch_args(*a, o, **kw), a[0].device.index,
                           torch.cuda.current_stream().cuda_stream)
                check(rc == 0, f"the earlier win_decode failed: {rc}")
                return o
            return run

        p_out = earlier(args)()
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(p_out, out)),
              "the earlier win_decode differs from the shipped one")
        runs["earlier"] = (earlier(args), earlier(zargs))
    # the earlier kernel, the shipped one, the shipped one, the earlier one
    order = (["earlier", "shipped", "shipped", "earlier"]
             if parent_lib is not None else ["shipped"])
    turns = {name: [] for name in runs}
    for name in order:
        turns[name].append((graph_ms(runs[name][0]),
                            graph_ms(runs[name][1])))
    k_ms = statistics.median(t[0] for t in turns["shipped"])
    z_ms = statistics.median(t[1] for t in turns["shipped"])
    q_ms = cuda_ms(run_kernel, 20)
    h_lean = host_ms(lambda: plan(*zargs[:6]))
    h_checked = host_ms(lambda: win_decode(*zargs, **kw))
    p1 = cuda_ms(lambda: win_decode_reference(*args, **kw), 3, batches=1)
    p2 = cuda_ms(lambda: win_decode_reference(*args, **kw), 3, batches=1)
    p_ms = statistics.median([p1, p2])
    ptxas = _kernels.ptxas_summary(_kernels.build_log["win_decode"], ".")
    print(f"win_decode ptxas: {ptxas}")
    print(f"win_decode kernel alone (CUDA graph of 20 launches): {k_ms:.4f} "
          f"ms for the bench step's {B} entries, {z_ms:.4f} ms for as many "
          f"entries all past the pool (zeros stored, nothing read but the "
          f"slot); lean call queued {q_ms:.4f} ms a launch; host time a "
          f"call past the pool: lean (WinDecodePlan) {1e3 * h_lean:.1f} us, "
          f"checked {1e3 * h_checked:.1f} us; plain PyTorch {p_ms:.4f} ms "
          f"(runs {p1:.4f}, {p2:.4f}); on {card}")
    if parent_lib is not None:
        print(f"win_decode in turns (earlier, shipped, shipped, earlier; "
              f"bench stream / all past the pool, ms): earlier "
              f"{turns['earlier']}, shipped {turns['shipped']}; on {card}")

    # the bound, from what this stream needs: every entry reads its slot and
    # writes its two rows and four scalars; a valid one reads its p and
    # fragment and the words (and validity bytes) that cover its wt_e
    # columns; the tables are read once
    ev = out[5]
    wt_e = out[4][ev].long()
    n_valid = int(ev.sum())
    words = int(((wt_e + kw["word_len"] - 1) // kw["word_len"]).sum())
    n_bytes = (4 * B + 8 * n_valid + 5 * words
               + sum(t.numel() * t.element_size() for t in args[3:4] + args[6:])
               + B * (8 * kw["wt_max"] + 10))
    n_ops = n_valid * kw["wt_max"] * DECODE_OPS_PER_COLUMN
    clock = sm_clock_hz(torch, run_kernel, k_ms)
    b_ms, b_by = bound_ms(n_bytes, n_ops, clock)
    print(f"win_decode bound: {b_ms:.4f} ms by {b_by} ({n_bytes} bytes: "
          f"{n_valid} valid entries of {B}, {words} covering words; "
          f"{n_ops} int32 ops at {clock / 1e6:.0f} MHz take "
          f"{n_ops / (INT32_LANES * clock) * 1e3:.4f} ms); the kernel alone "
          f"is at {100 * b_ms / k_ms:.1f}% of it on {card}")
    if parent_lib is not None:
        e_ms = statistics.median(t[0] for t in turns["earlier"])
        print(f"win_decode earlier kernel alone {e_ms:.4f} ms, at "
              f"{100 * b_ms / e_ms:.1f}% of the same bound, in the same "
              f"call; the shipped one {e_ms / k_ms:.2f}x faster, on {card}")
    row = {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "ms_all_invalid": z_ms, "ms_queued": q_ms,
           "host_ms_lean": h_lean, "host_ms_checked": h_checked,
           "entries": B, "valid_entries": n_valid, "ptxas": ptxas}
    if parent_lib is not None:
        row["ms_turns"] = turns
        row["ms_earlier"] = statistics.median(t[0] for t in turns["earlier"])
        row["ms_all_invalid_earlier"] = statistics.median(
            t[1] for t in turns["earlier"])

    # the step's other two kernels on this whole stream, one launch each,
    # as the step makes them (the panel's lean calls)
    nh, tb5, ptb, ql, wt_e_all, ent_valid = out
    slot = args[0]
    st = dp.tabs["slots"]
    sargs = (ptb, slot, ql, wt_e_all, st["qp"], dp.tabs["tc_all"])
    screen, plan = dp.tabs["screen_plan"], dp.tabs["eval_plan"]
    best, mgmax, M_rows = screen(*sargs[:4])
    torch.cuda.synchronize()
    want = screen_dp_reference(*sargs, eval_on=True)
    err = dp_errors((best, mgmax, M_rows), want, sargs, True)
    del want
    check(max(err) == 0, f"screen_dp on the bench step's stream: {err}")
    eargs = (M_rows, mgmax, tb5, slot, ql, wt_e_all, nh, ent_valid,
             st["qc"], dp.tabs["ev_tabs"], dp.tabs["ev_loop"])
    words_k = plan(*eargs[:8])
    torch.cuda.synchronize()
    n_bad = int((words_k != eval_pack_reference(*eargs, dp.eval_const))
                .any(dim=1).sum())
    check(n_bad == 0, f"eval_pack on the bench step's stream: {n_bad} "
                      "entries differ")
    s_ms = graph_ms(lambda: screen(*sargs[:4]))
    e_ms = graph_ms(lambda: plan(*eargs[:8]))
    s_bytes, s_ops, _ = screen_dp_work(sargs, dp.n_real, True)
    sb_ms, sb_by = bound_ms(s_bytes, s_ops, clock)
    e_bytes, e_cells = eval_pack_work(eargs)
    eb_ms, eb_by = bound_ms(e_bytes, e_cells * EVAL_OPS_PER_CELL, clock)
    print(f"the bench step's whole stream ({B} entries, {n_valid} valid) "
          f"through one launch of each: screen_dp == plain (best, mgmax, "
          f"M rows {err}), kernel alone {s_ms:.4f} ms, bound {sb_ms:.4f} ms "
          f"by {sb_by} ({100 * sb_ms / s_ms:.1f}%); eval_pack == plain on "
          f"all five words, kernel alone {e_ms:.4f} ms, bound {eb_ms:.4f} "
          f"ms by {eb_by} ({100 * eb_ms / e_ms:.1f}%); on {card}")
    stream = {"screen_dp": {"ms_step_stream": s_ms,
                            "bound_ms_step_stream": sb_ms},
              "eval_pack": {"ms_step_stream": e_ms,
                            "bound_ms_step_stream": eb_ms}}
    return row, stream


def seed_work(args, out, tables):
    """Bytes and int32 operations a seed call needs, as a dict: `bytes`
    for the whole call (the payload read once; the panel's VF table
    (`tables`: KS, VF of the plan) read once, and the KS rows of the words
    at this call's in-positions (valid words some oligo holds, the first
    cap of a fragment), each row once; the seven outputs written once),
    `ks_bytes` of it, `ops` (a few a base of every word), and each
    launch's own: `words_bytes` (the payload, VF, word and word_valid, and
    the in-position bits and block counts it hands on) and `keys_bytes`
    (those bits and counts, the words at the kept in-positions, the KS
    rows, and slot, p, n_cand, counts and overflow)."""
    from tntblast_tpu_torch import _kernels

    ks, vf = tables
    word, valid, cap = out[5], out[6], out[0].shape[1]
    n, nw_pos = word.shape
    held = valid & ((vf[word.long()] & 1) != 0)
    rank = held.int().cumsum(dim=1)
    kept = held & (rank <= cap)
    rows = word[kept].unique().numel()
    ks_bytes = rows * ks.shape[1] * ks.element_size()

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    payload = nbytes(args[:6])
    vf_bytes = vf.numel() * vf.element_size()
    span = _kernels.define("seed", "SEED_SPAN")
    blocks = -(-nw_pos // span)
    handed = n * blocks * (span // 8 + 4)           # bits and a count
    words_bytes = payload + vf_bytes + nbytes(out[5:]) + handed
    keys_bytes = (handed + 4 * int(kept.sum()) + ks_bytes
                  + nbytes(out[:5]))
    n_ops = word.numel() * SEED_OPS_PER_BASE * (
        args[0].shape[1] * 4 - word.shape[1] + 1)
    return {"bytes": payload + vf_bytes + ks_bytes + nbytes(out),
            "ks_bytes": ks_bytes, "ops": n_ops, "words_bytes": words_bytes,
            "keys_bytes": keys_bytes}


def launch_ms(torch, fn, names, reps=20, windows=3):
    """{name: device ms a call} of the kernels whose names hold each of
    `names`, from torch.profiler over `reps` calls of fn.

    The counted window follows a warm-up window of `reps` calls under the
    same profiler, because CUPTI can drop the first kernels it sees after
    tracing starts. A window counts only where the profiler recorded each
    kernel exactly `reps` times; a lossy window is printed and another is
    taken, up to `windows` of them, and the check fails if none is whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        rows = [r for r in prof.key_averages()
                if r.device_type == DeviceType.CUDA
                and not r.is_user_annotation]
        mine = {name: [r for r in rows if name in r.key] for name in names}
        counts = {name: [(r.key, r.count) for r in rs]
                  for name, rs in mine.items()}
        if all(sum(c for _, c in cs) == reps for cs in counts.values()):
            return {name: sum(r.self_device_time_total for r in rs)
                    / reps / 1e3 for name, rs in mine.items()}
        print(f"launch_ms: the profiler recorded {counts} in {reps} calls; "
              f"window dropped")
        seen.append(counts)
    check(False, f"the profiler saw {seen} launches of {list(names)} in "
                 f"{reps} calls, in each of {windows} windows")


def seed_phase(torch, card, fna, panel, parent_lib=None, parent_csrc=None):
    """Phase 3d: seed against seed_reference on the card, through the
    checked call and the lean call (SeedPlan), on the bench step's
    fragments and on synthetic payloads, back to back on one plan, on
    scratch full of 0xFF and through 20 replays of a CUDA graph; its
    times (the call and each launch), the plain version's, the bounds and
    the ptxas line; beside it the kernel of an earlier version of the
    sources (`parent_lib`, a library built from them in `parent_csrc`, or
    None), timed in turns with the shipped one."""
    import numpy as np

    from tntblast_tpu_torch import _kernels
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.ops import seed as S
    from tntblast_tpu_torch.ops.seed import SeedPlan, seed, seed_reference
    from tntblast_tpu_torch.tools.bench_inputs import (
        bench_options, bench_panel, seed_inputs)
    from tntblast_tpu_torch.tools.device_bench import bench_fragments
    from tntblast_tpu_torch.tools.screen_probe import (
        cuda_ms, graph_ms, host_ms)
    from tntblast_tpu_torch.tools.seed_steps import earlier_seed_plan

    names = ("slot", "p", "n_cand", "counts", "overflow", "word",
             "word_valid")

    def differ(got, want):
        return [n for n, g, w in zip(names, got, want)
                if not torch.equal(g, w)]

    def lean_of(args, kw):
        return SeedPlan.from_table(
            args[6].cpu().numpy(), args[0].device, L=kw["tile_len"],
            **{k: v for k, v in kw.items() if k != "tile_len"})

    def compare(args, kw, what, lean=None):
        got = seed(*args, **kw)
        lean_got = (lean or lean_of(args, kw))(*args[:6])
        torch.cuda.synchronize()
        want = seed_reference(*args, **kw)
        torch.cuda.synchronize()
        bad, bad_lean = differ(got, want), differ(lean_got, want)
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for out in (got, lean_got) for g, w in zip(out, want))
        print(f"seed vs plain, {what}: n={args[0].shape[0]} "
              f"L={kw['tile_len']} w={kw['word_len']} "
              f"num_os={kw['num_os']} max_words={kw['max_words']} "
              f"cap={kw['cap']} lanes {kw['s_max']}x{kw['k_max']}: checked "
              f"call {'equal on all seven outputs' if not bad else bad}, "
              f"lean call {'equal' if not bad_lean else bad_lean} "
              f"(max_abs_err={err}); n_cand {want[2].tolist()}, overflow "
              f"{want[4].int().tolist()}")
        check(not bad and not bad_lean and err == 0,
              f"seed kernel disagrees with its plain version ({what}): "
              f"checked {bad}, lean {bad_lean}")
        return want, err

    dp = bench_panel(fna, panel)
    cfg = dp.config
    plan = dp.tabs.get("seed_plan")
    check(plan is not None, "the bench panel has no seed plan: its seeding "
                            "is not on the word-table path")
    opt = bench_options(fna, panel, os.devnull)
    frags = bench_fragments(opt, open_database(fna), 8)
    payload = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                    for a in dp._pack_host(frags)[:6])
    args = (*payload, dp.tabs["w_tab"])
    kw = dict(word_len=cfg.word_len, num_os=cfg.num_os,
              max_words=cfg.max_words, tile_len=cfg.tile_len, cap=cfg.cap,
              s_max=dp.s_max, k_max=dp.k_max)
    out, max_err = compare(args, kw, "the bench step's 8 fragments", plan)
    n_cand = int(out[2].sum())
    rng = np.random.default_rng(20261017)
    for n, L, w, num_os, mw, cap, share, repeat in SEED_SHAPES:
        sargs, skw = seed_inputs(rng, "cuda", n=n, L=L, word_len=w,
                                 num_os=num_os, max_words=mw, cap=cap,
                                 share=share, repeat=repeat)
        max_err = max(max_err, compare(sargs, skw, "synthetic payload")[1])

    # back to back on one plan, no synchronisation between the calls
    outs = [plan(*payload) for _ in range(SEED_BACK_TO_BACK)]
    torch.cuda.synchronize()
    bad = [(i, differ(o, out)) for i, o in enumerate(outs) if differ(o, out)]
    check(not bad, f"seed, back-to-back calls on one plan differ: {bad}")
    # scratch and outputs full of 0xFF before the launch (the lean call's
    # own launch path, its scratch given here)
    lib = S._library()
    n = payload[0].shape[0]
    poisoned = S.empty_outputs(n, *plan.shape, plan.device)
    scratch = torch.empty(n * plan._scratch, dtype=torch.int32,
                          device=out[0].device)
    for t in (*poisoned, scratch):
        t.view(torch.uint8).fill_(0xFF)
    rc = lib.seed_launch_plan(
        *S.launch_args(plan._plan, payload, poisoned, scratch),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    check(rc == 0 and not differ(poisoned, out),
          f"seed on scratch of 0xFF: rc {rc}, differs in "
          f"{differ(poisoned, out)}")
    # a CUDA graph of the lean call, each replay on the scratch the last
    # one left (its tickets spent, its tiles' status words final) and on
    # outputs set to 0xFF before it
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = plan(*payload)
    for i in range(SEED_REPLAYS):
        for t in g_out:
            t.view(torch.uint8).fill_(0xFF)
        graph.replay()
        torch.cuda.synchronize()
        check(not differ(g_out, out),
              f"seed graph replay {i} differs in {differ(g_out, out)}")
    print(f"seed on the bench step: {SEED_BACK_TO_BACK} calls back to back "
          f"on one plan, a call on scratch and outputs of 0xFF, and "
          f"{SEED_REPLAYS} replays of a CUDA graph of the lean call (outputs "
          f"set to 0xFF before each) equal the plain version on all seven "
          f"outputs; on {card}")

    def run_kernel():
        plan(*payload)

    turns = None
    if parent_lib is not None:
        eplan, eper, elib = earlier_seed_plan(
            parent_lib, parent_csrc, plan._tables, L=cfg.tile_len,
            word_len=cfg.word_len, num_os=cfg.num_os,
            max_words=cfg.max_words, cap=cfg.cap, index=plan.index)

        def run_earlier():
            o = S.empty_outputs(n, *plan.shape, plan.device)
            sc = torch.empty(n * eper, dtype=torch.int32, device=plan.device)
            rc = elib.seed_launch_plan(
                *S.launch_args(eplan, payload, o, sc),
                torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"the earlier seed failed: {rc}")
            return o

        turns = _in_turns(torch, "seed", card, run_kernel, run_earlier, out,
                          names)
    k_ms = (statistics.median(turns["shipped"]) if turns is not None
            else graph_ms(run_kernel))
    per_launch = launch_ms(torch, run_kernel, SEED_LAUNCHES)
    q_ms = cuda_ms(run_kernel, 20)
    h_lean = host_ms(run_kernel)
    h_checked = host_ms(lambda: seed(*args, **kw), n=20)
    p1 = cuda_ms(lambda: seed_reference(*args, **kw), 3, batches=1)
    p2 = cuda_ms(lambda: seed_reference(*args, **kw), 3, batches=1)
    p_ms = statistics.median([p1, p2])
    ptxas = _kernels.ptxas_summary(_kernels.build_log["seed"], ".")
    print(f"seed ptxas: {ptxas}")
    print(f"seed kernel alone (CUDA graph of 20 calls, {len(SEED_LAUNCHES)} "
          f"launches each): {k_ms:.4f} ms for the bench step's 8 fragments "
          f"of {cfg.tile_len} ({n_cand} candidates); lean call queued "
          f"{q_ms:.4f} ms a call; host time a call: lean (SeedPlan) "
          f"{1e3 * h_lean:.1f} us, checked (builds the tables) "
          f"{1e3 * h_checked:.1f} us; plain PyTorch {p_ms:.4f} ms (runs "
          f"{p1:.4f}, {p2:.4f}); on {card}")
    work = seed_work(args, out, plan._tables)
    clock = sm_clock_hz(torch, run_kernel, k_ms)
    b_ms, b_by = bound_ms(work["bytes"], work["ops"], clock)
    print(f"seed bound: {b_ms:.4f} ms by {b_by} ({work['bytes']} bytes: "
          f"the payload, the VF table and {work['ks_bytes']} bytes of KS "
          f"rows of the in-position words, the words, their validity and "
          f"the keys; {work['ops']} int32 ops at {clock / 1e6:.0f} MHz take "
          f"{work['ops'] / (INT32_LANES * clock) * 1e3:.4f} ms); the kernel "
          f"alone is at {100 * b_ms / k_ms:.1f}% of it on {card}")
    row = {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "ms_queued": q_ms, "host_ms_lean": h_lean,
           "host_ms_checked": h_checked, "candidates": n_cand,
           "ptxas": ptxas}
    for name, key in zip(SEED_LAUNCHES, ("words", "keys")):
        lb_ms = work[f"{key}_bytes"] / HBM_BYTES_PER_S * 1e3
        print(f"seed launch {name}: {per_launch[name]:.4f} ms a call "
              f"(torch.profiler, 20 calls), bound {lb_ms:.4f} ms by bytes "
              f"({work[f'{key}_bytes']} bytes), "
              f"{100 * lb_ms / per_launch[name]:.1f}% of it; on {card}")
        row[f"ms_{key}"] = per_launch[name]
        row[f"bound_ms_{key}"] = lb_ms
    if turns is not None:
        row["ms_earlier"] = statistics.median(turns["earlier"])
    return row


def seed_dense_work(args, out, tables):
    """Bytes and int32 operations a seed_dense call needs, as a dict:
    `bytes` (the payload read once; the filter bits read once, and the hash
    row and entries of each distinct word at this call's valid positions
    that some oligo holds, once; the seven outputs written once),
    `table_bytes` of it, and `ops` (a word of w bases and its hash a
    position, an OR a matching entry)."""
    import torch

    hash_, _, filt, _ = tables
    word, valid = out[5], out[6]
    w = args[0].shape[1] * 4 - word.shape[1] + 1
    held = hash_[:, 0][hash_[:, 0] >= 0]
    hit = valid & torch.isin(word, held)
    rows = word[hit].unique()
    entries_of = {v: c for v, _, c, _ in hash_.tolist() if v >= 0}
    n_entries = sum(entries_of[v] for v in rows.tolist())
    table_bytes = (filt.numel() * filt.element_size()
                   + rows.numel() * hash_.shape[1] * 4 + 16 * n_entries)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    n_ops = word.numel() * (SEED_OPS_PER_BASE * w + 4) + int(hit.sum()) * 4
    return {"bytes": nbytes(args[:6]) + table_bytes + nbytes(out),
            "table_bytes": table_bytes, "ops": n_ops}


def probe_step(fna, work, config="long"):
    """(the panel of a long-probe configuration on the card, the first 8
    fragments of its search: one step's)."""
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.tools import probe_bench
    from tntblast_tpu_torch.tools.bench_inputs import (
        bench_options, bench_panel)
    from tntblast_tpu_torch.tools.device_bench import bench_fragments

    probes = probe_bench.build(fna, work, config)
    search = probe_bench.CONFIGS[config]["args"]
    dp = bench_panel(fna, probes, args=search)
    opt = bench_options(fna, probes, os.devnull, search)
    return dp, bench_fragments(opt, open_database(fna), 8)


def seed_dense_phase(torch, card, fna, work, parent_lib=None):
    """Phase 3h: seed_dense against seed_dense_reference on the card,
    through the checked call and the lean call (DenseSeedPlan), on the
    long-probe step's 8 fragments and on synthetic payloads (more diagonals
    than cap, more pairs than cap, slot 63, negative diagonals, 113- and
    300-word oligos, word length 3), back to back on one plan, on scratch
    full of 0xFF and through 20 replays of a CUDA graph; its times (the
    call and each launch), the plain version's, the bound and the ptxas
    line; and the kernel of an earlier version of the sources
    (`parent_lib`, a library built from them, or None) checked and timed
    in turns with it."""
    import numpy as np

    from tntblast_tpu_torch import _kernels
    from tntblast_tpu_torch.ops import seed as S
    from tntblast_tpu_torch.ops.seed import (
        DenseSeedPlan, seed_dense, seed_dense_reference)
    from tntblast_tpu_torch.tools.bench_inputs import seed_dense_inputs
    from tntblast_tpu_torch.tools.screen_probe import (
        cuda_ms, graph_ms, host_ms)

    names = ("slot", "p", "n_cand", "counts", "overflow", "word",
             "word_valid")

    def compare(args, kw, what, lean=None):
        got = seed_dense(*args, **kw)
        lean = lean or DenseSeedPlan(
            args[6], L=kw["tile_len"],
            **{k: v for k, v in kw.items() if k != "tile_len"})
        lean_got = lean(*args[:6])
        torch.cuda.synchronize()
        want = seed_dense_reference(*args, **kw)
        torch.cuda.synchronize()
        bad = _differ(torch, names, got, want)
        bad_lean = _differ(torch, names, lean_got, want)
        err = max(_max_err(got, want), _max_err(lean_got, want))
        print(f"seed_dense vs plain, {what}: n={args[0].shape[0]} "
              f"L={kw['tile_len']} w={kw['word_len']} "
              f"num_os={kw['num_os']} max_words={kw['max_words']} "
              f"cap={kw['cap']}: checked call "
              f"{'equal on all seven outputs' if not bad else bad}, lean "
              f"call {'equal' if not bad_lean else bad_lean} "
              f"(max_abs_err={err}); n_cand {want[2].tolist()}, overflow "
              f"{want[4].int().tolist()}")
        check(not bad and not bad_lean and err == 0,
              f"seed_dense kernel disagrees with its plain version "
              f"({what}): checked {bad}, lean {bad_lean}")
        return want, err

    dp, frags = probe_step(fna, work)
    payload = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                    for a in dp._pack_host(frags)[:6])
    cfg = dp.config
    check(dp.host_tables[1].shape[0] == 1, "the long-probe panel is not on "
                                           "the dense seeding path")
    plan = dp.tabs.get("seed_dense_plan")
    check(isinstance(plan, DenseSeedPlan) and "seed_plan" not in dp.tabs,
          "the long-probe panel has no dense seed plan")
    args = (*payload, dp.tabs["ow"])
    kw = dict(word_len=cfg.word_len, num_os=cfg.num_os,
              max_words=cfg.max_words, tile_len=cfg.tile_len, cap=cfg.cap)
    out, max_err = compare(args, kw, "the long-probe step's 8 fragments",
                           plan)
    check(not out[4].any(), "a long-probe fragment overflows")
    n_cand = int(out[2].sum())
    rng = np.random.default_rng(20261017)
    for shape, what in SEED_DENSE_SHAPES:
        sargs, skw = seed_dense_inputs(rng, "cuda", **shape)
        max_err = max(max_err, compare(sargs, skw, what)[1])

    outs = [plan(*payload) for _ in range(SEED_BACK_TO_BACK)]
    torch.cuda.synchronize()
    bad = [(i, _differ(torch, names, o, out)) for i, o in enumerate(outs)
           if _differ(torch, names, o, out)]
    check(not bad, f"seed_dense, back-to-back calls on one plan differ: "
                   f"{bad}")
    lib = S._dense_library()
    n = payload[0].shape[0]
    poisoned = S.empty_outputs(n, *plan.shape, plan.device)
    scratch = torch.empty(n * plan._scratch, dtype=torch.int32,
                          device=plan.device)
    for t in (*poisoned, scratch):
        t.view(torch.uint8).fill_(0xFF)
    rc = lib.seed_dense_launch_plan(
        *S.launch_args(plan._plan, payload, poisoned, scratch),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    check(rc == 0 and not _differ(torch, names, poisoned, out),
          f"seed_dense on scratch of 0xFF: rc {rc}, differs in "
          f"{_differ(torch, names, poisoned, out)}")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = plan(*payload)
    for i in range(SEED_REPLAYS):
        for t in g_out:
            t.view(torch.uint8).fill_(0xFF)
        graph.replay()
        torch.cuda.synchronize()
        check(not _differ(torch, names, g_out, out),
              f"seed_dense graph replay {i} differs in "
              f"{_differ(torch, names, g_out, out)}")
    print(f"seed_dense on the long-probe step: {SEED_BACK_TO_BACK} calls "
          f"back to back on one plan, a call on scratch and outputs of "
          f"0xFF, and {SEED_REPLAYS} replays of a CUDA graph of the lean "
          f"call (outputs set to 0xFF before each) equal the plain version "
          f"on all seven outputs; on {card}")
    del graph, g_out, outs

    def run_kernel():
        plan(*payload)

    k_ms = graph_ms(run_kernel)
    per_launch = launch_ms(torch, run_kernel, SEED_DENSE_LAUNCHES)
    q_ms = cuda_ms(run_kernel, 20)
    h_lean = host_ms(run_kernel)
    h_checked = host_ms(lambda: seed_dense(*args, **kw), n=20)
    p_ms = statistics.median(
        [cuda_ms(lambda: seed_dense_reference(*args, **kw), 2, batches=1)
         for _ in range(2)])
    ptxas = _kernels.ptxas_summary(_kernels.build_log["seed_dense"], ".")
    print(f"seed_dense ptxas: {ptxas}")
    print(f"seed_dense kernel alone (CUDA graph of 20 calls, "
          f"{len(SEED_DENSE_LAUNCHES)} launches each): {k_ms:.4f} ms for the "
          f"long-probe step's 8 fragments of {cfg.tile_len} ({n_cand} "
          f"candidates, {cfg.num_os} slots of {cfg.max_words} words); lean "
          f"call queued {q_ms:.4f} ms a call; host time a call: lean "
          f"(DenseSeedPlan) {1e3 * h_lean:.1f} us, checked (builds the "
          f"tables) {1e3 * h_checked:.1f} us; plain PyTorch {p_ms:.4f} ms; "
          f"on {card}")
    for name in SEED_DENSE_LAUNCHES:
        print(f"seed_dense launch {name}: {per_launch[name]:.4f} ms a call "
              f"(torch.profiler, 20 calls); on {card}")
    turns = None
    if parent_lib is not None:
        from tntblast_tpu_torch.tools.seed_dense_steps import runner

        turns = _in_turns(torch, "seed_dense", card, run_kernel,
                          runner(parent_lib, plan, payload, cfg), out, names)
    w = seed_dense_work(args, out, plan._tables)
    clock = sm_clock_hz(torch, run_kernel, k_ms)
    b_ms, b_by = bound_ms(w["bytes"], w["ops"], clock)
    print(f"seed_dense bound: {b_ms:.4f} ms by {b_by} ({w['bytes']} bytes: "
          f"the payload, {w['table_bytes']} bytes of filter bits, hash rows "
          f"and entries of the held words at valid positions, the words, "
          f"their validity and the pairs; {w['ops']} int32 ops at "
          f"{clock / 1e6:.0f} MHz take "
          f"{w['ops'] / (INT32_LANES * clock) * 1e3:.4f} ms); the kernel "
          f"alone is at {100 * b_ms / k_ms:.1f}% of it on {card}")
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_queued": q_ms, "host_ms_lean": h_lean,
            "host_ms_checked": h_checked, "candidates": n_cand,
            "ptxas": ptxas, "ms_head": per_launch[SEED_DENSE_LAUNCHES[0]],
            "ms_tiles": per_launch[SEED_DENSE_LAUNCHES[1]],
            "ms_scan": per_launch[SEED_DENSE_LAUNCHES[2]],
            "ms_emit": per_launch[SEED_DENSE_LAUNCHES[3]],
            **({"ms_turns": turns,
                "ms_earlier": statistics.median(turns["earlier"])}
               if turns else {})}


def earlier_screen_dp(torch, path, dp):
    """A function that runs an earlier build of csrc/screen_dp.cu (its C
    entry without the strip path's scratch; width 0 keeps the rows in
    shared memory) on a chunk (ptb, slot, ql, wt_e) of panel `dp`'s
    stream, as the lean call takes it, and returns (best, mgmax, M_rows)."""
    import ctypes

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(path).screen_dp_launch
    fn.argtypes = [P] * 9 + [I] * 8 + [P]
    fn.restype = I
    st, cfg = dp.tabs["slots"], dp.config
    tab, qp = dp.tabs["tc_kernel"], st["qp"]
    nc_all = tab.shape[0]

    def run(ptb, slot, ql, wt_e):
        B, wt = ptb.shape
        dev = ptb.device
        best = torch.empty((nc_all, B), dtype=torch.int32, device=dev)
        mgmax = torch.empty((B,), dtype=torch.int32, device=dev)
        M_rows = torch.empty((cfg.wq_max, B, wt + 1), dtype=torch.int32,
                             device=dev)
        rc = fn(ptb.data_ptr(), slot.data_ptr(), ql.data_ptr(),
                wt_e.data_ptr(), qp.data_ptr(), tab.data_ptr(),
                best.data_ptr(), mgmax.data_ptr(), M_rows.data_ptr(), B, wt,
                cfg.wq_max, nc_all, dp.n_real, 1, 0, dev.index,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the earlier screen_dp failed: {rc}")
        return best, mgmax, M_rows

    return run


def long_probe_mesh(torch, card, what, argv, made, n_items, mb):
    """Phase 4b's mesh run: the long-probe argv with --mesh T through
    local_main on every visible card (a one-card mesh: one fragment a
    step), its launches as its steps ask (seed_dense once a step),
    every panel a MeshPanel on the dense path, no fallback.  Returns its
    line of results."""
    from tntblast_tpu_torch import cli
    from tntblast_tpu_torch.parallel.mesh import MeshPanel

    with StepLaunches() as counted:
        t0 = time.perf_counter()
        rc = cli.local_main(argv + ["--mesh", "T", "-v", "F"],
                            stdout=io.StringIO(), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"{what}, mesh path: local_main returned {rc}")
    launched = counted.read(f"the {what} mesh path", table=False)
    mgr = made[-1]
    panels = [dp for g in mgr.groups for dp in g._panels.values()]
    check(panels and all(isinstance(dp, MeshPanel)
                         and dp.host_tables[1].shape[0] == 1
                         and "seed_dense_plan" in dp.tabs for dp in panels)
          and mgr.batch == len(mgr.mesh)
          and launched["seed_dense"] == mgr.stats["steps"] * len(mgr.mesh),
          f"{what}, mesh path: not MeshPanels on the dense path, seeded "
          f"once a step: {launched}, {mgr.stats}")
    check(mgr.stats["fallback"] == 0 and mgr.stats["fragments"] == n_items,
          f"{what}, mesh path: {mgr.stats}, {n_items} work items")
    return (f"{len(mgr.mesh)} card(s), batch {mgr.batch}, 0 fallbacks, "
            f"every panel a MeshPanel on the dense path, stats {mgr.stats}, "
            f"launches {launched} (seed_dense once a step); wall "
            f"{wall:.3f} s ({mb / wall:.3f} Mb/s) on {card}")


def long_probe_ranks(card, what, fna, probes, work, db, h_sha):
    """Phase 4b's two ranks: the long-probe argv with --tpu-screen T on
    two ranks of parallel/multiproc.py on the card; rank 0's output must
    equal the host path's, and each rank's fragments, steps and launches
    must be its share's (seed_dense once a step, screen_dp and eval_pack
    once a chunk), with no fallback and no module of the JAX side."""
    from tntblast_tpu_torch.tools import probe_bench, scaled_bench

    out = os.path.join(work, "probe_long_ranks.txt")
    if os.path.exists(out):
        os.unlink(out)
    argv = probe_bench.probe_argv(fna, probes, out)
    plans = scaled_bench.step_plan(argv, db, "ranks")
    wall, lines = run_ranks(argv + ["--tpu-screen", "T", "-v", "F"], HERE)
    counts = [rank_launches(line, plan) for line, plan in zip(lines, plans)]
    check(all(c["seed_dense"] > 0 and c["seed"] == 0 for c in counts),
          f"{what} on two ranks: not the dense path: {counts}")
    r_sha = sha256(out)
    check(r_sha == h_sha, f"{what} on two ranks: sha256 {r_sha} != host "
                          f"path {h_sha}")
    for line in lines:
        print(line)
    shares = [{k: p[k] for k in ("fragments", "steps", "seed_dense",
                                 "screen_dp")} for p in plans]
    print(f"{what} on two ranks of one card: rank 0's sha256 {r_sha} equals "
          f"the host path's, each rank's launches its share's ({shares}), "
          f"0 fallbacks; wall {wall:.3f} s incl. both processes' start-up, "
          f"on {card}")


def long_probe_phase(torch, card, fna, work, parent_lib=None,
                     config="long"):
    """Phase 4b (config long) and 4c (config wide): a long-probe search
    (tools/probe_bench.py: long, 32 probes of 60 nt, -A PROBE -E 40; wide,
    16 probes of 150 nt, -W 8; over the bench genome, the dense seeding
    path) through the port's local_main with --tpu-screen T on the card,
    twice (the second run with a fresh panel manager replays the first's
    graphs), and through the host path; the device path's output sha256
    must equal the host path's, with hits, no fallback, every panel on the
    dense path and each step kernel launched as often as its steps ask
    (seed_dense once a step, screen_dp and eval_pack once a chunk); then
    the step's first chunk of its real pooled stream through one screen_dp
    and one eval_pack launch (the strip path, and the evaluator's pieces
    at the wide widths) against their plain versions, their times alone
    and bounds, and, given an earlier build of screen_dp.cu
    (`parent_lib`), that kernel on the same chunk checked and timed in
    turns with the shipped one; then tools/device_bench --probes (graphed
    and eager batch_ms, chunks, stage extents).  Returns (the first run's
    launches, the chunk's screen_dp and eval_pack rows, device_bench's
    result)."""
    import tntblast_tpu_torch.parallel.panel as port_panel
    from tntblast_tpu_torch import _kernels, cli
    from tntblast_tpu_torch.engine import _fragment_work_items
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.ops.eval_pack import eval_pack_reference
    from tntblast_tpu_torch.ops.screen_dp import screen_dp_reference
    from tntblast_tpu_torch.parallel.device_search import chunk_entries
    from tntblast_tpu_torch.tools import device_bench, probe_bench
    from tntblast_tpu_torch.tools.bench_inputs import (
        bench_options, dp_errors, step_decode_inputs)
    from tntblast_tpu_torch.tools.screen_probe import graph_ms

    conf = probe_bench.CONFIGS[config]
    search = conf["args"]
    what = f"{config} probes"
    probes = probe_bench.build(fna, work, config)
    dev_out = os.path.join(work, f"probe_{config}_device.txt")
    host_out = os.path.join(work, f"probe_{config}_host.txt")
    argv = probe_bench.probe_argv(fna, probes, dev_out, config) + [
        "--tpu-screen", "T", "-v", "F"]
    host_argv = probe_bench.probe_argv(fna, probes, host_out, config) + [
        "-v", "F"]
    opt = bench_options(fna, probes, dev_out, search)
    db = open_database(fna)
    items, _ = _fragment_work_items(opt, db)
    mb = sum(db.approx_seq_len(i) for i in range(db.size())) / 1e6
    made = []
    plain_mgr = port_panel.FragmentPanelManager

    class Recorded(plain_mgr):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    walls = []
    port_panel.FragmentPanelManager = Recorded
    try:
        for rep in range(2):
            counted = StepLaunches() if rep == 0 else CoreCalls()
            with counted:
                t0 = time.perf_counter()
                rc = cli.local_main(argv, stdout=io.StringIO(),
                                    device="cuda")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            check(rc == 0, f"{what}: local_main returned {rc}")
            if rep == 0:
                launched = counted.read(f"the {what} path", table=False)
            else:
                check(counted.calls == counted.captures == 0,
                      f"{what} run {rep}: {counted.calls} calls of "
                      f"panel_step_core, {counted.captures} captures")
            mgr = made[-1]
            dense = [dp.host_tables[1].shape for g in mgr.groups
                     for dp in g._panels.values()]
            check(dense and all(shape[0] == 1 for shape in dense)
                  and all("seed_dense_plan" in dp.tabs for g in mgr.groups
                          for dp in g._panels.values()),
                  f"{what}: not every panel on the dense path: {dense}")
            check(mgr.stats["fallback"] == 0
                  and mgr.stats["fragments"] == len(items),
                  f"{what}: {mgr.stats}, {len(items)} work items")
            print(f"{what}, device path run {rep}: wall "
                  f"{walls[-1]:.3f} s ({mb / walls[-1]:.3f} Mb/s) "
                  f"stats={mgr.stats} on {card}")
        t0 = time.perf_counter()
        rc = cli.local_main(host_argv, stdout=io.StringIO(), device="cuda")
        host_wall = time.perf_counter() - t0
        check(rc == 0, f"{what}, host path: local_main returned {rc}")
        if config == "long":
            mesh_out = os.path.join(work, f"probe_{config}_mesh.txt")
            mesh = long_probe_mesh(torch, card, what, probe_bench.probe_argv(
                fna, probes, mesh_out, config), made, len(items), mb)
    finally:
        port_panel.FragmentPanelManager = plain_mgr
    d_sha, h_sha = sha256(dev_out), sha256(host_out)
    with open(host_out) as fh:
        hits = fh.read().count("probe tm = ")
    check(d_sha == h_sha, f"{what}: device path sha256 {d_sha} != host "
                          f"path {h_sha}")
    if config == "long":
        m_sha = sha256(mesh_out)
        check(m_sha == h_sha, f"{what}: mesh path sha256 {m_sha} != host "
                              f"path {h_sha}")
        print(f"{what} on the mesh path: sha256 {m_sha} equals the host "
              f"path's; {mesh}")
        long_probe_ranks(card, what, fna, probes, work, db, h_sha)
    check(hits >= conf["nplant"],
          f"{what}: {hits} hits, {conf['nplant']} planted probes")
    print(f"{what} ({conf['nprobe']} probes of {conf['length']} nt, "
          f"{' '.join(search)}, {mb:.1f} Mb, {len(items)} fragments, the "
          f"whole genome on both paths): device path sha256 {d_sha} equals "
          f"the host path's, {hits} hits, 0 fallbacks, every panel on the "
          f"dense seeding path; launches {launched}; walls: device "
          f"{walls[0]:.3f} s (first, captures), {walls[1]:.3f} s (replays), "
          f"host {host_wall:.3f} s; on {card}")

    # the first chunk of the step's real stream through one screen_dp and
    # one eval_pack launch
    dp, frags = probe_step(fna, work, config)
    dargs = step_decode_inputs(dp, frags)[0]
    stream = dp.tabs["decode_plan"](*dargs[:6])
    cfg = dp.config
    CH = chunk_entries(len(frags) * cfg.cap, cfg.wq_max, cfg.wt)
    nh, tb5, ptb, ql, wt_e, ent_valid = (t[:CH] for t in stream)
    st = dp.tabs["slots"]
    sargs = (ptb, dargs[0][:CH], ql, wt_e, st["qp"], dp.tabs["tc_all"])
    screen, evaluator = dp.tabs["screen_plan"], dp.tabs["eval_plan"]
    got = screen(*sargs[:4])
    torch.cuda.synchronize()
    want = screen_dp_reference(*sargs, eval_on=dp.eval_on)
    err = dp_errors(got, want, sargs, dp.eval_on)
    check(max(err) == 0, f"screen_dp on the {what} chunk: {err}")
    turns = None
    if parent_lib is not None:
        earlier = earlier_screen_dp(torch, parent_lib, dp)
        e_err = dp_errors(earlier(*sargs[:4]), want, sargs, dp.eval_on)
        check(max(e_err) == 0, f"the earlier screen_dp on the {what} "
                               f"chunk: {e_err}")
        runs = {"earlier": lambda: earlier(*sargs[:4]),
                "shipped": lambda: screen(*sargs[:4])}
        turns = {"earlier": [], "shipped": []}
        for which in ("earlier", "shipped", "shipped", "earlier"):
            turns[which].append(graph_ms(runs[which]))
        print(f"screen_dp in turns on the {what} chunk at wt_max {cfg.wt} "
              f"(earlier: rows in shared memory; shipped: the strip path; "
              f"earlier, shipped, shipped, earlier; ms alone, CUDA graph of "
              f"20 launches): earlier {turns['earlier']}, shipped "
              f"{turns['shipped']}; on {card}")
    del want
    eargs = (got[2], got[1], tb5, sargs[1], ql, wt_e, nh, ent_valid,
             st["qc"], dp.tabs["ev_tabs"], dp.tabs["ev_loop"])
    words = evaluator(*eargs[:8])
    torch.cuda.synchronize()
    n_bad = int((words != eval_pack_reference(*eargs, dp.eval_const))
                .any(dim=1).sum())
    check(n_bad == 0, f"eval_pack on the {what} chunk: {n_bad} entries "
                      f"differ")
    s_ms = graph_ms(lambda: screen(*sargs[:4]))
    e_ms = graph_ms(lambda: evaluator(*eargs[:8]))
    s_bytes, s_ops, cells = screen_dp_work(sargs, dp.n_real, dp.eval_on)
    clock = sm_clock_hz(torch, lambda: screen(*sargs[:4]), s_ms)
    sb_ms, sb_by = bound_ms(s_bytes, s_ops, clock)
    e_bytes, e_cells = eval_pack_work(eargs)
    eb_ms, eb_by = bound_ms(e_bytes, e_cells * EVAL_OPS_PER_CELL, clock)
    n_valid = int(((sargs[1] >= 0) & (sargs[1] < dp.n_real)).sum())
    strip = _kernels.ptxas_summary(_kernels.build_log["screen_dp"], "strip")
    print(f"screen_dp at wt_max {cfg.wt} (the strip path: {strip}): the "
          f"{what} step's first chunk of {CH} entries ({n_valid} valid, "
          f"{cells} cells) == plain (best, mgmax, M rows {err}), kernel "
          f"alone {s_ms:.4f} ms, bound {sb_ms:.4f} ms by {sb_by} "
          f"({100 * sb_ms / s_ms:.1f}%); eval_pack on it == plain on all "
          f"five words, kernel alone {e_ms:.4f} ms, bound {eb_ms:.4f} ms by "
          f"{eb_by} ({100 * eb_ms / e_ms:.1f}%); on {card}")
    del stream, sargs, dargs, got, eargs

    res = device_bench.run(fna, probes, "cuda", reps=3, args=search)
    per_step = {name: res[f"{name}_launches_per_step"]
                for name in launched}
    check(res["seeding"] == "dense" and res["batch_ms"] > 0
          and per_step == {"seed": 0, "seed_dense": 1, "pool": 1,
                           "win_decode": 1, "screen_dp": res["chunks"],
                           "eval_pack": res["chunks"], "kept": 1},
          f"device_bench --probes {config}: {res}")
    print(f"device_bench --probes {config} on {card}: {json.dumps(res)}")
    key = "probe" if config == "long" else config
    dp_row = {f"ms_{key}_chunk": s_ms, f"bound_ms_{key}_chunk": sb_ms,
              f"{key}_chunk_entries": CH}
    if turns is not None:
        dp_row[f"ms_{key}_chunk_turns"] = turns
        dp_row[f"ms_{key}_chunk_earlier"] = statistics.median(
            turns["earlier"])
    eval_row = {f"ms_{key}_chunk": e_ms, f"bound_ms_{key}_chunk": eb_ms}
    return launched, dp_row, eval_row, res


def scaled_phase(torch, card, work):
    """Phase 4d: BASELINE config 5 (tools/scaled_bench.py) at a reduced
    depth, the first of its eight 128 Mb sequences, at full width (the
    tool's assays, planting and record shapes): for PCR and PADLOCK the
    device path (--tpu-screen T) and the host path through local_main,
    sha256-equal, with at least the planted sites as hits, no fallback,
    and the fragments, steps and launches the database and the panel ask
    for (scaled_bench.step_plan); then PCR's device path again with a
    fresh panel manager (graph replays: no capture, no panel_step_core),
    PCR on the mesh path, and PADLOCK on two ranks of one card
    (--tpu-screen T --device cuda:0), rank 0's output equal to the host
    path's and each rank's launches its share's.  Returns the launches of
    PCR's first device run."""
    import tntblast_tpu_torch.parallel.panel as port_panel
    from tntblast_tpu_torch import cli
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.parallel.mesh import MeshPanel
    from tntblast_tpu_torch.tools import launches, scaled_bench as sb

    t_phase = time.perf_counter()
    files = sb.build(work, nseq=1)
    fna = files[0]
    db = open_database(fna)
    mb = sb.SEQLEN / 1e6
    made = []
    plain_mgr = port_panel.FragmentPanelManager

    class Recorded(plain_mgr):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    def argv(fmt, out):
        return sb.family_argv(fmt, files[1] if fmt == "PCR" else files[2],
                              fna, out)

    def search(fmt, mode, counted):
        out = os.path.join(work, f"scaled_n1_{fmt}_{mode}.out")
        flag = {"host": [], "screen": ["--tpu-screen", "T"],
                "mesh": ["--mesh", "T"]}[mode]
        del made[:]
        with counted:
            t0 = time.perf_counter()
            rc = cli.local_main(argv(fmt, out) + ["-v", "F"] + flag,
                                stdout=io.StringIO(), device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check(rc == 0, f"scaled {fmt} {mode}: local_main returned {rc}")
        return sha256(out), sb.hits(out), wall, (made[0] if made else None)

    def held(fmt, mode, mgr, counted, plan):
        got = counted.read(f"scaled {fmt} {mode}", table=plan["seed"] > 0)
        seen = dict(got, fragments=mgr.stats["fragments"],
                    steps=mgr.stats["steps"])
        check(seen == plan and mgr.stats["fallback"] == 0,
              f"scaled {fmt} {mode}: {seen}, stats {mgr.stats}; the "
              f"database and panel ask for {plan}")
        return got

    first = None
    port_panel.FragmentPanelManager = Recorded
    try:
        for fmt in sb.FAMILIES:
            (plan,) = sb.step_plan(argv(fmt, os.devnull), db, "screen")
            counted = StepLaunches()
            d_sha, d_hits, d_wall, mgr = search(fmt, "screen", counted)
            got = held(fmt, "screen", mgr, counted, plan)
            first = first or got
            h_sha, h_hits, h_wall, _ = search(fmt, "host",
                                              contextlib.nullcontext())
            check(d_sha == h_sha and d_hits == h_hits
                  and h_hits >= sb.planted(fmt, 1),
                  f"scaled {fmt}: device sha256 {d_sha} ({d_hits} hits), "
                  f"host {h_sha} ({h_hits} hits), "
                  f"{sb.planted(fmt, 1)} sites planted")
            print(f"scaled {fmt} (reduced: 1 of 8 sequences, {mb:.0f} Mb): "
                  f"device path sha256 {d_sha} equals the host path's, "
                  f"{h_hits} hits ({sb.planted(fmt, 1)} sites planted), 0 "
                  f"fallbacks, fragments/steps/launches as planned {plan}; "
                  f"walls device {d_wall:.3f} s ({mb / d_wall:.3f} Mb/s, "
                  f"the first search of its key: captures), host "
                  f"{h_wall:.3f} s ({mb / h_wall:.3f} Mb/s); on {card}")
            if fmt == "PCR":
                counted = CoreCalls()
                r_sha, _, r_wall, mgr = search(fmt, "screen", counted)
                check(counted.calls == counted.captures == 0
                      and r_sha == h_sha and mgr.stats["fallback"] == 0,
                      f"scaled PCR replay: {counted.calls} calls of "
                      f"panel_step_core, {counted.captures} captures, "
                      f"sha256 {r_sha}, {mgr.stats}")
                (m_plan,) = sb.step_plan(argv(fmt, os.devnull), db, "mesh")
                counted = StepLaunches()
                m_sha, _, m_wall, mgr = search(fmt, "mesh", counted)
                m_got = held(fmt, "mesh", mgr, counted, m_plan)
                check(m_sha == h_sha and all(
                    isinstance(dp, MeshPanel) for g in mgr.groups
                    for dp in g._panels.values()),
                      f"scaled PCR mesh: sha256 {m_sha}, not MeshPanels")
                print(f"scaled PCR, device path again with a fresh panel "
                      f"manager: graph replays only (no capture, no "
                      f"panel_step_core), sha256 equal, wall {r_wall:.3f} s "
                      f"({mb / r_wall:.3f} Mb/s); mesh path ({len(mgr.mesh)} "
                      f"card(s), batch {mgr.batch}): sha256 equal, 0 "
                      f"fallbacks, launches {m_got} as planned, wall "
                      f"{m_wall:.3f} s ({mb / m_wall:.3f} Mb/s); on {card}")
            else:
                out = os.path.join(work, f"scaled_n1_{fmt}_ranks.out")
                if os.path.exists(out):
                    os.unlink(out)
                plans = sb.step_plan(argv(fmt, out), db, "ranks")
                wall, ranks = launches.run_ranks(
                    argv(fmt, out) + ["--tpu-screen", "T", "-v", "F"], HERE,
                    device="cuda:0", env={"TNTBLAST_TPU_THREADS": "1"})
                lines = []
                for rank, (rc, log) in enumerate(ranks):
                    line = launches.profile_line(log, rank)
                    check(rc == 0 and line is not None,
                          f"scaled {fmt} rank {rank}: exit {rc}\n"
                          f"{log[-3000:]}")
                    lines.append(line)
                    print(line)
                for line, rank_plan in zip(lines, plans):
                    rank_launches(line, rank_plan)
                k_sha = sha256(out)
                check(k_sha == h_sha, f"scaled {fmt} on two ranks: sha256 "
                                      f"{k_sha} != host path {h_sha}")
                print(f"scaled {fmt} on two ranks of one card (--tpu-screen "
                      f"T --device cuda:0): rank 0's sha256 equals the host "
                      f"path's, each rank's fragments, steps and launches "
                      f"its share's {plans}, 0 fallbacks, no module of the "
                      f"JAX side; wall {wall:.3f} s ({mb / wall:.3f} Mb/s) "
                      f"incl. both processes' start-up; on {card}")
    finally:
        port_panel.FragmentPanelManager = plain_mgr
    print(f"scaled phase (reduced: 1 of 8 sequences): "
          f"{time.perf_counter() - t_phase:.1f} s added to the smoke, "
          f"data built or found included; on {card}")
    return first


def _differ(torch, names, got, want):
    return [n for n, g, w in zip(names, got, want) if not torch.equal(g, w)]


def _max_err(got, want):
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def _replays(torch, fn, want, names, what):
    """A CUDA graph of fn() replayed STAGE_REPLAYS times, its outputs set
    to 0xFF before each replay: every replay must equal `want`."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for i in range(STAGE_REPLAYS):
        for t in out:
            t.view(torch.uint8).fill_(0xFF)
        graph.replay()
        torch.cuda.synchronize()
        bad = _differ(torch, names, out, want)
        check(not bad, f"{what}: graph replay {i} differs in {bad}")


def _stage_times(torch, run_kernel, run_checked, run_plain, names):
    """(kernel alone from a CUDA graph of 20 calls, each launch's time by
    torch.profiler, host ms a call of the lean and the checked call, the
    plain version's ms)."""
    from tntblast_tpu_torch.tools.screen_probe import (
        cuda_ms, graph_ms, host_ms)

    k_ms = graph_ms(run_kernel)
    per_launch = launch_ms(torch, run_kernel, names)
    h_lean = host_ms(run_kernel)
    h_checked = host_ms(run_checked, n=100)
    p_ms = statistics.median(
        [cuda_ms(run_plain, 3, batches=1) for _ in range(2)])
    return k_ms, per_launch, h_lean, h_checked, p_ms


def _in_turns(torch, name, card, run_kernel, run_earlier, want, names):
    """The earlier kernel's outputs against `want`, then its time and the
    shipped kernel's alone (CUDA graph of 20 calls), in turns: earlier,
    shipped, shipped, earlier.  Returns {"earlier": [ms, ms], "shipped":
    [ms, ms]}."""
    from tntblast_tpu_torch.tools.screen_probe import graph_ms

    got = run_earlier()
    torch.cuda.synchronize()
    bad = _differ(torch, names, got, want)
    check(not bad, f"the earlier {name} differs from the plain version: {bad}")
    runs = {"earlier": run_earlier, "shipped": run_kernel}
    turns = {"earlier": [], "shipped": []}
    for which in ("earlier", "shipped", "shipped", "earlier"):
        turns[which].append(graph_ms(runs[which]))
    print(f"{name} in turns (earlier, shipped, shipped, earlier; ms alone, "
          f"CUDA graph of 20 calls): earlier {turns['earlier']}, shipped "
          f"{turns['shipped']}; on {card}")
    return turns


def pool_phase(torch, card, fna, panel, parent_lib=None):
    """Phase 3f: pool against pool_reference on the card, through the
    checked call and the panel's lean call (PoolPlan): the bench step's
    real seed outputs (8 bench fragments) and POOL_CASES; 25 replays of a
    CUDA graph of the lean call; its time alone and each launch's, each
    wrapper's host time, the plain version's time and the byte bound, a
    stable torch.sort of the step's keys as a yardstick; beside it the
    kernel of an earlier version of the sources (`parent_lib`, a library
    built from them, or None), timed in turns with the shipped one."""
    import numpy as np

    from tntblast_tpu_torch import _kernels
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.ops.pool import PoolPlan, pool, pool_reference
    from tntblast_tpu_torch.tools.bench_inputs import (
        bench_options, bench_panel, pool_inputs, step_plan_inputs)
    from tntblast_tpu_torch.tools.compact_steps import pool_runner
    from tntblast_tpu_torch.tools.device_bench import bench_fragments
    from tntblast_tpu_torch.tools.screen_probe import cuda_ms

    names = ("slot_str", "p_str", "frag_str", "order_str", "valid")

    def compare(args, num_os, what, lean=None):
        got = pool(*args, num_os=num_os)
        lean_got = (lean or PoolPlan(args[0].device, num_os=num_os,
                                     cap=args[0].shape[1]))(*args)
        torch.cuda.synchronize()
        want = pool_reference(*args, num_os=num_os)
        torch.cuda.synchronize()
        bad = _differ(torch, names, got, want)
        bad_lean = _differ(torch, names, lean_got, want)
        err = max(_max_err(got, want), _max_err(lean_got, want))
        print(f"pool vs plain, {what}: n={args[0].shape[0]} "
              f"cap={args[0].shape[1]} num_os={num_os}: checked call "
              f"{'equal on all five outputs' if not bad else bad}, lean "
              f"call {'equal' if not bad_lean else bad_lean} "
              f"(max_abs_err={err}); {int(want[4].sum())} pooled, n_cand "
              f"{args[2].tolist()}")
        check(not bad and not bad_lean and err == 0,
              f"pool kernel disagrees with its plain version ({what}): "
              f"checked {bad}, lean {bad_lean}")
        return want, err

    dp = bench_panel(fna, panel)
    cfg = dp.config
    plan = dp.tabs["pool_plan"]
    opt = bench_options(fna, panel, os.devnull)
    frags = bench_fragments(opt, open_database(fna), 8)
    args = step_plan_inputs(dp, frags, "pool_plan")[0]
    out, max_err = compare(args, cfg.num_os, "the bench step's 8 fragments",
                           plan)
    rng = np.random.default_rng(20261019)
    for num_os, cap, n_cand, one_slot in POOL_CASES:
        sargs = [torch.from_numpy(a).cuda() for a in pool_inputs(
            rng, len(n_cand), cap, num_os, n_cand, one_slot=one_slot)]
        max_err = max(max_err, compare(sargs, num_os, "synthetic")[1])
    _replays(torch, lambda: plan(*args), out, names, "pool")
    print(f"pool on the bench step: {STAGE_REPLAYS} replays of a CUDA graph "
          f"of the lean call (outputs set to 0xFF before each) equal the "
          f"plain version on all five outputs; on {card}")

    def run_kernel():
        return plan(*args)

    k_ms, per_launch, h_lean, h_checked, p_ms = _stage_times(
        torch, run_kernel, lambda: pool(*args, num_os=cfg.num_os),
        lambda: pool_reference(*args, num_os=cfg.num_os), POOL_LAUNCHES)
    ptxas = _kernels.ptxas_summary(_kernels.build_log["pool"], ".")
    Bp = args[0].numel()
    # the yardstick: one stable sort of the step's keys (a primitive
    # inside the function; the port never calls it on a card)
    rank = torch.arange(cfg.cap, device=args[0].device)[None, :]
    keys = torch.where(rank < args[2].clamp(0, cfg.cap)[:, None], args[0],
                       cfg.num_os).reshape(-1)
    sort_ms = cuda_ms(lambda: torch.sort(keys, stable=True), 20)
    print(f"pool yardstick: one stable torch.sort of the bench step's {Bp} "
          f"keys {sort_ms:.4f} ms (CUDA events, 20 queued); on {card}")
    turns = None
    if parent_lib is not None:
        earlier = pool_runner(parent_lib, args, num_os=cfg.num_os,
                              cap=cfg.cap, index=plan.index)
        turns = _in_turns(torch, "pool", card, run_kernel, earlier, out,
                          names)
    n_pool = int(out[4].sum())
    # the slot of a pooled entry (an entry past the pool is keyed num_os
    # whatever its slot), every p, n_cand; four int32 streams and valid
    # written
    n_bytes = 4 * n_pool + 4 * Bp + 4 * args[2].numel() + 17 * Bp
    n_ops = Bp * POOL_OPS_PER_ENTRY
    clock = sm_clock_hz(torch, run_kernel, k_ms)
    b_ms, b_by = bound_ms(n_bytes, n_ops, clock)
    print(f"pool ptxas: {ptxas}")
    print(f"pool kernel alone (CUDA graph of 20 calls, "
          f"{len(POOL_LAUNCHES)} launches each): {k_ms:.4f} ms for the bench "
          f"step's {Bp} entries ({n_pool} pooled); each launch (profiler, "
          f"20 calls): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in per_launch.items())
          + f"; host time a call: lean (PoolPlan) {1e3 * h_lean:.1f} us, "
          f"checked {1e3 * h_checked:.1f} us; plain PyTorch (stable sort "
          f"and gathers) {p_ms:.4f} ms; on {card}")
    print(f"pool bound: {b_ms:.4f} ms by {b_by} ({n_bytes} bytes: the pooled "
          f"entries' slots and every p read once, four streams and valid "
          f"written once; {n_ops} int32 "
          f"ops at {clock / 1e6:.0f} MHz); the kernel alone is at "
          f"{100 * b_ms / k_ms:.1f}% of it on {card}")
    row = {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "host_ms_lean": h_lean, "host_ms_checked": h_checked,
           "entries": Bp, "pooled": n_pool, "ptxas": ptxas,
           "sort_yardstick_ms": sort_ms,
           **{f"ms_{k}": v for k, v in per_launch.items()}}
    if turns is not None:
        row["turns"] = turns
    return row


def kept_work(args, want, thr, num_cond, num_os, max_words, eval_on):
    """Bytes and int32 operations the kept call needs on its arguments
    (the lean call's) and outputs: a pooled entry's validity byte (no entry
    past the pooled prefix, sum of clamp(n_cand, 0, cap), can be valid, and
    n_cand says where it ends); a valid entry's needs_host byte and, unless
    the host takes it, its slot and its num_cond scores; overflow,
    input_over, n_cand and counts; a kept
    entry below bkcap: its order, p and fragment, its slot where the flags
    did not read it (the host takes the entry), its evaluator words and
    the words (int32 and validity byte) kmin reads up to its first match
    (kmin + 1, at most max_words); the header and the whole kept block
    written once."""
    from tntblast_tpu_torch.ops.kept import keep_flags

    best, slot, needs_host, valid, rest = (args[0], args[1], args[5],
                                           args[6], args[10:])
    header, block = want
    n_valid = int(valid.sum())
    scored = int((valid & ~needs_host).sum())
    m = min(int(header[0]), block.shape[1])
    first = keep_flags(best, slot, needs_host, valid, thr, num_cond=num_cond,
                       num_os=num_os).nonzero()[:m, 0]
    unscored = int(needs_host[first].sum())
    kmin = block[3, :m].long()
    words = int((kmin + 1).clamp(max=max_words).sum())
    cap = valid.numel() // rest[2].numel()
    n_pool = int(rest[2].clamp(0, cap).sum())
    n_bytes = (n_pool + n_valid + scored * 4 * (1 + num_cond)
               + m * (12 + (20 if eval_on else 0)) + 4 * unscored
               + 5 * words
               + sum(t.numel() * t.element_size() for t in rest)
               + 4 * header.numel() + 4 * block.numel())
    return n_bytes, n_pool * KEPT_OPS_PER_ENTRY


def kept_phase(torch, card, fna, panel, parent_lib=None):
    """Phase 3g: kept against kept_reference on the card, through the
    checked call and the panel's lean call (KeptPlan): the bench step's
    real stream (its screen scores, routing, pool and words, as the step
    hands them over) and KEPT_CASES; 25 replays of a CUDA graph of the
    lean call; its time alone and each launch's, each wrapper's host time,
    the plain version's time and the byte bound, a torch.nonzero of the
    keep flags as a yardstick; beside it the kernel of an earlier version
    of the sources (`parent_lib`, or None), timed in turns with the
    shipped one."""
    import numpy as np

    from tntblast_tpu_torch import _kernels
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.ops.kept import (
        KeptPlan, keep_flags, kept, kept_reference)
    from tntblast_tpu_torch.tools.bench_inputs import (
        KEPT_ARGS, bench_options, bench_panel, kept_inputs, step_plan_inputs)
    from tntblast_tpu_torch.tools.compact_steps import kept_runner
    from tntblast_tpu_torch.tools.device_bench import bench_fragments
    from tntblast_tpu_torch.tools.screen_probe import cuda_ms

    names = ("header", "kept_block")

    def compare(largs, bkcap, rargs, kw, what, lean):
        """largs: the lean call's arguments; rargs: kept_reference's."""
        got = kept(*rargs, **kw, bkcap=bkcap)
        lean_got = lean(*largs, bkcap=bkcap)
        torch.cuda.synchronize()
        want = kept_reference(*rargs, **kw, bkcap=bkcap)
        torch.cuda.synchronize()
        bad = _differ(torch, names, got, want)
        bad_lean = _differ(torch, names, lean_got, want)
        err = max(_max_err(got, want), _max_err(lean_got, want))
        print(f"kept vs plain, {what}: Bp={rargs[1].shape[0]} "
              f"bkcap={bkcap} num_cond={kw['num_cond']} eval "
              f"{rargs[7] is not None}: checked call "
              f"{'equal on header and kept block' if not bad else bad}, "
              f"lean call {'equal' if not bad_lean else bad_lean} "
              f"(max_abs_err={err}); n_kept {int(want[0][0])}")
        check(not bad and not bad_lean and err == 0,
              f"kept kernel disagrees with its plain version ({what}): "
              f"checked {bad}, lean {bad_lean}")
        return want, err

    dp = bench_panel(fna, panel)
    cfg = dp.config
    plan = dp.tabs["kept_plan"]
    opt = bench_options(fna, panel, os.devnull)
    frags = bench_fragments(opt, open_database(fna), 8)
    largs, lkw = step_plan_inputs(dp, frags, "kept_plan")
    Bp = largs[1].shape[0]
    st = dp.tabs["slots"]
    rargs = (*largs[:10], dp.tabs["ow"], st["thr"], *largs[10:])
    kw = dict(num_cond=cfg.num_cond, num_os=cfg.num_os,
              max_words=cfg.max_words,
              nw_pos=cfg.tile_len - cfg.word_len + 1)
    bkcap = lkw["bkcap"]
    out, max_err = compare(largs, bkcap, rargs, kw,
                           "the bench step's stream", plan)
    rng = np.random.default_rng(20261020)
    for n, cap, num_cond, eval_on, sbk, share, mw, letters in KEPT_CASES:
        case = kept_inputs(rng, n=n, cap=cap, num_os=40, num_cond=num_cond,
                           eval_on=eval_on, valid_share=share, max_words=mw,
                           alphabet=letters)
        t = {k: (torch.from_numpy(np.ascontiguousarray(case[k])).cuda()
                 if case[k] is not None else None) for k in KEPT_ARGS}
        slean = KeptPlan(t["ow"], t["thr"], nw_pos=case["nw_pos"])
        s_largs = (*(t[k] for k in KEPT_ARGS[:10]),
                   *(t[k] for k in KEPT_ARGS[12:]))
        skw = dict(num_cond=num_cond, num_os=40,
                   max_words=case["max_words"], nw_pos=case["nw_pos"])
        max_err = max(max_err, compare(
            s_largs, sbk, [t[k] for k in KEPT_ARGS], skw, "synthetic",
            slean)[1])
    _replays(torch, lambda: plan(*largs, bkcap=bkcap), out, names, "kept")
    print(f"kept on the bench step: {STAGE_REPLAYS} replays of a CUDA graph "
          f"of the lean call (outputs set to 0xFF before each) equal the "
          f"plain version on header and kept block; on {card}")

    def run_kernel():
        return plan(*largs, bkcap=bkcap)

    k_ms, per_launch, h_lean, h_checked, p_ms = _stage_times(
        torch, run_kernel, lambda: kept(*rargs, **kw, bkcap=bkcap),
        lambda: kept_reference(*rargs, **kw, bkcap=bkcap), KEPT_LAUNCHES)
    ptxas = _kernels.ptxas_summary(_kernels.build_log["kept"], ".")
    # the yardstick: one torch.nonzero of the step's keep flags (a
    # primitive inside the function, with its host sync; the port never
    # calls it on a card)
    keep = keep_flags(largs[0], largs[1], largs[5], largs[6], st["thr"],
                      num_cond=cfg.num_cond, num_os=cfg.num_os)
    nonzero_ms = cuda_ms(lambda: torch.nonzero(keep), 20)
    print(f"kept yardstick: one torch.nonzero of the bench step's {Bp} keep "
          f"flags {nonzero_ms:.4f} ms (CUDA events, 20 queued, each with "
          f"its host sync); on {card}")
    turns = None
    if parent_lib is not None:
        earlier = kept_runner(parent_lib, largs, bkcap, dp.tabs["ow"],
                              st["thr"], nw_pos=kw["nw_pos"],
                              index=plan.index)
        turns = _in_turns(torch, "kept", card, run_kernel, earlier, out,
                          names)
    n_bytes, n_ops = kept_work(largs, out, st["thr"], cfg.num_cond,
                               cfg.num_os, cfg.max_words, dp.eval_on)
    clock = sm_clock_hz(torch, run_kernel, k_ms)
    b_ms, b_by = bound_ms(n_bytes, n_ops, clock)
    n_kept = int(out[0][0])
    print(f"kept ptxas: {ptxas}")
    print(f"kept kernel alone (CUDA graph of 20 calls, "
          f"{len(KEPT_LAUNCHES)} launches each): {k_ms:.4f} ms for the bench "
          f"step's {Bp} entries ({n_kept} kept, bkcap {bkcap}); each launch "
          f"(profiler, 20 calls): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in per_launch.items())
          + f"; host time a call: lean (KeptPlan) {1e3 * h_lean:.1f} us, "
          f"checked {1e3 * h_checked:.1f} us; plain PyTorch {p_ms:.4f} ms; "
          f"on {card}")
    print(f"kept bound: {b_ms:.4f} ms by {b_by} ({n_bytes} bytes: validity, "
          f"routing, slots and scores of the entries that need them, the "
          f"kept entries' gathers and kmin's words, the header and the "
          f"9 x {bkcap} kept block; {n_ops} int32 ops at "
          f"{clock / 1e6:.0f} MHz); the kernel alone is at "
          f"{100 * b_ms / k_ms:.1f}% of it on {card}")
    row = {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "host_ms_lean": h_lean, "host_ms_checked": h_checked,
           "entries": Bp, "kept": n_kept, "bkcap": bkcap, "ptxas": ptxas,
           "nonzero_yardstick_ms": nonzero_ms,
           **{f"ms_{k}": v for k, v in per_launch.items()}}
    if turns is not None:
        row["turns"] = turns
    return row


def graph_summary(step_graph, card):
    """One line a kept graph of the device step (its key's tile, fragments
    and full flag, the capture's host time, replays) and the graph pool's
    bytes on the card."""
    lines = []
    for key, g in step_graph.graphs().items():
        cfg_key, n_frags, full, device = key[0], key[3], key[7], key[9]
        lines.append(
            f"step graph: tile {cfg_key[4]}, cap {cfg_key[5]}, {n_frags} "
            f"fragments, full {full}, {device}: capture {g.capture_ms:.3f} "
            f"ms (host; the eager first step before it {g.warm_ms:.3f} ms), "
            f"{g.replays} replays, {card}")
    lines.append(f"step graph pool: {step_graph.pool_bytes('cuda')} bytes on "
                 f"{card}")
    return lines


def graph_phase(torch, card, fna, panel):
    """Phase 3e: the device step's CUDA graph against the eager step on the
    bench panel's steps of 8 bench fragments: three payloads, each step of
    both kinds with full False and True, six graph steps in flight (the
    first captures) resolved last first; header, the used kept block and
    the five full outputs equal bit for bit, the launches the graph steps
    ask for; the card's reserved memory before and after the captures;
    then the step's time by CUDA events, graph and eager in turns (graph,
    eager, eager, graph), its host time to queue a step, the capture's host
    time and the graph pool's bytes."""
    from tntblast_tpu_torch.engine import make_melt_engine
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.parallel import step_graph
    from tntblast_tpu_torch.parallel.panel import FragmentPanelManager
    from tntblast_tpu_torch.tools.bench_inputs import (
        bench_options, eager_step)
    from tntblast_tpu_torch.tools.device_bench import bench_fragments

    opt = bench_options(fna, panel, os.devnull)
    mgr = FragmentPanelManager(opt, make_melt_engine(opt, n_threads=1),
                               "cuda")
    n = mgr.batch
    frags = bench_fragments(opt, open_database(fna), 3 * n)
    check(len(frags) >= 2 * n, f"{len(frags)} bench fragments")
    payloads = [frags[i:i + n] for i in (0, n, len(frags) - n)]
    dp = mgr.groups[0].device_panel(
        mgr._tile_len(max(len(f) for f in frags)))
    payloads = [dp._pack_host(b) for b in payloads]

    def same(got, want, full, what):
        header = want[0].cpu()
        check(torch.equal(got[0].cpu(), header), f"{what}: header differs")
        m = min(int(header[0]), dp.config.batch_kcap(n))
        check(m > 0, f"{what}: nothing kept")
        check(torch.equal(got[1][:, :m].cpu(), want[1][:, :m].cpu()),
              f"{what}: kept block differs")
        if full:
            for i, name in enumerate(("slot", "p", "keep", "needs_host",
                                      "valid"), 2):
                check(torch.equal(got[i].cpu(), want[i].cpu()),
                      f"{what}: {name} differs")

    eager = {full: [eager_step(dp, pl, full) for pl in payloads]
             for full in (False, True)}
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    captures0 = step_graph.stats["captures"]
    with StepLaunches() as counted:
        for full in (False, True):
            graphed = [dp.step(pl, full=full) for pl in payloads * 2]
            for i in reversed(range(len(graphed))):
                same(graphed[i], eager[full][i % 3], full,
                     f"graph step {i} (full {full})")
        torch.cuda.synchronize()
        counted.read("the graph phase")
    check(step_graph.stats["captures"] - captures0 == 2,
          "the graph phase did not capture once a key")
    reserved1 = torch.cuda.memory_reserved()
    print(f"graph phase: the card's reserved memory {reserved0} bytes after "
          f"the eager steps, {reserved1} after the two captures "
          f"(+{reserved1 - reserved0}; the graph pool "
          f"{step_graph.pool_bytes('cuda')} bytes) on {card}")
    print(f"graph phase: the step's CUDA graph == the eager step bit for "
          f"bit on 3 payloads of {n} bench fragments, full False and True, "
          f"6 graph steps in flight resolved last first (the first of each "
          f"key its capture's eager step), launches {counted.expected}, "
          f"{card}")

    turns = {"graph": [], "eager": []}
    host = {"graph": [], "eager": []}
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for label in ("graph", "eager", "eager", "graph"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        for _ in range(GRAPH_REPS):
            if label == "eager":
                eager_step(dp, payloads[0])
            else:
                dp.step(payloads[0])
        b.record()
        t1 = time.perf_counter()
        b.synchronize()
        turns[label].append(a.elapsed_time(b) / GRAPH_REPS)
        host[label].append((t1 - t0) * 1e3 / GRAPH_REPS)
    print(f"graph phase: batch_ms ({GRAPH_REPS} queued steps of {n} bench "
          f"fragments, CUDA events) in turns graph, eager, eager, graph: "
          f"graph {turns['graph']}, eager {turns['eager']}; host ms to "
          f"queue a step: graph {host['graph']}, eager {host['eager']}; "
          f"{card}")
    print("\n".join(graph_summary(step_graph, card)))
    return {"graph_batch_ms": turns["graph"], "eager_batch_ms":
            turns["eager"]}


def run_slice(torch, card, fna, panel, work, flag, reps):
    """Phases 4 and 5: the bench config through the port's local_main with
    the device flag `flag` ("--tpu-screen" or "--mesh"); returns the
    launch counts of the step's kernels in the first run."""
    import tntblast_tpu_torch.parallel.panel as port_panel
    from tntblast_tpu_torch import cli
    from tntblast_tpu_torch.engine import _fragment_work_items
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.parallel.mesh import MeshPanel, make_mesh
    from tntblast_tpu_torch.tools.bench_inputs import (
        BENCH_ARGS, bench_options)

    made = []
    plain_mgr = port_panel.FragmentPanelManager

    class Recorded(plain_mgr):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    name = "mesh" if flag == "--mesh" else "slice"
    out_path = os.path.join(work, f"port_out_{name}.txt")
    argv = ["-i", panel, "-d", fna, *BENCH_ARGS, "-o", out_path,
            flag, "T", "-v", "F"]
    opt = bench_options(fna, panel, out_path)
    db = open_database(fna)
    items, _ = _fragment_work_items(opt, db)
    mb = sum(db.approx_seq_len(i) for i in range(db.size())) / 1e6

    walls = []
    port_panel.FragmentPanelManager = Recorded
    try:
        for rep in range(reps):
            # the first run's launches are counted against its steps; a
            # later run, with a fresh panel manager, replays the graphs the
            # first captured and never calls panel_step_core
            counted = StepLaunches() if rep == 0 else CoreCalls()
            with counted:
                t0 = time.perf_counter()
                rc = cli.local_main(argv, stdout=io.StringIO(),
                                    device="cuda")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            if rep == 0:
                launches = counted.read(f"the {name} path")
            else:
                check(counted.calls == counted.captures == 0,
                      f"{name} run {rep}: {counted.calls} calls of "
                      f"panel_step_core, {counted.captures} captures: the "
                      f"steps did not all replay")
            check(rc == 0, f"local_main returned {rc}")
            digest = sha256(out_path)
            check(digest == BENCH_GOLDEN_SHA256,
                  f"{name}: bench output sha256 {digest} != reference")
            mgr = made[-1]
            print(f"{name} run {rep}: wall={walls[-1]:.3f} s "
                  f"({mb / walls[-1]:.3f} Mb/s) stats={mgr.stats} "
                  f"batch={mgr.batch} on {card}")
            check(mgr.stats["fallback"] == 0,
                  "fragments fell back to the host")
            check(mgr.stats["fragments"] == len(items),
                  f"{mgr.stats['fragments']} device fragments, "
                  f"{len(items)} work items")
            if flag == "--mesh":
                check(mgr.mesh == make_mesh(), "mesh is not make_mesh()")
                check(all(isinstance(dp, MeshPanel) for g in mgr.groups
                          for dp in g._panels.values()),
                      "--mesh did not go through MeshPanel")
    finally:
        port_panel.FragmentPanelManager = plain_mgr
    print(f"{name}: bench {mb:.1f} Mb, {len(items)} fragments, output "
          f"sha256 matches the reference, launches={launches}")
    med = statistics.median(walls[1:] or walls)
    print(f"{name} wall (median of the runs after the first, {reps} runs): "
          f"{med:.3f} s = {mb / med:.3f} Mb/s; first run {walls[0]:.3f} s; "
          f"on {card}")
    return launches


def run_goldens(card):
    """Phase 6: golden configs through the CLI module on the card."""
    data = os.path.join(HERE, "tests", "data")
    gold = os.path.join(HERE, "tests", "golden", "e2e")
    env = dict(os.environ, PYTHONPATH=HERE)
    for name in GOLDENS:
        with open(os.path.join(gold, f"{name}.cmd")) as fh:
            args = fh.read().split()
        out = os.path.join(HERE, "bench_work", f"golden_{name}.out")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tntblast_tpu_torch", *args, "-o", out,
             "--tpu-screen", "T", "-v", "F"],
            cwd=data, env=env, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f"{name}: exit {proc.returncode}\n{proc.stderr}")
        with open(out) as a, open(os.path.join(gold, f"{name}.out")) as b:
            check(a.read() == b.read(), f"{name}: output differs")
        print(f"golden {name}: byte-identical on the card "
              f"({time.perf_counter() - t0:.1f} s incl. start-up, {card})")


def run_goldens_in_process(torch, card):
    """Phase 6, second half: the configurations of GOLDENS_IN_PROCESS
    through local_main on the card, in this process."""
    import tntblast_tpu_torch.parallel.panel as port_panel
    from tntblast_tpu_torch import cli

    data = os.path.join(HERE, "tests", "data")
    gold = os.path.join(HERE, "tests", "golden", "e2e")
    made = []
    plain_mgr = port_panel.FragmentPanelManager

    class Recorded(plain_mgr):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    cwd = os.getcwd()
    os.chdir(data)
    port_panel.FragmentPanelManager = Recorded
    t0 = time.perf_counter()
    try:
        for name in GOLDENS_IN_PROCESS:
            with open(os.path.join(gold, f"{name}.cmd")) as fh:
                args = fh.read().split()
            out = os.path.join(HERE, "bench_work", f"golden_ip_{name}.out")
            del made[:]
            with StepLaunches() as counted:
                rc = cli.local_main([*args, "-o", out, "--tpu-screen", "T",
                                     "-v", "F"], stdout=io.StringIO(),
                                    device="cuda")
                torch.cuda.synchronize()
            check(rc == 0, f"{name}: local_main returned {rc}")
            with open(out) as a, open(os.path.join(gold, f"{name}.out")) as b:
                check(a.read() == b.read(), f"{name}: output differs")
            check(len(made) == 1 and made[0].stats["fragments"] > 0
                  and made[0].stats["fallback"] == 0,
                  f"{name}: not through the device path: "
                  f"{[m.stats for m in made]}")
            evaluator = all(g.eval_dg is not None for g in made[0].groups)
            check(evaluator == (name != "pcr_dinkelbach"),
                  f"{name}: device evaluator {'on' if evaluator else 'off'}")
            counted.read(f"golden {name}", evaluator)
        # the dense seeding path: pcr_small with 3-base words, whose
        # 64-word table holds too many slots a word for the table path
        with open(os.path.join(gold, "pcr_small.cmd")) as fh:
            args = fh.read().split()
        out = os.path.join(HERE, "bench_work", "golden_ip_pcr_small_w3.out")
        del made[:]
        with StepLaunches() as counted:
            rc = cli.local_main([*args, "-W", "3", "-o", out, "--tpu-screen",
                                 "T", "-v", "F"], stdout=io.StringIO(),
                                device="cuda")
            torch.cuda.synchronize()
        check(rc == 0, f"pcr_small -W 3: local_main returned {rc}")
        digest = sha256(out)
        check(digest == sha256(os.path.join(gold, "pcr_small.out")),
              "pcr_small -W 3 (dense seeding): output differs from the "
              "pcr_small golden")
        dense = [dp.host_tables[1].shape for m in made for g in m.groups
                 for dp in g._panels.values()]
        check(dense and all(shape[0] == 1 for shape in dense)
              and all("seed_dense_plan" in dp.tabs for m in made
                      for g in m.groups for dp in g._panels.values())
              and made[0].stats["fallback"] == 0
              and made[0].stats["fragments"] > 0,
              f"pcr_small -W 3: not the dense path on the card: {dense}, "
              f"{made[0].stats}")
        dense_launches = counted.read("pcr_small -W 3 (dense seeding)",
                                      table=False)
    finally:
        port_panel.FragmentPanelManager = plain_mgr
        os.chdir(cwd)
    print(f"pcr_small -W 3 through the dense seeding path on the card: "
          f"sha256 {digest} equals the pcr_small golden's, 0 fallbacks, "
          f"launches {dense_launches} (the seed_dense kernel once a step, no "
          f"tensor-code seeding), {card}")
    print(f"{len(GOLDENS_IN_PROCESS)} goldens through local_main on the "
          f"card in this process: byte-identical, 0 fallbacks, each "
          f"kernel of the step launched as often as its steps ask "
          f"(pcr_dinkelbach: the evaluator is off, no eval_pack) "
          f"({', '.join(GOLDENS_IN_PROCESS)}; "
          f"{time.perf_counter() - t0:.1f} s, {card})")


def run_ranks(argv, cwd):
    """Two ranks of the port's multi-process runtime on `argv`, each on its
    default device, the card (tools/launches.py run_ranks).  Returns (wall
    seconds, [each rank's profile line])."""
    from tntblast_tpu_torch.tools import launches

    wall, ranks = launches.run_ranks(argv, cwd)
    lines = []
    for rank, (rc, out) in enumerate(ranks):
        check(rc == 0, f"rank {rank}: exit {rc}\n{out[-3000:]}")
        line = launches.profile_line(out, rank)
        check(line is not None, f"rank {rank}: no profile line\n"
                                f"{out[-2000:]}")
        lines.append(line)
    return wall, lines


def rank_launches(line, plan=None):
    """The launch counts of the step's kernels in a rank, from its profile
    line, after checking that it ran on a card, nothing fell back to the
    host and no module of jax or of the JAX package was loaded there.
    With `plan` (the rank's share, tools/scaled_bench.py step_plan,
    computed from the database and the panel) the rank's fragments, steps
    and launches must be the plan's.  Without, a rank's steps are one
    chunk each at these shapes and seed on one path: seed (the word-table
    path) or seed_dense (the dense path) as often as win_decode, which
    must have run, and the other never; pool, screen_dp, eval_pack and
    kept as often as win_decode."""
    from tntblast_tpu_torch.tools import launches

    check("device cuda:" in line, f"rank not on a card: {line}")
    check("'fallback': 0" in line, f"fragments fell back: {line}")
    check(line.endswith("outside 0"),
          f"a rank imported from outside the port: {line}")
    counts = launches.rank_counts(line)
    if plan is not None:
        stats = launches.line_stats(line)
        seen = dict(counts, fragments=stats["fragments"],
                    steps=stats["steps"])
        check(counts["win_decode"] > 0 and seen == plan,
              f"a rank's launches {seen}, its steps ask for {plan}: {line}")
        return counts
    steps = counts["win_decode"]
    seeds = (counts["seed"], counts["seed_dense"])
    check(steps > 0 and sorted(seeds) == [0, steps]
          and all(n == steps for name, n in counts.items()
                  if name not in ("seed", "seed_dense")),
          f"a rank's launches {counts}: not one of each a step: {line}")
    return counts


def multiproc_phase(card, fna, panel, work):
    """Phase 7: two ranks on the card, the bench config and a mesh golden."""
    from tntblast_tpu_torch.tools.bench_inputs import BENCH_ARGS

    out_path = os.path.join(work, "port_out_multiproc.txt")
    if os.path.exists(out_path):
        os.unlink(out_path)
    argv = ["-i", panel, "-d", fna, *BENCH_ARGS, "-o", out_path,
            "--tpu-screen", "T", "-v", "F"]
    wall, lines = run_ranks(argv, HERE)
    for line in lines:
        print(line)
    per_rank = [rank_launches(line) for line in lines]
    launches = {name: sum(c[name] for c in per_rank)
                for name in per_rank[0]}
    digest = sha256(out_path)
    check(digest == BENCH_GOLDEN_SHA256,
          f"multiproc: bench output sha256 {digest} != reference")
    print(f"multiproc: bench config on 2 ranks of one card, output sha256 "
          f"matches the reference, launches={launches} over the "
          f"ranks ({per_rank} a rank), wall {wall:.3f} s incl. both "
          f"processes' start-up, on {card}")

    gold = os.path.join(HERE, "tests", "golden", "e2e")
    with open(os.path.join(gold, "pcr_frag.cmd")) as fh:
        args = fh.read().split()
    out_path = os.path.join(work, "multiproc_pcr_frag.out")
    wall, lines = run_ranks([*args, "-o", out_path, "--mesh", "T", "-v", "F"],
                            os.path.join(HERE, "tests", "data"))
    for line in lines:
        rank_launches(line)
    with open(out_path) as a, open(os.path.join(gold, "pcr_frag.out")) as b:
        check(a.read() == b.read(), "multiproc pcr_frag --mesh: output "
                                    "differs")
    print(f"multiproc: pcr_frag with --mesh T on 2 ranks byte-identical "
          f"({wall:.1f} s incl. start-up, {card})")
    return launches


def search_layer_hits(opt, db, engine, screen=None):
    """Every hit of the Python search layer (search/assays.py over a
    search/bind.py BindContext) over the configuration's work items, as
    (work item, assay id, the hit's fields), with `screen` in each
    fragment's context."""
    from tntblast_tpu_torch import constants as C
    from tntblast_tpu_torch import engine as eng
    from tntblast_tpu_torch.search import assays
    from tntblast_tpu_torch.search.bind import BindContext, MeltCaches

    search = {C.ASSAY_PCR: assays.amplicon,
              C.ASSAY_PROBE: assays.hybrid}[opt.assay_format]
    items, _ = eng._fragment_work_items(opt, db)
    hits = []
    for idx, (tgt, start, stop, _) in enumerate(items):
        defline, seq_codes = db.read(
            tgt, start, stop + opt.max_product_length() + 2)
        if len(seq_codes) < opt.hash_word_size:
            continue
        ctx = BindContext(engine, seq_codes, opt.hash_word_size,
                          MeltCaches(), defline, screen=screen)
        for sig in opt.sig_list:
            for h in search(ctx, sig, opt):
                hits.append((idx, sig.id, dict(vars(h))))
    return hits


def checked_screen(torch, engine, dangle, device):
    """A TpuScreen on `device` that holds every batch of its path against
    the plain version: the scores window_scores returns (from the screen_dp
    kernel where the codes allow) must equal dp_max_score on the same padded
    batch, run on `device` and on the CPU, over every row, the padding too.
    It sums the host-clock time of its screen_windows calls without those
    comparisons (`seconds`) and counts the compared score rows (`rows`)."""
    from tntblast_tpu_torch import constants as C
    from tntblast_tpu_torch.ops.thermo_dp import dp_max_score
    from tntblast_tpu_torch.screen import TpuScreen, pack_windows

    class CheckedScreen(TpuScreen):
        seconds = check_seconds = 0.0
        rows = 0

        def window_scores(self, oligo_codes, window_codes, temps):
            scores = super().window_scores(oligo_codes, window_codes, temps)
            t0 = time.perf_counter()
            wq = len(oligo_codes)
            wt = wq + 2 * C.NUM_FLANK_BASE
            host = [torch.from_numpy(a) for a in pack_windows(
                oligo_codes, window_codes, len(scores[0]))]
            here = [a.to(self.device) for a in host]
            for T, score in zip(temps, scores):
                dg = self._tables_on_device(T)[0]
                for args, table in ((here, dg), (host, dg.cpu())):
                    want = dp_max_score(*args, table, wq=wq, wt=wt)
                    check(torch.equal(score.cpu(), want.cpu()),
                          f"screen_windows: a batch of {len(window_codes)} "
                          f"windows padded to {len(score)} rows at T={T} "
                          f"differs from dp_max_score on {want.device}")
                self.rows += len(score)
            self.check_seconds += time.perf_counter() - t0
            return scores

        def screen_windows(self, *args):
            t0, c0 = time.perf_counter(), self.check_seconds
            out = super().screen_windows(*args)
            self.seconds += (time.perf_counter() - t0
                             - (self.check_seconds - c0))
            return out

    return CheckedScreen(engine, dangle=dangle, device=device)


def window_screen_run(torch, argv, device):
    """The Python search layer over the configuration of the tntblast
    command line `argv`, without a screen and with a checked_screen on
    `device` in every context: the two hit lists must be equal (the screen
    kept every window the exact evaluator reports as a hit).  Returns the
    hit count, the screen's counters and its time per batch."""
    import numpy as np

    from tntblast_tpu_torch import constants as C
    from tntblast_tpu_torch import engine as eng
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.model import (
        expand_degenerate_signatures, multiplex_expansion, read_input_file)
    from tntblast_tpu_torch.options import Options

    opt = Options()
    opt.parse(argv)
    opt.sig_list = read_input_file(opt.input_filename, opt.ignore_probe,
                                   opt.assay_format == C.ASSAY_PROBE)
    if opt.multiplex:
        opt.sig_list = multiplex_expansion(opt.sig_list, opt.assay_format)
    opt.sig_list = expand_degenerate_signatures(opt.sig_list,
                                                opt.degen_rescale_ct)
    opt.validate_search_threshold()
    db = open_database(opt.dbase_filename or opt.local_dbase_filename)
    engine = eng.make_melt_engine(opt, n_threads=1)
    want = search_layer_hits(opt, db, engine)
    screen = checked_screen(torch, engine,
                            opt.allow_dangle_5 or opt.allow_dangle_3, device)
    got = search_layer_hits(opt, db, engine, screen=screen)
    check(len(got) == len(want) and all(
        g[:2] == w[:2] and g[2].keys() == w[2].keys()
        and all(np.array_equal(g[2][k], w[2][k]) for k in w[2])
        for g, w in zip(got, want)),
        f"{len(got)} hits with the screen, {len(want)} without, or their "
        f"fields differ")
    return {"hits": len(want), "device": str(device), **screen.stats,
            "rows_compared": screen.rows,
            "screen_ms_per_batch":
                1e3 * screen.seconds / max(screen.stats["batches"], 1)}


def window_screen_phase(torch, card, fna, panel):
    """Phase 8: dp_max_score against the kernel and against its CPU run,
    then screen_windows behind search/bind.py."""
    import numpy as np

    from tntblast_tpu_torch import constants as C
    from tntblast_tpu_torch.engine import make_melt_engine
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.ops.screen_dp import screen_dp
    from tntblast_tpu_torch.ops.thermo_dp import (
        build_qpair_rows, build_t_canon, dp_max_score, dp_scores_canon)
    from tntblast_tpu_torch.screen import TpuScreen, pack_windows
    from tntblast_tpu_torch.search.bind import BindContext
    from tntblast_tpu_torch.tools.bench_inputs import bench_options
    from tntblast_tpu_torch.tools.screen_probe import cuda_ms

    opt = bench_options(fna, panel, os.devnull)
    engine = make_melt_engine(opt, n_threads=1)
    _, seq = open_database(fna).read(0, 0, 499_999)
    oligo = C.ASCII_TO_MELT[np.frombuffer(
        opt.sig_list[0].forward_oligo.encode(), np.uint8)]
    wq = len(oligo)
    wt = wq + 2 * C.NUM_FLANK_BASE
    rng = np.random.default_rng(20261016)
    B = 4096
    # windows as search/bind.py cuts them, half on each strand
    cut = BindContext(None, seq, 0, None).window_codes
    starts = rng.integers(0, len(seq) - wt, B)
    wins = [cut(int(s), int(s) + wt, i < B // 2)
            for i, s in enumerate(starts)]
    scr = TpuScreen(engine, device="cuda")
    conds = scr.conditions(dict(min_tm=opt.min_primer_tm,
                                max_dg=opt.max_primer_dg),
                           opt.forward_primer_strand)
    check(len(conds) == 2, f"{len(conds)} screening conditions")
    dev = torch.device("cuda")
    for what, degenerate in (("codes in 0..4", False),
                             ("degenerate codes", True)):
        batch = [w.copy() for w in wins]
        if degenerate:
            for w in batch[::3]:
                w[rng.integers(0, len(w), 3)] = rng.integers(5, 18, 3)
        qc, ql, tc, tl = pack_windows(oligo, batch, B)
        check(degenerate == bool(max(qc.max(), tc.max()) > 4),
              f"the batch's codes are not {what}")
        for _, T, _ in conds:
            dg_d, tcan_d = scr._tables_on_device(T)
            args = [torch.from_numpy(a) for a in (qc, ql, tc, tl)]
            want = dp_max_score(*args, dg_d.cpu(), wq=wq, wt=wt)
            dargs = [a.to(dev) for a in args]
            got = dp_max_score(*dargs, dg_d, wq=wq, wt=wt)
            check(torch.equal(got.cpu(), want),
                  f"dp_max_score on the card != on the CPU ({what}, T={T})")
            if degenerate:
                continue
            qp = torch.from_numpy(np.repeat(
                build_qpair_rows([oligo], [wq], wq=wq), B, axis=0)).to(dev)
            before = screen_dp.launches
            canon = dp_scores_canon(qp, dargs[1], dargs[2], dargs[3], tcan_d)
            check(screen_dp.launches == before + 1,
                  "dp_scores_canon did not launch the kernel")
            check(torch.equal(canon, got),
                  f"dp_max_score != dp_scores_canon on the card (T={T})")
            check(torch.equal(torch.from_numpy(build_t_canon(
                dg_d.cpu().numpy())), tcan_d.cpu()), "canonical table")
            if T != conds[-1][1]:
                continue
            full_ms = cuda_ms(
                lambda: dp_max_score(*dargs, dg_d, wq=wq, wt=wt), 2,
                batches=3)
            canon_ms = cuda_ms(lambda: dp_scores_canon(
                qp, dargs[1], dargs[2], dargs[3], tcan_d), 10, batches=3)
            print(f"per {B}-window batch at one temperature: dp_max_score "
                  f"(PyTorch tensor code) {full_ms:.3f} ms, dp_scores_canon "
                  f"(screen_dp kernel) {canon_ms:.3f} ms, on {card}")
        print(f"dp_max_score on the card == on the CPU, {what}: {B} bench "
              f"windows x {len(conds)} temperatures, max score "
              f"{int(want.max())}, bit for bit"
              + ("" if degenerate else "; == dp_scores_canon (screen_dp "
                                       "kernel)"))
    gold = os.path.join(HERE, "tests", "golden", "e2e", "pcr_small.cmd")
    with open(gold) as fh:
        args = fh.read().split()
    cwd = os.getcwd()
    os.chdir(os.path.join(HERE, "tests", "data"))
    try:
        # the count is of this path alone, not of the comparisons above
        screen_dp.launches = 0
        res = window_screen_run(torch, args, "cuda")
        launches = screen_dp.launches
    finally:
        os.chdir(cwd)
    check(res["hits"] > 0 and res["screened"] > 0,
          f"window screen did nothing: {res}")
    check(res["canon"] > 0 and launches >= res["canon"],
          f"screen_windows never reached the kernel: {res}")
    print(f"screen_windows behind search/bind.py on pcr_small: {res['hits']} "
          f"hits with and without the screen, {res['screened']} windows "
          f"screened out, {res['kept']} kept in {res['batches']} batches "
          f"({res['canon']} through the screen_dp kernel, {res['full']} "
          f"through dp_max_score), every batch's scores == dp_max_score on "
          f"the card and on the CPU over {res['rows_compared']} padded rows, "
          f"{res['screen_ms_per_batch']:.3f} ms a batch (both conditions, "
          f"host clock, first batch's table upload included; screen_dp "
          f"launches={launches}) on {card}")
    return launches


def entry_phase(torch, card):
    """Phase 9: the step entry point on the card against the CPU."""
    from tntblast_tpu_torch.entry import dryrun_multichip, entry
    from tntblast_tpu_torch.tools import launches

    fn, args = entry("cuda")
    fn(*args)                                # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    launches.reset()
    a.record()
    got = fn(*args)
    b.record()
    b.synchronize()
    # one step of one chunk on the table path (entry binds panel_step_core
    # itself)
    counts = launches.counts()
    check(counts == dict(dict.fromkeys(launches.STEP_KERNELS, 1),
                         seed_dense=0),
          f"entry: launches {counts}, expected one of each kernel of the "
          f"table path")
    cfn, cargs = entry("cpu")
    want = cfn(*cargs)
    n_kept = int(want[0][0])
    check(n_kept > 0, "entry kept nothing")
    names = ("header", "kept_block", "slot", "p", "keep", "needs_host",
             "valid")
    for name, g, w in zip(names, got, want):
        g = g.cpu()
        if name == "kept_block":            # the used prefix is in contract
            g, w = g[:, :n_kept], w[:, :n_kept]
        check(torch.equal(g, w), f"entry: {name} differs from the CPU step")
    print(f"entry: one step of the synthetic panel (2 fragments of 16384, 8 "
          f"slots, wq_max 32) equals the CPU step on all 7 outputs, "
          f"n_kept={n_kept}, {a.elapsed_time(b):.3f} ms (CUDA events) on "
          f"{card}")
    dryrun_multichip(torch.cuda.device_count())
    print(f"dryrun_multichip({torch.cuda.device_count()}): pcr_frag "
          f"byte-identical through --mesh T")
    return counts


def bench_phase(card, fna, panel):
    """Phase 10: the device microbench."""
    from tntblast_tpu_torch.tools import device_bench, launches

    res = device_bench.run(fna, panel)
    per_step = {name: res[f"{name}_launches_per_step"]
                for name in launches.STEP_KERNELS}
    check(res["batch_ms"] > 0 and res["kept_seeds"] > 0
          and per_step == {"seed": 1, "seed_dense": 0, "pool": 1,
                           "win_decode": 1,
                           "screen_dp": res["chunks"],
                           "eval_pack": res["chunks"], "kept": 1},
          f"device_bench: {res}")
    print(f"device_bench on {card}: {json.dumps(res)}")
    return {name: int(v) for name, v in per_step.items()}


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--parent-csrc", default=None,
        help="an earlier version of tntblast_tpu_torch/csrc whose "
             "eval_pack, win_decode, seed, pool, kept, seed_dense and "
             "screen_dp kernels phases 3b, 3c, 3d, 3f, 3g, 3h and 4b time "
             "beside the shipped ones "
             "(default: parent_csrc/ beside this script when it holds "
             "win_decode.cu)")
    opts = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    parent_csrc = opts.parent_csrc
    if parent_csrc is None and os.path.exists(
            os.path.join(HERE, "parent_csrc", "win_decode.cu")):
        parent_csrc = os.path.join(HERE, "parent_csrc")
    sys.path.insert(0, HERE)
    import bench_data
    from tntblast_tpu_torch import _kernels
    from tntblast_tpu_torch.tools.screen_probe import card_name

    card = card_name()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # one compiler process per source, all started together
    t0 = time.perf_counter()
    names = _kernels.KERNELS
    errors, built = {}, {}

    def build(name, tag="", csrc=None):
        try:
            built[name + tag] = _kernels.build(name, force=True, tag=tag,
                                               csrc=csrc)
        except Exception as e:      # noqa: BLE001 — reported below
            errors[name + tag] = e

    jobs = [(n,) for n in names]
    earlier = ("win_decode", "seed", "pool", "kept", "seed_dense",
               "screen_dp", "eval_pack")
    if parent_csrc is not None:     # the earlier kernels timed in turns
        jobs += [(n, "_earlier", parent_csrc) for n in earlier
                 if os.path.exists(os.path.join(parent_csrc, f"{n}.cu"))]
    threads = [threading.Thread(target=build, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, e in errors.items():
        raise SmokeFailure(f"{name} did not build: {e}")
    print(f"built {', '.join(names)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s"
          + (f", and {', '.join(earlier)} from {parent_csrc}"
             if parent_csrc else ""))
    for name in names:
        for line in _kernels.ptxas_summary(_kernels.build_log[name], "."):
            print(f"{name}: ptxas: {line}")
        bad = _kernels.ptxas_problems(_kernels.build_log[name])
        check(not bad, f"{name}: a kernel meant to live in registers went "
                       f"to local memory: {bad}")
    for name in earlier:
        if name + "_earlier" in built:
            for line in _kernels.ptxas_summary(
                    _kernels.build_log[name + "_earlier"], "."):
                print(f"{name} (earlier sources): ptxas: {line}")
    print("ptxas: 0 bytes of stack frame and spill in seed, seed_dense, "
          "pool, win_decode, eval_pack, kept and every kernel that keeps its "
          "DP row in registers")

    work = os.path.join(HERE, "bench_work")
    fna, panel = bench_data.build(work)

    dp_row = kernel_vs_plain(torch, card, fna, panel)
    probe_row = probe_phase(torch, card)
    eval_row = eval_phase(torch, card, fna, panel,
                          built.get("eval_pack_earlier"))
    decode_row, stream_rows = decode_phase(
        torch, card, fna, panel, built.get("win_decode_earlier"))
    seed_row = seed_phase(torch, card, fna, panel, built.get("seed_earlier"),
                          parent_csrc)
    pool_row = pool_phase(torch, card, fna, panel, built.get("pool_earlier"))
    kept_row = kept_phase(torch, card, fna, panel, built.get("kept_earlier"))
    seed_dense_row = seed_dense_phase(torch, card, fna, work,
                                      built.get("seed_dense_earlier"))
    # every step graph of this process held against the kernels it runs
    with GraphKernels(work) as held:
        graph_phase(torch, card, fna, panel)
        # the launch counts of the step's kernels on every path of the step
        paths = {"launches": run_slice(torch, card, fna, panel, work,
                                       "--tpu-screen", 2),
                 "launches_mesh": run_slice(torch, card, fna, panel, work,
                                            "--mesh", 1)}
        run_goldens(card)
        run_goldens_in_process(torch, card)
        (paths["launches_probes"], probe_dp_row, probe_eval_row,
         probe_bench_res) = long_probe_phase(
             torch, card, fna, work, built.get("screen_dp_earlier"))
        (paths["launches_wide_probes"], wide_dp_row, wide_eval_row,
         wide_bench_res) = long_probe_phase(torch, card, fna, work,
                                            config="wide")
        paths["launches_scaled"] = scaled_phase(torch, card, work)
        paths["launches_multiproc"] = multiproc_phase(card, fna, panel,
                                                      work)
        launches_window_screen = window_screen_phase(torch, card, fna,
                                                     panel)
        paths["launches_entry_step"] = entry_phase(torch, card)
        paths["launches_device_bench_step"] = bench_phase(card, fna, panel)
    check(held.checked >= 2, f"{held.checked} step graphs captured")
    print(f"step graphs: each of the {held.checked} captured in this process "
          f"holds, by its kernel nodes' names, the launches its capture "
          f"recorded; on {card}")

    def launches_of(name):
        return {key: counts[name] for key, counts in paths.items()}

    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "tntblast_tpu"
              or m.startswith("tntblast_tpu.")]
    check(not loaded, f"imported from outside the port: {loaded[:5]}")
    print("no module of jax or of tntblast_tpu was imported, here or in a "
          "rank")
    from tntblast_tpu_torch.parallel import step_graph
    print("\n".join(graph_summary(step_graph, card)))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [
        # no Pallas original: the XLA-jitted unpack + _seed_fragment's
        # table path
        {"name": "seed", "route": "cuda",
         "source": "tntblast_tpu_torch/csrc/seed.cu",
         "replaces": "tntblast_tpu/parallel/device_search.py:102",
         **launches_of("seed"), **seed_row},
        # no Pallas original: the XLA-jitted unpack + _seed_fragment's
        # dense path; its main path is the long-probe search (the bench
        # slice seeds on the table path: "launches_bench_slice" 0)
        {"name": "seed_dense", "route": "cuda",
         "source": "tntblast_tpu_torch/csrc/seed_dense.cu",
         "replaces": "tntblast_tpu/parallel/device_search.py:219",
         **launches_of("seed_dense"),
         "launches": paths["launches_probes"]["seed_dense"],
         "launches_bench_slice": paths["launches"]["seed_dense"],
         "long_probe_batch_ms": probe_bench_res["batch_ms"],
         "wide_probe_batch_ms": wide_bench_res["batch_ms"],
         **seed_dense_row},
        # no Pallas original: the XLA-jitted stable argsort by slot
        {"name": "pool", "route": "cuda",
         "source": "tntblast_tpu_torch/csrc/pool.cu",
         "replaces": "tntblast_tpu/parallel/device_search.py:468",
         **launches_of("pool"), **pool_row},
        # no Pallas original: the XLA-jitted win_decode + slot_scalars
        {"name": "win_decode", "route": "cuda",
         "source": "tntblast_tpu_torch/csrc/win_decode.cu",
         "replaces": "tntblast_tpu/parallel/device_search.py:529",
         **launches_of("win_decode"), **decode_row},
        {"name": "screen_dp", "route": "cuda",
         "source": "tntblast_tpu_torch/csrc/screen_dp.cu",
         "replaces": "tntblast_tpu/ops/pallas_screen.py:93",
         **launches_of("screen_dp"),
         "launches_window_screen": launches_window_screen, **dp_row,
         **stream_rows["screen_dp"], **probe_dp_row, **wide_dp_row},
        {"name": "screen_probe", "route": "cuda",
         "source": "tntblast_tpu_torch/csrc/screen_probe.cu",
         "replaces": "tools/tpu_pallas_probe2.py:18", **probe_row},
        # no Pallas original: the XLA-jitted eval_flat + pack_eval
        {"name": "eval_pack", "route": "cuda",
         "source": "tntblast_tpu_torch/csrc/eval_pack.cu",
         "replaces": "tntblast_tpu/ops/eval_gapless_jax.py:270",
         **launches_of("eval_pack"), **eval_row,
         **stream_rows["eval_pack"], **probe_eval_row, **wide_eval_row},
        # no Pallas original: the XLA-jitted keep flags and kept-seed
        # compaction, kmin and header
        {"name": "kept", "route": "cuda",
         "source": "tntblast_tpu_torch/csrc/kept.cu",
         "replaces": "tntblast_tpu/parallel/device_search.py:854",
         **launches_of("kept"), **kept_row}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
