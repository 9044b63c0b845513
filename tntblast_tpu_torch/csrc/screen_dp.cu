// Screening DP of the device seed+screen step, designed for the Hopper SM
// (sm_90a).
//
// Replaces the TPU kernel tntblast_tpu/ops/pallas_screen.py::_screen_kernel
// and the default XLA form of the same DP, the row scan of
// tntblast_tpu/parallel/device_search.py run_chunk/one_row.  Where those
// work on slot-homogeneous 512-window blocks with the slot's energies
// pre-expanded per row (TS), this kernel runs on the flat mixed-slot stream
// and reads every energy from the canonical table of its condition:
//
//     e[k] = T_canon[c][ptb[j]][qp[slot][r]][k]        (k = 0..6)
//
// which is exactly the value TS holds, with no one-hot selection.
//
// Per window and condition c it runs the exact-int32 3-state NucCruc DP
// (dp_core.cuh) over the window's rows r < min(ql, wq_max) and all wt_max
// target columns, and produces:
//   best[c][b]       max M over rows r < ql, columns j < wt_e (-1 floor)
//   mgmax[b]         max of the gapped-best channel Mg of the LAST
//                    condition (the eval condition) when eval_on, else
//                    -(1 << 29)
//   mrows[r][b][:]   the last condition's M row r with the -1 boundary
//                    column 0 (the layout eval_flat reads), rows r < ql
//                    only; rows >= ql are left unwritten (out of contract)
// An entry whose slot is outside [0, n_real) is invalid: best = -1,
// mgmax = -(1 << 29), no M rows written.
//
// What bounds it on the H100: integer work over B * nc_all * ql * wt_max
// cells: 23 instructions a cell, 7 of them 4-byte shared-memory loads a lane
// on the SM's 32 load lanes a clock, so about 7 clocks a warp-cell on the
// load pipe and as many on the two integer pipes.  The eval condition adds
// the M-row block of wq_max * B * (wt_max + 1) words, written once: about
// 98 MB a 32768-window chunk at the bench shapes, 0.03 ms at HBM3's rate.
//
// What the design does about it:
// - one thread per window, one block per (THREADS windows, condition); the
//   grid is (blocks of windows, conditions).  The eval condition runs as
//   its own instantiation (EVAL) in its own launch, so the screening
//   conditions carry neither the Mg row nor the M-row store.
// - the previous DP row lives in registers (dp_core.cuh RegRows): the
//   kernel is instantiated for the widths of FOR_REG_WIDTHS below and a
//   window of wt_max columns runs on the smallest width >= wt_max: 24 for
//   wt_max <= 24, 32 for wt_max 25..32 (oligos up to 24 nt: the panels of
//   tests/golden/e2e and the bench panel).  The row loop is a run-time loop
//   to min(ql, wq_max): the stream is slot-major, so a warp's ql is mostly
//   uniform.
// - wider windows (wt_max 33..MAX_WT, oligos of 25 to 1024 nt) run on the
//   strip path, the same cell code on registers too: a thread walks its
//   window in strips of STRIP columns (RegRows<STRIP>), every row of a
//   strip before the next strip.  Between strips it carries each row's last
//   column (clamped M, raw Iq, clamped It, raw Mg: what the next strip's
//   first column reads of the row to its left and, for the row below, of
//   the previous row) through a scratch of carry_words x wq_max planes of B
//   words in device memory, neighbouring lanes on neighbouring words; the
//   next row's carry is loaded while the current row runs.  A window's
//   first strip starts from the boundary column (0, 0, 0, NEG; iq from
//   NEG_I32, which max(., a) ignores), so the strips compute exactly what
//   one pass over the row does.  A warp stages its windows' ptb columns of
//   a strip and, on the eval condition, each strip of an M row in its own
//   buffer (odd pitch STRIP_PITCH) and stores the strip's columns of its
//   32 rows from there (runs of STRIP contiguous words; rows >= ql and
//   invalid entries unwritten), with no block barrier past the table load.
// - the condition's table sits in shared memory, loaded once a block with
//   16-byte coalesced reads, in the layout ops/screen_dp.py::kernel_tables
//   makes once per panel: the word at q * 225 + k * 32 + v of condition c
//   is -T_canon[c][v][q][k].  A warp mostly shares q and differs in
//   v = ptb[j], so the seven loads of a cell are conflict-free (equal v
//   broadcast); the odd stride between query pairs spreads the lanes of a
//   warp that mixes slots over the banks as well.
// - ptb (B, wt_max) row-major is loaded a block at a time, neighbouring
//   lanes on neighbouring words, into shared memory with an odd row stride;
//   each thread then packs its window's clamped values, times 4, four to a
//   register.
// - the eval condition stages each M row of a warp's 32 windows in shared
//   memory (odd stride: conflict-free) and stores the warp's contiguous
//   32 x (wt_max + 1) words 16 bytes a lane; a warp with a lane past its ql
//   or an invalid entry, an odd wt_max or a span off 16 bytes stores word by
//   word under a ballot, which keeps rows >= ql and invalid entries
//   unwritten.
// - no early exit past a barrier: a thread beyond B or with an invalid slot
//   stays with its block as an idle lane; a block with no valid entry at all
//   (the sorted tail of the stream) leaves before it loads anything.
//
// Build switches for timing one design step against the next
// (tools/dp_steps.py): -DDP_NO_DPX (plain max), -DDP_TABLE_GLOBAL (table
// read from global memory, same layout), -DDP_DIRECT_STORE (each thread
// stores its own M row); the three act on the register path.
//
// The host build (-DSCREEN_DP_HOST, tests/test_torch_screen_dp_host.py,
// g++ behind tests/cuda_host_shim/cuda_runtime.h) builds the strip path
// only: one host thread plays a block's warps one after another and a
// warp's 32 lanes phase by phase (the lane loops below, WARP_LANES), so the
// staging's index arithmetic and the carry planes run as on the card.

#include "dp_core.cuh"

#define DP_THREADS 128
// one condition's table: a row of 7 x 32 energies per query pair, one word
// of skew between rows (lanes that differ in q then differ in bank too),
// padded to 16 bytes; ops/screen_dp.py TAB_Q_WORDS, TAB_WORDS must agree
#define TAB_Q_WORDS (TAB_ROW_WORDS + 1)
#define TAB_WORDS ((NUM_PAIR * TAB_Q_WORDS + 3) / 4 * 4)
#define MAX_WT 1032     // oligos up to MAX_SEQUENCE_LENGTH 1024 nt + flanks

// register-path widths (ops/screen_dp.py REG_WIDTHS must agree)
#define FOR_REG_WIDTHS(X) X(24) X(32)

struct DpArgs {
    const int *ptb, *slot, *ql, *wt_e, *qp, *tab;
    int *best, *mgmax, *mrows;
    int* carry;     // the strip path's scratch (carry_words x wq_max x B)
    int B, wt_max, wq_max, nc_all, n_real;
    int c0;         // condition of blockIdx.y == 0
};

__device__ __forceinline__ int clamp_pair(int v) {
    return v < 0 ? 0 : (v >= NUM_PAIR ? NUM_PAIR - 1 : v);
}

// takes a row's raw M values: columns past the window's wt_max (a register
// width wider than the window) are dropped
struct RowSink {
    int* row;       // where column 0 of the DP goes (after the boundary)
    int wt;
    __device__ __forceinline__ void put(int j, int m) const {
        if (j < wt) row[j] = m;
    }
};

#ifndef SCREEN_DP_HOST
// registers a thread needs beside its rows and packed offsets (energies in
// flight, scalars): ptxas reports no spill with these
#define DP_REG_SLACK 48
#define DP_REG_SLACK_EVAL 72

// blocks an SM must hold, from the register budget a thread needs
__host__ __device__ constexpr int min_blocks(int wt, bool eval, int threads) {
    const int regs = (eval ? 4 : 3) * wt + wt / 4
        + (eval ? DP_REG_SLACK_EVAL : DP_REG_SLACK);
    const int n = 65536 / (threads * regs);
    return n < 1 ? 1 : n;
}

template <class Rows, bool EVAL, int THREADS>
__device__ __forceinline__ void screen_dp_block(const DpArgs& a)
{
    extern __shared__ __align__(16) int smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b0 = blockIdx.x * THREADS, b = b0 + tid;
    const int c = a.c0 + blockIdx.y;
    const bool last = c == a.nc_all - 1;
    const int s = b < a.B ? a.slot[b] : -1;
    const bool valid = s >= 0 && s < a.n_real;
    if (!__syncthreads_or(valid)) {         // nothing to do in this block
        if (b < a.B) {
            a.best[(size_t)c * a.B + b] = -1;
            if (last) a.mgmax[b] = NEG_I32;
        }
        return;
    }
    const int wt = a.wt_max, w1 = wt + 1;

    // shared memory: table | staging (ptb, then M rows)
    int* stage = smem + TAB_WORDS;
#ifdef DP_TABLE_GLOBAL
    const char* tab = (const char*)(a.tab + (size_t)c * TAB_WORDS);
#else
    {
        const int4* src = (const int4*)(a.tab + (size_t)c * TAB_WORDS);
        for (int i = tid; i < TAB_WORDS / 4; i += THREADS)
            ((int4*)smem)[i] = src[i];
    }
    const char* tab = (const char*)smem;
#endif

    static_assert(Rows::STATIC, "the register path keeps its rows in "
                                "registers");
    Rows rows;
    const int sst = w1 | 1;     // staging row stride, odd: conflict-free
    rows.init();

    // ptb: the block's windows are one contiguous span of nwin * wt words
    {
        const int* src = a.ptb + (size_t)b0 * wt;
        const int n = min(THREADS, a.B - b0) * wt;
        SpanIndex at(tid, wt);
        for (int i = tid; i < n; i += THREADS) {
            stage[at.row * (wt | 1) + at.col] = clamp_pair(src[i]) * 4;
            at.advance(THREADS, wt);
        }
    }
    __syncthreads();
    if (b < a.B) {
#pragma unroll
        for (int j = 0; j < Rows::WT; ++j)
            if (j < wt) rows.set_voff(j, stage[tid * (wt | 1) + j]);
    }
    __syncthreads();            // staging is reused for the M rows

    const int nrows = valid ? min(a.ql[b], a.wq_max) : 0;
    const int wte = valid ? min(a.wt_e[b], wt) : 0;
    const int* qrow = a.qp + (size_t)(valid ? s : 0) * a.wq_max;
    int bestv = -1, mgbest = NEG_I32;
    int q = nrows > 0 ? clamp_pair(__ldg(qrow)) : 0;

    if constexpr (EVAL) {
        // a warp walks its rows together: lanes past their ql idle
        const int rmax = __reduce_max_sync(0xffffffffu, nrows);
        const int bw0 = b0 + warp * 32;     // the warp's first window
#ifdef DP_DIRECT_STORE
        for (int r = 0; r < rmax; ++r) {
            if (r < nrows) {
                const TableEnergy en{tab + q * (TAB_Q_WORDS * 4)};
                if (r + 1 < nrows) q = clamp_pair(__ldg(qrow + r + 1));
                const RowSink out{
                    a.mrows + ((size_t)r * a.B + b) * w1 + 1, wt};
                out.row[-1] = -1;
                dp_row<true>(rows, en, out, wte, bestv, mgbest);
            }
        }
#else
        // the warp's staging buffer: 32 rows of sst words, column 0 of every
        // row the -1 boundary
        int* buf = stage + warp * 32 * sst;
        buf[lane * sst] = -1;
        __syncwarp();
        for (int r = 0; r < rmax; ++r) {
            const bool live = r < nrows;
            if (live) {
                const TableEnergy en{tab + q * (TAB_Q_WORDS * 4)};
                if (r + 1 < nrows) q = clamp_pair(__ldg(qrow + r + 1));
                const RowSink sink{buf + lane * sst + 1, wt};
                rows.keep_packed();
                dp_row<true>(rows, en, sink, wte, bestv, mgbest);
            }
            __syncwarp();
            // mrows[r][bw0 ..][0 .. wt] is one span of 32 * w1 words.  When
            // the staged rows are its image (sst == w1), every lane is live
            // and the span starts on 16 bytes, it is stored 16 bytes a lane;
            // else word by word, rows >= ql and invalid entries left out
            const unsigned act = __ballot_sync(0xffffffffu, live);
            const size_t e0 = ((size_t)r * a.B + bw0) * (size_t)w1;
            int* dst = a.mrows + e0;
            if (act == 0xffffffffu && sst == w1 && (e0 & 3) == 0) {
                for (int i = lane; i < 8 * w1; i += 32)
                    ((int4*)dst)[i] = ((const int4*)buf)[i];
            } else {
                SpanIndex at(lane, w1);
                for (int e = lane; e < 32 * w1; e += 32) {
                    if ((act >> at.row) & 1)
                        dst[e] = buf[at.row * sst + at.col];
                    at.advance(32, w1);
                }
            }
            __syncwarp();
        }
#endif
    } else {
        for (int r = 0; r < nrows; ++r) {
            const TableEnergy en{tab + q * (TAB_Q_WORDS * 4)};
            if (r + 1 < nrows) q = clamp_pair(__ldg(qrow + r + 1));
            dp_row<false>(rows, en, NoSink{}, wte, bestv, mgbest);
        }
    }
    if (b < a.B) {
        a.best[(size_t)c * a.B + b] = bestv;
        if (last) a.mgmax[b] = EVAL ? mgbest : NEG_I32;
    }
}

template <int WT, bool EVAL>
__global__ void
__launch_bounds__(DP_THREADS, min_blocks(WT, EVAL, DP_THREADS))
screen_dp_kernel(const DpArgs a)
{
    screen_dp_block<RegRows<WT, EVAL>, EVAL, DP_THREADS>(a);
}

// Launches `kernel` on (blocks of windows) x n_cond blocks.
template <class K>
static cudaError_t launch(K kernel, int (&opted)[MAX_DEVICES],
                          const DpArgs& a, int threads, int n_cond,
                          int smem_bytes, cudaStream_t stream)
{
    const cudaError_t err = allow_shared_memory(kernel, opted, smem_bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((a.B + threads - 1) / threads),
                    (unsigned)n_cond);
    kernel<<<grid, threads, smem_bytes, stream>>>(a);
    return cudaGetLastError();
}

template <int WT, bool EVAL>
static cudaError_t launch_reg(const DpArgs& a, int n_cond, cudaStream_t st)
{
    static int opted[MAX_DEVICES];
    const int bytes = (TAB_WORDS + DP_THREADS * ((a.wt_max + 1) | 1))
        * (int)sizeof(int);
    return launch(screen_dp_kernel<WT, EVAL>, opted, a, DP_THREADS, n_cond,
                  bytes, st);
}

#endif  // SCREEN_DP_HOST

// ---- the strip path: windows wider than the widest register width -------

#define STRIP 24                    // columns of a strip: RegRows<STRIP>
#define STRIP_PITCH (STRIP | 1)     // a lane's staging words, odd
#define STRIP_WARPS (DP_THREADS / 32)
// a warp's staging buffer, then the block's shared memory
#define STRIP_BUF_WORDS (32 * STRIP_PITCH)
#define STRIP_SMEM_WORDS (TAB_WORDS + STRIP_WARPS * STRIP_BUF_WORDS)
// registers beside the ones the register path needs at width STRIP: the
// carry in flight and the strip's bounds
#define STRIP_REG_SLACK 24

#ifdef SCREEN_DP_HOST
#define WARP_LANES 32       // the host thread plays every lane of a warp
#define LANE(i) (i)
#else
#define WARP_LANES 1        // a lane plays itself
#define LANE(i) ((int)(threadIdx.x & 31))
#endif

// words a window carries between strips for each row: clamped M, raw Iq,
// clamped It, and on the eval condition raw Mg
__host__ __device__ constexpr int carry_words(bool eval) {
    return eval ? 4 : 3;
}

__host__ __device__ constexpr int strip_min_blocks(bool eval) {
    const int regs = (eval ? 4 : 3) * STRIP + STRIP / 4 + STRIP_REG_SLACK
        + (eval ? 72 : 48);
    const int n = 65536 / (DP_THREADS * regs);
    return n < 1 ? 1 : n;
}

// What a lane of the strip path keeps across its strips.
struct StripLane {
    int nrows, wte, best, mgbest;
    const int* qrow;
};

// One row's carry: the strip's left neighbour column, or its last column.
struct Carry {
    int m, iq, it, mg;
};

// The warp of windows bw0 .. bw0 + 31 (those below B) on condition c:
// `tab` the condition's table in shared memory, `buf` the warp's staging
// buffer, `carry` the condition's carry planes (plane k of row r, window b
// at carry[(k * wq_max + r) * B + b]).
template <bool EVAL>
__device__ __forceinline__ void strip_warp(const DpArgs& a, const char* tab,
                                           int* buf, int* carry, int bw0,
                                           int c)
{
    const int wt = a.wt_max, w1 = wt + 1, B = a.B;
    const int nw = min(32, B - bw0);
    const size_t plane = (size_t)a.wq_max * B;
    StripLane ln[WARP_LANES];
    int rmax = 0;
    for (int i = 0; i < WARP_LANES; ++i) {
        const int b = bw0 + LANE(i);
        const int s = b < B ? a.slot[b] : -1;
        const bool valid = s >= 0 && s < a.n_real;
        ln[i].nrows = valid ? min(a.ql[b], a.wq_max) : 0;
        ln[i].wte = valid ? min(a.wt_e[b], wt) : 0;
        ln[i].best = -1;
        ln[i].mgbest = NEG_I32;
        ln[i].qrow = a.qp + (size_t)(valid ? s : 0) * a.wq_max;
        rmax = max(rmax, ln[i].nrows);
    }
    rmax = __reduce_max_sync(0xffffffffu, rmax);
    const int nstrip = (wt + STRIP - 1) / STRIP;
    for (int st = 0; st < nstrip && rmax > 0; ++st) {
        const int j0 = st * STRIP, ncol = min(STRIP, wt - j0);
        const bool first = st == 0, last = st == nstrip - 1;
        // the strip's ptb columns of the warp's windows, times 4
        for (int i = 0; i < WARP_LANES; ++i) {
            SpanIndex at(LANE(i), STRIP);
            for (int e = LANE(i); e < nw * STRIP; e += 32) {
                if (at.col < ncol)
                    buf[at.row * STRIP_PITCH + at.col] = 4 * clamp_pair(__ldg(
                        a.ptb + (size_t)(bw0 + at.row) * wt + j0 + at.col));
                at.advance(32, STRIP);
            }
        }
        __syncwarp();
        RegRows<STRIP, EVAL> rows[WARP_LANES];
        int q[WARP_LANES];
        Carry up[WARP_LANES], next[WARP_LANES];
        for (int i = 0; i < WARP_LANES; ++i) {
            const int lane = LANE(i);
            rows[i].init();
            if (lane < nw) {
#pragma unroll
                for (int j = 0; j < STRIP; ++j)
                    if (j < ncol)
                        rows[i].set_voff(j, buf[lane * STRIP_PITCH + j]);
            }
            q[i] = ln[i].nrows > 0 ? clamp_pair(__ldg(ln[i].qrow)) : 0;
            // the row above row 0: the boundary row, clamped -1 and NEG
            up[i] = Carry{0, 0, 0, NEG_I32};
            // row 0's left neighbour: the boundary column, or the carry
            next[i] = Carry{0, NEG_I32, 0, NEG_I32};
            if (!first && ln[i].nrows > 0) {
                const int* cr = carry + bw0 + lane;
                next[i] = Carry{cr[0], cr[plane], cr[2 * plane],
                                EVAL ? cr[3 * plane] : NEG_I32};
            }
        }
        __syncwarp();       // the buffer is free for the M rows
        for (int r = 0; r < rmax; ++r) {
            unsigned act = 0;
            for (int i = 0; i < WARP_LANES; ++i) {
                const int lane = LANE(i);
                StripLane& L = ln[i];
                if (r >= L.nrows) continue;
                act |= 1u << lane;
                const TableEnergy en{tab + q[i] * (TAB_Q_WORDS * 4)};
                if (r + 1 < L.nrows) q[i] = clamp_pair(__ldg(L.qrow + r + 1));
                const Carry left = next[i];
                int* cr = carry + (size_t)r * B + bw0 + lane;
                if (!first && r + 1 < L.nrows)      // the next row's, early
                    next[i] = Carry{cr[B], cr[plane + B], cr[2 * plane + B],
                                    EVAL ? cr[3 * plane + B] : NEG_I32};
                int cm = left.m, iq = left.iq;
                if (EVAL) {
                    const RowSink sink{buf + lane * STRIP_PITCH, ncol};
                    rows[i].keep_packed();
                    dp_row_strip<true>(rows[i], en, sink, L.wte - j0, L.best,
                                       L.mgbest, up[i].m, up[i].iq, up[i].it,
                                       up[i].mg, cm, iq);
                } else {
                    dp_row_strip<false>(rows[i], en, NoSink{}, L.wte - j0,
                                        L.best, L.mgbest, up[i].m, up[i].iq,
                                        up[i].it, up[i].mg, cm, iq);
                }
                // the next row's view of this row's left neighbour
                up[i] = Carry{left.m, max(left.iq, 0), left.it, left.mg};
                if (!last) {
                    cr[0] = cm;
                    cr[plane] = iq;
                    cr[2 * plane] = rows[i].it(STRIP - 1);
                    if (EVAL) cr[3 * plane] = rows[i].mg(STRIP - 1);
                }
            }
            if (!EVAL) continue;
            // the strip's columns of the warp's row r, from the buffer: runs
            // of ncol words at mrows[r][b][1 + j0 ..], the boundary -1 with
            // the first strip; rows >= ql and invalid entries left out
            act = __reduce_or_sync(0xffffffffu, act);
            __syncwarp();
            int* dst = a.mrows + ((size_t)r * B + bw0) * (size_t)w1;
            for (int i = 0; i < WARP_LANES; ++i) {
                const int lane = LANE(i);
                if (first && ((act >> lane) & 1))
                    dst[(size_t)lane * w1] = -1;
                SpanIndex at(lane, STRIP);
                for (int e = lane; e < 32 * STRIP; e += 32) {
                    if (((act >> at.row) & 1) && at.col < ncol)
                        dst[(size_t)at.row * w1 + 1 + j0 + at.col] =
                            buf[at.row * STRIP_PITCH + at.col];
                    at.advance(32, STRIP);
                }
            }
            __syncwarp();
        }
    }
    for (int i = 0; i < WARP_LANES; ++i) {
        const int b = bw0 + LANE(i);
        if (b >= B) continue;
        a.best[(size_t)c * B + b] = ln[i].best;
        if (c == a.nc_all - 1) a.mgmax[b] = EVAL ? ln[i].mgbest : NEG_I32;
    }
}

// Whether window b is valid.
__device__ __forceinline__ bool window_valid(const DpArgs& a, int b)
{
    const int s = b < a.B ? a.slot[b] : -1;
    return s >= 0 && s < a.n_real;
}

#ifdef SCREEN_DP_HOST
// the CPU tests' build: every (block, condition) in turn, a block's warps
// one after another
template <bool EVAL>
static cudaError_t launch_strip(const DpArgs& a, int n_cond, cudaStream_t st)
{
    (void)st;
    int* smem = (int*)aligned_alloc(16, STRIP_SMEM_WORDS * sizeof(int));
    for (int cy = 0; cy < n_cond; ++cy) {
        const int c = a.c0 + cy;
        int* carry = a.carry + (size_t)cy * carry_words(EVAL) * a.wq_max * a.B;
        std::memcpy(smem, a.tab + (size_t)c * TAB_WORDS,
                    TAB_WORDS * sizeof(int));
        for (int b0 = 0; b0 < a.B; b0 += DP_THREADS)
            for (int w = 0; w < STRIP_WARPS && b0 + 32 * w < a.B; ++w)
                strip_warp<EVAL>(a, (const char*)smem,
                                 smem + TAB_WORDS + w * STRIP_BUF_WORDS,
                                 carry, b0 + 32 * w, c);
    }
    free(smem);
    return cudaSuccess;
}
#else
// A block: DP_THREADS windows on one condition.  A block with no valid
// window (the sorted tail of the stream) writes its scores and leaves
// before it loads anything; else the table is loaded once and each warp
// runs on its own.
template <bool EVAL>
__global__ void __launch_bounds__(DP_THREADS, strip_min_blocks(EVAL))
screen_dp_strip_kernel(const DpArgs a)
{
    extern __shared__ __align__(16) int smem[];
    const int tid = threadIdx.x, warp = tid >> 5;
    const int b0 = blockIdx.x * DP_THREADS, b = b0 + tid;
    const int c = a.c0 + blockIdx.y;
    if (!__syncthreads_or(window_valid(a, b))) {
        if (b < a.B) {
            a.best[(size_t)c * a.B + b] = -1;
            if (c == a.nc_all - 1) a.mgmax[b] = NEG_I32;
        }
        return;
    }
    {
        const int4* src = (const int4*)(a.tab + (size_t)c * TAB_WORDS);
        for (int i = tid; i < TAB_WORDS / 4; i += DP_THREADS)
            ((int4*)smem)[i] = src[i];
    }
    __syncthreads();
    const int bw0 = b0 + 32 * warp;
    if (bw0 >= a.B) return;
    int* carry = a.carry
        + (size_t)blockIdx.y * carry_words(EVAL) * a.wq_max * a.B;
    strip_warp<EVAL>(a, (const char*)smem,
                     smem + TAB_WORDS + warp * STRIP_BUF_WORDS, carry, bw0,
                     c);
}

template <bool EVAL>
static cudaError_t launch_strip(const DpArgs& a, int n_cond, cudaStream_t st)
{
    static int opted[MAX_DEVICES];
    return launch(screen_dp_strip_kernel<EVAL>, opted, a, DP_THREADS, n_cond,
                  STRIP_SMEM_WORDS * (int)sizeof(int), st);
}
#endif

// int32 words of carry scratch a call takes on the strip path: the
// conditions of its larger launch, carry_words planes of wq_max x B each
// (the launches run one after the other on one stream).
extern "C" long long screen_dp_carry_words(int B, int wq_max, int nc_all,
                                           int eval_on)
{
    const int n_screen = eval_on ? nc_all - 1 : nc_all;
    const long long per = (long long)wq_max * B;
    const long long ev = eval_on ? carry_words(true) * per : 0;
    const long long sc = (long long)n_screen * carry_words(false) * per;
    return ev > sc ? ev : sc;
}

// One group of conditions [c0, c0 + n_cond) on the path `width` names: a
// register width of FOR_REG_WIDTHS, or 0 for the strip path.
template <bool EVAL>
static cudaError_t launch_group(DpArgs a, int c0, int n_cond, int width,
                                cudaStream_t st)
{
    a.c0 = c0;
    if (width != 0 && width < a.wt_max) return cudaErrorInvalidValue;
    switch (width) {
    case 0:
        if (a.carry == nullptr) return cudaErrorInvalidValue;
        return launch_strip<EVAL>(a, n_cond, st);
#ifndef SCREEN_DP_HOST
#define REG_CASE(W) case W: return launch_reg<W, EVAL>(a, n_cond, st);
    FOR_REG_WIDTHS(REG_CASE)
#undef REG_CASE
#endif
    default: return cudaErrorInvalidValue;
    }
}

// tab is the kernel_tables() layout of tcan; width is the register width
// the caller picked for wt_max (0: the strip path, which takes `carry`,
// screen_dp_carry_words() int32 words of scratch, any values; elsewhere it
// may be null).  The launches go to card `device` (made current for them
// and restored) on `stream`.
extern "C" int screen_dp_launch(
    const void* ptb, const void* slot, const void* ql, const void* wt_e,
    const void* qp, const void* tab, void* best, void* mgmax, void* mrows,
    void* carry, int B, int wt_max, int wq_max, int nc_all, int n_real,
    int eval_on, int width, int device, void* stream)
{
    if (B <= 0 || nc_all <= 0) return 0;
    if (wt_max > MAX_WT || wt_max <= 0 || wq_max <= 0)
        return (int)cudaErrorInvalidValue;
    if (eval_on && mrows == nullptr) return (int)cudaErrorInvalidValue;
    const DpArgs a{(const int*)ptb, (const int*)slot, (const int*)ql,
                   (const int*)wt_e, (const int*)qp, (const int*)tab,
                   (int*)best, (int*)mgmax, (int*)mrows, (int*)carry,
                   B, wt_max, wq_max, nc_all, n_real, 0};
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
    const int n_screen = eval_on ? nc_all - 1 : nc_all;
    // the eval condition first: its blocks are the long ones
    if (eval_on) err = launch_group<true>(a, nc_all - 1, 1, width, st);
    if (err == cudaSuccess && n_screen > 0)
        err = launch_group<false>(a, 0, n_screen, width, st);
    if (cur != device) {
        const cudaError_t back = cudaSetDevice(cur);
        if (err == cudaSuccess) err = back;
    }
    return (int)err;
}
