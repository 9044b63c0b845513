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
//   tests/golden/e2e and the bench panel).  Wider windows (wt_max 33..128)
//   run the same cell code with rows in shared memory (SmemRows,
//   WIDE_THREADS threads a block), every condition alike.  The row loop is
//   a run-time loop to min(ql, wq_max): the stream is slot-major, so a
//   warp's ql is mostly uniform.
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
// stores its own M row).

#include "dp_core.cuh"

#define DP_THREADS 128
#define WIDE_THREADS 64
// one condition's table: a row of 7 x 32 energies per query pair, one word
// of skew between rows (lanes that differ in q then differ in bank too),
// padded to 16 bytes; ops/screen_dp.py TAB_Q_WORDS, TAB_WORDS must agree
#define TAB_Q_WORDS (TAB_ROW_WORDS + 1)
#define TAB_WORDS ((NUM_PAIR * TAB_Q_WORDS + 3) / 4 * 4)
#define MAX_WT 128

// register-path widths (ops/screen_dp.py REG_WIDTHS must agree)
#define FOR_REG_WIDTHS(X) X(24) X(32)

struct DpArgs {
    const int *ptb, *slot, *ql, *wt_e, *qp, *tab;
    int *best, *mgmax, *mrows;
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

    // shared memory: table | staging (ptb, then M rows) | SmemRows planes
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

    Rows rows;
    const int sst = w1 | 1;     // staging row stride, odd: conflict-free
    int* planes = stage + THREADS * sst;       // SmemRows only
    if constexpr (!Rows::STATIC) {
        rows.base = planes + tid;
        rows.wt = wt;
        rows.pitch = THREADS;
    }
    rows.init();

    // ptb: the block's windows are one contiguous span of nwin * wt words
    {
        const int* src = a.ptb + (size_t)b0 * wt;
        const int n = min(THREADS, a.B - b0) * wt;
        SpanIndex at(tid, wt);
        for (int i = tid; i < n; i += THREADS) {
            const int v = clamp_pair(src[i]) * 4;
            if constexpr (Rows::STATIC)
                stage[at.row * (wt | 1) + at.col] = v;
            else
                planes[at.col * THREADS + at.row] = v;   // plane 0
            at.advance(THREADS, wt);
        }
    }
    __syncthreads();
    if constexpr (Rows::STATIC) {
        if (b < a.B) {
#pragma unroll
            for (int j = 0; j < Rows::WT; ++j)
                if (j < wt) rows.set_voff(j, stage[tid * (wt | 1) + j]);
        }
        __syncthreads();        // staging is reused for the M rows
    }

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

template <bool EVAL>
__global__ void __launch_bounds__(WIDE_THREADS)
screen_dp_wide_kernel(const DpArgs a)
{
    screen_dp_block<SmemRows<EVAL>, EVAL, WIDE_THREADS>(a);
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

template <bool EVAL>
static cudaError_t launch_wide(const DpArgs& a, int n_cond, cudaStream_t st)
{
    static int opted[MAX_DEVICES];
    const int bytes =
        (TAB_WORDS + WIDE_THREADS * ((a.wt_max + 1) | 1)
         + SmemRows<EVAL>::words(a.wt_max, WIDE_THREADS)) * (int)sizeof(int);
    return launch(screen_dp_wide_kernel<EVAL>, opted, a, WIDE_THREADS,
                  n_cond, bytes, st);
}

// One group of conditions [c0, c0 + n_cond) on the path `width` names: a
// register width of FOR_REG_WIDTHS, or 0 for rows in shared memory.
template <bool EVAL>
static cudaError_t launch_group(DpArgs a, int c0, int n_cond, int width,
                                cudaStream_t st)
{
    a.c0 = c0;
    if (width != 0 && width < a.wt_max) return cudaErrorInvalidValue;
    switch (width) {
    case 0: return launch_wide<EVAL>(a, n_cond, st);
#define REG_CASE(W) case W: return launch_reg<W, EVAL>(a, n_cond, st);
    FOR_REG_WIDTHS(REG_CASE)
#undef REG_CASE
    default: return cudaErrorInvalidValue;
    }
}

// tab is the kernel_tables() layout of tcan; width is the register width
// the caller picked for wt_max (0: rows in shared memory).  The launches go
// to card `device` (made current for them and restored) on `stream`.
extern "C" int screen_dp_launch(
    const void* ptb, const void* slot, const void* ql, const void* wt_e,
    const void* qp, const void* tab, void* best, void* mgmax, void* mrows,
    int B, int wt_max, int wq_max, int nc_all, int n_real, int eval_on,
    int width, int device, void* stream)
{
    if (B <= 0 || nc_all <= 0) return 0;
    if (wt_max > MAX_WT || wt_max <= 0 || wq_max <= 0)
        return (int)cudaErrorInvalidValue;
    if (eval_on && mrows == nullptr) return (int)cudaErrorInvalidValue;
    const DpArgs a{(const int*)ptb, (const int*)slot, (const int*)ql,
                   (const int*)wt_e, (const int*)qp, (const int*)tab,
                   (int*)best, (int*)mgmax, (int*)mrows,
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
