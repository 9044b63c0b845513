// Probe of the screening DP's recurrence, designed for the Hopper SM
// (sm_90a).
//
// Replaces the TPU kernel tools/tpu_pallas_probe2.py::mk_kernel: the DP of
// csrc/screen_dp.cu with SYNTHETIC energies, so that the time of the energy
// reads can be told apart from the time of the recurrence.  It runs that
// kernel's cell code (dp_core.cuh: dp_row over RegRows, or over ProbeRows
// below), not a
// copy of it.  Three variants, chosen by n_sel:
//   n_sel = 0   const_energy: all seven energies of every cell are 1234;
//               neither ptb nor any table is read
//   n_sel = 5   sel5:  energy k of a cell whose ptb value is v is
//               (v * 7919 + k * 31) % 60000 - 30000 if v < n_sel, else 0
//   n_sel = 30  sel30: the same with all 30 values live
// (k = 0..6 for mm, mq, mt, qi, qe, ti, te).  The two table variants run the
// same code on one 7 x 32 row of negated energies in shared memory, the
// layout of one query-pair row of screen_dp's table (values 30 and 31 are
// the zero row of out-of-range ptb), and differ only in how many of its
// values are non-zero; const_energy differs from them only in not reading
// ptb and the table.
//
// Layout (the TPU probe's): meta (n_blocks, 4) int32 = [_, ql, wt_e, _];
// ptb (n_blocks, wt_max, BB) int32, window w of block b at ptb[b][j][w];
// best (n_blocks, nc_all, BB) int32.  Per window and condition c:
//   best[b][c][w] = max of M over rows r < ql and columns j < wt_e, floor -1.
// All three state planes start at -1 in every column and the column left of
// the first is -1 too; every one of the wq_max rows is computed, rows
// r >= ql only do not update best; the nc_all conditions compute the same
// values (the energies do not depend on c) and each is written.  Where
// screen_dp clamps an out-of-range ptb value, the probe reads the zero row.
//
// What bounds it on the H100: integer work over
// n_blocks * BB * nc_all * wq_max * wt_max cells: 21.5 instructions a cell,
// 7 of them shared-memory loads, which at 32 load lanes an SM a clock is 7
// clocks a warp-cell (const_energy: 13 integer instructions and no load);
// the bytes (ptb once, best once) are three orders of magnitude below that.
//
// Design: one thread per (window, condition), the previous row in registers
// for wt_max up to the widest of FOR_REG_WIDTHS (a window runs on the
// smallest width >= wt_max), in shared memory beyond (ProbeRows, wt_max
// 33..PROBE_MAX_WT, WIDE_THREADS threads a block).  screen_dp.cu runs its
// wider windows in strips of registers with a carry in device memory; the
// probe keeps its rows in shared memory, which needs no scratch, and so
// stays at 128 columns (4 planes of 128 columns x 64 threads): it times
// the recurrence at the TPU probe's widths, not the search's.  Two blocks an SM: ptxas then spills
// nothing, and three were no faster.  ptb is column-major per block, so a
// warp's 32 windows read 32 neighbouring words; each thread packs its column
// values, times 4, four to a register.  The I_query prefix recurrence
// iq[j] = max(a[j], iq[j-1] - e4[j]) runs sequentially along the row (equal
// to the TPU kernel's prefix-sum / prefix-max form exactly in int32:
// magnitudes stay under 2^21).

#include "dp_core.cuh"

#define THREADS 128
#define WIDE_THREADS 64
#define PROBE_MAX_WT 128    // ops/screen_probe.py PROBE_MAX_WT
#define CONST_ENERGY 1234

// register-path widths (ops/screen_dp.py REG_WIDTHS must agree)
#define FOR_REG_WIDTHS(X) X(24) X(32)

// Any width: the rows and the offsets in shared memory, laid out
// [plane][column][thread] (conflict-free), columns a run-time loop.
struct ProbeRows {
    static constexpr bool STATIC = false;
    static constexpr int PLANES = 4;    // voff, cM, cIq, cIt
    int* base;      // this thread's word of column 0 of plane 0
    int wt;         // columns
    int pitch;      // words between columns (the block's thread count)

    // shared-memory words a block of `threads` threads needs
    __host__ __device__ static int words(int wt, int threads) {
        return PLANES * wt * threads;
    }
    __device__ __forceinline__ int* at(int plane, int j) const {
        return base + (plane * wt + j) * pitch;
    }
    __device__ __forceinline__ void init() {
        for (int j = 0; j < wt; ++j) {
            *at(1, j) = 0; *at(2, j) = 0; *at(3, j) = 0;
        }
    }
    __device__ __forceinline__ int ncols() const { return wt; }
    __device__ __forceinline__ void set_voff(int j, int v) { *at(0, j) = v; }
    __device__ __forceinline__ int voff(int j) const { return *at(0, j); }
    __device__ __forceinline__ int m(int j) const { return *at(1, j); }
    __device__ __forceinline__ int iq(int j) const { return *at(2, j); }
    __device__ __forceinline__ int it(int j) const { return *at(3, j); }
    __device__ __forceinline__ int mg(int) const { return NEG_I32; }
    __device__ __forceinline__ void set(int j, int m_, int iq_, int it_) {
        *at(1, j) = m_; *at(2, j) = iq_; *at(3, j) = it_;
    }
    __device__ __forceinline__ void set_mg(int, int) {}
};

struct ProbeArgs {
    const int *meta, *ptb;
    int* best;
    int n_blocks, BB, wt_max, wq_max, nc_all, n_sel;
};

// byte offset of pair value v in the table row; out of range: the zero row
__device__ __forceinline__ int probe_voff(int v) {
    return ((v < 0 || v >= NUM_PAIR) ? NUM_PAIR : v) * 4;
}

template <class Rows, bool TABLE, int NTHREADS>
__device__ __forceinline__ void screen_probe_block(const ProbeArgs& a)
{
    __shared__ int tab[TAB_ROW_WORDS];
    extern __shared__ __align__(16) int planes[];       // ProbeRows only
    if (TABLE) {
        for (int i = threadIdx.x; i < TAB_ROW_WORDS; i += NTHREADS) {
            const int k = i / TAB_K_WORDS, v = i % TAB_K_WORDS;
            tab[i] = (v < a.n_sel && v < NUM_PAIR)
                ? -((v * 7919 + k * 31) % 60000 - 30000) : 0;
        }
        __syncthreads();
    }
    const long long tid = (long long)blockIdx.x * NTHREADS + threadIdx.x;
    if (tid >= (long long)a.n_blocks * a.nc_all * a.BB) return;
    // best is (n_blocks, nc_all, BB): tid is the output index
    const int w = (int)(tid % a.BB);
    const int b = (int)(tid / ((long long)a.BB * a.nc_all));
    const int nrows = a.meta[b * 4 + 1];
    const int wte = min(a.meta[b * 4 + 2], a.wt_max);

    Rows rows;
    if constexpr (!Rows::STATIC) {
        rows.base = planes + threadIdx.x;
        rows.wt = a.wt_max;
        rows.pitch = NTHREADS;
    }
    rows.init();
    if (TABLE) {
        const int* pt = a.ptb + (long long)b * a.wt_max * a.BB + w;
        if constexpr (Rows::STATIC) {
#pragma unroll
            for (int j = 0; j < Rows::WT; ++j)
                if (j < a.wt_max)
                    rows.set_voff(j, probe_voff(pt[(long long)j * a.BB]));
        } else {
            for (int j = 0; j < a.wt_max; ++j)
                rows.set_voff(j, probe_voff(pt[(long long)j * a.BB]));
        }
    }

    int bestv = -1, unused = NEG_I32;
    for (int r = 0; r < a.wq_max; ++r) {
        const int wte_r = r < nrows ? wte : 0;      // rows >= ql score nothing
        if (TABLE)
            dp_row<false>(rows, TableEnergy{(const char*)tab}, NoSink{},
                          wte_r, bestv, unused);
        else
            dp_row<false>(rows, ConstEnergy<CONST_ENERGY>{}, NoSink{},
                          wte_r, bestv, unused);
    }
    a.best[tid] = bestv;
}

template <int WT, bool TABLE>
__global__ void __launch_bounds__(THREADS, 2)
screen_probe_kernel(const ProbeArgs a)
{
    screen_probe_block<RegRows<WT, false>, TABLE, THREADS>(a);
}

template <bool TABLE>
__global__ void __launch_bounds__(WIDE_THREADS)
screen_probe_wide_kernel(const ProbeArgs a)
{
    screen_probe_block<ProbeRows, TABLE, WIDE_THREADS>(a);
}

template <bool TABLE>
static cudaError_t launch_wide(const ProbeArgs& a, unsigned long long n,
                               cudaStream_t st)
{
    static int opted[MAX_DEVICES];
    const int bytes =
        ProbeRows::words(a.wt_max, WIDE_THREADS) * (int)sizeof(int);
    const cudaError_t err =
        allow_shared_memory(screen_probe_wide_kernel<TABLE>, opted, bytes);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)((n + WIDE_THREADS - 1) / WIDE_THREADS);
    screen_probe_wide_kernel<TABLE><<<grid, WIDE_THREADS, bytes, st>>>(a);
    return cudaGetLastError();
}

template <bool TABLE>
static cudaError_t launch_width(const ProbeArgs& a, int width,
                                cudaStream_t st)
{
    const unsigned long long n =
        (unsigned long long)a.n_blocks * a.nc_all * a.BB;
    const unsigned grid = (unsigned)((n + THREADS - 1) / THREADS);
    switch (width) {
    case 0: return launch_wide<TABLE>(a, n, st);
#define REG_CASE(W)                                                  \
    case W:                                                          \
        screen_probe_kernel<W, TABLE><<<grid, THREADS, 0, st>>>(a);  \
        return cudaGetLastError();
    FOR_REG_WIDTHS(REG_CASE)
#undef REG_CASE
    default: return cudaErrorInvalidValue;
    }
}

// width is the register width the caller picked for wt_max (0: rows in
// shared memory).
extern "C" int screen_probe_launch(
    const void* meta, const void* ptb, void* best, int n_blocks, int BB,
    int wt_max, int wq_max, int nc_all, int n_sel, int width, void* stream)
{
    if (n_blocks <= 0 || BB <= 0 || nc_all <= 0) return 0;
    if (wt_max > PROBE_MAX_WT || wt_max <= 0 || wq_max <= 0 || n_sel < 0
            || (width != 0 && width < wt_max))
        return (int)cudaErrorInvalidValue;
    const ProbeArgs a{(const int*)meta, (const int*)ptb, (int*)best,
                      n_blocks, BB, wt_max, wq_max, nc_all, n_sel};
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(n_sel > 0 ? launch_width<true>(a, width, st)
                           : launch_width<false>(a, width, st));
}
