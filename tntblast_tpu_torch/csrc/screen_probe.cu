// Probe of the screening DP's recurrence, written for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/tpu_pallas_probe2.py::mk_kernel: the DP
// skeleton of csrc/screen_dp.cu with SYNTHETIC energies, so that the time of
// the energy reads can be told apart from the time of the recurrence.  Three
// variants, chosen by n_sel:
//   n_sel = 0   const_energy: all seven energies of every cell are 1234;
//               neither ptb nor any table is read
//   n_sel = 5   sel5:  energy k of a cell whose ptb value is v is
//               (v * 7919 + k * 31) % 60000 - 30000 if v < n_sel, else 0
//   n_sel = 30  sel30: the same with all 30 values live
// (k = 0..6 for mm, mq, mt, qi, qe, ti, te).  The two table variants run the
// same code on the same 31 x 7 table in shared memory (row 30 is the zero row
// of out-of-range values) and differ only in how many of its rows are
// non-zero; const_energy differs from them only in not reading ptb and the
// table.
//
// Layout (the TPU probe's): meta (n_blocks, 4) int32 = [_, ql, wt_e, _];
// ptb (n_blocks, wt_max, BB) int32, window w of block b at ptb[b][j][w];
// best (n_blocks, nc_all, BB) int32.  Per window and condition c:
//   best[b][c][w] = max of M over rows r < ql and columns j < wt_e, floor -1.
// All three state planes start at -1 in every column and the column left of
// the first is -1 too; every one of the wq_max rows is computed, rows
// r >= ql only do not update best; the nc_all conditions compute the same
// values (the energies do not depend on c) and each is written.
//
// What bounds it on the H100: int32 ALU work over
// n_blocks * BB * nc_all * wq_max * wt_max cells (the same recurrence as
// screen_dp.cu without the gapped-best channel and the M-row store); the
// bytes (ptb once, best once) are three orders of magnitude below that.
//
// Design: that of screen_dp.cu on purpose, so that the probe's times say
// something about that kernel: one thread per (window, condition), the
// previous row in per-thread local memory, rows outer and columns inner, the
// I_query prefix recurrence iq[j] = max(a[j], iq[j-1] - e4[j]) run
// sequentially (equal to the TPU kernel's prefix-sum / prefix-max form
// exactly in int32: magnitudes stay under 2^21).  ptb is stored column-major
// per block, so a warp's 32 windows read 32 neighbouring words.

#include <cuda_runtime.h>
#include <stdint.h>

// columns (wt_max + 1) a thread can hold; the wrapper refuses wider windows
#define MAX_WT1 129
#define NUM_PAIR 30
#define THREADS 128

__device__ __forceinline__ int relu(int x) { return x > 0 ? x : 0; }

template <bool TABLE>
__global__ void __launch_bounds__(THREADS)
screen_probe_kernel(const int* __restrict__ meta, const int* __restrict__ ptb,
                    int* __restrict__ best, int n_blocks, int BB, int wt_max,
                    int wq_max, int nc_all, int n_sel)
{
    __shared__ int tab[(NUM_PAIR + 1) * 7];
    if (TABLE) {
        for (int i = threadIdx.x; i < (NUM_PAIR + 1) * 7; i += blockDim.x) {
            const int v = i / 7, k = i - v * 7;
            tab[i] = (v < n_sel && v < NUM_PAIR)
                ? (v * 7919 + k * 31) % 60000 - 30000 : 0;
        }
        __syncthreads();
    }
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tid >= (long long)n_blocks * nc_all * BB) return;
    // best is (n_blocks, nc_all, BB): tid is the output index
    const int w = (int)(tid % BB);
    const int b = (int)(tid / ((long long)BB * nc_all));
    const int nrows = meta[b * 4 + 1];
    const int wte = meta[b * 4 + 2];
    const int* __restrict__ pt = ptb + (long long)b * wt_max * BB + w;

    // previous DP row; column 0 is the -1 boundary
    int M[MAX_WT1], Iq[MAX_WT1], It[MAX_WT1];
    for (int j = 0; j <= wt_max; ++j) { M[j] = -1; Iq[j] = -1; It[j] = -1; }
    int bestv = -1;

    for (int r = 0; r < wq_max; ++r) {
        const bool row_ok = r < nrows;
        int dM = M[0], dIq = Iq[0], dIt = It[0];
        int mleft = -1, iqleft = 0;
        for (int j = 1; j <= wt_max; ++j) {
            int e0, e1, e2, e3, e4, e5, e6;
            if (TABLE) {
                const int v = __ldg(pt + (long long)(j - 1) * BB);
                const int* e =
                    tab + ((v < 0 || v >= NUM_PAIR) ? NUM_PAIR : v) * 7;
                e0 = e[0]; e1 = e[1]; e2 = e[2]; e3 = e[3];
                e4 = e[4]; e5 = e[5]; e6 = e[6];
            } else {
                e0 = e1 = e2 = e3 = e4 = e5 = e6 = 1234;
            }
            const int uM = M[j], uIq = Iq[j], uIt = It[j];
            const int m = max(max(relu(dM) - e0, relu(dIq) - e1),
                              relu(dIt) - e2);
            const int it = max(relu(uM) - e5, relu(uIt) - e6);
            const int a = max(relu(mleft) - e3, -e4);
            const int iq = (j == 1) ? a : max(a, iqleft - e4);
            dM = uM; dIq = uIq; dIt = uIt;
            M[j] = m; Iq[j] = iq; It[j] = it;
            mleft = m; iqleft = iq;
            if (row_ok && (j - 1) < wte) bestv = max(bestv, m);
        }
    }
    best[tid] = bestv;
}

extern "C" int screen_probe_launch(
    const void* meta, const void* ptb, void* best, int n_blocks, int BB,
    int wt_max, int wq_max, int nc_all, int n_sel, void* stream)
{
    if (n_blocks <= 0 || BB <= 0 || nc_all <= 0) return 0;
    if (wt_max + 1 > MAX_WT1 || wt_max <= 0 || wq_max <= 0 || n_sel < 0)
        return (int)cudaErrorInvalidValue;
    const long long n = (long long)n_blocks * nc_all * BB;
    const unsigned grid = (unsigned)((n + THREADS - 1) / THREADS);
    if (n_sel > 0)
        screen_probe_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const int*)meta, (const int*)ptb, (int*)best, n_blocks, BB,
            wt_max, wq_max, nc_all, n_sel);
    else
        screen_probe_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const int*)meta, (const int*)ptb, (int*)best, n_blocks, BB,
            wt_max, wq_max, nc_all, n_sel);
    return (int)cudaGetLastError();
}
