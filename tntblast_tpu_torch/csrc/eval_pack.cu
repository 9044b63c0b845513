// The evaluation stage of the device seed+screen step, as one kernel for the
// Hopper SM (sm_90a): trust decision, exact gapless evaluation and word
// packing of every entry of a chunk, from the M rows screen_dp.cu has just
// written to the five int32 words the host resolve reads.
//
// Replaces no Pallas kernel.  In the JAX package this stage is
// tntblast_tpu/ops/eval_gapless_jax.py::eval_flat followed by pack_eval
// (tntblast_tpu/parallel/device_search.py), fused by XLA inside the jitted
// step into a handful of device kernels.  The plain PyTorch version beside
// this kernel (ops/eval_pack.py::eval_pack_reference, eager tensor code) is
// some hundreds of small launches a chunk; on this card the counterpart of
// the jitted program is this kernel.  It computes what eval_flat computes
// and is not carried over op by op: eval_flat holds every per-row quantity
// as a (B, wq_max) array and reduces it; here one thread owns one entry and
// walks it, and nothing but the entry's five words leaves the thread.
//
// Per entry b (ql rows, wt_e columns, slot s), exactly eval_flat + pack_eval:
//   1. the best cell of the masked M block (rows r < ql, columns j <= wt_e of
//      mrows[r][b][:]; every other cell counts as -1 and is never read, since
//      screen_dp leaves it unwritten): the maximum, the FIRST row-major index
//      that holds it, and how many cells hold it;
//   2. the walk down the best cell's diagonal (M values at row ql-1-qi,
//      column A-qi+1), which stops at the first negative value: the visited
//      range, and whether a visited value is zero; with mgmax this gives
//      `trusted`;
//   3. the query/target pairs along the diagonal (tq[qi] = tb5[b][A - qi]),
//      the frayed-end trim [lo, hi] to the first and last complementary
//      visited pair, and the two anchors;
//   4. dH/dS in f32 in the order of eval_flat: init, the 5' AT closing, per
//      row qi = 0..wq_max-1 eleven adds and subtractions (stack, loop
//      entropy, loop terminals against the saved first-mismatch stack), the
//      3' AT closing.  A term that is masked out is added as +0.0f, as
//      torch.where(mask, x, 0) adds it: every add is unconditional and only
//      its operand is selected, so not one rounding or sign of zero differs.
//      There are no products; the file is built with -fmad=false and without
//      fast math all the same;
//   5. the words: w0 = trusted | tm_zero << 1 | num_base << 2 | mm << 10 |
//      align_len << 16 (clamped to 8, 6 and 6 bits), w1 = fm_q | fm_t << 8 |
//      lm_q << 16 | lm_t << 24 (each & 0xFF, so the top byte may set the sign
//      bit), w2 = anchor5 | anchor3 << 8, w3/w4 the bits of dH/dS.  `trusted`
//      is cleared by needs_host.
// An entry with ent_valid false (the tail of the pooled stream, every entry
// of a chunk past the pool) writes five zeros and leaves at once, as the
// skipped chunks of the jitted step do; the plain version writes the same.
// Every gather eval_flat clamps is clamped here (JAX gathers clamp, a pointer
// does not): the column of the diagonal, the index into tb5, the pair codes
// 0..4, the loop length into the slot's loop table, lo and hi.
//
// What bounds it on the H100: bytes.  The M block of a 32768-entry chunk at
// the bench shapes (24 rows, 33 columns) is 97.7 MB, read once: 0.03 ms at
// HBM3's rate; the scan is a compare and a select a cell.
//
// What the design does about it, and what it leaves: one thread an entry,
// 128 threads a block, no shared memory, no barrier; all loops are run-time
// loops over ql / wq_max with scalar state, so ONE general path takes any
// width (no per-width instantiation, no local array, registers few enough
// for full occupancy).  A thread reads its row's wt_e + 1 words in order:
// a warp's 32 rows are one contiguous span, every sector of it is used, but
// one load instruction touches 32 lines (the row pitch, 132 bytes at the
// bench shapes, is more than a line), so the reads count on L1 to serve a
// line to the seven or eight loads that follow.  A warp-cooperative copy of
// the span through shared memory would make each instruction one line.

#include <cuda_runtime.h>
#include <stdint.h>

#define EVAL_THREADS 128

struct EvalArgs {
    const int *mrows, *mgmax, *tb5, *slot, *ql, *wt_e;
    const uint8_t *needs_host, *ent_valid;
    const int* qc;          // (n_q, wq_max) query codes per slot
    const float4* ev_tabs;  // (n_slots, wq_max, 25) of (Hstk, Sstk, Hlt, Slt)
    const float* ev_loop;   // (n_slots, wq_max + 2) loop entropies
    int* out;               // (B, 5)
    int B, wq_max, wt_max, n_q, n_slots;
    float AT_H, AT_S, init_H, init_S;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// the running maximum of a row-major scan: its value, the first index that
// holds it, and the number of cells that hold it
struct Best {
    int v, first, count;
    // `n` cells of value `x` from flat index `at` on
    __device__ __forceinline__ void feed(int x, int at, int n) {
        if (x > v) { v = x; first = at; count = n; }
        else if (x == v) count += n;
    }
};

// the diagonal of alignment A in the masked M block, by query index
struct Diagonal {
    const int* m;           // mrows + b * w1
    size_t pitch;           // words from row r to row r + 1
    int ql, ncol, A;        // rows, columns in contract
    // eval_flat's Mdiag[qi]: the cell of row ql-1-qi at column A-qi+1, -1
    // where the column falls outside the block or the contract
    __device__ __forceinline__ int at(int qi) const {
        const int j = A - qi + 1;
        if (qi >= ql || j < 0 || j >= ncol) return -1;
        return __ldg(m + (size_t)(ql - 1 - qi) * pitch + j);
    }
};

// the pair at query index qi of the diagonal: tq (5 outside the window) and
// whether it is complementary
struct Pairs {
    const int *q, *t;       // the slot's query codes, the entry's tb5 row
    int ql, wt_e, wt_max, A;
    __device__ __forceinline__ bool ti_ok(int qi) const {
        const int ti = A - qi;
        return ti >= 0 && ti < wt_e && qi < ql;
    }
    __device__ __forceinline__ int tq(int qi) const {
        return ti_ok(qi) ? __ldg(t + clampi(A - qi, 0, wt_max - 1)) : 5;
    }
    __device__ __forceinline__ bool comp(int qi, int tqv) const {
        const int qv = __ldg(q + qi);
        return (qv == 4 || tqv == 4 || qv + tqv == 3) && ti_ok(qi);
    }
    __device__ __forceinline__ bool comp(int qi) const {
        return comp(qi, tq(qi));
    }
    // an A-T pair at the (clamped) index qi
    __device__ __forceinline__ bool at_pair(int qi, int wq_max) const {
        qi = clampi(qi, 0, wq_max - 1);
        const int qv = __ldg(q + qi), tv = tq(qi);
        return (qv == 0 && tv == 3) || (qv == 3 && tv == 0);
    }
};

__global__ void __launch_bounds__(EVAL_THREADS)
eval_pack_kernel(const EvalArgs a)
{
    const int b = blockIdx.x * EVAL_THREADS + threadIdx.x;
    if (b >= a.B) return;
    int* out = a.out + (size_t)b * 5;
    if (!a.ent_valid[b]) {
        out[0] = 0; out[1] = 0; out[2] = 0; out[3] = 0; out[4] = 0;
        return;
    }
    const int W = a.wq_max, w1 = a.wt_max + 1;
    const int ql = a.ql[b], wt_e = a.wt_e[b];
    const int nrow = clampi(ql, 0, W), ncol = clampi(wt_e + 1, 0, w1);
    const size_t pitch = (size_t)a.B * w1;
    const int* m = a.mrows + (size_t)b * w1;

    // ---- 1. best cell, first index on ties, number of ties ---------------
    Best best{INT32_MIN, 0, 0};
    for (int r = 0; r < nrow; ++r) {
        const int* row = m + (size_t)r * pitch;
        for (int j = 0; j < ncol; ++j) best.feed(__ldg(row + j), r * w1 + j, 1);
        if (ncol < w1) best.feed(-1, r * w1 + ncol, w1 - ncol);
    }
    if (nrow < W) best.feed(-1, nrow * w1, (W - nrow) * w1);
    const int r_star = best.first / w1, j_star = best.first % w1;
    const bool no_align = best.v < 0;
    const bool unique = best.count == 1 && !no_align;
    const bool no_gap_tie = a.mgmax[b] < best.v;
    const int qi0 = ql - (r_star + 1);
    const int A = qi0 + j_star - 1;

    // ---- 2. the walk along the diagonal -----------------------------------
    const Diagonal diag{m, pitch, nrow, ncol, A};
    const int walk_hi = min(ql - 1, A);
    int qi1 = walk_hi;
    bool has_neg = false, no_zero = true;
    for (int qi = max(qi0, 0); qi <= min(walk_hi, W - 1); ++qi) {
        const int v = diag.at(qi);
        if (v < 0) { has_neg = true; qi1 = qi; break; }
        if (v == 0) no_zero = false;
    }
    const bool row0_stale = !has_neg && A > ql - 1;
    const bool trusted_ev =
        no_align || (unique && no_gap_tie && !row0_stale && no_zero);
    // visited: qi0 <= qi <= qi1 (and 0 <= qi < wq_max)
    const int v_lo = max(qi0, 0), v_hi = min(qi1, W - 1);

    // ---- 3. pairs, trim, anchors ------------------------------------------
    const int s = a.slot[b];
    const Pairs pr{a.qc + (size_t)clampi(s, 0, a.n_q - 1) * W,
                   a.tb5 + (size_t)b * a.wt_max, ql, wt_e, a.wt_max, A};
    int lo = 0, hi = -1;
    bool any_wc = false;
    for (int qi = v_lo; qi <= v_hi; ++qi) {
        if (pr.comp(qi)) {
            if (!any_wc) lo = qi;
            any_wc = true;
            hi = qi;
        }
    }
    if (!any_wc) hi = ql - 1;
    const int align_len = any_wc ? hi - lo + 1 : 0;

    int anchor5 = 0, anchor3 = 0;
    if (A >= 0 && A < wt_e)
        while (anchor5 < W && pr.comp(anchor5)) ++anchor5;
    {
        const int t3 = A + 1 - ql;          // lm_q + lm_t + 1 - ql
        if (t3 >= 0 && t3 < wt_e)
            while (anchor3 < W && anchor3 < ql
                   && pr.comp(clampi(ql - 1 - anchor3, 0, W - 1)))
                ++anchor3;
    }

    // ---- 4. dH, dS: ordered f32 -------------------------------------------
    const int st = clampi(s, 0, a.n_slots - 1);
    const float4* tabs = a.ev_tabs + (size_t)st * W * 25;
    const float* loop2m = a.ev_loop + (size_t)st * (W + 2);
    const bool at5w = pr.at_pair(lo, W) && any_wc;
    const bool at3w = pr.at_pair(hi, W) && any_wc;
    float dH = a.init_H, dS = a.init_S;
    dH = dH + (at5w ? a.AT_H : 0.0f);
    dS = dS + (at5w ? a.AT_S : 0.0f);
    float sv_h = 0.0f, sv_s = 0.0f, sv_lth = 0.0f, sv_lts = 0.0f;
    int n_stack = 0, n_close = 0, n_mm = 0;
    int tprev = 5, lastwc = -1;             // tq, running max of wct indices
    bool comp_prev = false, wct_prev = false;
    for (int qi = 0; qi < W; ++qi) {
        const int tqv = pr.tq(qi);
        const bool comp = pr.comp(qi, tqv);
        const bool trimmed = qi >= lo && qi <= hi;
        const bool wct = comp && trimmed;
        const bool inner = trimmed && qi > lo;
        const bool in_loop = !comp && (qi == 0 || !comp_prev);
        const bool is_stk = inner && !in_loop;
        const int mm_run = (wct && qi > lo) ? qi - 1 - lastwc : 0;
        const bool is_close = wct && mm_run >= 2;
        const bool is_first = inner && !comp && wct_prev;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (is_stk || is_close || is_first)
            v = __ldg(tabs + qi * 25 + clampi(tprev, 0, 4) * 5
                      + clampi(tqv, 0, 4));
        // the sum over m of (mm_run == m ? loop2m[m] : 0) from +0.0f on
        float loop_s = 0.0f;
        if (is_close && mm_run <= W) loop_s = 0.0f + __ldg(loop2m + mm_run);
        if (is_first) { sv_h = v.x; sv_s = v.y; sv_lth = v.z; sv_lts = v.w; }
        dH = dH + (is_stk ? v.x : 0.0f);
        dS = dS + (is_stk ? v.y : 0.0f);
        dS = dS + (is_close ? loop_s : 0.0f);
        dH = dH - (is_close ? v.x : 0.0f);
        dS = dS - (is_close ? v.y : 0.0f);
        dH = dH + (is_close ? v.z : 0.0f);
        dS = dS + (is_close ? v.w : 0.0f);
        dH = dH - (is_close ? sv_h : 0.0f);
        dS = dS - (is_close ? sv_s : 0.0f);
        dH = dH + (is_close ? sv_lth : 0.0f);
        dS = dS + (is_close ? sv_lts : 0.0f);
        n_stack += is_stk;
        n_close += is_close;
        n_mm += trimmed && !comp;
        if (wct) lastwc = qi;
        tprev = tqv;
        comp_prev = comp;
        wct_prev = wct;
    }
    dH = dH + (at3w ? a.AT_H : 0.0f);
    dS = dS + (at3w ? a.AT_S : 0.0f);

    // ---- 5. the words -------------------------------------------------------
    const bool usable = align_len >= 3 && dH < 0.0f;
    const bool tm_zero = no_align || (trusted_ev && !usable);
    const bool trusted = trusted_ev && !a.needs_host[b];
    const int num_base = 2 + 2 * n_stack + 2 * n_close;
    out[0] = (int)trusted | ((int)tm_zero << 1)
        | (clampi(num_base, 0, 255) << 2) | (clampi(n_mm, 0, 63) << 10)
        | (clampi(align_len, 0, 63) << 16);
    out[1] = (int)((uint32_t)(lo & 0xFF) | ((uint32_t)((A - lo) & 0xFF) << 8)
                   | ((uint32_t)(hi & 0xFF) << 16)
                   | ((uint32_t)((A - hi) & 0xFF) << 24));
    out[2] = (anchor5 & 0xFF) | ((anchor3 & 0xFF) << 8);
    out[3] = __float_as_int(dH);
    out[4] = __float_as_int(dS);
}

// Every pointer is device memory of the current device; ev_tabs is 16-byte
// aligned.  Returns the CUDA error of the launch (0: queued on `stream`).
extern "C" int eval_pack_launch(
    const void* mrows, const void* mgmax, const void* tb5, const void* slot,
    const void* ql, const void* wt_e, const void* needs_host,
    const void* ent_valid, const void* qc, const void* ev_tabs,
    const void* ev_loop, void* out, int B, int wq_max, int wt_max, int n_q,
    int n_slots, float AT_H, float AT_S, float init_H, float init_S,
    void* stream)
{
    if (B <= 0) return 0;
    if (wq_max <= 0 || wt_max <= 0 || n_q <= 0 || n_slots <= 0
        || ((uintptr_t)ev_tabs & 15) != 0)
        return (int)cudaErrorInvalidValue;
    const EvalArgs a{(const int*)mrows, (const int*)mgmax, (const int*)tb5,
                     (const int*)slot, (const int*)ql, (const int*)wt_e,
                     (const uint8_t*)needs_host, (const uint8_t*)ent_valid,
                     (const int*)qc, (const float4*)ev_tabs,
                     (const float*)ev_loop, (int*)out,
                     B, wq_max, wt_max, n_q, n_slots,
                     AT_H, AT_S, init_H, init_S};
    const unsigned grid = (unsigned)((B + EVAL_THREADS - 1) / EVAL_THREADS);
#ifdef EVAL_PACK_HOST
    // the CPU tests' build (a host compiler and a header that stands in for
    // the CUDA runtime): the same kernel body, one entry after another
    for (blockIdx.x = 0; blockIdx.x < grid; ++blockIdx.x)
        for (threadIdx.x = 0; threadIdx.x < EVAL_THREADS; ++threadIdx.x)
            eval_pack_kernel(a);
    return 0;
#else
    eval_pack_kernel<<<grid, EVAL_THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
#endif
}
