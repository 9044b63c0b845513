// The cell update and the row state of the exact-int32 3-state NucCruc DP
// (M / I_query / I_target, plus the gapped-best channel Mg of the eval
// condition), shared by screen_dp.cu and screen_probe.cu: the probe runs the
// production kernel's recurrence by construction, with its own energies.
//
// One thread owns one window.  A DP row is the run-time loop of the caller;
// dp_row() below walks the row's columns left to right:
//
//     m  = max(relu(M'[j-1]) - e0, relu(Iq'[j-1]) - e1, relu(It'[j-1]) - e2)
//     it = max(relu(M'[j]) - e5, relu(It'[j]) - e6)
//     a  = max(relu(m[j-1]) - e3, -e4)
//     iq = j == 0 ? a : max(a, iq[j-1] - e4)
//     mg = max(Mg'[j-1] >= 0 ? Mg'[j-1] - e0 : NEG, <the last two terms of m>)
//
// (X' is the previous row; the column left of the first reads -1, NEG for
// Mg.)  Every read of a previous M, Iq or It goes through relu, so the row
// state holds them already clamped (cM, cIq, cIt); raw m only feeds `best`
// and the caller's sink, raw iq only the prefix recurrence.  Mg is kept raw
// and only when EVAL.  The energies arrive negated (n_k = -e_k), so every
// term is an add followed by a max: Hopper's DPX instructions do both in one
// (__viaddmax_s32 = max(a + b, c), __viaddmax_s32_relu = max(a + b, c, 0);
// SASS VIADDMNMX, VIADDMNMX.RELU, VIMNMX.RELU).  As written a cell without
// the Mg channel is 13 integer instructions (two adds, five add-max, two max
// for the clamps, compare and predicated max for `best`, byte extract and add
// for the table address) and seven shared-memory loads.  What nvcc
// emits for a 32-column row of the width-32 instantiation (cuobjdump -sass;
// tools/dp_steps.py prints the row loop's mix): 750 instructions, 23.4 a
// cell: 6.9 LDS, 2.9 VIADDMNMX, 3.9 VIMNMX, 6.3 IMAD (adds, moves and the
// table address), 2.1 ISETP, 1 SEL (it splits two of the five add-max over
// both integer pipes and unpacks the byte offsets ahead of the row loop);
// 33 a cell with
// the Mg channel and the staged M-row store.  Building with -DDP_NO_DPX
// writes the same arithmetic with plain max (for timing the difference).
//
// Where the previous row lives is the Rows type:
//   RegRows<WT, EVAL>   WT columns in registers: every loop over j is fully
//                       unrolled, so each index is a compile-time constant
//                       (no local memory); the window's pair offsets are
//                       packed four to a register.  A window narrower than
//                       WT computes the columns to its right too: they change
//                       nothing to their left, and `best`/`mgbest` only count
//                       j < wt_e.  A window wider than WT runs in strips of
//                       WT columns (dp_row_strip below): the row's state left
//                       of the strip comes in as a carry, and the strip's
//                       last column goes out as the next strip's.
//   A Rows type with STATIC false (screen_probe.cu keeps one, its rows in
//   shared memory) walks its columns in a run-time loop.
// Where the energies come from is the Energy type: TableEnergy reads a
// 7 x 32 row of negated energies n[k][v] at `row + voff + k * 128` bytes
// (voff = 4 * pair value: lanes with different values hit different banks,
// lanes with equal values broadcast); ConstEnergy returns a constant.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"     // allow_shared_memory, SpanIndex

#define NEG_I32 (-(1 << 29))
#define NUM_PAIR 30
#define TAB_K_WORDS 32                    // words from energy k to k + 1
#define TAB_ROW_WORDS (7 * TAB_K_WORDS)   // one row: 7 energies x 32 values

#ifndef DP_NO_DPX
__device__ __forceinline__ int addmax(int a, int b, int c) {
    return __viaddmax_s32(a, b, c);
}
__device__ __forceinline__ int addmax_relu(int a, int b, int c) {
    return __viaddmax_s32_relu(a, b, c);
}
#else
__device__ __forceinline__ int addmax(int a, int b, int c) {
    return max(a + b, c);
}
__device__ __forceinline__ int addmax_relu(int a, int b, int c) {
    return max(max(a + b, c), 0);
}
#endif

struct TableEnergy {
    const char* row;        // the 7 x 32 row of this DP row's query pair
    __device__ __forceinline__ void load(int voff, int (&n)[7]) const {
        const int* p = reinterpret_cast<const int*>(row + voff);
#pragma unroll
        for (int k = 0; k < 7; ++k) n[k] = p[k * TAB_K_WORDS];
    }
};

template <int E>
struct ConstEnergy {
    __device__ __forceinline__ void load(int, int (&n)[7]) const {
#pragma unroll
        for (int k = 0; k < 7; ++k) n[k] = -E;
    }
};

struct NoSink {
    __device__ __forceinline__ void put(int, int) const {}
};

template <int WT_, bool EVAL>
struct RegRows {
    static constexpr bool STATIC = true;
    static constexpr int WT = WT_;
    int cM[WT], cIq[WT], cIt[WT], Mg[EVAL ? WT : 1];
    unsigned pk[(WT + 3) / 4];      // byte j & 3 of pk[j >> 2] = 4 * pair

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int j = 0; j < WT; ++j) {
            cM[j] = 0; cIq[j] = 0; cIt[j] = 0;      // relu(-1)
            if (EVAL) Mg[j] = NEG_I32;
        }
#pragma unroll
        for (int i = 0; i < (WT + 3) / 4; ++i) pk[i] = 0;
    }
    __device__ __forceinline__ int ncols() const { return WT; }
    // Called once a DP row: hides pk from the optimiser, which else unpacks
    // all WT offsets into registers of their own ahead of the row loop.
    __device__ __forceinline__ void keep_packed() {
#pragma unroll
        for (int i = 0; i < (WT + 3) / 4; ++i) asm volatile("" : "+r"(pk[i]));
    }
    // j is a compile-time constant wherever these are called
    __device__ __forceinline__ void set_voff(int j, int voff) {
        pk[j >> 2] |= (unsigned)voff << (8 * (j & 3));
    }
    __device__ __forceinline__ int voff(int j) const {
        return (int)__byte_perm(pk[j >> 2], 0, 0x4440 | (j & 3));
    }
    __device__ __forceinline__ int m(int j) const { return cM[j]; }
    __device__ __forceinline__ int iq(int j) const { return cIq[j]; }
    __device__ __forceinline__ int it(int j) const { return cIt[j]; }
    __device__ __forceinline__ int mg(int j) const { return Mg[EVAL ? j : 0]; }
    __device__ __forceinline__ void set(int j, int m_, int iq_, int it_) {
        cM[j] = m_; cIq[j] = iq_; cIt[j] = it_;
    }
    __device__ __forceinline__ void set_mg(int j, int v) {
        Mg[EVAL ? j : 0] = v;
    }
};

// One cell: column j of the current row.  d* is the previous row's column
// j - 1, cmleft / iqleft this row's column j - 1; all are moved on.  With
// CARRY, column j == 0 is not the window's first: its iq takes iqleft (a
// strip's carry, or NEG_I32 at the window's first column, where
// max(NEG_I32 - e4, a) == a since a >= -e4).
template <bool EVAL, bool CARRY = false, class Rows, class Energy, class Sink>
__device__ __forceinline__ void dp_cell(
    Rows& rows, const Energy& en, const Sink& sink, int j, int wte,
    int& dM, int& dIq, int& dIt, int& dMg, int& cmleft, int& iqleft,
    int& best, int& mgbest)
{
    int n[7];
    en.load(rows.voff(j), n);
    const int uM = rows.m(j), uIq = rows.iq(j), uIt = rows.it(j);
    const int t12 = addmax(dIq, n[1], dIt + n[2]);
    const int m = addmax(dM, n[0], t12);
    const int it = addmax_relu(uM, n[5], uIt + n[6]);
    const int a = addmax(cmleft, n[3], n[4]);
    const int iq = (!CARRY && j == 0) ? a : addmax(iqleft, n[4], a);
    const int cm = max(m, 0);
    const bool ok = j < wte;
    if (ok) best = max(best, m);
    if (EVAL) {
        // gapped-best channel: no relu restart on the M path, and NEG - e0
        // must not feed the max
        const int uMg = rows.mg(j);
        const int mg = max(dMg >= 0 ? dMg + n[0] : NEG_I32, t12);
        rows.set_mg(j, mg);
        if (ok) mgbest = max(mgbest, mg);
        dMg = uMg;
    }
    dM = uM; dIq = uIq; dIt = uIt;
    rows.set(j, cm, max(iq, 0), it);
    cmleft = cm; iqleft = iq;
    sink.put(j, m);
}

// One DP row over all of `rows`' columns.  `best` (and `mgbest` when EVAL)
// take the maxima over columns j < wte; sink.put(j, m) sees every column's
// raw M.
template <bool EVAL, class Rows, class Energy, class Sink>
__device__ __forceinline__ void dp_row(
    Rows& rows, const Energy& en, const Sink& sink, int wte, int& best,
    int& mgbest)
{
    // the boundary column: relu(-1) for M, Iq, It, NEG for Mg
    int dM = 0, dIq = 0, dIt = 0, dMg = NEG_I32, cmleft = 0, iqleft = 0;
    if constexpr (Rows::STATIC) {
#pragma unroll
        for (int j = 0; j < Rows::WT; ++j)
            dp_cell<EVAL>(rows, en, sink, j, wte, dM, dIq, dIt, dMg, cmleft,
                          iqleft, best, mgbest);
    } else {
        const int n = rows.ncols();
        for (int j = 0; j < n; ++j)
            dp_cell<EVAL>(rows, en, sink, j, wte, dM, dIq, dIt, dMg, cmleft,
                          iqleft, best, mgbest);
    }
}

// One DP row over the WT columns of a strip of a wider window.  The strip's
// left neighbour column comes in: the previous row's (dM, dIq, dIt clamped,
// dMg raw) and this row's (cmleft clamped, iqleft raw; for the window's
// first strip the boundary 0 and NEG_I32).  cmleft / iqleft go out as the
// strip's last column; rows.it(WT - 1) and rows.mg(WT - 1) hold the rest.
// `wte` counts columns from the strip's first.
template <bool EVAL, class Rows, class Energy, class Sink>
__device__ __forceinline__ void dp_row_strip(
    Rows& rows, const Energy& en, const Sink& sink, int wte, int& best,
    int& mgbest, int dM, int dIq, int dIt, int dMg, int& cmleft, int& iqleft)
{
    static_assert(Rows::STATIC, "strips run on register rows");
#pragma unroll
    for (int j = 0; j < Rows::WT; ++j)
        dp_cell<EVAL, true>(rows, en, sink, j, wte, dM, dIq, dIt, dMg,
                            cmleft, iqleft, best, mgbest);
}
