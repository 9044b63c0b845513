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
// as a (B, wq_max) array and reduces it; here one lane owns one entry and
// walks it, and nothing but the entry's five words leaves the warp.
//
// Per entry b (ql rows, wt_e columns, slot s), exactly eval_flat + pack_eval:
//   1. the best cell of the masked M block (rows r < ql, columns j <= wt_e of
//      mrows[r][b][:]; every other cell counts as -1 and is never fed, since
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
// of a chunk past the pool) writes five zeros, as the skipped chunks of the
// jitted step do; the plain version writes the same.  Every gather eval_flat
// clamps is clamped here (JAX gathers clamp, a pointer does not): the column
// of the diagonal, the index into tb5, the pair codes 0..4, the loop length
// into the slot's loop table, lo and hi.
//
// What bounds it on the H100: bytes.  The M block of a 32768-entry chunk at
// the bench shapes (24 rows, 33 columns) is 97.7 MB, of which the entries'
// contract is about 87 MB, read once: 0.028 ms at HBM3's rate; the scan is a
// compare and a select a cell.
//
// What the design does about it.  A warp owns 32 consecutive entries
// b0..b0+31, one a lane; warps do not wait for each other (no block
// barrier), so a block is only a way to share an SM's shared memory.
// - The M rows go through shared memory.  For row r the warp's 32 entries
//   are one contiguous span of 32 * w1 words (w1 = wt_max + 1) at
//   mrows + (r * B + b0) * w1; the warp copies it with cp.async, neighbouring
//   lanes on neighbouring words, so a copy instruction covers whole lines.
//   Where the pitch w1 is odd the span lands in the buffer as it is (its
//   image): 16 bytes a lane, with the up to 3 words before the first 16-byte
//   boundary and the words after the last one copied singly, and the image
//   shifted by the span's misalignment so that source and destination agree
//   on 16 bytes (B * w1 need not be a multiple of 4: B = 4099).  Where w1 is
//   even the buffer's pitch is w1 + 1 and the span is copied word by word
//   (SpanIndex, staging.cuh, as screen_dp's staged store walks the same
//   layout the other way).  The pitch is odd either way, so each lane's
//   scan of its own row is free of bank conflicts.
// - A ring of EVAL_STAGES row buffers per warp: rows r + 1 .. r + STAGES - 1
//   are in flight while the lanes scan row r.
// - A warp copies rows r < max(ql) over its valid lanes only (in a
//   slot-major stream ql is uniform within nearly every warp), and a warp
//   without a valid entry writes its zeros and copies nothing; a block of
//   such warps (the sorted tail of the stream) therefore does no copy.
// - The walk down the diagonal reads its cells from device memory again,
//   eight at a time (__ldg); the block's rows were just read, so they are
//   mostly in L2.  Keeping every row of the warp in shared memory to walk
//   there instead costs three quarters of the warps an SM, and was three
//   times slower.
// - The warp's window codes are staged with its first row; whether the pair
//   at each query index is complementary is computed once, as bits.
// - The warp's 32 x 5 words are staged in shared memory and stored as one
//   contiguous 640-byte span.
// - The layout (pitch, ring, warps a block, shared memory) is worked out on
//   the host by eval_layout(), once for a panel's shapes, in eval_pack_plan();
//   eval_pack_launch_plan() then takes only a chunk's pointers and B
//   (ops/eval_pack.py, EvalPackPlan).
// All loops over rows and columns are run-time loops, so ONE general path
// takes any width.
//
// The host build (-DEVAL_PACK_HOST, tests/test_torch_eval_pack.py, g++
// behind tests/cuda_host_shim/cuda_runtime.h): one host thread plays the 32
// lanes of a warp, phase by phase (stage a row, scan it in every lane; walk
// and evaluate every lane; store), through the lane loops below, which run
// over one lane on the card (WARP_LANES).  The shim's copies check the
// 16-byte alignment the hardware demands and its warp reductions return
// what the lane loop has already reduced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"

#define EVAL_STAGES 3       // row buffers a warp's ring holds
#define EVAL_WARPS 4        // warps a block at most
#define EVAL_MAX_WT 1032    // ops/screen_dp.py MAX_WT
#define EVAL_ROW_WT 128     // widest window staged a whole row at a time
#define EVAL_PIECE 32       // columns of a piece past EVAL_ROW_WT
#define EVAL_MAX_W 1024     // wq_max the kernel takes at most
#define EVAL_REG_W 128      // widest wq_max whose pair bits fit registers
#define BITS_PITCH (EVAL_MAX_W / 32 + 1)    // a lane's pair-bit words, odd
// ops/eval_gapless.py LOOP_MAX_MM: an entry with a closing run of more
// mismatches (a loop past the entropy table's 512 bases) is not trusted
#define EVAL_LOOP_MAX_MM 256
#define EVAL_SMEM_MAX (227 * 1024)  // dynamic shared memory a block may use
#define SM_SMEM (228 * 1024)        // shared memory an SM can hold

#ifdef EVAL_PACK_HOST
#define WARP_LANES 32       // the host thread plays every lane of a warp
#define LANE(i) (i)
#else
#define WARP_LANES 1        // a lane plays itself
#define LANE(i) ((int)(threadIdx.x & 31))
// the card's copy primitives (the host build's are the shim's)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void async_copy_word(int* dst, const int* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void async_copy_16(int* dst, const int* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
#endif

// The staging layout of one launch, from the panel's shapes alone.
struct EvalLayout {
    int pitch;      // words from a lane's row to the next lane's (odd)
    int stage;      // words of one row buffer (a multiple of 4)
    int slots;      // row buffers of a warp
    int tpitch;     // words from a lane's window codes to the next lane's
    int tb5;        // words of the warp's window codes (0: read in place)
    int warps;      // warps a block (0: does not fit)
    int smem;       // dynamic shared memory of a block, bytes
    int piece;      // columns a buffer holds of each lane's row (w1: all)
    int bits;       // words of the warp's pair bits (0: in registers)
};

static EvalLayout eval_layout(int wt_max, int wq_max)
{
    EvalLayout l;
    const int w1 = wt_max + 1;
    l.slots = EVAL_STAGES;
    if (wt_max > EVAL_ROW_WT || wq_max > EVAL_REG_W) {
        // pieces of EVAL_PIECE columns of the 32 lanes' rows, copied word
        // by word; the window codes read from device memory
        l.piece = EVAL_PIECE;
        l.pitch = EVAL_PIECE | 1;
        l.stage = (32 * l.pitch + 3) / 4 * 4;
        l.tpitch = 0;
        l.tb5 = 0;
    } else {
        l.piece = w1;
        l.pitch = w1 | 1;
        // 32 lanes' rows and up to 3 words of the span's misalignment
        l.stage = (32 * l.pitch + 3 + 3) / 4 * 4;
        l.tpitch = wt_max | 1;
        l.tb5 = (32 * l.tpitch + 3) / 4 * 4;
    }
    l.bits = l.piece < w1 || wq_max > EVAL_REG_W ? 32 * BITS_PITCH : 0;
    const long per_warp =
        ((long)l.slots * l.stage + l.tb5 + l.bits) * (long)sizeof(int);
    const long fit = EVAL_SMEM_MAX / per_warp;
    l.warps = wt_max < 1 || wt_max > EVAL_MAX_WT ? 0
        : (int)(fit < EVAL_WARPS ? fit : EVAL_WARPS);
    l.smem = (int)(l.warps * per_warp);
    return l;
}

// The percent of an SM's shared memory to ask for when `blocks` blocks of
// `smem` bytes share an SM (the SM keeps 1 KB a block besides): no more, so
// that the rest of its 256 KB serves as L1 (the evaluation's tables, the
// diagonal's cells).
static int carveout(int smem, int blocks)
{
    const long want = (long)blocks * (smem + 1024L);
    return want >= SM_SMEM ? 100 : (int)((100 * want + SM_SMEM - 1) / SM_SMEM);
}

struct EvalArgs {
    const int *mrows, *mgmax, *tb5, *slot, *ql, *wt_e;
    const uint8_t *needs_host, *ent_valid;
    const int* qc;          // (n_q, wq_max) query codes per slot
    const float4* ev_tabs;  // (n_slots, wq_max, 25) of (Hstk, Sstk, Hlt, Slt)
    const float* ev_loop;   // (n_slots, wq_max + 2) loop entropies
    int* out;               // (B, 5)
    int B, wq_max, wt_max, n_q, n_slots;
    float AT_H, AT_S, init_H, init_S;
    EvalLayout lay;
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

// Row r of the warp's entries b0 .. b0 + nw - 1: where its span starts in
// device memory, and the word of the row buffer its first word lands on (the
// span's misalignment when the span is copied as its image, else 0).
struct RowSpan {
    const int* src;
    int lead;
    __device__ __forceinline__ RowSpan(const EvalArgs& a, int r, int b0) {
        const int w1 = a.wt_max + 1;
        src = a.mrows + ((size_t)r * a.B + b0) * w1;
        lead = a.lay.pitch == w1 ? (int)(((uintptr_t)src >> 2) & 3) : 0;
    }
};

// The warp copies the piece of `width` columns from column c0 of each of
// its nw entries' rows r into buffer u of its ring, word by word into the
// pitch (every lane its share; the host build runs the lanes one after
// another).
__device__ __forceinline__ void stage_piece(const EvalArgs& a, int* ring,
                                            int u, int r, int c0, int width,
                                            int b0, int nw)
{
    const int w1 = a.wt_max + 1, P = a.lay.pitch, pc = a.lay.piece;
    int* dst = ring + (u % a.lay.slots) * a.lay.stage;
    const int* src = a.mrows + ((size_t)r * a.B + b0) * w1 + c0;
    for (int i = 0; i < WARP_LANES; ++i) {
        SpanIndex at(LANE(i), pc);
        for (int e = LANE(i); e < nw * pc; e += 32) {
            if (at.col < width)
                async_copy_word(dst + at.row * P + at.col,
                                src + (size_t)at.row * w1 + at.col);
            at.advance(32, pc);
        }
    }
}

// The warp copies row r of its nw entries into its ring (every lane its
// share; the host build runs the lanes one after another).
__device__ __forceinline__ void stage_row(const EvalArgs& a, int* ring, int r,
                                          int b0, int nw)
{
    const int w1 = a.wt_max + 1, P = a.lay.pitch;
    int* dst = ring + (r % a.lay.slots) * a.lay.stage;
    const RowSpan sp(a, r, b0);
    const int n = nw * w1;
    for (int i = 0; i < WARP_LANES; ++i) {
        const int lane = LANE(i);
        if (P == w1) {
            // the image: singles up to the first 16-byte boundary, 16 bytes a
            // lane, singles after the last one
            int* d = dst + sp.lead;
            const int head = min(n, (4 - sp.lead) & 3);
            const int n4 = (n - head) >> 2;
            for (int k = lane; k < head; k += 32)
                async_copy_word(d + k, sp.src + k);
            for (int k = lane; k < n4; k += 32)
                async_copy_16(d + head + 4 * k, sp.src + head + 4 * k);
            for (int k = head + 4 * n4 + lane; k < n; k += 32)
                async_copy_word(d + k, sp.src + k);
            continue;
        }
        SpanIndex at(lane, w1);
        for (int e = lane; e < n; e += 32) {
            async_copy_word(dst + at.row * P + at.col, sp.src + e);
            at.advance(32, w1);
        }
    }
}

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
    const int *q, *t;       // the slot's query codes, the entry's codes
    int ql, wt_e, wt_max, A;
    __device__ __forceinline__ bool ti_ok(int qi) const {
        const int ti = A - qi;
        return ti >= 0 && ti < wt_e && qi < ql;
    }
    __device__ __forceinline__ int tq(int qi) const {
        return ti_ok(qi) ? t[clampi(A - qi, 0, wt_max - 1)] : 5;
    }
    __device__ __forceinline__ bool comp(int qi) const {
        const int qv = __ldg(q + qi), tqv = tq(qi);
        return (qv == 4 || tqv == 4 || qv + tqv == 3) && ti_ok(qi);
    }
    // an A-T pair at the (clamped) index qi
    __device__ __forceinline__ bool at_pair(int qi, int wq_max) const {
        qi = clampi(qi, 0, wq_max - 1);
        const int qv = __ldg(q + qi), tv = tq(qi);
        return (qv == 0 && tv == 3) || (qv == 3 && tv == 0);
    }
};

// Whether the pair at qi is complementary, as bits: comp(qi) is computed
// once a qi, and the trim and the anchors become bit operations.  Up to
// wq_max EVAL_REG_W the bits live in registers (RegPairBits: every word
// index is a compile-time constant after unrolling, so no local memory);
// past it in shared memory (SmemPairBits: a lane's EVAL_MAX_W / 32 words,
// lanes BITS_PITCH words apart).  The kernel is built for each.

// set bits from bit 0 up, until the first clear one
template <class Bits>
__device__ __forceinline__ int bits_run_up(const Bits& b)
{
    int n = 0;
    for (int k = 0; k < Bits::WORDS; ++k) {
        const unsigned x = b.word(k);
        if (x != ~0u) return n + __ffs((int)~x) - 1;
        n += 32;
    }
    return n;
}

// set bits from bit `from` down, until the first clear one
template <class Bits>
__device__ __forceinline__ int bits_run_down(const Bits& b, int from)
{
    int n = 0;
    for (int k = from >> 5; from >= 0 && k >= 0; --k) {
        const int top = from - 32 * k;          // bit of `from` in word k
        const unsigned x = b.word(k) << (31 - top);
        const int ones = __clz((int)~x);        // 32 when all are set
        if (ones < top + 1) return n + ones;
        n += top + 1;
        from = 32 * k - 1;
    }
    return n;
}

struct RegPairBits {
    static constexpr bool IN_REGISTERS = true;
    static constexpr int WORDS = EVAL_REG_W / 32;
    unsigned w[WORDS];
    __device__ __forceinline__ void bind(unsigned*) {}
    __device__ __forceinline__ void set(int k, unsigned x) { w[k] = x; }
    __device__ __forceinline__ unsigned word(int k) const {
        unsigned x = 0;
#pragma unroll
        for (int i = 0; i < WORDS; ++i) x = k == i ? w[i] : x;
        return x;
    }
    __device__ __forceinline__ bool get(int qi) const {
        return (word(qi >> 5) >> (qi & 31)) & 1u;
    }
    // the first and the last set bit in [lo, hi]; false if none
    __device__ __forceinline__ bool span(int lo, int hi, int& first,
                                         int& last) const {
        bool any = false;
#pragma unroll
        for (int k = 0; k < WORDS; ++k) {
            const int b0 = 32 * k;
            unsigned x = w[k];
            if (lo > b0) x &= lo - b0 >= 32 ? 0u : ~0u << (lo - b0);
            if (hi < b0 + 31) x &= hi < b0 ? 0u : ~0u >> (b0 + 31 - hi);
            if (x == 0) continue;
            if (!any) first = b0 + __ffs((int)x) - 1;
            last = b0 + 31 - __clz((int)x);
            any = true;
        }
        return any;
    }
    // set bits from bit 0 up, until the first clear one
    __device__ __forceinline__ int run_up() const {
        return bits_run_up(*this);
    }
    // set bits from bit `from` down, until the first clear one
    __device__ __forceinline__ int run_down(int from) const {
        return bits_run_down(*this, from);
    }
};

struct SmemPairBits {
    static constexpr bool IN_REGISTERS = false;
    static constexpr int WORDS = EVAL_MAX_W / 32;
    unsigned* w;            // the lane's words
    __device__ __forceinline__ void bind(unsigned* row) { w = row; }
    __device__ __forceinline__ void set(int k, unsigned x) { w[k] = x; }
    __device__ __forceinline__ unsigned word(int k) const { return w[k]; }
    __device__ __forceinline__ bool get(int qi) const {
        return (w[qi >> 5] >> (qi & 31)) & 1u;
    }
    // the first and the last set bit in [lo, hi] (lo >= 0); false if none
    __device__ __forceinline__ bool span(int lo, int hi, int& first,
                                         int& last) const {
        bool any = false;
        for (int k = lo >> 5; k <= (hi >> 5) && k < WORDS; ++k) {
            const int b0 = 32 * k;
            unsigned x = w[k];
            if (lo > b0) x &= lo - b0 >= 32 ? 0u : ~0u << (lo - b0);
            if (hi < b0 + 31) x &= hi < b0 ? 0u : ~0u >> (b0 + 31 - hi);
            if (x == 0) continue;
            if (!any) first = b0 + __ffs((int)x) - 1;
            last = b0 + 31 - __clz((int)x);
            any = true;
        }
        return any;
    }
    __device__ __forceinline__ int run_up() const {
        return bits_run_up(*this);
    }
    __device__ __forceinline__ int run_down(int from) const {
        return bits_run_down(*this, from);
    }
};

// A valid entry's own inputs, loaded before the scan so that the
// evaluation does not wait for them.
struct Entry {
    int ql, wt_e, mgmax, slot;
    bool needs_host;
    const int* tb5;         // its window codes, staged in shared memory
};

#define WALK_BATCH 8        // diagonal cells loaded at once

// Steps 2-5 for a valid entry, whose scan ended in `best` (rows past its ql
// already fed as -1): its five words.
template <class Bits>
__device__ __forceinline__ void evaluate(const EvalArgs& a, const Diagonal& d,
                                         const Entry& e, const Best& best,
                                         unsigned* bits_row, int* out)
{
    const int W = a.wq_max, w1 = a.wt_max + 1;
    const int ql = e.ql, wt_e = e.wt_e;
    const int r_star = best.first / w1, j_star = best.first % w1;
    const bool no_align = best.v < 0;
    const bool unique = best.count == 1 && !no_align;
    const bool no_gap_tie = e.mgmax < best.v;
    const int qi0 = ql - (r_star + 1);
    const int A = qi0 + j_star - 1;

    // ---- 2. the walk along the diagonal -----------------------------------
    Diagonal diag = d;
    diag.A = A;
    const int walk_hi = min(ql - 1, A), walk_end = min(walk_hi, W - 1);
    int qi1 = walk_hi;
    bool has_neg = false, no_zero = true;
    // WALK_BATCH cells are loaded at once, then looked at in order up to the
    // first negative one (the cells loaded past it are not looked at)
    for (int q0 = max(qi0, 0); q0 <= walk_end && !has_neg;
         q0 += WALK_BATCH) {
        int v[WALK_BATCH];
#pragma unroll
        for (int k = 0; k < WALK_BATCH; ++k)
            v[k] = q0 + k <= walk_end ? diag.at(q0 + k) : 1;
#pragma unroll
        for (int k = 0; k < WALK_BATCH; ++k) {
            if (has_neg || q0 + k > walk_end) continue;
            if (v[k] < 0) { has_neg = true; qi1 = q0 + k; }
            else if (v[k] == 0) no_zero = false;
        }
    }
    const bool row0_stale = !has_neg && A > ql - 1;
    const bool trusted_ev =
        no_align || (unique && no_gap_tie && !row0_stale && no_zero);
    // visited: qi0 <= qi <= qi1 (and 0 <= qi < wq_max)
    const int v_lo = max(qi0, 0), v_hi = min(qi1, W - 1);

    // ---- 3. pairs, trim, anchors ------------------------------------------
    const int s = e.slot;
    const Pairs pr{a.qc + (size_t)clampi(s, 0, a.n_q - 1) * W, e.tb5, ql,
                   wt_e, a.wt_max, A};
    int lo = 0, hi = -1;
    int anchor5 = 0, anchor3 = 0;
    const int t3 = A + 1 - ql;              // lm_q + lm_t + 1 - ql
    // comp(qi) is false from ql on (ti_ok), so bits qi < min(W, ql) are all
    Bits bits;
    bits.bind(bits_row);
    if constexpr (Bits::IN_REGISTERS) {
#pragma unroll
        for (int k = 0; k < Bits::WORDS; ++k) {
            unsigned x = 0;
            for (int l = 0; l < 32 && 32 * k + l < min(W, ql); ++l)
                x |= (unsigned)pr.comp(32 * k + l) << l;
            bits.set(k, x);
        }
    } else {
        for (int k = 0; k < Bits::WORDS; ++k) {
            unsigned x = 0;
            for (int l = 0; l < 32 && 32 * k + l < min(W, ql); ++l)
                x |= (unsigned)pr.comp(32 * k + l) << l;
            bits.set(k, x);
        }
    }
    const bool any_wc = bits.span(v_lo, v_hi, lo, hi);
    // the loops above on the bits (ql <= W by contract): anchor5 counts
    // comp from 0 up, anchor3 from ql - 1 down
    if (A >= 0 && A < wt_e) anchor5 = bits.run_up();
    if (t3 >= 0 && t3 < wt_e) anchor3 = bits.run_down(min(ql, W) - 1);
    if (!any_wc) hi = ql - 1;
    const int align_len = any_wc ? hi - lo + 1 : 0;

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
    bool long_loop = false;     // a closing run past EVAL_LOOP_MAX_MM
    int tprev = 5, lastwc = -1;             // tq, running max of wct indices
    bool comp_prev = false, wct_prev = false;
    for (int qi = 0; qi < W; ++qi) {
        const int tqv = pr.tq(qi);
        const bool comp = bits.get(qi);
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
        if constexpr (!Bits::IN_REGISTERS)  // runs past 256 need wq_max 258
            long_loop = long_loop || (is_close && mm_run > EVAL_LOOP_MAX_MM);
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
    const bool trusted_all = trusted_ev && !long_loop;
    const bool tm_zero = no_align || (trusted_all && !usable);
    const bool trusted = trusted_all && !e.needs_host;
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

// The warp of entries b0 .. b0 + nw - 1 (nw <= 32), with `ring` its share
// of the block's shared memory.
template <class Bits>
__device__ __forceinline__ void eval_warp(const EvalArgs& a, int* ring,
                                          int b0, int nw)
{
    const int W = a.wq_max, w1 = a.wt_max + 1, P = a.lay.pitch;
    int* out = a.out + (size_t)b0 * 5;

    // ---- the lanes' entries, the warp's row bound --------------------------
    bool valid[WARP_LANES];
    int nrow[WARP_LANES], ncol[WARP_LANES];
    Entry ent[WARP_LANES];
    int rmax = 0, cmax = 0;
    unsigned live = 0;
    for (int i = 0; i < WARP_LANES; ++i) {
        const int lane = LANE(i), b = b0 + lane;
        valid[i] = lane < nw && a.ent_valid[b];
        ent[i] = Entry{0, 0, 0, 0, false, nullptr};
        if (valid[i])
            ent[i] = Entry{a.ql[b], a.wt_e[b], a.mgmax[b], a.slot[b],
                           a.needs_host[b] != 0,
                           Bits::IN_REGISTERS
                               ? ring + a.lay.slots * a.lay.stage
                                   + lane * a.lay.tpitch
                               : a.tb5 + (size_t)b * a.wt_max};
        nrow[i] = clampi(ent[i].ql, 0, W);
        ncol[i] = valid[i] ? clampi(ent[i].wt_e + 1, 0, w1) : 0;
        rmax = max(rmax, nrow[i]);
        cmax = max(cmax, ncol[i]);
        live |= (unsigned)valid[i] << lane;
    }
    rmax = __reduce_max_sync(0xffffffffu, rmax);
    cmax = __reduce_max_sync(0xffffffffu, cmax);
    live = __reduce_or_sync(0xffffffffu, live);
    if (live == 0) {            // the tail of the pool: zeros, no M row read
        for (int i = 0; i < WARP_LANES; ++i)
            for (int k = LANE(i); k < nw * 5; k += 32) out[k] = 0;
        return;
    }

    // ---- 1. best cell: rows staged through the ring, scanned in shared -----
    Best best[WARP_LANES];
    for (int i = 0; i < WARP_LANES; ++i) best[i] = Best{INT32_MIN, 0, 0};
    if constexpr (Bits::IN_REGISTERS) {
        // whole rows; the warp's window codes behind its ring, in the first
        // copy group: nw rows of wt_max words, one span, into the odd pitch
        // tpitch
        for (int i = 0; i < WARP_LANES; ++i) {
            const int* src = a.tb5 + (size_t)b0 * a.wt_max;
            int* dst = ring + a.lay.slots * a.lay.stage;
            SpanIndex at(LANE(i), a.wt_max);
            for (int e = LANE(i); e < nw * a.wt_max; e += 32) {
                async_copy_word(dst + at.row * a.lay.tpitch + at.col,
                                src + e);
                at.advance(32, a.wt_max);
            }
        }
        for (int r = 0; r < EVAL_STAGES - 1; ++r) {
            if (r < rmax) stage_row(a, ring, r, b0, nw);
            async_commit();
        }
        for (int r = 0; r < rmax; ++r) {
            if (r + EVAL_STAGES - 1 < rmax)
                stage_row(a, ring, r + EVAL_STAGES - 1, b0, nw);
            async_commit();
            async_wait<EVAL_STAGES - 1>();      // row r has landed
            __syncwarp();
            const int* buf = ring + (r % a.lay.slots) * a.lay.stage
                + RowSpan(a, r, b0).lead;
            for (int i = 0; i < WARP_LANES; ++i) {
                if (r >= nrow[i]) continue;
                const int* row = buf + LANE(i) * P;
                for (int j = 0; j < ncol[i]; ++j)
                    best[i].feed(row[j], r * w1 + j, 1);
                if (ncol[i] < w1)
                    best[i].feed(-1, r * w1 + ncol[i], w1 - ncol[i]);
            }
            __syncwarp();   // the buffer is free for row r + EVAL_STAGES
        }
    } else {
        // pieces of each row up to the warp's widest lane, in row-major
        // order, so that every lane feeds its cells in flat index order;
        // piece u + EVAL_STAGES - 1 (row sr, piece sc) is staged while piece
        // u (row r, piece pc) is scanned
        const int PC = a.lay.piece;
        const int npr = (cmax + PC - 1) / PC, nunit = rmax * npr;
        int sr = 0, sc = 0, r = 0, pc = 0;
        for (int u = 0; u < EVAL_STAGES - 1; ++u) {
            if (u < nunit) {
                stage_piece(a, ring, u, sr, sc * PC, min(PC, cmax - sc * PC),
                            b0, nw);
                if (++sc == npr) { sc = 0; ++sr; }
            }
            async_commit();
        }
        for (int u = 0; u < nunit; ++u) {
            if (u + EVAL_STAGES - 1 < nunit) {
                stage_piece(a, ring, u + EVAL_STAGES - 1, sr, sc * PC,
                            min(PC, cmax - sc * PC), b0, nw);
                if (++sc == npr) { sc = 0; ++sr; }
            }
            async_commit();
            async_wait<EVAL_STAGES - 1>();      // piece u has landed
            __syncwarp();
            const int c0 = pc * PC;
            const int* buf = ring + (u % a.lay.slots) * a.lay.stage;
            for (int i = 0; i < WARP_LANES; ++i) {
                if (r >= nrow[i]) continue;
                const int* row = buf + LANE(i) * P - c0;
                const int hi = min(ncol[i], c0 + PC);
                for (int j = c0; j < hi; ++j)
                    best[i].feed(row[j], r * w1 + j, 1);
                if (pc == npr - 1 && ncol[i] < w1)
                    best[i].feed(-1, r * w1 + ncol[i], w1 - ncol[i]);
            }
            if (++pc == npr) { pc = 0; ++r; }
            __syncwarp();   // the buffer is free for piece u + EVAL_STAGES
        }
    }
    async_wait<0>();        // the window codes, where no row was copied
    __syncwarp();

    // ---- 2-5. walk, evaluate ------------------------------------------------
    int words[WARP_LANES][5];
    for (int i = 0; i < WARP_LANES; ++i) {
        for (int k = 0; k < 5; ++k) words[i][k] = 0;
        if (!valid[i]) continue;
        if (nrow[i] < W)
            best[i].feed(-1, nrow[i] * w1, (W - nrow[i]) * w1);
        const Diagonal d{a.mrows + (size_t)(b0 + LANE(i)) * w1,
                         (size_t)a.B * w1, nrow[i], ncol[i], 0};
        evaluate<Bits>(a, d, ent[i], best[i],
                       (unsigned*)ring + a.lay.slots * a.lay.stage
                           + a.lay.tb5 + LANE(i) * BITS_PITCH,
                       words[i]);
    }

    // ---- the words ---------------------------------------------------------
    // through the ring (no copy is in flight: the groups after the last row
    // are empty), out as one span of nw * 5 words
    __syncwarp();
    for (int i = 0; i < WARP_LANES; ++i)
        for (int k = 0; k < 5; ++k) ring[LANE(i) * 5 + k] = words[i][k];
    __syncwarp();
    for (int i = 0; i < WARP_LANES; ++i)
        for (int k = LANE(i); k < nw * 5; k += 32) out[k] = ring[k];
}

#ifndef EVAL_PACK_HOST
template <class Bits>
__global__ void __launch_bounds__(EVAL_WARPS * 32)
eval_pack_kernel(const EvalArgs a)
{
    extern __shared__ __align__(16) int smem[];
    const int warp = threadIdx.x >> 5;
    const int b0 = (blockIdx.x * a.lay.warps + warp) * 32;
    if (b0 >= a.B) return;
    eval_warp<Bits>(
        a, smem + warp * (a.lay.slots * a.lay.stage + a.lay.tb5 + a.lay.bits),
        b0, min(32, a.B - b0));
}

// Queues the kernel of Bits on `stream` (the current device's).
template <class Bits>
static int launch_kernel(const EvalArgs& a, void* stream)
{
    static int opted[MAX_DEVICES], sms[MAX_DEVICES], carved[MAX_DEVICES];
    cudaError_t err = allow_shared_memory(eval_pack_kernel<Bits>, opted,
                                          a.lay.smem);
    if (err != cudaSuccess) return (int)err;
    const int per_block = 32 * a.lay.warps;
    const unsigned grid = (unsigned)((a.B + per_block - 1) / per_block);
    // shared memory for the blocks one wave of this grid puts on an SM
    int dev = 0;
    err = cudaGetDevice(&dev);     // a valid index: allow_shared_memory
    if (err == cudaSuccess && sms[dev] == 0)
        err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const int pct = carveout(a.lay.smem, (int)((grid + sms[dev] - 1) / sms[dev]));
    if (carved[dev] != pct + 1) {
        err = cudaFuncSetAttribute(
            eval_pack_kernel<Bits>,
            cudaFuncAttributePreferredSharedMemoryCarveout, pct);
        if (err != cudaSuccess) return (int)err;
        carved[dev] = pct + 1;
    }
    eval_pack_kernel<Bits>
        <<<grid, per_block, a.lay.smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
#endif

// Queues the kernel on `stream` (the current device's); 0 or a CUDA error.
// The layout says where the pair bits live: registers up to wq_max
// EVAL_REG_W, shared memory past it.
static int launch(const EvalArgs& a, void* stream)
{
    if (a.B <= 0) return 0;
    if (a.lay.warps < 1) return (int)cudaErrorInvalidValue;
    const bool reg_bits = a.lay.bits == 0;
#ifdef EVAL_PACK_HOST
    // the CPU tests' build: every warp in turn, in 16-byte aligned memory
    (void)stream;
    int* ring = (int*)aligned_alloc(
        16, ((size_t)a.lay.slots * a.lay.stage + a.lay.tb5 + a.lay.bits)
                * sizeof(int));
    host_fault = 0;
    for (int b0 = 0; b0 < a.B; b0 += 32) {
        if (reg_bits)
            eval_warp<RegPairBits>(a, ring, b0, min(32, a.B - b0));
        else
            eval_warp<SmemPairBits>(a, ring, b0, min(32, a.B - b0));
    }
    free(ring);
    return host_fault;
#else
    return reg_bits ? launch_kernel<RegPairBits>(a, stream)
                    : launch_kernel<SmemPairBits>(a, stream);
#endif
}

static bool shapes_ok(int wq_max, int wt_max, int n_q, int n_slots,
                      const void* ev_tabs)
{
    return wq_max > 0 && wq_max <= EVAL_MAX_W && wt_max > 0
        && wt_max <= EVAL_MAX_WT && n_q > 0
        && n_slots > 0
        && ((uintptr_t)ev_tabs & 15) == 0;
}

// The layout a launch at this window width takes, with the step's wq_max
// (wt_max - 8): pitch, stage, slots, tpitch, tb5, warps, shared memory
// bytes; the carveout it asks for when `blocks` blocks share an SM; the
// columns of a piece and the words of a warp's pair bits (what the CPU
// tests check and chip_smoke.py reports).
extern "C" void eval_pack_layout(int wt_max, int blocks, int* out)
{
    const EvalLayout l = eval_layout(wt_max, wt_max - 8);
    out[0] = l.pitch; out[1] = l.stage; out[2] = l.slots; out[3] = l.tpitch;
    out[4] = l.tb5; out[5] = l.warps; out[6] = l.smem;
    out[7] = carveout(l.smem, blocks);
    out[8] = l.piece; out[9] = l.bits;
}

// A panel's part of the arguments, checked and laid out once: the tables,
// the shapes, the constants and the card.  The lean call fills in a chunk.
struct EvalPlan {
    EvalArgs a;
    int device;
};

extern "C" int eval_pack_plan_bytes() { return (int)sizeof(EvalPlan); }

// Fills `plan` (eval_pack_plan_bytes() bytes, 8-byte aligned); 0, or
// cudaErrorInvalidValue where the shapes or the table alignment are refused
// or the layout does not fit in a block's shared memory.
extern "C" int eval_pack_plan(
    void* plan, const void* qc, const void* ev_tabs, const void* ev_loop,
    int wq_max, int wt_max, int n_q, int n_slots, float AT_H, float AT_S,
    float init_H, float init_S, int device)
{
    if (!shapes_ok(wq_max, wt_max, n_q, n_slots, ev_tabs))
        return (int)cudaErrorInvalidValue;
    const EvalLayout lay = eval_layout(wt_max, wq_max);
    if (lay.warps < 1) return (int)cudaErrorInvalidValue;
    EvalPlan* p = (EvalPlan*)plan;
    p->a = EvalArgs{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, (const int*)qc,
                    (const float4*)ev_tabs, (const float*)ev_loop, nullptr,
                    0, wq_max, wt_max, n_q, n_slots,
                    AT_H, AT_S, init_H, init_S, lay};
    p->device = device;
    return 0;
}

// The lean call's launch: a chunk of B entries under a plan, on the plan's
// card (made current for the launch and restored), on `stream`.
extern "C" int eval_pack_launch_plan(
    const void* plan, const void* mrows, const void* mgmax, const void* tb5,
    const void* slot, const void* ql, const void* wt_e,
    const void* needs_host, const void* ent_valid, void* out, int B,
    void* stream)
{
    EvalArgs a = ((const EvalPlan*)plan)->a;
    a.mrows = (const int*)mrows; a.mgmax = (const int*)mgmax;
    a.tb5 = (const int*)tb5; a.slot = (const int*)slot;
    a.ql = (const int*)ql; a.wt_e = (const int*)wt_e;
    a.needs_host = (const uint8_t*)needs_host;
    a.ent_valid = (const uint8_t*)ent_valid;
    a.out = (int*)out;
    a.B = B;
#ifdef EVAL_PACK_HOST
    return launch(a, stream);
#else
    const int dev = ((const EvalPlan*)plan)->device;
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != dev) err = cudaSetDevice(dev);
    if (err != cudaSuccess) return (int)err;
    const int rc = launch(a, stream);
    if (cur != dev) {
        err = cudaSetDevice(cur);
        if (rc == 0 && err != cudaSuccess) return (int)err;
    }
    return rc;
#endif
}
