// Window decode of the device seed+screen step, as one kernel for the Hopper
// SM (sm_90a): for every entry of the pooled candidate stream, the slot's
// oligo length and window width, whether the window needs the host, and the
// window's codes in the two layouts the next kernels read (tb5 for
// eval_pack.cu, ptb for screen_dp.cu).
//
// Replaces no Pallas kernel.  In the JAX package this stage is the closures
// slot_scalars and win_decode of tntblast_tpu/parallel/device_search.py
// (_panel_step), fused by XLA inside the jitted step.  The plain PyTorch
// version beside this kernel (ops/win_decode.py::win_decode_reference) is
// some 25 small launches a call; here one launch covers the whole pooled
// stream.  Where the JAX step skips a chunk that lies wholly past the pool
// (lax.cond), this launch lets the entries past the pool off lightly: an
// entry whose slot is outside [0, num_os) reads nothing more and writes
// zeros in all six outputs, and the stream's stable sort puts every such
// entry after the valid ones.
//
// Per valid entry b (slot s, diagonal p, fragment fi clamped into [0, n)),
// exactly the plain version:
//   1. ql = slot_ql[s], minus = slot_minus[s], wt_e = ql + 2 * NUM_FLANK_BASE;
//   2. start = p - NUM_FLANK_BASE, full_win = start >= 0 and
//      start + wt_e <= frag_lens[fi], start_c = clamp(start, 0, L - wt_max)
//      (the upper bound wins where L < wt_max, as torch.clamp's does);
//   3. covering word k (k * word_len < wt_e) sits at wpos = start_c +
//      k * word_len; its validity is read at fi * nw_pos + clamp(wpos, 0,
//      nw_pos - 1), and a word whose wpos lies past nw_pos - 1 disqualifies
//      the window: the clamp must never read a DIFFERENT position's
//      validity.  clean = every covering word valid;
//   4. column j's code is bits 2 * (word_len - 1 - j % word_len) of word
//      j / word_len (gathered at the same clamped position); on the minus
//      strand column j is the complement of column clamp(wt_e - 1 - j, 0,
//      wt_max - 1): the reversal within the true width;
//   5. tb5[j] = code (0 for j >= wt_e), ptb[j] = (j == 0 ? 5 : tb5[j - 1]) *
//      NUM_T5 + tb5[j], needs_host = !full_win || !clean.
// Integer arithmetic throughout, so the kernel equals the plain version bit
// for bit by construction.
//
// What bounds it on the H100: bytes.  An entry writes its two rows of
// wt_max words and 10 bytes of scalars (8 * wt_max + 10 bytes) and reads its
// slot; a valid one reads its p and fragment and up to ceil(wt_max /
// word_len) words of 4 bytes with their validity bytes.  At the bench's
// shapes (wt_max 32, 7-base words, 360448 entries a step) that is about
// 96 MB of writes and a few MB of reads: 0.03 ms at HBM3's 3.35e12 B/s.
// The rows are nine tenths of it, so the design is about storing them.
//
// What the design does about it.  A block owns DECODE_ENTRIES consecutive
// entries b0 .. b0 + E - 1.  Their tb5 rows are one contiguous span of
// E * wt_max words, and so are their ptb rows; the span starts
// b0 * wt_max * 4 bytes past the output's base, a multiple of 16 bytes.
// - Phase 1, one thread an entry: the entry's scalars as above, stored
//   coalesced (neighbouring threads, neighbouring entries), and what phase
//   2 needs of it kept in shared memory: its word row, start_c, wt_e (0
//   past the pool) and its two flags, whatever wt_max is.  A block barrier.
// - Phase 2, the spans: the block's threads walk each span in flat order,
//   four consecutive words a thread, the thread's next four words
//   4 * DECODE_THREADS further on.  A thread computes its words' tb5 and
//   ptb from the entries' scalars in shared memory and the covering words
//   (through the read-only path, __ldg; neighbouring threads on one entry
//   read the same word, and the slot-major order makes neighbouring entries
//   read neighbouring words of one fragment), then stores one 16-byte int4
//   into each span, so a warp's store instruction writes 512 contiguous
//   bytes.  Four words may cross from one entry into the next (wt_max % 4
//   != 0): the walk then starts the next entry's column 0, whose ptb takes
//   the code 5 before it, never the previous entry's last column.  The
//   span's (row, column) walk is kept without a division a step.  Only the
//   block's last, partial span (B * wt_max % 4 != 0) and an output whose
//   base is off 16 bytes take word stores.
// - r / word_len is (r * word_inv) >> 16 with word_inv = ceil(2^16 /
//   word_len): exact for every column r < MAX_WT and word_len <= 15, since
//   r * (word_inv * word_len - 2^16) <= r * (word_len - 1) < 1032 * 14 <
//   2^16 (it stays exact up to r < 4369).  A block's spans, 128 entries of
//   up to MAX_WT words, hold 132096 words: int indices.
// One run-time path takes every wt_max up to MAX_WT and every word length
// up to MAX_WORD_LEN.  The panel's part of the arguments (the slot tables
// and the static shapes) is checked once, in win_decode_plan(); the step's
// call, win_decode_launch_plan(), takes the stream's pointers, B and n
// (ops/win_decode.py, WinDecodePlan).
//
// The host build (-DWIN_DECODE_HOST, tests/test_torch_win_decode.py, g++
// behind tests/cuda_host_shim/cuda_runtime.h): one host thread plays a
// block's threads phase by phase (every thread's scalars, then every
// thread's part of the spans) through the thread loops below, which run
// over one thread on the card (BLOCK_THREADS), with the block's shared
// scalars in a local struct.  Its 16-byte stores go through the shim's
// checked copy, which refuses an address off 16 bytes (the launch returns
// 716, as the card would fail).

#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_FLANK_BASE 4    // constants.py NUM_FLANK_BASE
#define NUM_T5 5            // ops/thermo_dp.py NUM_T5
#define MAX_WT 1032         // ops/screen_dp.py MAX_WT
#define MAX_WORD_LEN 15     // ops/win_decode.py MAX_WORD_LEN
#define DECODE_ENTRIES 128  // entries a block owns
#define DECODE_THREADS DECODE_ENTRIES   // phase 1 takes one thread an entry

struct DecodeArgs {
    const int *slot, *p, *frag, *frag_lens, *word;
    const uint8_t* word_valid;
    const int* slot_ql;
    const uint8_t* slot_minus;
    uint8_t* needs_host;
    int *tb5, *ptb, *ql, *wt_e;
    uint8_t* ent_valid;
    int B, n, L, wt_max, word_len, nw_pos, num_os;
    int word_inv;           // ceil(2^16 / word_len)
};

// What phase 2 reads of the block's entries, written by phase 1.
struct DecodeShared {
    const int* row[DECODE_ENTRIES];     // the fragment's word row
    int start_c[DECODE_ENTRIES];
    int wt_e[DECODE_ENTRIES];           // 0 past the pool
    int flags[DECODE_ENTRIES];          // valid | minus << 1
};

__device__ void decode_block(const DecodeArgs& a, DecodeShared& s, int b0);

#ifdef WIN_DECODE_HOST
#define BLOCK_THREADS DECODE_THREADS    // the host thread plays every thread
#define THREAD(i) (i)
static void store_16(int* dst, int4 v) { host_copy(dst, &v.x, 16); }

// the CPU tests' build: every block in turn, 16-byte stores checked
static int run(const DecodeArgs& a, int device, void* stream)
{
    (void)device;
    (void)stream;
    host_fault = 0;
    DecodeShared s;
    for (int b0 = 0; b0 < a.B; b0 += DECODE_ENTRIES) decode_block(a, s, b0);
    return host_fault;
}
#else
#define BLOCK_THREADS 1                 // a thread plays itself
#define THREAD(i) ((int)threadIdx.x)
__device__ __forceinline__ void store_16(int* dst, int4 v)
{
    *reinterpret_cast<int4*>(dst) = v;
}

__global__ void __launch_bounds__(DECODE_THREADS)
win_decode_kernel(const DecodeArgs a)
{
    __shared__ DecodeShared s;
    decode_block(a, s, (int)blockIdx.x * DECODE_ENTRIES);
}

// Queues the kernel on `stream` on card `device` (made current for the
// launch and restored); 0 or a CUDA error.
static int run(const DecodeArgs& a, int device, void* stream)
{
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((a.B + DECODE_ENTRIES - 1)
                                     / DECODE_ENTRIES);
    win_decode_kernel<<<grid, DECODE_THREADS, 0, (cudaStream_t)stream>>>(a);
    int rc = (int)cudaGetLastError();
    if (cur != device) {
        err = cudaSetDevice(cur);
        if (rc == 0 && err != cudaSuccess) rc = (int)err;
    }
    return rc;
}
#endif

__host__ __device__ __forceinline__ int clampi(int x, int lo, int hi)
{
    return min(max(x, lo), hi);
}

// Phase 1 for thread t: the scalars of entry b0 + t, stored, and kept in
// shared memory for phase 2.
__device__ void decode_scalars(const DecodeArgs& a, DecodeShared& s, int b0,
                               int t)
{
    const int b = b0 + t;
    if (b >= a.B) return;
    const int slot = a.slot[b];
    const bool valid = slot >= 0 && slot < a.num_os;
    int wt_e = 0, ql = 0, start_c = 0;
    bool minus = false, host = false;
    const int* row = nullptr;
    if (valid) {
        ql = __ldg(a.slot_ql + slot);
        minus = __ldg(a.slot_minus + slot) != 0;
        wt_e = ql + 2 * NUM_FLANK_BASE;
        const int fi = clampi(a.frag[b], 0, a.n - 1);
        const int start = a.p[b] - NUM_FLANK_BASE;
        const bool full_win =
            start >= 0 && start + wt_e <= __ldg(a.frag_lens + fi);
        row = a.word + (size_t)fi * a.nw_pos;
        start_c = clampi(start, 0, a.L - a.wt_max);
        const uint8_t* valid_row = a.word_valid + (size_t)fi * a.nw_pos;
        bool clean = true;
        for (int k = 0; clean && k * a.word_len < wt_e
                     && k * a.word_len < a.wt_max; ++k) {
            const int wpos = start_c + k * a.word_len;
            clean = wpos <= a.nw_pos - 1
                && __ldg(valid_row + clampi(wpos, 0, a.nw_pos - 1)) != 0;
        }
        host = !full_win || !clean;
    }
    a.needs_host[b] = host;
    a.ent_valid[b] = valid;
    a.ql[b] = ql;
    a.wt_e[b] = wt_e;
    s.row[t] = row;
    s.start_c[t] = start_c;
    s.wt_e[t] = wt_e;
    s.flags[t] = (valid ? 1 : 0) | (minus ? 2 : 0);
}

// One entry as phase 2 reads it from shared memory.
struct Entry {
    const int* row;
    int start_c, wt_e;
    bool valid, minus;

    __device__ __forceinline__ Entry(const DecodeShared& s, int e)
        : row(s.row[e]), start_c(s.start_c[e]), wt_e(s.wt_e[e]),
          valid((s.flags[e] & 1) != 0), minus((s.flags[e] & 2) != 0) {}

    // tb5 of column j (0 past wt_e, and for an entry past the pool, whose
    // wt_e is 0: nothing is read)
    __device__ __forceinline__ int tb5(const DecodeArgs& a, int j) const
    {
        if (j >= wt_e) return 0;
        const int r = minus ? clampi(wt_e - 1 - j, 0, a.wt_max - 1) : j;
        const int k = (r * a.word_inv) >> 16;
        const int w = __ldg(row + clampi(start_c + k * a.word_len, 0,
                                         a.nw_pos - 1));
        const int c = (w >> (2 * (a.word_len - 1 - (r - k * a.word_len))))
            & 3;
        return minus ? 3 - c : c;
    }
};

// n (1..4) words at dst: one 16-byte store where all four are there and
// the output's base lies on 16 bytes, else word by word.
__device__ __forceinline__ void store_words(int* dst, const int (&v)[4],
                                            int n, bool vec)
{
    if (n == 4 && vec) {
        store_16(dst, int4{v[0], v[1], v[2], v[3]});
        return;
    }
    for (int i = 0; i < n; ++i) dst[i] = v[i];
}

// Phase 2 for thread t: its words of the block's two spans.
__device__ void decode_span(const DecodeArgs& a, const DecodeShared& s,
                            int b0, int t)
{
    const int wt = a.wt_max;
    const int len = min(DECODE_ENTRIES, a.B - b0) * wt;
    int* const trow = a.tb5 + (size_t)b0 * wt;
    int* const prow = a.ptb + (size_t)b0 * wt;
    const bool t16 = ((uintptr_t)a.tb5 & 15) == 0;
    const bool p16 = ((uintptr_t)a.ptb & 15) == 0;
    // word f of the span is column j of entry e; a step moves 4 * THREADS
    // words on, dq entries and dr columns
    const int step = 4 * DECODE_THREADS, dq = step / wt, dr = step % wt;
    int f = 4 * t, e = f / wt, j = f % wt;
    for (; f < len; f += step) {
        const int n = min(4, len - f);
        int tv[4] = {0, 0, 0, 0}, pv[4] = {0, 0, 0, 0};
        Entry en(s, e);
        int prev = j == 0 ? 5 : en.tb5(a, j - 1);
        int ee = e, jj = j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (i >= n) break;
            if (jj == wt) {             // column 0 of the next entry
                jj = 0;
                prev = 5;
                en = Entry(s, ++ee);
            }
            const int code = en.tb5(a, jj);
            tv[i] = code;
            pv[i] = en.valid ? prev * NUM_T5 + code : 0;
            prev = code;
            ++jj;
        }
        store_words(trow + f, tv, n, t16);
        store_words(prow + f, pv, n, p16);
        e += dq;
        j += dr;
        if (j >= wt) {
            j -= wt;
            ++e;
        }
    }
}

// The block of entries b0 .. b0 + DECODE_ENTRIES - 1: phase 1 in every
// thread, a barrier, phase 2 in every thread.
__device__ void decode_block(const DecodeArgs& a, DecodeShared& s, int b0)
{
    for (int i = 0; i < BLOCK_THREADS; ++i)
        decode_scalars(a, s, b0, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i)
        decode_span(a, s, b0, THREAD(i));
}

// A panel's part of the arguments, checked once: the slot tables, the
// static shapes and the card.  The step's call fills in the stream.
struct DecodePlan {
    DecodeArgs a;
    int device;
};

extern "C" int win_decode_plan_bytes() { return (int)sizeof(DecodePlan); }

// Fills `plan` (win_decode_plan_bytes() bytes, 8-byte aligned); 0, or
// cudaErrorInvalidValue where a shape is refused.
extern "C" int win_decode_plan(
    void* plan, const void* slot_ql, const void* slot_minus, int L,
    int wt_max, int word_len, int nw_pos, int num_os, int device)
{
    if (wt_max < 1 || wt_max > MAX_WT || word_len < 1
        || word_len > MAX_WORD_LEN || nw_pos < 1 || num_os < 0)
        return (int)cudaErrorInvalidValue;
    DecodePlan* p = (DecodePlan*)plan;
    p->a = DecodeArgs{
        nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        (const int*)slot_ql, (const uint8_t*)slot_minus, nullptr, nullptr,
        nullptr, nullptr, nullptr, nullptr, 0, 0, L, wt_max, word_len,
        nw_pos, num_os, ((1 << 16) + word_len - 1) / word_len};
    p->device = device;
    return 0;
}

// The step's call: the decode of B entries on n fragments under a plan, on
// the plan's card, on `stream`; 0, cudaErrorInvalidValue for n < 1, or the
// launch's CUDA error.
extern "C" int win_decode_launch_plan(
    const void* plan, const void* slot, const void* p, const void* frag,
    const void* frag_lens, const void* word, const void* word_valid,
    void* needs_host, void* tb5, void* ptb, void* ql, void* wt_e,
    void* ent_valid, int B, int n, void* stream)
{
    if (n < 1) return (int)cudaErrorInvalidValue;
    if (B <= 0) return 0;
    DecodeArgs a = ((const DecodePlan*)plan)->a;
    a.slot = (const int*)slot; a.p = (const int*)p; a.frag = (const int*)frag;
    a.frag_lens = (const int*)frag_lens; a.word = (const int*)word;
    a.word_valid = (const uint8_t*)word_valid;
    a.needs_host = (uint8_t*)needs_host; a.tb5 = (int*)tb5;
    a.ptb = (int*)ptb; a.ql = (int*)ql; a.wt_e = (int*)wt_e;
    a.ent_valid = (uint8_t*)ent_valid;
    a.B = B;
    a.n = n;
    return run(a, ((const DecodePlan*)plan)->device, stream);
}

// The whole decode in one call, a plan made for it: what the host build's
// tests and an earlier version's callers use.  Pointers: the inputs slot,
// p, frag, frag_lens, word, word_valid, slot_ql, slot_minus, then the
// outputs needs_host, tb5, ptb, ql, wt_e, ent_valid (ops/win_decode.py).
extern "C" int win_decode_launch(
    const void* slot, const void* p, const void* frag, const void* frag_lens,
    const void* word, const void* word_valid, const void* slot_ql,
    const void* slot_minus, void* needs_host, void* tb5, void* ptb, void* ql,
    void* wt_e, void* ent_valid, int B, int n, int L, int wt_max,
    int word_len, int nw_pos, int num_os, int device, void* stream)
{
    DecodePlan plan;
    const int rc = win_decode_plan(&plan, slot_ql, slot_minus, L, wt_max,
                                   word_len, nw_pos, num_os, device);
    if (rc != 0) return rc;
    return win_decode_launch_plan(&plan, slot, p, frag, frag_lens, word,
                                  word_valid, needs_host, tb5, ptb, ql, wt_e,
                                  ent_valid, B, n, stream);
}
