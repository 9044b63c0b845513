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
// some 25 small launches a call; here one thread owns one entry, and the
// launch covers the whole pooled stream.  Where the JAX step skips a chunk
// that lies wholly past the pool (lax.cond), this launch lets the entries
// past the pool leave at once: an entry whose slot is outside [0, num_os)
// reads nothing more and writes zeros in all six outputs, and the stream's
// stable sort puts every such entry after the valid ones.
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
//
// What the design does about it, in this first form: one thread an entry,
// the stream's scalars read coalesced; the slot-major order makes
// neighbouring threads read neighbouring words of one fragment, so the word
// gathers mostly hit the same lines (through the read-only path, __ldg).
// The columns are produced in order and the covering word is re-read
// through L1 when a column leaves the previous one's word, rather than kept
// in a dynamically indexed array of up to 22 words, which would live in
// local memory.  A thread stores its rows 16 bytes at a time between a head
// and a tail of single words where the rows lie on the same 16-byte grid
// (row b starts at b * wt_max words: 16-byte aligned only when wt_max % 4 ==
// 0), else word by word.  Neighbouring threads' rows are neighbouring, so a
// warp's stores cover one contiguous span.  One run-time path takes every
// wt_max up to MAX_WT and every word length a panel uses.
//
// The host build (-DWIN_DECODE_HOST, tests/test_torch_win_decode.py, g++
// behind tests/cuda_host_shim/cuda_runtime.h): one host thread decodes the
// entries in turn through the same decode_entry; its 16-byte stores go
// through the shim's checked copy, which refuses an address off 16 bytes
// (the launch returns 716, as the card would fail).

#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_FLANK_BASE 4    // constants.py NUM_FLANK_BASE
#define NUM_T5 5            // ops/thermo_dp.py NUM_T5
#define MAX_WT 128          // ops/screen_dp.py MAX_WT
#define MAX_WORD_LEN 15     // ops/win_decode.py MAX_WORD_LEN
#define DECODE_THREADS 256

struct DecodeArgs {
    const int *slot, *p, *frag, *frag_lens, *word;
    const uint8_t* word_valid;
    const int* slot_ql;
    const uint8_t* slot_minus;
    uint8_t* needs_host;
    int *tb5, *ptb, *ql, *wt_e;
    uint8_t* ent_valid;
    int B, n, L, wt_max, word_len, nw_pos, num_os;
};

__device__ void decode_entry(const DecodeArgs& a, int b);

#ifdef WIN_DECODE_HOST
// the CPU tests' build: every entry in turn; 16-byte stores checked
static void store_16(int* dst, int4 v) { host_copy(dst, &v.x, 16); }

static int run(const DecodeArgs& a, int device, void* stream)
{
    (void)device;
    (void)stream;
    host_fault = 0;
    for (int b = 0; b < a.B; ++b) decode_entry(a, b);
    return host_fault;
}
#else
__device__ __forceinline__ void store_16(int* dst, int4 v)
{
    *reinterpret_cast<int4*>(dst) = v;
}

__global__ void __launch_bounds__(DECODE_THREADS)
win_decode_kernel(const DecodeArgs a)
{
    const int b = blockIdx.x * DECODE_THREADS + threadIdx.x;
    if (b < a.B) decode_entry(a, b);
}

// Queues the kernel on `stream` on card `device` (made current for the
// launch and restored); 0 or a CUDA error.
static int run(const DecodeArgs& a, int device, void* stream)
{
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((a.B + DECODE_THREADS - 1)
                                     / DECODE_THREADS);
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

// The codes of one window, column by column: code(r) is the 2-bit code of
// window column r (0 <= r < wt_max) on the plus strand.  It keeps the last
// covering word it read and reads another (through the read-only cache)
// when r leaves it; the columns are asked for in order, ascending on the
// plus strand and descending on the minus strand, so each word is read
// once a window.
struct Window {
    const int* words;   // the fragment's word row
    int start_c, nw_pos, word_len;
    int k, w;           // the word index held, and its value

    __device__ __forceinline__ int code(int r)
    {
        const int kr = r / word_len;
        if (kr != k) {
            k = kr;
            w = __ldg(words + clampi(start_c + kr * word_len, 0, nw_pos - 1));
        }
        return (w >> (2 * (word_len - 1 - (r - kr * word_len)))) & 3;
    }
};

// The words before a row's first 16-byte boundary, or the whole row where
// the two rows of an entry do not lie on the same 16-byte grid.
__device__ __forceinline__ int vector_head(const int* t, const int* p, int wt)
{
    const uintptr_t at = (uintptr_t)t & 15, ap = (uintptr_t)p & 15;
    if (at != ap || (at & 3)) return wt;
    return min(wt, (int)(((16 - at) & 15) >> 2));
}

__device__ void decode_entry(const DecodeArgs& a, int b)
{
    const int wt = a.wt_max;
    int* trow = a.tb5 + (size_t)b * wt;
    int* prow = a.ptb + (size_t)b * wt;
    const int slot = a.slot[b];
    const bool valid = slot >= 0 && slot < a.num_os;

    int wt_e = 0, ql = 0;
    bool minus = false, host = false;
    Window win{nullptr, 0, a.nw_pos, a.word_len, -1, 0};
    if (valid) {
        ql = __ldg(a.slot_ql + slot);
        minus = __ldg(a.slot_minus + slot) != 0;
        wt_e = ql + 2 * NUM_FLANK_BASE;
        const int fi = clampi(a.frag[b], 0, a.n - 1);
        const int start = a.p[b] - NUM_FLANK_BASE;
        const bool full_win =
            start >= 0 && start + wt_e <= __ldg(a.frag_lens + fi);
        win.words = a.word + (size_t)fi * a.nw_pos;
        win.start_c = clampi(start, 0, a.L - wt);
        const uint8_t* valid_row = a.word_valid + (size_t)fi * a.nw_pos;
        bool clean = true;
        for (int k = 0; clean && k * a.word_len < wt_e
                     && k * a.word_len < wt; ++k) {
            const int wpos = win.start_c + k * a.word_len;
            clean = wpos <= a.nw_pos - 1
                && __ldg(valid_row + clampi(wpos, 0, a.nw_pos - 1)) != 0;
        }
        host = !full_win || !clean;
    }
    a.needs_host[b] = host;
    a.ent_valid[b] = valid;
    a.ql[b] = ql;
    a.wt_e[b] = wt_e;

    // tb5 of column j (0 past wt_e and for an entry past the pool)
    auto tb5_at = [&](int j) -> int {
        if (j >= wt_e) return 0;
        if (!minus) return win.code(j);
        return 3 - win.code(clampi(wt_e - 1 - j, 0, wt - 1));
    };
    // ptb from the previous column's code; an entry past the pool is zeros
    int prev = 5;
    auto ptb_of = [&](int t) -> int {
        const int v = valid ? prev * NUM_T5 + t : 0;
        prev = t;
        return v;
    };
    const int head = vector_head(trow, prow, wt);
    int j = 0;
    for (; j < head; ++j) {
        const int t = tb5_at(j);
        trow[j] = t;
        prow[j] = ptb_of(t);
    }
    for (; j + 4 <= wt; j += 4) {
        int4 t4, p4;
        t4.x = tb5_at(j);
        p4.x = ptb_of(t4.x);
        t4.y = tb5_at(j + 1);
        p4.y = ptb_of(t4.y);
        t4.z = tb5_at(j + 2);
        p4.z = ptb_of(t4.z);
        t4.w = tb5_at(j + 3);
        p4.w = ptb_of(t4.w);
        store_16(trow + j, t4);
        store_16(prow + j, p4);
    }
    for (; j < wt; ++j) {
        const int t = tb5_at(j);
        trow[j] = t;
        prow[j] = ptb_of(t);
    }
}

// The decode of B entries; 0, or cudaErrorInvalidValue where a shape is
// refused, or the launch's CUDA error.  Pointers: the inputs slot, p, frag,
// frag_lens, word, word_valid, slot_ql, slot_minus, then the outputs
// needs_host, tb5, ptb, ql, wt_e, ent_valid (ops/win_decode.py).
extern "C" int win_decode_launch(
    const void* slot, const void* p, const void* frag, const void* frag_lens,
    const void* word, const void* word_valid, const void* slot_ql,
    const void* slot_minus, void* needs_host, void* tb5, void* ptb, void* ql,
    void* wt_e, void* ent_valid, int B, int n, int L, int wt_max,
    int word_len, int nw_pos, int num_os, int device, void* stream)
{
    if (B <= 0) return 0;
    if (wt_max < 1 || wt_max > MAX_WT || word_len < 1
        || word_len > MAX_WORD_LEN || n < 1 || nw_pos < 1 || num_os < 0)
        return (int)cudaErrorInvalidValue;
    const DecodeArgs a{
        (const int*)slot, (const int*)p, (const int*)frag,
        (const int*)frag_lens, (const int*)word, (const uint8_t*)word_valid,
        (const int*)slot_ql, (const uint8_t*)slot_minus,
        (uint8_t*)needs_host, (int*)tb5, (int*)ptb, (int*)ql, (int*)wt_e,
        (uint8_t*)ent_valid, B, n, L, wt_max, word_len, nw_pos, num_os};
    return run(a, device, stream);
}
