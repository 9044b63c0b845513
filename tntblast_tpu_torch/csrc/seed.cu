// Seeding of the device seed+screen step, as three launches of hand-written
// kernels for the Hopper SM (sm_90a): from one step's packed payload and the
// panel's seed tables, every fragment's target words and their validity, and
// its seed candidates, the unique (diagonal, slot) keys of the word-table
// path in (diagonal, slot) order.
//
// Replaces no Pallas kernel.  In the JAX package this stage is the payload
// unpack of tntblast_tpu/parallel/device_search.py (panel_step_core,
// :434-457) and the table path of _seed_fragment (:102-217) under its
// fragment vmap (:464), fused by XLA inside the jitted step.  Its plain
// PyTorch version (ops/seed.py::seed_reference) is a few hundred tensor ops
// with a library sort in the middle; here there is no sort at all.
//
// What it computes, per fragment f of length flen in a tile of L positions
// (word length w, nw_pos = L - w + 1 words, max_words MW, cap):
//   codes[x], x < L, in this order of overrides (the JAX unpack's):
//     1. the 2-bit base, (packed[x / 4] >> 2 * (x % 4)) & 3;
//     2. DB_UNKNOWN at x >= flen;
//     3. DB_N where the N-run count #{s_i <= x} - #{e_i <= x} is > 0 (trap:
//        the JAX form is cumsum(delta) > 0 with both ends clamped to [0, L];
//        for x in [0, L) it is this count, for runs that overlap, touch the
//        ends or come unsorted, so a block takes it at its span's start
//        and need not scan the fragment from 0);
//     4. the exceptions last: code exc_c[i] at clamp(exc_p[i], 0, L), pads
//        at L dropped (trap: see what the kernel relies on, below).
//   word[q] = the codes' low two bits over [q, q + w), at EVERY q < nw_pos:
//     padding, N runs and exceptions too (trap: the window decode and kmin
//     read word, so a kernel that skipped or zeroed invalid positions would
//     differ); word_valid[q] = q < flen - w + 1 and every code <= DB_T.
//   in-positions: q with word_valid and a word some oligo holds (VF[word]
//     bit 0), the first cap of them by position (trap: truncation happens
//     before the dedup; an overflowing fragment's keys must match too).
//   keys: (p, s) with p = q - k for an in-position q and a lane (s, k) of
//     its word: s among the s_max lowest slots holding the word, k among
//     the k_max lowest word indices of that slot's oligo.  KS[v][k] is the
//     set of slots s whose lane (s, k) exists for word value v, a
//     panel-static table (ops/seed.py::seed_tables), so the slots of
//     diagonal p are U[p] = OR over in-positions q = p + k of KS[word[q]][k]
//     and the unique keys are the set bits of U.  Key order (p + MW) * num_os
//     + s is diagonal first, slot second: walking the diagonals in order and
//     each U[p]'s bits from the lowest (trap: slot 31 of lane 0 and slot 63
//     are bits 31 and 63 of a 64-bit set, found by __ffsll on the unsigned
//     value) emits the sorted unique keys with no sort.
//   slot/p: the first cap keys, 0 past them; n_cand: the number of keys;
//   counts[s]: the keys of slot s over all of them; overflow: more than cap
//   in-positions, or an in-position whose word has more slots than s_max or
//   a slot with more word indices than k_max (VF[word] bit 1), or n_cand >
//   cap.
//
// The three launches (a block: SEED_THREADS threads over SEED_SPAN
// positions or diagonals of one fragment; grid (blocks, n)):
//  1. words: the block's codes in shared memory (its span plus w - 1), from
//     the packed bytes, flen, the N-run count at its span's start (a
//     reduction over the fragment's runs: the count is a sum of +-1 terms,
//     valid for runs that overlap, touch the ends or are not sorted, so no
//     block scans the fragment from 0) and its span's run ends (shared
//     atomics into a delta array, then a block scan), then the exceptions
//     that fall in it; writes word and word_valid, the in-position bits
//     (before truncation) and the block's count of them.  Block 0 zeroes the
//     fragment's counts and overflow flag.
//  2. sets: the block's diagonals p in [j * SPAN - MW + 1, (j + 1) * SPAN -
//     MW + 1) read the in-position bits of [j * SPAN - 32, (j + 1) * SPAN);
//     launch 1's counts before the block give each bit's rank, and bits of
//     rank >= cap are dropped (the truncation; a drop flags the fragment);
//     U[p] from the KS table; the block's number of keys, the per-slot
//     counts (shared atomics, then one integer atomic a slot: exact in any
//     order) and the residue flag.
//  3. emit: the same U[p] again, the block's offset from launch 2's counts
//     before it, a block scan of the threads' key counts, and each thread's
//     keys stored in order below cap; the fragment's slots past its n_cand
//     zero-filled, split over its blocks; block 0 writes n_cand and
//     overflow.
// Integer arithmetic throughout: the kernel equals the plain version bit for
// bit by construction.
//
// What the kernel relies on.  frag_lens, runs and exceptions as the panel
// packs them (DevicePanel._pack_host): each exception position at most once
// (two codes for one position would race here, as they would in the JAX
// scatter); their order does not matter, and pads anywhere in the list are
// dropped.  Run ends in any order, overlapping or not.  The KS and VF tables
// of the panel's w_table (the plan holds them).
//
// What bounds it on the H100: bytes.  A bench step (8 fragments of 2^19, w
// 7, cap 45056) reads 1 MB of packed bases, 0.1 MB of runs and exceptions,
// the 16 KB VF table and the KS rows of the words at its in-positions (at
// most the 720 words the 40 slots hold, 144 B a row: 0.1 MB), and writes
// 16.8 MB of words, 4.2 MB of validity and 2.9 MB of slot/p: about 25 MB,
// 0.0075 ms at 3.35e12 B/s.  Launch 1 is that
// store stream (coalesced: thread t of a block writes positions t, t + 256,
// ...); launches 2 and 3 read 0.5 MB of bits and the words of the
// in-positions again (4% of positions here) and write the keys.
//
// The host build (-DSEED_HOST, tests/test_torch_seed.py, g++ behind
// tests/cuda_host_shim/cuda_runtime.h): the grid block by block, and a
// block's threads phase by phase through the thread loops below, which run
// over one thread on the card (BLOCK_THREADS); what a thread carries across
// a barrier lives in the block's shared struct.

#include <cuda_runtime.h>
#include <stdint.h>

#define SEED_THREADS 256
#define SEED_SPAN 2048      // positions (launch 1) or diagonals (2, 3) a block
#define SEED_PER_THREAD (SEED_SPAN / SEED_THREADS)
#define SEED_HALO 32        // in-position bits before a block's diagonals
#define SEED_RANGE (SEED_HALO + SEED_SPAN)
#define SEED_RANGE_WORDS (SEED_RANGE / 32 + 1)  // and one word of zeros
#define MAX_WORD_LEN 8      // ops/seed.py MAX_WORD_LEN
#define MAX_WORDS 31        // ops/seed.py MAX_WORDS: MW + HALO's bound
#define MAX_SLOTS 64        // ops/seed.py MAX_SLOTS: a 64-bit slot set
#define DB_MAX_ATGC 3       // constants.py DB_T
#define DB_N 15             // constants.py DB_N
#define DB_UNKNOWN 17       // constants.py DB_UNKNOWN

struct SeedArgs {
    const uint8_t* packed;          // (n, L / 4)
    const int *frag_lens, *nrun_s, *nrun_e, *exc_p;
    const uint8_t* exc_c;
    const unsigned long long* ks;   // (4^w, MW) slot sets
    const uint8_t* vf;              // (4^w,) 1: held, 2: residue
    int *slot, *p, *n_cand, *counts;
    uint8_t* overflow;
    int* word;
    uint8_t* word_valid;
    int *cnt1, *cnt2;               // scratch: in-positions / keys a block
    unsigned* bits;                 // scratch: in-position bits
    int* oflag;                     // scratch: truncation or residue
    int n, L, word_len, nw_pos, num_os, max_words, cap, n_runs, n_exc;
    int nb1, nb2, nbits;            // blocks of launch 1, of 2 and 3; bit
                                    // words a fragment
};

// Launch 1's block: its span's codes and what the scans carry.
struct WordsShared {
    int delta[SEED_SPAN + MAX_WORD_LEN];    // run starts - run ends
    int scan[2][SEED_THREADS];
    int part[SEED_THREADS];
    uint8_t code[SEED_SPAN + MAX_WORD_LEN];
    uint8_t in[SEED_SPAN];
    int nbase, count;
};

// Launches 2 and 3's block: its diagonals' slot sets.
struct DiagShared {
    unsigned long long u[SEED_SPAN];
    int wv[SEED_RANGE];                     // words at in-positions
    int scan[2][SEED_THREADS];
    int part[SEED_THREADS];
    int scount[MAX_SLOTS];
    unsigned raw[SEED_RANGE_WORDS], eff[SEED_RANGE_WORDS];
    int base, before, total, flag;
};

__device__ void words_block(const SeedArgs& a, WordsShared& s, int f, int j);
template <bool EMIT>
__device__ void diag_block(const SeedArgs& a, DiagShared& s, int f, int j);

#ifdef SEED_HOST
#define BLOCK_THREADS SEED_THREADS      // the host thread plays every thread
#define THREAD(i) (i)

// the CPU tests' build: the three launches' grids in turn, block by block
static int run(const SeedArgs& a, int device, void* stream)
{
    (void)device;
    (void)stream;
    WordsShared ws;
    DiagShared ds;
    for (int f = 0; f < a.n; ++f)
        for (int j = 0; j < a.nb1; ++j) words_block(a, ws, f, j);
    for (int f = 0; f < a.n; ++f)
        for (int j = 0; j < a.nb2; ++j) diag_block<false>(a, ds, f, j);
    for (int f = 0; f < a.n; ++f)
        for (int j = 0; j < a.nb2; ++j) diag_block<true>(a, ds, f, j);
    return 0;
}
#else
#define BLOCK_THREADS 1                 // a thread plays itself
#define THREAD(i) ((int)threadIdx.x)

__global__ void __launch_bounds__(SEED_THREADS)
seed_words_kernel(const SeedArgs a)
{
    __shared__ WordsShared s;
    words_block(a, s, (int)blockIdx.y, (int)blockIdx.x);
}

template <bool EMIT>
__global__ void __launch_bounds__(SEED_THREADS)
seed_diag_kernel(const SeedArgs a)
{
    __shared__ DiagShared s;
    diag_block<EMIT>(a, s, (int)blockIdx.y, (int)blockIdx.x);
}

// Queues the three launches on `stream` on card `device` (made current for
// the launches and restored); 0 or a CUDA error.
static int run(const SeedArgs& a, int device, void* stream)
{
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
    const dim3 g1((unsigned)a.nb1, (unsigned)a.n);
    const dim3 g2((unsigned)a.nb2, (unsigned)a.n);
    seed_words_kernel<<<g1, SEED_THREADS, 0, st>>>(a);
    int rc = (int)cudaGetLastError();
    if (rc == 0) {
        seed_diag_kernel<false><<<g2, SEED_THREADS, 0, st>>>(a);
        rc = (int)cudaGetLastError();
    }
    if (rc == 0) {
        seed_diag_kernel<true><<<g2, SEED_THREADS, 0, st>>>(a);
        rc = (int)cudaGetLastError();
    }
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

// The lowest set bit's index of a nonzero 64-bit set.
__device__ __forceinline__ int low_bit(unsigned long long x)
{
    return __ffsll((long long)x) - 1;
}

// Inclusive scan of scan[0][t] over the block's threads (Hillis-Steele,
// one barrier a round; the rounds alternate the two rows, eight of them end
// in row 0).
__device__ void block_scan(int (&scan)[2][SEED_THREADS])
{
    int b = 0;
    for (int d = 1; d < SEED_THREADS; d <<= 1, b ^= 1) {
        for (int i = 0; i < BLOCK_THREADS; ++i) {
            const int t = THREAD(i);
            scan[b ^ 1][t] = scan[b][t] + (t >= d ? scan[b][t - d] : 0);
        }
        __syncthreads();
    }
}

// ---- launch 1: codes, words, in-positions ----------------------------------

// Positions of the block's codes: its span and the w - 1 after it, in L.
__device__ __forceinline__ int codes_len(const SeedArgs& a, int j)
{
    return min(SEED_SPAN + a.word_len - 1, a.L - j * SEED_SPAN);
}

__device__ void words_init(const SeedArgs& a, WordsShared& s, int f, int j,
                           int t)
{
    for (int x = t; x < SEED_SPAN + MAX_WORD_LEN; x += SEED_THREADS)
        s.delta[x] = 0;
    if (t == 0) {
        s.nbase = 0;
        s.count = 0;
    }
    if (j == 0) {       // the fragment's sums of launch 2, zeroed first
        if (t < a.num_os) a.counts[f * a.num_os + t] = 0;
        if (t == 0) a.oflag[f] = 0;
    }
}

// N runs: the count at the span's start, and the ends inside it.
__device__ void words_runs(const SeedArgs& a, WordsShared& s, int f, int j,
                           int t)
{
    const int x0 = j * SEED_SPAN, len = codes_len(a, j);
    const int* rs = a.nrun_s + (size_t)f * a.n_runs;
    const int* re = a.nrun_e + (size_t)f * a.n_runs;
    int before = 0;
    for (int i = t; i < a.n_runs; i += SEED_THREADS) {
        const int st = __ldg(rs + i), en = __ldg(re + i);
        before += (st < x0 ? 1 : 0) - (en < x0 ? 1 : 0);
        if (st >= x0 && st - x0 < len) atomicAdd(&s.delta[st - x0], 1);
        if (en >= x0 && en - x0 < len) atomicAdd(&s.delta[en - x0], -1);
    }
    if (before != 0) atomicAdd(&s.nbase, before);
}

// Thread t's chunk of the block's codes: SEED_PER_THREAD positions, the
// last thread's up to codes_len.
__device__ __forceinline__ void code_chunk(const SeedArgs& a, int j, int t,
                                           int& lo, int& hi)
{
    const int len = codes_len(a, j);
    lo = min(t * SEED_PER_THREAD, len);
    hi = t == SEED_THREADS - 1 ? len : min(lo + SEED_PER_THREAD, len);
}

__device__ void words_part(const SeedArgs& a, WordsShared& s, int j, int t)
{
    int lo, hi, sum = 0;
    code_chunk(a, j, t, lo, hi);
    for (int x = lo; x < hi; ++x) sum += s.delta[x];
    s.part[t] = sum;
    s.scan[0][t] = sum;
}

// Overrides 1-3: the base, DB_UNKNOWN past the fragment, DB_N in a run.
__device__ void words_codes(const SeedArgs& a, WordsShared& s, int f, int j,
                            int t)
{
    const int x0 = j * SEED_SPAN, flen = __ldg(a.frag_lens + f);
    const uint8_t* row = a.packed + (size_t)f * (a.L / 4);
    int lo, hi;
    code_chunk(a, j, t, lo, hi);
    int c = s.nbase + s.scan[0][t] - s.part[t];
    for (int x = lo; x < hi; ++x) {
        const int pos = x0 + x;
        c += s.delta[x];
        int code = (__ldg(row + pos / 4) >> (2 * (pos % 4))) & 3;
        if (pos >= flen) code = DB_UNKNOWN;
        if (c > 0) code = DB_N;
        s.code[x] = (uint8_t)code;
    }
}

// Override 4: the exceptions in the block's codes (pads at L dropped).
__device__ void words_exceptions(const SeedArgs& a, WordsShared& s, int f,
                                 int j, int t)
{
    const int x0 = j * SEED_SPAN, len = codes_len(a, j);
    const int* ep = a.exc_p + (size_t)f * a.n_exc;
    const uint8_t* ec = a.exc_c + (size_t)f * a.n_exc;
    for (int i = t; i < a.n_exc; i += SEED_THREADS) {
        const int pos = clampi(__ldg(ep + i), 0, a.L);
        if (pos >= x0 && pos - x0 < len) s.code[pos - x0] = __ldg(ec + i);
    }
}

// word and word_valid at every position of the span (thread t: t, t + 256,
// ...: coalesced stores), and whether it is an in-position before the
// truncation.
__device__ void words_store(const SeedArgs& a, WordsShared& s, int f, int j,
                            int t)
{
    const int x0 = j * SEED_SPAN, flen = __ldg(a.frag_lens + f);
    const int w = a.word_len;
    for (int r = t; r < SEED_SPAN; r += SEED_THREADS) {
        const int q = x0 + r;
        bool in = false;
        if (q < a.nw_pos) {
            int word = 0;
            bool valid = q < flen - w + 1;
            for (int k = 0; k < w; ++k) {
                const int code = s.code[r + k];
                word = (word << 2) | (code & 3);
                valid = valid && code <= DB_MAX_ATGC;
            }
            const size_t at = (size_t)f * a.nw_pos + q;
            a.word[at] = word;
            a.word_valid[at] = valid ? 1 : 0;
            in = valid && (__ldg(a.vf + word) & 1) != 0;
        }
        s.in[r] = in ? 1 : 0;
    }
}

__device__ void words_bits(const SeedArgs& a, WordsShared& s, int f, int j,
                           int t)
{
    if (t >= SEED_SPAN / 32) return;
    unsigned m = 0;
    for (int b = 0; b < 32; ++b) m |= (unsigned)s.in[32 * t + b] << b;
    a.bits[(size_t)f * a.nbits + j * (SEED_SPAN / 32) + t] = m;
    if (m != 0) atomicAdd(&s.count, __popc(m));
}

__device__ void words_block(const SeedArgs& a, WordsShared& s, int f, int j)
{
    for (int i = 0; i < BLOCK_THREADS; ++i) words_init(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) words_runs(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) words_part(a, s, j, THREAD(i));
    __syncthreads();
    block_scan(s.scan);
    for (int i = 0; i < BLOCK_THREADS; ++i)
        words_codes(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i)
        words_exceptions(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i)
        words_store(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) words_bits(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i)
        if (THREAD(i) == 0) a.cnt1[f * a.nb1 + j] = s.count;
}

// ---- launches 2 and 3: the diagonals' slot sets ----------------------------

template <bool EMIT>
__device__ void diag_init(DiagShared& s, int t)
{
    if (t == 0) {
        s.base = 0;
        s.before = 0;
        s.total = 0;
        s.flag = 0;
    }
    if (!EMIT && t < MAX_SLOTS) s.scount[t] = 0;
}

// The in-positions before the block (launch 1's counts), launch 3's keys
// before it and in all, and the block's in-position bits, word 0 the halo.
template <bool EMIT>
__device__ void diag_load(const SeedArgs& a, DiagShared& s, int f, int j,
                          int t)
{
    int sum = 0;
    for (int i = t; i < min(j, a.nb1); i += SEED_THREADS)
        sum += a.cnt1[f * a.nb1 + i];
    if (sum != 0) atomicAdd(&s.base, sum);
    if (EMIT) {
        int before = 0, total = 0;
        for (int i = t; i < a.nb2; i += SEED_THREADS) {
            const int c = a.cnt2[f * a.nb2 + i];
            total += c;
            if (i < j) before += c;
        }
        if (before != 0) atomicAdd(&s.before, before);
        if (total != 0) atomicAdd(&s.total, total);
    }
    if (t < SEED_RANGE_WORDS) {
        const int wi = j * (SEED_SPAN / 32) - 1 + t;
        s.raw[t] = t < SEED_RANGE_WORDS - 1 && wi >= 0 && wi < a.nbits
            ? a.bits[(size_t)f * a.nbits + wi] : 0u;
    }
}

// The truncation: bits of rank >= cap are dropped (a drop flags the
// fragment's overflow: it had more than cap in-positions).
__device__ void diag_truncate(const SeedArgs& a, DiagShared& s, int t)
{
    if (t >= SEED_RANGE_WORDS) return;
    const unsigned m = s.raw[t];
    int r0 = s.base - __popc(s.raw[0]);     // rank of word 0's first bit
    for (int u = 0; u < t; ++u) r0 += __popc(s.raw[u]);
    unsigned kept = m;
    if (r0 >= a.cap) {
        kept = 0;
    } else if (__popc(m) > a.cap - r0) {   // keep the lowest cap - r0 bits
        kept = 0;
        unsigned x = m;
        for (int i = a.cap - r0; i > 0; --i) {
            const unsigned low = x & (0u - x);
            kept |= low;
            x ^= low;
        }
    }
    s.eff[t] = kept;
    if (kept != m) atomicOr(&s.flag, 1);
}

// The words at the block's in-positions into shared memory; launch 2 flags
// a residue (more slots than s_max, or word indices than k_max).
template <bool EMIT>
__device__ void diag_words(const SeedArgs& a, DiagShared& s, int f, int j,
                           int t)
{
    const int r0 = j * SEED_SPAN - SEED_HALO;
    const int* row = a.word + (size_t)f * a.nw_pos;
    for (int r = t; r < SEED_RANGE; r += SEED_THREADS) {
        if (((s.eff[r >> 5] >> (r & 31)) & 1u) == 0) continue;
        const int v = __ldg(row + r0 + r);
        s.wv[r] = v;
        if (!EMIT && (__ldg(a.vf + v) & 2) != 0) atomicOr(&s.flag, 1);
    }
}

// U[p] of thread t's SEED_PER_THREAD consecutive diagonals, and their keys:
// launch 2 counts them a block and a slot, launch 3 a thread.
template <bool EMIT>
__device__ void diag_sets(const SeedArgs& a, DiagShared& s, int t)
{
    const int mw = a.max_words;
    const unsigned long long kmask = (1ull << mw) - 1;
    int keys = 0;
    for (int i = 0; i < SEED_PER_THREAD; ++i) {
        const int d = t * SEED_PER_THREAD + i;
        // diagonal p = j * SPAN - MW + 1 + d; its positions p + k, k < MW,
        // start at index rel of the block's range
        const int rel = d + SEED_HALO + 1 - mw;
        const int wi = rel >> 5;
        unsigned long long win =
            ((((unsigned long long)s.eff[wi + 1] << 32) | s.eff[wi])
             >> (rel & 31)) & kmask;
        unsigned long long u = 0;
        while (win != 0) {
            const int k = low_bit(win);
            win &= win - 1;
            u |= __ldg(a.ks + (size_t)s.wv[rel + k] * mw + k);
        }
        s.u[d] = u;
        keys += __popcll(u);
        if (!EMIT)
            for (unsigned long long x = u; x != 0; x &= x - 1)
                atomicAdd(&s.scount[low_bit(x)], 1);
    }
    if (EMIT) {
        s.part[t] = keys;
        s.scan[0][t] = keys;
    } else if (keys != 0) {
        atomicAdd(&s.total, keys);
    }
}

// Launch 2's sums: the block's keys, its residue or truncation flag, and
// its per-slot counts (integer atomics: exact in any order).
__device__ void diag_sums(const SeedArgs& a, DiagShared& s, int f, int j,
                          int t)
{
    if (t == 0) {
        a.cnt2[f * a.nb2 + j] = s.total;
        if (s.flag != 0) atomicOr(a.oflag + f, 1);
    }
    if (t < a.num_os && s.scount[t] != 0)
        atomicAdd(a.counts + f * a.num_os + t, s.scount[t]);
}

// Launch 3's stores: thread t's keys from its offset, in diagonal then slot
// order, below cap; the fragment's slots past n_cand zeroed, this block's
// share of them; n_cand and overflow from block 0.
__device__ void diag_emit(const SeedArgs& a, DiagShared& s, int f, int j,
                          int t)
{
    const int p0 = j * SEED_SPAN - a.max_words + 1;
    int* slot = a.slot + (size_t)f * a.cap;
    int* pp = a.p + (size_t)f * a.cap;
    int g = s.before + s.scan[0][t] - s.part[t];
    for (int i = 0; i < SEED_PER_THREAD && g < a.cap; ++i) {
        const int d = t * SEED_PER_THREAD + i;
        for (unsigned long long x = s.u[d]; x != 0 && g < a.cap;
             x &= x - 1, ++g) {
            slot[g] = low_bit(x);
            pp[g] = p0 + d;
        }
    }
    const int n_cand = s.total;
    const int share = (a.cap + a.nb2 - 1) / a.nb2;
    const int hi = (int)min((long long)a.cap, (long long)(j + 1) * share);
    for (long long z = max((long long)n_cand, (long long)j * share) + t;
         z < hi; z += SEED_THREADS) {
        slot[z] = 0;
        pp[z] = 0;
    }
    if (j == 0 && t == 0) {
        a.n_cand[f] = n_cand;
        a.overflow[f] = a.oflag[f] != 0 || n_cand > a.cap ? 1 : 0;
    }
}

template <bool EMIT>
__device__ void diag_block(const SeedArgs& a, DiagShared& s, int f, int j)
{
    for (int i = 0; i < BLOCK_THREADS; ++i) diag_init<EMIT>(s, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i)
        diag_load<EMIT>(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) diag_truncate(a, s, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i)
        diag_words<EMIT>(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) diag_sets<EMIT>(a, s, THREAD(i));
    __syncthreads();
    if (EMIT) {
        block_scan(s.scan);
        for (int i = 0; i < BLOCK_THREADS; ++i)
            diag_emit(a, s, f, j, THREAD(i));
    } else {
        for (int i = 0; i < BLOCK_THREADS; ++i)
            diag_sums(a, s, f, j, THREAD(i));
    }
}

// ---- the C entry points -----------------------------------------------------

// A panel's part of the arguments, checked once: the seed tables, the
// static shapes and the card.  The step's call fills in the rest.
struct SeedPlan {
    SeedArgs a;
    int device;
};

extern "C" int seed_plan_bytes() { return (int)sizeof(SeedPlan); }

// Fills `plan` (seed_plan_bytes() bytes, 8-byte aligned); 0, or
// cudaErrorInvalidValue where a shape is refused.
extern "C" int seed_plan(void* plan, const void* ks, const void* vf, int L,
                         int word_len, int num_os, int max_words, int cap,
                         int device)
{
    if (word_len < 1 || word_len > MAX_WORD_LEN || L < word_len || L % 4 != 0
        || L > (1 << 30) || num_os < 1 || num_os > MAX_SLOTS || max_words < 1
        || max_words > MAX_WORDS || cap < 1)
        return (int)cudaErrorInvalidValue;
    SeedPlan* pl = (SeedPlan*)plan;
    SeedArgs a = {};
    a.ks = (const unsigned long long*)ks;
    a.vf = (const uint8_t*)vf;
    a.L = L;
    a.word_len = word_len;
    a.nw_pos = L - word_len + 1;
    a.num_os = num_os;
    a.max_words = max_words;
    a.cap = cap;
    a.nb1 = (a.nw_pos + SEED_SPAN - 1) / SEED_SPAN;
    a.nb2 = (a.nw_pos + max_words - 1 + SEED_SPAN - 1) / SEED_SPAN;
    a.nbits = a.nb1 * (SEED_SPAN / 32);
    pl->a = a;
    pl->device = device;
    return 0;
}

// int32 words of scratch a call on n fragments needs under a plan.
extern "C" long long seed_scratch_words(const void* plan, int n)
{
    const SeedArgs& a = ((const SeedPlan*)plan)->a;
    return (long long)n * (a.nb1 + a.nb2 + a.nbits + 1);
}

// The step's call: seeds n fragments under a plan, on the plan's card, on
// `stream`.  Pointers: the payload (packed, frag_lens, nrun_s, nrun_e,
// exc_p, exc_c; n_runs runs and n_exc exceptions a fragment), the seven
// outputs (slot, p, n_cand, counts, overflow, word, word_valid) and
// seed_scratch_words(plan, n) int32 words of scratch.  0,
// cudaErrorInvalidValue for n < 1 or a negative count, or a launch's CUDA
// error.
extern "C" int seed_launch_plan(
    const void* plan, const void* packed, const void* frag_lens,
    const void* nrun_s, const void* nrun_e, const void* exc_p,
    const void* exc_c, void* slot, void* p, void* n_cand, void* counts,
    void* overflow, void* word, void* word_valid, void* scratch, int n,
    int n_runs, int n_exc, void* stream)
{
    if (n < 1 || n > 65535 || n_runs < 0 || n_exc < 0)
        return (int)cudaErrorInvalidValue;
    SeedArgs a = ((const SeedPlan*)plan)->a;
    a.packed = (const uint8_t*)packed;
    a.frag_lens = (const int*)frag_lens;
    a.nrun_s = (const int*)nrun_s;
    a.nrun_e = (const int*)nrun_e;
    a.exc_p = (const int*)exc_p;
    a.exc_c = (const uint8_t*)exc_c;
    a.slot = (int*)slot;
    a.p = (int*)p;
    a.n_cand = (int*)n_cand;
    a.counts = (int*)counts;
    a.overflow = (uint8_t*)overflow;
    a.word = (int*)word;
    a.word_valid = (uint8_t*)word_valid;
    a.n = n;
    a.n_runs = n_runs;
    a.n_exc = n_exc;
    a.cnt1 = (int*)scratch;
    a.cnt2 = a.cnt1 + (size_t)n * a.nb1;
    a.bits = (unsigned*)(a.cnt2 + (size_t)n * a.nb2);
    a.oflag = (int*)(a.bits + (size_t)n * a.nbits);
    return run(a, ((const SeedPlan*)plan)->device, stream);
}
