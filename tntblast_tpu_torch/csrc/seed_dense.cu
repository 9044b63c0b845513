// The dense seeding path of the device seed+screen step, as two launches of
// hand-written kernels for the Hopper SM (sm_90a): from one step's packed
// payload and the panel's oligo words, every fragment's target words and
// their validity, and its seed candidates with the two-stage compaction of
// the JAX dense path.
//
// Replaces no Pallas kernel.  In the JAX package this stage is the payload
// unpack of tntblast_tpu/parallel/device_search.py (panel_step_core,
// :434-457) and the dense fallback of _seed_fragment (:219-248) under its
// fragment vmap, fused by XLA inside the jitted step: a (L + MW, num_os)
// bitmap built by comparing every target word with every oligo word, then
// two nonzero compactions.  DevicePanel takes it where the word table is
// gated off (oligos of more than 31 words, a table too large, or more than
// 8 lanes a word).  Its plain PyTorch version (ops/seed.py::
// seed_dense_reference) builds that bitmap; here no bitmap exists.
//
// What it computes, per fragment f of length flen in a tile of L positions
// (word length w, nw_pos = L - w + 1 words, MW words an oligo, cap):
//   codes and word/word_valid exactly as csrc/seed.cu's words launch: the
//     2-bit base, DB_UNKNOWN at x >= flen, DB_N where the count of N-run
//     starts minus ends at or before x (both clamped to [0, L]) is > 0,
//     the exception last (pads at L dropped); word[q] the codes' low two
//     bits over [q, q + w) at EVERY q < nw_pos (trap: padding, N runs and
//     exceptions too: the decode and kmin read them); word_valid[q] = q <
//     flen - w + 1 and every code <= DB_T.
//   seeds: slot s has diagonal p in [-(MW - 1), nw_pos) iff some k < MW has
//     ow[s][k] >= 0, word_valid[p + k] and word[p + k] == ow[s][k].  The
//     panel-static tables (ops/seed.py::dense_tables) give, for a word
//     value v, its entries (k, S) with S the 64-bit set of slots whose word
//     k is v, found through an open-addressing hash of v; so the slots of
//     diagonal p are U[p] = OR over valid positions q = p + k of the S of
//     word[q]'s entries with that k.  No lane limit: every (s, k) counts.
//   compaction (the JAX dense semantics, not the table path's):
//     n_pos = the non-empty diagonals; only the first cap of them by
//     diagonal are taken; their (diagonal, slot) pairs in that order, the
//     first cap of them into slot/p, zeros past them; n_cand = the pairs
//     inside the first cap diagonals (may exceed cap); counts[s] = the
//     diagonals of slot s over ALL diagonals (trap: not just the first
//     cap); overflow = n_pos > cap or sum(counts) > cap.  Slots 31, 32 and
//     63 are bits of one 64-bit set (trap: __ffsll on the unsigned value).
//
// The four launches (DENSE_THREADS threads a block):
//  1. head: zeroes the fragments' slot counts, which launch 2 adds to, so
//     that every call, and every replay of a CUDA graph of one, starts
//     from zero.  Every other word of scratch is written before it is read.
//  2. tiles: diagonal tile j of fragment f (a block each) holds the
//     diagonals p in [P0, P0 + span), P0 = j * span - MW + 1, whose
//     positions q = p + k are exactly [P0, (j + 1) * span): the tile's own
//     span and the MW - 1 before it.  span is DENSE_SPAN, or
//     DENSE_SPAN_WIDE for oligos of more than DENSE_WIDE_WORDS words, so
//     that the halo of MW - 1 positions stays a quarter of a tile at most
//     (its arrays are dynamic shared memory, sized by the plan for the span
//     and the panel's words).  The block scatters the fragment's run ends
//     and exceptions that fall in its codes into shared memory (the run
//     ends before them into one count), sums the deltas (a block scan),
//     builds its codes, then a thread a position computes the word and its
//     validity, stores them where the position is the tile's own, and puts
//     a valid word that the panel's filter bits may hold on the tile's list
//     of positions to look up.  Then a thread a listed position looks its
//     word up in the hash and ORs each entry's slot set into U[q - k] in
//     shared memory where that diagonal is the tile's: the block's probes
//     are in flight at once.  A thread then holds span / THREADS
//     consecutive diagonals: their non-empty count and pair count (one
//     64-bit block scan of both), the per-slot counts (shared atomics, one
//     global atomic a slot a tile); it writes its non-empty diagonals'
//     slot sets and offsets at their ranks into the tile's compacted list,
//     and the tile its two counts.
//  3. scan: a block a fragment sums the tiles' counts in tile order
//     (tprefix: D, the non-empty diagonals before a tile, and P, their
//     pairs), finds the tile holding the cap-th non-empty diagonal, and
//     from its compacted list n_cand (the pairs inside the first cap
//     diagonals; all pairs where there are fewer), overflow, and placed =
//     min(n_cand, cap).
//  4. emit: a diagonal tile's diagonals of rank D + r < cap are the taken
//     ones (a prefix in diagonal order, so every pair before a taken
//     diagonal is counted in P); a block scan of their pair counts places
//     their pairs in slot/p from P on, below cap.  A fill tile zeroes slot
//     and p from placed to cap, DENSE_FILL places each.
//     A tile's counts and their sums fit one word (CNT_*): a fragment's
//     diagonals are at most L + MW - 1 < 2^27 (30 bits), its pairs 64
//     times that (33 bits).
// Integer arithmetic throughout: the kernel equals the plain version bit for
// bit by construction.
//
// What the kernel relies on.  frag_lens, runs and exceptions as the panel
// packs them (DevicePanel._pack_host): each exception position at most
// once; their order does not matter, pads anywhere are dropped; run ends in
// any order.  The plan's tables built by ops/seed.py::dense_tables from the
// panel's ow.  Scratch needs no initial value: launch 1 resets it.
//
// What bounds it on the H100: bytes.  A long-probe step (8 fragments of
// 2^19, w 7, 64 slots of 54 words, cap 131072) reads 1 MB of packed bases
// and writes 16.8 MB of words, 4.2 MB of validity and 8.4 MB of slot/p:
// about 30 MB, 0.009 ms at 3.35e12 B/s.  Its arithmetic is a word and a
// hash probe a position and an OR a matching entry (about 0.2 entries a
// random position at 3456 oligo words of 16384 values).  Where the
// first form (PR 15) spent a tile's time (tools/seed_dense_steps.py
// --timeline, a timestamp after each of a tile's barriers): most in the
// words, where a warp waited on a hash probe in nearly every round of its
// positions (some lane's word passes the filter in most rounds), and in
// the look-back, where a tile waited for the slowest of its fragment's
// earlier tiles to publish its counts while holding its SM's slot.  This
// form lists the positions to look up and probes them a thread each, all
// at once, and replaces the look-back by a scan launch between the tiles
// and their pairs: no block waits on another.  Its arrays are sized at
// run time, so the oligos' words are limited only by the 16 bits of a
// listed position's offset (MAX_WORDS).  The hash of a 64-slot panel of
// long oligos (2 MB at 293 words) does not fit in shared memory: its
// probes stay in device memory (L2), behind the filter bits in shared
// memory.
//
// The host build (-DSEED_DENSE_HOST, tests/test_torch_seed_dense.py, g++
// behind tests/cuda_host_shim/cuda_runtime.h): each launch block by block
// (the tile and emit launches' blocks backwards with
// seed_dense_host_reverse); a block's threads are played phase by phase
// through the thread loops below (BLOCK_THREADS; in reverse order with
// seed_dense_host_reverse, so no phase may depend on the order of its
// threads).  The block scan has a host form.

#include <cuda_runtime.h>
#include <stdint.h>

#define DENSE_THREADS 256
#define DENSE_WARPS (DENSE_THREADS / 32)
#define DENSE_SPAN 2048         // diagonals a tile, up to DENSE_WIDE_WORDS
#define DENSE_SPAN_WIDE 4096    // diagonals a tile past DENSE_WIDE_WORDS
#define DENSE_WIDE_WORDS 512
#define DENSE_FILL 8192         // slot/p places a fill tile zeroes
#define MAX_WORD_LEN 15         // ops/seed.py DENSE_MAX_WORD_LEN: 30 bits
#define MAX_WORDS 1024          // ops/seed.py DENSE_MAX_WORDS: 1024-nt oligos
#define MAX_SLOTS 64            // a diagonal's slots in one 64-bit set
#define MAX_TILE (1 << 26)      // counts fit their words' fields (CNT_*)
#define FILTER_BITS 15          // ops/seed.py DENSE_FILTER_BITS
#define FILTER_WORDS ((1 << FILTER_BITS) / 32)
#define HASH_MUL 2654435761u    // ops/seed.py DENSE_HASH_MUL
#define NO_EXC 0xFFFF           // above every uint8 code
#define DB_MAX_ATGC 3           // constants.py DB_T
#define DB_N 15                 // constants.py DB_N
#define DB_UNKNOWN 17           // constants.py DB_UNKNOWN

// A tile's counts, and their sums over a fragment's earlier tiles, in one
// word: the non-empty diagonals in bits 33-62, their pairs in bits 0-32
// (at most L + MW - 1 < 2^27 diagonals a fragment, 64 times as many pairs).
#define CNT_POS_SHIFT 33
#define CNT_PAIRS ((1ull << 33) - 1)

struct DenseArgs {
    const uint8_t* packed;          // (n, L / 4)
    const int *frag_lens, *nrun_s, *nrun_e, *exc_p;
    const uint8_t* exc_c;
    const int4* hash;               // (1 << hash_bits,): v, start, count
    const int4* entries;            // k, slot set low, high
    const unsigned* filter;         // FILTER_WORDS: bits of held hashes
    int *slot, *p, *n_cand, *counts;
    uint8_t* overflow;
    int* word;
    uint8_t* word_valid;
    // scratch, every word written before it is read in a call
    unsigned long long* tcount;     // a tile's counts (CNT_*)
    unsigned long long* tprefix;    // the counts of the fragment's earlier
                                    // tiles
    unsigned long long* placed;     // a fragment's min(n_cand, cap)
    unsigned long long* dset;       // a tile's non-empty diagonals' slot
                                    // sets, in diagonal order: span a tile
    uint16_t* didx;                 // their diagonals' offsets in the tile
    int n, L, word_len, nw_pos, num_os, max_words, cap, n_runs, n_exc;
    int hash_bits, nb, nf;          // diagonal and fill tiles a fragment
    int span;                       // diagonals a tile
    int ncodes;                     // codes a tile holds at most
    int smem;                       // the tiles' dynamic shared memory, bytes
};

// A block's scans, and what the tile launch carries between its phases.
struct alignas(16) DenseShared {
    long long part[DENSE_THREADS];      // scans: a thread's share
    long long wsum[DENSE_WARPS];
    int scount[MAX_SLOTS];
    long long total, cross_prior;
    int before, flen, n_list, cross;
};

// The tile launch's block: its codes, the positions it looks up and its
// diagonals' slot sets, in dynamic shared memory laid out by the plan
// (dense_tile()) for its span and the panel's words.
struct DenseTile {
    unsigned* filter;                   // FILTER_WORDS
    unsigned *ulo, *uhi;                // slots 0-31, 32-63 of U: span each
    int* delta;                         // run starts - run ends: ncodes
    uint16_t* exc;                      // an exception's code, or NO_EXC
    uint16_t* list;                     // positions to look up, over delta
    uint8_t* code;                      // ncodes
};

// The tile's arrays at `base` (the plan's smem bytes).  The list of
// positions (at most span + MW - 1 <= ncodes) takes the place of the
// deltas, which no phase reads after the codes are built.
__host__ __device__ __forceinline__ DenseTile dense_tile(const DenseArgs& a,
                                                         unsigned* base)
{
    DenseTile d;
    d.filter = base;
    d.ulo = d.filter + FILTER_WORDS;
    d.uhi = d.ulo + a.span;
    d.delta = (int*)(d.uhi + a.span);
    d.exc = (uint16_t*)(d.delta + a.ncodes);
    d.list = (uint16_t*)d.delta;
    d.code = (uint8_t*)(d.exc + a.ncodes);
    return d;
}

// the tile launch's dynamic shared memory, bytes
__host__ __device__ __forceinline__ int dense_smem(int span, int ncodes)
{
    return 4 * (FILTER_WORDS + 2 * span + ncodes) + 2 * ncodes + ncodes;
}

__device__ void dense_head(const DenseArgs& a, int t);
__device__ void dense_tile_block(const DenseArgs& a, DenseShared& s,
                                 const DenseTile& d, int tile);
__device__ void dense_scan_block(const DenseArgs& a, DenseShared& s, int f);
__device__ void dense_emit_block(const DenseArgs& a, DenseShared& s, int b);

#ifdef SEED_DENSE_HOST
#define BLOCK_THREADS DENSE_THREADS     // the host thread plays every thread
static int host_reverse;                // play each phase's threads backwards
#define THREAD(i) (host_reverse ? DENSE_THREADS - 1 - (i) : (i))

// Exclusive prefix of part[] over the block's threads, in place; the sum
// into *total.
static void block_scan(long long* part, long long* wsum, long long* total)
{
    (void)wsum;
    long long sum = 0;
    for (int t = 0; t < DENSE_THREADS; ++t) {
        const long long v = part[t];
        part[t] = sum;
        sum += v;
    }
    *total = sum;
}

extern "C" void seed_dense_host_reverse(int on) { host_reverse = on; }

// the CPU tests' build: each launch block by block (the tile and emit
// launches' blocks backwards with seed_dense_host_reverse: no block waits
// on another)
static int run(const DenseArgs& a, int device, void* stream)
{
    (void)device;
    (void)stream;
    static DenseShared sh;
    host_fault = 0;
    for (int i = 0; i < DENSE_THREADS; ++i) dense_head(a, THREAD(i));
    unsigned* dyn = (unsigned*)aligned_alloc(16, (a.smem + 15) / 16 * 16);
    const DenseTile d = dense_tile(a, dyn);
    const int tiles = a.n * a.nb, emits = a.n * (a.nb + a.nf);
    for (int i = 0; i < tiles; ++i)
        dense_tile_block(a, sh, d, host_reverse ? tiles - 1 - i : i);
    free(dyn);
    for (int f = 0; f < a.n; ++f) dense_scan_block(a, sh, f);
    for (int i = 0; i < emits; ++i)
        dense_emit_block(a, sh, host_reverse ? emits - 1 - i : i);
    return host_fault;
}
#else
#define BLOCK_THREADS 1                 // a thread plays itself
#define THREAD(i) ((int)threadIdx.x)

// Exclusive prefix of part[] over the block's threads, in place (a warp
// scan by shuffles, then the warps' sums); the sum into *total.
__device__ void block_scan(long long* part, long long* wsum, long long* total)
{
    const int t = (int)threadIdx.x, lane = t & 31, wp = t >> 5;
    const long long v = part[t];
    long long x = v;
    for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) wsum[wp] = x;
    __syncthreads();
    if (t < 32) {
        const long long ws = t < DENSE_WARPS ? wsum[t] : 0;
        long long e = ws;
        for (int d = 1; d < DENSE_WARPS; d <<= 1) {
            const long long y = __shfl_up_sync(0xffffffffu, e, d);
            if (lane >= d) e += y;
        }
        if (t < DENSE_WARPS) wsum[t] = e - ws;
        if (t == DENSE_WARPS - 1) *total = e;
    }
    __syncthreads();
    part[t] = x - v + wsum[wp];
    __syncthreads();
}

__global__ void __launch_bounds__(DENSE_THREADS)
seed_dense_head_kernel(const DenseArgs a)
{
    dense_head(a, (int)threadIdx.x);
}

__global__ void __launch_bounds__(DENSE_THREADS)
seed_dense_kernel(const DenseArgs a)
{
    __shared__ DenseShared s;
    extern __shared__ __align__(16) unsigned dyn[];
    dense_tile_block(a, s, dense_tile(a, dyn), (int)blockIdx.x);
}

__global__ void __launch_bounds__(DENSE_THREADS)
seed_dense_scan_kernel(const DenseArgs a)
{
    __shared__ DenseShared s;
    dense_scan_block(a, s, (int)blockIdx.x);
}

__global__ void __launch_bounds__(DENSE_THREADS)
seed_dense_emit_kernel(const DenseArgs a)
{
    __shared__ DenseShared s;
    dense_emit_block(a, s, (int)blockIdx.x);
}

// Queues the four launches on `stream` on card `device` (made current for
// the launches and restored), the tile launch's dynamic shared memory
// opted into once a card; 0 or a CUDA error.
static int run(const DenseArgs& a, int device, void* stream)
{
    static int opted[64];
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
    if (err == cudaSuccess && (device < 0 || device >= 64))
        err = cudaErrorInvalidDevice;
    if (err == cudaSuccess && opted[device] < a.smem) {
        // as much shared memory an SM as it has: six tiles of the
        // long-probe shapes (37 KB each) share an SM, not five
        err = cudaFuncSetAttribute(
            seed_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            a.smem);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                seed_dense_kernel,
                cudaFuncAttributePreferredSharedMemoryCarveout, 100);
        if (err == cudaSuccess) opted[device] = a.smem;
    }
    if (err != cudaSuccess) {
        if (cur != device) cudaSetDevice(cur);
        return (int)err;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    seed_dense_head_kernel<<<1, DENSE_THREADS, 0, st>>>(a);
    int rc = (int)cudaGetLastError();
    if (rc == 0) {
        seed_dense_kernel<<<(unsigned)(a.n * a.nb), DENSE_THREADS, a.smem,
                            st>>>(a);
        rc = (int)cudaGetLastError();
    }
    if (rc == 0) {
        seed_dense_scan_kernel<<<(unsigned)a.n, DENSE_THREADS, 0, st>>>(a);
        rc = (int)cudaGetLastError();
    }
    if (rc == 0) {
        seed_dense_emit_kernel<<<(unsigned)(a.n * (a.nb + a.nf)),
                                 DENSE_THREADS, 0, st>>>(a);
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

// ---- launch 1: the reset ----------------------------------------------------

// Thread t of the head block: its share of the fragments' slot counts,
// which the tile launch adds to.
__device__ void dense_head(const DenseArgs& a, int t)
{
    for (int c = t; c < a.n * a.num_os; c += DENSE_THREADS) a.counts[c] = 0;
}

// ---- launch 2: the tiles ----------------------------------------------------

// The first code position of tile j and how many (its positions from P0,
// clamped at 0, and the w - 1 after its span, clamped at L).
__device__ __forceinline__ int codes_lo(const DenseArgs& a, int j)
{
    return max(j * a.span - a.max_words + 1, 0);
}

__device__ __forceinline__ int codes_len(const DenseArgs& a, int j)
{
    return min((j + 1) * a.span + a.word_len - 1, a.L) - codes_lo(a, j);
}

// Thread t's part of the tile's arrays zeroed, and its share of the
// panel's filter bits loaded.
__device__ void tile_init(const DenseArgs& a, const DenseTile& d, int t)
{
    for (int x = t; x < a.ncodes; x += DENSE_THREADS) {
        d.delta[x] = 0;
        d.exc[x] = NO_EXC;
    }
    for (int x = t; x < FILTER_WORDS; x += DENSE_THREADS)
        d.filter[x] = __ldg(a.filter + x);
    for (int x = t; x < a.span; x += DENSE_THREADS) {
        d.ulo[x] = 0;
        d.uhi[x] = 0;
    }
}

// Thread t's share of the fragment's run ends and exceptions, those in the
// tile's codes scattered into shared memory, the run ends before them
// counted.
__device__ void tile_scatter(const DenseArgs& a, DenseShared& s,
                             const DenseTile& d, int f, int j, int t)
{
    const int c0 = codes_lo(a, j), nc = codes_len(a, j);
    const int* rs = a.nrun_s + (size_t)f * a.n_runs;
    const int* re = a.nrun_e + (size_t)f * a.n_runs;
    const int* ep = a.exc_p + (size_t)f * a.n_exc;
    const uint8_t* ec = a.exc_c + (size_t)f * a.n_exc;
    int before = 0;
    for (int k = t; k < a.n_runs; k += DENSE_THREADS) {
        const int x = clampi(__ldg(rs + k), 0, a.L) - c0;
        const int y = clampi(__ldg(re + k), 0, a.L) - c0;
        if (x < 0) before += 1;
        else if (x < nc) atomicAdd(&d.delta[x], 1);
        if (y < 0) before -= 1;
        else if (y < nc) atomicAdd(&d.delta[y], -1);
    }
    if (before != 0) atomicAdd(&s.before, before);
    for (int k = t; k < a.n_exc; k += DENSE_THREADS) {
        const int x = clampi(__ldg(ep + k), 0, a.L) - c0;
        if (x >= 0 && x < nc) d.exc[x] = __ldg(ec + k);
    }
}

// Thread t's contiguous chunk of the tile's codes.
__device__ __forceinline__ int chunk_of(int nc)
{
    return (nc + DENSE_THREADS - 1) / DENSE_THREADS;
}

__device__ void tile_delta_sum(const DenseArgs& a, DenseShared& s,
                               const DenseTile& d, int j, int t)
{
    const int nc = codes_len(a, j), ch = chunk_of(nc);
    int sum = 0;
    for (int x = t * ch; x < min((t + 1) * ch, nc); ++x) sum += d.delta[x];
    s.part[t] = sum;
}

// The codes of thread t's chunk: the base, DB_UNKNOWN past the fragment,
// DB_N in a run, the exception last.
__device__ void tile_codes(const DenseArgs& a, DenseShared& s,
                           const DenseTile& d, int f, int j, int t)
{
    const int c0 = codes_lo(a, j), nc = codes_len(a, j), ch = chunk_of(nc);
    const uint8_t* row = a.packed + (size_t)f * (a.L / 4);
    int c = s.before + (int)s.part[t];
    for (int x = t * ch; x < min((t + 1) * ch, nc); ++x) {
        c += d.delta[x];
        const int pos = c0 + x;
        int code = (__ldg(row + (pos >> 2)) >> (2 * (pos & 3))) & 3;
        if (pos >= s.flen) code = DB_UNKNOWN;
        if (c > 0) code = DB_N;
        if (d.exc[x] != NO_EXC) code = d.exc[x];
        d.code[x] = (uint8_t)code;
    }
}

// The word at position q of the tile (its codes from c0 on), and whether
// every one of its w codes is a base.
__device__ __forceinline__ unsigned word_at(const DenseTile& d, int x, int w,
                                            bool& ok)
{
    unsigned v = 0;
    for (int k = 0; k < w; ++k) {
        const int c = d.code[x + k];
        v = (v << 2) | (unsigned)(c & 3);
        ok = ok && c <= DB_MAX_ATGC;
    }
    return v & ((1u << (2 * w)) - 1);
}

// The entries of a word value, [*first, *first + *count): its hash slot
// (v, first entry, entries), probed linearly from the hash of v; no
// entries where no oligo holds v (an empty slot, v -1, ends the probe).
__device__ __forceinline__ void lookup(const DenseArgs& a, int v, int* first,
                                       int* count)
{
    const int mask = (1 << a.hash_bits) - 1;
    int h = (int)(((unsigned)v * HASH_MUL) >> (32 - a.hash_bits));
    for (;;) {
        const int4 e = __ldg(a.hash + h);
        if (e.x == v || e.x < 0) {
            *first = e.y;
            *count = e.x == v ? e.z : 0;
            return;
        }
        h = (h + 1) & mask;
    }
}

// A thread a position q of the tile's [P0, (j + 1) * span), clamped to
// [0, nw_pos): its word and validity, stored where q is the tile's own,
// and a valid word that the panel's filter bits may hold put on the
// tile's list of positions to look up (tile_probe).
__device__ void tile_words(const DenseArgs& a, DenseShared& s,
                           const DenseTile& d, int f, int j, int t)
{
    const int w = a.word_len, c0 = codes_lo(a, j);
    const int p0 = j * a.span - a.max_words + 1, q0 = max(p0, 0);
    const int own = j * a.span;
    const int hi = min((j + 1) * a.span, a.nw_pos);
    for (int q = q0 + t; q < hi; q += DENSE_THREADS) {
        bool ok = q < s.flen - w + 1;
        const unsigned v = word_at(d, q - c0, w, ok);
        if (q >= own) {
            const size_t at = (size_t)f * a.nw_pos + q;
            a.word[at] = (int)v;
            a.word_valid[at] = ok ? 1 : 0;
        }
        if (!ok) continue;
        const unsigned fb = (v * HASH_MUL) >> (32 - FILTER_BITS);
        if (((d.filter[fb >> 5] >> (fb & 31)) & 1u) == 0) continue;
        d.list[atomicAdd(&s.n_list, 1)] = (uint16_t)(q - q0);
    }
}

// The tile's listed positions, a thread each: the word's entries in the
// panel's hash ORed into U where the diagonal is the tile's.  The block's
// hash probes are in flight at once, where a thread walking its own
// positions would wait for each (most warps hold a listed position in
// nearly every round of their positions).
__device__ void tile_probe(const DenseArgs& a, DenseShared& s,
                           const DenseTile& d, int j, int t)
{
    const int w = a.word_len, c0 = codes_lo(a, j);
    const int p0 = j * a.span - a.max_words + 1, q0 = max(p0, 0);
    for (int i = t; i < s.n_list; i += DENSE_THREADS) {
        const int q = q0 + d.list[i];
        bool ok = true;
        const unsigned v = word_at(d, q - c0, w, ok);
        int first, count;
        lookup(a, (int)v, &first, &count);
        for (int e = first; e < first + count; ++e) {
            const int4 x = __ldg(a.entries + e);
            const int dg = q - x.x - p0;
            if (dg >= 0 && dg < a.span) {
                if (x.y != 0) atomicOr(&d.ulo[dg], (unsigned)x.y);
                if (x.z != 0) atomicOr(&d.uhi[dg], (unsigned)x.z);
            }
        }
    }
}

// Thread t's diagonals: non-empty ones and their pairs (for the block
// scan, non-empty in the high half), their slots into the tile's counts.
__device__ void tile_count(const DenseArgs& a, DenseShared& s,
                           const DenseTile& d, int t)
{
    const int per = a.span / DENSE_THREADS;
    long long npos = 0, pairs = 0;
    for (int i = 0; i < per; ++i) {
        const int g = t * per + i;
        const unsigned long long x =
            (unsigned long long)d.uhi[g] << 32 | d.ulo[g];
        if (x == 0) continue;
        npos += 1;
        pairs += __popcll(x);
        for (unsigned long long y = x; y != 0; y &= y - 1)
            atomicAdd(&s.scount[__ffsll((long long)y) - 1], 1);
    }
    s.part[t] = npos << CNT_POS_SHIFT | pairs;
}

// Thread t's non-empty diagonals into the tile's compacted list (slot set
// and offset, at their rank among the tile's), after the block scan; the
// tile's counts and its slot counts (one atomic a slot) out.
__device__ void tile_publish(const DenseArgs& a, DenseShared& s,
                             const DenseTile& d, int f, int tile, int t)
{
    const int per = a.span / DENSE_THREADS;
    const size_t base = (size_t)tile * a.span;
    int r = (int)(s.part[t] >> CNT_POS_SHIFT);
    for (int i = 0; i < per; ++i) {
        const int g = t * per + i;
        const unsigned long long x =
            (unsigned long long)d.uhi[g] << 32 | d.ulo[g];
        if (x == 0) continue;
        a.dset[base + r] = x;
        a.didx[base + r] = (uint16_t)g;
        r += 1;
    }
    if (t < a.num_os && s.scount[t] != 0)
        atomicAdd(a.counts + f * a.num_os + t, s.scount[t]);
    if (t == 0) a.tcount[tile] = (unsigned long long)s.total;
}

// Diagonal tile `tile` (j of fragment f): its codes, words, slot sets,
// counts and compacted list.
__device__ void dense_tile_block(const DenseArgs& a, DenseShared& s,
                                 const DenseTile& d, int tile)
{
    const int f = tile / a.nb, j = tile % a.nb;
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        tile_init(a, d, t);
        if (t < MAX_SLOTS) s.scount[t] = 0;
        if (t == 0) {
            s.before = 0;
            s.n_list = 0;
            s.flen = __ldg(a.frag_lens + f);
        }
    }
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i)
        tile_scatter(a, s, d, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i)
        tile_delta_sum(a, s, d, j, THREAD(i));
    __syncthreads();
    block_scan(s.part, s.wsum, &s.total);
    for (int i = 0; i < BLOCK_THREADS; ++i)
        tile_codes(a, s, d, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i)
        tile_words(a, s, d, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) tile_probe(a, s, d, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) tile_count(a, s, d, THREAD(i));
    __syncthreads();
    block_scan(s.part, s.wsum, &s.total);
    for (int i = 0; i < BLOCK_THREADS; ++i)
        tile_publish(a, s, d, f, tile, THREAD(i));
}

// ---- launch 3: a fragment's scan over its tiles ------------------------------

// Fragment f: every tile's counts summed over the tiles before it
// (tprefix), DENSE_THREADS tiles a round; the totals give overflow; the
// tile holding the cap-th non-empty diagonal is found on the way, and the
// pairs of its diagonals below cap give n_cand (all pairs when there are
// no more than cap non-empty diagonals), and placed = min(n_cand, cap) for
// the fill tiles.
__device__ void dense_scan_block(const DenseArgs& a, DenseShared& s, int f)
{
    const unsigned long long* tc = a.tcount + (size_t)f * a.nb;
    unsigned long long* tp = a.tprefix + (size_t)f * a.nb;
    long long carry = 0;
    for (int i = 0; i < BLOCK_THREADS; ++i)
        if (THREAD(i) == 0) s.cross = -1;
    for (int k0 = 0; k0 < a.nb; k0 += DENSE_THREADS) {
        __syncthreads();
        for (int i = 0; i < BLOCK_THREADS; ++i) {
            const int t = THREAD(i), k = k0 + t;
            s.part[t] = k < a.nb ? (long long)tc[k] : 0;
        }
        __syncthreads();
        block_scan(s.part, s.wsum, &s.total);
        for (int i = 0; i < BLOCK_THREADS; ++i) {
            const int t = THREAD(i), k = k0 + t;
            if (k >= a.nb) continue;
            const long long pre = carry + s.part[t];
            tp[k] = (unsigned long long)pre;
            const long long D = pre >> CNT_POS_SHIFT;
            const long long n = (long long)(tc[k] >> CNT_POS_SHIFT);
            if (D < a.cap && D + n >= a.cap) {
                s.cross = k;
                s.cross_prior = pre;
            }
        }
        carry += s.total;
    }
    __syncthreads();
    const long long n_pos = carry >> CNT_POS_SHIFT;
    const long long n_pairs = carry & (long long)CNT_PAIRS;
    // the crossing tile's pairs of its first cap - D diagonals
    const int cross = s.cross;
    const long long D = cross >= 0 ? s.cross_prior >> CNT_POS_SHIFT : 0;
    const int need = cross >= 0 ? (int)(a.cap - D) : 0;
    const unsigned long long* set =
        a.dset + (size_t)(f * a.nb + (cross >= 0 ? cross : 0)) * a.span;
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        long long c = 0;
        for (int e = t; e < need; e += DENSE_THREADS) c += __popcll(set[e]);
        s.part[t] = c;
    }
    __syncthreads();
    block_scan(s.part, s.wsum, &s.total);
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        if (THREAD(i) != 0) continue;
        const long long n_cand = n_pos <= a.cap ? n_pairs
            : (s.cross_prior & (long long)CNT_PAIRS) + s.total;
        a.n_cand[f] = (int)n_cand;
        a.overflow[f] = n_pos > a.cap || n_pairs > a.cap ? 1 : 0;
        a.placed[f] = (unsigned long long)min(n_cand, (long long)a.cap);
    }
}

// ---- launch 4: the pairs ------------------------------------------------------

// Block b of fragment f: a diagonal tile writes the pairs of its taken
// diagonals (rank D + r below cap) from place P on, in diagonal then slot
// order, below cap (a block scan of their pair counts, a thread a chunk of
// the tile's compacted list); a fill tile zeroes slot and p of
// [max(placed, i * FILL), (i + 1) * FILL) below cap.
__device__ void dense_emit_block(const DenseArgs& a, DenseShared& s, int b)
{
    const int f = b / (a.nb + a.nf), r = b % (a.nb + a.nf);
    int* slot = a.slot + (size_t)f * a.cap;
    int* pp = a.p + (size_t)f * a.cap;
    if (r >= a.nb) {
        const int i = r - a.nb;
        const long long lo = max((long long)a.placed[f],
                                 (long long)i * DENSE_FILL);
        const int hi = (int)min((long long)a.cap,
                                (long long)(i + 1) * DENSE_FILL);
        for (int k = 0; k < BLOCK_THREADS; ++k)
            for (long long z = lo + THREAD(k); z < hi; z += DENSE_THREADS) {
                slot[z] = 0;
                pp[z] = 0;
            }
        return;
    }
    const int tile = f * a.nb + r;
    const long long pre = (long long)a.tprefix[tile];
    const long long D = pre >> CNT_POS_SHIFT;
    if (D >= a.cap) return;
    const long long P = pre & (long long)CNT_PAIRS;
    const int take = (int)min((long long)(a.tcount[tile] >> CNT_POS_SHIFT),
                              a.cap - D);
    const int ch = (take + DENSE_THREADS - 1) / DENSE_THREADS;
    const unsigned long long* set = a.dset + (size_t)tile * a.span;
    const uint16_t* idx = a.didx + (size_t)tile * a.span;
    for (int k = 0; k < BLOCK_THREADS; ++k) {
        const int t = THREAD(k);
        long long c = 0;
        for (int e = t * ch; e < min(take, (t + 1) * ch); ++e)
            c += __popcll(set[e]);
        s.part[t] = c;
    }
    __syncthreads();
    block_scan(s.part, s.wsum, &s.total);
    const int p0 = r * a.span - a.max_words + 1;
    for (int k = 0; k < BLOCK_THREADS; ++k) {
        const int t = THREAD(k);
        long long g = P + s.part[t];
        for (int e = t * ch; e < min(take, (t + 1) * ch) && g < a.cap; ++e) {
            const int dg = idx[e];
            for (unsigned long long x = set[e]; x != 0 && g < a.cap;
                 x &= x - 1, ++g) {
                slot[g] = __ffsll((long long)x) - 1;
                pp[g] = p0 + dg;
            }
        }
    }
}

// ---- the C entry points -----------------------------------------------------

// A panel's part of the arguments, checked once: the dense tables, the
// static shapes and the card.  The step's call fills in the rest.
struct DensePlan {
    DenseArgs a;
    int device;
};

extern "C" int seed_dense_plan_bytes() { return (int)sizeof(DensePlan); }

// Fills `plan` (seed_dense_plan_bytes() bytes, 8-byte aligned) with the
// tables of ops/seed.py::dense_tables (hash: 1 << hash_bits int4; entries;
// filter: FILTER_WORDS words) and the tiling of the shapes; 0, or
// cudaErrorInvalidValue where a shape is refused.
extern "C" int seed_dense_plan(void* plan, const void* hash,
                               const void* entries, const void* filter,
                               int hash_bits, int L, int word_len,
                               int num_os, int max_words, int cap,
                               int device)
{
    if (word_len < 1 || word_len > MAX_WORD_LEN || L < word_len || L % 4 != 0
        || L > MAX_TILE || num_os < 1 || num_os > MAX_SLOTS || max_words < 1
        || max_words > MAX_WORDS || cap < 1 || hash_bits < 1
        || hash_bits > 24)
        return (int)cudaErrorInvalidValue;
    DensePlan* pl = (DensePlan*)plan;
    DenseArgs a = {};
    a.hash = (const int4*)hash;
    a.entries = (const int4*)entries;
    a.filter = (const unsigned*)filter;
    a.hash_bits = hash_bits;
    a.L = L;
    a.word_len = word_len;
    a.nw_pos = L - word_len + 1;
    a.num_os = num_os;
    a.max_words = max_words;
    a.cap = cap;
    a.span = max_words > DENSE_WIDE_WORDS ? DENSE_SPAN_WIDE : DENSE_SPAN;
    a.nb = (a.nw_pos + max_words - 1 + a.span - 1) / a.span;
    a.nf = (cap + DENSE_FILL - 1) / DENSE_FILL;
    a.ncodes = a.span + max_words - 1 + word_len - 1;
    a.smem = dense_smem(a.span, a.ncodes);
    pl->a = a;
    pl->device = device;
    return 0;
}

// The tiling a plan took: diagonals a tile, tiles a fragment, launch 2's
// dynamic shared memory (bytes), in out[0..2].
extern "C" void seed_dense_plan_tiling(const void* plan, int* out)
{
    const DenseArgs& a = ((const DensePlan*)plan)->a;
    out[0] = a.span;
    out[1] = a.nb;
    out[2] = a.smem;
}

// int32 words of scratch a call on n fragments needs under a plan, n
// times a fragment's: its tiles' counts and their prefix sums, its placed
// word (64 bits each), its tiles' compacted slot sets (64 bits each) and
// their offsets (16 bits each), span a tile.
extern "C" long long seed_dense_scratch_words(const void* plan, int n)
{
    const DenseArgs& a = ((const DensePlan*)plan)->a;
    const long long per = 2 * (2LL * a.nb + 1) + 2LL * a.nb * a.span
        + (long long)a.nb * a.span / 2;
    return (long long)n * per;
}

// The step's call: seeds n fragments under a plan, on the plan's card, on
// `stream`.  Pointers: the payload (packed, frag_lens, nrun_s, nrun_e,
// exc_p, exc_c; n_runs runs and n_exc exceptions a fragment), the seven
// outputs (slot, p, n_cand, counts, overflow, word, word_valid) and
// seed_dense_scratch_words(plan, n) int32 words of scratch (on 8 bytes),
// any values.  0, cudaErrorInvalidValue for n < 1, a negative count or
// misaligned scratch, or a launch's CUDA error.
extern "C" int seed_dense_launch_plan(
    const void* plan, const void* packed, const void* frag_lens,
    const void* nrun_s, const void* nrun_e, const void* exc_p,
    const void* exc_c, void* slot, void* p, void* n_cand, void* counts,
    void* overflow, void* word, void* word_valid, void* scratch, int n,
    int n_runs, int n_exc, void* stream)
{
    if (n < 1 || n > 65535 || n_runs < 0 || n_exc < 0
        || (uintptr_t)scratch % 8 != 0)
        return (int)cudaErrorInvalidValue;
    DenseArgs a = ((const DensePlan*)plan)->a;
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
    a.tcount = (unsigned long long*)scratch;
    a.tprefix = a.tcount + (size_t)n * a.nb;
    a.placed = a.tprefix + (size_t)n * a.nb;
    a.dset = a.placed + n;
    a.didx = (uint16_t*)(a.dset + (size_t)n * a.nb * a.span);
    return run(a, ((const DensePlan*)plan)->device, stream);
}
