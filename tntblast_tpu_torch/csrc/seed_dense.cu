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
// The two launches (DENSE_THREADS threads a block):
//  1. head: resets what launch 2 reads before it writes: the tiles'
//     look-back status words, the fragments' fill words and counts, and the
//     tile counter, so that every call, and every replay of a CUDA graph of
//     one, starts from zero (another graph may reuse the scratch between
//     replays).
//  2. tiles: the blocks take tickets from the tile counter: every
//     fragment's diagonal tiles in order, then the fill tiles.  Diagonal
//     tile j of fragment f holds the diagonals p in [P0, P0 + SPAN), P0 =
//     j * SPAN - MW + 1, whose positions q = p + k are exactly [P0, (j + 1)
//     * SPAN): the tile's own span and the MW - 1 before it.  The block
//     scatters the fragment's run ends and exceptions that fall in its
//     codes into shared memory (the run ends before them into one count),
//     sums the deltas (a block scan), builds its codes, then a thread a
//     position computes the word and its validity, stores them where the
//     position is the tile's own, and for a valid word that the panel's
//     filter bits may hold looks it up in the hash and ORs each entry's
//     slot set into U[q - k] in shared memory where that diagonal is the
//     tile's.  A thread then holds SPAN / THREADS consecutive diagonals:
//     their non-empty count and pair count (one 64-bit block scan of
//     both), the per-slot counts (shared atomics, one global atomic a slot
//     a tile).  A single-pass decoupled look-back over the fragment's
//     earlier tiles (a status word holding state, the diagonal count and
//     the pair count; a tile waits only on tiles of lower tickets, which
//     started before it and never wait on it) gives the tile D, the
//     non-empty diagonals before it, and P, their pairs.  Its diagonals of
//     rank D + r < cap are the taken ones (a prefix in diagonal order, so
//     every pair before a taken diagonal is counted in P), and their pairs
//     go to slot/p from P on, below cap.  The tile holding the cap-th
//     non-empty diagonal (or the last tile, when there are fewer) writes
//     n_cand and the fragment's fill word; the last tile writes overflow.
//     A fill tile waits for the fill word and zeroes slot and p from
//     min(n_cand, cap) to cap, DENSE_FILL places each.
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
// random position at 3456 oligo words of 16384 values).  A simple first
// form: each block reads the whole run and exception lists of its fragment
// (from L2), its filter bits, and computes a word from w shared loads.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3h,
// the long-probe step of tools/probe_bench.py, 511159 pairs): ptxas 39
// registers, 39136 bytes of shared memory, 0 stack, 0 spill (head: 12
// registers); 0.0916 ms alone (a CUDA graph of 20 calls; head 0.0012,
// tiles 0.0896 by torch.profiler), 46.9 us of host time a lean call,
// against a bound of 0.0091 ms by bytes (10.0%) and 167 ms for the plain
// version.
//
// The host build (-DSEED_DENSE_HOST, tests/test_torch_seed_dense.py, g++
// behind tests/cuda_host_shim/cuda_runtime.h): launch 1 block by block,
// launch 2 block by block, so the tiles run in ticket order and a look-back
// never waits (one that would is a fault the launch returns); odd tiles
// keep their own counts (not their inclusive sums), so that look-backs sum
// back over them as on the card.  A block's threads are played phase by
// phase through the thread loops below (BLOCK_THREADS; in reverse order
// with seed_dense_host_reverse, so no phase may depend on the order of its
// threads).  The block scans and the look-back have host forms.

#include <cuda_runtime.h>
#include <stdint.h>

#define DENSE_THREADS 256
#define DENSE_WARPS (DENSE_THREADS / 32)
#define DENSE_SPAN 2048         // diagonals a tile
#define DENSE_PER_THREAD (DENSE_SPAN / DENSE_THREADS)
#define DENSE_FILL 8192         // slot/p places a fill tile zeroes
#define MAX_WORD_LEN 15         // ops/seed.py DENSE_MAX_WORD_LEN: 30 bits
#define MAX_WORDS 256           // ops/seed.py DENSE_MAX_WORDS
#define MAX_SLOTS 64            // a diagonal's slots in one 64-bit set
#define MAX_TILE (1 << 26)      // counts fit the status word's fields
#define DENSE_CODES (DENSE_SPAN + MAX_WORDS + MAX_WORD_LEN)
#define FILTER_BITS 15          // ops/seed.py DENSE_FILTER_BITS
#define FILTER_WORDS ((1 << FILTER_BITS) / 32)
#define HASH_MUL 2654435761u    // ops/seed.py DENSE_HASH_MUL
#define NO_EXC 0xFFFF          // above every uint8 code
#define DB_MAX_ATGC 3           // constants.py DB_T
#define DB_N 15                 // constants.py DB_N
#define DB_UNKNOWN 17           // constants.py DB_UNKNOWN

// A tile's look-back status: state in bits 62-63 (0 not yet, 1 its own
// counts, 2 every count up to it), the non-empty diagonals in bits 33-60,
// their pairs in bits 0-32.  A fragment's fill word: bit 63 once written,
// the places slot/p hold below.
#define ST_AGGREGATE (1ull << 62)
#define ST_INCLUSIVE (2ull << 62)
#define ST_COUNT ((1ull << 61) - 1)
#define ST_PAIRS ((1ull << 33) - 1)
#define ST_POS_SHIFT 33
#define FILL_READY (1ull << 63)

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
    unsigned long long* status;     // scratch: a tile's look-back word
    unsigned long long* fill;       // scratch: a fragment's fill word
    unsigned* ticket;               // scratch: launch 2's tile counter
    int n, L, word_len, nw_pos, num_os, max_words, cap, n_runs, n_exc;
    int hash_bits, nb, nf, per;     // diagonal and fill tiles a fragment,
                                    // tickets a fragment
};

// Launch 2's block: its codes, its diagonals' slot sets, what the scans
// and the look-back carry.
struct alignas(16) DenseShared {
    int delta[DENSE_CODES];             // run starts - run ends
    unsigned filter[FILTER_WORDS];
    unsigned ulo[DENSE_SPAN], uhi[DENSE_SPAN];  // slots 0-31, 32-63 of U
    long long part[DENSE_THREADS];      // scans: a thread's share
    long long wsum[DENSE_WARPS];
    int scount[MAX_SLOTS];
    uint16_t exc[DENSE_CODES];          // an exception's code, or NO_EXC
    uint8_t code[DENSE_CODES];
    long long total, prior;
    int tile, before, flen, taken, n_fill;
};

__device__ void dense_block(const DenseArgs& a, DenseShared& s);

#ifdef SEED_DENSE_HOST
#define BLOCK_THREADS DENSE_THREADS     // the host thread plays every thread
static int host_reverse;                // play each phase's threads backwards
#define THREAD(i) (host_reverse ? DENSE_THREADS - 1 - (i) : (i))
#define ME 0                            // the look-back's one host form

static void status_store(unsigned long long* at, unsigned long long v)
{
    *at = v;
}

// A status word of state `ready` or later.  With the tiles played in
// ticket order an earlier tile has always published: one that has not is
// a fault.
static unsigned long long status_wait(const unsigned long long* at,
                                      unsigned ready)
{
    const unsigned long long v = *at;
    if ((unsigned)(v >> 62) < ready) host_fault = cudaErrorLaunchFailure;
    return v;
}

static unsigned long long fill_wait(const unsigned long long* at)
{
    const unsigned long long v = *at;
    if ((v & FILL_READY) == 0) host_fault = cudaErrorLaunchFailure;
    return v;
}

// Tile j's inclusive counts into its status word.  Played in ticket order
// every earlier tile would hold its inclusive sum; keeping the odd tiles'
// own counts (but the last's) makes the look-backs sum own counts back to
// an inclusive word, as on the card, where the tiles run at once.
static void publish_inclusive(const DenseArgs& a, unsigned long long* st,
                              int j, unsigned long long incl)
{
    if (j % 2 == 0 || j == a.nb - 1) status_store(st + j, incl);
}

// Tile j's look-back over its fragment's status words: publishes its own
// counts, then sums the earlier tiles' back to the first inclusive one.
static unsigned long long lookback(unsigned long long* st, int j,
                                   unsigned long long own)
{
    unsigned long long prior = 0;
    if (j == 0) return prior;
    status_store(st + j, ST_AGGREGATE | own);
    for (int k = j - 1; k >= 0; --k) {
        const unsigned long long v = status_wait(st + k, 1);
        prior += v & ST_COUNT;
        if ((v >> 62) == 2) break;
    }
    return prior;
}

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

__device__ void dense_head(const DenseArgs& a, int b, int t);

// the CPU tests' build: each launch block by block
static int run(const DenseArgs& a, int device, void* stream)
{
    (void)device;
    (void)stream;
    static DenseShared sh;
    host_fault = 0;
    const int heads = (a.n * a.nb + DENSE_THREADS - 1) / DENSE_THREADS;
    for (int bb = 0; bb < heads; ++bb) {
        const int b = host_reverse ? heads - 1 - bb : bb;
        for (int i = 0; i < DENSE_THREADS; ++i) dense_head(a, b, THREAD(i));
    }
    for (int i = 0; i < a.n * a.per && host_fault == 0; ++i)
        dense_block(a, sh);
    return host_fault;
}
#else
#define BLOCK_THREADS 1                 // a thread plays itself
#define THREAD(i) ((int)threadIdx.x)
#define ME ((int)threadIdx.x)

// A status word carries all a tile hands on (state and both counts in one
// 64-bit word, read and written whole), so relaxed loads and stores at the
// card's scope order enough.
__device__ __forceinline__ unsigned long long status_load(
    const unsigned long long* at)
{
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(at));
    return v;
}

__device__ __forceinline__ void status_store(unsigned long long* at,
                                             unsigned long long v)
{
    asm volatile("st.relaxed.gpu.u64 [%0], %1;" :: "l"(at), "l"(v));
}

__device__ __forceinline__ unsigned long long status_wait(
    const unsigned long long* at, unsigned ready)
{
    unsigned long long v = status_load(at);
    while ((unsigned)(v >> 62) < ready) v = status_load(at);
    return v;
}

// The fill word once written.  It is written after the writer's slot/p
// stores, which a fill tile never touches (it zeroes only places past
// them), so a relaxed load orders enough here too.
__device__ __forceinline__ unsigned long long fill_wait(
    const unsigned long long* at)
{
    unsigned long long v = status_load(at);
    while ((v & FILL_READY) == 0) v = status_load(at);
    return v;
}

__device__ __forceinline__ void publish_inclusive(const DenseArgs& a,
                                                  unsigned long long* st,
                                                  int j,
                                                  unsigned long long incl)
{
    (void)a;
    status_store(st + j, incl);
}

// Tile j's look-back by the lanes of one warp: publishes its own counts,
// then reads the 32 earlier tiles' words at once, each lane waiting for
// its own, and sums them back to the nearest inclusive one (before tile 0
// an inclusive 0), 32 more at a time until it finds one.
__device__ unsigned long long lookback(unsigned long long* st, int j,
                                       unsigned long long own)
{
    const int lane = (int)threadIdx.x & 31;
    unsigned long long prior = 0;
    if (j == 0) return prior;
    if (lane == 0) status_store(st + j, ST_AGGREGATE | own);
    for (int end = j;; end -= 32) {
        const int k = end - 1 - lane;
        const unsigned long long v =
            k >= 0 ? status_wait(st + k, 1) : ST_INCLUSIVE;
        const unsigned incl = __ballot_sync(0xffffffffu, (v >> 62) == 2);
        const int near = incl != 0 ? __ffs((int)incl) - 1 : 31;
        unsigned long long c = lane <= near ? v & ST_COUNT : 0;
        for (int d = 16; d > 0; d >>= 1)
            c += __shfl_xor_sync(0xffffffffu, c, d);
        prior += c;
        if (incl != 0) return prior;
    }
}

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

__device__ void dense_head(const DenseArgs& a, int b, int t);

__global__ void __launch_bounds__(DENSE_THREADS)
seed_dense_head_kernel(const DenseArgs a)
{
    dense_head(a, (int)blockIdx.x, (int)threadIdx.x);
}

__global__ void __launch_bounds__(DENSE_THREADS)
seed_dense_kernel(const DenseArgs a)
{
    __shared__ DenseShared s;
    dense_block(a, s);
}

// Queues the two launches on `stream` on card `device` (made current for
// the launches and restored); 0 or a CUDA error.
static int run(const DenseArgs& a, int device, void* stream)
{
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
    const int heads = (a.n * a.nb + DENSE_THREADS - 1) / DENSE_THREADS;
    seed_dense_head_kernel<<<(unsigned)heads, DENSE_THREADS, 0, st>>>(a);
    int rc = (int)cudaGetLastError();
    if (rc == 0) {
        seed_dense_kernel<<<(unsigned)(a.n * a.per), DENSE_THREADS, 0, st>>>(
            a);
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

// Thread t of head block b: the status words of tiles b * THREADS + t, and
// in block 0 the fragments' fill words and counts and the tile counter.
__device__ void dense_head(const DenseArgs& a, int b, int t)
{
    const int i = b * DENSE_THREADS + t;
    if (i < a.n * a.nb) a.status[i] = 0;
    if (b != 0) return;
    for (int f = t; f < a.n; f += DENSE_THREADS) a.fill[f] = 0;
    for (int c = t; c < a.n * a.num_os; c += DENSE_THREADS) a.counts[c] = 0;
    if (t == 0) *a.ticket = 0;
}

// ---- launch 2: the tiles ----------------------------------------------------

// The first code position of tile j and how many (its positions from P0,
// clamped at 0, and the w - 1 after its span, clamped at L).
__device__ __forceinline__ int codes_lo(const DenseArgs& a, int j)
{
    return max(j * DENSE_SPAN - a.max_words + 1, 0);
}

__device__ __forceinline__ int codes_len(const DenseArgs& a, int j)
{
    return min((j + 1) * DENSE_SPAN + a.word_len - 1, a.L) - codes_lo(a, j);
}

// Thread t's part of the shared state zeroed, and its share of the
// panel's filter bits loaded.
__device__ void tile_init(const DenseArgs& a, DenseShared& s, int t)
{
    for (int x = t; x < DENSE_CODES; x += DENSE_THREADS) {
        s.delta[x] = 0;
        s.exc[x] = NO_EXC;
    }
    for (int x = t; x < FILTER_WORDS; x += DENSE_THREADS)
        s.filter[x] = __ldg(a.filter + x);
    for (int d = t; d < DENSE_SPAN; d += DENSE_THREADS) {
        s.ulo[d] = 0;
        s.uhi[d] = 0;
    }
    if (t < MAX_SLOTS) s.scount[t] = 0;
}

// Thread t's share of the fragment's run ends and exceptions, those in the
// tile's codes scattered into shared memory, the run ends before them
// counted.
__device__ void tile_scatter(const DenseArgs& a, DenseShared& s, int f,
                             int j, int t)
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
        else if (x < nc) atomicAdd(&s.delta[x], 1);
        if (y < 0) before -= 1;
        else if (y < nc) atomicAdd(&s.delta[y], -1);
    }
    if (before != 0) atomicAdd(&s.before, before);
    for (int k = t; k < a.n_exc; k += DENSE_THREADS) {
        const int x = clampi(__ldg(ep + k), 0, a.L) - c0;
        if (x >= 0 && x < nc) s.exc[x] = __ldg(ec + k);
    }
}

// Thread t's contiguous chunk of the tile's codes.
__device__ __forceinline__ int chunk_of(int nc)
{
    return (nc + DENSE_THREADS - 1) / DENSE_THREADS;
}

__device__ void tile_delta_sum(const DenseArgs& a, DenseShared& s, int j,
                               int t)
{
    const int nc = codes_len(a, j), ch = chunk_of(nc);
    int sum = 0;
    for (int x = t * ch; x < min((t + 1) * ch, nc); ++x) sum += s.delta[x];
    s.part[t] = sum;
}

// The codes of thread t's chunk: the base, DB_UNKNOWN past the fragment,
// DB_N in a run, the exception last.
__device__ void tile_codes(const DenseArgs& a, DenseShared& s, int f, int j,
                           int t)
{
    const int c0 = codes_lo(a, j), nc = codes_len(a, j), ch = chunk_of(nc);
    const uint8_t* row = a.packed + (size_t)f * (a.L / 4);
    int c = s.before + (int)s.part[t];
    for (int x = t * ch; x < min((t + 1) * ch, nc); ++x) {
        c += s.delta[x];
        const int pos = c0 + x;
        int code = (__ldg(row + (pos >> 2)) >> (2 * (pos & 3))) & 3;
        if (pos >= s.flen) code = DB_UNKNOWN;
        if (c > 0) code = DB_N;
        if (s.exc[x] != NO_EXC) code = s.exc[x];
        s.code[x] = (uint8_t)code;
    }
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

// A thread a position q of the tile's [P0, (j + 1) * SPAN), clamped to
// [0, nw_pos): its word and validity, stored where q is the tile's own,
// and for a valid word the panel holds its entries ORed into U.
__device__ void tile_words(const DenseArgs& a, DenseShared& s, int f, int j,
                           int t)
{
    const int w = a.word_len, c0 = codes_lo(a, j);
    const int p0 = j * DENSE_SPAN - a.max_words + 1;
    const int own = j * DENSE_SPAN;
    const int hi = min((j + 1) * DENSE_SPAN, a.nw_pos);
    const unsigned wmask = (1u << (2 * w)) - 1;
    for (int q = max(p0, 0) + t; q < hi; q += DENSE_THREADS) {
        unsigned v = 0;
        bool ok = q < s.flen - w + 1;
        for (int k = 0; k < w; ++k) {
            const int c = s.code[q - c0 + k];
            v = (v << 2) | (unsigned)(c & 3);
            ok = ok && c <= DB_MAX_ATGC;
        }
        v &= wmask;
        if (q >= own) {
            const size_t at = (size_t)f * a.nw_pos + q;
            a.word[at] = (int)v;
            a.word_valid[at] = ok ? 1 : 0;
        }
        if (!ok) continue;
        const unsigned fb = (v * HASH_MUL) >> (32 - FILTER_BITS);
        if (((s.filter[fb >> 5] >> (fb & 31)) & 1u) == 0) continue;
        int first, count;
        lookup(a, (int)v, &first, &count);
        for (int e = first; e < first + count; ++e) {
            const int4 x = __ldg(a.entries + e);
            const int d = q - x.x - p0;
            if (d >= 0 && d < DENSE_SPAN) {
                if (x.y != 0) atomicOr(&s.ulo[d], (unsigned)x.y);
                if (x.z != 0) atomicOr(&s.uhi[d], (unsigned)x.z);
            }
        }
    }
}

// Thread t's diagonals: non-empty ones and their pairs (for the block
// scan, non-empty in the high half), their slots into the tile's counts.
__device__ void tile_count(DenseShared& s, int t)
{
    long long npos = 0, pairs = 0;
    for (int i = 0; i < DENSE_PER_THREAD; ++i) {
        const int d = t * DENSE_PER_THREAD + i;
        const unsigned long long x =
            (unsigned long long)s.uhi[d] << 32 | s.ulo[d];
        if (x == 0) continue;
        npos += 1;
        pairs += __popcll(x);
        for (unsigned long long y = x; y != 0; y &= y - 1)
            atomicAdd(&s.scount[__ffsll((long long)y) - 1], 1);
    }
    s.part[t] = npos << 32 | pairs;
}

// The tile's counts to the fragment's (one atomic a slot); then by warp 0
// the look-back, whose prior counts go to s.prior and whose inclusive sum
// is published; the last tile writes overflow.
__device__ void tile_publish(const DenseArgs& a, DenseShared& s, int f,
                             int j)
{
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        if (t < a.num_os && s.scount[t] != 0)
            atomicAdd(a.counts + f * a.num_os + t, s.scount[t]);
    }
    if (ME >= 32) return;
    unsigned long long* st = a.status + (size_t)f * a.nb;
    const unsigned long long own =
        (unsigned long long)(s.total >> 32) << ST_POS_SHIFT
        | (unsigned long long)(s.total & 0xFFFFFFFFll);
    const unsigned long long prior = lookback(st, j, own);
    if (ME != 0) return;
    const unsigned long long incl = prior + own;
    publish_inclusive(a, st, j, ST_INCLUSIVE | incl);
    s.prior = (long long)prior;
    if (j == a.nb - 1) {
        const long long n_pos = (long long)(incl >> ST_POS_SHIFT) & 0xFFFFFFF;
        const long long n_pairs = (long long)(incl & ST_PAIRS);
        a.overflow[f] = n_pos > a.cap || n_pairs > a.cap ? 1 : 0;
    }
}

// Thread t's taken diagonals (rank D + r below cap): their pairs counted
// into s.taken, those placed below cap stored in diagonal then slot order.
__device__ void tile_emit(const DenseArgs& a, DenseShared& s, int f, int j,
                          int t)
{
    const long long D = (s.prior >> ST_POS_SHIFT) & 0xFFFFFFF;
    const long long P = s.prior & (long long)ST_PAIRS;
    long long r = D + (s.part[t] >> 32);          // rank of the next one
    long long g = P + (s.part[t] & 0xFFFFFFFFll); // place of its first pair
    if (r >= a.cap) return;
    const int p0 = j * DENSE_SPAN - a.max_words + 1;
    int* slot = a.slot + (size_t)f * a.cap;
    int* pp = a.p + (size_t)f * a.cap;
    int taken = 0;
    for (int i = 0; i < DENSE_PER_THREAD && r < a.cap; ++i) {
        const int d = t * DENSE_PER_THREAD + i;
        unsigned long long x = (unsigned long long)s.uhi[d] << 32 | s.ulo[d];
        if (x == 0) continue;
        r += 1;
        taken += __popcll(x);
        for (; x != 0 && g < a.cap; x &= x - 1, ++g) {
            slot[g] = __ffsll((long long)x) - 1;
            pp[g] = p0 + d;
        }
    }
    if (taken != 0) atomicAdd(&s.taken, taken);
}

// The tile holding the cap-th non-empty diagonal, or the last tile when
// there are fewer: n_cand, and the fill word the fill tiles wait for.
__device__ void tile_close(const DenseArgs& a, DenseShared& s, int f, int j)
{
    const long long D = (s.prior >> ST_POS_SHIFT) & 0xFFFFFFF;
    const long long P = s.prior & (long long)ST_PAIRS;
    if (D >= a.cap || (D + (s.total >> 32) < a.cap && j != a.nb - 1))
        return;
    const long long n_cand = P + s.taken;
    a.n_cand[f] = (int)n_cand;
    status_store(a.fill + f,
                 FILL_READY | (unsigned long long)min(n_cand,
                                                      (long long)a.cap));
}

// Fill tile i of fragment f: once the fill word is out, slot and p of
// [max(placed, i * FILL), (i + 1) * FILL) below cap zeroed.
__device__ void tile_fill(const DenseArgs& a, DenseShared& s, int f, int i)
{
    for (int r = 0; r < BLOCK_THREADS; ++r)
        if (THREAD(r) == 0)
            s.n_fill = (int)(fill_wait(a.fill + f) & ~FILL_READY);
    __syncthreads();
    int* slot = a.slot + (size_t)f * a.cap;
    int* pp = a.p + (size_t)f * a.cap;
    const int hi = (int)min((long long)a.cap, (long long)(i + 1) * DENSE_FILL);
    for (int r = 0; r < BLOCK_THREADS; ++r)
        for (int z = max(s.n_fill, i * DENSE_FILL) + THREAD(r); z < hi;
             z += DENSE_THREADS) {
            slot[z] = 0;
            pp[z] = 0;
        }
}

__device__ void dense_block(const DenseArgs& a, DenseShared& s)
{
    for (int i = 0; i < BLOCK_THREADS; ++i)
        if (THREAD(i) == 0) s.tile = (int)atomicAdd(a.ticket, 1u);
    __syncthreads();
    if (s.tile >= a.n * a.nb) {         // the fill tiles come last
        const int i = s.tile - a.n * a.nb;
        tile_fill(a, s, i / a.nf, i % a.nf);
        return;
    }
    const int f = s.tile / a.nb, j = s.tile % a.nb;
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        tile_init(a, s, t);
        if (t == 0) {
            s.before = 0;
            s.taken = 0;
            s.flen = __ldg(a.frag_lens + f);
        }
    }
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) tile_scatter(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) tile_delta_sum(a, s, j, THREAD(i));
    __syncthreads();
    block_scan(s.part, s.wsum, &s.total);
    for (int i = 0; i < BLOCK_THREADS; ++i) tile_codes(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) tile_words(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) tile_count(s, THREAD(i));
    __syncthreads();
    block_scan(s.part, s.wsum, &s.total);
    tile_publish(a, s, f, j);
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) tile_emit(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i)
        if (THREAD(i) == 0) tile_close(a, s, f, j);
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
// filter: FILTER_WORDS words); 0, or cudaErrorInvalidValue where a shape
// is refused.
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
    a.nb = (a.nw_pos + max_words - 1 + DENSE_SPAN - 1) / DENSE_SPAN;
    a.nf = (cap + DENSE_FILL - 1) / DENSE_FILL;
    a.per = a.nb + a.nf;
    pl->a = a;
    pl->device = device;
    return 0;
}

// int32 words of scratch a call on n fragments needs under a plan, n
// times a fragment's: its tiles' status words, its fill word and one more
// 64-bit word (the tile counter follows the last fill word).
extern "C" long long seed_dense_scratch_words(const void* plan, int n)
{
    const DenseArgs& a = ((const DensePlan*)plan)->a;
    return 2 * (long long)n * (a.nb + 2);
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
    a.status = (unsigned long long*)scratch;
    a.fill = a.status + (size_t)n * a.nb;
    a.ticket = (unsigned*)(a.fill + n);
    return run(a, ((const DensePlan*)plan)->device, stream);
}
