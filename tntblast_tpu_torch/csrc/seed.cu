// Seeding of the device seed+screen step, as two launches of hand-written
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
// The two launches (SEED_THREADS threads a block):
//  1. words: grid (blocks of SEED_SPAN positions, n), in clusters of
//     SEED_CLUSTER blocks along a fragment.  A cluster reads its fragment's
//     run and exception lists once, split over its blocks, and each block
//     scatters what it reads into the shared memory of the blocks whose
//     codes it touches (distributed shared memory): +-1 run ends into their
//     delta arrays, the run ends before a block into its count at its
//     span's start, exception codes into their override arrays, and a mark
//     that the block has overrides.  So no block reads the whole lists
//     (most of their rows are pads at L), and their order does not matter.
//     Meanwhile cp.async brings the block's packed bases and the bits of
//     the words some oligo holds (aux: VF bit 0 a bit a word) into shared
//     memory.  A block with overrides (runs, exceptions or the fragment's
//     end in its codes) then sums its deltas (a warp scan) and builds its
//     codes (its span plus w - 1); one without reads its codes as the
//     packed bases.  A thread writes word and word_valid of 8 consecutive
//     positions at a time, each word one field of the codes in reverse
//     order, with two 16-byte and one 8-byte store (groups aligned in the
//     whole (n, nw_pos) array: a fragment's row need not start on 16
//     bytes), then the in-position bits (before truncation) and the
//     block's count of them.  At its end it resets what launch 2 reads
//     before writing: the fragment's counts, its tiles' look-back status
//     words and the tile counter (not before the cluster barriers, which
//     would wait for the stores).
//  2. keys: one block a tile, the tiles taken in ticket order from an
//     atomic counter (every fragment's key tiles in order, then the fill
//     tiles).  A key tile j of fragment f, diagonals p in [j * SPAN - MW +
//     1, (j + 1) * SPAN - MW + 1), reads the in-position bits of [j * SPAN
//     - 32, (j + 1) * SPAN); launch 1's counts before it (a block scan)
//     give each bit's rank, and bits of rank >= cap are dropped (the
//     truncation; a drop flags the fragment).  The kept in-positions go to
//     a list; a thread a kept position q reads its word, which of its KS
//     entries hold slots (aux: a bit mask a word, bit 31 the residue), then
//     those entries with their loads in flight together (most of a row is
//     empty), and ORs each KS[word][k] into U[q - k] where that diagonal is
//     the tile's (shared atomicOr, and a bit that U[q - k] is not empty), so
//     U is built once and no load waits on another but the word's.  A
//     thread holds SEED_PER_THREAD consecutive diagonals and visits only the
//     non-empty ones: its keys, a block scan of them, the per-slot counts
//     by a warp vote (the lanes holding one slot add their popcount once;
//     one global atomic a slot a tile).  The tile's offset comes from a
//     single-pass decoupled look-back over its fragment's earlier tiles
//     (status words holding state, the overflow flag and the count in one
//     64-bit word; a tile waits only on tiles of lower tickets, which
//     started before it and never wait on it), then its keys are stored in
//     order below cap.  The fragment's last key tile writes n_cand and
//     overflow; the fill tiles wait for that total and zero slot and p from
//     n_cand to cap, SEED_FILL slots each.
// Integer arithmetic throughout: the kernel equals the plain version bit for
// bit by construction.
//
// What the kernel relies on.  frag_lens, runs and exceptions as the panel
// packs them (DevicePanel._pack_host): each exception position at most once
// (two codes for one position would race here, as they would in the JAX
// scatter); their order does not matter, and pads anywhere in the list are
// dropped.  Run ends in any order, overlapping or not.  The KS table of the
// panel's w_table and the tables derived from it and VF (the plan holds
// them, ops/seed.py::aux_tables).  word 16-byte and word_valid 8-byte
// aligned (the launch refuses others; PyTorch's allocations are).  Scratch
// needs no initial value: launch 1 resets what launch 2 reads.
//
// What bounds it on the H100: bytes.  A bench step (8 fragments of 2^19, w
// 7, cap 45056) reads 1 MB of packed bases, 0.1 MB of runs and exceptions,
// the 16 KB VF table and the KS rows of the words at its in-positions (at
// most the 720 words the 40 slots hold, 144 B a row: 0.1 MB), and writes
// 16.8 MB of words, 4.2 MB of validity and 2.9 MB of slot/p: about 25 MB,
// 0.0075 ms at 3.35e12 B/s.  Launch 1 is that store stream (a warp writes
// 1 KB of words at once); launch 2 reads 0.5 MB of bits, the words of the
// in-positions (4% of positions here) and their KS entries that hold
// slots, and writes the keys.  Both are held off that bound by latency:
// each block is a short chain of dependent steps (loads, barriers, the
// look-back) and a bench step is about two waves of blocks.
//
// The host build (-DSEED_HOST, tests/test_torch_seed.py, g++ behind
// tests/cuda_host_shim/cuda_runtime.h): launch 1 cluster by cluster, each
// phase over the cluster's blocks before the next (the cluster barriers),
// launch 2 block by block, so the tiles run in ticket order and a look-back
// never waits (one that would is a fault the launch returns); a block's
// threads phase by phase through the thread loops below, which run over one
// thread on the card (BLOCK_THREADS).  What a thread carries across a
// barrier lives in the block's shared struct.  The warp collectives (the
// scan, the slot counts, the look-back) have a host form that computes the
// same sums from shared memory, and the 16-byte shared and global accesses
// and cp.async copies a plain one (the global stores through the shim's
// alignment check).

#include <cuda_runtime.h>
#include <stdint.h>

#define SEED_THREADS 256
#define SEED_WARPS (SEED_THREADS / 32)
#define SEED_SPAN 4096      // positions (launch 1) or diagonals (2) a block
#define SEED_PER_THREAD (SEED_SPAN / SEED_THREADS)
#define SEED_CLUSTER 8      // launch 1's blocks sharing a sideband read
#define SEED_GROUP 8        // positions a thread stores at once (launch 1)
#define SEED_FILL 8192      // slots a fill tile zeroes
#define SEED_HALO 32        // in-position bits before a tile's diagonals
#define SEED_RANGE (SEED_HALO + SEED_SPAN)
#define SEED_RANGE_WORDS (SEED_RANGE / 32 + 1)  // and one word of zeros
#define SEED_CODES (SEED_SPAN + MAX_WORD_LEN)
#define SEED_PK (SEED_CODES / 16 + 2)   // packed words: a guard, the codes
#define SEED_HELD ((1 << (2 * MAX_WORD_LEN)) / 32)  // aux's held bits, at
                                                    // most
#define SEED_KS 4           // KS entries a thread has in flight (launch 2)
#define MAX_WORD_LEN 8      // ops/seed.py MAX_WORD_LEN
#define MAX_WORDS 31        // ops/seed.py MAX_WORDS: MW + HALO's bound
#define MAX_SLOTS 64        // ops/seed.py MAX_SLOTS: a 64-bit slot set
#define DB_MAX_ATGC 3       // constants.py DB_T
#define DB_N 15             // constants.py DB_N
#define DB_UNKNOWN 17       // constants.py DB_UNKNOWN

// A tile's look-back status: state in bits 62-63 (0 not yet, 1 its own
// keys, 2 every key up to it), the overflow flag in bit 61, a count below.
#define ST_AGGREGATE (1ull << 62)
#define ST_INCLUSIVE (2ull << 62)
#define ST_FLAG (1ull << 61)
#define ST_COUNT (ST_FLAG - 1)

struct SeedArgs {
    const uint8_t* packed;          // (n, L / 4)
    const int *frag_lens, *nrun_s, *nrun_e, *exc_p;
    const uint8_t* exc_c;
    const unsigned long long* ks;   // (4^w, MW) slot sets
    const unsigned* held;           // (4^w / 32,) VF bit 0, a bit a word
    const unsigned* kmask;          // (4^w,) bit k: KS[v][k] not empty;
                                    // bit 31: VF bit 1
    int *slot, *p, *n_cand, *counts;
    uint8_t* overflow;
    int* word;
    uint8_t* word_valid;
    unsigned long long* status;     // scratch: a key tile's look-back word
    int* cnt1;                      // scratch: in-positions a block
    unsigned* bits;                 // scratch: in-position bits
    unsigned* ticket;               // scratch: launch 2's tile counter
    int n, L, word_len, nw_pos, num_os, max_words, cap, n_runs, n_exc;
    int nb1, gx, nb2, nf, per, nbits;   // blocks of launch 1 (gx with the
                                        // cluster's pad), key and fill
                                        // tiles a fragment, tickets a
                                        // fragment, bit words a fragment
};

// Launch 1's block: its span's codes and what the scatter and scan carry.
struct alignas(16) WordsShared {
    int delta[SEED_CODES];              // run starts - run ends
    uint16_t exc[SEED_CODES];           // an exception's code, or 0xFFFF
    uint8_t code[SEED_CODES];
    unsigned pk[SEED_PK];               // 2-bit bases, 16 a word
    int part[SEED_THREADS];
    int wsum[SEED_WARPS];
    unsigned in[SEED_SPAN / 32];        // in-position bits
    int nbase, count, total, flen, slow;
};
static_assert(SEED_PER_THREAD == 16, "a thread's codes are one pk word");

// Launch 2's block: its tile's diagonals' slot sets.
struct alignas(16) KeysShared {
    unsigned ulo[SEED_SPAN], uhi[SEED_SPAN];    // slots 0-31, 32-63 of U
    unsigned nz[SEED_SPAN / 32];            // bit d: U[d] is not empty
    int part[SEED_THREADS];
    int wsum[SEED_WARPS];
    int scount[MAX_SLOTS];
    uint16_t kept[SEED_RANGE];              // kept in-positions, in order
    unsigned raw[SEED_RANGE_WORDS];
    int tile, base, flag, nkept, total, n_cand, ranks;
    long long off;
};

__device__ void words_init(const SeedArgs& a, WordsShared& s, int f, int j);
__device__ void words_scatter(const SeedArgs& a, WordsShared& s, int f,
                              int j);
__device__ void words_finish(const SeedArgs& a, WordsShared& s, int f, int j);
__device__ void keys_block(const SeedArgs& a, KeysShared& s);
__device__ __forceinline__ unsigned own_sets(const KeysShared& s, int t);

#ifdef SEED_HOST
#define BLOCK_THREADS SEED_THREADS      // the host thread plays every thread
#define THREAD(i) (i)

static WordsShared* host_cluster;      // the cluster's blocks, in rank order
static int host_reverse;                // play each grid's blocks backwards

// Block `r` of the caller's cluster.
static WordsShared* peer(WordsShared& s, int r)
{
    (void)s;
    return host_cluster + r;
}

// 16 bytes of shared memory, each of its int32 words `v` (0 or -1).
static void fill16(void* at, int v)
{
    std::memset(at, v & 0xFF, 16);
}

// The words launch's bits of VF bit 0 (on the card in dynamic shared
// memory, its size from the word length), and its copies into shared
// memory, at once here.
static unsigned host_held[SEED_HELD];
static unsigned* held_words() { return host_held; }
static void copy4_async(void* dst, const void* src)
{
    std::memcpy(dst, src, 4);
}
static void copy_wait() {}

// A thread's SEED_PER_THREAD consecutive shared ints, 16-bit words, and
// its codes stored as bytes.
static void load_ints(const int* at, int (&v)[SEED_PER_THREAD])
{
    for (int i = 0; i < SEED_PER_THREAD; ++i) v[i] = at[i];
}

static void load_halves(const uint16_t* at, unsigned (&v)[SEED_PER_THREAD])
{
    for (int i = 0; i < SEED_PER_THREAD; ++i) v[i] = at[i];
}

static void store_bytes(uint8_t* at, const unsigned (&v)[SEED_PER_THREAD])
{
    for (int i = 0; i < SEED_PER_THREAD; ++i) at[i] = (uint8_t)v[i];
}

static void status_store(unsigned long long* at, unsigned long long v)
{
    *at = v;
}

// A status word of state `ready` or later (1: its tile's own count, 2: its
// inclusive sum).  With the tiles played in ticket order an earlier tile
// has always published: one that has not is a fault.
static unsigned long long status_wait(const unsigned long long* at,
                                      unsigned ready)
{
    const unsigned long long v = *at;
    if ((unsigned)(v >> 62) < ready) host_fault = cudaErrorLaunchFailure;
    return v;
}

// Tile j's inclusive sum into its status word.  Played in ticket order,
// every earlier tile would hold its inclusive sum, so a look-back would
// stop at once; keeping the odd tiles' own counts (but the last's, which
// the fill tiles wait for) makes the look-backs sum own counts back to an
// inclusive word, as on the card, where the tiles run at once.
static void publish_inclusive(const SeedArgs& a, unsigned long long* st,
                              int j, unsigned long long incl)
{
    if (j % 2 == 0 || j == a.nb2 - 1) status_store(st + j, incl);
}

// Tile j's look-back over its fragment's status words `st`: publishes its
// own count and flag `own`, then sums the earlier tiles' back to the first
// inclusive one; returns that count and flag.
static unsigned long long lookback(unsigned long long* st, int j,
                                   unsigned long long own)
{
    unsigned long long prior = 0;
    if (j == 0) return prior;
    status_store(st + j, ST_AGGREGATE | own);
    for (int k = j - 1; k >= 0; --k) {
        const unsigned long long v = status_wait(st + k, 1);
        prior = ((prior & ST_COUNT) + (v & ST_COUNT))
            | ((prior | v) & ST_FLAG);
        if ((v >> 62) == 2) break;
    }
    return prior;
}

// Exclusive prefix of part[] over the block's threads, in place; the sum
// into *total.
static void block_scan(int* part, int* wsum, int* total)
{
    (void)wsum;
    int sum = 0;
    for (int t = 0; t < SEED_THREADS; ++t) {
        const int v = part[t];
        part[t] = sum;
        sum += v;
    }
    *total = sum;
}

// Keys of each slot over the tile's diagonals into s.scount[].
static void slot_counts(KeysShared& s)
{
    for (int d = 0; d < SEED_SPAN; ++d) {
        for (unsigned x = s.ulo[d]; x != 0; x &= x - 1)
            s.scount[__ffs((int)x) - 1] += 1;
        for (unsigned x = s.uhi[d]; x != 0; x &= x - 1)
            s.scount[32 + __ffs((int)x) - 1] += 1;
    }
}

// 32 bytes of words and 8 of validity (bytes of `lo`, then of `hi`),
// through the shim's checked copy.
static void store_group(int* word, uint8_t* valid, const int (&w)[8],
                        unsigned lo, unsigned hi)
{
    host_copy(word, w, 16);
    host_copy(word + 4, w + 4, 16);
    if (reinterpret_cast<uintptr_t>(valid) % 8)
        host_fault = cudaErrorMisalignedAddress;
    std::memcpy(valid, &lo, 4);
    std::memcpy(valid + 4, &hi, 4);
}

extern "C" void seed_host_reverse(int on) { host_reverse = on; }

// the CPU tests' build: launch 1 a cluster at a time, phase by phase over
// its blocks; launch 2 block by block
static int run(const SeedArgs& a, int device, void* stream)
{
    (void)device;
    (void)stream;
    static WordsShared ws[SEED_CLUSTER];
    static KeysShared ks;
    host_fault = 0;
    host_cluster = ws;
    const int nc = a.gx / SEED_CLUSTER;
    for (int y = 0; y < a.n; ++y)
        for (int c = 0; c < nc; ++c) {
            const int f = host_reverse ? a.n - 1 - y : y;
            const int j0 = (host_reverse ? nc - 1 - c : c) * SEED_CLUSTER;
            for (int r = 0; r < SEED_CLUSTER; ++r) {
                const int b = host_reverse ? SEED_CLUSTER - 1 - r : r;
                words_init(a, ws[b], f, j0 + b);
            }
            for (int r = 0; r < SEED_CLUSTER; ++r) {
                const int b = host_reverse ? SEED_CLUSTER - 1 - r : r;
                words_scatter(a, ws[b], f, j0 + b);
            }
            for (int r = 0; r < SEED_CLUSTER; ++r) {
                const int b = host_reverse ? SEED_CLUSTER - 1 - r : r;
                words_finish(a, ws[b], f, j0 + b);
            }
        }
    for (int i = 0; i < a.n * a.per && host_fault == 0; ++i)
        keys_block(a, ks);
    return host_fault;
}
#else
#define BLOCK_THREADS 1                 // a thread plays itself
#define THREAD(i) ((int)threadIdx.x)

// The caller's struct in block `r` of its cluster (a generic address into
// that block's shared memory).
__device__ __forceinline__ WordsShared* peer(WordsShared& s, int r)
{
    unsigned long long out;
    asm volatile("mapa.u64 %0, %1, %2;"
                 : "=l"(out) : "l"((unsigned long long)&s), "r"(r));
    return (WordsShared*)out;
}

// Every thread of the cluster; release and acquire (the defaults).
__device__ __forceinline__ void cluster_sync()
{
    asm volatile("barrier.cluster.arrive.aligned;\n\t"
                 "barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ void fill16(void* at, int v)
{
    *(int4*)at = make_int4(v, v, v, v);
}

// A thread's SEED_PER_THREAD consecutive shared ints, 16-bit words, and
// its codes stored as bytes, as 16-byte accesses (the thread's run of
// words would otherwise meet bank conflicts, a warp's lanes SEED_PER_THREAD
// words apart).
__device__ __forceinline__ void load_ints(const int* at,
                                          int (&v)[SEED_PER_THREAD])
{
#pragma unroll
    for (int i = 0; i < SEED_PER_THREAD; i += 4) {
        const int4 x = *(const int4*)(at + i);
        v[i] = x.x;
        v[i + 1] = x.y;
        v[i + 2] = x.z;
        v[i + 3] = x.w;
    }
}

__device__ __forceinline__ void load_halves(const uint16_t* at,
                                            unsigned (&v)[SEED_PER_THREAD])
{
#pragma unroll
    for (int i = 0; i < SEED_PER_THREAD; i += 8) {
        const uint4 x = *(const uint4*)(at + i);
        const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            v[i + 2 * k] = w[k] & 0xFFFF;
            v[i + 2 * k + 1] = w[k] >> 16;
        }
    }
}

__device__ __forceinline__ void store_bytes(
    uint8_t* at, const unsigned (&v)[SEED_PER_THREAD])
{
#pragma unroll
    for (int i = 0; i < SEED_PER_THREAD; i += 16) {
        unsigned w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            w[k] = v[i + 4 * k] | v[i + 4 * k + 1] << 8
                | v[i + 4 * k + 2] << 16 | v[i + 4 * k + 3] << 24;
        *(uint4*)(at + i) = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

// The words launch's bits of VF bit 0, in dynamic shared memory (its size
// from the word length, set at the launch).
extern __shared__ unsigned seed_held[];
__device__ __forceinline__ unsigned* held_words() { return seed_held; }

// 4 bytes from global to shared memory without passing a register
// (cp.async): the block goes on while they land; copy_wait waits for the
// calling thread's copies.
__device__ __forceinline__ void copy4_async(void* dst, const void* src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copy_wait()
{
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// A status word carries all a tile hands on (state, flag and count in one
// 64-bit word, read and written whole), so relaxed loads and stores at
// the card's scope order enough: an acquire load would empty the SM's L1
// (which holds the KS rows) at each read of the spin.
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

// A status word once its tile has published state `ready` or later (1:
// its own count, 2: its inclusive sum); spins.
__device__ __forceinline__ unsigned long long status_wait(
    const unsigned long long* at, unsigned ready)
{
    unsigned long long v = status_load(at);
    while ((unsigned)(v >> 62) < ready) v = status_load(at);
    return v;
}

__device__ __forceinline__ void publish_inclusive(const SeedArgs& a,
                                                  unsigned long long* st,
                                                  int j,
                                                  unsigned long long incl)
{
    (void)a;
    status_store(st + j, incl);
}

// Tile j's look-back over its fragment's status words `st`, by the lanes
// of one warp: publishes its own count and flag `own`, then reads the 32
// earlier tiles' words at once, each lane waiting for its own, and sums
// them back to the nearest inclusive one (before tile 0, an inclusive 0),
// 32 more at a time until it finds one; returns that count and flag.
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
        const unsigned fl = __reduce_or_sync(
            0xffffffffu, lane <= near && (v & ST_FLAG) != 0 ? 1u : 0u);
        prior = ((prior & ST_COUNT) + c) | (prior & ST_FLAG)
            | (fl != 0 ? ST_FLAG : 0);
        if (incl != 0) return prior;
    }
}

// Exclusive prefix of part[] over the block's threads, in place (a warp
// scan by shuffles, then the warps' sums); the sum into *total.
__device__ void block_scan(int* part, int* wsum, int* total)
{
    const int t = (int)threadIdx.x, lane = t & 31, wp = t >> 5;
    const int v = part[t];
    int x = v;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) wsum[wp] = x;
    __syncthreads();
    if (t < 32) {
        const int ws = t < SEED_WARPS ? wsum[t] : 0;
        int e = ws;
        for (int d = 1; d < SEED_WARPS; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, e, d);
            if (lane >= d) e += y;
        }
        if (t < SEED_WARPS) wsum[t] = e - ws;
        if (t == SEED_WARPS - 1) *total = e;
    }
    __syncthreads();
    part[t] = x - v + wsum[wp];
    __syncthreads();
}

// Keys of each slot over the tile's diagonals into s.scount[]: each lane
// takes its next key (its non-empty sets in order, own_sets), the lanes
// holding the same slot find each other (a warp vote, __match_any_sync),
// and the first of them adds their popcount; a warp takes as many turns as
// its lane with the most keys has keys.
__device__ void slot_counts(KeysShared& s)
{
    const int t = (int)threadIdx.x, lane = t & 31;
    unsigned m = own_sets(s, t);
    unsigned long long x = 0;           // the lane's keys left in its set
    for (;;) {
        if (x == 0 && m != 0) {
            const int d = t * SEED_PER_THREAD + __ffs((int)m) - 1;
            m &= m - 1;
            x = (unsigned long long)s.uhi[d] << 32 | s.ulo[d];
        }
        if (__ballot_sync(0xffffffffu, x != 0) == 0) return;
        const int slot = x != 0 ? __ffsll((long long)x) - 1 : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, slot);
        if (x != 0 && lane == __ffs((int)peers) - 1)
            atomicAdd(&s.scount[slot], __popc(peers));
        x &= x - 1;
    }
}

__device__ __forceinline__ void store_group(int* word, uint8_t* valid,
                                            const int (&w)[8], unsigned lo,
                                            unsigned hi)
{
    *(int4*)word = make_int4(w[0], w[1], w[2], w[3]);
    *(int4*)(word + 4) = make_int4(w[4], w[5], w[6], w[7]);
    *(uint2*)valid = make_uint2(lo, hi);
}

__global__ void __cluster_dims__(SEED_CLUSTER, 1, 1)
__launch_bounds__(SEED_THREADS) seed_words_kernel(const SeedArgs a)
{
    __shared__ WordsShared s;
    const int f = (int)blockIdx.y, j = (int)blockIdx.x;
    words_init(a, s, f, j);
    cluster_sync();
    words_scatter(a, s, f, j);
    cluster_sync();
    words_finish(a, s, f, j);
}

__global__ void __launch_bounds__(SEED_THREADS)
seed_keys_kernel(const SeedArgs a)
{
    __shared__ KeysShared s;
    keys_block(a, s);
}

// Queues the two launches on `stream` on card `device` (made current for
// the launches and restored); 0 or a CUDA error.
static int run(const SeedArgs& a, int device, void* stream)
{
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
    const size_t held = 4 * (((1 << (2 * a.word_len)) + 31) / 32);
    seed_words_kernel<<<dim3((unsigned)a.gx, (unsigned)a.n), SEED_THREADS,
                        held, st>>>(a);
    int rc = (int)cudaGetLastError();
    if (rc == 0) {
        seed_keys_kernel<<<(unsigned)(a.n * a.per), SEED_THREADS, 0, st>>>(
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

// The lowest set bit's index of a nonzero 64-bit set.
__device__ __forceinline__ int low_bit(unsigned long long x)
{
    return __ffsll((long long)x) - 1;
}

// ---- launch 1: codes, words, in-positions ----------------------------------

// Positions of block j's codes: its span and the w - 1 after it, in L.
__device__ __forceinline__ int codes_len(const SeedArgs& a, int j)
{
    return clampi(a.L - j * SEED_SPAN, 0, SEED_SPAN + a.word_len - 1);
}

// The block's shared state, and its packed bases (2-bit codes from bit 0
// of pk[1], loaded while the cluster scatters; pk[0] a guard of zeros
// before them, zeros after them).  No global store here: the cluster
// barrier after would wait for it.
__device__ void words_init(const SeedArgs& a, WordsShared& s, int f, int j)
{
    const uint8_t* row = a.packed + (size_t)f * (a.L / 4)
        + (size_t)j * (SEED_SPAN / 4);
    const int nbytes = (codes_len(a, j) + 3) / 4;
    // whole words where the row's are aligned and the last ends in it (the
    // bytes past the codes then feed no stored word), else bytes
    const int nwords = (nbytes + 3) / 4;
    const bool whole = (uintptr_t)row % 4 == 0
        && j * (SEED_SPAN / 4) + 4 * nwords <= a.L / 4;
    uint8_t* pb = (uint8_t*)(s.pk + 1);
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        for (int x = t; x < SEED_CODES / 4; x += SEED_THREADS)
            fill16(s.delta + 4 * x, 0);
        for (int x = t; x < SEED_CODES / 8; x += SEED_THREADS)
            fill16(s.exc + 8 * x, -1);
        if (whole) {
            for (int x = t; x < SEED_PK - 1; x += SEED_THREADS) {
                if (x < nwords)
                    copy4_async(s.pk + 1 + x, (const unsigned*)row + x);
                else
                    s.pk[1 + x] = 0;
            }
        } else {
            for (int x = t; x < 4 * (SEED_PK - 1); x += SEED_THREADS)
                pb[x] = x < nbytes ? __ldg(row + x) : 0;
        }
        for (int x = t; x < ((1 << (2 * a.word_len)) + 31) / 32;
             x += SEED_THREADS)
            copy4_async(held_words() + x, a.held + x);
        if (t < SEED_SPAN / 32) s.in[t] = 0;
        if (t == 0) {
            s.pk[0] = 0;
            s.nbase = 0;
            s.count = 0;
            s.slow = 0;
            s.flen = __ldg(a.frag_lens + f);
        }
    }
}

// A +-1 run end at c (clamped to [0, L]) into the cluster's blocks: the
// delta of each block whose codes hold c, the span-start count of each
// block after it (each such block marked slow: its codes are not all
// bases).  `before` collects the ends before the cluster.
__device__ __forceinline__ void scatter_end(const SeedArgs& a, WordsShared& s,
                                            int j0, int c, int v,
                                            int& before)
{
    const int x0 = j0 * SEED_SPAN;
    if (c < x0) {
        before += v;
        return;
    }
    const int b = (c - x0) / SEED_SPAN;
    for (int bb = max(b - 1, 0); bb <= b && bb < SEED_CLUSTER; ++bb) {
        const int r = c - (x0 + bb * SEED_SPAN);
        if (r < codes_len(a, j0 + bb)) {
            WordsShared* o = peer(s, bb);
            atomicAdd(&o->delta[r], v);
            o->slow = 1;
        }
    }
    for (int bb = b + 1; bb < SEED_CLUSTER; ++bb) {
        WordsShared* o = peer(s, bb);
        atomicAdd(&o->nbase, v);
        o->slow = 1;
    }
}

// The block's share of the fragment's runs and exceptions, scattered into
// the cluster's blocks (pads at L fall in no block's codes).
__device__ void words_scatter(const SeedArgs& a, WordsShared& s, int f,
                              int j)
{
    const int rank = j % SEED_CLUSTER, j0 = j - rank;
    const int x0 = j0 * SEED_SPAN;
    const int stride = SEED_CLUSTER * SEED_THREADS;
    const int* rs = a.nrun_s + (size_t)f * a.n_runs;
    const int* re = a.nrun_e + (size_t)f * a.n_runs;
    const int* ep = a.exc_p + (size_t)f * a.n_exc;
    const uint8_t* ec = a.exc_c + (size_t)f * a.n_exc;
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        int before = 0;
        for (int k = rank * SEED_THREADS + t; k < a.n_runs; k += stride) {
            scatter_end(a, s, j0, clampi(__ldg(rs + k), 0, a.L), 1, before);
            scatter_end(a, s, j0, clampi(__ldg(re + k), 0, a.L), -1, before);
        }
        if (before != 0) {
            for (int bb = 0; bb < SEED_CLUSTER; ++bb) {
                WordsShared* o = peer(s, bb);
                atomicAdd(&o->nbase, before);
                o->slow = 1;
            }
        }
        for (int k = rank * SEED_THREADS + t; k < a.n_exc; k += stride) {
            const int pos = clampi(__ldg(ep + k), 0, a.L);
            if (pos < x0) continue;
            const int b = (pos - x0) / SEED_SPAN;
            for (int bb = max(b - 1, 0); bb <= b && bb < SEED_CLUSTER; ++bb) {
                const int r = pos - (x0 + bb * SEED_SPAN);
                if (r < codes_len(a, j0 + bb)) {
                    WordsShared* o = peer(s, bb);
                    o->exc[r] = __ldg(ec + k);
                    o->slow = 1;
                }
            }
        }
    }
}

// The sum of thread t's deltas: its SEED_PER_THREAD positions, and the
// last thread's the w - 1 after the span too.
__device__ void words_part(const SeedArgs& a, WordsShared& s, int j, int t)
{
    int d[SEED_PER_THREAD];
    load_ints(s.delta + t * SEED_PER_THREAD, d);
    int sum = 0;
#pragma unroll
    for (int u = 0; u < SEED_PER_THREAD; ++u) sum += d[u];
    if (t == SEED_THREADS - 1)
        for (int x = SEED_SPAN; x < codes_len(a, j); ++x) sum += s.delta[x];
    s.part[t] = sum;
}

// The codes of thread t's positions (and the last thread's w - 1 after
// the span), for a block with overrides: the base, DB_UNKNOWN past the
// fragment, DB_N in a run, the exception last.
__device__ void words_codes(const SeedArgs& a, WordsShared& s, int j, int t)
{
    const int x0 = j * SEED_SPAN + t * SEED_PER_THREAD;
    int d[SEED_PER_THREAD];
    unsigned e[SEED_PER_THREAD], code[SEED_PER_THREAD];
    load_ints(s.delta + t * SEED_PER_THREAD, d);
    load_halves(s.exc + t * SEED_PER_THREAD, e);
    const unsigned bases = s.pk[1 + t];
    int c = s.nbase + s.part[t];
#pragma unroll
    for (int u = 0; u < SEED_PER_THREAD; ++u) {
        c += d[u];
        code[u] = (bases >> (2 * u)) & 3;
        if (x0 + u >= s.flen) code[u] = DB_UNKNOWN;
        if (c > 0) code[u] = DB_N;
        if (e[u] != 0xFFFF) code[u] = e[u];
    }
    store_bytes(s.code + t * SEED_PER_THREAD, code);
    if (t != SEED_THREADS - 1) return;
    const uint8_t* pb = (const uint8_t*)(s.pk + 1);
    for (int x = SEED_SPAN; x < codes_len(a, j); ++x) {
        c += s.delta[x];
        int cx = (pb[x >> 2] >> (2 * (x & 3))) & 3;
        if (j * SEED_SPAN + x >= s.flen) cx = DB_UNKNOWN;
        if (c > 0) cx = DB_N;
        if (s.exc[x] != 0xFFFF) cx = s.exc[x];
        s.code[x] = (uint8_t)cx;
    }
}

// Bytes 0 or 1 of the four low bits of m.
__device__ __forceinline__ unsigned spread4(unsigned m)
{
    return (m & 1u) | ((m & 2u) << 7) | ((m & 4u) << 14) | ((m & 8u) << 21);
}

// word and word_valid of one group of SEED_GROUP positions from q0
// (aligned in the whole array), those in [x0, hi) stored (two 16-byte and
// one 8-byte store for a whole group); its in-positions before the
// truncation into s.in.  A block without overrides (`slow` false) reads
// its codes as the packed bases, one with them the codes it built.
__device__ void words_group(const SeedArgs& a, WordsShared& s, int f,
                            int x0, int hi, int q0, bool slow)
{
    const int w = a.word_len, r0 = q0 - x0;
    // the 2-bit codes of r0 .. r0 + 15, and which are above DB_T
    unsigned stream = 0, bad = 0;
    if (!slow) {
        const int r = r0 + 16;
        const unsigned long long v = s.pk[r >> 4]
            | (unsigned long long)s.pk[(r >> 4) + 1] << 32;
        stream = (unsigned)(v >> (2 * (r & 15)));
    } else {
#pragma unroll
        for (int m = 0; m < 16; ++m) {
            const int r = r0 + m;
            const int c = r >= 0 && r < SEED_CODES ? s.code[r] : 0;
            stream |= (unsigned)(c & 3) << (2 * m);
            bad |= (c > DB_MAX_ATGC ? 1u : 0u) << m;
        }
    }
    // the codes in reverse order, code m at bits 2 * (15 - m): the word at
    // r0 + u, its first code highest, is then one field of them
    unsigned rev = __brev(stream);
    rev = ((rev >> 1) & 0x55555555u) | ((rev & 0x55555555u) << 1);
    const unsigned mask = (1u << (2 * w)) - 1;
    int wv[SEED_GROUP];
#pragma unroll
    for (int u = 0; u < SEED_GROUP; ++u)
        wv[u] = (int)((rev >> (2 * (16 - u - w))) & mask);
    // valid: before the fragment's last word, and no code above DB_T in
    // the window (bit u of `bad` spread over the w - 1 positions before)
    const int n_in = clampi(s.flen - w + 1 - q0, 0, SEED_GROUP);
    unsigned valid = (1u << n_in) - 1;
    if (bad != 0) {
        unsigned hit = bad;
        for (int k = 1; k < w; ++k) hit |= bad >> k;
        valid &= ~hit;
    }
    const long long at = (long long)f * a.nw_pos + q0;
    if (q0 >= x0 && q0 + SEED_GROUP <= hi) {
        store_group(a.word + at, a.word_valid + at, wv, spread4(valid),
                    spread4(valid >> 4));
    } else {
#pragma unroll
        for (int u = 0; u < SEED_GROUP; ++u) {
            if (q0 + u >= x0 && q0 + u < hi) {
                a.word[at + u] = wv[u];
                a.word_valid[at + u] = (uint8_t)((valid >> u) & 1);
            }
        }
    }
    const unsigned* held = held_words();
    unsigned in = 0;                    // bit u: position q0 + u
#pragma unroll
    for (int u = 0; u < SEED_GROUP; ++u)
        if (((valid >> u) & 1) != 0 && q0 + u >= x0 && q0 + u < hi
            && ((held[wv[u] >> 5] >> (wv[u] & 31)) & 1) != 0)
            in |= 1u << u;
    if (in != 0 && r0 < 0) {            // 8 bits over one or two words
        atomicOr(&s.in[0], in >> -r0);
    } else if (in != 0) {
        atomicOr(&s.in[r0 >> 5], in << (r0 & 31));
        const unsigned up = (r0 & 31) > 32 - SEED_GROUP
            ? in >> (32 - (r0 & 31)) : 0u;
        if (up != 0) atomicOr(&s.in[(r0 >> 5) + 1], up);
    }
}

__device__ void words_bits(const SeedArgs& a, WordsShared& s, int f, int j,
                           int t)
{
    if (t >= SEED_SPAN / 32) return;
    const unsigned m = s.in[t];
    a.bits[(size_t)f * a.nbits + j * (SEED_SPAN / 32) + t] = m;
    if (m != 0) atomicAdd(&s.count, __popc(m));
}

// After the scatter: where the block has overrides, its deltas summed and
// its codes built; its words and bits, its count.
__device__ void words_finish(const SeedArgs& a, WordsShared& s, int f, int j)
{
    copy_wait();                    // the packed bases and VF's bits
    __syncthreads();
    const int x0 = j * SEED_SPAN;
    const bool slow = s.slow != 0 || s.flen < x0 + codes_len(a, j);
    if (slow) {
        for (int i = 0; i < BLOCK_THREADS; ++i) words_part(a, s, j, THREAD(i));
        __syncthreads();
        block_scan(s.part, s.wsum, &s.total);
        for (int i = 0; i < BLOCK_THREADS; ++i)
            words_codes(a, s, j, THREAD(i));
        __syncthreads();
    }
    if (j >= a.nb1) return;         // a cluster's pad: no position
    // groups aligned in the whole array: a fragment's row starts
    // (f * nw_pos) % SEED_GROUP elements past such a group
    const int hi = min(x0 + SEED_SPAN, a.nw_pos);
    const int q_first =
        x0 - (int)(((size_t)f * a.nw_pos + x0) % SEED_GROUP);
    const int groups = (hi - q_first + SEED_GROUP - 1) / SEED_GROUP;
    for (int i = 0; i < BLOCK_THREADS; ++i)
        for (int g = THREAD(i); g < groups; g += SEED_THREADS)
            words_group(a, s, f, x0, hi, q_first + SEED_GROUP * g, slow);
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) words_bits(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        if (t == 0) a.cnt1[f * a.nb1 + j] = s.count;
        // what launch 2 reads before it writes: the fragment's counts
        // (block 0), its tiles' status words, the tile counter
        for (int k = j + t * a.nb1; k < a.nb2; k += SEED_THREADS * a.nb1)
            a.status[(size_t)f * a.nb2 + k] = 0;
        if (j == 0 && t < a.num_os) a.counts[f * a.num_os + t] = 0;
        if (j == 0 && f == 0 && t == 0) *a.ticket = 0;
    }
}

// ---- launch 2: the tiles' slot sets, keys and fill -------------------------

// The tile's share of launch 1's counts before it (summed by the block
// scan after), its in-position bits (word 0 the halo), U and the slot
// counts zeroed.
__device__ void keys_load(const SeedArgs& a, KeysShared& s, int f, int j,
                          int t)
{
    int sum = 0;
    for (int i = t; i < min(j, a.nb1); i += SEED_THREADS)
        sum += a.cnt1[f * a.nb1 + i];
    s.part[t] = sum;
    if (t < SEED_RANGE_WORDS) {
        const int wi = j * (SEED_SPAN / 32) - 1 + t;
        s.raw[t] = t < SEED_RANGE_WORDS - 1 && wi >= 0 && wi < a.nbits
            ? a.bits[(size_t)f * a.nbits + wi] : 0u;
    }
    for (int d = t; d < SEED_SPAN / 4; d += SEED_THREADS) {
        fill16(s.ulo + 4 * d, 0);
        fill16(s.uhi + 4 * d, 0);
    }
    if (t < MAX_SLOTS) s.scount[t] = 0;
    if (t < SEED_SPAN / 32) s.nz[t] = 0;
}

// The in-position bits before each bit word of the range, for the block
// scan after.
__device__ void keys_ranks(KeysShared& s, int t)
{
    s.part[t] = t < SEED_RANGE_WORDS ? __popc(s.raw[t]) : 0;
}

// The truncation: in-positions of rank >= cap are dropped (a drop flags
// the fragment's overflow: it had more than cap of them); the kept ones go
// to the list in order, word t's from its rank in the range (the block
// scan of the words' popcounts).  The last word (zeros) gives the list's
// length.
__device__ void keys_truncate(const SeedArgs& a, KeysShared& s, int t)
{
    if (t >= SEED_RANGE_WORDS) return;
    const unsigned m = s.raw[t];
    const int r_range = s.base - __popc(s.raw[0]);  // rank of word 0's first
    const int room = max(a.cap - r_range, 0);       // the list's most
    int at = s.part[t];
    if (r_range + at + __popc(m) > a.cap) atomicOr(&s.flag, 1);
    for (unsigned x = m; x != 0 && at < room; x &= x - 1)
        s.kept[at++] = (uint16_t)(32 * t + __ffs((int)x) - 1);
    if (t == SEED_RANGE_WORDS - 1) s.nkept = min(at, room);
}

// The scatter: a thread a kept in-position q, its word, which of its KS
// entries hold slots (kmask; bit 31 a residue, more slots than s_max or
// word indices than k_max, which flags the fragment), then those entries,
// SEED_KS loads in flight together, each ORed into U[q - k] where that
// diagonal is the tile's.
__device__ void keys_scatter(const SeedArgs& a, KeysShared& s, int f, int j,
                             int t)
{
    const int* row = a.word + (size_t)f * a.nw_pos
        + (j * SEED_SPAN - SEED_HALO);
    const int mw = a.max_words;
    for (int i = t; i < s.nkept; i += SEED_THREADS) {
        const int r = s.kept[i];
        const int v = __ldg(row + r);
        unsigned km = __ldg(a.kmask + v);
        if ((km >> 31) != 0) atomicOr(&s.flag, 1);
        km &= 0x7FFFFFFFu;
        const unsigned long long* ks = a.ks + (size_t)v * mw;
        // diagonal index of list entry r, word index k: r - HALO - k + MW - 1
        const int d0 = r - SEED_HALO + mw - 1;
        while (km != 0) {
            unsigned long long x[SEED_KS];
            int d[SEED_KS];
#pragma unroll
            for (int u = 0; u < SEED_KS; ++u) {
                x[u] = 0;
                d[u] = -1;
                if (km != 0) {
                    const int k = __ffs((int)km) - 1;
                    km &= km - 1;
                    x[u] = __ldg(ks + k);
                    d[u] = d0 - k;
                }
            }
#pragma unroll
            for (int u = 0; u < SEED_KS; ++u) {
                if (d[u] >= 0 && d[u] < SEED_SPAN) {
                    if ((unsigned)x[u] != 0)
                        atomicOr(&s.ulo[d[u]], (unsigned)x[u]);
                    if ((unsigned)(x[u] >> 32) != 0)
                        atomicOr(&s.uhi[d[u]], (unsigned)(x[u] >> 32));
                    atomicOr(&s.nz[d[u] >> 5], 1u << (d[u] & 31));
                }
            }
        }
    }
}

// Thread t's keys over its SEED_PER_THREAD consecutive diagonals.
__device__ void keys_count(KeysShared& s, int t)
{
    int keys = 0;
    for (unsigned m = own_sets(s, t); m != 0; m &= m - 1) {
        const int d = t * SEED_PER_THREAD + __ffs((int)m) - 1;
        keys += __popc(s.ulo[d]) + __popc(s.uhi[d]);
    }
    s.part[t] = keys;
}

// The tile's offset and its fragment's total so far (the look-back, by
// warp 0), published with this tile's as its inclusive sum; the per-slot
// counts to the fragment's (one atomic a slot).
__device__ void keys_publish(const SeedArgs& a, KeysShared& s, int f, int j)
{
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        if (t < a.num_os && s.scount[t] != 0)
            atomicAdd(a.counts + f * a.num_os + t, s.scount[t]);
    }
    if (THREAD(0) >= 32) return;
    unsigned long long* st = a.status + (size_t)f * a.nb2;
    const unsigned long long own =
        (unsigned long long)s.total | (s.flag != 0 ? ST_FLAG : 0);
    const unsigned long long prior = lookback(st, j, own);
    if (THREAD(0) != 0) return;
    const unsigned long long incl =
        ((prior & ST_COUNT) + s.total) | ((prior | own) & ST_FLAG);
    publish_inclusive(a, st, j, ST_INCLUSIVE | incl);
    s.off = (long long)(prior & ST_COUNT);
    if (j == a.nb2 - 1) {
        const long long n_cand = (long long)(incl & ST_COUNT);
        a.n_cand[f] = (int)n_cand;
        a.overflow[f] = (incl & ST_FLAG) != 0 || n_cand > a.cap ? 1 : 0;
    }
}

// Thread t's keys from its offset, in diagonal then slot order, below cap.
__device__ void keys_emit(const SeedArgs& a, KeysShared& s, int f, int j,
                          int t)
{
    const int p0 = j * SEED_SPAN - a.max_words + 1;
    int* slot = a.slot + (size_t)f * a.cap;
    int* pp = a.p + (size_t)f * a.cap;
    long long g = s.off + s.part[t];
    for (unsigned m = own_sets(s, t); m != 0 && g < a.cap; m &= m - 1) {
        const int d = t * SEED_PER_THREAD + __ffs((int)m) - 1;
        for (unsigned long long x = (unsigned long long)s.uhi[d] << 32
                 | s.ulo[d];
             x != 0 && g < a.cap; x &= x - 1, ++g) {
            slot[g] = low_bit(x);
            pp[g] = p0 + d;
        }
    }
}

// Fill tile i of fragment f: once the fragment's last key tile has its
// total, slot and p of [max(n_cand, i * FILL), (i + 1) * FILL) below cap
// zeroed.
__device__ void keys_fill(const SeedArgs& a, KeysShared& s, int f, int i)
{
    for (int r = 0; r < BLOCK_THREADS; ++r)
        if (THREAD(r) == 0)
            s.n_cand = (int)min(
                (long long)(status_wait(a.status + (size_t)f * a.nb2
                                        + a.nb2 - 1, 2) & ST_COUNT),
                (long long)a.cap);
    __syncthreads();
    int* slot = a.slot + (size_t)f * a.cap;
    int* pp = a.p + (size_t)f * a.cap;
    const int hi = (int)min((long long)a.cap, (long long)(i + 1) * SEED_FILL);
    for (int r = 0; r < BLOCK_THREADS; ++r)
        for (int z = max(s.n_cand, i * SEED_FILL) + THREAD(r); z < hi;
             z += SEED_THREADS) {
            slot[z] = 0;
            pp[z] = 0;
        }
}

// Which of thread t's SEED_PER_THREAD consecutive diagonals have keys.
__device__ __forceinline__ unsigned own_sets(const KeysShared& s, int t)
{
    return (s.nz[t * SEED_PER_THREAD / 32] >> (t * SEED_PER_THREAD % 32))
        & ((1u << SEED_PER_THREAD) - 1);
}

__device__ void keys_block(const SeedArgs& a, KeysShared& s)
{
    for (int i = 0; i < BLOCK_THREADS; ++i)
        if (THREAD(i) == 0) {
            s.tile = (int)atomicAdd(a.ticket, 1u);
            s.flag = 0;
        }
    __syncthreads();
    if (s.tile >= a.n * a.nb2) {        // the fill tiles come last
        const int i = s.tile - a.n * a.nb2;
        keys_fill(a, s, i / a.nf, i % a.nf);
        return;
    }
    const int f = s.tile / a.nb2, j = s.tile % a.nb2;
    for (int i = 0; i < BLOCK_THREADS; ++i) keys_load(a, s, f, j, THREAD(i));
    __syncthreads();
    block_scan(s.part, s.wsum, &s.base);
    for (int i = 0; i < BLOCK_THREADS; ++i) keys_ranks(s, THREAD(i));
    __syncthreads();
    block_scan(s.part, s.wsum, &s.ranks);
    for (int i = 0; i < BLOCK_THREADS; ++i) keys_truncate(a, s, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i)
        keys_scatter(a, s, f, j, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) keys_count(s, THREAD(i));
    slot_counts(s);
    __syncthreads();
    block_scan(s.part, s.wsum, &s.total);
    keys_publish(a, s, f, j);
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) keys_emit(a, s, f, j, THREAD(i));
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
extern "C" int seed_plan(void* plan, const void* ks, const void* aux, int L,
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
    a.held = (const unsigned*)aux;
    a.kmask = a.held + ((1 << (2 * word_len)) + 31) / 32;
    a.L = L;
    a.word_len = word_len;
    a.nw_pos = L - word_len + 1;
    a.num_os = num_os;
    a.max_words = max_words;
    a.cap = cap;
    a.nb1 = (a.nw_pos + SEED_SPAN - 1) / SEED_SPAN;
    a.gx = (a.nb1 + SEED_CLUSTER - 1) / SEED_CLUSTER * SEED_CLUSTER;
    a.nb2 = (a.nw_pos + max_words - 1 + SEED_SPAN - 1) / SEED_SPAN;
    a.nf = (cap + SEED_FILL - 1) / SEED_FILL;
    a.per = a.nb2 + a.nf;
    a.nbits = a.nb1 * (SEED_SPAN / 32);
    pl->a = a;
    pl->device = device;
    return 0;
}

// int32 words of scratch a call on n fragments needs under a plan: a
// fragment's status words (two each), counts and bits, and one word (the
// first of them the tile counter).
extern "C" long long seed_scratch_words(const void* plan, int n)
{
    const SeedArgs& a = ((const SeedPlan*)plan)->a;
    return (long long)n * (2 * a.nb2 + a.nb1 + a.nbits + 1);
}

// The step's call: seeds n fragments under a plan, on the plan's card, on
// `stream`.  Pointers: the payload (packed, frag_lens, nrun_s, nrun_e,
// exc_p, exc_c; n_runs runs and n_exc exceptions a fragment), the seven
// outputs (slot, p, n_cand, counts, overflow, word, word_valid; word on 16
// bytes, word_valid on 8) and seed_scratch_words(plan, n) int32 words of
// scratch (on 8 bytes), any values.  0, cudaErrorInvalidValue for n < 1,
// a negative count or a misaligned pointer, or a launch's CUDA error.
extern "C" int seed_launch_plan(
    const void* plan, const void* packed, const void* frag_lens,
    const void* nrun_s, const void* nrun_e, const void* exc_p,
    const void* exc_c, void* slot, void* p, void* n_cand, void* counts,
    void* overflow, void* word, void* word_valid, void* scratch, int n,
    int n_runs, int n_exc, void* stream)
{
    if (n < 1 || n > 65535 || n_runs < 0 || n_exc < 0
        || (uintptr_t)word % 16 != 0 || (uintptr_t)word_valid % 8 != 0
        || (uintptr_t)scratch % 8 != 0)
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
    a.status = (unsigned long long*)scratch;
    a.cnt1 = (int*)(a.status + (size_t)n * a.nb2);
    a.bits = (unsigned*)(a.cnt1 + (size_t)n * a.nb1);
    a.ticket = a.bits + (size_t)n * a.nbits;
    return run(a, ((const SeedPlan*)plan)->device, stream);
}
